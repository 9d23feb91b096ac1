"""The port's exchange between processes (``mesh/distributed.py``,
``mesh/extchunk.ring_extend_all``) on the CPU over gloo: the collective
ring of several ranks is ``torch.equal`` to the in-process ring
(``_ring_extend``, ``_ring_extend_1d``) of the whole mesh's blocks, under
two processes on 2x4 and four on 2x2 (where every corner of a block comes
from another rank), for every ring from 0 to the block's width and fills 0
and 1; and what a process knows of the others (its blocks, the transport's
rules) without starting any."""

import os
import sys

import numpy as np
import pytest
import torch

from extpom_tpu_torch.mesh import distributed
from extpom_tpu_torch.mesh.extchunk import _ring_extend, _ring_extend_1d

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# each rank builds every block's fields from one numpy seed, exchanges its
# own blocks' and holds the result to the in-process ring of all blocks
_EXCHANGE = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from extpom_tpu_torch.mesh import distributed
from extpom_tpu_torch.mesh.extchunk import (_ring_extend, _ring_extend_1d,
                                            ring_extend_all)

px, py, ni, nj = map(int, sys.argv[1:5])
p = distributed.init_distributed(device="cpu", timeout_s=60)
owned = distributed.owned_blocks(px, py, p.rank, p.world)
owner = distributed.owner_map(px, py, p.world)
rng = np.random.default_rng(7)
ids = [(bi, bj) for bi in range(px) for bj in range(py)]
shapes = [(ni, nj), (3, ni, nj), (ni,), (2, ni), (nj,), (2, nj)]
axes = [None, None, "x", "x", "y", "y"]
full = [{b: torch.from_numpy(rng.standard_normal(s)) for b in ids}
        for s in shapes]
mine = [{b: f[b] for b in owned} for f in full]
n = 0
for hx in range(ni + 1):
    for hy in range(nj + 1):
        for fill in (0.0, 1.0):
            fills = [fill, fill, 0.0, 0.0, 0.0, 0.0]
            got = ring_extend_all(mine, (hx, hy), owner, p.rank, fills, axes)
            for f, g, ax, fl in zip(full, got, axes, fills):
                for b in owned:
                    want = (_ring_extend(f, b, hx, hy, fl) if ax is None
                            else _ring_extend_1d(f, b, hx if ax == "x"
                                                 else hy, ax))
                    assert torch.equal(g[b], want), (b, hx, hy, fill, ax)
                    n += 1
print(f"EXCHANGE_OK rank={p.rank} checked={n} "
      f"calls={distributed.EXCHANGE.calls}", flush=True)
distributed.destroy()
"""


def _spawn(code: str, n: int, *args, timeout: float = 120.0) -> list:
    """Run ``code`` as ``n`` ranks from the repository's root; every rank
    must exit 0."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = distributed.spawn([sys.executable, "-c", code, *map(str, args)],
                            n, timeout, env=env, cwd=ROOT)
    for r, (rc, so, se) in enumerate(out):
        assert rc == 0, f"rank {r} exited {rc}:\n{so[-2000:]}\n{se[-4000:]}"
    return [so for _, so, _ in out]


@pytest.mark.parametrize("n,px,py,ni,nj", [(2, 2, 4, 5, 3), (4, 2, 2, 4, 3)])
def test_collective_ring_equals_the_in_process_ring(n, px, py, ni, nj):
    outs = _spawn(_EXCHANGE, n, px, py, ni, nj)
    for r, o in enumerate(outs):
        assert f"EXCHANGE_OK rank={r}" in o, o
        calls = int(o.split("calls=")[1].split()[0])
        # one exchange per ring that reaches another rank
        assert 0 < calls <= (ni + 1) * (nj + 1) * 2


def test_owned_blocks_follow_jax_device_order():
    """config5's 2x4 mesh over two ranks: block row 0 and block row 1;
    uneven splits give the earlier ranks one more; every rank needs one."""
    assert distributed.owned_blocks(2, 4, 0, 2) == [(0, j) for j in range(4)]
    assert distributed.owned_blocks(2, 4, 1, 2) == [(1, j) for j in range(4)]
    assert [len(distributed.owned_blocks(3, 1, r, 2)) for r in (0, 1)] \
        == [2, 1]
    assert distributed.owner_map(2, 2, 4) == {(0, 0): 0, (0, 1): 1,
                                              (1, 0): 2, (1, 1): 3}
    with pytest.raises(ValueError, match="every rank needs a block"):
        distributed.owned_blocks(1, 2, 0, 3)


def test_nccl_refuses_two_ranks_on_one_card():
    """nccl needs a card per rank (checked at init, before any step); gloo
    shares a card; nccl takes no CPU rank."""
    with pytest.raises(ValueError, match="two ranks on one card"):
        distributed.one_card_per_rank("nccl", ["GPU-a", "GPU-a"])
    distributed.one_card_per_rank("nccl", ["GPU-a", "GPU-b"])
    distributed.one_card_per_rank("gloo", ["GPU-a", "GPU-a"])
    with pytest.raises(ValueError, match="gloo"):
        distributed.init_distributed("localhost:1", 2, 0, backend="nccl",
                                     device="cpu")


def test_init_is_a_no_op_for_one_process(monkeypatch):
    """One process (or none named) joins no group, as in the JAX package;
    several without a coordinator or a rank raise instead of waiting."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    assert distributed.init_distributed(device="cpu").world == 1
    assert distributed.init_distributed(num_processes=1).world == 1
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="RANK"):
        distributed.init_distributed("localhost:1", 2, device="cpu")
    with pytest.raises(ValueError, match="coordinator"):
        distributed.init_distributed(None, 2, 0, device="cpu")


def test_in_process_ring_of_blocks_is_lazy_and_equal():
    """One process: ``Blocks.ext_all`` extends a block when it is read,
    as ``_ring_extend`` does, and a None field stays None."""
    from extpom_tpu_torch.cases.seamount import seamount_model
    from extpom_tpu_torch.mesh.shardmap import Mesh
    m = seamount_model(device="cpu", im=16, jm=24, kb=4, dtype="float64")
    m.shard(Mesh(2, 3, device="cpu"))
    bl = m.blocks
    el = bl.field("el")
    got = bl.ext_all([el, None], (3, 2), fills=[1.0, 0.0])
    assert got[1] is None and set(got[0]) == set(bl.ids)
    for b in bl.ids:
        assert torch.equal(got[0][b], _ring_extend(el, b, 3, 2, 1.0))


def test_compensated_sum_carries_the_exact_error():
    """The diagnostics' compensated sum (``diag.stats._csum``, which the
    block forms sum again over the ranks) takes each addition's exact
    rounding error (Knuth's TwoSum), so that a total that cancels is
    within an ulp of the exact one; the JAX package's error term is not
    exact for some additions (about one in thirty here)."""
    import math
    from fractions import Fraction
    from extpom_tpu_torch.diag import stats
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((2, 4000)) * 10.0 ** rng.integers(-5, 5,
                                                                 (2, 4000))
    t = a + b
    exact = [float(Fraction(x) + Fraction(y) - Fraction(z))
             for x, y, z in zip(a, b, t)]
    jax_term = (a - (t - b)) + (b - (t - a))
    assert np.count_nonzero(jax_term != exact) > 50
    for x, y, e in zip(a, b, exact):
        s, c = stats._csum2(torch.tensor([x, y], dtype=torch.float64))
        assert float(c) == e
    x = torch.from_numpy(rng.standard_normal(5000) * 1e3)
    x = torch.cat([x, -x[:4990] * (1 + 1e-9)])      # nearly all cancels
    want = math.fsum(x.tolist())
    assert abs(float(stats._csum(x)) - want) <= math.ulp(want)
