"""The port's plain Thomas solve (kernels/tridiag.py:thomas_plain, what
the CUDA kernel csrc/tridiag.cu is held against on the card) against the
JAX package's Pallas kernel (interpret mode) and its scan pair, on the
four (k0, k_last, bottom-row) variants of the vertical solvers, at a
lane-unaligned 13x17x9 in float64 (atol 1e-12)."""

from contextlib import nullcontext

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from extpom_tpu.core.config import Config as JxConfig
from extpom_tpu.ops.vertical import _forward, _backward
from extpom_tpu.pallas import tridiag as jx_tridiag

from extpom_tpu_torch import kernels
from extpom_tpu_torch.kernels import tridiag

torch.set_num_threads(1)

IM, JM, KB = 13, 17, 9

VARIANTS = [
    (1, KB - 2, True, False),    # proft
    (1, KB - 2, True, True),     # profu/profv
    (1, KB - 1, False, False),   # profq q2
    (2, KB - 1, False, False),   # profq q2l
]


def _operands(seed, k0, k_last, use_cl, use_mask):
    rng = np.random.default_rng(seed)
    r3 = lambda s=1.0, o=0.0: o + s * rng.random((KB, IM, JM))
    r2 = lambda s=1.0, o=0.0: o + s * rng.random((IM, JM))
    a = -r3(0.5, 0.1)
    c = -r3(0.5, 0.1)
    den = r3(0.2, 1.0)
    rhs = r3(2.0, -1.0)
    ee0, gg0 = r2(0.5), r2(1.0)
    cl = a[k_last] if use_cl else np.zeros((IM, JM))
    rb = r2(1.0)
    db = r2(0.5, -1.5) if use_cl else np.ones((IM, JM))
    mask = ((rng.random((IM, JM)) > 0.3).astype(float) if use_mask
            else np.ones((IM, JM)))
    return [a, c, den, rhs, ee0, gg0, cl, rb, db, mask]


def _scan(ops, k0, k_last):
    a, c, den, rhs, ee0, gg0, cl, rb, db, mask = (jnp.asarray(x) for x in ops)
    ee, gg = _forward(a, c, den, rhs, ee0, gg0, k0, 1024)
    f_last = (cl * gg[k_last - 1] + rb) / (cl * (1.0 - ee[k_last - 1]) + db)
    f = _backward(ee, gg, f_last, k_last, 1024) * mask
    if k_last + 1 < KB:
        f = jnp.concatenate([f, jnp.zeros((KB - k_last - 1, IM, JM))], axis=0)
    return np.asarray(f)


@pytest.mark.parametrize("k0,k_last,use_cl,use_mask", VARIANTS)
def test_thomas_plain_matches_jax(k0, k_last, use_cl, use_mask):
    ops = _operands(5, k0, k_last, use_cl, use_mask)
    cfg = JxConfig(im=IM, jm=JM, kb=KB, dtype="float64")
    pallas = np.asarray(jx_tridiag.thomas(cfg, *ops, k0, k_last,
                                          interpret=True))
    scan = _scan(ops, k0, k_last)
    before = kernels.LAUNCHES["tridiag"]
    got = tridiag.thomas(*[torch.from_numpy(x) for x in ops], k0, k_last)
    # a CPU tensor runs the plain version, which launches nothing
    assert kernels.LAUNCHES["tridiag"] == before
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.numpy(), scan, rtol=0, atol=1e-12)
    # rows below k_last+1 carry the solution, rows above it are zero
    assert not got[k_last + 1:].any()


def _good():
    return [torch.from_numpy(x) for x in _operands(7, 1, KB - 2, True, True)]


def test_thomas_rejects_dtype():
    ops = [x.to(torch.float16) for x in _good()]
    with pytest.raises(TypeError):
        tridiag.thomas(*ops, 1, KB - 2)


def test_thomas_rejects_mixed_dtype():
    ops = _good()
    ops[2] = ops[2].float()
    with pytest.raises(TypeError):
        tridiag.thomas(*ops, 1, KB - 2)


def test_thomas_rejects_shape():
    ops = _good()
    ops[1] = ops[1][:, :-1]
    with pytest.raises(ValueError):
        tridiag.thomas(*ops, 1, KB - 2)
    ops = _good()
    ops[7] = ops[7][:-1]          # a 2-D operand that does not broadcast
    with pytest.raises(ValueError):
        tridiag.thomas(*ops, 1, KB - 2)


def test_thomas_rejects_noncontiguous():
    ops = _good()
    ops[3] = ops[3].transpose(1, 2).contiguous().transpose(1, 2)
    assert not ops[3].is_contiguous()
    with pytest.raises(ValueError):
        tridiag.thomas(*ops, 1, KB - 2)


def test_thomas_rejects_levels():
    with pytest.raises(ValueError):
        tridiag.thomas(*_good(), 0, KB - 2)
    with pytest.raises(ValueError):
        tridiag.thomas(*_good(), 1, KB)


def test_thomas_never_hands_other_devices_to_the_plain_version():
    ops = [x.to("meta") for x in _good()]
    with pytest.raises(TypeError):
        tridiag.thomas(*ops, 1, KB - 2)


class _FakeLibrary:
    """Stands in for the kernel library: records what a launch passes."""

    def __init__(self):
        self.calls = []

    def extpom_tridiag_f64(self, ptrs, strides, *ints):
        self.calls.append((list(ptrs), list(strides), ints))
        return 0


def test_launch_reads_broadcast_operands_in_place(monkeypatch):
    """The launch path hands the kernel each 2-D operand where the caller
    keeps it, with its element strides (0 along a broadcast axis): a 0-d
    ee0, a row gg0, a column rb and a level of a as cl go in uncopied, and
    the output is the one tensor it allocates (no ee/gg scratch)."""
    ops = _good()
    a = ops[0]
    ops[4] = torch.tensor(0.25, dtype=torch.float64)
    ops[5] = ops[5][0]
    ops[7] = ops[7][:, :1]
    ops[6] = a[KB - 2]
    lib = _FakeLibrary()
    monkeypatch.setattr(tridiag.build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    empty = torch.empty_like
    made = []
    monkeypatch.setattr(torch, "empty_like",
                        lambda *x, **k: made.append(empty(*x, **k))
                        or made[-1])
    monkeypatch.setattr(torch, "empty", None)    # nothing else allocates
    three, two = tridiag._check(*ops, 1, KB - 2)
    out = tridiag._launch(three, two, 1, KB - 2)
    (ptrs, strides, ints), = lib.calls
    assert [m.data_ptr() for m in made] == [out.data_ptr()] == ptrs[10:]
    assert ptrs[:10] == [x.data_ptr() for x in ops]
    assert strides == [0, 0, 0, 1, JM, 1, JM, 0, JM, 1, JM, 1]
    assert ints == (KB, IM, JM, 1, KB - 2,
                    tridiag.block_threads(KB, torch.float64), 0)


@pytest.mark.parametrize("kb,dtype,threads", [
    (31, torch.float32, 256), (41, torch.float32, 128),
    (31, torch.float64, 128), (41, torch.float64, 64),
    (200, torch.float64, 32)])
def test_block_threads_fit_two_blocks_an_sm(kb, dtype, threads):
    """The stacks and the coefficient ring of a block fit twice into an
    SM's shared memory with the most threads that allow it (f64 at kb=41:
    64 columns, 58,368 bytes)."""
    assert tridiag.block_threads(kb, dtype) == threads
    smem = tridiag.smem_bytes(kb, dtype, threads)
    assert 2 * (smem + tridiag.SMEM_RESERVED) <= tridiag.SM_SMEM
    if threads < 256:
        bigger = tridiag.smem_bytes(kb, dtype, 2 * threads)
        assert 2 * (bigger + tridiag.SMEM_RESERVED) > tridiag.SM_SMEM
    with pytest.raises(ValueError, match="do not fit"):
        tridiag.block_threads(500, torch.float64)
