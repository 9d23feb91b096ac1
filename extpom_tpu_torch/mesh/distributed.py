"""Several processes that run one decomposed model
(``extpom_tpu/mesh/distributed.py``).

The reference is an MPI program: ``initialize_mpi`` assigns the ranks
(parallel_mpi.f:6-20), ``distribute_mpi`` gives each rank its tiles
(parallel_mpi.f:34-122), and every I/O call is collective, with per-rank
hyperslabs (io_pnetcdf.F:272-275).  The JAX package runs one process per
host that sees the global device set, materialises its own shards from
host-replicated data (``make_global``) and exchanges rings by ``ppermute``.
The port runs one process per card, as ``torchrun`` launches it: each
process owns a contiguous run of the mesh's blocks (:func:`owned_blocks`)
on its one device, builds the case on the host and moves only its blocks
to the card (``Model.shard``), and exchanges rings with the other ranks
(``mesh.extchunk.ring_extend_all``).

* :func:`init_distributed` -- the process group (the ``initialize_mpi``
  analogue), from its arguments or torchrun's environment;
* :func:`process_barrier` -- the barrier of the cooperative writes, on a
  gloo group of its own, so that the writer thread never issues a
  collective on the group of the step's exchange;
* :func:`exchange` -- one buffer to and from each peer rank.  ``nccl``
  moves device tensors and needs one card per rank (checked at init);
  ``gloo`` takes no CUDA tensor, so each buffer is staged through pinned
  host memory.

One process holding blocks on several cards is not supported: a process
has one device, and a mesh spans cards by its processes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import subprocess
import tempfile
import time
from typing import Optional

import torch

from extpom_tpu_torch.diag.profiling import span

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass
class Procs:
    """This process's place among the ranks: its rank, the world size, the
    transport of the step's exchange (``backend``), its device, each
    rank's device (``devices``), the gloo group of the I/O barriers
    (``io_group``) and the group of the main thread's small host
    reductions (``host_group``: the default group under gloo)."""
    rank: int = 0
    world: int = 1
    backend: Optional[str] = None
    device: Optional[torch.device] = None
    devices: tuple = ()
    io_group: object = None
    host_group: object = None

    @property
    def staged(self) -> bool:
        """Whether the exchange stages device buffers through the host."""
        return (self.backend == "gloo" and self.device is not None
                and self.device.type == "cuda")


_PROCS = Procs()


@dataclasses.dataclass
class Slabs:
    """A global array held as this process's hyperslabs: its ``shape``, its
    dtype's name, the ``chunks`` of its store (each filled by one rank) and
    the ``pieces``: ((i0, i1), (j0, j1)) of the two trailing axes -> the
    tensor of those cells (``mesh.shardmap.Blocks.slabs``)."""
    shape: tuple
    dtype: str
    chunks: tuple
    pieces: dict


@dataclasses.dataclass
class ExchangeStats:
    """What the exchanges between ranks cost since :meth:`reset`: calls,
    wall seconds (the host's clock from packing to unpacking, the device
    synchronisations of host staging included), bytes sent to other ranks
    and bytes staged through the host (sent and received)."""
    calls: int = 0
    seconds: float = 0.0
    sent_bytes: int = 0
    staged_bytes: int = 0

    def reset(self) -> None:
        self.calls, self.seconds = 0, 0.0
        self.sent_bytes = self.staged_bytes = 0


EXCHANGE = ExchangeStats()


def procs() -> Procs:
    """This process's :class:`Procs` (one rank of one until
    :func:`init_distributed` ran)."""
    return _PROCS


def rank() -> int:
    return _PROCS.rank


def world() -> int:
    return _PROCS.world


def _coordinator(coordinator: Optional[str]) -> tuple:
    if coordinator is None:
        host, port = os.environ.get("MASTER_ADDR"), os.environ.get(
            "MASTER_PORT")
        if host is None or port is None:
            raise ValueError("several processes need a coordinator "
                             "'host:port' or MASTER_ADDR and MASTER_PORT")
        return host, int(port)
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator {coordinator!r} is not 'host:port'")
    return host, int(port)


def _env_int(name: str, given) -> int:
    if given is not None:
        return int(given)
    if name not in os.environ:
        raise ValueError(f"several processes need this process's {name} "
                         f"(or the argument that stands for it)")
    return int(os.environ[name])


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device=None,
                     timeout_s: float = 600.0) -> Procs:
    """Join the process group (``initialize_mpi``, parallel_mpi.f:6-20).

    The arguments default to torchrun's environment: ``coordinator``
    "host:port" to MASTER_ADDR/MASTER_PORT, ``num_processes`` to
    WORLD_SIZE, ``process_id`` to RANK, and the device to
    ``cuda:LOCAL_RANK`` (``device`` overrides it: two ranks may share a
    card under gloo).  ``backend`` is ``nccl`` for a CUDA device and
    ``gloo`` for the CPU unless given; nccl with two ranks on one card
    raises here, before any step.  A no-op for one process and when the
    group is already initialised.  Every collective gives up after
    ``timeout_s``, so a rank that dies makes the others fail instead of
    hanging."""
    global _PROCS
    import torch.distributed as dist
    if dist.is_initialized():
        return _PROCS
    n = int(num_processes if num_processes is not None
            else os.environ.get("WORLD_SIZE", 1))
    if n <= 1:
        return _PROCS
    r = _env_int("RANK", process_id)
    if not 0 <= r < n:
        raise ValueError(f"rank {r} of {n} processes")
    host, port = _coordinator(coordinator)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the processes on the CPU")
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: the port has {BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("nccl exchanges CUDA tensors: a CPU rank needs gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{host}:{port}",
                            world_size=n, rank=r,
                            timeout=datetime.timedelta(seconds=timeout_s))
    io = dist.new_group(backend="gloo")
    host_group = (dist.group.WORLD if backend == "gloo"
                  else dist.new_group(backend="gloo"))
    card = (str(torch.cuda.get_device_properties(device).uuid)
            if device.type == "cuda" else None)
    seen = [None] * n
    dist.all_gather_object(seen, (str(device), card), group=host_group)
    try:
        one_card_per_rank(backend, [c for _, c in seen])
    except ValueError:
        dist.destroy_process_group()
        raise
    if backend == "nccl":
        dist.barrier()      # the first collective of WORLD: every rank
    _PROCS = Procs(r, n, backend, device, tuple(d for d, _ in seen), io,
                   host_group)
    return _PROCS


def one_card_per_rank(backend: str, cards: list) -> None:
    """nccl's exchange needs a card per rank: raise where two ranks hold
    the same card (``cards``: each rank's card id)."""
    held = [c for c in cards if c is not None]
    if backend == "nccl" and len(set(held)) < len(held):
        raise ValueError("nccl with two ranks on one card: use one process "
                         "per card, or the gloo backend to share a card")


def destroy() -> None:
    """Leave the process group (the end of a run)."""
    global _PROCS
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    _PROCS = Procs()


def owned_blocks(px: int, py: int, rank: int, world: int) -> list:
    """The blocks of rank ``rank`` of ``world`` on a px x py mesh: the
    row-major ids split into contiguous runs (the earlier ranks one longer
    where they do not divide), as JAX's device order splits a mesh over
    processes: on 2x4 over two ranks, block row 0 and block row 1."""
    ids = [(bi, bj) for bi in range(px) for bj in range(py)]
    if world > len(ids):
        raise ValueError(f"{world} processes for {len(ids)} blocks: every "
                         f"rank needs a block")
    base, extra = divmod(len(ids), world)
    start = rank * base + min(rank, extra)
    return ids[start:start + base + (rank < extra)]


def owner_map(px: int, py: int, world: int) -> dict:
    """Block -> the rank that owns it."""
    return {b: r for r in range(world) for b in owned_blocks(px, py, r,
                                                             world)}


def process_barrier(name: str = "extpom") -> None:
    """Wait for every rank (``multihost_utils.sync_global_devices``), on the
    I/O group; nothing for one process."""
    if _PROCS.world > 1:
        import torch.distributed as dist
        dist.barrier(group=_PROCS.io_group)


def host_all_gather(obj) -> list:
    """Every rank's ``obj`` (picklable), by rank, over the host group."""
    if _PROCS.world == 1:
        return [obj]
    import torch.distributed as dist
    out = [None] * _PROCS.world
    dist.all_gather_object(out, obj, group=_PROCS.host_group)
    return out


def exchange(send: dict, recv: dict, device, dtype) -> dict:
    """One buffer to and from each peer rank, in one batch: ``send`` maps a
    rank to a 1-D tensor on ``device``, ``recv`` a rank to the number of
    elements to receive from it; returns rank -> received 1-D tensor on
    ``device``.  Under gloo a CUDA buffer is copied to pinned host memory
    before its send and the received ones copied back after."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    stage = _PROCS.backend == "gloo" and torch.device(device).type == "cuda"
    ops, out = [], {}
    for r in sorted(set(send) | set(recv)):
        if r in send:
            buf = send[r]
            if stage:
                host = torch.empty(buf.shape, dtype=dtype, pin_memory=True)
                with span("sync"):
                    host.copy_(buf)
                buf = host
            ops.append(dist.P2POp(dist.isend, buf, r))
        if r in recv:
            out[r] = torch.empty(recv[r], dtype=dtype,
                                 device="cpu" if stage else device,
                                 pin_memory=stage)
            ops.append(dist.P2POp(dist.irecv, out[r], r))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if stage:
        out = {r: b.to(device, non_blocking=True) for r, b in out.items()}
    item = torch.empty((), dtype=dtype).element_size()
    sent = sum(b.numel() for b in send.values()) * item
    EXCHANGE.calls += 1
    EXCHANGE.sent_bytes += sent
    if stage:
        EXCHANGE.staged_bytes += sent + sum(recv.values()) * item
    EXCHANGE.seconds += time.perf_counter() - t0
    return out


def spawn(argv: list, n: int, timeout_s: float, env: Optional[dict] = None,
          cwd: Optional[str] = None) -> list:
    """Run ``argv`` as ``n`` ranks on this host, as torchrun would (RANK,
    LOCAL_RANK, WORLD_SIZE, MASTER_ADDR=localhost and a free MASTER_PORT in
    each one's environment), and wait for them.  When a rank exits with an
    error, or ``timeout_s`` passes, the others are killed.  Returns each
    rank's (exit code, stdout, stderr); the code of a rank killed at the
    time limit is None."""
    port = free_port()
    base = dict(os.environ if env is None else env)
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as st:
        files = [tuple(st.enter_context(open(os.path.join(tmp, f"{r}.{k}"),
                                             "w+")) for k in ("out", "err"))
                 for r in range(n)]
        ranks = []
        timed_out = False
        try:
            for r, (out, err) in enumerate(files):
                ranks.append(subprocess.Popen(
                    argv, stdout=out, stderr=err, cwd=cwd,
                    env=dict(base, RANK=str(r), LOCAL_RANK=str(r),
                             WORLD_SIZE=str(n), MASTER_ADDR="localhost",
                             MASTER_PORT=str(port))))
            deadline = time.monotonic() + timeout_s
            while any(p.poll() is None for p in ranks):
                if any(p.poll() not in (None, 0) for p in ranks):
                    break
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.05)
        finally:
            for p in ranks:
                if p.poll() is None:
                    p.kill()
            for p in ranks:
                p.wait()
        result = []
        for p, (out, err) in zip(ranks, files):
            out.seek(0)
            err.seek(0)
            rc = None if timed_out and p.returncode < 0 else p.returncode
            result.append((rc, out.read(), err.read()))
    return result


def free_port() -> int:
    """A TCP port that was free on localhost a moment ago."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]
