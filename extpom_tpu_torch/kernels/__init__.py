"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper checks its operands, then dispatches by device: CPU tensors go
to the plain version, CUDA tensors to the kernel (built from ``csrc/`` at
first use by :mod:`extpom_tpu_torch.kernels.build`).  Each wrapper counts
its kernel launches in :data:`LAUNCHES`; the variants for blocks of the
decomposed step (``extchunk``, ``extwin_chunk``, ``phase_<p>_mesh``) count
one per wrapper call.
"""

PHASES = ("lat", "uvw", "tke", "tracer", "mom")
LAUNCHES = {"tridiag": 0, "extloop": 0, "extwin": 0,
            **{f"phase_{p}": 0 for p in PHASES},
            "extchunk": 0, "extwin_chunk": 0,
            **{f"phase_{p}_mesh": 0 for p in PHASES}}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
