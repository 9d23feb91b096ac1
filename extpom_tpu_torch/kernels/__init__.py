"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper checks its operands, then dispatches by device: CPU tensors go
to the plain version, CUDA tensors to the kernel (built from ``csrc/`` at
first use by :mod:`extpom_tpu_torch.kernels.build`).  Each wrapper counts
its kernel launches in :data:`LAUNCHES`.
"""

LAUNCHES = {"tridiag": 0, "extloop": 0, "extwin": 0, "phase_lat": 0,
            "phase_uvw": 0, "phase_tke": 0, "phase_tracer": 0,
            "phase_mom": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
