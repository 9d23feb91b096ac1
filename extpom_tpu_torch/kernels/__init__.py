"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper checks its operands, then dispatches by device: CPU tensors go
to the plain version, CUDA tensors to the kernel (built from ``csrc/`` at
first use by :mod:`extpom_tpu_torch.kernels.build`).  Each wrapper counts
its kernel launches in :data:`LAUNCHES`; the variants for blocks of the
decomposed step (``extchunk``, ``extwin_chunk``, ``phase_<p>_mesh``) count
one per wrapper call.  The option instantiations of three phase kernels
count under their own names (:data:`OPTION_VARIANTS`): lat's McCalpin
variant ``phase_lat_npg2``, tracer's MPDATA/restoring variant
``phase_tracer_options``, mom's ``file`` scheme ``phase_mom_file`` (each
``_mesh`` on a block).  MPDATA's upstream steps (``nadv=2``), launched by
the tracer phase before its tile, count one per launch under
``phase_tracer_mpdata`` (``_mesh``).  The step's forcing interpolation
(``kernels/forcing.py``) counts one per launch under ``forcing``, on one
device and on a mesh alike (the mesh forms it on the whole grid).
"""

PHASES = ("lat", "uvw", "tke", "tracer", "mom")
OPTION_VARIANTS = ("phase_lat_npg2", "phase_tracer_options",
                   "phase_mom_file", "phase_tracer_mpdata")
LAUNCHES = {"tridiag": 0, "extloop": 0, "extwin": 0,
            **{f"phase_{p}": 0 for p in PHASES},
            **{v: 0 for v in OPTION_VARIANTS},
            "extchunk": 0, "extwin_chunk": 0,
            **{f"phase_{p}_mesh": 0 for p in PHASES},
            **{f"{v}_mesh": 0 for v in OPTION_VARIANTS},
            "forcing": 0}


def whole_grid_only(cfg, what: str) -> None:
    """Raise for a whole-grid kernel launch on a padded grid: the
    whole-grid kernels take the array's extents as the domain's, so a
    padded model runs the block kernels (``mesh/padding.py``)."""
    if cfg.is_padded:
        raise NotImplementedError(
            f"{what}: the whole-grid kernel on a padded grid; a padded model "
            f"runs the block kernels (Model.run_segment)")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
