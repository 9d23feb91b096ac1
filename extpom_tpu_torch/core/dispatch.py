"""Which machine each model component gets (``extpom_tpu/core/dispatch.py``,
single-device part).

:func:`dispatch_report` computes the decisions the step takes for a
configuration, dtype and device without running anything, and
:func:`format_report` renders the echo a run prints beside its first lines.
"""

from __future__ import annotations

from typing import Optional

import torch

from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.kernels import extwin

PHASES = ("lat", "uvw", "tke", "tracer", "mom")


def dispatch_report(cfg: Config, dtype: torch.dtype, device,
                    mesh: Optional[dict] = None) -> dict:
    """The machine of the external loop and of each phase for ``cfg`` in
    ``dtype`` on ``device``: on the card the external loop is the
    whole-grid chain (``cuda-chain``) or the window kernel (``cuda-window``,
    with its C, H and tile), the phases ``cuda``; on the CPU everything is
    ``plain``.  ``mesh`` is a run file's mesh block; multi-GPU runs are not
    ported yet, so any mesh raises."""
    if mesh is not None:
        raise NotImplementedError("multi-GPU meshes are not ported yet")
    device = torch.device(device)
    if device.type == "cuda":
        itemsize = torch.empty((), dtype=dtype).element_size()
        if extwin.use_windowed(cfg.im, cfg.jm, itemsize,
                               extwin.l2_bytes(device)):
            geo = extwin.chunk_geometry(cfg, itemsize)
            external = {"machine": "cuda-window", "C": geo.C, "H": geo.H,
                        "tile": f"{geo.ti}x{geo.tj}", "threads": geo.threads,
                        "launches_per_step": cfg.isplit // geo.C}
        else:
            external = {"machine": "cuda-chain"}
        phase = "cuda"
    elif device.type == "cpu":
        external, phase = {"machine": "plain"}, "plain"
    else:
        raise TypeError(f"dispatch: unsupported device {device}")
    return {"external": external,
            "phases": {p: {"machine": phase} for p in PHASES},
            "mesh": {"px": 1, "py": 1, "mode": "single-device"},
            "grid": (cfg.im, cfg.jm, cfg.kb), "dtype": str(dtype),
            "device": str(device)}


def format_report(rep: dict) -> str:
    """Render the dispatch echo, one component per line."""
    ext = rep["external"]
    geo = " ".join(f"{k}={v}" for k, v in ext.items() if k != "machine")
    im, jm, kb = rep["grid"]
    lines = [f"  grid {im}x{jm}x{kb} {rep['dtype']} on {rep['device']}",
             f"  external mode: {ext['machine']}"
             + (f"  [{geo}]" if geo else "")]
    by_machine: dict = {}
    for p, d in rep["phases"].items():
        by_machine.setdefault(d["machine"], []).append(p)
    for machine, names in sorted(by_machine.items()):
        lines.append(f"  phases [{machine}]: {', '.join(names)}")
    mk = rep["mesh"]
    lines.append(f"  mesh: {mk['px']}x{mk['py']} {mk['mode']}")
    return "\n".join(lines)
