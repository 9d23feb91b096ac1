"""Which machine each model component gets (``extpom_tpu/core/dispatch.py``):
on one device, and for the decomposed step on a mesh, whose blocks lie on
one device per process (``mesh/distributed.py``: the report then names
the processes, the transport of their exchange, and each rank's blocks
and device).

:func:`dispatch_report` computes the decisions the step takes for a
configuration, dtype and device without running anything, and
:func:`format_report` renders the echo a run prints beside its first lines.
"""

from __future__ import annotations

import torch

from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.kernels import PHASES, extwin
from extpom_tpu_torch.mesh import distributed


def dispatch_report(cfg: Config, dtype: torch.dtype, device,
                    mesh=None) -> dict:
    """The machine of the external loop and of each phase for ``cfg`` in
    ``dtype`` on ``device``: on the card the external loop is the
    whole-grid chain (``cuda-chain``) or the window kernel (``cuda-window``,
    with its C, H and tile), the phases ``cuda``; on the CPU everything is
    ``plain``.  ``mesh`` is a run file's mesh block ({"px", "py", "mode"})
    or a ``mesh.shardmap.Mesh``: a mesh of more than one block reports the
    decomposed step (:func:`_mesh_report`), and so does a padded grid,
    which runs it on one device as a 1x1 mesh; an unpadded 1x1 mesh runs
    the single-device path."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise TypeError(f"dispatch: unsupported device {device}")
    px = py = 1
    if mesh is not None:
        px, py, mode = _mesh_shape(mesh)
    if px * py > 1 or cfg.is_padded:
        return _mesh_report(cfg, dtype, device, px, py)
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
    else:
        external, phase = {"machine": "plain"}, "plain"
    return {"external": _with_options(external, cfg),
            "phases": _phases(cfg, {"machine": phase}),
            "mesh": {"px": 1, "py": 1, "mode": "single-device"},
            "grid": (cfg.im, cfg.jm, cfg.kb), "dtype": str(dtype),
            "device": str(device)}


def _with_options(external: dict, cfg: Config) -> dict:
    """The external loop's report with the options its kernels compile in
    (the orlanski scheme's edges, mode 2's advave), where any is set."""
    opts = [name for name, on in (("orlanski", cfg.bc_scheme == "orlanski"),
                                  ("mode2", cfg.mode == 2)) if on]
    return {**external, "options": "+".join(opts)} if opts else external


def phase_options(cfg: Config) -> dict:
    """Phase -> the options its kernels run under ``cfg``, where any is
    set: lat McCalpin's pressure gradient (``npg2``), tracer MPDATA with
    its upstream steps (``mpdata<nitera>``) and interior restoring
    (``restore``), mom the file scheme's ``bc_vel3d`` (``file``)."""
    opts = {"lat": [("npg2", cfg.npg == 2)],
            "tracer": [(f"mpdata{cfg.nitera}", cfg.nadv == 2),
                       ("restore", cfg.do_restore)],
            "mom": [("file", cfg.bc_scheme == "file")]}
    out = {}
    for p, names in opts.items():
        on = [n for n, x in names if x]
        if on:
            out[p] = "+".join(on)
    return out


def _phases(cfg: Config, machine: dict) -> dict:
    """The phases' machines, each with the options its kernels run: none
    run in mode 2 (external only)."""
    if cfg.mode == 2:
        return {}
    opts = phase_options(cfg)
    return {p: {**machine, **({"options": opts[p]} if p in opts else {})}
            for p in PHASES}


def _mesh_shape(mesh) -> tuple:
    """(px, py, mode) of a run file's mesh block or a Mesh; what the port
    cannot run raises."""
    if isinstance(mesh, dict):
        px, py = int(mesh["px"]), int(mesh["py"])
        mode = mesh.get("mode", "shardmap")
    else:
        px, py, mode = mesh.px, mesh.py, "shardmap"
        mesh.device       # raises for blocks on several devices
    if mode != "shardmap":
        raise NotImplementedError(f"parallel mode {mode!r} is not ported; "
                                  f"the port has 'shardmap'")
    return px, py, mode


def _mesh_report(cfg: Config, dtype: torch.dtype, device, px: int,
                 py: int) -> dict:
    """The decomposed step's decisions (``stepper.mesh_step``): the chunk
    plan of the external loop (``mesh.extchunk.chunk_plan``: C substeps per
    ring exchange, the ring, the extended block and, for the window kernel,
    its C per launch, H and tile) and the phases' ring.  A grid that does
    not divide the mesh is reported padded, as ``Model.shard`` pads it:
    the padded extents, the active ones and the block."""
    from extpom_tpu_torch.mesh import extchunk, padding
    if cfg.im % px or cfg.jm % py:
        if cfg.is_padded:
            raise ValueError(f"padded grid {cfg.im}x{cfg.jm} does not "
                             f"divide mesh {px}x{py}")
        imp, jmp = padding.padded_dims(cfg.im, cfg.jm, px, py)
        cfg = cfg.replace(im=imp, jm=jmp, im_act=cfg.im, jm_act=cfg.jm)
    ni, nj = cfg.im // px, cfg.jm // py
    itemsize = torch.empty((), dtype=dtype).element_size()
    plan = extchunk.chunk_plan(cfg, px, py, ni, nj, device, itemsize)
    external = {"machine": plan.machine, "C": plan.C,
                "ring": (plan.hx, plan.hy), "block": (plan.R, plan.L),
                "chunks_per_step": cfg.isplit // plan.C}
    if plan.geo is not None:
        external.update(C_launch=plan.geo.C, H=plan.geo.H,
                        tile=f"{plan.geo.ti}x{plan.geo.tj}",
                        threads=plan.geo.threads)
    on_i, on_j = padding.ring_axes(cfg, px, py)
    ring = (cfg.phase_halo if on_i else 0, cfg.phase_halo if on_j else 0)
    phase = "cuda-mesh" if device.type == "cuda" else "plain"
    out = {"external": _with_options(external, cfg),
           "phases": _phases(cfg, {"machine": phase, "ring": ring}),
           "mesh": {"px": px, "py": py, "mode": "shardmap", "devices": 1,
                    "local_tile": (ni, nj, cfg.kb)},
           "grid": (cfg.im, cfg.jm, cfg.kb), "dtype": str(dtype),
           "device": str(device)}
    if cfg.is_padded:
        out["active"] = cfg.active
    procs = distributed.procs()
    if procs.world > 1:
        out["mesh"]["devices"] = len(set(procs.devices))
        out["processes"] = {
            "count": procs.world, "transport": procs.backend,
            "staged": procs.staged, "printed_by": procs.rank,
            "ranks": [(r, distributed.owned_blocks(px, py, r, procs.world),
                       procs.devices[r]) for r in range(procs.world)]}
    return out


def format_report(rep: dict) -> str:
    """Render the dispatch echo, one component per line."""
    ext = rep["external"]
    geo = " ".join(f"{k}={v}" for k, v in ext.items() if k != "machine")
    im, jm, kb = rep["grid"]
    pad = ("  padded from {}x{}".format(*rep["active"]) if "active" in rep
           else "")
    lines = [f"  grid {im}x{jm}x{kb} {rep['dtype']} on {rep['device']}{pad}",
             f"  external mode: {ext['machine']}"
             + (f"  [{geo}]" if geo else "")]
    by_machine: dict = {}
    for p, d in rep["phases"].items():
        geo = " ".join(f"{k}={v}" for k, v in d.items() if k != "machine")
        by_machine.setdefault((d["machine"], geo), []).append(p)
    for (machine, geo), names in sorted(by_machine.items()):
        lines.append(f"  phases [{machine}]: {', '.join(names)}"
                     + (f"  [{geo}]" if geo else ""))
    if not by_machine:
        lines.append("  phases: none (mode 2, external only)")
    mk = rep["mesh"]
    line = f"  mesh: {mk['px']}x{mk['py']} {mk['mode']}"
    if "local_tile" in mk:
        n = mk["devices"]
        line += (f" on {n} device{'s' if n > 1 else ''}  local tile "
                 + "x".join(map(str, mk["local_tile"])))
    lines.append(line)
    pr = rep.get("processes")
    if pr is not None:
        how = ("each ring staged through pinned host memory" if pr["staged"]
               else "device tensors")
        lines.append(f"  processes: {pr['count']} over {pr['transport']} "
                     f"({how})")
        for r, blocks, dev in pr["ranks"]:
            lines.append(f"    rank {r}: blocks {', '.join(map(str, blocks))}"
                         f" on {dev}")
        lines.append(f"  printed by rank {pr['printed_by']}")
    return "\n".join(lines)
