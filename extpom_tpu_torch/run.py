"""Run driver: ``python -m extpom_tpu_torch.run config.json [--device cpu]``
(``extpom_tpu/run.py``).

The ``program pom`` equivalent (pom.f:8-39, read_input initialize.f:67-244):
reads a JSON run configuration (the namelist analogue), builds the model
from a built-in case or from NetCDF/Zarr datasets, and drives the time loop
in segments between print, restart and ``iswtch`` boundaries, with the
diagnostics print and blow-up guard, snapshots and restarts written by a
background writer, and resume from a restart (nread_rst, initialize.f:39).
It runs on the card unless ``--device cpu`` is given, and raises when there
is no card.  Under several processes (the ``distributed`` block) each
process runs its own blocks of the mesh on its own device.

Config schema (all keys optional unless noted)::

    {
      "run_name": "seamount01",
      "case": "seamount" | "channel",        # built-in generator ...
      "case_args": {"im": 65, "jm": 49},     # ... and its arguments
      "grid": "in/grid.nc", "init": "in/init.nc",
      #   (or Zarr dataset directories; .nc files are the reference's
      #    formats, io/netcdf.py)
      "sfrc": "in/sfrc.nc", "lbry": "in/lbry.nc",
      #   surface and lateral forcing series: a .nc series file, a
      #   directory of .efr files (native/recordio) or a Zarr dataset
      "config": {"mode": 3, "dte": 6.0, "days": 1.0, ...},
      "out_dir": "out",
      "out_format": "zarr" | "nc",
      #   snapshots: Zarr directories {run}.NNNNNN, or with "nc" one
      #   {run}.nc record stream; restarts are Zarr directories
      #   {run}.rst.NNNNNN under both (io/zarrstore.py, blosc-lz4 chunks)
      "nread_rst": 0, "read_rst_path": "out/run.rst.000024",
      #   a Zarr restart, or a reference-format .nc restart file
      "cont_bry": 0,
      "mesh": {"px": 2, "py": 4},            # Model.shard blocks
      "distributed": {"num_processes": 2,    # one process per card
                      "coordinator": "host:port", "process_id": 0,
                      "backend": "nccl" | "gloo"}
    }

The ``distributed`` block (``mesh/distributed.py``) joins the process
group before any device use; its keys default to torchrun's environment
(WORLD_SIZE, RANK, MASTER_ADDR/MASTER_PORT; the device is
``cuda:LOCAL_RANK``, the CPU with ``--device cpu``), so one run file serves
every process::

    torchrun --nproc-per-node 2 -m extpom_tpu_torch.run run.json

Each process builds the case on the host and keeps only its own blocks of
the mesh block's mesh, on its device; only rank 0 prints.
The diagnostics come from the blocks (``diag.stats`` block forms), the
Zarr snapshots and restarts are written cooperatively
(``io.zarrstore``), a Zarr restart resumes into each rank's blocks, and
rank 0 prints each rank's wall clock, writer times, encoder times and
kernel launches at the end.
``out_format`` "nc" raises under several processes, as in the JAX
package: write Zarr.

A mesh block runs forced runs too: the staged series are cut to the
blocks.  A grid that does not divide the mesh is padded (``Model.shard``,
``mesh/padding.py``); its snapshots and restarts hold the active ``im x
jm``, and a restart of it resumes into the padded model.

Not ported, and raising ``NotImplementedError``: ``"mode": "gspmd"`` in
the mesh block, several processes without a mesh block, and forcing series
on a padded grid (the JAX package cannot run them either).  A fresh run
(``nread_rst`` 0) writes its ``{run}.nc`` anew.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
import types
from typing import Callable, Optional

import numpy as np
import torch


def _open_source(path: str):
    """Forcing record source by format: a ``.nc`` series file, a directory
    of ``.efr`` files (the native record store), else a Zarr dataset."""
    if path.endswith(".nc"):
        from extpom_tpu_torch.io.netcdf import NcForcingSource
        return NcForcingSource(path)
    if (os.path.isdir(path)
            and any(fn.endswith(".efr") for fn in os.listdir(path))):
        from extpom_tpu_torch.native import recordio
        return recordio.NativeRecordSource(path)
    from extpom_tpu_torch.io import zarrstore as zio
    return zio.ZarrSource(path)


def build_model(conf: dict, device=None):
    """The Model of a run configuration on ``device`` (the card unless
    given): case or datasets, forcing sources, restart, mesh.  Under
    several processes (``init_distributed`` ran) the case is built on the
    host, and each process cold-starts its own blocks on its device
    (``Model(defer=True)``); a restart is read into the blocks."""
    from extpom_tpu_torch.cases.seamount import resolve_device
    from extpom_tpu_torch.core.config import Config
    from extpom_tpu_torch.core.model import Model
    from extpom_tpu_torch.forcing.provider import ForcingProvider, MultiSource
    from extpom_tpu_torch.io import netcdf as ncio
    from extpom_tpu_torch.io import zarrstore as zio
    from extpom_tpu_torch.mesh import distributed

    procs = distributed.procs()
    device = procs.device if procs.world > 1 else resolve_device(device)
    host = torch.device("cpu") if procs.world > 1 else device
    cfg_kw = dict(conf.get("config", {}))
    case = conf.get("case")
    src = None
    if case == "seamount":
        from extpom_tpu_torch.cases.seamount import seamount_case
        cfg, grid, ics = seamount_case(device=host,
                                       **conf.get("case_args", {}), **cfg_kw)
    elif case == "channel":
        from extpom_tpu_torch.cases.channel import channel_case
        cfg, grid, ics, src = channel_case(
            device=host, **conf.get("case_args", {}), **cfg_kw)
    elif "grid" in conf:
        cfg = Config(**cfg_kw)
        if conf["grid"].endswith(".nc"):
            grid = ncio.read_grid_nc(conf["grid"], cfg, host)
        else:
            grid = zio.read_grid(conf["grid"], cfg, host)
        if conf["init"].endswith(".nc"):
            tb, sb, tclim, sclim = ncio.read_initial_ts_nc(conf["init"])
        else:
            tb, sb, tclim, sclim = zio.read_initial_ts(conf["init"])
        ics = dict(tb=tb, sb=sb, tclim=tclim, sclim=sclim)
    else:
        raise ValueError("config needs 'case' or 'grid'")

    # under several processes the cold start runs on each rank's blocks
    m = Model(grid, cfg, tb=ics["tb"], sb=ics["sb"], tclim=ics.get("tclim"),
              sclim=ics.get("sclim"), elb=ics.get("elb"),
              uab=ics.get("uab"), vab=ics.get("vab"), defer=procs.world > 1)

    sources = [] if src is None else [src]
    sources += [_open_source(conf[k]) for k in ("sfrc", "lbry") if k in conf]
    if sources:
        src = sources[0] if len(sources) == 1 else MultiSource(sources)
        m.forcing_fn = ForcingProvider(
            grid, cfg, m.base_forcing, src,
            cont_bry_offset=int(conf.get("cont_bry", 0)))

    # restart resume (initialize.f:39; read_restart_pnetcdf): under several
    # processes into the blocks, below
    path = conf.get("read_rst_path") if conf.get("nread_rst") else None
    if path is not None and procs.world == 1:
        if path.endswith(".nc"):
            m.state, m.iint, m.time0 = ncio.read_restart_nc(path, cfg,
                                                            device)
        else:
            m.state, m.iint, m.time0 = zio.read_restart(path, cfg, device)

    # the blocks (distribute_mpi analogue, parallel_mpi.f)
    if "mesh" in conf:
        from extpom_tpu_torch.mesh.shardmap import Mesh
        mk = conf["mesh"]
        m.shard(Mesh(int(mk["px"]), int(mk["py"]), device=device),
                mode=mk.get("mode", "shardmap"))
    if path is not None and procs.world > 1:
        if path.endswith(".nc"):
            raise NotImplementedError(
                "a NetCDF restart under several processes: resume from a "
                "Zarr restart, which each process reads its blocks of")
        _, m.iint, m.time0 = zio.read_restart(path, m.cfg, device,
                                              blocks=m.blocks)
    return m


def start_processes(conf: dict, device=None):
    """Join the processes of the run's ``distributed`` block
    (``mesh.distributed.init_distributed``, before any device use): a
    no-op without one or for one process.  Several processes decompose one
    model, so they need the mesh block."""
    from extpom_tpu_torch.mesh import distributed
    dk = conf.get("distributed")
    if dk is None:
        return distributed.procs()
    n = int(dk.get("num_processes") or os.environ.get("WORLD_SIZE", 1))
    if n > 1 and "mesh" not in conf:
        raise NotImplementedError(
            "several processes without a mesh block: the processes of the "
            "port share one decomposed model")
    return distributed.init_distributed(
        dk.get("coordinator"), dk.get("num_processes"),
        dk.get("process_id"), backend=dk.get("backend"), device=device)


@dataclasses.dataclass
class RunResult:
    """What :func:`execute` did: its exit code, the model at the end, the
    steps it ran and the writes it made."""
    rc: int
    model: object
    steps: int
    writes: int


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def execute(conf: dict, device=None,
            log: Callable[[str], None] = print) -> RunResult:
    """Run a configuration (see the module docstring); ``log`` takes each
    line the driver prints (on rank 0 only under several processes)."""
    from extpom_tpu_torch.core import dispatch
    from extpom_tpu_torch.core.grid import Grid
    from extpom_tpu_torch.diag import stats as diag_stats
    from extpom_tpu_torch.io import netcdf as ncio
    from extpom_tpu_torch.io import zarrstore as zio
    from extpom_tpu_torch.io.asyncwriter import AsyncWriter
    from extpom_tpu_torch.mesh import distributed
    from extpom_tpu_torch.mesh.padding import unpad
    from extpom_tpu_torch.native import zcodec

    out_format = conf.get("out_format", "zarr")
    if out_format not in ("zarr", "nc"):
        raise ValueError(f"out_format must be 'zarr' or 'nc', not "
                         f"{out_format!r}")
    procs = start_processes(conf, device)
    multi = procs.world > 1
    if multi and out_format == "nc":
        # the NetCDF writers take whole arrays (extpom_tpu/run.py:277-283)
        raise RuntimeError("out_format='nc' is single-process only; write "
                           "zarr and convert via python -m extpom_tpu_torch."
                           "io.netcdf")
    if procs.rank != 0:
        log = lambda line: None   # rank 0 prints
    m = build_model(conf, device)
    cfg = m.cfg
    device = m.device
    run = conf.get("run_name", "run")
    out_dir = conf.get("out_dir", "out")
    os.makedirs(out_dir, exist_ok=True)
    nc_out = os.path.join(out_dir, f"{run}.nc")
    if out_format == "nc" and not conf.get("nread_rst") \
            and os.path.exists(nc_out):
        os.remove(nc_out)         # a fresh run starts its record stream

    # config echo (read_input's summary print, initialize.f:201-241)
    log(f"run: {run}")
    for k in ("mode", "nadv", "nitera", "sw", "npg", "dte", "isplit",
              "days", "prtd1", "smoth", "horcon", "ntp", "nbct", "nbcs"):
        log(f"  {k} = {getattr(cfg, k)}")
    log(f"  dti = {cfg.dti}  iend = {cfg.iend}  iprint = {cfg.iprint}")
    if multi:
        log(f"  processes = {procs.world}  devices = "
            f"{len(set(procs.devices))}")
    log(f"  CFL advisory: min dt_ext = "
        f"{float(diag_stats.cfl_min(m.grid, cfg)):.2f} s (dte = {cfg.dte} s)")
    log("dispatch:")
    log(dispatch.format_report(dispatch.dispatch_report(
        cfg, cfg.torch_dtype, device, mesh=conf.get("mesh"))))

    # the grid as host arrays, once: every snapshot reads it; the writes of
    # a padded run hold its active region, under the unpadded cfg
    grid_host = types.SimpleNamespace(**{
        f.name: unpad(getattr(m.grid, f.name), cfg).cpu().numpy()
        for f in dataclasses.fields(Grid)})
    ia, ja = cfg.active
    out_cfg = cfg.replace(im=ia, jm=ja, im_act=None, jm_act=None)
    writer = AsyncWriter()
    encoded0 = zcodec.ENCODED.totals()
    iint0 = m.iint
    rc = 0
    _sync(device)
    t0 = time.perf_counter()
    try:
        while m.iint < cfg.iend:
            # next boundary: print, restart, iswtch or the end
            iprint = cfg.iprint if m.iint < cfg.iswtch else cfg.iprint2
            nxt = min(((m.iint // iprint) + 1) * iprint,
                      ((m.iint // cfg.irestart) + 1) * cfg.irestart,
                      cfg.iend)
            if m.iint < cfg.iswtch:
                nxt = min(nxt, cfg.iswtch)
            m.run_segment(nxt - m.iint)
            # the print cadence switches at iswtch (advance.f:65-68)
            iprint = cfg.iprint if m.iint < cfg.iswtch else cfg.iprint2
            st = None
            if m.iint % iprint == 0 or m.iint == cfg.iend:
                st = None if multi else m.gathered_state()
                s = m.stats(st)
                vamax, (iloc, jloc) = m.velocity_check(st)
                if not np.isfinite(vamax) or vamax > cfg.vmaxl:
                    log("POM terminated with error: velocity condition "
                        f"violated, vamax={vamax:.3e} at (i,j)="
                        f"({iloc},{jloc}), iint={m.iint}")
                    rc = 1
                    break
                log(f"time = {m.time_days:9.4f}  iint = {m.iint:8d}  "
                    f"vtot = {s['vtot']:.7e}  eaver = {s['eaver']:.7e}  "
                    f"taver = {s['taver']:.7e}  saver = {s['saver']:.7e}")
                if multi:   # each rank's hyperslabs, written together
                    extra = ({"wr": m.blocks.slabs(m.wr_blocks())}
                             if cfg.calc_wr else None)
                    snap = m.blocks.state_slabs(ncio.OUTPUT_FIELDS)
                else:
                    extra = ({"wr": unpad(m.compute_wr(), cfg)}
                             if cfg.calc_wr else None)
                    snap = types.SimpleNamespace(**{
                        n: unpad(getattr(st, n), cfg)
                        for n in ncio.OUTPUT_FIELDS})
                if out_format == "nc":
                    # one record stream per run (io_pnetcdf.F:180-410); the
                    # writer's single worker keeps the order
                    writer.submit(ncio.write_output_nc, nc_out, grid_host,
                                  out_cfg, snap, m.time_days, s, extra=extra,
                                  append=True)
                else:
                    writer.submit(
                        zio.write_output,
                        os.path.join(out_dir, f"{run}.{m.iint:06d}"),
                        grid_host, out_cfg, snap, m.time_days, s,
                        extra=extra)
            if m.iint % cfg.irestart == 0:
                if multi:
                    st = m.blocks.state_slabs()
                else:
                    st = unpad(st if st is not None else m.gathered_state(),
                               cfg)
                # Zarr under both formats (extpom_tpu/run.py:294-297)
                writer.submit(zio.write_restart, os.path.join(
                    out_dir, f"{run}.rst.{m.iint:06d}"), st, m.iint,
                    m.time0)
    finally:
        writer.close()            # drain the last interval's writes
    _sync(device)
    wall = time.perf_counter() - t0
    steps = m.iint - iint0
    # the Zarr chunks this run encoded (writer thread), seconds and bytes
    frames, enc_s, raw_b, frame_b = (
        b - a for a, b in zip(encoded0, zcodec.ENCODED.totals()))
    encoded = (f"encoder: {frames} chunks in {enc_s:.3f} s, "
               f"{raw_b / 1e6:.3f} MB into {frame_b / 1e6:.3f} MB")
    if rc == 0:
        gps = out_cfg.im * out_cfg.jm * cfg.kb * steps / max(wall, 1e-9)
        log(f"wall clock: {wall:.3f} s for {steps} steps (segments + async "
            f"writes; {gps / 1e6:.1f} Mgrid-pt-steps/s)")
        log(f"writes: {writer.n_writes} in {writer.busy_s:.3f} s on the "
            f"writer thread, {writer.blocked_s:.3f} s of the driver's time")
        log(encoded)
    if multi:
        from extpom_tpu_torch import kernels
        per_rank = distributed.host_all_gather(
            (wall, writer.n_writes, writer.busy_s, writer.blocked_s, encoded,
             {k: v for k, v in kernels.LAUNCHES.items() if v}))
        for r, (w, n, busy, blocked, enc, launches) in enumerate(per_rank):
            if rc == 0:
                log(f"rank {r}: wall clock {w:.3f} s, writes: {n} in "
                    f"{busy:.3f} s on the writer thread, {blocked:.3f} s of "
                    f"the driver's time, {enc}, kernel launches "
                    f"{json.dumps(launches, separators=(',', ':'))}")
    return RunResult(rc, m, steps, writer.n_writes)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    device: Optional[str] = None
    if "--device" in argv:
        k = argv.index("--device")
        if k + 1 >= len(argv):
            print("--device needs a value (cpu, cuda)", file=sys.stderr)
            return 2
        device = argv[k + 1]
        del argv[k:k + 2]
    if len(argv) != 1:
        print(__doc__)
        return 2
    with open(argv[0]) as f:
        conf = json.load(f)
    from extpom_tpu_torch.mesh import distributed
    try:
        return execute(conf, device).rc
    finally:
        distributed.destroy()


if __name__ == "__main__":
    sys.exit(main())
