"""Internal-mode phases ``lat``, ``uvw``, ``tke``, ``tracer`` and ``mom``:
the CUDA kernels ``csrc/phase_{lat,uvw,tke,tracer,mom}.cu`` (the
counterparts of the phases of ``extpom_tpu/pallas/phases.py:_kernel``) and
their plain PyTorch versions.

Each ``phase_*`` has the signature of ``core/stepper.py``'s phase of the
JAX package without the operand no kernel reads (``l`` of ``tke``;
``tracer`` takes ``ub`` as a keyword, read by the ``orlanski`` scheme only)
and returns the same tuple.  ``lat`` and ``mom`` take the depth ``d = h +
el``, read by McCalpin's pressure gradient (``npg=2``) and by the ``file``
scheme's ``bc_vel3d``.  Every option of the JAX phases runs in both
versions: ``npg=2``, MPDATA (``nadv=2``, whose ``nitera`` upstream steps
run as launches of their own before the tracer tile, :func:`mpdata`),
interior restoring (``do_restore``) and ``bc_scheme="file"``.
The ``*_plain`` versions run the ops of ``ops/`` and ``bc/``, whose Thomas
solves are ``tridiag.thomas_plain``, so a plain phase launches no
hand-written kernel, on the card either.

With ``off=(oi, oj)`` a phase runs on one ring-extended block of the
decomposed step (``mesh/shardmap.py``; the mesh variant of the TPU kernel,
``windowed_phase(..., rows, lanes, off)``): every field is (.., R, L), the
grid and forcing are extended alike, ``off`` is the global (i, j) of the
block's cell (0, 0), and the domain's extents are ``cfg``'s active ones
(``im_act``/``jm_act`` of a padded grid, ``mesh/padding.py``).  Its
regions and edges are those of the global domain; only the cells whose
inputs the ring covers come out right, and the caller trims the rest.  On
the card it launches the ``*_mesh`` entry of the same source, counted
under ``phase_<p>_mesh``.  A padded grid runs only on blocks there: the
whole-grid entries take the array's extents as the domain's.
"""

from __future__ import annotations

import ctypes
import functools
import re
from typing import NamedTuple

import torch

from extpom_tpu_torch import kernels
from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.diag.profiling import span
from extpom_tpu_torch.kernels import build
from extpom_tpu_torch.ops import (continuity, density, momentum, pressure,
                                  tracers, vertical)
from extpom_tpu_torch.ops.stencil import domain_of, sft, put
from extpom_tpu_torch.bc import bcond as bcf
from extpom_tpu_torch.bc import orlanski as bco

_DTYPES = (torch.float32, torch.float64)
# cells next to a split edge of a block that the last launch of a block
# phase kernel skips (csrc/column.cuh GeomT; mom skips 2, then 4): the ring
# must be at least this wide for the block's own cells to come out
MESH_MARGIN = 4

# ---------------------------------------------------------------------------
# the column tiles of the phase kernels (csrc/column.cuh Tiles)
# ---------------------------------------------------------------------------

SMEM_BYTES = 232_448     # shared memory a block may use on Hopper (227 KB)
# the tile (TI, TJ) by itemsize: the fastest of
# `python -m extpom_tpu_torch.tools.phase_sweep` at 2048x2048x41 on the H100
TILE = {4: (8, 32), 8: (4, 32)}
# ... of uvw, from its own sweep there (2048x2048x41 and 256x256x31)
UVW_TILE = {4: (2, 64), 8: (4, 32)}
# uvw keeps its levels where this many blocks of the kept tile fit an SM:
# in the sweep the kept default tiles beat the ones that read u and v
# again, and a kept tile of one block per SM lost
UVW_KEEP_BLOCKS = 2
TILED = build.TILED
_LAYOUT = ("kStages", "kHalo", "kOwn", "k2D", "kWide", "kFaces",
           "kStageFaces", "kScratch", "kKeep", "kKeepRing", "kMaxThreads")
# ... and, where the source has it, the wide planes its option variant
# adds (lat: McCalpin's d)
_LAYOUT_OPT = ("kWideOpt",)


@functools.lru_cache(maxsize=None)
def layout_constants(phase: str) -> dict:
    """The constants that size the ``phase`` tile kernel's memory, read from
    its source ``csrc/phase_<phase>.cu``: kStages (levels in the ring),
    kHalo (fields staged as the one-cell window), kOwn (fields staged at
    the own column), k2D (arrays on the one-cell window), kWide (2-D fields
    on the two-cell window), kFaces (face pairs, (TI+1) x TJ x faces and
    TI x (TJ+1) y faces, once per tile), kStageFaces (face pairs per level
    of the ring), kScratch (ee/gg rows per level in device scratch), kKeep
    (values per level a column keeps in shared memory when the tile keeps
    its levels), kKeepRing (1: a tile that keeps its levels holds kb-1
    levels of the ring's fields instead of kStages), kMaxThreads, and
    kWideOpt (the wide planes of the option variant; 0 where the source
    has none)."""
    src = (build.CSRC / f"phase_{phase}.cu").read_text()
    find = lambda name: re.search(rf"constexpr int {name} = (\d+);", src)
    out = {name: int(find(name).group(1)) for name in _LAYOUT}
    for name in _LAYOUT_OPT:
        m = find(name)
        out[name] = int(m.group(1)) if m else 0
    return out


class Tile(NamedTuple):
    """TI x TJ columns per block (TJ along j), the block's dynamic shared
    bytes, its ee/gg scratch bytes in device memory (kb x kScratch rows of
    its columns), the depth kb it was planned for and whether it keeps the
    kb levels of each column in shared memory (mom's Asselin pass; uvw's
    u and v between its two passes)."""
    ti: int
    tj: int
    smem: int
    scratch: int
    kb: int
    keep: bool


def _smem(c: dict, ti: int, tj: int, kb: int, keep: bool,
          opt: bool = False) -> int:
    """Shared elements of a ti x tj tile by the kernel's ``layout``: the
    level ring (kb-1 levels deep where a kept tile keeps it), the 2-D
    arrays, the wide window (with the option variant's planes when
    ``opt``), the faces and the kept levels."""
    hc, tc = (ti + 2) * (tj + 2), ti * tj
    fp = (ti + 1) * tj + ti * (tj + 1)
    stages = kb - 1 if keep and c["kKeepRing"] else c["kStages"]
    wide = c["kWide"] + (c["kWideOpt"] if opt else 0)
    return (stages * (c["kHalo"] * hc + c["kOwn"] * tc
                      + c["kStageFaces"] * fp)
            + c["k2D"] * hc + wide * (ti + 4) * (tj + 4)
            + c["kFaces"] * fp + (c["kKeep"] * kb * tc if keep else 0))


def _keeps(c: dict) -> bool:
    """Whether a tile of the kernel with layout ``c`` can keep its
    levels."""
    return bool(c["kKeep"] or c["kKeepRing"])


def column_tile(kb: int, dtype: torch.dtype, phase: str, ti=None, tj=None,
                keep: bool = False, opt: bool = False) -> Tile:
    """The tile of the ``phase`` kernel (one of :data:`TILED`) at ``kb``
    levels in ``dtype``: :data:`TILE` (uvw :data:`UVW_TILE`) unless
    ``ti``/``tj`` are given; with ``keep`` a kernel that can (mom, uvw)
    keeps each column's levels in shared memory; ``opt`` sizes the option
    variant (:func:`variant`).  Raises ValueError where the tile breaks
    the kernel's rules or does not fit a block's shared memory."""
    if phase not in TILED:
        raise ValueError(f"column_tile: no tile kernel for phase {phase!r}")
    c = layout_constants(phase)
    item = torch.finfo(dtype).bits // 8
    dti, dtj = (UVW_TILE if phase == "uvw" else TILE)[item]
    ti, tj = ti or dti, tj or dtj
    if ti < 1 or tj < 32 or tj % 32 or ti * tj > c["kMaxThreads"]:
        raise ValueError(f"column_tile: a {ti}x{tj} tile needs TJ a multiple "
                         f"of 32 and at most {c['kMaxThreads']} columns")
    keep = bool(keep) and _keeps(c)
    smem = _smem(c, ti, tj, kb, keep, opt) * item
    if smem > SMEM_BYTES:
        raise ValueError(
            f"column_tile: phase {phase} in {dtype} with a {ti}x{tj} tile "
            f"needs {smem} bytes of shared memory, more than a block's "
            f"{SMEM_BYTES}")
    return Tile(ti, tj, smem, kb * c["kScratch"] * ti * tj * item, kb,
                keep)


@functools.lru_cache(maxsize=None)
def _tile_info(phase: str, f64: bool, mesh: bool, ti: int, tj: int, kb: int,
               keep: bool, device: int) -> dict:
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        status = getattr(build.library(), f"extpom_phase_{phase}_info")(
            int(f64), int(mesh), ti, tj, kb, int(keep),
            ctypes.cast(out, ctypes.c_void_p))
    build.check(status, f"phase_{phase} tile info")
    return dict(zip(("registers", "static_smem", "dynamic_smem",
                     "blocks_per_sm", "spill_bytes", "sms"), out))


def tile_info(phase: str, dtype: torch.dtype, tile: Tile, mesh: bool = False,
              device=None, orl: bool = False, opt: bool = False) -> dict:
    """What the compiler and the card give the ``phase`` tile kernel with
    ``tile``: registers per thread, static and dynamic shared bytes,
    resident blocks per SM, spill bytes per thread and the SMs of the card
    (from ``cudaFuncGetAttributes`` and
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); with ``orl`` of tke
    or tracer, their orlanski variant's; with ``opt``, the option variant
    of lat or tracer (:func:`variant`).  Builds the kernels; needs a CUDA
    device."""
    device = torch.device("cuda" if device is None else device)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    # the entry's last option: bit 0 mom's and uvw's keep, tke's and
    # tracer's orlanski variant; bit 1 the option variant
    return dict(_tile_info(phase, dtype == torch.float64, mesh, tile.ti,
                           tile.tj, tile.kb,
                           int(tile.keep or orl) | (2 if opt else 0), index))


def variant(phase: str, cfg: Config) -> bool:
    """Whether ``cfg`` runs the option variant of the ``phase`` tile
    kernel: lat's McCalpin pressure gradient (``npg=2``), tracer's MPDATA
    or restoring (``nadv=2``, ``do_restore``).  mom's ``file`` scheme
    changes its perimeter launch only."""
    if phase == "lat":
        return cfg.npg == 2
    if phase == "tracer":
        return cfg.nadv == 2 or cfg.do_restore
    return False


def counter(phase: str, cfg: Config) -> str:
    """The name a launch of the ``phase`` kernel under ``cfg`` counts under
    in ``kernels.LAUNCHES`` (``_mesh`` added on a block): the option
    instantiation's own (lat's McCalpin variant ``phase_lat_npg2``,
    tracer's ``phase_tracer_options``, mom's ``file`` perimeter
    ``phase_mom_file``), else ``phase_<phase>``."""
    if variant(phase, cfg):
        return "phase_lat_npg2" if phase == "lat" else "phase_tracer_options"
    if phase == "mom" and cfg.bc_scheme == "file":
        return "phase_mom_file"
    return f"phase_{phase}"


def reads_depth(phase: str, cfg: Config) -> bool:
    """Whether the ``phase`` under ``cfg`` reads the depth ``d = h + el``:
    lat's McCalpin pressure gradient, mom's ``file`` scheme ``bc_vel3d``;
    elsewhere ``d`` may be None."""
    return ((phase == "lat" and cfg.npg == 2)
            or (phase == "mom" and cfg.bc_scheme == "file"))


@functools.lru_cache(maxsize=None)
def plan_tile(phase: str, dtype: torch.dtype, kb: int, R: int, L: int,
              mesh: bool = False, device=None, ti=None, tj=None,
              keep=None, opt: bool = False) -> tuple:
    """(tile, blocks) of a launch of the ``phase`` tile kernel on (kb, R, L)
    operands: the resident blocks the card gives the tile, at most one per
    tile; uvw one block per tile (its blocks, persistent, drifted apart in
    k and lost 15 % at 2048x2048).  Unless ``keep`` says, mom keeps its
    levels in shared memory where the blocks the card then holds at once
    still cover every tile: the kept levels save device traffic, and the
    fewer blocks per SM cost nothing when one wave runs the grid.  uvw
    keeps them where :data:`UVW_KEEP_BLOCKS` blocks of the kept tile fit an
    SM.  ``opt`` plans the option variant (:func:`variant`)."""
    device = torch.device("cuda" if device is None else device)
    tiles = lambda t: -(-R // t.ti) * -(-L // t.tj)
    if keep is None:
        keep = False
        if _keeps(layout_constants(phase)):
            try:
                kept = column_tile(kb, dtype, phase, ti, tj, keep=True)
            except ValueError:
                kept = None
            if kept is not None:
                info = tile_info(phase, dtype, kept, mesh, device)
                keep = (info["blocks_per_sm"] >= UVW_KEEP_BLOCKS
                        if phase == "uvw" else
                        info["blocks_per_sm"] * info["sms"] >= tiles(kept))
    tile = column_tile(kb, dtype, phase, ti, tj, keep, opt)
    info = tile_info(phase, dtype, tile, mesh, device,
                     **({"opt": True} if opt else {}))
    if info["blocks_per_sm"] < 1:
        raise RuntimeError(f"phase_{phase}: a {tile.ti}x{tile.tj} tile does "
                           f"not fit an SM ({info})")
    if phase == "uvw":
        return tile, tiles(tile)
    return tile, min(tiles(tile), info["blocks_per_sm"] * info["sms"])


def _tile_launch(phase: str, kb: int, x: torch.Tensor, off, tile,
                 opt: bool = False) -> tuple:
    """(geometry ints, scratch, keep) of a launch of the ``phase`` tile
    kernel (its option variant when ``opt``) with ``tile`` (the planned one
    when None) on operands like ``x``: TI, TJ and the blocks; the ee/gg
    scratch of every block (none for a kernel without a solve); whether
    the tile keeps its levels."""
    tile, blocks = plan_tile(phase, x.dtype, kb, *x.shape[-2:],
                             off is not None, x.device,
                             *(tile[:2] if tile else (None, None)),
                             tile.keep if tile else None, opt)
    scratch = [torch.empty(blocks * tile.scratch // x.element_size(),
                           dtype=x.dtype, device=x.device)] \
        if tile.scratch else []
    return (tile.ti, tile.tj, blocks), scratch, tile.keep


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _depth_sum(x, dz3, kbm1: int):
    """sum over k < kbm1 of x[k] dz[k], in ascending k as the phase kernels
    take it: torch.sum's order differs in the last bit, and vertvl's
    continuity integral amplifies that difference in w."""
    acc = x[0] * dz3[0]
    for k in range(1, kbm1):
        acc = acc + x[k] * dz3[k]
    return acc


def phase_lat_plain(grid, cfg: Config, u, v, ub, vb, aam0, rho, rmean, dt,
                    d, ramp):
    """Lateral viscosity + 3-D advection/pressure terms (advance.f:96-141)
    -> (aam, advx, advy, drhox, drhoy); ``d`` is read by ``npg=2``."""
    advx, advy = momentum.advct(grid, cfg, u, v, ub, vb, aam0, dt)
    if cfg.npg == 1:
        drhox, drhoy = pressure.baropg(grid, cfg, rho, rmean, dt, ramp)
    else:
        drhox, drhoy = pressure.baropg_mcc(grid, cfg, rho, rmean, d, dt,
                                           ramp)
    dx, dy = grid.dx, grid.dy
    aam_new = (cfg.horcon * dx * dy
               * torch.sqrt(((sft(u, 1, 0) - u) / dx) ** 2
                            + ((sft(v, 0, 1) - v) / dy) ** 2
                            + 0.5 * (0.25 * (sft(u, 0, 1) + sft(u, 1, 1)
                                             - sft(u, 0, -1) - sft(u, 1, -1))
                                     / dy
                                     + 0.25 * (sft(v, 1, 0) + sft(v, 1, 1)
                                               - sft(v, -1, 0)
                                               - sft(v, -1, 1))
                                     / dx) ** 2))
    aam = put(aam0, aam_new, slice(0, cfg.kbm1), slice(1, -1), slice(1, -1))
    return aam, advx, advy, drhox, drhoy


def phase_uvw_plain(grid, cfg: Config, u, v, w, dt, utb, vtb, utf, vtf, etb,
                    etf, vfluxb, vflux):
    """Depth-mean adjustment of u, v + vertical velocity
    (advance.f:364-400) -> (u, v, w)."""
    kbm1 = cfg.kbm1
    KM1 = slice(0, kbm1)
    dz3 = grid.dz3
    tps = _depth_sum(u, dz3, kbm1)
    u = put(u, (u - tps) + (utb + utf) / (dt + sft(dt, -1, 0)),
            KM1, slice(1, None), slice(None))
    tps = _depth_sum(v, dz3, kbm1)
    v = put(v, (v - tps) + (vtb + vtf) / (dt + sft(dt, 0, -1)),
            KM1, slice(None), slice(1, None))
    w = continuity.vertvl(grid, cfg, w, u, v, dt, etf, etb, vfluxb, vflux)
    w = bco.orl_w(grid, cfg, w)
    return u, v, w


def phase_tke_plain(grid, cfg: Config, q2, q2b, q2l, q2lb, u, v, w, aam, t,
                    s, rho, km, kh, kq, dt, etb, etf, wubot, wvbot, fc):
    """TKE advection + MY-2.5 closure + BC + Asselin (advance.f:406-421)
    -> (q2, q2b, q2l, q2lb, km, kh, kq, l)."""
    q2f = tracers.advq(grid, cfg, q2b, q2, u, v, w, aam, dt, etb, etf)
    q2lf = tracers.advq(grid, cfg, q2lb, q2l, u, v, w, aam, dt, etb, etf)
    (q2f, q2lf, km, kh, kq, l, q2b, q2lb) = vertical.profq(
        grid, cfg, q2f, q2lf, q2, q2b, q2lb, u, v, t, s, rho,
        km, kh, kq, etf, fc.wusurf, fc.wvsurf, wubot, wvbot)
    if cfg.bc_scheme == "orlanski":
        q2f, q2lf = bco.orl_turb(grid, cfg, q2f, q2lf)
    else:
        q2f, q2lf = bcf.bc_turb(grid, cfg, q2f, q2lf, q2, q2l, u, v)
    q2 = q2 + 0.5 * cfg.smoth * (q2f + q2b - 2.0 * q2)
    q2l = q2l + 0.5 * cfg.smoth * (q2lf + q2lb - 2.0 * q2l)
    return q2f, q2, q2lf, q2l, km, kh, kq, l


def phase_tracer_plain(grid, cfg: Config, t, tb, s, sb, tclim, sclim, u, v,
                       w, aam, kh, dt, etb, etf, fc, ub=None):
    """Tracer advection + implicit diffusion + BC + Asselin + restoring +
    EOS (advance.f:424-456) -> (t, tb, s, sb, rho); ``ub`` (the old u) is
    read by the ``orlanski`` scheme's edges only."""
    adv = tracers.advt1 if cfg.nadv == 1 else tracers.advt2
    tf = adv(grid, cfg, tb, t, tclim, u, v, w, aam, dt, etb, etf)
    sf = adv(grid, cfg, sb, s, sclim, u, v, w, aam, dt, etb, etf)
    tf = vertical.proft(grid, cfg, tf, fc.wtsurf, fc.tsurf, cfg.nbct, kh,
                        etf, fc.swrad)
    sf = vertical.proft(grid, cfg, sf, fc.wssurf, fc.ssurf, cfg.nbcs, kh,
                        etf, fc.swrad)
    if cfg.bc_scheme == "orlanski":
        tf, sf = bco.orl_ts(grid, cfg, tf, sf, t, tb, s, sb, ub, fc)
    else:
        tf, sf = bcf.bc_ts(grid, cfg, tf, sf, t, s, u, v, w, dt, fc)

    t = t + 0.5 * cfg.smoth * (tf + tb - 2.0 * t)
    s = s + 0.5 * cfg.smoth * (sf + sb - 2.0 * s)
    tb, t, sb, s = t, tf, s, sf
    if cfg.do_restore:
        t, tb, s, sb = restore(grid, cfg, t, tb, s, sb, fc)
    rho = density.dens(grid, cfg, s, t)
    return t, tb, s, sb, rho


def restore(grid, cfg: Config, t, tb, s, sb, fc):
    """Interior restoring toward ``fc.trstr``/``fc.srstr`` at the rate
    ``fc.taurstr`` [1/day], on levels k < kbm1 of every column, times fsm
    (bounds_forcing.f:1097-1118) -> (t, tb, s, sb)."""
    fac = 2.0 * cfg.dti / 86400.0 * fc.taurstr
    KM1 = slice(0, cfg.kbm1)
    A = (slice(None), slice(None))
    t = put(t, (t + fac * (fc.trstr - t)) * grid.fsm, KM1, *A)
    tb = put(tb, (tb + fac * (fc.trstr - tb)) * grid.fsm, KM1, *A)
    s = put(s, (s + fac * (fc.srstr - s)) * grid.fsm, KM1, *A)
    sb = put(sb, (sb + fac * (fc.srstr - sb)) * grid.fsm, KM1, *A)
    return t, tb, s, sb


def phase_mom_plain(grid, cfg: Config, u, ub, v, vb, w, advx, advy, drhox,
                    drhoy, km, dt, egf, egb, etb, etf, d, fc):
    """Momentum advection + implicit vertical diffusion + BC + Asselin with
    depth-mean correction (advance.f:459-521)
    -> (u, ub, v, vb, wubot, wvbot); ``d`` is read by the ``file``
    scheme's ``bc_vel3d``."""
    kbm1 = cfg.kbm1
    dz3 = grid.dz3
    uf = momentum.advu(grid, cfg, u, ub, v, w, advx, drhox, dt,
                       egf, egb, fc.e_atmos, etb, etf)
    vf = momentum.advv(grid, cfg, v, vb, u, w, advy, drhoy, dt,
                       egf, egb, fc.e_atmos, etb, etf)
    uf, wubot = vertical.profu(grid, cfg, uf, ub, vb, km, etf, fc.wusurf)
    vf, wvbot = vertical.profv(grid, cfg, vf, ub, vb, km, etf, fc.wvsurf)
    if cfg.bc_scheme == "file":
        uf, vf = bcf.bc_vel3d(grid, cfg, uf, vf, u, v, d, fc)
    else:
        uf, vf = bco.orl_vel3d(grid, cfg, uf, vf, u, ub, v, vb)

    tps = _depth_sum(uf + ub - 2.0 * u, dz3, kbm1)
    u = u + 0.5 * cfg.smoth * (uf + ub - 2.0 * u - tps)
    tps = _depth_sum(vf + vb - 2.0 * v, dz3, kbm1)
    v = v + 0.5 * cfg.smoth * (vf + vb - 2.0 * v - tps)
    return uf, u, vf, v, wubot, wvbot


# ---------------------------------------------------------------------------
# operand checks and dispatch
# ---------------------------------------------------------------------------

# each phase's operands after (grid, cfg); the first _N3 are (kb, im, jm),
# the others (im, jm) but for the 0-d ramp and the Forcing fc
_ARGS = {
    "lat": ("u", "v", "ub", "vb", "aam0", "rho", "rmean", "dt", "d", "ramp"),
    "uvw": ("u", "v", "w", "dt", "utb", "vtb", "utf", "vtf", "etb", "etf",
            "vfluxb", "vflux"),
    "tke": ("q2", "q2b", "q2l", "q2lb", "u", "v", "w", "aam", "t", "s", "rho",
            "km", "kh", "kq", "dt", "etb", "etf", "wubot", "wvbot", "fc"),
    "tracer": ("t", "tb", "s", "sb", "tclim", "sclim", "u", "v", "w", "aam",
               "kh", "dt", "etb", "etf", "fc"),
    "mom": ("u", "ub", "v", "vb", "w", "advx", "advy", "drhox", "drhoy",
            "km", "dt", "egf", "egb", "etb", "etf", "d", "fc"),
}
_N3 = {"lat": 7, "uvw": 3, "tke": 14, "tracer": 11, "mom": 10}
# forcing fields the kernel reads: (im, jm), (kb, jm), (kb, im)
_FC = {
    "tke": (("wusurf", "wvsurf"), (), ()),
    "tracer": (("wtsurf", "tsurf", "wssurf", "ssurf", "swrad"),
               ("tbw", "tbe", "sbw", "sbe"), ("tbs", "tbn", "sbs", "sbn")),
    "mom": (("e_atmos", "wusurf", "wvsurf"), (), ()),
}
# ... and those the options add: the file scheme's velocity profiles (mom),
# the restoring series (tracer; taurstr may be one broadcast value)
_FC_FILE = ((), ("ubw", "ube", "vbw", "vbe"), ("ubs", "ubn", "vbs", "vbn"))
RESTORE = ("trstr", "srstr", "taurstr")
# every forcing field a phase reads, under any option (the decomposed step
# cuts only these at the phases' ring)
PHASE_FORCING = frozenset(
    [n for groups in list(_FC.values()) + [_FC_FILE] for g in groups
     for n in g] + list(RESTORE) + ["vflux"])
# grid fields the kernel reads: (im, jm), (kb,)
_GRID = {
    "lat": (("dx", "dy", "aru", "arv", "dum", "dvm"), ("zz", "dzz")),
    "uvw": (("dx", "dy", "fsm"), ("dz",)),
    "tke": (("h", "dx", "dy", "art", "dum", "dvm", "fsm"),
            ("z", "zz", "dz", "dzz")),
    "tracer": (("h", "dx", "dy", "art", "dum", "dvm", "fsm"),
               ("z", "zz", "dz", "dzz")),
    "mom": (("h", "dx", "dy", "aru", "arv", "cor", "cbc", "dum", "dvm"),
            ("dz", "dzz")),
}


def _fc_groups(phase: str, cfg: Config) -> tuple:
    """The forcing fields the ``phase`` kernel reads under ``cfg``, as
    ((im, jm), (kb, jm), (kb, im)) name groups."""
    groups = _FC.get(phase, ((), (), ()))
    if phase == "mom" and cfg.bc_scheme == "file":
        groups = tuple(a + b for a, b in zip(groups, _FC_FILE))
    return groups


def kernel_inputs(phase: str, grid, cfg: Config, *args) -> list:
    """The tensors the phase's kernel reads, in its pointer-table order:
    the state operands (``d`` may be None, a null pointer), the ramp, the
    forcing fields, then the grid fields; :func:`option_inputs` gives the
    operands the options add."""
    named = dict(zip(_ARGS[phase], args))
    fc, ramp = named.pop("fc", None), named.pop("ramp", None)
    out = list(named.values())
    if ramp is not None:
        out.append(ramp)
    for group in _FC.get(phase, ()):
        out += [getattr(fc, n) for n in group]
    two, one = _GRID[phase]
    out += [getattr(grid, n) for n in two + one]
    return out


def option_inputs(phase: str, grid, cfg: Config, fc) -> list:
    """The operands the options add to the phase's pointer table, after
    its outputs and scratch, None (a null pointer) where the option is
    off: mom's ``file`` series and ``grid.hmax``, tracer's restoring
    series."""
    if phase == "mom":
        on = cfg.bc_scheme == "file"
        return ([getattr(fc, n) for n in _FC_FILE[1] + _FC_FILE[2]]
                + [grid.hmax] if on else [None] * 9)
    if phase == "tracer":
        return ([getattr(fc, n) for n in RESTORE] if cfg.do_restore
                else [None] * 3)
    return []


def _check(phase: str, grid, cfg: Config, args, off=None) -> torch.device:
    """Validate every operand of a phase (state, grid and forcing) before
    any dispatch; returns their device.  The horizontal extents are the
    grid's (im, jm), or a block's (R, L) when ``off`` is given."""
    if not isinstance(args[0], torch.Tensor):
        raise TypeError(f"phase_{phase}: operands must be tensors")
    kb, im, jm = cfg.kb, cfg.im, cfg.jm
    if off is not None:
        im, jm = args[0].shape[-2:]
        if len(off) != 2 or not all(isinstance(o, int) for o in off):
            raise TypeError(f"phase_{phase}: off must be two ints")
    dtype, device = args[0].dtype, args[0].device
    if dtype not in _DTYPES:
        raise TypeError(f"phase_{phase}: dtype {dtype} not supported")
    if phase in ("tke", "tracer", "mom") and kb < 4:
        raise ValueError(f"phase_{phase}: the vertical solve needs kb >= 4, "
                         f"got {kb}")
    shape = {"ramp": ()}
    named = []
    for k, (n, x) in enumerate(zip(_ARGS[phase], args)):
        if n == "fc":
            sides = ((im, jm), (kb, jm), (kb, im))
            for group, sh in zip(_fc_groups(phase, cfg), sides):
                named += [(f, getattr(x, f), sh) for f in group]
            if phase == "tracer" and cfg.do_restore:
                tau = x.taurstr
                one = isinstance(tau, torch.Tensor) and tau.numel() == 1
                named += [(f, getattr(x, f), (kb, im, jm))
                          for f in RESTORE[:2]]
                named.append(("taurstr", tau,
                              tuple(tau.shape) if one else (kb, im, jm)))
        elif not (n == "d" and x is None and not reads_depth(phase, cfg)):
            named.append((n, x, shape.get(n, (kb, im, jm) if k < _N3[phase]
                                          else (im, jm))))
    two, one = _GRID[phase]
    named += ([(n, getattr(grid, n), (im, jm)) for n in two]
              + [(n, getattr(grid, n), (kb,)) for n in one])
    if phase == "mom" and cfg.bc_scheme == "file":
        named.append(("hmax", grid.hmax, ()))
    for name, x, sh in named:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"phase_{phase}: {name} must be a tensor")
        if tuple(x.shape) != sh:
            raise ValueError(f"phase_{phase}: {name} is {tuple(x.shape)}, "
                             f"expected {sh}")
        if x.dtype != dtype or x.device != device:
            raise TypeError(f"phase_{phase}: {name} differs in dtype or "
                            f"device")
        if not x.is_contiguous():
            raise ValueError(f"phase_{phase}: {name} must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise TypeError(f"phase_{phase}: unsupported device {device}")
    if device.type == "cuda" and off is None:
        kernels.whole_grid_only(cfg, f"phase_{phase}")
    return device


def _tke_params(cfg: Config) -> list:
    """The parameter table of ``csrc/phase_tke.cu``: each constant of the
    plain tke phase as its Python expression forms it."""
    v = vertical
    a1, b1, a2, b2, c1 = v.MY_A1, v.MY_B1, v.MY_A2, v.MY_B2, v.MY_C1
    return [cfg.dti2, -cfg.dti2, 2.0 * cfg.umol, 2.0 * cfg.dti2,
            -2.0 * cfg.dti2, cfg.dti, 0.5 * cfg.smoth, cfg.grav,
            (cfg.grav ** 2) * 2.0, cfg.grav * cfg.rhoref, cfg.tbias,
            cfg.sbias, cfg.kappa, -cfg.kappa, cfg.small,
            (b1 ** (2.0 / 3.0)) * v.MY_SEF,
            (15.8 * v.MY_CBCNST) ** (2.0 / 3.0), v.MY_SURFL, v.MY_SEF,
            v.MY_SHIW, b1, v.MY_E1, v.MY_E2, a1, a2, 6.0 * a1 / b1,
            1.0 - 3.0 * c1, 3.0 * a2 * b2, 18.0 * a1 * a2,
            18.0 * a1 * a1 + 9.0 * a1 * a2, 9.0 * a1 * a2]


def _launch(phase: str, tensors, prm, cfg: Config, opt0=0, opt1=0,
            off=None, geo=(), entry=None, count=None) -> None:
    """Call ``extpom_phase_<phase>_<f32|f64>`` (``extpom_phase_<phase>_mesh_
    <f32|f64>`` on a block at ``off``; ``extpom_<entry>_...`` for another
    entry of the phase's source) with a pointer table of ``tensors`` (None
    a null pointer), a parameter table of the doubles ``prm`` and the
    geometry integers ``geo`` of the tile kernels; counts one launch under
    ``count`` (:func:`counter`'s name) or the entry's name, ``_mesh``
    added on a block."""
    x = next(t for t in tensors if t is not None)
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
    params = (ctypes.c_double * len(prm))(*prm)
    lib = build.library()
    suffix = "f32" if x.dtype == torch.float32 else "f64"
    name = entry or f"phase_{phase}"
    name = name if off is None else f"{name}_mesh"
    fn = getattr(lib, f"extpom_{name}_{suffix}")
    block = () if off is None else (*x.shape[-2:], *off)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        status = fn(ctypes.cast(ptrs, ctypes.c_void_p),
                    ctypes.cast(params, ctypes.c_void_p), cfg.kb,
                    *cfg.active, *block, opt0, opt1, *geo, stream)
    build.check(status, f"{name} kernel")
    count = count or entry or f"phase_{phase}"
    kernels.LAUNCHES[count if off is None else f"{count}_mesh"] += 1


def _plain(phase: str, grid, cfg: Config, args, off, **kw):
    """The plain phase, on a block under its DomainCtx when ``off`` is
    given; ``kw`` are its keyword operands (tracer's ub)."""
    with domain_of(cfg, off):
        return globals()[f"phase_{phase}_plain"](grid, cfg, *args, **kw)


def _empty(like: torch.Tensor, n: int, cfg: Config = None,
           off=None) -> list:
    """``n`` fresh tensors shaped like ``like`` (each its own allocation, so
    an output kept in the state holds no other output alive).  A block
    kernel leaves some of its cells outside the domain unwritten (the
    caller trims them); on a padded grid the pad cells among them may be
    the block's own, so where the block at ``off`` reaches the pad the
    outputs start as 0, the pad's land value, which the plain versions
    leave there too."""
    if off is not None and cfg is not None and cfg.is_padded:
        ia, ja = cfg.active
        if off[0] + like.shape[-2] > ia or off[1] + like.shape[-1] > ja:
            return [torch.zeros_like(like) for _ in range(n)]
    return [torch.empty_like(like) for _ in range(n)]


# ---------------------------------------------------------------------------
# the phases
# ---------------------------------------------------------------------------


def phase_lat(grid, cfg: Config, u, v, ub, vb, aam0, rho, rmean, dt, d,
              ramp, off=None, tile=None):
    """-> (aam, advx, advy, drhox, drhoy); CUDA tensors launch
    ``csrc/phase_lat.cu`` (its McCalpin variant under ``npg=2``) with
    ``tile`` (:func:`column_tile`'s by default), CPU tensors run
    :func:`phase_lat_plain`; ``d`` may be None unless ``npg=2``."""
    args = (u, v, ub, vb, aam0, rho, rmean, dt, d, ramp)
    if _check("lat", grid, cfg, args, off).type == "cpu":
        return _plain("lat", grid, cfg, args, off)
    out = _empty(u, 5, cfg, off)
    mcc = variant("lat", cfg)
    geo, _, _ = _tile_launch("lat", cfg.kb, u, off, tile, mcc)
    _launch("lat", kernel_inputs("lat", grid, cfg, *args) + out,
            [cfg.horcon, cfg.grav], cfg, int(mcc), off=off, geo=geo,
            count=counter("lat", cfg))
    return tuple(out)


def phase_uvw(grid, cfg: Config, u, v, w, dt, utb, vtb, utf, vtf, etb, etf,
              vfluxb, vflux, off=None, tile=None):
    """-> (u, v, w); CUDA tensors launch ``csrc/phase_uvw.cu`` with ``tile``
    (:func:`column_tile`'s by default), CPU tensors run
    :func:`phase_uvw_plain`."""
    args = (u, v, w, dt, utb, vtb, utf, vtf, etb, etf, vfluxb, vflux)
    if _check("uvw", grid, cfg, args, off).type == "cpu":
        return _plain("uvw", grid, cfg, args, off)
    out = _empty(u, 3, cfg, off)
    geo, _, keep = _tile_launch("uvw", cfg.kb, u, off, tile)
    _launch("uvw", kernel_inputs("uvw", grid, cfg, *args) + out, [cfg.dti2],
            cfg, int(keep), off=off, geo=geo)
    return tuple(out)


def uvw_device_launches() -> int:
    """Kernels the library's uvw entries launched so far (one per call of
    :func:`phase_uvw`, on the grid or on a block)."""
    return build.library().extpom_phase_uvw_launches()


def phase_tke(grid, cfg: Config, q2, q2b, q2l, q2lb, u, v, w, aam, t, s, rho,
              km, kh, kq, dt, etb, etf, wubot, wvbot, fc, off=None,
              tile=None):
    """-> (q2, q2b, q2l, q2lb, km, kh, kq, l); CUDA tensors launch
    ``csrc/phase_tke.cu`` with ``tile`` (:func:`column_tile`'s by default),
    CPU tensors run :func:`phase_tke_plain`."""
    args = (q2, q2b, q2l, q2lb, u, v, w, aam, t, s, rho, km, kh, kq, dt, etb,
            etf, wubot, wvbot, fc)
    if _check("tke", grid, cfg, args, off).type == "cpu":
        return _plain("tke", grid, cfg, args, off)
    out = _empty(q2, 8, cfg, off)
    geo, eg, _ = _tile_launch("tke", cfg.kb, q2, off, tile)
    _launch("tke", kernel_inputs("tke", grid, cfg, *args) + out + eg,
            _tke_params(cfg), cfg, int(cfg.bc_scheme == "orlanski"),
            off=off, geo=geo)
    return tuple(out)


def mpdata_radius(cfg: Config) -> int:
    """Cells of the inputs that MPDATA's result at a cell reads along i
    and j: each of the ``nitera`` upstream steps reads the previous field
    and the antidiffusive velocities one cell either way, and those read
    the previous field at i-1 (j-1) and i (j), so the field after n steps
    reaches n cells; the closing diffusion reads fb and aam one cell
    away."""
    return max(cfg.nitera, 1)


# the tile (TI, TJ) of csrc/phase_mpdata.cu by itemsize (its kTileI,
# kTileJ: compiled in)
MPDATA_TILE = {4: (16, 32), 8: (8, 32)}
# the resident blocks the planner counts on where the card has not said
# (two blocks of the f32 kernel fit an SM, by its launch bounds and shared
# memory; one of the f64), and the SMs (H100 SXM)
MPDATA_RESIDENT = {4: 2, 8: 1}
H100_SMS = 132
_MPDATA_LAYOUT = ("kInRing", "kInVelRing", "kFieldRing", "kVelRing", "k2D",
                  "kTable", "kMaxGroup", "kMaxHalo", "kMaxThreads")


@functools.lru_cache(maxsize=None)
def mpdata_layout() -> dict:
    """The constants that size the MPDATA kernel's shared memory, read from
    ``csrc/phase_mpdata.cu``: the levels of the input field's ring
    (kInRing), of the input velocities' rings (kInVelRing), of a step's
    field (kFieldRing) and velocities (kVelRing), the 2-D planes (k2D), the
    32-bit planes of the cell table (kTable), the most steps a launch
    chains (kMaxGroup), the widest halo compiled (kMaxHalo) and
    kMaxThreads."""
    src = (build.CSRC / "phase_mpdata.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                src).group(1)) for name in _MPDATA_LAYOUT}


def _mpdata_smem(steps: int, halo: int, ti: int, tj: int, item: int) -> int:
    """Shared bytes of a launch of ``steps`` steps with ``halo``: the planes
    of the kernel's ``planes(ns)`` and its cell table over the
    (ti + 2 halo) x (tj + 2 halo) box (``smem_bytes``)."""
    c = mpdata_layout()
    planes = (c["kInRing"] + 3 * c["kInVelRing"] + c["kFieldRing"] * steps
              + 3 * c["kVelRing"] * (steps - 1) + c["k2D"])
    return (ti + 2 * halo) * (tj + 2 * halo) * (planes * item
                                                + 4 * c["kTable"])


class MpdataPlan(NamedTuple):
    """The launches of MPDATA's steps on (kb, R, L) operands: TI x TJ tiles
    of ``threads`` threads, ``groups`` steps per launch in order and the
    halo of each (``halos``; the first launch is the longest and widest),
    the shared bytes per block of the widest (``smem``), the most steps one
    launch chains (``group``, G), the launches per tracer phase, the chunks
    of levels each column is cut into and the blocks of each launch (tiles
    x chunks, for T and for S)."""
    ti: int
    tj: int
    threads: int
    groups: tuple
    halos: tuple
    group: int
    smem: int
    launches: int
    chunks: int
    blocks: int


@functools.lru_cache(maxsize=None)
def mpdata_plan(nitera: int, dtype: torch.dtype, kb: int, R: int, L: int,
                threads=None, chunks=None, slots=None) -> MpdataPlan:
    """How ``csrc/phase_mpdata.cu`` runs ``nitera`` upstream steps on
    (kb, R, L) operands in ``dtype``, on the tiles of :data:`MPDATA_TILE`.
    A launch of n steps has a halo of n cells (n + 1 where another launch
    follows: its last step's velocities read that step's field at i-1 and
    j-1); G is the most steps (at most kMaxGroup, halos up to kMaxHalo)
    whose launch fits a block's shared memory, and the ``nitera`` steps run
    as the fewest launches of at most G steps, the longer ones first.
    ``threads`` is by default one per cell of the first step's domain (the
    first launch's box less a cell each side), at most kMaxThreads.  Unless
    ``chunks`` says, each column is cut into the chunks of levels that
    minimise the waves of blocks times the levels a block walks (its chunk,
    widened by the halo), where ``slots`` blocks run at once (the card's
    resident blocks per SM times its SMs; :data:`MPDATA_RESIDENT` on an
    H100 by default): the whole column where the tiles fill the card, more
    chunks where they leave SMs idle.  Raises ValueError where one step
    does not fit."""
    item = torch.finfo(dtype).bits // 8
    ti, tj = MPDATA_TILE[item]
    c = mpdata_layout()
    nitera = max(int(nitera), 1)
    fits = lambda n, halo: (halo <= c["kMaxHalo"] and
                            _mpdata_smem(n, halo, ti, tj, item) <= SMEM_BYTES)
    g = 0
    for n in range(1, min(nitera, c["kMaxGroup"]) + 1):
        if fits(n, n) and (n == nitera or fits(n, n + 1)):
            g = n
    if g == 0:
        raise ValueError(f"mpdata_plan: one step of a {ti}x{tj} tile in "
                         f"{dtype} does not fit a block's shared memory")
    count = -(-nitera // g)
    groups = tuple(nitera // count + (k < nitera % count)
                   for k in range(count))
    halos = [n + (k + 1 < count) for k, n in enumerate(groups)]
    smem = max(_mpdata_smem(n, h, ti, tj, item)
               for n, h in zip(groups, halos))
    # a thread per cell of the first step's domain (the box less a cell
    # each side), as far as a block takes them
    box1 = (ti + 2 * halos[0] - 2) * (tj + 2 * halos[0] - 2)
    threads = threads or min(-(-box1 // 32) * 32, c["kMaxThreads"])
    if threads % 32 or not 32 <= threads <= c["kMaxThreads"]:
        raise ValueError(f"mpdata_plan: {threads} threads; a block takes a "
                         f"multiple of 32 up to {c['kMaxThreads']}")
    tiles = 2 * -(-R // ti) * -(-L // tj)
    if chunks is None:
        slots = slots or MPDATA_RESIDENT[item] * H100_SMS
        walk = lambda k: (-(-tiles * k // slots)
                          * (-(-kb // k) + max(halos) + max(groups)))
        chunks = min(range(1, kb + 1), key=walk)
    chunks = max(1, min(int(chunks), kb))
    return MpdataPlan(ti, tj, threads, groups, tuple(halos), g, smem, count,
                      chunks, tiles * chunks)


@functools.lru_cache(maxsize=None)
def _mpdata_info(f64: bool, mesh: bool, steps: int, halo: int,
                 threads: int, smem: int, device: int) -> dict:
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        status = build.library().extpom_phase_tracer_mpdata_info(
            int(f64), int(mesh), steps, halo, threads, smem,
            ctypes.cast(out, ctypes.c_void_p))
    build.check(status, "phase_tracer_mpdata info")
    return dict(zip(("registers", "static_smem", "dynamic_smem",
                     "blocks_per_sm", "spill_bytes", "sms"), out))


def mpdata_info(dtype: torch.dtype, plan: MpdataPlan, mesh: bool = False,
                device=None) -> dict:
    """What the compiler and the card give the MPDATA kernel under
    ``plan`` (the instantiation of its first launch, the longest and
    widest, at the plan's shared memory): registers, static and dynamic
    shared bytes, resident blocks per SM, spill bytes, SMs.  Builds the
    kernels; needs a CUDA device."""
    device = torch.device("cuda" if device is None else device)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return dict(_mpdata_info(dtype == torch.float64, mesh, plan.groups[0],
                             plan.halos[0], plan.threads, plan.smem, index))


def mpdata(grid, cfg: Config, t, tb, s, sb, u, v, w, dt, etb, etf,
           off=None, plan=None) -> tuple:
    """The ``nitera`` MPDATA upstream steps of T and S (``ops/tracers.py:
    advt2`` before its closing diffusion) -> (F_t, F_s), ff after the last
    step's fsm mask.  CUDA tensors launch ``csrc/phase_mpdata.cu``'s
    ``k_mpdata_tile`` as ``plan`` (:func:`mpdata_plan`'s by default) says,
    one launch per group of steps, T and S in each, counted under
    ``phase_tracer_mpdata`` (``_mesh`` on a block); CPU tensors run
    :func:`mpdata_plain`.  ``off`` as the phases'."""
    if t.device.type == "cpu":
        with domain_of(cfg, off):
            return mpdata_plain(grid, cfg, t, tb, s, sb, u, v, w, dt, etb,
                                etf)
    if off is None:
        kernels.whole_grid_only(cfg, "mpdata")
    return _mpdata_launch(grid, cfg, t, tb, s, sb, u, v, w, dt, etb, etf,
                          off, plan)


def mpdata_plain(grid, cfg: Config, t, tb, s, sb, u, v, w, dt, etb,
                 etf) -> tuple:
    """:func:`mpdata`'s plain version: advt2's upstream steps of T and
    S."""
    return tuple(tracers.mpdata_steps(grid, cfg, fb, f, u, v, w, dt, etb,
                                      etf)[0] for f, fb in ((t, tb), (s, sb)))


def mpdata_launch_plan(cfg: Config, t: torch.Tensor,
                       mesh: bool = False) -> MpdataPlan:
    """The plan :func:`mpdata` launches on CUDA operands like ``t`` (on a
    block when ``mesh``): its chunks from the blocks the card holds at
    once."""
    plan = mpdata_plan(cfg.nitera, t.dtype, *t.shape, chunks=1)
    info = mpdata_info(t.dtype, plan, mesh, t.device)
    return mpdata_plan(cfg.nitera, t.dtype, *t.shape,
                       slots=max(info["blocks_per_sm"], 1) * info["sms"])


def mpdata_inputs(grid, t, tb, s, sb, u, v, w, dt, etb, etf) -> list:
    """The operands the MPDATA kernel reads, in its pointer-table order:
    the 3-D fields, the ten 2-D fields (``csrc/phase_mpdata.cu``'s D*
    order), dz and dzz; the group before's fields and velocities and the
    outputs follow them."""
    return [t, s, tb, sb, u, v, w, dt, grid.dx, grid.dy, grid.h, grid.art,
            grid.aru, grid.arv, grid.fsm, etb, etf, grid.dz, grid.dzz]


def _mpdata_launch(grid, cfg: Config, t, tb, s, sb, u, v, w, dt, etb, etf,
                   off, plan=None) -> tuple:
    """:func:`mpdata` on CUDA tensors: a launch per group of steps, each
    into fresh fields; a group that another follows also writes its last
    step's velocities, which the next one reads."""
    plan = plan or mpdata_launch_plan(cfg, t, off is not None)
    ins = mpdata_inputs(grid, t, tb, s, sb, u, v, w, dt, etb, etf)
    prm = [cfg.dti2, cfg.sw, tracers.MPDATA_VALUE_MIN,
           tracers.MPDATA_EPSILON]
    fin, vin = [None] * 2, [None] * 6      # the group before's
    for k, steps in enumerate(plan.groups):
        fout = _empty(t, 2)
        vout = _empty(t, 6) if k + 1 < plan.launches else [None] * 6
        _launch("tracer", ins + fin + vin + fout + vout, prm, cfg, steps,
                plan.threads, off=off, geo=(plan.ti, plan.tj, plan.chunks),
                entry="phase_tracer_mpdata")
        fin, vin = fout, vout
    return tuple(fin)


def phase_tracer(grid, cfg: Config, t, tb, s, sb, tclim, sclim, u, v, w,
                 aam, kh, dt, etb, etf, fc, off=None, tile=None, ub=None):
    """-> (t, tb, s, sb, rho); CUDA tensors launch ``csrc/phase_tracer.cu``
    (under ``nadv=2`` after :func:`mpdata`'s launches, and its option
    variant under ``nadv=2`` or ``do_restore``) with ``tile``
    (:func:`column_tile`'s by default), CPU tensors run
    :func:`phase_tracer_plain`.  ``ub`` (kb, im, jm), the old u, is an
    operand of the ``orlanski`` scheme only."""
    args = (t, tb, s, sb, tclim, sclim, u, v, w, aam, kh, dt, etb, etf, fc)
    device = _check("tracer", grid, cfg, args, off)
    orl = cfg.bc_scheme == "orlanski"
    if orl and (not isinstance(ub, torch.Tensor) or ub.shape != t.shape
                or ub.dtype != t.dtype or ub.device != t.device
                or not ub.is_contiguous()):
        raise ValueError("phase_tracer: the orlanski scheme needs ub, a "
                         "contiguous tensor like t")
    if device.type == "cpu":
        return _plain("tracer", grid, cfg, args, off, ub=ub)
    for nbc in (cfg.nbct, cfg.nbcs):
        if nbc not in (1, 2, 3, 4):
            raise ValueError(f"invalid nbc {nbc}")
    # MPDATA's upstream steps (null: the tile forms advt1 itself)
    adv = [None, None]
    if cfg.nadv == 2:
        with span("mpdata"):
            adv = list(_mpdata_launch(grid, cfg, t, tb, s, sb, u, v, w, dt,
                                      etb, etf, off))
    opt = variant("tracer", cfg)
    out = _empty(t, 5, cfg, off)
    ntp = cfg.ntp - 1
    geo, eg, _ = _tile_launch("tracer", cfg.kb, t, off, tile, opt)
    # orl_ts (selected by a non-null ub): the old u, and the strip of the
    # solved T and S one cell inside each edge for the perimeter launch
    # (2 tracers x 2 sides x kb rows of L, then of R)
    R, L = t.shape[-2:]
    edge = [ub, t.new_empty(4 * cfg.kb * (R + L))] if orl else [None, None]
    # the restoring series (selected by a non-null trstr), null otherwise
    _launch("tracer", kernel_inputs("tracer", grid, cfg, *args) + out + eg
            + edge + option_inputs("tracer", grid, cfg, fc) + adv,
            [cfg.dti2, cfg.dti, cfg.tprni, cfg.umol, cfg.smoth, cfg.tbias,
             cfg.sbias, cfg.grav, cfg.rhoref, vertical._R_JERLOV[ntp],
             vertical._AD1_JERLOV[ntp], vertical._AD2_JERLOV[ntp],
             2.0 * cfg.dti / 86400.0,
             float(cfg.do_restore and fc.taurstr.numel() == 1)],
            cfg, cfg.nbct, cfg.nbcs, off=off, geo=geo,
            count=counter("tracer", cfg))
    return tuple(out)


def phase_mom(grid, cfg: Config, u, ub, v, vb, w, advx, advy, drhox, drhoy,
              km, dt, egf, egb, etb, etf, d, fc, off=None, tile=None):
    """-> (u, ub, v, vb, wubot, wvbot); CUDA tensors launch
    ``csrc/phase_mom.cu`` (its perimeter launch takes ``bc_vel3d`` under
    the ``file`` scheme) with ``tile`` (:func:`column_tile`'s by default),
    CPU tensors run :func:`phase_mom_plain`; ``d`` may be None unless the
    scheme is ``file``."""
    args = (u, ub, v, vb, w, advx, advy, drhox, drhoy, km, dt, egf, egb, etb,
            etf, d, fc)
    if _check("mom", grid, cfg, args, off).type == "cpu":
        return _plain("mom", grid, cfg, args, off)
    out = _empty(u, 4, cfg, off) + _empty(dt, 2, cfg, off)
    geo, eg, keep = _tile_launch("mom", cfg.kb, u, off, tile)
    # the solved uf of rows 2 and im-2, vf of columns 2 and jm-2
    R, L = u.shape[-2:]
    strip = u.new_empty(2 * cfg.kb * (L + R))
    # the operands, outputs and scratch, then (file scheme; null
    # otherwise) the eight velocity profiles and hmax
    _launch("mom", kernel_inputs("mom", grid, cfg, *args) + out + eg
            + [strip] + option_inputs("mom", grid, cfg, fc),
            [cfg.dti2, cfg.grav, cfg.umol, cfg.smoth], cfg, int(keep),
            int(cfg.bc_scheme == "file"), off=off, geo=geo,
            count=counter("mom", cfg))
    return tuple(out)
