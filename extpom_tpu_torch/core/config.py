"""Run configuration: the physics and numerics fields of the reference's
namelist (``extpom_tpu/core/config.py``), with the same names and defaults.

The TPU schedule knobs of the JAX package (``pallas_*``, ``phase_block``,
``extwin_budget_mb``, ``scan_unroll``, ``ext_unroll``, ...) have no
counterpart: the port dispatches by the tensors' device.  It keeps the ring
widths and chunking of the decomposed step (``phase_halo``,
``ext_halo_sub``, ``extwin_chunk``, ``ext_local_chunk``), which set what it
computes on each block, not only how fast.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Config:
    # -- domain geometry --
    im: int
    jm: int
    kb: int
    im_act: Optional[int] = None
    jm_act: Optional[int] = None

    # -- mode switches --
    mode: int = 3          # 2: 2-D only, 3: full 3-D, 4: 3-D with frozen T/S
    nadv: int = 1          # 1: central tracer advection, 2: MPDATA
    nitera: int = 1
    sw: float = 0.5
    npg: int = 1           # 1: 2nd-order pressure gradient, 2: McCalpin

    # -- time stepping --
    dte: float = 6.0
    isplit: int = 30
    days: float = 0.05
    prtd1: float = 0.1
    prtd2: float = 1.0
    swtch: float = 9999.0
    write_rst: float = 1.0

    # -- physical constants --
    lramp: bool = False
    rhoref: float = 1025.0
    tbias: float = 0.0
    sbias: float = 0.0
    grav: float = 9.806
    kappa: float = 0.4
    z0b: float = 0.01
    cbcmin: float = 0.0025
    cbcmax: float = 1.0
    horcon: float = 0.1
    tprni: float = 0.1
    umol: float = 2.0e-5
    vmaxl: float = 100.0
    slmax: float = 2.0
    ntp: int = 2
    nbct: int = 1
    nbcs: int = 1
    ispadv: int = 1
    smoth: float = 0.10
    alpha: float = 0.0
    aam_init: float = 0.0
    small: float = 1.0e-9

    # -- boundary conditions --
    bc_scheme: str = "extpom"
    rfe: float = 1.0
    rfw: float = 1.0
    rfn: float = 1.0
    rfs: float = 1.0

    # -- feature gates --
    do_restore: bool = False
    calc_wr: bool = False

    # -- numerics --
    dtype: str = "float32"

    # -- decomposed step (mesh/shardmap.py, mesh/extchunk.py) --
    phase_halo: int = 8        # ring cells per split side for the phases
                               # (>= the chained stencil radius of any one)
    extwin_chunk: int = 10     # external substeps per ring exchange, at most
    ext_local_chunk: str = "auto"   # "off": one substep per exchange
    ext_halo_sub: int = 3      # ring cells a substep consumes (radius 2,
                               # + 1 for the metrics of ext_precompute)

    # -- forcing series (forcing/device.py) --
    forcing_hbm_mb: int = 512  # device budget of a staged series: beyond
                               # it run_segment stages a window per segment

    # derived quantities (initialize.f:177-191)
    @property
    def dti(self) -> float:
        return self.dte * float(self.isplit)

    @property
    def dte2(self) -> float:
        return self.dte * 2.0

    @property
    def dti2(self) -> float:
        return self.dti * 2.0

    @property
    def iend(self) -> int:
        return max(int(round(self.days * 86400.0 / self.dti)), 2)

    @property
    def iprint(self) -> int:
        return max(int(round(self.prtd1 * 86400.0 / self.dti)), 1)

    @property
    def iswtch(self) -> int:
        return int(round(self.swtch * 86400.0 / self.dti))

    @property
    def iprint2(self) -> int:
        return max(int(round(self.prtd2 * 86400.0 / self.dti)), 1)

    @property
    def irestart(self) -> int:
        return max(int(round(self.write_rst * 86400.0 / self.dti)), 1)

    @property
    def ispi(self) -> float:
        return 1.0 / float(self.isplit)

    @property
    def isp2i(self) -> float:
        return 1.0 / (2.0 * float(self.isplit))

    @property
    def kbm1(self) -> int:
        return self.kb - 1

    @property
    def kbm2(self) -> int:
        return self.kb - 2

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "float64": torch.float64}[self.dtype]

    @property
    def active(self) -> Tuple[int, int]:
        """The physical extents (im_act, jm_act) of a possibly padded grid
        (``mesh/padding.py``): the array's where it is not padded."""
        return self.im_act or self.im, self.jm_act or self.jm

    @property
    def is_padded(self) -> bool:
        return self.active != (self.im, self.jm)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        if self.mode not in (2, 3, 4):
            raise ValueError(f"invalid mode {self.mode}")
        if self.nadv not in (1, 2):
            raise ValueError(f"invalid nadv {self.nadv}")
        if self.npg not in (1, 2):
            raise ValueError(f"invalid npg {self.npg}")
        if self.nbcs not in (1, 3):
            raise ValueError("only nbcs in (1, 3) allowed for salinity")
        if not 1 <= self.ntp <= 5:
            raise ValueError(f"invalid Jerlov water type ntp={self.ntp}")
        if self.bc_scheme not in ("extpom", "file", "orlanski"):
            raise ValueError(f"invalid bc_scheme {self.bc_scheme}")
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"invalid dtype {self.dtype}")
        if self.ext_local_chunk not in ("auto", "off"):
            raise ValueError(f"invalid ext_local_chunk {self.ext_local_chunk}")
        if self.kb < 3 or self.im < 5 or self.jm < 5:
            raise ValueError("domain too small")
        if self.im_act is not None and not 5 <= self.im_act <= self.im:
            raise ValueError("im_act out of range")
        if self.jm_act is not None and not 5 <= self.jm_act <= self.jm:
            raise ValueError("jm_act out of range")
