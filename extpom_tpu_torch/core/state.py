"""Model state and forcing (``extpom_tpu/core/state.py``): dataclasses of
tensors.  :class:`State` carries the prognostic fields the reference keeps in
its restart file plus the accumulators the step needs across calls;
:class:`Forcing` the per-step surface and lateral boundary values."""

from __future__ import annotations

import dataclasses

import torch

from extpom_tpu_torch.core.config import Config


@dataclasses.dataclass
class State:
    # ---- 2-D fields (im, jm) ----
    el: torch.Tensor
    elb: torch.Tensor
    et: torch.Tensor
    etb: torch.Tensor
    etf: torch.Tensor
    ua: torch.Tensor
    uab: torch.Tensor
    va: torch.Tensor
    vab: torch.Tensor
    utb: torch.Tensor
    vtb: torch.Tensor
    egb: torch.Tensor
    adx2d: torch.Tensor
    ady2d: torch.Tensor
    advua: torch.Tensor
    advva: torch.Tensor
    aam2d: torch.Tensor
    drx2d: torch.Tensor
    dry2d: torch.Tensor
    wubot: torch.Tensor
    wvbot: torch.Tensor
    vfluxb: torch.Tensor
    vfluxf: torch.Tensor
    # ---- 3-D fields (kb, im, jm) ----
    u: torch.Tensor
    ub: torch.Tensor
    v: torch.Tensor
    vb: torch.Tensor
    w: torch.Tensor
    t: torch.Tensor
    tb: torch.Tensor
    s: torch.Tensor
    sb: torch.Tensor
    rho: torch.Tensor
    q2: torch.Tensor
    q2b: torch.Tensor
    q2l: torch.Tensor
    q2lb: torch.Tensor
    km: torch.Tensor
    kh: torch.Tensor
    kq: torch.Tensor
    l: torch.Tensor
    aam: torch.Tensor

    @property
    def dtype(self) -> torch.dtype:
        return self.el.dtype

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def field_names() -> tuple:
        return tuple(f.name for f in dataclasses.fields(State))


@dataclasses.dataclass
class Forcing:
    # surface fluxes (im, jm)
    wusurf: torch.Tensor
    wvsurf: torch.Tensor
    wtsurf: torch.Tensor
    wssurf: torch.Tensor
    swrad: torch.Tensor
    vflux: torch.Tensor
    e_atmos: torch.Tensor
    tsurf: torch.Tensor
    ssurf: torch.Tensor
    # lateral open-boundary series: j-sides (jm,), i-sides (im,)
    elw: torch.Tensor
    ele: torch.Tensor
    els: torch.Tensor
    eln: torch.Tensor
    uabw: torch.Tensor
    uabe: torch.Tensor
    vabs: torch.Tensor
    vabn: torch.Tensor
    uabs: torch.Tensor
    uabn: torch.Tensor
    vabw: torch.Tensor
    vabe: torch.Tensor
    # 3-D boundary profiles: (kb, jm) on j-sides, (kb, im) on i-sides
    tbw: torch.Tensor
    tbe: torch.Tensor
    sbw: torch.Tensor
    sbe: torch.Tensor
    tbs: torch.Tensor
    tbn: torch.Tensor
    sbs: torch.Tensor
    sbn: torch.Tensor
    ubw: torch.Tensor
    ube: torch.Tensor
    vbw: torch.Tensor
    vbe: torch.Tensor
    vbs: torch.Tensor
    vbn: torch.Tensor
    ubs: torch.Tensor
    ubn: torch.Tensor
    # interior restoring (kb, im, jm), or (kb, 1, 1) zeros when unused
    trstr: torch.Tensor
    srstr: torch.Tensor
    taurstr: torch.Tensor
    # inertial ramp factor, a 0-d tensor
    ramp: torch.Tensor

    def replace(self, **kw) -> "Forcing":
        return dataclasses.replace(self, **kw)


FIELDS_2D = frozenset({
    "el", "elb", "et", "etb", "etf", "ua", "uab", "va", "vab",
    "utb", "vtb", "egb", "adx2d", "ady2d", "advua", "advva", "aam2d",
    "drx2d", "dry2d", "wubot", "wvbot", "vfluxb", "vfluxf",
})

_FC_J = ("elw", "ele", "uabw", "uabe", "vabw", "vabe")
_FC_I = ("els", "eln", "vabs", "vabn", "uabs", "uabn")
_FC_KJ = ("tbw", "tbe", "sbw", "sbe", "ubw", "ube", "vbw", "vbe")
_FC_KI = ("tbs", "tbn", "sbs", "sbn", "vbs", "vbn", "ubs", "ubn")
_FC_2D = ("wusurf", "wvsurf", "wtsurf", "wssurf", "swrad", "vflux",
          "e_atmos", "tsurf", "ssurf")


def zero_forcing(cfg: Config, device, dtype=None,
                 with_restore: bool = False) -> Forcing:
    dtype = cfg.torch_dtype if dtype is None else dtype
    im, jm, kb = cfg.im, cfg.jm, cfg.kb
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    fields = {}
    fields.update({f: z(im, jm) for f in _FC_2D})
    fields.update({f: z(jm) for f in _FC_J})
    fields.update({f: z(im) for f in _FC_I})
    fields.update({f: z(kb, jm) for f in _FC_KJ})
    fields.update({f: z(kb, im) for f in _FC_KI})
    r3 = (kb, im, jm) if with_restore else (kb, 1, 1)
    fields.update({f: z(*r3) for f in ("trstr", "srstr", "taurstr")})
    fields["ramp"] = torch.ones((), dtype=dtype, device=device)
    return Forcing(**fields)


def zero_state(cfg: Config, device, dtype=None, shape=None) -> State:
    """A State of zeros over ``shape`` = (im, jm) (cfg's by default: a
    block's on a mesh)."""
    dtype = cfg.torch_dtype if dtype is None else dtype
    im, jm = (cfg.im, cfg.jm) if shape is None else shape
    kb = cfg.kb
    return State(**{
        f: torch.zeros((im, jm) if f in FIELDS_2D else (kb, im, jm),
                       dtype=dtype, device=device)
        for f in State.field_names()})
