"""The system under test: the port's ``Model`` built from the benchmark's
inputs.  This is the one module of the benchmark that imports the port
(``extpom_tpu_torch``); everything the benchmark takes from it passes
through here."""

from __future__ import annotations

from pombench.inputs import Inputs


def load() -> None:
    """Import the modules of the port that a run drives."""
    import extpom_tpu_torch.core.model  # noqa: F401


def build(inp: Inputs, device):
    """The port's Model of ``inp`` on ``device``: its grid from the
    metrics and its cold start from the initial fields, with the case's
    climatology (the initial fields where it gives none, as POM's cases
    have it).  A case's forcing series reach the port as a run's files do
    (``run.py:execute``): through a ``ForcingProvider`` that
    ``Model.run_segment`` stages on the device and interpolates at every
    step."""
    from extpom_tpu_torch.core.config import Config
    from extpom_tpu_torch.core.grid import make_grid
    from extpom_tpu_torch.core.model import Model
    cfg = Config(**inp.namelist)
    grid = make_grid(cfg, inp.z, inp.zz, inp.dx, inp.dy, inp.h, inp.fsm,
                     cor=inp.cor, device=device)
    tclim = inp.tb.clone() if inp.tclim is None else inp.tclim
    sclim = inp.sb.clone() if inp.sclim is None else inp.sclim
    m = Model(grid, cfg, tb=inp.tb, sb=inp.sb, tclim=tclim, sclim=sclim,
              elb=inp.elb, uab=inp.uab, vab=inp.vab)
    if inp.series:
        from extpom_tpu_torch.forcing.provider import (ArraySource,
                                                       ForcingProvider)
        m.forcing_fn = ForcingProvider(grid, cfg, m.base_forcing,
                                       ArraySource(dict(inp.series)))
    return m


def state_fields(m) -> dict:
    """Field name -> tensor of the model's current State."""
    st = m.state
    return {f: getattr(st, f) for f in st.field_names()}


def to_host(fields: dict) -> dict:
    """A host copy of each field."""
    return {k: v.to("cpu", copy=True) for k, v in fields.items()}
