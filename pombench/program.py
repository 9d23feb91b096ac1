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
    metrics and its cold start from the initial fields (climatology = the
    initial fields, as POM's cases have it)."""
    from extpom_tpu_torch.core.config import Config
    from extpom_tpu_torch.core.grid import make_grid
    from extpom_tpu_torch.core.model import Model
    cfg = Config(**inp.namelist)
    grid = make_grid(cfg, inp.z, inp.zz, inp.dx, inp.dy, inp.h, inp.fsm,
                     cor=inp.cor, device=device)
    return Model(grid, cfg, tb=inp.tb, sb=inp.sb, tclim=inp.tb.clone(),
                 sclim=inp.sb.clone(), elb=inp.elb, uab=inp.uab, vab=inp.vab)


def state_fields(m) -> dict:
    """Field name -> tensor of the model's current State."""
    st = m.state
    return {f: getattr(st, f) for f in st.field_names()}


def to_host(fields: dict) -> dict:
    """A host copy of each field."""
    return {k: v.to("cpu", copy=True) for k, v in fields.items()}
