"""The f32-against-f64 tolerance ladder (``tests/test_tolerance.py``,
VALIDATION.md §2): the same run in float64 and float32 on one device,
each prognostic field's drift as the max-norm of its difference over its
float64 scale, and the conservation scalars' relative drift, held to the
JAX package's bounds (a copy: the port imports nothing of it).

:func:`run` makes and steps a case's model, :func:`drift` measures two
runs against each other and :func:`over` names the bounds they exceed.
"""

from __future__ import annotations

from typing import Dict

from extpom_tpu_torch.diag import stats

FIELDS = ("el", "ua", "va", "u", "v", "t", "s", "q2")
SCALARS = ("vtot", "eaver", "taver", "saver", "ekin")

# (case arguments, internal steps) of each case: the seamount's BASELINE
# config-2 core, 3 hours at dti 180 s; the tidal channel with its boundary
# elevation series (config 3)
CASES = {"seamount": (dict(im=33, jm=33, kb=11), 60),
         "channel": (dict(im=32, jm=24, kb=7), 40)}

# tests/test_tolerance.py:48-51 and its scalar bounds: about 5-10x the
# drift measured on the CPU; v and q2 are weak signals on these cases, so
# their relative drift runs largest
BOUNDS = {
    "seamount": {"el": 1e-4, "ua": 1e-4, "va": 6e-4, "u": 1e-2, "v": 1e-1,
                 "t": 2e-4, "s": 5e-5, "q2": 5e-3, "vtot": 1e-6,
                 "saver": 1e-6, "taver": 1e-6, "eaver": 3e-3},
    "channel": {"el": 1e-4, "ua": 1e-4, "va": 2e-4, "u": 6e-4, "v": 2e-3,
                "t": 5e-5, "s": 5e-5, "q2": 5e-4, "vtot": 1e-6,
                "saver": 1e-5},
}


def run(case: str, dtype: str, device):
    """The case's model in ``dtype`` on ``device``, stepped its steps in
    one segment."""
    from extpom_tpu_torch.cases.channel import channel_model
    from extpom_tpu_torch.cases.seamount import seamount_model
    make = seamount_model if case == "seamount" else channel_model
    kw, steps = CASES[case]
    m = make(device=device, dtype=dtype, **kw)
    m.run_segment(steps)
    return m


def _stats(m) -> Dict[str, float]:
    return {k: float(v) for k, v in
            stats.domain_stats(m.grid, m.cfg, m.state).items()}


def drift(m64, m32) -> Dict[str, float]:
    """Each field's max |f32 - f64| over the f64 field's max |.|, and each
    scalar's |f32 - f64| over |f64| (both floored at 1e-12)."""
    out = {}
    for name in FIELDS:
        a = getattr(m64.state, name).double()
        b = getattr(m32.state, name).double().to(a.device)
        scale = max(float(a.abs().max()), 1e-12)
        out[name] = float((a - b).abs().max()) / scale
    s64, s32 = _stats(m64), _stats(m32)
    for k in SCALARS:
        out[k] = abs(s64[k] - s32[k]) / max(abs(s64[k]), 1e-12)
    return out


def over(case: str, d: Dict[str, float]) -> Dict[str, tuple]:
    """The quantities of ``d`` at or above the case's bound: (drift,
    bound) by name."""
    return {k: (d[k], b) for k, b in BOUNDS[case].items() if not d[k] < b}
