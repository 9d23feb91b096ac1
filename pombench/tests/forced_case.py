"""A small seeded forced case for the harness's tests: POM's seamount
(``pombench/cases/seamount.py``) with land in it, a climatology of its own
and every forcing series a case may give (``pombench.inputs.SERIES``), at
bounds_forcing.f's record periods, under the ``file`` edges and the
interior restoring.  ``make(conf, seed, device, dtype)`` is a case's
``make``; :data:`CONF` is its configuration at 33x33x11 in float64.

The seed draws the phases of the series' smooth waves and how far each
turns from one record to the next; sizes, amplitudes and the land do not
hang on it, so every seed does the same work.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pombench.cases import seamount
from pombench.inputs import pattern, perturbed

CONF = {
    "case": "seamount",
    "case_args": {"im": 33, "jm": 33, "kb": 11, "depth": 4500.0,
                  "dx0": 4000.0, "delh": 0.9, "ra": 25000.0, "lat": 45.0,
                  "vel": 0.2, "tbias": 10.0, "sbias": 20.0,
                  "stretched": True},
    "config": {"mode": 3, "bc_scheme": "file", "do_restore": True,
               "nadv": 1, "npg": 1, "nbct": 2, "dte": 6.0, "isplit": 30,
               "days": 1.0, "prtd1": 6 * 180.0 / 86400.0, "lramp": True,
               "forcing_hbm_mb": 16384, "dtype": "float64"},
    "assumed": {
        "perturbation": {"t_amp": 0.2, "s_amp": 0.05,
                         "modes": [[1, 0], [0, 1], [1, 1], [2, 1], [1, 2],
                                   [3, 2]]},
        "forcing": {
            # records of each dataset: enough for some 250 steps of 180 s
            "nrec": {"lbry": 32, "sfrc": 8, "clim": 2},
            "taurstr": True,
            # land: a 2x2 island and two coast cells on the east edge
            "island": [0.25, 0.25], "coast": 0.5,
        },
    },
}


def _edge_wave(r, n: int, nrec: int, zz=None) -> np.ndarray:
    """(nrec, n), or (nrec, kb, n) weighted (1 + zz) toward the bottom: a
    wave along an edge of ``n`` cells at a drawn phase, turned by a drawn
    step each record, in [-1, 1]."""
    s = np.arange(n) / n
    ph, step = r.uniform(0.0, 2.0 * math.pi), r.uniform(0.2, 0.6)
    w = np.cos(2.0 * math.pi * s[None] + ph
               + step * np.arange(nrec)[:, None])
    return w if zz is None else w[:, None, :] * (1.0 + zz)[None, :, None]


def _plane_waves(r, im, jm, nrec, device) -> list:
    """``nrec`` smooth (im, jm) fields in [-1, 1], float64 on ``device``:
    two plane waves at drawn phases, turned by a drawn step each record."""
    ph, step = r.uniform(0.0, 2.0 * math.pi, 2), r.uniform(0.2, 0.6)
    return [pattern(im, jm, [[1, 0], [1, 1]], ph + step * n, device)
            for n in range(nrec)]


def make(conf: dict, seed: int, device, dtype):
    inp = seamount.make(conf, seed, device, dtype)
    f = conf["assumed"]["forcing"]
    nrec = f["nrec"]
    im, jm, kb = inp.im, inp.jm, inp.kb
    r = np.random.default_rng((seed % 2 ** 64, 22))
    zz = np.asarray(inp.zz)

    i0, j0 = int(f["island"][0] * im), int(f["island"][1] * jm)
    inp.fsm[i0:i0 + 2, j0:j0 + 2] = 0.0
    jc = int(f["coast"] * jm)
    inp.fsm[-1, jc:jc + 2] = 0.0

    tb64, sb64 = inp.tb.double(), inp.sb.double()
    pt, ps = (_plane_waves(r, im, jm, 1, device)[0] for _ in range(2))
    inp.tclim = perturbed(tb64, zz, 0.1, pt, dtype)
    inp.sclim = perturbed(sb64, zz, 0.02, ps, dtype)

    host = lambda x: x.cpu().numpy()
    vel = float(conf["case_args"]["vel"])
    s = {}
    n = nrec["lbry"]
    for side in "wesn":
        ln = jm if side in "we" else im
        edge = {"w": (slice(None), 0, slice(None)),
                "e": (slice(None), -1, slice(None)),
                "s": (slice(None), slice(None), 0),
                "n": (slice(None), slice(None), -1)}[side]
        normal = side in "we"
        s[f"el{side}"] = 0.05 * _edge_wave(r, ln, n)
        s[f"tb{side}"] = host(tb64[edge])[None] \
            + 0.2 * _edge_wave(r, ln, n, zz)
        s[f"sb{side}"] = host(sb64[edge])[None] \
            + 0.05 * _edge_wave(r, ln, n, zz)
        s[f"ub{side}"] = (vel if normal else 0.0) \
            + (0.05 if normal else 0.02) * _edge_wave(r, ln, n, zz)
        s[f"vb{side}"] = (0.02 if normal else 0.05) \
            * _edge_wave(r, ln, n, zz)
    n = nrec["sfrc"]
    for name, (base, amp) in {
            "wusurf": (-1e-4, 5e-5), "wvsurf": (0.0, 5e-5),
            "wtsurf": (0.0, 2e-5), "swrad": (-5e-5, 1.5e-5),
            "tsurf": (tb64[0], 0.5), "ssurf": (sb64[0], 0.1)}.items():
        s[name] = np.stack([host(base + amp * w) for w in
                            _plane_waves(r, im, jm, n, device)])
    n = nrec["clim"]
    w3 = torch.as_tensor(1.0 + zz, device=device)[:, None, None]
    clim = {"trstr": (tb64, 0.3), "srstr": (sb64, 0.05)}
    if f["taurstr"]:
        clim["taurstr"] = (torch.full_like(tb64, 1.0 / 30.0), 0.5 / 30.0)
    for name, (base, amp) in clim.items():
        s[name] = np.stack([host(base + amp * w3 * w[None]) for w in
                            _plane_waves(r, im, jm, n, device)])
    inp.series = s
    return inp

