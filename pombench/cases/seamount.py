"""POM's seamount: a stratified f-plane basin with a Gaussian seamount, a
uniform zonal inflow and open edges (``case_args``: im, jm, kb, depth, dx0,
delh, ra, lat, vel, tbias, sbias, stretched; ``assumed.perturbation``: the
seed's smooth perturbation of T and S)."""

from __future__ import annotations

import math

import numpy as np
import torch

from pombench.inputs import (Inputs, namelist, pattern, perturbed, rng,
                             sigma_levels)


def _edges_like_interior(h: np.ndarray) -> np.ndarray:
    h[0, :] = h[1, :]
    h[-1, :] = h[-2, :]
    h[:, 0] = h[:, 1]
    h[:, -1] = h[:, -2]
    return h


def make(conf: dict, seed: int, device, dtype) -> Inputs:
    a, pert = conf["case_args"], conf["assumed"]["perturbation"]
    im, jm, kb = a["im"], a["jm"], a["kb"]
    dx0, depth = a["dx0"], a["depth"]
    z, zz = sigma_levels(kb, a["stretched"])
    dx = np.full((im, jm), dx0)
    x = (np.arange(im) - (im - 1) / 2.0)[:, None] * dx0
    y = (np.arange(jm) - (jm - 1) / 2.0)[None, :] * dx0
    h = _edges_like_interior(
        depth * (1.0 - a["delh"] * np.exp(-(x ** 2 + y ** 2) / a["ra"] ** 2)))
    cor = np.full((im, jm), 2.0 * 7.29e-5 * np.sin(np.deg2rad(a["lat"])))
    r = rng(seed)
    modes = pert["modes"]
    pt = pattern(im, jm, modes, r.uniform(0, 2 * math.pi, len(modes)), device)
    ps = pattern(im, jm, modes, r.uniform(0, 2 * math.pi, len(modes)), device)
    ht = torch.as_tensor(h, device=device)
    zzt = torch.as_tensor(zz, device=device)[:, None, None]
    tbase = 5.0 + 15.0 * torch.exp(zzt * ht[None] / 1000.0) - a["tbias"]
    tb = perturbed(tbase, zz, pert["t_amp"], pt, dtype)
    del tbase
    sb = perturbed(torch.full((kb, 1, 1), 35.0 - a["sbias"],
                              dtype=torch.float64, device=device),
                   zz, pert["s_amp"], ps, dtype)
    z2 = torch.zeros((im, jm), dtype=dtype, device=device)
    return Inputs(im, jm, kb, namelist(conf), z, zz, dx, dx.copy(), h,
                  np.ones((im, jm)), cor, tb, sb, z2,
                  torch.full((im, jm), a["vel"], dtype=dtype, device=device),
                  z2.clone())
