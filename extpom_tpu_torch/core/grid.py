"""Static model grid (``extpom_tpu/core/grid.py``): a dataclass of tensors
built from numpy metrics with the reference's derivations (initialize.f:
317-389, io_pnetcdf.F:2241-2256, initialize.f:524-544)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from extpom_tpu_torch.core.config import Config


@dataclasses.dataclass
class Grid:
    # vertical sigma grid (kb,)
    z: torch.Tensor
    zz: torch.Tensor
    dz: torch.Tensor
    dzz: torch.Tensor
    # horizontal metrics (im, jm)
    dx: torch.Tensor
    dy: torch.Tensor
    h: torch.Tensor
    fsm: torch.Tensor
    dum: torch.Tensor
    dvm: torch.Tensor
    cor: torch.Tensor
    art: torch.Tensor
    aru: torch.Tensor
    arv: torch.Tensor
    cbc: torch.Tensor
    hmax: torch.Tensor
    # coordinates (diagnostic only)
    east_e: torch.Tensor
    north_e: torch.Tensor
    east_c: torch.Tensor
    north_c: torch.Tensor
    east_u: torch.Tensor
    north_u: torch.Tensor
    east_v: torch.Tensor
    north_v: torch.Tensor
    rot: torch.Tensor

    @property
    def im(self) -> int:
        return self.h.shape[0]

    @property
    def jm(self) -> int:
        return self.h.shape[1]

    @property
    def kb(self) -> int:
        return self.z.shape[0]

    @property
    def device(self) -> torch.device:
        return self.h.device

    @property
    def dtype(self) -> torch.dtype:
        return self.h.dtype

    # (kb,) -> (kb, 1, 1) for 3-D expressions
    @property
    def dz3(self) -> torch.Tensor:
        return self.dz[:, None, None]

    @property
    def dzz3(self) -> torch.Tensor:
        return self.dzz[:, None, None]

    @property
    def z3(self) -> torch.Tensor:
        return self.z[:, None, None]

    @property
    def zz3(self) -> torch.Tensor:
        return self.zz[:, None, None]

    def inertial_period_days(self) -> float:
        c = float(self.cor[self.im // 2, self.jm // 2])
        if c == 0:
            raise ValueError("zero Coriolis at domain center")
        return float(2.0 * np.pi / abs(c) / 86400.0)


def masks_from_fsm(fsm: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """u/v masks from the T-cell mask (io_pnetcdf.F:2241-2256)."""
    dum = fsm.copy()
    dvm = fsm.copy()
    dum[1:, :] = fsm[1:, :] * np.where(fsm[:-1, :] == 0.0, 0.0, 1.0)
    dvm[:, 1:] = fsm[:, 1:] * np.where(fsm[:, :-1] == 0.0, 0.0, 1.0)
    return dum, dvm


def sigma_levels(kb: int, kl1: Optional[int] = None,
                 kl2: Optional[int] = None) -> tuple[np.ndarray, np.ndarray]:
    """Sigma levels z and mid-layers zz; tanh-stretched when ``kl1`` is
    given, uniform otherwise."""
    if kl1 is None:
        z = -np.linspace(0.0, 1.0, kb)
    else:
        s = np.linspace(0.0, 1.0, kb)
        c = np.tanh(2.0)
        z = -(np.tanh(2.0 * s) + s * (1.0 - c)) / (c + (1.0 - c))
        z[0], z[-1] = 0.0, -1.0
    zz = np.zeros(kb)
    zz[:-1] = 0.5 * (z[:-1] + z[1:])
    zz[-1] = 2.0 * zz[-2] - zz[-3]
    return z, zz


def make_grid(cfg: Config, z, zz, dx, dy, h, fsm,
              east_e=None, north_e=None, rot=None, dum=None, dvm=None,
              cor=None, *, device: torch.device | str,
              dtype: Optional[torch.dtype] = None) -> Grid:
    """Assemble a :class:`Grid` from numpy metrics, deriving areas, masks
    and the bottom-friction coefficient as ``read_grid`` does."""
    dtype = cfg.torch_dtype if dtype is None else dtype
    im, jm, kb = cfg.im, cfg.jm, cfg.kb
    if h.shape != (im, jm) or z.shape != (kb,):
        raise ValueError(f"grid shapes {h.shape}, {z.shape} do not match "
                         f"({im}, {jm}, {kb})")

    z = np.asarray(z, np.float64)
    zz = np.asarray(zz, np.float64)
    dz = np.zeros(kb)
    dzz = np.zeros(kb)
    dz[:-1] = z[:-1] - z[1:]
    dzz[:-1] = zz[:-1] - zz[1:]

    if east_e is None:
        xe = np.cumsum(dx, axis=0) - dx / 2.0
        ye = np.cumsum(dy, axis=1) - dy / 2.0
        east_e = xe / 111.0e3
        north_e = 45.0 + ye / 111.0e3
    if rot is None:
        rot = np.zeros((im, jm))
    if cor is None:
        cor = 2.0 * 7.29e-5 * np.sin(np.deg2rad(north_e))
    cor = np.broadcast_to(np.asarray(cor, np.float64), (im, jm))

    art = dx * dy
    aru = np.ones((im, jm))
    arv = np.ones((im, jm))
    aru[1:, 1:] = 0.25 * (dx[1:, 1:] + dx[:-1, 1:]) * (dy[1:, 1:] + dy[:-1, 1:])
    arv[1:, 1:] = 0.25 * (dx[1:, 1:] + dx[1:, :-1]) * (dy[1:, 1:] + dy[1:, :-1])
    aru[0, :] = aru[1, :]
    arv[0, :] = arv[1, :]
    aru[:, 0] = aru[:, 1]
    arv[:, 0] = arv[:, 1]

    if dum is None or dvm is None:
        dum, dvm = masks_from_fsm(np.asarray(fsm, np.float64))

    with np.errstate(divide="ignore", invalid="ignore"):
        cbc = (cfg.kappa / np.log((1.0 + zz[kb - 2]) * h / cfg.z0b)) ** 2
    cbc = np.clip(np.nan_to_num(cbc, nan=cfg.cbcmax), cfg.cbcmin, cfg.cbcmax)

    east_u = np.copy(east_e)
    east_u[1:, :] = 0.5 * (east_e[1:, :] + east_e[:-1, :])
    north_u = np.copy(north_e)
    north_u[1:, :] = 0.5 * (north_e[1:, :] + north_e[:-1, :])
    east_v = np.copy(east_e)
    east_v[:, 1:] = 0.5 * (east_e[:, 1:] + east_e[:, :-1])
    north_v = np.copy(north_e)
    north_v[:, 1:] = 0.5 * (north_e[:, 1:] + north_e[:, :-1])
    east_c = np.copy(east_u)
    east_c[:, 1:] = 0.5 * (east_u[:, 1:] + east_u[:, :-1])
    north_c = np.copy(north_v)
    north_c[1:, :] = 0.5 * (north_v[1:, :] + north_v[:-1, :])

    hmax = (np.max(np.asarray(h) * np.asarray(fsm))
            if np.any(np.asarray(fsm) > 0) else np.max(h))

    def dev(a):     # C order: a field read from a file may be transposed
        return torch.from_numpy(np.array(a, dtype=np.float64, order="C")).to(
            device=device, dtype=dtype)

    return Grid(
        z=dev(z), zz=dev(zz), dz=dev(dz), dzz=dev(dzz),
        dx=dev(dx), dy=dev(dy), h=dev(h), fsm=dev(fsm),
        dum=dev(dum), dvm=dev(dvm), cor=dev(cor),
        art=dev(art), aru=dev(aru), arv=dev(arv), cbc=dev(cbc),
        hmax=dev(hmax),
        east_e=dev(east_e), north_e=dev(north_e),
        east_c=dev(east_c), north_c=dev(north_c),
        east_u=dev(east_u), north_u=dev(north_u),
        east_v=dev(east_v), north_v=dev(north_v), rot=dev(rot),
    )
