"""Algebraic and static RANS closures of the low-Mach path.

The port of the JAX package's solvers/lomach/rans.py.  AlgebraicRans
(reference: src/algebraic_rans.cpp:120-191):
  nu_t = min(kappa d_wall, max_mixing_length)^2 * |omega|
with |omega| the vorticity magnitude from the H1 velocity field.
StaticRans (src/static_rans.cpp): a frozen eddy-viscosity field, a
constant or one read from `loMach/static-rans/visc-file`
(interop/ext_data.py, solver.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ...fem import h1
from .base import TurbModelBase, zeros


class AlgebraicRans(TurbModelBase):
    def __init__(self, tab, flow, thermo, wall_distance, kappa=0.41,
                 max_mixing_length=1.0e30):
        self.tab = tab
        self.flow = flow
        self.thermo = thermo
        self.dist = torch.as_tensor(np.asarray(wall_distance),
                                    dtype=tab.wq.dtype, device=tab.wq.device)
        self.kappa = kappa
        self.max_len = max_mixing_length
        self._nut = zeros(tab, tab.ndofs)

    def step(self, coeff, dt, loops=None):
        self._nut.copy_(self.nut_of(self.flow.velocity()))

    def nut_of(self, u):
        """nu_t as a function of the velocity field."""
        tab = self.tab
        g = torch.stack(
            [h1.grad_at_dofs(tab, u[:, d]) for d in range(tab.dim)], dim=1
        )  # [nd, comp, dim]
        if tab.dim == 2:
            mag = torch.abs(g[:, 1, 0] - g[:, 0, 1])
        else:
            wx = g[:, 2, 1] - g[:, 1, 2]
            wy = g[:, 0, 2] - g[:, 2, 0]
            wz = g[:, 1, 0] - g[:, 0, 1]
            mag = torch.sqrt(wx * wx + wy * wy + wz * wz)
        ell = torch.clamp(self.kappa * self.dist, max=self.max_len)
        # nu_t (kinematic); the flow adds rho * nu_t to mu
        return ell * ell * mag

    def eddy_viscosity(self):
        return self._nut


class StaticRans(TurbModelBase):
    """Frozen eddy-viscosity field (reference: src/static_rans.cpp)."""

    def __init__(self, tab, nut_field):
        self._nut = torch.as_tensor(
            np.broadcast_to(np.asarray(nut_field, np.float64),
                            (tab.ndofs,)).copy(),
            dtype=tab.wq.dtype, device=tab.wq.device)

    def eddy_viscosity(self):
        return self._nut
