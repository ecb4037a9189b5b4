"""Calorically-perfect thermo-chemistry of the low-Mach path.

The port of the JAX package's solvers/lomach/thermo_chem.py: the implicit
advection-diffusion temperature equation with Sutherland (or constant)
viscosity and open/closed thermodynamic pressure (reference:
src/calorically_perfect.cpp):

  rho cp (dT/dt + u . grad T) = div(kappa grad T) + dp_th/dt + sources

solved with BDF/EXT in time and matrix-free CG in space; density follows
the thermodynamic (not hydrodynamic) pressure: rho = p_th / (R T).  T, its
history, Qt and p_th are tensors updated in place (base.py).  `weight_q`
(the radius at quadrature points, [ne, nq]) weights every volume form of
an axisymmetric run.  A geometric sponge (sponge.py) scales the thermal
conductivity (reference: src/calorically_perfect.cpp:463).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...fem import h1
from .base import TemporalCoefficients, ThermoChemBase, full, shift_history


@dataclass
class TemperatureDirichlet:
    attrs: tuple
    value: float


class CaloricallyPerfectThermoChem(ThermoChemBase):
    def __init__(self, tab, flow=None, gas_constant=287.058, gamma=1.4,
                 p_thermo=101325.0, closed_system=False,
                 mu0=1.68e-5, sutherland_T0=273.0, sutherland_S0=110.4,
                 Pr=0.71, constant_mu=None, temp_bcs=(), qt_bcs=(),
                 heat_source=None, sponge=None, weight_q=None, sw_stab=False,
                 reh_factor=0.5, reh_offset=1.0, T_init=300.0, cg_tol=1e-10,
                 cg_maxiter=1000):
        self.tab = tab
        self.sponge = sponge
        self.flow = flow
        # optional quadrature-point volume weight (radius for axisymmetric
        # runs; reference loMach/axisymmetric thermo path)
        self.weight_q = weight_q
        # SUPG streamwise stabilization (reference:
        # loMach/calperfect/streamwise-stabilization, utils.cpp
        # streamwiseTensor/csupgFactor; defaults Reh_factor 0.5, offset 1)
        self.sw_stab = sw_stab
        self.reh_factor = reh_factor
        self.reh_offset = reh_offset
        self.R = gas_constant
        self.gamma = gamma
        self.cp = gamma * gas_constant / (gamma - 1.0)
        self.closed_system = closed_system
        self.mu0 = mu0
        self.sT0 = sutherland_T0
        self.sS0 = sutherland_S0
        self.Pr = Pr
        self.constant_mu = constant_mu
        self.cg_tol = cg_tol
        self.cg_maxiter = cg_maxiter
        kw = {"dtype": tab.wq.dtype, "device": tab.wq.device}
        # a heat source is evaluated once, at the dof coordinates
        self.heat_source = None if heat_source is None else \
            torch.as_tensor(heat_source(tab.xyz), **kw)
        self.info = {}

        nd = tab.ndofs
        self.p_thermo = full(tab, p_thermo)  # a device scalar
        self.Qt = full(tab, 0.0, nd)
        free = np.ones(nd)
        vals = np.zeros(nd)
        for bc in temp_bcs:
            dofs = h1.boundary_dofs(tab, bc.attrs)
            free[dofs] = 0.0
            vals[dofs] = bc.value
        self.T_mask = torch.as_tensor(free, **kw)
        self.T_bc = torch.as_tensor(vals, **kw)
        self.T = full(tab, T_init, nd)
        self.T_hist = [full(tab, 0.0, nd) for _ in range(2)]
        self.set_temperature(self.T)

        # Qt = 0 Dirichlet at isothermal walls (reference: AddQtDirichletBC,
        # src/calorically_perfect.cpp:422-424) -- kills the spurious
        # divergence spike in the wall-adjacent layer
        qt_free = np.ones(nd)
        for attrs in qt_bcs:
            qt_free[h1.boundary_dofs(tab, attrs)] = 0.0
        self.Qt_mask = torch.as_tensor(qt_free, **kw)

        # closed system: conserve initial mass (reference updateThermoP)
        if closed_system:
            self._mass0 = float(h1.integrate(tab, self.density()))

    # -- interfaces --------------------------------------------------------
    def set_temperature(self, T0):
        T0 = torch.as_tensor(T0, dtype=self.T.dtype, device=self.T.device)
        self.T.copy_(T0 * self.T_mask + self.T_bc * (1.0 - self.T_mask))
        for h in self.T_hist:
            h.copy_(self.T)

    def density(self):
        return self.p_thermo / (self.R * self.T)

    def viscosity(self, T=None):
        T = self.T if T is None else T
        if self.constant_mu is not None:
            return torch.full_like(T, float(self.constant_mu))
        return self.mu0 * (T / self.sT0) ** 1.5 * (
            (self.sT0 + self.sS0) / (T + self.sS0)
        )

    def conductivity(self):
        return self.cp / self.Pr * self.viscosity()

    def thermal_divergence(self):
        return self.Qt

    def step(self, coeff: TemporalCoefficients, dt: float, loops=None):
        vel = (self.flow.velocity() if self.flow is not None
               else torch.zeros((self.tab.ndofs, self.tab.dim),
                                dtype=self.T.dtype, device=self.T.device))
        kappa = self.conductivity()
        if self.sponge is not None:
            kappa = kappa * self.sponge.multiplier()
        T_new, Qt, self.info = self._step_impl(
            self.T, self.T_hist, vel, self.density(), kappa,
            self.p_thermo, dt, coeff.order, loops)
        shift_history(self.T_hist, self.T)
        self.T.copy_(T_new)
        self.Qt.copy_(Qt)
        if self.closed_system:
            # adjust p_thermo to conserve mass: M = int p/(R T)
            self.p_thermo.copy_(self._mass0 * self.R / h1.integrate(
                self.tab, 1.0 / self.T))

    # -- internals ---------------------------------------------------------
    def _step_impl(self, T, T_hist, vel, rho, kappa, p_thermo, dt, order,
                   loops=None):
        tab = self.tab
        coeff = TemporalCoefficients.bdf(order)
        bd = (coeff.bd0, coeff.bd1, coeff.bd2, coeff.bd3)

        rho_cp = rho * self.cp
        hist = -(bd[1] * T + bd[2] * T_hist[0] + bd[3] * T_hist[1]) / dt

        wq = self.weight_q  # None (planar) or radius at quad points (axisym)
        if wq is None:
            kq = kappa  # nodal
            kq_cp = kappa / self.cp
        else:
            kq = h1.to_quad(tab, kappa) * wq
            kq_cp = kq / self.cp

        # explicit advection at time n: nodal u.grad(T), mass-weighted by rho cp
        adv = h1.convection_apply(tab, T, vel) / tab.ml
        rhs = h1.mass_apply(tab, rho_cp * (hist - adv), coef=wq)
        if self.heat_source is not None:
            rhs = rhs + h1.mass_apply(tab, self.heat_source, coef=wq)

        mask = self.T_mask
        Tbc = self.T_bc

        if self.sw_stab:
            # SUPG: anisotropic streamwise diffusion
            # K = rho Csupg(Reh) h |u| (u u^T / |u|^2),
            # Reh = rho h |u| / mu, Csupg = f (tanh(Reh) + offset)
            uq = torch.stack(
                [h1.to_quad(tab, vel[:, d]) for d in range(vel.shape[-1])],
                dim=-1)
            umag = torch.sqrt(torch.sum(uq * uq, dim=-1))
            rho_q = h1.to_quad(tab, rho)
            mu_q = h1.to_quad(tab, self.viscosity(T))
            h_q = h1.grid_scale_q(tab, tab.order)
            Reh = rho_q * h_q * umag / torch.clamp(mu_q, min=1e-300)
            csupg = self.reh_factor * (torch.tanh(Reh) + self.reh_offset)
            # cp factor makes the streamwise addition act as a conductivity
            # in the rho*cp-scaled temperature equation
            coef = rho_q * self.cp * csupg * h_q * umag
            if wq is not None:
                coef = coef * wq
            udir = uq / torch.clamp(umag, min=1e-8)[..., None]
            K_supg = coef[..., None, None] * (
                udir[..., :, None] * udir[..., None, :])
        else:
            K_supg = None

        def helm(v):
            out = (bd[0] / dt) * h1.mass_apply(tab, rho_cp * v, coef=wq) + \
                h1.diffusion_apply(tab, v, kq)
            if K_supg is not None:
                out = out + h1.diffusion_apply_tensor(tab, v, K_supg)
            return out

        diag = (bd[0] / dt) * torch.abs(
            h1.mass_lumped_diag(tab, rho_cp if wq is None else wq)) \
            + h1.stiffness_diag(tab, kq)
        rhs = (rhs - helm(Tbc * (1.0 - mask))) * mask
        diag_c = diag * mask + (1.0 - mask)
        T_new, T_iters, T_res = h1.cg_solve(
            helm, rhs, x0=T * mask, diag=diag_c, dirichlet_mask=mask,
            tol=self.cg_tol, maxiter=self.cg_maxiter, return_info=True,
            loops=loops)
        T_new = T_new * mask + Tbc * (1.0 - mask)

        # thermal divergence in the Thomas-Olson operator form
        # Qt = (R/(p cp)) [div(kappa grad T) + q] = (1/(rho cp T)) [...]
        # evaluated from the diffusion operator, not the material
        # derivative (reference computeQtTO, src/calorically_perfect.cpp:
        # 1050-1077)
        lq = h1.diffusion_apply(tab, T_new, kq_cp)
        if K_supg is not None:
            lq = lq + h1.diffusion_apply_tensor(tab, T_new, K_supg / self.cp)
        qdiv, qt_iters, _ = h1.l2_project(tab, -lq, coef=wq,
                                          return_info=True, loops=loops)
        if self.heat_source is not None:
            qdiv = qdiv + self.heat_source / self.cp
        Qt = (self.R / p_thermo) * qdiv * self.Qt_mask
        return T_new, Qt, {"T_iters": T_iters, "T_res": T_res,
                           "Qt_iters": qt_iters}
