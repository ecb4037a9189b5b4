"""LTE table-based low-Mach thermo-chemistry.

The port of the JAX package's solvers/lomach/lte_thermo.py (the role of
the reference LteThermoChem, src/lte_thermo_chem.cpp): an implicit energy
equation with all properties from equilibrium tables rho(T), cp(T),
mu(T), kappa(T), sigma(T) (1-D in T at the operating pressure, or 2-D in
(T, rho)), plus the Joule-heating source and the optional net-emission
radiation sink of the coupled plasma-torch cases.

State (T, its history, Qt, the Joule heating) lives in tensors updated in
place (base.py): the coupling hands each EM solve's heating over with
`set_joule_heating`, a `copy_` into the tensor a captured step reads.
The lagged dense factors (the T Helmholtz and the consistent mass of the
Qt projection) are refreshed every 16 steps outside the step, into the
same tensors.  `weight_q` (the radius at quadrature points) weights every
volume form of an axisymmetric run.
"""

from __future__ import annotations

import numpy as np
import torch

from ...fem import h1
from ...physics.tables import _eval2
from .base import (TemporalCoefficients, ThermoChemBase, full, shift_history,
                   zeros)


class LteThermoChem(ThermoChemBase):
    _PRECOND_REFRESH = 16

    def __init__(self, tab, flow=None, rho_table=None, cp_table=None,
                 mu_table=None, kappa_table=None, sigma_table=None,
                 radiation=None, temp_bcs=(), qt_bcs=(), weight_q=None,
                 T_init=300.0, cg_tol=1e-10, cg_maxiter=500):
        self.tab = tab
        self.flow = flow
        self.weight_q = weight_q
        self.rho_table = rho_table
        self.cp_table = cp_table
        self.mu_table = mu_table
        self.kappa_table = kappa_table
        self.sigma_table = sigma_table
        self.radiation = radiation
        self.cg_tol = cg_tol
        self.cg_maxiter = cg_maxiter
        self.info = {}

        kw = {"dtype": tab.wq.dtype, "device": tab.wq.device}
        nd = tab.ndofs
        self.T = full(tab, T_init, nd)
        self.T_hist = [full(tab, 0.0, nd) for _ in range(2)]
        self.Qt = zeros(tab, nd)
        self.joule_heating = zeros(tab, nd)
        free = np.ones(nd)
        vals = np.zeros(nd)
        for bc in temp_bcs:
            dofs = h1.boundary_dofs(tab, bc.attrs)
            free[dofs] = 0.0
            vals[dofs] = bc.value
        self.T_mask = torch.as_tensor(free, **kw)
        self.T_bc = torch.as_tensor(vals, **kw)
        self.set_temperature(self.T)

        # Qt = 0 Dirichlet at isothermal walls (reference:
        # AddQtDirichletBC, src/lte_thermo_chem.cpp:546)
        qt_free = np.ones(nd)
        for attrs in qt_bcs:
            qt_free[h1.boundary_dofs(tab, attrs)] = 0.0
        self.Qt_mask = torch.as_tensor(qt_free, **kw)

        # lagged dense-direct factors (T Helmholtz, consistent mass)
        self._direct = None
        self._direct_age = None
        self.refreshes = 0

    # -- lagged dense factors ----------------------------------------------
    def _precond_build(self, T, dt, bd0):
        tab = self.tab
        rho_cp = _eval2(self.rho_table, T, T) * _eval2(self.cp_table, T, T)
        kappa = _eval2(self.kappa_table, T, T)
        wq = self.weight_q
        if wq is None:
            m_coef, k_coef = rho_cp, kappa
        else:
            m_coef = h1.to_quad(tab, rho_cp) * wq
            k_coef = h1.to_quad(tab, kappa) * wq
        He_e = (bd0 / dt) * h1.element_mass(tab, m_coef) \
            + h1.element_stiffness(tab, k_coef)
        # the (weighted) consistent mass of the Qt projection: time-
        # constant, refactored with the batch to keep one path
        Mw_e = h1.element_mass(tab, wq)
        He, Mw = h1.assemble_dense(tab, torch.stack([He_e, Mw_e]))
        He = h1.dense_constrain(He, mask=self.T_mask)
        L = h1.dense_cholesky(torch.stack([He, Mw]))
        return L[0], L[1]

    def precond_refresh(self, dt, order, force=False):
        """Refresh the lagged dense factors when due (eager, outside any
        captured step), into the same tensors."""
        if not h1.dense_capable(self.tab):
            return
        age = self._direct_age
        if not force and age is not None and age < self._PRECOND_REFRESH:
            return
        bd0 = TemporalCoefficients.bdf(order).bd0
        L = self._precond_build(self.T, dt, bd0)
        if self._direct is None:
            self._direct = L
        else:
            for dst, src in zip(self._direct, L):
                dst.copy_(src)
        self._direct_age = 0
        self.refreshes += 1

    def set_temperature(self, T0):
        T0 = torch.as_tensor(T0, dtype=self.T.dtype, device=self.T.device)
        self.T.copy_(T0 * self.T_mask + self.T_bc * (1.0 - self.T_mask))
        for h in self.T_hist:
            h.copy_(self.T)

    # -- property fields ---------------------------------------------------
    def density(self):
        return _eval2(self.rho_table, self.T, self.T)

    def viscosity(self):
        return _eval2(self.mu_table, self.T, self.T)

    def conductivity(self):
        return _eval2(self.kappa_table, self.T, self.T)

    def plasma_conductivity(self):
        """sigma(T) for the EM coupling (reference lte_thermo_chem Joule
        path)."""
        if self.sigma_table is None:
            return torch.zeros_like(self.T)
        return _eval2(self.sigma_table, self.T, self.T)

    def set_joule_heating(self, qj):
        """The coupling's Joule heating, copied into the tensor the step
        reads (a rebound tensor would leave a captured step heating with
        the old field)."""
        self.joule_heating.copy_(torch.as_tensor(
            qj, dtype=self.T.dtype, device=self.T.device))

    def thermal_divergence(self):
        return self.Qt

    def step(self, coeff: TemporalCoefficients, dt: float, loops=None):
        vel = (self.flow.velocity() if self.flow is not None
               else torch.zeros((self.tab.ndofs, self.tab.dim),
                                dtype=self.T.dtype, device=self.T.device))
        T_new, Qt, self.info = self._step_impl(
            self.T, self.T_hist, vel, self.joule_heating, dt, coeff.order,
            self._direct, loops)
        shift_history(self.T_hist, self.T)
        self.T.copy_(T_new)
        self.Qt.copy_(Qt)

    def _step_impl(self, T, T_hist, vel, qj, dt, order, precond=None,
                   loops=None):
        tab = self.tab
        coeff = TemporalCoefficients.bdf(order)
        bd = (coeff.bd0, coeff.bd1, coeff.bd2, coeff.bd3)

        rho = _eval2(self.rho_table, T, T)
        cp = _eval2(self.cp_table, T, T)
        kappa = _eval2(self.kappa_table, T, T)
        rho_cp = rho * cp

        hist = -(bd[1] * T + bd[2] * T_hist[0] + bd[3] * T_hist[1]) / dt
        adv = h1.convection_apply(tab, T, vel) / tab.ml
        src = qj
        if self.radiation is not None:
            src = src + self.radiation.energy_sink(T)
        wq = self.weight_q
        kq = kappa if wq is None else h1.to_quad(tab, kappa) * wq
        rhs = h1.mass_apply(tab, rho_cp * (hist - adv) + src, coef=wq)

        mask = self.T_mask
        Tbc = self.T_bc

        def helm(v):
            return (bd[0] / dt) * h1.mass_apply(tab, rho_cp * v, coef=wq) \
                + h1.diffusion_apply(tab, v, kq)

        diag = (bd[0] / dt) * torch.abs(
            h1.mass_lumped_diag(tab, rho_cp if wq is None else wq)
        ) + h1.stiffness_diag(tab, kq)
        rhs = (rhs - helm(Tbc * (1.0 - mask))) * mask
        diag = diag * mask + (1.0 - mask)
        M_T = h1.direct_precond(precond[0]) if precond is not None else None
        T_new, T_iters, T_res = h1.cg_solve(
            helm, rhs, x0=T * mask, diag=diag, dirichlet_mask=mask, M=M_T,
            tol=self.cg_tol, maxiter=self.cg_maxiter, return_info=True,
            loops=loops)
        T_new = T_new * mask + Tbc * (1.0 - mask)

        # thermal divergence in the operator form (reference computeQt,
        # src/lte_thermo_chem.cpp:1430-1466): Qt = -(drho/dT / rho) DT/Dt
        # with DT/Dt = [div(kappa grad T) + q_J - q_rad] / (rho cp) from the
        # diffusion and source operators, never the material derivative
        # (the D/Dt form feeds the constraint velocity back into Qt); the
        # table's drho/dT keeps LTE generality
        dT = 1e-3 * torch.clamp(T_new, min=1.0)
        drho_dT = (_eval2(self.rho_table, T_new + dT, T_new)
                   - _eval2(self.rho_table, T_new - dT, T_new)) / (2 * dT)
        rho_new = _eval2(self.rho_table, T_new, T_new)
        cp_new = _eval2(self.cp_table, T_new, T_new)
        kq_new = _eval2(self.kappa_table, T_new, T_new)
        if wq is not None:
            kq_new = h1.to_quad(tab, kq_new) * wq
        lap, qt_iters, _ = h1.l2_project(
            tab, -h1.diffusion_apply(tab, T_new, kq_new), coef=wq,
            M=(h1.direct_precond(precond[1]) if precond is not None
               else None), return_info=True, loops=loops)
        src_new = qj
        if self.radiation is not None:
            src_new = src_new + self.radiation.energy_sink(T_new)
        DTDt = (lap + src_new) / (rho_new * cp_new)
        Qt = -(drho_dT / rho_new) * DTDt * self.Qt_mask
        return T_new, Qt, {"T_iters": T_iters, "T_res": T_res,
                           "Qt_iters": qt_iters}
