"""Finite-rate reacting low-Mach thermo-chemistry (the ReactingFlow model).

The port of the JAX package's solvers/lomach/reacting_flow.py (the role of
the reference ReactingFlow, src/reactingFlow.cpp): operator-split
temperature and species transport with chemistry substeps inside each flow
step.  Two tiers:

* the full plasma tier: a PerfectMixture with a molecular transport model
  (the objects the compressible plasma path uses, from [plasma_models],
  [species] and [reactions]): per-species rho D from the transport's flux
  properties, kappa + kappa_e, the transport's electric conductivity for
  the EM coupling, Joule heating and net emission in the T equation, and
  the mixture's heats of formation;
* the simple tier: constant Prandtl/Schmidt closures over explicit
  species arrays (no transport model).

Per flow step dt (reference: step(), src/reactingFlow.cpp:1997-2120):

  PART I   implicit BDF advection-diffusion solves for each active species
           mass fraction and for T; the ambipolar electron from
           quasi-neutrality and the background as the remainder
           (`_close_species`); cross-diffusion, Joule heating and
           radiation in the T equation.
  PART II  `n_substeps` chemistry substeps from (T_n, Y_n), each adding
           1/n of the transport increment plus dt/n of the reaction
           source.

Then the thermal divergence Qt in the operator form, and, in a closed
system, the thermodynamic pressure that keeps the initial mass.

The state (T, Y, their histories, Qt, the Joule heating, p_thermo and the
clock `t` the ramp-chem blend reads) lives in tensors updated in place:
a captured step (step_graph.py) reads and writes those addresses, and a
closed system's p_thermo comes from h1.integrate with no host read.  The
species, T and Qt solves run their CG blocks through the caller's
`loops`.  The lagged dense factors of the T and species Helmholtz
operators are refreshed every 16 steps outside the step, into the same
tensors (`precond_refresh`, before the step as the JAX package's
`ReactingFlow.step` does).  No radius weight: the JAX package's reacting
thermo uses planar forms on an axisymmetric mesh too.
"""

from __future__ import annotations

import numpy as np
import torch

from ...constants import UNIVERSAL_GAS_CONSTANT as _R
from ...fem import h1
from ...physics.perfect_mixture import PerfectMixture
from .base import (TemporalCoefficients, ThermoChemBase, full, shift_history,
                   zeros)

# the simple tier's closures (the JAX package's defaults): a power-law
# viscosity, constant Prandtl and Schmidt numbers
_MU0_SIMPLE = 1.68e-5
_PR = 0.71
_SC = 0.71


class SpeciesSet:
    """The species facts a Chemistry needs from its mixture, for the simple
    tier (no PerfectMixture): molar masses, the electron's index."""

    _arr = PerfectMixture._arr  # constant tensors, made once

    def __init__(self, mw, i_electron):
        self.mw = tuple(mw)
        self.num_species = len(self.mw)
        self.i_electron = i_electron


class ReactingFlow(ThermoChemBase):
    _PRECOND_REFRESH = 16

    def __init__(self, tab, flow=None, species_names=(), mw=(),
                 molar_cv_over_R=(), formation_energy=(), chemistry=None,
                 p_thermo=101325.0, closed_system=False,
                 n_substeps=4, temp_bcs=(), qt_bcs=(),
                 spec_bcs=(), T_init=300.0, Y_init=None, cg_tol=1e-10,
                 cg_maxiter=500, mixture=None, transport=None,
                 radiation=None, operator_split=True,
                 const_plasma_conductivity=0.0, chemistry_base=None,
                 ramp_start=-1.0, ramp_time=-1.0):
        self.tab = tab
        self.flow = flow
        self.mixture = mixture
        self.transport = transport
        self.radiation = radiation
        self.operator_split = operator_split
        self.const_plasma_conductivity = const_plasma_conductivity
        self.species_names = list(species_names)
        if mixture is not None:
            self.mw = np.asarray(mixture.mw, dtype=np.float64)
            molar_cv = np.asarray(mixture.molar_cv_over_R) * _R
            self.hf = np.asarray(mixture.formation_energy, dtype=np.float64)
            self.n_active = mixture.num_active_species
            self.i_electron = mixture.i_electron
            self.ambipolar = bool(mixture.ambipolar)
        else:
            self.mw = np.asarray(mw, dtype=np.float64)
            molar_cv = np.asarray(molar_cv_over_R) * _R
            self.hf = np.asarray(formation_energy, dtype=np.float64)
            self.n_active = len(self.mw) - 1  # all but the background
            self.i_electron = -1
            self.ambipolar = False
        self.nsp = len(self.mw)
        self.molar_cp = molar_cv + _R
        self.chemistry = chemistry
        # ramp-chem (reference: src/reactingFlow.cpp:652-682, 2697-2710):
        # inside (ramp_start, ramp_start + ramp_time) the reaction source
        # blends linearly from chemistry_base to the active chemistry
        self.chemistry_base = chemistry_base
        self.ramp_start = float(ramp_start)
        self.ramp_time = float(ramp_time)
        self.closed_system = closed_system
        self.n_substeps = n_substeps
        self.cg_tol = cg_tol
        self.cg_maxiter = cg_maxiter
        self.info = {}

        kw = {"dtype": tab.wq.dtype, "device": tab.wq.device}
        nd = tab.ndofs
        # constants of the step, made once (a captured step copies nothing
        # from the host)
        self._inv_mw = torch.as_tensor(1.0 / self.mw, **kw)
        self._mw = torch.as_tensor(self.mw, **kw)
        self._cp_s = torch.as_tensor(self.molar_cp / self.mw, **kw)
        self._hf_mass = torch.as_tensor(self.hf / self.mw, **kw)  # J/kg
        if self.ambipolar and self.i_electron >= 0:
            z = np.asarray(mixture.charges)[: self.n_active]
            self._e_fac = torch.as_tensor(z / self.mw[: self.n_active], **kw)

        self.p_thermo = full(tab, p_thermo)  # a device scalar
        self.t = zeros(tab)  # the ramp-chem clock, on the device
        self.T = full(tab, T_init, nd)
        if Y_init is None:
            Y0 = np.zeros((nd, self.nsp))
            Y0[:, -1] = 1.0  # background species
        else:
            Y0 = np.broadcast_to(np.asarray(Y_init, np.float64),
                                 (nd, self.nsp)).copy()
        self.Y = torch.as_tensor(Y0, **kw)
        self.T_hist = [self.T.clone(), self.T.clone()]
        self.Y_hist = [self.Y.clone(), self.Y.clone()]
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

        # Qt = 0 Dirichlet at isothermal walls (reference:
        # AddQtDirichletBC, src/reactingFlow.cpp:1391)
        qt_free = np.ones(nd)
        for attrs in qt_bcs:
            qt_free[h1.boundary_dofs(tab, attrs)] = 0.0
        self.Qt_mask = torch.as_tensor(qt_free, **kw)

        # species Dirichlet BCs (reference: AddSpecDirichletBC,
        # src/reactingFlow.cpp:1279,1317,1393): (attrs, Y values [nsp], or
        # None for a pure background); the last entry wins at shared dofs
        spec_free = np.ones(nd)
        ybc = np.zeros((nd, self.nsp))
        ybc[:, -1] = 1.0
        for attrs, v in spec_bcs:
            dofs = h1.boundary_dofs(tab, attrs)
            spec_free[dofs] = 0.0
            if v is None:
                v = np.zeros(self.nsp)
                v[-1] = 1.0
            else:
                v = np.clip(np.asarray(v, dtype=np.float64), 0.0, None)
                v = v / max(v.sum(), 1e-300)
            ybc[dofs] = v
        self.Y_mask = torch.as_tensor(spec_free, **kw)
        self.Y_bc = torch.as_tensor(ybc, **kw)
        if spec_bcs:
            # the BC composition imprinted on the IC at constrained dofs
            Ym = self.Y_mask[:, None]
            self.Y.copy_(self.Y * Ym + self.Y_bc * (1.0 - Ym))
            for h in self.Y_hist:
                h.copy_(self.Y)

        if closed_system:
            # the mass at the uniform initial state (a later IC does not
            # change it, as in the JAX package)
            self._mass0 = float(h1.integrate(tab, self.density()))

        # lagged dense factors of the T and species Helmholtz operators
        self._direct = None
        self._direct_age = None
        self.refreshes = 0

    @property
    def _n_solved(self):
        return self.n_active if self.mixture is not None else self.nsp - 1

    @property
    def _reacting(self):
        return self.chemistry is not None and self.chemistry.num_reactions > 0

    # -- lagged dense factors ----------------------------------------------
    def _precond_build(self, T, Y, p, dt, bd0):
        tab = self.tab
        rho = p * self._mixture_mw(Y) / (_R * T)
        cp = self._cp_mass(Y)
        diff, _mu, kappa = self._transport_props(T, Y, p)
        ops = [(bd0 / dt) * h1.element_mass(tab, rho * cp)
               + h1.element_stiffness(tab, kappa)]
        for s in range(self._n_solved):
            ops.append((bd0 / dt) * h1.element_mass(tab, rho)
                       + h1.element_stiffness(tab, diff[:, s]))
        K = h1.assemble_dense(tab, torch.stack(ops))
        masks = torch.stack([self.T_mask] + [self.Y_mask] * self._n_solved)
        L = h1.dense_cholesky(h1.dense_constrain(K, mask=masks))
        return L[0], L[1:]

    def precond_refresh(self, dt, order, force=False):
        """Refresh the lagged dense factors when due (eager, outside any
        captured step), into the same tensors."""
        if not h1.dense_capable(self.tab):
            return
        age = self._direct_age
        if not force and age is not None and age < self._PRECOND_REFRESH:
            return
        bd0 = TemporalCoefficients.bdf(order).bd0
        L = self._precond_build(self.T, self.Y, self.p_thermo, dt, bd0)
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

    def set_mass_fractions(self, Y0):
        """Y and its history (a species initialisation)."""
        self.Y.copy_(torch.as_tensor(Y0, dtype=self.Y.dtype,
                                     device=self.Y.device))
        for h in self.Y_hist:
            h.copy_(self.Y)

    # -- mixture properties on nodes ---------------------------------------
    def _mixture_mw(self, Y):
        """Mean molar mass W = 1 / sum(Y_s / W_s)."""
        return 1.0 / (torch.clamp(Y, min=0.0) @ self._inv_mw)

    def _cp_mass(self, Y):
        """Mixture specific heat [J/kg/K]."""
        return torch.clamp(Y, min=0.0) @ self._cp_s

    def density(self):
        return self.p_thermo * self._mixture_mw(self.Y) / (_R * self.T)

    def _conserved_state(self, T, Y, p):
        """Per-node conserved and primitive states in the mixture's layout
        (reference: evaluatePlasmaConductivityGF builds this state,
        src/reactingFlow.cpp:3192-3227); the fluid at rest."""
        mix = self.mixture
        rho = p * self._mixture_mw(Y) / (_R * T)
        na = self.n_active
        n_active = rho[:, None] * torch.clamp(Y[:, :na], min=0.0) \
            / self._mw[:na]
        parts = [rho[:, None], T.new_zeros((T.shape[0], mix.nvel)),
                 T[:, None], n_active]
        if mix.two_temperature:
            parts.append(T[:, None])  # single-T low Mach: Te = Th
        Up = torch.cat(parts, dim=-1)
        return mix.conservatives(Up), Up

    def _transport_props(self, T, Y, p):
        """Per-species rho D [nd, nsp], viscosity, conductivity: from the
        molecular transport model (full tier) or Pr/Sc closures.  The
        transport forms the parts that cancel in float (the e-Ar log T
        fits, the third-order electron conductivity, the diffusion block)
        in double whatever the run's precision (physics/gas_transport.py::
        _f64)."""
        if self.transport is None or self.mixture is None:
            cp = self._cp_mass(Y)
            mu = _MU0_SIMPLE * (T / 273.0) ** 0.7
            kappa = cp / _PR * mu
            diff = (mu / _SC)[:, None].expand(Y.shape)
            return diff, mu, kappa
        mix = self.mixture
        U, Up = self._conserved_state(T, Y, p)
        zero_grad = U.new_zeros(U.shape[:-1] + (mix.num_equations, mix.dim))
        props = self.transport.flux_properties(mix, U, Up, zero_grad)
        rho = p * self._mixture_mw(Y) / (_R * T)
        diff = rho[:, None] * props["diffusivity"]  # rho D_s
        kappa = props["kappa"] + props.get("kappa_e", 0.0)
        return diff, props["visc"], kappa

    def viscosity(self):
        return self._transport_props(self.T, self.Y, self.p_thermo)[1]

    def conductivity(self):
        return self._transport_props(self.T, self.Y, self.p_thermo)[2]

    def thermal_divergence(self):
        return self.Qt

    def plasma_conductivity(self):
        """Electric conductivity at the nodes for the EM coupling
        (reference: evaluatePlasmaConductivityGF,
        src/reactingFlow.cpp:3192)."""
        if self.const_plasma_conductivity > 0.0:
            return torch.full_like(self.T, self.const_plasma_conductivity)
        if self.transport is None or self.mixture is None:
            return torch.zeros_like(self.T)
        U, Up = self._conserved_state(self.T, self.Y, self.p_thermo)
        return self.transport.electric_conductivity(U, Up)

    def set_joule_heating(self, qj):
        """The coupling's Joule heating, copied into the tensor the step
        reads (a rebound tensor would leave a captured step heating with
        the old field)."""
        self.joule_heating.copy_(torch.as_tensor(
            qj, dtype=self.T.dtype, device=self.T.device))

    # ----------------------------------------------------------------------
    def step(self, coeff: TemporalCoefficients, dt: float, loops=None):
        """One step's device work (the dense factors are refreshed by the
        caller, before the step)."""
        vel = (self.flow.velocity() if self.flow is not None
               else self.T.new_zeros((self.tab.ndofs, self.tab.dim)))
        T_new, Y_new, Qt, self.info = self._step_impl(
            self.T, self.Y, self.T_hist, self.Y_hist, vel, dt, coeff.order,
            self._direct, loops)
        shift_history(self.T_hist, self.T)
        shift_history(self.Y_hist, self.Y)
        self.T.copy_(T_new)
        self.Y.copy_(Y_new)
        self.Qt.copy_(Qt)
        self.t.add_(dt)
        if self.closed_system:
            # the pressure that keeps the initial mass, on the device
            self.p_thermo.copy_(self._mass0 * _R / h1.integrate(
                self.tab, self._mixture_mw(self.Y) / self.T))

    def _helmholtz_solve(self, rho_c, kappa, x0, rhs, bd0, dt, mask, bc_vals,
                         L, loops):
        tab = self.tab

        def op(v):
            return (bd0 / dt) * h1.mass_apply(tab, rho_c * v) + \
                h1.diffusion_apply(tab, v, kappa)

        diag = (bd0 / dt) * h1.mass_lumped_diag(tab, rho_c) + \
            h1.stiffness_diag(tab, kappa)
        rhs = (rhs - op(bc_vals * (1.0 - mask))) * mask
        diag = diag * mask + (1.0 - mask)
        M = None if L is None else h1.direct_precond(L)
        out, iters, res = h1.cg_solve(
            op, rhs, x0=x0 * mask, diag=diag, dirichlet_mask=mask, M=M,
            tol=self.cg_tol, maxiter=self.cg_maxiter, return_info=True,
            loops=loops)
        return out * mask + bc_vals * (1.0 - mask), iters, res

    def _close_species(self, Y):
        """Ambipolar electron and background closure (reference: step()'s
        quasi-neutrality block and speciesLastStep)."""
        Y = torch.clamp(Y, 0.0, 1.0)
        cols = list(Y.unbind(1))
        if self.ambipolar and self.i_electron >= 0:
            # Y_e = m_e sum_active (q_s / m_s) Y_s
            Ye = float(self.mw[self.i_electron]) * (Y[:, : self.n_active]
                                                    @ self._e_fac)
            cols[self.i_electron] = torch.clamp(Ye, 0.0, 1.0)
        # the background species takes up the remainder
        others = torch.sum(torch.stack(cols[:-1], dim=1), dim=-1)
        cols[-1] = torch.clamp(1.0 - others, 0.0, 1.0)
        Y = torch.stack(cols, dim=1)
        return Y / torch.sum(Y, dim=-1, keepdim=True)

    def _reaction_source(self, T, Y, p, t=None):
        """(dY/dt [1/s], heat release dT/dt [K/s]) at the nodes."""
        rho = p * self._mixture_mw(Y) / (_R * T)
        n_sp = rho[:, None] * torch.clamp(Y, min=0.0) / self._mw
        _, creation = self.chemistry.source(n_sp, T, T)  # kg/m^3/s
        if self.chemistry_base is not None and t is not None:
            # progress rates are linear in the forward coefficients, so
            # blending creation rates is the reference's kfwd blend
            _, cb = self.chemistry_base.source(n_sp, T, T)
            w = torch.clamp((t - self.ramp_start) / self.ramp_time, 0.0, 1.0)
            inside = (t > self.ramp_start) \
                & (t < self.ramp_start + self.ramp_time)
            creation = torch.where(inside, cb + w * (creation - cb),
                                   creation)
        dY = creation / rho[:, None]
        # heat of formation: -sum_s hf_s w_s (reference: heatOfFormation)
        dT = -(creation @ self._hf_mass) / (rho * self._cp_mass(Y))
        return dY, dT

    def _step_impl(self, T, Y, T_hist, Y_hist, vel, dt, order, precond=None,
                   loops=None):
        tab = self.tab
        coeff = TemporalCoefficients.bdf(order)
        bd = (coeff.bd0, coeff.bd1, coeff.bd2, coeff.bd3)
        Ml = tab.ml
        p, t_now, joule = self.p_thermo, self.t, self.joule_heating
        tmask, tbc = self.T_mask, self.T_bc
        ymask, ybc = self.Y_mask, self.Y_bc

        rho = p * self._mixture_mw(Y) / (_R * T)
        cp = self._cp_mass(Y)
        diff, _mu, kappa = self._transport_props(T, Y, p)
        chem_in_transport = not self.operator_split and self._reacting
        if chem_in_transport:
            dY_chem, dT_chem = self._reaction_source(T, Y, p, t_now)

        # ---- PART I: implicit advection-diffusion transport ----
        # active species only; the electron (ambipolar) and the background
        # are algebraic closures (reference: step() :2030-2060)
        cols, y_iters, y_res = [], [], []
        for s in range(self._n_solved):
            hist = -(bd[1] * Y[:, s] + bd[2] * Y_hist[0][:, s]
                     + bd[3] * Y_hist[1][:, s]) / dt
            adv = h1.convection_apply(tab, Y[:, s], vel) / Ml
            rhs = h1.mass_apply(tab, rho * (hist - adv))
            if chem_in_transport:
                rhs = rhs + h1.mass_apply(tab, rho * dY_chem[:, s])
            ys, it, res = self._helmholtz_solve(
                rho, diff[:, s], Y[:, s], rhs, bd[0], dt, ymask, ybc[:, s],
                None if precond is None else precond[1][s], loops)
            cols.append(ys)
            y_iters.append(it)
            y_res.append(res)
        Y_new = self._close_species(
            torch.cat([torch.stack(cols, dim=1), Y[:, len(cols):]], dim=1))

        # temperature: rho cp DT/Dt = div(k grad T) + crossDiff + jh - rad
        rc = rho * cp
        histT = -(bd[1] * T + bd[2] * T_hist[0] + bd[3] * T_hist[1]) / dt
        advT = h1.convection_apply(tab, T, vel) / Ml
        rhsT = h1.mass_apply(tab, rc * (histT - advT))

        # cross-diffusion: sum_s cp_s (rho D_s grad Y_s) . grad T
        # (reference: crossDiffusion, src/reactingFlow.cpp:2700+)
        gT = h1.grad_at_dofs(tab, T)
        cross = torch.zeros_like(T)
        for s in range(self.nsp):
            gY = h1.grad_at_dofs(tab, Y_new[:, s])
            cross = cross + self._cp_s[s] * diff[:, s] * torch.sum(
                gY * gT, dim=-1)
        src_T = cross + joule
        if self.radiation is not None:
            src_T = src_T + self.radiation.energy_sink(T)  # a negative sink
        if chem_in_transport:
            src_T = src_T + rc * dT_chem
        rhsT = rhsT + h1.mass_apply(tab, src_T)
        T_new, t_iters, t_res = self._helmholtz_solve(
            rc, kappa, T, rhsT, bd[0], dt, tmask, tbc,
            None if precond is None else precond[0], loops)

        # ---- PART II: operator-split chemistry substeps ----
        # each substep adds 1/n of the transport increment (reference:
        # substepState :2156, species/temperatureSubstep)
        if self.operator_split and self._reacting:
            nsub = self.n_substeps
            sub_dt = dt / nsub
            dY_star = (Y_new - Y) / nsub
            dT_star = (T_new - T) / nsub
            Ts, Ys = T, Y
            for _ in range(nsub):
                dY, dT = self._reaction_source(Ts, Ys, p, t_now)
                Ys, Ts = (self._close_species(Ys + dY_star + sub_dt * dY),
                          Ts + dT_star + sub_dt * dT)
            T_new = Ts * tmask + tbc * (1.0 - tmask)
            # the species Dirichlet values after the substeps (the
            # reference's essential dofs are never touched by them)
            Y_new = self._close_species(
                Ys * ymask[:, None] + ybc * (1.0 - ymask[:, None]))

        # ---- thermal divergence, operator form (reference computeQtTO,
        # src/reactingFlow.cpp:3378-3445): Qt = (Rmix / (cp p))
        # [M^-1 (-L T_next) + jh - rad + crossDiff + chem], from the
        # diffusion and source operators, never the material derivative
        W_new = self._mixture_mw(Y_new)
        cp_new = self._cp_mass(Y_new)
        rho_new = p * W_new / (_R * T_new)
        lap, qt_iters, _ = h1.l2_project(
            tab, -h1.diffusion_apply(tab, T_new, kappa), return_info=True,
            loops=loops)
        src_q = cross + joule
        if self.radiation is not None:
            src_q = src_q + self.radiation.energy_sink(T_new)
        if self._reacting:
            _, dT_chem = self._reaction_source(T_new, Y_new, p, t_now)
            src_q = src_q + rho_new * cp_new * dT_chem
        Qt = (lap + src_q) / (rho_new * cp_new * T_new) * self.Qt_mask
        info = {"T_iters": t_iters, "T_res": t_res, "Qt_iters": qt_iters}
        if y_iters:
            info["Y_iters"] = sum(y_iters[1:], y_iters[0])
            info["Y_res"] = torch.max(torch.stack(y_res))
        return T_new, Y_new, Qt, info
