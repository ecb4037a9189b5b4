"""Axisymmetric (r, z) Tomboulides flow with optional swirl.

The port of the JAX package's solvers/lomach/axisym.py (the role of the
reference's axisymmetric low-Mach path, src/tomboulides.cpp axisym_/swirl
support, src/loMach.cpp loMach/axisymmetric): coordinates are (x = r,
y = z); every weak form carries the Jacobian factor r, which turns the
r-weighted stiffness into the axisymmetric vector Laplacian except for
the extra -mu u/r^2 terms on u_r and u_theta (added as (v, mu u / r) mass
terms; quadrature points are strictly interior, so r_q > 0 even in
elements touching the axis).  Swirl u_theta adds the centrifugal force
rho u_theta^2 / r to the r-momentum and the Coriolis transport
rho u_r u_theta / r to the theta-momentum.  Axis dofs (r < axis_tol)
carry Dirichlet u_r = u_theta = 0.

The step: the r-weighted pressure gradient (a consistent-mass projection,
both components in one multi-column CG), one multi-column Helmholtz CG
for u_r, u_z (and u_theta), the pressure-correction Poisson solve, and
the projection of its gradient.  Every CG solve runs its blocks through
the caller's `loops` (the low-Mach step loop's SolveLoops); the state
lives in tensors updated in place; the lagged dense factors of the five
radius-weighted operators are refreshed outside the step, into the same
tensors (base class `precond_refresh`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...fem import h1
from .base import TemporalCoefficients, shift_history, zeros
from .tomboulides import Tomboulides


@dataclass
class SwirlDirichlet:
    attrs: tuple
    value: float  # u_theta on the patch (or a 1-tuple)


class TomboulidesAxisym(Tomboulides):
    def __init__(self, tab, thermo, turb=None, vel_bcs=(), swirl=False,
                 swirl_bcs=(), body_force=None, sponge=None,
                 cg_tol=1e-10, cg_maxiter=1000, axis_tol=1e-12,
                 gravity=None):
        # no mesh (no p-multigrid) and no pressure Dirichlet: the JAX
        # package's axisymmetric flow solves a pure-Neumann Poisson problem
        super().__init__(tab, thermo, turb=turb, vel_bcs=vel_bcs,
                         body_force=body_force, sponge=sponge,
                         cg_tol=cg_tol, cg_maxiter=cg_maxiter,
                         gravity=gravity)
        kw = {"dtype": tab.wq.dtype, "device": tab.wq.device}
        nd = tab.ndofs
        self.swirl = swirl
        self.rad_q = tab.xyz_q[..., 0]  # radius at quad points (> 0)
        r_nodal = h1._np(tab.xyz)[:, 0]
        axis = r_nodal < axis_tol
        # axis-safe radius: a where on both the divisor and the quotient
        self._r_pos = tab.xyz[:, 0] > 0.0
        self._r_safe = torch.where(self._r_pos, tab.xyz[:, 0],
                                   torch.ones_like(tab.xyz[:, 0]))

        # component masks: u_r gets the axis Dirichlet on top of walls
        base = h1._np(self.vel_mask)
        mask_r = base.copy()
        mask_r[axis] = 0.0
        self.vel_mask_c = torch.as_tensor(np.stack([mask_r, base], axis=-1),
                                          **kw)

        self.ut = zeros(tab, nd)
        self.ut_hist = [zeros(tab, nd) for _ in range(3)]
        self.Nt_hist = [zeros(tab, nd) for _ in range(3)]
        free = np.array(base)
        vals = np.zeros(nd)
        if swirl:
            for bc in swirl_bcs:
                dofs = h1.boundary_dofs(tab, tuple(bc.attrs))
                free[dofs] = 0.0
                vals[dofs] = (bc.value if np.isscalar(bc.value)
                              else bc.value[0])
            free[axis] = 0.0
        else:
            free[:] = 1.0
        self.swirl_mask = torch.as_tensor(free, **kw)
        self.swirl_bc_values = torch.as_tensor(vals, **kw)
        self._extra_col = torch.as_tensor([1.0, 0.0, 1.0][:3 if swirl else 2],
                                          **kw)

    def set_swirl(self, ut0):
        ut0 = torch.as_tensor(ut0, dtype=self.ut.dtype, device=self.ut.device)
        self.ut.copy_(ut0 * self.swirl_mask
                      + self.swirl_bc_values * (1.0 - self.swirl_mask))
        for h in self.ut_hist:
            h.copy_(self.ut)

    def swirl_velocity(self):
        return self.ut

    def _precond_build(self, rho, mu, dt, bd0):
        """Lagged dense factors of the radius-weighted operators: [0] the
        r/rho pressure Laplacian, [1] the z-momentum Helmholtz, [2] the
        r-momentum Helmholtz (with the (v, mu u / r) mass term), [3] the
        r-weighted consistent mass (the gradient projections), and, with
        swirl, [4] the r-momentum Helmholtz constrained with the swirl
        mask."""
        tab = self.tab
        rq = self.rad_q
        rho_q = h1.to_quad(tab, rho)
        mu_q = h1.to_quad(tab, mu)
        Kp_e = h1.element_stiffness(tab, rq / rho_q)
        He_e = (bd0 / dt) * h1.element_mass(tab, rho_q * rq) \
            + h1.element_stiffness(tab, mu_q * rq)
        Hx_e = He_e + h1.element_mass(tab, mu_q / rq)
        Mr_e = h1.element_mass(tab, rq)
        Kp, He, Hx, Mr = h1.assemble_dense(
            tab, torch.stack([Kp_e, He_e, Hx_e, Mr_e]))
        if self.pres_mask is not None:
            Kp_c = h1.dense_constrain(Kp, mask=self.pres_mask)
        else:
            Kp_c = h1.dense_constrain(Kp, ortho=True)
        mats = [Kp_c,
                h1.dense_constrain(He, mask=self.vel_mask_c[:, 1]),
                h1.dense_constrain(Hx, mask=self.vel_mask_c[:, 0]),
                Mr]
        if self.swirl:
            mats.append(h1.dense_constrain(Hx, mask=self.swirl_mask))
        L = h1.dense_cholesky(torch.stack(mats))
        return tuple(L[i] for i in range(len(mats)))

    def advance(self, coeff, dt, loops=None):
        """The step's device work (base class `advance`), with the swirl
        state."""
        rho, mu = self._total_viscosity()
        qt = self.thermo.thermal_divergence()
        self.t.add_(dt)
        u_new, p_new, ut_new, N_now, Nt_now, self.info = self._step_impl_axi(
            rho, mu, qt, self._ramped_ubc(self.t), dt, coeff.order,
            self._direct, loops)
        shift_history(self.u_hist, self.u)
        shift_history(self.N_hist, N_now)
        shift_history(self.ut_hist, self.ut)
        shift_history(self.Nt_hist, Nt_now)
        self.u.copy_(u_new)
        self.p.copy_(p_new)
        self.ut.copy_(ut_new)

    # ------------------------------------------------------------------
    def _step_impl_axi(self, rho, mu, qt, ubc, dt, order, precond=None,
                       loops=None):
        tab = self.tab
        u, p, ut = self.u, self.p, self.ut
        u_hist, N_hist = self.u_hist, self.N_hist
        ut_hist, Nt_hist = self.ut_hist, self.Nt_hist
        coeff = TemporalCoefficients.bdf(order)
        bd = (coeff.bd0, coeff.bd1, coeff.bd2, coeff.bd3)
        ab = (coeff.ab1, coeff.ab2, coeff.ab3)
        rq = self.rad_q
        r_pos, r_safe = self._r_pos, self._r_safe

        Ml = tab.ml
        # r-weighted consistent-mass diagonal (int phi_i^2 r > 0 strictly;
        # the row-sum lumped mass has zero rows at axis nodes for p >= 2)
        Dr = h1.mass_diag(tab, rq)
        M_mass = (h1.direct_precond(precond[3])
                  if precond is not None else None)
        g_iters = []

        def grad_r(s):
            """r-weighted L2 gradient projection (a consistent-mass CG
            solve, both components in one multi-column CG): the discrete
            adjoint of the r-weighted pressure Laplacian."""
            num = h1.weak_grad(tab, s, coef=rq)
            g, it, _ = h1.cg_solve_multi(
                lambda v: h1.mass_apply(tab, v, coef=rq), num,
                x0=num / Dr[:, None], diag=Dr, M=M_mass, tol=1e-12,
                maxiter=200, return_info=True, loops=loops)
            g_iters.append(it)
            return g

        mu_q = h1.to_quad(tab, mu)
        rho_q = h1.to_quad(tab, rho)

        # nodal convection acceleration: (u.grad)q is pointwise, so the
        # unweighted lumped projection is used (the r-weighted lumped mass
        # degenerates at axis nodes)
        def conv_nodal(field):
            return h1.convection_apply(tab, field, u) / (
                Ml[:, None] if field.ndim > 1 else Ml)

        N_now = -conv_nodal(u)
        if self.swirl:
            # centrifugal u_t^2 / r -> r-momentum (as acceleration)
            N_now[:, 0] = N_now[:, 0] + torch.where(
                r_pos, ut * ut / r_safe, torch.zeros_like(ut))
        if self.body_force is not None:
            N_now = N_now + self.body_force / rho[:, None]
        N_ext = ab[0] * N_now + ab[1] * N_hist[0] + ab[2] * N_hist[1]
        hist = -(bd[1] * u + bd[2] * u_hist[0] + bd[3] * u_hist[1]) / dt

        gradp = grad_r(p)
        rhs = h1.mass_apply(tab, rho[:, None] * (hist + N_ext) - gradp,
                            coef=rq)

        # Helmholtz with the extra r-weighted (v, mu u / r) term on u_r
        # (and u_theta)
        mu_over_r = mu_q / rq
        diag_base = ((bd[0] / dt) * h1.mass_lumped_diag(tab, rho_q * rq)
                     + h1.stiffness_diag(tab, mu_q * rq))
        diag_extra = h1.mass_lumped_diag(tab, mu_over_r)
        masks = self.vel_mask_c

        if self.swirl:
            Nt_now = (-conv_nodal(ut)
                      - torch.where(r_pos, u[:, 0] * ut / r_safe,
                                    torch.zeros_like(ut)))
            Nt_ext = (ab[0] * Nt_now + ab[1] * Nt_hist[0]
                      + ab[2] * Nt_hist[1])
            hist_t = -(bd[1] * ut + bd[2] * ut_hist[0]
                       + bd[3] * ut_hist[1]) / dt
            rhs_t = h1.mass_apply(tab, rho * (hist_t + Nt_ext), coef=rq)
            smask = self.swirl_mask
            sbc = self.swirl_bc_values
        else:
            Nt_now = torch.zeros_like(ut)

        # columns [u_r, u_z] (+ [u_theta] with swirl) in one multi-column
        # CG; the extra (v, mu u / r) mass term on the r and theta columns
        ncol = 3 if self.swirl else 2
        extra_col = self._extra_col
        B_bc = torch.stack(
            [ubc[:, 0] * (1.0 - masks[:, 0]), ubc[:, 1] * (1.0 - masks[:, 1])]
            + ([sbc * (1.0 - smask)] if self.swirl else []), dim=-1)
        mask_m = torch.stack(
            [masks[:, 0], masks[:, 1]] + ([smask] if self.swirl else []),
            dim=-1)
        rhs_m = torch.stack(
            [rhs[:, 0], rhs[:, 1]] + ([rhs_t] if self.swirl else []), dim=-1)
        x0_m = torch.stack(
            [u[:, 0], u[:, 1]] + ([ut] if self.swirl else []), dim=-1)

        # density and viscosity as quadrature-point coefficients (the
        # reference's GridFunctionCoefficient semantics)
        m_rz = (bd[0] / dt) * rho_q * rq
        mass_cs = torch.stack([m_rz + mu_q / rq, m_rz]
                              + ([m_rz + mu_q / rq] if self.swirl else []))
        diff_cs = torch.stack([mu_q * rq] * ncol)

        def helm_m(V):
            return h1.helmholtz_apply_multi(tab, V, 1.0, mass_cs, diff_cs)

        lift = helm_m(B_bc)
        rhs_cols = (rhs_m - lift) * mask_m
        diag_m = diag_base[:, None] + diag_extra[:, None] * extra_col[None, :]
        diag_m = diag_m * mask_m + (1.0 - mask_m)
        if precond is not None:
            facs = [precond[2], precond[1]]
            if self.swirl:
                facs.append(precond[4] if len(precond) > 4 else precond[2])
            M_m = h1.direct_precond_stack(facs)
        else:
            M_m = None
        sol, v_iters, v_res = h1.cg_solve_multi(
            helm_m, rhs_cols, x0=x0_m * mask_m, diag=diag_m,
            dirichlet_mask=mask_m, M=M_m, tol=self.cg_tol,
            maxiter=self.cg_maxiter, return_info=True, loops=loops)
        sol = sol * mask_m + B_bc
        u_star = sol[:, :2]
        ut_new = sol[:, 2] if self.swirl else ut

        # pressure correction: (grad v, (1/rho) grad phi) r =
        #   (bd0/dt) [ (grad v, u*) r + (v, Qt) r ]
        b = (bd[0] / dt) * (h1.weak_divergence(tab, u_star, coef=rq)
                            + h1.mass_apply(tab, qt, coef=rq))
        if self._ortho:
            b = b - torch.mean(b)
        inv_rho_c = rq / rho_q

        def lap(v):
            return h1.diffusion_apply(tab, v, inv_rho_c)

        pdiag = h1.stiffness_diag(tab, inv_rho_c)
        M_p = h1.direct_precond(precond[0]) if precond is not None else None
        phi, p_iters, p_res = h1.cg_solve(
            lap, b, x0=torch.zeros_like(p), diag=pdiag, M=M_p,
            tol=self.cg_tol, maxiter=self.cg_maxiter, return_info=True,
            loops=loops)
        if self._ortho:
            phi = phi - torch.mean(phi)

        gphi = grad_r(phi)
        u_new = u_star - (dt / bd[0]) * gphi / rho[:, None]
        u_new = u_new * masks + ubc * (1.0 - masks)
        p_new = p + phi
        info = {"p_iters": p_iters, "p_res": p_res, "v_iters": v_iters,
                "v_res": v_res, "g_iters": g_iters[0] + g_iters[1]}
        return u_new, p_new, ut_new, N_now, Nt_now, info
