"""Tomboulides-style fractional-step variable-density flow solver.

The port of the JAX package's solvers/lomach/tomboulides.py (reference:
src/tomboulides.cpp:1530-2036, Tomboulides 1997 splitting) in its
rotational, non-incremental form:

  2) vstar/dt = extrapolated convection + forcing + BDF history
  3) pressure Poisson  div((1/rho) grad p) with RHS built from
     pp_div = vstar/dt + nu (-curl curl u_ext + 4/3 grad Qt)
              + (2 S(u_ext) . grad(mu) - 2/3 Qt grad(mu)) / rho
     weak form (grad q, pp_div) + (bd0/dt)[(q, Qt) - oint q u_bc.n]
  4) Helmholtz velocity solve with
     rhs = (v, rho vstar/dt - grad p + 1/3 grad(mu Qt) + S_mom),
     S_mom = (grad u_ext)^T grad(mu) - Qt grad(mu)

Pure-Neumann (orthogonalised) and pressure-Dirichlet (outlet) Poisson
solves; spatially varying and time-ramped velocity Dirichlet values (an
interpolated inlet writes its ramped values into `vel_bc_values` in
place, solver.py); a geometric sponge (sponge.py) scales the total
viscosity.  The
pressure solve is preconditioned by the lagged dense Cholesky factor on
small spaces (fem/h1.py dense_capable), else by two-level p-multigrid,
else by Chebyshev; the velocity components are solved together, in one
multi-column CG.

`step` refreshes the lagged dense factors when they are due and then
`advance`s; `advance` is device work only (the ramp reads the device time
`t`), so the low-Mach step loop captures it as CUDA graphs.  The dense
factors are refreshed outside the graph, into the same tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...fem import h1
from .base import FlowBase, TemporalCoefficients, shift_history, zeros


@dataclass
class VelocityDirichlet:
    attrs: tuple
    value: tuple  # velocity vector, or callable(xyz [n, dim] numpy) -> [n, dim]
    ramp_time: float = 0.0  # linear 0 -> value ramp (reference: SetTime)


@dataclass
class PressureDirichlet:
    attrs: tuple
    value: float


def _col(a, v):
    """A per-dof [nd] factor shaped to multiply v ([nd] or [nd, k])."""
    return a[:, None] if v.ndim == 2 else a


class Tomboulides(FlowBase):
    _PRECOND_REFRESH = 16

    def __init__(self, tab, thermo, turb=None, vel_bcs=(), body_force=None,
                 sponge=None, cg_tol=1e-10, cg_maxiter=1000, mesh=None,
                 pres_bcs=(), gravity=None):
        self.tab = tab
        self.sponge = sponge
        self.thermo = thermo
        self.turb = turb
        self.vel_bcs = tuple(vel_bcs)
        dtype, dev = tab.wq.dtype, tab.wq.device
        kw = {"dtype": dtype, "device": dev}
        # a body force is evaluated once, at the dof coordinates
        self.body_force = None if body_force is None else \
            torch.as_tensor(body_force(tab.xyz), **kw)
        # constant gravitational acceleration [dim] added to the velocity
        # equation (reference: loMach/gravity, src/tomboulides.cpp:419-434)
        self.gravity = None if gravity is None else torch.as_tensor(
            np.asarray(gravity, dtype=np.float64), **kw)
        self.cg_tol = cg_tol
        self.cg_maxiter = cg_maxiter

        # two-level p-multigrid data for the pressure Poisson solve
        # (the reference preconditions with LOR BoomerAMG,
        # src/tomboulides.cpp:1582-1610)
        self._pmg = None
        if mesh is not None and tab.order > 1:
            tab_c_np = h1.build_h1(mesh, order=1)
            P_ids, P_wts, c2f = h1.build_p_interp(tab, tab_c_np, mesh)
            self._pmg = {
                "tab_c": tab_c_np.to_torch(dtype, dev),
                "P": h1.PInterp.from_numpy(P_ids, P_wts, c2f,
                                           tab_c_np.ndofs, dtype, dev),
            }

        dim = tab.dim
        nd = tab.ndofs
        self.u = zeros(tab, nd, dim)
        self.u_hist = [zeros(tab, nd, dim) for _ in range(3)]  # u^{n-1}, ...
        self.N_hist = [zeros(tab, nd, dim) for _ in range(3)]  # conv terms
        self.p = zeros(tab, nd)
        self.t = zeros(tab)  # the ramps' clock, on the device
        self.info = {}

        # velocity Dirichlet machinery: spatially varying values (callables
        # evaluated at dof coordinates) and per-BC ramp times
        xyz = h1._np(tab.xyz)
        self._vel_ramps = []  # (dof ids, base values, ramp_time)
        free = np.ones(nd)
        vals = np.zeros((nd, dim))
        for bc in self.vel_bcs:
            dofs = h1.boundary_dofs(tab, bc.attrs)
            free[dofs] = 0.0
            if callable(bc.value):
                v = np.asarray(bc.value(xyz[dofs]), dtype=np.float64)
            else:
                v = np.broadcast_to(np.asarray(bc.value, np.float64),
                                    (len(dofs), dim)).copy()
            vals[dofs] = v
            if bc.ramp_time > 0.0:
                self._vel_ramps.append((
                    torch.as_tensor(dofs.astype(np.int64), device=dev),
                    torch.as_tensor(v, **kw), bc.ramp_time))
        self.vel_mask = torch.as_tensor(free, **kw)
        self.vel_bc_values = torch.as_tensor(vals, **kw)

        # boundary faces of velocity-Dirichlet patches (for the
        # oint q u_bc.n pressure-RHS term; none: the term is zero)
        vel_attrs = sorted({a for bc in self.vel_bcs for a in bc.attrs})
        bf_attr = h1._np(tab.bf_attr)
        self._vel_face_sel = None
        if vel_attrs and len(bf_attr):
            self._vel_face_sel = torch.as_tensor(
                np.isin(bf_attr, vel_attrs).astype(np.float64), **kw)

        # pressure Dirichlet (outlets); pure Neumann otherwise
        self.pres_bcs = tuple(pres_bcs)
        if self.pres_bcs:
            pfree = np.ones(nd)
            pvals = np.zeros(nd)
            for bc in self.pres_bcs:
                dofs = h1.boundary_dofs(tab, bc.attrs)
                pfree[dofs] = 0.0
                pvals[dofs] = bc.value
            self.pres_mask = torch.as_tensor(pfree, **kw)
            self.pres_bc_values = torch.as_tensor(pvals, **kw)
            self._ortho = False
        else:
            self.pres_mask = None
            self.pres_bc_values = None
            self._ortho = True  # pure Neumann -> orthogonalize

        # lagged dense-direct preconditioner (small spaces only): the
        # factors (pressure, Helmholtz), refreshed every _PRECOND_REFRESH
        # steps into the same tensors; exactness is never required, CG
        # still iterates to tolerance
        self._direct = None
        self._direct_age = None
        self.refreshes = 0  # dense refreshes so far

    # -- lagged dense factors ----------------------------------------------
    def _total_viscosity(self):
        rho = self.thermo.density()
        mu = self.thermo.viscosity()
        if self.turb is not None:
            mu = mu + rho * self.turb.eddy_viscosity()
        if self.sponge is not None:
            # the geometric sponge scales the total viscosity (reference:
            # src/tomboulides.cpp:2077)
            mu = mu * self.sponge.multiplier()
        return rho, mu

    def _precond_build(self, rho, mu, dt, bd0):
        tab = self.tab
        Kp_e = h1.element_stiffness(tab, 1.0 / rho)
        He_e = (bd0 / dt) * h1.element_mass(tab, rho) \
            + h1.element_stiffness(tab, mu)
        Kp, He = h1.assemble_dense(tab, torch.stack([Kp_e, He_e]))
        if self.pres_mask is not None:
            Kp = h1.dense_constrain(Kp, mask=self.pres_mask)
        else:
            Kp = h1.dense_constrain(Kp, ortho=True)
        He = h1.dense_constrain(He, mask=self.vel_mask)
        L = h1.dense_cholesky(torch.stack([Kp, He]))
        return L[0], L[1]

    def precond_refresh(self, dt, order, force=False):
        """Refresh the lagged dense pressure/Helmholtz factors when due
        (eager, outside any captured step), into the same tensors."""
        if not h1.dense_capable(self.tab):
            return
        age = self._direct_age
        if not force and age is not None and age < self._PRECOND_REFRESH:
            return
        rho, mu = self._total_viscosity()
        bd0 = TemporalCoefficients.bdf(order).bd0
        L = self._precond_build(rho, mu, dt, bd0)
        if self._direct is None:
            self._direct = L
        else:
            for dst, src in zip(self._direct, L):
                dst.copy_(src)
        self._direct_age = 0
        self.refreshes += 1

    # -- public API --------------------------------------------------------
    def set_velocity(self, u0):
        self.u.copy_(torch.as_tensor(u0, dtype=self.u.dtype,
                                     device=self.u.device))
        N0 = self._convection(self.u)
        for h, n in zip(self.u_hist, self.N_hist):
            h.copy_(self.u)
            n.copy_(N0)

    def velocity(self):
        return self.u

    def step(self, coeff: TemporalCoefficients, dt: float, loops=None):
        """One step, as the JAX package's: the dense factors refreshed when
        due, then `advance`."""
        self.precond_refresh(dt, coeff.order)
        if self._direct_age is not None:
            self._direct_age += 1
        self.advance(coeff, dt, loops)

    def advance(self, coeff, dt, loops=None):
        """The step's device work: t += dt, the split scheme, the state
        committed in place; self.info holds its solves' iterations and
        relative residuals (device scalars)."""
        rho, mu = self._total_viscosity()
        qt = self.thermo.thermal_divergence()
        self.t.add_(dt)
        u_new, p_new, N_now, self.info = self._step_impl(
            self.u, self.p, self.u_hist, self.N_hist, rho, mu, qt,
            self._ramped_ubc(self.t), dt, coeff.order, self._direct, loops)
        shift_history(self.u_hist, self.u)
        shift_history(self.N_hist, N_now)
        self.u.copy_(u_new)
        self.p.copy_(p_new)

    @property
    def solve_info(self):
        """Latest solver iterations/residuals (a host read)."""
        return {k: float(v) for k, v in self.info.items()}

    @staticmethod
    def check_solve_info(vals):
        """A diverged solve raises (the reference's hypre solvers print
        iterations/residual and abort on non-convergence)."""
        if not (vals["p_res"] < 1e-3 and vals["v_res"] < 1e-3):
            raise FloatingPointError(
                f"implicit solve did not converge: {vals}")

    def _ramped_ubc(self, t):
        """Velocity Dirichlet values with the ramps at device time t
        (reference: coefficient SetTime on the velocity dbcs)."""
        ubc = self.vel_bc_values
        for (jd, v, ramp) in self._vel_ramps:
            w = torch.clamp(t / ramp, 0.0, 1.0)
            ubc = ubc.index_copy(0, jd, w * v)
        return ubc

    # -- internals ---------------------------------------------------------
    def _convection(self, u):
        """-M^-1_lumped (v,(u.grad)u) nodal convection acceleration."""
        return -h1.convection_apply(self.tab, u, u) / self.tab.ml[:, None]

    def _curl(self, u):
        """Nodal curl via lumped projections of component gradients.

        2-D: returns scalar omega [nd]; 3-D: vector [nd, 3]
        (reference: ComputeCurl2D/3D, src/tomboulides.cpp:1720-1731)."""
        tab = self.tab
        g = [h1.grad_at_dofs(tab, u[:, d]) for d in range(u.shape[-1])]
        if tab.dim == 2:
            return g[1][:, 0] - g[0][:, 1]
        return torch.stack(
            [g[2][:, 1] - g[1][:, 2],
             g[0][:, 2] - g[2][:, 0],
             g[1][:, 0] - g[0][:, 1]], dim=-1)

    def _curl_curl(self, u):
        tab = self.tab
        w = self._curl(u)
        if tab.dim == 2:
            gw = h1.grad_at_dofs(tab, w)
            # curl(w zhat) = (dw/dy, -dw/dx)
            return torch.stack([gw[:, 1], -gw[:, 0]], dim=-1)
        return self._curl(w)

    def _step_impl(self, u, p, u_hist, N_hist, rho, mu, qt, ubc, dt, order,
                   precond=None, loops=None):
        tab = self.tab
        coeff = TemporalCoefficients.bdf(order)
        bd = (coeff.bd0, coeff.bd1, coeff.bd2, coeff.bd3)
        ab = (coeff.ab1, coeff.ab2, coeff.ab3)
        mask = self.vel_mask
        inv_rho = 1.0 / rho
        cg = {"tol": self.cg_tol, "maxiter": self.cg_maxiter,
              "return_info": True, "loops": loops}

        # ---- Step 2: vstar/dt (reference :1930-2000) ----
        N_now = self._convection(u)
        N_ext = ab[0] * N_now + ab[1] * N_hist[0] + ab[2] * N_hist[1]
        if self.body_force is not None:
            N_ext = N_ext + self.body_force / rho[:, None]
        if self.gravity is not None:
            N_ext = N_ext + self.gravity[None, :]
        hist = -(bd[1] * u + bd[2] * u_hist[0] + bd[3] * u_hist[1]) / dt
        ustar_dt = N_ext + hist  # acceleration: vstar/dt

        # ---- Step 3: pressure Poisson, rotational form ----
        u_ext = ab[0] * u + ab[1] * u_hist[0] + ab[2] * u_hist[1]
        nu = mu * inv_rho
        pp_div = ustar_dt - nu[:, None] * self._curl_curl(u_ext)
        pp_div = pp_div + (4.0 / 3.0) * nu[:, None] * h1.grad_at_dofs(tab, qt)
        # variable-viscosity terms (reference S_poisson_coeff :875-879)
        gmu = h1.grad_at_dofs(tab, mu)
        gu = [h1.grad_at_dofs(tab, u_ext[:, d]) for d in range(tab.dim)]
        graduT_gmu = torch.stack(
            [torch.einsum("nd,nd->n", gu[d], gmu) for d in range(tab.dim)],
            dim=-1)  # (grad u)^T grad(mu)
        gradu_gmu = torch.stack(
            [sum(gu[k][:, d] * gmu[:, k] for k in range(tab.dim))
             for d in range(tab.dim)], dim=-1)  # (grad u) grad(mu)
        twoS_gmu = graduT_gmu + gradu_gmu
        pp_div = pp_div + (
            twoS_gmu - (2.0 / 3.0) * qt[:, None] * gmu
        ) * inv_rho[:, None]

        # weak RHS: (grad q, pp_div) + (bd0/dt)[(q, Qt) - oint q u_bc.n]
        b = h1.weak_divergence(tab, pp_div) \
            + (bd[0] / dt) * h1.mass_apply(tab, qt)
        if self._vel_face_sel is not None:
            b = b - (bd[0] / dt) * h1.surface_normal_form(
                tab, ubc, self._vel_face_sel)

        def lap(v):
            return h1.diffusion_apply(tab, v, inv_rho)

        pdiag = h1.stiffness_diag(tab, inv_rho)
        if self.pres_mask is not None:
            pmask = self.pres_mask
            pbc = self.pres_bc_values
            b = (b - lap(pbc * (1.0 - pmask))) * pmask
            pdiag_c = pdiag * pmask + (1.0 - pmask)

            def lap_m(v):
                return lap(v * pmask) * pmask + v * (1.0 - pmask)

            if precond is not None:
                # the lagged dense factor: exact for the factor-time rho,
                # a near-exact preconditioner for the current one
                M_p = h1.direct_precond(precond[0])
            elif self._pmg is not None:
                # mask-aware two-level V(1,1): the coarse operator is the
                # same 1/rho Laplacian on the order-1 space with the
                # pressure-Dirichlet mask injected at the vertices
                tab_c = self._pmg["tab_c"]
                c2f = self._pmg["P"].c2f
                inv_rho_c = inv_rho[c2f]
                pmask_c = pmask[c2f]

                def lap_c_m(v):
                    return h1.diffusion_apply(
                        tab_c, v * pmask_c, inv_rho_c
                    ) * pmask_c + v * (1.0 - pmask_c)

                diag_cc = h1.stiffness_diag(tab_c, inv_rho_c) * pmask_c \
                    + (1.0 - pmask_c)
                M_p = h1.pmg_precond(lap_m, pdiag_c, lap_c_m, diag_cc,
                                     self._pmg["P"])
            else:
                M_p = h1.chebyshev_precond(lap_m, pdiag_c, degree=3)
            p_new, p_iters, p_res = h1.cg_solve(
                lap, b, x0=p * pmask, diag=pdiag_c, dirichlet_mask=pmask,
                M=M_p, **cg)
            p_new = p_new * pmask + pbc * (1.0 - pmask)
        else:
            if self._ortho:
                b = b - torch.mean(b)
            M_p = None
            if precond is not None:
                M_p = h1.direct_precond(precond[0])
            elif self._pmg is not None:
                # p-multigrid V(1,1): coarse operator = same 1/rho
                # Laplacian on the order-1 space, coefficient injected at
                # the vertices
                tab_c = self._pmg["tab_c"]
                inv_rho_c = inv_rho[self._pmg["P"].c2f]

                def lap_c(v):
                    return h1.diffusion_apply(tab_c, v, inv_rho_c)

                M_p = h1.pmg_precond(
                    lap, pdiag, lap_c, h1.stiffness_diag(tab_c, inv_rho_c),
                    self._pmg["P"], ortho=self._ortho)
            p_new, p_iters, p_res = h1.cg_solve(
                lap, b, x0=p, diag=pdiag, M=M_p, **cg)
            if self._ortho:
                p_new = p_new - torch.mean(p_new)

        # ---- Step 4: Helmholtz velocity solve (reference :1895-1930) ----
        # rhs = (v, rho vstar/dt - grad p + 1/3 grad(mu Qt) + S_mom)
        gradp = h1.grad_at_dofs(tab, p_new)
        S_mom = graduT_gmu - qt[:, None] * gmu
        rhs_nodal = rho[:, None] * ustar_dt - gradp + S_mom \
            + (1.0 / 3.0) * h1.grad_at_dofs(tab, mu * qt)
        rhs = h1.mass_apply(tab, rhs_nodal)

        def helm(v):
            return (bd[0] / dt) * h1.mass_apply(tab, _col(rho, v) * v) + \
                h1.diffusion_apply(tab, v, mu)

        diag = (bd[0] / dt) * h1.mass_lumped_diag(tab, rho) \
            + h1.stiffness_diag(tab, mu)
        rhs = (rhs - helm(ubc * (1.0 - mask)[:, None])) * mask[:, None]
        diag_c = diag * mask + (1.0 - mask)

        if precond is not None:
            # all velocity components in one multi-RHS CG with the lagged
            # dense factor, stopped when every column has converged
            u_new, v_iters, v_res = h1.cg_solve_multi(
                helm, rhs, x0=u * mask[:, None], diag=diag_c[:, None],
                dirichlet_mask=mask[:, None],
                M=h1.direct_precond(precond[1]), **cg)
        else:
            # Chebyshev-preconditioned, each component stopped at its own
            # tolerance (the JAX package's per-component cg_solve loop),
            # all components in one sweep
            def helm_m(v):
                m = _col(mask, v)
                return helm(v * m) * m + v * (1.0 - m)

            M_helm = h1.chebyshev_precond(helm_m, diag_c, degree=2)
            u_new, v_iters, v_res = h1.cg_solve_multi(
                helm, rhs, x0=u * mask[:, None], diag=diag_c,
                dirichlet_mask=mask, M=M_helm, per_column=True, **cg)
        u_new = u_new * mask[:, None] + ubc * (1.0 - mask)[:, None]

        info = {"p_iters": p_iters, "p_res": p_res,
                "v_iters": v_iters, "v_res": v_res}
        return u_new, p_new, N_now, info
