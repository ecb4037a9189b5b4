"""Four-equation zeta-f RANS model of the low-Mach path.

The port of the JAX package's solvers/lomach/zeta_model.py (reference
src/zetaModel.cpp, the "code-friendly" zeta-f of Hanjalic, Popovac &
Hadziabdic 2004): transport equations for the turbulent kinetic energy
k, its dissipation rate eps, the wall-normal velocity-scale ratio v2
(zeta = v2/k), and the elliptic-relaxation variable f.  Each transport
equation is an implicit BDF Helmholtz solve with explicit convection,
diffusion coefficient mu + mu_t/sigma and semi-implicit destruction; f
solves the elliptic relaxation equation L^2 lap(f) - f = rhs.  Constants
follow the reference defaults (src/zetaModel.hpp:238-250).

Inlet values are uniform (scalars) or, for an interpolated inlet, the
profiles of `ransModel/zeta-f-file` at its dofs (interop/ext_data.py,
solver.py).  The state (k, eps, v2, f, mu_t and the histories) is updated in place.
"""

from __future__ import annotations

import numpy as np
import torch

from ...fem import h1
from .base import TemporalCoefficients, TurbModelBase, full, shift_history

TANH_HALF = 0.54930615


class ZetaModel(TurbModelBase):
    def __init__(self, tab, flow, thermo, wall_attrs=(), inlet_bcs=(),
                 tke_ic=1.0e-4, tdr_ic=1.0e-8,
                 Cmu=0.22, sigmaK=1.0, sigmaE=1.3, sigmaZ=1.2,
                 Ce2=1.9, C1=1.4, C2=0.3, Ct=6.0, Cl=0.23, Cn=70.0,
                 tke_min=1.0e-12, tdr_min=1.0e-12, zeta_min=1.0e-12,
                 v2_min=0.667e-12, tts_min=1.0e-12, tls_min=1.0e-12,
                 tts_max=100.0, tls_max=100.0, mut_min=1.0e-12,
                 pk_min=1.0e-14, cg_tol=1e-10, cg_maxiter=500):
        self.tab = tab
        self.flow = flow
        self.thermo = thermo
        self.c = dict(Cmu=Cmu, sigmaK=sigmaK, sigmaE=sigmaE, sigmaZ=sigmaZ,
                      Ce2=Ce2, C1=C1, C2=C2, Ct=Ct, Cl=Cl, Cn=Cn,
                      tke_min=tke_min, tdr_min=tdr_min, zeta_min=zeta_min,
                      v2_min=v2_min, tts_min=tts_min, tls_min=tls_min,
                      tts_max=tts_max, tls_max=tls_max, mut_min=mut_min,
                      pk_min=pk_min)
        self.cg_tol = cg_tol
        self.cg_maxiter = cg_maxiter
        self.info = {}

        nd = tab.ndofs
        self.k = full(tab, tke_ic, nd)
        self.eps = full(tab, tdr_ic, nd)
        self.v2 = full(tab, (2.0 / 3.0) * float(tke_ic), nd)
        self.f = full(tab, 0.0, nd)
        self.k_hist = [self.k.clone(), self.k.clone()]
        self.eps_hist = [self.eps.clone(), self.eps.clone()]
        self.v2_hist = [self.v2.clone(), self.v2.clone()]
        self._mut = full(tab, mut_min, nd)

        # wall dofs: k = v2 = f = 0; eps gets the wall value nu lap(k)
        free = np.ones(nd)
        if wall_attrs:
            free[h1.boundary_dofs(tab, tuple(wall_attrs))] = 0.0
        # inlet Dirichlet values: (attrs, k, eps[, v2]) tuples of scalars, or
        # of arrays over the patch's dofs (boundary_dofs order)
        k_free = np.array(free)
        kin, ein = np.zeros(nd), np.zeros(nd)
        for bc in inlet_bcs:
            dofs = h1.boundary_dofs(tab, tuple(bc[0]))
            k_free[dofs] = 0.0
            kin[dofs] = bc[1]
            ein[dofs] = bc[2]
        # v2 defaults to (2/3) k everywhere (seeded only after every k is
        # written); explicit v2 values override in a second pass
        v2in = (2.0 / 3.0) * kin
        for bc in inlet_bcs:
            if len(bc) > 3 and bc[3] is not None:
                v2in[h1.boundary_dofs(tab, tuple(bc[0]))] = bc[3]
        kw = {"dtype": tab.wq.dtype, "device": tab.wq.device}
        self.wall_mask = torch.as_tensor(free, **kw)
        self.dir_mask = torch.as_tensor(k_free, **kw)
        self.k_bc = torch.as_tensor(kin, **kw)
        self.eps_bc = torch.as_tensor(ein, **kw)
        self.v2_bc = torch.as_tensor(v2in, **kw)

    # -- interface ---------------------------------------------------------
    def eddy_viscosity(self):
        """Kinematic eddy viscosity nu_t (the flow adds rho * nu_t to mu)."""
        return self._mut / torch.clamp(self.thermo.density(), min=1e-300)

    @property
    def zeta(self):
        return self.v2 / torch.clamp(self.k, min=self.c["tke_min"])

    def step(self, coeff: TemporalCoefficients, dt: float, loops=None):
        out = self._step_impl(
            self.k, self.eps, self.v2, self.k_hist, self.eps_hist,
            self.v2_hist, self.flow.velocity(), self.thermo.density(),
            self.thermo.viscosity(), dt, coeff.order, loops)
        k, eps, v2, f, mut, self.info = out
        shift_history(self.k_hist, self.k)
        shift_history(self.eps_hist, self.eps)
        shift_history(self.v2_hist, self.v2)
        for buf, v in ((self.k, k), (self.eps, eps), (self.v2, v2),
                       (self.f, f), (self._mut, mut)):
            buf.copy_(v)

    # -- internals ---------------------------------------------------------
    def _scales(self, k, eps, v2, rho, mu, smag):
        c = self.c
        nu = mu / rho
        eps_c = torch.clamp(eps, min=c["tdr_min"])
        T1 = k / eps_c
        T2 = (0.6 / (np.sqrt(6.0) * c["Cmu"])) * k / (
            torch.clamp(smag, min=1e-14) * torch.clamp(v2, min=c["v2_min"]))
        T3 = c["Ct"] * torch.sqrt(torch.clamp(nu / eps_c, min=0.0))
        w = torch.tanh(TANH_HALF * T1 / torch.clamp(T3, min=1e-300))
        tts = torch.clamp(w * T1 + (1.0 - w) * T3, c["tts_min"], c["tts_max"])
        tts_strain = torch.clamp(T2, min=c["tts_min"])

        L1 = k**1.5 / eps_c
        L3 = c["Cn"] * (nu**3 / eps_c) ** 0.25
        w = torch.tanh(TANH_HALF * L1 / torch.clamp(L3, min=1e-300))
        tls = torch.clamp(c["Cl"] * (w * L1 + (1.0 - w) * L3),
                          min=c["tls_min"])
        w = torch.tanh(TANH_HALF * tls / c["tls_max"])
        tls = (1.0 - w) * tls + w * c["tls_max"]
        return tts, tts_strain, tls

    def _step_impl(self, k, eps, v2, k_hist, eps_hist, v2_hist, u, rho, mu,
                   dt, order, loops=None):
        tab = self.tab
        c = self.c
        coeff = TemporalCoefficients.bdf(order)
        bd = (coeff.bd0, coeff.bd1, coeff.bd2, coeff.bd3)
        Ml = tab.ml
        info = {}

        # velocity gradient and strain at dofs
        g = torch.stack(
            [h1.grad_at_dofs(tab, u[:, d]) for d in range(tab.dim)], dim=1
        )  # [nd, comp, dim]
        S = 0.5 * (g + g.transpose(1, 2))
        smag = torch.sqrt(2.0 * torch.einsum("nij,nij->n", S, S))
        divu = torch.diagonal(g, dim1=1, dim2=2).sum(-1)

        tts, tts_strain, tls = self._scales(k, eps, v2, rho, mu, smag)

        # eddy viscosity at the current state
        mut = c["Cmu"] * rho * torch.minimum(v2, (2.0 / 3.0) * k) \
            * torch.minimum(tts, tts_strain)
        mut = torch.clamp(mut, min=c["mut_min"])

        # production P_k = tau : grad(u), tau = 2 mut S - 2/3 (mut divu + rho k) I
        tau = 2.0 * mut[:, None, None] * S + torch.diag_embed(
            (-(2.0 / 3.0) * (mut * divu + rho * k))[:, None].expand(
                -1, tab.dim))
        prod = torch.clamp(torch.einsum("nij,nij->n", tau, g),
                           min=c["pk_min"])

        zeta = torch.clamp(v2 / torch.clamp(k, min=c["tke_min"]),
                           c["zeta_min"], 2.0 / 3.0)
        k_c = torch.clamp(k, min=c["tke_min"])
        eps_c = torch.clamp(eps, min=c["tdr_min"])

        def transport_solve(name, q, q_hist, sigma, src, react, mask,
                            bc_vals):
            """Implicit BDF advection-diffusion-reaction solve for q."""
            hist = -(bd[1] * q + bd[2] * q_hist[0] + bd[3] * q_hist[1]) / dt
            adv = h1.convection_apply(tab, q, u) / Ml
            rhs = h1.mass_apply(tab, rho * (hist - adv) + src)
            kdiff = mu + mut / sigma
            # zero the (positive) reaction coefficient on constrained rows:
            # its spike there (eps/k_min on the floored wall k) would leak
            # into free rows through the consistent mass and make the
            # operator indefinite
            react_c = torch.clamp(react, min=0.0) * mask

            def helm(v):
                return ((bd[0] / dt) * h1.mass_apply(tab, rho * v)
                        + h1.mass_apply(tab, react_c * v)
                        + h1.diffusion_apply(tab, v, kdiff))

            diag = ((bd[0] / dt) * h1.mass_lumped_diag(tab, rho)
                    + Ml * react_c
                    + h1.stiffness_diag(tab, kdiff))
            rhs = (rhs - helm(bc_vals * (1.0 - mask))) * mask
            diag = diag * mask + (1.0 - mask)
            out, info[name], _ = h1.cg_solve(
                helm, rhs, x0=q * mask, diag=diag, dirichlet_mask=mask,
                tol=self.cg_tol, maxiter=self.cg_maxiter, return_info=True,
                loops=loops)
            return out * mask + bc_vals * (1.0 - mask)

        # ---- k equation: destruction rho*eps treated as reaction rho/T1 ----
        k_new = transport_solve(
            "k_iters", k, k_hist, c["sigmaK"], prod, rho * eps_c / k_c,
            self.dir_mask, self.k_bc)
        k_new = torch.clamp(k_new, min=c["tke_min"])

        # ---- eps equation ----
        ce1 = torch.clamp(1.4 * (1.0 + 0.05 / torch.sqrt(zeta)),
                          1.4 * (1.0 + 0.05 * np.sqrt(1.5)), 1.55)
        # wall value: eps_wall = nu * lap(k) ~ nu * Minv(-K k)
        nu = mu / rho
        lap_k = -h1.diffusion_apply(tab, k_new, None) / Ml
        eps_wall = torch.clamp(nu * lap_k, min=c["tdr_min"])
        eps_bc = torch.where(self.wall_mask < 0.5, eps_wall, self.eps_bc)
        eps_new = transport_solve(
            "eps_iters", eps, eps_hist, c["sigmaE"], ce1 * prod / tts,
            rho * c["Ce2"] / tts, self.dir_mask, eps_bc)
        eps_new = torch.clamp(eps_new, min=c["tdr_min"])

        # ---- f elliptic relaxation:  (M/L^2 + K) f = M g / L^2 ----
        # g = [2/3 (C1-1) - (C1-6) zeta]/T + C2 P/(rho k)
        gsrc = ((2.0 / 3.0) * (c["C1"] - 1.0) - (c["C1"] - 6.0) * zeta) / tts \
            + c["C2"] * prod / (rho * k_c)
        L2 = torch.clamp(tls * tls, min=1e-300)

        def helm_f(v):
            return h1.mass_apply(tab, v / L2) + h1.diffusion_apply(tab, v, None)

        diag_f = h1.mass_lumped_diag(tab, 1.0 / L2) + h1.stiffness_diag(tab, None)
        mask = self.wall_mask
        rhs_f = h1.mass_apply(tab, gsrc / L2) * mask
        diag_f = diag_f * mask + (1.0 - mask)
        f_new, info["f_iters"], _ = h1.cg_solve(
            helm_f, rhs_f, x0=self.f * 0.0, diag=diag_f, dirichlet_mask=mask,
            tol=self.cg_tol, maxiter=self.cg_maxiter, return_info=True,
            loops=loops)
        f_new = f_new * mask  # f = 0 at walls

        # ---- v2 equation: production rho k f, destruction 6 rho eps zeta ----
        v2_new = transport_solve(
            "v2_iters", v2, v2_hist, c["sigmaZ"],
            rho * k_new * torch.clamp(f_new, min=0.0),
            6.0 * rho * eps_new / torch.clamp(k_new, min=c["tke_min"]),
            self.dir_mask, self.v2_bc)
        v2_new = torch.minimum(torch.clamp(v2_new, min=c["v2_min"]),
                               (2.0 / 3.0) * k_new)

        # ---- final eddy viscosity at n+1 ----
        tts, tts_strain, _ = self._scales(k_new, eps_new, v2_new, rho, mu,
                                          smag)
        mut_new = c["Cmu"] * rho * torch.minimum(v2_new, (2.0 / 3.0) * k_new) \
            * torch.minimum(tts, tts_strain)
        mut_new = torch.clamp(mut_new, min=c["mut_min"])
        return k_new, eps_new, v2_new, f_new, mut_new, info
