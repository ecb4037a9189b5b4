"""Pointwise convective and viscous flux evaluation on torch tensors.

Mirrors the behavior of reference Fluxes (src/fluxes.cpp:131-336), the
JAX package's dg/fluxes.py, for the branches this port carries: a
single-species gas (DryAir) or a species mixture (PerfectMixture: species
convection, the electron-energy flux, the electron heat flux, species
diffusion with its enthalpy fluxes), planar geometry, no SGS model and
no viscous sponge.  Every other branch raises NotImplementedError naming
the ROADMAP item that ports it.  Everything here operates on tensors with
an arbitrary batch prefix; the equation index is the second-to-last axis
of flux tensors (F[..., eq, d]).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Fluxes:
    mixture: object
    transport: object | None = None
    eq_system: str = "navier-stokes"  # "euler" | "navier-stokes"
    axisymmetric: bool = False
    sgs_model: object | None = None
    visc_sponge: object | None = None

    def __post_init__(self):
        if self.axisymmetric:
            raise NotImplementedError(
                "axisymmetric fluxes are not ported yet (ROADMAP A5)")
        if self.sgs_model is not None:
            raise NotImplementedError(
                "SGS models are not ported yet (ROADMAP A5, dg/sgs.py)")
        if self.visc_sponge is not None:
            raise NotImplementedError(
                "the viscous sponge is not ported yet (ROADMAP A5)")
        if self.eq_system not in ("euler", "navier-stokes"):
            raise NotImplementedError(
                f"equation system '{self.eq_system}' is not ported yet "
                "(ROADMAP A6.2)")
        if getattr(self.mixture, "n_passive", 0):
            raise NotImplementedError(
                "passive scalars are not ported yet (ROADMAP A6.2)")

    @property
    def dim(self):
        return self.mixture.dim

    @property
    def nvel(self):
        return self.mixture.nvel

    @property
    def neq(self):
        return self.mixture.num_equations

    # -- convective --------------------------------------------------------

    def convective(self, U):
        """F_conv[..., neq, dim] (reference: src/fluxes.cpp:135-171)."""
        mix = self.mixture
        dim, nvel, neq = self.dim, self.nvel, self.neq
        p = mix.pressure(U)
        rho = U[..., 0]
        mom = U[..., 1 : 1 + nvel]  # [..., nvel]
        vel_d = mom[..., :dim] / rho[..., None]  # [..., dim]
        # momentum: rho u_i u_d + p delta_{id}
        eye = torch.eye(nvel, dim, dtype=U.dtype, device=U.device)
        Fm = mom[..., :, None] * vel_d[..., None, :] + p[..., None, None] * eye
        # energy: u_d * (rhoE + p)
        Fe = vel_d * (U[..., mix.i_th] + p)[..., None]
        parts = [mom[..., None, :dim], Fm, Fe[..., None, :]]
        # active species: rhoY * u_d
        nact = mix.num_active_species
        if nact > 0:
            rhoY = U[..., nvel + 2 : nvel + 2 + nact]
            parts.append(rhoY[..., :, None] * vel_d[..., None, :])
        if mix.two_temperature:
            # electron energy: (rho e_e + p_e) / rho * rho u_d
            pe = mix.electron_pressure(U)
            he = (U[..., neq - 1] + pe) / rho
            parts.append((he[..., None] * mom[..., :dim])[..., None, :])
        return torch.cat(parts, dim=-2)

    # -- viscous -----------------------------------------------------------

    def viscous(self, U, Up, grad_up, xyz=None, delta=None, distance=None):
        """F_visc[..., neq, dim] (reference: src/fluxes.cpp:173-336).

        grad_up[..., neq, dim] is the gradient of primitives.  The viscous
        flux is defined so the total flux is F_conv - F_visc.
        """
        mix = self.mixture
        dim, nvel, neq = self.dim, self.nvel, self.neq
        if self.eq_system == "euler":
            return torch.zeros(U.shape[:-1] + (neq, dim), dtype=U.dtype,
                               device=U.device)

        props = self.transport.flux_properties(mix, U, Up, grad_up)
        visc = props["visc"]
        bulk = props["bulk_visc"] - (2.0 / 3.0) * visc
        kappa = props["kappa"]
        kappa_e = props["kappa_e"]

        grad_vel = grad_up[..., 1 : 1 + dim, :dim]  # du_i/dx_j
        div_v = torch.diagonal(grad_vel, dim1=-2, dim2=-1).sum(-1)
        eye = torch.eye(dim, dtype=U.dtype, device=U.device)
        stress = (visc[..., None, None]
                  * (grad_vel + torch.transpose(grad_vel, -1, -2))
                  + (bulk * div_v)[..., None, None] * eye)

        # energy flux: tau . u + kappa grad(T) (+ electron heat flux)
        vel = Up[..., 1 : 1 + dim]
        tau_u = torch.einsum("...ij,...j->...i", stress, vel)
        gradT = grad_up[..., mix.i_th, :]
        zero = torch.zeros_like(tau_u)
        parts = [zero[..., None, :], stress]
        nact = mix.num_active_species
        dv = props.get("diff_vel")
        if mix.two_temperature:
            qe = kappa_e[..., None] * grad_up[..., neq - 1, :]
            Fe = tau_u + kappa[..., None] * gradT + qe
        else:
            Fe = tau_u + (kappa + kappa_e)[..., None] * gradT
        if dv is None:
            parts.append(Fe[..., None, :])
            if nact:
                parts.append(torch.zeros(U.shape[:-1] + (nact, dim),
                                         dtype=U.dtype, device=U.device))
            if mix.two_temperature:
                parts.append(qe[..., None, :])
            return torch.cat(parts, dim=-2)

        # species diffusion fluxes: -rhoY_s * V_s, and the enthalpy they
        # carry
        rhoY = U[..., nvel + 2 : nvel + 2 + nact]
        h_sp = mix.species_enthalpies(U)
        Fe = Fe - torch.einsum("...s,...sd->...d", h_sp, dv[..., :dim])
        parts += [Fe[..., None, :], -rhoY[..., None] * dv[..., :nact, :dim]]
        if mix.two_temperature:
            # the electron-energy equation also transports electron
            # enthalpy with the electron diffusion velocity (reference:
            # src/fluxes.cpp:250-252; the JAX package's round-5 fix)
            ie = mix.i_electron
            parts.append((qe - h_sp[..., ie, None] * dv[..., ie, :dim])
                         [..., None, :])
        return torch.cat(parts, dim=-2)

    def total_at_dofs(self, U, Up, grad_up, xyz, delta, distance=None):
        """F_conv - F_visc at solution nodes (reference: rhs_operator.cpp:532-541)."""
        F = self.convective(U)
        if self.eq_system != "euler":
            F = F - self.viscous(U, Up, grad_up, xyz=xyz, delta=delta,
                                 distance=distance)
        return F
