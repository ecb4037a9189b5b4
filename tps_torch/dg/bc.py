"""Boundary conditions for the compressible DG solver, on torch tensors.

The JAX package's dg/bc.py for the boundary conditions of this slice.
Each BC object owns a static slice of the (attribute-sorted) boundary
faces and produces the boundary normal flux at its face quadrature points.
Mirrors reference behavior:
  walls:   src/wallBC.cpp:205-560 (inviscid mirror, viscous adiabatic,
           viscous isothermal via ghost states + one-sided viscous fluxes)
  inlets:  src/inletBC.cpp:729-756 (subsonic reflecting density-velocity)
  outlets: src/outletBC.cpp:731-737 (subsonic reflecting pressure)

Each of these BCs is pointwise (`pointwise = True`): a face point's flux
depends on that point's data only, so the RHS may evaluate adjacent
patches of one and the same BC in one call.

The general multi-species wall, the face-based, interpolated and
characteristic inlets, the far field and the non-reflecting outlets are
ROADMAP A5: `OutletBC` raises for every kind but "subsonicPressure".
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def _unit(nor):
    mag = torch.linalg.norm(nor, dim=-1, keepdim=True)
    return nor / mag, mag[..., 0]


def _interior_visc_dot_n(fluxes, U, Up, grad, nor, xyz, delta):
    Fv = fluxes.viscous(U, Up, grad, xyz=xyz, delta=delta)
    return torch.einsum("...ed,...d->...e", Fv, nor)


def _set_momentum(U, mom, nvel):
    """U with rho*u replaced by mom [..., nvel]."""
    return torch.cat([U[..., :1], mom, U[..., 1 + nvel :]], dim=-1)


def _sub_tail(flux, corr):
    """flux - corr on equations 1.. (the viscous correction)."""
    return torch.cat([flux[..., :1], flux[..., 1:] - corr[..., 1:]], dim=-1)


@dataclass(frozen=True)
class WallBC:
    """Wall boundary (reference: src/wallBC.cpp)."""

    kind: str  # "inviscid" | "slip" | "viscous_adiabatic" | "viscous_isothermal"
    wall_temp: float = 0.0
    pointwise = True

    def ghost_primitive(self, mixture, UpL):
        """Exterior primitive state for the gradient operator (useBCinGrad)."""
        if self.kind == "viscous_isothermal":
            nvel = mixture.nvel
            return torch.cat([UpL[..., :1], torch.zeros_like(UpL[..., 1 : 1 + nvel]),
                              torch.full_like(UpL[..., :1], self.wall_temp),
                              UpL[..., 2 + nvel :]], dim=-1)
        return UpL

    def flux(self, ctx, UL, UpL, gradL, nor, xyz, delta, t, state=None, wts=None):
        mix = ctx.fluxes.mixture
        nvel = mix.nvel
        dim = mix.dim
        nhat, mag = _unit(nor)

        if self.kind in ("inviscid", "slip"):
            vel = UL[..., 1 : 1 + nvel] / UL[..., 0:1]
            vn = torch.einsum("...d,...d->...", vel[..., :dim], nhat)
            mirr_vel = torch.cat(
                [vel[..., :dim] + (-2.0 * vn[..., None]) * nhat, vel[..., dim:]],
                dim=-1)
            ghost = _set_momentum(UL, UL[..., 0:1] * mirr_vel, nvel)
            flux = ctx.riemann(UL, ghost, nor)
            if ctx.fluxes.eq_system != "euler" and self.kind == "inviscid":
                # reference computeINVwallFlux also averages one-sided viscous
                # fluxes of interior and mirror states with the same gradient
                fv_in = _interior_visc_dot_n(ctx.fluxes, UL, UpL, gradL, nor, xyz, delta)
                Upm = mix.primitives(ghost)
                fv_m = _interior_visc_dot_n(ctx.fluxes, ghost, Upm, gradL, nor, xyz, delta)
                flux = _sub_tail(flux, 0.5 * (fv_in + fv_m))
            return flux

        if self.kind == "viscous_adiabatic":
            # stagnation ghost state (same internal energy)
            ke = 0.5 * torch.sum(UL[..., 1 : 1 + nvel] ** 2, dim=-1) / UL[..., 0]
            ghost = _set_momentum(UL, torch.zeros_like(UL[..., 1 : 1 + nvel]), nvel)
            ghost = torch.cat([ghost[..., : mix.i_th],
                               (UL[..., mix.i_th] - ke)[..., None],
                               ghost[..., mix.i_th + 1 :]], dim=-1)
            flux = ctx.riemann(UL, ghost, nor)
            # wall viscous flux: stress from interior grad, zero heat flux,
            # energy advected with INTERIOR velocity (reference wallBC.cpp:430-470
            # -> fluxes.cpp ComputeBdrViscousFluxes with vel0 = interior vel)
            fv_wall = self._wall_visc(ctx, ghost, mix.primitives(ghost), gradL, nhat,
                                      heat_on=False,
                                      vel0=UL[..., 1 : 1 + dim] / UL[..., 0:1])
            fv_in = _interior_visc_dot_n(ctx.fluxes, UL, UpL, gradL, nor, xyz, delta)
            return _sub_tail(flux, 0.5 * (fv_wall * mag[..., None] + fv_in))

        if self.kind == "viscous_isothermal":
            rho = UL[..., 0]
            e_wall = (mix.gas_constant / (mix.specific_heat_ratio - 1.0)
                      * rho * self.wall_temp)
            ghost = _set_momentum(UL, torch.zeros_like(UL[..., 1 : 1 + nvel]), nvel)
            ghost = torch.cat([ghost[..., : mix.i_th], e_wall[..., None],
                               ghost[..., mix.i_th + 1 :]], dim=-1)
            flux = ctx.riemann(UL, ghost, nor)
            fv_wall = self._wall_visc(ctx, ghost, mix.primitives(ghost), gradL, nhat,
                                      heat_on=True,
                                      vel0=torch.zeros_like(UL[..., 1 : 1 + dim]))
            fv_in = _interior_visc_dot_n(ctx.fluxes, UL, UpL, gradL, nor, xyz, delta)
            return _sub_tail(flux, 0.5 * (fv_wall * mag[..., None] + fv_in))

        raise ValueError(f"unknown wall kind: {self.kind}")

    def _wall_visc(self, ctx, Uw, Upw, grad, nhat, heat_on, vel0):
        """One-sided wall viscous normal flux (unit normal), conservative form.

        Mirrors Fluxes::ComputeBdrViscousFluxes (src/fluxes.cpp) for
        single-temperature mixtures."""
        mix = ctx.fluxes.mixture
        dim = mix.dim
        props = ctx.fluxes.transport.flux_properties(mix, Uw, Upw, grad)
        visc = props["visc"]
        bulk = props["bulk_visc"] - (2.0 / 3.0) * visc
        kappa = props["kappa"] + props["kappa_e"]

        grad_vel = grad[..., 1 : 1 + dim, :dim]
        div_v = torch.diagonal(grad_vel, dim1=-2, dim2=-1).sum(-1)
        eye = torch.eye(dim, dtype=Uw.dtype, device=Uw.device)
        stress = (visc[..., None, None] * (grad_vel + torch.transpose(grad_vel, -1, -2))
                  + (bulk * div_v)[..., None, None] * eye)
        sn = torch.einsum("...ij,...j->...i", stress, nhat)

        e_flux = torch.einsum("...d,...d->...", sn, vel0)
        if heat_on:
            gradT = grad[..., mix.i_th, :]
            # normalPrimFlux heat slot = -k dT/dn; energy -= that slot
            e_flux = e_flux + kappa * torch.einsum("...d,...d->...", gradT, nhat)
        neq = mix.num_equations
        zero = torch.zeros_like(Uw[..., :1])
        parts = [zero, sn]
        if mix.nvel > dim:
            parts.append(torch.zeros_like(Uw[..., 1 + dim : 1 + mix.nvel]))
        parts.append(e_flux[..., None])
        if neq > mix.i_th + 1:
            parts.append(torch.zeros_like(Uw[..., mix.i_th + 1 :]))
        return torch.cat(parts, dim=-1)


@dataclass(frozen=True)
class InletBC:
    """Subsonic reflecting density-velocity inlet (src/inletBC.cpp:729-756).

    input_state = (rho, u, v[, w])
    """

    input_state: tuple
    pointwise = True

    def ghost_primitive(self, mixture, UpL):
        return UpL

    def flux(self, ctx, UL, UpL, gradL, nor, xyz, delta, t, state=None, wts=None):
        mix = ctx.fluxes.mixture
        nvel = mix.nvel
        if mix.num_active_species:
            raise NotImplementedError("multi-species inlets are not ported "
                                      "to tps_torch yet (ROADMAP A6)")
        p = mix.pressure(UL)
        rho = self.input_state[0]
        # Python floats filled on the device: no host-to-device copy per call
        ghost = torch.cat([torch.full_like(UL[..., :1], rho)]
                          + [torch.full_like(UL[..., :1], rho * self.input_state[1 + d])
                             for d in range(nvel)]
                          + [UL[..., 1 + nvel :]], dim=-1)
        # keep the interior pressure
        ghost = mix.modify_energy_for_pressure(ghost, p)
        return ctx.riemann(UL, ghost, nor)


@dataclass(frozen=True)
class OutletBC:
    """Pressure outlet (reference: src/outletBC.cpp).

    kind = "subsonicPressure": reflecting ghost with target pressure and
    interior density/velocity (reference :731-737).  The non-reflecting
    and mass-flow kinds are ROADMAP A5."""

    pressure: float = 0.0
    kind: str = "subsonicPressure"
    pointwise = True

    def __post_init__(self):
        if self.kind != "subsonicPressure":
            raise NotImplementedError(
                f"the '{self.kind}' outlet is not ported to tps_torch yet "
                "(ROADMAP A5)")

    def ghost_primitive(self, mixture, UpL):
        return UpL

    def flux(self, ctx, UL, UpL, gradL, nor, xyz, delta, t, state=None, wts=None):
        ghost = ctx.fluxes.mixture.modify_energy_for_pressure(UL, self.pressure)
        return ctx.riemann(UL, ghost, nor)
