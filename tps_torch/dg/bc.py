"""Boundary conditions for the compressible DG solver, on torch tensors.

The JAX package's dg/bc.py, single device.  Each BC object owns a static
slice of the (attribute-sorted) boundary faces and produces the boundary
normal flux at its face quadrature points.  Mirrors reference behavior:
  walls:   src/wallBC.cpp:205-560 (inviscid mirror, viscous adiabatic,
           viscous isothermal via ghost states + one-sided viscous fluxes;
           the general wall VISC_GNRL with its species, electron-energy
           and sheath fluxes)
  inlets:  src/inletBC.cpp:729-756 (subsonic reflecting density-velocity,
           with species mass fractions on a mixture),
           :453-520 (face-based), the characteristic inlets :756-900
  outlets: src/outletBC.cpp:731-737 (subsonic reflecting pressure), the
           characteristic outlets :594-1010
  far field: a Riemann-invariant free-stream boundary (O-grid outer
           boundaries).

The stateless BCs are pointwise (`pointwise = True`): a face point's flux
depends on that point's data only, so the RHS may evaluate adjacent
patches of one and the same BC in one call.  The characteristic BCs
(`has_state = True`) carry a ghost state per boundary point that
`advance` integrates once a step from patch means; the solver keeps those
states in its step loop's buffers (solvers/step_graph.py).  Patch means
are device reductions: nothing here reads a value back to the host.

On a species mixture every BC goes through the mixture's BC helpers
(physics/perfect_mixture.py: modify_energy_for_pressure,
pressure_derivative, sound_speed_from_T), as in the JAX package; on the
LTE-table fluid through its own (physics/lte.py), the walls with the
table's background R and gamma at 300 K.  Not ported: the interpolated
inlet (ROADMAP A5.2).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..constants import PI, UNIVERSAL_GAS_CONSTANT


def _unit(nor):
    mag = torch.linalg.norm(nor, dim=-1, keepdim=True)
    return nor / mag, mag[..., 0]


def _tangent_frame(nhat):
    """Deterministic orthonormal tangents (t1, t2) for unit normals (the
    JAX package's choice: in 3-D the cross product with the cartesian axis
    least aligned with n at each point)."""
    if nhat.shape[-1] == 2:
        return torch.stack([-nhat[..., 1], nhat[..., 0]], dim=-1), None
    eye = torch.eye(3, dtype=nhat.dtype, device=nhat.device)
    ek = eye[torch.argmin(torch.abs(nhat), dim=-1)]
    t1 = torch.linalg.cross(ek, nhat, dim=-1)
    t1 = t1 / torch.linalg.norm(t1, dim=-1, keepdim=True)
    return t1, torch.linalg.cross(nhat, t1, dim=-1)


def _patch_mean(Up, wts):
    """Quadrature-weighted boundary-patch mean of per-point data [..., k]
    (the reference's per-patch subcommunicator means, src/mpi_groups.hpp:
    44-78): a device reduction, [k]."""
    num = torch.sum(wts[..., None] * Up, dim=tuple(range(Up.ndim - 1)))
    return num / torch.clamp(torch.sum(wts), min=1e-300)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _pad_vel(nhat, nvel):
    """Unit normals padded with zeros to nvel components."""
    if nvel == nhat.shape[-1]:
        return nhat
    pad = torch.zeros(nhat.shape[:-1] + (nvel - nhat.shape[-1],),
                      dtype=nhat.dtype, device=nhat.device)
    return torch.cat([nhat, pad], dim=-1)


def _with_rho_mom(U, rho, mom):
    """U with density rho [...] and momenta mom [..., nvel]."""
    nvel = mom.shape[-1]
    return torch.cat([rho[..., None], mom, U[..., 1 + nvel:]], dim=-1)


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

    input_state = (rho, u, v[, w], Y_1..Y_nactive)
    """

    input_state: tuple
    pointwise = True

    def ghost_primitive(self, mixture, UpL):
        return UpL

    def flux(self, ctx, UL, UpL, gradL, nor, xyz, delta, t, state=None, wts=None):
        mix = ctx.fluxes.mixture
        nvel = mix.nvel
        nact = getattr(mix, "num_active_species", 0)
        p = mix.pressure(UL)
        rho = self.input_state[0]

        def fill(v):
            # a Python float filled on the device: no host-to-device copy
            return torch.full_like(UL[..., :1], v)

        ghost = torch.cat(
            [fill(rho)] + [fill(rho * self.input_state[1 + d])
                           for d in range(nvel)]
            + [UL[..., 1 + nvel : 2 + nvel]]
            + [fill(self.input_state[1 + nvel + sp] * rho)
               for sp in range(nact)]
            + [UL[..., 2 + nvel + nact :]], dim=-1)
        # keep the interior pressure; on a mixture this rebuilds the
        # energies from the species' heats and formation energies
        ghost = mix.modify_energy_for_pressure(ghost, p)
        return ctx.riemann(UL, ghost, nor)


@dataclass(frozen=True)
class OutletBC:
    """Pressure outlet (reference: src/outletBC.cpp).

    kind = "subsonicPressure": reflecting ghost with target pressure and
    interior density/velocity (reference :731-737).  The solver maps the
    non-reflecting and mass-flow kinds to CharacteristicOutletBC, as the
    JAX package's solver does; the JAX OutletBC's stateless variants of
    them, which no deck reaches, are ROADMAP A5.2."""

    pressure: float = 0.0
    kind: str = "subsonicPressure"
    pointwise = True

    def __post_init__(self):
        if self.kind != "subsonicPressure":
            raise NotImplementedError(
                f"the '{self.kind}' outlet is not ported to tps_torch yet "
                "(ROADMAP A5.2)")

    def ghost_primitive(self, mixture, UpL):
        return UpL

    def flux(self, ctx, UL, UpL, gradL, nor, xyz, delta, t, state=None, wts=None):
        ghost = ctx.fluxes.mixture.modify_energy_for_pressure(UL, self.pressure)
        return ctx.riemann(UL, ghost, nor)


def _stress_dot_n(props, grad, nhat, dim):
    """(mu (grad u + grad u^T) + (bulk - 2/3 mu) div u I) . nhat."""
    visc = props["visc"]
    bulk = props["bulk_visc"] - (2.0 / 3.0) * visc
    grad_vel = grad[..., 1 : 1 + dim, :dim]
    div_v = torch.diagonal(grad_vel, dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(dim, dtype=grad.dtype, device=grad.device)
    stress = (visc[..., None, None] * (grad_vel + torch.transpose(grad_vel, -1, -2))
              + (bulk * div_v)[..., None, None] * eye)
    return torch.einsum("...ij,...j->...i", stress, nhat)


@dataclass(frozen=True)
class GeneralWallBC:
    """No-slip wall with independently prescribed heavy and electron
    thermal conditions (reference: WallType VISC_GNRL, src/wallBC.cpp:
    100-141,510-560).

    heavy:    "isothermal" | "adiabatic"
    electron: "isothermal" | "adiabatic" | "sheath"
    The sheath prescribes the Bohm outflow of positive ions, the
    current-balancing electron flux, a fully catalytic background influx
    and the sheath's electron energy flux (reference:
    PerfectMixture::computeSheathBdrFlux, src/equation_of_state.cpp:
    1909-1945)."""

    heavy: str = "isothermal"
    electron: str = "isothermal"
    wall_temp: float = 300.0
    wall_temp_e: float = 300.0
    pointwise = True

    def ghost_primitive(self, mixture, UpL):
        nvel, ith = mixture.nvel, mixture.i_th
        T = (torch.full_like(UpL[..., :1], self.wall_temp)
             if self.heavy == "isothermal" else UpL[..., ith : ith + 1])
        out = torch.cat([UpL[..., :1], torch.zeros_like(UpL[..., 1 : 1 + nvel]),
                         T, UpL[..., ith + 1 :]], dim=-1)
        if getattr(mixture, "two_temperature", False) \
                and self.electron == "isothermal":
            out = torch.cat([out[..., : mixture.i_te],
                             torch.full_like(UpL[..., :1], self.wall_temp_e)],
                            dim=-1)
        return out

    def _wall_state(self, mix, UL, UpL):
        """The no-slip wall state at the prescribed temperatures: (U, Up)."""
        Upw = self.ghost_primitive(mix, UpL)
        return mix.conservatives(Upw), Upw

    def _sheath_flux(self, mix, Uw, Upw):
        """The prescribed normal diffusion velocities [..., nsp] and the
        electron energy flux."""
        R = UNIVERSAL_GAS_CONSTANT
        _X, _Y, n_sp = mix.species_primitives(Uw)
        Th = Upw[..., mix.i_th]
        Te = Upw[..., mix.i_te] if mix.two_temperature else Th
        nsp = mix.num_species
        ie, ib = mix.i_electron, nsp - 1
        Vn = [torch.zeros_like(Th) for _ in range(nsp)]
        flux_e = torch.zeros_like(Th)  # sum Z n V_B
        mass_bg = torch.zeros_like(Th)  # -sum m n V_B
        for sp in range(nsp):
            z = mix.charges[sp]
            if z > 0.0:
                VB = torch.sqrt((Th + z * Te) * R / mix.mw[sp])
                Vn[sp] = VB
                flux_e = flux_e + z * n_sp[..., sp] * VB
                mass_bg = mass_bg - mix.mw[sp] * n_sp[..., sp] * VB
        ne = n_sp[..., ie] + 1e-100
        Vn[ie] = flux_e / ne
        mass_bg = mass_bg - mix.mw[ie] * ne * Vn[ie]
        Vn[ib] = mass_bg / (mix.mw[ib] * (n_sp[..., ib] + 1e-100))
        q_sheath = None
        if mix.two_temperature:
            vTe = torch.sqrt(8.0 * R * Te / PI / mix.mw[ie])
            gam = -torch.log(torch.clamp(4.0 / vTe * Vn[ie], min=1e-100))
            q_sheath = Vn[ie] * (gam + 2.0) * ne * R * Te
        return torch.stack(Vn, dim=-1), q_sheath

    def flux(self, ctx, UL, UpL, gradL, nor, xyz, delta, t, state=None, wts=None):
        mix = ctx.fluxes.mixture
        nhat, mag = _unit(nor)
        Uw, Upw = self._wall_state(mix, UL, UpL)
        flux = ctx.riemann(UL, Uw, nor)
        if ctx.fluxes.eq_system == "euler":
            return flux
        if getattr(mix, "num_active_species", 0) or getattr(
                mix, "two_temperature", False):
            fv_wall = self._wall_visc_general(ctx, Uw, Upw, gradL, nhat, xyz,
                                              delta)
        else:
            fv_wall = self._wall_visc_single(ctx, Uw, Upw, gradL, nhat)
        fv_in = _interior_visc_dot_n(ctx.fluxes, UL, UpL, gradL, nor, xyz, delta)
        return _sub_tail(flux, 0.5 * (fv_wall * mag[..., None] + fv_in))

    def _wall_visc_single(self, ctx, Uw, Upw, grad, nhat):
        """The one-sided wall viscous normal flux of a single-species gas."""
        mix = ctx.fluxes.mixture
        dim = mix.dim
        props = ctx.fluxes.transport.flux_properties(mix, Uw, Upw, grad)
        sn = _stress_dot_n(props, grad, nhat, dim)
        if self.heavy == "adiabatic":
            heat = torch.zeros_like(sn[..., 0])
        else:
            # -q_h with q_h = -kappa dT/dn (the wall is no-slip: sn . u = 0)
            heat = props["kappa"] * _dot(grad[..., mix.i_th, :], nhat)
        parts = [torch.zeros_like(heat[..., None]), sn]
        if mix.nvel > dim:
            parts.append(torch.zeros_like(Uw[..., 1 + dim : 1 + mix.nvel]))
        parts.append(heat[..., None])
        return torch.cat(parts, dim=-1)

    def _wall_visc_general(self, ctx, Uw, Upw, grad, nhat, xyz, delta):
        """The one-sided wall viscous normal flux with the prescribed
        primitive fluxes of a mixture (reference:
        Fluxes::ComputeBdrViscousFluxes)."""
        mix = ctx.fluxes.mixture
        dim, nvel, neq = mix.dim, mix.nvel, mix.num_equations
        nsp, nact, ie = mix.num_species, mix.num_active_species, mix.i_electron
        props = ctx.fluxes.transport.flux_properties(mix, Uw, Upw, grad)
        visc = props["visc"]
        sn = _stress_dot_n(props, grad, nhat, dim)
        # the prescribed species normal diffusion velocities
        if self.electron == "sheath":
            Vn, q_sheath = self._sheath_flux(mix, Uw, Upw)
        else:
            Vn = torch.zeros(Uw.shape[:-1] + (nsp,), dtype=Uw.dtype,
                             device=Uw.device)
            q_sheath = torch.zeros_like(visc)
        h_sp = mix.species_enthalpies(Uw)
        # heavy heat slot: -k dTh/dn + sum_{sp != e} h_sp Vn_sp
        if self.heavy == "adiabatic":
            q_h = torch.zeros_like(visc)
        else:
            q_h = -props["kappa"] * _dot(grad[..., mix.i_th, :], nhat)
            for sp in range(nsp):
                if mix.two_temperature and sp == ie:
                    continue
                q_h = q_h + h_sp[..., sp] * Vn[..., sp]
        # electron heat slot
        if not mix.two_temperature or self.electron == "adiabatic":
            q_e = torch.zeros_like(visc)
        elif self.electron == "isothermal":
            q_e = (-props["kappa_e"] * _dot(grad[..., neq - 1, :], nhat)
                   + h_sp[..., ie] * Vn[..., ie])
        else:  # sheath
            q_e = q_sheath
        # the wall state is no-slip: sn . u = 0
        parts = [torch.zeros_like(visc[..., None]), sn]
        if nvel > dim:
            parts.append(torch.zeros_like(Uw[..., 1 + dim : 1 + nvel]))
        parts.append((-q_h - q_e)[..., None])
        parts.append(-Uw[..., nvel + 2 : nvel + 2 + nact] * Vn[..., :nact])
        if mix.two_temperature:
            parts.append(-q_e[..., None])
        return torch.cat(parts, dim=-1)


@dataclass(frozen=True)
class FaceInletBC:
    """Face-relative subsonic density-velocity inlet (reference:
    subsonicReflectingDensityVelocityFace, src/inletBC.cpp:453-520; ini
    types subsonicFaceBasedX/Y/Z).

    input_state = (rho, U_normal, U_tangent): the injection velocity is
    U_normal along the inward face normal (orthogonalised against the
    chosen axis) plus U_tangent along n x e_axis, rotated into cartesian
    components as in the JAX package."""

    input_state: tuple
    tangent_axis: int = 2  # X=0 / Y=1 / Z=2 ini variants
    pointwise = True

    def ghost_primitive(self, mixture, UpL):
        return UpL

    def flux(self, ctx, UL, UpL, gradL, nor, xyz, delta, t, state=None, wts=None):
        mix = ctx.fluxes.mixture
        nvel, dim = mix.nvel, mix.dim
        p = mix.pressure(UL)
        rho, Un, Ut = self.input_state[:3]
        nhat, _ = _unit(nor)
        ax = self.tangent_axis % dim
        # the inward normal with its component along the axis removed
        n_in = torch.cat([-nhat[..., :ax], torch.zeros_like(nhat[..., :1]),
                          -nhat[..., ax + 1 :]], dim=-1)
        if dim == 3:
            e = torch.zeros_like(n_in)
            e[..., ax] = 1.0
            t1 = torch.linalg.cross(n_in, e, dim=-1)
        else:
            t1 = torch.stack([n_in[..., 1], -n_in[..., 0]], dim=-1)
        vel = Un * n_in + Ut * t1
        mom = rho * vel
        if nvel > dim:
            mom = torch.cat([mom, torch.zeros_like(UL[..., 1 + dim : 1 + nvel])], -1)
        ghost = _with_rho_mom(UL, torch.full_like(p, rho), mom)
        ghost = mix.modify_energy_for_pressure(ghost, p)
        return ctx.riemann(UL, ghost, nor)


@dataclass(frozen=True)
class NonReflectingInletBC:
    """Characteristic subsonic inlets without state (the JAX package's
    'nonreflecting' / 'nonreflectingConstEntropy' ghost form; reference
    SUB_DENS_VEL_NR / SUB_VEL_CONST_ENT, src/inletBC.cpp).

    The outgoing acoustic invariant R- = u_n - 2c/(gamma-1) is taken from
    the interior; density (or entropy) and velocity from the target state.
    input_state = (rho, u, v[, w]); rho is ignored for const-entropy."""

    input_state: tuple
    kind: str = "nonreflecting"  # | "nonreflectingConstEntropy"
    pointwise = True

    def ghost_primitive(self, mixture, UpL):
        return UpL

    def flux(self, ctx, UL, UpL, gradL, nor, xyz, delta, t, state=None, wts=None):
        mix = ctx.fluxes.mixture
        nvel, dim = mix.nvel, mix.dim
        gam = mix.specific_heat_ratio
        nhat, _ = _unit(nor)
        rho = UL[..., 0]
        vel = UL[..., 1 : 1 + nvel] / rho[..., None]
        p_in = mix.pressure(UL)
        c_in = torch.sqrt(gam * p_in / rho)
        Rminus = _dot(vel[..., :dim], nhat) - 2.0 * c_in / (gam - 1.0)
        vel_t = self.input_state[1 : 1 + nvel]
        un_t = sum(vel_t[d] * nhat[..., d] for d in range(dim))
        c_g = 0.5 * (gam - 1.0) * (un_t - Rminus)
        if self.kind == "nonreflectingConstEntropy":
            s_ent = p_in / rho**gam
            rho_g = (c_g * c_g / (gam * s_ent)) ** (1.0 / (gam - 1.0))
        else:
            rho_g = torch.full_like(rho, self.input_state[0])
        p_g = rho_g * c_g * c_g / gam
        mom = torch.stack([rho_g * v for v in vel_t], dim=-1)
        ghost = mix.modify_energy_for_pressure(_with_rho_mom(UL, rho_g, mom), p_g)
        return ctx.riemann(UL, ghost, nor)


@dataclass(frozen=True)
class FarFieldBC:
    """Characteristic (Riemann-invariant) far field with a full free-stream
    state: inflow or outflow is decided per quadrature point by the
    boundary normal velocity; entropy and tangential velocity come from
    the upwind side.  The O-grid's outer boundary (flow past a cylinder).

    input_state = (rho_inf, u_inf..., p_inf).  Exactly well balanced: at
    the free-stream state the ghost equals the interior."""

    input_state: tuple
    pointwise = True

    def ghost_primitive(self, mixture, UpL):
        return UpL

    def _ghost(self, mix, UL, nor):
        nvel, dim = mix.nvel, mix.dim
        gam = mix.specific_heat_ratio
        nhat, _ = _unit(nor)
        rho = UL[..., 0]
        vel = UL[..., 1 : 1 + nvel] / rho[..., None]
        p_in = mix.pressure(UL)
        c_in = torch.sqrt(gam * p_in / rho)
        un = _dot(vel[..., :dim], nhat)

        rho_inf = self.input_state[0]
        vel_inf = self.input_state[1 : 1 + nvel]
        p_inf = self.input_state[1 + nvel]
        c_inf = math.sqrt(gam * p_inf / rho_inf)
        un_inf = sum(vel_inf[d] * nhat[..., d] for d in range(dim))

        Rplus = un + 2.0 * c_in / (gam - 1.0)  # leaves through the boundary
        Rminus = un_inf - 2.0 * c_inf / (gam - 1.0)  # enters from far away
        un_b = 0.5 * (Rplus + Rminus)
        c_b = 0.25 * (gam - 1.0) * (Rplus - Rminus)
        outflow = un_b > 0.0
        s_in = p_in / rho**gam
        s_b = torch.where(outflow, s_in,
                          torch.full_like(s_in, p_inf / rho_inf**gam))
        rho_b = (c_b * c_b / (gam * s_b)) ** (1.0 / (gam - 1.0))
        p_b = rho_b * c_b * c_b / gam
        npad = _pad_vel(nhat, nvel)
        vt_in = vel - un[..., None] * npad
        vt_inf = torch.stack([vel_inf[d] - un_inf * npad[..., d]
                              for d in range(nvel)], dim=-1)
        vel_b = torch.where(outflow[..., None], vt_in, vt_inf) \
            + un_b[..., None] * npad
        ghost = _with_rho_mom(UL, rho_b, rho_b[..., None] * vel_b)
        return mix.modify_energy_for_pressure(ghost, p_b)

    def flux(self, ctx, UL, UpL, gradL, nor, xyz, delta, t, state=None, wts=None):
        return ctx.riemann(UL, self._ghost(ctx.fluxes.mixture, UL, nor), nor)


# ---------------------------------------------------------------------------
# Time-integrated nonreflecting characteristic BCs (LODI)
# ---------------------------------------------------------------------------
#
# The reference's nonreflecting inlets and outlets carry a ghost state per
# boundary point (`boundaryU`) integrated in time with characteristic (LODI)
# amplitudes built from patch-mean primitives (reference: src/outletBC.cpp:
# 594-1010, src/inletBC.cpp:756-900; means: src/mpi_groups.hpp:44-78).
# `flux()` evaluates Riemann(interior, carried ghost); `advance()` steps the
# ghost once per time step.  The solver keeps the ghosts in its step loop's
# static buffers, so a replayed step graph reads and writes them in place.


def _lodi_assemble(mean_rho, meanVn, meanVt1, meanVt2, meanK, gam,
                   d1, d2, d3, d4, d5, neq, nvel):
    """Characteristic flux vector in the (n, t1, t2) frame."""
    F = [d1, meanVn * d1 + mean_rho * d2, meanVt1 * d1 + mean_rho * d3]
    if nvel == 3:
        F.append(meanVt2 * d1 + mean_rho * d4)
    en = mean_rho * meanVn * d2 + mean_rho * meanVt1 * d3
    if nvel == 3:
        en = en + mean_rho * meanVt2 * d4
    F.append(en + meanK * d1 + d5 / (gam - 1.0))
    out = torch.stack([torch.broadcast_to(f, d1.shape) for f in F], dim=-1)
    if neq > nvel + 2:  # further slots (passive scalars): frozen
        out = torch.cat([out, torch.zeros(d1.shape + (neq - nvel - 2,),
                                          dtype=d1.dtype, device=d1.device)], -1)
    return out


def _lodi_integrate(state, bdrFlux, nhat, t1, t2, dt, nvel, dim):
    """rotate(state) - dt * bdrFlux, the momenta rotated back."""
    mom = state[..., 1 : 1 + nvel]
    momN = [_dot(mom[..., :dim], nhat), _dot(mom[..., :dim], t1)]
    if nvel == 3:
        momN.append(_dot(mom, t2) if dim == 3 else mom[..., 2])
    stateN = torch.cat([state[..., :1], torch.stack(momN, dim=-1),
                        state[..., 1 + nvel :]], dim=-1)
    newN = stateN - dt * bdrFlux
    mN = newN[..., 1 : 1 + nvel]
    mom_xy = mN[..., 0:1] * nhat + mN[..., 1:2] * t1
    if dim == 3:
        mom_xy = mom_xy + mN[..., 2:3] * t2
    parts = [newN[..., :1], mom_xy]
    if nvel == 3 and dim == 2:
        parts.append(mN[..., 2:3])
    parts.append(newN[..., 1 + nvel :])
    return torch.cat(parts, dim=-1)


def _mean_frame(mix, mean_up, nhat, t1, t2):
    """Patch-mean rho, velocity components along (n, t1, t2), kinetic
    energy and sound speed."""
    dim, nvel = mix.dim, mix.nvel
    mean_vel = mean_up[1 : 1 + nvel]
    meanVn = _dot(mean_vel[:dim], nhat)
    meanVt1 = _dot(mean_vel[:dim], t1)
    if dim == 3:
        meanVt2 = _dot(mean_vel, t2)
    else:
        meanVt2 = mean_vel[2] if nvel == 3 else 0.0
    return (mean_up[0], mean_vel, meanVn, meanVt1, meanVt2,
            0.5 * torch.sum(mean_vel * mean_vel),
            mix.sound_speed_from_T(mean_up[mix.i_th]))


@dataclass(frozen=True)
class CharacteristicOutletBC:
    """Time-integrated nonreflecting outlets (reference: OutletType
    SUB_P_NR / SUB_MF_NR / SUB_MF_NR_PW, src/outletBC.cpp:594-1010).

    kind = "nonReflectingPressure": the incoming wave relaxes the
    patch-mean pressure to `pressure` with strength sigma = c/ref_length;
    "nonReflectingMassFlow": the patch-mean normal velocity to
    mass_flow/(mean_rho * area); "nonReflectingPointBasedMassFlow": the
    same target, with the local normal velocity in the relaxation."""

    kind: str = "nonReflectingPressure"
    pressure: float = 0.0
    mass_flow: float = 0.0
    area: float = 1.0
    ref_length: float = 1.0

    has_state = True

    def ghost_primitive(self, mixture, UpL):
        return UpL

    def init_state(self, mix, UL0):
        """The ghost starts at the interior trace (reference: initBoundaryU)."""
        return UL0

    def flux(self, ctx, UL, UpL, gradL, nor, xyz, delta, t, state=None, wts=None):
        if state is None:
            # not integrated: reflecting ghost at the target pressure
            mix = ctx.fluxes.mixture
            state = mix.modify_energy_for_pressure(
                UL, self.pressure if self.kind == "nonReflectingPressure"
                else mix.pressure(UL))
        return ctx.riemann(UL, state, nor)

    def advance(self, ctx, state, UL, UpL, gradL, nor, wts, dt):
        mix = ctx.fluxes.mixture
        dim, nvel, neq = mix.dim, mix.nvel, mix.num_equations
        gam = mix.specific_heat_ratio
        nhat, _ = _unit(nor)
        t1, t2 = _tangent_frame(nhat)
        mean_up = _patch_mean(UpL, wts)
        (mean_rho, _mean_vel, meanVn, meanVt1, meanVt2, meanK,
         c) = _mean_frame(mix, mean_up, nhat, t1, t2)

        normGrad = torch.einsum("...ed,...d->...e", gradL, nhat)
        dpdn = mix.pressure_derivative(normGrad, UL)
        dvel = normGrad[..., 1 : 1 + dim]
        dVndn, dVt1dn = _dot(dvel, nhat), _dot(dvel, t1)
        dVt2dn = _dot(dvel, t2) if dim == 3 else torch.zeros_like(dpdn)

        # outgoing amplitudes, mean-frozen coefficients
        L2 = meanVn * (c * c * normGrad[..., 0] - dpdn)
        L3 = meanVn * dVt1dn
        L4 = meanVn * dVt2dn
        L5 = (meanVn + c) * (dpdn + mean_rho * c * dVndn)

        # the incoming wave relaxes toward the target
        sigma = c / self.ref_length
        if self.kind == "nonReflectingPressure":
            mean_p = mean_rho * mix.gas_constant * mean_up[mix.i_th]
            L1 = sigma * (mean_p - self.pressure) * torch.ones_like(dpdn)
        else:
            un_target = self.mass_flow / (mean_rho * self.area)
            if self.kind == "nonReflectingPointBasedMassFlow":
                un_pt = _dot(UpL[..., 1 : 1 + dim], nhat)
                L1 = -sigma * (un_pt - un_target) * mean_rho * c
            else:
                L1 = (-sigma * (meanVn - un_target) * mean_rho * c
                      ) * torch.ones_like(dpdn)

        d1 = (L2 + 0.5 * (L5 + L1)) / (c * c)
        d2 = 0.5 * (L5 - L1) / (mean_rho * c)
        bdrFlux = _lodi_assemble(mean_rho, meanVn, meanVt1, meanVt2, meanK,
                                 gam, d1, d2, L3, L4, 0.5 * (L5 + L1), neq,
                                 nvel)
        return _lodi_integrate(state, bdrFlux, nhat, t1, t2, dt, nvel, dim)


@dataclass(frozen=True)
class CharacteristicInletBC:
    """Time-integrated nonreflecting density-velocity inlet (reference:
    InletType SUB_DENS_VEL_NR / SUB_VEL_CONST_ENT, src/inletBC.cpp:
    756-900).  input_state = (rho_target, u, v[, w]); const_entropy drops
    the entropy relaxation.  The frame uses the inward unit normal, as the
    reference does."""

    input_state: tuple
    ref_length: float = 1.0
    const_entropy: bool = False

    has_state = True

    def ghost_primitive(self, mixture, UpL):
        return UpL

    def init_state(self, mix, UL0):
        return UL0

    def flux(self, ctx, UL, UpL, gradL, nor, xyz, delta, t, state=None, wts=None):
        return ctx.riemann(UL, UL if state is None else state, nor)

    def advance(self, ctx, state, UL, UpL, gradL, nor, wts, dt):
        mix = ctx.fluxes.mixture
        dim, nvel, neq = mix.dim, mix.nvel, mix.num_equations
        gam = mix.specific_heat_ratio
        n_out, _ = _unit(nor)
        nhat = -n_out  # inward
        t1, t2 = _tangent_frame(nhat)
        (mean_rho, mean_vel, meanVn, meanVt1, meanVt2, meanK,
         c) = _mean_frame(mix, _patch_mean(UpL, wts), nhat, t1, t2)
        target = self.input_state
        meanDV = torch.stack([mean_vel[d] - target[1 + d]
                              for d in range(nvel)])

        normGrad = torch.einsum("...ed,...d->...e", gradL, nhat)
        dpdn = mix.pressure_derivative(normGrad, UL)
        dVndn = _dot(normGrad[..., 1 : 1 + dim], nhat)

        # outgoing: leaves through the inlet against the flow
        L1 = (meanVn - c) * (dpdn - mean_rho * c * dVndn)
        sigma = c / self.ref_length
        dv_n = _dot(meanDV[:dim], nhat)
        dv_t1 = _dot(meanDV[:dim], t1)
        if dim == 3:
            dv_t2 = _dot(meanDV, t2)
        else:
            dv_t2 = meanDV[2] if nvel == 3 else torch.zeros_like(c)
        L5 = sigma * 2.0 * mean_rho * c * dv_n
        L3 = sigma * dv_t1
        L4 = sigma * dv_t2
        if self.const_entropy:
            L2 = torch.zeros_like(L1)
        else:
            L2 = (sigma * c * c * (mean_rho - target[0]) - 0.5 * L5
                  ) * torch.ones_like(L1)

        d1 = (L2 + 0.5 * (L5 + L1)) / (c * c)
        d2 = 0.5 * (L5 - L1) / (mean_rho * c)
        d3 = L3 * torch.ones_like(L1)
        d4 = L4 * torch.ones_like(L1)
        bdrFlux = _lodi_assemble(mean_rho, meanVn, meanVt1, meanVt2, meanK,
                                 gam, d1, d2, d3, d4, 0.5 * (L5 + L1), neq,
                                 nvel)
        return _lodi_integrate(state, bdrFlux, nhat, t1, t2, dt, nvel, dim)
