"""Pointwise convective and viscous flux evaluation on torch tensors.

Mirrors the behavior of reference Fluxes (src/fluxes.cpp:131-336), the
JAX package's dg/fluxes.py, for the branches this port carries: a
single-species gas (DryAir) or a species mixture (PerfectMixture: species
convection, the electron-energy flux, the electron heat flux, species
diffusion with its enthalpy fluxes), planar or axisymmetric (r, z) with
swirl (nvel = 3: the azimuthal momentum is advected and carries no
pressure; u_r/r in div u, the swirl stresses tau_tr, tau_tz and their
work), with the closures that change a point's transport coefficients
before the stress forms: the transport's own (the mixing length of
physics/transport.py, which reads the wall distance), then an SGS model
(dg/sgs.py), then the planar viscous sponge.  The "ns-passive" equation
system's passive scalars (DryAir(n_passive=k): rho Z convected, Fick
diffusion mu/Sc grad Z) are carried as a module, as in the JAX package:
no configuration builds them (solvers/compressible.py refuses such a
deck, ROADMAP C).  Everything here operates on tensors with
an arbitrary batch prefix; the equation index is the second-to-last axis
of flux tensors (F[..., eq, d]).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def _over_r(v, radius):
    """v / r where r > 0, else 0 (the JAX package's double where)."""
    pos = radius > 0
    return torch.where(pos, v / torch.where(pos, radius, 1.0), 0.0)


@dataclass(frozen=True)
class PlanarViscousSponge:
    """Planar viscosity-multiplier ramp (reference: src/fluxes.cpp:669-687
    viscSpongePlanar, ini section viscosityMultiplierFunction):
    wgt(x) = 1 + (ratio-1) * 0.5 (tanh(dist/width - 2) + 1) with dist the
    signed distance past the plane (point, normal)."""

    point: tuple
    normal: tuple
    width: float
    ratio: float

    def __call__(self, xyz):
        # the plane as device constants, made on the first call (a captured
        # step graph copies nothing from the host)
        dim = xyz.shape[-1]
        key = (xyz.dtype, xyz.device, dim)
        consts = self.__dict__.setdefault("_consts", {})
        if key not in consts:
            kw = {"dtype": xyz.dtype, "device": xyz.device}
            consts[key] = (torch.as_tensor(self.point[:dim], **kw),
                           torch.as_tensor(self.normal[:dim], **kw))
        p, n = consts[key]
        dist = torch.einsum("...d,d->...", xyz - p, n)
        w = 0.5 * (torch.tanh(dist / self.width - 2.0) + 1.0)
        return 1.0 + (max(self.ratio, 1.0) - 1.0) * w


@dataclass(frozen=True)
class Fluxes:
    mixture: object
    transport: object | None = None
    eq_system: str = "navier-stokes"  # "euler" | "navier-stokes" | "ns-passive"
    axisymmetric: bool = False
    sgs_model: object | None = None
    visc_sponge: object | None = None

    def __post_init__(self):
        if self.eq_system not in ("euler", "navier-stokes", "ns-passive"):
            raise ValueError(f"unknown equation system '{self.eq_system}'")

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
        # active species / passive scalars: rhoY * u_d
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

        axi = self.axisymmetric
        radius = xyz[..., 0] if axi else None
        props = self.transport.flux_properties(mix, U, Up, grad_up,
                                               distance=distance,
                                               radius=radius)
        visc = props["visc"]
        bulk = props["bulk_visc"] - (2.0 / 3.0) * visc
        kappa = props["kappa"]
        kappa_e = props["kappa_e"]
        dv = props.get("diff_vel")

        if self.sgs_model is not None and delta is not None:
            mu_sgs = self.sgs_model(U, grad_up, delta)
            pr_cp = visc / kappa
            bulk = bulk * (1.0 + mu_sgs / visc)
            visc = visc + mu_sgs
            kappa = kappa + mu_sgs / pr_cp

        if self.visc_sponge is not None and xyz is not None:
            # the viscous sponge multiplies every transport coefficient
            # (reference: src/fluxes.cpp:233-246)
            wgt = self.visc_sponge(xyz)
            visc, bulk = visc * wgt, bulk * wgt
            kappa, kappa_e = kappa * wgt, kappa_e * wgt
            if dv is not None:
                dv = dv * wgt[..., None, None]

        grad_vel = grad_up[..., 1 : 1 + dim, :dim]  # du_i/dx_j
        div_v = torch.diagonal(grad_vel, dim1=-2, dim2=-1).sum(-1)
        if axi:
            # u_r / r, 0 on the axis (where the face weights vanish)
            div_v = div_v + _over_r(Up[..., 1], radius)
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
        if axi:
            # the swirl row (tau_tr, tau_tz) and its work u_t tau_t
            # (reference: fluxes.cpp:285-297)
            ut = Up[..., 3]
            tau_t = visc[..., None] * torch.stack(
                [grad_up[..., 3, 0] - _over_r(ut, radius), grad_up[..., 3, 1]],
                dim=-1)
            parts.append(tau_t[..., None, :])
            tau_u = tau_u + ut[..., None] * tau_t
        nact = mix.num_active_species
        if mix.two_temperature:
            qe = kappa_e[..., None] * grad_up[..., neq - 1, :]
            Fe = tau_u + kappa[..., None] * gradT + qe
        else:
            Fe = tau_u + (kappa + kappa_e)[..., None] * gradT
        if dv is None:
            parts.append(Fe[..., None, :])
            if nact and self.eq_system == "ns-passive":
                # passive scalars: Fick diffusion mu/Sc grad(Z)
                Sc = getattr(self.transport, "Sc", 0.71)
                parts.append((visc / Sc)[..., None, None]
                             * grad_up[..., nvel + 2 : nvel + 2 + nact, :dim])
            elif nact:
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
