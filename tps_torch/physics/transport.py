"""Molecular transport models (viscosity, conductivity, diffusion).

Mirrors the behavior of the reference TransportProperties hierarchy
(reference: src/transport_properties.hpp:52-311) as pure batched functions
on torch tensors.  Each model returns a dict with keys:
  visc       dynamic viscosity mu
  bulk_visc  bulk viscosity (before the -2/3 mu Stokes correction)
  kappa      heavy-species thermal conductivity
  kappa_e    electron thermal conductivity (0 for neutral gases)
  diff_vel   species diffusion velocities [..., nspecies, dim] (or None)
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ConstantTransport:
    """Fixed transport coefficients (reference: transport_properties.hpp:275)."""

    visc: float
    bulk_visc: float
    kappa: float
    kappa_e: float = 0.0

    def flux_properties(self, mixture, U, Up, grad_up, **kw):
        shape = U.shape[:-1]
        kw = {"dtype": U.dtype, "device": U.device}
        return {
            "visc": torch.full(shape, self.visc, **kw),
            "bulk_visc": torch.full(shape, self.bulk_visc, **kw),
            "kappa": torch.full(shape, self.kappa, **kw),
            "kappa_e": torch.full(shape, self.kappa_e, **kw),
            "diff_vel": None,
        }


@dataclass(frozen=True)
class DryAirTransport:
    """Sutherland-law air transport (reference: transport_properties.hpp:227-273).

    mu = C1 * T^1.5 / (T + S0); k = cp/Pr * mu; bulk viscosity via multiplier.
    """

    gas_constant: float
    specific_heat_ratio: float
    visc_mult: float = 1.0
    bulk_visc_mult: float = 0.0
    C1: float = 1.458e-6
    S0: float = 110.4
    Pr: float = 0.71
    Sc: float = 0.71

    def viscosity(self, T):
        return self.C1 * self.visc_mult * T**1.5 / (T + self.S0)

    def flux_properties(self, mixture, U, Up, grad_up, **kw):
        T = Up[..., mixture.i_th]
        mu = self.viscosity(T)
        cp = self.specific_heat_ratio * self.gas_constant / (self.specific_heat_ratio - 1.0)
        kappa = cp / self.Pr * mu
        return {
            "visc": mu,
            "bulk_visc": self.bulk_visc_mult * mu,
            "kappa": kappa,
            "kappa_e": torch.zeros_like(mu),
            "diff_vel": None,
        }


def _over_r(v, radius):
    """v / r where r > 0, else 0 (the JAX package's double where)."""
    pos = radius > 0
    return torch.where(pos, v / torch.where(pos, radius, 1.0), 0.0)


@dataclass(frozen=True, eq=False)
class MixingLengthTransport:
    """Algebraic mixing-length RANS closure wrapping a molecular transport
    (reference: src/mixing_length_transport.cpp:66-135):
      mu_t = rho * min(0.41 d_wall, max_mixing_length)^2 * |S|
      kappa_t = mu_t * (cp/Pr) * Prt ; bulk += bulk_mult * mu_t
    with cp/Pr the molecular kappa / visc.  `distance` is the wall
    distance at the evaluation points; without it (the geometric source,
    the boundary faces) the molecular values come back unchanged."""

    molecular: object
    max_mixing_length: float
    Prt: float = 0.91
    bulk_mult: float = 0.0

    def flux_properties(self, mixture, U, Up, grad_up, distance=None,
                        radius=None, **kw):
        props = dict(self.molecular.flux_properties(mixture, U, Up, grad_up))
        if distance is None or grad_up is None:
            return props
        dim = mixture.dim
        gv = grad_up[..., 1:1 + dim, :dim]
        S = 0.5 * (gv + torch.transpose(gv, -1, -2))
        S2 = 2.0 * torch.sum(S * S, dim=(-2, -1))
        if mixture.nvel != dim and radius is not None:
            # the axisymmetric swirl strain (reference:
            # src/mixing_length_transport.cpp:103-117)
            Szx = 0.5 * (grad_up[..., 3, 0] - _over_r(Up[..., 3], radius))
            Szy = 0.5 * grad_up[..., 3, 1]
            Szz = _over_r(Up[..., 1], radius)
            S2 = S2 + 2.0 * (2.0 * Szx**2 + 2.0 * Szy**2 + Szz**2)
        lmix = torch.clamp(0.41 * distance, max=self.max_mixing_length)
        mut = U[..., 0] * lmix * lmix * torch.sqrt(S2)
        cp_over_pr = props["kappa"] / props["visc"]
        props["visc"] = props["visc"] + mut
        props["bulk_visc"] = props["bulk_visc"] + self.bulk_mult * mut
        props["kappa"] = props["kappa"] + mut * cp_over_pr * self.Prt
        return props

    def source_properties(self, U, Up, grad_up, efield=None):
        """The source terms' transport is the molecular one (reference:
        MixingLengthTransport::ComputeSourceTransportProperties,
        src/mixing_length_transport.cpp:159-164)."""
        return self.molecular.source_properties(U, Up, grad_up, efield=efield)
