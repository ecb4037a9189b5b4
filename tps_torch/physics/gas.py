"""Equations of state as pure, batched functions on torch tensors.

The reference implements a polymorphic GasMixture hierarchy placement-new'ed
on the GPU (reference: src/equation_of_state.hpp:72, src/gpu_constructor.hpp);
here mixtures are lightweight frozen dataclasses whose methods work on
tensors with arbitrary leading axes.

State conventions (identical to the reference, src/equation_of_state.cpp:298-340):
  conserved  U  = [rho, rho*u (nvel), rho*E, rho*Y_s (active species), rho*e_e]
  primitive  Up = [rho, u (nvel), T  at index iTh=nvel+1, n_s ..., T_e]
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..constants import DRY_AIR_GAMMA, DRY_AIR_GAS_CONSTANT


@dataclass(frozen=True)
class DryAir:
    """Calorically perfect single-species gas.

    Mirrors reference DryAir (src/equation_of_state.cpp:146-372).
    """

    dim: int
    nvel: int
    gas_constant: float = DRY_AIR_GAS_CONSTANT
    specific_heat_ratio: float = DRY_AIR_GAMMA
    n_passive: int = 0  # extra passive-scalar equations (NS_PASSIVE)

    @property
    def num_equations(self) -> int:
        return self.nvel + 2 + self.n_passive

    @property
    def num_active_species(self) -> int:
        return self.n_passive

    @property
    def two_temperature(self) -> bool:
        return False

    @property
    def i_th(self) -> int:
        """Index of rho*E in conserved / temperature in primitive."""
        return self.nvel + 1

    # -- thermodynamics ----------------------------------------------------

    def pressure(self, U):
        """p from conserved state; U[..., neq]."""
        rho = U[..., 0]
        ke = 0.5 * torch.sum(U[..., 1 : 1 + self.nvel] ** 2, dim=-1) / rho
        return (self.specific_heat_ratio - 1.0) * (U[..., self.i_th] - ke)

    def temperature(self, U):
        return self.pressure(U) / (self.gas_constant * U[..., 0])

    def pressure_from_primitives(self, Up):
        return self.gas_constant * Up[..., 0] * Up[..., self.i_th]

    def sound_speed_from_T(self, T):
        return torch.sqrt(self.specific_heat_ratio * self.gas_constant * T)

    def pressure_derivative(self, dUp_dn, U):
        """Directional pressure derivative from primitive gradients along
        some direction (reference: DryAir::ComputePressureDerivative):
        dp/dn = R (T drho/dn + rho dT/dn)."""
        return self.gas_constant * (self.temperature(U) * dUp_dn[..., 0]
                                    + U[..., 0] * dUp_dn[..., self.i_th])

    def modify_energy_for_pressure(self, U, p, modify_electron_energy=False):
        """U with rhoE set so that its pressure is p (reference:
        DryAir::modifyEnergyForPressure, src/equation_of_state.cpp); a
        single-temperature gas ignores modify_electron_energy."""
        ke = 0.5 * torch.sum(U[..., 1 : 1 + self.nvel] ** 2, dim=-1) / U[..., 0]
        rhoE = p / (self.specific_heat_ratio - 1.0) + ke
        return torch.cat([U[..., : self.i_th], rhoE[..., None],
                          U[..., self.i_th + 1 :]], dim=-1)

    def max_char_speed(self, U):
        """|u| + c (reference: src/equation_of_state.cpp:278-292)."""
        rho = U[..., 0]
        v2 = torch.sum(U[..., 1 : 1 + self.nvel] ** 2, dim=-1) / (rho * rho)
        p = self.pressure(U)
        c = torch.sqrt(self.specific_heat_ratio * p / rho)
        return torch.sqrt(v2) + c

    # -- conversions -------------------------------------------------------

    def primitives(self, U):
        """Conserved -> primitive (reference: equation_of_state.cpp:321-340)."""
        rho = U[..., 0:1]
        vel = U[..., 1 : 1 + self.nvel] / rho
        T = self.temperature(U)[..., None]
        rest = U[..., self.nvel + 2 :] / rho  # passive scalars (mass fractions)
        return torch.cat([rho, vel, T, rest], dim=-1)

    def conservatives(self, Up):
        """Primitive -> conserved (reference: equation_of_state.cpp:298-315)."""
        rho = Up[..., 0:1]
        mom = rho * Up[..., 1 : 1 + self.nvel]
        v2 = torch.sum(Up[..., 1 : 1 + self.nvel] ** 2, dim=-1, keepdim=True)
        rhoE = (
            self.gas_constant * rho * Up[..., self.i_th : self.i_th + 1]
            / (self.specific_heat_ratio - 1.0)
            + 0.5 * rho * v2
        )
        rest = rho * Up[..., self.nvel + 2 :]
        return torch.cat([rho, mom, rhoE, rest], dim=-1)

    def total_energy(self, rho, vel, T):
        """rho*E from rho, velocity vector, temperature."""
        v2 = torch.sum(vel * vel, dim=-1)
        return rho * (self.gas_constant * T / (self.specific_heat_ratio - 1.0)
                      + 0.5 * v2)

    def conserved_from_convective_flux(self, mean_flux, normal):
        """Mixed-out conserved state [neq] whose convective normal flux is
        `mean_flux` [neq] along the unit `normal` (reference:
        DryAir::computeConservedStateFromConvectiveFlux,
        src/equation_of_state.cpp:414-443): the subsonic root of the
        quadratic for p, then the flux relations inverted; the azimuthal
        momentum (nvel > dim) carries no pressure, and a passive scalar's Y
        is its flux over the mass flux."""
        gamma = self.specific_heat_ratio
        mdot = mean_flux[0]
        mom_n = torch.sum(mean_flux[1 : 1 + self.dim] * normal[: self.dim])
        A = 1.0 - 2.0 * gamma / (gamma - 1.0)
        B = 2.0 * mom_n / (gamma - 1.0)
        C = -2.0 * mdot * mean_flux[self.i_th] + torch.sum(
            mean_flux[1 : 1 + self.nvel] ** 2)
        p = (-B - torch.sqrt(B * B - 4.0 * A * C)) / (2.0 * A)
        rho = mdot * mdot / (mom_n - p)
        n_full = torch.cat([normal[: self.dim],
                            torch.zeros(self.nvel - self.dim,
                                        dtype=mean_flux.dtype,
                                        device=mean_flux.device)])
        vel = (mean_flux[1 : 1 + self.nvel] - p * n_full) / mdot
        T = p / (self.gas_constant * rho)
        rest = mean_flux[self.nvel + 2 :] / mdot
        return self.conservatives(torch.cat([rho[None], vel, T[None], rest]))
