"""Multi-species two-temperature perfect-gas mixture EOS on torch tensors.

The JAX package's physics/perfect_mixture.py (PerfectMixture,
tps_tpu/physics/perfect_mixture.py:31-529), method by method with the
same formulas (reference: src/equation_of_state.cpp:473-1750).

Species ordering convention (identical to the reference,
SetSpeciesStateIndices src/equation_of_state.hpp:137-146):
  mixture species [0 .. nsp-1] = [ions/neutrals ..., electron, background]
  iElectron = nsp-2, iBackground = nsp-1
  active species = first (nsp-1) (non-ambipolar: includes electron)
                 or first (nsp-2) (ambipolar: electron from quasineutrality)
State layout:
  U  = [rho, rho*u (nvel), rho*E, rho_s = MW_s n_s (active), rho*e_e (2T)]
  Up = [rho, u (nvel), T_h, n_s (active number densities), T_e (2T)]

Not here: the BC helpers (pressure_derivative,
conserved_from_convective_flux, stagnant_state_with_temp,
modify_energy_for_pressure) wait for the mixture BCs (ROADMAP A6.2) and
raise; the LTE initialisation (saha_ionization_fraction, species_from_lte,
state_from_lte) is ROADMAP A6.4.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import UNIVERSAL_GAS_CONSTANT

_R = UNIVERSAL_GAS_CONSTANT
_TINY = 1.0e-30


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported to tps_torch yet "
                               f"(ROADMAP {item})")


@dataclass(frozen=True, eq=False)
class PerfectMixture:
    dim: int
    nvel: int
    # per-species parameters in mixture ordering (tuple of floats)
    mw: tuple  # molar mass [kg/mol]
    charges: tuple  # signed charge numbers
    formation_energy: tuple  # [J/mol]
    molar_cv_over_R: tuple  # molar CV / R (e.g. 1.5 monatomic)
    ambipolar: bool = False
    two_temperature: bool = False
    const_plasma_conductivity: float = 0.0
    # per-species lumped level degeneracy (the LTE initialisation's); None
    # -> all 1
    degeneracy: tuple | None = None

    def __post_init__(self):
        assert self.num_species >= 2, "need at least electron + background"
        assert self.charges[self.i_background] == 0.0, "background must be neutral"
        assert self.formation_energy[self.i_electron] == 0.0
        assert self.formation_energy[self.i_background] == 0.0

    # -- sizes & indices ---------------------------------------------------
    @property
    def num_species(self) -> int:
        return len(self.mw)

    @property
    def i_electron(self) -> int:
        return self.num_species - 2

    @property
    def i_background(self) -> int:
        return self.num_species - 1

    @property
    def num_active_species(self) -> int:
        return self.num_species - (2 if self.ambipolar else 1)

    @property
    def num_equations(self) -> int:
        return (self.nvel + 2 + self.num_active_species
                + (1 if self.two_temperature else 0))

    @property
    def i_th(self) -> int:
        return self.nvel + 1

    @property
    def i_te(self) -> int:
        return self.num_equations - 1

    # -- parameter vectors -------------------------------------------------
    def _arr(self, values, like):
        """The numbers `values` as a tensor of like's dtype and device, made
        once per (values, dtype, device) and kept on the mixture: a copy
        from the host inside a captured step graph would raise, so every
        step after the first reuses the first step's tensor."""
        cache = self.__dict__.setdefault("_const_cache", {})
        a = np.asarray(values, dtype=np.float64)
        key = (a.shape, a.tobytes(), like.dtype, like.device)
        if key not in cache:
            cache[key] = torch.as_tensor(a, dtype=like.dtype,
                                         device=like.device)
        return cache[key]

    def molar_cv(self, like):
        return self._arr(self.molar_cv_over_R, like) * _R

    def molar_cp(self, like):
        return self.molar_cv(like) + _R

    def _heavy_mask(self, like):
        mask = np.ones(self.num_species)
        mask[self.i_electron] = 0.0
        return self._arr(mask, like)

    @property
    def gas_constant(self):
        """Background-species specific gas constant (GetGasConstant)."""
        return _R / self.mw[self.i_background]

    @property
    def specific_heat_ratio(self):
        """Background-species heat ratio (GetSpecificHeatRatio)."""
        cv = self.molar_cv_over_R[self.i_background] * _R
        return (cv + _R) / cv

    # -- species number densities -----------------------------------------
    def _active_slice(self, X):
        na = self.num_active_species
        return X[..., self.nvel + 2 : self.nvel + 2 + na]

    def ambipolar_electron_density(self, n_active):
        z = self._arr(self.charges, n_active)[: self.num_active_species]
        ne = torch.einsum("...s,s->...", n_active, z)
        return torch.clamp(ne, min=0.0)

    def _n_sp(self, rho, n_active):
        """All species' number densities from rho and the active ones."""
        mw = self._arr(self.mw, rho)
        na = self.num_active_species
        if self.ambipolar:
            n_e = self.ambipolar_electron_density(n_active)
        else:
            n_e = n_active[..., self.i_electron]
        rhoB = rho - torch.einsum("...s,s->...", n_active, mw[:na])
        if self.ambipolar:
            rhoB = rhoB - n_e * mw[self.i_electron]
        n_B = rhoB / mw[self.i_background]
        if self.ambipolar:
            return torch.cat([n_active, n_e[..., None], n_B[..., None]], -1)
        return torch.cat([n_active, n_B[..., None]], -1)

    def number_densities(self, U):
        """n_sp [..., nsp] from conserved state (computeNumberDensities)."""
        na = self.num_active_species
        mw = self._arr(self.mw, U)
        return self._n_sp(U[..., 0], self._active_slice(U) / mw[:na])

    def _heavies_cv(self, n_sp):
        """Volumetric heat capacity of heavy species (J/m^3/K)."""
        return torch.einsum("...s,s->...", n_sp,
                            self.molar_cv(n_sp) * self._heavy_mask(n_sp))

    def heavies_gamma(self, n_sp):
        """Heavy-species mixture heat ratio (computeHeaviesMixtureHeatRatio)."""
        cv = self._heavies_cv(n_sp)
        n_h = torch.einsum("...s,s->...", n_sp, self._heavy_mask(n_sp))
        return 1.0 + n_h * _R / cv

    def _formation(self, n_sp):
        """sum over the species before the electron of n_s h_f,s."""
        hf = self._arr(self.formation_energy, n_sp)
        k = self.num_species - 2
        return torch.einsum("...s,s->...", n_sp[..., :k], hf[:k])

    # -- temperatures / pressure ------------------------------------------
    def temperatures(self, U, n_sp=None):
        """(T_h, T_e) from conserved state (computeTemperaturesBase)."""
        if n_sp is None:
            n_sp = self.number_densities(U)
        ne = n_sp[..., self.i_electron]
        cv_e = self.molar_cv_over_R[self.i_electron] * _R
        C = self._heavies_cv(n_sp)
        if not self.two_temperature:
            C = C + ne * cv_e
        total_e = U[..., self.i_th] - self._formation(n_sp)
        ke = 0.5 * torch.sum(U[..., 1 : 1 + self.nvel] ** 2, dim=-1) / U[..., 0]
        Th = total_e - ke
        if self.two_temperature:
            Th = Th - U[..., self.i_te]
        Th = Th / C
        if self.two_temperature:
            Te = U[..., self.i_te] / torch.clamp(ne, min=_TINY) / cv_e
        else:
            Te = Th
        return Th, Te

    def pressure_base(self, n_sp, Th, Te):
        n_h = torch.einsum("...s,s->...", n_sp, self._heavy_mask(n_sp))
        ne = n_sp[..., self.i_electron]
        p = n_h * Th + ne * (Te if self.two_temperature else Th)
        return p * _R

    def pressure(self, U):
        n_sp = self.number_densities(U)
        Th, Te = self.temperatures(U, n_sp)
        return self.pressure_base(n_sp, Th, Te)

    def electron_pressure(self, U):
        n_sp = self.number_densities(U)
        _Th, Te = self.temperatures(U, n_sp)
        return n_sp[..., self.i_electron] * _R * Te

    def _n_sp_from_primitives(self, Up):
        return self._n_sp(Up[..., 0], self._active_slice(Up))

    # -- conversions -------------------------------------------------------
    def primitives(self, U):
        n_sp = self.number_densities(U)
        Th, Te = self.temperatures(U, n_sp)
        rho = U[..., 0:1]
        vel = U[..., 1 : 1 + self.nvel] / rho
        parts = [rho, vel, Th[..., None], n_sp[..., : self.num_active_species]]
        if self.two_temperature:
            parts.append(Te[..., None])
        return torch.cat(parts, dim=-1)

    def conservatives(self, Up):
        rho = Up[..., 0:1]
        mom = rho * Up[..., 1 : 1 + self.nvel]
        na = self.num_active_species
        mw = self._arr(self.mw, Up)
        rho_s = self._active_slice(Up) * mw[:na]
        n_sp = self._n_sp_from_primitives(Up)
        ne = n_sp[..., self.i_electron]
        cv_e = self.molar_cv_over_R[self.i_electron] * _R
        Th = Up[..., self.i_th]
        C = self._heavies_cv(n_sp)
        if self.two_temperature:
            Ue = ne * cv_e * Up[..., self.i_te]
        else:
            C = C + ne * cv_e
        total_e = 0.5 * rho[..., 0] * torch.sum(
            Up[..., 1 : 1 + self.nvel] ** 2, dim=-1) + C * Th
        if self.two_temperature:
            total_e = total_e + Ue
        total_e = total_e + self._formation(n_sp)
        parts = [rho, mom, total_e[..., None], rho_s]
        if self.two_temperature:
            parts.append(Ue[..., None])
        return torch.cat(parts, dim=-1)

    # -- wave speeds -------------------------------------------------------
    def speed_of_sound_from_conserved(self, U):
        n_sp = self.number_densities(U)
        Th, Te = self.temperatures(U, n_sp)
        p = self.pressure_base(n_sp, Th, Te)
        gamma = self.heavies_gamma(n_sp)
        return torch.sqrt(gamma * p / U[..., 0])

    def max_char_speed(self, U):
        rho = U[..., 0]
        v2 = torch.sum(U[..., 1 : 1 + self.nvel] ** 2, dim=-1) / (rho * rho)
        return torch.sqrt(v2) + self.speed_of_sound_from_conserved(U)

    # -- species views -----------------------------------------------------
    def species_enthalpies(self, U):
        """Volumetric species enthalpies n_s (Cp_s T + h_f)  [J/m^3]."""
        n_sp = self.number_densities(U)
        Th, Te = self.temperatures(U, n_sp)
        ie = self.i_electron
        Tsp = torch.stack([Te if s == ie else Th
                           for s in range(self.num_species)], dim=-1)
        return n_sp * (self.molar_cp(U) * Tsp
                       + self._arr(self.formation_energy, U))

    def species_primitives(self, U):
        """(X, Y, n) mole/mass fractions + number densities
        (computeSpeciesPrimitives)."""
        n_sp = self.number_densities(U)
        Y = n_sp * self._arr(self.mw, U) / U[..., 0:1]
        X = n_sp / torch.sum(n_sp, dim=-1, keepdim=True)
        return X, Y, n_sp

    def _species_gradients(self, grad_up):
        """grad n_s [..., nsp, dim] of every species from the primitive
        gradients (the active ones, then the electron's by
        quasineutrality, then the background's by mass)."""
        nvel, na = self.nvel, self.num_active_species
        mw = self._arr(self.mw, grad_up)
        gn_active = grad_up[..., nvel + 2 : nvel + 2 + na, :]
        if self.ambipolar:
            z = self._arr(self.charges, grad_up)[:na]
            ne_grad = torch.einsum("...sd,s->...d", gn_active, z)
        else:
            ne_grad = gn_active[..., self.i_electron, :]
        nB_grad = grad_up[..., 0, :] - torch.einsum("...sd,s->...d",
                                                    gn_active, mw[:na])
        if self.ambipolar:
            nB_grad = nB_grad - mw[self.i_electron] * ne_grad
        nB_grad = nB_grad / mw[self.i_background]
        parts = [gn_active]
        if self.ambipolar:
            parts.append(ne_grad[..., None, :])
        parts.append(nB_grad[..., None, :])
        return torch.cat(parts, dim=-2), gn_active, ne_grad, nB_grad

    def mole_fraction_gradient(self, n_sp, grad_up):
        """grad X [..., nsp, dim] from primitive gradients
        (ComputeMoleFractionGradient)."""
        gn_all, gn_active, ne_grad, nB_grad = self._species_gradients(grad_up)
        totalN = torch.sum(n_sp, dim=-1)
        totalN_grad = torch.sum(gn_active, dim=-2) + nB_grad
        if self.ambipolar:
            totalN_grad = totalN_grad + ne_grad
        tN = totalN[..., None, None]
        return (gn_all / tN
                - (n_sp[..., None] / tN**2) * totalN_grad[..., None, :])

    def mass_fraction_gradient(self, rho, n_sp, grad_up):
        """grad Y [..., nsp, dim] (ComputeMassFractionGradient behavior):
        dY_s = (MW_s/rho) dn_s - (MW_s n_s / rho^2) drho."""
        mw = self._arr(self.mw, n_sp)
        gn_all = self._species_gradients(grad_up)[0]
        grho = grad_up[..., 0, :]
        r = rho[..., None, None]
        return ((mw[:, None] * gn_all) / r
                - ((mw * n_sp)[..., None] / r**2) * grho[..., None, :])

    # -- BC helpers: the mixture BCs are ROADMAP A6.2 ------------------------
    def pressure_derivative(self, dUp_dn, U):
        raise _not_ported("the mixture's pressure derivative (mixture BCs)",
                          "A6.2")

    def conserved_from_convective_flux(self, mean_flux, normal):
        raise _not_ported("the mixture's mixed-out state (mixture BCs)",
                          "A6.2")

    def stagnant_state_with_temp(self, U, T_wall):
        raise _not_ported("the mixture's wall state (mixture BCs)", "A6.2")

    def modify_energy_for_pressure(self, U, p, modify_electron_energy=False):
        raise _not_ported("the mixture's pressure-set energy (mixture BCs)",
                          "A6.2")
