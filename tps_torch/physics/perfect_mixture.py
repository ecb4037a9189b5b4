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

The BC helpers (pressure_derivative, conserved_from_convective_flux,
stagnant_state_with_temp, modify_energy_for_pressure, sound_speed_from_T)
serve dg/bc.py's walls, inlets and outlets on a mixture.  The LTE
initialisation (saha_ionization_fraction, species_from_lte,
state_from_lte) serves the LTE restart (solvers/compressible.py,
io/restartFromLTE).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import UNIVERSAL_GAS_CONSTANT

_R = UNIVERSAL_GAS_CONSTANT
_TINY = 1.0e-30


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

    def pressure_from_primitives(self, Up):
        n_sp = self._n_sp_from_primitives(Up)
        Th = Up[..., self.i_th]
        Te = Up[..., self.i_te] if self.two_temperature else Th
        return self.pressure_base(n_sp, Th, Te)

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

    # -- BC helpers (tps_tpu/physics/perfect_mixture.py:284-530) ---------
    def sound_speed_from_T(self, T):
        """The background gas's sound speed at T (the characteristic BCs'
        patch-mean c)."""
        return torch.sqrt(self.specific_heat_ratio * self.gas_constant * T)

    def pressure_derivative(self, dUp_dn, U):
        """Directional dp/dn from primitive derivatives along a direction
        (reference: PerfectMixture::ComputePressureDerivative): p = R (n_h
        Th + n_e Te), the electron and background density derivatives by
        quasineutrality and mass."""
        nvel, na = self.nvel, self.num_active_species
        mw = self._arr(self.mw, U)
        n_sp = self.number_densities(U)
        Th, Te = self.temperatures(U, n_sp)
        gn_active = dUp_dn[..., nvel + 2 : nvel + 2 + na]
        if self.ambipolar:
            z = self._arr(self.charges, U)[:na]
            ne_grad = torch.einsum("...s,s->...", gn_active, z)
        else:
            ne_grad = gn_active[..., self.i_electron]
        nB_grad = dUp_dn[..., 0] - torch.einsum("...s,s->...", gn_active,
                                                mw[:na])
        if self.ambipolar:
            nB_grad = nB_grad - mw[self.i_electron] * ne_grad
        nB_grad = nB_grad / mw[self.i_background]
        # heavies: every species but the electron
        nh_grad = torch.sum(gn_active, dim=-1) + nB_grad
        if not self.ambipolar:
            nh_grad = nh_grad - ne_grad
        n_h = torch.einsum("...s,s->...", n_sp, self._heavy_mask(U))
        ne = n_sp[..., self.i_electron]
        dTh = dUp_dn[..., self.i_th]
        if self.two_temperature:
            dp = (nh_grad * Th + n_h * dTh + ne_grad * Te
                  + ne * dUp_dn[..., self.i_te])
        else:
            dp = (nh_grad + ne_grad) * Th + (n_h + ne) * dTh
        return _R * dp

    def conserved_from_convective_flux(self, mean_flux, normal):
        """Mixed-out conserved state [neq] whose convective normal flux is
        `mean_flux` [neq] along the unit `normal` (reference:
        PerfectMixture::computeConservedStateFromConvectiveFlux,
        src/equation_of_state.cpp:1744-1824): the species number-density
        fluxes, the pressure from its quadratic, then the primitives."""
        nvel, na, nsp = self.nvel, self.num_active_species, self.num_species
        mw = self._arr(self.mw, mean_flux)
        hf = self._arr(self.formation_energy, mean_flux)
        cp = self.molar_cp(mean_flux)
        ie, ib = self.i_electron, self.i_background
        mdot = mean_flux[0]
        n_flux = mean_flux[nvel + 2 : nvel + 2 + na] / mw[:na]
        form_flux = torch.sum(n_flux * hf[:na])
        nB_flux = mdot - torch.sum(mean_flux[nvel + 2 : nvel + 2 + na])
        if self.ambipolar:
            ne_flux = torch.sum(n_flux * self._arr(self.charges,
                                                   mean_flux)[:na])
            form_flux = form_flux + ne_flux * hf[ie]
            nB_flux = nB_flux - ne_flux * mw[ie]
        else:
            ne_flux = n_flux[ie]
        nB_flux = nB_flux / mw[ib]
        form_flux = form_flux + nB_flux * hf[ib]
        Te = None
        if self.two_temperature:
            Te = mean_flux[self.i_te] / cp[ie] / ne_flux
        # the heavies' molar heat capacity from the fluxes (the electron's
        # only with one temperature)
        k = nsp - 2
        n_mix = torch.sum(n_flux[:k]) + nB_flux
        cp_mix = torch.sum(n_flux[:k] * cp[:k]) + nB_flux * cp[ib]
        if not self.two_temperature:
            n_mix = n_mix + ne_flux
            cp_mix = cp_mix + ne_flux * cp[ie]
        cp_mix = cp_mix / n_mix
        mom_n = torch.sum(mean_flux[1 : 1 + self.dim] * normal[: self.dim])
        A = 1.0 - 2.0 * cp_mix / _R
        B = 2.0 * mom_n * (cp_mix / _R - 1.0)
        C = -2.0 * mdot * mean_flux[self.i_th] + torch.sum(
            mean_flux[1 : 1 + nvel] ** 2)
        if self.two_temperature:
            C = C + 2.0 * mdot * ne_flux * (cp[ie] - cp_mix) * Te
        C = C + 2.0 * mdot * form_flux
        p = (-B - torch.sqrt(B * B - 4.0 * A * C)) / (2.0 * A)
        Th = (mom_n - p) / mdot * p / _R
        if self.two_temperature:
            Th = Th - ne_flux * Te
        Th = Th / n_mix
        rho = mdot * mdot / (mom_n - p)
        n_full = torch.cat([normal[: self.dim],
                            torch.zeros(nvel - self.dim, dtype=mean_flux.dtype,
                                        device=mean_flux.device)])
        vel = (mean_flux[1 : 1 + nvel] - p * n_full) / mdot
        parts = [rho[None], vel, Th[None], n_flux * mdot / (mom_n - p)]
        if self.two_temperature:
            parts.append(Te[None])
        return self.conservatives(torch.cat(parts))

    def stagnant_state_with_temp(self, U, T_wall):
        """Zero-velocity state at the wall temperature, Th = Te = T_wall
        (computeStagnantStateWithTemp)."""
        n_sp = self.number_densities(U)
        ne = n_sp[..., self.i_electron]
        Ue = ne * self.molar_cv_over_R[self.i_electron] * _R * T_wall
        e_tot = self._heavies_cv(n_sp) * T_wall + Ue + self._formation(n_sp)
        parts = [U[..., :1], torch.zeros_like(U[..., 1 : 1 + self.nvel]),
                 e_tot[..., None], U[..., self.i_th + 1 :]]
        out = torch.cat(parts, dim=-1)
        if self.two_temperature:
            out = torch.cat([out[..., : self.i_te], Ue[..., None]], dim=-1)
        return out

    def modify_energy_for_pressure(self, U, p, modify_electron_energy=False):
        """U with the energies set so that its pressure is p
        (modifyEnergyForPressure); p a number or a tensor."""
        n_sp = self.number_densities(U)
        ne = n_sp[..., self.i_electron]
        cv_e = self.molar_cv_over_R[self.i_electron] * _R
        if self.two_temperature and not modify_electron_energy:
            Te = U[..., self.i_te] / (ne + _TINY) / cv_e
            pe = ne * _R * Te
            n_for_T = torch.sum(n_sp, dim=-1) - ne
        else:
            pe = torch.zeros_like(ne)
            n_for_T = torch.sum(n_sp, dim=-1)
        Th = (p - pe) / (n_for_T * _R)
        if self.two_temperature and not modify_electron_energy:
            Ue = U[..., self.i_te]
        else:
            Ue = ne * cv_e * Th
        rE = (self._heavies_cv(n_sp) * Th + Ue
              + 0.5 * torch.sum(U[..., 1 : 1 + self.nvel] ** 2, dim=-1)
              / U[..., 0] + self._formation(n_sp))
        out = torch.cat([U[..., : self.i_th], rE[..., None],
                         U[..., self.i_th + 1 :]], dim=-1)
        if self.two_temperature:
            out = torch.cat([out[..., : self.i_te], Ue[..., None]], dim=-1)
        return out


# -- the LTE initialisation (tps_tpu/physics/perfect_mixture.py:531-714) ----


def _f64(x):
    """x as a float64 tensor (numbers and arrays included)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def saha_ionization_fraction(n_total, T, ionization_energy_J_per_mol,
                             g_ratio=6.0):
    """Saha equilibrium ionization fraction x = n_e / n_nuclei for a single
    positive ion species (the role of PerfectMixture::GetSpeciesFromLTE,
    reference: src/equation_of_state.cpp:1910+, 'weakly ionized perfect
    gas' assumptions).

    n_total in mol/m^3 (nuclei), T in K; g_ratio = 2 g_ion / g_neutral.
    Tensors keep their dtype; numbers are taken in f64."""
    from ..constants import (AVOGADRO_NUMBER, BOLTZMANN_CONSTANT,
                             ELECTRON_MASS, PI, PLANCK_CONSTANT)

    T = T if isinstance(T, torch.Tensor) else _f64(T)
    n_total = (n_total if isinstance(n_total, torch.Tensor)
               else _f64(n_total))
    lam = PLANCK_CONSTANT / torch.sqrt(
        2.0 * PI * ELECTRON_MASS * BOLTZMANN_CONSTANT * T)
    # S = (g_ratio / lambda^3) exp(-E_ion / R T)  [1/m^3] -> molar
    S = (g_ratio / lam**3) * torch.exp(
        -ionization_energy_J_per_mol / (_R * T)) / AVOGADRO_NUMBER
    # x^2 / (1 - x) = S / n  ->  x = (-s + sqrt(s^2 + 4 s)) / 2, s = S/n
    s = S / torch.clamp(n_total, min=1e-300)
    x = 0.5 * (-s + torch.sqrt(s * s + 4.0 * s))
    return torch.clamp(x, 0.0, 1.0)


def _lte_level_structure(mixture):
    """(neutral levels, the ion, degeneracies) of the mixture's active
    species: the lumped excited neutral levels, the single positive ion
    and the per-species level degeneracies (level_degeneracy in the
    ini)."""
    charges = np.asarray(mixture.charges)
    na = mixture.num_active_species
    g = np.asarray(mixture.degeneracy if mixture.degeneracy is not None
                   else np.ones(mixture.num_species))
    ions = [sp for sp in range(na)
            if charges[sp] > 0.0 and sp != mixture.i_electron]
    if len(ions) != 1:
        raise NotImplementedError(
            "LTE species initialization supports exactly one positive ion "
            f"(found {len(ions)} among the active species); the reference "
            "makes the same assumption (src/equation_of_state.cpp:1902-1905)")
    levels = [sp for sp in range(na)
              if charges[sp] == 0.0 and sp != mixture.i_electron]
    return levels, ions[0], g


def species_from_lte(mixture, rho, T):
    """Active-species number densities [..., n_active] at LTE for a weakly
    ionized atomic mixture at (rho, T): the Saha equation for the
    ionization balance, with the neutral partition function over the
    lumped excited levels, then Boltzmann level populations (reference:
    PerfectMixture::GetSpeciesFromLTE, src/equation_of_state.cpp:
    1894-1966).  The nuclei density is rho / mw_background, so mass is
    preserved (the reference works from the table pressure instead).
    rho and T: tensors (their dtype) or numbers (f64)."""
    from ..constants import (AVOGADRO_NUMBER, BOLTZMANN_CONSTANT,
                             ELECTRON_MASS, PI, PLANCK_CONSTANT)

    T = T if isinstance(T, torch.Tensor) else _f64(T)
    rho = rho if isinstance(rho, torch.Tensor) else _f64(rho)
    mw = np.asarray(mixture.mw)
    hf = np.asarray(mixture.formation_energy)
    levels, i_ion, g = _lte_level_structure(mixture)
    ib = mixture.i_background

    n_nuc = rho / mw[ib]

    # neutral partition function: the ground state (1) and the lumped
    # levels
    RT = _R * T
    Q_n = 1.0
    for sp in levels:
        Q_n = Q_n + g[sp] * torch.exp(-hf[sp] / RT)
    Q_i = g[i_ion]
    Q_e = 2.0
    mr32 = (mw[i_ion] / mw[ib]) ** 1.5

    # S = mr32 (Q_e Q_i / Q_n) / (lambda_e^3 N_A) exp(-E_ion / RT), in log
    # space: 2 pi m_e k T ~ 1e-52 underflows f32
    log_lam3 = 3.0 * (
        float(np.log(PLANCK_CONSTANT))
        - 0.5 * (float(np.log(2.0 * PI * ELECTRON_MASS * BOLTZMANN_CONSTANT))
                 + torch.log(T)))
    S = torch.exp(float(np.log(mr32 * Q_e / AVOGADRO_NUMBER))
                  + torch.log(Q_i / Q_n) - log_lam3 - hf[i_ion] / RT)
    # Saha: n_e^2 = S n_neutral with n_neutral = n_nuc - n_e
    n_e = 0.5 * (-S + torch.sqrt(S * S + 4.0 * S * n_nuc))
    n_e = torch.minimum(torch.clamp(n_e, min=0.0), n_nuc)
    n_neutral = n_nuc - n_e

    out = [None] * mixture.num_active_species
    for sp in levels:
        out[sp] = n_neutral * g[sp] * torch.exp(-hf[sp] / RT) / Q_n
    out[i_ion] = n_e
    if not mixture.ambipolar:
        out[mixture.i_electron] = n_e
    return torch.stack(out, dim=-1)


def state_from_lte(mixture, U, newton_iters=30):
    """The conserved state at LTE from the bulk fields of U (density,
    momentum, total energy; the species and electron-energy slots are
    ignored): T from Newton on e_int(T; Saha species at (rho, T)) =
    rhoE - ke, with its exact derivative (forward mode), so mass,
    momentum and energy are kept (the role of io/restartFromLTE and
    M2ulPhyS::initilizeSpeciesFromLTE, reference: src/M2ulPhyS.cpp:
    2388-2470).  Two-temperature mixtures get Te = T (reference :2455)."""
    mw = np.asarray(mixture.mw)
    nvel = mixture.nvel
    rho = U[..., 0]
    mom = U[..., 1 : 1 + nvel]
    ke = 0.5 * torch.sum(mom * mom, dim=-1) / rho
    e_target = U[..., mixture.i_th] - ke

    def primitives(T, vel):
        parts = [rho[..., None], vel, T[..., None],
                 species_from_lte(mixture, rho, T)]
        if mixture.two_temperature:
            parts.append(T[..., None])
        return torch.cat(parts, dim=-1)

    def resid(T):
        Up0 = primitives(T, torch.zeros_like(mom))
        return mixture.conservatives(Up0)[..., mixture.i_th] - e_target

    # initial guess: the all-neutral background gas
    cv_bg = mixture.molar_cv_over_R[mixture.i_background] * _R
    T = torch.clamp(e_target / (rho / mw[mixture.i_background] * cv_bg),
                    min=200.0)
    for _ in range(newton_iters):
        r, dr = torch.func.jvp(resid, (T,), (torch.ones_like(T),))
        # dr = d(rhoE)/dT >= rho cv > 0; the guard keeps a 0/0 from
        # rounding out of the step
        pos = dr > 0.0
        step = r / torch.where(pos, dr, torch.ones_like(dr))
        T = torch.clamp(torch.where(pos, T - step, T), min=200.0)
    return mixture.conservatives(primitives(T, mom / rho[..., None]))
