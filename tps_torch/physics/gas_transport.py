"""Argon ternary collision-integral transport (ArgonMinimalTransport) on
torch tensors.

The JAX package's physics/gas_transport.py for the Ar / Ar+ / e- system
(ArgonMinimalTransport, tps_tpu/physics/gas_transport.py:43-275, and
_add_ambipolar_efield / _correct_mass_diffusion_flux, :375-435), with the
same formulas (reference: src/gas_transport.cpp:39-520,
src/transport_properties.cpp:59-200): Chapman-Enskog first-order species
viscosities and conductivities averaged by mole fraction, the optional
third-order electron thermal conductivity (Devoto L-matrix form),
Curtiss-Hirschfelder averaged diffusivities from binary diffusion
coefficients, the ambipolar field and mixture drift, and
mass-conservation-corrected diffusion velocities.

Mixture species ordering expected: [Ar+, e-, Ar] (ion, electron,
background).  csrc/dg_pointwise.cuh computes flux_properties' viscous
part on the card (dg/cuda_faces.py::mixture_phys packs its constants).

Not here: ConstantPlasmaTransport (constant transport with species,
ROADMAP A6.2) and GasMixtureTransport (the general per-pair model,
`argon_mixture`, ROADMAP A6.3); physics/plasma_config.py raises for both.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import (AVOGADRO_NUMBER, BOLTZMANN_CONSTANT, ELECTRON_CHARGE,
                         MOLAR_ELECTRON_CHARGE, PI, VACUUM_PERMITTIVITY)
from . import collision_integrals as ci

_KB = BOLTZMANN_CONSTANT
_XEPS = 1.0e-30
_DEBYE_FACTOR = _KB * VACUUM_PERMITTIVITY / ELECTRON_CHARGE / ELECTRON_CHARGE
_QE_OVER_KB = ELECTRON_CHARGE / _KB

VISCOSITY_FACTOR = 5.0 / 16.0 * np.sqrt(PI * _KB)
K_OVER_ETA_FACTOR = 15.0 / 4.0 * _KB
DIFFUSIVITY_FACTOR = 3.0 / 16.0 * np.sqrt(2.0 * PI * _KB) / AVOGADRO_NUMBER
MF_FREQ_FACTOR = 4.0 / 3.0 * AVOGADRO_NUMBER * np.sqrt(8.0 * _KB / PI)

# the Devoto L-matrix combinations of the third-order electron thermal
# conductivity (reference: gas_transport.cpp:403-487): l11, l12, l22 of
# the e-e integrals Q2 = (rep22, rep23, rep24) and of the e-heavy ones
# Q1 = (Q^(1,1) .. Q^(1,5))
L_EE = ((1.0, 0.0, 0.0), (1.75, -2.0, 0.0), (4.8125, -7.0, 5.0))
L_EH = ((6.25, -15.0, 12.0, 0.0, 0.0),
        (10.9375, -39.375, 57.0, -30.0, 0.0),
        (19.140625, -91.875, 199.5, -210.0, 90.0))


def _lsum(coef, Q):
    out = 0.0
    for c, q in zip(coef, Q):
        if c != 0.0:
            out = out + c * q
    return out


@dataclass(frozen=True, eq=False)
class ArgonMinimalTransport:
    """Transport for the [Ar+, e-, Ar] mixture."""

    mixture: object
    third_order_electron_thermal_conductivity: bool = True
    # artificial multipliers (reference setArtificialMultipliers)
    visc_mult: float = 1.0
    bulk_visc_mult: float = 1.0
    kappa_mult: float = 1.0
    kappa_e_mult: float = 1.0
    diff_mult: float = 1.0
    mobil_mult: float = 1.0

    @property
    def i_ion(self):
        return 0

    @property
    def i_electron(self):
        return self.mixture.i_electron  # = 1 for the ternary mixture

    @property
    def i_neutral(self):
        return self.mixture.i_background  # = 2

    def masses(self):
        """Per-molecule masses (reference divides MW by Avogadro)."""
        return np.asarray(self.mixture.mw) / AVOGADRO_NUMBER

    def muw(self, a, b):
        """Reduced mass of species a and b (per molecule)."""
        m = self.masses()
        return m[a] * m[b] / (m[a] + m[b])

    # ------------------------------------------------------------------
    def _collision_inputs(self, n_sp, Th, Te):
        ne = n_sp[..., self.i_electron]
        ni = n_sp[..., self.i_ion]
        n_over_t = (ne + _XEPS) / Te + (ni + _XEPS) / Th
        debye_len = torch.sqrt(_DEBYE_FACTOR / AVOGADRO_NUMBER / n_over_t)
        debye_circle = PI * debye_len**2
        ndim_te = debye_len * 4.0 * PI * _DEBYE_FACTOR * Te
        ndim_th = debye_len * 4.0 * PI * _DEBYE_FACTOR * Th
        return debye_len, debye_circle, ndim_te, ndim_th

    def _third_order_ke(self, X_sp, debye_circle, Te, ndim_te):
        """Devoto third-order electron thermal conductivity
        (reference: gas_transport.cpp:403-487)."""
        m = self.masses()
        Q2 = [debye_circle * f(ndim_te) for f in (ci.rep22, ci.rep23, ci.rep24)]
        Q1i = [debye_circle * f(ndim_te)
               for f in (ci.att11, ci.att12, ci.att13, ci.att14, ci.att15)]
        Q1n = [f(Te) for f in (ci.eAr11, ci.eAr12, ci.eAr13, ci.eAr14, ci.eAr15)]
        Xe = X_sp[..., self.i_electron]
        Xi = X_sp[..., self.i_ion]
        Xn = X_sp[..., self.i_neutral]
        sq2 = np.sqrt(2.0)
        l11, l12, l22 = (sq2 * Xe * _lsum(ee, Q2) + Xi * _lsum(eh, Q1i)
                         + Xn * _lsum(eh, Q1n)
                         for ee, eh in zip(L_EE, L_EH))
        return (VISCOSITY_FACTOR * K_OVER_ETA_FACTOR
                * torch.sqrt(2.0 * Te / m[self.i_electron]) * Xe
                / (l11 - l12 * l12 / l22))

    def _diffusion(self, mix, X_sp, Y_sp, n_sp, Th, Te, dc, ndim_te, grad_up,
                   efield, Qea=None, Qie=None):
        """Curtiss-Hirschfelder diffusivities from the binary ones, the
        mobilities, and the corrected diffusion velocities
        [..., nsp, dim]."""
        ii, ie, ib = self.i_ion, self.i_electron, self.i_neutral
        n_tot = torch.sum(n_sp, dim=-1)
        if Qea is None:
            Qea = ci.eAr11(Te)
        if Qie is None:
            Qie = ci.att11(ndim_te) * dc
        d_en = (DIFFUSIVITY_FACTOR * torch.sqrt(Te / self.muw(ie, ib)) / n_tot
                / Qea)
        d_ni = (DIFFUSIVITY_FACTOR * torch.sqrt(Th / self.muw(ib, ii)) / n_tot
                / ci.ArAr1P11(Th))
        d_ei = (DIFFUSIVITY_FACTOR * torch.sqrt(Te / self.muw(ii, ie)) / n_tot
                / Qie)
        # Curtiss-Hirschfelder: D_s = (1 - Y_s) / sum_{j != s} (X_j+eps)/D_sj
        Xe_ = X_sp[..., ie] + _XEPS
        Xi_ = X_sp[..., ii] + _XEPS
        Xn_ = X_sp[..., ib] + _XEPS
        D_ion = (1.0 - Y_sp[..., ii]) / (Xe_ / d_ei + Xn_ / d_ni)
        D_ele = (1.0 - Y_sp[..., ie]) / (Xi_ / d_ei + Xn_ / d_en)
        D_neu = (1.0 - Y_sp[..., ib]) / (Xi_ / d_ni + Xe_ / d_en)
        diff = torch.stack([D_ion, D_ele, D_neu], dim=-1) * self.diff_mult

        charges = mix._arr(mix.charges, Th)
        Tsp = torch.stack([Th, Te, Th], dim=-1)
        mobility = _QE_OVER_KB * charges / Tsp * diff * self.mobil_mult

        # concentration-driven diffusion velocities
        gradX = mix.mole_fraction_gradient(n_sp, grad_up)  # [..., nsp, dim]
        dv = -diff[..., None] * gradX / (X_sp[..., None] + _XEPS)
        if mix.ambipolar:
            dv = _add_ambipolar_efield(mobility, n_sp, charges, dv)
        if efield is not None:
            dv = dv + torch.where(charges[..., None] != 0.0,
                                  mobility[..., None] * efield[..., None, :],
                                  0.0)
        dv = _correct_mass_diffusion_flux(Y_sp, dv)
        return diff, mobility, dv

    # ------------------------------------------------------------------
    def flux_properties(self, mixture, U, Up, grad_up, efield=None, **kw):
        """Viscosity, conductivities, and species diffusion velocities."""
        mix = self.mixture
        m = self.masses()
        ii, ie, ib = self.i_ion, self.i_electron, self.i_neutral

        X_sp, Y_sp, n_sp = mix.species_primitives(U)
        Th = Up[..., mix.i_th]
        Te = Up[..., mix.i_te] if mix.two_temperature else Th

        _dl, dc, ndim_te, ndim_th = self._collision_inputs(n_sp, Th, Te)

        # species viscosities (electron viscosity neglected)
        visc_i = (VISCOSITY_FACTOR * torch.sqrt(m[ii] * Th)
                  / (ci.rep22(ndim_th) * dc))
        visc_n = VISCOSITY_FACTOR * torch.sqrt(m[ib] * Th) / ci.ArAr22(Th)
        sp_visc = torch.stack([visc_i, torch.zeros_like(visc_i), visc_n], -1)
        sp_kappa = sp_visc * K_OVER_ETA_FACTOR / mix._arr(m, U)

        visc = torch.einsum("...s,...s->...", X_sp, sp_visc)
        kappa = torch.einsum("...s,...s->...", X_sp, sp_kappa)

        if self.third_order_electron_thermal_conductivity:
            kappa_e = self._third_order_ke(X_sp, dc, Te, ndim_te)
        else:
            kappa_e = (VISCOSITY_FACTOR * K_OVER_ETA_FACTOR
                       * torch.sqrt(Te / m[ie]) * X_sp[..., ie]
                       / (ci.rep22(ndim_te) * dc))

        diff, mobility, dv = self._diffusion(mix, X_sp, Y_sp, n_sp, Th, Te,
                                             dc, ndim_te, grad_up, efield)
        return {
            "visc": visc * self.visc_mult,
            "bulk_visc": torch.zeros_like(visc),
            "kappa": kappa * self.kappa_mult,
            "kappa_e": kappa_e * self.kappa_e_mult,
            "diff_vel": dv,
            "diffusivity": diff,
            "mobility": mobility,
            "n_sp": n_sp,
        }

    # ------------------------------------------------------------------
    def source_properties(self, U, Up, grad_up, efield=None):
        """Transport for the source terms: electric conductivity, e-heavy
        momentum-transfer collision frequencies, diffusion velocities
        (reference: GasMinimalTransport::ComputeSourceMolecularTransport,
        src/gas_transport.cpp:592-790)."""
        mix = self.mixture
        m = self.masses()
        ii, ie, ib = self.i_ion, self.i_electron, self.i_neutral

        X_sp, Y_sp, n_sp = mix.species_primitives(U)
        Th = Up[..., mix.i_th]
        Te = Up[..., mix.i_te] if mix.two_temperature else Th

        _dl, dc, ndim_te, _ndim_th = self._collision_inputs(n_sp, Th, Te)
        Qea = ci.eAr11(Te)
        Qie = ci.att11(ndim_te) * dc

        # momentum-transfer collision frequencies of electrons with heavies
        vfac = MF_FREQ_FACTOR * torch.sqrt(Te / m[ie])
        zero = torch.zeros_like(Te)
        mf = torch.stack([vfac * n_sp[..., ii] * Qie if s == ii
                          else vfac * n_sp[..., ib] * Qea if s == ib
                          else zero for s in range(mix.num_species)], dim=-1)

        diff, mobility, dv = self._diffusion(mix, X_sp, Y_sp, n_sp, Th, Te,
                                             dc, ndim_te, grad_up, efield,
                                             Qea=Qea, Qie=Qie)
        charges = mix._arr(mix.charges, U)
        sigma = MOLAR_ELECTRON_CHARGE * torch.einsum(
            "...s,...s,s->...", mobility, n_sp, charges)
        return {
            "sigma": sigma,
            "mf_freq": mf,
            "diff_vel": dv,
            "n_sp": n_sp,
            "mobility": mobility,
            "diffusivity": diff,
        }

    def electric_conductivity(self, U, Up):
        """Mixture electric conductivity sigma = sum_s mu_s n_s z_s * F
        (reference computeMixtureElectricConductivity; used for Joule
        coupling)."""
        mix = self.mixture
        zero_grad = torch.zeros(U.shape[:-1] + (mix.num_equations, mix.dim),
                                dtype=U.dtype, device=U.device)
        props = self.flux_properties(mix, U, Up, zero_grad)
        charges = mix._arr(mix.charges, U)
        return MOLAR_ELECTRON_CHARGE * torch.einsum(
            "...s,...s,s->...", props["mobility"], props["n_sp"], charges)


def _add_ambipolar_efield(mobility, n_sp, charges, dv):
    """Zero-current ambipolar electric field correction
    (reference: transport_properties.cpp:115-135)."""
    mho = torch.einsum("...s,...s,s->...", mobility, n_sp, charges)
    ambE = -torch.einsum("...sd,...s,s->...d", dv, n_sp, charges)
    ambE = ambE / (mho[..., None] + _XEPS)
    return dv + mobility[..., None] * ambE[..., None, :]


def _correct_mass_diffusion_flux(Y_sp, dv):
    """Subtract the mass-averaged drift so sum_s Y_s V_s = 0
    (reference: transport_properties.cpp:59-71)."""
    Vc = torch.einsum("...s,...sd->...d", Y_sp, dv)
    return dv - Vc[..., None, :]
