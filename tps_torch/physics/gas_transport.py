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
background); GasMixtureTransport takes [ion, others..., e-, background].  csrc/dg_pointwise.cuh computes flux_properties' viscous
part on the card (dg/cuda_faces.py::mixture_phys packs its constants).

Also here: ConstantPlasmaTransport (constant coefficients with
per-species diffusivities, :276-373) and GasMixtureTransport (the general
N-species model from per-pair collision integrals, `argon_mixture`,
:437-642).  The face-sweep kernel's mixture policies compute their
viscous parts on the card: csrc/dg_gas_mixture.cuh, with the constants
dg/cuda_faces.py packs.
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


def _f64(*ts):
    """The tensors in double (None stays None).  The transport is
    evaluated in the run's precision but for the parts that cancel most
    of float's digits, which are formed in double whatever it is: the
    species fractions (`_species`), the e-neutral log T fits (their terms
    cancel ~5 digits at a few hundred K), Devoto's third-order electron
    conductivity (~2 more) and the diffusion block, where the ambipolar
    field cancels the electron's drift against the ion's.  In float they leave a weakly ionised deck's
    electron conductivity ~5x off and its T_e diffusing past the step's
    limit.  The face-sweep kernels' mixture policies split their viscous
    fluxes the same way (csrc/dg_mixture.cuh, csrc/dg_gas_mixture.cuh)."""
    return tuple(None if t is None else t.double() for t in ts)


def _species(mix, U):
    """Mole fractions, mass fractions and number densities in double from
    a state in any precision (in float the background's 1 - Y_s, its
    diffusivity's numerator, cancels every digit at a weak ionisation),
    and X_s, n_s in the state's precision."""
    X_d, Y_d, n_d = mix.species_primitives(U.double())
    return X_d, Y_d, n_d, X_d.to(U.dtype), n_d.to(U.dtype)


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
        Q2 = _f64(*(debye_circle * f(ndim_te)
                    for f in (ci.rep22, ci.rep23, ci.rep24)))
        Q1i = _f64(*(debye_circle * f(ndim_te)
                     for f in (ci.att11, ci.att12, ci.att13, ci.att14,
                               ci.att15)))
        Q1n = [f(Te.double())
               for f in (ci.eAr11, ci.eAr12, ci.eAr13, ci.eAr14, ci.eAr15)]
        dtype = Te.dtype
        X_sp, Te = _f64(X_sp, Te)
        Xe = X_sp[..., self.i_electron]
        Xi = X_sp[..., self.i_ion]
        Xn = X_sp[..., self.i_neutral]
        sq2 = np.sqrt(2.0)
        l11, l12, l22 = (sq2 * Xe * _lsum(ee, Q2) + Xi * _lsum(eh, Q1i)
                         + Xn * _lsum(eh, Q1n)
                         for ee, eh in zip(L_EE, L_EH))
        # l12 (l12 / l22), not l12^2 / l22: l12^2 (~1e-38 m^4) is below
        # float's normal range, where the JAX package's compiled form keeps
        # it (the kernels form it so too, csrc/dg_mixture.cuh)
        return (VISCOSITY_FACTOR * K_OVER_ETA_FACTOR
                * torch.sqrt(2.0 * Te / m[self.i_electron]) * Xe
                / (l11 - l12 * (l12 / l22))).to(dtype)

    def _diffusion(self, mix, X_sp, Y_sp, n_sp, Th, Te, dc, ndim_te, grad_up,
                   efield, Qea=None, Qie=None):
        """Curtiss-Hirschfelder diffusivities from the binary ones, the
        mobilities, and the corrected diffusion velocities
        [..., nsp, dim], in double (_f64) and returned in the run's
        precision."""
        ii, ie, ib = self.i_ion, self.i_electron, self.i_neutral
        dtype = Th.dtype
        if Qea is None:
            Qea = ci.eAr11(Te.double())
        if Qie is None:
            Qie = ci.att11(ndim_te) * dc
        Qni = ci.ArAr1P11(Th)
        X_sp, Y_sp, n_sp, Th, Te, grad_up, efield, Qie, Qni = _f64(
            X_sp, Y_sp, n_sp, Th, Te, grad_up, efield, Qie, Qni)
        n_tot = torch.sum(n_sp, dim=-1)
        d_en = (DIFFUSIVITY_FACTOR * torch.sqrt(Te / self.muw(ie, ib)) / n_tot
                / Qea)
        d_ni = (DIFFUSIVITY_FACTOR * torch.sqrt(Th / self.muw(ib, ii)) / n_tot
                / Qni)
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
        return diff.to(dtype), mobility.to(dtype), dv.to(dtype)

    # ------------------------------------------------------------------
    def flux_properties(self, mixture, U, Up, grad_up, efield=None, **kw):
        """Viscosity, conductivities, and species diffusion velocities (the
        parts that cancel in double, _f64)."""
        mix = self.mixture
        m = self.masses()
        ii, ie, ib = self.i_ion, self.i_electron, self.i_neutral

        X_d, Y_d, n_d, X_sp, n_sp = _species(mix, U)
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
            kappa_e = self._third_order_ke(X_d, dc, Te, ndim_te)
        else:
            kappa_e = (VISCOSITY_FACTOR * K_OVER_ETA_FACTOR
                       * torch.sqrt(Te / m[ie]) * X_sp[..., ie]
                       / (ci.rep22(ndim_te) * dc))

        diff, mobility, dv = self._diffusion(mix, X_d, Y_d, n_d, Th, Te,
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

        X_d, Y_d, n_d, X_sp, n_sp = _species(mix, U)
        Th = Up[..., mix.i_th]
        Te = Up[..., mix.i_te] if mix.two_temperature else Th

        _dl, dc, ndim_te, _ndim_th = self._collision_inputs(n_sp, Th, Te)
        Qea = ci.eAr11(Te.double())
        Qie = ci.att11(ndim_te) * dc

        # momentum-transfer collision frequencies of electrons with heavies
        vfac = MF_FREQ_FACTOR * torch.sqrt(Te / m[ie])
        zero = torch.zeros_like(Te)
        mf = torch.stack([vfac * n_sp[..., ii] * Qie if s == ii
                          else (vfac * n_sp[..., ib] * Qea).to(Te.dtype)
                          if s == ib else zero
                          for s in range(mix.num_species)], dim=-1)

        diff, mobility, dv = self._diffusion(mix, X_d, Y_d, n_d, Th, Te,
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


@dataclass(frozen=True, eq=False)
class ConstantPlasmaTransport:
    """Constant-coefficient multi-species transport (reference:
    ConstantTransport with per-species diffusivities and momentum-transfer
    frequencies, src/transport_properties.cpp:303-452): concentration-driven
    diffusion with the constant diffusivities, V_s = -D_s grad X_s /
    (X_s + eps), the ambipolar field (mobility qe/kB Z_s / T_s D_s), an
    external field's drift and the mass correction; the source side adds
    the electric conductivity and the constant e-heavy momentum-transfer
    frequencies."""

    mixture: object
    visc: float = 0.0
    bulk_visc: float = 0.0
    kappa: float = 0.0
    kappa_e: float = 0.0
    diffusivity: tuple = ()  # per species, mixture order [.., E, bg]
    mt_freq: tuple = ()  # per species, mixture order

    def _diffusion(self, mix, U, Up, grad_up, efield):
        """The diffusion block, in double (_f64), returned in the run's
        precision."""
        dtype = U.dtype
        X_sp, Y_sp, n_sp = mix.species_primitives(U.double())
        Th = Up[..., mix.i_th]
        Te = Up[..., mix.i_te] if mix.two_temperature else Th
        Th, Te, grad_up, efield, U = _f64(Th, Te, grad_up, efield, U)
        ie = mix.i_electron
        charges = mix._arr(mix.charges, U)
        diff = torch.broadcast_to(mix._arr(self.diffusivity, U), X_sp.shape)
        Tsp = torch.stack([Te if sp == ie else Th
                           for sp in range(mix.num_species)], dim=-1)
        mobility = _QE_OVER_KB * charges / Tsp * diff
        gradX = mix.mole_fraction_gradient(n_sp, grad_up)
        dv = -diff[..., None] * gradX / (X_sp[..., None] + _XEPS)
        if mix.ambipolar:
            dv = _add_ambipolar_efield(mobility, n_sp, charges, dv)
        if efield is not None:
            dv = _add_efield_drift(mobility, charges, efield, dv)
        dv = _correct_mass_diffusion_flux(Y_sp, dv)
        return tuple(t.to(dtype) for t in (dv, mobility, n_sp, diff))

    def flux_properties(self, mixture, U, Up, grad_up, efield=None, **kw):
        dv, mobility, n_sp, diff = self._diffusion(self.mixture, U, Up,
                                                   grad_up, efield)
        shape = U.shape[:-1]
        kw = {"dtype": U.dtype, "device": U.device}
        return {
            "visc": torch.full(shape, self.visc, **kw),
            "bulk_visc": torch.full(shape, self.bulk_visc, **kw),
            "kappa": torch.full(shape, self.kappa, **kw),
            "kappa_e": torch.full(shape, self.kappa_e, **kw),
            "diff_vel": dv,
            "diffusivity": diff,
            "mobility": mobility,
            "n_sp": n_sp,
        }

    def source_properties(self, U, Up, grad_up, efield=None):
        mix = self.mixture
        dv, mobility, n_sp, diff = self._diffusion(mix, U, Up, grad_up,
                                                   efield)
        return {
            "sigma": _conductivity(mix, mobility, n_sp),
            "mf_freq": torch.broadcast_to(mix._arr(self.mt_freq, U),
                                          n_sp.shape),
            "diff_vel": dv,
            "n_sp": n_sp,
            "mobility": mobility,
            "diffusivity": diff,
        }

    def electric_conductivity(self, U, Up):
        mix = self.mixture
        zero_grad = torch.zeros(U.shape[:-1] + (mix.num_equations, mix.dim),
                                dtype=U.dtype, device=U.device)
        _, mobility, n_sp, _ = self._diffusion(mix, U, Up, zero_grad, None)
        return _conductivity(mix, mobility, n_sp)


def _conductivity(mix, mobility, n_sp):
    """sigma = F sum_s mu_s n_s Z_s."""
    return MOLAR_ELECTRON_CHARGE * torch.einsum(
        "...s,...s,s->...", mobility, n_sp, mix._arr(mix.charges, n_sp))


def _add_efield_drift(mobility, charges, efield, dv):
    """The charged species' drift mu_s E in an external field."""
    return dv + torch.where(charges[..., None] != 0.0,
                            mobility[..., None] * efield[..., None, :],
                            torch.zeros_like(dv))


# ---------------------------------------------------------------------------
# General mixture transport from per-pair collision integrals
# ---------------------------------------------------------------------------

# collision kinds -> {(l, r): Omega(T)}; the Coulomb kinds take the
# nondimensional temperature and are scaled by the Debye circle
NEUTRAL_KINDS = {
    "AR_AR": {(1, 1): ci.ArAr11, (2, 2): ci.ArAr22},
    "AR_AR1P": {(1, 1): ci.ArAr1P11},
    "AR_E": {(1, r): getattr(ci, f"eAr1{r}") for r in range(1, 6)},
    "N2_N2": {(1, 1): ci.N2N211, (2, 2): ci.N2N222},
    "N2_N21P": {(1, 1): ci.N2N21P11},
    "N2_NI": {(1, 1): ci.N2Ni11, (2, 2): ci.N2Ni22},
    "N2_NI1P": {(1, 1): ci.N2Ni1P11},
    "NI_NI": {(1, 1): ci.NiNi11, (2, 2): ci.NiNi22},
    "NI_NI1P": {(1, 1): ci.NiNi1P11},
    "N2_E": {(1, r): getattr(ci, f"eN21{r}") for r in range(1, 6)},
    "NI_E": {(1, r): getattr(ci, f"eNi1{r}") for r in range(1, 6)},
}
CLMB = {
    "CLMB_ATT": {(l, r): getattr(ci, f"att{l}{r}")
                 for l, rs in ((1, range(1, 6)), (2, range(2, 5)))
                 for r in rs},
    "CLMB_REP": {(l, r): getattr(ci, f"rep{l}{r}")
                 for l, rs in ((1, range(1, 6)), (2, range(2, 5)))
                 for r in rs},
}

# species-name pair -> collision kind (order-insensitive), the valid tags
# of the reference's dispatch (src/gas_transport.cpp:995-1283)
NAME_PAIR_KINDS = {
    frozenset(["Ar"]): "AR_AR",
    frozenset(["Ar", "Ar.+1"]): "AR_AR1P",
    frozenset(["Ar", "E"]): "AR_E",
    frozenset(["N2"]): "N2_N2",
    frozenset(["N2", "N2.+1"]): "N2_N21P",
    frozenset(["N2", "N"]): "N2_NI",
    frozenset(["N2", "N.+1"]): "N2_NI1P",
    frozenset(["N"]): "NI_NI",
    frozenset(["N", "N.+1"]): "NI_NI1P",
    frozenset(["N2", "E"]): "N2_E",
    frozenset(["N", "E"]): "NI_E",
}


@dataclass(frozen=True, eq=False)
class GasMixtureTransport(ArgonMinimalTransport):
    """General N-species collision-integral transport (reference:
    GasMixtureTransport, src/gas_transport.cpp:874-1660): the ternary
    model's Chapman-Enskog machinery driven by a per-pair table of
    collision integrals.  Charged pairs take the screened-Coulomb fits
    (attractive or repulsive by the sign of the charge product), the
    others the argon or nitrogen fits of their species names.
    `species_names` are in mixture order; `pair_kinds` maps each pair
    (i <= j) to its kind ("CLMB_ATT", "CLMB_REP" or a NEUTRAL_KINDS key),
    which dg/cuda_faces.py packs for the kernel."""

    species_names: tuple = ()

    def __post_init__(self):
        mix = self.mixture
        names = list(self.species_names)
        nsp = mix.num_species
        if len(names) != nsp:
            raise ValueError("species_names must match mixture.num_species")
        kinds = {}
        for i in range(nsp):
            for j in range(i, nsp):
                zi, zj = mix.charges[i], mix.charges[j]
                if zi != 0.0 and zj != 0.0:
                    kinds[(i, j)] = "CLMB_REP" if zi * zj > 0 else "CLMB_ATT"
                    continue
                key = frozenset([names[i]] if i == j else [names[i], names[j]])
                if key not in NAME_PAIR_KINDS:
                    raise NotImplementedError(
                        f"no collision-integral data for pair "
                        f"({names[i]}, {names[j]})")
                kinds[(i, j)] = NAME_PAIR_KINDS[key]
        object.__setattr__(self, "pair_kinds", kinds)

    def _omega(self, i, j, l, r, Th, Te, dc, ndim_th, ndim_te):
        """Q^(l,r)(i, j) at the pair's temperature: T_e where the electron
        takes part, else T_h.  An e-neutral pair's log T fit is evaluated
        in double (_f64)."""
        kind = self.pair_kinds[(min(i, j), max(i, j))]
        is_e = self.mixture.i_electron in (i, j)
        if kind in CLMB:
            return dc * CLMB[kind][(l, r)](ndim_te if is_e else ndim_th)
        return NEUTRAL_KINDS[kind][(l, r)](Te.double() if is_e else Th)

    def _third_order_ke_general(self, X_sp, Th, Te, dc, ndim_th, ndim_te):
        """Devoto's third-order electron thermal conductivity, summed over
        every species (reference: gas_transport.cpp:1388-1407)."""
        mix = self.mixture
        m = self.masses()
        ie = mix.i_electron

        def om(j, l, r):
            return self._omega(ie, j, l, r, Th, Te, dc, ndim_th, ndim_te)

        Q2 = _f64(*(om(ie, 2, r) for r in (2, 3, 4)))
        dtype = Te.dtype
        X_d, Te_d = _f64(X_sp, Te)
        sq2Xe = np.sqrt(2.0) * X_d[..., ie]
        ls = [sq2Xe * _lsum(ee, Q2) for ee in L_EE]
        for sp in range(mix.num_species):
            if sp == ie:
                continue
            Q1 = _f64(*(om(sp, 1, r) for r in range(1, 6)))
            ls = [lv + X_d[..., sp] * _lsum(eh, Q1)
                  for lv, eh in zip(ls, L_EH)]
        l11, l12, l22 = ls
        return (VISCOSITY_FACTOR * K_OVER_ETA_FACTOR
                * torch.sqrt(2.0 * Te_d / m[ie]) * X_d[..., ie]
                / (l11 - l12 * (l12 / l22))).to(dtype)  # as _third_order_ke

    def _common(self, U, Up, grad_up, efield):
        mix = self.mixture
        m = self.masses()
        nsp = mix.num_species
        ie = mix.i_electron
        X_d, Y_d, n_d, X_sp, n_sp = _species(mix, U)
        n_tot = torch.sum(n_d, dim=-1)
        Th = Up[..., mix.i_th]
        Te = Up[..., mix.i_te] if mix.two_temperature else Th
        _dl, dc, ndim_te, ndim_th = self._collision_inputs(n_sp, Th, Te)
        # the diffusion block in double (_f64): binary diffusion of every
        # pair, the Curtiss-Hirschfelder average, the diffusion velocities
        dtype = Th.dtype
        Th_d, Te_d, grad_up, efield = _f64(Th, Te, grad_up, efield)
        denom = [torch.zeros_like(Th_d) for _ in range(nsp)]
        for i in range(nsp):
            for j in range(i + 1, nsp):
                Tij = Te_d if ie in (i, j) else Th_d
                muw = m[i] * m[j] / (m[i] + m[j])
                Q11 = self._omega(i, j, 1, 1, Th, Te, dc, ndim_th,
                                  ndim_te).double()
                d_ij = DIFFUSIVITY_FACTOR * torch.sqrt(Tij / muw) / n_tot / Q11
                denom[i] = denom[i] + (X_d[..., j] + _XEPS) / d_ij
                denom[j] = denom[j] + (X_d[..., i] + _XEPS) / d_ij
        diff = torch.stack([(1.0 - Y_d[..., s]) / denom[s]
                            for s in range(nsp)], dim=-1) * self.diff_mult
        charges = mix._arr(mix.charges, Th_d)
        Tsp = torch.stack([Te_d if s == ie else Th_d for s in range(nsp)],
                          dim=-1)
        mobility = _QE_OVER_KB * charges / Tsp * diff * self.mobil_mult
        gradX = mix.mole_fraction_gradient(n_d, grad_up)
        dv = -diff[..., None] * gradX / (X_d[..., None] + _XEPS)
        if mix.ambipolar:
            dv = _add_ambipolar_efield(mobility, n_d, charges, dv)
        if efield is not None:
            dv = _add_efield_drift(mobility, charges, efield, dv)
        dv = _correct_mass_diffusion_flux(Y_d, dv)
        diff, mobility, dv = (t.to(dtype) for t in (diff, mobility, dv))
        return (X_d, X_sp, n_sp, Th, Te, dc, ndim_th, ndim_te, diff, mobility,
                dv)

    def flux_properties(self, mixture, U, Up, grad_up, efield=None, **kw):
        mix = self.mixture
        m = self.masses()
        ie = mix.i_electron
        (X_d, X_sp, n_sp, Th, Te, dc, ndim_th, ndim_te, diff, mobility,
         dv) = self._common(U, Up, grad_up, efield)
        visc = torch.zeros_like(Th)
        kappa = torch.zeros_like(Th)
        for sp in range(mix.num_species):
            if sp == ie:
                continue  # electron viscosity neglected
            Q22 = self._omega(sp, sp, 2, 2, Th, Te, dc, ndim_th, ndim_te)
            v = VISCOSITY_FACTOR * torch.sqrt(m[sp] * Th) / Q22
            visc = visc + X_sp[..., sp] * v
            kappa = kappa + X_sp[..., sp] * v * K_OVER_ETA_FACTOR / m[sp]
        if self.third_order_electron_thermal_conductivity:
            kappa_e = self._third_order_ke_general(X_d, Th, Te, dc, ndim_th,
                                                   ndim_te)
        else:
            Qee = self._omega(ie, ie, 2, 2, Th, Te, dc, ndim_th, ndim_te)
            kappa_e = (VISCOSITY_FACTOR * K_OVER_ETA_FACTOR
                       * torch.sqrt(Te / m[ie]) * X_sp[..., ie] / Qee)
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

    def source_properties(self, U, Up, grad_up, efield=None):
        mix = self.mixture
        m = self.masses()
        ie = mix.i_electron
        (X_d, X_sp, n_sp, Th, Te, dc, ndim_th, ndim_te, diff, mobility,
         dv) = self._common(U, Up, grad_up, efield)
        # the electrons' momentum-transfer collision frequencies with every
        # heavy
        vfac = MF_FREQ_FACTOR * torch.sqrt(Te / m[ie])
        zero = torch.zeros_like(Te)
        mf = torch.stack([
            zero if sp == ie else (vfac * n_sp[..., sp] * self._omega(
                ie, sp, 1, 1, Th, Te, dc, ndim_th, ndim_te)).to(Te.dtype)
            for sp in range(mix.num_species)], dim=-1)
        return {
            "sigma": _conductivity(mix, mobility, n_sp),
            "mf_freq": mf,
            "diff_vel": dv,
            "n_sp": n_sp,
            "mobility": mobility,
            "diffusivity": diff,
        }
