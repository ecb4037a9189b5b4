"""Escape-factor radiative decay of argon's excited states, on torch tensors.

The JAX package's physics/radiative_decay.py (escape_factor,
RadiativeDecay, tps_tpu/physics/radiative_decay.py:1-133), with the same
level data and formulas (reference: RadiativeDecay, src/reaction.cpp:146+,
src/reaction.hpp:160-260): the effective decay rate of a lumped excited
state is the Boltzmann-weighted sum over its internal levels of the
Einstein A coefficients times radiation-trapping escape factors (Chai &
Kwon's Doppler-lineshape formula) for a cylindrical plasma column of
radius R and length 2R.  The level loops run over Python constants, so a
step that calls it copies nothing from the host and stays capturable.
The rate is evaluated in double whatever the run's precision: the
excited levels' Boltzmann weights (exp(-E / R T), ~1e-190 at 300 K) are
below float's range, and their ratio came out 0 / 0.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import (AVOGADRO_NUMBER, BOLTZMANN_CONSTANT, PI,
                         PLANCK_CONSTANT, SPEED_OF_LIGHT,
                         UNIVERSAL_GAS_CONSTANT)

M_AR = 6.63352090e-26  # argon atomic mass [kg]

# argon lumped-state internal level data (NIST; reference reaction.hpp):
# energies [J/mol] and degeneracies
E_LVL = {
    "Ar": np.array([0.0]),
    "Ar_m": np.array([1114246.8116913952, 1131113.0237639823]),
    "Ar_r": np.array([1121506.2040552883, 1141235.3742507447]),
    "Ar_p": np.array([
        1245337.6579411437, 1280653.4893638478, 1261614.7730293325,
        1263463.1280640187, 1269085.454762629, 1270883.3460389085,
        1281579.837318737, 1283469.8354227678, 1285942.7139612488,
        1300611.3568123293,
    ]),
}
G_LVL = {
    "Ar": np.array([1.0]),
    "Ar_m": np.array([5.0, 1.0]),
    "Ar_r": np.array([3.0, 3.0]),
    "Ar_p": np.array([3.0, 1.0, 7.0, 5.0, 3.0, 5.0, 3.0, 5.0, 3.0, 1.0]),
}
# Einstein A coefficients [1/s]: AJI[(upper, lower)][i_upper][i_lower]
AJI = {
    ("Ar_r", "Ar"): np.array([[1.32e8], [5.32e8]]),
    ("Ar_p", "Ar_m"): np.array([
        [1.89e7, 9.8e5], [3.3e7, 0.0], [9.3e6, 0.0], [5.2e6, 2.43e6],
        [2.45e7, 0.0], [0.0, 0.0], [6.3e5, 1.86e7], [3.8e6, 0.0],
        [6.4e6, 1.17e7], [0.0, 0.0],
    ]),
    ("Ar_p", "Ar_r"): np.array([
        [5.4e6, 1.9e5], [0.0, 0.0], [2.15e7, 1.47e6], [2.5e7, 1.06e6],
        [4.9e6, 5.0e6], [4.0e7, 8643.18384420115], [2.2e4, 1.39e7],
        [8.5e6, 2.23e7], [1.83e6, 1.53e7], [2.36e5, 4.5e7],
    ]),
}
_SMALL = 1e-300


def _boltzmann_levels(n_sp, T, E, g):
    """Number densities of the internal levels [..., nlvl], Boltzmann at T."""
    w = torch.stack([float(gi) * torch.exp(
        -float(Ei) / UNIVERSAL_GAS_CONSTANT / (T + _SMALL))
        for Ei, gi in zip(E, g)], dim=-1)
    return w / torch.sum(w, dim=-1, keepdim=True) * n_sp[..., None]


def escape_factor(n_lower, E_u, E_l, g_u, g_l, A, T_g, R_cyl):
    """Chai & Kwon's Doppler-lineshape escape factor for a cylinder of
    radius R and length 2R (reference escapeFactCalc)."""
    lam0 = PLANCK_CONSTANT * SPEED_OF_LIGHT / ((E_u - E_l) / AVOGADRO_NUMBER)
    k0 = (lam0**3 * (n_lower * AVOGADRO_NUMBER) * g_u * A * math.sqrt(M_AR)
          / (8.0 * PI * g_l * torch.sqrt(2.0 * BOLTZMANN_CONSTANT * PI * T_g)))
    L = 2.0 * R_cyl
    q0 = R_cyl
    Lq = L / (2.0 * q0)
    kL = torch.clamp(k0 * L / 2.0, min=1.0 + 1e-12)
    kq = torch.clamp(k0 * q0, min=1.0 + 1e-12)
    eta_t = (2.0 / (torch.sqrt(PI * torch.log(kL)) * k0 * L + _SMALL)
             / (2.0 * Lq**2 + 2.0)
             + 1.0 / (torch.sqrt(PI * torch.log(kq)) * k0 * 2.0 * q0 + _SMALL)
             * (Lq / (Lq**2 + 1.0) + math.atan(Lq)))
    trapped = (k0 * L / 2.0 > 1.0) & (k0 * q0 > 1.0)
    return torch.clamp(torch.where(trapped, eta_t, torch.ones_like(eta_t)),
                       max=1.0)


@dataclass(frozen=True)
class RadiativeDecay:
    """Rate model: the effective Einstein A [1/s] of upper -> lower + hv,
    a forward-rate model of physics/chemistry.py::Chemistry for a
    unimolecular reaction (reactant stoichiometry 1 on the upper state)."""

    upper: str  # "Ar_r" | "Ar_p"
    lower: str  # "Ar" | "Ar_m" | "Ar_r"
    i_upper: int  # mixture species index of the upper state
    i_lower: int  # mixture species index of the lower state
    radius: float  # cylinder radius R [m]

    def __call__(self, T, n_sp=None, Th=None, Te=None, **kw):
        if n_sp is None:
            raise ValueError("RadiativeDecay needs species number densities")
        dtype = T.dtype
        T, n_sp, Th, Te = (None if a is None else a.double()
                           for a in (T, n_sp, Th, Te))
        Th = T if Th is None else Th
        Te = T if Te is None else Te
        E_u, g_u = E_LVL[self.upper], G_LVL[self.upper]
        E_l, g_l = E_LVL[self.lower], G_LVL[self.lower]
        A = AJI[(self.upper, self.lower)]
        n_u = n_sp[..., self.i_upper]
        n_l = n_sp[..., self.i_lower]
        nu_lvl = _boltzmann_levels(n_u, Te, E_u, g_u)
        nl_lvl = _boltzmann_levels(n_l, Te, E_l, g_l)
        eff = torch.zeros_like(n_u)
        for i in range(len(E_u)):
            a_i = torch.zeros_like(n_u)
            for j in range(len(E_l)):
                if A[i, j] == 0.0:
                    continue
                eta = escape_factor(nl_lvl[..., j], float(E_u[i]),
                                    float(E_l[j]), float(g_u[i]),
                                    float(g_l[j]), float(A[i, j]), Th,
                                    self.radius)
                a_i = a_i + eta * float(A[i, j])
            eff = eff + nu_lvl[..., i] * a_i
        return torch.clamp(eff / (n_u + _SMALL), min=0.0).to(dtype)
