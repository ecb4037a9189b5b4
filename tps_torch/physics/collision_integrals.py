"""Collision integrals Q^(l,r) as batched functions on torch tensors.

The JAX package's physics/collision_integrals.py, function by function,
with the same published fits (reference: src/collision_integrals.cpp:
35-300, with citations therein):
  * charged-pair integrals from screened-Coulomb fits to Mason, Munn & Smith
    (Phys. Fluids 10, 1827 (1967)) and Devoto (Phys. Fluids 16, 616 (1973));
    nondimensional T based on the Debye length, result in units of
    pi * debye_length^2 (see Munafo et al., JCP 406, 109190 (2020) eq. A.3-4).
  * argon neutral integrals fitted from Amdur & Mason (1958), Liu, Whitten
    & Glass (1978), Devoto (1973).
  * e-Ar integrals from a shifted-MERT model fit over the BSR LXCat dataset.
  * the nitrogen system's log-polynomial fits (used by the general
    mixture transport, ROADMAP A6.3).

csrc/dg_pointwise.cuh evaluates the argon fits on the card with the same
coefficients (dg/cuda_faces.py packs them).
"""

from __future__ import annotations

import numpy as np
import torch

# (c, a, b, p) of c * log1p(a Tp^b)^p / Tp^2, per screened-Coulomb fit
SCREENED = {
    "att11": (0.2150, 5.2194, 1.0472, 1.2435),
    "att12": (0.0991, 7.4684, 1.0155, 1.1536),
    "att13": (0.0616, 7.8271, 0.9452, 1.1105),
    "att14": (0.0308, 13.9567, 0.9511, 1.1803),
    "att15": (0.0232, 13.7888, 0.9148, 1.1532),
    "att22": (0.2423, 4.6796, 1.3290, 1.1279),
    "att23": (0.1221, 8.7542, 1.3875, 1.1110),
    "att24": (0.0619, 18.2538, 1.4341, 1.1618),
    "rep11": (0.3904, 0.9100, 1.1025, 1.0544),
    "rep12": (0.1547, 1.6597, 1.1725, 0.9792),
    "rep13": (0.0814, 2.5815, 1.1948, 0.9570),
    "rep14": (0.0683, 1.9774, 1.2033, 0.8264),
    "rep15": (0.0346, 4.5177, 1.2132, 0.9294),
    "rep22": (0.4128, 1.2436, 1.1830, 1.0123),
    "rep23": (0.2203, 1.8832, 1.2059, 0.9851),
    "rep24": (0.1323, 2.7248, 1.2129, 0.9847),
}


def _screened(c, a, b, p):
    def f(Tp):
        return c * torch.log1p(a * Tp**b) ** p / (Tp * Tp)

    return f


# -- charged-pair (attractive / repulsive) fits; argument is the
#    Debye-nondimensionalized temperature; result in units of pi*lambda_D^2.
att11 = _screened(*SCREENED["att11"])
att12 = _screened(*SCREENED["att12"])
att13 = _screened(*SCREENED["att13"])
att14 = _screened(*SCREENED["att14"])
att15 = _screened(*SCREENED["att15"])
att22 = _screened(*SCREENED["att22"])
att23 = _screened(*SCREENED["att23"])
att24 = _screened(*SCREENED["att24"])

rep11 = _screened(*SCREENED["rep11"])
rep12 = _screened(*SCREENED["rep12"])
rep13 = _screened(*SCREENED["rep13"])
rep14 = _screened(*SCREENED["rep14"])
rep15 = _screened(*SCREENED["rep15"])
rep22 = _screened(*SCREENED["rep22"])
rep23 = _screened(*SCREENED["rep23"])
rep24 = _screened(*SCREENED["rep24"])


# -- argon system (T in Kelvin, result in m^2) --------------------------------

# (A, b) of A T^b
POWER_FITS = {"ArAr11": (2.2910e-18, -0.3032), "ArAr22": (1.7e-18, -0.25),
              "ArAr1P11": (4.574321e-18, -0.1805)}


def _power(A, b):
    def f(T):
        return A * T**b

    return f


ArAr11 = _power(*POWER_FITS["ArAr11"])
ArAr22 = _power(*POWER_FITS["ArAr22"])
ArAr1P11 = _power(*POWER_FITS["ArAr1P11"])


# e-Ar (l,r): fits in powers of log(T), k = -1..7
EAR_COEFFS = np.array(
    [
        [6.36254140e-18, 1.84835040e-18, -5.87727093e-18, 3.20023027e-18,
         -8.50509054e-19, 1.28163820e-19, -1.11712910e-20, 5.25649382e-22,
         -1.03296658e-23],
        [1.91338172e-17, 5.45418129e-18, -1.78361685e-17, 9.75657946e-18,
         -2.61115722e-18, 3.98310268e-19, -3.53503678e-20, 1.70375066e-21,
         -3.45211955e-23],
        [3.04685398e-17, 8.39750994e-18, -2.88132528e-17, 1.60147037e-17,
         -4.34837891e-18, 6.73136845e-19, -6.06704580e-20, 2.97216168e-21,
         -6.12760944e-23],
        [3.90777949e-17, 1.04696956e-17, -3.73774204e-17, 2.10610498e-17,
         -5.79029566e-18, 9.07573157e-19, -8.28466766e-20, 4.11188110e-21,
         -8.59225098e-23],
        [4.41333290e-17, 1.15696010e-17, -4.25651305e-17, 2.42442440e-17,
         -6.73359258e-18, 1.06641697e-18, -9.83933863e-20, 4.93775812e-21,
         -1.04362372e-22],
    ]
)


def _log_t_fit(T, coeff):
    """sum_k c_k log(T)^k for k = -1 .. 7 (Horner on log T)."""
    lt = torch.log(T)
    acc = torch.zeros_like(lt)
    for c in coeff[:0:-1]:  # c7 ... c0 (indices 8..1)
        acc = acc * lt + float(c)
    return acc + float(coeff[0]) / lt


def eAr(r: int):
    """Q_{e,Ar}^(1,r) for r = 1..5."""
    coeff = EAR_COEFFS[r - 1]

    def f(T):
        return _log_t_fit(T, coeff)

    return f


eAr11 = eAr(1)
eAr12 = eAr(2)
eAr13 = eAr(3)
eAr14 = eAr(4)
eAr15 = eAr(5)


# ---------------------------------------------------------------------------
# Nitrogen system fits (N2 / N / N+ / N2+ / e-), log-polynomial forms
# Omega(T) = pref * exp(scale * sum_k c_k ln(T)^k).
# Published sources (as cited by the reference src/collision_integrals.cpp):
# N-N, N-N+ — Levin et al. 1990 / Capitelli 2000 / Su 2023; N2-N2, N2-N+ —
# Phelps 1991 / Capitelli 2000; e-N, e-N2 — Itikawa cross sections.
# ---------------------------------------------------------------------------

def _logpoly(coeffs, scale=1.0, pref=1.0):
    c = np.asarray(coeffs, dtype=np.float64)

    def f(T):
        lt = torch.log(T)
        acc = torch.zeros_like(lt)
        for ck in c[::-1]:
            acc = acc * lt + float(ck)
        return pref * torch.exp(scale * acc)

    return f


_PI_ = float(np.pi)

NiNi11 = _logpoly([-41.999345922993626, -0.294552697364472], pref=_PI_)
NiNi22 = _logpoly([-42.134170027961517, -0.264742466936063], pref=_PI_)
NiNi1P11 = _logpoly(
    [-38.031557701992455, -1.615788958431633, 0.232342802535233,
     -0.015601342343555, 0.000385790678744], pref=_PI_)
N2N211 = _logpoly([-42.225712551892755, -0.229958945507976], pref=_PI_)
N2N222 = _logpoly([-42.077467697607034, -0.229160550336776], pref=_PI_)
N2N21P11 = _logpoly(
    [-96.770585022102779, 29.148723006721372, -5.530060545847180,
     0.455326558461576, -0.013842724823926])
N2Ni1P11 = _logpoly(
    [-7.070758182949830, 4.845317363412498, -1.458758839937497,
     0.233156378931474, -0.020896682219994, 0.000996062674946,
     -0.000019731218085], scale=100.0)
NiN21P11 = N2Ni1P11
N2Ni11 = _logpoly(
    [24.496049925340895, -27.786968224881310, 4.261190501951376,
     -0.293139208272160, 0.007561754781801], pref=_PI_)
N2Ni22 = _logpoly(
    [-62.712016967753847, 7.212207597803123, -0.988167069227977,
     0.056255946061936, -0.001145315858929], pref=_PI_)

eNi11 = _logpoly(
    [2.583657310241357, -3.338700252668392, 1.384354837198594,
     -0.284334080031242, 0.031157728257488, -0.001750672149711,
     0.000039758329849], scale=100.0)
eNi12 = _logpoly(
    [-1.934755833917042, 1.396606776346035, -0.422114799937392,
     0.067093051236947, -0.005928358157850, 0.000276540278651,
     -0.000005326503633], scale=1000.0)
eNi13 = _logpoly(
    [-2.837349005539165, 2.184292700049795, -0.700859738170989,
     0.118480284536834, -0.011150119826904, 0.000554606302530,
     -0.000011402466225], scale=1000.0)
eNi14 = _logpoly(
    [-1.673254218486384, 1.339721615950149, -0.448694918786985,
     0.078770108123025, -0.007668193507749, 0.000393314841564,
     -0.000008317289766], scale=1000.0)
eNi15 = _logpoly(
    [-1.245791078716272, 1.535014697501557, -0.740292376788452,
     0.162391831811548, -0.018468300738766, 0.001064873335057,
     -0.000024703118057], scale=100.0)
eN211 = _logpoly(
    [-3.847278097767338, 2.151944606452283, -0.537317123236616,
     0.066165032113028, -0.004009615832468, 0.000095579640766], scale=100.0)
eN212 = _logpoly(
    [-5.337534425696322, 3.238333171420736, -0.845936604069987,
     0.109071857868453, -0.006934205079810, 0.000173872831529], scale=100.0)
eN213 = _logpoly(
    [-6.527006679994851, 4.109423857482659, -1.096380242694045,
     0.144466323778224, -0.009393664358810, 0.000241114854285], scale=100.0)
eN214 = eN213
eN215 = _logpoly(
    [-5.131403805671025, 3.295203439069785, -0.914505280894294,
     0.125300650936993, -0.008464520705942, 0.000225459901920], scale=100.0)
