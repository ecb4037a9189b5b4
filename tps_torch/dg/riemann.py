"""Numerical face fluxes: Rusanov (local Lax-Friedrichs) and Roe.

Mirrors reference RiemannSolverTPS (src/riemann_solver.cpp:85-206) as pure
batched functions over face quadrature points.  With swirl (nvel = 3,
the axisymmetric state) the normal has dim components and the azimuthal
momentum is advected by u.n with no pressure term (dg/fluxes.py); Roe is
planar only (the solver refuses it with axisymmetry, as the reference
does).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def flux_dot_n(fluxes, U, nor):
    """F_conv(U) . nor with nor the scaled (non-unit) normal."""
    F = fluxes.convective(U)  # [..., neq, dim]
    return torch.einsum("...ed,...d->...e", F, nor)


@dataclass(frozen=True)
class Rusanov:
    """Local Lax-Friedrichs flux (reference: src/riemann_solver.cpp:89-115)."""

    fluxes: object

    def __call__(self, U1, U2, nor):
        mix = self.fluxes.mixture
        max_e = torch.maximum(mix.max_char_speed(U1), mix.max_char_speed(U2))
        f1 = flux_dot_n(self.fluxes, U1, nor)
        f2 = flux_dot_n(self.fluxes, U2, nor)
        normag = torch.linalg.norm(nor, dim=-1)
        return 0.5 * (f1 + f2) - 0.5 * (max_e * normag)[..., None] * (U2 - U1)


def _dot(a, b):
    return torch.einsum("...d,...d->...", a, b)


@dataclass(frozen=True)
class Roe:
    """Roe flux with an entropy fix on the contact wave (reference:
    src/riemann_solver.cpp:117-206, generalised to 2-D/3-D).  The species
    are upwinded with the contact speed."""

    fluxes: object

    def __call__(self, U1, U2, nor):
        mix = self.fluxes.mixture
        dim = mix.dim
        # the norm is floored at the dtype's tiny: the weight-folded
        # normals (nor_wpf) are exactly zero at padding slots and axis
        # faces, and 0/0 would poison the element's row through the scatter
        normag = torch.clamp(torch.linalg.norm(nor, dim=-1),
                             min=torch.finfo(nor.dtype).tiny)
        n = nor / normag[..., None]

        f1 = flux_dot_n(self.fluxes, U1, n)
        f2 = flux_dot_n(self.fluxes, U2, n)
        mean = 0.5 * (f1 + f2)

        s1 = torch.sqrt(U1[..., 0])
        s2 = torch.sqrt(U2[..., 0])
        r = s1 * s2
        vel = (U1[..., 1:1 + dim] / s1[..., None]
               + U2[..., 1:1 + dim] / s2[..., None]) / (s1 + s2)[..., None]
        qk = _dot(vel, n)

        p1 = mix.pressure(U1)
        p2 = mix.pressure(U2)
        H = ((U1[..., 1 + dim] + p1) / s1
             + (U2[..., 1 + dim] + p2) / s2) / (s1 + s2)
        v2 = torch.sum(vel**2, dim=-1)
        a2 = (mix.specific_heat_ratio - 1.0) * (H - 0.5 * v2)
        a = torch.sqrt(a2)

        lamb0 = torch.where(torch.abs(qk) < 1e-4, 1e-4, qk)
        lamb1 = qk + a
        lamb2 = qk - a

        dP = p2 - p1
        dvel = (U2[..., 1:1 + dim] / U2[..., 0:1]
                - U1[..., 1:1 + dim] / U1[..., 0:1])
        dqk = _dot(dvel, n)
        drho = U2[..., 0] - U1[..., 0]
        # the contact and shear waves
        coef0 = drho - dP / a2
        DF1 = torch.cat(
            [coef0[..., None],
             coef0[..., None] * vel + r[..., None] * (dvel - n * dqk[..., None]),
             (coef0 * 0.5 * v2 + r * (_dot(vel, dvel) - qk * dqk))[..., None]],
            dim=-1) * torch.abs(lamb0)[..., None]
        # the acoustic waves
        alpha_p = 0.5 * (dP + r * a * dqk) / a2
        alpha_m = 0.5 * (dP - r * a * dqk) / a2
        one = torch.ones_like(a)[..., None]
        DFp = torch.cat([one, vel + n * a[..., None], (H + qk * a)[..., None]],
                        dim=-1) * (alpha_p * torch.abs(lamb1))[..., None]
        DFm = torch.cat([one, vel - n * a[..., None], (H - qk * a)[..., None]],
                        dim=-1) * (alpha_m * torch.abs(lamb2))[..., None]
        flux = mean[..., :dim + 2] - 0.5 * (DF1 + DFp + DFm)

        if mix.num_equations > dim + 2:
            # the transported scalars, upwinded with the contact speed
            sc1, sc2 = U1[..., dim + 2:], U2[..., dim + 2:]
            qk1 = _dot(U1[..., 1:1 + dim] / U1[..., 0:1], n)
            qk2 = _dot(U2[..., 1:1 + dim] / U2[..., 0:1], n)
            fs = (0.5 * (qk1[..., None] * sc1 + qk2[..., None] * sc2)
                  - 0.5 * torch.abs(qk)[..., None] * (sc2 - sc1))
            flux = torch.cat([flux, fs], dim=-1)
        return flux * normag[..., None]
