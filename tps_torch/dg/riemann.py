"""Numerical face fluxes: Rusanov (local Lax-Friedrichs).

Mirrors reference RiemannSolverTPS (src/riemann_solver.cpp:85-206) as pure
batched functions over face quadrature points.  With swirl (nvel = 3,
the axisymmetric state) the normal has dim components and the azimuthal
momentum is advected by u.n with no pressure term (dg/fluxes.py).  Roe
waits for its own slice (ROADMAP A5.3).
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
