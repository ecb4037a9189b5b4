"""Algebraic subgrid-scale (LES) models of the compressible DG path, on
torch tensors.

The JAX package's dg/sgs.py (reference: src/fluxes.cpp sgsSmag /
sgsSigma; constants 0.12 / 0.135, a floor shift on the grid scale):
callables `(U, grad_up, delta) -> mu_sgs` that dg/fluxes.py's `Fluxes`
takes as `sgs_model`.  The compressible solver builds Smagorinsky and
Sigma (`[flow] sgsModel`); Wale is the JAX module's third model, which no
configuration of either package builds.  Sigma takes its singular values
from torch.linalg.eigvalsh on the CPU (the JAX package's LAPACK) and from
the closed form of the face kernel on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def _velocity_gradient(mixture, grad_up):
    dim = mixture.dim
    return grad_up[..., 1:1 + dim, :dim]


def _scale(U, delta, const, floor):
    """(C (delta - floor)^+)^2 with delta broadcast to U's points."""
    dd = delta if delta.dim() == U.dim() - 1 else delta[..., 0]
    d = const * torch.clamp(dd - floor, min=0.0)
    return d * d


@dataclass(frozen=True)
class Smagorinsky:
    """mu_sgs = rho (Cd (delta - floor))^2 |S| with |S| = sqrt(2 S:S)."""

    mixture: object
    const: float = 0.12
    floor: float = 0.0

    def __call__(self, U, grad_up, delta):
        gv = _velocity_gradient(self.mixture, grad_up)
        S = 0.5 * (gv + torch.transpose(gv, -1, -2))
        smag = torch.sqrt(2.0 * torch.sum(S * S, dim=(-2, -1)))
        return U[..., 0] * _scale(U, delta, self.const, self.floor) * smag


@dataclass(frozen=True)
class Wale:
    """Wall-adapting local eddy viscosity (Nicoud & Ducros 1999), with the
    Ducros direct formula for Sd:Sd (default constant 0.5):
      G^2 = 1/6 (|S|^4 + |O|^4) + 2/3 |S|^2 |O|^2 + 2 S^2:O^2
      nu_t = (Cd d)^2 G^3 / (|S|^5 + G^{5/2})
    """

    mixture: object
    const: float = 0.5
    floor: float = 0.0

    def __call__(self, U, grad_up, delta):
        gv = _velocity_gradient(self.mixture, grad_up)
        gT = torch.transpose(gv, -1, -2)
        S = 0.5 * (gv + gT)
        O = 0.5 * (gv - gT)
        S2 = torch.einsum("...ik,...kj->...ij", S, S)
        O2 = torch.einsum("...ik,...kj->...ij", O, O)
        Smag2 = torch.sum(S * S, dim=(-2, -1))
        Omag2 = torch.sum(O * O, dim=(-2, -1))
        SSOO = torch.sum(S2 * O2, dim=(-2, -1))
        G2 = torch.clamp((Smag2**2 + Omag2**2) / 6.0
                         + (2.0 / 3.0) * Smag2 * Omag2 + 2.0 * SSOO, min=0.0)
        omega = G2**1.5 / torch.clamp(Smag2**2.5 + G2**1.25, min=1e-12)
        return U[..., 0] * _scale(U, delta, self.const, self.floor) * omega


@dataclass(frozen=True)
class Sigma:
    """Nicoud et al. (PoF 2011) sigma model:
    mu_sgs = rho (Cd d)^2 s3 (s1 - s2)(s2 - s3) / s1^2 with s_i the
    singular values of the velocity gradient, descending.  In 2-D s3 = 0,
    so the model is zero there."""

    mixture: object
    const: float = 0.135
    floor: float = 0.0

    def __call__(self, U, grad_up, delta):
        dim = self.mixture.dim
        gv = _velocity_gradient(self.mixture, grad_up)
        Q = torch.einsum("...ki,...kj->...ij", gv, gv)  # g^T g (sym psd)
        scale = U[..., 0] * _scale(U, delta, self.const, self.floor)
        if Q.is_cuda:
            # cuSOLVER's batched eigensolver takes a limited batch and
            # reads its status on the host (no step graph could hold it):
            # on the card the eigenvalues are the closed form's, the face
            # kernel's (csrc/dg_pointwise.cuh::sym3_eigenvalues)
            if dim < 3:
                return scale * (0.0 * Q.sum(dim=(-2, -1)))
            s1, s2, s3 = torch.sqrt(torch.clamp(_sym3_eigenvalues(Q),
                                                min=0.0)).unbind(-1)
            num = torch.clamp(s3 * (s1 - s2) * (s2 - s3), min=0.0)
            return scale * (num / torch.clamp(s1 * s1, min=1e-24))
        ev = torch.clamp(torch.linalg.eigvalsh(Q), min=0.0)  # ascending
        s_desc = torch.sqrt(torch.flip(ev, dims=(-1,)))
        s1 = s_desc[..., 0]
        zero = torch.zeros_like(s1)
        s2 = s_desc[..., 1] if dim > 1 else zero
        s3 = s_desc[..., 2] if dim > 2 else zero
        num = torch.clamp(s3 * (s1 - s2) * (s2 - s3), min=0.0)
        D = num / torch.clamp(s1 * s1, min=1e-24)
        return scale * D


def _sym3_eigenvalues(Q):
    """The eigenvalues of symmetric 3x3 matrices Q [..., 3, 3], descending,
    by the trigonometric solution of the characteristic cubic."""
    q01, q02, q12 = Q[..., 0, 1], Q[..., 0, 2], Q[..., 1, 2]
    tr = (Q[..., 0, 0] + Q[..., 1, 1] + Q[..., 2, 2]) / 3.0
    a, b, c = Q[..., 0, 0] - tr, Q[..., 1, 1] - tr, Q[..., 2, 2] - tr
    p2 = a * a + b * b + c * c + 2.0 * (q01 * q01 + q02 * q02 + q12 * q12)
    p = torch.sqrt(p2 / 6.0)
    pos = p2 > 0.0
    det = (a * (b * c - q12 * q12) - q01 * (q01 * c - q12 * q02)
           + q02 * (q01 * q12 - b * q02))
    r = torch.where(pos, det / torch.where(pos, 2.0 * p * p * p, 1.0), 0.0)
    phi = torch.acos(torch.clamp(r, -1.0, 1.0)) / 3.0
    e1 = tr + 2.0 * p * torch.cos(phi)
    e3 = tr + 2.0 * p * torch.cos(phi + 2.0943951023931957)
    return torch.stack([e1, 3.0 * tr - e1 - e3, e3], dim=-1)
