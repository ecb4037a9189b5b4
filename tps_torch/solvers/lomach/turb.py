"""Algebraic LES subgrid models of the low-Mach path.

The port of the JAX package's solvers/lomach/turb.py: Smagorinsky, Sigma
and WALE eddy viscosity over H1 velocity gradients (reference:
src/algebraicSubgridModels.cpp; model constants follow the reference
defaults).  The sigma model's 3-D eigenvalues come from cyclic Jacobi
rotations, a fixed number of sweeps (torch.linalg.eigvalsh checks its
result on the host, which a captured step cannot do).
"""

from __future__ import annotations

import numpy as np
import torch

from ...fem import h1
from .base import TurbModelBase, zeros

# cyclic Jacobi sweeps for a symmetric 3x3 matrix: quadratic convergence
# takes a generic matrix to its eigenvalues in working precision in 4-5
JACOBI_SWEEPS = 6


def sym_eigvals(G):
    """Eigenvalues, ascending, of symmetric [n, d, d] matrices, d = 2 or 3."""
    if G.shape[-1] == 2:
        a, b, c = G[:, 0, 0], G[:, 0, 1], G[:, 1, 1]
        m, r = 0.5 * (a + c), torch.sqrt((0.5 * (a - c)) ** 2 + b * b)
        return torch.stack([m - r, m + r], dim=-1)
    A = G.clone()
    for _ in range(JACOBI_SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            apq, app, aqq = A[:, p, q], A[:, p, p], A[:, q, q]
            small = torch.abs(apq) <= 1e-300
            theta = (aqq - app) / (2.0 * torch.where(small, torch.ones_like(apq), apq))
            t = torch.sign(theta) / (torch.abs(theta)
                                     + torch.sqrt(theta * theta + 1.0))
            t = torch.where(theta == 0, torch.ones_like(t), t)
            t = torch.where(small, torch.zeros_like(t), t)
            c = 1.0 / torch.sqrt(t * t + 1.0)
            s = t * c
            R = torch.eye(3, dtype=G.dtype, device=G.device).repeat(
                G.shape[0], 1, 1)
            R[:, p, p], R[:, q, q], R[:, p, q], R[:, q, p] = c, c, s, -s
            A = R.transpose(1, 2) @ A @ R
    return torch.sort(torch.diagonal(A, dim1=-2, dim2=-1), dim=-1).values


class AlgebraicSubgridModel(TurbModelBase):
    """model: 'smagorinsky' (Cs ~ 0.12), 'sigma' (Cs ~ 1.35), or 'wale'
    (Cw ~ 0.5; reference: src/algebraicSubgridModels.cpp:67-78)."""

    def __init__(self, tab, flow, model="smagorinsky", const=None):
        self.tab = tab
        self.flow = flow
        self.model = model
        if const is None:
            const = {"smagorinsky": 0.12, "sigma": 1.35, "wale": 0.5}[model]
        self.const = const
        # grid scale: per-dof mean of the element lengths around it
        detJc = h1._np(tab.detJ).mean(axis=1)  # ~ elem volume
        h_el = detJc ** (1.0 / tab.dim)
        h_dof = np.zeros(tab.ndofs)
        cnt = np.zeros(tab.ndofs)
        ed = h1._np(tab.elem_dofs)
        np.add.at(h_dof, ed, np.broadcast_to(h_el[:, None], ed.shape))
        np.add.at(cnt, ed, 1.0)
        self.delta = torch.as_tensor(
            h_dof / np.maximum(cnt, 1) / max(tab.order, 1),
            dtype=tab.wq.dtype, device=tab.wq.device)
        self._nut = zeros(tab, tab.ndofs)

    def step(self, coeff, dt, loops=None):
        self._nut.copy_(self.nut_of(self.flow.velocity()))

    def nut_of(self, u):
        """nu_t as a function of the velocity field."""
        tab = self.tab
        # nodal velocity gradient via lumped projection, per component
        g = torch.stack(
            [h1.grad_at_dofs(tab, u[:, d]) for d in range(tab.dim)], dim=1
        )  # [ndofs, comp, dim] = du_comp/dx_dim
        S = 0.5 * (g + g.transpose(1, 2))
        if self.model == "smagorinsky":
            smag = torch.sqrt(2.0 * torch.einsum("nij,nij->n", S, S))
            return (self.const * self.delta) ** 2 * smag
        if self.model == "wale":
            # Nicoud & Ducros 1999 via the Ducros direct formula
            # (reference: src/algebraicSubgridModels.cpp:324-452)
            O = 0.5 * (g - g.transpose(1, 2))  # noqa: E741
            S2 = torch.einsum("nik,nkj->nij", S, S)
            O2 = torch.einsum("nik,nkj->nij", O, O)
            Smag2 = torch.einsum("nij,nij->n", S, S)
            Omag2 = torch.einsum("nij,nij->n", O, O)
            SSOO = torch.einsum("nij,nij->n", S2, O2)
            G2 = torch.clamp(
                (Smag2**2 + Omag2**2) / 6.0
                + (2.0 / 3.0) * Smag2 * Omag2 + 2.0 * SSOO, min=0.0)
            omega = G2**1.5 / torch.clamp(Smag2**2.5 + G2**1.25, min=1e-12)
            return (self.const * self.delta) ** 2 * omega
        # sigma model (Nicoud et al. 2011)
        G = torch.einsum("nki,nkj->nij", g, g)
        ev = torch.clamp(sym_eigvals(G), min=0.0)
        s3, s2, s1 = (torch.sqrt(ev[:, 0]), torch.sqrt(ev[:, 1]),
                      torch.sqrt(ev[:, -1]))
        denom = torch.clamp(s1 * s1, min=1e-30)
        D = s3 * (s1 - s2) * (s2 - s3) / denom
        return (self.const * self.delta) ** 2 * D

    def eddy_viscosity(self):
        return self._nut
