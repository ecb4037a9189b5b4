"""Fused-layout RHS for structured periodic meshes, in plain PyTorch.

On structured generator meshes every element shares the same geometry
factors:

  - Bvol == I          (collocated Gauss-Legendre basis)
  - Minv diagonal and identical for all elements
  - adjJ constant (one dim x dim matrix)
  - face weights/normals identical per (local face, point) slot
  - neighbor traces are pure grid rolls (tab.roll_info)

so the *entire linear part* of the DG operator folds into a few shared
weight matrices acting on a fused (dof*eq) minor dimension:

  gradient: G2 [ne, ndof*neq*dim] = [Up2 | rolls(Up2)] @ K_grad
  traces:   T  [ne, nlf*nqf*neq(*dim)] = U2 @ K_tr (block kron(Btr, I))
  scatter:  y += fluxw2 @ K_face_out   (wts, sign, Minv folded in)
  volume:   y += Fdof2 @ K_vol         (wq, adjJ, Gvol, Minv folded in)

The nonlinear physics (primitives, Riemann, viscous fluxes) runs pointwise
between the matmuls.  This module is the plain PyTorch version of the two
hand-written CUDA kernels in dg/cuda_fused.py (`gradient` is K1's,
`faces_volume` K2's), the CPU path of the solver, and its only path in
2-D.  Hot-loop parity: reference RHSoperator::Mult,
src/rhs_operator.cpp:343-464 and dgNonlinearForm.cpp:90-349.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def fusable(tab_np, ctx) -> bool:
    """Preconditions for the fused path (see module docstring).

    The JAX package's fused path also takes pointwise forcings (chemistry
    SourceTerm, JouleHeating).  Both are ported on the slot path
    (dg/rhs.py), and this path still turns every forcing down: a deck with
    one runs the slot path."""
    t = tab_np
    if t.roll_info is None or t.nfb or ctx.bcs or ctx.forcings:
        return False
    if ctx.fluxes.axisymmetric or getattr(t, "rad_vol", None) is not None:
        return False
    if ctx.fluxes.sgs_model is not None or ctx.fluxes.visc_sponge is not None:
        return False
    if ctx.axis_name is not None:
        return False
    # collocation: the nodal basis must coincide with the volume rule
    # (true for the GL basis + GL 2p rule; NOT for the reference-default
    # GLL/GLL combination, whose 2p rule has p+2 points per dim)
    if t.Bvol.shape[0] != t.Bvol.shape[1]:
        return False
    if not np.allclose(t.Bvol, np.eye(t.nq)):
        return False
    M0 = np.asarray(t.Minv[0])
    if not np.allclose(t.Minv, M0) or not np.allclose(M0, np.diag(np.diag(M0))):
        return False
    if not np.allclose(t.adjJ, t.adjJ[0, 0]):
        return False
    if not (np.allclose(t.wts_slot, t.wts_slot[0:1])
            and np.allclose(t.nor_slot, t.nor_slot[0:1])):
        return False
    return True


@dataclass(frozen=True)
class FusedRHS:
    """Callable fused-layout RHS: (U2 [ne, ndof*neq], t) -> (dU2/dt, aux).

    Face handling is *per local face*: each face's trace lives in its own
    fused buffer [ne, nqf*neq], and the neighbor trace is a pure grid roll
    of the OPPOSITE face's buffer."""

    ctx: object
    ne: int
    ndof: int
    neq: int
    dim: int
    grid: tuple
    per_lf: tuple  # ((axis, shift, opp), ...) from tab.roll_info
    nlf: int
    nqf: int
    K_grad: torch.Tensor  # [(1+nlf)*ndof*neq, ndof*neq*dim]
    KU_lf: tuple  # per face: [ndof*neq, nqf*neq]
    KG_lf: tuple  # per face: [ndof*neq*dim, nqf*neq*dim]
    KO_lf: tuple  # per face: [nqf*neq, ndof*neq]
    K_vol: torch.Tensor  # [ndof*neq*dim, ndof*neq]
    nor_lf: tuple  # per face: [nqf, dim] (shared across elements)
    delta: float  # element size (uniform)

    @property
    def viscous(self) -> bool:
        return self.ctx.fluxes.eq_system != "euler"

    def to_fused(self, U):
        return U.reshape(U.shape[0], -1)

    def from_fused(self, U2):
        return U2.reshape(self.ne, self.ndof, self.neq)

    def _roll(self, A2, axis, shift):
        """Grid roll of a fused per-element buffer [ne, K]: row i of the
        result is the neighbor of element i across the rolled face."""
        Ag = A2.reshape(tuple(self.grid) + (A2.shape[-1],))
        return torch.roll(Ag, shifts=shift, dims=axis).reshape(A2.shape)

    def gradient(self, U2):
        """DG gradient of the primitives, [ne, ndof*neq*dim] with
        (dof, eq, dim) minor order: K1's plain version."""
        Up2 = self.ctx.mixture.primitives(self.from_fused(U2)).reshape(
            self.ne, -1)
        R = torch.cat([Up2] + [self._roll(Up2, a, s)
                               for (a, s, _o) in self.per_lf], dim=-1)
        return R @ self.K_grad

    def faces_volume(self, U2, G2):
        """Volume flux + per-face Rusanov/viscous fluxes, scattered through
        the folded inverse mass: K2's plain version.  G2 is the gradient
        (None for Euler)."""
        ctx = self.ctx
        mix = ctx.mixture
        ne, ndof, neq, dim, nqf = self.ne, self.ndof, self.neq, self.dim, \
            self.nqf
        viscous = self.viscous
        U = self.from_fused(U2)
        Up = mix.primitives(U)
        G4 = G2.reshape(ne, ndof, neq, dim) if viscous else None

        # ---- per-face traces (fused minor dim per face) ----
        TU = [U2 @ K for K in self.KU_lf]  # [ne, nqf*neq] each
        TG = [G2 @ K for K in self.KG_lf] if viscous else None

        # ---- volume flux + scatter ----
        Fdof = ctx.fluxes.total_at_dofs(U, Up, G4, None, None)
        y2 = Fdof.reshape(ne, -1) @ self.K_vol

        # ---- per-face physics: neighbor = grid roll of the opposite
        # face's trace buffer (pure row permutation) ----
        for lf, (axis, shift, opp) in enumerate(self.per_lf):
            own_u = TU[lf].reshape(ne, nqf, neq)
            nbr_u = self._roll(TU[opp], axis, shift).reshape(ne, nqf, neq)
            nor = self.nor_lf[lf]  # [nqf, dim]
            flux = ctx.riemann(own_u, nbr_u, nor)
            if viscous:
                own_g = TG[lf].reshape(ne, nqf, neq, dim)
                nbr_g = self._roll(TG[opp], axis, shift).reshape(
                    ne, nqf, neq, dim)
                Fv1 = ctx.fluxes.viscous(own_u, mix.primitives(own_u), own_g,
                                         xyz=None, delta=self.delta)
                Fv2 = ctx.fluxes.viscous(nbr_u, mix.primitives(nbr_u), nbr_g,
                                         xyz=None, delta=self.delta)
                flux = flux - torch.einsum("...ed,...d->...e",
                                           0.5 * (Fv1 + Fv2), nor)
            y2 = y2 + flux.reshape(ne, nqf * neq) @ self.KO_lf[lf]
        return y2

    def max_char_speed(self, U2):
        return torch.amax(self.ctx.mixture.max_char_speed(self.from_fused(U2)))

    def __call__(self, U2, t=0.0):
        G2 = self.gradient(U2) if self.viscous else None
        y2 = self.faces_volume(U2, G2)
        return y2, {"max_char_speed": self.max_char_speed(U2)}


def build_fused(tab_np, ctx, dtype=None, device=None) -> FusedRHS:
    """Fold the linear DG operators into fused-layout weight matrices."""
    if dtype is None:
        dtype = torch.get_default_dtype()

    t = tab_np
    mix = ctx.mixture
    ndof, nlf, nqf, dim = t.ndof, t.nlf, t.nqf, t.dim
    neq = mix.num_equations
    ne = t.ne
    grid, per_lf = t.roll_info

    B = np.asarray(t.Btr)  # [nlf*nqf, ndof]
    m = np.diag(np.asarray(t.Minv[0]))  # [ndof] diagonal inverse mass
    adj = np.asarray(t.adjJ[0, 0])  # [dim, dim]
    wq = np.asarray(t.wq)  # [nq] == [ndof]
    Gv = np.asarray(t.Gvol)  # [nq, ndof, dim] (ref-space basis gradients)
    w_s = np.asarray(t.wts_slot[0])  # [nlf, nqf]
    n_s = np.asarray(t.nor_slot[0])  # [nlf, nqf, dim]

    eye_e = np.eye(neq)

    # -- gradient fold: scalar maps [ndof -> (j, dd)] then kron over eq --
    # volume: rvol[j,(e,dd)] = wq[j] sum_k Gv[j,d,k] adj[k,dd] Up[d,e]
    S_vol = np.einsum("j,jdk,kD->djD", wq, Gv, adj)  # [d, j, dd]
    # own side of the central face jump: -0.5 w n (Btr Up)
    S_own = np.einsum("sj,s,sD,sd->djD", B, -0.5 * w_s.reshape(-1),
                      n_s.reshape(-1, dim), B)
    S_self = (S_vol + S_own) * m[None, :, None]
    blocks = [S_self]
    for lf, (_axis, _shift, opp) in enumerate(per_lf):
        sl = slice(lf * nqf, (lf + 1) * nqf)
        so = slice(opp * nqf, (opp + 1) * nqf)
        N = np.einsum("sj,s,sD,sd->djD", B[sl], 0.5 * w_s[lf],
                      n_s[lf], B[so])
        blocks.append(N * m[None, :, None])
    # expand each [d, j, dd] block over equations -> [(d,e), (j,e,dd)]
    K_grad = np.concatenate(
        [
            np.einsum("djD,ef->dejfD", blk, eye_e).reshape(
                ndof * neq, ndof * neq * dim
            )
            for blk in blocks
        ],
        axis=0,
    )  # [(1+nlf)*ndof*neq, ndof*neq*dim]

    # -- per-face trace matmuls: kron(Btr[face rows], I) --
    eye_ed = np.eye(neq * dim)
    KU_lf, KG_lf, KO_lf = [], [], []
    for lf in range(nlf):
        sl = slice(lf * nqf, (lf + 1) * nqf)
        KU_lf.append(np.einsum("sd,ef->desf", B[sl], eye_e).reshape(
            ndof * neq, nqf * neq))
        KG_lf.append(np.einsum("sd,gh->dgsh", B[sl], eye_ed).reshape(
            ndof * neq * dim, nqf * neq * dim))
        # face scatter: z[j,e] = -sum_s w[s] Btr[s,j] m[j] flux[s,e]
        KO_lf.append(np.einsum("s,sj,j,ef->sejf", w_s[lf], B[sl], m,
                               eye_e).reshape(nqf * neq, ndof * neq) * (-1.0))

    # -- volume scatter: z[j,e] = sum_{q,dd} wq[q] Gv[q,j,k] adj[k,dd] m[j] F --
    A_vol = np.einsum("q,qjk,kD,j->qDj", wq, Gv, adj, m)  # [q, dd, j]
    K_vol = np.einsum("qDj,ef->qeDjf", A_vol, eye_e).reshape(
        ndof * neq * dim, ndof * neq
    )

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return FusedRHS(
        ctx=ctx, ne=ne, ndof=ndof, neq=neq, dim=dim,
        grid=tuple(int(g) for g in grid), per_lf=tuple(per_lf), nlf=nlf,
        nqf=nqf,
        K_grad=dev(K_grad),
        KU_lf=tuple(dev(K) for K in KU_lf),
        KG_lf=tuple(dev(K) for K in KG_lf),
        KO_lf=tuple(dev(K) for K in KO_lf),
        K_vol=dev(K_vol),
        nor_lf=tuple(dev(n_s[lf]) for lf in range(nlf)),
        delta=float(np.asarray(t.delta).flat[0]),
    )


def maybe_build_fused(tab_np, ctx, dtype=None, device=None):
    """FusedRHS when the preconditions hold, else None."""
    if not fusable(tab_np, ctx):
        return None
    return build_fused(tab_np, ctx, dtype, device)
