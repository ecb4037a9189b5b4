"""The DG right-hand side of the general (slot) path: one residual evaluation.

The JAX package's dg/rhs.py, single device.  Mirrors the structure of
reference RHSoperator::Mult (src/rhs_operator.cpp:343-464): primitives ->
gradients -> face fluxes -> volume fluxes -> inverse mass, with the max
characteristic speed computed in the same sweep.

The face sweep is the neighbor-slot formulation (tab.nbr_row): every
(element, local face) slot computes its own outward flux from its own
trace and one neighbor trace.  Its interior part is the hand-written CUDA
kernel of dg/cuda_faces.py for CUDA tensors and its plain version,
dg/operators.py's `face_sweep_plain`, for CPU tensors; the boundary slots' BC
fluxes, the gradient, the volume term and the inverse mass are plain
PyTorch, as the JAX package leaves them to XLA.

The characteristic BCs' ghost states (init_bc_states, advance_bc_states)
are the JAX package's; the solver holds them in its step loop's buffers.
Pointwise forcings are added to dU/dt after the inverse mass, as the JAX
package adds them; this port carries one, the plasma source term
(dg/source_term.py).  Not ported here: the other forcings (ROADMAP A5),
the sharded RHS and the legacy point-permutation branch (A8) and boundary
states in the gradient (useBCinGrad, A5).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .cuda_faces import build_face_sweep
from .operators import _clip_species, _not_ported, _scatter_kron, _trace_kron
from .operators import apply_minv2, dg_gradient, volume_weak_div
from .source_term import SourceTerm


@dataclass(frozen=True)
class BCSlice:
    bc: object
    start: int  # static slice bounds into the boundary-face block
    stop: int


def bc_slices(f_bdr_attr, bc_for):
    """One BCSlice per boundary attribute (patch) of the tables, over its
    rows of the boundary-face block (the tables keep each patch's rows
    together), ordered by row.  bc_for(patch) -> its BC, or None where no
    BC is configured, which raises."""
    attrs = np.asarray(f_bdr_attr)
    slices, missing = [], []
    for patch in np.unique(attrs):
        rows = np.where(attrs == patch)[0]
        bc = bc_for(int(patch))
        if bc is None:
            missing.append(int(patch))
            continue
        start, stop = int(rows.min()), int(rows.max()) + 1
        if stop - start != len(rows):
            raise ValueError(f"boundary patch {int(patch)}: its faces are "
                             "not contiguous in the boundary-face block")
        slices.append(BCSlice(bc=bc, start=start, stop=stop))
    if missing:
        raise ValueError(f"no boundary condition for patch(es) {missing}")
    return tuple(sorted(slices, key=lambda s: s.start))


@dataclass(frozen=True)
class RHSContext:
    """Static (non-array) configuration of the DG right-hand side."""

    fluxes: object
    riemann: object
    bcs: tuple = ()
    forcings: tuple = ()
    use_bc_in_grad: bool = False
    axis_name: str | None = None

    @property
    def mixture(self):
        return self.fluxes.mixture


def _bdr_index(tab, lf, device):
    """(elements, rows into the boundary block) of local face lf, as index
    tensors (kept on the tables object, like operators._const)."""
    cache = tab.__dict__.setdefault("_op_cache", {})
    key = ("bdr", lf, device)
    if key not in cache:
        cache[key] = tuple(torch.tensor(v, dtype=torch.long, device=device)
                           for v in tab.bdr_by_lf[lf])
    return cache[key]


def _bc_runs(bcs, bc_states):
    """(bc, start, stop, state) per run of adjacent slices that carry one
    and the same stateless pointwise BC (six identical walls: one flux
    call instead of six; the flux is pointwise, so the values are the
    per-slice ones)."""
    runs = []
    for i, s in enumerate(bcs):
        state = None if bc_states is None else bc_states[i]
        last = runs[-1] if runs else None
        if (last is not None and state is None and last[3] is None
                and getattr(s.bc, "pointwise", False) and last[0] == s.bc
                and last[2] == s.start):
            runs[-1] = (last[0], last[1], s.stop, None)
        else:
            runs.append((s.bc, s.start, s.stop, state))
    return runs


def _boundary_traces(tab, X):
    """The own traces of X [ne, ndof, kx] at the boundary rows, in the
    boundary-face order: ([nfb, nqf, kx], per local face (elements, rows)
    or None)."""
    ne, ndof, kx = X.shape
    X2 = X.reshape(ne, ndof * kx)
    own_b = torch.zeros((tab.nfb, tab.nqf * kx), dtype=X.dtype, device=X.device)
    idx = []
    for lf in range(tab.nlf):
        if not tab.bdr_by_lf[lf][0]:
            idx.append(None)
            continue
        els, rows = _bdr_index(tab, lf, X.device)
        own_b[rows] = X2[els] @ _trace_kron(tab, lf, kx, X)
        idx.append((els, rows))
    return own_b.reshape(tab.nfb, tab.nqf, kx), idx


def boundary_face_sweep(ctx, tab, X, t=0.0, bc_states=None):
    """The boundary slots' part of the face sweep (rhs.py:180-250 of the
    JAX package): sum over boundary slots of Btr_lf^T (BC flux x weights),
    [ne, ndof*neq], with the same sign as the interior sum (before the
    face term's negation)."""
    mix = ctx.mixture
    neq, dim = mix.num_equations, tab.dim
    ne, ndof = X.shape[0], X.shape[1]
    nfi, nfb, nqf = tab.nfi, tab.nfb, tab.nqf
    viscous = ctx.fluxes.eq_system != "euler"
    own_b, idx = _boundary_traces(tab, X)
    ULb = _clip_species(mix, own_b[..., :neq])
    gLb = (own_b[..., neq:].reshape(nfb, nqf, neq, dim) if viscous else None)
    UpLb = mix.primitives(ULb)
    norb = tab.f_nor[nfi:]
    xyzb = tab.f_xyz[nfi:]
    deltab = tab.delta[tab.f_elem_l[nfi:].long()][:, None]
    wmagb = tab.f_wts[nfi:] * torch.linalg.norm(norb, dim=-1)
    covered = sum(s.stop - s.start for s in ctx.bcs)
    if covered != nfb:
        raise ValueError(
            f"boundary faces not fully covered by BCs: {covered} != {nfb}")
    flux_b = torch.cat([
        bc.flux(ctx, ULb[a:b], UpLb[a:b], None if gLb is None else gLb[a:b],
                norb[a:b], xyzb[a:b], deltab[a:b], t, state=state,
                wts=wmagb[a:b])
        for bc, a, b, state in _bc_runs(ctx.bcs, bc_states)], dim=0)
    fwb = tab.f_wts[nfi:]
    if tab.rad_face is not None:
        fwb = fwb * tab.rad_face[nfi:]
    fb2 = (flux_b * fwb[..., None]).reshape(nfb, nqf * neq)
    z2 = torch.zeros((ne, ndof * neq), dtype=X.dtype, device=X.device)
    for lf, ix in enumerate(idx):
        if ix is not None:
            els, rows = ix
            z2.index_add_(0, els, fb2[rows] @ _scatter_kron(tab, lf, neq, X))
    return z2


def compute_rhs(ctx: RHSContext, tab, U, t=0.0, fields=None, bc_states=None,
                sweep=None):
    """Return (dU/dt [ne, ndof, neq], aux) with aux["max_char_speed"].

    tab: the torch tables (DGTables.to_torch).  bc_states: tuple aligned
    with ctx.bcs (None for a stateless BC, the ghost state of a
    characteristic one).  sweep: the
    interior face sweep (dg/cuda_faces.py::CudaFaceSweep); None builds it
    from the tables, which raises for a CUDA tensor outside the kernel's
    preconditions."""
    if ctx.axis_name is not None:
        raise _not_ported("the sharded right-hand side", "A8")
    if any(not isinstance(f, SourceTerm) for f in ctx.forcings):
        raise _not_ported("forcings other than the plasma source term", "A5")
    if tab.nbr_row is None:
        raise _not_ported("the legacy (sharded-table) face sweep", "A8")
    mix = ctx.mixture
    neq = mix.num_equations
    dim = tab.dim
    ne, ndof = U.shape[0], U.shape[1]
    viscous = ctx.fluxes.eq_system != "euler"

    Up = mix.primitives(_clip_species(mix, U))

    # ---- gradients of primitives ----
    grad_up = None
    if viscous:
        if ctx.use_bc_in_grad and ctx.bcs:
            raise _not_ported("boundary states in the gradient (useBCinGrad)",
                              "A5")
        grad_up = dg_gradient(tab, Up)

    # ---- face sweep: interior slots (the kernel), then boundary slots ----
    if viscous:
        X = torch.cat([U, grad_up.reshape(ne, ndof, neq * dim)], dim=-1)
    else:
        X = U
    if sweep is None:
        sweep = build_face_sweep(tab, ctx)
    z2_face = sweep(X.contiguous()).reshape(ne, ndof * neq)  # -sum interior
    if tab.nfb:
        z2_face = z2_face - boundary_face_sweep(ctx, tab, X, t, bc_states)

    # ---- volume term ----
    Uv = _clip_species(mix, U)
    Fdof = ctx.fluxes.total_at_dofs(
        Uv, Up, grad_up, tab.xyz_dof, tab.delta[:, None], distance=tab.distance)
    z2_vol = volume_weak_div(tab, Fdof, fused_out=True)

    y = apply_minv2(tab, z2_vol + z2_face, neq, radial=True).reshape(
        ne, ndof, neq)

    # ---- forcings, added to dU/dt (reference rhs_operator.cpp:452-461)
    for f in ctx.forcings:
        y = y + f(t, tab, U, Up, grad_up, fields)
    aux = {"max_char_speed": torch.amax(mix.max_char_speed(U))}
    return y, aux


@dataclass(eq=False)
class SlotRHS:
    """The solver's right-hand side on the general (slot) path:
    (U [ne, ndof, neq], t) -> (dU/dt, aux).  bc_states: the per-BC states
    it reads (the solver's step-loop buffers, updated in place)."""

    ctx: RHSContext
    tab: object  # torch tables
    sweep: object  # CudaFaceSweep
    bc_states: tuple = ()

    # the solver's layout is the RHS's layout
    def to_fused(self, U):
        return U

    def from_fused(self, U):
        return U

    def __call__(self, U, t=0.0):
        return compute_rhs(self.ctx, self.tab, U, t, bc_states=self.bc_states,
                           sweep=self.sweep)


# ---------------------------------------------------------------------------
# Persistent BC state (time-integrated characteristic ghosts)
# ---------------------------------------------------------------------------

def has_stateful_bcs(ctx: RHSContext) -> bool:
    return any(getattr(s.bc, "has_state", False) for s in ctx.bcs)


def _boundary_interior_data(ctx: RHSContext, tab, U, need_grad):
    """Interior traces at the boundary-face points (the JAX package's
    rhs.py::_boundary_interior_data): (ULb [nfb, nqf, neq], UpLb, gLb
    [nfb, nqf, neq, dim] or None, normals, weights x |n|)."""
    mix = ctx.mixture
    neq, dim = mix.num_equations, tab.dim
    ne, ndof = U.shape[0], U.shape[1]
    X = U
    if need_grad:
        grad = dg_gradient(tab, mix.primitives(_clip_species(mix, U)))
        X = torch.cat([U, grad.reshape(ne, ndof, neq * dim)], dim=-1)
    own_b, _ = _boundary_traces(tab, X.contiguous())
    ULb = _clip_species(mix, own_b[..., :neq])
    gLb = (own_b[..., neq:].reshape(tab.nfb, tab.nqf, neq, dim)
           if need_grad else None)
    norb = tab.f_nor[tab.nfi:]
    wmagb = tab.f_wts[tab.nfi:] * torch.linalg.norm(norb, dim=-1)
    return ULb, mix.primitives(ULb), gLb, norb, wmagb


def init_bc_states(ctx: RHSContext, tab, U):
    """The per-BC state tuple: None for a stateless BC, the interior trace
    for a characteristic one (the ghost starts there)."""
    if not ctx.bcs:
        return ()
    if not has_stateful_bcs(ctx):
        return tuple(None for _ in ctx.bcs)
    ULb = _boundary_interior_data(ctx, tab, U, need_grad=False)[0]
    return tuple(s.bc.init_state(ctx.mixture, ULb[s.start:s.stop]).clone()
                 if getattr(s.bc, "has_state", False) else None
                 for s in ctx.bcs)


def advance_bc_states(ctx: RHSContext, tab, U, bc_states, dt):
    """One step of every stateful BC's ghost state from the state U after
    the step (reference: the boundaryU integration inside computeBdrFlux,
    src/outletBC.cpp:739+ / src/inletBC.cpp:756+); stateless BCs keep
    theirs."""
    if bc_states is None or not has_stateful_bcs(ctx):
        return bc_states
    ULb, UpLb, gLb, norb, wmagb = _boundary_interior_data(ctx, tab, U,
                                                          need_grad=True)
    out = []
    for i, s in enumerate(ctx.bcs):
        if getattr(s.bc, "has_state", False):
            sl = slice(s.start, s.stop)
            out.append(s.bc.advance(ctx, bc_states[i], ULb[sl], UpLb[sl],
                                    gLb[sl], norb[sl], wmagb[sl], dt))
        else:
            out.append(bc_states[i])
    return tuple(out)
