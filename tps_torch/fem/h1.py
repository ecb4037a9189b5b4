"""Continuous H1 finite-element substrate of the low-Mach solver family.

The port of the JAX package's fem/h1.py (tps_tpu/fem/h1.py).  Three
parts:

- the set-up, numpy (`H1Tables`, `build_h1`, `boundary_dofs`,
  `build_p_interp`): a copy of the JAX package's, pinned to it bit for bit
  by tests/test_torch_h1.py; `to_torch` in place of `to_jax`, and
  `h1_tables_from_numpy` to take that package's tables as they are;
- the matrix-free operators, PyTorch: fields live in a global dof vector
  [ndofs] or [ndofs, k]; an operator gathers element dofs with one
  `index_select` on `elem_dofs`, does small dense per-element quadrature
  matmuls, and assembles back through the assembly transpose
  `dof_gather` (a gather and a sum, so the result does not depend on the
  order in which atomics land: an operator gives the same bits on every
  run, and CG the same iteration counts);
- the solvers: preconditioned CG (`cg_solve`, `cg_solve_multi`) with
  Jacobi, Chebyshev, two-level p-multigrid and a lagged dense Cholesky
  factor as preconditioners.

CG runs in blocks of `block` masked iterations.  Once sum(r*r) <= atol2
(or the iteration cap is reached) on the device, every later iteration
of the block leaves x, r, p and r.z as they are (a `torch.where` on a
device flag), so the result is that of the iteration at which the JAX
package's `lax.while_loop` stops, and the iteration count stays on the
device.  Who runs the blocks is the caller's `loops` object: by default
the host runs one block at a time and reads the block's done flag; the
low-Mach step loop (solvers/lomach/step_graph.py) captures a block as a
CUDA graph and replays it.

Not here: the element-sharded assembly (ShardedH1, ROADMAP A8), the
TPU's mod-row gather and explicit inverse factor (ROADMAP, "Not to
port"); GMRES, for the EM solve, is fem/krylov.py.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..mesh.mesh import Mesh
from ..mesh.reference_element import ReferenceElement

# masked CG iterations a block (module doc).  One: an iteration past
# convergence costs as much as any (~1.7 ms for a p-multigrid one on the
# card), more than the reads a longer block saves, and the step loop's
# speculative blocks keep the reads at about two a solve
# (tps_torch/tools/cg_blocks.py times the choice; PERF.md has the runs)
CG_BLOCK = 1
# the dense direct preconditioner applies up to this many dofs
# (tps_tpu/fem/h1.py:786, its default)
DENSE_DIRECT_MAX = 12000


@dataclass
class H1Tables:
    """Static tables for one H1 space (numpy; `to_torch` for the device)."""

    dim: int
    order: int
    ne: int
    ndof_el: int
    nq: int
    ndofs: int  # global dofs
    nqf: int
    nbf: int  # boundary faces

    elem_dofs: np.ndarray  # [ne, ndof_el] global ids
    Bvol: np.ndarray  # [nq, ndof_el]
    Gvol: np.ndarray  # [nq, ndof_el, dim]
    wq: np.ndarray  # [nq]
    adjJ: np.ndarray  # [ne, nq, dim, dim]
    detJ: np.ndarray  # [ne, nq]
    xyz: np.ndarray  # [ndofs, dim] global dof coordinates
    xyz_q: np.ndarray  # [ne, nq, dim] quad-point coordinates

    # boundary faces (for Dirichlet marking + surface integrals)
    bf_elem: np.ndarray  # [nbf]
    bf_attr: np.ndarray  # [nbf]
    bf_Btr: np.ndarray  # [nbf, nqf, ndof_el] element-basis trace
    bf_nor: np.ndarray  # [nbf, nqf, dim] scaled outward normal
    bf_wts: np.ndarray  # [nbf, nqf]
    bf_xyz: np.ndarray  # [nbf, nqf, dim]

    # the JAX package's element-sharded assembly pads elements and masks
    # them with this; a port table never has it (sharding is ROADMAP A8)
    elem_valid: np.ndarray | None = None
    # assembly transpose: for each global dof, the flat (elem*ndof_el+local)
    # slots contributing to it, padded with the sentinel ne*ndof_el (reads a
    # zero row); scatter_add is a gather and a sum over it
    dof_gather: np.ndarray | None = None

    def to_torch(self, dtype, device):
        """A copy whose arrays are tensors on `device` (floats in `dtype`),
        with the operators' derived tables attached (flat index vectors,
        the metric, the lumped mass), all computed here, before any step
        could be captured."""
        if self.elem_valid is not None:
            raise NotImplementedError(
                "an element-sharded H1 space is not ported to tps_torch yet "
                "(ROADMAP A8)")
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                if np.issubdtype(v.dtype, np.floating):
                    out[f.name] = torch.as_tensor(v, dtype=dtype, device=device)
                else:
                    out[f.name] = torch.as_tensor(v, device=device)
            else:
                out[f.name] = v
        tab = H1Tables(**out)
        _attach_derived(tab, self)
        return tab


def _attach_derived(tab, tab_np):
    """Per-table constants of the operators (a hoisting the JAX package
    leaves to XLA)."""
    dev = tab.wq.device
    ne, nde, nq, dim = tab.ne, tab.ndof_el, tab.nq, tab.dim
    tab.ed_flat = torch.as_tensor(
        np.asarray(tab_np.elem_dofs).reshape(-1).astype(np.int64), device=dev)
    dg = np.asarray(tab_np.dof_gather)
    tab.kmax = dg.shape[1]
    tab.dg_flat = torch.as_tensor(dg.reshape(-1).astype(np.int64), device=dev)
    tab.wdet = tab.wq[None, :] * tab.detJ  # [ne, nq]
    # metric A[m, l] = (adjJ adjJ^T)[m, l] / detJ, as [ne, dim, dim, nq]
    A = torch.einsum("nqmd,nqld->nmlq", tab.adjJ, tab.adjJ)
    tab.metric = (A / tab.detJ[:, None, None, :]).contiguous()
    # reference gradients side by side: Gcat[d, l*nq + q] = Gvol[q, d, l]
    tab.Gcat = tab.Gvol.permute(1, 2, 0).reshape(nde, dim * nq).contiguous()
    tab.BT = tab.Bvol.t().contiguous()
    tab.ml = mass_lumped_diag(tab)
    # surface_normal_form's assembly: the boundary elements' dofs, the
    # distinct ones, and the transpose table from them to their slots
    ed = np.asarray(tab_np.elem_dofs)[np.asarray(tab_np.bf_elem)]
    bdofs, inv = np.unique(ed.reshape(-1), return_inverse=True)
    tab.bf_dofs = torch.as_tensor(ed.astype(np.int64), device=dev)
    tab.bf_uniq = torch.as_tensor(bdofs.astype(np.int64), device=dev)
    tab.bf_table = torch.as_tensor(
        _transpose_table(inv.reshape(-1), len(bdofs)).reshape(-1), device=dev)
    tab.dense_table = None  # assemble_dense's, built on its first call


def h1_tables_from_numpy(obj) -> H1Tables:
    """The port's H1Tables from any object with H1Tables' fields holding
    numpy arrays (the JAX package's numpy tables): the carry-over of that
    package's set-up."""
    out = {}
    for f in fields(H1Tables):
        v = getattr(obj, f.name)
        out[f.name] = np.asarray(v) if hasattr(v, "__array__") else v
    return H1Tables(**out)


def build_h1(mesh: Mesh, order: int, quad_order: int | None = None) -> H1Tables:
    ref = ReferenceElement(geom=mesh.geom, order=order, basis="gauss-lobatto")
    dim = ref.dim
    ne = mesh.num_elements
    ndof_el = ref.ndof
    if quad_order is None:
        quad_order = 2 * order + 2

    pts, wq = ref.volume_quadrature(quad_order)

    Bvol = ref.eval_basis(pts)
    Gvol = ref.eval_basis_grad(pts)

    elem_verts = mesh.vertices[mesh.elements]
    Nq = ref.eval_geom_basis(pts)  # [nq, nverts]
    xyz_q = np.einsum("qv,nvi->nqi", Nq, elem_verts)
    dN = ref.eval_geom_basis_grad(pts)
    J = np.einsum("nvi,qvj->nqij", elem_verts, dN)
    detJ = np.linalg.det(J)
    if np.any(detJ <= 0):
        raise ValueError("non-positive Jacobians in H1 build")
    adjJ = detJ[..., None, None] * np.linalg.inv(J)

    # global dof numbering by coordinate matching (handles conforming meshes)
    Ng = ref.eval_geom_basis(ref.nodes)
    node_xyz = np.einsum("dv,nvi->ndi", Ng, elem_verts)  # [ne, ndof_el, dim]
    flat = node_xyz.reshape(-1, dim)
    scale = max(np.abs(mesh.vertices).max(), 1.0)

    def _key(arr):
        return np.round(arr / scale * 1e10).astype(np.int64)

    key = _key(flat)
    _, inverse = np.unique(key, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    ndofs = int(inverse.max()) + 1
    xyz = np.zeros((ndofs, dim))
    xyz[inverse] = flat

    # periodic gluing: merge dofs identified by the mesh's periodic shifts
    # (side-a coords + shift land on side-b dofs; interior dofs shift out of
    # the domain and never collide)
    if mesh.periodic_pairs:
        keymap = {tuple(k): i for i, k in enumerate(_key(xyz))}
        parent = np.arange(ndofs)

        def find(i):
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        shifts = {tuple(np.round(np.asarray(s), 12)) for _, _, s in mesh.periodic_pairs}
        for s in shifts:
            shifted = _key(xyz + np.asarray(s))
            for i, k in enumerate(shifted):
                j = keymap.get(tuple(k))
                if j is not None and j != i:
                    ri, rj = find(i), find(j)
                    if ri != rj:
                        parent[max(ri, rj)] = min(ri, rj)
        roots = np.array([find(i) for i in range(ndofs)])
        uniq_roots, new_ids = np.unique(roots, return_inverse=True)
        inverse = new_ids[inverse]
        ndofs = len(uniq_roots)
        xyz = xyz[uniq_roots]

    elem_dofs = inverse.reshape(ne, ndof_el).astype(np.int32)

    # assembly-transpose gather table (see H1Tables.dof_gather)
    flat_ids = elem_dofs.reshape(-1)
    order_ = np.argsort(flat_ids, kind="stable")
    sorted_ids = flat_ids[order_]
    counts = np.bincount(flat_ids, minlength=ndofs)
    Kmax = int(counts.max()) if len(counts) else 0
    starts = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(len(sorted_ids)) - starts[sorted_ids]
    dof_gather = np.full((ndofs, Kmax), ne * ndof_el, dtype=np.int32)
    dof_gather[sorted_ids, pos] = order_

    # boundary faces, in element order (e, local face): the order of the
    # JAX package's native set-up kernel, which this module's numpy face
    # grouping gives in another order
    faces = mesh.build_faces()
    nlf = len(mesh.local_faces)
    perm = np.argsort(faces.bdr_elem.astype(np.int64) * nlf + faces.bdr_lf,
                      kind="stable")
    bdr_elem, bdr_lf = faces.bdr_elem[perm], faces.bdr_lf[perm]
    bdr_attr = faces.bdr_attr[perm]
    nbf = len(bdr_elem)
    fq_pts, fq_w = ref.face_quadrature(2 * order + 2)
    nqf = fq_pts.shape[0]
    bf_Btr = np.zeros((nbf, nqf, ndof_el))
    bf_nor = np.zeros((nbf, nqf, dim))
    bf_wts = np.broadcast_to(fq_w, (nbf, nqf)).copy()
    bf_xyz = np.zeros((nbf, nqf, dim))
    elem_centers = elem_verts.mean(axis=1)
    for k in range(nbf):
        e, lf = int(bdr_elem[k]), int(bdr_lf[k])
        rc = ref.face_ref_coords(lf, fq_pts)
        bf_Btr[k] = ref.eval_basis(rc)
        Nf = ref.eval_geom_basis(rc)
        bf_xyz[k] = Nf @ elem_verts[e]
        tang = ref.face_ref_tangents(lf, fq_pts)
        dNf = ref.eval_geom_basis_grad(rc)
        Jf = np.einsum("vi,qvj->qij", elem_verts[e], dNf)
        tph = np.einsum("qij,qjk->qik", Jf, tang)
        if dim == 2:
            nor = np.stack([tph[:, 1, 0], -tph[:, 0, 0]], axis=-1)
        else:
            nor = np.cross(tph[..., 0], tph[..., 1])
        sgn = np.sign(nor[0] @ (bf_xyz[k].mean(axis=0) - elem_centers[e]))
        bf_nor[k] = nor * (sgn if sgn != 0 else 1.0)

    return H1Tables(
        dim=dim, order=order, ne=ne, ndof_el=ndof_el, nq=pts.shape[0],
        ndofs=ndofs, nqf=nqf, nbf=nbf,
        elem_dofs=elem_dofs, Bvol=Bvol, Gvol=Gvol, wq=wq, adjJ=adjJ,
        detJ=detJ, xyz=xyz, xyz_q=xyz_q,
        bf_elem=bdr_elem.astype(np.int32),
        bf_attr=bdr_attr.astype(np.int32),
        bf_Btr=bf_Btr, bf_nor=bf_nor, bf_wts=bf_wts, bf_xyz=bf_xyz,
        dof_gather=dof_gather,
    )


def boundary_dofs(tab, attrs=None) -> np.ndarray:
    """Global dof ids on boundary faces (optionally restricted to attrs).
    Set-up side numpy; takes numpy or torch tables."""
    bf_attr = _np(tab.bf_attr)
    sel = np.ones(len(bf_attr), dtype=bool) if attrs is None else np.isin(
        bf_attr, list(attrs)
    )
    btr = np.abs(_np(tab.bf_Btr)).max(axis=1) > 1e-8  # [nbf, ndof_el]
    ed = _np(tab.elem_dofs)
    be = _np(tab.bf_elem)
    ids = set()
    for k in np.where(sel)[0]:
        for d in ed[be[k]][btr[k]]:
            ids.add(int(d))
    return np.array(sorted(ids), dtype=np.int32)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def build_p_interp(tab_f, tab_c, mesh):
    """Prolongation data between the order-1 and order-p H1 spaces on the
    same mesh (two-level p-multigrid), numpy, as the JAX package's
    (tps_tpu/fem/h1.py:693-725):

      prolong(uc)  = sum_v P_wts[:, v] * uc[P_ids[:, v]]
      restrict(rf) = the exact transpose
      c2f maps each coarse dof to its collocated fine dof (coefficient
      injection).

    Returns (P_ids [nf, nvert], P_wts [nf, nvert], c2f [nc])."""
    ref_f = ReferenceElement(geom=mesh.geom, order=tab_f.order,
                             basis="gauss-lobatto")
    # coarse vertex basis at the fine reference nodes == geometric basis
    Pe = ref_f.eval_geom_basis(ref_f.nodes)  # [ndof_f_el, nvert]
    nvert = Pe.shape[1]
    nf = tab_f.ndofs
    ed_f = _np(tab_f.elem_dofs)  # [ne, ndof_f_el]
    ed_c = _np(tab_c.elem_dofs)  # [ne, nvert]
    P_ids = np.zeros((nf, nvert), dtype=np.int32)
    P_wts = np.zeros((nf, nvert))
    P_ids[ed_f] = ed_c[:, None, :]
    P_wts[ed_f.reshape(-1)] = np.tile(Pe, (ed_f.shape[0], 1))
    # coarse -> fine collocation (coarse nodes are mesh vertices, which are
    # also fine Gauss-Lobatto nodes)
    c2f = np.zeros(tab_c.ndofs, dtype=np.int32)
    for v in range(nvert):
        hit_v = int(np.where(np.abs(Pe[:, v] - 1.0) < 1e-12)[0][0])
        c2f[ed_c[:, v]] = ed_f[:, hit_v]
    return P_ids, P_wts, c2f


def _transpose_table(ids, n):
    """For each target id in 0..n-1, the flat positions of `ids` that hold
    it, padded with the sentinel len(ids) (the gather-and-sum form of a
    scatter-add, as dof_gather)."""
    ids = np.asarray(ids).reshape(-1)
    order = np.argsort(ids, kind="stable")
    counts = np.bincount(ids, minlength=n)
    kmax = max(int(counts.max()) if len(counts) else 0, 1)
    starts = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(len(ids)) - starts[ids[order]]
    table = np.full((n, kmax), len(ids), dtype=np.int64)
    table[ids[order], pos] = order
    return table


@dataclass
class PInterp:
    """The p-multigrid transfer on the device: P_ids/P_wts as
    build_p_interp's, c2f, and the restriction's transpose table."""

    P_ids: torch.Tensor  # [nf, nvert] int64
    P_wts: torch.Tensor  # [nf, nvert]
    c2f: torch.Tensor  # [nc] int64
    R_ids: torch.Tensor  # [nc * kr] int64 flat positions of P_ids
    nc: int

    @classmethod
    def from_numpy(cls, P_ids, P_wts, c2f, nc, dtype, device):
        table = _transpose_table(P_ids, nc)
        return cls(
            P_ids=torch.as_tensor(np.asarray(P_ids, np.int64), device=device),
            P_wts=torch.as_tensor(P_wts, dtype=dtype, device=device),
            c2f=torch.as_tensor(np.asarray(c2f, np.int64), device=device),
            R_ids=torch.as_tensor(table.reshape(-1), device=device), nc=nc)

    def prolong(self, uc):
        nf, nv = self.P_ids.shape
        return torch.sum(
            self.P_wts * uc.index_select(0, self.P_ids.reshape(-1)).view(nf, nv),
            dim=-1)

    def restrict(self, rf):
        vals = (self.P_wts * rf[:, None]).reshape(-1)
        vals = torch.cat((vals, vals.new_zeros(1)))
        return vals.index_select(0, self.R_ids).view(self.nc, -1).sum(-1)


# --------------------------------------------------------------------------
# matrix-free operator applications
#
# Fields are [ndofs] (scalar) or [ndofs, k] (k-component).  The hot
# operators work on columns folded into the element axis, [k, ne, nde],
# so each quadrature contraction is one matmul over k*ne rows.
# --------------------------------------------------------------------------


def gather(tab, u):
    """u [ndofs(, k)] -> element-local [ne, ndof_el(, k)]."""
    return u.index_select(0, tab.ed_flat).view(
        (tab.ne, tab.ndof_el) + tuple(u.shape[1:]))


def scatter_add(tab, r_el):
    """[ne, ndof_el, ...] -> [ndofs, ...] assembly: a gather over the
    assembly transpose dof_gather and a sum."""
    rest = tuple(r_el.shape[2:])
    flat = r_el.reshape((tab.ne * tab.ndof_el,) + rest)
    flat = torch.cat((flat, flat.new_zeros((1,) + rest)))
    return flat.index_select(0, tab.dg_flat).view(
        (tab.ndofs, tab.kmax) + rest).sum(1)


def _gather_k(tab, uu):
    """uu [ndofs, k] -> [k * ne, ndof_el], columns folded into the rows."""
    k = uu.shape[1]
    return uu.t().contiguous().index_select(1, tab.ed_flat).view(
        k * tab.ne, tab.ndof_el)


def _scatter_k(tab, re, k):
    """[k * ne, ndof_el] -> [ndofs, k]: scatter_add of each column."""
    flat = re.reshape(k, tab.ne * tab.ndof_el)
    flat = torch.cat((flat, flat.new_zeros((k, 1))), dim=1)
    out = flat.index_select(1, tab.dg_flat).view(k, tab.ndofs, tab.kmax)
    return out.sum(-1).t()


def _promote(u):
    if u.ndim == 1:
        return u[:, None], True
    return u, False


def _coef_q(tab, coef):
    """Coefficient at quad points: None | scalar | nodal [ndofs] |
    quad-point [ne, nq]."""
    if coef is None or not isinstance(coef, torch.Tensor):
        return coef  # None or a Python scalar
    if coef.ndim in (0, 2):
        return coef  # scalar tensor, or already at quad points
    return gather(tab, coef) @ tab.BT


def to_quad(tab, u):
    """Nodal field -> quad-point values [ne, nq]."""
    return gather(tab, u) @ tab.BT


def weak_grad(tab, s, coef=None):
    """r[dof, d] = (v, c ds/dx_d): weak-gradient linear form (numerator of
    an L2 gradient projection)."""
    gq = torch.einsum("qdk,nd->nqk", tab.Gvol, gather(tab, s))
    gphys = torch.einsum("nqk,nqkd->nqd", gq, tab.adjJ)  # carries detJ
    cq = _coef_q(tab, coef)
    if cq is not None:
        gphys = gphys * (cq[..., None] if isinstance(cq, torch.Tensor)
                         and cq.ndim else cq)
    re = torch.einsum("qd,nqi->ndi", tab.Bvol * tab.wq[:, None], gphys)
    return scatter_add(tab, re)


def mass_apply(tab, u, coef=None):
    """(v, c u)."""
    uu, squeeze = _promote(u)
    w = tab.wdet
    cq = _coef_q(tab, coef)
    if cq is not None:
        w = w * cq
    k = uu.shape[1]
    uq = (_gather_k(tab, uu) @ tab.BT).view(k, tab.ne, tab.nq)
    re = (w * uq).view(k * tab.ne, tab.nq) @ tab.Bvol
    out = _scatter_k(tab, re, k)
    return out[:, 0] if squeeze else out


def _stiff_weights(tab, coef):
    """wq times the coefficient at quad points: [1, nq] or [ne, nq]."""
    w = tab.wq[None, :]
    cq = _coef_q(tab, coef)
    return w if cq is None else w * cq


def _stiff_k(tab, uek, w, k):
    """[k*ne, nde] element values -> (grad v, w grad u) element residuals
    [k*ne, nde]; w [1 | ne | k*ne, nq] weights at quad points."""
    ne, nq, dim = tab.ne, tab.nq, tab.dim
    g = (uek @ tab.Gcat).view(k, ne, 1, dim, nq)
    h = torch.sum(tab.metric[None] * g, dim=3)  # [k, ne, dim, nq]
    h = h * w.view(-1, 1 if w.shape[0] == 1 else ne, 1, nq)
    return h.reshape(k * ne, dim * nq) @ tab.Gcat.t()


def diffusion_apply(tab, u, coef=None):
    """(grad v, c grad u) -- the stiffness apply."""
    uu, squeeze = _promote(u)
    k = uu.shape[1]
    re = _stiff_k(tab, _gather_k(tab, uu), _stiff_weights(tab, coef), k)
    out = _scatter_k(tab, re, k)
    return out[:, 0] if squeeze else out


def mass_lumped_diag(tab, coef=None):
    """Row-sum (lumped) mass diagonal for Jacobi preconditioning."""
    w = tab.wdet
    cq = _coef_q(tab, coef)
    if cq is not None:
        w = w * cq
    return scatter_add(tab, w @ tab.Bvol)


def mass_diag(tab, coef=None):
    """True diagonal of the (coefficient-weighted) mass matrix,
    M_ii = int c phi_i^2."""
    w = tab.wdet
    cq = _coef_q(tab, coef)
    if cq is not None:
        w = w * cq
    return scatter_add(tab, w @ (tab.Bvol * tab.Bvol))


def l2_project(tab, rhs_weak, coef=None, tol=1e-12, maxiter=60, M=None,
               return_info=False, loops=None):
    """Solve the consistent mass system M x = rhs_weak by Jacobi-CG
    (`M`: a dense-direct mass factor preconditioner, where the caller has
    one)."""
    return cg_solve(
        lambda v: mass_apply(tab, v, coef=coef), rhs_weak,
        diag=mass_diag(tab, coef), tol=tol, maxiter=maxiter, M=M,
        return_info=return_info, loops=loops,
    )


def stiffness_diag(tab, coef=None):
    """Diagonal of the stiffness operator (Jacobi preconditioner)."""
    w = _stiff_weights(tab, coef)
    return scatter_add(tab, torch.einsum(
        "qdk,nklq,qdl,nq->nd", tab.Gvol, tab.metric, tab.Gvol,
        w.expand(tab.ne, tab.nq)))


def grad_at_dofs(tab, u):
    """Lumped-mass L2 projection of grad(u): [ndofs] -> [ndofs, dim]."""
    return weak_grad(tab, u) / tab.ml[:, None]


def convection_apply(tab, u, vel):
    """(v, (w . grad) u) with advecting velocity [ndofs, dim]."""
    uu, squeeze = _promote(u)
    vq = torch.einsum("qd,ndi->nqi", tab.Bvol, gather(tab, vel))
    gq = torch.einsum("qdl,ndk->nqlk", tab.Gvol, gather(tab, uu))
    gphys = torch.einsum("nqlk,nqld->nqdk", gq, tab.adjJ)  # carries detJ
    conv = torch.einsum("nqi,nqik->nqk", vq, gphys)
    re = torch.einsum("qd,nqk->ndk", tab.Bvol, tab.wq[None, :, None] * conv)
    out = scatter_add(tab, re)
    return out[:, 0] if squeeze else out


def weak_divergence(tab, vel, coef=None):
    """(grad v, w): RHS form for the pressure Poisson; vel [ndofs, dim]."""
    vq = torch.einsum("qd,ndi->nqi", tab.Bvol, gather(tab, vel))
    w = _stiff_weights(tab, coef).expand(tab.ne, tab.nq)
    vk = torch.einsum("nqi,nqki->nqk", w[..., None] * vq, tab.adjJ)
    return scatter_add(tab, torch.einsum("qdk,nqk->nd", tab.Gvol, vk))


def _div_num(tab, vel):
    gq = torch.einsum("qdl,ndk->nqlk", tab.Gvol, gather(tab, vel))
    div = torch.einsum("nqlk,nqlk->nq", gq, tab.adjJ)  # carries detJ
    re = torch.einsum("qd,nq->nd", tab.Bvol * tab.wq[:, None], div)
    return scatter_add(tab, re)


def divergence_at_dofs(tab, vel):
    """Lumped-mass projected div(vel): [ndofs, dim] -> [ndofs]."""
    return _div_num(tab, vel) / tab.ml


def integrate(tab, u):
    """Domain integral of a nodal field (a device scalar)."""
    return torch.sum(tab.wdet * to_quad(tab, u))


def surface_normal_form(tab, w, face_sel=None):
    """Boundary linear form r[dof] = oint v (w . n) ds.

    w: [ndofs, dim] nodal vector field; face_sel: optional [nbf] 0/1 mask
    restricting the integral to selected boundary faces.  Assembled
    through the transpose table of the boundary elements' dofs (a gather
    and a sum, like scatter_add)."""
    if tab.nbf == 0:
        return w.new_zeros(tab.ndofs)
    wf = w.index_select(0, tab.bf_dofs.reshape(-1)).view(
        tab.nbf, tab.ndof_el, -1)
    wq = torch.einsum("fqd,fdk->fqk", tab.bf_Btr, wf)
    wn = torch.einsum("fqk,fqk->fq", wq, tab.bf_nor) * tab.bf_wts
    if face_sel is not None:
        wn = wn * face_sel[:, None]
    contrib = torch.einsum("fq,fqd->fd", wn, tab.bf_Btr).reshape(-1)
    contrib = torch.cat((contrib, contrib.new_zeros(1)))
    vals = contrib.index_select(0, tab.bf_table).view(
        len(tab.bf_uniq), -1).sum(-1)
    return w.new_zeros(tab.ndofs).index_copy(0, tab.bf_uniq, vals)


def helmholtz_apply_multi(tab, U, alpha, mass_coefs, diff_coefs):
    """Batched-coefficient Helmholtz apply: column c of the result is
    (alpha M(mass_coefs[c]) + K(diff_coefs[c])) U[:, c], with one gather
    and one assembly for all columns.

    mass_coefs / diff_coefs: [k, ne, nq] quad-point coefficients (use
    to_quad per column) or None."""
    k = U.shape[1]
    ne, nq = tab.ne, tab.nq
    uek = _gather_k(tab, U)
    re = 0.0
    if mass_coefs is not None:
        uq = uek @ tab.BT  # [k*ne, nq]
        wm = (alpha * tab.wdet)[None] * mass_coefs  # [k, ne, nq]
        re = re + (wm.reshape(k * ne, nq) * uq) @ tab.Bvol
    if diff_coefs is not None:
        wk = tab.wq[None, None, :] * diff_coefs  # [k, ne, nq]
        re = re + _stiff_k(tab, uek, wk.reshape(k * ne, nq), k)
    return _scatter_k(tab, re, k)


def diffusion_apply_tensor(tab, u, Kq):
    """(grad v, K grad u) with a matrix coefficient K [ne, nq, dim, dim]
    at quadrature points (SUPG streamwise diffusion etc.)."""
    uu, squeeze = _promote(u)
    gq = torch.einsum("qdl,ndk->nqlk", tab.Gvol, gather(tab, uu))
    # A[m,l] = adjJ[m,:] K adjJ[l,:]^T / detJ
    A = torch.einsum("nqmd,nqde,nqle->nqml", tab.adjJ, Kq, tab.adjJ) \
        / tab.detJ[..., None, None]
    Ag = torch.einsum("nqml,nqlk->nqmk", A, gq)
    re = torch.einsum("qdm,nqmk->ndk", tab.Gvol,
                      tab.wq[None, :, None, None] * Ag)
    out = scatter_add(tab, re)
    return out[:, 0] if squeeze else out


def grid_scale_q(tab, order=1):
    """Element grid scale at quadrature points: detJ^(1/dim) / order."""
    return tab.detJ ** (1.0 / tab.dim) / max(order, 1)


# --------------------------------------------------------------------------
# Krylov solves with Dirichlet constraints, in blocks of masked iterations
# --------------------------------------------------------------------------


def run_blocks(block, status, k):
    """The default runner of a CG solve's blocks (k iterations each): one
    block, then a host read of the done flag, until it is set."""
    while True:
        block()
        if int(status[0]):
            return


def _jacobi(diag):
    dinv = torch.where(torch.abs(diag) > 1e-300, 1.0 / diag,
                       torch.ones_like(diag))
    return lambda x: x * dinv


def _atol2(tol, bnorm2, dtype):
    """(max(tol, 50 eps) * |b|)^2 + 1e-300: the tolerance clamped to what
    the dtype can deliver (an f64-minded 1e-12 in an f32 run would always
    hit maxiter)."""
    tol = max(float(tol), 50.0 * float(torch.finfo(dtype).eps))
    return (tol * torch.sqrt(bnorm2)) ** 2 + 1e-300, tol


def cg_solve(apply_fn, b, x0=None, diag=None, dirichlet_mask=None, tol=1e-10,
             maxiter=500, M=None, return_info=False, block=None,
             loops=None):
    """Preconditioned CG on the constrained system.

    `dirichlet_mask` [ndofs] is 1 on free dofs, 0 on constrained dofs; the
    caller lifts inhomogeneous values into x0 and b beforehand.

    `M`: optional preconditioner callable r -> z (chebyshev_precond /
    pmg_precond / direct_precond); `diag` gives plain Jacobi when M is
    None.  `loops` runs the blocks (run_blocks when None; the low-Mach
    step loop passes its own).

    With return_info=True, returns (x, iterations, relative_residual),
    device scalars."""
    return _cg(apply_fn, b, x0, diag, dirichlet_mask, tol, maxiter, M,
               return_info, block, loops, multi=False, per_column=False)


def cg_solve_multi(apply_fn, B, x0=None, diag=None, dirichlet_mask=None,
                   tol=1e-10, maxiter=500, M=None, return_info=False,
                   block=None, loops=None, per_column=False):
    """Multi-RHS preconditioned CG: one operator sweep per iteration for
    all columns (per-column alpha/beta), iterating until every column
    meets its tolerance, as the JAX package's.  apply_fn, dirichlet_mask,
    diag and M must accept/broadcast over [nd, k].

    per_column=True stops each column at its own tolerance instead: the
    same iterates as k separate cg_solve calls (the JAX package's
    per-component loop), in one sweep; the info then sums the columns'
    iterations and takes the largest relative residual, as that loop's
    caller does."""
    return _cg(apply_fn, B, x0, diag, dirichlet_mask, tol, maxiter, M,
               return_info, block, loops, multi=True, per_column=per_column)


def _cg(apply_fn, b, x0, diag, mask, tol, maxiter, M, return_info, block,
        loops, multi, per_column):
    block = CG_BLOCK if block is None else block
    if multi and mask is not None and mask.ndim == 1:
        mask = mask[:, None]

    def A(x):
        if mask is None:
            return apply_fn(x)
        return apply_fn(x * mask) * mask + x * (1.0 - mask)

    if M is None:
        if diag is not None:
            M = _jacobi(diag[:, None] if multi and diag.ndim == 1 else diag)
        else:
            M = lambda x: x  # noqa: E731

    x = torch.zeros_like(b) if x0 is None else x0.clone()
    red = (lambda v: torch.sum(v, dim=0)) if multi else torch.sum
    bnorm2 = red(b * b)
    if multi and not per_column:
        tol = max(float(tol), 50.0 * float(torch.finfo(b.dtype).eps))
        atol2 = (tol * tol) * bnorm2 + 1e-300
    else:
        atol2, tol = _atol2(tol, bnorm2, b.dtype)

    r = b - A(x)
    p = M(r)
    rz = red(r * p)
    it = torch.zeros(b.shape[1] if per_column else (), dtype=torch.int64,
                     device=b.device)
    status = torch.zeros(2, dtype=torch.int64, device=b.device)

    def active_now():
        more = red(r * r) > atol2
        if multi and not per_column:
            more = torch.any(more)
        return more & (it < maxiter)

    # the JAX loop's condition for the next iteration, kept current
    active = active_now()

    def iterate():
        Ap = A(p)
        denom = red(p * Ap)
        if multi:
            alpha = rz / torch.where(torch.abs(denom) > 1e-300, denom,
                                     torch.ones_like(denom))
        else:
            alpha = rz / denom
        x.copy_(torch.where(active, x + alpha * p, x))
        r.copy_(torch.where(active, r - alpha * Ap, r))
        z = M(r)
        rz_new = red(r * z)
        if multi:
            beta = rz_new / torch.where(torch.abs(rz) > 1e-300, rz,
                                        torch.ones_like(rz))
        else:
            beta = rz_new / rz
        p.copy_(torch.where(active, z + beta * p, p))
        rz.copy_(torch.where(active, rz_new, rz))
        it.add_(active.to(torch.int64))
        active.copy_(active_now())

    def run():
        for _ in range(block):
            iterate()
        done = ~torch.any(active)
        status.copy_(torch.stack((done.to(torch.int64), torch.max(it))))

    (loops or run_blocks)(run, status, block)
    if not return_info:
        return x
    # relative residuals; |b| = 0 (a solve with nothing to do) reads 0:
    # the JAX package's floor 1e-300 is 0 in f32, where its 0/0 is NaN
    tiny = float(torch.finfo(b.dtype).tiny)
    rr = red(r * r)
    if per_column:
        relres = torch.max(torch.sqrt(rr) / torch.clamp(torch.sqrt(bnorm2),
                                                        min=tiny))
        return x, torch.sum(it), relres
    if multi:
        relres = torch.sqrt(torch.max(rr / torch.clamp(bnorm2, min=tiny)))
        return x, it, relres
    return x, it, torch.sqrt(rr) / torch.clamp(torch.sqrt(bnorm2), min=tiny)


def estimate_lambda_max(apply_fn, dinv, n, iters=15):
    """Largest eigenvalue of D^-1 A by power iteration (deterministic
    start; a fixed number of applies)."""
    v = 1.0 + 0.3 * torch.cos(torch.arange(n, dtype=dinv.dtype,
                                           device=dinv.device))
    v = v / torch.sqrt(torch.sum(v * v))
    for _ in range(iters):
        w = dinv * apply_fn(v)
        v = w / torch.clamp(torch.sqrt(torch.sum(w * w)), min=1e-300)
    w = dinv * apply_fn(v)
    return torch.sum(v * w) / torch.clamp(torch.sum(v * v), min=1e-300)


def chebyshev_precond(apply_fn, diag, degree=3, lmax=None, eig_ratio=0.1,
                      lmax_safety=1.1):
    """Chebyshev polynomial preconditioner on the Jacobi-scaled operator
    (a fixed linear polynomial in D^-1 A, so plain CG stays valid).

    Targets the interval [eig_ratio*lmax, lmax] of D^-1 A; each degree
    costs one operator apply.  `lmax` may be passed in or is estimated
    here (estimate_lambda_max).  Takes r [nd] or, with the same operator
    on every column, [nd, k]."""
    dinv = torch.where(torch.abs(diag) > 1e-300, 1.0 / diag,
                       torch.ones_like(diag))
    if lmax is None:
        lmax = estimate_lambda_max(apply_fn, dinv, diag.shape[0])
    lmax = lmax * lmax_safety
    lmin = eig_ratio * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta

    def M(r):
        di = dinv[:, None] if r.ndim == 2 else dinv
        d = (1.0 / theta) * (di * r)
        z = d
        rho_old = 1.0 / sigma
        for _ in range(degree - 1):
            rho = 1.0 / (2.0 * sigma - rho_old)
            rk = r - apply_fn(z)
            d = rho * rho_old * d + (2.0 * rho / delta) * (di * rk)
            z = z + d
            rho_old = rho
        return z

    return M


def pmg_precond(apply_f, diag_f, apply_c, diag_c, P, degree=3,
                coarse_degree=None, lmax_f=None, lmax_c=None, ortho=False):
    """Two-level p-multigrid V(1,1) preconditioner: Chebyshev smoothing on
    the order-p space, a Chebyshev 'solve' on the order-1 space, exact-
    transpose grid transfers (P: a PInterp).  All parts are fixed linear
    symmetric operators, so the result is an SPD preconditioner for CG.

    The smoother targets the upper spectrum (eig_ratio 0.3); the coarse
    polynomial covers a wide interval so it acts as an approximate solve.
    f32 uses a tamer coarse polynomial (extreme Chebyshev intervals
    amplify f32 roundoff to divergence)."""
    f32 = torch.finfo(diag_f.dtype).bits <= 32
    if coarse_degree is None:
        coarse_degree = 10 if f32 else 24
    coarse_ratio = 0.05 if f32 else 0.02
    smooth = chebyshev_precond(apply_f, diag_f, degree=degree, lmax=lmax_f,
                               eig_ratio=0.3)
    coarse = chebyshev_precond(apply_c, diag_c, degree=coarse_degree,
                               lmax=lmax_c, eig_ratio=coarse_ratio)

    def M(r):
        z = smooth(r)
        rc = P.restrict(r - apply_f(z))
        z = z + P.prolong(coarse(rc))
        z = z + smooth(r - apply_f(z))
        if ortho:
            z = z - torch.mean(z)
        return z

    return M


# --------------------------------------------------------------------------
# Dense direct factorization (small-case implicit solves)
#
# For small dof counts the operator is assembled densely and Cholesky-
# factored once every few steps, outside the step; each solve's
# preconditioner apply is then one triangular pair (cholesky_solve), and
# CG (still exact) converges in 1-3 iterations.  The JAX package's
# counterpart (tps_tpu/fem/h1.py:770-1033) does the same.
# --------------------------------------------------------------------------


def dense_capable(tab):
    """True when the dense direct path applies (a small space)."""
    return tab.ndofs <= DENSE_DIRECT_MAX


def element_mass(tab, coef=None):
    """Element mass matrices (v_i, c v_j) [ne, nde, nde]."""
    w = tab.wdet
    cq = _coef_q(tab, coef)
    if cq is not None:
        w = w * cq
    return torch.einsum("nq,qi,qj->nij", w, tab.Bvol, tab.Bvol)


def element_stiffness(tab, coef=None):
    """Element stiffness matrices (grad v_i, c grad v_j) [ne, nde, nde]."""
    w = _stiff_weights(tab, coef)
    Ke = 0.0
    for m in range(tab.dim):
        for l in range(tab.dim):  # noqa: E741
            Ke = Ke + torch.einsum(
                "nq,qi,qj->nij", w * tab.metric[:, m, l, :],
                tab.Gvol[:, :, m], tab.Gvol[:, :, l])
    return Ke


def assemble_dense(tab, Ke):
    """[(k,) ne, nde, nde] element matrices -> dense [(k,) nd, nd].

    A gather over the transpose of the (row, column) pattern and a sum,
    into the pattern's positions; the table is built on the first call
    (outside any capture: the dense factors are refreshed eagerly)."""
    if tab.dense_table is None:
        ed = _np(tab.elem_dofs).astype(np.int64)
        nd = tab.ndofs
        keys = (ed[:, :, None] * nd + ed[:, None, :]).reshape(-1)
        uniq, inv = np.unique(keys, return_inverse=True)
        table = _transpose_table(inv.reshape(-1), len(uniq))
        dev = tab.wq.device
        tab.dense_table = (torch.as_tensor(uniq, device=dev),
                           torch.as_tensor(table.reshape(-1), device=dev))
    uniq, table = tab.dense_table
    nd = tab.ndofs
    lead = tuple(Ke.shape[:-3])
    flat = Ke.reshape(lead + (-1,))
    flat = torch.cat((flat, flat.new_zeros(lead + (1,))), dim=-1)
    vals = flat.index_select(-1, table).view(lead + (len(uniq), -1)).sum(-1)
    K = Ke.new_zeros(lead + (nd * nd,))
    return K.index_copy(K.ndim - 1, uniq, vals).view(lead + (nd, nd))


def dense_constrain(K, mask=None, ortho=False):
    """Apply Dirichlet elimination (mask: 1=free) and/or the rank-one
    shift that makes a pure-Neumann (singular, nullspace=constants)
    operator SPD while acting exactly on the mean-free complement."""
    if mask is not None:
        K = K * (mask[..., :, None] * mask[..., None, :])
        K = K + torch.diag_embed(1.0 - mask)
    if ortho:
        n = K.shape[-1]
        sigma = torch.mean(torch.diagonal(K, dim1=-2, dim2=-1), dim=-1)
        K = K + (sigma[..., None, None] / n) * torch.ones_like(K)
    return K


def dense_cholesky(K):
    """Robust lower Cholesky factor L (L L^T ~= K) of an SPD FEM operator
    in working precision.

    Symmetric Jacobi scaling to unit diagonal removes the scaling part of
    the condition number before factoring, and progressively larger
    diagonal shifts (1e-5, 1e-3) cover the rest: a shifted factor is
    still an excellent lagged preconditioner.  The failure test (a
    non-zero `info` or a NaN) stays on the device: `cholesky_ex`, never
    `cholesky`, which syncs and raises.  The scaling is absorbed back into
    the returned factor."""
    d = torch.diagonal(K, dim1=-2, dim2=-1)
    s = 1.0 / torch.sqrt(torch.clamp(d, min=1e-300))
    Ks = K * (s[..., :, None] * s[..., None, :])
    L, info = torch.linalg.cholesky_ex(Ks)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    for shift in (1e-5, 1e-3):
        Ls, info_s = torch.linalg.cholesky_ex(Ks + shift * eye)
        bad = (info != 0) | torch.isnan(L).flatten(-2).any(-1)
        L = torch.where(bad[..., None, None], Ls, L)
        info = torch.where(bad, info_s, info)
    return L / s[..., :, None]


def direct_precond(L):
    """Preconditioner callable from dense_cholesky's factor [nd, nd]:
    M(r) solves L L^T z = r for r of shape [nd] or [nd, k]."""

    def M(r):
        rr = r[:, None] if r.ndim == 1 else r
        z = torch.cholesky_solve(rr, L)
        return z[:, 0] if r.ndim == 1 else z
    return M


def direct_precond_stack(Ls):
    """Per-column preconditioner from factors ([k, nd, nd] stacked, or a
    sequence of k [nd, nd]) for a multi-RHS solve with a different
    operator per column: M(r [nd, k])."""

    def M(r):
        return torch.cat([torch.cholesky_solve(r[:, c:c + 1], Ls[c])
                          for c in range(len(Ls))], dim=1)
    return M
