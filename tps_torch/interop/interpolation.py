"""Cross-mesh field interpolation (the gslib FindPointsGSLIB analog).

The port of the JAX package's interop/interpolation.py.  The reference
interpolates conductivity and Joule heating between the flow and EM
meshes with gslib point location (reference:
src/cycle_avg_joule_coupling.cpp:143-375).  The meshes are static, so
point location and the inversion of the element map run once, in numpy,
at set-up: a (point -> element, basis weights) table.  At run time an
interpolation is one gather and a small weighted sum on the device.

The set-up is the JAX package's per-point search, vectorised: each point
is tried against every element whose box holds it, in element order, by
Newton inversion of the bi/tri-linear map (each pair stops where the
per-point loop stops), and takes the first element that holds it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..mesh.mesh import Mesh
from ..mesh.reference_element import ReferenceElement


def _invert_maps(ref: ReferenceElement, verts: np.ndarray, x: np.ndarray,
                 tol=1e-12, maxit=30):
    """Newton inversion of the element maps for point/element pairs
    (verts [P, nverts, dim], x [P, dim]): (xi [P, dim], max|residual| [P]),
    each pair as the JAX package's `_invert_map` leaves it."""
    P, dim = x.shape
    xi = np.full((P, dim), 0.5)
    res = np.full(P, np.inf)
    live = np.ones(P, dtype=bool)
    for _ in range(maxit):
        idx = np.nonzero(live)[0]
        if len(idx) == 0:
            break
        N = ref.eval_geom_basis(xi[idx])
        dN = ref.eval_geom_basis_grad(xi[idx])
        r = np.einsum("pv,pvi->pi", N, verts[idx]) - x[idx]
        res[idx] = np.abs(r).max(axis=1)
        done = res[idx] < tol
        live[idx[done]] = False
        go = idx[~done]
        if len(go) == 0:
            break
        J = np.einsum("pvi,pvj->pij", verts[go], dN[~done])
        xi[go] = xi[go] - np.linalg.solve(J, r[~done][..., None])[..., 0]
    return xi, res


@dataclass(eq=False)
class FieldInterpolator:
    """Interpolate nodal/dof fields from a source mesh onto target points."""

    elem_ids: np.ndarray  # [np] containing element (source mesh)
    weights: np.ndarray  # [np, ndof_el] basis values at the point
    found: np.ndarray  # [np] bool
    src_tab: object = None  # __call__'s source: an H1 table, None: DG
    _dev: dict = field(default_factory=dict, repr=False)

    @classmethod
    def build(cls, src_mesh: Mesh, src_order: int, src_basis: str,
              points: np.ndarray, tol=1e-8, chunk=2048, src_tab=None):
        ref = ReferenceElement(geom=src_mesh.geom, order=src_order,
                               basis=src_basis)
        pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
        npt = pts.shape[0]
        ev = src_mesh.vertices[src_mesh.elements]  # [ne, nverts, dim]
        lo = ev.min(axis=1) - tol
        hi = ev.max(axis=1) + tol

        elem_ids = np.zeros(npt, dtype=np.int32)
        ref_coords = np.zeros((npt, ref.dim))
        found = np.zeros(npt, dtype=bool)
        for p0 in range(0, npt, chunk):
            x = pts[p0:p0 + chunk]
            inbox = ((lo[None] <= x[:, None]) & (x[:, None] <= hi[None])
                     ).all(axis=-1)
            pp, ee = np.nonzero(inbox)  # by point, then element order
            xi, res = _invert_maps(ref, ev[ee], x[pp])
            ok = (res < tol) & (xi > -1e-9).all(axis=1) \
                & (xi < 1 + 1e-9).all(axis=1)
            pp, ee, xi = pp[ok], ee[ok], xi[ok]
            first = np.unique(pp, return_index=True)[1]
            hit = p0 + pp[first]
            elem_ids[hit] = ee[first]
            ref_coords[hit] = xi[first]
            found[hit] = True
        weights = np.zeros((npt, ref.ndof))
        if found.any():
            weights[found] = ref.eval_basis(np.clip(ref_coords[found], 0, 1))
        return cls(elem_ids=elem_ids, weights=weights, found=found,
                   src_tab=src_tab)

    # -- run time ----------------------------------------------------------
    def _tensors(self, dtype, device, tab=None):
        """The tables on the device, made once per (dtype, device, layout):
        the source rows to gather, the weights (zero rows where a point
        was not found)."""
        key = (dtype, str(device), tab is not None)
        out = self._dev.get(key)
        if out is None:
            from ..fem.h1 import _np

            eid = self.elem_ids.astype(np.int64)
            if tab is not None:
                rows = _np(tab.elem_dofs).astype(np.int64)[eid]
            else:
                rows = eid
            w = self.weights * self.found[:, None]
            out = (torch.as_tensor(rows.reshape(-1), device=device),
                   torch.as_tensor(w, dtype=dtype, device=device))
            self._dev[key] = out
        return out

    def from_dg(self, U_el):
        """Source field in DG layout [ne, ndof_el(, k)] -> values at the
        points."""
        rows, w = self._tensors(U_el.dtype, U_el.device)
        vals = U_el.index_select(0, rows)  # [np, ndof_el(, k)]
        return torch.einsum("pd,pd...->p...", w, vals)

    def __call__(self, u):
        """A source field in the layout build() was given (H1 global with
        src_tab, else DG) -> values at the points."""
        if self.src_tab is None:
            return self.from_dg(u)
        return self.from_h1(self.src_tab, u)

    def from_h1(self, tab, u):
        """Source field in H1 global layout [ndofs(, k)] -> values at the
        points."""
        rows, w = self._tensors(u.dtype, u.device, tab)
        vals = u.index_select(0, rows).view(
            (w.shape[0], w.shape[1]) + tuple(u.shape[1:]))
        return torch.einsum("pd,pd...->p...", w, vals)
