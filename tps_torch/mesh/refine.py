"""Uniform mesh refinement (the reference's `em/ref_levels` /
`mfem::Mesh::UniformRefinement` role, src/quasimagnetostatic.cpp:167-170).

A numpy copy of the JAX package's mesh/refine.py (tps_torch never imports
jax); tests/test_torch_mesh_io.py pins it to the JAX package's.

Straight-sided meshes: quads/tris split into 4 children, hexes into 8
(edge midpoints, face centers, body centers), tets into 8 (red
refinement: corner tets + Bey octasection).  Element attributes
propagate to children; boundary faces split with their attribute
preserved.
"""

from __future__ import annotations

import numpy as np

from .mesh import Mesh

# MFEM vertex ordering -> unit-lattice coordinates
_QUAD_LATTICE = {(0, 0): 0, (1, 0): 1, (1, 1): 2, (0, 1): 3}
_HEX_LATTICE = {
    (0, 0, 0): 0, (1, 0, 0): 1, (1, 1, 0): 2, (0, 1, 0): 3,
    (0, 0, 1): 4, (1, 0, 1): 5, (1, 1, 1): 6, (0, 1, 1): 7,
}


class _PointPool:
    """Deduplicated refinement points keyed by the vertex subset they
    bisect (edge = 2 vertices, face = 4, body = 8)."""

    def __init__(self, vertices):
        self.coords = [v for v in np.asarray(vertices, dtype=np.float64)]
        self.keys: dict[tuple, int] = {}

    def vertex(self, v: int) -> int:
        return int(v)

    def midpoint(self, vids) -> int:
        key = tuple(sorted(int(v) for v in vids))
        if len(key) == 1:
            return key[0]
        idx = self.keys.get(key)
        if idx is None:
            idx = len(self.coords)
            self.coords.append(
                np.mean([self.coords[v] for v in key], axis=0))
            self.keys[key] = idx
        return idx


def _lattice_vids(pool, ev, lattice_map, dim):
    """3^dim lattice of point ids for one element (corners from `ev`)."""
    inv = {i: c for c, i in lattice_map.items()}
    shape = (3,) * dim
    out = np.zeros(shape, dtype=np.int64)
    for idx in np.ndindex(shape):
        corners = []
        for corner in np.ndindex((2,) * dim):
            # corner participates iff each lattice coord is reachable:
            # coord 0 -> corner 0, coord 2 -> corner 1, coord 1 -> both
            ok = all(idx[d] == 2 * corner[d] or idx[d] == 1
                     for d in range(dim))
            if ok:
                corners.append(int(ev[lattice_map[corner]]))
        out[idx] = pool.midpoint(corners)
    del inv
    return out


def refine_uniform(mesh: Mesh, levels: int = 1) -> Mesh:
    """Uniformly refine `levels` times. quad/hex/tri/tet, straight-sided,
    non-periodic meshes."""
    out = mesh
    for _ in range(max(0, int(levels))):
        out = _refine_once(out)
    return out


def _refine_once(mesh: Mesh) -> Mesh:
    if mesh.geom not in ("quad", "hex", "tri", "tet"):
        raise NotImplementedError(f"uniform refinement of {mesh.geom} meshes")
    if mesh.periodic_pairs:
        # refine the unglued mesh (the periodic planes are ordinary
        # boundary faces there; children inherit their attributes),
        # then re-glue the children with the original translations —
        # the reference refines periodic meshes natively (MFEM), and
        # the MMS deck path is exactly "periodic beam mesh +
        # refinement" (test/mms.euler.2d.quad.ini:5-6)
        import dataclasses as _dc

        from .mesh import make_periodic

        ts, seen = [], set()
        for (_ia, _ib, s) in mesh.periodic_pairs:
            t = -np.asarray(s, dtype=np.float64)
            # canonical sign (t and -t glue the same plane pair)
            nz = np.nonzero(np.abs(t) > 1e-14)[0]
            if nz.size == 0:
                continue
            if t[nz[0]] < 0:
                t = -t
            key = tuple(np.round(t, 12))
            if key not in seen:
                seen.add(key)
                ts.append(t)
        fine = _refine_once(_dc.replace(mesh, periodic_pairs=[]))
        return make_periodic(fine, ts)
    if mesh.curved_nodes is not None:
        raise NotImplementedError("uniform refinement of curved meshes")
    if mesh.geom in ("tri", "tet"):
        return _refine_once_simplex(mesh)

    dim = mesh.dim
    lattice_map = _QUAD_LATTICE if mesh.geom == "quad" else _HEX_LATTICE
    pool = _PointPool(mesh.vertices)

    children = []
    child_attrs = []
    attrs = mesh.attributes()
    for e in range(mesh.num_elements):
        lat = _lattice_vids(pool, mesh.elements[e], lattice_map, dim)
        for child in np.ndindex((2,) * dim):
            vids = np.zeros(len(lattice_map), dtype=np.int64)
            for corner, local in lattice_map.items():
                pos = tuple(child[d] + corner[d] for d in range(dim))
                vids[local] = lat[pos]
            children.append(vids)
            child_attrs.append(int(attrs[e]))

    # boundary faces: segment -> 2 children, quad face -> 4 children
    new_bfaces, new_battrs = [], []
    for i in range(mesh.bdr_faces.shape[0]):
        fv = [int(v) for v in mesh.bdr_faces[i]]
        attr = int(mesh.bdr_attrs[i]) if len(mesh.bdr_attrs) else 1
        if len(fv) == 2:  # edge (2-D boundary)
            m = pool.midpoint(fv)
            new_bfaces += [[fv[0], m], [m, fv[1]]]
            new_battrs += [attr, attr]
        elif len(fv) == 4:  # quad face (3-D boundary)
            m01 = pool.midpoint((fv[0], fv[1]))
            m12 = pool.midpoint((fv[1], fv[2]))
            m23 = pool.midpoint((fv[2], fv[3]))
            m30 = pool.midpoint((fv[3], fv[0]))
            c = pool.midpoint(fv)
            new_bfaces += [
                [fv[0], m01, c, m30],
                [m01, fv[1], m12, c],
                [c, m12, fv[2], m23],
                [m30, c, m23, fv[3]],
            ]
            new_battrs += [attr] * 4
        else:
            raise NotImplementedError(f"boundary face with {len(fv)} vertices")

    return Mesh(
        dim=dim,
        geom=mesh.geom,
        vertices=np.asarray(pool.coords, dtype=np.float64),
        elements=np.asarray(children, dtype=np.int64),
        bdr_faces=(np.asarray(new_bfaces, dtype=np.int64)
                   if new_bfaces else np.zeros((0, 0), dtype=int)),
        bdr_attrs=np.asarray(new_battrs, dtype=np.int64),
        elem_attrs=np.asarray(child_attrs, dtype=np.int64),
    )


def _refine_once_simplex(mesh: Mesh) -> Mesh:
    """Red refinement of simplices: a triangle splits into 4 children
    (corners + the medial triangle); a tet splits into 8 — 4 corner tets
    plus Bey's octasection of the central octahedron along the
    (m02, m13) diagonal (the reference's tet UniformRefinement role for
    the rings/coupled-3d Gmsh meshes, src/quasimagnetostatic.cpp:167)."""
    pool = _PointPool(mesh.vertices)
    attrs = mesh.attributes()
    children, child_attrs = [], []

    def m(a, b):
        return pool.midpoint((a, b))

    for e in range(mesh.num_elements):
        ev = [int(v) for v in mesh.elements[e]]
        if mesh.geom == "tri":
            v0, v1, v2 = ev
            m01, m12, m02 = m(v0, v1), m(v1, v2), m(v0, v2)
            kids = [(v0, m01, m02), (m01, v1, m12),
                    (m02, m12, v2), (m01, m12, m02)]
        else:
            v0, v1, v2, v3 = ev
            m01, m02, m03 = m(v0, v1), m(v0, v2), m(v0, v3)
            m12, m13, m23 = m(v1, v2), m(v1, v3), m(v2, v3)
            kids = [
                (v0, m01, m02, m03), (m01, v1, m12, m13),
                (m02, m12, v2, m23), (m03, m13, m23, v3),
                # octahedron split along (m02, m13)
                (m01, m02, m03, m13), (m01, m02, m12, m13),
                (m02, m03, m13, m23), (m02, m12, m13, m23),
            ]
        children += [list(k) for k in kids]
        child_attrs += [int(attrs[e])] * len(kids)

    children = np.asarray(children, dtype=np.int64)
    verts = np.asarray(pool.coords, dtype=np.float64)

    # enforce positive orientation (affine simplices: one sign per child)
    if mesh.geom == "tet":
        ev = verts[children]
        det = np.linalg.det(ev[:, 1:4] - ev[:, 0:1])
        flip = det < 0
        children[flip, 2], children[flip, 3] = \
            children[flip, 3].copy(), children[flip, 2].copy()
    else:
        ev = verts[children]
        det = np.cross(ev[:, 1, :2] - ev[:, 0, :2], ev[:, 2, :2] - ev[:, 0, :2])
        flip = det < 0
        children[flip, 1], children[flip, 2] = \
            children[flip, 2].copy(), children[flip, 1].copy()

    new_bfaces, new_battrs = [], []
    for i in range(mesh.bdr_faces.shape[0]):
        fv = [int(v) for v in mesh.bdr_faces[i]]
        attr = int(mesh.bdr_attrs[i]) if len(mesh.bdr_attrs) else 1
        if len(fv) == 2:  # edge (2-D tri boundary)
            mm = m(fv[0], fv[1])
            new_bfaces += [[fv[0], mm], [mm, fv[1]]]
            new_battrs += [attr, attr]
        elif len(fv) == 3:  # triangle face (3-D tet boundary)
            a, b, c = fv
            mab, mbc, mac = m(a, b), m(b, c), m(a, c)
            new_bfaces += [[a, mab, mac], [mab, b, mbc],
                           [mac, mbc, c], [mab, mbc, mac]]
            new_battrs += [attr] * 4
        else:
            raise NotImplementedError(f"boundary face with {len(fv)} vertices")

    return Mesh(
        dim=mesh.dim,
        geom=mesh.geom,
        vertices=verts,
        elements=children,
        bdr_faces=(np.asarray(new_bfaces, dtype=np.int64)
                   if new_bfaces else np.zeros((0, 0), dtype=int)),
        bdr_attrs=np.asarray(new_battrs, dtype=np.int64),
        elem_attrs=np.asarray(child_attrs, dtype=np.int64),
    )
