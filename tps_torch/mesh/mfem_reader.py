"""Readers for MFEM `.mesh` (v1.0 text) and Gmsh `.msh` (v2.2 ASCII) files.

A numpy copy of the JAX package's mesh/mfem_reader.py (tps_torch never
imports jax); tests/test_torch_mesh_io.py pins it to the JAX package's.
Covers single-type quad/hex/tri/tet meshes, straight-sided or with an L2
nodes block (curved, periodic); a mixed tri/quad mesh is ROADMAP A7.
"""

from __future__ import annotations

import numpy as np

from .mesh import Mesh

# MFEM geometry type codes
_MFEM_GEOM = {
    1: ("segment", 2),
    2: ("tri", 3),
    3: ("quad", 4),
    4: ("tet", 4),
    5: ("hex", 8),
    6: ("prism", 6),
}


def _mixed(path, geoms):
    return NotImplementedError(
        f"{path}: a mixed mesh ({sorted(geoms)}) is not ported to tps_torch "
        "yet (ROADMAP A7)")


def _read_inline_mesh(lines, path):
    """MFEM 'INLINE mesh v1.0' generated-grid format (reference mesh files
    like test/meshes/inline-quad.mesh): key = value pairs describing a
    cartesian grid of quad/tri/hex/tet elements."""
    kv = {}
    for ln in lines[1:]:
        if "=" in ln:
            k, v = ln.split("=", 1)
            kv[k.strip()] = v.strip()
    typ = kv.get("type", "quad")
    nx = int(kv.get("nx", 1))
    ny = int(kv.get("ny", 1))
    sx = float(kv.get("sx", 1.0))
    sy = float(kv.get("sy", 1.0))
    from . import generators

    if typ == "quad":
        return generators.box_2d(nx, ny, x1=sx, y1=sy)
    if typ == "tri":
        return generators.box_2d_tri(nx, ny, x1=sx, y1=sy)
    nz = int(kv.get("nz", 1))
    sz = float(kv.get("sz", 1.0))
    bounds = ((0.0, sx), (0.0, sy), (0.0, sz))
    if typ == "hex":
        return generators.box_3d(nx, ny, nz, bounds=bounds)
    if typ == "tet":
        return generators.box_3d_tet(nx, ny, nz, bounds=bounds)
    raise NotImplementedError(f"{path}: INLINE mesh type '{typ}'")


def read_mfem_mesh(path: str) -> Mesh:
    with open(path) as f:
        lines = [ln.split("#")[0].strip() for ln in f]
    lines = [ln for ln in lines if ln]
    if lines and lines[0].startswith("MFEM INLINE mesh"):
        return _read_inline_mesh(lines, path)
    if not lines or not lines[0].startswith("MFEM mesh"):
        raise ValueError(f"{path}: not an MFEM mesh file")

    idx = {ln: i for i, ln in enumerate(lines)}

    def section(name):
        if name not in idx:
            return None
        return idx[name] + 1

    i = section("dimension")
    dim = int(lines[i])

    i = section("elements")
    ne = int(lines[i])
    elems = []
    eattrs = []
    geom_seen = set()
    for k in range(ne):
        parts = lines[i + 1 + k].split()
        eattrs.append(int(parts[0]))
        geom = int(parts[1])
        if geom not in _MFEM_GEOM:
            raise ValueError(f"{path}: unsupported element geometry {geom}")
        gname, nverts = _MFEM_GEOM[geom]
        geom_seen.add(gname)
        elems.append([int(v) for v in parts[2 : 2 + nverts]])
    if geom_seen - {"quad", "hex", "tri", "tet"}:
        raise NotImplementedError(
            f"{path}: element types {sorted(geom_seen)} not supported "
            "(quad/hex/tri/tet)"
        )
    if len(geom_seen) != 1:
        raise _mixed(path, geom_seen)
    geom = geom_seen.pop()
    elements = np.asarray(elems, dtype=np.int64)

    i = section("boundary")
    bdr_faces, bdr_attrs = [], []
    if i is not None:
        nb = int(lines[i])
        for k in range(nb):
            parts = lines[i + 1 + k].split()
            attr, g = int(parts[0]), int(parts[1])
            _, nverts = _MFEM_GEOM[g]
            bdr_faces.append(tuple(int(v) for v in parts[2 : 2 + nverts]))
            bdr_attrs.append(attr)

    i = section("vertices")
    nv = int(lines[i])
    curved_nodes, curved_order = None, 1
    # either "nv \n vdim \n coords..." or "nv" followed by a `nodes` section
    maybe_vdim = lines[i + 1].split()
    if len(maybe_vdim) == 1 and "nodes" not in idx:
        vdim = int(maybe_vdim[0])
        verts = np.array(
            [[float(x) for x in lines[i + 2 + k].split()[:vdim]] for k in range(nv)]
        )
    elif len(maybe_vdim) == 1 and "nodes" in idx:
        # nodes-based mesh (periodic and/or curved): geometry lives in an
        # L2 GridFunction, one block of (p+1)^dim tensor nodes per element;
        # the vertex ids above it are topology only (periodic seams share
        # ids while the per-element nodes keep the true coordinates).
        # Reference meshes: test/meshes/periodic-cube.mesh (L2_T1_3D_P1),
        # beam-quad-o3-s5-p.mesh (L2_T1_2D_P1).
        curved_nodes, curved_order = _read_l2_nodes(
            lines, idx["nodes"], path, ne, dim, geom
        )
        # representative vertex coordinates for topology/face matching:
        # each vertex id takes the coords from the first element corner
        # that references it (consistent across a periodic seam because
        # both sides name the same id)
        from .reference_element import ReferenceElement

        gref = ReferenceElement(geom=geom, order=curved_order,
                                basis="gauss-lobatto")
        vref = ReferenceElement(geom=geom, order=1, basis="gauss-lobatto")
        # corner node index of each element vertex in the tensor node set
        d2 = np.sum(
            (vref.vertices[:, None, :] - gref.nodes[None, :, :]) ** 2, axis=-1
        )
        corner_ids = np.argmin(d2, axis=1)
        verts = np.zeros((nv, dim))
        seen = np.zeros(nv, dtype=bool)
        for e in range(ne):
            for c, vid in enumerate(elements[e]):
                if not seen[vid]:
                    verts[vid] = curved_nodes[e, corner_ids[c]]
                    seen[vid] = True
    else:
        raise ValueError(f"{path}: malformed vertices section")

    if bdr_faces:
        width = max(len(b) for b in bdr_faces)
        bf = np.zeros((len(bdr_faces), width), dtype=np.int64)
        for j, b in enumerate(bdr_faces):
            bf[j, : len(b)] = b
    else:
        bf = np.zeros((0, 0), dtype=np.int64)

    return Mesh(
        dim=dim,
        geom=geom,
        vertices=verts[:, :dim],
        elements=elements,
        bdr_faces=bf,
        bdr_attrs=np.asarray(bdr_attrs, dtype=np.int64),
        elem_attrs=np.asarray(eattrs, dtype=np.int64),
        curved_nodes=curved_nodes,
        curved_order=curved_order,
    )


_MFEM_CODE = {"segment": 1, "tri": 2, "quad": 3, "tet": 4, "hex": 5}
_FACE_GEOM = {"quad": "segment", "tri": "segment", "hex": "quad",
              "tet": "tri"}


def write_mfem_mesh(path, mesh: Mesh):
    """Write a straight-sided, non-periodic single-type mesh as an MFEM
    v1.0 text file that read_mfem_mesh reads back to the same arrays
    (coordinates in 17 significant digits)."""
    if mesh.curved_nodes is not None or mesh.periodic_pairs:
        raise ValueError("write_mfem_mesh writes straight-sided, "
                         "non-periodic meshes only")
    code, bcode = _MFEM_CODE[mesh.geom], _MFEM_CODE[_FACE_GEOM[mesh.geom]]
    attrs = mesh.attributes()
    lines = ["MFEM mesh v1.0", "", "dimension", str(mesh.dim), "",
             "elements", str(mesh.num_elements)]
    lines += [f"{int(a)} {code} " + " ".join(map(str, ev))
              for a, ev in zip(attrs, mesh.elements.tolist())]
    lines += ["", "boundary", str(len(mesh.bdr_faces))]
    lines += [f"{int(a)} {bcode} " + " ".join(map(str, fv))
              for a, fv in zip(mesh.bdr_attrs, mesh.bdr_faces.tolist())]
    lines += ["", "vertices", str(mesh.num_vertices), str(mesh.dim)]
    lines += [" ".join(f"{x:.17g}" for x in v) for v in mesh.vertices]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _read_l2_nodes(lines, i_nodes, path, ne, dim, geom):
    """Parse a `nodes` FiniteElementSpace + GridFunction block into
    per-element geometry nodes [ne, (p+1)^dim, dim] at Gauss-Lobatto
    tensor points (x-fastest), resampling from Gauss-Legendre when the
    file's basis type is T0."""
    import re

    header = {}
    j = i_nodes + 1
    while j < len(lines) and (
        ":" in lines[j] or lines[j] == "FiniteElementSpace"
    ):
        if ":" in lines[j]:
            k, v = lines[j].split(":", 1)
            header[k.strip()] = v.strip()
        j += 1
    fec = header.get("FiniteElementCollection", "")
    m = re.match(r"L2(?:_T(\d))?_(\d)D_P(\d+)$", fec)
    if not m:
        raise NotImplementedError(
            f"{path}: nodes collection '{fec}' not supported (L2_* only)"
        )
    btype = int(m.group(1) or 0)  # 0 GaussLegendre, 1 GaussLobatto
    p = int(m.group(3))
    vdim = int(header.get("VDim", dim))
    ordering = int(header.get("Ordering", 1))
    if geom not in ("quad", "hex"):
        raise NotImplementedError(f"{path}: L2 nodes on {geom} elements")
    ldof = (p + 1) ** dim

    vals = []
    while j < len(lines):
        parts = lines[j].split()
        if not all(_is_float(t) for t in parts):
            break
        vals.extend(float(t) for t in parts)
        j += 1
    data = np.asarray(vals)
    if data.size != ne * ldof * vdim:
        raise ValueError(
            f"{path}: nodes GridFunction has {data.size} values, expected "
            f"{ne * ldof * vdim}"
        )
    if ordering == 1:  # byVDIM: (dof, component) interleaved
        nodes = data.reshape(ne, ldof, vdim)
    else:  # byNODES: all x, then all y, ...
        nodes = data.reshape(vdim, ne, ldof).transpose(1, 2, 0)
    nodes = nodes[..., :dim]

    if btype == 0:
        # resample Gauss-Legendre Lagrange nodes onto Gauss-Lobatto points
        # (exact: same polynomial space) so downstream curved geometry can
        # assume GLL nodes
        from .reference_element import ReferenceElement

        rgl = ReferenceElement(geom=geom, order=p, basis="gauss-legendre")
        rlo = ReferenceElement(geom=geom, order=p, basis="gauss-lobatto")
        R = rgl.eval_basis(rlo.nodes)  # [ldof_gll, ldof_gl]
        nodes = np.einsum("td,ndk->ntk", R, nodes)
    return nodes, p


def _is_float(tok):
    try:
        float(tok)
        return True
    except ValueError:
        return False


# Gmsh element type codes -> (geom, nverts)
_GMSH_ELEM = {3: ("quad", 4), 5: ("hex", 8), 1: ("segment", 2),
              2: ("tri", 3), 4: ("tet", 4)}
_GMSH_BDR_FOR = {"quad": "segment", "hex": "quad", "tri": "segment",
                 "tet": "tri"}


def read_gmsh_mesh(path: str) -> Mesh:
    """Gmsh 2.2 ASCII reader (quad/hex volume elements; physical groups
    become boundary attributes, as the reference's meshes use)."""
    with open(path) as f:
        text = f.read()

    def block(name):
        start = text.find(f"${name}\n")
        if start < 0:
            return None
        end = text.find(f"$End{name}")
        return text[start + len(name) + 2 : end].strip().splitlines()

    fmt = block("MeshFormat")
    if fmt is None:
        raise ValueError(f"{path}: missing $MeshFormat")
    version = float(fmt[0].split()[0])
    if version >= 3.0:
        raise NotImplementedError(f"{path}: gmsh format {version} (need 2.x ASCII)")

    nlines = block("Nodes")
    nn = int(nlines[0])
    coords = np.zeros((nn, 3))
    id_map = {}
    for k in range(nn):
        parts = nlines[1 + k].split()
        id_map[int(parts[0])] = k
        coords[k] = [float(x) for x in parts[1:4]]

    elines = block("Elements")
    nel = int(elines[0])
    cells = []  # (geom, verts, phys) for every supported cell type
    seen = set()
    for k in range(nel):
        parts = [int(x) for x in elines[1 + k].split()]
        etype = parts[1]
        ntags = parts[2]
        phys = parts[3] if ntags >= 1 else 0
        verts = [id_map[v] for v in parts[3 + ntags :]]
        if etype not in _GMSH_ELEM:
            continue
        g, _ = _GMSH_ELEM[etype]
        cells.append((g, verts, phys))
        seen.add(g)

    # volume dimensionality: hex/tet present -> 3-D (quads/tris are
    # boundary facets); else tri/quad are the 2-D volume and segments the
    # boundary
    if seen & {"hex", "tet"}:
        vol_geoms = seen & {"hex", "tet"}
        dim = 3
    elif seen & {"quad", "tri"}:
        vol_geoms = seen & {"quad", "tri"}
        dim = 2
    else:
        raise ValueError(f"{path}: no supported volume elements found")
    if len(vol_geoms) == 2 and dim == 3:
        raise NotImplementedError(f"{path}: mixed hex/tet meshes")
    bdr_geoms = {_GMSH_BDR_FOR[g] for g in vol_geoms}

    vols = [(g, v, a) for (g, v, a) in cells if g in vol_geoms]
    bdrs = [(a, v) for (g, v, a) in cells if g in bdr_geoms]

    if len(vol_geoms) == 2:  # mixed 2-D tri+quad
        raise _mixed(path, vol_geoms)

    geom = vol_geoms.pop()
    elements = np.asarray([v for _, v, _ in vols], dtype=np.int64)
    eattrs = np.asarray([a for _, _, a in vols], dtype=np.int64)

    if bdrs:
        width = max(len(v) for _, v in bdrs)
        bf = np.zeros((len(bdrs), width), dtype=np.int64)
        ba = np.zeros(len(bdrs), dtype=np.int64)
        for j, (a, v) in enumerate(bdrs):
            bf[j, : len(v)] = v
            ba[j] = a
    else:
        bf = np.zeros((0, 0), dtype=np.int64)
        ba = np.zeros(0, dtype=np.int64)

    return Mesh(
        dim=dim,
        geom=geom,
        vertices=coords[:, :dim],
        elements=elements,
        bdr_faces=bf,
        bdr_attrs=ba,
        elem_attrs=eattrs,
    )


def read_mesh(path: str) -> Mesh:
    if path.endswith(".msh"):
        return read_gmsh_mesh(path)
    return read_mfem_mesh(path)
