"""ParaView-readable output: legacy ASCII VTK unstructured grids.

The JAX package's io/visualization.py (`write_vtk_dg`, `_write_legacy_vtk`;
tps_tpu/io/visualization.py:20-62, 99-129), numpy only.  The role of the
reference's ParaViewDataCollection saves (src/M2ulPhyS.cpp:2043-2045) and
of `tps --visual` (:4073-4154): the mesh and named nodal fields, each
element's nodes written on their own (discontinuous), split into the
sub-cells of its node lattice.
"""

from __future__ import annotations

import os

import numpy as np

_VTK_QUAD = 9
_VTK_HEX = 12


def write_vtk_dg(path, tab_np, fields: dict):
    """DG fields on the numpy tables' nodes: fields maps a name to
    [ne, ndof] or [ne, ndof, k]."""
    xyz = np.asarray(tab_np.xyz_dof)  # [ne, ndof, dim]
    ne, ndof, dim = xyz.shape
    n1d = round(ndof ** (1.0 / dim))
    pts = xyz.reshape(-1, dim)
    pts3 = np.concatenate([pts, np.zeros((len(pts), 1))], axis=1) \
        if dim == 2 else pts

    # sub-cells of each element's tensor node lattice
    cells = []
    if dim == 2:
        for e in range(ne):
            base = e * ndof
            for j in range(n1d - 1):
                for i in range(n1d - 1):
                    v0 = base + i + n1d * j
                    cells.append([v0, v0 + 1, v0 + 1 + n1d, v0 + n1d])
        ctype = _VTK_QUAD
    else:
        for e in range(ne):
            base = e * ndof
            for k in range(n1d - 1):
                for j in range(n1d - 1):
                    for i in range(n1d - 1):
                        v0 = base + i + n1d * (j + n1d * k)
                        cells.append([
                            v0, v0 + 1, v0 + 1 + n1d, v0 + n1d,
                            v0 + n1d**2, v0 + 1 + n1d**2,
                            v0 + 1 + n1d + n1d**2, v0 + n1d + n1d**2,
                        ])
        ctype = _VTK_HEX

    _write_legacy_vtk(path, pts3, cells, ctype,
                      {k: np.asarray(v).reshape(len(pts), -1)
                       for k, v in fields.items()})


def _write_legacy_vtk(path, pts3, cells, ctype, fields):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\ntps-tpu output\nASCII\n")
        f.write("DATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {len(pts3)} double\n")
        np.savetxt(f, pts3, fmt="%.10e")
        nc = len(cells)
        width = len(cells[0])
        f.write(f"CELLS {nc} {nc * (width + 1)}\n")
        arr = np.column_stack([np.full(nc, width), np.asarray(cells)])
        np.savetxt(f, arr, fmt="%d")
        f.write(f"CELL_TYPES {nc}\n")
        np.savetxt(f, np.full(nc, ctype), fmt="%d")
        f.write(f"POINT_DATA {len(pts3)}\n")
        for name, data in fields.items():
            k = data.shape[1]
            if k == 1:
                f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                np.savetxt(f, data, fmt="%.10e")
            else:
                if k == 2:  # vectors padded to 3 components
                    data = np.column_stack([data, np.zeros(len(data))])
                    k = 3
                if k == 3:
                    f.write(f"VECTORS {name} double\n")
                    np.savetxt(f, data, fmt="%.10e")
                else:
                    f.write(f"SCALARS {name} double {min(k, 9)}\n"
                            "LOOKUP_TABLE default\n")
                    np.savetxt(f, data[:, : min(k, 9)], fmt="%.10e")
