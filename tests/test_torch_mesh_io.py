"""tps_torch's mesh files, refinement and mesh options == the JAX package's.

read_mfem_mesh (straight, curved L2 nodes, hex), read_gmsh_mesh,
refine_uniform, make_periodic and the solver's _apply_mesh_options give
arrays np.array_equal to the JAX package's on meshes the tests write (the
writers are copies of tests/test_mesh_io.py's); the port's MFEM writer
round-trips the generators' meshes; a mixed mesh raises ROADMAP A7.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tps_torch.config.ini import IniInput  # noqa: E402
from tps_torch.dg.discretization import build_tables  # noqa: E402
from tps_torch.mesh import generators  # noqa: E402
from tps_torch.mesh.mesh import make_periodic  # noqa: E402
from tps_torch.mesh.mfem_reader import (read_gmsh_mesh, read_mesh,  # noqa: E402
                                        read_mfem_mesh, write_mfem_mesh)
from tps_torch.mesh.refine import refine_uniform  # noqa: E402
from tps_torch.solvers.compressible import _apply_mesh_options  # noqa: E402
from tps_tpu.config.ini import IniInput as JIniInput  # noqa: E402
from tps_tpu.mesh import mfem_reader as jreader  # noqa: E402
from tps_tpu.mesh.mesh import make_periodic as jmake_periodic  # noqa: E402
from tps_tpu.mesh.refine import refine_uniform as jrefine_uniform  # noqa: E402
from tps_tpu.solvers.compressible import _apply_mesh_options as japply  # noqa: E402

# tests/test_mesh_io.py's two-quad meshes
MFEM_QUAD = """\
MFEM mesh v1.0

dimension
2

elements
2
1 3 0 1 4 3
2 3 1 2 5 4

boundary
6
1 1 0 1
1 1 1 2
2 1 2 5
3 1 5 4
3 1 4 3
4 1 3 0

vertices
6
2
0 0
1 0
2 0
0 1
1 1
2 1
"""

GMSH_QUAD = """\
$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
6
1 0 0 0
2 1 0 0
3 2 0 0
4 0 1 0
5 1 1 0
6 2 1 0
$EndNodes
$Elements
8
1 1 2 11 1 1 2
2 1 2 11 2 2 3
3 1 2 12 3 3 6
4 1 2 13 4 6 5
5 1 2 13 5 5 4
6 1 2 14 6 4 1
7 3 2 99 7 1 2 5 4
8 3 2 99 8 2 3 6 5
$EndElements
"""

# one curved quad: an L2 P2 Gauss-Lobatto nodes block (bulged top edge)
MFEM_CURVED = """\
MFEM mesh v1.0

dimension
2

elements
1
1 3 0 1 2 3

boundary
4
1 1 0 1
2 1 1 2
3 1 2 3
4 1 3 0

vertices
4

nodes
FiniteElementSpace
FiniteElementCollection: L2_T1_2D_P2
VDim: 2
Ordering: 1

0 0
0.5 0
1 0
0 0.5
0.5 0.55
1 0.5
0 1
0.5 1.2
1 1
"""

MIXED = """\
MFEM mesh v1.0

dimension
2

elements
2
1 3 0 1 4 3
1 2 1 2 4

boundary
0

vertices
5
2
0 0
1 0
2 0
0 1
1 1
"""


def _write_mfem_box(path, nx, ny, Lx, Ly):
    """Axis-aligned quad MFEM v1.0 mesh on [0,Lx]x[0,Ly] with the box_2d
    attribute convention (1=bottom, 2=right, 3=top, 4=left)."""
    nvx, nvy = nx + 1, ny + 1

    def vid(i, j):
        return i + nvx * j

    elems = []
    for j in range(ny):
        for i in range(nx):
            elems.append((vid(i, j), vid(i + 1, j), vid(i + 1, j + 1),
                          vid(i, j + 1)))
    bdr = []
    for i in range(nx):
        bdr.append((1, vid(i, 0), vid(i + 1, 0)))
        bdr.append((3, vid(i, nvy - 1), vid(i + 1, nvy - 1)))
    for j in range(ny):
        bdr.append((2, vid(nvx - 1, j), vid(nvx - 1, j + 1)))
        bdr.append((4, vid(0, j), vid(0, j + 1)))
    with open(path, "w") as f:
        f.write("MFEM mesh v1.0\n\ndimension\n2\n\n")
        f.write(f"elements\n{len(elems)}\n")
        for e in elems:
            f.write("1 3 " + " ".join(map(str, e)) + "\n")
        f.write(f"\nboundary\n{len(bdr)}\n")
        for a, v0, v1 in bdr:
            f.write(f"{a} 1 {v0} {v1}\n")
        f.write(f"\nvertices\n{nvx * nvy}\n2\n")
        for j in range(nvy):
            for i in range(nvx):
                f.write(f"{i * Lx / nx} {j * Ly / ny}\n")


def _same_mesh(a, b):
    """Every field of two Mesh objects equal (arrays np.array_equal)."""
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "periodic_pairs":
            assert len(x) == len(y)
            for (ia, ib, sa), (ja, jb, sb) in zip(x, y):
                assert (ia, ib) == (ja, jb) and np.array_equal(sa, sb)
        elif isinstance(y, np.ndarray) or isinstance(x, np.ndarray):
            assert np.array_equal(x, y), f.name
            assert np.asarray(x).dtype == np.asarray(y).dtype, f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("text,name", [(MFEM_QUAD, "two.mesh"),
                                       (MFEM_CURVED, "curved.mesh"),
                                       (GMSH_QUAD, "two.msh")],
                         ids=["mfem", "mfem_curved", "gmsh"])
def test_readers_match_jax(tmp_path, text, name):
    path = tmp_path / name
    path.write_text(text)
    ours, ref = read_mesh(str(path)), jreader.read_mesh(str(path))
    _same_mesh(ours, ref)
    if name == "curved.mesh":
        assert ours.curved_order == 2 and ours.curved_nodes.shape == (1, 9, 2)
    if name.endswith(".msh"):
        _same_mesh(read_gmsh_mesh(str(path)), ref)


@pytest.mark.parametrize("gen", ["box3d", "box2d", "box3d_tet"])
def test_writer_round_trips_the_generators(tmp_path, gen):
    """write_mfem_mesh then read_mfem_mesh (port and JAX package) gives
    the generator's vertices, connectivity, boundary and attributes, and
    the same DG tables."""
    mesh = {"box3d": lambda: generators.box_3d(4, 3, 2),
            "box2d": lambda: generators.box_2d(5, 3, x1=0.05, y1=0.03),
            "box3d_tet": lambda: generators.box_3d_tet(2, 2, 1)}[gen]()
    path = str(tmp_path / "m.mesh")
    write_mfem_mesh(path, mesh)
    back = read_mfem_mesh(path)
    _same_mesh(back, jreader.read_mfem_mesh(path))
    for k in ("vertices", "elements", "bdr_faces", "bdr_attrs"):
        assert np.array_equal(getattr(back, k), getattr(mesh, k)), k
    assert np.array_equal(back.attributes(), mesh.attributes())
    if gen != "box3d_tet":
        a = build_tables(back, 2)
        b = build_tables(dataclasses.replace(mesh, grid_shape=None), 2)
        assert np.array_equal(a.xyz_dof, b.xyz_dof)
        assert np.array_equal(a.f_bdr_attr, b.f_bdr_attr)
        assert np.array_equal(a.nbr_row, b.nbr_row)


@pytest.mark.parametrize("case", ["quad", "hex", "tri", "periodic"])
def test_refine_uniform_matches_jax(case):
    mesh = {"quad": lambda: generators.box_2d(3, 2),
            "hex": lambda: generators.box_3d(2, 2, 1),
            "tri": lambda: generators.box_2d_tri(2, 2),
            "periodic": lambda: generators.box_2d(
                3, 2, periodic_x=True, periodic_y=True)}[case]()
    _same_mesh(refine_uniform(mesh, 2), jrefine_uniform(mesh, 2))


def test_make_periodic_matches_jax(tmp_path):
    path = str(tmp_path / "box.mesh")
    _write_mfem_box(path, 4, 3, 10.0, 6.0)
    mesh = read_mfem_mesh(path)
    trans = [np.array([10.0, 0.0]), np.array([0.0, 6.0])]
    ours, ref = make_periodic(mesh, trans), jmake_periodic(mesh, trans)
    _same_mesh(ours, ref)
    assert len(ours.periodic_pairs) == 7
    assert build_tables(ours, 2).f_bdr_attr.size == 0


@pytest.mark.parametrize("options", [
    "[flow]\nrefinement_levels = 1\n",
    "[periodicity]\nenablePeriodic = 1\nxTrans = 10.0\n",
    "[flow]\nrefinement_levels = 2\n[periodicity]\nenablePeriodic = 1\n"
    "xTrans = 10.0\nyTrans = 6.0\n",
], ids=["refine", "periodic_x", "refine_periodic_xy"])
def test_apply_mesh_options_matches_jax(tmp_path, options):
    mpath = str(tmp_path / "box.mesh")
    _write_mfem_box(mpath, 4, 3, 10.0, 6.0)
    ini = tmp_path / "opts.ini"
    ini.write_text(options)
    mesh = read_mfem_mesh(mpath)
    _same_mesh(_apply_mesh_options(mesh, IniInput.read(str(ini))),
               japply(mesh, JIniInput.read(str(ini))))


def test_mixed_mesh_raises(tmp_path):
    path = tmp_path / "mixed.mesh"
    path.write_text(MIXED)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        read_mfem_mesh(str(path))
