"""tps_torch's copy of the numpy setup == the JAX package's setup.

tps_torch carries its own numpy mesh / DG-table / config code because the
JAX package cannot be imported without jax.  These tests pin the copy to
the original bit for bit, and check that the port imports with jax absent.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tps_torch.config.ini import IniInput  # noqa: E402
from tps_torch.config.run_config import parse_run_configuration  # noqa: E402
from tps_torch.dg.discretization import build_tables, tables_from_numpy  # noqa: E402
from tps_torch.mesh.generators import box_2d, box_3d  # noqa: E402
from tps_tpu.config.ini import IniInput as JIniInput  # noqa: E402
from tps_tpu.config.run_config import parse_run_configuration as jparse  # noqa: E402
from tps_tpu.dg.discretization import build_tables as jbuild_tables  # noqa: E402
from tps_tpu.mesh.generators import box_2d as jbox_2d  # noqa: E402
from tps_tpu.mesh.generators import box_3d as jbox_3d  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = [((4, 4, 8), 2), ((4, 4, 8), 3), ((6, 6), 2)]


def _tables(n, order):
    if len(n) == 3:
        ours = build_tables(box_3d(*n, periodic=(True, True, True)), order)
        ref = jbuild_tables(jbox_3d(*n, periodic=(True, True, True)), order)
    else:
        ours = build_tables(box_2d(*n, periodic_x=True, periodic_y=True), order)
        ref = jbuild_tables(jbox_2d(*n, periodic_x=True, periodic_y=True),
                            order)
    return ours, ref


def _assert_tables_equal(ours, ref):
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray), f.name
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("n,order", CASES)
def test_tables_bit_equal(n, order):
    ours, ref = _tables(n, order)
    _assert_tables_equal(ours, ref)
    assert ours.roll_info is not None and ours.roll_info == ref.roll_info


@pytest.mark.parametrize("n,order", CASES[:1])
def test_tables_carry_over(n, order):
    """tables_from_numpy takes the JAX package's tables as they are, and
    to_torch moves them to tensors of the requested dtype."""
    _ours, ref = _tables(n, order)
    carried = tables_from_numpy(ref)
    _assert_tables_equal(carried, ref)
    tt = carried.to_torch(torch.float32, "cpu")
    assert tt.xyz_dof.dtype == torch.float32
    assert tt.nbr_row.dtype == torch.int32
    np.testing.assert_array_equal(tt.Btr.double().numpy(),
                                  ref.Btr.astype(np.float32))


def test_run_configuration_equal():
    path = os.path.join(REPO, "examples", "cases", "vortex3d_ns.ini")
    ours = parse_run_configuration(IniInput.read(path))
    ref = jparse(JIniInput.read(path))
    a, b = dataclasses.asdict(ours), dataclasses.asdict(ref)
    assert a == b


def test_import_without_jax():
    """The port imports with jax and h5py unavailable, and initializes no
    CUDA and builds no kernel at import time."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['h5py'] = None\n"
        "import tps_torch, tps_torch.harness, tps_torch.dg.cuda_fused\n"
        "import tps_torch.solvers.compressible, tps_torch.dg.cuda_faces\n"
        "import tps_torch.dg.rhs, tps_torch.tools.face_prototype\n"
        "import tps_torch.dg.bc, tps_torch.io.h5lite, tps_torch.io.restart\n"
        "import tps_torch.io.visualization, tps_torch.mesh.mfem_reader\n"
        "import tps_torch.mesh.refine, tps_torch.dg.source_term\n"
        "import tps_torch.physics.collision_integrals\n"
        "import tps_torch.physics.perfect_mixture\n"
        "import tps_torch.physics.gas_transport, tps_torch.physics.chemistry\n"
        "import tps_torch.physics.plasma_config\n"
        "import torch\n"
        "assert not any(m.startswith('tps_tpu') for m in sys.modules)\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert tps_torch.dg.cuda_fused._Library.lib is None\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_no_module_imports_jax_h5py_or_the_jax_package():
    """No module of tps_torch, nor chip_smoke.py, imports jax, h5py or
    anything of tps_tpu (read from their import statements)."""
    import ast

    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO, "tps_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    bad = []
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(os.path.relpath(path, REPO), n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "h5py", "tps_tpu")]
    assert len(paths) > 30 and not bad, bad
