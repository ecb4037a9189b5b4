"""tps_torch's copy of the numpy setup == the JAX package's setup.

tps_torch carries its own numpy mesh / DG-table / config code because the
JAX package cannot be imported without jax.  These tests pin the copy to
the original bit for bit, and check that the port imports with jax absent.
The parsed plasma of the compressible decks too: species order and
constants, the general transport's pair table, the radiative decays'
level data and models, and the boundary conditions' input states.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
threadpool_limits(1)  # numpy's and scipy's BLAS too: one thread a worker

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
        "import tps_torch.dg.forcing, tps_torch.physics.radiative_decay\n"
        "import tps_torch.physics.collision_integrals\n"
        "import tps_torch.physics.perfect_mixture\n"
        "import tps_torch.physics.gas_transport, tps_torch.physics.chemistry\n"
        "import tps_torch.physics.plasma_config\n"
        "import tps_torch.fem.h1, tps_torch.solvers.lomach.solver\n"
        "import tps_torch.solvers.lomach.step_graph\n"
        "import tps_torch.solvers.lomach.rans\n"
        "import tps_torch.solvers.lomach.zeta_model\n"
        "import tps_torch.physics.tables, tps_torch.physics.radiation\n"
        "import tps_torch.solvers.lomach.lte_thermo\n"
        "import tps_torch.solvers.lomach.axisym, tps_torch.fem.krylov\n"
        "import tps_torch.solvers.em.qms, tps_torch.solvers.coupling\n"
        "import tps_torch.interop.interpolation\n"
        "import tps_torch.interop.ext_data\n"
        "import tps_torch.solvers.lomach.reacting_flow\n"
        "import tps_torch.solvers.lomach.sponge\n"
        "import tps_torch.dg.sgs, tps_torch.utils.wall_distance\n"
        "import tps_torch.tools.closure_cases\n"
        "import tps_torch.utils.masa, tps_torch.utils.mms\n"
        "import tps_torch.tools.compute_rhs\n"
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


PLASMA_DECKS = {
    "argon_full": os.path.join(REPO, "tests", "inputs", "argon_full.ini"),
    "inflow_outflow": os.path.join(REPO, "tests", "inputs",
                                   "argon_inflow_outflow.ini"),
    "channel_coupled": os.path.join(REPO, "tps_torch", "tools",
                                    "argon_channel_coupled.ini"),
}


@pytest.mark.parametrize("name", list(PLASMA_DECKS))
def test_parsed_plasma_equal(name, tmp_path):
    """Each deck's plasma as both packages parse it: species order and
    per-species constants, the transport (GasMixtureTransport's pair
    table: the same fit functions per pair), the reactions' models (the
    radiative decays' states, indices and radius, and their level data),
    and the BCs' input states (the solvers' BC objects)."""
    from tps_torch.physics import radiative_decay as prd
    from tps_torch.physics.plasma_config import build_plasma
    from tps_tpu.physics import gas_transport as jgt
    from tps_tpu.physics import radiative_decay as jrd
    from tps_tpu.physics.plasma_config import build_plasma as jbuild_plasma

    path = PLASMA_DECKS[name]
    ours = build_plasma(IniInput.read(path), 2, 2)
    ref = jbuild_plasma(JIniInput.read(path), 2, 2)
    assert ours.species_names == ref.species_names
    assert np.array_equal(ours.input_to_mixture, ref.input_to_mixture)
    assert np.array_equal(ours.initial_mass_fractions,
                          ref.initial_mass_fractions)
    for f in ("mw", "charges", "formation_energy", "molar_cv_over_R",
              "degeneracy", "ambipolar", "two_temperature"):
        assert getattr(ours.mixture, f) == getattr(ref.mixture, f), f
    assert type(ours.transport).__name__ == type(ref.transport).__name__
    if isinstance(ref.transport, jgt.GasMixtureTransport):
        assert ours.transport.species_names == ref.transport.species_names
        for pair, kind in ours.transport.pair_kinds.items():
            tag, fns = ref.transport._pair_table[pair]
            table = jgt._CLMB if tag == "CLMB" else jgt._NEUTRAL_KINDS
            assert fns is table[kind], pair
    chem, jchem = ours.chemistry, ref.chemistry
    assert np.array_equal(chem.reactant_stoich, jchem.reactant_stoich)
    assert np.array_equal(chem.product_stoich, jchem.product_stoich)
    assert chem.reaction_energies == jchem.reaction_energies
    for m, jm in zip(chem.models, jchem.models):
        assert type(m).__name__ == type(jm).__name__
        if isinstance(jm, jrd.RadiativeDecay):
            assert (m.upper, m.lower, m.i_upper, m.i_lower, m.radius) == (
                jm.upper, jm.lower, jm.i_upper, jm.i_lower, jm.radius)
    for table in ("E_LVL", "G_LVL", "AJI"):
        ours_t, ref_t = getattr(prd, table), getattr(jrd, table)
        assert ours_t.keys() == ref_t.keys()
        for k in ref_t:
            assert np.array_equal(ours_t[k], ref_t[k]), (table, k)
    assert prd.M_AR == jrd.M_AR
    # the BCs' input states, from both solvers' BC builders
    from tps_torch.solvers.compressible import CompressibleSolver
    from tps_tpu.solvers.compressible import \
        CompressibleSolver as JCompressibleSolver

    rc = parse_run_configuration(IniInput.read(path))
    jrc = jparse(JIniInput.read(path))
    mine, theirs = CompressibleSolver(rc, device="cpu"), \
        JCompressibleSolver(jrc)
    mine.mixture, mine.plasma = ours.mixture, ours
    theirs.mixture, theirs.plasma = ref.mixture, ref
    for spec, jspec in zip(rc.bcs, jrc.bcs):
        b, jb = mine._make_bc(spec), theirs._make_bc(jspec)
        assert type(b).__name__ == type(jb).__name__
        for f in ("input_state", "pressure", "heavy", "electron",
                  "wall_temp", "wall_temp_e", "kind"):
            if hasattr(jb, f):
                assert getattr(b, f) == getattr(jb, f), (spec.kind, f)
