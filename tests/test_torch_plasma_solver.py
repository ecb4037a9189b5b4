"""The argon plasma slice of tps_torch as a whole == the JAX package's, on
the CPU.

1. One right-hand side on tests/inputs/argon_minimal.ini's tables (2-D
   periodic 6x6 p=1 GLL; the slot path with the plasma source term as its
   forcing) against tps_tpu/dg/rhs.py::compute_rhs with its SourceTerm,
   1e-11 of max|column| per equation (the equations have different units).
2. The deck's 4 iterations with the port on the CPU in f64, its checkpoint
   against the committed golden tests/ref_solns/argon_minimal.4iters.h5
   through tools/soln_differ.py with the flags of
   tests/test_statistics_restart.py::test_golden_argon_regression.
3. Each plasma input outside the slice raises NotImplementedError naming
   its ROADMAP item: passive scalars (ROADMAP C: the JAX package's fact
   the port does not copy), axisymmetric flow with
   constant plasma transport (A5.3; the argon ternary's argon_minimal runs
   axisymmetric, tests/test_torch_axisym_dg.py) and the injected `bte`
   rates (A11.3).  The mixture decks with boundaries,
   general and constant transport run: tests/test_torch_mixture_bc.py and
   tests/test_torch_gas_mixture.py; the LTE fluid and LTE restarts run:
   tests/test_torch_lte_fluid.py and tests/test_torch_lte_restart.py.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from threadpoolctl import threadpool_limits

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
threadpool_limits(1)  # numpy's and scipy's BLAS too: one thread a worker

from tps_torch import harness  # noqa: E402
from tps_torch.dg import cuda_faces  # noqa: E402
from tps_torch.dg.forcing import JouleHeating  # noqa: E402
from tps_torch.dg.rhs import compute_rhs  # noqa: E402
from tps_torch.dg.source_term import SourceTerm  # noqa: E402
from tps_tpu.config.ini import IniInput as JIniInput  # noqa: E402
from tps_tpu.dg import rhs as jrhs  # noqa: E402
from tps_tpu.dg.discretization import build_tables as jbuild_tables  # noqa: E402
from tps_tpu.dg.fluxes import Fluxes as JFluxes  # noqa: E402
from tps_tpu.dg.riemann import Rusanov as JRusanov  # noqa: E402
from tps_tpu.dg.source_term import SourceTerm as JSourceTerm  # noqa: E402
from tps_tpu.mesh.generators import box_2d as jbox_2d  # noqa: E402
from tps_tpu.physics.plasma_config import build_plasma as jbuild_plasma  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DECK = os.path.join(HERE, "inputs", "argon_minimal.ini")
GOLDEN = os.path.join(HERE, "ref_solns", "argon_minimal.4iters.h5")
RHS_TOL = 1e-11


@pytest.fixture
def f64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _solver(path, outdir):
    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", path, "--device", "cpu"])
    tps.parse_input()
    tps.config.outdir = str(outdir)
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    return tps


def test_rhs_matches_jax_with_the_source_term(f64, tmp_path):
    s = _solver(DECK, tmp_path).solver
    assert type(s._rhs).__name__ == "SlotRHS"
    assert [type(f) for f in s.ctx.forcings] == [SourceTerm, JouleHeating]
    assert float(torch.max(torch.abs(s.get_joule_heating()))) == 0.0
    mix = s.mixture
    # the deck's uniform state, perturbed (dU/dt = 0 would hide faults):
    # ion fraction ~1e-3 (as the deck's 1e-7 leaves diffusion negligible),
    # Te twice Th, and a smooth wave in every primitive
    xyz = s.tables_np.xyz_dof
    k = 2 * np.pi / 0.01
    wave = (np.sin(k * xyz[..., 0]) * np.cos(k * xyz[..., 1]))[..., None]
    Up0 = mix.primitives(s.U).numpy().mean(axis=(0, 1))
    Up0[4] = 1e-3 * Up0[0] / mix.mw[0]
    Up0[5] = 2.0 * Up0[3]
    Up = Up0 * (1.0 + 0.05 * wave * np.array([1, 1, 1, 1, 3, 2]))
    Up[..., 2] = 3.0 * wave[..., 0]
    U = mix.conservatives(torch.as_tensor(Up))
    cuda_faces.reset_launches()
    y, aux = compute_rhs(s.ctx, s.tables, U)
    assert cuda_faces.launches["face_sweep"] == 0  # CPU: the plain version

    plasma = jbuild_plasma(JIniInput.read(DECK), 2, 2)
    jfl = JFluxes(mixture=plasma.mixture, transport=plasma.transport)
    jctx = jrhs.RHSContext(fluxes=jfl, riemann=JRusanov(jfl), forcings=(
        JSourceTerm(mixture=plasma.mixture, transport=plasma.transport,
                    chemistry=plasma.chemistry),))
    jtab = jbuild_tables(jbox_2d(6, 6, x1=0.01, y1=0.01, periodic_x=True,
                                 periodic_y=True), 1,
                         basis="gauss-lobatto", quad_rule="gauss-lobatto")
    np.testing.assert_array_equal(jtab.xyz_dof, xyz)
    jy, jaux = jax.jit(lambda t, u: jrhs.compute_rhs(jctx, t, u))(
        jtab.to_jax(jnp.float64), jnp.asarray(U.numpy()))
    jy = np.asarray(jy)
    for q in range(6):
        err = np.max(np.abs(y[..., q].numpy() - jy[..., q]))
        assert err <= RHS_TOL * np.max(np.abs(jy[..., q])), (q, err)
    np.testing.assert_allclose(float(aux["max_char_speed"]),
                               float(jaux["max_char_speed"]), rtol=1e-12)
    # the source term is a part of it: without it the species and electron
    # energy columns move
    y0, _ = compute_rhs(dataclasses.replace(s.ctx, forcings=()), s.tables, U)
    for q in (4, 5):
        assert torch.max(torch.abs(y0[..., q] - y[..., q])) > 1e-6 * np.max(
            np.abs(jy[..., q]))


def test_argon_deck_matches_the_golden_checkpoint(f64, tmp_path):
    tps = _solver(DECK, tmp_path)
    tps.solve()
    s = tps.solver
    assert s.iter == 4 and tps.get_status() == 0
    U = s.state_global()
    assert np.all(np.isfinite(U)) and np.all(U[..., 4] >= 0.0)
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "soln_differ.py"),
         "-d", "2", "-s", "-t", "2e-10", "-u", "2e-8", "-e", "1e-11",
         "-y", "1e-9", "-r", str(tmp_path / "restart_output.sol.h5"), GOLDEN],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "rho-Y_Ar.+1" in r.stdout


def _deck(tmp_path, edit):
    with open(DECK) as f:
        text = f.read()
    path = tmp_path / "deck.ini"
    path.write_text(edit(text))
    return str(path)


# the ids of the cases the LTE fluid and restart (edit0, edit1) left
@pytest.mark.parametrize("edit,item", [
    # passive scalars: refused naming the JAX package's fact (ROADMAP C)
    pytest.param(lambda t: t.replace(
        "[io]\n", "[passiveScalars]\nnumScalars = 1\n[io]\n"), "C",
        id="edit2-A5.4"),
    pytest.param(lambda t: t.replace("axisymmetric = False",
                                     "axisymmetric = True").replace(
        "transport_model = argon_minimal", "transport_model = constant"),
        "A5.3", id="edit3-A5.3"),
    pytest.param(lambda t: t.replace("model = arrhenius", "model = bte"),
                 "A11.3", id="edit4-A11.3"),
])
def test_unported_plasma_inputs_raise(tmp_path, edit, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        _solver(_deck(tmp_path, edit), tmp_path)


def test_mixture_boundaries_raise(tmp_path):
    """The inflow/outflow argon deck runs (tests/test_torch_mixture_bc.py
    holds it against the JAX package); with passive scalars it raises,
    naming the JAX package's fact the port does not copy (ROADMAP C)."""
    path = os.path.join(HERE, "inputs", "argon_inflow_outflow.ini")
    s = _solver(path, tmp_path).solver
    assert len(s.bc_slices) == 2
    with open(path) as f:
        text = f.read()
    for old, new, item in (
            ("[io]\n", "[passiveScalars]\nnumScalars = 1\n[io]\n", "C"),):
        deck = tmp_path / "deck.ini"
        deck.write_text(text.replace(old, new))
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            _solver(str(deck), tmp_path)
