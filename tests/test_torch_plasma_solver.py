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
   its ROADMAP item.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tps_torch import harness  # noqa: E402
from tps_torch.dg import cuda_faces  # noqa: E402
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
    assert [type(f) for f in s.ctx.forcings] == [SourceTerm]
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


@pytest.mark.parametrize("edit,item", [
    (lambda t: t.replace("transport_model = argon_minimal",
                         "transport_model = argon_mixture"), "A6.3"),
    (lambda t: t.replace("transport_model = argon_minimal",
                         "transport_model = constant"), "A6.2"),
    (lambda t: t.replace("[io]\n", "[io]\nrestartFromLTE = 1\n"), "A6.4"),
    (lambda t: t.replace("model = arrhenius", "model = tabulated"), "A6.3"),
    (lambda t: t.replace("chemistry_model = 'mass_action_law'",
                         "radiation_model = net_emission"), "A6.3"),
    (lambda t: t.replace("equation_system = navier-stokes",
                         "equation_system = euler"), "A6.2"),
])
def test_unported_plasma_inputs_raise(tmp_path, edit, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        _solver(_deck(tmp_path, edit), tmp_path)


def test_mixture_boundaries_raise(tmp_path):
    """The inflow/outflow argon deck: the mixture BCs are A6.2."""
    with pytest.raises(NotImplementedError, match="ROADMAP A6.2"):
        _solver(os.path.join(HERE, "inputs", "argon_inflow_outflow.ini"),
                tmp_path)
