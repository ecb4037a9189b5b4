"""The decks with the compressible closures through tps_torch's solvers ==
the JAX package's, on the CPU in f64.

1. tps_torch/tools/argon_torch_axisym_ml.ini (the axisymmetric argon
   torch under the Joule coupling with the wall distance, the mixing
   length and the viscous sponge) cut to 8x8 p=1 with an EM mesh of
   16x24 and an EM solve every 2 steps, 3 forward Euler steps (as
   tests/test_torch_axisym_decks.py cuts argon_torch_axisym.ini) through both
   packages' Tps API from tps_tpu's initial state: the state within
   STEP_TOL (tests/test_torch_axisym_dg.py's), the power on target at
   each EM solve, the wall-distance tables bit for bit; then the CLI
   entry in f32 to its end.
2. tps_torch/tools/les_channel3d.ini (Roe and Sigma on a 3-D channel of
   air) cut to 4x4x4 p=1, 3 forward Euler steps of its CFL dt through
   both packages' chunked solve() from tps_tpu's initial state with a
   seeded perturbation (so that the Sigma model acts): the state within
   STEP_TOL; then the CLI entry in f32.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tps_torch import harness  # noqa: E402
from tps_torch.io import h5lite  # noqa: E402
from tps_tpu import harness as jharness  # noqa: E402

from test_torch_axisym_decks import _deck, _state_rel, _tps  # noqa: E402
from test_torch_axisym_dg import STEP_TOL  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
TOOLS = os.path.join(os.path.dirname(HERE), "tps_torch", "tools")
ML = os.path.join(TOOLS, "argon_torch_axisym_ml.ini")
LES = os.path.join(TOOLS, "les_channel3d.ini")
POWER_TOL = 1e-8


@pytest.fixture(autouse=True)
def f64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def _tables_equal(s, js):
    for name in ("distance", "f_dist", "dist_slot"):
        a, b = getattr(s.tables_np, name), getattr(js.tables_np, name)
        assert a is not None and np.array_equal(a, np.asarray(b)), name


def test_small_ml_torch_deck_matches_jax(tmp_path):
    cut = [("nx = 64", "nx = 8"), ("ny = 64", "ny = 8"),
           ("order = 2", "order = 1"), ("nx = 32", "nx = 16"),
           ("ny = 48", "ny = 24"),
           ("solve-em-every-n = 10", "solve-em-every-n = 2"),
           ("maxIters = 200", "maxIters = 3"),
           ("integrator = rk4", "integrator = forward-euler")]
    path = _deck(tmp_path, ML, "ml.ini", cut + [
        ("outdirBase = output/argon_torch_axisym_ml",
         f"outdirBase = {tmp_path / 'out'}")])
    tps = _tps(harness, path, ["--device", "cpu"])
    c = tps.solver
    fl = c.flow.fluxes
    assert type(fl.transport).__name__ == "MixingLengthTransport"
    assert fl.visc_sponge is not None and fl.sgs_model is None
    assert c.flow._rhs.sweep.variant == "argon_axi_closure"
    jc = _tps(jharness, path).solver
    _tables_equal(c.flow, jc.flow)
    c.flow.set_state_global(np.asarray(jc.flow.U))
    tps.solve()
    while jc.iter < jc.max_iters:
        jc.solve_step()
    assert c.iter == jc.iter == 3 and len(c.em_log) == 2
    for e in c.em_log:
        assert abs(e["joule"] / e["target"] - 1.0) < POWER_TOL
    assert _state_rel(c.flow.state_global(), jc.flow.U) <= STEP_TOL
    assert np.isfinite(c.flow.mixture.primitives(c.flow.U).numpy()).all()
    # the CLI on the plain path, f32
    torch.set_default_dtype(torch.float32)
    cli = _deck(tmp_path, ML, "ml_cli.ini", cut + [
        ("outdirBase = output/argon_torch_axisym_ml",
         f"outdirBase = {tmp_path / 'cli'}")])
    assert harness.main(["tps", "--runFile", cli, "--device", "cpu"]) == 0
    f = h5lite.read(str(tmp_path / "cli" / "restart_output.sol.h5"))
    assert int(f.attrs["iteration"]) == 3
    assert np.isfinite(np.asarray(f["solution"]["z-mom"])).all()


def test_small_les_channel_matches_jax(tmp_path):
    cut = [("nx = 32", "nx = 4"), ("ny = 16", "ny = 4"), ("nz = 16", "nz = 4"),
           ("order = 2", "order = 1"), ("maxIters = 200", "maxIters = 3"),
           ("integrator = rk4", "integrator = forward-euler")]
    path = _deck(tmp_path, LES, "les.ini", cut + [
        ("outdirBase = output/les_channel3d",
         f"outdirBase = {tmp_path / 'out'}")])
    tps = _tps(harness, path, ["--device", "cpu"])
    jtps = _tps(jharness, path)
    s, js = tps.solver, jtps.solver
    assert type(s.riemann).__name__ == "Roe"
    assert type(s.fluxes.sgs_model).__name__ == "Sigma"
    assert s._rhs.sweep.variant == "dry_air_roe_3d_closure"
    U0 = np.asarray(js.state_global()).copy()
    xyz = s.tables_np.xyz_dof
    rng = np.random.default_rng(6)
    for q in (1, 2, 3):
        k = rng.uniform(0.5, 1.5, 3)
        U0[..., q] += 3.0 * U0[..., 0] * np.prod(np.sin(k * xyz), axis=-1)
    s.set_state_global(U0)
    js.set_state_global(U0)
    tps.solve()
    jtps.solve()
    assert s.iter == js.iter == 3
    assert _state_rel(s.state_global(), js.state_global()) <= STEP_TOL
    torch.set_default_dtype(torch.float32)
    cli = _deck(tmp_path, LES, "les_cli.ini", cut + [
        ("outdirBase = output/les_channel3d",
         f"outdirBase = {tmp_path / 'cli'}")])
    assert harness.main(["tps", "--runFile", cli, "--device", "cpu"]) == 0
    f = h5lite.read(str(tmp_path / "cli" / "restart_output.sol.h5"))
    assert int(f.attrs["iteration"]) == 3
    assert np.isfinite(np.asarray(f["solution"]["rho-E"])).all()
