"""The axisymmetric decks through tps_torch's solvers == the JAX
package's, on the CPU in f64.

1. tps_torch/tools/axisym_pipe.ini (the JAX package's axisymmetric pipe
   deck, tests/test_sharded_solver.py::_axisym_pipe_ini, unpartitioned:
   DryAir Navier-Stokes with swirl state, CFL steps, the axis as an
   inviscid patch, an isothermal wall, inlet and pressure outlet), 4
   forward Euler steps (the deck's RK3 runs on the card against a plain
   loop, chip_smoke.py phase 43) through both packages' chunked solve()
   from tps_tpu's initial state: the state within 1e-9.  Its checkpoint holds the JAX layout with
   z-mom (the swirl), the port restarts from tps_tpu's checkpoint, and the
   ParaView file carries a 3-component velocity.
2. tps_torch/tools/argon_torch_axisym.ini, the compressible argon plasma
   torch in (r, z) with swirl under the Joule coupling, cut to 8x8 p=1
   with an EM mesh of 16x24 and an EM solve every 2 steps, 3 forward
   Euler steps (the JAX package compiles one stage of its step, ~30 s on
   a CPU core, against ~75 s for the deck's RK4) through both packages'
   Tps API from tps_tpu's initial state: the state within 1e-9 and the
   power on target to 1e-8 at each EM solve; through the CLI entry
   (`harness.main`, as `python -m tps_torch --device cpu` runs it, f32)
   to its end.
"""

import os

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
threadpool_limits(1)  # numpy's and scipy's BLAS too: one thread a worker

from tps_torch import harness  # noqa: E402
from tps_torch.io import h5lite  # noqa: E402
from tps_torch.solvers.coupling import CycleAvgJouleCoupling  # noqa: E402
from tps_tpu import harness as jharness  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
TOOLS = os.path.join(os.path.dirname(HERE), "tps_torch", "tools")
PIPE = os.path.join(TOOLS, "axisym_pipe.ini")
TORCH = os.path.join(TOOLS, "argon_torch_axisym.ini")
DECK_TOL = 1e-9
POWER_TOL = 1e-8


@pytest.fixture(autouse=True)
def f64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def _state_rel(U, ref):
    """Per equation relative to its max; the momenta relative to max rho
    times the max speed (the radial and swirl momenta start at 0)."""
    U, ref = np.asarray(U), np.asarray(ref)
    speed = np.max(np.abs(ref[..., 1:4]) / ref[..., :1])
    out = 0.0
    for q in range(ref.shape[-1]):
        scale = np.abs(ref[..., q]).max()
        if 1 <= q <= 3:
            scale = max(scale, ref[..., 0].max() * speed)
        out = max(out, np.abs(U[..., q] - ref[..., q]).max() / scale)
    return out


def _deck(tmp_path, src, name, edits):
    with open(src) as f:
        text = f.read()
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new)
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _tps(mod, path, argv=()):
    tps = mod.Tps()
    tps.parse_command_line_args(["tps", "--runFile", path, *argv])
    tps.parse_input()
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    return tps


def test_pipe_deck_matches_jax(tmp_path):
    # forward Euler: the JAX package compiles one RHS (~6 s on a CPU
    # core) where the deck's RK3 takes three
    euler = ("integrator = rk3", "integrator = forward-euler")
    ours = _deck(tmp_path, PIPE, "pipe.ini", [
        ("outdirBase = output/axisym_pipe", f"outdirBase = {tmp_path / 'p'}"),
        ("[io]\n", "[io]\nenableParaview = 1\n"), euler])
    theirs = _deck(tmp_path, PIPE, "pipe_jax.ini", [
        ("outdirBase = output/axisym_pipe", f"outdirBase = {tmp_path / 'j'}"),
        euler])
    tps = _tps(harness, ours, ["--device", "cpu"])
    jtps = _tps(jharness, theirs)
    s, js = tps.solver, jtps.solver
    assert s.mixture.nvel == 3 and s.fluxes.axisymmetric
    assert [type(f).__name__ for f in s.ctx.forcings] == ["AxisymmetricSource"]
    assert s.tables_np.rad_vol is not None and s._rhs.sweep.variant == \
        "dry_air_axi"
    U0 = js.state_global()
    assert _state_rel(s.state_global(), U0) <= 1e-12
    s.set_state_global(U0)
    tps.solve()
    jtps.solve()
    assert s.iter == js.iter == 4 and s.check_nan() == 0
    assert _state_rel(s.state_global(), js.state_global()) <= DECK_TOL
    # the checkpoint: the JAX layout, the swirl as z-mom
    f = h5lite.read(str(tmp_path / "p" / "restart_output.sol.h5"))
    jf = h5lite.read(str(tmp_path / "j" / "restart_output.sol.h5"))
    names = sorted(f["solution"].keys())
    assert names == sorted(jf["solution"].keys())
    assert "z-mom" in names and int(f.attrs["iteration"]) == 4
    # ParaView: the velocity's three components, the swirl the third
    with open(tmp_path / "p" / "solution_00000004.vtk") as fh:
        lines = fh.read().split("VECTORS velocity double\n")[1].splitlines()
    vel = s.mixture.primitives(s.U)[..., 1:4].reshape(-1, 3).numpy()
    got = np.array([[float(v) for v in ln.split()] for ln in
                    lines[:len(vel)]])
    assert np.allclose(got, vel, rtol=1e-9, atol=1e-12)
    # restart from tps_tpu's checkpoint: iteration and state carry over
    again = _deck(tmp_path, PIPE, "pipe_restart.ini", [
        ("outdirBase = output/axisym_pipe", f"outdirBase = {tmp_path / 'j'}"),
        ("maxIters = 4", "maxIters = 5"),
        ("[io]\n", "[io]\nenableRestart = 1\n"), euler])
    r = _tps(harness, again, ["--device", "cpu"]).solver
    assert r.iter == 4
    assert _state_rel(r.state_global(), js.state_global()) == 0.0


def test_small_torch_deck_matches_jax(tmp_path):
    cut = [("nx = 64", "nx = 8"), ("ny = 64", "ny = 8"),
           ("order = 2", "order = 1"), ("nx = 32", "nx = 16"),
           ("ny = 48", "ny = 24"),
           ("solve-em-every-n = 10", "solve-em-every-n = 2"),
           ("maxIters = 200", "maxIters = 3"),
           ("integrator = rk4", "integrator = forward-euler")]
    path = _deck(tmp_path, TORCH, "torch.ini", cut + [
        ("outdirBase = output/argon_torch_axisym",
         f"outdirBase = {tmp_path / 'out'}")])
    tps = _tps(harness, path, ["--device", "cpu"])
    c = tps.solver
    assert isinstance(c, CycleAvgJouleCoupling)
    assert c.plasma_kind == "compressible"
    assert c.flow.mixture.nvel == 3 and c.flow.fluxes.axisymmetric
    assert c.flow._rhs.sweep.variant == "argon_axi"
    kinds = sorted(type(b.bc).__name__ for b in c.flow.bc_slices)
    assert kinds == ["GeneralWallBC", "InletBC", "OutletBC", "WallBC"]
    jc = _tps(jharness, path).solver
    c.flow.set_state_global(np.asarray(jc.flow.U))
    tps.solve()
    # tps_tpu's coupled loop in its per-step form
    while jc.iter < jc.max_iters:
        jc.solve_step()
    assert c.iter == jc.iter == 3 and len(c.em_log) == 2
    for e in c.em_log:
        assert abs(e["joule"] / e["target"] - 1.0) < POWER_TOL
    assert _state_rel(c.flow.state_global(), jc.flow.U) <= DECK_TOL
    Up = c.flow.mixture.primitives(c.flow.U).numpy()
    assert np.isfinite(Up).all() and np.abs(Up[..., 3]).max() > 0.0
    # the CLI on the plain path, f32
    torch.set_default_dtype(torch.float32)
    cli = _deck(tmp_path, TORCH, "torch_cli.ini", cut + [
        ("outdirBase = output/argon_torch_axisym",
         f"outdirBase = {tmp_path / 'cli'}")])
    assert harness.main(["tps", "--runFile", cli, "--device", "cpu"]) == 0
    f = h5lite.read(str(tmp_path / "cli" / "restart_output.sol.h5"))
    assert int(f.attrs["iteration"]) == 3
    assert np.isfinite(np.asarray(f["solution"]["z-mom"])).all()
