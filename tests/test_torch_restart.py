"""tps_torch's checkpoints (io/restart.py through io/h5lite.py) against the
JAX package's (io/restart.py through h5py), on the CPU in f64.

A checkpoint the JAX solver writes mid-run, read by the port's solver and
continued, ends where the JAX solver's straight run ends (1e-12), and the
same the other way round.  Then the restart surface of the port alone:
the CLI resumes iteration and time (bitwise a straight run), a missing
file raises FileNotFoundError and another mesh ValueError, the
variable-order restart is the JAX package's _resample_order, the
characteristic ghosts are re-seeded from the restored state, a DIE file
checkpoints, and -visual writes the JAX package's VTK file.
"""

import os
import shutil

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
threadpool_limits(1)  # numpy's and scipy's BLAS too: one thread a worker

from tps_torch import harness  # noqa: E402
from tps_torch.dg.rhs import init_bc_states  # noqa: E402

TOL = 1e-12

DECK = """
[solver]
type = flow
[flow]
order = {order}
maxIters = {iters}
timingFreq = 1000
outputFreq = 1000
fluid = dry_air
equation_system = navier-stokes
[mesh]
generator = box2d
nx = {nx}
ny = 3
x1 = 0.05
y1 = 0.03
[time]
cfl = 0.2
integrator = rk4
[initialConditions]
rho = 1.2
rhoU = 12.0
rhoV = 1.0
pressure = 101300
[boundaryConditions/inlet]
patch = 4
type = subsonic
density = 1.2
uvw = '10.0 1.0 0.0'
[boundaryConditions/outlet]
patch = 2
type = {outlet}
pressure = 101000
[boundaryConditions/bottom]
patch = 1
type = viscous_isothermal
temperature = 300
[boundaryConditions/top]
patch = 3
type = viscous_adiabatic
[io]
outdirBase = {outdir}
enableRestart = {restart}
"""


@pytest.fixture
def f64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _deck(path, outdir, iters=4, restart=0, order=2, nx=5,
          outlet="subsonicPressure"):
    path.write_text(DECK.format(order=order, iters=iters, nx=nx,
                                outdir=outdir, restart=restart, outlet=outlet))
    return str(path)


def _port(path):
    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", path, "--device", "cpu"])
    tps.parse_input()
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    return tps


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert np.max(np.abs(a - b)) <= TOL * np.max(np.abs(b))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX solver on DECK: 2 steps, a checkpoint (kept), 2 more."""
    from tps_tpu import harness as jharness

    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    d = tmp_path_factory.mktemp("jax_restart")
    path = _deck(d / "deck.ini", d / "jax")
    jtps = jharness.Tps()
    jtps.parse_input(path)
    jtps.choose_solver()
    jtps.initialize()
    js = jtps.solver
    for _ in range(2):
        js.solve_step()
    js.write_restart()
    ckpt = str(d / "jax_at_2.h5")
    shutil.copy(os.path.join(str(d / "jax"), "restart_output.sol.h5"), ckpt)
    U2 = np.asarray(js.state_global()).copy()
    for _ in range(2):
        js.solve_step()
    yield {"solver": js, "ckpt": ckpt, "U2": U2, "dir": d,
           "U4": np.asarray(js.state_global()).copy(),
           "t4": float(js.time), "dt4": float(js.dt)}
    torch.set_default_dtype(old)


def test_jax_checkpoint_continued_by_the_port(jax_run, tmp_path, f64):
    out = tmp_path / "port"
    os.makedirs(out)
    shutil.copy(jax_run["ckpt"], out / "restart_output.sol.h5")
    s = _port(_deck(tmp_path / "deck.ini", out, restart=1)).solver
    assert s.iter == 2
    np.testing.assert_array_equal(s.state_global(), jax_run["U2"])
    for _ in range(2):
        s.solve_step()
    _close(s.state_global(), jax_run["U4"])
    assert abs(float(s.time) - jax_run["t4"]) <= TOL * jax_run["t4"]
    assert abs(float(s.dt) - jax_run["dt4"]) <= TOL * jax_run["dt4"]


def test_port_checkpoint_continued_by_jax(jax_run, tmp_path, f64):
    s = _port(_deck(tmp_path / "deck.ini", tmp_path / "port")).solver
    for _ in range(2):
        s.solve_step()
    s.write_restart()
    js = jax_run["solver"]
    js._io.read(js, path=str(tmp_path / "port" / "restart_output.sol.h5"))
    assert js.iter == 2
    _close(np.asarray(js.state_global()), jax_run["U2"])
    for _ in range(2):
        js.solve_step()
    _close(np.asarray(js.state_global()), jax_run["U4"])
    assert abs(float(js.time) - jax_run["t4"]) <= TOL * jax_run["t4"]


def test_resume_continues_iteration_and_time(tmp_path, f64):
    """maxIters 4, then enableRestart with maxIters 6: the run resumes at
    4 and ends bitwise where a straight 6-step run ends."""
    assert harness.main(["tps", "--runFile", _deck(
        tmp_path / "a.ini", tmp_path / "out"), "--device", "cpu"]) == 0
    tps = _port(_deck(tmp_path / "b.ini", tmp_path / "out", iters=6,
                      restart=1))
    s = tps.solver
    assert s.iter == 4 and float(s.time) > 0
    t4 = float(s.time)
    tps.solve()
    assert s.iter == 6 and float(s.time) > t4
    straight = _port(_deck(tmp_path / "c.ini", tmp_path / "straight",
                           iters=6)).solver
    straight.solve()
    np.testing.assert_array_equal(s.state_global(), straight.state_global())
    assert float(s.time) == float(straight.time)


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="restart file not found"):
        _port(_deck(tmp_path / "a.ini", tmp_path / "empty", restart=1))


def test_mesh_mismatch_raises(tmp_path, f64):
    assert harness.main(["tps", "--runFile", _deck(
        tmp_path / "a.ini", tmp_path / "out", iters=1), "--device", "cpu"]) == 0
    with pytest.raises(ValueError, match="restart mesh mismatch: file has 15"):
        _port(_deck(tmp_path / "b.ini", tmp_path / "out", nx=6, restart=1))


def test_variable_order_restart(tmp_path, f64):
    """A p=1 checkpoint read by a p=2 run: each element's nodal values
    resampled as the JAX package's _resample_order does."""
    from tps_tpu.io.restart import _resample_order

    s1 = _port(_deck(tmp_path / "a.ini", tmp_path / "out", order=1)).solver
    s1.solve_step()
    s1.write_restart()
    U1 = s1.state_global().copy()
    s2 = _port(_deck(tmp_path / "b.ini", tmp_path / "out", order=2,
                     restart=1)).solver
    want = _resample_order(U1, "quad", 1, 2, "gauss-lobatto")
    np.testing.assert_allclose(s2.state_global(), want, rtol=1e-14,
                               atol=1e-14 * np.max(np.abs(want)))
    assert s2.iter == 1 and float(s2.time) == float(s1.time)


def test_restart_reseeds_characteristic_ghosts(tmp_path, f64):
    """With a nonReflectingPressure outlet the read re-seeds the ghosts from
    the restored state (as the JAX solver does): the continued run equals
    a straight run whose ghosts were re-seeded at the same step."""
    a = _port(_deck(tmp_path / "a.ini", tmp_path / "a",
                    outlet="nonReflectingPressure")).solver
    for _ in range(2):
        a.solve_step()
    a.write_restart()
    a._loop.load_bc_states(init_bc_states(a.ctx, a.tables, a._loop.U))
    b = _port(_deck(tmp_path / "b.ini", tmp_path / "a", restart=1,
                    outlet="nonReflectingPressure")).solver
    ga = [g for g in a._loop.bc_states if g is not None]
    gb = [g for g in b._loop.bc_states if g is not None]
    assert len(ga) == 1
    np.testing.assert_array_equal(ga[0].numpy(), gb[0].numpy())
    for _ in range(2):
        a.solve_step()
        b.solve_step()
    np.testing.assert_array_equal(a.state_global(), b.state_global())


def test_die_file_writes_a_checkpoint(tmp_path, f64):
    out = tmp_path / "out"
    os.makedirs(out)
    (out / "DIE").write_text("")
    path = _deck(tmp_path / "a.ini", out, iters=8)
    with open(path, "a") as f:
        f.write("[jobManagement]\ncheckFreq = 2\n")
    tps = _port(path)
    tps.solve()
    assert tps.get_status() == 10 and tps.solver.iter == 2
    import h5py

    with h5py.File(out / "restart_output.sol.h5", "r") as f:
        assert int(f.attrs["iteration"]) == 2


def test_visual_mode_writes_the_jax_vtk(tmp_path, f64):
    """-visual reads the checkpoint and writes the VTK file the JAX
    package's writer writes from the same fields, byte for byte."""
    from tps_tpu.io.visualization import write_vtk_dg as jwrite

    path = _deck(tmp_path / "a.ini", tmp_path / "out", iters=2)
    assert harness.main(["tps", "--runFile", path, "--device", "cpu"]) == 0
    assert harness.main(["tps", "--runFile", path, "--device", "cpu",
                         "-visual"]) == 0
    vtk = tmp_path / "out" / "solution_00000002.vtk"
    s = _port(path).solver
    s.read_restart()
    mix = s.mixture
    Up = mix.primitives(s.U).numpy()
    jwrite(str(tmp_path / "jax.vtk"), s.tables_np, {
        "density": Up[..., 0], "velocity": Up[..., 1:3],
        "temperature": Up[..., 3], "pressure": mix.pressure(s.U).numpy()})
    assert vtk.read_bytes() == (tmp_path / "jax.vtk").read_bytes()


def test_golden_vortex_regression(tmp_path, f64):
    """The deck of the committed golden tests/ref_solns/vortex2d.5iters.h5
    (tests/test_statistics_restart.py's VORTEX_AVG: tests/inputs/
    vortex2d.ini's periodic Euler box at 6x6 p=2 with the default initial
    condition; its [averaging] section, which does not touch the solution,
    left out: the port's statistics are ROADMAP A12) through the port's CLI
    in f64, 5 steps; its checkpoint against the golden by
    tools/soln_differ.py with test_golden_vortex_regression's flags: the
    port's checkpoint written by h5lite, read by h5py."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    golden = os.path.join(repo, "tests", "ref_solns", "vortex2d.5iters.h5")
    with open(os.path.join(repo, "tests", "inputs", "vortex2d.ini")) as f:
        text = f.read()
    text = text.replace("nx = 8", "nx = 6").replace("ny = 8", "ny = 6")
    text = text.replace("[initialConditions]\ncase = isentropic_vortex\n",
                        "")
    text = text.replace("outdirBase = /tmp/tps_tpu_test_output",
                        f"outdirBase = {tmp_path / 'out'}")
    path = tmp_path / "vortex2d.ini"
    path.write_text(text)
    assert "isentropic_vortex" not in text
    assert harness.main(["tps", "--runFile", str(path), "--device",
                         "cpu"]) == 0
    ckpt = str(tmp_path / "out" / "restart_output.sol.h5")
    r = subprocess.run(
        [sys.executable, os.path.join(repo, "tools", "soln_differ.py"),
         "-d", "2", "-t", "2e-10", "-u", "2e-8", "-e", "1e-11", "-r", ckpt,
         golden], capture_output=True, text=True, cwd=repo)
    assert r.returncode == 0, r.stdout + r.stderr
