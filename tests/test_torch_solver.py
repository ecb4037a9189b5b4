"""tps_torch's solver, driven like a user would, on the CPU.

Part 1: the JAX package's solver and the port's (device cpu, the plain
PyTorch RHS) on one small 3-D Navier-Stokes deck, from the same perturbed
state: after 5 CFL-controlled RK4 steps U, t and dt agree to 1e-10.
Part 2: the isentropic vortex advected to t=2 through the port (relative
L2 < 5e-3, as the JAX package's canonical drive asks).  Part 3: the
general (slot) path through the solver: the reference-default
Gauss-Lobatto deck after 5 steps and a 2-D deck with walls, an inlet and
an outlet through each package's chunked solve(), against the JAX solver
(1e-10).  Then the CLI surface: the timing line, the NaN guard, and the
inputs the slice refuses; and the chunked step loop: JAX's chunk lengths,
chunks bitwise equal to single steps, a NaN reported mcsLagSteps late.
"""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tps_torch import harness  # noqa: E402
from tps_torch.dg.discretization import build_tables  # noqa: E402
from tps_torch.dg.fluxes import Fluxes  # noqa: E402
from tps_torch.dg.fused import maybe_build_fused  # noqa: E402
from tps_torch.dg.rhs import RHSContext, SlotRHS  # noqa: E402
from tps_torch.dg.riemann import Rusanov  # noqa: E402
from tps_torch.mesh.generators import box_2d  # noqa: E402
from tps_torch.physics.gas import DryAir  # noqa: E402
from tps_torch.time.integrators import rk4  # noqa: E402
from tps_torch.utils.cases import isentropic_vortex  # noqa: E402

DECK_3D = """
[solver]
type = flow
[flow]
order = 2
basisType = 0
integrationRule = 0
maxIters = {iters}
timingFreq = {timing}
outputFreq = 1000
fluid = dry_air
equation_system = navier-stokes
[mesh]
generator = box3d
nx = 4
ny = 4
nz = 8
periodic_x = 1
periodic_y = 1
periodic_z = 1
[time]
cfl = 0.12
integrator = rk4
[initialConditions]
rho = 1.2
rhoU = 12.0
rhoV = 0.
rhoW = 0.
pressure = 101300
[io]
outdirBase = {outdir}
"""


@pytest.fixture
def f64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _perturbed_U(mix, xyz):
    """Conserved perturbed state (tests/test_pallas_fused.py's field)."""
    tp = 2 * np.pi
    Up = np.zeros(xyz.shape[:-1] + (5,))
    Up[..., 0] = 1.2
    Up[..., 1:4] = (10.0, 3.0, -2.0)
    Up[..., 4] = 300.0
    Up[..., 1] += 5.0 * np.sin(tp * xyz[..., 0]) * np.cos(tp * xyz[..., 1])
    Up[..., 2] += -5.0 * np.cos(tp * xyz[..., 0]) * np.sin(tp * xyz[..., 2])
    Up[..., 4] += 20.0 * np.sin(tp * xyz[..., 2]) * np.cos(tp * xyz[..., 1])
    return mix.conservatives(torch.as_tensor(Up)).numpy()


def _port_tps(path, device="cpu"):
    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", str(path),
                                 "--device", device])
    tps.parse_input()
    tps.choose_devices()
    tps.choose_solver()
    return tps


def test_solver_matches_jax(tmp_path, f64):
    from tps_tpu import harness as jharness

    path = tmp_path / "ns3d.ini"
    path.write_text(DECK_3D.format(iters=5, timing=5, outdir=tmp_path / "out"))

    tps = _port_tps(path)
    tps.initialize()
    s = tps.solver
    U0 = _perturbed_U(s.mixture, s.tables_np.xyz_dof)
    s.set_state_global(U0)

    jtps = jharness.Tps()
    jtps.parse_input(str(path))
    jtps.choose_solver()
    jtps.initialize()
    js = jtps.solver
    js.set_state_global(U0)

    for _ in range(5):
        s.solve_step()
        js.solve_step()
    U, Uj = s.state_global(), np.asarray(js.state_global())
    np.testing.assert_allclose(U, Uj, rtol=1e-10,
                               atol=1e-10 * np.max(np.abs(Uj)))
    np.testing.assert_allclose(float(s.time), float(js.time), rtol=1e-10)
    np.testing.assert_allclose(float(s.dt), float(js.dt), rtol=1e-10)
    assert s.iter == js.iter == 5
    assert np.max(np.abs(U - U0)) > 1e-6 * np.max(np.abs(U0))  # it moved


def test_isentropic_vortex_drive(f64):
    """Advect the isentropic vortex to t=2 (dt=0.02) on a periodic
    16x16 p=2 box; relative L2 error (tests/test_convergence.py's norm
    ratio) < 5e-3 and density positive."""
    mix = DryAir(dim=2, nvel=2, gas_constant=1.0)
    tab_np = build_tables(box_2d(16, 16, x1=10.0, y1=10.0, periodic_x=True,
                                 periodic_y=True), 2)
    tab = tab_np.to_torch(torch.float64, "cpu")
    fl = Fluxes(mixture=mix, eq_system="euler")
    fr = maybe_build_fused(tab_np, RHSContext(fluxes=fl, riemann=Rusanov(fl)),
                           torch.float64, "cpu")
    U2 = fr.to_fused(mix.conservatives(isentropic_vortex(tab.xyz_dof, 0.0, mix)))
    dt, t = 0.02, 0.0
    for _ in range(100):
        U2 = rk4(fr, U2, t, dt)[0]
        t += dt
    U = fr.from_fused(U2)
    Uex = mix.conservatives(isentropic_vortex(tab.xyz_dof, t, mix))
    w = tab.wq[None, :, None] * tab.detJ[..., None]
    num = torch.sum(w * torch.einsum("qd,nde->nqe", tab.Bvol, (U - Uex) ** 2))
    den = torch.sum(w * torch.einsum("qd,nde->nqe", tab.Bvol, Uex**2))
    err = float(torch.sqrt(num / den))
    assert err < 5e-3, err
    assert float(U[..., 0].min()) > 0.0


DECK_2D = """
[solver]
type = flow
[flow]
order = 2
basisType = 0
integrationRule = 0
maxIters = {iters}
timingFreq = {timing}
fluid = dry_air
equation_system = euler
[mesh]
generator = box2d
nx = 4
ny = 4
periodic_x = 1
periodic_y = 1
[time]
cfl = 0.2
integrator = rk3
[initialConditions]
rho = 1.2
rhoU = 12.0
rhoV = 6.0
pressure = 101300
[io]
outdirBase = {outdir}
{extra}
"""


def _deck_2d(tmp_path, iters=10, timing=5, extra=""):
    path = tmp_path / "deck2d.ini"
    path.write_text(DECK_2D.format(iters=iters, timing=timing,
                                   outdir=tmp_path / "out", extra=extra))
    return str(path)


def test_cli_runs_freestream(tmp_path, f64, capsys):
    rc = harness.main(["tps", "--runFile", _deck_2d(tmp_path), "--device",
                       "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert (tmp_path / "out" / "restart_output.sol.h5").exists()
    assert "time step: 5, physical time" in out
    assert "time step: 10, physical time" in out and "s/iter" in out


def test_nan_guard_reports_the_step(tmp_path, f64):
    tps = _port_tps(_deck_2d(tmp_path, iters=4, timing=4))
    tps.initialize()
    s = tps.solver
    U = s.state_global().copy()
    U[3, 2, 0] = np.nan
    s.set_state_global(U)
    s.solve_step()  # the guard reads it 8 steps late, or at the end
    assert s.iter == 1
    with pytest.raises(FloatingPointError, match="iteration 1 .reported at 4"):
        s.solve()


@pytest.mark.parametrize("extra,match", [
    ("[boundaryConditions/in1]\npatch = 1\ntype = interpolate", "ROADMAP A5"),
    ("[mesh]\npartitions = 2", "ROADMAP A8"),
    ("[io]\nenableHistory = 1", "ROADMAP A12"),
])
def test_unported_inputs_raise(tmp_path, extra, match):
    tps = _port_tps(_deck_2d(tmp_path, extra=extra))
    with pytest.raises(NotImplementedError, match=match):
        tps.initialize()


def _match_jax_solver(path, steps=5, chunked=False):
    """The port's solver (device cpu) and the JAX package's on one deck,
    from the deck's own initial state: after `steps` steps (solve_step,
    or with chunked, each one's chunked solve() to the deck's maxIters)
    U, t and dt agree to 1e-10."""
    from tps_tpu import harness as jharness

    tps = _port_tps(path)
    tps.initialize()
    s = tps.solver
    jtps = jharness.Tps()
    jtps.parse_input(str(path))
    jtps.choose_solver()
    jtps.initialize()
    js = jtps.solver
    U0 = s.state_global().copy()
    np.testing.assert_allclose(U0, np.asarray(js.state_global()), rtol=1e-14)
    if chunked:
        s.solve()
        js.solve()
    else:
        for _ in range(steps):
            s.solve_step()
            js.solve_step()
    U, Uj = s.state_global(), np.asarray(js.state_global())
    np.testing.assert_allclose(U, Uj, rtol=1e-10,
                               atol=1e-10 * np.max(np.abs(Uj)))
    np.testing.assert_allclose(float(s.time), float(js.time), rtol=1e-10)
    np.testing.assert_allclose(float(s.dt), float(js.dt), rtol=1e-10)
    assert s.iter == js.iter == steps
    return s, U0, U


def test_gauss_lobatto_deck_names_the_fix(tmp_path, f64):
    """The reference-default GLL basis (no basisType / integrationRule
    keys) runs the general slot path, on the CPU as in the JAX package,
    and matches the JAX solver after 5 steps."""
    path = tmp_path / "gll.ini"
    text = pathlib.Path(_deck_2d(tmp_path)).read_text()
    path.write_text(text.replace("basisType = 0\n", "")
                    .replace("integrationRule = 0\n", ""))
    s, _U0, _U = _match_jax_solver(path)
    assert isinstance(s._rhs, SlotRHS)
    assert s.tables_np.minv_diag is None  # GLL: non-diagonal mass


WALLED_2D = """
[solver]
type = flow
[flow]
order = 2
maxIters = 8
timingFreq = 4
outputFreq = 1000
fluid = dry_air
equation_system = navier-stokes
[mesh]
generator = box2d
nx = 5
ny = 3
x1 = 0.05
y1 = 0.03
[time]
cfl = 0.2
integrator = rk4
[initialConditions]
rho = 1.2
rhoU = 12.0
rhoV = 0.
pressure = 101300
[boundaryConditions/inlet]
patch = 4
type = subsonic
density = 1.2
uvw = '10.0 0.0 0.0'
[boundaryConditions/outlet]
patch = 2
type = subsonicPressure
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
"""


def test_walled_inlet_outlet_deck_matches_jax(tmp_path, f64, capsys):
    """A 2-D channel (GLL, NS): isothermal and adiabatic walls, a subsonic
    inlet, a subsonicPressure outlet; two chunks of 4 CFL steps through
    each package's chunked solve()."""
    path = tmp_path / "channel.ini"
    path.write_text(WALLED_2D.format(outdir=tmp_path / "out"))
    s, U0, U = _match_jax_solver(path, steps=8, chunked=True)
    assert isinstance(s._rhs, SlotRHS) and s.tables_np.nfb == 16
    assert [type(b.bc).__name__ for b in s.ctx.bcs] == [
        "WallBC", "OutletBC", "WallBC", "InletBC"]
    assert np.max(np.abs(U - U0)) > 1e-6 * np.max(np.abs(U0))  # it moved
    out = capsys.readouterr().out
    assert "[INLET]: # of boundary faces               = 3" in out
    assert "[OUTLET]: Total Surface Area                = 0.03000" in out


CHANNEL = pathlib.Path(__file__).parent / "inputs" / "channel2d.ini"


def _channel(tmp_path, sub, max_iters):
    """The port's solver on tests/inputs/channel2d.ini (2-D NS: subsonic
    inlet, pressure outlet, isothermal walls), device cpu."""
    tps = _port_tps(CHANNEL)
    tps.config.max_iters = max_iters
    tps.config.outdir = str(tmp_path / sub)
    tps.initialize()
    return tps.solver


def test_chunk_size_matches_jax(tmp_path):
    """The port's chunk lengths are the JAX solver's on the same settings
    (tests/test_harness.py::test_chunk_size_respects_service_boundaries,
    with timingFreq / checkFreq / outputFreq binding)."""
    from tps_tpu import harness as jharness

    s = _channel(tmp_path, "port", 100)
    jtps = jharness.Tps()
    jtps.input_file = str(CHANNEL)
    jtps.parse_input()
    jtps.config.max_iters = 100
    jtps.config.outdir = str(tmp_path / "jax")
    jtps.choose_devices()
    jtps.choose_solver()
    jtps.initialize()
    js = jtps.solver
    for timing, check, out, it, want in (
            (10, 1000, 1000, 0, 8), (10, 1000, 1000, 6, 4),
            (10, 1000, 1000, 9, 1), (1000, 12, 1000, 5, 4),
            (1000, 1000, 1000, 0, 64), (1000, 1000, 1000, 97, 2),
            (1000, 1000, 20, 3, 16)):
        for solver in (s, js):
            solver.config.timing_freq = timing
            solver.config.exit_check_freq = check
            solver.config.output_freq = out
            solver.iter = it
        assert s._chunk_size() == js._chunk_size() == want, (timing, check,
                                                             out, it)


def test_chunked_solve_matches_per_step(tmp_path, f64):
    """solve_chunk(4) twice is bitwise 8 solve_step() calls (f64, the
    channel deck's walls, inlet and outlet, CFL dt)."""
    a, b = _channel(tmp_path, "a", 8), _channel(tmp_path, "b", 8)
    for _ in range(8):
        a.solve_step()
    b.solve_chunk(4)
    b.solve_chunk(4)
    assert a.iter == b.iter == 8
    np.testing.assert_array_equal(a.state_global(), b.state_global())
    assert float(a.time) == float(b.time) and float(a.dt) == float(b.dt)
    assert float(a.time) > 0


def test_chunked_solve_matches_per_step_characteristic_outlet(tmp_path, f64):
    """The same with the outlet a nonReflectingPressure one, whose ghost
    state the step loop carries in its buffers: bitwise equal, and the
    ghost moved away from its initial interior trace."""
    def channel(sub):
        tps = _port_tps(CHANNEL)
        tps.config.max_iters = 8
        tps.config.outdir = str(tmp_path / sub)
        for spec in tps.config.bcs:
            if spec.kind == "subsonicPressure":
                spec.kind = "nonReflectingPressure"
        tps.initialize()
        return tps.solver

    a, b = channel("a"), channel("b")
    ghost0 = [g.clone() for g in a._loop.bc_states if g is not None]
    assert len(ghost0) == 1
    for _ in range(8):
        a.solve_step()
    b.solve_chunk(4)
    b.solve_chunk(4)
    np.testing.assert_array_equal(a.state_global(), b.state_global())
    ga = [g for g in a._loop.bc_states if g is not None]
    gb = [g for g in b._loop.bc_states if g is not None]
    np.testing.assert_array_equal(ga[0].numpy(), gb[0].numpy())
    assert a._rhs.bc_states[1] is a._loop.bc_states[1]  # the RHS reads them
    assert float(torch.max(torch.abs(ga[0] - ghost0[0]))) > 0


def test_nan_mid_chunk_names_its_step(tmp_path, f64):
    """A NaN that appears at step 3 of a chunk of 4 is reported by the
    guard once it is mcsLagSteps old: after the next chunk, at 8."""
    tps = _port_tps(_deck_2d(tmp_path, iters=12, timing=4))
    tps.config.mcs_lag = 4
    tps.initialize()
    s = tps.solver
    real, calls = s._integrator, []

    def planting(rhs, U, t, dt):
        calls.append(1)
        U2, aux = real(rhs, U, t, dt)
        if len(calls) == 2:  # step 2's result: step 3 starts from a NaN
            U2 = U2.clone()
            U2[3, 0] = np.nan
        return U2, aux

    s._integrator = planting
    with pytest.raises(FloatingPointError,
                       match="iteration 3 .reported at 8,"):
        s.solve()
    assert s.iter == 8


def test_collector_paused_collects_first_and_restores():
    """The guard around a graph capture: dead reference cycles are
    collected on entry (a dead solver's CUDA graphs must not be destroyed
    inside a capture), no automatic collection runs inside, and the
    collector's state comes back, after an error too."""
    import gc
    import weakref

    from tps_torch.solvers.step_graph import collector_paused

    class Cycle:
        pass

    was = gc.isenabled()
    try:
        for enabled in (True, False):
            (gc.enable if enabled else gc.disable)()
            c = Cycle()
            c.me = c
            dead = weakref.ref(c)
            del c
            with pytest.raises(KeyError):
                with collector_paused():
                    assert dead() is None and not gc.isenabled()
                    raise KeyError
            assert gc.isenabled() == enabled
    finally:
        (gc.enable if was else gc.disable)()


def test_cuda_device_requires_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: --device cuda is valid here")
    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", _deck_2d(tmp_path)])
    with pytest.raises(RuntimeError, match="--device cpu"):
        tps.choose_devices()
