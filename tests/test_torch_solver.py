"""tps_torch's solver, driven like a user would, on the CPU.

Part 1: the JAX package's solver and the port's (device cpu, the plain
PyTorch RHS) on one small 3-D Navier-Stokes deck, from the same perturbed
state: after 5 CFL-controlled RK4 steps U, t and dt agree to 1e-10.
Part 2: the isentropic vortex advected to t=2 through the port (relative
L2 < 5e-3, as the JAX package's canonical drive asks).  Part 3: the
general (slot) path through the solver: the reference-default
Gauss-Lobatto deck and a 2-D deck with walls, an inlet and an outlet, each
against the JAX solver after 5 steps (1e-10).  Then the CLI surface: the
timing line, the NaN guard, and the inputs the slice refuses.
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
    assert "writes no checkpoints" in out
    assert "time step: 5, physical time" in out
    assert "time step: 10, physical time" in out and "s/iter" in out


def test_nan_guard_reports_the_step(tmp_path, f64):
    tps = _port_tps(_deck_2d(tmp_path, iters=4, timing=4))
    tps.initialize()
    s = tps.solver
    U = s.state_global().copy()
    U[3, 2, 0] = np.nan
    s.set_state_global(U)
    s.solve_step()  # the guard reads the buffer at the timing cadence
    assert s.iter == 1
    with pytest.raises(FloatingPointError, match="iteration 1 .reported at 4"):
        s.solve()


@pytest.mark.parametrize("extra,match", [
    ("[boundaryConditions/far1]\npatch = 1\ntype = farfield", "ROADMAP A5"),
    ("[io]\nenableRestart = 1", "ROADMAP A4.1"),
    ("[mesh]\npartitions = 2", "ROADMAP A8"),
    ("[io]\nenableParaview = 1", "ROADMAP A12"),
])
def test_unported_inputs_raise(tmp_path, extra, match):
    tps = _port_tps(_deck_2d(tmp_path, extra=extra))
    with pytest.raises(NotImplementedError, match=match):
        tps.initialize()


def _match_jax_solver(path, steps=5):
    """The port's solver (device cpu) and the JAX package's on one deck,
    from the deck's own initial state: after `steps` steps U, t and dt
    agree to 1e-10."""
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
maxIters = 5
timingFreq = 5
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
    inlet, a subsonicPressure outlet; 5 CFL steps against the JAX solver."""
    path = tmp_path / "channel.ini"
    path.write_text(WALLED_2D.format(outdir=tmp_path / "out"))
    s, U0, U = _match_jax_solver(path)
    assert isinstance(s._rhs, SlotRHS) and s.tables_np.nfb == 16
    assert [type(b.bc).__name__ for b in s.ctx.bcs] == [
        "WallBC", "OutletBC", "WallBC", "InletBC"]
    assert np.max(np.abs(U - U0)) > 1e-6 * np.max(np.abs(U0))  # it moved
    out = capsys.readouterr().out
    assert "[INLET]: # of boundary faces               = 3" in out
    assert "[OUTLET]: Total Surface Area                = 0.03000" in out


def test_cuda_device_requires_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: --device cuda is valid here")
    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", _deck_2d(tmp_path)])
    with pytest.raises(RuntimeError, match="--device cpu"):
        tps.choose_devices()
