"""tps_torch's low-Mach solver (tps_torch/solvers/lomach/) against the JAX
package's, on the CPU in f64.

The same numpy state (the JAX package's H1 tables carried over with
h1_tables_from_numpy, the fields loaded into both models) goes through
one step of each model in both packages:

- Tomboulides.step on a periodic TGV box and on a channel with walls, a
  ramped inlet and a pressure outlet, with the lagged dense factor, and
  on the channel with p-multigrid/Chebyshev (the dense cutoff set to 0
  in both packages; the pure-Neumann p-multigrid and the per-column
  Chebyshev solve are held in tests/test_torch_h1.py): u and p to 1e-10
  of max|u| and max|p|.  Every solve runs to
  its relative tolerance (1e-10 here, 1e-11 on the channel), so solver
  noise, not rounding, sets this bound;
- CaloricallyPerfectThermoChem.step with isothermal walls (plain, and
  with SUPG and a closed system): T and Qt to 1e-10;
- AlgebraicSubgridModel.nut_of for the three models in 2-D and 3-D: to
  1e-12 (no solve: rounding only);
- ZetaModel.step on test_zeta_model.py's sheared channel: 1e-10.

Then tests/inputs/lomach_tgv2d.ini end to end with --device cpu against
the JAX package's LoMachSolver on the same deck (1e-10 of max|u|: 40
steps of solves to 1e-12 each, noise of ~1e-14 found); restarts across
the two packages; the port's convergence guard; speculative blocks are
exact no-ops; the shipped channel_rans.ini's zeta-f fields stay positive
and realizable; and every input outside the slice raises its ROADMAP
item.
"""

import os

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
threadpool_limits(1)  # numpy's and scipy's BLAS too: one thread a worker

import jax.numpy as jnp  # noqa: E402

from tps_torch import harness  # noqa: E402
from tps_torch.fem import h1  # noqa: E402
from tps_torch.mesh.generators import box_2d  # noqa: E402
from tps_torch.solvers.lomach import base as tbase  # noqa: E402
from tps_torch.solvers.lomach import thermo_chem as tthermo  # noqa: E402
from tps_torch.solvers.lomach import tomboulides as ttomb  # noqa: E402
from tps_torch.solvers.lomach.turb import AlgebraicSubgridModel  # noqa: E402
from tps_torch.solvers.lomach.zeta_model import ZetaModel  # noqa: E402
from tps_tpu.fem import h1 as jh1  # noqa: E402
from tps_tpu.harness import Tps as JTps  # noqa: E402
from tps_tpu.mesh.generators import box_2d as jbox_2d  # noqa: E402
from tps_tpu.mesh.generators import box_3d as jbox_3d  # noqa: E402
from tps_tpu.solvers.lomach import base as jbase  # noqa: E402
from tps_tpu.solvers.lomach import thermo_chem as jthermo  # noqa: E402
from tps_tpu.solvers.lomach import tomboulides as jtomb  # noqa: E402
from tps_tpu.solvers.lomach.turb import AlgebraicSubgridModel as JSubgrid  # noqa: E402
from tps_tpu.solvers.lomach.zeta_model import ZetaModel as JZeta  # noqa: E402

HERE = os.path.dirname(__file__)
REPO = os.path.dirname(HERE)
TGV_DECK = os.path.join(HERE, "inputs", "lomach_tgv2d.ini")
CHANNEL_DECK = os.path.join(REPO, "examples", "cases", "channel_rans.ini")
F64 = torch.float64
SOLVE_TOL = 1e-10
DECK_TOL = 1e-10


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _tables(jmesh, order):
    """Both packages' tables from the JAX package's numpy set-up."""
    tab_np = jh1.build_h1(jmesh, order)
    return (h1.h1_tables_from_numpy(tab_np).to_torch(F64, "cpu"),
            tab_np.to_jax(jnp.float64))


class _Frozen:
    """A frozen velocity field for the thermo and turbulence models."""

    def __init__(self, u):
        self._u = u

    def velocity(self):
        return self._u


@pytest.fixture(autouse=True)
def f64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(F64)
    yield
    torch.set_default_dtype(prev)


# ------------------------------------------------------------ Tomboulides


def _flow_case(case):
    """(port mesh, JAX mesh, Tomboulides keywords, thermo properties)."""
    if case == "tgv":
        kw = dict(x1=2 * np.pi, y1=2 * np.pi, periodic_x=True,
                  periodic_y=True)
        return (box_2d(6, 6, **kw), jbox_2d(6, 6, **kw),
                dict(cg_tol=1e-10, cg_maxiter=500), dict(rho=1.0, mu=0.01))
    # test_lomach.py::test_channel_pressure_outlet_and_ramped_inlet
    return (box_2d(12, 4, x1=1.0, y1=0.25), jbox_2d(12, 4, x1=1.0, y1=0.25),
            dict(cg_tol=1e-11, cg_maxiter=600), dict(rho=1.0, mu=5e-3))


def _bcs(mod, case):
    if case == "tgv":
        return {}
    return dict(vel_bcs=[mod.VelocityDirichlet(attrs=(1, 3), value=(0.0, 0.0)),
                         mod.VelocityDirichlet(attrs=(4,), value=(1.0, 0.0),
                                               ramp_time=5e-3)],
                pres_bcs=[mod.PressureDirichlet(attrs=(2,), value=0.0)])


@pytest.mark.parametrize("case,precond", [("tgv", "dense"),
                                          ("channel", "dense"),
                                          ("channel", "pmg")])
def test_tomboulides_step_matches(monkeypatch, case, precond):
    if precond == "pmg":  # past the dense cutoff in both packages
        monkeypatch.setattr(h1, "DENSE_DIRECT_MAX", 0)
        monkeypatch.setattr(jh1, "DENSE_DIRECT_MAX", 0)
    mesh, jmesh, kw, prop = _flow_case(case)
    tt, tj = _tables(jmesh, 2)
    ours = ttomb.Tomboulides(
        tt, tbase.ConstantPropertyThermoChem(tt, **prop), mesh=mesh,
        **kw, **_bcs(ttomb, case))
    ref = jtomb.Tomboulides(
        tj, jbase.ConstantPropertyThermoChem(tj, **prop), mesh=jmesh,
        **kw, **_bcs(jtomb, case))
    # one state in both: a smooth field plus noise, three histories
    xyz = np.asarray(tj.xyz)
    rng = np.random.default_rng(7)
    u0 = np.stack([np.sin(xyz[:, 0]) * np.cos(xyz[:, 1]),
                   -np.cos(xyz[:, 0]) * np.sin(xyz[:, 1])], -1)
    hists = [u0 + 0.01 * rng.standard_normal(u0.shape) for _ in range(3)]
    p0 = rng.standard_normal(len(xyz))
    ours.set_velocity(torch.as_tensor(u0))
    ref.set_velocity(jnp.asarray(u0))
    for i, h in enumerate(hists):
        ours.u_hist[i].copy_(torch.as_tensor(h))
    ref.u_hist = [jnp.asarray(h) for h in hists]
    ours.p.copy_(torch.as_tensor(p0))
    ref.p = jnp.asarray(p0)
    ours.step(tbase.TemporalCoefficients.bdf(3), 1e-3)
    ref.step(jbase.TemporalCoefficients.bdf(3), 1e-3)
    assert (ours._direct is None) == (precond == "pmg") \
        == (ref._direct is None)
    assert _rel(ours.u, ref.u) < SOLVE_TOL
    assert _rel(ours.p, ref.p) < SOLVE_TOL
    info, jinfo = ours.solve_info, ref.solve_info
    assert info["p_res"] < 1e-9 and info["v_res"] < 1e-9
    assert abs(info["p_iters"] - jinfo["p_iters"]) <= 1
    assert abs(info["v_iters"] - jinfo["v_iters"]) <= 1


# ------------------------------------------------------------------ thermo


@pytest.mark.parametrize("variant", ["plain", "supg_closed"])
def test_calorically_perfect_step_matches(variant):
    jmesh = jbox_2d(6, 6)
    tt, tj = _tables(jmesh, 2)
    xyz = np.asarray(tj.xyz)
    vel = np.stack([np.sin(np.pi * xyz[:, 1]), 0.5 * xyz[:, 0]], -1)
    kw = dict(sw_stab=variant != "plain", closed_system=variant != "plain",
              qt_bcs=((2, 4),))
    ours = tthermo.CaloricallyPerfectThermoChem(
        tt, flow=_Frozen(torch.as_tensor(vel)), T_init=300.0,
        temp_bcs=(tthermo.TemperatureDirichlet((4,), 350.0),
                  tthermo.TemperatureDirichlet((2,), 250.0)), **kw)
    ref = jthermo.CaloricallyPerfectThermoChem(
        tj, flow=_Frozen(jnp.asarray(vel)), T_init=300.0,
        temp_bcs=(jthermo.TemperatureDirichlet((4,), 350.0),
                  jthermo.TemperatureDirichlet((2,), 250.0)), **kw)
    T0 = 300.0 + 20.0 * np.sin(2 * xyz[:, 0]) * np.cos(3 * xyz[:, 1])
    ours.set_temperature(T0)
    ref.set_temperature(jnp.asarray(T0))
    ours.step(tbase.TemporalCoefficients.bdf(1), 2e-3)
    ref.step(jbase.TemporalCoefficients.bdf(1), 2e-3)
    assert _rel(ours.T, ref.T) < SOLVE_TOL
    assert _rel(ours.Qt, ref.Qt) < SOLVE_TOL
    assert float(ours.p_thermo) == pytest.approx(float(ref.p_thermo),
                                                 rel=1e-12)
    assert np.abs(ours.Qt.numpy()[h1.boundary_dofs(tt, (2, 4))]).max() == 0


# -------------------------------------------------------------- subgrid


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("model", ["smagorinsky", "sigma", "wale"])
def test_subgrid_nut_matches(model, dim):
    jmesh = jbox_2d(6, 5) if dim == 2 else jbox_3d(3, 3, 3)
    tt, tj = _tables(jmesh, 2)
    rng = np.random.default_rng(11)
    xyz = np.asarray(tj.xyz)
    u = np.stack([np.sin((d + 1) * xyz[:, d % dim] + xyz[:, (d + 1) % dim])
                  for d in range(dim)], -1) \
        + 0.1 * rng.standard_normal((len(xyz), dim))
    ours = AlgebraicSubgridModel(tt, None, model=model)
    ref = JSubgrid(tj, None, model=model)
    assert _rel(ours.delta, ref.delta) == 0.0
    nut, jnut = ours.nut_of(torch.as_tensor(u)), ref.nut_of(jnp.asarray(u))
    assert _rel(nut, jnut) < 1e-12
    assert float(nut.abs().max()) > 0 or (model == "sigma" and dim == 2)


# -------------------------------------------------------------------- zeta


def test_zeta_step_matches():
    """test_zeta_model.py's _setup(): a periodic channel with a frozen
    parabolic profile, walls at y = 0 and 1."""
    jmesh = jbox_2d(12, 4, x1=1.0, y1=1.0, periodic_x=True)
    tt, tj = _tables(jmesh, 2)
    y = np.asarray(tj.xyz)[:, 1]
    u = np.stack([40.0 * y * (1.0 - y), np.zeros_like(y)], -1)
    ours = ZetaModel(tt, _Frozen(torch.as_tensor(u)),
                     tbase.ConstantPropertyThermoChem(tt, rho=1.0, mu=1e-3),
                     wall_attrs=(1, 3), tke_ic=1e-2, tdr_ic=1e-2)
    ref = JZeta(tj, _Frozen(jnp.asarray(u)),
                jbase.ConstantPropertyThermoChem(tj, rho=1.0, mu=1e-3),
                wall_attrs=(1, 3), tke_ic=1e-2, tdr_ic=1e-2)
    for i in range(2):
        ours.step(tbase.TemporalCoefficients.bdf(1), 5e-3)
        ref.step(jbase.TemporalCoefficients.bdf(1), 5e-3)
    for name in ("k", "eps", "v2", "f", "_mut"):
        assert _rel(getattr(ours, name), getattr(ref, name)) < SOLVE_TOL, name
    assert _rel(ours.eddy_viscosity(), ref.eddy_viscosity()) < SOLVE_TOL


# -------------------------------------------------------------- the decks


def _port(deck, outdir, iters=None, keys=None):
    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", deck, "--device", "cpu"])
    tps.parse_input()
    tps.config.outdir = str(outdir)
    if iters is not None:
        tps.config.raw.values["loMach/maxIters"] = str(iters)
    for k, v in (keys or {}).items():
        tps.config.raw.values[k] = v
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    return tps


def _jax(deck, outdir):
    tps = JTps()
    tps.input_file = deck
    tps.parse_input()
    tps.config.raw.values["io/outdirBase"] = str(outdir)
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    return tps


@pytest.fixture(scope="module")
def tgv_runs(tmp_path_factory):
    """lomach_tgv2d.ini (40 steps) through each package."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(F64)
    try:
        out = tmp_path_factory.mktemp("tgv")
        ours = _port(TGV_DECK, out / "port")
        ke0 = float(h1.integrate(ours.solver.tab,
                                 torch.sum(ours.solver.flow.u ** 2, -1)))
        ours.solve()
        ref = _jax(TGV_DECK, out / "jax")
        ref.solve()
    finally:
        torch.set_default_dtype(prev)
    return ours, ref, ke0, out


def test_tgv_deck_matches_the_jax_solver(tgv_runs):
    ours, ref, ke0, _ = tgv_runs
    s, js = ours.solver, ref.solver
    assert ours.get_status() == 0 and s.iter == js.iter == 40
    assert s.time == pytest.approx(js.time, rel=1e-14)
    assert _rel(s.flow.u, js.flow.velocity()) < DECK_TOL
    assert _rel(s.flow.p, js.flow.p) < DECK_TOL
    # the kinetic energy decays as exp(-4 nu t) (test_lomach.py's bar)
    ke = float(h1.integrate(s.tab, torch.sum(s.flow.u ** 2, -1)))
    assert abs(np.sqrt(ke / ke0) - np.exp(-2 * 0.01 * s.time)) < 2e-3
    # every step's solves read back, converged, on the lagged dense factor
    assert len(s.info_log) == 40
    assert max(r["p_res"] for r in s.info_log) < 1e-9
    assert s.flow._direct is not None


def test_port_restart_reads_in_the_jax_package(tgv_runs):
    import h5py

    ours, _ref, _ke0, out = tgv_runs
    s = ours.solver
    path = os.path.join(s.outdir, "restart_lomach.sol.h5")
    with h5py.File(path, "r") as f:
        assert int(f.attrs["iteration"]) == 40
        assert int(f.attrs["dofs_global"]) == s.tab.ndofs
        assert sorted(f["solution"]) == ["eddy_viscosity", "pressure",
                                         "velocity"]
    reader = _jax(TGV_DECK, s.outdir)
    reader.solver.read_restart()
    js = reader.solver
    assert js.iter == 40 and js.time == pytest.approx(s.time, rel=1e-15)
    np.testing.assert_array_equal(np.asarray(js.flow.velocity()),
                                  s.flow.u.numpy())
    np.testing.assert_array_equal(np.asarray(js.flow.p), s.flow.p.numpy())


def test_jax_restart_reads_in_the_port(tgv_runs, tmp_path):
    _ours, ref, _ke0, _out = tgv_runs
    js = ref.solver
    js.outdir = str(tmp_path)
    js.write_restart()
    reader = _port(TGV_DECK, tmp_path)
    s = reader.solver
    s.read_restart()
    assert s.iter == 40 and s.time == js.time
    assert float(s.flow.t) == js.time
    np.testing.assert_array_equal(s.flow.u.numpy(),
                                  np.asarray(js.flow.velocity()))
    np.testing.assert_array_equal(s.flow.p.numpy(), np.asarray(js.flow.p))


def test_speculative_blocks_are_exact_no_ops(tmp_path, monkeypatch):
    """A solve that runs more blocks than it needs ends on the same bits:
    one run as usual, one told every solve needs 6 blocks, p-multigrid
    (several blocks a solve)."""
    monkeypatch.setattr(h1, "DENSE_DIRECT_MAX", 0)
    keys = {"mesh/nx": "6", "mesh/ny": "6", "loMach/order": "2"}
    runs = []
    for extra in (False, True):
        tps = _port(TGV_DECK, tmp_path / str(extra), iters=4, keys=keys)
        s = tps.solver
        if extra:
            s.loops.blocks = {i: 6 for i in range(8)}
        tps.solve()
        runs.append(s)
    assert runs[1].loops.reads < runs[0].loops.reads
    assert torch.equal(runs[0].flow.u, runs[1].flow.u)
    assert torch.equal(runs[0].flow.p, runs[1].flow.p)
    assert runs[0].info_log == runs[1].info_log


def test_unconverged_solve_raises(tmp_path, monkeypatch):
    """A pressure solve stopped at maxiter above tolerance raises when the
    ring is read (mcsLagSteps late), naming the residuals."""
    monkeypatch.setattr(h1, "DENSE_DIRECT_MAX", 0)
    keys = {"mesh/nx": "6", "mesh/ny": "6", "loMach/order": "2",
            "time/maxSolverIteration": "1", "time/mcsLagSteps": "2"}
    tps = _port(TGV_DECK, tmp_path, iters=6, keys=keys)
    with pytest.raises(FloatingPointError, match="did not converge"):
        tps.solve()
    assert tps.solver.iter == 2


def test_channel_deck_zeta_fields(tmp_path):
    """channel_rans.ini as shipped, 40 of its 200 steps: k, eps, v2
    positive, v2 <= 2/3 k, f = 0 at the walls, a checkpoint."""
    tps = _port(CHANNEL_DECK, tmp_path, iters=40)
    tps.solve()
    s = tps.solver
    z = s.turb
    k, eps, v2, f = (a.numpy() for a in (z.k, z.eps, z.v2, z.f))
    y = s.tab_np.xyz[:, 1]
    wall = (y < 1e-12) | (y > 1.0 - 1e-12)
    assert (k > 0).all() and (eps > 0).all() and (v2 > 0).all()
    assert (v2 <= (2.0 / 3.0) * k + 1e-14).all()
    assert np.abs(f[wall]).max() == 0.0
    assert os.path.exists(tmp_path / "restart_lomach.sol.h5")
    assert {"k_iters", "eps_iters", "f_iters", "v2_iters"} <= set(
        s.info_log[-1])


# ---------------------------------------------------------------- refusals

REFUSALS = {
    "averaging": ("[averaging]\nsampleFreq = 10\n", "A12"),
    "partitions": ("[mesh]\npartitions = 2\n", "A8"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_inputs_outside_the_slice_raise(tmp_path, name):
    extra, item = REFUSALS[name]
    deck = tmp_path / "deck.ini"
    with open(TGV_DECK) as f:
        deck.write_text(f.read() + "\n" + extra)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        _port(str(deck), tmp_path)
