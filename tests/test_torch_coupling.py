"""tps_torch's EM <-> low-Mach coupling (solvers/coupling.py) and the
cross-mesh interpolator against the JAX package's, on the CPU in f64.

- FieldInterpolator: values at another mesh's dofs (and at points off the
  mesh, which read 0) from H1 and DG layouts, to 1e-13 of max (the port
  locates points with a vectorised search; values, not element ids, are
  compared: a point on a shared face may land in either element);
- the coupled torch deck of tests/test_coupling.py (6x9 p=2 LTE column,
  axisymmetric with swirl, EM every 4 steps on a 10x10 EM mesh, 8 steps)
  through both packages' per-step loops: T, u, u_theta, p and the total
  Joule heating within 1e-10 of max (every solve to 1e-10 or below), the
  power on target to 1e-8 at both EM solves;
- the other power controls (initial-input-power, oscillating-power,
  fixed-conductivity) on the zero-flow column through both packages: on
  target to 1e-8 at each EM solve, the raw total unchanged while sigma is
  fixed, the fields within 1e-10 of max;
- independent-coupled through the Tps API: both solvers run, with no
  exchange (each equals its plain run);
- the zero-flow coupled case (test_coupling.py's 6x6 p=1 column at rest,
  its checks: the Joule heating warms the column, the power on target to
  1e-8 at each of its three EM solves; the port alone, for the suite's
  time: the JAX package's side costs ~9 s of compiles, and the swirl
  deck above already holds the LTE thermo, the EM solve and the coupling
  to that package);
- examples/cases/torch_axisym_coupled.ini as shipped, maxIters cut to 12,
  through the CLI's entry (`tps_torch.harness.main`, as
  `python -m tps_torch --device cpu` runs it, in f32);
- refusals of what stays out: axisymmetric flow in the compressible
  plasma solver under the coupling (ROADMAP A5.3), a 3-D EM mesh and the
  `em` solver (A10).  The reacting thermo under the coupling runs:
  tests/test_torch_reacting.py; the compressible plasma solver:
  tests/test_torch_compressible_coupling.py, with the LTE fluid
  tests/test_torch_lte_coupled.py.
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
from tps_torch.config.ini import IniInput  # noqa: E402
from tps_torch.config.run_config import parse_run_configuration  # noqa: E402
from tps_torch.fem import h1  # noqa: E402
from tps_torch.interop.interpolation import FieldInterpolator  # noqa: E402
from tps_torch.io import h5lite  # noqa: E402
from tps_torch.mesh.generators import box_2d  # noqa: E402
from tps_torch.solvers.coupling import CycleAvgJouleCoupling  # noqa: E402
from tps_torch.solvers.em.qms import \
    QuasiMagnetostaticSolverAxiSym  # noqa: E402
from tps_tpu.config.ini import IniInput as JIniInput  # noqa: E402
from tps_tpu.config.run_config import \
    parse_run_configuration as jparse  # noqa: E402
from tps_tpu.interop.interpolation import \
    FieldInterpolator as JFieldInterpolator  # noqa: E402
from tps_tpu.mesh.generators import box_2d as jbox_2d  # noqa: E402
from tps_tpu.solvers.coupling import \
    CycleAvgJouleCoupling as JCoupling  # noqa: E402
from tps_tpu.solvers.em.qms import \
    QuasiMagnetostaticSolverAxiSym as JQms  # noqa: E402

HERE = os.path.dirname(__file__)
REPO = os.path.dirname(HERE)
SHIPPED = os.path.join(REPO, "examples", "cases", "torch_axisym_coupled.ini")
F64 = torch.float64
DECK_TOL = 1e-10


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(autouse=True)
def f64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(F64)
    yield
    torch.set_default_dtype(prev)


# ----------------------------------------------------------- interpolator

def test_field_interpolator_values_match():
    src = dict(nx=6, ny=9, x1=0.02, y1=0.08)
    mesh, jmesh = box_2d(**src), jbox_2d(**src)
    tab_np = h1.build_h1(mesh, 2)
    tgt = h1.build_h1(box_2d(7, 5, x0=-0.004, x1=0.03, y0=0.01, y1=0.09), 1)
    pts = np.concatenate([tgt.xyz, tab_np.xyz[::17]])  # shared nodes too
    ours = FieldInterpolator.build(mesh, 2, "gauss-lobatto", pts)
    ref = JFieldInterpolator.build(jmesh, 2, "gauss-lobatto", pts)
    np.testing.assert_array_equal(ours.found, ref.found)
    assert (~ours.found).sum() > 0 and ours.found.sum() > 30
    xyz = tab_np.xyz
    u = np.stack([np.sin(90 * xyz[:, 0]) * np.cos(40 * xyz[:, 1]),
                  xyz[:, 0] * xyz[:, 1]], -1)
    tab = tab_np.to_torch(F64, "cpu")
    got = ours.from_h1(tab, torch.as_tensor(u)).numpy()
    want = np.asarray(ref.from_h1(tab_np, jnp.asarray(u)))
    assert np.abs(got - want).max() < 1e-13 * np.abs(want).max()
    assert np.abs(got[~ours.found]).max() == 0.0
    # the DG layout: the same field gathered per element
    U_el = u[tab_np.elem_dofs]
    got = ours.from_dg(torch.as_tensor(U_el)).numpy()
    want = np.asarray(ref.from_dg(jnp.asarray(U_el)))
    assert np.abs(got - want).max() < 1e-13 * np.abs(want).max()


# ---------------------------------------------------------------- decks

# test_coupling.py's LTE table, conducting from 3 kK (there: 6 kK).  At 6
# kK only the EM mesh's axis nodes conduct, where A = 0, so the raw Joule
# heating is 0 in the port and interpolation rounding (~1e-22 W) in the
# JAX package, which power control multiplies by ~1e24: noise, not a
# result to compare.
LTE_T = np.linspace(200.0, 20000.0, 199)
LTE_DATA = np.stack(
    [LTE_T, 1.8e-5 * (LTE_T / 300.0) ** 0.7, 0.025 * (LTE_T / 300.0) ** 0.8,
     np.where(LTE_T > 3000.0, 50.0 * (LTE_T - 3000.0) / 17000.0, 0.0),
     np.full_like(LTE_T, 287.0), np.full_like(LTE_T, 1004.0)], axis=1)

SWIRL_DECK = """
[solver]
type = cycle-avg-joule-coupled
[cycle-avg-joule-coupled]
plasma-solver = lomach
axisymmetric = 1
solve-em-every-n = 4
input-power = 100.0
[mesh]
generator = box2d
nx = 6
ny = 9
x1 = 0.02
y1 = 0.08
[loMach]
order = 2
axisymmetric = 1
swirl = 1
flow-solver = tomboulides
thermo-solver = lte-thermo-chem
maxIters = 8
outputFreq = 1000
[loMach/ltethermo]
table-file = {tf}
[initialConditions]
profile = gaussian
temperature = 8000.0
backgroundTemperature = 300.0
center = '0.0 0.04'
width = '0.009 0.025'
[time]
dt_fixed = 2.5e-7
[boundaryConditions/inlet1]
patch = 1
type = inlet
velocity = '0.0 1.0'
rampTime = 2e-5
temperature = 300.0
[boundaryConditions/wall1]
patch = 2
type = viscous
temperature = 300.0
[boundaryConditions/outlet1]
patch = 3
type = outlet
pressure = 0.0
[io]
outdirBase = {out}
"""

ZERO_FLOW_DECK = """
[solver]
type = cycle-avg-joule-coupled
[cycle-avg-joule-coupled]
plasma-solver = lomach
axisymmetric = 1
solve-em-every-n = 2
input-power = 100.0
[mesh]
generator = box2d
nx = 6
ny = 6
x1 = 0.01
y1 = 0.01
periodic_y = 1
[loMach]
order = 1
axisymmetric = 1
flow-solver = zero-flow
thermo-solver = lte-thermo-chem
maxIters = 6
[loMach/ltethermo]
table-file = {tf}
[initialConditions]
temperature = 8000.0
[time]
dt_fixed = 1e-5
[io]
outdirBase = {out}
"""

# the zero-flow deck under the other power controls: 150 W at step 0
# (initial-input-power), then 100 W x (1 + 0.3 sin(2 pi t / 8e-5)), i.e.
# 130 W at step 2 and 100 W at step 4, with sigma fixed at step 0's
POWER_CONTROL_DECK = ZERO_FLOW_DECK.replace(
    "input-power = 100.0\n",
    "input-power = 100.0\ninitial-input-power = 150.0\n"
    "oscillating-power = 1\ninput-power-amplitude = 0.3\n"
    "input-power-period = 8e-5\nfixed-conductivity = 1\n")
POWER_TARGETS = (150.0, 130.0, 100.0)

ZERO_FLOW_EM = (dict(x0=0.0, x1=0.03, y0=-0.01, y1=0.02), (0.018, 0.005),
                (0.004, 0.004))
CASES = {
    # deck, steps, EM mesh (box, ring center, ring halfwidth)
    "swirl": (SWIRL_DECK, 8, (dict(x0=0.0, x1=0.05, y0=-0.02, y1=0.10),
                              (0.03, 0.04), (0.007, 0.012))),
    "zero_flow": (ZERO_FLOW_DECK, 6, ZERO_FLOW_EM),
    "power_control": (POWER_CONTROL_DECK, 6, ZERO_FLOW_EM),
}


def _em_mesh(gen, box, center, halfwidth):
    m = gen(10, 10, **box)
    cent = m.vertices[m.elements].mean(axis=1)
    attrs = np.ones(m.num_elements, dtype=np.int64)
    attrs[(np.abs(cent[:, 0] - center[0]) < halfwidth[0])
          & (np.abs(cent[:, 1] - center[1]) < halfwidth[1])] = 2
    m.elem_attrs = attrs
    return m


def _build(pkg, deck, em_mesh, out):
    """A package's coupled solver on the deck, the EM mesh given."""
    if pkg == "port":
        rc = parse_run_configuration(IniInput.read(deck))
        mods = (CycleAvgJouleCoupling, QuasiMagnetostaticSolverAxiSym)
        kw = {"device": "cpu"}
    else:
        rc = jparse(JIniInput.read(deck))
        mods = (JCoupling, JQms)
        kw = {}
    rc.raw.values["em/current_amplitude"] = "1e6"
    rc.raw.values["em/current_frequency"] = "1e5"
    rc.raw.values["io/outdirBase"] = str(out)
    em = mods[1](rc, mesh=em_mesh, **kw)
    em.initialize()
    coupled = mods[0](rc, em_solver=em, **kw)
    coupled.initialize()
    return coupled


def _run(case, pkg, d):
    """The case through a package's per-step loop: (solver, the total
    Joule heating after each EM solve)."""
    deck_text, steps, (box, center, hw) = CASES[case]
    tf = d / "lte.h5"
    h5lite.write(str(tf), {"T_mu_kap_sig_R_Cp": LTE_DATA})
    deck = d / "deck.ini"
    deck.write_text(deck_text.format(tf=tf, out=d / "out"))
    gen = box_2d if pkg == "port" else jbox_2d
    c = _build(pkg, str(deck), _em_mesh(gen, box, center, hw), d / pkg)
    joule = []
    for _ in range(steps):
        em_step = c.iter % c.solve_em_every_n == 0
        c.solve_step()
        if em_step:
            joule.append(c.em.total_joule_heating())
    return c, joule


def test_coupled_deck_matches_the_jax_package(tmp_path):
    (ours, joule), (ref, jjoule) = (_run("swirl", pkg, tmp_path)
                                    for pkg in ("port", "jax"))
    assert ours.iter == ref.iter == CASES["swirl"][1]
    th, jth = ours.flow.thermo, ref.flow.thermo
    assert _rel(th.T, jth.T) < DECK_TOL
    assert len(joule) == len(jjoule) == 2
    for q, jq in zip(joule, jjoule):
        assert q == pytest.approx(100.0, rel=1e-8)
        assert q == pytest.approx(jq, rel=DECK_TOL)
    assert _rel(th.joule_heating, jth.joule_heating) < DECK_TOL
    assert _rel(ours.em.A_re, ref.em.A_re) < DECK_TOL
    assert _rel(ours.em.A_im, ref.em.A_im) < DECK_TOL
    assert _rel(ours.flow.efield, ref.flow.efield) < DECK_TOL
    fl, jfl = ours.flow.flow, ref.flow.flow
    assert _rel(fl.u, jfl.u) < DECK_TOL
    assert _rel(fl.p, jfl.p) < DECK_TOL
    # the deck has no swirl inlet: u_theta stays 0 in both
    assert float(fl.ut.abs().max()) == 0.0
    assert np.abs(np.asarray(jfl.ut)).max() == 0.0
    assert max(r["p_res"] for r in ours.flow.info_log) < 1e-9
    assert all(e["relres"] < 1e-12 for e in ours.em_log)


def test_zero_flow_coupled_case(tmp_path):
    """test_coupling.py::test_cycle_avg_joule_coupling_lomach's checks."""
    c, joule = _run("zero_flow", "port", tmp_path)
    T = c.flow.thermo.T
    assert c.iter == CASES["zero_flow"][1] and len(joule) == 3
    assert bool(torch.isfinite(T).all())
    assert float(T.mean()) > 8000.0  # the Joule heating warmed it
    for q in joule:
        assert q == pytest.approx(100.0, rel=1e-8)
    assert all(e["relres"] < 1e-12 and e["joule_raw"] > 0
               for e in c.em_log)


def test_power_control_matches_the_jax_package(tmp_path):
    """initial-input-power, oscillating-power and fixed-conductivity
    (reference cycle_avg_joule_coupling.cpp:66-71, 434-516) on the
    zero-flow column, both packages: the total after control on each
    solve's target, the raw total the same at every solve (sigma stays
    step 0's while the column heats), the fields within DECK_TOL."""
    (ours, joule), (ref, jjoule) = (_run("power_control", pkg, tmp_path)
                                    for pkg in ("port", "jax"))
    assert ours.iter == ref.iter == CASES["power_control"][1]
    assert [e["target"] for e in ours.em_log] == pytest.approx(
        POWER_TARGETS, rel=1e-12)
    for q, jq, want in zip(joule, jjoule, POWER_TARGETS, strict=True):
        assert q == pytest.approx(want, rel=1e-8)
        assert jq == pytest.approx(want, rel=1e-8)
    raw = [e["joule_raw"] for e in ours.em_log]
    assert raw[0] > 0 and max(raw) - min(raw) <= 1e-12 * raw[0]
    th, jth = ours.flow.thermo, ref.flow.thermo
    assert float(th.T.min()) > 8000.0  # heated, so sigma would have moved
    assert _rel(th.T, jth.T) < DECK_TOL
    assert _rel(th.joule_heating, jth.joule_heating) < DECK_TOL
    assert _rel(ours.em.A_re, ref.em.A_re) < DECK_TOL
    assert _rel(ours.flow.efield, ref.flow.efield) < DECK_TOL


INDEPENDENT_DECK = """
[solver]
type = independent-coupled
[flow]
order = 1
maxIters = 2
outputFreq = 100
fluid = dry_air
equation_system = euler
[mesh]
generator = box2d
nx = 4
ny = 4
x1 = 10.0
y1 = 10.0
periodic_x = 1
periodic_y = 1
[time]
cfl = 0.1
integrator = rk2
[initialConditions]
case = isentropic_vortex
[em]
generator = box2d
nx = 6
ny = 6
x0 = 0.0
x1 = 0.03
y0 = -0.01
y1 = 0.02
ring1/center = 0.018 0.005
ring1/halfwidth = 0.005 0.005
current_amplitude = 1e6
current_frequency = 1e5
[io]
outdirBase = {out}
"""


def _tps(deck, solver_type=None):
    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", str(deck), "--device",
                                 "cpu"])
    tps.parse_input()
    if solver_type:
        tps.config.solver_type = solver_type
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    return tps


def test_independent_coupling_runs_both_solvers_apart(tmp_path):
    """independent-coupled (test_cli_solvers.py's deck) through the Tps
    API: one EM solve at step 0, two flow steps, and no exchange: the flow
    equals a plain `flow` run of the deck and the EM field a plain `em-axi`
    solve, bitwise."""
    deck = tmp_path / "deck.ini"
    deck.write_text(INDEPENDENT_DECK.format(out=tmp_path / "out"))
    tps = _tps(deck)
    tps.solve()
    c = tps.solver
    assert tps.get_status() == 0 and c.iter == 2
    assert c.em.last_solve_relres < 1e-12
    flow = _tps(deck, "flow")
    flow.solve()
    assert flow.solver.iter == 2
    assert torch.equal(c.flow.U, flow.solver.U)
    em = _tps(deck, "em-axi").solver
    em.solve_step()
    assert float(em.A_re.abs().max()) > 0
    assert torch.equal(c.em.A_re, em.A_re)
    assert torch.equal(c.em.A_im, em.A_im)


def test_shipped_deck_runs_through_the_cli(tmp_path, capsys):
    """torch_axisym_coupled.ini as shipped, 12 steps, f32 as the CLI runs
    it: two EM solves, the checkpoint at step 12, the column hot and
    finite."""
    text = open(SHIPPED).read()
    text = text.replace("maxIters = 1000", "maxIters = 12")
    text = text.replace("examples/cases/", os.path.join(REPO, "examples",
                                                        "cases", ""))
    text = text.replace("outdirBase = output/torch",
                        f"outdirBase = {tmp_path / 'out'}")
    deck = tmp_path / "torch.ini"
    deck.write_text(text)
    torch.set_default_dtype(torch.float32)  # the CLI's dtype
    rc = harness.main(["tps", "--runFile", str(deck), "--device", "cpu"])
    assert rc == 0
    assert capsys.readouterr().out.count("EM solve: 3 Krylov iters") == 2
    f = h5lite.read(str(tmp_path / "out" / "restart_lomach.sol.h5"))
    assert int(f.attrs["iteration"]) == 12
    T = np.asarray(f["solution"]["temperature"])
    u = np.asarray(f["solution"]["velocity"])
    assert np.isfinite(T).all() and np.isfinite(u).all()
    assert T.max() > 7000.0 and T.min() >= 300.0 - 1e-3


# -------------------------------------------------------------- refusals

# (ini keys, run-configuration fields, ROADMAP item); the compressible
# plasma solver under the coupling runs (tests/test_torch_compressible_
# coupling.py), with the LTE fluid too (tests/test_torch_lte_coupled.py),
# in (r, z) too (tests/test_torch_lte_axisym.py); with axisymmetric flow
# on a six-species mixture it raises
REFUSALS = {
    "compressible": ({"cycle-avg-joule-coupled/plasma-solver":
                      "compressible", "species/numSpecies": "6"},
                     {"fluid": "user_defined", "axisymmetric": True},
                     "A5.3"),
    "qms3d": ({"cycle-avg-joule-coupled/axisymmetric": "0"}, {}, "A10"),
    "em3d": ({"solver/type": "em"}, {}, "A10"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_inputs_outside_the_slice_raise(tmp_path, name):
    keys, fields, item = REFUSALS[name]
    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", SHIPPED, "--device",
                                 "cpu"])
    tps.parse_input()
    for k, v in keys.items():
        tps.config.raw.values[k] = v
    for k, v in fields.items():
        setattr(tps.config, k, v)
    tps.config.solver_type = tps.config.raw.values["solver/type"]
    tps.config.outdir = str(tmp_path)
    tps.choose_devices()
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        tps.choose_solver()
        tps.initialize()
