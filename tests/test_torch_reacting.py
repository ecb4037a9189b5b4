"""tps_torch's reacting low-Mach thermo-chemistry (solvers/lomach/
reacting_flow.py, TabulatedRate, plasma_config's chemistry_base and net
emission) against the JAX package's, on the CPU in f64.

- pointwise, on a seeded argon state (4x4 p=2, the full plasma tier):
  the transport properties (rho D_s, mu, kappa + kappa_e), the reaction
  source, `_close_species`, the plasma conductivity, a tabulated rate
  through build_plasma, and the ramp-chem blend before, inside and after
  its window: 1e-12 of max (rounding only).  The conductivity is held to
  the JAX package's composition evaluated eagerly: its jitted
  `plasma_conductivity` differs from that by 1.4e-12 of max on this
  state, the port by 1.7e-15;
- the transport and plasma conductivity of an f32 run against the JAX
  package's f64, on the reacting deck's range: 1e-5 of max;
- ReactingFlow steps with the lagged dense factors: the two-species toy,
  periodic and with species, temperature and Qt Dirichlet BCs, and the
  simple tier built from the ini schema (a tabulated rate, a closed
  system); the argon
  full tier with Joule heating and net emission, operator-split and not;
  two first-order steps each (the deck below runs orders 1-3): T, Y and
  Qt to 1e-10 of max;
- bench_lomach_reacting's deck (tps_torch/tools/lomach_reacting.ini) cut
  to 6x12 p=2, 5 steps through both packages' per-step loops: T, Y, u and
  p_thermo to 1e-9 of max, and the closed system's p_thermo after step 1
  (the mass taken at the uniform 8,000 K before the Gaussian IC: 101,325
  to 39,396 Pa) to 1e-12 relative;
- the deck file against bench.py's text, key by key; the CLI on it with
  --device cpu, and without it on a machine with no CUDA (raises);
- the reacting thermo under the cycle-averaged Joule coupling on
  tests/test_coupling.py's 5x5 set-up: the Joule total on 100 W to 1e-8
  in both, sigma > 0, the fields to 1e-9 of max.

Every solve runs to its relative tolerance (1e-12 here), so solver noise,
not rounding, sets the 1e-10 and 1e-9 bounds.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tps_torch import harness  # noqa: E402
from tps_torch.config.ini import IniInput  # noqa: E402
from tps_torch.fem import h1  # noqa: E402
from tps_torch.physics import plasma_config  # noqa: E402
from tps_torch.physics.chemistry import Arrhenius, Chemistry  # noqa: E402
from tps_torch.solvers.lomach import base as tbase  # noqa: E402
from tps_torch.solvers.lomach import reacting_flow as treact  # noqa: E402
from tps_torch.solvers.lomach import solver as tsolver  # noqa: E402
from tps_torch.solvers.lomach.thermo_chem import \
    TemperatureDirichlet  # noqa: E402
from tps_tpu.config.ini import IniInput as JIniInput  # noqa: E402
from tps_tpu.fem import h1 as jh1  # noqa: E402
from tps_tpu.harness import Tps as JTps  # noqa: E402
from tps_tpu.mesh.generators import box_2d as jbox_2d  # noqa: E402
from tps_tpu.physics import plasma_config as jplasma_config  # noqa: E402
from tps_tpu.physics.chemistry import Arrhenius as JArrhenius  # noqa: E402
from tps_tpu.physics.chemistry import Chemistry as JChemistry  # noqa: E402
from tps_tpu.solvers.lomach import base as jbase  # noqa: E402
from tps_tpu.solvers.lomach import reacting_flow as jreact  # noqa: E402
from tps_tpu.solvers.lomach import solver as jsolver  # noqa: E402
from tps_tpu.solvers.lomach.thermo_chem import \
    TemperatureDirichlet as JTemperatureDirichlet  # noqa: E402

HERE = os.path.dirname(__file__)
REPO = os.path.dirname(HERE)
ARGON = os.path.join(HERE, "inputs", "argon_minimal.ini")
DECK = os.path.join(REPO, "tps_torch", "tools", "lomach_reacting.ini")
F64 = torch.float64
POINT_TOL = 1e-12
STEP_TOL = 1e-10
DECK_TOL = 1e-9
F32_TRANSPORT_TOL = 1e-5  # an f32 run's transport against f64


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


def _tables(jmesh, order, dtype=F64):
    """Both packages' tables from the JAX package's numpy set-up (the
    port's in `dtype`, the JAX package's in f64)."""
    tab_np = jh1.build_h1(jmesh, order)
    return (h1.h1_tables_from_numpy(tab_np).to_torch(dtype, "cpu"),
            tab_np.to_jax(jnp.float64))


def _plasma_text(extra=""):
    """argon_minimal.ini's plasma blocks (its [solver] and [io] left out),
    with `extra` before them."""
    argon = open(ARGON).read()
    argon = "[plasma_models]" + argon.split("[plasma_models]", 1)[1]
    return extra + "\n" + argon.rsplit("[io]", 1)[0]


def _argon_pair(T_init=9000.0, extra="", temp_bcs=((), ()), dtype=F64):
    """The argon full tier in both packages on one 4x4 p=2 periodic box
    (test_reacting_flow.py's set-up at p=2; the port in `dtype`)."""
    text = _plasma_text(f"""
[loMach]
ambientPressure = 101325.0
openSystem = 1
[loMach/reacting]
sub-steps = 4
[initialConditions]
temperature = {T_init}
""" + extra)
    tab, jtab = _tables(jbox_2d(4, 4, x1=0.01, y1=0.01, periodic_x=True,
                                periodic_y=True), 2, dtype)
    ours = tsolver._build_reacting_flow(IniInput.parse(text), tab,
                                        temp_bcs[0], 1e-12, 400)
    ref = jsolver._build_reacting_flow(JIniInput.parse(text), jtab,
                                       temp_bcs[1], 1e-12, 400)
    return ours, ref


def _seeded_state(nd, seed):
    """T in [6, 12] kK and Y(Ar+) in [1e-6, 1e-3] (mixture order Ar+, E,
    Ar), before the closure."""
    rng = np.random.default_rng(seed)
    T = 6000.0 + 6000.0 * rng.random(nd)
    Y = np.zeros((nd, 3))
    Y[:, 0] = 10.0 ** (-6.0 + 3.0 * rng.random(nd))
    Y[:, 2] = 1.0 - Y[:, 0]
    return T, Y


def _load(ours, ref, T, Y):
    ref.T = jnp.asarray(T)
    ref.Y = ref._close_species(jnp.asarray(Y))
    ref.T_hist = [ref.T, ref.T]
    ref.Y_hist = [ref.Y, ref.Y]
    ours.set_temperature(torch.as_tensor(T))
    ours.set_mass_fractions(ours._close_species(torch.as_tensor(Y)))


def _port_step(rf, order, dt):
    """A standalone step as the JAX package's ReactingFlow.step takes it:
    the dense factors refreshed when due, then the step."""
    rf.precond_refresh(dt, order)
    if rf._direct_age is not None:
        rf._direct_age += 1
    rf.step(tbase.TemporalCoefficients.bdf(order), dt)


# ------------------------------------------------------------- pointwise

RAMP = """
[loMach/reactingFlow]
ramp-chem = 1
[loMach/reactingFlow/ramp-chem]
ramp_start = 1.0
ramp_time = 2.0
"""
RAMP_BASE = """
[reactions_base/reaction1]
model = arrhenius
reaction_energy = 1.7e6
[reactions_base/reaction1/arrhenius]
A = 1.0
b = 0.0
E = 0.0
"""


def _pointwise(ours, ref, name):
    """(port values, JAX values) of one pointwise module."""
    tT, tY, jT, jY = ours.T, ours.Y, ref.T, ref.Y
    p = 101325.0
    if name == "transport":
        return (torch.cat([v.reshape(len(tT), -1) for v in
                           ours._transport_props(tT, tY, ours.p_thermo)], 1),
                jnp.concatenate([v.reshape(len(jT), -1) for v in
                                 ref._transport_props(jT, jY, p=p)], 1))
    if name == "reaction_source":
        (a, b), (c, d) = (ours._reaction_source(tT, tY, ours.p_thermo),
                          ref._reaction_source(jT, jY, p=p))
        return torch.cat([a, b[:, None]], 1), jnp.concatenate(
            [c, d[:, None]], 1)
    if name == "close_species":
        Y = tY * torch.linspace(0.5, 2.0, len(tT))[:, None]
        return ours._close_species(Y), ref._close_species(jnp.asarray(
            Y.numpy()))
    if name == "plasma_conductivity":
        # the JAX package's own composition, evaluated eagerly: its jitted
        # plasma_conductivity differs from it by 1.4e-12 of max on this
        # state (XLA's fused exp/log), the port from it by 1.7e-15
        return ours.plasma_conductivity(), ref.transport.electric_conductivity(
            *ref._conserved_state(jT, jY, p=p))
    if name == "ramp_chem":
        # before, inside and after the window (1 s, 3 s)
        outs = [], []
        for t in (0.5, 2.0, 1.5, 5.0):
            outs[0].append(ours._reaction_source(
                tT, tY, ours.p_thermo, torch.tensor(t))[0])
            outs[1].append(ref._reaction_source(jT, jY, p=p,
                                                t=jnp.asarray(t))[0])
        return torch.cat(outs[0], 1), jnp.concatenate(outs[1], 1)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["transport", "reaction_source",
                                  "close_species", "plasma_conductivity",
                                  "ramp_chem"])
def test_pointwise_modules_match(name):
    ours, ref = _argon_pair(extra=RAMP + RAMP_BASE if name == "ramp_chem"
                            else "")
    assert (ours.chemistry_base is not None) == (name == "ramp_chem")
    T, Y = _seeded_state(ours.tab.ndofs, seed=5)
    _load(ours, ref, T, Y)
    a, b = _pointwise(ours, ref, name)
    assert np.all(np.isfinite(np.asarray(b)))
    assert _rel(a, b) <= POINT_TOL, (name, _rel(a, b))
    if name == "plasma_conductivity":
        assert float(a.min()) > 0.0


def test_transport_in_float_matches():
    """The argon transport and plasma conductivity of an f32 run against
    the JAX package's in f64, on the reacting deck's range (T 0.3-8 kK,
    Y(Ar+) 1e-8..1e-6): F32_TRANSPORT_TOL of max.  The e-Ar log T fits
    and the third-order electron conductivity cancel ~7 digits, so the
    port evaluates the transport in double (evaluated in float, it misses
    this bar by orders of magnitude)."""
    ours, ref = _argon_pair(dtype=torch.float32)
    nd = ours.tab.ndofs
    rng = np.random.default_rng(7)
    T = 300.0 + 7700.0 * rng.random(nd)
    Y = np.zeros((nd, 3))
    Y[:, 0] = 10.0 ** (-8.0 + 2.0 * rng.random(nd))
    Y[:, 2] = 1.0 - Y[:, 0]
    ref.T = jnp.asarray(T)
    ref.Y = ref._close_species(jnp.asarray(Y))
    ours.set_temperature(torch.as_tensor(T))
    ours.set_mass_fractions(np.array(ref.Y))
    assert ours.T.dtype == ours.Y.dtype == torch.float32
    props = ours._transport_props(ours.T, ours.Y, ours.p_thermo)
    jprops = ref._transport_props(ref.T, ref.Y, p=101325.0)
    for name, a, b in zip(("rho D", "mu", "kappa"), props, jprops):
        assert a.dtype == torch.float32
        assert _rel(a.double(), b) <= F32_TRANSPORT_TOL, (name, _rel(
            a.double(), b))
    sigma = ours.plasma_conductivity()
    jsigma = ref.transport.electric_conductivity(
        *ref._conserved_state(ref.T, ref.Y, p=101325.0))
    assert sigma.dtype == torch.float32
    assert _rel(sigma.double(), jsigma) <= F32_TRANSPORT_TOL


def test_tabulated_rate_matches(tmp_path):
    """A `tabulated` reaction (inline x/f, log-log) through build_plasma in
    both packages: forward rates and the mass creation rates, 1e-12."""
    text = open(ARGON).read().replace(
        "model = arrhenius",
        "model = tabulated\ntabulated/x_log = 1\ntabulated/f_log = 1\n"
        "tabulated/x = '1000 4000 8000 12000 20000'\n"
        "tabulated/f = '1e-30 1e-12 1e-6 1e-3 1.0'")
    ours = plasma_config.build_plasma(IniInput.parse(text), 2, 2)
    ref = jplasma_config.build_plasma(JIniInput.parse(text), 2, 2)
    assert type(ours.chemistry.models[0]).__name__ == "TabulatedRate"
    T, Y = _seeded_state(40, seed=7)
    n_sp = 10.0 * Y / np.asarray(ours.mixture.mw)
    a = ours.chemistry.source(torch.as_tensor(n_sp), torch.as_tensor(T),
                              torch.as_tensor(T))
    b = ref.chemistry.source(jnp.asarray(n_sp), jnp.asarray(T),
                             jnp.asarray(T))
    for x, y in zip(a, b):
        assert _rel(x, y) <= POINT_TOL


# ------------------------------------------------------------------ steps


def _toy_pair(case):
    """The two-species A -> B toy of test_reacting_flow.py in both
    packages (4x4 p=2 periodic), or its species Dirichlet set-up (4x6 p=2,
    a cold inflow of fixed composition, a pure-background isothermal
    wall)."""

    class Mix:  # the indices Chemistry reads
        mw = (0.03, 0.03)
        i_electron = 0
        num_species = 2

    def chem(pkg_chem, pkg_arr, mix):
        return pkg_chem(mixture=mix, reactant_stoich=np.array([[1, 0]]),
                        product_stoich=np.array([[0, 1]]),
                        models=(pkg_arr(A=50.0 if case == "periodic" else 5.0,
                                        b=0.0, E=0.0),),
                        reaction_energies=(0.0,), detailed_balance=(False,),
                        equilibrium_params=((0.0, 0.0, 0.0),))

    if case == "ini":
        tab, jtab = _tables(jbox_2d(4, 4, periodic_x=True, periodic_y=True),
                            2)
        return (tsolver._build_reacting_flow(IniInput.parse(SIMPLE), tab, (),
                                             1e-12, 400),
                jsolver._build_reacting_flow(JIniInput.parse(SIMPLE), jtab,
                                             (), 1e-12, 400))
    if case == "periodic":
        jmesh = jbox_2d(4, 4, periodic_x=True, periodic_y=True)
        kw = dict(formation_energy=(5.0e4, 0.0), n_substeps=4)
    else:
        jmesh = jbox_2d(4, 6, x1=0.01, y1=0.02)
        kw = dict(formation_energy=(1.0e4, 0.0), n_substeps=2, T_init=900.0,
                  qt_bcs=((2,),),
                  spec_bcs=(((1,), [0.05, 0.95]), ((2,), None)))
    tab, jtab = _tables(jmesh, 2)
    common = dict(species_names=["A", "B"], mw=Mix.mw,
                  molar_cv_over_R=(2.5, 2.5), Y_init=np.array([0.3, 0.7]),
                  cg_tol=1e-12, **kw)
    tbc = () if case == "periodic" else (TemperatureDirichlet((1,), 300.0),)
    jbc = () if case == "periodic" else (JTemperatureDirichlet((1,), 300.0),)
    ours = treact.ReactingFlow(
        tab, flow=tbase.ZeroFlow(tab),
        chemistry=chem(Chemistry, Arrhenius,
                       treact.SpeciesSet(Mix.mw, 0)), temp_bcs=tbc, **common)
    ref = jreact.ReactingFlow(
        jtab, flow=jbase.ZeroFlow(jtab), chemistry=chem(JChemistry,
                                                        JArrhenius, Mix()),
        temp_bcs=jbc, **common)
    return ours, ref


# the simple tier from the ini schema: two species of one atom, a
# tabulated A -> B rate, a closed system (the default)
SIMPLE = """
[loMach]
ambientPressure = 101325.0
[initialConditions]
temperature = 500.0
[atoms]
numAtoms = 1
[atoms/atom1]
name = 'A'
mass = 0.03
[species]
numSpecies = 2
[species/species1]
name = 'A'
composition = '{A : 1}'
formation_energy = 5.0e4
initialMassFraction = 0.3
[species/species2]
name = 'B'
composition = '{A : 1}'
initialMassFraction = 0.7
perfect_mixture/constant_molar_cv = 1.5
[reactions]
numberOfReactions = 1
[reactions/reaction1]
reactant_stoichiometry = '1 0'
product_stoichiometry = '0 1'
model = tabulated
tabulated/x = '200 400 800 1600'
tabulated/f = '10 20 40 80'
"""


@pytest.mark.parametrize("case", ["periodic", "dirichlet", "ini"])
def test_two_species_steps_match(case):
    ours, ref = _toy_pair(case)
    assert _rel(ours.Y, ref.Y) == 0.0  # the BC imprint
    for i in range(2):
        _port_step(ours, 1, 1e-4)
        ref.step(jbase.TemporalCoefficients.bdf(1), 1e-4)
        for k in ("T", "Y", "Qt"):
            assert _rel(getattr(ours, k), getattr(ref, k)) <= STEP_TOL, (i, k)
    assert ours.refreshes == 1 and ours._direct is not None
    if case == "ini":  # the closed system's pressure, on the device
        assert ours.closed_system and type(
            ours.chemistry.models[0]).__name__ == "TabulatedRate"
        assert abs(float(ours.p_thermo) - float(ref.p_thermo)) \
            <= 1e-12 * float(ref.p_thermo)
    Y = ours.Y.numpy()
    assert np.abs(Y.sum(axis=1) - 1.0).max() < 1e-12
    if case == "dirichlet":
        wall = h1.boundary_dofs(ours.tab, (2,))
        inlet = np.setdiff1d(h1.boundary_dofs(ours.tab, (1,)), wall)
        assert np.abs(Y[inlet, 0] - 0.05).max() < 1e-14
        assert np.abs(Y[wall, 0]).max() < 1e-14


NEC = """
[plasma_models]
radiation_model = net_emission
[plasma_models/radiation_model/net_emission/tabulated]
x = '300 5000 10000 20000'
f = '0.0 1e3 1e6 1e8'
"""


@pytest.mark.parametrize("split", [1, 0])
def test_argon_steps_match(split):
    """The full tier: ionised, Joule-heated (1e8 W/m^3) and radiating (a
    net-emission table), two steps."""
    ours, ref = _argon_pair(
        extra=f"[loMach/reacting]\noperator-split = {split}\n" + NEC)
    assert ours.radiation is not None and ref.radiation is not None
    T, Y = _seeded_state(ours.tab.ndofs, seed=11)
    _load(ours, ref, T, Y)
    q = np.full(ours.tab.ndofs, 1e8)
    ours.set_joule_heating(torch.as_tensor(q))
    ref.set_joule_heating(jnp.asarray(q))
    for _ in range(2):
        _port_step(ours, 1, 1e-7)
        ref.step(jbase.TemporalCoefficients.bdf(1), 1e-7)
        for k in ("T", "Y", "Qt"):
            assert _rel(getattr(ours, k), getattr(ref, k)) <= STEP_TOL, k
    assert set(ours.info) == {"T_iters", "T_res", "Qt_iters", "Y_iters",
                              "Y_res"}
    me, mi = ours.mw[ours.i_electron], ours.mw[0]
    Y = ours.Y.numpy()
    np.testing.assert_allclose(Y[:, 1], Y[:, 0] * me / mi, rtol=1e-10)


# ------------------------------------------------------------------- deck


def _deck_text(nx, ny, iters):
    with open(DECK) as f:
        text = f.read()
    return (text.replace("nx = 24", f"nx = {nx}")
            .replace("ny = 48", f"ny = {ny}")
            .replace("maxIters = 100", f"maxIters = {iters}"))


def _port_tps(path, outdir):
    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", str(path), "--device",
                                 "cpu"])
    tps.parse_input()
    tps.config.outdir = str(outdir)
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    return tps


def _jax_tps(path, outdir):
    tps = JTps()
    tps.input_file = str(path)
    tps.parse_input()
    tps.config.raw.values["io/outdirBase"] = str(outdir)
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    return tps


@pytest.fixture(scope="module")
def deck_runs(tmp_path_factory):
    """The deck at 6x12 p=2, 5 steps through both packages' per-step
    loops; p_thermo after each step."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(F64)
    try:
        out = tmp_path_factory.mktemp("reacting")
        path = out / "deck.ini"
        path.write_text(_deck_text(6, 12, 5))
        ours = _port_tps(path, out / "port").solver
        ref = _jax_tps(path, out / "jax").solver
        p = []
        for _ in range(5):
            ours.solve_step()
            ref.solve_step()
            p.append((float(ours.thermo.p_thermo),
                      float(ref.thermo.p_thermo)))
        ours.solve_end()
        return ours, ref, p
    finally:
        torch.set_default_dtype(prev)


def test_reacting_deck_matches(deck_runs):
    ours, ref, p = deck_runs
    for name, a, b in (("T", ours.thermo.T, ref.thermo.T),
                       ("Y", ours.thermo.Y, ref.thermo.Y),
                       ("Y(Ar+)", ours.thermo.Y[:, 0], ref.thermo.Y[:, 0]),
                       ("u", ours.flow.u, ref.flow.u)):
        assert _rel(a, b) <= DECK_TOL, name
    for pa, pb in p:
        assert abs(pa - pb) <= DECK_TOL * pb
    # the closed system's mass was taken at the uniform 8,000 K
    assert abs(p[0][0] - p[0][1]) <= 1e-12 * p[0][1]
    assert 39000.0 < p[0][0] < 40000.0
    kinds = {"T_iters", "Y_iters", "Qt_iters", "p_iters", "v_iters"}
    assert kinds <= set(ours.info_log[-1])


def test_deck_file_pins_the_bench(monkeypatch):
    """tps_torch/tools/lomach_reacting.ini holds bench.py's
    bench_lomach_reacting deck key for key, but for [io] outdirBase (a
    path in the checkout)."""
    monkeypatch.syspath_prepend(REPO)
    import bench

    captured = {}

    def capture(text):
        captured["text"] = text
        raise RuntimeError("captured")

    monkeypatch.setattr(bench, "_make_solver", capture)
    with pytest.raises(RuntimeError, match="captured"):
        bench.bench_lomach_reacting()
    a = IniInput.parse(captured["text"]).values
    b = IniInput.read(DECK).values
    assert a.pop("io/outdirBase") != b.pop("io/outdirBase")
    assert a == b
    assert b["mesh/nx"] == "24" and b["mesh/ny"] == "48"


def test_deck_cli(tmp_path, capsys):
    """The deck through the CLI with --device cpu (cut to 6x12, 2 steps,
    f32 as the CLI runs it): a checkpoint with the species; without
    --device cpu and no CUDA, it raises."""
    text = _deck_text(6, 12, 2).replace(
        "outdirBase = output/lomach_reacting",
        f"outdirBase = {tmp_path / 'out'}")
    path = tmp_path / "deck.ini"
    path.write_text(text)
    torch.set_default_dtype(torch.float32)
    assert harness.main(["tps", "--runFile", str(path), "--device",
                         "cpu"]) == 0
    from tps_torch.io import h5lite

    f = h5lite.read(str(tmp_path / "out" / "restart_lomach.sol.h5"))
    Y = np.asarray(f["solution"]["species"])
    assert Y.shape == (13 * 25, 3) and np.isfinite(Y).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            harness.main(["tps", "--runFile", str(path)])


# --------------------------------------------------------------- coupling


def test_coupled_reacting_matches(tmp_path):
    """tests/test_coupling.py::test_cycle_avg_joule_coupling_reacting's
    set-up (axisymmetric EM 10x10 with a coil ring, the argon zero-flow
    reacting column 5x5 p=1, EM every 2 steps, 100 W) through both
    packages, 3 first-order steps (EM updates before steps 1 and 3)."""
    from tps_torch.mesh.generators import box_2d
    from tps_torch.solvers.coupling import CycleAvgJouleCoupling
    from tps_torch.solvers.em.qms import QuasiMagnetostaticSolverAxiSym
    from tps_tpu.config.run_config import parse_run_configuration as jparse
    from tps_tpu.solvers.coupling import CycleAvgJouleCoupling as JCoupling
    from tps_tpu.solvers.em.qms import \
        QuasiMagnetostaticSolverAxiSym as JQms
    from tps_torch.config.run_config import parse_run_configuration

    text = _plasma_text(f"""
[solver]
type = cycle-avg-joule-coupled
[cycle-avg-joule-coupled]
plasma-solver = lomach
axisymmetric = 1
solve-em-every-n = 2
input-power = 100.0
eval-Rplasma = 1
[mesh]
generator = box2d
nx = 5
ny = 5
x1 = 0.01
y1 = 0.01
periodic_y = 1
[loMach]
order = 1
axisymmetric = 1
flow-solver = zero-flow
thermo-solver = reacting-flow
maxIters = 4
ambientPressure = 101325.0
openSystem = 1
[loMach/reacting]
sub-steps = 4
[initialConditions]
temperature = 9000.0
[time]
dt_fixed = 1e-7
bdfOrder = 1
[io]
outdirBase = {tmp_path}/out
[em]
current_amplitude = 1e6
current_frequency = 1e5
""")

    def em_mesh(gen):
        m = gen(10, 10, x0=0.0, x1=0.03, y0=-0.01, y1=0.02)
        cent = m.vertices[m.elements].mean(axis=1)
        attrs = np.ones(m.num_elements, dtype=np.int64)
        ring = (np.abs(cent[:, 0] - 0.018) < 0.004) \
            & (np.abs(cent[:, 1] - 0.005) < 0.004)
        attrs[ring] = 2
        m.elem_attrs = attrs
        return m

    rc = parse_run_configuration(IniInput.parse(text))
    ours = CycleAvgJouleCoupling(rc, device="cpu")
    ours._em_in = QuasiMagnetostaticSolverAxiSym(rc, mesh=em_mesh(box_2d),
                                                 device="cpu")
    ours._em_in.initialize()
    ours.initialize()
    jrc = jparse(JIniInput.parse(text))
    ref = JCoupling(jrc)
    ref._em_in = JQms(jrc, mesh=em_mesh(jbox_2d))
    ref._em_in.initialize()
    ref.initialize()
    sigma = ours.flow.thermo.plasma_conductivity()
    assert float(sigma.min()) >= 0.0 and float(sigma.max()) > 0.0
    jth = ref.flow.thermo  # its eager composition (see _pointwise)
    assert _rel(sigma, jth.transport.electric_conductivity(
        *jth._conserved_state(jth.T, jth.Y))) <= POINT_TOL
    for _ in range(3):
        ours.solve_step()
        ref.solve_step()
    assert len(ours.em_log) == 2
    for e in ours.em_log:
        assert abs(e["joule"] - 100.0) <= 1e-8 * 100.0
    assert abs(ref.em.total_joule_heating() - 100.0) <= 1e-8 * 100.0
    th, jth = ours.flow.thermo, ref.flow.thermo
    for a, b in ((th.T, jth.T), (th.Y, jth.Y),
                 (th.joule_heating, jth.joule_heating),
                 (ours.flow.efield, ref.flow.efield)):
        assert _rel(a, b) <= DECK_TOL
    assert np.isfinite(th.plasma_conductivity().numpy()).all()
    assert ours.plasma_resistance > 0 and ours.plasma_inductance > 0
