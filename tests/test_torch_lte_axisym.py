"""The axisymmetric (r, z) LTE-table fluid with swirl in tps_torch == the
JAX package's, on the CPU in f64.

1. LteMixture's swirl state (nvel = 3) on the committed 1-D tables and on
   2-D (T, rho) tables: temperature (the kinetic energy over the three
   velocities), primitives, conservatives, pressure (also from
   primitives), max |u| + c, sound_speed_from_T and the BC helpers, 1e-12
   of max.
2. AxisymmetricSource on the LTE fluid, Navier-Stokes (its pressure from
   the R table, mu from the mu table, no bulk viscosity) and Euler, 1e-12
   of max; it forms no temperature of its own (T is the primitives').
3. The slot RHS with the geometric source, the axis an inviscid wall and
   the outer radius a viscous_adiabatic one (inviscid on Euler), on a
   strip off the axis and on a box whose left side is the axis, with 1-D
   and 2-D tables, Navier-Stokes and Euler: 1e-12 of max per equation;
   the CPU face sweep is the plain version and names its `lte_axi*`
   variant; then 3 RK4 steps against the JAX package's over its jitted
   RHS, 1e-10.
4. tps_torch/tools/lte_torch_axisym.ini (the LTE torch in (r, z) under
   the Joule coupling) cut to 8x8 p=1 with an EM mesh of 16x24 and an EM
   solve every 2 steps, 3 forward Euler steps through both packages' Tps
   API from tps_tpu's initial state: the state within 1e-9 and the power
   on target to 1e-8 at each EM solve (the bars of
   tests/test_torch_axisym_decks.py); through the CLI (f32) to its end.
5. The gate: face_sweep_supported admits the LTE fluid on axisymmetric
   tables, `variant` names the four `lte_axi*` instantiations, and with a
   closure the configuration stays outside the kernel (a CUDA table
   raises naming ROADMAP A6.5); under axisymmetry the constant-transport
   ternary, the six-species mixture and a mixture that is not ambipolar
   still raise naming ROADMAP A5.3.

One JAX RHS is compiled per case of 3 and shared with the steps of that
case; the deck's JAX run is the file's longest (~20 s).
"""

import os
import types

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
threadpool_limits(1)  # numpy's and scipy's BLAS too: one thread a worker

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tps_torch import harness  # noqa: E402
from tps_torch.config.ini import IniInput  # noqa: E402
from tps_torch.config.run_config import parse_run_configuration  # noqa: E402
from tps_torch.dg import bc as tbc  # noqa: E402
from tps_torch.dg import cuda_faces  # noqa: E402
from tps_torch.dg import rhs as trhs  # noqa: E402
from tps_torch.dg.cuda_faces import build_face_sweep  # noqa: E402
from tps_torch.dg.discretization import build_tables  # noqa: E402
from tps_torch.dg.fluxes import Fluxes  # noqa: E402
from tps_torch.dg.forcing import AxisymmetricSource  # noqa: E402
from tps_torch.dg.riemann import Rusanov  # noqa: E402
from tps_torch.io import h5lite  # noqa: E402
from tps_torch.mesh.generators import box_2d  # noqa: E402
from tps_torch.physics.lte import load_lte_setup  # noqa: E402
from tps_torch.solvers.compressible import check_slice  # noqa: E402
from tps_torch.solvers.coupling import CycleAvgJouleCoupling  # noqa: E402
from tps_torch.time.integrators import rk4  # noqa: E402
from tps_torch.tools.closure_cases import closure_fluxes  # noqa: E402
from tps_torch.tools.lte_argon_tables import lte_keys, write_2d  # noqa: E402
from tps_tpu import harness as jharness  # noqa: E402
from tps_tpu.config.ini import IniInput as JIniInput  # noqa: E402
from tps_tpu.dg import bc as jbc  # noqa: E402
from tps_tpu.dg import rhs as jrhs  # noqa: E402
from tps_tpu.dg.discretization import build_tables as jbuild_tables  # noqa: E402
from tps_tpu.dg.fluxes import Fluxes as JFluxes  # noqa: E402
from tps_tpu.dg.forcing import AxisymmetricSource as JAxiSource  # noqa: E402
from tps_tpu.dg.riemann import Rusanov as JRusanov  # noqa: E402
from tps_tpu.mesh.generators import box_2d as jbox_2d  # noqa: E402
from tps_tpu.physics.lte import load_lte_setup as jload  # noqa: E402
from tps_tpu.time.integrators import rk4 as jrk4  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DECK = os.path.join(REPO, "tps_torch", "tools", "lte_torch_axisym.ini")
ARGON = os.path.join(HERE, "inputs", "argon_minimal.ini")
TOL = 1e-12
STEP_TOL = 1e-10
DECK_TOL = 1e-9
POWER_TOL = 1e-8
# (r0, r1) of the (r, z) boxes, z in [0, 0.01] periodic: a strip off the
# axis and a box whose left side is the axis
GEOMETRIES = {"strip": (0.002, 0.012), "axis": (0.0, 0.01)}


@pytest.fixture(autouse=True)
def f64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _per_eq(a, b):
    """Each equation (last axis) relative to its own max, the worst."""
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return max(_rel(a[..., q], np.asarray(b)[..., q])
               for q in range(a.shape[-1]))


@pytest.fixture(scope="module")
def t2dir(tmp_path_factory):
    """2-D (T, rho) tables of the equilibrium argon on a coarse grid
    (tps_torch/tools/lte_argon_tables.py::write_2d), written once."""
    d = str(tmp_path_factory.mktemp("lte2d"))
    write_2d(d, nT=80, ne=120)
    return d


_SETUPS = {}


def _setups(table_dim, d):
    """((LteMixture, LteTransport), (JAX's)) with swirl (nvel = 3)."""
    if table_dim not in _SETUPS:
        keys = lte_keys(table_dim, d)
        _SETUPS[table_dim] = (load_lte_setup(IniInput.parse(keys), 2, 3),
                              jload(JIniInput.parse(keys), 2, 3))
    return _SETUPS[table_dim]


def _primitives(xyz, seed=None):
    """A perturbed hot swirl state's primitives [..., 5] at points xyz:
    rho ~0.05, u_r, u_z ~10 m/s, u_theta = 500 r, T ~9,500 K with 20%
    spots; the perturbation random per point (seed), or a smooth wave
    (seed None) for the steps."""
    shape = xyz.shape[:-1]
    if seed is None:
        k = 2 * np.pi / 0.01
        wave = np.sin(k * xyz[..., 0]) * np.cos(k * xyz[..., 1])
    else:
        wave = np.random.default_rng(seed).uniform(-1.0, 1.0, shape)
    Up = np.zeros(shape + (5,))
    Up[..., 0] = 0.05 * (1 + 0.1 * wave)
    Up[..., 1] = 3.0 * wave
    Up[..., 2] = 10.0 - 2.0 * wave
    Up[..., 3] = 500.0 * xyz[..., 0] * (1 + 0.1 * wave)
    Up[..., 4] = 9500.0 * (1 + 0.2 * wave)
    return Up


def _gradient(shape, seed):
    """A random primitive gradient [..., 5, 2] of realistic scale."""
    rng = np.random.default_rng(seed)
    scale = np.array([5.0, 1e3, 1e3, 1e3, 1e6])
    return rng.standard_normal(shape + (5, 2)) * scale[:, None]


_TABLES = {}


def _tables(geom, n=6):
    """(port numpy tables, JAX numpy tables), n x n p=2 GL axisymmetric,
    z periodic; built once per geometry."""
    if (geom, n) not in _TABLES:
        r0, r1 = GEOMETRIES[geom]
        kw = dict(x0=r0, x1=r1, y0=0.0, y1=0.01, periodic_y=True)
        _TABLES[geom, n] = (
            build_tables(box_2d(n, n, **kw), order=2, axisymmetric=True),
            jbuild_tables(jbox_2d(n, n, **kw), order=2, axisymmetric=True))
    return _TABLES[geom, n]


# ------------------------------------------------------ 1-2. pointwise


@pytest.mark.parametrize("table_dim", [1, 2])
def test_swirl_state(table_dim, t2dir):
    (mix, _), (jmix, _) = _setups(table_dim, t2dir)
    tnp, _ = _tables("axis")
    Up = _primitives(tnp.xyz_dof, table_dim)
    fns = ("temperature", "pressure", "max_char_speed", "primitives")

    @jax.jit
    def theirs(Up):
        jU = jmix.conservatives(Up)
        return (jU, [getattr(jmix, fn)(jU) for fn in fns],
                jmix.pressure_from_primitives(Up),
                jmix.sound_speed_from_T(Up[..., 4]))

    jU, jvals, jpp, jc = theirs(jnp.asarray(Up))
    # the BC helpers read the table's R(300 K) as a host float: not
    # traceable, run op by op
    jstag = jmix.stagnant_state_with_temp(jU, 9000.0)
    jmod = jmix.modify_energy_for_pressure(jU, 101325.0)
    U = torch.as_tensor(np.array(jU))
    assert mix.nvel == 3 and mix.num_equations == 5 and mix.i_th == 4
    assert _per_eq(mix.conservatives(torch.as_tensor(Up)), jU) <= TOL
    for fn, want in zip(fns, jvals):
        assert _per_eq(getattr(mix, fn)(U)[..., None],
                       np.asarray(want)[..., None]) <= TOL, fn
    assert _rel(mix.pressure_from_primitives(torch.as_tensor(Up)),
                jpp) <= TOL
    T = torch.as_tensor(Up[..., 4])
    assert _rel(mix.sound_speed_from_T(T), jc) <= TOL
    assert _per_eq(mix.stagnant_state_with_temp(U, 9000.0), jstag) <= TOL
    assert _per_eq(mix.modify_energy_for_pressure(U, 101325.0),
                   jmod) <= TOL
    # the swirl's kinetic energy is not the fluid's internal energy: the
    # state's T is the one it was built at, and u_theta counts in |u|
    assert _rel(mix.temperature(U), Up[..., 4]) <= 1e-9
    U0 = U.clone()
    U0[..., 3] = 0.0
    assert bool(torch.all(mix.max_char_speed(U0) < mix.max_char_speed(U)))


@pytest.mark.parametrize("table_dim,eq", [
    (1, "navier-stokes"), (1, "euler"), (2, "navier-stokes"), (2, "euler")])
def test_axisymmetric_source(table_dim, eq, t2dir, monkeypatch):
    (mix, tr), (jmix, jtr) = _setups(table_dim, t2dir)
    euler = eq == "euler"
    fl = Fluxes(mixture=mix, transport=tr, eq_system=eq, axisymmetric=True)
    jfl = JFluxes(mixture=jmix, transport=jtr, eq_system=eq,
                  axisymmetric=True)
    tnp, jtnp = _tables("axis")
    tab, jtab = tnp.to_torch(torch.float64, "cpu"), jtnp.to_jax(jnp.float64)
    Up = _primitives(tnp.xyz_dof, 3)
    U = torch.as_tensor(np.array(jmix.conservatives(jnp.asarray(Up))))
    G = _gradient(tnp.xyz_dof.shape[:-1], 4)
    Upt = mix.primitives(U)
    # the source reads T from the primitives: no Newton solve of its own
    newton = []
    temperature = type(mix).temperature
    monkeypatch.setattr(type(mix), "temperature",
                        lambda self, U: newton.append(1) or temperature(
                            self, U))
    src = AxisymmetricSource(mixture=mix, fluxes=fl)(
        0.0, tab, U, Upt, torch.as_tensor(G))
    assert not newton
    monkeypatch.undo()
    jU = jnp.asarray(U.numpy())
    jsrc = jax.jit(lambda jt, u, g: JAxiSource(mixture=jmix, fluxes=jfl)(
        0.0, jt, u, jmix.primitives(u), g))(jtab, jU, jnp.asarray(G))
    assert _rel(src[..., 1], jsrc[..., 1]) <= TOL
    assert _rel(src[..., 3], jsrc[..., 3]) <= TOL
    assert float(src[..., [0, 2, 4]].abs().max()) == 0.0
    # the viscous parts are there on Navier-Stokes only
    inv = AxisymmetricSource(mixture=mix, fluxes=None)(
        0.0, tab, U, mix.primitives(U), torch.as_tensor(G))
    assert torch.equal(inv, src) == euler


# ------------------------------------------------------------ 3. the RHS


def _ctx(P, mix, tr, eq, tnp):
    """The axis (patch 4, or the strip's inner radius) an inviscid wall,
    the outer radius (patch 2) viscous_adiabatic on Navier-Stokes
    (inviscid on Euler), and the geometric source."""
    fl = P["Fluxes"](mixture=mix, transport=tr, eq_system=eq,
                     axisymmetric=True)
    attrs = np.asarray(tnp.f_bdr_attr)
    bcs = []
    for a in sorted(set(attrs.tolist())):
        rows = np.where(attrs == a)[0]
        kind = ("viscous_adiabatic" if a == 2 and eq != "euler"
                else "inviscid")
        bcs.append(P["rhs"].BCSlice(bc=P["bc"].WallBC(kind=kind),
                                    start=int(rows.min()),
                                    stop=int(rows.max()) + 1))
    return P["rhs"].RHSContext(fluxes=fl, riemann=P["Rusanov"](fl),
                               bcs=tuple(bcs),
                               forcings=(P["Axi"](mixture=mix, fluxes=fl),))


PORT = {"Fluxes": Fluxes, "rhs": trhs, "bc": tbc, "Axi": AxisymmetricSource,
        "Rusanov": Rusanov}
JAX = {"Fluxes": JFluxes, "rhs": jrhs, "bc": jbc, "Axi": JAxiSource,
       "Rusanov": JRusanov}


@pytest.mark.parametrize("table_dim,eq,geom", [
    (1, "navier-stokes", "axis"), (1, "euler", "strip"),
    (2, "navier-stokes", "strip"), (2, "euler", "axis")])
def test_slot_rhs_and_rk4_steps_match_jax(table_dim, eq, geom, t2dir):
    (mix, tr), (jmix, jtr) = _setups(table_dim, t2dir)
    tnp, jtnp = _tables(geom)
    ctx = _ctx(PORT, mix, None if eq == "euler" else tr, eq, tnp)
    jctx = _ctx(JAX, jmix, None if eq == "euler" else jtr, eq, jtnp)
    tab, jtab = tnp.to_torch(torch.float64, "cpu"), jtnp.to_jax(jnp.float64)
    Up = _primitives(tnp.xyz_dof)
    U = torch.as_tensor(np.array(jmix.conservatives(jnp.asarray(Up))))
    sweep = build_face_sweep(tab, ctx)
    want = ("lte_axi" + ("_t2" if table_dim == 2 else "")
            + ("_euler" if eq == "euler" else ""))
    assert (sweep.physics, sweep.variant) == ("lte", want)
    assert tuple(sweep.rad.shape) == (tnp.ne, tnp.nlf, tnp.nqf)
    jfn = jax.jit(lambda tb, u, t: jrhs.compute_rhs(jctx, tb, u, t))
    y, aux = trhs.compute_rhs(ctx, tab, U, sweep=sweep)
    jy, jaux = jfn(jtab, jnp.asarray(U.numpy()), 0.0)
    assert _per_eq(y, jy) <= TOL
    assert float(y[..., 3].abs().max()) > 0.0  # the swirl moves
    assert _rel(aux["max_char_speed"], jaux["max_char_speed"]) <= TOL
    # 3 RK4 steps over the same jitted RHS
    jU, dt = jnp.asarray(U.numpy()), 2e-9
    for i in range(3):
        U = rk4(lambda uu, tt: trhs.compute_rhs(ctx, tab, uu, tt,
                                                sweep=sweep),
                U, i * dt, dt)[0]
        jU = jrk4(lambda uu, tt: jfn(jtab, uu, tt), jU, i * dt, dt)[0]
    assert np.isfinite(U.numpy()).all()
    assert _per_eq(U, jU) <= STEP_TOL


# ------------------------------------------------------------ 4. the deck


def _deck(tmp_path, name, edits):
    with open(DECK) as f:
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


def _state_rel(U, ref):
    """Per equation relative to its max; the momenta relative to max rho
    times the max speed (the radial momentum starts at 0)."""
    U, ref = np.asarray(U), np.asarray(ref)
    speed = np.max(np.abs(ref[..., 1:4]) / ref[..., :1])
    out = 0.0
    for q in range(ref.shape[-1]):
        scale = np.abs(ref[..., q]).max()
        if 1 <= q <= 3:
            scale = max(scale, ref[..., 0].max() * speed)
        out = max(out, np.abs(U[..., q] - ref[..., q]).max() / scale)
    return out


def test_small_deck_matches_jax(tmp_path, monkeypatch):
    # the deck names its tables from the repository root
    monkeypatch.chdir(REPO)
    cut = [("nx = 64", "nx = 8"), ("ny = 64", "ny = 8"),
           ("order = 2", "order = 1"), ("nx = 32", "nx = 16"),
           ("ny = 48", "ny = 24"),
           ("solve-em-every-n = 10", "solve-em-every-n = 2"),
           ("maxIters = 200", "maxIters = 3"),
           ("integrator = rk4", "integrator = forward-euler")]
    path = _deck(tmp_path, "lte_axi.ini", cut + [
        ("outdirBase = output/lte_torch_axisym",
         f"outdirBase = {tmp_path / 'out'}")])
    tps = _tps(harness, path, ["--device", "cpu"])
    c = tps.solver
    assert isinstance(c, CycleAvgJouleCoupling)
    assert c.plasma_kind == "compressible"
    flow = c.flow
    assert type(flow.mixture).__name__ == "LteMixture"
    assert flow.mixture.nvel == 3 and flow.fluxes.axisymmetric
    assert flow._rhs.sweep.variant == "lte_axi"
    assert [type(f).__name__ for f in flow.ctx.forcings] == [
        "SourceTerm", "JouleHeating", "AxisymmetricSource"]
    assert sorted(b.bc.kind for b in flow.bc_slices) == [
        "inviscid", "viscous_adiabatic"]
    jc = _tps(jharness, path).solver
    flow.set_state_global(np.asarray(jc.flow.U))
    tps.solve()
    # tps_tpu's coupled loop in its per-step form
    while jc.iter < jc.max_iters:
        jc.solve_step()
    assert c.iter == jc.iter == 3 and len(c.em_log) == 2
    for e in c.em_log:
        assert abs(e["joule"] / e["target"] - 1.0) < POWER_TOL
    assert _state_rel(flow.state_global(), jc.flow.U) <= DECK_TOL
    Up = flow.mixture.primitives(flow.U).numpy()
    assert np.isfinite(Up).all() and np.abs(Up[..., 3]).max() > 0.0
    assert Up[..., 4].max() > 6000.0  # a conductor for the coil
    # the CLI on the plain path, f32
    torch.set_default_dtype(torch.float32)
    cli = _deck(tmp_path, "lte_axi_cli.ini", cut + [
        ("outdirBase = output/lte_torch_axisym",
         f"outdirBase = {tmp_path / 'cli'}")])
    assert harness.main(["tps", "--runFile", cli, "--device", "cpu"]) == 0
    f = h5lite.read(str(tmp_path / "cli" / "restart_output.sol.h5"))
    assert int(f.attrs["iteration"]) == 3
    assert np.isfinite(np.asarray(f["solution"]["z-mom"])).all()


# ------------------------------------------------------ 5. gate, refusals


@pytest.mark.parametrize("table_dim,eq", [
    (1, "navier-stokes"), (1, "euler"), (2, "navier-stokes"), (2, "euler")])
def test_gate_names_the_lte_axi_variants(table_dim, eq, t2dir):
    (mix, tr), _ = _setups(table_dim, t2dir)
    tnp, _ = _tables("axis")
    fl = Fluxes(mixture=mix, transport=None if eq == "euler" else tr,
                eq_system=eq, axisymmetric=True)
    ctx = trhs.RHSContext(fluxes=fl, riemann=Rusanov(fl))
    want = ("lte_axi" + ("_t2" if table_dim == 2 else "")
            + ("_euler" if eq == "euler" else ""))
    assert cuda_faces.face_sweep_supported(tnp, ctx)
    assert cuda_faces.variant(ctx, 2) == want
    assert want in cuda_faces.AXI_VARIANTS and want in cuda_faces.VARIANTS
    assert cuda_faces.face_physics(ctx, 2, torch.float64, "cpu")[0] == "lte"
    # the planar tables name the planar variant
    planar = build_tables(box_2d(3, 3, x1=0.01, y1=0.01, periodic_x=True,
                                 periodic_y=True), 2)
    pmix = load_lte_setup(IniInput.parse(lte_keys(table_dim, t2dir)),
                          2, 2)[0]
    pfl = Fluxes(mixture=pmix, transport=fl.transport, eq_system=eq)
    pctx = trhs.RHSContext(fluxes=pfl, riemann=Rusanov(pfl))
    assert cuda_faces.face_sweep_supported(planar, pctx)
    assert cuda_faces.variant(pctx, 2) == want.replace("axi", "2d")
    if eq == "euler":
        return
    # with a closure (the viscous sponge) the LTE fluid in (r, z) has no
    # kernel: its CPU sweep runs the plain version, a CUDA table raises
    cfl = closure_fluxes(mix, tr, "sponge", 0.01, axisymmetric=True)
    cctx = trhs.RHSContext(fluxes=cfl, riemann=Rusanov(cfl))
    assert not cuda_faces.face_sweep_supported(tnp, cctx)
    ttab = tnp.to_torch(torch.float64, "cpu")
    assert build_face_sweep(ttab, cctx).variant == "none"
    cuda_tab = types.SimpleNamespace(**{
        **ttab.__dict__, "Btr_or": types.SimpleNamespace(
            device=torch.device("cuda", 0), dtype=torch.float64)})
    with pytest.raises(NotImplementedError, match=r"ROADMAP A6\.5"):
        build_face_sweep(cuda_tab, cctx)


def _rc(text):
    return parse_run_configuration(IniInput.parse(text))


@pytest.mark.parametrize("edit", [
    pytest.param(("transport_model = argon_minimal",
                  "transport_model = constant"), id="constant-transport"),
    pytest.param(("numSpecies = 3", "numSpecies = 6"), id="six-species"),
    pytest.param(("ambipolar = True", "ambipolar = False"),
                 id="not-ambipolar"),
])
def test_lte_runs_and_the_mixtures_stay_out(edit):
    with open(ARGON) as f:
        text = f.read().replace("axisymmetric = False",
                                "axisymmetric = True")
    assert edit[0] in text
    with pytest.raises(NotImplementedError, match=r"ROADMAP A5\.3"):
        check_slice(_rc(text.replace(*edit)))
    # the LTE fluid in (r, z) is in the slice
    with open(DECK) as f:
        rc = _rc(f.read())
    check_slice(rc)
    assert rc.axisymmetric and rc.fluid == "lte_table"
