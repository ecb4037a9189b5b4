"""The axisymmetric (r, z) + swirl compressible DG of tps_torch == the JAX
package's, on the CPU in f64, module by module.

1. The radius-weighted tables (rad_vol, rad_face, rad_face_r, rad_slot,
   Minv_rad and its diagonal, nor_wpf with r w folded in) bit for bit, on
   tests/test_axisymmetric.py's strip (r in [0.2, 1.2]) and on a box that
   touches the axis (r in [0, 1]), where the axis face points carry zero
   weight.
2. The radius-weighted volume term (dV = r dr dz) and inverse mass, 1e-12.
3. The swirl state (nvel = 3) of DryAir and of the argon ternary:
   primitives, conservatives, pressure (also from primitives) and
   max |u| + c, 1e-12.
4. The axisymmetric viscous flux (u_r / r in div u, the swirl stresses and
   their work; 0 on the axis), the convective flux, Rusanov on nvel = 3
   and the geometric source AxisymmetricSource, 1e-12 of max.
5. The slot RHS with the geometric source on both geometries (DryAir
   Euler on the strip, Navier-Stokes on the axis), 1e-12 of max per
   equation; the CPU face sweep is the plain version and names its
   axisymmetric variant.  The argon ternary's RHS (Navier-Stokes, its
   plasma source, its walls, inlet and outlet) is held through the torch
   deck in tests/test_torch_axisym_decks.py: the JAX package compiles an
   argon RHS for ~5-13 s, and these files keep to a minute.
6. tests/test_axisymmetric.py's two cases through the port: its
   well-balance bar (rel < 1e-6) and its 5 RK4 swirl steps against the
   JAX package's, 1e-10.
7. What stays out raises: Roe with axisymmetry (ValueError, the
   reference's error), and under axisymmetry constant plasma transport,
   the six-species mixture and a mixture that is not ambipolar
   (NotImplementedError naming ROADMAP A5.3; the LTE fluid runs,
   tests/test_torch_lte_axisym.py).  The SGS models, the viscous sponge and the
   mixing length run under axisymmetry: check_slice accepts them.

The pipe deck, the small torch deck and the checkpoints are held in
tests/test_torch_axisym_decks.py.
"""

import dataclasses
import os

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
threadpool_limits(1)  # numpy's and scipy's BLAS too: one thread a worker

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tps_torch.config.ini import IniInput  # noqa: E402
from tps_torch.config.run_config import parse_run_configuration  # noqa: E402
from tps_torch.dg import bc as tbc  # noqa: E402
from tps_torch.dg import operators as tops  # noqa: E402
from tps_torch.dg import rhs as trhs  # noqa: E402
from tps_torch.dg.cuda_faces import build_face_sweep  # noqa: E402
from tps_torch.dg.discretization import build_tables  # noqa: E402
from tps_torch.dg.fluxes import Fluxes  # noqa: E402
from tps_torch.dg.forcing import AxisymmetricSource  # noqa: E402
from tps_torch.dg.riemann import Rusanov  # noqa: E402
from tps_torch.mesh.generators import box_2d  # noqa: E402
from tps_torch.physics.gas import DryAir  # noqa: E402
from tps_torch.physics.plasma_config import build_plasma  # noqa: E402
from tps_torch.physics.transport import DryAirTransport  # noqa: E402
from tps_torch.solvers.compressible import check_slice  # noqa: E402
from tps_torch.time.integrators import rk4  # noqa: E402
from tps_tpu.config.ini import IniInput as JIniInput  # noqa: E402
from tps_tpu.dg import bc as jbc  # noqa: E402
from tps_tpu.dg import operators as jops  # noqa: E402
from tps_tpu.dg import rhs as jrhs  # noqa: E402
from tps_tpu.dg.discretization import build_tables as jbuild_tables  # noqa: E402
from tps_tpu.dg.fluxes import Fluxes as JFluxes  # noqa: E402
from tps_tpu.dg.forcing import AxisymmetricSource as JAxiSource  # noqa: E402
from tps_tpu.dg.riemann import Rusanov as JRusanov  # noqa: E402
from tps_tpu.mesh.generators import box_2d as jbox_2d  # noqa: E402
from tps_tpu.physics.gas import DryAir as JDryAir  # noqa: E402
from tps_tpu.physics.plasma_config import build_plasma as jbuild_plasma  # noqa: E402
from tps_tpu.physics.transport import DryAirTransport as JDryAirTransport  # noqa: E402
from tps_tpu.time.integrators import rk4 as jrk4  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ARGON = os.path.join(HERE, "inputs", "argon_minimal.ini")
TOL = 1e-12
STEP_TOL = 1e-10
# (r0, r1, extent in z): the strip of tests/test_axisymmetric.py, a box on
# the axis, the argon deck's box on the axis
GEOMETRIES = {"strip": (0.2, 1.2, 1.0), "axis": (0.0, 1.0, 1.0),
              "argon": (0.0, 0.01, 0.01)}


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


def _cols_rel(a, b):
    """Per equation (last axis) relative to that column's max."""
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return max(_rel(a[..., q], b[..., q]) for q in range(b.shape[-1]))


_TABLES = {}


def _tables(geom):
    """(port numpy tables, JAX numpy tables), 6x6 p=2, z periodic; built
    once per geometry."""
    if geom not in _TABLES:
        r0, r1, lz = GEOMETRIES[geom]
        kw = dict(x0=r0, x1=r1, y0=0.0, y1=lz, periodic_y=True)
        _TABLES[geom] = (
            build_tables(box_2d(6, 6, **kw), order=2, axisymmetric=True),
            jbuild_tables(jbox_2d(6, 6, **kw), order=2, axisymmetric=True))
    return _TABLES[geom]


_PLASMA = {}


def _argon():
    """(port, JAX) plasma setups of argon_minimal.ini with swirl."""
    if not _PLASMA:
        _PLASMA["p"] = (build_plasma(IniInput.read(ARGON), 2, 3),
                        jbuild_plasma(JIniInput.read(ARGON), 2, 3))
    return _PLASMA["p"]


def _physics(kind, eq):
    """((mixture, transport), (JAX mixture, transport)) with swirl."""
    if kind == "dry_air":
        mix, jmix = DryAir(dim=2, nvel=3), JDryAir(dim=2, nvel=3)
        if eq == "euler":
            return (mix, None), (jmix, None)
        return ((mix, DryAirTransport(mix.gas_constant,
                                      mix.specific_heat_ratio,
                                      bulk_visc_mult=0.3)),
                (jmix, JDryAirTransport(jmix.gas_constant,
                                        jmix.specific_heat_ratio,
                                        bulk_visc_mult=0.3)))
    pl, jpl = _argon()
    if eq == "euler":
        return (pl.mixture, None), (jpl.mixture, None)
    return (pl.mixture, pl.transport), (jpl.mixture, jpl.transport)


def _primitives(kind, mix, xyz, seed):
    """A perturbed swirl state's primitives [..., neq] at points xyz."""
    rng = np.random.default_rng(seed)
    shape = xyz.shape[:-1]
    r = xyz[..., 0]
    Up = np.zeros(shape + (mix.num_equations,))
    wave = rng.uniform(-1.0, 1.0, shape)
    if kind == "dry_air":
        Up[..., 0] = 1.2 * (1 + 0.05 * wave)
        Up[..., 4] = 300.0 * (1 + 0.05 * wave)
        swirl = 5.0
    else:
        Up[..., 0] = 1.6 * (1 + 0.05 * wave)
        Up[..., 4] = 1800.0 * (1 + 0.05 * wave)
        Up[..., 5] = 1e-3 * 1.6 / mix.mw[0] * (1 + 0.2 * wave)
        Up[..., 6] = 9000.0 * (1 - 0.1 * wave)
        swirl = 500.0
    Up[..., 1] = 3.0 * wave
    Up[..., 2] = 10.0 - 2.0 * wave
    Up[..., 3] = swirl * r * (1 + 0.1 * wave)
    return Up


def _gradient(kind, shape, seed):
    """A random primitive gradient [..., neq, 2] of realistic scale."""
    rng = np.random.default_rng(seed)
    neq = 5 if kind == "dry_air" else 7
    scale = [10.0, 1e3, 1e3, 1e3, 1e4] + ([1e24, 1e5] if neq == 7 else [])
    return rng.standard_normal(shape + (neq, 2)) * np.asarray(scale)[:, None]


# ------------------------------------------------------------ 1-2. tables


@pytest.mark.parametrize("geom", ["strip", "axis"])
def test_axisymmetric_tables_bit_equal(geom):
    ours, ref = _tables(geom)
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray), f.name
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    for name in ("rad_vol", "rad_face", "rad_face_r", "rad_slot", "Minv_rad",
                 "minv_rad_diag"):
        assert getattr(ours, name) is not None, name
    on_axis = ours.xyz_slot[..., 0] == 0.0
    assert on_axis.any() == (geom == "axis")
    nor = ours.nor_wpf.reshape(ours.nlf, ours.ne, ours.nqf, 2)
    assert np.all(nor.transpose(1, 0, 2, 3)[on_axis] == 0.0)


@pytest.mark.parametrize("geom", ["strip", "axis"])
def test_radial_volume_term_and_inverse_mass(geom):
    tnp, jnp_tab = _tables(geom)
    tab, jtab = tnp.to_torch(torch.float64, "cpu"), jnp_tab.to_jax(jnp.float64)
    rng = np.random.default_rng(3)
    F = rng.standard_normal((tnp.ne, tnp.ndof, 5, 2))
    assert _rel(tops.volume_weak_div(tab, torch.as_tensor(F)),
                jops.volume_weak_div(jtab, jnp.asarray(F))) <= TOL
    Z2 = rng.standard_normal((tnp.ne, tnp.ndof * 5))
    got = tops.apply_minv2(tab, torch.as_tensor(Z2), 5, radial=True)
    assert _rel(got, jops.apply_minv2(jtab, jnp.asarray(Z2), 5,
                                      radial=True)) <= TOL
    assert _rel(got, tops.apply_minv2(tab, torch.as_tensor(Z2), 5)) > 1e-3


# ------------------------------------------------------ 3-4. pointwise


@pytest.mark.parametrize("kind", ["dry_air", "argon"])
def test_swirl_state(kind):
    (mix, _), (jmix, _) = _physics(kind, "euler")
    tnp, _ = _tables("argon" if kind == "argon" else "axis")
    Up = _primitives(kind, mix, tnp.xyz_dof, 1)
    U = mix.conservatives(torch.as_tensor(Up))

    @jax.jit
    def theirs(Up):
        jU = jmix.conservatives(Up)
        return (jU, jmix.primitives(jU), jmix.pressure(jU),
                jmix.pressure_from_primitives(Up), jmix.max_char_speed(jU))

    jU, jUp, jp, jpp, jmcs = theirs(jnp.asarray(Up))
    assert mix.nvel == 3 and U.shape[-1] == (5 if kind == "dry_air" else 7)
    assert _cols_rel(U, jU) <= TOL
    assert _cols_rel(mix.primitives(U), jUp) <= TOL
    assert _rel(mix.pressure(U), jp) <= TOL
    assert _rel(mix.pressure_from_primitives(torch.as_tensor(Up)), jpp) <= TOL
    assert _rel(mix.max_char_speed(U), jmcs) <= TOL
    # the swirl counts in |u| and carries no pressure
    U0 = U.clone()
    U0[..., 3] = 0.0
    assert bool(torch.all(mix.max_char_speed(U0) < mix.max_char_speed(U)))


@pytest.mark.parametrize("kind", ["dry_air", "argon"])
def test_pointwise_axisymmetric_fluxes_and_source(kind):
    (mix, tr), (jmix, jtr) = _physics(kind, "navier-stokes")
    fl = Fluxes(mixture=mix, transport=tr, axisymmetric=True)
    jfl = JFluxes(mixture=jmix, transport=jtr, axisymmetric=True)
    tnp, jtnp = _tables("argon" if kind == "argon" else "axis")
    tab, jtab = tnp.to_torch(torch.float64, "cpu"), jtnp.to_jax(jnp.float64)
    # the slot points, the axis among them (r = 0), for the fluxes; the
    # solution nodes for the source
    xyz = tnp.xyz_slot.reshape(-1, 2)
    U = mix.conservatives(torch.as_tensor(_primitives(kind, mix, xyz, 2)))
    U2 = mix.conservatives(torch.as_tensor(_primitives(kind, mix, xyz, 5)))
    G = torch.as_tensor(_gradient(kind, xyz.shape[:-1], 4))
    nor = torch.as_tensor(np.random.default_rng(6).standard_normal(xyz.shape))
    Un = mix.conservatives(torch.as_tensor(
        _primitives(kind, mix, tnp.xyz_dof, 7)))
    Gn = torch.as_tensor(_gradient(kind, tnp.xyz_dof.shape[:-1], 8))

    def ours():
        src = AxisymmetricSource(mixture=mix, fluxes=fl)(
            0.0, tab, Un, mix.primitives(Un), Gn)
        return (fl.convective(U),
                fl.viscous(U, mix.primitives(U), G, xyz=torch.as_tensor(xyz)),
                Rusanov(fl)(U, U2, nor), src)

    @jax.jit
    def theirs(U, U2, G, nor, xyz, Un, Gn, jtab):
        src = JAxiSource(mixture=jmix, fluxes=jfl)(
            0.0, jtab, Un, jmix.primitives(Un), Gn)
        return (jfl.convective(U),
                jfl.viscous(U, jmix.primitives(U), G, xyz=xyz),
                JRusanov(jfl)(U, U2, nor), src)

    conv, Fv, rus, src = ours()
    jconv, jFv, jrus, jsrc = theirs(*(jnp.asarray(a.numpy()) for a in
                                      (U, U2, G, nor)), jnp.asarray(xyz),
                                    jnp.asarray(Un.numpy()),
                                    jnp.asarray(Gn.numpy()), jtab)
    assert _rel(conv, jconv) <= TOL
    assert np.isfinite(Fv.numpy()).all() and float(Fv[:, 3].abs().max()) > 0
    for q in range(mix.num_equations):
        assert _rel(Fv[:, q], jFv[:, q]) <= TOL, q
    assert _cols_rel(rus, jrus) <= TOL
    assert _rel(src[..., 1], jsrc[..., 1]) <= TOL
    assert _rel(src[..., 3], jsrc[..., 3]) <= TOL
    others = [q for q in range(mix.num_equations) if q not in (1, 3)]
    assert float(src[..., others].abs().max()) == 0.0


# ------------------------------------------------------------ 5. the RHS


def _ctx(P, mix, tr, eq, tnp):
    """Inviscid walls on every patch (tests/test_axisymmetric.py's
    set-up) and the geometric source."""
    fl = P["Fluxes"](mixture=mix, transport=tr, eq_system=eq,
                     axisymmetric=True)
    attrs = np.asarray(tnp.f_bdr_attr)
    bcs = []
    for a in sorted(set(attrs.tolist())):
        rows = np.where(attrs == a)[0]
        bcs.append(P["rhs"].BCSlice(bc=P["bc"].WallBC(kind="inviscid"),
                                    start=int(rows.min()),
                                    stop=int(rows.max()) + 1))
    return P["rhs"].RHSContext(fluxes=fl, riemann=P["Rusanov"](fl),
                               bcs=tuple(bcs),
                               forcings=(P["Axi"](mixture=mix, fluxes=fl),))


PORT = {"Fluxes": Fluxes, "rhs": trhs, "bc": tbc, "Axi": AxisymmetricSource,
        "Rusanov": Rusanov}
JAX = {"Fluxes": JFluxes, "rhs": jrhs, "bc": jbc, "Axi": JAxiSource,
       "Rusanov": JRusanov}


_JAX_RHS = {}


def _jax_rhs(kind, eq, geom):
    """(JAX tables, jitted (tables, U, t) -> (dU/dt, aux)) of a case, built
    and compiled once."""
    if (kind, eq, geom) not in _JAX_RHS:
        (jmix, jtr) = _physics(kind, eq)[1]
        jtnp = _tables(geom)[1]
        jctx = _ctx(JAX, jmix, jtr, eq, jtnp)
        _JAX_RHS[kind, eq, geom] = (
            jtnp.to_jax(jnp.float64),
            jax.jit(lambda tb, u, t: jrhs.compute_rhs(jctx, tb, u, t)))
    return _JAX_RHS[kind, eq, geom]


@pytest.mark.parametrize("kind,eq,geom", [
    ("dry_air", "euler", "strip"), ("dry_air", "navier-stokes", "axis")])
def test_slot_rhs_matches_jax(kind, eq, geom):
    (mix, tr) = _physics(kind, eq)[0]
    tnp = _tables(geom)[0]
    ctx = _ctx(PORT, mix, tr, eq, tnp)
    tab = tnp.to_torch(torch.float64, "cpu")
    U = mix.conservatives(torch.as_tensor(
        _primitives(kind, mix, tnp.xyz_dof, 9)))
    sweep = build_face_sweep(tab, ctx)
    assert sweep.variant == "dry_air_axi"
    assert tuple(sweep.rad.shape) == (tnp.ne, tnp.nlf, tnp.nqf)
    y, aux = trhs.compute_rhs(ctx, tab, U, sweep=sweep)
    jtab, jfn = _jax_rhs(kind, eq, geom)
    jy, jaux = jfn(jtab, jnp.asarray(U.numpy()), 0.0)
    assert _cols_rel(y, jy) <= TOL
    assert _rel(aux["max_char_speed"], jaux["max_char_speed"]) <= TOL


# ------------------------------------- 6. tests/test_axisymmetric.py


def _strip_case(mix):
    """The port's Euler context on the strip, and its tables."""
    tnp = _tables("strip")[0]
    return _ctx(PORT, mix, None, "euler", tnp), tnp


def test_uniform_axial_flow_is_well_balanced():
    mix = DryAir(dim=2, nvel=3)
    ctx, tnp = _strip_case(mix)
    tab = tnp.to_torch(torch.float64, "cpu")
    Up = torch.zeros(tnp.xyz_dof.shape[:2] + (5,))
    Up[..., 0], Up[..., 2], Up[..., 4] = 1.2, 30.0, 300.0
    y, _ = trhs.compute_rhs(ctx, tab, mix.conservatives(Up))
    p = 1.2 * mix.gas_constant * 300.0
    assert float(y.abs().max()) / (p / 0.2) < 1e-6


def test_swirl_rk4_steps_match_jax():
    mix = DryAir(dim=2, nvel=3)
    ctx, tnp = _strip_case(mix)
    tab = tnp.to_torch(torch.float64, "cpu")
    Up = np.zeros(tnp.xyz_dof.shape[:2] + (5,))
    Up[..., 0], Up[..., 2], Up[..., 4] = 1.2, 10.0, 300.0
    Up[..., 3] = 5.0 * tnp.xyz_dof[..., 0]
    U = mix.conservatives(torch.as_tensor(Up))
    jU = jnp.asarray(U.numpy())
    sweep = build_face_sweep(tab, ctx)
    # the JAX package's RK4 over its jitted RHS (the one of
    # test_slot_rhs_matches_jax's strip case, compiled once)
    jtab, jfn = _jax_rhs("dry_air", "euler", "strip")
    dt = 1e-6
    for i in range(5):
        U = rk4(lambda uu, tt: trhs.compute_rhs(ctx, tab, uu, tt,
                                                sweep=sweep),
                U, i * dt, dt)[0]
        jU = jrk4(lambda uu, tt: jfn(jtab, uu, tt), jU, i * dt, dt)[0]
    assert np.isfinite(U.numpy()).all()
    assert 250 < float(mix.primitives(U)[..., 4].mean()) < 350
    assert _cols_rel(U, jU) <= STEP_TOL


# ----------------------------------------------------------- 7. refusals


def _rc(text):
    return parse_run_configuration(IniInput.parse(text))


def _argon_text(**edits):
    with open(ARGON) as f:
        text = f.read()
    text = text.replace("axisymmetric = False", "axisymmetric = True")
    for old, new in edits.items():
        text = text.replace(old, new)
    return text


def test_roe_with_axisymmetry_is_the_references_error():
    text = _argon_text().replace("[flow]\n", "[flow]\nuseRoe = 1\n")
    with pytest.raises(ValueError, match="Roe flux not supported for "
                       "axisymmetric"):
        check_slice(_rc(text))
    check_slice(_rc(_argon_text()))  # the argon ternary runs


@pytest.mark.parametrize("edit", [
    pytest.param(("transport_model = argon_minimal",
                  "transport_model = constant"), id="constant-transport"),
    pytest.param(("numSpecies = 3", "numSpecies = 6"), id="six-species"),
    pytest.param(("ambipolar = True", "ambipolar = False"),
                 id="not-ambipolar"),
])
def test_what_stays_out_names_a5_3(edit):
    rc = _rc(_argon_text(**{edit[0]: edit[1]}))
    with pytest.raises(NotImplementedError, match=r"ROADMAP A5\.3"):
        check_slice(rc)


@pytest.mark.parametrize("edit", [
    pytest.param(("[flow]\n", "[flow]\nsgsModel = smagorinsky\n"), id="sgs"),
    pytest.param(("[flow]\n", "[flow]\ncomputeDistance = 1\n"
                  "useMixingLength = 1\n"), id="mixing-length"),
    pytest.param(("[flow]\n", "[viscosityMultiplierFunction]\nisEnabled = 1"
                  "\n[flow]\n"), id="viscous-sponge"),
])
def test_a5_3_closures_are_accepted(edit):
    rc = _rc(_argon_text(**{edit[0]: edit[1]}))
    check_slice(rc)
    assert rc.axisymmetric
