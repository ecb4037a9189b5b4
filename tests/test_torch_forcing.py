"""The compressible forcings of tps_torch == the JAX package's, on the CPU
in f64, module by module (dg/forcing.py, the DryAir methods the sponge
reads, the ns-passive flux rows).

1. DryAir's total_energy, modify_energy_for_pressure and the mixed-out
   inversion conserved_from_convective_flux (with a passive row).
2. ConstantPressureGradient with and without the p div u term, and
   HeatSource, on seeded states over 2-D and 3-D boxes.
3. sponge_target_conserved: DryAir, and the argon ternary of
   argon_minimal.ini with its species from input-ordered mass fractions
   and the two-temperature electron energy from the deck's T_e (as
   tests/test_forcing_wiring.py:122-153 checks the JAX one), and with
   single_temperature.
4. SpongeZone: planar and annulus, each with a userDef and a mixedOut
   target, in 2-D and 3-D; the annulus's axis guard on a node on the axis
   (the JAX package's floor of 1e-300 there).
5. PassiveScalar and the ns-passive convective and viscous rows on
   DryAir(n_passive=1).
6. make_mms_forcing: f = dU*/dt - RHS(U*) of an analytic field.

Every comparison is relative to the JAX result's max, bar 1e-12 (the
module bar of PERF.md §2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tps_torch.config.ini import IniInput  # noqa: E402
from tps_torch.dg import forcing as tf  # noqa: E402
from tps_torch.dg.discretization import build_tables  # noqa: E402
from tps_torch.dg.fluxes import Fluxes  # noqa: E402
from tps_torch.dg.rhs import RHSContext  # noqa: E402
from tps_torch.dg.riemann import Rusanov  # noqa: E402
from tps_torch.mesh import generators  # noqa: E402
from tps_torch.physics.gas import DryAir  # noqa: E402
from tps_torch.physics.plasma_config import build_plasma  # noqa: E402
from tps_torch.physics.transport import DryAirTransport  # noqa: E402
from tps_tpu.config.ini import IniInput as JIniInput  # noqa: E402
from tps_tpu.dg import forcing as jf  # noqa: E402
from tps_tpu.dg.discretization import build_tables as jbuild_tables  # noqa: E402
from tps_tpu.dg.fluxes import Fluxes as JFluxes  # noqa: E402
from tps_tpu.dg.rhs import RHSContext as JRHSContext  # noqa: E402
from tps_tpu.dg.riemann import Rusanov as JRusanov  # noqa: E402
from tps_tpu.mesh import generators as jgenerators  # noqa: E402
from tps_tpu.physics.gas import DryAir as JDryAir  # noqa: E402
from tps_tpu.physics.plasma_config import build_plasma as jbuild_plasma  # noqa: E402
from tps_tpu.physics.transport import DryAirTransport as JDryAirTransport  # noqa: E402

from test_torch_axisym_dg import ARGON  # noqa: E402

TOL = 1e-12


@pytest.fixture(autouse=True)
def f64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


_TABLES = {}


def _tables(dim):
    """(port tables, JAX tables, numpy xyz) of a p=1 box: [0, 1]^2 at 6x4,
    or [-1, 1]^2 x [0, 1] at 4x4x2 (the annulus's, about the z axis)."""
    if dim not in _TABLES:
        if dim == 2:
            kw = dict(nx=6, ny=4, periodic_x=True, periodic_y=True)
            m, jm = generators.box_2d(**kw), jgenerators.box_2d(**kw)
        else:
            kw = dict(nx=4, ny=4, nz=2, bounds=((-1.0, 1.0), (-1.0, 1.0),
                                                (0.0, 1.0)),
                      periodic=(False, False, True))
            m, jm = generators.box_3d(**kw), jgenerators.box_3d(**kw)
        tab = build_tables(m, order=1).to_torch(torch.float64, "cpu")
        jtab = jbuild_tables(jm, order=1).to_jax(jnp.float64)
        _TABLES[dim] = (tab, jtab, np.asarray(jtab.xyz_dof))
    return _TABLES[dim]


def _dry_state(shape, dim, seed, nvel=None, n_passive=0):
    """Seeded DryAir primitives [..., neq]: rho ~ 1.2, |u| ~ 20, T ~ 300,
    passive mass fractions in (0, 1)."""
    nvel = dim if nvel is None else nvel
    rng = np.random.default_rng(seed)
    Up = np.concatenate([
        rng.uniform(0.9, 1.5, shape + (1,)),
        rng.uniform(-20.0, 30.0, shape + (nvel,)),
        rng.uniform(260.0, 340.0, shape + (1,)),
        rng.uniform(0.0, 1.0, shape + (n_passive,))], -1)
    return Up


def _pair(mix, jmix, Up):
    """(U, Up) in torch and in JAX from numpy primitives."""
    jUp = jnp.asarray(Up)
    jU = jmix.conservatives(jUp)
    U = torch.as_tensor(np.asarray(jU))
    return (U, mix.primitives(U)), (jU, jmix.primitives(jU))


# ------------------------------------------------------------ 1. DryAir


@pytest.mark.parametrize("nvel,n_passive", [(2, 0), (3, 0), (2, 1)])
def test_dry_air_sponge_methods_match_jax(nvel, n_passive):
    mix = DryAir(dim=2, nvel=nvel, n_passive=n_passive)
    jmix = JDryAir(dim=2, nvel=nvel, n_passive=n_passive)
    Up = _dry_state((5,), 2, 1, nvel=nvel, n_passive=n_passive)
    (U, _), (jU, _) = _pair(mix, jmix, Up)
    rho, vel, T = (torch.as_tensor(Up[..., 0]),
                   torch.as_tensor(Up[..., 1:1 + nvel]),
                   torch.as_tensor(Up[..., nvel + 1]))
    assert _rel(mix.total_energy(rho, vel, T), jmix.total_energy(
        jnp.asarray(Up[..., 0]), jnp.asarray(Up[..., 1:1 + nvel]),
        jnp.asarray(Up[..., nvel + 1]))) <= TOL
    p = torch.full((5,), 9.0e4)
    assert _rel(mix.modify_energy_for_pressure(U, p, modify_electron_energy=True),
                jmix.modify_energy_for_pressure(jU, jnp.full((5,), 9.0e4),
                                                modify_electron_energy=True)) <= TOL
    # the mixed-out inversion of a subsonic state's own normal flux
    n = np.array([0.6, 0.8])
    fl, jfl = Fluxes(mixture=mix), JFluxes(mixture=jmix)
    Fn = torch.einsum("qd,d->q", fl.convective(U[0]), torch.as_tensor(n))
    jFn = jnp.einsum("qd,d->q", jfl.convective(jU[0]), jnp.asarray(n))
    got = mix.conserved_from_convective_flux(Fn, torch.as_tensor(n))
    want = jmix.conserved_from_convective_flux(jFn, jnp.asarray(n))
    assert _rel(got, want) <= TOL
    assert _rel(got, U[0]) <= 1e-11


# ------------------------------------------------- 2. pressure gradient, heat


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("viscous", [False, True])
def test_pressure_gradient_matches_jax(dim, viscous):
    tab, jtab, xyz = _tables(dim)
    mix, jmix = DryAir(dim=dim, nvel=dim), JDryAir(dim=dim, nvel=dim)
    (U, Up), (jU, jUp) = _pair(mix, jmix, _dry_state(xyz.shape[:-1], dim, 2))
    g = (-0.887037, 3.5, -2.0)
    grad = None
    if viscous:
        grad = np.random.default_rng(3).standard_normal(
            xyz.shape[:-1] + (dim + 2, dim)) * 50.0
    f = tf.ConstantPressureGradient(mixture=mix, press_grad=g)
    jfc = jf.ConstantPressureGradient(mixture=jmix, press_grad=g)
    got = f(0.0, tab, U, Up, None if grad is None else torch.as_tensor(grad))
    want = jfc(0.0, jtab, jU, jUp, None if grad is None else jnp.asarray(grad))
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("dim", [2, 3])
def test_heat_source_matches_jax(dim):
    tab, jtab, xyz = _tables(dim)
    mix, jmix = DryAir(dim=dim, nvel=dim), JDryAir(dim=dim, nvel=dim)
    (U, Up), (jU, jUp) = _pair(mix, jmix, _dry_state(xyz.shape[:-1], dim, 4))
    # the axis along z in 3-D; in 2-D a segment in the plane (its z is cut)
    ends = (((0.5, 0.5, -1.0), (0.5, 0.5, 1.0)) if dim == 3
            else ((0.2, 0.5, 0.0), (0.8, 0.5, 0.0)))
    kw = dict(value=1.0e7, point1=ends[0], point2=ends[1], radius=0.3)
    got = tf.HeatSource(mixture=mix, **kw)(0.0, tab, U, Up, None)
    want = jf.HeatSource(mixture=jmix, **kw)(0.0, jtab, jU, jUp, None)
    assert np.array_equal(_np(got), _np(want))
    assert (_np(got)[..., dim + 1] > 0).any()


# ---------------------------------------------------------- 3. sponge target


def test_dry_air_sponge_target_matches_jax():
    for nvel in (2, 3):
        mix, jmix = DryAir(dim=2, nvel=nvel), JDryAir(dim=2, nvel=nvel)
        args = (1.2, (10.0, -3.0, 2.0), 101300.0)
        got = tf.sponge_target_conserved(mix, *args)
        want = jf.sponge_target_conserved(jmix, *args)
        assert _rel(np.asarray(got), np.asarray(want)) <= TOL


_PLASMA = []


def _argon():
    """(port, JAX) plasma setups of argon_minimal.ini in 2-D."""
    if not _PLASMA:
        _PLASMA.append((build_plasma(IniInput.read(ARGON), 2, 2),
                        jbuild_plasma(JIniInput.read(ARGON), 2, 2)))
    return _PLASMA[0]


@pytest.mark.parametrize("single_t", [False, True])
def test_argon_sponge_target_matches_jax(single_t):
    """Species densities from the input-ordered mass fractions (the
    mixture order is [Ar.+1, E, Ar]), and the electron energy n_e cv_e T_e
    from the deck's T_e (or, with single_temperature, from the heavy
    temperature)."""
    pl, jpl = _argon()
    mix, jmix = pl.mixture, jpl.mixture
    # the deck's input species are [E, Ar, Ar.+1]
    fracs = {1: 1.0e-8, 2: 0.9999999, 3: 1.0e-7}
    i2m = np.asarray(jpl.input_to_mixture)
    assert np.array_equal(np.asarray(pl.input_to_mixture), i2m)
    ys = tuple(fracs[int(np.where(i2m == sp)[0][0]) + 1]
               for sp in range(mix.num_active_species))
    args = (1.6, (10.0, 0.0, 0.0), 101300.0, ys, None if single_t else 400.0,
            single_t)
    got = np.asarray(tf.sponge_target_conserved(mix, *args))
    want = np.asarray(jf.sponge_target_conserved(jmix, *args))
    assert _rel(got, want) <= TOL
    assert got[mix.nvel + 2] == pytest.approx(1.6 * 1.0e-7, rel=1e-12)
    assert got[mix.num_equations - 1] > 0.0


# ------------------------------------------------------------ 4. sponge zone


def _sponge_kw(kind, dim):
    if kind == "planar":
        return dict(normal=(-1.0, 0.0, 0.0), p0=(1.0, 0.0, 0.0),
                    p_init=(0.5, 0.0, 0.0), mult=0.5)
    return dict(normal=(0.0, 0.0, -1.0), p0=(0.0, 0.0, 1.0),
                p_init=(0.0, 0.0, 0.0), mult=1.0, sz_type="annulus", r1=0.2,
                r2=1.0)


# the annulus about the z axis of the 3-D box (in 2-D its axis would lie
# in the plane)
@pytest.mark.parametrize("dim,kind", [(2, "planar"), (3, "planar"),
                                      (3, "annulus")])
@pytest.mark.parametrize("sol", ["userDef", "mixedOut"])
def test_sponge_zone_matches_jax(dim, kind, sol):
    tab, jtab, xyz = _tables(dim)
    mix, jmix = DryAir(dim=dim, nvel=dim), JDryAir(dim=dim, nvel=dim)
    (U, Up), (jU, jUp) = _pair(mix, jmix, _dry_state(xyz.shape[:-1], dim, 5))
    kw = _sponge_kw(kind, dim)
    if sol == "userDef":
        vel = (5.0, 2.0, -1.0)
        p = 1.0 * 287.058 * 300.0
        kw.update(target_u=tf.sponge_target_conserved(mix, 1.0, vel, p))
        jkw = dict(kw, target_u=jf.sponge_target_conserved(jmix, 1.0, vel, p))
        f = tf.SpongeZone(mixture=mix, **kw)
        jfc = jf.SpongeZone(mixture=jmix, **jkw)
    else:
        # GL p=1 nodes lie inside the elements: a wide sampling band
        kw.update(target_u=None, sol_type="mixedOut", tol=0.3)
        f = tf.SpongeZone(mixture=mix, fluxes=Fluxes(mixture=mix), **kw)
        jfc = jf.SpongeZone(mixture=jmix, fluxes=JFluxes(mixture=jmix), **kw)
    got = f(0.0, tab, U, Up, None)
    want = jfc(0.0, jtab, jU, jUp, None)
    assert _rel(got, want) <= TOL
    assert np.abs(_np(want)).max() > 0.0
    # the cached constants serve a second call unchanged
    assert torch.equal(f(0.0, tab, U, Up, None), got)


@pytest.mark.parametrize("sol", ["userDef", "mixedOut"])
def test_argon_sponge_zone_matches_jax(sol):
    """The planar sponge on the argon ternary (its sound speed and the
    mixed-out inversion are the mixture's)."""
    pl, jpl = _argon()
    mix, jmix = pl.mixture, jpl.mixture
    tab, jtab, xyz = _tables(2)
    rng = np.random.default_rng(9)
    shape = xyz.shape[:-1]
    jUp = jnp.stack([1.6 + 0.1 * rng.uniform(-1, 1, shape),
                     40.0 + 5.0 * rng.uniform(-1, 1, shape),
                     -5.0 + 5.0 * rng.uniform(-1, 1, shape),
                     9000.0 + 500.0 * rng.uniform(-1, 1, shape),
                     0.4 + 0.05 * rng.uniform(-1, 1, shape),
                     11000.0 + 500.0 * rng.uniform(-1, 1, shape)], -1)
    jU = jmix.conservatives(jUp)
    U = torch.as_tensor(np.array(jU))
    kw = _sponge_kw("planar", 2)
    if sol == "userDef":
        args = (1.6, (10.0, 0.0, 0.0), 101300.0, (1.0e-7,), 400.0)
        f = tf.SpongeZone(mixture=mix, target_u=tf.sponge_target_conserved(
            mix, *args), **kw)
        jfc = jf.SpongeZone(mixture=jmix, target_u=jf.sponge_target_conserved(
            jmix, *args), **kw)
    else:
        kw.update(target_u=None, sol_type="mixedOut", tol=0.3)
        f = tf.SpongeZone(mixture=mix, fluxes=Fluxes(mixture=mix), **kw)
        jfc = jf.SpongeZone(mixture=jmix, fluxes=JFluxes(mixture=jmix), **kw)
    got = f(0.0, tab, U, mix.primitives(U), None)
    want = jfc(0.0, jtab, jU, jmix.primitives(jU), None)
    assert _rel(got, want) <= TOL


def test_annulus_on_the_axis_is_finite():
    """A node on the annulus's axis (R = 0): the JAX package divides by
    maximum(R, 1e-300), which underflows in float32; the port guards the
    divide with `where`, so float32 and float64 agree there."""
    mix = DryAir(dim=3, nvel=3)
    target = tf.sponge_target_conserved(mix, 1.0, (0.0, 2.0, 0.0), 86117.4)
    kw = _sponge_kw("annulus", 3)
    kw.update(r1=0.0)
    f = tf.SpongeZone(mixture=mix, target_u=target, **kw)
    xyz = torch.tensor([[[0.0, 0.0, 0.5], [0.3, 0.4, 0.5]]])
    tab = type("Tab", (), {"xyz_dof": xyz})()
    Up = torch.as_tensor(_dry_state((1, 2), 3, 6))
    U = mix.conservatives(Up)
    out64 = f(0.0, tab, U, mix.primitives(U), None)
    tab32 = type("Tab", (), {"xyz_dof": xyz.float()})()
    out32 = f(0.0, tab32, U.float(), mix.primitives(U.float()), None)
    assert torch.isfinite(out32).all()
    # float32's rounding of U - U_t (rho E ~ 2e5 against a difference of
    # ~5e3) sets this bar
    assert _rel(out32.double(), out64) <= 1e-4
    jmix = JDryAir(dim=3, nvel=3)
    jfc = jf.SpongeZone(mixture=jmix, target_u=target, **kw)
    jtab = type("Tab", (), {"xyz_dof": jnp.asarray(xyz.numpy())})()
    jU = jnp.asarray(U.numpy())
    assert _rel(out64, jfc(0.0, jtab, jU, jmix.primitives(jU), None)) <= TOL


# ------------------------------------------------------- 5. passive scalars


@pytest.mark.parametrize("dim", [2, 3])
def test_passive_scalar_and_flux_rows_match_jax(dim):
    tab, jtab, xyz = _tables(dim)
    mix = DryAir(dim=dim, nvel=dim, n_passive=1)
    jmix = JDryAir(dim=dim, nvel=dim, n_passive=1)
    (U, Up), (jU, jUp) = _pair(mix, jmix, _dry_state(xyz.shape[:-1], dim, 7,
                                                     n_passive=1))
    kw = dict(xyz=(0.5, 0.5, 0.5), radius=0.4, value=0.7)
    got = tf.PassiveScalar(mixture=mix, **kw)(0.0, tab, U, Up, None)
    want = jf.PassiveScalar(mixture=jmix, **kw)(0.0, jtab, jU, jUp, None)
    assert _rel(got, want) <= TOL and np.abs(_np(want)).max() > 0
    tr = DryAirTransport(mix.gas_constant, mix.specific_heat_ratio)
    jtr = JDryAirTransport(jmix.gas_constant, jmix.specific_heat_ratio)
    grad = np.random.default_rng(8).standard_normal(
        xyz.shape[:-1] + (dim + 3, dim)) * 40.0
    for eq in ("ns-passive", "navier-stokes"):
        fl = Fluxes(mixture=mix, transport=tr, eq_system=eq)
        jfl = JFluxes(mixture=jmix, transport=jtr, eq_system=eq)
        assert _rel(fl.convective(U), jfl.convective(jU)) <= TOL
        F = fl.viscous(U, Up, torch.as_tensor(grad))
        jF = jfl.viscous(jU, jUp, jnp.asarray(grad))
        assert _rel(F, jF) <= TOL
        # the Fick row mu/Sc grad Z on ns-passive, none on navier-stokes
        assert (np.abs(_np(jF)[..., -1, :]).max() > 0) == (eq == "ns-passive")


# ------------------------------------------------------------------ 6. MMS


def _exact(lib):
    two_pi = 2 * np.pi

    def exact(xy, t):
        x, y = xy[..., 0], xy[..., 1]
        rho = 1.0 + 0.1 * lib.sin(two_pi * (x - 0.3 * t))
        u = 0.5 + 0.05 * lib.cos(two_pi * y) * lib.sin(two_pi * 0.2 * t)
        v = 0.0 * u
        T = 1.0 + 0.05 * lib.cos(two_pi * x) + 0.0 * t
        return lib.stack([rho, u, v, T], -1)

    return exact


def test_mms_forcing_matches_jax():
    """tests/test_forcing.py's field on a periodic 4x4 p=2 box, Euler."""
    kw = dict(nx=4, ny=4, periodic_x=True, periodic_y=True)
    tab = build_tables(generators.box_2d(**kw), order=2).to_torch(
        torch.float64, "cpu")
    jtab = jbuild_tables(jgenerators.box_2d(**kw), order=2).to_jax(
        jnp.float64)
    mix, jmix = DryAir(dim=2, nvel=2, gas_constant=1.0), JDryAir(
        dim=2, nvel=2, gas_constant=1.0)
    fl, jfl = Fluxes(mixture=mix, eq_system="euler"), JFluxes(
        mixture=jmix, eq_system="euler")
    f = tf.make_mms_forcing(_exact(torch), RHSContext(
        fluxes=fl, riemann=Rusanov(fl)), tab)
    jfc = jf.make_mms_forcing(_exact(jnp), JRHSContext(
        fluxes=jfl, riemann=JRusanov(jfl)), jtab)
    for t in (0.0, 0.37):
        got = f(torch.tensor(t), tab, None, None, None)
        want = jfc(t, jtab, None, None, None)
        assert _rel(got, want) <= 1e-11
    jax.clear_caches()
