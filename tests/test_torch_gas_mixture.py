"""tps_torch's general plasma transport, radiative decay and the
six-species argon deck against the JAX package's, on the CPU in f64.

- GasMixtureTransport (physics/gas_transport.py, the `argon_mixture`
  model): tests/test_gas_mixture_transport.py's three cases through the
  port, each also against tps_tpu on the same inputs: on the argon ternary
  it equals ArgonMinimalTransport; on the nitrogen plasma [N+, N, E, N2]
  and on tests/inputs/argon_full.ini's six species its flux and source
  properties equal tps_tpu's; an unknown pair raises.
- ConstantPlasmaTransport on the ternary with per-species diffusivities.
- The escape-factor radiative decay (physics/radiative_decay.py):
  tests/test_chemistry.py::test_radiative_decay_rate's optically thin and
  thick cases, and the rates equal tps_tpu's.
- The DG source term with tabulated rates and net emission, and with the
  radiative decays of argon_full.ini, equals tps_tpu's SourceTerm.
- tests/inputs/argon_full.ini (six species, argon_mixture transport,
  radiative decay) through both packages' harness, 4 RK3 steps:
  tests/test_plasma_solver.py::test_argon_full_multilevel_plasma's checks
  on the port, the state within 1e-9 of tps_tpu's.
- The ternary on Euler (2-D) and in 3-D: one right-hand side against
  tps_tpu's compute_rhs.

Bar: 1e-12 of max|ref| per quantity (TOL), unless a check states a wider
one and why.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
from threadpoolctl import threadpool_limits

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
threadpool_limits(1)  # numpy's and scipy's BLAS too: one thread a worker

from tps_torch import harness  # noqa: E402
from tps_torch.config.ini import IniInput  # noqa: E402
from tps_torch.physics import gas_transport as pgt  # noqa: E402
from tps_torch.physics.perfect_mixture import PerfectMixture  # noqa: E402
from tps_torch.physics.plasma_config import build_plasma  # noqa: E402
from tps_torch.physics.radiative_decay import RadiativeDecay  # noqa: E402
from tps_tpu.config.ini import IniInput as JIniInput  # noqa: E402
from tps_tpu.harness import Tps as JTps  # noqa: E402
from tps_tpu.physics import gas_transport as jgt  # noqa: E402
from tps_tpu.physics import radiative_decay as jrd  # noqa: E402
from tps_tpu.physics.perfect_mixture import \
    PerfectMixture as JPerfectMixture  # noqa: E402
from tps_tpu.physics.plasma_config import \
    build_plasma as jbuild_plasma  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FULL = os.path.join(HERE, "inputs", "argon_full.ini")
MINIMAL = os.path.join(HERE, "inputs", "argon_minimal.ini")
TOL = 1e-12
DECK_TOL = 1e-9
MW_AR, MW_E = 39.948e-3, 5.4858e-7
MW_N2, MW_N = 28.0134e-3, 14.0067e-3


@pytest.fixture(autouse=True)
def f64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def _close(a, ref, tol=TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    ref = np.asarray(ref)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    scale = np.max(np.abs(ref))
    assert np.all(np.isfinite(a))
    err = np.max(np.abs(a - ref)) / max(scale, 1e-300)
    assert err <= tol, err


def _mixtures(kind):
    """(port, JAX) PerfectMixture and species names: the ternary argon
    (non-ambipolar) or the nitrogen plasma [N+, N, E, N2]."""
    if kind == "argon3":
        kw = dict(dim=2, nvel=2, mw=(MW_AR - MW_E, MW_E, MW_AR),
                  charges=(1.0, -1.0, 0.0),
                  formation_energy=(1.521e6, 0.0, 0.0),
                  molar_cv_over_R=(1.5, 1.5, 1.5), two_temperature=True)
        names = ("Ar.+1", "E", "Ar")
    else:
        kw = dict(dim=2, nvel=2, mw=(MW_N - MW_E, MW_N, MW_E, MW_N2),
                  charges=(1.0, 0.0, -1.0, 0.0),
                  formation_energy=(1.402e6, 3.36e4, 0.0, 0.0),
                  molar_cv_over_R=(1.5, 1.5, 1.5, 2.5), two_temperature=True)
        names = ("N.+1", "N", "E", "N2")
    return PerfectMixture(**kw), JPerfectMixture(**kw), names


def _state(mix, n, seed, rho=0.05, T=8000.0, Te=12000.0, fracs=None):
    """Conserved states [n, neq] (numpy) and primitive gradients."""
    rng = np.random.default_rng(seed)
    na = mix.num_active_species
    Up = np.zeros((n, mix.num_equations))
    Up[:, 0] = rho * rng.uniform(0.9, 1.1, n)
    Up[:, 1:3] = rng.uniform(-20, 20, (n, 2))
    Up[:, 3] = T * rng.uniform(0.8, 1.2, n)
    fracs = fracs or [1e-3] * na
    for s in range(na):
        # mole fractions of the background's molar density
        Up[:, 4 + s] = fracs[s] * Up[:, 0] / mix.mw[-1] * rng.uniform(0.5, 2, n)
    Up[:, -1] = Te * rng.uniform(0.8, 1.2, n)
    U = mix.conservatives(torch.as_tensor(Up)).numpy()
    G = rng.standard_normal(Up.shape + (2,)) * np.abs(Up)[..., None] * 1e2
    return U, G


def _props(tr, jtr, mix, jmix, U, G, keys, tol=TOL):
    Ut, Gt = torch.as_tensor(U), torch.as_tensor(G)
    Uj, Gj = jnp.asarray(U), jnp.asarray(G)
    a = tr.flux_properties(mix, Ut, mix.primitives(Ut), Gt)
    b = jtr.flux_properties(jmix, Uj, jmix.primitives(Uj), Gj)
    for k in keys:
        _close(a[k], b[k], tol.get(k, TOL) if isinstance(tol, dict) else tol)
    sa = tr.source_properties(Ut, mix.primitives(Ut), Gt)
    sb = jtr.source_properties(Uj, jmix.primitives(Uj), Gj)
    for k in ("sigma", "mf_freq", "diff_vel"):
        _close(sa[k], sb[k])
    return a, sa


# ------------------------------------------------------- transport


def test_matches_argon_minimal_on_ternary():
    mix, jmix, names = _mixtures("argon3")
    U, G = _state(mix, 16, 1)
    tr_min = pgt.ArgonMinimalTransport(mixture=mix)
    tr_gen = pgt.GasMixtureTransport(mixture=mix, species_names=names)
    Ut, Gt = torch.as_tensor(U), torch.as_tensor(G) * 1e-5
    a = tr_min.flux_properties(mix, Ut, mix.primitives(Ut), Gt)
    b = tr_gen.flux_properties(mix, Ut, mix.primitives(Ut), Gt)
    for k in ("visc", "kappa", "kappa_e", "diffusivity", "diff_vel"):
        _close(b[k], a[k])
    sa = tr_min.source_properties(Ut, mix.primitives(Ut), Gt)
    sb = tr_gen.source_properties(Ut, mix.primitives(Ut), Gt)
    for k in ("sigma", "mf_freq"):
        _close(sb[k], sa[k])
    # and tps_tpu's on the same inputs
    jtr = jgt.GasMixtureTransport(mixture=jmix, species_names=names)
    _props(tr_gen, jtr, mix, jmix, U, G * 1e-5,
           ("visc", "kappa", "kappa_e", "diffusivity", "diff_vel"))


def test_nitrogen_mixture_transport_physical():
    mix, jmix, names = _mixtures("nitrogen")
    U, G = _state(mix, 6, 2, fracs=[1e-4, 1e-3, 1e-4])
    tr = pgt.GasMixtureTransport(mixture=mix, species_names=names)
    jtr = jgt.GasMixtureTransport(mixture=jmix, species_names=names)
    p, s = _props(tr, jtr, mix, jmix, U, G * 1e-6,
                  ("visc", "kappa", "kappa_e", "diffusivity", "diff_vel"))
    visc = p["visc"].numpy()
    assert np.isfinite(visc).all() and (2e-5 < visc).all() and (visc < 1e-3).all()
    assert (p["kappa_e"].numpy() > 0).all()
    _, Y, _ = mix.species_primitives(torch.as_tensor(U))
    drift = torch.einsum("ns,nsd->nd", Y, p["diff_vel"])
    assert float(torch.abs(drift).max()) < 1e-12
    assert (s["sigma"].numpy() > 0).all()
    mf = s["mf_freq"].numpy()
    assert np.isfinite(mf).all() and (mf >= 0).all()
    assert (mf[:, :2] > 0).all() and (mf[:, 3] > 0).all()


def test_unknown_pair_raises():
    mix, _, _ = _mixtures("nitrogen")
    with pytest.raises(NotImplementedError, match="collision-integral"):
        pgt.GasMixtureTransport(mixture=mix,
                                species_names=("N2.+1", "N", "E", "N2"))


@pytest.mark.parametrize("third_order", [True, False])
def test_argon_full_transport_matches_jax(third_order):
    """The six species of argon_full.ini (the excited states take ground
    argon's collision data), the third-order electron conductivity on and
    off.  kappa_e is held to 5e-12: Devoto's combination l11 - l12^2/l22
    cancels ~3 digits, as in tests/test_torch_plasma.py."""
    port = build_plasma(IniInput.read(FULL), 2, 2)
    ref = jbuild_plasma(JIniInput.read(FULL), 2, 2)
    assert port.species_names == ref.species_names
    tr = pgt.GasMixtureTransport(
        mixture=port.mixture, species_names=port.transport.species_names,
        third_order_electron_thermal_conductivity=third_order)
    jtr = jgt.GasMixtureTransport(
        mixture=ref.mixture, species_names=ref.transport.species_names,
        third_order_electron_thermal_conductivity=third_order)
    U, G = _state(port.mixture, 24, 5, rho=0.16, T=2000.0, Te=9000.0,
                  fracs=[1e-3, 1e-4, 1e-4, 1e-4])
    _props(tr, jtr, port.mixture, ref.mixture, U, G * 1e-5,
           ("visc", "kappa", "kappa_e", "diffusivity", "diff_vel"),
           tol={"kappa_e": 5e-12})


def test_constant_plasma_transport_matches_jax():
    mix, jmix, _ = _mixtures("argon3")
    kw = dict(visc=5e-5, bulk_visc=1e-6, kappa=0.04, kappa_e=0.5,
              diffusivity=(1.2e-4, 2e-3, 1e-4), mt_freq=(2e9, 0.0, 1e9))
    tr = pgt.ConstantPlasmaTransport(mixture=mix, **kw)
    jtr = jgt.ConstantPlasmaTransport(mixture=jmix, **kw)
    U, G = _state(mix, 16, 3)
    _props(tr, jtr, mix, jmix, U, G * 1e-5,
           ("visc", "bulk_visc", "kappa", "kappa_e", "diffusivity",
            "diff_vel", "mobility"))
    Ut = torch.as_tensor(U)
    _close(tr.electric_conductivity(Ut, mix.primitives(Ut)),
           jtr.electric_conductivity(jnp.asarray(U),
                                     jmix.primitives(jnp.asarray(U))))


# ------------------------------------------------------- radiative decay


def test_radiative_decay_rate():
    """Optically thin at low density (escape factor -> 1: the Boltzmann
    average of the A coefficients) and trapped at high ground-state
    density; the rates equal tps_tpu's."""
    from tps_torch.constants import UNIVERSAL_GAS_CONSTANT as R

    kw = dict(upper="Ar_r", lower="Ar", i_upper=0, i_lower=1, radius=0.01)
    rd, jrd_ = RadiativeDecay(**kw), jrd.RadiativeDecay(**kw)
    Te = torch.full((3,), 12000.0)
    Th = torch.full((3,), 1000.0)
    rates = {}
    for case, n in (("thin", [[1e-12, 1e-15]] * 3),
                    ("thick", [[1e-3, 40.0]] * 3)):
        k = rd(Te, n_sp=torch.as_tensor(n), Th=Th, Te=Te)
        jk = jrd_(jnp.asarray(Te.numpy()), n_sp=jnp.asarray(n),
                  Th=jnp.asarray(Th.numpy()), Te=jnp.asarray(Te.numpy()))
        _close(k, jk)
        rates[case] = k.numpy()
    E, g = jrd.E_LVL["Ar_r"], jrd.G_LVL["Ar_r"]
    w = g * np.exp(-E / R / 12000.0)
    A_mean = (w * jrd.AJI[("Ar_r", "Ar")][:, 0]).sum() / w.sum()
    assert np.allclose(rates["thin"], A_mean, rtol=1e-6)
    assert (rates["thick"] < 1e-3 * A_mean).all()
    assert (rates["thick"] > 0).all()
    # the 4p -> metastable decay of argon_full.ini, on a grid of densities
    port = build_plasma(IniInput.read(FULL), 2, 2)
    ref = jbuild_plasma(JIniInput.read(FULL), 2, 2)
    rng = np.random.default_rng(4)
    n_sp = 10 ** rng.uniform(-8, 1, (40, 6))
    T = rng.uniform(300.0, 15000.0, (2, 40))
    for m, jm in zip(port.chemistry.models[2:], ref.chemistry.models[2:]):
        assert (m.upper, m.lower, m.i_upper, m.i_lower, m.radius) == (
            jm.upper, jm.lower, jm.i_upper, jm.i_lower, jm.radius)
        _close(m(torch.as_tensor(T[1]), n_sp=torch.as_tensor(n_sp),
                 Th=torch.as_tensor(T[0]), Te=torch.as_tensor(T[1])),
               jm(jnp.asarray(T[1]), n_sp=jnp.asarray(n_sp),
                  Th=jnp.asarray(T[0]), Te=jnp.asarray(T[1])))


# ------------------------------------------------------- source term


def _table_deck(tmp_path):
    """argon_minimal.ini with its rate tabulated and net emission."""
    T = np.linspace(200.0, 30000.0, 60)
    k = 4.7 * T ** 1.2 * np.exp(-6.49e4 / T)
    nec = 1e3 * (T / 1e4) ** 3
    with open(MINIMAL) as f:
        text = f.read()
    def vec(a):
        return "'" + " ".join(f"{v:.17g}" for v in a) + "'"

    text = text.replace("model = arrhenius", "model = tabulated\n"
                        f"tabulated/x = {vec(T)}\ntabulated/f = {vec(k)}")
    text = text.replace("[plasma_models]\n", "[plasma_models]\n"
                        "radiation_model = net_emission\n", 1)
    text += ("\n[plasma_models/radiation_model/net_emission/tabulated]\n"
             f"x = {vec(T)}\nf = {vec(nec)}\n")
    path = tmp_path / "tables.ini"
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("deck", ["tables", "full", "efield"])
def test_source_term_matches_jax(deck, tmp_path):
    """The source term with tabulated rates and net emission, with
    argon_full.ini's radiative decays, and with an external E-field (the
    charged species' drift in the diffusion velocities)."""
    from tps_torch.dg.source_term import SourceTerm
    from tps_tpu.dg.source_term import SourceTerm as JSourceTerm

    path = {"tables": None, "full": FULL, "efield": MINIMAL}[deck] \
        or _table_deck(tmp_path)
    port = build_plasma(IniInput.read(path), 2, 2)
    ref = jbuild_plasma(JIniInput.read(path), 2, 2)
    if deck == "tables":
        assert port.radiation is not None
        assert type(port.chemistry.models[0]).__name__ == "TabulatedRate"
    mix, jmix = port.mixture, ref.mixture
    na = mix.num_active_species
    U, G = _state(mix, 20, 6, rho=0.16 if deck == "full" else 1.6,
                  T=2000.0, Te=9000.0, fracs=[1e-3] + [1e-4] * (na - 1))
    E = (np.random.default_rng(9).standard_normal((20, 2)) * 1e3
         if deck == "efield" else None)
    st = SourceTerm(mixture=mix, transport=port.transport,
                    chemistry=port.chemistry, radiation=port.radiation,
                    efield=None if E is None else torch.as_tensor(E))
    jst = JSourceTerm(mixture=jmix, transport=ref.transport,
                      chemistry=ref.chemistry, radiation=ref.radiation,
                      efield=None if E is None else jnp.asarray(E))
    Ut = torch.as_tensor(U)
    y = st(0.0, None, Ut, mix.primitives(Ut), torch.as_tensor(G * 1e-5))
    Uj = jnp.asarray(U)
    jy = np.asarray(jst(0.0, None, Uj, jmix.primitives(Uj),
                        jnp.asarray(G * 1e-5)))
    for q in range(mix.num_equations):
        if np.abs(jy[:, q]).max() > 0:
            _close(y[:, q], jy[:, q])
    _close(st.plasma_conductivity(Ut, mix.primitives(Ut)),
           jst.plasma_conductivity(Uj, jmix.primitives(Uj)))
    if E is not None:  # the drift the field adds to the diffusion
        g = G * 1e-5
        dv = port.transport.source_properties(
            Ut, mix.primitives(Ut), torch.as_tensor(g),
            efield=torch.as_tensor(E))["diff_vel"]
        jdv = ref.transport.source_properties(
            Uj, jmix.primitives(Uj), jnp.asarray(g),
            efield=jnp.asarray(E))["diff_vel"]
        _close(dv, jdv)
        dv0 = port.transport.source_properties(
            Ut, mix.primitives(Ut), torch.as_tensor(g))["diff_vel"]
        assert float(torch.abs(dv - dv0).max()) > 1e-3 * float(
            torch.abs(dv0).max())


# ------------------------------------------------------- decks


def _port(path, tmp_path, edits=None):
    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", path, "--device", "cpu"])
    tps.parse_input()
    for k, v in (edits or {}).items():
        tps.config.raw.values[k] = v
    tps.config.outdir = str(tmp_path)
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    return tps


def _jax(path, tmp_path):
    tps = JTps()
    tps.input_file = path
    tps.parse_input()
    tps.config.outdir = str(tmp_path / "jax")
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    return tps


def _states_close(U, jU, tol=DECK_TOL, speed=None, nvel=2):
    """U within tol of jU per equation, relative to the column's max; the
    momenta of a fluid at rest (0 up to rounding) relative to max rho
    times `speed` (the max characteristic speed)."""
    U, jU = np.asarray(U), np.asarray(jU)
    for q in range(jU.shape[-1]):
        scale = np.abs(jU[..., q]).max()
        if speed is not None and 1 <= q <= nvel:
            scale = max(scale, np.abs(jU[..., 0]).max() * speed)
        err = np.abs(U[..., q] - jU[..., q]).max() / scale
        assert np.isfinite(U[..., q]).all() and err <= tol, (q, err)


def test_argon_full_multilevel_plasma(tmp_path):
    """tests/test_plasma_solver.py::test_argon_full_multilevel_plasma's
    checks on the port (GasMixtureTransport, four reactions with the
    radiative decays, the resonance state decaying), and its 4 steps
    against tps_tpu's."""
    tps = _port(FULL, tmp_path)
    s = tps.solver
    assert isinstance(s.transport, pgt.GasMixtureTransport)
    assert s.plasma.chemistry.num_reactions == 4
    assert any(isinstance(m, RadiativeDecay) for m in s.plasma.chemistry.models)
    mix = s.mixture
    i_r = s.plasma.species_names.index("Ar_r")
    jtps = _jax(FULL, tmp_path)
    # the initial condition agrees to rounding; the run starts from
    # tps_tpu's, bit for bit
    speed = float(jnp.max(jtps.solver.mixture.max_char_speed(
        jtps.solver.U)))
    _states_close(s.state_global(), jtps.solver.U, TOL, speed)
    s.set_state_global(np.asarray(jtps.solver.U))
    n_r0 = float(s.U[..., mix.nvel + 2 + i_r].sum())
    tps.solve()
    jtps.solve()
    assert s.iter == 4 and s.check_nan() == 0
    assert float(s.U[..., mix.nvel + 2 + i_r].sum()) < n_r0
    Up = mix.primitives(s.U).numpy()
    assert (Up[..., mix.i_th] > 0).all() and np.isfinite(Up).all()
    _states_close(s.state_global(), jtps.solver.U, DECK_TOL, speed)


@pytest.mark.parametrize("dim,eq", [(2, "euler"), (3, "navier-stokes"),
                                    (3, "euler")])
def test_ternary_rhs_euler_and_3d(dim, eq):
    """One slot-path right-hand side of the argon ternary on a periodic
    box (2x2(x2) p=1), Euler or Navier-Stokes, against tps_tpu's
    compute_rhs with its source term on the same state."""
    import jax

    from tps_torch.dg.discretization import build_tables
    from tps_torch.dg.fluxes import Fluxes
    from tps_torch.dg.rhs import RHSContext, compute_rhs
    from tps_torch.dg.riemann import Rusanov
    from tps_torch.dg.source_term import SourceTerm
    from tps_torch.mesh.generators import box_2d, box_3d
    from tps_tpu.dg import rhs as jrhs
    from tps_tpu.dg.discretization import build_tables as jbuild_tables
    from tps_tpu.dg.fluxes import Fluxes as JFluxes
    from tps_tpu.dg.riemann import Rusanov as JRusanov
    from tps_tpu.dg.source_term import SourceTerm as JSourceTerm
    from tps_tpu.mesh.generators import box_2d as jbox_2d
    from tps_tpu.mesh.generators import box_3d as jbox_3d

    port = build_plasma(IniInput.read(MINIMAL), dim, dim)
    ref = jbuild_plasma(JIniInput.read(MINIMAL), dim, dim)
    if dim == 2:
        kw = dict(x1=0.01, y1=0.01, periodic_x=True, periodic_y=True)
        tab_np = build_tables(box_2d(3, 3, **kw), 1)
        jtab = jbuild_tables(jbox_2d(3, 3, **kw), 1)
    else:
        kw = dict(bounds=((0.0, 0.01),) * 3, periodic=(True,) * 3)
        tab_np = build_tables(box_3d(2, 2, 2, **kw), 1)
        jtab = jbuild_tables(jbox_3d(2, 2, 2, **kw), 1)
    fl = Fluxes(mixture=port.mixture,
                transport=None if eq == "euler" else port.transport,
                eq_system=eq)
    ctx = RHSContext(fluxes=fl, riemann=Rusanov(fl), forcings=(
        SourceTerm(mixture=port.mixture, transport=port.transport,
                   chemistry=port.chemistry),))
    jfl = JFluxes(mixture=ref.mixture, transport=ref.transport, eq_system=eq)
    jctx = jrhs.RHSContext(fluxes=jfl, riemann=JRusanov(jfl), forcings=(
        JSourceTerm(mixture=ref.mixture, transport=ref.transport,
                    chemistry=ref.chemistry),))
    mix = port.mixture
    xyz = tab_np.xyz_dof
    k = 2 * np.pi / 0.01
    wave = np.sin(k * xyz[..., 0]) * np.cos(k * xyz[..., 1])
    Up = np.zeros(xyz.shape[:-1] + (mix.num_equations,))
    Up[..., 0] = 1.6 * (1 + 0.05 * wave)
    Up[..., 1] = 10 + 3 * wave
    Up[..., 2] = -2 * wave
    if dim == 3:
        Up[..., 3] = 1.5 * np.cos(k * xyz[..., 2]) * wave
    Up[..., dim + 1] = 1800 * (1 + 0.05 * wave)
    Up[..., dim + 2] = 1e-3 * 1.6 / mix.mw[0] * (1 + 0.2 * wave)
    Up[..., dim + 3] = 9000 * (1 - 0.1 * wave)
    U = mix.conservatives(torch.as_tensor(Up))
    y, aux = compute_rhs(ctx, tab_np.to_torch(torch.float64, "cpu"), U)
    jy, jaux = jax.jit(lambda t, u: jrhs.compute_rhs(jctx, t, u))(
        jtab.to_jax(jnp.float64), jnp.asarray(U.numpy()))
    jy = np.asarray(jy)
    for q in range(mix.num_equations):
        _close(y[..., q], jy[..., q], 1e-11)
    _close(aux["max_char_speed"], jaux["max_char_speed"])


def test_transport_in_float_matches_double():
    """The plasma transport in a float run: the coupled channel's weakly
    ionised state (ion fraction 1e-7, T_e 300-700 K), float inputs, the
    properties within 1e-6 of the double evaluation of the same inputs.
    In float arithmetic the e-Ar log T fits lose ~5 digits there and the
    electron conductivity came out ~5x off (physics/gas_transport.py::
    _f64)."""
    path = os.path.join(os.path.dirname(HERE), "tps_torch", "tools",
                        "argon_channel_coupled.ini")
    pl = build_plasma(IniInput.read(path), 2, 2)
    mix, tr = pl.mixture, pl.transport
    rng = np.random.default_rng(0)
    n = 64
    Up = np.zeros((n, 6))
    Up[:, 0] = 1.6
    Up[:, 1] = rng.uniform(-1, 1, n)
    Up[:, 2] = 10 + rng.uniform(-1, 1, n)
    Up[:, 3] = rng.uniform(300, 310, n)
    Up[:, 4] = 1e-7 * 1.6 / mix.mw[0] * rng.uniform(0.9, 1.1, n)
    Up[:, 5] = rng.uniform(300, 700, n)
    U = mix.conservatives(torch.as_tensor(Up)).float()
    G = torch.as_tensor(rng.standard_normal((n, 6, 2))
                        * np.abs(Up)[..., None] * 10).float()
    ref = tr.flux_properties(mix, U.double(), mix.primitives(U.double()),
                             G.double())
    got = tr.flux_properties(mix, U, mix.primitives(U), G)
    for k in ("visc", "kappa", "kappa_e", "diff_vel"):
        assert got[k].dtype == torch.float32
        _close(got[k], ref[k].numpy(), 1e-6)
    src = tr.source_properties(U, mix.primitives(U), G)
    assert src["sigma"].dtype == torch.float32


def test_radiative_decay_in_float_is_finite():
    """argon_full.ini's decays at 300 K in a float run: the excited levels'
    Boltzmann weights (~1e-190) are below float's range, and the rate
    came out NaN (0 / 0); it is evaluated in double, within 1e-6 of the
    double rate of the same inputs."""
    port = build_plasma(IniInput.read(FULL), 2, 2)
    rng = np.random.default_rng(8)
    n_sp = torch.as_tensor(10 ** rng.uniform(-8, 1, (16, 6))).float()
    T = torch.full((16,), 300.0, dtype=torch.float32)
    for m in port.chemistry.models[2:]:
        k32 = m(T, n_sp=n_sp, Th=T, Te=T)
        k64 = m(T.double(), n_sp=n_sp.double(), Th=T.double(), Te=T.double())
        assert k32.dtype == torch.float32
        _close(k32, k64.numpy(), 1e-6)


@pytest.mark.parametrize("deck", ["full", "constant"])
def test_gas_mixture_kernel_constants(deck, tmp_path):
    """The constants dg/cuda_faces.py packs for csrc/dg_gas_mixture.cuh:
    their count is the header's gas_phys_len for the deck's species, the
    species count leads (the dispatch checks it), the pair kinds are
    symmetric, and the gate picks the variant ("gas_mixture" for
    argon_full.ini's six species, "argon_const" for the constant-transport
    ternary)."""
    import re

    from tps_torch.dg import cuda_faces
    from tps_torch.dg.fluxes import Fluxes
    from tps_torch.dg.rhs import RHSContext
    from tps_torch.dg.riemann import Rusanov

    if deck == "full":
        path = FULL
    else:
        text = open(MINIMAL).read().replace(
            "transport_model = argon_minimal", "transport_model = constant")
        text += ("\n[plasma_models/transport_model/constant]\nviscosity = 2e-5"
                 "\nthermal_conductivity = 0.02\ndiffusivity/species1 = 0.1\n"
                 "diffusivity/species2 = 4e-6\ndiffusivity/species3 = 4e-6\n")
        path = tmp_path / "constant.ini"
        path.write_text(text)
    pl = build_plasma(IniInput.read(str(path)), 2, 2)
    fl = Fluxes(mixture=pl.mixture, transport=pl.transport)
    ctx = RHSContext(fluxes=fl, riemann=Rusanov(fl))
    ns = pl.mixture.num_species
    with open(os.path.join(os.path.dirname(HERE), "tps_torch", "csrc",
                           "dg_gas_mixture.cuh")) as f:
        header = f.read()
    expr = re.search(r"gas_phys_len\(\) \{\s*return ([^;]+);", header).group(1)
    phys = cuda_faces.gas_mixture_phys(ctx)
    assert len(phys) == eval(" ".join(expr.split()), {"NS": ns})
    assert phys[0] == float(ns)
    assert cuda_faces.variant(ctx, 2) == ("gas_mixture" if deck == "full"
                                          else "argon_const")
    off = 1 + 5 * ns + 3 + 4 + ns + 3 + 2 * ns + 2 + ns * ns + 1 + 6
    kinds = np.asarray(phys[off:off + ns * ns]).reshape(ns, ns)
    assert np.array_equal(kinds, kinds.T)
