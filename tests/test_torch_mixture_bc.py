"""tps_torch's boundary conditions on a species mixture against the JAX
package's, on the CPU in f64.

- The mixture's BC helpers (physics/perfect_mixture.py:
  pressure_derivative, conserved_from_convective_flux,
  stagnant_state_with_temp, modify_energy_for_pressure,
  sound_speed_from_T) on the ternary argon and on argon_full.ini's six
  species.
- The general wall (dg/bc.py::GeneralWallBC): tests/test_wall_general.py's
  three cases through the port (the sheath's Bohm ion outflux and electron
  energy loss, the Bohm velocity, the adiabatic wall's zero heat), each
  flux also against tps_tpu's.
- The inlet with species mass fractions, the pressure outlet, the
  characteristic outlet and inlet and the far field on the ternary: each
  flux (and ghost advance) against tps_tpu's.
- The manufactured-state checks (tests/test_mms_ternary_bc.py's) are in
  tests/test_torch_mixture_mms.py.
- tests/inputs/argon_inflow_outflow.ini through both packages' harness,
  4 RK4 steps: tests/test_plasma_solver.py::test_argon_inflow_outflow's
  checks on the port, the state within 1e-9 of tps_tpu's.

Bar: 1e-12 of max|ref| (TOL) per quantity, unless a check states
another and why.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
from threadpoolctl import threadpool_limits

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
threadpool_limits(1)  # numpy's and scipy's BLAS too: one thread a worker

from test_argon_transport import MW_AR, MW_E, HF_ARP  # noqa: E402

from tps_torch import harness  # noqa: E402
from tps_torch.config.ini import IniInput  # noqa: E402
from tps_torch.dg import bc as pbc  # noqa: E402
from tps_torch.dg.fluxes import Fluxes  # noqa: E402
from tps_torch.dg.rhs import RHSContext  # noqa: E402
from tps_torch.dg.riemann import Rusanov  # noqa: E402
from tps_torch.physics.gas_transport import ArgonMinimalTransport  # noqa: E402
from tps_torch.physics.perfect_mixture import PerfectMixture  # noqa: E402
from tps_torch.physics.plasma_config import build_plasma  # noqa: E402
from tps_tpu.config.ini import IniInput as JIniInput  # noqa: E402
from tps_tpu.dg import bc as jbc  # noqa: E402
from tps_tpu.dg import rhs as jrhs  # noqa: E402
from tps_tpu.dg.fluxes import Fluxes as JFluxes  # noqa: E402
from tps_tpu.dg.riemann import Rusanov as JRusanov  # noqa: E402
from tps_tpu.harness import Tps as JTps  # noqa: E402
from tps_tpu.physics.gas_transport import \
    ArgonMinimalTransport as JArgonMinimalTransport  # noqa: E402
from tps_tpu.physics.perfect_mixture import \
    PerfectMixture as JPerfectMixture  # noqa: E402
from tps_tpu.physics.plasma_config import \
    build_plasma as jbuild_plasma  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FULL = os.path.join(HERE, "inputs", "argon_full.ini")
INOUT = os.path.join(HERE, "inputs", "argon_inflow_outflow.ini")
TOL = 1e-12
DECK_TOL = 1e-9


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
    assert np.all(np.isfinite(a))
    err = np.max(np.abs(a - ref)) / max(np.max(np.abs(ref)), 1e-300)
    assert err <= tol, err


def _cols_close(a, ref, tol=TOL):
    """Per equation (the last axis), each relative to its own max."""
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    ref = np.asarray(ref)
    for q in range(ref.shape[-1]):
        if np.max(np.abs(ref[..., q])) > 0:
            _close(a[..., q], ref[..., q], tol)
        else:
            assert np.max(np.abs(a[..., q])) == 0.0, q


def _argon3(ambipolar=True, two_temperature=True):
    kw = dict(dim=2, nvel=2, mw=(MW_AR - MW_E, MW_E, MW_AR),
              charges=(1.0, -1.0, 0.0), formation_energy=(HF_ARP, 0.0, 0.0),
              molar_cv_over_R=(1.5, 1.5, 1.5), ambipolar=ambipolar,
              two_temperature=two_temperature)
    return PerfectMixture(**kw), JPerfectMixture(**kw)


def _ctxs(ambipolar=True, two_temperature=True, eq="navier-stokes"):
    mix, jmix = _argon3(ambipolar, two_temperature)
    fl = Fluxes(mixture=mix, transport=ArgonMinimalTransport(mixture=mix),
                eq_system=eq)
    jfl = JFluxes(mixture=jmix, transport=JArgonMinimalTransport(mixture=jmix),
                  eq_system=eq)
    return (RHSContext(fluxes=fl, riemann=Rusanov(fl)),
            jrhs.RHSContext(fluxes=jfl, riemann=JRusanov(jfl)))


def _face_batch(mix, n=6, seed=3):
    """tests/test_wall_general.py::_face_batch: ionization 1e-3 at 8,000 K,
    outward normals +x, gradients ~1e-2; numpy arrays."""
    rng = np.random.RandomState(0)
    neq, nvel = mix.num_equations, mix.nvel
    Up = np.zeros((n, neq))
    Up[:, 0] = 0.1
    Up[:, 1 : 1 + nvel] = 10.0 * rng.randn(n, nvel)
    Up[:, mix.i_th] = 8000.0 * (0.9 + 0.2 * rng.rand(n))
    if mix.two_temperature:
        Up[:, mix.i_te] = 12000.0 * (0.9 + 0.2 * rng.rand(n))
    n_ion = 1e-3 * 0.1 / MW_AR
    Up[:, nvel + 2] = n_ion
    if not mix.ambipolar:
        Up[:, nvel + 3] = n_ion
    UL = mix.conservatives(torch.as_tensor(Up)).numpy()
    grad = np.random.RandomState(seed).randn(n, neq, mix.dim) * 1e-2
    nor = np.zeros((n, mix.dim))
    nor[:, 0] = 1.0
    return dict(UL=UL, grad=grad, nor=nor, xyz=np.zeros((n, mix.dim)),
                delta=np.full((n, 1), 1e-3))


def _bc_flux(bc, jbc_, ctx, jctx, d, state=None):
    """The port's and tps_tpu's flux of one BC on the batch d."""
    T = {k: torch.as_tensor(v) for k, v in d.items()}
    J = {k: jnp.asarray(v) for k, v in d.items()}
    mix, jmix = ctx.mixture, jctx.mixture
    f = bc.flux(ctx, T["UL"], mix.primitives(T["UL"]), T["grad"], T["nor"],
                T["xyz"], T["delta"], 0.0, state=state)
    jf = jbc_.flux(jctx, J["UL"], jmix.primitives(J["UL"]), J["grad"],
                   J["nor"], J["xyz"], J["delta"], 0.0,
                   state=None if state is None else jnp.asarray(state.numpy()))
    return f, np.asarray(jf)


# ------------------------------------------------------- BC helpers


@pytest.mark.parametrize("kind", ["ternary", "ternary_1t", "full"])
def test_mixture_bc_helpers_match_jax(kind):
    if kind == "full":
        mix = build_plasma(IniInput.read(FULL), 2, 2).mixture
        jmix = jbuild_plasma(JIniInput.read(FULL), 2, 2).mixture
    else:
        mix, jmix = _argon3(kind == "ternary", kind == "ternary")
    rng = np.random.default_rng(11)
    n, neq, nvel = 12, mix.num_equations, mix.nvel
    Up = np.zeros((n, neq))
    Up[:, 0] = rng.uniform(0.1, 1.6, n)
    Up[:, 1:3] = rng.uniform(-30, 30, (n, 2))
    Up[:, 3] = rng.uniform(300, 3000, n)
    for s in range(mix.num_active_species):
        Up[:, 4 + s] = Up[:, 0] / MW_AR * 10 ** rng.uniform(-6, -3, n)
    if mix.two_temperature:
        Up[:, -1] = rng.uniform(300, 12000, n)
    U = mix.conservatives(torch.as_tensor(Up))
    Uj = jnp.asarray(U.numpy())
    _cols_close(mix.conservatives(torch.as_tensor(Up)),
                jmix.conservatives(jnp.asarray(Up)))
    dUp = torch.as_tensor(rng.standard_normal((n, neq)) * np.abs(Up))
    _close(mix.pressure_derivative(dUp, U),
           jmix.pressure_derivative(jnp.asarray(dUp.numpy()), Uj))
    p = mix.pressure(U) * torch.as_tensor(rng.uniform(0.8, 1.2, n))
    for flag in (False, True):
        _cols_close(mix.modify_energy_for_pressure(U, p, flag),
                    jmix.modify_energy_for_pressure(Uj, jnp.asarray(p.numpy()),
                                                    flag))
        _close(mix.pressure(mix.modify_energy_for_pressure(U, p, flag)), p)
    for Tw in (300.0, 1234.5):
        _cols_close(mix.stagnant_state_with_temp(U, Tw),
                    jmix.stagnant_state_with_temp(Uj, Tw))
    T = torch.as_tensor(Up[:, 3])
    _close(mix.sound_speed_from_T(T), jmix.sound_speed_from_T(
        jnp.asarray(Up[:, 3])))
    # the mixed-out state of a state's own convective flux is the state;
    # 1e-10: its pressure root -B - sqrt(B^2 - 4AC) subtracts nearly equal
    # terms at low Mach numbers (|u| / c ~ 0.05 here), so both packages
    # carry ~1e-11 of rounding in it
    from tps_torch.dg.fluxes import Fluxes as F

    nrm = np.array([0.6, 0.8])
    Fc = torch.einsum("ned,d->ne", F(mixture=mix).convective(U),
                      torch.as_tensor(nrm))
    for i in range(n):
        if float(Fc[i, 0]) <= 0:  # an outflowing mass flux only
            continue
        got = mix.conserved_from_convective_flux(Fc[i], torch.as_tensor(nrm))
        want = jmix.conserved_from_convective_flux(jnp.asarray(Fc[i].numpy()),
                                                   jnp.asarray(nrm))
        _cols_close(got, want, 1e-10)


# ------------------------------------------------------- the general wall


def test_sheath_wall_ion_outflux_and_electron_energy_loss():
    ctx, jctx = _ctxs()
    mix = ctx.mixture
    d = _face_batch(mix)
    kw = dict(heavy="isothermal", electron="sheath", wall_temp=2000.0)
    f, jf = _bc_flux(pbc.GeneralWallBC(**kw), jbc.GeneralWallBC(**kw), ctx,
                     jctx, d)
    _cols_close(f, jf)
    flux = f.numpy()
    assert np.isfinite(flux).all()
    assert (flux[:, mix.nvel + 2] > 0).all()  # Bohm outflux of the ions
    assert (flux[:, mix.num_equations - 1] > 0).all()  # sheath energy loss


def test_sheath_bohm_velocity_magnitude():
    from tps_torch.constants import UNIVERSAL_GAS_CONSTANT as R

    ctx, jctx = _ctxs()
    mix, jmix = ctx.mixture, jctx.mixture
    d = _face_batch(mix)
    kw = dict(heavy="isothermal", electron="sheath", wall_temp=2000.0,
              wall_temp_e=2000.0)
    bc, jb = pbc.GeneralWallBC(**kw), jbc.GeneralWallBC(**kw)
    UL = torch.as_tensor(d["UL"])
    Uw, Upw = bc._wall_state(mix, UL, mix.primitives(UL))
    Vn, q = bc._sheath_flux(mix, Uw, Upw)
    jUL = jnp.asarray(d["UL"])
    jUw, jUpw = jb._wall_state(jmix, jUL, jmix.primitives(jUL))
    jVn, jq = jb._sheath_flux(jmix, jUw, jUpw)
    _cols_close(Vn, jVn)
    _close(q, jq)
    Th, Te = Upw[:, mix.i_th].numpy(), Upw[:, mix.i_te].numpy()
    assert np.allclose(Vn[:, 0].numpy(), np.sqrt((Th + Te) * R / mix.mw[0]),
                       rtol=1e-12)
    assert (q.numpy() > 0).all()
    assert np.allclose(Vn[:, mix.i_electron].numpy(), Vn[:, 0].numpy(),
                       rtol=1e-10)


def test_general_wall_adiabatic_matches_zero_heat():
    ctx, jctx = _ctxs(ambipolar=False, two_temperature=False)
    mix, jmix = ctx.mixture, jctx.mixture
    d = _face_batch(mix)
    kw = dict(heavy="adiabatic", electron="adiabatic")
    bc, jb = pbc.GeneralWallBC(**kw), jbc.GeneralWallBC(**kw)
    UL, jUL = torch.as_tensor(d["UL"]), jnp.asarray(d["UL"])
    Uw, Upw = bc._wall_state(mix, UL, mix.primitives(UL))
    jUw, jUpw = jb._wall_state(jmix, jUL, jmix.primitives(jUL))
    nhat = torch.as_tensor(d["nor"])
    fv = bc._wall_visc_general(ctx, Uw, Upw, torch.as_tensor(d["grad"]), nhat,
                               None, None)
    jfv = jb._wall_visc_general(jctx, jUw, jUpw, jnp.asarray(d["grad"]),
                                jnp.asarray(d["nor"]), None, None)
    _cols_close(fv, jfv)
    assert np.allclose(fv[:, mix.i_th].numpy(), 0.0, atol=1e-16)
    # and the whole wall flux
    f, jf = _bc_flux(bc, jb, ctx, jctx, d)
    _cols_close(f, jf)


# ------------------------------------------------------- the other BCs


def _bc_pairs(mix):
    Y = (1e-3,)
    return {
        "inlet": (pbc.InletBC(input_state=(0.12, 8.0, 1.0, *Y)),
                  jbc.InletBC(input_state=(0.12, 8.0, 1.0, *Y))),
        "outlet": (pbc.OutletBC(pressure=3.0e3),
                   jbc.OutletBC(pressure=3.0e3)),
        "isothermal": (pbc.GeneralWallBC(wall_temp=500.0, wall_temp_e=700.0),
                       jbc.GeneralWallBC(wall_temp=500.0, wall_temp_e=700.0)),
        "farfield": (pbc.FarFieldBC(input_state=(0.1, 5.0, 0.0, 3.0e3)),
                     jbc.FarFieldBC(input_state=(0.1, 5.0, 0.0, 3.0e3))),
        "inviscid": (pbc.WallBC(kind="inviscid"), jbc.WallBC(kind="inviscid")),
    }


@pytest.mark.parametrize("name", ["inlet", "outlet", "isothermal", "farfield",
                                  "inviscid"])
def test_mixture_bc_fluxes_match_jax(name):
    ctx, jctx = _ctxs()
    d = _face_batch(ctx.mixture, seed=5)
    bc, jb = _bc_pairs(ctx.mixture)[name]
    f, jf = _bc_flux(bc, jb, ctx, jctx, d)
    _cols_close(f, jf)


@pytest.mark.parametrize("kind", ["nonReflectingPressure",
                                  "nonReflectingMassFlow", "inlet"])
def test_mixture_characteristic_bcs_match_jax(kind):
    """The characteristic BCs' ghost advance on the ternary (their
    pressure derivative and sound speed are the mixture's)."""
    ctx, jctx = _ctxs()
    d = _face_batch(ctx.mixture, n=8, seed=7)
    if kind == "inlet":
        kw = dict(input_state=(0.1, 5.0, 0.0), ref_length=0.01)
        bc, jb = pbc.CharacteristicInletBC(**kw), jbc.CharacteristicInletBC(**kw)
    else:
        kw = dict(kind=kind, pressure=3.0e3, mass_flow=0.02, area=0.01,
                  ref_length=0.01)
        bc = pbc.CharacteristicOutletBC(**kw)
        jb = jbc.CharacteristicOutletBC(**kw)
    T = {k: torch.as_tensor(v) for k, v in d.items()}
    J = {k: jnp.asarray(v) for k, v in d.items()}
    mix, jmix = ctx.mixture, jctx.mixture
    wts = torch.linspace(0.5, 1.5, 8)
    st = bc.advance(ctx, T["UL"] * 1.01, T["UL"], mix.primitives(T["UL"]),
                    T["grad"] * 1e3, T["nor"], wts, 1e-7)
    jst = jb.advance(jctx, J["UL"] * 1.01, J["UL"], jmix.primitives(J["UL"]),
                     J["grad"] * 1e3, J["nor"], jnp.asarray(wts.numpy()),
                     1e-7)
    _cols_close(st, jst)
    f, jf = _bc_flux(bc, jb, ctx, jctx, d, state=st)
    _cols_close(f, jf)


# ------------------------------------------------------- the deck


def test_argon_inflow_outflow(tmp_path):
    """tests/test_plasma_solver.py::test_argon_inflow_outflow on the port
    (the inlet carries the active species' mass fraction; 4 steps, finite,
    the temperature and ion density in range), and its 4 steps from
    tps_tpu's initial state against tps_tpu's."""
    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", INOUT, "--device",
                                 "cpu"])
    tps.parse_input()
    tps.config.outdir = str(tmp_path)
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    s = tps.solver
    mix = s.mixture
    inlets = [b.bc for b in s.bc_slices if isinstance(b.bc, pbc.InletBC)]
    assert len(inlets) == 1
    assert inlets[0].input_state == (1.6, 10.0, 0.0, 1.0e-7)
    jtps = JTps()
    jtps.input_file = INOUT
    jtps.parse_input()
    jtps.config.outdir = str(tmp_path / "jax")
    jtps.choose_devices()
    jtps.choose_solver()
    jtps.initialize()
    _cols_close(s.state_global(), jtps.solver.U, TOL)
    s.set_state_global(np.asarray(jtps.solver.U))
    s.set_time(float(jtps.solver.time), float(jtps.solver.dt))
    tps.solve()
    jtps.solve()
    assert s.iter == 4 and s.check_nan() == 0
    Up = mix.primitives(s.U).numpy()
    assert Up[..., 0].min() > 0
    assert 200 < Up[..., mix.i_th].mean() < 5000
    n_ion = Up[..., mix.nvel + 2]
    n_ref = 1.0e-7 * 1.6 / (39.948e-3 - 5.4858e-07)
    assert 0.5 * n_ref < n_ion.mean() < 2.0 * n_ref
    # the y momentum of the x channel is 0 up to rounding: held to rho u
    U, jU = s.state_global(), np.asarray(jtps.solver.U)
    for q in range(U.shape[-1]):
        scale = max(np.abs(jU[..., q]).max(), 16.0 if q == 2 else 0.0)
        err = np.abs(U[..., q] - jU[..., q]).max() / scale
        assert err <= DECK_TOL, (q, err)
    assert abs(float(s.time) - float(jtps.solver.time)) <= 1e-12 * float(
        jtps.solver.time)
