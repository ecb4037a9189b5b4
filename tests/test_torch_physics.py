"""Pointwise physics of tps_torch == the JAX package's, in f64.

DryAir, the transport models, Rusanov and the DryAir flux branch on the
same random states (numpy, seeded).  Both sides do the same arithmetic in
f64, so the bar is rounding: rtol 1e-13.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tps_torch.dg.fluxes import Fluxes, PlanarViscousSponge  # noqa: E402
from tps_torch.dg.sgs import Smagorinsky  # noqa: E402
from tps_torch.dg.riemann import Rusanov  # noqa: E402
from tps_torch.physics.gas import DryAir  # noqa: E402
from tps_torch.physics.transport import ConstantTransport, DryAirTransport  # noqa: E402
from tps_tpu.dg.fluxes import Fluxes as JFluxes  # noqa: E402
from tps_tpu.dg.riemann import Rusanov as JRusanov  # noqa: E402
from tps_tpu.physics.gas import DryAir as JDryAir  # noqa: E402
from tps_tpu.physics.transport import ConstantTransport as JConstantTransport  # noqa: E402
from tps_tpu.physics.transport import DryAirTransport as JDryAirTransport  # noqa: E402

RTOL = 1e-13


def _states(rng, n, dim):
    """Physical conserved states [n, dim+2]: rho ~ 1, |u| ~ 10, T ~ 300."""
    rho = rng.uniform(0.8, 1.6, n)
    vel = rng.uniform(-20.0, 20.0, (n, dim))
    T = rng.uniform(250.0, 350.0, n)
    R, g = 287.058, 1.4
    rhoE = rho * (R * T / (g - 1.0) + 0.5 * np.sum(vel**2, -1))
    return np.concatenate([rho[:, None], rho[:, None] * vel, rhoE[:, None]], -1)


def _close(a, b, rtol=RTOL):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol,
                               atol=rtol * np.max(np.abs(np.asarray(b))))


@pytest.mark.parametrize("dim", [2, 3])
def test_dry_air(dim):
    rng = np.random.default_rng(11 + dim)
    U = _states(rng, 64, dim)
    mix, jmix = DryAir(dim=dim, nvel=dim), JDryAir(dim=dim, nvel=dim)
    Ut, Uj = torch.as_tensor(U), jnp.asarray(U)
    for name in ("pressure", "temperature", "primitives", "max_char_speed"):
        _close(getattr(mix, name)(Ut), getattr(jmix, name)(Uj))
    Up = np.array(jmix.primitives(Uj))
    _close(mix.conservatives(torch.as_tensor(Up)),
           jmix.conservatives(jnp.asarray(Up)))
    assert mix.num_equations == jmix.num_equations == dim + 2


@pytest.mark.parametrize("dim", [2, 3])
def test_transport(dim):
    rng = np.random.default_rng(23 + dim)
    U = _states(rng, 64, dim)
    grad = rng.normal(size=(64, dim + 2, dim))
    mix, jmix = DryAir(dim=dim, nvel=dim), JDryAir(dim=dim, nvel=dim)
    Up = np.array(jmix.primitives(jnp.asarray(U)))
    models = [
        (DryAirTransport(287.058, 1.4, visc_mult=1.3, bulk_visc_mult=0.4),
         JDryAirTransport(287.058, 1.4, visc_mult=1.3, bulk_visc_mult=0.4)),
        (ConstantTransport(1.8e-5, 2e-6, 0.026),
         JConstantTransport(1.8e-5, 2e-6, 0.026)),
    ]
    for tr, jtr in models:
        p = tr.flux_properties(mix, torch.as_tensor(U), torch.as_tensor(Up),
                               torch.as_tensor(grad))
        q = jtr.flux_properties(jmix, jnp.asarray(U), jnp.asarray(Up),
                                jnp.asarray(grad))
        for k in ("visc", "bulk_visc", "kappa", "kappa_e"):
            _close(p[k], q[k])
        assert p["diff_vel"] is None and q["diff_vel"] is None


@pytest.mark.parametrize("dim", [2, 3])
def test_rusanov(dim):
    rng = np.random.default_rng(37 + dim)
    U1, U2 = _states(rng, 48, dim), _states(rng, 48, dim)
    # scaled (non-unit) normals, as the slot normals carry the face area
    nor = rng.normal(size=(48, dim)) * rng.uniform(0.1, 3.0, (48, 1))
    mix, jmix = DryAir(dim=dim, nvel=dim), JDryAir(dim=dim, nvel=dim)
    fl = Fluxes(mixture=mix, eq_system="euler")
    jfl = JFluxes(mixture=jmix, eq_system="euler")
    _close(Rusanov(fl)(torch.as_tensor(U1), torch.as_tensor(U2),
                       torch.as_tensor(nor)),
           JRusanov(jfl)(jnp.asarray(U1), jnp.asarray(U2), jnp.asarray(nor)))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("eq_system", ["euler", "navier-stokes"])
def test_fluxes(dim, eq_system):
    rng = np.random.default_rng(53 + dim)
    U = _states(rng, 64, dim)
    grad = rng.normal(scale=50.0, size=(64, dim + 2, dim))
    mix, jmix = DryAir(dim=dim, nvel=dim), JDryAir(dim=dim, nvel=dim)
    tr = jtr = None
    if eq_system != "euler":
        tr = DryAirTransport(287.058, 1.4, bulk_visc_mult=0.5)
        jtr = JDryAirTransport(287.058, 1.4, bulk_visc_mult=0.5)
    fl = Fluxes(mixture=mix, transport=tr, eq_system=eq_system)
    jfl = JFluxes(mixture=jmix, transport=jtr, eq_system=eq_system)
    Ut, Uj = torch.as_tensor(U), jnp.asarray(U)
    Up_t, Up_j = mix.primitives(Ut), jmix.primitives(Uj)
    gt, gj = torch.as_tensor(grad), jnp.asarray(grad)
    _close(fl.convective(Ut), jfl.convective(Uj))
    _close(fl.viscous(Ut, Up_t, gt), jfl.viscous(Uj, Up_j, gj))
    _close(fl.total_at_dofs(Ut, Up_t, gt, None, None),
           jfl.total_at_dofs(Uj, Up_j, gj, None, None))


def test_unported_branches_raise():
    mix = DryAir(dim=3, nvel=3)
    # the SGS models and the viscous sponge are ported (dg/sgs.py,
    # dg/fluxes.py::PlanarViscousSponge; tests/test_torch_closures.py)
    Fluxes(mixture=mix, sgs_model=Smagorinsky(mixture=mix),
           visc_sponge=PlanarViscousSponge(point=(0.0, 0.0, 0.0),
                                           normal=(1.0, 0.0, 0.0),
                                           width=0.1, ratio=10.0))
    # the passive-scalar rows are ported as a module (held to the JAX
    # package's in tests/test_torch_forcing.py); the solver refuses a deck
    # with them (ROADMAP C, tests/test_torch_forcing_decks.py)
    passive = DryAir(dim=3, nvel=3, n_passive=1)
    for eq in ("ns-passive", "navier-stokes"):
        assert Fluxes(mixture=passive, eq_system=eq).neq == 6
    with pytest.raises(ValueError, match="unknown equation system"):
        Fluxes(mixture=mix, eq_system="ns-reacting")
