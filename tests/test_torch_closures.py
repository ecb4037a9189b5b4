"""The compressible closures of tps_torch == the JAX package's, on the CPU
in f64, module by module.

1. Roe on DryAir 2-D and 3-D and on the argon ternary: against the JAX
   function on the same seeded states; consistency F(U, U, n) = F(U) . n,
   conservation F(a, b, n) = -F(b, a, -n), and a zero normal giving a
   zero flux, not NaN.  The JAX package's Roe raises on any mixture (it
   subtracts the Euler rows' dissipation from the mean over every
   equation, and its unused `up` cannot broadcast); the port's takes the
   mean's Euler rows.  So the ternary's Euler rows are held to the JAX Roe
   over the mixture's pressure and gamma with the convective flux cut to
   those rows, and its scalar rows to the JAX formula in numpy.
2. Smagorinsky, Wale and Sigma on 2-D and 3-D gradients (Sigma 1e-11:
   eigvalsh sums in another order), WALE's zero in pure shear and
   Sigma's zero in 2-D.
3. PlanarViscousSponge.
4. The wall-distance tables of the solver bit for bit.
5. MixingLengthTransport, planar and with the swirl strain.
6. Fluxes.viscous with each closure on DryAir and on the ternary.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tps_torch.config.ini import IniInput  # noqa: E402
from tps_torch.dg.fluxes import Fluxes, PlanarViscousSponge  # noqa: E402
from tps_torch.dg.riemann import Roe  # noqa: E402
from tps_torch.dg import sgs  # noqa: E402
from tps_torch.physics.gas import DryAir  # noqa: E402
from tps_torch.physics.plasma_config import build_plasma  # noqa: E402
from tps_torch.physics.transport import (DryAirTransport,  # noqa: E402
                                         MixingLengthTransport)
from tps_tpu.config.ini import IniInput as JIniInput  # noqa: E402
from tps_tpu.dg import sgs as jsgs  # noqa: E402
from tps_tpu.dg.fluxes import Fluxes as JFluxes  # noqa: E402
from tps_tpu.dg.fluxes import PlanarViscousSponge as JSponge  # noqa: E402
from tps_tpu.dg.riemann import Roe as JRoe  # noqa: E402
from tps_tpu.physics.gas import DryAir as JDryAir  # noqa: E402
from tps_tpu.physics.plasma_config import build_plasma as jbuild_plasma  # noqa: E402
from tps_tpu.physics.transport import DryAirTransport as JDryAirTransport  # noqa: E402
from tps_tpu.physics.transport import MixingLengthTransport as JMixingLength  # noqa: E402

from test_torch_axisym_dg import ARGON, _gradient, _primitives  # noqa: E402

TOL = 1e-12
SIGMA_TOL = 1e-11


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
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _cols_rel(a, b):
    a, b = _np(a), _np(b)
    return max(_rel(a[..., q], b[..., q]) for q in range(b.shape[-1]))


_PLASMA = {}


def _argon(nvel):
    """(port, JAX) plasma setups of argon_minimal.ini in 2-D."""
    if nvel not in _PLASMA:
        _PLASMA[nvel] = (build_plasma(IniInput.read(ARGON), 2, nvel),
                         jbuild_plasma(JIniInput.read(ARGON), 2, nvel))
    return _PLASMA[nvel]


def _physics(kind, dim, nvel=None):
    """((mixture, transport), (JAX mixture, transport)): DryAir with
    Sutherland transport and a bulk viscosity, or the argon ternary."""
    nvel = dim if nvel is None else nvel
    if kind == "dry_air":
        mix, jmix = DryAir(dim=dim, nvel=nvel), JDryAir(dim=dim, nvel=nvel)
        return ((mix, DryAirTransport(mix.gas_constant,
                                      mix.specific_heat_ratio,
                                      bulk_visc_mult=0.3)),
                (jmix, JDryAirTransport(jmix.gas_constant,
                                        jmix.specific_heat_ratio,
                                        bulk_visc_mult=0.3)))
    pl, jpl = _argon(nvel)
    return (pl.mixture, pl.transport), (jpl.mixture, jpl.transport)


def _dry_states(rng, n, dim):
    """Conserved DryAir states [n, dim+2]: rho ~ 1, |u| ~ 10, T ~ 300."""
    rho = rng.uniform(0.8, 1.6, n)
    vel = rng.uniform(-20.0, 20.0, (n, dim))
    T = rng.uniform(250.0, 350.0, n)
    rhoE = rho * (287.058 * T / 0.4 + 0.5 * np.sum(vel**2, -1))
    return np.concatenate([rho[:, None], rho[:, None] * vel, rhoE[:, None]], -1)


PLANAR = [0, 1, 2, 4, 5, 6]  # the swirl state's columns without u_t


def _argon_primitives(xyz, seed, nvel):
    """The argon ternary's perturbed primitives at xyz [..., 2]."""
    Up = _primitives("argon", _physics("argon", 2, 3)[0][0], xyz, seed)
    return Up if nvel == 3 else Up[..., PLANAR]


def _states(kind, dim, n, seed):
    """Conserved states [n, neq] of a case, numpy."""
    rng = np.random.default_rng(seed)
    if kind == "dry_air":
        return _dry_states(rng, n, dim)
    mix = _physics(kind, dim)[0][0]
    Up = _argon_primitives(rng.uniform(0.0, 0.01, (n, 2)), seed, 2)
    return mix.conservatives(torch.as_tensor(Up)).numpy()


def _grad(kind, dim, n, seed):
    """A primitive gradient [n, neq, dim] of realistic scale."""
    if kind == "argon":
        return _gradient("argon", (n,), seed)[:, PLANAR]
    rng = np.random.default_rng(seed)
    scale = np.asarray([10.0] + [1e3] * dim + [1e4])
    return rng.standard_normal((n, dim + 2, dim)) * scale[:, None]


# ---------------------------------------------------------------- 1. Roe


def _jax_roe(jfl, kind, dim):
    """The JAX Roe; on the ternary its Euler rows, over the mixture's
    pressure and gamma with the convective flux cut to those rows
    (module docstring)."""
    if kind == "dry_air":
        return JRoe(jfl)
    jmix = jfl.mixture
    shim_mix = types.SimpleNamespace(
        dim=dim, num_equations=dim + 2, pressure=jmix.pressure,
        specific_heat_ratio=jmix.specific_heat_ratio)
    shim = types.SimpleNamespace(
        mixture=shim_mix,
        convective=lambda U: jfl.convective(U)[..., :dim + 2, :])
    return JRoe(shim)


def _scalar_rows(U1, U2, nor, dim):
    """The JAX Roe's upwinded scalars (tps_tpu/dg/riemann.py:106-116) in
    numpy: the mean of rhoY u.n minus |Roe u.n| times the jump, times
    |n|."""
    normag = np.linalg.norm(nor, axis=-1)
    n = nor / normag[:, None]
    s1, s2 = np.sqrt(U1[:, 0]), np.sqrt(U2[:, 0])
    vel = (U1[:, 1:1 + dim] / s1[:, None]
           + U2[:, 1:1 + dim] / s2[:, None]) / (s1 + s2)[:, None]
    qk = np.sum(vel * n, -1)
    qk1 = np.sum(U1[:, 1:1 + dim] / U1[:, :1] * n, -1)
    qk2 = np.sum(U2[:, 1:1 + dim] / U2[:, :1] * n, -1)
    a, b = U1[:, dim + 2:], U2[:, dim + 2:]
    fs = 0.5 * (qk1[:, None] * a + qk2[:, None] * b) - 0.5 * np.abs(
        qk)[:, None] * (b - a)
    return fs * normag[:, None]


@pytest.mark.parametrize("kind,dim", [("dry_air", 2), ("dry_air", 3),
                                      ("argon", 2)])
def test_roe_consistent_conservative_and_zero_normal(kind, dim):
    (mix, _), _ = _physics(kind, dim)
    fl = Fluxes(mixture=mix)
    roe = Roe(fl)
    U1 = torch.as_tensor(_states(kind, dim, 32, 4))
    U2 = torch.as_tensor(_states(kind, dim, 32, 5))
    n = torch.as_tensor(np.random.default_rng(6).standard_normal((32, dim)))
    exact = torch.einsum("...ed,...d->...e", fl.convective(U1), n)
    # the two-temperature electron energy is upwinded as a scalar (no
    # p_e work), so consistency holds on the other rows there
    rows = slice(None) if kind == "dry_air" else slice(0, mix.num_equations
                                                      - 1)
    assert _rel(roe(U1, U1, n)[:, rows], exact[:, rows]) <= TOL
    assert _rel(roe(U1, U2, n), -roe(U2, U1, -n)) <= TOL
    # a zero normal: the flux is scaled by the floored norm, finfo.tiny
    zero = roe(U1, U2, torch.zeros_like(n))
    assert bool(torch.isfinite(zero).all())
    assert float(zero.abs().max()) < 1e-200


# ---------------------------------------------------------------- 2. SGS


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("model", ["Smagorinsky", "Wale", "Sigma"])
def test_sgs_models_match_jax(model, dim):
    (mix, _), (jmix, _) = _physics("dry_air", dim)
    U = _states("dry_air", dim, 96, 7).reshape(8, 12, dim + 2)
    G = _grad("dry_air", dim, 96, 8).reshape(8, 12, dim + 2, dim)
    delta = np.random.default_rng(9).uniform(0.01, 0.1, (8, 1))
    m = getattr(sgs, model)(mixture=mix, floor=0.005)
    jm = getattr(jsgs, model)(mixture=jmix, floor=0.005)
    got = m(torch.as_tensor(U), torch.as_tensor(G), torch.as_tensor(delta))
    want = jax.jit(jm)(jnp.asarray(U), jnp.asarray(G), jnp.asarray(delta))
    assert got.shape == (8, 12)
    assert _rel(got, want) <= (SIGMA_TOL if model == "Sigma" else TOL)
    if model == "Sigma" and dim == 2:
        assert float(got.abs().max()) == 0.0
    else:
        assert float(got.min()) >= 0.0 and float(got.max()) > 0.0
    # delta at face points [ne, 1, 1] (the face sweep's) gives the same
    face = m(torch.as_tensor(U), torch.as_tensor(G),
             torch.as_tensor(delta[:, :, None]))
    assert torch.equal(face, got)


def test_sigma_closed_form_eigenvalues_match_eigvalsh():
    """The card's Sigma (sgs._sym3_eigenvalues, the face kernel's closed
    form) against torch.linalg.eigvalsh on g^T g, descending: 1e-12 of
    the largest on full-rank and isotropic gradients, zero gradients
    exact; on rank-1 gradients (a double root of the cubic, where the
    arccos of the rounded r moves the roots by sqrt(eps) of the largest)
    within 1e-7."""
    rng = np.random.default_rng(21)
    g = rng.standard_normal((256, 3, 3)) * 1e3
    g[:8] = 0.0
    g[8:16] = np.einsum("ni,nj->nij", rng.standard_normal((8, 3)),
                        rng.standard_normal((8, 3)))  # rank 1
    g[16:24] = np.eye(3) * rng.uniform(1.0, 10.0, (8, 1, 1))
    G = torch.as_tensor(g)
    Q = torch.einsum("...ki,...kj->...ij", G, G)
    got = sgs._sym3_eigenvalues(Q)
    want = torch.flip(torch.linalg.eigvalsh(Q), dims=(-1,))
    scale = torch.clamp(want[:, 0], min=1e-300)[:, None]
    err = ((got - want).abs() / scale).amax(dim=-1)
    assert float(err[24:].max()) <= TOL
    assert float(err[8:16].max()) <= 1e-7
    assert bool(torch.all(got[:8] == 0.0))
    assert float(err[16:24].max()) <= TOL


def test_wale_is_zero_in_pure_shear():
    (mix, _), (jmix, _) = _physics("dry_air", 3)
    U = torch.as_tensor(_states("dry_air", 3, 16, 10))
    G = torch.zeros(16, 5, 3)
    G[:, 1, 1] = torch.linspace(10.0, 1e3, 16)  # du/dy only
    delta = torch.full((16,), 0.05)
    got = sgs.Wale(mixture=mix)(U, G, delta)
    want = jsgs.Wale(mixture=jmix)(jnp.asarray(U.numpy()),
                                   jnp.asarray(G.numpy()),
                                   jnp.asarray(delta.numpy()))
    assert float(got.abs().max()) <= 1e-12 * float(U[:, 0].max()) * 0.05**2
    assert _rel(got, want) <= TOL or float(np.abs(want).max()) <= 1e-20


# ------------------------------------------------------------ 3. sponge


@pytest.mark.parametrize("dim", [2, 3])
def test_planar_viscous_sponge_matches_jax(dim):
    xyz = np.random.default_rng(11).uniform(0.0, 1.0, (40, 7, dim))
    kw = dict(point=(0.1, 0.7, 0.2), normal=(0.0, 1.0, 0.0), width=0.05,
              ratio=10.0)
    got = PlanarViscousSponge(**kw)(torch.as_tensor(xyz))
    want = JSponge(**kw)(jnp.asarray(xyz))
    assert _rel(got, want) <= TOL
    assert 1.0 <= float(got.min()) and float(got.max()) <= 10.0
    assert float(got.max()) > 9.0 and float(got.min()) < 1.01


# ------------------------------------------------------- 5. mixing length


@pytest.mark.parametrize("kind,nvel", [("dry_air", 2), ("dry_air", 3),
                                       ("argon", 3)])
def test_mixing_length_matches_jax(kind, nvel):
    (mix, tr), (jmix, jtr) = _physics(kind, 2, nvel)
    rng = np.random.default_rng(12)
    xyz = rng.uniform(0.0, 0.01, (60, 2))
    xyz[:6, 0] = 0.0  # on the axis
    if kind == "argon":
        Up = _argon_primitives(xyz, 13, nvel)
    else:
        Up = _primitives(kind, _physics(kind, 2, 3)[0][0], xyz, 13)
    G = _gradient(kind, (60,), 14)
    if nvel == 2:
        Up, G = Up[..., [0, 1, 2, 4]], G[:, [0, 1, 2, 4]]
    dist = rng.uniform(0.0, 0.02, 60)
    dist[-4:] = np.inf  # no wall
    ml = MixingLengthTransport(molecular=tr, max_mixing_length=0.004,
                               Prt=0.9, bulk_mult=0.2)
    jml = JMixingLength(molecular=jtr, max_mixing_length=0.004, Prt=0.9,
                        bulk_mult=0.2)
    U = mix.conservatives(torch.as_tensor(Up))
    radius = xyz[:, 0] if nvel == 3 else None
    got = ml.flux_properties(mix, U, torch.as_tensor(Up), torch.as_tensor(G),
                             distance=torch.as_tensor(dist),
                             radius=(None if radius is None
                                     else torch.as_tensor(radius)))

    def theirs(U, Up, G, dist, r):
        p = jml.flux_properties(jmix, U, Up, G, distance=dist, radius=r)
        return {k: v for k, v in p.items() if v is not None}

    # the argon transport eagerly: XLA's fusion reorders its cancelling
    # electron conductivity (the port matches the eager form)
    theirs = theirs if kind == "argon" else jax.jit(theirs)

    want = theirs(jnp.asarray(U.numpy()), jnp.asarray(Up), jnp.asarray(G),
                  jnp.asarray(dist),
                  None if radius is None else jnp.asarray(radius))
    for key in ("visc", "bulk_visc", "kappa", "kappa_e"):
        assert _rel(got[key], want[key]) <= TOL, key
    mol = tr.flux_properties(mix, U, torch.as_tensor(Up), torch.as_tensor(G))
    assert bool(torch.all(got["visc"] > mol["visc"]))
    # no distance (the geometric source, the boundary faces): molecular
    plain = ml.flux_properties(mix, U, torch.as_tensor(Up),
                               torch.as_tensor(G))
    assert torch.equal(plain["visc"], mol["visc"])


# ------------------------------------------------ 6. the viscous flux


CLOSURES = ("smagorinsky", "sigma", "sponge", "mixing", "all")


def _closed_fluxes(P, mix, tr, closure, axisymmetric=False):
    """Fluxes with one closure or all of them (P: the package's
    namespace)."""
    on = (lambda c: closure in (c, "all"))
    if on("mixing"):
        tr = P["ML"](molecular=tr, max_mixing_length=0.003, Prt=0.9,
                     bulk_mult=0.1)
    model = None
    if on("smagorinsky"):
        model = P["sgs"].Smagorinsky(mixture=mix)
    if on("sigma") and closure != "all":
        model = P["sgs"].Sigma(mixture=mix)
    sponge = (P["Sponge"](point=(0.0, 0.006, 0.0), normal=(0.0, 1.0, 0.0),
                          width=0.001, ratio=10.0) if on("sponge") else None)
    return P["Fluxes"](mixture=mix, transport=tr, axisymmetric=axisymmetric,
                       sgs_model=model, visc_sponge=sponge)


PORT = {"ML": MixingLengthTransport, "sgs": sgs, "Sponge": PlanarViscousSponge,
        "Fluxes": Fluxes}
JAX = {"ML": JMixingLength, "sgs": jsgs, "Sponge": JSponge, "Fluxes": JFluxes}


@pytest.mark.parametrize("closure", CLOSURES)
@pytest.mark.parametrize("kind,dim,nvel", [("dry_air", 2, 2),
                                           ("dry_air", 3, 3),
                                           ("argon", 2, 2), ("argon", 2, 3)])
def test_viscous_flux_with_closures_matches_jax(kind, dim, nvel, closure):
    (mix, tr), (jmix, jtr) = _physics(kind, dim, nvel)
    axi = nvel != dim
    fl = _closed_fluxes(PORT, mix, tr, closure, axi)
    jfl = _closed_fluxes(JAX, jmix, jtr, closure, axi)
    rng = np.random.default_rng(15)
    n = 48
    xyz = rng.uniform(0.0, 0.01, (n, dim))
    if kind == "argon":
        Up = _argon_primitives(xyz, 16, nvel)
        G = _gradient("argon", (n,), 17)
        if nvel == 2:
            G = G[:, PLANAR]
        U = mix.conservatives(torch.as_tensor(Up)).numpy()
    else:
        U = _states("dry_air", dim, n, 16)
        G = _grad("dry_air", dim, n, 17)
        if closure == "sigma" and dim == 3:
            G[..., 1:4, :] *= 10.0
    delta = rng.uniform(0.001, 0.003, (n, 1))[:, 0]
    dist = rng.uniform(0.0, 0.01, n)
    Ut = torch.as_tensor(U)
    got = fl.viscous(Ut, mix.primitives(Ut), torch.as_tensor(G),
                     xyz=torch.as_tensor(xyz), delta=torch.as_tensor(delta),
                     distance=torch.as_tensor(dist))

    def theirs(U, G, xyz, delta, dist):
        return jfl.viscous(U, jmix.primitives(U), G, xyz=xyz, delta=delta,
                           distance=dist)

    theirs = theirs if kind == "argon" else jax.jit(theirs)

    want = theirs(jnp.asarray(U), jnp.asarray(G), jnp.asarray(xyz),
                  jnp.asarray(delta), jnp.asarray(dist))
    base = Fluxes(mixture=mix, transport=tr, axisymmetric=axi).viscous(
        Ut, mix.primitives(Ut), torch.as_tensor(G), xyz=torch.as_tensor(xyz))
    tol = SIGMA_TOL if closure == "sigma" else TOL
    for q in range(1, mix.num_equations):
        assert _rel(got[:, q], want[:, q]) <= tol, q
    moved = max(_rel(got[:, q], base[:, q])
                for q in range(1, mix.num_equations))
    # Sigma vanishes in 2-D; elsewhere each closure changes the flux
    assert moved == 0.0 if (closure == "sigma" and dim == 2) else moved > 1e-6
