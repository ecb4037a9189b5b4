"""The plasma modules of tps_torch == the JAX package's, on the CPU.

The shipped argon deck's mixture (tests/inputs/argon_minimal.ini: Ar+, E,
Ar; ambipolar, two temperatures, argon_minimal transport with the
third-order electron conductivity, one Arrhenius reaction with detailed
balance) is built by both packages' build_plasma.  The same numpy-seeded
states (Te != Th, an ion fraction from 1e-7 to 1e-2) and gradients go
through tps_tpu (f64) and tps_torch (f64): collision integrals on a
300..30,000 K grid, PerfectMixture, ArgonMinimalTransport, Chemistry,
SourceTerm, the mixture Fluxes and Rusanov, and the plain face sweep on
the argon 6x6 p=1 tables against the JAX package's slot-path face flux.
Bar: 1e-12 of max|ref| (TOL), unless a test states a wider one and why.

Also the kernel's side on the CPU: the face-sweep gate and the packed
constants (csrc/dg_mixture.cuh::MixPhys) and, in tests/test_torch_faces.py
style, the kernel's decomposition (tiles, traces through the combos,
NEQ = 6 channels of k = 18) replayed in numpy with the plain pointwise
physics.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tps_torch.config.ini import IniInput  # noqa: E402
from tps_torch.dg import cuda_faces  # noqa: E402
from tps_torch.dg.cuda_faces import (build_face_sweep,  # noqa: E402
                                     face_sweep_supported, mixture_phys)
from tps_torch.dg.discretization import build_tables  # noqa: E402
from tps_torch.dg.fluxes import Fluxes  # noqa: E402
from tps_torch.dg.operators import (_clip_species, dg_gradient,  # noqa: E402
                                    face_sweep_plain)
from tps_torch.dg.rhs import RHSContext  # noqa: E402
from tps_torch.dg.riemann import Rusanov  # noqa: E402
from tps_torch.dg.source_term import SourceTerm  # noqa: E402
from tps_torch.mesh.generators import box_2d, box_3d  # noqa: E402
from tps_torch.physics import collision_integrals as ci  # noqa: E402
from tps_torch.physics.plasma_config import build_plasma  # noqa: E402
from tps_torch.physics.transport import ConstantTransport  # noqa: E402
from tps_tpu.config.ini import IniInput as JIniInput  # noqa: E402
from tps_tpu.dg import operators as jops  # noqa: E402
from tps_tpu.dg.discretization import build_tables as jbuild_tables  # noqa: E402
from tps_tpu.dg.fluxes import Fluxes as JFluxes  # noqa: E402
from tps_tpu.dg.riemann import Rusanov as JRusanov  # noqa: E402
from tps_tpu.dg.rhs import _clip_species as jclip  # noqa: E402
from tps_tpu.dg.source_term import SourceTerm as JSourceTerm  # noqa: E402
from tps_tpu.mesh.generators import box_2d as jbox_2d  # noqa: E402
from tps_tpu.physics import collision_integrals as jci  # noqa: E402
from tps_tpu.physics.plasma_config import build_plasma as jbuild_plasma  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
DECK = os.path.join(HERE, "inputs", "argon_minimal.ini")
CSRC = os.path.join(os.path.dirname(HERE), "tps_torch", "csrc")
TOL = 1e-12
GLL = dict(basis="gauss-lobatto", quad_rule="gauss-lobatto")


def _rel_close(a, ref, tol=TOL):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    scale = np.max(np.abs(ref))
    assert scale > 0 and np.all(np.isfinite(a))
    err = np.max(np.abs(a - ref)) / scale
    assert err <= tol, err


def _plasmas(dim=2):
    """(port setup, JAX setup) of the shipped argon deck."""
    port = build_plasma(IniInput.read(DECK), dim, dim)
    ref = jbuild_plasma(JIniInput.read(DECK), dim, dim)
    return port, ref


def _primitives(mix, n, seed, dim=2):
    """Primitive states [n, neq]: rho 1.2..2, |u| ~ 30, Th 300..3,000,
    Te 300..30,000, the ion number density 1e-7..1e-2 of rho/mw."""
    rng = np.random.default_rng(seed)
    Up = np.zeros((n, mix.num_equations))
    Up[:, 0] = rng.uniform(1.2, 2.0, n)
    Up[:, 1:1 + dim] = rng.uniform(-30.0, 30.0, (n, dim))
    Up[:, dim + 1] = rng.uniform(300.0, 3000.0, n)
    Up[:, dim + 2] = Up[:, 0] / mix.mw[0] * 10 ** rng.uniform(-7, -2, n)
    Up[:, dim + 3] = rng.uniform(300.0, 30000.0, n)
    return Up


def _state(seed, n=64, dim=2):
    """(port, JAX setups, U [n, neq] from the JAX conservatives, its
    primitive gradients [n, neq, dim], scaled to the state)."""
    port, ref = _plasmas(dim)
    Up = _primitives(ref.mixture, n, seed, dim)
    U = np.array(ref.mixture.conservatives(jnp.asarray(Up)))
    rng = np.random.default_rng(seed + 100)
    G = rng.standard_normal(Up.shape + (dim,)) * np.abs(Up)[..., None] * 50.0
    return port, ref, U, G


# ---------------------------------------------------------------- modules


def test_collision_integrals_match_jax():
    T = np.geomspace(300.0, 30000.0, 64)
    names = ([f"{k}{lr}" for k in ("att", "rep")
              for lr in ("11", "12", "13", "14", "15", "22", "23", "24")]
             + ["ArAr11", "ArAr22", "ArAr1P11"]
             + [f"eAr1{r}" for r in range(1, 6)]
             + ["NiNi11", "NiNi22", "NiNi1P11", "N2N211", "N2N222",
                "N2N21P11", "N2Ni1P11", "NiN21P11", "N2Ni11", "N2Ni22"]
             + [f"eNi1{r}" for r in range(1, 6)]
             + [f"eN21{r}" for r in range(1, 6)])
    for name in names:
        # the screened fits take a nondimensional T; any positive grid
        x = T / 300.0 if name[:3] in ("att", "rep") else T
        _rel_close(getattr(ci, name)(torch.as_tensor(x)),
                   getattr(jci, name)(jnp.asarray(x)))


def test_plasma_setup_matches_jax():
    port, ref = _plasmas()
    assert port.species_names == ref.species_names == ["Ar.+1", "E", "Ar"]
    np.testing.assert_array_equal(port.input_to_mixture, ref.input_to_mixture)
    np.testing.assert_array_equal(port.initial_mass_fractions,
                                  ref.initial_mass_fractions)
    for f in ("mw", "charges", "formation_energy", "molar_cv_over_R",
              "ambipolar", "two_temperature"):
        assert getattr(port.mixture, f) == getattr(ref.mixture, f), f
    pc, rc = port.chemistry, ref.chemistry
    np.testing.assert_array_equal(pc.reactant_stoich, rc.reactant_stoich)
    np.testing.assert_array_equal(pc.product_stoich, rc.product_stoich)
    assert pc.equilibrium_params == rc.equilibrium_params
    assert pc.models[0] == type(pc.models[0])(**vars(rc.models[0]))
    assert port.mixture.num_equations == 6


def test_perfect_mixture_matches_jax():
    port, ref, U, G = _state(1)
    mix, jmix = port.mixture, ref.mixture
    Ut, Uj = torch.as_tensor(U), jnp.asarray(U)
    Up = mix.primitives(Ut)
    _rel_close(Up, jmix.primitives(Uj))
    _rel_close(mix.conservatives(Up), Ut)  # round trip
    _rel_close(mix.conservatives(Up), jmix.conservatives(jnp.asarray(Up)))
    _rel_close(mix.number_densities(Ut), jmix.number_densities(Uj))
    for a, b in zip(mix.temperatures(Ut), jmix.temperatures(Uj)):
        _rel_close(a, b)
    assert not np.allclose(*(np.asarray(t) for t in mix.temperatures(Ut)))
    for f in ("pressure", "electron_pressure", "max_char_speed",
              "speed_of_sound_from_conserved", "species_enthalpies"):
        _rel_close(getattr(mix, f)(Ut), getattr(jmix, f)(Uj))
    for a, b in zip(mix.species_primitives(Ut), jmix.species_primitives(Uj)):
        _rel_close(a, b)
    n_sp = mix.number_densities(Ut)
    Gt, Gj = torch.as_tensor(G), jnp.asarray(G)
    _rel_close(mix.mole_fraction_gradient(n_sp, Gt),
               jmix.mole_fraction_gradient(jnp.asarray(n_sp), Gj))
    _rel_close(mix.mass_fraction_gradient(Ut[:, 0], n_sp, Gt),
               jmix.mass_fraction_gradient(Uj[:, 0], jnp.asarray(n_sp), Gj))
    # the BC helpers (tests/test_torch_mixture_bc.py holds them on more
    # mixtures)
    _rel_close(mix.pressure_derivative(Gt[..., 0], Ut),
               jmix.pressure_derivative(Gj[..., 0], Uj))
    p = mix.pressure(Ut) * 1.1
    _rel_close(mix.modify_energy_for_pressure(Ut, p),
               jmix.modify_energy_for_pressure(Uj, jnp.asarray(p.numpy())))


@pytest.mark.parametrize("third_order", [True, False])
def test_argon_transport_matches_jax(third_order):
    import dataclasses

    port, ref, U, G = _state(2)
    tr = dataclasses.replace(
        port.transport, third_order_electron_thermal_conductivity=third_order)
    jtr = dataclasses.replace(
        ref.transport, third_order_electron_thermal_conductivity=third_order)
    Ut, Uj = torch.as_tensor(U), jnp.asarray(U)
    Up, Upj = port.mixture.primitives(Ut), ref.mixture.primitives(Uj)
    Gt, Gj = torch.as_tensor(G), jnp.asarray(G)
    p = tr.flux_properties(port.mixture, Ut, Up, Gt)
    jp = jtr.flux_properties(ref.mixture, Uj, Upj, Gj)
    for k in ("visc", "bulk_visc", "kappa", "kappa_e", "diff_vel",
              "diffusivity", "mobility", "n_sp"):
        if k == "bulk_visc":
            assert not torch.any(p[k]) and not jnp.any(jp[k])
            continue
        _rel_close(p[k], jp[k])
    s = tr.source_properties(Ut, Up, Gt)
    js = jtr.source_properties(Uj, Upj, Gj)
    for k in ("sigma", "mf_freq", "diff_vel", "mobility", "diffusivity"):
        _rel_close(s[k], js[k])
    _rel_close(tr.electric_conductivity(Ut, Up),
               jtr.electric_conductivity(Uj, Upj))


def test_chemistry_and_source_term_match_jax():
    port, ref, U, G = _state(3)
    mix, jmix = port.mixture, ref.mixture
    Ut, Uj = torch.as_tensor(U), jnp.asarray(U)
    n_sp = mix.number_densities(Ut)
    Th, Te = mix.temperatures(Ut)
    pr, cr = port.chemistry.source(n_sp, Th, Te)
    jpr, jcr = ref.chemistry.source(jnp.asarray(n_sp), jnp.asarray(Th),
                                    jnp.asarray(Te))
    _rel_close(pr, jpr)
    _rel_close(cr, jcr)
    # a clipped species and Th below the chemistry's minimum temperature
    U2 = U.copy()
    U2[:4, 4] *= -1.0
    Ut2, Uj2 = torch.as_tensor(U2), jnp.asarray(U2)
    src = SourceTerm(mixture=mix, transport=port.transport,
                     chemistry=port.chemistry)
    jsrc = JSourceTerm(mixture=jmix, transport=ref.transport,
                       chemistry=ref.chemistry)
    Up = mix.primitives(Ut2)
    for g in (torch.as_tensor(G), None):
        y = src(0.0, None, Ut2, Up, g)
        jy = jsrc(0.0, None, Uj2, jmix.primitives(Uj2),
                  None if g is None else jnp.asarray(G))
        # column by column: the species creation and the electron-energy
        # sinks are of different units
        for q in (4, 5):
            _rel_close(y[:, q], jy[:, q])
        assert not torch.any(y[:, :4])


def test_mixture_fluxes_and_rusanov_match_jax():
    port, ref, U, G = _state(4)
    mix, jmix = port.mixture, ref.mixture
    fl = Fluxes(mixture=mix, transport=port.transport)
    jfl = JFluxes(mixture=jmix, transport=ref.transport)
    Ut, Uj = torch.as_tensor(U), jnp.asarray(U)
    Gt, Gj = torch.as_tensor(G), jnp.asarray(G)
    # eager on both sides: XLA's fusions reorder the sums, which the
    # third-order electron conductivity's cancellation (l11 - l12^2/l22)
    # lifts to ~2e-10 of its column
    Fc, jFc = fl.convective(Ut), jfl.convective(Uj)
    Fv = fl.viscous(Ut, mix.primitives(Ut), Gt)
    jFv = jfl.viscous(Uj, jmix.primitives(Uj), Gj)
    for q in range(mix.num_equations):  # equations of different units
        _rel_close(Fc[:, q], jFc[:, q])
        if q:
            _rel_close(Fv[:, q], jFv[:, q])
    assert not torch.any(Fv[:, 0])
    nor = np.random.default_rng(5).standard_normal((U.shape[0], 2))
    f = Rusanov(fl)(Ut[::2], Ut[1::2], torch.as_tensor(nor[::2]))
    jf = jax.jit(JRusanov(jfl))(Uj[::2], Uj[1::2], jnp.asarray(nor[::2]))
    for q in range(mix.num_equations):
        _rel_close(f[:, q], jf[:, q])


# ---------------------------------------------------------------- face sweep


def _argon_case(n=(6, 6), order=1, gll=True, seed=6):
    """(port numpy tables, JAX tables, port ctx, JAX setups, X = [U | G])
    on a periodic box of the deck's extent: a perturbed state (the JAX
    conservatives of `_primitives` smoothed in space) and its DG
    gradient."""
    kw = GLL if gll else {}
    mesh = box_2d(*n, x1=0.01, y1=0.01, periodic_x=True, periodic_y=True)
    jmesh = jbox_2d(*n, x1=0.01, y1=0.01, periodic_x=True, periodic_y=True)
    tab_np, jtab_np = build_tables(mesh, order, **kw), jbuild_tables(jmesh, order, **kw)
    port, ref = _plasmas()
    fl = Fluxes(mixture=port.mixture, transport=port.transport)
    ctx = RHSContext(fluxes=fl, riemann=Rusanov(fl))
    xyz = tab_np.xyz_dof
    Up = _primitives(ref.mixture, xyz.shape[0] * xyz.shape[1], seed).reshape(
        xyz.shape[:2] + (6,))
    k = 2 * np.pi / 0.01
    wave = np.sin(k * xyz[..., 0]) * np.cos(k * xyz[..., 1])
    Up = Up.mean(axis=(0, 1)) * (1.0 + 0.05 * wave[..., None]
                                 + 0.01 * (Up / Up.mean(axis=(0, 1)) - 1.0))
    U = torch.as_tensor(np.array(ref.mixture.conservatives(jnp.asarray(Up))))
    tab = tab_np.to_torch(torch.float64, "cpu")
    G = dg_gradient(tab, port.mixture.primitives(U))
    X = torch.cat([U, G.reshape(tab_np.ne, tab_np.ndof, -1)], -1).contiguous()
    return tab_np, jtab_np, tab, ctx, ref, X


def _jax_face_flux(ref, jtab_np, X):
    """The JAX package's slot-path interior face flux (tps_tpu dg/rhs.py:
    143-178) on X = [U | G]: minus the sum over local faces of
    Btr_lf^T (Rusanov - mean viscous normal flux) x interior mask."""
    mix = ref.mixture
    jfl = JFluxes(mixture=mix, transport=ref.transport)
    riem = JRusanov(jfl)
    ne, ndof, _ = X.shape
    neq, nqf, dim = mix.num_equations, jtab_np.nqf, 2
    return np.asarray(jax.jit(lambda jtab, X: _jax_face_sum(
        jtab, X, mix, jfl, riem, ne, ndof, neq, nqf, dim, jtab_np.nlf))(
            jtab_np.to_jax(jnp.float64), jnp.asarray(X)))


def _jax_face_sum(jtab, X, mix, jfl, riem, ne, ndof, neq, nqf, dim, nlf):
    own, nbr = jops.perface_traces(jtab, X)
    z = jnp.zeros((ne, ndof, neq))
    for lf in range(nlf):
        U1 = jclip(mix, own[lf].reshape(ne, nqf, -1)[..., :neq])
        U2 = jclip(mix, nbr[lf].reshape(ne, nqf, -1)[..., :neq])
        g1 = own[lf].reshape(ne, nqf, -1)[..., neq:].reshape(ne, nqf, neq, dim)
        g2 = nbr[lf].reshape(ne, nqf, -1)[..., neq:].reshape(ne, nqf, neq, dim)
        nor = jtab.nor_wpf[lf].reshape(ne, nqf, dim)
        Fv = (jfl.viscous(U1, mix.primitives(U1), g1)
              + jfl.viscous(U2, mix.primitives(U2), g2))
        flux = riem(U1, U2, nor) - jnp.einsum("...ed,...d->...e", 0.5 * Fv, nor)
        flux = flux * jtab.interior_mask[:, lf, None, None]
        B = jtab.Btr[lf * nqf:(lf + 1) * nqf]
        z = z - jnp.einsum("sj,esq->ejq", B, flux)
    return z


def test_face_sweep_plain_matches_jax_on_the_argon_deck():
    tab_np, jtab_np, tab, ctx, ref, X = _argon_case()
    assert (tab_np.ndof, X.shape[-1]) == (4, 18)
    z = face_sweep_plain(ctx, tab, X)
    jz = _jax_face_flux(ref, jtab_np, X.numpy())
    for q in range(6):  # equations of different units
        _rel_close(z[..., q], jz[..., q], 1e-11)
    # the wrapper on CPU tensors is the plain version, no launch
    sweep = build_face_sweep(tab, ctx)
    cuda_faces.reset_launches()
    assert torch.equal(sweep(X), z)
    assert cuda_faces.launches["face_sweep"] == 0
    assert sweep.physics == "argon" and (sweep.neq, sweep.k) == (6, 18)


def test_face_sweep_gate_and_packed_constants():
    tab_np, _, tab, ctx, _, _ = _argon_case((2, 3))
    assert face_sweep_supported(tab_np, ctx)
    # constants: the length of csrc/dg_mixture.cuh::MixPhys, in double,
    # the mass products formed on the host
    with open(os.path.join(CSRC, "dg_mixture.cuh")) as f:
        text = f.read()
    expr = re.search(r"MIX_PHYS_LEN = ([^;]+);", text).group(1).replace(
        "\n", " ")
    assert len(mixture_phys(ctx)) == eval(expr) == 118
    assert re.search(r"MIX_FLAGS = (\d+);", text).group(1) == "14"
    phys = mixture_phys(ctx)
    assert phys[14:16] == [1.0, 1.0] and 0 < min(phys[23:31])
    # outside the gate: a transport without species diffusion, one
    # temperature
    import dataclasses

    for fl in (Fluxes(mixture=ctx.mixture, transport=ConstantTransport(
                   1e-5, 0.0, 0.02)),
               Fluxes(mixture=dataclasses.replace(ctx.mixture,
                                                  two_temperature=False),
                      transport=ctx.fluxes.transport)):
        assert not face_sweep_supported(
            tab_np, RHSContext(fluxes=fl, riemann=Rusanov(fl)))
    # Euler (no transport) and 3-D: their own instantiations
    fle = Fluxes(mixture=ctx.mixture, eq_system="euler")
    ctxe = RHSContext(fluxes=fle, riemann=Rusanov(fle))
    assert face_sweep_supported(tab_np, ctxe)
    assert cuda_faces.variant(ctxe, 2) == "argon_euler"
    port3 = _plasmas(3)[0]
    fl3 = Fluxes(mixture=port3.mixture, transport=port3.transport)
    ctx3 = RHSContext(fluxes=fl3, riemann=Rusanov(fl3))
    tab3 = build_tables(box_3d(2, 2, 2, periodic=(True, True, True)), 1)
    assert face_sweep_supported(tab3, ctx3)
    assert cuda_faces.variant(ctx3, 3) == "argon_3d"


def _emulate_argon(sw, ctx, X):
    """csrc/face_sweep.cu's decomposition on the mixture, in numpy, from the
    wrapper's words (tests/test_torch_faces.py::_emulate with the plain
    pointwise physics): tiles of the kernel's plan, the padded last tile,
    the neighbour's trace through its combo's face block with its points
    put in place, each face's products over the nodes it touches, the
    strided normals, the mask and the sign."""
    X = np.asarray(X, np.float64)
    ne, ndof, k = X.shape
    nqf, nlf, nc, dim, neq = sw.nqf, sw.nlf, sw.n_combo, sw.dim, sw.neq
    Bc = sw.Btr_or.double().numpy().reshape(nc, nqf, ndof)
    cface, cperm = sw.combo_face.numpy(), sw.combo_perm.numpy()
    nbr = sw.nbr_row.numpy().astype(np.int64)
    nor = sw.nor.double().numpy().reshape(-1)
    mask = sw.mask.double().numpy()
    E = cuda_faces.plan(ndof, nqf, nlf, k, neq, sw.Btr_or.dtype)[0]
    nt = -(-ne // E)
    support = [np.flatnonzero((Bc[lf] != 0).any(0)) for lf in range(nlf)]
    s, d = np.arange(nqf), np.arange(dim)
    mix = ctx.mixture
    Y = np.zeros((ne, ndof, neq))
    for t0 in range(0, nt * E, E):
        els = np.arange(t0, min(t0 + E, ne))
        for lf in range(nlf):
            sup = support[lf]
            to = np.einsum("sk,ekq->esq", Bc[lf][:, sup], X[els][:, sup])
            en, c = np.divmod(nbr[els, lf], nc)
            tn = np.zeros_like(to)
            for i, (ee, cc) in enumerate(zip(en, c)):
                f = cface[cc]
                tn[i, cperm[cc]] = Bc[f][:, support[f]] @ X[ee][support[f]]
            n = nor[lf * sw.nor_lf + els[:, None, None] * sw.nor_e
                    + s[None, :, None] * dim + d[None, None, :]]
            tt = [torch.as_tensor(a) for a in (to, tn)]
            U1, U2 = (_clip_species(mix, a[..., :neq]) for a in tt)
            g1, g2 = (a[..., neq:].reshape(len(els), nqf, neq, dim) for a in tt)
            nt_ = torch.as_tensor(n)
            flux = ctx.riemann(U1, U2, nt_)
            Fv = (ctx.fluxes.viscous(U1, mix.primitives(U1), g1)
                  + ctx.fluxes.viscous(U2, mix.primitives(U2), g2))
            flux = (flux - torch.einsum("...ed,...d->...e", 0.5 * Fv, nt_)).numpy()
            m = mask[els, lf]
            flux = np.where((m == 0)[:, None, None], 0.0, flux * m[:, None, None])
            Y[els[:, None], sup[None, :]] += np.einsum(
                "sj,esq->ejq", Bc[lf][:, sup], flux)
    return sw.sign * Y


@pytest.mark.parametrize("n,order,gll", [((6, 6), 1, True), ((3, 5), 1, False),
                                         ((3, 2), 2, False)])
def test_kernel_algebra_matches_plain_on_the_mixture(n, order, gll):
    tab_np, _, tab, ctx, _, X = _argon_case(n, order, gll, seed=7)
    sweep = build_face_sweep(tab, ctx)
    z_plain = sweep(X)
    z_kern = _emulate_argon(sweep, ctx, X)
    for q in range(6):
        _rel_close(z_kern[..., q], z_plain[..., q], 1e-11)
