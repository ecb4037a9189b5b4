"""The fused RHS of tps_torch == the JAX package's fused and Pallas RHS.

On the CPU the K1/K2 wrappers of dg/cuda_fused.py run their plain
PyTorch version (dg/fused.py); here it is held against the JAX package's
Pallas megakernel in interpret mode and its XLA FusedRHS, at the bar of
tests/test_pallas_fused.py (1e-11 relative to max|y|, max char speed to
1e-12).  The CUDA kernels themselves run only on a GPU
(tests/test_torch_cuda.py, chip_smoke.py); what can be checked here is
their algebra: `_emulate` replays, in numpy, the products and neighbor
arithmetic of csrc/fused_rhs.cu on the folds and grid words the wrapper
passes, K2 in its decomposition (tiles of the kernel's plan, the last one
ragged; each face's products over the nodes its trace rows touch), and
must agree with the plain version, also on periodic boxes one and two
elements wide.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tps_torch.dg import cuda_fused  # noqa: E402
from tps_torch.dg.cuda_fused import build_cuda_fused, cuda_fusable, kernel_folds  # noqa: E402
from tps_torch.dg.discretization import build_tables  # noqa: E402
from tps_torch.dg.fluxes import Fluxes  # noqa: E402
from tps_torch.dg.fused import maybe_build_fused  # noqa: E402
from tps_torch.dg.rhs import RHSContext  # noqa: E402
from tps_torch.dg.riemann import Rusanov  # noqa: E402
from tps_torch.mesh.generators import box_2d, box_3d  # noqa: E402
from tps_torch.physics.gas import DryAir  # noqa: E402
from tps_torch.physics.transport import DryAirTransport  # noqa: E402
from tps_tpu.dg.discretization import build_tables as jbuild_tables  # noqa: E402
from tps_tpu.dg.fluxes import Fluxes as JFluxes  # noqa: E402
from tps_tpu.dg.fused import maybe_build_fused as jmaybe_build_fused  # noqa: E402
from tps_tpu.dg.pallas_fused import build_pallas_fused  # noqa: E402
from tps_tpu.dg.rhs import RHSContext as JRHSContext  # noqa: E402
from tps_tpu.dg.riemann import Rusanov as JRusanov  # noqa: E402
from tps_tpu.mesh.generators import box_3d as jbox_3d  # noqa: E402
from tps_tpu.physics.gas import DryAir as JDryAir  # noqa: E402
from tps_tpu.physics.transport import DryAirTransport as JDryAirTransport  # noqa: E402

TOL = 1e-11


def _perturbed(xyz, dim):
    """The perturbed periodic state of tests/test_pallas_fused.py (primitives)."""
    tp = 2 * np.pi
    Up = np.zeros(xyz.shape[:-1] + (dim + 2,))
    Up[..., 0] = 1.2
    Up[..., 1:1 + dim] = (10.0, 3.0, -2.0)[:dim]
    Up[..., dim + 1] = 300.0
    Up[..., 1] += 5.0 * np.sin(tp * xyz[..., 0]) * np.cos(tp * xyz[..., 1])
    Up[..., 2] += -5.0 * np.cos(tp * xyz[..., 0]) * np.sin(tp * xyz[..., -1])
    Up[..., dim + 1] += (20.0 * np.sin(tp * xyz[..., -1])
                         * np.cos(tp * xyz[..., 1]))
    return Up


def _ctx(dim, eq_system):
    mix = DryAir(dim=dim, nvel=dim)
    tr = None if eq_system == "euler" else DryAirTransport(
        mix.gas_constant, mix.specific_heat_ratio, bulk_visc_mult=0.3)
    fl = Fluxes(mixture=mix, transport=tr, eq_system=eq_system)
    return RHSContext(fluxes=fl, riemann=Rusanov(fl))


def _port_setup(n, order, eq_system):
    tab = build_tables(box_3d(*n, periodic=(True, True, True)), order)
    ctx = _ctx(3, eq_system)
    U = ctx.mixture.conservatives(torch.as_tensor(_perturbed(tab.xyz_dof, 3)))
    return tab, ctx, U


@pytest.mark.parametrize("eq_system", ["euler", "navier-stokes"])
def test_cuda_fused_cpu_matches_jax(eq_system):
    n = (4, 4, 8)
    tab, ctx, U = _port_setup(n, 2, eq_system)
    rhs = build_cuda_fused(tab, ctx, torch.float64, "cpu")
    cuda_fused.reset_launches()
    y, aux = rhs(U)
    assert cuda_fused.launches == {"k1_gradient": 0, "k2_faces_volume": 0}

    jmix = JDryAir(dim=3, nvel=3)
    jtr = None if eq_system == "euler" else JDryAirTransport(
        jmix.gas_constant, jmix.specific_heat_ratio, bulk_visc_mult=0.3)
    jfl = JFluxes(mixture=jmix, transport=jtr, eq_system=eq_system)
    jctx = JRHSContext(fluxes=jfl, riemann=JRusanov(jfl))
    jtab = jbuild_tables(jbox_3d(*n, periodic=(True, True, True)), 2)
    Uj = jnp.asarray(U.numpy())
    pall = build_pallas_fused(jtab, jctx, dtype=jnp.float64, interpret=True)
    yp, auxp = pall(pall.to_fused(Uj))
    yp = np.asarray(pall.from_fused(yp))
    jf = jmaybe_build_fused(jtab, jctx, dtype=jnp.float64)
    yx, auxx = jf(jf.to_fused(Uj))
    yx = np.asarray(jf.from_fused(yx))

    scale = np.max(np.abs(yp))
    for ref, aux_ref in ((yp, auxp), (yx, auxx)):
        np.testing.assert_allclose(y.numpy(), ref, atol=TOL * scale,
                                   rtol=TOL)
        np.testing.assert_allclose(float(aux["max_char_speed"]),
                                   float(aux_ref["max_char_speed"]),
                                   rtol=1e-12)


def test_fused_ns_2d_matches_jax():
    """2-D NS runs through the plain version (the kernels are 3-D only)."""
    n = 6
    mesh = box_2d(n, n, periodic_x=True, periodic_y=True)
    tab = build_tables(mesh, 2)
    ctx = _ctx(2, "navier-stokes")
    assert not cuda_fusable(tab, ctx)
    fr = maybe_build_fused(tab, ctx, torch.float64, "cpu")
    U = ctx.mixture.conservatives(torch.as_tensor(_perturbed(tab.xyz_dof, 2)))
    y2, aux = fr(fr.to_fused(U))

    from tps_tpu.mesh.generators import box_2d as jbox_2d

    jmix = JDryAir(dim=2, nvel=2)
    jfl = JFluxes(mixture=jmix, transport=JDryAirTransport(
        jmix.gas_constant, jmix.specific_heat_ratio, bulk_visc_mult=0.3),
        eq_system="navier-stokes")
    jctx = JRHSContext(fluxes=jfl, riemann=JRusanov(jfl))
    jtab = jbuild_tables(jbox_2d(n, n, periodic_x=True, periodic_y=True), 2)
    jf = jmaybe_build_fused(jtab, jctx, dtype=jnp.float64)
    Uj = jnp.asarray(U.numpy())
    yx, auxx = jf(jf.to_fused(Uj))
    scale = float(jnp.max(jnp.abs(yx)))
    np.testing.assert_allclose(y2.numpy(), np.asarray(yx), atol=TOL * scale,
                               rtol=TOL)
    np.testing.assert_allclose(float(aux["max_char_speed"]),
                               float(auxx["max_char_speed"]), rtol=1e-12)


# ---------------------------------------------------------------- the
# kernels' algebra, replayed in numpy as csrc/fused_rhs.cu does it


def _neighbors(geo, ne):
    nz, ny, nx = geo[0:3]
    axis, step = geo[3:9], geo[9:15]
    e = np.arange(ne)
    c = np.stack([e // (nx * ny), (e // nx) % ny, e % nx])
    n = np.array([nz, ny, nx])
    out = []
    for lf in range(6):
        cc = c.copy()
        a = axis[lf]
        cc[a] = ((cc[a] + step[lf]) % n[a] + n[a]) % n[a]
        out.append((cc[0] * ny + cc[1]) * nx + cc[2])
    return out


def _emulate(rhs, U):
    """(G, y, per-element mcs) from the kernels' algorithm in numpy."""
    f = {k: getattr(rhs, k).numpy() for k in
         ("Wgrad", "Vvol", "Btr", "Wscat", "nor")}
    geo = list(rhs.geo)
    gamma, R, C1, S0, cp_pr, bulk_mult = list(rhs.phys)
    U = U.numpy()
    ne = U.shape[0]
    nbr = _neighbors(geo, ne)
    opp = geo[15:21]

    def prims(u):
        rho = u[..., 0]
        vel = u[..., 1:4] / rho[..., None]
        p = (gamma - 1) * (u[..., 4] - 0.5 * rho * np.sum(vel**2, -1))
        return rho, vel, p

    def mu_kap(T):
        mu = C1 * T * np.sqrt(T) / (T + S0)
        return mu, cp_pr * mu

    def tau(g, mu, bulk):
        gv = g[..., 1:4, :]  # [.., i, d]
        div = gv[..., 0, 0] + gv[..., 1, 1] + gv[..., 2, 2]
        return (mu[..., None, None] * (gv + np.swapaxes(gv, -1, -2))
                + (bulk * div)[..., None, None] * np.eye(3))

    # K1
    rho, vel, p = prims(U)
    Up = np.concatenate([rho[..., None], vel, (p / rho / R)[..., None]], -1)
    S = np.stack([Up] + [Up[nb] for nb in nbr])  # [7, ne, ndof, 5]
    Gr = np.einsum("srk,sekq->erq", f["Wgrad"], S)
    ndof = U.shape[1]
    G = Gr.reshape(ne, 3, ndof, 5).transpose(0, 2, 3, 1)
    if not rhs.viscous:
        G = None

    # K2: tiles of the kernel's E elements; the ragged last tile's empty
    # slots (no element, no neighbor, flux 0) are padding, dropped at the end
    E = cuda_fused.k2_plan(ndof, rhs.nqf, rhs.viscous, torch.float64)[0]
    nt = -(-ne // E)
    pad = nt * E - ne
    Ut = np.concatenate([U, np.repeat(U[:1], pad, 0)])
    Gp = None if G is None else np.concatenate([G, np.repeat(G[:1], pad, 0)])
    valid = np.arange(nt * E) < ne
    nbrp = [np.concatenate([nb, np.zeros(pad, np.int64)]) for nb in nbr]
    Bl = f["Btr"]
    support = [np.flatnonzero((Bl[lf] != 0).any(0)) for lf in range(6)]

    # volume: each element's flux and its scatter through V
    rho, vel, p = prims(Ut)
    mcs = np.max(np.sqrt(np.sum(vel**2, -1)) + np.sqrt(gamma * p / rho), 1)
    F = np.zeros(Ut.shape + (3,))
    F[..., 0, :] = Ut[..., 1:4]
    F[..., 1:4, :] = Ut[..., 1:4, None] * vel[..., None, :] + \
        p[..., None, None] * np.eye(3)
    F[..., 4, :] = vel * (Ut[..., 4] + p)[..., None]
    if Gp is not None:
        mu, kap = mu_kap(p / rho / R)
        t = tau(Gp, mu, (bulk_mult - 2.0 / 3.0) * mu)
        F[..., 1:4, :] -= t
        F[..., 4, :] -= np.einsum("...id,...i->...d", t, vel) + \
            kap[..., None] * Gp[..., 4, :]
    y = np.einsum("djq,eqcd->ejc", f["Vvol"], F)

    # the six faces: both traces over the face's nodes, the flux, the
    # scatter through W_lf (to the same nodes)
    for lf in range(6):
        so, sn, n = support[lf], support[opp[lf]], f["nor"][lf]
        bo, bn = Bl[lf][:, so], Bl[opp[lf]][:, sn]
        to = np.einsum("sk,ekc->esc", bo, Ut[:, so])
        tn = np.einsum("sk,ekc->esc", bn, U[nbrp[lf]][:, sn])
        fl = []
        cs = []
        for tr in (to, tn):
            r, v, pp = prims(tr)
            un = np.einsum("esd,sd->es", v, n)
            f0 = r * un
            fm = f0[..., None] * v + n * pp[..., None]
            fe = un * (tr[..., 4] + pp)
            fl.append(np.concatenate([f0[..., None], fm, fe[..., None]], -1))
            cs.append(np.sqrt(gamma * pp / r) + np.sqrt(np.sum(v**2, -1)))
        lam = 0.5 * np.linalg.norm(n, axis=-1) * np.maximum(cs[0], cs[1])
        flux = 0.5 * (fl[0] + fl[1]) - lam[..., None] * (tn - to)
        if Gp is not None:
            for tr, g in ((to, np.einsum("sk,ekcd->escd", bo, Gp[:, so])),
                          (tn, np.einsum("sk,ekcd->escd", bn, G[nbrp[lf]][:, sn]))):
                r, v, _ = prims(tr)
                T = (gamma - 1) / R * (tr[..., 4] / r - 0.5 * np.sum(v**2, -1))
                mu, kap = mu_kap(T)
                t = tau(g, mu, (bulk_mult - 2.0 / 3.0) * mu)
                taun = np.einsum("esid,sd->esi", t, n)
                qn = kap * np.einsum("esd,sd->es", g[..., 4, :], n)
                flux[..., 1:4] -= 0.5 * taun
                flux[..., 4] -= 0.5 * (np.sum(taun * v, -1) + qn)
        flux = np.where(valid[:, None, None], flux, 0.0)
        y[:, so] += np.einsum("js,esc->ejc", f["Wscat"][lf][so], flux)
    return G, y[:ne], mcs[:ne]


@pytest.mark.parametrize("n,order,eq_system", [
    ((3, 4, 5), 2, "navier-stokes"),  # non-cubic: a swapped axis shows up
    ((3, 4, 5), 2, "euler"),
    ((2, 3, 4), 3, "navier-stokes"),
    # periodic extents 1 and 2: an element its own neighbor, both x
    # neighbors one element; 6 and 27 elements (ragged tiles of 8)
    ((1, 2, 3), 2, "navier-stokes"),
    ((3, 3, 3), 2, "euler"),
])
def test_kernel_algebra_matches_plain(n, order, eq_system):
    tab, ctx, U = _port_setup(n, order, eq_system)
    assert cuda_fusable(tab, ctx)
    rhs = build_cuda_fused(tab, ctx, torch.float64, "cpu")
    G, y, mcs = _emulate(rhs, U)
    y_plain, mcs_plain = rhs.faces_volume(
        U, rhs.gradient(U) if rhs.viscous else None)
    scale = float(torch.max(torch.abs(y_plain)))
    np.testing.assert_allclose(y, y_plain.numpy(), atol=TOL * scale, rtol=TOL)
    np.testing.assert_allclose(mcs, mcs_plain.numpy(), rtol=1e-12)
    if G is not None:
        G_plain = rhs.gradient(U).numpy()
        np.testing.assert_allclose(G, G_plain, rtol=TOL,
                                   atol=TOL * np.max(np.abs(G_plain)))


def test_kernel_folds_shapes_and_gate():
    tab, ctx, _U = _port_setup((3, 4, 5), 2, "navier-stokes")
    f = kernel_folds(tab)
    assert f["Wgrad"].shape == (7, 81, 27)
    assert f["Vvol"].shape == (3, 27, 27)
    # faces integrate at OrderW + 2p = 6: 4x4 points
    assert tab.nqf == 16
    assert f["Btr"].shape == (6, 16, 27)
    assert f["Wscat"].shape == (6, 27, 16)
    assert f["nor"].shape == (6, 16, 3)
    # the reference-default Gauss-Lobatto basis is not collocated: no kernel
    gll = build_tables(box_3d(2, 2, 2, periodic=(True, True, True)), 2,
                       basis="gauss-lobatto", quad_rule="gauss-lobatto")
    assert not cuda_fusable(gll, ctx)
    with pytest.raises(ValueError):
        build_cuda_fused(gll, ctx, torch.float64, "cpu")


def test_shared_memory_bound_raises_for_cuda():
    """p=5 in f64 (ndof 216) needs more than K1's 48 KB per block (K2 would
    take it, one element a block): refused before any CUDA call, while the
    CPU (plain) path takes it.  p=4 fits both."""
    assert 7 * 125 * 5 * 8 <= cuda_fused.K1_SHARED_LIMIT
    assert cuda_fused.k2_plan(125, 36, True, torch.float64)[0] >= 1
    tab = build_tables(box_3d(2, 2, 2, periodic=(True, True, True)), 5)
    ctx = _ctx(3, "navier-stokes")
    assert cuda_fused.k2_plan(tab.ndof, tab.nqf, True, torch.float64)[0] == 1
    with pytest.raises(ValueError, match="shared memory"):
        build_cuda_fused(tab, ctx, torch.float64, "cuda")
    assert build_cuda_fused(tab, ctx, torch.float64, "cpu").ndof == 216
