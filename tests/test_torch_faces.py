"""The face sweep of tps_torch (dg/cuda_faces.py) on the CPU.

1. The prototype: tools/pallas_face_prototype.py runs in a subprocess
   (Pallas interpret mode, its own jax config) and saves its state, its
   XLA chain's result and its Pallas kernel's result.  The port's
   `prototype_chain_plain` and the wrapper's CPU path in prototype mode
   land within the prototype's own bar (1e-5, f32) of both; the package's
   Rusanov in its place does not.
2. The kernel's algebra: `_emulate` replays in numpy what
   csrc/face_sweep.cu computes from the words the wrapper passes, in its
   decomposition: tiles of the kernel's plan (the last one ragged), the
   nbr_row decode, the neighbour's trace through its combo's face block
   (combo_face) with its points put in place (combo_perm), each face's
   products over the nodes it touches, the strided normals, the mask and
   the sign.  It must agree with the plain version, 1e-11 in f64, also on
   periodic boxes one and two elements wide and with combos that permute
   a face's points.
The CUDA kernel itself runs only on a GPU (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
threadpool_limits(1)  # numpy's and scipy's BLAS too: one thread a worker

from tps_torch.dg import cuda_faces  # noqa: E402
from tps_torch.dg.bc import WallBC  # noqa: E402
from tps_torch.dg.cuda_faces import (  # noqa: E402
    build_face_sweep,
    build_prototype_sweep,
    face_sweep_plain,
    face_sweep_supported,
    prototype_chain_plain,
)
from tps_torch.dg.discretization import build_tables  # noqa: E402
from tps_torch.dg.fluxes import Fluxes  # noqa: E402
from tps_torch.dg.operators import dg_gradient  # noqa: E402
from tps_torch.dg.rhs import RHSContext, bc_slices  # noqa: E402
from tps_torch.dg.riemann import Rusanov  # noqa: E402
from tps_torch.mesh.generators import box_2d, box_3d  # noqa: E402
from tps_torch.physics.gas import DryAir  # noqa: E402
from tps_torch.physics.transport import ConstantTransport, DryAirTransport  # noqa: E402
from tps_torch.tools.face_prototype import prototype_state  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROTO_BAR = 1e-5  # tools/pallas_face_prototype.py:186
TOL = 1e-11

GLL = dict(basis="gauss-lobatto", quad_rule="gauss-lobatto")


def _ctx(dim, eq_system):
    mix = DryAir(dim=dim, nvel=dim)
    tr = None if eq_system == "euler" else DryAirTransport(
        mix.gas_constant, mix.specific_heat_ratio, bulk_visc_mult=0.3)
    fl = Fluxes(mixture=mix, transport=tr, eq_system=eq_system)
    return RHSContext(fluxes=fl, riemann=Rusanov(fl))


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(a - ref)) / np.max(np.abs(ref))


# ---------------------------------------------------------------- prototype


@pytest.fixture(scope="module")
def prototype_run(tmp_path_factory):
    """tools/pallas_face_prototype.py's arrays (interpret mode)."""
    out = tmp_path_factory.mktemp("proto") / "proto.npz"
    code = (
        "import runpy, sys\n"
        "import numpy as np\n"
        "sys.argv = ['pallas_face_prototype.py']\n"
        "g = runpy.run_path('tools/pallas_face_prototype.py')\n"
        f"np.savez({str(out)!r}, Ustd=np.asarray(g['Ustd']), "
        "z_ref=np.asarray(g['z_ref']), z_pal_std=np.asarray(g['z_pal_std']))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "CORRECT" in res.stdout
    d = np.load(out)
    tab = build_tables(box_3d(16, 16, 16, periodic=(True, True, True)), 2)
    return {k: d[k] for k in d.files}, tab


def test_prototype_chain_and_wrapper_match_the_prototype(prototype_run):
    arr, tab = prototype_run
    U_np = prototype_state(tab.ne, tab.ndof)
    np.testing.assert_array_equal(U_np, arr["Ustd"])  # the same state
    U = torch.as_tensor(U_np)
    sweep = build_prototype_sweep(tab, torch.float32, "cpu")
    cuda_faces.reset_launches()
    z_wrap = sweep(U)
    assert cuda_faces.launches["face_sweep"] == 0
    z_chain = prototype_chain_plain(
        U, torch.as_tensor(tab.Btr, dtype=torch.float32),
        torch.as_tensor(tab.nor_slot[0], dtype=torch.float32),
        torch.as_tensor(tab.wts_slot[0], dtype=torch.float32), tab.roll_info)
    for z in (z_wrap, z_chain):
        assert z.dtype == torch.float32
        for ref in ("z_ref", "z_pal_std"):
            assert _rel(z, arr[ref]) < PROTO_BAR, ref


def test_package_rusanov_fails_the_prototype_bar(prototype_run):
    """The prototype's per-side |u.n| + c|n| and the package's
    max(|u| + c) |n| differ far above 1e-5 on the prototype's state: a
    kernel with the two swapped fails the prototype's check."""
    arr, tab = prototype_run
    U = torch.as_tensor(arr["Ustd"])
    ctx = _ctx(3, "euler")
    z_pkg = -face_sweep_plain(ctx, tab.to_torch(torch.float32, "cpu"), U)
    assert _rel(z_pkg, arr["z_ref"]) > 100 * PROTO_BAR
    # and the numpy replay of the kernel, in each form
    sweep = build_prototype_sweep(tab, torch.float32, "cpu")
    X = U.double()
    assert _rel(_emulate(sweep, X), arr["z_ref"]) < PROTO_BAR
    assert _rel(_emulate(sweep, X, prototype=False), arr["z_ref"]) > 100 * PROTO_BAR


# ---------------------------------------------------------------- algebra


def _emulate(sw, X, prototype=None):
    """csrc/face_sweep.cu's algorithm in numpy, from the wrapper's words.

    Elements go in tiles of the kernel's E (plan); the last tile is padded
    with empty slots (no neighbour, mask 0), as the kernel's block leaves
    them.  Per tile and face: the own trace through Btr[lf], the
    neighbour's through its combo's face block combo_face[c] in that
    face's point order, point s stored at combo_perm[c, s]; both over the
    nodes the face touches.  The flux per point times the mask (0 for a
    boundary slot), scattered through Btr[lf]^T to the face's nodes and
    summed face by face; times sign."""
    proto = sw.prototype if prototype is None else prototype
    X = np.asarray(X, np.float64)
    ne, ndof, k = X.shape
    nqf, nlf, nc, dim, neq = sw.nqf, sw.nlf, sw.n_combo, sw.dim, sw.neq
    Bc = sw.Btr_or.double().numpy().reshape(nc, nqf, ndof)
    cface, cperm = sw.combo_face.numpy(), sw.combo_perm.numpy()
    nbr = sw.nbr_row.numpy().astype(np.int64)
    nor = sw.nor.double().numpy().reshape(-1)
    mask = np.ones((ne, nlf)) if sw.mask is None else sw.mask.double().numpy()
    gamma, R, C1, S0, cp_pr, bulk_mult, const, mu0, bulk0, kap0 = list(sw.phys)
    E = cuda_faces.plan(ndof, nqf, nlf, k, neq, sw.Btr_or.dtype)[0]
    nt = -(-ne // E)
    pad = nt * E - ne  # the ragged last tile's empty slots
    Xp = np.concatenate([X, np.zeros((pad, ndof, k))])
    mask = np.concatenate([mask, np.zeros((pad, nlf))])
    nbr = np.concatenate([nbr, np.zeros((pad, nlf), np.int64)])
    support = [np.flatnonzero((Bc[lf] != 0).any(0)) for lf in range(nlf)]
    e = np.minimum(np.arange(nt * E), ne - 1)  # an empty slot's normals: any

    def conv(u, n):
        rho = u[..., 0]
        vel = u[..., 1:1 + dim] / rho[..., None]
        v2 = np.sum(vel**2, -1)
        p = (gamma - 1) * (u[..., dim + 1] - 0.5 * rho * v2)
        un = np.sum(n * vel, -1)
        f0 = rho * un
        f = np.concatenate([f0[..., None], f0[..., None] * vel + n * p[..., None],
                            (un * (u[..., dim + 1] + p))[..., None]], -1)
        return f, np.sqrt(gamma * p / rho), np.sqrt(v2), un

    def visc(u, g, n):
        rho = u[..., 0]
        vel = u[..., 1:1 + dim] / rho[..., None]
        T = (gamma - 1) / R * (u[..., dim + 1] / rho - 0.5 * np.sum(vel**2, -1))
        if const:
            one = np.ones_like(T)
            mu, kap, bulk = mu0 * one, kap0 * one, (bulk0 - 2.0 / 3.0 * mu0) * one
        else:
            mu = C1 * T * np.sqrt(T) / (T + S0)
            kap, bulk = cp_pr * mu, (bulk_mult - 2.0 / 3.0) * mu
        gv = g[..., 1:1 + dim, :]
        div = np.trace(gv, axis1=-2, axis2=-1)
        tau = (mu[..., None, None] * (gv + np.swapaxes(gv, -1, -2))
               + (bulk * div)[..., None, None] * np.eye(dim))
        sn = np.einsum("...id,...d->...i", tau, n)
        qn = kap * np.einsum("...d,...d->...", g[..., dim + 1, :], n)
        return sn, np.sum(sn * vel, -1) + qn

    s, d = np.arange(nqf), np.arange(dim)
    Y = np.zeros((nt * E, ndof, neq))
    for lf in range(nlf):
        m = mask[:, lf]
        en, c = np.divmod(nbr[:, lf], nc)
        sup = support[lf]
        to = np.einsum("sk,ekq->esq", Bc[lf][:, sup], Xp[:, sup])
        tn = np.zeros_like(to)
        for cc in np.unique(c[m != 0]):
            sel = (c == cc) & (m != 0)
            f = cface[cc]
            tr = np.einsum("sk,ekq->esq", Bc[f][:, support[f]],
                           X[en[sel]][:, support[f]])
            tp = np.empty_like(tr)
            tp[:, cperm[cc]] = tr
            tn[sel] = tp
        n = nor[lf * sw.nor_lf + e[:, None, None] * sw.nor_e
                + s[None, :, None] * dim + d[None, None, :]]
        nmag = np.linalg.norm(n, axis=-1)
        with np.errstate(all="ignore"):  # empty slots and boundary slots
            f1, s1, v1, un1 = conv(to[..., :neq], n)
            f2, s2, v2, un2 = conv(tn[..., :neq], n)
            if proto:
                lam = 0.5 * np.maximum(np.abs(un1) + s1 * nmag,
                                       np.abs(un2) + s2 * nmag)
            else:
                lam = 0.5 * nmag * np.maximum(s1 + v1, s2 + v2)
            flux = 0.5 * (f1 + f2) - lam[..., None] * (tn[..., :neq] - to[..., :neq])
            if sw.viscous:
                for tr in (to, tn):
                    sn, en_flux = visc(tr[..., :neq],
                                       tr[..., neq:].reshape(-1, nqf, neq, dim), n)
                    flux[..., 1:1 + dim] -= 0.5 * sn
                    flux[..., dim + 1] -= 0.5 * en_flux
        flux = np.where((m == 0)[:, None, None], 0.0, flux * m[:, None, None])
        Y[:, sup] += np.einsum("sj,esq->ejq", Bc[lf][:, sup], flux)
    return sw.sign * Y[:ne]


def _permuted(tab_np, seed=3):
    """The tables with one more combo, face 1's block with its points
    permuted, taken by about half the slots whose neighbour side used face
    1: the plain sweep (its row gather, roll_info dropped) and the kernel
    then compute the same, non-physical, function through a combo that is
    not the identity."""
    rng = np.random.default_rng(seed)
    nc, nqf = tab_np.n_combo, tab_np.nqf
    extra = np.asarray(tab_np.Btr)[nqf + rng.permutation(nqf)]
    en, c = np.divmod(np.asarray(tab_np.nbr_row).astype(np.int64), nc)
    c = np.where((c == 1) & (rng.random(c.shape) < 0.5), nc, c)
    return dataclasses.replace(
        tab_np, roll_info=None, n_combo=nc + 1,
        Btr_or=np.concatenate([np.asarray(tab_np.Btr_or), extra]),
        nbr_row=(en * (nc + 1) + c).astype(np.asarray(tab_np.nbr_row).dtype))


def _slot_case(n, order, eq_system, gll, walls, seed):
    if len(n) == 3:
        mesh = box_3d(*n, periodic=(not walls,) * 3)
    else:
        mesh = box_2d(*n, periodic_x=not walls, periodic_y=not walls)
    tab_np = build_tables(mesh, order, **(GLL if gll else {}))
    ctx = _ctx(len(n), eq_system)
    if walls:
        bcs = bc_slices(tab_np.f_bdr_attr, lambda p: WallBC("inviscid"))
        ctx = RHSContext(fluxes=ctx.fluxes, riemann=ctx.riemann, bcs=bcs)
    tab = tab_np.to_torch(torch.float64, "cpu")
    dim = len(n)
    rng = np.random.default_rng(seed)
    Up = np.empty(tab_np.xyz_dof.shape[:-1] + (dim + 2,))
    Up[..., 0] = rng.uniform(1.0, 1.4, Up.shape[:-1])
    Up[..., 1:1 + dim] = rng.uniform(-15.0, 15.0, Up.shape[:-1] + (dim,))
    Up[..., dim + 1] = rng.uniform(280.0, 320.0, Up.shape[:-1])
    U = ctx.mixture.conservatives(torch.as_tensor(Up))
    if eq_system == "euler":
        X = U
    else:
        G = dg_gradient(tab, ctx.mixture.primitives(U))
        X = torch.cat([U, G.reshape(tab_np.ne, tab_np.ndof, -1)], -1)
    return tab_np, tab, ctx, X.contiguous()


@pytest.mark.parametrize("n,order,eq_system,gll,walls", [
    ((3, 4, 5), 2, "navier-stokes", True, True),   # non-cubic: axes show
    ((3, 4, 5), 2, "euler", False, True),
    ((2, 3, 3), 3, "navier-stokes", True, False),
    ((5, 4), 3, "navier-stokes", True, True),
    ((5, 4), 2, "euler", False, True),
    # periodic extents 1 and 2 (an element its own neighbour, both x
    # neighbours one element) in one ragged tile; 10 elements in two
    ((1, 2, 3), 2, "navier-stokes", True, False),
    ((2, 1, 5), 2, "euler", False, False),
    # p=1 (4 or 8 nodes an element), GL and GLL
    ((3, 4, 5), 1, "navier-stokes", True, True),
    ((3, 4, 5), 1, "navier-stokes", False, False),
    ((6, 6), 1, "navier-stokes", True, False),
    ((5, 4), 1, "euler", False, True),
])
def test_kernel_algebra_matches_plain(n, order, eq_system, gll, walls):
    tab_np, tab, ctx, X = _slot_case(n, order, eq_system, gll, walls, seed=11)
    assert face_sweep_supported(tab_np, ctx)
    sweep = build_face_sweep(tab, ctx)
    assert sweep.k == X.shape[-1] and not sweep.prototype
    z_plain = sweep(X)  # CPU: the plain version
    z_kern = _emulate(sweep, X)
    assert _rel(z_kern, z_plain) <= TOL
    # swapping the Rusanov forms is visible here too
    assert _rel(_emulate(sweep, X, prototype=True), z_plain) > 1e-6


@pytest.mark.parametrize("geom_order,gll,transport", [
    (2, False, "sutherland"), (2, True, "sutherland"), (3, False, "constant"),
])
def test_kernel_algebra_on_curved_annulus(geom_order, gll, transport):
    """The kernel's algorithm (emulated) against the plain sweep on the
    cylinder O-grid's curved quads (per-point normals, a face rule that
    grows with the geometry order), Sutherland and constant transport."""
    from tps_torch.mesh.generators import annulus_2d

    tab_np = build_tables(annulus_2d(3, 12, r0=0.5, r1=4.0,
                                     geom_order=geom_order), 2,
                          **(GLL if gll else {}))
    ctx = _ctx(2, "navier-stokes")
    if transport == "constant":
        fl = Fluxes(mixture=ctx.mixture, eq_system="navier-stokes",
                    transport=ConstantTransport(1.8e-5, 2e-6, 0.026))
        ctx = RHSContext(fluxes=fl, riemann=Rusanov(fl))
    assert face_sweep_supported(tab_np, ctx)
    tab = tab_np.to_torch(torch.float64, "cpu")
    rng = np.random.default_rng(3)
    Up = np.empty(tab_np.xyz_dof.shape[:-1] + (4,))
    Up[..., 0] = rng.uniform(1.0, 1.4, Up.shape[:-1])
    Up[..., 1:3] = rng.uniform(-15.0, 15.0, Up.shape[:-1] + (2,))
    Up[..., 3] = rng.uniform(280.0, 320.0, Up.shape[:-1])
    U = ctx.mixture.conservatives(torch.as_tensor(Up))
    G = dg_gradient(tab, ctx.mixture.primitives(U))
    X = torch.cat([U, G.reshape(tab_np.ne, tab_np.ndof, -1)], -1).contiguous()
    sweep = build_face_sweep(tab, ctx)
    assert sweep.nqf == 2 + geom_order + gll  # the face rule grows
    assert _rel(_emulate(sweep, X), sweep(X)) <= TOL


def test_permuted_combos_match_plain():
    tab0 = build_tables(box_3d(3, 4, 5, periodic=(False,) * 3), 2, **GLL)
    tab_np = _permuted(tab0)
    ctx = _ctx(3, "navier-stokes")
    ctx = RHSContext(fluxes=ctx.fluxes, riemann=ctx.riemann,
                     bcs=bc_slices(tab_np.f_bdr_attr, lambda p: WallBC("inviscid")))
    _, _, _, X = _slot_case((3, 4, 5), 2, "navier-stokes", True, True, seed=11)
    sweep = build_face_sweep(tab_np.to_torch(torch.float64, "cpu"), ctx)
    assert sweep.n_combo == 7 and sorted(sweep.combo_perm[6].tolist()) == list(range(25))
    assert sweep.combo_perm[6].tolist() != list(range(25))
    z_plain = sweep(X)
    assert _rel(_emulate(sweep, X), z_plain) <= TOL
    # the permutation is visible: the unpermuted tables give another sum
    unperm = build_face_sweep(tab0.to_torch(torch.float64, "cpu"), ctx)
    assert _rel(unperm(X), z_plain) > 1e-3


@pytest.mark.parametrize("case", ["walled_gll", "periodic_gl", "box_2d"])
def test_combo_tables_rebuild_btr_or(case):
    mesh = {"walled_gll": box_3d(2, 3, 2, periodic=(False,) * 3),
            "periodic_gl": box_3d(2, 2, 3, periodic=(True,) * 3),
            "box_2d": box_2d(3, 2, periodic_x=True, periodic_y=False)}[case]
    tab = build_tables(mesh, 2, **({} if case == "periodic_gl" else GLL))
    face, perm = cuda_faces.combo_tables(tab.Btr_or, tab.nlf, tab.nqf)
    B = np.asarray(tab.Btr_or).reshape(-1, tab.nqf, tab.ndof)
    rebuilt = np.empty_like(B)
    for c in range(tab.n_combo):
        rebuilt[c, perm[c]] = np.asarray(tab.Btr)[face[c] * tab.nqf:(face[c] + 1) * tab.nqf]
    np.testing.assert_array_equal(rebuilt, B)  # exact copies
    # generator boxes: one identity combo per face
    assert tab.n_combo == tab.nlf
    np.testing.assert_array_equal(face, np.arange(tab.nlf))
    np.testing.assert_array_equal(perm, np.tile(np.arange(tab.nqf), (tab.nlf, 1)))
    # and the permuted combo of `_permuted`
    t2 = _permuted(tab)
    face2, perm2 = cuda_faces.combo_tables(t2.Btr_or, t2.nlf, t2.nqf)
    assert face2[-1] == 1
    np.testing.assert_array_equal(
        np.asarray(t2.Btr_or)[-tab.nqf:][perm2[-1]], np.asarray(tab.Btr)[tab.nqf:2 * tab.nqf])


def test_prototype_algebra_on_a_small_box():
    tab = build_tables(box_3d(3, 4, 5, periodic=(True, True, True)), 2)
    sweep = build_prototype_sweep(tab, torch.float64, "cpu")
    U = torch.as_tensor(prototype_state(tab.ne, tab.ndof), dtype=torch.float64)
    assert _rel(_emulate(sweep, U), sweep(U)) <= TOL
    assert sweep.nor_e == 0 and sweep.sign == 1.0 and sweep.mask is None


def test_gate_and_shared_memory_bound():
    tab = build_tables(box_3d(2, 2, 2, periodic=(False,) * 3), 2, **GLL)
    assert face_sweep_supported(tab, _ctx(3, "navier-stokes"))
    mix = DryAir(dim=3, nvel=3)
    # constant transport is taken (dg_pointwise.cuh::transport); a gas
    # with fewer velocities than dimensions is not
    fl = Fluxes(mixture=mix, transport=ConstantTransport(1e-5, 0.0, 0.02),
                eq_system="navier-stokes")
    assert face_sweep_supported(tab, RHSContext(fluxes=fl, riemann=Rusanov(fl)))
    assert not face_sweep_supported(tab, _ctx(2, "navier-stokes"))
    # p=7 NS in f64 (ndof 512): one element's states need more than a
    # block's 227 KB: refused for CUDA; p=6 still fits, one element a block
    assert cuda_faces.plan(343, 81, 6, 20, 5, torch.float64)[0] == 1
    big = build_tables(box_3d(1, 1, 1, periodic=(False,) * 3), 7, **GLL)
    assert (big.ndof, big.nqf) == (512, 100)
    tile, _res, smem = cuda_faces.plan(big.ndof, big.nqf, 6, 20, 5, torch.float64)
    assert tile == 0 and smem > cuda_faces.SHARED_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        cuda_faces._check_cuda(big, True, torch.float64, "cuda")
    cuda_faces._check_cuda(big, True, torch.float64, "cpu")  # CPU: any size
