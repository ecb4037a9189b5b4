"""The general (slot) path of tps_torch == the JAX package's, on the CPU.

The same numpy tables and the same numpy-seeded states go through
tps_tpu.dg.operators / tps_tpu.dg.rhs.compute_rhs (jit, f64) and their
counterparts in tps_torch (f64, the plain face sweep of dg/cuda_faces.py
on CPU tensors).  Bars: operators to 1e-12 and the right-hand side to
1e-11 relative to max|y|, the max char speed to 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from threadpoolctl import threadpool_limits

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
threadpool_limits(1)  # numpy's and scipy's BLAS too: one thread a worker

from tps_torch.dg import cuda_faces  # noqa: E402
from tps_torch.dg import operators as ops  # noqa: E402
from tps_torch.dg.bc import InletBC, OutletBC, WallBC  # noqa: E402
from tps_torch.dg.discretization import build_tables  # noqa: E402
from tps_torch.dg.fluxes import Fluxes  # noqa: E402
from tps_torch.dg.rhs import RHSContext, bc_slices, compute_rhs  # noqa: E402
from tps_torch.dg.riemann import Rusanov  # noqa: E402
from tps_torch.mesh.generators import box_2d, box_3d  # noqa: E402
from tps_torch.physics.gas import DryAir  # noqa: E402
from tps_torch.physics.transport import DryAirTransport  # noqa: E402
from tps_tpu.dg import bc as jbc  # noqa: E402
from tps_tpu.dg import operators as jops  # noqa: E402
from tps_tpu.dg import rhs as jrhs  # noqa: E402
from tps_tpu.dg.discretization import build_tables as jbuild_tables  # noqa: E402
from tps_tpu.dg.fluxes import Fluxes as JFluxes  # noqa: E402
from tps_tpu.dg.riemann import Rusanov as JRusanov  # noqa: E402
from tps_tpu.mesh.generators import box_2d as jbox_2d  # noqa: E402
from tps_tpu.mesh.generators import box_3d as jbox_3d  # noqa: E402
from tps_tpu.physics.gas import DryAir as JDryAir  # noqa: E402
from tps_tpu.physics.transport import DryAirTransport as JDryAirTransport  # noqa: E402

OP_TOL = 1e-12
RHS_TOL = 1e-11
MCS_TOL = 1e-12

BASES = {"gl": dict(basis="gauss-legendre", quad_rule="gauss-legendre"),
         "gll": dict(basis="gauss-lobatto", quad_rule="gauss-lobatto")}


def _tables(n, order, basis, periodic):
    """(port numpy tables, JAX tables in f64) of one generated box."""
    kw = BASES[basis]
    if len(n) == 3:
        port = build_tables(box_3d(*n, periodic=(periodic,) * 3), order, **kw)
        ref = jbuild_tables(jbox_3d(*n, periodic=(periodic,) * 3), order, **kw)
    else:
        port = build_tables(box_2d(*n, periodic_x=periodic, periodic_y=periodic),
                            order, **kw)
        ref = jbuild_tables(jbox_2d(*n, periodic_x=periodic, periodic_y=periodic),
                            order, **kw)
    return port, ref


def _state(xyz, dim, seed):
    """A perturbed conserved state from a numpy seed: rho ~ 1.2, u ~ (10,
    3, -2), T ~ 300, each with noise (a uniform state hides faults)."""
    rng = np.random.default_rng(seed)
    shape = xyz.shape[:-1]
    rho = 1.2 + 0.1 * rng.uniform(-1.0, 1.0, shape)
    vel = np.asarray((10.0, 3.0, -2.0)[:dim]) + 4.0 * rng.uniform(
        -1.0, 1.0, shape + (dim,))
    T = 300.0 + 20.0 * rng.uniform(-1.0, 1.0, shape)
    p = rho * 287.058 * T
    rhoE = p / 0.4 + 0.5 * rho * np.sum(vel**2, -1)
    return np.concatenate([rho[..., None], rho[..., None] * vel,
                           rhoE[..., None]], -1)


def _ctxs(dim, eq_system, specs=(), tab_np=None):
    """(port ctx, JAX ctx) with one BCSlice per (patch, port bc, JAX bc)."""
    mix, jmix = DryAir(dim=dim, nvel=dim), JDryAir(dim=dim, nvel=dim)
    tr = jtr = None
    if eq_system != "euler":
        tr = DryAirTransport(mix.gas_constant, mix.specific_heat_ratio,
                             bulk_visc_mult=0.3)
        jtr = JDryAirTransport(jmix.gas_constant, jmix.specific_heat_ratio,
                               bulk_visc_mult=0.3)
    fl = Fluxes(mixture=mix, transport=tr, eq_system=eq_system)
    jfl = JFluxes(mixture=jmix, transport=jtr, eq_system=eq_system)
    slices = ()
    if specs:
        slices = bc_slices(tab_np.f_bdr_attr, {p: bc for p, bc, _ in specs}.get)
    jbc_of = {id(bc): jbc_ for _, bc, jbc_ in specs}
    jslices = [jrhs.BCSlice(bc=jbc_of[id(s.bc)], start=s.start, stop=s.stop)
               for s in slices]
    return (RHSContext(fluxes=fl, riemann=Rusanov(fl), bcs=slices),
            jrhs.RHSContext(fluxes=jfl, riemann=JRusanov(jfl),
                            bcs=tuple(jslices)))


def _inviscid_walls(dim):
    return [(p, WallBC("inviscid"), jbc.WallBC("inviscid"))
            for p in range(1, 2 * dim + 1)]


def _rel_close(a, ref, tol):
    a, ref = np.asarray(a), np.asarray(ref)
    scale = np.max(np.abs(ref))
    assert scale > 0
    err = np.max(np.abs(a - ref)) / scale
    assert err <= tol, err


# ---------------------------------------------------------------- operators


@pytest.mark.parametrize("roll", [True, False])
def test_operators_match_jax(roll):
    """perface_traces, dg_gradient, volume_weak_div and apply_minv2 on a
    3x3x4 p=2 GLL box with walls (non-diagonal mass).  roll=False drops
    the grid-roll hint, so the neighbours come from the nbr_row gather."""
    tab_np, jtab_np = _tables((3, 3, 4), 2, "gll", periodic=False)
    assert tab_np.nfb and tab_np.minv_diag is None
    assert tab_np.roll_info is not None
    if not roll:
        tab_np.roll_info = jtab_np.roll_info = None
    tab = tab_np.to_torch(torch.float64, "cpu")
    jtab = jtab_np.to_jax(jnp.float64)
    rng = np.random.default_rng(3)
    ne, ndof, nq = tab_np.ne, tab_np.ndof, tab_np.nq
    X = rng.standard_normal((ne, ndof, 20))
    Xt, Xj = torch.as_tensor(X), jnp.asarray(X)
    own, nbr = ops.perface_traces(tab, Xt)
    jown, jnbr = jops.perface_traces(jtab, Xj)
    for a, b in zip(own + nbr, jown + jnbr):
        _rel_close(a, b, OP_TOL)
    for a, b in zip(ops.perface_own_traces(tab, Xt),
                    jops.perface_own_traces(jtab, Xj)):
        _rel_close(a, b, OP_TOL)
    for a, b in zip(ops.slot_traces(tab, Xt), jops.slot_traces(jtab, Xj)):
        _rel_close(a, b, OP_TOL)
    _rel_close(ops.elem_traces(tab, Xt), jops.elem_traces(jtab, Xj), OP_TOL)
    Fel = rng.standard_normal((ne, tab_np.nlf * tab_np.nqf, 20))
    _rel_close(ops.trace_transpose(tab, torch.as_tensor(Fel)),
               jops.trace_transpose(jtab, jnp.asarray(Fel)), OP_TOL)
    _rel_close(ops.apply_minv(tab, Xt), jops.apply_minv(jtab, Xj), OP_TOL)
    Up = _state(tab_np.xyz_dof, 3, 4)
    _rel_close(ops.dg_gradient(tab, torch.as_tensor(Up)),
               jops.dg_gradient(jtab, jnp.asarray(Up)), OP_TOL)
    F = rng.standard_normal((ne, ndof, 5, 3))
    _rel_close(ops.volume_weak_div(tab, torch.as_tensor(F)),
               jops.volume_weak_div(jtab, jnp.asarray(F)), OP_TOL)
    Z2 = rng.standard_normal((ne, ndof * 5))
    _rel_close(ops.apply_minv2(tab, torch.as_tensor(Z2), 5),
               jops.apply_minv2(jtab, jnp.asarray(Z2), 5), OP_TOL)
    assert nq == 64 and ndof == 27


def test_gradient_boundary_states_not_ported():
    tab_np, _ = _tables((2, 2, 2), 2, "gl", periodic=False)
    tab = tab_np.to_torch(torch.float64, "cpu")
    Up = torch.ones((tab_np.ne, tab_np.ndof, 5), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        ops.dg_gradient(tab, Up, bdr_up2=Up[:1])


# ---------------------------------------------------------------- the RHS


def _check_rhs(n, order, basis, periodic, eq_system, specs_fn, seed):
    tab_np, jtab_np = _tables(n, order, basis, periodic)
    dim = len(n)
    ctx, jctx = _ctxs(dim, eq_system, specs_fn(dim), tab_np)
    U = _state(tab_np.xyz_dof, dim, seed)
    tab = tab_np.to_torch(torch.float64, "cpu")
    cuda_faces.reset_launches()
    y, aux = compute_rhs(ctx, tab, torch.as_tensor(U))
    assert cuda_faces.launches["face_sweep"] == 0  # CPU: the plain version
    jy, jaux = jax.jit(lambda t, u: jrhs.compute_rhs(jctx, t, u))(
        jtab_np.to_jax(jnp.float64), jnp.asarray(U))
    _rel_close(y, jy, RHS_TOL)
    np.testing.assert_allclose(float(aux["max_char_speed"]),
                               float(jaux["max_char_speed"]), rtol=MCS_TOL)
    return tab_np


def test_rhs_periodic_gll_ns():
    """(a) periodic 3x4x4 p=2 GLL Navier-Stokes (the flagship deck's
    discretization): the slot path, no boundary slots."""
    tab_np = _check_rhs((3, 4, 4), 2, "gll", True, "navier-stokes",
                        lambda dim: [], seed=1)
    assert tab_np.nfb == 0 and tab_np.minv_diag is None


@pytest.mark.parametrize("basis", ["gl", "gll"])
def test_rhs_inviscid_walls_ns(basis):
    """(b) six inviscid walls, Navier-Stokes (bench.py's general-path box)."""
    _check_rhs((3, 3, 4), 2, basis, False, "navier-stokes", _inviscid_walls,
               seed=2)


def _mixed_2d(dim):
    return [
        (1, WallBC("viscous_isothermal", 310.0),
         jbc.WallBC("viscous_isothermal", 310.0)),
        (2, OutletBC(pressure=101000.0), jbc.OutletBC(pressure=101000.0)),
        (3, WallBC("viscous_adiabatic"), jbc.WallBC("viscous_adiabatic")),
        (4, InletBC(input_state=(1.25, 9.0, 1.0)),
         jbc.InletBC(input_state=(1.25, 9.0, 1.0))),
    ]


def test_rhs_2d_p3_ns_wall_inlet_outlet():
    """(c) 2-D p=3 NS: isothermal and adiabatic walls, a subsonic inlet
    and a subsonicPressure outlet."""
    _check_rhs((4, 3), 3, "gll", False, "navier-stokes", _mixed_2d, seed=5)


def test_rhs_3d_p3_euler_slip():
    """(d) 3-D p=3 Euler with slip walls on every side."""
    def slip(dim):
        return [(p, WallBC("slip"), jbc.WallBC("slip"))
                for p in range(1, 2 * dim + 1)]
    _check_rhs((2, 2, 3), 3, "gl", False, "euler", slip, seed=6)


def test_bc_slices_cover_each_patch():
    """One slice per patch, over exactly its rows, ordered by row; a patch
    with no BC raises."""
    tab_np, _ = _tables((2, 3), 2, "gl", periodic=False)
    attrs = np.asarray(tab_np.f_bdr_attr)
    slices = bc_slices(attrs, lambda p: WallBC("inviscid"))
    assert len(slices) == 4
    assert [s.start for s in slices] == sorted(s.start for s in slices)
    for s in slices:
        assert len(np.unique(attrs[s.start:s.stop])) == 1
    assert sum(s.stop - s.start for s in slices) == len(attrs)
    with pytest.raises(ValueError, match=r"patch\(es\) \[3\]"):
        bc_slices(attrs, lambda p: None if p == 3 else WallBC("inviscid"))


def test_unported_outlet_kind_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        OutletBC(pressure=1.0, kind="nonReflectingPressure")
