"""tps_torch's mixture boundary conditions on manufactured states, against
the JAX package's, on the CPU in f64 (a file of its own beside
tests/test_torch_mixture_bc.py, so that loadfile spreads the two):

- tests/test_mms_ternary_bc.py::test_exact_states_satisfy_bcs: the
  manufactured wall and inflow/outflow states (constant plasma transport)
  satisfy their BCs in the port's mixture, and the port's right-hand side
  with the BCs active equals tps_tpu's (jitted) on them;
- ::test_general_wall_sheath_exact_flux_match: with the slopes tps_tpu
  solves, the port's sheath and isothermal general walls prescribe the
  manufactured fluxes on every row.

Bar: 1e-12 of max|ref| (TOL) per quantity, unless a check states
another and why.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from threadpoolctl import threadpool_limits

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
threadpool_limits(1)  # numpy's and scipy's BLAS too: one thread a worker

import test_mms_ternary_bc as mms  # noqa: E402

from tps_torch import harness  # noqa: E402
from tps_torch.dg import bc as pbc  # noqa: E402
from tps_torch.dg.rhs import compute_rhs  # noqa: E402
from tps_tpu.dg import rhs as jrhs  # noqa: E402
from tps_tpu.harness import Tps as JTps  # noqa: E402

TOL = 1e-12


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


# ------------------------------------------------------- manufactured states


def _mms_pair(order, n, bcs, periodic, tmp_path):
    """The manufactured-solution deck (constant plasma transport) built by
    both packages."""
    text = mms.DECK.format(order=order, n=n, L=mms.L, bcs=bcs,
                           periodic=periodic)
    path = tmp_path / f"mms_{abs(hash(bcs)) % 99999}.ini"
    path.write_text(text)
    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", str(path), "--device",
                                 "cpu"])
    tps.parse_input()
    tps.config.outdir = str(tmp_path)
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    jtps = JTps()
    jtps.input_file = str(path)
    jtps.parse_input()
    jtps.config.outdir = str(tmp_path / "jax")
    jtps.choose_devices()
    jtps.choose_solver()
    jtps.initialize()
    return tps.solver, jtps.solver


def _rhs_pair(s, js, up_point):
    """Both packages' right-hand sides (forcings off, BCs on) on the
    manufactured state at the dofs."""
    tab = js.tables
    xyz = tab.xyz_dof.reshape(-1, tab.dim)
    Up = jax.vmap(up_point)(xyz).reshape(tab.ne, tab.ndof, -1)
    U = np.asarray(js.mixture.conservatives(Up))
    jctx = dataclasses.replace(js.ctx, forcings=())
    jy, _ = jax.jit(lambda tab, U: jrhs.compute_rhs(jctx, tab, U, 0.0))(
        tab, jnp.asarray(U))
    ctx = dataclasses.replace(s.ctx, forcings=())
    y, _ = compute_rhs(ctx, s.tables, torch.as_tensor(U))
    return y, np.asarray(jy)


def test_exact_states_satisfy_bcs(tmp_path):
    """The manufactured wall and inflow/outflow states meet their BCs in
    the port's mixture (no-slip and the wall temperatures, the inlet's
    constants, the outlet's pressure), and the port's right-hand side with
    those BCs active equals tps_tpu's on them (2-D p=2, 4x4; 1e-11 per
    equation: the fluxes are summed in another order)."""
    s, js = _mms_pair(2, 4, mms.WALL_BCS, "periodic_x = 1", tmp_path)
    mix = s.mixture
    assert [type(b.bc).__name__ for b in s.bc_slices] == ["GeneralWallBC"] * 2
    for xv in (0.3, 2.1, 4.7):
        up0 = np.asarray(mms._wall_up_point(jnp.asarray([xv, 0.0])))
        assert abs(up0[1]) < 1e-12 and abs(up0[2]) < 1e-12
        assert abs(up0[3] - 300.0) < 1e-9 and abs(up0[5] - 300.0) < 1e-9
    y, jy = _rhs_pair(s, js, mms._wall_up_point)
    _cols_close(y, jy, 1e-11)

    rho0, YI0 = mms._inlet_consts()
    bcs = mms.INOUT_BCS.format(rho0=repr(rho0), u0=mms.U0, v0=mms.V0,
                               YI0=repr(YI0), p0=mms.P0)
    s, js = _mms_pair(2, 4, bcs, "periodic_y = 1", tmp_path)
    mix = s.mixture
    inlet = [b.bc for b in s.bc_slices if isinstance(b.bc, pbc.InletBC)]
    assert inlet[0].input_state == (rho0, mms.U0, mms.V0, YI0)
    for yv in (0.4, 2.2, 4.9):
        upi = np.asarray(mms._inout_up_point(jnp.asarray([0.0, yv])))
        assert abs(upi[0] - rho0) < 1e-12
        upo = mms._inout_up_point(jnp.asarray([mms.L, yv]))
        Uo = mix.conservatives(torch.as_tensor(np.asarray(upo))[None])
        assert abs(float(mix.pressure(Uo)[0]) - mms.P0) / mms.P0 < 1e-12
    y, jy = _rhs_pair(s, js, mms._inout_up_point)
    _cols_close(y, jy, 1e-11)


def _general_wall_slopes(js):
    """mms._solve_general_wall_slopes with its residual F compiled once
    (jax.jit) instead of dispatched op by op: the same three equations,
    the same solve and the same guard on the residual."""
    from tps_tpu.dg.bc import GeneralWallBC

    mix = js.mixture
    neq = mix.num_equations
    i_ion = mix.nvel + 2
    bc0 = GeneralWallBC(heavy="isothermal", electron="sheath",
                        wall_temp=300.0)
    bcL = GeneralWallBC(heavy="isothermal", electron="isothermal",
                        wall_temp=300.0, wall_temp_e=300.0)

    def F(params):
        up = mms._general_up_factory(*params)
        m0, _ = mms._wall_flux_mismatch(js, up, 1.234, 0.0, -1.0, bc0)
        mL, _ = mms._wall_flux_mismatch(js, up, 1.234, mms.L, 1.0, bcL)
        return jnp.asarray([m0[i_ion], m0[neq - 1], mL[i_ion]])

    p0 = jnp.zeros(3)
    J = jax.jit(jax.jacfwd(F))(p0)
    Fj = jax.jit(F)
    p = jnp.linalg.solve(J, -Fj(p0))
    res = np.asarray(Fj(p))
    assert np.abs(res).max() < 1e-8, res  # the linearity assumption
    return [float(v) for v in np.asarray(p)], bc0, bcL


def test_general_wall_sheath_exact_flux_match(tmp_path):
    """With tps_tpu's solved slopes, the port's sheath wall (y = 0) and
    isothermal general wall (y = L) prescribe the manufactured interior
    fluxes on every row (1e-10 of the interior flux, the JAX test's bar),
    and its wall and interior fluxes equal tps_tpu's (each JAX function
    compiled once with jax.jit)."""
    from tps_torch.dg.bc import _interior_visc_dot_n

    js = mms._build_general(2, 4)
    (a0, b0, aL), jbc0, jbcL = _general_wall_slopes(js)
    up = mms._general_up_factory(a0, b0, aL)
    text = mms.DECK
    for old, new in mms.GEN_SUBS:
        text = text.replace(old, new)
    path = tmp_path / "sheath.ini"
    path.write_text(text.format(order=2, n=4, L=mms.L, bcs=mms.GENERAL_BCS,
                                periodic="periodic_x = 1"))
    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", str(path), "--device",
                                 "cpu"])
    tps.parse_input()
    tps.config.outdir = str(tmp_path)
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    s = tps.solver
    bcs = {b.bc.electron: b.bc for b in s.bc_slices}
    assert set(bcs) == {"sheath", "isothermal"}
    mix = s.mixture
    ctx = dataclasses.replace(s.ctx, forcings=())
    i_ion = mix.nvel + 2
    for y0, ny, bc, jb in ((0.0, -1.0, bcs["sheath"], jbc0),
                           (mms.L, 1.0, bcs["isothermal"], jbcL)):
        mismatch = jax.jit(lambda xv: mms._wall_flux_mismatch(
            js, up, xv, y0, ny, jb))
        for xv in (0.4, 2.2, 4.1):
            x = jnp.asarray([xv, y0])
            Up = np.asarray(up(x))[None]
            g = np.asarray(jax.jacfwd(up)(x))[None]
            U = mix.conservatives(torch.as_tensor(Up))
            nor = torch.as_tensor([[0.0, ny]])
            Uw, Upw = bc._wall_state(mix, U, torch.as_tensor(Up))
            fvw = bc._wall_visc_general(ctx, Uw, Upw, torch.as_tensor(g), nor,
                                        None, None)[0]
            fvi = _interior_visc_dot_n(ctx.fluxes, U, torch.as_tensor(Up),
                                       torch.as_tensor(g), nor,
                                       torch.as_tensor([[xv, y0]]),
                                       torch.full((1, 1), 0.1))[0]
            ref = float(torch.abs(fvi).max())
            assert float(torch.abs(fvw - fvi).max()) / ref < 1e-10, (xv, y0)
            jm, jfvi = mismatch(xv)
            _close(fvi, jfvi)
            _close(fvw - fvi, jm, 1e-10 * ref / float(np.abs(jm).max()))
            if bc.electron == "sheath":
                assert abs(float(fvi[i_ion])) > 0.1  # a real Bohm outflux
