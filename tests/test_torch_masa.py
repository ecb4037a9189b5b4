"""The manufactured solutions of tps_torch == the JAX package's, on the CPU
in f64 (utils/masa.py, utils/mms.py, tools/compute_rhs.py).

1. masa_params: the four solutions' parameter sets, the fitted
   ad_cns_2d_sutherlands amplitudes and the deck overrides, equal to the
   JAX package's.
2. MasaHandler.exact_U and source_at (pointwise_source: nested
   torch.func.jacfwd through the fluxes, under vmap) at seeded points for
   all four solutions, the transient ones at t > 0; its forcing, the
   steady source made once per table and the transient one at a device
   time.
3. utils/mms.py: rhs_error, l2_norm, solution_error, primitive_errors and
   convergence_study on small periodic boxes.
4. tps_torch/tools/compute_rhs.py on the MMS decks cut to 6x6: the
   reference's TSV line, and on the cns deck the relative RHS errors
   against the JAX tool's rhs_rel_errors.

Bars relative to the JAX result's max: 1e-12 (module bar, PERF.md §2);
the RHS-error ratios are quotients of a small residual (the RHS of the
exact state is ~1e-2 of the source at 10x10, more at 6x6), held at
1e-10.
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from threadpoolctl import threadpool_limits

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
threadpool_limits(1)  # numpy's and scipy's BLAS too: one thread a worker

from tps_torch.dg.discretization import build_tables  # noqa: E402
from tps_torch.dg.fluxes import Fluxes  # noqa: E402
from tps_torch.dg.rhs import RHSContext  # noqa: E402
from tps_torch.dg.riemann import Rusanov  # noqa: E402
from tps_torch.mesh import generators  # noqa: E402
from tps_torch.physics.gas import DryAir  # noqa: E402
from tps_torch.physics.transport import DryAirTransport  # noqa: E402
from tps_torch.tools import compute_rhs as tool  # noqa: E402
from tps_torch.utils import masa, mms  # noqa: E402
from tps_tpu.dg.discretization import build_tables as jbuild_tables  # noqa: E402
from tps_tpu.dg.fluxes import Fluxes as JFluxes  # noqa: E402
from tps_tpu.dg.rhs import RHSContext as JRHSContext  # noqa: E402
from tps_tpu.dg.riemann import Rusanov as JRusanov  # noqa: E402
from tps_tpu.mesh import generators as jgenerators  # noqa: E402
from tps_tpu.physics.gas import DryAir as JDryAir  # noqa: E402
from tps_tpu.physics.transport import DryAirTransport as JDryAirTransport  # noqa: E402
from tps_tpu.utils import masa as jmasa  # noqa: E402
from tps_tpu.utils import mms as jmms  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-12
RATIO_TOL = 1e-10
SOLUTIONS = {"euler_2d": (2, "euler"),
             "ad_cns_2d_sutherlands": (2, "navier-stokes"),
             "euler_transient_3d": (3, "euler"),
             "navierstokes_3d_transient_sutherland": (3, "navier-stokes")}


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


def _handlers(name, visc_mult=1.0, bulk=0.0, overrides=None):
    """(port, JAX) MasaHandler of a solution on DryAir, with the deck's
    viscosity multiplier and bulk viscosity."""
    dim, eq = SOLUTIONS[name]
    rc = types.SimpleNamespace(visc_mult=visc_mult, bulk_visc_mult=bulk)
    mix, jmix = DryAir(dim=dim, nvel=dim), JDryAir(dim=dim, nvel=dim)
    tr = jtr = None
    if eq != "euler":
        tr = DryAirTransport(mix.gas_constant, mix.specific_heat_ratio,
                             visc_mult=visc_mult, bulk_visc_mult=bulk)
        jtr = JDryAirTransport(jmix.gas_constant, jmix.specific_heat_ratio,
                               visc_mult=visc_mult, bulk_visc_mult=bulk)
    h = masa.MasaHandler(name, mix, Fluxes(mixture=mix, transport=tr,
                                           eq_system=eq), rc=rc,
                         overrides=overrides)
    jh = jmasa.MasaHandler(name, jmix, JFluxes(mixture=jmix, transport=jtr,
                                               eq_system=eq), rc=rc,
                           overrides=overrides)
    return h, jh


# ------------------------------------------------------------ 1. parameters


@pytest.mark.parametrize("name", list(SOLUTIONS))
def test_params_match_jax(name):
    for kw in ({}, {"visc_mult": 2.0, "bulk_visc": 0.5},
               {"overrides": {"u_0": 150.0, "L": 2.5}}):
        assert masa.masa_params(name, **kw) == jmasa.masa_params(name, **kw)
    p = masa.masa_params("ad_cns_2d_sutherlands")
    assert (p["u_0"], p["p_0"], p["u_x"], p["u_y"]) == (70.0, 1e5, 1.5441,
                                                       1.8948)
    with pytest.raises(ValueError, match="unknown MASA parameter"):
        masa.masa_params(name, overrides={"no_such": 1.0})
    with pytest.raises(ValueError, match="not supported"):
        masa.masa_params("no_such_solution")


# --------------------------------------------------- 2. exact state, source


@pytest.mark.parametrize("name", list(SOLUTIONS))
def test_source_at_matches_jax(name):
    dim = SOLUTIONS[name][0]
    h, jh = _handlers(name, visc_mult=3.0, bulk=0.2,
                      overrides={"rho_x": 0.12})
    x = np.random.default_rng(11).uniform(0.0, 3.0, (3, 4, dim))
    tx, jx = torch.as_tensor(x), jnp.asarray(x)
    t = 1.3e-3 if h.transient else 0.0
    # the JAX package's functions compiled once (jax.jit), not dispatched
    # op by op
    assert _rel(h.exact_U(tx, t), jax.jit(jh.exact_U)(jx, t)) <= TOL
    want = jax.jit(jh.source_at)(jx, t)
    assert _rel(h.source_at(tx, t), want) <= TOL
    # the forcing: the steady source made once per table, the transient
    # one at the stage's device time
    tab = types.SimpleNamespace(xyz_dof=tx)
    f = h.make_forcing(tab)
    got = f(torch.tensor(t), tab, tx[..., :1], None, None)
    assert _rel(got, want) <= TOL
    if not h.transient:
        assert f(t, tab, tx[..., :1], None, None) is got


# ---------------------------------------------------------------- 3. mms.py


def _box(n, order=2, L=3.02):
    kw = dict(nx=n, ny=n, x1=L, y1=L, periodic_x=True, periodic_y=True)
    return (build_tables(generators.box_2d(**kw), order=order).to_torch(
                torch.float64, "cpu"),
            jbuild_tables(jgenerators.box_2d(**kw), order=order).to_jax(
                jnp.float64))


def test_rhs_error_and_norms_match_jax():
    """rhs_error of euler_2d's exact field (Euler, Rusanov) on a periodic
    4x4 p=2 box, the convergence study's last level, the L2 norms and the
    solution and primitive errors."""
    h, jh = _handlers("euler_2d")
    tab, jtab = _box(4)
    fl, jfl = h.fluxes, jh.fluxes
    ctx = RHSContext(fluxes=fl, riemann=Rusanov(fl))
    err, per = mms.rhs_error(ctx, tab, h.up_fn)
    jctx = JRHSContext(fluxes=jfl, riemann=JRusanov(jfl))
    jerr, jper = jax.jit(lambda jtab: jmms.rhs_error(jctx, jtab, jh.up_fn))(
        jtab)
    assert _rel(err, jerr) <= RATIO_TOL and _rel(per, jper) <= RATIO_TOL
    res, orders = mms.convergence_study(lambda n: (ctx, _box(n)[0]),
                                        h.up_fn, (2, 4))
    assert res[1][0] == 4 and _rel(np.array(res[1][1]), jerr) <= RATIO_TOL
    assert orders == [np.log(res[0][1] / res[1][1]) / np.log(2.0)]
    U = h.exact_U(tab.xyz_dof) * 1.001
    jU = jh.exact_U(jtab.xyz_dof) * 1.001
    assert _rel(mms.l2_norm(tab, U), jmms.l2_norm(jtab, jU)) <= TOL
    assert _rel(mms.solution_error(tab, h.mix, U, h.up_fn, 0.0),
                jmms.solution_error(jtab, jh.mix, jU, jh.up_fn, 0.0)) <= 1e-10
    # primitive errors against the JAX state's, in numpy
    got = mms.primitive_errors(tab, h.mix, U, h.up_fn, 0.0)
    Up, Upx = np.asarray(jh.mix.primitives(jU)), np.asarray(
        jh.up_fn(jtab.xyz_dof, 0.0))
    B, w = np.asarray(jtab.Bvol), np.asarray(jtab.wq)[None] * np.asarray(
        jtab.detJ)

    def l2(f):
        fq = np.einsum("qd,nd->nq", B, f)
        return np.sqrt(np.sum(w * fq * fq))

    R = jh.mix.gas_constant
    want = (l2(Up[..., 0] - Upx[..., 0]),
            np.sqrt(sum(l2(Up[..., k] - Upx[..., k]) ** 2 for k in (1, 2))),
            l2(R * (Up[..., 0] * Up[..., 3] - Upx[..., 0] * Upx[..., 3])))
    assert _rel(np.array(got), np.array(want)) <= 1e-10


# ------------------------------------------------------- 4. compute_rhs tool


def _small_deck(tmp_path, ini, n):
    src = open(os.path.join(HERE, "inputs", ini)).read()
    src = src.replace(f"nx = {n}", "nx = 6").replace(f"ny = {n}", "ny = 6")
    report = tmp_path / f"{ini}.rhs_error.txt"
    src = src.replace("outdirBase = output", f"outdirBase = {tmp_path}")
    src = "\n".join(
        f"filename = {report}" if line.startswith("filename =") else line
        for line in src.splitlines())
    path = tmp_path / f"small_{ini}"
    path.write_text(src)
    return str(path), report


def test_compute_rhs_tool_matches_jax(tmp_path):
    """The cns deck (Navier-Stokes, Sutherland) against the JAX tool; the
    euler deck's RHS is held to the JAX package's by
    test_rhs_error_and_norms_match_jax and tests/test_torch_forcing_decks.py,
    here its report line."""
    sys.path.insert(0, os.path.join(HERE, os.pardir))
    from tools.compute_rhs import rhs_rel_errors as jrhs_rel_errors
    from tps_tpu.harness import Tps as JTps

    for ini, n in (("mms.euler.2d.quad.ini", 160), ("mms.cns.2d.quad.ini", 80)):
        path, report = _small_deck(tmp_path, ini, n)
        assert tool.main(["--runFile", path, "--device", "cpu"]) == 0
        cols = report.read_text().strip().split("\t")
        assert cols[0] == "36" and len(cols) == 4
        errs = [float(c) for c in cols[1:]]
        assert all(e > 0 for e in errs)
    jt = JTps()
    jt.input_file = path
    jt.parse_input()
    jt.choose_devices()
    jt.choose_solver()
    jt.initialize()
    jerrs, jne = jrhs_rel_errors(jt.solver)
    assert jne == 36 and len(jerrs) == 3
    # the report line carries 6 significant digits (%.6g)
    assert _rel(np.array(errs), np.array(jerrs)) <= 1e-5
    s = tool.build_solver(path, "cpu")
    exact, ne = tool.rhs_rel_errors(s)
    assert ne == 36 and _rel(np.array(exact), np.array(jerrs)) <= RATIO_TOL
    jax.clear_caches()


def test_compute_rhs_tool_needs_mms(tmp_path):
    path, _ = _small_deck(tmp_path, "mms.euler.2d.quad.ini", 160)
    text = open(path).read().replace("isEnabled = True", "isEnabled = False")
    open(path, "w").write(text)
    with pytest.raises(SystemExit, match="requires"):
        tool.run_file_mode(path, "cpu")
