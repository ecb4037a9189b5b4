"""tps_torch's LTE tables and thermo-chemistry against the JAX package's,
on the CPU in f64.

- LinearTable (plain, x_log, f_log, both; values and df/dx, inside and
  outside the table's range), Table2D and `_eval2`: bit for bit (the same
  segment coefficients, the same searchsorted), except that an f_log
  table's exp, a library function, may round its last bit otherwise
  (held to 4e-16 relative);
- `read_table_input` from an HDF5 file written with io/h5lite.py (the
  JAX package reads it through h5py) and from inline x/f lists;
- NetEmission on an f_log table: within 4e-16 (its exp);
- LteThermoChem over 3 steps, planar and radius-weighted, with a dense
  refresh inside the run (the refresh period cut to 2 in both packages)
  and with the Jacobi path (dense cutoff 0): T and Qt to 1e-10 of max;
- the calorically-perfect thermo with the radius weight: one step, 1e-10.

Every solve runs to its relative tolerance (1e-12 here), so solver
noise, not rounding, sets the 1e-10 bound.
"""

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
threadpool_limits(1)  # numpy's and scipy's BLAS too: one thread a worker

import jax.numpy as jnp  # noqa: E402

from tps_torch.config.ini import IniInput  # noqa: E402
from tps_torch.fem import h1  # noqa: E402
from tps_torch.io import h5lite  # noqa: E402
from tps_torch.physics import plasma_config, radiation, tables  # noqa: E402
from tps_torch.solvers.lomach import base as tbase  # noqa: E402
from tps_torch.solvers.lomach import lte_thermo as tlte  # noqa: E402
from tps_torch.solvers.lomach import thermo_chem as tthermo  # noqa: E402
from tps_tpu.config.ini import IniInput as JIniInput  # noqa: E402
from tps_tpu.fem import h1 as jh1  # noqa: E402
from tps_tpu.mesh.generators import box_2d as jbox_2d  # noqa: E402
from tps_tpu.physics import lte as jlte_phys  # noqa: E402
from tps_tpu.physics import plasma_config as jplasma_config  # noqa: E402
from tps_tpu.physics import radiation as jradiation  # noqa: E402
from tps_tpu.physics import tables as jtables  # noqa: E402
from tps_tpu.solvers.lomach import base as jbase  # noqa: E402
from tps_tpu.solvers.lomach import lte_thermo as jlte  # noqa: E402
from tps_tpu.solvers.lomach import thermo_chem as jthermo  # noqa: E402

F64 = torch.float64
SOLVE_TOL = 1e-10


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(autouse=True)
def f64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(F64)
    yield
    torch.set_default_dtype(prev)


# ----------------------------------------------------------------- tables

def _same(a, b, f_log):
    """Bit for bit, or within the last bit of an exp where f_log."""
    a, b = a.numpy(), np.asarray(b)
    if f_log:
        np.testing.assert_allclose(a, b, rtol=4e-16, atol=0)
    else:
        np.testing.assert_array_equal(a, b)


XS = np.linspace(300.0, 20000.0, 57)
FS = 1e-3 + (XS / 3000.0) ** 2.5
# inside, on the knots, and outside the range at both ends
QUERY = np.concatenate([np.linspace(150.0, 25000.0, 97), XS[::7]])


@pytest.mark.parametrize("x_log,f_log", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_linear_table_matches_bitwise(x_log, f_log):
    ours = tables.LinearTable(x=XS, f=FS, x_log=x_log, f_log=f_log)
    ref = jtables.LinearTable(x=XS, f=FS, x_log=x_log, f_log=f_log)
    q = torch.as_tensor(QUERY)
    _same(ours(q), ref(jnp.asarray(QUERY)), f_log)
    _same(ours.deriv(q), ref.deriv(jnp.asarray(QUERY)), f_log)


def test_table2d_and_eval2_match_bitwise():
    rng = np.random.default_rng(3)
    x, y = np.linspace(0.0, 1.0, 9), np.linspace(-1.0, 2.0, 7)
    f = rng.standard_normal((9, 7))
    xq, yq = rng.uniform(-0.2, 1.2, 50), rng.uniform(-1.5, 2.5, 50)
    ours, ref = tables.Table2D(x, y, f), jtables.Table2D(x, y, f)
    tq = (torch.as_tensor(xq), torch.as_tensor(yq))
    np.testing.assert_array_equal(
        tables._eval2(ours, *tq).numpy(),
        np.asarray(jlte_phys._eval2(ref, jnp.asarray(xq), jnp.asarray(yq))))
    lin, jlin = tables.LinearTable(XS, FS), jtables.LinearTable(XS, FS)
    np.testing.assert_array_equal(
        tables._eval2(lin, torch.as_tensor(QUERY), None).numpy(),
        np.asarray(jlte_phys._eval2(jlin, jnp.asarray(QUERY), None)))


def _table_ini(tmp_path, form):
    prefix = "plasma_models/radiation_model/net_emission/tabulated"
    body = f"[{prefix}]\n"
    if form == "file":
        path = tmp_path / "nec.h5"
        h5lite.write(str(path), {"table": np.stack([XS, FS], axis=1)})
        body += f"filename = {path}\n"
    else:
        body += ("x = '" + " ".join(repr(float(v)) for v in XS[:9]) + "'\n"
                 "f = '" + " ".join(repr(float(v)) for v in FS[:9]) + "'\n")
    body += "f_log = 1\n"
    (tmp_path / "t.ini").write_text(body)
    return str(tmp_path / "t.ini"), prefix


@pytest.mark.parametrize("form", ["file", "inline"])
def test_read_table_input_and_net_emission_match(tmp_path, form):
    path, prefix = _table_ini(tmp_path, form)
    ours = plasma_config.read_table_input(IniInput.read(path), prefix)
    ref = jplasma_config.read_table_input(JIniInput.read(path), prefix)
    np.testing.assert_array_equal(ours.x, ref.x)
    np.testing.assert_array_equal(ours.f, ref.f)
    assert (ours.x_log, ours.f_log) == (ref.x_log, ref.f_log) == (False, True)
    _same(radiation.NetEmission(ours).energy_sink(torch.as_tensor(QUERY)),
          jradiation.NetEmission(ref).energy_sink(jnp.asarray(QUERY)), True)


# ----------------------------------------------------------------- thermo

T_GRID = np.linspace(200.0, 20000.0, 199)


def _lte_tables(mod):
    """Both packages' property tables from the same numpy columns (the
    LTE table of tests/test_coupling.py, with a net emission)."""
    T = T_GRID
    cols = dict(
        rho_table=101325.0 / (287.0 * T), cp_table=np.full_like(T, 1004.0),
        mu_table=1.8e-5 * (T / 300.0) ** 0.7,
        kappa_table=0.025 * (T / 300.0) ** 0.8,
        sigma_table=np.where(T > 6000.0, 50.0 * (T - 6000.0) / 14000.0, 0.0))
    out = {k: mod.LinearTable(x=T, f=v) for k, v in cols.items()}
    return out, mod.LinearTable(x=T, f=1e3 * (T / 1e4) ** 4)


class _Frozen:
    """A frozen velocity field."""

    def __init__(self, u):
        self._u = u

    def velocity(self):
        return self._u


@pytest.fixture(scope="module")
def lte_case():
    """A 6x4 p=2 (r, z) column on both packages' tables, its state."""
    tab_np = jh1.build_h1(jbox_2d(6, 4, x1=0.02, y1=0.01), 2)
    xyz = np.asarray(tab_np.xyz)
    T0 = 300.0 + 7700.0 * np.exp(-(xyz[:, 0] / 0.008) ** 2
                                 - ((xyz[:, 1] - 0.005) / 0.004) ** 2)
    vel = np.stack([0.3 * np.sin(60 * xyz[:, 1]), 1.0 + 20 * xyz[:, 0]], -1)
    qj = 1e8 * np.exp(-(xyz[:, 0] / 0.005) ** 2)
    return tab_np, T0, vel, qj


@pytest.mark.parametrize("weighted,dense", [(False, True), (True, True),
                                            (True, False)])
def test_lte_thermo_steps_match(monkeypatch, lte_case, weighted, dense):
    tab_np, T0, vel, qj = lte_case
    monkeypatch.setattr(tlte.LteThermoChem, "_PRECOND_REFRESH", 2)
    monkeypatch.setattr(jlte.LteThermoChem, "_PRECOND_REFRESH", 2)
    if not dense:
        monkeypatch.setattr(h1, "DENSE_DIRECT_MAX", 0)
        monkeypatch.setattr(jh1, "DENSE_DIRECT_MAX", 0)
    tt = h1.h1_tables_from_numpy(tab_np).to_torch(F64, "cpu")
    tj = tab_np.to_jax(jnp.float64)
    models = []
    for mod, tmod, tab, arr in ((tlte, tables, tt, torch.as_tensor),
                                (jlte, jtables, tj, jnp.asarray)):
        props, nec = _lte_tables(tmod)
        rad = (radiation if mod is tlte else jradiation).NetEmission(nec)
        th = (tthermo if mod is tlte else jthermo).TemperatureDirichlet
        m = mod.LteThermoChem(
            tab, flow=_Frozen(arr(vel)), radiation=rad, **props,
            temp_bcs=(th((2,), 300.0),), qt_bcs=((2,),),
            weight_q=tab.xyz_q[..., 0] if weighted else None, cg_tol=1e-12)
        m.set_temperature(arr(T0))
        m.set_joule_heating(arr(qj))
        models.append(m)
    ours, ref = models
    dt = 2.5e-6
    for _ in range(3):  # refreshes at steps 1 and 3 (dense)
        ours.precond_refresh(dt, 2)
        if ours._direct_age is not None:
            ours._direct_age += 1
        ours.step(tbase.TemporalCoefficients.bdf(2), dt)
        ref.step(jbase.TemporalCoefficients.bdf(2), dt)
    assert ours.refreshes == (2 if dense else 0)
    assert _rel(ours.T, ref.T) < SOLVE_TOL
    assert _rel(ours.Qt, ref.Qt) < SOLVE_TOL
    assert _rel(ours.plasma_conductivity(), ref.plasma_conductivity()) \
        < 1e-14
    for name in ("density", "viscosity", "conductivity"):
        assert _rel(getattr(ours, name)(), getattr(ref, name)()) < 1e-14


def test_calorically_perfect_radius_weight_matches(lte_case):
    tab_np, _, vel, _ = lte_case
    tt = h1.h1_tables_from_numpy(tab_np).to_torch(F64, "cpu")
    tj = tab_np.to_jax(jnp.float64)
    xyz = np.asarray(tab_np.xyz)
    T0 = 300.0 + 40.0 * np.cos(150 * xyz[:, 0]) * np.sin(300 * xyz[:, 1])
    models = []
    for mod, tab, arr in ((tthermo, tt, torch.as_tensor),
                          (jthermo, tj, jnp.asarray)):
        m = mod.CaloricallyPerfectThermoChem(
            tab, flow=_Frozen(arr(vel)), T_init=300.0,
            temp_bcs=(mod.TemperatureDirichlet((2,), 350.0),),
            qt_bcs=((2,),), weight_q=tab.xyz_q[..., 0], sw_stab=True)
        m.set_temperature(arr(T0))
        models.append(m)
    ours, ref = models
    ours.step(tbase.TemporalCoefficients.bdf(1), 2e-3)
    ref.step(jbase.TemporalCoefficients.bdf(1), 2e-3)
    assert _rel(ours.T, ref.T) < SOLVE_TOL
    assert _rel(ours.Qt, ref.Qt) < SOLVE_TOL
