"""The LTE-table fluid of tps_torch (physics/lte.py, `fluid = lte_table` on
the compressible solver) against the JAX package's, on the CPU in f64.

- LteMixture and LteTransport on the committed 1-D tables
  (tps_torch/tools/lte_argon_*.h5) and on 2-D (T, rho) whitespace tables
  (tps_torch/tools/lte_argon_tables.py::write_2d):
  temperature, pressure, primitives and conservatives, sound speeds, the
  BC helpers, mu, kappa and sigma to 1e-12 of max; load_lte_setup's
  tables equal to tps_tpu's from the same files.
- The slot RHS on a walled 8x8 p=2 box (inlet, pressure outlet,
  isothermal walls on Navier-Stokes, slip walls on Euler, where neither
  package has a gradient for the isothermal wall's viscous flux), with
  net emission and a Joule field, against tps_tpu's compute_rhs to 1e-11
  of max.  tps_tpu's LTE BC helpers read the table's R(300 K) as a host
  float, which its jitted step cannot trace (its LTE decks run only
  periodic boxes and adiabatic or slip walls), so its RHS is jitted here
  with that float taken once, eagerly, beforehand.
- The face sweep's plain version on the LTE fluid (1-D and 2-D tables,
  2-D and 3-D, NS and Euler) against the JAX slot path's interior-face
  sum; the wrapper on CPU tensors is that plain version; the gate, the
  variant names and the packed constants.
- The periodic 2-D-table box (NS, Euler) and the 3-D LTE box through the
  port's solver.
The coupled deck is held in tests/test_torch_lte_coupled.py.
- tps_torch.physics.lte imports with no jax.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tps_torch.config.ini import IniInput  # noqa: E402
from tps_torch.config.run_config import parse_run_configuration  # noqa: E402
from tps_torch.dg import cuda_faces  # noqa: E402
from tps_torch.dg.cuda_faces import build_face_sweep  # noqa: E402
from tps_torch.dg.discretization import build_tables  # noqa: E402
from tps_torch.dg.fluxes import Fluxes  # noqa: E402
from tps_torch.dg.operators import dg_gradient, face_sweep_plain  # noqa: E402
from tps_torch.dg.rhs import RHSContext, compute_rhs  # noqa: E402
from tps_torch.dg.riemann import Rusanov  # noqa: E402
from tps_torch.mesh.generators import box_2d, box_3d  # noqa: E402
from tps_torch.physics.lte import load_lte_setup  # noqa: E402
from tps_torch.solvers.compressible import CompressibleSolver  # noqa: E402
from tps_torch.tools.lte_argon_tables import lte_keys, write_2d  # noqa: E402
from tps_tpu.config.ini import IniInput as JIniInput  # noqa: E402
from tps_tpu.config.run_config import \
    parse_run_configuration as jparse  # noqa: E402
from tps_tpu.dg import operators as jops  # noqa: E402
from tps_tpu.dg import rhs as jrhs  # noqa: E402
from tps_tpu.dg.discretization import build_tables as jbuild_tables  # noqa: E402
from tps_tpu.dg.fluxes import Fluxes as JFluxes  # noqa: E402
from tps_tpu.dg.riemann import Rusanov as JRusanov  # noqa: E402
from tps_tpu.mesh.generators import box_2d as jbox_2d  # noqa: E402
from tps_tpu.mesh.generators import box_3d as jbox_3d  # noqa: E402
from tps_tpu.physics.lte import load_lte_setup as jload  # noqa: E402
from tps_tpu.solvers.compressible import \
    CompressibleSolver as JCompressibleSolver  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
NEC = os.path.join(REPO, "examples", "cases", "nec_table.h5")
TOL = 1e-12
RHS_TOL = 1e-11


@pytest.fixture(autouse=True)
def f64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _per_eq(a, b):
    """Each equation relative to its own max, the worst."""
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return max(_rel(a[..., q], np.asarray(b)[..., q])
               for q in range(a.shape[-1]))


@pytest.fixture(scope="module")
def t2dir(tmp_path_factory):
    """A directory with 2-D (T, rho) tables of the equilibrium argon
    (tps_torch/tools/lte_argon_tables.py::write_2d, on a coarse grid),
    written once."""
    d = str(tmp_path_factory.mktemp("lte2d"))
    write_2d(d, nT=80, ne=120)
    return d


def _setups(table_dim, d, dim=2):
    inp = IniInput.parse(lte_keys(table_dim, d))
    jinp = JIniInput.parse(lte_keys(table_dim, d))
    return load_lte_setup(inp, dim, dim), jload(jinp, dim, dim)


def _states(mix, n, seed, dim=2):
    """Conserved states [n, dim + 2] of the JAX mixture near 9,500 K, some
    cold, some hot, rho around 0.05."""
    rng = np.random.default_rng(seed)
    Up = np.zeros((n, dim + 2))
    Up[:, 0] = 0.05 * (1.0 + 0.3 * rng.standard_normal(n)).clip(0.3)
    Up[:, 1:1 + dim] = 40.0 * rng.standard_normal((n, dim))
    Up[:, -1] = rng.choice([400.0, 6000.0, 9500.0, 14000.0], n) * (
        1.0 + 0.05 * rng.standard_normal(n))
    return np.asarray(mix.conservatives(jnp.asarray(Up)))


# ------------------------------------------------------------ the modules


@pytest.mark.parametrize("table_dim", [1, 2])
def test_mixture_and_transport_match_jax(table_dim, t2dir):
    (mix, tr), (jmix, jtr) = _setups(table_dim, t2dir)
    names = ("energy_table", "R_table", "c_table", "T_table")
    for t, jt in [(getattr(mix, k), getattr(jmix, k)) for k in names] + [
            (getattr(tr, k), getattr(jtr, k)) for k in (
                "mu_table", "kappa_table", "sigma_table")]:
        for f in ("x", "y", "f"):
            if hasattr(jt, f):
                assert np.array_equal(getattr(t, f), np.asarray(getattr(jt, f)))
    U = _states(jmix, 400, table_dim)
    Ut, Uj = torch.as_tensor(U), jnp.asarray(U)
    for fn in ("temperature", "pressure", "max_char_speed", "primitives"):
        assert _rel(getattr(mix, fn)(Ut), getattr(jmix, fn)(Uj)) <= TOL, fn
    Up = np.asarray(jmix.primitives(Uj))
    assert _per_eq(mix.conservatives(torch.as_tensor(Up)),
                   jmix.conservatives(jnp.asarray(Up))) <= TOL
    assert _rel(mix.pressure_from_primitives(torch.as_tensor(Up)),
                jmix.pressure_from_primitives(jnp.asarray(Up))) <= TOL
    T = torch.as_tensor(Up[:, -1])
    assert _rel(mix.sound_speed_from_T(T),
                jmix.sound_speed_from_T(jnp.asarray(Up[:, -1]))) <= TOL
    assert mix.gas_constant == float(jmix.gas_constant)
    assert mix.specific_heat_ratio == float(jmix.specific_heat_ratio)
    assert _per_eq(mix.stagnant_state_with_temp(Ut, 9000.0),
                   jmix.stagnant_state_with_temp(Uj, 9000.0)) <= TOL
    p = np.linspace(9e4, 1.1e5, 400)
    assert _per_eq(mix.modify_energy_for_pressure(Ut, torch.as_tensor(p)),
                   jmix.modify_energy_for_pressure(Uj, jnp.asarray(p))) <= TOL
    assert _per_eq(mix.modify_energy_for_pressure(Ut, 101325.0),
                   jmix.modify_energy_for_pressure(Uj, 101325.0)) <= TOL
    G = torch.zeros(400, 4, 2)
    props = tr.flux_properties(mix, Ut, mix.primitives(Ut), G)
    jprops = jtr.flux_properties(jmix, Uj, jmix.primitives(Uj),
                                 jnp.zeros((400, 4, 2)))
    for k in ("visc", "kappa", "bulk_visc", "kappa_e"):
        assert np.allclose(props[k].numpy(), np.asarray(jprops[k]),
                           rtol=TOL, atol=0), k
    assert props["diff_vel"] is None
    sig = tr.source_properties(Ut, mix.primitives(Ut), G)["sigma"]
    jsig = jtr.source_properties(Uj, jmix.primitives(Uj), None)["sigma"]
    assert float(np.asarray(jsig).max()) > 0 and _rel(sig, jsig) <= TOL


def test_table_dim_must_be_1_or_2():
    inp = IniInput.parse(lte_keys(1).replace("table_dim = 1",
                                                    "table_dim = 3"))
    with pytest.raises(ValueError, match="table_dim must be 1 or 2"):
        load_lte_setup(inp, 2, 2)


# ------------------------------------------------------------ the RHS

WALLED = """
[solver]
type = flow
[flow]
order = 2
maxIters = 1
outputFreq = 100000
fluid = lte_table
equation_system = {eq}
[mesh]
generator = box2d
nx = 8
ny = 8
x1 = 0.01
y1 = 0.01
[time]
integrator = rk4
dt_fixed = 1e-9
enableConstantTimestep = 1
[initialConditions]
rho = 0.0507
rhoU = 0.0
rhoV = 0.507
rhoW = 0.0
pressure = 100245.6
{lte}
[plasma_models]
radiation_model = net_emission
[plasma_models/radiation_model/net_emission/tabulated]
filename = {nec}
[boundaryConditions]
numWalls = 2
numInlets = 1
numOutlets = 1
[boundaryConditions/inlet1]
patch = 1
type = subsonic
density = 0.0507
uvw = '0 10 0'
[boundaryConditions/outlet1]
patch = 3
type = subsonicPressure
pressure = 101250
[boundaryConditions/wall1]
patch = 2
type = {wall}
temperature = 6000.0
[boundaryConditions/wall2]
patch = 4
type = {wall}
temperature = 6000.0
[io]
outdirBase = {out}
"""


def _solvers(text, tmp_path):
    path = tmp_path / "deck.ini"
    path.write_text(text)
    rc = parse_run_configuration(IniInput.read(str(path)))
    rc.outdir = str(tmp_path / "out")
    s = CompressibleSolver(rc, device="cpu")
    s.initialize()
    jrc = jparse(JIniInput.read(str(path)))
    jrc.outdir = str(tmp_path / "jax")
    js = JCompressibleSolver(jrc)
    js.initialize()
    return s, js


def _perturbed(js, seed):
    """tps_tpu's initial state with a wave in density, velocity and T."""
    mix = js.mixture
    xyz = np.asarray(js.tables.xyz_dof)
    k = 2 * np.pi / 0.01
    wave = np.sin(k * xyz[..., 0]) * np.cos(k * xyz[..., 1])
    Up = np.array(mix.primitives(js.U))
    Up[..., 0] *= 1.0 + 0.05 * wave
    Up[..., 1] += 20.0 * wave
    Up[..., -1] *= 1.0 + 0.1 * np.random.default_rng(seed).random(
        wave.shape) * wave
    return np.asarray(mix.conservatives(jnp.asarray(Up)))


@pytest.mark.parametrize("eq,wall", [("navier-stokes", "viscous_isothermal"),
                                     ("euler", "slip")])
def test_walled_rhs_matches_jax(eq, wall, tmp_path, monkeypatch):
    s, js = _solvers(WALLED.format(eq=eq, wall=wall, lte=lte_keys(1),
                                   nec=NEC, out=tmp_path), tmp_path)
    kinds = sorted(type(b.bc).__name__ for b in s.bc_slices)
    assert kinds == ["InletBC", "OutletBC", "WallBC", "WallBC"]
    assert type(s.mixture).__name__ == "LteMixture"
    U = _perturbed(js, 0)
    q = np.random.default_rng(1).uniform(-1e8, 1e9, U.shape[:-1])
    s.set_joule_heating(q)
    js.set_joule_heating(q)
    y, aux = compute_rhs(s.ctx, s.tables, torch.as_tensor(U))
    # tps_tpu's background R and gamma, taken eagerly (as its own eager
    # RHS takes them), so that its RHS can be jitted
    jmix = js.mixture
    consts = {k: float(getattr(jmix, k))
              for k in ("gas_constant", "specific_heat_ratio")}
    assert consts == {"gas_constant": s.mixture.gas_constant,
                      "specific_heat_ratio": s.mixture.specific_heat_ratio}
    for k, v in consts.items():
        monkeypatch.setattr(type(jmix), k, property(lambda self, v=v: v))
    jy, jaux = jax.jit(lambda tab, U, f: jrhs.compute_rhs(
        js.ctx, tab, U, 0.0, fields=f))(js.tables, jnp.asarray(U), js.fields)
    assert _per_eq(y, jy) <= RHS_TOL
    assert _rel(aux["max_char_speed"], jaux["max_char_speed"]) <= TOL
    # the conductivity the coupling reads: the sigma table at each node
    sig = s.evaluate_plasma_conductivity()
    assert float(sig.max()) > 0
    assert _rel(sig, js.evaluate_plasma_conductivity()) <= TOL


# ------------------------------------------------------------ face sweep


def _box(n, dim, periodic=True, order=2):
    if dim == 2:
        return (box_2d(*n, x1=0.01, y1=0.01, periodic_x=periodic,
                       periodic_y=periodic),
                jbox_2d(*n, x1=0.01, y1=0.01, periodic_x=periodic,
                        periodic_y=periodic))
    b = ((0.0, 0.01),) * 3
    return (box_3d(*n, bounds=b, periodic=(periodic,) * 3),
            jbox_3d(*n, bounds=b, periodic=(periodic,) * 3))


def _face_case(table_dim, dim, eq, t2dir, n=None):
    (mix, tr), (jmix, jtr) = _setups(table_dim, t2dir, dim)
    n = n or ((3, 4) if dim == 2 else (2, 2, 3))
    mesh, jmesh = _box(n, dim)
    tab_np, jtab_np = build_tables(mesh, 2), jbuild_tables(jmesh, 2)
    fl = Fluxes(mixture=mix, transport=None if eq == "euler" else tr,
                eq_system=eq)
    ctx = RHSContext(fluxes=fl, riemann=Rusanov(fl))
    jfl = JFluxes(mixture=jmix, transport=None if eq == "euler" else jtr,
                  eq_system=eq)
    xyz = tab_np.xyz_dof
    k = 2 * np.pi / 0.01
    wave = np.sin(k * xyz[..., 0]) * np.cos(k * xyz[..., 1])
    Up = np.zeros(xyz.shape[:2] + (dim + 2,))
    Up[..., 0] = 0.05 * (1 + 0.1 * wave)
    Up[..., 1] = 10.0 + 30.0 * wave
    Up[..., 2:1 + dim] = -5.0 * wave[..., None]
    Up[..., -1] = 9500.0 * (1 + 0.2 * wave)
    U = torch.as_tensor(np.asarray(jmix.conservatives(jnp.asarray(Up))))
    tab = tab_np.to_torch(torch.float64, "cpu")
    X = U
    if eq != "euler":
        G = dg_gradient(tab, mix.primitives(U))
        X = torch.cat([U, G.reshape(tab_np.ne, tab_np.ndof, -1)], -1)
    return tab, jtab_np, ctx, jmix, jfl, X.contiguous()


def _jax_face_sum(jtab_np, jmix, jfl, X):
    """The JAX package's slot-path interior face flux (tps_tpu dg/rhs.py:
    143-178) on X: minus the sum over local faces of Btr_lf^T (Rusanov -
    the mean viscous normal flux) x the interior mask.  The pointwise flux
    is one jitted function that every face reuses (one compile)."""
    ne, ndof, _ = X.shape
    neq, nqf, nlf, dim = jmix.num_equations, jtab_np.nqf, jtab_np.nlf, \
        jtab_np.dim
    viscous = jfl.eq_system != "euler"
    riem = JRusanov(jfl)

    @jax.jit
    def flux(o, b, nor):
        U1, U2 = o[..., :neq], b[..., :neq]
        f = riem(U1, U2, nor)
        if viscous:
            g1 = o[..., neq:].reshape(ne, nqf, neq, dim)
            g2 = b[..., neq:].reshape(ne, nqf, neq, dim)
            Fv = (jfl.viscous(U1, jmix.primitives(U1), g1)
                  + jfl.viscous(U2, jmix.primitives(U2), g2))
            f = f - jnp.einsum("...ed,...d->...e", 0.5 * Fv, nor)
        return f

    jtab = jtab_np.to_jax(jnp.float64)
    own, nbr = jops.perface_traces(jtab, jnp.asarray(X.numpy()))
    z = np.zeros((ne, ndof, neq))
    for lf in range(nlf):
        f = np.asarray(flux(own[lf].reshape(ne, nqf, -1),
                            nbr[lf].reshape(ne, nqf, -1),
                            jtab.nor_wpf[lf].reshape(ne, nqf, dim)))
        f = f * np.asarray(jtab_np.interior_mask)[:, lf, None, None]
        B = np.asarray(jtab_np.Btr)[lf * nqf:(lf + 1) * nqf]
        z = z - np.einsum("sj,esq->ejq", B, f)
    return z


@pytest.mark.parametrize("table_dim,dim,eq", [
    (1, 2, "navier-stokes"), (1, 2, "euler"), (2, 2, "navier-stokes"),
    (1, 3, "navier-stokes"), (2, 3, "euler")])
def test_face_sweep_plain_matches_jax(table_dim, dim, eq, t2dir):
    tab, jtab_np, ctx, jmix, jfl, X = _face_case(table_dim, dim, eq, t2dir)
    z = face_sweep_plain(ctx, tab, X)
    assert _per_eq(z, _jax_face_sum(jtab_np, jmix, jfl, X)) <= RHS_TOL
    # the wrapper on CPU tensors is the plain version, no launch
    sweep = build_face_sweep(tab, ctx)
    cuda_faces.reset_launches()
    assert torch.equal(sweep(X), z)
    assert cuda_faces.launches["face_sweep"] == 0
    want = (f"lte_{dim}d" + ("_t2" if table_dim == 2 else "")
            + ("_euler" if eq == "euler" else ""))
    assert (sweep.physics, sweep.variant) == ("lte", want)
    assert want in cuda_faces.VARIANTS


def test_face_sweep_gate_and_packed_constants():
    tab, _, ctx, _, _, _ = _face_case(1, 2, "navier-stokes", None)
    tab_np = build_tables(box_2d(3, 4, x1=0.01, y1=0.01, periodic_x=True,
                                 periodic_y=True), 2)
    assert cuda_faces.face_sweep_supported(tab_np, ctx)
    assert cuda_faces.lte_table_dim(ctx) == 1
    mix = ctx.mixture
    vals = cuda_faces.lte_phys(ctx, torch.float32, "cpu")
    # dim, Newton count, then six tables of (3 addresses, n, xlog, flog)
    assert len(vals) == 2 + 6 * 6 and vals[:2] == [1.0, 20.0]
    x, a, b = (mix.energy_table._dev[(torch.float32, torch.device("cpu"))])
    assert vals[2:8] == [float(x.data_ptr()), float(a.data_ptr()),
                         float(b.data_ptr()), float(len(x)), 0.0, 0.0]
    assert a.dtype == torch.float32 and len(a) == len(x) - 1
    # tables of mixed kinds, or a transport other than the tables', are
    # outside the gate
    from tps_torch.physics.lte import LteTransport
    from tps_torch.physics.tables import Table2D
    from tps_torch.physics.transport import ConstantTransport

    t2 = Table2D(x=np.arange(3.0), y=np.arange(2.0), f=np.zeros((3, 2)))
    tr = ctx.fluxes.transport
    for bad in (LteTransport(mu_table=t2, kappa_table=tr.kappa_table),
                ConstantTransport(visc=1e-5, bulk_visc=0.0, kappa=0.02)):
        fl = Fluxes(mixture=mix, transport=bad)
        bctx = RHSContext(fluxes=fl, riemann=Rusanov(fl))
        assert not cuda_faces.face_sweep_supported(tab_np, bctx)
        assert cuda_faces.lte_table_dim(bctx) is None


# ------------------------------------------------------------ the boxes

BOX = """
[solver]
type = flow
[flow]
order = {order}
basisType = 0
integrationRule = 0
maxIters = {iters}
outputFreq = 100000
fluid = lte_table
equation_system = {eq}
[mesh]
{mesh}
[time]
integrator = rk4
dt_fixed = 2e-9
enableConstantTimestep = 1
[initialConditions]
rho = 0.0507
rhoU = 0.507
rhoV = 0.2
rhoW = 0.1
pressure = 100245.6
{lte}
[plasma_models]
radiation_model = net_emission
[plasma_models/radiation_model/net_emission/tabulated]
filename = {nec}
[io]
outdirBase = {out}
"""


def _box_mesh(n, dim):
    axes = "xyz"[:dim]
    return ("generator = box{}d\n".format(dim)
            + "".join(f"n{a} = {n}\n{a}1 = 0.01\nperiodic_{a} = 1\n"
                      for a in axes))


@pytest.mark.parametrize("table_dim,dim,eq", [
    (2, 2, "navier-stokes"), (2, 2, "euler"), (1, 3, "navier-stokes")])
def test_periodic_boxes_step(table_dim, dim, eq, t2dir, tmp_path):
    """Paths 3 and 4 cut to size through the port's solver: the periodic
    2-D-table box (NS, Euler) and the 3-D box with 1-D tables, 2 steps
    from a perturbed state; the slot path's sweep is the LTE variant's
    plain version (its RHS and face sweep are held against tps_tpu's
    above)."""
    text = BOX.format(order=2 if dim == 2 else 1, iters=2, eq=eq,
                      mesh=_box_mesh(2, dim),
                      lte=lte_keys(table_dim, t2dir), nec=NEC,
                      out=tmp_path / "out")
    path = tmp_path / "box.ini"
    path.write_text(text)
    rc = parse_run_configuration(IniInput.read(str(path)))
    s = CompressibleSolver(rc, device="cpu")
    s.initialize()
    want = (f"lte_{dim}d" + ("_t2" if table_dim == 2 else "")
            + ("_euler" if eq == "euler" else ""))
    assert s._rhs.sweep.variant == want
    U0 = s.state_global()
    # a hot start (T = pressure / (rho R(300 K, rho = 1)) of the tables)
    T0 = s.mixture.temperature(s.U)
    assert 8000.0 < float(T0.min()) <= float(T0.max()) < 11000.0
    xyz = s.tables_np.xyz_dof
    U1 = U0.copy()
    U1[..., 0] *= 1.0 + 0.05 * np.sin(2 * np.pi / 0.01 * xyz[..., 0])
    s.set_state_global(U1)
    s.solve()
    assert s.iter == 2 and s.check_nan() == 0
    assert _per_eq(s.state_global(), U1) > 1e-9  # it moved


def test_lte_module_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import tps_torch.physics.lte, tps_torch.tools.lte_argon_tables")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
