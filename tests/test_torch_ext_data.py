"""tps_torch's external data (interop/ext_data.py) and its four uses in the
low-Mach solver against the JAX package's, on the CPU in f64.

- the readers (whitespace and CSV profiles, the inlet plane with its
  T < 0 rows dropped), gaussian_interp, volume_field_from_file and
  inlet_scalars_from_file on seeded inputs: bit for bit (the same numpy);
- the interpolated inlet's ramped values on the device step counter
  against the JAX package's host count, before, inside and after the
  ramp: bit for bit;
- decks, through both packages' per-step loops: the interpolated inlet
  inside its ramp (rampSteps 3, 3 steps) with the calorically-perfect
  thermo (test_ext_data.py's deck), whose temperature BC takes the
  inlet's values on its dofs (the reacting and LTE thermo take them
  through the same `T_bc`); species
  initialisation from a file; the zeta-f inlet file; the static-RANS
  eddy-viscosity file (first-order steps: one compiled step a deck in the
  JAX package, for the suite's time): every field to 1e-9 of max (solves
  to 1e-12).
"""

import os

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
threadpool_limits(1)  # numpy's and scipy's BLAS too: one thread a worker

import jax.numpy as jnp  # noqa: E402

from tps_torch import harness  # noqa: E402
from tps_torch.fem import h1  # noqa: E402
from tps_torch.interop import ext_data  # noqa: E402
from tps_tpu.fem import h1 as jh1  # noqa: E402
from tps_tpu.harness import Tps as JTps  # noqa: E402
from tps_tpu.interop import ext_data as jext_data  # noqa: E402
from tps_tpu.mesh.generators import box_2d as jbox_2d  # noqa: E402

HERE = os.path.dirname(__file__)
ARGON = os.path.join(HERE, "inputs", "argon_minimal.ini")
F64 = torch.float64
DECK_TOL = 1e-9


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


def _tables(order=2, n=6):
    tab_np = jh1.build_h1(jbox_2d(n, n), order)
    return (h1.h1_tables_from_numpy(tab_np).to_torch(F64, "cpu"),
            tab_np.to_jax(jnp.float64))


def _inlet_csv(path, n=30, swirl=False, hole=False):
    """A parabolic u(y) inlet plane along x = 0 (T 300 K; a w column
    where swirl; one row with T < 0 where hole)."""
    ys = np.linspace(0.0, 1.0, n)
    with open(path, "w") as fh:
        fh.write("# no, x, y, z, T, u, v, w\n")
        for i, y in enumerate(ys):
            T = -1.0 if hole and i == n // 2 else 300.0 + 50.0 * y
            w = 0.3 * y if swirl else 0.0
            fh.write(f"{i},0.0,{y},0.0,{T},{4.0 * y * (1 - y)},0.0,{w}\n")
    return str(path)


def _profiles(tmp_path):
    """A tke/v2 inlet profile and a volume nu_t field (rows x y z vals)."""
    rng = np.random.default_rng(3)
    ys = np.sort(rng.random(25))
    tke = tmp_path / "tke.csv"
    np.savetxt(tke, np.column_stack([0 * ys, ys, 0 * ys, 0.1 * ys,
                                     0.05 * ys]), delimiter=",")
    pts = rng.random((300, 2))
    nut = tmp_path / "nuT.dat"
    np.savetxt(nut, np.column_stack([pts, 0 * pts[:, 0],
                                     0.01 + 0.02 * pts[:, 0]]),
               header="x y z nut")
    return str(tke), str(nut)


# ------------------------------------------------------------ the readers

@pytest.mark.parametrize("name", ["read_profile", "read_inlet_plane",
                                  "gaussian_interp", "volume_field",
                                  "inlet_scalars"])
def test_readers_match(tmp_path, name):
    tke, nut = _profiles(tmp_path)
    tab, jtab = _tables()
    if name == "read_profile":
        a = [ext_data.read_profile(p) for p in (tke, nut)]
        b = [jext_data.read_profile(p) for p in (tke, nut)]
    elif name == "read_inlet_plane":
        path = _inlet_csv(tmp_path / "in.csv", swirl=True, hole=True)
        a = ext_data.read_inlet_plane(path)
        b = jext_data.read_inlet_plane(path)
        assert len(a[0]) == 29  # the T < 0 row is outside the source
    elif name == "gaussian_interp":
        rng = np.random.default_rng(4)
        # more destinations than one block of the interpolation holds
        src, dst = rng.random((200, 3)), rng.random((2100, 3))
        vals = rng.random((200, 2))
        a = [ext_data.gaussian_interp(src, vals, dst)]
        b = [jext_data.gaussian_interp(src, vals, dst)]
    elif name == "volume_field":
        a = [ext_data.volume_field_from_file(tab, nut, fac=1.5)]
        b = [jext_data.volume_field_from_file(jtab, nut, fac=1.5)]
    else:
        a = ext_data.inlet_scalars_from_file(tab, tke, (4,), fac=2.0)
        b = jext_data.inlet_scalars_from_file(jtab, tke, (4,), fac=2.0)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_ramped_inlet_values_match(tmp_path):
    path = _inlet_csv(tmp_path / "in.csv", swirl=True)
    tab, jtab = _tables()
    ours = ext_data.GaussianInterpExtData(tab, path, (4,), ramp_steps=3)
    ref = jext_data.GaussianInterpExtData(jtab, path, (4,), ramp_steps=3)
    np.testing.assert_array_equal(ours.dofs.numpy(), ref.dofs)
    for _ in range(5):
        ours.step()
        ref.step()
        for f in ("velocity_values", "swirl_values", "temperature_values"):
            np.testing.assert_array_equal(getattr(ours, f)().numpy(),
                                          np.asarray(getattr(ref, f)()))
    assert float(ours.ramp) == 1.0


# ------------------------------------------------------------------ decks

INLET_DECK = """
[solver]
type = loMach
[mesh]
generator = box2d
nx = 6
ny = 6
[loMach]
order = 2
flow-solver = tomboulides
thermo-solver = calorically-perfect
maxIters = 3
[time]
dt_fixed = 1e-3
bdfOrder = 1
solverRelTolerance = 1e-12
[boundaryConditions/inlet1]
patch = 4
type = interpolate
name = {csv}
rampSteps = 3
[boundaryConditions/wall1]
patch = 1
type = viscous
[boundaryConditions/wall2]
patch = 3
type = viscous
"""


def _plasma_blocks():
    argon = open(ARGON).read()
    argon = "[plasma_models]" + argon.split("[plasma_models]", 1)[1]
    return argon.rsplit("[io]", 1)[0]


def _pair(text, tmp_path, steps):
    """The deck through both packages, `steps` per-step steps each."""
    path = tmp_path / "deck.ini"
    path.write_text(text)
    ours = harness.Tps()
    ours.parse_command_line_args(["tps", "--runFile", str(path), "--device",
                                  "cpu"])
    ours.parse_input()
    ours.config.outdir = str(tmp_path / "port")
    ours.choose_devices()
    ours.choose_solver()
    ours.initialize()
    ref = JTps()
    ref.input_file = str(path)
    ref.parse_input()
    ref.config.raw.values["io/outdirBase"] = str(tmp_path / "jax")
    ref.choose_devices()
    ref.choose_solver()
    ref.initialize()
    for _ in range(steps):
        ours.solver.solve_step()
        ref.solver.solve_step()
    return ours.solver, ref.solver


def _fields(s):
    out = {"u": s.flow.velocity()}
    for k in ("T", "Y", "T_bc", "T_mask"):
        if hasattr(s.thermo, k):
            out[k] = getattr(s.thermo, k)
    if hasattr(s.flow, "p"):
        out["p"] = s.flow.p
    for k in ("k", "eps", "v2", "f"):
        if hasattr(s.turb, k):
            out[k] = getattr(s.turb, k)
    out["nut"] = s.turb.eddy_viscosity()
    return out


def _assert_match(ours, ref):
    a, b = _fields(ours), _fields(ref)
    assert set(a) == set(b)
    for k in a:
        assert _rel(a[k], b[k]) <= DECK_TOL, k
        assert np.isfinite(a[k].numpy()).all(), k


def test_interpolated_inlet_deck_matches(tmp_path):
    """Three steps inside the ramp (1/3, 2/3, 1 of the profile); the
    inlet's temperature becomes a Dirichlet value on its dofs."""
    text = INLET_DECK.format(csv=_inlet_csv(tmp_path / "in.csv"))
    ours, ref = _pair(text, tmp_path, 3)
    _assert_match(ours, ref)
    ed = ours.ext_data[0]
    dofs = ed.dofs.numpy()
    y = ours.tab_np.xyz[dofs, 1]
    u = ours.flow.u.numpy()
    assert np.abs(u[dofs, 0] - 4 * y * (1 - y)).max() < 0.1
    assert float(ed.count) == 3.0
    assert ours.thermo.T_mask.numpy()[dofs].max() == 0.0
    T = ours.thermo.T.numpy()[dofs]
    assert np.abs(T - ed.temperature_bdr.numpy()).max() < 1e-9


def test_species_initialisation_matches(tmp_path):
    """plasma_models/initialize_species on a zero-flow reacting column:
    Y(Ar+) from a file (mixture columns Ar+, E, Ar), one step."""
    rng = np.random.default_rng(8)
    pts = rng.random((200, 2)) * 0.01
    yi = 1e-5 + 1e-4 * pts[:, 0] / 0.01
    ye = yi * 5.4858e-07 / (39.948e-3 - 5.4858e-07)
    rows = np.column_stack([pts, 0 * yi, yi, ye, 1.0 - yi - ye])
    init = tmp_path / "species.dat"
    np.savetxt(init, rows)
    text = f"""
[solver]
type = loMach
[mesh]
generator = box2d
nx = 3
ny = 3
x1 = 0.01
y1 = 0.01
[loMach]
order = 1
flow-solver = zero-flow
thermo-solver = reacting-flow
maxIters = 2
[initialConditions]
temperature = 9000.0
[time]
dt_fixed = 1e-8
bdfOrder = 1
""" + _plasma_blocks().replace(
        "[plasma_models]\n", "[plasma_models]\ninitialize_species = 1\n"
        f"initialize_file = {init}\n", 1)
    ours, ref = _pair(text, tmp_path, 0)
    assert _rel(ours.thermo.Y, ref.thermo.Y) == 0.0
    assert float(ours.thermo.Y[:, 0].max()) > 1e-5
    ours.solve_step()
    ref.solve_step()
    _assert_match(ours, ref)


TURB_DECK = """
[solver]
type = loMach
[mesh]
generator = box2d
nx = 5
ny = 5
[loMach]
order = 1
flow-solver = tomboulides
thermo-solver = constant-property
turb-model = {turb}
maxIters = 2
[time]
dt_fixed = 1e-4
bdfOrder = 1
[boundaryConditions/inlet1]
patch = 4
type = interpolate
name = {csv}
[boundaryConditions/wall1]
patch = 1
type = viscous
[boundaryConditions/wall2]
patch = 3
type = viscous
"""


@pytest.mark.parametrize("turb", ["zeta-f", "static-rans"])
def test_turbulence_files_match(tmp_path, turb):
    """ransModel/zeta-f-file at the interpolated inlet (bc-fac 2) and
    loMach/static-rans/visc-file (visc-fac 1.5), test_ext_data.py's set-up;
    one step."""
    tke, nut = _profiles(tmp_path)
    text = TURB_DECK.format(turb=turb, csv=_inlet_csv(tmp_path / "in.csv"))
    if turb == "zeta-f":
        text += (f"[ransModel]\nzeta-f-file = {tke}\nbc-fac = 2.0\n"
                 "walls = '1 3'\n")
    else:
        text += (f"[loMach/static-rans]\nvisc-file = {nut}\n"
                 "visc-fac = 1.5\n")
    ours, ref = _pair(text, tmp_path, 0)
    if turb == "zeta-f":
        for k in ("k_bc", "v2_bc", "eps_bc", "dir_mask"):
            assert _rel(getattr(ours.turb, k), getattr(ref.turb, k)) == 0.0
        dofs = h1.boundary_dofs(ours.tab, (4,))
        y = ours.tab_np.xyz[dofs, 1]
        assert np.abs(ours.turb.k_bc.numpy()[dofs] - 0.2 * y).max() < 0.03
    else:
        assert _rel(ours.turb.eddy_viscosity(),
                    ref.turb.eddy_viscosity()) == 0.0
    ours.solve_step()
    ref.solve_step()
    _assert_match(ours, ref)
