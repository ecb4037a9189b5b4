"""The CUDA kernels K1/K2 and the face sweep == their plain PyTorch
versions, on a GPU (K1 on its compressed folds against the dense plain
gradient), with Sutherland and constant transport, on boxes, the curved
cylinder O-grid and a hex mesh read from an MFEM file; the solver's step
graph == its eager steps, with a characteristic outlet's ghost state in
the loop's buffers; a checkpoint read on the card continues the run.
The low-Mach path (no kernel of its own): an H1 operator repeats its bits
on the card and matches the CPU; the Tomboulides step graph == eager
steps, on p-multigrid and across a dense-factor refresh, and a capture
holds while a dead solver's graphs are collected.  The coupled torch
deck: step graph == eager steps across an EM update; GMRES on the card
matches the CPU.  The reacting deck: step graph == eager steps across a
dense refresh, and inside an interpolated inlet's ramp; a ReactingFlow
step on the card matches the CPU.  The face sweep's mixture variants (the
argon ternary in 3-D and on Euler, with constant transport; the
six-species mixture) == their plain versions; the coupled compressible
argon channel's step graph == eager steps across an EM update.  The
LTE-table fluid's eight variants == their plain versions (f64 2.2e-13);
the LTE channel's step graph == eager steps across an EM update.  The
axisymmetric (r, z) + swirl variants (DryAir, the argon ternary on
Navier-Stokes and Euler) == their plain versions, on a strip off the axis
and on boxes touching it.  The forcings (pressure gradient, heat source,
sponge zones, the MASA sources) on the card == on the CPU; the forced
channel and the transient MMS deck: step graph == eager steps == the CPU;
the compute_rhs tool's errors on the card == the CPU's.

Marked `cuda`; each test skips where torch.cuda.is_available() is false.
This file imports no jax, so on a machine without it run it alone, past
the suite's jax-configuring conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Bars: 1e-11 (f64) and 5e-5 (f32) relative to max|plain|; the two sum the
same products in another order.  TF32 is off for the plain version.  The
step graph against eager steps: 1e-12 of max|U| in f64 (the same kernels
on the same inputs).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tps_torch.dg import cuda_faces, cuda_fused  # noqa: E402
from tps_torch.dg.bc import WallBC  # noqa: E402
from tps_torch.dg.cuda_faces import build_face_sweep, build_prototype_sweep  # noqa: E402
from tps_torch.dg.cuda_fused import build_cuda_fused  # noqa: E402
from tps_torch.dg.discretization import build_tables  # noqa: E402
from tps_torch.dg.fluxes import Fluxes  # noqa: E402
from tps_torch.dg.operators import dg_gradient  # noqa: E402
from tps_torch.dg.rhs import RHSContext, bc_slices  # noqa: E402
from tps_torch.dg.riemann import Rusanov  # noqa: E402
from tps_torch.mesh.generators import box_2d, box_3d  # noqa: E402
from tps_torch.physics.gas import DryAir  # noqa: E402
from tps_torch.physics.transport import ConstantTransport, DryAirTransport  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float64: 1e-11, torch.float32: 5e-5}
# K1 (compressed folds) against the dense plain gradient
K1_TOL = {torch.float64: 1e-12, torch.float32: 5e-5}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda", 0)


def _setup(n, order, eq_system, dtype, device):
    mix = DryAir(dim=3, nvel=3)
    tr = None if eq_system == "euler" else DryAirTransport(
        mix.gas_constant, mix.specific_heat_ratio, bulk_visc_mult=0.3)
    fl = Fluxes(mixture=mix, transport=tr, eq_system=eq_system)
    ctx = RHSContext(fluxes=fl, riemann=Rusanov(fl))
    tab = build_tables(box_3d(*n, periodic=(True, True, True)), order)
    rng = np.random.default_rng(7)
    Up = np.empty(tab.xyz_dof.shape[:-1] + (5,))
    Up[..., 0] = rng.uniform(1.0, 1.4, Up.shape[:-1])
    Up[..., 1:4] = rng.uniform(-15.0, 15.0, Up.shape[:-1] + (3,))
    Up[..., 4] = rng.uniform(280.0, 320.0, Up.shape[:-1])
    U = mix.conservatives(torch.as_tensor(Up)).to(dtype=dtype, device=device)
    return build_cuda_fused(tab, ctx, dtype, device), U.contiguous()


def _rel(a, b):
    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,order,eq_system", [
    ((5, 6, 7), 2, "navier-stokes"),
    ((5, 6, 7), 2, "euler"),
    ((3, 4, 5), 3, "navier-stokes"),
    # periodic extents 1 and 2 (self- and double neighbors, in K1's tile);
    # 6 and 27 elements, ragged tiles
    ((1, 2, 3), 2, "navier-stokes"),
    ((3, 3, 3), 2, "euler"),
    ((3, 3, 3), 2, "navier-stokes"),
    # ndof 216 (K1 and K2 one or two elements a block in f64)
    ((2, 2, 3), 5, "navier-stokes"),
])
def test_kernels_match_plain(device, n, order, eq_system, dtype):
    rhs, U = _setup(n, order, eq_system, dtype, device)
    plain = rhs.plain
    U2 = U.reshape(rhs.ne, -1)
    cuda_fused.reset_launches()
    y, aux = rhs(U)
    torch.cuda.synchronize()
    assert cuda_fused.launches["k2_faces_volume"] == 1
    assert cuda_fused.launches["k1_gradient"] == (eq_system != "euler")
    y_ref, aux_ref = plain(U2)
    assert _rel(y, y_ref.reshape(U.shape)) <= TOL[dtype]
    np.testing.assert_allclose(float(aux["max_char_speed"]),
                               float(aux_ref["max_char_speed"]),
                               rtol=TOL[dtype])
    if rhs.viscous:
        G_ref = plain.gradient(U2).reshape(rhs.ne, rhs.ndof, 5, 3)
        assert _rel(rhs.gradient(U), G_ref) <= K1_TOL[dtype]


def test_wrapper_rejects_bad_input(device):
    rhs, U = _setup((3, 3, 3), 2, "navier-stokes", torch.float32, device)
    with pytest.raises(ValueError):
        rhs.gradient(U.double())
    with pytest.raises(ValueError):
        rhs.gradient(U.transpose(1, 2).contiguous().transpose(1, 2))


# ---------------------------------------------------------------- face sweep


def _face_case(n, order, eq_system, basis, dtype, device, transport=None):
    """Slot-mode sweep on a walled box and X = [U | G] from a seeded state
    (Sutherland transport unless `transport`)."""
    dim = len(n)
    kw = {} if basis == "gl" else dict(basis="gauss-lobatto",
                                       quad_rule="gauss-lobatto")
    mesh = (box_3d(*n, periodic=(False,) * 3) if dim == 3
            else box_2d(*n, periodic_x=False, periodic_y=False))
    tab_np = build_tables(mesh, order, **kw)
    mix = DryAir(dim=dim, nvel=dim)
    tr = None if eq_system == "euler" else transport or DryAirTransport(
        mix.gas_constant, mix.specific_heat_ratio, bulk_visc_mult=0.3)
    fl = Fluxes(mixture=mix, transport=tr, eq_system=eq_system)
    bcs = bc_slices(tab_np.f_bdr_attr, lambda p: WallBC("inviscid"))
    ctx = RHSContext(fluxes=fl, riemann=Rusanov(fl), bcs=bcs)
    rng = np.random.default_rng(5)
    Up = np.empty(tab_np.xyz_dof.shape[:-1] + (dim + 2,))
    Up[..., 0] = rng.uniform(1.0, 1.4, Up.shape[:-1])
    Up[..., 1:1 + dim] = rng.uniform(-15.0, 15.0, Up.shape[:-1] + (dim,))
    Up[..., dim + 1] = rng.uniform(280.0, 320.0, Up.shape[:-1])
    tab = tab_np.to_torch(dtype, device)
    U = mix.conservatives(torch.as_tensor(Up)).to(dtype=dtype, device=device)
    X = U if eq_system == "euler" else torch.cat(
        [U, dg_gradient(tab, mix.primitives(U)).reshape(U.shape[0], U.shape[1], -1)],
        -1)
    return build_face_sweep(tab, ctx), X.contiguous()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,order,eq_system,basis", [
    ((3, 4, 5), 2, "navier-stokes", "gll"),
    ((3, 4, 5), 2, "navier-stokes", "gl"),
    ((3, 4, 5), 2, "euler", "gll"),
    ((2, 3, 3), 3, "navier-stokes", "gll"),
    ((6, 5), 3, "navier-stokes", "gll"),
    ((6, 5), 2, "euler", "gl"),
])
def test_face_sweep_matches_plain(device, n, order, eq_system, basis, dtype):
    sweep, X = _face_case(n, order, eq_system, basis, dtype, device)
    cuda_faces.reset_launches()
    z = sweep(X)
    torch.cuda.synchronize()
    assert cuda_faces.launches["face_sweep"] == 1
    assert _rel(z, sweep.plain(X)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,basis,eq_system", [
    ((1, 2, 3), "gll", "navier-stokes"),  # periodic extents 1 and 2
    ((3, 3, 3), "gl", "euler"),           # 27 elements: ragged tiles
])
def test_face_sweep_periodic_edge_grids(device, n, basis, eq_system, dtype):
    mix = DryAir(dim=3, nvel=3)
    tr = None if eq_system == "euler" else DryAirTransport(
        mix.gas_constant, mix.specific_heat_ratio, bulk_visc_mult=0.3)
    fl = Fluxes(mixture=mix, transport=tr, eq_system=eq_system)
    ctx = RHSContext(fluxes=fl, riemann=Rusanov(fl))
    kw = {} if basis == "gl" else dict(basis="gauss-lobatto",
                                       quad_rule="gauss-lobatto")
    tab_np = build_tables(box_3d(*n, periodic=(True,) * 3), 2, **kw)
    rng = np.random.default_rng(9)
    Up = np.empty(tab_np.xyz_dof.shape[:-1] + (5,))
    Up[..., 0] = rng.uniform(1.0, 1.4, Up.shape[:-1])
    Up[..., 1:4] = rng.uniform(-15.0, 15.0, Up.shape[:-1] + (3,))
    Up[..., 4] = rng.uniform(280.0, 320.0, Up.shape[:-1])
    tab = tab_np.to_torch(dtype, device)
    U = mix.conservatives(torch.as_tensor(Up)).to(dtype=dtype, device=device)
    X = U if eq_system == "euler" else torch.cat(
        [U, dg_gradient(tab, mix.primitives(U)).reshape(U.shape[0], U.shape[1], -1)],
        -1)
    sweep = build_face_sweep(tab, ctx)
    X = X.contiguous()
    z = sweep(X)
    torch.cuda.synchronize()
    assert _rel(z, sweep.plain(X)) <= TOL[dtype]


CONSTANT = ConstantTransport(visc=1.8e-5, bulk_visc=2e-6, kappa=0.026)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_constant_transport_kernels_match_plain(device, dtype):
    """K1+K2 and the face sweep with constant mu, bulk viscosity and kappa
    (dg_pointwise.cuh::transport) against the plain version."""
    mix = DryAir(dim=3, nvel=3)
    fl = Fluxes(mixture=mix, transport=CONSTANT, eq_system="navier-stokes")
    ctx = RHSContext(fluxes=fl, riemann=Rusanov(fl))
    tab = build_tables(box_3d(5, 6, 7, periodic=(True, True, True)), 2)
    rhs = build_cuda_fused(tab, ctx, dtype, device)
    _, U = _setup((5, 6, 7), 2, "navier-stokes", dtype, device)
    y, _ = rhs(U)
    y_ref, _ = rhs.plain(U.reshape(rhs.ne, -1))
    assert _rel(y, y_ref.reshape(U.shape)) <= TOL[dtype]
    sweep, X = _face_case((3, 4, 5), 2, "navier-stokes", "gll", dtype, device,
                          transport=CONSTANT)
    assert _rel(sweep(X), sweep.plain(X)) <= TOL[dtype]


def _curved_case(mesh, basis, dtype, device):
    """Slot-mode NS sweep (Sutherland) on `mesh`, X from a seeded state."""
    dim = mesh.dim
    kw = {} if basis == "gl" else dict(basis="gauss-lobatto",
                                       quad_rule="gauss-lobatto")
    tab_np = build_tables(mesh, 2, **kw)
    mix = DryAir(dim=dim, nvel=dim)
    fl = Fluxes(mixture=mix, eq_system="navier-stokes", transport=DryAirTransport(
        mix.gas_constant, mix.specific_heat_ratio))
    ctx = RHSContext(fluxes=fl, riemann=Rusanov(fl))
    rng = np.random.default_rng(2)
    Up = np.empty(tab_np.xyz_dof.shape[:-1] + (dim + 2,))
    Up[..., 0] = rng.uniform(1.0, 1.4, Up.shape[:-1])
    Up[..., 1:1 + dim] = rng.uniform(-15.0, 15.0, Up.shape[:-1] + (dim,))
    Up[..., dim + 1] = rng.uniform(280.0, 320.0, Up.shape[:-1])
    tab = tab_np.to_torch(dtype, device)
    U = mix.conservatives(torch.as_tensor(Up)).to(dtype=dtype, device=device)
    G = dg_gradient(tab, mix.primitives(U)).reshape(U.shape[0], U.shape[1], -1)
    return build_face_sweep(tab, ctx), torch.cat([U, G], -1).contiguous()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["annulus_gl", "annulus_gll",
                                  "annulus_geom3", "hex_file"])
def test_face_sweep_on_curved_and_file_meshes(device, tmp_path, case, dtype):
    """The cylinder O-grid's curved quads (per-point normals; the face rule
    grows with the geometry order) and a hex mesh read from an MFEM file."""
    from tps_torch.mesh.generators import annulus_2d
    from tps_torch.mesh.mfem_reader import read_mfem_mesh, write_mfem_mesh

    if case == "hex_file":
        write_mfem_mesh(str(tmp_path / "box.mesh"), box_3d(4, 3, 5))
        mesh, basis = read_mfem_mesh(str(tmp_path / "box.mesh")), "gll"
    else:
        mesh = annulus_2d(6, 24, r0=0.5, r1=8.0,
                          geom_order=3 if case == "annulus_geom3" else 2)
        basis = "gll" if case == "annulus_gll" else "gl"
    sweep, X = _curved_case(mesh, basis, dtype, device)
    cuda_faces.reset_launches()
    z = sweep(X)
    torch.cuda.synchronize()
    assert cuda_faces.launches["face_sweep"] == 1
    assert _rel(z, sweep.plain(X)) <= TOL[dtype]


def test_shared_memory_plans_match_the_kernels(device):
    """The Python plans (tiles and shared bytes) are the kernels' own."""
    import ctypes

    from tps_torch.dg.cuda_fused import _Library, build_kernels

    build_kernels()
    lib = _Library.lib
    tile = ctypes.c_int()
    for dtype in (torch.float32, torch.float64):
        size = torch.empty((), dtype=dtype).element_size()
        # K1: (ndof, groups, columns, rows) of GL boxes p = 1..6, and folds
        # kept dense (one group of 8 rows per 8 rows, every column)
        for ndof, ngroup, ncol, nrow in ((8, 12, 6, 2), (27, 27, 9, 3),
                                         (64, 48, 12, 4), (125, 75, 15, 5),
                                         (216, 108, 18, 6), (343, 147, 21, 7),
                                         (27, 11, 189, 8)):
            E, _res, smem = cuda_fused.k1_plan(ndof, ngroup, ncol, nrow, dtype)
            assert lib.tps_k1_smem(ndof, ngroup, ncol, nrow, size,
                                   ctypes.byref(tile)) == smem
            assert tile.value == E
        for ndof, nqf in ((27, 16), (64, 25), (125, 36), (216, 49), (343, 64)):
            for viscous in (True, False):
                E, _res, smem = cuda_fused.k2_plan(ndof, nqf, viscous, dtype)
                assert lib.tps_k2_smem(ndof, nqf, int(viscous), size,
                                       ctypes.byref(tile)) == smem
                assert tile.value == E
        for ndof, nqf, nlf, k, neq in ((27, 25, 6, 20, 5), (27, 16, 6, 5, 5),
                                       (64, 36, 6, 20, 5), (512, 100, 6, 20, 5),
                                       (16, 5, 4, 12, 4), (9, 4, 4, 4, 4),
                                       # the argon plasma: neq 6, k 18 (2-D);
                                       # then a 3-D plan of 7 equations
                                       (4, 2, 4, 18, 6), (9, 3, 4, 18, 6),
                                       (9, 4, 4, 18, 6), (27, 16, 6, 28, 7),
                                       # the mixture variants: 3-D NS (neq
                                       # 7, k 28) at p=2 GL; Euler (k =
                                       # neq) 2-D and 3-D; the six-species
                                       # mixture (neq 9, k 27) at p=1, 2
                                       (27, 9, 6, 28, 7), (9, 3, 4, 6, 6),
                                       (27, 9, 6, 7, 7), (4, 2, 4, 27, 9),
                                       (9, 3, 4, 27, 9)):
            E, _res, smem = cuda_faces.plan(ndof, nqf, nlf, k, neq, dtype)
            assert lib.tps_face_sweep_smem(ndof, nqf, nlf, k, neq, size,
                                           ctypes.byref(tile)) == smem
            assert tile.value == E


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_face_sweep_prototype_mode(device, dtype):
    from tps_torch.tools.face_prototype import prototype_state

    tab = build_tables(box_3d(4, 5, 6, periodic=(True, True, True)), 2)
    sweep = build_prototype_sweep(tab, dtype, device)
    U = torch.as_tensor(prototype_state(tab.ne, tab.ndof), dtype=dtype,
                        device=device)
    z = sweep(U)
    torch.cuda.synchronize()
    assert _rel(z, sweep.plain(U)) <= 1e-5


WALLED_DECK = """
[solver]
type = flow
[flow]
order = 2
maxIters = 2
timingFreq = 2
equation_system = navier-stokes
[mesh]
generator = box3d
nx = 3
ny = 3
nz = 4
[time]
integrator = rk4
dt_fixed = 2e-6
[initialConditions]
rho = 1.2
rhoU = 12.0
pressure = 101300
[io]
outdirBase = {outdir}
""" + "".join(f"[boundaryConditions/wall{i}]\npatch = {i}\ntype = inviscid\n"
              for i in range(1, 7))


def test_slot_solver_launches_the_face_sweep(device, tmp_path):
    """The GLL walled deck through the CLI on the card: the slot path
    launches the face sweep once per RHS (K1/K2 never) and lands where
    the CPU run (the plain sweep) does, in f64."""
    from tps_torch import harness

    path = tmp_path / "walled.ini"
    path.write_text(WALLED_DECK.format(outdir=tmp_path / "out"))
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        states = {}
        for dev in ("cuda", "cpu"):
            tps = harness.Tps()
            tps.parse_command_line_args(["tps", "--runFile", str(path),
                                         "--device", dev])
            tps.parse_input()
            tps.choose_devices()
            tps.choose_solver()
            tps.initialize()
            cuda_fused.reset_launches()
            cuda_faces.reset_launches()
            tps.solve()
            states[dev] = tps.solver.state_global()
            if dev == "cuda":
                assert cuda_faces.launches["face_sweep"] == 8
                assert cuda_fused.launches == {"k1_gradient": 0,
                                               "k2_faces_volume": 0}
    finally:
        torch.set_default_dtype(old)
    np.testing.assert_allclose(states["cuda"], states["cpu"], rtol=1e-10,
                               atol=1e-10 * np.max(np.abs(states["cpu"])))


# ---------------------------------------------------------------- step graphs

CHANNEL_2D = """
[solver]
type = flow
[flow]
order = 2
maxIters = {iters}
timingFreq = 4
equation_system = navier-stokes
[mesh]
generator = box2d
nx = 5
ny = 3
x1 = 0.05
y1 = 0.03
[time]
cfl = 0.2
integrator = rk4
{dt}
[initialConditions]
rho = 1.2
rhoU = 12.0
pressure = 101300
[boundaryConditions/inlet]
patch = 4
type = subsonic
density = 1.2
uvw = '10.0 0.0 0.0'
[boundaryConditions/outlet]
patch = 2
type = {outlet}
pressure = 101000
[boundaryConditions/bottom]
patch = 1
type = viscous_isothermal
temperature = 300
[boundaryConditions/top]
patch = 3
type = viscous_adiabatic
[io]
outdirBase = {outdir}
"""

FUSED_BOX = """
[solver]
type = flow
[flow]
order = 2
basisType = 0
integrationRule = 0
maxIters = {iters}
timingFreq = 4
equation_system = navier-stokes
[mesh]
generator = box3d
nx = 3
ny = 4
nz = 5
periodic_x = 1
periodic_y = 1
periodic_z = 1
[time]
cfl = 0.2
integrator = rk4
{dt}
[initialConditions]
rho = 1.2
rhoU = 12.0
pressure = 101300
[io]
outdirBase = {outdir}
"""

# launches of each kernel per RK4 step (4 RHS) on each deck
PER_STEP = {
    "channel": {"face_sweep": 4, "k1_gradient": 0, "k2_faces_volume": 0},
    "fused": {"face_sweep": 0, "k1_gradient": 4, "k2_faces_volume": 4}}


def _solver(tmp_path, deck, iters, fixed_dt, graphs, outlet="subsonicPressure",
            outdir="out"):
    """A solver on the card in f64 from a seeded perturbed state."""
    from tps_torch import harness

    text = (CHANNEL_2D if deck == "channel" else FUSED_BOX).format(
        iters=iters, outdir=tmp_path / outdir, outlet=outlet,
        dt=f"dt_fixed = {fixed_dt}" if fixed_dt else "")
    path = tmp_path / f"{deck}.ini"
    path.write_text(text)
    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", str(path)])
    tps.parse_input()
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    s = tps.solver
    s.cuda_graphs = graphs
    U = s.state_global()
    rng = np.random.default_rng(11)
    scale = 1.0 + 0.02 * rng.standard_normal(U.shape[:-1] + (1,))
    s.set_state_global(U * scale)
    return s


def _counts():
    return {**cuda_fused.launches, **cuda_faces.launches}


@pytest.fixture
def f64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@pytest.mark.parametrize("fixed_dt", [None, 2e-6])
@pytest.mark.parametrize("deck", ["channel", "fused"])
def test_step_graph_matches_eager(device, f64, tmp_path, deck, fixed_dt):
    """Two chunks of 4 steps through solve(): graph replays == eager
    steps (f64, 1e-12 of max|U|), t and dt too; launches = per step x 8."""
    out = {}
    for graphs in (True, False):
        s = _solver(tmp_path, deck, 8, fixed_dt, graphs)
        cuda_fused.reset_launches()
        cuda_faces.reset_launches()
        s.solve()
        torch.cuda.synchronize()
        assert _counts() == {k: v * 8 for k, v in PER_STEP[deck].items()}
        assert (s._loop.graph is not None) == graphs
        out[graphs] = (s.state_global(), float(s.time), float(s.dt))
    (Ug, tg, dtg), (Ue, te, dte) = out[True], out[False]
    np.testing.assert_allclose(Ug, Ue, rtol=0, atol=1e-12 * np.max(np.abs(Ue)))
    np.testing.assert_allclose([tg, dtg], [te, dte], rtol=1e-12)


def test_set_state_global_after_capture(device, f64, tmp_path):
    """A state set after the capture is the one the replays step."""
    s = _solver(tmp_path, "channel", 4, None, True)
    U0, dt0 = s.state_global(), float(s.dt)
    s.solve()
    assert s._loop.graph is not None
    U1 = s.state_global()
    s.set_state_global(U0)
    s.time, s.dt, s.iter = 0.0, dt0, 0
    s.solve()
    ref = _solver(tmp_path, "channel", 4, None, False)
    ref.set_state_global(U0)
    ref.dt = dt0
    ref.solve()
    np.testing.assert_allclose(s.state_global(), ref.state_global(), rtol=0,
                               atol=1e-12 * np.max(np.abs(U1)))
    np.testing.assert_allclose(float(s.time), float(ref.time), rtol=1e-12)


def test_capture_with_host_sync_raises(device):
    """A host sync inside the step raises at the capture; nothing falls
    back, and the capture counts no launch."""
    from tps_torch.solvers.step_graph import StepLoop

    def body(U, t, dt, bc):
        if float(U.sum()) < 0:  # a host read
            U = -U
        return 2.0 * U, t + dt, dt, U.amax(), bc

    counter = {"k": 0}
    lp = StepLoop(body, torch.ones(8, device=device), 0.5, counters=(counter,))
    with pytest.raises(RuntimeError):
        lp.run(2)
    assert lp.graph is None and counter == {"k": 0}
    torch.cuda.synchronize()


def test_stateful_outlet_graph_matches_eager(device, f64, tmp_path):
    """A nonReflectingPressure outlet, whose ghost state the step loop keeps
    in its buffers: 20 steps through solve(), graph replays == eager steps
    (1e-12 of max|U|), the ghosts too; the ghosts moved."""
    out = {}
    for graphs in (True, False):
        s = _solver(tmp_path, "channel", 20, None, graphs,
                    outlet="nonReflectingPressure")
        g0 = [g.clone() for g in s._loop.bc_states if g is not None]
        s.solve()
        torch.cuda.synchronize()
        assert (s._loop.graph is not None) == graphs
        ghosts = [g.cpu().numpy() for g in s._loop.bc_states if g is not None]
        assert len(ghosts) == 1 and np.max(np.abs(ghosts[0] - g0[0].cpu().numpy())) > 0
        out[graphs] = (s.state_global(), ghosts[0], float(s.time))
    (Ug, gg, tg), (Ue, ge, te) = out[True], out[False]
    np.testing.assert_allclose(Ug, Ue, rtol=0, atol=1e-12 * np.max(np.abs(Ue)))
    np.testing.assert_allclose(gg, ge, rtol=0, atol=1e-12 * np.max(np.abs(ge)))
    np.testing.assert_allclose(tg, te, rtol=1e-12)


@pytest.mark.parametrize("outlet", ["subsonicPressure", "nonReflectingPressure"])
def test_restart_round_trip_on_cuda(device, f64, tmp_path, outlet):
    """8 steps straight == 4 steps, a checkpoint, a fresh solver reading it
    and 4 more (step graphs, f64, 1e-12); with a characteristic outlet the
    straight run re-seeds its ghosts at step 4, as the read does."""
    from tps_torch.dg.rhs import init_bc_states

    import shutil

    a = _solver(tmp_path, "channel", 8, None, True, outlet, "a")
    a.config.max_iters = 4
    a.solve()  # ends with a checkpoint
    (tmp_path / "b").mkdir()
    shutil.copy(tmp_path / "a" / "restart_output.sol.h5", tmp_path / "b")
    a._loop.load_bc_states(init_bc_states(a.ctx, a.tables, a._loop.U))
    a.config.max_iters = 8
    a.solve()
    b = _solver(tmp_path, "channel", 8, None, True, outlet, "b")
    b.read_restart()
    assert b.iter == 4
    b.solve()
    np.testing.assert_allclose(b.state_global(), a.state_global(), rtol=0,
                               atol=1e-12 * np.max(np.abs(a.state_global())))
    np.testing.assert_allclose(float(b.time), float(a.time), rtol=1e-12)


# ---------------------------------------------------------------- argon plasma

ARGON_DECK = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "inputs", "argon_minimal.ini")


def _argon_case(n, order, basis, dtype, device):
    """The face sweep on the argon deck's mixture, periodic box of the
    deck's extent, a perturbed state (Te != Th, ion fraction ~1e-3) and
    its DG gradient."""
    from tps_torch.config.ini import IniInput
    from tps_torch.physics.plasma_config import build_plasma

    pl = build_plasma(IniInput.read(ARGON_DECK), 2, 2)
    mix = pl.mixture
    fl = Fluxes(mixture=mix, transport=pl.transport)
    ctx = RHSContext(fluxes=fl, riemann=Rusanov(fl))
    kw = {} if basis == "gl" else dict(basis="gauss-lobatto",
                                       quad_rule="gauss-lobatto")
    tab_np = build_tables(box_2d(*n, x1=0.01, y1=0.01, periodic_x=True,
                                 periodic_y=True), order, **kw)
    xyz = tab_np.xyz_dof
    k = 2 * np.pi / 0.01
    wave = np.sin(k * xyz[..., 0]) * np.cos(k * xyz[..., 1])
    Up = np.zeros(xyz.shape[:-1] + (6,))
    Up[..., 0] = 1.6 * (1 + 0.05 * wave)
    Up[..., 1], Up[..., 2] = 10.0 + 3.0 * wave, -2.0 * wave
    Up[..., 3] = 1800.0 * (1 + 0.05 * wave)
    Up[..., 4] = 1e-3 * 1.6 / mix.mw[0] * (1 + 0.2 * wave)
    Up[..., 5] = 9000.0 * (1 - 0.1 * wave)
    tab = tab_np.to_torch(torch.float64, device)
    U = mix.conservatives(torch.as_tensor(Up, device=device))
    G = dg_gradient(tab, mix.primitives(U))
    X = torch.cat([U, G.reshape(tab_np.ne, tab_np.ndof, -1)], -1)
    tab = tab_np.to_torch(dtype, device)
    return build_face_sweep(tab, ctx), X.to(dtype).contiguous()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,order,basis", [((6, 6), 1, "gll"),
                                           ((32, 32), 2, "gl"),
                                           ((32, 32), 2, "gll")])
def test_face_sweep_matches_plain_on_argon(device, n, order, basis, dtype):
    """f64: 1e-11 of max|plain|.  f32: the kernel no farther from the f64
    plain result than twice the f32 plain version (the third-order
    electron conductivity cancels digits in either order)."""
    sw, X = _argon_case(n, order, basis, dtype, device)
    assert sw.physics == "argon" and sw.k == 18
    cuda_faces.reset_launches()
    z = sw(X)
    torch.cuda.synchronize()
    assert cuda_faces.launches["face_sweep"] == 1
    plain = sw.plain(X)
    if dtype == torch.float64:
        assert _rel(z, plain) <= TOL[dtype]
    else:
        sw64, _ = _argon_case(n, order, basis, torch.float64, device)
        ref = sw64.plain(X.double())
        assert (_rel(z, plain) <= TOL[dtype]
                or _rel(z.double(), ref) <= 2 * _rel(plain.double(), ref))


def test_argon_deck_graph_matches_eager(device, f64, tmp_path):
    """The shipped argon deck (4 RK4 steps, CFL dt) through solve() on the
    card: graph replays == eager steps (f64, 1e-12 of max|U|), 16
    face-sweep launches and none of K1/K2 each way."""
    from tps_torch import harness

    out = {}
    for graphs in (True, False):
        text = open(ARGON_DECK).read().replace(
            "outdirBase = /tmp/tps_tpu_argon_output",
            f"outdirBase = {tmp_path / str(graphs)}")
        path = tmp_path / "argon.ini"
        path.write_text(text)
        tps = harness.Tps()
        tps.parse_command_line_args(["tps", "--runFile", str(path)])
        tps.parse_input()
        tps.choose_devices()
        tps.choose_solver()
        tps.initialize()
        s = tps.solver
        s.cuda_graphs = graphs
        cuda_fused.reset_launches()
        cuda_faces.reset_launches()
        s.solve()
        torch.cuda.synchronize()
        assert _counts() == {"face_sweep": 16, "k1_gradient": 0,
                             "k2_faces_volume": 0}
        out[graphs] = (s.state_global(), float(s.time), float(s.dt))
    (Ug, tg, dtg), (Ue, te, dte) = out[True], out[False]
    np.testing.assert_allclose(Ug, Ue, rtol=0, atol=1e-12 * np.max(np.abs(Ue)))
    np.testing.assert_allclose([tg, dtg], [te, dte], rtol=1e-12)


# ------------------------------------------------- the mixture variants

INPUTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "inputs")
CONSTANT_PLASMA = """
[plasma_models/transport_model/constant]
viscosity = 2.25e-5
bulk_viscosity = 0.0
thermal_conductivity = 0.0175
electron_thermal_conductivity = 1.5e-5
diffusivity/species1 = 0.094
diffusivity/species2 = 4.2e-6
diffusivity/species3 = 4.2e-6
momentum_transfer_frequency/species1 = 0.0
momentum_transfer_frequency/species2 = 4.4e10
momentum_transfer_frequency/species3 = 4.1e9
"""


def _variant_case(var, n, order, dtype, device):
    """A face-sweep variant's sweep and input: the argon deck's ternary in
    3-D (argon_3d), on Euler (argon_euler, 2-D or 3-D by n), with constant
    transport (argon_const); argon_full.ini's six species (gas_mixture).
    A periodic box of 0.01 m, a perturbed state (Te != Th, the ion ~1e-3
    and each other active species ~1e-4 of rho) and its DG gradient."""
    from tps_torch.config.ini import IniInput
    from tps_torch.physics.plasma_config import build_plasma

    deck = "argon_full.ini" if var == "gas_mixture" else "argon_minimal.ini"
    text = open(os.path.join(INPUTS, deck)).read()
    if var == "argon_const":
        text = text.replace("transport_model = argon_minimal",
                            "transport_model = constant") + CONSTANT_PLASMA
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"{var}.ini")
    with open(path, "w") as f:
        f.write(text)
    dim = len(n)
    pl = build_plasma(IniInput.read(path), dim, dim)
    mix = pl.mixture
    eq = "euler" if var == "argon_euler" else "navier-stokes"
    fl = Fluxes(mixture=mix, transport=None if eq == "euler" else pl.transport,
                eq_system=eq)
    ctx = RHSContext(fluxes=fl, riemann=Rusanov(fl))
    mesh = (box_3d(*n, bounds=((0.0, 0.01),) * 3, periodic=(True,) * 3)
            if dim == 3 else box_2d(*n, x1=0.01, y1=0.01, periodic_x=True,
                                    periodic_y=True))
    tab_np = build_tables(mesh, order)
    xyz = tab_np.xyz_dof
    k = 2 * np.pi / 0.01
    wave = np.sin(k * xyz[..., 0]) * np.cos(k * xyz[..., 1])
    Up = np.zeros(xyz.shape[:-1] + (mix.num_equations,))
    Up[..., 0] = 1.6 * (1 + 0.05 * wave)
    Up[..., 1], Up[..., 2] = 10.0 + 3.0 * wave, -2.0 * wave
    Up[..., dim + 1] = 1800.0 * (1 + 0.05 * wave)
    for sp in range(mix.num_active_species):
        frac = 1e-3 if sp == 0 else 1e-4
        Up[..., dim + 2 + sp] = frac * 1.6 / mix.mw[sp] * (1 + 0.1 * wave)
    Up[..., -1] = 9000.0 * (1 - 0.1 * wave)
    tab = tab_np.to_torch(torch.float64, device)
    U = mix.conservatives(torch.as_tensor(Up, device=device))
    X = U
    if eq != "euler":
        G = dg_gradient(tab, mix.primitives(U))
        X = torch.cat([U, G.reshape(tab_np.ne, tab_np.ndof, -1)], -1)
    return build_face_sweep(tab_np.to_torch(dtype, device), ctx), \
        X.to(dtype).contiguous()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("var,n,order", [
    ("argon_3d", (4, 4, 4), 2), ("argon_euler", (8, 8), 2),
    ("argon_euler", (4, 4, 4), 2), ("argon_const", (8, 8), 2),
    ("gas_mixture", (4, 4), 1), ("gas_mixture", (8, 8), 2)])
def test_face_sweep_variants_match_plain(device, var, n, order, dtype):
    """Each mixture variant against its plain version: f64 1e-11 of
    max|plain|; f32 within 5e-5, or no farther from the f64 plain result
    than twice the f32 plain version; one launch, counted under its
    variant."""
    sw, X = _variant_case(var, n, order, dtype, device)
    assert sw.variant == var
    cuda_faces.reset_launches()
    z = sw(X)
    torch.cuda.synchronize()
    assert cuda_faces.launches["face_sweep"] == 1
    assert cuda_faces.variant_launches[var] == 1
    plain = sw.plain(X)
    if dtype == torch.float64:
        assert _rel(z, plain) <= TOL[dtype]
    else:
        sw64, _ = _variant_case(var, n, order, torch.float64, device)
        ref = sw64.plain(X.double())
        assert (_rel(z, plain) <= TOL[dtype]
                or _rel(z.double(), ref) <= 2 * _rel(plain.double(), ref))


def _axi_case(var, n, order, dtype, device):
    """An axisymmetric variant's sweep and input on (r, z) tables with
    swirl (nvel = 3): DryAir (dry_air_axi, Navier-Stokes, or Euler where
    n is given as ("euler", n)) on tests/test_axisymmetric.py's strip
    (r in [0.2, 1.2], z periodic), the argon ternary (argon_axi,
    argon_axi_euler) on r in [0, 0.01] touching the axis; a perturbed
    state with a rigid swirl u_t = 5 r / 500 r and its DG gradient."""
    from tps_torch.config.ini import IniInput
    from tps_torch.physics.plasma_config import build_plasma

    eq = "euler" if var.endswith("euler") or n[0] == "euler" else \
        "navier-stokes"
    n = n[1] if n[0] == "euler" else n
    if var == "dry_air_axi":
        mix = DryAir(dim=2, nvel=3)
        tr = None if eq == "euler" else DryAirTransport(
            mix.gas_constant, mix.specific_heat_ratio, bulk_visc_mult=0.3)
        x0, L, swirl = 0.2, 1.0, 5.0
    else:
        pl = build_plasma(IniInput.read(ARGON_DECK), 2, 3)
        mix, tr = pl.mixture, (None if eq == "euler" else pl.transport)
        x0, L, swirl = 0.0, 0.01, 500.0
    fl = Fluxes(mixture=mix, transport=tr, eq_system=eq, axisymmetric=True)
    ctx = RHSContext(fluxes=fl, riemann=Rusanov(fl))
    tab_np = build_tables(box_2d(*n, x0=x0, x1=x0 + L, y1=L,
                                 periodic_y=True), order, axisymmetric=True)
    xyz = tab_np.xyz_dof
    k = 2 * np.pi / L
    wave = np.sin(k * xyz[..., 0]) * np.cos(k * xyz[..., 1])
    r = xyz[..., 0]
    Up = np.zeros(xyz.shape[:-1] + (mix.num_equations,))
    if var == "dry_air_axi":
        Up[..., 0] = 1.2 * (1 + 0.05 * wave)
        Up[..., 4] = 300.0 * (1 + 0.05 * wave)
    else:
        Up[..., 0] = 1.6 * (1 + 0.05 * wave)
        Up[..., 4] = 1800.0 * (1 + 0.05 * wave)
        Up[..., 5] = 1e-3 * 1.6 / mix.mw[0] * (1 + 0.2 * wave)
        Up[..., 6] = 9000.0 * (1 - 0.1 * wave)
    Up[..., 1], Up[..., 2] = 3.0 * wave, 10.0 - 2.0 * wave
    Up[..., 3] = swirl * r * (1 + 0.1 * wave)
    tab = tab_np.to_torch(torch.float64, device)
    U = mix.conservatives(torch.as_tensor(Up, device=device))
    X = U
    if eq != "euler":
        G = dg_gradient(tab, mix.primitives(U))
        X = torch.cat([U, G.reshape(tab_np.ne, tab_np.ndof, -1)], -1)
    return build_face_sweep(tab_np.to_torch(dtype, device), ctx), \
        X.to(dtype).contiguous()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("var,n,order", [
    ("dry_air_axi", (6, 6), 2), ("dry_air_axi", (64, 64), 2),
    ("dry_air_axi", ("euler", (64, 64)), 2), ("argon_axi", (8, 8), 2),
    ("argon_axi", (64, 64), 2), ("argon_axi_euler", (64, 64), 2)])
def test_face_sweep_axi_variants_match_plain(device, var, n, order, dtype):
    """Each axisymmetric variant against its plain version (the
    axisymmetric Fluxes through face_sweep_plain): f64 1e-11 of
    max|plain|; f32 within 5e-5, or no farther from the f64 plain result
    than twice the f32 plain version; one launch, counted under its
    variant; the swirl row is not zero."""
    sw, X = _axi_case(var, n, order, dtype, device)
    assert sw.variant == var and sw.rad is not None
    cuda_faces.reset_launches()
    z = sw(X)
    torch.cuda.synchronize()
    assert cuda_faces.launches["face_sweep"] == 1
    assert cuda_faces.variant_launches[var] == 1
    plain = sw.plain(X)
    assert float(plain[..., 3].abs().max()) > 0.0
    if dtype == torch.float64:
        assert _rel(z, plain) <= TOL[dtype]
    else:
        sw64, _ = _axi_case(var, n, order, torch.float64, device)
        ref = sw64.plain(X.double())
        assert (_rel(z, plain) <= TOL[dtype]
                or _rel(z.double(), ref) <= 2 * _rel(plain.double(), ref))


def _closure_case(base, closure, eq, dtype, device):
    """(sweep, X) of tps_torch/tools/closure_cases.py's case at 6x6 (2-D)
    or 4^3 (3-D) p=2 GL, X = [U | grad] in dtype on device."""
    from tps_torch.tools.closure_cases import closure_case

    ctx, tab_np, Up = closure_case(base, closure, 4 if "3d" in base else 6,
                                   eq=eq)
    mix = ctx.mixture
    tab = tab_np.to_torch(torch.float64, device)
    U = mix.conservatives(torch.as_tensor(Up, device=device))
    X = U
    if eq != "euler":
        G = dg_gradient(tab, mix.primitives(U))
        X = torch.cat([U, G.reshape(tab_np.ne, tab_np.ndof, -1)], -1)
    return build_face_sweep(tab_np.to_torch(dtype, device), ctx), \
        X.to(dtype).contiguous()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("base,closure,eq", [
    ("dry_air_2d", "all", "navier-stokes"),
    ("dry_air_3d", "all", "navier-stokes"),
    ("dry_air_axi", "all", "navier-stokes"),
    ("argon_2d", "all", "navier-stokes"),
    ("argon_3d", "all", "navier-stokes"),
    ("argon_axi", "all", "navier-stokes"),
    ("argon_axi", "mixing", "navier-stokes"),
    ("dry_air_3d", "sigma", "navier-stokes"),
    ("dry_air_roe_2d", "none", "navier-stokes"),
    ("dry_air_roe_2d", "none", "euler"),
    ("dry_air_roe_3d", "all", "navier-stokes"),
    ("dry_air_roe_3d", "none", "euler")])
def test_face_sweep_closure_and_roe_variants_match_plain(device, base,
                                                         closure, eq, dtype):
    """Each variant with the viscous flux's closures (the mixing length,
    an SGS model, the viscous sponge) and DryAir's Roe form against its
    plain version (face_sweep_plain with the closed Fluxes and Roe): f64
    1e-11 of max|plain|; f32 within 5e-5, or no farther from the f64 plain
    result than twice the f32 plain version; one launch, counted under
    its variant."""
    sw, X = _closure_case(base, closure, eq, dtype, device)
    want = base if closure == "none" or eq == "euler" else f"{base}_closure"
    assert sw.variant == want
    assert (sw.closure is not None) == want.endswith("_closure")
    cuda_faces.reset_launches()
    z = sw(X)
    torch.cuda.synchronize()
    assert cuda_faces.launches["face_sweep"] == 1
    assert cuda_faces.variant_launches[want] == 1
    plain = sw.plain(X)
    if dtype == torch.float64:
        assert _rel(z, plain) <= TOL[dtype]
    else:
        sw64, _ = _closure_case(base, closure, eq, torch.float64, device)
        ref = sw64.plain(X.double())
        assert (_rel(z, plain) <= TOL[dtype]
                or _rel(z.double(), ref) <= 2 * _rel(plain.double(), ref))


def test_coupled_channel_graph_matches_eager(device, f64, tmp_path):
    """tps_torch/tools/argon_channel_coupled.ini cut to 8x8 p=2 and 12 steps
    (EM updates at 0 and 10, the second between two replays): graph
    replays == eager steps (f64, 1e-12 of max|U|), 48 launches of the 2-D
    argon sweep each way, the Joule heating the same tensor throughout."""
    from tps_torch import harness

    deck = os.path.join(os.path.dirname(INPUTS), "..", "tps_torch", "tools",
                        "argon_channel_coupled.ini")
    text = open(deck).read().replace("nx = 64", "nx = 8").replace(
        "ny = 64", "ny = 8").replace("maxIters = 200", "maxIters = 12")
    out = {}
    for graphs in (True, False):
        path = tmp_path / f"channel_{graphs}.ini"
        path.write_text(text.replace(
            "outdirBase = output/argon_channel_coupled",
            f"outdirBase = {tmp_path / str(graphs)}"))
        tps = harness.Tps()
        tps.parse_command_line_args(["tps", "--runFile", str(path)])
        tps.parse_input()
        tps.choose_devices()
        tps.choose_solver()
        tps.initialize()
        c = tps.solver
        c.flow.cuda_graphs = graphs
        ptr = c.flow.joule_heating.data_ptr()
        cuda_faces.reset_launches()
        tps.solve()
        torch.cuda.synchronize()
        assert cuda_faces.variant_launches["argon_2d"] == 48
        assert cuda_faces.launches["face_sweep"] == 48
        assert c.flow.joule_heating.data_ptr() == ptr
        assert len(c.em_log) == 2
        out[graphs] = c.flow.state_global()
    np.testing.assert_allclose(out[True], out[False], rtol=0,
                               atol=1e-12 * np.max(np.abs(out[False])))


# ---------------------------------------------------------------- LTE


def _lte_case(var, n, dtype, device, tmp):
    """An LTE variant's sweep and input: the LTE fluid on
    tps_torch/tools/lte_argon_tables.py's tables (1-D, or 2-D written into
    tmp, "_t2"), Navier-Stokes or Euler ("_euler"), 2-D or 3-D by n; a
    periodic box of 0.01 m, a hot state (T 9,500 K with a 20% wave) and its
    DG gradient."""
    from tps_torch.config.ini import IniInput
    from tps_torch.physics.lte import load_lte_setup
    from tps_torch.tools.lte_argon_tables import lte_keys

    dim, euler = len(n), var.endswith("euler")
    mix, tr = load_lte_setup(IniInput.parse(lte_keys(
        2 if "_t2" in var else 1, str(tmp))), dim, dim)
    fl = Fluxes(mixture=mix, transport=tr,
                eq_system="euler" if euler else "navier-stokes")
    ctx = RHSContext(fluxes=fl, riemann=Rusanov(fl))
    mesh = (box_3d(*n, bounds=((0.0, 0.01),) * 3, periodic=(True,) * 3)
            if dim == 3 else box_2d(*n, x1=0.01, y1=0.01, periodic_x=True,
                                    periodic_y=True))
    tab_np = build_tables(mesh, 2)
    xyz = tab_np.xyz_dof
    wave = (np.sin(2 * np.pi / 0.01 * xyz[..., 0])
            * np.cos(2 * np.pi / 0.01 * xyz[..., 1]))
    Up = np.zeros(xyz.shape[:-1] + (dim + 2,))
    Up[..., 0] = 0.05 * (1 + 0.1 * wave)
    Up[..., 1] = 10.0 + 30.0 * wave
    Up[..., 2:1 + dim] = -5.0 * wave[..., None]
    Up[..., -1] = 9500.0 * (1 + 0.2 * wave)
    tab = tab_np.to_torch(torch.float64, device)
    U = mix.conservatives(torch.as_tensor(Up, device=device))
    X = U
    if not euler:
        G = dg_gradient(tab, mix.primitives(U))
        X = torch.cat([U, G.reshape(tab_np.ne, tab_np.ndof, -1)], -1)
    return build_face_sweep(tab_np.to_torch(dtype, device), ctx), \
        X.to(dtype).contiguous()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("var,n", [
    ("lte_2d", (8, 8)), ("lte_2d_euler", (8, 8)), ("lte_2d_t2", (6, 6)),
    ("lte_2d_t2_euler", (6, 6)), ("lte_3d", (3, 3, 3)),
    ("lte_3d_euler", (3, 3, 3)), ("lte_3d_t2", (3, 3, 3)),
    ("lte_3d_t2_euler", (3, 3, 3))])
def test_face_sweep_lte_variants_match_plain(device, tmp_path, var, n, dtype):
    """Each LTE variant against its plain version: f64 2.2e-13 of
    max|plain| (the same lookups and Newton steps); f32 within 5e-5, or no
    farther from the f64 plain result than twice the f32 plain version;
    one launch, counted under its variant."""
    sw, X = _lte_case(var, n, dtype, device, tmp_path)
    assert sw.variant == var and sw.physics == "lte"
    cuda_faces.reset_launches()
    z = sw(X)
    torch.cuda.synchronize()
    assert cuda_faces.launches["face_sweep"] == 1
    assert cuda_faces.variant_launches[var] == 1
    plain = sw.plain(X)
    if dtype == torch.float64:
        assert _rel(z, plain) <= 2.2e-13
    else:
        sw64, _ = _lte_case(var, n, torch.float64, device, tmp_path)
        ref = sw64.plain(X.double())
        assert (_rel(z, plain) <= TOL[dtype]
                or _rel(z.double(), ref) <= 2 * _rel(plain.double(), ref))


def test_lte_channel_graph_matches_eager(device, f64, tmp_path):
    """tps_torch/tools/lte_channel_coupled.ini cut to 8x8 p=2 and 12 steps
    (EM updates at 0 and 10): graph replays == eager steps (f64, 1e-12 of
    max|U|), 48 launches of the 2-D LTE sweep each way."""
    from tps_torch import harness

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    text = open(os.path.join(repo, "tps_torch", "tools",
                             "lte_channel_coupled.ini")).read()
    text = text.replace("nx = 64", "nx = 8").replace(
        "ny = 64", "ny = 8").replace("maxIters = 200", "maxIters = 12")
    for rel in ("tps_torch/tools/lte_argon_thermo.h5",
                "tps_torch/tools/lte_argon_trans.h5",
                "examples/cases/nec_table.h5"):
        text = text.replace(rel, os.path.join(repo, rel))
    out = {}
    for graphs in (True, False):
        path = tmp_path / f"lte_{graphs}.ini"
        path.write_text(text.replace(
            "outdirBase = output/lte_channel_coupled",
            f"outdirBase = {tmp_path / str(graphs)}"))
        tps = harness.Tps()
        tps.parse_command_line_args(["tps", "--runFile", str(path)])
        tps.parse_input()
        tps.choose_devices()
        tps.choose_solver()
        tps.initialize()
        c = tps.solver
        c.flow.cuda_graphs = graphs
        cuda_faces.reset_launches()
        tps.solve()
        torch.cuda.synchronize()
        assert cuda_faces.variant_launches["lte_2d"] == 48
        assert cuda_faces.launches["face_sweep"] == 48
        assert len(c.em_log) == 2
        out[graphs] = c.flow.state_global()
    np.testing.assert_allclose(out[True], out[False], rtol=0,
                               atol=1e-12 * np.max(np.abs(out[False])))


# ---------------------------------------------------------------- low-Mach

LOMACH_TGV = os.path.join(os.path.dirname(__file__), "inputs",
                          "lomach_tgv2d.ini")
LOMACH_CHANNEL = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                              "examples", "cases", "channel_rans.ini")


def _lomach(deck, outdir, graphs, iters, keys=None):
    from tps_torch import harness

    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", deck])
    tps.parse_input()
    tps.config.outdir = str(outdir)
    tps.config.raw.values["loMach/maxIters"] = str(iters)
    for k, v in (keys or {}).items():
        tps.config.raw.values[k] = v
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    tps.solver.cuda_graphs = graphs
    tps.solve()
    return tps.solver


def test_h1_operator_is_repeatable_on_card(device):
    """The H1 stiffness apply (gather, matmuls, the dof_gather sum: no
    atomics) gives the same bits twice on the card, and the CPU's result
    within 1e-12 of max|y| (f64)."""
    from tps_torch.fem import h1

    tab_np = h1.build_h1(box_2d(16, 16), 3)
    rng = np.random.default_rng(0)
    u, c = rng.standard_normal(tab_np.ndofs), 1.0 + rng.random(tab_np.ndofs)
    ys = []
    for dev in (device, device, "cpu"):
        tab = tab_np.to_torch(torch.float64, dev)
        ys.append(h1.diffusion_apply(
            tab, torch.as_tensor(u, device=dev),
            torch.as_tensor(c, device=dev)).cpu())
    assert torch.equal(ys[0], ys[1])
    assert float((ys[0] - ys[2]).abs().max()) <= 1e-12 * float(
        ys[2].abs().max())


def test_lomach_graph_matches_eager(device, f64, tmp_path, monkeypatch):
    """The TGV deck at 16x16 p=3 with p-multigrid (the dense cutoff set
    below it), 10 steps through solve(): graph replays == eager steps,
    bitwise, with the same CG iterations every step."""
    from tps_torch.fem import h1

    monkeypatch.setattr(h1, "DENSE_DIRECT_MAX", 0)
    keys = {"mesh/nx": "16", "mesh/ny": "16"}
    g = _lomach(LOMACH_TGV, tmp_path / "g", True, 10, keys)
    e = _lomach(LOMACH_TGV, tmp_path / "e", False, 10, keys)
    assert g._graphs and not e._graphs
    assert torch.equal(g.flow.u, e.flow.u) and torch.equal(g.flow.p, e.flow.p)
    assert g.info_log == e.info_log and len(g.info_log) == 10


def test_lomach_dense_refresh_inside_capture_window(device, f64, tmp_path):
    """channel_rans.ini, 20 steps: the dense factors are refreshed at steps
    0 and 16, the second between two replays, into the tensors the graph
    reads; graph == eager bitwise."""
    g = _lomach(LOMACH_CHANNEL, tmp_path / "g", True, 20)
    e = _lomach(LOMACH_CHANNEL, tmp_path / "e", False, 20)
    assert g.flow.refreshes == e.flow.refreshes == 2 and g._graphs
    for name in ("k", "eps", "v2", "f"):
        assert torch.equal(getattr(g.turb, name), getattr(e.turb, name))
    assert torch.equal(g.flow.u, e.flow.u)
    assert g.info_log == e.info_log


def test_lomach_capture_after_a_dead_solver(device, f64, tmp_path,
                                            monkeypatch):
    """A solver dropped in a reference cycle, its step graphs with it, and
    a collection forced inside the next solver's capture (at each CG
    solve's split): the capture holds, since the dead graphs went before it
    began (a graph destroyed inside a capture ends the capture)."""
    import gc

    from tps_torch.solvers.lomach.step_graph import StepGraph

    split = StepGraph.split

    def collecting(self, *args):
        gc.collect()
        return split(self, *args)

    monkeypatch.setattr(StepGraph, "split", collecting)
    enabled = gc.isenabled()
    gc.disable()  # the dead solver lives until a collection
    try:
        old = _lomach(LOMACH_TGV, tmp_path / "a", True, 4)
        assert old._graphs
        old.cycle = old
        del old
        s = _lomach(LOMACH_TGV, tmp_path / "b", True, 4)
    finally:
        if enabled:
            gc.enable()
    assert s._graphs and s.iter == 4


CASES_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "examples", "cases")
COUPLED_KEYS = {
    "loMach/ltethermo/table-file": os.path.join(CASES_DIR, "lte_table.h5"),
    "plasma_models/radiation_model/net_emission/tabulated/filename":
        os.path.join(CASES_DIR, "nec_table.h5")}


def test_coupled_graph_matches_eager_across_an_em_update(device, f64,
                                                         tmp_path):
    """torch_axisym_coupled.ini, 20 steps through the coupled solve(), EM
    updates at steps 0 and 10 (the second between two replays): graph ==
    eager bitwise, the same CG iterations every step.  The Joule heating
    and E-field reach the captured step by copies into the tensors it
    reads (a rebound tensor would leave the replays heating with the old
    field)."""
    from tps_torch import harness

    runs = []
    for graphs in (True, False):
        tps = harness.Tps()
        tps.parse_command_line_args(
            ["tps", "--runFile",
             os.path.join(CASES_DIR, "torch_axisym_coupled.ini")])
        tps.parse_input()
        tps.config.outdir = str(tmp_path / str(graphs))
        tps.config.raw.values.update(COUPLED_KEYS)
        tps.config.raw.values["loMach/maxIters"] = "20"
        tps.choose_devices()
        tps.choose_solver()
        tps.initialize()
        tps.solver.flow.cuda_graphs = graphs
        tps.solve()
        runs.append(tps.solver)
    g, e = runs
    assert len(g.em_log) == len(e.em_log) == 2 and g.flow._graphs
    for name in ("T", "joule_heating"):
        assert torch.equal(getattr(g.flow.thermo, name),
                           getattr(e.flow.thermo, name))
    for name in ("u", "ut", "p"):
        assert torch.equal(getattr(g.flow.flow, name),
                           getattr(e.flow.flow, name))
    assert torch.equal(g.em.A_re, e.em.A_re)
    assert torch.equal(g.flow.efield, e.flow.efield)
    assert g.flow.info_log == e.flow.info_log
    assert [x["joule"] for x in g.em_log] == [x["joule"] for x in e.em_log]


def test_gmres_on_card_matches_cpu(device, f64, monkeypatch):
    """The shipped deck's EM solve (16x24 p=1) on GMRES-IR (the dense
    path off): the same iterations on the card and the CPU, both below
    1e-10 relative residual, their difference mapped by the block
    operator within 2e-10 of |b| (the f32 cycles round otherwise)."""
    from tps_torch.config.ini import IniInput
    from tps_torch.config.run_config import parse_run_configuration
    from tps_torch.fem import h1
    from tps_torch.solvers.em.qms import QuasiMagnetostaticSolverAxiSym

    monkeypatch.setattr(h1, "DENSE_DIRECT_MAX", 0)
    rc = parse_run_configuration(IniInput.read(
        os.path.join(CASES_DIR, "torch_axisym_coupled.ini")))
    ems = []
    for dev in (device, "cpu"):
        em = QuasiMagnetostaticSolverAxiSym(rc, device=dev)
        em.initialize()
        xyz = em.tab_np.xyz
        em.set_plasma_conductivity(torch.as_tensor(
            2000.0 * np.exp(-(xyz[:, 0] / 0.006) ** 2
                            - ((xyz[:, 1] - 0.04) / 0.02) ** 2)))
        em.solve_step()
        ems.append(em)
    card, cpu = ems
    assert card.last_solve_iters == cpu.last_solve_iters > 30
    assert max(card.last_solve_relres, cpu.last_solve_relres) <= 1e-10
    _, _, apply, b = cpu._operands(cpu.plasma_conductivity)
    d = torch.cat([card.A_re.cpu() - cpu.A_re, card.A_im.cpu() - cpu.A_im])
    assert float(torch.linalg.norm(apply(d)) / torch.linalg.norm(b)) <= 2e-10


REACTING_DECK = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                             "tps_torch", "tools", "lomach_reacting.ini")
REACTING_KEYS = {"mesh/nx": "12", "mesh/ny": "24"}


def test_reacting_graph_matches_eager_across_a_refresh(device, f64,
                                                       tmp_path):
    """lomach_reacting.ini cut to 12x24, 20 steps through solve(): the
    thermo's and the flow's dense factors refreshed again at step 17,
    between two replays; graph == eager bitwise (T, Y, p_thermo, u, p),
    the same CG iterations every step."""
    g = _lomach(REACTING_DECK, tmp_path / "g", True, 20, REACTING_KEYS)
    e = _lomach(REACTING_DECK, tmp_path / "e", False, 20, REACTING_KEYS)
    assert g._graphs and not e._graphs
    assert g.thermo.refreshes == e.thermo.refreshes == 2
    assert next(iter(g._graphs.values())).replays == 17
    for name in ("T", "Y", "Qt", "p_thermo"):
        assert torch.equal(getattr(g.thermo, name), getattr(e.thermo, name))
    assert torch.equal(g.flow.u, e.flow.u) and torch.equal(g.flow.p, e.flow.p)
    assert g.info_log == e.info_log and len(g.info_log) == 20


def test_interpolated_inlet_graph_matches_eager_inside_its_ramp(
        device, f64, tmp_path):
    """A channel with an interpolated inlet (rampSteps 12, its device step
    counter advanced inside the graph) and a plane sponge, 8 steps: graph
    == eager bitwise, the ramp at 8/12 in both, the BC tensors the same
    objects after the run."""
    csv = tmp_path / "inlet.csv"
    with open(csv, "w") as fh:
        fh.write("# no, x, y, z, T, u, v, w\n")
        for i, y in enumerate(np.linspace(0.0, 0.25, 30)):
            fh.write(f"{i},0.0,{y},0.0,{320 + 100 * y},"
                     f"{64 * y * (0.25 - y)},0.0,0.0\n")
    deck = tmp_path / "deck.ini"
    deck.write_text(f"""
[solver]
type = loMach
[mesh]
generator = box2d
nx = 8
ny = 4
x1 = 1.0
y1 = 0.25
[loMach]
order = 2
flow-solver = tomboulides
thermo-solver = calorically-perfect
[loMach/calperfect]
viscosity-model = constant
viscosity/mu = 5e-3
[time]
dt_fixed = 1e-3
[spongeMultiplier]
plane = 1
planePoint = '0.7 0.0 0.0'
planeNormal = '1.0 0.0 0.0'
planeWidth = 0.05
planeMult = 20.0
[boundaryConditions/inlet1]
patch = 4
type = interpolate
name = {csv}
rampSteps = 12
[boundaryConditions/wall1]
patch = 1
type = viscous
temperature = 300.0
[boundaryConditions/wall2]
patch = 3
type = viscous
[boundaryConditions/outlet1]
patch = 2
type = outlet
""")
    g = _lomach(str(deck), tmp_path / "g", True, 8)
    e = _lomach(str(deck), tmp_path / "e", False, 8)
    assert g._graphs and float(g.ext_data[0].count) == 8.0
    for a, b in ((g.flow.u, e.flow.u), (g.flow.p, e.flow.p),
                 (g.thermo.T, e.thermo.T),
                 (g.flow.vel_bc_values, e.flow.vel_bc_values),
                 (g.thermo.T_bc, e.thermo.T_bc)):
        assert torch.equal(a, b)
    assert g.info_log == e.info_log


def test_reacting_step_on_card_matches_cpu(device, f64):
    """One ReactingFlow step of the deck (12x24 p=2, the argon full tier
    from the deck's IC, its dense refresh) on the card and on the CPU: T,
    Y and Qt within 1e-10 of max."""
    from tps_torch import harness
    from tps_torch.solvers.lomach.base import TemporalCoefficients

    out = []
    for dev in ("cuda", "cpu"):
        tps = harness.Tps()
        tps.parse_command_line_args(["tps", "--runFile", REACTING_DECK,
                                     "--device", dev])
        tps.parse_input()
        tps.config.raw.values.update(REACTING_KEYS)
        tps.choose_devices()
        tps.choose_solver()
        tps.initialize()
        s = tps.solver
        s._refresh(s.thermo, 1)
        s.thermo.step(TemporalCoefficients.bdf(1), s.dt)
        out.append({k: getattr(s.thermo, k).cpu() for k in ("T", "Y", "Qt")})
    for k in out[0]:
        d = float((out[0][k] - out[1][k]).abs().max())
        assert d <= 1e-10 * float(out[1][k].abs().max()), k


# ------------------------------------------- the forcings and the MMS decks

FORCED_CHANNEL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tps_torch", "tools", "forced_channel3d.ini")
MASA3D_DECK = """
[solver]
type = flow
[flow]
order = 1
basisType = 0
integrationRule = 0
maxIters = {iters}
outputFreq = {iters}
timingFreq = 100000
equation_system = euler
fluid = dry_air
[mesh]
generator = box3d
nx = 3
ny = 3
nz = 3
x1 = 2.0
y1 = 2.0
z1 = 2.0
periodic_x = 1
periodic_y = 1
periodic_z = 1
[time]
integrator = rk4
dt_fixed = 2e-5
enableConstantTimestep = True
[mms]
isEnabled = True
name = euler_transient_3d
[io]
outdirBase = {out}
"""


def _deck_tps(path, device, graphs=True):
    from tps_torch import harness

    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", str(path), "--device",
                                 device])
    tps.parse_input()
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    tps.solver.cuda_graphs = graphs
    return tps


def _forced_channel_text(out, target="userDef", iters=4):
    text = open(FORCED_CHANNEL).read()
    for old, new in (("nx = 32", "nx = 8"), ("ny = 16", "ny = 4"),
                     ("nz = 16", "nz = 4"), ("maxIters = 200",
                                             f"maxIters = {iters}"),
                     ("outdirBase = output/forced_channel3d",
                      f"outdirBase = {out}")):
        text = text.replace(old, new)
    if target == "mixedOut":
        text = text.replace("targetSolType = userDef",
                            "targetSolType = mixedOut\ntolerance = 0.3")
    return text


@pytest.mark.parametrize("target", ["userDef", "mixedOut"])
def test_forced_channel_graph_eager_and_cpu(device, f64, tmp_path, target):
    """tps_torch/tools/forced_channel3d.ini cut to 8x4x4 (pressure forcing,
    a heat source, a planar sponge with a userDef or mixedOut target), 4
    RK4 steps through solve(): graph replays == eager steps (1e-12 of
    max|U|), card == the CPU (1e-9), the dry_air_3d sweep 4 times a step
    on the card and no other kernel."""
    path = tmp_path / "forced.ini"
    path.write_text(_forced_channel_text(tmp_path / "o", target))
    out = {}
    for name, dev, graphs in (("graph", "cuda", True), ("eager", "cuda", False),
                              ("cpu", "cpu", True)):
        tps = _deck_tps(path, dev, graphs)
        cuda_fused.reset_launches()
        cuda_faces.reset_launches()
        tps.solve()
        s = tps.solver
        if dev == "cuda":
            torch.cuda.synchronize()
            assert _counts() == {"face_sweep": 16, "k1_gradient": 0,
                                 "k2_faces_volume": 0}
            assert cuda_faces.variant_launches["dry_air"] == 16
            assert (s._loop.graph is not None) == graphs
        out[name] = s.state_global()
    scale = np.max(np.abs(out["eager"]))
    np.testing.assert_allclose(out["graph"], out["eager"], rtol=0,
                               atol=1e-12 * scale)
    np.testing.assert_allclose(out["graph"], out["cpu"], rtol=0,
                               atol=1e-9 * scale)


def test_transient_mms_graph_eager_and_cpu(device, f64, tmp_path):
    """The transient 3-D MASA source (nested torch.func.jacfwd at the step
    loop's device time) under the step graph: 4 RK4 steps at 3^3 p=1,
    graph == eager (1e-12 of max|U|), card == CPU (1e-9), the L2 solution
    error the same."""
    path = tmp_path / "m3d.ini"
    path.write_text(MASA3D_DECK.format(iters=4, out=tmp_path / "o"))
    out = {}
    for name, dev, graphs in (("graph", "cuda", True), ("eager", "cuda", False),
                              ("cpu", "cpu", True)):
        tps = _deck_tps(path, dev, graphs)
        cuda_faces.reset_launches()
        tps.solve()
        s = tps.solver
        if dev == "cuda":
            torch.cuda.synchronize()
            assert cuda_faces.launches["face_sweep"] == 16
            assert (s._loop.graph is not None) == graphs
        out[name] = (s.state_global(), s.mms_solution_error(), float(s.time))
    scale = np.max(np.abs(out["eager"][0]))
    np.testing.assert_allclose(out["graph"][0], out["eager"][0], rtol=0,
                               atol=1e-12 * scale)
    np.testing.assert_allclose(out["graph"][0], out["cpu"][0], rtol=0,
                               atol=1e-9 * scale)
    np.testing.assert_allclose(out["graph"][1:], out["cpu"][1:], rtol=1e-9)


def test_forcings_on_card_match_cpu(device, f64):
    """Each forcing and the MASA sources at the nodes of a 4x4x2 box, on
    the card against the CPU (f64, 1e-12 of max).  The state streams
    through the sponges' sampling planes (w ~ 30 m/s along their normal):
    the mixed-out target divides by the mean mass flux there, so a state
    with none would make it 0/0."""
    from tps_torch.dg import forcing as tf
    from tps_torch.utils.masa import MasaHandler

    mix = DryAir(dim=3, nvel=3)
    tab_np = build_tables(box_3d(4, 4, 2, bounds=((-1.0, 1.0), (-1.0, 1.0),
                                                   (0.0, 1.0)),
                                 periodic=(False, False, True)), 1)
    rng = np.random.default_rng(12)
    Up = np.empty(tab_np.xyz_dof.shape[:-1] + (5,))
    Up[..., 0] = rng.uniform(1.0, 1.4, Up.shape[:-1])
    Up[..., 1:4] = rng.uniform(-15.0, 15.0, Up.shape[:-1] + (3,))
    Up[..., 3] += 30.0
    Up[..., 4] = rng.uniform(280.0, 320.0, Up.shape[:-1])
    grad = torch.as_tensor(rng.standard_normal(Up.shape + (3,)) * 30.0)
    target = tf.sponge_target_conserved(mix, 1.0, (0.0, 2.0, 1.0), 86117.4)
    fl = Fluxes(mixture=mix)
    sponge = dict(normal=(0.0, 0.0, -1.0), p0=(0.0, 0.0, 1.0),
                  p_init=(0.0, 0.0, 0.0), mult=0.7)
    annulus = dict(sponge, sz_type="annulus", r1=0.2, r2=1.0)
    forcings = [
        tf.ConstantPressureGradient(mixture=mix, press_grad=(-0.9, 0.2, 0.0)),
        tf.HeatSource(mixture=mix, value=1e7, point1=(0.0, 0.0, -1.0),
                      point2=(0.0, 0.0, 2.0), radius=0.5),
        tf.SpongeZone(mixture=mix, target_u=target, **sponge),
        tf.SpongeZone(mixture=mix, target_u=target, **annulus),
        tf.SpongeZone(mixture=mix, target_u=None, sol_type="mixedOut",
                      tol=0.3, fluxes=fl, **sponge),
        tf.SpongeZone(mixture=mix, target_u=None, sol_type="mixedOut",
                      tol=0.3, fluxes=fl, **annulus),
        MasaHandler("euler_transient_3d", mix,
                    Fluxes(mixture=mix, eq_system="euler")).make_forcing(),
        MasaHandler("navierstokes_3d_transient_sutherland", mix,
                    Fluxes(mixture=mix, transport=DryAirTransport(
                        mix.gas_constant, mix.specific_heat_ratio),
                        eq_system="navier-stokes")).make_forcing()]
    res = {}
    for dev in ("cpu", device):
        tab = tab_np.to_torch(torch.float64, dev)
        U = mix.conservatives(torch.as_tensor(Up)).to(dev)
        t = torch.tensor(1.1e-3, device=dev)
        res[str(dev)] = [f(t, tab, U, mix.primitives(U), grad.to(dev))
                         for f in forcings]
    errs = [_rel(a.cpu(), b) for a, b in zip(res[str(device)], res["cpu"])]
    assert max(errs) <= 1e-12, errs


def test_compute_rhs_tool_on_card(device, tmp_path):
    """tps_torch/tools/compute_rhs.py on the euler MMS deck cut to 16x16
    (f64): the card's relative RHS errors == the CPU's (1e-10; quotients
    of a residual ~1e-3 of the source), one face-sweep launch."""
    from tps_torch.tools import compute_rhs as tool

    src = open(os.path.join(INPUTS, "mms.euler.2d.quad.ini")).read()
    src = (src.replace("nx = 160", "nx = 16").replace("ny = 160", "ny = 16")
           .replace("outdirBase = output", f"outdirBase = {tmp_path}")
           .replace("filename = euler_2d", f"filename = {tmp_path}/euler_2d"))
    path = tmp_path / "mms.ini"
    path.write_text(src)
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        got = {}
        for dev in ("cpu", "cuda"):
            s = tool.build_solver(str(path), dev)
            cuda_faces.reset_launches()
            got[dev] = tool.rhs_rel_errors(s)[0]
            if dev == "cuda":
                assert cuda_faces.launches["face_sweep"] == 1
    finally:
        torch.set_default_dtype(old)
    np.testing.assert_allclose(got["cuda"], got["cpu"], rtol=1e-10)
