"""The CUDA kernels K1/K2 and the face sweep == their plain PyTorch
versions, on a GPU (K1 on its compressed folds against the dense plain
gradient), with Sutherland and constant transport, on boxes, the curved
cylinder O-grid and a hex mesh read from an MFEM file; the solver's step
graph == its eager steps, with a characteristic outlet's ghost state in
the loop's buffers; a checkpoint read on the card continues the run.

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
                                       (9, 4, 4, 18, 6), (27, 16, 6, 28, 7)):
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
