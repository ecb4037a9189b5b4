"""The CUDA kernels K1/K2 and the face sweep == their plain PyTorch
versions, on a GPU.

Marked `cuda`; each test skips where torch.cuda.is_available() is false.
This file imports no jax, so on a machine without it run it alone, past
the suite's jax-configuring conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Bars: 1e-11 (f64) and 5e-5 (f32) relative to max|plain|; the two sum the
same products in another order.  TF32 is off for the plain version.
"""

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
from tps_torch.physics.transport import DryAirTransport  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float64: 1e-11, torch.float32: 5e-5}


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
    # periodic extents 1 and 2 (self- and double neighbors); 6 and 27
    # elements, ragged tiles
    ((1, 2, 3), 2, "navier-stokes"),
    ((3, 3, 3), 2, "euler"),
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
        assert _rel(rhs.gradient(U), G_ref) <= TOL[dtype]


def test_wrapper_rejects_bad_input(device):
    rhs, U = _setup((3, 3, 3), 2, "navier-stokes", torch.float32, device)
    with pytest.raises(ValueError):
        rhs.gradient(U.double())
    with pytest.raises(ValueError):
        rhs.gradient(U.transpose(1, 2).contiguous().transpose(1, 2))


# ---------------------------------------------------------------- face sweep


def _face_case(n, order, eq_system, basis, dtype, device):
    """Slot-mode sweep on a walled box and X = [U | G] from a seeded state."""
    dim = len(n)
    kw = {} if basis == "gl" else dict(basis="gauss-lobatto",
                                       quad_rule="gauss-lobatto")
    mesh = (box_3d(*n, periodic=(False,) * 3) if dim == 3
            else box_2d(*n, periodic_x=False, periodic_y=False))
    tab_np = build_tables(mesh, order, **kw)
    mix = DryAir(dim=dim, nvel=dim)
    tr = None if eq_system == "euler" else DryAirTransport(
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


def test_shared_memory_plans_match_the_kernels(device):
    """The Python plans (tiles and shared bytes) are the kernels' own."""
    import ctypes

    from tps_torch.dg.cuda_fused import _Library, build_kernels

    build_kernels()
    lib = _Library.lib
    tile = ctypes.c_int()
    for dtype in (torch.float32, torch.float64):
        size = torch.empty((), dtype=dtype).element_size()
        for ndof, nqf in ((27, 16), (64, 25), (125, 36), (216, 49), (343, 64)):
            for viscous in (True, False):
                E, _res, smem = cuda_fused.k2_plan(ndof, nqf, viscous, dtype)
                assert lib.tps_k2_smem(ndof, nqf, int(viscous), size,
                                       ctypes.byref(tile)) == smem
                assert tile.value == E
        for ndof, nqf, nlf, k, neq in ((27, 25, 6, 20, 5), (27, 16, 6, 5, 5),
                                       (64, 36, 6, 20, 5), (512, 100, 6, 20, 5),
                                       (16, 5, 4, 12, 4), (9, 4, 4, 4, 4)):
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
