"""tps_torch's boundary conditions == the JAX package's, on the CPU in f64.

Each BC of this slice (far field, stateless characteristic inlets,
face-based inlet, general wall, the time-integrated characteristic outlets
and inlets) gives the JAX package's flux, and each stateful one its
`advance`, within 1e-12 on seeded random boundary data in 2-D and 3-D.
Then the far field is well balanced on the cylinder O-grid, and two decks
run through both packages' chunked solve() to 1e-10: the shipped cylinder
deck (examples/cases/cyl2d_ogrid.ini at 6x24, 10 steps) and a channel read
from an MFEM file (one uniform refinement) with a characteristic inlet and
a nonReflectingPressure outlet.
"""

import os
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tps_torch import harness  # noqa: E402
from tps_torch.dg import bc as pbc  # noqa: E402
from tps_torch.dg.fluxes import Fluxes  # noqa: E402
from tps_torch.dg.riemann import Rusanov  # noqa: E402
from tps_torch.dg.rhs import RHSContext  # noqa: E402
from tps_torch.physics.gas import DryAir  # noqa: E402
from tps_torch.physics.transport import DryAirTransport  # noqa: E402
from tps_tpu.dg import bc as jbc  # noqa: E402
from tps_tpu.dg.fluxes import Fluxes as JFluxes  # noqa: E402
from tps_tpu.dg.rhs import RHSContext as JRHSContext  # noqa: E402
from tps_tpu.dg.riemann import Rusanov as JRusanov  # noqa: E402
from tps_tpu.physics.gas import DryAir as JDryAir  # noqa: E402
from tps_tpu.physics.transport import DryAirTransport as JDryAirTransport  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-12


class _JAir(JDryAir):
    """The JAX package's DryAir with the electron index its general wall
    reads (tps_tpu/dg/bc.py:257), which DryAir lacks: for one species and
    one temperature the index is never used."""

    i_electron = 0


def _ctxs(dim, eq_system="navier-stokes"):
    mix, jmix = DryAir(dim=dim, nvel=dim), _JAir(dim=dim, nvel=dim)
    ns = eq_system != "euler"
    fl = Fluxes(mixture=mix, eq_system=eq_system, transport=DryAirTransport(
        mix.gas_constant, mix.specific_heat_ratio) if ns else None)
    jfl = JFluxes(mixture=jmix, eq_system=eq_system, transport=JDryAirTransport(
        jmix.gas_constant, jmix.specific_heat_ratio) if ns else None)
    return (RHSContext(fluxes=fl, riemann=Rusanov(fl)),
            JRHSContext(fluxes=jfl, riemann=JRusanov(jfl)))


def _data(dim, seed, nf=3, nqf=4):
    """Random boundary data: interior traces around a free stream of 30 m/s
    (points of both inflow and outflow), primitive gradients, scaled
    normals, points, sizes, weights x |n| and a ghost state."""
    rng = np.random.default_rng(seed)
    shp = (nf, nqf)
    Up = np.empty(shp + (dim + 2,))
    Up[..., 0] = rng.uniform(1.0, 1.4, shp)
    Up[..., 1:1 + dim] = rng.uniform(-40.0, 40.0, shp + (dim,))
    Up[..., dim + 1] = rng.uniform(270.0, 330.0, shp)
    mix = DryAir(dim=dim, nvel=dim)
    UL = mix.conservatives(torch.as_tensor(Up)).numpy()
    Ug = Up.copy()
    Ug[..., 0] *= rng.uniform(0.95, 1.05, shp)
    Ug[..., dim + 1] += rng.uniform(-5.0, 5.0, shp)
    state = mix.conservatives(torch.as_tensor(Ug)).numpy()
    grad = rng.standard_normal(shp + (dim + 2, dim)) * 50.0
    nor = rng.standard_normal(shp + (dim,)) * rng.uniform(0.5, 2.0, shp)[..., None]
    xyz = rng.standard_normal(shp + (dim,))
    delta = rng.uniform(0.1, 0.2, (nf, 1))
    wts = rng.uniform(0.1, 1.0, shp)
    return dict(UL=UL, grad=grad, nor=nor, xyz=xyz, delta=delta, wts=wts,
                state=state)


def _bcs(name, dim):
    """(port BC, JAX BC) of case `name` in `dim` dimensions."""
    vel = (30.0, -4.0, 2.0)[:dim]
    c = {
        "farfield": lambda m: m.FarFieldBC(input_state=(1.2, *vel, 101300.0)),
        "nonreflecting": lambda m: m.NonReflectingInletBC(
            input_state=(1.15, *vel)),
        "nonreflectingConstEntropy": lambda m: m.NonReflectingInletBC(
            input_state=(1.15, *vel), kind="nonreflectingConstEntropy"),
        "faceX": lambda m: m.FaceInletBC(input_state=(1.2, 25.0, 3.0),
                                         tangent_axis=0),
        "faceY": lambda m: m.FaceInletBC(input_state=(1.2, 25.0, 3.0),
                                         tangent_axis=1),
        "faceZ": lambda m: m.FaceInletBC(input_state=(1.2, 25.0, 3.0),
                                         tangent_axis=2),
        "general_isothermal": lambda m: m.GeneralWallBC(
            heavy="isothermal", wall_temp=310.0),
        "general_adiabatic": lambda m: m.GeneralWallBC(heavy="adiabatic"),
        "outlet_pressure": lambda m: m.CharacteristicOutletBC(
            kind="nonReflectingPressure", pressure=101000.0, ref_length=0.7),
        "outlet_massflow": lambda m: m.CharacteristicOutletBC(
            kind="nonReflectingMassFlow", mass_flow=3.0, area=0.1,
            ref_length=0.7),
        "outlet_pointmassflow": lambda m: m.CharacteristicOutletBC(
            kind="nonReflectingPointBasedMassFlow", mass_flow=3.0, area=0.1,
            ref_length=0.7),
        "inlet_characteristic": lambda m: m.CharacteristicInletBC(
            input_state=(1.18, *vel), ref_length=0.7),
        "inlet_const_entropy": lambda m: m.CharacteristicInletBC(
            input_state=(1.18, *vel), ref_length=0.7, const_entropy=True),
    }[name]
    return c(pbc), c(jbc)


FLUX_CASES = ["farfield", "nonreflecting", "nonreflectingConstEntropy",
              "faceX", "faceY", "faceZ", "general_isothermal",
              "general_adiabatic", "outlet_pressure", "outlet_massflow",
              "inlet_characteristic"]
STATEFUL = ["outlet_pressure", "outlet_massflow", "outlet_pointmassflow",
            "inlet_characteristic", "inlet_const_entropy"]


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) <= TOL * np.max(np.abs(b)), \
        np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("name", FLUX_CASES)
def test_bc_flux_matches_jax(name, dim):
    ctx, jctx = _ctxs(dim)
    b, jb = _bcs(name, dim)
    d = _data(dim, seed=7 + dim)
    T = {k: torch.as_tensor(v) for k, v in d.items()}
    J = {k: jnp.asarray(v) for k, v in d.items()}
    mix, jmix = ctx.mixture, jctx.mixture
    has_state = getattr(b, "has_state", False)
    f = b.flux(ctx, T["UL"], mix.primitives(T["UL"]), T["grad"], T["nor"],
               T["xyz"], T["delta"], 0.0, state=T["state"] if has_state
               else None, wts=T["wts"])
    jf = jb.flux(jctx, J["UL"], jmix.primitives(J["UL"]), J["grad"], J["nor"],
                 J["xyz"], J["delta"], 0.0, state=J["state"] if has_state
                 else None, wts=J["wts"])
    _close(f.numpy(), jf)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("name", STATEFUL)
def test_bc_advance_matches_jax(name, dim):
    ctx, jctx = _ctxs(dim)
    b, jb = _bcs(name, dim)
    d = _data(dim, seed=3 + dim)
    T = {k: torch.as_tensor(v) for k, v in d.items()}
    J = {k: jnp.asarray(v) for k, v in d.items()}
    dt = 2.5e-6
    new = b.advance(ctx, T["state"], T["UL"], ctx.mixture.primitives(T["UL"]),
                    T["grad"], T["nor"], T["wts"],
                    torch.tensor(dt, dtype=torch.float64))
    jnew = jb.advance(jctx, J["state"], J["UL"],
                      jctx.mixture.primitives(J["UL"]), J["grad"], J["nor"],
                      J["wts"], dt)
    _close(new.numpy(), jnew)
    assert np.max(np.abs(new.numpy() - d["state"])) > 0  # it moved


def test_general_wall_euler_and_refusals():
    """The general wall under Euler is its Riemann flux alone (as in the
    JAX package), whatever its electron condition; the mixture's and the
    sheath's viscous parts are held in tests/test_torch_mixture_bc.py."""
    ctx, jctx = _ctxs(2, "euler")
    b, jb = _bcs("general_isothermal", 2)
    d = _data(2, seed=1)
    T = {k: torch.as_tensor(v) for k, v in d.items()}
    f = b.flux(ctx, T["UL"], ctx.mixture.primitives(T["UL"]), None, T["nor"],
               T["xyz"], T["delta"], 0.0)
    UL = jnp.asarray(d["UL"])
    jf = jb.flux(jctx, UL, jctx.mixture.primitives(UL), None,
                 jnp.asarray(d["nor"]), None, None, 0.0)
    _close(f.numpy(), jf)
    sheath = pbc.GeneralWallBC(electron="sheath", wall_temp=b.wall_temp)
    fs = sheath.flux(ctx, T["UL"], ctx.mixture.primitives(T["UL"]), None,
                     T["nor"], T["xyz"], T["delta"], 0.0)
    _close(fs.numpy(), jf)


def test_farfield_well_balanced_annulus():
    """A uniform free stream with far-field BCs on both circles of the
    O-grid (tests/test_farfield_cyl.py:12-49, through the port): the RHS
    vanishes to roundoff."""
    from tps_torch.dg.discretization import build_tables
    from tps_torch.dg.rhs import bc_slices, compute_rhs
    from tps_torch.mesh.generators import annulus_2d
    from tps_torch.utils.cases import uniform_state

    ctx, _ = _ctxs(2)
    mix = ctx.mixture
    tab_np = build_tables(annulus_2d(4, 24, r0=0.5, r1=4.0), order=2)
    tab = tab_np.to_torch(torch.float64, "cpu")
    rho, u0, T0 = 1.2, 40.0, 300.0
    ff = pbc.FarFieldBC(input_state=(rho, u0, 0.0, rho * mix.gas_constant * T0))
    ctx = RHSContext(fluxes=ctx.fluxes, riemann=ctx.riemann,
                     bcs=bc_slices(tab_np.f_bdr_attr, lambda p: ff))
    U = mix.conservatives(uniform_state(tab.xyz_dof, mix, rho, (u0, 0.0), T0))
    dU, _ = compute_rhs(ctx, tab, U)
    assert float(torch.max(torch.abs(dU))) < 1e-8 * float(torch.max(torch.abs(U)))


@pytest.fixture
def f64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _both_solve(path):
    """The deck through the port's CLI surface (device cpu) and the JAX
    package's, each its chunked solve(): U, t and dt to 1e-10."""
    from tps_tpu import harness as jharness

    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", str(path), "--device",
                                 "cpu"])
    tps.parse_input()
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    s = tps.solver
    jtps = jharness.Tps()
    jtps.parse_input(str(path))
    jtps.choose_solver()
    jtps.initialize()
    js = jtps.solver
    U0 = s.state_global().copy()
    s.solve()
    js.solve()
    U, Uj = s.state_global(), np.asarray(js.state_global())
    np.testing.assert_allclose(U, Uj, rtol=1e-10,
                               atol=1e-10 * np.max(np.abs(Uj)))
    np.testing.assert_allclose(float(s.time), float(js.time), rtol=1e-10)
    np.testing.assert_allclose(float(s.dt), float(js.dt), rtol=1e-10)
    assert s.iter == js.iter == s.config.max_iters
    assert np.max(np.abs(U - U0)) > 1e-6 * np.max(np.abs(U0))  # it moved
    return s


def test_cylinder_deck_matches_jax(tmp_path, f64):
    """examples/cases/cyl2d_ogrid.ini (GL, curved O-grid, isothermal wall,
    far field, ParaView output) at 6x24 and 10 steps."""
    text = (REPO / "examples" / "cases" / "cyl2d_ogrid.ini").read_text()
    # timingFreq 2: chunks of 2 steps, one chunk length to compile
    text = (text.replace("maxIters = 200", "maxIters = 10")
            .replace("timingFreq = 20", "timingFreq = 2")
            .replace("nr = 12", "nr = 6").replace("ntheta = 48", "ntheta = 24")
            .replace("outdirBase = output_cyl2d",
                     f"outdirBase = {tmp_path / 'out'}"))
    path = tmp_path / "cyl.ini"
    path.write_text(text)
    s = _both_solve(path)
    assert [type(b.bc).__name__ for b in s.ctx.bcs] == ["FarFieldBC", "WallBC"]
    assert os.path.exists(tmp_path / "out" / "solution_00000010.vtk")
    assert os.path.exists(tmp_path / "out" / "restart_output.sol.h5")


FILE_DECK = """
[solver]
type = flow
[flow]
mesh = {mesh}
refinement_levels = 1
order = 2
maxIters = 4
timingFreq = 1000
outputFreq = 1000
fluid = dry_air
equation_system = navier-stokes
refLength = 0.5
[time]
cfl = 0.2
integrator = rk4
[initialConditions]
rho = 1.2
rhoU = 12.0
rhoV = 0.
pressure = 101300
[boundaryConditions/inlet]
patch = 4
type = nonreflecting
density = 1.2
uvw = '10.0 0.5 0.0'
[boundaryConditions/outlet]
patch = 2
type = nonReflectingPressure
pressure = 101000
[boundaryConditions/bottom]
patch = 1
type = viscous_isothermal
temperature = 300
[boundaryConditions/top]
patch = 3
type = slip
[io]
outdirBase = {outdir}
"""


def test_file_mesh_characteristic_deck_matches_jax(tmp_path, f64):
    """A channel read from an MFEM file, refined once, with a
    characteristic inlet and outlet whose ghosts the step loop carries."""
    from tps_torch.mesh.generators import box_2d
    from tps_torch.mesh.mfem_reader import write_mfem_mesh

    mesh = tmp_path / "channel.mesh"
    write_mfem_mesh(str(mesh), box_2d(3, 2, x1=0.04, y1=0.02))
    path = tmp_path / "file.ini"
    path.write_text(FILE_DECK.format(mesh=mesh, outdir=tmp_path / "out"))
    s = _both_solve(path)
    assert s.tables_np.ne == 24 and len(
        [b for b in s._loop.bc_states if b is not None]) == 2
