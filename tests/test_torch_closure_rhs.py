"""The compressible closures and Roe in tps_torch's right-hand side == the
JAX package's, on the CPU in f64; and the face sweep's gate for them.

1. compute_rhs of solvers built from small walled decks through both
   packages' harness, on one seeded perturbed state, 1e-12 of max per
   equation: DryAir 2-D (8x8 p=1, four no-slip walls) with the
   Smagorinsky model, the viscous sponge, the mixing length (the wall
   distance of `computeDistance`), and Roe; DryAir 3-D
   (tps_torch/tools/les_channel3d.ini at 4x4x4 p=1: Roe and Sigma, walls
   in y); the axisymmetric argon torch with every closure
   (tps_torch/tools/argon_torch_axisym_ml.ini at 8x8 p=1 with
   Smagorinsky added).  The wall-distance tables of the solvers bit for
   bit.
2. A periodic Gauss-Legendre box with Roe runs the plain fused path on the
   CPU, as in the JAX package: 3 steps within 1e-12.
3. The gate: Roe and the closures are admitted on DryAir and the argon
   ternary (`closure_cases`' variants); Roe on a mixture or the LTE
   fluid, and the closures on argon_const, gas_mixture and the LTE fluid,
   are not, and such a configuration's sweep on a CUDA table raises
   NotImplementedError naming ROADMAP A6.5 (here: a CPU table whose
   operator reports a CUDA device), while its CPU sweep runs the plain
   version.
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tps_torch import harness  # noqa: E402
from tps_torch.dg import rhs as trhs  # noqa: E402
from tps_torch.dg.cuda_faces import (build_face_sweep,  # noqa: E402
                                     face_sweep_supported)
from tps_torch.tools.closure_cases import BASES, closure_case  # noqa: E402
from tps_tpu import harness as jharness  # noqa: E402
from tps_tpu.dg import rhs as jrhs  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
TOOLS = os.path.join(os.path.dirname(HERE), "tps_torch", "tools")
TOL = 1e-12

WALLED_2D = """
[solver]
type = flow
[flow]
order = 1
maxIters = 3
outputFreq = 100000
fluid = dry_air
equation_system = navier-stokes
viscosityMultiplier = 200.
{flow}
[mesh]
generator = box2d
nx = 8
ny = 8
x1 = 1.0
y1 = 1.0
[time]
integrator = forward-euler
cfl = 0.1
[initialConditions]
rho = 1.2
rhoU = 12.
rhoV = 6.
rhoW = 0.
pressure = 101300
[boundaryConditions]
numWalls = 4
[boundaryConditions/wall1]
patch = 1
type = viscous_isothermal
temperature = 300
[boundaryConditions/wall2]
patch = 2
type = viscous_adiabatic
[boundaryConditions/wall3]
patch = 3
type = viscous_isothermal
temperature = 310
[boundaryConditions/wall4]
patch = 4
type = slip
{extra}
[io]
outdirBase = {out}
"""

SPONGE = """
[viscosityMultiplierFunction]
isEnabled = 1
point = '0.0 0.6 0.0'
normal = '0.0 1.0 0.0'
width = 0.1
viscosityRatio = 10.0
"""

CASES_2D = {
    "smagorinsky": ("sgsModel = smagorinsky", ""),
    "sponge": ("", SPONGE),
    "mixing": ("computeDistance = 1\nuseMixingLength = 1\n"
               "[flow/mixing-length]\nmax-mixing-length = 0.1\n"
               "Pr_ratio = 0.9\nbulk-multiplier = 0.2", ""),
    "roe": ("useRoe = 1", ""),
}


@pytest.fixture(autouse=True)
def f64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def _rel_cols(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return max(float(np.abs(a[..., q] - b[..., q]).max()
                     / max(np.abs(b[..., q]).max(), 1e-300))
               for q in range(b.shape[-1]))


def _tps(mod, path, argv=()):
    tps = mod.Tps()
    tps.parse_command_line_args(["tps", "--runFile", path, *argv])
    tps.parse_input()
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    return tps


def _from_file(tmp_path, src, name, edits):
    with open(src) as f:
        text = f.read()
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new)
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _perturbed(s, seed):
    """The solver's initial state with seeded smooth velocity and
    temperature perturbations (the species untouched)."""
    mix = s.mixture
    Up = mix.primitives(s.U).clone()
    xyz = torch.as_tensor(s.tables_np.xyz_dof)
    L = float(xyz.max() - xyz.min())
    rng = np.random.default_rng(seed)
    nvel = mix.nvel
    for q in list(range(1, nvel + 1)) + [nvel + 1]:
        k = torch.as_tensor(rng.uniform(1.0, 3.0, xyz.shape[-1])) * 2 * np.pi / L
        ph = torch.as_tensor(rng.uniform(0.0, 2 * np.pi, xyz.shape[-1]))
        wave = torch.prod(torch.cos(k * xyz + ph), dim=-1)
        scale = 0.05 * float(Up[..., nvel + 1].mean()) if q == nvel + 1 \
            else 3.0
        Up[..., q] = Up[..., q] + scale * wave
    return mix.conservatives(Up)


def _rhs_pair(s, js, U):
    y, aux = trhs.compute_rhs(s.ctx, s.tables, U)
    jy, jaux = jax.jit(lambda u: jrhs.compute_rhs(js.ctx, js.tables, u, 0.0))(
        jnp.asarray(U.numpy()))
    return y, aux, np.asarray(jy), jaux


def _assert_distance_tables(s, js):
    for name in ("distance", "f_dist", "dist_slot"):
        a, b = getattr(s.tables_np, name), getattr(js.tables_np, name)
        assert a is not None and np.array_equal(a, np.asarray(b)), name


@pytest.mark.parametrize("case", sorted(CASES_2D))
def test_walled_2d_rhs_matches_jax(tmp_path, case):
    flow, extra = CASES_2D[case]
    text = WALLED_2D.format(flow=flow, extra=extra, out=tmp_path / "o")
    path = tmp_path / "d.ini"
    path.write_text(text)
    s = _tps(harness, str(path), ["--device", "cpu"]).solver
    js = _tps(jharness, str(path)).solver
    fl = s.fluxes
    assert (type(s.riemann).__name__ == "Roe") == (case == "roe")
    assert (fl.sgs_model is not None) == (case == "smagorinsky")
    assert (fl.visc_sponge is not None) == (case == "sponge")
    assert (type(fl.transport).__name__ == "MixingLengthTransport") == \
        (case == "mixing")
    if case == "mixing":
        _assert_distance_tables(s, js)
    U = _perturbed(s, 1)
    y, aux, jy, jaux = _rhs_pair(s, js, U)
    assert _rel_cols(y.numpy(), jy) <= TOL
    assert abs(float(aux["max_char_speed"]) / float(jaux["max_char_speed"])
               - 1.0) <= TOL
    # the closure moves the RHS (against the same solver without it)
    base = WALLED_2D.format(flow="", extra="", out=tmp_path / "b")
    bpath = tmp_path / "b.ini"
    bpath.write_text(base)
    b = _tps(harness, str(bpath), ["--device", "cpu"]).solver
    yb, _ = trhs.compute_rhs(b.ctx, b.tables, U)
    assert _rel_cols(y.numpy(), yb.numpy()) > 1e-6


def test_les_channel_rhs_matches_jax(tmp_path):
    path = _from_file(tmp_path, os.path.join(TOOLS, "les_channel3d.ini"),
                      "les.ini", [("nx = 32", "nx = 4"), ("ny = 16", "ny = 4"),
                                  ("nz = 16", "nz = 4"),
                                  ("order = 2", "order = 1"),
                                  ("outdirBase = output/les_channel3d",
                                   f"outdirBase = {tmp_path / 'o'}")])
    s = _tps(harness, path, ["--device", "cpu"]).solver
    js = _tps(jharness, path).solver
    assert type(s.riemann).__name__ == "Roe"
    assert type(s.fluxes.sgs_model).__name__ == "Sigma"
    assert s._rhs.sweep.variant == "dry_air_roe_3d_closure"
    U = _perturbed(s, 2)
    y, _, jy, _ = _rhs_pair(s, js, U)
    assert _rel_cols(y.numpy(), jy) <= TOL
    # Sigma is not zero in 3-D: the RHS moves without it
    nosgs = _from_file(tmp_path, path, "nosgs.ini",
                       [("sgsModel = sigma", "sgsModel = none")])
    b = _tps(harness, nosgs, ["--device", "cpu"]).solver
    yb, _ = trhs.compute_rhs(b.ctx, b.tables, U)
    assert _rel_cols(y.numpy(), yb.numpy()) > 1e-9


def test_axisymmetric_argon_with_every_closure_matches_jax(tmp_path):
    path = _from_file(tmp_path, os.path.join(TOOLS,
                                             "argon_torch_axisym_ml.ini"),
                      "ml.ini", [
                          ("nx = 64", "nx = 8"), ("ny = 64", "ny = 8"),
                          ("order = 2", "order = 1"), ("nx = 32", "nx = 16"),
                          ("ny = 48", "ny = 24"),
                          ("useMixingLength = 1",
                           "useMixingLength = 1\nsgsModel = smagorinsky"),
                          ("outdirBase = output/argon_torch_axisym_ml",
                           f"outdirBase = {tmp_path / 'o'}")])
    c = _tps(harness, path, ["--device", "cpu"]).solver
    jc = _tps(jharness, path).solver
    s, js = c.flow, jc.flow
    fl = s.fluxes
    assert fl.axisymmetric and fl.sgs_model is not None
    assert fl.visc_sponge is not None
    assert type(fl.transport).__name__ == "MixingLengthTransport"
    # the source term's transport is the wrapped one (its molecular values)
    assert s._source_term.transport is fl.transport
    assert s._rhs.sweep.variant == "argon_axi_closure"
    _assert_distance_tables(s, js)
    # the wall distance is the r = 0.01 wall's: the axis is inviscid
    assert np.allclose(s.tables_np.distance,
                       0.01 - s.tables_np.xyz_dof[..., 0], atol=1e-3)
    U = _perturbed(s, 3)
    y, _, jy, _ = _rhs_pair(s, js, U)
    assert _rel_cols(y.numpy(), jy) <= TOL


def test_periodic_roe_box_runs_the_plain_fused_path(tmp_path):
    text = WALLED_2D.format(flow="useRoe = 1\nbasisType = 0\n"
                                 "integrationRule = 0",
                            extra="", out=tmp_path / "o")
    text = text.replace("order = 1", "order = 2").replace(
        "x1 = 1.0\n", "x1 = 1.0\nperiodic_x = 1\nperiodic_y = 1\n")
    text = text[:text.index("[boundaryConditions]")] + text[
        text.index("[io]"):]
    path = tmp_path / "box.ini"
    path.write_text(text)
    tps = _tps(harness, str(path), ["--device", "cpu"])
    jtps = _tps(jharness, str(path))
    s, js = tps.solver, jtps.solver
    assert type(s._rhs).__name__ == "FusedRHS"
    assert type(s.ctx.riemann).__name__ == "Roe"
    U0 = _perturbed(s, 4).numpy()
    s.set_state_global(U0)
    js.set_state_global(U0)
    tps.solve()
    jtps.solve()
    assert s.iter == js.iter == 3
    assert _rel_cols(s.state_global(), js.state_global()) <= TOL


# ------------------------------------------------------------ 3. the gate


@pytest.mark.parametrize("base", sorted(BASES))
def test_gate_admits_the_kernel_variants(base):
    ctx, tab, _ = closure_case(base, "all", 2)
    assert face_sweep_supported(tab, ctx)
    sw = build_face_sweep(tab.to_torch(torch.float64, "cpu"), ctx)
    assert sw.variant == f"{base}_closure" and sw.closure is not None


def _mixture_ctx(edits, closure=None, roe=False):
    """The argon ternary of tests/inputs/argon_minimal.ini (or an edited
    copy) with a closure or Roe; (ctx, tables)."""
    from tps_torch.config.ini import IniInput
    from tps_torch.dg.discretization import build_tables
    from tps_torch.dg.rhs import RHSContext
    from tps_torch.dg.riemann import Roe, Rusanov
    from tps_torch.mesh.generators import box_2d
    from tps_torch.physics.plasma_config import build_plasma
    from tps_torch.tools.closure_cases import closure_fluxes

    with open(os.path.join(HERE, "inputs", "argon_minimal.ini")) as f:
        text = f.read()
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new)
    pl = build_plasma(IniInput.parse(text), 2, 2)
    fl = closure_fluxes(pl.mixture, pl.transport, closure or "none", 0.01)
    ctx = RHSContext(fluxes=fl, riemann=(Roe if roe else Rusanov)(fl))
    return ctx, build_tables(box_2d(4, 4, x1=0.01, y1=0.01), order=1)


def _lte_ctx(closure=None, roe=False):
    from tps_torch.config.ini import IniInput
    from tps_torch.dg.discretization import build_tables
    from tps_torch.dg.rhs import RHSContext
    from tps_torch.dg.riemann import Roe, Rusanov
    from tps_torch.mesh.generators import box_2d
    from tps_torch.physics.lte import load_lte_setup
    from tps_torch.tools.closure_cases import closure_fluxes

    repo = os.path.dirname(HERE)
    with open(os.path.join(TOOLS, "lte_channel_coupled.ini")) as f:
        text = f.read().replace("tps_torch/tools/",
                                os.path.join(repo, "tps_torch", "tools", ""))
    mix, tr = load_lte_setup(IniInput.parse(text), 2, 2)
    fl = closure_fluxes(mix, tr, closure or "none", 0.01)
    ctx = RHSContext(fluxes=fl, riemann=(Roe if roe else Rusanov)(fl))
    return ctx, build_tables(box_2d(4, 4, x1=0.01, y1=0.01), order=1)


CONSTANT = [("transport_model = argon_minimal", "transport_model = constant")]


@pytest.mark.parametrize("case", [
    "roe-argon", "roe-lte", "closures-argon_const", "closures-gas_mixture",
    "closures-lte", "wale"])
def test_gate_keeps_the_cpu_only_configurations(case):
    what, _, kind = case.partition("-")
    if case == "wale":
        from tps_torch.dg.sgs import Wale

        ctx, tab, _ = closure_case("dry_air_2d", "none", 2)
        fl = dataclasses.replace(ctx.fluxes, sgs_model=Wale(mixture=ctx.mixture))
        ctx = dataclasses.replace(ctx, fluxes=fl)
    elif kind == "lte":
        ctx, tab = _lte_ctx("all" if what == "closures" else None,
                            roe=what == "roe")
    elif kind == "gas_mixture":
        from tps_torch.config.ini import IniInput
        from tps_torch.dg.discretization import build_tables
        from tps_torch.dg.rhs import RHSContext
        from tps_torch.dg.riemann import Rusanov
        from tps_torch.mesh.generators import box_2d
        from tps_torch.physics.plasma_config import build_plasma
        from tps_torch.tools.closure_cases import closure_fluxes

        pl = build_plasma(IniInput.read(os.path.join(HERE, "inputs",
                                                     "argon_full.ini")), 2, 2)
        fl = closure_fluxes(pl.mixture, pl.transport, "sponge", 0.01)
        ctx = RHSContext(fluxes=fl, riemann=Rusanov(fl))
        tab = build_tables(box_2d(4, 4, x1=0.01, y1=0.01), order=1)
    else:
        ctx, tab = _mixture_ctx(CONSTANT if kind == "argon_const" else [],
                                "sponge" if what == "closures" else None,
                                roe=what == "roe")
    # without the closure or Roe, the same physics has a kernel
    assert not face_sweep_supported(tab, ctx)
    ttab = tab.to_torch(torch.float64, "cpu")
    sw = build_face_sweep(ttab, ctx)
    assert sw.variant == "none"
    k = ctx.mixture.num_equations * (1 + tab.dim)
    X = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (tab.ne, tab.ndof, k)))
    X[..., 0] = 1.0 + 0.1 * X[..., 0].abs()
    assert sw(X).shape == (tab.ne, tab.ndof, ctx.mixture.num_equations)
    cuda_tab = types.SimpleNamespace(**{
        **ttab.__dict__, "Btr_or": types.SimpleNamespace(
            device=torch.device("cuda", 0), dtype=torch.float64)})
    with pytest.raises(NotImplementedError, match=r"ROADMAP A6\.5"):
        build_face_sweep(cuda_tab, ctx)
