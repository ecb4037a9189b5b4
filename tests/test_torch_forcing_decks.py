"""The decks of the compressible forcings and the manufactured solutions
through tps_torch's solver == the JAX package's, on the CPU in f64.

For each deck, the solver's forcing list against the JAX solver's, by
type and by field, and three steps of both packages from their own
initial state (the MMS decks start from the exact state), the state
within DECK_TOL (the deck bar of PERF.md §2):
- tests/test_forcing_wiring.py's DryAir deck (pressure forcing, a heat
  source, a planar userDef sponge) and its mixedOut form;
- tests/inputs/argon_minimal.ini with a planar sponge whose target has
  the species and the electron temperature (the forcing list only: the
  argon step compiles slowly in the JAX package);
- tps_torch/tools/forced_channel3d.ini cut to 8x4x4;
- tests/inputs/mms.{euler,cns}.2d.quad.ini cut to 8x8, and the 3-D
  transient euler deck of tests/test_masa_3d.py at 3^3 (its
  Navier-Stokes form's source is held in tests/test_torch_masa.py), with
  the L2 solution error at the end.
Then what each package does with passive scalars: the JAX package runs a
[passiveScalars] deck with 4 equations, its PassiveScalar on rho E
(ROADMAP C); the port refuses it, and equation_system = ns-passive,
naming that fact.  And the sections that are skipped or refused: a
disabled sponge zone, a mixedOut plane with no node near it.
"""

import os

import jax
import numpy as np
import pytest
from threadpoolctl import threadpool_limits

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
threadpool_limits(1)  # numpy's and scipy's BLAS too: one thread a worker

from tps_torch import harness  # noqa: E402
from tps_torch.solvers.compressible import check_slice  # noqa: E402
from tps_tpu import harness as jharness  # noqa: E402

from test_forcing_wiring import DRYAIR_DECK, MIXEDOUT_DECK  # noqa: E402
from test_masa_3d import DECK as MASA3D_DECK  # noqa: E402
from test_torch_axisym_dg import ARGON  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHANNEL = os.path.join(os.path.dirname(HERE), "tps_torch", "tools",
                       "forced_channel3d.ini")
DECK_TOL = 1e-9
ARGON_SPONGE = """
[spongezone]
numSpongeZones = 1
[spongezone1]
type = planar
targetSolType = userDef
density = 1.6
uvw = '10.0 0.0 0.0'
pressure = 101300.0
mass_fraction/species1 = 1.0e-8
mass_fraction/species2 = 0.9999999
mass_fraction/species3 = 1.0e-7
electron_temperature = 400.0
normal = '-1 0 0'
p0 = '0.01 0.0 0.0'
pInit = '0.0075 0.0 0.0'
multiplier = 0.5
"""


@pytest.fixture(autouse=True)
def f64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def _build(mod, path, device=True):
    tps = mod.Tps()
    tps.parse_command_line_args(["tps", "--runFile", str(path)]
                                + (["--device", "cpu"] if device else []))
    tps.parse_input()
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    return tps.solver


def _write(tmp_path, text, name="deck.ini"):
    path = tmp_path / name
    path.write_text(text)
    return path


def _rel(U, ref, nvel):
    """Per equation relative to its max; the momenta relative to max rho
    times the max speed (a momentum that stays at 0 is rounding)."""
    U, ref = np.asarray(U), np.asarray(ref)
    mom = ref[..., 1:1 + nvel]
    speed = np.max(np.abs(mom) / ref[..., :1])
    out = 0.0
    for q in range(ref.shape[-1]):
        scale = np.abs(ref[..., q]).max()
        if 1 <= q <= nvel:
            scale = max(scale, ref[..., 0].max() * speed)
        out = max(out, float(np.abs(U[..., q] - ref[..., q]).max() / scale))
    return out


FIELDS = {"ConstantPressureGradient": ("press_grad",),
          "HeatSource": ("value", "point1", "point2", "radius"),
          "SpongeZone": ("normal", "p0", "p_init", "mult", "sz_type", "r1",
                         "r2", "sol_type", "tol")}


def _same_forcings(s, js):
    """The two solvers' forcing lists by type and by field (the MMS
    forcing is a closure in both; the sponge targets to 1e-12)."""
    kinds = [type(f).__name__ for f in s.ctx.forcings]
    jkinds = [type(f).__name__ for f in js.ctx.forcings]
    assert kinds == jkinds, (kinds, jkinds)
    for f, jf in zip(s.ctx.forcings, js.ctx.forcings):
        for field in FIELDS.get(type(f).__name__, ()):
            assert getattr(f, field) == getattr(jf, field), field
        if type(f).__name__ == "SpongeZone" and jf.target_u is not None:
            np.testing.assert_allclose(f.target_u, jf.target_u, rtol=1e-12)
        if type(f).__name__ == "SpongeZone":
            assert (f.target_u is None) == (jf.target_u is None)
    assert (s.masa is None) == (js.masa is None)
    return kinds


def _steps(s, js, n=3):
    np.testing.assert_array_equal(s.state_global(), np.asarray(js.U))
    for _ in range(n):
        s.solve_step()
        js.solve_step()
    d = _rel(s.state_global(), js.U, s.mixture.nvel)
    assert d <= DECK_TOL, d
    assert abs(float(s.time) - float(js.time)) <= 1e-15 * float(js.time)
    return d


@pytest.mark.parametrize("kind", ["userDef", "mixedOut"])
def test_dry_air_forcing_deck_matches_jax(tmp_path, kind):
    deck = DRYAIR_DECK if kind == "userDef" else MIXEDOUT_DECK
    path = _write(tmp_path, deck.format(out=tmp_path / "o"))
    s, js = _build(harness, path), _build(jharness, path)
    assert _same_forcings(s, js) == ["ConstantPressureGradient",
                                     "HeatSource", "SpongeZone"]
    _steps(s, js)


def test_argon_sponge_deck_forcings_match_jax(tmp_path):
    """The argon deck's forcing list and its sponge's target (the
    SpongeZone on the ternary is held to the JAX one in
    tests/test_torch_forcing.py; chip_smoke.py steps this deck on the
    card against the CPU)."""
    path = _write(tmp_path, open(ARGON).read() + ARGON_SPONGE)
    s, js = _build(harness, path), _build(jharness, path)
    kinds = _same_forcings(s, js)
    assert kinds == ["SourceTerm", "JouleHeating", "SpongeZone"]


def test_forced_channel_matches_jax(tmp_path):
    text = open(CHANNEL).read()
    for old, new in (("nx = 32", "nx = 8"), ("ny = 16", "ny = 4"),
                     ("nz = 16", "nz = 4"),
                     ("outdirBase = output/forced_channel3d",
                      f"outdirBase = {tmp_path / 'o'}")):
        text = text.replace(old, new)
    path = _write(tmp_path, text)
    s, js = _build(harness, path), _build(jharness, path)
    assert _same_forcings(s, js) == ["ConstantPressureGradient",
                                     "HeatSource", "SpongeZone"]
    assert type(s._rhs).__name__ == "SlotRHS"
    _steps(s, js)
    jax.clear_caches()


def _mms_text(tmp_path, ini, n):
    text = open(os.path.join(HERE, "inputs", ini)).read()
    return (text.replace(f"nx = {n}", "nx = 8").replace(f"ny = {n}", "ny = 8")
            .replace("outdirBase = output", f"outdirBase = {tmp_path}"))


@pytest.mark.parametrize("deck", ["euler2d", "cns2d", "euler3d"])
def test_mms_deck_matches_jax(tmp_path, deck):
    if deck == "euler2d":
        text = _mms_text(tmp_path, "mms.euler.2d.quad.ini", 160)
    elif deck == "cns2d":
        text = _mms_text(tmp_path, "mms.cns.2d.quad.ini", 80)
    else:
        text = MASA3D_DECK.format(n=3, iters=3, dt=2e-5, out=tmp_path,
                                  name="euler_transient_3d", eqsys="euler")
    path = _write(tmp_path, text)
    s, js = _build(harness, path), _build(jharness, path)
    assert _same_forcings(s, js)[-1] == "function"
    assert s.masa.params == js.masa.params
    _steps(s, js)
    # the L2 solution error (the JAX solver's report, in numpy)
    from tps_tpu.utils.mms import l2_norm

    want = float(l2_norm(js.tables, js.U - js.masa.exact_U(
        js.tables.xyz_dof, js.time)))
    assert abs(s.mms_solution_error() - want) <= 1e-9 * want
    jax.clear_caches()


PASSIVE = "[passiveScalars]\nnumScalars = 1\n[passiveScalar1]\n" \
          "xyz = '0.5 0.5 0.0'\nradius = 0.2\nvalue = 1.0\n"


def test_passive_scalars_fact_and_refusal(tmp_path):
    """ROADMAP C: the JAX solver builds DryAir with n_passive = 0, so a
    [passiveScalars] deck runs with 4 equations in 2-D and PassiveScalar
    relaxes U[..., -1], rho E; the port refuses such a deck, and
    equation_system = ns-passive, on any device (check_slice runs before
    a device is touched), naming the fact."""
    base = DRYAIR_DECK.format(out=tmp_path / "o")
    for old in ("enablePressureForcing = True", "numHeatSources = 1",
                "numSpongeZones = 1"):
        base = base.replace(old, old.split("=")[0] + "= 0")
    for eq in ("navier-stokes", "ns-passive"):
        text = base.replace("equation_system = navier-stokes",
                            f"equation_system = {eq}") + PASSIVE
        path = _write(tmp_path, text, f"{eq}.ini")
        js = _build(jharness, path)
        assert js.mixture.num_equations == 4
        assert [type(f).__name__ for f in js.ctx.forcings] == [
            "PassiveScalar"]
        for device in ("cpu", "cuda"):
            tps = harness.Tps()
            tps.parse_command_line_args(["tps", "--runFile", str(path),
                                         "--device", device])
            tps.parse_input()
            with pytest.raises(NotImplementedError,
                               match="ROADMAP C.*facts of the reference"):
                check_slice(tps.config)
        with pytest.raises(NotImplementedError, match="no scalar equation"):
            _build(harness, path)
    jax.clear_caches()


def test_skipped_and_refused_sections(tmp_path):
    """A disabled sponge zone builds none; a mixedOut plane with no node
    within its tolerance raises, as in the JAX package."""
    deck = DRYAIR_DECK.format(out=tmp_path / "o").replace(
        "[spongezone1]\nisEnabled = True", "[spongezone1]\nisEnabled = False")
    s = _build(harness, _write(tmp_path, deck))
    assert [type(f).__name__ for f in s.ctx.forcings] == [
        "ConstantPressureGradient", "HeatSource"]
    deck = MIXEDOUT_DECK.replace("tolerance = 0.2", "tolerance = 1e-12")
    deck = deck.replace("[flow]\norder = 1", "[flow]\norder = 1\nbasisType = 0"
                        "\nintegrationRule = 0")
    path = _write(tmp_path, deck.format(out=tmp_path / "o"), "empty.ini")
    for mod in (harness, jharness):
        with pytest.raises(ValueError, match="no dof nodes within tolerance"):
            _build(mod, path)
