"""The LTE restart of tps_torch (io/restartFromLTE: a bulk checkpoint
converted into the mixture's multi-level Saha/Boltzmann equilibrium) and
its functions (physics/perfect_mixture.py: saha_ionization_fraction,
species_from_lte, state_from_lte) against the JAX package's, on the CPU in
f64.

- The Saha functions to 1e-12 of max, saha_ionization_fraction also with
  the limits of tests/test_plasma_solver.py::test_saha_lte_species_init;
  state_from_lte on the batched and the scalar shapes.
- tests/test_lte_restart.py::test_lte2noneq_restart_cli through both
  packages' CLI, the bulk checkpoint written by io/h5lite.py: the port's
  converted restart carries tps_tpu's dataset names (the reference's,
  rho-Y_<species> and rhoE_e) and its values within 1e-10.
- An LTE-table run's own checkpoint converted into argon_full.ini's state:
  the converted temperature is the LTE run's within the tables'
  interpolation error (its tables are argon_full.ini's equilibrium).
- The refusal of a mixture with two ions.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tps_torch import harness  # noqa: E402
from tps_torch.config.ini import IniInput  # noqa: E402
from tps_torch.constants import (AVOGADRO_NUMBER,  # noqa: E402
                                 ELECTRON_CHARGE)
from tps_torch.io import h5lite  # noqa: E402
from tps_torch.physics import perfect_mixture as pm  # noqa: E402
from tps_torch.physics.plasma_config import build_plasma  # noqa: E402
from tps_tpu.config.ini import IniInput as JIniInput  # noqa: E402
from tps_tpu.physics import perfect_mixture as jpm  # noqa: E402
from tps_tpu.physics.plasma_config import \
    build_plasma as jbuild_plasma  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FULL = os.path.join(HERE, "inputs", "argon_full.ini")
TOL = 1e-12
RESTART_TOL = 1e-10


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
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return max(_rel(a[..., q], b[..., q]) for q in range(b.shape[-1])
               if np.abs(b[..., q]).max() > 0)


@pytest.fixture(scope="module")
def mixtures():
    """argon_full.ini's six-species mixture in both packages."""
    return (build_plasma(IniInput.read(FULL), 2, 2).mixture,
            jbuild_plasma(JIniInput.read(FULL), 2, 2).mixture)


def test_saha_ionization_fraction_matches_jax():
    E_ion = 15.7596119 * ELECTRON_CHARGE * AVOGADRO_NUMBER  # J/mol
    T = np.asarray([300.0, 10000.0, 16000.0])
    n_atm = 101325.0 / (8.3144598 * T)
    x = pm.saha_ionization_fraction(torch.as_tensor(n_atm),
                                    torch.as_tensor(T), E_ion).numpy()
    jx = np.asarray(jpm.saha_ionization_fraction(jnp.asarray(n_atm),
                                                 jnp.asarray(T), E_ion))
    assert x[0] < 1e-30          # cold: neutral
    assert 1e-6 < x[1] < 5e-2    # 10 kK
    assert x[2] > 1e-2           # 16 kK: percent-level
    assert x[2] > x[1] > x[0]
    assert _rel(x, jx) <= TOL
    rng = np.random.default_rng(0)
    T = 2000.0 + 18000.0 * rng.random(200)
    n = 10.0 ** rng.uniform(-1.0, 2.0, 200)
    assert _rel(pm.saha_ionization_fraction(torch.as_tensor(n),
                                            torch.as_tensor(T), E_ion, 4.0),
                jpm.saha_ionization_fraction(jnp.asarray(n), jnp.asarray(T),
                                             E_ion, 4.0)) <= TOL


def test_species_from_lte_matches_jax(mixtures):
    mix, jmix = mixtures
    assert mix.degeneracy == jmix.degeneracy == (4.0, 6.0, 6.0, 36.0, 1.0,
                                                 1.0)
    rng = np.random.default_rng(1)
    rho = 0.01 + 0.3 * rng.random((6, 7))
    T = 300.0 + 19700.0 * rng.random((6, 7))
    n = pm.species_from_lte(mix, torch.as_tensor(rho), torch.as_tensor(T))
    jn = jpm.species_from_lte(jmix, jnp.asarray(rho), jnp.asarray(T))
    assert n.shape == (6, 7, mix.num_active_species)
    assert _per_eq(n, jn) <= TOL
    # numbers give f64 tensors
    n0 = pm.species_from_lte(mix, 0.16, 12000.0)
    assert n0.dtype == torch.float64
    assert _rel(n0, jpm.species_from_lte(jmix, jnp.float64(0.16),
                                         jnp.float64(12000.0))) <= TOL


@pytest.mark.parametrize("shape", [(5, 7), ()])
def test_state_from_lte_matches_jax(mixtures, shape):
    mix, jmix = mixtures
    rng = np.random.default_rng(2)
    neq = mix.num_equations
    Up = np.zeros(shape + (neq,))
    Up[..., 0] = 0.05 + 0.1 * rng.random(shape)
    Up[..., 1] = 20.0 * rng.standard_normal(shape)
    T = 6000.0 + 9000.0 * rng.random(shape)
    Up[..., mix.i_th] = T
    Up[..., mix.i_te] = T
    U = np.asarray(jmix.conservatives(jnp.asarray(Up)))
    out = pm.state_from_lte(mix, torch.as_tensor(U))
    jout = np.asarray(jpm.state_from_lte(jmix, jnp.asarray(U)))
    assert out.shape == U.shape and np.isfinite(jout).all()
    assert _per_eq(out, jout) <= TOL
    # the bulk fields are kept
    assert _per_eq(out[..., :mix.nvel + 2], U[..., :mix.nvel + 2]) <= TOL


def test_restart_from_lte_requires_single_ion():
    mw_ar, mw_e, e_ion = 39.948e-3, 5.478e-7, 1520571.3883
    mix = pm.PerfectMixture(
        dim=2, nvel=2, mw=(mw_ar - mw_e, mw_ar - mw_e, mw_e, mw_ar),
        charges=(1.0, 1.0, -1.0, 0.0),
        formation_energy=(e_ion, e_ion, 0.0, 0.0),
        molar_cv_over_R=(1.5,) * 4, ambipolar=True)
    with pytest.raises(NotImplementedError, match="one positive ion"):
        pm.species_from_lte(mix, 0.16, 9000.0)


def _lte2noneq_deck(tmp_path, outdir):
    """argon_full.ini with io/restartFromLTE, maxIters at the checkpoint's
    iteration (tests/test_lte_restart.py::test_lte2noneq_restart_cli)."""
    with open(FULL) as f:
        deck = f.read()
    deck = deck.replace("outdirBase = /tmp/tps_tpu_argon_full",
                        f"outdirBase = {outdir}")
    deck += "\nrestartFromLTE = 1\nenableRestart = 1\n"
    deck = deck.replace("maxIters = 4", "maxIters = 7")
    ini = tmp_path / f"{os.path.basename(str(outdir))}.ini"
    ini.write_text(deck)
    return str(ini)


def _bulk_checkpoint(path, U, ndof=4):
    """A bulk-only checkpoint (density, momenta, rho-E) of U [ne, ndof,
    4], at iteration 7, through h5lite."""
    ne = U.shape[0]
    sol = {name: np.ascontiguousarray(U[..., k]).reshape(-1)
           for k, name in enumerate(("density", "x-mom", "y-mom", "rho-E"))}
    h5lite.write(path, {"solution": sol},
                 {"iteration": 7, "time": 1.4e-8, "dt": 2e-9, "order": 1,
                  "nprocs": 1, "ne_global": ne, "dofs_global": ne * ndof})


def test_lte2noneq_restart_cli(mixtures, tmp_path):
    from tps_tpu.harness import main as jmain

    mix, jmix = mixtures
    rho, T = 0.16, 10000.0
    ne, ndof = 16, 4
    n_act = pm.species_from_lte(mix, rho, T)
    up = torch.cat([torch.tensor([rho, 0.0, 0.0, T]), n_act,
                    torch.tensor([T])])
    U_true = mix.conservatives(up).numpy()
    # a bulk field that varies over the nodes
    U = np.broadcast_to(U_true[:4], (ne, ndof, 4)).copy()
    U[..., 3] *= 1.0 + 0.1 * np.linspace(0.0, 1.0, ne * ndof).reshape(
        ne, ndof)
    outs = {}
    for name in ("port", "jax"):
        outdir = tmp_path / name
        os.makedirs(outdir)
        _bulk_checkpoint(str(outdir / "restart_output.sol.h5"), U)
        ini = _lte2noneq_deck(tmp_path, outdir)
        if name == "port":
            status = harness.main(["tps", "--runFile", ini, "--device",
                                   "cpu"])
        else:
            status = jmain(["tps", "--runFile", ini])
        assert status == 0
        outs[name] = h5lite.read(str(outdir / "restart_output.sol.h5"))
    port, ref = outs["port"], outs["jax"]
    assert int(port.attrs["iteration"]) == int(ref.attrs["iteration"]) == 7
    names = sorted(ref["solution"].keys())
    assert sorted(port["solution"].keys()) == names
    for k in ("rho-Y_Ar.+1", "rho-Y_Ar_m", "rho-Y_Ar_r", "rho-Y_Ar_p",
              "rhoE_e"):
        assert k in names
    for k in names:
        assert _rel(port["solution"][k], ref["solution"][k]) <= \
            RESTART_TOL, k
    # the composition of the uniform-T nodes (the first) recovered
    n_ion = np.asarray(port["solution"]["rho-Y_Ar.+1"])[0] / mix.mw[0]
    assert abs(n_ion / float(n_act[0]) - 1.0) < 1e-6


LTE_BOX = """
[solver]
type = flow
[flow]
order = 1
maxIters = 7
outputFreq = 100000
fluid = lte_table
equation_system = navier-stokes
[mesh]
generator = box2d
nx = 4
ny = 4
x1 = 0.01
y1 = 0.01
periodic_x = 1
periodic_y = 1
[time]
integrator = rk3
dt_fixed = 2e-9
enableConstantTimestep = 1
[initialConditions]
rho = 0.0507
rhoU = 0.507
rhoV = 0.0
rhoW = 0.0
pressure = 100245.6
[flow/lte]
table_dim = 1
thermo_table = {repo}/tps_torch/tools/lte_argon_thermo.h5
transport_table = {repo}/tps_torch/tools/lte_argon_trans.h5
[io]
outdirBase = {out}
"""


def test_lte_checkpoint_converts_at_its_temperature(mixtures, tmp_path):
    """Path 2 cut to size: an LTE-table run's checkpoint (argon_full.ini's
    4x4 p=1 mesh, 7 steps from a wave in T at 101,325 Pa) converted by
    argon_full.ini with restartFromLTE; its T against the LTE run's T."""
    mix = mixtures[0]
    out = tmp_path / "lte"
    ini = tmp_path / "lte.ini"
    ini.write_text(LTE_BOX.format(repo=REPO, out=out))
    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", str(ini), "--device",
                                 "cpu"])
    tps.parse_input()
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    s = tps.solver
    Up = s.mixture.primitives(s.U)
    x = torch.as_tensor(s.tables_np.xyz_dof[..., 0])
    # a wave in T along the tables' isobar (rho from 101,325 Pa): the 1-D
    # tables are the equilibrium there, the Saha composition a function of
    # (rho, T)
    T = 9500.0 + 1500.0 * torch.sin(2 * np.pi / 0.01 * x)
    Up[..., 0] = 101325.0 / (s.mixture.R_table(T) * T)
    Up[..., -1] = T
    s.set_state_global(s.mixture.conservatives(Up).numpy())
    tps.solve()
    T_lte = s.mixture.temperature(s.U).numpy()
    conv = tmp_path / "conv"
    os.makedirs(conv)
    import shutil

    shutil.copy(out / "restart_output.sol.h5", conv / "restart_output.sol.h5")
    ntps = harness.Tps()
    ntps.parse_command_line_args(["tps", "--runFile",
                                  _lte2noneq_deck(tmp_path, conv),
                                  "--device", "cpu"])
    ntps.parse_input()
    ntps.choose_devices()
    ntps.choose_solver()
    ntps.initialize()
    n = ntps.solver
    U = n.U
    T_conv = mix.temperatures(U)[0].numpy()
    # mass, momentum and energy kept; T within the tables' interpolation
    # error (800 points, 24.7 K apart: 0.025 K here)
    assert _per_eq(U[..., :4], s.U) <= TOL
    dT = np.abs(T_conv - T_lte).max()
    assert 7900.0 < T_lte.min() and T_lte.max() < 11100.0
    assert dT < 0.1, dT
    # the converted restart was written at once
    f = h5lite.read(str(conv / "restart_output.sol.h5"))
    assert "rho-Y_Ar_m" in f["solution"] and "rhoE_e" in f["solution"]
