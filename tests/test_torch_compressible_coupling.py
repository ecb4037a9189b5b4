"""The compressible plasma solver under the cycle-averaged Joule coupling
(`plasma-solver` left at its default, `compressible`) against the JAX
package's, on the CPU in f64.

- The coupling API of solvers/compressible.py (evaluate_plasma_
  conductivity, set/get_joule_heating, set/get_efield) against tps_tpu's:
  the conductivity on the same state to 1e-12; each setter copies into
  the tensor the forcing (and a captured step) reads; dry air has none.
- dg/forcing.py::JouleHeating against tps_tpu's on one heating field,
  negative values clipped.
- tests/test_coupling.py::test_cycle_avg_joule_coupling through both
  packages (periodic argon_minimal.ini, ion fraction 1e-4, 0.5 W, EM every
  2 steps on a 12x12 EM mesh with a coil ring, 4 steps from tps_tpu's
  initial state): its checks on the port (power on target to 1e-8 at each
  EM solve, the energy rose, the heating reached the flow) and the flow
  state, the Joule heating and the E-field within 1e-9 of tps_tpu's.

The coupled channel deck (tps_torch/tools/argon_channel_coupled.ini) is
held in tests/test_torch_compressible_channel.py.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tps_torch.config.ini import IniInput  # noqa: E402
from tps_torch.config.run_config import parse_run_configuration  # noqa: E402
from tps_torch.dg.forcing import JouleHeating  # noqa: E402
from tps_torch.mesh.generators import box_2d  # noqa: E402
from tps_torch.solvers.coupling import CycleAvgJouleCoupling  # noqa: E402
from tps_torch.solvers.em.qms import \
    QuasiMagnetostaticSolverAxiSym  # noqa: E402
from tps_tpu.config.ini import IniInput as JIniInput  # noqa: E402
from tps_tpu.config.run_config import \
    parse_run_configuration as jparse  # noqa: E402
from tps_tpu.dg.forcing import JouleHeating as JJouleHeating  # noqa: E402
from tps_tpu.mesh.generators import box_2d as jbox_2d  # noqa: E402
from tps_tpu.solvers.coupling import \
    CycleAvgJouleCoupling as JCoupling  # noqa: E402
from tps_tpu.solvers.em.qms import \
    QuasiMagnetostaticSolverAxiSym as JQms  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
MINIMAL = os.path.join(HERE, "inputs", "argon_minimal.ini")
TOL = 1e-12
DECK_TOL = 1e-9
POWER_TOL = 1e-8


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


def _state_rel(U, ref):
    """Per equation relative to its max; the momenta relative to max rho
    times the max speed (a channel's cross-stream momentum starts at 0)."""
    U, ref = np.asarray(U), np.asarray(ref)
    speed = np.max(np.abs(ref[..., 1:3]) / ref[..., :1])
    out = 0.0
    for q in range(ref.shape[-1]):
        scale = np.abs(ref[..., q]).max()
        if 1 <= q <= 2:
            scale = max(scale, ref[..., 0].max() * speed)
        out = max(out, np.abs(U[..., q] - ref[..., q]).max() / scale)
    return out


# ------------------------------------------------------------ the pieces


def _argon_solvers(tmp_path):
    """The port's and tps_tpu's compressible solvers on argon_minimal.ini."""
    from tps_torch.solvers.compressible import CompressibleSolver
    from tps_tpu.solvers.compressible import \
        CompressibleSolver as JCompressibleSolver

    rc = parse_run_configuration(IniInput.read(MINIMAL))
    rc.outdir = str(tmp_path)
    s = CompressibleSolver(rc, device="cpu")
    s.initialize()
    jrc = jparse(JIniInput.read(MINIMAL))
    jrc.outdir = str(tmp_path / "jax")
    js = JCompressibleSolver(jrc)
    js.initialize()
    return s, js


def test_coupling_api_matches_jax(tmp_path):
    s, js = _argon_solvers(tmp_path)
    rng = np.random.default_rng(0)
    U = np.asarray(js.U).copy()
    U[..., 4] *= 1e3  # an ion fraction ~1e-4: a conductivity worth comparing
    U[..., 5] *= 1e3 * rng.uniform(1.0, 5.0, U.shape[:-1])
    js.set_state_global(U)
    s.set_state_global(U)
    sig = s.evaluate_plasma_conductivity()
    jsig = np.asarray(js.evaluate_plasma_conductivity())
    assert tuple(sig.shape) == jsig.shape and jsig.max() > 0
    assert _rel(sig, jsig) <= TOL
    assert torch.equal(s.get_plasma_conductivity(), sig)
    # the setters copy into the tensors a captured step reads
    q = rng.uniform(-1e5, 1e6, sig.shape)
    ptrs = (s.get_joule_heating().data_ptr(), s.get_efield().data_ptr())
    s.set_joule_heating(q)
    s.set_efield(2.0 * q)
    assert ptrs == (s.get_joule_heating().data_ptr(),
                    s.get_efield().data_ptr())
    assert np.array_equal(s.get_joule_heating().numpy(), q)
    assert np.array_equal(s.get_efield().numpy(), 2.0 * q)
    js.set_joule_heating(q)
    js.set_efield(2.0 * q)
    assert np.array_equal(np.asarray(js.get_efield()), 2.0 * q)
    # the forcing reads the copy: one RHS with the heating against tps_tpu's
    from tps_torch.dg.rhs import compute_rhs
    from tps_tpu.dg import rhs as jrhs

    y, _ = compute_rhs(s.ctx, s.tables, torch.as_tensor(U))
    jy, _ = jrhs.compute_rhs(js.ctx, js.tables, jnp.asarray(U), 0.0,
                             fields=js.fields)
    jy = np.asarray(jy)
    for k in (3, 4, 5):
        assert _rel(y[..., k], jy[..., k]) <= 1e-11, k


def test_joule_heating_forcing_matches_jax(tmp_path):
    s, js = _argon_solvers(tmp_path)
    rng = np.random.default_rng(1)
    q = rng.uniform(-1e5, 1e6, s.get_joule_heating().shape)
    U = np.asarray(js.U)
    f = JouleHeating(mixture=s.mixture, heating=torch.as_tensor(q))
    jf = JJouleHeating(mixture=js.mixture)
    out = f(0.0, None, torch.as_tensor(U), None, None)
    jout = np.asarray(jf(0.0, None, jnp.asarray(U), None, None,
                         fields={"joule_heating": jnp.asarray(q)}))
    assert np.array_equal(out.numpy(), jout)
    assert out[..., 3].min() == 0.0 and out[..., 3].max() > 0
    # dry air: no conductivity
    from tps_torch.solvers.compressible import CompressibleSolver

    rc = parse_run_configuration(IniInput.read(os.path.join(
        REPO, "examples", "cases", "cyl2d_ogrid.ini")))
    rc.outdir = str(tmp_path)
    d = CompressibleSolver(rc, device="cpu")
    d.initialize()
    assert float(d.evaluate_plasma_conductivity().abs().max()) == 0.0


# ------------------------------------------------------------ the gate


def _gate_inputs(read, parse):
    inp = read(MINIMAL)
    inp.values["mesh/periodic_x"] = "1"
    inp.values["mesh/periodic_y"] = "1"
    inp.values["em/order"] = "1"
    inp.values["em/current_amplitude"] = "1e6"
    inp.values["em/current_frequency"] = "1e5"
    inp.values["cycle-avg-joule-coupled/solve-em-every-n"] = "2"
    inp.values["cycle-avg-joule-coupled/input-power"] = "0.5"
    inp.values["species/species3/initialMassFraction"] = "1.0e-4"
    inp.values["species/species2/initialMassFraction"] = "0.9999"
    inp.values["time/dt_fixed"] = "5e-8"
    rc = parse(inp)
    rc.max_iters = 4
    return rc


def _em_mesh(box):
    mesh = box(12, 12, x0=0.0, x1=0.04, y0=-0.015, y1=0.025)
    cent = mesh.vertices[mesh.elements].mean(axis=1)
    attrs = np.ones(mesh.num_elements, dtype=np.int64)
    ring = ((np.abs(cent[:, 0] - 0.02) < 0.004)
            & (np.abs(cent[:, 1] - 0.005) < 0.004))
    attrs[ring] = 2
    mesh.elem_attrs = attrs
    return mesh


def test_cycle_avg_joule_coupling(tmp_path):
    """tests/test_coupling.py::test_cycle_avg_joule_coupling with the
    compressible plasma solver (no plasma-solver key), both packages."""
    rc = _gate_inputs(IniInput.read, parse_run_configuration)
    rc.outdir = str(tmp_path)
    em = QuasiMagnetostaticSolverAxiSym(rc, mesh=_em_mesh(box_2d),
                                        device="cpu")
    em.initialize()
    c = CycleAvgJouleCoupling(rc, em_solver=em, device="cpu")
    c.initialize()
    assert c.plasma_kind == "compressible"
    jrc = _gate_inputs(JIniInput.read, jparse)
    jrc.outdir = str(tmp_path / "jax")
    jc = JCoupling(jrc)
    jc._em_in = JQms(jrc, mesh=_em_mesh(jbox_2d))
    jc._em_in.initialize()
    jc.initialize()
    U0 = np.asarray(jc.flow.U)
    assert _state_rel(c.flow.state_global(), U0) <= TOL
    c.flow.set_state_global(U0)
    ith = c.flow.mixture.i_th
    E0 = float(c.flow.U[..., ith].sum())
    c.solve()
    jc.solve()
    assert c.iter == 4 and c.flow.check_nan() == 0
    assert len(c.em_log) == 2
    for e in c.em_log:
        assert abs(e["joule"] - 0.5) / 0.5 < POWER_TOL
    assert abs(c.em.total_joule_heating() - 0.5) / 0.5 < POWER_TOL
    assert float(c.flow.U[..., ith].sum()) > E0
    qj = c.flow.get_joule_heating().numpy()
    assert qj.max() > 0 and np.isfinite(qj).all()
    assert _state_rel(c.flow.state_global(), jc.flow.U) <= DECK_TOL
    assert _rel(qj, jc.flow.get_joule_heating()) <= DECK_TOL
    assert _rel(c.flow.get_efield(), jc.flow.get_efield()) <= DECK_TOL
