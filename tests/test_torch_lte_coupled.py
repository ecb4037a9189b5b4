"""tps_torch/tools/lte_channel_coupled.ini, the LTE-table plasma under the
cycle-averaged Joule coupling, cut to size (flow 8x8 p=1, EM mesh 16x24,
EM updates at steps 0 and 10 of 12): through both packages' Tps API from
the same initial state on the CPU in f64, the state within 1e-10, the
conductivity and the Joule heating within 1e-9, the power on target at
each EM solve; through the CLI entry (`harness.main`, as `python -m
tps_torch --device cpu` runs it) in f32.  A file of its own beside
tests/test_torch_lte_fluid.py: the JAX package's coupled step takes most
of a minute to compile, and loadfile spreads the two files.
"""

import os

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
threadpool_limits(1)  # numpy's and scipy's BLAS too: one thread a worker

from tps_torch import harness  # noqa: E402
from tps_torch.io import h5lite  # noqa: E402
from tps_torch.solvers.coupling import CycleAvgJouleCoupling  # noqa: E402
from tps_tpu.harness import Tps as JTps  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CHANNEL = os.path.join(REPO, "tps_torch", "tools", "lte_channel_coupled.ini")
TOL = 1e-12
DECK_TOL = 1e-10
FIELD_TOL = 1e-9
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
    times the max speed (the cross-stream momentum starts at 0)."""
    U, ref = np.asarray(U), np.asarray(ref)
    dim = ref.shape[-1] - 2
    speed = np.max(np.abs(ref[..., 1:1 + dim]) / ref[..., :1])
    out = 0.0
    for q in range(ref.shape[-1]):
        scale = np.abs(ref[..., q]).max()
        if 1 <= q <= dim:
            scale = max(scale, ref[..., 0].max() * speed)
        out = max(out, np.abs(U[..., q] - ref[..., q]).max() / scale)
    return out


def _channel_small(tmp_path, iters=12):
    """lte_channel_coupled.ini at 8x8 p=1, its EM mesh 16x24, EM updates at
    steps 0 and 10, the tables named by absolute path."""
    with open(CHANNEL) as f:
        text = f.read()
    text = text.replace("nx = 64", "nx = 8").replace("ny = 64", "ny = 8")
    text = text.replace("order = 2", "order = 1", 1)
    text = text.replace("nx = 32", "nx = 16").replace("ny = 48", "ny = 24")
    text = text.replace("maxIters = 200", f"maxIters = {iters}")
    for rel in ("tps_torch/tools/lte_argon_thermo.h5",
                "tps_torch/tools/lte_argon_trans.h5",
                "examples/cases/nec_table.h5"):
        text = text.replace(rel, os.path.join(REPO, rel))
    text = text.replace("outdirBase = output/lte_channel_coupled",
                        f"outdirBase = {tmp_path / 'out'}")
    path = tmp_path / "channel.ini"
    path.write_text(text)
    return str(path)


def test_coupled_deck_matches_jax(tmp_path):
    path = _channel_small(tmp_path)
    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", path, "--device", "cpu"])
    tps.parse_input()
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    c = tps.solver
    assert isinstance(c, CycleAvgJouleCoupling)
    assert c.plasma_kind == "compressible"
    assert type(c.flow.mixture).__name__ == "LteMixture"
    assert c.flow._rhs.sweep.variant == "lte_2d"
    jtps = JTps()
    jtps.input_file = path
    jtps.parse_input()
    jtps.choose_devices()
    jtps.choose_solver()
    jtps.initialize()
    jc = jtps.solver
    assert _state_rel(c.flow.state_global(), jc.flow.U) <= TOL
    E0 = float(c.flow.U[..., 3].sum())
    tps.solve()
    # tps_tpu's coupled loop in its per-step form
    while jc.iter < jc.max_iters:
        jc.solve_step()
    assert c.iter == jc.iter == 12 and len(c.em_log) == 2
    for e in c.em_log:
        assert abs(e["joule"] / e["target"] - 1.0) < POWER_TOL
    assert _state_rel(c.flow.state_global(), jc.flow.U) <= DECK_TOL
    qj = c.flow.get_joule_heating()
    assert float(qj.max()) > 0
    assert _rel(qj, jc.flow.get_joule_heating()) <= FIELD_TOL
    sig = c.flow.evaluate_plasma_conductivity()
    assert float(sig.min()) > 1000.0  # the hot start conducts everywhere
    assert _rel(sig, jc.flow.evaluate_plasma_conductivity()) <= FIELD_TOL
    # the coil heats and the gas radiates: the energy moved
    assert float(c.flow.U[..., 3].sum()) != E0


def test_coupled_deck_through_the_cli(tmp_path, capsys):
    torch.set_default_dtype(torch.float32)
    path = _channel_small(tmp_path, iters=3)
    assert harness.main(["tps", "--runFile", path, "--device", "cpu"]) == 0
    assert capsys.readouterr().out.count("total input Joule heating") == 1
    f = h5lite.read(str(tmp_path / "out" / "restart_output.sol.h5"))
    assert int(f.attrs["iteration"]) == 3
    assert sorted(f["solution"].keys()) == ["density", "rho-E", "x-mom",
                                            "y-mom"]
