"""tps_torch/tools/argon_channel_coupled.ini, the compressible argon
plasma under the cycle-averaged Joule coupling, against the JAX package's,
on the CPU in f64: its flow mesh cut to 8x8 (p=2), its EM mesh to 16x24
and an EM update every 5 steps, 7 steps (updates at 0 and 5): through both
packages' API, the state within 1e-9 and the power on target to 1e-8;
through the CLI entry (`harness.main`, as `python -m tps_torch --device
cpu` runs it, f32) to its end.  A file of its own beside
tests/test_torch_compressible_coupling.py (the coupling's pieces), so
that loadfile spreads the two.
"""

import os

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
threadpool_limits(1)  # numpy's and scipy's BLAS too: one thread a worker

from tps_torch import harness  # noqa: E402
from tps_torch.solvers.coupling import CycleAvgJouleCoupling  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CHANNEL = os.path.join(REPO, "tps_torch", "tools", "argon_channel_coupled.ini")
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


# ------------------------------------------------------------ the deck


def _channel_small(tmp_path, iters=7):
    with open(CHANNEL) as f:
        text = f.read()
    text = text.replace("nx = 64", "nx = 8").replace("ny = 64", "ny = 8")
    text = text.replace("nx = 32", "nx = 16").replace("ny = 48", "ny = 24")
    text = text.replace("solve-em-every-n = 10", "solve-em-every-n = 5")
    text = text.replace("maxIters = 200", f"maxIters = {iters}")
    text = text.replace("outdirBase = output/argon_channel_coupled",
                        f"outdirBase = {tmp_path / 'out'}")
    path = tmp_path / "channel.ini"
    path.write_text(text)
    return str(path)


def test_channel_deck_matches_jax(tmp_path):
    """tps_torch/tools/argon_channel_coupled.ini cut to size (8x8 p=2, EM
    at steps 0 and 5 of 7): inlet with species, pressure outlet, two
    general walls and the coil, through both packages' Tps API from
    tps_tpu's initial state."""
    from tps_tpu.harness import Tps as JTps

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
    kinds = sorted(type(b.bc).__name__ for b in c.flow.bc_slices)
    assert kinds == ["GeneralWallBC", "GeneralWallBC", "InletBC", "OutletBC"]
    jtps = JTps()
    jtps.input_file = path
    jtps.parse_input()
    jtps.choose_devices()
    jtps.choose_solver()
    jtps.initialize()
    jc = jtps.solver
    c.flow.set_state_global(np.asarray(jc.flow.U))
    tps.solve()
    # tps_tpu's coupled loop in its per-step form (its chunked solve()
    # equals it on the compressible solver)
    while jc.iter < jc.max_iters:
        jc.solve_step()
    assert c.iter == jc.iter == 7 and len(c.em_log) == 2
    for e in c.em_log:
        assert abs(e["joule"] / e["target"] - 1.0) < POWER_TOL
    assert _state_rel(c.flow.state_global(), jc.flow.U) <= DECK_TOL
    assert _rel(c.flow.get_joule_heating(),
                jc.flow.get_joule_heating()) <= DECK_TOL
    Up = c.flow.mixture.primitives(c.flow.U).numpy()
    assert np.isfinite(Up).all() and Up[..., -1].max() > 300.0


def test_channel_deck_through_the_cli(tmp_path, capsys):
    torch.set_default_dtype(torch.float32)
    path = _channel_small(tmp_path, iters=10)
    assert harness.main(["tps", "--runFile", path, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("total input Joule heating") == 2
    from tps_torch.io import h5lite

    f = h5lite.read(str(tmp_path / "out" / "restart_output.sol.h5"))
    assert int(f.attrs["iteration"]) == 10
