"""tps_torch's axisymmetric Tomboulides flow (solvers/lomach/axisym.py)
against the JAX package's, on the CPU in f64.

The same numpy state goes through a few steps of each package's
TomboulidesAxisym:

- circular Couette with swirl (tests/test_lomach_axisym.py's set-up at
  12x3 p=2: the inner cylinder turning, the outer one fixed, u_theta
  started at half the steady profile and a meridional perturbation on
  top), on the lagged dense factors and, with the dense cutoff set to 0 in
  both packages, on Jacobi-preconditioned CG: u, u_theta and p to 1e-10
  of their max;
- the Poiseuille pipe's start (the axis Dirichlet on u_r, a body force,
  no swirl) through the port alone: u_r = 0 on the axis (its parity is
  the coupled deck's, tests/test_torch_coupling.py, whose column has an
  axis).

Every solve runs to its relative tolerance (1e-12), so solver noise, not
rounding, sets the bound.  Two steps at BDF order 3 from a history
equal to the start state (one compile of the JAX package's step a case).
"""

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
threadpool_limits(1)  # numpy's and scipy's BLAS too: one thread a worker

import jax.numpy as jnp  # noqa: E402

from tps_torch.fem import h1  # noqa: E402
from tps_torch.mesh.generators import box_2d  # noqa: E402
from tps_torch.solvers.lomach import axisym as taxi  # noqa: E402
from tps_torch.solvers.lomach import base as tbase  # noqa: E402
from tps_torch.solvers.lomach import tomboulides as ttomb  # noqa: E402
from tps_tpu.fem import h1 as jh1  # noqa: E402
from tps_tpu.mesh.generators import box_2d as jbox_2d  # noqa: E402
from tps_tpu.solvers.lomach import axisym as jaxi  # noqa: E402
from tps_tpu.solvers.lomach import base as jbase  # noqa: E402
from tps_tpu.solvers.lomach import tomboulides as jtomb  # noqa: E402

F64 = torch.float64
TOL = 1e-10


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(autouse=True)
def f64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(F64)
    yield
    torch.set_default_dtype(prev)


def _couette(mods, tab, arr):
    """test_lomach_axisym.py::test_couette_swirl's flow, its start state."""
    tmod, base = mods
    r1, r2, Om1 = 0.5, 1.5, 2.0
    flow = tmod[1].TomboulidesAxisym(
        tab, base.ConstantPropertyThermoChem(tab, rho=1.0, mu=0.05),
        swirl=True,
        vel_bcs=[tmod[0].VelocityDirichlet(attrs=(2, 4), value=(0.0, 0.0))],
        swirl_bcs=[taxi.SwirlDirichlet((4,), Om1 * r1),
                   taxi.SwirlDirichlet((2,), 0.0)], cg_tol=1e-12)
    r = np.asarray(tab.xyz[:, 0])
    z = np.asarray(tab.xyz[:, 1])
    A = -Om1 * r1 ** 2 / (r2 ** 2 - r1 ** 2)
    B = Om1 * r1 * r2 ** 2 * r1 / (r2 ** 2 - r1 ** 2)
    flow.set_swirl(arr(0.5 * (A * r + B / r)))
    bump = np.sin(np.pi * (r - r1)) * np.sin(2 * np.pi * z / 0.4)
    flow.set_velocity(arr(np.stack([0.05 * bump, 0.02 * bump], -1)))
    return flow, 0.05


def _pipe(mods, tab, arr):
    """test_lomach_axisym.py::test_poiseuille_pipe's flow, half the
    steady profile."""
    tmod, base = mods
    mu, F = 0.1, 0.4
    bf = ((lambda xyz: np.stack([np.zeros(len(xyz)), np.full(len(xyz), F)],
                                -1)) if arr is torch.as_tensor else
          (lambda xyz: jnp.stack([jnp.zeros(xyz.shape[0]),
                                  jnp.full(xyz.shape[0], F)], -1)))
    flow = tmod[1].TomboulidesAxisym(
        tab, base.ConstantPropertyThermoChem(tab, rho=1.0, mu=mu),
        vel_bcs=[tmod[0].VelocityDirichlet(attrs=(2,), value=(0.0, 0.0))],
        body_force=bf, cg_tol=1e-12)
    r = np.asarray(tab.xyz[:, 0])
    uz = F / (4.0 * mu) * (1.0 - r ** 2)
    flow.set_velocity(arr(np.stack([0.01 * np.sin(np.pi * r), 0.5 * uz],
                                   -1)))
    return flow, 0.04


CASES = {
    "couette": (lambda: jbox_2d(12, 3, x0=0.5, x1=1.5, y1=0.4,
                                periodic_y=True), _couette),
    "pipe": (lambda: jbox_2d(10, 3, x1=1.0, y1=1.0, periodic_y=True), _pipe),
}


@pytest.mark.parametrize("case,dense", [("couette", True),
                                        ("couette", False)])
def test_axisym_steps_match(monkeypatch, case, dense):
    if not dense:
        monkeypatch.setattr(h1, "DENSE_DIRECT_MAX", 0)
        monkeypatch.setattr(jh1, "DENSE_DIRECT_MAX", 0)
    make_mesh, make_flow = CASES[case]
    tab_np = jh1.build_h1(make_mesh(), 2)
    tt = h1.h1_tables_from_numpy(tab_np).to_torch(F64, "cpu")
    tj = tab_np.to_jax(jnp.float64)
    ours, dt = make_flow(((ttomb, taxi), tbase), tt, torch.as_tensor)
    ref, _ = make_flow(((jtomb, jaxi), jbase), tj, jnp.asarray)
    for _ in range(2):
        ours.step(tbase.TemporalCoefficients.bdf(3), dt)
        ref.step(jbase.TemporalCoefficients.bdf(3), dt)
    assert (ours._direct is not None) == dense
    assert _rel(ours.u, ref.u) < TOL
    assert _rel(ours.p, ref.p) < TOL
    assert float(ours.ut.abs().max()) > 0.4
    assert _rel(ours.ut, ref.ut) < TOL
    info = ours.solve_info
    assert info["p_res"] < 1e-10 and info["v_res"] < 1e-10


def test_axis_dirichlet_and_body_force():
    """The pipe: after a step u_r is 0 on the axis, u_z follows the body
    force, and the solves converge."""
    make_mesh, make_flow = CASES["pipe"]
    tab = h1.build_h1(box_2d(10, 3, x1=1.0, y1=1.0, periodic_y=True),
                      2).to_torch(F64, "cpu")
    flow, dt = make_flow(((ttomb, taxi), tbase), tab, torch.as_tensor)
    uz0 = flow.u[:, 1].clone()
    for _ in range(2):
        flow.step(tbase.TemporalCoefficients.bdf(3), dt)
    axis = tab.xyz[:, 0] < 1e-12
    assert bool(axis.any()) and float(flow.u[axis, 0].abs().max()) == 0.0
    assert float((flow.u[:, 1] - uz0).max()) > 0.0
    info = flow.solve_info
    assert info["p_res"] < 1e-10 and info["v_res"] < 1e-10
