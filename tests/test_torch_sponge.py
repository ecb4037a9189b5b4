"""tps_torch's geometric sponge (solvers/lomach/sponge.py) against the JAX
package's, on the CPU in f64.

- the multiplier field of each region (uniform, plane, cylinder, the 3-D
  annulus, and all of them at once) on the H1 dofs: bit for bit (the same
  numpy);
- a channel deck with a plane sponge at its outlet, the calorically-
  perfect thermo (conductivity scaled) and the planar Tomboulides flow
  (viscosity scaled), two steps through both packages' per-step loops:
  T, u and p to 1e-9 of max (solves to 1e-12);
- the axisymmetric flow scales its total viscosity by the same field.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tps_torch import harness  # noqa: E402
from tps_torch.fem import h1  # noqa: E402
from tps_torch.solvers.lomach import sponge  # noqa: E402
from tps_tpu.fem import h1 as jh1  # noqa: E402
from tps_tpu.harness import Tps as JTps  # noqa: E402
from tps_tpu.mesh.generators import box_2d as jbox_2d  # noqa: E402
from tps_tpu.mesh.generators import box_3d as jbox_3d  # noqa: E402
from tps_tpu.solvers.lomach import sponge as jsponge  # noqa: E402

F64 = torch.float64
DECK_TOL = 1e-9


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


def _regions(mod, name):
    """GeometricSponge keywords of one case, from module mod."""
    kw = {}
    if name in ("uniform", "all"):
        kw["uniform_mult"] = 2.0
    if name in ("plane", "all"):
        kw["plane"] = mod.PlaneSponge(point=(0.8, 0.0, 0.0),
                                      normal=(1.0, 0.2, 0.0), width=0.02,
                                      mult=50.0)
    if name in ("cylinder", "all"):
        kw["cylinder"] = mod.CylinderSponge(radius_z=0.3,
                                            point=(0.5, 0.5, 0.0),
                                            width=0.05, mult=8.0)
    if name in ("annulus", "all"):
        kw["annulus"] = mod.AnnulusSponge(point=(0.0, 0.4, 0.0),
                                          radius_y=0.6, width=0.2,
                                          mult=20.0)
    return kw


@pytest.mark.parametrize("name", ["uniform", "plane", "cylinder",
                                  "annulus", "all"])
def test_sponge_field_matches(name):
    jmesh = (jbox_3d(3, 3, 3) if name in ("annulus", "all")
             else jbox_2d(6, 6))
    tab_np = jh1.build_h1(jmesh, 2)
    tab = h1.h1_tables_from_numpy(tab_np).to_torch(F64, "cpu")
    ours = sponge.GeometricSponge(tab, **_regions(sponge, name))
    ref = jsponge.GeometricSponge(tab_np.to_jax(jnp.float64),
                                  **_regions(jsponge, name))
    m = ours.multiplier()
    np.testing.assert_array_equal(m.numpy(), np.asarray(ref.multiplier()))
    assert float(m.min()) >= 1.0 and float(m.max()) > 1.5


DECK = """
[solver]
type = loMach
[mesh]
generator = box2d
nx = 8
ny = 4
x1 = 1.0
y1 = 0.25
[loMach]
order = 2
flow-solver = tomboulides
thermo-solver = calorically-perfect
maxIters = 2
{axisym}
[loMach/calperfect]
viscosity-model = constant
viscosity/mu = 5e-3
[time]
dt_fixed = 1e-3
bdfOrder = 1
solverRelTolerance = 1e-12
[spongeMultiplier]
plane = 1
planePoint = '0.7 0.0 0.0'
planeNormal = '1.0 0.0 0.0'
planeWidth = 0.05
planeMult = 20.0
[boundaryConditions/inlet1]
patch = 4
type = inlet
velocity = '1.0 0.0'
temperature = 350.0
[boundaryConditions/wall1]
patch = 1
type = viscous
temperature = 300.0
[boundaryConditions/wall2]
patch = 3
type = viscous
[boundaryConditions/outlet1]
patch = 2
type = outlet
"""


def _port(text, tmp_path):
    path = tmp_path / "deck.ini"
    path.write_text(text)
    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", str(path), "--device",
                                 "cpu"])
    tps.parse_input()
    tps.config.outdir = str(tmp_path / "port")
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    return tps.solver


def test_sponge_deck_matches(tmp_path):
    ours = _port(DECK.format(axisym=""), tmp_path)
    ref = JTps()
    ref.input_file = str(tmp_path / "deck.ini")
    ref.parse_input()
    ref.config.raw.values["io/outdirBase"] = str(tmp_path / "jax")
    ref.choose_devices()
    ref.choose_solver()
    ref.initialize()
    ref = ref.solver
    np.testing.assert_array_equal(ours.sponge.multiplier().numpy(),
                                  np.asarray(ref.sponge.multiplier()))
    for _ in range(2):
        ours.solve_step()
        ref.solve_step()
    for a, b in ((ours.thermo.T, ref.thermo.T), (ours.flow.u, ref.flow.u),
                 (ours.flow.p, ref.flow.p)):
        assert _rel(a, b) <= DECK_TOL
    mult = ours.sponge.multiplier()
    _rho, mu = ours.flow._total_viscosity()
    assert torch.equal(mu, ours.thermo.viscosity() * mult)


def test_axisymmetric_flow_takes_the_sponge(tmp_path):
    s = _port(DECK.format(axisym="axisymmetric = 1"), tmp_path)
    assert type(s.flow).__name__ == "TomboulidesAxisym"
    mult = s.sponge.multiplier()
    _rho, mu = s.flow._total_viscosity()
    assert torch.equal(mu, s.thermo.viscosity() * mult)
    assert s.flow.sponge is s.sponge and s.thermo.sponge is s.sponge
    s.solve_step()
    assert bool(torch.isfinite(s.flow.u).all())
