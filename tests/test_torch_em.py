"""tps_torch's axisymmetric EM solver and GMRES against the JAX package's,
on the CPU in f64.

- `krylov.gmres_solve` on a nonsymmetric system, restarted: plain f64,
  f32 Arnoldi cycles under an f64 outer loop (GMRES-IR), and a tolerance
  below reach that the stall test stops: the same iteration count, x to
  1e-10 of max, the reported relative residual the true one and below
  the tolerance in both packages;
- `em_mesh_from_ini`: the same mesh and ring attributes;
- QuasiMagnetostaticSolverAxiSym on a 10x10 EM mesh with a Gaussian
  column of conductivity, on the dense Schur path and (dense cutoff 0 in
  both packages) on GMRES-IR: both solves below 1e-10 relative residual,
  the same GMRES iterations, the difference of the two solutions mapped
  by the block operator within 2e-10 of |b|; A_re, A_im, the Joule
  heating and the diagnostics (total Joule heating, magnetic energy,
  coil current) to 1e-10 of max on the dense path, and on GMRES-IR to
  1e-6 (its f32 cycles round the last digits, and the block system's
  condition turns a 1e-10 residual into ~1e-8 of |A|);
- the dense path in f32 with no current (b = 0) reports a relative
  residual of 0, not NaN (the JAX package's floor 1e-300 is 0 in f32);
- element-sharded EM raises ROADMAP A8.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tps_torch.config.ini import IniInput  # noqa: E402
from tps_torch.config.run_config import parse_run_configuration  # noqa: E402
from tps_torch.fem import h1, krylov  # noqa: E402
from tps_torch.solvers.em import qms  # noqa: E402
from tps_tpu.config.ini import IniInput as JIniInput  # noqa: E402
from tps_tpu.config.run_config import \
    parse_run_configuration as jparse  # noqa: E402
from tps_tpu.fem import h1 as jh1  # noqa: E402
from tps_tpu.fem import krylov as jkrylov  # noqa: E402
from tps_tpu.solvers.em import qms as jqms  # noqa: E402

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


# ------------------------------------------------------------------ GMRES

def _system(n=48, seed=5):
    rng = np.random.default_rng(seed)
    A = np.eye(n) * 4.0 + rng.standard_normal((n, n)) / np.sqrt(n) \
        + np.diag(np.linspace(0.0, 20.0, n))
    return A, rng.standard_normal(n)


@pytest.mark.parametrize("variant", ["f64", "ir", "stall"])
def test_gmres_matches(variant):
    A, b = _system()
    d = 1.0 / np.diag(A)
    kw = dict(tol=1e-17 if variant == "stall" else 1e-11, restart=8,
              maxiter=400)
    tA, tb, td = (torch.as_tensor(v) for v in (A, b, d))
    jA, jb, jd = (jnp.asarray(v) for v in (A, b, d))
    tk, jk = dict(kw), dict(kw, return_info=True)
    if variant == "ir":
        tk["cycle_dtype"] = torch.float32
        jk["cycle_dtype"] = jnp.float32
    x, it, rr = krylov.gmres_solve(lambda v: tA @ v, tb,
                                   M=lambda v: v * td, **tk)
    jx, jit, jrr = jkrylov.gmres_solve(lambda v: jA @ v, jb,
                                       M=lambda v: v * jd, **jk)
    assert it == int(jit) and it > 8  # more than one restart cycle
    assert _rel(x, jx) < TOL
    true = np.linalg.norm(b - A @ x.numpy()) / np.linalg.norm(b)
    assert float(rr) == pytest.approx(true, rel=1e-6, abs=1e-15)
    if variant == "stall":  # stopped by the stall test, not the cap
        assert it < 400 and 1e-17 < float(rr) < 1e-13
        assert abs(np.log10(float(rr) / float(jrr))) < 1.0
    else:  # both to the tolerance (the last digits are rounding)
        assert float(rr) < 1e-11 and float(jrr) < 1e-11


# --------------------------------------------------------------------- EM

EM_INI = """
[em]
generator = box2d
nx = 10
ny = 10
x0 = 0.0
x1 = 0.05
y0 = -0.02
y1 = 0.10
ring1/center = 0.03 0.04
ring1/halfwidth = 0.007 0.012
current_amplitude = {amp}
current_frequency = 1e5
"""


def _configs(tmp_path, amp=1e6):
    path = tmp_path / "em.ini"
    path.write_text(EM_INI.format(amp=amp))
    return (parse_run_configuration(IniInput.read(str(path))),
            jparse(JIniInput.read(str(path))))


def test_em_mesh_from_ini_matches(tmp_path):
    rc, jrc = _configs(tmp_path)
    m, jm = qms.em_mesh_from_ini(rc.raw), jqms.em_mesh_from_ini(jrc.raw)
    np.testing.assert_array_equal(m.vertices, jm.vertices)
    np.testing.assert_array_equal(m.elements, jm.elements)
    np.testing.assert_array_equal(m.attributes(), jm.attributes())
    assert (m.attributes() == 2).sum() > 0


def _sigma(xyz):
    return 50.0 * np.exp(-(xyz[:, 0] / 0.01) ** 2
                         - ((xyz[:, 1] - 0.04) / 0.025) ** 2)


@pytest.mark.parametrize("path", ["dense", "gmres"])
def test_qms_solve_matches(monkeypatch, tmp_path, path):
    if path == "gmres":
        monkeypatch.setattr(h1, "DENSE_DIRECT_MAX", 0)
        monkeypatch.setattr(jh1, "DENSE_DIRECT_MAX", 0)
    rc, jrc = _configs(tmp_path)
    ours = qms.QuasiMagnetostaticSolverAxiSym(rc, device="cpu")
    ours.initialize()
    ref = jqms.QuasiMagnetostaticSolverAxiSym(jrc)
    ref.initialize()
    sig = _sigma(ours.tab_np.xyz)
    ours.set_plasma_conductivity(torch.as_tensor(sig))
    ref.set_plasma_conductivity(jnp.asarray(sig))
    ours.solve_step()
    ref.solve_step()
    assert ours.last_solve_iters == ref.last_solve_iters
    if path == "gmres":
        assert ours.last_solve_iters > 30  # more than one restart cycle
    assert ours.last_solve_relres < 1e-10
    assert ref.last_solve_relres < 1e-10
    # the two solutions differ by a vector the block operator maps to
    # within the two solves' residuals (both below 1e-10 of |b|)
    _, _, apply, b = ours._operands(ours.plasma_conductivity)
    d = torch.cat([ours.A_re - torch.as_tensor(np.array(ref.A_re)),
                   ours.A_im - torch.as_tensor(np.array(ref.A_im))])
    assert float(torch.linalg.norm(apply(d)) / torch.linalg.norm(b)) < 2e-10
    # the fields themselves: 1e-10 on the dense path; on GMRES-IR the f32
    # cycles leave the last digits to rounding, and the mu0-scaled block
    # system (condition ~1e5) turns a 1e-10 residual into ~1e-8 of |A|
    tol = TOL if path == "dense" else 1e-6
    for a, b in ((ours.A_re, ref.A_re), (ours.A_im, ref.A_im),
                 (ours.joule_heating, ref.joule_heating)):
        assert _rel(a, b) < tol
    for e, je in zip(ours.electric_field(), ref.electric_field()):
        assert _rel(e, je) < tol
    for name in ("total_joule_heating", "magnetic_energy", "coil_current"):
        assert getattr(ours, name)() == pytest.approx(
            getattr(ref, name)(), rel=tol)
    ours.scale_joule_heating(3.0)
    ref.scale_joule_heating(3.0)
    assert ours.total_joule_heating() == pytest.approx(
        ref.total_joule_heating(), rel=tol)


def test_qms_f32_relres_with_no_current(tmp_path):
    """b = 0 in f32: the relative residual reads 0 (a 1e-300 floor, as the
    JAX package's, is 0 in f32 and gives 0/0)."""
    torch.set_default_dtype(torch.float32)
    rc, _ = _configs(tmp_path, amp=0.0)
    em = qms.QuasiMagnetostaticSolverAxiSym(rc, device="cpu")
    em.initialize()
    em.set_plasma_conductivity(torch.as_tensor(_sigma(em.tab_np.xyz)))
    em.solve_step()
    assert em.A_re.dtype == torch.float32
    assert em.last_solve_relres == 0.0
    assert float(em.joule_heating.abs().max()) == 0.0


def test_sharded_em_raises(tmp_path):
    rc, _ = _configs(tmp_path)
    rc.raw.values["em/partitions"] = "2"
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        qms.QuasiMagnetostaticSolverAxiSym(rc, device="cpu").initialize()
