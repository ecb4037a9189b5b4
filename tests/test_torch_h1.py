"""tps_torch's H1 substrate (tps_torch/fem/h1.py) against the JAX package's
(tps_tpu/fem/h1.py), on the CPU in f64.

- The set-up: the port's numpy tables equal the JAX package's, field by
  field (dof_gather included), and so do boundary_dofs and build_p_interp,
  on box2d 6x5 p=1..3, box3d 3^3 p=2 and a periodic box.
- The operators: each matches to 1e-12 of max|ref| on random fields, with
  no, scalar, nodal and quad-point coefficients.  Both sum the same
  products in another order (the port's assembly is a gather over the
  assembly transpose, the JAX package's a scatter), so they agree to
  rounding: ~1e-15.
- CG: cg_solve and cg_solve_multi with each preconditioner (Jacobi,
  Chebyshev, p-multigrid, the dense Cholesky factor) on a masked
  Dirichlet and a pure-Neumann system match to 1e-10 with the same
  iteration count: both run to the relative tolerance 1e-12, so solver
  noise, not rounding, sets this bound.
- The masked block CG gives the bits of the plain unblocked loop, for
  blocks of 1, 3 and 8 iterations.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tps_torch.fem import h1  # noqa: E402
from tps_torch.mesh.generators import box_2d, box_3d  # noqa: E402
from tps_tpu.fem import h1 as jh1  # noqa: E402
from tps_tpu.mesh.generators import box_2d as jbox_2d  # noqa: E402
from tps_tpu.mesh.generators import box_3d as jbox_3d  # noqa: E402

OP_TOL = 1e-12
CG_TOL = 1e-10
F64 = torch.float64

CASES = {
    "2d_p1": ("2d", (6, 5), {}, 1),
    "2d_p2": ("2d", (6, 5), {}, 2),
    "2d_p3": ("2d", (6, 5), {}, 3),
    "3d_p2": ("3d", (3, 3, 3), {}, 2),
    "periodic_p2": ("2d", (4, 4), {"periodic_x": True, "periodic_y": True}, 2),
}


def _meshes(name):
    kind, n, kw, _order = CASES[name]
    if kind == "2d":
        return box_2d(*n, **kw), jbox_2d(*n, **kw)
    return box_3d(*n, **kw), jbox_3d(*n, **kw)


class _Space:
    """One case's tables in both packages, numpy and on their devices."""

    def __init__(self, name):
        self.mesh, self.jmesh = _meshes(name)
        order = CASES[name][3]
        self.np = h1.build_h1(self.mesh, order)
        self.jnp = jh1.build_h1(self.jmesh, order)
        self.t = h1.h1_tables_from_numpy(self.jnp).to_torch(F64, "cpu")
        self.j = self.jnp.to_jax(jnp.float64)


@pytest.fixture(scope="module")
def spaces():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _Space(name)
        return cache[name]

    return get


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# ------------------------------------------------------------------ set-up


@pytest.mark.parametrize("name", list(CASES))
def test_tables_match(spaces, name):
    sp = spaces(name)
    ours, ref = sp.np, sp.jnp
    for f in ("dim", "order", "ne", "ndof_el", "nq", "ndofs", "nqf", "nbf"):
        assert getattr(ours, f) == getattr(ref, f), f
    for f in ("elem_dofs", "Bvol", "Gvol", "wq", "adjJ", "detJ", "xyz",
              "xyz_q", "bf_elem", "bf_attr", "bf_Btr", "bf_nor", "bf_wts",
              "bf_xyz", "dof_gather"):
        a, b = getattr(ours, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert ours.elem_valid is None and ref.elem_valid is None
    np.testing.assert_array_equal(h1.boundary_dofs(ours),
                                  jh1.boundary_dofs(ref))
    np.testing.assert_array_equal(h1.boundary_dofs(ours, (1, 3)),
                                  jh1.boundary_dofs(ref, (1, 3)))
    if ours.order > 1:
        ours_c = h1.build_h1(sp.mesh, 1)
        ref_c = jh1.build_h1(sp.jmesh, 1)
        for a, b in zip(h1.build_p_interp(ours, ours_c, sp.mesh),
                        jh1.build_p_interp(ref, ref_c, sp.jmesh)):
            assert np.array_equal(a, np.asarray(b))


def test_tables_carry_over(spaces):
    """h1_tables_from_numpy takes the JAX package's tables as they are;
    to_torch casts floats to the requested dtype."""
    sp = spaces("2d_p2")
    carried = h1.h1_tables_from_numpy(sp.jnp)
    for f in ("elem_dofs", "adjJ", "dof_gather", "bf_Btr"):
        assert np.array_equal(getattr(carried, f), getattr(sp.jnp, f))
    t32 = carried.to_torch(torch.float32, "cpu")
    assert t32.adjJ.dtype == torch.float32
    assert t32.elem_dofs.dtype == torch.int32


# --------------------------------------------------------------- operators

COEFS = ("none", "scalar", "nodal", "quad")
COEF_OPS = ("mass_apply", "diffusion_apply", "mass_lumped_diag", "mass_diag",
            "stiffness_diag", "weak_grad", "weak_divergence", "element_mass",
            "element_stiffness")
PLAIN_OPS = ("mass_apply_multi", "diffusion_apply_multi", "convection_apply",
             "grad_at_dofs", "divergence_at_dofs", "integrate",
             "surface_normal_form", "surface_normal_form_sel", "to_quad",
             "helmholtz_apply_multi", "diffusion_apply_tensor",
             "assemble_dense", "grid_scale_q")
# where the periodic gluing shows (shared dofs across the seam, no faces)
PERIODIC_OPS = ("diffusion_apply_multi", "grad_at_dofs",
                "surface_normal_form", "assemble_dense")


def _inputs(sp, seed):
    rng = np.random.default_rng(seed)
    tab = sp.np
    return {"u": rng.standard_normal(tab.ndofs),
            "V": rng.standard_normal((tab.ndofs, tab.dim)),
            "c": 1.0 + rng.random(tab.ndofs),
            "cq": 1.0 + rng.random((tab.ne, tab.nq)),
            "mc": rng.random((tab.dim, tab.ne, tab.nq)),
            "dc": rng.random((tab.dim, tab.ne, tab.nq)),
            "Kq": rng.random((tab.ne, tab.nq, tab.dim, tab.dim)),
            "sel": (rng.random(tab.nbf) > 0.5).astype(np.float64)}


def _coef(kind, x, lib):
    if kind == "none":
        return None
    if kind == "scalar":
        return 2.5
    arr = x["c"] if kind == "nodal" else x["cq"]
    return torch.as_tensor(arr) if lib == "torch" else jnp.asarray(arr)


def _call(op, mod, tab, x, coef, lib):
    a = (lambda v: torch.as_tensor(v)) if lib == "torch" else jnp.asarray
    u, V = a(x["u"]), a(x["V"])
    if op in ("mass_apply", "diffusion_apply", "weak_grad"):
        return getattr(mod, op)(tab, u, coef)
    if op == "weak_divergence":
        return mod.weak_divergence(tab, V, coef)
    if op in COEF_OPS:
        return getattr(mod, op)(tab, coef)
    if op == "mass_apply_multi":
        return mod.mass_apply(tab, V, a(x["c"]))
    if op == "diffusion_apply_multi":
        return mod.diffusion_apply(tab, V, a(x["cq"]))
    if op == "convection_apply":
        return mod.convection_apply(tab, u, V)
    if op == "grad_at_dofs":
        return mod.grad_at_dofs(tab, u)
    if op == "divergence_at_dofs":
        return mod.divergence_at_dofs(tab, V)
    if op == "integrate":
        return mod.integrate(tab, a(x["c"]))
    if op == "surface_normal_form":
        return mod.surface_normal_form(tab, V)
    if op == "surface_normal_form_sel":
        return mod.surface_normal_form(tab, V, a(x["sel"]))
    if op == "to_quad":
        return mod.to_quad(tab, u)
    if op == "helmholtz_apply_multi":
        return mod.helmholtz_apply_multi(tab, V, 3.0, a(x["mc"]), a(x["dc"]))
    if op == "diffusion_apply_tensor":
        return mod.diffusion_apply_tensor(tab, u, a(x["Kq"]))
    if op == "assemble_dense":
        Ke = mod.element_stiffness(tab, a(x["c"]))
        return mod.assemble_dense(tab, (torch.stack if lib == "torch"
                                        else jnp.stack)([Ke, 2.0 * Ke]))
    if op == "grid_scale_q":
        return mod.grid_scale_q(tab, tab.order)
    raise KeyError(op)


@pytest.mark.parametrize("name,coef",
                         [("2d_p3", c) for c in COEFS] + [("3d_p2", "quad")])
@pytest.mark.parametrize("op", COEF_OPS)
def test_coefficient_operators_match(spaces, name, op, coef):
    sp = spaces(name)
    x = _inputs(sp, 1)
    ours = _call(op, h1, sp.t, x, _coef(coef, x, "torch"), "torch")
    ref = _call(op, jh1, sp.j, x, _coef(coef, x, "jax"), "jax")
    assert tuple(ours.shape) == tuple(np.shape(ref))
    assert _rel(ours, ref) < OP_TOL


@pytest.mark.parametrize("name,op",
                         [(n, op) for n in ("2d_p2", "3d_p2") for op in PLAIN_OPS]
                         + [("periodic_p2", op) for op in PERIODIC_OPS])
def test_operators_match(spaces, name, op):
    sp = spaces(name)
    x = _inputs(sp, 2)
    ours = _call(op, h1, sp.t, x, None, "torch")
    ref = _call(op, jh1, sp.j, x, None, "jax")
    assert tuple(ours.shape) == tuple(np.shape(ref))
    assert _rel(ours, ref) < OP_TOL


# ---------------------------------------------------------------------- CG


class _System:
    """A Helmholtz (Dirichlet, masked) or pure-Neumann Laplacian system on
    one space, with the same data in both packages."""

    def __init__(self, sp, kind):
        self.sp, self.kind = sp, kind
        tab = sp.np
        rng = np.random.default_rng(3)
        self.c = 1.0 + rng.random(tab.ndofs)
        b = rng.standard_normal(tab.ndofs)
        if kind == "dirichlet":
            self.mask = np.ones(tab.ndofs)
            self.mask[h1.boundary_dofs(tab)] = 0.0
            self.b = b * self.mask
            self.B = np.stack([self.b, np.roll(self.b, 3) * self.mask], -1)
            self.x0 = 0.1 * rng.standard_normal(tab.ndofs) * self.mask
        else:
            self.mask = None
            self.b = b - b.mean()
            B = np.stack([b, np.roll(b, 5)], -1)
            self.B = B - B.mean(axis=0)
            self.x0 = None
        self.ortho = kind == "neumann"
        self.coarse = h1.build_h1(sp.mesh, 1)
        self.coarse_j = jh1.build_h1(sp.jmesh, 1)

    def pieces(self, lib):
        """(apply, diag, masked apply and diag, mask, preconditioner
        factory) in one package."""
        sp = self.sp
        if lib == "torch":
            mod, tab, a = h1, sp.t, (lambda v: torch.as_tensor(v))
        else:
            mod, tab, a = jh1, sp.j, jnp.asarray
        c = a(self.c)
        helm = self.kind == "dirichlet"

        def apply(v):
            out = mod.diffusion_apply(tab, v, c)
            return out + mod.mass_apply(tab, v) if helm else out

        diag = mod.stiffness_diag(tab, c)
        if helm:
            diag = diag + mod.mass_lumped_diag(tab)
        mask = None if self.mask is None else a(self.mask)
        if mask is None:
            app_m, diag_m = apply, diag
        else:
            def app_m(v):
                m = mask[:, None] if v.ndim == 2 else mask
                return apply(v * m) * m + v * (1.0 - m)
            diag_m = diag * mask + (1.0 - mask)

        def precond(kind):
            if kind == "jacobi":
                return None
            if kind == "chebyshev":
                return mod.chebyshev_precond(app_m, diag_m, degree=3)
            if kind == "direct":
                K = mod.element_stiffness(tab, c)
                if helm:
                    K = K + mod.element_mass(tab)
                K = mod.assemble_dense(tab, K)
                K = mod.dense_constrain(K, mask=mask, ortho=self.ortho)
                return mod.direct_precond(mod.dense_cholesky(K))
            # two-level p-multigrid, the coarse coefficient injected
            ct, cj = self.coarse, self.coarse_j
            if lib == "torch":
                tab_c = ct.to_torch(F64, "cpu")
                P = h1.PInterp.from_numpy(
                    *h1.build_p_interp(sp.np, ct, sp.mesh), ct.ndofs, F64,
                    "cpu")
                c2f = P.c2f
            else:
                tab_c = cj.to_jax(jnp.float64)
                P_ids, P_wts, c2f = jh1.build_p_interp(sp.jnp, cj, sp.jmesh)
            cc = c[c2f]
            mc = None if mask is None else mask[c2f]

            def app_c(v):
                vv = v if mc is None else v * mc
                out = mod.diffusion_apply(tab_c, vv, cc)
                if helm:
                    out = out + mod.mass_apply(tab_c, vv)
                return out if mc is None else out * mc + v * (1.0 - mc)

            diag_c = mod.stiffness_diag(tab_c, cc)
            if helm:
                diag_c = diag_c + mod.mass_lumped_diag(tab_c)
            if mc is not None:
                diag_c = diag_c * mc + (1.0 - mc)
            if lib == "torch":
                return h1.pmg_precond(app_m, diag_m, app_c, diag_c, P,
                                      ortho=self.ortho)
            return jh1.pmg_precond(app_m, diag_m, app_c, diag_c, P_ids,
                                   jnp.asarray(P_wts), cj.ndofs,
                                   ortho=self.ortho)

        return apply, diag_m, mask, precond


@pytest.fixture(scope="module")
def systems(spaces):
    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = _System(spaces("2d_p3"), kind)
        return cache[kind]

    return get


@pytest.mark.parametrize("kind", ["dirichlet", "neumann"])
@pytest.mark.parametrize("prec", ["jacobi", "chebyshev", "pmg", "direct"])
def test_cg_solve_matches(systems, kind, prec):
    sy = systems(kind)
    out = {}
    for lib, mod in (("torch", h1), ("jax", jh1)):
        a = (lambda v: torch.as_tensor(v)) if lib == "torch" else jnp.asarray
        apply, diag, mask, precond = sy.pieces(lib)
        x0 = None if sy.x0 is None else a(sy.x0)
        out[lib] = mod.cg_solve(apply, a(sy.b), x0=x0, diag=diag,
                                dirichlet_mask=mask, M=precond(prec),
                                tol=1e-12, maxiter=400, return_info=True)
    (x, it, res), (xj, itj, resj) = out["torch"], out["jax"]
    assert int(it) == int(itj) and 0 < int(it) < 400
    assert float(res) < 1e-12 and float(resj) < 1e-12
    assert _rel(x, xj) < CG_TOL


@pytest.mark.parametrize("kind", ["dirichlet", "neumann"])
@pytest.mark.parametrize("prec", ["jacobi", "direct"])
def test_cg_solve_multi_matches(systems, kind, prec):
    """All columns stopped together (the velocity solve on the dense
    factor)."""
    sy = systems(kind)
    out = {}
    for lib, mod in (("torch", h1), ("jax", jh1)):
        a = (lambda v: torch.as_tensor(v)) if lib == "torch" else jnp.asarray
        apply, diag, mask, precond = sy.pieces(lib)
        out[lib] = mod.cg_solve_multi(
            apply, a(sy.B), diag=diag[:, None],
            dirichlet_mask=None if mask is None else mask[:, None],
            M=precond(prec), tol=1e-12, maxiter=400, return_info=True)
    (x, it, res), (xj, itj, resj) = out["torch"], out["jax"]
    assert int(it) == int(itj) and 0 < int(it) < 400
    assert _rel(x, xj) < CG_TOL


@pytest.mark.parametrize("kind", ["dirichlet", "neumann"])
@pytest.mark.parametrize("prec", ["jacobi", "chebyshev"])
def test_per_column_cg_matches_separate_solves(systems, kind, prec):
    """cg_solve_multi(per_column=True) == the JAX package's cg_solve on each
    column (the velocity solve without the dense factor): the same x and
    the same summed iteration count."""
    sy = systems(kind)
    apply, diag, mask, precond = sy.pieces("torch")
    x, it, res = h1.cg_solve_multi(
        apply, torch.as_tensor(sy.B), diag=diag, dirichlet_mask=mask,
        M=precond(prec), tol=1e-12, maxiter=400, return_info=True,
        per_column=True)
    applyj, diagj, maskj, precondj = sy.pieces("jax")
    Mj = precondj(prec)
    cols = [jh1.cg_solve(applyj, jnp.asarray(sy.B[:, c]), diag=diagj,
                         dirichlet_mask=maskj, M=Mj, tol=1e-12, maxiter=400,
                         return_info=True) for c in range(sy.B.shape[1])]
    assert int(it) == sum(int(c[1]) for c in cols)
    assert float(res) == pytest.approx(max(float(c[2]) for c in cols),
                                       rel=1e-6)
    assert _rel(x, np.stack([np.asarray(c[0]) for c in cols], -1)) < CG_TOL


def _plain_cg(A, b, M, tol, maxiter):
    """The unblocked loop, in the arithmetic of fem/h1.py's iteration."""
    x = torch.zeros_like(b)
    r = b - A(x)
    z = M(r)
    p = z.clone()
    rz = torch.sum(r * z)
    tol = max(tol, 50.0 * float(torch.finfo(b.dtype).eps))
    atol2 = (tol * torch.sqrt(torch.sum(b * b))) ** 2 + 1e-300
    it = 0
    while bool(torch.sum(r * r) > atol2) and it < maxiter:
        Ap = A(p)
        alpha = rz / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.sum(r * z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    return x, it


@pytest.mark.parametrize("block", [1, 3, 8])
def test_masked_block_cg_is_the_plain_loop(systems, block):
    """Blocks of masked iterations give the plain loop's x bit for bit and
    its iteration count, whatever the block length."""
    sy = systems("dirichlet")
    apply, diag, mask, precond = sy.pieces("torch")

    def A(v):
        return apply(v * mask) * mask + v * (1.0 - mask)

    M = precond("chebyshev")
    b = torch.as_tensor(sy.b)
    ref, it_ref = _plain_cg(A, b, M, 1e-12, 400)
    x, it, _ = h1.cg_solve(A, b, M=M, tol=1e-12, maxiter=400,
                           return_info=True, block=block)
    assert int(it) == it_ref and torch.equal(x, ref)
    # the iteration cap inside a block stops there too
    x7, it7, _ = h1.cg_solve(A, b, M=M, tol=1e-12, maxiter=7,
                             return_info=True, block=block)
    ref7, _ = _plain_cg(A, b, M, 1e-12, 7)
    assert int(it7) == 7 and torch.equal(x7, ref7)
