"""Quasimagnetostatic EM solver, axisymmetric, frequency domain.

The port of the JAX package's solvers/em/qms.py (the A_theta formulation
of the reference, src/quasimagnetostatic.cpp:790-1400):

  block system  [ K          -w M_sigma ] [A_re]   [r]
                [ w M_sigma   K         ] [A_im] = [0]

  K        = (grad v, r grad A) + (v, A/r)           (:855-857)
  M_sigma  = (v, mu0 sigma 2 pi f  r A)              (:1014-1019)
  r        = (v, mu0 I/2 r) over coil-ring elements  (InitializeCurrent)
  A = 0 on the whole boundary.

Two solve paths, as the JAX package's: up to `h1.DENSE_DIRECT_MAX` dofs a
dense Schur-complement solve (a_im = -K^-1 M a_re gives the SPD system
(K + M K^-1 M) a_re = b_re: two Cholesky factors and two matrix-free
refinement steps); above it diagonally preconditioned GMRES on the
matrix-free block operator (fem/krylov.py), with f32 Arnoldi cycles under
an f64 outer loop when the solve runs in f64 (GMRES-IR).  Every product
of a solve runs in full precision (TF32 off): the mu0-scaled block system
loses its true residual with reduced-precision products.

Outputs: Joule heating q_J = 2 w^2 sigma (A_re^2 + A_im^2) (:1073-1086),
electric field E = i w A (:1088-1094), total Joule heating, coil current
and magnetic energy for the power control of the coupling; the
fields are tensors updated in place, the Joule heating and the
diagnostics in f64 whatever the solve's dtype.  Element-sharded solves
(`em/partitions > 1`) are not ported (ROADMAP A8).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ...constants import PI
from ...fem import h1, krylov
from ..base import Solver, register_solver


def em_mesh_from_ini(inp):
    """The EM mesh from the [em] section: an MFEM mesh file (em/mesh) or a
    generated box with coil-ring element attributes:

        [em]
        generator = box2d
        nx/ny, x0/x1/y0/y1      domain (r, z)
        ring1/center = r z      elements whose centroid lies within
        ring1/halfwidth = dr dz halfwidth of center get attribute 1+j

    Ring j gets element attribute 1+j (the reference's ring attributes
    2..5 carry current)."""
    gen = inp.get("em/generator", None)
    if gen is None:
        from ...mesh.mfem_reader import read_mesh

        return read_mesh(inp.get_required("em/mesh"))
    if gen != "box2d":
        raise ValueError(f"unknown em mesh generator '{gen}'")
    from ...mesh.generators import box_2d

    mesh = box_2d(
        inp.get("em/nx", 16), inp.get("em/ny", 16),
        x0=inp.get("em/x0", 0.0), x1=inp.get("em/x1", 1.0),
        y0=inp.get("em/y0", 0.0), y1=inp.get("em/y1", 1.0),
    )
    cent = mesh.vertices[mesh.elements].mean(axis=1)
    attrs = np.ones(mesh.num_elements, dtype=np.int64)
    j = 1
    while f"em/ring{j}/center" in inp.values:
        c = inp.get_vec(f"em/ring{j}/center", 2)
        hw = inp.get_vec(f"em/ring{j}/halfwidth", 2)
        inside = (np.abs(cent[:, 0] - c[0]) < hw[0]) & (
            np.abs(cent[:, 1] - c[1]) < hw[1])
        attrs[inside] = 1 + j
        j += 1
    mesh.elem_attrs = attrs
    return mesh


@contextlib.contextmanager
def full_precision():
    """TF32 off for the products of an EM solve (restored after)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])


class QuasiMagnetostaticSolverAxiSym(Solver):
    """Standalone axisymmetric EM solver ('em-axi' in the registry)."""

    def __init__(self, config, tps=None, mesh=None, device=None):
        super().__init__(config, tps)
        self._mesh_in = mesh
        if device is None:
            device = getattr(tps, "device", None) or "cuda"
        self.device = torch.device(device)

    def initialize(self):
        inp = self.config.raw if hasattr(self.config, "raw") else self.config
        if int(inp.get("em/partitions", 1) or 1) > 1:
            raise NotImplementedError(
                "an element-sharded EM solve (em/partitions > 1) is not "
                "ported to tps_torch yet (ROADMAP A8)")
        self.dtype = torch.get_default_dtype()
        dev = self.device
        kw = {"dtype": self.dtype, "device": dev}

        self.mesh = (self._mesh_in if self._mesh_in is not None
                     else em_mesh_from_ini(inp))
        self.tab_np = h1.build_h1(self.mesh, order=inp.get("em/order", 1))
        self.tab = self.tab_np.to_torch(self.dtype, dev)
        self._tab32 = None  # the f32 tables of the GMRES-IR cycles

        self.mu0 = inp.get("em/mu0", 1.25663706e-6)
        self.current_amplitude = inp.get("em/current_amplitude", 1.0)
        self.current_frequency = inp.get("em/current_frequency", 1.0)
        self.rtol = inp.get("em/rtol", 1e-10)
        # 0: pure relative (the rhs scale here is mu0 J ~ 1e-7)
        self.atol = inp.get("em/atol", 0.0)
        self.max_iter = inp.get("em/max_iter", 200)
        # background conductivity used only in the preconditioner
        # (reference: em/preconditioner_background_sigma,
        # src/quasimagnetostatic.cpp:439-443)
        self.pre_bg_sigma = inp.get("em/preconditioner_background_sigma", -1.0)
        top_only = bool(inp.get("em/top_only", 0))
        bot_only = bool(inp.get("em/bot_only", 0))

        # ring-current source by element attribute (attr 1 = no source;
        # attrs 2..5 = rings, reference InitializeCurrent)
        attrs = np.asarray(self.mesh.attributes())
        max_attr = int(attrs.max())
        J0 = np.zeros(max_attr + 1)
        mu0J = self.mu0 * self.current_amplitude * 0.5
        if max_attr >= 5:
            if bot_only:
                J0[2] = J0[3] = mu0J
            elif top_only:
                J0[4] = J0[5] = mu0J
            else:
                J0[2] = J0[3] = J0[4] = J0[5] = mu0J
        elif max_attr >= 2:
            J0[2:] = mu0J
        self._ring_attr = 2  # attr used for the coil current report

        # per-quad-point coefficient fields; the axis guard 1/max(r, 1e-14)
        # as a where on the divisor and the quotient (quadrature points are
        # interior, so it never binds)
        self.r_q = self.tab.xyz_q[..., 0]
        far = self.r_q > 1e-14
        self.inv_r_q = torch.where(
            far, 1.0 / torch.where(far, self.r_q, torch.ones_like(self.r_q)),
            torch.full_like(self.r_q, 1e14))
        self.J0_q = torch.as_tensor(J0[attrs], **kw)[:, None] \
            * torch.ones_like(self.r_q)

        # Dirichlet A = 0 on the whole boundary (reference ess_bdr)
        mask = np.ones(self.tab.ndofs)
        mask[h1.boundary_dofs(self.tab_np)] = 0.0
        self.mask = torch.as_tensor(mask, **kw)

        nd = self.tab.ndofs
        self.plasma_conductivity = torch.zeros(nd, **kw)
        self.A_re = torch.zeros(nd, **kw)
        self.A_im = torch.zeros(nd, **kw)
        # the Joule heating and its power control in f64 whatever the
        # solve's dtype (the reference's power control works in double):
        # an f32 field rescaled by ~100 sums to its target only to ~3e-8
        self.joule_heating = torch.zeros(nd, dtype=torch.float64, device=dev)
        self._joule_version = 0
        self._diag_key = None
        self._coil_current = None
        self.iter = 0
        self.time = 0.0

    @property
    def max_iters(self):
        return 1

    # ------------------------------------------------------------------
    def set_plasma_conductivity(self, sigma):
        self.plasma_conductivity.copy_(torch.as_tensor(
            sigma, dtype=self.dtype, device=self.device))

    def _K_apply(self, tab, v, r_q, inv_r_q):
        return h1.diffusion_apply(tab, v, r_q) + h1.mass_apply(tab, v, inv_r_q)

    def _block_apply(self, tab, mask, r_q, inv_r_q, msw_q):
        nd = tab.ndofs

        def apply(w):
            a_re = w[:nd] * mask
            a_im = w[nd:] * mask
            y_re = self._K_apply(tab, a_re, r_q, inv_r_q) \
                - h1.mass_apply(tab, a_im, msw_q)
            y_im = h1.mass_apply(tab, a_re, msw_q) \
                + self._K_apply(tab, a_im, r_q, inv_r_q)
            y_re = y_re * mask + w[:nd] * (1 - mask)
            y_im = y_im * mask + w[nd:] * (1 - mask)
            return torch.cat([y_re, y_im])

        return apply

    def _operands(self, sigma):
        """(omega, mu0 omega sigma r at quad points, the block apply, the
        right-hand side)."""
        tab = self.tab
        omega = 2.0 * PI * self.current_frequency
        msw_q = self.mu0 * omega * h1.to_quad(tab, sigma) * self.r_q
        apply = self._block_apply(tab, self.mask, self.r_q, self.inv_r_q,
                                  msw_q)
        # rhs: (v, J0 r) on the real block
        rhs_re = h1.mass_apply(tab, torch.ones_like(self.mask),
                               self.J0_q * self.r_q)
        b = torch.cat([rhs_re * self.mask, torch.zeros_like(rhs_re)])
        return omega, msw_q, apply, b

    def _solve_dense(self, msw_q, apply, b):
        """The dense Schur-complement solve with two refinement steps
        (small spaces): (a_re, a_im, relres)."""
        tab, mask, nd = self.tab, self.mask, self.tab.ndofs
        Ke = h1.element_stiffness(tab, self.r_q) \
            + h1.element_mass(tab, self.inv_r_q)
        Kd, Mm = h1.assemble_dense(
            tab, torch.stack([Ke, h1.element_mass(tab, msw_q)]))
        Kd = h1.dense_constrain(Kd, mask)
        Mm = Mm * (mask[:, None] * mask[None, :])
        Kinv = h1.direct_precond(h1.dense_cholesky(Kd))
        X = Kinv(Mm)  # K^-1 M
        S = Kd + Mm @ X
        Sinv = h1.direct_precond(h1.dense_cholesky(S))

        def schur_solve(r_re, r_im):
            t = Kinv(r_im)
            a_re = Sinv(r_re + Mm @ t)
            return a_re, t - X @ a_re

        a_re, a_im = schur_solve(b[:nd], torch.zeros_like(b[:nd]))
        # iterative refinement with the matrix-free residual
        for _ in range(2):
            r = b - apply(torch.cat([a_re, a_im]))
            d_re, d_im = schur_solve(r[:nd], r[nd:])
            a_re = a_re + d_re
            a_im = a_im + d_im
        res = torch.linalg.norm(b - apply(torch.cat([a_re, a_im])))
        # |b| = 0 (no current) reads 0: the JAX package's floor 1e-300 is
        # 0 in f32, where its 0/0 is NaN
        tiny = float(torch.finfo(b.dtype).tiny)
        relres = res / torch.clamp(torch.linalg.norm(b), min=tiny)
        return a_re, a_im, relres

    def _solve_gmres(self, omega, msw_q, apply, b):
        """Diagonally preconditioned GMRES(30), with f32 Arnoldi cycles
        under the f64 outer loop when the solve runs in f64:
        (a_re, a_im, iterations, relres)."""
        tab, mask, nd = self.tab, self.mask, self.tab.ndofs
        # diagonal preconditioner from K's diagonal (+ the optional
        # background-sigma mass term)
        kdiag = h1.stiffness_diag(tab, self.r_q) \
            + h1.mass_lumped_diag(tab, self.inv_r_q)
        if self.pre_bg_sigma > 0:
            kdiag = kdiag + h1.mass_lumped_diag(
                tab, self.mu0 * omega * self.pre_bg_sigma * self.r_q)
        kdiag = kdiag * mask + (1 - mask)
        dinv = 1.0 / torch.cat([kdiag, kdiag])
        cyc = {}
        if self.dtype == torch.float64:
            f32 = torch.float32
            if self._tab32 is None:
                self._tab32 = self.tab_np.to_torch(f32, self.device)
            apply32 = self._block_apply(
                self._tab32, mask.to(f32), self.r_q.to(f32),
                self.inv_r_q.to(f32), msw_q.to(f32))
            dinv32 = dinv.to(f32)
            cyc = dict(cycle_dtype=f32, cycle_apply=apply32,
                       cycle_M=lambda v: v * dinv32)
        w, iters, relres = krylov.gmres_solve(
            apply, b, tol=self.rtol, atol=self.atol, maxiter=self.max_iter,
            M=lambda x: x * dinv, restart=30, **cyc)
        return w[:nd] * mask, w[nd:] * mask, iters, relres

    def solve_step(self):
        """One frequency-domain solve from the current conductivity."""
        cuda = self.device.type == "cuda"
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        with full_precision():
            sigma = self.plasma_conductivity
            omega, msw_q, apply, b = self._operands(sigma)
            if h1.dense_capable(self.tab):
                a_re, a_im, relres = self._solve_dense(msw_q, apply, b)
                iters = 3
            else:
                a_re, a_im, iters, relres = self._solve_gmres(
                    omega, msw_q, apply, b)
            a_re = a_re * self.mask
            a_im = a_im * self.mask
            self.A_re.copy_(a_re)
            self.A_im.copy_(a_im)
            self.joule_heating.copy_(
                2.0 * omega ** 2 * sigma * (a_re ** 2 + a_im ** 2))
        if cuda:
            ev[1].record()
        # per-solve diagnostics (the reference prints its iteration counts
        # and residuals per EM solve, src/quasimagnetostatic.cpp:464-476)
        self.last_solve_relres = float(relres)  # the solve's one host read
        self.last_solve_ms = 1e3 * (time.perf_counter() - t0)
        self.last_solve_device_ms = (ev[0].elapsed_time(ev[1]) if cuda
                                     else None)
        self.last_solve_iters = int(iters)
        self.iter += 1

    def solve(self):
        self.solve_step()

    # -- diagnostics (reference :1186-1380) --------------------------------
    def electric_field(self):
        """E_theta = i w A: (E_re, E_im)."""
        omega = 2.0 * PI * self.current_frequency
        return -omega * self.A_im, omega * self.A_re

    def _diag_core(self):
        """Total Joule heating and magnetic energy in one pass ([2]); the
        quadrature sums in f64 whatever the solve's dtype (the reference
        sums in double)."""
        tab, f64 = self.tab, torch.float64
        w = tab.wdet.to(f64)
        r_q = self.r_q.to(f64)
        jq = h1.gather(tab, self.joule_heating) @ tab.BT.to(f64)
        tot_jh = torch.sum(w * jq * r_q)
        emag = 0.0
        for A in (self.A_re, self.A_im):
            g = h1.grad_at_dofs(tab, A)  # [nd, (r, z)]
            gq = torch.einsum("qd,ndi->nqi", tab.Bvol, h1.gather(tab, g))
            Aq = h1.to_quad(tab, A)
            Br = -gq[..., 1]
            Bz = gq[..., 0] + Aq * self.inv_r_q
            emag = emag + torch.sum(w * (Br ** 2 + Bz ** 2).to(f64) * r_q)
        return torch.stack([tot_jh, PI / self.mu0 * 0.5 * emag])

    def _diag_vals(self):
        """(total Joule heating, magnetic energy), read once per solve and
        per scaling of the heating."""
        key = (self.iter, self._joule_version)
        if self._diag_key != key:
            with full_precision():
                self._diag_cache = self._diag_core().tolist()
            self._diag_key = key
        return self._diag_cache

    def total_joule_heating(self):
        """int q_J r dr dz (reference totalJouleHeating)."""
        return self._diag_vals()[0]

    def magnetic_energy(self):
        """(pi/mu0) int [ (dA/dz)^2 + (1/r d(rA)/dr)^2 ] r dr dz over both
        phase components (time-averaged magnetic energy)."""
        return self._diag_vals()[1]

    def coil_current(self):
        """Area integral of I/2 over one ring (reference coilCurrent);
        geometry-constant, computed once."""
        if self._coil_current is None:
            tab = self.tab_np
            sel = (np.asarray(self.mesh.attributes())
                   == self._ring_attr).astype(np.float64)
            self._coil_current = float(
                np.sum(tab.wq[None, :] * tab.detJ * sel[:, None])
                * 0.5 * self.current_amplitude)
        return self._coil_current

    def scale_joule_heating(self, factor):
        self.joule_heating.mul_(factor)
        self._joule_version += 1


@register_solver("em-axi")
class _EmAxiFromConfig(QuasiMagnetostaticSolverAxiSym):
    pass
