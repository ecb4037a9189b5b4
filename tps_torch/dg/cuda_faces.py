"""The DG face sweep as a hand-written CUDA kernel (Hopper), and its plain
PyTorch versions.

csrc/face_sweep.cu replaces the JAX package's Pallas TPU kernel `kernel`
of tools/pallas_face_prototype.py (a fused Euler face sweep on a periodic
box: traces, roll neighbours, Rusanov, weighted transpose) and, with the
same code, computes the interior face sweep of the general (slot) path,
dg/rhs.py:143-178 of the JAX package.  For each element e

    z_e = sign * sum_lf Btr_or[lf]^T mask[e,lf] F(tr_own, tr_nbr, n[e,lf])

on X = [U | G] [ne, ndof, k], with the neighbour (e', combo) decoded from
nbr_row (see the .cu file).  The kernel keeps only the nlf identity trace
blocks in shared memory: combo c's rows are face block combo_face[c]'s
rows in the order combo_perm[c] (`combo_tables`, derived once from
Btr_or).  Its block owns a tile of elements (`plan`, the kernel's own
csrc/face_sweep.cu::face_plan).  Two modes:

- slot (`build_face_sweep`): the package Rusanov minus the mean one-sided
  viscous normal flux, normals nor_wpf, mask interior_mask, sign -1; its
  plain version is dg/operators.py's `face_sweep_plain`.  The solver's slot
  path runs it on every right-hand side.  Its pointwise physics is DryAir
  (`kernel_phys`, csrc/face_sweep.cu) or the two-temperature ambipolar
  argon plasma (`mixture_phys`, csrc/dg_mixture.cuh in
  csrc/face_sweep_argon.cu).
- prototype (`build_prototype_sweep`): Euler, the prototype's own
  Rusanov (per side |u.n| + c|n|), the uniform normals wts*nor shared by
  every element, mask 1, sign +1; its plain version is
  `prototype_chain_plain`, the prototype's XLA chain.  Run by
  `python -m tps_torch.tools.face_prototype`.

The wrapper `CudaFaceSweep` launches the kernel for CUDA tensors and counts
the launch in `launches`; for CPU tensors it runs its plain version and
nothing else.  There is no fallback from a CUDA tensor to the plain
version: a missing compiler, a failed build, a configuration outside
`face_sweep_supported` or a refused launch raises.  The kernel is built
with K1/K2 by dg/cuda_fused.py::build_kernels, on first use.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import AVOGADRO_NUMBER, PI, UNIVERSAL_GAS_CONSTANT
from ..physics import collision_integrals as ci
from ..physics import gas_transport as gt
from ..physics import perfect_mixture as pm
from .cuda_fused import (SHARED_LIMIT, _al4, _Library, build_kernels,
                         kernel_phys, kernel_transport, row_slot,
                         support_values, tile_plan)
from .operators import face_sweep_plain  # noqa: F401 (slot mode's plain version)

# kernel launches since the last reset_launches()
launches = {"face_sweep": 0}
# the kernel's pointwise physics (csrc/face_sweep.cu's PHYSICS_*)
PHYSICS_ID = {"dry_air": 0, "argon": 1}


def reset_launches():
    for k in launches:
        launches[k] = 0


def face_sweep_supported(tab_np, ctx) -> bool:
    """Preconditions of the kernel in slot mode: neighbor-slot tables,
    2-D or 3-D, one velocity per dimension, Rusanov, planar, single
    device, and one of its two physics: DryAir, Euler or Navier-Stokes
    with Sutherland or constant transport; or the argon plasma in 2-D
    (`argon_supported`)."""
    t = tab_np
    if t.nbr_row is None or t.dim not in (2, 3):
        return False
    if ctx.axis_name is not None or ctx.use_bc_in_grad:
        return False
    fl = ctx.fluxes
    if fl.axisymmetric or fl.sgs_model is not None or fl.visc_sponge is not None:
        return False
    if type(ctx.riemann).__name__ != "Rusanov":
        return False
    if fl.eq_system not in ("euler", "navier-stokes"):
        return False
    mix = ctx.mixture
    if mix.nvel != t.dim:
        return False
    if type(mix).__name__ == "PerfectMixture":
        return t.dim == 2 and argon_supported(ctx)
    if type(mix).__name__ != "DryAir" or mix.n_passive:
        return False
    return fl.eq_system == "euler" or kernel_transport(fl.transport)


def argon_supported(ctx) -> bool:
    """The argon plasma the kernel computes (csrc/dg_mixture.cuh): the
    ternary [Ar+, e, Ar] perfect mixture, ambipolar, two temperatures,
    Navier-Stokes with argon_minimal transport (csrc/face_sweep_argon.cu
    builds it for 2-D only)."""
    mix, fl = ctx.mixture, ctx.fluxes
    return (fl.eq_system == "navier-stokes"
            and type(fl.transport).__name__ == "ArgonMinimalTransport"
            and mix.num_species == 3 and mix.ambipolar
            and mix.two_temperature)


def mixture_phys(ctx):
    """The argon plasma's constants in the order of
    csrc/dg_mixture.cuh::MixPhys, every mass combination formed here in
    double (a product of two per-molecule masses is below float's range)."""
    mix, tr = ctx.mixture, ctx.fluxes.transport
    R = UNIVERSAL_GAS_CONSTANT
    m = tr.masses()
    cv = [c * R for c in mix.molar_cv_over_R]
    sqrt = np.sqrt
    vf, koe, dfac = (gt.VISCOSITY_FACTOR, gt.K_OVER_ETA_FACTOR,
                     gt.DIFFUSIVITY_FACTOR)
    screened = [ci.SCREENED[k] for k in ("rep22", "rep23", "rep24", "att11",
                                         "att12", "att13", "att14", "att15")]
    vals = [*mix.mw, *mix.charges, *cv, *[c + R for c in cv],
            mix.formation_energy[0], R,
            float(mix.ambipolar), float(mix.two_temperature),
            gt._DEBYE_FACTOR / AVOGADRO_NUMBER, 4.0 * PI * gt._DEBYE_FACTOR,
            PI, gt._XEPS, pm._TINY,
            vf * sqrt(m[0]), vf * sqrt(m[2]), koe / m[0], koe / m[2],
            vf * koe * sqrt(2.0 / m[1]), vf * koe * sqrt(1.0 / m[1]),
            dfac / sqrt(tr.muw(1, 2)), dfac / sqrt(tr.muw(2, 0)),
            dfac / sqrt(tr.muw(0, 1)),
            gt._QE_OVER_KB,
            tr.visc_mult, tr.kappa_mult, tr.kappa_e_mult, tr.diff_mult,
            tr.mobil_mult,
            float(tr.third_order_electron_thermal_conductivity),
            *[v for q in screened for v in q],
            *ci.POWER_FITS["ArAr22"], *ci.POWER_FITS["ArAr1P11"],
            *ci.EAR_COEFFS.reshape(-1)]
    return [float(v) for v in vals]


def face_physics(ctx):
    """(physics, packed constants) of the kernel for ctx: "dry_air"
    (cuda_fused.kernel_phys) or "argon" (`mixture_phys`)."""
    if type(ctx.mixture).__name__ == "PerfectMixture":
        return "argon", mixture_phys(ctx)
    return "dry_air", kernel_phys(ctx)


def plan(ndof, nqf, nlf, k, neq, dtype):
    """(elements per block, trace blocks resident, shared bytes) of the
    kernel (csrc/face_sweep.cu::face_plan): the faces' supports, the nlf
    trace blocks per node if resident, the tile's states and two
    neighbour buffers (row slots; the second also stages the blocks),
    both traces, the flux and the accumulator.  Elements 0: the shape does
    not fit."""
    size = torch.empty((), dtype=dtype).element_size()

    def nbytes(E, res):
        nb = E * row_slot(ndof * k, size)
        v = support_values(nlf, ndof, size)
        v += _al4(nlf * ndof * _al4(nqf)) if res else 0
        v += _al4(E * ndof * k) + nb + _al4(max(nb, nlf * nqf * ndof if res else 0))
        v += 2 * _al4(E * nqf * k)
        v += _al4(E * (nqf * neq + 1)) + _al4(E * ndof * neq)
        return v * size

    return tile_plan(nbytes)


def combo_tables(Btr_or, nlf, nqf):
    """(combo_face [n_combo], combo_perm [n_combo, nqf]) int32 numpy with
    Btr_or[c*nqf + combo_perm[c, s]] == Btr_or[combo_face[c]*nqf + s]
    exactly: every combo is one of the nlf identity blocks that lead Btr_or
    (dg/discretization.py's oriented traces) with its points reordered,
    point s landing at combo_perm[c, s].  Raises if a combo is not."""
    B = np.asarray(Btr_or)
    blocks = B.reshape(-1, nqf, B.shape[-1])
    n_combo = blocks.shape[0]
    face = np.zeros(n_combo, np.int32)
    perm = np.zeros((n_combo, nqf), np.int32)
    for c in range(n_combo):
        for lf in range(nlf):
            eq = np.all(blocks[c][:, None, :] == blocks[lf][None, :, :], -1)
            pc = np.argmax(eq, 1)
            if eq.any(1).all() and np.array_equal(np.sort(pc), np.arange(nqf)):
                face[c], perm[c] = lf, np.argsort(pc)
                break
        else:
            raise ValueError(f"combo {c} of Btr_or is no point permutation "
                             f"of a face block")
    return face, perm


# ---------------------------------------------------------------- plain


def prototype_rusanov(U1, U2, n, gamma):
    """The prototype's Rusanov (tools/pallas_face_prototype.py:57-77):
    per side |u.n| + c |n|, the max over the sides.  n [..., 3] scaled."""
    def flux(Uv):
        rho, mom, E = Uv[..., 0], Uv[..., 1:4], Uv[..., 4]
        vel = mom / rho[..., None]
        p = (gamma - 1) * (E - 0.5 * torch.sum(mom * vel, -1))
        un = torch.sum(vel * n, -1)
        F = torch.cat([torch.sum(mom * n, -1)[..., None],
                       mom * un[..., None] + p[..., None] * n,
                       ((E + p) * un)[..., None]], -1)
        c = torch.sqrt(gamma * p / rho) * torch.linalg.norm(n, dim=-1)
        return F, torch.abs(un) + c

    F1, s1 = flux(U1)
    F2, s2 = flux(U2)
    s = torch.maximum(s1, s2)
    return 0.5 * (F1 + F2) - 0.5 * s[..., None] * (U2 - U1)


def prototype_chain_plain(U, Btr, nor, wts, roll_info, gamma=1.4):
    """The prototype's XLA chain (tools/pallas_face_prototype.py:81-93):
    traces through Btr, neighbours by grid rolls of the opposite face,
    its Rusanov, times the face weights, scattered through Btr^T.
    U [ne, ndof, 5]; Btr [nlf*nqf, ndof]; nor [nlf, nqf, 3] and wts
    [nlf, nqf] shared by every element -> z [ne, ndof, 5] (+sum, no Minv)."""
    grid, per_lf = roll_info
    ne, _ndof, neq = U.shape
    nlf, nqf = wts.shape
    tr = torch.einsum("fd,ndk->nfk", Btr, U).reshape(ne, nlf, nqf, neq)
    og = tr.reshape(tuple(grid) + (nlf, nqf, neq))
    nbr = torch.stack([torch.roll(og[..., opp, :, :], shifts=shift, dims=axis)
                       for (axis, shift, opp) in per_lf], dim=-3)
    f = prototype_rusanov(tr, nbr.reshape(ne, nlf, nqf, neq), nor[None], gamma)
    return torch.einsum("fd,nfk->ndk", Btr,
                        (f * wts[None, ..., None]).reshape(ne, nlf * nqf, neq))


# ---------------------------------------------------------------- wrapper


@dataclass(frozen=True, eq=False)
class CudaFaceSweep:
    """X [ne, ndof, k] -> [ne, ndof, neq]: the kernel for CUDA tensors,
    `plain` for CPU tensors."""

    plain: object  # X -> [ne, ndof, neq]
    Btr_or: torch.Tensor  # [n_combo*nqf, ndof]
    combo_face: torch.Tensor  # [n_combo] int32
    combo_perm: torch.Tensor  # [n_combo, nqf] int32
    nbr_row: torch.Tensor  # [ne, nlf] int32
    nor: torch.Tensor  # normals, element stride nor_e, face stride nor_lf
    mask: torch.Tensor | None  # [ne, nlf] (None: every slot interior)
    ne: int
    ndof: int
    nqf: int
    nlf: int
    n_combo: int
    dim: int
    neq: int
    viscous: bool
    prototype: bool
    nor_lf: int
    nor_e: int
    sign: float
    physics: str  # "dry_air" or "argon" (`face_physics`)
    phys: object  # ctypes doubles: kernel_phys or mixture_phys

    @property
    def k(self):
        return self.neq * (1 + self.dim) if self.viscous else self.neq

    def __call__(self, X):
        if not X.is_cuda:
            return self.plain(X)
        shape = (self.ne, self.ndof, self.k)
        ref = self.Btr_or
        if X.device != ref.device or X.dtype != ref.dtype:
            raise ValueError(f"X: expected {ref.dtype} on {ref.device}, got "
                             f"{X.dtype} on {X.device}")
        if tuple(X.shape) != shape or not X.is_contiguous():
            raise ValueError(f"X: expected a contiguous {shape} tensor, got "
                             f"{tuple(X.shape)}")
        build_kernels()
        suffix = "f64" if X.dtype == torch.float64 else "f32"
        fn = getattr(_Library.lib, f"tps_face_sweep_{suffix}")
        Y = torch.empty((self.ne, self.ndof, self.neq), dtype=X.dtype,
                        device=X.device)
        with torch.cuda.device(X.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(X.data_ptr(), self.Btr_or.data_ptr(),
                     self.combo_face.data_ptr(), self.combo_perm.data_ptr(),
                     self.nbr_row.data_ptr(), self.nor.data_ptr(),
                     None if self.mask is None else self.mask.data_ptr(),
                     Y.data_ptr(), self.ne, self.ndof, self.nqf, self.nlf,
                     self.n_combo, self.nor_lf, self.nor_e, self.sign,
                     self.dim, int(self.viscous), int(self.prototype),
                     PHYSICS_ID[self.physics], self.phys, stream)
        if err:
            raise RuntimeError(f"face_sweep launch failed: CUDA error {err}")
        launches["face_sweep"] += 1
        return Y


def _check_cuda(tab, viscous, dtype, device, neq=None):
    """Raise for CUDA tables whose element does not fit a block (neq:
    DryAir's dim + 2 where not given)."""
    if torch.device(device).type != "cuda":
        return
    neq = tab.dim + 2 if neq is None else neq
    k = neq * (1 + tab.dim) if viscous else neq
    tile, _res, smem = plan(tab.ndof, tab.nqf, tab.nlf, k, neq, dtype)
    if not tile:
        raise ValueError(f"ndof={tab.ndof}, nqf={tab.nqf}, k={k} needs {smem} "
                         f"B of shared memory for one element in {dtype}; "
                         f"the face sweep kernel's block takes {SHARED_LIMIT}")


def _combo_tensors(Btr_or, nlf, nqf, device):
    face, perm = combo_tables(Btr_or, nlf, nqf)
    return (torch.as_tensor(face, device=device),
            torch.as_tensor(perm, device=device).contiguous())


def build_face_sweep(tab, ctx) -> CudaFaceSweep:
    """The slot-mode sweep on the torch tables `tab` (their dtype and
    device).  Raises for CUDA tables outside `face_sweep_supported`."""
    device, dtype = tab.Btr_or.device, tab.Btr_or.dtype
    viscous = ctx.fluxes.eq_system != "euler"
    neq = ctx.mixture.num_equations
    supported = face_sweep_supported(tab, ctx)
    if device.type == "cuda":
        if not supported:
            raise NotImplementedError(
                "the face-sweep kernel's preconditions do not hold (see "
                "dg/cuda_faces.py::face_sweep_supported); this configuration "
                "runs with --device cpu")
        _check_cuda(tab, viscous, dtype, device, neq)
    # outside the preconditions (the CPU only) the plain version runs and
    # the kernel's constants are not needed
    physics, phys = face_physics(ctx) if supported else ("none", [])
    nlf, ne, nqf, dim = tab.nlf, tab.ne, tab.nqf, tab.dim
    cface, cperm = _combo_tensors(tab.Btr_or.cpu().numpy(), nlf, nqf, device)
    return CudaFaceSweep(
        plain=functools.partial(face_sweep_plain, ctx, tab),
        Btr_or=tab.Btr_or.contiguous(), combo_face=cface, combo_perm=cperm,
        nbr_row=tab.nbr_row.to(torch.int32).contiguous(),
        nor=tab.nor_wpf.contiguous(),
        mask=tab.interior_mask.contiguous(),
        ne=ne, ndof=tab.ndof, nqf=nqf, nlf=nlf, n_combo=tab.n_combo, dim=dim,
        neq=neq, viscous=viscous, prototype=False,
        nor_lf=ne * nqf * dim, nor_e=nqf * dim, sign=-1.0, physics=physics,
        phys=(ctypes.c_double * len(phys))(*phys),
    )


def build_prototype_sweep(tab_np, dtype, device, gamma=1.4) -> CudaFaceSweep:
    """The prototype-mode sweep on a periodic 3-D box's numpy tables, in
    dtype on device: Euler, gamma 1.4 (the prototype's GAM), one set of
    face normals and weights for every element (nor_slot[0],
    wts_slot[0])."""
    t = tab_np
    if t.dim != 3 or t.roll_info is None or t.nfb:
        raise ValueError("prototype mode needs a periodic 3-D box")

    def dev(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

    nor, wts = dev(t.nor_slot[0]), dev(t.wts_slot[0])  # [nlf, nqf, 3], [nlf, nqf]
    _check_cuda(t, False, dtype, device)
    cface, cperm = _combo_tensors(t.Btr_or, t.nlf, t.nqf, device)
    return CudaFaceSweep(
        plain=functools.partial(prototype_chain_plain, Btr=dev(t.Btr),
                                nor=nor, wts=wts, roll_info=t.roll_info,
                                gamma=gamma),
        Btr_or=dev(t.Btr_or), combo_face=cface, combo_perm=cperm,
        nbr_row=dev(t.nbr_row, torch.int32),
        nor=(wts[..., None] * nor).contiguous(), mask=None,
        ne=t.ne, ndof=t.ndof, nqf=t.nqf, nlf=t.nlf, n_combo=t.n_combo, dim=3,
        neq=5, viscous=False, prototype=True, nor_lf=t.nqf * 3, nor_e=0,
        sign=1.0, physics="dry_air",
        phys=(ctypes.c_double * 10)(gamma, 1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0,
                                    0.0, 0.0),
    )
