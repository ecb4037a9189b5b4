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
  path runs it on every right-hand side.  Its pointwise physics is a
  policy of the kernel template, one `PHYSICS_ID` each (`face_physics`):
  DryAir (`kernel_phys`, csrc/face_sweep.cu); the two-temperature
  ambipolar ternary argon plasma with argon_minimal transport, 2-D or
  3-D, and on Euler any such ternary mixture (`mixture_phys`,
  csrc/dg_mixture.cuh in csrc/face_sweep_argon.cu); the ternary with
  constant transport (csrc/face_sweep_argon_const.cu) and the six-species
  argon with the per-pair collision-integral transport
  (csrc/face_sweep_gas_mixture.cu), both `gas_mixture_phys` of
  csrc/dg_gas_mixture.cuh; the LTE-table fluid, 2-D or 3-D, 1-D or 2-D
  tables, Navier-Stokes or Euler (`lte_phys`, csrc/dg_lte.cuh in
  csrc/face_sweep_lte.cu and csrc/face_sweep_lte3d.cu).  On axisymmetric
  (r, z) tables with swirl (nvel = 3) two of them, DryAir and the argon
  ternary (`argon` above, Navier-Stokes or Euler), run their axisymmetric
  instantiations (csrc/face_sweep_axi.cu, csrc/face_sweep_argon_axi.cu),
  which read each slot point's radius (xyz_slot[..., 0],
  `CudaFaceSweep.rad`, passed to the same C entry; null on planar
  tables).  DryAir also runs with the Roe flux in 2-D and 3-D
  (csrc/face_sweep_roe.cu).  DryAir and the argon ternary (planar and
  axisymmetric) take the viscous flux's closures, the mixing length,
  the Smagorinsky and Sigma SGS models and the planar viscous sponge
  (`closure_phys`, csrc/dg_pointwise.cuh::closure_step), whose per-point
  inputs are fixed for the run: each element's length scale and its
  neighbours', and each slot point's wall distance and sponge weight
  (the weight made once here with the plain PlanarViscousSponge).
- prototype (`build_prototype_sweep`): Euler, the prototype's own
  Rusanov (per side |u.n| + c|n|), the uniform normals wts*nor shared by
  every element, mask 1, sign +1; its plain version is
  `prototype_chain_plain`, the prototype's XLA chain.  Run by
  `python -m tps_torch.tools.face_prototype`.

The wrapper `CudaFaceSweep` launches the kernel for CUDA tensors and counts
the launch in `launches["face_sweep"]` and under its variant in
`variant_launches` (`VARIANTS`); for CPU tensors it runs its plain version
and nothing else.  There is no fallback from a CUDA tensor to the plain
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
from ..physics.tables import LinearTable, Table2D, _on
from .cuda_fused import (SHARED_LIMIT, _al4, _Library, build_kernels,
                         kernel_phys, kernel_transport, row_slot,
                         support_values, tile_plan)
from .operators import face_sweep_plain  # noqa: F401 (slot mode's plain version)

# the kernel's pointwise physics policies (csrc/face_sweep.cu's PHYSICS_*)
PHYSICS_ID = {"dry_air": 0, "argon": 1, "argon_const": 2, "gas_mixture": 3,
              "lte": 4, "dry_air_roe": 5}
# the LTE fluid's instantiations: lte_<dim>d, _t2 with 2-D (T, rho)
# tables, _euler on Euler
LTE_VARIANTS = tuple(f"lte_{dim}d{td}{eq}" for dim in (2, 3)
                     for td in ("", "_t2") for eq in ("", "_euler"))
# the axisymmetric (r, z) + swirl instantiations: DryAir (Navier-Stokes
# and Euler) and the argon ternary's Navier-Stokes and Euler forms
AXI_VARIANTS = ("dry_air_axi", "argon_axi", "argon_axi_euler")
# DryAir with the Roe flux, planar
ROE_VARIANTS = ("dry_air_roe_2d", "dry_air_roe_3d")
# the Navier-Stokes variants with the viscous flux's closures (the runtime
# branch of the same instantiations, counted apart): DryAir planar (Rusanov
# and Roe) and axisymmetric, the argon ternary planar and axisymmetric
CLOSURE_VARIANTS = tuple(f"{v}_closure" for v in (
    "dry_air_2d", "dry_air_3d", "dry_air_axi", "argon_2d", "argon_3d",
    "argon_axi") + ROE_VARIANTS)
# the instantiations, each counted on its own: DryAir; the argon plasma's
# Navier-Stokes in 2-D and 3-D and its Euler form; the constant-transport
# ternary; the six-species collision-integral mixture; the LTE fluid's;
# the axisymmetric ones; Roe; the closures'
VARIANTS = ("dry_air", "argon_2d", "argon_3d", "argon_euler", "argon_const",
            "gas_mixture") + LTE_VARIANTS + AXI_VARIANTS + ROE_VARIANTS \
    + CLOSURE_VARIANTS
# kernel launches since the last reset_launches(), and each variant's
launches = {"face_sweep": 0}
variant_launches = {v: 0 for v in VARIANTS}
# the species of the gas_mixture instantiation (face_sweep_gas_mixture.cu)
GAS_MIXTURE_NS = 6
# GasMixtureTransport's pair kinds -> csrc/dg_gas_mixture.cuh's KIND_*
PAIR_KIND = {"CLMB_ATT": 0, "CLMB_REP": 1, "AR_AR": 2, "AR_AR1P": 3,
             "AR_E": 4}


def reset_launches():
    for counts in (launches, variant_launches):
        for k in counts:
            counts[k] = 0


def molecular(transport):
    """The molecular transport under a mixing-length closure (or the
    transport itself)."""
    return getattr(transport, "molecular", transport)


def closures_on(ctx) -> bool:
    """Whether the viscous flux carries a closure: on Navier-Stokes, an
    SGS model, the viscous sponge or the mixing length."""
    fl = ctx.fluxes
    return fl.eq_system != "euler" and (
        fl.sgs_model is not None or fl.visc_sponge is not None
        or type(fl.transport).__name__ == "MixingLengthTransport")


def face_sweep_supported(tab_np, ctx) -> bool:
    """Preconditions of the kernel in slot mode: neighbor-slot tables,
    2-D or 3-D, single device, and one of its physics: DryAir, Euler or
    Navier-Stokes with Sutherland or constant transport; a mixture of
    `mixture_physics`; or the LTE fluid (`lte_table_dim`); one velocity
    per dimension, or, on axisymmetric (r, z) tables, the swirl state
    (nvel = 3) on DryAir or the `argon` mixture.  Rusanov everywhere, Roe
    on planar DryAir.  The closures (`closures_on`: the Smagorinsky or
    Sigma model, the viscous sponge, the mixing length) on DryAir and the
    `argon` mixture only.  Outside these (Roe on a mixture or the LTE
    fluid, the closures on argon_const, gas_mixture and the LTE fluid, the
    Wale model) the configuration runs on the CPU only (ROADMAP A6.5)."""
    t = tab_np
    if t.nbr_row is None or t.dim not in (2, 3):
        return False
    if ctx.axis_name is not None or ctx.use_bc_in_grad:
        return False
    fl = ctx.fluxes
    riemann = type(ctx.riemann).__name__
    if riemann not in ("Rusanov", "Roe"):
        return False
    if fl.eq_system not in ("euler", "navier-stokes"):
        return False
    mix = ctx.mixture
    if mix.dim != t.dim:
        return False
    closed = closures_on(ctx)
    if closed and fl.sgs_model is not None and type(
            fl.sgs_model).__name__ not in ("Smagorinsky", "Sigma"):
        return False
    kind = type(mix).__name__
    if kind == "DryAir":
        if mix.n_passive:
            return False
        tr = molecular(fl.transport)
        if fl.eq_system != "euler" and not kernel_transport(tr):
            return False
        # the kernel's constant transport carries kappa + kappa_e as one
        if closed and type(tr).__name__ == "ConstantTransport" \
                and tr.kappa_e != 0.0:
            return False
    elif riemann == "Roe":
        return False
    elif kind == "PerfectMixture":
        physics = mixture_physics(ctx, t.dim)
        if physics is None or (closed and physics != "argon"):
            return False
    elif kind == "LteMixture":
        if closed or lte_table_dim(ctx) is None:
            return False
    else:
        return False
    if fl.axisymmetric:
        return (t.dim == 2 and mix.nvel == 3 and t.xyz_slot is not None
                and riemann == "Rusanov"
                and (kind == "DryAir"
                     or mixture_physics(ctx, t.dim) == "argon"))
    return mix.nvel == t.dim


def mixture_physics(ctx, dim):
    """The kernel's policy for a species mixture, or None outside them:
    each is the two-temperature ambipolar mixture, and
      "argon": the ternary [Ar+, e, Ar] with argon_minimal transport in
        2-D or 3-D, and on Euler any such ternary (no transport);
      "argon_const": the ternary with ConstantPlasmaTransport, 2-D;
      "gas_mixture": GAS_MIXTURE_NS species (the ion first, neutral
        states, the electron, the background) with GasMixtureTransport on
        the argon pairs, 2-D."""
    mix, fl = ctx.mixture, ctx.fluxes
    if not (mix.ambipolar and mix.two_temperature):
        return None
    ns = mix.num_species
    if fl.eq_system == "euler":
        return "argon" if ns == 3 else None
    tr = molecular(fl.transport)
    kind = type(tr).__name__
    if kind == "ArgonMinimalTransport" and ns == 3:
        return "argon"
    if kind == "ConstantPlasmaTransport" and ns == 3 and dim == 2:
        return "argon_const"
    if (kind == "GasMixtureTransport" and ns == GAS_MIXTURE_NS and dim == 2
            and set(tr.pair_kinds.values()) <= set(PAIR_KIND)
            and mix.charges[0] > 0.0
            and all(mix.charges[i] == 0.0 for i in range(1, ns - 2))):
        return "gas_mixture"
    return None


def _lte_tables(ctx):
    """The LTE fluid's tables in csrc/dg_lte.cuh::LtePhys's order: e(T,
    rho), R, c, the T(e, rho) guess, mu, kappa (on Euler, where no
    transport is read, the energy table stands for mu and kappa)."""
    mix, tr = ctx.mixture, ctx.fluxes.transport
    visc = (tr.mu_table, tr.kappa_table) if tr is not None else (
        mix.energy_table,) * 2
    return (mix.energy_table, mix.R_table, mix.c_table, mix.T_table) + visc


def lte_table_dim(ctx):
    """1 or 2, the kind of every table of the LTE fluid (LinearTable or
    Table2D), or None outside the kernel's LTE policy: Navier-Stokes with
    LteTransport, or Euler; the tables all of one kind."""
    fl = ctx.fluxes
    if fl.eq_system != "euler" and type(fl.transport).__name__ != \
            "LteTransport":
        return None
    kinds = {type(t) for t in _lte_tables(ctx)}
    if kinds == {LinearTable}:
        return 1
    if kinds == {Table2D}:
        return 2
    return None


def lte_phys(ctx, dtype, device):
    """The LTE policy's constants (csrc/dg_lte.cuh::make_lte_phys): the
    table dim and the Newton count, then per table three device addresses
    and three ints.  The arrays are the tables' own device copies in
    dtype (physics/tables.py::_on, the plain version's), which the tables
    keep alive; their addresses go as doubles, exact below 2^53."""
    td = lte_table_dim(ctx)
    vals = [float(td), float(ctx.mixture.newton_iters)]
    key = (dtype, torch.device(device))
    for t in _lte_tables(ctx):
        if td == 1:
            arrs = _on(t._dev, key, t._coeffs())
            ints = (len(t.x), int(t.x_log), int(t.f_log))
        else:
            arrs = _on(t._dev, key, (t.x, t.y, t.f))
            ints = (len(t.x), len(t.y), 0)
        for a in arrs:
            if not a.is_contiguous() or a.data_ptr() >= 2**53:
                raise ValueError("an LTE table's device array cannot be "
                                 "passed to the face-sweep kernel")
            vals.append(float(a.data_ptr()))
        vals += [float(i) for i in ints]
    return vals


def variant(ctx, dim):
    """The instantiation (`VARIANTS`) the kernel runs for ctx: its base,
    and on Navier-Stokes with closures the base's `_closure` record."""
    base = _base_variant(ctx, dim)
    if not closures_on(ctx):
        return base
    if base == "dry_air":
        base = f"dry_air_{dim}d"
    return f"{base}_closure"


def _base_variant(ctx, dim):
    if type(ctx.riemann).__name__ == "Roe":
        return f"dry_air_roe_{dim}d"
    if ctx.fluxes.axisymmetric:
        if type(ctx.mixture).__name__ != "PerfectMixture":
            return "dry_air_axi"
        return ("argon_axi_euler" if ctx.fluxes.eq_system == "euler"
                else "argon_axi")
    if type(ctx.mixture).__name__ == "LteMixture":
        return (f"lte_{dim}d" + ("_t2" if lte_table_dim(ctx) == 2 else "")
                + ("_euler" if ctx.fluxes.eq_system == "euler" else ""))
    if type(ctx.mixture).__name__ != "PerfectMixture":
        return "dry_air"
    physics = mixture_physics(ctx, dim)
    if physics != "argon":
        return physics
    if ctx.fluxes.eq_system == "euler":
        return "argon_euler"
    return f"argon_{dim}d"


def mixture_phys(ctx):
    """The argon plasma's constants in the order of
    csrc/dg_mixture.cuh::MixPhys, every mass combination formed here in
    double (a product of two per-molecule masses is below float's range).
    On Euler (no transport) the transport's fields are argon_minimal's
    defaults, which the kernel does not read."""
    mix, tr = ctx.mixture, molecular(ctx.fluxes.transport)
    if type(tr).__name__ != "ArgonMinimalTransport":
        tr = gt.ArgonMinimalTransport(mixture=mix)
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


def gas_mixture_phys(ctx):
    """The constants of csrc/dg_gas_mixture.cuh::GasPhys for ctx's mixture
    (ConstantPlasmaTransport or GasMixtureTransport), in its order; every
    mass combination formed here in double.  The fields of the other
    transport are 0."""
    mix, tr = ctx.mixture, molecular(ctx.fluxes.transport)
    ns = mix.num_species
    R = UNIVERSAL_GAS_CONSTANT
    m = np.asarray(mix.mw) / AVOGADRO_NUMBER
    cv = [c * R for c in mix.molar_cv_over_R]
    vf, koe, dfac = (gt.VISCOSITY_FACTOR, gt.K_OVER_ETA_FACTOR,
                     gt.DIFFUSIVITY_FACTOR)
    if type(tr).__name__ == "ConstantPlasmaTransport":
        ctr = [tr.visc, tr.bulk_visc, tr.kappa, tr.kappa_e, *tr.diffusivity]
        kinds = [0.0] * (ns * ns)
        mults = [1.0] * 5 + [0.0]
    else:
        ctr = [0.0] * (4 + ns)
        kinds = [float(PAIR_KIND[tr.pair_kinds[(min(i, j), max(i, j))]])
                 for i in range(ns) for j in range(ns)]
        mults = [tr.visc_mult, tr.kappa_mult, tr.kappa_e_mult, tr.diff_mult,
                 tr.mobil_mult,
                 float(tr.third_order_electron_thermal_conductivity)]
    ie = mix.i_electron
    pair = [0.0 if i == j else dfac / np.sqrt(m[i] * m[j] / (m[i] + m[j]))
            for i in range(ns) for j in range(ns)]
    fits = [ci.SCREENED[f"{kind}{l}{r}"][k]
            for kind in ("att", "rep")
            for l, r in ((1, 1), (1, 2), (1, 3), (1, 4), (1, 5), (2, 2),
                         (2, 3), (2, 4))
            for k in range(4)]
    vals = [float(ns), *mix.mw, *mix.charges, *cv, *[c + R for c in cv],
            *mix.formation_energy, R, pm._TINY, gt._XEPS, *ctr,
            gt._DEBYE_FACTOR / AVOGADRO_NUMBER, 4.0 * PI * gt._DEBYE_FACTOR,
            PI, *[vf * np.sqrt(mi) for mi in m], *[koe / mi for mi in m],
            vf * koe * np.sqrt(2.0 / m[ie]), vf * koe * np.sqrt(1.0 / m[ie]),
            *pair, gt._QE_OVER_KB, *mults, *kinds, *fits,
            *ci.POWER_FITS["ArAr11"], *ci.POWER_FITS["ArAr22"],
            *ci.POWER_FITS["ArAr1P11"], *ci.EAR_COEFFS.reshape(-1)]
    return [float(v) for v in vals]


def closure_phys(ctx, tab):
    """The closures' constants (csrc/dg_pointwise.cuh::Closure): the SGS
    model (0 none, 1 Smagorinsky, 2 Sigma), its constant and floor, the
    mixing length's switch (on where the transport has one and the tables
    the slot points' wall distances), its largest length, Pr_t factor and
    bulk multiplier."""
    fl = ctx.fluxes
    model = fl.sgs_model
    sgs = {None: 0.0, "Smagorinsky": 1.0, "Sigma": 2.0}[
        None if model is None else type(model).__name__]
    ml = fl.transport if type(fl.transport).__name__ == \
        "MixingLengthTransport" and tab.dist_slot is not None else None
    return [sgs, float(getattr(model, "const", 0.0)),
            float(getattr(model, "floor", 0.0)), float(ml is not None),
            float(ml.max_mixing_length) if ml else 0.0,
            float(ml.Prt) if ml else 0.0, float(ml.bulk_mult) if ml else 0.0]


def face_physics(ctx, dim, dtype, device):
    """(physics, packed constants) of the kernel for ctx in dtype on
    device: "dry_air" or, with the Roe flux, "dry_air_roe"
    (cuda_fused.kernel_phys), "argon" (`mixture_phys`), "argon_const" or
    "gas_mixture" (`gas_mixture_phys`), "lte" (`lte_phys`)."""
    if type(ctx.mixture).__name__ == "LteMixture":
        return "lte", lte_phys(ctx, dtype, device)
    if type(ctx.mixture).__name__ != "PerfectMixture":
        roe = type(ctx.riemann).__name__ == "Roe"
        return "dry_air_roe" if roe else "dry_air", kernel_phys(ctx)
    physics = mixture_physics(ctx, dim)
    if physics == "argon":
        return physics, mixture_phys(ctx)
    return physics, gas_mixture_phys(ctx)


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
    physics: str  # a PHYSICS_ID key (`face_physics`)
    phys: object  # ctypes doubles: kernel_phys, mixture_phys,
    # gas_mixture_phys or lte_phys
    variant: str = "dry_air"  # its instantiation (`VARIANTS`)
    # the slot points' radii [ne, nlf, nqf] on axisymmetric tables (the
    # C entry then runs the axisymmetric policies), else None
    rad: torch.Tensor | None = None
    # the closures (None where the viscous flux has none): their constants
    # (ctypes doubles, `closure_phys`), the element length scales [ne]
    # and the neighbours' [ne, nlf] (with an SGS model), the sponge
    # weights and the wall distances of the slot points [ne, nlf, nqf]
    closure: object = None
    delta: torch.Tensor | None = None
    delta_nbr: torch.Tensor | None = None
    wgt: torch.Tensor | None = None
    dist: torch.Tensor | None = None

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
        def ptr(t):
            return None if t is None else t.data_ptr()

        with torch.cuda.device(X.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(X.data_ptr(), self.Btr_or.data_ptr(),
                     self.combo_face.data_ptr(), self.combo_perm.data_ptr(),
                     self.nbr_row.data_ptr(), self.nor.data_ptr(),
                     ptr(self.mask), ptr(self.rad), ptr(self.delta),
                     ptr(self.delta_nbr), ptr(self.wgt), ptr(self.dist),
                     Y.data_ptr(), self.ne, self.ndof, self.nqf, self.nlf,
                     self.n_combo, self.nor_lf, self.nor_e, self.sign,
                     self.dim, int(self.viscous), int(self.prototype),
                     PHYSICS_ID[self.physics], self.phys, self.closure,
                     stream)
        if err:
            raise RuntimeError(f"face_sweep launch failed: CUDA error {err}")
        launches["face_sweep"] += 1
        variant_launches[self.variant] += 1
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
                "runs with --device cpu (ROADMAP A6.5)")
        _check_cuda(tab, viscous, dtype, device, neq)
    # outside the preconditions (the CPU only) the plain version runs and
    # the kernel's constants are not needed
    physics, phys = (face_physics(ctx, tab.dim, dtype, device) if supported
                     else ("none", []))
    nlf, ne, nqf, dim = tab.nlf, tab.ne, tab.nqf, tab.dim
    rad = (tab.xyz_slot[..., 0].contiguous() if ctx.fluxes.axisymmetric
           else None)
    closure = {}
    if supported and closures_on(ctx):
        fl = ctx.fluxes
        cl = closure_phys(ctx, tab)
        closure = {"closure": (ctypes.c_double * len(cl))(*cl)}
        if fl.sgs_model is not None:
            closure["delta"] = tab.delta.contiguous()
            closure["delta_nbr"] = tab.delta_nbr.contiguous()
        if fl.visc_sponge is not None:
            # fixed for the run: made once with the plain version
            closure["wgt"] = fl.visc_sponge(tab.xyz_slot).contiguous()
        if cl[3]:
            closure["dist"] = tab.dist_slot.contiguous()
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
        variant=variant(ctx, dim) if supported else "none", rad=rad,
        **closure)


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
