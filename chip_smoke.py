"""GPU smoke test of tps_torch: builds the CUDA kernels, checks each against
its plain PyTorch version, drives the solvers' CLI on the compressible and
low-Mach decks, checks the solver against plain RK4 loops, its step graph
against eager steps and its checkpoints against straight runs, and times
kernels, right-hand sides, steps through solve() and checkpoint I/O.

    python3 chip_smoke.py

The kernels: K1/K2 (dg/cuda_fused.py, the fused periodic path) and the
face sweep (dg/cuda_faces.py, the general slot path and the face-sweep
prototype).  The two main paths, each driven through the CLI with the
launch counts set to 0 just before it and read just after:
  - the fused path: the flagship deck with the collocated Gauss-Legendre
    basis (basisType = 0, integrationRule = 0 added), K1 + K2;
  - the slot path: examples/cases/vortex3d_ns.ini as shipped (the
    reference-default Gauss-Lobatto basis), the face sweep;
  - the cylinder: examples/cases/cyl2d_ogrid.ini as shipped (curved
    O-grid, isothermal wall, far field, checkpoint every 100 steps,
    ParaView output), the face sweep on curved elements;
  - the argon plasma: examples/cases/argon_plasma_2d.ini as shipped (2-D
    periodic 6x6 p=1 GLL, the two-temperature ambipolar Ar/Ar+/e mixture
    with collision-integral transport and chemistry), the face sweep on
    the mixture.
Each runs solve()'s chunked loop, each step a replay of the solver's
captured CUDA graph (tps_torch/solvers/step_graph.py); each kernel of a
path must count 4 launches a step (RK4), those of the other path none.
The low-Mach path (phases 21-24; no hand-written kernel: its H1 operators,
CG and dense Cholesky are plain PyTorch on the card, as the JAX package's
are XLA): the H1 operators and CG against the CPU, the shipped decks
tests/inputs/lomach_tgv2d.ini and examples/cases/channel_rans.ini through
the CLI (each constant-order step replayed as CUDA graphs, its CG solves
in blocks, tps_torch/solvers/lomach/step_graph.py) and against the CPU in
f64, graph against eager steps, and ms/step.  The coupled plasma torch
(phases 25-28; no hand-written kernel either): its modules (the LTE
tables, the radius-weighted H1 applies, the EM block apply, the dense
Schur and GMRES solves, the cross-mesh interpolator) against the CPU,
examples/cases/torch_axisym_coupled.ini through the CLI and against the
CPU in f64, graph against eager steps across an EM update, and ms/step
through the coupled solve() on that deck and a refined one.  The reacting
low-Mach plasma (phases 29-33; no hand-written kernel either): its
modules (transport, reaction source, species closure, conductivity,
tabulated rates, the sponge, the Gaussian interpolation of external data,
one ReactingFlow step) against the CPU, tps_torch/tools/lomach_reacting.ini
(bench.py's bench_lomach_reacting deck) through the CLI and against the
CPU in f64, graph against eager steps across a dense refresh and inside
an interpolated inlet's ramp, the reacting thermo under the Joule
coupling, and ms/step on the deck.  The compressible argon plasma
(phases 34-37): the face sweep's mixture variants (the ternary in 3-D and
on Euler, with constant transport, the six-species mixture with the
per-pair transport) against their plain versions; the coupled channel
tps_torch/tools/argon_channel_coupled.ini through the CLI (its 2-D argon
sweep 4 times a step), then in f64 on the card against the CPU and graph
against eager steps across an EM update; each variant's deck, argon_full.ini
and argon_inflow_outflow.ini through the CLI, the last two at 64x64 p=2
against plain loops; ms/step on the channel and on argon_full at 64x64.
The LTE-table plasma (phases 38-40): the face sweep's eight LTE variants
(2-D and 3-D, 1-D and 2-D tables, Navier-Stokes and Euler) against their
plain versions and each on its path through the CLI;
tps_torch/tools/lte_channel_coupled.ini through the CLI (its 2-D LTE sweep
4 times a step), graph against eager steps and the card against the CPU
in f64 across an EM update, ms/step; its f64 checkpoint converted by the
LTE restart into argon_full.ini's six-species state on the card and on
the CPU, then continued on the card.  The axisymmetric (r, z) flow with
swirl (phases 41-43): the face sweep's axisymmetric variants (DryAir on
Navier-Stokes and Euler, the argon ternary on both) against their plain
versions at 64x64 p=2; tps_torch/tools/argon_torch_axisym.ini (the
compressible argon torch on the axis under the Joule coupling) through the
CLI in f32 and f64 (its argon_axi sweep 4 times a step), graph against
eager steps and the card against the CPU in f64, ms/step, and on Euler;
tps_torch/tools/axisym_pipe.ini at 32x128 p=2 against a plain RK3 loop
(its dry_air_axi sweep 3 times a step).  Roe and the closures (phases
44-46): every closure and Roe variant against its plain version, each
variant's path, argon_torch_axisym_ml.ini and les_channel3d.ini through
the CLI.  The forcings and the manufactured solutions (phases 47-50; no
kernel of their own: plain PyTorch inside the captured step, the decks on
the face sweep): the MMS decks tests/inputs/mms.{euler,cns}.2d.quad.ini at
full width through tps_torch/tools/compute_rhs.py in f64 against the
reference's brackets; the 3-D transient MASA rates; each forcing alone
and all together (pressure gradient, heat source, planar and annulus
sponges with userDef and mixedOut targets, the MMS sources, the argon
deck's two-temperature sponge), graph against eager against the CPU;
tps_torch/tools/forced_channel3d.ini through the CLI in f32 and f64 (its
dry_air sweep 4 times a step), graph against eager and the card against
the CPU in f64, its sweep against plain, ms/step.  The port's longest
CPU runs, those of phases 22, 26, 30, 35, 42, 45 and 50 that the card is
held against, run in one worker process (CpuRefs) from the end of the
build, beside the phases before them; it is stopped on every exit.

Needs one CUDA GPU (sm_90a: the kernels are built for Hopper) and nvcc.
Fails (non-zero exit, no result line) without CUDA, when a kernel does not
build or launch, when any comparison misses its tolerance, or when a CLI
run did not launch its kernels or did not step through the graph.  The
last stdout line is {"ok": true, "device": {...}}; the line before it the
card's name and power limit; the one before that the kernels' JSON
record.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
from concurrent.futures import ThreadPoolExecutor
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import torch

from tps_torch.tools.face_prototype import cuda_ms

REPO = os.path.dirname(os.path.abspath(__file__))
DECK = os.path.join(REPO, "examples", "cases", "vortex3d_ns.ini")
CYL_DECK = os.path.join(REPO, "examples", "cases", "cyl2d_ogrid.ini")
ARGON_DECK = os.path.join(REPO, "examples", "cases", "argon_plasma_2d.ini")
ARGON_GOLDEN = os.path.join(REPO, "tests", "ref_solns",
                            "argon_minimal.4iters.h5")

# kernel vs plain version, relative to max|plain|: the two sum the same
# products in another order.  In f64 that is rounding (1e-11).  In f32 the
# RHS is a small difference of O(p/h) terms (the uniform pressure's volume
# and face terms cancel), so either order carries ~1e-4 of noise relative
# to max|y| at p=3; an f32 case therefore passes when it is within 5e-5 of
# the plain version OR no farther than twice the plain version's own
# distance from the f64 plain result on the same input.
TOL = {torch.float64: 1e-11, torch.float32: 5e-5}
# K1 in f64 against the dense plain gradient: the compressed folds drop
# entries of at most ~1e-14 of their fold, so K1 is held tighter
K1_TOL_F64 = 1e-12
MCS_TOL_F64 = 1e-12
FREESTREAM_TOL = 1e-5  # f32, 100 RK4 steps from a uniform state
SOLVER_TOL = 1e-10  # f64, 20 fixed-dt steps, kernels vs plain RK4 loop
# f64, the step graph against eager steps: the same kernels on the same
# inputs, so equal up to the order of atomics (none on these paths); a
# restarted run against a straight one: the checkpoint holds every bit
GRAPH_TOL = 1e-12
RESTART_TOL = 1e-12
PROTO_TOL = 1e-5  # the face-sweep prototype's own bar (f32)
# the argon deck's checkpoint after 4 steps against the committed golden:
# tests/test_statistics_restart.py:183-186's soln_differ flags (absolute
# on rho and the momenta, relative on rho-E and the species)
GOLDEN_TOL = {"density": (2e-10, False), "x-mom": (2e-8, False),
              "y-mom": (2e-8, False), "rho-E": (1e-11, True),
              "rho-Y_Ar.+1": (1e-9, True)}
GLL = dict(basis="gauss-lobatto", quad_rule="gauss-lobatto")

# the least time the card could take (bound_ms): NVIDIA H100 SXM peaks
# (data sheet, 700 W): f32 / f64 outside the tensor cores, HBM3 bandwidth
PEAK_OPS = {torch.float32: 67e12, torch.float64: 34e12}
PEAK_BYTES = 3.35e12
# pointwise operations per point, counted from csrc/dg_pointwise.cuh (each
# multiply, add, division and square root one operation): the face flux
# (Rusanov of both sides, plus for NS the two one-sided viscous fluxes),
# K2's volume flux, K1's primitives
FACE_OPS = {"euler": 105, "navier-stokes": 280}
# the argon plasma's face flux per point in 2-D, counted the same way from
# csrc/dg_mixture.cuh (a comparison, pow, log and log1p one operation
# each): per side the convective flux with |u| + c (67) and the viscous
# flux with the collision-integral transport (563: state 37, the
# third-order electron conductivity 200, the ambipolar diffusion
# velocities 136), per point the Rusanov combination and the viscous mean
# (55)
MIX_FACE_OPS = 2 * (67 + 563) + 55
# 2-D: the same counts scaled by the equations (4 of 5), an estimate
VOLUME_OPS = 125
PRIM_OPS = 12


def log(*a):
    print(*a, flush=True)


def _numpy(x):
    """x's tensors as numpy arrays (a worker's result crosses by value)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_numpy(v) for v in x)
    return x


def _tensors(x):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    if isinstance(x, dict):
        return {k: _tensors(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_tensors(v) for v in x)
    return x


def _cpu_worker_init(log_path, threads):
    torch.set_num_threads(threads)
    sys.stdout = sys.stderr = open(log_path, "a", buffering=1)


def _cpu_run(fn, args):
    return _numpy(fn(*args, device="cpu"))


class CpuRefs:
    """The port's CPU runs that phases 22, 26, 30, 35, 42, 45, 49, 50 and
    52 hold their card runs against (in f64 at the decks' size; the coupled
    channel's takes ~3 s a step on 8 cores): one worker process runs them
    while the card works through the phases before them, so the same runs
    and checks leave the main line.  Started once the kernels are built;
    its output goes to build/cpu_references.log; leaving its `with` block
    stops it."""

    THREADS = 2  # of the host's 8 cores: the rest drive the card

    def __init__(self):
        self.pool, self.jobs = None, {}

    def start(self):
        self.pool = multiprocessing.get_context("spawn").Pool(
            1, initializer=_cpu_worker_init,
            initargs=(os.path.join(REPO, "build", "cpu_references.log"),
                      self.THREADS))
        for key, fn, args in (("lomach tgv", lomach_f64_run, ("tgv",)),
                              ("lomach channel", lomach_f64_run,
                               ("channel",)),
                              ("coupled", coupled_f64_run, ()),
                              ("reacting", reacting_f64_run, ()),
                              ("channel", channel_f64_run, ("cpu",)),
                              ("torch_axi", axi_f64_run,
                               (TORCH_AXI_DECK, "torch_axi")),
                              ("torch_ml", axi_f64_run,
                               (ML_DECK, "torch_ml")),
                              ("lte_axi", axi_f64_run,
                               (lte_axi_deck("lte_axi"), "lte_axi")),
                              ("forced cut", forced_cut_run, ()),
                              *((f"forcing {i}", forcing_case_run, (i,))
                                for i in range(len(forcing_cases())))):
            self.jobs[key] = self.pool.apply_async(_cpu_run, (fn, args))

    def get(self, key):
        """The run's result; waits for it (an error in the worker raises
        here)."""
        t0 = time.perf_counter()
        res = _tensors(self.jobs.pop(key).get(timeout=600))
        log(f"  the CPU run '{key}' from the worker (waited "
            f"{time.perf_counter() - t0:.1f} s)")
        return res

    def close(self):
        if self.pool is not None:
            self.pool.terminate()
            self.pool.join()
            self.pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()



def nvidia_smi_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def perturbed_U(mix, xyz, dtype, device):
    """The perturbed periodic state of tests/test_pallas_fused.py (in 2-D
    its first two velocity components): a uniform state has dU/dt = 0
    and would hide any kernel fault."""
    tp = 2 * np.pi
    dim = xyz.shape[-1]
    Up = np.zeros(xyz.shape[:-1] + (dim + 2,))
    Up[..., 0] = 1.2
    Up[..., 1:1 + dim] = (10.0, 3.0, -2.0)[:dim]
    Up[..., dim + 1] = 300.0
    Up[..., 1] += 5.0 * np.sin(tp * xyz[..., 0]) * np.cos(tp * xyz[..., 1])
    Up[..., 2] += -5.0 * np.cos(tp * xyz[..., 0]) * np.sin(tp * xyz[..., -1])
    Up[..., dim + 1] += (20.0 * np.sin(tp * xyz[..., -1])
                         * np.cos(tp * xyz[..., 1]))
    Up = torch.as_tensor(Up, dtype=torch.float64)
    return mix.conservatives(Up).to(dtype=dtype, device=device).contiguous()


class Setup:
    """Tables per (grid, order, basis, walls), built once (the 32^3 setup
    takes ~25 s)."""

    def __init__(self):
        self._tables = {}

    def tables(self, n, order, basis="gl", walls=False):
        from tps_torch.dg.discretization import build_tables
        from tps_torch.mesh.generators import box_2d, box_3d

        key = (n, order, basis, walls)
        if key not in self._tables:
            t0 = time.perf_counter()
            if len(n) == 3:
                mesh = box_3d(*n, periodic=(not walls,) * 3)
            else:
                mesh = box_2d(*n, periodic_x=not walls, periodic_y=not walls)
            self._tables[key] = build_tables(
                mesh, order, **({} if basis == "gl" else GLL))
            log(f"  tables {n} p={order} {basis}{' walls' if walls else ''}: "
                f"{time.perf_counter() - t0:.1f} s")
        return self._tables[key]

    @staticmethod
    def ctx(eq_system, dim=3, walls_of=None, transport="sutherland"):
        """RHS context; walls_of: tables whose every boundary patch gets an
        inviscid wall; transport: "sutherland" or "constant" (CONSTANT)."""
        from tps_torch.dg.bc import WallBC
        from tps_torch.dg.fluxes import Fluxes
        from tps_torch.dg.rhs import RHSContext, bc_slices
        from tps_torch.dg.riemann import Rusanov
        from tps_torch.physics.gas import DryAir
        from tps_torch.physics.transport import ConstantTransport, DryAirTransport

        mix = DryAir(dim=dim, nvel=dim)
        if eq_system == "euler":
            tr = None
        elif transport == "constant":
            tr = ConstantTransport(**CONSTANT)
        else:
            tr = DryAirTransport(mix.gas_constant, mix.specific_heat_ratio)
        fl = Fluxes(mixture=mix, transport=tr, eq_system=eq_system)
        bcs = ()
        if walls_of is not None:
            bcs = bc_slices(walls_of.f_bdr_attr, lambda p: WallBC("inviscid"))
        return RHSContext(fluxes=fl, riemann=Rusanov(fl), bcs=bcs)


def rel(a, b):
    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))


# (nx, ny, nz), order; 8x12x16 is non-cubic so a swapped axis shows up
KERNEL_GRIDS = (((16, 16, 16), 2), ((24, 24, 24), 2), ((32, 32, 32), 2),
                ((12, 12, 12), 3), ((8, 12, 16), 2))
# constant transport (physics/transport.py::ConstantTransport): air's
# Sutherland values at 300 K times 1000, the cylinder deck's viscosity
# multiplier, so that the viscous terms weigh in the comparison
CONSTANT = {"visc": 1.846e-2, "bulk_visc": 2.0e-3, "kappa": 26.2}
CONSTANT_GRIDS = ((16, 16, 16), (8, 12, 16))


def phase_kernels(setup, dev, grids=KERNEL_GRIDS):
    """K1, K2 and K1+K2 against the plain version on the card."""
    from tps_torch.dg.cuda_fused import build_cuda_fused

    failures, main_err = [], {}
    for n, order in grids:
        tab = setup.tables(n, order)
        cases = [("euler", None), ("navier-stokes", "sutherland")]
        if n in CONSTANT_GRIDS:
            cases.append(("navier-stokes", "constant"))
        for eq, transport in cases:
            ctx = setup.ctx(eq, transport=transport)
            rhs64 = build_cuda_fused(tab, ctx, torch.float64, dev)
            U64 = perturbed_U(ctx.mixture, tab.xyz_dof, torch.float64, dev)
            for dtype in (torch.float64, torch.float32):
                rhs = rhs64 if dtype == torch.float64 else build_cuda_fused(
                    tab, ctx, dtype, dev)
                res = compare_kernels(rhs, rhs64.plain, U64.to(dtype))
                name = (f"{n} p={order} {eq}"
                        f"{' constant transport' if transport == 'constant' else ''}"
                        f" {str(dtype)[6:]}")
                bad = [k for k, v in res.items() if not v["ok"]]
                log(f"  {name}: " + "; ".join(
                    f"{k} {v['vs_plain']:.3e}" + (
                        f" (f64 dist: kernel {v['kernel_vs_f64']:.3e}, "
                        f"plain {v['plain_vs_f64']:.3e})"
                        if "kernel_vs_f64" in v else "")
                    for k, v in res.items())
                    + (f"  FAIL {bad}" if bad else ""))
                if bad:
                    failures.append(name)
                if (n == (16, 16, 16) and dtype == torch.float32
                        and transport == "sutherland"):
                    main_err = {k: res[k]["max_abs"]
                                for k in ("k1_gradient", "k2_faces_volume")}
    if failures:
        raise SystemExit(f"kernel parity failed: {failures}")
    return main_err


def compare_kernels(rhs, plain64, U):
    """K1, K2 (fed the plain gradient) and K1+K2 vs the plain version on
    the same input U; for f32 also each one's distance from the f64
    plain result on U.  Returns per check: vs_plain, max_abs, ok."""
    plain = rhs.plain
    ne = rhs.ne
    U2 = U.reshape(ne, -1)
    U64, U64_2 = U.double(), U.double().reshape(ne, -1)
    f32 = U.dtype == torch.float32
    out = {}

    def check(name, kern, ref, ref64_fn):
        r = {"vs_plain": rel(kern, ref),
             "max_abs": float(torch.max(torch.abs(kern - ref)))}
        bar = K1_TOL_F64 if name == "k1_gradient" and not f32 else TOL[U.dtype]
        r["ok"] = r["vs_plain"] <= bar
        if f32:
            ref64 = ref64_fn()
            r["kernel_vs_f64"] = rel(kern.double(), ref64)
            r["plain_vs_f64"] = rel(ref.double(), ref64)
            r["ok"] = r["ok"] or r["kernel_vs_f64"] <= 2 * r["plain_vs_f64"]
        out[name] = r

    G_ref = None
    if rhs.viscous:
        G_ref = plain.gradient(U2)
        check("k1_gradient", rhs.gradient(U), G_ref.reshape(ne, rhs.ndof, 5, 3),
              lambda: plain64.gradient(U64_2).reshape(ne, rhs.ndof, 5, 3))
    y, mcs_e = rhs.faces_volume(
        U, None if G_ref is None else G_ref.reshape(ne, rhs.ndof, 5, 3))
    check("k2_faces_volume", y, plain.faces_volume(U2, G_ref).reshape(U.shape),
          lambda: plain64.faces_volume(
              U64_2, None if G_ref is None else G_ref.double()
          ).reshape(U.shape))
    y, aux = rhs(U)
    y_plain, aux_plain = plain(U2)
    check("rhs", y, y_plain.reshape(U.shape),
          lambda: plain64(U64_2)[0].reshape(U.shape))
    m, m_ref = float(aux["max_char_speed"]), float(aux_plain["max_char_speed"])
    r = abs(m - m_ref) / m_ref
    out["mcs"] = {"vs_plain": r, "max_abs": abs(m - m_ref),
                  "ok": r <= (MCS_TOL_F64 if not f32 else TOL[U.dtype])}
    torch.cuda.synchronize()
    return out


def flagship_deck():
    """The flagship deck with the collocated Gauss-Legendre basis: the
    fused path's main-path deck.

    vortex3d_ns.ini as shipped leaves [flow] basisType / integrationRule
    at the reference default (Gauss-Lobatto), which runs the general slot
    path (phase_cli on DECK); the fused path (and K1/K2) needs the GL basis
    of the bench configuration, so those two keys are added here."""
    with open(DECK) as f:
        text = f.read()
    if "[flow]\n" not in text:
        raise SystemExit(f"{DECK}: no [flow] section")
    text = text.replace("[flow]\n", "[flow]\nbasisType = 0\nintegrationRule = 0\n", 1)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    path = os.path.join(REPO, "build", "vortex3d_ns_gl.ini")
    with open(path, "w") as f:
        f.write(text)
    return path


def all_launches():
    """Launches by kernel since the last reset."""
    from tps_torch.dg import cuda_faces, cuda_fused

    return {**cuda_fused.launches, **cuda_faces.launches}


def launches_by_variant():
    """all_launches() and the face sweep's launches by variant
    ("face_sweep/<variant>", summed in "face_sweep")."""
    from tps_torch.dg import cuda_faces

    return {**all_launches(), **{f"face_sweep/{v}": n for v, n in
                                 cuda_faces.variant_launches.items()}}


def reset_all_launches():
    from tps_torch.dg import cuda_faces, cuda_fused

    cuda_fused.reset_launches()
    cuda_faces.reset_launches()


def phase_cli(path, launched, idle):
    """A main path: the harness on a deck (f32, CUDA), freestream kept;
    its steps replayed the step graph; the kernels in `launched` ran
    4 times a step (RK4), those in `idle` did not.  Returns the counts,
    the steps and the solver."""
    from tps_torch import harness

    torch.set_default_dtype(torch.float32)
    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", path])
    tps.parse_input()
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    s = tps.solver
    U0 = s.state_global().copy()
    reset_all_launches()
    t0 = time.perf_counter()
    tps.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = all_launches()
    U1 = s.state_global()
    if tps.get_status() != 0:
        raise SystemExit(f"CLI run ended with status {tps.get_status()}")
    dev = float(np.max(np.abs(U1 - U0)) / np.max(np.abs(U0)))
    log(f"  {type(s._rhs).__name__}: {s.iter} steps in {wall:.2f} s; "
        f"launches {counts}; freestream max|U-U0|/max|U0| = {dev:.3e} "
        f"(bar {FREESTREAM_TOL})")
    if not np.all(np.isfinite(U1)) or U1.shape != U0.shape:
        raise SystemExit("CLI run: non-finite or misshapen final state")
    if not dev <= FREESTREAM_TOL:
        raise SystemExit("CLI run: freestream not preserved")
    missing = [k for k in launched if counts[k] != 4 * s.iter]
    stray = [k for k in idle if counts[k] != 0]
    if missing or stray:
        raise SystemExit(f"CLI run: not 4 launches a step of {missing} / "
                         f"launched {stray} ({s.iter} steps)")
    if s._loop.graph is None:
        raise SystemExit("CLI run: the steps did not go through the graph")
    log(f"  step graph: captured in {s._loop.capture_s:.3f} s, pool "
        f"{s._loop.pool_bytes / 2**20:.1f} MiB, launches a replay "
        f"{s._loop.per_replay}")
    return counts, s.iter, s


SOLVER_DECK = """
[solver]
type = flow
[flow]
order = 2
basisType = 0
integrationRule = 0
maxIters = 20
timingFreq = 10
fluid = dry_air
equation_system = navier-stokes
[mesh]
generator = box3d
nx = 32
ny = 32
nz = 32
periodic_x = 1
periodic_y = 1
periodic_z = 1
[time]
integrator = rk4
{dt}
[io]
outdirBase = build/solver_check
"""


FIXED_DT = "dt_fixed = 3e-06"
CFL = "cfl = 0.12"


def deck_solver(deck, name, dt_line, dtype, dev, perturb=True,
                constant_transport=False):
    """A solver on the card through the harness, from `deck` with its
    [time] line dt_line, in dtype; from perturbed_U where perturb; with
    CONSTANT transport where constant_transport (the run configuration's
    transport_model, which no ini key sets)."""
    from tps_torch import harness

    torch.set_default_dtype(dtype)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    path = os.path.join(REPO, "build", name + ".ini")
    text = deck.format(dt=dt_line)
    if constant_transport:
        text += ("[plasma_models/transport_model/constant]\n"
                 f"viscosity = {CONSTANT['visc']}\n"
                 f"bulkViscosity = {CONSTANT['bulk_visc']}\n"
                 f"thermalConductivity = {CONSTANT['kappa']}\n")
    with open(path, "w") as f:
        f.write(text)
    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", path])
    tps.parse_input()
    if constant_transport:
        tps.config.transport_model = "constant"
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    s = tps.solver
    if perturb:
        s.set_state_global(perturbed_U(s.mixture, s.tables_np.xyz_dof,
                                       torch.float64, "cpu").numpy())
    return s


def phase_solver(dev):
    """The solver (kernels, step graph) vs a plain-version RK4 loop, 32^3
    p=2 f64.  Returns the solver and its initial state."""
    from tps_torch.dg.fused import build_fused
    from tps_torch.time.integrators import rk4

    dt = 3.0e-6
    s = deck_solver(SOLVER_DECK, "solver_check", FIXED_DT, torch.float64, dev)
    U0 = s.U.clone()
    s.solve()
    U_solver = s.U.clone()

    plain = build_fused(s.tables_np, s.ctx, torch.float64, dev)
    U2 = U0.reshape(U0.shape[0], -1)
    t = 0.0
    for _ in range(20):
        U2 = rk4(plain, U2, t, dt)[0]
        t += dt
    err = rel(U_solver, U2.reshape(U0.shape))
    moved = rel(U_solver, U0)
    log(f"  20 steps: max|U_kernels - U_plain|/max|U_plain| = {err:.3e} "
        f"(bar {SOLVER_TOL}); the state moved by {moved:.3e}")
    if not err <= SOLVER_TOL or not moved > 0:
        raise SystemExit("solver vs plain RK4 loop failed")
    return s, U0


def phase_timing(setup, dev):
    """ms/RHS (RK4 chains of 50 steps through the kernels, 1 through the
    host-bound plain version) and ms per kernel (50 calls, the plain
    version 10), kernels vs plain, in turns plain, kernel, kernel, plain,
    by CUDA events; each kernel's time on the device alone (`kernel_ms`),
    f32 and f64."""
    from tps_torch.dg.cuda_fused import build_cuda_fused
    from tps_torch.time.integrators import rk4

    out = {}
    ctx = setup.ctx("navier-stokes")
    for n in ((16, 16, 16), (32, 32, 32)):
        tab = setup.tables(n, 2)
        rhs = build_cuda_fused(tab, ctx, torch.float32, dev)
        plain = rhs.plain
        U = perturbed_U(ctx.mixture, tab.xyz_dof, torch.float32, dev)
        U2 = U.reshape(tab.ne, -1)
        dt = 1e-6

        def chain(f, u, steps):
            def run():
                x = u
                for _ in range(steps):
                    x = rk4(f, x, 0.0, dt)[0]
                return x
            return run

        steps = {"plain": 1, "kernels": 50}
        runs = {"plain": chain(plain, U2, steps["plain"]),
                "kernels": chain(rhs, U, steps["kernels"])}
        times = {"plain": [], "kernels": []}
        for which in ("plain", "kernels", "kernels", "plain"):
            times[which].append(cuda_ms(runs[which], 2) / (4 * steps[which]))
        G = rhs.gradient(U)
        k = {
            "k1_gradient": [cuda_ms(lambda: plain.gradient(U2), 10),
                            cuda_ms(lambda: rhs.gradient(U), 50),
                            cuda_ms(lambda: rhs.gradient(U), 50),
                            cuda_ms(lambda: plain.gradient(U2), 10)],
            "k2_faces_volume": [
                cuda_ms(lambda: plain.faces_volume(U2, G.reshape(tab.ne, -1)), 10),
                cuda_ms(lambda: rhs.faces_volume(U, G), 50),
                cuda_ms(lambda: rhs.faces_volume(U, G), 50),
                cuda_ms(lambda: plain.faces_volume(U2, G.reshape(tab.ne, -1)), 10)],
        }
        res = {
            "ms_per_rhs": float(np.mean(times["kernels"])),
            "plain_ms_per_rhs": float(np.mean(times["plain"])),
        }
        for name, (p1, k1, k2, p2) in k.items():
            res[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2}
        # K1 and K2 in f64 (the kernels alone; K2's plain version is
        # host-bound)
        rhs64 = build_cuda_fused(tab, ctx, torch.float64, dev)
        U64 = U.double()
        G64 = rhs64.gradient(U64)
        calls = {"k1_gradient": (lambda: rhs.gradient(U),
                                 lambda: rhs64.gradient(U64)),
                 "k2_faces_volume": (lambda: rhs.faces_volume(U, G),
                                     lambda: rhs64.faces_volume(U64, G64))}
        for name, (f32_call, f64_call) in calls.items():
            res[name]["f64_ms"] = cuda_ms(f64_call, 50)
            res[name]["device_ms"] = kernel_ms(f32_call, name)
            res[name]["f64_device_ms"] = kernel_ms(f64_call, name)
        res["profile"] = device_share(lambda: rk4(rhs, U, 0.0, dt))
        log(f"  {n} p=2 NS f32: ms/RHS kernels {times['kernels']} "
            f"plain {times['plain']}; per kernel (plain, kernel, kernel, "
            f"plain) {k}; f64 (CUDA events) K1 "
            f"{res['k1_gradient']['f64_ms']:.4f}, K2 "
            f"{res['k2_faces_volume']['f64_ms']:.4f} ms; on the device "
            + "; ".join(f"{name} {ms_text(res[name]['device_ms'])} (f64 "
                        f"{ms_text(res[name]['f64_device_ms'])})"
                        for name in calls)
            + f"; profiled RK4 step {res['profile']}")
        res["tab"] = tab
        out[n] = res
    return out


# ---------------------------------------------------------------- faces

# (n, order, basis, walls): the flagship deck's GLL box, bench.py's walled
# general-path box on both bases, a non-cubic walled box (a swapped axis
# shows up), p=3, and 2-D
FACE_GRIDS = (((16, 16, 16), 2, "gll", False), ((16, 16, 16), 2, "gl", True),
              ((16, 16, 16), 2, "gll", True), ((8, 12, 16), 2, "gll", True),
              ((12, 12, 12), 3, "gll", False), ((32, 32), 3, "gll", True),
              # p=1 (4 or 8 nodes an element), GL and GLL
              ((16, 16, 16), 1, "gl", True), ((16, 16, 16), 1, "gll", False),
              ((32, 32), 1, "gll", True), ((32, 32), 1, "gl", False))


def face_input(ctx, tab, U):
    """The sweep's X = [U | G] (G the plain DG gradient) for Navier-Stokes,
    U for Euler."""
    from tps_torch.dg.operators import dg_gradient

    if ctx.fluxes.eq_system == "euler":
        return U.contiguous()
    G = dg_gradient(tab, ctx.mixture.primitives(U))
    return torch.cat([U, G.reshape(U.shape[0], U.shape[1], -1)], -1).contiguous()


def phase_faces(setup, dev):
    """The face sweep against its plain versions: prototype mode on the
    prototype's case, slot mode on FACE_GRIDS (f64, and f32 by the rule
    of TOL)."""
    from tps_torch.dg.cuda_faces import build_face_sweep
    from tps_torch.tools import face_prototype

    proto = face_prototype.run("cuda", repeat=50,
                               tab=setup.tables((16, 16, 16), 2))
    log(f"  prototype mode, 16^3 p=2 GL Euler f32: kernel vs prototype "
        f"chain {proto['rel_err']:.3e} (bar {PROTO_TOL}); kernel "
        f"{proto['ms']:.4f} ms, plain {proto['plain_ms']:.4f} ms")
    failures = [] if proto["rel_err"] < PROTO_TOL else ["prototype"]
    main_err = None
    for n, order, basis, walls in FACE_GRIDS:
        tab_np = setup.tables(n, order, basis, walls)
        cases = [("euler", None), ("navier-stokes", "sutherland")]
        if walls and basis == "gll" and n in ((16, 16, 16), (32, 32)):
            cases.append(("navier-stokes", "constant"))
        for eq, transport in cases:
            ctx = setup.ctx(eq, len(n), tab_np if walls else None, transport)
            tab64 = tab_np.to_torch(torch.float64, dev)
            tab32 = tab_np.to_torch(torch.float32, dev)
            sw64, sw32 = build_face_sweep(tab64, ctx), build_face_sweep(tab32, ctx)
            X64 = face_input(ctx, tab64, perturbed_U(
                ctx.mixture, tab_np.xyz_dof, torch.float64, dev))
            X32 = X64.float()
            r64 = rel(sw64(X64), sw64.plain(X64))
            k32, p32 = sw32(X32), sw32.plain(X32)
            ref = sw64.plain(X32.double())
            r32 = rel(k32, p32)
            dk, dp = rel(k32.double(), ref), rel(p32.double(), ref)
            ok = r64 <= TOL[torch.float64] and (
                r32 <= TOL[torch.float32] or dk <= 2 * dp)
            name = (f"{n} p={order} {basis}{' walls' if walls else ''} {eq}"
                    f"{' constant transport' if transport == 'constant' else ''}")
            log(f"  {name}: f64 {r64:.3e}; f32 {r32:.3e} (f64 dist: kernel "
                f"{dk:.3e}, plain {dp:.3e})" + ("" if ok else "  FAIL"))
            if not ok:
                failures.append(name)
            if (n, basis, walls, transport) == ((16, 16, 16), "gll", False,
                                                "sutherland"):
                main_err = float(torch.max(torch.abs(k32 - p32)))
    torch.cuda.synchronize()
    if failures:
        raise SystemExit(f"face sweep parity failed: {failures}")
    return main_err, proto


WALLED_DECK = """
[solver]
type = flow
[flow]
order = 2
maxIters = 20
timingFreq = 10
fluid = dry_air
equation_system = navier-stokes
[mesh]
generator = box3d
nx = 16
ny = 16
nz = 16
[time]
integrator = rk4
{dt}
[io]
outdirBase = build/walled_check
""" + "".join(f"[boundaryConditions/wall{i}]\npatch = {i}\ntype = inviscid\n"
              for i in range(1, 7))


def phase_walled_solver(dev):
    """The slot path through the solver (the face-sweep kernel) vs a plain
    RK4 loop over compute_rhs with the plain face sweep: 16^3 p=2 GLL NS,
    six inviscid walls, f64, 20 fixed-dt steps."""
    from tps_torch.dg.cuda_faces import face_sweep_plain
    from tps_torch.dg.rhs import SlotRHS, compute_rhs
    from tps_torch.time.integrators import rk4

    dt = 3.0e-6
    s = deck_solver(WALLED_DECK, "walled_check", FIXED_DT, torch.float64, dev)
    if not isinstance(s._rhs, SlotRHS) or len(s.ctx.bcs) != 6:
        raise SystemExit("walled deck: not on the slot path with six walls")
    U0 = s.U.clone()
    reset_all_launches()
    s.solve()
    counts = all_launches()
    U_solver = s.U.clone()

    plain = functools.partial(face_sweep_plain, s.ctx, s.tables)
    bc_states = tuple(None for _ in s.ctx.bcs)

    def rhs(U, t):
        return compute_rhs(s.ctx, s.tables, U, t, bc_states=bc_states,
                           sweep=plain)

    U, t = U0, 0.0
    for _ in range(20):
        U = rk4(rhs, U, t, dt)[0]
        t += dt
    err, moved = rel(U_solver, U), rel(U_solver, U0)
    log(f"  20 steps: max|U_kernel - U_plain|/max|U_plain| = {err:.3e} "
        f"(bar {SOLVER_TOL}); moved {moved:.3e}; launches {counts}")
    if not err <= SOLVER_TOL or not moved > 0 or counts["face_sweep"] != 80:
        raise SystemExit("walled solver vs plain RK4 loop failed")
    return s, U0


def phase_constant_decks(dev):
    """ROADMAP C1: Navier-Stokes decks with constant transport through the
    solver on the card (f32, CFL, 8 steps): the fused 16^3 GL box on
    K1+K2 and the walled 16^3 GLL box on the face sweep, 4 launches a
    step through the step graph; the state finite and moved."""
    from tps_torch.dg.cuda_fused import CudaFusedRHS
    from tps_torch.dg.rhs import SlotRHS
    from tps_torch.physics.transport import ConstantTransport

    fused = SOLVER_DECK.replace("= 32\n", "= 16\n").replace(
        "solver_check", "constant_fused")
    walled = WALLED_DECK.replace("walled_check", "constant_walled")
    for name, deck, kind, kernels in (
            ("fused 16^3 GL", fused, CudaFusedRHS,
             ("k1_gradient", "k2_faces_volume")),
            ("walled 16^3 GLL", walled, SlotRHS, ("face_sweep",))):
        s = deck_solver(deck, name.split()[0] + "_constant", CFL,
                        torch.float32, dev, constant_transport=True)
        s.config.max_iters = 8
        U0 = s.U.clone()
        reset_all_launches()
        s.solve()
        counts = all_launches()
        moved = rel(s.U, U0)
        ok = (isinstance(s._rhs, kind) and s._loop.graph is not None
              and isinstance(s.ctx.fluxes.transport, ConstantTransport)
              and all(counts[k] == 4 * s.iter for k in kernels)
              and sum(counts.values()) == 4 * s.iter * len(kernels)
              and bool(torch.isfinite(s.U).all()) and moved > 0)
        log(f"  constant transport, {name}: {type(s._rhs).__name__}, "
            f"{s.iter} steps, launches {counts}, moved {moved:.3e}"
            + ("" if ok else "  FAIL"))
        if not ok:
            raise SystemExit(f"constant-transport deck {name} failed")


def graph_vs_eager(s, U0, dt0):
    """solve() from U0 at t = 0 and dt0, through the step graph and then
    eagerly: the relative differences of U, t and dt."""
    out = []
    for graphs in (True, False):
        s.set_state_global(U0.cpu().numpy())
        s.time, s.dt, s.iter, s.cuda_graphs = 0.0, dt0, 0, graphs
        s.solve()
        out.append((s.U.clone(), float(s.time), float(s.dt)))
    s.cuda_graphs = True
    (Ug, tg, dtg), (Ue, te, dte) = out
    return rel(Ug, Ue), abs(tg - te) / abs(te), abs(dtg - dte) / abs(dte)


def phase_graphs(dev, fixed):
    """The step graph against eager steps through solve(), f64, on the
    fused path (32^3 p=2) and the walled slot deck (16^3 p=2 GLL, six
    walls), in fixed-dt mode (`fixed`: phases 6 and 7's solvers, whose
    graphs were captured before this state was set) and in CFL mode."""
    failures = []
    for name, deck, tag in (("fused 32^3", SOLVER_DECK, "solver_check"),
                            ("walled slot", WALLED_DECK, "walled_check")):
        cfl = deck_solver(deck, tag + "_cfl", CFL, torch.float64, dev)
        for mode, (s, U0) in (("fixed dt", fixed[name]),
                              ("CFL", (cfl, cfl.U.clone()))):
            diffs = graph_vs_eager(s, U0, float(s.config.dt_fixed)
                                   if mode == "fixed dt" else float(s.dt))
            ok = max(diffs) <= GRAPH_TOL
            log(f"  {name}, {mode}: graph vs eager, {s.iter} steps: U "
                f"{diffs[0]:.3e}, t {diffs[1]:.3e}, dt {diffs[2]:.3e} (bar "
                f"{GRAPH_TOL})" + ("" if ok else "  FAIL"))
            if not ok:
                failures.append(f"{name} {mode}")
    if failures:
        raise SystemExit(f"step graph vs eager failed: {failures}")


# ---------------------------------------------------------------- cylinder


def cylinder_checks(s, wake):
    """The physics of tests/test_farfield_cyl.py:76-100 on the solver's
    state: a velocity deficit near the cylinder, slow flow at the wall,
    stagnation pressure above p_inf ahead of it, the far field near the
    free stream.  The deficit is the test's (mean u over 0.5 < r < 1) or,
    with `wake`, the wake's behind the cylinder (r < 1.5, x > 0, |y| <
    0.5): after 200 steps the flow speeds up around the sides, and the
    ring's mean is no longer a deficit.  Returns the four numbers; raises
    if one misses."""
    Up = s.mixture.primitives(s.U).double().cpu().numpy()
    p = s.mixture.pressure(s.U).double().cpu().numpy()
    xyz = np.asarray(s.tables_np.xyz_dof)
    r = np.linalg.norm(xyz, axis=-1)
    if wake:
        near = (r < 1.5) & (xyz[..., 0] > 0) & (np.abs(xyz[..., 1]) < 0.5)
    else:
        near = (r > 0.5) & (r < 1.0)
    wall = r < r.min() + 0.08
    stag = (r < 0.75) & (xyz[..., 0] < 0) & (np.abs(xyz[..., 1]) < 0.25)
    far = r > 6.0
    got = {"u_near": float(Up[..., 1][near].mean()),
           "speed_wall": float(np.linalg.norm(Up[..., 1:3], axis=-1)[wall].mean()),
           "p_stagnation": float(p[stag].mean()),
           "rho_far": float(Up[..., 0][far].mean())}
    ok = (got["u_near"] < 0.7 * 33.3 and got["speed_wall"] < 0.5 * 33.3
          and got["p_stagnation"] > 101300.0
          and abs(got["rho_far"] - 1.2) < 0.05
          and wall.any() and stag.any() and far.any())
    log(f"  physics: mean u {'in the wake' if wake else 'for 0.5 < r < 1'} "
        f"{got['u_near']:.3f} (< "
        f"{0.7 * 33.3:.2f}); mean |u| at the wall {got['speed_wall']:.3f} (< "
        f"{0.5 * 33.3:.2f}); stagnation p {got['p_stagnation']:.1f} (> 101300);"
        f" far-field rho {got['rho_far']:.4f} (1.2 +- 0.05)")
    if not ok:
        raise SystemExit("cylinder deck: a physics check failed")
    return got


def phase_cylinder():
    """The cylinder deck as shipped through the CLI (f32, CUDA, 200 steps):
    the face sweep 4 times a step and K1/K2 never, every step a graph
    replay, the checkpoint and the VTK file written, the checkpoint read
    back bitwise (h5lite, and the solver's restart read), the physics."""
    from tps_torch import harness
    from tps_torch.io import h5lite

    torch.set_default_dtype(torch.float32)
    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", CYL_DECK])
    tps.parse_input()
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    s = tps.solver
    out = s.config.outdir
    ckpt = os.path.join(out, "restart_output.sol.h5")
    vtk = os.path.join(out, f"solution_{s.max_iters:08d}.vtk")
    for path in (ckpt, vtk):
        if os.path.exists(path):
            os.remove(path)
    reset_all_launches()
    t0 = time.perf_counter()
    tps.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = all_launches()
    if tps.get_status() != 0 or s.iter != 200:
        raise SystemExit(f"cylinder deck: status {tps.get_status()}, "
                         f"{s.iter} steps")
    log(f"  {type(s._rhs).__name__}, {s.tables_np.ne} elements: {s.iter} "
        f"steps in {wall:.2f} s (2 checkpoints, a VTK file); launches "
        f"{counts}; step graph captured in {s._loop.capture_s:.3f} s, pool "
        f"{s._loop.pool_bytes / 2**20:.1f} MiB")
    if (counts["face_sweep"] != 4 * s.iter or counts["k1_gradient"]
            or counts["k2_faces_volume"] or s._loop.graph is None):
        raise SystemExit("cylinder deck: not 4 face-sweep launches a step "
                         "through the graph, or K1/K2 launched")
    U = s.state_global()
    if not np.all(np.isfinite(U)):
        raise SystemExit("cylinder deck: non-finite state")
    f = h5lite.read(ckpt)
    ne, ndof = U.shape[:2]
    back = np.stack([f["solution"][n].reshape(ne, ndof) for n in
                     ("density", "x-mom", "y-mom", "rho-E")], -1)
    s.read_restart()
    ok = (int(f.attrs["iteration"]) == 200 and os.path.getsize(vtk) > 0
          and np.array_equal(back, U.astype(np.float64))
          and np.array_equal(s.state_global(), U))
    log(f"  {os.path.relpath(ckpt, REPO)} ({os.path.getsize(ckpt)} B) and "
        f"{os.path.relpath(vtk, REPO)} ({os.path.getsize(vtk)} B) written; "
        f"read back bitwise: {ok}")
    if not ok:
        raise SystemExit("cylinder deck: checkpoint or VTK file wrong")
    physics = cylinder_checks(s, wake=True)
    # the test's own configuration (8x32, 40 steps), its checks verbatim
    t = deck_solver(annulus_deck(8, 32, 40, "cyl_test"), "cyl_test", "",
                    torch.float32, torch.device("cuda", 0), perturb=False)
    t.solve()
    log(f"  tests/test_farfield_cyl.py's run (8x32, 40 steps):")
    physics["test_config"] = cylinder_checks(t, wake=False)
    return counts, physics


def annulus_deck(nr, ntheta, iters, name, dt_line=""):
    """The cylinder deck at nr x ntheta, iters steps, no VTK file, a
    checkpoint only at the end, in build/<name>; dt_line replaces the CFL
    line of [time] where given."""
    with open(CYL_DECK) as f:
        text = f.read()
    for old, new in (("nr = 12", f"nr = {nr}"),
                     ("ntheta = 48", f"ntheta = {ntheta}"),
                     ("maxIters = 200", f"maxIters = {iters}"),
                     ("outputFreq = 100", "outputFreq = 100000"),
                     ("timingFreq = 20", "timingFreq = 100000"),
                     ("enableParaview = 1", "enableParaview = 0"),
                     ("outdirBase = output_cyl2d",
                      f"outdirBase = build/{name}")):
        if old not in text:
            raise SystemExit(f"{CYL_DECK}: no '{old}'")
        text = text.replace(old, new)
    if dt_line:
        text = text.replace("cfl = 0.15", dt_line)
    return text.replace("{", "{{").replace("}", "}}") + "{dt}"


FILE_CHANNEL = """
[solver]
type = flow
[flow]
mesh = {mesh}
order = 2
maxIters = {iters}
timingFreq = 100000
outputFreq = 100000
fluid = dry_air
equation_system = navier-stokes
[time]
integrator = rk4
{{dt}}
[initialConditions]
rho = 1.2
rhoU = 12.0
rhoV = 0.
rhoW = 0.
pressure = 101300
[boundaryConditions/inlet]
patch = 1
type = subsonic
density = 1.2
uvw = '10.0 0.0 0.0'
[boundaryConditions/outlet]
patch = 2
type = nonReflectingPressure
pressure = 101000
[io]
outdirBase = build/{name}
""" + "".join(f"[boundaryConditions/wall{i}]\npatch = {i}\n"
              f"type = {'viscous_isothermal' if i < 5 else 'slip'}\n"
              + ("temperature = 300\n" if i < 5 else "")
              for i in range(3, 7))


def file_channel_deck(n, iters, name):
    """A 3-D channel on the reference-default GLL basis read from an MFEM
    file that box_3d(n) on [0,2]x[0,0.5]x[0,0.5] is written to: subsonic
    inlet (x-min), nonReflectingPressure outlet (x-max), isothermal walls
    (y), slip walls (z).  Returns the deck text and the generator's mesh."""
    from tps_torch.mesh.generators import box_3d
    from tps_torch.mesh.mfem_reader import write_mfem_mesh

    mesh = box_3d(*n, bounds=((0.0, 2.0), (0.0, 0.5), (0.0, 0.5)))
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    path = os.path.join(REPO, "build", f"channel_{n[0]}x{n[1]}x{n[2]}.mesh")
    write_mfem_mesh(path, mesh)
    return FILE_CHANNEL.format(mesh=path, iters=iters, name=name), mesh, path


def phase_annulus_faces(setup, dev):
    """The face sweep against its plain version on the cylinder O-grid at
    12x48 (shipped), 24x96 and 96x384, GL and GLL, and on a hex mesh read
    from an MFEM file (box_3d 32x16x16 on the channel's box, GLL, read back
    equal to the generator's mesh); f64 and f32 by the rule of TOL.  The
    f32 kernel is timed (CUDA events and on the device) against the plain
    version on the GL annulus at 24x96 and 96x384."""
    from tps_torch.dg.cuda_faces import build_face_sweep
    from tps_torch.dg.discretization import build_tables
    from tps_torch.mesh.generators import annulus_2d
    from tps_torch.mesh.mfem_reader import read_mfem_mesh

    cases = [((nr, nth), basis) for nr, nth in ((12, 48), (24, 96), (96, 384))
             for basis in ("gl", "gll")] + [("hex file 32x16x16", "gll")]
    failures, timing = [], {}
    for grid, basis in cases:
        t0 = time.perf_counter()
        if grid == "hex file 32x16x16":
            _, mesh, path = file_channel_deck((32, 16, 16), 1, "faces")
            back = read_mfem_mesh(path)
            same = all(np.array_equal(getattr(back, k), getattr(mesh, k))
                       for k in ("vertices", "elements", "bdr_faces",
                                 "bdr_attrs")) and np.array_equal(
                back.attributes(), mesh.attributes())
            log(f"  {os.path.relpath(path, REPO)} read back equal to "
                f"box_3d's mesh: {same}")
            if not same:
                failures.append("hex file read back")
            mesh, walls = back, True
        else:
            mesh, walls = annulus_2d(*grid, r0=0.5, r1=8.0), True
        tab_np = build_tables(mesh, 2, **({} if basis == "gl" else GLL))
        name = f"{grid} p=2 {basis}"
        ctx = setup.ctx("navier-stokes", mesh.dim, tab_np if walls else None)
        tab64 = tab_np.to_torch(torch.float64, dev)
        tab32 = tab_np.to_torch(torch.float32, dev)
        sw64, sw32 = build_face_sweep(tab64, ctx), build_face_sweep(tab32, ctx)
        X64 = face_input(ctx, tab64, perturbed_U(
            ctx.mixture, tab_np.xyz_dof, torch.float64, dev))
        X32 = X64.float()
        y64, p64 = sw64(X64), sw64.plain(X64)
        r64 = rel(y64, p64)
        k32, p32 = sw32(X32), sw32.plain(X32)
        ref = sw64.plain(X32.double())
        r32 = rel(k32, p32)
        dk, dp = rel(k32.double(), ref), rel(p32.double(), ref)
        ok = r64 <= TOL[torch.float64] and (r32 <= TOL[torch.float32]
                                            or dk <= 2 * dp)
        log(f"  {name} ({tab_np.ne} elements, nqf {tab_np.nqf}, tables "
            f"{time.perf_counter() - t0:.1f} s): f64 {r64:.3e}; f32 "
            f"{r32:.3e} (f64 dist: kernel {dk:.3e}, plain {dp:.3e})"
            + ("" if ok else "  FAIL"))
        if not ok:
            failures.append(name)
        if basis == "gl" and grid in ((24, 96), (96, 384)):
            ms = [cuda_ms(lambda: sw32.plain(X32), 20), cuda_ms(lambda: sw32(X32), 50),
                  cuda_ms(lambda: sw32(X32), 50), cuda_ms(lambda: sw32.plain(X32), 20)]
            b = face_bound(tab_np, "navier-stokes", "gl", curved=True)
            timing[f"annulus {grid[0]}x{grid[1]}"] = {
                "ms": (ms[1] + ms[2]) / 2, "plain_ms": (ms[0] + ms[3]) / 2,
                "device_ms": kernel_ms(lambda: sw32(X32), "face_sweep"),
                "f64_ms": cuda_ms(lambda: sw64(X64), 50),
                "bound_ms": b[0], "bound_by": b[1], "ops_ms": b[2],
                "bytes_ms": b[3], "max_abs_err": float(torch.max(
                    torch.abs(k32 - p32))), "turns": ms}
            log(f"  timing {name} f32: {timing[f'annulus {grid[0]}x{grid[1]}']}")
        del tab64, tab32, sw64, sw32, X64, X32, y64, p64, k32, p32, ref
        torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"face sweep parity on curved / file meshes failed: "
                         f"{failures}")
    return timing


def restart_pair(deck, name, half, dev, reseed):
    """f64, step graphs: solver A runs `half` steps (its checkpoint copied
    aside), re-seeds its characteristic ghosts where `reseed` (as a
    restart read does) and runs `half` more; solver B reads the copy and
    runs `half`.  Returns max|U_A - U_B| / max|U_A| and the t difference."""
    import shutil

    a = deck_solver(deck, name, "", torch.float64, dev, perturb=False)
    a.config.max_iters = half
    a.solve()  # ends with a checkpoint
    src = os.path.join(a.config.outdir, "restart_output.sol.h5")
    copy_dir = a.config.outdir + "_copy"
    os.makedirs(copy_dir, exist_ok=True)
    shutil.copy(src, os.path.join(copy_dir, "restart_output.sol.h5"))
    if reseed:
        from tps_torch.dg.rhs import init_bc_states

        a._loop.load_bc_states(init_bc_states(a.ctx, a.tables, a._loop.U))
    a.config.max_iters = 2 * half
    a.solve()
    b = deck_solver(deck, name + "_b", "", torch.float64, dev, perturb=False)
    b.config.outdir = copy_dir
    b.read_restart()
    if b.iter != half:
        raise SystemExit(f"{name}: the restart read iteration {b.iter}")
    b.config.max_iters = 2 * half
    b.solve()
    if a._loop.graph is None or b._loop.graph is None:
        raise SystemExit(f"{name}: the steps did not go through the graph")
    return rel(b.U, a.U), abs(float(b.time) - float(a.time)) / float(a.time)


def phase_restart(dev):
    """A checkpoint continued on the card against a straight run (f64,
    step graphs): the cylinder deck at 12x48, 2 x 10 steps, and the 3-D
    file-mesh channel (8x4x4) with its nonReflectingPressure outlet, whose
    ghosts the read re-seeds from the restored state (the straight run
    re-seeds them at the same step)."""
    cyl = annulus_deck(12, 48, 20, "restart_cyl")
    chan, _, _ = file_channel_deck((8, 4, 4), 20, "restart_chan")
    failures = []
    for name, deck, reseed in (("cylinder 12x48", cyl, False),
                               ("file channel 8x4x4", chan, True)):
        dU, dt = restart_pair(deck, name.split()[0] + "_restart", 10, dev,
                              reseed)
        ok = dU <= RESTART_TOL and dt <= RESTART_TOL
        log(f"  {name}: 10 + checkpoint + 10 vs 20 straight: U {dU:.3e}, "
            f"t {dt:.3e} (bar {RESTART_TOL})" + ("" if ok else "  FAIL"))
        if not ok:
            failures.append(name)
    if failures:
        raise SystemExit(f"restart continuation failed: {failures}")


def phase_stateful_graph(dev):
    """The step graph against eager steps through solve() on the 3-D
    file-mesh channel (8x4x4) with its nonReflectingPressure outlet: f64,
    20 CFL steps; U, t and the outlet's ghost state."""
    chan, _, _ = file_channel_deck((8, 4, 4), 20, "graph_chan")
    out = {}
    for graphs in (True, False):
        s = deck_solver(chan, "graph_chan", "", torch.float64, dev)
        s.cuda_graphs = graphs
        s.solve()
        ghost = [g.clone() for g in s._loop.bc_states if g is not None]
        if len(ghost) != 1 or (s._loop.graph is not None) != graphs:
            raise SystemExit("stateful channel: no ghost state, or the "
                             "graph setting was not honoured")
        out[graphs] = (s.U.clone(), ghost[0], float(s.time))
    (Ug, gg, tg), (Ue, ge, te) = out[True], out[False]
    d = (rel(Ug, Ue), rel(gg, ge), abs(tg - te) / abs(te))
    ok = max(d) <= GRAPH_TOL
    log(f"  file channel with a nonReflectingPressure outlet, 20 steps: "
        f"graph vs eager U {d[0]:.3e}, ghost {d[1]:.3e}, t {d[2]:.3e} (bar "
        f"{GRAPH_TOL})" + ("" if ok else "  FAIL"))
    if not ok:
        raise SystemExit("step graph vs eager with a stateful outlet failed")


def phase_io_timing(s):
    """Seconds of one checkpoint write and one read of solver s (f32 state,
    stored in f64), best of three, and the file's bytes."""
    from tps_torch.io.restart import RestartIO

    io = RestartIO(s.config)
    w, r = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        io.write(s)
        w.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        io.read(s)
        torch.cuda.synchronize()
        r.append(time.perf_counter() - t0)
    size = os.path.getsize(io.path())
    res = {"write_s": min(w), "read_s": min(r), "bytes": size,
           "write_turns": w, "read_turns": r}
    log(f"  checkpoint of {s.tables_np.ne} elements p={s.config.order} "
        f"({size} B): write {res['write_s']:.4f} s, read {res['read_s']:.4f}"
        f" s (best of 3; turns {w}, {r})")
    return res


def phase_step_timing(cases, steps=4, profiled=4):
    """ms/step through solve() (f32), the step graph against eager steps,
    in turns eager, graph, chain, chain, graph, eager, `steps` steps a
    turn, host clock to a synchronize ("chain": the same integrator and
    RHS called in a bare loop with Python-float t and dt, as phase 10's
    chains, outside solve()); the device's busy share in a profiled graph
    chunk of `profiled` steps, and eager's from it (eager_busy); the
    capture's wall time
    and the graph pool's device memory.  The checkpoints solve() writes
    (every outputFreq and at its end) are left out: steps, not I/O (phase
    16 times the I/O)."""
    out = {}
    for name, s in cases.items():
        s.config.timing_freq = 10**9  # no timing print inside the turns
        s.write_restart = lambda: None

        def turn(graphs, n=steps):
            s.cuda_graphs = graphs
            s.config.max_iters = s.iter + n
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.solve()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n

        def chain(n=steps):
            U, dt = s.U.clone(), float(s.dt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                U = s._integrator(s._rhs, U, 0.0, dt)[0]
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n

        turn(True, 2)  # captures the graph where the solver has none
        ms = {True: [], False: [], "chain": []}
        for kind in (False, True, "chain", "chain", True, False):
            ms[kind].append(chain() if kind == "chain" else turn(kind))
        s.cuda_graphs = True
        prof = {"graph": device_share(lambda: s.solve_chunk(profiled), 1)}
        lp = s._loop
        dev_ms = prof["graph"].get("device_ms")
        prof["eager"] = eager_busy(None if dev_ms is None else dev_ms / profiled,
                                   float(np.mean(ms[False])))
        res = {"graph_ms_per_step": float(np.mean(ms[True])),
               "eager_ms_per_step": float(np.mean(ms[False])),
               "chain_ms_per_step": float(np.mean(ms["chain"])),
               "graph_turns": ms[True], "eager_turns": ms[False],
               "chain_turns": ms["chain"],
               "device_ms_per_step": (None if dev_ms is None
                                      else dev_ms / profiled),
               "capture_s": lp.capture_s, "pool_MiB": lp.pool_bytes / 2**20,
               "finite": bool(torch.isfinite(s.U).all()),
               "launches_per_step": lp.per_replay,
               "profile": {k: {kk: v[kk] for kk in ("wall_ms", "device_ms",
                                                    "busy_share")
                               if kk in v} or v
                           for k, v in prof.items()}}
        log(f"  {name}: ms/step graph {res['graph_ms_per_step']:.4f} "
            f"{ms[True]}, eager {res['eager_ms_per_step']:.4f} {ms[False]}, "
            f"bare chain {res['chain_ms_per_step']:.4f} {ms['chain']}; "
            f"device ms/step {res['device_ms_per_step']}; profiled chunk of "
            f"{profiled} {res['profile']}; capture {lp.capture_s:.3f} s, "
            f"pool {res['pool_MiB']:.1f} MiB")
        out[name] = res
    return out


def phase_slot_timing(setup, dev):
    """f32 NS, CUDA events, in turns plain, kernel, kernel, plain: the face
    sweep alone (50 calls, the plain one 10) and ms/RHS of the slot path
    (RK4 chains of 10 steps, through the plain sweep 2) through the kernel
    and through the plain sweep, on the flagship GLL deck's box and the
    walled GL box; the slot RHS's parts; launches per RHS."""
    from tps_torch.dg import cuda_faces
    from tps_torch.dg.cuda_faces import build_face_sweep, face_sweep_plain
    from tps_torch.dg.operators import dg_gradient
    from tps_torch.dg.rhs import SlotRHS, boundary_face_sweep
    from tps_torch.time.integrators import rk4

    out = {}
    for name, (n, order, basis, walls) in (
            ("gll_deck", ((16, 16, 16), 2, "gll", False)),
            ("walled_gl", ((16, 16, 16), 2, "gl", True))):
        tab_np = setup.tables(n, order, basis, walls)
        ctx = setup.ctx("navier-stokes", 3, tab_np if walls else None)
        tab = tab_np.to_torch(torch.float32, dev)
        sweep = build_face_sweep(tab, ctx)
        states = tuple(None for _ in ctx.bcs)
        rhs_k = SlotRHS(ctx, tab, sweep, states)
        rhs_p = SlotRHS(ctx, tab, functools.partial(face_sweep_plain, ctx, tab),
                        states)
        U = perturbed_U(ctx.mixture, tab_np.xyz_dof, torch.float32, dev)
        X = face_input(ctx, tab, U)

        def chain(f, steps):
            def run():
                x = U
                for _ in range(steps):
                    x = rk4(f, x, 0.0, 1e-7)[0]
                return x
            return run

        def turns(fp, fk, reps, plain_reps, per, plain_per):
            t = [cuda_ms(fp, plain_reps), cuda_ms(fk, reps),
                 cuda_ms(fk, reps), cuda_ms(fp, plain_reps)]
            return ((t[1] + t[2]) / 2 / per, (t[0] + t[3]) / 2 / plain_per,
                    t)

        # the host-bound plain version: 2-step chains and 10 sweeps
        ms_rhs, plain_rhs, t_rhs = turns(chain(rhs_p, 2), chain(rhs_k, 10),
                                         2, 2, 40, 8)
        ms_sw, plain_sw, t_sw = turns(lambda: sweep.plain(X), lambda: sweep(X),
                                      50, 10, 1, 1)
        Up = ctx.mixture.primitives(U)
        parts = {"gradient": cuda_ms(lambda: dg_gradient(tab, Up), 50),
                 "face_sweep": ms_sw}
        if walls:
            parts["boundary_slots"] = cuda_ms(
                lambda: boundary_face_sweep(ctx, tab, X, 0.0, states), 50)
        parts["rest"] = ms_rhs - sum(parts.values())
        cuda_faces.reset_launches()
        rhs_k(U)
        per_rhs = cuda_faces.launches["face_sweep"]
        busy = device_share(lambda: rhs_k(U))
        tab64 = tab_np.to_torch(torch.float64, dev)
        sweep64, X64 = build_face_sweep(tab64, ctx), X.double()
        f64_ms = cuda_ms(lambda: sweep64(X64), 50)
        dev_ms = kernel_ms(lambda: sweep(X), "face_sweep")
        log(f"  {name} {n} p={order} {basis}: ms/RHS kernel {ms_rhs:.4f}, "
            f"plain {plain_rhs:.4f} {t_rhs}; face sweep kernel {ms_sw:.4f} "
            f"(on the device {ms_text(dev_ms)}), "
            f"plain {plain_sw:.4f} {t_sw}; parts (ms, each timed alone; rest "
            f"= volume, inverse mass, RK, host gaps) {parts}; launches/RHS "
            f"{per_rhs}; profiled RHS {busy}; face sweep f64 {f64_ms:.4f} ms")
        out[name] = {"ms_per_rhs": ms_rhs, "plain_ms_per_rhs": plain_rhs,
                     "face_sweep_ms": ms_sw, "face_sweep_device_ms": dev_ms,
                     "face_sweep_plain_ms": plain_sw,
                     "face_sweep_f64_ms": f64_ms,
                     "parts_ms": parts, "launches_per_rhs": per_rhs,
                     "profile": busy, "tab": tab_np}
    return out


# ---------------------------------------------------------------- argon


def argon_ctx():
    """The shipped argon deck's plasma (physics/plasma_config.py) as a slot
    RHS context, 2-D."""
    from tps_torch.config.ini import IniInput
    from tps_torch.dg.fluxes import Fluxes
    from tps_torch.dg.rhs import RHSContext
    from tps_torch.dg.riemann import Rusanov
    from tps_torch.physics.plasma_config import build_plasma

    pl = build_plasma(IniInput.read(ARGON_DECK), 2, 2)
    fl = Fluxes(mixture=pl.mixture, transport=pl.transport)
    return RHSContext(fluxes=fl, riemann=Rusanov(fl))


def argon_U(mix, xyz, dtype, device):
    """A perturbed argon state on the deck's 0.01 m box: the deck's rho
    1.6 and u 10 with a wave, Th ~1,800 K, Te ~9,000 K and the ion
    fraction raised to ~1e-3 (the deck's 1e-7 leaves the diffusion and
    the electron terms negligible)."""
    k = 2 * np.pi / 0.01
    wave = np.sin(k * xyz[..., 0]) * np.cos(k * xyz[..., 1])
    Up = np.zeros(xyz.shape[:-1] + (mix.num_equations,))
    Up[..., 0] = 1.6 * (1 + 0.05 * wave)
    Up[..., 1], Up[..., 2] = 10.0 + 3.0 * wave, -2.0 * wave
    Up[..., 3] = 1800.0 * (1 + 0.05 * wave)
    Up[..., 4] = 1e-3 * 1.6 / mix.mw[0] * (1 + 0.2 * wave)
    Up[..., 5] = 9000.0 * (1 - 0.1 * wave)
    U = mix.conservatives(torch.as_tensor(Up, dtype=torch.float64))
    return U.to(dtype=dtype, device=device).contiguous()


ARGON_FACE_GRIDS = (((6, 6), 1, "gll"), ((32, 32), 2, "gl"),
                    ((32, 32), 2, "gll"), ((128, 128), 2, "gl"))


def argon_tables(n, order, basis):
    from tps_torch.dg.discretization import build_tables
    from tps_torch.mesh.generators import box_2d

    mesh = box_2d(*n, x1=0.01, y1=0.01, periodic_x=True, periodic_y=True)
    return build_tables(mesh, order, **({} if basis == "gl" else GLL))


def phase_argon_faces(dev):
    """The face sweep on the argon plasma against its plain version: the
    shipped 6x6 p=1 GLL mesh, 32x32 p=2 GL and GLL, 128x128 p=2 GL.  f64
    within 1e-11 of max|plain|; f32 by the rule of TOL (within 5e-5 of
    the plain f32 version, or no farther than twice its distance from the
    f64 plain result: the third-order electron conductivity cancels digits
    in float in either order).  Either failing on any grid fails the
    phase.  The f32 kernel timed on the GL grids (CUDA events and on the
    device) against the plain version, with the mixture's bound."""
    from tps_torch.dg.cuda_faces import build_face_sweep

    ctx = argon_ctx()
    failures, timing, max_err = [], {}, 0.0
    for n, order, basis in ARGON_FACE_GRIDS:
        t0 = time.perf_counter()
        tab_np = argon_tables(n, order, basis)
        tab64 = tab_np.to_torch(torch.float64, dev)
        tab32 = tab_np.to_torch(torch.float32, dev)
        sw64, sw32 = build_face_sweep(tab64, ctx), build_face_sweep(tab32, ctx)
        X64 = face_input(ctx, tab64, argon_U(ctx.mixture, tab_np.xyz_dof,
                                             torch.float64, dev))
        X32 = X64.float()
        y64, p64 = sw64(X64), sw64.plain(X64)
        r64 = rel(y64, p64)
        k32, p32 = sw32(X32), sw32.plain(X32)
        ref = sw64.plain(X32.double())
        r32 = rel(k32, p32)
        dk, dp = rel(k32.double(), ref), rel(p32.double(), ref)
        name = f"{n[0]}x{n[1]} p={order} {basis}"
        ok = (r64 <= TOL[torch.float64] and sw64.physics == "argon"
              and (r32 <= TOL[torch.float32] or dk <= 2 * dp))
        log(f"  {name} ({tab_np.ne} elements, nqf {tab_np.nqf}, k "
            f"{sw64.k}, tables {time.perf_counter() - t0:.1f} s): f64 "
            f"{r64:.3e} (bar {TOL[torch.float64]}); f32 {r32:.3e} (bar "
            f"{TOL[torch.float32]}, or f64 dist: kernel {dk:.3e} <= 2 x "
            f"plain {dp:.3e})" + ("" if ok else "  FAIL"))
        max_err = max(max_err, r64)
        if not ok:
            failures.append(name)
        if basis == "gl" and order == 2:
            ms = [cuda_ms(lambda: sw32.plain(X32), 5), cuda_ms(lambda: sw32(X32), 50),
                  cuda_ms(lambda: sw32(X32), 50), cuda_ms(lambda: sw32.plain(X32), 5)]
            b = face_bound(tab_np, "navier-stokes", "gl", argon=True)
            timing[f"argon {n[0]}x{n[1]}"] = {
                "ms": (ms[1] + ms[2]) / 2, "plain_ms": (ms[0] + ms[3]) / 2,
                "device_ms": kernel_ms(lambda: sw32(X32), "face_sweep"),
                "f64_ms": cuda_ms(lambda: sw64(X64), 50),
                "f64_device_ms": kernel_ms(lambda: sw64(X64), "face_sweep"),
                "bound_ms": b[0], "bound_by": b[1], "ops_ms": b[2],
                "bytes_ms": b[3], "max_abs_err": float(torch.max(
                    torch.abs(k32 - p32))), "f32_rel": r32,
                "f32_f64_dist": dk, "plain_f32_f64_dist": dp, "turns": ms}
            log(f"  timing {name} f32: {timing[f'argon {n[0]}x{n[1]}']}")
        del tab64, tab32, sw64, sw32, X64, X32, y64, p64, k32, p32, ref
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    if failures:
        raise SystemExit(f"face sweep parity on the argon plasma failed: "
                         f"{failures}")
    return timing, max_err


def argon_cli(dtype, outdir):
    """The shipped argon deck through the harness (as `python -m tps_torch
    --runFile examples/cases/argon_plasma_2d.ini`), in dtype, its output
    in build/<outdir> (the deck names /tmp)."""
    from tps_torch import harness

    torch.set_default_dtype(dtype)
    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", ARGON_DECK])
    tps.parse_input()
    tps.config.outdir = os.path.join(REPO, "build", outdir)
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    return tps


def golden_diffs(ckpt):
    """The checkpoint against ARGON_GOLDEN by GOLDEN_TOL (read with
    io/h5lite.py): {dataset: (worst difference, tolerance)}."""
    from tps_torch.io import h5lite

    a, b = h5lite.read(ckpt)["solution"], h5lite.read(ARGON_GOLDEN)["solution"]
    out = {}
    for name, (tol, relative) in GOLDEN_TOL.items():
        x, y = np.asarray(a[name]), np.asarray(b[name])
        d = np.abs(x - y)
        if relative:
            d = np.where(np.abs(x) > 0, d / np.where(x != 0, np.abs(x), 1), d)
        out[name] = (float(d.max()), tol)
    return out


def phase_argon_cli():
    """The shipped argon deck through the CLI on the card, as shipped (f32,
    4 RK4 steps): 16 face-sweep launches and none of K1/K2, every step a
    graph replay; finite, the ion density >= 0, p near its 101,300 Pa.
    Then the same deck in f64 through the API: its checkpoint against the
    committed golden at test_golden_argon_regression's tolerances."""
    tps = argon_cli(torch.float32, "argon_cli")
    s = tps.solver
    U0 = s.state_global().copy()
    reset_all_launches()
    t0 = time.perf_counter()
    tps.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = all_launches()
    U = s.state_global()
    p = s.mixture.pressure(s.U).double().cpu().numpy()
    dp = float(np.max(np.abs(p / 101300.0 - 1.0)))
    log(f"  {type(s._rhs).__name__}, {s.tables_np.ne} elements, k "
        f"{s._rhs.sweep.k}: {s.iter} steps in {wall:.2f} s; launches "
        f"{counts}; step graph captured in {s._loop.capture_s:.3f} s; "
        f"max|p/101300 - 1| {dp:.3e}; min rho Y_Ar+ "
        f"{float(U[..., 4].min()):.3e}; moved {rel(s.U, torch.as_tensor(U0, device=s.U.device)):.3e}")
    if (tps.get_status() != 0 or s.iter != 4 or counts["face_sweep"] != 16
            or counts["k1_gradient"] or counts["k2_faces_volume"]
            or s._loop.graph is None):
        raise SystemExit("argon deck: not 16 face-sweep launches through the "
                         "graph, or K1/K2 launched")
    if not (np.all(np.isfinite(U)) and U[..., 4].min() >= 0 and dp < 1e-4):
        raise SystemExit("argon deck: non-finite, negative species or p off")
    tps64 = argon_cli(torch.float64, "argon_f64")
    tps64.solve()
    diffs = golden_diffs(os.path.join(tps64.solver.config.outdir,
                                      "restart_output.sol.h5"))
    ok = all(d <= tol for d, tol in diffs.values())
    log(f"  f64 checkpoint vs {os.path.relpath(ARGON_GOLDEN, REPO)}: "
        + ", ".join(f"{k} {d:.3e} (bar {t})" for k, (d, t) in diffs.items())
        + ("" if ok else "  FAIL"))
    if not ok:
        raise SystemExit("argon deck: f64 checkpoint off the golden")
    return counts, {"dp_rel": dp, "golden": diffs}


def argon_big_deck(n, cfl, iters, name, dt_fixed=None):
    """bench.py::bench_argon_big's deck (bench.py:450-461: the shipped deck
    at n x n p=2, GL, cfl 0.02) at n, cfl and iters steps, output in
    build/<name>, with a fixed dt where given."""
    with open(ARGON_DECK) as f:
        text = f.read()
    text = text.replace("nx = 6", f"nx = {n}").replace("ny = 6", f"ny = {n}")
    text = text.replace("order = 1", "order = 2")
    text = text.replace("outputFreq = 100",
                        "outputFreq = 100000\ntimingFreq = 100000\n"
                        "basisType = 0\nintegrationRule = 0")
    text = text.replace("cfl = 0.1", f"cfl = {cfl}")
    text = text.replace("maxIters = 4", f"maxIters = {iters}")
    if dt_fixed:
        text = text.replace("[time]\n", f"[time]\ndt_fixed = {dt_fixed}\n")
    text = text.replace("outdirBase = /tmp/tps_tpu_argon_output",
                        f"outdirBase = {os.path.join(REPO, 'build', name)}")
    path = os.path.join(REPO, "build", name + ".ini")
    with open(path, "w") as f:
        f.write(text)
    return path


def argon_solver(path, dtype, perturb):
    from tps_torch import harness

    torch.set_default_dtype(dtype)
    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", path])
    tps.parse_input()
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    s = tps.solver
    if perturb:
        s.set_state_global(argon_U(s.mixture, s.tables_np.xyz_dof,
                                   torch.float64, "cpu").numpy())
    return s


def phase_argon_solver(dev):
    """bench_argon_big's deck (32x32 p=2 GL) in f64 from the perturbed
    state: the solver (face-sweep kernel, step graph) against a plain RK4
    loop over compute_rhs with the plain face sweep and the species clip,
    20 fixed-dt steps; then the step graph against eager steps in CFL
    mode, 20 steps."""
    from tps_torch.dg.cuda_faces import face_sweep_plain
    from tps_torch.dg.operators import _clip_species
    from tps_torch.dg.rhs import compute_rhs
    from tps_torch.time.integrators import rk4

    dt = 9.0e-9  # about the deck's CFL dt (cfl 0.02)
    s = argon_solver(argon_big_deck(32, 0.02, 20, "argon_fixed", dt),
                     torch.float64, True)
    U0 = s.U.clone()
    reset_all_launches()
    s.solve()
    counts = all_launches()
    U_solver = s.U.clone()
    plain = functools.partial(face_sweep_plain, s.ctx, s.tables)

    def rhs(U, t):
        return compute_rhs(s.ctx, s.tables, U, t, sweep=plain)

    U, t = U0, 0.0
    for _ in range(20):
        U = _clip_species(s.mixture, rk4(rhs, U, t, dt)[0])
        t += dt
    err, moved = rel(U_solver, U), rel(U_solver, U0)
    log(f"  20 steps: max|U_kernel - U_plain|/max|U_plain| = {err:.3e} "
        f"(bar {SOLVER_TOL}); moved {moved:.3e}; launches {counts}")
    if not err <= SOLVER_TOL or not moved > 0 or counts["face_sweep"] != 80:
        raise SystemExit("argon solver vs plain RK4 loop failed")
    cfl = argon_solver(argon_big_deck(32, 0.02, 20, "argon_cfl"),
                       torch.float64, True)
    diffs = graph_vs_eager(cfl, cfl.U.clone(), float(cfl.dt))
    ok = max(diffs) <= GRAPH_TOL
    log(f"  CFL: graph vs eager, {cfl.iter} steps: U {diffs[0]:.3e}, t "
        f"{diffs[1]:.3e}, dt {diffs[2]:.3e} (bar {GRAPH_TOL})"
        + ("" if ok else "  FAIL"))
    if not ok:
        raise SystemExit("argon step graph vs eager failed")
    return {"solver_vs_plain": err, "graph_vs_eager": diffs}


def kernel_ms(fn, name, n=50):
    """Device ms per call of the kernels named `name` that fn launches:
    their intervals on the device under torch.profiler over n calls, the
    host's launch cost excluded (a small kernel's wrapper can take longer
    on the host than the kernel on the device).  None (not measured) where
    three profiled runs record no such kernel (a run now and then records
    none)."""
    for _ in range(3):
        prof = device_share(fn, n)
        ms = sum(v for k, v in prof.get("top_ms", {}).items() if name in k)
        if ms > 0:
            return ms
    log(f"  {name}: no device time from the profiler ({prof}): not measured")
    return None


def ms_text(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def device_share(fn, n=8):
    """torch.profiler over n calls of fn: wall ms per call (profiler on),
    device ms per call (the kernels' own intervals on the device; one
    stream, so they do not overlap), the device's busy share and the top
    kernels by device time; "not measured" where the profiler records no
    kernel or fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                us = e.time_range.elapsed_us()
                by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3 / n
    except Exception as exc:  # a measurement, not a check: report it
        return {"not measured": repr(exc)}
    dev = sum(by_name.values())
    if dev <= 0:
        return {"not measured": "no kernel recorded"}
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:6]
    launches = sum(1 for e in prof.events()
                   if e.device_type == DeviceType.CUDA) / n
    return {"wall_ms": wall, "device_ms": dev, "busy_share": dev / wall,
            "kernels": len(by_name), "launches": launches,
            "top_ms": {k[:60]: v for k, v in top}}


def eager_busy(device_ms, eager_ms):
    """An eager step's busy share: a profiled graph step's device ms (the
    same kernels) over the eager turns' ms a step.  Profiling an eager
    step of 10-20 thousand launches costs seconds of event processing on
    the host."""
    return {"busy_share": None if device_ms is None else device_ms / eager_ms}


# ---------------------------------------------------------------- bounds


def bound(ops, nbytes, dtype=torch.float32):
    """(bound_ms, bound_by, ops_ms, bytes_ms): the larger of the operations
    over the card's peak rate for their type and the bytes over its memory
    rate, and both."""
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes), by, t_ops, t_bytes


# The operations are the least that the function needs on this run's data,
# not what the kernels do.  On the generator boxes' hexahedra every trace,
# scatter and derivative is a tensor product of 1-D matrices, applied one
# axis at a time (sum factorisation), and the boxes are axis-aligned, so
# each physical direction is one reference direction and a face's normal
# has one non-zero component.  In a 1-D matrix a zero entry costs nothing,
# and so does a row that copies one value (a node that is also a point: on
# the Gauss-Lobatto basis the face's nodes are its trace).  Each face's
# trace is counted once (the neighbour's trace of a face is that
# neighbour's own trace, counted on its side), and so is each face's flux.


def _fma_1d(A):
    """Multiply-adds of y = A x for a 1-D matrix A: the non-zero entries of
    every row that does not just copy one value."""
    nz = np.abs(A) > 1e-12 * np.abs(A).max()
    copy = (nz.sum(1) == 1) & np.isclose(A.sum(1), 1.0)
    return int(nz[~copy].sum())


def tensor_fma(t, basis, curved=False):
    """(trace, deriv): multiply-adds per channel of one face trace (or its
    transpose, the scatter to the nodes) and of the derivative along one
    axis at the nodes, on tables t of a box on `basis` ("gl" or "gll",
    nodes and face points of that family); `curved`: quads or hexes of any
    shape (the trace is a reference-element operator all the same)."""
    from tps_torch.mesh.reference_element import (gauss_legendre_1d,
                                                  gauss_lobatto_1d,
                                                  lagrange_deriv, lagrange_eval)

    nor = np.abs(np.asarray(t.nor_slot))  # [ne, nlf, nqf, dim]
    if not curved and np.any(
            np.count_nonzero(nor > 1e-12 * nor.max(), axis=-1) != 1):
        raise SystemExit("bounds: the box is not axis-aligned")
    rule = gauss_legendre_1d if basis == "gl" else gauss_lobatto_1d
    n1, dim = t.order + 1, t.dim
    mf = round(t.nqf ** (1.0 / (dim - 1)))
    nodes = rule(n1)[0]
    to_face = _fma_1d(lagrange_eval(nodes, np.array([0.0])))
    interp = _fma_1d(lagrange_eval(nodes, rule(mf)[0]))
    on_face = n1 * interp + mf * interp if dim == 3 else interp
    trace = n1 ** (dim - 1) * to_face + on_face
    deriv = n1 ** (dim - 1) * _fma_1d(lagrange_deriv(nodes, nodes))
    return trace, deriv


def k1_bound(t, basis="gl", size=4):
    """K1 on tables t: per element the primitives, the volume derivative of
    each of 5 primitives along each axis, per slot the 5 own traces and
    the lift of the jump along the normal's axis; per face the jump;
    the diagonal inverse mass.  U in, G out, the folds."""
    ne, nd, nq, nlf, dim = t.ne, t.ndof, t.nqf, t.nlf, t.dim
    trace, deriv = tensor_fma(t, basis)
    fma = ne * (5 * dim * deriv + nlf * 5 * 2 * trace)
    ops = 2 * fma + ne * (nd * PRIM_OPS + nlf * nq * 5 + nd * 5 * dim)
    nbytes = size * (ne * nd * 5 + ne * nd * 15 + (1 + nlf) * 3 * nd * nd)
    return bound(ops, nbytes)


def k2_bound(t, basis="gl", size=4):
    """K2 on tables t (NS): per element the volume flux and its weak
    divergence, per slot the own traces of U and G (20 channels) and the
    scatter of 5, per face the flux, the diagonal inverse mass.  U and G
    in, y and the per-element max out, the folds."""
    ne, nd, nq, nlf, dim = t.ne, t.ndof, t.nqf, t.nlf, t.dim
    trace, deriv = tensor_fma(t, basis)
    fma = ne * (5 * dim * deriv + nlf * (20 + 5) * trace)
    ops = 2 * fma + ne * (nd * (VOLUME_OPS + 5)
                          + nlf * nq * FACE_OPS["navier-stokes"] // 2)
    nbytes = size * (ne * nd * 20 + ne * nd * 5 + ne + 3 * nd * nd
                     + 2 * nlf * nq * nd + nlf * nq * 3)
    return bound(ops, nbytes)


def face_bound(t, eq, basis, size=4, curved=False, argon=False, neq=None,
               flux_ops=None, axi=False, slot_arrays=0, delta=False):
    """The face sweep on tables t: per interior slot the own traces of X's
    k channels and the scatter of neq, per interior face the flux.  X in,
    the result out, the normals, nbr_row, the mask and Btr_or (`axi`:
    and the slot points' radii; `slot_arrays` more such per-point arrays,
    the closures' sponge weights and wall distances; `delta`: the element
    length scales, own and neighbours').  `argon`: the plasma's 6
    equations (k = 18) and MIX_FACE_OPS (2-D, NS); a mixture variant
    gives its neq and flux operations per point (MIX_OPS)."""
    ne, nd, nq, nlf, dim = t.ne, t.ndof, t.nqf, t.nlf, t.dim
    if neq is None:
        neq = dim + 4 if argon else dim + 2
        flux_ops = MIX_FACE_OPS if argon else None
    k = neq if eq == "euler" else neq * (1 + dim)
    trace, _ = tensor_fma(t, basis, curved)
    slots = int(np.count_nonzero(np.asarray(t.interior_mask)))
    flux = (slots * nq * flux_ops // 2 if flux_ops is not None
            else slots * nq * FACE_OPS[eq] * neq // 5 // 2)
    ops = 2 * slots * (k + neq) * trace + flux
    nbytes = (size * (ne * nd * k + ne * nd * neq + nlf * ne * nq * dim
                      + ne * nlf + t.n_combo * nq * nd
                      + (int(axi) + slot_arrays) * ne * nlf * nq
                      + (ne * (1 + nlf) if delta else 0)) + 4 * ne * nlf)
    return bound(ops, nbytes)


# What the kernels' designs do (csrc/dg_face_stage.cuh), counted from
# their loops: per face, both traces (RS = 4 face points per thread, the
# last group padded) over the face's support (the nodes its trace rows
# touch), the scatter over the support; K2 also the volume scatter.
# Achieved rate: 2 x FMA / time, as a share of the f32 peak (67 TFLOP/s).


def face_supports(t):
    """Nodes each local face's trace rows touch (non-zero columns)."""
    B = np.asarray(t.Btr).reshape(t.nlf, t.nqf, t.ndof)
    return (B != 0).any(axis=1).sum(axis=1)


def design_fma(t, k, volume):
    """FMAs of K2 (volume=True; k = 20 channels for NS) or the face sweep
    (k channels of X) on tables t."""
    neq = t.dim + 2
    nk = face_supports(t)
    rows = -(-t.nqf // 4) * 4
    per = int(nk.sum()) * (2 * rows * k + t.nqf * neq)
    if volume:
        per += t.dim * t.ndof * t.ndof * neq
    return t.ne * per


def k1_design_fma(t):
    """FMAs of K1 on tables t: per element and group of its compressed
    folds, every column times every row times 5 primitives (the zeros a
    group's block holds included)."""
    from tps_torch.dg.cuda_fused import gradient_groups, kernel_folds

    ngroup, ncol, nrow = gradient_groups(kernel_folds(t)["Wgrad"])["vals"].shape
    return t.ne * ngroup * ncol * nrow * 5


def rate_line(name, fma, ms, device_ms, b):
    """The achieved f32 rate and time/bound by CUDA events (ms) and by the
    device time alone (device_ms)."""
    def part(t):
        share = 2 * fma / (t * 1e-3) / PEAK_OPS[torch.float32]
        return (f"{t:.4f} ms: {share:.1%} of 67 TFLOP/s, time/bound "
                f"{t / b[0]:.1f}")

    return (f"  {name}: {fma / 1e6:.1f} M FMA by design; CUDA events "
            f"{part(ms)}; on the device "
            + ("not measured" if device_ms is None else part(device_ms)))


# ---------------------------------------------------------------- low-Mach

TGV_DECK = os.path.join(REPO, "tests", "inputs", "lomach_tgv2d.ini")
CHANNEL_DECK = os.path.join(REPO, "examples", "cases", "channel_rans.ini")
# f64, card against the CPU: the same operations, summed in another order
# by the card's libraries (1e-16..1e-15 expected); CG to the relative
# tolerance 1e-12 on both, so its solver noise, not rounding, sets 1e-10
H1_OP_TOL = 1e-12
H1_CG_TOL = 1e-10
# f64, a deck's final state on the card against the port's CPU run of the
# same deck, relative to max|u| (each field to its own max): every solve
# runs to 1e-12, so solver noise sets the bound
LOMACH_CPU_TOL = 1e-9
# the 3-D heated channel of phases 23-24 (24x12x12 p=2, p-multigrid)
HEATED_CHANNEL = os.path.join(REPO, "tps_torch", "tools",
                              "heated_channel3d.ini")


def lrel(a, b):
    """max|a - b| / max|b|, or max|a - b| where b is all zeros (the
    shipped channel deck's fluid stays at rest)."""
    a, b = a.double().cpu(), b.double().cpu()
    d, m = float((a - b).abs().max()), float(b.abs().max())
    return d / m if m > 0 else d


def lomach_tps(deck, dtype, outdir, device="cuda", iters=None, keys=None):
    """A low-Mach deck through the harness, as `python -m tps_torch
    --runFile deck [--device cpu]` does, in dtype, its output in
    build/<outdir>; `iters` and `keys` change ini values."""
    from tps_torch import harness

    torch.set_default_dtype(dtype)
    tps = harness.Tps()
    tps.parse_command_line_args(
        ["tps", "--runFile", deck] + ([] if device == "cuda"
                                      else ["--device", "cpu"]))
    tps.parse_input()
    tps.config.outdir = os.path.join(REPO, "build", outdir)
    raw = tps.config.raw
    if iters is not None:
        raw.values["loMach/maxIters"] = str(iters)
    for k, v in (keys or {}).items():
        raw.values[k] = v
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    return tps


def h1_case(kind, dev):
    """2-D 16x16 p=3 or 3-D 8^3 p=2 boxes: (mesh, numpy tables, card
    tables, CPU tables), f64."""
    from tps_torch.fem import h1
    from tps_torch.mesh.generators import box_2d, box_3d

    mesh, order = (box_2d(16, 16), 3) if kind == "2d" else (box_3d(8, 8, 8), 2)
    tab = h1.build_h1(mesh, order)
    return (mesh, tab, tab.to_torch(torch.float64, dev),
            tab.to_torch(torch.float64, "cpu"))


def h1_inputs(tab, seed, dev):
    rng = np.random.default_rng(seed)
    nd, ne, nq, dim = tab.ndofs, tab.ne, tab.nq, tab.dim
    x = {"u": rng.standard_normal(nd), "V": rng.standard_normal((nd, dim)),
         "c": 1.0 + rng.random(nd), "cq": 1.0 + rng.random((ne, nq)),
         "re": rng.standard_normal((ne, tab.ndof_el, 2)),
         "mc": rng.random((dim, ne, nq)), "dc": rng.random((dim, ne, nq)),
         "Kq": rng.random((ne, nq, dim, dim))}
    return {k: torch.as_tensor(v, dtype=torch.float64, device=dev)
            for k, v in x.items()}


def h1_operators():
    """Module 2 of fem/h1.py: name -> f(tab, inputs)."""
    from tps_torch.fem import h1

    return {
        "gather": lambda t, x: h1.gather(t, x["V"]),
        "scatter_add": lambda t, x: h1.scatter_add(t, x["re"]),
        "to_quad": lambda t, x: h1.to_quad(t, x["u"]),
        "weak_grad": lambda t, x: h1.weak_grad(t, x["u"], x["c"]),
        "mass_apply": lambda t, x: h1.mass_apply(t, x["u"], x["cq"]),
        "mass_apply (k=dim)": lambda t, x: h1.mass_apply(t, x["V"], x["c"]),
        "diffusion_apply": lambda t, x: h1.diffusion_apply(t, x["u"], x["c"]),
        "diffusion_apply (k=dim)":
            lambda t, x: h1.diffusion_apply(t, x["V"], x["cq"]),
        "mass_lumped_diag": lambda t, x: h1.mass_lumped_diag(t, x["c"]),
        "mass_diag": lambda t, x: h1.mass_diag(t, x["cq"]),
        "stiffness_diag": lambda t, x: h1.stiffness_diag(t, x["c"]),
        "convection_apply":
            lambda t, x: h1.convection_apply(t, x["u"], x["V"]),
        "weak_divergence": lambda t, x: h1.weak_divergence(t, x["V"], x["c"]),
        "grad_at_dofs": lambda t, x: h1.grad_at_dofs(t, x["u"]),
        "divergence_at_dofs": lambda t, x: h1.divergence_at_dofs(t, x["V"]),
        "integrate": lambda t, x: h1.integrate(t, x["c"]),
        "surface_normal_form":
            lambda t, x: h1.surface_normal_form(t, x["V"]),
        "helmholtz_apply_multi": lambda t, x: h1.helmholtz_apply_multi(
            t, x["V"], 3.0, x["mc"], x["dc"]),
        "diffusion_apply_tensor":
            lambda t, x: h1.diffusion_apply_tensor(t, x["u"], x["Kq"]),
        "grid_scale_q": lambda t, x: h1.grid_scale_q(t, t.order),
    }


def h1_solves(mesh, tab_np, tab, x):
    """The masked Helmholtz system (v, u) + (grad v, c grad u), Dirichlet
    on the whole boundary, b random, under each preconditioner, and the
    consistent-mass projection: name -> (x, iterations)."""
    from tps_torch.fem import h1

    dt, dev = tab.wq.dtype, tab.wq.device
    mask = torch.ones(tab.ndofs, dtype=dt, device=dev)
    mask[torch.as_tensor(h1.boundary_dofs(tab_np).astype(np.int64),
                         device=dev)] = 0.0
    c, b = x["c"], x["u"] * mask

    def apply(v):
        return h1.diffusion_apply(tab, v, c) + h1.mass_apply(tab, v)

    def app_m(v):
        return apply(v * mask) * mask + v * (1.0 - mask)

    diag = (h1.stiffness_diag(tab, c) + h1.mass_lumped_diag(tab)) * mask \
        + (1.0 - mask)
    tab_c_np = h1.build_h1(mesh, 1)
    tab_c = tab_c_np.to_torch(dt, dev)
    P = h1.PInterp.from_numpy(*h1.build_p_interp(tab_np, tab_c_np, mesh),
                              tab_c_np.ndofs, dt, dev)
    cc, mc = c[P.c2f], mask[P.c2f]

    def app_c(v):
        out = h1.diffusion_apply(tab_c, v * mc, cc) \
            + h1.mass_apply(tab_c, v * mc)
        return out * mc + v * (1.0 - mc)

    diag_c = (h1.stiffness_diag(tab_c, cc) + h1.mass_lumped_diag(tab_c)) \
        * mc + (1.0 - mc)
    K = h1.assemble_dense(tab, h1.element_stiffness(tab, c)
                          + h1.element_mass(tab))
    L = h1.dense_cholesky(h1.dense_constrain(K, mask=mask))
    preconds = {
        "jacobi": None,
        "chebyshev": h1.chebyshev_precond(app_m, diag, degree=3),
        "p-multigrid": h1.pmg_precond(app_m, diag, app_c, diag_c, P),
        "dense direct": h1.direct_precond(L),
    }
    out = {}
    for name, M in preconds.items():
        xs, it, _res = h1.cg_solve(apply, b, diag=diag, dirichlet_mask=mask,
                                   M=M, tol=1e-12, maxiter=1000,
                                   return_info=True)
        out[name] = (xs, int(it))
    xs, it, _res = h1.cg_solve(
        lambda v: h1.mass_apply(tab, v, c), h1.mass_apply(tab, x["u"]),
        diag=h1.mass_diag(tab, c), tol=1e-12, maxiter=60, return_info=True)
    out["l2_project (Jacobi)"] = (xs, int(it))
    return out


def phase_h1(dev):
    """Phase 21: every operator of fem/h1.py's module 2 on the card against
    the same function on the CPU (f64, to 1e-12 of max|y|), twice on the
    card with equal bits; CG under each preconditioner (to 1e-10, equal
    iteration counts), twice on the card with equal bits."""
    worst = {}
    for kind in ("2d", "3d"):
        mesh, tab_np, tcard, tcpu = h1_case(kind, dev)
        xg, xc = h1_inputs(tab_np, 5, dev), h1_inputs(tab_np, 5, "cpu")
        bad = []
        for name, f in h1_operators().items():
            y1, y2, yc = f(tcard, xg), f(tcard, xg), f(tcpu, xc)
            e = lrel(y1.cpu(), yc)
            worst[name] = max(worst.get(name, 0.0), e)
            if not (torch.equal(y1, y2) and e <= H1_OP_TOL):
                bad.append((name, e, torch.equal(y1, y2)))
        card, card2 = h1_solves(mesh, tab_np, tcard, xg), \
            h1_solves(mesh, tab_np, tcard, xg)
        cpu = h1_solves(mesh, tab_np, tcpu, xc)
        its = {}
        for name in card:
            (xs, it), (xs2, it2), (xr, itr) = card[name], card2[name], \
                cpu[name]
            e = lrel(xs.cpu(), xr)
            its[name] = (it, itr)
            worst[f"cg {name}"] = max(worst.get(f"cg {name}", 0.0), e)
            if not (e <= H1_CG_TOL and it == itr and it2 == it
                    and torch.equal(xs, xs2)):
                bad.append((f"cg {name}", e, it, itr))
        log(f"  {kind} {tab_np.ndofs} dofs p={tab_np.order}: CG iterations "
            f"card/CPU {its}")
        if bad:
            raise SystemExit(f"phase 21: the card's H1 path differs: {bad}")
    log("  worst card vs CPU (relative to max|y|; CG to max|x|), every "
        "operator and solve bitwise repeatable on the card: "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    return worst


def tgv_energy(s):
    from tps_torch.fem import h1

    return float(h1.integrate(s.tab, torch.sum(s.flow.u ** 2, -1)))


def zeta_checks(z, y):
    """test_zeta_model.py's checks on zeta-f fields (walls at y = 0 and
    1): positive, realizable, f = 0 at the walls; returns (passed, nu_t/k
    near the walls over nu_t/k in the core)."""
    k, eps, v2, f = (a.double().cpu().numpy() for a in (z.k, z.eps, z.v2,
                                                        z.f))
    nut = z.eddy_viscosity().double().cpu().numpy()
    wall = (y < 1e-12) | (y > 1.0 - 1e-12)
    near, core = (y < 0.15) & ~wall, (y > 0.2) & (y < 0.8)
    ok = ((k > 0).all() and (eps > 0).all() and (v2 > 0).all()
          and (v2 <= (2.0 / 3.0) * k * (1 + 1e-6) + 1e-14).all()
          and np.abs(f[wall]).max() == 0.0 and np.isfinite(nut).all())
    return ok, float((nut[near] / k[near]).mean()
                     / (nut[core] / k[core]).mean())


def sheared_zeta(dev, steps=60):
    """test_zeta_model.py's test_zeta_channel_growth_and_wall_damping on
    the card (f64): a periodic channel under a frozen parabolic profile,
    60 steps; nu_t/k near the walls below half its core value."""
    from tps_torch.fem import h1
    from tps_torch.mesh.generators import box_2d
    from tps_torch.solvers.lomach.base import (ConstantPropertyThermoChem,
                                               TemporalCoefficients)
    from tps_torch.solvers.lomach.zeta_model import ZetaModel

    tab_np = h1.build_h1(box_2d(12, 4, x1=1.0, y1=1.0, periodic_x=True), 2)
    tab = tab_np.to_torch(torch.float64, dev)
    y = tab.xyz[:, 1]

    class Frozen:
        def velocity(self):
            return torch.stack([40.0 * y * (1.0 - y), torch.zeros_like(y)], -1)

    zm = ZetaModel(tab, Frozen(), ConstantPropertyThermoChem(tab, 1.0, 1e-3),
                   wall_attrs=(1, 3), tke_ic=1e-2, tdr_ic=1e-2)
    for i in range(steps):
        zm.step(TemporalCoefficients.bdf(min(i + 1, 2)), 5e-3)
    return zeta_checks(zm, tab_np.xyz[:, 1])


def lomach_f64_run(name, device):
    """Phase 22's f64 run of the TGV ("tgv") or channel_rans ("channel")
    deck as shipped on device: its final fields on the CPU."""
    tps = lomach_tps(TGV_DECK if name == "tgv" else CHANNEL_DECK,
                     torch.float64, f"lomach_{name}_{device}", device=device)
    tps.solve()
    s = tps.solver
    st = {"u": s.flow.u, "p": s.flow.p, "nu_t": s.turb.eddy_viscosity()}
    if name == "channel":
        st.update(k=s.turb.k, eps=s.turb.eps, v2=s.turb.v2)
    return {k: v.double().cpu() for k, v in st.items()}


def phase_lomach_decks(dev, refs):
    """Phase 22: tests/inputs/lomach_tgv2d.ini (40 steps) and
    examples/cases/channel_rans.ini (200 steps) as shipped through the
    CLI on the card (f32), each constant-order step a graph replay: the
    TGV's energy decays as exp(-4 nu t) (test_lomach.py's bar), the
    channel's zeta-f fields stay positive and realizable with f = 0 at
    the walls, its checkpoint (every outputFreq 50) reads back through
    h5lite; then both decks through the API in f64, on the card and on
    the CPU (the CPU runs in refs' worker): the final states within
    LOMACH_CPU_TOL."""
    from tps_torch.io import h5lite

    out = {}
    tps = lomach_tps(TGV_DECK, torch.float32, "lomach_tgv")
    s = tps.solver
    ke0 = tgv_energy(s)
    t0 = time.perf_counter()
    tps.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    decay = abs(np.sqrt(tgv_energy(s) / ke0) - np.exp(-2 * 0.01 * s.time))
    g = list(s._graphs.values())
    log(f"  TGV f32: {s.iter} steps in {wall:.2f} s, {len(g)} step graph "
        f"({g[0].graphs if g else 0} graphs: segments and CG blocks), host "
        f"reads {s.loops.reads + s.info_reads}; |sqrt(KE/KE0) - "
        f"exp(-2 nu t)| = {decay:.2e} (bar 2e-3); last solves "
        f"{s.info_log[-1]}")
    if tps.get_status() != 0 or s.iter != 40 or not g or decay >= 2e-3:
        raise SystemExit("TGV deck: not 40 steps through the step graph, "
                         "or the decay is off")
    out["tgv f32"] = {"decay_err": decay, "wall_s": wall}

    tps = lomach_tps(CHANNEL_DECK, torch.float32, "lomach_channel")
    s = tps.solver
    t0 = time.perf_counter()
    tps.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ok, ratio = zeta_checks(s.turb, s.tab_np.xyz[:, 1])
    ck = h5lite.read(os.path.join(s.outdir, "restart_lomach.sol.h5"))
    layout = (sorted(ck["solution"]) == ["eddy_viscosity", "pressure",
                                          "velocity"]
              and int(ck.attrs["iteration"]) == 200
              and ck["solution"]["velocity"].shape == (s.tab.ndofs, 2))
    log(f"  channel f32: {s.iter} steps in {wall:.2f} s, host reads "
        f"{s.loops.reads + s.info_reads}; zeta-f fields positive, "
        f"realizable, f = 0 at the walls: {ok}; nu_t/k near the walls / "
        f"core {ratio:.3f} (at rest: no shear); checkpoint layout {layout}; "
        f"last solves {s.info_log[-1]}")
    if tps.get_status() != 0 or s.iter != 200 or not (ok and layout
                                                     and ratio < 1.0):
        raise SystemExit("channel deck: zeta-f checks or checkpoint failed")
    ok, ratio = sheared_zeta(dev)
    log(f"  zeta-f under shear (test_zeta_model.py's case, f64, 60 steps): "
        f"checks {ok}, nu_t/k near the walls / core {ratio:.3f} (bar 0.5)")
    if not (ok and ratio < 0.5):
        raise SystemExit("zeta-f under shear: wall damping failed")
    out["channel f32"] = {"wall_s": wall, "damping": ratio}

    for name in ("tgv", "channel"):
        card = lomach_f64_run(name, "cuda")
        cpu = refs.get(f"lomach {name}")
        umax = float(cpu["u"].abs().max())
        dists = {"u": float((card["u"] - cpu["u"]).abs().max())
                 / max(umax, 1e-300)}
        dists.update({k: lrel(card[k], cpu[k]) for k in card if k != "u"})
        ok = all(v <= LOMACH_CPU_TOL for v in dists.values()) \
            if umax > 0 else (float(card["u"].abs().max()) == 0.0
                              and all(v <= LOMACH_CPU_TOL for k, v in
                                      dists.items() if k != "u"))
        log(f"  {name} f64, card vs the port's CPU run (each field to its "
            f"max; max|u| {umax:.3e}): "
            + ", ".join(f"{k} {v:.2e}" for k, v in dists.items())
            + f" (bar {LOMACH_CPU_TOL})" + ("" if ok else "  FAIL"))
        if not ok:
            raise SystemExit(f"{name} deck: card and CPU differ")
        out[f"{name} f64 card vs cpu"] = dists
    return out


def lomach_cases(dtype):
    """Phase 24's cases (and phase 23's above the dense cutoff): the shipped
    channel deck, the TGV deck at 64x64 p=3, the 3-D heated channel."""
    return {
        "channel_rans.ini": lambda: lomach_tps(CHANNEL_DECK, dtype,
                                               "lomach_t_channel"),
        "TGV 64x64 p=3": lambda: lomach_tps(
            TGV_DECK, dtype, "lomach_t_tgv",
            keys={"mesh/nx": "64", "mesh/ny": "64"}),
        "3-D channel 24x12x12 p=2": lambda: lomach_tps(
            HEATED_CHANNEL, dtype, "lomach_t_3d"),
    }


def lomach_state(s):
    out = {"u": s.flow.u, "p": s.flow.p, "nu_t": s.turb.eddy_viscosity()}
    for name in ("T", "Qt"):
        if hasattr(s.thermo, name):
            out[name] = getattr(s.thermo, name)
    for name in ("k", "eps", "v2", "f"):
        if hasattr(s.turb, name):
            out[name] = getattr(s.turb, name)
    return {k: v.detach().clone() for k, v in out.items()}


def phase_lomach_graphs(steps=20):
    """Phase 23: graph against eager steps through solve(), f64: 20
    constant-order steps after the BDF ramp, on the TGV 64x64 p=3 and the
    3-D channel (p-multigrid, above the dense cutoff) and on the shipped
    channel deck, whose dense factors are refreshed between two replays
    (at step 16): every field bitwise or within GRAPH_TOL, the same CG
    iterations per solve and step; then a capture that meets a dead
    solver's graphs (dead_solver_capture)."""
    out = {}
    for name, make in lomach_cases(torch.float64).items():
        runs = []
        for graphs in (True, False):
            tps = make()
            s = tps.solver
            s.cuda_graphs = graphs
            s.max_iters_cfg = s.max_bdf_order - 1 + steps
            s.output_freq = 10**9
            s.write_restart = lambda: None
            tps.solve()
            runs.append((lomach_state(s), s.info_log, s))
        (a, ia, sa), (b, ib, _) = runs
        diffs = {k: lrel(a[k], b[k]) for k in a}
        bitwise = all(torch.equal(a[k], b[k]) for k in a)
        its = [k for k in ia[0] if k.endswith("_iters")]
        same_its = [[r[k] for k in its] for r in ia] == \
            [[r[k] for k in its] for r in ib]
        # the shipped deck's factors: refreshed at steps 0 and 16, the
        # second between two replays
        refreshed = sa.flow.refreshes
        ok = same_its and all(v <= GRAPH_TOL for v in diffs.values()) \
            and (sa.flow._direct is None or refreshed >= 2)
        log(f"  {name}: {sa.iter} steps, graph vs eager bitwise {bitwise}, "
            f"max diff {max(diffs.values()):.3e} (bar {GRAPH_TOL}); the same "
            f"CG iterations every step {same_its}; dense refreshes "
            f"{refreshed}; iterations of the last step "
            f"{ {k: ia[-1][k] for k in its} }" + ("" if ok else "  FAIL"))
        if not ok:
            raise SystemExit(f"{name}: graph and eager steps differ")
        out[name] = {"bitwise": bitwise, "max_diff": max(diffs.values())}
    out["dead solver's graphs collected around a capture"] = \
        dead_solver_capture()
    return out


def dead_solver_capture():
    """A solver dropped in a reference cycle with its step graphs, and a
    collection forced inside the next solver's capture, at each CG solve's
    split: a graph destroyed inside a capture ends the capture ("operation
    failed due to a previous error during capture"), so the capture must
    collect before it begins (solvers/step_graph.py, collector_paused)."""
    import gc

    from tps_torch.solvers.lomach.step_graph import StepGraph

    split = StepGraph.split

    def collecting(self, *args):
        gc.collect()
        return split(self, *args)

    enabled = gc.isenabled()
    gc.disable()  # the dead solver lives until a collection
    StepGraph.split = collecting
    try:
        old = lomach_tps(TGV_DECK, torch.float64, "lomach_dead_a", iters=4)
        old.solve()
        graphs = len(old.solver._graphs)
        old.solver.cycle = old.solver
        del old
        tps = lomach_tps(TGV_DECK, torch.float64, "lomach_dead_b", iters=4)
        tps.solve()
    finally:
        StepGraph.split = split
        if enabled:
            gc.enable()
    s = tps.solver
    ok = graphs > 0 and bool(s._graphs) and s.iter == 4 \
        and tps.get_status() == 0
    log(f"  a capture with a dead solver's {graphs} step graph collected "
        f"inside it at every CG split: captured {len(s._graphs)}, "
        f"{s.iter} steps" + ("" if ok else "  FAIL"))
    if not ok:
        raise SystemExit("a capture after a dead solver failed")
    return ok


def cg_breakdown(s, n=20):
    """One pressure CG iteration of the TGV case (p-multigrid, pure
    Neumann) in parts, device ms under torch.profiler: the operator apply,
    the preconditioner apply, the vector work (reductions and updates);
    with the bytes each must move at least (inputs read once, outputs
    written once) and the time those take at the card's memory rate."""
    from tps_torch.fem import h1

    fl, tab = s.flow, s.tab
    es = torch.finfo(s.dtype).bits // 8
    inv_rho = 1.0 / s.thermo.density()
    tab_c, P = fl._pmg["tab_c"], fl._pmg["P"]
    inv_rho_c = inv_rho[P.c2f]

    def lap(v):
        return h1.diffusion_apply(tab, v, inv_rho)

    def lap_c(v):
        return h1.diffusion_apply(tab_c, v, inv_rho_c)

    M = h1.pmg_precond(lap, h1.stiffness_diag(tab, inv_rho), lap_c,
                       h1.stiffness_diag(tab_c, inv_rho_c), P, ortho=True)
    g = torch.Generator(device=tab.wq.device).manual_seed(3)
    vec = [torch.randn(tab.ndofs, dtype=s.dtype, device=tab.wq.device,
                       generator=g) for _ in range(5)]
    x, r, p, Ap, z = vec
    rz = torch.sum(r * z)
    it = torch.zeros((), dtype=torch.int64, device=tab.wq.device)

    def vector_work():
        active = (torch.sum(r * r) > 0.0) & (it < 10**9)
        alpha = rz / torch.sum(p * Ap)
        x.copy_(torch.where(active, x + alpha * p, x))
        r.copy_(torch.where(active, r - alpha * Ap, r))
        rz_new = torch.sum(r * z)
        p.copy_(torch.where(active, z + (rz_new / rz) * p, p))
        rz.copy_(torch.where(active, rz_new, rz))
        it.add_(active.to(torch.int64))

    def apply_bytes(t):
        return (3 * t.ndofs * es + t.metric.numel() * es
                + t.ed_flat.numel() * 8 + t.dg_flat.numel() * 8)

    nd = tab.ndofs
    parts = {
        "operator apply": (lambda: lap(p), apply_bytes(tab)),
        "preconditioner apply": (
            lambda: M(r), apply_bytes(tab) + apply_bytes(tab_c)
            + (P.P_ids.numel() + P.R_ids.numel() + P.c2f.numel()) * 8
            + P.P_wts.numel() * es),
        "reductions and updates": (vector_work, 8 * nd * es),
    }
    out = {}
    for name, (fn, nbytes) in parts.items():
        prof = device_share(fn, n)
        out[name] = {"device_ms": prof.get("device_ms"),
                     "wall_ms": prof.get("wall_ms"),
                     "kernels": prof.get("kernels"), "bytes": nbytes,
                     "bytes_ms": nbytes / PEAK_BYTES * 1e3,
                     "top_ms": prof.get("top_ms")}
    return out


def phase_lomach_timing(cases, steps=2, profiled=1):
    """Phase 24: ms/step through solve(), in turns eager, graph, graph,
    eager, `steps` steps a turn, host clock to a synchronize (checkpoints
    left out); device ms and busy share from `profiled` graph steps under
    torch.profiler (one step: a low-Mach step launches ~10-20 thousand
    kernels, and the profiler drops events past a few tens of thousands),
    the eager busy share from them (eager_busy); capture s and the graphs'
    pool; host
    reads a step (CG status reads and ring reads); CG iterations per solve
    (mean over the timed graph turns); the dense refresh s."""
    out = {}
    for name, s in cases.items():
        s.output_freq = 10**9
        s.write_restart = lambda: None

        def turn(graphs, n=steps):
            s.cuda_graphs = graphs
            s.max_iters_cfg = s.iter + n
            r0 = s.loops.reads + s.info_reads
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            s.solve()
            ev[1].record()
            torch.cuda.synchronize()
            return ((time.perf_counter() - t0) * 1e3 / n,
                    (s.loops.reads + s.info_reads - r0) / n,
                    ev[0].elapsed_time(ev[1]) / n)

        ke0 = tgv_energy(s) if "TGV" in name else None
        turn(True, 4)  # the BDF ramp, the warm-up step, the capture
        ms = {True: [], False: []}
        reads = {True: [], False: []}
        span = {True: [], False: []}
        rows = []
        for graphs in (False, True, True, False):
            m, rd, sp = turn(graphs)
            ms[graphs].append(m)
            reads[graphs].append(rd)
            span[graphs].append(sp)
            if graphs:
                rows += s.info_log[-steps:]
        s.cuda_graphs = True
        prof = {"graph": device_share(s.solve_step, profiled)}
        prof["eager"] = eager_busy(prof["graph"].get("device_ms"),
                                   float(np.mean(ms[False])))
        its = {k: float(np.mean([r[k] for r in rows]))
               for k in rows[0] if k.endswith("_iters")}
        refresh_s = {}  # s of a forced dense refresh, per model
        for model in (s.thermo, s.flow):
            if getattr(model, "_direct", None) is not None:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.precond_refresh(s.dt, s.max_bdf_order, force=True)
                torch.cuda.synchronize()
                refresh_s[type(model).__name__] = time.perf_counter() - t0
        g = next(iter(s._graphs.values()))
        dev_ms = prof["graph"].get("device_ms")
        res = {"dofs": s.tab.ndofs,
               "graph_ms_per_step": float(np.mean(ms[True])),
               "eager_ms_per_step": float(np.mean(ms[False])),
               "graph_turns": ms[True], "eager_turns": ms[False],
               "device_ms_per_step": (None if dev_ms is None
                                      else dev_ms / profiled),
               "span_ms_per_step": {"graph": float(np.mean(span[True])),
                                    "eager": float(np.mean(span[False]))},
               "launches_per_step": prof["graph"].get("launches"),
               "busy_share": {k: v.get("busy_share") for k, v in
                              prof.items()},
               "host_reads_per_step": {"graph": float(np.mean(reads[True])),
                                       "eager": float(np.mean(reads[False]))},
               "cg_iterations_per_solve": its,
               "capture_s": g.capture_s, "graphs": g.graphs,
               "pool_MiB": g.pool_bytes / 2**20,
               "dense_refresh_s": refresh_s,
               "finite": bool(torch.isfinite(s.flow.u).all()),
               "top_ms": prof["graph"].get("top_ms")}
        if ke0 is not None:  # the TGV's decay, exp(-4 nu t) in energy
            res["tgv_decay_err"] = abs(np.sqrt(tgv_energy(s) / ke0)
                                       - np.exp(-2 * 0.01 * s.time))
            log(f"  {name}: after {s.iter} steps |sqrt(KE/KE0) - "
                f"exp(-2 nu t)| = {res['tgv_decay_err']:.2e} (bar 2e-3)")
        if s.flow._direct is None and s.tab.dim == 2:
            res["cg_iteration_parts"] = cg_breakdown(s)
        log(f"  {name} ({res['dofs']} dofs, {s.dtype}): ms/step graph "
            f"{res['graph_ms_per_step']:.3f} {ms[True]}, eager "
            f"{res['eager_ms_per_step']:.3f} {ms[False]}; device ms/step "
            f"{res['device_ms_per_step']} (kernels alone, profiled), "
            f"{res['span_ms_per_step']} (CUDA events over the turns), "
            f"{res['launches_per_step']} kernel launches a step; busy share "
            f"{res['busy_share']}; "
            f"host reads/step {res['host_reads_per_step']}; CG iterations "
            f"per solve {its}; capture {g.capture_s:.3f} s ({g.graphs} "
            f"graphs), pool {res['pool_MiB']:.1f} MiB; dense refresh "
            f"{refresh_s} s")
        if "cg_iteration_parts" in res:
            for part, v in res["cg_iteration_parts"].items():
                log(f"    one pressure CG iteration, {part}: device ms "
                    f"{v['device_ms']}, {v['kernels']} kernels, >= "
                    f"{v['bytes']} bytes = {v['bytes_ms']:.5f} ms at "
                    f"{PEAK_BYTES / 1e12} TB/s; top {v['top_ms']}")
        if not res["finite"]:
            raise SystemExit(f"{name}: the state left the finite range")
        out[f"{name} {str(s.dtype)[6:]}"] = res
    return out


# ---------------------------------------------------------------- coupled

COUPLED_DECK = os.path.join(REPO, "examples", "cases",
                            "torch_axisym_coupled.ini")
REFINED_DECK = os.path.join(REPO, "tps_torch", "tools",
                            "torch_axisym_refined.ini")
# the decks' tables, read from the checkout whatever the working directory
COUPLED_TABLES = {
    "loMach/ltethermo/table-file": os.path.join(REPO, "examples", "cases",
                                                "lte_table.h5"),
    "plasma_models/radiation_model/net_emission/tabulated/filename":
        os.path.join(REPO, "examples", "cases", "nec_table.h5")}
# f64, card against the CPU: a dense EM solve's fields (Cholesky factors
# and two refinement steps, ~1e-15 relative residual) to 1e-10 of max;
# GMRES-IR runs its Arnoldi cycles in f32, so its two solutions are held
# by what the block operator maps their difference to, within the two
# solves' relative residuals (both <= EM_SOLVE_TOL) of |b|
EM_SOLVE_TOL = 1e-10
POWER_TOL = 1e-8  # the total Joule heating after power control, relative
COUPLED_CPU_TOL = 1e-9  # the deck's 20 steps, card vs CPU, f64


def coupled_tps(deck, dtype, outdir, device="cuda", iters=None, keys=None):
    """A coupled deck through the harness (lomach_tps), its tables read from
    the checkout."""
    return lomach_tps(deck, dtype, outdir, device=device, iters=iters,
                      keys={**COUPLED_TABLES, **(keys or {})})


def axisym_operators():
    """The radius-weighted H1 applies of the axisymmetric flow and thermo:
    name -> f(tab, inputs)."""
    from tps_torch.fem import h1

    def rq(t):
        return t.xyz_q[..., 0]

    def helm(t, x):
        r = rq(t)
        m = 4.0 * x["cq"] * r
        mass = torch.stack([m + x["cq"] / r, m, m + x["cq"] / r])
        return h1.helmholtz_apply_multi(
            t, torch.cat([x["V"], x["u"][:, None]], 1), 1.0, mass,
            torch.stack([x["cq"] * r] * 3))

    return {
        "mass_apply r": lambda t, x: h1.mass_apply(t, x["u"], rq(t)),
        "mass_apply r c (k=2)":
            lambda t, x: h1.mass_apply(t, x["V"], h1.to_quad(t, x["c"])
                                       * rq(t)),
        "diffusion_apply r c":
            lambda t, x: h1.diffusion_apply(t, x["u"], x["cq"] * rq(t)),
        "weak_grad r": lambda t, x: h1.weak_grad(t, x["u"], rq(t)),
        "weak_divergence r":
            lambda t, x: h1.weak_divergence(t, x["V"], rq(t)),
        "mass_diag r": lambda t, x: h1.mass_diag(t, rq(t)),
        "mass_lumped_diag c/r":
            lambda t, x: h1.mass_lumped_diag(t, x["cq"] / rq(t)),
        "stiffness_diag r/c":
            lambda t, x: h1.stiffness_diag(t, rq(t) / x["cq"]),
        "helmholtz_apply_multi (swirl columns)": helm,
    }


def table_lookups():
    """The deck's LTE and NEC tables (read with h5lite): name -> table."""
    from tps_torch.io import h5lite
    from tps_torch.physics.tables import LinearTable

    data = np.asarray(h5lite.read(
        COUPLED_TABLES["loMach/ltethermo/table-file"])["T_mu_kap_sig_R_Cp"])
    nec = np.asarray(h5lite.read(COUPLED_TABLES[
        "plasma_models/radiation_model/net_emission/tabulated/filename"])
        ["table"])
    T = data[:, 0]
    return {"rho(T)": LinearTable(T, 101325.0 / (data[:, 4] * T)),
            "sigma(T)": LinearTable(T, data[:, 3]),
            "NEC(T)": LinearTable(nec[:, 0], nec[:, 1]),
            "kappa(T), x_log": LinearTable(T, data[:, 2], x_log=True),
            "mu(T), x_log and f_log": LinearTable(T, data[:, 1], x_log=True,
                                                  f_log=True)}


def em_pair(dev, dtype=torch.float64):
    """The shipped deck's EM solver (16x24 p=1) on the card and on the
    CPU, the same Gaussian column of conductivity in both."""
    from tps_torch.config.ini import IniInput
    from tps_torch.config.run_config import parse_run_configuration
    from tps_torch.solvers.em.qms import QuasiMagnetostaticSolverAxiSym

    torch.set_default_dtype(dtype)
    rc = parse_run_configuration(IniInput.read(COUPLED_DECK))
    out = []
    for device in (dev, "cpu"):
        em = QuasiMagnetostaticSolverAxiSym(rc, device=device)
        em.initialize()
        xyz = em.tab_np.xyz
        em.set_plasma_conductivity(torch.as_tensor(
            2000.0 * np.exp(-(xyz[:, 0] / 0.006) ** 2
                            - ((xyz[:, 1] - 0.04) / 0.02) ** 2)))
        out.append(em)
    return out


def em_solve_pair(dev, gmres):
    """Card and CPU EM solves on one path: (card, cpu, operator-mapped
    difference over |b|, max field difference over max|A|)."""
    from tps_torch.fem import h1

    keep = h1.DENSE_DIRECT_MAX
    if gmres:  # the dense path off through the port's own cutoff
        h1.DENSE_DIRECT_MAX = 0
    try:
        card, cpu = em_pair(dev)
        card.solve_step()
        cpu.solve_step()
    finally:
        h1.DENSE_DIRECT_MAX = keep
    _, _, apply, b = cpu._operands(cpu.plasma_conductivity)
    d = torch.cat([card.A_re.cpu() - cpu.A_re, card.A_im.cpu() - cpu.A_im])
    mapped = float(torch.linalg.norm(apply(d)) / torch.linalg.norm(b))
    field = max(lrel(card.A_re, cpu.A_re), lrel(card.A_im, cpu.A_im),
                lrel(card.joule_heating, cpu.joule_heating))
    return card, cpu, mapped, field


def phase_coupled_modules(dev):
    """Phase 25: the coupled path's modules on the card against the CPU,
    f64: the deck's table lookups; the radius-weighted H1 applies (12x24
    p=2 column); the EM block apply (1e-12 of max|y|), the dense Schur
    solve and GMRES-IR (the dense path off by h1.DENSE_DIRECT_MAX) on the
    shipped 16x24 EM mesh: relative residuals <= EM_SOLVE_TOL, equal GMRES
    iterations; FieldInterpolator.from_h1 both ways between the deck's
    meshes (1e-12)."""
    from tps_torch.fem import h1
    from tps_torch.interop.interpolation import FieldInterpolator
    from tps_torch.mesh.generators import box_2d

    torch.set_default_dtype(torch.float64)
    bad, worst = [], {}
    q = np.random.default_rng(7).uniform(100.0, 30000.0, 20000)
    for name, tbl in table_lookups().items():
        y1, y2 = tbl(torch.as_tensor(q, device=dev)), tbl(
            torch.as_tensor(q, device=dev))
        e = lrel(y1.cpu(), tbl(torch.as_tensor(q)))
        worst[f"table {name}"] = e
        if not (torch.equal(y1, y2) and e <= H1_OP_TOL):
            bad.append((name, e))
    mesh = box_2d(12, 24, x1=0.02, y1=0.08)
    tab_np = h1.build_h1(mesh, 2)
    tcard, tcpu = tab_np.to_torch(torch.float64, dev), \
        tab_np.to_torch(torch.float64, "cpu")
    xg, xc = h1_inputs(tab_np, 11, dev), h1_inputs(tab_np, 11, "cpu")
    for name, f in axisym_operators().items():
        y1, y2, yc = f(tcard, xg), f(tcard, xg), f(tcpu, xc)
        e = lrel(y1.cpu(), yc)
        worst[name] = e
        if not (torch.equal(y1, y2) and e <= H1_OP_TOL):
            bad.append((name, e))
    card, cpu = em_pair(dev)
    w = np.random.default_rng(3).standard_normal(2 * card.tab.ndofs)
    ys = []
    for em in (card, cpu):
        _, _, apply, _ = em._operands(em.plasma_conductivity)
        ys.append(apply(torch.as_tensor(w, device=em.device)).cpu())
    worst["EM block apply"] = lrel(ys[0], ys[1])
    if worst["EM block apply"] > H1_OP_TOL:
        bad.append(("EM block apply", worst["EM block apply"]))
    solves = {}
    for path in ("dense", "gmres"):
        c, r, mapped, field = em_solve_pair(dev, path == "gmres")
        solves[path] = {"iterations": (c.last_solve_iters,
                                       r.last_solve_iters),
                        "relres": (c.last_solve_relres, r.last_solve_relres),
                        "mapped_difference": mapped, "field_difference":
                            field, "card_ms": c.last_solve_ms,
                        "card_event_ms": c.last_solve_device_ms}
        ok = (c.last_solve_iters == r.last_solve_iters
              and max(c.last_solve_relres, r.last_solve_relres)
              <= EM_SOLVE_TOL and mapped <= 2 * EM_SOLVE_TOL
              and (path == "gmres" or field <= EM_SOLVE_TOL))
        log(f"  EM {path} ({c.tab.ndofs} dofs): iterations card/CPU "
            f"{solves[path]['iterations']}, relres {c.last_solve_relres:.2e}"
            f" / {r.last_solve_relres:.2e}, |B (A_card - A_cpu)| / |b| "
            f"{mapped:.2e}, fields {field:.2e} of max, card "
            f"{c.last_solve_ms:.1f} ms" + ("" if ok else "  FAIL"))
        if not ok:
            bad.append((f"EM {path}", solves[path]))
    em_tab = card.tab_np
    f2e = FieldInterpolator.build(mesh, 2, "gauss-lobatto", em_tab.xyz)
    e2f = FieldInterpolator.build(card.mesh, 1, "gauss-lobatto", tab_np.xyz)
    for name, it, src_np, u in (
            ("flow -> EM", f2e, tab_np, xg["u"]),
            ("EM -> flow", e2f, em_tab, torch.as_tensor(
                np.sin(40 * em_tab.xyz[:, 0]) + em_tab.xyz[:, 1],
                device=dev))):
        yc = it.from_h1(src_np.to_torch(torch.float64, "cpu"), u.cpu())
        e = lrel(it.from_h1(src_np.to_torch(torch.float64, dev), u).cpu(),
                 yc)
        worst[f"interpolate {name}"] = e
        if e > H1_OP_TOL:
            bad.append((name, e))
    log("  card vs CPU (f64, relative to max|y|), each apply bitwise "
        "repeatable on the card: " + ", ".join(
            f"{k} {v:.2e}" for k, v in worst.items()))
    if bad:
        raise SystemExit(f"phase 25: the coupled path's modules differ: {bad}")
    return {"worst": worst, "em_solves": solves}


def coupled_state(c):
    fl, th, em = c.flow.flow, c.flow.thermo, c.em
    return {"T": th.T, "u": fl.u, "u_theta": fl.ut, "p": fl.p,
            "A_re": em.A_re, "A_im": em.A_im, "joule": th.joule_heating,
            "efield": c.flow.efield}


def coupled_f64_run(device):
    """Phase 26's f64 run: the coupled deck's first 20 steps on device, its
    fields and the total Joule heating of each EM solve on the CPU."""
    tps = coupled_tps(COUPLED_DECK, torch.float64, f"coupled_{device}",
                      device=device, iters=20)
    tps.solve()
    st = {k: v.double().cpu() for k, v in coupled_state(tps.solver).items()}
    st["total joule"] = torch.tensor(
        [e["joule"] for e in tps.solver.em_log], dtype=torch.float64)
    return st


def phase_coupled_deck(dev, refs):
    """Phase 26: examples/cases/torch_axisym_coupled.ini through the CLI on
    the card (f32).  As shipped (maxIters 1000) the deck diverges, in the
    JAX package as here (the velocity grows ~1.2x a step from the first
    step, the same digits in both: tests/test_torch_deck_growth.py): the
    run must either stop cleanly with the solve-convergence guard's error
    after step 30, or run its 1000 steps finite with the power on target
    at every EM solve; it must not carry on in NaN.  Then 30 steps (three
    EM solves): every field finite, the total Joule heating
    on 400 W to POWER_TOL after control at each EM solve, the column's
    peak T above the 300 K background, the EM solves and their iterations
    printed; then its first 20 steps (two EM solves) in f64 on the card
    and on the CPU (in refs' worker): T, u, u_theta, p, A_re, A_im,
    the Joule heating and its total within COUPLED_CPU_TOL of max."""
    tps = coupled_tps(COUPLED_DECK, torch.float32, "coupled")
    c = tps.solver
    t0 = time.perf_counter()
    try:
        tps.solve()
        stopped = None
    except FloatingPointError as exc:
        stopped = str(exc)
    wall = time.perf_counter() - t0
    power = max(abs(e["joule"] / e["target"] - 1.0) for e in c.em_log)
    log(f"  as shipped, f32: {'stopped at' if stopped else 'ran to'} step "
        f"{c.flow.iter} in {wall:.1f} s"
        + (f", by the guard: {stopped}" if stopped else "")
        + f"; EM solves {len(c.em_log)}, |Joule after control / 400 - 1| "
        f"<= {power:.2e}")
    if stopped is not None:
        ok = c.flow.iter >= 30 and power <= POWER_TOL
    else:
        ok = (tps.get_status() == 0 and c.iter == 1000
              and len(c.em_log) == 100 and power <= POWER_TOL
              and all(bool(torch.isfinite(v).all())
                      for v in coupled_state(c).values()))
    if not ok:
        raise SystemExit("the shipped deck: neither a clean stop at the "
                         "convergence guard after step 30 nor 1000 finite "
                         "steps on the target power")
    out = {"as shipped f32": {"steps": c.flow.iter, "error": stopped}}
    tps = coupled_tps(COUPLED_DECK, torch.float32, "coupled_30", iters=30)
    c = tps.solver
    t0 = time.perf_counter()
    tps.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fl = c.flow
    finite = all(bool(torch.isfinite(v).all())
                 for v in coupled_state(c).values())
    power = [abs(e["joule"] / e["target"] - 1.0) for e in c.em_log]
    Tmax = float(fl.thermo.T.max())
    g = list(fl._graphs.values())
    em = {k: [e[k] for e in c.em_log]
          for k in ("em_iters", "relres", "joule_raw")}
    log(f"  30 steps, f32: {wall:.1f} s ({len(g)} step graph, "
        f"{g[0].graphs if g else 0} graphs), {len(c.em_log)} EM solves "
        f"(iterations, relres, raw Joule W: {em}), |Joule after "
        f"control / 400 - 1| <= {max(power):.2e} (bar {POWER_TOL}); peak "
        f"T {Tmax:.1f} K, max|u| {float(fl.flow.u.abs().max()):.2f} m/s; "
        f"finite {finite}; last solves {fl.info_log[-1]}")
    ok = (tps.get_status() == 0 and c.iter == 30 and g and finite
          and len(c.em_log) == 3 and max(power) <= POWER_TOL
          and Tmax > 300.0)
    if not ok:
        raise SystemExit("the coupled deck failed its checks")
    out["f32 30 steps"] = {"wall_s": wall, "em_solves": len(c.em_log),
                           "power_err": max(power), "T_max": Tmax}
    states = [coupled_f64_run("cuda"), refs.get("coupled")]
    dists = {k: lrel(states[0][k], states[1][k]) for k in states[0]
             if k != "u_theta"}
    ut_zero = all(float(s["u_theta"].abs().max()) == 0.0 for s in states)
    ok = all(v <= COUPLED_CPU_TOL for v in dists.values()) and ut_zero
    log("  f64, 20 steps (2 EM solves), card vs the port's CPU run (each "
        "field to its max): " + ", ".join(f"{k} {v:.2e}" for k, v in
                                          dists.items())
        + f"; u_theta 0 in both (no swirl inlet): {ut_zero} (bar "
        f"{COUPLED_CPU_TOL})" + ("" if ok else "  FAIL"))
    if not ok:
        raise SystemExit("the coupled deck: card and CPU differ")
    out["f64 card vs cpu"] = dists
    return out


def phase_coupled_graphs(steps=20):
    """Phase 27: the coupled deck in f64, 20 steps through the coupled
    solve() with step graphs and with eager steps (EM updates at steps 0
    and 10, the second between two replays): every field bitwise, the same
    CG iterations every step, the Joule heating and E-field tensors the
    same objects before and after the update (the hand-off copies)."""
    runs = []
    for graphs in (True, False):
        tps = coupled_tps(COUPLED_DECK, torch.float64,
                          f"coupled_graph_{graphs}", iters=steps)
        c = tps.solver
        c.flow.cuda_graphs = graphs
        ptrs = (c.flow.thermo.joule_heating.data_ptr(),
                c.flow.efield.data_ptr())
        tps.solve()
        same = ptrs == (c.flow.thermo.joule_heating.data_ptr(),
                        c.flow.efield.data_ptr())
        runs.append((coupled_state(c), c.flow.info_log, c, same))
    (a, ia, ca, sa), (b, ib, _, _) = runs
    bitwise = {k: torch.equal(a[k], b[k]) for k in a}
    its = [k for k in ia[0] if k.endswith("_iters")]
    same_its = [[r[k] for k in its] for r in ia] == \
        [[r[k] for k in its] for r in ib]
    ok = (all(bitwise.values()) and same_its and sa and ca.flow._graphs
          and len(ca.em_log) == 2)
    log(f"  {ca.iter} steps, {len(ca.em_log)} EM solves: graph vs eager "
        f"bitwise {bitwise}; the same CG iterations every step {same_its};"
        f" hand-off tensors kept {sa}; dense refreshes thermo "
        f"{ca.flow.thermo.refreshes}, flow {ca.flow.flow.refreshes}"
        + ("" if ok else "  FAIL"))
    if not ok:
        raise SystemExit("coupled deck: graph and eager steps differ")
    return {"bitwise": bitwise, "same_iterations": same_its}


def phase_coupled_timing(cases, turn_steps=5, profiled=1):
    """Phase 28: ms/step through the coupled solve(), after 4 steps (the
    BDF ramp, the warm-up step, the capture; an EM update at step 0), in
    turns eager, graph, graph, eager of `turn_steps` steps: steps 4-23,
    EM updates at 10 and 20, so each kind's two turns hold one, its mean
    one update per 10 steps; all within the 40 steps before the deck
    diverges (phase 26).  Host clock to a synchronize; CUDA events over
    each turn; one graph flow step profiled (device ms, launches; the
    eager busy share from it, eager_busy) and one EM solve (device ms);
    host reads a step; CG iterations per solve kind;
    the EM solve's device ms and its share a step amortised over
    solve-em-every-n; the dense refresh s; the interpolators' build s;
    capture s and pool MiB."""
    out = {}
    for name, c in cases.items():
        fl = c.flow
        fl.output_freq = 10**9
        fl.write_restart = lambda: None

        def turn(graphs, n=turn_steps):
            fl.cuda_graphs = graphs
            fl.max_iters_cfg = c.iter + n
            r0 = fl.loops.reads + fl.info_reads
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            c.solve()
            ev[1].record()
            torch.cuda.synchronize()
            return ((time.perf_counter() - t0) * 1e3 / n,
                    (fl.loops.reads + fl.info_reads - r0) / n,
                    ev[0].elapsed_time(ev[1]) / n)

        turn(True, 4)  # the BDF ramp, the warm-up step, the capture
        ms = {True: [], False: []}
        reads = {True: [], False: []}
        span = {True: [], False: []}
        rows = []
        for graphs in (False, True, True, False):
            m, rd, sp = turn(graphs)
            ms[graphs].append(m)
            reads[graphs].append(rd)
            span[graphs].append(sp)
            if graphs:
                rows += fl.info_log[-turn_steps:]
        fl.cuda_graphs = True
        prof = {"graph": device_share(fl.solve_step, profiled)}
        prof["eager"] = eager_busy(prof["graph"].get("device_ms"),
                                   float(np.mean(ms[False])))
        em_prof = device_share(c.em.solve_step, 1)
        em_ms = [e["device_ms"] for e in c.em_log[-4:]]
        its = {k: float(np.mean([r[k] for r in rows]))
               for k in rows[0] if k.endswith("_iters")}
        refresh_s = {}
        for model in (fl.thermo, fl.flow):
            if getattr(model, "_direct", None) is not None:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.precond_refresh(fl.dt, fl.max_bdf_order, force=True)
                torch.cuda.synchronize()
                refresh_s[type(model).__name__] = time.perf_counter() - t0
        g = next(iter(fl._graphs.values()))
        dev_ms = prof["graph"].get("device_ms")
        em_dev = em_prof.get("device_ms")
        res = {"flow_dofs": fl.tab.ndofs, "em_dofs": c.em.tab.ndofs,
               "graph_ms_per_step": float(np.mean(ms[True])),
               "eager_ms_per_step": float(np.mean(ms[False])),
               "graph_turns": ms[True], "eager_turns": ms[False],
               "flow_step_device_ms": (None if dev_ms is None
                                       else dev_ms / profiled),
               "span_ms_per_step": {"graph": float(np.mean(span[True])),
                                    "eager": float(np.mean(span[False]))},
               "launches_per_flow_step": prof["graph"].get("launches"),
               "busy_share": {k: v.get("busy_share") for k, v in
                              prof.items()},
               "host_reads_per_step": {"graph": float(np.mean(reads[True])),
                                       "eager": float(np.mean(reads[False]))},
               "cg_iterations_per_solve": its,
               "em_solve_device_ms": em_dev,
               "em_solve_event_ms": em_ms,
               "em_share_per_step_ms": (None if em_dev is None else
                                        em_dev / c.solve_em_every_n),
               "em_launches": em_prof.get("launches"),
               "dense_refresh_s": refresh_s,
               "interp_build_s": c.interp_build_s,
               "capture_s": g.capture_s, "graphs": g.graphs,
               "pool_MiB": g.pool_bytes / 2**20,
               "finite": all(bool(torch.isfinite(v).all())
                             for v in coupled_state(c).values()),
               "top_ms": prof["graph"].get("top_ms")}
        log(f"  {name} ({res['flow_dofs']} flow / {res['em_dofs']} EM dofs,"
            f" {fl.dtype}): ms/step graph {res['graph_ms_per_step']:.3f} "
            f"{ms[True]}, eager {res['eager_ms_per_step']:.3f} {ms[False]};"
            f" flow step device ms {res['flow_step_device_ms']} (profiled), "
            f"span {res['span_ms_per_step']}, {res['launches_per_flow_step']}"
            f" launches a flow step; busy share {res['busy_share']}; host "
            f"reads/step {res['host_reads_per_step']}; CG iterations per "
            f"solve {its}; EM solve device ms {em_dev} (events {em_ms}), "
            f"{res['em_share_per_step_ms']} ms a step amortised; dense "
            f"refresh {refresh_s} s; interpolators {c.interp_build_s:.3f} s;"
            f" capture {g.capture_s:.3f} s ({g.graphs} graphs), pool "
            f"{res['pool_MiB']:.1f} MiB")
        if not res["finite"]:
            raise SystemExit(f"{name}: the state left the finite range")
        out[f"{name} {str(fl.dtype)[6:]}"] = res
    return out


def coupled_cases(dtype):
    """Phase 28's cases: the shipped deck, and in f64 the refined one.  In
    f32 the refined deck's Jacobi-preconditioned velocity solve diverges
    within three steps in the JAX package as in this one (a CPU probe at
    24x48 with the dense path off: max|u| 17, 153, 440, 1.3e10 m/s there,
    17, 20, 1.7e20, NaN here), so it is timed in f64 only."""
    cases = {"torch_axisym_coupled.ini (12x24 p=2, EM 16x24)": lambda:
             coupled_tps(COUPLED_DECK, dtype, "coupled_t")}
    if dtype == torch.float64:
        cases["refined (48x96 p=2, EM 64x96)"] = lambda: coupled_tps(
            REFINED_DECK, dtype, "coupled_t_refined", iters=10**6)
    return cases


# ---------------------------------------------------------------- reacting

REACTING_DECK = os.path.join(REPO, "tps_torch", "tools",
                             "lomach_reacting.ini")
REACT_POINT_TOL = 1e-12  # pointwise modules, card vs CPU, f64
# kappa + kappa_e's bar: the third-order electron conductivity's Devoto
# combinations cancel, so a 4-ulp (1e-15) relative change of T moves it by
# 3.0e-11 of max on the CPU at phase 29's state (libm and libdevice round
# exp, log and pow apart by up to an ulp); the card read 8.3e-12 against
# the CPU (NVIDIA H100 80GB HBM3, 700.00 W)
REACT_POINT_TOLS = {"transport kappa + kappa_e": 3e-11}
REACT_STEP_TOL = 1e-10  # one ReactingFlow step (its solves to 1e-12)
REACT_CPU_TOL = 1e-9  # the deck after 10 steps, card vs CPU, f64
REACT_STEPS = 40  # the deck's CLI run on the card (phase 30)


def reacting_fields(s):
    th = s.thermo
    out = {"T": th.T, "Y": th.Y, "Y(Ar+)": th.Y[:, 0], "Qt": th.Qt,
           "p_thermo": th.p_thermo.reshape(1), "u": s.flow.u, "p": s.flow.p}
    return {k: v.detach().clone() for k, v in out.items()}


def reacting_state(s, seed):
    """A seeded argon state on the deck's dofs (T 6-12 kK, Y(Ar+) 1e-6 to
    1e-3, closed), loaded into the thermo, the same numbers on any
    device."""
    th = s.thermo
    rng = np.random.default_rng(seed)
    nd = th.T.shape[0]
    Y = np.zeros((nd, 3))
    Y[:, 0] = 10.0 ** (-6.0 + 3.0 * rng.random(nd))
    Y[:, 2] = 1.0 - Y[:, 0]
    th.set_temperature(torch.as_tensor(6000.0 + 6000.0 * rng.random(nd)))
    th.set_mass_fractions(th._close_species(torch.as_tensor(
        Y, device=th.T.device)))


def reacting_modules(s):
    """The reacting thermo's pointwise modules on solver s's state: name
    -> tensor."""
    from tps_torch.physics.chemistry import TabulatedRate
    from tps_torch.physics.tables import LinearTable
    from tps_torch.solvers.lomach.sponge import GeometricSponge, PlaneSponge

    th = s.thermo
    T, Y, p = th.T, th.Y, th.p_thermo
    diff, mu, kappa = th._transport_props(T, Y, p)
    dY, dT = th._reaction_source(T, Y, p)
    rate = TabulatedRate(LinearTable(
        np.array([1e3, 4e3, 8e3, 1.2e4, 2e4]),
        np.array([1e-30, 1e-12, 1e-6, 1e-3, 1.0]), x_log=True, f_log=True))
    sponge = GeometricSponge(s.tab, uniform_mult=2.0, plane=PlaneSponge(
        point=(0.007, 0.0), normal=(1.0, 0.3), width=0.001, mult=30.0))
    return {"transport rho D_s": diff, "transport mu": mu,
            "transport kappa + kappa_e": kappa, "reaction source dY/dt": dY,
            "reaction source dT/dt": dT,
            "_close_species": th._close_species(
                Y * torch.linspace(0.5, 2.0, len(T), dtype=T.dtype,
                                   device=T.device)[:, None]),
            "plasma conductivity": th.plasma_conductivity(),
            "TabulatedRate": rate(T), "sponge field": sponge.multiplier()}


def inlet_plane(path, n=40):
    """A parabolic u(y) inlet plane along x = 0 with a swirl column."""
    with open(path, "w") as fh:
        fh.write("# no, x, y, z, T, u, v, w\n")
        for i, y in enumerate(np.linspace(0.0, 0.25, n)):
            fh.write(f"{i},0.0,{y},0.0,{320.0 + 100.0 * y},"
                     f"{64.0 * y * (0.25 - y)},0.0,{0.5 * y}\n")
    return path


def phase_reacting_modules(dev):
    """Phase 29: the reacting path's modules on the card against the CPU,
    f64, on lomach_reacting.ini's 24x48 p=2 space and a seeded argon
    state: the transport properties, the reaction source,
    _close_species, the plasma conductivity, a TabulatedRate (log-log),
    the sponge field, the interpolated inlet's Gaussian interpolation
    (REACT_POINT_TOL of max, kappa + kappa_e its own REACT_POINT_TOLS bar;
    each bitwise repeatable on the card; what a 4-ulp change of T moves
    each module by on the CPU is logged beside); then
    one ReactingFlow step with its dense refresh, from the deck's IC
    (REACT_STEP_TOL on T, Y, Qt)."""
    from tps_torch.interop.ext_data import GaussianInterpExtData
    from tps_torch.solvers.lomach.base import TemporalCoefficients

    solvers = [lomach_tps(REACTING_DECK, torch.float64, f"react_mod_{d}",
                          device=d).solver for d in ("cuda", "cpu")]
    worst, bad = {}, []
    for s in solvers:
        reacting_state(s, 5)
    card, again, cpu = (reacting_modules(solvers[0]),
                        reacting_modules(solvers[0]),
                        reacting_modules(solvers[1]))
    path = inlet_plane(os.path.join(REPO, "build", "react_inlet.csv"))
    eds = [GaussianInterpExtData(s.tab, path, (4,), ramp_steps=3)
           for s in solvers]
    for ed in eds:
        ed.step()
    for k, f in (("velocity", "velocity_values"), ("swirl", "swirl_values"),
                 ("temperature", "temperature_values")):
        card[f"gaussian_interp {k}"] = getattr(eds[0], f)()
        again[f"gaussian_interp {k}"] = getattr(eds[0], f)()
        cpu[f"gaussian_interp {k}"] = getattr(eds[1], f)()
    # the modules' response to a 4-ulp (1e-15) relative change of T on
    # the CPU, logged as the scale of the card-vs-CPU gaps
    th = solvers[1].thermo
    th.T.mul_(1.0 + 1e-15)
    moved = reacting_modules(solvers[1])
    moved = {k: lrel(moved[k], cpu[k]) for k in moved}
    for k in card:
        bar = REACT_POINT_TOLS.get(k, REACT_POINT_TOL)
        worst[k] = lrel(card[k], cpu[k])
        if not (torch.equal(card[k], again[k]) and worst[k] <= bar
                and bool(torch.isfinite(card[k]).all())):
            bad.append((k, worst[k], bar))
    steps = []
    for d in ("cuda", "cpu"):
        s = lomach_tps(REACTING_DECK, torch.float64, f"react_step_{d}",
                       device=d).solver
        s._refresh(s.thermo, 1)
        s.thermo.step(TemporalCoefficients.bdf(1), s.dt)
        steps.append(s.thermo)
    for k in ("T", "Y", "Qt"):
        worst[f"one step {k}"] = lrel(getattr(steps[0], k),
                                      getattr(steps[1], k))
        if worst[f"one step {k}"] > REACT_STEP_TOL:
            bad.append((f"one step {k}", worst[f"one step {k}"]))
    info = {k: float(v) for k, v in steps[0].info.items()}
    log(f"  {solvers[0].tab.ndofs} dofs; card vs CPU (f64, relative to "
        f"max|y|), each bitwise repeatable on the card: " + ", ".join(
            f"{k} {v:.2e}" for k, v in worst.items())
        + f" (bars {REACT_POINT_TOL}, {REACT_POINT_TOLS}; a 4-ulp change "
        f"of T on the CPU moves them " + ", ".join(
            f"{k} {v:.1e}" for k, v in moved.items())
        + f"; one step {REACT_STEP_TOL}); the step's solves on the card "
        f"{info}")
    if bad:
        raise SystemExit(f"phase 29: the reacting modules differ: {bad}")
    return {"worst": worst, "ulp_response": moved, "one_step_info": info}


def reacting_f64_run(device):
    """Phase 30's f64 run: the reacting deck's first 10 steps on device,
    its fields on the CPU."""
    tps = lomach_tps(REACTING_DECK, torch.float64, f"reacting_{device}",
                     device=device, iters=10)
    tps.solve()
    return {k: v.double().cpu()
            for k, v in reacting_fields(tps.solver).items()}


def phase_reacting_deck(dev, refs):
    """Phase 30: lomach_reacting.ini through the CLI's path on the card
    (f32, as `python -m tps_torch --runFile` runs it), REACT_STEPS steps:
    every field finite, the solve-info guard read every step without
    tripping (it raises), the step graph captured once and replayed from
    the first constant-order step on, Y a partition of unity, p_thermo
    near the closed system's 39.7 kPa, the species in the checkpoint;
    then 10 steps in f64 on the card and on the CPU (in refs'
    worker): T, Y, Y(Ar+), u and p_thermo within REACT_CPU_TOL of max."""
    from tps_torch.io import h5lite

    tps = lomach_tps(REACTING_DECK, torch.float32, "reacting",
                     iters=REACT_STEPS)
    s = tps.solver
    t0 = time.perf_counter()
    tps.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = reacting_fields(s)
    finite = all(bool(torch.isfinite(v).all()) for v in st.values())
    g = list(s._graphs.values())
    replays = g[0].replays if g else 0
    ysum = float((s.thermo.Y.sum(-1) - 1.0).abs().max())
    p_th = float(s.thermo.p_thermo)
    ck = h5lite.read(os.path.join(s.outdir, "restart_lomach.sol.h5"))
    layout = ck["solution"]["species"].shape == (s.tab.ndofs, 3)
    rows = len(s.info_log)
    log(f"  f32: {s.iter} steps in {wall:.2f} s, {len(g)} step graph "
        f"({g[0].graphs if g else 0} graphs), {replays} replays, host "
        f"reads {s.loops.reads + s.info_reads}; T {float(st['T'].min()):.1f}"
        f"-{float(st['T'].max()):.1f} K, Y(Ar+) max "
        f"{float(st['Y(Ar+)'].max()):.4e}, |sum Y - 1| {ysum:.1e}, max|u| "
        f"{float(st['u'].abs().max()):.4f} m/s, p_thermo {p_th:.2f} Pa; "
        f"finite {finite}; solve-info rows read {rows}; species in the "
        f"checkpoint {layout}; last solves {s.info_log[-1]}")
    ok = (tps.get_status() == 0 and s.iter == REACT_STEPS and finite
          and len(g) == 1 and replays == REACT_STEPS - s.max_bdf_order
          and rows == REACT_STEPS and ysum < 1e-5
          and 30000.0 < p_th < 50000.0 and layout)
    if not ok:
        raise SystemExit("the reacting deck failed its checks")
    out = {"f32": {"steps": s.iter, "wall_s": wall, "replays": replays,
                   "T_max": float(st["T"].max()), "p_thermo": p_th}}
    states = [reacting_f64_run("cuda"), refs.get("reacting")]
    dists = {k: lrel(states[0][k], states[1][k]) for k in states[0]}
    ok = all(dists[k] <= REACT_CPU_TOL
             for k in ("T", "Y", "Y(Ar+)", "u", "p_thermo"))
    log("  f64, 10 steps, card vs the port's CPU run (each field to its "
        "max): " + ", ".join(f"{k} {v:.2e}" for k, v in dists.items())
        + f" (bar {REACT_CPU_TOL} on T, Y, u, p_thermo)"
        + ("" if ok else "  FAIL"))
    if not ok:
        raise SystemExit("the reacting deck: card and CPU differ")
    out["f64 card vs cpu"] = dists
    return out


SPONGE_INLET_DECK = """
[solver]
type = loMach
[mesh]
generator = box2d
nx = 16
ny = 8
x1 = 1.0
y1 = 0.25
[loMach]
order = 2
flow-solver = tomboulides
thermo-solver = calorically-perfect
maxIters = {iters}
[loMach/calperfect]
viscosity-model = constant
viscosity/mu = 5e-3
[time]
dt_fixed = 1e-3
[spongeMultiplier]
plane = 1
planePoint = '0.7 0.0 0.0'
planeNormal = '1.0 0.0 0.0'
planeWidth = 0.05
planeMult = 20.0
[boundaryConditions/inlet1]
patch = 4
type = interpolate
name = {csv}
rampSteps = {ramp}
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


def phase_reacting_graphs(steps=22):
    """Phase 31: step graphs against eager steps through solve(), f64:
    lomach_reacting.ini, `steps` steps (the dense factors refreshed again
    at step 17, between two replays), and a 16x8 p=2 channel with a plane
    sponge and an interpolated inlet whose ramp (12 steps) runs through
    all 10 of its steps (its device step counter advanced inside the
    graph): every field bitwise, the same CG iterations every step, the
    BC tensors the same objects."""
    csv = inlet_plane(os.path.join(REPO, "build", "sponge_inlet.csv"))
    deck = os.path.join(REPO, "build", "sponge_inlet.ini")
    with open(deck, "w") as f:
        f.write(SPONGE_INLET_DECK.format(iters=10, csv=csv, ramp=12))
    out = {}
    for name, path, n in (("lomach_reacting.ini", REACTING_DECK, steps),
                          ("sponge + interpolated inlet", deck, 10)):
        runs = []
        for graphs in (True, False):
            tps = lomach_tps(path, torch.float64, f"react_graph_{graphs}",
                             iters=n)
            s = tps.solver
            s.cuda_graphs = graphs
            s.write_restart = lambda: None
            ptrs = [s.flow.vel_bc_values.data_ptr(),
                    s.thermo.T_bc.data_ptr()]
            tps.solve()
            st = {"u": s.flow.u, "p": s.flow.p, "T": s.thermo.T,
                  "Qt": s.thermo.Qt, "T_bc": s.thermo.T_bc,
                  "u_bc": s.flow.vel_bc_values}
            if hasattr(s.thermo, "Y"):
                st.update(Y=s.thermo.Y, p_thermo=s.thermo.p_thermo)
            for i, ed in enumerate(s.ext_data):
                st[f"inlet {i} count"] = ed.count
            same = ptrs == [s.flow.vel_bc_values.data_ptr(),
                            s.thermo.T_bc.data_ptr()]
            runs.append((st, s.info_log, s, same))
        (a, ia, sa, same), (b, ib, _, _) = runs
        bitwise = {k: torch.equal(a[k], b[k]) for k in a}
        its = [k for k in ia[0] if k.endswith("_iters")]
        same_its = [[r[k] for k in its] for r in ia] == \
            [[r[k] for k in its] for r in ib]
        g = list(sa._graphs.values())
        refreshes = getattr(sa.thermo, "refreshes", None)
        ok = (all(bitwise.values()) and same_its and same and g
              and g[0].replays == n - sa.max_bdf_order
              and (refreshes is None or refreshes >= 2))
        if sa.ext_data:
            ok = ok and float(sa.ext_data[0].count) == n
        log(f"  {name}: {sa.iter} steps ({g[0].replays if g else 0} "
            f"replays), graph vs eager bitwise {bitwise}; the same CG "
            f"iterations every step {same_its}; BC tensors kept {same}; "
            f"dense refreshes thermo {refreshes}, flow "
            f"{sa.flow.refreshes}" + ("" if ok else "  FAIL"))
        if not ok:
            raise SystemExit(f"{name}: graph and eager steps differ")
        out[name] = {"bitwise": bitwise, "same_iterations": same_its}
    return out


def reacting_coupled(device, outdir):
    """tests/test_coupling.py::test_cycle_avg_joule_coupling_reacting's
    set-up on device: the argon zero-flow reacting column (5x5 p=1,
    axisymmetric, 9 kK), an EM mesh 10x10 with a coil ring, EM every 2
    steps, 100 W."""
    from tps_torch.config.ini import IniInput
    from tps_torch.config.run_config import parse_run_configuration
    from tps_torch.mesh.generators import box_2d
    from tps_torch.solvers.coupling import CycleAvgJouleCoupling
    from tps_torch.solvers.em.qms import QuasiMagnetostaticSolverAxiSym

    with open(ARGON_DECK) as f:
        argon = f.read()
    argon = "[plasma_models]" + argon.split("[plasma_models]", 1)[1]
    text = f"""
[solver]
type = cycle-avg-joule-coupled
[cycle-avg-joule-coupled]
plasma-solver = lomach
axisymmetric = 1
solve-em-every-n = 2
input-power = 100.0
eval-Rplasma = 1
[mesh]
generator = box2d
nx = 5
ny = 5
x1 = 0.01
y1 = 0.01
periodic_y = 1
[loMach]
order = 1
axisymmetric = 1
flow-solver = zero-flow
thermo-solver = reacting-flow
maxIters = 4
ambientPressure = 101325.0
openSystem = 1
[loMach/reacting]
sub-steps = 4
[initialConditions]
temperature = 9000.0
[time]
dt_fixed = 1e-7
[em]
current_amplitude = 1e6
current_frequency = 1e5
""" + argon.rsplit("[io]", 1)[0]
    torch.set_default_dtype(torch.float64)
    rc = parse_run_configuration(IniInput.parse(text))
    rc.outdir = os.path.join(REPO, "build", outdir)
    mesh = box_2d(10, 10, x0=0.0, x1=0.03, y0=-0.01, y1=0.02)
    cent = mesh.vertices[mesh.elements].mean(axis=1)
    attrs = np.ones(mesh.num_elements, dtype=np.int64)
    attrs[(np.abs(cent[:, 0] - 0.018) < 0.004)
          & (np.abs(cent[:, 1] - 0.005) < 0.004)] = 2
    mesh.elem_attrs = attrs
    c = CycleAvgJouleCoupling(rc, device=device)
    c._em_in = QuasiMagnetostaticSolverAxiSym(rc, mesh=mesh, device=device)
    c._em_in.initialize()
    c.initialize()
    return c


def phase_reacting_coupled(dev):
    """Phase 32: the reacting thermo under the cycle-averaged Joule
    coupling on the card (reacting_coupled), 4 steps, two EM updates:
    sigma from the mixture's transport positive and finite, the total
    Joule heating after control on 100 W to POWER_TOL at each update, the
    column heats, Y a partition of unity; then the same on the CPU: T, Y,
    the Joule heating, the E-field and sigma within REACT_CPU_TOL."""
    runs = []
    for device in ("cuda", "cpu"):
        c = reacting_coupled(device, f"react_coupled_{device}")
        sigma0 = c.flow.thermo.plasma_conductivity()
        T0 = float(c.flow.thermo.T.mean())
        for _ in range(4):
            c.solve_step()
        th = c.flow.thermo
        runs.append((c, sigma0, T0, {
            "T": th.T.double().cpu(), "Y": th.Y.double().cpu(),
            "joule": th.joule_heating.double().cpu(),
            "efield": c.flow.efield.double().cpu(),
            "sigma": th.plasma_conductivity().double().cpu()}))
    (c, sigma0, T0, a), (_, _, _, b) = runs
    power = [abs(e["joule"] / e["target"] - 1.0) for e in c.em_log]
    dists = {k: lrel(a[k], b[k]) for k in a}
    ysum = float((a["Y"].sum(-1) - 1.0).abs().max())
    ok = (float(sigma0.min()) >= 0.0 and float(sigma0.max()) > 0.0
          and bool(torch.isfinite(sigma0).all()) and len(c.em_log) == 2
          and max(power) <= POWER_TOL and float(a["T"].mean()) > T0
          and ysum < 1e-12 and all(v <= REACT_CPU_TOL
                                   for v in dists.values()))
    log(f"  4 steps, {len(c.em_log)} EM solves (iterations "
        f"{[e['em_iters'] for e in c.em_log]}): sigma "
        f"{float(sigma0.min()):.3e}-{float(sigma0.max()):.3e} S/m, |Joule "
        f"after control / 100 - 1| <= {max(power):.2e} (bar {POWER_TOL}); "
        f"mean T {T0:.1f} -> {float(a['T'].mean()):.1f} K; |sum Y - 1| "
        f"{ysum:.1e}; card vs CPU: " + ", ".join(
            f"{k} {v:.2e}" for k, v in dists.items())
        + f" (bar {REACT_CPU_TOL})" + ("" if ok else "  FAIL"))
    if not ok:
        raise SystemExit("the reacting coupling failed its checks")
    return {"power_err": max(power), "card_vs_cpu": dists}


def reacting_chain(s, n=4):
    """Device ms of the reacting thermo's pointwise chain on the deck's
    state, profiled alone: one transport evaluation (the thermo step and
    the flow's viscosity take one each a step) and one reaction source
    (4 substeps and the Qt take 5 a step)."""
    th = s.thermo
    tr = device_share(lambda: th._transport_props(th.T, th.Y, th.p_thermo),
                      n)
    rs = device_share(lambda: th._reaction_source(th.T, th.Y, th.p_thermo,
                                                  th.t), n)
    out = {"transport_device_ms": tr.get("device_ms"),
           "transport_launches": tr.get("launches"),
           "reaction_source_device_ms": rs.get("device_ms"),
           "reaction_source_launches": rs.get("launches")}
    if None not in (out["transport_device_ms"],
                    out["reaction_source_device_ms"]):
        out["chain_device_ms_per_step"] = (2 * out["transport_device_ms"]
                                           + 5 * out[
                                               "reaction_source_device_ms"])
    return out


def reacting_cases(dtype):
    """Phase 33's case: the deck as shipped."""
    return {"lomach_reacting.ini (24x48 p=2)": lambda: lomach_tps(
        REACTING_DECK, dtype, "reacting_t", iters=10**6)}


# ---------------------------------------------------------------- mixtures

# the compressible argon plasma's decks (phases 34-37)
# f64, the coupled channel on the card against the port's CPU run after 12
# steps across an EM update (the same operations summed in another order;
# the EM solve is dense, ~1e-15 relative residual)
CHANNEL_CPU_TOL = 1e-9
ARGON_CHANNEL_DECK = os.path.join(REPO, "tps_torch", "tools",
                                  "argon_channel_coupled.ini")
FULL_DECK = os.path.join(REPO, "tests", "inputs", "argon_full.ini")
INOUT_DECK = os.path.join(REPO, "tests", "inputs", "argon_inflow_outflow.ini")
# the face flux per point of each mixture policy, counted from its code as
# MIX_FACE_OPS is (an estimate: the 3-D stress and gradients add ~20% to
# the 2-D counts; Euler keeps the convective flux and the combination;
# constant transport replaces the collision integrals' ~390 operations a
# side; the six-species mixture's 15 binary diffusivities, 5 viscosities
# and 28 third-order integrals take ~1,100 a side)
MIX_OPS = {"argon_2d": MIX_FACE_OPS, "argon_3d": 2 * (77 + 671) + 65,
           "argon_euler": 2 * 67 + 45, "argon_euler_3d": 2 * 77 + 55,
           "argon_const": 2 * (67 + 240) + 55,
           "gas_mixture": 2 * (90 + 1100) + 70}
# the ternary with constant transport (ConstantPlasmaTransport): the
# argon_minimal transport's values at the shipped deck's state (rho 1.6,
# 300 K, ion fraction 1e-7), the species in input order (E, Ar, Ar+)
CONSTANT_PLASMA = """
[plasma_models/transport_model/constant]
viscosity = 2.25e-5
bulk_viscosity = 0.0
thermal_conductivity = 0.0175
electron_thermal_conductivity = 1.5e-5
diffusivity/species1 = 0.094
diffusivity/species2 = 4.2e-6
diffusivity/species3 = 4.2e-6
momentum_transfer_frequency/species1 = 0.0
momentum_transfer_frequency/species2 = 4.4e10
momentum_transfer_frequency/species3 = 4.1e9
"""


def mixture_text(kind):
    """The ini text of a face-sweep variant's plasma: the shipped argon
    deck (argon_2d, argon_3d, argon_euler), with constant transport
    (argon_const) or tests/inputs/argon_full.ini (gas_mixture)."""
    with open(FULL_DECK if kind == "gas_mixture" else ARGON_DECK) as f:
        text = f.read()
    if kind == "argon_euler":
        text = text.replace("equation_system = navier-stokes",
                            "equation_system = euler")
    if kind == "argon_const":
        text = text.replace("transport_model = argon_minimal",
                            "transport_model = constant") + CONSTANT_PLASMA
    return text


def mixture_ctx(kind, dim):
    """(RHS context, mixture) of a variant's plasma, dim-D."""
    from tps_torch.config.ini import IniInput
    from tps_torch.dg.fluxes import Fluxes
    from tps_torch.dg.rhs import RHSContext
    from tps_torch.dg.riemann import Rusanov
    from tps_torch.physics.plasma_config import build_plasma

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    path = os.path.join(REPO, "build", f"mixture_{kind}.ini")
    with open(path, "w") as f:
        f.write(mixture_text(kind))
    pl = build_plasma(IniInput.read(path), dim, dim)
    eq = "euler" if kind == "argon_euler" else "navier-stokes"
    fl = Fluxes(mixture=pl.mixture,
                transport=None if eq == "euler" else pl.transport,
                eq_system=eq)
    return RHSContext(fluxes=fl, riemann=Rusanov(fl))


def mixture_U(mix, xyz, dtype, device, L=0.01):
    """A perturbed plasma state on an L box, 2-D or 3-D: argon_U's rho
    1.6, u ~10, Th ~1,800 K, Te ~9,000 K, the ion fraction ~1e-3 and
    every other active species ~1e-4, with a wave in every primitive."""
    dim = xyz.shape[-1]
    k = 2 * np.pi / L
    wave = np.sin(k * xyz[..., 0]) * np.cos(k * xyz[..., 1])
    if dim == 3:
        wave = wave * np.cos(k * xyz[..., 2])
    Up = np.zeros(xyz.shape[:-1] + (mix.num_equations,))
    Up[..., 0] = 1.6 * (1 + 0.05 * wave)
    Up[..., 1], Up[..., 2] = 10.0 + 3.0 * wave, -2.0 * wave
    if dim == 3:
        Up[..., 3] = 1.5 * wave
    Up[..., dim + 1] = 1800.0 * (1 + 0.05 * wave)
    for s in range(mix.num_active_species):
        frac = 1e-3 if s == 0 else 1e-4
        Up[..., dim + 2 + s] = (frac * 1.6 / mix.mw[s]
                                * (1 + (0.2 if s == 0 else 0.1) * wave))
    Up[..., -1] = 9000.0 * (1 - 0.1 * wave)
    U = mix.conservatives(torch.as_tensor(Up, dtype=torch.float64))
    return U.to(dtype=dtype, device=device).contiguous()


def mixture_tables(n, order, basis, L=0.01):
    from tps_torch.dg.discretization import build_tables
    from tps_torch.mesh.generators import box_2d, box_3d

    if len(n) == 3:
        mesh = box_3d(*n, bounds=((0.0, L),) * 3, periodic=(True,) * 3)
    else:
        mesh = box_2d(*n, x1=L, y1=L, periodic_x=True, periodic_y=True)
    return build_tables(mesh, order, **({} if basis == "gl" else GLL))


# (variant, plasma, grid, order, basis): each variant on a small grid and
# at the full width of its path (the last of each, timed)
MIXTURE_FACE_CASES = (
    ("argon_3d", "argon_3d", (4, 4, 4), 2, "gll"),
    ("argon_3d", "argon_3d", (16, 16, 16), 2, "gl"),
    ("argon_euler", "argon_euler", (8, 8), 1, "gll"),
    ("argon_euler", "argon_euler", (16, 16, 16), 2, "gl"),
    ("argon_euler", "argon_euler", (64, 64), 2, "gl"),
    ("argon_const", "argon_const", (8, 8), 2, "gll"),
    ("argon_const", "argon_const", (64, 64), 2, "gl"),
    ("gas_mixture", "gas_mixture", (4, 4), 1, "gll"),
    ("gas_mixture", "gas_mixture", (64, 64), 2, "gl"),
)


def phase_mixture_faces(dev, cases=MIXTURE_FACE_CASES):
    """Phase 34: the face sweep's mixture variants against their plain
    versions, f64 within TOL and f32 by TOL's rule, each on a small grid
    and at the full width of its path; the full-width case timed in f32
    (kernel, plain, kernel) and f64 (CUDA events, and on the device), with
    its bound.  Returns
    {variant: record} and the largest f64 error."""
    from tps_torch.dg.cuda_faces import build_face_sweep

    failures, out, worst = [], {}, 0.0
    for var, plasma, n, order, basis in cases:
        t0 = time.perf_counter()
        dim = len(n)
        ctx = mixture_ctx(plasma, dim)
        tab_np = mixture_tables(n, order, basis)
        tab64 = tab_np.to_torch(torch.float64, dev)
        tab32 = tab_np.to_torch(torch.float32, dev)
        sw64, sw32 = build_face_sweep(tab64, ctx), build_face_sweep(tab32, ctx)
        X64 = face_input(ctx, tab64, mixture_U(ctx.mixture, tab_np.xyz_dof,
                                               torch.float64, dev))
        X32 = X64.float()
        y64, p64 = sw64(X64), sw64.plain(X64)
        r64 = rel(y64, p64)
        k32, p32 = sw32(X32), sw32.plain(X32)
        ref = sw64.plain(X32.double())
        r32 = rel(k32, p32)
        dk, dp = rel(k32.double(), ref), rel(p32.double(), ref)
        name = f"{var} {'x'.join(map(str, n))} p={order} {basis}"
        ok = (r64 <= TOL[torch.float64] and sw64.variant == var
              and (r32 <= TOL[torch.float32] or dk <= 2 * dp))
        log(f"  {name} (NEQ {sw64.neq}, k {sw64.k}, {tab_np.ne} elements, "
            f"set-up {time.perf_counter() - t0:.1f} s): f64 {r64:.3e} (bar "
            f"{TOL[torch.float64]}); f32 {r32:.3e} (bar {TOL[torch.float32]}"
            f", or f64 dist: kernel {dk:.3e} <= 2 x plain {dp:.3e})"
            + ("" if ok else "  FAIL"))
        worst = max(worst, r64)
        if not ok:
            failures.append(name)
        key = var if not (var == "argon_euler" and dim == 3) else \
            "argon_euler_3d"
        if n[0] >= 16:
            ms = [cuda_ms(lambda: sw32(X32), 30),
                  cuda_ms(lambda: sw32.plain(X32), 3),
                  cuda_ms(lambda: sw32(X32), 30)]
            b = face_bound(tab_np, ctx.fluxes.eq_system, basis,
                           neq=sw64.neq, flux_ops=MIX_OPS[key])
            out[key] = {
                "grid": name, "neq": sw64.neq, "nodes": tab_np.ne * tab_np.ndof,
                "ms": (ms[0] + ms[2]) / 2, "plain_ms": ms[1],
                "device_ms": kernel_ms(lambda: sw32(X32), "face_sweep", 20),
                "f64_ms": cuda_ms(lambda: sw64(X64), 20),
                "f64_device_ms": kernel_ms(lambda: sw64(X64), "face_sweep",
                                           20),
                "bound_ms": b[0], "bound_by": b[1], "ops_ms": b[2],
                "bytes_ms": b[3], "f64_rel_err": r64,
                "max_abs_err": float(torch.max(torch.abs(k32 - p32))),
                "f32_rel": r32, "f32_f64_dist": dk, "plain_f32_f64_dist": dp,
                "turns": ms}
            log(f"  timing {name} f32: {out[key]}")
        del tab64, tab32, sw64, sw32, X64, X32, y64, p64, k32, p32, ref
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    if failures:
        raise SystemExit(f"face sweep parity on the mixtures failed: "
                         f"{failures}")
    return out, worst


def channel_tps(dtype, outdir, device="cuda", iters=None, keys=None,
                path=ARGON_CHANNEL_DECK):
    """A compressible deck through the harness, as `python -m tps_torch
    --runFile path [--device cpu]` does, in dtype, its output in
    build/<outdir>; `iters` and `keys` change its maxIters and ini
    values."""
    from tps_torch import harness

    torch.set_default_dtype(dtype)
    tps = harness.Tps()
    tps.parse_command_line_args(
        ["tps", "--runFile", path] + ([] if device == "cuda"
                                      else ["--device", "cpu"]))
    tps.parse_input()
    tps.config.outdir = os.path.join(REPO, "build", outdir)
    for k, v in (keys or {}).items():
        tps.config.raw.values[k] = v
    if iters is not None:
        tps.config.max_iters = iters
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    return tps


def state_rel(U, ref, mix=None, nvel=2):
    """max|U - ref| per equation over that equation's max, the nvel
    momenta over max rho times a speed (a channel's cross-stream momentum,
    and every momentum of a gas at rest, starts at 0): max |u|, or the max
    characteristic speed of `mix`: the largest."""
    U, ref = U.double().cpu(), ref.double().cpu()
    dim = nvel
    speed = float(torch.max(torch.abs(ref[..., 1:1 + dim]) / ref[..., :1]))
    if mix is not None:
        speed = float(torch.max(mix.max_char_speed(ref)))
    out = 0.0
    for q in range(ref.shape[-1]):
        scale = float(torch.max(torch.abs(ref[..., q])))
        if 1 <= q <= dim:
            scale = max(scale, float(torch.max(ref[..., 0])) * speed)
        out = max(out, float(torch.max(torch.abs(U[..., q] - ref[..., q])))
                  / scale)
    return out


def channel_state(c):
    return {"U": c.flow.U, "joule": c.flow.joule_heating,
            "efield": c.flow.efield, "A_re": c.em.A_re, "A_im": c.em.A_im}


def channel_power(c):
    return max(abs(e["joule"] / e["target"] - 1.0) for e in c.em_log)


def channel_f64_run(name, device, graphs=True):
    """Phase 35's f64 run: the coupled channel's first 12 steps on device
    (the step graph or eager steps): its state, the Joule heating, the
    E-field and the EM potential on the CPU, the power's distance from the
    target, the EM solves, and whether the hand-off tensors were kept."""
    tps = channel_tps(torch.float64, f"channel_{name}", device=device,
                      iters=12)
    c = tps.solver
    c.flow.cuda_graphs = graphs
    ptrs = (c.flow.joule_heating.data_ptr(), c.flow.efield.data_ptr())
    tps.solve()
    return ({k: v.double().cpu().clone() for k, v in channel_state(c).items()},
            channel_power(c), len(c.em_log),
            ptrs == (c.flow.joule_heating.data_ptr(),
                     c.flow.efield.data_ptr()))


def phase_channel_deck(dev, refs):
    """Phase 35: tps_torch/tools/argon_channel_coupled.ini (the compressible
    argon channel under the Joule coupling, 64x64 p=2 GL, EM every 10
    steps) through the CLI (f32, 100 of its 200 steps) with the launch
    counts set to 0 before it: the 2-D argon face sweep 4 times a step,
    no other variant; finite; the steps replayed the step graph; the
    power after control on target at each EM solve.  Then 12 steps (EM
    updates at 0 and 10) in f64 on the card and on the CPU (in refs'
    worker): the state, the Joule heating, the E-field and the EM potential
    within
    CHANNEL_CPU_TOL; the power within POWER_TOL of the target; the step
    graph against eager steps over the same 12 steps within GRAPH_TOL."""
    tps = channel_tps(torch.float32, "channel", iters=100)
    c = tps.solver
    reset_all_launches()
    t0 = time.perf_counter()
    tps.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches_by_variant()
    steps = c.flow.iter
    want = {"face_sweep": 4 * steps, "face_sweep/argon_2d": 4 * steps}
    bad = {k: v for k, v in counts.items() if v != want.get(k, 0)}
    finite = all(bool(torch.isfinite(v).all())
                 for v in channel_state(c).values())
    power32 = channel_power(c)
    Up = c.flow.mixture.primitives(c.flow.U)
    log(f"  f32: {steps} of the deck's 200 steps in {wall:.1f} s, "
        f"{len(c.em_log)} "
        f"EM solves; launches {counts}; finite {finite}; |Joule after "
        f"control / target - 1| <= {power32:.2e} (f32); T_e max "
        f"{float(Up[..., -1].max()):.1f} K, max|u| "
        f"{float(Up[..., 1:3].abs().max()):.3f} m/s; step graph "
        f"{c.flow._loop.graph is not None}, launches a replay "
        f"{c.flow._loop.per_replay}")
    if (bad or not finite or tps.get_status() != 0 or steps != 100
            or len(c.em_log) != 10 or c.flow._loop.graph is None):
        raise SystemExit(f"the coupled channel's CLI run failed its checks "
                         f"(launches off: {bad})")
    out = {"as shipped f32": {"steps": steps, "wall_s": wall,
                              "launches": counts, "power_err_f32": power32}}
    card = channel_f64_run("card", "cuda")
    eager = channel_f64_run("eager", "cuda", graphs=False)
    cpu = refs.get("channel")
    cpu_d = {k: (state_rel(card[0][k], cpu[0][k]) if k == "U"
                 else lrel(card[0][k], cpu[0][k])) for k in card[0]}
    graph_d = {k: (state_rel(card[0][k], eager[0][k]) if k == "U"
                   else lrel(card[0][k], eager[0][k])) for k in card[0]}
    ok = (max(cpu_d.values()) <= CHANNEL_CPU_TOL
          and max(graph_d.values()) <= GRAPH_TOL
          and max(card[1], cpu[1]) <= POWER_TOL
          and card[2] == cpu[2] == eager[2] == 2 and card[3])
    log(f"  f64, 12 steps (EM updates at 0 and 10): card vs the port's CPU "
        f"run {cpu_d} (bar {CHANNEL_CPU_TOL}); graph vs eager {graph_d} "
        f"(bar {GRAPH_TOL}); |Joule / target - 1| card {card[1]:.2e}, CPU "
        f"{cpu[1]:.2e} (bar {POWER_TOL}); hand-off tensors kept {card[3]}"
        + ("" if ok else "  FAIL"))
    if not ok:
        raise SystemExit("the coupled channel: card, CPU and eager differ")
    out["f64 card vs cpu"] = cpu_d
    out["f64 graph vs eager"] = graph_d
    out["power_err_f64"] = card[1]
    return out


def big_deck(path, name, n, iters, dt):
    """A shipped mixture deck at n x n p=2 (its own basis), dt_fixed dt,
    iters steps, output in build/<name>."""
    with open(path) as f:
        text = f.read()
    for k in ("nx", "ny"):
        text = text.replace(f"{k} = 4\n", f"{k} = {n}\n").replace(
            f"{k} = 6\n", f"{k} = {n}\n")
    text = text.replace("order = 1", "order = 2")
    text = text.replace("maxIters = 4", f"maxIters = {iters}")
    text = text.replace("dt_fixed = 2e-9\n", "")
    text = text.replace("[time]\n", f"[time]\ndt_fixed = {dt}\n")
    text = text.replace("[flow]\n", "[flow]\ntimingFreq = 100000\n", 1)
    for old in ("outdirBase = /tmp/tps_tpu_argon_full",
                "outdirBase = /tmp/tps_tpu_argon_inout_output"):
        text = text.replace(old, f"outdirBase = "
                                 f"{os.path.join(REPO, 'build', name)}")
    out = os.path.join(REPO, "build", name + ".ini")
    with open(out, "w") as f:
        f.write(text)
    return out


def variant_deck(var):
    """The shipped argon deck (argon_minimal.ini) on the path of a face-sweep
    variant, through the CLI: argon_3d, the 3-D periodic box 16^3 p=2 GL
    (110,592 nodes, 7 equations); argon_euler_2d / argon_euler_3d, Euler on
    64x64 p=2 GL and on the 3-D box; argon_const, constant transport
    (CONSTANT_PLASMA) on 64x64 p=2 GL.  4 RK4 steps of dt 1e-9, output in
    build/<var>."""
    kind = {"argon_3d": "argon_3d", "argon_euler_2d": "argon_euler",
            "argon_euler_3d": "argon_euler", "argon_const": "argon_const"}[var]
    text = mixture_text(kind)
    n = 16 if var.endswith("3d") else 64
    mesh = (f"generator = box3d\nnx = {n}\nny = {n}\nnz = {n}\nx1 = 0.01\n"
            f"y1 = 0.01\nz1 = 0.01\nperiodic_x = 1\nperiodic_y = 1\n"
            f"periodic_z = 1\n") if var.endswith("3d") else (
            f"generator = box2d\nnx = {n}\nny = {n}\nx1 = 0.01\ny1 = 0.01\n"
            f"periodic_x = 1\nperiodic_y = 1\n")
    start = text.index("[mesh]\n") + len("[mesh]\n")
    text = text[:start] + mesh + text[text.index("\n[time]"):]
    text = text.replace("order = 1", "order = 2\nbasisType = 0\n"
                        "integrationRule = 0\ntimingFreq = 100000")
    text = text.replace("cfl = 0.1", "dt_fixed = 1e-9")
    text = text.replace("outputFreq = 100", "outputFreq = 100000")
    text = text.replace("outdirBase = /tmp/tps_tpu_argon_output",
                        f"outdirBase = {os.path.join(REPO, 'build', var)}")
    path = os.path.join(REPO, "build", var + ".ini")
    with open(path, "w") as f:
        f.write(text)
    return path


def phase_mixture_decks(dev):
    """Phase 36: the paths of the variants through the CLI (f32,
    `variant_deck`): each counts its variant once a stage and no other.
    tests/inputs/argon_full.ini (six species, the per-pair
    transport, radiative decay; RK3) and argon_inflow_outflow.ini (the
    inlet with species, the pressure outlet; RK4) through the CLI as
    shipped (f32), the launch counts set to 0 before each: its variant
    (gas_mixture, argon_2d) once a stage, no other; finite.  Then both at
    64x64 p=2, dt 1e-9, in f64 from their initial states: the solver (the
    kernel, the step graph) against a plain loop of the same integrator
    over compute_rhs with the plain face sweep and the species clip, 5
    steps, within SOLVER_TOL."""
    from tps_torch.dg.cuda_faces import face_sweep_plain
    from tps_torch.dg.operators import _clip_species
    from tps_torch.dg.rhs import compute_rhs

    out = {}
    for name, var in (("argon_3d", "argon_3d"),
                      ("argon_euler_2d", "argon_euler"),
                      ("argon_euler_3d", "argon_euler"),
                      ("argon_const", "argon_const")):
        tps = channel_tps(torch.float32, name, path=variant_deck(name))
        s = tps.solver
        reset_all_launches()
        tps.solve()
        torch.cuda.synchronize()
        counts = launches_by_variant()
        want = {"face_sweep": 4 * s.iter, f"face_sweep/{var}": 4 * s.iter}
        bad = {k: v for k, v in counts.items() if v != want.get(k, 0)}
        finite = bool(torch.isfinite(s.U).all())
        log(f"  {name} (argon_minimal.ini's plasma, {s.tables_np.ne} "
            f"elements p=2 GL, f32): {s.iter} steps, launches {counts}, "
            f"finite {finite}, step graph {s._loop.graph is not None}")
        if (bad or not finite or tps.get_status() != 0
                or s._loop.graph is None):
            raise SystemExit(f"{name}: the CLI run failed its checks "
                             f"(launches off: {bad})")
        out[name] = {"launches": counts}
        del tps, s
    for name, path, var, stages in (
            ("argon_full", FULL_DECK, "gas_mixture", 3),
            ("argon_inflow_outflow", INOUT_DECK, "argon_2d", 4)):
        tps = channel_tps(torch.float32, name, path=path)
        s = tps.solver
        reset_all_launches()
        tps.solve()
        torch.cuda.synchronize()
        counts = launches_by_variant()
        want = {"face_sweep": stages * s.iter,
                f"face_sweep/{var}": stages * s.iter}
        bad = {k: v for k, v in counts.items() if v != want.get(k, 0)}
        finite = bool(torch.isfinite(s.U).all())
        log(f"  {name} as shipped, f32: {s.iter} steps, launches {counts}, "
            f"finite {finite}")
        if bad or not finite or tps.get_status() != 0:
            raise SystemExit(f"{name}: the CLI run failed its checks "
                             f"(launches off: {bad})")
        dt = 1e-9
        s = channel_tps(torch.float64, f"{name}64", path=big_deck(
            path, f"{name}64", 64, 5, dt)).solver
        U0 = s.U.clone()
        s.solve()
        U_solver = s.U.clone()
        plain = functools.partial(face_sweep_plain, s.ctx, s.tables)

        def rhs(U, t):
            return compute_rhs(s.ctx, s.tables, U, t,
                               bc_states=s._rhs.bc_states, sweep=plain)

        U, t = U0, 0.0
        for _ in range(5):
            U = _clip_species(s.mixture, s._integrator(rhs, U, t, dt)[0])
            t += dt
        err = state_rel(U_solver, U, s.mixture)
        moved = state_rel(U_solver, U0, s.mixture)
        ok = err <= SOLVER_TOL and moved > 0
        log(f"  {name} 64x64 p=2 f64, 5 steps: solver vs plain loop "
            f"{err:.3e} (bar {SOLVER_TOL}); moved {moved:.3e}"
            + ("" if ok else "  FAIL"))
        if not ok:
            raise SystemExit(f"{name}: solver vs plain loop failed")
        out[name] = {"launches": counts, "solver_vs_plain": err}
        del s, U, U0, U_solver
        torch.cuda.empty_cache()
    return out


def phase_channel_timing(cases=None, turn_steps=5, profiled=1):
    """Phase 37: ms/step through solve() on the coupled channel (through
    the coupled solve(), f32 and f64) and on argon_full at 64x64 p=2 (f32,
    dt 1e-9): after 4 steps (an EM update at 0, the capture), in turns
    eager, graph, graph, eager of `turn_steps` steps, host clock to a
    synchronize: steps 4-23, EM updates at 10 and 20, so each kind's two
    turns hold one, its mean one update per 10 steps (as phase 28);
    device ms of a profiled graph chunk of `profiled` flow steps, its busy
    share, the eager one (eager_busy) and launches a step; the EM solve's
    device ms and its share a step amortised over solve-em-every-n."""
    out = {}
    if cases is None:
        cases = {"channel f32": channel_tps(torch.float32, "channel_t32",
                                            iters=4).solver,
                 "channel f64": channel_tps(torch.float64, "channel_t64",
                                            iters=4).solver,
                 "argon_full 64x64 f32": channel_tps(
                     torch.float32, "full64_t",
                     path=big_deck(FULL_DECK, "full64_t", 64, 4,
                                   1e-9)).solver}
    for name, c in cases.items():
        coupled = hasattr(c, "em")
        fl = c.flow if coupled else c
        fl.write_restart = lambda: None
        c.solve()  # warm-up, capture, the first EM update

        def turn(graphs, n=turn_steps):
            fl.cuda_graphs = graphs
            fl.config.max_iters = c.iter + n
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c.solve()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n

        ms = {True: [], False: []}
        for graphs in (False, True, True, False):
            ms[graphs].append(turn(graphs))
        fl.cuda_graphs = True
        prof = {"graph": device_share(lambda: fl.solve_chunk(profiled), 1)}
        dev_ms = prof["graph"].get("device_ms")
        prof["eager"] = eager_busy(None if dev_ms is None else dev_ms / profiled,
                                   float(np.mean(ms[False])))
        res = {"graph_ms_per_step": float(np.mean(ms[True])),
               "eager_ms_per_step": float(np.mean(ms[False])),
               "graph_turns": ms[True], "eager_turns": ms[False],
               "device_ms_per_step": (None if dev_ms is None
                                      else dev_ms / profiled),
               "busy_share": {k: v.get("busy_share") for k, v in
                              prof.items()},
               "launches_per_step": (None if prof["graph"].get("launches")
                                     is None else prof["graph"]["launches"]
                                     / profiled),
               "replay_launches": fl._loop.per_replay,
               "capture_s": fl._loop.capture_s,
               "pool_MiB": fl._loop.pool_bytes / 2**20,
               "finite": bool(torch.isfinite(fl.U).all()),
               "top_ms": prof["graph"].get("top_ms")}
        if coupled:
            em = device_share(c.em.solve_step, 1)
            em_dev = em.get("device_ms")
            res.update({"em_solve_device_ms": em_dev,
                        "em_solve_launches": em.get("launches"),
                        "em_per_step_ms": (None if em_dev is None else
                                           em_dev / c.solve_em_every_n),
                        "em_dofs": c.em.tab.ndofs})
        log(f"  {name}: ms/step graph {res['graph_ms_per_step']:.4f} "
            f"{ms[True]}, eager {res['eager_ms_per_step']:.4f} {ms[False]} "
            f"({'an EM update in each kind' if coupled else 'no EM'}); device "
            f"ms/step {res['device_ms_per_step']}, busy share "
            f"{res['busy_share']}, launches a step "
            f"{res['launches_per_step']}"
            + (f"; EM solve device ms {res['em_solve_device_ms']}, "
               f"{res['em_per_step_ms']} a step amortised over "
               f"{c.solve_em_every_n}" if coupled else ""))
        if not res["finite"]:
            raise SystemExit(f"{name}: the state left the finite range")
        out[name] = res
    del cases
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- LTE

# the LTE-table plasma (phases 38-40)
LTE_DECK = os.path.join(REPO, "tps_torch", "tools", "lte_channel_coupled.ini")
# f64, an LTE variant against its plain version, relative to max|plain|:
# the same table lookups and Newton steps, summed in another order
LTE_F64_TOL = 2.2e-13
# f64, the LTE channel on the card against the port's CPU run after 12
# steps across an EM update (U; the Joule heating to CHANNEL_CPU_TOL)
LTE_CPU_TOL = 1e-11
# f64, the LTE restart's conversion on the card against the CPU's
LTE_CONVERT_TOL = 1e-11
# the converted six-species plasma's dt at 64x64 p=2: a restart keeps the
# checkpoint's dt (the LTE channel's 4e-9, as in the JAX package), at
# which the 9,500 K plasma goes NaN within 4 steps on the card (PERF.md);
# 1e-9 stays finite at 32x32 on the CPU; 16x below 4e-9
LTE_RESTART_DT = 2.5e-10


def _lookup_ops(n):
    """A 1-D table lookup: the binary search (a comparison and two index
    operations a step), the clamp and a + b x."""
    return 3 * int(np.ceil(np.log2(n))) + 4


def _lookup2_ops(nx, ny):
    """A 2-D lookup: two clamps and searches, the weights, bilinear."""
    return 3 * int(np.ceil(np.log2(nx)) + np.ceil(np.log2(ny))) + 25


def lte_ops(dim, table_dim, euler, newton=20):
    """The LTE face flux per point, counted from csrc/dg_lte.cuh as
    MIX_OPS is (the least the function needs: each side's temperature
    once): per side the energy, the T(e) guess and `newton` Newton steps
    (three lookups of e and 11 operations each), p and c (a lookup each),
    the convective flux, and on Navier-Stokes mu, kappa and the viscous
    normal flux; per point the Rusanov combination and the viscous mean.
    The tables: lte_argon_tables.py's (800 temperatures; 2-D: 200 x 12,
    the inversion 300 x 12)."""
    L = _lookup_ops(800) if table_dim == 1 else _lookup2_ops(200, 12)
    Lg = _lookup_ops(800) if table_dim == 1 else _lookup2_ops(300, 12)
    neq = dim + 2
    temp = 2 * dim + 4 + Lg + newton * (3 * L + 11)
    conv = 4 * dim + 3 * dim + 3 + (L + 2) + (L + 4)
    visc = 0 if euler else 2 * L + 3 * dim * dim + dim * (4 * dim + 3) + 2
    point = 2 * dim + 2 + 5 * neq + (0 if euler else 3 * (neq - 1))
    return 2 * (temp + conv + visc) + point


# (variant, table dim, grid): each LTE variant at the width of its path
# (phases 38-39: the 64x64 channel, the 32x32 box with 2-D tables, the
# 16^3 box) or, the 3-D forms that no shipped deck takes, at 8^3
LTE_FACE_CASES = (
    ("lte_2d", 1, (64, 64)), ("lte_2d_euler", 1, (64, 64)),
    ("lte_2d_t2", 2, (32, 32)), ("lte_2d_t2_euler", 2, (32, 32)),
    ("lte_3d", 1, (16, 16, 16)), ("lte_3d_euler", 1, (8, 8, 8)),
    ("lte_3d_t2", 2, (8, 8, 8)), ("lte_3d_t2_euler", 2, (8, 8, 8)),
)


def lte_ctx(table_dim, dim, euler):
    """(RHS context) of the LTE fluid on lte_argon_tables.py's tables (the
    2-D ones written into build/)."""
    from tps_torch.config.ini import IniInput
    from tps_torch.dg.fluxes import Fluxes
    from tps_torch.dg.rhs import RHSContext
    from tps_torch.dg.riemann import Rusanov
    from tps_torch.physics.lte import load_lte_setup
    from tps_torch.tools.lte_argon_tables import lte_keys

    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    mix, tr = load_lte_setup(IniInput.parse(lte_keys(table_dim, build)),
                             dim, dim)
    fl = Fluxes(mixture=mix, transport=tr,
                eq_system="euler" if euler else "navier-stokes")
    return RHSContext(fluxes=fl, riemann=Rusanov(fl))


def lte_U(mix, xyz, dtype, device, L=0.01):
    """A hot LTE state on an L box: rho 0.05, u ~10 m/s, T 9,500 K with a
    20% wave, 2-D or 3-D."""
    dim = xyz.shape[-1]
    k = 2 * np.pi / L
    wave = np.sin(k * xyz[..., 0]) * np.cos(k * xyz[..., 1])
    if dim == 3:
        wave = wave * np.cos(k * xyz[..., 2])
    Up = np.zeros(xyz.shape[:-1] + (dim + 2,))
    Up[..., 0] = 0.05 * (1 + 0.1 * wave)
    Up[..., 1] = 10.0 + 30.0 * wave
    Up[..., 2:1 + dim] = -5.0 * wave[..., None]
    Up[..., -1] = 9500.0 * (1 + 0.2 * wave)
    U = mix.conservatives(torch.as_tensor(Up, dtype=torch.float64))
    return U.to(dtype=dtype, device=device).contiguous()


def lte_deck_text(name, n, table_dim=1, dim=2, euler=False, iters=4):
    """A path of an LTE variant through the CLI: the shipped channel's flow
    keys on a periodic n^dim p=2 GL box (`type = flow`, no coil), 1-D or
    2-D tables, NS or Euler, `iters` steps of dt 4e-9, output in
    build/<name>."""
    with open(LTE_DECK) as f:
        text = f.read()
    from tps_torch.tools.lte_argon_tables import lte_keys

    start = text.index("[flow/lte]")
    end = text.index("[plasma_models]")
    text = text[:start] + lte_keys(table_dim, os.path.join(
        REPO, "build")) + "\n" + text[end:]
    text = text.replace("type = cycle-avg-joule-coupled", "type = flow", 1)
    mesh = "".join(f"n{a} = {n}\n{a}1 = 0.01\nperiodic_{a} = 1\n"
                   for a in "xyz"[:dim])
    start = text.index("[mesh]\n") + len("[mesh]\n")
    text = (text[:start] + f"generator = box{dim}d\n" + mesh
            + text[text.index("\n[time]"):])
    bstart = text.index("[boundaryConditions]")
    text = text[:bstart] + text[text.index("[em]"):]
    if euler:
        text = text.replace("equation_system = navier-stokes",
                            "equation_system = euler")
    text = text.replace("maxIters = 200", f"maxIters = {iters}")
    text = text.replace("examples/cases/nec_table.h5",
                        os.path.join(REPO, "examples", "cases",
                                     "nec_table.h5"))
    text = text.replace("outdirBase = output/lte_channel_coupled",
                        f"outdirBase = {os.path.join(REPO, 'build', name)}")
    path = os.path.join(REPO, "build", name + ".ini")
    with open(path, "w") as f:
        f.write(text)
    return path


def lte_channel_deck(name, n=64, iters=200):
    """tps_torch/tools/lte_channel_coupled.ini with its tables named by
    absolute path (it names them from the repository root), its flow mesh
    n x n and `iters` steps, output in build/<name>."""
    with open(LTE_DECK) as f:
        text = f.read()
    for rel in ("tps_torch/tools/lte_argon_thermo.h5",
                "tps_torch/tools/lte_argon_trans.h5",
                "examples/cases/nec_table.h5"):
        text = text.replace(rel, os.path.join(REPO, rel))
    text = text.replace("nx = 64", f"nx = {n}").replace("ny = 64",
                                                          f"ny = {n}")
    text = text.replace("maxIters = 200", f"maxIters = {iters}")
    text = text.replace("outdirBase = output/lte_channel_coupled",
                        f"outdirBase = {os.path.join(REPO, 'build', name)}")
    path = os.path.join(REPO, "build", name + ".ini")
    with open(path, "w") as f:
        f.write(text)
    return path


def phase_lte_faces(dev, cases=LTE_FACE_CASES):
    """Phase 38: the face sweep's LTE variants against their plain
    versions, f64 within LTE_F64_TOL and f32 by TOL's rule, each at the
    width of its path, timed in f32 (kernel, plain, kernel) and f64 (CUDA
    events and on the device) with its bound; then each variant's path
    but the headline's (phase 39) through the CLI, 2 steps in f32: its
    variant once a stage, no other.  Returns {variant: record} and the
    largest f64 error."""
    from tps_torch.dg.cuda_faces import build_face_sweep
    from tps_torch.dg.discretization import build_tables
    from tps_torch.mesh.generators import box_2d, box_3d

    failures, out, worst = [], {}, 0.0
    for var, td, n in cases:
        t0 = time.perf_counter()
        dim, euler = len(n), var.endswith("euler")
        ctx = lte_ctx(td, dim, euler)
        if dim == 3:
            mesh = box_3d(*n, bounds=((0.0, 0.01),) * 3, periodic=(True,) * 3)
        else:  # the channel's mesh: periodic along y, walls at x
            mesh = box_2d(*n, x1=0.01, y1=0.01, periodic_x=td == 2,
                          periodic_y=True)
        tab_np = build_tables(mesh, 2)
        tab64 = tab_np.to_torch(torch.float64, dev)
        tab32 = tab_np.to_torch(torch.float32, dev)
        sw64, sw32 = build_face_sweep(tab64, ctx), build_face_sweep(tab32, ctx)
        X64 = face_input(ctx, tab64, lte_U(ctx.mixture, tab_np.xyz_dof,
                                           torch.float64, dev))
        X32 = X64.float()
        y64, p64 = sw64(X64), sw64.plain(X64)
        r64 = rel(y64, p64)
        k32, p32 = sw32(X32), sw32.plain(X32)
        ref = sw64.plain(X32.double())
        r32 = rel(k32, p32)
        dk, dp = rel(k32.double(), ref), rel(p32.double(), ref)
        name = f"{var} {'x'.join(map(str, n))} p=2 gl"
        ok = (r64 <= LTE_F64_TOL and sw64.variant == var
              and (r32 <= TOL[torch.float32] or dk <= 2 * dp))
        log(f"  {name} (NEQ {sw64.neq}, k {sw64.k}, {tab_np.ne} elements, "
            f"set-up {time.perf_counter() - t0:.1f} s): f64 {r64:.3e} (bar "
            f"{LTE_F64_TOL}); f32 {r32:.3e} (bar {TOL[torch.float32]}, or "
            f"f64 dist: kernel {dk:.3e} <= 2 x plain {dp:.3e})"
            + ("" if ok else "  FAIL"))
        worst = max(worst, r64)
        if not ok:
            failures.append(name)
        ms = [cuda_ms(lambda: sw32(X32), 30), cuda_ms(lambda: sw32.plain(X32), 1),
              cuda_ms(lambda: sw32(X32), 30)]
        b = face_bound(tab_np, ctx.fluxes.eq_system, "gl", neq=sw64.neq,
                       flux_ops=lte_ops(dim, td, euler))
        out[var] = {
            "grid": name, "neq": sw64.neq, "nodes": tab_np.ne * tab_np.ndof,
            "ms": (ms[0] + ms[2]) / 2, "plain_ms": ms[1],
            "device_ms": kernel_ms(lambda: sw32(X32), "face_sweep", 10),
            "f64_ms": cuda_ms(lambda: sw64(X64), 20),
            "bound_ms": b[0], "bound_by": b[1], "ops_ms": b[2],
            "bytes_ms": b[3], "ops_per_point": lte_ops(dim, td, euler),
            "f64_rel_err": r64,
            "max_abs_err": float(torch.max(torch.abs(k32 - p32))),
            "f32_rel": r32, "f32_f64_dist": dk, "plain_f32_f64_dist": dp,
            "turns": ms}
        log(f"  timing {name} f32: {out[var]}")
        del tab64, tab32, sw64, sw32, X64, X32, y64, p64, k32, p32, ref
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    if failures:
        raise SystemExit(f"face sweep parity on the LTE fluid failed: "
                         f"{failures}")
    for var, td, n in cases:
        if var == "lte_2d":
            continue  # the headline deck's, phase 39
        dim = len(n)
        path = lte_deck_text(f"deck_{var}", n[0], td, dim,
                             var.endswith("euler"), iters=2)
        tps = channel_tps(torch.float32, f"deck_{var}", path=path)
        s = tps.solver
        reset_all_launches()
        tps.solve()
        torch.cuda.synchronize()
        counts = launches_by_variant()
        want = {"face_sweep": 4 * s.iter, f"face_sweep/{var}": 4 * s.iter}
        bad = {k: v for k, v in counts.items() if v != want.get(k, 0)}
        finite = bool(torch.isfinite(s.U).all())
        log(f"  {var}'s path ({s.tables_np.ne} elements p=2 GL, f32): "
            f"{s.iter} steps, launches {counts}, finite {finite}, step "
            f"graph {s._loop.graph is not None}")
        if (bad or not finite or tps.get_status() != 0
                or s._loop.graph is None):
            raise SystemExit(f"{var}: the CLI run failed its checks "
                             f"(launches off: {bad})")
        out[var]["launches"] = counts[f"face_sweep/{var}"]
        del tps, s
    return out, worst


def phase_lte_channel(dev):
    """Phase 39: tps_torch/tools/lte_channel_coupled.ini (the LTE-table
    plasma under the Joule coupling, 64x64 p=2 GL, EM every 10 steps)
    through the CLI (f32, 100 of its 200 steps) with the launch counts set
    to 0 before it: the 2-D LTE sweep 4 times a step, no other variant;
    finite; the steps replayed the step graph; the power on target at
    each EM solve.  Then 12 f64 steps (EM updates at 0 and 10): at 64x64
    through the step graph (its checkpoint is phase 40's), and at 8x8
    the step graph against eager steps within GRAPH_TOL and the card
    against the port's CPU run, U within LTE_CPU_TOL and the Joule
    heating within CHANNEL_CPU_TOL; the power within POWER_TOL.  Then
    ms/step graph and eager through the coupled solve() on the shipped
    f32 run's solver (phase 37's turns, from step 100)."""
    tps = channel_tps(torch.float32, "lte_channel",
                      path=lte_channel_deck("lte_channel", iters=100))
    c = tps.solver
    reset_all_launches()
    t0 = time.perf_counter()
    tps.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches_by_variant()
    steps = c.flow.iter
    want = {"face_sweep": 4 * steps, "face_sweep/lte_2d": 4 * steps}
    bad = {k: v for k, v in counts.items() if v != want.get(k, 0)}
    finite = all(bool(torch.isfinite(v).all())
                 for v in channel_state(c).values())
    power32 = channel_power(c)
    T = c.flow.mixture.temperature(c.flow.U)
    log(f"  f32: {steps} of the deck's 200 steps in {wall:.1f} s, "
        f"{len(c.em_log)} "
        f"EM solves; launches {counts}; finite {finite}; |Joule after "
        f"control / target - 1| <= {power32:.2e} (f32); T {float(T.min()):.2f}"
        f"-{float(T.max()):.2f} K; step graph {c.flow._loop.graph is not None}"
        f", launches a replay {c.flow._loop.per_replay}")
    if (bad or not finite or tps.get_status() != 0 or steps != 100
            or len(c.em_log) != 10 or c.flow._loop.graph is None):
        raise SystemExit(f"the LTE channel's CLI run failed its checks "
                         f"(launches off: {bad})")
    out = {"as shipped f32": {"steps": steps, "wall_s": wall,
                              "launches": counts, "power_err_f32": power32}}
    shipped = c
    del tps
    runs = {}
    for name, n, device, graphs in (("graph", 64, "cuda", True),
                                    ("card8", 8, "cuda", True),
                                    ("eager8", 8, "cuda", False),
                                    ("cpu8", 8, "cpu", True)):
        tps = channel_tps(torch.float64, f"lte_{name}", device=device,
                          path=lte_channel_deck(f"lte_{name}", n, 12))
        c = tps.solver
        c.flow.cuda_graphs = graphs
        tps.solve()
        runs[name] = ({k: v.double().cpu().clone()
                       for k, v in channel_state(c).items()},
                      channel_power(c), len(c.em_log))
    graph_d = {k: (state_rel(runs["card8"][0][k], runs["eager8"][0][k])
                   if k == "U" else lrel(runs["card8"][0][k],
                                         runs["eager8"][0][k]))
               for k in runs["card8"][0]}
    cpu_d = {k: (state_rel(runs["card8"][0][k], runs["cpu8"][0][k])
                 if k == "U" else lrel(runs["card8"][0][k],
                                       runs["cpu8"][0][k]))
             for k in runs["card8"][0]}
    power = max(r[1] for r in runs.values())
    ok = (max(graph_d.values()) <= GRAPH_TOL and cpu_d["U"] <= LTE_CPU_TOL
          and max(cpu_d.values()) <= CHANNEL_CPU_TOL and power <= POWER_TOL
          and all(r[2] == 2 for r in runs.values()))
    log(f"  f64, 12 steps (EM updates at 0 and 10), 8x8: graph vs eager "
        f"{graph_d} (bar {GRAPH_TOL}); card vs the port's CPU run "
        f"{cpu_d} (bars U {LTE_CPU_TOL}, fields {CHANNEL_CPU_TOL}); "
        f"|Joule / target - 1| <= {power:.2e} (bar {POWER_TOL})"
        + ("" if ok else "  FAIL"))
    if not ok:
        raise SystemExit("the LTE channel: card, CPU and eager differ")
    out.update({"f64 graph vs eager": graph_d, "f64 card vs cpu 8x8": cpu_d,
                "power_err_f64": power})
    # the f32 run's solver, its graph captured, times on from step 100
    out["solve() ms/step"] = phase_channel_timing({"lte channel f32":
                                                   shipped})
    return out


def lte_restart_deck(name, ckpt, n=64, iters=4):
    """tests/inputs/argon_full.ini at n x n p=2 GL (the LTE channel's mesh
    and basis) with io/restartFromLTE: the checkpoint `ckpt` copied into
    build/<name>, converted at its iteration, `iters` steps to run (RK3,
    f64: the radiative decay needs it)."""
    import shutil

    from tps_torch.io import h5lite

    outdir = os.path.join(REPO, "build", name)
    os.makedirs(outdir, exist_ok=True)
    shutil.copy(ckpt, os.path.join(outdir, "restart_output.sol.h5"))
    it0 = int(h5lite.read(ckpt).attrs["iteration"])
    with open(FULL_DECK) as f:
        text = f.read()
    text = text.replace("nx = 4\n", f"nx = {n}\n").replace(
        "ny = 4\n", f"ny = {n}\n")
    text = text.replace("order = 1", "order = 2\nbasisType = 0\n"
                        "integrationRule = 0\ntimingFreq = 100000")
    text = text.replace("maxIters = 4", f"maxIters = {it0 + iters}")
    text = text.replace("outputFreq = 10", "outputFreq = 100000")
    text = text.replace("outdirBase = /tmp/tps_tpu_argon_full",
                        f"outdirBase = {outdir}")
    text += "\nrestartFromLTE = 1\nenableRestart = 1\n"
    path = os.path.join(REPO, "build", name + ".ini")
    with open(path, "w") as f:
        f.write(text)
    return path


def phase_lte_restart(dev):
    """Phase 40: phase 39's 64x64 f64 checkpoint (12 steps of the LTE
    channel) converted by tests/inputs/argon_full.ini with restartFromLTE
    into the six-species two-temperature state, on the card and on the
    CPU: the two within LTE_CONVERT_TOL, mass, momentum and energy kept,
    the converted T against the LTE run's (the tables' interpolation
    error, reported), the converted restart written at once with the
    reference's dataset names; then 4 steps of LTE_RESTART_DT on the card
    (RK3, f64), the six-species sweep once a stage and no other variant,
    finite."""
    from tps_torch.io import h5lite

    ckpt = os.path.join(REPO, "build", "lte_graph", "restart_output.sol.h5")
    f = h5lite.read(ckpt)
    ne = int(f.attrs["ne_global"])
    U_lte = torch.as_tensor(np.stack([np.asarray(f["solution"][k]).reshape(
        ne, -1) for k in ("density", "x-mom", "y-mom", "rho-E")], -1))
    T_lte = lte_ctx(1, 2, False).mixture.temperature(U_lte)
    conv = {}
    t0 = time.perf_counter()
    for device in ("cuda", "cpu"):
        tps = channel_tps(torch.float64, f"lte_convert_{device}",
                          device=device, path=lte_restart_deck(
                              f"lte_convert_{device}", ckpt))
        conv[device] = tps
    s, s_cpu = conv["cuda"].solver, conv["cpu"].solver
    U_card, U_cpu = s.U.double().cpu().clone(), s_cpu.U.double().clone()
    conv_s = time.perf_counter() - t0
    d_cpu = state_rel(U_card, U_cpu)
    kept = state_rel(U_card[..., :4], U_lte)
    T_conv = s_cpu.mixture.temperatures(U_cpu)[0]
    dT = float(torch.max(torch.abs(T_conv - T_lte)))
    written = h5lite.read(os.path.join(REPO, "build", "lte_convert_cuda",
                                       "restart_output.sol.h5"))
    want_names = {"density", "x-mom", "y-mom", "rho-E", "rho-Y_Ar.+1",
                  "rho-Y_Ar_m", "rho-Y_Ar_r", "rho-Y_Ar_p", "rhoE_e"}
    s.set_time(float(s.time), LTE_RESTART_DT)
    reset_all_launches()
    it0 = s.iter
    conv["cuda"].solve()
    torch.cuda.synchronize()
    counts = launches_by_variant()
    steps = s.iter - it0
    want = {"face_sweep": 3 * steps, "face_sweep/gas_mixture": 3 * steps}
    bad = {k: v for k, v in counts.items() if v != want.get(k, 0)}
    finite = bool(torch.isfinite(s.U).all())
    ok = (d_cpu <= LTE_CONVERT_TOL and kept <= LTE_CONVERT_TOL
          and set(written["solution"].keys()) == want_names
          and not bad and finite and steps == 4)
    log(f"  converted {ne} elements ({conv_s:.1f} s, card and CPU): card vs "
        f"CPU {d_cpu:.3e} (bar {LTE_CONVERT_TOL}); bulk fields kept "
        f"{kept:.3e}; |T converted - T of the LTE run| max {dT:.4e} K (T "
        f"{float(T_lte.min()):.2f}-{float(T_lte.max()):.2f} K); datasets "
        f"{sorted(written['solution'].keys())}; then {steps} steps: launches "
        f"{counts}, finite {finite}" + ("" if ok else "  FAIL"))
    if not ok:
        raise SystemExit(f"the LTE restart failed its checks (launches off: "
                         f"{bad})")
    return {"card_vs_cpu": d_cpu, "bulk_kept": kept, "max_dT_K": dT,
            "launches": counts, "convert_s": conv_s}


# ---------------------------------------------------------------- axisymmetric

# the axisymmetric compressible flow with swirl (phases 41-43)
TORCH_AXI_DECK = os.path.join(REPO, "tps_torch", "tools",
                              "argon_torch_axisym.ini")
PIPE_DECK = os.path.join(REPO, "tps_torch", "tools", "axisym_pipe.ini")
# the face flux per point of the axisymmetric policies (an estimate, as
# MIX_OPS): DryAir's 2-D Navier-Stokes flux (FACE_OPS' 3-D count less a
# fifth for the 2-D stress and normals) plus the swirl's convective term,
# u_r / r, the swirl row and its work (~15 a side); Euler as 3-D Euler;
# the argon policies' 2-D counts plus the same swirl terms
AXI_OPS = {"dry_air_axi": FACE_OPS["navier-stokes"] * 4 // 5 + 30,
           "dry_air_axi_euler": FACE_OPS["euler"],
           "argon_axi": MIX_FACE_OPS + 30,
           "argon_axi_euler": MIX_OPS["argon_euler"] + 6}
# (record key, variant, equations, geometry): DryAir on the strip of
# tests/test_axisymmetric.py (r in [0.2, 1.2], z periodic), the argon
# policies on the torch deck's (r, z) box, which touches the axis; 64x64
# p=2 GL, the torch deck's width
AXI_FACE_CASES = (("dry_air_axi", "dry_air_axi", "navier-stokes", "strip"),
                  ("dry_air_axi_euler", "dry_air_axi", "euler", "strip"),
                  ("argon_axi", "argon_axi", "navier-stokes", "torch"),
                  ("argon_axi_euler", "argon_axi_euler", "euler", "torch"))


def axi_case(var, eq, geom, n=64):
    """(RHS context, numpy tables, primitives) of an axisymmetric variant:
    DryAir with Sutherland transport or the torch deck's argon ternary,
    nvel = 3, on n x n p=2 GL axisymmetric tables; a perturbed state with
    a rigid swirl (u_t = 5 r on the strip, 500 r on the 0.01 m box)."""
    from tps_torch.config.ini import IniInput
    from tps_torch.dg.discretization import build_tables
    from tps_torch.dg.fluxes import Fluxes
    from tps_torch.dg.rhs import RHSContext
    from tps_torch.dg.riemann import Rusanov
    from tps_torch.mesh.generators import box_2d
    from tps_torch.physics.gas import DryAir
    from tps_torch.physics.plasma_config import build_plasma
    from tps_torch.physics.transport import DryAirTransport

    if var.startswith("dry_air"):
        mix = DryAir(dim=2, nvel=3)
        tr = None if eq == "euler" else DryAirTransport(
            mix.gas_constant, mix.specific_heat_ratio)
    else:
        pl = build_plasma(IniInput.read(TORCH_AXI_DECK), 2, 3)
        mix, tr = pl.mixture, None if eq == "euler" else pl.transport
    fl = Fluxes(mixture=mix, transport=tr, eq_system=eq, axisymmetric=True)
    if geom == "strip":
        mesh, L, swirl = box_2d(n, n, x0=0.2, x1=1.2, y1=1.0,
                                periodic_y=True), 1.0, 5.0
    else:
        mesh, L, swirl = box_2d(n, n, x1=0.01, y1=0.01), 0.01, 500.0
    tab_np = build_tables(mesh, 2, axisymmetric=True)
    xyz = tab_np.xyz_dof
    k = 2 * np.pi / L
    wave = np.sin(k * xyz[..., 0]) * np.cos(k * xyz[..., 1])
    Up = np.zeros(xyz.shape[:-1] + (mix.num_equations,))
    if var.startswith("dry_air"):
        Up[..., 0], Up[..., 4] = 1.2 * (1 + 0.05 * wave), 300.0 + 20 * wave
    else:
        Up[..., 0] = 1.6 * (1 + 0.05 * wave)
        Up[..., 4] = 1800.0 * (1 + 0.05 * wave)
        Up[..., 5] = 1e-3 * 1.6 / mix.mw[0] * (1 + 0.2 * wave)
        Up[..., 6] = 9000.0 * (1 - 0.1 * wave)
    Up[..., 1], Up[..., 2] = 3.0 * wave, 10.0 - 2.0 * wave
    Up[..., 3] = swirl * xyz[..., 0]
    return RHSContext(fluxes=fl, riemann=Rusanov(fl)), tab_np, Up


def phase_axi_faces(dev):
    """Phase 41: the face sweep's axisymmetric variants (dry_air_axi on
    Navier-Stokes and Euler, argon_axi, argon_axi_euler) against their
    plain versions, f64 within TOL and f32 by TOL's rule; each timed in
    f32 (kernel, plain, kernel: CUDA events), on the device (profiler) and
    in f64, with its bound.  Returns {case: record} and the largest f64
    error."""
    from tps_torch.dg.cuda_faces import build_face_sweep

    failures, out, worst = [], {}, 0.0
    for key, var, eq, geom in AXI_FACE_CASES:
        t0 = time.perf_counter()
        ctx, tab_np, Up = axi_case(var, eq, geom)
        U = ctx.mixture.conservatives(torch.as_tensor(Up, device=dev))
        tab64 = tab_np.to_torch(torch.float64, dev)
        tab32 = tab_np.to_torch(torch.float32, dev)
        sw64, sw32 = build_face_sweep(tab64, ctx), build_face_sweep(tab32, ctx)
        X64 = face_input(ctx, tab64, U)
        X32 = X64.float()
        reset_all_launches()
        y64 = sw64(X64)
        k32 = sw32(X32)
        torch.cuda.synchronize()
        counted = launches_by_variant()[f"face_sweep/{var}"]
        p64, p32 = sw64.plain(X64), sw32.plain(X32)
        ref = sw64.plain(X32.double())
        r64, r32 = rel(y64, p64), rel(k32, p32)
        dk, dp = rel(k32.double(), ref), rel(p32.double(), ref)
        swirl = float(p64[..., 3].abs().max()) > 0.0
        name = f"{key} {geom} 64x64 p=2 gl"
        ok = (r64 <= TOL[torch.float64] and sw64.variant == var
              and counted == 2 and swirl
              and (r32 <= TOL[torch.float32] or dk <= 2 * dp))
        log(f"  {name} (NEQ {sw64.neq}, k {sw64.k}, {tab_np.ne} elements, "
            f"set-up {time.perf_counter() - t0:.1f} s): f64 {r64:.3e} (bar "
            f"{TOL[torch.float64]}); f32 {r32:.3e} (bar {TOL[torch.float32]}"
            f", or f64 dist: kernel {dk:.3e} <= 2 x plain {dp:.3e}); "
            f"launches under {var}: {counted}" + ("" if ok else "  FAIL"))
        worst = max(worst, r64)
        if not ok:
            failures.append(name)
        ms = [cuda_ms(lambda: sw32(X32), 30),
              cuda_ms(lambda: sw32.plain(X32), 3),
              cuda_ms(lambda: sw32(X32), 30)]
        b = face_bound(tab_np, eq, "gl", neq=sw64.neq, flux_ops=AXI_OPS[key],
                       axi=True)
        out[key] = {
            "grid": name, "variant": var, "neq": sw64.neq, "k": sw64.k,
            "nodes": tab_np.ne * tab_np.ndof,
            "ms": (ms[0] + ms[2]) / 2, "plain_ms": ms[1],
            "device_ms": kernel_ms(lambda: sw32(X32), "face_sweep", 20),
            "f64_ms": cuda_ms(lambda: sw64(X64), 20),
            "f64_device_ms": kernel_ms(lambda: sw64(X64), "face_sweep", 20),
            "bound_ms": b[0], "bound_by": b[1], "ops_ms": b[2],
            "bytes_ms": b[3], "f64_rel_err": r64,
            "max_abs_err": float(torch.max(torch.abs(k32 - p32))),
            "f32_rel": r32, "f32_f64_dist": dk, "plain_f32_f64_dist": dp,
            "turns": ms}
        log(f"  timing {name} f32: {out[key]}")
        del tab64, tab32, sw64, sw32, X64, X32, y64, p64, k32, p32, ref
        torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"face sweep parity on the axisymmetric variants "
                         f"failed: {failures}")
    return out, worst


def euler_text(text):
    """A deck's text on Euler: its viscous adiabatic walls inviscid (a
    viscous wall's flux reads the gradient, which Euler does not form, in
    both packages)."""
    return text.replace("equation_system = navier-stokes",
                        "equation_system = euler").replace(
        "type = viscous_adiabatic", "type = inviscid")


def axi_f64_run(path, tag, device):
    """Phases 42 and 45's CPU run: the deck's first 3 f64 steps on device:
    its state on the CPU, and its steps, EM solves, power error, status
    and kernel launches."""
    tps = channel_tps(torch.float64, f"{tag}_cpu3", device=device, iters=3,
                      path=path)
    c = tps.solver
    reset_all_launches()
    tps.solve()
    return ({k: v.double().cpu().clone() for k, v in channel_state(c).items()},
            {"steps": c.flow.iter, "em_solves": len(c.em_log),
             "power": channel_power(c), "status": tps.get_status(),
             "launches": {k: v for k, v in launches_by_variant().items()
                          if v}})


def phase_torch_axi(dev, refs, path=TORCH_AXI_DECK, var="argon_axi",
                    tag="torch_axi", euler="argon_axi_euler",
                    cpu_tol=CHANNEL_CPU_TOL):
    """Phase 42: tps_torch/tools/argon_torch_axisym.ini (the compressible
    argon torch in (r, z) with swirl under the Joule coupling, 64x64 p=2
    GL, EM every 10 steps) through the CLI, 20 steps in f32 and in f64,
    with the launch counts set to 0 before each: the argon_axi sweep 4
    times a step, no other variant; finite; the steps replayed the step
    graph; the power on target at each EM solve.  (Phase 45 runs the same
    on another deck, `path`, whose sweep is variant `var`, without the
    Euler run.)  The f64 run at its step
    12 against 12 eager steps (EM updates at 0 and 10) within GRAPH_TOL,
    and at its step 3 against the port's CPU run of 3 steps (in refs'
    worker): U within `cpu_tol`, the Joule heating, E-field and EM
    potential within CHANNEL_CPU_TOL.  Then
    ms/step graph and eager through the coupled solve() on the f32 run's
    solver (phase 37's turns, from step 20); then the deck on Euler, 2
    steps in f32, its sweep, variant `euler` (none where None), 4 times a
    step."""
    out, runs = {}, {}
    shipped = None
    for name, dtype, device, graphs, iters in (
            ("f32", torch.float32, "cuda", True, 20),
            ("f64", torch.float64, "cuda", True, 20),
            ("eager", torch.float64, "cuda", False, 12)):
        tps = channel_tps(dtype, f"{tag}_{name}", device=device,
                          iters=iters, path=path)
        c = tps.solver
        c.flow.cuda_graphs = graphs
        reset_all_launches()
        t0 = time.perf_counter()
        if name == "f64":  # its states at step 3 and 12 for the CPU's
            for stop in (3, 12):  # and the eager run's
                c.flow.config.max_iters = stop
                tps.solve()
                runs[f"card{stop}"] = {k: v.double().cpu().clone()
                                       for k, v in channel_state(c).items()}
            c.flow.config.max_iters = iters
        tps.solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches_by_variant()
        steps = c.flow.iter
        want = {"face_sweep": 4 * steps, f"face_sweep/{var}": 4 * steps}
        bad = {k: v for k, v in counts.items() if v != want.get(k, 0)}
        state = {k: v.double().cpu().clone()
                 for k, v in channel_state(c).items()}
        finite = all(bool(torch.isfinite(v).all()) for v in state.values())
        power = channel_power(c)
        runs[name] = state
        Up = c.flow.mixture.primitives(c.flow.U)
        log(f"  {name}: {steps} steps in {wall:.1f} s, {len(c.em_log)} EM "
            f"solves; launches {counts}; finite {finite}; |Joule after "
            f"control / target - 1| <= {power:.2e}; T_e max "
            f"{float(Up[..., -1].max()):.1f} K, max|u_t| "
            f"{float(Up[..., 3].abs().max()):.4f} m/s; step graph "
            f"{c.flow._loop.graph is not None}")
        if (bad or not finite or tps.get_status() != 0 or steps != iters
                or len(c.em_log) != (iters + 9) // 10
                or (dtype == torch.float64 and power > POWER_TOL)
                or (graphs and c.flow._loop.graph is None)):
            raise SystemExit(f"{os.path.basename(path)}'s {name} run "
                             f"failed its checks (launches off: {bad})")
        if name in ("f32", "f64"):
            out[name] = {"steps": steps, "wall_s": wall, "launches": counts,
                         "power_err": power}
        if name == "f32":
            shipped = c
        del tps, c
    runs["cpu3"], cpu3 = refs.get(tag)
    finite = all(bool(torch.isfinite(v).all()) for v in runs["cpu3"].values())
    log(f"  cpu3: {cpu3['steps']} steps, {cpu3['em_solves']} EM solves; "
        f"launches {cpu3['launches']}; finite {finite}; |Joule after "
        f"control / target - 1| <= {cpu3['power']:.2e}")
    if (cpu3["launches"] or not finite or cpu3["status"] != 0
            or cpu3["steps"] != 3 or cpu3["em_solves"] != 1
            or cpu3["power"] > POWER_TOL):
        raise SystemExit(f"{os.path.basename(path)}'s cpu3 run failed its "
                         "checks")
    graph_d = {k: (state_rel(runs["card12"][k], runs["eager"][k], nvel=3)
                   if k == "U" else lrel(runs["card12"][k], runs["eager"][k]))
               for k in runs["card12"]}
    cpu_d = {k: (state_rel(runs["card3"][k], runs["cpu3"][k], nvel=3)
                 if k == "U" else lrel(runs["card3"][k], runs["cpu3"][k]))
             for k in runs["card3"]}
    ok = (max(graph_d.values()) <= GRAPH_TOL and cpu_d["U"] <= cpu_tol
          and max(cpu_d.values()) <= CHANNEL_CPU_TOL)
    log(f"  f64: graph vs eager, 12 steps (EM updates at 0 and 10) "
        f"{graph_d} (bar {GRAPH_TOL}); card vs the port's CPU run, 3 steps "
        f"{cpu_d} (bars U {cpu_tol}, fields {CHANNEL_CPU_TOL})"
        + ("" if ok else "  FAIL"))
    if not ok:
        raise SystemExit(f"{os.path.basename(path)}: card, CPU and eager "
                         "differ")
    out.update({"f64 graph vs eager": graph_d, "f64 card vs cpu": cpu_d})
    out["solve() ms/step"] = phase_channel_timing(
        {f"{os.path.basename(path)} f32": shipped})
    del shipped
    if not euler:
        return out
    # the Euler variant's path: the deck on Euler through the CLI, f32, 2
    # steps
    with open(path) as f:
        text = euler_text(f.read())
    path = os.path.join(REPO, "build", f"{tag}_euler.ini")
    with open(path, "w") as f:
        f.write(text)
    tps = channel_tps(torch.float32, f"{tag}_euler", iters=2, path=path)
    reset_all_launches()
    tps.solve()
    torch.cuda.synchronize()
    counts = launches_by_variant()
    want = {"face_sweep": 8, f"face_sweep/{euler}": 8}
    bad = {k: v for k, v in counts.items() if v != want.get(k, 0)}
    finite = bool(torch.isfinite(tps.solver.flow.U).all())
    log(f"  Euler, f32, 2 steps: launches {counts}; finite {finite}")
    if bad or not finite or tps.get_status() != 0:
        raise SystemExit(f"{os.path.basename(path)} failed its checks "
                         f"(launches off: {bad})")
    out["euler f32"] = {"steps": 2, "launches": counts}
    return out


def phase_pipe(dev, n=(32, 128), steps=20):
    """Phase 43: tps_torch/tools/axisym_pipe.ini (DryAir Navier-Stokes
    with swirl state, RK3 CFL steps; axis, isothermal wall, inlet and
    pressure outlet) at 32x128 p=2 GL through the solver in f64 (the
    dry_air_axi sweep 3 times a step, the step graph) against a plain
    RK3 loop over compute_rhs with the plain face sweep and the solver's
    CFL dt rule, within SOLVER_TOL.  Then the deck on Euler (its
    isothermal wall inviscid: Euler has no transport) through the CLI, 2
    steps in f32: the dry_air_axi sweep's Euler form 3 times a step."""
    from tps_torch.dg.cuda_faces import face_sweep_plain
    from tps_torch.dg.rhs import compute_rhs

    with open(PIPE_DECK) as f:
        text = f.read()
    text = (text.replace("nx = 4\n", f"nx = {n[0]}\n")
            .replace("ny = 8\n", f"ny = {n[1]}\n")
            .replace("maxIters = 4\n", f"maxIters = {steps}\n"))
    path = os.path.join(REPO, "build", "axisym_pipe.ini")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    tps = channel_tps(torch.float64, "axisym_pipe", path=path)
    s = tps.solver
    U0, dt0 = s.U.clone(), float(s.dt)
    reset_all_launches()
    t0 = time.perf_counter()
    tps.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches_by_variant()
    U_solver = s.U.clone()
    plain = functools.partial(face_sweep_plain, s.ctx, s.tables)
    bc_states = tuple(None for _ in s.ctx.bcs)

    def rhs(U, t):
        return compute_rhs(s.ctx, s.tables, U, t, bc_states=bc_states,
                           sweep=plain)

    rc = s.config
    U, t, dt = U0, 0.0, dt0
    for _ in range(steps):
        U, aux = s._integrator(rhs, U, t, dt)
        t += dt
        dt = rc.cfl * s.hmin / aux["max_char_speed"] / s.mesh.dim
    err, moved = rel(U_solver, U), rel(U_solver, U0)
    want = {"face_sweep": 3 * steps, "face_sweep/dry_air_axi": 3 * steps}
    bad = {k: v for k, v in counts.items() if v != want.get(k, 0)}
    ok = (err <= SOLVER_TOL and moved > 0 and not bad
          and s._loop.graph is not None and s.iter == steps)
    log(f"  {n[0]}x{n[1]} p=2, {steps} RK3 steps in {wall:.1f} s: "
        f"max|U_kernel - U_plain|/max|U_plain| = {err:.3e} (bar "
        f"{SOLVER_TOL}); moved {moved:.3e}; t {float(s.time):.6e} vs plain "
        f"{float(t):.6e}; launches {counts}" + ("" if ok else "  FAIL"))
    if not ok:
        raise SystemExit("the axisymmetric pipe: solver vs plain RK3 loop "
                         f"failed (launches off: {bad})")
    out = {"solver_vs_plain": err, "moved": moved, "wall_s": wall,
           "launches": counts}
    text = (text.replace("equation_system = navier-stokes",
                         "equation_system = euler")
            .replace("type = viscous_isothermal\ntemperature = 300\n",
                     "type = inviscid\n"))
    path = os.path.join(REPO, "build", "axisym_pipe_euler.ini")
    with open(path, "w") as f:
        f.write(text)
    tps = channel_tps(torch.float32, "axisym_pipe_euler", iters=2, path=path)
    s = tps.solver
    reset_all_launches()
    tps.solve()
    torch.cuda.synchronize()
    counts = launches_by_variant()
    want = {"face_sweep": 6, "face_sweep/dry_air_axi": 6}
    bad = {k: v for k, v in counts.items() if v != want.get(k, 0)}
    finite = bool(torch.isfinite(s.U).all())
    euler = (s.ctx.fluxes.eq_system == "euler"
             and not s._rhs.sweep.viscous)
    log(f"  Euler, f32, 2 steps: launches {counts}; finite {finite}; the "
        f"sweep's Euler form {euler}")
    if bad or not finite or not euler or tps.get_status() != 0:
        raise SystemExit(f"the axisymmetric pipe on Euler failed its checks "
                         f"(launches off: {bad})")
    out["euler f32"] = {"steps": 2, "launches": counts}
    return out


# ---------------------------------------------------------------- closures

# Roe and the compressible closures (phases 44-46)
ML_DECK = os.path.join(REPO, "tps_torch", "tools", "argon_torch_axisym_ml.ini")
LES_DECK = os.path.join(REPO, "tps_torch", "tools", "les_channel3d.ini")
# the face flux per point with the closure step, counted from
# csrc/dg_pointwise.cuh::closure_step as FACE_OPS is (an estimate): per
# side the strain |S| (2-D 16, 3-D 36, the swirl's 15 more), the mixing
# length 8 past it, Smagorinsky 8 past it, Sigma's g^T g and closed-form
# eigenvalues ~90 (3-D), the SGS update 6 and the sponge 3; and the Roe
# combination's waves, ~75 a point more than Rusanov's


def closure_flux_ops(base, closure, eq):
    """Operations per face point of a variant of tps_torch/tools/
    closure_cases.py (its base flux, FACE_OPS / MIX_OPS / AXI_OPS, plus
    two sides' closure steps and Roe's waves)."""
    from tps_torch.tools.closure_cases import BASES

    fluid, dim, axi, roe = BASES[base]
    if fluid == "dry_air":
        ops = (AXI_OPS["dry_air_axi" + ("_euler" if eq == "euler" else "")]
               if axi else FACE_OPS[eq] * (dim + 2) // 5)
    else:
        ops = AXI_OPS["argon_axi"] if axi else MIX_OPS[f"argon_{dim}d"]
    if roe:
        ops += 75
    if eq == "euler" or closure == "none":
        return ops
    strain = (16 if dim == 2 else 36) + (15 if axi else 0)
    side = {"smagorinsky": strain + 8 + 6, "sigma": 90 + 6, "sponge": 3,
            "mixing": strain + 8,
            "all": strain + 8 + (strain + 8 if dim == 2 else 90) + 6 + 3}
    return ops + 2 * side[closure]


# the variants on small boxes (4x4 p=2, 3^3 in 3-D): every closure alone
# and all together on each base, and Roe with and without them
CLOSURE_BASES = ("dry_air_2d", "dry_air_3d", "dry_air_axi", "argon_2d",
                 "argon_3d", "argon_axi")
CLOSURE_SMALL = tuple(
    (b, c, "navier-stokes") for b in CLOSURE_BASES
    for c in ("smagorinsky", "sigma", "sponge", "mixing", "all")) + tuple(
    (b, c, eq) for b in ("dry_air_roe_2d", "dry_air_roe_3d")
    for c, eq in (("none", "navier-stokes"), ("none", "euler"),
                  ("all", "navier-stokes")))
# (record, base, closure, equations, elements a side): at the decks'
# width, each timed: 64x64 (the ML deck's), 32x16x16 (the LES deck's),
# the 3-D argon at 16^3 (phase 34's)
CLOSURE_WIDE = (
    ("dry_air_2d_closure", "dry_air_2d", "all", "navier-stokes", 64),
    ("dry_air_3d_closure", "dry_air_3d", "all", "navier-stokes",
     (32, 16, 16)),
    ("dry_air_axi_closure", "dry_air_axi", "all", "navier-stokes", 64),
    ("argon_2d_closure", "argon_2d", "all", "navier-stokes", 64),
    ("argon_3d_closure", "argon_3d", "all", "navier-stokes", 16),
    ("argon_axi_closure", "argon_axi", "all", "navier-stokes", 64),
    ("dry_air_roe_2d", "dry_air_roe_2d", "none", "navier-stokes", 64),
    ("dry_air_roe_2d_euler", "dry_air_roe_2d", "none", "euler", 64),
    ("dry_air_roe_2d_closure", "dry_air_roe_2d", "all", "navier-stokes", 64),
    ("dry_air_roe_3d", "dry_air_roe_3d", "none", "navier-stokes",
     (32, 16, 16)),
    ("dry_air_roe_3d_euler", "dry_air_roe_3d", "none", "euler",
     (32, 16, 16)),
    ("dry_air_roe_3d_closure", "dry_air_roe_3d", "all", "navier-stokes",
     (32, 16, 16)))


def closure_check(base, closure, eq, n, dev, timed=False):
    """One case of tps_torch/tools/closure_cases.py: the kernel against its
    plain version, f64 within TOL and f32 by TOL's rule, its variant
    counted once; the closure (or Roe) moves the plain result.  timed:
    the record (CUDA events kernel, plain, kernel; the device ms; f64;
    the bound)."""
    from tps_torch.dg.cuda_faces import build_face_sweep
    from tps_torch.tools.closure_cases import BASES, closure_case

    ctx, tab_np, Up = closure_case(base, closure, n, eq=eq)
    U = ctx.mixture.conservatives(torch.as_tensor(Up, device=dev))
    tab64 = tab_np.to_torch(torch.float64, dev)
    tab32 = tab_np.to_torch(torch.float32, dev)
    sw64, sw32 = build_face_sweep(tab64, ctx), build_face_sweep(tab32, ctx)
    X64 = face_input(ctx, tab64, U)
    X32 = X64.float()
    var = sw64.variant
    reset_all_launches()
    y64 = sw64(X64)
    k32 = sw32(X32)
    torch.cuda.synchronize()
    counted = launches_by_variant()[f"face_sweep/{var}"]
    p64, p32 = sw64.plain(X64), sw32.plain(X32)
    ref = sw64.plain(X32.double())
    r64, r32 = rel(y64, p64), rel(k32, p32)
    dk, dp = rel(k32.double(), ref), rel(p32.double(), ref)
    want = base if closure == "none" or eq == "euler" else f"{base}_closure"
    ok = (r64 <= TOL[torch.float64] and var == want and counted == 2
          and (r32 <= TOL[torch.float32] or dk <= 2 * dp))
    grid = "x".join(map(str, (n,) * tab_np.dim if isinstance(n, int) else n))
    name = f"{var} {closure} {eq} {grid} p=2 gl"
    rec = {"grid": name, "variant": var, "f64_rel_err": r64, "f32_rel": r32,
           "f32_f64_dist": dk, "plain_f32_f64_dist": dp, "ok": ok,
           "max_abs_err": float(torch.max(torch.abs(k32 - p32)))}
    if timed:
        ms = [cuda_ms(lambda: sw32(X32), 30), cuda_ms(lambda: sw32.plain(X32), 2),
              cuda_ms(lambda: sw32(X32), 30)]
        fluid, _dim, axi, _roe = BASES[base]
        b = face_bound(tab_np, eq, "gl", neq=sw64.neq,
                       flux_ops=closure_flux_ops(base, closure, eq), axi=axi,
                       slot_arrays=(0 if want == base
                                    else int(sw64.wgt is not None)
                                    + int(sw64.dist is not None)),
                       delta=sw64.delta is not None)
        rec.update({
            "neq": sw64.neq, "k": sw64.k, "nodes": tab_np.ne * tab_np.ndof,
            "ms": (ms[0] + ms[2]) / 2, "plain_ms": ms[1],
            "device_ms": kernel_ms(lambda: sw32(X32), "face_sweep", 20),
            "f64_ms": cuda_ms(lambda: sw64(X64), 20),
            "f64_device_ms": kernel_ms(lambda: sw64(X64), "face_sweep", 20),
            "bound_ms": b[0], "bound_by": b[1], "ops_ms": b[2],
            "bytes_ms": b[3], "turns": ms})
    log(f"  {name} (NEQ {sw64.neq}, {tab_np.ne} elements): f64 {r64:.3e} "
        f"(bar {TOL[torch.float64]}); f32 {r32:.3e} (or f64 dist: kernel "
        f"{dk:.3e} <= 2 x plain {dp:.3e}); launches under {var}: {counted}"
        + (f"; ms {rec['ms']:.4f}, device {ms_text(rec['device_ms'])}, f64 "
           f"{rec['f64_ms']:.4f}, plain {rec['plain_ms']:.2f}, bound "
           f"{rec['bound_ms']:.6f} ({rec['bound_by']})" if timed else "")
        + ("" if ok else "  FAIL"))
    del tab64, tab32, sw64, sw32, X64, X32, y64, p64, k32, p32, ref
    return rec


def closure_path_decks():
    """{variant: (deck path, stages a step)}: the path of each closure and
    Roe variant that phases 45-46's decks do not take, through the CLI:
    the LES deck at 8x4x4 (Sigma on Rusanov; Roe alone; Roe on Euler,
    its walls inviscid), the pipe deck planar (Smagorinsky and the sponge,
    on Rusanov and Roe; Roe alone and on Euler) and axisymmetric
    (Smagorinsky and the sponge), the argon deck with Smagorinsky, the
    3-D argon box at 4^3 with Smagorinsky.  Output in build/<variant>."""
    sponge = ("[viscosityMultiplierFunction]\nisEnabled = 1\n"
              "point = '0.0 0.7 0.0'\nnormal = '0.0 1.0 0.0'\nwidth = 0.05\n"
              "viscosityRatio = 10.0\n")
    with open(LES_DECK) as f:
        les = (f.read().replace("nx = 32", "nx = 8").replace("ny = 16", "ny = 4")
               .replace("nz = 16", "nz = 4"))
    with open(PIPE_DECK) as f:
        pipe = f.read()
    planar = pipe.replace("axisymmetric = 1\n", "")
    euler = [("equation_system = navier-stokes", "equation_system = euler"),
             ("type = viscous_isothermal\ntemperature = 300.0\n",
              "type = inviscid\n"),
             ("type = viscous_isothermal\ntemperature = 300\n",
              "type = inviscid\n")]

    def edit(text, pairs):
        for old, new in pairs:
            text = text.replace(old, new)
        return text

    smag = [("[flow]\n", "[flow]\nsgsModel = smagorinsky\n"), ("[io]", sponge + "[io]")]
    roe = [("[flow]\n", "[flow]\nuseRoe = 1\n")]
    texts = {
        "dry_air_3d_closure": (edit(les, [("useRoe = 1", "useRoe = 0")]), 4),
        "dry_air_roe_3d": (edit(les, [("sgsModel = sigma", "sgsModel = none")]),
                           4),
        "dry_air_roe_3d_euler": (edit(les, [("sgsModel = sigma",
                                             "sgsModel = none")] + euler), 4),
        "dry_air_2d_closure": (edit(planar, smag), 3),
        "dry_air_roe_2d_closure": (edit(planar, smag + roe), 3),
        "dry_air_roe_2d": (edit(planar, roe), 3),
        "dry_air_roe_2d_euler": (edit(planar, roe + euler), 3),
        "dry_air_axi_closure": (edit(pipe, smag), 3)}
    with open(ARGON_DECK) as f:
        argon = f.read().replace("[flow]\n", "[flow]\nsgsModel = smagorinsky\n",
                                 1)
    texts["argon_2d_closure"] = (argon, 4)
    with open(variant_deck("argon_3d")) as f:
        argon3 = (f.read().replace("nx = 16", "nx = 4").replace("ny = 16", "ny = 4")
                  .replace("nz = 16", "nz = 4")
                  .replace("[flow]\n", "[flow]\nsgsModel = smagorinsky\n", 1))
    texts["argon_3d_closure"] = (argon3, 4)
    out = {}
    for var, (text, stages) in texts.items():
        for name in ("output/les_channel3d", "output/axisym_pipe",
                     "/tmp/tps_tpu_argon_output",
                     os.path.join(REPO, "build", "argon_3d")):
            text = text.replace(f"outdirBase = {name}",
                                f"outdirBase = build/{var}")
        path = os.path.join(REPO, "build", var + ".ini")
        with open(path, "w") as f:
            f.write(text)
        out[var] = (path, stages)
    return out


def phase_closure_faces(dev):
    """Phase 44: the face sweep's closure and Roe variants against their
    plain versions (`closure_check`): every case of CLOSURE_SMALL, then
    CLOSURE_WIDE timed; then each variant's path that phases 45-46's
    decks do not take through the CLI (`closure_path_decks`, f32, 2 steps):
    its variant once a stage and no other.  Returns ({record: record},
    {variant: launches}, the largest f64 error)."""
    from tps_torch.dg.cuda_faces import VARIANTS

    failures, worst = [], 0.0
    for base, closure, eq in CLOSURE_SMALL:
        rec = closure_check(base, closure, eq, 3 if "3d" in base else 4, dev)
        worst = max(worst, rec["f64_rel_err"])
        if not rec["ok"]:
            failures.append(rec["grid"])
    out = {}
    for key, base, closure, eq, n in CLOSURE_WIDE:
        rec = closure_check(base, closure, eq, n, dev, timed=True)
        worst = max(worst, rec["f64_rel_err"])
        if not rec["ok"]:
            failures.append(rec["grid"])
        out[key] = rec
        torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"face sweep parity on the closure and Roe variants "
                         f"failed: {failures}")
    launched = {}
    for key, (path, stages) in closure_path_decks().items():
        var = key.replace("_euler", "")
        assert var in VARIANTS, var
        tps = channel_tps(torch.float32, key, iters=2, path=path)
        reset_all_launches()
        tps.solve()
        torch.cuda.synchronize()
        counts = launches_by_variant()
        want = {"face_sweep": 2 * stages, f"face_sweep/{var}": 2 * stages}
        bad = {k: v for k, v in counts.items() if v != want.get(k, 0)}
        finite = bool(torch.isfinite(tps.solver.U).all())
        log(f"  {key}'s path ({os.path.basename(path)}), f32, 2 steps: "
            f"launches {counts}; finite {finite}")
        if bad or not finite or tps.get_status() != 0:
            raise SystemExit(f"{key}'s path failed its checks (launches off: "
                             f"{bad})")
        launched[key] = counts[f"face_sweep/{var}"]
        del tps
    return out, launched, worst


def les_perturbed(s, seed=6):
    """The LES deck's state with seeded 3-D velocity perturbations of 3 m/s
    (numpy, in f64), so that the Sigma model acts from the first step."""
    U0 = s.state_global().astype(np.float64)
    xyz = s.tables_np.xyz_dof
    rng = np.random.default_rng(seed)
    for q in (1, 2, 3):
        k = rng.uniform(0.5, 1.5, 3)
        U0[..., q] += 3.0 * U0[..., 0] * np.prod(np.sin(k * xyz), axis=-1)
    return U0


@contextlib.contextmanager
def shared_tables():
    """Solvers made inside share one build of each mesh's numpy tables
    (~6 s of host time each at 221,184 nodes), each a shallow copy."""
    from tps_torch.solvers import compressible

    built, build_tables = {}, compressible.build_tables

    def once(mesh, **kw):
        key = (mesh.vertices.tobytes(), tuple(sorted(kw.items())))
        if key not in built:
            built[key] = build_tables(mesh, **kw)
        return copy.copy(built[key])

    compressible.build_tables = once
    try:
        yield
    finally:
        compressible.build_tables = build_tables


def phase_les(dev):
    """Phase 46: tps_torch/tools/les_channel3d.ini (Roe and Sigma on a 3-D
    channel of air, 32x16x16 p=2 GL, 221,184 nodes) through the CLI, 20
    steps in f32 and in f64, from les_perturbed's state, with the launch
    counts set to 0 before each: the dry_air_roe_3d_closure sweep 4 times
    a step, no other variant; finite; the step graph.  The f64 run at its
    step 12 against 12 eager steps within GRAPH_TOL; the deck cut to
    16x8x8 (27,648 nodes; the CPU takes ~10 s a step at full size), 3 f64
    steps on the card against the port's CPU run within CHANNEL_CPU_TOL
    (U).  Then ms/step through solve() (phase 11's turns, f32)."""
    with shared_tables():
        return _les_runs(dev, "dry_air_roe_3d_closure", {}, {})


def _les_runs(dev, var, out, runs):
    """phase_les' runs and checks (its docstring)."""
    shipped = None
    with open(LES_DECK) as f:
        text = (f.read().replace("nx = 32", "nx = 16")
                .replace("ny = 16", "ny = 8").replace("nz = 16", "nz = 8"))
    cut = os.path.join(REPO, "build", "les_cut.ini")
    with open(cut, "w") as f:
        f.write(text)
    for name, dtype, device, graphs, iters, path in (
            ("f32", torch.float32, "cuda", True, 20, LES_DECK),
            ("f64", torch.float64, "cuda", True, 20, LES_DECK),
            ("eager", torch.float64, "cuda", False, 12, LES_DECK),
            ("card3", torch.float64, "cuda", True, 3, cut),
            ("cpu3", torch.float64, "cpu", True, 3, cut)):
        tps = channel_tps(dtype, f"les_{name}", device=device, iters=iters,
                          path=path)
        s = tps.solver
        s.cuda_graphs = graphs
        s.set_state_global(les_perturbed(s))
        reset_all_launches()
        t0 = time.perf_counter()
        if name == "f64":
            s.config.max_iters = 12
            tps.solve()
            runs["card12"] = s.U.double().cpu().clone()
            s.config.max_iters = iters
        tps.solve()
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches_by_variant()
        want = ({"face_sweep": 4 * s.iter, f"face_sweep/{var}": 4 * s.iter}
                if device == "cuda" else {})
        bad = {k: v for k, v in counts.items() if v != want.get(k, 0)}
        runs[name] = s.U.double().cpu().clone()
        finite = bool(torch.isfinite(runs[name]).all())
        log(f"  {name}: {s.iter} steps in {wall:.1f} s; launches {counts}; "
            f"finite {finite}; max|u| "
            f"{float((runs[name][..., 1:4] / runs[name][..., :1]).abs().max()):.4f}"
            f" m/s; step graph {s._loop.graph is not None}")
        if (bad or not finite or tps.get_status() != 0 or s.iter != iters
                or (graphs and device == "cuda" and s._loop.graph is None)):
            raise SystemExit(f"the LES channel's {name} run failed its checks "
                             f"(launches off: {bad})")
        if name in ("f32", "f64"):
            out[name] = {"steps": s.iter, "wall_s": wall, "launches": counts}
        if name == "f32":
            shipped = s
        else:
            del tps, s
    graph_d = state_rel(runs["card12"], runs["eager"], nvel=3)
    cpu_d = state_rel(runs["card3"], runs["cpu3"], nvel=3)
    ok = graph_d <= GRAPH_TOL and cpu_d <= CHANNEL_CPU_TOL
    log(f"  f64: graph vs eager, 12 steps {graph_d:.3e} (bar {GRAPH_TOL}); "
        f"card vs the port's CPU run, 16x8x8, 3 steps {cpu_d:.3e} (bar "
        f"{CHANNEL_CPU_TOL})" + ("" if ok else "  FAIL"))
    if not ok:
        raise SystemExit("the LES channel: card, CPU and eager differ")
    out.update({"f64 graph vs eager": graph_d, "f64 card vs cpu": cpu_d})
    out["solve() ms/step"] = phase_step_timing({"les_channel3d f32": shipped},
                                               steps=4)
    return out


# ---------------------------------------------------------------- forcings

# the MMS decks at full width through tps_torch/tools/compute_rhs.py (f64),
# each against the reference's brackets (tests/test_masa_parity.py:75-84,
# 97-111: the euler deck's three, the cns deck's three and its goldens)
MMS_BRACKETS = {
    "euler_2d quad 160x160": ("mms.euler.2d.quad.ini", 25600,
                              ((5.74e-5, 5.75e-5), (5.745e-5, 5.755e-5),
                               (5.745e-5, 5.755e-5)), None),
    "cns_2d quad 80x80": ("mms.cns.2d.quad.ini", 6400,
                          ((2.25e-4, 2.35e-4), (2.32e-4, 2.33e-4),
                           (2.355e-4, 2.365e-4)),
                          (2.30524e-4, 2.32575e-4, 2.36350e-4))}
MMS_GOLDEN_TOL = 2e-7
# the 3-D transient MASA decks of tests/test_masa_3d.py (the reference's
# periodic cube [0, 2]^3, p=1 GL): the rates between 6^3 and 12^3 at the
# same physical time 6e-3 s, each in 1.9-2.8 and the pressure's in the
# reference's 2.10-2.25 (tests/test_masa_3d.py:138-142); the consistency
# bounds of its :145-168
MASA3D_DECK = """
[solver]
type = flow
[flow]
order = 1
basisType = 0
integrationRule = 0
maxIters = {iters}
outputFreq = 100000
timingFreq = 100000
useRoe = 0
equation_system = {eqsys}
fluid = dry_air
[mesh]
generator = box3d
nx = {n}
ny = {n}
nz = {n}
x1 = 2.0
y1 = 2.0
z1 = 2.0
periodic_x = 1
periodic_y = 1
periodic_z = 1
[time]
integrator = rk4
dt_fixed = {dt}
enableConstantTimestep = True
[boundaryConditions]
numWalls = 0
numInlets = 0
numOutlets = 0
[mms]
isEnabled = True
compare_rhs = False
name = {name}
[io]
outdirBase = {out}
"""
MASA3D_RATES = (1.9, 2.8)
MASA3D_PRESSURE_RATE = (2.10, 2.25)
MASA3D_CONSISTENT = (0.05, 5.0, 500.0)  # rho, velocity, pressure L2 errors
FORCED_DECK = os.path.join(REPO, "tps_torch", "tools", "forced_channel3d.ini")
# the JAX package's 200 f64 steps of the forced channel on the CPU
# (tests/test_torch_deck_growth.py --deck forced_channel --steps 200
# --jax-only): max|u| and the peak T at step 200
FORCED_JAX_200 = (34.69989, 316.9746)
# relative: the printed digits hold them to ~1.6e-7; f64 rounding over 200
# steps on two devices is far below that
FORCED_JAX_TOL = 1e-6
ANNULUS_ZONES = """[spongezone]
numSpongeZones = 2

[spongezone1]
isEnabled = True
type = annulus
targetSolType = userDef
density = 1.2
uvw = '0.0 5.0 -30.0'
pressure = 103341.0
normal = '-1 0 0'
p0 = '6.283185307179586 1.0 1.5707963267948966'
pInit = '5.5 1.0 1.5707963267948966'
r1 = 0.2
r2 = 0.9
multiplier = 0.5

[spongezone2]
isEnabled = True
type = annulus
targetSolType = mixedOut
tolerance = 0.3
normal = '-1 0 0'
p0 = '6.283185307179586 1.0 1.5707963267948966'
pInit = '5.5 1.0 1.5707963267948966'
r1 = 0.5
r2 = 0.9
multiplier = 0.5

[io]
"""
ARGON_SPONGE = """
[spongezone]
numSpongeZones = 1
[spongezone1]
type = planar
targetSolType = userDef
density = 1.6
uvw = '10.0 0.0 0.0'
pressure = 101300.0
mass_fraction/species1 = 1.0e-8
mass_fraction/species2 = 0.9999999
mass_fraction/species3 = 1.0e-7
electron_temperature = 400.0
normal = '-1 0 0'
p0 = '0.01 0.0 0.0'
pInit = '0.0075 0.0 0.0'
multiplier = 0.5
"""


def deck_file(name, text):
    path = os.path.join(REPO, "build", name)
    with open(path, "w") as f:
        f.write(text)
    return path


def forced_text(kind, n=(8, 4, 4), iters=4):
    """forced_channel3d.ini at n elements with one forcing alone (kind
    "pressure", "heat", "sponge userDef", "sponge mixedOut", "annulus": an
    annulus with a userDef (a swirl) and one with a mixedOut target about
    the channel's centre line along x, over the fringe's x range) or all
    of them ("all")."""
    with open(FORCED_DECK) as f:
        text = f.read()
    for old, new in (("nx = 32", f"nx = {n[0]}"), ("ny = 16", f"ny = {n[1]}"),
                     ("nz = 16", f"nz = {n[2]}"),
                     ("maxIters = 200", f"maxIters = {iters}"),
                     ("outdirBase = output/forced_channel3d",
                      f"outdirBase = build/forced_{kind.replace(' ', '_')}")):
        text = text.replace(old, new)
    if kind not in ("all", "pressure"):
        text = text.replace("enablePressureForcing = True",
                            "enablePressureForcing = False")
    if kind not in ("all", "heat"):
        text = text.replace("numHeatSources = 1", "numHeatSources = 0")
    if kind in ("pressure", "heat"):
        text = text.replace("numSpongeZones = 1", "numSpongeZones = 0")
    if kind == "sponge mixedOut":
        text = text.replace("targetSolType = userDef",
                            "targetSolType = mixedOut\ntolerance = 0.3")
    if kind == "annulus":
        text = text[:text.index("\n[spongezone]\n") + 1] + ANNULUS_ZONES + \
            text[text.index("\n[io]\n") + 5:]
    return text


def forcing_cases():
    """(name, deck path, face-sweep variant) of phase 49."""
    cases = [(f"channel 8x4x4 {k}",
              deck_file(f"forced_{k.replace(' ', '_')}.ini", forced_text(k)),
              "dry_air")
             for k in ("pressure", "heat", "sponge userDef", "sponge mixedOut",
                       "annulus", "all")]
    with open(os.path.join(REPO, "tests", "inputs",
                           "mms.euler.2d.quad.ini")) as f:
        mms = (f.read().replace("nx = 160", "nx = 16")
               .replace("ny = 160", "ny = 16")
               .replace("maxIters = 300", "maxIters = 4")
               .replace("outdirBase = output", "outdirBase = build/mms16"))
    cases.append(("mms euler_2d 16x16", deck_file("mms16.ini", mms),
                  "dry_air"))
    cases.append(("mms euler_transient_3d 3^3", deck_file(
        "masa3d_3.ini", MASA3D_DECK.format(
            n=3, iters=4, dt=2e-5, out="build/masa3d_3",
            name="euler_transient_3d", eqsys="euler")), "dry_air"))
    with open(os.path.join(REPO, "tests", "inputs", "argon_minimal.ini")) as f:
        argon = f.read().replace("outdirBase = /tmp/tps_tpu_argon_output",
                                 "outdirBase = build/argon_sponge")
    cases.append(("argon_minimal + 2-T sponge", deck_file(
        "argon_sponge.ini", argon + ARGON_SPONGE), "argon_2d"))
    return cases


def phase_mms_brackets(dev):
    """Phase 47: the MMS decks at full width on the card in f64 through
    tps_torch/tools/compute_rhs.py (the solver's exact state, its slot RHS
    with the face sweep and the MASA source made at set-up): the relative
    RHS errors per group in the reference's brackets, the cns deck's
    within MMS_GOLDEN_TOL of the goldens; one face-sweep launch each."""
    from tps_torch.tools import compute_rhs as tool

    torch.set_default_dtype(torch.float64)
    out = {}
    for key, (ini, ne_want, brackets, golden) in MMS_BRACKETS.items():
        with open(os.path.join(REPO, "tests", "inputs", ini)) as f:
            text = f.read().replace("outdirBase = output",
                                    "outdirBase = build/mms_out")
        report = os.path.join(REPO, "build", ini + ".rhs_error.txt")
        text = "\n".join(f"filename = {report}" if ln.startswith("filename =")
                         else ln for ln in text.splitlines())
        path = deck_file("full_" + ini, text)
        reset_all_launches()
        t0 = time.perf_counter()
        errs, ne = tool.run_file_mode(path, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches_by_variant()
        with open(report) as f:
            line = f.read().strip().splitlines()[-1]
        ok = (ne == ne_want and len(errs) == 3
              and all(lo < e < hi for e, (lo, hi) in zip(errs, brackets))
              and (golden is None or all(abs(e - g) < MMS_GOLDEN_TOL
                                         for e, g in zip(errs, golden)))
              and counts["face_sweep"] == 1
              and counts["face_sweep/dry_air"] == 1)
        log(f"  {key}: {ne} elements, errors {[f'{e:.6e}' for e in errs]} "
            f"(brackets {brackets}" + (f", goldens {golden}" if golden else "")
            + f"); report line '{line}'; launches {counts}; {wall:.1f} s "
            "with set-up" + ("" if ok else "  FAIL"))
        if not ok:
            raise SystemExit(f"{key}: the MMS errors miss the reference's "
                             "brackets")
        out[key] = {"errors": errs, "elements": ne, "wall_s": wall,
                    "launches": counts["face_sweep"]}
    return out


def masa3d_run(n, iters, dt, name, eqsys, graphs=True):
    """One 3-D transient MASA deck through the harness on the card in f64:
    (solver, primitive errors, wall s of solve(), launches)."""
    from tps_torch.utils.mms import primitive_errors

    path = deck_file(f"masa3d_{name}_{n}.ini", MASA3D_DECK.format(
        n=n, iters=iters, dt=dt, out=f"build/masa3d_{n}", name=name,
        eqsys=eqsys))
    tps = channel_tps(torch.float64, f"masa3d_{name}_{n}", path=path)
    s = tps.solver
    s.cuda_graphs = graphs
    s.write_restart = lambda: None
    reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tps.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    errs = primitive_errors(s.tables, s.mixture, s.U, s.masa.up_fn, s.time)
    return s, errs, wall, launches_by_variant()


def phase_masa_rates(dev):
    """Phase 48: the 3-D transient MASA decks on the card in f64 (step
    graph): euler_transient_3d at 6^3 (300 x 2e-5 s) and 12^3 (600 x 1e-5
    s), the L2 errors of density, velocity and pressure at t = 6e-3 s and
    their rates in MASA3D_RATES, the pressure's in MASA3D_PRESSURE_RATE;
    navierstokes_3d_transient_sutherland at 6^3 (150 steps) within
    MASA3D_CONSISTENT; each 4 face-sweep launches a step."""
    out, errs = {}, {}
    for key, (n, iters, dt, name, eqsys) in {
            "euler 6^3": (6, 300, 2e-5, "euler_transient_3d", "euler"),
            "euler 12^3": (12, 600, 1e-5, "euler_transient_3d", "euler"),
            "ns 6^3": (6, 150, 2e-5, "navierstokes_3d_transient_sutherland",
                       "navier-stokes")}.items():
        s, e, wall, counts = masa3d_run(n, iters, dt, name, eqsys)
        ok = (counts["face_sweep"] == 4 * iters == counts["face_sweep/dry_air"]
              and s._loop.graph is not None
              and abs(float(s.time) - iters * dt) < 1e-12)
        if key == "ns 6^3":
            ok = ok and all(v < b for v, b in zip(e, MASA3D_CONSISTENT))
        errs[key] = e
        out[key] = {"errors": e, "steps": iters, "wall_s": wall,
                    "ms_per_step": wall * 1e3 / iters,
                    "launches": counts["face_sweep"],
                    "solution_error": s.mms_solution_error()}
        log(f"  {key}: {iters} steps in {wall:.2f} s; L2 errors rho, u, p "
            f"{e}; launches {counts['face_sweep']}" + ("" if ok else "  FAIL"))
        if not ok:
            raise SystemExit(f"the 3-D MASA deck {key} failed its checks")
        del s
    rates = [float(np.log2(a / b)) for a, b in zip(errs["euler 6^3"],
                                                     errs["euler 12^3"])]
    ok = (all(MASA3D_RATES[0] < r < MASA3D_RATES[1] for r in rates)
          and MASA3D_PRESSURE_RATE[0] < rates[2] < MASA3D_PRESSURE_RATE[1])
    log(f"  rates rho, u, p: {rates} (each in {MASA3D_RATES}, p in "
        f"{MASA3D_PRESSURE_RATE})" + ("" if ok else "  FAIL"))
    if not ok:
        raise SystemExit("the 3-D MASA rates miss the reference's brackets")
    out["rates"] = rates
    return out


def forcing_case_run(i, device, graphs=True):
    """Phase 49's case i (forcing_cases' order), its 4 f64 steps on device
    (the step graph or eager steps on the card): U on the CPU, and the
    forcings' kinds, the steps, the kernel launches and whether a step
    graph ran."""
    name, path, var = forcing_cases()[i]
    tps = channel_tps(torch.float64, f"forcings_{device}", device=device,
                      path=path)
    s = tps.solver
    s.cuda_graphs = graphs
    s.write_restart = lambda: None
    reset_all_launches()
    tps.solve()
    if device == "cuda":
        torch.cuda.synchronize()
    return s.U.double().cpu().clone(), {
        "kinds": [type(f).__name__ for f in s.ctx.forcings],
        "steps": s.iter, "graph": s._loop.graph is not None,
        "launches": {k: v for k, v in launches_by_variant().items() if v}}


def phase_forcings(dev, refs):
    """Phase 49: each forcing alone and all together on the forced channel
    cut to 8x4x4 p=2 (3,456 nodes), the MMS sources (euler_2d at 16x16 p=2
    GLL, euler_transient_3d at 3^3) and the argon deck with a
    two-temperature sponge: 4 RK4 steps through solve() in f64 on the card
    with the step graph, eagerly, and on the CPU (in refs' worker); graph
    vs eager within GRAPH_TOL, card vs CPU within CHANNEL_CPU_TOL (U), the case's
    face-sweep variant 4 times a step and no other kernel."""
    out = {}
    for i, (name, path, var) in enumerate(forcing_cases()):
        runs = {}
        for run, graphs in (("graph", True), ("eager", False)):
            runs[run], info = forcing_case_run(i, "cuda", graphs)
            counts = info["launches"]
            want = {"face_sweep": 4 * info["steps"],
                    f"face_sweep/{var}": 4 * info["steps"]}
            if counts != want or (graphs and not info["graph"]):
                raise SystemExit(f"{name}: launches {counts}, not {want}")
        runs["cpu"], cpu = refs.get(f"forcing {i}")
        kinds = info["kinds"]
        if (cpu["kinds"] != kinds or cpu["launches"]
                or cpu["steps"] != info["steps"]):
            raise SystemExit(f"{name}: the CPU run {cpu}")
        nvel = 2 if "2d" in name or "argon" in name else 3
        graph_d = state_rel(runs["graph"], runs["eager"], nvel=nvel)
        cpu_d = state_rel(runs["graph"], runs["cpu"], nvel=nvel)
        ok = (graph_d <= GRAPH_TOL and cpu_d <= CHANNEL_CPU_TOL
              and bool(torch.isfinite(runs["graph"]).all()))
        log(f"  {name} ({kinds}): graph vs eager {graph_d:.3e}, card vs CPU "
            f"{cpu_d:.3e}; launches {counts}" + ("" if ok else "  FAIL"))
        if not ok:
            raise SystemExit(f"{name}: card, CPU and eager differ")
        out[name] = {"graph vs eager": graph_d, "card vs cpu": cpu_d,
                     "launches": counts[f"face_sweep/{var}"],
                     "forcings": kinds}
    return out


def forced_cut_run(device):
    """Phase 50's cut copy: forced_channel3d.ini at 16x8x8 with every
    forcing, 3 f64 steps on device (the step graph on the card): U on the
    CPU, and its steps, status and kernel launches."""
    cut = deck_file(f"forced_cut_{device}.ini",
                    forced_text("all", (16, 8, 8), 3))
    tps = channel_tps(torch.float64, f"forced_cut_{device}", device=device,
                      iters=3, path=cut)
    s = tps.solver
    reset_all_launches()
    tps.solve()
    if device == "cuda":
        if s._loop.graph is None:
            raise SystemExit("the forced channel's card3 run: no step graph")
        torch.cuda.synchronize()
    return s.U.double().cpu().clone(), {
        "steps": s.iter, "status": tps.get_status(),
        "launches": {k: v for k, v in launches_by_variant().items() if v}}


def phase_forced_channel(dev, refs):
    """Phase 50: tps_torch/tools/forced_channel3d.ini (32x16x16 p=2 GL,
    221,184 nodes: the pressure forcing, a heat source, a planar sponge)
    through the CLI, 200 steps in f32 and in f64 (the JAX package keeps it
    finite for 200 f64 steps on the CPU, FORCED_JAX_200), the dry_air
    sweep 4 times a step; the f64 run's max|u| and peak T at step 200
    within FORCED_JAX_TOL of the JAX package's; the f64 run at its step 12
    against 12 eager steps within GRAPH_TOL; cut to 16x8x8 (27,648 nodes),
    3 f64 steps on the card against the port's CPU run (in refs'
    worker) within CHANNEL_CPU_TOL; ms/step through solve() (phase 11's
    turns, f32)."""
    out, runs, shipped = {}, {}, None
    for name, dtype, graphs, iters in (
            ("f32", torch.float32, True, 200),
            ("f64", torch.float64, True, 200),
            ("eager", torch.float64, False, 12)):
        tps = channel_tps(dtype, f"forced_{name}", iters=iters,
                          path=FORCED_DECK)
        s = tps.solver
        s.cuda_graphs = graphs
        reset_all_launches()
        t0 = time.perf_counter()
        if name == "f64":
            s.config.max_iters = 12
            tps.solve()
            runs["card12"] = s.U.double().cpu().clone()
            s.config.max_iters = iters
        tps.solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in launches_by_variant().items() if v}
        want = {"face_sweep": 4 * s.iter, "face_sweep/dry_air": 4 * s.iter}
        U = s.U.double().cpu().clone()
        runs[name] = U
        finite = bool(torch.isfinite(U).all())
        Up = s.mixture.primitives(U)
        umax = float(Up[..., 1:4].abs().max())
        tmax = float(Up[..., 4].max())
        log(f"  {name}: {s.iter} steps in {wall:.1f} s; launches {counts}; "
            f"finite {finite}; max|u| {umax:.6e} m/s, peak T {tmax:.6e} K; "
            f"step graph {s._loop.graph is not None}")
        if (counts != want or not finite or tps.get_status() != 0
                or s.iter != iters or (graphs and s._loop.graph is None)):
            raise SystemExit(f"the forced channel's {name} run failed its "
                             f"checks (launches {counts})")
        if name in ("f32", "f64"):
            out[name] = {"steps": s.iter, "wall_s": wall,
                         "launches": counts["face_sweep/dry_air"],
                         "max_u": umax, "peak_T": tmax}
        if name == "f32":
            shipped = s
        else:
            del tps, s
    runs["card3"], card3 = forced_cut_run("cuda")
    runs["cpu3"], cpu3 = refs.get("forced cut")
    graph_d = state_rel(runs["card12"], runs["eager"], nvel=3)
    cpu_d = state_rel(runs["card3"], runs["cpu3"], nvel=3)
    jax_d = [abs(out["f64"][k] / ref - 1.0)
             for k, ref in zip(("max_u", "peak_T"), FORCED_JAX_200)]
    ok = (graph_d <= GRAPH_TOL and cpu_d <= CHANNEL_CPU_TOL
          and max(jax_d) <= FORCED_JAX_TOL and cpu3["launches"] == {}
          and card3["launches"] == {"face_sweep": 12, "face_sweep/dry_air": 12}
          and cpu3["status"] == card3["status"] == 0
          and cpu3["steps"] == card3["steps"] == 3)
    log(f"  f64: graph vs eager, 12 steps {graph_d:.3e} (bar {GRAPH_TOL}); "
        f"card vs the port's CPU run, 16x8x8, 3 steps {cpu_d:.3e} (bar "
        f"{CHANNEL_CPU_TOL}; the card's run {card3}, the CPU's {cpu3}); "
        f"step 200 f64 max|u| "
        f"{out['f64']['max_u']:.6e}, peak T {out['f64']['peak_T']:.6e} "
        f"against the JAX package's CPU run {FORCED_JAX_200}: "
        f"{jax_d[0]:.2e}, {jax_d[1]:.2e} (bar {FORCED_JAX_TOL})"
        + ("" if ok else "  FAIL"))
    if not ok:
        raise SystemExit("the forced channel: card, CPU and eager differ")
    out.update({"f64 graph vs eager": graph_d, "f64 card vs cpu": cpu_d})
    out["face_sweep"] = forced_sweep_timing(shipped)
    out["solve() ms/step"] = phase_step_timing(
        {"forced_channel3d f32": shipped}, steps=4)
    return out


def forced_sweep_timing(s):
    """The dry_air sweep of the forced channel's f32 solver on its state
    after 200 steps: kernel against its plain version (f32 by TOL's rule,
    the f64 plain version on f64 tables the reference), CUDA events
    (kernel, plain, kernel), the device ms, f64 and the bound."""
    from tps_torch.dg.cuda_faces import build_face_sweep

    sw32, tab_np = s._rhs.sweep, s.tables_np
    X32 = face_input(s.ctx, s.tables, s.U)
    tab64 = tab_np.to_torch(torch.float64, s.U.device)
    sw64 = build_face_sweep(tab64, s.ctx)
    X64 = face_input(s.ctx, tab64, s.U.double())
    k32, p32 = sw32(X32), sw32.plain(X32)
    y64, p64 = sw64(X64), sw64.plain(X64)
    ref = sw64.plain(X32.double())
    r64, r32 = rel(y64, p64), rel(k32, p32)
    dk, dp = rel(k32.double(), ref), rel(p32.double(), ref)
    ok = r64 <= TOL[torch.float64] and (r32 <= TOL[torch.float32]
                                        or dk <= 2 * dp)
    ms = [cuda_ms(lambda: sw32(X32), 30), cuda_ms(lambda: sw32.plain(X32), 2),
          cuda_ms(lambda: sw32(X32), 30)]
    b = face_bound(tab_np, "navier-stokes", "gl")
    rec = {"grid": "forced channel 32x16x16 p=2 gl", "variant": sw32.variant,
           "f64_rel_err": r64, "f32_rel": r32, "f32_f64_dist": dk,
           "plain_f32_f64_dist": dp,
           "max_abs_err": float(torch.max(torch.abs(k32 - p32))),
           "ms": (ms[0] + ms[2]) / 2, "plain_ms": ms[1], "turns": ms,
           "device_ms": kernel_ms(lambda: sw32(X32), "face_sweep", 20),
           "f64_ms": cuda_ms(lambda: sw64(X64), 20),
           "bound_ms": b[0], "bound_by": b[1], "ops_ms": b[2], "bytes_ms": b[3]}
    log(f"  the dry_air sweep at the deck's width: f64 {r64:.3e} (bar "
        f"{TOL[torch.float64]}); f32 {r32:.3e} (or f64 dist: kernel {dk:.3e} "
        f"<= 2 x plain {dp:.3e}); ms {rec['ms']:.4f}, device "
        f"{ms_text(rec['device_ms'])}, f64 {rec['f64_ms']:.4f}, plain "
        f"{rec['plain_ms']:.2f}, bound {rec['bound_ms']:.6f} "
        f"({rec['bound_by']})" + ("" if ok else "  FAIL"))
    if not ok:
        raise SystemExit("the forced channel's sweep differs from its plain "
                         "version")
    return rec


# ------------------------------------------------------- the LTE torch

# the LTE-table torch in (r, z) with swirl (phases 51-52)
LTE_AXI_DECK = os.path.join(REPO, "tps_torch", "tools",
                            "lte_torch_axisym.ini")
# (variant, table dim): each lte_axi variant at the width of its path: the
# deck's box at 64x64 (1-D tables), the 2-D tables on a 32x32 box as
# phase 38's lte_2d_t2 row
LTE_AXI_FACE_CASES = (("lte_axi", 1, 64), ("lte_axi_euler", 1, 64),
                      ("lte_axi_t2", 2, 32), ("lte_axi_t2_euler", 2, 32))


def lte_axi_ops(table_dim, euler):
    """The axisymmetric LTE face flux per point: the planar 2-D count
    (`lte_ops`) with a fifth equation (the Rusanov combination and the
    viscous mean over it) and, per side, the swirl's kinetic energy and
    its convective flux (2), and on Navier-Stokes u_r / r in div u, the
    swirl row and its work (13)."""
    return (lte_ops(2, table_dim, euler) + 5 + (0 if euler else 3)
            + 2 * (2 + (0 if euler else 13)))


def lte_axi_deck(name):
    """tps_torch/tools/lte_torch_axisym.ini with its tables named by
    absolute path (it names them from the repository root), output in
    build/<name>."""
    with open(LTE_AXI_DECK) as f:
        text = f.read()
    for rel in ("tps_torch/tools/lte_argon_thermo.h5",
                "tps_torch/tools/lte_argon_trans.h5",
                "examples/cases/nec_table.h5"):
        text = text.replace(rel, os.path.join(REPO, rel))
    text = text.replace("outdirBase = output/lte_torch_axisym",
                        f"outdirBase = {os.path.join(REPO, 'build', name)}")
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    path = os.path.join(REPO, "build", name + ".ini")
    old = None
    if os.path.exists(path):  # the CPU worker may be reading it
        with open(path) as f:
            old = f.read()
    if old != text:
        with open(path, "w") as f:
            f.write(text)
    return path


def lte_axi_case(table_dim, euler, n):
    """(RHS context, numpy tables, conserved state f64 on the CPU) of an
    lte_axi variant on the deck's (r, z) box at n x n p=2 GL: the deck's
    fluid with swirl (nvel = 3) on lte_argon_tables.py's tables (the 2-D
    ones written into build/), the hot state of `lte_U` with a rigid
    swirl u_t = 500 r (1 + 0.1 wave)."""
    from tps_torch.config.ini import IniInput
    from tps_torch.dg.discretization import build_tables
    from tps_torch.dg.fluxes import Fluxes
    from tps_torch.dg.rhs import RHSContext
    from tps_torch.dg.riemann import Rusanov
    from tps_torch.mesh.generators import box_2d
    from tps_torch.physics.lte import load_lte_setup
    from tps_torch.tools.lte_argon_tables import lte_keys

    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    mix, tr = load_lte_setup(IniInput.parse(lte_keys(table_dim, build)),
                             2, 3)
    fl = Fluxes(mixture=mix, transport=tr,
                eq_system="euler" if euler else "navier-stokes",
                axisymmetric=True)
    tab_np = build_tables(box_2d(n, n, x1=0.01, y1=0.01, periodic_y=True),
                          2, axisymmetric=True)
    xyz = tab_np.xyz_dof
    k = 2 * np.pi / 0.01
    wave = np.sin(k * xyz[..., 0]) * np.cos(k * xyz[..., 1])
    Up = np.zeros(xyz.shape[:-1] + (5,))
    Up[..., 0] = 0.05 * (1 + 0.1 * wave)
    Up[..., 1], Up[..., 2] = 3.0 * wave, 10.0 - 2.0 * wave
    Up[..., 3] = 500.0 * xyz[..., 0] * (1 + 0.1 * wave)
    Up[..., 4] = 9500.0 * (1 + 0.2 * wave)
    U = mix.conservatives(torch.as_tensor(Up, dtype=torch.float64))
    return RHSContext(fluxes=fl, riemann=Rusanov(fl)), tab_np, U


def phase_lte_axi_faces(dev):
    """Phase 51: the face sweep's lte_axi variants against their plain
    versions (the axisymmetric Fluxes through face_sweep_plain), f64
    within LTE_F64_TOL and f32 by TOL's rule, each at the width of its
    path, one launch each counted under its variant; timed in f32
    (kernel, plain, kernel: CUDA events), on the device (profiler) and in
    f64, with its bound.  Returns {variant: record} and the largest f64
    error."""
    from tps_torch.dg.cuda_faces import build_face_sweep

    failures, out, worst = [], {}, 0.0
    for var, td, n in LTE_AXI_FACE_CASES:
        t0 = time.perf_counter()
        euler = var.endswith("euler")
        ctx, tab_np, U = lte_axi_case(td, euler, n)
        tab64 = tab_np.to_torch(torch.float64, dev)
        tab32 = tab_np.to_torch(torch.float32, dev)
        sw64, sw32 = build_face_sweep(tab64, ctx), build_face_sweep(tab32, ctx)
        X64 = face_input(ctx, tab64, U.to(dev))
        X32 = X64.float()
        reset_all_launches()
        y64 = sw64(X64)
        k32 = sw32(X32)
        torch.cuda.synchronize()
        counted = launches_by_variant().get(f"face_sweep/{var}", 0)
        p64, p32 = sw64.plain(X64), sw32.plain(X32)
        ref = sw64.plain(X32.double())
        r64, r32 = rel(y64, p64), rel(k32, p32)
        dk, dp = rel(k32.double(), ref), rel(p32.double(), ref)
        swirl = float(p64[..., 3].abs().max()) > 0.0
        name = f"{var} {n}x{n} p=2 gl"
        ok = (r64 <= LTE_F64_TOL and sw64.variant == var and counted == 2
              and swirl and (r32 <= TOL[torch.float32] or dk <= 2 * dp))
        log(f"  {name} (NEQ {sw64.neq}, k {sw64.k}, {tab_np.ne} elements, "
            f"set-up {time.perf_counter() - t0:.1f} s): f64 {r64:.3e} (bar "
            f"{LTE_F64_TOL}); f32 {r32:.3e} (bar {TOL[torch.float32]}, or "
            f"f64 dist: kernel {dk:.3e} <= 2 x plain {dp:.3e}); launches "
            f"under {var}: {counted}" + ("" if ok else "  FAIL"))
        worst = max(worst, r64)
        if not ok:
            failures.append(name)
        ms = [cuda_ms(lambda: sw32(X32), 30), cuda_ms(lambda: sw32.plain(X32), 1),
              cuda_ms(lambda: sw32(X32), 30)]
        ops = lte_axi_ops(td, euler)
        b = face_bound(tab_np, ctx.fluxes.eq_system, "gl", neq=sw64.neq,
                       flux_ops=ops, axi=True)
        out[var] = {
            "grid": name, "neq": sw64.neq, "k": sw64.k,
            "nodes": tab_np.ne * tab_np.ndof,
            "ms": (ms[0] + ms[2]) / 2, "plain_ms": ms[1],
            "device_ms": kernel_ms(lambda: sw32(X32), "face_sweep", 10),
            "f64_ms": cuda_ms(lambda: sw64(X64), 20),
            "f64_device_ms": kernel_ms(lambda: sw64(X64), "face_sweep", 10),
            "bound_ms": b[0], "bound_by": b[1], "ops_ms": b[2],
            "bytes_ms": b[3], "ops_per_point": ops, "f64_rel_err": r64,
            "max_abs_err": float(torch.max(torch.abs(k32 - p32))),
            "f32_rel": r32, "f32_f64_dist": dk, "plain_f32_f64_dist": dp,
            "turns": ms}
        log(f"  timing {name} f32: {out[var]}")
        del tab64, tab32, sw64, sw32, X64, X32, y64, p64, k32, p32, ref
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    if failures:
        raise SystemExit(f"face sweep parity on the lte_axi variants "
                         f"failed: {failures}")
    # the 2-D-table variants' path: the deck on the 2-D tables at their
    # width through the CLI, f32, 2 steps (the 1-D-table ones are phase
    # 52's)
    from tps_torch.tools.lte_argon_tables import lte_keys

    for var, td, n in LTE_AXI_FACE_CASES:
        if td != 2:
            continue
        with open(lte_axi_deck("lte_axi")) as f:
            text = f.read()
        start, end = text.index("[flow/lte]"), text.index("[plasma_models]")
        text = (text[:start] + lte_keys(2, os.path.join(REPO, "build"))
                + "\n" + text[end:])
        text = text.replace("nx = 64\nny = 64", f"nx = {n}\nny = {n}")
        if var.endswith("euler"):
            text = euler_text(text)
        path = os.path.join(REPO, "build", f"deck_{var}.ini")
        with open(path, "w") as f:
            f.write(text)
        tps = channel_tps(torch.float32, f"deck_{var}", iters=2, path=path)
        s = tps.solver.flow
        reset_all_launches()
        tps.solve()
        torch.cuda.synchronize()
        counts = launches_by_variant()
        want = {"face_sweep": 4 * s.iter, f"face_sweep/{var}": 4 * s.iter}
        bad = {k: v for k, v in counts.items() if v != want.get(k, 0)}
        finite = bool(torch.isfinite(s.U).all())
        log(f"  {var}'s path ({s.tables_np.ne} elements p=2 GL, f32): "
            f"{s.iter} steps, launches {counts}, finite {finite}")
        if bad or not finite or tps.get_status() != 0 or s.iter != 2:
            raise SystemExit(f"{var}: the CLI run failed its checks "
                             f"(launches off: {bad})")
        out[var]["launches"] = counts[f"face_sweep/{var}"]
        del tps, s
    return out, worst


def launch_account(path, tag):
    """Phase 52's account of the deck's launches, each profiled on the card
    in f32 over several calls and divided: launches a graph step of the
    deck as shipped and of the deck with its outer wall inviscid like its
    axis (both walls of one kind, which `dg/rhs.py::_bc_runs` runs as one
    flux call a stage); and, on the deck as shipped, the launches of one
    call of the geometric source, of one plain temperature of its state
    (a Newton solve) and of one mu and kappa lookup (the source's
    transport).  Fails where a count is missing."""
    from tps_torch.dg.forcing import AxisymmetricSource

    with open(path) as f:
        text = f.read()
    one_kind = os.path.join(REPO, "build", f"{tag}_one_wall_kind.ini")
    with open(one_kind, "w") as f:
        f.write(text.replace("type = viscous_adiabatic", "type = inviscid"))
    out = {}
    for name, deck in (("step, as shipped", path),
                       ("step, both walls inviscid", one_kind)):
        tps = channel_tps(torch.float32, f"{tag}_count", iters=2, path=deck)
        fl = tps.solver.flow
        fl.write_restart = lambda: None
        fl.cuda_graphs = True
        tps.solve()  # the capture
        out[name] = device_share(lambda: fl.solve_chunk(1), 2).get("launches")
        if deck == path:
            src = next(f for f in fl.ctx.forcings
                       if isinstance(f, AxisymmetricSource))
            U = fl.U.clone()
            Up = fl.mixture.primitives(U)
            grad = torch.zeros(U.shape + (fl.mixture.dim,), dtype=U.dtype,
                               device=U.device)
            tab = fl.tables
            for key, fn in (
                    ("source", lambda: src(0.0, tab, U, Up, grad)),
                    ("temperature", lambda: fl.mixture.temperature(U)),
                    ("mu lookup", lambda: fl.transport.flux_properties(
                        fl.mixture, U, Up, grad))):
                out[key] = device_share(fn, 8).get("launches")
        del tps, fl
    log(f"  launches on the card, f32, a profiled call's mean: {out}")
    missing = [k for k, v in out.items() if not v]
    if missing:
        raise SystemExit(f"phase 52: no launches recorded for {missing}")
    return out


def phase_lte_torch(dev, refs):
    """Phase 52: tps_torch/tools/lte_torch_axisym.ini (the LTE-table torch
    in (r, z) with swirl under the Joule coupling, 64x64 p=2 GL, EM every
    10 steps) through the CLI as phase 42 runs its deck (phase_torch_axi):
    20 steps in f32 and f64, the lte_axi sweep 4 times a step and no other
    variant, graph vs eager within GRAPH_TOL, card vs the port's CPU at
    step 3 (U within LTE_CPU_TOL, phase 39's bar; the fields within
    CHANNEL_CPU_TOL), the power on target at each EM solve, ms/step; the
    deck on Euler, 2 steps, lte_axi_euler.  Then launch_account."""
    path = lte_axi_deck("lte_axi")
    out = phase_torch_axi(dev, refs, path, "lte_axi", "lte_axi",
                          euler="lte_axi_euler", cpu_tol=LTE_CPU_TOL)
    out["launches"] = launch_account(path, "lte_axi")
    torch.cuda.empty_cache()
    return out


def run(dev, refs):
    """Every phase on device dev, the CPU references in refs (a CpuRefs,
    started here once the kernels are built); returns the kernels'
    record and the card's nvidia-smi line."""
    from tps_torch.dg import cuda_fused

    t_start = time.perf_counter()

    def log_phase(text):
        log(f"{text} [{time.perf_counter() - t_start:.1f} s]")

    log_phase("phase 1: build")
    setup = Setup()

    def build():
        t0 = time.perf_counter()
        path = cuda_fused.build_kernels()
        return path, time.perf_counter() - t0

    # nvcc's processes build the kernels while this thread builds the
    # numpy tables of phases 2 and 3 (~50 s of host work)
    with ThreadPoolExecutor(1) as pool:
        built = pool.submit(build)
        for n, order in KERNEL_GRIDS:
            setup.tables(n, order)
        for n, order, basis, walls in FACE_GRIDS:
            setup.tables(n, order, basis, walls)
        path, build_s = built.result()
    log(f"  built {os.path.relpath(path, REPO)} in {build_s:.1f} s")
    refs.start()
    for line in cuda_fused._Library.build_log.splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line
                or "compiled in" in line):
            log("  " + line.strip())
    smi = nvidia_smi_line()
    log(f"  card: {smi}")

    log_phase("phase 2: K1/K2 vs plain version (relative to max|plain|)")
    main_err = phase_kernels(setup, dev)
    log_phase("phase 3: face sweep vs plain versions (relative to "
              "max|plain|)")
    face_err, proto = phase_faces(setup, dev)
    phase_constant_decks(dev)
    log_phase("phase 4: the fused path's CLI (flagship deck with the GL "
              "basis, 16^3 p=2 NS, RK4, f32)")
    counts, _, fused16 = phase_cli(flagship_deck(),
                                   ("k1_gradient", "k2_faces_volume"),
                                   ("face_sweep",))
    log_phase("phase 5: the slot path's CLI (vortex3d_ns.ini as shipped: "
              "GLL, 16^3 p=2 NS, RK4, f32)")
    counts_slot, _, gll_deck = phase_cli(DECK, ("face_sweep",),
                                         ("k1_gradient", "k2_faces_volume"))
    log_phase("phase 6: solver vs plain RK4 loop (32^3 p=2 NS, f64, fixed dt)")
    fixed = {"fused 32^3": phase_solver(dev)}
    log_phase("phase 7: slot solver vs plain RK4 loop (16^3 p=2 GLL NS, "
              "six inviscid walls, f64, fixed dt)")
    fixed["walled slot"] = phase_walled_solver(dev)
    log_phase("phase 8: the step graph vs eager steps through solve() (f64)")
    phase_graphs(dev, fixed)
    del fixed
    phase_stateful_graph(dev)
    log_phase("phase 9: timing K1/K2 (f32, NS, p=2)")
    timing = phase_timing(setup, dev)
    log_phase("phase 10: timing the slot path (f32, NS, 16^3 p=2)")
    slot = phase_slot_timing(setup, dev)
    log_phase("phase 11: ms/step through solve(), step graph vs eager "
              "(f32, NS, p=2, RK4)")
    walled_gl = WALLED_DECK.replace(
        "[flow]\n", "[flow]\nbasisType = 0\nintegrationRule = 0\n", 1)
    fused32 = deck_solver(SOLVER_DECK, "fused32", CFL, torch.float32, dev)
    steps = phase_step_timing({
        "gll_deck 16^3": gll_deck,
        "walled_gl 16^3": deck_solver(walled_gl, "walled_gl", FIXED_DT,
                                      torch.float32, dev),
        "fused 16^3": fused16,
        "fused 32^3": fused32})
    del gll_deck, fused16
    log_phase("phase 12: the cylinder's CLI (cyl2d_ogrid.ini as shipped: "
              "curved O-grid 12x48 p=2 GL NS, isothermal wall, far field, "
              "RK4, f32, 200 steps)")
    counts_cyl, cyl_physics = phase_cylinder()
    log_phase("phase 13: face sweep vs plain on the O-grid (12x48, 24x96, "
              "96x384; GL, GLL) and on a hex mesh read from an MFEM file")
    annulus = phase_annulus_faces(setup, dev)
    log_phase("phase 14: a checkpoint continued on the card vs a straight "
              "run (f64, step graphs)")
    phase_restart(dev)
    log_phase("phase 15: ms/step through solve(), step graph vs eager, on "
              "the cylinder (24x96, 96x384) and the 3-D file-mesh channel "
              "(32x16x16 GLL, a nonReflectingPressure outlet) (f32, NS, "
              "p=2, RK4)")
    chan32, _, _ = file_channel_deck((32, 16, 16), 10**6, "chan32")
    steps.update(phase_step_timing({
        "cylinder 24x96": deck_solver(annulus_deck(24, 96, 10**6, "cyl24"),
                                      "cyl24", "", torch.float32, dev,
                                      perturb=False),
        "cylinder 96x384": deck_solver(annulus_deck(96, 384, 10**6, "cyl96"),
                                       "cyl96", "", torch.float32, dev,
                                       perturb=False),
        "file channel 32x16x16": deck_solver(chan32, "chan32", "",
                                             torch.float32, dev)}))
    log_phase("phase 16: checkpoint write and read, 32^3 p=2 (f32 state, "
              "f64 file)")
    io32 = phase_io_timing(fused32)
    del fused32
    log_phase("phase 17: face sweep vs plain on the argon plasma (6x6 p=1 "
              "GLL, 32x32 p=2 GL and GLL, 128x128 p=2 GL; f64, f32)")
    argon_faces, argon_err = phase_argon_faces(dev)
    log_phase("phase 18: the argon deck's CLI (argon_plasma_2d.ini as "
              "shipped: 6x6 p=1 GLL, 2-T ambipolar Ar/Ar+/e, RK4, f32, 4 "
              "steps), then f64 against the golden checkpoint")
    counts_argon, argon_cli_checks = phase_argon_cli()
    log_phase("phase 19: bench_argon_big's deck (32x32 p=2 GL, f64): solver "
              "vs plain RK4 loop, step graph vs eager")
    argon_solver_checks = phase_argon_solver(dev)
    log_phase("phase 20: ms/step through solve() on the argon plasma, step "
              "graph vs eager (32x32 p=2 GL cfl 0.01, 128x128 cfl 0.0025; "
              "f32, RK4)")
    # bench_argon_big's cfl 0.02 is above the electron-energy diffusion
    # limit at 32x32 p=2: T_e noise grows ~4x a step, in the JAX package
    # as in this one (the same digits on the CPU in f64, 1e-6 noise), and
    # decays at 0.01.  These turns run ~60 steps, so at half of it, and
    # at a quarter of that at 128x128 (h/4, dt ~ h^2); 4 steps a turn
    # (eager steps take 70-90 ms here)
    argon_steps = phase_step_timing({
        "argon 32x32": argon_solver(argon_big_deck(32, 0.01, 10**6,
                                                   "argon32"),
                                    torch.float32, False),
        "argon 128x128": argon_solver(argon_big_deck(128, 0.0025, 10**6,
                                                     "argon128"),
                                      torch.float32, False)})
    for name, res in argon_steps.items():
        if not res["finite"]:
            raise SystemExit(f"{name}: the f32 state left the finite range")
    steps.update(argon_steps)

    log_phase("phase 21: the H1 operators and CG on the card vs the CPU "
              "(f64, 2-D 16x16 p=3, 3-D 8^3 p=2), bitwise repeatable")
    h1_worst = phase_h1(dev)
    log_phase("phase 22: the low-Mach decks through the CLI (lomach_tgv2d.ini "
              "40 steps, channel_rans.ini 200 steps, f32), then f64 card vs "
              "CPU")
    lomach_decks = phase_lomach_decks(dev, refs)
    log_phase("phase 23: low-Mach step graphs vs eager steps through solve() "
              "(f64, 20 constant-order steps)")
    lomach_graphs = phase_lomach_graphs()
    log_phase("phase 24: low-Mach ms/step through solve(), graph vs eager "
              "(channel_rans.ini, TGV 64x64 p=3, 3-D channel 24x12x12 p=2; "
              "f64, f32)")
    lomach_steps = {}
    for dtype in (torch.float64, torch.float32):
        lomach_steps.update(phase_lomach_timing(
            {k: make().solver for k, make in lomach_cases(dtype).items()}))
    log_phase("phase 25: the coupled torch's modules on the card vs the "
              "CPU (f64: tables, radius-weighted H1 applies, EM block "
              "apply, dense Schur and GMRES solves, interpolation)")
    coupled_modules = phase_coupled_modules(dev)
    log_phase("phase 26: torch_axisym_coupled.ini as shipped through the CLI "
              "(f32, 1000 steps, EM every 10), then f64 card vs CPU")
    coupled_deck = phase_coupled_deck(dev, refs)
    log_phase("phase 27: the coupled deck's step graphs vs eager steps "
              "across an EM update (f64, 20 steps)")
    coupled_graphs = phase_coupled_graphs()
    log_phase("phase 28: ms/step through the coupled solve(), graph vs "
              "eager (the shipped deck in f64 and f32, the refined one in "
              "f64)")
    coupled_steps = {}
    for dtype in (torch.float64, torch.float32):
        coupled_steps.update(phase_coupled_timing(
            {k: make().solver for k, make in coupled_cases(dtype).items()}))
    log_phase("phase 29: the reacting path's modules on the card vs the CPU "
              "(f64, 24x48 p=2: transport, reaction source, closure, "
              "conductivity, TabulatedRate, sponge, Gaussian interpolation; "
              "one ReactingFlow step)")
    reacting_mods = phase_reacting_modules(dev)
    log_phase(f"phase 30: lomach_reacting.ini through the CLI (f32, "
              f"{REACT_STEPS} steps), then f64 card vs CPU (10 steps)")
    reacting_deck = phase_reacting_deck(dev, refs)
    log_phase("phase 31: step graphs vs eager steps through solve() (f64): "
              "the reacting deck across a dense refresh, a channel with a "
              "plane sponge and an interpolated inlet inside its ramp")
    reacting_graphs = phase_reacting_graphs()
    log_phase("phase 32: the reacting thermo under the Joule coupling on the "
              "card (test_coupling.py's 5x5 set-up, 4 steps), then vs the "
              "CPU (f64)")
    reacting_coupled_out = phase_reacting_coupled(dev)
    log_phase("phase 33: ms/step through solve() on lomach_reacting.ini, "
              "graph vs eager (f64, f32)")
    reacting_steps = {}
    for dtype in (torch.float64, torch.float32):
        cases = {k: make().solver for k, make in
                 reacting_cases(dtype).items()}
        res = phase_lomach_timing(cases)
        for name, s in cases.items():
            key = f"{name} {str(s.dtype)[6:]}"
            res[key]["pointwise_chain"] = chain = reacting_chain(s)
            log(f"  {key}: the pointwise chain alone, device ms: {chain}")
        reacting_steps.update(res)
        del cases
    log_phase("phase 34: the face sweep's mixture variants vs plain (3-D "
              "argon, Euler 2-D and 3-D, constant transport, the six-species "
              "mixture; each on a small grid and at full width; f64, f32)")
    mix_faces, mix_err = phase_mixture_faces(dev)
    log_phase("phase 35: argon_channel_coupled.ini through the CLI (f32, 100 "
              "steps, EM every 10), then f64 card vs CPU and graph vs eager "
              "across an EM update")
    channel = phase_channel_deck(dev, refs)
    log_phase("phase 36: the variants' decks, argon_full.ini and "
              "argon_inflow_outflow.ini through the CLI (f32), then the last "
              "two at 64x64 p=2 vs a plain loop (f64)")
    mix_decks = phase_mixture_decks(dev)
    log_phase("phase 37: ms/step through solve() on the coupled channel (f32, "
              "f64) and argon_full at 64x64 p=2 (f32), graph vs eager")
    channel_steps = phase_channel_timing()
    log_phase("phase 38: the face sweep's LTE variants vs plain (2-D and "
              "3-D, 1-D and 2-D tables, NS and Euler; f64, f32), then each "
              "variant's path through the CLI (f32, 2 steps)")
    lte_faces, lte_err = phase_lte_faces(dev)
    log_phase("phase 39: lte_channel_coupled.ini through the CLI (f32, 100 "
              "steps, EM every 10), then f64 graph vs eager and card vs CPU "
              "across an EM update (8x8), and ms/step (f32)")
    lte_channel = phase_lte_channel(dev)
    log_phase("phase 40: the LTE restart: phase 39's f64 checkpoint "
              "converted into argon_full.ini's state on the card and the "
              "CPU, then 4 steps (f64)")
    lte_restart = phase_lte_restart(dev)
    log_phase("phase 41: the face sweep's axisymmetric variants vs plain "
              "(dry_air_axi on Navier-Stokes and Euler on the strip, "
              "argon_axi and argon_axi_euler on the torch deck's box on the "
              "axis; 64x64 p=2 GL; f64, f32)")
    axi_faces, axi_err = phase_axi_faces(dev)
    log_phase("phase 42: argon_torch_axisym.ini through the CLI (f32 and "
              "f64, 20 steps, EM every 10), f64 graph vs eager and card vs "
              "CPU (3 steps), ms/step (f32); the deck on Euler (2 steps)")
    torch_axi = phase_torch_axi(dev, refs)
    log_phase("phase 43: axisym_pipe.ini at 32x128 p=2 (DryAir NS, f64, 20 "
              "RK3 steps) vs a plain RK3 loop; the pipe on Euler (2 steps)")
    pipe = phase_pipe(dev)
    log_phase("phase 44: the face sweep's closure and Roe variants vs plain "
              "(the mixing length, Smagorinsky, Sigma, the sponge, alone and "
              "together, on DryAir 2-D/3-D/axi and the argon ternary "
              "2-D/3-D/axi; Roe on DryAir 2-D/3-D, NS and Euler; small boxes "
              "and the decks' width; f64, f32), then each variant's path "
              "through the CLI (f32, 2 steps)")
    closure_faces, closure_launched, closure_err = phase_closure_faces(dev)
    log_phase("phase 45: argon_torch_axisym_ml.ini through the CLI (f32 and "
              "f64, 20 steps, EM every 10), f64 graph vs eager and card vs "
              "CPU (3 steps), ms/step (f32)")
    torch_ml = phase_torch_axi(dev, refs, ML_DECK, "argon_axi_closure",
                               "torch_ml", euler=None)
    log_phase("phase 46: les_channel3d.ini (Roe + Sigma, 32x16x16 p=2 GL) "
              "through the CLI (f32 and f64, 20 steps), f64 graph vs eager; "
              "card vs CPU at 16x8x8 (3 steps); ms/step (f32)")
    les = phase_les(dev)
    log_phase("phase 47: the MMS decks' reference brackets on the card "
              "through tps_torch/tools/compute_rhs.py (euler_2d quad "
              "160x160, cns_2d quad 80x80, p=2 GLL, f64)")
    mms_brackets = phase_mms_brackets(dev)
    log_phase("phase 48: the 3-D transient MASA rates (euler_transient_3d "
              "at 6^3 and 12^3 p=1 GL to t = 6e-3 s, the Navier-Stokes form "
              "at 6^3; f64, step graph)")
    masa_rates = phase_masa_rates(dev)
    log_phase("phase 49: each forcing alone and all together (the forced "
              "channel at 8x4x4, the MMS sources, the argon deck's "
              "two-temperature sponge): graph vs eager vs the CPU (f64)")
    forcings = phase_forcings(dev, refs)
    log_phase("phase 50: forced_channel3d.ini (32x16x16 p=2 GL, pressure "
              "forcing, heat source, sponge) through the CLI (f32 and f64, "
              "200 steps), f64 graph vs eager; card vs CPU at 16x8x8 (3 "
              "steps); ms/step (f32)")
    with shared_tables():  # its three full-size runs
        forced = phase_forced_channel(dev, refs)
    log_phase("phase 51: the face sweep's lte_axi variants vs plain (the "
              "LTE torch deck's box on the axis: 1-D tables 64x64, 2-D "
              "tables 32x32 p=2 GL; NS and Euler; f64, f32), then the "
              "2-D-table variants' path through the CLI (f32, 2 steps)")
    lte_axi_faces, lte_axi_err = phase_lte_axi_faces(dev)
    log_phase("phase 52: lte_torch_axisym.ini through the CLI (f32 and f64, "
              "20 steps, EM every 10), f64 graph vs eager and card vs CPU "
              "(3 steps), ms/step (f32); the deck on Euler (2 steps); the "
              "launches of the geometric source")
    lte_torch = phase_lte_torch(dev, refs)
    torch.set_default_dtype(torch.float32)

    t16 = timing[(16, 16, 16)]
    tab16 = setup.tables((16, 16, 16), 2)
    gll = slot["gll_deck"]
    k1b, k2b = k1_bound(tab16), k2_bound(tab16)
    fb = face_bound(gll["tab"], "navier-stokes", "gll")
    kernels = [
        {"name": "k1_gradient", "route": "cuda",
         "source": "tps_torch/csrc/fused_rhs.cu",
         "replaces": "tps_tpu/dg/pallas_fused.py:258",
         "launches": counts["k1_gradient"],
         "max_abs_err": main_err["k1_gradient"],
         "ms": t16["k1_gradient"]["ms"],
         "device_ms": t16["k1_gradient"]["device_ms"],
         "plain_ms": t16["k1_gradient"]["plain_ms"],
         "bound_ms": k1b[0], "bound_by": k1b[1], "library_ms": None},
        {"name": "k2_faces_volume", "route": "cuda",
         "source": "tps_torch/csrc/fused_rhs.cu",
         "replaces": "tps_tpu/dg/pallas_fused.py:322",
         "launches": counts["k2_faces_volume"],
         "max_abs_err": main_err["k2_faces_volume"],
         "ms": t16["k2_faces_volume"]["ms"],
         "device_ms": t16["k2_faces_volume"]["device_ms"],
         "plain_ms": t16["k2_faces_volume"]["plain_ms"],
         "bound_ms": k2b[0], "bound_by": k2b[1], "library_ms": None},
        {"name": "face_sweep", "route": "cuda",
         "source": "tps_torch/csrc/face_sweep.cu",
         "replaces": "tools/pallas_face_prototype.py:102",
         "launches": counts_slot["face_sweep"],
         "launches_by_path": {"vortex3d_ns.ini": counts_slot["face_sweep"],
                              "cyl2d_ogrid.ini": counts_cyl["face_sweep"],
                              "argon_plasma_2d.ini":
                                  counts_argon["face_sweep"]},
         "max_abs_err": face_err,
         "ms": gll["face_sweep_ms"], "device_ms": gll["face_sweep_device_ms"],
         "plain_ms": gll["face_sweep_plain_ms"],
         "bound_ms": fb[0], "bound_by": fb[1], "library_ms": None,
         "argon_32x32": {k: argon_faces["argon 32x32"][k] for k in (
             "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
         "argon_f64_max_rel_err": argon_err},
    ]
    # the mixture variants: launches on their paths' CLI runs (phases 35,
    # 36), times and bounds at full width (phase 34)
    variant_launches = {
        "argon_2d": channel["as shipped f32"]["launches"],
        "argon_3d": mix_decks["argon_3d"]["launches"],
        "argon_euler": mix_decks["argon_euler_2d"]["launches"],
        "argon_euler_3d": mix_decks["argon_euler_3d"]["launches"],
        "argon_const": mix_decks["argon_const"]["launches"],
        "gas_mixture": mix_decks["argon_full"]["launches"]}
    sources = {"argon_3d": "face_sweep_argon3d.cu",
               "argon_euler": "face_sweep_argon.cu",
               "argon_euler_3d": "face_sweep_argon3d.cu",
               "argon_const": "face_sweep_argon_const.cu",
               "gas_mixture": "face_sweep_gas_mixture.cu"}
    for key, src in sources.items():
        var = "argon_euler" if key.startswith("argon_euler") else key
        rec = mix_faces[key]
        kernels.append({
            "name": f"face_sweep/{key}", "route": "cuda",
            "source": f"tps_torch/csrc/{src}",
            "replaces": "tools/pallas_face_prototype.py:102",
            "launches": variant_launches[key][f"face_sweep/{var}"],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "device_ms": rec["device_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None, "grid": rec["grid"],
            "f64_ms": rec["f64_ms"], "f64_device_ms": rec["f64_device_ms"],
            "f64_max_rel_err": rec["f64_rel_err"]})
    kernels[2]["launches_by_path"]["argon_channel_coupled.ini"] = \
        variant_launches["argon_2d"]["face_sweep/argon_2d"]
    # the LTE variants: launches on their paths' CLI runs (phases 38, 39),
    # times and bounds at the width of those paths (phase 38)
    lte_launches = lte_channel["as shipped f32"]["launches"][
        "face_sweep/lte_2d"]
    kernels[2]["launches_by_path"]["lte_channel_coupled.ini"] = lte_launches
    for var, rec in lte_faces.items():
        kernels.append({
            "name": f"face_sweep/{var}", "route": "cuda",
            "source": "tps_torch/csrc/face_sweep_lte"
                      + ("3d" if "_3d" in var else "") + ".cu",
            "replaces": "tools/pallas_face_prototype.py:102",
            "launches": lte_launches if var == "lte_2d" else rec["launches"],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "device_ms": rec["device_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None, "grid": rec["grid"],
            "f64_ms": rec["f64_ms"], "f64_max_rel_err": rec["f64_rel_err"]})
    # the axisymmetric variants: launches on their paths' CLI runs (phases
    # 42, 43; dry_air_axi's Euler form on the pipe's Euler run), times and
    # bounds at the torch deck's width (phase 41)
    axi_launches = {
        "dry_air_axi": pipe["launches"]["face_sweep/dry_air_axi"],
        "dry_air_axi_euler": pipe["euler f32"]["launches"][
            "face_sweep/dry_air_axi"],
        "argon_axi": torch_axi["f32"]["launches"]["face_sweep/argon_axi"],
        "argon_axi_euler": torch_axi["euler f32"]["launches"][
            "face_sweep/argon_axi_euler"]}
    kernels[2]["launches_by_path"]["argon_torch_axisym.ini"] = \
        axi_launches["argon_axi"]
    kernels[2]["launches_by_path"]["axisym_pipe.ini"] = \
        axi_launches["dry_air_axi"]
    for key, rec in axi_faces.items():
        var = rec["variant"]
        kernels.append({
            "name": f"face_sweep/{key}", "route": "cuda",
            "source": "tps_torch/csrc/" + ("face_sweep_axi.cu"
                                           if var == "dry_air_axi"
                                           else "face_sweep_argon_axi.cu"),
            "replaces": "tools/pallas_face_prototype.py:102",
            "launches": axi_launches[key],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "device_ms": rec["device_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None, "grid": rec["grid"],
            "f64_ms": rec["f64_ms"], "f64_device_ms": rec["f64_device_ms"],
            "f64_max_rel_err": rec["f64_rel_err"]})
    # the closure and Roe variants: launches on their paths' CLI runs
    # (phases 45, 46, and phase 44's small decks), times and bounds at the
    # decks' width (phase 44)
    closure_launches = {
        **closure_launched,
        "argon_axi_closure": torch_ml["f32"]["launches"][
            "face_sweep/argon_axi_closure"],
        "dry_air_roe_3d_closure": les["f32"]["launches"][
            "face_sweep/dry_air_roe_3d_closure"]}
    kernels[2]["launches_by_path"]["argon_torch_axisym_ml.ini"] = \
        closure_launches["argon_axi_closure"]
    kernels[2]["launches_by_path"]["les_channel3d.ini"] = \
        closure_launches["dry_air_roe_3d_closure"]
    for key, rec in closure_faces.items():
        src = ("face_sweep_roe.cu" if "roe" in key
               else "face_sweep_argon3d.cu" if key == "argon_3d_closure"
               else "face_sweep_argon.cu" if key == "argon_2d_closure"
               else "face_sweep_argon_axi.cu" if key == "argon_axi_closure"
               else "face_sweep_axi.cu" if key == "dry_air_axi_closure"
               else "face_sweep.cu")
        kernels.append({
            "name": f"face_sweep/{key}", "route": "cuda",
            "source": f"tps_torch/csrc/{src}",
            "replaces": "tools/pallas_face_prototype.py:102",
            "launches": closure_launches[key],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "device_ms": rec["device_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None, "grid": rec["grid"],
            "f64_ms": rec["f64_ms"], "f64_device_ms": rec["f64_device_ms"],
            "f64_max_rel_err": rec["f64_rel_err"]})
    # the forcings' and MMS decks' launches (phases 47-50): all on the
    # DryAir sweep, the argon sponge deck on argon_2d
    kernels[2]["launches_by_path"].update({
        **{f"{k} (compute_rhs)": v["launches"]
           for k, v in mms_brackets.items()},
        **{f"3-D MASA {k}": v["launches"]
           for k, v in masa_rates.items() if k != "rates"},
        **{k: v["launches"] for k, v in forcings.items()},
        "forced_channel3d.ini": forced["f32"]["launches"]})
    # the LTE fluid's axisymmetric variants: launches on their paths' CLI
    # runs (phase 52: the deck and its Euler form; phase 51: the deck on
    # the 2-D tables), times and bounds at the width of those paths
    # (phase 51)
    lte_axi_launches = {
        "lte_axi": lte_torch["f32"]["launches"]["face_sweep/lte_axi"],
        "lte_axi_euler": lte_torch["euler f32"]["launches"][
            "face_sweep/lte_axi_euler"],
        **{v: lte_axi_faces[v]["launches"] for v in ("lte_axi_t2",
                                                     "lte_axi_t2_euler")}}
    kernels[2]["launches_by_path"]["lte_torch_axisym.ini"] = \
        lte_axi_launches["lte_axi"]
    for var, rec in lte_axi_faces.items():
        kernels.append({
            "name": f"face_sweep/{var}", "route": "cuda",
            "source": "tps_torch/csrc/face_sweep_lte_axi.cu",
            "replaces": "tools/pallas_face_prototype.py:102",
            "launches": lte_axi_launches[var],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "device_ms": rec["device_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None, "grid": rec["grid"],
            "f64_ms": rec["f64_ms"], "f64_device_ms": rec["f64_device_ms"],
            "f64_max_rel_err": rec["f64_rel_err"]})
    # the DryAir sweep at the forced channel's width (phase 50)
    fs = forced["face_sweep"]
    kernels.append({
        "name": "face_sweep/dry_air forced_channel3d", "route": "cuda",
        "source": "tps_torch/csrc/face_sweep.cu",
        "replaces": "tools/pallas_face_prototype.py:102",
        "launches": forced["f32"]["launches"],
        **{k: fs[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms",
                              "bound_ms", "bound_by", "grid", "f64_ms")},
        "library_ms": None, "f64_max_rel_err": fs["f64_rel_err"]})
    pb = face_bound(setup.tables((16, 16, 16), 2), "euler", "gl")
    summary = {f"fused {n[0]}^3": {"ms_per_rhs": v["ms_per_rhs"],
                                   "plain_ms_per_rhs": v["plain_ms_per_rhs"],
                                   **{f"{k}_{f}": v[name][f]
                                      for k, name in (("k1", "k1_gradient"),
                                                      ("k2", "k2_faces_volume"))
                                      for f in ("ms", "f64_ms", "device_ms",
                                                "f64_device_ms")},
                                   "profile": v["profile"]}
               for n, v in timing.items()}
    summary.update({f"slot {k}": {kk: v[kk] for kk in (
        "ms_per_rhs", "plain_ms_per_rhs", "face_sweep_ms",
        "face_sweep_device_ms",
        "face_sweep_plain_ms", "face_sweep_f64_ms", "parts_ms",
        "launches_per_rhs", "profile")}
        for k, v in slot.items()})
    summary["solve() ms/step"] = steps
    summary["face_sweep on the O-grid (GL, p=2, NS)"] = {
        k: {kk: v[kk] for kk in ("ms", "device_ms", "plain_ms", "f64_ms",
                                 "bound_ms", "bound_by", "max_abs_err")}
        for k, v in annulus.items()}
    summary["cylinder deck"] = {"launches": counts_cyl, **cyl_physics}
    summary["checkpoint 32^3 p=2"] = io32
    summary["face_sweep on the argon plasma (p=2 GL, NS)"] = argon_faces
    summary["argon deck"] = {"launches": counts_argon, **argon_cli_checks,
                             **argon_solver_checks}
    summary["low-Mach"] = {"H1 card vs CPU (f64)": h1_worst,
                           "decks": lomach_decks,
                           "graph vs eager (f64)": lomach_graphs,
                           "solve() ms/step": lomach_steps}
    summary["coupled torch"] = {"modules card vs CPU (f64)": coupled_modules,
                                "deck": coupled_deck,
                                "graph vs eager (f64)": coupled_graphs,
                                "solve() ms/step": coupled_steps}
    summary["reacting low Mach"] = {
        "modules card vs CPU (f64)": reacting_mods, "deck": reacting_deck,
        "graph vs eager (f64)": reacting_graphs,
        "coupled": reacting_coupled_out, "solve() ms/step": reacting_steps}
    summary["compressible argon plasma"] = {
        "face sweep variants": mix_faces, "variants f64 max rel err": mix_err,
        "coupled channel": channel, "decks": mix_decks,
        "solve() ms/step": channel_steps}
    summary["LTE-table plasma"] = {
        "face sweep variants": lte_faces, "variants f64 max rel err": lte_err,
        "coupled channel": lte_channel, "restart": lte_restart}
    summary["axisymmetric"] = {
        "face sweep variants": axi_faces, "variants f64 max rel err": axi_err,
        "torch deck": torch_axi, "pipe": pipe}
    summary["closures and Roe"] = {
        "face sweep variants": closure_faces,
        "variants f64 max rel err": closure_err,
        "paths' launches": closure_launches, "ml torch deck": torch_ml,
        "les channel": les}
    summary["forcings and MMS"] = {
        "MMS brackets (f64)": mms_brackets, "3-D MASA rates (f64)": masa_rates,
        "forcings graph/eager/cpu (f64)": forcings, "forced channel": forced}
    summary["axisymmetric LTE torch"] = {
        "face sweep variants": lte_axi_faces,
        "variants f64 max rel err": lte_axi_err, "deck": lte_torch}
    summary["face_sweep prototype mode"] = {
        "ms": proto["ms"], "plain_ms": proto["plain_ms"],
        "bound_ms": pb[0], "bound_by": pb[1], "rel_err": proto["rel_err"]}
    log(f"ms (f32 unless named; CUDA events, host included, except "
        f"device_ms: torch.profiler, the kernel alone): {json.dumps(summary)}")
    for name, b in (("k1_gradient", k1b), ("k2_faces_volume", k2b),
                    ("face_sweep", fb), ("face_sweep prototype mode", pb)):
        log(f"  bound {name}: operations {b[2]:.6f} ms, bytes {b[3]:.6f} ms")
    log("design FMAs and achieved f32 rate:")
    t32 = timing[(32, 32, 32)]
    k1b32, k2b32 = k1_bound(t32["tab"]), k2_bound(t32["tab"])
    walled = slot["walled_gl"]
    fbw = face_bound(walled["tab"], "navier-stokes", "gl")
    for name, fma, t, b in (
            ("K1 16^3 f32", k1_design_fma(tab16), t16["k1_gradient"], k1b),
            ("K1 32^3 f32", k1_design_fma(t32["tab"]), t32["k1_gradient"],
             k1b32),
            ("K2 16^3 f32", design_fma(tab16, 20, True),
             t16["k2_faces_volume"], k2b),
            ("K2 32^3 f32", design_fma(t32["tab"], 20, True),
             t32["k2_faces_volume"], k2b32)):
        log(rate_line(name, fma, t["ms"], t["device_ms"], b))
    for name, fma, t, b in (
            ("face sweep GLL deck f32", design_fma(gll["tab"], 20, False),
             gll, fb),
            ("face sweep walled GL f32", design_fma(walled["tab"], 20, False),
             walled, fbw)):
        log(rate_line(name, fma, t["face_sweep_ms"],
                      t["face_sweep_device_ms"], b))
    log(f"  f64 ms (CUDA events): K1 16^3 {t16['k1_gradient']['f64_ms']:.4f}, 32^3 "
        f"{t32['k1_gradient']['f64_ms']:.4f}; "
        f"K2 16^3 {t16['k2_faces_volume']['f64_ms']:.4f}, 32^3 "
        f"{t32['k2_faces_volume']['f64_ms']:.4f}; face sweep GLL deck "
        f"{gll['face_sweep_f64_ms']:.4f}, walled GL "
        f"{walled['face_sweep_f64_ms']:.4f}")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    return kernels, smi


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    # the plain version's float32 matmuls must not run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    with CpuRefs() as refs:
        kernels, smi = run(torch.device("cuda", 0), refs)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
