"""GPU smoke test of tps_torch: builds the CUDA kernels, checks each against
its plain PyTorch version, drives the solver's CLI on three decks, checks
the solver against plain RK4 loops, its step graph against eager steps
and its checkpoints against straight runs, and times kernels, right-hand
sides, steps through solve() and checkpoint I/O.

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

Needs one CUDA GPU (sm_90a: the kernels are built for Hopper) and nvcc.
Fails (non-zero exit, no result line) without CUDA, when a kernel does not
build or launch, when any comparison misses its tolerance, or when a CLI
run did not launch its kernels or did not step through the graph.  The
last stdout line is {"ok": true, "device": {...}}; the line before it the
card's name and power limit; the one before that the kernels' JSON
record.
"""

from __future__ import annotations

import functools
import json
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
    from tps_torch.dg import cuda_faces, cuda_fused

    return {**cuda_fused.launches, **cuda_faces.launches}


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
    """ms/RHS (RK4 chains of 50 steps through the kernels, 10 through the
    host-bound plain version) and ms per kernel, kernels vs plain, in
    turns plain, kernel, kernel, plain, by CUDA events; each kernel's
    time on the device alone (`kernel_ms`), f32 and f64."""
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

        steps = {"plain": 10, "kernels": 50}
        runs = {"plain": chain(plain, U2, steps["plain"]),
                "kernels": chain(rhs, U, steps["kernels"])}
        times = {"plain": [], "kernels": []}
        for which in ("plain", "kernels", "kernels", "plain"):
            times[which].append(cuda_ms(runs[which], 2) / (4 * steps[which]))
        G = rhs.gradient(U)
        k = {
            "k1_gradient": [cuda_ms(lambda: plain.gradient(U2), 50),
                            cuda_ms(lambda: rhs.gradient(U), 50),
                            cuda_ms(lambda: rhs.gradient(U), 50),
                            cuda_ms(lambda: plain.gradient(U2), 50)],
            "k2_faces_volume": [
                cuda_ms(lambda: plain.faces_volume(U2, G.reshape(tab.ne, -1)), 50),
                cuda_ms(lambda: rhs.faces_volume(U, G), 50),
                cuda_ms(lambda: rhs.faces_volume(U, G), 50),
                cuda_ms(lambda: plain.faces_volume(U2, G.reshape(tab.ne, -1)), 50)],
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


def phase_step_timing(cases, steps=32, profiled=16):
    """ms/step through solve() (f32), the step graph against eager steps,
    in turns eager, graph, chain, chain, graph, eager, `steps` steps a
    turn, host clock to a synchronize ("chain": the same integrator and
    RHS called in a bare loop with Python-float t and dt, as phase 10's
    chains, outside solve()); the device's busy share in a profiled
    chunk of `profiled` steps, graph and eager; the capture's wall time
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
        prof = {}
        for graphs in (True, False):
            s.cuda_graphs = graphs
            prof["graph" if graphs else "eager"] = device_share(
                lambda: s.solve_chunk(profiled), 1)
        s.cuda_graphs = True
        lp = s._loop
        dev_ms = prof["graph"].get("device_ms")
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
    sweep alone and ms/RHS of the slot path (RK4 chains) through the
    kernel and through the plain sweep, on the flagship GLL deck's box and
    the walled GL box; the slot RHS's parts; launches per RHS."""
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

        def chain(f):
            def run():
                x = U
                for _ in range(10):
                    x = rk4(f, x, 0.0, 1e-7)[0]
                return x
            return run

        def turns(fp, fk, reps, per):
            t = [cuda_ms(fp, reps), cuda_ms(fk, reps), cuda_ms(fk, reps),
                 cuda_ms(fp, reps)]
            return (t[1] + t[2]) / 2 / per, (t[0] + t[3]) / 2 / per, t

        ms_rhs, plain_rhs, t_rhs = turns(chain(rhs_p), chain(rhs_k), 2, 40)
        ms_sw, plain_sw, t_sw = turns(lambda: sweep.plain(X), lambda: sweep(X),
                                      50, 1)
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
    return {"wall_ms": wall, "device_ms": dev, "busy_share": dev / wall,
            "kernels": len(by_name), "top_ms": {k[:60]: v for k, v in top}}


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


def face_bound(t, eq, basis, size=4, curved=False, argon=False):
    """The face sweep on tables t: per interior slot the own traces of X's
    k channels and the scatter of neq, per interior face the flux.  X in,
    the result out, the normals, nbr_row, the mask and Btr_or.  `argon`:
    the plasma's 6 equations (k = 18) and MIX_FACE_OPS (2-D, NS)."""
    ne, nd, nq, nlf, dim = t.ne, t.ndof, t.nqf, t.nlf, t.dim
    neq = dim + 4 if argon else dim + 2
    k = neq if eq == "euler" else neq * (1 + dim)
    trace, _ = tensor_fma(t, basis, curved)
    slots = int(np.count_nonzero(np.asarray(t.interior_mask)))
    flux = (slots * nq * MIX_FACE_OPS // 2 if argon
            else slots * nq * FACE_OPS[eq] * neq // 5 // 2)
    ops = 2 * slots * (k + neq) * trace + flux
    nbytes = (size * (ne * nd * k + ne * nd * neq + nlf * ne * nq * dim
                      + ne * nlf + t.n_combo * nq * nd) + 4 * ne * nlf)
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


def run(dev):
    """Every phase on device dev; returns the kernels' record and the
    card's nvidia-smi line."""
    from tps_torch.dg import cuda_fused

    t_start = time.perf_counter()

    def log_phase(text):
        log(f"{text} [{time.perf_counter() - t_start:.1f} s]")

    log_phase("phase 1: build")
    t0 = time.perf_counter()
    path = cuda_fused.build_kernels()
    log(f"  built {os.path.relpath(path, REPO)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in cuda_fused._Library.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  " + line.strip())
    smi = nvidia_smi_line()
    log(f"  card: {smi}")

    setup = Setup()
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
    # decays at 0.01.  These turns run ~230 steps, so at half of it, and
    # at a quarter of that at 128x128 (h/4, dt ~ h^2); 16 steps a turn
    # (eager steps take 70-90 ms here)
    argon_steps = phase_step_timing({
        "argon 32x32": argon_solver(argon_big_deck(32, 0.01, 10**6,
                                                   "argon32"),
                                    torch.float32, False),
        "argon 128x128": argon_solver(argon_big_deck(128, 0.0025, 10**6,
                                                     "argon128"),
                                      torch.float32, False)}, steps=16)
    for name, res in argon_steps.items():
        if not res["finite"]:
            raise SystemExit(f"{name}: the f32 state left the finite range")
    steps.update(argon_steps)

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
    kernels, smi = run(torch.device("cuda", 0))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
