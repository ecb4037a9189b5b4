"""GPU smoke test of tps_torch: builds the CUDA kernels, checks each against
its plain PyTorch version, drives the solver's CLI on two decks, checks
the solver against plain RK4 loops and its step graph against eager
steps, and times kernels, right-hand sides and steps through solve().

    python3 chip_smoke.py

The kernels: K1/K2 (dg/cuda_fused.py, the fused periodic path) and the
face sweep (dg/cuda_faces.py, the general slot path and the face-sweep
prototype).  The two main paths, each driven through the CLI with the
launch counts set to 0 just before it and read just after:
  - the fused path: the flagship deck with the collocated Gauss-Legendre
    basis (basisType = 0, integrationRule = 0 added), K1 + K2;
  - the slot path: examples/cases/vortex3d_ns.ini as shipped (the
    reference-default Gauss-Lobatto basis), the face sweep.
Both run solve()'s chunked loop, each step a replay of the solver's
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
# inputs, so equal up to the order of atomics (none on these paths)
GRAPH_TOL = 1e-12
PROTO_TOL = 1e-5  # the face-sweep prototype's own bar (f32)
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
    def ctx(eq_system, dim=3, walls_of=None):
        """RHS context; walls_of: tables whose every boundary patch gets an
        inviscid wall."""
        from tps_torch.dg.bc import WallBC
        from tps_torch.dg.fluxes import Fluxes
        from tps_torch.dg.rhs import RHSContext, bc_slices
        from tps_torch.dg.riemann import Rusanov
        from tps_torch.physics.gas import DryAir
        from tps_torch.physics.transport import DryAirTransport

        mix = DryAir(dim=dim, nvel=dim)
        tr = None if eq_system == "euler" else DryAirTransport(
            mix.gas_constant, mix.specific_heat_ratio)
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


def phase_kernels(setup, dev, grids=KERNEL_GRIDS):
    """K1, K2 and K1+K2 against the plain version on the card."""
    from tps_torch.dg.cuda_fused import build_cuda_fused

    failures, main_err = [], {}
    for n, order in grids:
        tab = setup.tables(n, order)
        for eq in ("euler", "navier-stokes"):
            ctx = setup.ctx(eq)
            rhs64 = build_cuda_fused(tab, ctx, torch.float64, dev)
            U64 = perturbed_U(ctx.mixture, tab.xyz_dof, torch.float64, dev)
            for dtype in (torch.float64, torch.float32):
                rhs = rhs64 if dtype == torch.float64 else build_cuda_fused(
                    tab, ctx, dtype, dev)
                res = compare_kernels(rhs, rhs64.plain, U64.to(dtype))
                name = f"{n} p={order} {eq} {str(dtype)[6:]}"
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
                if n == (16, 16, 16) and dtype == torch.float32 and rhs.viscous:
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


def deck_solver(deck, name, dt_line, dtype, dev, perturb=True):
    """A solver on the card through the harness, from `deck` with its
    [time] line dt_line, in dtype; from perturbed_U where perturb."""
    from tps_torch import harness

    torch.set_default_dtype(dtype)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    path = os.path.join(REPO, "build", name + ".ini")
    with open(path, "w") as f:
        f.write(deck.format(dt=dt_line))
    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", path])
    tps.parse_input()
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
              ((12, 12, 12), 3, "gll", False), ((32, 32), 3, "gll", True))


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
        for eq in ("euler", "navier-stokes"):
            ctx = setup.ctx(eq, len(n), tab_np if walls else None)
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
            name = f"{n} p={order} {basis}{' walls' if walls else ''} {eq}"
            log(f"  {name}: f64 {r64:.3e}; f32 {r32:.3e} (f64 dist: kernel "
                f"{dk:.3e}, plain {dp:.3e})" + ("" if ok else "  FAIL"))
            if not ok:
                failures.append(name)
            if (n, basis, walls, eq) == ((16, 16, 16), "gll", False,
                                         "navier-stokes"):
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


def phase_step_timing(cases, steps=32, profiled=16):
    """ms/step through solve() (f32), the step graph against eager steps,
    in turns eager, graph, chain, chain, graph, eager, `steps` steps a
    turn, host clock to a synchronize ("chain": the same integrator and
    RHS called in a bare loop with Python-float t and dt, as phase 10's
    chains, outside solve()); the device's busy share in a profiled
    chunk of `profiled` steps, graph and eager; the capture's wall time
    and the graph pool's device memory."""
    out = {}
    for name, s in cases.items():
        s.config.timing_freq = 10**9  # no timing print inside the turns

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


def tensor_fma(t, basis):
    """(trace, deriv): multiply-adds per channel of one face trace (or its
    transpose, the scatter to the nodes) and of the derivative along one
    axis at the nodes, on tables t of a box on `basis` ("gl" or "gll",
    nodes and face points of that family)."""
    from tps_torch.mesh.reference_element import (gauss_legendre_1d,
                                                  gauss_lobatto_1d,
                                                  lagrange_deriv, lagrange_eval)

    nor = np.abs(np.asarray(t.nor_slot))  # [ne, nlf, nqf, dim]
    if np.any(np.count_nonzero(nor > 1e-12 * nor.max(), axis=-1) != 1):
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


def face_bound(t, eq, basis, size=4):
    """The face sweep on tables t: per interior slot the own traces of X's
    k channels and the scatter of neq, per interior face the flux.  X in,
    the result out, the normals, nbr_row, the mask and Btr_or."""
    ne, nd, nq, nlf, dim = t.ne, t.ndof, t.nqf, t.nlf, t.dim
    neq = dim + 2
    k = neq if eq == "euler" else neq * (1 + dim)
    trace, _ = tensor_fma(t, basis)
    slots = int(np.count_nonzero(np.asarray(t.interior_mask)))
    ops = 2 * slots * (k + neq) * trace + slots * nq * FACE_OPS[eq] // 2
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
    log_phase("phase 9: timing K1/K2 (f32, NS, p=2)")
    timing = phase_timing(setup, dev)
    log_phase("phase 10: timing the slot path (f32, NS, 16^3 p=2)")
    slot = phase_slot_timing(setup, dev)
    log_phase("phase 11: ms/step through solve(), step graph vs eager "
              "(f32, NS, p=2, RK4)")
    walled_gl = WALLED_DECK.replace(
        "[flow]\n", "[flow]\nbasisType = 0\nintegrationRule = 0\n", 1)
    steps = phase_step_timing({
        "gll_deck 16^3": gll_deck,
        "walled_gl 16^3": deck_solver(walled_gl, "walled_gl", FIXED_DT,
                                      torch.float32, dev),
        "fused 16^3": fused16,
        "fused 32^3": deck_solver(SOLVER_DECK, "fused32", CFL, torch.float32,
                                  dev)})

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
         "max_abs_err": face_err,
         "ms": gll["face_sweep_ms"], "device_ms": gll["face_sweep_device_ms"],
         "plain_ms": gll["face_sweep_plain_ms"],
         "bound_ms": fb[0], "bound_by": fb[1], "library_ms": None},
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
