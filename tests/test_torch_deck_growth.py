"""max|u| of examples/cases/torch_axisym_coupled.ini as shipped (or, with
--deck reacting, of tps_torch/tools/lomach_reacting.ini; with --deck
channel, of the compressible coupled channel
tps_torch/tools/argon_channel_coupled.ini, its peak T the electrons';
with --deck axisym, of its axisymmetric form with swirl,
tps_torch/tools/argon_torch_axisym.ini, max|u| over the three velocities;
with --deck axisym_ml, of that deck with the mixing length and the
viscous sponge, tps_torch/tools/argon_torch_axisym_ml.ini; with --deck
lte_axisym, of the LTE-table torch in (r, z) with swirl,
tps_torch/tools/lte_torch_axisym.ini, its peak T the equilibrium one;
with --deck forced_channel, of the 3-D channel of air with the pressure forcing, the
heat source and the sponge zone, tps_torch/tools/forced_channel3d.ini,
its peak T the gas temperature),
step by step,
in the JAX package and in tps_torch side by side: a diagnostic of the
deck's growth, run as a script.  It holds no test function, so
pytest collects nothing from it.

Both packages build the deck through their harness (`Tps`) and advance
it one `solve_step` at a time, the per-step loop of the coupled solver
(an EM solve every `solve-em-every-n` steps, then the flow step).  Every
--every steps it prints, for each package, max|u|, the peak T and the
total Joule heating of the last EM solve (on the reacting deck: the
largest Y(Ar+)), and the distance between the
two packages' u and T relative to the JAX package's max.  The JAX package
runs on its CPU backend; tps_torch on --device (cpu unless asked).  A
package that stops (the port's solve-convergence guard raises) or goes
non-finite is reported and dropped; the other carries on.

    python tests/test_torch_deck_growth.py             # f64, 40 steps
    python tests/test_torch_deck_growth.py --f32 --steps 50
    python tests/test_torch_deck_growth.py --plain-lomach   # no Joule
    python tests/test_torch_deck_growth.py --deck reacting --f32 --steps 30
    python tests/test_torch_deck_growth.py --deck channel --steps 200 \
        --every 10 --dt 2e-9      # the channel's time step, its power

--plain-lomach runs the same deck as a plain `loMach` run (solver/type
loMach: the flow alone, no Joule heating).  --against-f64 first runs
the JAX package in f64 in a child process and then prints, beside each
package's numbers, its distance from that f64 run: on an --f32 run, each
package's own f32 error, the scale against which the distance between
the two packages is read.

    python tests/test_torch_deck_growth.py --deck reacting --f32 \
        --steps 30 --against-f64

--jax-only runs the JAX package alone (a deck too large to run twice on
the CPU):

    python tests/test_torch_deck_growth.py --deck forced_channel \
        --steps 200 --every 20 --jax-only
"""

import argparse
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DECKS = {"torch": os.path.join(REPO, "examples", "cases",
                               "torch_axisym_coupled.ini"),
         "reacting": os.path.join(REPO, "tps_torch", "tools",
                                  "lomach_reacting.ini"),
         "channel": os.path.join(REPO, "tps_torch", "tools",
                                 "argon_channel_coupled.ini"),
         "axisym": os.path.join(REPO, "tps_torch", "tools",
                                "argon_torch_axisym.ini"),
         "axisym_ml": os.path.join(REPO, "tps_torch", "tools",
                                   "argon_torch_axisym_ml.ini"),
         "lte_axisym": os.path.join(REPO, "tps_torch", "tools",
                                    "lte_torch_axisym.ini"),
         "forced_channel": os.path.join(REPO, "tps_torch", "tools",
                                        "forced_channel3d.ini")}


def deck_text(deck, steps, plain, outdir, dt=None, power=None):
    with open(DECKS[deck]) as f:
        txt = f.read()
    if dt is not None:
        txt = re.sub(r"dt_fixed = \S+", f"dt_fixed = {dt}", txt)
    if power is not None:
        txt = txt.replace("input-power = 0.5", f"input-power = {power}")
    for name in ("argon_channel_coupled", "argon_torch_axisym_ml",
                 "argon_torch_axisym", "lte_torch_axisym",
                 "forced_channel3d"):
        txt = txt.replace(f"outdirBase = output/{name}",
                          f"outdirBase = {outdir}")
    txt = txt.replace("maxIters = 200", f"maxIters = {steps}")
    txt = txt.replace("maxIters = 1000", f"maxIters = {steps}")
    txt = txt.replace("maxIters = 100\n", f"maxIters = {steps}\n")
    txt = txt.replace("outdirBase = output/lomach_reacting",
                      f"outdirBase = {outdir}")
    txt = txt.replace("examples/cases/",
                      os.path.join(REPO, "examples", "cases", ""))
    txt = txt.replace("tps_torch/tools/lte_argon",
                      os.path.join(REPO, "tps_torch", "tools", "lte_argon"))
    txt = txt.replace("outdirBase = output/torch", f"outdirBase = {outdir}")
    if plain:
        txt = txt.replace("type = cycle-avg-joule-coupled", "type = loMach")
    return txt


def make(tps, argv, path):
    tps.parse_command_line_args(["tps", "--runFile", path] + argv)
    tps.parse_input()
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    return tps.solver


def parts(s):
    """The (thermo, flow) pair of a low-Mach or coupled solver."""
    flow = getattr(s, "flow", s)
    if hasattr(flow, "flow") and hasattr(flow, "thermo"):
        return flow.thermo, flow.flow
    return s.thermo, s.flow


def fields(s, np_of):
    if hasattr(s, "mixture") and hasattr(s, "U"):  # a compressible flow
        Up = np_of(s.mixture.primitives(s.U))
        return Up[..., 1:1 + s.mixture.nvel], Up[..., s.mixture.i_th], 0.0
    if hasattr(getattr(s, "flow", None), "mixture"):  # compressible
        mix = s.flow.mixture
        Up = np_of(mix.primitives(s.flow.U))
        # the electrons' T on a mixture, the LTE fluid's own
        return (Up[..., 1:1 + mix.nvel],
                Up[..., getattr(mix, "i_te", mix.i_th)],
                s.em.total_joule_heating())
    th, fl = parts(s)
    if hasattr(s, "em"):
        return np_of(fl.u), np_of(th.T), s.em.total_joule_heating()
    if hasattr(th, "Y"):
        return np_of(fl.u), np_of(th.T), float(np_of(th.Y)[:, 0].max())
    return np_of(fl.u), np_of(th.T), 0.0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--every", type=int, default=5)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--plain-lomach", action="store_true")
    ap.add_argument("--deck", default="torch", choices=tuple(DECKS))
    ap.add_argument("--against-f64", action="store_true")
    ap.add_argument("--jax-only", action="store_true")
    # the channel deck's dt_fixed and input-power
    ap.add_argument("--dt", type=float)
    ap.add_argument("--power", type=float)
    # the child of --against-f64: the JAX package alone, its u and T at
    # each reported step saved to this .npz
    ap.add_argument("--dump", help=argparse.SUPPRESS)
    a = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    out = tempfile.mkdtemp(prefix="torch_deck_")
    ref = None
    if a.against_f64:
        path = os.path.join(out, "f64.npz")
        subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--deck", a.deck,
             "--steps", str(a.steps), "--every", str(a.every), "--dump",
             path] + (["--plain-lomach"] if a.plain_lomach else [])
            + sum((["--" + k, str(v)] for k, v in (("dt", a.dt),
                                                    ("power", a.power))
                   if v is not None), []),
            check=True)
        ref = np.load(path)
    import jax

    jax.config.update("jax_enable_x64", not a.f32)
    import torch

    torch.set_default_dtype(torch.float32 if a.f32 else torch.float64)
    from tps_torch import harness
    from tps_tpu import harness as jharness

    runs, saved = {}, {}
    packages = [("jax", jharness, [])]
    if not (a.dump or a.jax_only):
        packages.append(("torch", harness, ["--device", a.device]))
    for name, mod, argv in packages:
        path = os.path.join(out, f"{name}.ini")
        with open(path, "w") as f:
            f.write(deck_text(a.deck, a.steps, a.plain_lomach,
                              os.path.join(out, name), a.dt, a.power))
        t0 = time.perf_counter()
        runs[name] = make(mod.Tps(), argv, path)
        print(f"{name}: set up in {time.perf_counter() - t0:.1f} s",
              flush=True)
    np_of = {"jax": lambda v: np.asarray(v, np.float64),
             "torch": lambda v: v.detach().double().cpu().numpy()}
    print(f"{'f32' if a.f32 else 'f64'}, "
          f"{'plain loMach' if a.plain_lomach else a.deck}; per package:"
          f" step, max|u| m/s, peak T K, total Joule W (reacting: max "
          f"Y(Ar+)); then |du|, |dT| "
          f"over the JAX package's max", flush=True)
    t0 = time.perf_counter()
    for step in range(1, a.steps + 1):
        for name in list(runs):
            try:
                runs[name].solve_step()
            except FloatingPointError as exc:
                print(f"{name}: stopped at step {step}: {exc}", flush=True)
                del runs[name]
        if not runs:
            break
        if step % a.every and step != a.steps:
            continue
        got = {k: fields(s, np_of[k]) for k, s in runs.items()}
        line = [f"step {step:4d} ({time.perf_counter() - t0:7.1f} s)"]
        for name, (u, T, q) in got.items():
            line.append(f"{name} {np.abs(u).max():.6e} {T.max():.6e} "
                        f"{q:.6e}")
        if len(got) == 2:
            line.append(dist(got["torch"], got["jax"]))
        if ref is not None and f"u{step}" in ref:
            for name, f in got.items():
                line.append(f"{name} vs JAX f64 " + dist(
                    f, (ref[f"u{step}"], ref[f"T{step}"])))
        if a.dump:
            saved[f"u{step}"], saved[f"T{step}"] = got["jax"][:2]
        print(" | ".join(line), flush=True)
        for name, (u, T, _) in got.items():
            if not (np.isfinite(u).all() and np.isfinite(T).all()):
                print(f"{name}: non-finite at step {step}", flush=True)
                del runs[name]
    if a.dump:
        np.savez(a.dump, **saved)


def dist(f, g):
    """|du|, |dT| of field set f from g, over g's max."""
    (u, T), (ug, Tg) = f[:2], g[:2]
    return (f"|du| {np.abs(u - ug).max() / np.abs(ug).max():.2e} "
            f"|dT| {np.abs(T - Tg).max() / np.abs(Tg).max():.2e}")


if __name__ == "__main__":
    main()
