"""max|u| of examples/cases/torch_axisym_coupled.ini as shipped, step by
step, in the JAX package and in tps_torch side by side: a diagnostic
of the deck's growth, run as a script.  It holds no test function, so
pytest collects nothing from it.

Both packages build the deck through their harness (`Tps`) and advance
it one `solve_step` at a time, the per-step loop of the coupled solver
(an EM solve every `solve-em-every-n` steps, then the flow step).  Every
--every steps it prints, for each package, max|u|, the peak T and the
total Joule heating of the last EM solve, and the distance between the
two packages' u and T relative to the JAX package's max.  The JAX package
runs on its CPU backend; tps_torch on --device (cpu unless asked).  A
package that stops (the port's solve-convergence guard raises) or goes
non-finite is reported and dropped; the other carries on.

    python tests/test_torch_deck_growth.py             # f64, 40 steps
    python tests/test_torch_deck_growth.py --f32 --steps 50
    python tests/test_torch_deck_growth.py --plain-lomach   # no Joule

--plain-lomach runs the same deck as a plain `loMach` run (solver/type
loMach: the flow alone, no Joule heating).
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DECK = os.path.join(REPO, "examples", "cases", "torch_axisym_coupled.ini")


def deck_text(steps, plain, outdir):
    with open(DECK) as f:
        txt = f.read()
    txt = txt.replace("maxIters = 1000", f"maxIters = {steps}")
    txt = txt.replace("examples/cases/",
                      os.path.join(REPO, "examples", "cases", ""))
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


def fields(s, np_of):
    flow = getattr(s, "flow", s)
    if hasattr(flow, "flow") and hasattr(flow, "thermo"):
        th, fl = flow.thermo, flow.flow
    else:
        th, fl = s.thermo, s.flow
    joule = s.em.total_joule_heating() if hasattr(s, "em") else 0.0
    return np_of(fl.u), np_of(th.T), joule


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--every", type=int, default=5)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--plain-lomach", action="store_true")
    a = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_enable_x64", not a.f32)
    import torch

    torch.set_default_dtype(torch.float32 if a.f32 else torch.float64)
    from tps_torch import harness
    from tps_tpu import harness as jharness

    out = tempfile.mkdtemp(prefix="torch_deck_")
    runs = {}
    for name, mod, argv in (("jax", jharness, []),
                            ("torch", harness, ["--device", a.device])):
        path = os.path.join(out, f"{name}.ini")
        with open(path, "w") as f:
            f.write(deck_text(a.steps, a.plain_lomach,
                              os.path.join(out, name)))
        t0 = time.perf_counter()
        runs[name] = make(mod.Tps(), argv, path)
        print(f"{name}: set up in {time.perf_counter() - t0:.1f} s",
              flush=True)
    np_of = {"jax": lambda v: np.asarray(v, np.float64),
             "torch": lambda v: v.detach().double().cpu().numpy()}
    print(f"{'f32' if a.f32 else 'f64'}, "
          f"{'plain loMach' if a.plain_lomach else 'coupled'}; per package:"
          f" step, max|u| m/s, peak T K, total Joule W; then |du|, |dT| "
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
            (uj, Tj, _), (ut, Tt, _) = got["jax"], got["torch"]
            line.append(
                f"|du| {np.abs(ut - uj).max() / np.abs(uj).max():.2e} "
                f"|dT| {np.abs(Tt - Tj).max() / np.abs(Tj).max():.2e}")
        print(" | ".join(line), flush=True)
        for name, (u, T, _) in got.items():
            if not (np.isfinite(u).all() and np.isfinite(T).all()):
                print(f"{name}: non-finite at step {step}", flush=True)
                del runs[name]


if __name__ == "__main__":
    main()
