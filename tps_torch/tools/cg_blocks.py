"""The low-Mach step for several CG block lengths, on the GPU.

    python -m tps_torch.tools.cg_blocks [--steps 8] [--blocks 1,2,4]

A CG solve of the low-Mach step runs in blocks of k masked iterations
(fem/h1.py, CG_BLOCK), and the step loop reads a solve's done flag
between blocks (solvers/lomach/step_graph.py): a longer block costs fewer
reads and more iterations past convergence.  For each case (f64; the TGV
deck tests/inputs/lomach_tgv2d.ini at 64x64 p=3, the 3-D channel
tps_torch/tools/heated_channel3d.ini, the shipped
examples/cases/channel_rans.ini) this prints ms per step through solve()
with the step graph, host clock to a synchronize, in turns over the block
lengths and back (1, 2, 4, 4, 2, 1), `steps` steps a turn after a
recapture, with the host reads and CG iterations a step, and the card's
name and power limit.  Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from .. import harness
from ..fem import h1

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CASES = {
    "TGV 64x64 p=3": (os.path.join(REPO, "tests", "inputs",
                                   "lomach_tgv2d.ini"),
                      {"mesh/nx": "64", "mesh/ny": "64"}),
    "3-D channel 24x12x12 p=2": (os.path.join(
        REPO, "tps_torch", "tools", "heated_channel3d.ini"), {}),
    "channel_rans.ini": (os.path.join(REPO, "examples", "cases",
                                      "channel_rans.ini"), {}),
}


def solver(deck, keys, outdir):
    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", deck])
    tps.parse_input()
    tps.config.outdir = outdir
    for k, v in keys.items():
        tps.config.raw.values[k] = v
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    s = tps.solver
    s.output_freq = 10**9
    s.write_restart = lambda: None
    return s


def turn(s, block, steps):
    """`steps` graph steps with CG blocks of `block` iterations, after a
    fresh capture: (ms a step, host reads a step, iterations a step)."""
    h1.CG_BLOCK = block
    s._graphs.clear()
    s._warm.clear()
    s.loops.blocks.clear()
    s.max_iters_cfg = s.iter + 3  # the warm-up step, the capture, one more
    s.solve()
    s.max_iters_cfg = s.iter + steps
    r0 = s.loops.reads + s.info_reads
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.solve()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = s.info_log[-steps:]
    its = sum(v for r in rows for k, v in r.items() if k.endswith("_iters"))
    return ms, (s.loops.reads + s.info_reads - r0) / steps, its / steps


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cg_blocks")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--blocks", default="1,2,4")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("cg_blocks: needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    print(f"card: {smi[0] if smi else torch.cuda.get_device_name(0)}")
    torch.set_default_dtype(torch.float64)
    blocks = [int(b) for b in args.blocks.split(",")]
    order = blocks + blocks[::-1]
    outdir = os.path.join(REPO, "build", "cg_blocks")
    out = {}
    for name, (deck, keys) in CASES.items():
        s = solver(deck, keys, outdir)
        s.max_iters_cfg = 2
        s.solve()  # the BDF ramp
        res = {b: [] for b in blocks}
        for b in order:
            res[b].append(turn(s, b, args.steps))
        out[name] = {
            str(b): {"ms_per_step": [r[0] for r in v],
                     "reads_per_step": float(np.mean([r[1] for r in v])),
                     "iterations_per_step": float(np.mean([r[2] for r in v]))}
            for b, v in res.items()}
        print(f"{name} ({s.tab.ndofs} dofs, f64): " + "; ".join(
            f"k={b}: ms/step {v['ms_per_step']}, reads/step "
            f"{v['reads_per_step']:.2f}, CG iterations/step "
            f"{v['iterations_per_step']:.2f}"
            for b, v in out[name].items()), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
