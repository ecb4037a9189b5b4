"""The face-sweep prototype on the GPU: the CUDA kernel in prototype mode
against the prototype's own chain.

    python -m tps_torch.tools.face_prototype [--device cuda|cpu] [--repeat N]

The port of tools/pallas_face_prototype.py's entry point: the same 16^3
p=2 Gauss-Legendre periodic box, the same state (np.random.RandomState(0)
and the prototype's recipe, f32), the same Btr, nor_slot[0] and
wts_slot[0].  It runs dg/cuda_faces.py's kernel in prototype mode (Euler,
per-side |u.n| + c|n| Rusanov, +sum, no inverse mass) and its plain
version `prototype_chain_plain` (the prototype's XLA chain), prints their
relative difference against the prototype's bar of 1e-5 and, on CUDA,
the ms of each by CUDA events.  --device cuda (the default) needs a CUDA
GPU and raises without one; --device cpu runs the plain version twice (the
wrapper takes it for CPU tensors) and times nothing.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..dg import cuda_faces
from ..dg.discretization import build_tables
from ..mesh.generators import box_3d

N, P, GAM = 16, 2, 1.4
BAR = 1e-5  # tools/pallas_face_prototype.py:186


def prototype_state(ne, ndof):
    """The prototype's conserved state [ne, ndof, 5] in f32
    (tools/pallas_face_prototype.py:44-52)."""
    rng = np.random.RandomState(0)
    Up = np.zeros((ne, ndof, 5), np.float32)
    Up[..., 0] = 1.0 + 0.1 * rng.rand(ne, ndof)
    Up[..., 1:4] = 0.3 * rng.randn(ne, ndof, 3)
    Up[..., 4] = 10.0 + rng.rand(ne, ndof)
    U = np.array(Up)
    U[..., 4] = Up[..., 4] / (GAM - 1) + 0.5 * (Up[..., 1:4] ** 2).sum(-1) / Up[..., 0]
    U[..., 1:4] *= Up[..., 0:1]
    return U


def cuda_ms(fn, n):
    """Mean ms per call of fn over n calls, by CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def run(device="cuda", repeat=50, tab=None):
    """Build the case, compare kernel and plain version, time both on CUDA.
    Returns {"rel_err", "max_abs", "ms", "plain_ms", "launches", "tab"}."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda (the default) requested but CUDA is "
                           "not available; pass --device cpu")
    if tab is None:
        tab = build_tables(box_3d(N, N, N, periodic=(True, True, True)), P)
    sweep = cuda_faces.build_prototype_sweep(tab, torch.float32, device, GAM)
    U = torch.as_tensor(prototype_state(tab.ne, tab.ndof), device=device)
    cuda_faces.reset_launches()
    z_kernel = sweep(U)
    launched = cuda_faces.launches["face_sweep"]
    z_plain = sweep.plain(U)
    err = float(torch.max(torch.abs(z_kernel - z_plain))
                / torch.max(torch.abs(z_plain)))
    out = {"rel_err": err,
           "max_abs": float(torch.max(torch.abs(z_kernel - z_plain))),
           "ms": None, "plain_ms": None, "launches": launched, "tab": tab}
    if device.type == "cuda":
        # in turns plain, kernel, kernel, plain
        t = [cuda_ms(lambda: sweep.plain(U), repeat), cuda_ms(lambda: sweep(U), repeat),
             cuda_ms(lambda: sweep(U), repeat), cuda_ms(lambda: sweep.plain(U), repeat)]
        out["ms"], out["plain_ms"] = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m tps_torch.tools.face_prototype")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--repeat", type=int, default=50,
                    help="calls per CUDA-event timing")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    res = run(args.device, args.repeat)
    print(f"{N}^3 p={P} GL Euler f32 on {args.device}: rel err kernel vs "
          f"prototype chain: {res['rel_err']:.3e} (bar {BAR})")
    if res["ms"] is not None:
        print(f"face sweep: kernel {res['ms']:.4f} ms, plain "
              f"{res['plain_ms']:.4f} ms")
    if not res["rel_err"] < BAR:
        raise SystemExit("INCORRECT")
    print("CORRECT")
    return res


if __name__ == "__main__":
    main()
