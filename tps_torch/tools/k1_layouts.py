"""K1 on two layouts of its compressed folds, on the GPU.

    python -m tps_torch.tools.k1_layouts

The layouts: the rows grouped by shared columns (`gradient_groups`, what
the solver uses: at p=2 a group is a line of 3 rows over 9 columns) and
one row a group, a per-row ELL (each output row's kept (slot, node,
value) entries, padded to the widest row).  Both run the same kernel,
csrc/fused_rhs.cu::k1_gradient, with R = 3 and R = 1 rows a group.  For
the 16^3 and 32^3 p=2 Navier-Stokes boxes in f32 and f64 it prints each
layout's ms per call on the device (torch.profiler, 50 calls) and by
CUDA events (50 calls, host included), in turns grouped, per row, per
row, grouped, and the largest difference of G between the layouts
relative to max|G|.  Needs a CUDA GPU and nvcc.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess

import numpy as np
import torch

from ..dg.cuda_fused import build_cuda_fused, gradient_groups, kernel_folds
from ..dg.discretization import build_tables
from ..dg.fluxes import Fluxes
from ..dg.rhs import RHSContext
from ..dg.riemann import Rusanov
from ..mesh.generators import box_3d
from ..physics.gas import DryAir
from ..physics.transport import DryAirTransport
from .face_prototype import cuda_ms


def per_row_layout(Wgrad):
    """The compressed folds one output row a group: rows [nrow, 1], cols
    [nrow, M], vals [nrow, M, 1], with gradient_groups' cut and column
    order (slot, node)."""
    keep = gradient_groups(Wgrad)["keep"]
    W = np.asarray(Wgrad, dtype=np.float64)
    nslot, nrow, ndof = W.shape
    K = keep.transpose(1, 0, 2).reshape(nrow, nslot * ndof)
    M = int(K.sum(1).max())
    rows = np.arange(nrow, dtype=np.int32)[:, None]
    cols = np.zeros((nrow, M), np.int32)
    vals = np.zeros((nrow, M, 1))
    for r in range(nrow):
        s, k = np.divmod(np.flatnonzero(K[r]), ndof)
        cols[r, :len(s)] = (s << 16) | k
        vals[r, :len(s), 0] = W[s, r, k]
    return rows, cols, vals


def device_ms(fn, name, n=50):
    """ms per call on the device of the kernels named `name` that fn
    launches (torch.profiler over n calls); None where no such kernel was
    recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name)
    return us / 1e3 / n if us > 0 else None


def context():
    mix = DryAir(dim=3, nvel=3)
    tr = DryAirTransport(mix.gas_constant, mix.specific_heat_ratio)
    fl = Fluxes(mixture=mix, transport=tr, eq_system="navier-stokes")
    return RHSContext(fluxes=fl, riemann=Rusanov(fl), bcs=())


def state(mix, ne, ndof, dtype, device):
    """A varying state from a seed: rho ~1.2, velocity ~10, T ~300."""
    rng = np.random.RandomState(0)
    Up = np.empty((ne, ndof, 5))
    Up[..., 0] = 1.2 + 0.1 * rng.rand(ne, ndof)
    Up[..., 1:4] = 10.0 * rng.randn(ne, ndof, 3)
    Up[..., 4] = 300.0 + 20.0 * rng.rand(ne, ndof)
    return mix.conservatives(torch.as_tensor(Up)).to(dtype=dtype, device=device)


def run(device="cuda"):
    device = torch.device(device)
    ctx = context()
    out = {}
    for n in (16, 32):
        tab = build_tables(box_3d(n, n, n, periodic=(True, True, True)), 2)
        rows, cols, vals = per_row_layout(kernel_folds(tab)["Wgrad"])
        for dtype in (torch.float32, torch.float64):
            grouped = build_cuda_fused(tab, ctx, dtype, device)
            per_row = dataclasses.replace(
                grouped,
                k1_rows=torch.as_tensor(rows, device=device),
                k1_cols=torch.as_tensor(cols, device=device),
                k1_vals=torch.as_tensor(vals, dtype=dtype, device=device))
            U = state(ctx.mixture, tab.ne, tab.ndof, dtype, device).contiguous()
            runs = {"grouped": lambda: grouped.gradient(U),
                    "per_row": lambda: per_row.gradient(U)}
            dev = {"grouped": [], "per_row": []}
            ev = {"grouped": [], "per_row": []}
            for which in ("grouped", "per_row", "per_row", "grouped"):
                dev[which].append(device_ms(runs[which], "k1_gradient"))
                ev[which].append(cuda_ms(runs[which], 50))
            Gg, Gr = runs["grouped"](), runs["per_row"]()
            rel = float(torch.max(torch.abs(Gg - Gr)) / torch.max(torch.abs(Gg)))
            key = f"{n}^3 p=2 {str(dtype)[6:]}"
            out[key] = {"device_ms": dev, "events_ms": ev,
                        "shapes": {"grouped": list(grouped.k1_vals.shape),
                                   "per_row": list(vals.shape)},
                        "G_rel_diff": rel}
            print(key, json.dumps(out[key]), flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k1_layouts: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(json.dumps(run()), flush=True)


if __name__ == "__main__":
    main()
