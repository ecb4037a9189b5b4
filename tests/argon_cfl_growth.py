"""T_e noise growth per step on bench.py::bench_argon_big's deck, in the
JAX package or in tps_torch, on the CPU.  Not a test (pytest does not
collect it): a diagnostic of the electron-energy diffusion limit.

The deck is the shipped argon plasma at 32x32 p=2 GL (bench.py:450-461)
at the cfl given.  The uniform initial state gets a relative noise of
--noise (numpy, seed 0), the same in both packages; each step prints dt,
max|T_e - median T_e| and its growth over the step.  At the start it
prints the electron thermal conductivity of the deck's uniform state in
the run's dtype.

    python tests/argon_cfl_growth.py --package jax --cfl 0.02 --f64
    python tests/argon_cfl_growth.py --package torch --cfl 0.02 --f64
    python tests/argon_cfl_growth.py --package jax --slot --noise 1e-6
    python tests/argon_cfl_growth.py --package torch --kappa-e 0.66

--slot runs the JAX package's slot path (it takes its fused roll path on
this deck otherwise); --kappa-e scales tps_torch's third-order electron
conductivity.
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DECK = os.path.join(REPO, "examples", "cases", "argon_plasma_2d.ini")


def deck_text(cfl, outdir):
    with open(DECK) as f:
        txt = f.read()
    txt = txt.replace("nx = 6", "nx = 32").replace("ny = 6", "ny = 32")
    txt = txt.replace("order = 1", "order = 2")
    txt = txt.replace("outputFreq = 100",
                      "outputFreq = 100000\ntimingFreq = 100000\n"
                      "basisType = 0\nintegrationRule = 0")
    txt = txt.replace("cfl = 0.1", f"cfl = {cfl}")
    return txt.replace("outdirBase = /tmp/tps_tpu_argon_output",
                       f"outdirBase = {outdir}")


def jax_solver(text, f64, slot):
    import jax

    jax.config.update("jax_enable_x64", f64)
    sys.path.insert(0, REPO)
    import bench
    import tps_tpu.solvers.compressible  # noqa: F401

    if slot:
        import tps_tpu.dg.fused as fused

        fused.maybe_build_fused = lambda *a, **k: None
    s = bench._make_solver(text)

    def prim():
        return np.asarray(s.mixture.primitives(s.U), np.float64)

    def kappa_e(U):
        import jax.numpy as jnp

        U = jnp.asarray(U[:1, :1], s.U.dtype)
        G = jnp.zeros(U.shape + (2,), U.dtype)
        p = s.ctx.fluxes.transport.flux_properties(
            s.mixture, U, s.mixture.primitives(U), G)
        return float(np.asarray(p["kappa_e"]).ravel()[0])

    return s, prim, kappa_e, f"fused path {s._fused is not None}"


def torch_solver(path, f64, kappa_e_factor):
    import torch

    sys.path.insert(0, REPO)
    from tps_torch import harness
    from tps_torch.physics import gas_transport

    torch.set_default_dtype(torch.float64 if f64 else torch.float32)
    if kappa_e_factor != 1.0:
        third = gas_transport.ArgonMinimalTransport._third_order_ke
        gas_transport.ArgonMinimalTransport._third_order_ke = (
            lambda self, *a: kappa_e_factor * third(self, *a))
    tps = harness.Tps()
    tps.parse_command_line_args(["tps", "--runFile", path, "--device", "cpu"])
    tps.parse_input()
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    s = tps.solver

    def prim():
        return s.mixture.primitives(s.U).double().numpy()

    def kappa_e(U):
        U = torch.as_tensor(U[:1, :1], dtype=s.U.dtype)
        G = torch.zeros(U.shape + (2,), dtype=U.dtype)
        p = s.ctx.fluxes.transport.flux_properties(
            s.mixture, U, s.mixture.primitives(U), G)
        return float(p["kappa_e"].ravel()[0])

    return s, prim, kappa_e, type(s._rhs).__name__


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--cfl", type=float, default=0.02)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--noise", type=float, default=1e-6)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--slot", action="store_true")
    ap.add_argument("--kappa-e", type=float, default=1.0)
    a = ap.parse_args()
    out = tempfile.mkdtemp(prefix="argon_cfl_")
    text = deck_text(a.cfl, out)
    if a.package == "jax":
        s, prim, kappa_e, path = jax_solver(text, a.f64, a.slot)
    else:
        deck = os.path.join(out, "deck.ini")
        with open(deck, "w") as f:
            f.write(text)
        s, prim, kappa_e, path = torch_solver(deck, a.f64, a.kappa_e)
    U0 = np.array(s.state_global(), np.float64, copy=True)
    rng = np.random.default_rng(0)
    s.set_state_global(U0 * (1 + a.noise * rng.standard_normal(U0.shape)))
    print(f"{a.package} ({path}), {'f64' if a.f64 else 'f32'}, cfl {a.cfl}, "
          f"noise {a.noise}: kappa_e of the uniform state "
          f"{kappa_e(U0):.6e}", flush=True)
    prev = None
    for k in range(a.steps):
        t0 = time.perf_counter()
        s.solve_chunk(1)
        te = prim()[..., 5]
        dev = float(np.max(np.abs(te - np.median(te))))
        growth = dev / prev if prev else float("nan")
        prev = dev
        print(f"step {k + 1}: dt {float(s.dt):.6e}, max|T_e - median| "
              f"{dev:.6e} K, growth {growth:.3f} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if not np.isfinite(dev):
            break


if __name__ == "__main__":
    main()
