"""Restarted GMRES with iteration counting and mixed-precision cycles.

The port of the JAX package's fem/krylov.py (`gmres_solve`): textbook
right-preconditioned GMRES(m) with modified Gram-Schmidt (one
reorthogonalization pass) and Givens rotations.

- **The monitored residual is the true residual.**  Every restart
  recomputes r = b - A x in the outer dtype, so the reported relres is
  meaningful whatever the preconditioner or the inner precision, and a
  stalled solve is cut off by `stall_factor` instead of burning maxiter.
- **Iterative refinement (GMRES-IR).**  `cycle_dtype`/`cycle_apply`/
  `cycle_M` run the Arnoldi cycles in f32 while the outer residual and
  solution updates stay in the caller's dtype: each cycle solves
  A d = r/||r|| in the cycle precision and applies x += ||r|| d in the
  outer precision.

The outer loop runs on the host with one read a restart cycle (the true
residual, the cycle's Arnoldi steps and the loop's condition, computed on
the device in the dtype as the JAX package's `lax.while_loop` does).  A
cycle is `restart` masked Arnoldi steps: once the residual estimate of
the cycle meets its target, or the cycle is full, every later step leaves
the basis, the rotated Hessenberg, the rotations and the step count as
they are (a `torch.where` on a device flag), so the cycle ends where the
JAX package's inner `lax.while_loop` stops and the iteration count
(Arnoldi steps summed over cycles) is the same.
"""

from __future__ import annotations

import torch


def _tiny(dtype):
    """The divide guard of the JAX package (1e-300 in f64, 1e-30 in f32)."""
    return 1e-300 if dtype == torch.float64 else 1e-30


def gmres_solve(apply_fn, b, M=None, tol=1e-8, atol=0.0,
                restart=30, maxiter=400,
                cycle_apply=None, cycle_M=None, cycle_dtype=None,
                stall_factor=0.95):
    """Solve A x = b with restarted right-preconditioned GMRES(-IR).

    Returns (x, iterations, relres): `iterations` (an int) counts
    Arnoldi steps summed over restart cycles; `relres` (a device scalar)
    is the true relative residual ||b - A x|| / ||b|| in the dtype of
    `b`.

    cycle_dtype (with cycle_apply/cycle_M in that dtype, or casts of the
    outer ones) runs the Arnoldi cycles in reduced precision with an
    outer-precision residual refresh at each restart.  stall_factor:
    stop when a cycle fails to shrink the true residual below
    stall_factor times the previous one."""
    if M is None:
        M = lambda x: x  # noqa: E731
    n = b.shape[0]
    dtype = b.dtype
    dev = b.device
    cdtype = dtype if cycle_dtype is None else cycle_dtype
    if cycle_apply is None:
        cycle_apply = (apply_fn if cdtype == dtype else
                       (lambda v: apply_fn(v.to(dtype)).to(cdtype)))
    if cycle_M is None:
        cycle_M = (M if cdtype == dtype else
                   (lambda v: M(v.to(dtype)).to(cdtype)))
    m = int(restart)
    x = torch.zeros_like(b)

    bnorm = torch.sqrt(torch.sum(b * b))
    eps = float(torch.finfo(dtype).eps)
    ceps = float(torch.finfo(cdtype).eps)
    target = torch.clamp(max(float(tol), 10.0 * eps) * bnorm,
                         min=float(atol))
    tiny = _tiny(dtype)
    ctiny = _tiny(cdtype)
    ar_m = torch.arange(m, device=dev)
    ar_m1 = torch.arange(m + 1, device=dev)

    def arnoldi_cycle(x):
        """One GMRES(m) cycle from iterate x: (x_new, true residual norm
        of x_new, Arnoldi steps), all on the device."""
        r = b - apply_fn(x)
        beta = torch.sqrt(torch.sum(r * r))
        V = torch.zeros((m + 1, n), dtype=cdtype, device=dev)
        V[0] = (r / (beta + tiny)).to(cdtype)
        R = torch.zeros((m, m), dtype=cdtype, device=dev)
        g = torch.zeros(m + 1, dtype=cdtype, device=dev)
        g[0] = 1.0
        cs = torch.zeros(m, dtype=cdtype, device=dev)
        sn = torch.zeros(m, dtype=cdtype, device=dev)
        j = torch.zeros((), dtype=torch.int64, device=dev)
        # in-cycle exit on the residual estimate relative to this cycle's
        # start: down to the outer target, never below what the cycle
        # precision resolves
        inner_target = torch.clamp((target / (beta + tiny)).to(cdtype),
                                   min=5.0 * ceps)
        for jj in range(m):
            # while a step is active its index j equals jj
            active = torch.abs(g[jj]) > inner_target
            w = cycle_apply(cycle_M(V[jj]))
            live = (ar_m1 <= jj).to(cdtype)
            h = (V @ w) * live
            w = w - h @ V
            # one reorthogonalization pass
            h2 = (V @ w) * live
            w = w - h2 @ V
            h = h + h2
            hj1 = torch.sqrt(torch.sum(w * w))
            V[jj + 1] = torch.where(active, w / (hj1 + ctiny), V[jj + 1])

            # the previous Givens rotations on the new column
            col = torch.where(ar_m1 <= jj, h, torch.zeros_like(h))
            col[min(jj + 1, m)] = hj1
            for i in range(jj):
                a, bb = col[i].clone(), col[i + 1].clone()
                col[i] = cs[i] * a + sn[i] * bb
                col[i + 1] = -sn[i] * a + cs[i] * bb
            # the new rotation, eliminating the subdiagonal hj1
            a = col[jj].clone()
            denom = torch.sqrt(a * a + hj1 * hj1) + ctiny
            c, s = a / denom, hj1 / denom
            cs[jj] = torch.where(active, c, cs[jj])
            sn[jj] = torch.where(active, s, sn[jj])
            col[jj] = c * a + s * hj1
            R[:, jj] = torch.where(active, col[:m], R[:, jj])
            gj = g[jj].clone()
            g[jj] = torch.where(active, c * gj, gj)
            g[jj + 1] = torch.where(active, -s * gj, g[jj + 1])
            j = j + active.to(torch.int64)

        # back-substitute the leading j x j system (unit diagonal and zero
        # rhs on the unused tail: y[k >= j] = 0)
        used = ar_m < j
        Rm = torch.where(used[None, :] & used[:, None], R,
                         torch.zeros_like(R))
        Rm = Rm + torch.diag(torch.where(used, 0.0, 1.0).to(cdtype))
        rhs = torch.where(used, g[:m], torch.zeros_like(g[:m]))
        y = torch.linalg.solve_triangular(Rm, rhs[:, None], upper=True)[:, 0]
        dx = cycle_M(y @ V[:m]).to(dtype)
        x_new = x + beta * dx
        # the true residual of the new iterate, in the outer dtype
        r_new = b - apply_fn(x_new)
        return x_new, torch.sqrt(torch.sum(r_new * r_new)), j

    res = torch.full((), float("inf"), dtype=dtype, device=dev)
    iters, go = 0, True
    while go and iters < maxiter:
        x2, res2, j = arnoldi_cycle(x)
        # keep the better iterate (a failed reduced-precision cycle must
        # not destroy a converged solution)
        x = torch.where(res2 < res, x2, x)
        prev, res = res, torch.minimum(res2, res)
        go_dev = (res > target) & (res < stall_factor * prev)
        # one host read a cycle: its Arnoldi steps and the loop condition
        j_host, go_host = torch.stack(
            (j.to(torch.float64), go_dev.to(torch.float64))).tolist()
        iters += int(j_host)
        go = bool(go_host)
    return x, iters, res / torch.clamp(bnorm, min=tiny)
