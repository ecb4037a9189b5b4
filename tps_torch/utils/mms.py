"""Manufactured-solution (MMS) verification utilities, on torch tensors.

The JAX package's utils/mms.py, the role of the reference's MASA handlers
and compute_rhs utility (reference: src/masa_handler.cpp,
utils/compute_rhs.cpp, used by test/mms.euler_2d.test:28-52): project an
exact solution, evaluate the discrete RHS and report the L2 error against
the exact time derivative (torch.func.jacfwd in place of jax.jacfwd).
"""

from __future__ import annotations

import numpy as np
import torch


def l2_norm(tab, field):
    """Quadrature L2 norm of a dof field [ne, ndof(, k)]."""
    fq = torch.einsum("qd,nd...->nq...", tab.Bvol, field)
    w = tab.wq[None, :] * tab.detJ
    if fq.ndim == 3:
        w = w[..., None]
    return torch.sqrt(torch.sum(w * fq * fq))


def rhs_error(ctx, tab, exact_primitive_fn, t=0.0):
    """L2 error of the discrete RHS vs the exact dU/dt at time t:
    (error, per-equation errors), the quantity bracketed by the
    reference's mms.euler_2d test."""
    from ..dg.rhs import compute_rhs

    mix = ctx.fluxes.mixture

    def exact_U(tt):
        return mix.conservatives(exact_primitive_fn(tab.xyz_dof, tt))

    xyz = tab.xyz_dof
    t = torch.as_tensor(t, dtype=xyz.dtype, device=xyz.device)
    y, _ = compute_rhs(ctx, tab, exact_U(t), t)
    err = y - torch.func.jacfwd(exact_U)(t)
    per_eq = torch.stack([l2_norm(tab, err[..., k])
                          for k in range(err.shape[-1])])
    return l2_norm(tab, err), per_eq


def solution_error(tab, mix, U, exact_primitive_fn, t):
    """L2 error of the solution vs the exact state (checkSolutionError
    analog, reference: src/M2ulPhyS.hpp:361-366)."""
    Uex = mix.conservatives(exact_primitive_fn(tab.xyz_dof, t))
    return l2_norm(tab, U - Uex)


def primitive_errors(tab, mix, U, exact_primitive_fn, t):
    """L2 errors of density, velocity (all components together) and
    pressure vs the exact fields at time t, as floats (the fields the
    reference's 3-D MMS test brackets the rates of,
    test/mms.euler.test:43-96)."""
    Up = mix.primitives(U)
    Upex = exact_primitive_fn(tab.xyz_dof, t)
    vel = slice(1, 1 + mix.nvel)
    rho = l2_norm(tab, Up[..., 0] - Upex[..., 0])
    u = torch.sqrt(sum(l2_norm(tab, Up[..., k] - Upex[..., k]) ** 2
                       for k in range(vel.start, vel.stop)))
    p = l2_norm(tab, mix.pressure_from_primitives(Up)
                - mix.pressure_from_primitives(Upex))
    return float(rho), float(u), float(p)


def convergence_study(make_ctx_tab, exact_primitive_fn, resolutions):
    """RHS-error convergence sweep (the runP*.sh role). Returns
    [(n, error)] and observed orders."""
    results = []
    for n in resolutions:
        ctx, tab = make_ctx_tab(n)
        err, _ = rhs_error(ctx, tab, exact_primitive_fn)
        results.append((n, float(err)))
    orders = [
        np.log(results[i - 1][1] / results[i][1])
        / np.log(results[i][0] / results[i - 1][0])
        for i in range(1, len(results))
    ]
    return results, orders
