"""Pointwise forcings of the compressible DG right-hand side, on torch
tensors.

The JAX package's dg/forcing.py.  JouleHeating (tps_tpu/dg/forcing.py:
275-293; reference: src/forcing_terms.cpp:443-472): the EM Joule heating
q >= 0 added to the total energy and, for a two-temperature mixture, to
the electron energy.  The JAX package reads q from the RHS's `fields`
dict; here q is a device tensor [ne, ndof] that the coupling fills with
`copy_` (solvers/compressible.py::set_joule_heating), so a captured step
graph reads every EM update.  Until the coupling sets it, q is 0 and the
forcing adds nothing, as the JAX package's does without the field.

AxisymmetricSource (tps_tpu/dg/forcing.py:210-249; reference:
src/forcing_terms.cpp:255-380): the geometric source of the (r, z) +
swirl formulation.  Its nodal radius, clamped at 1e-14 as in the JAX
package (Gauss-Legendre nodes lie off the axis), is a per-table constant
made once on the device (dg/operators.py::_const), so a captured step
copies nothing from the host.

Not here: the other forcings of the JAX module (ConstantPressureGradient,
HeatSource, SpongeZone, PassiveScalar, the MMS forcing), ROADMAP A5.4.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .operators import _const


@dataclass(frozen=True, eq=False)
class JouleHeating:
    mixture: object
    heating: torch.Tensor  # [ne, ndof], updated in place

    def __call__(self, t, tab, U, Up, grad_up, fields=None):
        mix = self.mixture
        q = torch.clamp(self.heating, min=0.0)
        zero = torch.zeros_like(q)
        cols = [zero] * mix.num_equations
        cols[mix.i_th] = q
        if mix.two_temperature:
            cols[mix.i_te] = q
        return torch.stack(cols, dim=-1)


@dataclass(frozen=True, eq=False)
class AxisymmetricSource:
    """Geometric source terms of the axisymmetric (r, z) + swirl state:
       d(rho u_r)/dt     += (p + rho u_t^2 - tau_tt) / r
       d(rho u_theta)/dt += (-rho u_r u_theta + tau_tr) / r
    with tau_tt = 2 mu u_r/r + (mu_b - 2/3 mu) div(u) and
    tau_tr = mu (du_t/dr - u_t/r); the viscous parts on Navier-Stokes."""

    mixture: object
    fluxes: object  # its transport gives the viscous parts

    def __call__(self, t, tab, U, Up, grad_up, fields=None):
        mix = self.mixture
        r = _const(tab, ("axi_radius",), U,
                   lambda: torch.clamp(tab.xyz_dof[..., 0], min=1e-14))
        rho, ur, ut = Up[..., 0], Up[..., 1], Up[..., 3]
        p = mix.pressure_from_primitives(Up)
        src_r = p + rho * ut * ut
        src_t = -rho * ur * ut
        fl = self.fluxes
        if fl is not None and fl.eq_system != "euler" and grad_up is not None:
            props = fl.transport.flux_properties(mix, U, Up, grad_up)
            visc = props["visc"]
            bulk = props["bulk_visc"] - (2.0 / 3.0) * visc
            div_v = grad_up[..., 1, 0] + grad_up[..., 2, 1] + ur / r
            src_r = src_r - (2.0 * visc * ur / r + bulk * div_v)
            src_t = src_t + visc * (grad_up[..., 3, 0] - ut / r)
        zero = torch.zeros_like(p)
        cols = [zero] * mix.num_equations
        cols[1] = src_r / r
        cols[3] = src_t / r
        return torch.stack(cols, dim=-1)
