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

Not here: the other forcings of the JAX module (ConstantPressureGradient,
HeatSource, SpongeZone, PassiveScalar, the MMS forcing), ROADMAP A5.4.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


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
