"""Radiation models.

The port of the JAX package's physics/radiation.py.  NetEmission: the
optically-thin net-emission-coefficient energy sink from a 1-D table in
heavy temperature (reference: src/radiation.hpp:57-70):
  S_rad(T) = -4 pi * NEC(T)  added to the energy equation.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..constants import PI


@dataclass(frozen=True, eq=False)
class NetEmission:
    nec_table: object  # tables.LinearTable of NEC(T)

    def energy_sink(self, Th):
        return -4.0 * PI * self.nec_table(Th)
