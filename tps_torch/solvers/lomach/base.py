"""Low-Mach solver family: model interfaces and temporal coefficients.

The port of the JAX package's solvers/lomach/base.py.  The orchestrator
(solver.py) owns the mesh and H1 space and steps thermoChem -> flow ->
turbModel each time step, with BDF/EXT temporal coefficients shared by
all models (reference: src/loMach.hpp:76-264).

A model keeps its state in tensors that it updates in place (`copy_`),
never rebinds: a captured step graph (step_graph.py) reads and writes
those addresses.  `step(coeff, dt, loops)` runs one step; `loops` runs
its CG solves' blocks (fem/h1.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class TemporalCoefficients:
    """BDF-k implicit + EXT-k explicit extrapolation coefficients
    (reference: temporalSchemeCoefficients src/loMach.hpp:76-103)."""

    order: int = 1
    bd0: float = 1.0
    bd1: float = -1.0
    bd2: float = 0.0
    bd3: float = 0.0
    ab1: float = 1.0
    ab2: float = 0.0
    ab3: float = 0.0

    @classmethod
    def bdf(cls, order: int) -> "TemporalCoefficients":
        """Constant-dt coefficients, ramping order 1..3."""
        if order <= 1:
            return cls(1, 1.0, -1.0, 0.0, 0.0, 1.0, 0.0, 0.0)
        if order == 2:
            return cls(2, 1.5, -2.0, 0.5, 0.0, 2.0, -1.0, 0.0)
        return cls(3, 11.0 / 6.0, -3.0, 1.5, -1.0 / 3.0, 3.0, -3.0, 1.0)


def zeros(tab, *shape):
    """A zero field on the H1 space's device and dtype."""
    return torch.zeros(shape, dtype=tab.wq.dtype, device=tab.wq.device)


def full(tab, value, *shape):
    return torch.full(shape, float(value), dtype=tab.wq.dtype,
                      device=tab.wq.device)


def shift_history(hist, new):
    """hist = [new, hist[0], ...] in place (oldest copied first)."""
    for i in range(len(hist) - 1, 0, -1):
        hist[i].copy_(hist[i - 1])
    hist[0].copy_(new)


class FlowBase:
    """Velocity solver interface (reference: src/split_flow_base.hpp:71-151)."""

    def step(self, coeff: TemporalCoefficients, dt: float, loops=None):
        raise NotImplementedError

    def advance(self, coeff: TemporalCoefficients, dt: float, loops=None):
        """The step's device work (what a captured step graph holds); a
        flow with host-side work in `step` separates the two."""
        self.step(coeff, dt, loops)

    def velocity(self):
        raise NotImplementedError


class ZeroFlow(FlowBase):
    """No flow (reference: split_flow_base.hpp:152)."""

    def __init__(self, tab):
        self._vel = zeros(tab, tab.ndofs, tab.dim)

    def step(self, coeff, dt, loops=None):
        pass

    def velocity(self):
        return self._vel


class ThermoChemBase:
    """Thermo-chemistry interface (reference: src/thermo_chem_base.hpp:75-205)."""

    def step(self, coeff: TemporalCoefficients, dt: float, loops=None):
        raise NotImplementedError

    def density(self):
        raise NotImplementedError

    def viscosity(self):
        raise NotImplementedError

    def thermal_divergence(self):
        """Q_t = -(1/rho)(d rho/dt): velocity divergence constraint."""
        raise NotImplementedError


class ConstantPropertyThermoChem(ThermoChemBase):
    """Fixed rho/mu/Qt (reference: thermo_chem_base.hpp:207)."""

    def __init__(self, tab, rho=1.0, mu=1.0e-3, qt=0.0):
        self._rho = full(tab, rho, tab.ndofs)
        self._mu = full(tab, mu, tab.ndofs)
        self._qt = full(tab, qt, tab.ndofs)

    def step(self, coeff, dt, loops=None):
        pass

    def density(self):
        return self._rho

    def viscosity(self):
        return self._mu

    def thermal_divergence(self):
        return self._qt


class TurbModelBase:
    """Eddy-viscosity interface (reference: src/turb_model_base.hpp:74)."""

    def step(self, coeff, dt, loops=None):
        pass

    def eddy_viscosity(self):
        raise NotImplementedError


class ZeroTurbModel(TurbModelBase):
    def __init__(self, tab):
        self._nut = zeros(tab, tab.ndofs)

    def eddy_viscosity(self):
        return self._nut


class SpongeBase:
    """Damping-coefficient field interface (reference: src/sponge_base.hpp:67);
    sponge.py's GeometricSponge."""

    def multiplier(self):
        raise NotImplementedError
