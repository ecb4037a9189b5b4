"""Finite-rate chemistry: reaction models + mass-action network, on torch
tensors.

The JAX package's physics/chemistry.py (Arrhenius, HoffertLien and
Chemistry, tps_tpu/physics/chemistry.py:27-52, 77-162), with the same
formulas (reference: src/chemistry.cpp:38-300, src/reaction.cpp:41-117):
k_f from per-reaction models, equilibrium constants for detailed balance,
progress rates by mass action over molar number densities, creation rates
in mass units.  The (static, small) reaction list is unrolled in Python
over constants, so a step that runs it stays capturable as a CUDA graph.

Not here: tabulated rates (TabulatedRate, which reads tables) and
radiative decay wait for ROADMAP A6.3, the externally injected `bte`
rates for the Boltzmann coupling (ROADMAP A11); physics/plasma_config.py
raises for each.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import BOLTZMANN_CONSTANT, UNIVERSAL_GAS_CONSTANT

_R = UNIVERSAL_GAS_CONSTANT


@dataclass(frozen=True)
class Arrhenius:
    """k = A T^b exp(-E / (R T)) (reference: src/reaction.cpp:41-48)."""

    A: float
    b: float
    E: float

    def __call__(self, T, **kw):
        return self.A * T**self.b * torch.exp(-self.E / _R / T)


@dataclass(frozen=True)
class HoffertLien:
    """Hoffert & Lien (1967) partially-ionized argon rate
    (reference: src/reaction.cpp:50-61): k = A T^b (E/kB/T + 2) exp(-E/kB/T)."""

    A: float
    b: float
    E: float

    def __call__(self, T, **kw):
        tf = self.E / BOLTZMANN_CONSTANT / T
        return self.A * T**self.b * (tf + 2.0) * torch.exp(-tf)


@dataclass(frozen=True, eq=False)
class Chemistry:
    """Reaction network over a PerfectMixture-ordered species set."""

    mixture: object
    # [nreact, nsp] stoichiometric coefficients
    reactant_stoich: np.ndarray
    product_stoich: np.ndarray
    models: tuple  # per-reaction rate models (callables above)
    reaction_energies: tuple  # [nreact] J/mol
    detailed_balance: tuple  # [nreact] bool
    equilibrium_params: tuple  # [nreact] (A, b, E) for A T^b exp(-E/T)
    min_temperature: float = 0.0

    @property
    def num_reactions(self):
        return len(self.models)

    def electron_involved(self):
        """Reaction uses Te if the electron participates as a reactant
        (reference isElectronInvolvedAt)."""
        ie = self.mixture.i_electron
        return [bool(self.reactant_stoich[r, ie] > 0)
                for r in range(self.num_reactions)]

    # ------------------------------------------------------------------
    def forward_rates(self, Th, Te, n_sp=None):
        """k_f per reaction: [..., nreact]."""
        Thl = torch.clamp(Th, min=self.min_temperature)
        Tel = torch.clamp(Te, min=self.min_temperature)
        einv = self.electron_involved()
        return torch.stack([model(Tel if einv[r] else Thl, n_sp=n_sp,
                                  Th=Thl, Te=Tel)
                            for r, model in enumerate(self.models)], dim=-1)

    def equilibrium_constants(self, Th, Te):
        """K_c per reaction (only meaningful under detailed balance)."""
        Thl = torch.clamp(Th, min=self.min_temperature)
        Tel = torch.clamp(Te, min=self.min_temperature)
        einv = self.electron_involved()
        out = []
        for r in range(self.num_reactions):
            if self.detailed_balance[r]:
                A, b, E = self.equilibrium_params[r]
                T = Tel if einv[r] else Thl
                out.append(A * T**b * torch.exp(-E / T))
            else:
                out.append(torch.zeros_like(Th))
        return torch.stack(out, dim=-1)

    def progress_rates(self, n_sp, kfwd, keq):
        """Mass-action progress rates [..., nreact]; n_sp in mol/m^3."""
        out = []
        ns = torch.clamp(n_sp, min=0.0)
        for r in range(self.num_reactions):
            rs = self.reactant_stoich[r]
            ps = self.product_stoich[r]
            fwd = torch.ones_like(n_sp[..., 0])
            for sp in range(n_sp.shape[-1]):
                if rs[sp] != 0:
                    fwd = fwd * ns[..., sp] ** float(rs[sp])
            rate = fwd
            if self.detailed_balance[r]:
                bwd = torch.ones_like(fwd)
                for sp in range(n_sp.shape[-1]):
                    if ps[sp] != 0:
                        bwd = bwd * ns[..., sp] ** float(ps[sp])
                rate = rate - bwd / keq[..., r]
            out.append(kfwd[..., r] * rate)
        return torch.stack(out, dim=-1)

    def creation_rates(self, progress):
        """Mass creation rates [..., nsp] in kg/m^3/s."""
        net = self.product_stoich - self.reactant_stoich  # [nr, nsp]
        mw = np.asarray(self.mixture.mw)
        w = self.mixture._arr(net * mw[None, :], progress)
        return torch.einsum("...r,rs->...s", progress, w)

    # convenience: everything at once
    def source(self, n_sp, Th, Te):
        kf = self.forward_rates(Th, Te, n_sp=n_sp)
        kc = self.equilibrium_constants(Th, Te)
        pr = self.progress_rates(n_sp, kf, kc)
        return pr, self.creation_rates(pr)
