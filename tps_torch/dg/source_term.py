"""Chemistry source term of the compressible plasma solver, on torch tensors.

The JAX package's dg/source_term.py (SourceTerm, tps_tpu/dg/source_term.py:
24-110), mirroring reference SourceTerm::updateTerms (src/source_term.cpp:
62-258): per-point reaction creation rates and, for two-temperature
mixtures, the electron-energy sinks (electron-impact reaction energy,
electron-pressure work, elastic electron-heavy energy exchange).  A
forcing `(t, tab, U, Up, grad_up, fields) -> dU/dt [..., neq]` that
dg/rhs.py adds after the DG part.

Every loop runs over Python constants (species, reactions) and every
constant tensor is made once (physics/perfect_mixture.py::const), so the
step that calls it stays capturable as a CUDA graph: no host sync, no copy
from the host.

Not here: the radiation sink (NetEmission, ROADMAP A6.3), the external
electric field and injected rates (the EM and Boltzmann coupling, ROADMAP
A10/A11) and the plasma conductivity field they read.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..constants import UNIVERSAL_GAS_CONSTANT as _R


@dataclass(frozen=True, eq=False)
class SourceTerm:
    mixture: object
    transport: object  # needs .source_properties
    chemistry: object | None = None

    def __call__(self, t, tab, U, Up, grad_up, fields=None):
        mix = self.mixture
        nvel, neq, dim = mix.nvel, mix.num_equations, mix.dim
        if grad_up is None:
            grad_up = torch.zeros(U.shape[:-1] + (neq, dim), dtype=U.dtype,
                                  device=U.device)

        # clip species (reference source_term.cpp:127-131)
        na = mix.num_active_species
        lo, hi = nvel + 2, nvel + 2 + na

        def clip(X):
            return torch.cat([X[..., :lo], torch.clamp(X[..., lo:hi], min=0.0),
                              X[..., hi:]], dim=-1)

        Uc, Upc = clip(U), clip(Up)
        props = self.transport.source_properties(Uc, Upc, grad_up)
        n_sp = props["n_sp"]
        Th = Upc[..., mix.i_th]
        Te = Upc[..., mix.i_te] if mix.two_temperature else Th

        zero = torch.zeros_like(Th)
        creation = [zero] * na
        progress = None
        chem = self.chemistry
        if chem is not None and chem.num_reactions > 0:
            progress, rates = chem.source(n_sp, Th, Te)
            creation = [rates[..., s] for s in range(na)]

        e_src = zero
        if mix.two_temperature:
            ie = mix.i_electron
            # electron-impact reaction energy sink
            if progress is not None:
                einv = chem.electron_involved()
                for r in range(chem.num_reactions):
                    if einv[r]:
                        e_src = e_src + (-chem.reaction_energies[r]
                                         * progress[..., r])
            # work by electron pressure: u . grad(pe)
            ne = n_sp[..., ie]
            gn_active = grad_up[..., lo:hi, :]
            if mix.ambipolar:
                z = mix._arr(mix.charges, U)[:na]
                ne_grad = torch.einsum("...sd,s->...d", gn_active, z)
            else:
                ne_grad = gn_active[..., ie, :]
            gradTe = grad_up[..., mix.i_te, :]
            gradPe = _R * (ne_grad * Te[..., None] + ne[..., None] * gradTe)
            u = Upc[..., 1 : 1 + dim]
            e_src = e_src + torch.einsum("...d,...d->...", gradPe, u)
            # elastic electron-heavy energy exchange
            me = mix.mw[ie]
            for sp in range(mix.num_species):
                if sp == ie:
                    continue
                msp = mix.mw[sp]
                coup = 2.0 * me * msp / (msp + me) ** 2
                energy = (1.5 * _R * (Te - Th)
                          * coup * ne * props["mf_freq"][..., sp])
                e_src = e_src + (-energy)

        cols = [zero] * (nvel + 2) + creation
        if mix.two_temperature:
            cols.append(e_src)
        return torch.stack(cols, dim=-1)
