"""Build plasma physics models from the ini input.

The JAX package's physics/plasma_config.py (PlasmaSetup,
_parse_composition and build_plasma, tps_tpu/physics/plasma_config.py:
26-312): parses the reference's input schema ([atoms/*], [species/*],
[plasma_models], [reactions/*] — exemplar test/inputs/argonMinimal.ini)
and constructs the port's PerfectMixture / transport / Chemistry objects
with the reference's species-ordering conventions: input species are
reordered to [others..., electron, background].  Its species and reaction
readers (`read_species`, `parse_reactions`) also serve the reacting
low-Mach thermo's simple tier, which keeps the input order.

Transport: argon_minimal, the general per-pair model (`argon_mixture`,
GasMixtureTransport, its collision types taken from each species'
composition, so the lumped excited states use ground-state argon's data),
and `constant` (ConstantPlasmaTransport with per-species diffusivities, or
physics/transport.py::ConstantTransport without).  Reactions: Arrhenius,
Hoffert-Lien, tabulated and escape-factor radiative decay
(physics/radiative_decay.py).

`read_table_input` reads a table from an HDF5 file (through io/h5lite.py)
or from inline x/f lists: the LTE thermo's and the mixture's net-emission
table, a `tabulated` reaction rate.  With `loMach/reactingFlow/ramp-chem`,
`[reactions_base/reactionN]` gives the baseline chemistry the reacting
thermo blends from (`chemistry_base`).  Not here: the externally injected
`bte` rates of the Boltzmann coupling (ROADMAP A11.3), which raise.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from ..io import h5lite
from .chemistry import Arrhenius, Chemistry, HoffertLien, TabulatedRate
from .gas_transport import (ArgonMinimalTransport, ConstantPlasmaTransport,
                            GasMixtureTransport)
from .perfect_mixture import PerfectMixture
from .radiation import NetEmission
from .radiative_decay import RadiativeDecay
from .tables import LinearTable
from .transport import ConstantTransport


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported to tps_torch yet "
                               f"(ROADMAP {item})")


@dataclass
class PlasmaSetup:
    mixture: object
    transport: object
    chemistry: object | None
    radiation: object | None
    species_names: list  # mixture-ordered
    input_to_mixture: np.ndarray  # input species index -> mixture index
    initial_mass_fractions: np.ndarray = None  # mixture-ordered
    chemistry_base: object | None = None  # ramp-chem's baseline chemistry


def _parse_composition(s: str) -> dict:
    """'{Ar : 1, E : -1}' -> {'Ar': 1.0, 'E': -1.0}"""
    out = {}
    for m in re.finditer(r"([A-Za-z0-9_.+\-]+)\s*:\s*([-+0-9.eE]+)", s):
        out[m.group(1)] = float(m.group(2))
    return out


def read_table_input(inp, prefix: str):
    """Read a table spec: either an HDF5 file (dataset `table`, columns x
    and f) or inline x/f lists."""
    if inp.has(f"{prefix}/filename"):
        data = np.asarray(h5lite.read(inp.get(f"{prefix}/filename"))["table"])
        x, fv = data[:, 0], data[:, 1]
    else:
        x = np.asarray(inp.get_vec(f"{prefix}/x"))
        fv = np.asarray(inp.get_vec(f"{prefix}/f"))
    return LinearTable(
        x=x,
        f=fv,
        x_log=bool(inp.get(f"{prefix}/x_log", 0)),
        f_log=bool(inp.get(f"{prefix}/f_log", 0)),
    )


def read_species(inp, default_cv: float, compositions=None):
    """[atoms] and [species] in input order: the names, molar masses,
    charges, heats of formation, molar cv / R (`default_cv` where a
    species gives none), initial mass fractions and level degeneracies,
    one list each; each species' composition appended to `compositions`
    where given."""
    atoms = {}
    for a in range(1, inp.get("atoms/numAtoms", 0) + 1):
        atoms[inp.get_required(f"atoms/atom{a}/name")] = inp.get_required(
            f"atoms/atom{a}/mass", float)
    nsp = inp.get_required("species/numSpecies", int)
    names, mws, charges, hf, cv, imf, degen = [], [], [], [], [], [], []
    for s in range(1, nsp + 1):
        base = f"species/species{s}"
        name = inp.get_required(f"{base}/name")
        comp = _parse_composition(inp.get(f"{base}/composition", "{}"))
        if compositions is not None:
            compositions.append(comp)
        names.append(name)
        mws.append(sum(atoms[a] * c for a, c in comp.items()))
        charges.append(-comp.get("E", 0.0) if name != "E" else -1.0)
        hf.append(inp.get(f"{base}/formation_energy", 0.0))
        cv.append(inp.get(f"{base}/perfect_mixture/constant_molar_cv",
                          default_cv))
        imf.append(inp.get(f"{base}/initialMassFraction", 0.0))
        degen.append(inp.get(f"{base}/level_degeneracy", 1.0))
    return names, mws, charges, hf, cv, imf, degen


def _rate_model(inp, base, decay_states=None):
    """The rate model of [base]; decay_states: (upper name, lower name,
    upper index, lower index) of a radiative decay, in the mixture's
    order."""
    model = inp.get(f"{base}/model", "arrhenius")
    if model in ("arrhenius", "hoffert_lien"):
        rate = Arrhenius if model == "arrhenius" else HoffertLien
        return rate(A=inp.get_required(f"{base}/{model}/A", float),
                    b=inp.get_required(f"{base}/{model}/b", float),
                    E=inp.get_required(f"{base}/{model}/E", float))
    if model == "tabulated":
        return TabulatedRate(read_table_input(inp, f"{base}/tabulated"))
    if model == "radiative_decay":
        # (reference: src/reactingFlow.cpp:562-566)
        upper, lower, iu, il = decay_states
        return RadiativeDecay(upper=upper, lower=lower, i_upper=iu,
                              i_lower=il, radius=inp.get_required(
                                  f"{base}/radius", float))
    if model == "bte":
        raise _not_ported("externally injected (bte) reaction rates "
                          "(the Boltzmann coupling)", "A11.3")
    raise NotImplementedError(f"reaction model '{model}'")


def parse_reactions(inp, nsp: int, mixture, to_mixture=None,
                    baseline=False, species_names=None):
    """The Chemistry of [reactions] over `mixture`, or None without
    reactions.  `to_mixture` maps input species to the mixture's order
    (identity if None); `species_names` in the mixture's order name a
    radiative decay's states.  With `baseline`, ramp-chem's baseline chemistry:
    the same reactions, stoichiometry and equilibria, the rate models (and
    the energies, where given) from [reactions_base/reactionN] (reference:
    src/reactingFlow.cpp:658-682)."""
    n_react = inp.get("reactions/numberOfReactions",
                      inp.get("reactions/number_of_reactions", 0))
    if n_react == 0:
        return None
    to_mixture = np.arange(nsp) if to_mixture is None else to_mixture
    r_stoich = np.zeros((n_react, nsp))
    p_stoich = np.zeros((n_react, nsp))
    models, energies, balances, eq_params = [], [], [], []
    for r in range(1, n_react + 1):
        base = f"reactions/reaction{r}"
        r_stoich[r - 1, to_mixture] = inp.get_vec(
            f"{base}/reactant_stoichiometry", nsp)
        p_stoich[r - 1, to_mixture] = inp.get_vec(
            f"{base}/product_stoichiometry", nsp)
        energy = inp.get(f"{base}/reaction_energy", 0.0)
        decay = None
        if species_names is not None:
            iu = int(np.argmax(r_stoich[r - 1]))
            il = int(np.argmax(p_stoich[r - 1]))
            decay = (species_names[iu], species_names[il], iu, il)
        if baseline:
            base_b = f"reactions_base/reaction{r}"
            models.append(_rate_model(inp, base_b, decay))
            energies.append(inp.get(f"{base_b}/reaction_energy", energy))
        else:
            models.append(_rate_model(inp, base, decay))
            energies.append(energy)
        db = bool(inp.get(f"{base}/detailed_balance", 0))
        balances.append(db)
        eq_params.append(tuple(
            inp.get_required(f"{base}/equilibrium_constant/{k}", float)
            for k in "AbE") if db else (0.0, 0.0, 0.0))
    return Chemistry(
        mixture=mixture,
        reactant_stoich=r_stoich,
        product_stoich=p_stoich,
        models=tuple(models),
        reaction_energies=tuple(energies),
        detailed_balance=tuple(balances),
        equilibrium_params=tuple(eq_params),
        min_temperature=inp.get("reactions/minimumTemperature", 0.0),
    )


def build_plasma(inp, dim: int, nvel: int) -> PlasmaSetup:
    comps = []
    names, mws, charges, hf, cv, imf, degen = read_species(inp, 1.5, comps)
    nsp = len(names)
    bg_input = inp.get_required("species/background_index", int)  # 1-based

    # ---- reorder to mixture convention: [others..., E, background] ----
    e_input = names.index("E")
    order = [
        i for i in range(nsp) if i != e_input and i != bg_input - 1
    ] + [e_input, bg_input - 1]
    input_to_mixture = np.empty(nsp, dtype=np.int64)
    for mix_idx, inp_idx in enumerate(order):
        input_to_mixture[inp_idx] = mix_idx

    mixture = PerfectMixture(
        dim=dim,
        nvel=nvel,
        mw=tuple(mws[i] for i in order),
        charges=tuple(charges[i] for i in order),
        formation_energy=tuple(hf[i] for i in order),
        molar_cv_over_R=tuple(cv[i] for i in order),
        degeneracy=tuple(degen[i] for i in order),
        ambipolar=bool(inp.get("plasma_models/ambipolar", 0)),
        two_temperature=bool(inp.get("plasma_models/two_temperature", 0)),
        const_plasma_conductivity=inp.get(
            "plasma_models/const_plasma_conductivity", 0.0),
    )

    # ---- transport ----
    tmodel = inp.get("plasma_models/transport_model", "argon_minimal")
    third_order = bool(
        inp.get(
            "plasma_models/transport_model/argon_minimal/"
            "third_order_thermal_conductivity",
            1,
        )
    )
    if tmodel == "argon_minimal":
        transport = ArgonMinimalTransport(
            mixture=mixture,
            third_order_electron_thermal_conductivity=third_order,
        )
    elif tmodel in ("argon_mixture", "gas_mixture", "mixture"):
        # the collision types follow each species' composition, so lumped
        # excited states (Ar_m, Ar_r, Ar_p) take ground-state argon's data
        # (reference: identifySpeciesType, src/M2ulPhyS.cpp:3860-3923)
        def canonical(i):
            heavy = [a for a in comps[i] if a != "E"]
            if not heavy:
                return "E"
            return f"{heavy[0]}.+1" if charges[i] > 0 else heavy[0]

        transport = GasMixtureTransport(
            mixture=mixture,
            species_names=tuple(canonical(i) for i in order),
            third_order_electron_thermal_conductivity=third_order)
    elif tmodel == "constant":
        pre = "plasma_models/transport_model/constant"
        common = dict(visc=inp.get(f"{pre}/viscosity", 0.0),
                      bulk_visc=inp.get(f"{pre}/bulk_viscosity", 0.0),
                      kappa=inp.get(f"{pre}/thermal_conductivity", 0.0),
                      kappa_e=inp.get(
                          f"{pre}/electron_thermal_conductivity", 0.0))
        if inp.has(f"{pre}/diffusivity/species1"):
            # per-species diffusivities and momentum-transfer frequencies
            # in input order, reordered to the mixture's (reference:
            # ConstantTransport, transport_properties.cpp:303-332)
            diff_in = [inp.get(f"{pre}/diffusivity/species{s + 1}", 0.0)
                       for s in range(nsp)]
            mtf_in = [inp.get(f"{pre}/momentum_transfer_frequency/"
                              f"species{s + 1}", 0.0) for s in range(nsp)]
            transport = ConstantPlasmaTransport(
                mixture=mixture, diffusivity=tuple(diff_in[i] for i in order),
                mt_freq=tuple(mtf_in[i] for i in order), **common)
        else:
            transport = ConstantTransport(**common)
    else:
        raise NotImplementedError(f"transport model '{tmodel}'")

    # ---- reactions (and ramp-chem's baseline) ----
    names_mix = [names[i] for i in order]
    chemistry = parse_reactions(inp, nsp, mixture, input_to_mixture,
                                species_names=names_mix)
    chemistry_base = None
    if chemistry is not None and inp.get("loMach/reactingFlow/ramp-chem", 0):
        chemistry_base = parse_reactions(inp, nsp, mixture, input_to_mixture,
                                         baseline=True,
                                         species_names=names_mix)

    # ---- radiation ----
    radiation = None
    rmodel = inp.get("plasma_models/radiation_model", "none")
    if rmodel == "net_emission":
        radiation = NetEmission(read_table_input(
            inp, "plasma_models/radiation_model/net_emission/tabulated"))
    elif rmodel not in ("none", "n/a"):
        raise NotImplementedError(f"radiation model '{rmodel}'")

    return PlasmaSetup(
        mixture=mixture,
        transport=transport,
        chemistry=chemistry,
        radiation=radiation,
        species_names=names_mix,
        input_to_mixture=input_to_mixture,
        initial_mass_fractions=np.array([imf[i] for i in order]),
        chemistry_base=chemistry_base,
    )
