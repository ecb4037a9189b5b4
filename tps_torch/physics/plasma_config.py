"""Build plasma physics models from the ini input.

The JAX package's physics/plasma_config.py (PlasmaSetup,
_parse_composition and build_plasma, tps_tpu/physics/plasma_config.py:
26-312): parses the reference's input schema ([atoms/*], [species/*],
[plasma_models], [reactions/*] — exemplar test/inputs/argonMinimal.ini)
and constructs the port's PerfectMixture / transport / Chemistry objects
with the reference's species-ordering conventions: input species are
reordered to [others..., electron, background].

Not here, each raising with its ROADMAP item: tables read from files or
inline (tabulated rates, `read_table_input`; A6.3 on io/h5lite.py), the
`net_emission` radiation model and radiative decay (A6.3), the general
per-pair transport (`argon_mixture`, A6.3), constant transport with
species (A6.2), the externally injected `bte` rates (A11) and the
reacting-flow chemistry ramp (`ramp-chem`, the low-Mach family, A9).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from .chemistry import Arrhenius, Chemistry, HoffertLien
from .gas_transport import ArgonMinimalTransport
from .perfect_mixture import PerfectMixture


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


def _parse_composition(s: str) -> dict:
    """'{Ar : 1, E : -1}' -> {'Ar': 1.0, 'E': -1.0}"""
    out = {}
    for m in re.finditer(r"([A-Za-z0-9_.+\-]+)\s*:\s*([-+0-9.eE]+)", s):
        out[m.group(1)] = float(m.group(2))
    return out


def read_table_input(inp, prefix: str):
    """A table spec (an HDF5 file or inline x/f lists)."""
    raise _not_ported(f"tabulated inputs ([{prefix}])", "A6.3")


def build_plasma(inp, dim: int, nvel: int) -> PlasmaSetup:
    # ---- atoms ----
    atoms = {}
    n_atoms = inp.get("atoms/numAtoms", 0)
    for a in range(1, n_atoms + 1):
        name = inp.get_required(f"atoms/atom{a}/name")
        atoms[name] = inp.get_required(f"atoms/atom{a}/mass", float)

    # ---- species (input order) ----
    nsp = inp.get_required("species/numSpecies", int)
    bg_input = inp.get_required("species/background_index", int)  # 1-based
    names, mws, charges, hf, cv, imf, degen = [], [], [], [], [], [], []
    for s in range(1, nsp + 1):
        base = f"species/species{s}"
        name = inp.get_required(f"{base}/name")
        comp = _parse_composition(inp.get(f"{base}/composition", "{}"))
        mw = sum(atoms[a] * c for a, c in comp.items())
        charge = -comp.get("E", 0.0) if name != "E" else -1.0
        names.append(name)
        mws.append(mw)
        charges.append(charge)
        hf.append(inp.get(f"{base}/formation_energy", 0.0))
        cv.append(inp.get(f"{base}/perfect_mixture/constant_molar_cv", 1.5))
        imf.append(inp.get(f"{base}/initialMassFraction", 0.0))
        degen.append(inp.get(f"{base}/level_degeneracy", 1.0))

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
        raise _not_ported(f"the '{tmodel}' transport model "
                          "(GasMixtureTransport)", "A6.3")
    elif tmodel == "constant":
        raise _not_ported("constant transport of a species mixture "
                          "(ConstantPlasmaTransport)", "A6.2")
    else:
        raise NotImplementedError(f"transport model '{tmodel}'")

    # ---- reactions ----
    chemistry = None
    n_react = inp.get("reactions/numberOfReactions",
                      inp.get("reactions/number_of_reactions", 0))
    if inp.get("loMach/reactingFlow/ramp-chem", 0):
        raise _not_ported("the chemistry ramp (ramp-chem)", "A9")
    if n_react > 0:
        r_stoich = np.zeros((n_react, nsp))
        p_stoich = np.zeros((n_react, nsp))

        def parse_model(base):
            model = inp.get(f"{base}/model", "arrhenius")
            if model == "arrhenius":
                return Arrhenius(
                    A=inp.get_required(f"{base}/arrhenius/A", float),
                    b=inp.get_required(f"{base}/arrhenius/b", float),
                    E=inp.get_required(f"{base}/arrhenius/E", float),
                )
            if model == "hoffert_lien":
                return HoffertLien(
                    A=inp.get_required(f"{base}/hoffert_lien/A", float),
                    b=inp.get_required(f"{base}/hoffert_lien/b", float),
                    E=inp.get_required(f"{base}/hoffert_lien/E", float),
                )
            if model == "tabulated":
                return read_table_input(inp, f"{base}/tabulated")
            if model == "radiative_decay":
                raise _not_ported("the radiative-decay reaction model", "A6.3")
            if model == "bte":
                raise _not_ported("externally injected (bte) reaction rates",
                                  "A11")
            raise NotImplementedError(f"reaction model '{model}'")

        models, energies, balances, eq_params = [], [], [], []
        for r in range(1, n_react + 1):
            base = f"reactions/reaction{r}"
            rs = inp.get_vec(f"{base}/reactant_stoichiometry", nsp)
            ps = inp.get_vec(f"{base}/product_stoichiometry", nsp)
            for i in range(nsp):
                r_stoich[r - 1, input_to_mixture[i]] = rs[i]
                p_stoich[r - 1, input_to_mixture[i]] = ps[i]
            energies.append(inp.get(f"{base}/reaction_energy", 0.0))
            models.append(parse_model(base))
            db = bool(inp.get(f"{base}/detailed_balance", 0))
            balances.append(db)
            if db:
                eq_params.append(
                    (
                        inp.get_required(f"{base}/equilibrium_constant/A", float),
                        inp.get_required(f"{base}/equilibrium_constant/b", float),
                        inp.get_required(f"{base}/equilibrium_constant/E", float),
                    )
                )
            else:
                eq_params.append((0.0, 0.0, 0.0))
        chemistry = Chemistry(
            mixture=mixture,
            reactant_stoich=r_stoich,
            product_stoich=p_stoich,
            models=tuple(models),
            reaction_energies=tuple(energies),
            detailed_balance=tuple(balances),
            equilibrium_params=tuple(eq_params),
            min_temperature=inp.get("reactions/minimumTemperature", 0.0),
        )

    # ---- radiation ----
    rmodel = inp.get("plasma_models/radiation_model", "none")
    if rmodel == "net_emission":
        raise _not_ported("the net-emission radiation model", "A6.3")
    if rmodel not in ("none", "n/a"):
        raise NotImplementedError(f"radiation model '{rmodel}'")

    return PlasmaSetup(
        mixture=mixture,
        transport=transport,
        chemistry=chemistry,
        radiation=None,
        species_names=[names[i] for i in order],
        input_to_mixture=input_to_mixture,
        initial_mass_fractions=np.array([imf[i] for i in order]),
    )
