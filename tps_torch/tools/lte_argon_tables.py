"""The LTE tables of tps_torch/tools/lte_channel_coupled.ini: the
equilibrium argon of tests/inputs/argon_full.ini at 101,325 Pa.

    python -m tps_torch.tools.lte_argon_tables [--n 800] [--out DIR]
    python -m tps_torch.tools.lte_argon_tables --table-dim 2 --out DIR

Writes lte_argon_thermo.h5 (dataset "T_energy_R_c": T, e, R, c) and
lte_argon_trans.h5 ("T_mu_kappa_sigma": T, mu, kappa, sigma), through
io/h5lite.py, in the layout physics/lte.py::load_lte_setup reads with
table_dim = 1 (the JAX package's reader, with h5py, reads them too).
With --table-dim 2, the same equilibrium on a (T, rho) grid as the
whitespace tables of table_dim = 2 (`write_2d`: lte2d_thermo.dat,
lte2d_trans.dat and the T(e, rho) inversion lte2d_erev.dat).

- e(T) and R(T): the six species of argon_full.ini (the ion, three lumped
  excited levels, the electron, the ground state) in the multi-level
  Saha/Boltzmann equilibrium of physics/perfect_mixture.py::
  species_from_lte, at the density that gives 101,325 Pa, over 300-20,000
  K; e is the mixture's own total energy per mass at rest (formation
  energies included, T_e = T), so an LTE run's state converts into
  argon_full.ini's by the LTE restart (io/restartFromLTE) at the same
  temperature up to the table's interpolation error.
- c(T): the frozen sound speed, sqrt(gamma_f R T) with gamma_f the
  composition's cp / cv.
- mu, kappa, sigma: the forms of examples/cases/make_lte_table.py.

Runs the port's own code on the CPU in f64; imports no jax.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..config.ini import IniInput
from ..constants import UNIVERSAL_GAS_CONSTANT
from ..io import h5lite
from ..physics.perfect_mixture import species_from_lte
from ..physics.plasma_config import build_plasma

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
DECK = os.path.join(REPO, "tests", "inputs", "argon_full.ini")
PRESSURE = 101325.0


def _at_rest(mix, rho, T):
    """The mixture's conserved state at rest in LTE at (rho, T) [n]."""
    parts = [rho[:, None], torch.zeros(len(T), mix.nvel, dtype=torch.float64),
             T[:, None], species_from_lte(mix, rho, T)]
    if mix.two_temperature:
        parts.append(T[:, None])
    return mix.conservatives(torch.cat(parts, dim=-1))


def _properties(mix, rho, T):
    """(e, R, c) of the LTE states at (rho, T): the total energy per mass,
    p / (rho T) and the frozen sound speed."""
    U = _at_rest(mix, rho, T)
    e = U[:, mix.i_th] / rho
    R = mix.pressure(U) / (rho * T)
    n_sp = mix.number_densities(U)
    cv = torch.sum(n_sp * mix.molar_cv(U), dim=-1)
    cp = torch.sum(n_sp * mix.molar_cp(U), dim=-1)
    return e, R, torch.sqrt(cp / cv * R * T)


def equilibrium(mix, T, p=PRESSURE, iters=60):
    """(rho, e, R, c) of the mixture in LTE at temperatures T [n] and
    pressure p: rho by fixed-point steps on p(rho, T) = p."""
    T = torch.as_tensor(T, dtype=torch.float64)
    rho = p / (UNIVERSAL_GAS_CONSTANT / mix.mw[mix.i_background] * T)
    for _ in range(iters):
        rho = rho * p / mix.pressure(_at_rest(mix, rho, T))
    e, R, c = _properties(mix, rho, T)
    return rho.numpy(), e.numpy(), R.numpy(), c.numpy()


def write_2d(out, nT=200, rhos=None, ne=300):
    """The whitespace tables of table_dim = 2 in directory `out`: the
    equilibrium at each (T, rho) of the grid (nT temperatures over
    300-20,000 K, the densities `rhos`), thermo columns (T, rho, 0, e, 0,
    0, R, 0, c), transport columns (T, rho, mu, kappa, sigma), and the
    inversion (e, rho, T) on ne energies, T(e) interpolated at each rho.
    Returns the three paths (thermo, transport, e_rev)."""
    mix = build_plasma(IniInput.read(DECK), 2, 2).mixture
    T = np.linspace(300.0, 20000.0, nT)
    rhos = np.geomspace(0.005, 2.0, 12) if rhos is None else np.asarray(rhos)
    TT, RR = np.meshgrid(T, rhos, indexing="ij")
    e, R, c = (a.numpy().reshape(TT.shape) for a in _properties(
        mix, torch.as_tensor(RR.ravel()), torch.as_tensor(TT.ravel())))
    mu, kap, sig = transport(TT)
    z = np.zeros_like(TT)
    thermo = np.stack([TT, RR, z, e, z, z, R, z, c], -1).reshape(-1, 9)
    trans = np.stack([TT, RR, mu, kap, sig], -1).reshape(-1, 5)
    es = np.linspace(e.min(), e.max(), ne)
    erev = np.asarray([[ei, rho, np.interp(ei, e[:, j], T)]
                       for ei in es for j, rho in enumerate(rhos)])
    paths = tuple(os.path.join(out, f"lte2d_{k}.dat")
                  for k in ("thermo", "trans", "erev"))
    for path, rows in zip(paths, (thermo, trans, erev)):
        np.savetxt(path, rows)
    return paths


def lte_keys(table_dim, out=None):
    """The [flow/lte] section of an ini on these tables: the committed 1-D
    tables by absolute path, or (table_dim 2) the 2-D tables `write_2d`
    writes into directory `out`, written there if missing."""
    if table_dim == 1:
        return (f"[flow/lte]\ntable_dim = 1\nthermo_table = "
                f"{os.path.join(HERE, 'lte_argon_thermo.h5')}\n"
                f"transport_table = {os.path.join(HERE, 'lte_argon_trans.h5')}"
                "\n")
    paths = tuple(os.path.join(out, f"lte2d_{k}.dat")
                  for k in ("thermo", "trans", "erev"))
    if not all(os.path.exists(p) for p in paths):
        paths = write_2d(out)
    return (f"[flow/lte]\ntable_dim = 2\nthermo_table = {paths[0]}\n"
            f"transport_table = {paths[1]}\ne_rev_table = {paths[2]}\n")


def transport(T):
    """mu, kappa, sigma: examples/cases/make_lte_table.py's forms."""
    mu = 1.8e-5 * (T / 300.0) ** 0.7
    kap = 0.016 * (T / 300.0) ** 0.8
    sig = np.where(T > 6000.0, 8000.0 * (T - 6000.0) / 19000.0, 0.0)
    return mu, kap, sig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=800, help="temperatures")
    ap.add_argument("--out", default=HERE, help="output directory")
    ap.add_argument("--table-dim", type=int, default=1, choices=(1, 2))
    args = ap.parse_args(argv)
    if args.table_dim == 2:
        print("wrote", *write_2d(args.out))
        return
    mix = build_plasma(IniInput.read(DECK), 2, 2).mixture
    T = np.linspace(300.0, 20000.0, args.n)
    rho, e, R, c = equilibrium(mix, T)
    mu, kap, sig = transport(T)
    thermo = os.path.join(args.out, "lte_argon_thermo.h5")
    trans = os.path.join(args.out, "lte_argon_trans.h5")
    h5lite.write(thermo, {"T_energy_R_c": np.stack([T, e, R, c], axis=1)})
    h5lite.write(trans, {"T_mu_kappa_sigma": np.stack([T, mu, kap, sig],
                                                      axis=1)})
    for Tq in (300.0, 6000.0, 9000.0, 9500.0, 10000.0, 15000.0, 20000.0):
        i = int(np.argmin(np.abs(T - Tq)))
        print(f"T {T[i]:9.1f} K: rho {rho[i]:.6e} kg/m^3, e {e[i]:.6e} J/kg, "
              f"R {R[i]:.3f} J/kg/K, c {c[i]:.1f} m/s, sigma {sig[i]:.1f} "
              f"S/m")
    print(f"wrote {thermo} and {trans}")


if __name__ == "__main__":
    main()
