"""LTE (local thermodynamic equilibrium) table-based mixture and transport,
on torch tensors.

The port of the JAX package's physics/lte.py (tps_tpu/physics/lte.py),
mirroring the reference LteMixture / LteTransport (reference:
src/lte_mixture.cpp:119-225, src/lte_transport_properties.cpp): one
equilibrium fluid whose thermodynamics come from tables e(T, rho),
R(T, rho), c(T, rho) and T(e, rho), with a fixed count of Newton steps
refining the T(e) inversion; mu, kappa and sigma are table lookups.

Tables are physics/tables.py's Table2D over (T, rho) [(e, rho) for the
T(e) guess] or its 1-D LinearTable, which ignores rho (`_eval2`).  Every
lookup keeps its device copies on the table, so a captured step graph
copies nothing from the host.  The face-sweep kernel's LTE policy
(csrc/dg_lte.cuh) computes the same temperature, pressure, sound speed
and transport on the card.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..io import h5lite
from .tables import LinearTable, Table2D, _eval2


def _at(table, x, y):
    """A table's value at one point (x, y), as a Python float: the lookup
    in f64 on the CPU, as the JAX package evaluates it with x64 on."""
    one = dict(dtype=torch.float64)
    return float(_eval2(table, torch.tensor([x], **one),
                        torch.tensor([y], **one))[0])


@dataclass(frozen=True, eq=False)
class LteMixture:
    dim: int
    nvel: int
    energy_table: object  # e(T, rho) [J/kg]
    R_table: object  # R(T, rho) [J/kg/K]
    c_table: object  # speed of sound c(T, rho) [m/s]
    T_table: object  # T(e, rho), the inversion's first guess
    newton_iters: int = 20

    @property
    def num_equations(self):
        return self.nvel + 2

    @property
    def num_species(self):
        return 1

    @property
    def num_active_species(self):
        return 0

    @property
    def two_temperature(self):
        return False

    @property
    def i_th(self):
        return self.nvel + 1

    # the walls' and the characteristic BCs' background properties
    @functools.cached_property
    def gas_constant(self):
        return _at(self.R_table, 300.0, 1.0)

    @functools.cached_property
    def specific_heat_ratio(self):
        c = _at(self.c_table, 300.0, 1.0)
        return c * c / (self.gas_constant * 300.0)

    # ------------------------------------------------------------------
    def temperature(self, U):
        """T of a conserved state: the table's guess, then newton_iters
        Newton steps on e(T) = e with a finite-difference cv, no early
        exit (reference ComputeTemperatureInternal :161-220)."""
        rho = U[..., 0]
        ke = 0.5 * torch.sum(U[..., 1 : 1 + self.nvel] ** 2, dim=-1) / rho
        e = (U[..., self.i_th] - ke) / rho
        T = _eval2(self.T_table, e, rho)
        # e at T, T + dT and T - dT in one lookup: the same values, a
        # third of the operations (and of the card's launches)
        rho3 = rho.expand((3,) + rho.shape)
        for _ in range(self.newton_iters):
            dT = 1e-3 * torch.clamp(T, min=1.0)
            e0, e_hi, e_lo = _eval2(self.energy_table,
                                    torch.stack([T, T + dT, T - dT]), rho3)
            cv = (e_hi - e_lo) / (2 * dT)
            T = T + (e - e0) / torch.clamp(cv, min=1e-30)
        return T

    def pressure(self, U):
        rho = U[..., 0]
        T = self.temperature(U)
        return rho * _eval2(self.R_table, T, rho) * T

    def electron_pressure(self, U):
        return torch.zeros_like(U[..., 0])

    def pressure_from_primitives(self, Up):
        rho = Up[..., 0]
        T = Up[..., self.i_th]
        return rho * _eval2(self.R_table, T, rho) * T

    def primitives(self, U):
        rho = U[..., 0:1]
        vel = U[..., 1 : 1 + self.nvel] / rho
        T = self.temperature(U)[..., None]
        return torch.cat([rho, vel, T], dim=-1)

    def conservatives(self, Up):
        rho = Up[..., 0:1]
        mom = rho * Up[..., 1 : 1 + self.nvel]
        T = Up[..., self.i_th]
        e = _eval2(self.energy_table, T, rho[..., 0])
        ke = 0.5 * torch.sum(Up[..., 1 : 1 + self.nvel] ** 2, dim=-1)
        rhoE = rho[..., 0] * (e + ke)
        return torch.cat([rho, mom, rhoE[..., None]], dim=-1)

    def max_char_speed(self, U):
        rho = U[..., 0]
        v2 = torch.sum(U[..., 1 : 1 + self.nvel] ** 2, dim=-1) / (rho * rho)
        T = self.temperature(U)
        c = _eval2(self.c_table, T, rho)
        return torch.sqrt(v2) + c

    def sound_speed_from_T(self, T):
        return _eval2(self.c_table, T, torch.ones_like(T))

    def species_enthalpies(self, U):
        return torch.zeros(U.shape[:-1] + (1,), dtype=U.dtype,
                           device=U.device)

    # the BC helpers: DryAir's behaviour with the table energy
    def stagnant_state_with_temp(self, U, T_wall):
        rho = U[..., 0]
        e = _eval2(self.energy_table, torch.full_like(rho, T_wall), rho)
        return torch.cat([U[..., :1],
                          torch.zeros_like(U[..., 1 : 1 + self.nvel]),
                          (rho * e)[..., None]], dim=-1)

    def modify_energy_for_pressure(self, U, p, modify_electron_energy=False):
        """The state with its energy set so that its pressure is p: T from
        p = rho R(T) T by 8 fixed-point steps, then e(T)."""
        rho = U[..., 0]
        T = p / (rho * self.gas_constant)
        for _ in range(8):
            T = p / (rho * _eval2(self.R_table, T, rho))
        e = _eval2(self.energy_table, T, rho)
        ke = 0.5 * torch.sum(U[..., 1 : 1 + self.nvel] ** 2, dim=-1) / rho
        return torch.cat([U[..., : self.i_th], (rho * e + ke)[..., None],
                          U[..., self.i_th + 1 :]], dim=-1)


@dataclass(frozen=True, eq=False)
class LteTransport:
    """Table transport mu(T, rho), kappa(T, rho), sigma(T, rho)
    (reference: src/lte_transport_properties.cpp); no bulk viscosity, no
    electron conduction, no species diffusion."""

    mu_table: object
    kappa_table: object
    sigma_table: object | None = None

    def flux_properties(self, mixture, U, Up, grad_up, **kw):
        rho = U[..., 0]
        T = Up[..., mixture.i_th]
        mu = _eval2(self.mu_table, T, rho)
        kappa = _eval2(self.kappa_table, T, rho)
        zero = torch.zeros_like(mu)
        return {"visc": mu, "bulk_visc": zero, "kappa": kappa,
                "kappa_e": zero, "diff_vel": None}

    def source_properties(self, U, Up, grad_up, efield=None):
        rho = U[..., 0]
        T = Up[..., -1]  # the temperature is the last primitive
        sigma = (_eval2(self.sigma_table, T, rho)
                 if self.sigma_table is not None else torch.zeros_like(rho))
        return {"sigma": sigma, "mf_freq": None, "diff_vel": None,
                "n_sp": None}


def _grid2d(path, xcol, ycol, fcol):
    """A Table2D over a whitespace table's structured (x, y) grid."""
    data = np.loadtxt(path)
    xs = np.unique(data[:, xcol])
    ys = np.unique(data[:, ycol])
    if len(xs) * len(ys) != data.shape[0]:
        raise ValueError(f"{path}: not a structured (x, y) grid")
    F = np.full((len(xs), len(ys)), np.nan)
    ix = np.searchsorted(xs, data[:, xcol])
    iy = np.searchsorted(ys, data[:, ycol])
    F[ix, iy] = data[:, fcol]
    return Table2D(x=xs, y=ys, f=F)


def load_lte_setup(inp, dim, nvel, prefix="flow/lte"):
    """(LteMixture, LteTransport) from the [flow/lte] keys (reference:
    src/M2ulPhyS.cpp:164-260 and parseFluidPreset :2398-2403).

    table_dim = 1: HDF5 files (read by io/h5lite.py) with the 4-column
    datasets "T_energy_R_c" (thermo) and "T_mu_kappa_sigma" (transport);
    the T(e) guess is the thermo's e(T) pair swapped (reference :193-201).
    table_dim = 2: whitespace tables over a structured (T, rho) grid:
    thermo columns (T, rho, .., e[3], .., R[6], .., c[8]), transport
    columns (T, rho, mu, kappa, sigma), e_rev columns (e, rho, T)
    (reference: src/lte_mixture.cpp:49-64,
    src/lte_transport_properties.cpp:38-51)."""
    table_dim = int(inp.get(f"{prefix}/table_dim", 2))
    thermo_file = inp.get_required(f"{prefix}/thermo_table")
    trans_file = inp.get_required(f"{prefix}/transport_table")

    if table_dim == 1:
        td = np.asarray(h5lite.read(thermo_file)["T_energy_R_c"])
        T, e, R, c = td[:, 0], td[:, 1], td[:, 2], td[:, 3]
        mixture = LteMixture(
            dim=dim, nvel=nvel,
            energy_table=LinearTable(x=T, f=e),
            R_table=LinearTable(x=T, f=R),
            c_table=LinearTable(x=T, f=c),
            T_table=LinearTable(x=e, f=T),
        )
        tr = np.asarray(h5lite.read(trans_file)["T_mu_kappa_sigma"])
        Tt = tr[:, 0]
        transport = LteTransport(
            mu_table=LinearTable(x=Tt, f=tr[:, 1]),
            kappa_table=LinearTable(x=Tt, f=tr[:, 2]),
            sigma_table=LinearTable(x=Tt, f=tr[:, 3]),
        )
        return mixture, transport

    if table_dim != 2:
        raise ValueError("flow/lte/table_dim must be 1 or 2")

    e_rev_file = inp.get_required(f"{prefix}/e_rev_table")
    mixture = LteMixture(
        dim=dim, nvel=nvel,
        energy_table=_grid2d(thermo_file, 0, 1, 3),
        R_table=_grid2d(thermo_file, 0, 1, 6),
        c_table=_grid2d(thermo_file, 0, 1, 8),
        T_table=_grid2d(e_rev_file, 0, 1, 2),
    )
    transport = LteTransport(
        mu_table=_grid2d(trans_file, 0, 1, 2),
        kappa_table=_grid2d(trans_file, 0, 1, 3),
        sigma_table=_grid2d(trans_file, 0, 1, 4),
    )
    return mixture, transport
