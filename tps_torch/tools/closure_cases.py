"""Face-sweep cases of the viscous flux's closures and of the Roe flux:
the contexts, tables and states that `chip_smoke.py` (phase 44) and
tests/test_torch_cuda.py hold each kernel variant against its plain
version with.

A case is a base variant (`BASES`: DryAir planar 2-D or 3-D or
axisymmetric, the argon ternary likewise, DryAir with Roe in 2-D or 3-D)
with one closure or all of them (`CLOSURES`), on a box of n elements a
side at p=2 on the Gauss-Legendre basis, every face of the box a wall
for the wall distance.  The closures' constants are the solver's defaults
(Smagorinsky 0.12, Sigma 0.135), the mixing length's largest length a
fifth of the box and the sponge's plane across its middle (ratio 10, a
twentieth of the box wide), so that each changes the flux.  The state is
a smooth seeded perturbation in every velocity, with swirl on the
axisymmetric boxes.

    from tps_torch.tools.closure_cases import closure_case
    ctx, tab_np, Up = closure_case("argon_axi", "all", 8)
"""

from __future__ import annotations

import os

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
# the argon ternary with argon_minimal transport (the torch decks')
ARGON_DECK = os.path.join(_HERE, "argon_torch_axisym.ini")

# base variant -> (fluid, dim, axisymmetric, Roe)
BASES = {"dry_air_2d": ("dry_air", 2, False, False),
         "dry_air_3d": ("dry_air", 3, False, False),
         "dry_air_axi": ("dry_air", 2, True, False),
         "argon_2d": ("argon", 2, False, False),
         "argon_3d": ("argon", 3, False, False),
         "argon_axi": ("argon", 2, True, False),
         "dry_air_roe_2d": ("dry_air", 2, False, True),
         "dry_air_roe_3d": ("dry_air", 3, False, True)}
# "all": the mixing length, the sponge and an SGS model (Smagorinsky in
# 2-D, where Sigma is zero; Sigma in 3-D)
CLOSURES = ("none", "smagorinsky", "sigma", "sponge", "mixing", "all")


def closure_fluxes(mix, transport, closure, L, eq="navier-stokes",
                   axisymmetric=False):
    """Fluxes with `closure` (`CLOSURES`) on a box of side L."""
    from ..dg.fluxes import Fluxes, PlanarViscousSponge
    from ..dg.sgs import Sigma, Smagorinsky
    from ..physics.transport import MixingLengthTransport

    on = (lambda c: closure in (c, "all"))
    if transport is not None and on("mixing"):
        transport = MixingLengthTransport(molecular=transport,
                                          max_mixing_length=0.2 * L,
                                          Prt=0.9, bulk_mult=0.1)
    model = None
    if closure == "smagorinsky" or (closure == "all" and mix.dim == 2):
        model = Smagorinsky(mixture=mix)
    elif closure == "sigma" or closure == "all":
        model = Sigma(mixture=mix)
    sponge = (PlanarViscousSponge(point=(0.0, 0.5 * L, 0.0),
                                  normal=(0.0, 1.0, 0.0), width=0.05 * L,
                                  ratio=10.0) if on("sponge") else None)
    return Fluxes(mixture=mix, transport=transport, eq_system=eq,
                  axisymmetric=axisymmetric, sgs_model=model,
                  visc_sponge=sponge)


_TABLES = {}


def _tables(dim, axisymmetric, n, L):
    """Numpy tables of an n-a-side box (n an int or a tuple) of side L,
    p=2 GL, with the wall distance to every boundary patch; built once
    per box."""
    n = (n,) * dim if isinstance(n, int) else tuple(n)
    key = (dim, axisymmetric, n, L)
    if key not in _TABLES:
        _TABLES[key] = _build_tables(dim, axisymmetric, n, L)
    return _TABLES[key]


def _build_tables(dim, axisymmetric, n, L):
    from ..dg.discretization import build_tables
    from ..mesh.generators import box_2d, box_3d

    if dim == 2:
        mesh = box_2d(*n, x1=L, y1=L)
    else:
        mesh = box_3d(*n, bounds=((0.0, L), (0.0, L), (0.0, L)))
    t = build_tables(mesh, order=2, axisymmetric=axisymmetric)
    # the distance to the nearest face of the box, every face a wall (the
    # exact distance, where utils/wall_distance.py samples the walls'
    # quadrature points, whose cost grows with nodes x wall points)
    def dist(x):
        return np.min(np.minimum(x, L - x), axis=-1)

    t.distance, t.f_dist = dist(t.xyz_dof), dist(t.f_xyz)
    t.dist_slot = dist(t.xyz_slot)
    return t


def _waves(xyz, L, seed, count):
    """count smooth seeded fields in [-1, 1] at points xyz [..., dim]."""
    rng = np.random.default_rng(seed)
    k = 2.0 * np.pi / L
    out = []
    for _ in range(count):
        a = rng.uniform(-1.0, 1.0, xyz.shape[-1])
        ph = rng.uniform(0.0, 2.0 * np.pi, xyz.shape[-1])
        out.append(np.prod(np.cos(k * a * xyz + ph), axis=-1))
    return out


def closure_case(base, closure, n, eq="navier-stokes", seed=0):
    """(RHS context, numpy tables, primitives [ne, ndof, neq]) of a base
    variant (`BASES`) with a closure (`CLOSURES`) on an n-a-side box."""
    from ..config.ini import IniInput
    from ..dg.rhs import RHSContext
    from ..dg.riemann import Roe, Rusanov
    from ..physics.gas import DryAir
    from ..physics.plasma_config import build_plasma
    from ..physics.transport import DryAirTransport

    fluid, dim, axi, roe = BASES[base]
    nvel = 3 if axi else dim
    if fluid == "dry_air":
        L = 1.0
        mix = DryAir(dim=dim, nvel=nvel)
        tr = None if eq == "euler" else DryAirTransport(
            mix.gas_constant, mix.specific_heat_ratio)
    else:
        L = 0.01
        pl = build_plasma(IniInput.read(ARGON_DECK), dim, nvel)
        mix, tr = pl.mixture, None if eq == "euler" else pl.transport
    fl = closure_fluxes(mix, tr, closure, L, eq, axi)
    ctx = RHSContext(fluxes=fl, riemann=(Roe if roe else Rusanov)(fl))
    tab = _tables(dim, axi, n, L)
    xyz = tab.xyz_dof
    w = _waves(xyz, L, seed, 5)
    Up = np.zeros(xyz.shape[:-1] + (mix.num_equations,))
    if fluid == "dry_air":
        Up[..., 0] = 1.2 * (1 + 0.05 * w[0])
        Up[..., nvel + 1] = 300.0 + 20.0 * w[1]
        swirl = 5.0
    else:
        Up[..., 0] = 1.6 * (1 + 0.05 * w[0])
        Up[..., nvel + 1] = 1800.0 * (1 + 0.05 * w[1])
        Up[..., nvel + 2] = 1e-3 * 1.6 / mix.mw[0] * (1 + 0.2 * w[2])
        Up[..., nvel + 3] = 9000.0 * (1 - 0.1 * w[3])
        swirl = 500.0
    for d in range(dim):
        Up[..., 1 + d] = (10.0 if d == 1 else 0.0) + 3.0 * w[(d + 2) % 5]
    if axi:
        Up[..., 3] = swirl * xyz[..., 0] * (1 + 0.1 * w[4])
    return ctx, tab, Up
