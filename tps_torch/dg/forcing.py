"""Pointwise forcings of the compressible DG right-hand side, on torch
tensors.

The JAX package's dg/forcing.py (reference: src/forcing_terms.cpp).  Each
forcing is a callable (t, tab, U, Up, grad_up, fields) -> its part of
dU/dt, added after the inverse mass (dg/rhs.py).  Every constant a
forcing reads (a vector of the deck, a mask or ramp on the solution
nodes, a sponge target) is made on its first call, once per dtype and
device (per table for the nodal ones, through dg/operators.py::_const),
so a captured step graph copies nothing from the host; the time t is a
device scalar of the step loop.

- ConstantPressureGradient (tps_tpu/dg/forcing.py:20-44; reference:
  src/forcing_terms.cpp:115-172): an imposed dp/dx, with its work u.grad p
  and p div u on the energy.
- HeatSource (:47-70): a uniform volumetric heating inside a cylinder.
- sponge_target_conserved (:73-102), at set-up in numpy: the conserved
  target of a userDef sponge, its energy set from the pressure (on a
  two-temperature mixture the electron energy from the deck's T_e).
- SpongeZone (:105-207; reference: src/forcing_terms.cpp:480-744):
  planar or annulus damping toward a userDef or mixedOut target; the
  annulus rotates its cylindrical target velocity into Cartesian at each
  node, with the axis divide guarded by `where` (the JAX package's
  maximum(R, 1e-300) floor underflows in float32).  The mixedOut target,
  the mean convective flux over the sampling plane inverted to a state,
  is formed on the device each call.
- AxisymmetricSource (:210-249; reference: src/forcing_terms.cpp:255-380):
  the geometric source of the (r, z) + swirl formulation.  Its nodal
  radius is clamped at 1e-14 as in the JAX package (Gauss-Legendre nodes
  lie off the axis).
- PassiveScalar (:252-273; reference: src/forcing_terms.cpp:820-842):
  the last equation relaxed toward rho Z in a ball.  A module only: no
  configuration builds it (solvers/compressible.py refuses passive
  scalars, ROADMAP C).
- JouleHeating (:275-293; reference: src/forcing_terms.cpp:443-472): the
  EM Joule heating q >= 0 added to the total energy and, for a
  two-temperature mixture, to the electron energy.  The JAX package reads
  q from the RHS's `fields` dict; here q is a device tensor [ne, ndof]
  that the coupling fills with `copy_` (solvers/compressible.py::
  set_joule_heating), so a captured step graph reads every EM update.
- make_mms_forcing (:296-322): f = dU*/dt - RHS(U*(t)) of an analytic
  primitive field, dU*/dt by torch.func.jacfwd.  Kept as a module held
  to the JAX package's: no configuration builds it, the solver's MMS
  decks take their source from utils/masa.py::MasaHandler (the
  reference's pointwise MASA source, not a DG residual).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .operators import _const


def _vec(obj, name, values, like):
    """The numbers `values` as a tensor of like's dtype and device, made on
    the first call and kept on obj (a forcing's deck constants)."""
    cache = obj.__dict__.setdefault("_consts", {})
    key = (name, like.dtype, like.device)
    if key not in cache:
        cache[key] = torch.as_tensor(np.asarray(values, dtype=np.float64),
                                     dtype=like.dtype, device=like.device)
    return cache[key]


@dataclass(frozen=True, eq=False)
class ConstantPressureGradient:
    """Imposed pressure gradient driving (e.g. channel flow):
    d(rho u_d)/dt -= dp/dx_d ; d(rhoE)/dt -= u_d dp/dx_d + p d(u_d)/dx_d."""

    mixture: object
    press_grad: tuple  # dim components

    def __call__(self, t, tab, U, Up, grad_up, fields=None):
        mix = self.mixture
        dim = mix.dim
        g = _vec(self, "g", self.press_grad[:dim], U)
        p = mix.pressure_from_primitives(Up)
        work = -torch.einsum("...d,d->...", Up[..., 1 : 1 + dim], g)
        if grad_up is not None:
            divu = torch.diagonal(grad_up[..., 1 : 1 + dim, :dim], dim1=-2,
                                  dim2=-1).sum(-1)
            work = work - p * divu
        zero = torch.zeros_like(p)
        cols = [zero] * mix.num_equations
        for d in range(dim):
            cols[1 + d] = (-g[d]).expand_as(p)
        cols[mix.i_th] = work
        return torch.stack(cols, dim=-1)


@dataclass(frozen=True, eq=False)
class HeatSource:
    """Uniform volumetric heat source inside a cylinder region (reference:
    src/forcing_terms.hpp:202): the axis from point1 to point2, radius."""

    mixture: object
    value: float
    point1: tuple
    point2: tuple
    radius: float

    def heating(self, tab, like):
        """value inside the cylinder, 0 outside, at the solution nodes."""
        def build():
            xyz = tab.xyz_dof
            kw = {"dtype": xyz.dtype, "device": xyz.device}
            dim = xyz.shape[-1]
            p1 = torch.as_tensor(self.point1[:dim], **kw)
            p2 = torch.as_tensor(self.point2[:dim], **kw)
            axis = p2 - p1
            s = (torch.einsum("...d,d->...", xyz - p1, axis)
                 / torch.sum(axis * axis))
            r = torch.linalg.norm(xyz - (p1 + s[..., None] * axis), dim=-1)
            inside = (s >= 0) & (s <= 1) & (r <= self.radius)
            return torch.where(inside, torch.full_like(s, self.value), 0.0)
        key = ("heat_source", self.point1, self.point2, self.radius,
               self.value)
        return _const(tab, key, like, build)

    def __call__(self, t, tab, U, Up, grad_up, fields=None):
        mix = self.mixture
        q = self.heating(tab, U)
        cols = [torch.zeros_like(q)] * mix.num_equations
        cols[mix.i_th] = q
        return torch.stack(cols, dim=-1)


def sponge_target_conserved(mixture, rho, vel, pressure, mass_fracs=(),
                            electron_temp=None, single_temperature=False):
    """Conserved sponge target from the deck's userDef primitives
    (reference: src/forcing_terms.cpp:486-518): density, velocity, species
    mass fractions, then the total energy set by
    `modify_energy_for_pressure`; on a two-temperature mixture the electron
    energy n_e cv_e T_e from the deck's electron temperature (unless
    single_temperature).  In float64 at set-up; a tuple of floats."""
    f64 = torch.float64
    nvel = getattr(mixture, "nvel", mixture.dim)
    cons = np.zeros(mixture.num_equations)
    cons[0] = rho
    for d in range(nvel):
        cons[1 + d] = rho * vel[d]
    for sp in range(mixture.num_active_species):
        cons[nvel + 2 + sp] = rho * mass_fracs[sp]
    modify_electron = True
    if mixture.two_temperature:
        modify_electron = bool(single_temperature)
        if not modify_electron:
            c = torch.as_tensor(cons, dtype=f64)
            ne = float(mixture.number_densities(c)[mixture.i_electron])
            cv_e = float(mixture.molar_cv(c)[mixture.i_electron])
            cons[mixture.num_equations - 1] = ne * cv_e * electron_temp
    out = mixture.modify_energy_for_pressure(
        torch.as_tensor(cons, dtype=f64), torch.tensor(pressure, dtype=f64),
        modify_electron_energy=modify_electron)
    return tuple(float(v) for v in out)


@dataclass(frozen=True, eq=False)
class SpongeZone:
    """Sponge zone: damp the state toward a target between two planes
    (reference: src/forcing_terms.cpp:480-710):

        dU/dt -= c_target * mult * sigma(x) * (U - U_target)

    Planar: sigma = distInit / L^2 inside the slab between the plane
    through `p_init` and the plane through `p0` (normal `n` points from the
    p0 side toward p_init; distInit = -n.(x - p_init), distF = n.(x - p0),
    both > 0 inside, L = distInit + distF).  Annulus: sigma = (R - r1) /
    (r2 - r1)^2 for the radius R about the axis through `p_init` along n,
    and the target velocity is cylindrical (V_r, V_theta, V_axial), rotated
    into Cartesian at each node (reference: src/forcing_terms.cpp:590-630,
    667-709).  mixedOut: the target is the state whose convective normal
    flux is the mean over the nodes within `tol` of the pInit plane
    (planar) or the r1 cylinder (annulus)."""

    mixture: object
    target_u: tuple | None  # conserved target (sponge_target_conserved);
    #                         None for the mixedOut dynamic target
    normal: tuple
    p0: tuple
    p_init: tuple
    mult: float = 1.0
    sz_type: str = "planar"  # "planar" | "annulus"
    r1: float = 0.0
    r2: float = 0.0
    sol_type: str = "userDef"  # "userDef" | "mixedOut"
    tol: float = 1e-5  # mixed-out plane node search tolerance
    fluxes: object = None  # convective flux evaluator (mixedOut only)

    def unit_normal(self):
        n = np.asarray(self.normal[: self.mixture.dim], float)
        return n / np.linalg.norm(n)

    def geometry(self, tab, like):
        """Per table, at the solution nodes [ne, ndof, k]: sigma, the
        mixedOut sampling weight (1 within tol of the sampling plane),
        and, for the annulus, the unit radial and azimuthal vectors (dim
        columns each)."""
        def build():
            xyz = tab.xyz_dof
            kw = {"dtype": xyz.dtype, "device": xyz.device}
            dim = self.mixture.dim
            n = torch.as_tensor(self.unit_normal(), **kw)
            p0 = torch.as_tensor(self.p0[:dim], **kw)
            pi = torch.as_tensor(self.p_init[:dim], **kw)
            dist_init = -torch.einsum("...d,d->...", xyz - pi, n)
            dist_f = torch.einsum("...d,d->...", xyz - p0, n)
            inside = (dist_init > 0.0) & (dist_f > 0.0)
            if self.sz_type == "planar":
                L = dist_init + dist_f
                sigma = torch.where(inside, dist_init / (L * L), 0.0)
                on_plane = torch.abs(dist_init) < self.tol
                return torch.stack([sigma, on_plane.to(xyz.dtype)], -1)
            radial = xyz - pi + dist_init[..., None] * n
            R = torch.linalg.norm(radial, dim=-1)
            inside = inside & (R > self.r1)
            dr = self.r2 - self.r1
            sigma = torch.where(inside, (R - self.r1) / (dr * dr), 0.0)
            pos = R > 0
            ur = torch.where(pos[..., None],
                             radial / torch.where(pos, R, 1.0)[..., None], 0.0)
            if dim == 3:
                uth = torch.linalg.cross(n.expand_as(ur), ur, dim=-1)
            else:
                uth = torch.stack([-ur[..., 1], ur[..., 0]], dim=-1)
            on_plane = torch.abs(R - self.r1) < self.tol
            return torch.cat([sigma[..., None], on_plane.to(xyz.dtype)[..., None],
                              ur, uth], -1)
        key = ("sponge", self.sz_type, self.normal, self.p0, self.p_init,
               self.r1, self.r2, self.tol)
        return _const(tab, key, like, build)

    def _mixed_out_target(self, U, n, w):
        """Per-step mixed-out target: the mean convective normal flux over
        the sampling nodes, inverted to a conserved state (reference:
        SpongeZone::computeMixedOutValues, src/forcing_terms.cpp:712-744),
        on the device."""
        F = self.fluxes.convective(U)  # [..., neq, dim]
        Fn = torch.einsum("...qd,d->...q", F[..., : n.shape[0]], n)
        mean_flux = torch.einsum("...q,...->q", Fn, w) / torch.sum(w)
        return self.mixture.conserved_from_convective_flux(mean_flux, n)

    def _target(self, U, n, geo):
        """(conserved target [neq], its sound speed); a userDef one is
        made once per dtype and device."""
        mix = self.mixture

        def speed(target):
            return mix.sound_speed_from_T(mix.primitives(target)[mix.i_th])

        if self.sol_type == "mixedOut":
            target = self._mixed_out_target(U, n, geo[..., 1])
            return target, speed(target)
        target = _vec(self, "target", self.target_u, U)
        cache = self.__dict__["_consts"]
        key = ("c", U.dtype, U.device)
        if key not in cache:
            cache[key] = speed(target)
        return target, cache[key]

    def __call__(self, t, tab, U, Up, grad_up, fields=None):
        mix = self.mixture
        dim = mix.dim
        geo = self.geometry(tab, U)
        n = _vec(self, "normal", self.unit_normal(), U)
        target, c = self._target(U, n, geo)
        U_t = target
        if self.sz_type == "annulus":
            mom = target[1 : 1 + dim]
            v_cart = (mom[0] * geo[..., 2 : 2 + dim]
                      + mom[1] * geo[..., 2 + dim : 2 + 2 * dim])
            if dim == 3:
                v_cart = v_cart + mom[2] * n
            lead = v_cart.shape[:-1]
            U_t = torch.cat([target[:1].expand(lead + (1,)), v_cart,
                             target[1 + dim :].expand(
                                 lead + (target.shape[0] - 1 - dim,))], -1)
        return -(c * self.mult) * geo[..., :1] * (U - U_t)


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


@dataclass(frozen=True, eq=False)
class AxisymmetricSource:
    """Geometric source terms of the axisymmetric (r, z) + swirl state:
       d(rho u_r)/dt     += (p + rho u_t^2 - tau_tt) / r
       d(rho u_theta)/dt += (-rho u_r u_theta + tau_tr) / r
    with tau_tt = 2 mu u_r/r + (mu_b - 2/3 mu) div(u) and
    tau_tr = mu (du_t/dr - u_t/r); the viscous parts on Navier-Stokes."""

    mixture: object
    fluxes: object  # its transport gives the viscous parts

    def __call__(self, t, tab, U, Up, grad_up, fields=None):
        mix = self.mixture
        r = _const(tab, ("axi_radius",), U,
                   lambda: torch.clamp(tab.xyz_dof[..., 0], min=1e-14))
        rho, ur, ut = Up[..., 0], Up[..., 1], Up[..., 3]
        p = mix.pressure_from_primitives(Up)
        src_r = p + rho * ut * ut
        src_t = -rho * ur * ut
        fl = self.fluxes
        if fl is not None and fl.eq_system != "euler" and grad_up is not None:
            props = fl.transport.flux_properties(mix, U, Up, grad_up)
            visc = props["visc"]
            bulk = props["bulk_visc"] - (2.0 / 3.0) * visc
            div_v = grad_up[..., 1, 0] + grad_up[..., 2, 1] + ur / r
            src_r = src_r - (2.0 * visc * ur / r + bulk * div_v)
            src_t = src_t + visc * (grad_up[..., 3, 0] - ut / r)
        zero = torch.zeros_like(p)
        cols = [zero] * mix.num_equations
        cols[1] = src_r / r
        cols[3] = src_t / r
        return torch.stack(cols, dim=-1)


@dataclass(frozen=True, eq=False)
class PassiveScalar:
    """Passive-scalar injection: relax the last equation toward rho*Z inside
    a ball of given radius around `xyz`, at the local advective rate
    (reference: src/forcing_terms.cpp:820-842)."""

    mixture: object
    xyz: tuple
    radius: float
    value: float

    def __call__(self, t, tab, U, Up, grad_up, fields=None):
        mix = self.mixture
        dim = mix.dim
        x0 = _vec(self, "x0", self.xyz[:dim], U)
        inside = torch.linalg.norm(tab.xyz_dof - x0, dim=-1) <= self.radius
        vel = torch.linalg.norm(Up[..., 1 : 1 + dim], dim=-1)
        rate = -vel * (U[..., -1] - U[..., 0] * self.value) / self.radius
        zero = torch.zeros_like(rate)
        cols = [zero] * mix.num_equations
        cols[-1] = torch.where(inside, rate, 0.0)
        return torch.stack(cols, dim=-1)


def make_mms_forcing(exact_primitive_fn, ctx, tab):
    """Manufactured-solution forcing f = dU*/dt - RHS(U*(t)) of an analytic
    primitive field exact_primitive_fn(xyz, t) (torch ops), the MASA
    forcings' role (reference: src/forcing_terms.hpp:224,
    src/masa_handler.cpp): dU*/dt by torch.func.jacfwd, RHS the DG
    residual of ctx without its forcings."""
    from .rhs import compute_rhs

    ctx = dataclasses.replace(ctx, forcings=())  # no self-recursion
    mix = ctx.fluxes.mixture

    def exact_U(t):
        return mix.conservatives(exact_primitive_fn(tab.xyz_dof, t))

    def forcing(t, tab_in, U, Up, grad_up, fields=None):
        xyz = tab_in.xyz_dof
        t = torch.as_tensor(t, dtype=xyz.dtype, device=xyz.device)
        dUdt = torch.func.jacfwd(exact_U)(t)
        rhs_exact, _ = compute_rhs(ctx, tab_in, exact_U(t), t)
        return dUdt - rhs_exact

    return forcing
