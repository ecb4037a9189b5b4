"""Compressible Navier-Stokes DG solver (the M2ulPhyS analog), PyTorch.

This slice carries single-device runs on generated boxes (mesh
generators), DryAir with Sutherland or constant transport, Rusanov,
explicit RK, and two right-hand sides:

- the fused path (periodic boxes, collocated Gauss-Legendre basis): on a
  CUDA device the two hand-written kernels of dg/cuda_fused.py, on the
  CPU their plain PyTorch version (dg/fused.py, also the 2-D case);
- the general (slot) path, dg/rhs.py::SlotRHS, for everything else:
  walls, inlets and outlets (dg/bc.py), and the reference-default
  Gauss-Lobatto basis.  Its interior face sweep is the hand-written
  CUDA kernel of dg/cuda_faces.py on a CUDA device, the plain version on
  the CPU.

Every input key outside the slice raises NotImplementedError naming the
ROADMAP item that ports it.

Mirrors the reference solver's structure (reference: src/M2ulPhyS.cpp):
CFL timestep control uses dt = CFL * hmin / max_char_speed / dim
(reference: src/M2ulPhyS.cpp:2013-2016), kept as a device scalar so the
step loop never waits on the device; the NaN guard (reference:
src/M2ulPhyS.cpp:2463-2525) checks every step's max characteristic speed
from a device buffer that is read at the timing cadence and at the end.
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from ..config.run_config import RunConfiguration
from ..dg.bc import InletBC, OutletBC, WallBC
from ..dg.cuda_faces import build_face_sweep
from ..dg.cuda_fused import build_cuda_fused, cuda_fusable
from ..dg.discretization import build_tables
from ..dg.fluxes import Fluxes
from ..dg.fused import maybe_build_fused
from ..dg.rhs import (RHSContext, SlotRHS, advance_bc_states, bc_slices,
                      init_bc_states)
from ..dg.riemann import Rusanov
from ..mesh import generators
from ..physics.gas import DryAir
from ..physics.transport import ConstantTransport, DryAirTransport
from ..time.integrators import get_integrator
from ..utils.cases import isentropic_vortex, taylor_green_2d, uniform_state
from .base import SOLVER_REGISTRY, PlasmaSolver

STATUS_EARLY_EXIT = 10  # status of a run ended by a DIE file


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported to tps_torch yet "
                               f"(ROADMAP {item})")


def _flag(gen, key):
    return gen.get(key, "0") in ("1", "true", "True")


def _build_mesh(rc: RunConfiguration):
    """Mesh from the [mesh] generator section (box2d / box3d)."""
    gen = rc.mesh_generator
    if not gen:
        if rc.mesh:
            raise _not_ported("reading mesh files ([flow]/mesh)", "A5")
        raise ValueError("no mesh specified ([flow]/mesh or [mesh] generator)")
    kind = gen.get("generator", "box2d")
    if kind == "box2d":
        return generators.box_2d(
            nx=int(gen.get("nx", 8)),
            ny=int(gen.get("ny", 8)),
            x0=float(gen.get("x0", 0.0)),
            x1=float(gen.get("x1", 1.0)),
            y0=float(gen.get("y0", 0.0)),
            y1=float(gen.get("y1", 1.0)),
            periodic_x=_flag(gen, "periodic_x"),
            periodic_y=_flag(gen, "periodic_y"),
        )
    if kind == "box3d":
        return generators.box_3d(
            nx=int(gen.get("nx", 8)),
            ny=int(gen.get("ny", 8)),
            nz=int(gen.get("nz", 8)),
            bounds=(
                (float(gen.get("x0", 0.0)), float(gen.get("x1", 1.0))),
                (float(gen.get("y0", 0.0)), float(gen.get("y1", 1.0))),
                (float(gen.get("z0", 0.0)), float(gen.get("z1", 1.0))),
            ),
            periodic=(_flag(gen, "periodic_x"), _flag(gen, "periodic_y"),
                      _flag(gen, "periodic_z")),
        )
    if kind in ("box2d_tri", "annulus2d", "annulus"):
        raise _not_ported(f"the '{kind}' mesh generator", "A5")
    raise ValueError(f"unknown mesh generator '{kind}'")


# input keys outside this slice: (ini key, what it enables, ROADMAP item)
_UNPORTED_KEYS = (
    ("io/enableRestart", "restart read", "A4.1"),
    ("io/restartCycle", "restart read", "A4.1"),
    ("io/restartFromLTE", "LTE restart conversion", "A6"),
    ("jobManagement/enableAutoRestart", "auto-restart checkpoints", "A4.1"),
    ("mesh/partitions", "domain decomposition", "A8"),
    ("io/enableHistory", "the history file", "A12"),
    ("io/enableParaview", "ParaView output", "A12"),
    ("planeDump/isEnabled", "plane dumps", "A12"),
    ("flow/computeDistance", "wall distance", "A5"),
    ("flow/useMixingLength", "the mixing-length closure", "A5"),
    ("viscosityMultiplierFunction/isEnabled", "the viscous sponge", "A5"),
    ("flow/enablePressureForcing", "pressure forcing", "A5"),
    ("heatSource/numHeatSources", "heat sources", "A5"),
    ("spongezone/numSpongeZones", "sponge zones", "A5"),
    ("passiveScalars/numScalars", "passive scalars", "A6"),
    ("mms/isEnabled", "manufactured solutions", "A5"),
)


# boundary-condition types of this slice (dg/bc.py); the rest is A5
_WALL_KINDS = ("inviscid", "slip", "viscous_adiabatic", "viscous_isothermal")
_INLET_KINDS = ("subsonic",)
_OUTLET_KINDS = ("subsonicPressure",)
_BC_KINDS = _WALL_KINDS + _INLET_KINDS + _OUTLET_KINDS


def check_slice(rc: RunConfiguration):
    """Raise NotImplementedError for any input this slice does not run."""
    if rc.fluid != "dry_air":
        raise _not_ported(f"fluid '{rc.fluid}'", "A6")
    if rc.equation_system not in ("euler", "navier-stokes"):
        raise _not_ported(f"equation system '{rc.equation_system}'", "A6")
    if rc.use_roe:
        raise _not_ported("the Roe flux", "A1")
    if rc.axisymmetric:
        raise _not_ported("axisymmetric flow", "A5")
    if rc.sgs_model != "none":
        raise _not_ported(f"the '{rc.sgs_model}' SGS model", "A5")
    for spec in rc.bcs:
        if spec.kind not in _BC_KINDS:
            raise _not_ported(f"boundary condition type '{spec.kind}'", "A5")
    if rc.avg_enabled:
        raise _not_ported("running statistics ([averaging])", "A12")
    raw = rc.raw
    if raw is None:
        return
    for key, what, item in _UNPORTED_KEYS:
        if raw.has(key) and _enabled(raw, key):
            section, name = key.split("/", 1)
            raise _not_ported(f"{what} ([{section}] {name})", item)


def _enabled(raw, key):
    v = str(raw.values[key]).strip("'\" ").lower()
    if key == "mesh/partitions":
        return v not in ("", "0", "1")
    return v not in ("", "0", "false", "no", "off")


class CompressibleSolver(PlasmaSolver):
    """Explicit DG compressible flow solver on one device."""

    def __init__(self, config, tps=None, device=None):
        super().__init__(config, tps=tps)
        if device is None:
            device = getattr(tps, "device", None) or "cuda"
        self.device = torch.device(device)

    def initialize(self):
        rc = self.config
        check_slice(rc)
        self.dtype = torch.get_default_dtype()

        self.mesh = getattr(self, "_premade_mesh", None)
        if self.mesh is None:
            self.mesh = _build_mesh(rc)
        basis = "gauss-legendre" if rc.basis_type == 0 else "gauss-lobatto"
        quad_rule = ("gauss-legendre" if rc.integration_rule == 0
                     else "gauss-lobatto")
        quad_kw = {"quad_rule": quad_rule}
        if rc.raw is not None:
            fqo = int(rc.raw.get("flow/faceQuadOrder", 0) or 0)
            vqo = int(rc.raw.get("flow/volQuadOrder", 0) or 0)
            if fqo > 0:
                quad_kw["face_quad_order"] = fqo
            if vqo > 0:
                quad_kw["vol_quad_order"] = vqo
        self.tables_np = build_tables(self.mesh, order=rc.order, basis=basis,
                                      **quad_kw)
        self.tables = self.tables_np.to_torch(self.dtype, self.device)

        dim = self.mesh.dim
        self._build_physics(dim, dim)
        # boundary conditions: per-attr static slices over sorted bdr faces
        self.bc_slices = self._build_bcs()
        self._report_bc_patches()
        self.ctx = RHSContext(fluxes=self.fluxes, riemann=self.riemann,
                              bcs=tuple(self.bc_slices))
        print("flow: tps_torch writes no checkpoints yet (ROADMAP A4.1); "
              "[flow] outputFreq is ignored", flush=True)
        self._initialize_state_and_loop()

    # ------------------------------------------------------------------
    def _build_physics(self, dim, nvel):
        """Mixture, transport, fluxes and Riemann solver."""
        rc = self.config
        self.mixture = DryAir(dim=dim, nvel=nvel)
        if rc.equation_system == "euler":
            transport = None
        elif rc.transport_model == "constant":
            raw = rc.raw
            transport = ConstantTransport(
                visc=raw.get("plasma_models/transport_model/constant/viscosity", 0.0),
                bulk_visc=raw.get("plasma_models/transport_model/constant/bulkViscosity", 0.0),
                kappa=raw.get("plasma_models/transport_model/constant/thermalConductivity", 0.0),
            )
        else:
            transport = DryAirTransport(
                gas_constant=self.mixture.gas_constant,
                specific_heat_ratio=self.mixture.specific_heat_ratio,
                visc_mult=rc.visc_mult,
                bulk_visc_mult=rc.bulk_visc_mult,
            )
        self.fluxes = Fluxes(mixture=self.mixture, transport=transport,
                             eq_system=rc.equation_system)
        self.riemann = Rusanov(self.fluxes)

    def _build_rhs(self):
        """K1+K2 where their preconditions hold; the plain fused RHS for
        the CPU's other fused-path boxes (2-D), as the JAX package picks
        its fused path; the slot path (with the face-sweep kernel on a
        CUDA device) for everything else."""
        if cuda_fusable(self.tables_np, self.ctx):
            return build_cuda_fused(self.tables_np, self.ctx, self.dtype,
                                    self.device)
        if self.device.type == "cpu":
            fused = maybe_build_fused(self.tables_np, self.ctx, self.dtype,
                                      self.device)
            if fused is not None:
                return fused
        return SlotRHS(ctx=self.ctx, tab=self.tables,
                       sweep=build_face_sweep(self.tables, self.ctx))

    # ------------------------------------------------------------------
    def _build_bcs(self):
        """One BCSlice per configured patch that has boundary faces."""
        specs = {spec.patch: spec for spec in self.config.bcs}
        return list(bc_slices(
            self.tables_np.f_bdr_attr,
            lambda p: self._make_bc(specs[p]) if p in specs else None))

    def _make_bc(self, spec):
        kind = spec.kind
        p = spec.params

        def fget(key, default=None):
            if key in p:
                return float(str(p[key]).strip("'\""))
            return default

        if kind in _WALL_KINDS:
            return WallBC(kind=kind, wall_temp=fget("temperature", 300.0))
        if kind == "subsonic":
            rho = fget("density")
            uvw = [float(x) for x in
                   str(p.get("uvw", "0 0 0")).strip().strip("'\"").split()]
            return InletBC(input_state=(rho, *uvw[: self.mixture.nvel]))
        if kind == "subsonicPressure":
            return OutletBC(pressure=fget("pressure"))
        raise _not_ported(f"boundary condition type '{kind}'", "A5")

    def _report_bc_patches(self):
        """Per-patch surface area / face-count report at BC init, matching
        the reference's inlet/outlet constructor logs (src/inletBC.cpp:311-312,
        src/outletBC.cpp:339-340)."""
        attrs = np.asarray(self.tables_np.f_bdr_attr)
        for spec in self.config.bcs:
            nfaces = int(np.count_nonzero(attrs == spec.patch))
            if spec.kind in _INLET_KINDS:
                print(f"[INLET]: Total Surface Area                = "
                      f"{self._patch_area(spec):.5e}", flush=True)
                print(f"[INLET]: # of boundary faces               = "
                      f"{nfaces}", flush=True)
            elif spec.kind in _OUTLET_KINDS:
                print(f"[OUTLET]: Total Surface Area                = "
                      f"{self._patch_area(spec):.5f}", flush=True)
                print(f"[OUTLET]: # of boundary faces               = "
                      f"{nfaces}", flush=True)

    def _patch_area(self, spec):
        """Quadrature area of a boundary patch."""
        tab = self.tables_np
        sel = np.asarray(tab.f_bdr_attr) == spec.patch
        nrm = np.linalg.norm(np.asarray(tab.f_nor[tab.nfi :])[sel], axis=-1)
        return float(np.sum(np.asarray(tab.f_wts[tab.nfi :])[sel] * nrm))

    def _initialize_state_and_loop(self):
        """IC, RHS, CFL/dt, NaN-guard buffer."""
        rc = self.config
        dim = self.mesh.dim
        self.U = self._initial_condition()
        self.time = 0.0
        self.iter = 0
        self.hmin = float(np.min(self.tables_np.delta) * max(rc.order, 1))
        self._integrator = get_integrator(rc.integrator)
        self._rhs = self._build_rhs()
        if self.ctx.bcs:
            self._rhs.bc_states = init_bc_states(self.ctx, self.tables, self.U)

        # initial dt (reference: M2ulPhyS::initialTimeStep)
        if rc.dt_fixed > 0:
            self.dt = rc.dt_fixed
        else:
            mcs0 = float(torch.amax(self.mixture.max_char_speed(self.U)))
            self.dt = rc.cfl * self.hmin / mcs0 / dim

        # every step's max char speed lands here on the device; the NaN
        # guard reads the filled part at the timing cadence and at the end
        self._mcs_buf = torch.empty(max(rc.timing_freq, 1), dtype=self.dtype,
                                    device=self.device)
        self._mcs_n = 0
        self._wall0 = _time.perf_counter()

    def _initial_condition(self):
        rc = self.config
        mix = self.mixture
        xyz = self.tables.xyz_dof
        if rc.ic.case == "isentropic_vortex":
            return mix.conservatives(isentropic_vortex(xyz, 0.0, mix))
        if rc.ic.case == "taylor_green_2d":
            return mix.conservatives(taylor_green_2d(xyz, mix))
        rho = rc.ic.rho
        vel = [rc.ic.rhoU / rho, rc.ic.rhoV / rho, rc.ic.rhoW / rho]
        T = rc.ic.pressure / (mix.gas_constant * rho)
        Up = uniform_state(xyz, mix, rho, vel, T)
        return mix.conservatives(Up).to(self.dtype)

    # ------------------------------------------------------------------
    def _step(self, U, t, dt):
        """One integrator step on the RHS's own layout."""
        r = self._rhs
        U2, aux = self._integrator(r, r.to_fused(U), t, dt)
        U = r.from_fused(U2)
        if self.ctx.bcs:
            # the BC ghost states advance once per step, after the stages
            # (tps_tpu solvers/compressible.py:674-676)
            r.bc_states = advance_bc_states(self.ctx, self.tables, U,
                                            r.bc_states, dt)
        return U, aux["max_char_speed"]

    def solve_step(self):
        """One time step + dt update + guards (reference: solveStep :2004)."""
        t = torch.as_tensor(self.time, dtype=self.dtype, device=self.device)
        dt = torch.as_tensor(self.dt, dtype=self.dtype, device=self.device)
        self.U, mcs = self._step(self.U, t, dt)
        self.time = self.time + self.dt
        self.iter += 1
        self._post_step_services(mcs)

    def _check_mcs(self):
        """NaN guard over every step since the last check (one host read)."""
        n = self._mcs_n
        if n == 0:
            return
        vals = self._mcs_buf[:n].cpu().numpy()
        self._mcs_n = 0
        if not np.all(np.isfinite(vals)):
            self.check_nan(verbose=True)
            bad = int(np.argmax(~np.isfinite(vals)))
            raise FloatingPointError(
                f"NaN/Inf detected at iteration {self.iter - n + 1 + bad} "
                f"(reported at {self.iter}, t={float(self.time):.6e})")

    def _post_step_services(self, mcs):
        """NaN-guard buffer, CFL dt, timing print, job management
        (reference: src/M2ulPhyS.cpp:2004-2177)."""
        rc = self.config
        self._mcs_buf[self._mcs_n] = mcs
        self._mcs_n += 1
        if self._mcs_n == self._mcs_buf.numel():
            self._check_mcs()
        if not (rc.constant_dt or rc.dt_fixed > 0):
            # dt from THIS step's wave speed, as a device scalar
            self.dt = rc.cfl * self.hmin / mcs / self.mesh.dim
        if self.iter % rc.timing_freq == 0:
            self._check_mcs()
            wall = _time.perf_counter() - self._wall0
            print(
                f"time step: {self.iter}, physical time {float(self.time):.6e} s"
                f", wall {wall / rc.timing_freq:.4f} s/iter",
                flush=True,
            )
            self._wall0 = _time.perf_counter()
        if self.iter % max(rc.exit_check_freq, 1) == 0:
            self._job_management()

    def _job_management(self):
        from ..utils.job_management import check_die_file

        if check_die_file(self.config.outdir):
            print("DIE file detected: exiting early (no checkpoint: "
                  "ROADMAP A4.1)", flush=True)
            self._check_mcs()
            self.status = STATUS_EARLY_EXIT

    def solve(self):
        """Step loop (reference: M2ulPhyS::solve, src/M2ulPhyS.cpp:2137-2177)."""
        self.solve_begin()
        while self.iter < self.max_iters and self.status == 0:
            with self.timers.section("solve/step"):
                self.solve_step()
        self.solve_end()

    def solve_end(self):
        self._check_mcs()
        if self.timers._acc:
            self.timers.summarize()

    # ------------------------------------------------------------------
    def check_nan(self, verbose=False) -> int:
        """Count NaN entries (reference: Check_NaN_GPU :2509)."""
        arr = self.state_global()
        bad = int(np.sum(~np.isfinite(arr)))
        if verbose and bad:
            el = np.argwhere(~np.isfinite(arr))[:10]
            print(f"found {bad} non-finite state entries; first: {el.tolist()}")
        return bad

    def read_restart(self):
        raise _not_ported("restart read", "A4.1")

    def state_global(self):
        """Conserved state [ne, ndof, neq] as numpy."""
        return self.U.detach().cpu().numpy()

    def set_state_global(self, Ug):
        self.U = torch.as_tensor(np.ascontiguousarray(Ug), dtype=self.dtype,
                                 device=self.device)


def _flow_solver_factory(config, tps=None):
    """Solver factory for [solver]/type = flow (single element type)."""
    s = CompressibleSolver(config, tps=tps)
    s._premade_mesh = _build_mesh(config)
    return s


SOLVER_REGISTRY["flow"] = _flow_solver_factory
