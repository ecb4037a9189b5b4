"""Compressible Navier-Stokes DG solver (the M2ulPhyS analog), PyTorch.

This slice carries single-device runs on generated boxes and O-grids
(mesh generators) and on MFEM / Gmsh mesh files (mesh/mfem_reader.py,
with uniform refinement, [periodicity] and refLength scaling), DryAir with
Sutherland or constant transport, the two-temperature argon plasma
(`fluid = user_defined`: physics/plasma_config.py's perfect mixture with
argon_minimal transport and mass-action chemistry, its source term
dg/source_term.py a forcing of the RHS, the species undershoot clip
inside the step), Rusanov, explicit RK, and two right-hand sides:

- the fused path (periodic boxes, collocated Gauss-Legendre basis): on a
  CUDA device the two hand-written kernels of dg/cuda_fused.py, on the
  CPU their plain PyTorch version (dg/fused.py, also the 2-D case);
- the general (slot) path, dg/rhs.py::SlotRHS, for everything else:
  walls, inlets, outlets and the far field (dg/bc.py, the characteristic
  BCs' ghost states in the step loop's buffers), curved elements, and
  the reference-default Gauss-Lobatto basis.  Its interior face sweep is the hand-written
  CUDA kernel of dg/cuda_faces.py on a CUDA device, the plain version on
  the CPU.

Every input key outside the slice raises NotImplementedError naming the
ROADMAP item that ports it.

Mirrors the reference solver's structure (reference: src/M2ulPhyS.cpp):
CFL timestep control uses dt = CFL * hmin / max_char_speed / dim
(reference: src/M2ulPhyS.cpp:2013-2016).  The step loop is the JAX
solver's chunked one (tps_tpu solvers/compressible.py:697-729,
1238-1386): `solve` runs chunks of up to 64 steps between its service
boundaries; U, t and dt are device scalars and buffers of the step loop
(solvers/step_graph.py), and on a CUDA device each step is a replay of one
captured CUDA graph.  The NaN guard (reference: src/M2ulPhyS.cpp:
2463-2525) checks every step's max characteristic speed, read from a
device ring after each chunk, `time/mcsLagSteps` steps late, and all of
it at a DIE file and at the end.

Checkpoints (io/restart.py, the JAX package's layout through io/h5lite.py)
are written every outputFreq, at a DIE file, before an auto-restart exit
and at the end, and read at start-up with enableRestart / restartCycle;
enableParaview writes a legacy VTK file at the end (io/visualization.py).
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from ..config.run_config import RunConfiguration
from ..constants import UNIVERSAL_GAS_CONSTANT
from ..dg import cuda_faces, cuda_fused
from ..dg import bc as bcs
from ..dg.cuda_faces import build_face_sweep
from ..dg.cuda_fused import build_cuda_fused, cuda_fusable
from ..dg.discretization import build_tables
from ..dg.fluxes import Fluxes
from ..dg.fused import maybe_build_fused
from ..dg.operators import _clip_species
from ..dg.rhs import (RHSContext, SlotRHS, advance_bc_states, bc_slices,
                      init_bc_states)
from ..dg.riemann import Rusanov
from ..dg.source_term import SourceTerm
from ..io.restart import RestartIO
from ..mesh import generators
from ..physics.gas import DryAir
from ..physics.plasma_config import build_plasma
from ..physics.transport import ConstantTransport, DryAirTransport
from ..time.integrators import get_integrator
from ..utils.cases import isentropic_vortex, taylor_green_2d, uniform_state
from .base import SOLVER_REGISTRY, PlasmaSolver
from .step_graph import RING, StepLoop

STATUS_EARLY_EXIT = 10  # status of a run ended by a DIE file
STATUS_JOB_RESTART = 20  # status of a run ended for a resubmission


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported to tps_torch yet "
                               f"(ROADMAP {item})")


def _flag(gen, key):
    return gen.get(key, "0") in ("1", "true", "True")


def _build_mesh(rc: RunConfiguration):
    """Mesh from the [mesh] generator section or a mesh file ([flow]/mesh,
    with _apply_mesh_options and refLength scaling, as in the JAX
    package's solvers/compressible.py:35-130)."""
    gen = rc.mesh_generator
    if not gen:
        if not rc.mesh:
            raise ValueError(
                "no mesh specified ([flow]/mesh or [mesh] generator)")
        from ..mesh.mfem_reader import read_mfem_mesh

        mesh = _apply_mesh_options(read_mfem_mesh(rc.mesh), rc.raw)
        if rc.ref_length != 1.0:
            mesh = mesh.scaled(1.0 / rc.ref_length)
        return mesh
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
    if kind in ("annulus2d", "annulus"):
        # the curved O-grid around a cylinder (inner circle attribute 4,
        # outer circle 2)
        return generators.annulus_2d(
            nr=int(gen.get("nr", 8)),
            ntheta=int(gen.get("ntheta", 32)),
            r0=float(gen.get("r0", 0.5)),
            r1=float(gen.get("r1", 10.0)),
            geom_order=int(gen.get("geom_order", 2)),
        )
    if kind == "box2d_tri":
        raise _not_ported("triangles (the 'box2d_tri' mesh generator)",
                          "A5.5")
    raise ValueError(f"unknown mesh generator '{kind}'")


def _apply_mesh_options(mesh, raw):
    """Uniform refinement and ini-driven periodicity for file meshes
    (reference: [flow]/refinement_levels src/M2ulPhyS.cpp:350-357,2685
    and [periodicity] :296-312,3806-3811); refinement before gluing."""
    if raw is None:
        return mesh
    ref_levels = int(raw.get("flow/refinement_levels", 0) or 0)
    if ref_levels > 0:
        from ..mesh.refine import refine_uniform

        mesh = refine_uniform(mesh, levels=ref_levels)
    if raw.get("periodicity/enablePeriodic", 0):
        from ..mesh.mesh import make_periodic

        trans = []
        for ax, key in enumerate(("xTrans", "yTrans", "zTrans")[: mesh.dim]):
            vec = np.zeros(mesh.dim)
            vec[ax] = float(raw.get(f"periodicity/{key}", 1.0e12))
            trans.append(vec)
        mesh = make_periodic(mesh, trans)
    return mesh


# input keys outside this slice: (ini key, what it enables, ROADMAP item)
_UNPORTED_KEYS = (
    ("io/restartFromLTE", "LTE restart conversion", "A6.4"),
    ("mesh/partitions", "domain decomposition", "A8"),
    ("io/enableHistory", "the history file", "A12"),
    ("planeDump/isEnabled", "plane dumps", "A12"),
    ("flow/computeDistance", "wall distance", "A5"),
    ("flow/useMixingLength", "the mixing-length closure", "A5"),
    ("viscosityMultiplierFunction/isEnabled", "the viscous sponge", "A5"),
    ("flow/enablePressureForcing", "pressure forcing", "A5"),
    ("heatSource/numHeatSources", "heat sources", "A5"),
    ("spongezone/numSpongeZones", "sponge zones", "A5"),
    ("passiveScalars/numScalars", "passive scalars", "A6.2"),
    ("mms/isEnabled", "manufactured solutions", "A5"),
)


# boundary-condition types of this slice (dg/bc.py), as the JAX package's
# solver names them (its _make_bc and _INLET_KINDS / _OUTLET_KINDS); the
# interpolated inlet is A5
_WALL_KINDS = ("inviscid", "slip", "viscous_adiabatic", "viscous_isothermal",
               "viscous_general")
_INLET_KINDS = ("subsonic", "subsonicFaceBasedX", "subsonicFaceBasedY",
                "subsonicFaceBasedZ", "nonreflecting",
                "nonreflectingConstEntropy")
_OUTLET_KINDS = ("subsonicPressure", "nonReflectingPressure",
                 "nonreflectingPressure", "nonReflectingMassFlow",
                 "nonReflectingPointBasedMassFlow", "farfield")
_BC_KINDS = _WALL_KINDS + _INLET_KINDS + _OUTLET_KINDS


def _check_plasma(rc: RunConfiguration):
    """The plasma this slice runs: a perfect mixture with argon_minimal
    transport, no boundaries (the mixture BCs are A6.2)."""
    raw = rc.raw
    gas = str(raw.get("plasma_models/gas_model", "perfect_mixture"))
    if gas != "perfect_mixture":
        raise _not_ported(f"the '{gas}' gas model", "A6.3")
    tmodel = str(raw.get("plasma_models/transport_model", "argon_minimal"))
    if tmodel == "constant":
        raise _not_ported("constant transport of a species mixture "
                          "(ConstantPlasmaTransport)", "A6.2")
    if tmodel != "argon_minimal":
        raise _not_ported(f"the '{tmodel}' transport model", "A6.3")
    if rc.bcs:
        raise _not_ported("boundary conditions of a species mixture", "A6.2")
    if rc.equation_system == "euler":
        # the face-sweep kernel's mixture policy is Navier-Stokes only
        raise _not_ported("Euler on a species mixture", "A6.2")


def check_slice(rc: RunConfiguration):
    """Raise NotImplementedError for any input this slice does not run."""
    if rc.fluid == "user_defined":
        if rc.raw is None:
            raise ValueError("fluid 'user_defined' is read from the input "
                             "file's [plasma_models] and [species]")
        _check_plasma(rc)
    elif rc.fluid == "lte_table":
        raise _not_ported("the LTE-table fluid (physics/lte.py)", "A9")
    elif rc.fluid != "dry_air":
        # neither package has another fluid (the JAX package raises too)
        raise ValueError(f"fluid '{rc.fluid}': the fluids are dry_air, "
                         f"user_defined and lte_table")
    if rc.equation_system not in ("euler", "navier-stokes"):
        raise _not_ported(f"equation system '{rc.equation_system}'", "A6.2")
    if rc.use_roe:
        raise _not_ported("the Roe flux", "A1")
    if rc.axisymmetric:
        raise _not_ported("axisymmetric flow", "A5")
    if rc.sgs_model != "none":
        raise _not_ported(f"the '{rc.sgs_model}' SGS model", "A5")
    for spec in rc.bcs:
        if spec.kind == "interpolate":
            raise _not_ported("the interpolated inlet (needs "
                              "interop/ext_data.py)", "A5")
        if spec.kind not in _BC_KINDS:
            raise NotImplementedError(
                f"boundary condition type '{spec.kind}'")
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

    # on a CUDA device each step is a replay of a captured CUDA graph;
    # False steps eagerly there (the graphs' reference and yardstick)
    cuda_graphs = True

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
        forcings = self._build_physics(dim, dim)
        # boundary conditions: per-attr static slices over sorted bdr faces
        self.bc_slices = self._build_bcs()
        self._report_bc_patches()
        self.ctx = RHSContext(fluxes=self.fluxes, riemann=self.riemann,
                              bcs=tuple(self.bc_slices),
                              forcings=tuple(forcings))
        self._initialize_state_and_loop()
        # checkpoints are written every outputFreq whatever the keys, as
        # in the reference (src/M2ulPhyS.cpp:1988,2041); enableRestart /
        # restartCycle only read one at start-up (:1930-1946)
        self._io = RestartIO(rc)
        if rc.enable_restart or rc.restart_cycle:
            self.read_restart()
        self._enable_paraview = bool(
            rc.raw.get("io/enableParaview", 0) if rc.raw is not None else 0)

    # ------------------------------------------------------------------
    def _build_physics(self, dim, nvel):
        """Mixture, transport, fluxes and Riemann solver; returns the
        forcings (the plasma's source term)."""
        rc = self.config
        self.plasma = None
        forcings = []
        if rc.fluid == "user_defined":
            # the plasma (tps_tpu solvers/compressible.py:271-288).  Its
            # Joule heating contributes zero without EM fields
            # (tps_tpu dg/forcing.py:283-288) and is left out until the EM
            # and coupling slices supply them (ROADMAP A10/A11)
            self.plasma = build_plasma(rc.raw, dim, nvel)
            self.mixture = self.plasma.mixture
            transport = (None if rc.equation_system == "euler"
                         else self.plasma.transport)
            forcings.append(SourceTerm(mixture=self.mixture,
                                       transport=self.plasma.transport,
                                       chemistry=self.plasma.chemistry))
            self.fluxes = Fluxes(mixture=self.mixture, transport=transport,
                                 eq_system=rc.equation_system)
            self.riemann = Rusanov(self.fluxes)
            return forcings
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
        return forcings

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
        """The BC of a [boundaryConditions/...] section, in the order of
        the JAX package's solvers/compressible.py:951-1104."""
        kind = spec.kind
        p = spec.params
        nvel = self.mixture.nvel

        def fget(key, default=None):
            if key in p:
                return float(str(p[key]).strip("'\""))
            return default

        def uvw():
            return [float(x) for x in
                    str(p.get("uvw", "0 0 0")).strip().strip("'\"").split()]

        if kind in ("inviscid", "slip", "viscous_adiabatic",
                    "viscous_isothermal"):
            return bcs.WallBC(kind=kind, wall_temp=fget("temperature", 300.0))
        if kind == "viscous_general":
            Th = fget("temperature", 300.0)
            return bcs.GeneralWallBC(
                heavy=str(p.get("heavy_thermal_condition", "isothermal")),
                electron=str(p.get("electron_thermal_condition",
                                   "isothermal")),
                wall_temp=Th, wall_temp_e=fget("electron_temperature", Th))
        if kind == "subsonic":
            return bcs.InletBC(input_state=(fget("density"), *uvw()[:nvel]))
        if kind in ("subsonicFaceBasedX", "subsonicFaceBasedY",
                    "subsonicFaceBasedZ"):
            return bcs.FaceInletBC(
                input_state=(fget("density", 1.0), *uvw()[:2]),
                tangent_axis={"X": 0, "Y": 1, "Z": 2}[kind[-1]])
        if kind in ("nonreflecting", "nonreflectingConstEntropy"):
            # time-integrated characteristic inlet (reference:
            # SUB_DENS_VEL_NR / SUB_VEL_CONST_ENT, src/inletBC.cpp:756+)
            return bcs.CharacteristicInletBC(
                input_state=(fget("density", 1.0), *uvw()[:nvel]),
                ref_length=self.config.ref_length,
                const_entropy=(kind == "nonreflectingConstEntropy"))
        if kind == "farfield":
            return bcs.FarFieldBC(input_state=(
                fget("density", 1.0), *uvw()[:nvel],
                fget("pressure", 101325.0)))
        if kind == "subsonicPressure":
            return bcs.OutletBC(pressure=fget("pressure"))
        if kind in ("nonReflectingPressure", "nonreflectingPressure"):
            return bcs.CharacteristicOutletBC(
                kind="nonReflectingPressure", pressure=fget("pressure"),
                ref_length=self.config.ref_length)
        if kind in ("nonReflectingMassFlow",
                    "nonReflectingPointBasedMassFlow"):
            return bcs.CharacteristicOutletBC(
                kind=kind, mass_flow=fget("massFlow"),
                area=fget("area", self._patch_area(spec)),
                ref_length=self.config.ref_length)
        raise NotImplementedError(f"boundary condition type '{kind}'")

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
        """IC, RHS, CFL/dt, the step loop and its NaN-guard queue."""
        rc = self.config
        dim = self.mesh.dim
        U = self._initial_condition()
        self.iter = 0
        self.hmin = float(np.min(self.tables_np.delta) * max(rc.order, 1))
        self._integrator = get_integrator(rc.integrator)
        self._cfl_mode = not (rc.constant_dt or rc.dt_fixed > 0)
        self._rhs = self._build_rhs()
        bc_states = init_bc_states(self.ctx, self.tables, U)

        # initial dt (reference: M2ulPhyS::initialTimeStep)
        if rc.dt_fixed > 0:
            dt = rc.dt_fixed
        else:
            mcs0 = float(torch.amax(self.mixture.max_char_speed(U)))
            dt = rc.cfl * self.hmin / mcs0 / dim

        # U, time, dt and the BC ghost states are the step loop's buffers
        # from here on; the RHS reads the ghost states there
        self._loop = StepLoop(self._step_body, U, dt, bc_states,
                              counters=(cuda_fused.launches,
                                        cuda_faces.launches))
        if self.ctx.bcs:
            self._rhs.bc_states = self._loop.bc_states
        self.U, self.time, self.dt = self._loop.U, self._loop.t, self._loop.dt
        # (iteration of a chunk's last step, its max char speeds on the
        # host, the event that says they have arrived), oldest first
        self._mcs_queue = []
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
        if self.plasma is not None:
            # species initial mass fractions -> number densities (mixture
            # order), then T (and Te) from the total pressure p = sum n_s
            # R T (tps_tpu solvers/compressible.py:1183-1198)
            Y = self.plasma.initial_mass_fractions
            lo, na = mix.nvel + 2, mix.num_active_species
            n_act = [torch.full_like(Up[..., 0], Y[s] * rho / mix.mw[s])
                     for s in range(na)]
            Up = torch.cat([Up[..., :lo], torch.stack(n_act, -1),
                            Up[..., lo + na:]], -1)
            n_sp = mix._n_sp_from_primitives(Up)
            T_adj = rc.ic.pressure / (UNIVERSAL_GAS_CONSTANT
                                      * torch.sum(n_sp, dim=-1))
            Up = Up.clone()
            Up[..., mix.i_th] = T_adj
            if mix.two_temperature:
                Up[..., mix.i_te] = T_adj
        return mix.conservatives(Up).to(self.dtype)

    # ------------------------------------------------------------------
    def _step_body(self, U, t, dt, bc_states):
        """One step, the body of the JAX chunk's scan (tps_tpu
        solvers/compressible.py:709-717): the integrator's stages on the
        RHS's own layout (which read the ghost states bc_states), the
        ghosts advanced once from the new state (:674-676), t + dt, and
        in CFL mode the next dt from this step's max char speed.  Returns
        (U, t, dt, mcs, bc_states), all on the device; captured as the
        step graph on CUDA, so no host sync."""
        r = self._rhs
        U2, aux = self._integrator(r, r.to_fused(U), t, dt)
        U2 = r.from_fused(U2)
        # species-density undershoots clipped on the stored state
        # (reference: M2ulPhyS::Check_Undershoot; tps_tpu :665-673)
        U2 = _clip_species(self.mixture, U2)
        bc2 = advance_bc_states(self.ctx, self.tables, U2, bc_states, dt)
        mcs = aux["max_char_speed"]
        if self._cfl_mode:
            rc = self.config
            dt2 = rc.cfl * self.hmin / mcs / self.mesh.dim
        else:
            dt2 = dt
        return U2, t + dt, dt2, mcs, bc2

    def solve_step(self):
        """One time step + dt update + guards (reference: solveStep :2004)."""
        self.solve_chunk(1)

    def _chunk_size(self):
        """Steps to run before the next service boundary (timing print,
        checkpoint, exit check, the end): a power of two up to 64, as in
        the JAX solver (tps_tpu solvers/compressible.py:1271-1298)."""
        rc = self.config
        bounds = [self.max_iters - self.iter]
        for freq in (rc.timing_freq, rc.output_freq,
                     max(rc.exit_check_freq, 1)):
            bounds.append(freq - self.iter % freq)
        n = min(min(bounds), RING)
        chunk = 1
        while chunk * 2 <= n:
            chunk *= 2
        return chunk

    def solve_chunk(self, n):
        """n time steps (1 <= n <= 64) through the step loop (on CUDA,
        replays of the step graph), then the service tail.  U, time and
        dt that the caller rebound are copied into the loop first."""
        lp = self._loop
        lp.load(self.U, self.time, self.dt)
        lp.run(n, graph=self.cuda_graphs)
        self.U, self.time, self.dt = lp.U, lp.t, lp.dt
        self.iter += n
        self._mcs_queue.append((self.iter, *lp.speeds(n)))
        self._post_chunk_services()

    def _drain_mcs_queue(self, lag):
        """NaN guard over the queued max char speeds of the chunks whose
        last step is at least `lag` steps old (lag 0: all of them); waits
        for their copies, which trail the chunks on the device."""
        q = self._mcs_queue
        while q and self.iter - q[0][0] >= lag:
            it0, vals, done = q.pop(0)
            if done is not None:
                done.synchronize()
            arr = vals.numpy()
            if not np.all(np.isfinite(arr)):
                self.check_nan(verbose=True)
                bad = int(np.argmax(~np.isfinite(arr)))
                step = it0 - len(arr) + 1 + bad
                raise FloatingPointError(
                    f"NaN/Inf detected at iteration {step} (reported at "
                    f"{self.iter}, t={float(self.time):.6e})")

    def _post_chunk_services(self):
        """NaN guard, timing print, checkpoint, job management (reference:
        src/M2ulPhyS.cpp:2004-2177); the CFL dt was updated in the step."""
        rc = self.config
        self._drain_mcs_queue(int(rc.mcs_lag))
        if self.iter % rc.timing_freq == 0:
            wall = _time.perf_counter() - self._wall0
            print(
                f"time step: {self.iter}, physical time {float(self.time):.6e} s"
                f", wall {wall / rc.timing_freq:.4f} s/iter",
                flush=True,
            )
            self._wall0 = _time.perf_counter()
        if self.iter % rc.output_freq == 0:
            # the NaN guard first: a checkpoint never stores a NaN state
            self._drain_mcs_queue(0)
            with self.timers.section("io/restart"):
                self.write_restart()
        if self.iter % max(rc.exit_check_freq, 1) == 0:
            self._job_management()

    def _job_management(self):
        """A DIE file: checkpoint and exit early; the walltime threshold
        with enableAutoRestart: checkpoint and exit for a resubmission
        (reference: src/M2ulPhyS.cpp:2160-2177)."""
        from ..utils.job_management import check_die_file, job_almost_done

        rc = self.config
        if check_die_file(rc.outdir):
            print("DIE file detected: exiting early", flush=True)
            self._drain_mcs_queue(0)
            self.write_restart()
            self.status = STATUS_EARLY_EXIT
        elif rc.enable_auto_restart and job_almost_done(rc.rm_threshold):
            print("walltime threshold reached: checkpoint + resubmit",
                  flush=True)
            self._drain_mcs_queue(0)
            self.write_restart()
            self.status = STATUS_JOB_RESTART

    def solve(self):
        """Chunked step loop (reference: M2ulPhyS::solve, the while loop at
        src/M2ulPhyS.cpp:2137-2177)."""
        self.solve_begin()
        while self.iter < self.max_iters and self.status == 0:
            with self.timers.section("solve/chunk"):
                self.solve_chunk(self._chunk_size())
        self.solve_end()

    def solve_end(self):
        self._drain_mcs_queue(0)
        self.write_restart()
        if self._enable_paraview:
            self.visualization()
        if self.timers._acc:
            self.timers.summarize()

    # ------------------------------------------------------------------
    def write_restart(self):
        self._io.write(self)

    def read_restart(self):
        """The checkpoint's state, t and dt into the step loop's buffers,
        and the characteristic ghosts re-seeded from the restored state,
        as the JAX solver does (tps_tpu solvers/compressible.py:1694-1702)."""
        self._io.read(self)
        if any(b is not None for b in self._loop.bc_states):
            self._loop.load_bc_states(
                init_bc_states(self.ctx, self.tables, self._loop.U))

    def visualization(self):
        """The state as a ParaView-readable VTK file (the reference's
        paraviewColl->Save() and `tps --visual`); returns its path."""
        import os

        from ..io.visualization import write_vtk_dg

        if self.config.postprocess is not None:
            raise _not_ported("the --visual snapshot series "
                              "([post-process/visualization])", "A12")
        mix = self.mixture
        Up = mix.primitives(self.U).cpu().numpy()
        fields = {"density": Up[..., 0],
                  "velocity": Up[..., 1 : 1 + mix.nvel],
                  "temperature": Up[..., mix.i_th],
                  "pressure": mix.pressure(self.U).cpu().numpy()}
        path = os.path.join(self.config.outdir,
                            f"solution_{self.iter:08d}.vtk")
        write_vtk_dg(path, self.tables_np, fields)
        return path

    # ------------------------------------------------------------------
    def check_nan(self, verbose=False) -> int:
        """Count NaN entries (reference: Check_NaN_GPU :2509)."""
        arr = self.state_global()
        bad = int(np.sum(~np.isfinite(arr)))
        if verbose and bad:
            el = np.argwhere(~np.isfinite(arr))[:10]
            print(f"found {bad} non-finite state entries; first: {el.tolist()}")
        return bad

    @property
    def ne_global(self):
        return self.tables_np.ne

    def state_global(self):
        """Conserved state [ne, ndof, neq] as numpy."""
        return self.U.detach().cpu().numpy()

    def set_state_global(self, Ug):
        """Copy Ug into the step loop's U (a captured step graph reads
        that buffer)."""
        self._loop.U.copy_(torch.as_tensor(np.ascontiguousarray(Ug),
                                           dtype=self.dtype))
        self.U = self._loop.U

    def set_time(self, t, dt):
        """Copy t and dt into the step loop's buffers."""
        self._loop.t.fill_(float(t))
        self._loop.dt.fill_(float(dt))
        self.time, self.dt = self._loop.t, self._loop.dt


def _flow_solver_factory(config, tps=None):
    """Solver factory for [solver]/type = flow (single element type)."""
    s = CompressibleSolver(config, tps=tps)
    s._premade_mesh = _build_mesh(config)
    return s


SOLVER_REGISTRY["flow"] = _flow_solver_factory
