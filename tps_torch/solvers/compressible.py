"""Compressible Navier-Stokes DG solver (the M2ulPhyS analog), PyTorch.

This slice carries single-device runs on generated boxes and O-grids
(mesh generators) and on MFEM / Gmsh mesh files (mesh/mfem_reader.py,
with uniform refinement, [periodicity] and refLength scaling), DryAir with
Sutherland or constant transport, the species mixture (`fluid =
user_defined`: physics/plasma_config.py's perfect mixture, 2-D or 3-D,
Euler or Navier-Stokes, with argon_minimal, general per-pair or constant
transport; mass-action chemistry with Arrhenius, tabulated and
radiative-decay rates, net emission; its source term dg/source_term.py
and the Joule heating dg/forcing.py forcings of the RHS; the mixture's
walls, inlets and outlets; the species undershoot clip inside the step),
axisymmetric (r, z) flow with swirl on DryAir, on the LTE-table fluid and
on the argon ternary with argon_minimal transport (`[flow] axisymmetric`:
nvel = 3, the radius-weighted tables, dg/forcing.py's AxisymmetricSource),
the closures that change the viscous flux's transport coefficients (the
wall distance with the mixing length, `[flow] computeDistance` and
`useMixingLength`; the Smagorinsky and Sigma SGS models, `sgsModel`; the
planar viscous sponge, `[viscosityMultiplierFunction]`),
the LTE-table fluid (`fluid = lte_table`: physics/lte.py's table
thermodynamics and transport with 1-D HDF5 or 2-D (T, rho) tables, net
emission and the Joule heating through its sigma table), the LTE restart
(io/restartFromLTE: a bulk checkpoint converted into the mixture's
Saha/Boltzmann equilibrium and written at once), the forcings of
dg/forcing.py (`[flow] enablePressureForcing`, `[heatSourceN]`,
`[spongezoneN]`) and the manufactured solutions of utils/masa.py (`[mms]`:
the exact initial state, the MASA source, the L2 solution error at the
end), Rusanov or Roe (`useRoe`, planar), explicit RK,
and two right-hand sides:

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
ROADMAP item that ports it; passive scalars raise naming the JAX
package's fact that the port does not copy (ROADMAP C).  The coupling side (evaluate_plasma_
conductivity, set_joule_heating, set_efield) serves
solvers/coupling.py::CycleAvgJouleCoupling: each setter copies into a
device tensor the captured step reads.

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

import dataclasses
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
from ..dg.fluxes import Fluxes, PlanarViscousSponge
from ..dg.forcing import (AxisymmetricSource, ConstantPressureGradient,
                          HeatSource, JouleHeating, SpongeZone,
                          sponge_target_conserved)
from ..dg.fused import maybe_build_fused
from ..dg.operators import _clip_species
from ..dg.rhs import (RHSContext, SlotRHS, advance_bc_states, bc_slices,
                      init_bc_states)
from ..dg.riemann import Roe, Rusanov
from ..dg.sgs import Sigma, Smagorinsky
from ..dg.source_term import SourceTerm
from ..io.restart import RestartIO, _solver_field_names
from ..mesh import generators
from ..physics.gas import DryAir
from ..physics.lte import load_lte_setup
from ..physics.perfect_mixture import state_from_lte
from ..physics.plasma_config import build_plasma, read_table_input
from ..physics.radiation import NetEmission
from ..physics.transport import (ConstantTransport, DryAirTransport,
                                 MixingLengthTransport)
from ..time.integrators import get_integrator
from ..utils.cases import isentropic_vortex, taylor_green_2d, uniform_state
from ..utils.masa import MasaHandler
from ..utils.mms import solution_error
from ..utils.wall_distance import distance_to_points, wall_face_points
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
    ("mesh/partitions", "domain decomposition", "A8"),
    ("io/enableHistory", "the history file", "A12"),
    ("planeDump/isEnabled", "plane dumps", "A12"),
)

# why a deck with passive scalars raises on both devices (ROADMAP C, facts
# of the reference): the JAX package's solver builds its DryAir without
# the scalars (tps_tpu solvers/compressible.py never passes n_passive), so
# such a deck runs with no scalar equation, and its PassiveScalar forcing
# relaxes U[..., -1], which is then rho E, toward rho Z
PASSIVE_SCALAR_FACT = (
    "passive scalars ({what}) raise: the JAX package runs such a deck with "
    "no scalar equation (its DryAir keeps n_passive = 0) and its "
    "PassiveScalar sink on rho E; the port does not copy that answer and "
    "builds no equation the JAX solver never builds (ROADMAP C, facts of "
    "the reference)")


# boundary-condition types of this slice (dg/bc.py), as the JAX package's
# solver names them (its _make_bc and _INLET_KINDS / _OUTLET_KINDS); the
# interpolated inlet is A5.2
_WALL_KINDS = ("inviscid", "slip", "viscous_adiabatic", "viscous_isothermal",
               "viscous_general")
_INLET_KINDS = ("subsonic", "subsonicFaceBasedX", "subsonicFaceBasedY",
                "subsonicFaceBasedZ", "nonreflecting",
                "nonreflectingConstEntropy")
_OUTLET_KINDS = ("subsonicPressure", "nonReflectingPressure",
                 "nonreflectingPressure", "nonReflectingMassFlow",
                 "nonReflectingPointBasedMassFlow", "farfield")
_BC_KINDS = _WALL_KINDS + _INLET_KINDS + _OUTLET_KINDS


def check_slice(rc: RunConfiguration):
    """Raise NotImplementedError for any input this slice does not run."""
    if rc.fluid == "user_defined":
        # the species mixture runs whole; physics/plasma_config.py raises
        # for the `bte` rates of the Boltzmann coupling (ROADMAP A11.3)
        if rc.raw is None:
            raise ValueError("fluid 'user_defined' is read from the input "
                             "file's [plasma_models] and [species]")
    elif rc.fluid == "lte_table":
        if rc.raw is None:
            raise ValueError("fluid 'lte_table' is read from the input "
                             "file's [flow/lte] tables")
    elif rc.fluid != "dry_air":
        # neither package has another fluid (the JAX package raises too)
        raise ValueError(f"fluid '{rc.fluid}': the fluids are dry_air, "
                         f"user_defined and lte_table")
    if rc.equation_system == "ns-passive":
        raise NotImplementedError(PASSIVE_SCALAR_FACT.format(
            what="equation_system = ns-passive"))
    if rc.equation_system not in ("euler", "navier-stokes"):
        raise ValueError(f"unknown equation system '{rc.equation_system}'")
    if rc.use_roe and rc.axisymmetric:
        # the reference refuses this combination (annulus.test), and so
        # does the JAX package
        raise ValueError("Roe flux not supported for axisymmetric "
                         "simulations. Please use flow/useRoe = 0.")
    if rc.axisymmetric:
        _check_axisymmetric_fluid(rc)
    for spec in rc.bcs:
        if spec.kind == "interpolate":
            raise _not_ported("the interpolated inlet (its BC, "
                              "dg/bc.py's InterpolatedInletBC of the JAX "
                              "package)", "A5.2")
        if spec.kind not in _BC_KINDS:
            raise NotImplementedError(
                f"boundary condition type '{spec.kind}'")
    if rc.avg_enabled:
        raise _not_ported("running statistics ([averaging])", "A12")
    raw = rc.raw
    if raw is None:
        return
    if raw.has("passiveScalars/numScalars") and _enabled(
            raw, "passiveScalars/numScalars"):
        raise NotImplementedError(PASSIVE_SCALAR_FACT.format(
            what="[passiveScalars] numScalars"))
    for key, what, item in _UNPORTED_KEYS:
        if raw.has(key) and _enabled(raw, key):
            section, name = key.split("/", 1)
            raise _not_ported(f"{what} ([{section}] {name})", item)


def _check_axisymmetric_fluid(rc):
    """Axisymmetric flow runs on the face sweep's axisymmetric policies
    only (dg/cuda_faces.py::face_sweep_supported): DryAir, the LTE-table
    fluid, and the two-temperature ambipolar argon ternary with
    argon_minimal transport or on Euler.  The other mixtures (other
    species counts, the constant plasma transport, mixtures that are not
    ambipolar and two-temperature) raise on both devices."""
    if rc.fluid != "user_defined":
        return
    raw = rc.raw
    tmodel = str(raw.get("plasma_models/transport_model", "argon_minimal"))
    nsp = int(raw.get("species/numSpecies", 0))
    if nsp != 3:
        raise _not_ported(f"axisymmetric flow on a {nsp}-species mixture "
                          "(only the argon ternary)", "A5.3")
    if not (raw.get("plasma_models/ambipolar", 0)
            and raw.get("plasma_models/two_temperature", 0)):
        raise _not_ported("axisymmetric flow on a mixture that is not "
                          "ambipolar and two-temperature", "A5.3")
    if rc.equation_system != "euler" and tmodel != "argon_minimal":
        raise _not_ported(f"axisymmetric flow with '{tmodel}' plasma "
                          "transport", "A5.3")


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
    masa = None  # utils/masa.py::MasaHandler when [mms] isEnabled

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
                                      axisymmetric=rc.axisymmetric, **quad_kw)
        if rc.raw is not None and rc.raw.get("flow/computeDistance", 0):
            self._wall_distance_tables()
        self.tables = self.tables_np.to_torch(self.dtype, self.device)
        # the coupling's fields on the solution nodes [ne, ndof]: the Joule
        # heating the forcing adds and the E-field amplitude (the
        # Boltzmann bus's), filled in place by set_joule_heating/set_efield
        shape = self.tables.xyz_dof.shape[:-1]
        self.joule_heating = torch.zeros(shape, dtype=self.dtype,
                                         device=self.device)
        self.efield = torch.zeros(shape, dtype=self.dtype, device=self.device)

        dim = self.mesh.dim
        # (r, z) + swirl: the azimuthal velocity is the third
        nvel = 3 if (rc.axisymmetric and dim == 2) else dim
        forcings = self._build_physics(dim, nvel)
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
        restart_from_lte = (rc.raw is not None
                            and rc.raw.get("io/restartFromLTE", 0))
        if restart_from_lte:
            # an LTE checkpoint holds no species or electron energy: they
            # read as optional (reference: registerIOVar(..., required=
            # false), src/M2ulPhyS.cpp:1842-1853)
            names = _solver_field_names(self)
            self._restart_optional_fields = frozenset(
                names[self.mixture.nvel + 2:])
        if rc.enable_restart or rc.restart_cycle:
            self.read_restart()
        if restart_from_lte:
            self._init_species_from_lte()
            # the converted restart is written at once (reference:
            # src/M2ulPhyS.cpp:1985-1991)
            self.write_restart()
        self._enable_paraview = bool(
            rc.raw.get("io/enableParaview", 0) if rc.raw is not None else 0)

    def _wall_distance_tables(self):
        """The wall distance ([flow] computeDistance; tps_tpu solvers/
        compressible.py:204-221, reference: src/M2ulPhyS.cpp:371-437) to
        every wall patch that is not inviscid, at the solution nodes
        (`distance`), the face points (`f_dist`) and the slot points
        (`dist_slot` [ne, nlf, nqf]), set on the numpy tables."""
        wall_kinds = ("slip", "viscous_adiabatic", "viscous_isothermal",
                      "viscous_general")
        t = self.tables_np
        attrs = [b.patch for b in self.config.bcs if b.kind in wall_kinds]
        wall_pts = wall_face_points(t, attrs)
        t.distance = distance_to_points(t.xyz_dof, wall_pts)
        t.f_dist = distance_to_points(t.f_xyz, wall_pts)
        if t.xyz_slot is not None:
            t.dist_slot = distance_to_points(t.xyz_slot, wall_pts)

    # ------------------------------------------------------------------
    def _build_physics(self, dim, nvel):
        """Mixture, transport, fluxes and Riemann solver; returns the
        forcings (the plasma's source term and Joule heating, and the
        geometric source of axisymmetric flow)."""
        rc = self.config
        self.plasma = None
        self._source_term = None
        forcings = []
        if rc.fluid in ("user_defined", "lte_table"):
            if rc.fluid == "user_defined":
                # the plasma (tps_tpu solvers/compressible.py:271-288)
                self.plasma = build_plasma(rc.raw, dim, nvel)
                self.mixture = self.plasma.mixture
                self.transport = self.plasma.transport
                chemistry, radiation = (self.plasma.chemistry,
                                        self.plasma.radiation)
            else:
                # the equilibrium table fluid (tps_tpu solvers/
                # compressible.py:289-318): no chemistry; the source term
                # is the radiation sink, and the sigma table gives the
                # conductivity the Joule coupling reads
                self.mixture, self.transport = load_lte_setup(rc.raw, dim,
                                                              nvel)
                chemistry, radiation = None, None
                if rc.raw.get("plasma_models/radiation_model",
                              "none") == "net_emission":
                    radiation = NetEmission(read_table_input(
                        rc.raw, "plasma_models/radiation_model/"
                        "net_emission/tabulated"))
            self._source_term = SourceTerm(
                mixture=self.mixture, transport=self.transport,
                chemistry=chemistry, radiation=radiation)
            forcings += [self._source_term,
                         JouleHeating(mixture=self.mixture,
                                      heating=self.joule_heating)]
            # the LTE fluid's Euler walls read its transport, as the JAX
            # package's do (its Fluxes always carry the transport)
            transport = (None if rc.equation_system == "euler"
                         and rc.fluid == "user_defined" else self.transport)
            self._build_fluxes(transport)
            return forcings + self._axisymmetric_source() + self._forcings()
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
        self.transport = transport
        self._build_fluxes(transport)
        return forcings + self._axisymmetric_source() + self._forcings()

    def _build_fluxes(self, transport):
        """Fluxes and the Riemann solver, with the closures of the viscous
        flux (tps_tpu solvers/compressible.py:321-389): the transport
        wrapped in the mixing length (the source term's too), the SGS
        model and the planar viscous sponge; Roe for useRoe."""
        rc, raw = self.config, self.config.raw
        if (transport is not None and raw is not None
                and raw.get("flow/useMixingLength", 0)):
            # reference: src/M2ulPhyS.cpp:2701-2707
            transport = MixingLengthTransport(
                molecular=transport,
                max_mixing_length=raw.get(
                    "flow/mixing-length/max-mixing-length", 0.0),
                Prt=raw.get("flow/mixing-length/Pr_ratio", 1.0),
                bulk_mult=raw.get("flow/mixing-length/bulk-multiplier", 0.0))
            if self._source_term is not None:
                self._source_term = dataclasses.replace(
                    self._source_term, transport=transport)
            self.transport = transport
        sgs = None
        if rc.sgs_model == "smagorinsky":
            sgs = Smagorinsky(mixture=self.mixture, const=rc.sgs_const or 0.12)
        elif rc.sgs_model == "sigma":
            sgs = Sigma(mixture=self.mixture, const=rc.sgs_const or 0.135)
        sponge = None
        if raw is not None and raw.get("viscosityMultiplierFunction/isEnabled",
                                       0):
            # reference: src/M2ulPhyS.cpp:2789-2807
            base = "viscosityMultiplierFunction"
            sponge = PlanarViscousSponge(
                point=tuple(raw.get_vec(f"{base}/point")),
                normal=tuple(raw.get_vec(f"{base}/normal")),
                width=raw.get_required(f"{base}/width", float),
                ratio=raw.get_required(f"{base}/viscosityRatio", float))
        self.fluxes = Fluxes(mixture=self.mixture, transport=transport,
                             eq_system=rc.equation_system,
                             axisymmetric=rc.axisymmetric, sgs_model=sgs,
                             visc_sponge=sponge)
        self.riemann = (Roe if rc.use_roe else Rusanov)(self.fluxes)

    def _axisymmetric_source(self):
        """[AxisymmetricSource] on axisymmetric flow, after the other
        forcings (tps_tpu solvers/compressible.py:391-395), else []."""
        if not self.config.axisymmetric:
            return []
        return [AxisymmetricSource(mixture=self.mixture, fluxes=self.fluxes)]

    def _forcings(self):
        """The deck's forcings, after the axisymmetric source, in the JAX
        order (tps_tpu solvers/compressible.py:397-476): the imposed
        pressure gradient ([flow] enablePressureForcing), the cylindrical
        heat sources ([heatSourceN]), the sponge zones ([spongezoneN]) and
        the manufactured-solution source ([mms], sets self.masa); sections
        that are not enabled are skipped."""
        rc, raw = self.config, self.config.raw
        out = []
        self.masa = None
        if raw is None:
            return out
        if raw.get("flow/enablePressureForcing", 0):
            # reference: src/M2ulPhyS.cpp:2681-2684
            out.append(ConstantPressureGradient(
                mixture=self.mixture,
                press_grad=tuple(raw.get_vec("flow/pressureGrad"))))
        # reference: src/M2ulPhyS.cpp:2751-2785
        for k in range(1, raw.get("heatSource/numHeatSources", 0) + 1):
            base = f"heatSource{k}"
            if not raw.get(f"{base}/isEnabled", 0):
                continue
            dist = raw.get_required(f"{base}/distribution")
            if dist != "cylinder":
                raise ValueError(f"unknown heat source distribution '{dist}'")
            out.append(HeatSource(
                mixture=self.mixture,
                value=raw.get_required(f"{base}/value", float),
                point1=tuple(raw.get_vec(f"{base}/point1")),
                point2=tuple(raw.get_vec(f"{base}/point2")),
                radius=raw.get_required(f"{base}/radius", float)))
        # reference: src/M2ulPhyS.cpp:3682-3760
        for k in range(1, raw.get("spongezone/numSpongeZones", 0) + 1):
            base = f"spongezone{k}"
            if raw.has(f"{base}/isEnabled") and not raw.get(
                    f"{base}/isEnabled", 1):
                continue
            out.append(self._build_sponge_zone(raw, base))
        if rc.use_mms:
            # reference: src/masa_handler.cpp + MASA_forcings,
            # src/forcing_terms.cpp:956-1012
            known = ("isEnabled", "name", "compare_rhs", "save_details")
            overrides = {k.split("/", 1)[1]: raw.get(k, 0.0)
                         for k in raw.keys_under("mms")
                         if k.split("/", 1)[1] not in known}
            self.masa = MasaHandler(rc.mms_name, self.mixture, self.fluxes,
                                    rc=rc, overrides=overrides)
            if not rc.mms_compare_rhs:
                # with compare_rhs the source stays out of the RHS
                # (reference: rhs_operator.cpp:454)
                out.append(self.masa.make_forcing(self.tables))
        return out

    def _build_sponge_zone(self, raw, base):
        """One [spongezoneN] section -> SpongeZone (tps_tpu solvers/
        compressible.py:478-558; reference: src/M2ulPhyS.cpp:3682-3760)."""
        sz_type = raw.get(f"{base}/type", "none")
        if sz_type not in ("planar", "annulus"):
            raise ValueError(f"unknown sponge zone type '{sz_type}'")
        sol_type = raw.get_required(f"{base}/targetSolType")
        if sol_type not in ("userDef", "mixedOut"):
            raise ValueError(f"unknown sponge targetSolType '{sol_type}'")
        mix = self.mixture
        common = dict(
            mixture=mix,
            normal=tuple(raw.get_vec(f"{base}/normal", 3)),
            p0=tuple(raw.get_vec(f"{base}/p0", 3)),
            p_init=tuple(raw.get_vec(f"{base}/pInit", 3)),
            mult=raw.get(f"{base}/multiplier", 1.0),
            sz_type=sz_type,
            r1=raw.get(f"{base}/r1", 0.0),
            r2=raw.get(f"{base}/r2", 0.0),
        )
        if sol_type == "mixedOut":
            tol = raw.get(f"{base}/tolerance", 1e-5)
            self._check_sampling_plane(base, common, tol)
            return SpongeZone(target_u=None, sol_type="mixedOut", tol=tol,
                              fluxes=self.fluxes, **common)
        rho = raw.get_required(f"{base}/density", float)
        vel = tuple(raw.get_vec(f"{base}/uvw", 3))
        pressure = raw.get_required(f"{base}/pressure", float)
        mass_fracs = []
        if mix.num_active_species > 0:
            i2m = self.plasma.input_to_mixture
            for sp in range(mix.num_active_species):
                inp_idx = int(np.where(i2m == sp)[0][0])
                mass_fracs.append(raw.get_required(
                    f"{base}/mass_fraction/species{inp_idx + 1}", float))
        single_t, te = False, None
        if mix.two_temperature:
            single_t = bool(raw.get(f"{base}/single_temperature", 0))
            if not single_t:
                te = raw.get_required(f"{base}/electron_temperature", float)
        target = sponge_target_conserved(mix, rho, vel, pressure,
                                         tuple(mass_fracs), te, single_t)
        return SpongeZone(target_u=target, **common)

    def _check_sampling_plane(self, base, common, tol):
        """A mixedOut target averages over the nodes within tol of its
        sampling plane (the pInit plane, or the r1 cylinder); the
        reference finds them once at construction
        (src/forcing_terms.cpp:565-603).  None found would give a 0/0
        target, so it raises here."""
        dim = self.mixture.dim
        nrm = np.asarray(common["normal"][:dim], float)
        nrm = nrm / np.linalg.norm(nrm)
        xyz = np.asarray(self.tables_np.xyz_dof).reshape(-1, dim)
        p_init = np.asarray(common["p_init"][:dim])
        d_init = -np.einsum("nd,d->n", xyz - p_init, nrm)
        if common["sz_type"] == "planar":
            cnt = int(np.sum(np.abs(d_init) < tol))
        else:
            rad = xyz - p_init + d_init[:, None] * nrm
            cnt = int(np.sum(np.abs(np.linalg.norm(rad, axis=-1)
                                    - common["r1"]) < tol))
        if cnt == 0:
            raise ValueError(
                f"[{base}] mixedOut: no dof nodes within tolerance {tol} of "
                f"the sampling plane; raise {base}/tolerance (dof nodes are "
                "interior Gauss points)")

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

        multi = self.plasma is not None
        if multi and kind == "viscous_isothermal":
            # a mixture's VISC_ISOTH is the general wall with both thermal
            # conditions isothermal at Tw and no species flux (reference:
            # src/wallBC.cpp:96-112)
            Tw = fget("temperature", 300.0)
            return bcs.GeneralWallBC(heavy="isothermal", electron="isothermal",
                                     wall_temp=Tw, wall_temp_e=Tw)
        if multi and kind == "viscous_adiabatic":
            # VISC_ADIAB: the general wall with no heat or species flux
            # (src/wallBC.cpp:86-95)
            return bcs.GeneralWallBC(heavy="adiabatic", electron="adiabatic")
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
            return bcs.InletBC(input_state=(fget("density"), *uvw()[:nvel],
                                            *self._bc_mass_fractions(p)))
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

    def _bc_mass_fractions(self, params):
        """A mixture inlet's active-species mass fractions, in the
        mixture's order, from its mass_fraction/speciesN keys (input
        numbering; reference: src/M2ulPhyS.cpp:3629-3641)."""
        if self.plasma is None:
            return ()
        i2m = self.plasma.input_to_mixture
        ys = []
        for sp in range(self.mixture.num_active_species):
            key = f"mass_fraction/species{int(np.where(i2m == sp)[0][0]) + 1}"
            if key not in params:
                raise ValueError(
                    f"multi-species inlet needs {key} (mass fraction of "
                    f"'{self.plasma.species_names[sp]}')")
            ys.append(float(str(params[key]).strip("'\"")))
        return tuple(ys)

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
                                        cuda_faces.launches,
                                        cuda_faces.variant_launches))
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
        if self.masa is not None:
            # the exact manufactured state at the nodes (reference:
            # M2ulPhyS::projectExactSolution, src/M2ulPhyS.cpp:1925-1943)
            return self.masa.exact_U(xyz, 0.0).to(self.dtype)
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
        if self.masa is not None:
            print(f"[mms] t={float(self.time):.6e} L2 solution error = "
                  f"{self.mms_solution_error():.8e}", flush=True)
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

    def _init_species_from_lte(self):
        """Overwrite the state with the multi-level Saha/Boltzmann
        equilibrium of its bulk (rho, momentum, rhoE) fields, the Newton in
        f64 and the species clipped at 0 (reference: io/restartFromLTE +
        M2ulPhyS::initilizeSpeciesFromLTE, src/M2ulPhyS.cpp:2388-2470;
        tps_tpu solvers/compressible.py:1662-1682).  Nothing for a fluid
        without species."""
        mix = self.mixture
        if getattr(mix, "num_active_species", 0) == 0:
            return
        U = state_from_lte(mix, self.U.to(torch.float64))
        lo, hi = mix.nvel + 2, mix.nvel + 2 + mix.num_active_species
        U = torch.cat([U[..., :lo], torch.clamp(U[..., lo:hi], min=0.0),
                       U[..., hi:]], dim=-1)
        self._loop.U.copy_(U)
        self.U = self._loop.U

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

    def mms_solution_error(self):
        """L2 error of the state against the exact manufactured state at
        the current time (the JAX solver's report, tps_tpu solvers/
        compressible.py:1564-1572; reference: checkSolutionError,
        src/M2ulPhyS.hpp:361-366)."""
        return float(solution_error(self.tables, self.mixture, self.U,
                                    self.masa.up_fn, self.time))

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

    # -- the plasma-coupling contract (reference: src/solver.hpp:121-144;
    #    tps_tpu solvers/compressible.py:1763-1829) ----------------------
    def coupling_nodes(self):
        """The FieldInterpolator.build arguments of the fields the coupling
        exchanges (DG dof fields [ne, ndof]), and their points [n, dim]."""
        return ({"src_mesh": self.mesh, "src_order": self.config.order,
                 "src_basis": "gauss-legendre" if self.config.basis_type == 0
                 else "gauss-lobatto"},
                np.asarray(self.tables_np.xyz_dof).reshape(-1, self.mesh.dim))

    def evaluate_plasma_conductivity(self):
        """sigma at the solution nodes [ne, ndof] (reference:
        M2ulPhyS::evaluatePlasmaConductivityGF, src/M2ulPhyS.cpp:4265): the
        source term's, from the mixture's transport or the LTE sigma
        table; 0 for dry air."""
        if self._source_term is None:
            return torch.zeros_like(self.joule_heating)
        return self._source_term.plasma_conductivity(
            self.U, self.mixture.primitives(self.U))

    def get_plasma_conductivity(self):
        return self.evaluate_plasma_conductivity()

    def get_joule_heating(self):
        return self.joule_heating

    def set_joule_heating(self, qj):
        """The Joule heating at the solution nodes [ne, ndof], copied into
        the tensor the forcing (and a captured step) reads."""
        self.joule_heating.copy_(torch.as_tensor(qj).reshape(
            self.joule_heating.shape))

    def get_efield(self):
        return self.efield

    def set_efield(self, e):
        """The EM E-field amplitude at the solution nodes [ne, ndof]
        (reference: interpElectricFieldFromEMToFlow,
        src/cycle_avg_joule_coupling.cpp:290-330), copied in place; the
        Boltzmann bus reads it, the flow's source term does not (as in the
        JAX package)."""
        self.efield.copy_(torch.as_tensor(e).reshape(self.efield.shape))

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
