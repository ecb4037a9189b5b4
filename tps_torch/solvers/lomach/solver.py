"""LoMachSolver: the low-Mach orchestrator (reference: src/loMach.cpp).

The port of the JAX package's solvers/lomach/solver.py.  Owns the mesh and
the H1 space, builds the models from the ini input ([loMach] section;
the factory of src/loMach.cpp:148-208), and steps thermoChem -> flow ->
turbModel (reference: solveStep :414-437) with BDF order ramping.

The step loop (step_graph.py): every step's CG solves run in blocks of
masked iterations through one `SolveLoops`.  On a CUDA device, once the
BDF order is constant (the JAX package's chunked steps start there too,
its `_chunkable`), the first such step runs eagerly on a side stream, the
next is captured as a StepGraph, and every step from then on is a replay
of it; the ramp-up steps run eagerly.  `cuda_graphs = False` keeps every
step eager (the graphs' reference).  The lagged dense factors are
refreshed when due outside the graph: the thermo's before the step, the
flow's after the thermo step (host work between two of the graph's
segments), as in the JAX package's per-step loop.  Each step
adds its solves' iterations and relative residuals to a device ring;
the ring is read every `time/mcsLagSteps` steps, at a checkpoint and at
the end, and a pressure or velocity solve that ended above tolerance
raises there, as the JAX package's convergence check does (a
checkpoint never holds a step whose solve failed).

The models: constant-property, calorically-perfect, LTE-table
(`lte-thermo-chem`, its tables read with io/h5lite.py) and finite-rate
reacting (`reacting-flow`, reacting_flow.py: the argon plasma stack or the
simple Pr/Sc tier) thermo-chemistry; the planar Tomboulides flow, or with
`loMach/axisymmetric` the (r, z) flow with swirl (axisym.py) and the
radius weight in the calorically-perfect and LTE thermo's forms; the
geometric sponge ([spongeMultiplier], sponge.py); external data
(interop/ext_data.py): the `interpolate` inlet, whose ramped values the
step writes into the flow's and the thermo's BC tensors from a device
step counter, species initialisation, the zeta-f inlet file and the
static-RANS eddy-viscosity file.

Out of the slice, each raising NotImplementedError with its ROADMAP item:
running statistics (A12) and domain decomposition (A8).
"""

from __future__ import annotations

import os
import time as _time

import numpy as np
import torch

from ...fem import h1
from ...io import h5lite
from ...mesh import generators
from ..base import Solver, register_solver
from .base import (ConstantPropertyThermoChem, TemporalCoefficients,
                   ZeroFlow, ZeroTurbModel)
from .axisym import TomboulidesAxisym
from .lte_thermo import LteThermoChem
from .step_graph import SolveLoops, StepGraph
from .thermo_chem import CaloricallyPerfectThermoChem, TemperatureDirichlet
from .tomboulides import PressureDirichlet, Tomboulides, VelocityDirichlet
from .turb import AlgebraicSubgridModel

RING = 64  # steps of solve info kept on the device between two reads


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported to tps_torch yet "
                               f"(ROADMAP {item})")


def check_slice(inp):
    """Raise NotImplementedError for any low-Mach input this slice does not
    run, on every device alike."""
    if inp.get("averaging/sampleFreq", 0) or inp.has("averaging/startIter"):
        raise _not_ported("running statistics ([averaging])", "A12")
    if max(int(inp.get("mesh/partitions", 1) or 1), 1) > 1:
        raise _not_ported("domain decomposition (mesh/partitions > 1)", "A8")


def _build_reacting_flow(inp, tab, temp_bcs, cg_tol, cg_maxiter, qt_bcs=(),
                         spec_bcs=()):
    """Finite-rate reacting thermo-chemistry from the [species]/[reactions]
    schema (tps_tpu/solvers/lomach/solver.py:106-247): the argon plasma
    stack where a transport model is named and an electron is among the
    species, else the simple tier over the input species order."""
    from ...physics.plasma_config import (build_plasma, parse_reactions,
                                          read_species)
    from .reacting_flow import ReactingFlow, SpeciesSet

    nsp = inp.get("species/numSpecies", 0)
    has_electron = any(inp.get(f"species/species{s}/name", "") == "E"
                       for s in range(1, nsp + 1))
    common = dict(
        p_thermo=inp.get("loMach/ambientPressure", 101325.0),
        closed_system=not bool(inp.get("loMach/openSystem", 0)),
        n_substeps=inp.get("loMach/reacting/sub-steps", 4),
        temp_bcs=tuple(temp_bcs), qt_bcs=qt_bcs, spec_bcs=spec_bcs,
        T_init=inp.get("initialConditions/temperature", 300.0),
        cg_tol=cg_tol, cg_maxiter=cg_maxiter)
    if has_electron and inp.get("plasma_models/transport_model", ""):
        pl = build_plasma(inp, tab.dim, tab.dim)
        return ReactingFlow(
            tab, species_names=pl.species_names, mixture=pl.mixture,
            transport=pl.transport, chemistry=pl.chemistry,
            radiation=pl.radiation,
            operator_split=bool(inp.get("loMach/reacting/operator-split", 1)),
            Y_init=pl.initial_mass_fractions,
            const_plasma_conductivity=inp.get(
                "plasma_models/const_plasma_conductivity", 0.0),
            chemistry_base=pl.chemistry_base,
            ramp_start=inp.get("loMach/reactingFlow/ramp-chem/ramp_start",
                               -1.0),
            ramp_time=inp.get("loMach/reactingFlow/ramp-chem/ramp_time",
                              -1.0),
            **common)

    names, mws, _, hf, cv, imf, _ = read_species(inp, 2.5)
    chemistry = parse_reactions(
        inp, len(names), SpeciesSet(mws, names.index("E") if "E" in names
                                    else -1), species_names=names)
    return ReactingFlow(
        tab, species_names=names, mw=tuple(mws), molar_cv_over_R=tuple(cv),
        formation_energy=tuple(hf), chemistry=chemistry,
        Y_init=np.asarray(imf), **common)


def _build_sponge(inp, tab):
    """The geometric sponge of [spongeMultiplier] (reference:
    src/geometricSponge.cpp), or None."""
    if not any(inp.get(f"spongeMultiplier/{k}", 0)
               for k in ("uniform", "plane", "cylinder", "annulus")):
        return None
    from .sponge import (AnnulusSponge, CylinderSponge, GeometricSponge,
                         PlaneSponge)

    key = "spongeMultiplier"
    plane = cylinder = annulus = None
    uniform_mult = (inp.get(f"{key}/uniformMult", 1.0)
                    if inp.get(f"{key}/uniform", 0) else None)
    if inp.get(f"{key}/plane", 0):
        plane = PlaneSponge(
            point=tuple(inp.get_vec(f"{key}/planePoint")),
            normal=tuple(inp.get_vec(f"{key}/planeNormal")),
            width=inp.get(f"{key}/planeWidth", 1e-8),
            mult=inp.get(f"{key}/planeMult", 1.0))
    if inp.get(f"{key}/cylinder", 0):
        cylinder = CylinderSponge(
            radius_x=inp.get(f"{key}/cylinderRadiusX", -1.0),
            radius_y=inp.get(f"{key}/cylinderRadiusY", -1.0),
            radius_z=inp.get(f"{key}/cylinderRadiusZ", -1.0),
            width=inp.get(f"{key}/cylinderWidth", 1e-8),
            mult=inp.get(f"{key}/cylinderMult", 1.0))
    if inp.get(f"{key}/annulus", 0):
        annulus = AnnulusSponge(
            point=tuple(inp.get_vec(f"{key}/annulusPoint",
                                    default=[0.0, 0.0, 0.0])),
            radius_y=inp.get(f"{key}/annulusRadiusY", -1.0),
            width=inp.get(f"{key}/annulusWidth", 1e-8),
            mult=inp.get(f"{key}/annulusMult", 1.0))
    return GeometricSponge(tab, uniform_mult=uniform_mult, plane=plane,
                           cylinder=cylinder, annulus=annulus)


def _build_lte_thermo(inp, tab, temp_bcs, cg_tol, cg_maxiter, weight_q=None,
                      qt_bcs=()):
    """LTE table thermo-chem from loMach/ltethermo/table-file (reference:
    src/lte_thermo_chem.cpp:83-145, dataset T_mu_kap_sig_R_Cp), read with
    io/h5lite.py."""
    from ...physics.plasma_config import read_table_input
    from ...physics.radiation import NetEmission
    from ...physics.tables import LinearTable

    table_file = inp.get_required("loMach/ltethermo/table-file")
    data = np.asarray(h5lite.read(table_file)["T_mu_kap_sig_R_Cp"])
    T, mu, kap, sig, Rg, Cp = (data[:, i] for i in range(6))
    p0 = inp.get("loMach/ambientPressure", 101325.0)

    radiation = None
    if inp.get("plasma_models/radiation_model", "none") == "net_emission":
        radiation = NetEmission(read_table_input(
            inp, "plasma_models/radiation_model/net_emission/tabulated"))

    return LteThermoChem(
        tab,
        flow=None,
        rho_table=LinearTable(x=T, f=p0 / (Rg * T)),
        cp_table=LinearTable(x=T, f=Cp),
        mu_table=LinearTable(x=T, f=mu),
        kappa_table=LinearTable(x=T, f=kap),
        sigma_table=LinearTable(x=T, f=sig),
        radiation=radiation,
        temp_bcs=tuple(temp_bcs),
        qt_bcs=qt_bcs,
        weight_q=weight_q,
        T_init=inp.get("initialConditions/temperature", 300.0),
        cg_tol=inp.get("loMach/ltethermo/linear-solver-rtol", cg_tol),
        cg_maxiter=inp.get("loMach/ltethermo/linear-solver-max-iter",
                           cg_maxiter),
    )


def _build_lomach_mesh(inp):
    """[mesh] generator extension or [loMach] mesh file + scale."""
    if inp.has("mesh/generator"):
        gen = inp.get("mesh/generator", "box2d")
        if gen == "box2d":
            return generators.box_2d(
                nx=inp.get("mesh/nx", 8), ny=inp.get("mesh/ny", 8),
                x1=inp.get("mesh/x1", 1.0), y1=inp.get("mesh/y1", 1.0),
                periodic_x=bool(inp.get("mesh/periodic_x", 0)),
                periodic_y=bool(inp.get("mesh/periodic_y", 0)),
            )
        if gen == "box3d":
            return generators.box_3d(
                nx=inp.get("mesh/nx", 8), ny=inp.get("mesh/ny", 8),
                nz=inp.get("mesh/nz", 8),
                bounds=((0.0, inp.get("mesh/x1", 1.0)),
                        (0.0, inp.get("mesh/y1", 1.0)),
                        (0.0, inp.get("mesh/z1", 1.0))),
                periodic=(bool(inp.get("mesh/periodic_x", 0)),
                          bool(inp.get("mesh/periodic_y", 0)),
                          bool(inp.get("mesh/periodic_z", 0))),
            )
        raise ValueError(f"unknown generator {gen}")
    from ...mesh.mfem_reader import read_mesh

    mesh = read_mesh(inp.get_required("loMach/mesh"))
    scale = inp.get("loMach/scale-mesh", 1.0)
    if scale != 1.0:
        mesh = mesh.scaled(scale)
    return mesh


@register_solver("loMach")
class LoMachSolver(Solver):
    # on a CUDA device constant-order steps are replays of a captured step
    # graph; False steps eagerly there (the graphs' reference)
    cuda_graphs = True

    def __init__(self, config, tps=None, device=None):
        super().__init__(config, tps=tps)
        if device is None:
            device = getattr(tps, "device", None) or "cuda"
        # TF32 stays off on this path (ROADMAP C, matmul precision): the
        # solver never switches it on, so its f32 matmuls and the dense
        # factors run in full f32 on the card
        self.device = torch.device(device)

    def initialize(self):
        inp = self.config.raw
        check_slice(inp)
        self.dtype = torch.get_default_dtype()

        self.mesh = _build_lomach_mesh(inp)
        order = inp.get("loMach/order", 1)
        self.tab_np = h1.build_h1(self.mesh, order=order)
        self.tab = self.tab_np.to_torch(self.dtype, self.device)

        self.dt = inp.get("time/dt_fixed", 1e-3)
        self.max_bdf_order = inp.get("time/bdfOrder", 3)
        self.max_iters_cfg = inp.get("loMach/maxIters", 10)
        self.output_freq = inp.get("loMach/outputFreq", 1000)
        self.lag = max(min(int(inp.get("time/mcsLagSteps", 8)), RING), 1)
        cg_tol = inp.get("time/solverRelTolerance", 1e-12)
        cg_maxiter = inp.get("time/maxSolverIteration", 500)
        # the flow's solves have their own tolerance, looser by default
        # (reference: tomboulides.hpp:149 default_rtol_ 1e-10)
        flow_tol = inp.get("loMach/tomboulides/psolve-rtol",
                           inp.get("loMach/rtol", 1e-10))

        vel_bcs, temp_bcs, pres_bcs, inlet_info, qt_attrs, ext_specs = \
            self._read_bcs(inp)
        self.sponge = _build_sponge(inp, self.tab)

        # thermo-chem model factory (reference: src/loMach.cpp:148-208)
        axisym = bool(inp.get("loMach/axisymmetric", 0))
        weight_q = self.tab.xyz_q[..., 0] if axisym else None
        tc_model = inp.get("loMach/thermo-solver", "constant-property")
        if tc_model in ("calorically-perfect", "calorically_perfect"):
            self.thermo = CaloricallyPerfectThermoChem(
                self.tab,
                gas_constant=inp.get("loMach/calperfect/Rgas", 287.058),
                gamma=inp.get("loMach/calperfect/gamma", 1.4),
                p_thermo=inp.get("loMach/ambientPressure", 101325.0),
                closed_system=bool(inp.get("loMach/closedSystem", 0)),
                constant_mu=(
                    inp.get("loMach/calperfect/viscosity/mu", None, float)
                    if inp.get("loMach/calperfect/viscosity-model",
                               "sutherland") == "constant"
                    else None),
                Pr=inp.get("loMach/calperfect/Prandtl", 0.71),
                temp_bcs=tuple(temp_bcs),
                qt_bcs=(tuple(qt_attrs),) if qt_attrs else (),
                T_init=inp.get("loMach/calperfect/ic/temperature", 300.0),
                sponge=self.sponge, weight_q=weight_q,
                sw_stab=bool(
                    inp.get("loMach/calperfect/streamwise-stabilization", 0)),
                reh_factor=inp.get("loMach/calperfect/Reh_factor", 0.5),
                reh_offset=inp.get("loMach/calperfect/Reh_offset", 1.0),
                cg_tol=cg_tol, cg_maxiter=cg_maxiter,
            )
        elif tc_model == "lte-thermo-chem":
            self.thermo = _build_lte_thermo(
                inp, self.tab, temp_bcs, cg_tol, cg_maxiter,
                weight_q=weight_q,
                qt_bcs=(tuple(qt_attrs),) if qt_attrs else ())
        elif tc_model == "reacting-flow":
            self.thermo = _build_reacting_flow(
                inp, self.tab, temp_bcs, cg_tol, cg_maxiter,
                qt_bcs=(tuple(qt_attrs),) if qt_attrs else (),
                spec_bcs=self._species_bcs(inp, inlet_info, qt_attrs))
            if inp.get("plasma_models/initialize_species", 0):
                self._initialize_species(inp)
        else:
            self.thermo = ConstantPropertyThermoChem(
                self.tab,
                rho=inp.get("loMach/constprop/rho", 1.0),
                mu=inp.get("loMach/constprop/mu", 1.0e-3),
            )

        # optional smooth hot-kernel temperature IC:
        #   [initialConditions]
        #   profile = gaussian   temperature = peak, backgroundTemperature,
        #   center = 'x y [z]'   width = 'wx wy [wz]' (1e30 = uniform dim)
        if inp.get("initialConditions/profile", "uniform") == "gaussian" \
                and hasattr(self.thermo, "set_temperature"):
            Tpeak = inp.get("initialConditions/temperature", 300.0)
            Tback = inp.get("initialConditions/backgroundTemperature", 300.0)
            dim = self.mesh.dim
            cen = np.asarray(inp.get_vec("initialConditions/center",
                                         default=[0.0] * dim))
            wid = np.asarray(inp.get_vec("initialConditions/width",
                                         default=[1.0] * dim))
            xyz = self.tab_np.xyz
            arg = sum(((xyz[:, d] - cen[d]) / wid[d]) ** 2
                      for d in range(dim))
            self.thermo.set_temperature(Tback + (Tpeak - Tback) * np.exp(-arg))

        # flow model factory
        flow_model = inp.get("loMach/flow-solver", "tomboulides")
        gvec = inp.get_vec("loMach/gravity", self.tab.dim) \
            if inp.has("loMach/gravity") else None
        if flow_model == "tomboulides" and axisym:
            self.flow = TomboulidesAxisym(
                self.tab, self.thermo, vel_bcs=tuple(vel_bcs),
                swirl=bool(inp.get("loMach/swirl", 0)), sponge=self.sponge,
                cg_tol=flow_tol, cg_maxiter=cg_maxiter, gravity=gvec,
            )
        elif flow_model == "tomboulides":
            self.flow = Tomboulides(
                self.tab, self.thermo, vel_bcs=tuple(vel_bcs),
                pres_bcs=tuple(pres_bcs), sponge=self.sponge, cg_tol=flow_tol,
                cg_maxiter=cg_maxiter,
                mesh=self.mesh,  # enables p-multigrid pressure precond
                gravity=gvec,
            )
        elif flow_model == "zero-flow":
            self.flow = ZeroFlow(self.tab)
        else:
            raise ValueError(f"unknown flow solver '{flow_model}'")
        if hasattr(self.thermo, "flow"):
            self.thermo.flow = self.flow
        self._build_ext_data(ext_specs)

        self.turb = self._build_turb(inp, inlet_info)
        if self.turb is not None and hasattr(self.flow, "turb"):
            self.flow.turb = self.turb
        if self.turb is None:
            self.turb = ZeroTurbModel(self.tab)

        # initial condition
        if inp.get("loMach/tomboulides/ic", None) == "tgv2d" \
                and flow_model == "tomboulides":
            x, y = self.tab.xyz[:, 0], self.tab.xyz[:, 1]
            self.flow.set_velocity(torch.stack(
                [torch.sin(x) * torch.cos(y), -torch.cos(x) * torch.sin(y)],
                -1))

        self.time = 0.0
        self.iter = 0
        self.loops = SolveLoops()
        self._side = None  # the warm-up and capture stream (CUDA)
        self._graphs = {}  # (order, dt) -> StepGraph
        self._warm = set()  # (order, dt) whose warm-up step has run
        self._ring = None  # [RING, len(info keys)] solve info of the last steps
        self._info_keys = None
        self._unread = 0  # steps in the ring not read yet
        self.info_log = []  # the read rows (dicts), newest last
        self.info_reads = 0  # host reads of the ring
        self._wall0 = _time.perf_counter()
        # the E-field amplitude a coupling sets (set_efield; the Boltzmann
        # bus reads it)
        self.efield = torch.zeros(self.tab.ndofs, dtype=self.dtype,
                                  device=self.device)

        self.outdir = self.config.outdir
        if inp.get("io/enableRestart", 0):
            self.read_restart()

    def _read_bcs(self, inp):
        """[boundaryConditions/*]: velocity, temperature and pressure
        Dirichlet BCs, inlets for the turbulence model and the species,
        isothermal walls, interpolated inlets."""
        vel_bcs, temp_bcs, pres_bcs = [], [], []
        inlet_info = []  # (patch, "uniform" | "interpolate", base)
        qt_attrs = []  # isothermal-wall patches: Qt = 0 Dirichlet there
        ext_specs = []  # (patch, profile file, ramp steps)
        dim = self.mesh.dim
        for sub in inp.sections_under("boundaryConditions"):
            base = f"boundaryConditions/{sub}"
            if not inp.has(f"{base}/patch"):
                continue
            patch = inp.get_required(f"{base}/patch", int)
            kind = inp.get(f"{base}/type", "viscous")
            # temperature Dirichlet applies to walls and inlets
            if kind != "outlet" and inp.has(f"{base}/temperature"):
                temp_bcs.append(TemperatureDirichlet(
                    attrs=(patch,),
                    value=inp.get_required(f"{base}/temperature", float)))
            if kind in ("viscous", "no-slip", "viscous_isothermal"):
                vel = inp.get_vec(f"{base}/velocity", default=[0.0] * dim)
                vel_bcs.append(VelocityDirichlet(attrs=(patch,),
                                                 value=tuple(vel)))
                if inp.has(f"{base}/temperature"):
                    qt_attrs.append(patch)
            elif kind == "inlet":
                vel = inp.get_vec(f"{base}/velocity", default=[0.0] * dim)
                vel_bcs.append(VelocityDirichlet(
                    attrs=(patch,), value=tuple(vel),
                    ramp_time=inp.get(f"{base}/rampTime", 0.0)))
                inlet_info.append((patch, "uniform", base))
            elif kind in ("outlet", "pressure"):
                # pressure Dirichlet outlet (reference: pres_dbcs_,
                # src/tomboulides.cpp:1865-1870)
                pres_bcs.append(PressureDirichlet(
                    attrs=(patch,), value=inp.get(f"{base}/pressure", 0.0)))
            elif kind == "interpolate":
                # the external-data inlet (reference: GaussianInterpExtData):
                # its values are written into the BC tensors every step
                vel_bcs.append(VelocityDirichlet(attrs=(patch,),
                                                 value=(0.0,) * dim))
                ext_specs.append((patch,
                                  inp.get(f"{base}/name", "inletPlane.csv"),
                                  inp.get(f"{base}/rampSteps", 1)))
                inlet_info.append((patch, "interpolate", base))
            # any other type: a natural (do-nothing) boundary
        return vel_bcs, temp_bcs, pres_bcs, inlet_info, qt_attrs, ext_specs

    @staticmethod
    def _species_bcs(inp, inlet_info, qt_attrs):
        """Species Dirichlet BCs of the reacting thermo (reference:
        zero-Neumann by default at inlets and walls, Dirichlet with
        loMach/reactingFlow/neumann-species-* = 0, src/reactingFlow.cpp:
        790-792): an inlet takes its speciesMassFractions (a pure
        background without them), an isothermal wall a pure background."""
        spec_bcs = []
        if not bool(inp.get("loMach/reactingFlow/neumann-species-inlet", 1)):
            for patch, _kind, base in inlet_info:
                vals = (inp.get_vec(f"{base}/speciesMassFractions")
                        if inp.has(f"{base}/speciesMassFractions") else None)
                spec_bcs.append(((patch,), vals))
        if not bool(inp.get("loMach/reactingFlow/neumann-species-wall", 1)):
            for patch in qt_attrs:
                spec_bcs.append(((patch,), None))
        return tuple(spec_bcs)

    def _initialize_species(self, inp):
        """Y and its history from plasma_models/initialize_file (reference:
        setFieldInitSpec, src/gaussianInterpExtData.cpp:559-748),
        renormalised; after the thermo's set-up, so a closed system keeps
        the mass of the input composition, as in the JAX package."""
        from ...interop.ext_data import volume_field_from_file

        fname = inp.get_required("plasma_models/initialize_file")
        Y0 = np.atleast_2d(np.asarray(volume_field_from_file(self.tab,
                                                             fname)))
        if Y0.shape[0] != self.tab.ndofs:
            Y0 = Y0.T
        nsp = self.thermo.Y.shape[1]
        if Y0.shape[1] != nsp:
            raise ValueError(f"{fname}: {Y0.shape[1]} species columns, "
                             f"model has {nsp}")
        Y0 = np.clip(Y0, 0.0, None)
        Y0 = Y0 / np.maximum(Y0.sum(axis=1, keepdims=True), 1e-300)
        self.thermo.set_mass_fractions(Y0)

    def _build_ext_data(self, ext_specs):
        """The interpolated inlets (reference: GaussianInterpExtData): each
        step writes their ramped velocity (and swirl) and their
        temperature into the flow's and the thermo's BC tensors
        (`_apply_ext_data`); a thermo with `T_bc` (all but the constant-
        property one) takes
        their dofs as temperature Dirichlet dofs, once, as the JAX package
        does."""
        from ...interop.ext_data import GaussianInterpExtData

        self.ext_data = [GaussianInterpExtData(self.tab, fname, (patch,),
                                               ramp_steps=ramp)
                         for patch, fname, ramp in ext_specs]
        if self.ext_data and getattr(self.thermo, "T_bc", None) is not None:
            for ed in self.ext_data:
                self.thermo.T_mask.index_fill_(0, ed.dofs, 0.0)

    def _apply_ext_data(self):
        """The interpolated inlets' step (device work; the JAX package's
        extData step before the thermo's, loMach.cpp:414)."""
        swirl = getattr(self.flow, "swirl_bc_values", None)
        tvals = getattr(self.thermo, "T_bc", None)
        for ed in self.ext_data:
            ed.step()
            self.flow.vel_bc_values.index_copy_(0, ed.dofs,
                                                ed.velocity_values())
            sv = ed.swirl_values()
            if swirl is not None and sv is not None:
                swirl.index_copy_(0, ed.dofs, sv)
            if tvals is not None:
                tvals.index_copy_(0, ed.dofs, ed.temperature_values())

    def _build_turb(self, inp, inlet_info):
        """The turbulence model (reference: src/loMach.cpp:153-177); None
        for none."""
        turb = inp.get("loMach/turb-model", inp.get("loMach/sgsModel", "none"))
        if turb in ("smagorinsky", "sigma", "wale"):
            return AlgebraicSubgridModel(
                self.tab, self.flow, model=turb,
                const=inp.get("loMach/sgsModelConstant", 0.0) or None)
        if turb == "algebraic-rans":
            from .rans import AlgebraicRans

            walls = self._wall_attrs(inp, "loMach/algebraic-rans/walls")
            return AlgebraicRans(
                self.tab, self.flow, self.thermo,
                wall_distance=self._h1_wall_distance(walls),
                max_mixing_length=inp.get(
                    "loMach/algebraic-rans/max-mixing-length", 1.0e30))
        if turb == "zeta-f":
            from .zeta_model import ZetaModel

            # inlet tke/v2 Dirichlet values: uniform from {inlet}/tke
            # (v2 = 2/3 tke) (reference: zetaModel.cpp:481-540)
            # or, at an interpolated inlet, from ransModel/zeta-f-file
            # scaled by ransModel/bc-fac (setInletTurbScalars)
            tdr_ic = inp.get("ransModel/tdr-ic", 1.0e-8)
            tke_file = inp.get("ransModel/zeta-f-file", None)
            inlet_bcs = []
            for patch, kind, base in inlet_info:
                if kind == "uniform" and inp.has(f"{base}/tke"):
                    tke = inp.get(f"{base}/tke", 0.0)
                    inlet_bcs.append(((patch,), tke, tdr_ic,
                                      (2.0 / 3.0) * tke))
                elif kind == "interpolate" and tke_file:
                    from ...interop.ext_data import inlet_scalars_from_file

                    _dofs, vals = inlet_scalars_from_file(
                        self.tab, tke_file, (patch,),
                        fac=inp.get("ransModel/bc-fac", 1.0))
                    inlet_bcs.append((
                        (patch,), vals[:, 0], tdr_ic,
                        vals[:, 1] if vals.shape[1] > 1 else None))
            return ZetaModel(
                self.tab, self.flow, self.thermo,
                wall_attrs=self._wall_attrs(inp, "ransModel/walls"),
                inlet_bcs=tuple(inlet_bcs),
                tke_ic=inp.get("ransModel/tke-ic", 1.0e-4), tdr_ic=tdr_ic,
                cg_tol=inp.get("ransModel/hsolve-rtol", 1e-10),
                cg_maxiter=inp.get("ransModel/hsolve-maxIters", 500))
        if turb == "static-rans":
            from .rans import StaticRans

            nut = inp.get("loMach/static-rans/eddy-viscosity", 0.0)
            visc_file = inp.get("loMach/static-rans/visc-file", None)
            if visc_file:
                from ...interop.ext_data import volume_field_from_file

                nut = volume_field_from_file(
                    self.tab, visc_file,
                    fac=inp.get("loMach/static-rans/visc-fac", 1.0))
            return StaticRans(self.tab, nut)
        return None

    def _wall_attrs(self, inp, key):
        return tuple(int(a) for a in inp.get_vec(key, default=[])) \
            or tuple(int(a) for a in np.unique(self.mesh.bdr_attrs))

    def _h1_wall_distance(self, wall_attrs):
        """Distance from every H1 dof to the nearest wall-boundary dof
        (serial wall distance; reference: src/mesh_base.cpp)."""
        xyz = self.tab_np.xyz
        wxyz = xyz[h1.boundary_dofs(self.tab_np, tuple(wall_attrs))]
        out = np.empty(len(xyz))
        for i in range(0, len(xyz), 4096):
            d = np.linalg.norm(
                xyz[i:i + 4096, None, :] - wxyz[None, :, :], axis=-1)
            out[i:i + 4096] = d.min(axis=1)
        return out

    @property
    def max_iters(self):
        return self.max_iters_cfg

    # -- the cycle-averaged Joule coupling's side (solvers/coupling.py), as
    #    CompressibleSolver's: H1 nodal fields
    def coupling_nodes(self):
        """The FieldInterpolator.build arguments of the fields the coupling
        exchanges, and their points [n, dim]."""
        return ({"src_mesh": self.mesh, "src_order": self.tab_np.order,
                 "src_basis": "gauss-lobatto", "src_tab": self.tab},
                np.asarray(self.tab_np.xyz))

    def evaluate_plasma_conductivity(self):
        return self.thermo.plasma_conductivity()

    def set_joule_heating(self, qj):
        self.thermo.set_joule_heating(qj)

    def set_efield(self, e):
        self.efield.copy_(e)

    # -- the step loop ---------------------------------------------------
    def solve(self):
        """Step to maxIters (reference: LoMachSolver::solve,
        src/loMach.cpp:543)."""
        self.solve_begin()
        while self.iter < self.max_iters and self.status == 0:
            self.solve_step()
        self.solve_end()

    def solve_step(self):
        """thermo -> flow -> turb (reference: loMach.cpp:414-437): the
        dense factors refreshed when due, then the step, eager or a graph
        replay; then the service tail."""
        order = min(self.iter + 1, self.max_bdf_order)
        coeff = TemporalCoefficients.bdf(order)
        self._refresh(self.thermo, order)
        graph = self._graph(coeff)
        if graph is not None:
            graph.replay()
        elif self._warming(coeff):
            dev = self.device
            self._side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(self._side):
                self._body(coeff)
            torch.cuda.current_stream(dev).wait_stream(self._side)
        else:
            self._body(coeff)
        self.time += self.dt
        self.iter += 1
        self._unread += 1
        if self._unread >= self.lag:
            self._read_info()
        if self.iter % self.output_freq == 0:
            self._read_info()
            wall = _time.perf_counter() - self._wall0
            si = self.info_log[-1] if self.info_log else {}
            txt = (f" [p: {si['p_iters']:.0f} it {si['p_res']:.1e}"
                   f" | v: {si['v_iters']:.0f} it {si['v_res']:.1e}]"
                   if "p_iters" in si else "")
            print(f"loMach step {self.iter} t={self.time:.6e} "
                  f"wall/step={wall / self.output_freq:.4f}s" + txt,
                  flush=True)
            self._wall0 = _time.perf_counter()
            self.write_restart()

    def _graphs_on(self, coeff):
        return (self.cuda_graphs and self.device.type == "cuda"
                and coeff.order == self.max_bdf_order)

    def _warming(self, coeff):
        """True for the first constant-order step on CUDA with graphs on:
        it runs eagerly on the capture stream (library handles, workspaces
        and caches set up before any capture)."""
        key = (coeff.order, self.dt)
        if not self._graphs_on(coeff) or key in self._warm:
            return False
        self._warm.add(key)
        if self._side is None:
            self._side = torch.cuda.Stream(device=self.device)
        return True

    def _graph(self, coeff):
        """The step graph of this order and dt, captured on its second
        step (the first warms up); None where steps run eagerly."""
        key = (coeff.order, self.dt)
        if not self._graphs_on(coeff) or key not in self._warm:
            return None
        graph = self._graphs.get(key)
        if graph is None:
            graph = StepGraph(self.loops, self._side)
            graph.capture(lambda: self._body(coeff))
            self._graphs[key] = graph
        return graph

    def _refresh(self, model, order):
        """A model's lagged dense factors refreshed when due (host-driven,
        eager), and their age advanced a step."""
        if hasattr(model, "precond_refresh"):
            model.precond_refresh(self.dt, order)
            if model._direct_age is not None:
                model._direct_age += 1

    def _body(self, coeff):
        """One step's device work (what a step graph holds): each model's
        step, then its solves' info into the ring.  The flow's factors
        are refreshed after the thermo step, from its density, as the JAX
        package's per-step loop does; a step graph runs that refresh as
        host work between its segments."""
        self.loops.begin_step()
        self._apply_ext_data()
        self.thermo.step(coeff, self.dt, self.loops)
        self.loops.host(lambda: self._refresh(self.flow, coeff.order))
        self.flow.advance(coeff, self.dt, self.loops)
        self.turb.step(coeff, self.dt, self.loops)
        info = {}
        for model in (self.flow, self.thermo, self.turb):
            info.update(getattr(model, "info", {}))
        if self._ring is None:  # the first step, always eager
            self._info_keys = tuple(info)
            self._ring = torch.zeros((RING, len(info)), dtype=self.dtype,
                                     device=self.device)
        row = torch.stack([info[k].to(self.dtype) for k in self._info_keys])
        self._ring.copy_(torch.cat((self._ring[1:], row[None])))

    def _read_info(self):
        """Read the ring's unread rows (one host read) and check the flow's
        solves converged (the JAX package's _check_solve_info)."""
        n, self._unread = min(self._unread, RING), 0
        if n == 0 or self._ring is None:
            return
        self.info_reads += 1
        rows = [dict(zip(self._info_keys, r))
                for r in self._ring[RING - n:].tolist()]
        self.info_log = (self.info_log + rows)[-1024:]
        for row in rows:
            if "p_res" in row:
                Tomboulides.check_solve_info(row)

    def solve_end(self):
        self._read_info()
        self.write_restart()

    # -- restart in the JAX package's layout -----------------------------
    @property
    def _restart_path(self):
        return os.path.join(self.outdir, "restart_lomach.sol.h5")

    def _restart_fields(self):
        """Model state registered for checkpointing (tps_tpu/solvers/lomach/
        solver.py:1013-1027)."""
        fields = {"velocity": self.flow.velocity()}
        if hasattr(self.flow, "p"):
            fields["pressure"] = self.flow.p
        if hasattr(self.thermo, "T"):
            fields["temperature"] = self.thermo.T
        if hasattr(self.thermo, "Y"):
            fields["species"] = self.thermo.Y
        fields["eddy_viscosity"] = self.turb.eddy_viscosity()
        return {k: v.detach().double().cpu().numpy() for k, v in fields.items()}

    def write_restart(self):
        os.makedirs(self.outdir, exist_ok=True)
        h5lite.write(self._restart_path,
                     {"solution": self._restart_fields()},
                     {"iteration": int(self.iter), "time": float(self.time),
                      "order": int(self.tab.order),
                      "dofs_global": int(self.tab.ndofs)})

    def read_restart(self):
        path = self._restart_path
        if not os.path.exists(path):
            raise FileNotFoundError(f"restart file not found: {path}")
        f = h5lite.read(path)
        self.iter = int(f.attrs["iteration"])
        self.time = float(f.attrs["time"])
        g = f["solution"]
        if hasattr(self.flow, "set_velocity"):
            self.flow.set_velocity(np.asarray(g["velocity"]))
            self.flow.t.fill_(self.time)
        if "pressure" in g and hasattr(self.flow, "p"):
            self.flow.p.copy_(torch.as_tensor(np.asarray(g["pressure"])))
        if "temperature" in g and hasattr(self.thermo, "set_temperature"):
            self.thermo.set_temperature(np.asarray(g["temperature"]))
        if "species" in g and hasattr(self.thermo, "Y"):
            # Y only, its history kept (tps_tpu/solvers/lomach/solver.py:
            # 1070-1071)
            self.thermo.Y.copy_(torch.as_tensor(np.asarray(g["species"])))
        if hasattr(self.thermo, "t"):
            # the ramp-chem clock (its windows are absolute time)
            self.thermo.t.fill_(self.time)

    def visualization(self):
        """ParaView VTK file of the model fields (reference: loMach pvdc)."""
        from ...io.visualization import write_vtk_h1

        path = os.path.join(self.outdir, f"lomach_{self.iter:08d}.vtk")
        write_vtk_h1(path, self.tab_np, self._restart_fields())
        return path
