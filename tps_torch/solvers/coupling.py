"""EM <-> flow couplings.

The port of the JAX package's solvers/coupling.py.

CycleAvgJouleCoupling (reference: src/cycle_avg_joule_coupling.cpp:
49-555): two meshes (flow and EM); every `solve-em-every-n` flow steps,
evaluate the plasma conductivity on the flow mesh, interpolate it to the
EM mesh, solve the quasimagnetostatic system, rescale the Joule heating
toward a target power (power control, constant or oscillating), and
interpolate the heating (and the E-field amplitude) back to the flow mesh,
where it enters the energy equation.  The plasma solver is the
compressible DG solver (`plasma-solver = compressible`, the reference's
default: DG dof fields, the heating a forcing of its RHS) or the low-Mach
one (`lomach`: H1 nodal fields, the heating a term of its thermo).  The
EM update runs between flow steps, outside the flow's step graphs, and
hands its fields over with `copy_` into the tensors the captured steps
read.  Host reads: the EM
solve's own (one on the dense path, one a restart cycle on GMRES), and
one of the total Joule heating and magnetic energy after the solve and
after the rescaling; nothing is read inside a flow step.

IndependentCoupling (reference: src/independent_coupling.cpp): runs the
compressible flow and the EM solver with no data exchange.

Not here: a 3-D EM mesh (`qms3d`, ROADMAP A10.2).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..interop.interpolation import FieldInterpolator
from .base import Solver, create_solver, register_solver
from .compressible import CompressibleSolver
from .em.qms import QuasiMagnetostaticSolverAxiSym
from .lomach.solver import LoMachSolver


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported to tps_torch yet "
                               f"(ROADMAP {item})")


@register_solver("cycle-avg-joule-coupled")
class CycleAvgJouleCoupling(Solver):
    def __init__(self, config, tps=None, em_solver=None, device=None):
        super().__init__(config, tps)
        self._em_in = em_solver
        self.device = device

    def initialize(self):
        inp = self.config.raw
        key = "cycle-avg-joule-coupled"
        self.solve_em_every_n = inp.get(f"{key}/solve-em-every-n", 100)
        self.input_power = inp.get(f"{key}/input-power", -1.0)
        self.initial_input_power = inp.get(f"{key}/initial-input-power",
                                           -1.0)
        self.fixed_conductivity = bool(inp.get(f"{key}/fixed-conductivity",
                                               0))
        # oscillating target power (reference :66-71)
        self.oscillating_power = bool(inp.get(f"{key}/oscillating-power", 0))
        self.power_amplitude = inp.get(f"{key}/input-power-amplitude", 0.0)
        self.power_period = inp.get(f"{key}/input-power-period", 1.0)

        # plasma (flow) solver (reference: plasma-solver :58-85)
        self.plasma_kind = inp.get(f"{key}/plasma-solver", "compressible")
        if not bool(inp.get(f"{key}/axisymmetric", 1)):
            raise _not_ported("the 3-D EM solver (qms3d)", "A10.2")
        flow_cls = (LoMachSolver if self.plasma_kind == "lomach"
                    else CompressibleSolver)
        self.flow = flow_cls(self.config, tps=self.tps, device=self.device)
        self.flow.initialize()
        if self._em_in is not None:
            self.em = self._em_in
        else:
            self.em = QuasiMagnetostaticSolverAxiSym(
                self.config, tps=self.tps, device=self.device)
            self.em.initialize()

        # plasma R/L diagnostics (reference: em/eval_Rplasma and
        # cycle_avg_joule_coupling.cpp:434-478)
        self.eval_rplasma = bool(inp.get("em/eval_Rplasma", 0)) or bool(
            inp.get(f"{key}/eval-Rplasma", 0))
        self.plasma_resistance = None
        self.plasma_inductance = None

        t0 = time.perf_counter()
        self._build_interpolators()
        self.interp_build_s = time.perf_counter() - t0
        self.em_log = []  # one dict per EM solve
        self.iter = 0
        self.time = 0.0

    def _build_interpolators(self):
        """Static cross-mesh interpolation tables (the gslib analog;
        reference interpConductivityFromFlowToEM :185 etc.): the flow's
        fields where its solver keeps them (H1 nodes on the low-Mach
        solver, DG dofs on the compressible one)."""
        em_tab = self.em.tab_np
        src, flow_pts = self.flow.coupling_nodes()
        self.flow_to_em = FieldInterpolator.build(
            points=np.asarray(em_tab.xyz), **src)
        self.em_to_flow = FieldInterpolator.build(
            self.em.mesh, em_tab.order, "gauss-lobatto", flow_pts)

    @property
    def max_iters(self):
        return self.flow.max_iters

    def solve_step(self):
        self._maybe_em_update()
        self.flow.solve_step()
        self.iter = self.flow.iter
        self.time = self.flow.time

    def solve(self):
        """The coupled loop (reference: CycleAvgJouleCoupling::solve,
        src/cycle_avg_joule_coupling.cpp:384-520): an EM update every
        `solve-em-every-n` steps; between them the compressible solver
        runs chunks of steps (the JAX package's chunked branch: a power of
        two up to the next EM update), the low-Mach solver one
        `solve_step` each (the JAX package's per-step branch)."""
        ev = max(self.solve_em_every_n, 1)
        chunked = self.plasma_kind != "lomach"
        while self.iter < self.max_iters and self.status == 0:
            self._maybe_em_update()
            target = min(self.iter + ev - self.iter % ev, self.max_iters)
            while self.flow.iter < target and self.status == 0:
                if chunked:
                    n = min(self.flow._chunk_size(), target - self.flow.iter)
                    m = 1
                    while m * 2 <= n:
                        m *= 2
                    self.flow.solve_chunk(m)
                else:
                    self.flow.solve_step()
                self.status = getattr(self.flow, "status", 0)
            self.iter = self.flow.iter
            self.time = self.flow.time
        self.solve_end()

    def _maybe_em_update(self):
        if self.iter % self.solve_em_every_n != 0:
            return
        # 1) sigma on the flow mesh -> EM mesh
        if not self.fixed_conductivity or self.iter == 0:
            self.em.set_plasma_conductivity(self.flow_to_em(
                self.flow.evaluate_plasma_conductivity()))
        # 2) EM solve
        self.em.solve_step()
        tot_jh_raw = self.em.total_joule_heating()
        em = self.em
        print(f"(cycle-avg-joule-coupled) EM solve: {em.last_solve_iters} "
              f"Krylov iters, relres {em.last_solve_relres:.3e}, "
              f"{em.last_solve_ms:.1f} ms", flush=True)
        print(f"(cycle-avg-joule-coupled) total input Joule heating = "
              f"{tot_jh_raw:.6e}", flush=True)
        entry = {"iter": self.iter, "em_iters": em.last_solve_iters,
                 "relres": em.last_solve_relres, "ms": em.last_solve_ms,
                 "device_ms": em.last_solve_device_ms,
                 "joule_raw": tot_jh_raw}
        # plasma resistance/inductance report (reference
        # cycle_avg_joule_coupling.cpp:434-478): R = <S_J>/<I^2>,
        # L = 2 E_mag / <I^2>, with <I^2> = 2 Re(I_hat)^2
        if self.eval_rplasma:
            tot_I = self.em.coil_current()
            if tot_I > 0:
                I2 = 2.0 * tot_I * tot_I
                self.plasma_resistance = tot_jh_raw / I2
                e_mag = self.em.magnetic_energy()
                self.plasma_inductance = 2.0 * e_mag / I2
                print(f"  coil current amplitude = {2 * tot_I:.6e}\n"
                      f"  effective plasma resistance = "
                      f"{self.plasma_resistance:.6e}\n"
                      f"  magnetic field energy = {e_mag:.6e}\n"
                      f"  effective plasma inductance = "
                      f"{self.plasma_inductance:.6e}", flush=True)
        # 3) power control (reference :434-516), optionally oscillating
        target = self.input_power
        if self.initial_input_power > 0 and self.iter == 0:
            target = self.initial_input_power
        if target > 0 and self.oscillating_power:
            target = target * (1.0 + self.power_amplitude * np.sin(
                2.0 * np.pi * self.time / self.power_period))
        efield_scale = 1.0
        if target > 0 and tot_jh_raw > 0:
            ratio = target / tot_jh_raw
            self.em.scale_joule_heating(ratio)
            # q_J ~ sigma |E|^2: keep the reported E consistent
            efield_scale = float(np.sqrt(max(ratio, 0.0)))
        entry["target"] = target
        # the total after control (one more read of the [2] diagnostics)
        entry["joule"] = self.em.total_joule_heating()
        self.em_log.append(entry)
        # 4) the Joule heating back to the flow (copied into the tensor
        # the captured step reads)
        em_tab = self.em.tab
        self.flow.set_joule_heating(
            self.em_to_flow.from_h1(em_tab, self.em.joule_heating))
        # 5) the E-field amplitude back to the flow (reference:
        # interpElectricFieldFromEMToFlow, :290-330)
        E_re, E_im = self.em.electric_field()
        Eamp = torch.sqrt(E_re ** 2 + E_im ** 2) * efield_scale
        self.flow.set_efield(self.em_to_flow.from_h1(em_tab, Eamp))

    def solve_end(self):
        self.flow.solve_end()


@register_solver("independent-coupled")
class IndependentCoupling(Solver):
    """Run the compressible flow and EM with no coupling (reference
    independent_coupling.cpp)."""

    def initialize(self):
        self.flow = create_solver("flow", self.config, tps=self.tps)
        self.flow.initialize()
        self.em = QuasiMagnetostaticSolverAxiSym(self.config, tps=self.tps)
        self.em.initialize()
        self.iter = 0

    @property
    def max_iters(self):
        return self.flow.max_iters

    def solve_step(self):
        if self.iter == 0:
            self.em.solve_step()
        self.flow.solve_step()
        self.iter = self.flow.iter
        self.time = self.flow.time

    def solve_end(self):
        self.flow.solve_end()
