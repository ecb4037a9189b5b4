"""Top-level Tps harness: CLI args, input parsing, device setup, solver
factory, lifecycle (PyTorch).

Mirrors the reference TPS::Tps surface (reference: src/tps.hpp:72-216,
src/tps.cpp:128-278) so reference-style drivers port directly:

    tps = Tps()
    tps.parse_command_line_args(argv)
    tps.parse_input()
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    tps.solve()

`--device cuda` (the default) runs the solver on the GPU through the
hand-written CUDA kernels and fails when CUDA is absent; `--device cpu`
runs the plain PyTorch path.  camelCase aliases match the reference's
Python API.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .config.ini import IniInput
from .config.run_config import parse_run_configuration
from .solvers import base as solver_base
from .solvers.compressible import CompressibleSolver  # noqa: F401 (registry)

# exit status of a completed run (reference: src/tps.hpp Tps::getStatus)
NORMAL = 0


class Tps:
    def __init__(self):
        self.input_file = None
        self.iniput = None
        self.config = None
        self.solver = None
        self.status = NORMAL
        self._device_config = "cuda"
        self._visual = False
        self.device = None

    # ------------------------------------------------------------------
    def parse_command_line_args(self, argv=None):
        ap = argparse.ArgumentParser(prog="tps-torch",
                                     description="TPS on PyTorch + CUDA")
        ap.add_argument("--runFile", "-run", dest="run_file", help="ini input file")
        ap.add_argument("--version", action="store_true")
        ap.add_argument("--visualization", "-visual", action="store_true")
        ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda (default: the CUDA kernels) or cpu (the "
                             "plain PyTorch path)")
        args = ap.parse_args(argv[1:] if argv else sys.argv[1:])
        if args.version:
            from . import __version__

            print(f"tps-torch version {__version__}")
            raise SystemExit(0)
        self.input_file = args.run_file
        self._visual = args.visualization
        self._device_config = args.device
        return args

    def parse_input(self, path=None):
        path = path or self.input_file
        if path is None:
            raise RuntimeError("no input file; pass --runFile")
        self.iniput = IniInput.read(path)
        self.config = parse_run_configuration(self.iniput)
        return self.config

    def choose_devices(self):
        """Select the torch device (reference chooseDevices selects the MFEM
        device backend, src/tps.cpp:196-239).  CUDA, when requested, must
        be present: there is no silent switch to the CPU."""
        if self._device_config == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "--device cuda (the default) requested but CUDA is not "
                    "available; pass --device cpu for the plain PyTorch path")
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device("cpu")
        return self.device

    def choose_solver(self):
        name = self.config.solver_type
        if name not in solver_base.SOLVER_REGISTRY:
            raise NotImplementedError(
                f"solver type '{name}' is not ported to tps_torch yet "
                "(ROADMAP A9-A11)")
        self.solver = solver_base.create_solver(name, self.config, tps=self)
        self.solver.parse_solver_options()
        return self.solver

    def initialize(self):
        self.solver.initialize()

    def solve(self):
        self.solver.solve()
        self.status = self.solver.status

    def solve_begin(self):
        self.solver.solve_begin()

    def solve_step(self):
        self.solver.solve_step()

    def solve_end(self):
        self.solver.solve_end()
        self.status = self.solver.status

    def get_status(self):
        return self.status

    # -- camelCase aliases (reference pybind API names) --------------------
    parseCommandLineArgs = parse_command_line_args
    parseInput = parse_input
    chooseDevices = choose_devices
    chooseSolver = choose_solver
    solveBegin = solve_begin
    solveStep = solve_step
    solveEnd = solve_end
    getStatus = get_status


def main(argv=None):
    tps = Tps()
    tps.parse_command_line_args(argv)
    tps.parse_input()
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    if tps._visual:
        # visualization mode: the checkpoint as a VTK file, no solve
        # (reference: tps --visual, src/M2ulPhyS.cpp:4073)
        tps.solver.read_restart()
        tps.solver.visualization()
        return 0
    tps.solve()
    return tps.get_status()


if __name__ == "__main__":
    raise SystemExit(main())
