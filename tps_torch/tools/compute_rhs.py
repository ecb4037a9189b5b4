"""The RHS evaluation of the MMS spatial verification, run-file mode
(the JAX package's tools/compute_rhs.py --runFile; reference:
utils/compute_rhs.cpp, used by test/mms.euler_2d.test:28-52 and
test/mms.cns_2d.test).

Builds the solver of an ini that enables [mms], whose state is then the
exact manufactured state at the nodes, evaluates the full discrete RHS
once (the manufactured source included, unless [mms] compare_rhs) and
appends the relative L2 errors ||RHS_var|| / ||S_var|| per variable group
(rho / momentum vector / energy, then any further equation alone) to
[utils/compute_rhs] filename as the TSV line "numElems\\te0\\te1\\te2\\t",
the file the reference's tests bracket.  It runs on the card (the face
sweep kernel of the slot path) unless --device cpu, in float64 (the
brackets are float64 numbers).

    python -m tps_torch.tools.compute_rhs --runFile tests/inputs/mms.euler.2d.quad.ini
    python -m tps_torch.tools.compute_rhs --runFile deck.ini --device cpu
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def build_solver(run_file, device="cuda"):
    """The initialized solver of run_file (through the harness, as a user
    script would)."""
    from ..harness import Tps

    tps = Tps()
    tps.parse_command_line_args(["tps", "--runFile", run_file, "--device",
                                 device])
    tps.parse_input()
    tps.choose_devices()
    tps.choose_solver()
    tps.initialize()
    return tps.solver


def rhs_rel_errors(s):
    """Relative RHS errors per variable group (rho, momentum, energy, then
    each further equation) on the solver's current state, and numElems
    (tools/compute_rhs.py:57-100 of the JAX package): the quadrature L2
    norms of the RHS and of the manufactured source S at the nodes."""
    from ..dg.rhs import compute_rhs

    tab = s.tables
    y, _ = compute_rhs(s.ctx, tab, s.U, s.time,
                       bc_states=s._loop.bc_states,
                       sweep=getattr(s._rhs, "sweep", None))
    S = s.masa.source_at(tab.xyz_dof)
    w = tab.wq[None, :] * tab.detJ

    def l2sq(field):  # [ne, ndof, k] -> per-equation integrals
        fq = torch.einsum("qd,ndk->nqk", tab.Bvol, field)
        return torch.sum(w[..., None] * fq * fq, dim=(0, 1)).double().cpu()

    num, den = l2sq(y).numpy(), l2sq(S).numpy()
    dim = s.mesh.dim
    groups = [(0,), tuple(range(1, 1 + dim)), (1 + dim,)]
    groups += [(k,) for k in range(2 + dim, y.shape[-1])]
    errs = []
    for g in groups:
        n_ = float(np.sqrt(sum(num[k] for k in g)))
        d_ = float(np.sqrt(sum(den[k] for k in g)))
        errs.append(n_ / d_ if d_ > 0 else n_)
    return errs, s.mesh.num_elements


def run_file_mode(run_file, device="cuda"):
    """Evaluate, print and append the report line; returns (errs, ne)."""
    s = build_solver(run_file, device)
    if s.masa is None:
        raise SystemExit("compute_rhs --runFile requires [mms]/isEnabled")
    filename = s.config.raw.get("utils/compute_rhs/filename", "")
    if not filename:
        raise SystemExit("utils/compute_rhs/filename is required")
    errs, ne = rhs_rel_errors(s)
    print(f"{ne},\t" + ",\t".join(f"{e:.6g}" for e in errs))
    with open(filename, "a") as f:
        f.write(f"{ne}\t" + "".join(f"{e:.6g}\t" for e in errs) + "\n")
    return errs, ne


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runFile", required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    torch.set_default_dtype(torch.float64)
    run_file_mode(a.runFile, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
