"""The fused periodic-box RHS as two hand-written CUDA kernels (Hopper).

K1 (`gradient`) and K2 (`faces_volume`) in csrc/fused_rhs.cu replace the
JAX package's two Pallas TPU kernels, dg/pallas_fused.py k1_kernel and
k2_kernel, and compute the same algebra on the same folded matrices
(`kernel_folds`, the numpy folds of that module).  The TPU kernels'
channel-major [nz, neq*ndof, ny*nx] carry, lane rolls and VMEM limits
were shaped by the TPU; here the kernels read the solver's element-major
[ne, ndof, neq] state directly, with neighbors found from the grid
coordinates, a tile of elements per block with its states in shared
memory (see the .cu files' notes and csrc/dg_face_stage.cuh).

Both are bound by bytes on the card (K1: U in, G out).  K1 takes the
gradient folds compressed (`gradient_groups`): on the collocated GL basis
of an axis-aligned box a row of the folds touches only the nodes on one
line of the element and of its two neighbours along that direction (8 of
189 columns at p=2); the other entries are rounding noise of the folding,
at most 1.1e-14 of their fold's largest entry for p = 1..4, while the
smallest kept entry is at least 2.4e-3 of it.  Entries at or below
FOLD_CUT (1e-12) of their fold's largest are dropped: the same linear map
up to rounding, about 1/20 of the dense FMAs.  Rows that share their
columns (a line) are grouped so the kernel loads each column's state once
for the group; one row a group (a per-row ELL) is slower on the card
(tps_torch/tools/k1_layouts.py).  Dense folds stay correct in the same
format, only slower.  The plain version (FusedRHS.gradient) keeps the dense folds.

Each wrapper launches its kernel for CUDA tensors and counts the launch in
`launches`; for CPU tensors it runs the plain PyTorch version, FusedRHS
(dg/fused.py), and nothing else.  There is no fallback from a CUDA tensor
to the plain version: a missing compiler, a failed build or a refused
launch raises.

The kernels are built on first use from the repo's own sources with nvcc
(sm_90a) into one shared library with a plain C interface under
<repo>/build (`build_kernels`, which also builds dg/cuda_faces.py's face
sweep), named by the sources' hash, and called through ctypes on
PyTorch's current stream.  Nothing is built or loaded at import time.

Preconditions (`cuda_fusable`): the fused-path preconditions (periodic
roll topology, collocated GL basis, uniform affine elements, no BCs) plus
3-D hexes, DryAir with 3 velocities, Rusanov, Euler or Navier-Stokes with
Sutherland or constant transport, and no forcings.  Any grid extents; ndof generic
up to the shared memory of a block (dynamic, up to 227 KB): K1 follows
`k1_plan`, K2 `k2_plan`, each with its folds or operators read through
the cache where they do not fit beside one element.  build_cuda_fused
raises beyond, naming the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

from .fused import FusedRHS, build_fused, fusable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ("-O3", *ARCH, "-std=c++17", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c")
LINK_FLAGS = (*ARCH, "-shared")

# Shared memory (csrc/dg_face_stage.cuh): K1, K2 and the face sweep take
# dynamic shared memory up to 227 KB a block (232,448 B, less 1 KB for
# their static neighbor tables) and aim at two blocks per SM.
SHARED_LIMIT = 232448 - 1024
SHARED_TARGET = 114688
TILE_MAX = 8  # elements per block (of 256 threads)
# K1's compressed folds (`gradient_groups`): the share of a fold's largest
# entry at or below which an entry is dropped, and the most rows a group
# holds (csrc/fused_rhs.cu::K1_ROWS)
FOLD_CUT = 1e-12
GROUP_ROWS = 8

# kernel launches since the last reset_launches(), by kernel name
launches = {"k1_gradient": 0, "k2_faces_volume": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


class _Library:
    """The built kernel library (loaded once per process)."""

    lib = None
    path = None
    build_log = ""


def _nvcc():
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        path = cand if os.path.exists(cand) else None
    if path is None:
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                           "the CUDA kernels cannot be built")
    return path


def _csrc_files(ext):
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(ext))


def build_kernels():
    """Build (if needed) and load the kernel library; returns its path.

    Every csrc/*.cu (this module's K1/K2 and dg/cuda_faces.py's face
    sweep) is compiled by its own nvcc, all started together, and linked
    into one shared library.  Its name carries the hash of every source
    and header in csrc/, so an edited file is rebuilt and a stale library
    is never loaded.  The compilers' output (with -Xptxas -v register and
    shared-memory counts) is kept in `_Library.build_log`."""
    if _Library.lib is not None:
        return _Library.path
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for f in _csrc_files(".cu") + _csrc_files(".cuh"):
        with open(f, "rb") as fh:
            digest.update(os.path.basename(f).encode() + fh.read())
    tag = digest.hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libtps_kernels_{tag}.so")
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            srcs = _csrc_files(".cu")
            objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in srcs]
            logs = [o + ".log" for o in objs]
            t0 = time.perf_counter()
            procs = []
            for src, o, lg in zip(srcs, objs, logs):
                with open(lg, "w") as out:
                    procs.append(subprocess.Popen(
                        [nvcc, *COMPILE_FLAGS, "-o", o, src], stdout=out,
                        stderr=subprocess.STDOUT))
            # each source's compile time, polled (they run side by side)
            secs = [None] * len(procs)
            while any(s is None for s in secs):
                for i, proc in enumerate(procs):
                    if secs[i] is None and proc.poll() is not None:
                        secs[i] = time.perf_counter() - t0
                time.sleep(0.05)
            parts = []
            for src, lg, sec in zip(srcs, logs, secs):
                with open(lg) as fh:
                    parts.append(f"{os.path.basename(src)}: compiled in "
                                 f"{sec:.1f} s\n" + fh.read())
            _Library.build_log = "".join(parts)
            if any(proc.returncode for proc in procs):
                raise RuntimeError(f"nvcc failed:\n{_Library.build_log}")
            lib_tmp = os.path.join(tmp, "lib.so")
            res = subprocess.run([nvcc, *LINK_FLAGS, "-o", lib_tmp, *objs],
                                 capture_output=True, text=True)
            _Library.build_log += res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                                   f"{_Library.build_log}")
            os.replace(lib_tmp, path)
    lib = ctypes.CDLL(path)
    ptr, i32, dbl = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_double)
    ip, i64 = ctypes.POINTER(ctypes.c_int), ctypes.c_longlong
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"tps_k1_gradient_{suffix}")
        fn.argtypes = [ptr] * 5 + [i32] * 5 + [ip, dbl, ptr]
        fn.restype = i32
        fn = getattr(lib, f"tps_k2_faces_volume_{suffix}")
        fn.argtypes = [ptr] * 8 + [i32, i32, i32, i32, ip, dbl, ptr]
        fn.restype = i32
        fn = getattr(lib, f"tps_face_sweep_{suffix}")
        fn.argtypes = ([ptr] * 13 + [i32] * 5 + [i64, i64, ctypes.c_double]
                       + [i32] * 4 + [dbl, dbl, ptr])
        fn.restype = i32
    lib.tps_k1_smem.argtypes = [i32] * 5 + [ip]
    lib.tps_k1_smem.restype = i64
    lib.tps_k2_smem.argtypes = [i32, i32, i32, i32, ip]
    lib.tps_k2_smem.restype = i64
    lib.tps_face_sweep_smem.argtypes = [i32] * 6 + [ip]
    lib.tps_face_sweep_smem.restype = i64
    _Library.lib, _Library.path = lib, path
    return path


def cuda_fusable(tab_np, ctx) -> bool:
    """Preconditions of the CUDA kernels (module docstring)."""
    t = tab_np
    if not fusable(t, ctx):
        return False
    if t.dim != 3 or t.nlf != 6:
        return False
    grid, per_lf = t.roll_info
    if len(grid) != 3 or any(abs(sh) != 1 for (_a, sh, _o) in per_lf):
        return False
    mix = ctx.mixture
    if type(mix).__name__ != "DryAir" or mix.nvel != 3 or mix.n_passive:
        return False
    if type(ctx.riemann).__name__ != "Rusanov":
        return False
    eq = ctx.fluxes.eq_system
    if eq not in ("euler", "navier-stokes"):
        return False
    return eq == "euler" or kernel_transport(ctx.fluxes.transport)


def _al4(n):
    return (n + 3) & ~3


def tile_plan(nbytes):
    """(elements per block, operators resident, shared bytes) of a tiled
    kernel whose block takes nbytes(E, resident) bytes: the most elements
    in flight per SM (2 or 1 blocks by shared memory, times E) over E in
    (8, 4, 2, 1) and operators in shared memory or read through the cache;
    on a tie the larger tile, then resident.  E = 0: it does not fit.  The
    kernels' own formula: csrc/dg_face_stage.cuh::make_plan."""
    best, best_score = (0, False, nbytes(1, False)), 0
    for E in (8, 4, 2, 1):
        for res in (True, False):
            b = nbytes(E, res)
            score = (2 if b <= SHARED_TARGET else 1 if b <= SHARED_LIMIT else 0) * E
            if score > best_score:
                best, best_score = (E, res, b), score
    return best


def row_slot(n, size):
    """Values of a neighbor row slot (dg_face_stage.cuh::row_slot): n
    values copied in 16-byte chunks from any phase."""
    v = 16 // size
    s = _al4((n + 2 * v - 2) // v * v)
    return s if s % 8 else s + 4


def support_values(nlf, ndof, size):
    """Values of `size` bytes that the kernels' face supports take (nlf
    counts and nlf node lists, int32): dg_face_stage.cuh::support_values."""
    return _al4(-(-nlf * (ndof + 1) * 4 // size))


def k1_plan(ndof, ngroup, ncol, nrow, dtype):
    """K1's tile plan (csrc/fused_rhs.cu::k1_plan) for folds of ngroup
    groups of ncol columns and nrow rows (`gradient_groups`): the folds if
    resident (columns as int32, values); the staged rows (the tile's own
    and one per face and element), and the tile's G at a 16-byte phase."""
    size = torch.empty((), dtype=dtype).element_size()
    nu, nc = ndof * 5, ngroup * ncol

    def nbytes(E, res):
        v = _al4(-(-nc * 4 // size)) + _al4(nc * nrow) if res else 0
        v += _al4(7 * E * nu) + _al4(E * nu * 3) + 4
        return v * size

    return tile_plan(nbytes)


def k2_plan(ndof, nqf, viscous, dtype):
    """K2's tile plan (csrc/fused_rhs.cu::k2_plan): the face supports; V,
    Btr per node, W if resident; U and G of the tile and two neighbor
    buffers (the second also stages Btr); the traces (or the volume flux
    before them); the face flux, accumulator, |u| + c."""
    size = torch.empty((), dtype=dtype).element_size()
    ng = 15 if viscous else 0
    k = 5 + ng

    def nbytes(E, res):
        nb = 6 * nqf * ndof
        v = support_values(6, ndof, size)
        if res:
            v += _al4(3 * ndof * ndof) + _al4(6 * ndof * _al4(nqf)) + _al4(nb)
        v += _al4(E * ndof * 5) + _al4(E * ndof * ng)
        nbuf = E * (row_slot(ndof * 5, size)
                    + (row_slot(ndof * ng, size) if ng else 0))
        v += nbuf + _al4(max(nbuf, nb if res else 0))
        v += max(2 * _al4(E * nqf * k), _al4(E * ndof * 15))
        v += _al4(E * (nqf * 5 + 1)) + _al4(E * ndof * 5) + _al4(E * ndof)
        return v * size

    return tile_plan(nbytes)


def kernel_transport(tr) -> bool:
    """The transport models the kernels compute: Sutherland's law
    (DryAirTransport) and constant coefficients (ConstantTransport)."""
    return type(tr).__name__ in ("DryAirTransport", "ConstantTransport")


def kernel_phys(ctx):
    """The kernels' physical constants (dg_pointwise.cuh::make_phys):
    gamma, R, C1*visc_mult, S0, cp/Pr, bulk_mult, then the transport switch
    (1: constant) and the constant mu, bulk viscosity and kappa (Euler: no
    transport)."""
    mix = ctx.mixture
    gamma, rgas = float(mix.specific_heat_ratio), float(mix.gas_constant)
    if ctx.fluxes.eq_system == "euler":
        return [gamma, rgas, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    # the molecular transport (the face sweep applies a mixing length
    # as a closure)
    tr = getattr(ctx.fluxes.transport, "molecular", ctx.fluxes.transport)
    if type(tr).__name__ == "ConstantTransport":
        return [gamma, rgas, 0.0, 1.0, 0.0, 0.0, 1.0, float(tr.visc),
                float(tr.bulk_visc), float(tr.kappa + tr.kappa_e)]
    return [gamma, rgas, float(tr.C1 * tr.visc_mult), float(tr.S0),
            gamma * rgas / (gamma - 1.0) / float(tr.Pr),
            float(tr.bulk_visc_mult), 0.0, 0.0, 0.0, 0.0]


def kernel_folds(t):
    """Per-equation scalar linear maps folded from the tables: the
    gradient matrices (self + one per local face, Minv folded in), the
    volume scatter V_dd, the face trace rows Btr_lf, the face scatter W_lf
    and the per-point face normals (scaled by the face area)."""
    ndof, nqf, dim = t.ndof, t.nqf, t.dim
    B = np.asarray(t.Btr)  # [nlf*nqf, ndof]
    m = np.diag(np.asarray(t.Minv[0]))  # [ndof]
    adj = np.asarray(t.adjJ[0, 0])  # [dim, dim]
    wq = np.asarray(t.wq)  # [nq] == [ndof]
    Gv = np.asarray(t.Gvol)  # [nq, ndof, dim]
    w_s = np.asarray(t.wts_slot[0])  # [nlf, nqf]
    n_s = np.asarray(t.nor_slot[0])  # [nlf, nqf, dim]
    _grid, per_lf = t.roll_info

    # gradient: G[(dd,j)] <- sum_d S[d, j, dd] Up[d]  (self + per-face nbr)
    S_vol = np.einsum("j,jdk,kD->djD", wq, Gv, adj)
    S_own = np.einsum("sj,s,sD,sd->djD", B, -0.5 * w_s.reshape(-1),
                      n_s.reshape(-1, dim), B)
    S_self = (S_vol + S_own) * m[None, :, None]
    # matmul form [dim*ndof, ndof]: row (dd, j), col d
    M = [S_self.transpose(2, 1, 0).reshape(dim * ndof, ndof)]
    for lf, (_ax, _sh, opp) in enumerate(per_lf):
        sl = slice(lf * nqf, (lf + 1) * nqf)
        so = slice(opp * nqf, (opp + 1) * nqf)
        N = np.einsum("sj,s,sD,sd->djD", B[sl], 0.5 * w_s[lf], n_s[lf],
                      B[so]) * m[None, :, None]
        M.append(N.transpose(2, 1, 0).reshape(dim * ndof, ndof))

    # volume scatter: y[j] += sum_dd V[dd][j, q] F[dd][q]
    V = [np.einsum("q,qj,j->jq", wq, np.einsum("qjk,k->qj", Gv, adj[:, dd]), m)
         for dd in range(dim)]
    # face trace + scatter
    Btr = [B[lf * nqf:(lf + 1) * nqf] for lf in range(t.nlf)]
    W = [-np.einsum("s,sj,j->js", w_s[lf], Btr[lf], m) for lf in range(t.nlf)]
    return {"Wgrad": np.stack(M), "Vvol": np.stack(V), "Btr": np.stack(Btr),
            "Wscat": np.stack(W), "nor": n_s}


def gradient_groups(Wgrad):
    """K1's folds, compressed.  Wgrad [nslot, nrow, ndof] (slot 0 the
    element, slot 1 + lf its neighbour across face lf; row dd*ndof + j).

    An entry is kept when it exceeds FOLD_CUT times its fold's largest;
    the rest is rounding noise of the folding (module docstring).  Rows
    whose kept columns overlap (at least half of the smaller row's, joined
    transitively: on a box, the rows of one line of nodes along one
    direction) form a group, cut into chunks of at most GROUP_ROWS rows.  A
    group lists the union of its rows' columns, sorted by (slot, node), and
    a dense block of values over them (0 where a row lacks a column), so K1
    loads each column's state once for all the group's rows (faster on the
    card than one row a group: tps_torch/tools/k1_layouts.py).  Groups are
    padded to the widest (columns: slot 0 node 0, values 0; rows: -1).

    Returns keep [nslot, nrow, ndof] (bool) and the kernel's arrays: rows
    [ngroup, R] (output row, -1: none), cols [ngroup, M] (slot << 16 |
    node), vals [ngroup, M, R] (Wgrad's kept entries, bit for bit)."""
    W = np.asarray(Wgrad, dtype=np.float64)
    nslot, nrow, ndof = W.shape
    if ndof >= 1 << 16:
        raise ValueError(f"ndof={ndof}: a column packs its node in 16 bits")
    big = np.abs(W).reshape(nslot, -1).max(1)
    keep = np.abs(W) > FOLD_CUT * big[:, None, None]
    K = keep.transpose(1, 0, 2).reshape(nrow, nslot * ndof)
    n = K.sum(1)
    common = K.astype(np.float64) @ K.T.astype(np.float64)  # exact counts
    near = (common > 0) & (2 * common >= np.minimum(n[:, None], n[None, :]))
    near |= np.eye(nrow, dtype=bool)
    label = np.arange(nrow)
    while True:  # each row takes the least row index of its component
        new = np.where(near, label[None, :], nrow).min(1)
        if np.array_equal(new, label):
            break
        label = new
    chunks = []
    for lab in np.unique(label):
        rows = np.flatnonzero(label == lab)
        chunks += [rows[i:i + GROUP_ROWS]
                   for i in range(0, len(rows), GROUP_ROWS)]
    colsets = [np.flatnonzero(K[r].any(0)) for r in chunks]
    R = max(len(r) for r in chunks)
    M = max(1, max(len(c) for c in colsets))
    rows_a = np.full((len(chunks), R), -1, np.int32)
    cols_a = np.zeros((len(chunks), M), np.int32)
    vals_a = np.zeros((len(chunks), M, R))
    for g, (rows, cols) in enumerate(zip(chunks, colsets)):
        s, k = np.divmod(cols, ndof)
        rows_a[g, :len(rows)] = rows
        cols_a[g, :len(cols)] = (s << 16) | k
        blk = W[s[:, None], rows[None, :], k[:, None]]
        vals_a[g, :len(cols), :len(rows)] = np.where(
            keep[s[:, None], rows[None, :], k[:, None]], blk, 0.0)
    return {"keep": keep, "rows": rows_a, "cols": cols_a, "vals": vals_a}


@dataclass(frozen=True, eq=False)
class CudaFusedRHS:
    """Fused RHS on the solver's [ne, ndof, neq] state: K1 + K2 for CUDA
    tensors, the plain FusedRHS for CPU tensors."""

    plain: FusedRHS
    viscous: bool
    # K1's compressed folds (gradient_groups)
    k1_rows: torch.Tensor  # int32 [ngroup, R]
    k1_cols: torch.Tensor  # int32 [ngroup, M]
    k1_vals: torch.Tensor  # [ngroup, M, R]
    Vvol: torch.Tensor  # [dim, ndof, ndof]
    Btr: torch.Tensor  # [nlf, nqf, ndof]
    Wscat: torch.Tensor  # [nlf, ndof, nqf]
    nor: torch.Tensor  # [nlf, nqf, dim]
    geo: object  # ctypes int[21]: nz, ny, nx, axis[6], step[6], opp[6]
    phys: object  # ctypes doubles: kernel_phys

    @property
    def ne(self):
        return self.plain.ne

    @property
    def ndof(self):
        return self.plain.ndof

    @property
    def neq(self):
        return self.plain.neq

    @property
    def nqf(self):
        return self.plain.nqf

    # the solver's layout is the kernels' layout
    def to_fused(self, U):
        return U

    def from_fused(self, U):
        return U

    def _check(self, name, x, shape):
        if x.device != self.Vvol.device or x.dtype != self.Vvol.dtype:
            raise ValueError(
                f"{name}: expected {self.Vvol.dtype} on {self.Vvol.device}, "
                f"got {x.dtype} on {x.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {shape} tensor, "
                             f"got {tuple(x.shape)}")

    def _fn(self, kernel):
        build_kernels()
        suffix = "f64" if self.Vvol.dtype == torch.float64 else "f32"
        return getattr(_Library.lib, f"tps_{kernel}_{suffix}")

    def gradient(self, U):
        """K1: DG gradient of the primitives, [ne, ndof, neq, dim]."""
        ne, ndof, neq = self.ne, self.ndof, self.neq
        if not U.is_cuda:
            return self.plain.gradient(U.reshape(ne, -1)).reshape(
                ne, ndof, neq, 3)
        self._check("U", U, (ne, ndof, neq))
        G = torch.empty((ne, ndof, neq, 3), dtype=U.dtype, device=U.device)
        ngroup, ncol, nrow = self.k1_vals.shape
        with torch.cuda.device(U.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = self._fn("k1_gradient")(
                U.data_ptr(), self.k1_rows.data_ptr(), self.k1_cols.data_ptr(),
                self.k1_vals.data_ptr(), G.data_ptr(), ne, ndof, ngroup, ncol,
                nrow, self.geo, self.phys, stream)
        if err:
            raise RuntimeError(f"k1_gradient launch failed: CUDA error {err}")
        launches["k1_gradient"] += 1
        return G

    def faces_volume(self, U, G):
        """K2: dU/dt [ne, ndof, neq] and each element's max |u| + c [ne].
        G is K1's gradient (None for Euler)."""
        ne, ndof, neq = self.ne, self.ndof, self.neq
        if not U.is_cuda:
            mix = self.plain.ctx.mixture
            y2 = self.plain.faces_volume(
                U.reshape(ne, -1), None if G is None else G.reshape(ne, -1))
            return (y2.reshape(ne, ndof, neq),
                    torch.amax(mix.max_char_speed(U), dim=1))
        self._check("U", U, (ne, ndof, neq))
        if self.viscous:
            self._check("G", G, (ne, ndof, neq, 3))
        Y = torch.empty_like(U)
        mcs = torch.empty(ne, dtype=U.dtype, device=U.device)
        with torch.cuda.device(U.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = self._fn("k2_faces_volume")(
                U.data_ptr(), (G if self.viscous else U).data_ptr(),
                self.Vvol.data_ptr(), self.Btr.data_ptr(),
                self.Wscat.data_ptr(), self.nor.data_ptr(), Y.data_ptr(),
                mcs.data_ptr(), ne, ndof, self.nqf, int(self.viscous),
                self.geo, self.phys, stream)
        if err:
            raise RuntimeError(
                f"k2_faces_volume launch failed: CUDA error {err}")
        launches["k2_faces_volume"] += 1
        return Y, mcs

    def __call__(self, U, t=0.0):
        G = self.gradient(U) if self.viscous else None
        y, mcs = self.faces_volume(U, G)
        return y, {"max_char_speed": torch.amax(mcs)}


def build_cuda_fused(tab_np, ctx, dtype, device) -> CudaFusedRHS:
    """Fold the tables for the kernels (and for the plain FusedRHS), in
    dtype on device.  Raises for CUDA where a kernel's block would not fit
    its shared memory with one element (`k1_plan`, `k2_plan`)."""
    if not cuda_fusable(tab_np, ctx):
        raise ValueError("the CUDA fused kernels' preconditions do not hold "
                         "(see cuda_fusable)")
    viscous = ctx.fluxes.eq_system != "euler"
    folds = kernel_folds(tab_np)
    groups = gradient_groups(folds["Wgrad"])
    if torch.device(device).type == "cuda":
        nd, nq = tab_np.ndof, tab_np.nqf
        plans = {"K2": k2_plan(nd, nq, viscous, dtype)}
        if viscous:  # Euler does not launch K1
            plans["K1"] = k1_plan(nd, *groups["vals"].shape, dtype)
        misfits = [f"{k} needs {smem} B for one element" for k, (tile, _r, smem)
                   in sorted(plans.items()) if not tile]
        if misfits:
            raise ValueError(
                f"ndof={nd}, nqf={nq} in {dtype}: shared memory per block: "
                f"{'; '.join(misfits)} (limit {SHARED_LIMIT})")
    plain = build_fused(tab_np, ctx, dtype, device)
    grid, per_lf = tab_np.roll_info
    geo = ([int(g) for g in grid] + [int(a) for (a, _s, _o) in per_lf]
           + [-int(s) for (_a, s, _o) in per_lf]
           + [int(o) for (_a, _s, o) in per_lf])
    phys = kernel_phys(ctx)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    def idx(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    return CudaFusedRHS(
        plain=plain, viscous=viscous,
        k1_rows=idx(groups["rows"]), k1_cols=idx(groups["cols"]),
        k1_vals=dev(groups["vals"]), Vvol=dev(folds["Vvol"]),
        Btr=dev(folds["Btr"]), Wscat=dev(folds["Wscat"]),
        nor=dev(folds["nor"]),
        geo=(ctypes.c_int * len(geo))(*geo),
        phys=(ctypes.c_double * len(phys))(*phys),
    )
