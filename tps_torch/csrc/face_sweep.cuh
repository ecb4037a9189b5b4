// Hopper kernel for the DG face sweep of the general (slot) path: for each
// element e,
//
//   z_e = sign * sum_lf Btr_or[lf]^T . mask[e,lf] * F(tr_own, tr_nbr, n[e,lf])
//
//   tr_own = Btr_or[lf] . X_e,   tr_nbr = Btr_or[c] . X_e',
//   (e', c) = divmod(nbr_row[e, lf], n_combo),
//
// with X = [U | G] (k = NEQ channels for Euler, NEQ + NEQ*DIM for
// Navier-Stokes; G's channel NEQ + eq*DIM + d).  It replaces the Pallas
// TPU kernel `kernel` of tools/pallas_face_prototype.py (a fused Euler face
// sweep on a periodic box) and generalises it to the interior face sweep
// of the JAX package's dg/rhs.py:143-178:
//
//   prototype mode: Euler, the prototype's Rusanov (per side |u.n| + c|n|),
//     normals wts*nor shared by every element (element stride 0),
//     mask = 1, sign = +1, no inverse mass;
//   slot mode: the package Rusanov (max |u| + c, times |n|) minus, for
//     Navier-Stokes, the mean of the two one-sided viscous normal fluxes;
//     normals nor_wpf (weights folded in), mask = interior_mask,
//     sign = -1.  Boundary slots (mask 0) add nothing: their BC fluxes
//     stay in PyTorch (dg/rhs.py).
//
// The pointwise physics is a policy of the kernel template: DryAir
// (dg_pointwise.cuh::DryAirPhysics, instantiated in face_sweep.cu, both
// modes) and the two-temperature argon plasma (dg_mixture.cuh::
// ArgonMixture, NEQ = DIM + 4, slot mode, 2-D, instantiated in
// face_sweep_argon.cu so that nvcc builds the two files side by side).
//
// Neighbours are decoded from nbr_row.  Combo c's rows are face block
// combo_face[c]'s rows in another order: Btr_or[c][combo_perm[c][s]] =
// Btr_or[combo_face[c]][s] (the wrapper derives both), so the kernel
// needs only the nlf identity blocks, whatever n_combo is, forms the
// neighbour's trace in its face's order and stores point s at
// combo_perm[c][s]; any conforming mesh works.
//
// Bound on this card: bytes (X, the result and the per-slot normals; the
// least work at p=2 GLL Navier-Stokes takes ~0.4 of the bytes' time).  What
// held the first version ~50x above it was the data path: trace products
// at one FMA per two loads, one of them from global memory (the
// neighbour's state, strided, inside the FMA chain), the flux on 25 of
// 128 lanes, three barriers per face per element.  This design (the face
// stage of dg_face_stage.cuh): tiles of E elements per block; the nlf
// trace blocks (laid out per node) and the tile's states in shared memory
// by cp.async, each face's neighbour states copied into a second buffer
// while the previous face is computed; register-blocked trace products
// (4 points x NEQ channels per thread) over the nodes a face touches (9
// of 27 on the Gauss-Lobatto basis at p=2); the flux on one thread per
// face point of the tile; three barriers per face per tile.  Each element
// still forms both traces of its faces (the neighbour's is computed again
// by the neighbour's block).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dg_face_stage.cuh"

namespace {

using namespace tps_dg;

// Shared memory of a block of E elements (values, regions 16-byte aligned):
// the faces' supports, the nlf trace blocks per node [nlf][ndof][ldq]
// (if resident), the own states [E][ndof][k] and two neighbour buffers
// [E][row_slot(ndof*k)] (the second also stages the trace blocks as
// copied), the two traces [E][nqf][k], the
// flux [E][nqf*neq + 1], the accumulator [E][ndof][neq].
Plan face_plan(int ndof, int nqf, int nlf, int k, int neq, size_t ts) {
  auto bytes = [=](int E, int res) {
    size_t v = support_values(nlf, ndof, ts);
    const size_t nb = (size_t)E * row_slot(ndof * k, ts);
    const size_t staged = res ? (size_t)nlf * nqf * ndof : 0;
    v += res ? al4((size_t)nlf * ndof * trace_ld(nqf)) : 0;
    v += al4((size_t)E * ndof * k) + nb + al4(nb > staged ? nb : staged);
    v += 2 * al4((size_t)E * nqf * k);
    v += al4((size_t)E * (nqf * neq + 1)) + al4((size_t)E * ndof * neq);
    return v * ts;
  };
  return make_plan(bytes);
}

// P: the physics policy (dg_pointwise.cuh::DryAirPhysics,
// dg_mixture.cuh::ArgonMixture).  RES: the trace blocks are resident in
// shared memory (then every operand load is a shared-memory load).
template <typename T, class P, bool VISCOUS, bool PROTO, bool RES>
__global__ void __launch_bounds__(THREADS_MAX)
face_sweep(const T* __restrict__ X,          // [ne][ndof][K]
           const T* __restrict__ Bor,        // [n_combo][nqf][ndof]
           const int* __restrict__ cface,    // [n_combo]
           const int* __restrict__ cperm,    // [n_combo][nqf] positions
           const int* __restrict__ nbr_row,  // [ne][nlf]
           const T* __restrict__ Nor,        // lf, e, (s, d) strided
           const T* __restrict__ mask,       // [ne][nlf] or null (all 1)
           T* __restrict__ Y,                // [ne][ndof][NEQ]
           int ne, int ndof, int nqf, int nlf, int n_combo, long long nor_lf,
           long long nor_e, T sign, int E, const typename P::Params ph) {
  constexpr int DIM = P::DIM, NEQ = P::NEQ;
  constexpr int K = VISCOUS ? NEQ * (1 + DIM) : NEQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_nb[NLF_MAX * TILE_MAX];     // neighbour of (lf, el); -1: none
  __shared__ int s_cb[NLF_MAX * TILE_MAX];     // its combo
  __shared__ double s_m[NLF_MAX * TILE_MAX];   // mask; 0 also past the mesh

  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * E;
  const int nt = ne - e0 < E ? ne - e0 : E;  // elements of this tile
  const int nx = ndof * K, fs = nqf * NEQ + 1;
  const int ld = (int)row_slot(nx, sizeof(T));  // neighbour row slot
  const int ldq = trace_ld(nqf);
  const size_t nB = (size_t)nlf * nqf * ndof;
  T* p = reinterpret_cast<T*>(smem_raw);
  int* s_cnt = reinterpret_cast<int*>(p);  // face supports
  int* s_node = s_cnt + nlf;
  p += support_values(nlf, ndof, sizeof(T));
  T* sBT = p;  // the trace blocks per node, [nlf][ndof][ldq]
  p += RES ? al4((size_t)nlf * ndof * ldq) : 0;
  T* sX = p;  // the tile's states
  p += al4((size_t)E * nx);
  T* sXn = p;  // two buffers, sXn + b * E * ld
  T* staged = sXn + (size_t)E * ld;  // buffer 1: the blocks as copied
  p = staged + al4((size_t)E * ld > (RES ? nB : 0) ? (size_t)E * ld : nB);
  T* sTo = p;
  p += al4((size_t)E * nqf * K);
  T* sTn = p;
  p += al4((size_t)E * nqf * K);
  T* sF = p;
  p += al4((size_t)E * fs);
  T* sY = p;
  // the blocks: per node in shared memory (RES), else Btr_or's rows
  const T* B = RES ? sBT : Bor;
  const int ldb = RES ? ldq : ndof;
  const size_t fstride = RES ? (size_t)ndof * ldq : (size_t)nqf * ndof;
  const T* Xend = X + (size_t)ne * nx;

  // group 0: the blocks as copied and the tile's states
  if (RES) copy_async(staged, Bor, (int)nB);
  copy_async(sX, X + (size_t)e0 * nx, nt * nx);
  cp_async_commit();
  for (int i = tid; i < nlf * E; i += blockDim.x) {
    const int lf = i / E, el = i - lf * E, e = e0 + el;
    int nb = -1, c = 0;
    double m = 0.0;
    if (el < nt) {
      m = mask ? (double)mask[(size_t)e * nlf + lf] : 1.0;
      if (m != 0.0) {
        const int row = nbr_row[(size_t)e * nlf + lf];
        nb = row / n_combo;
        c = row - nb * n_combo;
      }
    }
    s_nb[i] = nb;
    s_cb[i] = c;
    s_m[i] = m;
  }
  for (int i = tid; i < E * ndof * NEQ; i += blockDim.x) sY[i] = T(0);
  __syncthreads();

  auto nbr_x = [&](int lf, int el) -> const T* {  // neighbour's row of X
    const int nb = s_nb[lf * E + el];
    return nb < 0 ? nullptr : X + (size_t)nb * nx;
  };
  auto fetch = [&](int lf) {  // one group: face lf's neighbour states
    copy_rows_async(sXn + (size_t)(lf & 1) * E * ld, E, nx, ld,
                    [&](int el) { return nbr_x(lf, el); }, X, Xend);
    cp_async_commit();
  };
  fetch(0);
  cp_async_wait<1>();
  __syncthreads();
  prepare_faces<T, RES>(sBT, RES ? staged : Bor, nlf, nqf, ndof, ldq, s_cnt,
                        s_node);
  // scatter through Btr_or[lf]^T (the identity combo lf is Btr[lf])
  auto scatter = [&](int lf) {
    scatter_stage<T, NEQ>(E, nqf, s_node + lf * ndof, s_cnt[lf],
                          B + lf * fstride, RES ? ldq : 1, RES ? 1 : ndof, sF,
                          fs, sY, ndof);
  };
  for (int lf = 0; lf < nlf; ++lf) {
    // buffer (lf + 1) & 1 was last read by face lf - 1's traces
    if (lf + 1 < nlf) {
      fetch(lf + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // face lf - 1's scatter (its flux is complete) beside face lf's traces
    if (lf > 0) scatter(lf - 1);
    const T* xn = sXn + (size_t)(lf & 1) * E * ld;
    trace_stage<T, NEQ, K, RES>(
        E, nqf, ndof, B, ldb, fstride, s_cnt, s_node,
        [&](int side, int el, int& face, const int*& pos) {
          if (side == 0) {
            face = lf;
            pos = nullptr;
          } else {  // combo c: face cface[c], its points at cperm[c]
            const int c = s_cb[lf * E + el];
            face = __ldg(cface + c);
            pos = cperm + (size_t)c * nqf;
          }
        },
        [&](int side, int el, int cg, const T*& x, int& ldx) {
          if (side == 0) {
            x = sX + (size_t)el * nx + cg * NEQ;
          } else {  // a fetched row, at its phase
            const T* src = nbr_x(lf, el);
            x = xn + (size_t)el * ld + (src ? row_phase(src) : 0) + cg * NEQ;
          }
          ldx = K;
        },
        sTo, sTn);
    __syncthreads();
    flux_stage<T, P, VISCOUS, PROTO, K>(E, nqf, sTo, sTn, Nor + lf * nor_lf,
                                        nor_e, e0, s_m + lf * E, ph, sF, fs);
    __syncthreads();
  }
  scatter(nlf - 1);
  __syncthreads();
  for (int i = tid; i < nt * ndof * NEQ; i += blockDim.x)
    Y[(size_t)e0 * ndof * NEQ + i] = sign * sY[i];
}

template <typename T, class P, bool VISCOUS, bool PROTO>
int launch(const T* X, const T* B, const int* cface, const int* cperm,
           const int* nbr, const T* N, const T* M, T* Y, int ne, int ndof,
           int nqf, int nlf, int n_combo, long long nor_lf, long long nor_e,
           double sign, const double* p, void* stream) {
  constexpr int NEQ = P::NEQ;
  constexpr int K = VISCOUS ? NEQ * (1 + P::DIM) : NEQ;
  static size_t allowed[2] = {48 * 1024, 48 * 1024};
  const Plan pl = face_plan(ndof, nqf, nlf, K, NEQ, sizeof(T));
  if (pl.tile == 0 || ne < 0 || nlf > NLF_MAX || n_combo < nlf)
    return (int)cudaErrorInvalidValue;
  if (ne == 0) return 0;
  auto kernel = pl.resident ? face_sweep<T, P, VISCOUS, PROTO, true>
                            : face_sweep<T, P, VISCOUS, PROTO, false>;
  if (int err = allow_smem(kernel, pl.smem, allowed[pl.resident])) return err;
  const int blocks = (ne + pl.tile - 1) / pl.tile;
  kernel<<<blocks, THREADS_MAX, pl.smem, (cudaStream_t)stream>>>(
      X, B, cface, cperm, nbr, N, M, Y, ne, ndof, nqf, nlf, n_combo, nor_lf,
      nor_e, T(sign), pl.tile, P::make(p));
  return (int)cudaGetLastError();
}

}  // namespace

