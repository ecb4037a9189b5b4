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
//     sign = -1.  Boundary slots (mask 0) are skipped: their BC fluxes
//     stay in PyTorch (dg/rhs.py).
//
// Neighbours are decoded from nbr_row and their rows taken from
// Btr_or[combo], so any conforming mesh works, not only grid rolls.
//
// Design: one thread block per element.  The block stages X_e in shared
// memory; per local face it forms both traces (the neighbour's straight
// from global memory), the pointwise flux per face point, and scatters
// through Btr_or[lf]^T into a shared accumulator.  Btr_or is read from
// global memory through the read-only cache (every block reads the same
// rows).
//
// Bound: arithmetic.  At p=2 GLL Navier-Stokes (ndof 27, nqf 25, k 20)
// one element does 6*25*27*(2*20 + 5) multiply-adds (both traces and the
// scatter) against ~2.5 KB of X and 1.8 KB of normals read.  No tensor
// cores, TMA or CUTLASS: correct first, fast in later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dg_pointwise.cuh"

namespace {

using namespace tps_dg;

constexpr int BLOCK = 128;
constexpr size_t SHARED_LIMIT = 48 * 1024;

template <typename T, int DIM, bool VISCOUS, bool PROTO>
__global__ void __launch_bounds__(BLOCK)
face_sweep(const T* __restrict__ X,        // [ne][ndof][K]
           const T* __restrict__ Bor,      // [n_combo][nqf][ndof]
           const int* __restrict__ nbr_row,  // [ne][nlf]
           const T* __restrict__ Nor,      // lf, e, (s, d) strided
           const T* __restrict__ mask,     // [ne][nlf] or null (all 1)
           T* __restrict__ Y,              // [ne][ndof][NEQ]
           int ndof, int nqf, int nlf, int n_combo, long long nor_lf,
           long long nor_e, T sign, Phys ph) {
  constexpr int NEQ = DIM + 2;
  constexpr int K = VISCOUS ? NEQ * (1 + DIM) : NEQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sx = reinterpret_cast<T*>(smem_raw);  // [ndof][K]
  T* to = sx + ndof * K;                    // [nqf][K] own trace
  T* tn = to + nqf * K;                     // [nqf][K] neighbour trace
  T* fl = tn + nqf * K;                     // [nqf][NEQ] face flux
  T* sy = fl + nqf * NEQ;                   // [ndof][NEQ] accumulator

  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const int nx = ndof * K, ny = ndof * NEQ, nt = nqf * K;
  const T gam = T(ph.gamma);

  for (int i = tid; i < nx; i += blockDim.x) sx[i] = X[(size_t)e * nx + i];
  for (int i = tid; i < ny; i += blockDim.x) sy[i] = T(0);
  __syncthreads();

  for (int lf = 0; lf < nlf; ++lf) {
    const T m = mask ? mask[(size_t)e * nlf + lf] : T(1);
    if (m == T(0)) continue;  // boundary slot (the same for every thread)
    const int row = nbr_row[(size_t)e * nlf + lf];
    const int en = row / n_combo, c = row - en * n_combo;
    const T* bo = Bor + (size_t)lf * nqf * ndof;
    const T* bn = Bor + (size_t)c * nqf * ndof;
    const T* xn = X + (size_t)en * nx;

    // traces (s, channel): own from shared memory, neighbour from global
    for (int o = tid; o < 2 * nt; o += blockDim.x) {
      const bool own = o < nt;
      const int i = own ? o : o - nt;
      const int s = i / K, q = i - s * K;
      const T* b = (own ? bo : bn) + (size_t)s * ndof;
      const T* src = own ? sx + q : xn + q;
      T acc = T(0);
      for (int k = 0; k < ndof; ++k) acc += __ldg(b + k) * src[k * K];
      (own ? to : tn)[i] = acc;
    }
    __syncthreads();

    for (int s = tid; s < nqf; s += blockDim.x) {
      const T* np = Nor + lf * nor_lf + e * nor_e + (long long)s * DIM;
      T n[DIM];
      for (int d = 0; d < DIM; ++d) n[d] = np[d];
      const T* u1 = to + s * K;
      const T* u2 = tn + s * K;
      T f[NEQ];
      if constexpr (PROTO)
        rusanov_prototype<T, DIM>(u1, u2, n, gam, f);
      else
        rusanov<T, DIM>(u1, u2, n, gam, f);
      if constexpr (VISCOUS) {
        T v1[NEQ], v2[NEQ];
        visc_dot_n<T, DIM>(u1, u1 + NEQ, n, ph, v1);
        visc_dot_n<T, DIM>(u2, u2 + NEQ, n, ph, v2);
        for (int q = 1; q < NEQ; ++q) f[q] -= T(0.5) * (v1[q] + v2[q]);
      }
      for (int q = 0; q < NEQ; ++q) fl[s * NEQ + q] = f[q] * m;
    }
    __syncthreads();

    // scatter through Btr_or[lf]^T (the identity combo lf is Btr[lf])
    for (int o = tid; o < ny; o += blockDim.x) {
      const int j = o / NEQ, q = o - j * NEQ;
      T acc = T(0);
      for (int s = 0; s < nqf; ++s)
        acc += __ldg(bo + (size_t)s * ndof + j) * fl[s * NEQ + q];
      sy[o] += acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < ny; i += blockDim.x) Y[(size_t)e * ny + i] = sign * sy[i];
}

size_t face_smem(int ndof, int nqf, int k, int neq, size_t tsize) {
  return ((size_t)ndof * (k + neq) + (size_t)nqf * (2 * k + neq)) * tsize;
}

template <typename T, int DIM, bool VISCOUS, bool PROTO>
int launch(const T* X, const T* B, const int* nbr, const T* N, const T* M,
           T* Y, int ne, int ndof, int nqf, int nlf, int n_combo,
           long long nor_lf, long long nor_e, double sign, const double* p,
           void* stream) {
  constexpr int NEQ = DIM + 2;
  constexpr int K = VISCOUS ? NEQ * (1 + DIM) : NEQ;
  const size_t smem = face_smem(ndof, nqf, K, NEQ, sizeof(T));
  if (smem > SHARED_LIMIT || ne < 0) return (int)cudaErrorInvalidValue;
  if (ne == 0) return 0;
  face_sweep<T, DIM, VISCOUS, PROTO><<<ne, BLOCK, smem, (cudaStream_t)stream>>>(
      X, B, nbr, N, M, Y, ndof, nqf, nlf, n_combo, nor_lf, nor_e, T(sign),
      make_phys(p));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* X, const T* B, const int* nbr, const T* N, const T* M,
             T* Y, int ne, int ndof, int nqf, int nlf, int n_combo,
             long long nor_lf, long long nor_e, double sign, int dim,
             int viscous, int prototype, const double* p, void* stream) {
  if (prototype) {
    if (dim != 3 || viscous) return (int)cudaErrorInvalidValue;
    return launch<T, 3, false, true>(X, B, nbr, N, M, Y, ne, ndof, nqf, nlf,
                                     n_combo, nor_lf, nor_e, sign, p, stream);
  }
  if (dim == 2)
    return viscous ? launch<T, 2, true, false>(X, B, nbr, N, M, Y, ne, ndof,
                                               nqf, nlf, n_combo, nor_lf,
                                               nor_e, sign, p, stream)
                   : launch<T, 2, false, false>(X, B, nbr, N, M, Y, ne, ndof,
                                                nqf, nlf, n_combo, nor_lf,
                                                nor_e, sign, p, stream);
  if (dim == 3)
    return viscous ? launch<T, 3, true, false>(X, B, nbr, N, M, Y, ne, ndof,
                                               nqf, nlf, n_combo, nor_lf,
                                               nor_e, sign, p, stream)
                   : launch<T, 3, false, false>(X, B, nbr, N, M, Y, ne, ndof,
                                                nqf, nlf, n_combo, nor_lf,
                                                nor_e, sign, p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface for ctypes.  Normal of (lf, e, point s, d) at
// N[lf * nor_lf + e * nor_e + s * dim + d]; `mask` may be null (all
// slots interior); `phys` as in dg_pointwise.cuh::make_phys.  Each returns
// the cudaError_t of its launch.
extern "C" {

int tps_face_sweep_f32(const float* X, const float* B, const int* nbr,
                       const float* N, const float* M, float* Y, int ne,
                       int ndof, int nqf, int nlf, int n_combo,
                       long long nor_lf, long long nor_e, double sign,
                       int dim, int viscous, int prototype,
                       const double* phys, void* stream) {
  return dispatch<float>(X, B, nbr, N, M, Y, ne, ndof, nqf, nlf, n_combo,
                         nor_lf, nor_e, sign, dim, viscous, prototype, phys,
                         stream);
}

int tps_face_sweep_f64(const double* X, const double* B, const int* nbr,
                       const double* N, const double* M, double* Y, int ne,
                       int ndof, int nqf, int nlf, int n_combo,
                       long long nor_lf, long long nor_e, double sign,
                       int dim, int viscous, int prototype,
                       const double* phys, void* stream) {
  return dispatch<double>(X, B, nbr, N, M, Y, ne, ndof, nqf, nlf, n_combo,
                          nor_lf, nor_e, sign, dim, viscous, prototype, phys,
                          stream);
}

}  // extern "C"
