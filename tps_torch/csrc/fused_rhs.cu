// Hopper kernels for the fused periodic-box DG right-hand side (DryAir,
// 3-D, Euler or Navier-Stokes, Rusanov): K1 (DG gradient of the
// primitives) and K2 (volume flux + six face fluxes + folded inverse-mass
// scatter).  They replace the two Pallas TPU kernels of the JAX package,
// dg/pallas_fused.py: k1_kernel and k2_kernel.
//
// What each computes is the TPU kernels' algebra on the same folded
// matrices (dg/cuda_fused.py builds them from the DG tables):
//   K1: G = M_self . Up + sum_lf M_lf . Up(neighbor lf)
//       Up = (rho, u, v, w, T) at each dof; M_* are [3*ndof, ndof].
//   K2: y = sum_dd V_dd . (Fconv - Fvisc)[dd]
//         + sum_lf W_lf . flux_lf(traces of U and G through Btr),
//       flux = Rusanov (dissipation scaled by |n|) minus the mean of the
//       two one-sided viscous normal fluxes (equations 1..4 only).
//
// Layout: element-major, the solver's own [ne, ndof, neq] state and a
// [ne, ndof, neq, dim] gradient, so no layout conversion sits between the
// solver and the kernels.  Elements form a C-order (nz, ny, nx) periodic
// grid; the neighbor across local face lf sits `step[lf]` cells along
// `axis[lf]` (step = -shift of the tables' roll_info), with wrap-around.
//
// Design: one thread block per element.  A block stages its element's
// state (and for K1 the six neighbors' primitives) in shared memory and
// walks the small dense products with block-strided loops; the folded
// matrices are read from global memory through the read-only cache (every
// block reads the same few tens of KB, so they stay in L1/L2).
//
// Bound: arithmetic.  At p=2 K1 does 7*81*27*5 multiply-adds per element
// and K2 about 77k, against ~4 KB of state and gradient read per element;
// the dense folds trade extra flops for a simple, general-in-ndof kernel.
// No tensor cores, TMA or CUTLASS: correct first, fast in later work.
//
// The pointwise physics (primitives, Sutherland, fluxes, Rusanov) is in
// dg_pointwise.cuh, shared with face_sweep.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dg_pointwise.cuh"

namespace {

using namespace tps_dg;

constexpr int NEQ = 5;   // rho, rho u, rho v, rho w, rho E
constexpr int DIM = 3;
constexpr int NLF = 6;
constexpr int BLOCK = 128;

struct Geo {
  int nz, ny, nx;
  int axis[NLF];
  int step[NLF];
  int opp[NLF];
};

__device__ __forceinline__ int neighbor(int e, int lf, const Geo& g) {
  int c[3];
  c[2] = e % g.nx;
  c[1] = (e / g.nx) % g.ny;
  c[0] = e / (g.nx * g.ny);
  const int n[3] = {g.nz, g.ny, g.nx};
  const int a = g.axis[lf];
  c[a] = ((c[a] + g.step[lf]) % n[a] + n[a]) % n[a];
  return (c[0] * g.ny + c[1]) * g.nx + c[2];
}

// ---------------------------------------------------------------- K1
template <typename T>
__global__ void __launch_bounds__(BLOCK)
k1_gradient(const T* __restrict__ U, const T* __restrict__ W,
            T* __restrict__ G, int ndof, Geo geo, Phys ph) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* up = reinterpret_cast<T*>(smem_raw);  // [1+NLF][ndof][NEQ]
  const int e = blockIdx.x;
  const T gm1 = T(ph.gamma) - T(1);
  const T rgas = T(ph.rgas);

  // primitives of the element (slot 0) and its six neighbors
  for (int i = threadIdx.x; i < (1 + NLF) * ndof; i += blockDim.x) {
    const int s = i / ndof, k = i - s * ndof;
    const int src = s == 0 ? e : neighbor(e, s - 1, geo);
    const T* u = U + ((size_t)src * ndof + k) * NEQ;
    const T rho = u[0];
    const T inv = T(1) / rho;
    const T vx = u[1] * inv, vy = u[2] * inv, vz = u[3] * inv;
    const T ke = T(0.5) * rho * (vx * vx + vy * vy + vz * vz);
    const T p = gm1 * (u[4] - ke);
    T* o = up + i * NEQ;
    o[0] = rho;
    o[1] = vx;
    o[2] = vy;
    o[3] = vz;
    o[4] = p * inv / rgas;
  }
  __syncthreads();

  // G[(dd, j), eq] = sum_s sum_k W[s][(dd, j)][k] up[s][k][eq]
  const int nrow = DIM * ndof;
  for (int o = threadIdx.x; o < nrow * NEQ; o += blockDim.x) {
    const int r = o / NEQ, q = o - r * NEQ;
    T acc = T(0);
    for (int s = 0; s < 1 + NLF; ++s) {
      const T* w = W + ((size_t)s * nrow + r) * ndof;
      const T* x = up + s * ndof * NEQ + q;
      for (int k = 0; k < ndof; ++k) acc += __ldg(w + k) * x[k * NEQ];
    }
    const int dd = r / ndof, j = r - dd * ndof;
    G[(((size_t)e * ndof + j) * NEQ + q) * DIM + dd] = acc;
  }
}

// ---------------------------------------------------------------- K2
template <typename T>
__global__ void __launch_bounds__(BLOCK)
k2_faces_volume(const T* __restrict__ U, const T* __restrict__ G,
                const T* __restrict__ V,     // [DIM][ndof][ndof]
                const T* __restrict__ Btr,   // [NLF][nqf][ndof]
                const T* __restrict__ Wsc,   // [NLF][ndof][nqf]
                const T* __restrict__ Nor,   // [NLF][nqf][DIM]
                T* __restrict__ Y, T* __restrict__ mcs, int ndof, int nqf,
                int viscous, Geo geo, Phys ph) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* su = reinterpret_cast<T*>(smem_raw);  // [ndof][NEQ]
  T* sg = su + ndof * NEQ;                  // [ndof][NEQ][DIM]
  T* sf = sg + ndof * NEQ * DIM;            // [ndof][NEQ][DIM] volume flux
  T* sy = sf + ndof * NEQ * DIM;            // [ndof][NEQ] accumulator
  T* sm = sy + ndof * NEQ;                  // [ndof] char speed
  T* to = sm + ndof;                        // [nqf][NEQ] own U trace
  T* tn = to + nqf * NEQ;                   // [nqf][NEQ] neighbor U trace
  T* go = tn + nqf * NEQ;                   // [nqf][NEQ][DIM] own G trace
  T* gn = go + nqf * NEQ * DIM;             // [nqf][NEQ][DIM] nbr G trace
  T* fl = gn + nqf * NEQ * DIM;             // [nqf][NEQ] face flux

  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const T gam = T(ph.gamma);
  const T gm1 = gam - T(1);
  const int nu = ndof * NEQ, ng = ndof * NEQ * DIM;

  for (int i = tid; i < nu; i += blockDim.x) su[i] = U[(size_t)e * nu + i];
  if (viscous)
    for (int i = tid; i < ng; i += blockDim.x) sg[i] = G[(size_t)e * ng + i];
  __syncthreads();

  // ---- pointwise volume flux F = Fconv - Fvisc, and |u| + c ----
  for (int q = tid; q < ndof; q += blockDim.x) {
    const T* u = su + q * NEQ;
    const T rho = u[0];
    const T inv = T(1) / rho;
    const T vel[3] = {u[1] * inv, u[2] * inv, u[3] * inv};
    const T v2 = vel[0] * vel[0] + vel[1] * vel[1] + vel[2] * vel[2];
    const T p = gm1 * (u[4] - T(0.5) * rho * v2);
    sm[q] = sqrt(v2) + sqrt(gam * p / rho);
    T* F = sf + q * NEQ * DIM;
    for (int d = 0; d < 3; ++d) {
      F[0 * DIM + d] = u[1 + d];
      for (int i = 0; i < 3; ++i)
        F[(1 + i) * DIM + d] = u[1 + i] * vel[d] + (i == d ? p : T(0));
      F[4 * DIM + d] = vel[d] * (u[4] + p);
    }
    if (viscous) {
      const T* g = sg + q * NEQ * DIM;
      T mu, kap;
      mu_kappa(p * inv / T(ph.rgas), ph, mu, kap);
      const T bulk = (T(ph.bulk_mult) - T(2) / T(3)) * mu;
      const T div = g[1 * DIM + 0] + g[2 * DIM + 1] + g[3 * DIM + 2];
      for (int d = 0; d < 3; ++d) {
        T fe = T(0);
        for (int i = 0; i < 3; ++i) {
          T tau = mu * (g[(1 + i) * DIM + d] + g[(1 + d) * DIM + i]);
          if (i == d) tau += bulk * div;
          F[(1 + i) * DIM + d] -= tau;
          fe += tau * vel[i];
        }
        F[4 * DIM + d] -= fe + kap * g[4 * DIM + d];
      }
    }
  }
  __syncthreads();

  // ---- volume scatter: y[j][eq] = sum_dd sum_q V[dd][j][q] F[q][eq][dd] ----
  for (int o = tid; o < nu; o += blockDim.x) {
    const int j = o / NEQ, q = o - j * NEQ;
    T acc = T(0);
    for (int dd = 0; dd < DIM; ++dd) {
      const T* v = V + ((size_t)dd * ndof + j) * ndof;
      for (int k = 0; k < ndof; ++k)
        acc += __ldg(v + k) * sf[(k * NEQ + q) * DIM + dd];
    }
    sy[o] = acc;
  }

  // ---- the six faces ----
  const int nt = nqf * NEQ * (viscous ? 1 + DIM : 1);
  for (int lf = 0; lf < NLF; ++lf) {
    const int opp = geo.opp[lf];
    const int nb = neighbor(e, lf, geo);
    const T* bo = Btr + (size_t)lf * nqf * ndof;
    const T* bn = Btr + (size_t)opp * nqf * ndof;
    const T* un = U + (size_t)nb * nu;
    const T* gnb = G + (size_t)nb * ng;
    // traces: own side from shared memory, neighbor side (its opposite
    // face) straight from global memory
    for (int o = tid; o < 2 * nt; o += blockDim.x) {
      const bool own = o < nt;
      const int i = own ? o : o - nt;
      const T* b = own ? bo : bn;
      T acc = T(0);
      if (i < nqf * NEQ) {  // U trace (s, eq)
        const int s = i / NEQ, q = i - s * NEQ;
        const T* src = own ? su + q : un + q;
        for (int k = 0; k < ndof; ++k)
          acc += __ldg(b + s * ndof + k) * src[k * NEQ];
        (own ? to : tn)[i] = acc;
      } else {  // G trace (s, eq, dd)
        const int ig = i - nqf * NEQ;
        const int s = ig / (NEQ * DIM), c = ig - s * NEQ * DIM;
        const T* src = own ? sg + c : gnb + c;
        for (int k = 0; k < ndof; ++k)
          acc += __ldg(b + s * ndof + k) * src[k * NEQ * DIM];
        (own ? go : gn)[ig] = acc;
      }
    }
    __syncthreads();

    for (int s = tid; s < nqf; s += blockDim.x) {
      const T* n = Nor + ((size_t)lf * nqf + s) * DIM;
      const T* u1 = to + s * NEQ;
      const T* u2 = tn + s * NEQ;
      T* f = fl + s * NEQ;
      rusanov<T, DIM>(u1, u2, n, gam, f);
      if (viscous) {
        T v1[NEQ], v2[NEQ];
        visc_dot_n<T, DIM>(u1, go + s * NEQ * DIM, n, ph, v1);
        visc_dot_n<T, DIM>(u2, gn + s * NEQ * DIM, n, ph, v2);
        for (int q = 1; q < NEQ; ++q) f[q] -= T(0.5) * (v1[q] + v2[q]);
      }
    }
    __syncthreads();

    // scatter through W_lf = -(w * Btr_lf^T * Minv)
    const T* w = Wsc + (size_t)lf * ndof * nqf;
    for (int o = tid; o < nu; o += blockDim.x) {
      const int j = o / NEQ, q = o - j * NEQ;
      T acc = T(0);
      for (int s = 0; s < nqf; ++s) acc += __ldg(w + j * nqf + s) * fl[s * NEQ + q];
      sy[o] += acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < nu; i += blockDim.x) Y[(size_t)e * nu + i] = sy[i];
  if (tid == 0) {
    T m = sm[0];
    for (int q = 1; q < ndof; ++q) m = nan_max(m, sm[q]);
    mcs[e] = m;
  }
}

Geo make_geo(const int* g) {
  Geo geo;
  geo.nz = g[0];
  geo.ny = g[1];
  geo.nx = g[2];
  for (int lf = 0; lf < NLF; ++lf) {
    geo.axis[lf] = g[3 + lf];
    geo.step[lf] = g[3 + NLF + lf];
    geo.opp[lf] = g[3 + 2 * NLF + lf];
  }
  return geo;
}

size_t k1_smem(int ndof, size_t tsize) {
  return (size_t)(1 + NLF) * ndof * NEQ * tsize;
}

size_t k2_smem(int ndof, int nqf, size_t tsize) {
  return ((size_t)ndof * (2 * NEQ + 2 * NEQ * DIM + 1) +
          (size_t)nqf * (3 * NEQ + 2 * NEQ * DIM)) * tsize;
}

template <typename T>
int launch_k1(const T* U, const T* W, T* G, int ne, int ndof, const int* g,
              const double* p, void* stream) {
  const size_t smem = k1_smem(ndof, sizeof(T));
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  k1_gradient<T><<<ne, BLOCK, smem, (cudaStream_t)stream>>>(
      U, W, G, ndof, make_geo(g), make_phys(p));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k2(const T* U, const T* G, const T* V, const T* B, const T* Wsc,
              const T* N, T* Y, T* mcs, int ne, int ndof, int nqf,
              int viscous, const int* g, const double* p, void* stream) {
  const size_t smem = k2_smem(ndof, nqf, sizeof(T));
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  k2_faces_volume<T><<<ne, BLOCK, smem, (cudaStream_t)stream>>>(
      U, G, V, B, Wsc, N, Y, mcs, ndof, nqf, viscous, make_geo(g),
      make_phys(p));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  `geo` holds nz, ny, nx, then axis[6],
// step[6], opp[6]; `phys` holds gamma, R, C1*visc_mult, S0, cp/Pr,
// bulk_mult.  Each returns the cudaError_t of its launch.
extern "C" {

int tps_k1_gradient_f32(const float* U, const float* W, float* G, int ne,
                        int ndof, const int* geo, const double* phys,
                        void* stream) {
  return launch_k1<float>(U, W, G, ne, ndof, geo, phys, stream);
}

int tps_k1_gradient_f64(const double* U, const double* W, double* G, int ne,
                        int ndof, const int* geo, const double* phys,
                        void* stream) {
  return launch_k1<double>(U, W, G, ne, ndof, geo, phys, stream);
}

int tps_k2_faces_volume_f32(const float* U, const float* G, const float* V,
                            const float* B, const float* W, const float* N,
                            float* Y, float* mcs, int ne, int ndof, int nqf,
                            int viscous, const int* geo, const double* phys,
                            void* stream) {
  return launch_k2<float>(U, G, V, B, W, N, Y, mcs, ne, ndof, nqf, viscous,
                          geo, phys, stream);
}

int tps_k2_faces_volume_f64(const double* U, const double* G, const double* V,
                            const double* B, const double* W, const double* N,
                            double* Y, double* mcs, int ne, int ndof, int nqf,
                            int viscous, const int* geo, const double* phys,
                            void* stream) {
  return launch_k2<double>(U, G, V, B, W, N, Y, mcs, ne, ndof, nqf, viscous,
                           geo, phys, stream);
}

}  // extern "C"
