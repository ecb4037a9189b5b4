// Pointwise physics of the LTE-table fluid for the face stage
// (dg_face_stage.cuh::flux_stage): one equilibrium fluid whose
// thermodynamics and transport are tables.  The device counterpart of the
// plain PyTorch code the face-sweep kernel is checked against:
// physics/lte.py (LteMixture.temperature, pressure, max_char_speed;
// LteTransport.flux_properties), physics/tables.py (LinearTable, Table2D)
// and dg/fluxes.py with no bulk viscosity, no electron conduction and no
// diffusion, as the JAX package computes them in XLA.
//
// State: U = (rho, rho u_1..u_NVEL, rho E), NEQ = NVEL + 2, NVEL = DIM
// planar or 3 on the axisymmetric (r, z) state with swirl (AXI: u_theta
// the third velocity, carried by the normal speed and carrying no
// pressure; in the viscous flux u_r / r in div u and the swirl row
// mu (du_t/dr - u_t/r, du_t/dz) with its work, each 1/r through
// dg_pointwise.cuh::over_r, as dg/fluxes.py forms them); gradients of the
// primitives (rho, u, T) are laid out g[eq * DIM + d].
//
// T at a point: the T(e, rho) table's guess, then `newton` Newton steps on
// e(T, rho) = e with the finite-difference cv of physics/lte.py (dT = 1e-3
// max(T, 1)), a fixed count with no early exit, in the run's precision.
//
// Tables: device arrays of the run's dtype passed by pointer (their
// addresses packed as doubles by dg/cuda_faces.py::lte_phys, exact below
// 2^53), read through the read-only cache.  A 1-D table (LinearTable) is
// its abscissae and the per-segment a + b x coefficients that
// physics/tables.py forms in numpy f64, with its log-scale options; a 2-D
// table (Table2D) is its two axes and the values [nx][ny], bilinear and
// clamped.  The lookup is a binary search with torch.searchsorted's left
// rule, so the plain version's interval is found for every query, NaN
// included.  The table kind is a template parameter (TD = 1 or 2): each
// instantiation has one kind of lookup, none switches per lookup.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dg_pointwise.cuh"

namespace tps_dg {

// a pointer packed as a double (exact: device addresses are below 2^53)
__host__ __device__ inline const void* lte_ptr(double v) {
  return reinterpret_cast<const void*>((uintptr_t)(unsigned long long)v);
}

// The first index i with x[i] >= v among x[0..n) (n if none): the left
// rule of torch.searchsorted, as its binary search forms it.
template <typename T>
__device__ __forceinline__ int search_left(const T* __restrict__ x, int n,
                                           T v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(x + mid) < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// physics/tables.py::LinearTable: x[n] (log x where xlog), segments
// a[n-1], b[n-1]; the clamped end interval extrapolates.
struct LteTab1 {
  const void *x, *a, *b;
  int n, xlog, flog;

  static LteTab1 unpack(const double* q) {  // x, a, b, n, xlog, flog
    return {lte_ptr(q[0]), lte_ptr(q[1]), lte_ptr(q[2]), (int)q[3],
            (int)q[4], (int)q[5]};
  }

  template <typename T>
  __device__ __forceinline__ T operator()(T q, T) const {
    const T* xs = static_cast<const T*>(x);
    const T xt = xlog ? log(q) : q;
    int i = search_left(xs, n, xt) - 1;
    i = i < 0 ? 0 : (i > n - 2 ? n - 2 : i);
    const T ft = __ldg(static_cast<const T*>(a) + i) +
                 __ldg(static_cast<const T*>(b) + i) * xt;
    return flog ? exp(ft) : ft;
  }
};

// physics/tables.py::Table2D: axes x[nx], y[ny], values f[nx][ny];
// queries clamped to the grid, bilinear.
struct LteTab2 {
  const void *x, *y, *f;
  int nx, ny;

  static LteTab2 unpack(const double* q) {  // x, y, f, nx, ny, 0
    return {lte_ptr(q[0]), lte_ptr(q[1]), lte_ptr(q[2]), (int)q[3],
            (int)q[4]};
  }

  template <typename T>
  __device__ __forceinline__ T operator()(T xq, T yq) const {
    const T* xs = static_cast<const T*>(x);
    const T* ys = static_cast<const T*>(y);
    const T* fs = static_cast<const T*>(f);
    const T x0 = __ldg(xs), x1 = __ldg(xs + nx - 1);
    const T y0 = __ldg(ys), y1 = __ldg(ys + ny - 1);
    xq = xq < x0 ? x0 : (xq > x1 ? x1 : xq);
    yq = yq < y0 ? y0 : (yq > y1 ? y1 : yq);
    int i = search_left(xs, nx, xq) - 1;
    int j = search_left(ys, ny, yq) - 1;
    i = i < 0 ? 0 : (i > nx - 2 ? nx - 2 : i);
    j = j < 0 ? 0 : (j > ny - 2 ? ny - 2 : j);
    const T xi = __ldg(xs + i), yj = __ldg(ys + j);
    const T tx = (xq - xi) / (__ldg(xs + i + 1) - xi);
    const T ty = (yq - yj) / (__ldg(ys + j + 1) - yj);
    const T* r0 = fs + (size_t)i * ny + j;
    const T* r1 = r0 + ny;
    return __ldg(r0) * (T(1) - tx) * (T(1) - ty) +
           __ldg(r1) * tx * (T(1) - ty) + __ldg(r0 + 1) * (T(1) - tx) * ty +
           __ldg(r1 + 1) * tx * ty;
  }
};

template <int TD>
struct LteTabKind;
template <>
struct LteTabKind<1> {
  using type = LteTab1;
};
template <>
struct LteTabKind<2> {
  using type = LteTab2;
};

// Packed constants, in the order of dg/cuda_faces.py::lte_phys: the table
// dim and the Newton count, then six tables of six doubles each (energy,
// R, c, the T(e) guess, mu, kappa): three packed pointers and three ints
// (1-D: n, xlog, flog; 2-D: nx, ny, 0).
constexpr int LTE_TABLES = 6;
constexpr int LTE_PHYS_LEN = 2 + 6 * LTE_TABLES;

template <int TD>
struct LtePhys {
  using Tab = typename LteTabKind<TD>::type;
  int newton;
  Tab e, R, c, Tg, mu, kap;  // e(T, rho), R, c, T(e, rho), mu, kappa
};

template <int TD>
inline LtePhys<TD> make_lte_phys(const double* p) {
  using Tab = typename LteTabKind<TD>::type;
  LtePhys<TD> m;
  m.newton = (int)p[1];
  Tab* tabs[LTE_TABLES] = {&m.e, &m.R, &m.c, &m.Tg, &m.mu, &m.kap};
  for (int k = 0; k < LTE_TABLES; ++k) *tabs[k] = Tab::unpack(p + 2 + 6 * k);
  return m;
}

template <int DIM_, int TD, bool AXI_ = false>
struct LteFluid {
  static constexpr int DIM = DIM_;
  static constexpr bool AXI = AXI_;
  static constexpr int NVEL = DIM + (AXI ? 1 : 0);
  static constexpr int NEQ = NVEL + 2;
  static constexpr int IE = NVEL + 1;
  static constexpr int NW = 1;  // wave data per side: |u| + c
  static constexpr bool CLOSURES = false;  // no closure step
  using Params = LtePhys<TD>;
  static_assert(!AXI || DIM == 2, "the axisymmetric state is 2-D");

  static Params make(const double* p) { return make_lte_phys<TD>(p); }

  // T of a conserved state (physics/lte.py::LteMixture.temperature)
  template <typename T>
  static __device__ __forceinline__ T temperature(const T* u,
                                                  const Params& m) {
    const T rho = u[0];
    T m2 = T(0);
    for (int d = 0; d < NVEL; ++d) m2 += u[1 + d] * u[1 + d];
    const T e = (u[IE] - T(0.5) * m2 / rho) / rho;
    T th = m.Tg(e, rho);
#pragma unroll 1
    for (int k = 0; k < m.newton; ++k) {
      const T res = e - m.e(th, rho);
      const T dT = T(1e-3) * (th > T(1) ? th : T(1));
      const T cv = (m.e(th + dT, rho) - m.e(th - dT, rho)) / (T(2) * dT);
      th = th + res / (cv > T(1e-30) ? cv : T(1e-30));
    }
    return th;
  }

  // Convective flux along the (scaled) normal n and |u| + c
  // (fluxes.py::convective, lte.py::max_char_speed).
  template <typename T>
  static __device__ __forceinline__ void conv(const T* u, const T* n,
                                              const Params& m, T* f, T* w) {
    const T rho = u[0];
    const T th = temperature(u, m);
    const T p = rho * m.R(th, rho) * th;
    T vel[DIM], m2 = T(0), un = T(0), mn = T(0);
    for (int d = 0; d < DIM; ++d) {
      vel[d] = u[1 + d] / rho;
      m2 += u[1 + d] * u[1 + d];
      un += vel[d] * n[d];
      mn += u[1 + d] * n[d];
    }
    for (int d = DIM; d < NVEL; ++d) m2 += u[1 + d] * u[1 + d];
    f[0] = mn;
    for (int i = 0; i < DIM; ++i) f[1 + i] = u[1 + i] * un + p * n[i];
    for (int i = DIM; i < NVEL; ++i) f[1 + i] = u[1 + i] * un;
    f[IE] = un * (u[IE] + p);
    w[0] = sqrt(m2 / (rho * rho)) + m.c(th, rho);
  }

  // Rusanov (dg/riemann.py): the larger |u| + c, times |n|.
  template <typename T, bool PROTO>
  static __device__ __forceinline__ void combine(const T* u1, const T* u2,
                                                 const T* n, const T* f1,
                                                 const T* f2, const T* w1,
                                                 const T* w2, const Params&,
                                                 T* f) {
    static_assert(!PROTO, "the prototype form is DryAir's");
    T nmag2 = T(0);
    for (int d = 0; d < DIM; ++d) nmag2 += n[d] * n[d];
    const T lam = T(0.5) * ((w1[0] > w2[0] ? w1[0] : w2[0]) * sqrt(nmag2));
    for (int q = 0; q < NEQ; ++q)
      f[q] = T(0.5) * (f1[q] + f2[q]) - lam * (u2[q] - u1[q]);
  }

  // The one-sided viscous normal flux of a traced state and its traced
  // gradient gt[eq * DIM + d] (fluxes.py::viscous with
  // LteTransport.flux_properties: mu(T, rho), kappa(T, rho), no bulk
  // viscosity), at radius pt.r on the axisymmetric state (read there
  // only).  fv[0] is not written.
  template <typename T>
  static __device__ __forceinline__ void visc(const T* u, const T* gt,
                                              const T* n, const Params& m,
                                              T* fv, const FacePoint<T>& pt,
                                              const Closure&) {
    const T rho = u[0];
    const T th = temperature(u, m);
    const T mu = m.mu(th, rho), kap = m.kap(th, rho);
    const T bulk = T(0) - T(2) / T(3) * mu;
    T vel[DIM], div = T(0);
    for (int d = 0; d < DIM; ++d) {
      vel[d] = u[1 + d] / rho;
      div += gt[(1 + d) * DIM + d];
    }
    if constexpr (AXI) div += over_r(vel[0], pt.r);
    T tau[DIM][DIM];
    for (int i = 0; i < DIM; ++i)
      for (int j = 0; j < DIM; ++j) {
        tau[i][j] = mu * (gt[(1 + i) * DIM + j] + gt[(1 + j) * DIM + i]);
        if (i == j) tau[i][j] += bulk * div;
      }
    T e = T(0);
    for (int d = 0; d < DIM; ++d) {
      T tu = T(0), sn = T(0);
      for (int j = 0; j < DIM; ++j) {
        tu += tau[d][j] * vel[j];
        sn += tau[d][j] * n[j];
      }
      fv[1 + d] = sn;
      e += (tu + kap * gt[IE * DIM + d]) * n[d];
    }
    if constexpr (AXI) {  // the swirl row (tau_tr, tau_tz) and its work
      const T ut = u[1 + DIM] / rho;
      const T* gu = gt + (1 + DIM) * DIM;  // grad u_t
      const T st = mu * (gu[0] - over_r(ut, pt.r)) * n[0] + mu * gu[1] * n[1];
      fv[1 + DIM] = st;
      e += ut * st;
    }
    fv[IE] = e;
  }
};

}  // namespace tps_dg
