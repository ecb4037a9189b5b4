// Pointwise DG physics shared by the Hopper kernels (fused_rhs.cu,
// face_sweep.cu): DryAir primitives, Sutherland or constant transport, the
// convective and one-sided viscous normal fluxes, and the Rusanov flux in
// its two wave-speed forms; `DryAirPhysics`, the face stage's physics
// policy for DryAir (dg_mixture.cuh has the argon plasma's).  Each is the device counterpart of the plain PyTorch
// code its kernel is checked against (physics/gas.py, physics/transport.py,
// dg/fluxes.py, dg/riemann.py; the prototype form: dg/cuda_faces.py).
//
// State: U = (rho, rho u_1..u_DIM, rho E), NEQ = DIM + 2.  Gradients of
// the primitives (rho, u_1..u_DIM, T) are laid out g[eq * DIM + d].

#pragma once

#include <cuda_runtime.h>

namespace tps_dg {

struct Phys {
  double gamma, rgas;     // gas
  double c1, s0, cp_pr;   // Sutherland C1 * visc_mult, S0, cp / Pr
  double bulk_mult;       // bulk viscosity multiplier
  bool constant;          // constant transport: the three values below
  double mu0, bulk0, kap0;  // mu, bulk viscosity (before -2/3 mu), kappa
};

// `phys` holds gamma, R, C1*visc_mult, S0, cp/Pr, bulk_mult, then the
// transport switch (0 Sutherland, 1 constant) and the constant mu, bulk
// viscosity and kappa (physics/transport.py::ConstantTransport).
inline Phys make_phys(const double* p) {
  Phys ph;
  ph.gamma = p[0];
  ph.rgas = p[1];
  ph.c1 = p[2];
  ph.s0 = p[3];
  ph.cp_pr = p[4];
  ph.bulk_mult = p[5];
  ph.constant = p[6] != 0.0;
  ph.mu0 = p[7];
  ph.bulk0 = p[8];
  ph.kap0 = p[9];
  return ph;
}

// NaN-propagating max (fmax would drop a NaN and hide it from the guard).
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (b > a || b != b) ? b : a;
}

// Viscosity, conductivity and the Stokes-corrected bulk coefficient
// (bulk viscosity - 2/3 mu) at temperature temp: Sutherland's law, or the
// constant values.
template <typename T>
__device__ __forceinline__ void transport(T temp, const Phys& ph, T& mu,
                                          T& kap, T& bulk) {
  if (ph.constant) {
    mu = T(ph.mu0);
    kap = T(ph.kap0);
    bulk = T(ph.bulk0) - T(2) / T(3) * mu;
  } else {
    mu = T(ph.c1) * temp * sqrt(temp) / (temp + T(ph.s0));
    kap = T(ph.cp_pr) * mu;
    bulk = (T(ph.bulk_mult) - T(2) / T(3)) * mu;
  }
}

// Convective flux of a conserved state along the (scaled) normal n, with
// the sound speed, |u| and u.n.
template <typename T, int DIM>
__device__ __forceinline__ void conv_dot_n(const T* u, const T* n, T gam,
                                           T* f, T& snd, T& vmag, T& un) {
  constexpr int IE = DIM + 1;
  const T rho = u[0];
  const T inv = T(1) / rho;
  T vel[DIM];
  T v2 = T(0);
  un = T(0);
  for (int d = 0; d < DIM; ++d) {
    vel[d] = u[1 + d] * inv;
    v2 += vel[d] * vel[d];
    un += n[d] * vel[d];
  }
  const T p = (gam - T(1)) * (u[IE] - T(0.5) * rho * v2);
  f[0] = rho * un;
  for (int d = 0; d < DIM; ++d) f[1 + d] = f[0] * vel[d] + n[d] * p;
  f[IE] = un * (u[IE] + p);
  snd = sqrt(gam * p / rho);
  vmag = sqrt(v2);
}

// The Rusanov flux from each side's conv_dot_n results (f, sound speed s,
// |u| v, u.n): PROTO, the face-sweep prototype's form
// (tools/pallas_face_prototype.py:57-77), per side |u.n| + c |n|, then the
// max over the sides; else the package form (dg/riemann.py), the max over
// the two sides of |u| + c, times |n|.
template <typename T, int DIM, bool PROTO>
__device__ __forceinline__ void rusanov_combine(const T* u1, const T* u2,
                                                const T* n, const T* f1,
                                                const T* f2, T s1, T v1, T un1,
                                                T s2, T v2, T un2, T* f) {
  constexpr int NEQ = DIM + 2;
  T nmag2 = T(0);
  for (int d = 0; d < DIM; ++d) nmag2 += n[d] * n[d];
  T lam;
  if constexpr (PROTO) {
    const T nmag = sqrt(nmag2);
    const T c1 = fabs(un1) + s1 * nmag, c2 = fabs(un2) + s2 * nmag;
    lam = T(0.5) * (c1 > c2 ? c1 : c2);
  } else {
    const T c1 = s1 + v1, c2 = s2 + v2;
    lam = T(0.5) * sqrt(nmag2) * (c1 > c2 ? c1 : c2);
  }
  for (int q = 0; q < NEQ; ++q)
    f[q] = T(0.5) * (f1[q] + f2[q]) - lam * (u2[q] - u1[q]);
}

// One-sided viscous normal flux of a traced state (T from the traced
// conserved variables, not a traced T) and its traced gradient gt[eq][d].
// fv[0] is not written (the continuity equation has no viscous flux).
template <typename T, int DIM>
__device__ __forceinline__ void visc_dot_n(const T* u, const T* gt,
                                           const T* n, const Phys& ph,
                                           T* fv) {
  constexpr int IE = DIM + 1;
  const T rho = u[0];
  T vel[DIM];
  T v2 = T(0);
  for (int d = 0; d < DIM; ++d) {
    vel[d] = u[1 + d] / rho;
    v2 += vel[d] * vel[d];
  }
  const T temp = (T(ph.gamma) - T(1)) / T(ph.rgas) * (u[IE] / rho - T(0.5) * v2);
  T mu, kap, bulk;
  transport(temp, ph, mu, kap, bulk);
  T div = T(0);
  for (int d = 0; d < DIM; ++d) div += gt[(1 + d) * DIM + d];
  T e = T(0);
  for (int i = 0; i < DIM; ++i) {
    T s = T(0);
    for (int d = 0; d < DIM; ++d) {
      T tij = mu * (gt[(1 + i) * DIM + d] + gt[(1 + d) * DIM + i]);
      if (i == d) tij += bulk * div;
      s += tij * n[d];
    }
    fv[1 + i] = s;
    e += s * vel[i];
  }
  T qn = T(0);
  for (int d = 0; d < DIM; ++d) qn += gt[IE * DIM + d] * n[d];
  fv[IE] = e + kap * qn;
}

// The face stage's physics policy (dg_face_stage.cuh::flux_stage) for
// DryAir: NEQ, the packed constants, per side the convective normal flux
// with its wave data (sound speed, |u|, u.n), the Rusanov combination of
// two sides (PROTO: the prototype's form) and the one-sided viscous normal
// flux.  The same functions as before the policy existed, so K2 and the
// face sweep compute what they did.
template <int DIM_>
struct DryAirPhysics {
  static constexpr int DIM = DIM_;
  static constexpr int NEQ = DIM + 2;
  static constexpr int NW = 3;
  using Params = Phys;

  static Params make(const double* p) { return make_phys(p); }

  template <typename T>
  static __device__ __forceinline__ void conv(const T* u, const T* n,
                                              const Params& ph, T* f, T* w) {
    conv_dot_n<T, DIM>(u, n, T(ph.gamma), f, w[0], w[1], w[2]);
  }

  template <typename T, bool PROTO>
  static __device__ __forceinline__ void combine(const T* u1, const T* u2,
                                                 const T* n, const T* f1,
                                                 const T* f2, const T* w1,
                                                 const T* w2, T* f) {
    rusanov_combine<T, DIM, PROTO>(u1, u2, n, f1, f2, w1[0], w1[1], w1[2],
                                   w2[0], w2[1], w2[2], f);
  }

  template <typename T>
  static __device__ __forceinline__ void visc(const T* u, const T* gt,
                                              const T* n, const Params& ph,
                                              T* fv) {
    visc_dot_n<T, DIM>(u, gt, n, ph, fv);
  }
};

}  // namespace tps_dg
