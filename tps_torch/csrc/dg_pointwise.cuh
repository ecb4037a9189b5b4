// Pointwise DG physics shared by the Hopper kernels (fused_rhs.cu,
// face_sweep.cu): DryAir primitives, Sutherland or constant transport, the
// convective and one-sided viscous normal fluxes, the Rusanov flux in its
// two wave-speed forms and the Roe flux; the closures that change a
// point's transport coefficients before the stress forms (the mixing
// length, the Smagorinsky and Sigma SGS models, the planar viscous
// sponge); `DryAirPhysics`, the face stage's physics policy for DryAir
// (dg_mixture.cuh has the argon plasma's).  Each is the device
// counterpart of the plain PyTorch code its kernel is checked against
// (physics/gas.py, physics/transport.py, dg/fluxes.py, dg/riemann.py,
// dg/sgs.py; the prototype form: dg/cuda_faces.py).
//
// State: U = (rho, rho u_1..u_NVEL, rho E), NEQ = NVEL + 2, with NVEL =
// DIM, or DIM + 1 on the axisymmetric (r, z) state with swirl: (rho, rho
// u_r, rho u_z, rho u_t, rho E), the azimuthal momentum advected by u.n
// with no pressure term.  Gradients of the primitives (rho, u_1..u_NVEL,
// T) are laid out g[eq * DIM + d].

#pragma once

#include <cuda_runtime.h>
#include <float.h>

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

// The closures of the viscous flux (dg/fluxes.py::viscous), packed by
// dg/cuda_faces.py::closure_phys: the SGS model and its constant and
// floor (dg/sgs.py), the mixing length's switch, its largest length,
// turbulent Prandtl factor and bulk multiplier
// (physics/transport.py::MixingLengthTransport).  The sponge is on where
// its weights are given (FaceClosure::wgt).
struct Closure {
  double sgs;                  // 0 none, 1 Smagorinsky, 2 Sigma
  double sgs_const, sgs_floor;
  double mixing;               // 1: the mixing length (wall distances given)
  double l_max, prt, ml_bulk;
};
constexpr int CLOSURE_LEN = 7;

inline Closure make_closure(const double* c) {
  Closure cl = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  if (c) {
    double* dst = reinterpret_cast<double*>(&cl);
    static_assert(sizeof(Closure) == CLOSURE_LEN * sizeof(double),
                  "Closure is a flat array of doubles");
    for (int i = 0; i < CLOSURE_LEN; ++i) dst[i] = c[i];
  }
  return cl;
}

// The closures' per-point data of a face sweep, null where off: the
// element length scale of each element (delta [ne]) and of each slot's
// neighbour (delta_nbr [ne][nlf]), the sponge weight and the wall
// distance of each slot point ([ne][nlf][nqf]).  `on` is false for a
// sweep with no closure: the viscous flux is then the molecular one,
// the code it was before the closures.
template <typename T>
struct FaceClosure {
  bool on;
  Closure c;
  const T* delta;
  const T* delta_nbr;
  const T* wgt;
  const T* dist;
};

// What one side's viscous flux at one face point reads besides its
// trace: the radius (the axisymmetric policies), and where closures are
// on, its element's length scale, the wall distance and the sponge
// weight.
template <typename T>
struct FacePoint {
  T r;
  bool on;
  T delta, dist, wgt;
};

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
// the sound speed, |u| and u.n (|u| over all NVEL velocities; u.n and the
// pressure over the DIM in-plane ones).
template <typename T, int DIM, int NVEL = DIM>
__device__ __forceinline__ void conv_dot_n(const T* u, const T* n, T gam,
                                           T* f, T& snd, T& vmag, T& un) {
  constexpr int IE = NVEL + 1;
  const T rho = u[0];
  const T inv = T(1) / rho;
  T vel[NVEL];
  T v2 = T(0);
  un = T(0);
  for (int d = 0; d < NVEL; ++d) {
    vel[d] = u[1 + d] * inv;
    v2 += vel[d] * vel[d];
  }
  for (int d = 0; d < DIM; ++d) un += n[d] * vel[d];
  const T p = (gam - T(1)) * (u[IE] - T(0.5) * rho * v2);
  f[0] = rho * un;
  for (int d = 0; d < DIM; ++d) f[1 + d] = f[0] * vel[d] + n[d] * p;
  for (int d = DIM; d < NVEL; ++d) f[1 + d] = f[0] * vel[d];
  f[IE] = un * (u[IE] + p);
  snd = sqrt(gam * p / rho);
  vmag = sqrt(v2);
}

// The Rusanov flux from each side's conv_dot_n results (f, sound speed s,
// |u| v, u.n): PROTO, the face-sweep prototype's form
// (tools/pallas_face_prototype.py:57-77), per side |u.n| + c |n|, then the
// max over the sides; else the package form (dg/riemann.py), the max over
// the two sides of |u| + c, times |n|.
template <typename T, int DIM, bool PROTO, int NEQ = DIM + 2>
__device__ __forceinline__ void rusanov_combine(const T* u1, const T* u2,
                                                const T* n, const T* f1,
                                                const T* f2, T s1, T v1, T un1,
                                                T s2, T v2, T un2, T* f) {
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

// v / r where r > 0, else 0: a branch, never a floor on r (a tiny floor
// underflows in float).  Face points on the axis carry zero weight.
template <typename T>
__device__ __forceinline__ T over_r(T v, T r) {
  return r > T(0) ? v / r : T(0);
}

// The eigenvalues of the symmetric positive semi-definite 3x3 matrix q
// (row-major), descending, in closed form (the trigonometric solution of
// the characteristic cubic).
__device__ __forceinline__ void sym3_eigenvalues(const double* q,
                                                 double* ev) {
  const double p1 = q[1] * q[1] + q[2] * q[2] + q[5] * q[5];
  const double tr = (q[0] + q[4] + q[8]) / 3.0;
  const double a = q[0] - tr, b = q[4] - tr, c = q[8] - tr;
  const double p2 = a * a + b * b + c * c + 2.0 * p1;
  if (p2 <= 0.0) {
    ev[0] = ev[1] = ev[2] = tr;
    return;
  }
  const double p = sqrt(p2 / 6.0);
  // det((q - tr I) / p) / 2
  const double r = (a * (b * c - q[5] * q[5]) - q[1] * (q[1] * c - q[5] * q[2]) +
                    q[2] * (q[1] * q[5] - b * q[2])) /
                   (2.0 * p * p * p);
  const double phi = acos(r <= -1.0 ? -1.0 : r >= 1.0 ? 1.0 : r) / 3.0;
  ev[0] = tr + 2.0 * p * cos(phi);
  ev[2] = tr + 2.0 * p * cos(phi + 2.0943951023931957);  // + 2 pi / 3
  ev[1] = 3.0 * tr - ev[0] - ev[2];
}

// The closure step of one side's viscous flux, in dg/fluxes.py's order:
// the transport's mixing length (mu_t = rho min(0.41 d, l_max)^2 |S|,
// with the swirl strain under AXI; kappa += mu_t (kappa / mu) Pr_t, the
// bulk viscosity += bulk multiplier mu_t), then the SGS model
// (Smagorinsky, or Sigma from the singular values of the velocity
// gradient, zero in 2-D: bulk *= 1 + mu_sgs / mu, mu += mu_sgs, kappa +=
// mu_sgs kappa / mu), then the sponge weight on mu, bulk and kappa (the
// caller weighs the electron conductivity and the diffusion velocities).
// mu, kap: the molecular viscosity and (heavy) conductivity; bulk: the
// Stokes-corrected bulk coefficient (bulk viscosity - 2/3 mu).  vel: the
// point's NVEL velocities; gt: its gradient, g[eq * DIM + d].
template <typename T, int DIM, bool AXI>
__device__ __forceinline__ void closure_step(const Closure& c,
                                             const FacePoint<T>& pt, T rho,
                                             const T* vel, const T* gt, T& mu,
                                             T& kap, T& bulk) {
  auto g = [&](int i, int j) { return gt[(1 + i) * DIM + j]; };
  if (c.mixing != 0.0) {
    T s2 = T(0);  // 2 S:S
    for (int i = 0; i < DIM; ++i)
      for (int j = 0; j < DIM; ++j) {
        const T sij = T(0.5) * (g(i, j) + g(j, i));
        s2 += sij * sij;
      }
    s2 *= T(2);
    if constexpr (AXI) {  // the swirl strain
      const T szx = T(0.5) * (g(DIM, 0) - over_r(vel[DIM], pt.r));
      const T szy = T(0.5) * g(DIM, 1);
      const T szz = over_r(vel[0], pt.r);
      s2 += T(2) * (T(2) * szx * szx + T(2) * szy * szy + szz * szz);
    }
    const T l0 = T(0.41) * pt.dist;
    const T l = l0 < T(c.l_max) ? l0 : T(c.l_max);
    const T mut = rho * l * l * sqrt(s2);
    const T cpr = kap / mu;
    bulk += T(c.ml_bulk) * mut - T(2) / T(3) * mut;
    mu += mut;
    kap += mut * cpr * T(c.prt);
  }
  if (c.sgs != 0.0) {
    T dd = pt.delta - T(c.sgs_floor);
    dd = dd > T(0) ? T(c.sgs_const) * dd : T(0);
    T mu_sgs = T(0);
    if (c.sgs == 1.0) {  // Smagorinsky
      T s2 = T(0);
      for (int i = 0; i < DIM; ++i)
        for (int j = 0; j < DIM; ++j) {
          const T sij = T(0.5) * (g(i, j) + g(j, i));
          s2 += sij * sij;
        }
      mu_sgs = rho * dd * dd * sqrt(T(2) * s2);
    } else if constexpr (DIM == 3) {  // Sigma (s3 = 0 in 2-D)
      double q[9], ev[3];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          double acc = 0.0;
          for (int k = 0; k < 3; ++k) acc += double(g(k, i)) * double(g(k, j));
          q[i * 3 + j] = acc;
        }
      sym3_eigenvalues(q, ev);
      const double s1 = sqrt(ev[0] > 0.0 ? ev[0] : 0.0);
      const double s2 = sqrt(ev[1] > 0.0 ? ev[1] : 0.0);
      const double s3 = sqrt(ev[2] > 0.0 ? ev[2] : 0.0);
      double num = s3 * (s1 - s2) * (s2 - s3);
      num = num > 0.0 ? num : 0.0;
      const double s11 = s1 * s1;
      mu_sgs = rho * dd * dd * T(num / (s11 > 1e-24 ? s11 : 1e-24));
    }
    const T pr_cp = mu / kap;
    bulk *= T(1) + mu_sgs / mu;
    mu += mu_sgs;
    kap += mu_sgs / pr_cp;
  }
  mu *= pt.wgt;
  bulk *= pt.wgt;
  kap *= pt.wgt;
}

// The Roe flux of two DryAir sides (dg/riemann.py::Roe) from their
// convective normal fluxes f1, f2 along the scaled normal n: the mean less
// the contact, shear and acoustic waves' dissipation, formed on the unit
// normal, |n| floored at the type's least normal value (zero normals at
// padding slots), the contact speed's entropy fix at 1e-4.
template <typename T, int DIM>
__device__ __forceinline__ void roe_combine(const T* u1, const T* u2,
                                            const T* n, const T* f1,
                                            const T* f2, T gam, T* f) {
  constexpr int IE = DIM + 1;
  const T tiny = sizeof(T) == 8 ? T(DBL_MIN) : T(FLT_MIN);
  T nmag2 = T(0);
  for (int d = 0; d < DIM; ++d) nmag2 += n[d] * n[d];
  T normag = sqrt(nmag2);
  normag = normag < tiny ? tiny : normag;
  T nu[DIM];
  for (int d = 0; d < DIM; ++d) nu[d] = n[d] / normag;
  const T r1 = u1[0], r2 = u2[0];
  const T s1 = sqrt(r1), s2 = sqrt(r2), r = s1 * s2;
  T vel[DIM], dvel[DIM], m1 = T(0), m2 = T(0);
  T qk = T(0), v2 = T(0), dqk = T(0), vdv = T(0);
  for (int d = 0; d < DIM; ++d) {
    vel[d] = (u1[1 + d] / s1 + u2[1 + d] / s2) / (s1 + s2);
    dvel[d] = u2[1 + d] / r2 - u1[1 + d] / r1;
    m1 += u1[1 + d] * u1[1 + d];
    m2 += u2[1 + d] * u2[1 + d];
    qk += vel[d] * nu[d];
    v2 += vel[d] * vel[d];
    dqk += dvel[d] * nu[d];
    vdv += vel[d] * dvel[d];
  }
  const T p1 = (gam - T(1)) * (u1[IE] - T(0.5) * m1 / r1);
  const T p2 = (gam - T(1)) * (u2[IE] - T(0.5) * m2 / r2);
  const T H = ((u1[IE] + p1) / s1 + (u2[IE] + p2) / s2) / (s1 + s2);
  const T a2 = (gam - T(1)) * (H - T(0.5) * v2);
  const T a = sqrt(a2);
  const T lam0 = fabs(fabs(qk) < T(1e-4) ? T(1e-4) : qk);
  const T lam1 = fabs(qk + a), lam2 = fabs(qk - a);
  const T dP = p2 - p1;
  const T coef0 = (r2 - r1) - dP / a2;
  const T ap = T(0.5) * (dP + r * a * dqk) / a2 * lam1;
  const T am = T(0.5) * (dP - r * a * dqk) / a2 * lam2;
  T df[DIM + 2];
  df[0] = coef0 * lam0 + ap + am;
  for (int d = 0; d < DIM; ++d)
    df[1 + d] = (coef0 * vel[d] + r * (dvel[d] - nu[d] * dqk)) * lam0 +
                (vel[d] + nu[d] * a) * ap + (vel[d] - nu[d] * a) * am;
  df[IE] = (coef0 * T(0.5) * v2 + r * (vdv - qk * dqk)) * lam0 +
           (H + qk * a) * ap + (H - qk * a) * am;
  for (int q = 0; q < DIM + 2; ++q)
    f[q] = T(0.5) * (f1[q] + f2[q]) - T(0.5) * normag * df[q];
}

// One-sided viscous normal flux of a traced state (T from the traced
// conserved variables, not a traced T) and its traced gradient gt[eq][d].
// fv[0] is not written (the continuity equation has no viscous flux).
// AXI: the (r, z) + swirl state (NVEL = 3, DIM = 2) at radius r: u_r / r
// in div u, the swirl row (tau_tr, tau_tz) . n with tau_tr = mu (du_t/dr
// - u_t / r), tau_tz = mu du_t/dz, and its work u_t (tau_t . n) in the
// energy row (dg/fluxes.py's axisymmetric branch).  pt.on: the closure
// step (`closure_step`, constants cl) changes mu, kappa and the bulk
// coefficient before the stress forms.
template <typename T, int DIM, bool AXI = false>
__device__ __forceinline__ void visc_dot_n(const T* u, const T* gt,
                                           const T* n, const Phys& ph,
                                           T* fv, const FacePoint<T>& pt,
                                           const Closure& cl) {
  const T r = pt.r;
  constexpr int NVEL = DIM + (AXI ? 1 : 0);
  constexpr int IE = NVEL + 1;
  const T rho = u[0];
  T vel[NVEL];
  T v2 = T(0);
  for (int d = 0; d < NVEL; ++d) {
    vel[d] = u[1 + d] / rho;
    v2 += vel[d] * vel[d];
  }
  const T temp = (T(ph.gamma) - T(1)) / T(ph.rgas) * (u[IE] / rho - T(0.5) * v2);
  T mu, kap, bulk;
  transport(temp, ph, mu, kap, bulk);
  if (pt.on) closure_step<T, DIM, AXI>(cl, pt, rho, vel, gt, mu, kap, bulk);
  T div = T(0);
  for (int d = 0; d < DIM; ++d) div += gt[(1 + d) * DIM + d];
  if constexpr (AXI) div += over_r(vel[0], r);
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
  if constexpr (AXI) {
    const T ut = vel[DIM];
    const T* gu = gt + (1 + DIM) * DIM;  // grad u_t
    const T st = mu * (gu[0] - over_r(ut, r)) * n[0] + mu * gu[1] * n[1];
    fv[1 + DIM] = st;
    e += ut * st;
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
// face sweep compute what they did.  AXI_: the axisymmetric (r, z) state
// with swirl (DIM 2, NVEL 3, NEQ 5), its viscous flux at the point's
// radius.  ROE_: the Roe combination in place of Rusanov (planar).
template <int DIM_, bool AXI_ = false, bool ROE_ = false>
struct DryAirPhysics {
  static constexpr int DIM = DIM_;
  static constexpr bool AXI = AXI_;
  static constexpr bool ROE = ROE_;
  static constexpr int NVEL = DIM + (AXI ? 1 : 0);
  static constexpr int NEQ = NVEL + 2;
  static constexpr int NW = 3;
  static constexpr bool CLOSURES = true;  // takes the closure step
  using Params = Phys;
  static_assert(!AXI || DIM == 2, "the axisymmetric state is 2-D");
  static_assert(!(AXI && ROE), "Roe is planar (the reference refuses it "
                "with axisymmetry)");

  static Params make(const double* p) { return make_phys(p); }

  template <typename T>
  static __device__ __forceinline__ void conv(const T* u, const T* n,
                                              const Params& ph, T* f, T* w) {
    conv_dot_n<T, DIM, NVEL>(u, n, T(ph.gamma), f, w[0], w[1], w[2]);
  }

  template <typename T, bool PROTO>
  static __device__ __forceinline__ void combine(const T* u1, const T* u2,
                                                 const T* n, const T* f1,
                                                 const T* f2, const T* w1,
                                                 const T* w2,
                                                 const Params& ph, T* f) {
    if constexpr (ROE) {
      static_assert(!PROTO, "the prototype form is Rusanov");
      roe_combine<T, DIM>(u1, u2, n, f1, f2, T(ph.gamma), f);
    } else {
      rusanov_combine<T, DIM, PROTO, NEQ>(u1, u2, n, f1, f2, w1[0], w1[1],
                                          w1[2], w2[0], w2[1], w2[2], f);
    }
  }

  // pt: the point's radius (read on the axisymmetric state only) and
  // closure data (read where pt.on)
  template <typename T>
  static __device__ __forceinline__ void visc(const T* u, const T* gt,
                                              const T* n, const Params& ph,
                                              T* fv, const FacePoint<T>& pt,
                                              const Closure& cl) {
    visc_dot_n<T, DIM, AXI>(u, gt, n, ph, fv, pt, cl);
  }
};

}  // namespace tps_dg
