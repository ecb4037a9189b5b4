// Pointwise physics of the two-temperature ambipolar argon plasma for the
// face stage (dg_face_stage.cuh): the ternary perfect mixture [Ar+, e, Ar]
// with argon_minimal collision-integral transport.  The device counterpart
// of the plain PyTorch code the face-sweep kernel is checked against:
// physics/perfect_mixture.py (number densities, temperatures, pressure,
// max |u| + c), physics/gas_transport.py::ArgonMinimalTransport
// .flux_properties (viscosity, conductivities, ambipolar diffusion
// velocities), physics/collision_integrals.py and dg/fluxes.py's mixture
// branches, as the JAX package computes them in XLA.
//
// State: U = (rho, rho u_1..u_NVEL, rho E, rho Y_Ar+, rho e_e), NEQ =
// NVEL + 4 (ambipolar: the electrons follow from quasineutrality; two
// temperatures: the electron energy), NVEL = DIM, or 3 on the
// axisymmetric (r, z) state with swirl (AXI: the azimuthal momentum
// advected by u.n with no pressure term; the viscous flux's u_r / r, swirl
// stresses and their work as dg/fluxes.py's axisymmetric branch).
// Gradients of the primitives (rho, u, T_h, n_Ar+, T_e) are laid out
// g[eq * DIM + d].  rho Y_Ar+ is clipped at 0 as the plain face sweep
// clips its traces.
//
// Every constant comes packed from dg/cuda_faces.py::mixture_phys in
// double, the products of per-molecule masses among them: m_e m_Ar
// /(m_e + m_Ar) is ~5e-57 kg^2 / kg, below float's range, so no mass is
// combined on the card.  The third-order electron conductivity forms
// l11 - l12 (l12 / l22): l12^2 (~1e-52 m^4 at an ionisation of 1e-7)
// would underflow in float.

#pragma once

#include <cuda_runtime.h>

#include "dg_pointwise.cuh"

namespace tps_dg {

// Packed constants, in the order of dg/cuda_faces.py::mixture_phys.
struct MixPhys {
  double mw[3], z[3], cv[3], cp[3], hf_ion, rgas;  // species [Ar+, e, Ar]
  double ambipolar, two_temperature;               // must be 1, 1
  double debye, ndim;     // k eps0 / e^2 / N_A, 4 pi k eps0 / e^2
  double pi, xeps, tiny;  // pi, _XEPS, the mixture's _TINY
  double vis_i, vis_n;    // VISCOSITY_FACTOR sqrt(m_s)
  double koe_i, koe_n;    // K_OVER_ETA_FACTOR / m_s
  double ke3, ke1;        // VF KOE sqrt(2 / m_e), VF KOE sqrt(1 / m_e)
  double d_en, d_ni, d_ei;  // DIFFUSIVITY_FACTOR / sqrt(reduced mass)
  double qe_kb;           // e / k
  double visc_mult, kappa_mult, kappa_e_mult, diff_mult, mobil_mult;
  double third;           // third-order electron conductivity (1) or not
  double scr[8][4];       // (c, a, b, p): rep22, rep23, rep24, att11..att15
  double ar22[2], ar1p11[2];  // (A, b) of A T^b: Ar-Ar (2,2), Ar-Ar+ (1,1)
  double ear[5][9];       // e-Ar (1, r), r = 1..5: log T powers -1..7
};

constexpr int MIX_PHYS_LEN = 3 * 4 + 2 + 2 + 2 + 3 + 2 + 2 + 2 + 3 + 1 + 5 +
                             1 + 32 + 4 + 45;
constexpr int MIX_FLAGS = 14;  // where `ambipolar` sits

inline MixPhys make_mix_phys(const double* p) {
  MixPhys m;
  double* dst = reinterpret_cast<double*>(&m);
  static_assert(sizeof(MixPhys) == MIX_PHYS_LEN * sizeof(double),
                "MixPhys is a flat array of doubles");
  for (int i = 0; i < MIX_PHYS_LEN; ++i) dst[i] = p[i];
  return m;
}

// c log1p(a x^b)^p / x^2: a screened-Coulomb fit
// (collision_integrals.py::_screened); q = scr[i].
template <typename T>
__device__ __forceinline__ T screened(const double* q, T x) {
  return T(q[0]) * pow(log1p(T(q[1]) * pow(x, T(q[2]))), T(q[3])) / (x * x);
}

// sum_k c_k log(T)^k, k = -1..7 (collision_integrals.py::_log_t_fit)
template <typename T>
__device__ __forceinline__ T log_t_fit(const double* c, T lt) {
  T acc = T(0);
#pragma unroll
  for (int k = 8; k >= 1; --k) acc = acc * lt + T(c[k]);
  return acc + T(c[0]) / lt;
}

template <int DIM_, bool AXI_ = false>
struct ArgonMixture {
  static constexpr int DIM = DIM_;
  static constexpr bool AXI = AXI_;
  static constexpr int NVEL = DIM + (AXI ? 1 : 0);
  static constexpr int NEQ = NVEL + 4;
  static constexpr int IE = NVEL + 1, IS = NVEL + 2, IEE = NVEL + 3;
  static constexpr int NW = 1;  // wave data per side: |u| + c
  static constexpr bool CLOSURES = true;  // takes the closure step
  using Params = MixPhys;
  static_assert(!AXI || DIM == 2, "the axisymmetric state is 2-D");

  static Params make(const double* p) { return make_mix_phys(p); }

  template <typename T>
  static __device__ __forceinline__ T clipped(const T* u, int q) {
    return q == IS ? (u[q] > T(0) ? u[q] : T(0)) : u[q];
  }

  // Thermodynamic state of a (clipped) conserved state.
  template <typename T>
  struct State {
    T rho, vel[NVEL], v2, n[3], th, te, p, pe, cheavy;
  };

  template <typename T>
  static __device__ __forceinline__ void state(const T* u, const Params& m,
                                               State<T>& s) {
    s.rho = u[0];
    T m2 = T(0);
    for (int d = 0; d < NVEL; ++d) m2 += u[1 + d] * u[1 + d];
    for (int d = 0; d < NVEL; ++d) s.vel[d] = u[1 + d] / s.rho;
    s.v2 = m2 / (s.rho * s.rho);
    const T ni = clipped(u, IS) / T(m.mw[0]);
    const T zn = ni * T(m.z[0]);
    const T ne = zn > T(0) ? zn : T(0);
    const T nb = (s.rho - ni * T(m.mw[0]) - ne * T(m.mw[1])) / T(m.mw[2]);
    s.n[0] = ni;
    s.n[1] = ne;
    s.n[2] = nb;
    s.cheavy = ni * T(m.cv[0]) + nb * T(m.cv[2]);
    const T ke = T(0.5) * m2 / s.rho;
    s.th = (u[IE] - ni * T(m.hf_ion) - ke - u[IEE]) / s.cheavy;
    s.te = u[IEE] / (ne > T(m.tiny) ? ne : T(m.tiny)) / T(m.cv[1]);
    const T nh = ni + nb;
    const T r = T(m.rgas);
    s.p = (nh * s.th + ne * s.te) * r;
    s.pe = ne * r * s.te;
  }

  // Convective flux along the (scaled) normal n and |u| + c
  // (fluxes.py::convective, perfect_mixture.py::max_char_speed).
  template <typename T>
  static __device__ __forceinline__ void conv(const T* u, const T* n,
                                              const Params& m, T* f, T* w) {
    State<T> s;
    state(u, m, s);
    T un = T(0), mn = T(0);
    for (int d = 0; d < DIM; ++d) {
      un += n[d] * s.vel[d];
      mn += n[d] * u[1 + d];
    }
    f[0] = mn;
    for (int d = 0; d < DIM; ++d) f[1 + d] = u[1 + d] * un + n[d] * s.p;
    for (int d = DIM; d < NVEL; ++d) f[1 + d] = u[1 + d] * un;
    f[IE] = un * (u[IE] + s.p);
    f[IS] = clipped(u, IS) * un;
    f[IEE] = (u[IEE] + s.pe) / s.rho * mn;
    const T gam = T(1) + (s.n[0] + s.n[2]) * T(m.rgas) / s.cheavy;
    w[0] = sqrt(s.v2) + sqrt(gam * s.p / s.rho);
  }

  // Rusanov from both sides (dg/riemann.py): the larger |u| + c, times |n|.
  template <typename T, bool PROTO>
  static __device__ __forceinline__ void combine(const T* u1, const T* u2,
                                                 const T* n, const T* f1,
                                                 const T* f2, const T* w1,
                                                 const T* w2, const Params&,
                                                 T* f) {
    static_assert(!PROTO, "the prototype form is DryAir's");
    T nmag2 = T(0);
    for (int d = 0; d < DIM; ++d) nmag2 += n[d] * n[d];
    const T lam = T(0.5) * sqrt(nmag2) * (w1[0] > w2[0] ? w1[0] : w2[0]);
    for (int q = 0; q < NEQ; ++q)
      f[q] = T(0.5) * (f1[q] + f2[q]) - lam * (clipped(u2, q) - clipped(u1, q));
  }

  // The one-sided viscous normal flux of a traced state and its traced
  // gradient gt[eq * DIM + d] (fluxes.py::viscous with the transport's
  // flux_properties), at radius pt.r on the axisymmetric state (read there
  // only), with the closure step where pt.on (dg_pointwise.cuh::
  // closure_step; the sponge weight also on kappa_e and the diffusion
  // velocities).  In T but for the parts that cancel most of float's
  // digits, which are formed in double whatever T, as the plain version
  // forms them (physics/gas_transport.py::_f64): the species fractions
  // (the background's 1 - Y), the e-Ar log T fits, Devoto's third-order
  // electron conductivity and the diffusion block (the ambipolar field
  // cancels the electron's drift against the ion's).  fv[0] is not
  // written.
  template <typename T>
  static __device__ __forceinline__ void visc(const T* u, const T* gt,
                                              const T* n, const Params& m,
                                              T* fv, const FacePoint<T>& pt,
                                              const Closure& cl) {
    const T r = pt.r;
    State<T> s;
    state(u, m, s);
    const T th = s.th, te = s.te;
    // species in double (gas_transport.py::_species)
    double nd[3], Xd[3], Yd[3];
    {
      const double rho = u[0];
      const double ui = u[IS] > T(0) ? double(u[IS]) : 0.0;
      const double ni = ui / m.mw[0];
      const double zn = ni * m.z[0];
      nd[0] = ni;
      nd[1] = zn > 0.0 ? zn : 0.0;
      nd[2] = (rho - ni * m.mw[0] - nd[1] * m.mw[1]) / m.mw[2];
    }
    const double ntd = nd[0] + nd[1] + nd[2];
    T X[3];
    for (int i = 0; i < 3; ++i) {
      Xd[i] = nd[i] / ntd;
      Yd[i] = nd[i] * m.mw[i] / double(u[0]);
      X[i] = T(Xd[i]);
    }
    // collision inputs (gas_transport.py::_collision_inputs)
    const T xeps = T(m.xeps);
    const T n_over_t = (s.n[1] + xeps) / te + (s.n[0] + xeps) / th;
    const T dl = sqrt(T(m.debye) / n_over_t);
    const T dc = T(m.pi) * dl * dl;
    const T nd_te = dl * T(m.ndim) * te, nd_th = dl * T(m.ndim) * th;
    // viscosity and heavy conductivity (electron viscosity neglected)
    const T sth = sqrt(th), ste = sqrt(te);
    const T vis_i = T(m.vis_i) * sth / (screened(m.scr[0], nd_th) * dc);
    const T vis_n = T(m.vis_n) * sth / (T(m.ar22[0]) * pow(th, T(m.ar22[1])));
    T mu = (X[0] * vis_i + X[2] * vis_n) * T(m.visc_mult);
    T kap = (X[0] * (vis_i * T(m.koe_i)) + X[2] * (vis_n * T(m.koe_n))) *
            T(m.kappa_mult);
    // e-heavy integrals: e-Ar+ (1, r) by the attractive fits, e-Ar by the
    // log T fits (in double)
    const double lte = log(double(te));
    const T q_ie = screened(m.scr[3], nd_te) * dc;
    const double q_ea = log_t_fit(m.ear[0], lte);
    T kape;
    if (m.third != 0.0) {  // Devoto's third order (_third_order_ke)
      double q2[3], q1i[5], q1n[5];
      for (int r = 0; r < 3; ++r) q2[r] = dc * screened(m.scr[r], nd_te);
      q1i[0] = q_ie;
      q1n[0] = q_ea;
      for (int r = 1; r < 5; ++r) {
        q1i[r] = dc * screened(m.scr[3 + r], nd_te);
        q1n[r] = log_t_fit(m.ear[r], lte);
      }
      const double s2 = 1.4142135623730951 * Xd[1];
      auto l11 = [&](const double* q) {
        return 6.25 * q[0] - 15.0 * q[1] + 12.0 * q[2];
      };
      auto l12 = [&](const double* q) {
        return 10.9375 * q[0] - 39.375 * q[1] + 57.0 * q[2] - 30.0 * q[3];
      };
      auto l22 = [&](const double* q) {
        return 19.140625 * q[0] - 91.875 * q[1] + 199.5 * q[2] -
               210.0 * q[3] + 90.0 * q[4];
      };
      const double a11 = s2 * q2[0] + Xd[0] * l11(q1i) + Xd[2] * l11(q1n);
      const double a12 = s2 * (1.75 * q2[0] - 2.0 * q2[1]) +
                         Xd[0] * l12(q1i) + Xd[2] * l12(q1n);
      const double a22 = s2 * (4.8125 * q2[0] - 7.0 * q2[1] + 5.0 * q2[2]) +
                         Xd[0] * l22(q1i) + Xd[2] * l22(q1n);
      kape = T(m.ke3 * sqrt(double(te)) * Xd[1] / (a11 - a12 * (a12 / a22)));
    } else {
      kape = T(m.ke1) * ste * X[1] / (screened(m.scr[0], nd_te) * dc);
    }
    kape *= T(m.kappa_e_mult);
    // the diffusion block, in double: binary and Curtiss-Hirschfelder
    // diffusivities, mobilities
    const double thd = th, ted = te;
    const double d_en = m.d_en * sqrt(ted) / ntd / q_ea;
    const double d_ni =
        m.d_ni * sqrt(thd) / ntd /
        double(T(m.ar1p11[0]) * pow(th, T(m.ar1p11[1])));
    const double d_ei = m.d_ei * sqrt(ted) / ntd / double(q_ie);
    const double xe = Xd[1] + m.xeps, xi = Xd[0] + m.xeps,
                 xn = Xd[2] + m.xeps;
    double D[3];
    D[0] = (1.0 - Yd[0]) / (xe / d_ei + xn / d_ni) * m.diff_mult;
    D[1] = (1.0 - Yd[1]) / (xi / d_ei + xn / d_en) * m.diff_mult;
    D[2] = (1.0 - Yd[2]) / (xi / d_ni + xe / d_en) * m.diff_mult;
    double mob[3];
    const double tsp[3] = {thd, ted, thd};
    for (int i = 0; i < 3; ++i)
      mob[i] = m.qe_kb * m.z[i] / tsp[i] * D[i] * m.mobil_mult;
    // species gradients (perfect_mixture.py::mole_fraction_gradient) and
    // the diffusion velocities, ambipolar field and mass correction
    double dv[3][DIM];
    double mho = 0.0;
    for (int i = 0; i < 3; ++i) mho += mob[i] * nd[i] * m.z[i];
    double ambe[DIM];
    for (int d = 0; d < DIM; ++d) {
      const double gi = gt[IS * DIM + d];
      const double ge = gi * m.z[0];
      const double gb =
          (double(gt[d]) - gi * m.mw[0] - m.mw[1] * ge) / m.mw[2];
      const double gtot = gi + gb + ge;
      const double gn[3] = {gi, ge, gb};
      double amb = 0.0;
      for (int i = 0; i < 3; ++i) {
        const double gx = gn[i] / ntd - nd[i] / (ntd * ntd) * gtot;
        dv[i][d] = -D[i] * gx / (Xd[i] + m.xeps);
        amb += dv[i][d] * nd[i] * m.z[i];
      }
      ambe[d] = -amb / (mho + m.xeps);
    }
    T dvn[3] = {T(0), T(0), T(0)};
    for (int d = 0; d < DIM; ++d) {
      double vc = 0.0;
      for (int i = 0; i < 3; ++i) {
        dv[i][d] += mob[i] * ambe[d];
        vc += Yd[i] * dv[i][d];
      }
      for (int i = 0; i < 3; ++i) dvn[i] += T(dv[i][d] - vc) * n[d];
    }
    // stress (bulk viscosity 0: -2/3 mu), heat fluxes, diffusion
    T bulk = -T(2) / T(3) * mu;
    if (pt.on) {
      closure_step<T, DIM, AXI>(cl, pt, s.rho, s.vel, gt, mu, kap, bulk);
      kape *= pt.wgt;
      for (int i = 0; i < 3; ++i) dvn[i] *= pt.wgt;
    }
    T div = T(0);
    for (int d = 0; d < DIM; ++d) div += gt[(1 + d) * DIM + d];
    if constexpr (AXI) div += over_r(s.vel[0], r);
    T e = T(0);
    for (int i = 0; i < DIM; ++i) {
      T sn = T(0);
      for (int d = 0; d < DIM; ++d) {
        T tij = mu * (gt[(1 + i) * DIM + d] + gt[(1 + d) * DIM + i]);
        if (i == d) tij += bulk * div;
        sn += tij * n[d];
      }
      fv[1 + i] = sn;
      e += sn * s.vel[i];
    }
    if constexpr (AXI) {  // the swirl row and its work
      const T ut = s.vel[DIM];
      const T* gu = gt + (1 + DIM) * DIM;  // grad u_t
      const T st = mu * (gu[0] - over_r(ut, r)) * n[0] + mu * gu[1] * n[1];
      fv[1 + DIM] = st;
      e += ut * st;
    }
    T qt = T(0), qe = T(0);
    for (int d = 0; d < DIM; ++d) {
      qt += gt[IE * DIM + d] * n[d];
      qe += gt[IEE * DIM + d] * n[d];
    }
    const T h0 = s.n[0] * (T(m.cp[0]) * th + T(m.hf_ion));
    const T h1 = s.n[1] * (T(m.cp[1]) * te);
    const T h2 = s.n[2] * (T(m.cp[2]) * th);
    const T qen = kape * qe;
    fv[IE] = e + kap * qt + qen - (h0 * dvn[0] + h1 * dvn[1] + h2 * dvn[2]);
    fv[IS] = -clipped(u, IS) * dvn[0];
    fv[IEE] = qen - h1 * dvn[1];
  }
};

}  // namespace tps_dg
