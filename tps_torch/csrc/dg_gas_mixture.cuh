// Pointwise physics of an N-species two-temperature ambipolar perfect
// mixture for the face stage (dg_face_stage.cuh), with two transports:
//
//   GasMixture<DIM, NS, false>: physics/gas_transport.py::
//     GasMixtureTransport, Chapman-Enskog transport from per-pair collision
//     integrals (screened Coulomb for charged pairs, the argon fits for the
//     others), the general third-order electron conductivity;
//   GasMixture<DIM, NS, true>: physics/gas_transport.py::
//     ConstantPlasmaTransport, constant viscosity, bulk viscosity,
//     conductivities and per-species diffusivities.
//
// Both with the ambipolar diffusion velocities, the mass correction and
// the species' enthalpy fluxes of dg/fluxes.py's mixture branch, as the
// JAX package computes them in XLA.  Species in mixture order: the NS - 2
// active ones (species 0 the ion that sets the Debye length), the
// electron (NS - 2) and the background (NS - 1).
//
// State: U = (rho, rho u_1..u_DIM, rho E, rho Y_0..rho Y_{NS-3}, rho e_e),
// NEQ = DIM + NS + 1.  Gradients of the primitives (rho, u, T_h, n_0..,
// T_e) are laid out g[eq * DIM + d].  The active species are clipped at 0
// as the plain face sweep clips its traces.
//
// Every constant comes packed from dg/cuda_faces.py::gas_mixture_phys in
// double, every product of per-molecule masses among them (the e-heavy
// reduced masses, ~9e-31 kg, and their products are formed on the host),
// so no mass is combined on the card.  The third-order electron
// conductivity forms l11 - l12 (l12 / l22), as dg_mixture.cuh does: l12^2
// would underflow in float.

#pragma once

#include <cuda_runtime.h>

#include "dg_mixture.cuh"

namespace tps_dg {

// pair kinds of GasPhys::kind (gas_transport.py's kinds)
constexpr int KIND_CLMB_ATT = 0, KIND_CLMB_REP = 1, KIND_AR_AR = 2,
              KIND_AR_AR1P = 3, KIND_AR_E = 4;

// Packed constants, in the order of dg/cuda_faces.py::gas_mixture_phys.
template <int NS>
struct GasPhys {
  double ns;  // NS, checked by the dispatch
  double mw[NS], z[NS], cv[NS], cp[NS], hf[NS];
  double rgas, tiny, xeps;
  // constant transport (ConstantPlasmaTransport)
  double visc, bulk, kappa, kappa_e, diff[NS];
  // collision-integral transport (GasMixtureTransport)
  double debye, ndim, pi;  // k eps0 / e^2 / N_A, 4 pi k eps0 / e^2, pi
  double vis[NS];          // VISCOSITY_FACTOR sqrt(m_s)
  double koe[NS];          // K_OVER_ETA_FACTOR / m_s
  double ke3, ke1;         // VF KOE sqrt(2 / m_e), VF KOE sqrt(1 / m_e)
  double dfac[NS][NS];     // DIFFUSIVITY_FACTOR / sqrt(reduced mass)
  double qe_kb;            // e / k
  double visc_mult, kappa_mult, kappa_e_mult, diff_mult, mobil_mult, third;
  double kind[NS][NS];     // KIND_* of each pair
  double att[8][4], rep[8][4];  // (c, a, b, p): (1, 1..5), (2, 2..4)
  double arar11[2], arar22[2], arar1p11[2];  // (A, b) of A T^b
  double ear[5][9];        // e-Ar (1, r), r = 1..5: log T powers -1..7
};

template <int NS>
constexpr int gas_phys_len() {
  return 1 + 5 * NS + 3 + 4 + NS + 3 + 2 * NS + 2 + NS * NS + 1 + 6 +
         NS * NS + 64 + 6 + 45;
}

template <int NS>
inline GasPhys<NS> make_gas_phys(const double* p) {
  static_assert(sizeof(GasPhys<NS>) == gas_phys_len<NS>() * sizeof(double),
                "GasPhys is a flat array of doubles");
  GasPhys<NS> m;
  double* dst = reinterpret_cast<double*>(&m);
  for (int i = 0; i < gas_phys_len<NS>(); ++i) dst[i] = p[i];
  return m;
}

template <int DIM_, int NS, bool CONST>
struct GasMixture {
  static constexpr int DIM = DIM_;
  static constexpr int NA = NS - 2;  // active species (ambipolar)
  static constexpr int NEQ = DIM + NS + 1;
  static constexpr int IE = DIM + 1, IS = DIM + 2, IEE = NEQ - 1;
  static constexpr int EL = NS - 2, BG = NS - 1;  // electron, background
  static constexpr int NW = 1;  // wave data per side: |u| + c
  static constexpr bool CLOSURES = false;  // no closure step
  using Params = GasPhys<NS>;

  static Params make(const double* p) { return make_gas_phys<NS>(p); }

  template <typename T>
  static __device__ __forceinline__ T clipped(const T* u, int q) {
    return (q >= IS && q < IS + NA) ? (u[q] > T(0) ? u[q] : T(0)) : u[q];
  }

  template <typename T>
  struct State {
    T rho, vel[DIM], v2, n[NS], th, te, p, pe, cheavy, nheavy;
  };

  // perfect_mixture.py: number densities, temperatures, pressure
  template <typename T>
  static __device__ __forceinline__ void state(const T* u, const Params& m,
                                               State<T>& s) {
    s.rho = u[0];
    T m2 = T(0);
#pragma unroll
    for (int d = 0; d < DIM; ++d) m2 += u[1 + d] * u[1 + d];
#pragma unroll
    for (int d = 0; d < DIM; ++d) s.vel[d] = u[1 + d] / s.rho;
    s.v2 = m2 / (s.rho * s.rho);
    T zn = T(0), rhoa = T(0);
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      s.n[i] = clipped(u, IS + i) / T(m.mw[i]);
      zn += s.n[i] * T(m.z[i]);
      rhoa += s.n[i] * T(m.mw[i]);
    }
    const T ne = zn > T(0) ? zn : T(0);
    s.n[EL] = ne;
    s.n[BG] = (s.rho - rhoa - ne * T(m.mw[EL])) / T(m.mw[BG]);
    T cheavy = T(0), nh = T(0), form = T(0);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      if (i == EL) continue;
      cheavy += s.n[i] * T(m.cv[i]);
      nh += s.n[i];
    }
#pragma unroll
    for (int i = 0; i < NS - 2; ++i) form += s.n[i] * T(m.hf[i]);
    s.cheavy = cheavy;
    s.nheavy = nh;
    const T ke = T(0.5) * m2 / s.rho;
    s.th = (u[IE] - form - ke - u[IEE]) / cheavy;
    s.te = u[IEE] / (ne > T(m.tiny) ? ne : T(m.tiny)) / T(m.cv[EL]);
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
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      un += n[d] * s.vel[d];
      mn += n[d] * u[1 + d];
    }
    f[0] = mn;
#pragma unroll
    for (int d = 0; d < DIM; ++d) f[1 + d] = u[1 + d] * un + n[d] * s.p;
    f[IE] = un * (u[IE] + s.p);
#pragma unroll
    for (int i = 0; i < NA; ++i) f[IS + i] = clipped(u, IS + i) * un;
    f[IEE] = (u[IEE] + s.pe) / s.rho * mn;
    const T gam = T(1) + s.nheavy * T(m.rgas) / s.cheavy;
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
#pragma unroll
    for (int d = 0; d < DIM; ++d) nmag2 += n[d] * n[d];
    const T lam = T(0.5) * sqrt(nmag2) * (w1[0] > w2[0] ? w1[0] : w2[0]);
#pragma unroll
    for (int q = 0; q < NEQ; ++q)
      f[q] = T(0.5) * (f1[q] + f2[q]) - lam * (clipped(u2, q) - clipped(u1, q));
  }

  // Every collision integral a pair of the argon kinds can ask for, each
  // evaluated once (GasMixtureTransport._omega: the Coulomb kinds at the
  // nondimensional temperature times the Debye circle dc, the others at
  // the pair's temperature, T_e where the electron takes part).  A pair's
  // Q^(l,r) is then a choice among these by its kind (`q_e1`, `q_h11`,
  // `q_h22`): the kinds are run-time constants, so the code holds each fit
  // once rather than once a pair.  The e-heavy (1, r) are held in
  // double: the e-Ar log T fits are evaluated in double (their terms
  // cancel ~5 digits), and they feed only the double parts of visc.
  template <typename T>
  struct Omegas {
    double e1[3][5];  // (1, r) of e-heavy pairs: attractive, repulsive, e-Ar
    T e2[3];          // (2, 2..4) of e-e (repulsive)
    T h11[4];    // (1, 1) of heavy pairs: att, rep, Ar-Ar, Ar-Ar+
    T h22[3];    // (2, 2) of a heavy with itself: att, rep, Ar-Ar
  };

  template <typename T>
  static __device__ __forceinline__ void omegas(const Params& m, T th,
                                                double lte, T nd_te, T nd_th,
                                                T dc, Omegas<T>& o) {
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      o.e1[0][r] = dc * screened(m.att[r], nd_te);
      o.e1[1][r] = dc * screened(m.rep[r], nd_te);
      o.e1[2][r] = log_t_fit(m.ear[r], lte);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) o.e2[r] = dc * screened(m.rep[5 + r], nd_te);
    o.h11[0] = dc * screened(m.att[0], nd_th);
    o.h11[1] = dc * screened(m.rep[0], nd_th);
    o.h11[2] = T(m.arar11[0]) * pow(th, T(m.arar11[1]));
    o.h11[3] = T(m.arar1p11[0]) * pow(th, T(m.arar1p11[1]));
    o.h22[0] = dc * screened(m.att[5], nd_th);
    o.h22[1] = dc * screened(m.rep[5], nd_th);
    o.h22[2] = T(m.arar22[0]) * pow(th, T(m.arar22[1]));
  }

  // Q^(1,r) of the electron with a heavy of pair kind k
  template <typename T>
  static __device__ __forceinline__ double q_e1(const Omegas<T>& o, int k,
                                                int r) {
    return k == KIND_CLMB_ATT   ? o.e1[0][r - 1]
           : k == KIND_CLMB_REP ? o.e1[1][r - 1]
                                : o.e1[2][r - 1];
  }

  // Q^(1,1) of two heavies of pair kind k
  template <typename T>
  static __device__ __forceinline__ T q_h11(const Omegas<T>& o, int k) {
    return k == KIND_CLMB_ATT   ? o.h11[0]
           : k == KIND_CLMB_REP ? o.h11[1]
           : k == KIND_AR_AR    ? o.h11[2]
                                : o.h11[3];
  }

  // Q^(2,2) of a heavy with itself, pair kind k
  template <typename T>
  static __device__ __forceinline__ T q_h22(const Omegas<T>& o, int k) {
    return k == KIND_CLMB_ATT   ? o.h22[0]
           : k == KIND_CLMB_REP ? o.h22[1]
                                : o.h22[2];
  }

  // The one-sided viscous normal flux of a traced state and its traced
  // gradient gt[eq * DIM + d] (fluxes.py::viscous with the transport's
  // flux_properties).  In T but for the parts that cancel most of float's
  // digits, which are formed in double whatever T, as the plain version
  // forms them (physics/gas_transport.py::_f64): the species fractions
  // (the background's 1 - Y), the e-Ar log T fits, the third-order
  // electron conductivity and the diffusion block (the ambipolar field
  // cancels the electron's drift against the ion's).  fv[0] is not
  // written.
  template <typename T>
  static __device__ __forceinline__ void visc(const T* u, const T* gt,
                                              const T* n, const Params& m,
                                              T* fv, const FacePoint<T>&,
                                              const Closure&) {
    State<T> s;
    state(u, m, s);
    const T th = s.th, te = s.te;
    // species in double (gas_transport.py::_species)
    double nd[NS], Xd[NS], Yd[NS];
    {
      double zn = 0.0, rhoa = 0.0;
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const double ua = u[IS + i] > T(0) ? double(u[IS + i]) : 0.0;
        nd[i] = ua / m.mw[i];
        zn += nd[i] * m.z[i];
        rhoa += nd[i] * m.mw[i];
      }
      nd[EL] = zn > 0.0 ? zn : 0.0;
      nd[BG] = (double(u[0]) - rhoa - nd[EL] * m.mw[EL]) / m.mw[BG];
    }
    double ntd = 0.0;
#pragma unroll
    for (int i = 0; i < NS; ++i) ntd += nd[i];
    T X[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      Xd[i] = nd[i] / ntd;
      Yd[i] = nd[i] * m.mw[i] / double(u[0]);
      X[i] = T(Xd[i]);
    }
    const T xeps = T(m.xeps);
    const double thd = th, ted = te;
    T mu, kap, kape, bulk;
    double D[NS], mob[NS];
    if constexpr (CONST) {
      mu = T(m.visc);
      kap = T(m.kappa);
      kape = T(m.kappa_e);
      bulk = T(m.bulk) - T(2) / T(3) * mu;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        D[i] = m.diff[i];
        mob[i] = m.qe_kb * m.z[i] / (i == EL ? ted : thd) * D[i];
      }
    } else {
      // collision inputs (gas_transport.py::_collision_inputs)
      const T n_over_t = (s.n[EL] + xeps) / te + (s.n[0] + xeps) / th;
      const T dl = sqrt(T(m.debye) / n_over_t);
      const T dc = T(m.pi) * dl * dl;
      const T nd_te = dl * T(m.ndim) * te, nd_th = dl * T(m.ndim) * th;
      const double lte = log(ted);
      const T sth = sqrt(th);
      Omegas<T> o;
      omegas(m, th, lte, nd_te, nd_th, dc, o);
      // binary diffusion of every pair, the Curtiss-Hirschfelder average
      // (in double)
      double denom[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) denom[i] = 0.0;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
#pragma unroll
        for (int j = i + 1; j < NS; ++j) {
          const int k = (int)m.kind[i][j];
          const bool e = i == EL || j == EL;
          const double q11 = e ? q_e1(o, k, 1) : double(q_h11(o, k));
          const double dij = m.dfac[i][j] * sqrt(e ? ted : thd) / ntd / q11;
          denom[i] += (Xd[j] + m.xeps) / dij;
          denom[j] += (Xd[i] + m.xeps) / dij;
        }
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        D[i] = (1.0 - Yd[i]) / denom[i] * m.diff_mult;
        mob[i] = m.qe_kb * m.z[i] / (i == EL ? ted : thd) * D[i] *
                 m.mobil_mult;
      }
      // viscosity and heavy conductivity (electron viscosity neglected)
      mu = T(0);
      kap = T(0);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        if (i == EL) continue;
        const T v = T(m.vis[i]) * sth / q_h22(o, (int)m.kind[i][i]);
        mu += X[i] * v;
        kap += X[i] * v * T(m.koe[i]);
      }
      mu *= T(m.visc_mult);
      kap *= T(m.kappa_mult);
      if (m.third != 0.0) {  // _third_order_ke_general, in double
        const double q22 = o.e2[0], q23 = o.e2[1], q24 = o.e2[2];
        const double s2 = 1.4142135623730951 * Xd[EL];
        double a11 = s2 * q22;
        double a12 = s2 * (1.75 * q22 - 2.0 * q23);
        double a22 = s2 * (4.8125 * q22 - 7.0 * q23 + 5.0 * q24);
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          if (i == EL) continue;
          const int k = (int)m.kind[EL][i];
          double q[5];
#pragma unroll
          for (int r = 0; r < 5; ++r) q[r] = q_e1(o, k, r + 1);
          a11 += Xd[i] * (6.25 * q[0] - 15.0 * q[1] + 12.0 * q[2]);
          a12 += Xd[i] * (10.9375 * q[0] - 39.375 * q[1] + 57.0 * q[2] -
                          30.0 * q[3]);
          a22 += Xd[i] * (19.140625 * q[0] - 91.875 * q[1] + 199.5 * q[2] -
                          210.0 * q[3] + 90.0 * q[4]);
        }
        kape = T(m.ke3 * sqrt(ted) * Xd[EL] / (a11 - a12 * (a12 / a22)));
      } else {
        kape = T(m.ke1) * sqrt(te) * X[EL] / o.e2[0];
      }
      kape *= T(m.kappa_e_mult);
      bulk = -T(2) / T(3) * mu;
    }
    // species gradients (perfect_mixture.py::mole_fraction_gradient), the
    // diffusion velocities, the ambipolar field and the mass correction,
    // in double
    double mho = 0.0;
#pragma unroll
    for (int i = 0; i < NS; ++i) mho += mob[i] * nd[i] * m.z[i];
    T dvn[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) dvn[i] = T(0);
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      double gn[NS];
      double ge = 0.0, gsum = 0.0, gm = 0.0;
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        gn[i] = gt[(IS + i) * DIM + d];
        ge += gn[i] * m.z[i];
        gsum += gn[i];
        gm += gn[i] * m.mw[i];
      }
      gn[EL] = ge;
      gn[BG] = (double(gt[d]) - gm - m.mw[EL] * ge) / m.mw[BG];
      const double gtot = gsum + gn[BG] + ge;
      double dv[NS];
      double amb = 0.0;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const double gx = gn[i] / ntd - nd[i] / (ntd * ntd) * gtot;
        dv[i] = -D[i] * gx / (Xd[i] + m.xeps);
        amb += dv[i] * nd[i] * m.z[i];
      }
      const double ambe = -amb / (mho + m.xeps);
      double vc = 0.0;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        dv[i] += mob[i] * ambe;
        vc += Yd[i] * dv[i];
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) dvn[i] += T(dv[i] - vc) * n[d];
    }
    // stress, heat fluxes, diffusion and the enthalpy it carries
    T div = T(0);
#pragma unroll
    for (int d = 0; d < DIM; ++d) div += gt[(1 + d) * DIM + d];
    T e = T(0);
#pragma unroll
    for (int i = 0; i < DIM; ++i) {
      T sn = T(0);
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        T tij = mu * (gt[(1 + i) * DIM + d] + gt[(1 + d) * DIM + i]);
        if (i == d) tij += bulk * div;
        sn += tij * n[d];
      }
      fv[1 + i] = sn;
      e += sn * s.vel[i];
    }
    T qt = T(0), qe = T(0);
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      qt += gt[IE * DIM + d] * n[d];
      qe += gt[IEE * DIM + d] * n[d];
    }
    T hflux = T(0), he = T(0);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const T h = s.n[i] * (T(m.cp[i]) * (i == EL ? te : th) + T(m.hf[i]));
      hflux += h * dvn[i];
      if (i == EL) he = h;
    }
    const T qen = kape * qe;
    fv[IE] = e + kap * qt + qen - hflux;
#pragma unroll
    for (int i = 0; i < NA; ++i) fv[IS + i] = -clipped(u, IS + i) * dvn[i];
    fv[IEE] = qen - he * dvn[EL];
  }
};

}  // namespace tps_dg
