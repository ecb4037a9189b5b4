// The face sweep (face_sweep.cuh) on DryAir: prototype mode (3-D Euler)
// and slot mode (2-D and 3-D, Euler and Navier-Stokes), f32 and f64, and
// the kernel's shared-memory plan.  The argon plasma's instantiations are
// in face_sweep_argon.cu, reached through dispatch_argon.

#include "face_sweep.cuh"

// the `physics` argument of the C entries
constexpr int PHYSICS_DRY_AIR = 0;  // dg_pointwise.cuh::DryAirPhysics
constexpr int PHYSICS_ARGON = 1;    // dg_mixture.cuh::ArgonMixture

// face_sweep_argon.cu: slot mode, Navier-Stokes, 2-D; `p` as in
// dg_mixture.cuh::make_mix_phys (MIX_PHYS_LEN values)
template <typename T>
int dispatch_argon(const T* X, const T* B, const int* cf, const int* cp,
                   const int* nbr, const T* N, const T* M, T* Y, int ne,
                   int ndof, int nqf, int nlf, int n_combo, long long nor_lf,
                   long long nor_e, double sign, int dim, const double* p,
                   void* stream);

namespace {

template <typename T>
int dispatch(const T* X, const T* B, const int* cf, const int* cp,
             const int* nbr, const T* N, const T* M, T* Y, int ne, int ndof,
             int nqf, int nlf, int n_combo, long long nor_lf, long long nor_e,
             double sign, int dim, int viscous, int prototype, int physics,
             const double* p, void* stream) {
  if (physics == PHYSICS_ARGON) {
    if (!viscous || prototype) return (int)cudaErrorInvalidValue;
    return dispatch_argon<T>(X, B, cf, cp, nbr, N, M, Y, ne, ndof, nqf, nlf,
                             n_combo, nor_lf, nor_e, sign, dim, p, stream);
  }
  if (physics != PHYSICS_DRY_AIR) return (int)cudaErrorInvalidValue;
  using A2 = DryAirPhysics<2>;
  using A3 = DryAirPhysics<3>;
  if (prototype) {
    if (dim != 3 || viscous) return (int)cudaErrorInvalidValue;
    return launch<T, A3, false, true>(X, B, cf, cp, nbr, N, M, Y, ne, ndof,
                                      nqf, nlf, n_combo, nor_lf, nor_e, sign,
                                      p, stream);
  }
  if (dim == 2)
    return viscous ? launch<T, A2, true, false>(X, B, cf, cp, nbr, N, M, Y, ne,
                                                ndof, nqf, nlf, n_combo, nor_lf,
                                                nor_e, sign, p, stream)
                   : launch<T, A2, false, false>(X, B, cf, cp, nbr, N, M, Y,
                                                 ne, ndof, nqf, nlf, n_combo,
                                                 nor_lf, nor_e, sign, p,
                                                 stream);
  if (dim == 3)
    return viscous ? launch<T, A3, true, false>(X, B, cf, cp, nbr, N, M, Y, ne,
                                                ndof, nqf, nlf, n_combo, nor_lf,
                                                nor_e, sign, p, stream)
                   : launch<T, A3, false, false>(X, B, cf, cp, nbr, N, M, Y,
                                                 ne, ndof, nqf, nlf, n_combo,
                                                 nor_lf, nor_e, sign, p,
                                                 stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface for ctypes.  Normal of (lf, e, point s, d) at
// N[lf * nor_lf + e * nor_e + s * dim + d]; `mask` may be null (all
// slots interior); `physics` PHYSICS_DRY_AIR with `phys` as in
// dg_pointwise.cuh::make_phys, or PHYSICS_ARGON with `phys` as in
// dg_mixture.cuh::make_mix_phys.  Each returns the cudaError_t of its
// launch.
extern "C" {

int tps_face_sweep_f32(const float* X, const float* B, const int* cface,
                       const int* cperm, const int* nbr, const float* N,
                       const float* M, float* Y, int ne, int ndof, int nqf,
                       int nlf, int n_combo, long long nor_lf, long long nor_e,
                       double sign, int dim, int viscous, int prototype,
                       int physics, const double* phys, void* stream) {
  return dispatch<float>(X, B, cface, cperm, nbr, N, M, Y, ne, ndof, nqf, nlf,
                         n_combo, nor_lf, nor_e, sign, dim, viscous, prototype,
                         physics, phys, stream);
}

int tps_face_sweep_f64(const double* X, const double* B, const int* cface,
                       const int* cperm, const int* nbr, const double* N,
                       const double* M, double* Y, int ne, int ndof, int nqf,
                       int nlf, int n_combo, long long nor_lf, long long nor_e,
                       double sign, int dim, int viscous, int prototype,
                       int physics, const double* phys, void* stream) {
  return dispatch<double>(X, B, cface, cperm, nbr, N, M, Y, ne, ndof, nqf,
                          nlf, n_combo, nor_lf, nor_e, sign, dim, viscous,
                          prototype, physics, phys, stream);
}

// The launch's plan, no launch: dynamic shared bytes per block; *tile gets
// the elements per block (0: the shape does not fit).  k channels of X,
// neq equations, tsize bytes per value.
long long tps_face_sweep_smem(int ndof, int nqf, int nlf, int k, int neq,
                              int tsize, int* tile) {
  const Plan pl = face_plan(ndof, nqf, nlf, k, neq, (size_t)tsize);
  if (tile) *tile = pl.tile;
  return (long long)pl.smem;
}

}  // extern "C"
