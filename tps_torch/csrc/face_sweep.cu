// The face sweep (face_sweep.cuh) on DryAir: prototype mode (3-D Euler)
// and slot mode (2-D and 3-D, Euler and Navier-Stokes, with the viscous
// flux's closures), f32 and f64, and the kernel's shared-memory plan.
// The mixtures' instantiations are in face_sweep_argon.cu,
// face_sweep_argon_const.cu and face_sweep_gas_mixture.cu, the LTE
// fluid's in face_sweep_lte.cu and face_sweep_lte3d.cu, the axisymmetric
// policies' in face_sweep_axi.cu (DryAir), face_sweep_argon_axi.cu and
// face_sweep_lte_axi.cu,
// and DryAir's Roe form in face_sweep_roe.cu (each its own nvcc
// process), reached through their dispatch functions.

#include "face_sweep.cuh"

// the `physics` argument of the C entries (dg/cuda_faces.py::PHYSICS_ID)
constexpr int PHYSICS_DRY_AIR = 0;      // dg_pointwise.cuh::DryAirPhysics
constexpr int PHYSICS_ARGON = 1;        // dg_mixture.cuh::ArgonMixture
constexpr int PHYSICS_ARGON_CONST = 2;  // GasMixture<2, 3, true>
constexpr int PHYSICS_GAS_MIXTURE = 3;  // GasMixture<2, 6, false>
constexpr int PHYSICS_LTE = 4;          // dg_lte.cuh::LteFluid
constexpr int PHYSICS_DRY_AIR_ROE = 5;  // DryAirPhysics<DIM, false, true>

// slot mode; `p` as in dg_gas_mixture.cuh::make_gas_phys (2-D
// Navier-Stokes) or dg_lte.cuh::make_lte_phys (the LTE fluid: 2-D and
// 3-D, Navier-Stokes and Euler)
#define TPS_DISPATCH(name)                                                  \
  template <typename T>                                                     \
  int name(const T* X, const T* B, const int* cf, const int* cp,            \
           const int* nbr, const T* N, const T* M, T* Y, int ne, int ndof,  \
           int nqf, int nlf, int n_combo, long long nor_lf, long long nor_e, \
           double sign, int dim, int viscous, const double* p, void* stream);
TPS_DISPATCH(dispatch_argon_const)
TPS_DISPATCH(dispatch_gas_mixture)
TPS_DISPATCH(dispatch_lte)
#undef TPS_DISPATCH

// slot mode, the policies that take the closures cl: the argon ternary
// (`p` as dg_mixture.cuh::make_mix_phys; 2-D and 3-D, Navier-Stokes and
// Euler) and DryAir's Roe form (`p` as dg_pointwise.cuh::make_phys; 2-D
// and 3-D, Navier-Stokes and Euler, face_sweep_roe.cu)
#define TPS_DISPATCH_CL(name)                                               \
  template <typename T>                                                     \
  int name(const T* X, const T* B, const int* cf, const int* cp,            \
           const int* nbr, const T* N, const T* M, T* Y, int ne, int ndof,  \
           int nqf, int nlf, int n_combo, long long nor_lf, long long nor_e, \
           double sign, int dim, int viscous, const double* p, void* stream, \
           const FaceClosure<T>& cl);
TPS_DISPATCH_CL(dispatch_argon)
TPS_DISPATCH_CL(dispatch_dry_air_roe)
#undef TPS_DISPATCH_CL

// slot mode, 2-D, the axisymmetric (r, z) policies with swirl (NVEL = 3),
// R the slot points' radii [ne][nlf][nqf]: DryAirPhysics<2, true> (`p` as
// dg_pointwise.cuh::make_phys), ArgonMixture<2, true> (`p` as
// dg_mixture.cuh::make_mix_phys) and LteFluid<2, TD, true> (`p` as
// dg_lte.cuh::make_lte_phys; no closures), Navier-Stokes and Euler, with
// the closures cl
#define TPS_DISPATCH_AXI(name)                                              \
  template <typename T>                                                     \
  int name(const T* X, const T* B, const int* cf, const int* cp,            \
           const int* nbr, const T* N, const T* M, const T* R, T* Y, int ne, \
           int ndof, int nqf, int nlf, int n_combo, long long nor_lf,       \
           long long nor_e, double sign, int viscous, const double* p,      \
           void* stream, const FaceClosure<T>& cl);
TPS_DISPATCH_AXI(dispatch_dry_air_axi)
TPS_DISPATCH_AXI(dispatch_argon_axi)
TPS_DISPATCH_AXI(dispatch_lte_axi)
#undef TPS_DISPATCH_AXI

namespace {

template <typename T>
int dispatch(const T* X, const T* B, const int* cf, const int* cp,
             const int* nbr, const T* N, const T* M, const T* R, T* Y, int ne,
             int ndof, int nqf, int nlf, int n_combo, long long nor_lf,
             long long nor_e, double sign, int dim, int viscous, int prototype,
             int physics, const double* p, const FaceClosure<T>& cl,
             void* stream) {
  if (prototype && (R != nullptr || cl.on)) return (int)cudaErrorInvalidValue;
  if (R != nullptr) {
    auto fn = physics == PHYSICS_DRY_AIR ? dispatch_dry_air_axi<T>
              : physics == PHYSICS_ARGON ? dispatch_argon_axi<T>
              : physics == PHYSICS_LTE   ? dispatch_lte_axi<T>
                                         : nullptr;
    if (fn == nullptr || dim != 2) return (int)cudaErrorInvalidValue;
    return fn(X, B, cf, cp, nbr, N, M, R, Y, ne, ndof, nqf, nlf, n_combo,
              nor_lf, nor_e, sign, viscous, p, stream, cl);
  }
  if (physics == PHYSICS_ARGON || physics == PHYSICS_DRY_AIR_ROE) {
    auto fn = physics == PHYSICS_ARGON ? dispatch_argon<T>
                                       : dispatch_dry_air_roe<T>;
    if (prototype) return (int)cudaErrorInvalidValue;
    return fn(X, B, cf, cp, nbr, N, M, Y, ne, ndof, nqf, nlf, n_combo, nor_lf,
              nor_e, sign, dim, viscous, p, stream, cl);
  }
  if (physics != PHYSICS_DRY_AIR) {
    auto fn = physics == PHYSICS_ARGON_CONST   ? dispatch_argon_const<T>
              : physics == PHYSICS_GAS_MIXTURE ? dispatch_gas_mixture<T>
              : physics == PHYSICS_LTE         ? dispatch_lte<T>
                                               : nullptr;
    if (fn == nullptr || prototype || cl.on) return (int)cudaErrorInvalidValue;
    return fn(X, B, cf, cp, nbr, N, M, Y, ne, ndof, nqf, nlf, n_combo, nor_lf,
              nor_e, sign, dim, viscous, p, stream);
  }
  using A2 = DryAirPhysics<2>;
  using A3 = DryAirPhysics<3>;
  if (prototype) {
    if (dim != 3 || viscous) return (int)cudaErrorInvalidValue;
    return launch<T, A3, false, true>(X, B, cf, cp, nbr, N, M, Y, ne, ndof,
                                      nqf, nlf, n_combo, nor_lf, nor_e, sign,
                                      p, stream);
  }
#define TPS_ARGS                                                         \
  X, B, cf, cp, nbr, N, M, Y, ne, ndof, nqf, nlf, n_combo, nor_lf, nor_e, \
      sign, p, stream, nullptr, cl
  if (dim == 2)
    return viscous ? launch<T, A2, true, false>(TPS_ARGS)
                   : launch<T, A2, false, false>(TPS_ARGS);
  if (dim == 3)
    return viscous ? launch<T, A3, true, false>(TPS_ARGS)
                   : launch<T, A3, false, false>(TPS_ARGS);
#undef TPS_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface for ctypes.  Normal of (lf, e, point s, d) at
// N[lf * nor_lf + e * nor_e + s * dim + d]; `mask` may be null (all
// slots interior); `R`, the slot points' radii [ne][nlf][nqf], is null
// on planar tables and selects the axisymmetric policies (slot mode, 2-D,
// PHYSICS_DRY_AIR, PHYSICS_ARGON or PHYSICS_LTE) when given.  `closure` (7 doubles,
// dg_pointwise.cuh::make_closure) is null where the viscous flux has no
// closure; where given (slot mode, PHYSICS_DRY_AIR, PHYSICS_DRY_AIR_ROE
// or PHYSICS_ARGON), D [ne] and Dn [ne][nlf] are the element length
// scales (null without an SGS model), W and Dist [ne][nlf][nqf] the
// sponge weights and the wall distances (each null where off).
// `physics` PHYSICS_DRY_AIR or PHYSICS_DRY_AIR_ROE with `phys` as in
// dg_pointwise.cuh::make_phys, PHYSICS_ARGON with `phys` as in
// dg_mixture.cuh::make_mix_phys, PHYSICS_ARGON_CONST /
// PHYSICS_GAS_MIXTURE with `phys` as in dg_gas_mixture.cuh::make_gas_phys,
// or PHYSICS_LTE with `phys` as in dg_lte.cuh::make_lte_phys.
// Each returns the cudaError_t of its launch.
extern "C" {

int tps_face_sweep_f32(const float* X, const float* B, const int* cface,
                       const int* cperm, const int* nbr, const float* N,
                       const float* M, const float* R, const float* D,
                       const float* Dn, const float* W, const float* Dist,
                       float* Y, int ne, int ndof, int nqf, int nlf,
                       int n_combo, long long nor_lf, long long nor_e,
                       double sign, int dim, int viscous, int prototype,
                       int physics, const double* phys,
                       const double* closure, void* stream) {
  const FaceClosure<float> cl = {closure != nullptr, make_closure(closure),
                                  D, Dn, W, Dist};
  return dispatch<float>(X, B, cface, cperm, nbr, N, M, R, Y, ne, ndof,
                         nqf, nlf, n_combo, nor_lf, nor_e, sign, dim, viscous,
                         prototype, physics, phys, cl, stream);
}

int tps_face_sweep_f64(const double* X, const double* B, const int* cface,
                       const int* cperm, const int* nbr, const double* N,
                       const double* M, const double* R, const double* D,
                       const double* Dn, const double* W, const double* Dist,
                       double* Y, int ne, int ndof, int nqf, int nlf,
                       int n_combo, long long nor_lf, long long nor_e,
                       double sign, int dim, int viscous, int prototype,
                       int physics, const double* phys,
                       const double* closure, void* stream) {
  const FaceClosure<double> cl = {closure != nullptr, make_closure(closure),
                                  D, Dn, W, Dist};
  return dispatch<double>(X, B, cface, cperm, nbr, N, M, R, Y, ne, ndof,
                         nqf, nlf, n_combo, nor_lf, nor_e, sign, dim, viscous,
                         prototype, physics, phys, cl, stream);
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
