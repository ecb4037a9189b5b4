// The face sweep (face_sweep.cuh) on DryAir with the Roe flux
// (dg_pointwise.cuh::DryAirPhysics<DIM, false, true>: roe_combine in
// place of Rusanov, the plain version dg/riemann.py::Roe): slot mode,
// planar 2-D and 3-D, Navier-Stokes with Sutherland or constant
// transport and Euler, with the viscous flux's closures cl, f32 and f64.
// Its own file so that nvcc builds it beside face_sweep.cu, whose C entry
// calls dispatch_dry_air_roe for physics PHYSICS_DRY_AIR_ROE.  Bound on
// this card: bytes, as the Rusanov sweep (the Roe waves add ~90
// operations a point).

#include "face_sweep.cuh"

template <typename T>
int dispatch_dry_air_roe(const T* X, const T* B, const int* cf, const int* cp,
                         const int* nbr, const T* N, const T* M, T* Y, int ne,
                         int ndof, int nqf, int nlf, int n_combo,
                         long long nor_lf, long long nor_e, double sign,
                         int dim, int viscous, const double* p, void* stream,
                         const FaceClosure<T>& cl) {
  using R2 = DryAirPhysics<2, false, true>;
  using R3 = DryAirPhysics<3, false, true>;
#define TPS_ARGS                                                         \
  X, B, cf, cp, nbr, N, M, Y, ne, ndof, nqf, nlf, n_combo, nor_lf, nor_e, \
      sign, p, stream, nullptr, cl
  if (dim == 2)
    return viscous ? launch<T, R2, true, false>(TPS_ARGS)
                   : launch<T, R2, false, false>(TPS_ARGS);
  if (dim == 3)
    return viscous ? launch<T, R3, true, false>(TPS_ARGS)
                   : launch<T, R3, false, false>(TPS_ARGS);
#undef TPS_ARGS
  return (int)cudaErrorInvalidValue;
}

template int dispatch_dry_air_roe<float>(const float*, const float*,
                                         const int*, const int*, const int*,
                                         const float*, const float*, float*,
                                         int, int, int, int, int, long long,
                                         long long, double, int, int,
                                         const double*, void*,
                                         const FaceClosure<float>&);
template int dispatch_dry_air_roe<double>(const double*, const double*,
                                          const int*, const int*, const int*,
                                          const double*, const double*,
                                          double*, int, int, int, int, int,
                                          long long, long long, double, int,
                                          int, const double*, void*,
                                          const FaceClosure<double>&);
