// The face sweep (face_sweep.cuh) on the two-temperature ambipolar ternary
// argon mixture with constant transport (dg_gas_mixture.cuh::GasMixture
// with ConstantPlasmaTransport's coefficients): slot mode, 2-D,
// Navier-Stokes, f32 and f64.  Its own file so that nvcc builds it beside
// the others; face_sweep.cu's C entry calls dispatch_argon_const for
// physics PHYSICS_ARGON_CONST.

#include "dg_gas_mixture.cuh"
#include "face_sweep.cuh"

template <typename T>
int dispatch_argon_const(const T* X, const T* B, const int* cf, const int* cp,
                         const int* nbr, const T* N, const T* M, T* Y, int ne,
                         int ndof, int nqf, int nlf, int n_combo,
                         long long nor_lf, long long nor_e, double sign,
                         int dim, int viscous, const double* p,
                         void* stream) {
  if (dim != 2 || !viscous || p[0] != 3.0) return (int)cudaErrorInvalidValue;
  return launch<T, GasMixture<2, 3, true>, true, false>(
      X, B, cf, cp, nbr, N, M, Y, ne, ndof, nqf, nlf, n_combo, nor_lf, nor_e,
      sign, p, stream);
}

template int dispatch_argon_const<float>(const float*, const float*,
                                         const int*, const int*, const int*,
                                         const float*, const float*, float*,
                                         int, int, int, int, int, long long,
                                         long long, double, int, int,
                                         const double*, void*);
template int dispatch_argon_const<double>(const double*, const double*,
                                          const int*, const int*, const int*,
                                          const double*, const double*,
                                          double*, int, int, int, int, int,
                                          long long, long long, double, int,
                                          int, const double*, void*);
