// The face sweep (face_sweep.cuh) on the LTE-table fluid in 3-D
// (dg_lte.cuh::LteFluid<3, TD>, NEQ = 5): slot mode, 1-D or 2-D tables,
// Navier-Stokes and Euler, f32 and f64.  Its own file so that nvcc builds
// it beside face_sweep_lte.cu, whose dispatch_lte calls dispatch_lte3d for
// dim 3.

#include "dg_lte.cuh"
#include "face_sweep.cuh"

template <typename T>
int dispatch_lte3d(const T* X, const T* B, const int* cf, const int* cp,
                   const int* nbr, const T* N, const T* M, T* Y, int ne,
                   int ndof, int nqf, int nlf, int n_combo, long long nor_lf,
                   long long nor_e, double sign, int viscous, const double* p,
                   void* stream) {
  if (p[0] != 1.0 && p[0] != 2.0) return (int)cudaErrorInvalidValue;
#define TPS_ARGS                                                         \
  X, B, cf, cp, nbr, N, M, Y, ne, ndof, nqf, nlf, n_combo, nor_lf, nor_e, \
      sign, p, stream
  if (p[0] == 1.0)
    return viscous ? launch<T, LteFluid<3, 1>, true, false>(TPS_ARGS)
                   : launch<T, LteFluid<3, 1>, false, false>(TPS_ARGS);
  return viscous ? launch<T, LteFluid<3, 2>, true, false>(TPS_ARGS)
                 : launch<T, LteFluid<3, 2>, false, false>(TPS_ARGS);
#undef TPS_ARGS
}

template int dispatch_lte3d<float>(const float*, const float*, const int*,
                                   const int*, const int*, const float*,
                                   const float*, float*, int, int, int, int,
                                   int, long long, long long, double, int,
                                   const double*, void*);
template int dispatch_lte3d<double>(const double*, const double*, const int*,
                                    const int*, const int*, const double*,
                                    const double*, double*, int, int, int,
                                    int, int, long long, long long, double,
                                    int, const double*, void*);
