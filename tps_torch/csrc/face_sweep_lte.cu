// The face sweep (face_sweep.cuh) on the LTE-table fluid
// (dg_lte.cuh::LteFluid): slot mode, 2-D here and 3-D in
// face_sweep_lte3d.cu, 1-D or 2-D tables (the template's TD), Navier-Stokes
// with the table transport and Euler, f32 and f64.  Files of their own so
// that nvcc builds them beside face_sweep.cu, whose C entry calls
// dispatch_lte for physics PHYSICS_LTE.

#include "dg_lte.cuh"
#include "face_sweep.cuh"

// face_sweep_lte3d.cu: LteFluid<3, TD>, the arguments of dispatch_lte
template <typename T>
int dispatch_lte3d(const T* X, const T* B, const int* cf, const int* cp,
                   const int* nbr, const T* N, const T* M, T* Y, int ne,
                   int ndof, int nqf, int nlf, int n_combo, long long nor_lf,
                   long long nor_e, double sign, int viscous, const double* p,
                   void* stream);

template <typename T>
int dispatch_lte(const T* X, const T* B, const int* cf, const int* cp,
                 const int* nbr, const T* N, const T* M, T* Y, int ne,
                 int ndof, int nqf, int nlf, int n_combo, long long nor_lf,
                 long long nor_e, double sign, int dim, int viscous,
                 const double* p, void* stream) {
  if (dim == 3)
    return dispatch_lte3d<T>(X, B, cf, cp, nbr, N, M, Y, ne, ndof, nqf, nlf,
                             n_combo, nor_lf, nor_e, sign, viscous, p, stream);
  if (dim != 2 || (p[0] != 1.0 && p[0] != 2.0))
    return (int)cudaErrorInvalidValue;
#define TPS_ARGS                                                         \
  X, B, cf, cp, nbr, N, M, Y, ne, ndof, nqf, nlf, n_combo, nor_lf, nor_e, \
      sign, p, stream
  if (p[0] == 1.0)
    return viscous ? launch<T, LteFluid<2, 1>, true, false>(TPS_ARGS)
                   : launch<T, LteFluid<2, 1>, false, false>(TPS_ARGS);
  return viscous ? launch<T, LteFluid<2, 2>, true, false>(TPS_ARGS)
                 : launch<T, LteFluid<2, 2>, false, false>(TPS_ARGS);
#undef TPS_ARGS
}

template int dispatch_lte<float>(const float*, const float*, const int*,
                                 const int*, const int*, const float*,
                                 const float*, float*, int, int, int, int, int,
                                 long long, long long, double, int, int,
                                 const double*, void*);
template int dispatch_lte<double>(const double*, const double*, const int*,
                                  const int*, const int*, const double*,
                                  const double*, double*, int, int, int, int,
                                  int, long long, long long, double, int, int,
                                  const double*, void*);
