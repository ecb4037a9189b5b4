// The face sweep (face_sweep.cuh) on the axisymmetric (r, z) LTE-table
// fluid with swirl (dg_lte.cuh::LteFluid<2, TD, true>, NEQ = 5): slot
// mode, 1-D or 2-D tables (the template's TD), Navier-Stokes with the
// table transport and Euler, f32 and f64.  Its own file so that nvcc
// builds it beside face_sweep.cu, whose C entry calls dispatch_lte_axi
// for physics PHYSICS_LTE when it is given the radii R (face_sweep_axi.cu
// says what R is).  The LTE fluid takes no closure step: cl must be off.

#include "dg_lte.cuh"
#include "face_sweep.cuh"

template <typename T>
int dispatch_lte_axi(const T* X, const T* B, const int* cf, const int* cp,
                     const int* nbr, const T* N, const T* M, const T* R, T* Y,
                     int ne, int ndof, int nqf, int nlf, int n_combo,
                     long long nor_lf, long long nor_e, double sign,
                     int viscous, const double* p, void* stream,
                     const FaceClosure<T>& cl) {
  if (cl.on || (p[0] != 1.0 && p[0] != 2.0))
    return (int)cudaErrorInvalidValue;
#define TPS_ARGS                                                         \
  X, B, cf, cp, nbr, N, M, Y, ne, ndof, nqf, nlf, n_combo, nor_lf, nor_e, \
      sign, p, stream, R
  using A1 = LteFluid<2, 1, true>;
  using A2 = LteFluid<2, 2, true>;
  if (p[0] == 1.0)
    return viscous ? launch<T, A1, true, false>(TPS_ARGS)
                   : launch<T, A1, false, false>(TPS_ARGS);
  return viscous ? launch<T, A2, true, false>(TPS_ARGS)
                 : launch<T, A2, false, false>(TPS_ARGS);
#undef TPS_ARGS
}

template int dispatch_lte_axi<float>(const float*, const float*, const int*,
                                     const int*, const int*, const float*,
                                     const float*, const float*, float*, int,
                                     int, int, int, int, long long, long long,
                                     double, int, const double*, void*,
                                     const FaceClosure<float>&);
template int dispatch_lte_axi<double>(const double*, const double*,
                                      const int*, const int*, const int*,
                                      const double*, const double*,
                                      const double*, double*, int, int, int,
                                      int, int, long long, long long, double,
                                      int, const double*, void*,
                                      const FaceClosure<double>&);
