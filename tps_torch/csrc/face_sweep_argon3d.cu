// The face sweep (face_sweep.cuh) on the two-temperature ambipolar argon
// plasma in 3-D (dg_mixture.cuh::ArgonMixture<3>, NEQ = 7): slot mode,
// Navier-Stokes with argon_minimal transport and Euler, f32 and f64, with
// the viscous flux's closures cl.  Its
// own file so that nvcc builds it beside face_sweep_argon.cu, whose
// dispatch_argon calls dispatch_argon3d for dim 3.

#include "dg_mixture.cuh"
#include "face_sweep.cuh"

template <typename T>
int dispatch_argon3d(const T* X, const T* B, const int* cf, const int* cp,
                     const int* nbr, const T* N, const T* M, T* Y, int ne,
                     int ndof, int nqf, int nlf, int n_combo, long long nor_lf,
                     long long nor_e, double sign, int viscous,
                     const double* p, void* stream, const FaceClosure<T>& cl) {
  return viscous ? launch<T, ArgonMixture<3>, true, false>(
                       X, B, cf, cp, nbr, N, M, Y, ne, ndof, nqf, nlf,
                       n_combo, nor_lf, nor_e, sign, p, stream, nullptr, cl)
                 : launch<T, ArgonMixture<3>, false, false>(
                       X, B, cf, cp, nbr, N, M, Y, ne, ndof, nqf, nlf,
                       n_combo, nor_lf, nor_e, sign, p, stream, nullptr, cl);
}

template int dispatch_argon3d<float>(const float*, const float*, const int*,
                                     const int*, const int*, const float*,
                                     const float*, float*, int, int, int, int,
                                     int, long long, long long, double, int,
                                     const double*, void*,
    const FaceClosure<float>&);
template int dispatch_argon3d<double>(const double*, const double*,
                                      const int*, const int*, const int*,
                                      const double*, const double*, double*,
                                      int, int, int, int, int, long long,
                                      long long, double, int, const double*,
                                      void*,
    const FaceClosure<double>&);
