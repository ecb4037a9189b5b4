// The face sweep (face_sweep.cuh) on the two-temperature ambipolar argon
// plasma (dg_mixture.cuh::ArgonMixture): slot mode, 2-D here and 3-D in
// face_sweep_argon3d.cu, Navier-Stokes with argon_minimal transport and
// Euler (the viscous template flag off: no transport), f32 and f64, with
// the viscous flux's closures cl.  Files of their own so that nvcc builds
// them beside face_sweep.cu, whose C entry calls dispatch_argon for
// physics PHYSICS_ARGON.

#include "dg_mixture.cuh"
#include "face_sweep.cuh"

// face_sweep_argon3d.cu: ArgonMixture<3>, the arguments of dispatch_argon
template <typename T>
int dispatch_argon3d(const T* X, const T* B, const int* cf, const int* cp,
                     const int* nbr, const T* N, const T* M, T* Y, int ne,
                     int ndof, int nqf, int nlf, int n_combo, long long nor_lf,
                     long long nor_e, double sign, int viscous,
                     const double* p, void* stream, const FaceClosure<T>& cl);

template <typename T>
int dispatch_argon(const T* X, const T* B, const int* cf, const int* cp,
                   const int* nbr, const T* N, const T* M, T* Y, int ne,
                   int ndof, int nqf, int nlf, int n_combo, long long nor_lf,
                   long long nor_e, double sign, int dim, int viscous,
                   const double* p, void* stream, const FaceClosure<T>& cl) {
  // the policy is the ambipolar two-temperature mixture (NEQ = DIM + 4)
  if (p[MIX_FLAGS] != 1.0 || p[MIX_FLAGS + 1] != 1.0)
    return (int)cudaErrorInvalidValue;
#define TPS_ARGS                                                         \
  X, B, cf, cp, nbr, N, M, Y, ne, ndof, nqf, nlf, n_combo, nor_lf, nor_e, \
      sign, p, stream, nullptr, cl
  if (dim == 2)
    return viscous ? launch<T, ArgonMixture<2>, true, false>(TPS_ARGS)
                   : launch<T, ArgonMixture<2>, false, false>(TPS_ARGS);
#undef TPS_ARGS
  if (dim == 3)
    return dispatch_argon3d<T>(X, B, cf, cp, nbr, N, M, Y, ne, ndof, nqf, nlf,
                               n_combo, nor_lf, nor_e, sign, viscous, p,
                               stream, cl);
  return (int)cudaErrorInvalidValue;
}

template int dispatch_argon<float>(const float*, const float*, const int*,
                                   const int*, const int*, const float*,
                                   const float*, float*, int, int, int, int,
                                   int, long long, long long, double, int,
                                   int, const double*, void*,
    const FaceClosure<float>&);
template int dispatch_argon<double>(const double*, const double*, const int*,
                                    const int*, const int*, const double*,
                                    const double*, double*, int, int, int,
                                    int, int, long long, long long, double,
                                    int, int, const double*, void*,
    const FaceClosure<double>&);
