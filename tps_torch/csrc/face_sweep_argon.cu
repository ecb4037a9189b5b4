// The face sweep (face_sweep.cuh) on the two-temperature ambipolar argon
// plasma (dg_mixture.cuh::ArgonMixture): slot mode, Navier-Stokes, 2-D,
// f32 and f64.  Its own file so that nvcc builds it beside face_sweep.cu,
// whose C entry calls dispatch_argon for physics PHYSICS_ARGON.

#include "dg_mixture.cuh"
#include "face_sweep.cuh"

template <typename T>
int dispatch_argon(const T* X, const T* B, const int* cf, const int* cp,
                   const int* nbr, const T* N, const T* M, T* Y, int ne,
                   int ndof, int nqf, int nlf, int n_combo, long long nor_lf,
                   long long nor_e, double sign, int dim, const double* p,
                   void* stream) {
  // the policy is the ambipolar two-temperature mixture (NEQ = DIM + 4)
  if (dim != 2 || p[MIX_FLAGS] != 1.0 || p[MIX_FLAGS + 1] != 1.0)
    return (int)cudaErrorInvalidValue;
  return launch<T, ArgonMixture<2>, true, false>(
      X, B, cf, cp, nbr, N, M, Y, ne, ndof, nqf, nlf, n_combo, nor_lf, nor_e,
      sign, p, stream);
}

template int dispatch_argon<float>(const float*, const float*, const int*,
                                   const int*, const int*, const float*,
                                   const float*, float*, int, int, int, int,
                                   int, long long, long long, double, int,
                                   const double*, void*);
template int dispatch_argon<double>(const double*, const double*, const int*,
                                    const int*, const int*, const double*,
                                    const double*, double*, int, int, int,
                                    int, int, long long, long long, double,
                                    int, const double*, void*);
