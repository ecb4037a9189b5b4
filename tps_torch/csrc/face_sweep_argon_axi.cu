// The face sweep (face_sweep.cuh) on the axisymmetric (r, z) argon plasma
// with swirl (dg_mixture.cuh::ArgonMixture<2, true>, NEQ = 7): slot mode,
// Navier-Stokes with argon_minimal transport and Euler, f32 and f64.  Its
// own file so that nvcc builds it beside face_sweep.cu, whose C entry
// calls dispatch_argon_axi for physics PHYSICS_ARGON when it is given the
// radii R (face_sweep_axi.cu says what R is), with the closures cl.

#include "dg_mixture.cuh"
#include "face_sweep.cuh"

template <typename T>
int dispatch_argon_axi(const T* X, const T* B, const int* cf, const int* cp,
                       const int* nbr, const T* N, const T* M, const T* R,
                       T* Y, int ne, int ndof, int nqf, int nlf, int n_combo,
                       long long nor_lf, long long nor_e, double sign,
                       int viscous, const double* p, void* stream,
                       const FaceClosure<T>& cl) {
  // the policy is the ambipolar two-temperature mixture
  if (p[MIX_FLAGS] != 1.0 || p[MIX_FLAGS + 1] != 1.0)
    return (int)cudaErrorInvalidValue;
  using A = ArgonMixture<2, true>;
  return viscous ? launch<T, A, true, false>(X, B, cf, cp, nbr, N, M, Y, ne,
                                             ndof, nqf, nlf, n_combo, nor_lf,
                                             nor_e, sign, p, stream, R, cl)
                 : launch<T, A, false, false>(X, B, cf, cp, nbr, N, M, Y, ne,
                                              ndof, nqf, nlf, n_combo, nor_lf,
                                              nor_e, sign, p, stream, R, cl);
}

template int dispatch_argon_axi<float>(const float*, const float*, const int*,
                                       const int*, const int*, const float*,
                                       const float*, const float*, float*, int,
                                       int, int, int, int, long long,
                                       long long, double, int, const double*,
                                       void*,
    const FaceClosure<float>&);
template int dispatch_argon_axi<double>(const double*, const double*,
                                        const int*, const int*, const int*,
                                        const double*, const double*,
                                        const double*, double*, int, int, int,
                                        int, int, long long, long long, double,
                                        int, const double*, void*,
    const FaceClosure<double>&);
