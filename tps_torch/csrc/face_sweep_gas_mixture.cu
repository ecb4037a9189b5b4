// The face sweep (face_sweep.cuh) on the N-species two-temperature
// ambipolar perfect mixture with collision-integral transport
// (dg_gas_mixture.cuh::GasMixture, physics/gas_transport.py::
// GasMixtureTransport), instantiated for the six-species argon of
// tests/inputs/argon_full.ini (Ar+, Ar_m, Ar_r, Ar_p, e, Ar; four active,
// NEQ = 9 in 2-D): slot mode, 2-D, Navier-Stokes, f32 and f64.  Its own
// file so that nvcc builds it beside the others; face_sweep.cu's C entry
// calls dispatch_gas_mixture for physics PHYSICS_GAS_MIXTURE.

#include "dg_gas_mixture.cuh"
#include "face_sweep.cuh"

template <typename T>
int dispatch_gas_mixture(const T* X, const T* B, const int* cf, const int* cp,
                         const int* nbr, const T* N, const T* M, T* Y, int ne,
                         int ndof, int nqf, int nlf, int n_combo,
                         long long nor_lf, long long nor_e, double sign,
                         int dim, int viscous, const double* p,
                         void* stream) {
  if (dim != 2 || !viscous || p[0] != 6.0) return (int)cudaErrorInvalidValue;
  return launch<T, GasMixture<2, 6, false>, true, false>(
      X, B, cf, cp, nbr, N, M, Y, ne, ndof, nqf, nlf, n_combo, nor_lf, nor_e,
      sign, p, stream);
}

template int dispatch_gas_mixture<float>(const float*, const float*,
                                         const int*, const int*, const int*,
                                         const float*, const float*, float*,
                                         int, int, int, int, int, long long,
                                         long long, double, int, int,
                                         const double*, void*);
template int dispatch_gas_mixture<double>(const double*, const double*,
                                          const int*, const int*, const int*,
                                          const double*, const double*,
                                          double*, int, int, int, int, int,
                                          long long, long long, double, int,
                                          int, const double*, void*);
