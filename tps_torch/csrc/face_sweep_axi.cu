// The face sweep (face_sweep.cuh) on the axisymmetric (r, z) state with
// swirl: slot mode, 2-D, NVEL = 3, f32 and f64.  DryAir here
// (dg_pointwise.cuh::DryAirPhysics<2, true>, NEQ = 5, Navier-Stokes with
// Sutherland or constant transport and Euler), the argon ternary in
// face_sweep_argon_axi.cu.  Files of their own so that nvcc builds them
// beside face_sweep.cu, whose C entry calls dispatch_dry_air_axi for
// physics PHYSICS_DRY_AIR when it is given the radii R.
// The plain version is dg/operators.py::face_sweep_plain with the
// axisymmetric Fluxes of dg/fluxes.py (the JAX package's dg/rhs.py:143-178
// on axisymmetric tables: nor_wpf with r w folded in, the viscous flux at
// the slot point's radius).
//
// R [ne][nlf][nqf] is the radius of every slot point (xyz_slot[..., 0]).
// Both sides of a face share the point, so the own slot's radius serves
// both one-sided viscous fluxes.  Each 1/r term is a branch
// (r > 0 ? v / r : 0); face points on the axis carry zero weight in the
// normals.  Bound on this card: bytes, as the planar sweep (X has K =
// NEQ (1 + DIM) = 15 channels for DryAir, 21 for argon; R adds nlf nqf
// values an element).  cl: the viscous flux's closures (face_sweep.cuh),
// off where cl.on is false.

#include "face_sweep.cuh"

template <typename T>
int dispatch_dry_air_axi(const T* X, const T* B, const int* cf, const int* cp,
                         const int* nbr, const T* N, const T* M, const T* R,
                         T* Y, int ne, int ndof, int nqf, int nlf, int n_combo,
                         long long nor_lf, long long nor_e, double sign,
                         int viscous, const double* p, void* stream,
                         const FaceClosure<T>& cl) {
  using A = DryAirPhysics<2, true>;
  return viscous ? launch<T, A, true, false>(X, B, cf, cp, nbr, N, M, Y, ne,
                                             ndof, nqf, nlf, n_combo, nor_lf,
                                             nor_e, sign, p, stream, R, cl)
                 : launch<T, A, false, false>(X, B, cf, cp, nbr, N, M, Y, ne,
                                              ndof, nqf, nlf, n_combo, nor_lf,
                                              nor_e, sign, p, stream, R, cl);
}

template int dispatch_dry_air_axi<float>(const float*, const float*,
                                         const int*, const int*, const int*,
                                         const float*, const float*,
                                         const float*, float*, int, int, int,
                                         int, int, long long, long long,
                                         double, int, const double*, void*,
    const FaceClosure<float>&);
template int dispatch_dry_air_axi<double>(const double*, const double*,
                                          const int*, const int*, const int*,
                                          const double*, const double*,
                                          const double*, double*, int, int,
                                          int, int, int, long long, long long,
                                          double, int, const double*, void*,
    const FaceClosure<double>&);
