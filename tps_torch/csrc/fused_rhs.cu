// Hopper kernels for the fused periodic-box DG right-hand side (DryAir,
// 3-D, Euler or Navier-Stokes, Rusanov): K1 (DG gradient of the
// primitives) and K2 (volume flux + six face fluxes + folded inverse-mass
// scatter).  They replace the two Pallas TPU kernels of the JAX package,
// dg/pallas_fused.py: k1_kernel and k2_kernel.
//
// What each computes is the TPU kernels' algebra on the same folded
// matrices (dg/cuda_fused.py builds them from the DG tables):
//   K1: G = M_self . Up + sum_lf M_lf . Up(neighbor lf)
//       Up = (rho, u, v, w, T) at each dof; M_* are [3*ndof, ndof].
//   K2: y = sum_dd V_dd . (Fconv - Fvisc)[dd]
//         + sum_lf W_lf . flux_lf(traces of U and G through Btr),
//       flux = Rusanov (dissipation scaled by |n|) minus the mean of the
//       two one-sided viscous normal fluxes (equations 1..4 only).
//
// Layout: element-major, the solver's own [ne, ndof, neq] state and a
// [ne, ndof, neq, dim] gradient, so no layout conversion sits between the
// solver and the kernels.  Elements form a C-order (nz, ny, nx) periodic
// grid; the neighbor across local face lf sits `step[lf]` cells along
// `axis[lf]` (step = -shift of the tables' roll_info), with wrap-around.
//
// Bound on this card: bytes, for both (K1: U in, G out; K2: U and G in, y
// out).  The least work at 16^3 p=2 takes 0.4 (K1) and ~1.0 (K2) of the
// bytes' time, counted sum-factorised; the dense folds do ~10x more.
//
// K1 replaces k1_kernel.  It is bound by U in and G out; its design keeps
// the work per byte small and every byte moved once:
// - Compressed folds.  On the collocated GL basis of an axis-aligned box
//   a row (dd, j) of the folds touches only the nodes on the line through
//   j along dd: n1 - 1 of the element's, n1 of each of the two neighbours
//   across the faces normal to dd (8 of 189 columns at p=2); every other
//   entry of the dense folds is rounding noise of the folding (<= 1.1e-14
//   of its fold's largest entry for p <= 4; the smallest kept one is >=
//   2.4e-3).  dg/cuda_fused.py::gradient_groups keeps the entries above
//   1e-12 of their fold's largest and groups the rows that share their
//   columns (a line: n1 rows, 3*n1 columns), so a thread loads each
//   column's state once for R = n1 rows (one row a group is slower on
//   the card: tps_torch/tools/k1_layouts.py).  Dense folds (another mesh) keep everything in
//   the same format: correct, only slower.
// - Centred columns.  The dropped entries are small against their fold,
//   but they multiply T ~ 300 where G is ~1e2: left out of a sum over
//   absolute primitives they would move G by ~1e-12 of max|G| at 32^3 p=2
//   (more on finer grids: the folds scale with 1/h).  So every column
//   enters less the element's node-0 primitives.  The folds annihilate
//   constants (the DG gradient of a constant is 0), so the sum is the
//   same in exact arithmetic, and the dropped entries multiply only the
//   field's variation.
// - Tiles.  A block owns E consecutive elements (`k1_plan`: up to 8, along
//   x): a neighbour inside the tile is read where it is, the others are
//   staged once per (face, element).  A warp loads a staged row, a lane
//   per node, four rows' loads in flight together, and writes the node's
//   primitives to shared memory: each staged node is converted once, in
//   the pass that loads it.  The folds go to shared memory by cp.async
//   when they fit.
// - One thread per (element, group), element fastest: the lanes of a warp
//   share a group's columns and values (broadcast loads) and R x NEQ sums
//   in registers (3 x 5 at p=2 over 9 columns; 3,645 FMA per element
//   against 76,545 dense).
// - The tile's G is staged in its own order and written as one span with
//   16-byte stores.
// - No tensor cores: after compression K1 does ~0.45 us of f32 FMA at 16^3,
//   a sixth of its bytes' time, in products of 9 columns.  It stays its own
//   kernel: K2 needs the neighbours' G, a grid-wide barrier away.
//
// K2: the face stage of dg_face_stage.cuh, shared with face_sweep.cu.  A
// block owns a tile of E elements (`k2_plan`).  V, Btr and W are copied
// into shared memory once per block by cp.async (read from global where
// they do not fit beside a tile, p >= 3); so are the tile's U and G and, for
// each face, the tile's neighbors' U and G, the next face's copy in
// flight while the current face is computed.  The volume flux runs one
// thread per node of the tile, the face flux one per face point of the
// tile, the products register-blocked.
//
// The pointwise physics (primitives, Sutherland, fluxes, Rusanov) is in
// dg_pointwise.cuh, shared with face_sweep.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dg_face_stage.cuh"

namespace {

using namespace tps_dg;

constexpr int NEQ = 5;   // rho, rho u, rho v, rho w, rho E
constexpr int DIM = 3;
constexpr int NLF = 6;
constexpr int K1_ROWS = 8;  // rows of a group of K1's folds at most
constexpr int LB = 4;       // K1: staged rows a warp loads at a time

struct Geo {
  int nz, ny, nx;
  int axis[NLF];
  int step[NLF];
  int opp[NLF];
};

__device__ __forceinline__ int neighbor(int e, int lf, const Geo& g) {
  int c[3];
  c[2] = e % g.nx;
  c[1] = (e / g.nx) % g.ny;
  c[0] = e / (g.nx * g.ny);
  const int n[3] = {g.nz, g.ny, g.nx};
  const int a = g.axis[lf];
  c[a] = ((c[a] + g.step[lf]) % n[a] + n[a]) % n[a];
  return (c[0] * g.ny + c[1]) * g.nx + c[2];
}

// ---------------------------------------------------------------- K1

// n values from shared src to global dst, src at dst's 16-byte phase
// (src - row_phase(dst) is 16-byte aligned), by all threads of the block:
// the whole 16-byte chunks inside [dst, dst + n) one store each, the ends
// one value per store.
template <typename T>
__device__ __forceinline__ void store_span(T* dst, const T* src, int n) {
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x, nthr = blockDim.x;
  int head = (V - row_phase(dst)) % V;
  head = head < n ? head : n;
  const int nv = (n - head) / V;
  for (int i = tid; i < head; i += nthr) dst[i] = src[i];
  for (int c = tid; c < nv; c += nthr)
    *reinterpret_cast<uint4*>(dst + head + c * V) =
        *reinterpret_cast<const uint4*>(src + head + c * V);
  for (int i = head + nv * V + tid; i < n; i += nthr) dst[i] = src[i];
}

// Shared memory of a block of E elements (values, regions 16-byte
// aligned): the compressed folds if resident (columns as ints, then the
// values); the staged rows [1 + NLF][E][ndof][NEQ] as primitives (the
// tile's own, then one per (face, element)); the tile's G
// [E][ndof][NEQ][DIM] at the 16-byte phase of its place in G.
Plan k1_plan(int ndof, int ngroup, int ncol, int nrow, size_t ts) {
  const size_t nu = (size_t)ndof * NEQ, nc = (size_t)ngroup * ncol;
  auto bytes = [=](int E, int res) {
    size_t v = res ? al4((nc * sizeof(int) + ts - 1) / ts) + al4(nc * nrow)
                   : 0;
    v += al4((1 + NLF) * E * nu) + al4(E * nu * DIM) + 4;
    return v * ts;
  };
  return make_plan(bytes);
}

// R: rows per group (the register block); RES: the folds resident in
// shared memory (else read through the cache).
template <typename T, int R, bool RES>
__global__ void __launch_bounds__(THREADS_MAX)
k1_gradient(const T* __restrict__ U,
            const int* __restrict__ Rows,  // [ngroup][R]: dd*ndof + j; -1
            const int* __restrict__ Cols,  // [ngroup][ncol]: slot << 16 | k
            const T* __restrict__ Vals,    // [ngroup][ncol][R]
            T* __restrict__ G, int ne, int ndof, int ngroup, int ncol, int E,
            Geo geo, Phys ph) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the staged row that holds (slot, element): slot 0 the element, slot
  // 1 + lf its neighbour across face lf
  __shared__ int s_row[(1 + NLF) * TILE_MAX];
  // the element loaded into staged row r; -1: none
  __shared__ int s_src[(1 + NLF) * TILE_MAX];

  const int tid = threadIdx.x, lane = tid & 31;
  const int e0 = blockIdx.x * E;
  const int nt = ne - e0 < E ? ne - e0 : E;  // elements of this tile
  const int lgE = __ffs(E) - 1;              // E is a power of two
  const int nu = ndof * NEQ, ng = nu * DIM;
  const size_t nc = (size_t)ngroup * ncol;
  T* p = reinterpret_cast<T*>(smem_raw);
  int* sC = reinterpret_cast<int*>(p);
  p += RES ? al4((nc * sizeof(int) + sizeof(T) - 1) / sizeof(T)) : 0;
  T* sV = p;
  p += RES ? al4(nc * R) : 0;
  T* sU = p;  // staged rows
  p += al4((size_t)(1 + NLF) * E * nu);
  T* Gt = G + (size_t)e0 * ng;
  T* sG = p + row_phase(Gt);
  const int* C = RES ? sC : Cols;
  const T* V = RES ? sV : Vals;

  if (RES) {
    copy_async(sC, Cols, (int)nc);
    copy_async(sV, Vals, (int)(nc * R));
    cp_async_commit();
  }
  // a neighbour inside the tile is read from its row there; the others
  // are loaded into the row of (face, element)
  for (int i = tid; i < (1 + NLF) * E; i += blockDim.x) {
    const int s = i >> lgE, el = i & (E - 1);
    int row = i, src = -1;
    if (el < nt) {
      src = e0 + el;
      if (s > 0) {
        const int n = neighbor(src, s - 1, geo);
        src = n >= e0 && n < e0 + nt ? -1 : n;
        row = src < 0 ? n - e0 : i;
      }
    }
    s_row[i] = row;
    s_src[i] = src;
  }
  __syncthreads();

  // load and convert: a warp per staged row, a lane per node, LB rows a
  // warp at a time (their loads in flight together); the primitives (rho,
  // u, v, w, T) of each loaded node once
  const T gm1 = T(ph.gamma) - T(1);
  const T rrg = T(1) / T(ph.rgas);
  const int nwarp = blockDim.x >> 5, nrows = (1 + NLF) * E;
  for (int r0 = tid >> 5; r0 < nrows; r0 += LB * nwarp) {
    int src[LB];
#pragma unroll
    for (int b = 0; b < LB; ++b) {
      const int r = r0 + b * nwarp;
      src[b] = r < nrows ? s_src[r] : -1;
    }
    for (int k = lane; k < ndof; k += 32) {
      T x[LB][NEQ];
#pragma unroll
      for (int b = 0; b < LB; ++b)
        if (src[b] >= 0) {
          const T* u = U + (size_t)src[b] * nu + k * NEQ;
#pragma unroll
          for (int q = 0; q < NEQ; ++q) x[b][q] = __ldg(u + q);
        }
#pragma unroll
      for (int b = 0; b < LB; ++b)
        if (src[b] >= 0) {
          const T inv = T(1) / x[b][0];
          const T vx = x[b][1] * inv, vy = x[b][2] * inv, vz = x[b][3] * inv;
          const T ke = T(0.5) * x[b][0] * (vx * vx + vy * vy + vz * vz);
          T* y = sU + (size_t)(r0 + b * nwarp) * nu + k * NEQ;
          y[0] = x[b][0];
          y[1] = vx;
          y[2] = vy;
          y[3] = vz;
          y[4] = gm1 * (x[b][4] - ke) * inv * rrg;
        }
    }
  }
  if (RES) cp_async_wait<0>();
  __syncthreads();

  // one thread per (element, group), element fastest: the group's R rows
  // of G, acc[r][q] = sum over its columns c = (slot, node k), in order,
  // of vals[c][r] * (Up(slot)[k][q] - Up(0)[0][q]); each column's state
  // loaded once.  The folds annihilate constants (the gradient of a
  // constant is 0), so taking the element's node 0 off every column leaves
  // the sum unchanged; the dropped entries then multiply the field's
  // variation only, not T ~ 300 (see the note at the top)
  for (int t = tid; t < E * ngroup; t += blockDim.x) {
    const int el = t & (E - 1), g = t >> lgE;
    if (el >= nt) continue;
    const int* cg = C + (size_t)g * ncol;
    const T* vg = V + (size_t)g * ncol * R;
    T c0[NEQ];
#pragma unroll
    for (int q = 0; q < NEQ; ++q) c0[q] = sU[el * nu + q];
    T acc[R][NEQ];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < NEQ; ++q) acc[r][q] = T(0);
    int slot = -1;
    const T* x = sU;
    for (int c = 0; c < ncol; ++c) {
      const int sk = cg[c];
      if ((sk >> 16) != slot) {  // columns are sorted by slot
        slot = sk >> 16;
        x = sU + (size_t)s_row[(slot << lgE) + el] * nu;
      }
      const T* u = x + (sk & 0xffff) * NEQ;
      T xv[NEQ];
#pragma unroll
      for (int q = 0; q < NEQ; ++q) xv[q] = u[q] - c0[q];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T w = vg[c * R + r];
#pragma unroll
        for (int q = 0; q < NEQ; ++q) acc[r][q] += w * xv[q];
      }
    }
    const int* rg = Rows + (size_t)g * R;
    T* o = sG + (size_t)el * ng;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = __ldg(rg + r);
      if (row < 0) continue;
      const int dd = row / ndof, j = row - dd * ndof;
#pragma unroll
      for (int q = 0; q < NEQ; ++q) o[(j * NEQ + q) * DIM + dd] = acc[r][q];
    }
  }
  __syncthreads();
  // the tile's G is one span of G
  store_span(Gt, sG, nt * ng);
}

// ---------------------------------------------------------------- K2

// Shared memory of a block of E elements (values, regions 16-byte
// aligned): the faces' supports; V, Btr per node [NLF][ndof][ldq], W (if
// resident); U and G of the tile and two neighbor buffers of each (row
// slots, `row_slot`; the second also stages Btr as copied); the two
// traces [E][nqf][NEQ + NG], which the volume flux [E][ndof][NEQ*DIM]
// uses before them; the face flux
// [E][nqf*NEQ + 1]; the accumulator [E][ndof][NEQ]; |u| + c [E][ndof].
Plan k2_plan(int ndof, int nqf, int viscous, size_t ts) {
  const size_t ng = viscous ? NEQ * DIM : 0, k = NEQ + ng;
  auto bytes = [=](int E, int res) {
    size_t v = support_values(NLF, ndof, ts);
    const size_t nb_ = (size_t)NLF * nqf * ndof;
    v += res ? al4((size_t)DIM * ndof * ndof) +
                   al4((size_t)NLF * ndof * trace_ld(nqf)) + al4(nb_)
             : 0;
    v += al4((size_t)E * ndof * NEQ) + al4((size_t)E * ndof * ng);
    const size_t nbuf =
        E * (row_slot(ndof * NEQ, ts) + (ng ? row_slot(ndof * ng, ts) : 0));
    const size_t staged = res ? nb_ : 0;
    v += nbuf + al4(nbuf > staged ? nbuf : staged);
    const size_t tr = 2 * al4((size_t)E * nqf * k);
    const size_t vf = al4((size_t)E * ndof * NEQ * DIM);
    v += tr > vf ? tr : vf;
    v += al4((size_t)E * (nqf * NEQ + 1)) + al4((size_t)E * ndof * NEQ) +
         al4((size_t)E * ndof);
    return v * ts;
  };
  return make_plan(bytes);
}

// RES: V, Btr and W are resident in shared memory (then every operand
// load is a shared-memory load).
template <typename T, bool VISCOUS, bool RES>
__global__ void __launch_bounds__(THREADS_MAX)
k2_faces_volume(const T* __restrict__ U, const T* __restrict__ G,
                const T* __restrict__ Vg,    // [DIM][ndof][ndof]
                const T* __restrict__ Bg,    // [NLF][nqf][ndof]
                const T* __restrict__ Wg,    // [NLF][ndof][nqf]
                const T* __restrict__ Nor,   // [NLF][nqf][DIM]
                T* __restrict__ Y, T* __restrict__ mcs, int ne, int ndof,
                int nqf, int E, Geo geo, Phys ph) {
  constexpr int NG = VISCOUS ? NEQ * DIM : 0;
  constexpr int K = NEQ + NG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_nb[NLF * TILE_MAX];     // neighbor of (lf, el); -1: none
  __shared__ double s_m[NLF * TILE_MAX];   // 1, or 0 past the mesh

  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * E;
  const int nt = ne - e0 < E ? ne - e0 : E;  // elements of this tile
  const int nu = ndof * NEQ, ng = ndof * NG, fs = nqf * NEQ + 1;
  const size_t nv = (size_t)DIM * ndof * ndof, nb_ = (size_t)NLF * nqf * ndof;
  const int ldq = trace_ld(nqf);
  T* p = reinterpret_cast<T*>(smem_raw);
  int* s_cnt = reinterpret_cast<int*>(p);  // face supports
  int* s_node = s_cnt + NLF;
  p += support_values(NLF, ndof, sizeof(T));
  T* sV = p;
  T* sBT = sV + (RES ? al4(nv) : 0);  // Btr per node, [NLF][ndof][ldq]
  T* sW = sBT + (RES ? al4((size_t)NLF * ndof * ldq) : 0);
  p = sW + (RES ? al4(nb_) : 0);
  T* sU = p;  // the tile's U and G
  p += al4((size_t)E * nu);
  T* sG = p;
  p += al4((size_t)E * ng);
  // two neighbor buffers: U at sUn + b * nbuf, G at sGn + b * nbuf, one
  // row slot per element
  const int ldu = (int)row_slot(nu, sizeof(T));
  const int ldg = NG ? (int)row_slot(ng, sizeof(T)) : 0;
  const size_t nbuf = (size_t)E * (ldu + ldg);
  T* sUn = p;
  T* sGn = p + (size_t)E * ldu;
  T* staged = p + nbuf;  // buffer 1 also stages Btr as copied
  p = staged + al4(nbuf > (RES ? nb_ : 0) ? nbuf : nb_);
  T* sTo = p;  // the traces; the volume flux sf before them
  T* sTn = sTo + al4((size_t)E * nqf * K);
  T* sf = p;   // [E][ndof][NEQ][DIM]
  {
    const size_t tr = 2 * al4((size_t)E * nqf * K);
    const size_t vf = al4((size_t)E * ndof * NEQ * DIM);
    p += tr > vf ? tr : vf;
  }
  T* sF = p;
  p += al4((size_t)E * fs);
  T* sY = p;
  p += al4((size_t)E * nu);
  T* sM = p;
  const T* V = RES ? sV : Vg;
  const T* W = RES ? sW : Wg;
  // Btr: per node in shared memory (RES), else its rows in global memory
  const T* B = RES ? sBT : Bg;
  const int ldb = RES ? ldq : ndof;
  const size_t fstride = RES ? (size_t)ndof * ldq : (size_t)nqf * ndof;
  const T *Uend = U + (size_t)ne * nu, *Gend = G + (size_t)ne * ng;

  // group 0: the operators (Btr as copied) and the tile's U and G
  if (RES) {
    copy_async(sV, Vg, (int)nv);
    copy_async(staged, Bg, (int)nb_);
    copy_async(sW, Wg, (int)nb_);
  }
  copy_async(sU, U + (size_t)e0 * nu, nt * nu);
  if (VISCOUS) copy_async(sG, G + (size_t)e0 * ng, nt * ng);
  cp_async_commit();
  for (int i = tid; i < NLF * E; i += blockDim.x) {
    const int lf = i / E, el = i - lf * E;
    const bool in = el < nt;
    s_nb[i] = in ? neighbor(e0 + el, lf, geo) : -1;
    s_m[i] = in ? 1.0 : 0.0;
  }
  __syncthreads();

  auto nbr_u = [&](int lf, int el) -> const T* {
    const int nb = s_nb[lf * E + el];
    return nb < 0 ? nullptr : U + (size_t)nb * nu;
  };
  auto nbr_g = [&](int lf, int el) -> const T* {
    const int nb = s_nb[lf * E + el];
    return nb < 0 ? nullptr : G + (size_t)nb * ng;
  };
  auto fetch = [&](int lf) {  // one group: face lf's neighbors' U and G
    copy_rows_async(sUn + (lf & 1) * nbuf, E, nu, ldu,
                    [&](int el) { return nbr_u(lf, el); }, U, Uend);
    if (VISCOUS)
      copy_rows_async(sGn + (lf & 1) * nbuf, E, ng, ldg,
                      [&](int el) { return nbr_g(lf, el); }, G, Gend);
    cp_async_commit();
  };
  fetch(0);
  cp_async_wait<1>();
  __syncthreads();
  prepare_faces<T, RES>(sBT, RES ? staged : Bg, NLF, nqf, ndof, ldq, s_cnt,
                        s_node);  // synchronised below

  // ---- pointwise volume flux F = Fconv - Fvisc, and |u| + c ----
  const T gam = T(ph.gamma);
  const T gm1 = gam - T(1);
  for (int i = tid; i < nt * ndof; i += blockDim.x) {
    const T* u = sU + (size_t)i * NEQ;
    const T rho = u[0];
    const T inv = T(1) / rho;
    const T vel[3] = {u[1] * inv, u[2] * inv, u[3] * inv};
    const T v2 = vel[0] * vel[0] + vel[1] * vel[1] + vel[2] * vel[2];
    const T pr = gm1 * (u[4] - T(0.5) * rho * v2);
    sM[i] = sqrt(v2) + sqrt(gam * pr / rho);
    T* F = sf + (size_t)i * NEQ * DIM;
    for (int d = 0; d < 3; ++d) {
      F[0 * DIM + d] = u[1 + d];
      for (int a = 0; a < 3; ++a)
        F[(1 + a) * DIM + d] = u[1 + a] * vel[d] + (a == d ? pr : T(0));
      F[4 * DIM + d] = vel[d] * (u[4] + pr);
    }
    if constexpr (VISCOUS) {
      const T* g = sG + (size_t)i * NG;
      T mu, kap, bulk;
      transport(pr * inv / T(ph.rgas), ph, mu, kap, bulk);
      const T div = g[1 * DIM + 0] + g[2 * DIM + 1] + g[3 * DIM + 2];
      for (int d = 0; d < 3; ++d) {
        T fe = T(0);
        for (int a = 0; a < 3; ++a) {
          T tau = mu * (g[(1 + a) * DIM + d] + g[(1 + d) * DIM + a]);
          if (a == d) tau += bulk * div;
          F[(1 + a) * DIM + d] -= tau;
          fe += tau * vel[a];
        }
        F[4 * DIM + d] -= fe + kap * g[4 * DIM + d];
      }
    }
  }
  __syncthreads();

  // ---- volume scatter y[el][j][q] = sum_dd sum_k V[dd][j][k] F[el][k][q][dd]
  // (one thread per (element, node), element fastest), and each
  // element's max |u| + c ----
  for (int t = tid; t < E * ndof; t += blockDim.x) {
    const int el = t % E, j = t / E;
    if (el >= nt) continue;
    T acc[NEQ];
#pragma unroll
    for (int q = 0; q < NEQ; ++q) acc[q] = T(0);
    for (int dd = 0; dd < DIM; ++dd) {
      const T* v = V + ((size_t)dd * ndof + j) * ndof;
      const T* f = sf + (size_t)el * ndof * NEQ * DIM + dd;
      for (int k = 0; k < ndof; ++k) {
        const T w = v[k];
#pragma unroll
        for (int q = 0; q < NEQ; ++q) acc[q] += w * f[(k * NEQ + q) * DIM];
      }
    }
    T* y = sY + ((size_t)el * ndof + j) * NEQ;
#pragma unroll
    for (int q = 0; q < NEQ; ++q) y[q] = acc[q];
  }
  for (int el = tid; el < nt; el += blockDim.x) {
    const T* s = sM + (size_t)el * ndof;
    T m = s[0];
    for (int q = 1; q < ndof; ++q) m = nan_max(m, s[q]);
    mcs[e0 + el] = m;
  }
  __syncthreads();  // the traces overwrite the volume flux

  // ---- the six faces ----
  // scatter through W_lf = -(w * Btr_lf^T * Minv)
  auto scatter = [&](int lf) {
    scatter_stage<T, NEQ>(E, nqf, s_node + lf * ndof, s_cnt[lf],
                          W + (size_t)lf * ndof * nqf, nqf, 1, sF, fs, sY,
                          ndof);
  };
  for (int lf = 0; lf < NLF; ++lf) {
    // buffer (lf + 1) & 1 was last read by face lf - 1's traces
    if (lf + 1 < NLF) {
      fetch(lf + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // face lf - 1's scatter (its flux is complete) beside face lf's traces
    if (lf > 0) scatter(lf - 1);
    const size_t b = (lf & 1) * nbuf;
    const int opp = geo.opp[lf];
    trace_stage<T, NEQ, K, RES>(
        E, nqf, ndof, B, ldb, fstride, s_cnt, s_node,
        [&](int side, int, int& face, const int*& pos) {
          face = side ? opp : lf;
          pos = nullptr;
        },
        [&](int side, int el, int cg, const T*& x, int& ldx) {
          // own, or a fetched row at its phase
          if (cg == 0) {
            const T* src = side ? nbr_u(lf, el) : nullptr;
            x = side ? sUn + b + (size_t)el * ldu + (src ? row_phase(src) : 0)
                     : sU + (size_t)el * nu;
            ldx = NEQ;
          } else {
            const T* src = side ? nbr_g(lf, el) : nullptr;
            x = side ? sGn + b + (size_t)el * ldg + (src ? row_phase(src) : 0)
                     : sG + (size_t)el * ng;
            x += (cg - 1) * NEQ;
            ldx = NG;
          }
        },
        sTo, sTn);
    __syncthreads();
    flux_stage<T, DryAirPhysics<DIM>, VISCOUS, false, K>(
        E, nqf, sTo, sTn, Nor + (size_t)lf * nqf * DIM, 0, e0, s_m + lf * E,
        ph, sF, fs, FaceClosure<T>{});
    __syncthreads();
  }
  scatter(NLF - 1);
  __syncthreads();
  for (int i = tid; i < nt * nu; i += blockDim.x)
    Y[(size_t)e0 * nu + i] = sY[i];
}

Geo make_geo(const int* g) {
  Geo geo;
  geo.nz = g[0];
  geo.ny = g[1];
  geo.nx = g[2];
  for (int lf = 0; lf < NLF; ++lf) {
    geo.axis[lf] = g[3 + lf];
    geo.step[lf] = g[3 + NLF + lf];
    geo.opp[lf] = g[3 + 2 * NLF + lf];
  }
  return geo;
}

template <typename T, int R>
int launch_k1(const T* U, const int* rows, const int* cols, const T* vals,
              T* G, int ne, int ndof, int ngroup, int ncol, const int* g,
              const double* p, void* stream) {
  static size_t allowed[2] = {48 * 1024, 48 * 1024};
  const Plan pl = k1_plan(ndof, ngroup, ncol, R, sizeof(T));
  if (pl.tile == 0 || ne < 0) return (int)cudaErrorInvalidValue;
  if (ne == 0) return 0;
  auto kernel = pl.resident ? k1_gradient<T, R, true>
                            : k1_gradient<T, R, false>;
  if (int err = allow_smem(kernel, pl.smem, allowed[pl.resident])) return err;
  const int blocks = (ne + pl.tile - 1) / pl.tile;
  kernel<<<blocks, THREADS_MAX, pl.smem, (cudaStream_t)stream>>>(
      U, rows, cols, vals, G, ne, ndof, ngroup, ncol, pl.tile, make_geo(g),
      make_phys(p));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_k1(const T* U, const int* rows, const int* cols, const T* vals,
                T* G, int ne, int ndof, int ngroup, int ncol, int nrow,
                const int* g, const double* p, void* stream) {
  static_assert(K1_ROWS == 8, "one case per row count below");
  switch (nrow) {
#define K1_CASE(R)                                                       \
  case R:                                                                \
    return launch_k1<T, R>(U, rows, cols, vals, G, ne, ndof, ngroup, ncol, \
                           g, p, stream);
    K1_CASE(1)
    K1_CASE(2)
    K1_CASE(3)
    K1_CASE(4)
    K1_CASE(5)
    K1_CASE(6)
    K1_CASE(7)
    K1_CASE(8)
#undef K1_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T, bool VISCOUS>
int launch_k2(const T* U, const T* G, const T* V, const T* B, const T* Wsc,
              const T* N, T* Y, T* mcs, int ne, int ndof, int nqf,
              const int* g, const double* p, void* stream) {
  static size_t allowed[2] = {48 * 1024, 48 * 1024};
  const Plan pl = k2_plan(ndof, nqf, VISCOUS, sizeof(T));
  if (pl.tile == 0 || ne < 0) return (int)cudaErrorInvalidValue;
  if (ne == 0) return 0;
  auto kernel = pl.resident ? k2_faces_volume<T, VISCOUS, true>
                            : k2_faces_volume<T, VISCOUS, false>;
  if (int err = allow_smem(kernel, pl.smem, allowed[pl.resident])) return err;
  const int blocks = (ne + pl.tile - 1) / pl.tile;
  kernel<<<blocks, THREADS_MAX, pl.smem, (cudaStream_t)stream>>>(
      U, G, V, B, Wsc, N, Y, mcs, ne, ndof, nqf, pl.tile, make_geo(g),
      make_phys(p));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_k2(const T* U, const T* G, const T* V, const T* B, const T* W,
                const T* N, T* Y, T* mcs, int ne, int ndof, int nqf,
                int viscous, const int* g, const double* p, void* stream) {
  return viscous ? launch_k2<T, true>(U, G, V, B, W, N, Y, mcs, ne, ndof, nqf,
                                      g, p, stream)
                 : launch_k2<T, false>(U, G, V, B, W, N, Y, mcs, ne, ndof,
                                       nqf, g, p, stream);
}

}  // namespace

// Plain C interface for ctypes.  `geo` holds nz, ny, nx, then axis[6],
// step[6], opp[6]; `phys` as in dg_pointwise.cuh::make_phys.  Each
// returns the cudaError_t of its launch.
extern "C" {

// K1: rows [ngroup][nrow], cols [ngroup][ncol], vals [ngroup][ncol][nrow]
// are the compressed folds (dg/cuda_fused.py::gradient_groups).
int tps_k1_gradient_f32(const float* U, const int* rows, const int* cols,
                        const float* vals, float* G, int ne, int ndof,
                        int ngroup, int ncol, int nrow, const int* geo,
                        const double* phys, void* stream) {
  return dispatch_k1<float>(U, rows, cols, vals, G, ne, ndof, ngroup, ncol,
                            nrow, geo, phys, stream);
}

int tps_k1_gradient_f64(const double* U, const int* rows, const int* cols,
                        const double* vals, double* G, int ne, int ndof,
                        int ngroup, int ncol, int nrow, const int* geo,
                        const double* phys, void* stream) {
  return dispatch_k1<double>(U, rows, cols, vals, G, ne, ndof, ngroup, ncol,
                             nrow, geo, phys, stream);
}

// K1's plan, no launch: dynamic shared bytes per block; *tile gets the
// elements per block (0: the shape does not fit).
long long tps_k1_smem(int ndof, int ngroup, int ncol, int nrow, int tsize,
                      int* tile) {
  const Plan pl = k1_plan(ndof, ngroup, ncol, nrow, (size_t)tsize);
  if (tile) *tile = pl.tile;
  return (long long)pl.smem;
}

int tps_k2_faces_volume_f32(const float* U, const float* G, const float* V,
                            const float* B, const float* W, const float* N,
                            float* Y, float* mcs, int ne, int ndof, int nqf,
                            int viscous, const int* geo, const double* phys,
                            void* stream) {
  return dispatch_k2<float>(U, G, V, B, W, N, Y, mcs, ne, ndof, nqf, viscous,
                            geo, phys, stream);
}

int tps_k2_faces_volume_f64(const double* U, const double* G, const double* V,
                            const double* B, const double* W, const double* N,
                            double* Y, double* mcs, int ne, int ndof, int nqf,
                            int viscous, const int* geo, const double* phys,
                            void* stream) {
  return dispatch_k2<double>(U, G, V, B, W, N, Y, mcs, ne, ndof, nqf, viscous,
                             geo, phys, stream);
}

// K2's plan, no launch: dynamic shared bytes per block; *tile gets the
// elements per block (0: the shape does not fit).
long long tps_k2_smem(int ndof, int nqf, int viscous, int tsize, int* tile) {
  const Plan pl = k2_plan(ndof, nqf, viscous, (size_t)tsize);
  if (tile) *tile = pl.tile;
  return (long long)pl.smem;
}

}  // extern "C"
