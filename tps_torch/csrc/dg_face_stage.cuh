// The face stage shared by K2 (fused_rhs.cu) and the face sweep
// (face_sweep.cu): for a tile of E elements and one local face, both
// traces of the state, the pointwise face flux at every face point of the
// tile, and the scatter of the flux back to the nodes.  Also the tile plan
// (elements per block, shared memory) and the asynchronous copies that
// fill shared memory.
//
// Design for Hopper:
// - A block of 256 threads owns a tile of E <= 8 elements (`make_plan`).
//   Operators are copied into shared memory once per block when they fit
//   beside the tile (`resident`); the tile's own states too, and each
//   face round's neighbour states are copied by cp.async (16-byte chunks
//   whatever a row's alignment, `copy_rows_async`) into one of two buffers
//   while the previous face is computed.
// - Trace products are register-blocked and unrolled: a thread forms RS
//   face points x NEQ channels of one element, reading per node the RS
//   points' weights (one 16-byte load from the blocks laid out per node,
//   `prepare_faces`) and NEQ state values.  Only the nodes a face's trace
//   rows touch are visited (9 of 27 on the Gauss-Lobatto basis at p=2,
//   all on Gauss-Legendre); the scatter writes only those nodes.  The
//   skipped products are exact zeros, so the sums are unchanged.
// - The flux stage runs one thread per (element, face point) of the tile
//   (a lane pair per point where that leaves half the block idle), the
//   scatter one thread per (element, node); each element sums its faces
//   in a fixed order (no atomics).
// - Three barriers per face round per tile.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "dg_pointwise.cuh"

namespace tps_dg {

constexpr int TILE_MAX = 8;       // elements per block
constexpr int THREADS_MAX = 256;  // threads per block
constexpr int NLF_MAX = 6;        // local faces per element
constexpr int RS = 4;             // face points per thread in a trace product
// Dynamic shared memory of one block: a block takes at most 227 KB
// (232,448 B) in all; 1 KB is left for its static neighbour tables.
constexpr size_t SMEM_LIMIT = 232448 - 1024;
// Two blocks per SM: 2 x (dynamic + static + 1 KB reserved) <= 228 KB.
constexpr size_t SMEM_TARGET = 114688;

// Regions of shared memory start on 16-byte boundaries (counts in values).
__host__ __device__ inline size_t al4(size_t n) { return (n + 3) & ~size_t(3); }

struct Plan {
  int tile;      // elements per block (0: does not fit)
  int resident;  // operators in shared memory (else read from global)
  size_t smem;   // dynamic shared bytes
};

// The tile with the most elements in flight per SM (blocks per SM, 2 or
// 1 by shared memory, times E), over E in (8, 4, 2, 1) and operators
// resident or read through the cache; on a tie the larger tile, then
// resident operators.  `bytes(E, resident)` is the kernel's shared
// memory.  Mirrored by dg/cuda_fused.py::tile_plan.
template <typename F>
inline Plan make_plan(F bytes) {
  Plan best = {0, 0, bytes(1, 0)};
  int best_score = 0;
  for (int E = TILE_MAX; E >= 1; E /= 2)
    for (int res = 1; res >= 0; --res) {
      const size_t b = bytes(E, res);
      const int score = (b <= SMEM_TARGET ? 2 : b <= SMEM_LIMIT ? 1 : 0) * E;
      if (score > best_score) {
        best_score = score;
        best = {E, res, b};
      }
    }
  return best;
}

// Points of a transposed trace block's row (16-byte aligned rows).
__host__ __device__ inline int trace_ld(int nqf) { return (int)al4(nqf); }

// Values of T that `face_support`'s tables take: nlf counts and nlf
// lists of up to ndof nodes, as ints.
__host__ __device__ inline size_t support_values(int nlf, int ndof,
                                               size_t ts) {
  return al4(((size_t)nlf * (ndof + 1) * sizeof(int) + ts - 1) / ts);
}

// Let `kernel` take `bytes` of dynamic shared memory and the SM's largest
// carve-out (once per instantiation of the caller; above 48 KB the
// attribute is required).
template <typename Kernel>
inline int allow_smem(Kernel kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  allowed = bytes;
  return 0;
}

// ---- asynchronous copies, global -> shared (cp.async, sm_80 and later)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// ---- end of asynchronous copies

template <typename T>
__device__ __forceinline__ void cp_async_value(T* dst, const T* src) {
  if constexpr (sizeof(T) == 8)
    cp_async8(dst, src);
  else
    cp_async4(dst, src);
}

// n contiguous values, by all threads of the block: 16-byte copies where
// both sides are 16-byte aligned, then one value per copy.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, int n) {
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x, nthr = blockDim.x;
  int head = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) &
       15) == 0) {
    head = n / V * V;
    for (int i = tid * V; i < head; i += nthr * V) cp_async16(dst + i, src + i);
  }
  for (int i = head + tid; i < n; i += nthr) cp_async_value(dst + i, src + i);
}

// Values of a row slot that holds n values copied in whole 16-byte
// chunks from any 16-byte phase: the row sits at slot + row_phase(src).
// Slots are 4 (mod 8) values long, so the rows of 8 elements start in 8
// different banks.
__host__ __device__ inline size_t row_slot(int n, size_t ts) {
  const size_t V = 16 / ts;
  const size_t s = al4((n + 2 * V - 2) / V * V);
  return s % 8 ? s : s + 4;
}
template <typename T>
__device__ __forceinline__ int row_phase(const T* src) {
  return (int)((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
}

// `rows` rows of n values: row r from src(r) (nullptr: not copied) into
// dst + r*ld + row_phase(src(r)) (ld = row_slot(n)), as the 16-byte
// chunks that cover it, a warp per row; a chunk that reaches outside the
// source array [begin, end) is copied value by value, inside it.
template <typename T, typename Src>
__device__ __forceinline__ void copy_rows_async(T* dst, int rows, int n,
                                                int ld, Src src,
                                                const T* begin, const T* end) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31, nwarp = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < rows; r += nwarp) {
    const T* s = src(r);
    if (!s) continue;
    const T* a = s - row_phase(s);  // the row's first chunk, 16-byte aligned
    const int nc = (int)((s + n - a + V - 1) / V);
    T* d = dst + (size_t)r * ld;
    for (int c = lane; c < nc; c += 32) {
      const T* cs = a + c * V;
      if (cs >= begin && cs + V <= end) {
        cp_async16(d + c * V, cs);
      } else {
        for (int v = 0; v < V; ++v)
          if (cs + v >= begin && cs + v < end)
            cp_async_value(d + c * V + v, cs + v);
      }
    }
  }
}

// The trace blocks src [nlf][nqf][ndof] made ready for the trace stage:
// TR, copied per node into dst [nlf][ndof][ldq] (points padded with zeros
// to ldq = trace_ld(nqf)), so that the weights of four consecutive points
// at a node are one 16-byte load; and each face's support: for face lf,
// cnt[lf] nodes node[lf*ndof + i] in increasing order, the nodes k with a
// non-zero entry at some point.  By all threads; the caller synchronises
// after.
template <typename T, bool TR>
__device__ __forceinline__ void prepare_faces(T* dst, const T* src, int nlf,
                                              int nqf, int ndof, int ldq,
                                              int* cnt, int* node) {
  for (int r = threadIdx.x; r < nlf * ndof; r += blockDim.x) {
    const int lf = r / ndof, k = r - lf * ndof;
    const T* col = src + (size_t)lf * nqf * ndof + k;
    T* row = dst + (size_t)r * ldq;
    bool nz = false;
    for (int s = 0; s < nqf; ++s) {
      const T v = col[(size_t)s * ndof];
      nz |= v != T(0);
      if constexpr (TR) row[s] = v;
    }
    if constexpr (TR)
      for (int s = nqf; s < ldq; ++s) row[s] = T(0);
    node[r] = nz;  // flag, compacted below
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int lf = threadIdx.x >> 5; lf < nlf; lf += blockDim.x >> 5) {
    int* nd = node + lf * ndof;  // a warp per face
    int c = 0;
    for (int k0 = 0; k0 < ndof; k0 += 32) {
      const int k = k0 + lane;
      const bool f = k < ndof && nd[k];
      const unsigned bits = __ballot_sync(0xffffffffu, f);
      __syncwarp();
      if (f) nd[c + __popc(bits & ((1u << lane) - 1u))] = k;
      c += __popc(bits);
      __syncwarp();
    }
    if (lane == 0) cnt[lf] = c;
  }
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// One thread's share of a trace product: for the face points s0..s0+3
// below nqf and the NC channels i, sum_k B(s, k) * x[k*ldx + i] over the
// nk nodes k = node[kk] the face touches (B is zero at the others), stored
// at out[pos[s]*ldo + i] (pos nullptr: s).  B is the face block: TR,
// B(s, k) = B[k*ldb + s] (transposed, resident in shared memory, four
// points one load); else B(s, k) = B[s*ldb + k].  The sum runs over k in
// order, as the plain version's.
template <typename T, int NC, bool TR>
__device__ __forceinline__ void trace_tile(const T* B, int ldb, const int* pos,
                                           int s0, int nqf, int ndof,
                                           const int* node, int nk, const T* x,
                                           int ldx, T* out, int ldo) {
  static_assert(RS == 4, "one 16-byte load holds the weights of RS points");
  const T* b[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r)
    b[r] = B + (size_t)(s0 + r < nqf ? s0 + r : nqf - 1) * ldb;
  T acc[RS][NC];
#pragma unroll
  for (int r = 0; r < RS; ++r)
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = T(0);
  auto node_step = [&](int k) {
    T bv[RS];
    if constexpr (TR) {
      load4(B + k * ldb + s0, bv);
    } else {
#pragma unroll
      for (int r = 0; r < RS; ++r) bv[r] = b[r][k];
    }
    T xv[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) xv[i] = x[k * ldx + i];
#pragma unroll
    for (int r = 0; r < RS; ++r)
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[r][i] += bv[r] * xv[i];
  };
  // unrolled (p=2 supports are 9 or 27 nodes): the loads of three nodes
  // are issued ahead of their FMAs
  if (nk == ndof) {  // every node
#pragma unroll 3
    for (int k = 0; k < ndof; ++k) node_step(k);
  } else {
#pragma unroll 3
    for (int kk = 0; kk < nk; ++kk) node_step(node[kk]);
  }
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const int s = s0 + r;
    if (s < nqf) {
      const int d = pos ? __ldg(pos + s) : s;
#pragma unroll
      for (int i = 0; i < NC; ++i) out[d * ldo + i] = acc[r][i];
    }
  }
}

// Both traces of one face for the tile into To, Tn [E][nqf][K]: tasks
// (side, channel group cg < K/NEQ, point group, element), element
// fastest: a warp's loads touch a few operator rows and a few elements'
// rows, each address shared by several lanes.  rows(side, el, face, pos)
// gives the side's face (its block at B + face*fstride, layout as in
// trace_tile) and where its points land (pos, nullptr: in order);
// cols(side, el, cg, x, ldx) the state's channels cg*NEQ.. at node k:
// x[k*ldx + i].
template <typename T, int NEQ, int K, bool TR, typename Rows, typename Cols>
__device__ __forceinline__ void trace_stage(int E, int nqf, int ndof,
                                            const T* B, int ldb,
                                            size_t fstride, const int* cnt,
                                            const int* node, Rows rows,
                                            Cols cols, T* To, T* Tn) {
  constexpr int NCG = K / NEQ;
  const int nsg = (nqf + RS - 1) / RS;
  const int ntask = 2 * nsg * NCG * E;
  for (int t = threadIdx.x; t < ntask; t += blockDim.x) {
    const int el = t % E;
    int r = t / E;
    const int sg = r % nsg;
    r /= nsg;
    const int cg = r % NCG, side = r / NCG;
    int face;
    const int* pos;
    rows(side, el, face, pos);
    const T* x;
    int ldx;
    cols(side, el, cg, x, ldx);
    T* out = (side ? Tn : To) + (size_t)el * nqf * K + cg * NEQ;
    trace_tile<T, NEQ, TR>(B + face * fstride, ldb, pos, sg * RS, nqf, ndof,
                           node + face * ndof, cnt[face], x, ldx, out, K);
  }
}

template <typename T>
__device__ __forceinline__ T other_lane(T v) {  // the pair partner's value
  return __shfl_xor_sync(0xffffffffu, v, 1);
}

// The face flux at every point of the tile: F = m * (Rusanov of the two
// traces minus, for Navier-Stokes, the mean of the two one-sided viscous
// normal fluxes) into Fl[el*fs + s*NEQ + q], with the physics of policy P
// (dg_pointwise.cuh::DryAirPhysics, dg_mixture.cuh::ArgonMixture).
// m[el] == 0 (a boundary slot or no element) writes 0.  Normal of (el,
// s): nor[(e0+el)*nor_e + s*DIM].  Where the tile has at most half as
// many points as the block threads, a lane pair takes a point, each lane
// one side's convective and viscous fluxes, exchanged by shuffles; the
// result is the same arithmetic.
template <typename T, class P, bool VISCOUS, bool PROTO, int K>
__device__ __forceinline__ void flux_stage(int E, int nqf, const T* To,
                                           const T* Tn, const T* nor,
                                           long long nor_e, int e0,
                                           const double* m,
                                           const typename P::Params& ph,
                                           T* Fl, int fs) {
  constexpr int DIM = P::DIM, NEQ = P::NEQ, NW = P::NW;
  if (2 * E * nqf <= (int)blockDim.x) {
    const int i = threadIdx.x >> 1, side = threadIdx.x & 1;
    const bool act = i < E * nqf;
    const int el = act ? i / nqf : 0, s = act ? i - el * nqf : 0;
    const T mm = T(m[el]);
    const T* np = nor + (e0 + el) * nor_e + (long long)s * DIM;
    T n[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) n[d] = __ldg(np + d);
    const T* u1 = To + (size_t)(el * nqf + s) * K;
    const T* u2 = Tn + (size_t)(el * nqf + s) * K;
    const T* u = side ? u2 : u1;
    T f[NEQ], w[NW], v[NEQ];
    P::conv(u, n, ph, f, w);
    if constexpr (VISCOUS) P::visc(u, u + NEQ, n, ph, v);
    T fo[NEQ], wo[NW], vo[NEQ];
#pragma unroll
    for (int q = 0; q < NEQ; ++q) fo[q] = other_lane(f[q]);
    if constexpr (VISCOUS) {
#pragma unroll
      for (int q = 1; q < NEQ; ++q) vo[q] = other_lane(v[q]);
    }
#pragma unroll
    for (int j = 0; j < NW; ++j) wo[j] = other_lane(w[j]);
    if (!act || side) return;
    T fl[NEQ];
    P::template combine<T, PROTO>(u1, u2, n, f, fo, w, wo, fl);
    if constexpr (VISCOUS) {
#pragma unroll
      for (int q = 1; q < NEQ; ++q) fl[q] -= T(0.5) * (v[q] + vo[q]);
    }
    T* out = Fl + el * fs + s * NEQ;
#pragma unroll
    for (int q = 0; q < NEQ; ++q) out[q] = mm == T(0) ? T(0) : fl[q] * mm;
    return;
  }
  for (int i = threadIdx.x; i < E * nqf; i += blockDim.x) {
    const int el = i / nqf, s = i - el * nqf;
    T* f = Fl + el * fs + s * NEQ;
    const T mm = T(m[el]);
    if (mm == T(0)) {
#pragma unroll
      for (int q = 0; q < NEQ; ++q) f[q] = T(0);
      continue;
    }
    const T* np = nor + (e0 + el) * nor_e + (long long)s * DIM;
    T n[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) n[d] = __ldg(np + d);
    const T* u1 = To + (size_t)(el * nqf + s) * K;
    const T* u2 = Tn + (size_t)(el * nqf + s) * K;
    T f1[NEQ], f2[NEQ], w1[NW], w2[NW], fl[NEQ];
    P::conv(u1, n, ph, f1, w1);
    P::conv(u2, n, ph, f2, w2);
    P::template combine<T, PROTO>(u1, u2, n, f1, f2, w1, w2, fl);
    if constexpr (VISCOUS) {
      T v1[NEQ], v2[NEQ];
      P::visc(u1, u1 + NEQ, n, ph, v1);
      P::visc(u2, u2 + NEQ, n, ph, v2);
#pragma unroll
      for (int q = 1; q < NEQ; ++q) fl[q] -= T(0.5) * (v1[q] + v2[q]);
    }
#pragma unroll
    for (int q = 0; q < NEQ; ++q) f[q] = fl[q] * mm;
  }
}

// Y[el][j][q] += sum_s op[j*oj + s*os] * Fl[el*fs + s*NEQ + q] for the
// nj nodes j = node[jj] the face touches (op is zero at the others): one
// thread per (element, node), element fastest; the sum over s in order,
// then added to the element's accumulator (the plain version's order).
template <typename T, int NEQ>
__device__ __forceinline__ void scatter_stage(int E, int nqf, const int* node,
                                              int nj, const T* op, int oj,
                                              int os, const T* Fl, int fs,
                                              T* Y, int ndof) {
  for (int t = threadIdx.x; t < E * nj; t += blockDim.x) {
    const int el = t % E, j = node[t / E];
    const T* o = op + (size_t)j * oj;
    const T* f = Fl + el * fs;
    T acc[NEQ];
#pragma unroll
    for (int q = 0; q < NEQ; ++q) acc[q] = T(0);
#pragma unroll 4
    for (int s = 0; s < nqf; ++s) {
      const T w = o[(size_t)s * os];
#pragma unroll
      for (int q = 0; q < NEQ; ++q) acc[q] += w * f[s * NEQ + q];
    }
    T* y = Y + ((size_t)el * ndof + j) * NEQ;
#pragma unroll
    for (int q = 0; q < NEQ; ++q) y[q] += acc[q];
  }
}

}  // namespace tps_dg
