// Fused primal-dual step for Hopper: the wide variant, n > 16 features.
//
// Replaces the part of the Pallas TPU kernel
// src/repro/kernels/pd_step.py:fused_pd_step (body _make_kernel) that
// the register-tile kernel (pd_step_impl.cuh, n <= kTileFeatures) does
// not take: the reference's BlockSpecs are (bv, n) for any n and its
// logistic Cholesky unrolls over n at trace time.  Same arguments, same
// storage contract and the same step as pd_step_impl.cuh (see there):
// every loss, tv / tv2, rho != 1, compute_residual, iters > 1 on one
// block, the stop word, float32 or bfloat16 storage and the lane axis,
// in one cooperative launch over the compact incidence.
//
// What bounds it on an H100 at the full-size width n = 32 (1M nodes,
// ~10.2M edges; PERF.md section 6): the squared loss by bytes (P alone
// is n^2 floats a node, 4.2 GB; u is read and written once: ~7.4 GB a
// step, 2.2 ms at 3.35 TB/s); the lasso by the issue rate and latency of
// its 30 ISTA steps a node (n FMAs a thread, two products, a soft
// threshold and a __syncwarp each); the logistic loss by the issue rate
// and latency of its 8 Newton steps a node, above all the 32-step
// Cholesky, whose trailing update a row a thread leaves half of a
// warp's lanes idle (the triangle) and whose pivot chain is sequential.
//
// Design.
//   * Node phase: a node a warp, each node warp walking its own stream
//     of nodes (node i to warp i mod the grid's node warps), so no block
//     barrier sits between nodes and the warps of an SM overlap one
//     node's loads with another's arithmetic.  The node's vectors live
//     in the warp's slice of shared memory.
//   * D^T u: the warp walks the node's slots in order (in-edges, then the
//     out run), several rows in flight; lane l loads features l + 32 c of
//     each row, so a row of 32 float32 is one 128-byte load.
//   * The prox: a row a thread.  Thread j owns row j (and j + 32, ...) of
//     P, Q or the Hessian; its dot products sum feature k into partial
//     sum k mod kSums, each in k order, then the partial sums pairwise,
//     the operand vector broadcast from shared memory; no shuffle tree.
//     The node's matrix (P, Q or its samples x) is staged in the slice
//     with coalesced 16-byte loads, rows at an odd stride, so that a
//     warp's reads of 32 rows at one column hit 32 banks.
//       - squared: P (v + b), one dot product a row.
//       - lasso: n <= kRowRegs: thread j holds row j of Q in registers,
//         loaded once a node, over every ISTA step (n FMAs, z read 4 at
//         a time, and one __syncwarp a step); past it the rows come from
//         the slice.  The divisions by m and tau_p are products with
//         their reciprocals.
//       - logistic: the logits a sample a thread (32 samples at once),
//         then per sample, its residual and weight shuffled to every
//         thread, thread r adds sample j to its gradient entry and to
//         row r of H = sum d_j x_j x_j^T / m + I / tau (the division by
//         m a product with 1 / m).
//         At n <= kRowRegs (rows in registers) the Cholesky is
//         right-looking, a column a step: the pivot reaches every thread
//         by one shuffle, threads r > c divide their entry by it and
//         write it to a column buffer (two, by the step's parity: one
//         __syncwarp a step) and to the packed factor, then update their
//         row from that column, read 4 entries at a time.  Each entry
//         h_rc takes the subtractions h_rk h_ck in k order, then the sqrt
//         or the division, as in the left-looking
//         api/losses.py:_chol_solve, each subtraction one fused
//         multiply-add (__fmaf_rn: one rounding where the reference
//         rounds twice).  The two substitutions go a column at a time
//         (forward from the first, subtracting in k order as the
//         reference does; back from the last, so in descending k where
//         the reference ascends), each unknown its thread's value times
//         its diagonal's reciprocal, shuffled to the others.
//         Past kRowRegs the Hessian's rows are packed in the slice (row r
//         at r (r + 1) / 2, which puts a warp's 32 rows on 32 banks) and
//         the factorization is left-looking, a column a step: the
//         pivot's sum of squares by the warp (lane l takes k = l, l + 32,
//         ..., then a fixed shuffle tree), then each thread's entries of
//         the column as dot products with kFactorSums partial sums.  The
//         reference's sequence, every subtraction in k order, rounds
//         further from float64 than the plain version's factorization
//         over a hundred columns (at n = 128, past what the tests allow).
//         The substitutions go a row at a time, each row's products
//         summed by the warp in the same way.
//   * Edge phase: a group of G threads an edge (G a power of two, up to
//     a warp, covering the row with 4-element vectors where n % 4 == 0
//     and every row is 16-byte aligned: 8 threads at n = 32), so the
//     rows of u, z[src] and z[dst] move as whole 128-byte lines (bf16 u:
//     64 bytes).  The update is elementwise and its residual a max, so
//     the grouping changes no bit (the parent kernel's outputs, bit for
//     bit, on every loss and storage type at n = 17-128).
//   * Parameters are staged in the warp's slice where the plan fits
//     (make_wide_plan), else read from device memory (STAGED false; a
//     row's entries 4 to a vector load where aligned); both read each
//     value as to_f32 of its storage value and run the same arithmetic,
//     so they give the same bits.
//   * Occupancy: wide_min_blocks caps the registers so that 4 (squared)
//     or 3 blocks of 256 threads reside on an SM (measured; see there):
//     32 or 24 warps.  ptxas, one-lane staged at n <= kRowRegs: squared
//     64 registers (12 bytes spilled), lasso 80 (none), logistic 80 (112
//     bytes of spill stores, 152 of loads).
// No float atomics: a node's sums run in a fixed order on one warp, so
// two launches, and lane l of a launch over lanes and a one-lane launch
// on its inputs, give bit-identical outputs.
#pragma once

#include "pd_step_impl.cuh"

namespace repro_pd {

constexpr int kWideChunk = 4;   // features a thread per gather pass (n > 32)
constexpr int kRowRegs = 32;    // widest n whose prox rows sit in registers
constexpr int kEdgeVec = 4;     // features a thread per edge-phase vector
// Plan::vec bits of a wide launch
constexpr int kVecEdge = 1;     // u and z rows as 4-element vectors
constexpr int kVecStage = 2;    // the staged matrix in 16-byte loads

__host__ __device__ __forceinline__ long long round4(long long x) {
  return (x + 3) & ~3LL;
}
__host__ __device__ __forceinline__ int tri(int r) { return r * (r + 1) / 2; }
// floats of each of a node's vectors in the slice: n padded to 16 bytes,
// and at least kRowRegs, so that a row in registers reads whole vectors
__host__ __device__ __forceinline__ long long vec_floats(int n) {
  return n < kRowRegs ? kRowRegs : round4(n);
}

// The loss's matrix parameter, staged a node at a time: its index among
// the sorted prox parameters and its rows (n columns each).
__host__ __device__ __forceinline__ int mat_param(int loss) {
  return loss == kSquared ? 1 : (loss == kLasso ? 2 : 4);
}
__host__ __device__ __forceinline__ int mat_rows(int loss, int n, int ms) {
  return loss == kLogistic ? ms : n;
}

// The offset of the staged matrix in a warp's slice: after the node's
// vectors (w, v and the prox's: squared w+; lasso z and its next; the
// logistic z and its gradient; vec_floats each) and the logistic
// Cholesky's two column buffers and packed factor.
__host__ __device__ __forceinline__ long long wide_mat_offset(int loss,
                                                              int n) {
  const long long rn = vec_floats(n);
  if (loss == kSquared) return 3 * rn;
  if (loss == kLasso) return 4 * rn;
  return 4 * rn + 2 * kRowRegs + round4(tri(n));
}

// Shared floats of one warp's slice: the vectors, and (staged) the matrix
// as float32 rows at stride n | 1.
inline long long wide_scratch(int loss, int n, int ms, bool staged) {
  long long f = wide_mat_offset(loss, n);
  if (staged) f += round4((long long)mat_rows(loss, n, ms) * (n | 1));
  return f;
}

// The wide launch plan: nw node warps a block (8, 4, 2 or 1: as many
// slices as fit kSmemTarget, else kSmemMax), each with `scratch` shared
// floats; the edge phase's group of `lanes` threads an edge and the
// vector bits (vec).  Returns the shared bytes; past kSmemMax the launch
// is refused (for the staged plan: the streamed one runs instead).
// Whether it fits depends on the loss, n, the samples a node and the
// lane count alone, as make_plan's does.
template <int LOSS, bool MULTI>
long long make_wide_plan(const PdArgs& a, Plan& p, bool staged) {
  stage_layout(LOSS, a.n, a.num_samples, p, staged);  // elems, num_params
  const long long slice = wide_scratch(LOSS, a.n, a.num_samples, staged);
  const long long fixed = MULTI ? a.num_lanes : 0;
  auto total = [&](long long nw) { return 4 * (nw * slice + fixed); };
  int nw = kWarps;
  while (nw > 1 && total(nw) > kSmemTarget) nw >>= 1;
  if (total(nw) > kSmemTarget) {
    nw = kWarps;
    while (nw > 1 && total(nw) > kSmemMax) nw >>= 1;
  }
  p.nw = nw;
  p.scratch = (int)slice;
  p.res_offset = (int)(nw * slice);
  p.num_tiles = (a.num_nodes + nw - 1) / nw;
  // the edge phase's vectors: every u / z row 16-byte aligned (bf16 u
  // rows 8-byte), in every lane
  bool ve = a.n % kEdgeVec == 0 && aligned16(a.u_in) && aligned16(a.u_out) &&
            aligned16(a.u_carry) && aligned16(a.z);
  if (MULTI)
    ve = ve && a.u_in_lane % kEdgeVec == 0 && a.u_out_lane % kEdgeVec == 0 &&
         a.uc_lane % kEdgeVec == 0;
  // the staged matrix's 16-byte loads: every node's rows aligned
  const int mp = mat_param(LOSS);
  const long long ts = a.storage == kBF16 ? 2 : 4;
  const bool vs = aligned16(a.prm[mp]) && (p.elems[mp] * ts) % 16 == 0;
  p.vec = (ve ? kVecEdge : 0) | (vs ? kVecStage : 0);
  int g = 1;
  const int per = ve ? kEdgeVec : 1;
  while (g < 32 && g * per < a.n) g <<= 1;
  p.lanes = g;
  return total(nw);
}

// A node's matrix, rows of n: the staged float32 rows at stride ld in
// the warp's slice, or the storage rows in device memory widened by
// to_f32 as the staging widens them (the same values, so the same bits).
// The 16 bytes at p as float32: 4 floats, or 8 bfloat16 widened.
__device__ __forceinline__ void unpack16(const float* p, float (&f)[4]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  f[0] = __uint_as_float(q.x); f[1] = __uint_as_float(q.y);
  f[2] = __uint_as_float(q.z); f[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* p,
                                         float (&f)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(w[j] << 16);
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// 4 elements at p as float32, and back (16 bytes of float32, 8 of bf16).
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  unpack16(p, f);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&f)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(q.x << 16);
  f[1] = __uint_as_float(q.x & 0xffff0000u);
  f[2] = __uint_as_float(q.y << 16);
  f[3] = __uint_as_float(q.y & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* p, const float (&f)[4]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                 __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&f)[4]) {
  unsigned w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    w[q] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(f[q]));
  *reinterpret_cast<uint2*>(p) =
      make_uint2(w[0] | (w[1] << 16), w[2] | (w[3] << 16));
}

// quad(r, c, f) reads 4 consecutive entries of a row: from device memory
// as one vector load where `vec` promises every row 16-byte (bf16:
// 8-byte) aligned, so that a row a thread still moves whole sectors.
template <typename T, bool STAGED>
struct NodeRows {
  const float* sm;
  const T* gm;
  int n, ld;
  bool vec;
  __device__ __forceinline__ float operator()(int r, int c) const {
    if constexpr (STAGED)
      return sm[r * ld + c];
    else
      return to_f32(gm[(long long)r * n + c]);
  }
  __device__ __forceinline__ void quad(int r, int c, float (&f)[4]) const {
    if constexpr (!STAGED) {
      if (vec) {
        load4(gm + (long long)r * n + c, f);
        return;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) f[q] = (*this)(r, c + q);
  }
};

// Copy a node's matrix (rows x n storage values at g) into the slice as
// float32 rows at the odd stride ld, on the warp: coalesced loads (16
// bytes a thread where vec), stores that hit distinct banks.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* g, int rows, int n,
                                           int ld, float* sm, bool vec,
                                           int lane) {
  const int total = rows * n;
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int step = 32 * E, dr = step / n, dc = step - dr * n;
    int r = lane * E / n, c = lane * E - r * n;
    for (int e = lane * E; e < total; e += step) {
      float f[E];
      unpack16(g + e, f);
      int rr = r, cc = c;
#pragma unroll
      for (int q = 0; q < E; ++q) {
        sm[rr * ld + cc] = f[q];
        if (++cc == n) { cc = 0; ++rr; }
      }
      r += dr;
      c += dc;
      if (c >= n) { c -= n; ++r; }
    }
  } else {
    const int dr = 32 / n, dc = 32 - dr * n;
    int r = lane / n, c = lane - r * n;
    for (int e = lane; e < total; e += 32) {
      sm[r * ld + c] = to_f32(g[e]);
      r += dr;
      c += dc;
      if (c >= n) { c -= n; ++r; }
    }
  }
}

// D^T u of node m into sv on its warp: in-edges (-1), then the out run
// (+1), in slot order; lane l takes features l + 32 c (CH of them a
// pass), UN rows in flight.
template <int CH, typename U>
__device__ __forceinline__ void wide_gather(const PdArgs& a, int4 m,
                                            const U* u, long long u_rows,
                                            float* sv, int lane) {
  constexpr int UN = CH == 1 ? 8 : kUnroll;
  const int n = a.n;
  const int nin = m.y, first = m.z, deg = m.y + m.w;
  for (int f0 = 0; f0 < n; f0 += 32 * CH) {
    float acc[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) acc[c] = 0.0f;
    for (int s0 = 0; s0 < deg; s0 += UN) {
      long long e[UN];
#pragma unroll
      for (int t = 0; t < UN; ++t) {
        const int sl = s0 + t;
        long long id = 0;
        if (sl < deg) id = sl < nin ? a.in_ids[m.x + sl] : first + (sl - nin);
        e[t] = id < 0 ? 0 : (id >= u_rows ? u_rows - 1 : id);
      }
      float r[UN][CH];
#pragma unroll
      for (int t = 0; t < UN; ++t) {
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const int k = f0 + lane + 32 * c;
          r[t][c] = (s0 + t < deg && k < n) ? to_f32(u[e[t] * n + k]) : 0.0f;
        }
      }
#pragma unroll
      for (int t = 0; t < UN; ++t) {
        const int sl = s0 + t;
        if (sl < deg) {
#pragma unroll
          for (int c = 0; c < CH; ++c)
            acc[c] = sl < nin ? acc[c] - r[t][c] : acc[c] + r[t][c];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int k = f0 + lane + 32 * c;
      if (k < n) sv[k] = acc[c];
    }
  }
}

// The sum of x over the warp by a fixed xor-shuffle tree; every thread
// gets the same bits (float addition commutes).
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

constexpr int kSums = 4;         // a prox row's partial sums
constexpr int kFactorSums = 16;  // a slice-row Cholesky entry's

// The partial sums s[0..K) added pairwise: s[q] += s[q + K/2], ... (a
// fixed tree).
template <int K>
__device__ __forceinline__ float pairwise(float (&acc)[K]) {
#pragma unroll
  for (int w = K / 2; w > 0; w >>= 1) {
#pragma unroll
    for (int q = 0; q < w; ++q) acc[q] = acc[q] + acc[q + w];
  }
  return acc[0];
}

// Row j of M against x (n floats in shared memory, broadcast): feature k
// into partial sum k mod K, each in k order, then the sums pairwise.  A
// fixed order, so every variant and lane gets the same bits; the
// independent sums shorten the latency, and the rounding of a sum of n
// terms grows as n / K + log2(K).
template <int K, class Rows>
__device__ __forceinline__ float dot_row(const Rows& M, int j,
                                         const float* x, int n) {
  float acc[K];
#pragma unroll
  for (int q = 0; q < K; ++q) acc[q] = 0.0f;
  int k = 0;
  for (; k + K <= n; k += K) {
#pragma unroll
    for (int q = 0; q < K; q += 4) {
      float v[4];
      M.quad(j, k + q, v);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[q + i] = __fmaf_rn(v[i], x[k + q + i], acc[q + i]);
    }
  }
#pragma unroll
  for (int q = 0; q < K; ++q)
    if (k + q < n) acc[q] = __fmaf_rn(M(j, k + q), x[k + q], acc[q]);
  return pairwise(acc);
}

// One row in shared memory, as dot_row's rows (the row index unused).
struct OneRow {
  const float* row;
  __device__ __forceinline__ float operator()(int, int c) const {
    return row[c];
  }
  __device__ __forceinline__ void quad(int, int c, float (&f)[4]) const {
#pragma unroll
    for (int q = 0; q < 4; ++q) f[q] = row[c + q];
  }
};

// The prox of node i on its warp: v in the slice (s + rn), the matrix
// rows M, the other parameters read from device memory (to_f32 of their
// storage values in either variant).  ROWS: n <= kRowRegs.  Returns the
// row of w+ (in the slice, or v itself for an unlabeled lasso /
// logistic node).  Every thread of the warp calls it; it ends with the
// warp synchronised.
template <int LOSS, typename T, bool STAGED, bool ROWS>
__device__ const float* wide_prox(const PdArgs& a, const Plan& p, float* s,
                                  long long i, int lane) {
  const int n = a.n;
  const int rn = (int)vec_floats(n);
  float* sv = s + rn;
  auto prm = [&](int k) {
    return static_cast<const T*>(a.prm[k]) + i * p.elems[k];
  };
  const NodeRows<T, STAGED> M{s + wide_mat_offset(LOSS, n),
                              prm(mat_param(LOSS)), n, n | 1,
                              (p.vec & kVecStage) != 0 && n % 4 == 0};
  if constexpr (LOSS == kSquared) {  // params ("b", "p"): P (v + b)
    const T* b = prm(0);
    float* wp = s + 2 * rn;
    for (int k = lane; k < n; k += 32) sv[k] = sv[k] + to_f32(b[k]);
    __syncwarp();
    for (int j = lane; j < n; j += 32) wp[j] = dot_row<kSums>(M, j, sv, n);
    __syncwarp();
    return wp;
  } else if constexpr (LOSS == kLasso) {
    // params ("labeled", "m", "q", "step", "tau", "xty")
    const float m = to_f32(prm(1)[0]), step = to_f32(prm(3)[0]),
                tp = to_f32(prm(4)[0]);
    const T* xty = prm(5);
    const float thr = a.alpha * step;
    const float inv_m = 1.0f / m, inv_tp = 1.0f / tp;
    float* z = s + 2 * rn;
    float* zn = s + 3 * rn;
    // one ISTA update of z_j from (Q z)_j (the divisions by m and tau_p
    // as products with their reciprocals)
    auto ista = [&](float qz, float zj, float vj, float xj) {
      float g = 2.0f * (qz - xj) * inv_m;
      g = g + (zj - vj) * inv_tp;
      const float x = zj - step * g;
      const float sgn = (float)(x > 0.0f) - (float)(x < 0.0f);
      return sgn * fmaxf(fabsf(x) - thr, 0.0f);
    };
    if constexpr (ROWS) {
      // row j of Q in registers for every step; z broadcast 4 at a time
      const int j = lane;
      const bool live = j < n;
      float q_row[kRowRegs];
#pragma unroll
      for (int k = 0; k < kRowRegs; ++k)
        q_row[k] = (live && k < n) ? M(j, k) : 0.0f;
      const float vj = live ? sv[j] : 0.0f;
      const float xj = live ? to_f32(xty[j]) : 0.0f;
      // z and its next are kRowRegs long, zero past n, so the row runs
      // whole: past n it adds 0 * 0
      float zj = vj;
      z[j] = vj;
      zn[j] = 0.0f;
      __syncwarp();
      for (int it = 0; it < a.num_inner; ++it) {
        // Q's row from registers: feature k into sum k mod kSums,
        // then the sums pairwise
        float acc[kSums];
#pragma unroll
        for (int q = 0; q < kSums; ++q) acc[q] = 0.0f;
#pragma unroll
        for (int k4 = 0; k4 < kRowRegs; k4 += 4) {
          const float4 z4 = *reinterpret_cast<const float4*>(z + k4);
          const int q = k4 % kSums;
          acc[q] = __fmaf_rn(q_row[k4], z4.x, acc[q]);
          acc[q + 1] = __fmaf_rn(q_row[k4 + 1], z4.y, acc[q + 1]);
          acc[q + 2] = __fmaf_rn(q_row[k4 + 2], z4.z, acc[q + 2]);
          acc[q + 3] = __fmaf_rn(q_row[k4 + 3], z4.w, acc[q + 3]);
        }
        zj = live ? ista(pairwise(acc), zj, vj, xj) : 0.0f;
        zn[j] = zj;
        __syncwarp();
        float* t = z;
        z = zn;
        zn = t;
      }
    } else {
      for (int k = lane; k < n; k += 32) z[k] = sv[k];
      __syncwarp();
      for (int it = 0; it < a.num_inner; ++it) {
        for (int j = lane; j < n; j += 32)
          zn[j] = ista(dot_row<kSums>(M, j, z, n), z[j], sv[j],
                       to_f32(xty[j]));
        __syncwarp();
        float* t = z;
        z = zn;
        zn = t;
      }
    }
    return to_f32(prm(0)[0]) > 0.0f ? z : sv;
  } else {
    // params ("labeled", "m", "mask", "tau", "x", "y")
    const int ms = a.num_samples;
    const float m = to_f32(prm(1)[0]), tp = to_f32(prm(3)[0]);
    const float inv_m = 1.0f / m, inv_tp = 1.0f / tp;
    const T* mask = prm(2);
    const T* ys = prm(5);
    float* z = s + 2 * rn;
    float* g = s + 3 * rn;       // the gradient, then the Newton step
    float* cols = s + 4 * rn;    // ROWS: the factor's column, by parity
    float* L = cols + 2 * kRowRegs;  // H, then its factor: row r at tri(r)
    for (int k = lane; k < n; k += 32) z[k] = sv[k];
    __syncwarp();
    // the residual and weight of sample j0 + lane
    auto sample = [&](int j0, float& res, float& d) {
      const int j = j0 + lane;
      res = 0.0f;
      d = 0.0f;
      if (j < ms) {
        const float logit = dot_row<kSums>(M, j, z, n);
        const float sg = 1.0f / (1.0f + expf(-logit));
        const float mk = to_f32(mask[j]);
        res = (sg - to_f32(ys[j])) * mk;
        d = (sg * (1.0f - sg)) * mk;
      }
    };
    for (int it = 0; it < a.num_inner; ++it) {
      if constexpr (ROWS) {
        const int r = lane;
        const bool live = r < n;
        float h[kRowRegs];
        float gr = 0.0f;
#pragma unroll
        for (int c = 0; c < kRowRegs; ++c) h[c] = 0.0f;
        for (int j0 = 0; j0 < ms; j0 += 32) {
          float res, d;
          sample(j0, res, d);
          const int cnt = ms - j0 < 32 ? ms - j0 : 32;
          for (int jj = 0; jj < cnt; ++jj) {
            const float rj = __shfl_sync(0xffffffffu, res, jj);
            const float dj = __shfl_sync(0xffffffffu, d, jj);
            const int js = j0 + jj;
            const float xr = live ? M(js, r) : 0.0f;
            gr = __fmaf_rn(rj, xr, gr);
            const float dx = dj * xr;
#pragma unroll
            for (int c = 0; c < kRowRegs; ++c)
              if (c < n) h[c] = __fmaf_rn(dx, M(js, c), h[c]);
          }
        }
        if (live) {
          gr = gr * inv_m + (z[r] - sv[r]) * inv_tp;
#pragma unroll
          for (int c = 0; c < kRowRegs; ++c)
            h[c] = h[c] * inv_m + (r == c ? inv_tp : 0.0f);
        }
        // Cholesky, right-looking: column c a step.  The pivot reaches
        // every thread by a shuffle; threads r > c divide their entry by
        // it and write it to the column buffer (one of two, by the
        // step's parity, so one __syncwarp a step serves) and to the
        // factor's packed rows (for the back substitution); then every
        // thread reads the column 4 entries at a time and threads r > c
        // update their row.
        const int tr = tri(r);
        float diag = 1.0f;
#pragma unroll
        for (int c = 0; c < kRowRegs; ++c) {
          if (c < n) {
            float* col = cols + (c & 1) * kRowRegs;
            const float piv = sqrtf(__shfl_sync(0xffffffffu, h[c], c));
            const float lrc = h[c] / piv;
            if (r == c) {
              h[c] = piv;
              diag = piv;
            } else if (r > c) {
              h[c] = lrc;
              col[r] = lrc;
            }
            if (r >= c && live) L[tr + c] = h[c];
            __syncwarp();
#pragma unroll
            for (int c4 = (c + 1) & ~3; c4 < kRowRegs; c4 += 4) {
              if (c4 < n) {
                const float4 l4 = *reinterpret_cast<const float4*>(col + c4);
                const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  const int c2 = c4 + q;
                  if (c2 > c && c2 < n && c2 <= r && live)
                    h[c2] = __fmaf_rn(-h[c], lv[q], h[c2]);
                }
              }
            }
          }
        }
        __syncwarp();
        // L y = g (k ascending), then L^T dz = y (a column at a time
        // from the last), each step's unknown times its diagonal's
        // reciprocal, shuffled from its thread
        const float inv = 1.0f / diag;
#pragma unroll
        for (int k = 0; k < kRowRegs; ++k) {
          if (k < n) {
            const float yk = __shfl_sync(0xffffffffu, gr * inv, k);
            if (r == k)
              gr = yk;
            else if (r > k && live)
              gr = __fmaf_rn(-h[k], yk, gr);
          }
        }
#pragma unroll
        for (int k = kRowRegs - 1; k >= 0; --k) {
          if (k < n) {
            const float zk = __shfl_sync(0xffffffffu, gr * inv, k);
            if (r == k)
              gr = zk;
            else if (r < k)
              gr = __fmaf_rn(-L[tri(k) + r], zk, gr);
          }
        }
        if (live) z[r] = z[r] - gr;
        __syncwarp();
      } else {
        for (int r = lane; r < n; r += 32) {
          g[r] = 0.0f;
          for (int c = 0; c <= r; ++c) L[tri(r) + c] = 0.0f;
        }
        for (int j0 = 0; j0 < ms; j0 += 32) {
          float res, d;
          sample(j0, res, d);
          const int cnt = ms - j0 < 32 ? ms - j0 : 32;
          for (int jj = 0; jj < cnt; ++jj) {
            const float rj = __shfl_sync(0xffffffffu, res, jj);
            const float dj = __shfl_sync(0xffffffffu, d, jj);
            const int js = j0 + jj;
            for (int r = lane; r < n; r += 32) {
              const float xr = M(js, r);
              g[r] = __fmaf_rn(rj, xr, g[r]);
              const float dx = dj * xr;
              float* hr = L + tri(r);
              for (int c = 0; c <= r; ++c)
                hr[c] = __fmaf_rn(dx, M(js, c), hr[c]);
            }
          }
        }
        for (int r = lane; r < n; r += 32) {
          g[r] = g[r] * inv_m + (z[r] - sv[r]) * inv_tp;
          float* hr = L + tri(r);
          for (int c = 0; c <= r; ++c)
            hr[c] = hr[c] * inv_m + (r == c ? inv_tp : 0.0f);
        }
        __syncwarp();
        // Cholesky on the packed rows in the slice, left-looking a column
        // at a time: the diagonal's sum of squares by the warp (lane l
        // takes k = l, l + 32, ..., then the shuffle tree), then each
        // thread's rows r > c: h_rc less the dot product of rows r and c
        // over k < c (kFactorSums partial sums), over the pivot.  (The
        // reference's sequence, every subtraction in k order, is kept at
        // n <= kRowRegs; over a hundred columns its float32 rounding
        // passes what the plain version's factorization leaves.)
        for (int c = 0; c < n; ++c) {
          const float* lc = L + tri(c);
          const float hcc = lc[c];
          float sq = 0.0f;
          for (int k = lane; k < c; k += 32) sq = __fmaf_rn(lc[k], lc[k], sq);
          const float piv = sqrtf(hcc - warp_sum(sq));
          for (int r = lane; r < n; r += 32) {
            if (r > c) {
              float* lr = L + tri(r);
              const float dot = dot_row<kFactorSums>(OneRow{lr}, 0, lc, c);
              lr[c] = (lr[c] - dot) / piv;
            } else if (r == c) {
              L[tri(c) + c] = piv;
            }
          }
          __syncwarp();
        }
        // the substitutions a row at a time, the row's products summed
        // by the warp: lane l takes k = l, l + 32, ... in order, then a
        // fixed shuffle tree
        for (int r = 0; r < n; ++r) {
          float acc = 0.0f;
          for (int k = lane; k < r; k += 32)
            acc = __fmaf_rn(L[tri(r) + k], g[k], acc);
          acc = warp_sum(acc);
          if (lane == 0) g[r] = (g[r] - acc) * (1.0f / L[tri(r) + r]);
          __syncwarp();
        }
        for (int r = n - 1; r >= 0; --r) {
          float acc = 0.0f;
          for (int k = r + 1 + lane; k < n; k += 32)
            acc = __fmaf_rn(L[tri(k) + r], g[k], acc);
          acc = warp_sum(acc);
          if (lane == 0) g[r] = (g[r] - acc) * (1.0f / L[tri(r) + r]);
          __syncwarp();
        }
        for (int r = lane; r < n; r += 32) z[r] = z[r] - g[r];
        __syncwarp();
      }
    }
    return to_f32(prm(0)[0]) > 0.0f ? z : sv;
  }
}

// The node update of node i (slots m) on its warp: D^T u, v, the prox,
// z = 2 w+ - w and the KM step, written to the carry or the outputs.
// Returns this thread's residual term over its features (0 without
// compute_residual).  Pointers are the lane's.
template <int LOSS, typename T, bool STAGED, bool ROWS, typename U>
__device__ float wide_node(const PdArgs& a, const Plan& p, float* s, int4 m,
                           long long i, int lane, bool in_carry,
                           bool out_carry, bool rounded_residual, const U* u,
                           long long u_rows, const T* w_in, float* w_carry,
                           float* z, T* w_out) {
  const int n = a.n;
  float* sw = s;
  float* sv = s + vec_floats(n);
  wide_gather<ROWS ? 1 : kWideChunk>(a, m, u, u_rows, sv, lane);
  const float tt = a.tau[i];
  for (int k = lane; k < n; k += 32) {
    const float wk = in_carry ? w_carry[i * n + k] : to_f32(w_in[i * n + k]);
    sw[k] = wk;
    sv[k] = wk - tt * sv[k];
  }
  __syncwarp();
  const float* wp = wide_prox<LOSS, T, STAGED, ROWS>(a, p, s, i, lane);
  float r = 0.0f;
  for (int k = lane; k < n; k += 32) {
    const float w = sw[k], wpk = wp[k];
    z[i * n + k] = 2.0f * wpk - w;
    float wn = a.relax ? w + a.rho * (wpk - w) : wpk;
    if (out_carry) {
      w_carry[i * n + k] = wn;
    } else {
      w_out[i * n + k] = from_f32<T>(wn);
      if (rounded_residual) wn = rounded<T>(wn);
    }
    if (a.compute_residual) r = fmaxf(r, fabsf(wn - w) / tt);
  }
  __syncwarp();  // the slice serves the warp's next node
  return r;
}

// The dual update of one feature: D(2w+ - w), the resolvent and the KM
// step (the register-tile kernel's edge_update, element by element).
__device__ __forceinline__ float edge_value(const PdArgs& a, float u0,
                                            float zs, float zd, float sg,
                                            float l, float scale) {
  const float x = u0 + sg * (zs - zd);
  const float up = a.reg_kind == 0 ? clip(x, l) : x * scale;
  float y = up;
  if (a.relax) {
    y = u0 + a.rho * (up - u0);
    if (a.reg_kind == 0) y = clip(y, l);
  }
  return y;
}

// The edge update of owned edge e on thread gl of its group of G: its
// features gl * 4 + 4 G c as vectors (vec), else gl + G c.  Returns the
// thread's residual term over its features.  Pointers are the lane's.
template <typename T>
__device__ __forceinline__ float wide_edge(
    const PdArgs& a, bool vec, int gl, int G, bool in_carry, bool out_carry,
    bool rounded_residual, long long u_off, long long e, long long s,
    long long d, float sg, float l, const T* u_in, float* u_carry,
    const float* z, T* u_out) {
  const int n = a.n;
  const float scale = l / (l + sg);
  float r = 0.0f;
  if (vec) {
    for (int k = gl * kEdgeVec; k < n; k += kEdgeVec * G) {
      float u0[4], zs[4], zd[4], y[4];
      if (in_carry)
        load4(u_carry + e * n + k, u0);
      else
        load4(u_in + (u_off + e) * n + k, u0);
      load4(z + s * n + k, zs);
      load4(z + d * n + k, zd);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        y[q] = edge_value(a, u0[q], zs[q], zd[q], sg, l, scale);
      if (out_carry) {
        store4(u_carry + e * n + k, y);
      } else {
        store4(u_out + e * n + k, y);
        if (rounded_residual) {
#pragma unroll
          for (int q = 0; q < 4; ++q) y[q] = rounded<T>(y[q]);
        }
      }
      if (a.compute_residual) {
#pragma unroll
        for (int q = 0; q < 4; ++q) r = fmaxf(r, fabsf(y[q] - u0[q]) / sg);
      }
    }
  } else {
    for (int k = gl; k < n; k += G) {
      const float u0 = in_carry ? u_carry[e * n + k]
                                : to_f32(u_in[(u_off + e) * n + k]);
      float y = edge_value(a, u0, z[s * n + k], z[d * n + k], sg, l, scale);
      if (out_carry) {
        u_carry[e * n + k] = y;
      } else {
        u_out[e * n + k] = from_f32<T>(y);
        if (rounded_residual) y = rounded<T>(y);
      }
      if (a.compute_residual) r = fmaxf(r, fabsf(y - u0) / sg);
    }
  }
  return r;
}

// Resident blocks per SM the register budget must allow, measured at
// 1M nodes and n = 32 (PERF.md section 6): 4 blocks of 256 threads (64
// registers) for the squared loss, 3 (80) for the others: each gained
// 10-20% a step over 3 and 2 (the latter's ptxas counts: 79 and 95-123).
template <int LOSS>
constexpr int wide_min_blocks() {
  return LOSS == kSquared ? 4 : 3;
}

// ROWS: n <= kRowRegs (the prox's rows in registers, the gather a
// feature a lane).  MULTI / STAGED as in pd_step_impl.cuh.
template <int LOSS, typename T, bool MULTI, bool STAGED, bool ROWS>
__global__ void __launch_bounds__(kThreads,
                                  wide_min_blocks<LOSS>())
fused_pd_step_wide_kernel(PdArgs a, Plan p) {
  // the stop word (see pd_step_impl.cuh)
  if (a.active != nullptr && *a.active == 0) return;
  cg::grid_group grid = cg::this_grid();
  // the node warps' slices, then (lanes > 1) the lanes' residual maxima
  extern __shared__ __align__(16) float smem[];
  const int n = a.n;
  const T* w_store = static_cast<const T*>(a.w_in);
  const T* u_store = static_cast<const T*>(a.u_in);
  T* w_out = static_cast<T*>(a.w_out);
  T* u_out = static_cast<T*>(a.u_out);
  const bool rounded_residual = a.iters == 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int num_lanes = MULTI ? (int)a.num_lanes : 1;
  const long long z_lane = a.num_nodes * n;
  float* slice = smem + (long long)warp * p.scratch;
  float* lane_res = smem + p.res_offset;
  if constexpr (MULTI) {
    for (int l = threadIdx.x; l < num_lanes; l += kThreads)
      lane_res[l] = 0.0f;
    __syncthreads();
  }
  float rmax = 0.0f;
  const int mp = mat_param(LOSS);
  const int mrows = mat_rows(LOSS, n, a.num_samples);
  float* mat = slice + wide_mat_offset(LOSS, n);
  const bool vec_edge = (p.vec & kVecEdge) != 0;
  const bool vec_stage = (p.vec & kVecStage) != 0;
  const int G = p.lanes;
  const long long node_warps = (long long)gridDim.x * p.nw;
  const long long groups = (long long)gridDim.x * (kThreads / G);

  for (int it = 0; it < a.iters; ++it) {
    const bool in_carry = it > 0;
    const bool out_carry = it + 1 < a.iters;
    const long long u_off = in_carry ? 0 : a.u_offset;
    const long long u_rows = in_carry ? a.num_edges : a.u_rows;

    // ---- node phase: a node a warp, each warp its own stream ----------
    if (warp < p.nw) {
      for (long long i = (long long)blockIdx.x * p.nw + warp;
           i < a.num_nodes; i += node_warps) {
        int4 m;
        m.x = a.in_ptr[i];
        m.y = a.in_ptr[i + 1] - m.x;
        const int2 run = reinterpret_cast<const int2*>(a.out_run)[i];
        m.z = run.x;
        m.w = run.y;
        if constexpr (STAGED) {
          stage_rows<T>(static_cast<const T*>(a.prm[mp]) + i * p.elems[mp],
                        mrows, n, n | 1, mat, vec_stage, lane);
          __syncwarp();
        }
        // the staged matrix serves every lane in turn
        for (int l = 0; l < num_lanes; ++l) {
          float r;
          if (in_carry)
            r = wide_node<LOSS, T, STAGED, ROWS>(
                a, p, slice, m, i, lane, in_carry, out_carry,
                rounded_residual, a.u_carry + l * a.uc_lane, u_rows,
                w_store + l * a.w_in_lane, a.w_carry + l * a.wc_lane,
                a.z + l * z_lane, w_out + l * a.w_out_lane);
          else
            r = wide_node<LOSS, T, STAGED, ROWS>(
                a, p, slice, m, i, lane, in_carry, out_carry,
                rounded_residual, u_store + l * a.u_in_lane, u_rows,
                w_store + l * a.w_in_lane, a.w_carry + l * a.wc_lane,
                a.z + l * z_lane, w_out + l * a.w_out_lane);
          if constexpr (MULTI) {
            if (a.compute_residual) warp_max_into(r, lane_res + l);
          } else {
            rmax = fmaxf(rmax, r);
          }
        }
      }
    }
    grid.sync();

    // ---- edge phase: D(2w+ - w), dual resolvent, KM; G threads an edge -
    const int gl = threadIdx.x & (G - 1);
    if constexpr (MULTI) {
      // the edge's columns once for every lane; a warp-uniform trip
      // count, since every lane's residual is a warp max
      for (long long e0 = (long long)blockIdx.x * (kThreads / G);
           e0 < a.num_edges; e0 += groups) {
        const long long e = e0 + threadIdx.x / G;
        const bool live = e < a.num_edges;
        long long s = 0, d = 0;
        float sg = 1.0f;
        if (live) {
          s = a.src[e];
          d = a.dst[e];
          sg = a.sigma[e];
        }
        for (int l = 0; l < num_lanes; ++l) {
          float r = 0.0f;
          if (live)
            r = wide_edge<T>(a, vec_edge, gl, G, in_carry, out_carry,
                             rounded_residual, u_off, e, s, d, sg,
                             a.la[l * a.la_lane + e],
                             u_store + l * a.u_in_lane,
                             a.u_carry + l * a.uc_lane, a.z + l * z_lane,
                             u_out + l * a.u_out_lane);
          if (a.compute_residual) warp_max_into(r, lane_res + l);
        }
      }
    } else {
      for (long long e =
               ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
           e < a.num_edges; e += groups) {
        const float r = wide_edge<T>(
            a, vec_edge, gl, G, in_carry, out_carry, rounded_residual,
            u_off, e, a.src[e], a.dst[e], a.sigma[e], a.la[e], u_store,
            a.u_carry, a.z, u_out);
        rmax = fmaxf(rmax, r);
      }
    }
    if (it + 1 < a.iters) grid.sync();
  }

  if (a.compute_residual) {
    if constexpr (MULTI) {
      __syncthreads();
      for (int l = threadIdx.x; l < num_lanes; l += kThreads)
        atomicMax(reinterpret_cast<int*>(a.res + l),
                  __float_as_int(lane_res[l]));
    } else {
      for (int off = 16; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      __shared__ float warp_max[kWarps];
      if (lane == 0) warp_max[warp] = rmax;
      __syncthreads();
      if (threadIdx.x == 0) {
        float mx = 0.0f;
        for (int k = 0; k < kWarps; ++k) mx = fmaxf(mx, warp_max[k]);
        atomicMax(reinterpret_cast<int*>(a.res), __float_as_int(mx));
      }
    }
  }
  if (a.executions != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(a.executions, 1ULL);
}

template <int LOSS, typename T, bool MULTI, bool STAGED>
cudaError_t launch_wide(const PdArgs& args, cudaStream_t stream) {
  Plan plan;
  const long long smem = make_wide_plan<LOSS, MULTI>(args, plan, STAGED);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  if (args.n <= kRowRegs)
    return cooperative_launch(
        fused_pd_step_wide_kernel<LOSS, T, MULTI, STAGED, true>, args, plan,
        smem, stream);
  return cooperative_launch(
      fused_pd_step_wide_kernel<LOSS, T, MULTI, STAGED, false>, args, plan,
      smem, stream);
}

template <int LOSS, typename T, bool STAGED>
cudaError_t launch_wide_lanes(const PdArgs& a, cudaStream_t s) {
  if (a.num_lanes == 1) return launch_wide<LOSS, T, false, STAGED>(a, s);
  return launch_wide<LOSS, T, true, STAGED>(a, s);
}

// The wide variants of one loss (n > kTileFeatures) in storage type T,
// staged or streamed.
template <int LOSS, typename T>
cudaError_t dispatch_wide(const PdArgs& a, cudaStream_t s, bool staged) {
  if (a.n <= kTileFeatures || a.num_lanes < 1) return cudaErrorInvalidValue;
  return staged ? launch_wide_lanes<LOSS, T, true>(a, s)
                : launch_wide_lanes<LOSS, T, false>(a, s);
}

// The same in the launch's storage type.
template <int LOSS>
cudaError_t dispatch_wide(const PdArgs& a, cudaStream_t s, bool staged) {
  if (a.storage == kF32) return dispatch_wide<LOSS, float>(a, s, staged);
  if (a.storage == kBF16)
    return dispatch_wide<LOSS, __nv_bfloat16>(a, s, staged);
  return cudaErrorInvalidValue;
}

}  // namespace repro_pd
