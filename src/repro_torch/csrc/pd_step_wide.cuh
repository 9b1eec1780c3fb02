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
// Design.  A per-thread register tile of n floats does not scale (the
// logistic width-16 tile already takes 255 registers), so a node goes to
// one warp and its features are split across the warp's threads: thread
// l owns features l, l + 32, ...  The node's vectors (w, v, the prox's
// iterates, the logistic gradient, the sample's row and the lower
// triangle of its Hessian, n (n + 1) / 2 floats) live in that warp's
// slice of shared memory, so
// registers do not grow with n and any n runs, as long as one warp's
// slice fits a block (the wrapper refuses past it, naming the limit).
//   * D^T u: the warp walks the node's slots in order (in-edges, then the
//     out run), kUnroll rows in flight; thread l loads features l + 32 c
//     of each row, so a row of 32 float32 is one 128-byte load.  Up to
//     32 * kWideChunk features a pass; wider rows take more passes.
//   * squared P (v + b) and the lasso's Q z: a warp dot product per row
//     of P / Q (thread l takes columns l + 32 c, a fixed xor-shuffle tree
//     sums them), rows read from the staged tile or from device memory.
//   * logistic: per sample the warp's dot product gives the logit; each
//     thread updates its own entries of the gradient and of the packed
//     lower-triangle Hessian (entry e = r (r + 1) / 2 + c, thread e mod
//     32), samples in order; then a column-by-column Cholesky (each entry
//     as api/losses.py:_chol_solve computes it: s = h_rc - sum_k<c
//     h_rk h_ck, then sqrt or / h_cc) and the two triangular solves, a
//     column at a time across the warp.
//   * The edge phase and the KM relaxation keep the register-tile
//     kernel's structure: one thread an edge, its features in a loop.
//   * Parameters are staged in shared memory per tile where a tile of nw
//     nodes fits the plan (make_wide_plan), else read from device memory
//     (STAGED false); both read each value as to_f32 of its storage value
//     and run the same arithmetic, so they give the same bits.
// No float atomics: a node's sums run in a fixed order on one warp, so
// two launches, and lane l of a launch over lanes and a one-lane launch
// on its inputs, give bit-identical outputs.
//
// What bounds it: bytes for the squared loss (P alone is n^2 floats a
// node: 4 KB at n = 32, most of the step's traffic at that width); the
// lasso adds num_inner passes over Q, the logistic num_inner passes over
// the samples with n (n + 1) / 2 Hessian updates each.
#pragma once

#include "pd_step_impl.cuh"

namespace repro_pd {

constexpr int kWideChunk = 4;   // features a thread per gather pass

// The sum of x over the warp by a fixed xor-shuffle tree; every thread
// gets the same bits (float addition commutes).
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Shared floats of one warp's slice: w, v and the prox's vectors, and
// for the logistic loss the packed lower triangle of the Hessian.
inline long long wide_scratch(int loss, int n) {
  const long long nn = n;
  if (loss == kSquared) return 3 * nn;            // w, v + b, w+
  if (loss == kLasso) return 4 * nn;              // w, v, z, z next
  return 5 * nn + nn * (nn + 1) / 2;              // w, v, z, g, x_j, H
}

// The wide launch plan: nw node warps a block (8, 4, 2 or 1: as many
// slices as fit) and tiles of nw nodes, a node a warp, with (staged)
// each node's parameter rows in shared memory.  Within kSmemTarget where
// nw nodes fit it, else up to kSmemMax.  A node costs a warp n row dot
// products or more, so tiles of nw nodes spread the nodes over every
// block of the grid.  Returns the shared bytes; past kSmemMax the launch
// is refused (for the staged plan: the streamed one runs instead).
// Depends on the loss, n, the samples a node and the lane count alone,
// as make_plan does.
template <int LOSS, bool MULTI>
long long make_wide_plan(const PdArgs& a, Plan& p, bool staged) {
  stage_layout(LOSS, a.n, a.num_samples, p, staged);
  long long node_floats = 4;                      // the slots (an int4)
  if (staged)
    for (int k = 0; k < p.num_params; ++k) node_floats += p.stride[k];
  const long long slice = wide_scratch(LOSS, a.n);
  const long long fixed = MULTI ? a.num_lanes : 0;
  auto total = [&](long long nw, long long tile) {
    return 4 * (tile * node_floats + nw * slice + fixed);
  };
  int nw = kWarps;
  while (nw > 1 && total(nw, nw) > kSmemTarget) nw >>= 1;
  if (total(nw, nw) > kSmemTarget) {
    nw = kWarps;
    while (nw > 1 && total(nw, nw) > kSmemMax) nw >>= 1;
  }
  const int tile = nw;
  p.tile = tile;
  p.nw = nw;
  p.scratch = (int)slice;
  long long off = 4LL * tile;
  for (int k = 0; k < 6; ++k) {
    p.offset[k] = (int)off;
    if (staged && k < p.num_params) off += (long long)tile * p.stride[k];
  }
  p.scratch_offset = (int)off;
  off += nw * slice;
  p.res_offset = (int)off;
  off += fixed;
  p.num_tiles = (a.num_nodes + tile - 1) / tile;
  return off * 4;
}

// The prox of one node on its warp: v in sv (n floats), the parameter
// rows sp[k] (staged float32 or storage rows in device memory), the
// warp's slice s.  Returns the row of w+ (in the slice, or sv itself for
// an unlabeled lasso / logistic node).  Every thread of the warp calls
// it; it ends with the warp synchronised.
template <int LOSS, typename PT>
__device__ float* wide_prox(const PdArgs& a, const PT* const* sp, float* s,
                            float* sv, int lane) {
  const int n = a.n;
  if (LOSS == kSquared) {  // params ("b", "p"): P (v + b)
    const PT* b = sp[0];
    const PT* P = sp[1];
    float* wp = s + 2 * n;
    for (int k = lane; k < n; k += 32) sv[k] = sv[k] + to_f32(b[k]);
    __syncwarp();
    for (int j = 0; j < n; ++j) {
      const PT* row = P + (long long)j * n;
      float acc = 0.0f;
      for (int k = lane; k < n; k += 32) acc += to_f32(row[k]) * sv[k];
      acc = warp_sum(acc);
      if (lane == (j & 31)) wp[j] = acc;
    }
    __syncwarp();
    return wp;
  } else if (LOSS == kLasso) {
    // params ("labeled", "m", "q", "step", "tau", "xty")
    const float m = to_f32(sp[1][0]), step = to_f32(sp[3][0]),
                tp = to_f32(sp[4][0]);
    const PT* Q = sp[2];
    const PT* xty = sp[5];
    const float thr = a.alpha * step;
    float* z = s + 2 * n;
    float* zn = s + 3 * n;
    for (int k = lane; k < n; k += 32) z[k] = sv[k];
    __syncwarp();
    for (int it = 0; it < a.num_inner; ++it) {
      for (int j = 0; j < n; ++j) {
        const PT* row = Q + (long long)j * n;
        float qz = 0.0f;
        for (int k = lane; k < n; k += 32) qz += to_f32(row[k]) * z[k];
        qz = warp_sum(qz);
        if (lane == (j & 31)) {
          float g = 2.0f * (qz - to_f32(xty[j])) / m;
          g = g + (z[j] - sv[j]) / tp;
          const float x = z[j] - step * g;
          const float sgn = (float)(x > 0.0f) - (float)(x < 0.0f);
          zn[j] = sgn * fmaxf(fabsf(x) - thr, 0.0f);
        }
      }
      __syncwarp();
      float* t = z;
      z = zn;
      zn = t;
    }
    return to_f32(sp[0][0]) > 0.0f ? z : sv;
  } else {
    // params ("labeled", "m", "mask", "tau", "x", "y")
    const int ms = a.num_samples;
    const float m = to_f32(sp[1][0]), tp = to_f32(sp[3][0]);
    const PT* mask = sp[2];
    const PT* xs = sp[4];
    const PT* ys = sp[5];
    float* z = s + 2 * n;
    float* g = s + 3 * n;
    float* xj = s + 4 * n;                // the sample's row
    float* h = s + 5 * n;                 // h[r (r + 1) / 2 + c], c <= r
    const int tri = n * (n + 1) / 2;
    // this thread's first Hessian entry (lane) as (r0, c0)
    int r0 = 0, c0 = lane;
    while (c0 > r0) { c0 -= r0 + 1; ++r0; }
    for (int k = lane; k < n; k += 32) z[k] = sv[k];
    __syncwarp();
    for (int it = 0; it < a.num_inner; ++it) {
      for (int k = lane; k < n; k += 32) g[k] = 0.0f;
      for (int e = lane; e < tri; e += 32) h[e] = 0.0f;
      for (int j = 0; j < ms; ++j) {
        // the row once into the slice (coalesced), for the Hessian's
        // entries, whose (r, c) are any thread's features
        const PT* row = xs + (long long)j * n;
        float part = 0.0f;
        for (int k = lane; k < n; k += 32) {
          const float x = to_f32(row[k]);
          xj[k] = x;
          part += x * z[k];
        }
        const float logit = warp_sum(part);
        const float sg = 1.0f / (1.0f + expf(-logit));
        const float mk = to_f32(mask[j]);
        const float res = (sg - to_f32(ys[j])) * mk;
        const float d = (sg * (1.0f - sg)) * mk;
        for (int k = lane; k < n; k += 32) g[k] += res * xj[k];
        __syncwarp();
        int r = r0, c = c0;
        for (int e = lane; e < tri; e += 32) {
          h[e] += (d * xj[r]) * xj[c];
          c += 32;
          while (c > r) { c -= r + 1; ++r; }
        }
        __syncwarp();                     // the next sample's row
      }
      __syncwarp();
      for (int k = lane; k < n; k += 32)
        g[k] = g[k] / m + (z[k] - sv[k]) / tp;
      {
        int r = r0, c = c0;
        for (int e = lane; e < tri; e += 32) {
          h[e] = h[e] / m + (r == c ? 1.0f / tp : 0.0f);
          c += 32;
          while (c > r) { c -= r + 1; ++r; }
        }
      }
      __syncwarp();
      // Cholesky, a column at a time: the diagonal, then the column below
      for (int c = 0; c < n; ++c) {
        const int cc = c * (c + 1) / 2;
        if (lane == 0) {
          float sd = h[cc + c];
          for (int k = 0; k < c; ++k) sd -= h[cc + k] * h[cc + k];
          h[cc + c] = sqrtf(sd);
        }
        __syncwarp();
        for (int r = c + 1 + lane; r < n; r += 32) {
          const int rr = r * (r + 1) / 2;
          float sr = h[rr + c];
          for (int k = 0; k < c; ++k) sr -= h[rr + k] * h[cc + k];
          h[rr + c] = sr / h[cc + c];
        }
        __syncwarp();
      }
      // L y = g, then L^T dz = y (into g), a column at a time
      for (int k = 0; k < n; ++k) {
        const int kk = k * (k + 1) / 2;
        if (lane == 0) g[k] = g[k] / h[kk + k];
        __syncwarp();
        for (int r = k + 1 + lane; r < n; r += 32)
          g[r] -= h[r * (r + 1) / 2 + k] * g[k];
        __syncwarp();
      }
      for (int k = n - 1; k >= 0; --k) {
        const int kk = k * (k + 1) / 2;
        if (lane == 0) g[k] = g[k] / h[kk + k];
        __syncwarp();
        for (int r = lane; r < k; r += 32) g[r] -= h[kk + r] * g[k];
        __syncwarp();
      }
      for (int k = lane; k < n; k += 32) z[k] = z[k] - g[k];
      __syncwarp();
    }
    return to_f32(sp[0][0]) > 0.0f ? z : sv;
  }
}

// The node update of node i (tile slot q) on its warp: D^T u, v, the
// prox, z = 2 w+ - w and the KM step, written to the carry or the
// outputs.  Returns this thread's residual term over its features (0
// without compute_residual).  Pointers are the lane's.
template <int LOSS, typename T, bool STAGED, typename U>
__device__ float wide_node(const PdArgs& a, const Plan& p, const float* smem,
                           float* s, int q, long long i, int lane,
                           bool in_carry, bool out_carry,
                           bool rounded_residual, const U* u,
                           long long u_rows, const T* w_in, float* w_carry,
                           float* z, T* w_out) {
  const int n = a.n;
  float* sw = s;
  float* sv = s + n;
  const int4 m = reinterpret_cast<const int4*>(smem)[q];
  const int nin = m.y, first = m.z, deg = m.y + m.w;
  // D^T u into sv: in-edges (-1), then the out run (+1), slot order
  for (int f0 = 0; f0 < n; f0 += 32 * kWideChunk) {
    float acc[kWideChunk];
#pragma unroll
    for (int c = 0; c < kWideChunk; ++c) acc[c] = 0.0f;
    for (int s0 = 0; s0 < deg; s0 += kUnroll) {
      long long e[kUnroll];
#pragma unroll
      for (int t = 0; t < kUnroll; ++t) {
        const int sl = s0 + t;
        long long id = 0;
        if (sl < deg) id = sl < nin ? a.in_ids[m.x + sl] : first + (sl - nin);
        e[t] = id < 0 ? 0 : (id >= u_rows ? u_rows - 1 : id);
      }
      float r[kUnroll][kWideChunk];
#pragma unroll
      for (int t = 0; t < kUnroll; ++t) {
#pragma unroll
        for (int c = 0; c < kWideChunk; ++c) {
          const int k = f0 + lane + 32 * c;
          r[t][c] = (s0 + t < deg && k < n) ? to_f32(u[e[t] * n + k]) : 0.0f;
        }
      }
#pragma unroll
      for (int t = 0; t < kUnroll; ++t) {
        const int sl = s0 + t;
        if (sl < deg) {
#pragma unroll
          for (int c = 0; c < kWideChunk; ++c)
            acc[c] = sl < nin ? acc[c] - r[t][c] : acc[c] + r[t][c];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kWideChunk; ++c) {
      const int k = f0 + lane + 32 * c;
      if (k < n) sv[k] = acc[c];
    }
  }
  const float tt = a.tau[i];
  for (int k = lane; k < n; k += 32) {
    const float wk = in_carry ? w_carry[i * n + k] : to_f32(w_in[i * n + k]);
    sw[k] = wk;
    sv[k] = wk - tt * sv[k];
  }
  __syncwarp();
  const float* wp;
  if constexpr (STAGED) {
    const float* sp[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) sp[k] = smem + p.offset[k] + q * p.stride[k];
    wp = wide_prox<LOSS>(a, sp, s, sv, lane);
  } else {
    const T* sp[6];
#pragma unroll
    for (int k = 0; k < 6; ++k)
      sp[k] = k < p.num_params
                  ? static_cast<const T*>(a.prm[k]) + i * p.elems[k]
                  : nullptr;
    wp = wide_prox<LOSS>(a, sp, s, sv, lane);
  }
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

// The edge update of owned edge e, a feature at a time (the
// register-tile kernel's edge_update for any n).
template <typename T>
__device__ __forceinline__ float wide_edge(
    const PdArgs& a, bool in_carry, bool out_carry, bool rounded_residual,
    long long u_off, long long e, long long s, long long d, float sg,
    float l, const T* u_in, float* u_carry, const float* z, T* u_out) {
  const int n = a.n;
  const float scale = l / (l + sg);
  float r = 0.0f;
  for (int k = 0; k < n; ++k) {
    const float u0 = in_carry ? u_carry[e * n + k]
                              : to_f32(u_in[(u_off + e) * n + k]);
    const float x = u0 + sg * (z[s * n + k] - z[d * n + k]);
    const float up = a.reg_kind == 0 ? clip(x, l) : x * scale;
    float y = up;
    if (a.relax) {
      y = u0 + a.rho * (up - u0);
      if (a.reg_kind == 0) y = clip(y, l);
    }
    if (out_carry) {
      u_carry[e * n + k] = y;
    } else {
      u_out[e * n + k] = from_f32<T>(y);
      if (rounded_residual) y = rounded<T>(y);
    }
    if (a.compute_residual) r = fmaxf(r, fabsf(y - u0) / sg);
  }
  return r;
}

template <int LOSS, typename T, bool MULTI, bool STAGED>
__global__ void __launch_bounds__(kThreads, 1)
fused_pd_step_wide_kernel(PdArgs a, Plan p) {
  // the stop word (see pd_step_impl.cuh)
  if (a.active != nullptr && *a.active == 0) return;
  cg::grid_group grid = cg::this_grid();
  // the tile's slots, (staged) its parameter rows, the warps' slices,
  // then (lanes > 1) the lanes' residual maxima
  extern __shared__ __align__(16) float smem[];
  const int n = a.n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const T* w_store = static_cast<const T*>(a.w_in);
  const T* u_store = static_cast<const T*>(a.u_in);
  T* w_out = static_cast<T*>(a.w_out);
  T* u_out = static_cast<T*>(a.u_out);
  const bool rounded_residual = a.iters == 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int num_lanes = MULTI ? (int)a.num_lanes : 1;
  const long long z_lane = a.num_nodes * n;
  float* slice = smem + p.scratch_offset + (long long)warp * p.scratch;
  float* lane_res = smem + p.res_offset;
  if constexpr (MULTI) {
    for (int l = threadIdx.x; l < num_lanes; l += kThreads)
      lane_res[l] = 0.0f;
  }
  float rmax = 0.0f;

  for (int it = 0; it < a.iters; ++it) {
    const bool in_carry = it > 0;
    const bool out_carry = it + 1 < a.iters;
    const long long u_off = in_carry ? 0 : a.u_offset;
    const long long u_rows = in_carry ? a.num_edges : a.u_rows;

    // ---- node phase: a node a warp ------------------------------------
    for (long long tile = blockIdx.x; tile < p.num_tiles;
         tile += gridDim.x) {
      const long long node0 = tile * p.tile;
      const long long left = a.num_nodes - node0;
      const int cnt = left < p.tile ? (int)left : p.tile;
      stage_tile<T, STAGED>(a, p, smem, node0, cnt);
      __syncthreads();
      if (warp < p.nw) {
        // the staged slots and parameters serve every lane in turn
        for (int l = 0; l < num_lanes; ++l) {
          for (int q = warp; q < cnt; q += p.nw) {
            float r;
            if (in_carry)
              r = wide_node<LOSS, T, STAGED>(
                  a, p, smem, slice, q, node0 + q, lane, in_carry,
                  out_carry, rounded_residual, a.u_carry + l * a.uc_lane,
                  u_rows, w_store + l * a.w_in_lane,
                  a.w_carry + l * a.wc_lane, a.z + l * z_lane,
                  w_out + l * a.w_out_lane);
            else
              r = wide_node<LOSS, T, STAGED>(
                  a, p, smem, slice, q, node0 + q, lane, in_carry,
                  out_carry, rounded_residual, u_store + l * a.u_in_lane,
                  u_rows, w_store + l * a.w_in_lane,
                  a.w_carry + l * a.wc_lane, a.z + l * z_lane,
                  w_out + l * a.w_out_lane);
            if constexpr (MULTI) {
              if (a.compute_residual) warp_max_into(r, lane_res + l);
            } else {
              rmax = fmaxf(rmax, r);
            }
          }
        }
      }
      __syncthreads();  // the next tile overwrites shared memory
    }
    grid.sync();

    // ---- edge phase: D(2w+ - w), dual resolvent, KM -------------------
    if constexpr (MULTI) {
      for (long long e0 = (long long)blockIdx.x * blockDim.x;
           e0 < a.num_edges; e0 += stride) {
        const long long e = e0 + threadIdx.x;
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
            r = wide_edge<T>(a, in_carry, out_carry, rounded_residual,
                             u_off, e, s, d, sg, a.la[l * a.la_lane + e],
                             u_store + l * a.u_in_lane,
                             a.u_carry + l * a.uc_lane, a.z + l * z_lane,
                             u_out + l * a.u_out_lane);
          if (a.compute_residual) warp_max_into(r, lane_res + l);
        }
      }
    } else {
      for (long long e = tid0; e < a.num_edges; e += stride) {
        const float r = wide_edge<T>(
            a, in_carry, out_carry, rounded_residual, u_off, e, a.src[e],
            a.dst[e], a.sigma[e], a.la[e], u_store, a.u_carry, a.z, u_out);
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
  return cooperative_launch(fused_pd_step_wide_kernel<LOSS, T, MULTI, STAGED>,
                            args, plan, smem, stream);
}

template <int LOSS, typename T, bool STAGED>
cudaError_t launch_wide_lanes(const PdArgs& a, cudaStream_t s) {
  if (a.num_lanes == 1) return launch_wide<LOSS, T, false, STAGED>(a, s);
  return launch_wide<LOSS, T, true, STAGED>(a, s);
}

// The wide variants of one loss (n > kTileFeatures), staged or streamed.
template <int LOSS>
cudaError_t dispatch_wide(const PdArgs& a, cudaStream_t s, bool staged) {
  if (a.n <= kTileFeatures || a.num_lanes < 1) return cudaErrorInvalidValue;
  if (a.storage == kF32)
    return staged ? launch_wide_lanes<LOSS, float, true>(a, s)
                  : launch_wide_lanes<LOSS, float, false>(a, s);
  if (a.storage == kBF16)
    return staged ? launch_wide_lanes<LOSS, __nv_bfloat16, true>(a, s)
                  : launch_wide_lanes<LOSS, __nv_bfloat16, false>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace repro_pd
