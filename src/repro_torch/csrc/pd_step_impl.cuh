// Fused primal-dual step (paper Algorithm 1, eqs. 14-15) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pd_step.py:fused_pd_step
// (body _make_kernel).  Same storage contract as its plain version,
// src/repro_torch/kernels/ref.py:fused_pd_step_ref, on the edge-blocked
// layout of core/graph.py:EdgeBlockLayout, for every registered loss with
// the tv (clip) or tv2 (scaling) dual resolvent, in float32 or bfloat16
// storage.
//
// What it computes, per iteration, in float32 whatever the storage:
//   node phase, every layout node i < nb*BV:
//     dtu_i = sum of u over i's out-edges - sum of u over its in-edges
//     w+_i  = PU_i(w_i - tau_i dtu_i)   the loss's prox (LOSS below)
//     z_i   = 2 w+_i - w_i;  w_i <- w_i + rho (w+_i - w_i)  (KM, rho != 1)
//   edge phase, every owned edge e < nb*EB (storage row klo*EB + e):
//     u+_e  = R(u_e + sigma_e (z_src - z_dst))  R = clip to +-la_e (tv)
//                                               or u la/(la+sigma) (tv2)
//     u_e  <- P(u_e + rho (u+_e - u_e))         P = the clip again (tv)
//   and, with compute_residual, the running max of |dw|/tau, |du|/sigma.
//
// The loss prox (api/losses.py prox_apply, per node, v = w - tau dtu):
//   squared  (LOSS 0): P (v + b)                             ("b", "p")
//   lasso    (LOSS 1): num_inner ISTA steps from z = v,
//     z <- S_{alpha step}(z - step (2 (Q z - xty)/m + (z - v)/tau_p)),
//     then labeled ? z : v         ("labeled", "m", "q", "step", "tau", "xty")
//   logistic (LOSS 2): num_inner Newton steps from z = v: a loop over the
//     node's m samples (logit, sigmoid, masked residual, gradient and the
//     lower triangle of the Hessian sum d x x^T / m + I/tau_p), then the
//     unrolled Cholesky solve of api/losses.py:_chol_solve; then
//     labeled ? z : v              ("labeled", "m", "mask", "tau", "x", "y")
//
// Storage (template T = float or __nv_bfloat16): w, u and the float prox
// parameters are read as T and widened exactly; outputs are rounded to
// nearest even (as Tensor.to(bfloat16)); tau, sigma, la, z and the
// residual stay float32.  With iters == 1 the residual compares the
// storage-rounded outputs with the inputs, as the plain version does.
// With iters > 1 the iterations run through a float32 carry (w_carry,
// u_carry) and only the last one writes the storage type, so bf16 rounds
// once per launch as in the reference; the residual then compares the
// carry.  For float storage the wrapper points the carry at the outputs.
//
// Design.  One cooperative persistent launch (the occupancy query sizes
// the grid); a grid-wide barrier separates the node phase from the edge
// phase and one iteration from the next (the TPU kernel's in-kernel
// multi-iteration loop, only on a single-block layout).  A node writes
// only its own w and z rows and an edge only its own u row, and the
// barriers separate the phases, so the outputs may be the owned rows of
// the inputs: the solver updates its state in place.
//
//   * Compact incidence.  The kernel reads the layout's compact tables
//     (core/graph.py:compact_incidence), not the padded (V, max_deg) ones:
//     per node its in-edge ids (CSR, sign -1 implied) and its out-edges as
//     one run of consecutive storage ids (first, count), which the planner
//     guarantees because edges are sorted by src.  The out half of D^T u
//     is a stream of consecutive u rows that needs no id at all.
//   * Staged tiles.  The node phase walks tiles of `tile` nodes.  A
//     tile's rows are contiguous in every node table, so the block first
//     copies, with coalesced loads, each node's slots (in-slot offset and
//     count, out run) and its prox parameter rows into shared memory
//     (parameters as float32, each node's row padded to an odd number of
//     words, so one thread per node reads them without bank conflicts).
//     `tile` is the largest power of two up to 256 whose staging fits
//     kSmemTarget bytes.
//   * Cooperative gathers.  A group of `lanes` threads (a power of two
//     from the mean degree) takes one node: lane l takes the node's slots
//     l, l + lanes, ... (in-edges first, then the out run), kUnroll of
//     them per round with every id and row load issued before the first
//     add; the group sums with a fixed xor-shuffle tree, and each group
//     has two nodes in flight.  No float atomics: two launches on the
//     same inputs give bit-identical outputs.
//   * The prox runs one thread per node from shared memory (D^T u and the
//     parameters): the lasso's and logistic's inner loops re-read Q or
//     the samples from there, not through L1.
//   * Rows move as whole vectors (8 or 16 bytes; bf16 pairs in a word)
//     when n equals the register tile and every row pointer is 16-byte
//     aligned; otherwise element by element.
//   * Edge phase: one thread per owned edge, grid-stride.
//   * Lanes (num_lanes > 1: a lambda path, the grid axis jax.vmap adds to
//     the reference kernel).  L problems share the layout, the prox
//     parameters, tau and sigma; each has its own w, u, la, outputs,
//     carry, z and residual slot.  One cooperative launch covers them all,
//     the lanes as more work of the same grid (a cooperative grid is
//     capped by residency, so more blocks would not launch): each node
//     tile's slots, parameters and in-edge ids are staged once and serve
//     every lane in turn, and the edge phase reads an edge's columns once
//     and updates it in every lane.  The lane loop stays outside the
//     per-node register tile, so registers do not grow with L; the tile
//     and the gather's lanes do not depend on L, so lane l sums in the
//     order a one-lane launch on its inputs does (bit-identical).  Each
//     lane's residual is a warp max into a shared slot, then one
//     atomicMax per lane and block.  One lane runs the single-problem
//     instantiation (MULTI false), unchanged.
//
// Stop word.  A tolerance solve keeps a device flag (`active`) that it
// clears once a block's residual is <= tol; its graph engine runs no
// launch after that (engine/loop.py:device_loop), and its plain loop
// enqueues every block of the budget.  Every thread reads the flag first
// and, when it is clear, returns before the first grid sync: the launch
// writes nothing, so the state stays exactly as it is and nothing is
// read back to the host.
// The residual is a per-thread max, a block max, then an atomicMax on the
// float's bits (non-negative floats order like their bit patterns) into a
// scalar the wrapper zeroes.
//
// The feature count n is a runtime value held in a register tile of
// MAXN = 2, 4, 8 or 16; wider rows run the wide variant
// (pd_step_wide.cuh: a node a warp).  The logistic Hessian is MAXN
// (MAXN + 1) / 2 floats per thread, 136 at MAXN = 16.
//
// Streamed variant.  A logistic node whose samples pass the staging plan
// (more than ~14,500 at n = 2) runs pd_step_streamed.cuh's kernel: this
// kernel's node phase and edge phase, with a block a labeled node that
// splits its samples over its threads.  Its sums run in another order, so
// where both variants apply they agree to float32 rounding, not bit for
// bit.
//
// What bounds it: bytes for the squared loss (a few flops per byte); the
// lasso and logistic inner loops add num_inner passes of n^2 (lasso) or
// m n^2 (logistic) flops per node over parameters already staged.  The
// function must move the compact incidence (an int32 per in-edge, two per
// node and the row offsets: about 53 MB at the 1M-node scale-out graph
// with its ~10.2M edges), the u rows of both ends of every edge, w, tau,
// the prox parameters, the edge columns (src, dst, sigma, la: 16 bytes an
// edge) and the outputs.  The in-edge gathers are random rows: each costs
// a 32-byte sector where it misses L2.  Measured at that size (PERF.md
// §6, chip_smoke.py --ab): the edge phase streams at ~2.2 TB/s; the node
// phase stays well short of its bytes, held by the latency of its
// dependent loads (slots, then ids, then rows), which only resident
// warps hide (min_blocks below), and in float32 by in-edge rows that
// miss L2.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "pd_step.cuh"

namespace repro_pd {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 256;            // nodes per tile
constexpr int kSmemTarget = 48 * 1024;   // staged bytes per block
// the kernel's static shared memory: the residual's warp maxima
constexpr int kSmemStatic = kWarps * (int)sizeof(float);
// the most a block may stage: the shared memory it can opt in to, less
// the static part
constexpr int kSmemMax = 227 * 1024 - kSmemStatic;
// what a block gets without opting in, less the static part (rounded)
constexpr int kSmemDefault = 48 * 1024 - 1024;
constexpr int kUnroll = 4;               // gather loads per lane per round
constexpr int kTileFeatures = 16;        // the widest register tile

// Per-launch plan, computed on the host from the arguments.
struct Plan {
  long long num_tiles;
  int tile;          // nodes per tile
  int lanes;         // threads per node in the gather (power of two)
  int vec;           // rows move as whole vectors
  int num_params;
  int doffset;       // shared float offset of D^T u (node slots before it)
  int dstride;       // shared floats per node of D^T u
  int elems[6];      // elements per node of each prox parameter
  int stride[6];     // shared floats per node of each (elems | 1)
  int offset[6];     // shared float offset of each
  // lanes > 1 only (0 otherwise): a tile's in-edge ids staged once for
  // every lane (up to ids_cap of them), and the lanes' residual maxima
  int ids_cap;
  int ids_offset;    // shared float offset of the staged ids
  int res_offset;    // shared float offset of num_lanes residual maxima
  // the wide variant (pd_step_wide.cuh): nw node warps a block, each
  // with `scratch` shared floats (its slice); `lanes` and `vec` are its
  // edge group and vector bits there (scratch_offset unused)
  int nw;
  int scratch;
  int scratch_offset;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to the storage type and widened again
template <typename T> __device__ __forceinline__ float rounded(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float clip(float x, float l) {
  return fminf(fmaxf(x, -l), l);
}

// ---- row I/O: MAXN elements as 32-bit words, in 16/8/4-byte vectors ----
template <int W>
__device__ __forceinline__ void load_words(const void* p, unsigned (&w)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int c = 0; c < W / 4; ++c) {
      const uint4 q = static_cast<const uint4*>(p)[c];
      w[4 * c] = q.x; w[4 * c + 1] = q.y; w[4 * c + 2] = q.z;
      w[4 * c + 3] = q.w;
    }
  } else if constexpr (W % 2 == 0) {
#pragma unroll
    for (int c = 0; c < W / 2; ++c) {
      const uint2 q = static_cast<const uint2*>(p)[c];
      w[2 * c] = q.x; w[2 * c + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < W; ++c) w[c] = static_cast<const unsigned*>(p)[c];
  }
}

template <int W>
__device__ __forceinline__ void store_words(void* p, const unsigned (&w)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int c = 0; c < W / 4; ++c)
      static_cast<uint4*>(p)[c] = make_uint4(w[4 * c], w[4 * c + 1],
                                             w[4 * c + 2], w[4 * c + 3]);
  } else if constexpr (W % 2 == 0) {
#pragma unroll
    for (int c = 0; c < W / 2; ++c)
      static_cast<uint2*>(p)[c] = make_uint2(w[2 * c], w[2 * c + 1]);
  } else {
#pragma unroll
    for (int c = 0; c < W; ++c) static_cast<unsigned*>(p)[c] = w[c];
  }
}

// One row of n (<= MAXN) elements into r, zero past n.  `vec` promises
// n == MAXN and an aligned row.
template <int MAXN>
__device__ __forceinline__ void load_row(const float* p, int n, bool vec,
                                         float (&r)[MAXN]) {
  if (vec) {
    unsigned w[MAXN];
    load_words<MAXN>(p, w);
#pragma unroll
    for (int k = 0; k < MAXN; ++k) r[k] = __uint_as_float(w[k]);
  } else {
#pragma unroll
    for (int k = 0; k < MAXN; ++k) r[k] = k < n ? p[k] : 0.0f;
  }
}

template <int MAXN>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, int n,
                                         bool vec, float (&r)[MAXN]) {
  if (vec) {  // element 2j in the low half of word j
    unsigned w[MAXN / 2];
    load_words<MAXN / 2>(p, w);
#pragma unroll
    for (int j = 0; j < MAXN / 2; ++j) {
      r[2 * j] = __uint_as_float(w[j] << 16);
      r[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int k = 0; k < MAXN; ++k) r[k] = k < n ? to_f32(p[k]) : 0.0f;
  }
}

template <int MAXN>
__device__ __forceinline__ void store_row(float* p, int n, bool vec,
                                          const float (&r)[MAXN]) {
  if (vec) {
    unsigned w[MAXN];
#pragma unroll
    for (int k = 0; k < MAXN; ++k) w[k] = __float_as_uint(r[k]);
    store_words<MAXN>(p, w);
  } else {
#pragma unroll
    for (int k = 0; k < MAXN; ++k)
      if (k < n) p[k] = r[k];
  }
}

template <int MAXN>
__device__ __forceinline__ void store_row(__nv_bfloat16* p, int n, bool vec,
                                          const float (&r)[MAXN]) {
  if (vec) {
    unsigned w[MAXN / 2];
#pragma unroll
    for (int j = 0; j < MAXN / 2; ++j)
      w[j] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(r[2 * j]))
             | ((unsigned)__bfloat16_as_ushort(
                    __float2bfloat16_rn(r[2 * j + 1])) << 16);
    store_words<MAXN / 2>(p, w);
  } else {
#pragma unroll
    for (int k = 0; k < MAXN; ++k)
      if (k < n) p[k] = __float2bfloat16_rn(r[k]);
  }
}

// ---- node phase pieces -------------------------------------------------

// Stage the tile of nodes [node0, node0 + cnt) in shared memory: each
// node's slots (in-slot offset and count, out run: an int4 at slots[q];
// zero past cnt), and (STAGED) its prox parameter rows as float32, node
// q's row of parameter k at smem[offset[k] + q * stride[k]]: coalesced
// reads of one contiguous span per table.
template <typename T, bool STAGED = true>
__device__ __forceinline__ void stage_tile(const PdArgs& a, const Plan& p,
                                           float* smem, long long node0,
                                           int cnt) {
  int4* slots = reinterpret_cast<int4*>(smem);
  for (int q = threadIdx.x; q < p.tile; q += kThreads) {
    int4 m = make_int4(0, 0, 0, 0);
    if (q < cnt) {
      const long long i = node0 + q;
      m.x = a.in_ptr[i];
      m.y = a.in_ptr[i + 1] - m.x;
      const int2 run = reinterpret_cast<const int2*>(a.out_run)[i];
      m.z = run.x;
      m.w = run.y;
    }
    slots[q] = m;
  }
  if constexpr (STAGED) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {  // unrolled: the plan stays in registers
      if (k >= p.num_params) break;
      const int el = p.elems[k], st = p.stride[k];
      const T* g = static_cast<const T*>(a.prm[k]) + node0 * el;
      float* s = smem + p.offset[k];
      const int total = cnt * el;
      for (int j = threadIdx.x; j < total; j += kThreads) {
        const int q = j / el;
        s[q * st + (j - q * el)] = to_f32(g[j]);
      }
    }
  }
}

// This lane's share of D^T u for the node with staged slots m (lane of
// `lanes`): slots lane, lane + lanes, ... of its in-edges (-1) then its
// out run (+1), summed in that order; kUnroll slots per round, all loads
// issued first.  In-edge slot j is ids[j - ids_base]: the compact table
// itself (ids_base 0), or the tile's ids staged in shared memory.
template <int MAXN, typename U>
__device__ __forceinline__ void gather_share(const PdArgs& a, const int* ids,
                                             int ids_base, const U* u,
                                             long long u_rows, bool vec,
                                             int4 m, int lane, int lanes,
                                             float (&acc)[MAXN]) {
  const int n = a.n;
#pragma unroll
  for (int k = 0; k < MAXN; ++k) acc[k] = 0.0f;
  const int p0 = m.x - ids_base, nin = m.y, first = m.z;
  const int deg = nin + m.w;
  for (int s0 = lane; s0 < deg; s0 += kUnroll * lanes) {
    int e[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const int s = s0 + q * lanes;
      const int id = s < nin ? ids[p0 + s] : first + (s - nin);
      e[q] = id < 0 ? 0 : (id >= u_rows ? (int)(u_rows - 1) : id);
    }
    float r[kUnroll][MAXN];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q)
      if (s0 + q * lanes < deg)
        load_row<MAXN>(u + (long long)e[q] * n, n, vec, r[q]);
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const int s = s0 + q * lanes;
      if (s < deg) {
#pragma unroll
        for (int k = 0; k < MAXN; ++k)
          acc[k] = s < nin ? acc[k] - r[q][k] : acc[k] + r[q][k];
      }
    }
  }
}

// PU_i(v) of the loss into wp (n live entries of MAXN, zero past n), from
// the node's parameter rows sp[k], staged as float32 in shared memory.
template <int MAXN, int LOSS, typename PT>
__device__ __forceinline__ void prox(const PdArgs& a,
                                     const PT* const* sp,
                                     const float (&v)[MAXN],
                                     float (&wp)[MAXN]) {
  const int n = a.n;
  if (LOSS == kSquared) {  // params ("b", "p"): P (v + b)
    const PT* b = sp[0];
    const PT* P = sp[1];
    float vb[MAXN];
#pragma unroll
    for (int k = 0; k < MAXN; ++k) vb[k] = k < n ? v[k] + to_f32(b[k]) : 0.0f;
#pragma unroll
    for (int j = 0; j < MAXN; ++j) {
      float s = 0.0f;
      if (j < n) {
#pragma unroll
        for (int k = 0; k < MAXN; ++k)
          if (k < n) s += to_f32(P[j * n + k]) * vb[k];
      }
      wp[j] = s;
    }
  } else if (LOSS == kLasso) {
    // params ("labeled", "m", "q", "step", "tau", "xty")
    const float m = to_f32(sp[1][0]), step = to_f32(sp[3][0]),
                tp = to_f32(sp[4][0]);
    const PT* Q = sp[2];
    const PT* xty = sp[5];
    const float thr = a.alpha * step;
    float z[MAXN];
#pragma unroll
    for (int k = 0; k < MAXN; ++k) z[k] = v[k];
    for (int it = 0; it < a.num_inner; ++it) {
      float zn[MAXN];
#pragma unroll
      for (int j = 0; j < MAXN; ++j) {
        if (j < n) {
          float qz = 0.0f;
#pragma unroll
          for (int k = 0; k < MAXN; ++k)
            if (k < n) qz += to_f32(Q[j * n + k]) * z[k];
          float g = 2.0f * (qz - to_f32(xty[j])) / m;
          g = g + (z[j] - v[j]) / tp;
          const float x = z[j] - step * g;
          const float sgn = (float)(x > 0.0f) - (float)(x < 0.0f);
          zn[j] = sgn * fmaxf(fabsf(x) - thr, 0.0f);
        } else {
          zn[j] = 0.0f;
        }
      }
#pragma unroll
      for (int k = 0; k < MAXN; ++k) z[k] = zn[k];
    }
    const bool lab = to_f32(sp[0][0]) > 0.0f;
#pragma unroll
    for (int k = 0; k < MAXN; ++k) wp[k] = lab ? z[k] : v[k];
  } else {
    // params ("labeled", "m", "mask", "tau", "x", "y")
    const int ms = a.num_samples;
    const float m = to_f32(sp[1][0]), tp = to_f32(sp[3][0]);
    const PT* mask = sp[2];
    const PT* xs = sp[4];
    const PT* ys = sp[5];
    float z[MAXN];
#pragma unroll
    for (int k = 0; k < MAXN; ++k) z[k] = v[k];
    for (int it = 0; it < a.num_inner; ++it) {
      float g[MAXN], h[MAXN][MAXN];
#pragma unroll
      for (int r = 0; r < MAXN; ++r) {
        g[r] = 0.0f;
#pragma unroll
        for (int c = 0; c <= r; ++c) h[r][c] = 0.0f;
      }
      for (int j = 0; j < ms; ++j) {
        const PT* row = xs + (long long)j * n;
        float x[MAXN];
        float logit = 0.0f;
#pragma unroll
        for (int k = 0; k < MAXN; ++k) {
          if (k < n) {
            x[k] = to_f32(row[k]);
            logit += x[k] * z[k];
          }
        }
        const float s = 1.0f / (1.0f + expf(-logit));
        const float mk = to_f32(mask[j]);
        const float res = (s - to_f32(ys[j])) * mk;
        const float d = (s * (1.0f - s)) * mk;
#pragma unroll
        for (int r = 0; r < MAXN; ++r) {
          if (r < n) {
            g[r] += res * x[r];
#pragma unroll
            for (int c = 0; c <= r; ++c) h[r][c] += (d * x[r]) * x[c];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < MAXN; ++r) {
        if (r < n) {
          g[r] = g[r] / m + (z[r] - v[r]) / tp;
#pragma unroll
          for (int c = 0; c <= r; ++c)
            h[r][c] = h[r][c] / m + (r == c ? 1.0f / tp : 0.0f);
        }
      }
      // Cholesky-Banachiewicz in place on the lower triangle
#pragma unroll
      for (int r = 0; r < MAXN; ++r) {
        if (r < n) {
#pragma unroll
          for (int c = 0; c <= r; ++c) {
            float s = h[r][c];
#pragma unroll
            for (int k = 0; k < c; ++k) s -= h[r][k] * h[c][k];
            h[r][c] = r == c ? sqrtf(s) : s / h[c][c];
          }
        }
      }
      // forward substitution L c = g (into g), back substitution L^T dz = c
#pragma unroll
      for (int r = 0; r < MAXN; ++r) {
        if (r < n) {
          float s = g[r];
#pragma unroll
          for (int k = 0; k < r; ++k) s -= h[r][k] * g[k];
          g[r] = s / h[r][r];
        }
      }
#pragma unroll
      for (int r = MAXN - 1; r >= 0; --r) {
        if (r < n) {
          float s = g[r];
#pragma unroll
          for (int k = r + 1; k < MAXN; ++k)
            if (k < n) s -= h[k][r] * g[k];
          g[r] = s / h[r][r];
        }
      }
#pragma unroll
      for (int k = 0; k < MAXN; ++k)
        if (k < n) z[k] = z[k] - g[k];
    }
    const bool lab = to_f32(sp[0][0]) > 0.0f;
#pragma unroll
    for (int k = 0; k < MAXN; ++k) wp[k] = lab ? z[k] : (k < n ? v[k] : 0.0f);
  }
}

// The node update of node i (thread t of its tile) after the tile's D^T u
// is in shared memory: v = w - tau D^T u, the prox (parameters staged),
// z = 2 w+ - w and the KM step, written to the carry or the outputs.
// Returns the node's residual term (0 without compute_residual).
// Pointers are the lane's.
template <int MAXN, int LOSS, typename T>
__device__ __forceinline__ float node_update(
    const PdArgs& a, const Plan& p, const float* smem, bool vec,
    bool in_carry, bool out_carry, bool rounded_residual, long long i,
    int t, const T* w_in, float* w_carry, float* z, T* w_out) {
  const int n = a.n;
  float w[MAXN], v[MAXN], wp[MAXN], zr[MAXN], wn[MAXN];
  if (in_carry)
    load_row<MAXN>(w_carry + i * n, n, vec, w);
  else
    load_row<MAXN>(w_in + i * n, n, vec, w);
  const float tt = a.tau[i];
#pragma unroll
  for (int k = 0; k < MAXN; ++k)
    v[k] = k < n ? w[k] - tt * smem[p.doffset + t * p.dstride + k] : 0.0f;
  const float* sp[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) sp[k] = smem + p.offset[k] + t * p.stride[k];
  prox<MAXN, LOSS>(a, sp, v, wp);
#pragma unroll
  for (int j = 0; j < MAXN; ++j) {
    zr[j] = 2.0f * wp[j] - w[j];
    wn[j] = a.relax ? w[j] + a.rho * (wp[j] - w[j]) : wp[j];
  }
  store_row<MAXN>(z + i * n, n, vec, zr);
  if (out_carry) {
    store_row<MAXN>(w_carry + i * n, n, vec, wn);
  } else {
    store_row<MAXN>(w_out + i * n, n, vec, wn);
    if (rounded_residual) {
#pragma unroll
      for (int j = 0; j < MAXN; ++j) wn[j] = rounded<T>(wn[j]);
    }
  }
  float r = 0.0f;
  if (a.compute_residual) {
#pragma unroll
    for (int j = 0; j < MAXN; ++j)
      if (j < n) r = fmaxf(r, fabsf(wn[j] - w[j]) / tt);
  }
  return r;
}

// The edge update of owned edge e (src s, dst d, dual step sg, level l):
// D(2w+ - w), the dual resolvent and the KM step, written to the carry or
// the outputs.  Returns the edge's residual term.  Pointers are the lane's.
template <int MAXN, typename T>
__device__ __forceinline__ float edge_update(
    const PdArgs& a, bool vec, bool in_carry, bool out_carry,
    bool rounded_residual, long long u_off, long long e, long long s,
    long long d, float sg, float l, const T* u_in, float* u_carry,
    const float* z, T* u_out) {
  const int n = a.n;
  const float scale = l / (l + sg);
  float u0[MAXN], zs[MAXN], zd[MAXN], y[MAXN];
  if (in_carry)
    load_row<MAXN>(u_carry + e * n, n, vec, u0);
  else
    load_row<MAXN>(u_in + (u_off + e) * n, n, vec, u0);
  load_row<MAXN>(z + s * n, n, vec, zs);
  load_row<MAXN>(z + d * n, n, vec, zd);
#pragma unroll
  for (int k = 0; k < MAXN; ++k) {
    const float x = u0[k] + sg * (zs[k] - zd[k]);
    const float up = a.reg_kind == 0 ? clip(x, l) : x * scale;
    float yk = up;
    if (a.relax) {
      yk = u0[k] + a.rho * (up - u0[k]);
      if (a.reg_kind == 0) yk = clip(yk, l);
    }
    y[k] = yk;
  }
  if (out_carry) {
    store_row<MAXN>(u_carry + e * n, n, vec, y);
  } else {
    store_row<MAXN>(u_out + e * n, n, vec, y);
    if (rounded_residual) {
#pragma unroll
      for (int k = 0; k < MAXN; ++k) y[k] = rounded<T>(y[k]);
    }
  }
  float r = 0.0f;
  if (a.compute_residual) {
#pragma unroll
    for (int k = 0; k < MAXN; ++k)
      if (k < n) r = fmaxf(r, fabsf(y[k] - u0[k]) / sg);
  }
  return r;
}

// The warp's max of r into the shared slot (every lane of the warp calls
// it; non-negative floats order like their bit patterns).
__device__ __forceinline__ void warp_max_into(float r, float* slot) {
  for (int off = 16; off > 0; off >>= 1)
    r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, off));
  if ((threadIdx.x & 31) == 0)
    atomicMax(reinterpret_cast<int*>(slot), __float_as_int(r));
}

// The sum of x over the warp by a fixed xor-shuffle tree; every thread
// gets the same bits (float addition commutes).
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Resident blocks per SM the register budget must allow.  The squared
// loss's node phase is latency-bound gathers, which occupancy hides (5
// blocks: 48 registers at n <= 2); the lasso's and logistic's proxes
// spill under such a cap and lose more than the gathers gain.  The lane
// loop needs a few registers more (its lane offsets): for the squared
// loss one block fewer, as spilling in the lane loop costs more than the
// block (measured at 1M, PERF.md); the lasso's lane kernel at n <= 4
// lands just past 3 blocks' registers (88), and the cap that restores
// the third block pays off (PERF.md).
template <int MAXN, int LOSS, bool MULTI> constexpr int min_blocks() {
  if (LOSS == kSquared)
    return MAXN <= 2 ? 5 - MULTI : (MAXN <= 4 ? 4 - MULTI : 1);
  return LOSS == kLasso && MULTI && MAXN <= 4 ? 3 : 1;
}

// MULTI: a launch over num_lanes > 1 lanes.  The one-lane instantiation
// (MULTI false) is the kernel of a single problem: its lane loops run once
// with every lane offset 0, and its residual is one register max.
template <int MAXN, int LOSS, typename T, bool MULTI>
__global__ void __launch_bounds__(kThreads, min_blocks<MAXN, LOSS, MULTI>())
fused_pd_step_kernel(PdArgs a, Plan p) {
  // the stop word: a stopped tol solve writes nothing (uniform: every
  // thread returns before the first grid sync)
  if (a.active != nullptr && *a.active == 0) return;
  cg::grid_group grid = cg::this_grid();
  // the tile: node slots, D^T u, the staged parameters, then (lanes > 1)
  // the staged in-edge ids and the lanes' residual maxima
  extern __shared__ __align__(16) float smem[];
  const int n = a.n;
  const bool vec = p.vec != 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const T* w_store = static_cast<const T*>(a.w_in);
  const T* u_store = static_cast<const T*>(a.u_in);
  T* w_out = static_cast<T*>(a.w_out);
  T* u_out = static_cast<T*>(a.u_out);
  const bool rounded_residual = a.iters == 1;
  const int lanes = p.lanes, lane = threadIdx.x & (lanes - 1);
  const int groups = kThreads / lanes;
  const int num_lanes = MULTI ? (int)a.num_lanes : 1;
  const long long z_lane = a.num_nodes * n;
  float* lane_res = smem + p.res_offset;
  if constexpr (MULTI) {
    // read only after a __syncthreads or grid sync below
    for (int l = threadIdx.x; l < num_lanes; l += kThreads)
      lane_res[l] = 0.0f;
  }
  float rmax = 0.0f;

  for (int it = 0; it < a.iters; ++it) {
    const bool in_carry = it > 0;             // read the f32 carry
    const bool out_carry = it + 1 < a.iters;  // write the f32 carry
    const long long u_off = in_carry ? 0 : a.u_offset;
    const long long u_rows = in_carry ? a.num_edges : a.u_rows;

    // ---- node phase: gather D^T u, loss prox, z, KM ------------------
    for (long long tile = blockIdx.x; tile < p.num_tiles;
         tile += gridDim.x) {
      const long long node0 = tile * p.tile;
      const long long left = a.num_nodes - node0;
      const int cnt = left < p.tile ? (int)left : p.tile;
      stage_tile<T>(a, p, smem, node0, cnt);
      const int* ids = a.in_ids;
      int ids_base = 0;
      if constexpr (MULTI) {
        // the tile's in-edge ids once for every lane, when they fit
        const int first = a.in_ptr[node0];
        const int count = a.in_ptr[node0 + cnt] - first;
        if (count <= p.ids_cap) {
          int* staged = reinterpret_cast<int*>(smem + p.ids_offset);
          for (int j = threadIdx.x; j < count; j += kThreads)
            staged[j] = a.in_ids[first + j];
          ids = staged;
          ids_base = first;
        }
      }
      __syncthreads();
      // the staged slots, ids and parameters serve every lane in turn
      for (int l = 0; l < num_lanes; ++l) {
        const T* u_l = u_store + l * a.u_in_lane;
        float* uc_l = a.u_carry + l * a.uc_lane;
        // warp-uniform trip count: p.tile is a multiple of a warp's
        // groups; two nodes' gathers in flight per group
#pragma unroll 2
        for (int q = threadIdx.x / lanes; q < p.tile; q += groups) {
          const int4 m = reinterpret_cast<const int4*>(smem)[q];
          float acc[MAXN];
          if (in_carry)
            gather_share<MAXN>(a, ids, ids_base, uc_l, u_rows, vec, m,
                               lane, lanes, acc);
          else
            gather_share<MAXN>(a, ids, ids_base, u_l, u_rows, vec, m, lane,
                               lanes, acc);
          for (int off = lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
            for (int k = 0; k < MAXN; ++k)
              if (k < n) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
          }
          if (lane == 0 && q < cnt) {
#pragma unroll
            for (int k = 0; k < MAXN; ++k)
              if (k < n) smem[p.doffset + q * p.dstride + k] = acc[k];
          }
        }
        __syncthreads();
        const int t = threadIdx.x;
        float r = 0.0f;
        if (t < cnt)
          r = node_update<MAXN, LOSS, T>(
              a, p, smem, vec, in_carry, out_carry, rounded_residual,
              node0 + t, t, w_store + l * a.w_in_lane,
              a.w_carry + l * a.wc_lane, a.z + l * z_lane,
              w_out + l * a.w_out_lane);
        if constexpr (MULTI) {
          if (a.compute_residual) warp_max_into(r, lane_res + l);
        } else {
          rmax = fmaxf(rmax, r);
        }
        __syncthreads();  // the next lane or tile overwrites shared memory
      }
    }
    grid.sync();

    // ---- edge phase: D(2w+ - w), dual resolvent, KM -------------------
    if constexpr (MULTI) {
      // the edge's columns once for every lane; a warp-uniform trip
      // count, since every lane's residual is a warp max
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
            r = edge_update<MAXN, T>(
                a, vec, in_carry, out_carry, rounded_residual, u_off, e, s,
                d, sg, a.la[l * a.la_lane + e], u_store + l * a.u_in_lane,
                a.u_carry + l * a.uc_lane, a.z + l * z_lane,
                u_out + l * a.u_out_lane);
          if (a.compute_residual) warp_max_into(r, lane_res + l);
        }
      }
    } else {
      for (long long e = tid0; e < a.num_edges; e += stride) {
        const float r = edge_update<MAXN, T>(
            a, vec, in_carry, out_carry, rounded_residual, u_off, e,
            a.src[e], a.dst[e], a.sigma[e], a.la[e], u_store, a.u_carry,
            a.z, u_out);
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
      const int wl = threadIdx.x & 31, warp = threadIdx.x >> 5;
      if (wl == 0) warp_max[warp] = rmax;
      __syncthreads();
      if (threadIdx.x == 0) {
        float m = 0.0f;
        for (int k = 0; k < kWarps; ++k) m = fmaxf(m, warp_max[k]);
        atomicMax(reinterpret_cast<int*>(a.res), __float_as_int(m));
      }
    }
  }
  // counted last, where the step's registers are free (the squared
  // kernel runs under a register cap)
  if (a.executions != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(a.executions, 1ULL);
}

inline bool aligned16(const void* q) {
  return (reinterpret_cast<std::uintptr_t>(q) & 15u) == 0;
}

// What one node of a launch stages: the count and shapes of the loss's
// prox parameters (elements per node of each, as kernels/pd_step.py
// checks them), their shared rows (each padded to an odd number of
// words) and the D^T u row.  Returns the node's shared bytes: its slots
// (an int4), its D^T u row and (staged) its parameter rows.  The one
// count of them: make_plan sizes tiles with it, and the wrapper and the
// solver's fused gate read make_plan's total through
// fused_pd_step_staging (pd_step.cu).
inline long long stage_layout(int loss, int n, int ms, Plan& p,
                              bool staged = true) {
  p = Plan{};
  if (loss == kSquared) {
    p.num_params = 2;
    p.elems[0] = n; p.elems[1] = n * n;                        // b, p
  } else if (loss == kLasso) {
    p.num_params = 6;                     // labeled, m, q, step, tau, xty
    const int el[6] = {1, 1, n * n, 1, 1, n};
    for (int k = 0; k < 6; ++k) p.elems[k] = el[k];
  } else {
    p.num_params = 6;                     // labeled, m, mask, tau, x, y
    const int el[6] = {1, 1, ms, 1, ms * n, ms};
    for (int k = 0; k < 6; ++k) p.elems[k] = el[k];
  }
  p.dstride = n | 1;
  long long per_node = 4 + p.dstride;             // slots (int4), D^T u
  for (int k = 0; k < p.num_params; ++k) {
    p.stride[k] = p.elems[k] | 1;
    if (staged) per_node += p.stride[k];
  }
  return 4 * per_node;
}

// The launch plan of one loss at register tile MAXN: staged parameter
// shapes, tile, lanes, vector rows, and for a launch over lanes (MULTI)
// the staged in-edge ids and the lanes' residual maxima.  The gather's
// lanes come from the staging tile (the tile of the staged plan) and the
// mean degree alone, never from the lane count or the variant, so each
// lane of a launch over lanes sums in the order a one-lane launch does,
// and the streamed variant's gather (pd_step_streamed.cuh) in the order
// of the staged one.  Returns the shared bytes; past kSmemMax the launch
// is refused.  The in-edge ids only fill what is left of kSmemTarget, so
// whether a plan fits depends on the loss, n, the samples a node and the
// lane count alone: fused_pd_step_staging (pd_step.cu) asks this plan
// with no graph, for the wrapper and the solver's fused gate.  `staged`
// false plans no parameter rows in shared memory (the streamed variant's
// node phase starts from it), so its tiles hold up to kMaxTile nodes.
template <int MAXN, int LOSS, bool MULTI>
long long make_plan(const PdArgs& a, Plan& p, bool staged = true) {
  long long node_bytes = stage_layout(LOSS, a.n, a.num_samples, p);
  int staging_tile = kMaxTile;
  while (staging_tile > 1 && staging_tile * node_bytes > kSmemTarget)
    staging_tile >>= 1;
  if (!staged) node_bytes = stage_layout(LOSS, a.n, a.num_samples, p, false);
  p.tile = kMaxTile;
  while (p.tile > 1 && p.tile * node_bytes > kSmemTarget) p.tile >>= 1;
  p.doffset = 4 * p.tile;
  long long off = p.doffset + (long long)p.tile * p.dstride;
  for (int k = 0; k < 6; ++k) {
    p.offset[k] = (int)off;
    if (staged && k < p.num_params) off += (long long)p.tile * p.stride[k];
  }
  p.num_tiles = (a.num_nodes + p.tile - 1) / p.tile;
  // about kUnroll slots per lane at the mean degree, and every thread of
  // the block on some node of the tile
  const double mean_deg =
      a.num_nodes > 0 ? 2.0 * (double)a.num_in / (double)a.num_nodes : 0.0;
  int lanes = 1;
  while (lanes < 32 && lanes * kUnroll < mean_deg) lanes <<= 1;
  while (lanes < 32 && lanes * staging_tile < kThreads) lanes <<= 1;
  p.lanes = lanes;
  p.vec = a.n == MAXN && aligned16(a.w_in) && aligned16(a.u_in) &&
          aligned16(a.w_out) && aligned16(a.u_out) &&
          aligned16(a.w_carry) && aligned16(a.u_carry) && aligned16(a.z);
  if (MULTI) {
    // every lane's rows aligned too (z's lane is num_nodes rows)
    const long long ts = a.storage == kBF16 ? 2 : 4;
    const long long strides[] = {a.w_in_lane * ts, a.u_in_lane * ts,
                                 a.w_out_lane * ts, a.u_out_lane * ts,
                                 a.wc_lane * 4, a.uc_lane * 4,
                                 a.num_nodes * a.n * 4};
    for (long long b : strides) p.vec = p.vec && b % 16 == 0;
    p.res_offset = (int)off;
    off += a.num_lanes;
    // a tile's in-edge ids: up to twice the mean in-degree a node, in
    // what is left of the staging target (a tile past it reads the ids
    // from device memory, as a one-lane launch does)
    p.ids_offset = (int)off;
    const double mean_in =
        a.num_nodes > 0 ? (double)a.num_in / (double)a.num_nodes : 0.0;
    long long cap = (long long)(p.tile * (2.0 * mean_in + 4.0));
    const long long room = kSmemTarget / 4 - off;
    if (cap > room) cap = room > 0 ? room : 0;
    p.ids_cap = (int)cap;
    off += cap;
  }
  return off * 4;
}

// One cooperative launch of `kernel` with `plan` and `smem` dynamic
// shared bytes: the grid is the larger of the node tiles and the edge
// blocks, capped by the blocks the occupancy query lets reside.
template <typename Kernel>
cudaError_t cooperative_launch(Kernel kernel, const PdArgs& args,
                               const Plan& plan, long long smem,
                               cudaStream_t stream) {
  cudaError_t err;
  if (smem > kSmemDefault) {  // opt in past the default per-block limit
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, (size_t)smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  const long long edge_blocks = (args.num_edges + kThreads - 1) / kThreads;
  long long blocks =
      plan.num_tiles > edge_blocks ? plan.num_tiles : edge_blocks;
  const long long resident = (long long)per_sm * sms;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  PdArgs local = args;
  Plan lplan = plan;
  void* kargs[] = {&local, &lplan};
  err = cudaLaunchCooperativeKernel((void*)kernel, dim3((unsigned)blocks),
                                    dim3(kThreads), kargs, (size_t)smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int MAXN, int LOSS, typename T, bool MULTI>
cudaError_t launch(const PdArgs& args, cudaStream_t stream) {
  Plan plan;
  const long long smem = make_plan<MAXN, LOSS, MULTI>(args, plan);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  return cooperative_launch(fused_pd_step_kernel<MAXN, LOSS, T, MULTI>,
                            args, plan, smem, stream);
}

// The register tile and storage type of one loss's launch.
template <int LOSS, typename T, bool MULTI>
cudaError_t launch_width(const PdArgs& a, cudaStream_t s) {
  if (a.n <= 2) return launch<2, LOSS, T, MULTI>(a, s);
  if (a.n <= 4) return launch<4, LOSS, T, MULTI>(a, s);
  if (a.n <= 8) return launch<8, LOSS, T, MULTI>(a, s);
  if (a.n <= kTileFeatures) return launch<16, LOSS, T, MULTI>(a, s);
  return cudaErrorInvalidValue;
}

// One lane runs the single-problem kernel; more run the lane kernel.
template <int LOSS, typename T>
cudaError_t launch_lanes(const PdArgs& a, cudaStream_t s) {
  if (a.num_lanes == 1) return launch_width<LOSS, T, false>(a, s);
  return launch_width<LOSS, T, true>(a, s);
}

// The staged register-tile variants (n <= kTileFeatures) of one loss.
template <int LOSS>
cudaError_t dispatch(const PdArgs& a, cudaStream_t s) {
  if (a.n < 1 || a.num_lanes < 1) return cudaErrorInvalidValue;
  if (a.storage == kF32) return launch_lanes<LOSS, float>(a, s);
  if (a.storage == kBF16) return launch_lanes<LOSS, __nv_bfloat16>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace repro_pd
