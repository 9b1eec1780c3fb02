// Fused primal-dual step for Hopper over lanes: the register tile's lane
// kernel (n <= 16, num_lanes > 1, prox parameters staged), for a lambda
// path on one layout.  It replaces what the Pallas TPU kernel
// src/repro/kernels/pd_step.py:fused_pd_step computes under the
// reference's jax.vmap (api/solver.py:solve_path, the fused branch): L
// problems share the layout, the prox parameters, tau and sigma; each has
// its own w, u, la, outputs, carry, z and residual slot.  What one lane
// computes, and the storage contract, are pd_step_impl.cuh's.
//
// What bounds it: bytes.  Per step every lane's state moves (u in and out,
// la, w in and out) beside the shared tables, read once: 1.52 GB for six
// float32 lanes at the 1M-node scale-out graph (~10.2M edges, n = 2).
// What it must not do is pay for each lane's random rows apart: the in-edge
// u rows of the gather and the z rows of an edge's ends are random reads,
// and a row of 8 bytes costs a 32-byte sector where it misses L2.  What
// holds it in practice (PERF.md) is the number of dependent memory rounds
// a block waits through, at two blocks an SM.
//
// Design.
//   * Lane-minor state.  Every lane-stacked array has its own row and lane
//     strides (PdArgs); the fused lambda path hands the kernel lane-minor
//     storage, (rows, L, n) viewed as (L, rows, n), where one visit to a
//     row reads every lane's (48 contiguous bytes for six float32 lanes at
//     n = 2: two sectors, against six).  z and the carries the wrapper
//     allocates lane-minor too.  Lane-major input takes the same code, with
//     rows loaded lane by lane.
//   * The node phase stages a tile's slots and prox parameters once for
//     every lane (stage_lane_tile: stage_tile's layout, its loads issued
//     kStageBatch deep before their stores), and its in-edge ids.  Then,
//     for each chunk of up to lane_chunk<MAXN>() lanes, a node's gather
//     group (the one-lane plan's `lanes` threads, slots and xor tree)
//     reads each in-edge id once and the chunk's rows beside it (one run
//     of vectors where the rows are whole and aligned), keeping a chunk x
//     MAXN accumulator; each lane sums its slots in the one-lane order, so
//     every lane is bit-identical to a one-lane launch on its inputs.  A
//     chunk costs two barriers (against two a lane before); its D^T u
//     lands in shared memory, (node, lane) rows of odd stride.
//   * The prox: a thread a (node, lane) pair of the chunk, neighbouring
//     threads on neighbouring rows, two pairs' loads in flight.  For the
//     lasso and logistic losses the tile lists its labeled nodes once (an
//     unlabeled node's prox returns v, bit for bit): unlabeled pairs write
//     w+ = v, and the threads then take (labeled node, lane) pairs from
//     the list, so ISTA and Newton steps run only where they count.
//   * The edge phase, where the state is dense lane-minor: a tile of up to
//     a block's edges stages its u and la runs, sigma, src and dst in
//     shared memory in coalesced sweeps, a thread an edge then reads its
//     ends' z rows edge_chunk lanes at a time (runs of vectors where they
//     are whole) and writes the new rows back in place, and the tile is
//     stored in one coalesced sweep.  Elsewhere a thread an edge reads its
//     rows from device memory, edge_chunk lanes at a time.
//   * Residual: each lane's max is exact whatever the order; a thread folds
//     its terms into the lane's shared slot (an atomicMax on the bits of a
//     non-negative float, skipped when the slot already holds more); one
//     atomicMax a lane and block at the end.
#pragma once

#include "pd_step_impl.cuh"

namespace repro_pd {

// Lanes one gather sums at once at register tile MAXN: its accumulators
// and the rows of the slot in flight are lane_chunk * MAXN floats each.
template <int MAXN> __host__ __device__ constexpr int lane_chunk() {
  return MAXN <= 2 ? 6 : (MAXN <= 4 ? 4 : (MAXN <= 8 ? 2 : 1));
}
// Loads a thread has in flight when a tile is staged (every load of a
// batch issued before its first store to shared memory).
constexpr int kStageBatch = 8;
// The shared bytes a lane launch's tile may fill: two blocks an SM (the
// lane kernels' register budget) may each take this much.
constexpr int kLaneSmemTarget = 96 * 1024;
// Lanes an edge thread loads at once (their z rows of both ends, and
// where the edge is not staged their la and u rows, all before the first
// store): four for the squared loss at n <= 2, fewer where the prox's
// registers leave less room (past 128 registers a thread, one block an SM
// instead of two, or spills: PERF.md).
template <int MAXN, int LOSS>
__host__ __device__ constexpr int edge_chunk() {
  return MAXN <= 2 ? (LOSS == kSquared ? 4 : 2) : (MAXN <= 4 ? 2 : 1);
}
// The fewest edges a staged edge tile takes (past it, fewer threads than
// a block's quarter would work the tile: the edges go straight through).
constexpr int kMinEdgeTile = 64;

// The lane launch's plan: the one-lane plan's fields (its gather lanes;
// the tile is sized with the chunk's D^T u rows), the lanes of a chunk,
// the shared offset of the tile's labeled-node list (its count, then its
// nodes; lasso and logistic only) and the edge phase's staged tile.
struct LanePlan {
  Plan p;
  int chunk;
  int list_offset;
  // edges a tile of the edge phase stages (their u and la runs in shared
  // memory, from offset 0); 0: every edge straight from device memory
  int edge_tile;
  // a chunk's rows are one run of whole aligned vectors (lane-minor, n ==
  // MAXN): z's chunk of edge_chunk lanes, u's and the carry's of
  // lane_chunk lanes
  int z_runs;
  int u_runs;
  int uc_runs;
};

// Resident blocks per SM the register budget must allow: two for the
// squared and lasso losses up to n = 4 (128 registers, room for the
// chunk's rows in flight: under a 64- or 80-register cap the kernel
// spilled and ran slower, PERF.md), the compiler's own count past them.
template <int MAXN, int LOSS> constexpr int lane_min_blocks() {
  return LOSS != kLogistic && MAXN <= 4 ? 2 : 1;
}

// The edge tile [e0, e0 + cnt) into shared memory: its u (or carry) runs
// from gu (span floats), la runs (lspan), sigma, src and dst, every load
// of a round issued before its first store (kStageBatch u and la values a
// thread a round: two rounds for six lanes at n = 2).
template <typename U>
__device__ __forceinline__ void stage_edge_tile(
    const PdArgs& a, long long e0, int cnt, int span, int lspan,
    const U* gu, float* su, float* sl, float* ssg, int* ssrc, int* sdst) {
  const int t = threadIdx.x;
  float sg = 0.0f;
  int s = 0, d = 0;
  if (t < cnt) {
    sg = a.sigma[e0 + t];
    s = a.src[e0 + t];
    d = a.dst[e0 + t];
  }
  const float* gl = a.la + e0 * a.num_lanes;
  for (int r0 = 0; r0 < span || r0 < lspan; r0 += kStageBatch * kThreads) {
    float vu[kStageBatch], vl[kStageBatch];
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      const int j = r0 + b * kThreads + t;
      vu[b] = j < span ? to_f32(gu[j]) : 0.0f;
      vl[b] = j < lspan ? gl[j] : 0.0f;
    }
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      const int j = r0 + b * kThreads + t;
      if (j < span) su[j] = vu[b];
      if (j < lspan) sl[j] = vl[b];
    }
  }
  if (t < cnt) {
    ssg[t] = sg;
    ssrc[t] = s;
    sdst[t] = d;
  }
}

// stage_tile's staging of the tile [node0, node0 + cnt) (pd_step_impl.cuh:
// the same slots and parameter rows in the same places), its parameter
// elements one flat list (parameter k's after parameter k - 1's) with
// kStageBatch loads a thread in flight before their stores.
template <typename T>
__device__ __forceinline__ void stage_lane_tile(const PdArgs& a,
                                                const Plan& p, float* smem,
                                                long long node0, int cnt) {
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
  int start[7];
  start[0] = 0;
#pragma unroll
  for (int k = 0; k < 6; ++k)
    start[k + 1] = start[k] + (k < p.num_params ? cnt * p.elems[k] : 0);
  const int all = start[6];
  for (int f0 = threadIdx.x; f0 < all; f0 += kStageBatch * kThreads) {
    float v[kStageBatch];
    int at[kStageBatch];
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      const int f = f0 + b * kThreads;
      v[b] = 0.0f;
      at[b] = -1;
      if (f < all) {
        // the parameter f falls in, selected without indexing the plan
        int el = p.elems[0], st = p.stride[0], off = p.offset[0], s0 = 0;
        const void* g = a.prm[0];
#pragma unroll
        for (int k = 1; k < 6; ++k) {
          if (f >= start[k]) {
            el = p.elems[k];
            st = p.stride[k];
            off = p.offset[k];
            s0 = start[k];
            g = a.prm[k];
          }
        }
        const int j = f - s0;
        v[b] = to_f32(static_cast<const T*>(g)[node0 * el + j]);
        const int q = j / el;
        at[b] = off + q * st + (j - q * el);
      }
    }
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b)
      if (at[b] >= 0) smem[at[b]] = v[b];
  }
}

// The max of a non-negative r into a lane's shared residual slot (float
// bits order like ints).
__device__ __forceinline__ void slot_max(float* slot, float r) {
  if (r > *reinterpret_cast<volatile float*>(slot))
    atomicMax(reinterpret_cast<int*>(slot), __float_as_int(r));
}

// This thread's share of D^T u for the node with staged slots m, for the
// lc lanes of a chunk: slots lane, lane + lanes, ... (in-edges first, -1,
// then the out run, +1), each lane summed in that order as gather_share
// sums one lane; u points at the chunk's first lane, rows `row` and lanes
// `lane_stride` elements apart.  A slot's chunk of rows is one run of
// whole vectors where `runs` promises it (and the chunk is whole), else
// loaded lane by lane; one slot in flight a thread (its rows are the
// loads in flight: more spilled, or cost the logistic kernel its second
// block an SM, PERF.md).
template <int MAXN, int LC, typename U>
__device__ __forceinline__ void gather_lanes(
    const PdArgs& a, const int* ids, int ids_base, const U* u,
    long long row, long long lane_stride, int lc, long long u_rows,
    bool vec, bool runs, int4 m, int lane, int lanes,
    float (&acc)[LC][MAXN]) {
  constexpr int W = LC * MAXN;   // a whole chunk's run
  const int n = a.n;
  const bool whole = runs && lc == LC;
#pragma unroll
  for (int c = 0; c < LC; ++c)
#pragma unroll
    for (int k = 0; k < MAXN; ++k) acc[c][k] = 0.0f;
  const int p0 = m.x - ids_base, nin = m.y, first = m.z;
  const int deg = nin + m.w;
  for (int s = lane; s < deg; s += lanes) {
    const int id = s < nin ? ids[p0 + s] : first + (s - nin);
    const long long e = id < 0 ? 0 : (id >= u_rows ? u_rows - 1 : id);
    float r[W];
    if (whole) {
      load_row<W>(u + e * row, W, true, r);
    } else {
#pragma unroll
      for (int c = 0; c < LC; ++c)
        if (c < lc)
          load_row<MAXN>(u + e * row + c * lane_stride, n, vec,
                         *reinterpret_cast<float(*)[MAXN]>(r + c * MAXN));
    }
#pragma unroll
    for (int c = 0; c < LC; ++c) {
      if (c < lc) {
#pragma unroll
        for (int k = 0; k < MAXN; ++k)
          acc[c][k] = s < nin ? acc[c][k] - r[c * MAXN + k]
                              : acc[c][k] + r[c * MAXN + k];
      }
    }
  }
}

template <int MAXN, int LOSS, typename T>
__global__ void __launch_bounds__(kThreads, lane_min_blocks<MAXN, LOSS>())
fused_pd_step_lanes_kernel(PdArgs a, LanePlan lp) {
  constexpr int LC = lane_chunk<MAXN>();
  constexpr int EC = edge_chunk<MAXN, LOSS>();
  constexpr bool kListed = LOSS != kSquared;
  // the stop word (uniform: every thread returns before the first sync)
  if (a.active != nullptr && *a.active == 0) return;
  cg::grid_group grid = cg::this_grid();
  // the tile: node slots, the chunk's D^T u, the staged parameters, the
  // lanes' residual maxima, the labeled-node list, the staged in-edge ids
  extern __shared__ __align__(16) float smem[];
  const Plan& p = lp.p;
  const int n = a.n;
  const bool vec = p.vec != 0;
  const T* w_store = static_cast<const T*>(a.w_in);
  const T* u_store = static_cast<const T*>(a.u_in);
  T* w_out = static_cast<T*>(a.w_out);
  T* u_out = static_cast<T*>(a.u_out);
  const bool rounded_residual = a.iters == 1;
  const int num_lanes = (int)a.num_lanes;
  const int lanes = p.lanes, lane = threadIdx.x & (lanes - 1);
  const int group = threadIdx.x / lanes, groups = kThreads / lanes;
  float* lane_res = smem + p.res_offset;
  int* list = reinterpret_cast<int*>(smem + lp.list_offset);
  // read only after a __syncthreads or grid sync below
  for (int l = threadIdx.x; l < num_lanes; l += kThreads) lane_res[l] = 0.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;

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
      // the tile's in-edge span, read before the staging's loads
      const int first = a.in_ptr[node0];
      const int count = a.in_ptr[node0 + cnt] - first;
      stage_lane_tile<T>(a, p, smem, node0, cnt);
      const int* ids = a.in_ids;
      int ids_base = 0;
      if (p.ids_cap > 0) {
        // the tile's in-edge ids once for every chunk, when they fit
        if (count <= p.ids_cap) {
          int* staged = reinterpret_cast<int*>(smem + p.ids_offset);
          for (int j0 = threadIdx.x; j0 < count;
               j0 += kStageBatch * kThreads) {
            int v[kStageBatch];
#pragma unroll
            for (int b = 0; b < kStageBatch; ++b) {
              const int j = j0 + b * kThreads;
              v[b] = j < count ? a.in_ids[first + j] : 0;
            }
#pragma unroll
            for (int b = 0; b < kStageBatch; ++b) {
              const int j = j0 + b * kThreads;
              if (j < count) staged[j] = v[b];
            }
          }
          ids = staged;
          ids_base = first;
        }
      }
      if (kListed && threadIdx.x == 0) list[0] = 0;
      __syncthreads();
      if (kListed) {
        // the tile's labeled nodes, in any order (each is its own work)
        const int q = threadIdx.x;
        if (q < cnt && smem[p.offset[0] + q * p.stride[0]] > 0.0f)
          list[1 + atomicAdd(list, 1)] = q;
      }
      for (int c0 = 0; c0 < num_lanes; c0 += lp.chunk) {
        const int lc = num_lanes - c0 < lp.chunk ? num_lanes - c0 : lp.chunk;
        // warp-uniform trip count (every thread takes part in the xor
        // tree; a group past the tile sums nothing)
        for (int base = 0; base < p.tile; base += groups) {
          const int q = base + group;
          const int4 m = q < p.tile ? reinterpret_cast<const int4*>(smem)[q]
                                    : make_int4(0, 0, 0, 0);
          float acc[LC][MAXN];
          if (in_carry)
            gather_lanes<MAXN, LC>(a, ids, ids_base,
                                   a.u_carry + c0 * a.uc_lane, a.uc_row,
                                   a.uc_lane, lc, u_rows, vec, lp.uc_runs,
                                   m, lane, lanes, acc);
          else
            gather_lanes<MAXN, LC>(a, ids, ids_base,
                                   u_store + c0 * a.u_in_lane, a.u_in_row,
                                   a.u_in_lane, lc, u_rows, vec, lp.u_runs,
                                   m, lane, lanes, acc);
          for (int off = lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
            for (int c = 0; c < LC; ++c) {
              if (c < lc) {
#pragma unroll
                for (int k = 0; k < MAXN; ++k)
                  if (k < n)
                    acc[c][k] += __shfl_xor_sync(0xffffffffu, acc[c][k], off);
              }
            }
          }
          if (q < cnt) {
            // every thread of the group holds the sums: each writes lanes
#pragma unroll
            for (int c = 0; c < LC; ++c) {
              if (c < lc && (c & (lanes - 1)) == lane) {
                float* d = smem + p.doffset + (q * lc + c) * p.dstride;
#pragma unroll
                for (int k = 0; k < MAXN; ++k)
                  if (k < n) d[k] = acc[c][k];
              }
            }
          }
        }
        __syncthreads();

        // the chunk's (node, lane) pairs, a thread each, neighbouring
        // threads on neighbouring rows, two pairs' loads in flight: v, the
        // prox (lasso, logistic: labeled nodes below), z, KM
        auto load = [&](int q, int c, float (&w)[MAXN]) {
          const long long i = node0 + q, l = c0 + c;
          if (in_carry)
            load_row<MAXN>(a.w_carry + i * a.wc_row + l * a.wc_lane, n, vec,
                           w);
          else
            load_row<MAXN>(w_store + i * a.w_in_row + l * a.w_in_lane, n,
                           vec, w);
          return a.tau[i];
        };
        auto node = [&](int q, int c, bool run_prox, float tt,
                        const float (&w)[MAXN]) {
          const long long i = node0 + q, l = c0 + c;
          const float* sp[6];
#pragma unroll
          for (int k = 0; k < 6; ++k)
            sp[k] = smem + p.offset[k] + q * p.stride[k];
          return node_math<MAXN, LOSS, T>(
              a, vec, out_carry, rounded_residual, run_prox, tt,
              smem + p.doffset + (q * lc + c) * p.dstride, sp, w,
              a.w_carry + i * a.wc_row + l * a.wc_lane,
              a.z + i * a.z_row + l * a.z_lane,
              w_out + i * a.w_out_row + l * a.w_out_lane);
        };
        auto listed = [&](int q) {
          return kListed && smem[p.offset[0] + q * p.stride[0]] > 0.0f;
        };
        const int npb = kThreads / lc;  // nodes a pass
        const int tq = threadIdx.x / lc, tc = threadIdx.x - tq * lc;
        if (tq < npb) {
          float r = 0.0f;
          for (int q = tq; q < cnt; q += 2 * npb) {
            const int q2 = q + npb;
            const bool on = !listed(q), on2 = q2 < cnt && !listed(q2);
            float w[MAXN], w2[MAXN], tt = 1.0f, tt2 = 1.0f;
            if (on) tt = load(q, tc, w);
            if (on2) tt2 = load(q2, tc, w2);
            if (on) r = fmaxf(r, node(q, tc, !kListed, tt, w));
            if (on2) r = fmaxf(r, node(q2, tc, !kListed, tt2, w2));
          }
          if (a.compute_residual) slot_max(lane_res + c0 + tc, r);
        }
        if (kListed) {
          const int work = list[0] * lc;
          for (int j = threadIdx.x; j < work; j += kThreads) {
            const int k = j / lc, c = j - k * lc;
            float w[MAXN];
            const float tt = load(list[1 + k], c, w);
            const float r = node(list[1 + k], c, true, tt, w);
            if (a.compute_residual) slot_max(lane_res + c0 + c, r);
          }
        }
        __syncthreads();  // the next chunk or tile overwrites shared memory
      }
    }
    grid.sync();

    // ---- edge phase: D(2w+ - w), dual resolvent, KM -------------------
    if (lp.edge_tile > 0) {
      // lane-minor runs: a tile's u and la runs are contiguous, so they
      // move through shared memory in coalesced sweeps; a thread an edge
      // reads its z rows a chunk of lanes at a time
      const int te = lp.edge_tile, run = num_lanes * n;
      float* su = smem;
      float* sl = su + te * run;
      float* sg_t = sl + te * num_lanes;
      int* src_t = reinterpret_cast<int*>(sg_t + te);
      int* dst_t = src_t + te;
      constexpr int ZW = EC * MAXN;   // a chunk's z run
      for (long long e0 = (long long)blockIdx.x * te; e0 < a.num_edges;
           e0 += (long long)gridDim.x * te) {
        const int cnt = a.num_edges - e0 < te ? (int)(a.num_edges - e0) : te;
        const int span = cnt * run;
        if (in_carry)
          stage_edge_tile(a, e0, cnt, span, cnt * num_lanes,
                          a.u_carry + e0 * run, su, sl, sg_t, src_t, dst_t);
        else
          stage_edge_tile(a, e0, cnt, span, cnt * num_lanes,
                          u_store + (u_off + e0) * run, su, sl, sg_t, src_t,
                          dst_t);
        __syncthreads();
        if ((int)threadIdx.x < cnt) {
          const float sg = sg_t[threadIdx.x];
          const float* zs_row = a.z + (long long)src_t[threadIdx.x] * a.z_row;
          const float* zd_row = a.z + (long long)dst_t[threadIdx.x] * a.z_row;
          float* my = su + threadIdx.x * run;
          for (int c0 = 0; c0 < num_lanes; c0 += EC) {
            // the chunk's z rows: one run of each end where they are whole
            // aligned vectors, else lane by lane
            float zs[ZW], zd[ZW];
            if (lp.z_runs && c0 + EC <= num_lanes) {
              load_row<ZW>(zs_row + c0 * n, ZW, true, zs);
              load_row<ZW>(zd_row + c0 * n, ZW, true, zd);
            } else {
#pragma unroll
              for (int c = 0; c < EC; ++c) {
                const long long ln = c0 + c;
                if (ln < num_lanes) {
                  load_row<MAXN>(zs_row + ln * a.z_lane, n, vec,
                                 *reinterpret_cast<float(*)[MAXN]>(
                                     zs + c * MAXN));
                  load_row<MAXN>(zd_row + ln * a.z_lane, n, vec,
                                 *reinterpret_cast<float(*)[MAXN]>(
                                     zd + c * MAXN));
                }
              }
            }
#pragma unroll
            for (int c = 0; c < EC; ++c) {
              const int ln = c0 + c;
              if (ln < num_lanes) {
                float u0[MAXN], y[MAXN];
#pragma unroll
                for (int k = 0; k < MAXN; ++k)
                  u0[k] = k < n ? my[ln * n + k] : 0.0f;
                edge_y<MAXN>(a, sg, sl[threadIdx.x * num_lanes + ln], u0,
                             *reinterpret_cast<const float(*)[MAXN]>(
                                 zs + c * MAXN),
                             *reinterpret_cast<const float(*)[MAXN]>(
                                 zd + c * MAXN), y);
#pragma unroll
                for (int k = 0; k < MAXN; ++k)
                  if (k < n) my[ln * n + k] = y[k];
                const float r = edge_residual<MAXN, T>(
                    a, !out_carry && rounded_residual, sg, u0, y);
                if (a.compute_residual) slot_max(lane_res + ln, r);
              }
            }
          }
        }
        __syncthreads();
        if (out_carry) {
          float* g = a.u_carry + e0 * run;
          for (int j = threadIdx.x; j < span; j += kThreads) g[j] = su[j];
        } else {
          T* g = u_out + e0 * run;
          for (int j = threadIdx.x; j < span; j += kThreads)
            g[j] = from_f32<T>(su[j]);
        }
        __syncthreads();  // the next tile overwrites shared memory
      }
    } else {
      // a thread an edge: src, dst and sigma once, then for each chunk of
      // EC lanes their la and the runs of u and both ends' z rows, every
      // load before the first store
      for (long long e = tid0; e < a.num_edges; e += stride) {
        const long long s = a.src[e], d = a.dst[e];
        const float sg = a.sigma[e];
        const T* u_row = u_store + (u_off + e) * a.u_in_row;
        float* uc_row = a.u_carry + e * a.uc_row;
        const float* zs_row = a.z + s * a.z_row;
        const float* zd_row = a.z + d * a.z_row;
        const float* la_row = a.la + e * a.la_row;
        T* out_row = u_out + e * a.u_out_row;
        for (int c0 = 0; c0 < num_lanes; c0 += EC) {
          float l[EC], u0[EC][MAXN], zs[EC][MAXN], zd[EC][MAXN];
#pragma unroll
          for (int c = 0; c < EC; ++c) {
            const long long ln = c0 + c;
            if (ln < num_lanes) {
              l[c] = la_row[ln * a.la_lane];
              if (in_carry)
                load_row<MAXN>(uc_row + ln * a.uc_lane, n, vec, u0[c]);
              else
                load_row<MAXN>(u_row + ln * a.u_in_lane, n, vec, u0[c]);
              load_row<MAXN>(zs_row + ln * a.z_lane, n, vec, zs[c]);
              load_row<MAXN>(zd_row + ln * a.z_lane, n, vec, zd[c]);
            }
          }
#pragma unroll
          for (int c = 0; c < EC; ++c) {
            const long long ln = c0 + c;
            if (ln < num_lanes) {
              const float r = edge_math<MAXN, T>(
                  a, vec, out_carry, rounded_residual, sg, l[c], u0[c],
                  zs[c], zd[c], uc_row + ln * a.uc_lane,
                  out_row + ln * a.u_out_lane);
              if (a.compute_residual) slot_max(lane_res + ln, r);
            }
          }
        }
      }
    }
    if (it + 1 < a.iters) grid.sync();
  }

  if (a.compute_residual) {
    __syncthreads();
    for (int l = threadIdx.x; l < num_lanes; l += kThreads)
      atomicMax(reinterpret_cast<int*>(a.res + l),
                __float_as_int(lane_res[l]));
  }
  if (a.executions != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(a.executions, 1ULL);
}

inline bool aligned_to(const void* q, long long bytes) {
  return (reinterpret_cast<std::uintptr_t>(q) % (std::uintptr_t)bytes) == 0;
}

// The lane launch's plan at register tile MAXN.  The gather's lanes are
// the one-lane plan's (make_plan<MAXN, LOSS, false>: they follow from the
// staging tile and the mean degree alone), so each lane sums in the order
// a one-lane launch does.  The tile is the largest power of two up to
// kMaxTile whose nodes' slots, D^T u rows of a chunk, parameter rows and
// list entries fit kLaneSmemTarget; the lanes' residual slots come after,
// and the tile's in-edge ids fill what is left of the target.  Whether a
// plan fits depends on the loss, n, the samples a node and the lane count
// alone: pd_step.cu reports it with no graph, for the wrapper and the
// solver's fused gate.  The edge tile, the runs and the vector rows
// follow from the strides and pointers.  Returns the shared bytes; past
// kSmemMax the launch is refused.
template <int MAXN, int LOSS>
long long make_lane_plan(const PdArgs& a, LanePlan& lp) {
  lp = LanePlan{};
  Plan& p = lp.p;
  Plan one;
  make_plan<MAXN, LOSS, false>(a, one);
  stage_layout(LOSS, a.n, a.num_samples, p);
  const int chunk = a.num_lanes < lane_chunk<MAXN>() ? (int)a.num_lanes
                                                     : lane_chunk<MAXN>();
  lp.chunk = chunk;
  const bool listed = LOSS != kSquared;
  long long per_node = 4 + (long long)chunk * p.dstride + (listed ? 1 : 0);
  for (int k = 0; k < p.num_params; ++k) per_node += p.stride[k];
  p.tile = kMaxTile;
  while (p.tile > 1 && p.tile * per_node * 4 > kLaneSmemTarget) p.tile >>= 1;
  p.num_tiles = (a.num_nodes + p.tile - 1) / p.tile;
  p.lanes = one.lanes;
  p.doffset = 4 * p.tile;
  long long off = p.doffset + (long long)p.tile * chunk * p.dstride;
  for (int k = 0; k < 6; ++k) {
    p.offset[k] = (int)off;
    if (k < p.num_params) off += (long long)p.tile * p.stride[k];
  }
  p.res_offset = (int)off;
  off += a.num_lanes;
  lp.list_offset = (int)off;
  if (listed) off += p.tile + 1;
  p.ids_offset = (int)off;
  const double mean_in =
      a.num_nodes > 0 ? (double)a.num_in / (double)a.num_nodes : 0.0;
  long long cap = (long long)(p.tile * (2.0 * mean_in + 4.0));
  const long long room = kLaneSmemTarget / 4 - off;
  if (cap > room) cap = room > 0 ? room : 0;
  p.ids_cap = (int)cap;
  off += cap;
  // the edge phase's staged tile, in [0, res_offset): every edge's u (and
  // carry) and la runs, src, dst and sigma; where the runs are dense
  // lane-minor rows and a tile holds at least kMinEdgeTile edges
  const long long L = a.num_lanes, run = L * a.n;
  bool dense = a.u_in_lane == a.n && a.u_in_row == run &&
               a.u_out_lane == a.n && a.u_out_row == run &&
               a.la_lane == 1 && a.la_row == L;
  if (a.iters > 1) dense = dense && a.uc_lane == a.n && a.uc_row == run;
  long long te = p.res_offset / (run + L + 3);
  if (te > kThreads) te = kThreads;
  lp.edge_tile = dense && te >= kMinEdgeTile ? (int)te : 0;
  // z's runs: the words load_words moves for edge_chunk * MAXN floats
  constexpr int zw = edge_chunk<MAXN, LOSS>() * MAXN;
  constexpr long long zv = zw % 4 == 0 ? 16 : (zw % 2 == 0 ? 8 : 4);
  lp.z_runs = a.n == MAXN && a.z_lane == a.n && aligned_to(a.z, zv) &&
              (a.z_row * 4) % zv == 0;
  // u's and the carry's: the words load_words moves for lane_chunk * MAXN
  // elements (bf16 pairs in a word)
  constexpr int uw = lane_chunk<MAXN>() * MAXN;
  const long long ts = a.storage == kBF16 ? 2 : 4;
  const long long words = ts == 2 ? uw / 2 : uw;
  const long long uv = words % 4 == 0 ? 16 : (words % 2 == 0 ? 8 : 4);
  constexpr long long cv = uw % 4 == 0 ? 16 : (uw % 2 == 0 ? 8 : 4);
  lp.u_runs = a.n == MAXN && a.u_in_lane == a.n && aligned_to(a.u_in, uv) &&
              (a.u_in_row * ts) % uv == 0;
  lp.uc_runs = a.n == MAXN && a.uc_lane == a.n &&
               aligned_to(a.u_carry, cv) && (a.uc_row * 4) % cv == 0;
  // whole vectors: n == MAXN, and every row of every lane aligned to its
  // vector (MAXN elements, at most 16 bytes)
  const long long vs = MAXN * ts < 16 ? MAXN * ts : 16;
  const long long vf = MAXN * 4 < 16 ? MAXN * 4 : 16;
  bool v = a.n == MAXN && aligned_to(a.w_in, vs) && aligned_to(a.u_in, vs) &&
           aligned_to(a.w_out, vs) && aligned_to(a.u_out, vs) &&
           aligned_to(a.w_carry, vf) && aligned_to(a.u_carry, vf) &&
           aligned_to(a.z, vf);
  const long long storage_strides[] = {a.w_in_lane, a.w_in_row, a.u_in_lane,
                                       a.u_in_row, a.w_out_lane, a.w_out_row,
                                       a.u_out_lane, a.u_out_row};
  for (long long s : storage_strides) v = v && (s * ts) % vs == 0;
  const long long f32_strides[] = {a.wc_lane, a.wc_row, a.uc_lane,
                                   a.uc_row, a.z_lane, a.z_row};
  for (long long s : f32_strides) v = v && (s * 4) % vf == 0;
  p.vec = v;
  return off * 4;
}

template <int MAXN, int LOSS, typename T>
cudaError_t launch_lanes(const PdArgs& args, cudaStream_t stream) {
  LanePlan plan;
  const long long smem = make_lane_plan<MAXN, LOSS>(args, plan);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  return cooperative_launch(fused_pd_step_lanes_kernel<MAXN, LOSS, T>, args,
                            plan, plan.p.num_tiles,
                            (args.num_edges + kThreads - 1) / kThreads, smem,
                            stream);
}

// The register tile and storage type of one loss's lane launch.
template <int LOSS, typename T>
cudaError_t launch_lane_width(const PdArgs& a, cudaStream_t s) {
  if (a.n <= 2) return launch_lanes<2, LOSS, T>(a, s);
  if (a.n <= 4) return launch_lanes<4, LOSS, T>(a, s);
  if (a.n <= 8) return launch_lanes<8, LOSS, T>(a, s);
  if (a.n <= kTileFeatures) return launch_lanes<16, LOSS, T>(a, s);
  return cudaErrorInvalidValue;
}

// The shared bytes of a lane launch of loss LOSS (its plan at the
// register tile the launch picks from n).
template <int LOSS>
long long lane_plan_bytes(const PdArgs& a) {
  LanePlan lp;
  if (a.n <= 2) return make_lane_plan<2, LOSS>(a, lp);
  if (a.n <= 4) return make_lane_plan<4, LOSS>(a, lp);
  if (a.n <= 8) return make_lane_plan<8, LOSS>(a, lp);
  return make_lane_plan<16, LOSS>(a, lp);
}

// The staged register-tile variants (n <= kTileFeatures) of one loss: one
// lane runs the single-problem kernel (pd_step_impl.cuh), more the lane
// kernel.
template <int LOSS>
cudaError_t dispatch(const PdArgs& a, cudaStream_t s) {
  if (a.n < 1 || a.num_lanes < 1) return cudaErrorInvalidValue;
  const bool one = a.num_lanes == 1;
  if (a.storage == kF32)
    return one ? launch_width<LOSS, float>(a, s)
               : launch_lane_width<LOSS, float>(a, s);
  if (a.storage == kBF16)
    return one ? launch_width<LOSS, __nv_bfloat16>(a, s)
               : launch_lane_width<LOSS, __nv_bfloat16>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace repro_pd
