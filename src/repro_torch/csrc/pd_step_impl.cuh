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
//     dtu_i = sum_d inc_signs[i,d] * u[inc_edges[i,d]]   (storage ids)
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
// parameters are loaded with __bfloat162float and stored with
// __float2bfloat16_rn (round to nearest even, as Tensor.to(bfloat16));
// tau, sigma, la, the incidence signs, z and the residual stay float32.
// With iters == 1 the residual compares the storage-rounded outputs with
// the inputs, as the plain version does.  With iters > 1 the iterations
// run through a float32 carry (w_carry, u_carry) and only the last one
// writes the storage type, so bf16 rounds once per launch as in the
// reference; the residual then compares the carry.  For float storage the
// wrapper points the carry at the outputs.
//
// Design.  The TPU kernel streams one node block's window (owned + halo
// rows) through VMEM per grid step and recomputes the halo nodes' primal
// update in every block that needs it.  Here the whole layout is read
// straight from device memory, so each node is computed once: one
// cooperative persistent launch, grid-stride loops, one thread per node in
// the node phase (z goes to a scratch tensor), a grid-wide barrier
// (cooperative_groups grid sync), one thread per owned edge in the edge
// phase, and another barrier before the next of `iters` iterations (the
// TPU kernel's in-kernel multi-iteration loop, only on a single-block
// layout).  A node reads and writes only its own w row and reads u; an
// edge reads and writes only its own u row and reads z; the barriers
// separate the phases.  So the outputs may be the owned rows of the
// inputs themselves: the solver updates its state in place.  The
// residual is a per-thread max, a block max, then an atomicMax on the
// float's bits (non-negative floats order like their bit patterns) into a
// scalar the wrapper zeroes.
//
// Stop word.  A tolerance solve enqueues every block of its budget and
// keeps a device flag (`active`) that it clears once a block's residual
// is <= tol.  Every thread reads the flag first and, when it is clear,
// returns before the first grid sync: the launch writes nothing, so the
// state stays exactly as it is and nothing is read back to the host.
//
// The feature count n is a runtime value held in a register tile of
// MAXN = 2, 4, 8 or 16; the entry point refuses n > 16.  The logistic
// Hessian is MAXN (MAXN + 1) / 2 floats per thread, 136 at MAXN = 16, so
// that width spills to local memory; a cooperative launch needs only one
// resident block per SM, and the occupancy query sizes the grid.
//
// What bounds it: bytes for the squared loss (a few flops per byte); the
// lasso and logistic inner loops add num_inner passes of n^2 (lasso) or
// m n^2 (logistic) flops per node over parameters the node has already
// read.  The function must move the filled incidence slots (an id and a
// sign for each of the 2E slots, plus row offsets: about 167 MB at the
// 1M-node scale-out graph, mean degree ~20.4), the dual rows gathered
// through them, the prox parameters, and the edge columns.  This kernel
// reads the padded tables instead (ids and signs, V x max_deg x 4 B
// each; at max_deg 47 about 376 MB) and re-reads the lasso's Q and the
// logistic's samples from L1/L2 on every inner iteration.  Compacting the
// tables and staging a node's parameters is the redesign's work.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "pd_step.cuh"

namespace repro_pd {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;

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

__device__ __forceinline__ float clip(float x, float l) {
  return fminf(fmaxf(x, -l), l);
}

// Parameter k of the prox, element idx, in float32.
template <typename T>
__device__ __forceinline__ float prm(const PdArgs& a, int k, long long idx) {
  return to_f32(static_cast<const T*>(a.prm[k])[idx]);
}

// PU_i(v) of the loss into wp (node i; n live entries of MAXN).
template <int MAXN, int LOSS, typename T>
__device__ __forceinline__ void prox(const PdArgs& a, long long i,
                                     const float (&v)[MAXN],
                                     float (&wp)[MAXN]) {
  const int n = a.n;
  if (LOSS == kSquared) {  // params ("b", "p"): P (v + b)
    float vb[MAXN];
#pragma unroll
    for (int k = 0; k < MAXN; ++k)
      if (k < n) vb[k] = v[k] + prm<T>(a, 0, i * n + k);
#pragma unroll
    for (int j = 0; j < MAXN; ++j) {
      if (j < n) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < MAXN; ++k)
          if (k < n) s += prm<T>(a, 1, (i * n + j) * n + k) * vb[k];
        wp[j] = s;
      }
    }
  } else if (LOSS == kLasso) {
    // params ("labeled", "m", "q", "step", "tau", "xty")
    const float m = prm<T>(a, 1, i), step = prm<T>(a, 3, i);
    const float tp = prm<T>(a, 4, i);
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
            if (k < n) qz += prm<T>(a, 2, (i * n + j) * n + k) * z[k];
          float g = 2.0f * (qz - prm<T>(a, 5, i * n + j)) / m;
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
    const bool lab = prm<T>(a, 0, i) > 0.0f;
#pragma unroll
    for (int k = 0; k < MAXN; ++k) wp[k] = lab ? z[k] : v[k];
  } else {
    // params ("labeled", "m", "mask", "tau", "x", "y")
    const int ms = a.num_samples;
    const float m = prm<T>(a, 1, i), tp = prm<T>(a, 3, i);
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
        const long long row = (i * ms + j) * n;
        float x[MAXN];
        float logit = 0.0f;
#pragma unroll
        for (int k = 0; k < MAXN; ++k) {
          if (k < n) {
            x[k] = prm<T>(a, 4, row + k);
            logit += x[k] * z[k];
          }
        }
        const float s = 1.0f / (1.0f + expf(-logit));
        const float mk = prm<T>(a, 2, i * ms + j);
        const float res = (s - prm<T>(a, 5, i * ms + j)) * mk;
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
    const bool lab = prm<T>(a, 0, i) > 0.0f;
#pragma unroll
    for (int k = 0; k < MAXN; ++k) wp[k] = lab ? z[k] : v[k];
  }
}

template <int MAXN, int LOSS, typename T>
__global__ void __launch_bounds__(kThreads)
fused_pd_step_kernel(PdArgs a) {
  // the stop word: a stopped tol solve writes nothing (uniform: every
  // thread returns before the first grid sync)
  if (a.active != nullptr && *a.active == 0) return;
  cg::grid_group grid = cg::this_grid();
  const int n = a.n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const T* w_store = static_cast<const T*>(a.w_in);
  const T* u_store = static_cast<const T*>(a.u_in);
  T* w_out = static_cast<T*>(a.w_out);
  T* u_out = static_cast<T*>(a.u_out);
  const bool rounded_residual = a.iters == 1;
  float rmax = 0.0f;

  for (int it = 0; it < a.iters; ++it) {
    const bool in_carry = it > 0;             // read the f32 carry
    const bool out_carry = it + 1 < a.iters;  // write the f32 carry
    const long long u_off = in_carry ? 0 : a.u_offset;
    const long long u_rows = in_carry ? a.num_edges : a.u_rows;

    // ---- node phase: gather D^T u, loss prox, z, KM ------------------
    for (long long i = tid0; i < a.num_nodes; i += stride) {
      float dtu[MAXN];
#pragma unroll
      for (int k = 0; k < MAXN; ++k) dtu[k] = 0.0f;
      const int* ie = a.inc_edges + i * a.max_deg;
      const float* is = a.inc_signs + i * a.max_deg;
      for (int d = 0; d < a.max_deg; ++d) {
        const float s = is[d];
        if (s != 0.0f) {
          long long e = ie[d];
          e = e < 0 ? 0 : (e >= u_rows ? u_rows - 1 : e);
#pragma unroll
          for (int k = 0; k < MAXN; ++k) {
            if (k < n) {
              const float ue = in_carry ? a.u_carry[e * n + k]
                                        : to_f32(u_store[e * n + k]);
              dtu[k] += s * ue;
            }
          }
        }
      }
      const float t = a.tau[i];
      float w[MAXN], v[MAXN], wp[MAXN];
#pragma unroll
      for (int k = 0; k < MAXN; ++k) {
        w[k] = 0.0f;
        if (k < n) {
          w[k] = in_carry ? a.w_carry[i * n + k] : to_f32(w_store[i * n + k]);
          v[k] = w[k] - t * dtu[k];
        } else {
          v[k] = 0.0f;
        }
      }
      prox<MAXN, LOSS, T>(a, i, v, wp);
#pragma unroll
      for (int j = 0; j < MAXN; ++j) {
        if (j < n) {
          a.z[i * n + j] = 2.0f * wp[j] - w[j];
          float wn = a.relax ? w[j] + a.rho * (wp[j] - w[j]) : wp[j];
          if (out_carry) {
            a.w_carry[i * n + j] = wn;
          } else {
            const T st = from_f32<T>(wn);
            w_out[i * n + j] = st;
            if (rounded_residual) wn = to_f32(st);
          }
          if (a.compute_residual) rmax = fmaxf(rmax, fabsf(wn - w[j]) / t);
        }
      }
    }
    grid.sync();

    // ---- edge phase: D(2w+ - w), dual resolvent, KM -------------------
    for (long long e = tid0; e < a.num_edges; e += stride) {
      const long long s = a.src[e], d = a.dst[e];
      const float sg = a.sigma[e], l = a.la[e];
      const float scale = l / (l + sg);
      const long long row = (u_off + e) * n;
      for (int k = 0; k < n; ++k) {
        const float u0 = in_carry ? a.u_carry[row + k]
                                  : to_f32(u_store[row + k]);
        const float x = u0 + sg * (a.z[s * n + k] - a.z[d * n + k]);
        const float up = a.reg_kind == 0 ? clip(x, l) : x * scale;
        float y = up;
        if (a.relax) {
          y = u0 + a.rho * (up - u0);
          if (a.reg_kind == 0) y = clip(y, l);
        }
        if (out_carry) {
          a.u_carry[e * n + k] = y;
        } else {
          const T st = from_f32<T>(y);
          u_out[e * n + k] = st;
          if (rounded_residual) y = to_f32(st);
        }
        if (a.compute_residual) rmax = fmaxf(rmax, fabsf(y - u0) / sg);
      }
    }
    if (it + 1 < a.iters) grid.sync();
  }

  if (a.compute_residual) {
    for (int off = 16; off > 0; off >>= 1)
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
    __shared__ float warp_max[kThreads / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_max[warp] = rmax;
    __syncthreads();
    if (threadIdx.x == 0) {
      float m = 0.0f;
      for (int k = 0; k < kThreads / 32; ++k) m = fmaxf(m, warp_max[k]);
      atomicMax(reinterpret_cast<int*>(a.res), __float_as_int(m));
    }
  }
}

template <int MAXN, int LOSS, typename T>
cudaError_t launch(const PdArgs& args, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_pd_step_kernel<MAXN, LOSS, T>, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  const long long work =
      args.num_nodes > args.num_edges ? args.num_nodes : args.num_edges;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long resident = (long long)per_sm * sms;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  PdArgs local = args;
  void* kargs[] = {&local};
  err = cudaLaunchCooperativeKernel(
      (void*)fused_pd_step_kernel<MAXN, LOSS, T>, dim3((unsigned)blocks),
      dim3(kThreads), kargs, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The register tile and storage type of one loss's launch.
template <int LOSS, typename T>
cudaError_t launch_width(const PdArgs& a, cudaStream_t s) {
  if (a.n <= 2) return launch<2, LOSS, T>(a, s);
  if (a.n <= 4) return launch<4, LOSS, T>(a, s);
  if (a.n <= 8) return launch<8, LOSS, T>(a, s);
  if (a.n <= 16) return launch<16, LOSS, T>(a, s);
  return cudaErrorInvalidValue;
}

template <int LOSS>
cudaError_t dispatch(const PdArgs& a, cudaStream_t s) {
  if (a.n < 1) return cudaErrorInvalidValue;
  if (a.storage == kF32) return launch_width<LOSS, float>(a, s);
  if (a.storage == kBF16) return launch_width<LOSS, __nv_bfloat16>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace repro_pd
