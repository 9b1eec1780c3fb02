// Fused primal-dual step (paper Algorithm 1, eqs. 14-15) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pd_step.py:fused_pd_step
// (body _make_kernel).  Same storage contract as its plain version,
// src/repro_torch/kernels/ref.py:fused_pd_step_ref, on the edge-blocked
// layout of core/graph.py:EdgeBlockLayout, squared loss (prox = affine map
// P (v + b)) with the tv (clip) or tv2 (scaling) dual resolvent, float32.
//
// What it computes, per iteration:
//   node phase, every layout node i < nb*BV:
//     dtu_i = sum_d inc_signs[i,d] * u[inc_edges[i,d]]   (storage ids)
//     w+_i  = P_i (w_i - tau_i dtu_i + b_i);  z_i = 2 w+_i - w_i
//     w_i  <- w_i + rho (w+_i - w_i)                      (KM, rho != 1)
//   edge phase, every owned edge e < nb*EB (storage row klo*EB + e):
//     u+_e  = R(u_e + sigma_e (z_src - z_dst))  R = clip to +-la_e (tv)
//                                               or u la/(la+sigma) (tv2)
//     u_e  <- P(u_e + rho (u+_e - u_e))         P = the clip again (tv)
//   and, with compute_residual, the running max of |dw|/tau, |du|/sigma.
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
// layout).  Iterations after the first update w and u in place in the
// outputs: a node reads and writes only its own w row and reads u, an
// edge reads and writes only its own u row and reads z, and the barriers
// separate the phases.  The residual is a per-thread max, a block max,
// then an atomicMax on the float's bits (non-negative floats order like
// their bit patterns) into a scalar the wrapper zeroes.
//
// The feature count n is a runtime value held in a register tile of
// MAXN = 2 or 4 (the widths the solver and its tests use); the entry point
// refuses n > 4.
//
// What bounds it: bytes; it does a few flops per byte.  The function must
// move the filled incidence slots (an id and a sign for each of the 2E
// slots, plus row offsets: about 167 MB at the 1M-node scale-out graph,
// mean degree ~20.4), the dual rows gathered through them, the prox
// parameters, and the edge columns.  This kernel reads the padded tables
// instead (ids and signs, V x max_deg x 4 B each; at max_deg 47 about
// 376 MB of the roughly 0.75 GB it moves per iteration).  It skips padding
// slots' dual reads (sign 0) but not their id and sign reads; compacting
// the tables (CSR, or narrower ids and signs) is the next step.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see src/repro_torch/kernels/pd_step.py); plain C entry
// point, loaded with ctypes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

struct PdArgs {
  const float* w_in;       // (>= num_nodes, n) node store
  const float* u_in;       // (u_rows, n) edge store (storage ids)
  const int* inc_edges;    // (>= num_nodes, max_deg) storage edge ids
  const float* inc_signs;  // (>= num_nodes, max_deg) +1 / -1 / 0
  const float* b;          // (>= num_nodes, n) prox shift
  const float* p;          // (>= num_nodes, n, n) prox matrix
  const float* tau;        // (>= num_nodes,) primal steps
  const int* src;          // (num_edges,) layout node ids
  const int* dst;
  const float* sigma;      // (num_edges,) dual steps
  const float* la;         // (num_edges,) lam * A_e
  float* w_out;            // (num_nodes, n)
  float* u_out;            // (num_edges, n)
  float* z;                // (num_nodes, n) scratch: 2 w+ - w
  float* res;              // (1,) residual, zeroed by the caller
  long long num_nodes;     // nb * BV
  long long num_edges;     // nb * EB
  long long u_offset;      // klo * EB: storage row of owned edge 0
  long long u_rows;        // rows of the edge store
  int n;
  int max_deg;
  int reg_kind;            // 0: tv (clip), 1: tv2 (scaling)
  int relax;               // rho != 1
  float rho;
  int iters;
  int compute_residual;
};

__device__ __forceinline__ float clip(float x, float l) {
  return fminf(fmaxf(x, -l), l);
}

template <int MAXN>
__global__ void __launch_bounds__(kThreads)
fused_pd_step_kernel(PdArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int n = a.n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float* w_in = a.w_in;
  const float* u_in = a.u_in;
  long long u_off = a.u_offset;
  float rmax = 0.0f;

  for (int it = 0; it < a.iters; ++it) {
    // ---- node phase: gather D^T u, squared-loss prox, z, KM ----------
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
          e = e < 0 ? 0 : (e >= a.u_rows ? a.u_rows - 1 : e);
          const float* ue = u_in + e * n;
#pragma unroll
          for (int k = 0; k < MAXN; ++k)
            if (k < n) dtu[k] += s * ue[k];
        }
      }
      const float t = a.tau[i];
      float w[MAXN], v[MAXN];
#pragma unroll
      for (int k = 0; k < MAXN; ++k) {
        if (k < n) {
          w[k] = w_in[i * n + k];
          v[k] = (w[k] - t * dtu[k]) + a.b[i * n + k];
        }
      }
      const float* pi = a.p + i * n * n;
#pragma unroll
      for (int j = 0; j < MAXN; ++j) {
        if (j < n) {
          float wp = 0.0f;
#pragma unroll
          for (int k = 0; k < MAXN; ++k)
            if (k < n) wp += pi[j * n + k] * v[k];
          a.z[i * n + j] = 2.0f * wp - w[j];
          const float wn = a.relax ? w[j] + a.rho * (wp - w[j]) : wp;
          a.w_out[i * n + j] = wn;
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
      const float* uo = u_in + (u_off + e) * n;
      for (int k = 0; k < n; ++k) {
        const float u0 = uo[k];
        const float x = u0 + sg * (a.z[s * n + k] - a.z[d * n + k]);
        const float up = a.reg_kind == 0 ? clip(x, l) : x * scale;
        float y = up;
        if (a.relax) {
          y = u0 + a.rho * (up - u0);
          if (a.reg_kind == 0) y = clip(y, l);
        }
        a.u_out[e * n + k] = y;
        if (a.compute_residual) rmax = fmaxf(rmax, fabsf(y - u0) / sg);
      }
    }
    if (it + 1 < a.iters) {
      grid.sync();
      w_in = a.w_out;
      u_in = a.u_out;
      u_off = 0;
    }
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

template <int MAXN>
cudaError_t launch(const PdArgs& args, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_pd_step_kernel<MAXN>, kThreads, 0);
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
      (void*)fused_pd_step_kernel<MAXN>, dim3((unsigned)blocks),
      dim3(kThreads), kargs, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_pd_step_launch(
    const float* w_in, const float* u_in, const int* inc_edges,
    const float* inc_signs, const float* b, const float* p, const float* tau,
    const int* src, const int* dst, const float* sigma, const float* la,
    float* w_out, float* u_out, float* z, float* res, long long num_nodes,
    long long num_edges, long long u_offset, long long u_rows, int n,
    int max_deg, int reg_kind, float rho, int relax, int iters,
    int compute_residual, void* stream) {
  PdArgs a{w_in,  u_in,  inc_edges, inc_signs, b,         p,
           tau,   src,   dst,       sigma,     la,        w_out,
           u_out, z,     res,       num_nodes, num_edges, u_offset,
           u_rows, n,    max_deg,   reg_kind,  relax,     rho,
           iters, compute_residual};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (n <= 2) err = launch<2>(a, s);
  else if (n <= 4) err = launch<4>(a, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
