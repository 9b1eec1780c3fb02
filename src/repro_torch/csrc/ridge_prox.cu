// Batched node-wise affine map (squared-loss primal update, paper eq. 21)
// for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ridge_prox.py:
// batched_affine (body _ridge_kernel): out[i, r] = sum_k p[i, r, k] v[i, k]
// for p (V, n, n), v (V, n), float32, summed in float32 with k ascending;
// and the same over a leading lane axis, v (L, V, n), with one P (V, n, n)
// shared by every lane (a lambda path: the prox matrices do not depend on
// lambda) or one per lane, p (L, V, n, n) (a batch of problems) -- the
// grid axis jax.vmap adds to the reference kernel.
// Its plain version is src/repro_torch/kernels/ref.py:batched_affine_ref.
//
// What bounds it: bytes.  It reads p and v once and writes out once,
// 4 V (n^2 + 2 n) bytes for 2 V n^2 float operations: half an operation
// per byte, far below the card's float rate.  At the unfused 1M-node solve
// (V = 1M, n = 2) that is 32 MB, 0.0096 ms at 3.35 TB/s; launch latency
// is of the same order.  With L lanes: 4 L V 2 n bytes of v and out, and
// P once when it is shared (4 V n^2), L times when it is not.
//
// Design.  One thread per output element (i, r) in a grid-stride loop,
// with n a runtime value of any size (the JAX package's tests go to
// n = 32).  Thread (i, r) reads the row p[i, r, :], which starts where
// thread (i, r - 1)'s ends, so a warp reads one contiguous stretch of p
// (for small n its loads coalesce); v[i, :] is shared by the n threads of
// a node.  Lanes are more rows of the same flat loop, one launch for all:
// the lane stride of P is a template choice, so a shared P is never
// copied L times and the one-lane kernel is unchanged (lane l's thread
// reads the P rows of node i mod V; they stay in L2 across lanes when P
// fits it, 16 MB at 1M nodes, n = 2).  The TPU kernel runs this on the
// MXU per 256-node tile; at
// n = 2..32 there is nothing for Hopper's tensor cores to do.  Later work:
// 16-byte vector loads, and folding this map into a kernel that also forms
// v = w - tau D^T u + b, which would remove one (V, n) round trip through
// device memory per iteration.
//
// Build: src/repro_torch/kernels/_build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -Xcompiler -fPIC, linked with the other
// sources into one shared library); plain C entry point, loaded with
// ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// SHARED: one P for every lane (element i of lane l reads the P row of
// element i - l V n); otherwise P[l] for lane l (P's index is i).
template <typename Idx, bool SHARED>
__global__ void __launch_bounds__(kThreads)
batched_affine_kernel(const float* __restrict__ p,
                      const float* __restrict__ v, float* __restrict__ out,
                      Idx total, Idx n, Idx lane_elems,
                      unsigned long long* executions) {
  if (executions != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(executions, 1ULL);
  const Idx stride = (Idx)gridDim.x * blockDim.x;
  for (Idx i = (Idx)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    // p[node, r, :], i = node * n + r (node counted across lanes)
    const float* row = p + (SHARED ? i % lane_elems : i) * n;
    const float* vi = v + (i / n) * n;   // v[node, :]
    float acc = 0.0f;
    for (Idx k = 0; k < n; ++k) acc = fmaf(row[k], vi[k], acc);
    out[i] = acc;
  }
}

template <typename Idx>
void launch(const float* p, const float* v, float* out, Idx total, Idx n,
            Idx lane_elems, bool shared, unsigned long long* executions,
            unsigned blocks, cudaStream_t s) {
  if (shared)
    batched_affine_kernel<Idx, true><<<blocks, kThreads, 0, s>>>(
        p, v, out, total, n, lane_elems, executions);
  else
    batched_affine_kernel<Idx, false><<<blocks, kThreads, 0, s>>>(
        p, v, out, total, n, lane_elems, executions);
}

}  // namespace

// v and out (lanes, num_nodes, n); p (lanes, num_nodes, n, n) or, with
// shared_p, (num_nodes, n, n) for every lane; float32.  executions: null,
// or the kernel's execution count (block 0 adds one each time the kernel
// runs, launched or replayed from a CUDA graph).
extern "C" int batched_affine_launch(const float* p, const float* v,
                                     float* out, long long lanes,
                                     long long num_nodes, int n,
                                     int shared_p,
                                     unsigned long long* executions,
                                     void* stream) {
  if (lanes <= 0 || num_nodes <= 0 || n <= 0)
    return static_cast<int>(cudaSuccess);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = lanes * num_nodes * n;
  const long long lane_elems = num_nodes * n;
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * (2048 / kThreads);  // one full wave
  if (blocks > cap) blocks = cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // one lane's P is the same array either way: the plain kernel
  const bool shared = shared_p != 0 && lanes > 1;
  // p has up to total * n elements: the index type must hold that offset
  if (total * n < (1LL << 31))
    launch<unsigned>(p, v, out, (unsigned)total, (unsigned)n,
                     (unsigned)lane_elems, shared, executions,
                     (unsigned)blocks, s);
  else
    launch<unsigned long long>(p, v, out, (unsigned long long)total,
                               (unsigned long long)n,
                               (unsigned long long)lane_elems, shared,
                               executions, (unsigned)blocks, s);
  return static_cast<int>(cudaGetLastError());
}
