// Edge-wise dual clip (paper Algorithm 1, step 10) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/tv_prox.py:tv_prox
// (body _tv_prox_kernel): out[e, j] = clip(u[e, j], -bound[e], bound[e]),
// u (E, n) float32 or bfloat16, bound (E,) float32.  The lanes of a
// lambda path or a batch, u (L, E, n) with each lane's bounds (L, E) (the
// grid axis jax.vmap adds to the reference kernel), are the contiguous
// rows (L E, n) with bounds (L E,): one launch for every lane, as
// kernels/tv_prox.py passes them.  As in the reference
// (bound.astype(u.dtype)), the bound is rounded to u's type before the
// clip: for bfloat16 with __float2bfloat16_rn, round to nearest even like
// Tensor.to(torch.bfloat16).  Its plain version is
// src/repro_torch/kernels/ref.py:tv_prox_ref (torch.clamp with tensor
// bounds of u's dtype); fminf(fmaxf(u, -b), b) on the float values is that
// clamp bit for bit on finite inputs, and its result is one of u, -b, b,
// so storing it back as bfloat16 is exact.
//
// What bounds it: bytes.  Each element is read once and written once and
// each bound read once: s 2 E n + 4 E bytes (s = 4 for float32, 2 for
// bfloat16) for two float operations per element, far below the card's
// float rate.  At the unfused 1M-node solve (E = 10.2M, n = 2) that is
// 204 MB in float32, 0.061 ms at 3.35 TB/s.
//
// Design.  One thread per element (e, j) in a grid-stride loop; the TPU
// kernel pads E to a multiple of its 512-row tile, this one masks the
// ragged end itself, so the caller pads nothing.  Neighbouring threads
// touch neighbouring elements, so the loads and stores of u and out
// coalesce; the n threads of one row read the same bound, served by one
// sector.  Offsets are 64-bit only when E n needs them (the index type is
// a template parameter), so the common case divides by n in 32 bits.
// Vectorised 16-byte loads, and fusing the clip into the dual step that
// produces its input (u + sigma D z), are later work.
//
// Build: src/repro_torch/kernels/_build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -Xcompiler -fPIC, linked with the other
// sources into one shared library); plain C entry point, loaded with
// ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load(float x) { return x; }
__device__ __forceinline__ float load(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// the bound in u's type, back in float (exact for float)
__device__ __forceinline__ float round_to(float b, const float*) { return b; }
__device__ __forceinline__ float round_to(float b, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(b));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, typename Idx>
__global__ void __launch_bounds__(kThreads)
tv_prox_kernel(const T* __restrict__ u, const float* __restrict__ bound,
               T* __restrict__ out, Idx total, Idx n,
               unsigned long long* executions) {
  if (executions != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(executions, 1ULL);
  const Idx stride = (Idx)gridDim.x * blockDim.x;
  for (Idx i = (Idx)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const float b = round_to(bound[i / n], u);
    store(out + i, fminf(fmaxf(load(u[i]), -b), b));
  }
}

template <typename T>
void launch(const void* u, const float* bound, void* out, long long total,
            int n, unsigned long long* executions, unsigned blocks,
            cudaStream_t s) {
  const T* ut = static_cast<const T*>(u);
  T* ot = static_cast<T*>(out);
  if (total < (1LL << 31))
    tv_prox_kernel<T, unsigned><<<blocks, kThreads, 0, s>>>(
        ut, bound, ot, (unsigned)total, (unsigned)n, executions);
  else
    tv_prox_kernel<T, unsigned long long><<<blocks, kThreads, 0, s>>>(
        ut, bound, ot, (unsigned long long)total, (unsigned long long)n,
        executions);
}

}  // namespace

// storage: 0 = float32, 1 = bfloat16 (u and out); bound is float32.
// executions: null, or the kernel's execution count (block 0 adds one
// each time the kernel runs, launched or replayed from a CUDA graph).
extern "C" int tv_prox_launch(const void* u, const float* bound, void* out,
                              long long num_edges, int n, int storage,
                              unsigned long long* executions,
                              void* stream) {
  if (num_edges <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = num_edges * n;
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * (2048 / kThreads);  // one full wave
  if (blocks > cap) blocks = cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (storage == 0)
    launch<float>(u, bound, out, total, n, executions, (unsigned)blocks, s);
  else if (storage == 1)
    launch<__nv_bfloat16>(u, bound, out, total, n, executions,
                          (unsigned)blocks, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
