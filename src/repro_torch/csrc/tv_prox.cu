// Edge-wise dual clip (paper Algorithm 1, step 10) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/tv_prox.py:tv_prox
// (body _tv_prox_kernel): out[e, j] = clip(u[e, j], -bound[e], bound[e]),
// u (E, n) float32, bound (E,) float32.  Its plain version is
// src/repro_torch/kernels/ref.py:tv_prox_ref (torch.clamp with tensor
// bounds); fminf(fmaxf(u, -b), b) is that clamp bit for bit on finite
// inputs.
//
// What bounds it: bytes.  Each element is read once and written once and
// each bound read once: 4 (2 E n + E) bytes for two float operations per
// element, far below the card's float rate.  At the unfused 1M-node solve
// (E = 10.2M, n = 2) that is 204 MB, 0.061 ms at 3.35 TB/s.
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

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
tv_prox_kernel(const float* __restrict__ u, const float* __restrict__ bound,
               float* __restrict__ out, Idx total, Idx n) {
  const Idx stride = (Idx)gridDim.x * blockDim.x;
  for (Idx i = (Idx)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const float b = bound[i / n];
    out[i] = fminf(fmaxf(u[i], -b), b);
  }
}

}  // namespace

extern "C" int tv_prox_launch(const float* u, const float* bound, float* out,
                              long long num_edges, int n, void* stream) {
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
  if (total < (1LL << 31))
    tv_prox_kernel<unsigned><<<(unsigned)blocks, kThreads, 0, s>>>(
        u, bound, out, (unsigned)total, (unsigned)n);
  else
    tv_prox_kernel<unsigned long long><<<(unsigned)blocks, kThreads, 0, s>>>(
        u, bound, out, (unsigned long long)total, (unsigned long long)n);
  return static_cast<int>(cudaGetLastError());
}
