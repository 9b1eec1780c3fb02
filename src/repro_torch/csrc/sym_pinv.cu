// Pseudo-inverse of a batch of symmetric float32 matrices for Hopper: the
// eq.-11 certificate's (src/repro_torch/engine/step.py:optimality_gap).
//
// Not a port of a TPU kernel: the reference calls jnp.linalg.pinv there.
// It replaces the certificate's plain version, engine/step.py:sym_pinv,
// which runs the same cyclic Jacobi as some 20 tensor ops a round (15
// rounds a sweep at n = 16, 8 sweeps): on the card the certificate was
// bound by those launches, not by the card.  torch.linalg.pinv reads its
// solver's status on the host, so it is no option on a solve's path.
//
// Design: one thread block a matrix, the matrix A and the rotations' V in
// shared memory (2 n^2 floats).  A round rotates a set of disjoint (p, q)
// pairs at once (the round-robin order of engine/step.py:_jacobi_plan:
// n - 1 rounds of n / 2 pairs, n rounds for an odd n), each pair's angle
// from the round's A (t = sign(theta) / (|theta| + sqrt(theta^2 + 1)),
// theta = (a_qq - a_pp) / (2 a_pq); no rotation where a_pq is 0), then
// A <- A J, V <- V J over columns and A <- J^T A over rows.  After the
// sweeps the eigenvalues are A's diagonal; those with |lambda| <= 10 n eps
// max |lambda| are cut (as the reference's jnp.linalg.pinv cuts singular
// values), and out = V diag(1 / lambda) V^T.  Nothing is read on the
// host, so it runs under torch.cuda.set_sync_debug_mode("error") and in a
// CUDA-graph capture.  A width whose two matrices pass a block's shared
// memory is refused (sym_pinv_plan); the wrapper says so.
//
// What bounds it: operations, n^3 a sweep a matrix in shared memory,
// against 8 n^2 bytes of traffic (one matrix in, one out).
//
// Build: compiled by kernels/_build.py with the port's other sources into
// one shared library; plain C entry points, loaded with ctypes by
// src/repro_torch/kernels/sym_pinv.py.

#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr long long kSmemMax = 227 * 1024;   // a block's opt-in maximum
constexpr long long kSmemDefault = 48 * 1024;

// shared bytes of one matrix's block: A, V, per pair slot (c, s) and
// (p, q), the eigenvalues and their inverses
inline long long smem_bytes(int n) {
  const long long nn = (long long)n * n, slots = (n + 1) / 2;
  return 4 * (2 * nn + 4 * slots + 2LL * n);
}

__global__ void sym_pinv_kernel(const float* __restrict__ a,
                                float* __restrict__ out, int n,
                                int sweeps) {
  extern __shared__ __align__(16) float sm[];
  const int nn = n * n;
  const int m = n + (n & 1);        // seats, one empty for an odd n
  const int slots = m / 2;          // pair slots a round
  float* A = sm;
  float* V = A + nn;
  float* cs = V + nn;               // (c, s) per slot
  int* pq = reinterpret_cast<int*>(cs + 2 * slots);  // (p, q); p -1: none
  float* lam = reinterpret_cast<float*>(pq + 2 * slots);
  float* inv = lam + n;
  const long long b = blockIdx.x;
  const float* src = a + b * nn;
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    A[i] = src[i];
    V[i] = (i / n == i % n) ? 1.0f : 0.0f;
  }
  __syncthreads();
  for (int sw = 0; sw < sweeps; ++sw) {
    for (int r = 0; r < m - 1; ++r) {
      // the round's pairs: seat 0 stays, the others turn a place a round
      for (int h = threadIdx.x; h < slots; h += blockDim.x) {
        const int s0 = h, s1 = m - 1 - h;
        const int i0 = s0 == 0 ? 0 : 1 + ((s0 - 1 - r) % (m - 1) + (m - 1))
                                               % (m - 1);
        const int i1 = 1 + ((s1 - 1 - r) % (m - 1) + (m - 1)) % (m - 1);
        const int p = i0 < i1 ? i0 : i1, q = i0 < i1 ? i1 : i0;
        float c = 1.0f, s = 0.0f;
        if (q >= n) {                 // the empty seat's pair
          pq[2 * h] = -1;
        } else {
          pq[2 * h] = p;
          pq[2 * h + 1] = q;
          const float apq = A[p * n + q];
          if (apq != 0.0f) {
            const float theta = (A[q * n + q] - A[p * n + p]) / (2.0f * apq);
            const float t =
                theta == 0.0f
                    ? 1.0f
                    : copysignf(1.0f, theta) /
                          (fabsf(theta) + sqrtf(theta * theta + 1.0f));
            c = 1.0f / sqrtf(t * t + 1.0f);
            s = t * c;
          }
        }
        cs[2 * h] = c;
        cs[2 * h + 1] = s;
      }
      __syncthreads();
      // columns p, q of A and V: A <- A J, V <- V J
      for (int idx = threadIdx.x; idx < n * slots; idx += blockDim.x) {
        const int i = idx / slots, h = idx - i * slots;
        const int p = pq[2 * h];
        if (p < 0) continue;
        const int q = pq[2 * h + 1];
        const float c = cs[2 * h], s = cs[2 * h + 1];
        const float aip = A[i * n + p], aiq = A[i * n + q];
        A[i * n + p] = c * aip - s * aiq;
        A[i * n + q] = s * aip + c * aiq;
        const float vip = V[i * n + p], viq = V[i * n + q];
        V[i * n + p] = c * vip - s * viq;
        V[i * n + q] = s * vip + c * viq;
      }
      __syncthreads();
      // rows p, q of A: A <- J^T A
      for (int idx = threadIdx.x; idx < n * slots; idx += blockDim.x) {
        const int j = idx / slots, h = idx - j * slots;
        const int p = pq[2 * h];
        if (p < 0) continue;
        const int q = pq[2 * h + 1];
        const float c = cs[2 * h], s = cs[2 * h + 1];
        const float apj = A[p * n + j], aqj = A[q * n + j];
        A[p * n + j] = c * apj - s * aqj;
        A[q * n + j] = s * apj + c * aqj;
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) lam[i] = A[i * n + i];
  __syncthreads();
  float mx = 0.0f;
  for (int i = 0; i < n; ++i) mx = fmaxf(mx, fabsf(lam[i]));
  const float cut = 10.0f * (float)n * FLT_EPSILON * mx;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    inv[i] = fabsf(lam[i]) > cut ? 1.0f / lam[i] : 0.0f;
  __syncthreads();
  float* dst = out + b * nn;
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    const int i = idx / n, j = idx - i * n;
    float acc = 0.0f;
    for (int k = 0; k < n; ++k) acc += V[i * n + k] * inv[k] * V[j * n + k];
    dst[idx] = acc;
  }
}

}  // namespace

// The shared bytes one matrix of width n takes (*need) and the most a
// block may take (*limit): past it the launch is refused.
extern "C" int sym_pinv_plan(int n, long long* need, long long* limit) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  *need = smem_bytes(n);
  *limit = kSmemMax;
  return 0;
}

// out[b] = pinv(a[b]) for `batch` contiguous symmetric n x n float32
// matrices, `sweeps` Jacobi sweeps, on `stream`; returns a CUDA error code.
extern "C" int sym_pinv_launch(const float* a, float* out, long long batch,
                               int n, int sweeps, void* stream) {
  if (batch < 0 || batch > 0x7fffffffLL || n < 1 || sweeps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const long long smem = smem_bytes(n);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        sym_pinv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long work = (long long)n * ((n + 1) / 2);
  int threads = 32;
  while (threads < 256 && threads < work) threads <<= 1;
  sym_pinv_kernel<<<(unsigned)batch, threads, (size_t)smem,
                    static_cast<cudaStream_t>(stream)>>>(a, out, n, sweeps);
  return static_cast<int>(cudaGetLastError());
}
