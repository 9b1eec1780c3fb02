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
// The Jacobi: a round rotates a set of disjoint (p, q) pairs at once (the
// round-robin order of engine/step.py:_jacobi_plan: n - 1 rounds of n / 2
// pairs, n rounds for an odd n), each pair's angle from the round's A
// (t = sign(theta) / (|theta| + sqrt(theta^2 + 1)), theta = (a_qq - a_pp)
// / (2 a_pq); no turn where a_pq is 0, but the pair is still rotated by
// c = 1, s = 0), then A <- A J, V <- V J over columns and A <- J^T A over
// rows.  After the sweeps the eigenvalues are A's diagonal; those with
// |lambda| <= 10 n eps max |lambda| are cut (as the reference's
// jnp.linalg.pinv cuts singular values), and out = V diag(1 / lambda) V^T,
// each entry summed over k in order.  Nothing is read on the host, so it
// runs under torch.cuda.set_sync_debug_mode("error") and in a CUDA-graph
// capture.
//
// Three variants by width (sym_pinv_plan names the one a width gets).
// Each does, for every entry, the float operations of the others in the
// same order (a round's pairs are disjoint, so which thread rotates which
// pair does not matter), so all three give the same bits, those of one
// block a matrix at every width:
//   * thread (n <= kThreadMax = 4; the main path's n = 2): a thread a
//     matrix, A and V in registers, every round and pair unrolled at
//     compile time; 256 threads a block, no shared memory.  A matrix of 4
//     or 16 floats is read and written as 16-byte vectors where both
//     pointers are 16-byte aligned (a contiguous batch of them from
//     PyTorch's allocator is: each matrix is a whole number of 16-byte
//     words), else a float at a time.
//   * warp (n <= kWarpMax = 32): a warp a matrix, kWarpsPerBlock warps a
//     block, each with its own slice of shared memory: A and V with rows
//     padded to an odd stride (no bank conflict down a column), and the
//     kept inverses.  A lane is a (row group, pair slot); every lane of a
//     slot computes the slot's angle itself (the warp issues the angle
//     once whichever lanes compute it, and no shuffle waits on it) and
//     rotates its pair over its group's rows and columns; each slot's
//     seats turn by a decrement, not a modulo; __syncwarp() between
//     phases, no block barrier.
//   * block (up to the width whose two matrices fill a block's shared
//     memory: n = 169): one thread block a matrix, its rows padded to an
//     odd stride and neighbouring threads on neighbouring rows (columns)
//     of a pair, so no phase has a bank conflict (down a column of rows
//     of an even width every read hits one bank: 32-way at n = 64).
//
// What bounds it: at n = 2 the bytes (one matrix in, one out, 32 bytes a
// matrix; the thread variant has three divisions and two square roots of
// work a matrix); past that the operations, n^3 a sweep a matrix.  In the
// warp variant it is the instructions a round issues per matrix (a lane
// rotates n / (32 / slots) entry pairs of A and V out of shared memory).
//
// Build: compiled by kernels/_build.py with the port's other sources into
// one shared library; plain C entry points, loaded with ctypes by
// src/repro_torch/kernels/sym_pinv.py.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr long long kSmemMax = 227 * 1024;   // a block's opt-in maximum
constexpr long long kSmemDefault = 48 * 1024;
constexpr int kThreadMax = 4;        // widest matrix of the thread variant
constexpr int kThreadBlock = 256;
constexpr int kWarpMax = 32;         // widest matrix of the warp variant
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

enum Variant { kThread = 0, kWarp = 1, kBlock = 2 };

// the index at `seat` in round r of the round-robin over m seats: seat 0
// stays, the others turn one place a round
__host__ __device__ constexpr int seat_index(int seat, int r, int m) {
  return seat == 0 ? 0 : 1 + ((seat - 1 - r) % (m - 1) + (m - 1)) % (m - 1);
}

// the index at a seat other than 0 one round on, from `idx` (>= 1)
__device__ __forceinline__ int next_seat(int idx, int m) {
  return idx == 1 ? m - 1 : idx - 1;
}

// the rotation (c, s) of a pair from a_pp, a_qq and a_pq
__device__ __forceinline__ void jacobi_angle(float app, float aqq, float apq,
                                             float& c, float& s) {
  c = 1.0f;
  s = 0.0f;
  if (apq != 0.0f) {
    const float theta = (aqq - app) / (2.0f * apq);
    const float t = theta == 0.0f
                        ? 1.0f
                        : copysignf(1.0f, theta) /
                              (fabsf(theta) + sqrtf(theta * theta + 1.0f));
    c = 1.0f / sqrtf(t * t + 1.0f);
    s = t * c;
  }
}

// (x, y) <- (c x - s y, s x + c y)
__device__ __forceinline__ void rotate(float& x, float& y, float c, float s) {
  const float xp = x, yq = y;
  x = c * xp - s * yq;
  y = s * xp + c * yq;
}

__device__ __forceinline__ float kept_inverse(float lam, float cut) {
  return fabsf(lam) > cut ? 1.0f / lam : 0.0f;
}

// ---------------------------------------------------------------------------
// thread variant: a thread a matrix, in registers
// ---------------------------------------------------------------------------

template <int N, bool kVec>
__global__ void __launch_bounds__(kThreadBlock)
    sym_pinv_thread(const float* __restrict__ a, float* __restrict__ out,
                    long long batch, int sweeps) {
  constexpr int NN = N * N, M = N + (N & 1), SLOTS = M / 2;
  const long long b = (long long)blockIdx.x * kThreadBlock + threadIdx.x;
  if (b >= batch) return;
  float A[N][N], V[N][N];
  if constexpr (kVec) {
    const float4* src = reinterpret_cast<const float4*>(a + b * NN);
#pragma unroll
    for (int w = 0; w < NN / 4; ++w) {
      const float4 v = src[w];
      A[(4 * w) / N][(4 * w) % N] = v.x;
      A[(4 * w + 1) / N][(4 * w + 1) % N] = v.y;
      A[(4 * w + 2) / N][(4 * w + 2) % N] = v.z;
      A[(4 * w + 3) / N][(4 * w + 3) % N] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < NN; ++e) A[e / N][e % N] = a[b * NN + e];
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) V[i][j] = i == j ? 1.0f : 0.0f;
  for (int sw = 0; sw < sweeps; ++sw) {
#pragma unroll
    for (int r = 0; r < M - 1; ++r) {
      float c[SLOTS], s[SLOTS];
#pragma unroll
      for (int h = 0; h < SLOTS; ++h) {
        const int i0 = seat_index(h, r, M), i1 = seat_index(M - 1 - h, r, M);
        const int p = i0 < i1 ? i0 : i1, q = i0 < i1 ? i1 : i0;
        if (q < N) jacobi_angle(A[p][p], A[q][q], A[p][q], c[h], s[h]);
      }
      // columns p, q of A and V: A <- A J, V <- V J
#pragma unroll
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int h = 0; h < SLOTS; ++h) {
          const int i0 = seat_index(h, r, M), i1 = seat_index(M - 1 - h, r, M);
          const int p = i0 < i1 ? i0 : i1, q = i0 < i1 ? i1 : i0;
          if (q < N) {
            rotate(A[i][p], A[i][q], c[h], s[h]);
            rotate(V[i][p], V[i][q], c[h], s[h]);
          }
        }
      }
      // rows p, q of A: A <- J^T A
#pragma unroll
      for (int j = 0; j < N; ++j) {
#pragma unroll
        for (int h = 0; h < SLOTS; ++h) {
          const int i0 = seat_index(h, r, M), i1 = seat_index(M - 1 - h, r, M);
          const int p = i0 < i1 ? i0 : i1, q = i0 < i1 ? i1 : i0;
          if (q < N) rotate(A[p][j], A[q][j], c[h], s[h]);
        }
      }
    }
  }
  float mx = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) mx = fmaxf(mx, fabsf(A[k][k]));
  const float cut = 10.0f * (float)N * FLT_EPSILON * mx;
  float inv[N];
#pragma unroll
  for (int k = 0; k < N; ++k) inv[k] = kept_inverse(A[k][k], cut);
  float o[NN];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < N; ++k) acc += V[i][k] * inv[k] * V[j][k];
      o[i * N + j] = acc;
    }
  }
  if constexpr (kVec) {
    float4* dst = reinterpret_cast<float4*>(out + b * NN);
#pragma unroll
    for (int w = 0; w < NN / 4; ++w)
      dst[w] = make_float4(o[4 * w], o[4 * w + 1], o[4 * w + 2], o[4 * w + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < NN; ++e) out[b * NN + e] = o[e];
  }
}

template <int N>
cudaError_t launch_thread(const float* a, float* out, long long batch,
                          int sweeps, cudaStream_t stream) {
  const unsigned grid = (unsigned)((batch + kThreadBlock - 1) / kThreadBlock);
  const bool aligned =
      ((reinterpret_cast<std::uintptr_t>(a) |
        reinterpret_cast<std::uintptr_t>(out)) & 15) == 0;
  if constexpr ((N * N) % 4 == 0) {
    if (aligned) {
      sym_pinv_thread<N, true><<<grid, kThreadBlock, 0, stream>>>(
          a, out, batch, sweeps);
      return cudaGetLastError();
    }
  }
  sym_pinv_thread<N, false><<<grid, kThreadBlock, 0, stream>>>(a, out, batch,
                                                               sweeps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// warp variant: a warp a matrix, in the warp's slice of shared memory
// ---------------------------------------------------------------------------

// floats of one warp's slice: A and V (n rows of an odd stride) and the
// kept inverses
__host__ __device__ inline long long warp_floats(int n) {
  return 2LL * n * (n | 1) + n;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    sym_pinv_warp(const float* __restrict__ a, float* __restrict__ out,
                  long long batch, int n, int sweeps) {
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= batch) return;            // the whole warp: no block barrier
  const int ld = n | 1, nn = n * n;
  float* A = sm + warp * warp_floats(n);
  float* V = A + n * ld;
  float* inv = V + n * ld;
  const float* src = a + b * nn;
  for (int e = lane; e < nn; e += 32) {
    const int i = e / n, j = e - i * n;
    A[i * ld + j] = src[e];
    V[i * ld + j] = i == j ? 1.0f : 0.0f;
  }
  const int m = n + (n & 1), slots = m / 2;
  // this lane's pair slot and row group; lanes past groups * slots idle
  // (their first row is past the last)
  const int groups = 32 / slots, h = lane % slots;
  const int g = lane < groups * slots ? lane / slots : n;
  __syncwarp();
  for (int sw = 0; sw < sweeps; ++sw) {
    int i0 = h, i1 = m - 1 - h;      // the slot's seats' indices in round 0
    for (int r = 0; r < m - 1; ++r) {
      // the slot's pair and angle, in every lane of the slot (the warp
      // issues the angle once whichever lanes compute it)
      const int p = i0 < i1 ? i0 : i1, q = i0 < i1 ? i1 : i0;
      const bool live = q < n;       // else the empty seat's pair
      float c = 1.0f, s = 0.0f;
      if (live)
        jacobi_angle(A[p * ld + p], A[q * ld + q], A[p * ld + q], c, s);
      if (h != 0) i0 = next_seat(i0, m);
      i1 = next_seat(i1, m);
      __syncwarp();
      // columns p, q of A and V over this lane's rows: A <- A J, V <- V J
      if (live) {
#pragma unroll 4
        for (int i = g; i < n; i += groups) {
          rotate(A[i * ld + p], A[i * ld + q], c, s);
          rotate(V[i * ld + p], V[i * ld + q], c, s);
        }
      }
      __syncwarp();
      // rows p, q of A over this lane's columns: A <- J^T A
      if (live) {
#pragma unroll 4
        for (int j = g; j < n; j += groups)
          rotate(A[p * ld + j], A[q * ld + j], c, s);
      }
      __syncwarp();
    }
  }
  const float lam = lane < n ? A[lane * ld + lane] : 0.0f;
  float mx = fabsf(lam);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  const float cut = 10.0f * (float)n * FLT_EPSILON * mx;
  if (lane < n) inv[lane] = kept_inverse(lam, cut);
  __syncwarp();
  float* dst = out + b * nn;
  for (int e = lane; e < nn; e += 32) {
    const int i = e / n, j = e - i * n;
    float acc = 0.0f;
#pragma unroll 4
    for (int k = 0; k < n; ++k) acc += V[i * ld + k] * inv[k] * V[j * ld + k];
    dst[e] = acc;
  }
}

// ---------------------------------------------------------------------------
// block variant: a thread block a matrix
// ---------------------------------------------------------------------------

// shared bytes of one matrix's block: A and V (n rows of an odd stride),
// per pair slot (c, s) and (p, q), the eigenvalues and their inverses
inline long long block_bytes(int n) {
  const long long slots = (n + 1) / 2;
  return 4 * (2LL * n * (n | 1) + 4 * slots + 2LL * n);
}

__global__ void sym_pinv_block(const float* __restrict__ a,
                               float* __restrict__ out, int n, int sweeps) {
  extern __shared__ __align__(16) float sm[];
  const int nn = n * n, ld = n | 1;
  const int m = n + (n & 1);        // seats, one empty for an odd n
  const int slots = m / 2;          // pair slots a round
  float* A = sm;
  float* V = A + n * ld;
  float* cs = V + n * ld;           // (c, s) per slot
  int* pq = reinterpret_cast<int*>(cs + 2 * slots);  // (p, q); p -1: none
  float* lam = reinterpret_cast<float*>(pq + 2 * slots);
  float* inv = lam + n;
  const long long b = blockIdx.x;
  const float* src = a + b * nn;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int i = e / n, j = e - i * n;
    A[i * ld + j] = src[e];
    V[i * ld + j] = i == j ? 1.0f : 0.0f;
  }
  __syncthreads();
  for (int sw = 0; sw < sweeps; ++sw) {
    for (int r = 0; r < m - 1; ++r) {
      for (int h = threadIdx.x; h < slots; h += blockDim.x) {
        const int i0 = seat_index(h, r, m), i1 = seat_index(m - 1 - h, r, m);
        const int p = i0 < i1 ? i0 : i1, q = i0 < i1 ? i1 : i0;
        float c = 1.0f, s = 0.0f;
        if (q >= n) {                 // the empty seat's pair
          pq[2 * h] = -1;
        } else {
          pq[2 * h] = p;
          pq[2 * h + 1] = q;
          jacobi_angle(A[p * ld + p], A[q * ld + q], A[p * ld + q], c, s);
        }
        cs[2 * h] = c;
        cs[2 * h + 1] = s;
      }
      __syncthreads();
      // columns p, q of A and V, neighbouring threads on neighbouring
      // rows: A <- A J, V <- V J
      for (int idx = threadIdx.x; idx < n * slots; idx += blockDim.x) {
        const int h = idx / n, i = idx - h * n;
        const int p = pq[2 * h];
        if (p < 0) continue;
        const int q = pq[2 * h + 1];
        const float c = cs[2 * h], s = cs[2 * h + 1];
        rotate(A[i * ld + p], A[i * ld + q], c, s);
        rotate(V[i * ld + p], V[i * ld + q], c, s);
      }
      __syncthreads();
      // rows p, q of A, neighbouring threads on neighbouring columns:
      // A <- J^T A
      for (int idx = threadIdx.x; idx < n * slots; idx += blockDim.x) {
        const int h = idx / n, j = idx - h * n;
        const int p = pq[2 * h];
        if (p < 0) continue;
        const int q = pq[2 * h + 1];
        rotate(A[p * ld + j], A[q * ld + j], cs[2 * h], cs[2 * h + 1]);
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) lam[i] = A[i * ld + i];
  __syncthreads();
  float mx = 0.0f;
  for (int i = 0; i < n; ++i) mx = fmaxf(mx, fabsf(lam[i]));
  const float cut = 10.0f * (float)n * FLT_EPSILON * mx;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    inv[i] = kept_inverse(lam[i], cut);
  __syncthreads();
  float* dst = out + b * nn;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int i = e / n, j = e - i * n;
    float acc = 0.0f;
    for (int k = 0; k < n; ++k) acc += V[i * ld + k] * inv[k] * V[j * ld + k];
    dst[e] = acc;
  }
}

// the variant a width gets
int pick(int n) {
  return n <= kThreadMax ? kThread : n <= kWarpMax ? kWarp : kBlock;
}

// shared bytes a block of width n's variant takes
long long variant_bytes(int n) {
  switch (pick(n)) {
    case kThread: return 0;
    case kWarp: return 4 * kWarpsPerBlock * warp_floats(n);
    default: return block_bytes(n);
  }
}

}  // namespace

// The variant width n gets (*variant: 0 thread, 1 warp, 2 block), the
// shared bytes a block of it takes (*need) and the most a block may take
// (*limit): past it the launch is refused.
extern "C" int sym_pinv_plan(int n, long long* need, long long* limit,
                             int* variant) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  *variant = pick(n);
  *need = variant_bytes(n);
  *limit = kSmemMax;
  return 0;
}

// out[b] = pinv(a[b]) for `batch` contiguous symmetric n x n float32
// matrices, `sweeps` Jacobi sweeps, by width n's variant, on `stream`;
// returns a CUDA error code.
extern "C" int sym_pinv_launch(const float* a, float* out, long long batch,
                               int n, int sweeps, void* stream) {
  if (batch < 0 || batch > 0x7fffffffLL || n < 1 || sweeps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = variant_bytes(n);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pick(n)) {
    case kThread:
      switch (n) {
        case 1: return static_cast<int>(launch_thread<1>(a, out, batch, sweeps, st));
        case 2: return static_cast<int>(launch_thread<2>(a, out, batch, sweeps, st));
        case 3: return static_cast<int>(launch_thread<3>(a, out, batch, sweeps, st));
        default: return static_cast<int>(launch_thread<4>(a, out, batch, sweeps, st));
      }
    case kWarp: {
      const unsigned grid =
          (unsigned)((batch + kWarpsPerBlock - 1) / kWarpsPerBlock);
      sym_pinv_warp<<<grid, kWarpsPerBlock * 32, (size_t)smem, st>>>(
          a, out, batch, n, sweeps);
      return static_cast<int>(cudaGetLastError());
    }
    default: {
      if (smem > kSmemDefault) {
        const cudaError_t err = cudaFuncSetAttribute(
            sym_pinv_block, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return static_cast<int>(err);
      }
      const long long work = (long long)n * ((n + 1) / 2);
      int threads = 32;
      while (threads < 256 && threads < work) threads <<= 1;
      sym_pinv_block<<<(unsigned)batch, threads, (size_t)smem, st>>>(
          a, out, n, sweeps);
      return static_cast<int>(cudaGetLastError());
    }
  }
}
