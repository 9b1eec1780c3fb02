// Fused primal-dual step for Hopper: the C entry point, and the squared
// loss's instantiations.  The kernel is pd_step_impl.cuh (what it
// computes, its design and what bounds it); the lasso and logistic
// instantiations live in pd_step_lasso.cu and pd_step_logistic.cu so that
// kernels/_build.py compiles the three in parallel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -Xcompiler -fPIC,
// linked with the other sources into one shared library (see
// src/repro_torch/kernels/_build.py); plain C entry point, loaded with
// ctypes by src/repro_torch/kernels/pd_step.py.

#include "pd_step_impl.cuh"

namespace repro_pd {

cudaError_t pd_launch_squared(const PdArgs& a, cudaStream_t s) {
  return dispatch<kSquared>(a, s);
}

}  // namespace repro_pd

// One launch of the fused step described by *args on `stream`, over its
// num_lanes lanes; returns a CUDA error code (0 on success).  n must be
// 1..16.
extern "C" int fused_pd_step_launch(const repro_pd::PdArgs* args,
                                    void* stream) {
  using namespace repro_pd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (args->loss_kind) {
    case kSquared: err = pd_launch_squared(*args, s); break;
    case kLasso: err = pd_launch_lasso(*args, s); break;
    case kLogistic: err = pd_launch_logistic(*args, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The shared memory a launch of loss `loss_kind` at n features,
// num_samples samples a node and num_lanes lanes plans (*need: make_plan's
// total, the one-lane or the lane instantiation's as the launch picks),
// and the most a block may take (*limit).  A launch past the limit is
// refused: the wrapper asks first, and so does the solver's fused gate.
// Returns a CUDA error code.
extern "C" int fused_pd_step_staging(int loss_kind, int n, int num_samples,
                                     int num_lanes, long long* need,
                                     long long* limit) {
  using namespace repro_pd;
  if (loss_kind < kSquared || loss_kind > kLogistic || n < 1 ||
      num_samples < 0 || num_lanes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  PdArgs a{};
  a.n = n;
  a.num_samples = num_samples;
  a.num_lanes = num_lanes;
  Plan p;
  const bool multi = num_lanes > 1;
  switch (loss_kind) {
    case kSquared:
      *need = multi ? make_plan<16, kSquared, true>(a, p)
                    : make_plan<16, kSquared, false>(a, p);
      break;
    case kLasso:
      *need = multi ? make_plan<16, kLasso, true>(a, p)
                    : make_plan<16, kLasso, false>(a, p);
      break;
    default:
      *need = multi ? make_plan<16, kLogistic, true>(a, p)
                    : make_plan<16, kLogistic, false>(a, p);
  }
  *limit = kSmemMax;
  return 0;
}
