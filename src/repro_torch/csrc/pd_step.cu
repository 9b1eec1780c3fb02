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

// The shared memory a launch of loss `loss_kind` at n features and
// num_samples samples a node stages for each node (*node_bytes), and the
// most a block may stage (*limit).  A launch whose node passes the limit
// is refused: the wrapper asks first, and so does the solver's fused
// gate.  Returns a CUDA error code.
extern "C" int fused_pd_step_staging(int loss_kind, int n, int num_samples,
                                     long long* node_bytes,
                                     long long* limit) {
  using namespace repro_pd;
  if (loss_kind < kSquared || loss_kind > kLogistic || n < 1 ||
      num_samples < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  *node_bytes = stage_layout(loss_kind, n, num_samples, p);
  *limit = kSmemMax;
  return 0;
}
