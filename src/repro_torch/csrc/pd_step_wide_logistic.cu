// Fused primal-dual step for Hopper: the logistic loss's wide
// instantiations in float32 storage (n > 16, a node a warp, a Hessian row
// a thread; see pd_step_wide.cuh), staged and streamed, and the entry to
// its bfloat16 ones (pd_step_wide_logistic_bf16.cu).  Each storage type
// is compiled on its own so that kernels/_build.py builds them in
// parallel.

#include "pd_step_wide.cuh"

namespace repro_pd {

cudaError_t pd_launch_wide_logistic(const PdArgs& a, cudaStream_t s,
                                    bool staged) {
  if (a.storage == kBF16) return pd_launch_wide_logistic_bf16(a, s, staged);
  if (a.storage != kF32) return cudaErrorInvalidValue;
  return dispatch_wide<kLogistic, float>(a, s, staged);
}

}  // namespace repro_pd
