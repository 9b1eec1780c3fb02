// Fused primal-dual step for Hopper: the logistic loss's wide
// instantiations in bfloat16 storage (see pd_step_wide_logistic.cu and
// pd_step_wide.cuh), staged and streamed.

#include "pd_step_wide.cuh"

namespace repro_pd {

cudaError_t pd_launch_wide_logistic_bf16(const PdArgs& a, cudaStream_t s,
                                         bool staged) {
  return dispatch_wide<kLogistic, __nv_bfloat16>(a, s, staged);
}

}  // namespace repro_pd
