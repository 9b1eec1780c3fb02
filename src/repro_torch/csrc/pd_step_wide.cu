// Fused primal-dual step for Hopper: the squared loss's wide
// instantiations (n > 16, a node a warp; see pd_step_wide.cuh), staged
// and streamed.  Each wide loss is compiled on its own (the logistic
// loss's in one unit per storage type) so that kernels/_build.py builds
// them beside the other variants.

#include "pd_step_wide.cuh"

namespace repro_pd {

cudaError_t pd_launch_wide_squared(const PdArgs& a, cudaStream_t s,
                                   bool staged) {
  return dispatch_wide<kSquared>(a, s, staged);
}

}  // namespace repro_pd
