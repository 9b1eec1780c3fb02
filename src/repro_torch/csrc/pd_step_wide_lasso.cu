// Fused primal-dual step for Hopper: the lasso loss's wide
// instantiations (n > 16, a node a warp, Q's row a thread; see
// pd_step_wide.cuh), staged and streamed.  Compiled on its own so that
// kernels/_build.py builds it beside the other variants.

#include "pd_step_wide.cuh"

namespace repro_pd {

cudaError_t pd_launch_wide_lasso(const PdArgs& a, cudaStream_t s,
                                 bool staged) {
  return dispatch_wide<kLasso>(a, s, staged);
}

}  // namespace repro_pd
