// Fused primal-dual step for Hopper: the lasso loss's instantiations (ISTA
// prox in the node phase; see pd_step_impl.cuh and pd_step_lanes.cuh).
// Compiled on its own so that kernels/_build.py builds the three losses in
// parallel.

#include "pd_step_lanes.cuh"

namespace repro_pd {

cudaError_t pd_launch_lasso(const PdArgs& a, cudaStream_t s) {
  return dispatch<kLasso>(a, s);
}

}  // namespace repro_pd
