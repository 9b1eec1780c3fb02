// Fused primal-dual step for Hopper: the logistic loss's instantiations
// (damped Newton prox with the unrolled Cholesky solve in the node phase;
// see pd_step_impl.cuh and pd_step_lanes.cuh).  Compiled on its own so
// that kernels/_build.py builds the three losses in parallel.

#include "pd_step_lanes.cuh"

namespace repro_pd {

cudaError_t pd_launch_logistic(const PdArgs& a, cudaStream_t s) {
  return dispatch<kLogistic>(a, s);
}

}  // namespace repro_pd
