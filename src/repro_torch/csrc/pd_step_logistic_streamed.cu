// Fused primal-dual step for Hopper: the logistic loss's streamed
// register-tile instantiations (n <= 16), for nodes whose samples pass
// the staging plan: the prox reads each node's parameter rows from device
// memory (see pd_step_impl.cuh).  Compiled on its own so that
// kernels/_build.py builds it beside the staged one.

#include "pd_step_impl.cuh"

namespace repro_pd {

cudaError_t pd_launch_logistic_streamed(const PdArgs& a, cudaStream_t s) {
  return dispatch<kLogistic, false>(a, s);
}

}  // namespace repro_pd
