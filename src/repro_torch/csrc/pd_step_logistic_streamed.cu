// Fused primal-dual step for Hopper: the logistic loss's streamed
// register-tile instantiations (n <= 16), for nodes whose samples pass
// the staging plan: a block a labeled node, its samples split over the
// block's threads and staged once in shared memory (see
// pd_step_streamed.cuh).  Compiled on its own so that kernels/_build.py
// builds it beside the staged one; the only unit that instantiates the
// streamed kernel (pd_step.cu includes its header for the plan alone).

#include "pd_step_streamed.cuh"

namespace repro_pd {

template <typename T, bool MULTI>
cudaError_t launch_streamed_width(const PdArgs& a, cudaStream_t s) {
  if (a.n <= 2) return launch_streamed<2, T, MULTI>(a, s);
  if (a.n <= 4) return launch_streamed<4, T, MULTI>(a, s);
  if (a.n <= 8) return launch_streamed<8, T, MULTI>(a, s);
  if (a.n <= kTileFeatures) return launch_streamed<16, T, MULTI>(a, s);
  return cudaErrorInvalidValue;
}

// The streamed variant's launch: storage type, lanes, register tile.
cudaError_t pd_launch_logistic_streamed(const PdArgs& a, cudaStream_t s) {
  if (a.n < 1 || a.num_lanes < 1) return cudaErrorInvalidValue;
  const bool multi = a.num_lanes > 1;
  if (a.storage == kF32)
    return multi ? launch_streamed_width<float, true>(a, s)
                 : launch_streamed_width<float, false>(a, s);
  if (a.storage == kBF16)
    return multi ? launch_streamed_width<__nv_bfloat16, true>(a, s)
                 : launch_streamed_width<__nv_bfloat16, false>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace repro_pd
