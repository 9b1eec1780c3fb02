// Fused primal-dual step for Hopper: the C entry points, and the squared
// loss's register-tile instantiations.  The kernel is pd_step_impl.cuh
// (n <= 16: what it computes, its design and what bounds it) and
// pd_step_wide.cuh (n > 16); the other variants live in their own
// translation units (pd_step.cuh) so that kernels/_build.py compiles them
// in parallel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -Xcompiler -fPIC,
// linked with the other sources into one shared library (see
// src/repro_torch/kernels/_build.py); plain C entry point, loaded with
// ctypes by src/repro_torch/kernels/pd_step.py.

#include <climits>

#include "pd_step_streamed.cuh"
#include "pd_step_wide.cuh"

namespace repro_pd {

cudaError_t pd_launch_squared(const PdArgs& a, cudaStream_t s) {
  return dispatch<kSquared>(a, s);
}

// The shared bytes of a launch of loss LOSS at n features, ms samples a
// node and `lanes` lanes, staged (*staged) and streamed (*streamed:
// LLONG_MAX where the loss has no streamed register-tile variant; its
// staged plan always fits).  No graph is needed: neither plan's size
// depends on one.
template <int LOSS>
void plan_bytes(int n, int ms, long long lanes, long long* staged,
                long long* streamed) {
  PdArgs a{};
  a.n = n;
  a.num_samples = ms;
  a.num_lanes = lanes;
  Plan p;
  const bool multi = lanes > 1;
  if (n > kTileFeatures) {
    *staged = multi ? make_wide_plan<LOSS, true>(a, p, true)
                    : make_wide_plan<LOSS, false>(a, p, true);
    *streamed = multi ? make_wide_plan<LOSS, true>(a, p, false)
                      : make_wide_plan<LOSS, false>(a, p, false);
    return;
  }
  *staged = multi ? make_plan<kTileFeatures, LOSS, true>(a, p, true)
                  : make_plan<kTileFeatures, LOSS, false>(a, p, true);
  *streamed = LLONG_MAX;
  if (LOSS == kLogistic) {
    StreamPlan sp;
    *streamed = multi ? make_streamed_plan<kTileFeatures, true>(a, sp)
                      : make_streamed_plan<kTileFeatures, false>(a, sp);
  }
}

inline cudaError_t plan_for(int loss_kind, int n, int ms, long long lanes,
                            long long* staged, long long* streamed) {
  if (n < 1 || ms < 0 || lanes < 1) return cudaErrorInvalidValue;
  switch (loss_kind) {
    case kSquared: plan_bytes<kSquared>(n, ms, lanes, staged, streamed);
      return cudaSuccess;
    case kLasso: plan_bytes<kLasso>(n, ms, lanes, staged, streamed);
      return cudaSuccess;
    case kLogistic: plan_bytes<kLogistic>(n, ms, lanes, staged, streamed);
      return cudaSuccess;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro_pd

// One launch of the fused step described by *args on `stream`, over its
// num_lanes lanes; returns a CUDA error code (0 on success).  The variant
// follows from the arguments: the register tile for n <= 16, the wide
// kernel past it; staged where the staging plan fits a block's shared
// memory, else streamed; refused (cudaErrorInvalidValue) where neither
// plan fits.
extern "C" int fused_pd_step_launch(const repro_pd::PdArgs* args,
                                    void* stream) {
  using namespace repro_pd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long staged = 0, streamed = 0;
  cudaError_t err = plan_for(args->loss_kind, args->n, args->num_samples,
                             args->num_lanes, &staged, &streamed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool use_staged = staged <= kSmemMax && !args->force_streamed;
  if (!use_staged && streamed > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  if (args->n > kTileFeatures) {
    switch (args->loss_kind) {
      case kSquared: err = pd_launch_wide_squared(*args, s, use_staged); break;
      case kLasso: err = pd_launch_wide_lasso(*args, s, use_staged); break;
      default: err = pd_launch_wide_logistic(*args, s, use_staged);
    }
    return static_cast<int>(err);
  }
  switch (args->loss_kind) {
    case kSquared: err = pd_launch_squared(*args, s); break;
    case kLasso: err = pd_launch_lasso(*args, s); break;
    default:
      err = use_staged ? pd_launch_logistic(*args, s)
                       : pd_launch_logistic_streamed(*args, s);
  }
  return static_cast<int>(err);
}

// The shared memory a launch of loss `loss_kind` at n features,
// num_samples samples a node and num_lanes lanes plans when it stages the
// prox parameters (*need: make_plan's or make_wide_plan's total for the
// instantiation the launch picks), and the most a block may take
// (*limit).  Past the limit the launch streams them instead; the wrapper
// and the solver's fused gate ask this first.  Returns a CUDA error code.
extern "C" int fused_pd_step_staging(int loss_kind, int n, int num_samples,
                                     int num_lanes, long long* need,
                                     long long* limit) {
  using namespace repro_pd;
  long long streamed = 0;
  const cudaError_t err =
      plan_for(loss_kind, n, num_samples, num_lanes, need, &streamed);
  *limit = kSmemMax;
  return static_cast<int>(err);
}

// The same for the streamed variant (parameters read from device memory):
// its plan's shared bytes (*need; LLONG_MAX where the loss has none: the
// register-tile squared and lasso kernels always stage) and the limit.
// Past the limit neither variant takes the launch.
extern "C" int fused_pd_step_streaming(int loss_kind, int n,
                                       int num_samples, int num_lanes,
                                       long long* need, long long* limit) {
  using namespace repro_pd;
  long long staged = 0;
  const cudaError_t err =
      plan_for(loss_kind, n, num_samples, num_lanes, &staged, need);
  *limit = kSmemMax;
  return static_cast<int>(err);
}

// The samples of a node that the register-tile logistic streamed variant
// stages in shared memory (*samples; the rest it reads from device memory
// in each Newton step), at n <= 16 features, num_samples samples a node,
// num_lanes lanes and storage type `storage` (Storage): its plan's own
// count.  Returns a CUDA error code.
extern "C" int fused_pd_step_streamed_samples(int n, int num_samples,
                                              int num_lanes, int storage,
                                              long long* samples) {
  using namespace repro_pd;
  if (n < 1 || n > kTileFeatures || num_samples < 0 || num_lanes < 1 ||
      (storage != kF32 && storage != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  PdArgs a{};
  a.n = n;
  a.num_samples = num_samples;
  a.num_lanes = num_lanes;
  a.storage = storage;
  StreamPlan sp;
  if (num_lanes > 1)
    make_streamed_plan<kTileFeatures, true>(a, sp);
  else
    make_streamed_plan<kTileFeatures, false>(a, sp);
  *samples = sp.slab_samples;
  return static_cast<int>(cudaSuccess);
}
