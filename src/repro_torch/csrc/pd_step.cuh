// Fused primal-dual step for Hopper: the launch arguments shared by the
// entry point (pd_step.cu) and the per-variant translation units
// (pd_step.cu: squared, pd_step_lasso.cu, pd_step_logistic.cu,
// pd_step_logistic_streamed.cu, pd_step_wide.cu, pd_step_wide_lasso.cu,
// pd_step_wide_logistic.cu, pd_step_wide_logistic_bf16.cu), which
// kernels/_build.py compiles in parallel.  See pd_step_impl.cuh
// (n <= 16) and pd_step_wide.cuh (n > 16) for what the kernel computes
// and how.
#pragma once

#include <cuda_runtime.h>

namespace repro_pd {

enum LossKind { kSquared = 0, kLasso = 1, kLogistic = 2 };
enum Storage { kF32 = 0, kBF16 = 1 };

// Mirrored field for field by kernels/pd_step.py:_PdArgs (ctypes).
// "T" below is the storage type (float or __nv_bfloat16).
struct PdArgs {
  const void* w_in;        // T (>= num_nodes, n) node store
  const void* u_in;        // T (u_rows, n) edge store (storage ids)
  // the compact incidence (core/graph.py:compact_incidence), storage ids
  const int* in_ptr;       // (num_nodes + 1,) offsets into in_ids
  const int* in_ids;       // (num_in,) in-edges (sign -1), row by row
  const int* out_run;      // (num_nodes, 2) first id, count of out-edges
  const void* prm[6];      // T: the loss's prox parameters, sorted keys
  const float* tau;        // (>= num_nodes,) primal steps
  const int* src;          // (num_edges,) layout node ids
  const int* dst;
  const float* sigma;      // (num_edges,) dual steps
  const float* la;         // (num_edges,) lam * A_e
  void* w_out;             // T (num_nodes, n)
  void* u_out;             // T (num_edges, n)
  float* w_carry;          // f32 (num_nodes, n) carry of iters > 1
  float* u_carry;          // f32 (num_edges, n)
  float* z;                // f32 (num_nodes, n) scratch: 2 w+ - w
  float* res;              // (num_lanes,) residuals, zeroed by the caller
  const unsigned char* active;  // null, or the stop word: 0 = write nothing
  long long num_nodes;     // nb * BV
  long long num_edges;     // nb * EB
  long long u_offset;      // klo * EB: storage row of owned edge 0
  long long u_rows;        // rows of the edge store
  long long num_in;        // in-edge slots (in_ids' length)
  int n;
  int reg_kind;            // 0: tv (clip), 1: tv2 (scaling)
  int relax;               // rho != 1
  float rho;
  int iters;
  int compute_residual;
  int loss_kind;           // LossKind
  int storage;             // Storage
  int num_samples;         // logistic: samples per node (x.shape[1])
  int num_inner;           // lasso / logistic inner iterations
  float alpha;             // lasso l1 weight
  // the lane axis: num_lanes problems on one layout with the same prox
  // parameters, tau and sigma (a lambda path), each with its own state,
  // la, outputs, carry, z and residual slot.  Lane l of an array starts
  // l times its lane stride (in elements) past its pointer; z's stride is
  // num_nodes * n and res holds num_lanes floats.
  long long num_lanes;
  long long w_in_lane;
  long long u_in_lane;
  long long w_out_lane;
  long long u_out_lane;
  long long wc_lane;       // w_carry
  long long uc_lane;       // u_carry
  long long la_lane;
  // null, or the kernel's execution count: block 0 adds one each time the
  // kernel runs its iterations, launched or replayed from a CUDA graph (a
  // launch that finds the stop word clear writes and counts nothing)
  unsigned long long* executions;
  // nonzero: run the streamed variant even where the staging plan fits
  // (for checking the two against each other: the wide kernel's give the
  // same bits, the register tile's agree to float32 rounding)
  int force_streamed;
  // the register-tile streamed variant's scratch (pd_step_streamed.cuh),
  // 1 + iters + num_nodes ints zeroed by the caller; null elsewhere
  int* work;
  // the row strides (in elements) of the lane-stacked arrays and z's lane
  // stride, read by the register tile's lane kernel (pd_step_lanes.cuh)
  // alone: lane-major rows are n apart (la's 1) with the lane strides
  // above, lane-minor rows num_lanes * n apart (la's num_lanes) with lane
  // stride n (la's 1).  Every other kernel reads lane-major state with
  // rows n apart and z's lane stride num_nodes * n.
  long long w_in_row;
  long long u_in_row;
  long long w_out_row;
  long long u_out_row;
  long long wc_row;
  long long uc_row;
  long long la_row;
  long long z_row;
  long long z_lane;
};

// The variants, each loss's in its own translation unit so that
// kernels/_build.py compiles them in parallel: the register-tile kernel
// (n <= 16) with staged prox parameters per loss (one lane:
// pd_step_impl.cuh; more: pd_step_lanes.cuh), the logistic loss's
// streamed one (pd_step_streamed.cuh: a labeled node's samples split over
// a block, staged once a launch step), and the wide kernel
// (n > 16) staged or streamed (the logistic loss's in one unit per
// storage type).
cudaError_t pd_launch_squared(const PdArgs& a, cudaStream_t s);
cudaError_t pd_launch_lasso(const PdArgs& a, cudaStream_t s);
cudaError_t pd_launch_logistic(const PdArgs& a, cudaStream_t s);
cudaError_t pd_launch_logistic_streamed(const PdArgs& a, cudaStream_t s);
cudaError_t pd_launch_wide_squared(const PdArgs& a, cudaStream_t s,
                                   bool staged);
cudaError_t pd_launch_wide_lasso(const PdArgs& a, cudaStream_t s,
                                 bool staged);
cudaError_t pd_launch_wide_logistic(const PdArgs& a, cudaStream_t s,
                                    bool staged);
cudaError_t pd_launch_wide_logistic_bf16(const PdArgs& a, cudaStream_t s,
                                         bool staged);

}  // namespace repro_pd
