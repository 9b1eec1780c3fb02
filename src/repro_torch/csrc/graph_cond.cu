// A captured CUDA graph under an IF node on a device flag, for the tol
// engines (src/repro_torch/engine/loop.py:device_loop).
//
// The reference stops a tol solve inside a lax.while_loop: the blocks
// after the stop are never computed.  The port captures one metric block
// into a CUDA graph (PyTorch's stream capture, so the block's memory lives
// in the capture's private pool) and wraps it here in a graph of two
// nodes: a one-thread kernel that copies the device flag `active` into a
// conditional handle, then an IF node whose body is a child-graph copy of
// the captured block.  Each launch of the wrapping graph runs the block
// when the flag is set and nothing else when it is clear: after the stop a
// launch costs the flag test on the device and a graph launch on the host.
// The handle is created with cudaGraphCondAssignDefault (0), so every
// launch starts from "skip" and the flag kernel decides.  Conditional
// nodes need CUDA 12.4; the card's driver and toolkit are 12.8.  A
// conditional body may hold kernel nodes (cooperative ones too, without
// MPS), memcpy and memset nodes on device memory, and child graphs: what a
// captured metric block holds.
//
// This is the device side of the engine's control flow, not the port of a
// TPU kernel; its plain version is the host loop
// (engine/loop.py:device_loop_plain), against which chip_smoke.py holds
// the graph engine bit for bit.
//
// Build: src/repro_torch/kernels/_build.py, with the port's kernels into
// one shared library; plain C entry points, loaded with ctypes.

#include <cuda_runtime.h>

namespace {

__global__ void set_if_from_flag(cudaGraphConditionalHandle handle,
                                 const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

}  // namespace

// Build and instantiate "flag -> IF { body }" around the captured graph
// `body` (copied: the caller may destroy it afterwards, but must keep the
// memory it addresses).  Returns the executable and its graph, to launch
// with repro_if_graph_launch and free with repro_if_graph_destroy.
extern "C" int repro_if_graph_create(void* body, const bool* flag,
                                     void** exec_out, void** graph_out) {
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaGraphCreate(&graph, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault);
  cudaGraphNode_t set_node = nullptr, cond_node = nullptr, child = nullptr;
  if (err == cudaSuccess) {
    void* args[] = {&handle, &flag};
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(set_if_from_flag);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.sharedMemBytes = 0;
    kp.kernelParams = args;
    kp.extra = nullptr;
    err = cudaGraphAddKernelNode(&set_node, graph, nullptr, 0, &kp);
  }
  cudaGraphNodeParams cp = {};
  if (err == cudaSuccess) {
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeIf;
    cp.conditional.size = 1;
    err = cudaGraphAddNode(&cond_node, graph, &set_node, 1, &cp);
  }
  if (err == cudaSuccess)
    err = cudaGraphAddChildGraphNode(&child, cp.conditional.phGraph_out[0],
                                     nullptr, 0,
                                     static_cast<cudaGraph_t>(body));
  cudaGraphExec_t exec = nullptr;
  if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, graph, 0);
  if (err != cudaSuccess) {
    cudaGraphDestroy(graph);
    return static_cast<int>(err);
  }
  *exec_out = exec;
  *graph_out = graph;
  return static_cast<int>(cudaSuccess);
}

extern "C" int repro_if_graph_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                          static_cast<cudaStream_t>(stream)));
}

// Safe while launches are in flight: an executable graph in flight is
// freed once it completes.
extern "C" int repro_if_graph_destroy(void* exec, void* graph) {
  cudaError_t a = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  cudaError_t b = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
  return static_cast<int>(a != cudaSuccess ? a : b);
}
