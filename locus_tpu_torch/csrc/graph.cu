// Conditional (IF) nodes inside a CUDA graph that a stream is capturing:
// the device side of `ops/graph.py::gate` under capture, the counterpart
// of `lax.cond` and of one trip of `lax.while_loop` inside a jitted JAX
// program (locus_tpu/registration/gicp.py, the outer loop and the final
// re-lookup). PyTorch 2.11 has no binding for them, so this file records
// them through the CUDA runtime (12.4 or later) the way the CUDA
// programming guide's stream-capture example does:
//
//   locus_if_begin  on the capturing stream: a one-thread kernel copies
//                   the 0-d bool predicate into a conditional handle,
//                   an IF node on that handle joins the captured graph
//                   after it, and `body` (another stream) starts to
//                   capture into the node's body graph;
//   locus_if_end    ends the body's capture.
//
// The work between the two calls, enqueued on `body`, runs on every
// replay where the predicate holds and is skipped where it does not: no
// host read, no launch of the body's kernels. The set kernel is the only
// extra launch a gate costs (1 thread; bound by the launch, not by
// bytes or operations).
//
//   locus_stamp     a one-thread kernel that reads the device's nanosecond
//                   clock (%globaltimer) and writes it to slot `slot` of
//                   row (*index mod rows) of `ring`, an int64 (rows,
//                   width) array; with `bump` it then moves *index on to
//                   the next row. Captured into a step's graph it stamps
//                   the replay's head, its tail (the bump) and each stage's
//                   entry and exit (`ops/graph.py::stage`); launched
//                   eagerly it reads the clock once (the host-to-device
//                   clock offset).
#include <cuda_runtime.h>

namespace {

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

__global__ void stamp_kernel(long long* ring, long long* index, long long rows, int width, int slot, int bump) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long row = *index % rows;
  ring[row * width + slot] = static_cast<long long>(now);
  if (bump) *index = *index + 1;
}

}  // namespace

// Returns a cudaError_t; -1 when `capturing` is not capturing.
extern "C" int locus_if_begin(void* capturing, const void* pred, void* body) {
  cudaStream_t s = static_cast<cudaStream_t>(capturing);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t num_deps = 0;
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &num_deps);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (status != cudaStreamCaptureStatusActive) return -1;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  set_conditional_kernel<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // the set kernel is now the stream's dependency: the node goes after it
  e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &num_deps);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, num_deps, &params);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body), params.conditional.phGraph_out[0], nullptr, nullptr, 0,
      cudaStreamCaptureModeRelaxed));
}

extern "C" int locus_if_end(void* body) {
  cudaGraph_t graph;
  return static_cast<int>(cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph));
}

extern "C" int locus_stamp(void* stream, void* ring, void* index, long long rows, int width, int slot, int bump) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<long long*>(index), rows, width, slot, bump);
  return static_cast<int>(cudaGetLastError());
}
