// Stage markers of the stream steps, and the node count of a graph under
// capture (utils/spans.py).
//
// No Pallas kernel precedes them. One empty kernel per stage name,
// launched with one thread on a stream where a stage begins, while spans
// are switched on in an eager step: on the device trace's clock a stage
// runs from its marker to the next one on the stream.
//
// A graph holds no marker. Where a stage begins during a capture,
// rxspan_graph_nodes counts the kernel, copy and fill nodes the graph
// being captured on the stream holds so far: a graph captured from one
// stream is a chain, so each replay runs its nodes, and the device trace
// shows their events, in that order, and the counts place every event of
// a replay in its stage.
//
// The order of RXSPAN_STAGES is utils/spans.py's MARKED: the index
// rxspan_launch takes is the name's place in that tuple.

#include <cuda_runtime.h>

#include <vector>

#define RXSPAN_STAGES(X) \
  X(inputs) X(frontend) X(windows) X(plsync) X(fec) X(snr) X(tracking) \
  X(outputs) X(walk)

#define RXSPAN_KERNEL(name) __global__ void rxspan_##name##_kernel() {}
RXSPAN_STAGES(RXSPAN_KERNEL)
#undef RXSPAN_KERNEL

extern "C" int rxspan_launch(int stage, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int i = 0;
#define RXSPAN_CASE(name)                        \
  if (stage == i++) {                            \
    rxspan_##name##_kernel<<<1, 1, 0, s>>>();    \
    return (int)cudaGetLastError();              \
  }
  RXSPAN_STAGES(RXSPAN_CASE)
#undef RXSPAN_CASE
  return (int)cudaErrorInvalidValue;
}

// counts[0..2] = the kernel, copy and fill nodes of the graph that the
// stream is capturing into; cudaErrorIllegalState if it captures nothing
extern "C" int rxspan_graph_nodes(void* stream, long long* counts) {
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo((cudaStream_t)stream, &status,
                                             &id, &graph);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive || graph == nullptr)
    return (int)cudaErrorIllegalState;
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess) return (int)err;
  std::vector<cudaGraphNode_t> nodes(n);
  if (n) {
    err = cudaGraphGetNodes(graph, nodes.data(), &n);
    if (err != cudaSuccess) return (int)err;
  }
  counts[0] = counts[1] = counts[2] = 0;
  for (size_t k = 0; k < n; ++k) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[k], &type);
    if (err != cudaSuccess) return (int)err;
    if (type == cudaGraphNodeTypeKernel) ++counts[0];
    else if (type == cudaGraphNodeTypeMemcpy) ++counts[1];
    else if (type == cudaGraphNodeTypeMemset) ++counts[2];
  }
  return 0;
}
