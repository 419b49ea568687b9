// CUDA-graph conditional nodes: the JAX package's lax.while_loop and
// lax.cond on the device, inside one captured forward.
//
// Replaces no Pallas kernel.  The JAX package runs its ECC Gauss-Newton
// loop (ops/registration.py:330) and its WLS unwrap's PCG
// (ops/unwrap.py:136) as lax.while_loop and picks the dominant component's
// seed with a lax.cond (ops/components.py:133), all inside its one compiled
// forward.  PyTorch records a CUDA graph by stream capture and wraps no
// conditional node, so the port adds them here, during a capture on the
// caller's stream (the host functions below), and sets their condition on
// the card (the one kernel):
//   vt_cond_handle   creates a conditional handle on the graph the stream
//                    is capturing into (cudaGraphConditionalHandleCreate);
//   vt_set_conditional  the condition setter: one thread reads a 1-byte
//                    predicate in device memory and calls
//                    cudaGraphSetConditional; launched (captured) right
//                    before the node, and at the end of a WHILE body;
//   vt_cond_begin    adds an IF or WHILE node after the stream's current
//                    capture dependencies, makes it the stream's only
//                    dependency and begins capturing the body stream into
//                    the node's body graph (cudaStreamBeginCaptureToGraph);
//   vt_cond_end      ends that body capture.
// A WHILE node runs its body while the handle is non-zero, testing it
// before each trip; an IF node runs its body once if it is non-zero.  The
// trip count is the data's: nothing reads the device on the host.
//
// Each run of the setter adds one to its call site's slot of a small device
// array (the sites: kernels/graph_cond_kernel.py SITES), so that a replay's
// executions are counted exactly and by site: a setter inside a WHILE body
// runs once a trip, which no count of captured launches gives.  The setter
// before a WHILE node counts in the "entry" slot, so a WHILE site's slot
// holds its trips; an IF site's slot holds its nodes' runs.
//
// Bound.  The setter reads one byte and writes the handle's value: its time
// is one launch's latency inside the graph.
//
// CUDA 12.3 added conditional nodes; CUDA 13 gave cudaStreamGetCaptureInfo,
// cudaGraphAddNode and cudaStreamUpdateCaptureDependencies an edge-data
// argument, which both branches below leave null (default edges).
#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 5;   // = len(graph_cond_kernel.SITES)
__device__ unsigned long long g_cond_sets[kSlots];

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle,
                                       const unsigned char* pred, int slot) {
  cudaGraphSetConditional(handle, pred[0] ? 1u : 0u);
  atomicAdd(&g_cond_sets[slot], 1ull);
}

cudaError_t capture_info(cudaStream_t st, cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* n) {
  cudaStreamCaptureStatus status;
  unsigned long long id;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(st, &status, &id, graph, deps, nullptr, n);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(st, &status, &id, graph, deps, n);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess
                                                 : cudaErrorStreamCaptureImplicit;
}

}  // namespace

extern "C" int vt_cond_handle(unsigned long long* handle, void* stream) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t err = capture_info((cudaStream_t)stream, &graph, &deps, &n);
  if (err != cudaSuccess) return (int)err;
  cudaGraphConditionalHandle h;
  err = cudaGraphConditionalHandleCreate(&h, graph, 0, 0);
  *handle = (unsigned long long)h;
  return (int)err;
}

extern "C" int vt_set_conditional(unsigned long long handle, const void* pred, int slot,
                                  void* stream) {
  if (slot < 0 || slot >= kSlots) return (int)cudaErrorInvalidValue;
  set_conditional_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (cudaGraphConditionalHandle)handle, (const unsigned char*)pred, slot);
  return (int)cudaGetLastError();
}

// kind: 0 an IF node, 1 a WHILE node.
extern "C" int vt_cond_begin(unsigned long long handle, int kind, void* body_stream,
                             void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t err = capture_info(st, &graph, &deps, &n);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = (cudaGraphConditionalHandle)handle;
  params.conditional.type = kind ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(st, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, n, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(st, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph((cudaStream_t)body_stream,
                                            params.conditional.phGraph_out[0], nullptr,
                                            nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

extern "C" int vt_cond_end(void* body_stream) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture((cudaStream_t)body_stream, &body);
}

extern "C" int vt_cond_slot_count() { return kSlots; }

// The slots into host memory: synchronously, or enqueued on a stream (into
// pinned memory, so that the copy does not wait for the host).
extern "C" int vt_cond_slots(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_cond_sets, sizeof(g_cond_sets));
}

extern "C" int vt_cond_slots_async(void* out, void* stream) {
  return (int)cudaMemcpyFromSymbolAsync(out, g_cond_sets, sizeof(g_cond_sets), 0,
                                        cudaMemcpyDeviceToHost, (cudaStream_t)stream);
}

extern "C" int vt_cond_slots_reset() {
  const unsigned long long zero[kSlots] = {};
  return (int)cudaMemcpyToSymbol(g_cond_sets, zero, sizeof(g_cond_sets));
}
