// graph_loop: the solve as one CUDA graph, its loops decided on the card.
//
// The JAX package runs a solve as one compiled program: the interior-point
// loop is one lax.while_loop over "not every lane done"
// (eicos_tpu/solver.py:635) and each refined KKT solve an inner
// lax.while_loop over "not every column done" (eicos_tpu/kkt.py:1205,
// :1246).  The port captures the same solve as the segments of a
// graphs.Program, one CUDA graph each.  This file composes those graphs
// into one program graph: each segment's graph a child graph node, each
// loop a conditional WHILE node whose body holds its segments and, last,
// the node of loop_cond that decides the next trip, so that a solve is one
// cudaGraphLaunch and the host reads nothing back.
//
// S2, loop_cond: the condition of every loop.  One block ANDs a bool
// vector of at most a few hundred entries (a lane's done flag, (L,) or
// (L, k)), sets the WHILE node's handle to "not every entry true" and adds
// one to its node's int64 trip counter, from which the host settles the
// launch counts later without a read per trip.  No Pallas kernel does this
// (the JAX package's loop condition is compiled by XLA into its while
// op); the host loop it replaces reads ~t.all() back once a trip
// (eicos_tpu_torch/kkt.py all_true).
//
// Bound: neither bytes nor operations.  It reads n <= a few hundred
// bytes and writes 8: a launch's latency, a few microseconds, is all of
// its time.  Design: one block of 256 threads, each ANDs a strided slice,
// __syncthreads_and combines them (an AND is exact in any order), thread 0
// sets the handle and counts.
//
// Device stamps.  A traced program graph also times its segments on the
// card's own clock (%globaltimer, ns), in int64 cells of the program's
// trip-counter tensor: a stamp block [last, launches, overwritten, stamps,
// ring of (start, end) a launch] and one accumulator a segment.  A one-thread
// kernel, loop_stamp, is the first and the last node of the root graph: the
// first writes the launch's start into the ring and sets `last`; the last
// adds now - last to the finish's accumulator and writes the end.  Between
// them every S2 node closes the segment placed just before it: thread 0
// adds now - last to that segment's accumulator and sets last = now.  The
// intervals telescope, so the segments' sums equal the launches' spans.
// Event-record nodes would do the same at segment boundaries, but a
// conditional body may not hold one (check_graph), and every segment
// but the finish is followed by an S2 node already.  A ring entry whose
// start is not zero has not been read yet (the host zeroes the ring when
// it reads it): overwriting it counts in `overwritten`.  Each stamp node
// counts its own launches in `stamps`, as S2 counts its trips.
//
// The host functions build the program graph node by node (each node
// depends on the one before it in its graph: the segments share one
// memory pool's temporaries, so nothing runs in parallel), instantiate it,
// launch it on the caller's stream and destroy it.  Each returns a null
// pointer or a message naming the call that failed.  Graph, exec and
// stream handles belong to the CUDA context that PyTorch's runtime uses.

#include <cuda_runtime.h>

#include <cstdio>

namespace {

constexpr int kThreads = 256;
thread_local char g_msg[512];

const char* failed(const char* what, cudaError_t e) {
  snprintf(g_msg, sizeof g_msg, "%s: %s (%s)", what, cudaGetErrorName(e),
           cudaGetErrorString(e));
  return g_msg;
}

const char* node_type_name(cudaGraphNodeType t) {
  switch (t) {
    case cudaGraphNodeTypeKernel: return "kernel";
    case cudaGraphNodeTypeMemcpy: return "memcpy";
    case cudaGraphNodeTypeMemset: return "memset";
    case cudaGraphNodeTypeHost: return "host";
    case cudaGraphNodeTypeGraph: return "child graph";
    case cudaGraphNodeTypeEmpty: return "empty";
    case cudaGraphNodeTypeWaitEvent: return "event wait";
    case cudaGraphNodeTypeEventRecord: return "event record";
    case cudaGraphNodeTypeExtSemaphoreSignal: return "semaphore signal";
    case cudaGraphNodeTypeExtSemaphoreWait: return "semaphore wait";
    case cudaGraphNodeTypeMemAlloc: return "memory alloc";
    case cudaGraphNodeTypeMemFree: return "memory free";
    case cudaGraphNodeTypeConditional: return "conditional";
    default: return "unknown";
  }
}

// device memory (or managed): what a memcpy node inside a conditional
// body may touch
bool on_device(const void* p) {
  cudaPointerAttributes a;
  if (cudaPointerGetAttributes(&a, p) != cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  return a.type == cudaMemoryTypeDevice || a.type == cudaMemoryTypeManaged;
}

const char* check_graph(cudaGraph_t g, int depth) {
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &n);
  if (e != cudaSuccess) return failed("cudaGraphGetNodes", e);
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n ? n : 1];
  e = cudaGraphGetNodes(g, nodes, &n);
  const char* msg = e == cudaSuccess ? nullptr
                                     : failed("cudaGraphGetNodes", e);
  for (size_t i = 0; msg == nullptr && i < n; ++i) {
    cudaGraphNodeType t;
    e = cudaGraphNodeGetType(nodes[i], &t);
    if (e != cudaSuccess) {
      msg = failed("cudaGraphNodeGetType", e);
    } else if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      e = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      msg = e != cudaSuccess
                ? failed("cudaGraphChildGraphNodeGetGraph", e)
                : check_graph(child, depth + 1);
    } else if (t == cudaGraphNodeTypeMemcpy) {
      cudaMemcpy3DParms p = {};
      e = cudaGraphMemcpyNodeGetParams(nodes[i], &p);
      if (e != cudaSuccess) {
        msg = failed("cudaGraphMemcpyNodeGetParams", e);
      } else if (p.srcArray || p.dstArray || !on_device(p.srcPtr.ptr) ||
                 !on_device(p.dstPtr.ptr)) {
        snprintf(g_msg, sizeof g_msg,
                 "node %zu (depth %d) is a memcpy node that reads or "
                 "writes host memory or an array, which a conditional "
                 "body may not hold", i, depth);
        msg = g_msg;
      }
    } else if (t != cudaGraphNodeTypeKernel && t != cudaGraphNodeTypeMemset &&
               t != cudaGraphNodeTypeEmpty &&
               t != cudaGraphNodeTypeConditional) {
      snprintf(g_msg, sizeof g_msg,
               "node %zu (depth %d) is a %s node (type %d), which a "
               "conditional body may not hold", i, depth,
               node_type_name(t), (int)t);
      msg = g_msg;
    }
  }
  delete[] nodes;
  return msg;
}

int deps(void* dep, cudaGraphNode_t* d) {
  *d = (cudaGraphNode_t)dep;
  return dep ? 1 : 0;
}

}  // namespace

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

// S2.  flags: n bools; trips: this node's counter; last, acc: the stamp
// block's `last` cell and the accumulator of the segment before the node
// (both null: no stamp).
__global__ void __launch_bounds__(kThreads)
    loop_cond(cudaGraphConditionalHandle handle, const bool* flags, int n,
              long long* trips, long long* last, long long* acc) {
  int all = 1;
  for (int i = threadIdx.x; i < n; i += kThreads) all &= flags[i] ? 1 : 0;
  all = __syncthreads_and(all);
  if (threadIdx.x == 0) {
    cudaGraphSetConditional(handle, all ? 0u : 1u);
    *trips += 1;
    if (acc != nullptr) {
      long long now = global_ns();
      *acc += now - *last;
      *last = now;
    }
  }
}

enum { kLast = 0, kLaunches = 1, kOverwritten = 2, kStamps = 3, kRing = 4 };
enum { kStart = 0, kEnd = 1, kNow = 2 };

// The stamp kernel, one thread.  kStart: a launch's start into the ring;
// kEnd: the finish's time into `acc`, the launch's end into the ring, one
// launch more; both count one stamp.  kNow: the clock into block[0] alone
// (the host's calibration, launched outside any graph, counted nowhere).
__global__ void loop_stamp(long long* block, int ring, long long* acc,
                           int phase) {
  long long now = global_ns();
  if (phase != kNow) {
    long long i = block[kLaunches];
    long long* e = block + kRing + 2 * (i % ring);
    if (phase == kStart) {
      if (e[0] != 0) block[kOverwritten] += 1;
      e[0] = now;
      e[1] = 0;
    } else {
      *acc += now - block[kLast];
      e[1] = now;
      block[kLaunches] = i + 1;
    }
    block[kStamps] += 1;
  }
  block[kLast] = now;
}

extern "C" {

const char* eicos_loop_create(int device, void** graph) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return failed("cudaSetDevice", e);
  cudaGraph_t g;
  e = cudaGraphCreate(&g, 0);
  if (e != cudaSuccess) return failed("cudaGraphCreate", e);
  *graph = g;
  return nullptr;
}

// A handle for a conditional node of `graph` (the graph that will hold
// the node), reset to 0 at every launch.
const char* eicos_loop_handle(void* graph, unsigned long long* handle) {
  cudaGraphConditionalHandle h;
  cudaError_t e = cudaGraphConditionalHandleCreate(
      &h, (cudaGraph_t)graph, 0, cudaGraphCondAssignDefault);
  if (e != cudaSuccess) return failed("cudaGraphConditionalHandleCreate", e);
  *handle = h;
  return nullptr;
}

// A WHILE node on `handle` after `dep` (null: no dependency); `body` gets
// its body graph, which the node owns.
const char* eicos_loop_while(void* graph, void* dep,
                             unsigned long long handle, void** body,
                             void** node) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = handle;
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
  cudaGraphNode_t d, out;
  cudaError_t e = cudaGraphAddNode(&out, (cudaGraph_t)graph, &d,
                                   deps(dep, &d), &p);
  if (e != cudaSuccess) return failed("cudaGraphAddNode (while)", e);
  *body = p.conditional.phGraph_out[0];
  *node = out;
  return nullptr;
}

// `child` (a segment's captured graph) cloned into a child graph node.
const char* eicos_loop_child(void* graph, void* dep, void* child,
                             void** node) {
  cudaGraphNode_t d, out;
  cudaError_t e = cudaGraphAddChildGraphNode(
      &out, (cudaGraph_t)graph, &d, deps(dep, &d), (cudaGraph_t)child);
  if (e != cudaSuccess) return failed("cudaGraphAddChildGraphNode", e);
  *node = out;
  return nullptr;
}

// A kernel node of loop_cond: set `handle` to "not all of flags[0:n]";
// with `acc`, stamp into it from `last`.
const char* eicos_loop_cond(void* graph, void* dep, unsigned long long handle,
                            const void* flags, int n, void* trips,
                            void* last, void* acc, void** node) {
  cudaGraphConditionalHandle h = handle;
  const bool* f = (const bool*)flags;
  long long* t = (long long*)trips;
  long long* l = (long long*)last;
  long long* a = (long long*)acc;
  void* args[] = {&h, &f, &n, &t, &l, &a};
  cudaKernelNodeParams k = {};
  k.func = (void*)loop_cond;
  k.gridDim = dim3(1);
  k.blockDim = dim3(kThreads);
  k.kernelParams = args;
  cudaGraphNode_t d, out;
  cudaError_t e = cudaGraphAddKernelNode(&out, (cudaGraph_t)graph, &d,
                                         deps(dep, &d), &k);
  if (e != cudaSuccess) return failed("cudaGraphAddKernelNode (loop_cond)", e);
  *node = out;
  return nullptr;
}

// A kernel node of loop_stamp: `phase` kStart or kEnd on the stamp block
// `block` with a ring of `ring` launches (`acc`: the finish's accumulator,
// for kEnd).
const char* eicos_loop_stamp(void* graph, void* dep, void* block, int ring,
                             void* acc, int phase, void** node) {
  long long* b = (long long*)block;
  long long* a = (long long*)acc;
  void* args[] = {&b, &ring, &a, &phase};
  cudaKernelNodeParams k = {};
  k.func = (void*)loop_stamp;
  k.gridDim = dim3(1);
  k.blockDim = dim3(1);
  k.kernelParams = args;
  cudaGraphNode_t d, out;
  cudaError_t e = cudaGraphAddKernelNode(&out, (cudaGraph_t)graph, &d,
                                         deps(dep, &d), &k);
  if (e != cudaSuccess)
    return failed("cudaGraphAddKernelNode (loop_stamp)", e);
  *node = out;
  return nullptr;
}

// One loop_stamp launch on `stream`, outside any graph: the card's clock
// into the int64 at `cell`.
const char* eicos_loop_stamp_now(int device, void* cell, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return failed("cudaSetDevice", e);
  loop_stamp<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)cell, 1, nullptr,
                                                kNow);
  e = cudaGetLastError();
  if (e != cudaSuccess) return failed("loop_stamp launch", e);
  return nullptr;
}

// Null if every node of `graph` (through its child graphs) may sit in a
// conditional body: kernel, memset, empty, conditional, child graph, and
// memcpy between device memory.
const char* eicos_loop_check(void* graph) {
  return check_graph((cudaGraph_t)graph, 0);
}

// Instantiate `graph` and upload it on `stream`.
const char* eicos_loop_instantiate(int device, void* graph, void* stream,
                                   void** exec) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return failed("cudaSetDevice", e);
  cudaGraphInstantiateParams p = {};
  p.flags = cudaGraphInstantiateFlagUpload;
  p.uploadStream = (cudaStream_t)stream;
  cudaGraphExec_t x;
  e = cudaGraphInstantiateWithParams(&x, (cudaGraph_t)graph, &p);
  if (e != cudaSuccess) {
    cudaGraphNodeType t = (cudaGraphNodeType)-1;
    if (p.errNode_out) cudaGraphNodeGetType(p.errNode_out, &t);
    snprintf(g_msg, sizeof g_msg,
             "cudaGraphInstantiateWithParams: %s (%s); result %d, at a %s "
             "node", cudaGetErrorName(e), cudaGetErrorString(e),
             (int)p.result_out,
             p.errNode_out ? node_type_name(t) : "(no node named)");
    return g_msg;
  }
  *exec = x;
  return nullptr;
}

const char* eicos_loop_launch(int device, void* exec, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return failed("cudaSetDevice", e);
  e = cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
  if (e != cudaSuccess) return failed("cudaGraphLaunch", e);
  return nullptr;
}

// Destroy `exec` and `graph` (either may be null).
const char* eicos_loop_destroy(void* graph, void* exec) {
  cudaError_t e = cudaSuccess;
  if (exec) e = cudaGraphExecDestroy((cudaGraphExec_t)exec);
  if (e != cudaSuccess) return failed("cudaGraphExecDestroy", e);
  if (graph) e = cudaGraphDestroy((cudaGraph_t)graph);
  if (e != cudaSuccess) return failed("cudaGraphDestroy", e);
  return nullptr;
}

}  // extern "C"
