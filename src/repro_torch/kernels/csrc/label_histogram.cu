// Start-node label histogram: the number of core nodes whose label matches
// (or the query label is WILDCARD) and whose value passes the value op --
// the one-pass metric that seeds a partition's SNI entry (paper Sec. 5.1).
//
// Replaces the TPU kernel src/repro/kernels/label_histogram.py::_kernel
// (launched by label_histogram_pallas).  Its plain PyTorch twin is
// kernels/label_histogram.py::label_histogram_plain.  NaN values fail every
// op but OP_NONE, as in the TPU kernel.
//
// The TPU kernel walks node blocks of 1024 in a sequential grid and writes
// one partial count per block, which its wrapper sums in a second op.
// Hopper's blocks run in parallel and in no order; here the second level of
// the sum is done by the last block to finish, inside the same launch.
//
// What bounds it on Hopper: bytes.  It reads 12 bytes a node (label, value,
// core flag) once and writes one int32: 3,532,804 B for one partition of the
// main path (294,400 nodes), 1.05 us at 3.35 TB/s.  A launch and the
// reduction's tail add a fixed cost of a few microseconds, which is what
// the design works on:
//  1. One graph node per call.  The count is written, not accumulated, so
//     the launcher zeroes nothing (no cudaMemsetAsync node before the
//     kernel).  Each block adds its count and draws a ticket in one 64-bit
//     atomicAdd on a scratch word (ticket in the high half, running count
//     in the low half).  Atomics on one address are totally ordered, so
//     the block that draws the last ticket gets back every other block's
//     count with it: it writes the total and sets the word back to 0 for
//     the next call.  No fence, no partials array and no second pass, so
//     the tail after the loads is one atomic round trip and one store.
//     The word is scratch owned by the wrapper, one per device and stream
//     (a call on another stream must not draw from the same ticket),
//     zeroed once when it is made.  (The textbook "last block" reduction
//     -- partials, __threadfence, ticket, a pass over the partials -- puts
//     three dependent round trips where this puts one.)
//  2. Every load in flight in one wave.  Blocks of 256 threads, four nodes
//     a thread through 16-byte loads (int4 label and core, float4 value):
//     1024 nodes a block, 288 blocks at 294,400 nodes, and up to 8 blocks
//     fit on an SM, so the whole 3.5 MB is requested at once.  The grid is
//     capped at MAX_BLOCKS and loops above that.
//  3. Counting: a warp ballot and popcount per node slot, one shared slot
//     per warp, and a shuffle sum over the block's 8 warps.
// The vector loads need all three pointers 16-byte aligned; the wrapper
// checks them and otherwise picks the scalar instantiation (a contiguous
// view at an offset is legal input).  The n % 4 tail of the vector path is
// counted by block 0.
//
// The kernel allocates nothing and does not synchronise; the launcher runs
// it on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "frontier_match.cuh"

namespace {

using namespace frontier;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = 4;                  // one 16-byte load of each input
constexpr int BLOCK_NODES = THREADS * PER_THREAD;
constexpr int MAX_BLOCKS = 1024;               // all resident at 8 blocks an SM
constexpr unsigned FULL = 0xffffffffu;

struct Pred {
  int label, op;
  float value;
  __device__ __forceinline__ bool operator()(int lab, float val,
                                             int core) const {
    return core == 1 && (label == WILDCARD || lab == label) &&
           value_ok(op, val, value);
  }
};

// Sum of one int per thread over the block; the result is valid in thread 0.
__device__ __forceinline__ int block_sum(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? warp_sums[lane] : 0;
    for (int off = WARPS / 2; off > 0; off >>= 1)
      v += __shfl_xor_sync(FULL, v, off);
  }
  return v;
}

// VEC: 16-byte loads over n / 4 vectors plus the n % 4 tail; otherwise one
// node a thread-slot.  Each loop trip is warp-uniform, so every lane takes
// part in each ballot.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 8)
label_histogram_kernel(const int32_t* __restrict__ node_label,
                       const float* __restrict__ node_value,
                       const int32_t* __restrict__ core_mask, int64_t n,
                       Pred pred, int32_t* __restrict__ count,
                       unsigned long long* __restrict__ ticket) {
  __shared__ int warp_sums[WARPS];
  int c = 0;  // the warp's count, equal in every lane
  if (VEC) {
    const int4* lab4 = reinterpret_cast<const int4*>(node_label);
    const float4* val4 = reinterpret_cast<const float4*>(node_value);
    const int4* core4 = reinterpret_cast<const int4*>(core_mask);
    const int64_t n4 = n / PER_THREAD;
    for (int64_t base = (int64_t)blockIdx.x * THREADS; base < n4;
         base += (int64_t)gridDim.x * THREADS) {
      const int64_t v = base + threadIdx.x;
      int4 l = make_int4(0, 0, 0, 0), k = make_int4(0, 0, 0, 0);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (v < n4) {
        l = lab4[v];
        x = val4[v];
        k = core4[v];
      }
      c += __popc(__ballot_sync(FULL, pred(l.x, x.x, k.x)));
      c += __popc(__ballot_sync(FULL, pred(l.y, x.y, k.y)));
      c += __popc(__ballot_sync(FULL, pred(l.z, x.z, k.z)));
      c += __popc(__ballot_sync(FULL, pred(l.w, x.w, k.w)));
    }
    if (blockIdx.x == 0 && threadIdx.x < 32) {  // the n % 4 tail, one warp
      const int64_t t = n4 * PER_THREAD + threadIdx.x;
      const bool ok = t < n && pred(node_label[t], node_value[t], core_mask[t]);
      c += __popc(__ballot_sync(FULL, ok));
    }
  } else {
    for (int64_t base = (int64_t)blockIdx.x * BLOCK_NODES; base < n;
         base += (int64_t)gridDim.x * BLOCK_NODES) {
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j) {
        const int64_t t = base + j * THREADS + threadIdx.x;
        const bool ok =
            t < n && pred(node_label[t], node_value[t], core_mask[t]);
        c += __popc(__ballot_sync(FULL, ok));
      }
    }
  }
  // one lane per warp carries the warp's count into the block sum
  const int block_count = block_sum((threadIdx.x & 31) == 0 ? c : 0, warp_sums);

  if (threadIdx.x == 0) {
    // ticket += 1 and running count += block_count, in one atomic
    const unsigned long long old =
        atomicAdd(ticket, (1ull << 32) | (unsigned)block_count);
    if ((unsigned)(old >> 32) == gridDim.x - 1) {
      *count = (int32_t)(unsigned)old + block_count;
      *ticket = 0ull;  // ready for the next call on this stream
    }
  }
}

}  // namespace

// scratch: one 8-byte word, zero when first made and left zero by every
// call.  vec: the wrapper found all three inputs 16-byte aligned.
extern "C" int label_histogram_launch(const void* node_label,
                                      const void* node_value,
                                      const void* core_mask, int64_t n,
                                      int label, int op, float value,
                                      void* count, void* scratch, int vec,
                                      void* stream) {
  if (vec && (((uintptr_t)node_label | (uintptr_t)node_value |
               (uintptr_t)core_mask) & 15u))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  int64_t blocks = (n + BLOCK_NODES - 1) / BLOCK_NODES;
  blocks = blocks < 1 ? 1 : (blocks > MAX_BLOCKS ? MAX_BLOCKS : blocks);
  const Pred pred{label, op, value};
  unsigned long long* ticket = (unsigned long long*)scratch;
  if (vec)
    label_histogram_kernel<true><<<(unsigned)blocks, THREADS, 0, s>>>(
        (const int32_t*)node_label, (const float*)node_value,
        (const int32_t*)core_mask, n, pred, (int32_t*)count, ticket);
  else
    label_histogram_kernel<false><<<(unsigned)blocks, THREADS, 0, s>>>(
        (const int32_t*)node_label, (const float*)node_value,
        (const int32_t*)core_mask, n, pred, (int32_t*)count, ticket);
  return (int)cudaGetLastError();
}
