// Start-node label histogram: the number of core nodes whose label matches
// (or the query label is WILDCARD) and whose value passes the value op —
// the one-pass metric that seeds a partition's SNI entry (paper Sec. 5.1).
//
// Replaces the TPU kernel src/repro/kernels/label_histogram.py::_kernel
// (launched by label_histogram_pallas).  Its plain PyTorch twin is
// kernels/label_histogram.py::label_histogram_plain.  NaN values fail every
// op but OP_NONE, as in the TPU kernel.
//
// The TPU kernel walks node blocks of 1024 in a sequential grid and writes
// one partial count per block, which its wrapper sums.  Hopper's blocks
// run in parallel and in no order, so here each block of 1024 threads
// evaluates 1024 nodes' predicates (one node a thread), counts them with a
// warp ballot and a shared-memory sum over its 32 warps, and adds its count
// to one int32 counter with a single atomicAdd.  The launcher zeroes the
// counter on the same stream first.  Integer addition is associative, so
// the order of the atomics does not change the result.
//
// What bounds it on Hopper: bytes.  It reads 12 bytes a node (label,
// value, core flag) once and writes 4: 3.5 MB for one partition of the main
// path (294,400 nodes), about a microsecond at HBM rate.  Neighbouring
// threads read neighbouring nodes, so every load coalesces.
//
// The kernel allocates nothing and does not synchronise; the launcher runs
// it on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "frontier_match.cuh"

namespace {

using namespace frontier;

constexpr int BLOCK_N = 1024;
constexpr int WARPS = BLOCK_N / 32;

__global__ void __launch_bounds__(BLOCK_N)
label_histogram_kernel(const int32_t* __restrict__ node_label,
                       const float* __restrict__ node_value,
                       const int32_t* __restrict__ core_mask, int n, int label,
                       int op, float value, int32_t* __restrict__ count) {
  __shared__ int warp_counts[WARPS];
  const int64_t v = (int64_t)blockIdx.x * BLOCK_N + threadIdx.x;
  bool ok = false;
  if (v < n) {
    ok = core_mask[v] == 1 && (label == WILDCARD || node_label[v] == label) &&
         value_ok(op, node_value[v], value);
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, ok);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int c = warp_counts[lane];  // WARPS == 32: one count per lane
    for (int off = 16; off > 0; off >>= 1)
      c += __shfl_down_sync(0xffffffffu, c, off);
    if (lane == 0 && c != 0) atomicAdd(count, c);
  }
}

static_assert(WARPS == 32, "the second-level sum assumes one warp count a lane");

}  // namespace

extern "C" int label_histogram_launch(const void* node_label,
                                      const void* node_value,
                                      const void* core_mask, int n, int label,
                                      int op, float value, void* count,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const int64_t blocks = ((int64_t)n + BLOCK_N - 1) / BLOCK_N;
  label_histogram_kernel<<<(unsigned)blocks, BLOCK_N, 0, s>>>(
      (const int32_t*)node_label, (const float*)node_value,
      (const int32_t*)core_mask, n, label, op, value, (int32_t*)count);
  return (int)cudaGetLastError();
}
