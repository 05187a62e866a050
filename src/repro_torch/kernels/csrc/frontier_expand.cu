// One-edge frontier expansion match: for each of EB bindings and each of
// the W slots of its frontier vertex's ELL row, does the candidate edge
// extend the binding under its plan step?  Writes the match mask `ok` and
// the candidate's global id `dg`.
//
// Replaces the TPU kernel src/repro/kernels/frontier_expand.py::_kernel
// (launched by frontier_expand_pallas).  The semantics are that kernel's,
// column for column of the packed per-binding parameters `pint`
// (kernels/frontier_expand.py names the columns); its plain PyTorch twin
// is kernels/frontier_expand.py::frontier_expand_plain.  The match algebra
// is shared with the fused kernel through frontier_match.cuh.
//
// The Pallas kernel gathers one (1, W) block of each table per grid step
// through a scalar-prefetch index map and pads W to 128 lanes; both are TPU
// layout and do not carry over.  Here one warp handles one binding:
//  * First load: lane k brings one per-binding value -- the 8 pint
//    columns, pflt, lidx, then the Q row values (a loop takes the rows
//    past lane 31) -- so each is read once, not once per candidate.
//  * Broadcast: the scalars reach every lane by __shfl_sync; the row is
//    staged in the warp's slice of shared memory behind __syncwarp(), so
//    frontier::edge_match keeps taking a pointer.  No block barrier.
//  * Candidates: lane w takes slot w of the binding's table row and loops
//    in strides of 32 when W > 32, so each table read coalesces.
//  * Grid: WARPS = 4 bindings a block, 128 blocks at EB = 512, about one
//    block per SM of 132.
//
// What bounds it on Hopper: at the main path's shape, latency.  One call
// reads six [W] table rows per binding plus its 8 packed scalars, its
// value, its lidx and its [Q] row, and writes a byte mask and an int32
// array of [EB, W]: 333,824 B at EB=512, W=20, Q=8, 0.0996 us at 3.35
// TB/s.  Two dependent DRAM latencies (lidx, then the table row it names;
// the outputs follow) and the launch come to more than a microsecond, so
// the launch floor, not the byte bound, is what the kernel can approach.
//
// The kernel allocates nothing and does not synchronise; the launcher runs
// it on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "frontier_match.cuh"

namespace {

using namespace frontier;

// packed per-binding int parameters: pint[i, P_*]; P_ACTIVE already folds
// m & (step < n_steps), so n_steps never enters the kernel
constexpr int P_EL = 0, P_DIR = 1, P_DLAB = 2, P_DOP = 3, P_DST = 4,
              P_CLOSES = 5, P_STEP = 6, P_ACTIVE = 7, N_PINT = 8;
// the first load's lanes: pint columns, then pflt, lidx and the row
constexpr int L_PFLT = N_PINT, L_LIDX = N_PINT + 1, L_ROW = N_PINT + 2;
constexpr int WARPS = 4;  // bindings per block
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARPS * 32) frontier_expand_kernel(
    const int32_t* __restrict__ lidx, const int32_t* __restrict__ pint,
    const float* __restrict__ pflt, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ ell_dst, const int32_t* __restrict__ ell_label,
    const int32_t* __restrict__ ell_dir, const int32_t* __restrict__ ell_dlab,
    const float* __restrict__ ell_dval, const int32_t* __restrict__ ell_dgid,
    uint8_t* __restrict__ ok_out, int32_t* __restrict__ dg_out, int n_bind,
    int W, int Q) {
  extern __shared__ int32_t s_rows[];  // [WARPS][Q]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * WARPS + warp;
  if (i >= n_bind) return;  // the whole warp leaves together
  int32_t* r = s_rows + warp * Q;
  const int32_t* row = rows + (int64_t)i * Q;

  int v = 0;
  if (lane < N_PINT) {
    v = pint[(int64_t)i * N_PINT + lane];
  } else if (lane == L_PFLT) {
    v = __float_as_int(pflt[i]);
  } else if (lane == L_LIDX) {
    v = lidx[i];
  } else if (lane - L_ROW < Q) {
    v = row[lane - L_ROW];
    r[lane - L_ROW] = v;
  }
  for (int q = 32 - L_ROW + lane; q < Q; q += 32) r[q] = row[q];
  __syncwarp();

  const StepParams sp{__shfl_sync(FULL, v, P_EL),
                      __shfl_sync(FULL, v, P_DIR),
                      __shfl_sync(FULL, v, P_DLAB),
                      __shfl_sync(FULL, v, P_DOP),
                      __shfl_sync(FULL, v, P_DST),
                      __shfl_sync(FULL, v, P_CLOSES),
                      __shfl_sync(FULL, v, P_ACTIVE),
                      __int_as_float(__shfl_sync(FULL, v, L_PFLT))};
  // the wrapper clips lidx into [0, Np)
  const int64_t base = (int64_t)__shfl_sync(FULL, v, L_LIDX) * W;
  const int64_t out = (int64_t)i * W;
  for (int w = lane; w < W; w += 32) {
    const int64_t e = base + w;
    const Candidate c{ell_dst[e], ell_label[e], ell_dir[e],
                      ell_dlab[e], ell_dgid[e], ell_dval[e]};
    ok_out[out + w] = edge_match(sp, c, r, Q);
    dg_out[out + w] = c.dg;
  }
}

}  // namespace

extern "C" int frontier_expand_launch(
    const void* lidx, const void* pint, const void* pflt, const void* rows,
    const void* ell_dst, const void* ell_label, const void* ell_dir,
    const void* ell_dlab, const void* ell_dval, const void* ell_dgid, void* ok,
    void* dg, int n_bind, int W, int Q, void* stream) {
  if ((int64_t)n_bind * W == 0) return 0;
  const size_t smem = (size_t)WARPS * Q * sizeof(int32_t);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n_bind + WARPS - 1) / WARPS);
  frontier_expand_kernel<<<blocks, WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const int32_t*)lidx, (const int32_t*)pint, (const float*)pflt,
      (const int32_t*)rows, (const int32_t*)ell_dst,
      (const int32_t*)ell_label, (const int32_t*)ell_dir,
      (const int32_t*)ell_dlab, (const float*)ell_dval,
      (const int32_t*)ell_dgid, (uint8_t*)ok, (int32_t*)dg, n_bind, W, Q);
  return (int)cudaGetLastError();
}
