// Fused frontier step: one-edge expansion + predicate match + routing of
// every produced row to done / keep / out, for one batch of EB bindings
// over their W-wide ELL rows.
//
// Replaces the TPU kernel src/repro/kernels/fused_frontier.py::_kernel
// (launched by fused_frontier_pallas).  The semantics are that kernel's,
// column for column of the packed per-binding parameters `pint`
// (kernels/fused_frontier.py names the columns); its plain PyTorch twin
// is kernels/fused_frontier.py::fused_frontier_plain.
//
// What bounds it on Hopper: bytes, and at the main path's shape launch
// time.  One call reads eight [W] table rows per binding plus the
// binding's 12 packed scalars, its value and its [Q] row, and writes four
// byte masks and two int32 arrays of [EB, W]: about 0.5 MB at EB=512,
// W=20, Q=8, which is well under a microsecond at HBM rate, so a launch
// costs more than its traffic.  The design is the simple one: one thread
// per candidate (i, w) over a flat grid of EB*W threads.  Threads of one
// binding read the same row of each table at consecutive w, so those
// reads coalesce; the per-binding scalars are broadcast reads that the
// L1 serves.  Nothing is staged in shared memory: each value is used once.
//
// The kernel allocates nothing and does not synchronise; the launcher runs
// it on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "frontier_match.cuh"

namespace {

using namespace frontier;

// packed per-binding int parameters: pint[i, F_*]
constexpr int F_EL = 0, F_DIR = 1, F_DLAB = 2, F_DOP = 3, F_DST = 4,
              F_CLOSES = 5, F_ACTIVE = 6, F_ISLAST = 7, F_USEDG = 8,
              F_FGLIDX = 9, F_FGOWNER = 10, F_NCORE = 11, N_FPINT = 12;

__global__ void fused_frontier_kernel(
    const int32_t* __restrict__ lidx, const int32_t* __restrict__ pint,
    const float* __restrict__ pflt, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ ell_dst, const int32_t* __restrict__ ell_label,
    const int32_t* __restrict__ ell_dir, const int32_t* __restrict__ ell_dlab,
    const float* __restrict__ ell_dval, const int32_t* __restrict__ ell_dgid,
    const int32_t* __restrict__ ell_dlidx,
    const int32_t* __restrict__ ell_downer, uint8_t* __restrict__ ok_out,
    int32_t* __restrict__ dg_out, uint8_t* __restrict__ done_out,
    uint8_t* __restrict__ keep_out, uint8_t* __restrict__ out_out,
    int32_t* __restrict__ dest_out, int n_bind, int W, int Q) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)n_bind * W) return;
  const int i = (int)(t / W);
  const int w = (int)(t - (int64_t)i * W);

  const int32_t* p = pint + (int64_t)i * N_FPINT;
  const StepParams sp{p[F_EL],     p[F_DIR],    p[F_DLAB],  p[F_DOP],
                      p[F_DST],    p[F_CLOSES], p[F_ACTIVE], pflt[i]};
  const int islast = p[F_ISLAST], use_dg = p[F_USEDG];
  const int fg_lidx = p[F_FGLIDX], fg_owner = p[F_FGOWNER];
  const int n_core = p[F_NCORE];

  // the wrapper clips lidx into [0, Np)
  const int64_t e = (int64_t)lidx[i] * W + w;
  const Candidate c{ell_dst[e], ell_label[e], ell_dir[e],
                    ell_dlab[e], ell_dgid[e], ell_dval[e]};
  const int dg = c.dg;
  const int dlidx = ell_dlidx[e];
  const int downer = ell_downer[e];

  // ---- the match (frontier_match.cuh) ----
  const bool ok = edge_match(sp, c, rows + (int64_t)i * Q, Q);

  // ---- the routing ----
  // the produced row's next frontier vertex is the freshly bound dst when
  // the next step expands from the slot this step binds (use_dg), else an
  // already-bound vertex whose local index / owner came in as scalars;
  // both local indices are -1 for absent vertices
  const int lfg = use_dg == 1 ? dlidx : fg_lidx;
  const bool local = lfg >= 0 && lfg < n_core;
  ok_out[t] = ok;
  dg_out[t] = dg;
  done_out[t] = ok && islast == 1;
  keep_out[t] = ok && islast == 0 && local;
  out_out[t] = ok && islast == 0 && !local;
  dest_out[t] = use_dg == 1 ? downer : fg_owner;
}

}  // namespace

extern "C" int fused_frontier_launch(
    const void* lidx, const void* pint, const void* pflt, const void* rows,
    const void* ell_dst, const void* ell_label, const void* ell_dir,
    const void* ell_dlab, const void* ell_dval, const void* ell_dgid,
    const void* ell_dlidx, const void* ell_downer, void* ok, void* dg,
    void* done, void* keep, void* out, void* dest, int n_bind, int W, int Q,
    void* stream) {
  const int64_t n = (int64_t)n_bind * W;
  if (n == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  fused_frontier_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)lidx, (const int32_t*)pint, (const float*)pflt,
      (const int32_t*)rows, (const int32_t*)ell_dst,
      (const int32_t*)ell_label, (const int32_t*)ell_dir,
      (const int32_t*)ell_dlab, (const float*)ell_dval,
      (const int32_t*)ell_dgid, (const int32_t*)ell_dlidx,
      (const int32_t*)ell_downer, (uint8_t*)ok, (int32_t*)dg,
      (uint8_t*)done, (uint8_t*)keep, (uint8_t*)out, (int32_t*)dest, n_bind,
      W, Q);
  return (int)cudaGetLastError();
}
