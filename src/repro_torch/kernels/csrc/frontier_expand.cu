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
// layout and do not carry over.  Here one thread handles one candidate
// (i, w) over a flat grid of EB*W threads: threads of one binding read the
// same table row at consecutive w, so those reads coalesce, and the
// per-binding scalars are broadcast reads that the L1 serves.
//
// What bounds it on Hopper: bytes, and at the main path's shape launch
// time.  One call reads six [W] table rows per binding plus its 8 packed
// scalars, its value and its [Q] row, and writes a byte mask and an int32
// array of [EB, W]: about 0.33 MB at EB=512, W=20, Q=8, a tenth of a
// microsecond at HBM rate, so a launch costs more than its traffic.
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

__global__ void frontier_expand_kernel(
    const int32_t* __restrict__ lidx, const int32_t* __restrict__ pint,
    const float* __restrict__ pflt, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ ell_dst, const int32_t* __restrict__ ell_label,
    const int32_t* __restrict__ ell_dir, const int32_t* __restrict__ ell_dlab,
    const float* __restrict__ ell_dval, const int32_t* __restrict__ ell_dgid,
    uint8_t* __restrict__ ok_out, int32_t* __restrict__ dg_out, int n_bind,
    int W, int Q) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)n_bind * W) return;
  const int i = (int)(t / W);
  const int w = (int)(t - (int64_t)i * W);

  const int32_t* p = pint + (int64_t)i * N_PINT;
  const StepParams sp{p[P_EL],     p[P_DIR],    p[P_DLAB],  p[P_DOP],
                      p[P_DST],    p[P_CLOSES], p[P_ACTIVE], pflt[i]};

  // the wrapper clips lidx into [0, Np)
  const int64_t e = (int64_t)lidx[i] * W + w;
  const Candidate c{ell_dst[e], ell_label[e], ell_dir[e],
                    ell_dlab[e], ell_dgid[e], ell_dval[e]};

  ok_out[t] = edge_match(sp, c, rows + (int64_t)i * Q, Q);
  dg_out[t] = c.dg;
}

}  // namespace

extern "C" int frontier_expand_launch(
    const void* lidx, const void* pint, const void* pflt, const void* rows,
    const void* ell_dst, const void* ell_label, const void* ell_dir,
    const void* ell_dlab, const void* ell_dval, const void* ell_dgid, void* ok,
    void* dg, int n_bind, int W, int Q, void* stream) {
  const int64_t n = (int64_t)n_bind * W;
  if (n == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  frontier_expand_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)lidx, (const int32_t*)pint, (const float*)pflt,
      (const int32_t*)rows, (const int32_t*)ell_dst,
      (const int32_t*)ell_label, (const int32_t*)ell_dir,
      (const int32_t*)ell_dlab, (const float*)ell_dval,
      (const int32_t*)ell_dgid, (uint8_t*)ok, (int32_t*)dg, n_bind, W, Q);
  return (int)cudaGetLastError();
}
