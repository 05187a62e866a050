// The evaluator loop's whole frontier step, in one launch: from the loop's
// selection (sel, m) over the work buffers straight to what the appends
// consume -- the match, the routing of every candidate to done / keep /
// out with its destination pid, and each candidate's new binding row and
// step -- for L lanes of EB bindings over their W-wide ELL rows.
//
// Replaces the TPU kernel src/repro/kernels/fused_frontier.py::_kernel
// (launched by fused_frontier_pallas) together with what the JAX package
// computes around it on the host side of the kernel boundary: the
// selected-row gathers, ops._fused_params (the 12 packed per-binding
// scalars), the lidx clamp, the per-call denorm_locality tables and
// engine._next_rows.  Its plain PyTorch twin is
// kernels/fused_frontier.py::frontier_step_plain, composed of exactly
// those pieces.
//
// What bounds it on Hopper: bytes, and at the main path's shape launch
// latency.  At EB=512, W=20, Q=8, L=1 one call reads six [W] table rows
// per binding (245,760 B), at most one g2l and one owner entry per
// candidate (<= 81,920 B), each binding's sel, m, step, lidx and Q-wide row
// plus the lane's plan (about 29 KB), and writes 48 B per candidate
// (491,520 B): about 0.85 MB, a quarter of a microsecond at 3.35 TB/s.  A
// launch and the dependent load chain (sel -> row, step, lidx -> table
// row -> g2l/owner of dg) cost more than that traffic.
//
// What the design does about the TPU design's four limits:
//  1. The kernel boundary is the evaluator's, not Mosaic's: the kernel
//     loads its own indices (sel, then the row, step and lidx it picks)
//     and the plan step, so the ~48 PyTorch ops that packed pint, clamped
//     lidx, gathered the rows and built nr/ns are gone.
//  2. Everything loop-invariant (tables, g2l, owner, the packed plan, the
//     lane scalars) is checked once per evaluator call by the wrapper;
//     a launch takes preallocated outputs and allocates nothing.
//  3. No [Np, W] locality tables: the g2l and owner entries of each
//     candidate's next frontier vertex are looked up directly (__ldg).
//     One g2l row and owner are 1.76 MB each at V = 440,000 and stay
//     resident in the 50 MB L2.
//  4. Bindings are staged: phase 1 runs one thread per binding of the
//     block's tile and puts its row, plan step and next frontier vertex in
//     shared memory; phase 2 runs the tile's candidates (i, w) flat, each
//     thread reading its six table values at [lidx, w] (coalesced across
//     w) and the binding's scalars from shared memory.  Each candidate
//     looks up the g2l/owner entry of its next frontier vertex itself:
//     the already-bound one (a warp-wide broadcast, issued beside the
//     table loads) or its freshly bound dst, so the chain holds one load
//     and one barrier fewer than a lookup in phase 1 would.  nr rows are
//     written as 16-byte vectors when Q % 4 == 0.
// A tile is TILE = 4 bindings of one lane (grid (ceil(EB / TILE), L)), so
// EB = 512 at L = 1 is 128 blocks on the 132 SMs; a block has
// min(256, TILE * W rounded up to a warp) threads and loops when W is
// wider (W = 130 works).  Shared memory per block: TILE Binding records
// (224 B, static) plus TILE * Q ints of rows and the lane's S x 8 int plan
// and S floats (dynamic), 560 B at Q = 8, S = 12.
//
// wgmma and TMA have no role: there is no matrix product, and the inputs
// are 80-byte rows picked by a data-dependent lidx, not tiles.
//
// The kernel allocates nothing and does not synchronise; the launcher runs
// it on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "frontier_match.cuh"

namespace {

using namespace frontier;

constexpr int TILE = 4;           // bindings per block
constexpr int MAX_THREADS = 256;
// packed plan table plan_int[lane, s, P_*]
constexpr int P_SRC = 0, P_DST = 1, P_EL = 2, P_DIR = 3, P_DLAB = 4,
              P_DOP = 5, P_CLOSES = 6, N_PLAN = 8;
// lane table lane[l, L_*]
constexpr int L_PART = 0, L_NCORE = 1, L_NSTEPS = 2, N_LANE = 3;

struct Args {
  const int32_t* wr;  int64_t wr_ls;   // [L, ., Q] work rows, lane stride
  const int32_t* ws;  int64_t ws_ls;   // [L, .] steps
  const int32_t* lidx; int64_t lidx_ls;  // [L, n_rows] frontier local index
  int n_rows;
  const int64_t* sel; int64_t sel_ls;  // [L, EB] selected work rows
  const uint8_t* m;                    // [L, EB] selected row is active
  const int32_t* ell_dst; const int32_t* ell_label; const int32_t* ell_dir;
  const int32_t* ell_dlab; const float* ell_dval; const int32_t* ell_dgid;
  const int32_t* g2l;                  // [P * V]
  const int32_t* owner;                // [V]
  const int32_t* plan_int;             // [L, S, N_PLAN]
  const float* plan_val;               // [L, S]
  const int32_t* lane;                 // [L, N_LANE]
  uint8_t* ok; int32_t* dg; uint8_t* done; uint8_t* keep; uint8_t* outm;
  int32_t* dest; int32_t* nr; int32_t* ns;   // [L, EB*W] (nr [L, EB*W, Q])
  int EB, W, Q, S, Np, V;
  int nr_vec;                          // Q % 4 == 0 and nr 16-byte aligned
};

// One binding's staged scalars.
struct Binding {
  int64_t e0;        // first element of its table row
  StepParams sp;
  int islast, use_dg, fg, step;   // fg: the bound next frontier vertex
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void __launch_bounds__(MAX_THREADS)
frontier_step_kernel(const Args a) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* srow = smem;                          // [TILE, Q]
  int32_t* splan = smem + TILE * a.Q;            // [S, N_PLAN]
  float* sval = (float*)(splan + a.S * N_PLAN);  // [S]
  __shared__ Binding sb[TILE];

  const int l = blockIdx.y;
  const int i0 = blockIdx.x * TILE;
  const int nb = min(TILE, a.EB - i0);
  const int part = a.lane[l * N_LANE + L_PART];
  const int n_core = a.lane[l * N_LANE + L_NCORE];
  const int n_steps = a.lane[l * N_LANE + L_NSTEPS];

  // phase 1a: each binding thread issues its index loads before the plan
  // is staged, so the two overlap
  const int j = threadIdx.x;
  int64_t r = 0;
  int step = 0, li = 0;
  bool mi = false;
  const int32_t* row = nullptr;
  if (j < nb) {
    const int64_t bi = (int64_t)l * a.EB + i0 + j;
    r = a.sel[l * a.sel_ls + i0 + j];
    // sel comes from the evaluator's sort; the clamp only keeps a bad
    // index in bounds
    r = r < 0 ? 0 : (r >= a.n_rows ? a.n_rows - 1 : r);
    mi = a.m[bi] != 0;
    row = a.wr + l * a.wr_ls + r * a.Q;
    step = a.ws[l * a.ws_ls + r];
    li = clampi(a.lidx[l * a.lidx_ls + r], 0, a.Np - 1);
    for (int q = 0; q < a.Q; ++q) srow[j * a.Q + q] = row[q];
  }
  // phase 0: stage the lane's plan
  const int32_t* gplan = a.plan_int + (int64_t)l * a.S * N_PLAN;
  for (int k = threadIdx.x; k < a.S * N_PLAN; k += blockDim.x)
    splan[k] = gplan[k];
  for (int k = threadIdx.x; k < a.S; k += blockDim.x)
    sval[k] = a.plan_val[(int64_t)l * a.S + k];
  __syncthreads();

  // phase 1b: the binding's plan step and next frontier vertex
  if (j < nb) {
    const int s = clampi(step, 0, a.S - 1);
    const int s2 = clampi(step + 1, 0, a.S - 1);
    const int32_t* p = splan + s * N_PLAN;
    const int nsrc = splan[s2 * N_PLAN + P_SRC];
    Binding b;
    b.e0 = ((int64_t)part * a.Np + li) * a.W;
    b.sp = StepParams{p[P_EL], p[P_DIR], p[P_DLAB], p[P_DOP], p[P_DST],
                      p[P_CLOSES], (mi && step < n_steps) ? 1 : 0, sval[s]};
    b.islast = step + 1 >= n_steps;
    b.use_dg = nsrc == p[P_DST] && p[P_CLOSES] == 0;
    // plan slots lie in [0, Q); the guard only keeps a bad plan in bounds
    b.fg = srow[j * a.Q + ((nsrc >= 0 && nsrc < a.Q) ? nsrc : 0)];
    b.step = step;
    sb[j] = b;
  }
  __syncthreads();

  // phase 2: the tile's candidates (i, w), flat
  const int n = nb * a.W;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int jj = c / a.W;
    const int w = c - jj * a.W;
    const Binding& b = sb[jj];
    const int32_t* g2l = a.g2l + (int64_t)part * a.V;
    // the produced row's next frontier vertex is the freshly bound dst
    // when the next step expands from the slot this step binds (use_dg),
    // else the already-bound fg, whose lookups go out before the table
    // loads; a local index is -1 for an absent vertex
    int lfg = 0, dest = 0;
    if (!b.use_dg) {
      const int fsafe = clampi(b.fg, 0, a.V - 1);
      lfg = b.fg >= 0 ? __ldg(g2l + fsafe) : -1;
      dest = __ldg(a.owner + fsafe);
    }
    const int64_t e = b.e0 + w;
    const Candidate cd{__ldg(a.ell_dst + e), __ldg(a.ell_label + e),
                       __ldg(a.ell_dir + e), __ldg(a.ell_dlab + e),
                       __ldg(a.ell_dgid + e), __ldg(a.ell_dval + e)};
    if (b.use_dg) {
      const int dsafe = clampi(cd.dg, 0, a.V - 1);
      lfg = cd.dg >= 0 ? __ldg(g2l + dsafe) : -1;
      dest = __ldg(a.owner + dsafe);
    }
    const int32_t* rr = srow + jj * a.Q;
    const bool ok = edge_match(b.sp, cd, rr, a.Q);
    const bool local = lfg >= 0 && lfg < n_core;
    const int64_t t = ((int64_t)l * a.EB + i0 + jj) * a.W + w;
    a.ok[t] = ok;
    a.dg[t] = cd.dg;
    a.done[t] = ok && b.islast;
    a.keep[t] = ok && !b.islast && local;
    a.outm[t] = ok && !b.islast && !local;
    a.dest[t] = dest;
    a.ns[t] = b.step + 1;

    // the new row binds the dst slot, unless the step closes a cycle
    const int pd = b.sp.closes == 0 ? b.sp.dst : -1;
    int32_t* o = a.nr + t * a.Q;
    if (a.nr_vec) {
      for (int q = 0; q < a.Q; q += 4) {
        int4 v = *reinterpret_cast<const int4*>(rr + q);
        if (pd == q) v.x = cd.dg;
        if (pd == q + 1) v.y = cd.dg;
        if (pd == q + 2) v.z = cd.dg;
        if (pd == q + 3) v.w = cd.dg;
        *reinterpret_cast<int4*>(o + q) = v;
      }
    } else {
      for (int q = 0; q < a.Q; ++q) o[q] = q == pd ? cd.dg : rr[q];
    }
  }
}

}  // namespace

extern "C" int fused_frontier_launch(
    const void* wr, long long wr_ls, const void* ws, long long ws_ls,
    const void* lidx, long long lidx_ls, int n_rows, const void* sel,
    long long sel_ls, const void* m, const void* ell_dst,
    const void* ell_label, const void* ell_dir, const void* ell_dlab,
    const void* ell_dval, const void* ell_dgid, const void* g2l,
    const void* owner, const void* plan_int, const void* plan_val,
    const void* lane, void* ok, void* dg, void* done, void* keep, void* outm,
    void* dest, void* nr, void* ns, int L, int EB, int W, int Q, int S,
    int Np, int V, void* stream) {
  if (L == 0 || EB == 0 || W == 0) return 0;
  if (Q <= 0 || S <= 0 || n_rows <= 0 || Np <= 0 || V <= 0)
    return (int)cudaErrorInvalidValue;
  Args a{(const int32_t*)wr, wr_ls, (const int32_t*)ws, ws_ls,
         (const int32_t*)lidx, lidx_ls, n_rows, (const int64_t*)sel, sel_ls,
         (const uint8_t*)m, (const int32_t*)ell_dst,
         (const int32_t*)ell_label, (const int32_t*)ell_dir,
         (const int32_t*)ell_dlab, (const float*)ell_dval,
         (const int32_t*)ell_dgid, (const int32_t*)g2l,
         (const int32_t*)owner, (const int32_t*)plan_int,
         (const float*)plan_val, (const int32_t*)lane, (uint8_t*)ok,
         (int32_t*)dg, (uint8_t*)done, (uint8_t*)keep, (uint8_t*)outm,
         (int32_t*)dest, (int32_t*)nr, (int32_t*)ns, EB, W, Q, S, Np, V,
         (Q % 4 == 0 && ((uintptr_t)nr % 16) == 0) ? 1 : 0};
  const int want = ((TILE * W + 31) / 32) * 32;
  const int threads = want < MAX_THREADS ? want : MAX_THREADS;
  const dim3 grid((unsigned)((EB + TILE - 1) / TILE), (unsigned)L);
  const size_t shmem = sizeof(int32_t) * ((size_t)TILE * Q + (size_t)S * N_PLAN) +
                       sizeof(float) * (size_t)S;
  frontier_step_kernel<<<grid, threads, shmem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
