// The evaluator's masked appends, in one launch: for each of L lanes, rank
// the candidates' done / outm / keep flags in candidate order (t = i*W + w,
// the order a cumsum gives) and write only the rows that land --
//   done -> comp_rows[comp_n + rank]                       (rank < cap - comp_n)
//   outm -> out_rows / out_step / out_dest[out_n + rank]   (rank < cap - out_n)
//   keep -> wr / ws / wv[free[rank]]                       (rank < kfree)
// -- then clamp comp_n and out_n at cap, set the lane's overflow flag when
// a total passes cap or the keep rows outnumber the free work slots, and
// add the rows written to the lane's landed counter.
//
// Replaces no TPU kernel.  The JAX package (src/repro/core/engine.py)
// builds these appends from cumsum and scatter, and the port copied them:
// an int64 cumsum over every candidate flag and an index_put of every
// candidate's Q-wide row, those that do not land sent to a trash row.  Its
// plain PyTorch twin is kernels/frontier_append.py::frontier_append_plain,
// which keeps exactly that code.
//
// What bounds it on Hopper: bytes.  It must read the three flag bytes of
// every candidate and move the rows that land, nothing else: at IMDB's
// shape (L = 32, EB = 512, W = 5,140) 252 MB of flags a loop, 75 us at
// 3.35 TB/s, where the cumsum + index_put form moved about 10 GB.  The
// source rows, steps and destinations, the free-slot list and the work
// buffers are touched only at the candidates that land.
//
// Design:
//  1. A block ranks a tile of TILE = 8,192 consecutive candidates of one
//     lane (grid (tiles, L)): 32 per thread, each thread's flags of a kind
//     read as two 16-byte loads when the wrapper found every mask pointer
//     and lane stride 16-byte aligned, packed into a bit mask.  popc gives
//     the thread's counts; the three counts, packed 21 bits apart into one
//     64-bit word, are scanned across the block in one pass of warp
//     shuffles.  (On the H100, 16 a thread took 2.2 times as long at
//     IMDB's sparse flags and 64 a thread 1.3 times as long at the main
//     path's 32 x 512 x 20 with dense flags, where one tile a lane leaves
//     most SMs idle.)
//  2. Tiles of a lane are chained by decoupled look-back: a tile publishes
//     its aggregate, then warp 0 walks its predecessors 32 at a time,
//     summing aggregates back to the nearest tile that has published its
//     inclusive prefix, and publishes its own.  Counts are stored before a
//     release store of the status and read after an acquire load of it.
//     A predecessor has a lower linear block index, so it was dispatched
//     first and the spin ends.  Each status word carries the launch's
//     epoch above its two flag bits, so statuses left by earlier launches
//     read as "not yet": the scratch is zeroed once, when it is made, and
//     never again.  Its layout depends on its size alone, not on the
//     launch's tile count: lane l's statuses sit at l * TS + i, where TS is
//     the most tiles the scratch holds a lane, and the counts after all
//     L * TS statuses.  So a launch over more tiles than the one before it
//     never reads that launch's counts as statuses.  The epoch is a device
//     word every block reads first;
//     the last lane to finish advances it (a lane's last tile has seen
//     every tile of its lane publish, so all have read it), so launches
//     replayed from a CUDA graph stay correct.
//  3. Each thread then walks its set bits in order, so ranks rise by one
//     and it stops at the first rank past its buffer's limit; landing rows
//     are copied as 16-byte vectors when Q % 4 == 0 and the wrapper found
//     the rows aligned.  A keep row's free slot is written by it alone, so
//     reading that slot's valid byte before writing it tells whether the
//     slot was free: a taken one means more keep rows than free slots.
//  4. The lane's last tile knows the lane's totals once its look-back is
//     done, and updates comp_n, out_n, overflow and landed.  Every tile
//     reads comp_n and out_n before it publishes a status, and the last
//     tile has seen every tile's status, so no tile reads a count after
//     it changes.
//
// The kernel allocates nothing, writes no trash row and does not
// synchronise; the launcher runs it on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 32;                  // candidates a thread, a multiple of 16
constexpr int TILE = THREADS * ITEMS;      // candidates a block
constexpr int KINDS = 3;                   // done, outm, keep
constexpr int FIELD = 21;                  // bits of one count in the packed scan
constexpr uint64_t FIELD_MASK = (1ull << FIELD) - 1;
constexpr uint64_t ST_AGG = 1, ST_INC = 2; // status flags, below the epoch
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const uint8_t* mask[KINDS];   // [L, N] done, outm, keep (keep null: none)
  int64_t mask_ls[KINDS];
  const int32_t* rows; int64_t rows_ls;   // [L, N, Q] source rows
  const int32_t* step; int64_t step_ls;   // [L, N]
  const int32_t* dest; int64_t dest_ls;   // [L, N]
  int32_t* comp_rows; int32_t* comp_n;    // [L, cap + 1, Q], [L]
  int32_t* out_rows; int32_t* out_step; int32_t* out_dest; int32_t* out_n;
  int64_t buf_ls;                         // cap + 1
  uint8_t* overflow; int64_t* landed;     // [L]
  int32_t* wr; int32_t* ws; uint8_t* wv;  // [L, WT + 1(, Q)]
  int64_t work_ls;                        // WT + 1
  const int64_t* free_slot; int64_t free_ls; int64_t kfree;   // [L, kfree]
  uint64_t* ctl;                          // [2]: epoch, ticket
  uint64_t* status;                       // [L, TS]
  uint32_t* agg; uint32_t* inc;           // [L, TS, KINDS]
  int64_t N, cap, TS;                     // TS: status slots a lane
  int T, Q, kinds, mask_vec, row_vec;     // T: this launch's tiles a lane
};

// Tile statuses are published with release stores and read with acquire
// loads, so a block that sees a status sees the counts written before it.
__device__ __forceinline__ uint64_t ld_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ uint32_t ld_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t field(uint64_t packed, int k) {
  return (uint32_t)((packed >> (FIELD * k)) & FIELD_MASK);
}

// The thread's ITEMS flags of one kind from t0 on, as a bit mask.
__device__ __forceinline__ uint64_t load_bits(const uint8_t* m, int64_t t0,
                                              int64_t N, int vec) {
  uint64_t bits = 0;
  if (vec && t0 + ITEMS <= N) {
#pragma unroll
    for (int c = 0; c < ITEMS / 16; ++c) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(m + t0) + c);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if ((w[k] >> (8 * b)) & 0xffu) bits |= 1ull << (16 * c + 4 * k + b);
    }
  } else {
    for (int b = 0; b < ITEMS && t0 + b < N; ++b)
      if (m[t0 + b]) bits |= 1ull << b;
  }
  return bits;
}

__device__ __forceinline__ void copy_row(int32_t* dst, const int32_t* src,
                                         int Q, int vec) {
  if (vec) {
    for (int q = 0; q < Q; q += 4)
      *reinterpret_cast<int4*>(dst + q) = *reinterpret_cast<const int4*>(src + q);
  } else {
    for (int q = 0; q < Q; ++q) dst[q] = src[q];
  }
}

// Exclusive scan of one packed word a thread over the block; ``total`` is
// the block's sum.  Ends with every warp's total in shared memory.
__device__ __forceinline__ uint64_t block_scan(uint64_t v, uint64_t* warp_tot,
                                               uint64_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint64_t x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint64_t y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  uint64_t before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const uint64_t t = warp_tot[w];
    if (w < warp) before += t;
    all += t;
  }
  *total = all;
  return before + x - v;
}

// Publish a tile's three counts, then its status.
__device__ __forceinline__ void publish(uint64_t* status, uint32_t* vals,
                                        int64_t tile, uint32_t v0, uint32_t v1,
                                        uint32_t v2, uint64_t epoch,
                                        uint64_t flag) {
  uint32_t* dst = vals + tile * KINDS;
  st_relaxed(dst, v0);
  st_relaxed(dst + 1, v1);
  st_relaxed(dst + 2, v2);
  st_release(status + tile, (epoch << 2) | flag);
}

__global__ void __launch_bounds__(THREADS) frontier_append_kernel(const Args a) {
  __shared__ uint64_t s_warp[WARPS];
  __shared__ uint64_t s_epoch;
  __shared__ uint32_t s_prefix[KINDS];
  __shared__ int64_t s_base[2];

  const int l = blockIdx.y;
  const int i = blockIdx.x;
  const int64_t tile = (int64_t)l * a.TS + i;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    // read before this tile publishes anything (design note 4)
    s_epoch = ld_acquire(a.ctl);
    s_base[0] = a.comp_n[l];
    s_base[1] = a.out_n[l];
  }

  const int64_t t0 = (int64_t)i * TILE + (int64_t)threadIdx.x * ITEMS;
  uint64_t bits[KINDS] = {0, 0, 0};
#pragma unroll
  for (int k = 0; k < KINDS; ++k)
    if (k < a.kinds)
      bits[k] = load_bits(a.mask[k] + l * a.mask_ls[k], t0, a.N, a.mask_vec);
  const uint64_t mine = (uint64_t)__popcll(bits[0]) |
                        ((uint64_t)__popcll(bits[1]) << FIELD) |
                        ((uint64_t)__popcll(bits[2]) << (2 * FIELD));
  uint64_t total;
  const uint64_t excl = block_scan(mine, s_warp, &total);
  const uint32_t t0c = field(total, 0), t1c = field(total, 1), t2c = field(total, 2);

  if (threadIdx.x < 32) {
    const uint64_t epoch = s_epoch;
    uint32_t p0 = 0, p1 = 0, p2 = 0;
    if (i > 0) {
      if (lane == 0) publish(a.status, a.agg, tile, t0c, t1c, t2c, epoch, ST_AGG);
      for (int64_t j = i - 1;; j -= 32) {
        const int64_t p = j - lane;
        uint32_t v0 = 0, v1 = 0, v2 = 0;
        bool is_inc = true;     // before tile 0: nothing to add
        if (p >= 0) {
          const uint64_t* sp = a.status + (int64_t)l * a.TS + p;
          uint64_t st;
          while (((st = ld_acquire(sp)) >> 2) != epoch || (st & 3) == 0) __nanosleep(32);
          is_inc = (st & 3) == ST_INC;
          const uint32_t* src = (is_inc ? a.inc : a.agg) + ((int64_t)l * a.TS + p) * KINDS;
          v0 = ld_relaxed(src);
          v1 = ld_relaxed(src + 1);
          v2 = ld_relaxed(src + 2);
        }
        // add the predecessors from j down to the nearest inclusive one
        const unsigned incs = __ballot_sync(FULL, is_inc);
        if (incs && lane > __ffs(incs) - 1) v0 = v1 = v2 = 0;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          v0 += __shfl_xor_sync(FULL, v0, off);
          v1 += __shfl_xor_sync(FULL, v1, off);
          v2 += __shfl_xor_sync(FULL, v2, off);
        }
        p0 += v0;
        p1 += v1;
        p2 += v2;
        if (incs) break;
      }
    }
    if (lane == 0) {
      publish(a.status, a.inc, tile, p0 + t0c, p1 + t1c, p2 + t2c, epoch, ST_INC);
      s_prefix[0] = p0;
      s_prefix[1] = p1;
      s_prefix[2] = p2;
    }
  }
  __syncthreads();

  // the rows that land, each thread's in candidate order
  const int32_t* rows = a.rows + l * a.rows_ls;
  const int64_t lbuf = (int64_t)l * a.buf_ls;
  {
    int64_t tgt = s_base[0] + s_prefix[0] + field(excl, 0);
    for (uint64_t m = bits[0]; m && tgt < a.cap; m &= m - 1, ++tgt) {
      const int64_t t = t0 + __ffsll(m) - 1;
      copy_row(a.comp_rows + (lbuf + tgt) * a.Q, rows + t * a.Q, a.Q, a.row_vec);
    }
  }
  {
    int64_t tgt = s_base[1] + s_prefix[1] + field(excl, 1);
    for (uint64_t m = bits[1]; m && tgt < a.cap; m &= m - 1, ++tgt) {
      const int64_t t = t0 + __ffsll(m) - 1;
      copy_row(a.out_rows + (lbuf + tgt) * a.Q, rows + t * a.Q, a.Q, a.row_vec);
      a.out_step[lbuf + tgt] = a.step[l * a.step_ls + t];
      a.out_dest[lbuf + tgt] = a.dest[l * a.dest_ls + t];
    }
  }
  if (a.kinds == KINDS) {
    int64_t r = s_prefix[2] + field(excl, 2);
    for (uint64_t m = bits[2]; m && r < a.kfree; m &= m - 1, ++r) {
      const int64_t t = t0 + __ffsll(m) - 1;
      const int64_t w = l * a.work_ls + a.free_slot[l * a.free_ls + r];
      // a taken slot: more keep rows than free slots (design note 3)
      if (a.wv[w]) a.overflow[l] = 1;
      copy_row(a.wr + w * a.Q, rows + t * a.Q, a.Q, a.row_vec);
      a.ws[w] = a.step[l * a.step_ls + t];
      a.wv[w] = 1;
    }
  }

  if (threadIdx.x == 0 && i == a.T - 1) {
    const int64_t comp = s_base[0] + s_prefix[0] + t0c;
    const int64_t out = s_base[1] + s_prefix[1] + t1c;
    const int64_t kept = (int64_t)s_prefix[2] + t2c;
    // keep rows past kfree outnumber the free slots too, since the
    // wrapper holds kfree to min(N, WT)
    if (comp > a.cap || out > a.cap || kept > a.kfree) a.overflow[l] = 1;
    const int64_t comp_c = comp < a.cap ? comp : a.cap;
    const int64_t out_c = out < a.cap ? out : a.cap;
    a.comp_n[l] = (int32_t)comp_c;
    a.out_n[l] = (int32_t)out_c;
    a.landed[l] += comp_c - s_base[0] + out_c - s_base[1] +
                   (kept < a.kfree ? kept : a.kfree);
    // every tile of the lane has read the epoch (it published a status);
    // the last lane to finish advances the epoch for the next launch
    if (atomicAdd(reinterpret_cast<unsigned long long*>(a.ctl + 1), 1ull) ==
        gridDim.y - 1ull) {
      a.ctl[1] = 0;
      st_release(a.ctl, s_epoch + 1);
    }
  }
}

}  // namespace

extern "C" int frontier_append_launch(
    const void* done, long long done_ls, const void* outm, long long outm_ls,
    const void* keep, long long keep_ls, const void* rows, long long rows_ls,
    const void* step, long long step_ls, const void* dest, long long dest_ls,
    void* comp_rows, void* comp_n, void* out_rows, void* out_step,
    void* out_dest, void* out_n, long long buf_ls, void* overflow,
    void* landed, void* wr, void* ws, void* wv, long long work_ls,
    const void* free_slot, long long free_ls, long long kfree, void* scratch,
    long long scratch_words, long long N, int L, int Q, long long cap,
    int mask_vec, int row_vec, void* stream) {
  if (L == 0 || N == 0) return 0;
  if (L < 0 || L > 65535 || N < 0 || Q <= 0 || cap < 0 || kfree < 0)
    return (int)cudaErrorInvalidValue;
  const long long T = (N + TILE - 1) / TILE;
  // the scratch's layout, fixed by its size (design note 2): the epoch
  // and ticket, L * TS statuses, then L * TS * KINDS aggregates and as
  // many inclusive prefixes (four words a slot)
  const long long TS = scratch_words < 2 ? 0 : (scratch_words - 2) / (4ll * L);
  // every count of a lane fits the 32-bit tile values, every tile count
  // the grid, and the scratch holds the launch's statuses
  if (N >= (1ll << 31) || T > 0x7fffffffll || T > TS)
    return (int)cudaErrorInvalidValue;
  uint64_t* ctl = (uint64_t*)scratch;
  uint64_t* status = ctl + 2;
  uint32_t* vals = (uint32_t*)(status + L * TS);
  Args a{{(const uint8_t*)done, (const uint8_t*)outm, (const uint8_t*)keep},
         {done_ls, outm_ls, keep_ls},
         (const int32_t*)rows, rows_ls, (const int32_t*)step, step_ls,
         (const int32_t*)dest, dest_ls,
         (int32_t*)comp_rows, (int32_t*)comp_n, (int32_t*)out_rows,
         (int32_t*)out_step, (int32_t*)out_dest, (int32_t*)out_n, buf_ls,
         (uint8_t*)overflow, (int64_t*)landed,
         (int32_t*)wr, (int32_t*)ws, (uint8_t*)wv, work_ls,
         (const int64_t*)free_slot, free_ls, kfree,
         ctl, status, vals, vals + L * TS * KINDS,
         N, cap, TS, (int)T, Q, keep ? KINDS : 2, mask_vec, row_vec};
  const dim3 grid((unsigned)T, (unsigned)L);
  frontier_append_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
