// The sinc frontend as matrix products on Hopper's warpgroup MMA (wgmma,
// sm_90a): sinc conv1d (C filters x 129 taps) -> |.| -> max pool (3,3) over
// (filter, time), floor semantics -> eval BatchNorm of one channel folded to
// a scalar scale/shift -> SELU.  (B, L) bf16 waveform in; F = C/3 rows by
// T = (L-128)/3 columns per batch row out, stored in one of four layouts:
//
//   filter-major (24, B, T), rows F..23 zero      aasist_frontend_dot_wg_fm
//   batch-major  (B, 24, T), rows F..23 zero      aasist_frontend_dot_wg_bm
//   the Scorer's (B, 1, F, T)                     aasist_frontend_dot_wg_plain
//   the zero-bordered frame (B, F + 2, T + 2)     aasist_frontend_dot_wg_padded
//
// Replaces the TPU kernels tools/probe_frontend_variants.py:kernel_v2
// (launched by run_v2) and tools/probe_fe_fix.py:kernel_v2bm (launched by
// run_v2bm): the first two layouts.  It computes what csrc/frontend_dot.cu
// computes (bf16 products, f32 sums, |.|, the pool, scale/shift and SELU in
// f32, one rounding at the store, rows F..23 exactly zero, samples past L
// read as zeros) on a new body; that kernel stays, and the Scorer's plain
// and padded routes stay on it.  The last two layouts are built here for a
// reading beside them and are on no route.  SELU's negative side is
// scale alpha (__expf(z) - 1), where csrc/frontend_dot.cu calls expm1f: a
// bf16 ulp apart at most where a value lies near a rounding boundary, and
// a few 1e-7 near zero (expm1f here measured 0.5009 ms against 0.4411 on
// the H100 at B = 128, filter-major, and was dropped).
//
// What bounds it on the H100.  At B = 128, L = 64,600 the conv is
// 2 * 128 * 69 * 64,470 * 129 = 1.47e11 FLOP against ~149 MB of bf16 in
// and out: compute-bound, 0.1485 ms at the tensor cores' 989 TFLOP/s.
//
// What held csrc/frontend_dot.cu back, and what this design does about it:
//
// 1. Nothing overlapped inside a block: the tile load, the MMAs, the pool
//    and the stores ran in turn between __syncthreads.  Here a CTA holds
//    three warpgroups that run their items independently, so that the
//    tensor cores run two warpgroups' MMAs while the third pools and
//    stores; each warpgroup loads its next item's waveform tile into its
//    second slot while it computes the current one (the loads are issued
//    at the item's start and stored after its first pass).  A producer
//    warp per warpgroup handing tiles over through mbarriers, the first
//    design, left room for two warpgroups only (ptxas held its 320-thread
//    CTA to 168 registers a thread, what three warpgroups get): two
//    warpgroups, left to run together, kept in step and left the tensor
//    cores idle through both epilogues, and taking turns (ping-pong) left
//    one warpgroup's three accumulator chains to feed them alone.  The
//    tile needs no TMA (and a tensor map would refuse it: at L = 16,001
//    the row pitch is 32,002 bytes, no multiple of 16).  One CTA an SM,
//    persistent; the pool and SELU are branch-free, so that a lane's
//    twelve windows interleave.  Two warpgroups a CTA (179-191 registers,
//    no spills) measured 0.5152 ms against three's 0.4411 and were
//    dropped.
// 2. Shared-memory traffic per FLOP: mma.sync read the bank again for
//    every warp and m16 tile through ldmatrix.  Here B (the bank) is read
//    by the tensor cores from shared memory through a matrix descriptor,
//    packed once per CTA in wgmma's no-swizzle core-matrix layout (blocks
//    of 8 filter columns x 8 taps, 16 bytes a row, 128 bytes a block; the
//    two k-halves of a k-step 128 bytes apart (LBO), the nine n8 groups
//    256 bytes apart (SBO)); the 8 columns ldmatrix.x4 read and no MMA
//    used are gone.
// 3. mma.sync reaches part of the tensor cores' rate; wgmma m64n72k16 is
//    their native instruction.
// 4. The padding (72 x 144 against 69 x 129) stays: N = 72 and K = 9
//    k-steps of 16 are the least that hold 69 filters and 129 taps.
//
// The GEMM: D[position, filter] = sum_k X[position, k] W[k, filter] with
// X[n, k] = x[n + k], a Toeplitz view whose rows lie 2 bytes apart, which
// no shared-memory descriptor can describe.  So A comes from registers:
// each lane builds its fragment (mma.sync m16n8k16's A layout in each warp,
// warp w of the warpgroup holding rows 16 w .. 16 w + 15) with 32-bit
// shared loads from the tile.  A register holds x[n+k] and x[n+k+1]; for
// odd n + k that pair is not 4-byte aligned, so the tile is kept twice,
// the second copy shifted by one sample (the copies 272 words apart, 16
// banks, so a warp's loads from both never share a bank), and each lane
// picks the copy by the parity of its position once.
//
// The pool runs on the accumulators.  A warpgroup issues three m64n72k16 a
// k-step (three accumulators of 36 f32 registers a thread) over 192
// positions: accumulator i's row g + 8 h of warp w (g = lane / 4) is row
// slot s = 2 i + h, position 48 w + 3 (g + 8 (s / 3)) + s % 3; accumulator
// column slot c = 2 n + (col & 1) of n8 tile n at lane-in-group q is filter
// 3 (6 q + c / 3) + c % 3, the bank column order the packing writes.  So
// each lane holds whole (3,3) windows: 6 pooled rows x 2 pooled columns a
// pass, no shuffles (tests/test_torch_frontend_dot_wg.py models these maps
// in numpy).  A work item is 128 pooled columns of one batch row, two
// passes of 64; pooled values go through a staging tile so that the
// stores run along time, 16 bytes a store between a row's unaligned head
// and tail (the output's row pitch, T * 2 bytes, is 4 mod 16 at L = 64,600
// and 2 mod 4 at L = 16,001: no TMA store either).  Each staging row is
// shifted as its output row is, so a 16-byte chunk is one 16-byte shared
// load and one 16-byte global store.
//
// The k-loop keeps two k-steps in flight (wgmma.wait_group 1): a k-step's
// A fragments are loaded while the previous k-step's wgmmas run (three in
// flight measured slower).  The Toeplitz view would let a lane reuse a
// third of its A fragments across k-steps (if its rows g and g + 8 lay 48
// positions apart); not taken: it needs 18 more registers a thread, and
// the warpgroups are at their 168.
//
// Timing-only builds for the probe (tools/probe_frontend_variants.py under
// aasist_tpu_torch/; their output is wrong): FDW_CUT bit 1, one window of
// a lane's twelve pooled, SELU'd and staged; bit 2, no global stores.
// Both bits leave the tile loads, the MMAs and a one-window epilogue: the
// breakdown that says what holds the kernel back, kept for the next
// redesign to read its gains against.
//
// Taps 129..143 are zero in the packed bank but their samples are read: a
// non-finite sample reaches 15 more positions than in the plain chain.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int KSIZE = 129;               // sinc taps
constexpr int KPAD = 144;                // taps padded to 9 k-steps of 16
constexpr int KSTEPS = KPAD / 16;
constexpr int NT = 9;                    // n8 groups of a wgmma: N = 72
constexpr int ACC = 3;                   // wgmmas (accumulators) a k-step
constexpr int NACC = 4 * NT;             // f32 registers of one accumulator
constexpr int ROWS = 24;                 // stored rows
constexpr int TILE = 128;                // pooled columns a work item
constexpr int PASS_COLS = 64;            // pooled columns a pass
constexpr int PASSES = TILE / PASS_COLS;
#ifndef FDW_CUT
#define FDW_CUT 0
#endif
constexpr int CONSUMERS = 3;             // warpgroups a CTA
constexpr int CUT = FDW_CUT;             // timing cuts (header)
constexpr int CTHREADS = 128;            // threads of a warpgroup
constexpr int THREADS = CTHREADS * CONSUMERS;
constexpr int XS = 3 * TILE + KPAD + 8;  // samples a copy of the tile
constexpr int XSP = 544;                 // bf16 stride of the two copies
constexpr int PLOADS = (XS + 1 + CTHREADS - 1) / CTHREADS;  // a thread's
                                         // loads of a tile
constexpr int OSW = TILE + 24;           // bf16 stride of a staging row:
                                         // 16-byte rows, a segment of up
                                         // to TILE + 2 after a shift < 8,
                                         // 6 rows 8 banks apart
constexpr int B_LBO = 128;               // bytes between k-half blocks
constexpr int B_SBO = 256;               // bytes between n8 blocks
constexpr int B_KSTEP = NT * 2 * 128;    // packed bank bytes a k-step
static_assert(XS % 2 == 0 && XSP >= XS && (XSP / 2) % 32 == 16,
              "4-byte aligned copies, 16 banks apart");
static_assert(3 * PASS_COLS == 48 * 4, "a pass is 4 warps x 48 positions");

struct __align__(128) Smem {
  bf16 bank[KSTEPS * B_KSTEP / 2];          // core-matrix packed bank
  bf16 xs[CONSUMERS][2][2][XSP];            // two tiles, each twice (the
                                            // second shifted one sample)
  bf16 os[CONSUMERS][ROWS * OSW];           // pooled tile [row][column]
};
static_assert(OSW % 8 == 0 && OSW >= TILE + 2 + 7 && (3 * OSW) % 32 == 8,
              "aligned staging rows");

// SELU, both sides computed and one selected: no branch, so the compiler
// interleaves a lane's twelve.
__device__ __forceinline__ float selu(float z) {
  const float scale = 1.0507009873554805f, alpha = 1.6732632423543772f;
  const float neg = (scale * alpha) * (__expf(fminf(z, 0.f)) - 1.f);
  return z > 0.f ? scale * z : neg;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins the accumulators in program order around the asynchronous wgmmas:
// the compiler may not move their writes or reads across this point.
__device__ __forceinline__ void fence_acc(float (&acc)[ACC][NACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i)
#pragma unroll
    for (int r = 0; r < NACC; ++r) asm volatile("" : "+f"(acc[i][r])::"memory");
}

// B's descriptor: the k-step's packed bank at `addr`, no swizzle.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(B_LBO >> 4) << 16) | ((uint64_t)(B_SBO >> 4) << 32);
}

// d (64 x 72, f32) += a (64 x 16, bf16, registers) * b (16 x 72, bf16,
// shared memory, K-major)
__device__ __forceinline__ void wgmma_m64n72k16(float (&d)[NACC],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The store layouts (the kernel's template parameter).
enum Layout { FM = 0, BM = 1, PLAIN = 2, PADDED = 3 };

// Row r of an item's output, from element 0 of its segment: the item's
// first column, or in the frame the column before it when the item holds
// the left border (lead = 1).
template <int LAYOUT>
__device__ __forceinline__ bf16* row_start(bf16* out, int b, int r, int t0,
                                           int lead, int B, int F_out,
                                           int T_out) {
  if constexpr (LAYOUT == FM)
    return out + ((long long)r * B + b) * T_out + t0;
  else if constexpr (LAYOUT == BM)
    return out + ((long long)b * ROWS + r) * T_out + t0;
  else if constexpr (LAYOUT == PLAIN)
    return out + ((long long)b * F_out + r) * T_out + t0;
  else
    return out + ((long long)b * (F_out + 2) + r) * (T_out + 2) + t0 + 1 -
           lead;
}

// Element 0 of a row's segment sits `shift` elements past a 16-byte
// boundary; the staging row holds segment element k at shift + k, so that
// both sides' 16-byte chunks line up.
__device__ __forceinline__ int shift_of(const bf16* p) {
  return (int)(reinterpret_cast<uintptr_t>(p) & 15) >> 1;
}

// One warpgroup stores its item from the staging tile: each row's segment
// as a head up to the first 16-byte boundary, 16-byte copies, and a tail.
// Staging row p holds stored row p (the frame's row p + 1); the frame's
// rows 0 and F + 1 are zeros, its columns 0 and T + 1 zeros in staging.
// A thread's units are loaded first and stored after, so that their
// shared-memory latencies overlap.
template <int LAYOUT>
__device__ __forceinline__ void store_item(bf16* __restrict__ out,
                                           const bf16* os, int b, int t0,
                                           int B, int F_out, int T_out,
                                           int ctid) {
  const int ncols = min(TILE, T_out - t0);
  const int nrows = LAYOUT == PLAIN ? F_out
                    : LAYOUT == PADDED ? F_out + 2 : ROWS;
  const int lead = LAYOUT == PADDED && t0 == 0;
  const int trail = LAYOUT == PADDED && t0 + TILE >= T_out;
  const int n = lead + ncols + trail;
  constexpr int UNITS = TILE / 8 + 2;    // head, <= TILE / 8 + 1 chunks
  constexpr int PER = ((ROWS + 2) * UNITS + CTHREADS - 1) / CTHREADS;
  uint4 val[PER];
  bf16* at[PER];
  int cnt[PER];                          // 8: a 16-byte chunk
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int v = ctid + it * CTHREADS;
    const int r = v / UNITS, ch = v % UNITS;
    bf16* dst = row_start<LAYOUT>(out, b, r, t0, lead, B, F_out, T_out);
    const int sh = shift_of(dst);
    const int head = (8 - sh) & 7;
    const int lo = ch == 0 ? 0 : head + 8 * (ch - 1);
    const int hi = min(ch == 0 ? head : lo + 8, n);
    cnt[it] = v < nrows * UNITS ? max(hi - lo, 0) : 0;
    at[it] = dst + lo;
    const bool zrow = LAYOUT == PADDED && (r == 0 || r == F_out + 1);
    const bf16* src = os + (LAYOUT == PADDED ? (zrow ? 0 : r - 1) : r) * OSW
                      + sh + lo;
    if (cnt[it] == 8) {                  // lo >= head: both 16-byte aligned
      val[it] = zrow ? make_uint4(0, 0, 0, 0)
                     : *reinterpret_cast<const uint4*>(src);
    } else {
      uint32_t wd[4] = {0, 0, 0, 0};
#pragma unroll
      for (int k = 0; k < 7; ++k)
        if (k < cnt[it] && !zrow)
          wd[k >> 1] |= (uint32_t)__bfloat16_as_ushort(src[k])
                        << (16 * (k & 1));
      val[it] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
  }
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    if (cnt[it] == 8) {
      *reinterpret_cast<uint4*>(at[it]) = val[it];
    } else {
      const uint32_t wd[4] = {val[it].x, val[it].y, val[it].z, val[it].w};
#pragma unroll
      for (int k = 0; k < 7; ++k)
        if (k < cnt[it])
          at[it][k] = __ushort_as_bfloat16(
              (unsigned short)(wd[k >> 1] >> (16 * (k & 1))));
    }
  }
}

// A thread's share of item w's tile: samples lane + CTHREADS u of
// [3 t0, 3 t0 + XS], zeros past L.
__device__ __forceinline__ void load_tile(bf16 (&v)[PLOADS],
                                          const bf16* __restrict__ x,
                                          long long work, int n_tiles, int L,
                                          int ctid) {
  const bf16* xb = x + (work / n_tiles) * (long long)L;
  const long long s0 = 3LL * (work % n_tiles) * TILE;
#pragma unroll
  for (int u = 0; u < PLOADS; ++u) {
    const int i = ctid + CTHREADS * u;
    v[u] = (i <= XS && s0 + i < L) ? xb[s0 + i] : __float2bfloat16(0.f);
  }
}

// ... stored into a ring slot: the tile, and the tile shifted one sample.
__device__ __forceinline__ void store_tile(bf16 (*slot)[XSP],
                                           const bf16 (&v)[PLOADS],
                                           int ctid) {
#pragma unroll
  for (int u = 0; u < PLOADS; ++u) {
    const int i = ctid + CTHREADS * u;
    if (i < XS) slot[0][i] = v[u];
    if (i >= 1 && i <= XS) slot[1][i - 1] = v[u];
  }
}

// Work item w is batch row w / n_tiles, pooled columns
// [(w % n_tiles) TILE, + TILE) (ops/frontend_variants.py:dot_work states
// the same decomposition and the wrapper passes its n_tiles and n_work).
// CTA c's k-th item is c + k gridDim.x, run by warpgroup k % CONSUMERS.
template <int LAYOUT>
__global__ void __launch_bounds__(THREADS, 1)
frontend_dot_wg_kernel(const bf16* __restrict__ x,
                       const bf16* __restrict__ bank,
                       const float* __restrict__ sc, bf16* __restrict__ out,
                       int B, int L, int F_out, int T_out, int n_tiles,
                       int n_work) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const bf16 zero = __float2bfloat16(0.f);
  const int warp = tid >> 5, lane = tid & 31;
  const int j = warp >> 2, w = warp & 3;
  const int g = lane >> 2, q = lane & 3;
  const int ctid = tid & (CTHREADS - 1);
  const auto work_of = [&](int m) {
    return blockIdx.x + (long long)(CONSUMERS * m + j) * gridDim.x;
  };

  // this warpgroup's first tile, in flight while the bank is packed
  bf16 v[PLOADS];
  if (work_of(0) < n_work) load_tile(v, x, work_of(0), n_tiles, L, ctid);

  // Bank element i is (k-step ks, n8 block nb, k half kc, column r of the
  // block, tap t of the half): filter column 8 nb + r, tap 16 ks + 8 kc +
  // t.  Column 8 n + col is the filter the accumulator layout wants there:
  // column slot c = 2 n + (col & 1) of lane-in-group col >> 1 is filter
  // 3 (6 (col >> 1) + c / 3) + c % 3.
  for (int i = tid; i < KSTEPS * B_KSTEP / 2; i += THREADS) {
    const int t = i & 7, col = (i >> 3) & 7, kc = (i >> 6) & 1;
    const int nb = (i >> 7) % NT, ks = (i >> 7) / NT;
    const int k = 16 * ks + 8 * kc + t;
    const int c = 2 * nb + (col & 1);
    const int p = 6 * (col >> 1) + c / 3;
    const int f = 3 * p + c % 3;
    sm.bank[i] = (p < F_out && k < KSIZE) ? bank[f * KSIZE + k] : zero;
  }
  if (work_of(0) < n_work) store_tile(sm.xs[j][0], v, ctid);
  // the bank's generic-proxy stores, visible to wgmma's reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const float scale = sc[0], shift = sc[1];
  // A: row slot sl of this lane is position pos of the pass; a_off[sl] is
  // the byte offset in a ring slot of the pair (x[pos + 2 q],
  // x[pos + 2 q + 1]) in the copy pos's parity picks
  uint32_t a_off[2 * ACC];
#pragma unroll
  for (int sl = 0; sl < 2 * ACC; ++sl) {
    const int pos = 48 * w + 3 * (g + 8 * (sl / 3)) + sl % 3;
    const int par = pos & 1;
    a_off[sl] = (par * XSP + pos - par + 2 * q) * 2;
  }
  const uint32_t ring = smem_u32(&sm.xs[j][0][0][0]);
  const uint32_t bank_u32 = smem_u32(sm.bank);
  bf16* os = sm.os[j];

  for (int m = 0;; ++m) {
    const long long work = work_of(m);
    if (work >= n_work) break;
    const int b = (int)(work / n_tiles);
    const int t0 = (int)(work % n_tiles) * TILE;
    const int ncols = min(TILE, T_out - t0);
    const int lead = LAYOUT == PADDED && t0 == 0;
    const uint32_t tile = ring + (m & 1) * (2 * XSP * 2);
    // the next item's tile: loads issued now, stored after pass 0 into
    // the other slot, which item m - 1 read before this item began
    const bool next = work_of(m + 1) < n_work;
    if (next) load_tile(v, x, work_of(m + 1), n_tiles, L, ctid);
    // staging offsets of this lane's six rows: segment element k of
    // stored row r (the frame's r + 1) at row * OSW + shift + k
    int row_at[6];
#pragma unroll
    for (int ii = 0; ii < 6; ++ii) {
      const int p = 6 * q + ii;
      const int r = LAYOUT == PADDED ? p + 1 : p;
      row_at[ii] = p * OSW + lead +
                   shift_of(row_start<LAYOUT>(out, b, r, t0, lead, B, F_out,
                                              T_out));
    }

#pragma unroll 1
    for (int pass = 0; pass < PASSES; ++pass) {
      float acc[ACC][NACC];
#pragma unroll
      for (int i = 0; i < ACC; ++i)
#pragma unroll
        for (int r = 0; r < NACC; ++r) acc[i][r] = 0.f;
      fence_acc(acc);
      const uint32_t pt = tile + pass * (3 * PASS_COLS) * 2;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        // a[i][0], a[i][2]: row g of accumulator i's warp slice at taps
        // 2 q and 2 q + 8 of this k-step; a[i][1], a[i][3]: row g + 8
        uint32_t a[ACC][4];
#pragma unroll
        for (int i = 0; i < ACC; ++i) {
          const uint32_t lo = pt + a_off[2 * i] + ks * 32;
          const uint32_t hi = pt + a_off[2 * i + 1] + ks * 32;
          a[i][0] = lds32(lo);
          a[i][1] = lds32(hi);
          a[i][2] = lds32(lo + 16);
          a[i][3] = lds32(hi + 16);
        }
        wgmma_fence();
        const uint64_t desc = b_desc(bank_u32 + ks * B_KSTEP);
#pragma unroll
        for (int i = 0; i < ACC; ++i) wgmma_m64n72k16(acc[i], a[i], desc);
        wgmma_commit();
        wgmma_wait<1>();
      }
      wgmma_wait<0>();
      fence_acc(acc);

      if (pass == 0) {
        if (next) store_tile(sm.xs[j][(m + 1) & 1], v, ctid);
        bar_sync(1 + j, CTHREADS);          // last item's stores have read
                                            // os
        // the frame's column 0 (element 0 of its rows' segments) and,
        // after a full item, column T + 1 (element lead + TILE): no
        // column of the pool writes them
        const bool last_full = t0 + TILE == T_out;
        if (LAYOUT == PADDED && (lead || last_full) && ctid < F_out) {
          const int at = ctid * OSW + shift_of(row_start<LAYOUT>(
                             out, b, ctid + 1, t0, lead, B, F_out, T_out));
          if (lead) os[at] = zero;
          if (last_full) os[at + lead + TILE] = zero;
        }
      }
      // element e of accumulator i's n8 tile n: row slot 2 i + (e >> 1),
      // column slot 2 n + (e & 1).  Window (u, ii): row slots 3 u ..
      // 3 u + 2 are pooled column g + 8 u of warp w's 16, column slots
      // 3 ii .. 3 ii + 2 are output row 6 q + ii.  Branch-free: every
      // window is pooled and stored, zero past the item's columns (the
      // frame's column T + 1 among them) and in rows F..23.
      const int col0 = PASS_COLS * pass + 16 * w + g;
      constexpr int WINDOWS = CUT & 1 ? 1 : 6;
      float z[6][2];
#pragma unroll
      for (int ii = 0; ii < WINDOWS; ++ii)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float mx = 0.f;
#pragma unroll
          for (int sl = 3 * u; sl < 3 * u + 3; ++sl)
#pragma unroll
            for (int c = 3 * ii; c < 3 * ii + 3; ++c)
              mx = fmaxf(mx, fabsf(acc[sl >> 1][4 * (c >> 1) +
                                                2 * (sl & 1) + (c & 1)]));
          z[ii][u] = mx * scale + shift;
        }
#pragma unroll
      for (int ii = 0; ii < WINDOWS; ++ii)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = col0 + 8 * u;
          const float y = selu(z[ii][u]);
          os[row_at[ii] + col] =
              6 * q + ii < F_out && col < ncols ? __float2bfloat16(y) : zero;
        }
    }
    // os holds the item, and the next tile is in its slot
    bar_sync(1 + j, CTHREADS);
    if (!(CUT & 2)) store_item<LAYOUT>(out, os, b, t0, B, F_out, T_out, ctid);
  }
}

template <int LAYOUT>
int launch(const void* x, const void* bank, const float* sc, void* out, int B,
           int L, int C, int n_tiles, int n_work, void* stream) {
  const int F_out = C / 3;
  const int T_out = (L - (KSIZE - 1)) / 3;
  if (B <= 0 || F_out <= 0 || F_out > ROWS || T_out <= 0)
    return (int)cudaErrorInvalidValue;
  // the caller's decomposition must be this kernel's
  if (n_tiles != (T_out + TILE - 1) / TILE ||
      (long long)n_work != (long long)n_tiles * B)
    return (int)cudaErrorInvalidValue;
  auto kernel = frontend_dot_wg_kernel<LAYOUT>;
  cudaError_t e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)sizeof(Smem))) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, sizeof(Smem))) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long blocks = (long long)sms * per_sm;
  const int grid = (int)(n_work < blocks ? n_work : blocks);
  kernel<<<grid, THREADS, sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(bank), sc,
      static_cast<bf16*>(out), B, L, F_out, T_out, n_tiles, n_work);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, L) and bank (C, 129) bf16, C / 3 <= 24; sc = {scale, shift} float32
// on the device; out (24, B, (L-128)/3) bf16; n_tiles = ceil(T / 128) and
// n_work = B n_tiles (ops/frontend_variants.py:dot_work).  Returns the
// launch's cudaError_t (0 on success).
extern "C" int aasist_frontend_dot_wg_fm(const void* x, const void* bank,
                                         const float* sc, void* out, int B,
                                         int L, int C, int n_tiles,
                                         int n_work, void* stream) {
  return launch<FM>(x, bank, sc, out, B, L, C, n_tiles, n_work, stream);
}

// As aasist_frontend_dot_wg_fm, with out (B, 24, (L-128)/3).
extern "C" int aasist_frontend_dot_wg_bm(const void* x, const void* bank,
                                         const float* sc, void* out, int B,
                                         int L, int C, int n_tiles,
                                         int n_work, void* stream) {
  return launch<BM>(x, bank, sc, out, B, L, C, n_tiles, n_work, stream);
}

// As aasist_frontend_dot_wg_fm, with out (B, 1, C/3, (L-128)/3).
extern "C" int aasist_frontend_dot_wg_plain(const void* x, const void* bank,
                                            const float* sc, void* out,
                                            int B, int L, int C, int n_tiles,
                                            int n_work, void* stream) {
  return launch<PLAIN>(x, bank, sc, out, B, L, C, n_tiles, n_work, stream);
}

// As aasist_frontend_dot_wg_fm, with out the zero-bordered
// (B, C/3 + 2, (L-128)/3 + 2) frame.
extern "C" int aasist_frontend_dot_wg_padded(const void* x, const void* bank,
                                             const float* sc, void* out,
                                             int B, int L, int C,
                                             int n_tiles, int n_work,
                                             void* stream) {
  return launch<PADDED>(x, bank, sc, out, B, L, C, n_tiles, n_work, stream);
}
