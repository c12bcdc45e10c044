// Residual block 0 of AASIST for Hopper (sm_90a), eval mode, bf16, with its
// phases overlapped:
//
//   y1  = selu(bn2(conv1(z)))      conv1 1 -> C, (2,3), pad (1,1)
//   y2  = conv2(y1)                C -> C, (2,3), pad (0,1)
//   ds  = downsample(z)            1 -> C, (1,3), pad (0,1)
//   out = max_pool (1,3) of (y2 + ds), floor semantics
//
// z is the zero-bordered bf16 frame (B, F + 2, T_z + 2) that the padded
// frontend writes (frame[b, f + 1, t + 1] = z[b, f, t]); out is
// (B, C, F, T_z / 3) bf16 stored channels last, (B, F, T_z / 3, C) in
// memory (PyTorch's channels_last).  The function is csrc/fused_block0.cu's bf16
// kernel's, to the bit: conv1 in f32 FMAs over f32 taps with bn2 and conv1's
// bias folded in, SELU in f32, y1 zero at the time halos and rounded once to
// bf16; conv2 on the tensor cores (bf16 operands, f32 sums, taps in the same
// order), the downsample in f32, both summed in f32, pooled, conv2's and the
// downsample's biases added after the max, one rounding at the store.
//
// Replaces the TPU kernel tools/fused_stack.py:_b0_kernel (launched by
// _b0_run), as csrc/fused_block0.cu does; that kernel stays, with its probe
// builds, as the version this one is measured against.
//
// What bounds it on the H100.  At B = 128, L = 64,600 (F = 23, T_z =
// 21,490) the block is ~8.1e11 FLOP, 95 % of it conv2, against ~1.5 GB of
// bf16 in and out: 0.82 ms on the tensor cores' 989 TFLOP/s, 0.44 ms for
// the bytes.  What the older kernel loses (PERF.md §5-§6, NVIDIA H100 80GB
// HBM3, 700.00 W): it runs an item's phases one after another between
// whole-CTA barriers (frame load, conv1 + SELU, conv2, store), with no load
// in flight under the work, so that its load-and-store skeleton alone takes
// 5.2x its bound; its bands of 4 output rows recompute 25 % of conv1 + SELU
// as halo and leave a quarter of the warps idle in the sixth band.
//
// What the design does about it.
// - Warp specialisation.  Eight producer warps build y1 tiles (conv1 + SELU
//   on the CUDA cores) and eight consumer warps run conv2 on mma.sync, the
//   downsample, the pool and the store, on two y1 buffers: producers fill
//   item k + 1's while consumers read item k's.  The hand-off is by named
//   barriers (FULL / EMPTY per buffer, bar.arrive on one side, bar.sync on
//   the other), never by a whole-CTA barrier.
// - Asynchronous frame loads.  A ring of four bf16 frame tiles: the
//   producers issue item k + 2's tile with cp.async while they compute
//   item k, and the consumers read item k's tile for the downsample after
//   the producers have moved on.  A frame row is 8-byte aligned or not
//   according to T_z, so each row's copy starts at the 8-byte boundary at
//   or before its first column and the readers add that row's offset (0..3
//   elements); chunks across the frame's edges are zero-filled or read
//   element by element.
// - Tall bands.  A work item is one batch row, all F = 23 output rows (24
//   y1 rows, so 4 % recomputed halo instead of 25 %) and TO = 16 pooled
//   columns (50 y1 columns for 48 positions).  The consumers take output
//   rows w, w + 8, w + 16: 23 of 24 row slots busy.
// - Whole-sector stores.  The older kernel's NCHW store writes 16-byte
//   pieces of misaligned rows (T_z / 3 is odd), and its load-and-store
//   skeleton is slow for it; with 16 pooled columns an item (needed for
//   the tall bands) a draft of this kernel with that store had a skeleton
//   several times slower than the one below.
//   Channels last, a lane holds 8 neighbouring channels of one pooled
//   column (the taps' output channels are permuted into the GEMM's N order
//   for that) and stores them as 16 bytes; a warp stores 512 contiguous
//   bytes.  cuDNN's convolutions of the next blocks take that layout as it
//   is and keep it.
// - conv2 as csrc/fused_block0.cu computes it: an implicit GEMM on
//   mma.sync m16n8k16 (M = 48 positions of one output row, N = 32 output
//   channels, K = 32 input channels x 6 taps), A fetched with ldmatrix from
//   y1 stored [row][time][channel] (pitch 40, conflict-free), B (the taps)
//   from shared memory laid out once per CTA, the accumulator rows assigned
//   so that each lane holds whole pool windows.  Whether wgmma should take
//   its place is the phase timer's question (PERF.md).
//
// Compile-time variants (preprocessor definitions, each its own library):
//
//   B0P_TIMER   thread 0 of each role adds clock64() deltas per phase into
//               registers and writes them per CTA, with the CTA's first and
//               last clock64 and %globaltimer, into the side buffer that
//               aasist_block0_pipe_timer reads (ops/block0_pipe.py:
//               phase_ms turns it into ms per phase).
//   B0P_CUT=bits  timing only, the output is meaningless: 1 the producers
//               compute no y1, 2 the consumers run no MMA loop.  3 leaves
//               the skeleton: frame loads, hand-offs, downsample, store.
//               4 the producers issue no frame tile (the ring and its
//               offsets stay the zeros set at the start), 8 the consumers
//               store nothing (the pool and the downsample still run, under
//               a bound no column is below, which the compiler cannot see
//               through).  tools/probe_b0_ablate.py's cuts (ops/
//               block0_variants.py:cut_defines): no_load 4, no_conv1 1,
//               no_mma 2, no_epi 8, only_loop 15.
//
// The block-0 probes' builds (ops/block0_variants.py states each one's
// function).  They replace the TPU kernels tools/probe_b0_constructs.py:
// _kernel (launched by its run), tools/probe_b0_ablate.py:_kernel (its
// run) and tools/probe_b0_epi.py:_kernel (its run), as
// csrc/fused_block0.cu's builds of the same names did on the older
// kernel, which stay as the builds these are timed against.  Their bound
// is block 0's (0.82 ms of tensor-core operations at B = 128; a stage's
// own, tools/_common.py:stage_bound); what they measure is what each
// construct, stage or phase costs on this kernel, whose producers and
// consumers overlap:
//
//   B0_EPI=1..4  where the producers' conv1 epilogue rounds to bf16:
//                1 (vA, the bf16epi construct) conv1's f32 sum is rounded,
//                  the shift added and SELU run on packed __nv_bfloat162
//                  pairs, every operation rounded to bf16; the consumers
//                  round the downsample to bf16 and add its bias in bf16,
//                  and add conv2's bias after the max;
//                4 (vF) as 1 with SELU's exponential and its "- 1" in f32;
//                2 (vB) f32 SELU, rounded, the halo mask applied in bf16;
//                3 (vD) f32 SELU, the halo mask applied in f32, rounded.
//                This kernel masks only the runs that cross a time edge
//                (the rest need none), so 2 and 3 move the mask there and
//                nowhere else; the older kernel multiplied every value by
//                its mask.
//   B0_RMW       conv2's partial sums leave the registers after each tap:
//                the consumers accumulate them by read-modify-write into an
//                f32 tile in shared memory and read them back for the pool.
//                The tile is a lane's 48 sums, 12 16-byte words (one
//                ld / st.shared.v4 each, where the older build moved one f32
//                word an access), 49,152 bytes over the eight consumer
//                warps, which the 12,976 bytes this kernel leaves free
//                cannot hold.  So the words lie in the y1 buffers' channel
//                padding (channels 32..39 of every y1 column, 16 bytes that
//                neither the producers' stores nor ldmatrix touch: 2,400
//                words in both buffers), and the last 672 in 10,752 bytes
//                past the small tables.  Nothing else changes: both y1
//                buffers, the frame ring and the loop order stay, and a
//                quarter warp's eight words are 80 bytes apart in the
//                padding (contiguous past it), which no two of its lanes
//                share a bank in.
//   B0_B2SLICE   the bias added after the max is read from shared memory
//                through a volatile pointer at each pooled column: the
//                default reads bs[] once a channel a row, a read the
//                compiler may keep in a register across rows.
//
//   B0_STAGE=0..4  the item's work ends after the stage (dma, fill,
//                conv1, epi, conv2 of tools/probe_b0_ablate.py:_kernel,
//                whose functions ops/block0_variants.py states) and what it
//                computed is reduced into the channels-last output tile, so
//                that nothing is dead code.  Each stage keeps this kernel's
//                roles and hand-offs and cuts what comes after it:
//                0 (dma) the producers run the cp.async frame ring and the
//                  hand-offs only; the consumers store channel 0 as one
//                  frame value a pooled column, the other channels zero;
//                1 (fill) the producers sum the 18 frame values conv1 and
//                  the downsample take for a pooled column (two rows, nine
//                  columns) into y1 buffer [row][column][0], rounded once;
//                  the consumers store it as channel 0;
//                2 (conv1) the producers run conv1's and the downsample's
//                  FMAs with their shifts and no SELU at the three times of
//                  a pooled column one to the left (unmasked), summed and
//                  rounded once into y1 buffer [row][column][channel]; the
//                  consumers store it as it is;
//                3 (epi) the producers build y1 as the whole kernel does
//                  (SELU, the halo mask, the stores into the y1 buffer); the
//                  consumers read its five terms for a pooled column (y1 at
//                  two rows and three times, the downsample with its bias
//                  rounded) and store their f32 sum;
//                4 (conv2) the whole kernel with the A fragments of the two
//                  off-split (pool phase, tap) pairs zeroed: "dense only".
//                Stages 0-2 read one pooled column to the left of the whole
//                kernel's: their frame tile starts four columns earlier
//                (ZOFF), its rows 60 elements apart instead of 56.
//
// The bf16 epilogues and the stages dma .. epi read `bias` as (3, C):
// conv2's bias plus the downsample's, the downsample's, conv2's; every
// other build reads the first row (ops/block0_variants.py passes all three
// to every probe build).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "b0_timer.cuh"

#ifndef B0_EPI
#define B0_EPI 0
#endif
#ifndef B0P_CUT
#define B0P_CUT 0
#endif
#ifndef B0_STAGE
#define B0_STAGE 5
#endif

namespace {

typedef __nv_bfloat16 bf16;

constexpr int CUT = B0P_CUT;
static_assert(CUT >= 0 && CUT < 16, "unknown cut");
constexpr int STAGE = B0_STAGE;   // 5: the whole block
static_assert(STAGE >= 0 && STAGE <= 5, "unknown stage");
constexpr int EPI = B0_EPI;       // conv1's epilogue (0: f32, rounded once)
constexpr bool BF16_EPI = EPI == 1 || EPI == 4;
static_assert(EPI >= 0 && EPI <= 4, "unknown epilogue");
#ifdef B0_RMW
constexpr bool RMW = true;
#else
constexpr bool RMW = false;
#endif
#ifdef B0_B2SLICE
constexpr bool B2SLICE = true;
#else
constexpr bool B2SLICE = false;
#endif
static_assert(STAGE == 5 || (CUT == 0 && EPI == 0 && !RMW && !B2SLICE),
              "a stage build takes no other switch");
// bias rows: sum, downsample's, conv2's
constexpr int NBIAS = (BF16_EPI || STAGE <= 3) ? 3 : 1;

constexpr int C = 32;             // block-0 channels (filts[1][1])
constexpr int TO = 16;            // pooled columns per item
constexpr int TP = 3 * TO;        // conv2 positions per item
constexpr int YW = TP + 2;        // y1 columns per item (time halo 1 + 1)
constexpr int ZOFF = STAGE < 3 ? 4 : 0;   // extra frame columns on the left
constexpr int ZW = TP + 4 + ZOFF; // frame columns per item
constexpr int RB = 23;            // output rows per band
constexpr int YR = RB + 1;        // y1 rows per band
constexpr int ZR = RB + 2;        // frame rows per band
constexpr int CIS = 40;           // bf16 pitch of a y1 column / a tap's co row
constexpr int ZP = (ZW + 6) / 4 * 4;  // bf16 pitch of a frame-tile row: ZW
                                      // + 3 alignment slack, in 8-byte
                                      // chunks (56; 60 with ZOFF)
constexpr int NCH = ZP / 4;       // 8-byte chunks per frame-tile row
constexpr int NSTAGE = 4;         // frame tiles in the ring
constexpr int RUN = 25;           // y1 columns per conv1 run
constexpr int RUNS = YW / RUN;    // runs per y1 row
constexpr int PWARPS = 8, CWARPS = 8;  // 4 + 12 and 6 + 10 time the same
constexpr int PTHREADS = 32 * PWARPS;
constexpr int THREADS = 32 * (PWARPS + CWARPS);
constexpr int MT = 3;             // m16 tiles: the 48 positions of a row
constexpr int U = 2;              // pool windows a lane holds
static_assert(YW % RUN == 0 && ZP >= ZW + 3 && ZP % 4 == 0, "tiling");
static_assert(16 * MT == TP && 2 * MT == 3 * U, "a row's pool windows");

constexpr int W2_SZ = 6 * C * CIS;          // bf16 [tap][co][ci]
constexpr int Y1_SZ = YR * YW * CIS;        // bf16 [row][col][ci], per buffer
constexpr int ZT_SZ = ZR * ZP;              // bf16 frame tile, per stage
// B0_RMW: the consumers' 16-byte words, 12 a lane; the first Y1_SLOTS in
// the y1 columns' padding, the rest in RMW_EXTRA bytes past the tables
constexpr int RMW_WORDS = 32 * CWARPS * MT * 4;
constexpr int Y1_SLOTS = 2 * YR * YW;
constexpr int RMW_EXTRA = RMW ? (RMW_WORDS - Y1_SLOTS) * 16 : 0;
static_assert(CIS - C == 8 && Y1_SLOTS % 32 == 0 && RMW_WORDS > Y1_SLOTS,
              "a warp's word j lies wholly in the padding or past it");
constexpr int TABLES = (W2_SZ + 2 * Y1_SZ + NSTAGE * ZT_SZ) * 2 +
                       NSTAGE * ZR * (int)sizeof(int) + (C * 3 + NBIAS * C) * 4;
constexpr size_t SMEM = TABLES + RMW_EXTRA;
static_assert((W2_SZ + 2 * Y1_SZ + NSTAGE * ZT_SZ) * 2 % 16 == 0 &&
              TABLES % 16 == 0, "align");
static_assert(SMEM <= 232448, "shared memory");

// Named barriers: 0 is __syncthreads.
constexpr int BAR_PRODUCERS = 1;            // the producers among themselves
constexpr int BAR_FULL = 2;                 // + buffer: y1 written
constexpr int BAR_EMPTY = 4;                // + buffer: y1 and frame read

// Timer slots (b0_timer.cuh): 0 / 1 first and last clock64, 2 / 3 first
// and last %globaltimer (ns), 4 items, then clocks summed over items:
// producers 5 waiting for an
// empty buffer, 6 issuing the next frame tile, 7 waiting for this one, 8
// conv1 + SELU; consumers 9 waiting for a full buffer, 10 conv2's MMA
// loop, 11 the downsample, pool and store.

constexpr float SELU_SCALE = 1.0507009873554805f;
constexpr float SELU_ALPHA = 1.6732632423543772f;

// SELU for values rounded to bf16 next, with no branch: both sides are
// computed and the side picked with bit operations.  A conditional SELU
// compiles to a branch around the exponential at every y1 value, which
// serialises the unrolled run (a draft of this kernel spent most of its
// time there).  The values are csrc/fused_block0.cu's
// selu_fast, bit for bit: __expf there is ex2.approx of the same product
// with a fix-up for results below 2^-126, which ex2.approx.ftz flushes to
// 0 instead; either way e - 1 rounds to -1.  For z > 0 the exponential may
// be inf, and that side is not picked.
__device__ __forceinline__ float selu_nb(float z) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(z * 1.4426950216293334961f));
  const float pos = SELU_SCALE * z;
  const float neg = (SELU_SCALE * SELU_ALPHA) * (e - 1.f);
  const unsigned m = z > 0.f ? 0xffffffffu : 0u;
  return __uint_as_float((__float_as_uint(pos) & m) |
                         (__float_as_uint(neg) & ~m));
}

// SELU on a pair of bf16 values, every operation rounded to bf16 (the _rn
// intrinsics keep the multiplies and the add from being contracted);
// F32EXP: the exponential and its "- 1" in f32, rounded once.  As
// csrc/fused_block0.cu's.
template <bool F32EXP>
__device__ __forceinline__ __nv_bfloat162 selu_bf16x2(__nv_bfloat162 y) {
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
  const __nv_bfloat162 pos = __hmax2(y, zero), neg = __hmin2(y, zero);
  __nv_bfloat162 t;
  if constexpr (F32EXP) {
    const float2 n = __bfloat1622float2(neg);
    t = __floats2bfloat162_rn(__expf(n.x) - 1.f, __expf(n.y) - 1.f);
  } else {
    t = __hsub2_rn(h2exp(neg), __float2bfloat162_rn(1.f));
  }
  return __hadd2_rn(
      __hmul2_rn(__float2bfloat162_rn(SELU_SCALE), pos),
      __hmul2_rn(__float2bfloat162_rn(SELU_SCALE * SELU_ALPHA), t));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// 8 bytes global -> shared, asynchronously; both addresses 8-byte aligned
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// B0_RMW's words: four f32 sums to / from shared memory, never held over
// in registers by the compiler
__device__ __forceinline__ void st_f4(uint32_t addr, const float* v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}

__device__ __forceinline__ void ld_f4(uint32_t addr, float* v) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "r"(addr)
               : "memory");
}

// B0_RMW: the address of the CTA's word h (the header says where it lies)
__device__ __forceinline__ uint32_t rmw_word(uint32_t y1_base,
                                             uint32_t extra_base, int h) {
  return h < Y1_SLOTS ? y1_base + (h * CIS + C) * 2
                      : extra_base + (h - Y1_SLOTS) * 16;
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Work item w (ops/block0_pipe.py:pipe_items states the same): pooled
// columns [t0, t0 + TO) of tile w % n_tiles, output rows [f0, f0 + rows)
// of band (w / n_tiles) % n_bands, batch row w / (n_tiles n_bands).
struct Item {
  long long b;
  int f0, rows, t0;
};

__device__ __forceinline__ Item item(int work, int n_tiles, int n_bands,
                                     int F) {
  const int rest = work / n_tiles;
  const int f0 = (rest % n_bands) * RB;
  return {rest / n_bands, f0, min(RB, F - f0), (work % n_tiles) * TO};
}

// Frame tile of item `it` into stage `zt` (rows f0 .. f0 + rows + 1 of the
// frame, columns 3 t0 - 1 - ZOFF .. 3 t0 + YW): row r's copy starts at the
// 8-byte boundary at or before column 3 t0 - 1 - ZOFF, that many elements
// earlier is off[r]; zeros outside the frame.  Producer threads only.
__device__ __forceinline__ void load_frame(bf16* zt, int* off,
                                           const bf16* __restrict__ z,
                                           const Item& it, int F, int T_z,
                                           int ptid) {
  if constexpr ((CUT & 4) != 0) return;   // no_load: the tiles stay zero
  const int zcols = T_z + 2, c0 = 3 * it.t0 - 1 - ZOFF;
  const bf16* zb = z + (it.b * (F + 2) + it.f0) * (long long)zcols;
  const uint32_t base = smem_u32(zt);
  for (int i = ptid; i < (it.rows + 2) * NCH; i += PTHREADS) {
    const int r = i / NCH, q = i % NCH;
    const bf16* row = zb + (long long)r * zcols;
    // element index of the row's first 8-byte boundary at or before c0
    const int mis = (int)(((reinterpret_cast<uintptr_t>(row) >> 1) +
                           (uintptr_t)(c0 + 8)) & 3);
    const int e0 = c0 - mis + 4 * q;           // first element of chunk q
    if (q == 0) off[r] = mis;
    const uint32_t dst = base + (r * ZP + 4 * q) * 2;
    if (e0 >= 0 && e0 + 4 <= zcols) {
      cp_async8(dst, row + e0);
    } else if (e0 + 4 <= 0 || e0 >= zcols) {
      *reinterpret_cast<uint2*>(zt + r * ZP + 4 * q) = make_uint2(0u, 0u);
    } else {
      bf16* d = zt + r * ZP + 4 * q;
      for (int j = 0; j < 4; ++j)
        d[j] = (e0 + j >= 0 && e0 + j < zcols) ? row[e0 + j]
                                               : __float2bfloat16(0.f);
    }
  }
}

__device__ __forceinline__ float bf(const bf16 v) {
  return __bfloat162float(v);
}

// RUN y1 columns of a thread's two channels: conv1 (taps wa / wb, shifts
// sa / sb, z0 / z1 the frame's two rows from the run's first column), SELU,
// rounded, stored at dst + j CIS.  MASK: zero at times outside 0 .. T_z - 1
// (t0: the time of the first column); a run wholly inside needs no mask.
// B0_EPI picks the epilogue (the header): the bf16 ones start the sum at 0
// and add the shift after its rounding.
template <bool MASK>
__device__ __forceinline__ void conv1_run(const float* z0, const float* z1,
                                          const float* wa, const float* wb,
                                          float sa, float sb, bf16* dst,
                                          int t0, int T_z) {
  const __nv_bfloat162 sh2 = __floats2bfloat162_rn(sa, sb);
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    float a = BF16_EPI ? 0.f : sa, b = BF16_EPI ? 0.f : sb;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      a = fmaf(wa[q], z0[j + q], fmaf(wa[3 + q], z1[j + q], a));
      b = fmaf(wb[q], z0[j + q], fmaf(wb[3 + q], z1[j + q], b));
    }
    const bool in = t0 + j >= 0 && t0 + j < T_z;
    __nv_bfloat162 y;
    if constexpr (BF16_EPI || EPI == 2) {
      if constexpr (BF16_EPI)
        y = selu_bf16x2<EPI == 4>(
            __hadd2_rn(__floats2bfloat162_rn(a, b), sh2));
      else
        y = __floats2bfloat162_rn(selu_nb(a), selu_nb(b));
      if constexpr (MASK)                // the mask in bf16
        y = __hmul2_rn(y, __float2bfloat162_rn(in ? 1.f : 0.f));
    } else {
      float ya = selu_nb(a), yb = selu_nb(b);
      if constexpr (MASK && EPI == 3) {  // the mask in f32, then rounded
        const float m = in ? 1.f : 0.f;
        ya *= m;
        yb *= m;
      } else if constexpr (MASK) {       // +0 outside the y1 extent
        const unsigned m = in ? 0xffffffffu : 0u;
        ya = __uint_as_float(__float_as_uint(ya) & m);
        yb = __uint_as_float(__float_as_uint(yb) & m);
      }
      y = __floats2bfloat162_rn(ya, yb);
    }
    *reinterpret_cast<__nv_bfloat162*>(dst + j * CIS) = y;
  }
}

// The producers' sums of stages fill (STAGE 1, channel 0) and conv1
// (STAGE 2, this thread's channels cp, cp + 1) for the item's output rows
// and pooled columns, rounded once into y1 buffer [row][column][channel].
// Frame-tile column c is frame column 3 t0 - 5 + c (ZOFF = 4): pooled
// column t0 + d's operands start at column 3 d.  The arithmetic is
// csrc/fused_block0.cu's stages', in the same order.
__device__ __forceinline__ void stage_sums(const bf16* zt, const int* off,
                                           bf16* y1, const float* wa,
                                           const float* wb, float sa,
                                           float sb, const float* wds,
                                           const float* bs, int cp,
                                           int group, int ptid, int rows) {
  if constexpr (STAGE == 1) {
    for (int i = ptid; i < rows * TO; i += PTHREADS) {
      const int row = i / TO, d = i % TO;
      const bf16* za = zt + row * ZP + off[row] + 3 * d;
      const bf16* zc = zt + (row + 1) * ZP + off[row + 1] + 3 * d;
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < 9; ++j) v += bf(za[j]) + bf(zc[j]);
      y1[(row * YW + d) * CIS] = __float2bfloat16(v);
    }
  } else if constexpr (STAGE == 2) {
    // conv1 + shift and downsample + bias at times 3 (t' - 1) + q, q =
    // 0..2, summed; the downsample's taps ride on conv1's second row
    const float da[3] = {wds[cp * 3], wds[cp * 3 + 1], wds[cp * 3 + 2]};
    const float db[3] = {wds[cp * 3 + 3], wds[cp * 3 + 4], wds[cp * 3 + 5]};
    const float a0 = 3.f * (sa + bs[C + cp]), b0 = 3.f * (sb + bs[C + cp + 1]);
    for (int i = group; i < rows * TO; i += PTHREADS / 16) {
      const int row = i / TO, d = i % TO;
      const bf16* za = zt + row * ZP + off[row] + 3 * d + 2;
      const bf16* zc = zt + (row + 1) * ZP + off[row + 1] + 3 * d + 2;
      float z0[5], z1[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        z0[k] = bf(za[k]);
        z1[k] = bf(zc[k]);
      }
      float a = a0, b = b0;
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          a = fmaf(wa[k], z0[q + k], fmaf(wa[3 + k] + da[k], z1[q + k], a));
          b = fmaf(wb[k], z0[q + k], fmaf(wb[3 + k] + db[k], z1[q + k], b));
        }
      *reinterpret_cast<__nv_bfloat162*>(y1 + (row * YW + d) * CIS + cp) =
          __floats2bfloat162_rn(a, b);
    }
  }
}

// Stages dma .. epi: the consumers' output row `row` of the item, pooled
// columns t0 + g and t0 + g + 8, channels 8 q .. 8 q + 7 of lane (g, q),
// stored channels last as the whole kernel stores (16 bytes a lane):
// dma channel 0 from the frame tile; fill and conv1 what the producers
// left in the y1 buffer; epi the five terms' f32 sum, y1 at times 3 t',
// 3 t' - 1 (row, row + 1) and 3 t' + 3 (row + 1), y1 column j being time
// 3 t0 - 1 + j, and the downsample with its bias at time 3 t', rounded to
// bf16 first, as the plain version does.
__device__ __forceinline__ void stage_row(const bf16* zt, const int* off,
                                          const bf16* y1, const float* wds,
                                          const float* bs,
                                          bf16* __restrict__ out,
                                          const Item& it, int row, int lane,
                                          int F, int T_out) {
  const int g = lane >> 2, q = lane & 3, f = it.f0 + row;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int d = g + 8 * u, t = it.t0 + d;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (STAGE == 0 || STAGE == 1) {
      if (q == 0)
        v.x = __bfloat16_as_ushort(STAGE == 0
                                       ? zt[row * ZP + off[row] + 3 * d]
                                       : y1[(row * YW + d) * CIS]);
    } else if constexpr (STAGE == 2) {
      v = *reinterpret_cast<const uint4*>(y1 + (row * YW + d) * CIS + 8 * q);
    } else {
      const bf16* y0 = y1 + (row * YW + 3 * d) * CIS + 8 * q;
      const bf16* yb = y0 + YW * CIS;
      const bf16* zr = zt + (row + 1) * ZP + off[row + 1] + 3 * d + 1;
      const float z0 = bf(zr[0]), z1 = bf(zr[1]), z2 = bf(zr[2]);
      uint4 w[4];
      w[0] = *reinterpret_cast<const uint4*>(y0 + CIS);       // row, 3 t'
      w[1] = *reinterpret_cast<const uint4*>(yb + CIS);       // row + 1, 3 t'
      w[2] = *reinterpret_cast<const uint4*>(y0);             // row, 3 t' - 1
      w[3] = *reinterpret_cast<const uint4*>(yb + 4 * CIS);   // row + 1, + 3
      const bf16* e[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) e[k] = reinterpret_cast<const bf16*>(&w[k]);
      uint32_t o[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        float s[2];
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          const int ch = 2 * h + par, co = 8 * q + ch;
          const float ds = fmaf(wds[co * 3], z0,
                                fmaf(wds[co * 3 + 1], z1,
                                     wds[co * 3 + 2] * z2)) + bs[C + co];
          s[par] = bf(e[0][ch]) + bf(e[1][ch]) + bf(e[2][ch]) +
                   bf(e[3][ch]) + bf(__float2bfloat16(ds));
        }
        const __nv_bfloat162 pr = __floats2bfloat162_rn(s[0], s[1]);
        o[h] = *reinterpret_cast<const uint32_t*>(&pr);
      }
      v = make_uint4(o[0], o[1], o[2], o[3]);
    }
    if (t < T_out)
      *reinterpret_cast<uint4*>(
          out + ((it.b * F + f) * (long long)T_out + t) * C + 8 * q) = v;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
block0_pipe_kernel(const bf16* __restrict__ z, const float* __restrict__ w1,
                   const float* __restrict__ sh1,
                   const float* __restrict__ w2, const float* __restrict__ wd,
                   const float* __restrict__ bias, bf16* __restrict__ out,
                   int F, int T_z, int T_out, int n_tiles, int n_bands,
                   int n_work) {
  extern __shared__ float4 smem4[];
  bf16* w2b = reinterpret_cast<bf16*>(smem4);
  bf16* y1b = w2b + W2_SZ;                           // two buffers
  bf16* zts = y1b + 2 * Y1_SZ;                       // NSTAGE frame tiles
  int* offs = reinterpret_cast<int*>(zts + NSTAGE * ZT_SZ);
  float* wds = reinterpret_cast<float*>(offs + NSTAGE * ZR);
  float* bs = wds + C * 3;                           // NBIAS rows
  float* rmw_extra = bs + NBIAS * C;                 // B0_RMW's last words

  const int tid = threadIdx.x;
#ifdef B0P_TIMER
  unsigned long long tm[NSLOT] = {};
  tm[0] = clk();
  tm[2] = gtimer();
  unsigned long long t_prev = tm[0];
  // the delta since the last mark, into slot s
  auto mark = [&](int s) {
    const unsigned long long t = clk();
    tm[s] += t - t_prev;
    t_prev = t;
  };
#else
  auto mark = [](int) {};
#endif
  // w2 [ci][tap][co] (f32) -> [tap][row][ci] (bf16), channel co at B row
  // 8 n + 2 q + p for co = 8 q + 2 n + p (see the consumers); ci 32..39
  // never read
  for (int i = tid; i < C * 6 * C; i += THREADS) {
    const int co = i % C, tap = (i / C) % 6, ci = i / (6 * C);
    const int row = 8 * ((co & 7) >> 1) + 2 * (co >> 3) + (co & 1);
    w2b[(tap * C + row) * CIS + ci] = __float2bfloat16(w2[i]);
  }
  for (int i = tid; i < C * 3; i += THREADS) wds[i] = wd[i];
  for (int i = tid; i < NBIAS * C; i += THREADS) bs[i] = bias[i];
  if constexpr ((CUT & 1) != 0)        // a cut phase leaves its tile unset
    for (int i = tid; i < 2 * Y1_SZ; i += THREADS)
      y1b[i] = __float2bfloat16(0.f);
  if constexpr ((CUT & 4) != 0) {      // no frame tile is ever issued
    for (int i = tid; i < NSTAGE * ZT_SZ; i += THREADS)
      zts[i] = __float2bfloat16(0.f);
    for (int i = tid; i < NSTAGE * ZR; i += THREADS) offs[i] = 0;
  }
  __syncthreads();
#ifdef B0P_TIMER
  t_prev = clk();
#endif

  if (tid >= 32 * CWARPS) {
    // ------------------------------------------------------- producers
    const int ptid = tid - 32 * CWARPS;
    const int cp = 2 * (ptid & 15);      // this thread's two channels
    const int group = ptid >> 4;         // runs group, group + 16, ...
    float wa[6], wb[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      wa[k] = w1[cp * 6 + k];
      wb[k] = w1[(cp + 1) * 6 + k];
    }
    const float sa = sh1[cp], sb = sh1[cp + 1];

    for (int k = 0; k < 2; ++k) {        // the first two items' tiles
      const int work = blockIdx.x + k * gridDim.x;
      if (work < n_work)
        load_frame(zts + k * ZT_SZ, offs + k * ZR, z,
                   item(work, n_tiles, n_bands, F), F, T_z, ptid);
      cp_async_commit();
    }
    for (int k = 0;; ++k) {
      const int work = blockIdx.x + k * gridDim.x;
      if (work >= n_work) break;
      const int s = k & 1, stage = k % NSTAGE;
      const Item it = item(work, n_tiles, n_bands, F);
      if (k >= 2) bar_sync(BAR_EMPTY + s, THREADS);   // item k - 2 read
      mark(5);
      const int next = work + 2 * gridDim.x;
      if (next < n_work)
        load_frame(zts + ((k + 2) % NSTAGE) * ZT_SZ,
                   offs + ((k + 2) % NSTAGE) * ZR, z,
                   item(next, n_tiles, n_bands, F), F, T_z, ptid);
      cp_async_commit();
      mark(6);
      cp_async_wait<2>();                // this item's tile has landed
      bar_sync(BAR_PRODUCERS, PTHREADS);
      mark(7);

      // y1 buffer s, [r][col][ci] at y1 row f0 + r, time 3 t0 - 1 + col;
      // zero outside times 0 .. T_z - 1 (stages fill and conv1: their sums
      // at [row][pooled column][ci]; dma: nothing)
      if constexpr (STAGE == 1 || STAGE == 2) {
        stage_sums(zts + stage * ZT_SZ, offs + stage * ZR, y1b + s * Y1_SZ,
                   wa, wb, sa, sb, wds, bs, cp, group, ptid, it.rows);
      } else if constexpr (STAGE >= 3 && !(CUT & 1)) {
        const bf16* zt = zts + stage * ZT_SZ;
        const int* off = offs + stage * ZR;
        bf16* y1 = y1b + s * Y1_SZ;
        for (int u = group; u < (it.rows + 1) * RUNS; u += PTHREADS / 16) {
          const int r = u / RUNS, col0 = (u % RUNS) * RUN;
          const bf16* za = zt + r * ZP + off[r] + col0;
          const bf16* zc = zt + (r + 1) * ZP + off[r + 1] + col0;
          float z0[RUN + 2], z1[RUN + 2];
#pragma unroll
          for (int j = 0; j < RUN + 2; ++j) {
            z0[j] = bf(za[j]);
            z1[j] = bf(zc[j]);
          }
          const int t_col0 = 3 * it.t0 - 1 + col0;    // y1 time of col0
          bf16* dst = y1 + (r * YW + col0) * CIS + cp;
          if (t_col0 >= 0 && t_col0 + RUN <= T_z)
            conv1_run<false>(z0, z1, wa, wb, sa, sb, dst, t_col0, T_z);
          else
            conv1_run<true>(z0, z1, wa, wb, sa, sb, dst, t_col0, T_z);
        }
      }
      bar_arrive(BAR_FULL + s, THREADS);
      mark(8);
#ifdef B0P_TIMER
      tm[4] += 1;
#endif
    }
    cp_async_wait<0>();
  } else {
    // ------------------------------------------------------- consumers
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2;
    // ldmatrix row addresses: A row lane & 15 of m tile m is position
    // a_pos[m], k half by lane >> 4; B rows are output channels, k half by
    // (lane >> 3) & 1.  An accumulator row of group g at slot s = 2 m +
    // (row >= 8) is position 3 g + 24 (s / 3) + s % 3, so slots 3 u ..
    // 3 u + 2 are pooled column g + 8 u.
    int a_pos[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int slot = 2 * m + ((lane >> 3) & 1);
      a_pos[m] = 3 * (lane & 7) + 24 * (slot / 3) + slot % 3;
    }
    const uint32_t a_base = smem_u32(y1b) + (lane >> 4) * 8 * 2;
    const uint32_t b_base =
        smem_u32(w2b) +
        ((((lane >> 4) * 8 + (lane & 7)) * CIS) + ((lane >> 3) & 1) * 8) * 2;
    // B0_RMW: word j = 4 m + n of this lane is the CTA's word h0 + 32 j
    const int h0 = warp * (MT * 4 * 32) + lane;
    const uint32_t y1_u32 = smem_u32(y1b), extra_u32 = smem_u32(rmw_extra);

    for (int k = 0;; ++k) {
      const int work = blockIdx.x + k * gridDim.x;
      if (work >= n_work) break;
      const int s = k & 1, stage = k % NSTAGE;
      const Item it = item(work, n_tiles, n_bands, F);
      bar_sync(BAR_FULL + s, THREADS);
      mark(9);
      const bf16* zt = zts + stage * ZT_SZ;
      const int* off = offs + stage * ZR;
      const uint32_t a_buf = a_base + s * Y1_SZ * 2;

      for (int row = warp; row < it.rows; row += CWARPS) {
        if constexpr (STAGE <= 3) {
          stage_row(zt, off, y1b + s * Y1_SZ, wds, bs, out, it, row, lane, F,
                    T_out);
          continue;
        }
        float acc[MT][4][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

        if constexpr (!(CUT & 2)) {
#pragma unroll
          for (int tap = 0; tap < 6; ++tap) {
            const int df = tap / 3, dt = tap % 3;
#pragma unroll
            for (int kh = 0; kh < 2; ++kh) {
              uint32_t b[4][2];
              const uint32_t ba = b_base + (tap * C * CIS + kh * 16) * 2;
              ldmatrix_x4(ba, b[0][0], b[0][1], b[1][0], b[1][1]);
              ldmatrix_x4(ba + 16 * CIS * 2, b[2][0], b[2][1], b[3][0],
                          b[3][1]);
#pragma unroll
              for (int m = 0; m < MT; ++m) {
                // A[p][ci] = y1[row + df][time col p + dt][kh * 16 + ci]
                uint32_t a[4];
                ldmatrix_x4(a_buf + (((row + df) * YW + a_pos[m] + dt) * CIS +
                                     kh * 16) * 2,
                            a[0], a[1], a[2], a[3]);
                if constexpr (STAGE == 4) {
                  // dense only: a[0], a[2] are slot 2 m, a[1], a[3] slot
                  // 2 m + 1, a slot's pool phase is slot % 3; phase 0
                  // lacks the tap dt = 0 and phase 2 the tap dt = 2
#pragma unroll
                  for (int hh = 0; hh < 2; ++hh)
                    if (dt != 1 && (2 * m + hh) % 3 == dt)
                      a[hh] = a[hh + 2] = 0u;
                }
#pragma unroll
                for (int n = 0; n < 4; ++n) mma_bf16(acc[m][n], a, b[n]);
              }
            }
            if constexpr (RMW) {         // this tap's partial sums
#pragma unroll
              for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int n = 0; n < 4; ++n) {
                  const uint32_t w =
                      rmw_word(y1_u32, extra_u32, h0 + 32 * (4 * m + n));
                  if (tap > 0) {
                    float t[4];
                    ld_f4(w, t);
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[m][n][e] += t[e];
                  }
                  st_f4(w, acc[m][n]);
#pragma unroll
                  for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
                }
            }
          }
          if constexpr (RMW) {           // read back for the pool
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
              for (int n = 0; n < 4; ++n)
                ld_f4(rmw_word(y1_u32, extra_u32, h0 + 32 * (4 * m + n)),
                      acc[m][n]);
          }
        }
        mark(10);

        // element e of tile (m, n): B column 2 q + (e & 1) of lane q =
        // lane % 4, which holds channel 8 q + 2 n + (e & 1), at slot
        // 2 m + (e >> 1); the downsample reads z row f (frame row f + 1,
        // tile row row + 1) at times 3 (t0 + t') - 1 + k for its pooled
        // columns t' = g + 8 u
        const int f = it.f0 + row, q = lane & 3;
        const bf16* zr = zt + (row + 1) * ZP + off[row + 1] + 3 * g + 1;
        float zz[U][5];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int j = 0; j < 5; ++j) zz[u][j] = bf(zr[24 * u + j]);
        uint32_t ov[U][4];     // channels 8 q + 2 n, + 1 of column g + 8 u
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          float o[U][2];
#pragma unroll
          for (int par = 0; par < 2; ++par) {
            const int co = 8 * q + 2 * n + par;
            const float d0 = wds[co * 3], d1 = wds[co * 3 + 1],
                        d2 = wds[co * 3 + 2];
            // the bias added after the max: the sum, or conv2's for the
            // bf16 epilogues, which add the downsample's (dsb) in bf16
            const int bo_at = (BF16_EPI ? 2 * C : 0) + co;
            float bo = 0.f, dsb = 0.f;
            if constexpr (!B2SLICE) bo = bs[bo_at];
            if constexpr (BF16_EPI) dsb = bs[C + co];
#pragma unroll
            for (int u = 0; u < U; ++u) {
              float v[3];
#pragma unroll
              for (int j = 0; j < 3; ++j) {
                const int slot = 3 * u + j;
                float ds = fmaf(d0, zz[u][j],
                                fmaf(d1, zz[u][j + 1], d2 * zz[u][j + 2]));
                if constexpr (BF16_EPI)
                  ds = __bfloat162float(__hadd_rn(__float2bfloat16(ds),
                                                  __float2bfloat16(dsb)));
                v[j] = acc[slot / 2][n][2 * (slot % 2) + par] + ds;
              }
              if constexpr (B2SLICE)
                bo = static_cast<const volatile float*>(bs)[bo_at];
              o[u][par] = fmaxf(fmaxf(v[0], v[1]), v[2]) + bo;
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const __nv_bfloat162 pr = __floats2bfloat162_rn(o[u][0], o[u][1]);
            ov[u][n] = *reinterpret_cast<const uint32_t*>(&pr);
          }
        }
        // out[b, f, t, co] (channels last): 16 contiguous bytes a lane, 512
        // a warp's store
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int t = it.t0 + g + 8 * u;
          if (t < ((CUT & 8) ? 0 : T_out))    // no_epi: a bound none is under
            *reinterpret_cast<uint4*>(
                out + ((it.b * F + f) * (long long)T_out + t) * C + 8 * q) =
                make_uint4(ov[u][0], ov[u][1], ov[u][2], ov[u][3]);
        }
        mark(11);
      }
      if (work + 2 * gridDim.x < n_work)   // the producers wait for it
        bar_arrive(BAR_EMPTY + s, THREADS);
      mark(11);
#ifdef B0P_TIMER
      tm[4] += 1;
#endif
    }
  }

#ifdef B0P_TIMER
  // thread 0 (consumer warp 0) and the first producer thread share the
  // CTA's words: each writes its own slots
  if (tid == 0 || tid == 32 * CWARPS) {
    unsigned long long* t = timer_words();
    if (tid == 0) {
      t[0] = tm[0];
      t[1] = clk();
      t[2] = tm[2];
      t[3] = gtimer();
      t[4] = tm[4];
      for (int i = 9; i < NSLOT; ++i) t[i] = tm[i];
    } else {
      for (int i = 5; i < 9; ++i) t[i] = tm[i];
    }
  }
#endif
}

}  // namespace

// z (B, F + 2, T_z + 2) bf16, zero-bordered, contiguous; out (B, F,
// T_z / 3, channels) bf16 in memory, 16-byte aligned (a channels_last
// (B, channels, F, T_z / 3) tensor).  Float32 on the device: w1 (C, 6) conv1 taps [df*3+dt]
// times the bn2 scale, sh1 (C) the folded shift, w2 (C, 6, C) conv2 taps
// [ci][df*3+dt][co], wd (C, 3) downsample taps, bias (C) conv2 bias +
// downsample bias (ops/fused_stack.py:fold_block0), or (3, C) in the
// bf16 epilogues' and the stages' builds (the header).  channels must be 32;
// n_tiles = ceil(T_out / 16), n_bands = ceil(F / 23), n_work = B n_bands
// n_tiles (ops/block0_pipe.py:pipe_work).  Returns the launch's cudaError_t
// (0 on success).
extern "C" int aasist_block0_pipe(const void* z, const float* w1,
                                  const float* sh1, const float* w2,
                                  const float* wd, const float* bias,
                                  void* out, int B, int F, int T_z,
                                  int channels, int n_tiles, int n_bands,
                                  int n_work, void* stream) {
  const int T_out = T_z / 3;
  if (channels != C || B <= 0 || F <= 0 || T_out <= 0 ||
      n_tiles != (T_out + TO - 1) / TO || n_bands != (F + RB - 1) / RB ||
      (long long)n_work != (long long)n_tiles * n_bands * B)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      block0_pipe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, block0_pipe_kernel, THREADS, SMEM)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long blocks = (long long)sms * per_sm;
  const int grid = (int)(n_work < blocks ? n_work : blocks);
#ifdef B0P_TIMER
  if ((e = timer_arm(grid)) != cudaSuccess) return (int)e;
#endif
  block0_pipe_kernel<<<grid, THREADS, SMEM,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(z), w1, sh1, w2, wd, bias,
      static_cast<bf16*>(out), F, T_z, T_out, n_tiles, n_bands, n_work);
  return (int)cudaGetLastError();
}

// The timer builds' side buffer of the last launch (b0_timer.cuh:
// timer_read).
extern "C" int aasist_block0_pipe_timer(void* dst, int* ctas, void* stream) {
  return timer_read(dst, ctas, stream);
}
