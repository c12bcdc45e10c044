// Residual block 0 of AASIST in float32 for Hopper (sm_90a), eval mode,
// with conv2 on the tensor cores at f32 accuracy (3xTF32) and its phases
// overlapped:
//
//   y1  = selu(bn2(conv1(z)))      conv1 1 -> C, (2,3), pad (1,1)
//   y2  = conv2(y1)                C -> C, (2,3), pad (0,1)
//   ds  = downsample(z)            1 -> C, (1,3), pad (0,1)
//   out = max_pool (1,3) of (y2 + ds), floor semantics
//
// z is the zero-bordered float32 frame (B, F + 2, T_z + 2) that the padded
// frontend writes (frame[b, f + 1, t + 1] = z[b, f, t]); out is
// (B, C, F, T_z / 3) float32, contiguous.  The function, halos, folding and
// store are those of csrc/fused_block0.cu's f32 kernel (block0_fma_kernel),
// which it replaces on the f32 path and which stays as the version it is
// measured against: conv1 in f32 FMAs over f32 taps with bn2 and conv1's
// bias folded in, SELU in f32, y1 zero at the time halos; conv2 and the
// downsample summed in f32, pooled, conv2's and the downsample's biases
// added after the max.
//
// Replaces the TPU kernel tools/fused_stack.py:_b0_kernel (launched by
// _b0_run) in float32.
//
// What bounds it on the H100.  At B = 128, L = 64,600 (F = 23, T_z =
// 21,490) the block is ~8.15e11 FLOP, 95 % of it conv2, against ~2.9 GB of
// f32 in and out (0.88 ms at 3.35 TB/s).  On the CUDA cores (67 TFLOP/s)
// that is 12.16 ms, and block0_fma_kernel takes about twice that.  The
// 3xTF32 split (below) costs three TF32 products a product, 3 * 8.15e11
// FLOP at 494.5 TFLOP/s: a floor of 4.94 ms.
//
// What the design does about it.
// - conv2 on mma.sync m16n8k8 .tf32 with the 3xTF32 split (CUTLASS's
//   OpMultiplyAddFastF32): each operand x is split into hi = tf32(x) and
//   lo = tf32(x - hi), rounded to nearest with ties away (cvt.rna's
//   rounding), and each product summed as lo*hi + hi*lo + hi*hi in f32
//   (lo*lo dropped, 2^-22 relative); the small terms of a k-step go into
//   the accumulator first.  The taps are split once per CTA into (hi, lo)
//   pairs in shared memory, [tap][co][ci] at a pitch of 36 pairs (one
//   64-bit load gives both halves, a warp's loads fall in distinct banks);
//   y1 is stored in f32 and each A value split in registers after its
//   load.  The implicit GEMM is csrc/block0_pipe.cu's: M = 48 positions of
//   one output row, N = 32 output channels, K = 32 input channels x 6
//   taps (24 k-steps of 8), the accumulator rows assigned so that each
//   lane holds whole pool windows (m16n8k8's accumulator layout is
//   m16n8k16's), so that the downsample, the pool and the store run on
//   registers.
// - Warp specialisation, as csrc/block0_pipe.cu: four producer warps build
//   y1 tiles (conv1 + SELU on the CUDA cores, f32) and eight consumer warps
//   run conv2, the downsample, the pool and the store, on two y1 buffers
//   handed over by named barriers (eight producer warps, as block0_pipe
//   has, and two were slower on the card: eight take instruction slots
//   from the consumers, two cannot keep up with them); frame tiles come in
//   a ring of four, loaded two items ahead with cp.async (16-byte chunks
//   from the 16-byte boundary at or before each row's first column; the
//   readers add the row's offset).
// - The band.  In f32, block0_pipe's all-rows band (24 y1 rows x 50 columns
//   x 40, two buffers) would take 2 x 192 KB.  A work item here is one batch
//   row, RB = 8 output rows (9 y1 rows, 10 frame rows) and TO = 16 pooled
//   columns (50 y1 columns for 48 positions): two y1 buffers of 9 x 50 x 36
//   floats (63.3 KB each), the split taps (54 KB) and the frame ring
//   (8.75 KB) take 190 KB of the 227 KB.  F = 23 makes three bands (8, 8,
//   7 rows): the halo costs 26 y1 rows for 23 output rows, where
//   block0_pipe's one band computes 24 (8 % more conv1 + SELU; the frame
//   rows read are 30 for 25, 20 % more, from L2), and 23 of 24 consumer
//   row slots are busy.  Each consumer warp takes one output row of an
//   item.
// - The store is NCHW, as block0_fma_kernel's: a lane holds two channels
//   of two pooled columns per n8 tile, so each warp store writes 32
//   contiguous bytes of four channels' rows.
//
// Halos.  conv2 zero-pads y1 in time, so y1 columns at t = -1 and t >= T_z
// are stored as zero, not selu(shift): the folded shift makes selu of an
// all-zero input nonzero.  y1 has F + 1 rows (conv1's freq padding), all
// real; the downsample reads rows 0..F-1 of z only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 32;             // block-0 channels (filts[1][1])
constexpr int TO = 16;            // pooled columns per item
constexpr int TP = 3 * TO;        // conv2 positions per item
constexpr int YW = TP + 2;        // y1 columns per item (time halo 1 + 1)
constexpr int ZW = TP + 4;        // frame columns per item
constexpr int RB = 8;             // output rows per band
constexpr int YR = RB + 1;        // y1 rows per band
constexpr int ZR = RB + 2;        // frame rows per band
constexpr int YP = 36;            // f32 pitch of a y1 column
constexpr int WP = 36;            // (hi, lo) pitch of a tap's co row
constexpr int ZP = 56;            // f32 pitch of a frame-tile row: ZW + 3
                                  // alignment slack, in 16-byte chunks
constexpr int NCH = ZP / 4;       // 16-byte chunks per frame-tile row
constexpr int NSTAGE = 4;         // frame tiles in the ring
constexpr int RUN = 10;           // y1 columns per conv1 run
constexpr int RUNS = YW / RUN;    // runs per y1 row
constexpr int PWARPS = 4, CWARPS = 8;
constexpr int PTHREADS = 32 * PWARPS;
constexpr int THREADS = 32 * (PWARPS + CWARPS);
constexpr int MT = 3;             // m16 tiles: the 48 positions of a row
constexpr int NT = C / 8;         // n8 tiles: the 32 output channels
constexpr int U = 2;              // pool windows a lane holds
static_assert(YW % RUN == 0 && ZP >= ZW + 3 && ZP % 4 == 0, "tiling");
static_assert(16 * MT == TP && 2 * MT == 3 * U, "a row's pool windows");
static_assert(CWARPS == RB, "a consumer warp per output row");
static_assert(YP % 32 == 4 && WP % 32 == 4, "conflict-free fragment loads");

constexpr int W2_SZ = 6 * C * WP;           // float2 [tap][co][ci]
constexpr int Y1_SZ = YR * YW * YP;         // f32 [row][col][ci], a buffer
constexpr int ZT_SZ = ZR * ZP;              // f32 frame tile, a stage
constexpr size_t SMEM = W2_SZ * sizeof(float2) +
                        (2 * Y1_SZ + NSTAGE * ZT_SZ) * sizeof(float) +
                        NSTAGE * ZR * sizeof(int) + (C * 3 + C) * 4;
static_assert((W2_SZ * sizeof(float2) + 2 * Y1_SZ * sizeof(float)) % 16 ==
                  0, "align");

// Named barriers: 0 is __syncthreads.
constexpr int BAR_PRODUCERS = 1;            // the producers among themselves
constexpr int BAR_FULL = 2;                 // + buffer: y1 written
constexpr int BAR_EMPTY = 4;                // + buffer: y1 and frame read

constexpr float SELU_SCALE = 1.0507009873554805f;
constexpr float SELU_ALPHA = 1.6732632423543772f;

// SELU in f32 with no branch: both sides computed, the side picked by a
// select.  The exponential is ex2.approx of z log2(e) (relative error
// ~2^-22, flushed to 0 below 2^-126), so exp(z) - 1 is within ~1e-7 of
// expm1(z): an f32 ulp of y1 at its scale, far below the f32 gate.  For
// z > 0 the exponential may be inf, and that side is not picked.
__device__ __forceinline__ float selu(float z) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(z * 1.4426950408889634f));
  const float neg = (SELU_SCALE * SELU_ALPHA) * (e - 1.f);
  return z > 0.f ? SELU_SCALE * z : neg;
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: cvt.rna.tf32.f32's rounding, with the low 13 bits cleared
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// (hi, lo) of the 3xTF32 split as floats: hi + lo is x to ~2^-22
__device__ __forceinline__ float2 split(float x) {
  const float hi = __uint_as_float(tf32_bits(x));
  return make_float2(hi, __uint_as_float(tf32_bits(x - hi)));
}

// d += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

// 16 bytes global -> shared, asynchronously; both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
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

// Work item w (ops/block0_f32.py:f32_items states the same): pooled
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
// frame, columns 3 t0 - 1 .. 3 t0 + YW): row r's copy starts at the 16-byte
// boundary at or before column 3 t0 - 1, that many elements earlier is
// off[r]; zeros outside the frame.  Producer threads only.
__device__ __forceinline__ void load_frame(float* zt, int* off,
                                           const float* __restrict__ z,
                                           const Item& it, int F, int T_z,
                                           int ptid) {
  const int zcols = T_z + 2, c0 = 3 * it.t0 - 1;
  const float* zb = z + (it.b * (F + 2) + it.f0) * (long long)zcols;
  const uint32_t base = smem_u32(zt);
  for (int i = ptid; i < (it.rows + 2) * NCH; i += PTHREADS) {
    const int r = i / NCH, q = i % NCH;
    const float* row = zb + (long long)r * zcols;
    // element index of the row's first 16-byte boundary at or before c0
    const int mis = (int)(((reinterpret_cast<uintptr_t>(row) >> 2) +
                           (uintptr_t)(c0 + 4)) & 3);
    const int e0 = c0 - mis + 4 * q;           // first element of chunk q
    if (q == 0) off[r] = mis;
    const uint32_t dst = base + (r * ZP + 4 * q) * 4;
    if (e0 >= 0 && e0 + 4 <= zcols) {
      cp_async16(dst, row + e0);
    } else if (e0 + 4 <= 0 || e0 >= zcols) {
      *reinterpret_cast<float4*>(zt + r * ZP + 4 * q) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      float* d = zt + r * ZP + 4 * q;
      for (int j = 0; j < 4; ++j)
        d[j] = (e0 + j >= 0 && e0 + j < zcols) ? row[e0 + j] : 0.f;
    }
  }
}

// RUN y1 columns of a thread's two channels: conv1 (taps wa / wb, shifts
// sa / sb, z0 / z1 the frame's two rows from the run's first column), SELU,
// stored at dst + j YP.  MASK: zero at times outside 0 .. T_z - 1 (t0: the
// time of the first column); a run wholly inside needs no mask.
template <bool MASK>
__device__ __forceinline__ void conv1_run(const float* z0, const float* z1,
                                          const float* wa, const float* wb,
                                          float sa, float sb, float* dst,
                                          int t0, int T_z) {
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    float a = sa, b = sb;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      a = fmaf(wa[q], z0[j + q], a);
      b = fmaf(wb[q], z0[j + q], b);
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      a = fmaf(wa[3 + q], z1[j + q], a);
      b = fmaf(wb[3 + q], z1[j + q], b);
    }
    float ya = selu(a), yb = selu(b);
    if constexpr (MASK) {                // +0 outside the y1 extent
      const bool in = t0 + j >= 0 && t0 + j < T_z;
      ya = in ? ya : 0.f;
      yb = in ? yb : 0.f;
    }
    *reinterpret_cast<float2*>(dst + j * YP) = make_float2(ya, yb);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
block0_f32_kernel(const float* __restrict__ z, const float* __restrict__ w1,
                  const float* __restrict__ sh1,
                  const float* __restrict__ w2, const float* __restrict__ wd,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int F, int T_z, int T_out, int n_tiles, int n_bands,
                  int n_work) {
  extern __shared__ float4 smem4[];
  float2* w2s = reinterpret_cast<float2*>(smem4);
  float* y1b = reinterpret_cast<float*>(w2s + W2_SZ);   // two buffers
  float* zts = y1b + 2 * Y1_SZ;                         // NSTAGE tiles
  int* offs = reinterpret_cast<int*>(zts + NSTAGE * ZT_SZ);
  float* wds = reinterpret_cast<float*>(offs + NSTAGE * ZR);
  float* bs = wds + C * 3;

  const int tid = threadIdx.x;
  // w2 [ci][tap][co] -> (hi, lo) at [tap][co][ci]; ci 32..35 never read
  for (int i = tid; i < C * 6 * C; i += THREADS) {
    const int co = i % C, tap = (i / C) % 6, ci = i / (6 * C);
    w2s[(tap * C + co) * WP + ci] = split(w2[i]);
  }
  for (int i = tid; i < C * 3; i += THREADS) wds[i] = wd[i];
  for (int i = tid; i < C; i += THREADS) bs[i] = bias[i];
  __syncthreads();

  if (tid >= 32 * CWARPS) {
    // ------------------------------------------------------- producers
    const int ptid = tid - 32 * CWARPS;
    const int cp = 2 * (ptid & 15);      // this thread's two channels
    const int group = ptid >> 4;         // runs group, group + 8, ...
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
      const int next = work + 2 * gridDim.x;
      if (next < n_work)
        load_frame(zts + ((k + 2) % NSTAGE) * ZT_SZ,
                   offs + ((k + 2) % NSTAGE) * ZR, z,
                   item(next, n_tiles, n_bands, F), F, T_z, ptid);
      cp_async_commit();
      cp_async_wait<2>();                // this item's tile has landed
      bar_sync(BAR_PRODUCERS, PTHREADS);

      // y1 buffer s, [r][col][ci] at y1 row f0 + r, time 3 t0 - 1 + col;
      // zero outside times 0 .. T_z - 1
      const float* zt = zts + stage * ZT_SZ;
      const int* off = offs + stage * ZR;
      float* y1 = y1b + s * Y1_SZ;
      for (int u = group; u < (it.rows + 1) * RUNS; u += PTHREADS / 16) {
        const int r = u / RUNS, col0 = (u % RUNS) * RUN;
        const float* za = zt + r * ZP + off[r] + col0;
        const float* zc = zt + (r + 1) * ZP + off[r + 1] + col0;
        float z0[RUN + 2], z1[RUN + 2];
#pragma unroll
        for (int j = 0; j < RUN + 2; ++j) {
          z0[j] = za[j];
          z1[j] = zc[j];
        }
        const int t_col0 = 3 * it.t0 - 1 + col0;    // y1 time of col0
        float* dst = y1 + (r * YW + col0) * YP + cp;
        if (t_col0 >= 0 && t_col0 + RUN <= T_z)
          conv1_run<false>(z0, z1, wa, wb, sa, sb, dst, t_col0, T_z);
        else
          conv1_run<true>(z0, z1, wa, wb, sa, sb, dst, t_col0, T_z);
      }
      bar_arrive(BAR_FULL + s, THREADS);
    }
    cp_async_wait<0>();
  } else {
    // ------------------------------------------------------- consumers
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, q = lane & 3;
    // A: row slot s of this lane (s = 2 m + (row >= 8)) is position
    // 3 g + 24 (s / 3) + s % 3, so slots 3 u .. 3 u + 2 are pooled column
    // g + 8 u; a_off[s] is its y1 column's offset plus the lane's channel q
    int a_off[2 * MT];
#pragma unroll
    for (int s = 0; s < 2 * MT; ++s)
      a_off[s] = (3 * g + 24 * (s / 3) + s % 3) * YP + q;
    // B: n8 tile n's column g is output channel 8 n + g, at input channels
    // q and q + 4 of a k-step
    const float2* b_base = w2s + g * WP + q;

    for (int k = 0;; ++k) {
      const int work = blockIdx.x + k * gridDim.x;
      if (work >= n_work) break;
      const int s = k & 1, stage = k % NSTAGE;
      const Item it = item(work, n_tiles, n_bands, F);
      bar_sync(BAR_FULL + s, THREADS);
      const float* zt = zts + stage * ZT_SZ;
      const int* off = offs + stage * ZR;
      const float* y1 = y1b + s * Y1_SZ;

      for (int row = warp; row < it.rows; row += CWARPS) {
        float acc[MT][NT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

#pragma unroll 1
        for (int tap = 0; tap < 6; ++tap) {
          const int df = tap / 3, dt = tap % 3;
          // A[p][ci] = y1[row + df][column p + dt][ci]
          const float* ya = y1 + ((row + df) * YW + dt) * YP;
#pragma unroll
          for (int kb = 0; kb < C / 8; ++kb) {
            uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              const float2* bp = b_base + (tap * C + 8 * n) * WP + 8 * kb;
              const float2 v0 = bp[0], v1 = bp[4];
              bh[n][0] = __float_as_uint(v0.x);
              bl[n][0] = __float_as_uint(v0.y);
              bh[n][1] = __float_as_uint(v1.x);
              bl[n][1] = __float_as_uint(v1.y);
            }
            // the three m16 tiles' A values, split: the 12 accumulators
            // then take each term in turn, so that an MMA waits on the one
            // 12 before it
            uint32_t ah[MT][4], al[MT][4];
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const float* row_g = ya + a_off[2 * m] + 8 * kb;
              const float* row_g8 = ya + a_off[2 * m + 1] + 8 * kb;
              const float av[4] = {row_g[0], row_g8[0], row_g[4],
                                   row_g8[4]};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 hl = split(av[e]);
                ah[m][e] = __float_as_uint(hl.x);
                al[m][e] = __float_as_uint(hl.y);
              }
            }
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
              for (int n = 0; n < NT; ++n) mma_tf32(acc[m][n], al[m], bh[n]);
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
              for (int n = 0; n < NT; ++n) mma_tf32(acc[m][n], ah[m], bl[n]);
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
              for (int n = 0; n < NT; ++n) mma_tf32(acc[m][n], ah[m], bh[n]);
          }
        }

        // element e of tile (m, n): channel 8 n + 2 q + (e & 1) at slot
        // 2 m + (e >> 1); the downsample reads z row f (frame row f + 1,
        // tile row row + 1) at times 3 (t0 + t') - 1 + k for its pooled
        // columns t' = g + 8 u
        const int f = it.f0 + row;
        const float* zr = zt + (row + 1) * ZP + off[row + 1] + 3 * g + 1;
        float zz[U][5];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int j = 0; j < 5; ++j) zz[u][j] = zr[24 * u + j];
        float* ob = out + ((it.b * C) * F + f) * (long long)T_out + it.t0 + g;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int par = 0; par < 2; ++par) {
            const int co = 8 * n + 2 * q + par;
            const float d0 = wds[co * 3], d1 = wds[co * 3 + 1],
                        d2 = wds[co * 3 + 2];
            const float bo = bs[co];
#pragma unroll
            for (int u = 0; u < U; ++u) {
              float v[3];
#pragma unroll
              for (int j = 0; j < 3; ++j) {
                const int slot = 3 * u + j;
                v[j] = acc[slot / 2][n][2 * (slot % 2) + par] +
                       fmaf(d0, zz[u][j],
                            fmaf(d1, zz[u][j + 1], d2 * zz[u][j + 2]));
              }
              if (it.t0 + g + 8 * u < T_out)
                ob[(long long)co * F * T_out + 8 * u] =
                    fmaxf(fmaxf(v[0], v[1]), v[2]) + bo;
            }
          }
      }
      if (work + 2 * gridDim.x < n_work)   // the producers wait for it
        bar_arrive(BAR_EMPTY + s, THREADS);
    }
  }
}

}  // namespace

// z (B, F + 2, T_z + 2) float32, zero-bordered, contiguous; out (B,
// channels, F, T_z / 3) float32, contiguous.  Float32 on the device: w1
// (C, 6) conv1 taps [df*3+dt] times the bn2 scale, sh1 (C) the folded
// shift, w2 (C, 6, C) conv2 taps [ci][df*3+dt][co], wd (C, 3) downsample
// taps, bias (C) conv2 bias + downsample bias (ops/fused_stack.py:
// fold_block0).  channels must be 32; n_tiles = ceil(T_out / 16), n_bands
// = ceil(F / 8), n_work = B n_bands n_tiles (ops/block0_f32.py:f32_work).
// Returns the launch's cudaError_t (0 on success).
extern "C" int aasist_block0_f32(const void* z, const float* w1,
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
      block0_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, block0_f32_kernel, THREADS, SMEM)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long blocks = (long long)sms * per_sm;
  const int grid = (int)(n_work < blocks ? n_work : blocks);
  block0_f32_kernel<<<grid, THREADS, SMEM,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), w1, sh1, w2, wd, bias,
      static_cast<float*>(out), F, T_z, T_out, n_tiles, n_bands, n_work);
  return (int)cudaGetLastError();
}
