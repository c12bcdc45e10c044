// Fused first residual block of AASIST for Hopper (sm_90a), eval mode:
//
//   y1  = selu(bn2(conv1(z)))      conv1 1 -> C, (2,3), pad (1,1)
//   y2  = conv2(y1)                C -> C, (2,3), pad (0,1)
//   ds  = downsample(z)            1 -> C, (1,3), pad (0,1)
//   out = max_pool (1,3) of (y2 + ds), floor semantics
//
// z is the zero-bordered frame (B, F + 2, T_z + 2) that csrc/fused_frontend.cu
// writes (aasist_fused_frontend_padded): frame[b, f + 1, t + 1] = z[b, f, t],
// so conv1's paddings are the frame's border.  out is (B, C, F, T_z / 3) in
// the frame's type (float or bf16); sums are f32, rounded once at the store
// (the bf16 kernel also rounds y1 to bf16, as the plain bf16 chain does).
// bn2 and conv1's bias are folded into conv1's taps and one shift per
// channel; conv2's and the downsample's biases are constant across the pool
// window and are added once after the max.
//
// Replaces the TPU kernel tools/fused_stack.py:_b0_kernel (launched by
// _b0_run).  That kernel reads mod-3 phase planes and packs the taps into
// K=18 and off-split dots because Mosaic has no stride-3 lane access; none
// of that is needed here: the pool reads three neighbouring values.
//
// What bounds it on the H100.  At B = 128, L = 64,600 (F = 23, T_z =
// 21,490) the block is ~8.1e11 FLOP, 95 % of it conv2, against ~1.5 GB of
// bf16 in and out: compute-bound.  ~0.82 ms on the bf16 tensor cores, ~12 ms
// on the f32 CUDA cores (67 TFLOP/s).
//
// What the design does about it.  Nothing but the frame and the pooled
// output touches device memory: the conv1, conv2 and downsample
// activations (each ~4 GB in bf16 at batch 128) live in shared memory and
// registers.  Persistent blocks keep the C x 6 x C conv2 taps in shared
// memory for their whole life and walk over work items of one batch row, a
// band of R output rows and TO pooled columns.  Per item a block loads the
// frame tile, builds the (R + 1)-row y1 tile in shared memory (conv1 on the
// CUDA cores), then runs conv2:
//
// - bf16 (block0_tc_kernel, two blocks per SM): conv2 on the tensor cores
//   as an implicit GEMM with mma.sync m16n8k16 (M = positions, N = 32
//   output channels, K = 32 input channels x 6 taps), operands fetched with
//   ldmatrix from y1 stored [row][time][channel] and the taps stored
//   [tap][co][ci].  The GEMM's rows are assigned so that each lane's f32
//   accumulators hold whole pool windows: the pool, the downsample and the
//   store run on registers.  conv1 walks runs of y1 columns with a sliding
//   window of z, two channels per thread.
// - f32 (block0_fma_kernel): conv2 on the CUDA cores in full f32, whose
//   floor is the f32 one.  Each thread holds 16 output channels x 6
//   positions (two pooled columns) of accumulators: per (input channel,
//   freq tap) it loads 8 y1 values (4 x 64-bit, conflict-free at a lane
//   stride of 6 words) and 48 taps (12 x 128-bit warp broadcasts) for 288
//   FMAs, so shared memory stays off the critical path.
//
// Where the bf16 kernel's time goes (ablation on an H100 at B = 128): the
// conv1 stage, issue-bound at ~34 instructions per y1 value, then the
// tensor-core phase; the phases of an item run one after another between
// barriers.  Overlapping them (producer warps building the next y1 tile)
// and conv1 on the tensor cores are the next steps.
//
// Halos.  conv2 zero-pads y1 in time, so y1 columns at t = -1 and t >= T_z
// are stored as zero, not selu(shift): the folded shift makes selu of an
// all-zero input nonzero.  y1 has F + 1 rows (conv1's freq padding), all
// real; the downsample reads rows 0..F-1 of z only.
//
// Compile-time variants of the bf16 kernel (preprocessor definitions; a
// build with none of them is the kernel described above, and a build with
// any of them holds the bf16 kernel only).  They are the counterparts of
// three TPU probes of block 0, wrapped by ops/block0_variants.py, whose
// header states each variant's function:
//
//   B0_EPI=1..4  where conv1's epilogue rounds to bf16
//                (tools/probe_b0_epi.py:_kernel; 1 is also the bf16epi
//                construct of tools/probe_b0_constructs.py:_kernel):
//                1 (vA) the f32 sum is rounded, the shift added and SELU run
//                  on packed bf16 pairs (each add / mul / ex2 takes two
//                  values); the downsample is rounded and its bias added
//                  in bf16;
//                2 (vB) f32 SELU, rounded, halo mask applied in bf16;
//                3 (vD) f32 SELU, halo mask applied in f32, rounded;
//                4 (vF) as 1 with SELU's exponential in f32.
//   B0_RMW       conv2's per-tap partial sums leave the registers: they are
//                accumulated by read-modify-write into an f32 tile in shared
//                memory (each lane its own words) and read back for the pool
//                (tools/probe_b0_constructs.py:81-85).
//   B0_B2SLICE   the bias is read from shared memory at each use, not held
//                in a register (tools/probe_b0_constructs.py:96-97).
//   B0_STAGE=0..4  the item's work ends after the stage (dma, fill, conv1,
//                epi, conv2 of tools/probe_b0_ablate.py:_kernel) and what it
//                computed is reduced into the output tile, so that nothing is
//                dead code.  Stages 0-2 read one pooled column to the left
//                of the full kernel's tile: their frame tile starts four
//                columns earlier.  Stage 4 (conv2 "dense only") zeroes the
//                A fragments of the two off-split (pool phase, tap) pairs.
//   B0_CUT=bits  one phase removed, for timing only (the output is
//                meaningless): 1 the frame-tile load, 2 conv1 + SELU, 4
//                conv2's MMA loop, 8 the output store (the pool and the
//                downsample are still computed).
//
// Variant builds read `bias` as (3, C): conv2's bias plus the downsample's,
// the downsample's, conv2's.
//
//   B0P_TIMER    the plain kernels, and thread 0 of each CTA of the bf16
//                kernel adds clock64() deltas per phase of an item (frame
//                load with its two barriers, conv1 + SELU with its barrier,
//                conv2's MMA loop, the downsample, pool and store) into
//                registers and writes them with the CTA's first and last
//                clock64 and %globaltimer into the side buffer that
//                aasist_fused_block0_timer reads, in the slots that
//                csrc/block0_pipe.cu uses (ops/block0_pipe.py:phase_ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "b0_timer.cuh"

#if defined(B0_EPI) || defined(B0_RMW) || defined(B0_B2SLICE) || \
    defined(B0_STAGE) || defined(B0_CUT)
#define B0_VARIANT 1
#endif
#ifndef B0_EPI
#define B0_EPI 0
#endif
#ifndef B0_STAGE
#define B0_STAGE 5
#endif
#ifndef B0_CUT
#define B0_CUT 0
#endif

namespace {

constexpr int EPI = B0_EPI;       // conv1's epilogue (0: f32, rounded once)
constexpr int STAGE = B0_STAGE;   // 5: the whole block
constexpr int CUT = B0_CUT;
constexpr bool BF16_EPI = EPI == 1 || EPI == 4;
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
#ifdef B0_VARIANT
constexpr int NBIAS = 3;          // bias rows: sum, downsample's, conv2's
#else
constexpr int NBIAS = 1;
#endif
static_assert(EPI >= 0 && EPI <= 4 && STAGE >= 0 && STAGE <= 5 && CUT >= 0 &&
              CUT < 16, "unknown variant");

// Timer slots (b0_timer.cuh): 0 / 1 first and last clock64, 2 / 3 first
// and last %globaltimer (ns), 4 items, then clocks summed over items: 5 the
// frame load, 6 conv1 + SELU, 7 conv2's MMA loop, 8 the downsample, pool
// and store; 9-11 unused.

constexpr int C = 32;             // block-0 channels (filts[1][1])
constexpr int TO = 32;            // pooled columns per tile
constexpr int TP = 3 * TO;        // conv2 positions per tile
constexpr int YW = TP + 2;        // y1 columns per tile (time halo 1 + 1)
constexpr int ZOFF = STAGE < 3 ? 4 : 0;   // extra frame columns on the left
constexpr int ZW = TP + 4 + 2 * ZOFF;     // frame columns per tile
constexpr int SMALL_SZ = C * 6 + C + C * 3 + NBIAS * C;  // w1, sh1, wd, bias

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

constexpr float SELU_SCALE = 1.0507009873554805f;
constexpr float SELU_ALPHA = 1.6732632423543772f;

__device__ __forceinline__ float selu(float z) {
  return z > 0.f ? SELU_SCALE * z : (SELU_SCALE * SELU_ALPHA) * expm1f(z);
}

// SELU for values rounded to bf16 next: __expf's error is far below bf16's
__device__ __forceinline__ float selu_fast(float z) {
  return z > 0.f ? SELU_SCALE * z
                 : (SELU_SCALE * SELU_ALPHA) * (__expf(z) - 1.f);
}

// Small per-channel tensors into shared memory: w1 (C, 6), sh1, wd (C, 3),
// bias, in that order from `small`.
__device__ __forceinline__ void load_small(float* small, const float* w1,
                                           const float* sh1, const float* wd,
                                           const float* bias) {
  for (int i = threadIdx.x; i < C * 6; i += blockDim.x) small[i] = w1[i];
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    small[C * 6 + i] = sh1[i];
    small[C * 10 + i] = bias[i];
  }
  for (int i = threadIdx.x; i < C * 3; i += blockDim.x)
    small[C * 7 + i] = wd[i];
  if constexpr (NBIAS > 1)
    for (int i = C + threadIdx.x; i < NBIAS * C; i += blockDim.x)
      small[C * 10 + i] = bias[i];
}

// Work item -> (batch row, first output row, first pooled column) for
// bands of R output rows.
struct Item {
  long long b;
  int f0, t0;
};
template <int R>
__device__ __forceinline__ Item item(int work, int n_tiles, int n_bands) {
  const int rest = work / n_tiles;
  return {rest / n_bands, (rest % n_bands) * R, (work % n_tiles) * TO};
}

// zs[r][c] = frame[b, f0 + r, 3 t0 - 1 - ZOFF + c] for r < R + 2, zero
// outside the frame.
template <int R, typename T>
__device__ __forceinline__ void load_frame_tile(float* zs, const T* z,
                                                const Item& it, int F,
                                                int T_z) {
  const int zrows = F + 2, zcols = T_z + 2, c0 = 3 * it.t0 - 1 - ZOFF;
  const T* zb = z + it.b * zrows * zcols;
  for (int i = threadIdx.x; i < (R + 2) * ZW; i += blockDim.x) {
    const int pr = it.f0 + i / ZW, pc = c0 + i % ZW;
    zs[i] = (pr < zrows && pc >= 0 && pc < zcols)
                ? to_f32(zb[(long long)pr * zcols + pc])
                : 0.f;
  }
}

// conv1 + folded bn2 before the SELU, at y1 row f0 + r, time 3 t0 - 1 + col
// of input channel ci; `valid` is false outside the y1 extent.
__device__ __forceinline__ float conv1_at(const float* zs, const float* w1s,
                                          const float* sh1s, const Item& it,
                                          int r, int col, int ci, int F,
                                          int T_z, bool* valid) {
  const int t = 3 * it.t0 - 1 + col;
  *valid = t >= 0 && t < T_z && it.f0 + r <= F;
  const float* wk = w1s + ci * 6;
  const float* zr = zs + r * ZW + col;
  float a = sh1s[ci];
  a = fmaf(wk[0], zr[0], a);
  a = fmaf(wk[1], zr[1], a);
  a = fmaf(wk[2], zr[2], a);
  a = fmaf(wk[3], zr[ZW], a);
  a = fmaf(wk[4], zr[ZW + 1], a);
  a = fmaf(wk[5], zr[ZW + 2], a);
  return a;
}

// ------------------------------------------------------------------ f32
#ifndef B0_VARIANT
namespace fma_k {
constexpr int THREADS = 256;
constexpr int R = 8;              // output rows per band
constexpr int G = 6;              // positions per thread (two pooled)
constexpr int NG = TP / G;        // position groups per row
constexpr int CH = 16;            // output channels per thread
static_assert(THREADS == (C / CH) * R * NG, "thread map");
static_assert(NG == 16 && C / CH == 2, "warp = 2 rows x 16 groups, 1 half");
constexpr int W2_SZ = C * 6 * C;            // [ci][df*3+dt][co]
constexpr int Y1_SZ = (R + 1) * C * YW;     // [row][ci][col]
constexpr int ZS_SZ = (R + 2) * ZW;         // frame tile
constexpr size_t SMEM = (W2_SZ + Y1_SZ + ZS_SZ + SMALL_SZ) * sizeof(float);
}  // namespace fma_k

// Warp w: channel half h = w & 1, rows 2 * (w >> 1) + {0, 1} of the band
// (lanes 0-15 and 16-31), lane & 15 = position group g.
__global__ void __launch_bounds__(fma_k::THREADS, 1)
block0_fma_kernel(const float* __restrict__ z, const float* __restrict__ w1,
                  const float* __restrict__ sh1,
                  const float* __restrict__ w2, const float* __restrict__ wd,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int F, int T_z, int T_out, int n_tiles, int n_bands,
                  int n_work) {
  using namespace fma_k;
  extern __shared__ float4 smem4[];
  float* w2s = reinterpret_cast<float*>(smem4);
  float* y1s = w2s + W2_SZ;
  float* zs = y1s + Y1_SZ;
  float* w1s = zs + ZS_SZ;
  const float* sh1s = w1s + C * 6;
  const float* wds = w1s + C * 7;
  const float* bs = w1s + C * 10;

  const int tid = threadIdx.x;
  for (int i = tid; i < W2_SZ; i += THREADS) w2s[i] = w2[i];
  load_small(w1s, w1, sh1, wd, bias);

  const int lane = tid & 31, warp = tid >> 5;
  const int h = warp & 1;
  const int row = 2 * (warp >> 1) + (lane >> 4);   // output row in band
  const int g = lane & 15;
  const int p0 = G * g;                            // first position in tile

  for (int work = blockIdx.x; work < n_work; work += gridDim.x) {
    const Item it = item<R>(work, n_tiles, n_bands);
    __syncthreads();                     // last item's readers are done
    load_frame_tile<R>(zs, z, it, F, T_z);
    __syncthreads();
    for (int i = tid; i < Y1_SZ; i += THREADS) {
      const int col = i % YW, rc = i / YW;
      bool valid;
      const float a = conv1_at(zs, w1s, sh1s, it, rc / C, col, rc % C, F,
                               T_z, &valid);
      y1s[i] = valid ? selu(a) : 0.f;
    }
    __syncthreads();

    const int f = it.f0 + row;
    if (f >= F || it.t0 + 2 * g >= T_out) continue;   // no syncs below

    float acc[CH][G];
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int j = 0; j < G; ++j) acc[c][j] = 0.f;

#pragma unroll 2
    for (int ci = 0; ci < C; ++ci) {
#pragma unroll
      for (int df = 0; df < 2; ++df) {
        // y[k] = y1[f + df][ci][time 3 t0 + p0 - 1 + k]
        const float* yr = y1s + ((row + df) * C + ci) * YW + p0;
        float y[G + 2];
#pragma unroll
        for (int k = 0; k < (G + 2) / 2; ++k) {
          const float2 v = *reinterpret_cast<const float2*>(yr + 2 * k);
          y[2 * k] = v.x;
          y[2 * k + 1] = v.y;
        }
        const float* wr = w2s + (ci * 6 + df * 3) * C + CH * h;
#pragma unroll
        for (int dt = 0; dt < 3; ++dt) {
#pragma unroll
          for (int q = 0; q < CH / 4; ++q) {
            const float4 w =
                *reinterpret_cast<const float4*>(wr + dt * C + 4 * q);
#pragma unroll
            for (int j = 0; j < G; ++j) {
              const float yv = y[j + dt];
              acc[4 * q + 0][j] = fmaf(w.x, yv, acc[4 * q + 0][j]);
              acc[4 * q + 1][j] = fmaf(w.y, yv, acc[4 * q + 1][j]);
              acc[4 * q + 2][j] = fmaf(w.z, yv, acc[4 * q + 2][j]);
              acc[4 * q + 3][j] = fmaf(w.w, yv, acc[4 * q + 3][j]);
            }
          }
        }
      }
    }

    // downsample reads z row f (frame row f + 1), times 3 t0 + p0 - 1 + k
    float zz[G + 2];
#pragma unroll
    for (int k = 0; k < G + 2; ++k) zz[k] = zs[(row + 1) * ZW + p0 + 1 + k];

    float* ob = out + ((it.b * C + CH * h) * F + f) * (long long)T_out;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int co = CH * h + c;
      const float d0 = wds[co * 3], d1 = wds[co * 3 + 1], d2 = wds[co * 3 + 2];
      float v[G];
#pragma unroll
      for (int j = 0; j < G; ++j)
        v[j] = acc[c][j] + fmaf(d0, zz[j], fmaf(d1, zz[j + 1], d2 * zz[j + 2]));
#pragma unroll
      for (int k = 0; k < G / 3; ++k) {
        const int to = it.t0 + 2 * g + k;
        if (to < T_out)
          ob[(long long)c * F * T_out + to] =
              fmaxf(fmaxf(v[3 * k], v[3 * k + 1]), v[3 * k + 2]) + bs[co];
      }
    }
  }
}

#endif  // !B0_VARIANT

// ----------------------------------------------------------------- bf16
namespace tc {
constexpr int R = 4;              // output rows per band
constexpr int THREADS = 256;      // two warps per output row
constexpr int CIS = 40;           // bf16 stride of a y1 time / a tap's co row
constexpr int MT = TP / 32;       // m16 tiles per warp: half the positions
constexpr int U = TO / 16;        // pooled columns per accumulator row group
constexpr int RUN = 7;            // y1 columns per conv1 run of a thread
static_assert(YW % RUN == 0, "runs tile a y1 row");
static_assert(THREADS / 32 == 2 * R, "two warps per output row");
static_assert(2 * MT == 3 * U, "a lane's 2 MT rows are U whole pools");
constexpr int W2_SZ = 6 * C * CIS;          // bf16 [tap][co][ci]
constexpr int Y1_SZ = (R + 1) * YW * CIS;   // bf16 [row][col][ci]
constexpr int ZS_SZ = (R + 2) * ZW;         // frame tile, f32
constexpr int ST_P = C + 1;                 // pitch of a stage tile position
constexpr int ST_SZ = R * TO * ST_P;        // a stage's output tile, f32
constexpr int RMW_SZ = THREADS * MT * 16;   // conv2's sums, f32, RMW builds
constexpr int EXTRA_SZ = (STAGE < 4 ? ST_SZ : 0) + (RMW ? RMW_SZ : 0);
constexpr size_t SMEM = (W2_SZ + Y1_SZ) * sizeof(__nv_bfloat16) +
                        (ZS_SZ + SMALL_SZ + EXTRA_SZ) * sizeof(float);
static_assert((W2_SZ + Y1_SZ) * sizeof(__nv_bfloat16) % 16 == 0, "align");
}  // namespace tc

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
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

// SELU on a pair of bf16 values, every operation rounded to bf16 (the _rn
// intrinsics keep the multiplies and the add from being contracted);
// F32EXP: the exponential and its "- 1" in f32, rounded once.
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

// Two neighbouring channels of y1 from conv1's f32 sums a, b (the shift
// included, except for the bf16 epilogues, which add sh2 in bf16); zero
// outside the y1 extent.
__device__ __forceinline__ __nv_bfloat162 y1_pair(float a, float b,
                                                  bool valid,
                                                  __nv_bfloat162 sh2) {
  if constexpr (EPI == 0) {
    return valid ? __floats2bfloat162_rn(selu_fast(a), selu_fast(b))
                 : __floats2bfloat162_rn(0.f, 0.f);
  } else if constexpr (EPI == 3) {
    const float m = valid ? 1.f : 0.f;
    return __floats2bfloat162_rn(selu_fast(a) * m, selu_fast(b) * m);
  } else {
    const __nv_bfloat162 m2 = __float2bfloat162_rn(valid ? 1.f : 0.f);
    if constexpr (EPI == 2)
      return __hmul2_rn(
          __floats2bfloat162_rn(selu_fast(a), selu_fast(b)), m2);
    else
      return __hmul2_rn(
          selu_bf16x2<EPI == 4>(
              __hadd2_rn(__floats2bfloat162_rn(a, b), sh2)),
          m2);
  }
}

// A stage's f32 tile st[r][d][co] (pitch ST_P, so that both the stages'
// channel-major writes and these time-major reads are free of bank
// conflicts) -> out[b, co, f0 + r, t0 + d].
__device__ __forceinline__ void store_stage_tile(const float* st,
                                                 __nv_bfloat16* out,
                                                 const Item& it, int F,
                                                 int T_out) {
  using namespace tc;
  for (int i = threadIdx.x; i < C * R * TO; i += THREADS) {
    const int d = i % TO, r = (i / TO) % R, co = i / (TO * R);
    const int f = it.f0 + r, t = it.t0 + d;
    if (f < F && t < T_out)
      out[((it.b * C + co) * F + f) * (long long)T_out + t] =
          __float2bfloat16(st[(r * TO + d) * ST_P + co]);
  }
}

// Warp w owns output row w / 2 of the band, all 32 channels, at half
// w % 2 of the tile's 96 positions (MT m16 tiles).  The M rows are
// assigned so that each lane's accumulators hold whole pool windows: an
// accumulator row of group g (lane / 4) at slot s = 2 m + (row >= 8) is
// position 48 (w % 2) + 3 g + 24 (s / 3) + s % 3, so slots 3u..3u+2 are
// pooled column 16 (w % 2) + g + 8 u.  Rows of one 8x8 ldmatrix are then 3
// positions (240 bytes) apart: conflict-free.  For conv1, thread i owns
// channels 2 (i % 16) + {0, 1}, their taps in registers, and walks runs of
// RUN y1 columns with a sliding window of z.
__global__ void __launch_bounds__(tc::THREADS, 2)
block0_tc_kernel(const __nv_bfloat16* __restrict__ z,
                 const float* __restrict__ w1, const float* __restrict__ sh1,
                 const float* __restrict__ w2, const float* __restrict__ wd,
                 const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, int F, int T_z, int T_out,
                 int n_tiles, int n_bands, int n_work) {
  using namespace tc;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* w2b = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* y1b = w2b + W2_SZ;
  float* zs = reinterpret_cast<float*>(y1b + Y1_SZ);
  float* w1s = zs + ZS_SZ;
  const float* wds = w1s + C * 7;
  const float* bs = w1s + C * 10;
  float* st = w1s + SMALL_SZ;                      // stages 0-3
  float* rmw_tile = st + (STAGE < 4 ? ST_SZ : 0);  // B0_RMW

  const int tid = threadIdx.x;
#ifdef B0P_TIMER
  unsigned long long tm[NSLOT] = {};
  tm[0] = clk();
  tm[2] = gtimer();
  unsigned long long t_prev = tm[0];
  // thread 0: the delta since the last mark, into slot s
  auto mark = [&](int s) {
    const unsigned long long t = clk();
    tm[s] += t - t_prev;
    t_prev = t;
  };
#else
  auto mark = [](int) {};
#endif
  // w2 [ci][tap][co] (f32) -> [tap][co][ci] (bf16); ci 32..39 never read
  for (int i = tid; i < C * 6 * C; i += THREADS) {
    const int co = i % C, tap = (i / C) % 6, ci = i / (6 * C);
    w2b[(tap * C + co) * CIS + ci] = __float2bfloat16(w2[i]);
  }
  load_small(w1s, w1, sh1, wd, bias);
  if constexpr ((CUT & 3) != 0) {      // a cut phase leaves its tile unset
    for (int i = tid; i < Y1_SZ; i += THREADS)
      y1b[i] = __float2bfloat16(0.f);
    for (int i = tid; i < ZS_SZ; i += THREADS) zs[i] = 0.f;
  }

  const int cp = 2 * (tid & 15);         // this thread's conv1 channels
  float wa[6], wb[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    wa[k] = w1[cp * 6 + k];
    wb[k] = w1[(cp + 1) * 6 + k];
  }
  const float sa = sh1[cp], sb = sh1[cp + 1];
  const __nv_bfloat162 sh2 = __floats2bfloat162_rn(sa, sb);
  // the bf16 epilogues add the shift after the sum's rounding
  const float a_init = BF16_EPI ? 0.f : sa, b_init = BF16_EPI ? 0.f : sb;

  const int lane = tid & 31, row = tid >> 6, half = (tid >> 5) & 1;
  const int g = lane >> 2, p0 = 48 * half;  // p0: first position of warp
  // ldmatrix row addresses: A row lane & 15 of m tile m is position
  // a_pos[m], k half by lane >> 4; B rows are output channels, k half by
  // (lane >> 3) & 1
  int a_pos[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int slot = 2 * m + ((lane >> 3) & 1);
    a_pos[m] = p0 + 3 * (lane & 7) + 24 * (slot / 3) + slot % 3;
  }
  const uint32_t a_base = smem_u32(y1b) + (lane >> 4) * 8 * 2;
  const uint32_t b_base =
      smem_u32(w2b) +
      ((((lane >> 4) * 8 + (lane & 7)) * CIS) + ((lane >> 3) & 1) * 8) * 2;

#ifdef B0P_TIMER
  t_prev = clk();
#endif
  for (int work = blockIdx.x; work < n_work; work += gridDim.x) {
    const Item it = item<R>(work, n_tiles, n_bands);
    __syncthreads();                     // last item's readers are done
    if constexpr (!(CUT & 1)) load_frame_tile<R>(zs, z, it, F, T_z);
    __syncthreads();
    mark(5);

    if constexpr (STAGE < 3) {
      // tile column c is frame column 3 t0 - 5 + c: pooled column t0 + d
      // starts at frame column 3 (t0 + d) - 5, tile column 3 d
      if constexpr (STAGE < 2) {
        for (int i = tid; i < C * R * TO; i += THREADS) {
          const int d = i % TO, r = (i / TO) % R, co = i / (TO * R);
          float v = 0.f;
          if (co == 0) {                 // the other channels are zero
            const float* zr = zs + r * ZW + 3 * d;
            if constexpr (STAGE == 0) {
              v = zr[0];
            } else {
#pragma unroll
              for (int j = 0; j < 9; ++j) v += zr[j] + zr[ZW + j];
            }
          }
          st[(r * TO + d) * ST_P + co] = v;
        }
      } else {
        // conv1 + shift and downsample + bias at times 3 (t' - 1) + q,
        // q = 0..2, summed; y1 time t reads tile columns t - 3 t0 + 5 + dt
        const float da[3] = {wds[cp * 3], wds[cp * 3 + 1], wds[cp * 3 + 2]};
        const float db[3] = {wds[cp * 3 + 3], wds[cp * 3 + 4],
                             wds[cp * 3 + 5]};
        for (int p = tid >> 4; p < R * TO; p += THREADS / 16) {
          const int d = p % TO, r = p / TO;
          const float* zr = zs + r * ZW + 3 * d + 2;
          float z0[5], z1[5];
#pragma unroll
          for (int k = 0; k < 5; ++k) {
            z0[k] = zr[k];
            z1[k] = zr[ZW + k];
          }
          float a = 3.f * (sa + bs[C + cp]), b = 3.f * (sb + bs[C + cp + 1]);
#pragma unroll
          for (int q = 0; q < 3; ++q)
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              a = fmaf(wa[k], z0[q + k], fmaf(wa[3 + k] + da[k], z1[q + k], a));
              b = fmaf(wb[k], z0[q + k], fmaf(wb[3 + k] + db[k], z1[q + k], b));
            }
          st[p * ST_P + cp] = a;
          st[p * ST_P + cp + 1] = b;
        }
      }
      __syncthreads();
      store_stage_tile(st, out, it, F, T_out);
      continue;
    }

    // y1b[r][col][ci] at y1 row f0 + r, time 3 t0 - 1 + col; zero outside
    // the y1 extent (rows 0..F, times 0..T_z-1)
    if constexpr (!(CUT & 2))
    for (int run = tid >> 4; run < (R + 1) * (YW / RUN);
         run += THREADS / 16) {
      const int r = run / (YW / RUN), col0 = (run % (YW / RUN)) * RUN;
      const float* zr = zs + r * ZW + col0;
      float z0[RUN + 2], z1[RUN + 2];
#pragma unroll
      for (int k = 0; k < RUN + 2; ++k) {
        z0[k] = zr[k];
        z1[k] = zr[ZW + k];
      }
      const bool row_ok = it.f0 + r <= F;
      const int t_col0 = 3 * it.t0 - 1 + col0;      // y1 time of col0
      __nv_bfloat16* dst = y1b + (r * YW + col0) * CIS + cp;
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        float a = a_init, b = b_init;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          a = fmaf(wa[k], z0[j + k], fmaf(wa[3 + k], z1[j + k], a));
          b = fmaf(wb[k], z0[j + k], fmaf(wb[3 + k], z1[j + k], b));
        }
        const bool valid = row_ok && t_col0 + j >= 0 && t_col0 + j < T_z;
        *reinterpret_cast<__nv_bfloat162*>(dst + j * CIS) =
            y1_pair(a, b, valid, sh2);
      }
    }
    __syncthreads();
    mark(6);

    if constexpr (STAGE == 3) {
      // y1 time 3 t' + k is tile column 3 d + 1 + k; the downsample reads
      // z row f (tile row r + 1) at tile columns 3 d + 1 + dt
      for (int i = tid; i < C * R * TO; i += THREADS) {
        const int co = i % C, d = (i / C) % TO, r = i / (C * TO);
        const __nv_bfloat16* y0 = y1b + (r * YW + 3 * d) * CIS + co;
        const __nv_bfloat16* y1r = y0 + YW * CIS;
        const float* zr = zs + (r + 1) * ZW + 3 * d + 1;
        const float ds = fmaf(wds[co * 3], zr[0],
                              fmaf(wds[co * 3 + 1], zr[1],
                                   wds[co * 3 + 2] * zr[2])) + bs[C + co];
        st[(r * TO + d) * ST_P + co] =
            to_f32(y0[CIS]) + to_f32(y1r[CIS]) + to_f32(y0[0]) +
            to_f32(y1r[4 * CIS]) + to_f32(__float2bfloat16(ds));
      }
      __syncthreads();
      store_stage_tile(st, out, it, F, T_out);
      continue;
    }

    const int f = it.f0 + row;
    if (f >= F) continue;                // no block-wide syncs below
    float acc[MT][4][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
    // B0_RMW: this lane's word (m, n, e) of the f32 tile
    volatile float* rt = rmw_tile + (tid >> 5) * (MT * 16 * 32) + lane;

    if constexpr (!(CUT & 4)) {
#pragma unroll
    for (int tap = 0; tap < 6; ++tap) {
      const int df = tap / 3, dt = tap % 3;
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        uint32_t b[4][2];
        const uint32_t ba = b_base + (tap * C * CIS + kh * 16) * 2;
        ldmatrix_x4(ba, b[0][0], b[0][1], b[1][0], b[1][1]);
        ldmatrix_x4(ba + 16 * CIS * 2, b[2][0], b[2][1], b[3][0], b[3][1]);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          // A[p][ci] = y1[row + df][time col p + dt][kh * 16 + ci]
          const int col = a_pos[m] + dt;
          uint32_t a[4];
          ldmatrix_x4(a_base + (((row + df) * YW + col) * CIS + kh * 16) * 2,
                      a[0], a[1], a[2], a[3]);
          if constexpr (STAGE == 4) {
            // dense only: rows 0-7 (a[0], a[2]) are slot 2 m, rows 8-15
            // (a[1], a[3]) slot 2 m + 1, a slot's pool phase is slot % 3;
            // phase 0 lacks the tap dt = 0 and phase 2 the tap dt = 2
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              if (dt != 1 && (2 * m + hh) % 3 == dt) a[hh] = a[hh + 2] = 0u;
          }
#pragma unroll
          for (int n = 0; n < 4; ++n) mma_bf16(acc[m][n], a, b[n]);
        }
      }
      if constexpr (RMW) {               // this tap's partial sums
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              volatile float* w = rt + ((m * 4 + n) * 4 + e) * 32;
              *w = tap == 0 ? acc[m][n][e] : *w + acc[m][n][e];
              acc[m][n][e] = 0.f;
            }
      }
    }
    }
    if constexpr (RMW && !(CUT & 4)) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[m][n][e] = rt[((m * 4 + n) * 4 + e) * 32];
    }
    mark(7);

    // element e of tile (m, n): channel n*8 + 2*(lane%4) + (e & 1), slot
    // 2 m + (e >> 1); the downsample reads z row f (frame row f + 1) at
    // times 3 (t0 + q) - 1 + k for its pooled columns q = 16 half + g + 8 u
    float zz[U][5];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < 5; ++k)
        zz[u][k] = zs[(row + 1) * ZW + p0 + 3 * g + 24 * u + 1 + k];
    const int q0 = it.t0 + 16 * half + g;
    __nv_bfloat16* ob = out + (it.b * C * F + f) * (long long)T_out + q0;
    // the bf16 epilogues add the downsample's bias in bf16 and conv2's
    // after the pool; the others add their sum after the pool
    const volatile float* bv = bs + (BF16_EPI ? 2 * C : 0);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        const int co = n * 8 + 2 * (lane & 3) + par;
        const float d0 = wds[co * 3], d1 = wds[co * 3 + 1],
                    d2 = wds[co * 3 + 2];
        float bo = 0.f;
        if constexpr (!B2SLICE) bo = bs[(BF16_EPI ? 2 * C : 0) + co];
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
                                              __float2bfloat16(bs[C + co])));
            v[j] = acc[slot / 2][n][2 * (slot % 2) + par] + ds;
          }
          if constexpr (B2SLICE) bo = bv[co];
          // B0_CUT & 8: a bound no column is under, which the compiler
          // cannot see through, so that only the store goes
          if (q0 + 8 * u < ((CUT & 8) ? 0 : T_out))
            ob[(long long)co * F * T_out + 8 * u] = __float2bfloat16(
                fmaxf(fmaxf(v[0], v[1]), v[2]) + bo);
        }
      }
    mark(8);
#ifdef B0P_TIMER
    tm[4] += 1;
#endif
  }
#ifdef B0P_TIMER
  if (tid == 0) {
    unsigned long long* t = timer_words();
    tm[1] = clk();
    tm[3] = gtimer();
    for (int i = 0; i < NSLOT; ++i) t[i] = tm[i];
  }
#endif
}

template <typename T, typename K>
cudaError_t launch(K kernel, int threads, int rows, size_t smem,
                   const void* z, const float* w1,
                   const float* sh1, const float* w2, const float* wd,
                   const float* bias, void* out, int B, int F, int T_z,
                   cudaStream_t stream) {
  const int T_out = T_z / 3;
  const int n_tiles = (T_out + TO - 1) / TO;
  const int n_bands = (F + rows - 1) / rows;
  const long long n_work = (long long)n_tiles * n_bands * B;
  if (n_work > 0x7fffffff) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long blocks = (long long)sms * per_sm;
  const int grid = (int)(n_work < blocks ? n_work : blocks);
#ifdef B0P_TIMER
  // only the bf16 kernel is timed: an f32 launch leaves the last bf16
  // launch's count
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    if ((e = timer_arm(grid)) != cudaSuccess) return e;
#endif
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(z), w1, sh1, w2, wd, bias, static_cast<T*>(out),
      F, T_z, T_out, n_tiles, n_bands, (int)n_work);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  z (B, F + 2, T_z + 2) of that type,
// zero-bordered; out (B, channels, F, T_z / 3) of that type.  Float32 on
// the device: w1 (C, 6) conv1 taps [df*3+dt] times the bn2 scale, sh1 (C)
// the folded shift, w2 (C, 6, C) conv2 taps [ci][df*3+dt][co], wd (C, 3)
// downsample taps, bias (C) conv2 bias + downsample bias.  channels must be
// 32.  A variant build (see the header) takes dtype 1 only and reads bias as
// (3, C): that sum, the downsample's bias, conv2's bias.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int aasist_fused_block0(const void* z, const float* w1,
                                   const float* sh1, const float* w2,
                                   const float* wd, const float* bias,
                                   void* out, int B, int F, int T_z,
                                   int channels, int dtype, void* stream) {
  if (channels != C || B <= 0 || F <= 0 || T_z / 3 <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
#ifndef B0_VARIANT
    case 0:
      return (int)launch<float>(block0_fma_kernel, fma_k::THREADS, fma_k::R,
                                fma_k::SMEM, z, w1, sh1, w2, wd, bias, out,
                                B, F, T_z, s);
#endif
    case 1:
      return (int)launch<__nv_bfloat16>(block0_tc_kernel, tc::THREADS, tc::R,
                                        tc::SMEM, z, w1, sh1, w2, wd, bias,
                                        out, B, F, T_z, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The timer builds' side buffer of the last bf16 launch (b0_timer.cuh:
// timer_read).
extern "C" int aasist_fused_block0_timer(void* dst, int* ctas, void* stream) {
  return timer_read(dst, ctas, stream);
}
