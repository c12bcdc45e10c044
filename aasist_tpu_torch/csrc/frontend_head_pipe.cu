// The sinc frontend fused with the head of residual block 0, for Hopper
// (sm_90a), eval mode, redesigned from csrc/frontend_head.cu:
//
//   x0 = selu(bn(maxpool(3,3)(|sinc conv(x)|)))      (B, 23, T) for C = 70
//   y1 = selu(bn2(conv1(x0)))      conv1 1 -> 32, (2,3), pad (1,1)
//
// (B, L) waveform in; y1 (B, 32, F + 1, T) and the frontend frame x0
// (B, F + 1, T) out, F = C / 3, T = (L-128)/3, row F of x0 zero, both in the
// input's type (float or bf16).  The function is csrc/frontend_head.cu's:
// sums are f32, x0 is rounded to the output type before conv1 reads it,
// conv1 sees zeros at frame row -1, row F, t = -1 and t >= T, y1 is not
// masked and is rounded once at the store; bn2 and conv1's bias are folded
// into conv1's taps and one shift per channel on the host side of the call.
//
// Replaces the TPU kernel tools/probe_feb0_ablate.py:kernel (launched by
// run), as csrc/frontend_head.cu does; that kernel stays as the version this
// one is timed against.
//
// What bounds it on the H100.  At B = 128, L = 64,600 it writes 33 x 24 x
// 128 x 21,490 values, 4.36 GB in bf16 and 8.71 GB in f32: 1.31 ms and
// 2.61 ms at 3.35 TB/s.  y1 is 97 % of those bytes.  The older kernel
// reaches a fifth of the bf16 bound: its frontend is the CUDA-core one
// (~4.3 ms alone at this shape), and each block runs its conv and then its
// stores.
//
// What the design does about it.
// - The frontend phase in bf16 is csrc/frontend_dot.cu's implicit GEMM on
//   mma.sync (0.66 ms alone), its pool on the accumulators, values bit for
//   bit that kernel's; in f32 it is csrc/frontend_ffma.cu's CUDA-core scheme
//   (3 filters x 15 positions a thread, a ring of 15 samples, a cp.async
//   double buffer of waveform tiles), bit for bit the older frontend, so
//   the f32 gates hold as they were.  Either writes the frame tile in
//   shared memory: rows -1 .. F of the frontend (the rows outside it zero)
//   at the item's columns t0 - 1 .. t0 + TT, zero outside 0 <= t < T, so
//   conv1's paddings are read as data.
// - conv1 + bn2 + SELU on the CUDA cores from that tile: six FMAs a channel
//   a value, SELU with no branch, both sides computed and one picked, its
//   exponential ex2.approx as csrc/block0_pipe.cu's (in f32 too: see
//   selu_nb).
// - The y1 store sets the pace, so it is laid out for whole sectors.  An
//   NCHW row of T = 21,490 bf16 is 42,980 bytes, 4-byte aligned only: no
//   16-byte store along time and no TMA descriptor (its global strides are
//   multiples of 16 bytes) can describe it.  So y1 is stored channels last,
//   (B, F + 1, T, 32) in memory: a position's 32 channels are 64 contiguous
//   bytes (128 in f32), and a lane computes 8 channels of one position and
//   stores them as 16 bytes (f32: two 16-byte halves of a 128-byte row), a
//   warp 8 neighbouring positions, 512 contiguous bytes in bf16.  The
//   tensor the wrapper returns keeps its logical (B, 32, F + 1, T) shape
//   and values (torch.channels_last).  An NCHW store was built and
//   measured against it: lanes along time, two neighbouring times a lane in
//   one 4-byte (bf16) or 8-byte (f32) word, a warp 128 (256) contiguous
//   bytes, four (two) times the store instructions of this one for the
//   same bytes, 32 partial rows an item instead of one run.  It took 2.7223
//   ms against 2.4473 in bf16 (both at 128 columns an item) and 6.3588
//   against 4.9069 in f32 (NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py,
//   B = 128, L = 64,600), so it was dropped; the older kernel keeps an
//   NCHW store as the yardstick.
// - The stores overlap the next item's conv: warp specialisation, as
//   csrc/block0_pipe.cu's.  CTAs are persistent (one an SM) and walk work
//   items of (batch row, TT columns).  Producer warps (bf16: 4 on
//   mma.sync; f32: 8 on the CUDA cores) write item k + 1's frame tile
//   while 8 consumer warps run conv1 + SELU and the stores of item k from
//   the other one; the hand-off is by named barriers (FULL / EMPTY a tile).
//   The producers load item k + 1's samples ahead: in bf16 into registers
//   before item k's conv, in f32 by cp.async into the other waveform
//   buffer.  A first draft ran both phases in every warp, three CTAs an SM:
//   the CTAs stayed in step, so the card's stores and convs took turns, and
//   the build without conv1 (the frontend and the stores alone) took about
//   their sum.  A draft with 12 consumer warps (the conv in three groups of
//   filters, to fit 128 registers) was slower than this one: the
//   consumers' FMAs and SELU exponentials, not their number, set the pace
//   (PERF.md).
//
// Compile-time variants, for aasist_tpu_torch/tools/probe_feb0_ablate.py
// (each a build of its own; the same probe switches as csrc/frontend_head.cu):
//   HEADP_SUB     bf16 frame-tile width: 16 x 4 warps x HEADP_SUB columns,
//                 2, 4 or 8 (default, 512 columns).  The default is the
//                 fastest: at B = 128, L = 64,600 HEADP_SUB = 2 took
//                 2.3128 ms, 4 2.2224 and 8 2.2140, medians of four runs of
//                 tools/probe_feb0_ablate.py (NVIDIA H100 80GB HBM3,
//                 700.00 W), 8 the fastest in each run; 4 and 8 differ by
//                 less than the spread of their runs.  A wider item has fewer
//                 items, barriers and recomputed halo columns (2 of its
//                 columns).  16 does not fit: its two f32 frame tiles take
//                 213,824 bytes beside the bank's 24,320, over the 232,448
//                 a block may have;
//   HEADP_NOSELU  y1 stored without its SELU;
//   HEADP_NODOT   no conv1: x0 broadcast to the 32 channels (the frontend
//                 plus the write floor);
//   HEADP_BF16ACC conv1 accumulated in bf16 (__hfma2, two channels a time);
//                 bf16 only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef HEADP_SUB
#define HEADP_SUB 8
#endif

namespace {

typedef __nv_bfloat16 bf16;

constexpr int KSIZE = 129;               // sinc taps
constexpr int C1 = 32;                   // conv1 output channels
constexpr int MAXF = 24;                 // pooled rows a frame tile holds
constexpr int FR_ROWS = MAXF + 2;        // with a zero row above and below
constexpr int WP = 8;                    // floats per channel of folded taps

constexpr float SELU_SCALE = 1.0507009873554805f;
constexpr float SELU_ALPHA = 1.6732632423543772f;

// The frontend's SELU (csrc/frontend_dot.cu's and csrc/frontend_ffma.cu's)
__device__ __forceinline__ float selu_ref(float z) {
  return z > 0.f ? SELU_SCALE * z : (SELU_SCALE * SELU_ALPHA) * expm1f(z);
}

// y1's SELU with no branch: both sides computed, one picked with bit
// operations, the exponential ex2.approx.ftz of z log2(e), as
// csrc/block0_pipe.cu's selu_nb, whose values are __expf's.  For z > 0 the
// exponential may be inf, and that side is not picked; below z = -87 it
// flushes to 0 and e - 1 is -1, as expm1f's -1 + 2^-126 rounds.  Its
// relative error, a few 2^-23 of e, is far below the f32 gate (5e-5 of
// max|y1|) and below a bf16 ulp; the older kernel's expm1f costs ~20
// instructions a value more on the f32 route, which the CUDA-core frontend
// already keeps busy.
__device__ __forceinline__ float selu_nb(float z) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(z * 1.4426950216293334961f));
  const float pos = SELU_SCALE * z;
  const float neg = (SELU_SCALE * SELU_ALPHA) * (e - 1.f);
  const unsigned m = z > 0.f ? 0xffffffffu : 0u;
  return __uint_as_float((__float_as_uint(pos) & m) |
                         (__float_as_uint(neg) & ~m));
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

// Channel i of a lane's 8 in the channels-last store: bf16 8 q + i (16
// contiguous bytes); f32 4 q + i and 16 + 4 q + i - 4 (two 16-byte pieces,
// each quarter warp's first piece one 64-byte run).
template <typename T>
__device__ __forceinline__ int lane_channel(int q, int i) {
  if constexpr (sizeof(T) == 2)
    return 8 * q + i;
  else
    return i < 4 ? 4 * q + i : 12 + 4 * q + i;
}

__device__ __forceinline__ void store8(bf16* dst, int q, const float* v) {
  uint32_t o[4];
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const __nv_bfloat162 pr = __floats2bfloat162_rn(v[2 * h], v[2 * h + 1]);
    o[h] = *reinterpret_cast<const uint32_t*>(&pr);
  }
  *reinterpret_cast<uint4*>(dst + 8 * q) = make_uint4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ void store8(float* dst, int q, const float* v) {
  *reinterpret_cast<float4*>(dst + 4 * q) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 16 + 4 * q) =
      make_float4(v[4], v[5], v[6], v[7]);
}

// A lane's 8 channels of y1 at one position from its six frame values z
// (taps [df*3+dt]) and the folded taps w, shifts sh in registers.
__device__ __forceinline__ void conv1_selu(const float (&w)[8][6],
                                           const float (&sh)[8],
                                           const float* z, float* v) {
#if defined(HEADP_NODOT)
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = z[4];
#elif defined(HEADP_BF16ACC)
  __nv_bfloat162 zq[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) zq[k] = __float2bfloat162_rn(z[k]);
#pragma unroll
  for (int i = 0; i < 8; i += 2) {
    __nv_bfloat162 a = __floats2bfloat162_rn(sh[i], sh[i + 1]);
#pragma unroll
    for (int k = 0; k < 6; ++k)
      a = __hfma2(__floats2bfloat162_rn(w[i][k], w[i + 1][k]), zq[k], a);
    const float2 f = __bfloat1622float2(a);
#if defined(HEADP_NOSELU)
    v[i] = f.x;
    v[i + 1] = f.y;
#else
    v[i] = selu_nb(f.x);
    v[i + 1] = selu_nb(f.y);
#endif
  }
#else
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float a = sh[i];                         // the folded shift
#pragma unroll
    for (int k = 0; k < 6; ++k) a = fmaf(w[i][k], z[k], a);
#if defined(HEADP_NOSELU)
    v[i] = a;
#else
    v[i] = selu_nb(a);
#endif
  }
#endif
}

// Phase 2 of an item, the consumer threads 0 .. NTHREADS - 1: x0 and y1 at
// columns t0 .. t0 + NF - 3 from the f32 frame tile fr[row][column] (pitch
// FP, even; row 0 is frame row -1, column j is time t0 - 1 + j).  w1s holds
// the folded taps, {6 taps [df*3+dt], shift, 0} a channel.  A lane takes
// two neighbouring positions (j even, and TT is even, so both lie in the
// item): 16 independent FMA chains and 8-byte frame loads.
template <typename T, int NF, int FP, int NTHREADS>
__device__ __forceinline__ void head_store(const float* fr, const float* w1s,
                                           T* __restrict__ y1,
                                           T* __restrict__ x0, long long b,
                                           int t0, int rows, int T_out) {
  constexpr int TT = NF - 2;
  static_assert(TT % 2 == 0 && FP % 2 == 0 && (NF / 2) % 8 == 0, "pairs");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T* x0b = x0 + b * rows * T_out + t0;
  for (int i = tid; i < rows * TT; i += NTHREADS) {
    const int r = i / TT, j = i % TT;
    if (t0 + j < T_out)
      x0b[(long long)r * T_out + j] = from_f32<T>(fr[(r + 1) * FP + j + 1]);
  }
  // lane (p, q) = (lane / 4, lane % 4): positions 2 p, 2 p + 1 of the
  // warp's 16, its 8 channels lane_channel(q, .)
  const int q = lane & 3;
  float w[8][6], sh[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = lane_channel<T>(q, i);
    const float4 wa = *reinterpret_cast<const float4*>(w1s + c * WP);
    const float4 wb = *reinterpret_cast<const float4*>(w1s + c * WP + 4);
    w[i][0] = wa.x; w[i][1] = wa.y; w[i][2] = wa.z; w[i][3] = wa.w;
    w[i][4] = wb.x; w[i][5] = wb.y;
    sh[i] = wb.z;
  }
  T* y1b = y1 + b * rows * T_out * C1;
#pragma unroll 2
  for (int i = warp * 8 + (lane >> 2); i < rows * (NF / 2);
       i += 8 * (NTHREADS / 32)) {
    const int r = i / (NF / 2), j = 2 * (i % (NF / 2)), t = t0 + j;
    if (j >= TT || t >= T_out) continue;
    const float* top = fr + r * FP + j;
    const float2 a0 = *reinterpret_cast<const float2*>(top);
    const float2 a1 = *reinterpret_cast<const float2*>(top + 2);
    const float2 b0 = *reinterpret_cast<const float2*>(top + FP);
    const float2 b1 = *reinterpret_cast<const float2*>(top + FP + 2);
    const float z0[6] = {a0.x, a0.y, a1.x, b0.x, b0.y, b1.x};
    const float z1[6] = {a0.y, a1.x, a1.y, b0.y, b1.x, b1.y};
    float v0[8], v1[8];
    conv1_selu(w, sh, z0, v0);
    conv1_selu(w, sh, z1, v1);
    T* yo = y1b + ((long long)r * T_out + t) * C1;
    store8(yo, q, v0);
    if (t + 1 < T_out) store8(yo + C1, q, v1);
  }
}

// Folded taps and the rows of both frame tiles that no item writes: row 0
// (frame row -1) and rows F + 1 .. FR_ROWS - 1.
template <int FP, int NTHREADS>
__device__ __forceinline__ void setup_tables(float* w1s, float* frs,
                                            const float* __restrict__ w1,
                                            const float* __restrict__ sh1,
                                            int F_out) {
  for (int i = threadIdx.x; i < C1 * WP; i += NTHREADS) {
    const int c = i / WP, k = i % WP;
    w1s[i] = k < 6 ? w1[c * 6 + k] : (k == 6 ? sh1[c] : 0.f);
  }
  for (int i = threadIdx.x; i < 2 * FR_ROWS * FP; i += NTHREADS) {
    const int r = (i / FP) % FR_ROWS;
    if (r == 0 || r > F_out) frs[i] = 0.f;
  }
}

// ------------------------------------------------------------------ bf16
namespace dot {
constexpr int KPAD = 144;                // taps padded to 9 k-steps of 16
constexpr int KSTEPS = KPAD / 16;
constexpr int NT = 9;                    // n8 tiles: 72 filter columns
constexpr int MT = 3;                    // m16 tiles: 48 positions a warp
constexpr int WROWS = 8 * (NT + 1);      // bank columns in shared memory
constexpr int WS = 152;                  // bf16 stride of a bank column
constexpr int PWARPS = 4;                // producers (the conv)
constexpr int CWARPS = 8;                // consumers (conv1, the stores)
constexpr int SUB = HEADP_SUB;           // 48-position sub-tiles a producer
static_assert(SUB == 2 || SUB == 4 || SUB == 8, "HEADP_SUB is 2, 4 or 8");
constexpr int PTHREADS = 32 * PWARPS;
constexpr int CTHREADS = 32 * CWARPS;
constexpr int THREADS = PTHREADS + CTHREADS;
constexpr int NF = 16 * SUB * PWARPS;    // frame-tile columns of an item
constexpr int TT = NF - 2;               // x0 / y1 columns of an item
constexpr int XS = 3 * NF + KPAD + 8;    // samples a copy of the tile
constexpr int FP = NF + 4;               // f32 pitch of a frame-tile row:
                                         // the pool's stores conflict-free
constexpr int XREG = (XS + PTHREADS - 1) / PTHREADS;  // prefetched by a
                                                      // producer
static_assert(XS % 8 == 0, "16-byte aligned copies");
}  // namespace dot

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
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

// Sample i of the item whose first pooled frame column is t0 - 1: x[b,
// 3 (t0 - 1) + i], zero outside the waveform.
__device__ __forceinline__ bf16 sample(const bf16* __restrict__ xb,
                                       long long s0, int i, int L) {
  const long long s = s0 + i;
  return (s >= 0 && s < L) ? xb[s] : __float2bfloat16(0.f);
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Named barriers: 0 is __syncthreads.
constexpr int BAR_PRODUCERS = 1;         // the producers among themselves
constexpr int BAR_FULL = 2;              // + buffer: frame tile written
constexpr int BAR_EMPTY = 4;             // + buffer: frame tile read

// The consumers' side of both kernels: warps 0 .. CTHREADS / 32 - 1 wait
// for frame tile s, store item k's x0 and y1 from it and hand it back
// (the producers wait for it only where an item k + 2 exists).
template <typename T, int NF, int FP, int CTHREADS, int THREADS>
__device__ __forceinline__ void consume(const float* frs, const float* w1s,
                                        T* __restrict__ y1,
                                        T* __restrict__ x0, int rows,
                                        int T_out, int n_tiles, int n_work) {
  for (int k = 0;; ++k) {
    const int work = blockIdx.x + k * gridDim.x;
    if (work >= n_work) break;
    const int s = k & 1;
    bar_sync(BAR_FULL + s, THREADS);
    head_store<T, NF, FP, CTHREADS>(frs + s * FR_ROWS * FP, w1s, y1, x0,
                                    work / n_tiles,
                                    (work % n_tiles) * (NF - 2), rows, T_out);
    if (work + 2 * gridDim.x < n_work) bar_arrive(BAR_EMPTY + s, THREADS);
  }
}

// Work item w: batch row w / n_tiles, x0 / y1 columns [(w % n_tiles) TT,
// + TT), its frame tile one column wider on each side.  Warp roles: PWARPS
// producers run csrc/frontend_dot.cu's conv, pool, BN and SELU on the
// item's 3 NF + 144 samples (kept in two copies, the second one sample on,
// so that every A register's bf16 pair is 4-byte aligned in one of them)
// into frame tile k % 2; CWARPS consumers store x0 and y1 from it.  The
// hand-off is by named barriers, as csrc/block0_pipe.cu's: producers fill
// item k + 1's tile while consumers store item k's, and load item k + 1's
// samples into registers before item k's conv.
__global__ void __launch_bounds__(dot::THREADS, 1)
head_dot_kernel(const bf16* __restrict__ x, const bf16* __restrict__ bank,
                const float* __restrict__ sc, const float* __restrict__ w1,
                const float* __restrict__ sh1, bf16* __restrict__ y1,
                bf16* __restrict__ x0, int L, int F_out, int T_out,
                int n_tiles, int n_work) {
  using namespace dot;
  extern __shared__ float4 smem4[];
  float* w1s = reinterpret_cast<float*>(smem4);      // C1 x WP
  bf16* ws = reinterpret_cast<bf16*>(w1s + C1 * WP);  // bank [column][tap]
  bf16* xs0 = ws + WROWS * WS;                        // the samples
  bf16* xs1 = xs0 + XS;                               // one sample on
  float* frs = reinterpret_cast<float*>(xs1 + XS);    // two frame tiles

  const int tid = threadIdx.x;
  const bf16 zero = __float2bfloat16(0.f);

  // bank column 8 n + col of n8 tile n is the filter the accumulator
  // layout wants there (csrc/frontend_dot.cu)
  for (int i = tid; i < WROWS * WS; i += THREADS) {
    const int row = i / WS, k = i % WS;
    const int n = row >> 3, col = row & 7;
    const int c = 2 * n + (col & 1);
    const int p = 6 * (col >> 1) + c / 3;
    const int f = 3 * p + c % 3;
    ws[i] = (n < NT && p < F_out && k < KSIZE) ? bank[f * KSIZE + k] : zero;
  }
  setup_tables<FP, THREADS>(w1s, frs, w1, sh1, F_out);
  if (blockIdx.x < n_work) {
    const int w = blockIdx.x;
    const long long s0 = 3LL * ((w % n_tiles) * TT - 1);
    const bf16* xb = x + (long long)(w / n_tiles) * L;
    for (int i = tid; i < XS; i += THREADS) {
      const bf16 v = sample(xb, s0, i, L);
      xs0[i] = v;
      if (i > 0) xs1[i - 1] = v;
    }
    if (tid == 0) xs1[XS - 1] = zero;
  }
  __syncthreads();

  if (tid < CTHREADS) {
    consume<bf16, NF, FP, CTHREADS, THREADS>(frs, w1s, y1, x0, F_out + 1,
                                             T_out, n_tiles, n_work);
    return;
  }
  // ------------------------------------------------------------ producers
  const int ptid = tid - CTHREADS, lane = ptid & 31, pw = ptid >> 5;
  const float scale = sc[0], shift = sc[1];
  const int g = lane >> 2, q4 = lane & 3;
  uint32_t a_addr[2 * MT];
#pragma unroll
  for (int s = 0; s < 2 * MT; ++s) {
    const int pos = 3 * (g + 8 * (s / 3)) + s % 3 + 48 * SUB * pw;
    const int par = pos & 1;
    a_addr[s] = smem_u32(par ? xs1 : xs0) + (pos - par + 2 * q4) * 2;
  }
  const uint32_t b_base =
      smem_u32(ws) +
      ((((lane >> 4) * 8 + (lane & 7)) * WS) + ((lane >> 3) & 1) * 8) * 2;

  for (int k = 0;; ++k) {
    const int work = blockIdx.x + k * gridDim.x;
    if (work >= n_work) break;
    const int s = k & 1, t0 = (work % n_tiles) * TT;
    const int next = work + gridDim.x;
    bf16 pre[XREG];                      // the next item's samples
    if (next < n_work) {
      const long long s0 = 3LL * ((next % n_tiles) * TT - 1);
      const bf16* xb = x + (long long)(next / n_tiles) * L;
#pragma unroll
      for (int j = 0; j < XREG; ++j)
        pre[j] = sample(xb, s0, ptid + j * PTHREADS, L);
    }
    if (k >= 2) bar_sync(BAR_EMPTY + s, THREADS);   // item k - 2 stored
    float* fr = frs + s * FR_ROWS * FP;

    // frame columns t0 - 1 .. t0 + NF - 2, x0 rounded to bf16
#pragma unroll 1
    for (int sub = 0; sub < SUB; ++sub) {
      float acc[MT][NT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
      const uint32_t xoff = sub * 48 * 2;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t bf[NT + 1][2];
#pragma unroll
        for (int j = 0; j < (NT + 1) / 2; ++j)
          ldmatrix_x4(b_base + (j * 16 * WS + ks * 16) * 2, bf[2 * j][0],
                      bf[2 * j][1], bf[2 * j + 1][0], bf[2 * j + 1][1]);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const uint32_t lo = a_addr[2 * m] + xoff + ks * 32;
          const uint32_t hi = a_addr[2 * m + 1] + xoff + ks * 32;
          uint32_t a[4];
          a[0] = lds32(lo);
          a[1] = lds32(hi);
          a[2] = lds32(lo + 16);
          a[3] = lds32(hi + 16);
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_bf16(acc[m][n], a, bf[n]);
        }
      }
      // window (u, i): row slots 3 u .. 3 u + 2 are frame column col0 +
      // 8 u, column slots 3 i .. 3 i + 2 pooled row 6 q4 + i
      const int col0 = 16 * (SUB * pw + sub) + g;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int p = 6 * q4 + i;
        if (p >= F_out) continue;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float mx = 0.f;
#pragma unroll
          for (int sl = 3 * u; sl < 3 * u + 3; ++sl)
#pragma unroll
            for (int c = 3 * i; c < 3 * i + 3; ++c)
              mx = fmaxf(mx,
                         fabsf(acc[sl >> 1][c >> 1][2 * (sl & 1) + (c & 1)]));
          const int col = col0 + 8 * u, t = t0 - 1 + col;
          fr[(p + 1) * FP + col] =
              (t >= 0 && t < T_out)
                  ? __bfloat162float(
                        __float2bfloat16(selu_ref(mx * scale + shift)))
                  : 0.f;
        }
      }
    }
    bar_arrive(BAR_FULL + s, THREADS);
    bar_sync(BAR_PRODUCERS, PTHREADS);       // every producer is done with
    if (next < n_work) {                     // this item's samples
#pragma unroll
      for (int j = 0; j < XREG; ++j) {
        const int i = ptid + j * PTHREADS;
        if (i < XS) {
          xs0[i] = pre[j];
          if (i > 0) xs1[i - 1] = pre[j];
        }
      }
      if (ptid == 0) xs1[XS - 1] = zero;
    }
    bar_sync(BAR_PRODUCERS, PTHREADS);
  }
}

// ------------------------------------------------------------------- f32
namespace ffma {
constexpr int P = 5;                     // pooled columns a thread
constexpr int CW = 3 * P;                // conv positions a thread
constexpr int WARPS_T = 2;               // producer warps along time
constexpr int WARPS_R = 4;               // producer warps along pooled rows
constexpr int PTHREADS = 32 * WARPS_T * WARPS_R;
constexpr int CTHREADS = 256;            // consumers
constexpr int THREADS = PTHREADS + CTHREADS;
constexpr int NF = 32 * P * WARPS_T;     // frame-tile columns of an item
constexpr int TT = NF - 2;               // x0 / y1 columns of an item
constexpr int TILE_X = 3 * NF + KSIZE - 1;   // samples an item
constexpr int FP = NF + 4;               // f32 pitch of a frame-tile row
}  // namespace ffma

// 4 bytes global -> shared, zero-filled when !valid (src-size 0).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Item w's samples 3 (t0 - 1) .. + TILE_X - 1, zero outside the waveform;
// producer thread ptid.
__device__ __forceinline__ void stage_tile(float* xs, const float* x, int w,
                                           int n_tiles, int L, int ptid) {
  using namespace ffma;
  const long long s0 = 3LL * ((w % n_tiles) * TT - 1);
  const float* xb = x + (long long)(w / n_tiles) * L;
  for (int i = ptid; i < TILE_X; i += PTHREADS) {
    const long long s = s0 + i;
    const bool in = s >= 0 && s < L;
    cp_async4(xs + i, in ? xb + s : xb, in);
  }
}

// One tap kk of a chunk that starts at tap k0 (k0 % CW == 0): ring[(j + kk)
// % CW] holds sample j + k0 + kk of this thread's window (as
// csrc/frontend_ffma.cu).
template <int KK>
__device__ __forceinline__ void tap(float (&acc)[3][ffma::CW],
                                    float (&ring)[ffma::CW], const float* xw,
                                    const float* w0, int k0) {
  constexpr int CW = ffma::CW;
  ring[(KK + CW - 1) % CW] = xw[k0 + KK + CW - 1];
  const float a0 = w0[k0 + KK], a1 = w0[KSIZE + k0 + KK],
              a2 = w0[2 * KSIZE + k0 + KK];
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    const float v = ring[(j + KK) % CW];
    acc[0][j] = fmaf(a0, v, acc[0][j]);
    acc[1][j] = fmaf(a1, v, acc[1][j]);
    acc[2][j] = fmaf(a2, v, acc[2][j]);
  }
}

template <int N, int KK = 0>
__device__ __forceinline__ void taps(float (&acc)[3][ffma::CW],
                                     float (&ring)[ffma::CW], const float* xw,
                                     const float* w0, int k0) {
  if constexpr (KK < N) {
    tap<KK>(acc, ring, xw, w0, k0);
    taps<N, KK + 1>(acc, ring, xw, w0, k0);
  }
}

// Work item w: as head_dot_kernel's, TT = 318 columns.  Producer warp (wt,
// wr) computes frame columns [32 P wt, + 32 P) of the item at pooled rows
// wr, wr + WARPS_R, ... into frame tile k % 2, its samples from a cp.async
// double buffer; the consumers store x0 and y1 from it, hand-offs as in
// head_dot_kernel.  Shared memory: the folded taps, two frame tiles, two
// waveform tiles, the bank (3 F filters x 129 taps).
__global__ void __launch_bounds__(ffma::THREADS, 1)
head_fma_kernel(const float* __restrict__ x, const float* __restrict__ bank,
                const float* __restrict__ sc, const float* __restrict__ w1,
                const float* __restrict__ sh1, float* __restrict__ y1,
                float* __restrict__ x0, int L, int F_out, int T_out,
                int n_tiles, int n_work) {
  using namespace ffma;
  extern __shared__ float4 smem4[];
  float* w1s = reinterpret_cast<float*>(smem4);     // C1 x WP
  float* frs = w1s + C1 * WP;                        // two frame tiles
  float* xbuf = frs + 2 * FR_ROWS * FP;              // two waveform tiles
  float* ws = xbuf + 2 * TILE_X;                     // 3 F_out x KSIZE

  const int tid = threadIdx.x;
  if (tid >= CTHREADS) {
    const int ptid = tid - CTHREADS;
    for (int i = ptid; i < 3 * F_out * KSIZE; i += PTHREADS)
      cp_async4(ws + i, bank + i, true);
    if (blockIdx.x < n_work) stage_tile(xbuf, x, blockIdx.x, n_tiles, L, ptid);
    cp_async_commit();
  }
  setup_tables<FP, THREADS>(w1s, frs, w1, sh1, F_out);
  __syncthreads();

  if (tid < CTHREADS) {
    consume<float, NF, FP, CTHREADS, THREADS>(frs, w1s, y1, x0, F_out + 1,
                                              T_out, n_tiles, n_work);
    return;
  }
  // ------------------------------------------------------------ producers
  const int ptid = tid - CTHREADS, lane = ptid & 31, pw = ptid >> 5;
  const float scale = sc[0], shift = sc[1];
  const int wt = pw % WARPS_T, wr = pw / WARPS_T;
  const int col0 = (wt * 32 + lane) * P;   // first frame column in the tile

  for (int k = 0;; ++k) {
    const int work = blockIdx.x + k * gridDim.x;
    if (work >= n_work) break;
    const int s = k & 1, t0 = (work % n_tiles) * TT;
    const int next = work + gridDim.x;
    if (next < n_work)
      stage_tile(xbuf + ((k + 1) & 1) * TILE_X, x, next, n_tiles, L, ptid);
    cp_async_commit();
    cp_async_wait<1>();
    bar_sync(BAR_PRODUCERS, PTHREADS);         // this item's tile landed
    if (k >= 2) bar_sync(BAR_EMPTY + s, THREADS);   // item k - 2 stored
    float* fr = frs + s * FR_ROWS * FP;
    const float* xw = xbuf + s * TILE_X + 3 * col0;
    for (int r = wr; r < F_out; r += WARPS_R) {
      const float* w0 = ws + 3 * r * KSIZE;
      float acc[3][CW];
#pragma unroll
      for (int f = 0; f < 3; ++f)
#pragma unroll
        for (int j = 0; j < CW; ++j) acc[f][j] = 0.f;
      float ring[CW];
#pragma unroll
      for (int j = 0; j < CW - 1; ++j) ring[j] = xw[j];
#pragma unroll 1
      for (int k0 = 0; k0 + CW <= KSIZE; k0 += CW)
        taps<CW>(acc, ring, xw, w0, k0);
      taps<KSIZE % CW>(acc, ring, xw, w0, KSIZE - KSIZE % CW);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int t = t0 - 1 + col0 + p;
        float m = 0.f;
#pragma unroll
        for (int f = 0; f < 3; ++f)
#pragma unroll
          for (int j = 3 * p; j < 3 * p + 3; ++j)
            m = fmaxf(m, fabsf(acc[f][j]));
        fr[(r + 1) * FP + col0 + p] =
            (t >= 0 && t < T_out) ? selu_ref(m * scale + shift) : 0.f;
      }
    }
    bar_arrive(BAR_FULL + s, THREADS);
    bar_sync(BAR_PRODUCERS, PTHREADS);   // this waveform tile is read: item
                                         // k + 2 may land in it
  }
  cp_async_wait<0>();
}

template <typename K>
cudaError_t persistent_grid(K kernel, int threads, size_t smem,
                            long long n_work, int* grid) {
  cudaError_t e;
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
  *grid = (int)(n_work < blocks ? n_work : blocks);
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x (B, L) and bank (C, 129) of that
// type, C / 3 <= 24; float32 on the device: sc = {scale, shift} of the
// frontend's BN, w1 (32, 6) conv1 taps [df*3+dt] times the bn2 scale, sh1
// (32) the folded shift.  y1 (B, 32, C/3 + 1, (L-128)/3) of x's type stored
// channels last, (B, C/3 + 1, (L-128)/3, 32) in memory, and x0 (B, C/3 +
// 1, (L-128)/3); channels must be 32.  Returns the launch's cudaError_t (0
// on success).
extern "C" int aasist_frontend_head_pipe(const void* x, const void* bank,
                                         const float* sc, const float* w1,
                                         const float* sh1, void* y1, void* x0,
                                         int B, int L, int C, int channels,
                                         int dtype, void* stream) {
  const int F_out = C / 3;
  const int T_out = (L - (KSIZE - 1)) / 3;
  if (channels != C1 || B <= 0 || F_out <= 0 || F_out > MAXF || T_out <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  int grid = 0;
  if (dtype == 1) {
    const int n_tiles = (T_out + dot::TT - 1) / dot::TT;
    const long long n_work = (long long)B * n_tiles;
    if (n_work >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    const size_t smem = (C1 * WP + 2 * FR_ROWS * dot::FP) * sizeof(float) +
                        (dot::WROWS * dot::WS + 2 * dot::XS) * sizeof(bf16);
    if ((e = cudaFuncSetAttribute(
             head_dot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)) != cudaSuccess)
      return (int)e;
    if ((e = persistent_grid(head_dot_kernel, dot::THREADS, smem, n_work,
                             &grid)) != cudaSuccess)
      return (int)e;
    head_dot_kernel<<<grid, dot::THREADS, smem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(bank), sc, w1,
        sh1, static_cast<bf16*>(y1), static_cast<bf16*>(x0), L, F_out, T_out,
        n_tiles, (int)n_work);
    return (int)cudaGetLastError();
  }
#if !defined(HEADP_BF16ACC)
  if (dtype == 0) {
    const int n_tiles = (T_out + ffma::TT - 1) / ffma::TT;
    const long long n_work = (long long)B * n_tiles;
    if (n_work >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    const size_t smem = (C1 * WP + 2 * FR_ROWS * ffma::FP +
                         2 * ffma::TILE_X + 3 * (size_t)F_out * KSIZE) *
                        sizeof(float);
    if ((e = cudaFuncSetAttribute(
             head_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)) != cudaSuccess)
      return (int)e;
    if ((e = persistent_grid(head_fma_kernel, ffma::THREADS, smem, n_work,
                             &grid)) != cudaSuccess)
      return (int)e;
    head_fma_kernel<<<grid, ffma::THREADS, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(bank), sc,
        w1, sh1, static_cast<float*>(y1), static_cast<float*>(x0), L, F_out,
        T_out, n_tiles, (int)n_work);
    return (int)cudaGetLastError();
  }
#endif
  return (int)cudaErrorInvalidValue;
}
