// The sinc frontend in float32 on Hopper's tensor cores (sm_90a), with
// f32-accurate products by the 3xTF32 split: sinc conv1d (C filters x 129
// taps) -> |.| -> max pool (3,3) over (filter, time), floor semantics ->
// eval BatchNorm of one channel folded to a scalar scale/shift -> SELU.
// (B, L) float32 waveform in; F = C/3 rows by T = (L-128)/3 columns per
// batch row out, float32, stored as
//
//   the Scorer's (B, 1, F, T)                     aasist_frontend_f32_plain
//   the zero-bordered frame (B, F + 2, T + 2)     aasist_frontend_f32_padded
//
// the function of csrc/fused_frontend.cu's float kernel
// (fused_frontend_kernel<float, *>), which it replaces on the f32 path; that
// kernel stays as the version this one is measured against.
//
// Replaces the TPU kernels aasist_tpu/ops/fused_frontend.py:_kernel
// (launched by _run) and, in its padded store, tools/fused_stack.py:
// _fe_kernel (launched by _fe_run), in float32.
//
// What bounds it on the H100.  At B = 128, L = 64,600 the conv is
// 2 * 128 * 69 * 64,470 * 129 = 1.47e11 FLOP against ~66 MB of f32 in and
// out: compute-bound.  On the CUDA cores (67 TFLOP/s f32) the floor is
// 2.19 ms, and csrc/fused_frontend.cu runs at about half of it.  The tensor
// cores take f32 operands only as TF32 (a 10-bit mantissa), which would
// miss the f32 path's gate; the 3xTF32 split keeps f32 accuracy at three
// TF32 products each, 3 * 1.47e11 FLOP at 494.5 TFLOP/s dense: a floor of
// 0.89 ms.
//
// What the design does about it.
// - 3xTF32 (CUTLASS's OpMultiplyAddFastF32).  Each operand x is split into
//   hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest (ties away,
//   as cvt.rna: the low 13 bits of the f32 pattern rounded off), and each
//   product becomes lo*hi + hi*lo + hi*hi, summed in f32 on mma.sync
//   m16n8k8 .tf32; lo*lo is dropped (2^-22 relative).  The small terms of a
//   k-step go first into the accumulator, then the large one.
// - The bank is split once per block, into shared memory as (hi, lo) pairs
//   [filter column][tap] (one 64-bit load gives both; the pitch of 140
//   pairs puts a warp's loads in distinct banks); the waveform tile is
//   staged in f32 and each A value split in registers after its load.
// - The rest is csrc/frontend_dot.cu's design: an implicit GEMM over a
//   Toeplitz view of the waveform tile, D[position, filter] = sum_k
//   x[position + k] W[k, filter], 72 filter columns (9 n8 tiles) by taps
//   padded from 129 to 136 (17 k-steps of 8, one fewer than the bf16
//   kernel's 144); m16n8k8's accumulator layout is m16n8k16's, so the
//   rows and columns are assigned as there and the (3,3) pool runs on the
//   accumulators (each lane ends with 6 rows x 2 pooled columns); pooled
//   values go through a staging tile so that global stores run along time;
//   persistent blocks walk work items of (batch row, TILE pooled columns).
//   A TF32 A value is one sample, so the bf16 kernel's second, shifted copy
//   of the tile is not needed.
//
// Taps 129..135 are zero in the packed bank but their samples are read: a
// non-finite sample reaches 7 more positions than in the plain chain.
// Samples past L are staged as zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KSIZE = 129;               // sinc taps
constexpr int KPAD = 136;                // taps padded to 17 k-steps of 8
constexpr int KSTEPS = KPAD / 8;
constexpr int NT = 9;                    // n8 tiles: 72 filter columns
constexpr int MT = 3;                    // m16 tiles: 48 positions per warp
constexpr int ROWS = 24;                 // pooled rows the columns hold
constexpr int WCOLS = 8 * NT;            // bank columns in shared memory
constexpr int WS = 140;                  // (hi, lo) pairs a bank column
constexpr int WARPS = 4;                 // warps per block
constexpr int SUB = 2;                   // 48-position sub-tiles per warp
                                         // and work item
constexpr int BLOCKS = 2;                // blocks per SM
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 16 * SUB * WARPS;   // pooled columns per work item
constexpr int XS = 3 * TILE + KPAD + 8;  // samples of the tile
constexpr int OSW = TILE + 4;            // f32 pitch of a staging row
constexpr size_t SMEM =
    (size_t)WCOLS * WS * sizeof(float2) + (XS + ROWS * OSW) * sizeof(float);
static_assert(WS >= KPAD && WS % 32 == 12, "conflict-free bank loads");
static_assert((size_t)WCOLS * WS * sizeof(float2) % 16 == 0, "align");

__device__ __forceinline__ float selu(float z) {
  const float scale = 1.0507009873554805f, alpha = 1.6732632423543772f;
  return z > 0.f ? scale * z : (scale * alpha) * expm1f(z);
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

// The store layouts (the kernel's template parameter).
enum Layout { PLAIN = 0, PADDED = 1 };

// Work item w is batch row w / n_tiles, pooled columns
// [(w % n_tiles) TILE, + TILE) (ops/frontend_f32.py:f32_work states the
// same decomposition and the wrapper passes its n_tiles and n_work).
template <int LAYOUT>
__global__ void __launch_bounds__(THREADS, BLOCKS)
frontend_f32_kernel(const float* __restrict__ x,
                    const float* __restrict__ bank,
                    const float* __restrict__ sc, float* __restrict__ out,
                    int L, int F_out, int T_out, int n_tiles, int n_work) {
  extern __shared__ float4 smem4[];
  float2* ws = reinterpret_cast<float2*>(smem4);        // bank (hi, lo)
  float* xs = reinterpret_cast<float*>(ws + WCOLS * WS); // waveform tile
  float* os = xs + XS;                                   // pooled tile

  const int tid = threadIdx.x;

  // Bank column 8 n + col of n8 tile n is the filter that the accumulator
  // layout wants there: column slot c = 2 n + (col & 1) of lane-in-group
  // col >> 1 is filter 3 (6 (col >> 1) + c / 3) + c % 3.
  for (int i = tid; i < WCOLS * WS; i += THREADS) {
    const int row = i / WS, k = i % WS;
    const int n = row >> 3, col = row & 7;
    const int c = 2 * n + (col & 1);
    const int p = 6 * (col >> 1) + c / 3;
    const int f = 3 * p + c % 3;
    ws[i] = split(p < F_out && k < KSIZE ? bank[f * KSIZE + k] : 0.f);
  }

  const float scale = sc[0], shift = sc[1];
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q4 = lane & 3;

  // A rows: row slot s of this lane is position pos_s of the warp's first
  // sub-tile; a_off[s] is the index of x[pos_s + q4] in the tile.
  int a_off[2 * MT];
#pragma unroll
  for (int s = 0; s < 2 * MT; ++s)
    a_off[s] = 3 * (g + 8 * (s / 3)) + s % 3 + 48 * SUB * warp + q4;
  // B: n8 tile n's column g at taps q4 and q4 + 4 of a k-step
  const float2* b_base = ws + g * WS + q4;

  for (int work = blockIdx.x; work < n_work; work += gridDim.x) {
    const int b = work / n_tiles;
    const int t0 = (work % n_tiles) * TILE;
    __syncthreads();            // the bank is packed; last item's readers
                                // of xs and os are done
    const float* xb = x + (long long)b * L;
    const long long s0 = 3LL * t0;
    for (int i = tid; i < XS; i += THREADS)
      xs[i] = s0 + i < L ? xb[s0 + i] : 0.f;
    __syncthreads();

#pragma unroll 1
    for (int sub = 0; sub < SUB; ++sub) {
      float acc[MT][NT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

      const float* xsub = xs + 48 * sub;
#pragma unroll 1
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float2 v0 = b_base[n * 8 * WS + ks * 8];
          const float2 v1 = b_base[n * 8 * WS + ks * 8 + 4];
          bh[n][0] = __float_as_uint(v0.x);
          bl[n][0] = __float_as_uint(v0.y);
          bh[n][1] = __float_as_uint(v1.x);
          bl[n][1] = __float_as_uint(v1.y);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float* row_g = xsub + a_off[2 * m] + ks * 8;
          const float* row_g8 = xsub + a_off[2 * m + 1] + ks * 8;
          const float av[4] = {row_g[0], row_g8[0], row_g[4], row_g8[4]};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 hl = split(av[e]);
            ah[e] = __float_as_uint(hl.x);
            al[e] = __float_as_uint(hl.y);
          }
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_tf32(acc[m][n], al, bh[n]);
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_tf32(acc[m][n], ah, bl[n]);
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_tf32(acc[m][n], ah, bh[n]);
        }
      }

      // element e of tile (m, n): row slot 2 m + (e >> 1), column slot
      // 2 n + (e & 1).  Window (u, i): row slots 3 u .. 3 u + 2 are pooled
      // column g + 8 u, column slots 3 i .. 3 i + 2 are output row 6 q4 + i.
      const int col0 = 16 * (SUB * warp + sub) + g;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int p = 6 * q4 + i;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float mx = 0.f;
#pragma unroll
          for (int s = 3 * u; s < 3 * u + 3; ++s)
#pragma unroll
            for (int c = 3 * i; c < 3 * i + 3; ++c)
              mx = fmaxf(mx, fabsf(acc[s >> 1][c >> 1][2 * (s & 1) + (c & 1)]));
          os[p * OSW + col0 + 8 * u] =
              p < F_out ? selu(mx * scale + shift) : 0.f;
        }
      }
    }
    __syncthreads();

    if constexpr (LAYOUT == PLAIN) {
      float* ob = out + (long long)b * F_out * T_out + t0;
      for (int i = tid; i < F_out * TILE; i += THREADS) {
        const int p = i / TILE, col = i % TILE;
        if (t0 + col < T_out) ob[(long long)p * T_out + col] = os[p * OSW + col];
      }
    } else {
      // frame row p + 1, column t + 1 holds row p, time t; rows 0 and
      // F + 1 of this item's columns are zero, and the items at either end
      // of the row write columns 0 and T + 1
      const long long W = T_out + 2;
      float* ob = out + (long long)b * (F_out + 2) * W;
      for (int i = tid; i < (F_out + 2) * TILE; i += THREADS) {
        const int p = i / TILE, col = i % TILE;
        if (t0 + col < T_out)
          ob[p * W + t0 + col + 1] =
              (p == 0 || p == F_out + 1) ? 0.f : os[(p - 1) * OSW + col];
      }
      if (t0 == 0)
        for (int p = tid; p < F_out + 2; p += THREADS) ob[p * W] = 0.f;
      if (t0 + TILE >= T_out)
        for (int p = tid; p < F_out + 2; p += THREADS)
          ob[p * W + T_out + 1] = 0.f;
    }
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
  auto kernel = frontend_f32_kernel<LAYOUT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, SMEM)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long blocks = (long long)sms * per_sm;
  const int grid = (int)(n_work < blocks ? n_work : blocks);
  kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(bank), sc,
      static_cast<float*>(out), L, F_out, T_out, n_tiles, n_work);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, L) and bank (C, 129) float32, C / 3 <= 24; sc = {scale, shift}
// float32 on the device; out (B, 1, C/3, (L-128)/3) float32; n_tiles =
// ceil(T / 128) and n_work = B n_tiles (ops/frontend_f32.py:f32_work).
// Returns the launch's cudaError_t (0 on success).
extern "C" int aasist_frontend_f32_plain(const void* x, const void* bank,
                                         const float* sc, void* out, int B,
                                         int L, int C, int n_tiles,
                                         int n_work, void* stream) {
  return launch<PLAIN>(x, bank, sc, out, B, L, C, n_tiles, n_work, stream);
}

// As aasist_frontend_f32_plain, with out the zero-bordered
// (B, C/3 + 2, (L-128)/3 + 2) frame.
extern "C" int aasist_frontend_f32_padded(const void* x, const void* bank,
                                          const float* sc, void* out, int B,
                                          int L, int C, int n_tiles,
                                          int n_work, void* stream) {
  return launch<PADDED>(x, bank, sc, out, B, L, C, n_tiles, n_work, stream);
}
