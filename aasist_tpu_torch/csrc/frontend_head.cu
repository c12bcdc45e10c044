// The sinc frontend fused with the head of residual block 0, for Hopper
// (sm_90a), eval mode:
//
//   x0 = selu(bn(maxpool(3,3)(|sinc conv(x)|)))      (B, 23, T) for C = 70
//   y1 = selu(bn2(conv1(x0)))      conv1 1 -> 32, (2,3), pad (1,1)
//
// (B, L) waveform in; y1 (B, 32, F + 1, T) and the frontend frame x0
// (B, F + 1, T) out, F = C / 3, T = (L-128)/3, row F of x0 zero, both in the
// input's type (float or bf16).  Sums are f32; x0 is rounded to the output
// type before conv1 reads it (the plain chain's conv1 reads the stored
// frontend), y1 once at the store.  bn2 and conv1's bias are folded into
// conv1's taps and one shift per channel on the host side of the call.
//
// Replaces the TPU kernel tools/probe_feb0_ablate.py:kernel (launched by
// run).  That kernel stores y1 and x0 in one channel-major (33, 24, B, T)
// array, Mosaic's native layout, runs conv1 as a K = 7 dot whose seventh
// "ones" tap carries the shift, and reads mod-3 phase planes; none of that
// carries over: the outputs are NCHW, the shift starts the accumulator, and
// the pool reads three neighbouring values.
//
// What bounds it on the H100.  At B = 128, L = 64,600 it writes 33 x 24 x
// 128 x 21,490 values, 4.36 GB in bf16 and 8.71 GB in f32, for 1.72e11
// FLOP: bound by the bytes it writes (~1.3 ms bf16, ~2.6 ms f32 at
// 3.35 TB/s).
//
// What the design does about it.  One block owns a batch row and a tile of
// pooled columns.  Phase 1 is the frontend of csrc/fused_frontend.cu (f32
// FMAs on the CUDA cores, 3 filters x 15 positions of accumulators and a
// sliding sample window per thread) into a frame tile in shared memory with
// one column of halo on each side and a zero row above and below, so conv1's
// paddings are read as data.  Phase 2 walks (y1 row, column) pairs, lanes
// along time: six frame values into registers, then for each of the 32
// channels six FMAs from warp-broadcast taps, the SELU and one store, so
// every warp store is one contiguous run.  The conv and the stores run one
// after the other inside a block; several blocks per SM overlap them.
//
// conv1 sees zeros at frame row -1, row F, t = -1 and t >= T.  y1 is not
// masked: at the edges it is SELU of the folded shift plus what the
// neighbours give.  (csrc/fused_block0.cu zeroes its y1 tile at t = -1 and
// t >= T instead, because its conv2 pads there.)
//
// Compile-time variants, for aasist_tpu_torch/tools/probe_feb0_ablate.py:
//   HEAD_WARPS_T  warps along time, 1, 2 (default) or 4: the frame tile is
//                 160 * HEAD_WARPS_T columns wide;
//   HEAD_NOSELU   y1 stored without its SELU;
//   HEAD_NODOT    no conv1: x0 broadcast to the 32 channels (the frontend
//                 plus the write floor);
//   HEAD_BF16ACC  conv1 accumulated in bf16 (__hfma2, two channels a
//                 time); bf16 only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#ifndef HEAD_WARPS_T
#define HEAD_WARPS_T 2
#endif

namespace {

constexpr int KSIZE = 129;               // sinc taps
constexpr int C1 = 32;                   // conv1 output channels
constexpr int P = 5;                     // pooled columns per thread
constexpr int CW = 3 * P;                // conv positions per thread
constexpr int WARPS_T = HEAD_WARPS_T;    // warps along time
constexpr int WARPS_R = 8 / WARPS_T;     // warps along pooled rows
static_assert(WARPS_T * WARPS_R == 8, "HEAD_WARPS_T is 1, 2, 4 or 8");
constexpr int THREADS = 256;
constexpr int FW = 32 * P * WARPS_T;     // frame-tile columns: t0 - 1 ...
constexpr int TILE = FW - 2;             // y1 / x0 columns per block
constexpr int TILE_X = 3 * FW + KSIZE - 1;   // waveform samples per block
constexpr int WP = 8;                    // floats per channel of folded taps

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
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

// grid (ceil(T / TILE), B); block THREADS.  Shared memory: the folded conv1
// taps w1s[channel] = {6 taps [df*3+dt], shift, 0}, the waveform tile, the
// bank, and the frame tile fr[row][column] with row 0 = frame row -1 and
// column j = time t0 - 1 + j.
template <typename T>
__global__ void __launch_bounds__(THREADS)
frontend_head_kernel(const T* __restrict__ x, const T* __restrict__ bank,
                     const float* __restrict__ sc,
                     const float* __restrict__ w1,
                     const float* __restrict__ sh1, T* __restrict__ y1,
                     T* __restrict__ x0, int L, int F_out, int T_out) {
  extern __shared__ float4 smem4[];
  float* w1s = reinterpret_cast<float*>(smem4);   // C1 x WP, 16-byte aligned
  float* xs = w1s + C1 * WP;                // TILE_X samples
  float* ws = xs + TILE_X;                  // 3*F_out filters x KSIZE taps
  float* fr = ws + 3 * F_out * KSIZE;       // (F_out + 2) x FW

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TILE;         // first y1 column of the block
  const long long s0 = 3LL * (t0 - 1);      // first sample of the tile
  const T* xb = x + (long long)b * L;
  for (int i = threadIdx.x; i < TILE_X; i += THREADS) {
    const long long s = s0 + i;
    xs[i] = (s >= 0 && s < L) ? to_f32(xb[s]) : 0.f;
  }
  const int nw = 3 * F_out * KSIZE;
  for (int i = threadIdx.x; i < nw; i += THREADS) ws[i] = to_f32(bank[i]);
  for (int i = threadIdx.x; i < C1 * WP; i += THREADS) {
    const int c = i / WP, k = i % WP;
    w1s[i] = k < 6 ? w1[c * 6 + k] : (k == 6 ? sh1[c] : 0.f);
  }
  for (int i = threadIdx.x; i < FW; i += THREADS) {
    fr[i] = 0.f;
    fr[(F_out + 1) * FW + i] = 0.f;
  }
  __syncthreads();

  // ---- phase 1: the frontend at columns t0 - 1 .. t0 - 2 + FW, rounded to
  // the output type, zero outside 0 <= t < T_out
  {
    const float scale = sc[0], shift = sc[1];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wt = warp % WARPS_T, wr = warp / WARPS_T;
    const int col0 = (wt * 32 + lane) * P;   // first frame column
    const float* xw = xs + 3 * col0;         // first sample of this thread

    for (int r = wr; r < F_out; r += WARPS_R) {
      const float* wf = ws + 3 * r * KSIZE;
      float acc[3][CW];
#pragma unroll
      for (int f = 0; f < 3; ++f)
#pragma unroll
        for (int j = 0; j < CW; ++j) acc[f][j] = 0.f;
      float win[CW];                         // win[j] = x[conv pos j + tap k]
#pragma unroll
      for (int j = 0; j < CW - 1; ++j) win[j] = xw[j];
#pragma unroll
      for (int k = 0; k < KSIZE; ++k) {
        win[CW - 1] = xw[k + CW - 1];
        const float a0 = wf[k], a1 = wf[KSIZE + k], a2 = wf[2 * KSIZE + k];
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          acc[0][j] = fmaf(a0, win[j], acc[0][j]);
          acc[1][j] = fmaf(a1, win[j], acc[1][j]);
          acc[2][j] = fmaf(a2, win[j], acc[2][j]);
        }
#pragma unroll
        for (int j = 0; j < CW - 1; ++j) win[j] = win[j + 1];
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int t = t0 - 1 + col0 + p;
        float m = 0.f;
#pragma unroll
        for (int f = 0; f < 3; ++f)
#pragma unroll
          for (int j = 3 * p; j < 3 * p + 3; ++j)
            m = fmaxf(m, fabsf(acc[f][j]));
        const float v = to_f32(from_f32<T>(selu(m * scale + shift)));
        fr[(r + 1) * FW + col0 + p] = (t >= 0 && t < T_out) ? v : 0.f;
      }
    }
  }
  __syncthreads();

  // ---- phase 2: x0 and y1 at columns t0 .. t0 + TILE - 1
  const int rows = F_out + 1;
  T* x0b = x0 + (long long)b * rows * T_out;
  T* y1b = y1 + (long long)b * C1 * rows * T_out;
  const long long plane = (long long)rows * T_out;   // one channel of y1
  for (int i = threadIdx.x; i < rows * TILE; i += THREADS) {
    const int r = i / TILE, j = i % TILE;
    const int t = t0 + j;
    if (t >= T_out) continue;
    // frame rows r - 1 (top) and r (bottom) at times t - 1 .. t + 1
    const float* top = fr + r * FW + j;
    const float z0 = top[0], z1 = top[1], z2 = top[2];
    const float z3 = top[FW], z4 = top[FW + 1], z5 = top[FW + 2];
    const long long o = (long long)r * T_out + t;
    x0b[o] = from_f32<T>(z4);
    T* yo = y1b + o;
#if defined(HEAD_NODOT)
#pragma unroll 8
    for (int c = 0; c < C1; ++c) yo[c * plane] = from_f32<T>(z4);
#elif defined(HEAD_BF16ACC)
    const __nv_bfloat162 q0 = __float2bfloat162_rn(z0),
                         q1 = __float2bfloat162_rn(z1),
                         q2 = __float2bfloat162_rn(z2),
                         q3 = __float2bfloat162_rn(z3),
                         q4 = __float2bfloat162_rn(z4),
                         q5 = __float2bfloat162_rn(z5);
#pragma unroll 4
    for (int c = 0; c < C1; c += 2) {
      const float4 wa = *reinterpret_cast<const float4*>(w1s + c * WP);
      const float4 wb = *reinterpret_cast<const float4*>(w1s + c * WP + 4);
      const float4 wc = *reinterpret_cast<const float4*>(w1s + c * WP + 8);
      const float4 wd = *reinterpret_cast<const float4*>(w1s + c * WP + 12);
      __nv_bfloat162 a = __floats2bfloat162_rn(wb.z, wd.z);
      a = __hfma2(__floats2bfloat162_rn(wa.x, wc.x), q0, a);
      a = __hfma2(__floats2bfloat162_rn(wa.y, wc.y), q1, a);
      a = __hfma2(__floats2bfloat162_rn(wa.z, wc.z), q2, a);
      a = __hfma2(__floats2bfloat162_rn(wa.w, wc.w), q3, a);
      a = __hfma2(__floats2bfloat162_rn(wb.x, wd.x), q4, a);
      a = __hfma2(__floats2bfloat162_rn(wb.y, wd.y), q5, a);
      const float2 f = __bfloat1622float2(a);
#if defined(HEAD_NOSELU)
      yo[c * plane] = from_f32<T>(f.x);
      yo[(c + 1) * plane] = from_f32<T>(f.y);
#else
      yo[c * plane] = from_f32<T>(selu_fast(f.x));
      yo[(c + 1) * plane] = from_f32<T>(selu_fast(f.y));
#endif
    }
#else
#pragma unroll 8
    for (int c = 0; c < C1; ++c) {
      const float4 wa = *reinterpret_cast<const float4*>(w1s + c * WP);
      const float4 wb = *reinterpret_cast<const float4*>(w1s + c * WP + 4);
      float a = wb.z;                        // the folded shift
      a = fmaf(wa.x, z0, a);
      a = fmaf(wa.y, z1, a);
      a = fmaf(wa.z, z2, a);
      a = fmaf(wa.w, z3, a);
      a = fmaf(wb.x, z4, a);
      a = fmaf(wb.y, z5, a);
#if defined(HEAD_NOSELU)
      yo[c * plane] = from_f32<T>(a);
#else
      yo[c * plane] = from_f32<T>(sizeof(T) == 4 ? selu(a) : selu_fast(a));
#endif
    }
#endif
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* bank, const float* sc,
                   const float* w1, const float* sh1, void* y1, void* x0,
                   int B, int L, int F_out, int T_out, cudaStream_t stream) {
  const size_t smem = (TILE_X + 3 * (size_t)F_out * KSIZE +
                       (size_t)(F_out + 2) * FW + C1 * WP) * sizeof(float);
  auto kernel = frontend_head_kernel<T>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T_out + TILE - 1) / TILE, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bank), sc, w1, sh1,
      static_cast<T*>(y1), static_cast<T*>(x0), L, F_out, T_out);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x (B, L) and bank (C, 129) of that
// type; float32 on the device: sc = {scale, shift} of the frontend's BN,
// w1 (32, 6) conv1 taps [df*3+dt] times the bn2 scale, sh1 (32) the folded
// shift.  y1 (B, 32, C/3 + 1, (L-128)/3) and x0 (B, C/3 + 1, (L-128)/3) of
// x's type; channels must be 32.  Returns the launch's cudaError_t (0 on
// success).
extern "C" int aasist_frontend_head(const void* x, const void* bank,
                                    const float* sc, const float* w1,
                                    const float* sh1, void* y1, void* x0,
                                    int B, int L, int C, int channels,
                                    int dtype, void* stream) {
  const int F_out = C / 3;
  const int T_out = (L - (KSIZE - 1)) / 3;
  if (channels != C1 || B <= 0 || B > 65535 || F_out <= 0 || T_out <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
#if !defined(HEAD_BF16ACC)
    case 0:
      return (int)launch<float>(x, bank, sc, w1, sh1, y1, x0, B, L, F_out,
                                T_out, s);
#endif
    case 1:
      return (int)launch<__nv_bfloat16>(x, bank, sc, w1, sh1, y1, x0, B, L,
                                        F_out, T_out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
