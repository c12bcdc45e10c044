// Fused sinc frontend for Hopper (sm_90a): sinc conv1d (C filters x 129
// taps, f32 accumulation) -> |.| -> max pool (3,3) over (filter, time) with
// floor semantics -> eval BatchNorm of one channel folded to a scalar
// scale/shift -> SELU.  (B, L) waveform in, (B, 1, C/3, (L-128)/3) out, in
// the input's type (float or bf16).  The padded entry point writes the same
// values into the interior of a zero-bordered (B, C/3 + 2, (L-128)/3 + 2)
// frame instead: the input layout of csrc/fused_block0.cu, whose conv1 pads
// frequency and time by one.
//
// Replaces the TPU kernel aasist_tpu/ops/fused_frontend.py:_kernel
// (launched by _run) and, in its padded form, tools/fused_stack.py:_fe_kernel
// (launched by _fe_run), which writes mod-3 phase planes with zeroed border
// rows and a masked tail for the TPU block-0 kernel.  Both split the
// waveform into phases on the host so Mosaic can pool over time without
// stride-3 lane access; the first pads the output to 32 rows and transposes
// it back.  None of that is needed here:
// each thread indexes the waveform tile in shared memory directly and
// stores its pooled outputs straight into (B, 1, F_out, T_out).
//
// What bounds it on the H100.  At B = 128, L = 64,600 the conv is
// 2 * 128 * 69 * 64,470 * 129 = 1.47e11 FLOP against ~143 MB of bf16 in and
// out, about 1,000 FLOP per byte: compute-bound at any precision.  The bound
// is ~0.15 ms on the bf16 tensor cores (989 TFLOP/s dense) and ~2.2 ms on
// the f32 CUDA cores (67 TFLOP/s).  This first design runs on the CUDA
// cores in f32 (exact products of bf16 inputs), so its floor is the f32 one;
// moving the conv onto wgmma (an im2col tile of 129 taps padded to 144) is
// the later step that can approach the bf16 bound.
//
// What the design does about it.  The pool discards the pre-pool
// activation at once, so nothing but the waveform and the pooled result
// touches device memory (the plain PyTorch chain writes and reads the
// (B, 70, L-128) conv output).  Per FMA the inner loop must not wait on
// shared memory: each thread keeps 3 filters x 15 conv positions (= one
// pooled row x 5 pooled columns) of accumulators in registers and a
// 15-sample sliding window of the waveform, so one tap costs 4 shared loads
// (3 filter taps, broadcast across the warp, and 1 new sample) for 45 FMAs.
// The 15-float stride between lanes is odd, so the sample loads hit 32
// distinct banks.  Filter C-1 when C % 3 == 1 (filter 69 of 70) is dropped
// by the floor pool and never computed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int KSIZE = 129;               // sinc taps
constexpr int P = 5;                     // pooled columns per thread
constexpr int CW = 3 * P;                // conv positions per thread
constexpr int WARPS_T = 2;               // warps along time
constexpr int WARPS_R = 4;               // warps along pooled rows
constexpr int THREADS = 32 * WARPS_T * WARPS_R;
constexpr int TILE = 32 * P * WARPS_T;   // pooled columns per block
constexpr int TILE_X = 3 * TILE + KSIZE - 1;  // waveform samples per block

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

__device__ __forceinline__ float selu(float z) {
  const float scale = 1.0507009873554805f, alpha = 1.6732632423543772f;
  return z > 0.f ? scale * z : (scale * alpha) * expm1f(z);
}

// grid (ceil(T_out / TILE), B); block THREADS.  Warp (wt, wr) covers pooled
// columns [tile + 32*P*wt, +32*P) and pooled rows wr, wr + WARPS_R, ...
// PADDED: out is (B, F_out + 2, T_out + 2); row 0, row F_out + 1, column 0
// and column T_out + 1 are written as zeros by the blocks that own them.
template <typename T, bool PADDED>
__global__ void __launch_bounds__(THREADS)
fused_frontend_kernel(const T* __restrict__ x, const T* __restrict__ bank,
                      const float* __restrict__ sc, T* __restrict__ out,
                      int L, int F_out, int T_out) {
  extern __shared__ float smem[];
  float* xs = smem;                 // TILE_X samples of this tile
  float* ws = smem + TILE_X;        // 3*F_out filters x KSIZE taps

  const int b = blockIdx.y;
  const int tile = blockIdx.x * TILE;
  const long long x0 = 3LL * tile;
  const T* xb = x + (long long)b * L;
  for (int i = threadIdx.x; i < TILE_X; i += THREADS) {
    const long long s = x0 + i;
    xs[i] = s < L ? to_f32(xb[s]) : 0.f;
  }
  const int nw = 3 * F_out * KSIZE;
  for (int i = threadIdx.x; i < nw; i += THREADS) ws[i] = to_f32(bank[i]);
  __syncthreads();

  const float scale = sc[0], shift = sc[1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wt = warp % WARPS_T, wr = warp / WARPS_T;
  const int col0 = (wt * 32 + lane) * P;   // first pooled column in tile
  const float* xw = xs + 3 * col0;         // first sample of this thread

  for (int r = wr; r < F_out; r += WARPS_R) {
    const float* w0 = ws + 3 * r * KSIZE;
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
      const float a0 = w0[k], a1 = w0[KSIZE + k], a2 = w0[2 * KSIZE + k];
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        acc[0][j] = fmaf(a0, win[j], acc[0][j]);
        acc[1][j] = fmaf(a1, win[j], acc[1][j]);
        acc[2][j] = fmaf(a2, win[j], acc[2][j]);
      }
#pragma unroll
      for (int j = 0; j < CW - 1; ++j) win[j] = win[j + 1];
    }

    T* orow = PADDED
        ? out + ((long long)b * (F_out + 2) + r + 1) * (T_out + 2) + 1
        : out + ((long long)b * F_out + r) * T_out;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int t = tile + col0 + p;
      if (t < T_out) {
        float m = 0.f;
#pragma unroll
        for (int f = 0; f < 3; ++f)
#pragma unroll
          for (int j = 3 * p; j < 3 * p + 3; ++j)
            m = fmaxf(m, fabsf(acc[f][j]));
        orow[t] = from_f32<T>(selu(m * scale + shift));
      }
    }
  }

  if (PADDED) {
    const long long W = T_out + 2;
    T* ob = out + (long long)b * (F_out + 2) * W;
    const T zero = from_f32<T>(0.f);
    for (int i = threadIdx.x; i < TILE; i += THREADS) {
      const int t = tile + i;
      if (t < T_out) {
        ob[t + 1] = zero;
        ob[(F_out + 1) * W + t + 1] = zero;
      }
    }
    if (blockIdx.x == 0)
      for (int r = threadIdx.x; r < F_out + 2; r += THREADS) ob[r * W] = zero;
    if (blockIdx.x == gridDim.x - 1)
      for (int r = threadIdx.x; r < F_out + 2; r += THREADS)
        ob[r * W + T_out + 1] = zero;
  }
}

template <typename T, bool PADDED>
cudaError_t launch(const void* x, const void* bank, const float* sc,
                   void* out, int B, int L, int F_out, int T_out,
                   cudaStream_t stream) {
  const size_t smem = (TILE_X + 3 * (size_t)F_out * KSIZE) * sizeof(float);
  auto kernel = fused_frontend_kernel<T, PADDED>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((T_out + TILE - 1) / TILE, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bank), sc,
      static_cast<T*>(out), L, F_out, T_out);
  return cudaGetLastError();
}

template <bool PADDED>
int dispatch(const void* x, const void* bank, const float* sc, void* out,
             int B, int L, int C, int dtype, void* stream) {
  const int F_out = C / 3;
  const int T_out = (L - (KSIZE - 1)) / 3;
  if (B <= 0 || B > 65535 || F_out <= 0 || T_out <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float, PADDED>(x, bank, sc, out, B, L, F_out, T_out,
                                        s);
    case 1:
      return (int)launch<__nv_bfloat16, PADDED>(x, bank, sc, out, B, L, F_out,
                                                T_out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x (B, L), bank (C, 129) of that type,
// sc = {scale, shift} float32 on the device, out (B, 1, C/3, (L-128)/3).
// Returns the launch's cudaError_t (0 on success).
extern "C" int aasist_fused_frontend(const void* x, const void* bank,
                                     const float* sc, void* out, int B, int L,
                                     int C, int dtype, void* stream) {
  return dispatch<false>(x, bank, sc, out, B, L, C, dtype, stream);
}

// As aasist_fused_frontend, with out the zero-bordered
// (B, C/3 + 2, (L-128)/3 + 2) frame.
extern "C" int aasist_fused_frontend_padded(const void* x, const void* bank,
                                            const float* sc, void* out, int B,
                                            int L, int C, int dtype,
                                            void* stream) {
  return dispatch<true>(x, bank, sc, out, B, L, C, dtype, stream);
}
