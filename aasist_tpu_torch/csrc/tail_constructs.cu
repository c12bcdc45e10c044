// The tail of residual block 0 as kernels of their own, for Hopper (sm_90a):
// the max pool (1,3) over time in three formulations, and SELU fused with
// the change from the channel-major compute layout to NCHW.
//
// Replaces the TPU kernels of tools/probe_tail_constructs.py:
//   pool_reshape_kernel, pool_strided_kernel (launched by mk_pool's run) ->
//     aasist_pool3_time, staged = 0 / 1: (rows, T) -> (rows, T / 3), a row
//     one (batch, channel, frequency) line of block 0's pre-pool tensor.  On
//     the TPU the two differ in how a stride-3 lane access is spelled; here
//     they are the two ways a memory-bound pass reads its input: each thread
//     its own three neighbours straight from device memory (direct), or a
//     tile of the row staged through shared memory with 128-bit loads
//     (staged);
//   pool_sublane_kernel -> aasist_pool3_time_major: time-major
//     (n, T, F) -> (n, T / 3, F), the pool over the slower axis;
//   geg_kernel (launched by geg_write) -> aasist_selu_to_nchw:
//     (C, F1, B, T) -> (B, C, F1, T) with SELU in f32.  Time is innermost on
//     both sides, so the layout change moves whole rows and both the reads
//     and the writes are coalesced without a transpose.  With T a multiple
//     of the vector width each thread can move 16 bytes (staged = 0); for
//     any T a chunk of the row goes through shared memory between 16-byte
//     loads and 16-byte stores, the two copies of a row being aligned
//     differently (staged = 1).  Both stay: at (32, 24, 64, 4608) bf16 the
//     vector kernel takes 0.380 ms and the staged one 0.552 (bound 0.270;
//     NVIDIA H100 80GB HBM3, 700.00 W;
//     aasist_tpu_torch/tools/probe_tail_constructs.py).
//
// What bounds them on the H100: bytes.  Each reads its input once and writes
// its output once (a pool 4/3 of its input, the layout change twice its
// input) against 3.35 TB/s; there is one max or one exponential per element.
// The design keeps every access coalesced and does nothing else.
//
// float32 and bfloat16.  A max of three stored values is one of them, so the
// pools are exact; SELU is computed in f32 (expm1f) and rounded once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 1024;        // pooled columns per block, staged pool

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16(v);
}

template <typename T>
__device__ __forceinline__ T max3(T a, T b, T c) {
  const float fa = to_f32(a), fb = to_f32(b), fc = to_f32(c);
  T o;
  from_f32(fmaxf(fmaxf(fa, fb), fc), &o);   // exact: one of the inputs
  return o;
}

// The element-wise kernels index with I: 32 bits when every index fits (a
// 64-bit division costs some hundred operations an element), else 64.

// out[r, j] = max(y[r, 3 j .. 3 j + 2]); one thread per output
template <typename T, typename I>
__global__ void __launch_bounds__(THREADS)
pool3_direct_kernel(const T* __restrict__ y, T* __restrict__ out, I n_out,
                    I t_in, I v) {
  const I i = (I)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_out) return;
  const I r = i / v, j = i - r * v;
  const T* src = y + r * t_in + 3 * j;
  out[i] = max3(src[0], src[1], src[2]);
}

// The same function, a block per (row, tile of TILE pooled columns): the
// tile's 3 TILE inputs go to shared memory in 16-byte vectors, starting at
// the 16-byte boundary at or below the tile's first element (rows need not
// be aligned), then each thread pools from shared memory.
template <typename T>
__global__ void __launch_bounds__(THREADS)
pool3_staged_kernel(const T* __restrict__ y, T* __restrict__ out,
                    long long n_in_total, int t_in, int v, int tiles) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ uint4 sh4[(3 * TILE + VEC) / VEC + 1];
  T* sh = reinterpret_cast<T*>(sh4);
  const long long r = blockIdx.x / tiles;
  const int j0 = (int)(blockIdx.x % tiles) * TILE;
  const int n_out = min(TILE, v - j0);
  const long long e0 = r * t_in + 3 * j0, e1 = e0 + 3 * n_out;
  const long long a0 = e0 & ~(long long)(VEC - 1);
  for (long long a = a0 + (long long)threadIdx.x * VEC; a < e1;
       a += (long long)THREADS * VEC) {
    const int s = (int)(a - a0);
    if (a + VEC <= n_in_total) {
      sh4[s / VEC] = *reinterpret_cast<const uint4*>(y + a);
    } else {
      for (int k = 0; k < VEC && a + k < n_in_total; ++k) sh[s + k] = y[a + k];
    }
  }
  __syncthreads();
  const T* src = sh + (int)(e0 - a0);
  T* dst = out + r * v + j0;
  for (int o = threadIdx.x; o < n_out; o += THREADS)
    dst[o] = max3(src[3 * o], src[3 * o + 1], src[3 * o + 2]);
}

// time-major: out[n, j, f] = max(y[n, 3 j .. 3 j + 2, f])
template <typename T, typename I>
__global__ void __launch_bounds__(THREADS)
pool3_time_major_kernel(const T* __restrict__ y, T* __restrict__ out,
                        I n_out, I t_in, I v, I f) {
  const I i = (I)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_out) return;
  const I rest = i / f, ff = i - rest * f;
  const I n = rest / v, j = rest - n * v;
  const T* src = y + (n * t_in + 3 * j) * f + ff;
  out[i] = max3(src[0], src[f], src[2 * f]);
}

constexpr float SELU_SCALE = 1.0507009873554805f;
constexpr float SELU_ALPHA = 1.6732632423543772f;

__device__ __forceinline__ float selu(float z) {
  return z > 0.f ? SELU_SCALE * z : (SELU_SCALE * SELU_ALPHA) * expm1f(z);
}

template <typename T>
__device__ __forceinline__ uint4 selu_vec(uint4 v) {
  constexpr int VEC = 16 / sizeof(T);
  alignas(16) T e[VEC];
  *reinterpret_cast<uint4*>(e) = v;
#pragma unroll
  for (int k = 0; k < VEC; ++k) from_f32(selu(to_f32(e[k])), &e[k]);
  return *reinterpret_cast<const uint4*>(e);
}

// out[b, c, f, t] = selu(z[c, f, b, t]) for t a multiple of the vector
// width: every row starts on a 16-byte boundary on both sides, and a thread
// moves one vector
template <typename T, typename I>
__global__ void __launch_bounds__(THREADS)
selu_to_nchw_kernel(const T* __restrict__ z, T* __restrict__ out, I n_vec,
                    I cf, I b, I t) {
  constexpr int VEC = 16 / sizeof(T);
  const I i = (I)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_vec) return;
  const I tv = t / VEC;
  const I row_out = i / tv;                      // (b, c, f)
  const I col = (i - row_out * tv) * VEC;
  const I bb = row_out / cf, q = row_out - bb * cf;      // q = (c, f)
  *reinterpret_cast<uint4*>(out + row_out * t + col) = selu_vec<T>(
      *reinterpret_cast<const uint4*>(z + (q * b + bb) * t + col));
}

// The same function for any t: a row's two copies then start at different
// offsets from a 16-byte boundary.  A block takes CHUNK times of one row:
// 16-byte loads from the boundary at or below the chunk's first element,
// SELU in registers, the values parked in shared memory, then 16-byte stores
// from the first boundary of the output chunk (its ragged head and tail
// element by element).
constexpr int CHUNK = 2048;
template <typename T>
__global__ void __launch_bounds__(THREADS)
selu_to_nchw_staged_kernel(const T* __restrict__ z, T* __restrict__ out,
                           long long n_total, int cf, int b, int t,
                           int chunks) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ uint4 sh4[(CHUNK + VEC) / VEC + 1];
  T* sh = reinterpret_cast<T*>(sh4);
  const long long row_out = blockIdx.x / chunks;
  const int c0 = (int)(blockIdx.x % chunks) * CHUNK;
  const int n = min(CHUNK, t - c0);
  const long long bb = row_out / cf, q = row_out % cf;
  const long long in0 = (q * b + bb) * t + c0, out0 = row_out * t + c0;
  const long long a0 = in0 & ~(long long)(VEC - 1);
  for (long long a = a0 + (long long)threadIdx.x * VEC; a < in0 + n;
       a += (long long)THREADS * VEC) {
    const int s = (int)(a - a0);
    if (a + VEC <= n_total) {
      sh4[s / VEC] = selu_vec<T>(*reinterpret_cast<const uint4*>(z + a));
    } else {
      for (int k = 0; k < VEC && a + k < n_total; ++k)
        from_f32(selu(to_f32(z[a + k])), sh + s + k);
    }
  }
  __syncthreads();
  const T* src = sh + (int)(in0 - a0);
  T* dst = out + out0;
  const int head = min(n, (int)((VEC - out0 % VEC) % VEC));
  const int n_vec = (n - head) / VEC, tail0 = head + n_vec * VEC;
  if ((int)threadIdx.x < head) dst[threadIdx.x] = src[threadIdx.x];
  if ((int)threadIdx.x < n - tail0)
    dst[tail0 + threadIdx.x] = src[tail0 + threadIdx.x];
  for (int k = threadIdx.x; k < n_vec; k += THREADS) {
    alignas(16) T e[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) e[j] = src[head + k * VEC + j];
    *reinterpret_cast<uint4*>(dst + head + k * VEC) =
        *reinterpret_cast<const uint4*>(e);
  }
}

inline long long blocks_for(long long n) {
  return (n + THREADS - 1) / THREADS;
}

// every element index of an n-element tensor, and the last block's thread
// indices past it, fit 32 bits
inline bool fits_u32(long long n) { return n + THREADS < 0xffffffffLL; }

template <typename T>
cudaError_t pool3_time(const void* y, void* out, long long rows, int t_in,
                       int staged, cudaStream_t s) {
  const int v = t_in / 3;
  const T* yp = static_cast<const T*>(y);
  T* op = static_cast<T*>(out);
  if (staged) {
    const int tiles = (v + TILE - 1) / TILE;
    const long long grid = rows * tiles;
    if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
    pool3_staged_kernel<T><<<(unsigned)grid, THREADS, 0, s>>>(
        yp, op, rows * t_in, t_in, v, tiles);
  } else {
    const long long grid = blocks_for(rows * v);
    if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
    if (fits_u32(rows * t_in))
      pool3_direct_kernel<T, uint32_t><<<(unsigned)grid, THREADS, 0, s>>>(
          yp, op, (uint32_t)(rows * v), (uint32_t)t_in, (uint32_t)v);
    else
      pool3_direct_kernel<T, long long><<<(unsigned)grid, THREADS, 0, s>>>(
          yp, op, rows * v, (long long)t_in, (long long)v);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t pool3_time_major(const void* y, void* out, long long n, int t_in,
                             int f, cudaStream_t s) {
  const int v = t_in / 3;
  const long long n_out = n * v * f, grid = blocks_for(n_out);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* yp = static_cast<const T*>(y);
  T* op = static_cast<T*>(out);
  if (fits_u32(n * t_in * f))
    pool3_time_major_kernel<T, uint32_t><<<(unsigned)grid, THREADS, 0, s>>>(
        yp, op, (uint32_t)n_out, (uint32_t)t_in, (uint32_t)v, (uint32_t)f);
  else
    pool3_time_major_kernel<T, long long><<<(unsigned)grid, THREADS, 0, s>>>(
        yp, op, n_out, (long long)t_in, (long long)v, (long long)f);
  return cudaGetLastError();
}

template <typename T>
cudaError_t selu_to_nchw(const void* z, void* out, int cf, int b, int t,
                         int staged, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const T* zp = static_cast<const T*>(z);
  T* op = static_cast<T*>(out);
  const long long n = (long long)cf * b * t;
  if (staged) {
    const int chunks = (t + CHUNK - 1) / CHUNK;
    const long long grid = (long long)cf * b * chunks;
    if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
    selu_to_nchw_staged_kernel<T><<<(unsigned)grid, THREADS, 0, s>>>(
        zp, op, n, cf, b, t, chunks);
    return cudaGetLastError();
  }
  if (t % VEC != 0) return cudaErrorInvalidValue;
  const long long n_vec = n / VEC, grid = blocks_for(n_vec);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (fits_u32(n))
    selu_to_nchw_kernel<T, uint32_t><<<(unsigned)grid, THREADS, 0, s>>>(
        zp, op, (uint32_t)n_vec, (uint32_t)cf, (uint32_t)b, (uint32_t)t);
  else
    selu_to_nchw_kernel<T, long long><<<(unsigned)grid, THREADS, 0, s>>>(
        zp, op, n_vec, (long long)cf, (long long)b, (long long)t);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for every entry; each returns the
// launch's cudaError_t (0 on success).

// y (rows, t_in) -> out (rows, t_in / 3); staged: 0 direct, 1 through shared
// memory (y must then be 16-byte aligned).
extern "C" int aasist_pool3_time(const void* y, void* out, long long rows,
                                 int t_in, int staged, int dtype,
                                 void* stream) {
  if (rows <= 0 || t_in / 3 <= 0) return (int)cudaErrorInvalidValue;
  if (staged && reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)pool3_time<float>(y, out, rows, t_in, staged, s);
    case 1:
      return (int)pool3_time<__nv_bfloat16>(y, out, rows, t_in, staged, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// y (n, t_in, f) -> out (n, t_in / 3, f)
extern "C" int aasist_pool3_time_major(const void* y, void* out, long long n,
                                       int t_in, int f, int dtype,
                                       void* stream) {
  if (n <= 0 || t_in / 3 <= 0 || f <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)pool3_time_major<float>(y, out, n, t_in, f, s);
    case 1:
      return (int)pool3_time_major<__nv_bfloat16>(y, out, n, t_in, f, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// z (c, f1, b, t) -> out (b, c, f1, t), SELU applied; both 16-byte aligned.
// staged: 0 a vector a thread (t must be a multiple of the 16-byte vector),
// 1 through shared memory (any t).
extern "C" int aasist_selu_to_nchw(const void* z, void* out, int c, int f1,
                                   int b, int t, int staged, int dtype,
                                   void* stream) {
  if (c <= 0 || f1 <= 0 || b <= 0 || t <= 0 ||
      reinterpret_cast<uintptr_t>(z) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)selu_to_nchw<float>(z, out, c * f1, b, t, staged, s);
    case 1:
      return (int)selu_to_nchw<__nv_bfloat16>(z, out, c * f1, b, t, staged,
                                              s);
    default: return (int)cudaErrorInvalidValue;
  }
}
