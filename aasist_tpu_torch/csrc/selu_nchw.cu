// SELU fused with the change from the channel-major compute layout to NCHW,
// for Hopper (sm_90a): z (C, F1, B, T) -> out (B, C, F1, T), SELU in f32 and
// rounded once, float32 or bfloat16, any T.
//
// Replaces the TPU kernel tools/probe_tail_constructs.py:geg_kernel
// (launched by geg_write), as csrc/tail_constructs.cu's two builds did
// before (a 16-byte vector a thread where T is a multiple of the vector,
// and a build staged through shared memory for any T); those stay as the
// older yardstick.
//
// What bounds it on the H100: bytes.  It reads its input once and writes its
// output once against 3.35 TB/s.  In bf16 SELU's arithmetic comes close:
// expm1f on every element is some 20-25 instructions, ~0.19 ms of issue at
// the probe's 113 M elements against a 0.27 ms byte bound; the older staged
// build also read shared memory back in conflicting 2-byte scalars, kept one
// 16-byte load in flight a thread, met at a __syncthreads every 4 KB and
// left a CTA in three with a quarter of the work at T = 4,608.
//
// What this design does about it:
// - Whole output rows, a warp each: a persistent grid of a few CTAs an SM
//   walks the B C F1 rows (a warp's rows gridDim.x * WARPS apart).  Time is
//   innermost on both sides, so a row is a contiguous run in and out.
// - Every access of a row's body is 16 bytes.  Lane L loads the aligned
//   input vectors U passes ahead (all issued before the first is used; lane
//   0 one more, the one after the pass), applies SELU to them in registers,
//   and takes its neighbour's vector from lane L + 1 by __shfl_sync (lane
//   31 from lane 0's next).  Each aligned 16-byte output vector is bytes
//   [sb, sb + 16) of the pair, sb = (input offset - output offset) mod 16:
//   a word select and a 16-bit funnel shift, warp-uniform in a row.  No
//   shared memory and no barrier.  Each row's ragged head and tail vector
//   are stored element by element.
// - SELU on the negative side is scale alpha (__expf(x) - 1), as the JAX
//   kernel writes it (exp(min(x, 0)) - 1) and as csrc/frontend_dot_wg.cu
//   computes it; a few 1e-7 from expm1f near zero, inside the f32 gate.
// - 32-bit index arithmetic where the elements fit (2.11e9 at block 0's
//   size), 64-bit otherwise.
// - Bases need only their type's alignment: vectors are aligned to the
//   address, and loads outside the tensor read no memory.
//
// A timing-only build: SNC_CUT=1 drops SELU (the layout change alone, an
// exact copy), which tells the arithmetic's share from the bytes'.
//
// The readings this was chosen by (NVIDIA H100 80GB HBM3, 700.00 W;
// aasist_tpu_torch/tools/probe_tail_constructs.py; PERF.md row 10c): in
// bf16 the kernel runs within a few % of its own SNC_CUT build, so SELU's
// arithmetic is no longer what bounds it; both sit under a plain copy of
// the input, which reaches ~90 % of the bytes' bound.  In f32 it is slower
// than the older one-vector-a-thread build where T allows that build, and
// so is its SNC_CUT build: the row walk, not SELU, moves the bytes slower.
// Not the grid's last round: grids that give every warp the same whole
// number of rows read no faster than the default (f32: 384 CTAs 0.6551 ms,
// default 660 0.6558), and one row a warp (6,144 CTAs) closes only a third
// of the gap to a plain clone (0.6356 against 0.5976). Builds read and dropped
// (no longer in the tree): 1, 2 or 8 vectors a lane a pass (4 is the fastest);
// threads held to fewer registers for more warps (spills, slower); work items
// of one pass of a row, consecutive for consecutive warps (no faster).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#ifndef SNC_CUT
#define SNC_CUT 0
#endif

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int U = 4;                    // input vectors a lane a pass
constexpr int PASS = 32 * U;            // output vectors a warp a pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16(v);
}

__device__ __forceinline__ float selu(float x) {
  const float scale = 1.0507009873554805f, alpha = 1.6732632423543772f;
  return x > 0.f ? scale * x : (scale * alpha) * (__expf(x) - 1.f);
}

template <typename T>
__device__ __forceinline__ uint4 selu_vec(uint4 v) {
  if (SNC_CUT) return v;
  constexpr int VEC = 16 / sizeof(T);
  alignas(16) T e[VEC];
  *reinterpret_cast<uint4*>(e) = v;
#pragma unroll
  for (int k = 0; k < VEC; ++k) from_f32(selu(to_f32(e[k])), &e[k]);
  return *reinterpret_cast<const uint4*>(e);
}

__device__ __forceinline__ uint4 shfl_vec(uint4 v, int src) {
  return make_uint4(__shfl_sync(0xffffffffu, v.x, src),
                    __shfl_sync(0xffffffffu, v.y, src),
                    __shfl_sync(0xffffffffu, v.z, src),
                    __shfl_sync(0xffffffffu, v.w, src));
}

// Bytes [4 SW + 2 half, + 16) of the 32 bytes (c, n).
template <int SW>
__device__ __forceinline__ uint4 window(uint4 c, uint4 n, bool half) {
  const uint32_t w[8] = {c.x, c.y, c.z, c.w, n.x, n.y, n.z, n.w};
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o[j] = half ? __funnelshift_r(w[j + SW], w[j + SW + 1], 16) : w[j + SW];
  return make_uint4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ uint4 realign(uint4 c, uint4 n, int sb) {
  const bool half = (sb & 2) != 0;
  switch (sb >> 2) {
    case 0: return window<0>(c, n, half);
    case 1: return window<1>(c, n, half);
    case 2: return window<2>(c, n, half);
    default: return window<3>(c, n, half);
  }
}

// Aligned input vector iv (elements [VEC iv, + VEC) from the aligned base),
// reading only elements [lo, hi): the whole vector where it lies inside,
// else element by element, zero outside.
template <typename T, typename I>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ base, I iv,
                                          I vlo, I vhi, I lo, I hi) {
  typedef typename std::make_unsigned<I>::type UI;
  constexpr int VEC = 16 / sizeof(T);
  if ((UI)(iv - vlo) < (UI)(vhi - vlo))
    return __ldg(reinterpret_cast<const uint4*>(base) + iv);
  alignas(16) T e[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const I at = iv * VEC + k;
    e[k] = (UI)(at - lo) < (UI)(hi - lo) ? base[at] : T(0.f);
  }
  return *reinterpret_cast<const uint4*>(e);
}

// out[b, c, f, t] = selu(z[c, f, b, t]).  zb and ob are the tensors' bases
// aligned down to 16 bytes, z_off and o_off the tensors' first elements
// from them.  Output row r = b cf + q (q = c F1 + f) is input row q B + b.
template <typename T, typename I>
__global__ void __launch_bounds__(THREADS)
selu_nchw_kernel(const T* __restrict__ zb, T* __restrict__ ob, I z_off,
                 I o_off, I n_total, I rows, I cf, I b, I t) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const I lo = z_off, hi = z_off + n_total;
  const I vlo = (z_off + VEC - 1) / VEC, vhi = hi / VEC;
  for (I r = (I)blockIdx.x * WARPS + (threadIdx.x >> 5); r < rows;
       r += (I)gridDim.x * WARPS) {
    const I bb = r / cf, q = r - bb * cf;
    const I in0 = z_off + (q * b + bb) * t, out0 = o_off + r * t;
    const int so = (int)(out0 % VEC);
    // output vector v holds elements from out0 - so + VEC v: input elements
    // from d + VEC v, d = in0 - so, that is input vectors qd + v and
    // qd + v + 1 from element rd (qd may be -1: unsigned wrap, no load)
    const I dp = in0 - so + VEC;                 // d + VEC >= 1
    const I qd = dp / VEC - 1;
    const int sb = (int)(dp % VEC) * (int)sizeof(T);
    const I ao = (out0 - so) / VEC;
    const I nvo = (so + t + VEC - 1) / VEC;
    for (I base = 0; base < nvo; base += PASS) {
      uint4 cur[U], extra = make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const I v = base + 32 * u + lane;
        cur[u] = v <= nvo ? load_vec(zb, qd + v, vlo, vhi, lo, hi)
                          : make_uint4(0, 0, 0, 0);
      }
      if (lane == 0 && base + PASS <= nvo)
        extra = load_vec(zb, qd + base + PASS, vlo, vhi, lo, hi);
#pragma unroll
      for (int u = 0; u < U; ++u) cur[u] = selu_vec<T>(cur[u]);
      extra = selu_vec<T>(extra);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const uint4 send = lane == 0 ? (u + 1 < U ? cur[u + 1] : extra)
                                     : cur[u];
        const uint4 nxt = shfl_vec(send, (lane + 1) & 31);
        const I v = base + 32 * u + lane;
        if (v >= nvo) continue;
        const uint4 o = realign(cur[u], nxt, sb);
        const I e0 = (ao + v) * VEC;             // the vector's first element
        if (e0 >= out0 && e0 + VEC <= out0 + t) {
          *reinterpret_cast<uint4*>(ob + e0) = o;
        } else {
          alignas(16) T e[VEC];
          *reinterpret_cast<uint4*>(e) = o;
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            if (e0 + k >= out0 && e0 + k < out0 + t) ob[e0 + k] = e[k];
        }
      }
    }
  }
}

template <typename T, typename I>
cudaError_t run(const T* zb, T* ob, long long z_off, long long o_off,
                long long n, long long rows, long long cf, long long b,
                long long t, cudaStream_t s) {
  auto kernel = selu_nchw_kernel<T, I>;
  cudaError_t e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         THREADS, 0)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long need = (rows + WARPS - 1) / WARPS;
  const long long full = (long long)sms * per_sm;
  const int grid = (int)(need < full ? need : full);
  kernel<<<grid, THREADS, 0, s>>>(zb, ob, (I)z_off, (I)o_off, (I)n, (I)rows,
                                  (I)cf, (I)b, (I)t);
  return cudaGetLastError();
}

template <typename T>
cudaError_t selu_nchw(const void* z, void* out, long long cf, long long b,
                      long long t, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const uintptr_t zp = reinterpret_cast<uintptr_t>(z);
  const uintptr_t op = reinterpret_cast<uintptr_t>(out);
  if (zp % sizeof(T) || op % sizeof(T)) return cudaErrorInvalidValue;
  const T* zb = reinterpret_cast<const T*>(zp & ~(uintptr_t)15);
  T* ob = reinterpret_cast<T*>(op & ~(uintptr_t)15);
  const long long z_off = (long long)(zp & 15) / (long long)sizeof(T);
  const long long o_off = (long long)(op & 15) / (long long)sizeof(T);
  const long long n = cf * b * t, rows = cf * b;
  // every index the kernel forms (up to an offset, n, and a pass of
  // vectors past a row's end) fits 32 bits
  if (n + 2LL * VEC * (PASS + 2) < 0xffffffffLL)
    return run<T, uint32_t>(zb, ob, z_off, o_off, n, rows, cf, b, t, s);
  return run<T, long long>(zb, ob, z_off, o_off, n, rows, cf, b, t, s);
}

}  // namespace

// z (c, f1, b, t) -> out (b, c, f1, t), SELU applied (SNC_CUT=1: copied),
// both contiguous, each aligned to its type.  dtype: 0 = float32,
// 1 = bfloat16.  Returns the launch's cudaError_t (0 on success).
extern "C" int aasist_selu_nchw(const void* z, void* out, int c, int f1,
                                int b, int t, int dtype, void* stream) {
  if (c <= 0 || f1 <= 0 || b <= 0 || t <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cf = (long long)c * f1;
  switch (dtype) {
    case 0: return (int)selu_nchw<float>(z, out, cf, b, t, s);
    case 1: return (int)selu_nchw<__nv_bfloat16>(z, out, cf, b, t, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
