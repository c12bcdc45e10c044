// The sinc frontend as matrix products on Hopper's tensor cores (sm_90a):
// sinc conv1d (C filters x 129 taps) -> |.| -> max pool (3,3) over (filter,
// time), floor semantics -> eval BatchNorm of one channel folded to a scalar
// scale/shift -> SELU.  (B, L) bf16 waveform in; F = C/3 rows by
// T = (L-128)/3 columns per batch row out, stored in one of four layouts:
//
//   filter-major (24, B, T), rows F..23 zero      aasist_frontend_dot_fm
//   batch-major  (B, 24, T), rows F..23 zero      aasist_frontend_dot_bm
//   the Scorer's (B, 1, F, T)                     aasist_frontend_dot_plain
//   the zero-bordered frame (B, F + 2, T + 2)     aasist_frontend_dot_padded
//
// Replaces the TPU kernels tools/probe_frontend_variants.py:kernel_v2
// (launched by run_v2) and tools/probe_fe_fix.py:kernel_v2bm (launched by
// run_v2bm), and in its last two layouts aasist_tpu/ops/fused_frontend.py:
// _kernel (launched by _run) and tools/fused_stack.py:_fe_kernel (launched
// by _fe_run), whose frame block 0 (csrc/block0_pipe.cu,
// csrc/fused_block0.cu) reads; the padded store writes the border's zeros
// itself.  All four compute one function: bf16 products, f32 sums, one
// rounding at the store.  What separates them is the layout they store, a
// template parameter here.  The TPU kernels' mod-3 / mod-9 phase planes,
// the 3 x 44-tap packing (K = 132, M = 210) and the G / u block sizes are
// Mosaic's way around its missing stride-3 lane access and do not carry
// over: here the pool reads accumulator registers.
//
// What bounds it on the H100.  At B = 128, L = 64,600 the conv is
// 2 * 128 * 69 * 64,470 * 129 = 1.47e11 FLOP against ~149 MB of bf16 in and
// out: compute-bound, ~0.15 ms at the tensor cores' 989 TFLOP/s.  The GEMM
// this kernel runs is padded to 72 filters x 144 taps (1.16x the FLOPs),
// and mma.sync reaches a part of the wgmma rate, so its own floor is a few
// times that.
//
// What the design does about it.  The conv is an implicit GEMM with
// mma.sync m16n8k16, bf16 operands, f32 accumulation:
//
//   D[position, filter] = sum_k X[position, k] * W[k, filter],
//   X[n, k] = x[n + k]                     (a Toeplitz view of the waveform)
//
// - A (16 positions x 16 taps) is read straight from the waveform tile in
//   shared memory, never materialised.  A thread's A register holds two
//   bf16 that are neighbours in K, x[n+k] and x[n+k+1]; for odd n + k that
//   pair is not 4-byte aligned, so the tile is kept twice, the second copy
//   shifted by one sample, and each lane picks the copy by the parity of its
//   position once.
// - B is the bank, packed once per block into shared memory as [filter
//   column][tap] with the taps padded from 129 to 144 with zeros and the
//   columns from C to 72 (plus 8 that ldmatrix.x4 reads and no MMA uses),
//   fetched with ldmatrix.  Filter C-1 when C % 3 == 1 (filter 69 of 70) is
//   dropped by the floor pool: its column is zero.
// - The pool runs on the accumulators.  GEMM rows and columns are assigned
//   so that each lane holds whole (3,3) pool windows: a warp's tile is 48
//   positions (3 m16 tiles) by 72 filters (9 n8 tiles); accumulator row
//   slot s = 2 m + (row >= 8) of lane group g is position 3 (g + 8 (s / 3))
//   + s % 3, and column slot c = 2 n + (col & 1) of lane-in-group q is
//   filter 3 (6 q + c / 3) + c % 3.  Each lane ends with 12 pooled values
//   (6 rows x 2 columns); no shuffles.
// - Pooled values go through a staging tile in shared memory so that global
//   stores are contiguous along time in either layout.
// - Persistent blocks keep the packed bank for their whole life and walk
//   work items of (batch row, TILE pooled columns).
//
// Taps 129..143 are zero in the packed bank but their samples are read: a
// non-finite sample reaches 15 more positions than in the plain chain.
// Samples past L are staged as zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int KSIZE = 129;               // sinc taps
constexpr int KPAD = 144;                // taps padded to 9 k-steps of 16
constexpr int KSTEPS = KPAD / 16;
constexpr int NT = 9;                    // n8 tiles: 72 filter columns
constexpr int MT = 3;                    // m16 tiles: 48 positions per warp
constexpr int ROWS = 24;                 // stored rows
constexpr int WROWS = 8 * (NT + 1);      // bank columns kept in shared memory
constexpr int WS = 152;                  // bf16 stride of a bank column: 304
                                         // bytes, 8 columns of one ldmatrix
                                         // fall into 8 distinct 16-byte banks
constexpr int WARPS = 4;                 // warps per block
constexpr int SUB = 2;                   // 48-position sub-tiles per warp
                                         // and work item
constexpr int BLOCKS = 3;                // blocks per SM the register
                                         // budget is set for
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 16 * SUB * WARPS;   // pooled columns per work item
constexpr int XS = 3 * TILE + KPAD + 8;  // samples per copy of the tile
constexpr int OSW = TILE + 8;            // bf16 stride of a staging row
static_assert(XS % 2 == 0 && OSW % 2 == 0, "4-byte aligned rows");

__device__ __forceinline__ float selu(float z) {
  const float scale = 1.0507009873554805f, alpha = 1.6732632423543772f;
  return z > 0.f ? scale * z : (scale * alpha) * expm1f(z);
}

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

// The store layouts (the kernel's template parameter).
enum Layout { FM = 0, BM = 1, PLAIN = 2, PADDED = 3 };

// Work item w is batch row w / n_tiles, pooled columns
// [(w % n_tiles) TILE, + TILE) (ops/frontend_variants.py:dot_work states
// the same decomposition and the wrapper passes its n_tiles and n_work).
template <int LAYOUT>
__global__ void __launch_bounds__(THREADS, BLOCKS)
frontend_dot_kernel(const bf16* __restrict__ x, const bf16* __restrict__ bank,
                    const float* __restrict__ sc, bf16* __restrict__ out,
                    int B, int L, int F_out, int T_out, int n_tiles,
                    int n_work) {
  __shared__ __align__(16) bf16 ws[WROWS * WS];   // bank [column][tap]
  __shared__ __align__(16) bf16 xs[2][XS];        // tile, and tile + 1 sample
  __shared__ __align__(16) bf16 os[ROWS * OSW];   // pooled tile [row][column]

  const int tid = threadIdx.x;
  const bf16 zero = __float2bfloat16(0.f);

  // Bank column 8 n + col of n8 tile n is the filter that the accumulator
  // layout wants there: column slot c = 2 n + (col & 1) of lane-in-group
  // col >> 1 is filter 3 (6 (col >> 1) + c / 3) + c % 3.
  for (int i = tid; i < WROWS * WS; i += THREADS) {
    const int row = i / WS, k = i % WS;
    const int n = row >> 3, col = row & 7;
    const int c = 2 * n + (col & 1);
    const int p = 6 * (col >> 1) + c / 3;
    const int f = 3 * p + c % 3;
    ws[i] = (n < NT && p < F_out && k < KSIZE) ? bank[f * KSIZE + k] : zero;
  }

  const float scale = sc[0], shift = sc[1];
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q4 = lane & 3;

  // A rows: row slot s of this lane is position pos_s of the warp's first
  // sub-tile; a_addr[s] is the shared-memory byte address of the bf16 pair
  // (x[pos_s + 2 q4], x[pos_s + 2 q4 + 1]) in the copy its parity picks.
  uint32_t a_addr[2 * MT];
#pragma unroll
  for (int s = 0; s < 2 * MT; ++s) {
    const int pos = 3 * (g + 8 * (s / 3)) + s % 3 + 48 * SUB * warp;
    const int par = pos & 1;
    a_addr[s] = smem_u32(&xs[par][0]) + (pos - par + 2 * q4) * 2;
  }
  // B: ldmatrix.x4 fetches n8 tiles 2 j and 2 j + 1 at one k-step; lanes
  // 0-7 address columns of tile 2 j at taps +0, 8-15 the same at taps +8,
  // 16-31 tile 2 j + 1 likewise.
  const uint32_t b_base =
      smem_u32(ws) +
      ((((lane >> 4) * 8 + (lane & 7)) * WS) + ((lane >> 3) & 1) * 8) * 2;

  for (int work = blockIdx.x; work < n_work; work += gridDim.x) {
    const int b = work / n_tiles;
    const int t0 = (work % n_tiles) * TILE;
    __syncthreads();            // the bank is packed; last item's readers
                                // of xs and os are done
    const bf16* xb = x + (long long)b * L;
    const long long s0 = 3LL * t0;
    for (int i = tid; i < XS; i += THREADS) {
      const bf16 v = s0 + i < L ? xb[s0 + i] : zero;
      xs[0][i] = v;
      if (i > 0) xs[1][i - 1] = v;
    }
    if (tid == 0) xs[1][XS - 1] = zero;
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
          // a[0], a[2]: row g of the m16 tile at taps 2 q4 and 2 q4 + 8 of
          // this k-step; a[1], a[3]: row g + 8
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
              p < F_out ? __float2bfloat16(selu(mx * scale + shift)) : zero;
        }
      }
    }
    __syncthreads();

    if constexpr (LAYOUT == FM || LAYOUT == BM) {
      // out[p, b, t] at p * stride_p + b * stride_b + t: filter-major
      // (24, B, T) has strides (B T, T), batch-major (B, 24, T) (T, 24 T)
      const long long stride_p =
          LAYOUT == BM ? T_out : (long long)B * T_out;
      const long long stride_b =
          LAYOUT == BM ? (long long)ROWS * T_out : T_out;
      bf16* ob = out + b * stride_b + t0;
      for (int i = tid; i < ROWS * TILE; i += THREADS) {
        const int p = i / TILE, col = i % TILE;
        if (t0 + col < T_out) ob[p * stride_p + col] = os[p * OSW + col];
      }
    } else if constexpr (LAYOUT == PLAIN) {
      bf16* ob = out + (long long)b * F_out * T_out + t0;
      for (int i = tid; i < F_out * TILE; i += THREADS) {
        const int p = i / TILE, col = i % TILE;
        if (t0 + col < T_out)
          ob[(long long)p * T_out + col] = os[p * OSW + col];
      }
    } else {
      // frame row p + 1, column t + 1 holds row p, time t; rows 0 and
      // F + 1 of this item's columns are zero, and the items at either end
      // of the row write columns 0 and T + 1
      const long long W = T_out + 2;
      bf16* ob = out + (long long)b * (F_out + 2) * W;
      for (int i = tid; i < (F_out + 2) * TILE; i += THREADS) {
        const int p = i / TILE, col = i % TILE;
        if (t0 + col < T_out)
          ob[p * W + t0 + col + 1] =
              (p == 0 || p == F_out + 1) ? zero : os[(p - 1) * OSW + col];
      }
      if (t0 == 0)
        for (int p = tid; p < F_out + 2; p += THREADS) ob[p * W] = zero;
      if (t0 + TILE >= T_out)
        for (int p = tid; p < F_out + 2; p += THREADS)
          ob[p * W + T_out + 1] = zero;
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
  auto kernel = frontend_dot_kernel<LAYOUT>;
  cudaError_t e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, 0)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long blocks = (long long)sms * per_sm;
  const int grid = (int)(n_work < blocks ? n_work : blocks);
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(bank), sc,
      static_cast<bf16*>(out), B, L, F_out, T_out, n_tiles, n_work);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, L) and bank (C, 129) bf16, C / 3 <= 24; sc = {scale, shift} float32
// on the device; out (24, B, (L-128)/3) bf16; n_tiles = ceil(T / 128) and
// n_work = B n_tiles (ops/frontend_variants.py:dot_work).  Returns the
// launch's cudaError_t (0 on success).
extern "C" int aasist_frontend_dot_fm(const void* x, const void* bank,
                                      const float* sc, void* out, int B, int L,
                                      int C, int n_tiles, int n_work,
                                      void* stream) {
  return launch<FM>(x, bank, sc, out, B, L, C, n_tiles, n_work, stream);
}

// As aasist_frontend_dot_fm, with out (B, 24, (L-128)/3).
extern "C" int aasist_frontend_dot_bm(const void* x, const void* bank,
                                      const float* sc, void* out, int B, int L,
                                      int C, int n_tiles, int n_work,
                                      void* stream) {
  return launch<BM>(x, bank, sc, out, B, L, C, n_tiles, n_work, stream);
}

// As aasist_frontend_dot_fm, with out (B, 1, C/3, (L-128)/3).
extern "C" int aasist_frontend_dot_plain(const void* x, const void* bank,
                                         const float* sc, void* out, int B,
                                         int L, int C, int n_tiles,
                                         int n_work, void* stream) {
  return launch<PLAIN>(x, bank, sc, out, B, L, C, n_tiles, n_work, stream);
}

// As aasist_frontend_dot_fm, with out the zero-bordered
// (B, C/3 + 2, (L-128)/3 + 2) frame.
extern "C" int aasist_frontend_dot_padded(const void* x, const void* bank,
                                          const float* sc, void* out, int B,
                                          int L, int C, int n_tiles,
                                          int n_work, void* stream) {
  return launch<PADDED>(x, bank, sc, out, B, L, C, n_tiles, n_work, stream);
}
