// The matrix-unit shape probe's kernel for Hopper (sm_90a): n chained dots
// y = w^T a on operands resident on chip, at the dot shapes of the fused
// kernels, to say what mma.sync gives at each (K, M) on this card.
//
// Replaces the TPU kernel tools/probe_mxu_shapes.py:_kernel (launched by its
// `run`).  w is (K, M) bf16, a (K, N) bf16; each of n iterations computes
// y = w^T a in f32 (M x N), s = eps * sum_m y^2 (f32), and
// a[0] = bf16(a[0] + bf16(s)): the next dot reads what the last one wrote,
// so no dot can be skipped or hoisted.  The kernel returns the final a
// (K, N); the TPU kernel's (8, 128) f32 output is its [0:8, 0:128].
//
// What bounds it on the H100: operations.  Each dot is 2 K M N FLOP on
// operands that stay on chip, so the least time of a dot is 2 K M N over the
// tensor cores' 989 TFLOP/s (bf16, dense).  The probe measures how far
// mma.sync m16n8k16 falls short of that at each shape.
//
// What the design does about it.  The columns of a never meet: column j's
// update reads only column j.  So the work splits over the whole card with
// no communication, one CTA per SM, each chaining all n dots on its own
// slice of NS = 16 columns (128 CTAs for the probe's N = 2048).  At that
// width w^T plus the slice fits in shared memory for every probe shape:
// w^T padded to 640 x 152 at k144_m630 is 190 KB, the slice 4.8 KB.
// - w^T is stored once per CTA as [m][k] (k contiguous, rows padded by 8
//   bf16 so the 8 rows of an ldmatrix fall into distinct bank groups), zero
//   past K and M: K and M pad to multiples of 16 (k12_m192 runs 75 % useful
//   MMA work, k132_m210 86 %).  A fragments are fetched by ldmatrix each
//   dot: w does not fit in registers at the large shapes.
// - The slice is stored transposed, [n][k], so ldmatrix (no .trans) gives
//   B fragments directly; each warp holds all KT k-steps of both n8 tiles in
//   registers for the dot.
// - Warps split the m16 tiles.  Each lane squares its accumulators and sums
//   over its rows, the rows of the warp meet by shuffles, the warps by a
//   small shared array; then one thread per column scales by eps, rounds,
//   adds to row 0 and rounds again, and a __syncthreads makes row 0 visible
//   to the next dot, whose B fragments are reloaded.
// At 16 columns a CTA has little work per dot and 8 warps meet twice per
// dot, so small shapes measure the barrier as much as the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NS = 16;          // columns per CTA: two n8 tiles

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

// KT: k-steps of 16, K padded to 16 KT; row stride of both tiles KT*16 + 8
template <int KT>
__global__ void __launch_bounds__(THREADS, 1)
chain_kernel(const bf16* __restrict__ w, const bf16* __restrict__ a,
             bf16* __restrict__ out, int K, int M, int N, int n_iter,
             float eps) {
  constexpr int KP = KT * 16, KS = KP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int MT = (M + 15) / 16, MP = MT * 16;
  bf16* ws = reinterpret_cast<bf16*>(smem);          // [MP][KS]: w^T
  bf16* as = ws + MP * KS;                           // [NS][KS]: a^T slice
  float* red = reinterpret_cast<float*>(as + NS * KS);   // [WARPS][NS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * NS;
  const bf16 zero = __float2bfloat16(0.f);

  // consecutive threads read consecutive m of one row of w (coalesced)
  for (int i = tid; i < KP * MP; i += THREADS) {
    const int k = i / MP, m = i % MP;
    ws[m * KS + k] = (k < K && m < M) ? w[(long long)k * M + m] : zero;
  }
  for (int i = tid; i < KP * NS; i += THREADS) {
    const int k = i / NS, n = i % NS;
    as[n * KS + k] =
        (k < K && n0 + n < N) ? a[(long long)k * N + n0 + n] : zero;
  }
  __syncthreads();

  // ldmatrix lane addresses.  A (16 x 16 of w^T at m tile mt, k-step ks):
  // matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15),
  // (rows 8-15, k 8-15) are the fragment's four registers.  B (both n8
  // tiles at one k-step): (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, ..).
  const uint32_t a_lane =
      smem_u32(ws) + (((lane & 7) + 8 * ((lane >> 3) & 1)) * KS +
                      8 * (lane >> 4)) * 2;
  const uint32_t b_lane =
      smem_u32(as) + (((lane & 7) + 8 * (lane >> 4)) * KS +
                      8 * ((lane >> 3) & 1)) * 2;

  for (int it = 0; it < n_iter; ++it) {
    uint32_t bf[KT][2][2];
#pragma unroll
    for (int ks = 0; ks < KT; ++ks)
      ldmatrix_x4(b_lane + ks * 32, bf[ks][0][0], bf[ks][0][1], bf[ks][1][0],
                  bf[ks][1][1]);
    float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};   // [n tile][column parity]
    for (int mt = warp; mt < MT; mt += WARPS) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const uint32_t a_tile = a_lane + mt * 16 * KS * 2;
#pragma unroll
      for (int ks = 0; ks < KT; ++ks) {
        uint32_t af[4];
        ldmatrix_x4(a_tile + ks * 32, af[0], af[1], af[2], af[3]);
        mma_bf16(acc[0], af, bf[ks][0]);
        mma_bf16(acc[1], af, bf[ks][1]);
      }
      // rows gid and gid + 8, columns 2 tig and 2 tig + 1 of each n tile
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        part[j][0] += acc[j][0] * acc[j][0] + acc[j][2] * acc[j][2];
        part[j][1] += acc[j][1] * acc[j][1] + acc[j][3] * acc[j][3];
      }
    }
    // the 8 lanes of one tig hold the same columns: sum over gid
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float v = part[j][p];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (gid == 0) red[warp * NS + 8 * j + 2 * tig + p] = v;
      }
    __syncthreads();
    if (tid < NS) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < WARPS; ++k) s += red[k * NS + tid];
      const bf16 sb = __float2bfloat16(s * eps);
      as[tid * KS] = __float2bfloat16(__bfloat162float(as[tid * KS]) +
                                      __bfloat162float(sb));
    }
    __syncthreads();            // row 0 is written before the next dot reads
  }

  for (int i = tid; i < K * NS; i += THREADS) {
    const int k = i / NS, n = i % NS;
    if (n0 + n < N) out[(long long)k * N + n0 + n] = as[n * KS + k];
  }
}

template <int KT>
int launch(const bf16* w, const bf16* a, bf16* out, int K, int M, int N,
           int n_iter, float eps, cudaStream_t s) {
  constexpr int KS = KT * 16 + 8;
  const int MP = (M + 15) / 16 * 16;
  const size_t smem = (size_t)(MP + NS) * KS * sizeof(bf16) +
                      WARPS * NS * sizeof(float);
  cudaError_t e;
  int dev = 0, max_smem = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&max_smem,
                                  cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  dev)) != cudaSuccess)
    return (int)e;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  if ((e = cudaFuncSetAttribute(chain_kernel<KT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return (int)e;
  chain_kernel<KT><<<(N + NS - 1) / NS, THREADS, smem, s>>>(
      w, a, out, K, M, N, n_iter, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// w (K, M) and a (K, N) bf16 on the device; out (K, N) bf16: a after n_iter
// chained dots (the header).  K pads to 16, 96, 128, 144, 192, 256 or 384
// (the probe's shapes); w^T padded to 16 rows plus a 16-column slice must fit
// in a block's shared memory.  Returns the launch's cudaError_t (0 on
// success).
extern "C" int aasist_mma_chain(const void* w, const void* a, void* out,
                                int K, int M, int N, int n_iter, float eps,
                                void* stream) {
  if (K <= 0 || M <= 0 || N <= 0 || n_iter < 0)
    return (int)cudaErrorInvalidValue;
  const bf16* wp = static_cast<const bf16*>(w);
  const bf16* ap = static_cast<const bf16*>(a);
  bf16* op = static_cast<bf16*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((K + 15) / 16) {
    case 1: return launch<1>(wp, ap, op, K, M, N, n_iter, eps, s);
    case 6: return launch<6>(wp, ap, op, K, M, N, n_iter, eps, s);
    case 8: return launch<8>(wp, ap, op, K, M, N, n_iter, eps, s);
    case 9: return launch<9>(wp, ap, op, K, M, N, n_iter, eps, s);
    case 12: return launch<12>(wp, ap, op, K, M, N, n_iter, eps, s);
    case 16: return launch<16>(wp, ap, op, K, M, N, n_iter, eps, s);
    case 24: return launch<24>(wp, ap, op, K, M, N, n_iter, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
