// The step-cost probe's kernels for Hopper (sm_90a): empty, copy and matrix
// kernels over block 0's grid geometry, which separate the fixed cost of a
// grid step from its bytes and from its tensor-core work.
//
// Replaces the TPU kernel tools/probe_stepcost.py:make_runner's `kernel`
// (launched by its `run`).  x is (32, B, 32, T) bf16 (channel, batch, row,
// time), w (96, 64) bf16; the grid is (B / g, T / u) steps, and step
// (bb, jj) owns g batch rows from bb g and u times from jj u.  One TPU grid
// step is one CTA here, so a time per CTA keeps the probe's meaning.  The
// modes and their outputs, all bf16:
//
//   nop     1.0 into (32, B, 23, T)
//   nopF32  1.0 into (32, B, 32, T)
//   nopblk  1.0 into the step-blocked (B/g, T/u, 32, g, 32, u): a step's
//           output is one contiguous region
//   copy    out = x[:, :, :23] into (32, B, 23, T); reads only those rows
//   matmul  d = w^T [x rows r, r+1, r+2] (K = 96, M = 64, f32 sums), then
//           out[o, b, r, t] = d[o, r] + d[32 + o, r + 1], r < 23, rounded
//           once, into (32, B, 23, T)
//   matblk  the same for r < 24, rows 24..31 zero, into the step-blocked
//           layout
//
// What bounds them on the H100: bytes.  Every mode reads its rows of x once
// and writes its output once against 3.35 TB/s (nop 1.35 GB written at
// B = 128, T = 7168; matblk 1.59 GB read and 1.88 GB written); matmul's
// 2.6e11 FLOP would take 0.26 ms at the tensor cores' 989 TFLOP/s against
// 0.86 ms of bytes.
//
// What the design does about it.  A TPU step's block of x is 32 g 32 u
// values, 4.2 MB at (g, u) = (8, 256) and 67 MB at (32, 1024): far more than
// a CTA's 227 KB of shared memory, so a CTA streams its step.
// - nop / copy: a warp takes (channel, batch row) planes of the step and
//   moves each row of u times in 16-byte vectors, lanes on neighbouring
//   vectors; copy issues eight rows' loads before their stores.
// - matmul / matblk: the step is cut into sub-tiles of one batch row and
//   UT = 64 times.  Each sub-tile's rows the dots read (26 for matmul, 27
//   for matblk) x 32 channels are staged in shared memory
//   [channel][row][time] with cp.async, double-buffered (209 / 217 KB), so
//   the next sub-tile's load overlaps this one's product.  64 times make
//   each staged row one 128-byte segment of x (32 times, 64 bytes, made
//   matmul 37 % slower on the H100).  The GEMM (M = 64 outputs, K = 96,
//   N = positions) runs on mma.sync m16n8k16, bf16 operands, f32 sums:
//   w^T's 24 A fragments live in registers for the CTA's life, and B
//   fragments come from the stage by ldmatrix.trans (one x4 per tap gives
//   both k-steps of its 32 channels).  Warp w walks times 8 w .. 8 w + 7
//   down the rows, computing d row by row; the low half of row r - 1 and
//   the high half of row r, held by the same lane at the same fragment
//   slots, sum in registers to output row r - 1.  matblk's zero rows
//   24..31 are stored with the sub-tile.
//
// Geometry: B % g == 0, T % u == 0, u % 8 == 0 (rows start on 16-byte
// boundaries).  A sub-tile's ragged tail (u % 64) is masked by whole 8-time
// groups, which u % 8 == 0 makes exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int C = 32;            // channels in and out
constexpr int ROWS = 32;         // rows of x and of the padded outputs
constexpr int F = 23;            // rows of the (32, B, 23, T) outputs
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 8;           // bf16 in a 16-byte vector
constexpr int RU = 8;            // rows a copy lane loads before storing

constexpr int UT = 8 * WARPS;    // times per staged sub-tile: 8 a warp
constexpr int KSTEPS = 6;        // K = 96: 3 taps x 2 halves of 16 channels
constexpr int MT = 4;            // M = 64: 4 m16 tiles, 2 per output half

// The staged sub-tile of matmul (BLK = false) and matblk (BLK = true).  d
// rows 0 .. FO are computed (row r's low half meets row r + 1's high half),
// so the dots read x rows 0 .. FO + 2: 26 rows for matmul, 27 for matblk.
template <bool BLK>
struct Tile {
  static constexpr int FO = BLK ? F + 1 : F;     // output rows: 24 / 23
  static constexpr int RIN = FO + 3;             // x rows staged
  static constexpr int CS = RIN * UT + 8;        // bf16 stride of a channel:
                                                 // an odd multiple of 16
                                                 // bytes, so the 8 rows of
                                                 // one ldmatrix hit 8
                                                 // distinct bank groups
  static constexpr int STAGE = C * CS;           // bf16 per stage buffer
  static constexpr int CHUNKS = C * RIN * (UT / VEC);  // 16-byte copies
  static constexpr int SMEM = 2 * STAGE * (int)sizeof(bf16);
};

enum Mode { NOP = 0, NOPF32 = 1, NOPBLK = 2, COPY = 3, MATMUL = 4,
            MATBLK = 5 };

// Where output plane (channel c, step batch row gi) starts, and its row
// stride: (32, B, R, T) or the step-blocked (B/g, T/u, 32, g, 32, u).
struct OutMap {
  long long base;
  int rstride;
};

__device__ __forceinline__ OutMap out_plane(bool blocked, int c, int gi,
                                            int B, int T, int g, int u,
                                            int rows) {
  const int bb = blockIdx.x, jj = blockIdx.y;
  if (blocked) {
    const long long step = (long long)bb * gridDim.y + jj;
    return {(step * (C * g) + (long long)c * g + gi) * ROWS * u, u};
  }
  return {(((long long)c * B + (long long)bb * g + gi) * rows) * T +
              (long long)jj * u,
          T};
}

__device__ __forceinline__ long long x_row(int c, int gi, int r, int B,
                                           int T, int g, int u) {
  return (((long long)c * B + (long long)blockIdx.x * g + gi) * ROWS + r) * T +
         (long long)blockIdx.y * u;
}

// nop, nopF32, nopblk: 1.0 (0x3F80) into every element of the step's output
__global__ void __launch_bounds__(THREADS)
fill_kernel(bf16* __restrict__ out, int B, int T, int g, int u, int rows,
            int blocked) {
  const uint4 ones = make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u,
                                0x3F803F80u);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int vpr = u / VEC;
  for (int p = warp; p < C * g; p += WARPS) {
    const OutMap o = out_plane(blocked, p / g, p % g, B, T, g, u, rows);
    for (int r = 0; r < rows; ++r) {
      uint4* dst = reinterpret_cast<uint4*>(out + o.base +
                                            (long long)r * o.rstride);
      for (int v = lane; v < vpr; v += 32) dst[v] = ones;
    }
  }
}

// copy: out (32, B, 23, T) = x[:, :, :23]
__global__ void __launch_bounds__(THREADS)
copy_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, int B, int T,
            int g, int u) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int vpr = u / VEC;
  for (int p = warp; p < C * g; p += WARPS) {
    const int c = p / g, gi = p % g;
    const OutMap o = out_plane(false, c, gi, B, T, g, u, F);
    const long long src0 = x_row(c, gi, 0, B, T, g, u);
    for (int r0 = 0; r0 < F; r0 += RU) {
      for (int v = lane; v < vpr; v += 32) {
        uint4 buf[RU];
#pragma unroll
        for (int k = 0; k < RU; ++k)
          if (r0 + k < F)
            buf[k] = __ldg(reinterpret_cast<const uint4*>(
                         x + src0 + (long long)(r0 + k) * T) + v);
#pragma unroll
        for (int k = 0; k < RU; ++k)
          if (r0 + k < F)
            reinterpret_cast<uint4*>(out + o.base +
                                     (long long)(r0 + k) * o.rstride)[v] =
                buf[k];
      }
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0,
                                                  uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_bf16(__float2bfloat16(lo), __float2bfloat16(hi));
}

// Stage sub-tile q (batch row q / n_sub, times (q % n_sub) UT ..) of the
// step: the RIN rows the dots read of the 32 channels, zeros past the
// step's u times.
template <bool BLK>
__device__ __forceinline__ void stage_load(bf16* buf, const bf16* x, int q,
                                           int n_sub, int B, int T, int g,
                                           int u) {
  typedef Tile<BLK> TL;
  const int gi = q / n_sub, t0 = (q % n_sub) * UT;
  for (int i = threadIdx.x; i < TL::CHUNKS; i += THREADS) {
    const int c = i / (TL::RIN * (UT / VEC));
    const int rest = i % (TL::RIN * (UT / VEC));
    const int r = rest / (UT / VEC), j = rest % (UT / VEC);
    const int t = t0 + j * VEC;
    const bool in = t < u;
    const bf16* src = in ? x + x_row(c, gi, r, B, T, g, u) + t : x;
    cp_async16(smem_u32(buf + c * TL::CS + r * UT + j * VEC), src,
               in ? 16 : 0);
  }
}

// matmul (BLK = false) and matblk (BLK = true)
template <bool BLK>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
            bf16* __restrict__ out, int B, int T, int g, int u) {
  typedef Tile<BLK> TL;
  extern __shared__ __align__(16) bf16 xs[];          // [2][C][CS]
  constexpr int FO = TL::FO;
  constexpr int R_OUT = BLK ? ROWS : F;                // rows of the layout
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;

  // A = w^T (64 x 96), A[m][k] = w[k][m]; fragment slots as mma.sync's
  // row-major A: {A[g][2t], A[g][2t+1]}, {A[g+8][..]}, then k + 8
  uint32_t af[MT][KSTEPS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int m0 = mt * 16 + gid, k0 = ks * 16 + 2 * tig;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 8 * (e & 1), k = k0 + 8 * (e >> 1);
        af[mt][ks][e] = pack_bf16(w[k * 64 + m], w[(k + 1) * 64 + m]);
      }
    }

  const int n_sub = (u + UT - 1) / UT, n_q = g * n_sub;
  // ldmatrix.trans row address of this lane: channel `lane`, this warp's
  // time group (times 8 warp .. 8 warp + 7 of the sub-tile)
  const uint32_t lane_off = (lane * TL::CS + warp * 8) * 2;

  stage_load<BLK>(xs, x, 0, n_sub, B, T, g, u);
  cp_async_commit();
  for (int q = 0; q < n_q; ++q) {
    if (q + 1 < n_q) {
      stage_load<BLK>(xs + ((q + 1) & 1) * TL::STAGE, x, q + 1, n_sub, B,
                      T, g, u);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int gi = q / n_sub, t0 = (q % n_sub) * UT;
    const int nv = min(UT, u - t0);                    // a multiple of 8
    if (warp * 8 < nv) {
      const uint32_t base = smem_u32(xs + (q & 1) * TL::STAGE) + lane_off;
      float lo[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) lo[i][e] = 0.f;
      // d rows 0 .. FO: row r's low half meets row r + 1's high half
      for (int r = 0; r <= FO; ++r) {
        const bool need_lo = r < FO, need_hi = r > 0;
        float acc[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          uint32_t b[4];
          ldmatrix_x4_trans(base + (r + s) * UT * 2, b[0], b[1], b[2], b[3]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ks = 2 * s + h;
            if (need_lo) {
              mma_bf16(acc[0], af[0][ks], b[2 * h], b[2 * h + 1]);
              mma_bf16(acc[1], af[1][ks], b[2 * h], b[2 * h + 1]);
            }
            if (need_hi) {
              mma_bf16(acc[2], af[2][ks], b[2 * h], b[2 * h + 1]);
              mma_bf16(acc[3], af[3][ks], b[2 * h], b[2 * h + 1]);
            }
          }
        }
        if (need_hi) {
          // output row r - 1: o = 16 i + gid (+ 8), times 2 tig, 2 tig + 1
          const int t = t0 + warp * 8 + 2 * tig;
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const int o = 16 * i + gid + 8 * e2;
              const OutMap om = out_plane(BLK, o, gi, B, T, g, u, R_OUT);
              *reinterpret_cast<uint32_t*>(
                  out + om.base + (long long)(r - 1) * om.rstride + t) =
                  pack_f32(lo[i][2 * e2] + acc[2 + i][2 * e2],
                           lo[i][2 * e2 + 1] + acc[2 + i][2 * e2 + 1]);
            }
        }
        if (need_lo) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) lo[i][e] = acc[i][e];
        }
      }
    }
    if (BLK) {
      // rows 24..31 of the sub-tile's times are zero
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      for (int i = tid; i < C * (ROWS - FO) * (UT / VEC); i += THREADS) {
        const int o = i / ((ROWS - FO) * (UT / VEC));
        const int rest = i % ((ROWS - FO) * (UT / VEC));
        const int r = FO + rest / (UT / VEC), j = rest % (UT / VEC);
        if (j * VEC < nv) {
          const OutMap om = out_plane(true, o, gi, B, T, g, u, ROWS);
          *reinterpret_cast<uint4*>(out + om.base + (long long)r * om.rstride +
                                    t0 + j * VEC) = zero;
        }
      }
    }
    __syncthreads();          // every warp is done with this buffer before
                              // the next iteration's load refills it
  }
}

}  // namespace

// x (32, B, 32, T) and w (96, 64) bf16 on the device, 16-byte aligned; out
// of the mode's shape (the header).  B % g == 0, T % u == 0, u % 8 == 0.
// mode: 0 nop, 1 nopF32, 2 nopblk, 3 copy, 4 matmul, 5 matblk.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int aasist_stepcost(const void* x, const void* w, void* out,
                               int mode, int B, int T, int g, int u,
                               void* stream) {
  if (B <= 0 || T <= 0 || g <= 0 || u <= 0 || B % g || T % u || u % VEC ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  if (T / u > 65535) return (int)cudaErrorInvalidValue;   // grid.y
  const dim3 grid(B / g, T / u);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w);
  bf16* op = static_cast<bf16*>(out);
  cudaError_t e = cudaSuccess;
  switch (mode) {
    case NOP:
      fill_kernel<<<grid, THREADS, 0, s>>>(op, B, T, g, u, F, 0);
      break;
    case NOPF32:
      fill_kernel<<<grid, THREADS, 0, s>>>(op, B, T, g, u, ROWS, 0);
      break;
    case NOPBLK:
      fill_kernel<<<grid, THREADS, 0, s>>>(op, B, T, g, u, ROWS, 1);
      break;
    case COPY:
      copy_kernel<<<grid, THREADS, 0, s>>>(xp, op, B, T, g, u);
      break;
    case MATMUL:
    case MATBLK: {
      auto kernel = mode == MATMUL ? gemm_kernel<false> : gemm_kernel<true>;
      const int smem = mode == MATMUL ? Tile<false>::SMEM : Tile<true>::SMEM;
      if ((e = cudaFuncSetAttribute(
               kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess)
        return (int)e;
      kernel<<<grid, THREADS, smem, s>>>(xp, wp, op, B, T, g, u);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
