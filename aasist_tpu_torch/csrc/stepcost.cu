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
// and writes its output once against 3.35 TB/s (at B = 128, T = 7168: nop
// 1.35 GB written, 0.403 ms; nopF32 and nopblk 0.561 ms; copy 0.806 ms;
// matblk 1.59 GB read and 1.88 GB written); matmul's 2.6e11 FLOP would take
// 0.26 ms at the tensor cores' 989 TFLOP/s against 0.86 ms of bytes.
//
// What the design does about it.  A TPU step's block of x is 32 g 32 u
// values, 4.2 MB at (g, u) = (8, 256) and 67 MB at (32, 1024): far more than
// a CTA's 227 KB of shared memory, so a CTA streams its step.
// - nop, nopF32, copy: the step's output goes out by TMA stores
//   (cp.async.bulk.tensor, the counterpart of a Pallas output BlockSpec),
//   a box of (ub times, 23 or 32 rows, 1 batch row, cb channels) at a time:
//   ub = u / nbox for the fewest boxes along time that keep ub <= 256 and a
//   multiple of 8, cb the most channels (a power of two) that keep a box
//   within 16 KB, so that three boxes a CTA let all of block 0's grid (448
//   CTAs at (8, 256)) be resident at once.  The tensor maps are encoded on
//   the host with cuTensorMapEncodeTiled, got through
//   cudaGetDriverEntryPoint (no -lcuda: the C interface stays), and passed
//   as __grid_constant__ parameters.
//   - nop, nopF32: the CTA fills one box of shared memory with 1.0 once;
//     one thread then issues the step's stores of that box, commits them as
//     one bulk group and waits for their reads of shared memory
//     (wait_group.read) before the CTA exits.
//   - copy: one thread drives a ring of NST = 3 boxes: TMA loads of x's
//     rows 0..22 (an mbarrier with expect-tx a stage) run NST - 1 boxes
//     ahead of the TMA stores that write each box back out, and a stage is
//     loaded again once the store that read it is done reading
//     (wait_group.read 1).  nop and copy then differ by the input's bytes.
//   - nopblk: a step's output is one contiguous region, written by 1-D
//     bulk stores (cp.async.bulk) of one 16 KB tile of 1.0.
//   One CTA per step stays, so that the (g, u) sweep still tells a fixed
//   cost per step from a cost per byte.
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
// STEPCOST_OLDER, a build of its own: nop, nopF32, nopblk and copy run the
// kernels the TMA ones replaced, which the default build is timed against.
// A warp takes (channel, batch row) planes of the step and moves each row
// of u times in 16-byte vectors, lanes on neighbouring vectors; copy issues
// eight rows' loads before their stores.  matmul and matblk are the same in
// both builds.
//
// Geometry: B % g == 0, T % u == 0, u % 8 == 0 (rows start on 16-byte
// boundaries; with T a multiple of u every global stride of the tensor maps
// is then a multiple of 16 bytes, and so are a box's rows, as TMA needs).
// A sub-tile's ragged tail (u % 64) is masked by whole 8-time groups, which
// u % 8 == 0 makes exact.

#include <cuda.h>           // CUtensorMap and its enums: types only
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

#ifdef STEPCOST_OLDER
// ------------------------------ the kernels the TMA ones replaced
constexpr int RU = 8;            // rows a copy lane loads before storing

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
#endif  // STEPCOST_OLDER

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

#ifndef STEPCOST_OLDER
// ------------------------------------------------- the TMA stores (default)
constexpr int TMA_THREADS = 128;
constexpr int BOX_MAX = 16384;   // bytes of one box, and of nopblk's tile
constexpr int NST = 3;           // copy's ring of boxes
constexpr int SMEM_ALIGN = 128;  // TMA's shared-memory alignment

// The first 128-byte boundary of the dynamic shared memory.
__device__ __forceinline__ unsigned char* smem_base(unsigned char* raw) {
  return raw + ((SMEM_ALIGN - (smem_u32(raw) & (SMEM_ALIGN - 1))) &
                (SMEM_ALIGN - 1));
}

// `bytes` (a multiple of 16) of 1.0 from `tile`, then the fence that makes
// the generic proxy's stores visible to TMA's reads; all threads.
__device__ __forceinline__ void fill_ones(unsigned char* tile, int bytes) {
  const uint4 ones = make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u,
                                0x3F803F80u);
  for (int i = threadIdx.x; i < bytes / 16; i += TMA_THREADS)
    reinterpret_cast<uint4*>(tile)[i] = ones;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int t, int r, int b,
                                          int c) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(t), "r"(r),
        "r"(b), "r"(c)
      : "memory");
}

__device__ __forceinline__ void tma_load(const CUtensorMap* map,
                                         uint32_t dst, uint32_t bar, int t,
                                         int r, int b, int c) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(t),
        "r"(r), "r"(b), "r"(c)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// nop, nopF32: the step's boxes of `om` (the output's map, (T, rows, B, 32)
// innermost first) stored from one box of 1.0
__global__ void __launch_bounds__(TMA_THREADS)
fill_box_kernel(const __grid_constant__ CUtensorMap om, int g, int u, int ub,
                int cb, int box_bytes) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* tile = smem_base(smem_raw);
  fill_ones(tile, box_bytes);
  if (threadIdx.x != 0) return;
  const uint32_t src = smem_u32(tile);
  const int b0 = blockIdx.x * g, t0 = blockIdx.y * u;
  for (int c = 0; c < C; c += cb)
    for (int gi = 0; gi < g; ++gi)
      for (int t = 0; t < u; t += ub)
        tma_store(&om, src, t0 + t, 0, b0 + gi, c);
  bulk_commit();
  bulk_wait_read<0>();   // the tile stays until TMA has read it
}

// nopblk: the step's contiguous region (32 g 32 u values) by 1-D bulk
// stores of one BOX_MAX tile of 1.0
__global__ void __launch_bounds__(TMA_THREADS)
fill_bulk_kernel(bf16* __restrict__ out, int g, int u) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* tile = smem_base(smem_raw);
  fill_ones(tile, BOX_MAX);
  if (threadIdx.x != 0) return;
  const uint32_t src = smem_u32(tile);
  const long long step = (long long)blockIdx.x * gridDim.y + blockIdx.y;
  const long long bytes = 2LL * C * g * ROWS * u;      // a multiple of 16
  unsigned char* dst = reinterpret_cast<unsigned char*>(out) + step * bytes;
  for (long long off = 0; off < bytes; off += BOX_MAX) {
    const int n = (int)(bytes - off < BOX_MAX ? bytes - off : BOX_MAX);
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], "
                 "%2;\n" ::"l"(dst + off), "r"(src), "r"(n)
                 : "memory");
  }
  bulk_commit();
  bulk_wait_read<0>();
}

// copy: the step's boxes of x's rows 0..22 (`xm`, (T, 32, B, 32)) loaded
// into a ring of NST stages and stored through `om` ((T, 23, B, 32)), both
// by one thread; a box is (ub, 23, 1, cb), so a stage is laid out alike for
// the load and the store.  Box i is (channels i / (g nbox) cb, batch row
// (i / nbox) % g, times (i % nbox) ub) of the step.
__global__ void __launch_bounds__(TMA_THREADS)
copy_box_kernel(const __grid_constant__ CUtensorMap xm,
                const __grid_constant__ CUtensorMap om, int g, int u, int ub,
                int cb, int box_bytes) {
  extern __shared__ unsigned char smem_raw[];
  if (threadIdx.x != 0) return;
  unsigned char* ring = smem_base(smem_raw);
  const int stride = (box_bytes + SMEM_ALIGN - 1) / SMEM_ALIGN * SMEM_ALIGN;
  const uint32_t st0 = smem_u32(ring), bar0 = st0 + NST * stride;
  for (int s = 0; s < NST; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0 + 8 * s)
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  const int nbox = u / ub, n = (C / cb) * g * nbox;
  const int b0 = blockIdx.x * g, t0 = blockIdx.y * u;
  auto load = [&](int i) {
    const int s = i % NST;
    const uint32_t bar = bar0 + 8 * s;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(box_bytes) : "memory");
    tma_load(&xm, st0 + s * stride, bar, t0 + (i % nbox) * ub, 0,
             b0 + (i / nbox) % g, (i / (g * nbox)) * cb);
  };
  for (int i = 0; i < NST && i < n; ++i) load(i);
  for (int i = 0; i < n; ++i) {
    const int s = i % NST;
    mbar_wait(bar0 + 8 * s, (i / NST) & 1);
    tma_store(&om, st0 + s * stride, t0 + (i % nbox) * ub, 0,
              b0 + (i / nbox) % g, (i / (g * nbox)) * cb);
    bulk_commit();
    // the stage box i - 1 was stored from takes box i - 1 + NST, once that
    // store has read it (box i's store may still be reading)
    if (i >= 1 && i - 1 + NST < n) {
      bulk_wait_read<1>();
      load(i - 1 + NST);
    }
  }
  bulk_wait_read<0>();
}
#endif  // STEPCOST_OLDER

#ifndef STEPCOST_OLDER
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query; null where it is missing.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A box of (ub times, rows, 1 batch row, cb channels) for a step of u
// times (the header says how ub and cb are chosen); bytes is its size.
struct Box {
  int ub, cb, bytes;
};

Box box_of(int u, int rows) {
  int nbox = (u + 255) / 256;
  while (u % nbox || (u / nbox) % VEC) ++nbox;   // ends at ub = 8
  const int ub = u / nbox;
  int cb = C;
  while (cb > 1 && 2 * ub * rows * cb > BOX_MAX) cb /= 2;
  return {ub, cb, 2 * ub * rows * cb};
}

// The tensor map of a bf16 (32, B, rows, T) array at `base`, innermost
// first (T, rows, B, 32), in boxes of (ub, box_rows, 1, cb).
bool encode(CUtensorMap* map, const void* base, int B, int T, int rows,
            int box_rows, const Box& bx) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)T, (cuuint64_t)rows, (cuuint64_t)B,
                              (cuuint64_t)C};
  const cuuint64_t strides[3] = {2ull * T, 2ull * T * rows,
                                 2ull * T * rows * B};   // bytes, dims 1..3
  const cuuint32_t box[4] = {(cuuint32_t)bx.ub, (cuuint32_t)box_rows, 1u,
                             (cuuint32_t)bx.cb};
  const cuuint32_t estride[4] = {1u, 1u, 1u, 1u};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
#endif  // STEPCOST_OLDER

}  // namespace

// x (32, B, 32, T) and w (96, 64) bf16 on the device, 16-byte aligned; out
// of the mode's shape (the header), 16-byte aligned.  B % g == 0,
// T % u == 0, u % 8 == 0.  mode: 0 nop, 1 nopF32, 2 nopblk, 3 copy,
// 4 matmul, 5 matblk.  Returns the launch's cudaError_t (0 on success;
// cudaErrorInvalidValue also where a tensor map cannot be encoded).
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
#ifdef STEPCOST_OLDER
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
#else
    case NOP:
    case NOPF32: {
      const int rows = mode == NOP ? F : ROWS;
      const Box bx = box_of(u, rows);
      CUtensorMap om;
      if (!encode(&om, out, B, T, rows, rows, bx))
        return (int)cudaErrorInvalidValue;
      fill_box_kernel<<<grid, TMA_THREADS, bx.bytes + SMEM_ALIGN, s>>>(
          om, g, u, bx.ub, bx.cb, bx.bytes);
      break;
    }
    case NOPBLK:
      fill_bulk_kernel<<<grid, TMA_THREADS, BOX_MAX + SMEM_ALIGN, s>>>(op, g,
                                                                      u);
      break;
    case COPY: {
      const Box bx = box_of(u, F);
      CUtensorMap xm, om;
      if (!encode(&xm, x, B, T, ROWS, F, bx) ||
          !encode(&om, out, B, T, F, F, bx))
        return (int)cudaErrorInvalidValue;
      const int smem = NST * ((bx.bytes + SMEM_ALIGN - 1) / SMEM_ALIGN *
                              SMEM_ALIGN) + NST * 8 + SMEM_ALIGN;
      if ((e = cudaFuncSetAttribute(
               copy_box_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
               smem)) != cudaSuccess)
        return (int)e;
      copy_box_kernel<<<grid, TMA_THREADS, smem, s>>>(xm, om, g, u, bx.ub,
                                                      bx.cb, bx.bytes);
      break;
    }
#endif
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
