// The matrix-unit shape probe's chained dots on Hopper's warpgroup MMA
// (wgmma, sm_90a), with w's M split over a thread block cluster.
//
// Replaces the TPU kernel tools/probe_mxu_shapes.py:_kernel (launched by its
// `run`), as csrc/mma_shapes.cu (mma.sync) did before; that kernel stays as
// the older yardstick.  w is (K, M) bf16, a (K, N) bf16; each of n
// iterations computes y = w^T a in f32 (M x N), s = eps * sum_m y^2 (f32)
// and a[0] = bf16(a[0] + bf16(s)): the next dot reads what the last one
// wrote, so no dot can be skipped or hoisted.  The kernel returns the final
// a (K, N).
//
// What bounds it on the H100: operations.  Each dot is 2 K M N FLOP on
// operands that stay on chip, so the least time of a dot is 2 K M N over the
// tensor cores' 989 TFLOP/s (bf16, dense).  What held the older kernel back
// was latency: every dot reloaded B by ldmatrix, met its 8 warps twice
// behind __syncthreads, and ran long chains of dependent mma.sync; and at
// the large shapes shared memory, since every warp read all of w^T by
// ldmatrix each dot (184 KB at k144_m630, over 1,400 cycles of the SM's
// 128 bytes a clock).
//
// The design: the columns of a are wgmma's M.  The product is computed as
// y^T = a^T w, one 64-row tile of a^T (64 columns of a) a warpgroup, one
// warpgroup a CTA:
// - A, the 64 columns' K values, and B, a slice of w (K x NW columns of M),
//   are packed once into shared memory in wgmma's no-swizzle K-major
//   core-matrix layout (8 rows x 8 k of 16 bytes a block; the two k-halves
//   of a k-step LBO = 128 bytes apart, the 8-row blocks SBO = 256 bytes
//   apart) and read by descriptors, but for k-step 0's A, which holds row
//   0 of a and is read from registers.
// - A dot is one m64nNk16 a k-step with N the whole slice (two of N / 2
//   past 256): N / 2 clocks of tensor work against 2 KB of A and 32 N bytes
//   of B, 16 + N / 4 clocks of shared memory, so from N = 64 up the tensor
//   cores and not shared memory are the limit.  KT wgmmas a dot, issued as
//   one group and waited on once; each wgmma's descriptors are the bases
//   plus immediates added inside its asm, so that no register a wgmma reads
//   is defined between the wgmmas of a group.
// - Warp w of the warpgroup owns accumulator rows 16 w .. 16 w + 15, that
//   is whole columns of a: a column's sum of squares is a lane's own
//   accumulators (four partial sums a row), then two shuffles over the
//   lanes of a quad.  No warp meets another for the sums.
// - Row 0 of a, the only one that changes, lives in k-step 0's register-A
//   fragment (the low halves of its registers 0 and 1 in the lanes with
//   lane % 4 == 0, rows g and g + 8 of their warp): the update is a
//   register write, with no shared-memory store, proxy fence or barrier
//   between dots.  Only that one wgmma of a group reads registers, and it
//   goes first, so ptxas needs no warpgroup.arrive inside the group.
// - 64 columns leave only N / 64 = 32 tiles at N = 2048, so w's M can be
//   split over a cluster of CL CTAs (CL = 1 or 2, a constant of each shape
//   in the wrapper's table), each holding NW = ceil(M / CL) rounded up to
//   16 columns of w and the same 64 columns of a.  With CL = 2 the CTAs
//   exchange their partial sums through distributed shared memory: lane 1
//   of each quad of rank 0 and lane 0 of rank 1 send their two rows'
//   partials to the other rank by st.async, which counts the 8 bytes on
//   the peer's mbarrier of the dot's parity; a CTA arms its own mbarrier
//   for 256 bytes, waits for it, and adds the two partials in rank order,
//   so both hold the same bits of row 0.  Slots and mbarriers alternate
//   with the dot's parity: a peer can run one dot ahead, never two, since
//   its next dot needs this CTA's partials.  CL = 1 launches no cluster and
//   skips the exchange.
//
// Rounding as before: f32 sums (in another order than the plain version),
// bf16(eps s), then the bf16 add.  K pads to 16 KT and M to CL NW, with
// zeros on both sides.
//
// The readings this was chosen by (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
// row 12b and section 6):
// - The orientation.  The other one, w^T as A (64-row m-tiles, from shared
//   memory) and each warpgroup's 16-column chain as an n16 B, its 4 warps
//   meeting behind a 128-thread named barrier, was built as a throwaway and
//   timed in turns with this kernel at all twelve shapes (us a dot, this
//   kernel first): k132_m210 0.715 / 0.637, k144_m630 1.293 / 1.288,
//   k256_m256 0.976 / 0.987, k12_m192 0.254 / 0.305; it took less time at 4
//   shapes (7-17 %), the same at 2 (within 1.1 %), more at 6 (6-32 %), and
//   7.174 us summed over the twelve against 7.056 here; two chains a CTA
//   sharing w^T took 1.1-1.8x its time again.  Every dot reads all of w^T
//   from shared memory for 16 columns (20 clocks an m64n16k16 of 8 clocks'
//   tensor work), so that design stays under 40 % of the tensor rate, and
//   it pays a barrier, a shared-memory update of row 0 and a proxy fence a
//   dot.  This one is kept: faster summed and at more shapes.
// - The cluster size of each shape: the fastest of 1, 2 and 4, timed in
//   turns (2 at k132_m210 0.713 against 0.785 at 1, k144_m630 1.263
//   against 1.314 at 4, k384_m96 0.781 / 0.801, k256_m256 0.979 / 1.321;
//   1 at the rest, k12_m192 0.251 against 0.450 at 2 and 0.614 at 4).  A
//   dot costs its tensor time plus a fixed latency (the wgmma group's, the
//   sums', the update's), and an exchange adds ~0.20 us a dot at 2 CTAs,
//   ~0.36 at 4, so only the four largest dots split M.
// - Designs read and dropped on the way (builds no longer in the tree):
//   row 0 written back to the A tile each dot behind a proxy fence and a
//   __syncthreads (1-8 % slower at 33 of 35 cases); one m64n16k16 a
//   16-column tile of the slice and a barrier.cluster a dot (slower than
//   the older kernel at 10 shapes of 12); A in registers at
//   every k-step (ptxas copies A into register quads and injects a
//   warpgroup.arrive before every wgmma of a group after the first, which
//   serialises them); the next dot's k-steps 1 .. issued ahead into a second
//   set of accumulators (slower at every shape); one CTA an SM forced
//   through shared memory (too few clusters of 4 fit at once); the exchange
//   by tagged 64-bit DSMEM stores polled in place (slower at every cluster
//   size).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128;             // one warpgroup a CTA
constexpr int COLS = 64;                 // columns of a a cluster chains
constexpr int NTILE = 16;                // slices of w pad to n16 tiles
constexpr int MAX_CL = 2;                // CTAs a cluster at most
constexpr int B_LBO = 128;               // bytes between k-half blocks
constexpr int B_SBO = 256;               // bytes between 8-row blocks
constexpr int A_KSTEP = COLS * 16 * 2;   // bytes of A a k-step

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// A descriptor of the packed tile at `addr`, no swizzle.
__device__ __forceinline__ uint64_t desc_of(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(B_LBO >> 4) << 16) | ((uint64_t)(B_SBO >> 4) << 32);
}

// d (64 x N, f32) (+)= a (64 x 16, bf16) * b (16 x N, bf16), N = 16 C,
// K-major: `mma` reads a at descriptor adesc + AO, `mma_rs` from the
// registers a (mma.sync m16n8k16's A layout in each warp), b at bdesc + BO
// (offsets in 16 bytes); SC = 0 overwrites d.  The offsets are added inside
// the asm.  Operands: the accumulators %0 .. %(8 C - 1), then I0 .. I6:
// adesc, bdesc, AO, BO, SC for `mma`; a[0..3], bdesc, BO, SC for `mma_rs`.
template <int C>
struct Wg;
#define F8(b)                                                             \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),            \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define F16(b) F8(b), F8(b + 8)
#define F32(b) F16(b), F16(b + 16)
#define F64(b) F32(b), F32(b + 32)
#define R0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define R1 R0 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define R2 R1 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define R3 R2 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define R4 R3 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define R5 R4 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define R6 R5 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define R7 R6 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define R8 R7 ", %64, %65, %66, %67, %68, %69, %70, %71"
#define R9 R8 ", %72, %73, %74, %75, %76, %77, %78, %79"
#define R10 R9 ", %80, %81, %82, %83, %84, %85, %86, %87"
#define R11 R10 ", %88, %89, %90, %91, %92, %93, %94, %95"
#define WG_WIDTH(C, N, DREGS, I0, I1, I2, I3, I4, I5, I6, ...)             \
  template <>                                                             \
  struct Wg<C> {                                                          \
    template <int AO, int BO, int SC>                                     \
    static __device__ __forceinline__ void mma(float (&d)[8 * C],         \
                                               uint64_t adesc,            \
                                               uint64_t bdesc) {          \
      asm volatile(                                                       \
          "{\n.reg .pred p;\n.reg .b32 s;\n.reg .b64 da, db;\n"           \
          "mov.b32 s, " I4 ";\nsetp.ne.b32 p, s, 0;\n"                    \
          "add.s64 da, " I0 ", " I2 ";\n"                                 \
          "add.s64 db, " I1 ", " I3 ";\n"                                 \
          "wgmma.mma_async.sync.aligned.m64n" N "k16.f32.bf16.bf16 {" DREGS \
          "}, da, db, p, 1, 1, 0, 0;\n}\n"                                 \
          : __VA_ARGS__                                                   \
          : "l"(adesc), "l"(bdesc), "n"(AO), "n"(BO), "n"(SC));           \
    }                                                                     \
    template <int BO, int SC>                                             \
    static __device__ __forceinline__ void mma_rs(float (&d)[8 * C],      \
                                                  const uint32_t (&a)[4], \
                                                  uint64_t bdesc) {       \
      asm volatile(                                                       \
          "{\n.reg .pred p;\n.reg .b32 s;\n.reg .b64 db;\n"               \
          "mov.b32 s, " I6 ";\nsetp.ne.b32 p, s, 0;\n"                    \
          "add.s64 db, " I4 ", " I5 ";\n"                                 \
          "wgmma.mma_async.sync.aligned.m64n" N "k16.f32.bf16.bf16 {" DREGS \
          "}, {" I0 ", " I1 ", " I2 ", " I3 "}, db, p, 1, 1, 0;\n}\n"       \
          : __VA_ARGS__                                                   \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc),       \
            "n"(BO), "n"(SC));                                            \
    }                                                                     \
  };
WG_WIDTH(2, "32", R1, "%16", "%17", "%18", "%19", "%20", "%21", "%22",
         F16(0))
WG_WIDTH(3, "48", R2, "%24", "%25", "%26", "%27", "%28", "%29", "%30",
         F16(0), F8(16))
WG_WIDTH(4, "64", R3, "%32", "%33", "%34", "%35", "%36", "%37", "%38",
         F32(0))
WG_WIDTH(6, "96", R5, "%48", "%49", "%50", "%51", "%52", "%53", "%54",
         F32(0), F16(32))
WG_WIDTH(7, "112", R6, "%56", "%57", "%58", "%59", "%60", "%61", "%62",
         F32(0), F16(32), F8(48))
WG_WIDTH(8, "128", R7, "%64", "%65", "%66", "%67", "%68", "%69", "%70",
         F64(0))
WG_WIDTH(10, "160", R9, "%80", "%81", "%82", "%83", "%84", "%85", "%86",
         F64(0), F16(64))
WG_WIDTH(12, "192", R11, "%96", "%97", "%98", "%99", "%100", "%101", "%102",
         F64(0), F32(64))
#undef WG_WIDTH

// Pins the accumulators in program order around the asynchronous wgmmas.
template <int N>
__device__ __forceinline__ void fence_acc(float (&acc)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) asm volatile("" : "+f"(acc[r])::"memory");
}

__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// One arrival on the local mbarrier, expecting `bytes` more of transfers.
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile(
      "{\n.reg .b64 mbst;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 mbst, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}

// Until the local mbarrier's phase of this parity completes; acquire at
// cluster scope, so that the peers' st.async data is visible.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], "
      "%1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// 8 bytes into a peer's shared memory, completing as many bytes of the
// transfer its mbarrier (at `bar`, the peer's address) expects.
__device__ __forceinline__ void st_async_v2(uint32_t addr, float x, float y,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(addr),
      "f"(x), "f"(y), "r"(bar)
      : "memory");
}

// Element (row r, k) of a packed operand of `rows` rows a k-step: k t of
// its 8, row r & 7 of an 8-row block, k half kc, block r >> 3, k-step ks:
// t + 8 (r & 7) + 64 kc + 128 (r >> 3) + 16 rows ks.
__device__ __forceinline__ int packed(int r, int k, int rows) {
  return (k & 7) + 8 * (r & 7) + 64 * ((k >> 3) & 1) + 128 * (r >> 3) +
         16 * rows * (k >> 4);
}

// The KT k-steps of a dot into acc: NI wgmmas of N = 16 C a k-step, the
// slice's columns [16 C i, 16 C (i + 1)); k-step 0 first, its A from the
// registers a0f, overwriting acc; k-steps 1 .. (KS + 1) with A from the
// tile.  A k-step's A lies A_KSTEP bytes after the last one's, its B
// 512 C NI.
template <int C, int NI, int... KS>
__device__ __forceinline__ void issue_dot(float (&acc)[NI][8 * C],
                                          const uint32_t (&a0f)[4],
                                          uint64_t adesc, uint64_t bdesc,
                                          std::integer_sequence<int, KS...>) {
  Wg<C>::template mma_rs<0, 0>(acc[0], a0f, bdesc);
  if constexpr (NI == 2) Wg<C>::template mma_rs<32 * C, 0>(acc[1], a0f, bdesc);
  (Wg<C>::template mma<A_KSTEP / 16 * (KS + 1), 32 * C * NI * (KS + 1), 1>(
       acc[0], adesc, bdesc),
   ...);
  if constexpr (NI == 2)
    (Wg<C>::template mma<A_KSTEP / 16 * (KS + 1),
                         32 * C * (NI * (KS + 1) + 1), 1>(acc[1], adesc,
                                                          bdesc),
     ...);
}

// CTA x of the grid is rank x % cl of column tile x / cl: columns
// [64 (x / cl), + 64) of a, columns [NW rank, + NW) of w, NW = 16 NT,
// issued as NI wgmmas of N = NW / NI a k-step.
template <int KT, int NT>
__global__ void __launch_bounds__(THREADS, 1)
chain_wg_kernel(const bf16* __restrict__ w, const bf16* __restrict__ a,
                bf16* __restrict__ out, int K, int M, int N, int n_iter,
                float eps, int cl) {
  constexpr int NW = NTILE * NT, KP = 16 * KT;
  constexpr int NI = NT > 16 ? 2 : 1, C = NT / NI;
  static_assert(NT % NI == 0 && C <= 16, "wgmma N is at most 256");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);      // B: w's slice
  bf16* as = ws + KP * NW;                           // A: a^T's tile
  __shared__ __align__(16) float2 slot[2][MAX_CL][THREADS / 4];
  __shared__ __align__(8) uint64_t bar[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int rank = (int)(blockIdx.x % cl);
  const int c0 = (int)(blockIdx.x / cl) * COLS;
  const int m0 = rank * NW;
  const bf16 zero = __float2bfloat16(0.f);

  // consecutive threads on consecutive columns of a row of w and of a
  for (int i = tid; i < KP * NW; i += THREADS) {
    const int k = i / NW, m = i % NW;
    ws[packed(m, k, NW)] =
        (k < K && m0 + m < M) ? w[(long long)k * M + m0 + m] : zero;
  }
  for (int i = tid; i < KP * COLS; i += THREADS) {
    const int k = i / COLS, j = i % COLS;
    as[packed(j, k, COLS)] =
        (k < K && c0 + j < N) ? a[(long long)k * N + c0 + j] : zero;
  }

  const uint32_t bar_u32 = smem_u32(&bar[0]);
  if (cl > 1 && tid == 0) {
    mbar_init(bar_u32, 1);
    mbar_init(bar_u32 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the tiles' generic-proxy stores, visible to wgmma's reads; with a
  // cluster, every CTA's mbarriers are set before the first remote store
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (cl > 1) cluster_sync();

  // this lane's partials land in slot[.][rank][warp * 8 + g] of rank q,
  // counted by rank q's mbarrier of the same parity
  const bool sends = cl > 1 && q < cl && q != rank;
  const uint32_t peer_slot =
      sends ? cluster_map(smem_u32(&slot[0][rank][warp * 8 + g]), q) : 0u;
  const uint32_t peer_bar = sends ? cluster_map(bar_u32, q) : 0u;
  const uint64_t adesc = desc_of(smem_u32(as));
  const uint64_t bdesc = desc_of(smem_u32(ws));
  // row 0 of a at rows 16 warp + g and + 8 of the tile: the lanes with
  // q == 0 keep it, in r0 and r8 and in the low halves of a0f[0] and a0f[1]
  bf16* a0 = as + packed(16 * warp + g, 0, COLS);
  bf16 r0 = a0[0], r8 = a0[128];
  // k-step 0's register-A fragment: register j holds row g + 8 (j & 1),
  // k 2 q + 8 (j >> 1) and the next k, the first in the low half
  uint32_t a0f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    a0f[j] = *reinterpret_cast<const uint32_t*>(
        as + packed(16 * warp + g + 8 * (j & 1), 2 * q + 8 * (j >> 1), COLS));
  float acc[NI][8 * C];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int r = 0; r < 8 * C; ++r) acc[i][r] = 0.f;

#pragma unroll 1
  for (int it = 0; it < n_iter; ++it) {
#pragma unroll
    for (int i = 0; i < NI; ++i) fence_acc(acc[i]);
    wgmma_fence();
    issue_dot<C, NI>(acc, a0f, adesc, bdesc,
                     std::make_integer_sequence<int, KT - 1>{});
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < NI; ++i) fence_acc(acc[i]);
    // element e of n8 block nb: row g + 8 ((e >> 1) & 1), column
    // 8 nb + 2 q + (e & 1); four sums a row shorten the chains
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int e = 0; e < 8 * C; ++e)
        s[(e >> 1) & 1][(e >> 2) & 3] =
            fmaf(acc[i][e], acc[i][e], s[(e >> 1) & 1][(e >> 2) & 3]);
    float s0 = (s[0][0] + s[0][1]) + (s[0][2] + s[0][3]);
    float s1 = (s[1][0] + s[1][1]) + (s[1][2] + s[1][3]);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    if (cl > 1) {
      // slot and mbarrier p serve the dots of parity p; the n-th such dot
      // waits for its mbarrier's phase n
      const int p = it & 1;
      const uint32_t bar_p = bar_u32 + 8 * p;
      if (tid == 0)
        mbar_expect(bar_p, (cl - 1) * (THREADS / 4) * (int)sizeof(float2));
      if (sends)
        st_async_v2(peer_slot + p * (int)sizeof(slot[0]), s0, s1,
                    peer_bar + 8 * p);
      mbar_wait(bar_p, (it >> 1) & 1);
      float t0 = 0.f, t1 = 0.f;
      for (int r = 0; r < cl; ++r) {
        const float2 v = r == rank ? make_float2(s0, s1)
                                   : slot[p][r][warp * 8 + g];
        t0 += v.x;
        t1 += v.y;
      }
      s0 = t0;
      s1 = t1;
    }
    if (q == 0) {
      r0 = __float2bfloat16(__bfloat162float(r0) +
                            __bfloat162float(__float2bfloat16(s0 * eps)));
      r8 = __float2bfloat16(__bfloat162float(r8) +
                            __bfloat162float(__float2bfloat16(s1 * eps)));
      a0f[0] = (a0f[0] & 0xFFFF0000u) | __bfloat16_as_ushort(r0);
      a0f[1] = (a0f[1] & 0xFFFF0000u) | __bfloat16_as_ushort(r8);
    }
  }

  // row 0 back into the tile, which the output is read from
  if (q == 0) {
    a0[0] = r0;
    a0[128] = r8;
  }
  __syncthreads();

  if (rank != 0) return;
  for (int i = tid; i < K * COLS; i += THREADS) {
    const int k = i / COLS, j = i % COLS;
    if (c0 + j < N) out[(long long)k * N + c0 + j] = as[packed(j, k, COLS)];
  }
}

template <int KT, int NT>
size_t smem_of() {
  return (size_t)16 * KT * (NTILE * NT + COLS) * sizeof(bf16);
}

template <int KT, int NT>
cudaLaunchConfig_t config_of(int N, int cl, cudaStream_t s,
                             cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((N + COLS - 1) / COLS) * cl));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_of<KT, NT>();
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cl > 1 ? 1 : 0;
  return cfg;
}

template <int KT, int NT>
int prepare() {
  cudaError_t e;
  int dev = 0, max_smem = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&max_smem,
                                  cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  dev)) != cudaSuccess)
    return (int)e;
  if (smem_of<KT, NT>() > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(chain_wg_kernel<KT, NT>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_of<KT, NT>());
}

template <int KT, int NT>
int launch(const bf16* w, const bf16* a, bf16* out, int K, int M, int N,
           int n_iter, float eps, int cl, cudaStream_t s) {
  int e;
  if ((e = prepare<KT, NT>()) != 0) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config_of<KT, NT>(N, cl, s, attr);
  if ((e = (int)cudaLaunchKernelEx(&cfg, chain_wg_kernel<KT, NT>, w, a, out,
                                   K, M, N, n_iter, eps, cl)) != 0)
    return e;
  return (int)cudaGetLastError();
}

}  // namespace

// The (KT, NT) builds: k-steps of 16 and n16 tiles of a CTA's slice of w.
// ops/mma_shapes.py:BUILDS lists the same pairs.
#define MCW_BUILDS(X)                                                     \
  X(9, 7) X(9, 20) X(12, 2) X(24, 3) X(24, 4) X(8, 8)                     \
  X(16, 8) X(1, 12) X(6, 6) X(6, 12) X(12, 6) X(12, 4)

// w (K, M) and a (K, N) bf16 on the device; out (K, N) bf16: a after n_iter
// chained dots (the header), computed by clusters of cl CTAs (1 or 2; the
// wrapper's per-shape table) each holding ceil(M / cl) columns of w rounded
// up to 16.  (ceil(K / 16),
// that count / 16) must be one of MCW_BUILDS.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int aasist_mma_chain_wg(const void* w, const void* a, void* out,
                                   int K, int M, int N, int n_iter, float eps,
                                   int cl, void* stream) {
  if (K <= 0 || M <= 0 || N <= 0 || n_iter < 0 ||
      (cl != 1 && cl != 2))
    return (int)cudaErrorInvalidValue;
  const int kt = (K + 15) / 16;
  const int nt = ((M + cl - 1) / cl + NTILE - 1) / NTILE;
  const bf16* wp = static_cast<const bf16*>(w);
  const bf16* ap = static_cast<const bf16*>(a);
  bf16* op = static_cast<bf16*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MCW_CASE(KT, NT)                                                   \
  if (kt == KT && nt == NT)                                               \
    return launch<KT, NT>(wp, ap, op, K, M, N, n_iter, eps, cl, s);
  MCW_BUILDS(MCW_CASE)
#undef MCW_CASE
  return (int)cudaErrorInvalidValue;
}
