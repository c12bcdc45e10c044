// Phase timer of the block-0 kernels' B0P_TIMER builds (csrc/block0_pipe.cu,
// csrc/fused_block0.cu): the side buffer, its slot layout, the clocks and
// the host's read.  ops/block0_pipe.py (TIMER_SLOTS, TIMER_PHASES,
// phase_ms) reads the same layout.
//
// Per CTA, NSLOT 64-bit words: 0 / 1 the CTA's first and last clock64,
// 2 / 3 its first and last %globaltimer (ns), 4 the items it ran, then from
// 5 on clock64 deltas summed over the items, one slot per phase, each
// kernel naming its own phases.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NSLOT = 12;
constexpr int MAX_CTAS = 1024;

#ifdef B0P_TIMER
__device__ unsigned long long g_timer[MAX_CTAS * NSLOT];
int g_timer_grid = 0;      // the CTAs of the last timed launch

// Before a timed launch of `grid` CTAs: the buffer has room for them.
inline cudaError_t timer_arm(int grid) {
  if (grid > MAX_CTAS) return cudaErrorInvalidConfiguration;
  g_timer_grid = grid;
  return cudaSuccess;
}

// This CTA's NSLOT words.
__device__ __forceinline__ unsigned long long* timer_words() {
  return g_timer + (size_t)blockIdx.x * NSLOT;
}
#endif

__device__ __forceinline__ unsigned long long clk() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Timer builds: copy the last timed launch's side buffer, (CTAs, NSLOT)
// words, into dst (device memory of at least MAX_CTAS x NSLOT words) on
// the stream; *ctas gets the launch's CTA count.  Other builds return
// cudaErrorNotSupported.
inline int timer_read(void* dst, int* ctas, void* stream) {
#ifdef B0P_TIMER
  *ctas = g_timer_grid;
  return (int)cudaMemcpyFromSymbolAsync(
      dst, g_timer, sizeof(unsigned long long) * NSLOT * g_timer_grid, 0,
      cudaMemcpyDeviceToDevice, static_cast<cudaStream_t>(stream));
#else
  (void)dst;
  *ctas = 0;
  (void)stream;
  return (int)cudaErrorNotSupported;
#endif
}

}  // namespace
