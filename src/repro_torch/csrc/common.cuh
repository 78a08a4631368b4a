// Shared pieces of the port's CUDA kernels.
//
// Every key word, row id and record id crosses the C interface as a
// 64-bit integer holding a value in 0 .. 2^32-1 (the port's int64 carrier,
// see repro_torch/core/u32.py).  Kernels read the low word as uint32_t and
// do all bit arithmetic in 32 bits, where shifts drop high bits exactly as
// the reference's uint32 arithmetic does.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The pk-bit window of a key whose start word is w0, the next word w1 (0
// past the key's end) and the bit offset in w0 sh: the top pk bits of the
// 32-bit window.  The shift `w1 >> (32 - sh)` is undefined for sh == 0 in
// C, so it is guarded; the reference's `where` hides the same case.  pk is
// in [1, 32].
__device__ __forceinline__ uint32_t window_bits(uint32_t w0, uint32_t w1, int sh,
                                                int pk) {
  const uint32_t hi = w0 << sh;
  const uint32_t lo = sh == 0 ? 0u : (w1 >> (32 - sh));
  return (hi | lo) >> (32 - pk);
}

// A start bit position clipped into a W-word key (bit 0 = MSB of word 0).
__device__ __forceinline__ int clip_start(int64_t start, int n_words) {
  const int64_t last = (int64_t)n_words * 32 - 1;
  return (int)(start < 0 ? 0 : (start > last ? last : start));
}

// pk bits of a W-word key starting at bit position `start`.  Bit-identical
// to repro's core/btree._slice_bits: the start is clipped into the key, the
// (word, word+1) straddle reads zero past the key's end, and the top pk
// bits of the 32-bit window are kept.
__device__ __forceinline__ uint32_t pk_window(const int64_t* __restrict__ key,
                                              int n_words, int64_t start,
                                              int pk) {
  const int s = clip_start(start, n_words);
  const int wi = s >> 5;
  const uint32_t w0 = (uint32_t)key[wi];
  const uint32_t w1 = wi + 1 < n_words ? (uint32_t)key[wi + 1] : 0u;
  return window_bits(w0, w1, s & 31, pk);
}
