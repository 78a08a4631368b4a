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

// pk bits of a W-word key starting at bit position `start` (bit 0 = MSB
// of word 0).  Bit-identical to repro's core/btree._slice_bits: the start
// is clipped into the key, the (word, word+1) straddle reads zero past the
// key's end, and the top pk bits of the 32-bit window are kept.  The shift
// `w1 >> (32 - sh)` is undefined for sh == 0 in C, so it is guarded; the
// reference's `where` hides the same case.  pk is in [1, 32].
__device__ __forceinline__ uint32_t pk_window(const int64_t* __restrict__ key,
                                              int n_words, int64_t start,
                                              int pk) {
  const int64_t last = (int64_t)n_words * 32 - 1;
  start = start < 0 ? 0 : (start > last ? last : start);
  const int wi = (int)(start >> 5);
  const int sh = (int)(start & 31);
  const uint32_t w0 = (uint32_t)key[wi];
  const uint32_t w1 = wi + 1 < n_words ? (uint32_t)key[wi + 1] : 0u;
  const uint32_t hi = w0 << sh;
  const uint32_t lo = sh == 0 ? 0u : (w1 >> (32 - sh));
  return (hi | lo) >> (32 - pk);
}
