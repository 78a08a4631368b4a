// Adjacent distinction bits of a sorted run (paper §4.3 refresh, Remark 1)
// for Hopper.
//
// Replaces repro/kernels/dbit/kernel.py::_dbit_kernel / dbit_planes, the
// TPU kernel that XORs (W, tile) planes of the previous and the current
// rows (two shifted copies that its wrapper builds) and finds the first
// nonzero word with an unrolled running-mask pass.  Here one thread owns
// one adjacent pair (i, i+1) and reads both rows in place from the
// row-major sorted run, with no shifted copies: it stops at the first word
// whose XOR is nonzero and returns 32*w + clz, or NO_DBIT (2^31 - 1) for an
// equal pair.
//
// Bound: bytes.  Each row is read by two neighbouring threads (once as
// "current", once as "previous"), which L1/L2 serve the second time, and
// one int32 is written per pair; the compare is a few integer operations
// per word, and the loop ends at the first differing word.
#include "common.cuh"

namespace {

constexpr int32_t kNoDbit = 0x7FFFFFFF;

__global__ void dbit_kernel(const int64_t* __restrict__ keys,
                            int32_t* __restrict__ out, int64_t m,
                            int n_words) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int64_t* a = keys + i * n_words;
  const int64_t* b = a + n_words;
  int32_t pos = kNoDbit;
  for (int w = 0; w < n_words; ++w) {
    const uint32_t x = (uint32_t)a[w] ^ (uint32_t)b[w];
    if (x != 0u) {
      pos = 32 * w + __clz((int)x);
      break;
    }
  }
  out[i] = pos;
}

}  // namespace

extern "C" int repro_dbit(const void* keys, void* out, int64_t m, int n_words,
                          void* stream) {
  const int threads = 256;
  const int64_t blocks = (m + threads - 1) / threads;
  dbit_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)keys, (int32_t*)out, m, n_words);
  return (int)cudaGetLastError();
}
