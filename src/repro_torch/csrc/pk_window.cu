// pk-window gather of the bulk build (paper §5.3, option C.b) for Hopper.
//
// Replaces repro/kernels/build/kernel.py::_pk_window_kernel /
// pk_window_planes, the TPU kernel that picks each entry's (word, word+1)
// straddle out of (W, tile) word planes with one compare+select per plane.
// Here one thread owns one entry and reads just the two words it needs
// straight from the row-major key (not all W planes), then applies the
// shared window arithmetic of common.cuh.
//
// Bound: bytes.  Per entry one start is read, one window written, and at
// most two words of the key touched — so the traffic is far below a full
// W-word row, and the gather's scattered 8-byte reads are what the card
// waits on.
#include "common.cuh"

namespace {

__global__ void pk_window_kernel(const int64_t* __restrict__ words,
                                 const int64_t* __restrict__ starts,
                                 int64_t* __restrict__ out, int64_t m,
                                 int n_words, int pk) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  out[i] = (int64_t)pk_window(words + i * n_words, n_words, starts[i], pk);
}

}  // namespace

extern "C" int repro_pk_window(const void* words, const void* starts, void* out,
                               int64_t m, int n_words, int pk, void* stream) {
  const int threads = 256;
  const int64_t blocks = (m + threads - 1) / threads;
  pk_window_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)words, (const int64_t*)starts, (int64_t*)out, m, n_words,
      pk);
  return (int)cudaGetLastError();
}
