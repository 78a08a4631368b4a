// Bitonic block sort of multiword keys for Hopper.
//
// Replaces repro/kernels/bitonic/kernel.py::_bitonic_kernel /
// bitonic_block_sort_planes, the TPU kernel that sorts each `block`-lane
// block of (W+1, n) word planes in VMEM with a bitonic network (paper
// Appendix A step 3.1, the row-column sort's base blocks).
//
// One thread block sorts one `block`-row block.  It stages the block in
// shared memory as W key planes plus the row plane, all uint32 (rows at or
// past n read as all-ones in every plane, exactly the reference's
// sentinel padding), runs the network with one __syncthreads() per
// substage, and writes the rows below n back row-major.  Each thread owns
// block/(2*blockDim) compare-exchange pairs per substage.  The rule is the
// reference's per-lane keep rule seen from the pair: in an ascending
// region the pair swaps only when lo > hi, in a descending one only when
// lo < hi, so ties keep their own entries and no payload is duplicated.
// Like the reference the network is not stable; the backend's keyed sort
// of the block runs restores the (key, row) order.
//
// Bound: bytes at the block sizes used (each row read once, written
// once); the 45 substages of a 512-row block run out of shared memory.
// Shared memory holds (W+1) * block * 4 bytes: 10 KB for the slice's
// 4-word compressed keys, 34 KB for the 16-word full-key baseline.  The
// wrapper refuses a launch past the 48 KB a block gets without opting in.
#include "common.cuh"

namespace {

__global__ void bitonic_block_sort_kernel(const int64_t* __restrict__ keys,
                                          const int64_t* __restrict__ rows,
                                          int64_t* __restrict__ keys_out,
                                          int64_t* __restrict__ rows_out,
                                          int64_t n, int n_words,
                                          int n_key_words, int block) {
  extern __shared__ uint32_t s[];  // plane p, lane l at s[p * block + l]
  const int64_t base = (int64_t)blockIdx.x * block;
  const int planes = n_words + 1;
  for (int f = threadIdx.x; f < block * n_words; f += blockDim.x) {
    const int lane = f / n_words, w = f % n_words;
    const int64_t g = base + lane;
    s[w * block + lane] = g < n ? (uint32_t)keys[g * n_words + w] : 0xFFFFFFFFu;
  }
  for (int lane = threadIdx.x; lane < block; lane += blockDim.x) {
    const int64_t g = base + lane;
    s[n_words * block + lane] = g < n ? (uint32_t)rows[g] : 0xFFFFFFFFu;
  }
  __syncthreads();
  for (int k = 2; k <= block; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < block / 2; t += blockDim.x) {
        const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int hi = lo | j;
        int cmp = 0;
        for (int w = 0; w < n_key_words; ++w) {
          const uint32_t a = s[w * block + lo], b = s[w * block + hi];
          if (a != b) {
            cmp = a < b ? -1 : 1;
            break;
          }
        }
        const bool ascending = (lo & k) == 0;
        if (ascending ? cmp > 0 : cmp < 0) {
          for (int p = 0; p < planes; ++p) {
            const uint32_t tmp = s[p * block + lo];
            s[p * block + lo] = s[p * block + hi];
            s[p * block + hi] = tmp;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int f = threadIdx.x; f < block * n_words; f += blockDim.x) {
    const int lane = f / n_words, w = f % n_words;
    const int64_t g = base + lane;
    if (g < n) keys_out[g * n_words + w] = (int64_t)s[w * block + lane];
  }
  for (int lane = threadIdx.x; lane < block; lane += blockDim.x) {
    const int64_t g = base + lane;
    if (g < n) rows_out[g] = (int64_t)s[n_words * block + lane];
  }
}

}  // namespace

extern "C" int repro_bitonic_block_sort(const void* keys, const void* rows,
                                        void* keys_out, void* rows_out,
                                        int64_t n, int n_words,
                                        int n_key_words, int block,
                                        void* stream) {
  const int threads = block / 2 < 1024 ? block / 2 : 1024;
  const int64_t blocks = (n + block - 1) / block;
  const size_t smem = (size_t)(n_words + 1) * block * sizeof(uint32_t);
  bitonic_block_sort_kernel<<<(unsigned)blocks, threads, smem,
                              (cudaStream_t)stream>>>(
      (const int64_t*)keys, (const int64_t*)rows, (int64_t*)keys_out,
      (int64_t*)rows_out, n, n_words, n_key_words, block);
  return (int)cudaGetLastError();
}
