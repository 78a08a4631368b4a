// pext: compressed-key extraction (paper §5.1) for Hopper.
//
// Replaces repro/kernels/pext/kernel.py::_pext_kernel / pext_planes, the
// TPU kernel that applies the extraction plan as a static shift/mask
// schedule over (W, tile) word planes.  Here one thread owns one key: it
// walks the plan's bits in ascending source position, loads each source
// word once (positions ascend, so the word index never goes back), and
// packs the kept bits MSB-first into the compressed words.
//
// The plan travels as a small device array, one int32 per kept bit
// (src_word << 5 | src_shift), staged in shared memory — it is not unrolled
// per plan, so 128-word keys with thousands of D-bits need no recompile.
//
// Bound: bytes.  Each key is read once (W words) and Wc words are written;
// the bit loop is a few integer ops per kept bit.  Keys are read row-major,
// as the pipeline holds them; each word of a thread's row is loaded once.
#include "common.cuh"

namespace {

__global__ void pext_kernel(const int64_t* __restrict__ keys,
                            const int32_t* __restrict__ plan,
                            int64_t* __restrict__ out, int64_t n, int n_words,
                            int n_words_out, int n_bits) {
  extern __shared__ int32_t s_plan[];
  for (int i = threadIdx.x; i < n_bits; i += blockDim.x) s_plan[i] = plan[i];
  __syncthreads();
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int64_t* key = keys + row * n_words;
  int64_t* dst = out + row * n_words_out;
  int cur_w = -1;
  uint32_t cur = 0;
  int b = 0;
  for (int dw = 0; dw < n_words_out; ++dw) {
    uint32_t acc = 0;
    const int end = min(n_bits, (dw + 1) * 32);
    for (; b < end; ++b) {
      const int p = s_plan[b];
      const int sw = p >> 5;
      if (sw != cur_w) {
        cur = (uint32_t)key[sw];
        cur_w = sw;
      }
      acc |= ((cur >> (p & 31)) & 1u) << (31 - (b & 31));
    }
    dst[dw] = (int64_t)acc;
  }
}

}  // namespace

extern "C" int repro_pext(const void* keys, const void* plan, void* out,
                          int64_t n, int n_words, int n_words_out, int n_bits,
                          void* stream) {
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  pext_kernel<<<(unsigned)blocks, threads, n_bits * sizeof(int32_t),
                (cudaStream_t)stream>>>(
      (const int64_t*)keys, (const int32_t*)plan, (int64_t*)out, n, n_words,
      n_words_out, n_bits);
  return (int)cudaGetLastError();
}
