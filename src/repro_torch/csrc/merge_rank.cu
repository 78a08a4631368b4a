// Merge-path ranks of the chunked sort's ladder and the incremental merge
// (paper §5.2 cascade, the delta merge of run_incremental) for Hopper.
//
// Replaces repro/kernels/merge/kernel.py::_rank_kernel / merge_rank_planes,
// the TPU kernel that keeps the whole searched run resident in VMEM as
// (W+1, n_s) word planes and runs a fixed bit_length(n_s) steps of
// lane-gather + multiword compare over a tile of queries.  Here one thread
// owns one query and runs a plain lower-bound binary search over the
// searched run in global memory: the compare is lexicographic over the key
// words, then the row word, on the low 32 bits of the int64 carriers,
// unsigned.  Ranks are exact, so the step count does not matter.
//
// Bound: bytes, counting each row of both runs read once and one int32
// written per query; in fact latency.  Every step is a dependent load of
// one searched row; the first steps of all threads hit the same few rows,
// which stay in L1/L2, and only the last steps reach device memory.  There is no size cap on the searched
// run (the TPU kernel needed it to fit VMEM), no tile padding of the
// queries (the ragged edge is masked here), and no (W+1, n) plane
// transpose: keys are read row-major, as the pipeline holds them.
#include "common.cuh"

namespace {

__global__ void merge_rank_kernel(const int64_t* __restrict__ keys_q,
                                  const int64_t* __restrict__ rows_q,
                                  const int64_t* __restrict__ keys_s,
                                  const int64_t* __restrict__ rows_s,
                                  int32_t* __restrict__ out, int64_t n_q,
                                  int64_t n_s, int n_words) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_q) return;
  const int64_t* q = keys_q + i * n_words;
  const uint32_t q_row = (uint32_t)rows_q[i];
  int64_t lo = 0, hi = n_s;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const int64_t* s = keys_s + mid * n_words;
    // (key_s, row_s)[mid] < (key_q, row_q)?
    int cmp = 0;
    for (int w = 0; w < n_words; ++w) {
      const uint32_t a = (uint32_t)s[w];
      const uint32_t b = (uint32_t)q[w];
      if (a != b) {
        cmp = a < b ? -1 : 1;
        break;
      }
    }
    const bool less = cmp < 0 || (cmp == 0 && (uint32_t)rows_s[mid] < q_row);
    if (less) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  out[i] = (int32_t)lo;
}

}  // namespace

extern "C" int repro_merge_rank(const void* keys_q, const void* rows_q,
                                const void* keys_s, const void* rows_s,
                                void* out, int64_t n_q, int64_t n_s,
                                int n_words, void* stream) {
  const int threads = 256;
  const int64_t blocks = (n_q + threads - 1) / threads;
  merge_rank_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)keys_q, (const int64_t*)rows_q, (const int64_t*)keys_s,
      (const int64_t*)rows_s, (int32_t*)out, n_q, n_s, n_words);
  return (int)cudaGetLastError();
}
