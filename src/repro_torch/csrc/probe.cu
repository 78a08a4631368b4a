// Partial-key leaf probe of the point lookup (paper §4.3) for Hopper.
//
// Replaces repro/kernels/lookup/kernel.py::_probe_kernel / probe_planes,
// the TPU kernel that screens (query, leaf entry) pairs: the query's pk-bit
// window at the entry's dpos + 1, compared with the entry's stored partial
// key.  The reference's wrapper first materializes repeat(queries, lc) and
// the gathered (q, lc) starts and partial keys; here one thread owns one
// (query, entry) pair and gathers for itself: the leaf node the descent
// chose for its query, the entry's dpos and pk from the leaf arrays, and
// two words of the query's key.  The mask it writes is the reference's.
//
// Bound: bytes — per pair one node id, one dpos, one pk and at most two
// query words are read and one mask byte written; the reads are gathers,
// so L2 hit rate decides how close it comes to the bound.
#include "common.cuh"

namespace {

__global__ void probe_kernel(const int64_t* __restrict__ queries,
                             const int64_t* __restrict__ node,
                             const int64_t* __restrict__ leaf_dpos,
                             const int64_t* __restrict__ leaf_pk,
                             uint8_t* __restrict__ out, int64_t q, int n_words,
                             int leaf_cap, int pk) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q * leaf_cap) return;
  const int64_t qi = i / leaf_cap;
  const int64_t slot = node[qi] * leaf_cap + (i - qi * leaf_cap);
  const uint32_t win =
      pk_window(queries + qi * n_words, n_words, leaf_dpos[slot] + 1, pk);
  out[i] = win == (uint32_t)leaf_pk[slot] ? 1 : 0;
}

}  // namespace

extern "C" int repro_probe(const void* queries, const void* node,
                           const void* leaf_dpos, const void* leaf_pk, void* out,
                           int64_t q, int n_words, int leaf_cap, int pk,
                           void* stream) {
  const int threads = 256;
  const int64_t blocks = (q * leaf_cap + threads - 1) / threads;
  probe_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)queries, (const int64_t*)node, (const int64_t*)leaf_dpos,
      (const int64_t*)leaf_pk, (uint8_t*)out, q, n_words, leaf_cap, pk);
  return (int)cudaGetLastError();
}
