// Tenant-major partial-key leaf probe of the multi-tenant lookup for Hopper.
//
// Replaces repro/kernels/lookup/kernel.py::_probe_many_kernel /
// probe_planes_many, the TPU kernel that screens every (tenant, query,
// leaf entry) triple of a stacked arena on a (T, pairs/tile) grid.  The
// reference's wrapper first materializes repeat(queries, lc) and the
// gathered starts and partial keys per tenant; here one thread owns one
// (query, entry) pair of one tenant (grid.y is the tenant) and gathers
// for itself, exactly as probe.cu does for one tree: the leaf node the
// descent chose, the entry's dpos and pk from the stacked leaf arrays,
// and two words of the query's key.  Every operand carries a per-tenant
// stride, so one launch answers the whole arena, and each tenant's row
// of the mask equals probe.cu on that tenant's arrays alone.
//
// Bound: bytes — per pair one node id, one dpos, one pk and at most two
// query words are read and one mask byte written; the reads are gathers,
// so L2 hit rate decides how close it comes to the bound.
#include "common.cuh"

namespace {

__global__ void probe_many_kernel(const int64_t* __restrict__ queries,
                                  const int64_t* __restrict__ node,
                                  const int64_t* __restrict__ leaf_dpos,
                                  const int64_t* __restrict__ leaf_pk,
                                  uint8_t* __restrict__ out, int64_t q,
                                  int n_words, int leaf_cap, int64_t n_leaves,
                                  int pk) {
  const int64_t t = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q * leaf_cap) return;
  const int64_t qi = i / leaf_cap;
  const int64_t row = t * q + qi;  // the query's row in (T, q)
  const int64_t slot =
      (t * n_leaves + node[row]) * leaf_cap + (i - qi * leaf_cap);
  const uint32_t win =
      pk_window(queries + row * n_words, n_words, leaf_dpos[slot] + 1, pk);
  out[t * q * leaf_cap + i] = win == (uint32_t)leaf_pk[slot] ? 1 : 0;
}

}  // namespace

extern "C" int repro_probe_many(const void* queries, const void* node,
                                const void* leaf_dpos, const void* leaf_pk,
                                void* out, int n_tenants, int64_t q,
                                int n_words, int leaf_cap, int64_t n_leaves,
                                int pk, void* stream) {
  const int threads = 256;
  const int64_t blocks = (q * leaf_cap + threads - 1) / threads;
  const dim3 grid((unsigned)blocks, (unsigned)n_tenants);
  probe_many_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)queries, (const int64_t*)node, (const int64_t*)leaf_dpos,
      (const int64_t*)leaf_pk, (uint8_t*)out, q, n_words, leaf_cap, n_leaves,
      pk);
  return (int)cudaGetLastError();
}
