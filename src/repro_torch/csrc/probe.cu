// Partial-key leaf probe of the point lookup (paper §4.3) for Hopper, and
// the leaf stage of the lookup that consumes it.
//
// Replaces two TPU kernels, which differ only in a leading tenant axis:
// repro/kernels/lookup/kernel.py::_probe_kernel / probe_planes and
// ::_probe_many_kernel / probe_planes_many.  They screen (query, leaf
// entry) pairs: the query's pk-bit window at the entry's dpos + 1 against
// the entry's stored partial key.  The reference's wrappers materialise
// repeat(queries, lc) and the gathered (q, lc) starts and partial keys
// first, and its lookup then ANDs the mask with a full-key compare over
// every lane's gathered full key (q x lc x W words).
//
// Design: a group of 16 lanes holds a query, two groups a warp (a leaf
// holds at most LEAF_MAX_FANOUT = 14 entries, so 16 lanes cover it), and
// blockIdx.y is the tenant of a stacked arena (T = 1 is the single tree).
// One lane reads the query's leaf node and a shuffle broadcasts it; beside
// it the group loads the query's leading words, one word a lane; lane
// j < lc reads entry j's dpos, pk (and valid), so a leaf's entries are one
// coalesced read; each lane takes its window's two words from the lanes
// that hold them by shuffle, or reads a word past them itself.  So a query
// costs two dependent reads: its node, then its leaf.  The kernel is bound
// by the latency of those reads, the leaf rows being random, so the mask
// form gives a group two queries whose reads are in flight together, and
// preloads only the query's first 32-byte sector (4 carrier words:
// adjacent keys of a sorted set differ early, so the windows of their
// distinction bits fall mostly there); the leaf-stage form, whose confirm
// loop runs one query at a time and needs the whole query, preloads the
// first 16 words.  No division: the query index is a shift of the thread
// index.
//
// Two forms from one template:
// * the mask form writes the (T, q, lc) candidate mask, the TPU kernels'
//   output;
// * the leaf-stage form finishes the lookup's leaf stage in the same pass:
//   a lane is a candidate when its window matches and its entry is valid;
//   the group takes the candidates in lane order (ballot, ffs) and compares
//   each one's full key, sorted_full[t, node * lc + j], with the query in
//   registers, 16 words a step (ballot over the group), stopping at the
//   first full match.  It writes found and the matching entry's rid
//   (NOT_FOUND_RID for none).  A full match always window-matches (the
//   entry's pk is the window of its own key), so this equals the plain
//   stage's "first valid lane whose full key equals the query" on every
//   tree the build makes; a lane that is not valid is never dereferenced.
//
// Every warp-wide operation runs with all 32 lanes (groups past the last
// query take part and do nothing); each group reads its own 16 bits of a
// ballot.
//
// Bound, as counted: bytes.  The mask form reads a node id, the query's
// window words and lc (dpos, pk) pairs per query and writes lc bytes; the
// leaf-stage form adds lc valid bytes, the full keys of the candidates up
// to the first match (at pk = 16 about one for a hit or for a miss that
// shares a key's windows, next to none for any other miss) and one rid,
// and writes found and rid, where the plain stage gathers all lc full
// keys.  What the card spends is the latency of the random leaf-row reads
// (96-byte rows of int64 carriers), more than their bytes.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 16;  // lanes per query
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kNotFoundRid = 0xFFFFFFFFll;

template <bool LEAF_STAGE>
struct Shape {
  static constexpr int kQueries = LEAF_STAGE ? 1 : 2;      // queries a group holds
  static constexpr int kPreload = LEAF_STAGE ? kGroup : 4;  // words loaded with the node
};

template <bool LEAF_STAGE>
__global__ void __launch_bounds__(kThreads)
    probe_group_kernel(const int64_t* __restrict__ queries,
                       const int64_t* __restrict__ node,
                       const int64_t* __restrict__ leaf_dpos,
                       const int64_t* __restrict__ leaf_pk,
                       const uint8_t* __restrict__ leaf_valid,
                       const int64_t* __restrict__ leaf_rid,
                       const int64_t* __restrict__ sorted_full,
                       uint8_t* __restrict__ out_mask, uint8_t* __restrict__ out_found,
                       int64_t* __restrict__ out_rid, int64_t q, int n_words,
                       int leaf_cap, int64_t n_leaves, int64_t n_keys, int pk) {
  constexpr int U = Shape<LEAF_STAGE>::kQueries;
  constexpr int P = Shape<LEAF_STAGE>::kPreload;
  constexpr int kGroups = kThreads / kGroup;
  const int64_t t = blockIdx.y;
  const int lane = threadIdx.x & (kGroup - 1);
  const int first = threadIdx.x & 16;  // the group's first lane in its warp
  int64_t row[U];
  bool live[U];
  uint32_t pre[U];
  long long nd[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {  // the block's queries u * kGroups ..
    const int64_t qi = ((int64_t)blockIdx.x * U + u) * kGroups + (threadIdx.x >> 4);
    live[u] = qi < q;
    row[u] = t * q + qi;  // the query's row in (T, q)
    pre[u] = live[u] && lane < P && lane < n_words ? (uint32_t)queries[row[u] * n_words + lane]
                                                   : 0u;
    nd[u] = live[u] && lane == 0 ? (long long)node[row[u]] : 0ll;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) nd[u] = __shfl_sync(kFull, nd[u], 0, kGroup);
  int64_t dpos[U];
  uint32_t stored[U];
  bool valid[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t slot = (t * n_leaves + nd[u]) * leaf_cap + lane;
    const bool entry = live[u] && lane < leaf_cap;
    dpos[u] = entry ? leaf_dpos[slot] : 0;
    stored[u] = entry ? (uint32_t)leaf_pk[slot] : 0u;
    valid[u] = LEAF_STAGE && entry && leaf_valid[slot] != 0;
  }
  bool hit[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool entry = live[u] && lane < leaf_cap;
    const int64_t* key = queries + row[u] * n_words;
    const int s = clip_start(dpos[u] + 1, n_words);
    const int wi = s >> 5;
    // every lane shuffles; lanes past the key's end hold 0, the zero fill
    // past the last word
    uint32_t w0 = __shfl_sync(kFull, pre[u], wi & (kGroup - 1), kGroup);
    uint32_t w1 = __shfl_sync(kFull, pre[u], (wi + 1) & (kGroup - 1), kGroup);
    if (entry && wi >= P) w0 = (uint32_t)key[wi];
    if (entry && wi + 1 >= P) w1 = wi + 1 < n_words ? (uint32_t)key[wi + 1] : 0u;
    hit[u] = entry && window_bits(w0, w1, s & 31, pk) == stored[u];
    if (!LEAF_STAGE && entry) out_mask[row[u] * leaf_cap + lane] = hit[u] ? 1 : 0;
  }
  if (!LEAF_STAGE) return;

  // candidates in lane order; each confirmed by a full-key compare, 16
  // words a step
  const int chunks = (n_words + kGroup - 1) / kGroup;
  const int64_t* key = queries + row[0] * n_words;
  const bool mine = hit[0] && valid[0];
  // a candidate reads its rid now, beside the first full key, rather than
  // after the compare
  const long long my_rid =
      mine ? (long long)leaf_rid[(t * n_leaves + nd[0]) * leaf_cap + lane] : 0ll;
  unsigned cand = (__ballot_sync(kFull, mine) >> first) & 0xffffu;
  int match = -1;
  const int64_t* full_base = sorted_full + (t * n_keys + nd[0] * leaf_cap) * n_words;
  while (__any_sync(kFull, cand != 0u)) {
    const bool active = cand != 0u;
    const int j = active ? __ffs(cand) - 1 : 0;
    const int64_t* full = full_base + (int64_t)j * n_words;
    bool eq = active;
    for (int c = 0; c < chunks && __any_sync(kFull, eq); ++c) {
      const int k = c * kGroup + lane;
      bool same = true;
      if (eq && k < n_words) same = (uint32_t)full[k] == (c == 0 ? pre[0] : (uint32_t)key[k]);
      // every lane votes (a short-circuit would leave the other group's
      // lanes out of the ballot)
      const unsigned agree = (__ballot_sync(kFull, same) >> first) & 0xffffu;
      eq = eq && agree == 0xffffu;
    }
    if (eq) {
      match = j;
      cand = 0u;
    } else if (active) {
      cand &= cand - 1u;
    }
  }
  const long long rid = __shfl_sync(kFull, my_rid, match >= 0 ? match : 0, kGroup);
  if (live[0] && lane == 0) {
    out_found[row[0]] = match >= 0 ? 1 : 0;
    out_rid[row[0]] = match >= 0 ? rid : kNotFoundRid;
  }
}

template <bool LEAF_STAGE>
dim3 grid_of(int n_tenants, int64_t q) {
  const int64_t per_block = kThreads / kGroup * Shape<LEAF_STAGE>::kQueries;
  return dim3((unsigned)((q + per_block - 1) / per_block), (unsigned)n_tenants);
}

}  // namespace

extern "C" int repro_probe(const void* queries, const void* node,
                           const void* leaf_dpos, const void* leaf_pk, void* out,
                           int n_tenants, int64_t q, int n_words, int leaf_cap,
                           int64_t n_leaves, int pk, void* stream) {
  probe_group_kernel<false><<<grid_of<false>(n_tenants, q), kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)queries, (const int64_t*)node, (const int64_t*)leaf_dpos,
      (const int64_t*)leaf_pk, nullptr, nullptr, nullptr, (uint8_t*)out, nullptr,
      nullptr, q, n_words, leaf_cap, n_leaves, 0, pk);
  return (int)cudaGetLastError();
}

extern "C" int repro_probe_leaf(const void* queries, const void* node,
                                const void* leaf_dpos, const void* leaf_pk,
                                const void* leaf_valid, const void* leaf_rid,
                                const void* sorted_full, void* found, void* rid,
                                int n_tenants, int64_t q, int n_words, int leaf_cap,
                                int64_t n_leaves, int64_t n_keys, int pk,
                                void* stream) {
  probe_group_kernel<true><<<grid_of<true>(n_tenants, q), kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)queries, (const int64_t*)node, (const int64_t*)leaf_dpos,
      (const int64_t*)leaf_pk, (const uint8_t*)leaf_valid, (const int64_t*)leaf_rid,
      (const int64_t*)sorted_full, nullptr, (uint8_t*)found, (int64_t*)rid, q, n_words,
      leaf_cap, n_leaves, n_keys, pk);
  return (int)cudaGetLastError();
}
