// Merge-path ranks of the chunked sort's ladder and the incremental merge
// (paper §5.2 cascade, the delta merge of run_incremental) for Hopper.
//
// Replaces repro/kernels/merge/kernel.py::_rank_kernel / merge_rank_planes,
// the TPU kernel that keeps the whole searched run resident in VMEM as
// (W+1, n_s) word planes and runs a fixed bit_length(n_s) steps of
// lane-gather + multiword compare over a tile of queries.  The rank of a
// query is the number of searched (key, row) pairs below it: the compare is
// lexicographic over the key words, then the row word, on the low 32 bits
// of the int64 carriers, unsigned (so the pad rows >= 2^31 sort last).
//
// The queries are a sorted run too (the merge ranks the smaller run in the
// larger), so a tile of consecutive queries ranks into one window of the
// searched run.  merge_rank_kernel<KW, TAIL, V> gives a block one tile of
// kTile queries:
//
// * it stages the tile and the next tile's first query in shared memory at
//   u32 width (asynchronous 4-byte copies of the carriers' low halves), and
//   meanwhile warp 0 finds the window: two groups of 16 lanes each probe 16
//   evenly spaced rows a round for the rank of the tile's first query and
//   of the next tile's first, until each range is kBoundSlack rows;
// * it stages the window's key words (a row id is read only when two keys
//   tie, so no row ids are staged), or, where the window is larger than the
//   buffer, an evenly spaced sample of at most kSamples of its rows;
// * one __syncthreads_and checks that the staged queries ascend; then each
//   thread searches shared memory, and after a sample ends with at most
//   log2(stride) probes in device memory, one round trip each;
// * a tile whose queries do not ascend ranks each query by a binary search
//   over the whole run in device memory, so the kernel is exact for any
//   query order.
//
// The leading KW <= 8 key words are staged; a wider key breaks a tie on
// them from device memory (TAIL).  V: 16-byte probes of even widths.
//
// Bound: bytes, each query and the key words of each searched row read
// once and one int32 written per query.  On an H100 a small buffer (16 KB, eight blocks an SM) measured
// faster than staging whole windows in a large one: at the largest cascade
// merge most windows (about 1,300 rows) are sampled, and the two or three
// probes per query that finish them hit rows the block's neighbours fetch
// too.
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int kTile = 256;          // queries per block, one per thread
constexpr int kMaxStaged = 8;       // leading key words staged
constexpr int kBufBytes = 16 * 1024;  // a block's staging buffer
constexpr int kSamples = 256;       // most rows of a larger window's sample
constexpr int kBoundSlack = 32;     // rows a window's ends may stray
constexpr int kBoundLanes = 16;     // lanes that search for one end

// Shared-memory words of a tile's staged queries, P a query, rounded up to
// 16 bytes.
template <int P>
constexpr int kQueryWords = ((kTile + 1) * P + 3) / 4 * 4;

// Key words [from, n_words) of ka against kb, in device memory: -1, 0 or 1.
__device__ __noinline__ int cmp_tail(const int64_t* __restrict__ ka,
                                     const int64_t* __restrict__ kb, int from,
                                     int n_words) {
  for (int w = from; w < n_words; ++w) {
    const uint32_t a = (uint32_t)ka[w], b = (uint32_t)kb[w];
    if (a != b) return a < b ? -1 : 1;
  }
  return 0;
}

// KW leading words of a against b: less, and equal.
template <int KW>
__device__ __forceinline__ void cmp_words(const uint32_t* a, const uint32_t* b, bool& lt,
                                          bool& eq) {
  lt = false;
  eq = true;
#pragma unroll
  for (int w = 0; w < KW; ++w) {
    lt = lt || (eq && a[w] < b[w]);
    eq = eq && a[w] == b[w];
  }
}

// Staged query a < staged query b, each its KW leading key words then its
// row; a tie on those words of a wider key (TAIL) reads the rest of both
// keys, ka and kb, from device memory.
template <int KW, bool TAIL>
__device__ __forceinline__ bool query_less(const uint32_t* a, const uint32_t* b,
                                           const int64_t* ka, const int64_t* kb,
                                           int n_words) {
  bool lt, eq;
  cmp_words<KW>(a, b, lt, eq);
  if (!eq) return lt;
  if (TAIL) {
    const int c = cmp_tail(ka, kb, KW, n_words);
    if (c) return c < 0;
  }
  return a[KW] < b[KW];
}

// Searched row j < query q (KW words and the row, staged), given the row's
// KW leading words s.  Only a tie on those words reads more from device
// memory: the rest of a wider key (TAIL), then the row id.  Rows of a run
// differ in their key words unless the keys repeat, so the row ids are
// neither staged nor, as a rule, read.
template <int KW, bool TAIL>
__device__ __forceinline__ bool row_below(const uint32_t* s, int64_t j, const uint32_t* q,
                                          const int64_t* __restrict__ keys_s,
                                          const int64_t* __restrict__ rows_s,
                                          const int64_t* kq, int n_words) {
  bool lt, eq;
  cmp_words<KW>(s, q, lt, eq);
  if (!eq) return lt;
  if (TAIL) {
    const int c = cmp_tail(keys_s + j * n_words, kq, KW, n_words);
    if (c) return c < 0;
  }
  return (uint32_t)rows_s[j] < q[KW];
}

// row_below for a row in device memory: its KW words are loaded together
// (as 16-byte pairs where V: an even width and 16-byte aligned keys), so a
// probe costs one round trip (one 32-byte sector for 4-word keys).
template <int KW, bool TAIL, bool V>
__device__ __forceinline__ bool probe_below(const int64_t* __restrict__ keys_s,
                                            const int64_t* __restrict__ rows_s, int64_t j,
                                            const uint32_t* q, const int64_t* kq,
                                            int n_words) {
  const int64_t* ks = keys_s + j * n_words;
  uint32_t s[KW];
  if constexpr (V) {
#pragma unroll
    for (int w = 0; w < KW; w += 2) {
      const longlong2 v = *reinterpret_cast<const longlong2*>(ks + w);
      s[w] = (uint32_t)v.x;
      s[w + 1] = (uint32_t)v.y;
    }
  } else {
#pragma unroll
    for (int w = 0; w < KW; ++w) s[w] = (uint32_t)ks[w];
  }
  return row_below<KW, TAIL>(s, j, q, keys_s, rows_s, kq, n_words);
}

// Lower bound of query q in rows [lo, hi) of the run, in device memory.
template <int KW, bool TAIL, bool V>
__device__ int64_t search_global(const int64_t* __restrict__ keys_s,
                                 const int64_t* __restrict__ rows_s, const uint32_t* q,
                                 const int64_t* kq, int64_t lo, int64_t hi, int n_words) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (probe_below<KW, TAIL, V>(keys_s, rows_s, mid, q, kq, n_words))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Query qi's KW leading words and row, as u32.
template <int KW>
__device__ __forceinline__ void load_query(uint32_t* q, const int64_t* __restrict__ keys_q,
                                           const int64_t* __restrict__ rows_q, int64_t qi,
                                           int n_words) {
#pragma unroll
  for (int w = 0; w < KW; ++w) q[w] = (uint32_t)keys_q[qi * n_words + w];
  q[KW] = (uint32_t)rows_q[qi];
}

// Start copying `count` rows first, first + stride, ... of a run into dst as
// [count][P] u32: the leading KW key words, then the row if P = KW + 1.
// Asynchronous 4-byte copies of each int64 carrier's low half, so every
// copy of the block is in flight at once.
template <int KW, int P>
__device__ __forceinline__ void stage(uint32_t* dst, const int64_t* __restrict__ keys,
                                      const int64_t* __restrict__ rows, int64_t first,
                                      int64_t stride, int count, int n_words) {
  for (int e = threadIdx.x; e < count * P; e += kTile) {
    const int r = e / P, w = e - r * P;
    const int64_t row = first + r * stride;
    __pipeline_memcpy_async(dst + e, w < KW ? keys + row * n_words + w : rows + row, 4);
  }
}

// The rank of query qi to within kBoundSlack rows, [lo, hi], by one group
// of kBoundLanes lanes: each round its lanes probe evenly spaced rows of the
// range and a ballot counts those below the query.  Every lane of the warp
// calls it (a warp holds two groups).
template <int KW, bool TAIL, bool V>
__device__ __forceinline__ void find_rank(const int64_t* __restrict__ keys_q,
                                          const int64_t* __restrict__ rows_q,
                                          const int64_t* __restrict__ keys_s,
                                          const int64_t* __restrict__ rows_s, int64_t qi,
                                          int64_t n_s, int n_words, int64_t& lo,
                                          int64_t& hi) {
  const int lane = threadIdx.x & 31;
  const int sub = lane % kBoundLanes, first = lane - sub;
  uint32_t q[KW + 1];
  load_query<KW>(q, keys_q, rows_q, qi, n_words);
  const int64_t* kq = keys_q + qi * n_words;
  lo = 0;
  hi = n_s;
  while (__any_sync(0xffffffffu, hi - lo > kBoundSlack)) {
    const bool active = hi - lo > kBoundSlack;
    const int64_t p = lo + ((sub + 1) * (hi - lo)) / (kBoundLanes + 1);
    const bool below = active && probe_below<KW, TAIL, V>(keys_s, rows_s, p, q, kq, n_words);
    const unsigned mine = (__ballot_sync(0xffffffffu, below) >> first) &
                          (0xffffffffu >> (32 - kBoundLanes));
    const int c = __popc(mine);
    const int64_t p_below =
        __shfl_sync(0xffffffffu, (long long)p, first + (c > 0 ? c - 1 : 0));
    const int64_t p_above =
        __shfl_sync(0xffffffffu, (long long)p, first + (c < kBoundLanes ? c : kBoundLanes - 1));
    if (active) {
      if (c > 0) lo = p_below + 1;
      if (c < kBoundLanes) hi = p_above;
    }
  }
}

// One tile's staging: what a block must know of it once it has landed.
struct TileWindow {
  int64_t lo, len, stride;  // the window [lo, lo + len), staged at `stride`
  int count, tq, staged;    // rows staged, queries, queries staged
};

// Stage tile t into buf: its queries (and the next tile's first), then the
// window that holds every rank of the tile if it ascends.
template <int KW, bool TAIL, bool V>
__device__ __forceinline__ TileWindow stage_tile(
    uint32_t* buf, int t, const int64_t* __restrict__ keys_q,
    const int64_t* __restrict__ rows_q, const int64_t* __restrict__ keys_s,
    const int64_t* __restrict__ rows_s, int64_t n_q, int64_t n_s, int n_words, int cap) {
  constexpr int P = KW + 1;
  __shared__ int64_t window[2];
  TileWindow tw;
  const int64_t q0 = (int64_t)t * kTile;
  const int64_t left = n_q - q0;
  tw.tq = left < kTile ? (int)left : kTile;
  tw.staged = left > kTile ? kTile + 1 : tw.tq;
  stage<KW, P>(buf, keys_q, rows_q, q0, 1, tw.staged, n_words);
  if (threadIdx.x < 32) {  // while the queries land: the window's ends
    const bool upper = threadIdx.x >= kBoundLanes;
    int64_t qi = upper ? q0 + kTile : q0;  // the next tile's first, or the last
    if (qi > n_q - 1) qi = n_q - 1;
    int64_t lo, hi;
    find_rank<KW, TAIL, V>(keys_q, rows_q, keys_s, rows_s, qi, n_s, n_words, lo, hi);
    if (threadIdx.x % kBoundLanes == 0) window[upper] = upper ? hi : lo;
  }
  __syncthreads();
  tw.lo = window[0];
  const int64_t span = window[1] - tw.lo;
  tw.len = span > 0 ? span : 0;
  const int samples = cap < kSamples ? cap : kSamples;
  tw.stride = tw.len <= cap ? 1 : (tw.len + samples - 1) / samples;
  tw.count = (int)((tw.len + tw.stride - 1) / tw.stride);
  stage<KW, KW>(buf + kQueryWords<P>, keys_s, rows_s, tw.lo, tw.stride, tw.count, n_words);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  return tw;
}

// Rank tile t's queries from its staged buffer (every thread of the block
// calls it: the ascending check is a barrier).
template <int KW, bool TAIL, bool V>
__device__ __forceinline__ void rank_tile(const uint32_t* buf, const TileWindow& tw, int t,
                                          const int64_t* __restrict__ keys_q,
                                          const int64_t* __restrict__ keys_s,
                                          const int64_t* __restrict__ rows_s,
                                          int32_t* __restrict__ out, int64_t n_s,
                                          int n_words) {
  constexpr int P = KW + 1;
  const uint32_t* sq = buf;
  const uint32_t* sw = buf + kQueryWords<P>;
  const int i = threadIdx.x;
  const int64_t qi = (int64_t)t * kTile + i;
  const int64_t* kq = keys_q + qi * n_words;
  const bool ascending = i + 1 >= tw.staged || !query_less<KW, TAIL>(
      sq + (i + 1) * P, sq + i * P, kq + n_words, kq, n_words);
  const bool sorted = __syncthreads_and(ascending);
  if (i >= tw.tq) return;
  uint32_t q[P];
#pragma unroll
  for (int w = 0; w < P; ++w) q[w] = sq[i * P + w];
  int64_t rank;
  if (!sorted) {  // any query order: a search over the whole run
    rank = search_global<KW, TAIL, V>(keys_s, rows_s, q, kq, 0, n_s, n_words);
  } else {
    // the staged rows below the query (every row of a dense window)
    int a = 0, b = tw.count;
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (row_below<KW, TAIL>(sw + mid * KW, tw.lo + mid * tw.stride, q, keys_s, rows_s, kq,
                              n_words))
        a = mid + 1;
      else
        b = mid;
    }
    rank = tw.lo + a;
    if (tw.stride > 1 && a > 0) {  // the rank lies in the stride below sample a
      const int64_t end = tw.lo + a * tw.stride, hi = tw.lo + tw.len;
      rank = search_global<KW, TAIL, V>(keys_s, rows_s, q, kq,
                                        tw.lo + (a - 1) * tw.stride + 1, end < hi ? end : hi,
                                        n_words);
    }
  }
  out[qi] = (int32_t)rank;
}

// One block per tile: stage it, then rank it.
template <int KW, bool TAIL, bool V>
__global__ void __launch_bounds__(kTile)
    merge_rank_kernel(const int64_t* __restrict__ keys_q,
                      const int64_t* __restrict__ rows_q,
                      const int64_t* __restrict__ keys_s,
                      const int64_t* __restrict__ rows_s, int32_t* __restrict__ out,
                      int64_t n_q, int64_t n_s, int n_words, int cap) {
  extern __shared__ uint32_t smem[];
  const TileWindow tw = stage_tile<KW, TAIL, V>(smem, blockIdx.x, keys_q, rows_q, keys_s,
                                                rows_s, n_q, n_s, n_words, cap);
  rank_tile<KW, TAIL, V>(smem, tw, blockIdx.x, keys_q, keys_s, rows_s, out, n_s, n_words);
}

template <int KW, bool TAIL, bool V>
int launch(const int64_t* keys_q, const int64_t* rows_q, const int64_t* keys_s,
           const int64_t* rows_s, int32_t* out, int64_t n_q, int64_t n_s, int n_words,
           cudaStream_t stream) {
  constexpr int P = KW + 1;
  static_assert((kBufBytes - kQueryWords<kMaxStaged + 1> * 4) / (4 * kMaxStaged) >= 64,
                "the staging buffer must hold a useful sample of a window");
  const int cap = (kBufBytes - kQueryWords<P> * 4) / (4 * KW);
  const int64_t n_tiles = (n_q + kTile - 1) / kTile;
  merge_rank_kernel<KW, TAIL, V><<<(unsigned)n_tiles, kTile, kBufBytes, stream>>>(
      keys_q, rows_q, keys_s, rows_s, out, n_q, n_s, n_words, cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_merge_rank(const void* keys_q, const void* rows_q,
                                const void* keys_s, const void* rows_s, void* out,
                                int64_t n_q, int64_t n_s, int n_words, void* stream) {
  const int64_t* kq = (const int64_t*)keys_q;
  const int64_t* rq = (const int64_t*)rows_q;
  const int64_t* ks = (const int64_t*)keys_s;
  const int64_t* rs = (const int64_t*)rows_s;
  int32_t* o = (int32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  // 16-byte probes where both key arrays are 16-byte aligned
  const bool v = (((uintptr_t)keys_q | (uintptr_t)keys_s) & 15) == 0;
  switch (n_words) {
    case 1: return launch<1, false, false>(kq, rq, ks, rs, o, n_q, n_s, n_words, st);
    case 2:
      return v ? launch<2, false, true>(kq, rq, ks, rs, o, n_q, n_s, n_words, st)
               : launch<2, false, false>(kq, rq, ks, rs, o, n_q, n_s, n_words, st);
    case 3: return launch<3, false, false>(kq, rq, ks, rs, o, n_q, n_s, n_words, st);
    case 4:
      return v ? launch<4, false, true>(kq, rq, ks, rs, o, n_q, n_s, n_words, st)
               : launch<4, false, false>(kq, rq, ks, rs, o, n_q, n_s, n_words, st);
    case 5: return launch<5, false, false>(kq, rq, ks, rs, o, n_q, n_s, n_words, st);
    case 6:
      return v ? launch<6, false, true>(kq, rq, ks, rs, o, n_q, n_s, n_words, st)
               : launch<6, false, false>(kq, rq, ks, rs, o, n_q, n_s, n_words, st);
    case 7: return launch<7, false, false>(kq, rq, ks, rs, o, n_q, n_s, n_words, st);
    case 8:
      return v ? launch<8, false, true>(kq, rq, ks, rs, o, n_q, n_s, n_words, st)
               : launch<8, false, false>(kq, rq, ks, rs, o, n_q, n_s, n_words, st);
    default: return launch<8, true, false>(kq, rq, ks, rs, o, n_q, n_s, n_words, st);
  }
}
