// pk-window of the bulk build (paper §5.3, option C.b) for Hopper.
//
// Replaces repro/kernels/build/kernel.py::_pk_window_kernel /
// pk_window_planes, the TPU kernel that picks each entry's (word, word+1)
// straddle out of (W, tile) word planes with one compare+select per plane.
// Two forms, both applying the shared window arithmetic of common.cuh:
//
// * gather_window_kernel<VEC>, the leaf level.  The build gathers every
//   entry's full key into sorted order anyway (sorted_full = table[rows]);
//   this kernel is that gather, and takes each entry's window on the way.
//   Lanes move whole rows in VEC-word chunks (16-byte accesses where the
//   key width is even and both arrays are 16-byte aligned, 8-byte ones
//   otherwise): a row belongs to a power-of-two group of consecutive lanes,
//   one chunk a lane, so loads and stores of a row are contiguous; keys
//   wider than 64 words span more than one warp.  The lane that holds the
//   start word takes word + 1 from its own chunk or from the next lane by
//   shuffle (the last lane of a warp reads it from device memory) and
//   writes the window.
// * pk_window_kernel, the non-leaf levels: one thread per entry reads the
//   two words of words[rows[i]] its window straddles (rows null: row i), so
//   a level never materialises sorted_full[rows].
//
// Bound: bytes.  The leaf form reads each gathered row once and writes it
// once, as the gather alone does; the window adds one start read and one
// window written per entry (16 of the 272 bytes an entry of a 16-word key
// moves as int64 carriers), so its time should be the gather's.  The index
// form reads a start, a row id and one or two 32-byte sectors of a row per
// entry, and writes a window.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // chunks per thread, loaded before any is stored

template <int VEC>
struct Chunk;
template <>
struct Chunk<1> {
  using type = long long;
  __device__ static uint32_t first(type v) { return (uint32_t)v; }
  __device__ static uint32_t second(type) { return 0u; }
};
template <>
struct Chunk<2> {
  using type = longlong2;
  __device__ static uint32_t first(type v) { return (uint32_t)v.x; }
  __device__ static uint32_t second(type v) { return (uint32_t)v.y; }
};

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    gather_window_kernel(const int64_t* __restrict__ table,
                         const int64_t* __restrict__ rows,
                         const int64_t* __restrict__ starts,
                         int64_t* __restrict__ out_rows,
                         int64_t* __restrict__ out_pk, int64_t m, int n_words,
                         int log_group, int pk) {
  using C = Chunk<VEC>;
  using T = typename C::type;
  const int chunks = n_words / VEC;
  const int64_t total = m << log_group;
  const int lane = threadIdx.x & 31;
  const int64_t base = (int64_t)blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
  T v[kUnroll];
  int64_t row[kUnroll], start[kUnroll];
  bool live[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t t = base + u * kThreads;
    const int64_t r = t >> log_group;
    const int c = (int)(t & ((1 << log_group) - 1));
    live[u] = t < total && c < chunks;
    v[u] = T{};
    if (live[u]) {
      row[u] = rows[r];
      start[u] = starts[r];
      v[u] = reinterpret_cast<const T*>(table + row[u] * n_words)[c];
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t t = base + u * kThreads;
    const int64_t r = t >> log_group;
    const int c = (int)(t & ((1 << log_group) - 1));
    if (live[u]) reinterpret_cast<T*>(out_rows + r * n_words)[c] = v[u];
    // every lane takes part in the shuffle; a row's chunks sit on
    // consecutive lanes, so the next lane holds the next chunk
    const uint32_t next = __shfl_down_sync(0xffffffffu, C::first(v[u]), 1);
    if (!live[u]) continue;
    const int s = clip_start(start[u], n_words);
    const int wi = s >> 5;
    if (wi / VEC != c) continue;
    const bool odd = VEC == 2 && (wi & 1);
    const uint32_t w0 = odd ? C::second(v[u]) : C::first(v[u]);
    uint32_t w1 = 0u;
    if (wi + 1 < n_words) {
      if (VEC == 2 && !odd)
        w1 = C::second(v[u]);
      else
        w1 = lane < 31 ? next : (uint32_t)table[row[u] * n_words + wi + 1];
    }
    out_pk[r] = (int64_t)window_bits(w0, w1, s & 31, pk);
  }
}

__global__ void pk_window_kernel(const int64_t* __restrict__ words,
                                 const int64_t* __restrict__ rows,
                                 const int64_t* __restrict__ starts,
                                 int64_t* __restrict__ out, int64_t m,
                                 int n_words, int pk) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int64_t r = rows ? rows[i] : i;
  out[i] = (int64_t)pk_window(words + r * n_words, n_words, starts[i], pk);
}

}  // namespace

extern "C" int repro_pk_window(const void* words, const void* rows,
                               const void* starts, void* out, int64_t m,
                               int n_words, int pk, void* stream) {
  const int64_t blocks = (m + kThreads - 1) / kThreads;
  pk_window_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)words, (const int64_t*)rows, (const int64_t*)starts,
      (int64_t*)out, m, n_words, pk);
  return (int)cudaGetLastError();
}

extern "C" int repro_gather_window(const void* table, const void* rows,
                                   const void* starts, void* out_rows,
                                   void* out_pk, int64_t m, int n_words, int pk,
                                   void* stream) {
  const bool wide = n_words % 2 == 0 && ((uintptr_t)table & 15) == 0 &&
                    ((uintptr_t)out_rows & 15) == 0;
  const int vec = wide ? 2 : 1;
  const int chunks = n_words / vec;
  int log_group = 0;
  while ((1 << log_group) < chunks) ++log_group;
  const int64_t total = m << log_group;
  const int64_t blocks = (total + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  cudaStream_t st = (cudaStream_t)stream;
  if (wide)
    gather_window_kernel<2><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const int64_t*)table, (const int64_t*)rows, (const int64_t*)starts,
        (int64_t*)out_rows, (int64_t*)out_pk, m, n_words, log_group, pk);
  else
    gather_window_kernel<1><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const int64_t*)table, (const int64_t*)rows, (const int64_t*)starts,
        (int64_t*)out_rows, (int64_t*)out_pk, m, n_words, log_group, pk);
  return (int)cudaGetLastError();
}
