// Adjacent distinction bits of a sorted run (paper §4.3 refresh, §5.3
// entry dpos, Remark 1) for Hopper.
//
// Replaces repro/kernels/dbit/kernel.py::_dbit_kernel / dbit_planes, the
// TPU kernel that XORs (W, tile) planes of the previous and the current
// rows (two shifted copies that its wrapper builds) and finds the first
// nonzero word with an unrolled running-mask pass.  The D-bit of a pair is
// 32*w + clz(prev ^ cur) at the first word w that differs, NO_DBIT
// (2^31 - 1) for an equal pair.  One template, two forms:
//
// * positions (dbit_kernel<false>): writes each pair's D-bit, (n-1,)
//   int32; the bulk build's leaf dpos;
// * bitmap (dbit_kernel<true>): writes nothing per pair.  The lane
//   that finds a pair's D-bit p sets bit 31 - p % 32 of word p / 32 of the
//   block's (W,) bitmap in shared memory (an atomicOr only where the bit is
//   not set yet: a sorted set has few distinct D-bits), and each block ORs
//   its words into the output with one atomicOr per word it adds bits to.
//   The refresh's D-bitmap and meta_from_keys' (in the run's own bit
//   space): W words leave the card, not n - 1 positions.
//
// Layout.  The run is row-major and read in place, with no shifted copy.
// A lane holds a row's first 4 words (one 32-byte sector of int64
// carriers, in 8-byte loads), so a warp's loads read whole sectors of 32
// consecutive rows.  The previous row's words come by shuffle from the lane
// before, and the warp's first row is compared with the halo row before
// it, which lane 0 loads.  A row whose first sector equals its
// predecessor's walks on, a sector a step, reading both rows' next words
// until one differs or the key ends, so a row's later sectors are read
// only when the earlier ones are equal (adjacent keys of a sorted set
// mostly differ in the first).  Lane j writes pair first + j, so a warp's
// positions are one coalesced store.  (In development this measured at
// least as fast as a group of lanes a row with a ballot for the first
// differing word, 16-byte loads, warps of two to four row steps, and 128-
// or 512-thread blocks at the main path's shapes.)
//
// Bound: bytes.  Each row is read once (the halo row once more per warp,
// from L2), up to the sector that holds its pairs' first difference; the
// positions form writes one int32 per pair.  The compare is a few integer
// operations per word.  At the int64 carrier's width a 4-word compressed
// row is one sector, so the bitmap form moves 32 bytes a row and the
// positions form 36.
#include "common.cuh"

namespace {

constexpr int32_t kNoDbit = 0x7FFFFFFF;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSector = 4;  // words a lane reads of a row a step: one 32-byte sector
constexpr unsigned kAll = 0xffffffffu;

// The kSector words of one row from word `word` on; zero where the row or
// the word does not exist (equal zeros compare as equal).
__device__ __forceinline__ void load_sector(uint32_t (&out)[kSector],
                                            const int64_t* __restrict__ keys,
                                            int64_t row, int word, bool live,
                                            int n_words) {
#pragma unroll
  for (int i = 0; i < kSector; ++i)
    out[i] = live && word + i < n_words ? (uint32_t)keys[row * n_words + word + i] : 0u;
}

// The first differing bit of a sector (word index `word` is its first),
// or kNoDbit.
__device__ __forceinline__ int sector_dbit(const uint32_t (&cur)[kSector],
                                           const uint32_t (&prev)[kSector], int word) {
  int pos = kNoDbit;
#pragma unroll
  for (int i = kSector - 1; i >= 0; --i) {
    const uint32_t x = cur[i] ^ prev[i];
    if (x != 0u) pos = 32 * (word + i) + __clz((int)x);
  }
  return pos;
}

template <bool BITMAP>
__global__ void __launch_bounds__(kThreads)
    dbit_kernel(const int64_t* __restrict__ keys, int32_t* __restrict__ pos_out,
                unsigned long long* __restrict__ bitmap_out, int64_t n, int n_words) {
  extern __shared__ uint32_t s_bits[];  // the bitmap form's block bitmap
  const int lane = threadIdx.x & 31;
  // the warp's pairs first .. first + 31: rows first + 1 .. first + 32,
  // each against the row before, and row first, the halo, before them
  const int64_t first = ((int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
  const int64_t r = first + 1 + lane;
  const bool pair = r < n;

  if (BITMAP) {
    for (int j = threadIdx.x; j < n_words; j += kThreads) s_bits[j] = 0u;
    __syncthreads();
  }
  uint32_t cur[kSector], halo[kSector], prev[kSector];
  load_sector(cur, keys, r, 0, pair, n_words);
  load_sector(halo, keys, first, 0, lane == 0 && first < n, n_words);
  // the previous row: the lane before's, or the halo row for lane 0
#pragma unroll
  for (int i = 0; i < kSector; ++i) {
    const uint32_t up = __shfl_up_sync(kAll, cur[i], 1);
    prev[i] = lane == 0 ? halo[i] : up;
  }
  int pos = sector_dbit(cur, prev, 0);
  // rows equal so far walk on, both rows a sector a step
  for (int w = kSector; pair && pos == kNoDbit && w < n_words; w += kSector) {
    uint32_t a[kSector], b[kSector];
    load_sector(a, keys, r, w, true, n_words);
    load_sector(b, keys, r - 1, w, true, n_words);
    pos = sector_dbit(a, b, w);
  }

  if (BITMAP) {
    if (pair && pos != kNoDbit) {
      uint32_t* word = s_bits + (pos >> 5);
      const uint32_t bit = 0x80000000u >> (pos & 31);
      if (!(*word & bit)) atomicOr(word, bit);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < n_words; j += kThreads) {
      const unsigned long long bits = s_bits[j];
      if (bits & ~__ldcg(bitmap_out + j)) atomicOr(bitmap_out + j, bits);
    }
  } else if (pair) {
    pos_out[r - 1] = pos;
  }
}

template <bool BITMAP>
int launch(const void* keys, void* out, int64_t n, int n_words, cudaStream_t stream) {
  const int64_t warps = (n + 31) / 32;
  const int64_t blocks = (warps + kWarps - 1) / kWarps;
  const size_t smem = BITMAP ? (size_t)n_words * sizeof(uint32_t) : 0;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  dbit_kernel<BITMAP><<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const int64_t*)keys, BITMAP ? nullptr : (int32_t*)out,
      BITMAP ? (unsigned long long*)out : nullptr, n, n_words);
  return (int)cudaGetLastError();
}

}  // namespace

// Positions form: n sorted rows of n_words int64 carriers -> (n-1,) int32.
extern "C" int repro_dbit(const void* keys, void* out, int64_t n, int n_words,
                          void* stream) {
  return launch<false>(keys, out, n, n_words, (cudaStream_t)stream);
}

// Bitmap form: n sorted rows -> (n_words,) int64-carrier bitmap words,
// zeroed here first.
extern "C" int repro_dbitmap(const void* keys, void* out, int64_t n,
                             int n_words, void* stream) {
  const cudaError_t err = cudaMemsetAsync(out, 0, (size_t)n_words * sizeof(int64_t),
                                          (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return launch<true>(keys, out, n, n_words, (cudaStream_t)stream);
}
