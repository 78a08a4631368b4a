// Bitonic block sort of multiword keys for Hopper.
//
// Replaces repro/kernels/bitonic/kernel.py::_bitonic_kernel /
// bitonic_block_sort_planes, the TPU kernel that sorts each `block`-lane
// block of (W+1, n) word planes in VMEM with a bitonic network (paper
// Appendix A step 3.1, the row-column sort's base blocks).
//
// The network is the reference's: the same substage order, the same
// partner lane ^ j and the same keep rule (in an ascending region a pair
// swaps only when lo > hi, in a descending one only when lo < hi), so ties
// keep their own entries and the output is byte-identical to the plain
// version for every block size.  Rows at or past n read as all-ones in
// every plane, the reference's sentinel padding.
//
// Bound: bytes at u32 width (each row read once, written once); the int64
// carrier doubles them.  What held the first port back was the network's
// 45 shared-memory substages (one barrier each, a thread per pair, every
// plane swapped through shared memory).  Two kernels now:
//
// * bitonic_regs_kernel<W, R, T>, for the widths the pipeline meets
//   (compressed keys of 1-8 words, full keys of 16): each thread holds R
//   consecutive rows of the tile (key words and row) in registers.  A
//   substage whose stride is below R compare-exchanges in registers; a
//   stride inside the warp exchanges with __shfl_xor_sync; only strides
//   that cross warps go through shared memory.  A 512-row block of keys up
//   to 4 words is one warp with 16 rows a thread: 30 of the 45 substages
//   run in registers, 15 on shuffles, none in shared memory.  The kernel
//   is bound by integer issue, so each step is made cheap: a compare is
//   one subtract-with-borrow per key word (lt_mask), a swap one LOP3 per
//   word, and at the start of each stage the key words of rows in
//   descending regions are complemented (and restored at the next), so
//   every compare-exchange tests one "hi < lo": a descending swap
//   "lo < hi" is "~hi < ~lo".  Rows arrive by asynchronous 4-byte copies
//   (the low half of each int64 word) into a padded shared-memory tile
//   and leave through it, both coalesced.
// * bitonic_wide_kernel, for any other width, up to the reference's
//   512-byte keys (128 words): shared memory holds the lane permutation and
//   as many leading key words as fit in 48 KB; a compare that ties on
//   those words reads the rest of both rows from device memory (the
//   block's rows are L2-resident), and the rows are gathered by the
//   permutation at the end.
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr int kSmemDefault = 48 * 1024;

// x < y, lexicographic over W words (word 0 most significant), as a mask
// of all ones or zero: the borrow out of the multiword subtraction x - y,
// one subtract-with-borrow per word from the least significant up.
template <int W>
__device__ __forceinline__ uint32_t lt_mask(const uint32_t (&x)[W],
                                            const uint32_t (&y)[W]);

#define LT_X(i) "r"(x[i])
#define LT_Y(i) "r"(y[i])
#define LT_SUB(a, b) "sub.cc.u32 t, %" #a ", %" #b ";\n\t"
#define LT_SUBC(a, b) "subc.cc.u32 t, %" #a ", %" #b ";\n\t"
#define LT_MASK(W, CHAIN, ...)                                          \
  template <>                                                           \
  __device__ __forceinline__ uint32_t lt_mask<W>(const uint32_t(&x)[W], \
                                                 const uint32_t(&y)[W]) { \
    uint32_t m;                                                         \
    asm("{\n\t.reg .u32 t, z;\n\tmov.u32 z, 0;\n\t" CHAIN               \
        "subc.u32 %0, z, z;\n\t}"                                       \
        : "=r"(m)                                                       \
        : __VA_ARGS__);                                                 \
    return m;                                                           \
  }
LT_MASK(1, LT_SUB(1, 2), LT_X(0), LT_Y(0))
LT_MASK(2, LT_SUB(2, 4) LT_SUBC(1, 3), LT_X(0), LT_X(1), LT_Y(0), LT_Y(1))
LT_MASK(3, LT_SUB(3, 6) LT_SUBC(2, 5) LT_SUBC(1, 4), LT_X(0), LT_X(1), LT_X(2),
        LT_Y(0), LT_Y(1), LT_Y(2))
LT_MASK(4, LT_SUB(4, 8) LT_SUBC(3, 7) LT_SUBC(2, 6) LT_SUBC(1, 5), LT_X(0),
        LT_X(1), LT_X(2), LT_X(3), LT_Y(0), LT_Y(1), LT_Y(2), LT_Y(3))
LT_MASK(5, LT_SUB(5, 10) LT_SUBC(4, 9) LT_SUBC(3, 8) LT_SUBC(2, 7)
            LT_SUBC(1, 6), LT_X(0), LT_X(1), LT_X(2), LT_X(3), LT_X(4),
        LT_Y(0), LT_Y(1), LT_Y(2), LT_Y(3), LT_Y(4))
LT_MASK(6, LT_SUB(6, 12) LT_SUBC(5, 11) LT_SUBC(4, 10) LT_SUBC(3, 9)
            LT_SUBC(2, 8) LT_SUBC(1, 7), LT_X(0), LT_X(1), LT_X(2), LT_X(3),
        LT_X(4), LT_X(5), LT_Y(0), LT_Y(1), LT_Y(2), LT_Y(3), LT_Y(4), LT_Y(5))
LT_MASK(7, LT_SUB(7, 14) LT_SUBC(6, 13) LT_SUBC(5, 12) LT_SUBC(4, 11)
            LT_SUBC(3, 10) LT_SUBC(2, 9) LT_SUBC(1, 8), LT_X(0), LT_X(1),
        LT_X(2), LT_X(3), LT_X(4), LT_X(5), LT_X(6), LT_Y(0), LT_Y(1), LT_Y(2),
        LT_Y(3), LT_Y(4), LT_Y(5), LT_Y(6))
LT_MASK(8, LT_SUB(8, 16) LT_SUBC(7, 15) LT_SUBC(6, 14) LT_SUBC(5, 13)
            LT_SUBC(4, 12) LT_SUBC(3, 11) LT_SUBC(2, 10) LT_SUBC(1, 9),
        LT_X(0), LT_X(1), LT_X(2), LT_X(3), LT_X(4), LT_X(5), LT_X(6), LT_X(7),
        LT_Y(0), LT_Y(1), LT_Y(2), LT_Y(3), LT_Y(4), LT_Y(5), LT_Y(6), LT_Y(7))

// 16 words: the low 8 words' borrow re-enters the chain as the borrow of
// 0 - low (set iff low is all ones) before the high 8 words.
template <>
__device__ __forceinline__ uint32_t lt_mask<16>(const uint32_t (&x)[16],
                                                const uint32_t (&y)[16]) {
  uint32_t xl[8], yl[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    xl[w] = x[8 + w];
    yl[w] = y[8 + w];
  }
  const uint32_t low = lt_mask<8>(xl, yl);
  uint32_t m;
  asm("{\n\t.reg .u32 t, z;\n\tmov.u32 z, 0;\n\t"
      "sub.cc.u32 t, z, %17;\n\t" LT_SUBC(8, 16) LT_SUBC(7, 15) LT_SUBC(6, 14)
          LT_SUBC(5, 13) LT_SUBC(4, 12) LT_SUBC(3, 11) LT_SUBC(2, 10)
              LT_SUBC(1, 9) "subc.u32 %0, z, z;\n\t}"
      : "=r"(m)
      : LT_X(0), LT_X(1), LT_X(2), LT_X(3), LT_X(4), LT_X(5), LT_X(6), LT_X(7),
        LT_Y(0), LT_Y(1), LT_Y(2), LT_Y(3), LT_Y(4), LT_Y(5), LT_Y(6), LT_Y(7),
        "r"(low));
  return m;
}

// a where the mask is clear, b where it is set
__device__ __forceinline__ uint32_t pick(uint32_t a, uint32_t b, uint32_t m) {
  return (a & ~m) | (b & m);
}

// lane l of a plane at l + l / 32: reading R consecutive rows per thread,
// and 32 consecutive rows, are both free of bank conflicts
__host__ __device__ __forceinline__ int padded(int l) { return l + (l >> 5); }

// Registers substage: pairs (r, r | J) of the thread's own rows.
template <int W, int R, int J>
__device__ __forceinline__ void reg_substage(uint32_t (&k)[R][W],
                                             uint32_t (&p)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r & J) continue;
    const int h = r | J;
    const uint32_t swap = lt_mask<W>(k[h], k[r]);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint32_t a = k[r][w], b = k[h][w];
      k[r][w] = pick(a, b, swap);
      k[h][w] = pick(b, a, swap);
    }
    const uint32_t a = p[r], b = p[h];
    p[r] = pick(a, b, swap);
    p[h] = pick(b, a, swap);
  }
}

// The register substages that end a stage, strides 2^(n-1) down to 1, as
// one unrolled sequence, so that registers are renamed across it.
template <int W, int R>
__device__ __forceinline__ void reg_substages(uint32_t (&k)[R][W],
                                              uint32_t (&p)[R], int n) {
  switch (n) {
    case 1:
      reg_substage<W, R, 1>(k, p);
      break;
    case 2:
      reg_substage<W, R, 2>(k, p);
      reg_substage<W, R, 1>(k, p);
      break;
    case 3:
      if constexpr (R >= 8) {
        reg_substage<W, R, 4>(k, p);
        reg_substage<W, R, 2>(k, p);
        reg_substage<W, R, 1>(k, p);
      }
      break;
    default:
      if constexpr (R >= 16) {
        reg_substage<W, R, 8>(k, p);
        reg_substage<W, R, 4>(k, p);
        reg_substage<W, R, 2>(k, p);
        reg_substage<W, R, 1>(k, p);
      }
      break;
  }
}

// The lo row takes its partner's entry iff partner < own; the hi row iff
// own < partner (the ascending keep rule seen from each side).  Both
// borrows are taken and the role picks one, so a warp whose lanes hold
// both roles does not branch.
template <int W>
__device__ __forceinline__ void keep_rule(uint32_t (&own)[W], uint32_t& own_p,
                                          const uint32_t (&other)[W],
                                          uint32_t other_p, uint32_t hi) {
  const uint32_t take = pick(lt_mask<W>(other, own), lt_mask<W>(own, other), hi);
#pragma unroll
  for (int w = 0; w < W; ++w) own[w] = pick(own[w], other[w], take);
  own_p = pick(own_p, other_p, take);
}

// Warp substage: the partner of every row is in lane ^ lane_mask.
template <int W, int R>
__device__ __forceinline__ void shfl_substage(uint32_t (&k)[R][W],
                                              uint32_t (&p)[R], int lane_mask) {
  const uint32_t hi = (threadIdx.x & lane_mask) ? 0xFFFFFFFFu : 0u;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    uint32_t q[W];
#pragma unroll
    for (int w = 0; w < W; ++w) q[w] = __shfl_xor_sync(0xFFFFFFFFu, k[r][w], lane_mask);
    const uint32_t qp = __shfl_xor_sync(0xFFFFFFFFu, p[r], lane_mask);
    keep_rule<W>(k[r], p[r], q, qp, hi);
  }
}

// The thread's rows to their staging lanes, home + r.
template <int W, int R>
__device__ __forceinline__ void to_smem(uint32_t* s, int pitch, int home,
                                        const uint32_t (&k)[R][W],
                                        const uint32_t (&p)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int l = home + r;
#pragma unroll
    for (int w = 0; w < W; ++w) s[w * pitch + l] = k[r][w];
    s[W * pitch + l] = p[r];
  }
}

// Block substage: the partner of every row is in another warp.  The role
// (lo or hi) is the same for the whole warp.
template <int W, int R>
__device__ __forceinline__ void smem_substage(uint32_t (&k)[R][W],
                                              uint32_t (&p)[R], uint32_t* s,
                                              int pitch, int first, int j) {
  __syncthreads();
  to_smem<W, R>(s, pitch, padded(first), k, p);
  __syncthreads();
  const uint32_t hi = (first & j) ? 0xFFFFFFFFu : 0u;
  const int partner = padded(first ^ j);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int l = partner + r;
    uint32_t q[W];
#pragma unroll
    for (int w = 0; w < W; ++w) q[w] = s[w * pitch + l];
    keep_rule<W>(k[r], p[r], q, s[W * pitch + l], hi);
  }
}

// Staging of one tile (rows past `valid` are the caller's): load queues
// asynchronous copies of the low u32 of each int64 word, 4 bytes each,
// into plane w at padded(row); store writes the tile's rows below `valid`
// back as int64.  With the thread count T known at compile time (T = 32,
// the main path's one-warp tiles) and W dividing 32, every address is a
// per-thread base plus a constant; otherwise the row and word of each
// flat index are computed.
template <int W, int R, int T>
__device__ __forceinline__ void load_tile(uint32_t* buf, int pitch,
                                          const int64_t* __restrict__ keys,
                                          const int64_t* __restrict__ rows,
                                          int64_t base, int valid) {
  if constexpr (T == 32 && 32 % W == 0) {
    if (valid == T * R) {
      constexpr int SUB = T / W;  // rows per pass
      uint32_t* dst = buf + (threadIdx.x % W) * pitch + threadIdx.x / W;
      const int64_t* src = keys + base * W + threadIdx.x;
#pragma unroll
      for (int j = 0; j < R * W; ++j)
        __pipeline_memcpy_async(dst + SUB * j + SUB * j / 32, src + j * T, 4);
#pragma unroll
      for (int j = 0; j < R; ++j)
        __pipeline_memcpy_async(buf + W * pitch + padded(T * j) + threadIdx.x,
                                rows + base + T * j + threadIdx.x, 4);
      return;
    }
  }
  for (int f = threadIdx.x; f < valid * W; f += blockDim.x) {
    const int row = f / W, w = f - row * W;
    __pipeline_memcpy_async(buf + w * pitch + padded(row), keys + base * W + f, 4);
  }
  for (int row = threadIdx.x; row < valid; row += blockDim.x)
    __pipeline_memcpy_async(buf + W * pitch + padded(row), rows + base + row, 4);
}

template <int W, int R, int T>
__device__ __forceinline__ void store_tile(const uint32_t* buf, int pitch,
                                           int64_t* __restrict__ keys_out,
                                           int64_t* __restrict__ rows_out,
                                           int64_t base, int valid) {
  if constexpr (T == 32 && 32 % W == 0) {
    if (valid == T * R) {
      constexpr int SUB = T / W;
      const uint32_t* src = buf + (threadIdx.x % W) * pitch + threadIdx.x / W;
      int64_t* dst = keys_out + base * W + threadIdx.x;
#pragma unroll
      for (int j = 0; j < R * W; ++j) dst[j * T] = (int64_t)src[SUB * j + SUB * j / 32];
#pragma unroll
      for (int j = 0; j < R; ++j)
        rows_out[base + T * j + threadIdx.x] =
            (int64_t)buf[W * pitch + padded(T * j) + threadIdx.x];
      return;
    }
  }
  for (int f = threadIdx.x; f < valid * W; f += blockDim.x) {
    const int row = f / W, w = f - row * W;
    keys_out[base * W + f] = (int64_t)buf[w * pitch + padded(row)];
  }
  for (int row = threadIdx.x; row < valid; row += blockDim.x)
    rows_out[base + row] = (int64_t)buf[W * pitch + padded(row)];
}

// One tile of T * R rows (a whole number of sort blocks; T = 0: blockDim.x
// threads) per thread block.  The staging buffer holds plane w at
// s[w * pitch + padded(row)] and the row ids in plane W; it also carries
// the cross-warp exchanges and the sorted tile out.  One buffer and one
// tile per block, not persistent blocks with the next tile's copies in
// flight in a second buffer: the smaller footprint keeps 16 one-warp
// blocks of 4-word keys on an SM, and on the H100 that hid the copies
// better than the prefetch did.
template <int W, int R, int T>
__global__ void __launch_bounds__(2048 / R)
    bitonic_regs_kernel(const int64_t* __restrict__ keys,
                        const int64_t* __restrict__ rows,
                        int64_t* __restrict__ keys_out,
                        int64_t* __restrict__ rows_out, int64_t n,
                        int log_block, int pitch) {
  constexpr int LR = R == 16 ? 4 : R == 8 ? 3 : R == 4 ? 2 : R == 2 ? 1 : 0;
  static_assert((1 << LR) == R, "R must be a power of two up to 16");
  extern __shared__ uint32_t s[];
  const int tile = (T > 0 ? T : blockDim.x) * R;
  const int64_t base = (int64_t)blockIdx.x * tile;
  const int valid = (int)min((int64_t)tile, n - base);
  const int first = threadIdx.x * R;
  const int home = padded(first);  // R divides 32: row first + r at home + r

  load_tile<W, R, T>(s, pitch, keys, rows, base, valid);
  __pipeline_commit();
  for (int f = valid * (W + 1) + threadIdx.x; f < tile * (W + 1); f += blockDim.x) {
    const int row = f / (W + 1), w = f - row * (W + 1);
    s[w * pitch + padded(row)] = kSentinel;
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  uint32_t k[R][W], p[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int w = 0; w < W; ++w) k[r][w] = s[w * pitch + home + r];
    p[r] = s[W * pitch + home + r];
  }

  // Stages of stride below R run in registers only; their complement
  // (rows of descending regions, bit st of the lane set below the last
  // stage, are complemented for the stage) is known per register.
#pragma unroll
  for (int st = 1; st <= LR; ++st) {
    if (st > log_block) break;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t was = st > 1 ? (r >> (st - 1)) & 1 : 0;
      const uint32_t now = st < log_block ? ((first + r) >> st) & 1 : 0;
#pragma unroll
      for (int w = 0; w < W; ++w) k[r][w] ^= 0u - (was ^ now);
    }
    reg_substages<W, R>(k, p, st);
  }
  // Later stages: one complement for all of a thread's rows.
  for (int st = LR + 1; st <= log_block; ++st) {
    const uint32_t was = (first >> (st - 1)) & 1;
    const uint32_t now = st < log_block ? (first >> st) & 1 : 0;
    const uint32_t flip = 0u - (was ^ now);
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int w = 0; w < W; ++w) k[r][w] ^= flip;
    }
    for (int sub = st - 1; sub >= LR; --sub) {
      if (sub < LR + 5)
        shfl_substage<W, R>(k, p, 1 << (sub - LR));
      else
        smem_substage<W, R>(k, p, s, pitch, first, 1 << sub);
    }
    reg_substages<W, R>(k, p, LR);
  }

  __syncthreads();
  to_smem<W, R>(s, pitch, home, k, p);
  __syncthreads();
  store_tile<W, R, T>(s, pitch, keys_out, rows_out, base, valid);
}

// Key word w of block-local row `row` (a pad row past `valid` is all-ones).
__device__ __forceinline__ uint32_t word_of(const int64_t* __restrict__ keys,
                                            int64_t base, int row, int valid,
                                            int n_words, int w) {
  return row < valid ? (uint32_t)keys[(base + row) * n_words + w] : kSentinel;
}

// One sort block per thread block.  Shared memory: n_smem key planes of
// `block` lanes (pitch block + 1), then the lane permutation (uint16).
__global__ void bitonic_wide_kernel(const int64_t* __restrict__ keys,
                                    const int64_t* __restrict__ rows,
                                    int64_t* __restrict__ keys_out,
                                    int64_t* __restrict__ rows_out, int64_t n,
                                    int n_words, int n_smem, int log_block) {
  extern __shared__ uint32_t s[];
  const int block = 1 << log_block, pitch = block + 1;
  uint16_t* perm = reinterpret_cast<uint16_t*>(s + n_smem * pitch);
  const int64_t base = (int64_t)blockIdx.x * block;
  const int valid = (int)min((int64_t)block, n - base);

  for (int l = threadIdx.x; l < block; l += blockDim.x) perm[l] = (uint16_t)l;
  if (n_smem > 0) {  // the leading words of each row, walked flat (row, word)
    int row = threadIdx.x / n_smem, w = threadIdx.x % n_smem;
    const int step_row = blockDim.x / n_smem, step_w = blockDim.x % n_smem;
    for (int f = threadIdx.x; f < block * n_smem; f += blockDim.x) {
      s[w * pitch + row] = word_of(keys, base, row, valid, n_words, w);
      row += step_row;
      w += step_w;
      if (w >= n_smem) {
        w -= n_smem;
        ++row;
      }
    }
  }
  __syncthreads();

  for (int st = 1; st <= log_block; ++st) {
    const int k = 1 << st;
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < block / 2; t += blockDim.x) {
        const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int hi = lo | j;
        int cmp = 0;
        for (int w = 0; w < n_smem; ++w) {
          const uint32_t a = s[w * pitch + lo], b = s[w * pitch + hi];
          if (a != b) {
            cmp = a < b ? -1 : 1;
            break;
          }
        }
        if (cmp == 0 && n_smem < n_words) {
          const int ra = perm[lo], rb = perm[hi];
          for (int w = n_smem; w < n_words; ++w) {
            const uint32_t a = word_of(keys, base, ra, valid, n_words, w);
            const uint32_t b = word_of(keys, base, rb, valid, n_words, w);
            if (a != b) {
              cmp = a < b ? -1 : 1;
              break;
            }
          }
        }
        const bool ascending = (lo & k) == 0;
        if (ascending ? cmp > 0 : cmp < 0) {
          const uint16_t tp = perm[lo];
          perm[lo] = perm[hi];
          perm[hi] = tp;
          for (int w = 0; w < n_smem; ++w) {
            const uint32_t tmp = s[w * pitch + lo];
            s[w * pitch + lo] = s[w * pitch + hi];
            s[w * pitch + hi] = tmp;
          }
        }
      }
      __syncthreads();
    }
  }

  for (int l = threadIdx.x; l < valid; l += blockDim.x) {
    const int src = perm[l];
    rows_out[base + l] = src < valid ? rows[base + src] : (int64_t)kSentinel;
  }
  if (n_words == 0) return;
  int row = threadIdx.x / n_words, w = threadIdx.x % n_words;
  const int step_row = blockDim.x / n_words, step_w = blockDim.x % n_words;
  for (int f = threadIdx.x; f < valid * n_words; f += blockDim.x) {
    keys_out[base * n_words + f] =
        (int64_t)word_of(keys, base, perm[row], valid, n_words, w);
    row += step_row;
    w += step_w;
    if (w >= n_words) {
      w -= n_words;
      ++row;
    }
  }
}

int ilog2(int x) {
  int l = 0;
  while ((1 << (l + 1)) <= x) ++l;
  return l;
}

// Dynamic shared memory past the default 48 KB needs an opt-in per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= (size_t)kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

int launch_wide(const void* keys, const void* rows, void* keys_out,
                void* rows_out, int64_t n, int n_words, int block,
                cudaStream_t stream) {
  const int pitch = block + 1;
  const int fit = (kSmemDefault - 2 * block) / (4 * pitch);
  const int n_smem = n_words < fit ? n_words : fit;
  const size_t smem = (size_t)n_smem * pitch * 4 + (size_t)block * 2;
  const int threads = block / 2 < 256 ? block / 2 : 256;
  const int64_t blocks = (n + block - 1) / block;
  bitonic_wide_kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      (const int64_t*)keys, (const int64_t*)rows, (int64_t*)keys_out,
      (int64_t*)rows_out, n, n_words, n_smem, ilog2(block));
  return (int)cudaGetLastError();
}

template <int W, int R, int T>
int launch_one(const void* keys, const void* rows, void* keys_out,
               void* rows_out, int64_t n, int block, cudaStream_t stream) {
  const int threads = block / R > 32 ? block / R : 32;
  const int tile = threads * R;
  // a plane's pitch: the padded lanes rounded up to a bank row, then
  // offset so that the W planes of one staged row spread over the banks
  const int spread = 32 / W > 0 ? 32 / W : 1;
  const int pitch = (padded(tile) + 31) / 32 * 32 + spread;
  const size_t smem = (size_t)(W + 1) * pitch * sizeof(uint32_t);
  const cudaError_t err = allow_smem(bitonic_regs_kernel<W, R, T>, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that a later launch does not report it
    return (int)err;
  }
  const int64_t blocks = (n + tile - 1) / tile;
  bitonic_regs_kernel<W, R, T><<<(unsigned)blocks, threads, smem, stream>>>(
      (const int64_t*)keys, (const int64_t*)rows, (int64_t*)keys_out,
      (int64_t*)rows_out, n, ilog2(block), pitch);
  return (int)cudaGetLastError();
}

// One warp per tile (T = 32, every address static) where the block fits.
template <int W, int R>
int launch_regs(const void* keys, const void* rows, void* keys_out,
                void* rows_out, int64_t n, int block, cudaStream_t stream) {
  if (block <= 32 * R)
    return launch_one<W, R, 32>(keys, rows, keys_out, rows_out, n, block, stream);
  return launch_one<W, R, 0>(keys, rows, keys_out, rows_out, n, block, stream);
}

}  // namespace

extern "C" int repro_bitonic_block_sort(const void* keys, const void* rows,
                                        void* keys_out, void* rows_out,
                                        int64_t n, int n_words, int block,
                                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (n_words) {
    case 1: return launch_regs<1, 16>(keys, rows, keys_out, rows_out, n, block, st);
    case 2: return launch_regs<2, 16>(keys, rows, keys_out, rows_out, n, block, st);
    case 3: return launch_regs<3, 16>(keys, rows, keys_out, rows_out, n, block, st);
    case 4: return launch_regs<4, 16>(keys, rows, keys_out, rows_out, n, block, st);
    case 5: return launch_regs<5, 8>(keys, rows, keys_out, rows_out, n, block, st);
    case 6: return launch_regs<6, 8>(keys, rows, keys_out, rows_out, n, block, st);
    case 7: return launch_regs<7, 8>(keys, rows, keys_out, rows_out, n, block, st);
    case 8: return launch_regs<8, 8>(keys, rows, keys_out, rows_out, n, block, st);
    case 16: return launch_regs<16, 4>(keys, rows, keys_out, rows_out, n, block, st);
    default: return launch_wide(keys, rows, keys_out, rows_out, n, n_words, block, st);
  }
}
