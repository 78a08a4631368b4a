// pext: compressed-key extraction (paper §5.1) for Hopper.
//
// Replaces repro/kernels/pext/kernel.py::_pext_kernel / pext_planes, the
// TPU kernel that applies the extraction plan as a static shift/mask
// schedule over (W, tile) word planes, a few vector operations per kept
// bit.  Per key, that is a few integer instructions per kept bit: about a
// thousand for the 110 D-bits of the 10M-key slice, which is what held the
// first port back.
//
// Here the host compiles the plan into segments (kernels/pext/ops.py,
// segment_plan): one for each source byte that holds kept bits, split
// where its bits cross a destination word.  A segment carries the byte's
// address in the key, the offset of its table (the compacted bits of all
// 256 byte values under its mask, shared by segments of equal masks), a
// multiplier 2^shift that places the compacted bits in the destination
// word, and that word.  So the work per key is one table read and one
// multiply-add per segment, not per kept bit.
//
// Bound: bytes.  Each key is read once (W words) and Wc words are written.
// A block stages a tile of rows in shared memory with coalesced loads
// (keys are row-major int64, as the pipeline holds them), each thread
// compresses one row of the tile, and the tile of compressed keys is
// stored coalesced.  Blocks stride over the tiles, so the plan is copied
// into shared memory once per block.  Shared memory: the segments (int4),
// the key tile (pitch W | 1 words, so a thread per row reads without bank
// conflicts), the output tile (pitch Wc | 1) and the tables (bytes).
#include "common.cuh"

namespace {

constexpr int kSmemDefault = 48 * 1024;
constexpr int kMaxBlocks = 2048;

// Walk a flat index f over rows of `width` words in steps of blockDim.x
// without a division per element.
struct FlatWalk {
  int row, w, step_row, step_w, width;
  __device__ FlatWalk(int width_) : width(width_) {
    row = threadIdx.x / width;
    w = threadIdx.x % width;
    step_row = blockDim.x / width;
    step_w = blockDim.x % width;
  }
  __device__ void next() {
    row += step_row;
    w += step_w;
    if (w >= width) {
      w -= width;
      ++row;
    }
  }
};

__global__ void pext_kernel(const int64_t* __restrict__ keys,
                            const int32_t* __restrict__ plan,
                            int64_t* __restrict__ out, int64_t n, int n_words,
                            int n_words_out, int n_seg, int n_tables) {
  extern __shared__ int4 smem[];
  const int tile = blockDim.x;
  const int pitch_in = n_words | 1, pitch_out = n_words_out | 1;
  int4* seg = smem;  // (byte address ^ 3, table offset, 2^shift, dst word)
  uint32_t* in = reinterpret_cast<uint32_t*>(seg + n_seg);
  uint32_t* res = in + tile * pitch_in;
  uint32_t* tables = res + tile * pitch_out;
  for (int i = threadIdx.x; i < 4 * n_seg; i += blockDim.x)
    reinterpret_cast<int32_t*>(seg)[i] = plan[i];
  for (int i = threadIdx.x; i < 64 * n_tables; i += blockDim.x)
    tables[i] = (uint32_t)plan[4 * n_seg + i];
  const uint8_t* table_bytes = reinterpret_cast<const uint8_t*>(tables);
  const uint8_t* my_key = reinterpret_cast<const uint8_t*>(in + threadIdx.x * pitch_in);

  const int64_t n_tiles = (n + tile - 1) / tile;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t base = t * tile;
    const int valid = (int)min((int64_t)tile, n - base);
    {
      FlatWalk at(n_words);
      const int64_t* src = keys + base * n_words;
      for (int f = threadIdx.x; f < valid * n_words; f += blockDim.x) {
        in[at.row * pitch_in + at.w] = (uint32_t)src[f];
        at.next();
      }
    }
    __syncthreads();
    // word q / 4 of the key holds byte q at bits 31 - 8 (q % 4) down; in
    // little-endian shared memory that byte sits at address q ^ 3
    uint32_t acc = 0;
    int cur = 0;
    for (int i = 0; i < n_seg; ++i) {
      const int4 sg = seg[i];
      if (sg.w != cur) {
        res[threadIdx.x * pitch_out + cur] = acc;
        acc = 0;
        cur = sg.w;
      }
      acc += (uint32_t)table_bytes[sg.y + my_key[sg.x]] * (uint32_t)sg.z;
    }
    res[threadIdx.x * pitch_out + cur] = acc;
    __syncthreads();
    {
      FlatWalk at(n_words_out);
      int64_t* dst = out + base * n_words_out;
      for (int f = threadIdx.x; f < valid * n_words_out; f += blockDim.x) {
        dst[f] = (int64_t)res[at.row * pitch_out + at.w];
        at.next();
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int repro_pext(const void* keys, const void* plan, void* out,
                          int64_t n, int n_words, int n_words_out, int n_seg,
                          int n_tables, void* stream) {
  // the key and output tiles grow with the widths: past a few hundred
  // words (a 513-word document key with every bit kept needs 290 KB at 64
  // rows) halve the tile until the block fits the card's opt-in limit
  int device = 0, smem_max = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  int threads = n_words <= 32 ? 128 : 64;
  auto smem_for = [&](int t) {
    return (size_t)n_seg * sizeof(int4) +
           (size_t)t * ((n_words | 1) + (n_words_out | 1)) * 4 + (size_t)n_tables * 256;
  };
  while (threads > 32 && smem_for(threads) > (size_t)smem_max) threads /= 2;
  const size_t smem = smem_for(threads);
  if (smem > (size_t)kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        pext_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so that a later launch does not report it
      return (int)err;
    }
  }
  const int64_t tiles = (n + threads - 1) / threads;
  const int blocks = tiles < kMaxBlocks ? (int)tiles : kMaxBlocks;
  pext_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int64_t*)keys, (const int32_t*)plan, (int64_t*)out, n, n_words,
      n_words_out, n_seg, n_tables);
  return (int)cudaGetLastError();
}
