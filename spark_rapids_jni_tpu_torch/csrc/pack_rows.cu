// K6: fixed-width columns -> the row format's word image.
//
// Replaces spark_rapids_jni_tpu/ops/pallas_kernels.py
// `_pack_rows_compiled` / `pack_rows_pallas` (kernel factory
// `_make_pack_kernel`), and computes what the reference library's
// `copy_from_fixed_width_columns` (row_conversion.cu) does: each column's
// bytes at an offset aligned to its own size, one validity byte per 8
// columns after the last column (bit c % 8 of byte c / 8, 1 = valid),
// the row padded to 8 bytes, little-endian. Unlike the TPU kernel it
// writes real validity: a column with validity words contributes bit r of
// word r / 32; a null pointer means all valid.
//
// What bounds it on an H100: bytes (each column value read once, the
// validity words, each row image written once). The host plans the
// schema once (ops/cuda_kernels.py `pack_plan`): for each 4-byte word of
// the row, the (column, width, source shift, destination shift)
// contributions whose OR forms it. The wrapper hands the plan, with the
// column and validity pointers, over as one small int64 array on the
// card, so any number of columns fits; each block copies it to shared
// memory first when it fits there (the threads of a warp index it at
// different places), and otherwise reads it through the cache.
//
// One warp makes one row: lane w makes output words w, w + 32, ..., so
// the row image (a contiguous run of words) is stored coalesced, and no
// thread divides to find its row. A block takes a run of 64 consecutive
// rows, its warps interleaved over them, so the column reads of one row
// and those of the next rows fall on the same L1 sectors of the same
// SM. The warp makes 32 words at a time; where they hold validity
// bytes, lane c votes the validity bit of column 32 j + c with
// __ballot_sync for each run j of 32 columns they cover (four bytes a
// vote), lane j keeps vote j, and each lane fetches the two votes its
// word's bytes come from with __shfl_sync: the votes stay in registers.
// An 8-byte column gives its low word to one
// output word and its high word to the next; 1- and 2-byte values are
// read unsigned, which equals the TPU kernel's sign extension followed
// by a mask. The reference's shared-memory staging of whole row tiles
// (coalesced column reads as well) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 64;
constexpr int64_t kMaxBlocks = 1 << 20;
// the largest plan staged in shared memory: the dynamic shared memory a
// block may take without asking for more
constexpr size_t kMaxStagedBytes = 48 * 1024;

// The plan: int64 col[n_cols] and valid[n_cols] (device pointers; a
// null validity pointer means every row valid), then int32
// word_first[n_words + 1] (word w ORs entries [word_first[w],
// word_first[w + 1])), ent_col[n_entries] and ent_meta[n_entries]
// (width | src_shift << 8 | dst_shift << 16), padded to 8 bytes.

__device__ __forceinline__ uint32_t load_part(const void* col, int width,
                                              int64_t r, int src_shift) {
  switch (width) {
    case 1: return static_cast<const uint8_t*>(col)[r];
    case 2: return static_cast<const uint16_t*>(col)[r];
    case 4: return static_cast<const uint32_t*>(col)[r];
    default:
      return static_cast<uint32_t>(static_cast<const uint64_t*>(col)[r] >>
                                   src_shift);
  }
}

// kStaged: the plan is copied to shared memory (a compile-time choice,
// so that the loads from it are shared-memory loads)
template <bool kStaged>
__global__ void pack_rows_kernel(const int64_t* __restrict__ gplan,
                                 int plan_words, int n_cols, int n_words,
                                 int n_entries, int validity_offset,
                                 int64_t n_rows, uint32_t* __restrict__ out) {
  extern __shared__ int64_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_chunks = (n_cols + 31) / 32;
  const int n_vbytes = (n_cols + 7) / 8;
  const int64_t* plan = gplan;
  if constexpr (kStaged) {
    for (int i = threadIdx.x; i < plan_words; i += blockDim.x) {
      smem[i] = gplan[i];
    }
    plan = smem;
    __syncthreads();
  }
  const int64_t* col = plan;
  const int64_t* valid = plan + n_cols;
  const int* word_first = reinterpret_cast<const int*>(plan + 2 * n_cols);
  const int* ent_col = word_first + n_words + 1;
  const int* ent_meta = ent_col + n_entries;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kRowsPerBlock;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
       base < n_rows; base += step) {
    const int64_t end =
        base + kRowsPerBlock < n_rows ? base + kRowsPerBlock : n_rows;
    // r and w0 depend on the warp only, so all 32 lanes reach each
    // ballot and shuffle
    for (int64_t r = base + warp; r < end; r += kWarps) {
      uint32_t* row = out + r * n_words;
      for (int w0 = 0; w0 < n_words; w0 += 32) {
        const int w = w0 + lane;
        uint32_t word = 0;
        if (w < n_words) {
          for (int e = word_first[w]; e < word_first[w + 1]; ++e) {
            const int meta = ent_meta[e];
            word |= load_part(
                        reinterpret_cast<const void*>(col[ent_col[e]]),
                        meta & 0xFF, r, (meta >> 8) & 0xFF)
                    << ((meta >> 16) & 0xFF);
          }
        }
        // validity bytes [b_first, b_first + 128) of the row fall in
        // words w0 .. w0 + 31: vote the chunks of 32 columns they hold
        const int b_first = 4 * w0 - validity_offset;
        if (b_first + 128 > 0 && b_first < n_vbytes) {
          const int j_first = (b_first > 0 ? b_first : 0) >> 2;
          int j_end = ((b_first + 127) >> 2) + 1;
          j_end = j_end < n_chunks ? j_end : n_chunks;
          uint32_t mine = 0;   // chunk j_first + lane
          uint32_t extra = 0;  // chunk j_first + 32 (same in every lane)
          for (int j = j_first; j < j_end; ++j) {
            const int c = 32 * j + lane;
            uint32_t bit = 0;  // padding bits of the last byte stay 0
            if (c < n_cols) {
              const uint32_t* vw =
                  reinterpret_cast<const uint32_t*>(valid[c]);
              bit = vw == nullptr ? 1u : (vw[r >> 5] >> (r & 31)) & 1u;
            }
            const uint32_t bits = __ballot_sync(0xFFFFFFFFu, bit);
            if (j - j_first == lane) mine = bits;
            if (j - j_first == 32) extra = bits;
          }
          // word w holds bytes b0 .. b0 + 3: the tail of chunk q0 and
          // the head of chunk q0 + 1 (relative to j_first)
          const int b0 = 4 * w - validity_offset;
          const int q0 = (b0 >> 2) - j_first;  // floor, b0 may be < 0
          const uint32_t got0 = __shfl_sync(0xFFFFFFFFu, mine, q0 & 31);
          const uint32_t got1 =
              __shfl_sync(0xFFFFFFFFu, mine, (q0 + 1) & 31);
          const uint32_t lo = q0 < 0 ? 0u : q0 < 32 ? got0 : extra;
          const uint32_t hi = q0 + 1 < 0 ? 0u : q0 + 1 < 32 ? got1 : extra;
          const uint64_t both = lo | static_cast<uint64_t>(hi) << 32;
          word |= static_cast<uint32_t>(both >> (8 * (b0 & 3)));
        }
        if (w < n_words) row[w] = word;
      }
    }
  }
}

}  // namespace

// `plan` is the plan above, on the card, `plan_words` int64 words long.
// Returns the CUDA error of the launch (0 = success), or
// cudaErrorInvalidValue for a malformed plan.
extern "C" int srt_pack_rows(const long long* plan, int plan_words,
                             int n_cols, int n_words, int n_entries,
                             int validity_offset, long long n_rows,
                             void* out, void* stream) {
  if (n_cols <= 0 || n_words <= 0 || n_entries < 0 ||
      2 * plan_words < 4 * n_cols + n_words + 1 + 2 * n_entries) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows <= 0) return 0;
  const size_t plan_bytes = sizeof(int64_t) * static_cast<size_t>(plan_words);
  const bool staged = plan_bytes <= kMaxStagedBytes;
  int64_t blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid(static_cast<unsigned int>(blocks));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* p = reinterpret_cast<const int64_t*>(plan);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (staged) {
    pack_rows_kernel<true><<<grid, kThreads, plan_bytes, s>>>(
        p, plan_words, n_cols, n_words, n_entries, validity_offset, n_rows,
        o);
  } else {
    pack_rows_kernel<false><<<grid, kThreads, 0, s>>>(
        p, plan_words, n_cols, n_words, n_entries, validity_offset, n_rows,
        o);
  }
  return static_cast<int>(cudaGetLastError());
}
