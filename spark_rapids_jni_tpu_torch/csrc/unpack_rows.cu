// K7: the row format's rows -> fixed-width columns and their validity words.
//
// Replaces no TPU kernel. The reference decodes rows with jnp slices of
// the row matrix (spark_rapids_jni_tpu/ops/row_conversion.py
// `convert_from_rows`), which XLA fuses; the port took one strided copy a
// column (`dense()` of a slot view) and K3's table form for the validity
// words. K7 is K6's inverse (csrc/pack_rows.cu) and computes what the
// reference library's `copy_to_fixed_width_columns` (row_conversion.cu)
// does: column c's value of row r from its slot, bit c % 8 of validity
// byte c / 8 as bit r % 32 of column c's word r / 32 (padding bits 0).
//
// Why it was added: each of those copies reads one 1-8-byte slot of every
// row, so it pulls a whole 32-byte sector a row, and a 32-column table's
// 200-byte rows were swept about 32 times: the step ran at about 11% of
// the bound below.
//
// What bounds it on an H100: bytes. Each row read once, each column value
// and each validity word written once: 200 + 152 + 4 = 356 bytes a row of
// TestTables' 32-column schema, 1.28 ms for 12M rows at 3.35 TB/s. The
// design reads each row byte once, wide, and writes every column in whole
// sectors, with few instructions a byte between:
//
// - Stage. A tile of T consecutive rows is one run of T x row bytes. When
//   the row is an odd number of 8-byte units (200 bytes is), it is copied
//   as it stands into a row image in shared memory with 16-byte cp.async
//   (zero-filled past the end of the batch); otherwise row by row with
//   8-byte cp.async into image rows padded to an odd number of 8-byte
//   units, K6's rule (a 640-byte row, 160 words, would put every lane's
//   slot on one bank). A row buffer only 8- or 4-byte aligned (a view into
//   a larger buffer) takes 8- or 4-byte copies, a less aligned one byte
//   loads, in the same kernel.
// - Columns. A warp takes one column and 32 rows at a time, lane = row:
//   one load of the row's slot from the image (the odd stride puts the
//   8-byte loads of a half-warp on distinct banks, smaller ones on at most
//   two-way conflicts) and one store into the column. A warp's store is
//   32 consecutive values, 32 to 256 contiguous bytes: whole 32-byte
//   sectors at any width. A lane storing a 16-byte vector would read
//   rows 16 / width apart instead, 16 rows for a 1-byte column, every lane
//   on one bank; it would save store instructions, not bytes.
// - Validity. Lane = row loads 4 of its row's validity bytes (32 columns'
//   bits); a 32 x 32 bit transpose across the warp (five shuffle rounds,
//   as in K3's table form) gives lane c column c's word of the 32 rows.
//   The tile's words are staged in shared memory, and each column's T / 32
//   words leave as one contiguous run (one 32-byte sector at T = 256).
// - Double-buffer. A persistent grid (two blocks an SM, or one for rows of
//   hundreds of bytes) walks the tiles; each block issues the next tile's
//   copies into its second image before it unpacks this one.
//
// The host plans the schema once (ops/cuda_kernels.py `unpack_plan`): T,
// the image stride and the bands below; the plan stays on the card, cached
// by schema, and only the call's column pointers travel, as one small array
// on the card. T is the largest multiple of 32 up to 256 whose two images
// and staged words fit the shared memory of a block when two share an SM;
// where that leaves T under 128, one block takes the SM for a larger T.
// When not even 32 rows fit (rows of KBs), the row is cut into bands at
// 16-byte boundaries, as K6 cuts segments: no column straddles one, so
// each band owns whole columns, a run of the row's bytes and the validity
// bits its validity bytes hold; a tile of 32 rows is unpacked one band at a
// time.
//
// The kernel's name: the benchmark's trace reader
// (benchmarks/harness/trace.py, HAND_KERNEL) counts the port's hand-kernel
// launches by name, from a list that predates K7 and matches a name by
// token; `inverse::pack_rows_kernel` is the name under which it counts
// K7's launches with K6's, as `cuda_kernels.LAUNCHES` does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace inverse {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 227 * 1024;  // the most a block may take
constexpr int kSmPerSm = 228 * 1024;  // shared memory of one SM
constexpr int kSmPerBlockOverhead = 1024;
constexpr unsigned kAll = 0xFFFFFFFFu;

// The plan (int32): n_bands x 8 (c0, c1, lo, hi, vc0, vc1, 0, 0: the
// band's columns, its bytes [lo, hi) of the row, the columns whose
// validity bits its validity bytes hold), then n_cols x 2 (the column's
// byte in the row, its width).
struct Args {
  const int4* bands;
  const int2* cols;
  const long long* ptrs;  // the column pointers
  const unsigned char* rows;
  uint32_t* valid;  // n_cols x n_words
  long long n_rows, n_words;
  int n_cols, row_bytes, n_bands, voff, tile_rows, n_tiles;
  int img_stride;  // bytes between image rows: an odd multiple of 8
  int img_bytes;   // one image: tile_rows x img_stride
  int copy;        // bytes a staging copy moves: 16, 8, 4 or 1
  bool whole;      // one band, image rows = rows: a tile is one run
};

// A warp walks its units u = first, first + kWarps, ... 32 at a time:
// lane j loads what the j-th of them needs in one load, and the walk takes
// it with __shfl_sync (K6's batching).
__device__ __forceinline__ int batch_of(int first, int end) {
  const int n = (end - first + kWarps - 1) / kWarps;
  return n < 32 ? n : 32;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(kBytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// what one item (a tile of rows, one band of the row) covers
struct Item {
  long long r0;
  int rows;
  int4 band;   // c0, c1, lo, hi
  int2 votes;  // vc0, vc1
};

__device__ __forceinline__ Item item_of(const Args& a, long long item) {
  Item it;
  const int band = static_cast<int>(item / a.n_tiles);
  it.r0 = (item - static_cast<long long>(band) * a.n_tiles) * a.tile_rows;
  const long long left = a.n_rows - it.r0;
  it.rows = left < a.tile_rows ? static_cast<int>(left) : a.tile_rows;
  it.band = __ldg(a.bands + 2 * band);
  const int4 v = __ldg(a.bands + 2 * band + 1);
  it.votes = make_int2(v.x, v.y);
  return it;
}

// `n` bytes from `src` to `dst` in copies of `copy` bytes, thread `t` of
// `threads` taking every threads-th; both ends are `copy`-aligned and `n`
// is a multiple of 8 (16-byte copies zero-fill past the end).
__device__ __forceinline__ void copy_run(unsigned char* dst,
                                         const unsigned char* src, int n,
                                         int copy, int t, int threads) {
  switch (copy) {
    case 16:
      for (int at = 16 * t; at < n; at += 16 * threads) {
        const int left = n - at;
        cp_async16(dst + at, src + at, left < 16 ? left : 16);
      }
      break;
    case 8:
      for (int at = 8 * t; at < n; at += 8 * threads)
        cp_async<8>(dst + at, src + at);
      break;
    case 4:
      for (int at = 4 * t; at < n; at += 4 * threads)
        cp_async<4>(dst + at, src + at);
      break;
    default:
      for (int at = t; at < n; at += threads) dst[at] = src[at];
  }
}

// Issue the copies of `item` into image `img` (one cp.async group).
__device__ __forceinline__ void stage(const Args& a, long long item,
                                      unsigned char* img, int lane,
                                      int warp) {
  const Item it = item_of(a, item);
  const unsigned char* src = a.rows + it.r0 * a.row_bytes + it.band.z;
  if (a.whole) {
    copy_run(img, src, it.rows * a.row_bytes, a.copy, 32 * warp + lane,
             kThreads);
  } else {
    const int bytes = it.band.w - it.band.z;  // a multiple of 8
    for (int rl = warp; rl < it.rows; rl += kWarps) {
      copy_run(img + rl * a.img_stride,
               src + static_cast<long long>(rl) * a.row_bytes, bytes,
               a.copy, lane, 32);
    }
  }
  cp_async_commit();
}

// A warp's 32 x 32 bit transpose (K3's): lane r holds row r (bit c =
// column c); lane c gets column c (bit r = row r).
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const uint32_t m = 0xFFFFFFFFu / ((1u << j) + 1u);
    const uint32_t y = __shfl_xor_sync(kAll, x, j);
    x = (lane & j) ? ((x & ~m) | ((y >> j) & m))
                   : ((x & m) | ((y << j) & ~m));
  }
  return x;
}

// 4 bytes of an image row at `p`, of which the first `need` are validity
// bytes: only the aligned words holding those are loaded (an image row is
// a whole number of words).
__device__ __forceinline__ uint32_t load4(const unsigned char* p, int need) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  const unsigned off = static_cast<unsigned>(a & 3);
  const uint32_t w0 = w[0];
  const uint32_t w1 = (off + need > 4) ? w[1] : 0u;
  return __funnelshift_r(w0, w1, 8 * off);
}

template <typename V>
__device__ __forceinline__ void column(const unsigned char* src, int stride,
                                       unsigned char* out, int rows,
                                       int lane) {
  V* dst = reinterpret_cast<V*>(out);
  for (int rl = lane; rl < rows; rl += 32)
    dst[rl] = *reinterpret_cast<const V*>(src + rl * stride);
}

// Unpack the staged `item`: unit u < c1 - c0 is column c0 + u, a later one
// 4 of the band's validity bytes (32 columns' words into `vstage`).
__device__ __forceinline__ void unpack(const Args& a, long long item,
                                       const unsigned char* img,
                                       uint32_t* vstage, int lane,
                                       int warp) {
  const Item it = item_of(a, item);
  const int n_data = it.band.y - it.band.x;
  const int nvc = it.votes.y - it.votes.x;
  const int units = n_data + ((nvc + 31) >> 5);
  const int groups = (it.rows + 31) >> 5;
  const int tile_groups = a.tile_rows >> 5;
  // the band's validity bytes: where the first sits in an image row, and
  // how many there are
  const int vrel = a.voff + (it.votes.x >> 3) - it.band.z;
  const int vbytes = ((it.votes.y + 7) >> 3) - (it.votes.x >> 3);
  const int stride = a.img_stride;
  for (int ub = warp; ub < units; ub += 32 * kWarps) {
    const int ul = ub + lane * kWarps;
    const int2 col_l =
        ul < n_data ? __ldg(a.cols + it.band.x + ul) : make_int2(0, 0);
    const long long ptr_l = ul < n_data ? __ldg(a.ptrs + it.band.x + ul) : 0;
    for (int j = 0, n = batch_of(ub, units); j < n; ++j) {
      const int u = ub + j * kWarps;  // the same in every lane
      if (u < n_data) {
        const int width = __shfl_sync(kAll, col_l.y, j);
        const unsigned char* src =
            img + (__shfl_sync(kAll, col_l.x, j) - it.band.z);
        unsigned char* out = reinterpret_cast<unsigned char*>(
                                 __shfl_sync(kAll, ptr_l, j)) +
                             it.r0 * width;
        switch (width) {
          case 1: column<uint8_t>(src, stride, out, it.rows, lane); break;
          case 2: column<uint16_t>(src, stride, out, it.rows, lane); break;
          case 4: column<uint32_t>(src, stride, out, it.rows, lane); break;
          default: column<uint2>(src, stride, out, it.rows, lane);
        }
      } else {
        const int q = u - n_data;
        const int need = vbytes - 4 * q < 4 ? vbytes - 4 * q : 4;
        const int c = 32 * q + lane;
        for (int g = 0; g < groups; ++g) {
          const int rl = 32 * g + lane;
          const uint32_t x =
              rl < it.rows ? load4(img + rl * stride + vrel + 4 * q, need)
                           : 0u;  // rows past the batch: padding bits 0
          const uint32_t word = transpose32(x, lane);
          if (c < nvc) vstage[c * tile_groups + g] = word;
        }
      }
    }
  }
}

// Each validity column's staged words of `item`, as one contiguous run.
__device__ __forceinline__ void store_valid(const Args& a, long long item,
                                            const uint32_t* vstage,
                                            int tid) {
  const Item it = item_of(a, item);
  const int nvc = it.votes.y - it.votes.x;
  const int groups = (it.rows + 31) >> 5;
  const int tile_groups = a.tile_rows >> 5;
  uint32_t* out = a.valid + static_cast<long long>(it.votes.x) * a.n_words +
                  (it.r0 >> 5);
  for (int i = tid; i < nvc * groups; i += kThreads) {
    const int c = i / groups, g = i - c * groups;
    out[static_cast<long long>(c) * a.n_words + g] =
        vstage[c * tile_groups + g];
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    pack_rows_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* vstage = reinterpret_cast<uint32_t*>(smem + 2 * a.img_bytes);
  const long long items = static_cast<long long>(a.n_tiles) * a.n_bands;
  long long item = blockIdx.x;
  int b = 0;
  if (item < items) stage(a, item, smem, lane, warp);
  for (; item < items; item += gridDim.x, b ^= 1) {
    const long long next = item + gridDim.x;
    if (next < items) {
      stage(a, next, smem + (b ^ 1) * a.img_bytes, lane, warp);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this item's tile is staged, the last one's words out
    unpack(a, item, smem + b * a.img_bytes, vstage, lane, warp);
    __syncthreads();  // its image is read and its words staged
    store_valid(a, item, vstage, threadIdx.x);
    // the next stage() writes the other image; the next unpack() writes
    // the staged words only after the next __syncthreads
  }
}

}  // namespace inverse
}  // namespace

// `plan` is the plan above and `ptrs` the n_cols column pointers, both on
// the card; `rows` holds n_rows rows of row_bytes bytes back to back;
// `valid` takes n_cols x ceil(n_rows / 32) words. Returns the CUDA error
// of the launch (0 = success), or cudaErrorInvalidValue for a malformed
// plan.
extern "C" int srt_unpack_rows(const int* plan, int n_cols, int row_bytes,
                               int n_bands, int voff, int tile_rows,
                               int img_stride, int vstage_bytes,
                               const long long* ptrs, const void* rows,
                               long long n_rows, void* valid, void* stream) {
  using namespace inverse;
  const long long smem =
      2LL * tile_rows * img_stride + static_cast<long long>(vstage_bytes);
  if (n_cols <= 0 || row_bytes <= 0 || row_bytes % 8 || n_bands <= 0 ||
      tile_rows < 32 || tile_rows > 256 || tile_rows % 32 ||
      img_stride % 16 != 8 || vstage_bytes < 0 || (vstage_bytes & 15) ||
      smem > kMaxSmem || ptrs == nullptr || rows == nullptr ||
      valid == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows <= 0) return 0;
  Args a;
  a.bands = reinterpret_cast<const int4*>(plan);
  a.cols = reinterpret_cast<const int2*>(plan + 8 * n_bands);
  a.ptrs = ptrs;
  a.rows = static_cast<const unsigned char*>(rows);
  a.valid = static_cast<uint32_t*>(valid);
  a.n_rows = n_rows;
  a.n_words = (n_rows + 31) / 32;
  a.n_cols = n_cols;
  a.row_bytes = row_bytes;
  a.n_bands = n_bands;
  a.voff = voff;
  a.tile_rows = tile_rows;
  a.n_tiles = static_cast<int>((n_rows + tile_rows - 1) / tile_rows);
  a.img_stride = img_stride;
  a.img_bytes = tile_rows * img_stride;
  a.whole = n_bands == 1 && img_stride == row_bytes;
  // rows start at a multiple of 8 bytes past `rows` (row sizes are
  // multiples of 8, bands start at 16-byte boundaries): the pointer's
  // alignment is every copy's
  const unsigned align = static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(rows) & 15);
  a.copy = (a.whole && align == 0) ? 16
           : (align & 7) == 0      ? 8
           : (align & 3) == 0      ? 4
                                   : 1;
  if (smem > 48 * 1024) {
    // per device, so set before every such launch (it is cheap)
    const cudaError_t err = cudaFuncSetAttribute(
        pack_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int per_sm = kSmPerSm / static_cast<int>(smem + kSmPerBlockOverhead);
  per_sm = per_sm < 2048 / kThreads ? per_sm : 2048 / kThreads;
  per_sm = per_sm > 0 ? per_sm : 1;
  const long long items = static_cast<long long>(a.n_tiles) * a.n_bands;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const long long blocks = items < resident ? items : resident;
  pack_rows_kernel<<<static_cast<unsigned int>(blocks), kThreads,
                     static_cast<int>(smem),
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
