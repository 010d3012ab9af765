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
// validity words, each row image written once). The design moves them
// through shared memory in tiles of T consecutive rows, as the reference
// library's kernel does, and spends few instructions a byte between:
//
// - Load. A column's T values are one run of T x width bytes; one warp
//   copies it with 16-byte cp.async (zero-filled past the end of the
//   batch), and the tile's T / 32 validity words of each column with
//   4-byte cp.async (all ones for a column without validity). Every
//   column pointer is read warp-uniformly, once a tile.
// - Assemble, column by column. A warp takes one column and 32 rows at a
//   time, lane = row: one load of the staged values (consecutive, no bank
//   conflicts) and one store of each into its row of a row image in
//   shared memory. The image's row stride is an odd number of 8-byte
//   units, so the 8-byte stores of a half-warp fall on distinct banks
//   (4-byte and smaller ones on at most two-way conflicts); a 640-byte
//   row, 160 words, would otherwise put all 32 lanes on one bank. A
//   validity byte is built the same way: lane = row, the 8 columns' staged
//   words read once each for the whole warp. Padding stays 0: the image
//   is zeroed at the start and each part again as it is stored.
// - Store. When the image rows are the output rows (stride = row size),
//   the tile's rows are one run of the output, copied out with 16-byte
//   stores; otherwise row by row with 8-byte stores.
// - Double-buffer. A persistent grid (two blocks an SM, or one for rows
//   of hundreds of bytes) walks the tiles; each block issues the next
//   tile's loads before it assembles this one.
//
// The host plans the schema once (ops/cuda_kernels.py `pack_plan`): T, the
// staging offsets, each column's place in the image, and the segments
// below; the plan stays on the card, cached by schema. Only the call's
// column and validity pointers travel, as one small array on the card:
// passed as a kernel parameter block instead, they made torch.profiler
// drop most of K6's launches on the H100.
//
// Any number of columns. T is the largest multiple of 32 up to 256 whose
// two staging buffers and row image fit the shared memory of a block when
// two share an SM (PACK_SMEM_BYTES); where that leaves T under 128 (rows
// of hundreds of bytes), one block takes the SM for a larger T: on the
// card, longer tiles helped such rows more than a second block did. When
// not even 32 rows fit (rows of KBs), the row is cut into segments at
// 16-byte boundaries, each within half of PACK_SMEM_BYTES, and a tile of
// 32 rows is made one segment at a time: no column
// straddles a 16-byte boundary (each is aligned to its own width), so
// every segment owns whole columns and a run of the row's bytes, and
// stages only its own columns and the validity words of the columns whose
// bits its validity bytes hold. Tiles of 32 rows keep every staged
// validity word whole and every column run a multiple of 16 bytes; a
// smaller T would break both.
//
// Batches start at multiples of 32 rows, so a batch's column pointers are
// 32 x width-byte aligned and its validity is a pointer offset. A column
// pointer that is not 16-byte aligned (a view at another offset) is
// staged with byte loads instead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 227 * 1024;   // the most a block may take
constexpr int kSmPerSm = 228 * 1024;   // shared memory of one SM
constexpr int kSmPerBlockOverhead = 1024;

// The plan (int32): n_segs x 8 (c0, c1, lo, hi, vc0, vc1, vst, 0: the
// segment's columns, its bytes [lo, hi) of the row, the columns whose
// validity bits its validity bytes hold, and the staged offset of their
// validity words), then n_cols x 2 (staged offset | width << 24, the
// column's byte in the row).
struct Args {
  const int4* segs;
  const int2* cols;
  const long long* ptrs;  // column pointers, then validity pointers
  uint32_t* out;
  long long n_rows;
  int n_cols, row_bytes, n_segs, voff, tile_rows, n_tiles, buf_bytes;
  int img_stride;  // bytes between image rows: an odd multiple of 8
};

// A warp walks its columns (or units) c = first, first + kWarps, ... 32 at
// a time: lane j loads what the j-th of them needs in one load, and the
// walk takes it with __shfl_sync, where each load would otherwise wait on
// the one before (on the H100 that chain cost most at 104 columns).
constexpr unsigned kAll = 0xFFFFFFFFu;

__device__ __forceinline__ int batch_of(int first, int end) {
  const int n = (end - first + kWarps - 1) / kWarps;
  return n < 32 ? n : 32;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// what one item (a tile of rows, one segment of the row) covers
struct Item {
  long long r0;
  int rows;
  int4 seg;    // c0, c1, lo, hi
  int4 votes;  // vc0, vc1, staged offset of their validity words
};

__device__ __forceinline__ Item item_of(const Args& a, long long item) {
  Item it;
  const int seg = static_cast<int>(item / a.n_tiles);
  it.r0 = (item - static_cast<long long>(seg) * a.n_tiles) * a.tile_rows;
  const long long left = a.n_rows - it.r0;
  it.rows = left < a.tile_rows ? static_cast<int>(left) : a.tile_rows;
  it.seg = __ldg(a.segs + 2 * seg);
  it.votes = __ldg(a.segs + 2 * seg + 1);
  return it;
}

// Issue the loads of `item` into buffer `buf` (one cp.async group).
__device__ __forceinline__ void stage(const Args& a, long long item,
                                      unsigned char* buf, int lane,
                                      int warp) {
  const Item it = item_of(a, item);
  for (int cb = it.seg.x + warp; cb < it.seg.y; cb += 32 * kWarps) {
    const int cl = cb + lane * kWarps;
    const int info_l = cl < it.seg.y ? __ldg(a.cols + cl).x : 0;
    const long long ptr_l = cl < it.seg.y ? __ldg(a.ptrs + cl) : 0;
    for (int j = 0, n = batch_of(cb, it.seg.y); j < n; ++j) {
      const int info = __shfl_sync(kAll, info_l, j);
      const int width = info >> 24;
      unsigned char* dst = buf + (info & 0xFFFFFF);
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
                                     __shfl_sync(kAll, ptr_l, j)) +
                                 it.r0 * width;
      const int nbytes = it.rows * width;
      if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        for (int at = 16 * lane; at < nbytes; at += 16 * 32) {
          const int left = nbytes - at;
          cp_async16(dst + at, src + at, left < 16 ? left : 16);
        }
      } else {
        for (int at = lane; at < nbytes; at += 32) dst[at] = src[at];
      }
    }
  }
  const int nvc = it.votes.y - it.votes.x;
  const int groups = (it.rows + 31) >> 5;
  uint32_t* vst = reinterpret_cast<uint32_t*>(buf + it.votes.z);
  for (int cb = it.votes.x + warp; cb < it.votes.y; cb += 32 * kWarps) {
    const int cl = cb + lane * kWarps;
    const long long ptr_l = cl < it.votes.y ? __ldg(a.ptrs + a.n_cols + cl)
                                            : 0;
    for (int j = 0, n = batch_of(cb, it.votes.y); j < n; ++j) {
      const uint32_t* vp = reinterpret_cast<const uint32_t*>(
          __shfl_sync(kAll, ptr_l, j));
      if (lane < groups) {
        uint32_t* d = vst + lane * nvc + (cb + j * kWarps - it.votes.x);
        if (vp == nullptr) {
          *d = 0xFFFFFFFFu;
        } else {
          cp_async4(d, vp + (it.r0 >> 5) + lane);
        }
      }
    }
  }
  cp_async_commit();
}

// Write the rows of `item` from the staged buffer into the zeroed image:
// unit u < c1 - c0 is column c0 + u, a later one validity byte vb0 + ...;
// each unit goes 32 rows (lanes) at a time.
__device__ __forceinline__ void assemble(const Args& a, long long item,
                                         const unsigned char* buf,
                                         unsigned char* image, int lane,
                                         int warp) {
  const Item it = item_of(a, item);
  const int n_data = it.seg.y - it.seg.x;
  const int vb0 = it.votes.x >> 3;
  const int vb1 = (it.votes.y + 7) >> 3;
  const int nvc = it.votes.y - it.votes.x;
  const int units = n_data + (it.votes.y > it.votes.x ? vb1 - vb0 : 0);
  const uint32_t* vst = reinterpret_cast<const uint32_t*>(buf + it.votes.z);
  const int stride = a.img_stride;
  for (int ub = warp; ub < units; ub += 32 * kWarps) {
    const int ul = ub + lane * kWarps;
    const int2 col_l =
        ul < n_data ? __ldg(a.cols + it.seg.x + ul) : make_int2(0, 0);
    for (int j = 0, n = batch_of(ub, units); j < n; ++j) {
      const int u = ub + j * kWarps;  // the same in every lane
      if (u < n_data) {
        const int width = __shfl_sync(kAll, col_l.x, j) >> 24;
        const unsigned char* src =
            buf + (__shfl_sync(kAll, col_l.x, j) & 0xFFFFFF);
        unsigned char* dst = image + (__shfl_sync(kAll, col_l.y, j) -
                                      it.seg.z);
        for (int rl = lane; rl < it.rows; rl += 32) {
          unsigned char* d = dst + rl * stride;
          switch (width) {
            case 1: *d = src[rl]; break;
            case 2:
              *reinterpret_cast<uint16_t*>(d) =
                  reinterpret_cast<const uint16_t*>(src)[rl];
              break;
            case 4:
              *reinterpret_cast<uint32_t*>(d) =
                  reinterpret_cast<const uint32_t*>(src)[rl];
              break;
            default:
              *reinterpret_cast<uint2*>(d) =
                  reinterpret_cast<const uint2*>(src)[rl];
          }
        }
      } else {
        // validity byte b: bit i = column 8 b + i's bit of this row
        const int b = vb0 + u - n_data;
        const int c_end = 8 * b + 8 < it.votes.y ? 8 * b + 8 : it.votes.y;
        unsigned char* dst = image + (a.voff + b - it.seg.z);
        for (int g = 0; 32 * g < it.rows; ++g) {
          const uint32_t* words = vst + g * nvc + (8 * b - it.votes.x);
          uint32_t byte = 0;
          for (int i = 0; i < c_end - 8 * b; ++i) {
            byte |= ((words[i] >> lane) & 1u) << i;
          }
          if (32 * g + lane < it.rows) {
            dst[(32 * g + lane) * stride] = byte;
          }
        }
      }
    }
  }
}

// Copy the image of `item` to the output, zeroing it behind.
__device__ __forceinline__ void store(const Args& a, long long item,
                                      unsigned char* image, int lane,
                                      int warp) {
  const Item it = item_of(a, item);
  unsigned char* out = reinterpret_cast<unsigned char*>(a.out) +
                       it.r0 * a.row_bytes + it.seg.z;
  const int seg_bytes = it.seg.w - it.seg.z;
  if (a.img_stride == a.row_bytes) {
    // one segment, rows back to back: one 16-byte-aligned run of the
    // output (T x row bytes is a multiple of 16); rows x row bytes is a
    // multiple of 8
    const int bytes = it.rows * a.row_bytes;
    uint4* dst = reinterpret_cast<uint4*>(out);
    uint4* src = reinterpret_cast<uint4*>(image);
    for (int i = 32 * warp + lane; i < bytes / 16; i += kThreads) {
      dst[i] = src[i];
      src[i] = make_uint4(0, 0, 0, 0);
    }
    if ((bytes & 15) && warp == 0 && lane == 0) {
      uint2* s2 = reinterpret_cast<uint2*>(image + bytes - 8);
      *reinterpret_cast<uint2*>(out + bytes - 8) = *s2;
      *s2 = make_uint2(0, 0);
    }
  } else {
    // row by row: 8-byte aligned (rows are 8-byte multiples, segments
    // start at 16-byte boundaries)
    for (int rl = warp; rl < it.rows; rl += kWarps) {
      uint2* dst = reinterpret_cast<uint2*>(out +
                                            static_cast<long long>(rl) *
                                                a.row_bytes);
      uint2* src = reinterpret_cast<uint2*>(image + rl * a.img_stride);
      for (int j = lane; j < seg_bytes / 8; j += 32) {
        dst[j] = src[j];
        src[j] = make_uint2(0, 0);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    pack_rows_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned char* image = smem + 2 * a.buf_bytes;
  const long long items = static_cast<long long>(a.n_tiles) * a.n_segs;
  long long item = blockIdx.x;
  int b = 0;
  if (item < items) stage(a, item, smem, lane, warp);
  uint4* img4 = reinterpret_cast<uint4*>(image);
  for (int i = threadIdx.x; i < a.tile_rows * a.img_stride / 16;
       i += kThreads) {
    img4[i] = make_uint4(0, 0, 0, 0);
  }
  for (; item < items; item += gridDim.x, b ^= 1) {
    const long long next = item + gridDim.x;
    if (next < items) {
      stage(a, next, smem + (b ^ 1) * a.buf_bytes, lane, warp);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this item's tile is staged and the image zeroed
    assemble(a, item, smem + b * a.buf_bytes, image, lane, warp);
    __syncthreads();  // its image is complete
    store(a, item, image, lane, warp);
    // the next stage() writes the other buffer; the next assemble()
    // writes the image only after the next __syncthreads
  }
}

}  // namespace

// `plan` is the plan above and `ptrs` the n_cols column pointers, then the
// n_cols validity pointers (0 = all valid), both on the card. Returns the
// CUDA error of the launch (0 = success), or cudaErrorInvalidValue for a
// malformed plan.
extern "C" int srt_pack_rows(const int* plan, int n_cols, int row_bytes,
                             int n_segs, int voff, int tile_rows,
                             int buf_bytes, int img_stride,
                             const long long* ptrs, long long n_rows,
                             void* out, void* stream) {
  const long long smem =
      2LL * buf_bytes + static_cast<long long>(tile_rows) * img_stride;
  if (n_cols <= 0 || row_bytes <= 0 || row_bytes % 8 || n_segs <= 0 ||
      tile_rows < 32 || tile_rows > 256 || tile_rows % 32 ||
      (buf_bytes & 15) || img_stride % 16 != 8 || img_stride < 8 ||
      smem > kMaxSmem || ptrs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows <= 0) return 0;
  Args a;
  a.segs = reinterpret_cast<const int4*>(plan);
  a.cols = reinterpret_cast<const int2*>(plan + 8 * n_segs);
  a.ptrs = ptrs;
  a.out = static_cast<uint32_t*>(out);
  a.n_rows = n_rows;
  a.n_cols = n_cols;
  a.row_bytes = row_bytes;
  a.n_segs = n_segs;
  a.voff = voff;
  a.tile_rows = tile_rows;
  a.n_tiles = static_cast<int>((n_rows + tile_rows - 1) / tile_rows);
  a.buf_bytes = buf_bytes;
  a.img_stride = img_stride;
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
  const long long items = static_cast<long long>(a.n_tiles) * a.n_segs;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const long long blocks = items < resident ? items : resident;
  pack_rows_kernel<<<static_cast<unsigned int>(blocks), kThreads,
                     static_cast<int>(smem),
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
