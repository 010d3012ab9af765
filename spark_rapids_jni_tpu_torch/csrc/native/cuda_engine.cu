// The native library's device engine on the H100: the CUDA runtime in
// place of the reference's PJRT plugin (src/main/cpp/src/pjrt_engine.cpp),
// behind device_engine.hpp.
//
// The engine owns one stream, created on the runtime's primary context
// (so it shares the card with PyTorch in the same process), and a
// registry of device buffers by handle with in-flight counts: destroy()
// waits for the calls that use a buffer, as pjrt_engine.hpp:131-136
// does. One call runs on the stream at a time; each drains the stream
// before it returns, so a CUDA error (an out-of-memory error included)
// comes back from the call that caused it, with CUDA's text. Device
// memory is stream-ordered (cudaMallocAsync), outside PyTorch's caching
// allocator.
//
// The seven routes and their kernels (none replaces a TPU kernel but K4,
// K5 and K6, which are launched here through their C launchers):
//
// - murmur3: each float column's bits normalised first (Spark: -0.0 is
//   0.0, every NaN the canonical one; `normalize_floats`), then K4
//   (csrc/murmur3.cu `srt_murmur3_int32`) over each 4-byte column and K5
//   (`srt_murmur3_int64`) over each 8-byte column, the running hash the
//   next column's per-row seeds. Bytes bound each launch.
// - xxhash64: one hand kernel, one thread a row, chained over up to 32
//   columns a launch (normalising floats as it reads them). Bytes bound.
// - to_rows: K6 (csrc/pack_rows.cu `srt_pack_rows`) over the rows of one
//   batch, with the plan of pack_plan.hpp.
// - from_rows: a hand unpack kernel, one thread a row, each column's
//   value copied out of the row and its validity bit gathered into a word
//   a warp with a ballot (32 rows a warp, so a warp writes whole words).
//   Bytes bound; the rows are read with one load a column (L1 keeps a
//   warp's rows), the columns written coalesced.
// - sort_order: per-column key transforms (the sign bit flipped for
//   signed types, all bits for descending) gathered through the current
//   permutation, then CUB's stable radix sort (cuda_sort.cu), one pass a
//   column from the last to the first (LSD).
// - inner_join: the right keys sorted the same way, a binary-search probe
//   a left row (lexicographic over the transformed keys; a second equal
//   right key is the unique-right overflow), the matches compacted by a
//   hand scan, then put in the host route's order (key, then left row) by
//   the same stable sort.
// - groupby: the keys sorted with the row permutation, head flags a key
//   change, segment ids by the scan, and one thread a group walking its
//   rows in input order for the count, integral sums wrapping in int64,
//   float sums in float64 (the host route's order, so its bits), min, max
//   in Spark's float order and the mean; groups written in order of their
//   first row.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <map>
#include <memory>
#include <mutex>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

#include "device_engine.hpp"
#include "pack_plan.hpp"

// K4, K5 (csrc/murmur3.cu) and K6 (csrc/pack_rows.cu)
extern "C" int srt_murmur3_int32(const void* blocks, const void* seeds,
                                 void* out, long long n, void* stream);
extern "C" int srt_murmur3_int64(const void* values, const void* seeds,
                                 void* out, long long n, void* stream);
extern "C" int srt_pack_rows(const int* plan, int n_cols, int row_bytes,
                             int n_segs, int voff, int tile_rows,
                             int buf_bytes, int img_stride,
                             const long long* ptrs, long long n_rows,
                             void* out, void* stream);

namespace srt {
namespace native {
cudaError_t radix_sort_pairs(void* temp, size_t& temp_bytes,
                             const uint64_t* keys_in, uint64_t* keys_out,
                             const int32_t* rows_in, int32_t* rows_out,
                             int n, int end_bit, cudaStream_t stream);
}  // namespace native
}  // namespace srt

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;
constexpr int kMaxCols = 32;  // columns a launch of the multi-column kernels
constexpr unsigned kAll = 0xFFFFFFFFu;

unsigned int grid_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks
                                                               : b));
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

__global__ void fill_i32_kernel(int32_t* out, int32_t v, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    out[i] = v;
  }
}

__global__ void iota_kernel(int32_t* out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    out[i] = static_cast<int32_t>(i);
  }
}

// Spark's float normalisation (hashing.cpp f32_norm_bits / f64_norm_bits)
__device__ __forceinline__ uint32_t f32_norm(float f) {
  if (f != f) return 0x7FC00000u;
  return f == 0.0f ? 0u : __float_as_uint(f);
}

__device__ __forceinline__ uint64_t f64_norm(double d) {
  if (d != d) return 0x7FF8000000000000ull;
  return d == 0.0 ? 0ull : static_cast<uint64_t>(__double_as_longlong(d));
}

__global__ void normalize_f32_kernel(const float* in, uint32_t* out,
                                     long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    out[i] = f32_norm(in[i]);
  }
}

__global__ void normalize_f64_kernel(const double* in, uint64_t* out,
                                     long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    out[i] = f64_norm(in[i]);
  }
}

// -- xxhash64 (hashing.cpp xx_int / xx_long) ---------------------------------

constexpr uint64_t XP1 = 0x9E3779B185EBCA87ull;
constexpr uint64_t XP2 = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t XP3 = 0x165667B19E3779F9ull;
constexpr uint64_t XP4 = 0x85EBCA77C2B2AE63ull;
constexpr uint64_t XP5 = 0x27D4EB2F165667C5ull;

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t xx_fmix(uint64_t h) {
  h = (h ^ (h >> 33)) * XP2;
  h = (h ^ (h >> 29)) * XP3;
  return h ^ (h >> 32);
}

__device__ __forceinline__ uint64_t xx_long(uint64_t v, uint64_t seed) {
  uint64_t h = seed + XP5 + 8;
  h ^= rotl64(v * XP2, 31) * XP1;
  h = rotl64(h, 27) * XP1 + XP4;
  return xx_fmix(h);
}

__device__ __forceinline__ uint64_t xx_int(uint32_t v, uint64_t seed) {
  uint64_t h = seed + XP5 + 4;
  h ^= static_cast<uint64_t>(v) * XP1;
  h = rotl64(h, 23) * XP2 + XP3;
  return xx_fmix(h);
}

enum hash_kind : int { HK_INT4 = 0, HK_FLOAT4, HK_LONG8, HK_DOUBLE8 };

struct hash_cols {
  const void* ptr[kMaxCols];
  int kind[kMaxCols];
  int n;
};

// One thread a row; the running hash of each row seeds its next column.
// `running` holds the hash of the columns before this launch's (its
// first launch starts from `seed`); it may be `out` itself.
__global__ void xxhash64_kernel(hash_cols c, const int64_t* running,
                                int64_t seed, int64_t* out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    uint64_t h = static_cast<uint64_t>(running ? running[i] : seed);
    for (int j = 0; j < c.n; ++j) {
      switch (c.kind[j]) {
        case HK_INT4:
          h = xx_int(static_cast<const uint32_t*>(c.ptr[j])[i], h);
          break;
        case HK_FLOAT4:
          h = xx_int(f32_norm(static_cast<const float*>(c.ptr[j])[i]), h);
          break;
        case HK_LONG8:
          h = xx_long(static_cast<const uint64_t*>(c.ptr[j])[i], h);
          break;
        default:
          h = xx_long(f64_norm(static_cast<const double*>(c.ptr[j])[i]), h);
      }
    }
    out[i] = static_cast<int64_t>(h);
  }
}

// -- from_rows ----------------------------------------------------------------

struct unpack_cols {
  void* data[kMaxCols];
  uint32_t* valid[kMaxCols];
  int start[kMaxCols];
  int width[kMaxCols];
  int index[kMaxCols];  // the column's place in the schema (validity bit)
  int n;
};

// A warp takes 32 consecutive rows (one validity word of each column),
// lane = row: each column's value is copied out of the lane's row, and
// its validity bit joins the warp's ballot, which lane 0 stores.
__global__ void unpack_rows_kernel(const uint8_t* rows, int spr, int voff,
                                   long long n, unpack_cols c) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x +
                        (threadIdx.x & ~31);
       base < n; base += stride) {
    const long long r = base + lane;
    const bool in = r < n;
    const uint8_t* row = rows + (in ? r : 0) * static_cast<long long>(spr);
    for (int j = 0; j < c.n; ++j) {
      bool valid = false;
      if (in) {
        const uint8_t* src = row + c.start[j];
        switch (c.width[j]) {
          case 1:
            static_cast<uint8_t*>(c.data[j])[r] = *src;
            break;
          case 2:
            static_cast<uint16_t*>(c.data[j])[r] =
                *reinterpret_cast<const uint16_t*>(src);
            break;
          case 4:
            static_cast<uint32_t*>(c.data[j])[r] =
                *reinterpret_cast<const uint32_t*>(src);
            break;
          default:
            static_cast<uint64_t*>(c.data[j])[r] =
                *reinterpret_cast<const uint64_t*>(src);
        }
        valid = (row[voff + c.index[j] / 8] >> (c.index[j] % 8)) & 1;
      }
      const unsigned word = __ballot_sync(kAll, valid);
      if (lane == 0) c.valid[j][base >> 5] = word;
    }
  }
}

// -- keys ---------------------------------------------------------------------

// A key's order-preserving unsigned form: the sign bit flipped for signed
// types; every bit of its width flipped for a descending column.
__device__ __forceinline__ uint64_t key_bits(const void* col, int width,
                                             int is_signed, int desc,
                                             long long r) {
  uint64_t u;
  if (width == 4) {
    uint32_t v = static_cast<const uint32_t*>(col)[r];
    if (is_signed) v ^= 0x80000000u;
    if (desc) v = ~v;
    u = v;
  } else {
    u = static_cast<const uint64_t*>(col)[r];
    if (is_signed) u ^= 0x8000000000000000ull;
    if (desc) u = ~u;
  }
  return u;
}

// out[i] = key of row perm[i] (row i without perm)
__global__ void sort_keys_kernel(const void* col, int width, int is_signed,
                                 int desc, const int32_t* perm,
                                 uint64_t* out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    out[i] = key_bits(col, width, is_signed, desc, perm ? perm[i] : i);
  }
}

// flag[i] = 1 where sorted position i starts a new key (over the key
// columns seen so far: the first launch sets, later ones OR)
__global__ void head_flags_kernel(const uint64_t* sk, int32_t* flag,
                                  long long n, int first) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const int change = i == 0 || sk[i] != sk[i - 1];
    flag[i] = first ? change : (flag[i] | change);
  }
}

// -- scan: exclusive prefix sums of int32 flags, three launches ---------------

constexpr int kScanThreads = 512;
constexpr int kScanItems = 8;
constexpr int kScanTile = kScanThreads * kScanItems;

// Exclusive scan of one value a thread across the block; *total gets the
// block's sum.
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kAll, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();  // warp_sums may still be read by a previous call
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kScanThreads / 32 ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kAll, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kScanThreads / 32) warp_sums[lane] = w;
  }
  __syncthreads();
  *total = warp_sums[kScanThreads / 32 - 1];
  return (warp ? warp_sums[warp - 1] : 0) + x - v;
}

// Scans `n` values from `base` of in into out (exclusive, from `carry`);
// returns the sum of those values. Thread t takes kScanItems in a row.
__device__ int scan_tile(const int32_t* in, int32_t* out, long long base,
                         long long n, int carry) {
  int vals[kScanItems];
  int sum = 0;
  const long long first = base + static_cast<long long>(threadIdx.x) *
                                     kScanItems;
  for (int j = 0; j < kScanItems; ++j) {
    vals[j] = first + j < n ? in[first + j] : 0;
    sum += vals[j];
  }
  int total;
  int run = carry + block_exclusive_scan(sum, &total);
  for (int j = 0; j < kScanItems; ++j) {
    if (first + j < n) out[first + j] = run;
    run += vals[j];
  }
  return total;
}

__global__ void __launch_bounds__(kScanThreads)
    scan_tiles_kernel(const int32_t* in, int32_t* out, int32_t* tile_sums,
                      long long n) {
  const long long base = static_cast<long long>(blockIdx.x) * kScanTile;
  const int total = scan_tile(in, out, base, n, 0);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// one block: scans the tile sums in place, writes the grand total
__global__ void __launch_bounds__(kScanThreads)
    scan_tile_sums_kernel(int32_t* sums, long long m, int32_t* total) {
  int carry = 0;
  for (long long base = 0; base < m; base += kScanTile) {
    carry += scan_tile(sums, sums, base, m, carry);
  }
  if (threadIdx.x == 0) *total = carry;
}

__global__ void add_tile_offsets_kernel(int32_t* out,
                                        const int32_t* tile_sums,
                                        long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    out[i] += tile_sums[i / kScanTile];
  }
}

// -- join ---------------------------------------------------------------------

struct key_cols {
  const void* ptr[kMaxCols];
  int width[kMaxCols];
  int is_signed[kMaxCols];
  int n;
};

struct sorted_keys {
  const uint64_t* ptr[kMaxCols];  // right keys' transformed bits, sorted
};

// sign of (sorted row m) - (left key tuple)
__device__ __forceinline__ int cmp_sorted(const sorted_keys& s, int k,
                                          long long m, const uint64_t* key) {
  for (int c = 0; c < k; ++c) {
    const uint64_t v = s.ptr[c][m];
    if (v != key[c]) return v < key[c] ? -1 : 1;
  }
  return 0;
}

// One thread a left row: lower bound of its key among the sorted right
// keys; a match records the right row, a second equal right key the
// overflow of the unique-right contract.
__global__ void join_probe_kernel(key_cols left, sorted_keys right,
                                  const int32_t* right_perm, long long nl,
                                  long long nr, int32_t* match,
                                  int32_t* flag, int32_t* overflow) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  uint64_t key[kMaxCols];
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < nl; i += stride) {
    for (int c = 0; c < left.n; ++c) {
      key[c] = key_bits(left.ptr[c], left.width[c], left.is_signed[c], 0, i);
    }
    long long lo = 0, hi = nr;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (cmp_sorted(right, left.n, mid, key) < 0) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const bool hit = lo < nr && cmp_sorted(right, left.n, lo, key) == 0;
    if (hit && lo + 1 < nr && cmp_sorted(right, left.n, lo + 1, key) == 0) {
      atomicExch(overflow, 1);
    }
    match[i] = hit ? right_perm[lo] : -1;
    flag[i] = hit ? 1 : 0;
  }
}

// out[pos[i]] = i where flag[i]
__global__ void compact_kernel(const int32_t* flag, const int32_t* pos,
                               int32_t* out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    if (flag[i]) out[pos[i]] = static_cast<int32_t>(i);
  }
}

// out[j] = src[idx[j]]
__global__ void gather_kernel(const int32_t* src, const int32_t* idx,
                              int32_t* out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    out[i] = src[idx[i]];
  }
}

// -- groupby ------------------------------------------------------------------

// starts[pos[i]] = i at each head; starts[groups] = n
__global__ void group_starts_kernel(const int32_t* flag, const int32_t* pos,
                                    int32_t* starts, long long n,
                                    int32_t groups) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    if (flag[i]) starts[pos[i]] = static_cast<int32_t>(i);
    if (i == 0) starts[groups] = static_cast<int32_t>(n);
  }
}

// rep[g] = the group's first row (the stable sort keeps its rows in input
// order); mark[rep[g]] = 1, whose scan ranks the groups by first row
__global__ void group_reps_kernel(const int32_t* perm, const int32_t* starts,
                                  int32_t* rep, int32_t* mark,
                                  long long groups) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < groups; g += stride) {
    const int32_t r = perm[starts[g]];
    rep[g] = r;
    mark[r] = 1;
  }
}

__global__ void group_meta_kernel(const int32_t* rep, const int32_t* rank,
                                  const int32_t* starts, int32_t* rep_out,
                                  int64_t* sizes, long long groups) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < groups; g += stride) {
    const int32_t o = rank[rep[g]];
    rep_out[o] = rep[g];
    sizes[o] = starts[g + 1] - starts[g];
  }
}

enum value_kind : int { VK_I32 = 0, VK_I64, VK_F32, VK_F64 };

// Spark float order (relational.cpp cmp_float): NaN greatest, NaNs equal
__device__ __forceinline__ int cmp_float(double a, double b) {
  const bool na = a != a, nb = b != b;
  if (na && nb) return 0;
  if (na) return 1;
  if (nb) return -1;
  if (a < b) return -1;
  return b < a ? 1 : 0;
}

// One thread a group, its rows in input order (the host route's loop in
// relational.cpp groupby_sum_count, so float sums keep its bits); the
// group's results go to slot rank[rep[g]], its place by first row.
__global__ void group_aggregate_kernel(const void* values, int kind,
                                       const int32_t* perm,
                                       const int32_t* starts,
                                       const int32_t* rep,
                                       const int32_t* rank, long long groups,
                                       int64_t* sums, int64_t* mins,
                                       int64_t* maxs, double* means) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < groups; g += stride) {
    const int32_t s = starts[g], e = starts[g + 1];
    const int32_t o = rank[rep[g]];
    double dsum = 0.0;
    if (kind == VK_F32 || kind == VK_F64) {
      double fsum = 0.0, fmin = 0.0, fmax = 0.0;
      for (int32_t k = s; k < e; ++k) {
        const int32_t r = perm[k];
        const double x =
            kind == VK_F32
                ? static_cast<double>(static_cast<const float*>(values)[r])
                : static_cast<const double*>(values)[r];
        fsum += x;
        dsum += x;
        if (k == s) {
          fmin = fmax = x;
        } else {
          if (cmp_float(x, fmin) < 0) fmin = x;
          if (cmp_float(x, fmax) > 0) fmax = x;
        }
      }
      sums[o] = __double_as_longlong(fsum);
      mins[o] = __double_as_longlong(fmin);
      maxs[o] = __double_as_longlong(fmax);
    } else {
      uint64_t isum = 0;
      int64_t imin = 0, imax = 0;
      for (int32_t k = s; k < e; ++k) {
        const int32_t r = perm[k];
        const int64_t x = kind == VK_I32
                              ? static_cast<const int32_t*>(values)[r]
                              : static_cast<const int64_t*>(values)[r];
        isum += static_cast<uint64_t>(x);  // int64 wrap: Spark long sum
        dsum += static_cast<double>(x);
        if (k == s) {
          imin = imax = x;
        } else {
          imin = x < imin ? x : imin;
          imax = x > imax ? x : imax;
        }
      }
      sums[o] = static_cast<int64_t>(isum);
      mins[o] = imin;
      maxs[o] = imax;
    }
    means[o] = dsum / static_cast<double>(e - s);
  }
}

// ---------------------------------------------------------------------------
// Engine state
// ---------------------------------------------------------------------------

thread_local std::string t_error;

struct engine_state {
  std::mutex mu;  // buffers, uses, launches
  std::condition_variable cv;
  std::map<int64_t, std::pair<void*, size_t>> buffers;
  std::map<int64_t, int> uses;  // buffer -> calls using it
  std::map<std::string, int64_t> launches;
  int64_t next = 1;
  std::mutex exec_mu;  // one call on the stream at a time
  std::mutex init_mu;
  cudaStream_t stream = nullptr;
  int device = -1;
  std::atomic<bool> up{false};
};

engine_state& E() {
  static engine_state e;
  return e;
}

[[noreturn]] void fail(const std::string& what) {
  throw std::runtime_error(what);
}

void ck(cudaError_t err, const char* what) {
  if (err != cudaSuccess) {
    fail(std::string("CUDA error in ") + what + ": " +
         cudaGetErrorName(err) + ": " + cudaGetErrorString(err));
  }
}

// A launch just made: count it, and raise what the launch returned.
void launched(const char* name, int n = 1) {
  ck(cudaGetLastError(), name);
  std::lock_guard<std::mutex> lk(E().mu);
  E().launches[name] += n;
}

// Stream-ordered device memory freed with its scope unless kept.
struct dmem {
  void* p = nullptr;
  size_t bytes = 0;
  explicit dmem(size_t n) : bytes(n) {
    if (n == 0) return;
    cudaError_t err = cudaMallocAsync(&p, n, E().stream);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the next call must not see it
      fail("CUDA error in cudaMallocAsync of " + std::to_string(n) +
           " bytes: " + cudaGetErrorName(err) + ": " +
           cudaGetErrorString(err));
    }
  }
  dmem(const dmem&) = delete;
  dmem& operator=(const dmem&) = delete;
  ~dmem() {
    if (p != nullptr) cudaFreeAsync(p, E().stream);
  }
  template <typename T>
  T* as() const {
    return static_cast<T*>(p);
  }
  // hands the allocation to the registry: its handle
  int64_t keep() {
    std::lock_guard<std::mutex> lk(E().mu);
    const int64_t h = E().next++;
    E().buffers[h] = {p, bytes};
    p = nullptr;
    return h;
  }
};

// The buffers a call reads, held against destroy() until it ends.
struct lease {
  std::vector<int64_t> hs;
  explicit lease(std::vector<int64_t> handles) : hs(std::move(handles)) {
    std::lock_guard<std::mutex> lk(E().mu);
    for (int64_t h : hs) {
      if (!E().buffers.count(h)) {
        fail("unknown device buffer handle " + std::to_string(h));
      }
    }
    for (int64_t h : hs) ++E().uses[h];
  }
  ~lease() {
    std::lock_guard<std::mutex> lk(E().mu);
    for (int64_t h : hs) {
      if (--E().uses[h] == 0) E().uses.erase(h);
    }
    E().cv.notify_all();
  }
  static std::pair<void*, size_t> at(int64_t h) {
    std::lock_guard<std::mutex> lk(E().mu);
    return E().buffers.at(h);
  }
};

// Runs one engine call: the stream's lock, the device made current on
// this thread, the stream drained at the end (so the call's CUDA errors
// are its own). Returns false with the error on this thread.
template <typename F>
bool call(F&& f) {
  if (!E().up) {
    t_error = "CUDA engine not initialized";
    return false;
  }
  try {
    std::lock_guard<std::mutex> lk(E().exec_mu);
    ck(cudaSetDevice(E().device), "cudaSetDevice");
    try {
      f();
    } catch (...) {
      cudaStreamSynchronize(E().stream);  // let the freed scratch go
      throw;
    }
    ck(cudaStreamSynchronize(E().stream), "the engine's stream");
    return true;
  } catch (const std::exception& e) {
    t_error = e.what();
    return false;
  }
}

std::vector<int64_t> handles_of(const std::vector<srt::dev::column>& cols) {
  std::vector<int64_t> hs;
  for (const auto& c : cols) hs.push_back(c.buf);
  return hs;
}

const void* ptr_of(const srt::dev::column& c) { return lease::at(c.buf).first; }

bool is_float4(srt::type_id id) { return id == srt::type_id::FLOAT32; }
bool is_float8(srt::type_id id) { return id == srt::type_id::FLOAT64; }
bool is_unsigned(srt::type_id id) {
  return id == srt::type_id::UINT32 || id == srt::type_id::UINT64;
}

// -- scans and sorts (run inside call()) -------------------------------------

// Exclusive scan of n int32 flags into out; returns their sum.
int32_t exclusive_scan(const int32_t* flags, int32_t* out, long long n) {
  const long long tiles = (n + kScanTile - 1) / kScanTile;
  dmem sums(static_cast<size_t>(tiles) * 4), total(4);
  scan_tiles_kernel<<<static_cast<unsigned>(tiles), kScanThreads, 0,
                      E().stream>>>(flags, out, sums.as<int32_t>(), n);
  launched("scan");
  scan_tile_sums_kernel<<<1, kScanThreads, 0, E().stream>>>(
      sums.as<int32_t>(), tiles, total.as<int32_t>());
  launched("scan");
  add_tile_offsets_kernel<<<grid_for(n), kThreads, 0, E().stream>>>(
      out, sums.as<int32_t>(), n);
  launched("scan");
  int32_t host = 0;
  ck(cudaMemcpyAsync(&host, total.p, 4, cudaMemcpyDeviceToHost, E().stream),
     "scan total");
  ck(cudaStreamSynchronize(E().stream), "scan total");
  return host;
}

struct sort_key {
  const void* ptr;
  int width;
  int is_signed;
  int desc;
};

sort_key key_of(const srt::dev::column& c, bool desc) {
  return {ptr_of(c), srt::size_of(c.dtype.id),
          is_unsigned(c.dtype.id) ? 0 : 1, desc ? 1 : 0};
}

// Stable LSD sort: permutes `perm` (n rows, device) by the keys, the last
// column first, one stable radix pass a column.
void lsd_sort(const std::vector<sort_key>& keys, int32_t* perm, long long n) {
  if (n <= 1) return;
  dmem kin(n * 8), kout(n * 8), other(n * 4);
  size_t temp_bytes = 0;
  ck(srt::native::radix_sort_pairs(nullptr, temp_bytes, nullptr, nullptr,
                                   nullptr, nullptr, static_cast<int>(n), 64,
                                   E().stream),
     "radix sort (size query)");
  dmem temp(temp_bytes);
  int32_t* cur = perm;
  int32_t* next = other.as<int32_t>();
  for (size_t i = keys.size(); i-- > 0;) {
    const sort_key& k = keys[i];
    sort_keys_kernel<<<grid_for(n), kThreads, 0, E().stream>>>(
        k.ptr, k.width, k.is_signed, k.desc, cur, kin.as<uint64_t>(), n);
    launched("sort_keys");
    ck(srt::native::radix_sort_pairs(temp.p, temp_bytes, kin.as<uint64_t>(),
                                     kout.as<uint64_t>(), cur, next,
                                     static_cast<int>(n), 8 * k.width,
                                     E().stream),
       "radix sort");
    launched("radix_sort");
    std::swap(cur, next);
  }
  if (cur != perm) {
    ck(cudaMemcpyAsync(perm, cur, n * 4, cudaMemcpyDeviceToDevice,
                       E().stream),
       "sort permutation");
  }
}

template <typename T>
std::vector<T> fetch(const void* p, long long n) {
  std::vector<T> out(static_cast<size_t>(n));
  if (n > 0) {
    ck(cudaMemcpyAsync(out.data(), p, n * sizeof(T), cudaMemcpyDeviceToHost,
                       E().stream),
       "device to host copy");
  }
  return out;
}

}  // namespace

namespace srt {
namespace dev {

// -- engine ------------------------------------------------------------------

bool init(int32_t device) {
  auto& e = E();
  std::lock_guard<std::mutex> lk(e.init_mu);
  if (e.up) {
    if (e.device == device) return true;
    t_error = "CUDA engine already started on device " +
              std::to_string(e.device);
    return false;
  }
  try {
    int count = 0;
    ck(cudaGetDeviceCount(&count), "cudaGetDeviceCount");
    if (device < 0 || device >= count) {
      fail("CUDA device " + std::to_string(device) + " does not exist (" +
           std::to_string(count) + " visible)");
    }
    ck(cudaSetDevice(device), "cudaSetDevice");
    ck(cudaFree(nullptr), "context creation");
    ck(cudaStreamCreateWithFlags(&e.stream, cudaStreamNonBlocking),
       "cudaStreamCreate");
    e.device = device;
    e.up = true;
    return true;
  } catch (const std::exception& ex) {
    t_error = ex.what();
    return false;
  }
}

bool available() { return E().up; }

int32_t device_count() {
  int count = 0;
  if (cudaGetDeviceCount(&count) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return count;
}

std::string platform_name() {
  if (!E().up) return "";
  cudaDeviceProp prop;
  if (cudaGetDeviceProperties(&prop, E().device) != cudaSuccess) return "cuda";
  return std::string("cuda: ") + prop.name + " (sm_" +
         std::to_string(prop.major) + std::to_string(prop.minor) + ")";
}

std::string last_error() { return t_error; }

// -- buffers -----------------------------------------------------------------

int64_t upload(const void* src, std::size_t bytes) {
  int64_t h = 0;
  call([&] {
    dmem m(bytes);
    if (bytes) {
      ck(cudaMemcpyAsync(m.p, src, bytes, cudaMemcpyHostToDevice, E().stream),
         "host to device copy");
    }
    ck(cudaStreamSynchronize(E().stream), "host to device copy");
    h = m.keep();
  });
  return h;
}

bool download(int64_t buf, void* dst, std::size_t capacity) {
  return call([&] {
    lease l({buf});
    auto b = lease::at(buf);
    if (capacity < b.second) {
      fail("destination of " + std::to_string(capacity) +
           " bytes is smaller than the buffer's " + std::to_string(b.second));
    }
    if (b.second) {
      ck(cudaMemcpyAsync(dst, b.first, b.second, cudaMemcpyDeviceToHost,
                         E().stream),
         "device to host copy");
    }
    ck(cudaStreamSynchronize(E().stream), "device to host copy");
  });
}

int64_t buffer_bytes(int64_t buf) {
  std::lock_guard<std::mutex> lk(E().mu);
  auto it = E().buffers.find(buf);
  return it == E().buffers.end() ? -1 : static_cast<int64_t>(it->second.second);
}

void destroy(int64_t buf) {
  auto& e = E();
  void* p = nullptr;
  {
    std::unique_lock<std::mutex> lk(e.mu);
    e.cv.wait(lk, [&] { return !e.uses.count(buf); });
    auto it = e.buffers.find(buf);
    if (it == e.buffers.end()) return;
    p = it->second.first;
    e.buffers.erase(it);
  }
  if (p != nullptr) {
    std::lock_guard<std::mutex> lk(e.exec_mu);
    cudaSetDevice(e.device);
    cudaFreeAsync(p, e.stream);
    cudaStreamSynchronize(e.stream);
  }
}

int64_t live_buffers() {
  std::lock_guard<std::mutex> lk(E().mu);
  return static_cast<int64_t>(E().buffers.size());
}

// -- kernels -----------------------------------------------------------------

int64_t murmur3(const std::vector<column>& cols, int32_t n, int32_t seed) {
  int64_t h = 0;
  call([&] {
    lease l(handles_of(cols));
    const long long rows = n;
    dmem a(rows * 4), b(rows * 4), norm(rows * 8);
    fill_i32_kernel<<<grid_for(rows), kThreads, 0, E().stream>>>(
        a.as<int32_t>(), seed, rows);
    launched("fill");
    dmem* cur = &a;
    dmem* next = &b;
    for (const auto& c : cols) {
      const void* blocks = ptr_of(c);
      const int width = srt::size_of(c.dtype.id);
      if (is_float4(c.dtype.id)) {
        normalize_f32_kernel<<<grid_for(rows), kThreads, 0, E().stream>>>(
            static_cast<const float*>(blocks), norm.as<uint32_t>(), rows);
        launched("normalize_floats");
        blocks = norm.p;
      } else if (is_float8(c.dtype.id)) {
        normalize_f64_kernel<<<grid_for(rows), kThreads, 0, E().stream>>>(
            static_cast<const double*>(blocks), norm.as<uint64_t>(), rows);
        launched("normalize_floats");
        blocks = norm.p;
      }
      const bool four = width == 4;
      const int rc = (four ? srt_murmur3_int32 : srt_murmur3_int64)(
          blocks, cur->p, next->p, rows, E().stream);
      ck(static_cast<cudaError_t>(rc),
         four ? "murmur3_int32 (K4)" : "murmur3_int64 (K5)");
      launched(four ? "murmur3_int32" : "murmur3_int64");
      std::swap(cur, next);
    }
    h = cur->keep();
  });
  return h;
}

int64_t xxhash64(const std::vector<column>& cols, int32_t n, int64_t seed) {
  int64_t h = 0;
  call([&] {
    lease l(handles_of(cols));
    const long long rows = n;
    dmem out(rows * 8);
    for (size_t c0 = 0; c0 < cols.size(); c0 += kMaxCols) {
      hash_cols set{};
      set.n = static_cast<int>(std::min<size_t>(kMaxCols, cols.size() - c0));
      for (int j = 0; j < set.n; ++j) {
        const column& c = cols[c0 + j];
        set.ptr[j] = ptr_of(c);
        const bool four = srt::size_of(c.dtype.id) == 4;
        set.kind[j] = is_float4(c.dtype.id)   ? HK_FLOAT4
                      : is_float8(c.dtype.id) ? HK_DOUBLE8
                      : four                  ? HK_INT4
                                              : HK_LONG8;
      }
      xxhash64_kernel<<<grid_for(rows), kThreads, 0, E().stream>>>(
          set, c0 == 0 ? nullptr : out.as<int64_t>(), seed,
          out.as<int64_t>(), rows);
      launched("xxhash64");
    }
    h = out.keep();
  });
  return h;
}

int64_t to_rows(const std::vector<column>& cols, int32_t row0,
                int32_t count) {
  int64_t h = 0;
  call([&] {
    lease l(handles_of(cols));
    std::vector<int> widths;
    for (const auto& c : cols) widths.push_back(srt::size_of(c.dtype.id));
    const auto plan = srt::native::make_pack_plan(widths);
    const auto words = plan.words();
    const int k = static_cast<int>(cols.size());
    std::vector<long long> ptrs(2 * k, 0);  // validity pointers 0: all valid
    for (int j = 0; j < k; ++j) {
      ptrs[j] = reinterpret_cast<long long>(
          static_cast<const uint8_t*>(ptr_of(cols[j])) +
          static_cast<size_t>(row0) * widths[j]);
    }
    dmem plan_d(words.size() * 4), ptrs_d(ptrs.size() * 8);
    ck(cudaMemcpyAsync(plan_d.p, words.data(), words.size() * 4,
                       cudaMemcpyHostToDevice, E().stream),
       "K6 plan upload");
    ck(cudaMemcpyAsync(ptrs_d.p, ptrs.data(), ptrs.size() * 8,
                       cudaMemcpyHostToDevice, E().stream),
       "K6 pointer upload");
    dmem out(static_cast<size_t>(count) * plan.size_per_row);
    const int rc = srt_pack_rows(
        plan_d.as<int>(), k, plan.size_per_row,
        static_cast<int>(plan.segments.size()), plan.validity_offset,
        plan.tile_rows, plan.buf_bytes, plan.img_stride,
        ptrs_d.as<long long>(), count, out.p, E().stream);
    ck(static_cast<cudaError_t>(rc), "pack_rows (K6)");
    launched("pack_rows");
    // the host copies above read pageable vectors: drain before they go
    ck(cudaStreamSynchronize(E().stream), "pack_rows (K6)");
    h = out.keep();
  });
  return h;
}

bool from_rows(int64_t rows, std::size_t offset, int32_t n,
               const std::vector<data_type>& schema,
               std::vector<int64_t>* out) {
  std::vector<int64_t> made;
  bool ok = call([&] {
    lease l({rows});
    const auto* base = static_cast<const uint8_t*>(lease::at(rows).first) +
                       offset;
    std::vector<int32_t> starts, sizes;
    int32_t at = 0;
    for (const auto& d : schema) {
      const int32_t w = srt::size_of(d.id);
      at = (at + w - 1) & ~(w - 1);
      starts.push_back(at);
      sizes.push_back(w);
      at += w;
    }
    const int32_t voff = at;
    const int32_t nc = static_cast<int32_t>(schema.size());
    const int32_t spr = (at + (nc + 7) / 8 + 7) & ~7;
    const long long words = (static_cast<long long>(n) + 31) / 32;
    std::vector<std::unique_ptr<dmem>> data, valid;
    for (int32_t j = 0; j < nc; ++j) {
      data.push_back(std::make_unique<dmem>(static_cast<size_t>(n) * sizes[j]));
      valid.push_back(std::make_unique<dmem>(words * 4));
    }
    for (int32_t c0 = 0; c0 < nc; c0 += kMaxCols) {
      unpack_cols set{};
      set.n = std::min(kMaxCols, nc - c0);
      for (int j = 0; j < set.n; ++j) {
        set.data[j] = data[c0 + j]->p;
        set.valid[j] = valid[c0 + j]->as<uint32_t>();
        set.start[j] = starts[c0 + j];
        set.width[j] = sizes[c0 + j];
        set.index[j] = c0 + j;
      }
      unpack_rows_kernel<<<grid_for(n), kThreads, 0, E().stream>>>(
          base, spr, voff, n, set);
      launched("unpack_rows");
    }
    ck(cudaStreamSynchronize(E().stream), "unpack_rows");
    for (auto& d : data) made.push_back(d->keep());
    for (auto& v : valid) made.push_back(v->keep());
  });
  if (ok) *out = std::move(made);
  return ok;
}

int64_t sort_order(const std::vector<column>& keys, int32_t n,
                   const std::vector<uint8_t>& ascending) {
  int64_t h = 0;
  call([&] {
    lease l(handles_of(keys));
    dmem perm(static_cast<size_t>(n) * 4);
    iota_kernel<<<grid_for(n), kThreads, 0, E().stream>>>(perm.as<int32_t>(),
                                                          n);
    launched("iota");
    std::vector<sort_key> ks;
    for (size_t c = 0; c < keys.size(); ++c) {
      ks.push_back(key_of(keys[c], !ascending.empty() && !ascending[c]));
    }
    lsd_sort(ks, perm.as<int32_t>(), n);
    h = perm.keep();
  });
  return h;
}

bool inner_join(const std::vector<column>& left, int32_t nl,
                const std::vector<column>& right, int32_t nr,
                join_result* out) {
  join_result r;
  bool ok = call([&] {
    std::vector<int64_t> hs = handles_of(left);
    for (int64_t x : handles_of(right)) hs.push_back(x);
    lease l(hs);
    const int k = static_cast<int>(left.size());
    // the right keys sorted, and their transformed bits in that order
    dmem rperm(static_cast<size_t>(nr) * 4);
    iota_kernel<<<grid_for(nr), kThreads, 0, E().stream>>>(
        rperm.as<int32_t>(), nr);
    launched("iota");
    std::vector<sort_key> rk, lk;
    for (int c = 0; c < k; ++c) {
      rk.push_back(key_of(right[c], false));
      lk.push_back(key_of(left[c], false));
    }
    lsd_sort(rk, rperm.as<int32_t>(), nr);
    std::vector<std::unique_ptr<dmem>> sorted;
    sorted_keys sk{};
    key_cols lc{};
    lc.n = k;
    for (int c = 0; c < k; ++c) {
      sorted.push_back(std::make_unique<dmem>(static_cast<size_t>(nr) * 8));
      sort_keys_kernel<<<grid_for(nr), kThreads, 0, E().stream>>>(
          rk[c].ptr, rk[c].width, rk[c].is_signed, 0, rperm.as<int32_t>(),
          sorted.back()->as<uint64_t>(), nr);
      launched("sort_keys");
      sk.ptr[c] = sorted.back()->as<uint64_t>();
      lc.ptr[c] = lk[c].ptr;
      lc.width[c] = lk[c].width;
      lc.is_signed[c] = lk[c].is_signed;
    }
    dmem match(static_cast<size_t>(nl) * 4), flag(static_cast<size_t>(nl) * 4),
        pos(static_cast<size_t>(nl) * 4), overflow(4);
    ck(cudaMemsetAsync(overflow.p, 0, 4, E().stream), "overflow flag");
    join_probe_kernel<<<grid_for(nl), kThreads, 0, E().stream>>>(
        lc, sk, rperm.as<int32_t>(), nl, nr, match.as<int32_t>(),
        flag.as<int32_t>(), overflow.as<int32_t>());
    launched("join_probe");
    int32_t over = 0;
    ck(cudaMemcpyAsync(&over, overflow.p, 4, cudaMemcpyDeviceToHost,
                       E().stream),
       "overflow flag");
    ck(cudaStreamSynchronize(E().stream), "join_probe");
    if (over) {
      r.overflow = true;
      return;
    }
    const int32_t count =
        exclusive_scan(flag.as<int32_t>(), pos.as<int32_t>(), nl);
    if (count == 0) return;
    dmem lidx(static_cast<size_t>(count) * 4), ridx(static_cast<size_t>(count) * 4);
    compact_kernel<<<grid_for(nl), kThreads, 0, E().stream>>>(
        flag.as<int32_t>(), pos.as<int32_t>(), lidx.as<int32_t>(), nl);
    launched("compact");
    // the host route's order: by key, left rows ascending within a key
    lsd_sort(lk, lidx.as<int32_t>(), count);
    gather_kernel<<<grid_for(count), kThreads, 0, E().stream>>>(
        match.as<int32_t>(), lidx.as<int32_t>(), ridx.as<int32_t>(), count);
    launched("gather");
    r.left = fetch<int32_t>(lidx.p, count);
    r.right = fetch<int32_t>(ridx.p, count);
  });
  if (ok) *out = std::move(r);
  return ok;
}

bool groupby(const std::vector<column>& keys,
             const std::vector<column>& values, int32_t n,
             groupby_result* out) {
  groupby_result g;
  bool ok = call([&] {
    std::vector<int64_t> hs = handles_of(keys);
    for (int64_t x : handles_of(values)) hs.push_back(x);
    lease l(hs);
    const long long rows = n;
    dmem perm(rows * 4), flag(rows * 4), pos(rows * 4), sk(rows * 8);
    iota_kernel<<<grid_for(rows), kThreads, 0, E().stream>>>(
        perm.as<int32_t>(), rows);
    launched("iota");
    std::vector<sort_key> ks;
    for (const auto& c : keys) ks.push_back(key_of(c, false));
    lsd_sort(ks, perm.as<int32_t>(), rows);
    for (size_t c = 0; c < ks.size(); ++c) {
      sort_keys_kernel<<<grid_for(rows), kThreads, 0, E().stream>>>(
          ks[c].ptr, ks[c].width, ks[c].is_signed, 0, perm.as<int32_t>(),
          sk.as<uint64_t>(), rows);
      launched("sort_keys");
      head_flags_kernel<<<grid_for(rows), kThreads, 0, E().stream>>>(
          sk.as<uint64_t>(), flag.as<int32_t>(), rows, c == 0 ? 1 : 0);
      launched("head_flags");
    }
    const int32_t groups =
        exclusive_scan(flag.as<int32_t>(), pos.as<int32_t>(), rows);
    dmem starts((static_cast<size_t>(groups) + 1) * 4),
        rep(static_cast<size_t>(groups) * 4), rank(rows * 4);
    group_starts_kernel<<<grid_for(rows), kThreads, 0, E().stream>>>(
        flag.as<int32_t>(), pos.as<int32_t>(), starts.as<int32_t>(), rows,
        groups);
    launched("group_starts");
    int32_t* mark = flag.as<int32_t>();  // the flags are spent: reuse
    ck(cudaMemsetAsync(mark, 0, rows * 4, E().stream), "group marks");
    group_reps_kernel<<<grid_for(groups), kThreads, 0, E().stream>>>(
        perm.as<int32_t>(), starts.as<int32_t>(), rep.as<int32_t>(), mark,
        groups);
    launched("group_reps");
    exclusive_scan(mark, rank.as<int32_t>(), rows);
    dmem rep_out(static_cast<size_t>(groups) * 4),
        sizes(static_cast<size_t>(groups) * 8);
    group_meta_kernel<<<grid_for(groups), kThreads, 0, E().stream>>>(
        rep.as<int32_t>(), rank.as<int32_t>(), starts.as<int32_t>(),
        rep_out.as<int32_t>(), sizes.as<int64_t>(), groups);
    launched("group_meta");
    g.rep_rows = fetch<int32_t>(rep_out.p, groups);
    g.sizes = fetch<int64_t>(sizes.p, groups);
    dmem sums(static_cast<size_t>(groups) * 8),
        mins(static_cast<size_t>(groups) * 8),
        maxs(static_cast<size_t>(groups) * 8),
        means(static_cast<size_t>(groups) * 8);
    for (const auto& v : values) {
      const auto id = v.dtype.id;
      const int kind = is_float4(id)                   ? VK_F32
                       : is_float8(id)                 ? VK_F64
                       : srt::size_of(id) == 4         ? VK_I32
                                                       : VK_I64;
      group_aggregate_kernel<<<grid_for(groups), kThreads, 0, E().stream>>>(
          ptr_of(v), kind, perm.as<int32_t>(), starts.as<int32_t>(),
          rep.as<int32_t>(), rank.as<int32_t>(), groups, sums.as<int64_t>(),
          mins.as<int64_t>(), maxs.as<int64_t>(), means.as<double>());
      launched("group_aggregate");
      g.sums.push_back(fetch<int64_t>(sums.p, groups));
      g.mins.push_back(fetch<int64_t>(mins.p, groups));
      g.maxs.push_back(fetch<int64_t>(maxs.p, groups));
      g.means.push_back(fetch<double>(means.p, groups));
      // the next column's kernel writes the same slots: drain first
      ck(cudaStreamSynchronize(E().stream), "group_aggregate");
    }
  });
  if (ok) *out = std::move(g);
  return ok;
}

// -- launch counts -----------------------------------------------------------

int64_t launches(const std::string& name) {
  std::lock_guard<std::mutex> lk(E().mu);
  auto it = E().launches.find(name);
  return it == E().launches.end() ? 0 : it->second;
}

std::vector<std::string> launch_names() {
  std::lock_guard<std::mutex> lk(E().mu);
  std::vector<std::string> out;
  for (const auto& kv : E().launches) out.push_back(kv.first);
  return out;
}

void reset_launches() {
  std::lock_guard<std::mutex> lk(E().mu);
  E().launches.clear();
}

}  // namespace dev
}  // namespace srt
