// K8: ROW_NUMBER and RANK of the window operator, from the sorted head
// flags straight into physical row order.
//
// Replaces no TPU kernel. The reference numbers windows with cumulative
// algebra in jnp (spark_rapids_jni_tpu/tpcds/oplib/windows.py): over the
// rows in sorted order, start(i) = cummax(new_part ? i : 0) is the row's
// partition start, first(i) = cummax(changed ? i : 0) the start of its tie
// run, row_number = i - start + 1, rank = first - start + 1, and one
// scatter through the sort's permutation puts them back in physical order.
// K8 computes exactly that, for every sorted position i:
//
//   row_number[order[i]] = i - start(i) + 1
//   rank[order[i]]       = first(i) - start(i) + 1
//
// writing only the outputs asked for.
//
// Why it was added: the port took torch.cummax for the two scans, and
// PyTorch's indexed scan of a 1-D tensor runs in a grid of one block
// (ATen/native/cuda/ScanUtils.cuh, scan_innermost_dim_with_indices: one
// block a row of the input, and a 1-D tensor is one row), so one SM of
// 132 walked q19's 28.8M sorted rows twice, and wrote an int64 index
// vector nothing read, about 0.1 s a call.
//
// What bounds it on an H100: bytes. Each row reads its int64 permutation
// entry and one or two bool flags, and writes one int64 a result: about
// 18 bytes a row for RANK, 0.155 ms at q19's 28.8M rows at 3.35 TB/s. The
// writes are scattered through the permutation, so each 8-byte store
// costs a whole 32-byte sector, which caps the share of that bound a
// kernel can reach near 40%.
//
// The design: one launch, a single-pass scan with decoupled look-back
// (Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016).
//
// - Tiles. A block takes the next tile of kTile sorted rows from an atomic
//   counter (so every tile before it belongs to a block already running,
//   and the look-back cannot wait on a block that never starts). Each
//   thread loads its kItems consecutive flags as one 16-byte vector and
//   keeps them as a bit mask; the block scans the threads' last head
//   positions with max (warp shuffles, then the warps' totals).
// - The operator. max over head positions: positions grow with the sorted
//   index, so the prefix of everything before a tile is the last head of
//   the nearest tile before it that holds one. A tile publishes, in one
//   64-bit word, a status and its last partition head and last tie head
//   (31 bits each: n < 2^31). A tile that holds a head of each scan knows
//   its inclusive prefix at once and publishes it as such, so a look-back
//   stops there. Value and status share the word, so one store publishes
//   both and no fence is needed between them.
// - Look-back. One warp reads the words of the 32 tiles before its own
//   together; for each scan, the nearest tile that is inclusive or holds
//   a head ends the walk, and its value is the prefix. A tile whose first
//   row is a head of a scan needs no prefix of it. At q19's size almost
//   every tile holds a head, so the walk ends at the tile before; at
//   q16's, a partition spans some 25 tiles, one window of the warp.
// - Output. The rows are revisited in striped order (thread t takes rows
//   t, t + 256, ...): each row finds its start from the owning thread's
//   mask and prefix in shared memory, the permutation is read coalesced,
//   and each result is stored once, at order[i].
//
// The wrapper (ops/cuda_kernels.py `window_numbering`) zeroes the tile
// words and the counter, one small buffer on the current stream; the
// kernel allocates nothing and does not synchronise with the host, so it
// runs inside a CUDA graph capture.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;  // rows a thread scans: one 16-byte flag load
constexpr int kTile = kThreads * kItems;  // 4096 (cuda_kernels.py)
constexpr unsigned kFull = 0xFFFFFFFFu;

// a tile's word: bits 62-63 its status, 31-61 its last partition head
// (or the prefix through it), 0-30 its last tie head
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr unsigned long long kPos = (1ull << 31) - 1;

struct Args {
  const long long* order;
  const unsigned char* part;
  const unsigned char* tie;  // null: no RANK
  long long* row_number;     // null: not asked for
  long long* rank;           // null: not asked for
  unsigned long long* words;
  unsigned int* counter;
  long long n;
};

__device__ __forceinline__ unsigned long long pack(unsigned long long status,
                                                   int p, int q) {
  return status | (static_cast<unsigned long long>(p) << 31) |
         static_cast<unsigned long long>(q);
}

__device__ __forceinline__ void publish(unsigned long long* w,
                                        unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(w) = v;
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* w) {
  return *reinterpret_cast<const volatile unsigned long long*>(w);
}

// bit j: row i0 + j is a head (rows past n are not)
__device__ __forceinline__ unsigned head_mask(const unsigned char* flags,
                                              long long i0, long long n) {
  unsigned mask = 0;
  if (i0 + kItems <= n) {
    const uint4 v = *reinterpret_cast<const uint4*>(flags + i0);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        mask |= static_cast<unsigned>(((w[k] >> (8 * b)) & 0xFFu) != 0)
                << (4 * k + b);
      }
    }
  } else {
    for (int j = 0; j < kItems && i0 + j < n; ++j) {
      mask |= static_cast<unsigned>(flags[i0 + j] != 0) << j;
    }
  }
  return mask;
}

// the last head of rows [i0, i0 + kItems) by their mask, 0 for none
__device__ __forceinline__ int last_head(unsigned mask, long long i0) {
  return mask ? static_cast<int>(i0) + 31 - __clz(mask) : 0;
}

__device__ __forceinline__ int warp_max_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = max(v, u);
  }
  return v;
}

// The prefix of every tile before `tile`, by warp 0: for each scan asked
// for (need_p, need_q), the value of the nearest tile that is inclusive
// or holds a head; 0 where the walk passes tile 0.
__device__ void look_back(const unsigned long long* words, int tile,
                          bool need_p, bool need_q, int lane, int* pre_p,
                          int* pre_q) {
  int p = 0, q = 0;
  for (int base = tile - 1; (need_p || need_q) && base >= 0; base -= 32) {
    const int idx = base - lane;
    unsigned long long w = kInclusive;  // before tile 0: nothing
    if (idx >= 0) {
      do {
        w = peek(words + idx);
      } while ((w >> 62) == 0);
    }
    const bool inclusive = (w >> 62) == 2;
    const int vp = static_cast<int>((w >> 31) & kPos);
    const int vq = static_cast<int>(w & kPos);
    const unsigned stop_p = __ballot_sync(kFull, inclusive || vp != 0);
    const unsigned stop_q = __ballot_sync(kFull, inclusive || vq != 0);
    if (need_p && stop_p) {
      p = __shfl_sync(kFull, vp, __ffs(stop_p) - 1);
      need_p = false;
    }
    if (need_q && stop_q) {
      q = __shfl_sync(kFull, vq, __ffs(stop_q) - 1);
      need_q = false;
    }
  }
  *pre_p = p;
  *pre_q = q;
}

__global__ void __launch_bounds__(kThreads)
    window_numbering_kernel(const Args a) {
  __shared__ int s_tile;
  __shared__ int s_warp_p[kWarps], s_warp_q[kWarps];
  __shared__ int s_pre_p, s_pre_q;
  __shared__ unsigned s_mask_p[kThreads], s_mask_q[kThreads];
  __shared__ int s_excl_p[kThreads], s_excl_q[kThreads];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) s_tile = static_cast<int>(atomicAdd(a.counter, 1u));
  __syncthreads();
  const int tile = s_tile;
  const long long base = static_cast<long long>(tile) * kTile;
  const bool ranks = a.tie != nullptr;

  // each thread's rows: their heads and the last of each scan
  const long long i0 = base + static_cast<long long>(t) * kItems;
  const unsigned mp = head_mask(a.part, i0, a.n);
  const unsigned mq = ranks ? head_mask(a.tie, i0, a.n) : 0u;
  const int ip = warp_max_scan(last_head(mp, i0), lane);
  const int iq = warp_max_scan(last_head(mq, i0), lane);
  int ep = __shfl_up_sync(kFull, ip, 1);
  int eq = __shfl_up_sync(kFull, iq, 1);
  if (lane == 0) ep = eq = 0;
  if (lane == 31) {
    s_warp_p[warp] = ip;
    s_warp_q[warp] = iq;
  }
  __syncthreads();
  int bp = 0, bq = 0;  // the tile's last heads
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      ep = max(ep, s_warp_p[w]);
      eq = max(eq, s_warp_q[w]);
    }
    bp = max(bp, s_warp_p[w]);
    bq = max(bq, s_warp_q[w]);
  }
  s_mask_p[t] = mp;
  s_mask_q[t] = mq;
  s_excl_p[t] = ep;
  s_excl_q[t] = eq;

  if (warp == 0) {
    // a tile that holds a head of each scan knows its inclusive prefix
    const bool known = tile == 0 || (bp != 0 && (!ranks || bq != 0));
    if (lane == 0) {
      publish(a.words + tile, pack(known ? kInclusive : kAggregate, bp, bq));
    }
    // a scan whose head opens the tile needs no prefix
    const unsigned first = __shfl_sync(kFull, mp | (mq << 16), 0);
    int pp = 0, pq = 0;
    look_back(a.words, tile, !(first & 1u), ranks && !(first & 0x10000u),
              lane, &pp, &pq);
    if (lane == 0) {
      if (!known) {
        publish(a.words + tile,
                pack(kInclusive, max(pp, bp), ranks ? max(pq, bq) : 0));
      }
      s_pre_p = pp;
      s_pre_q = pq;
    }
  }
  __syncthreads();

  // striped: thread t takes rows t, t + kThreads, ... of the tile
  const int pre_p = s_pre_p, pre_q = s_pre_q;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int r = k * kThreads + t;
    const long long i = base + r;
    if (i >= a.n) continue;
    const int owner = r / kItems;
    const unsigned below = (2u << (r % kItems)) - 1u;
    const long long o0 = base + static_cast<long long>(owner) * kItems;
    const unsigned hp = s_mask_p[owner] & below;
    const long long start =
        hp ? o0 + 31 - __clz(hp) : max(pre_p, s_excl_p[owner]);
    const long long o = __ldg(a.order + i);
    if (a.row_number != nullptr) a.row_number[o] = i - start + 1;
    if (a.rank != nullptr) {
      const unsigned hq = s_mask_q[owner] & below;
      const long long first =
          hq ? o0 + 31 - __clz(hq) : max(pre_q, s_excl_q[owner]);
      a.rank[o] = first - start + 1;
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = success), or
// cudaErrorInvalidValue for arguments the kernel does not take: rows at
// or past 2^31, flags not 16-byte aligned, RANK without tie flags, no
// output. `scratch` holds ceil(n / 4096) tile words and then the tile
// counter, all zero.
extern "C" int srt_window_numbering(const void* order, const void* part,
                                    const void* tie, long long n,
                                    void* row_number, void* rank,
                                    void* scratch, void* stream) {
  if (n < 0 || n >= (1LL << 31) || order == nullptr || part == nullptr ||
      scratch == nullptr || (row_number == nullptr && rank == nullptr) ||
      (rank != nullptr && tie == nullptr) ||
      (reinterpret_cast<uintptr_t>(part) & 15) ||
      (reinterpret_cast<uintptr_t>(tie) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const long long tiles = (n + kTile - 1) / kTile;
  Args a;
  a.order = static_cast<const long long*>(order);
  a.part = static_cast<const unsigned char*>(part);
  a.tie = rank != nullptr ? static_cast<const unsigned char*>(tie) : nullptr;
  a.row_number = static_cast<long long*>(row_number);
  a.rank = static_cast<long long*>(rank);
  a.words = static_cast<unsigned long long*>(scratch);
  a.counter = reinterpret_cast<unsigned int*>(a.words + tiles);
  a.n = n;
  window_numbering_kernel<<<static_cast<unsigned int>(tiles), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
