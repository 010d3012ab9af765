// K2: dense (ragged) groupby sum + count over int32 slot codes.
//
// Replaces spark_rapids_jni_tpu/ops/pallas_kernels.py `_ragged_groupby`
// (kernel `_ragged_groupby_kernel`, wrapper
// `ragged_groupby_sum_count_pallas`): per slot in [0, width), the int64
// sum (exact mod 2^64) and int32 count of the live rows' values. Rows
// that are dead or whose slot lies outside [0, width) are skipped.
//
// What bounds it on an H100: bytes on a spread slot space (1 B live read
// a row, 4 B slot and 8 B value a live row), shared-memory atomic
// contention on a narrow one (every row lands on a handful of slots), and
// launch latency on a small call. The TPU kernel splits values into
// 16-bit limbs so that a 32-bit one-hot matmul stays exact; here 64-bit
// atomicAdd on unsigned long long already wraps mod 2^64 in any order, so
// there are no limbs and no one-hot plane.
//
// One launch a call, and nothing arrives zeroed: a block of 1024 threads
// for each 2,048 rows, up to one an SM, launched cooperatively.
//  1. Each block keeps `copies` copies of all `width` sums and counts in
//     shared memory, as many as fit 192 KB (the caller picks,
//     `cuda_kernels.ragged_copies`; PERF.md has the measurement): up to
//     16 slots a thread keeps its own (1024 copies, plain adds: no two
//     lanes meet, however skewed the slots); else warp w adds with
//     shared-memory atomics into copy w % copies (32 up to 512 slots, 2
//     at 8192). Chunk c of 512 rows goes to block c % blocks, so a small
//     call is spread over SMs, not run by the warps of one. A warp takes
//     a chunk at a time: a lane loads 16 live flags in one 16-byte load
//     (the next chunk's load goes out before this one's flags are used),
//     and a chunk whose flags are all 0 goes no further; else lane l
//     takes row 32j + l of each 32-row step j (its flag shuffled over)
//     and reads the slots and values of its live rows, 8 steps' loads in
//     flight at once: neighbouring lanes on neighbouring rows, so each
//     read is coalesced, and a chunk waits on memory about twice, not
//     once a row (the first design walked 16 rows a thread, one
//     dependent load after another, and ran at latency). A call of up to
//     65,536 rows is all latency: there a warp takes 256 rows, a row a
//     lane, and reads all their flags, slots and values at once
//     (`kEagerRows`; the extra bytes are few).
//  2. The block folds its copies and writes its partials, every slot, to
//     a workspace row; then the grid syncs (`grid.sync()`).
//  3. Block b sums the workspace's column of the slots [b * per,
//     (b + 1) * per) over every block's row, 32 slots a warp-column, the
//     blocks' rows split over the warps, and writes the outputs.
// A last-block ticket instead would leave one block to read the whole
// workspace (13 MB at width 8192); after the grid sync every block reads
// its share. The sums are integers mod 2^64, so the order is free. (A
// cluster of up to 8 blocks summing its partials through distributed
// shared memory was no faster on a 31,622-row call: PERF.md.)

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 512;  // rows a warp takes at a time
constexpr int64_t kEagerRows = 1 << 16;  // a small call, read eagerly
constexpr int64_t kBlockRows = 2048;      // rows a block is launched for
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxDevices = 64;
// phase 3 parts: a warp's 32 partial sums and counts
constexpr size_t kPartsBytes = kThreads * (sizeof(unsigned long long) +
                                           sizeof(unsigned int));
constexpr size_t kMaxSmem = 227 * 1024;

// Live flags 16 rows a lane: one 16-byte load where the 16 rows are
// whole and the flags aligned, else byte by byte (0 past the end).
__device__ __forceinline__ uint4 load_flags(const uint8_t* live, int64_t r,
                                            int64_t n, bool vec) {
  if (vec && r + 16 <= n) return *reinterpret_cast<const uint4*>(live + r);
  uint32_t f[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (r + k < n && live[r + k]) f[k >> 2] |= 1u << (8 * (k & 3));
  return make_uint4(f[0], f[1], f[2], f[3]);
}

__global__ void __launch_bounds__(kThreads, 1)
ragged_groupby_kernel(const int32_t* __restrict__ slots,
                      const uint8_t* __restrict__ live,
                      const int64_t* __restrict__ values, int64_t n,
                      int width, int copies,
                      unsigned long long* __restrict__ ws_sum,
                      unsigned int* __restrict__ ws_cnt,
                      unsigned long long* __restrict__ sums,
                      unsigned int* __restrict__ counts) {
  // copy c of slot s: a thread's own (copies == kThreads, plain adds, at
  // s * kThreads + c: a warp's lanes on neighbouring words), else a
  // warp's (copies <= 32) or the block's (at c * width + s)
  extern __shared__ unsigned long long smem[];
  const int cells = copies * width;
  unsigned long long* s_sum = smem;
  unsigned int* s_cnt = reinterpret_cast<unsigned int*>(smem + cells);
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    s_sum[i] = 0ull;
    s_cnt[i] = 0u;
  }
  __syncthreads();

  // 1. accumulate each live row with a slot in range into this thread's,
  // warp's or the block's copy
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool own = copies == kThreads;
  const int copy = own ? threadIdx.x : (warp & (copies - 1)) * width;
  const int step = own ? kThreads : 1;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  auto add = [&](int32_t sl, int64_t val) {
    if (static_cast<unsigned>(sl) >= static_cast<unsigned>(width)) return;
    const int at = sl * step + copy;
    if (own) {
      s_sum[at] += static_cast<unsigned long long>(val);
      s_cnt[at] += 1u;
    } else {
      atomicAdd(&s_sum[at], static_cast<unsigned long long>(val));
      atomicAdd(&s_cnt[at], 1u);
    }
  };
  if (n <= kEagerRows) {
    // a small call is latency: a warp takes 256 rows, lane l row 32k + l
    // of each of its 8 steps, and reads every flag, slot and value at
    // once, one wait on memory (the bytes are few)
    const int64_t tasks = (n + 255) / 256;
    for (int64_t t = static_cast<int64_t>(warp) * gridDim.x + blockIdx.x;
         t < tasks; t += stride) {
      bool on[8];
      int32_t sl[8];
      int64_t val[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int64_t i = 256 * t + 32 * k + lane;
        const bool in = i < n;
        on[k] = in && live[i];
        sl[k] = in ? slots[i] : -1;
        val[k] = in ? values[i] : 0;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (on[k]) add(sl[k], val[k]);
    }
  }
  // else a warp takes 512 rows at a time, lane l their live flags
  // 16l .. 16l + 15 in one 16-byte load (the next chunk's already in
  // flight); a chunk with no live flag goes no further; else lane l takes
  // row 32j + l of each 32-row step j (its flag shuffled from lane
  // 2j + l / 16), so slots and values are read coalesced and only where
  // the row is live
  const bool vec = (reinterpret_cast<uintptr_t>(live) & 15) == 0;
  const int64_t chunks = n <= kEagerRows ? 0 : (n + kChunk - 1) / kChunk;
  int64_t ch = static_cast<int64_t>(warp) * gridDim.x + blockIdx.x;
  uint4 f = ch < chunks ? load_flags(live, ch * kChunk + 16 * lane, n, vec)
                        : make_uint4(0u, 0u, 0u, 0u);
  for (; ch < chunks; ch += stride) {
    const int64_t base = ch * kChunk;
    const uint4 cur = f;
    if (ch + stride < chunks)
      f = load_flags(live, (ch + stride) * kChunk + 16 * lane, n, vec);
    const unsigned any =
        __ballot_sync(kFull, (cur.x | cur.y | cur.z | cur.w) != 0u);
    if (any == 0u) continue;
    const int b = lane & 15;
    unsigned alive = 0u;  // bit j: row 32j + lane is live
#pragma unroll
    for (int j = 0; j < kChunk / 32; ++j) {
      if (((any >> (2 * j)) & 3u) == 0u) continue;
      const int src = 2 * j + (lane >> 4);
      const uint32_t w0 = __shfl_sync(kFull, cur.x, src);
      const uint32_t w1 = __shfl_sync(kFull, cur.y, src);
      const uint32_t w2 = __shfl_sync(kFull, cur.z, src);
      const uint32_t w3 = __shfl_sync(kFull, cur.w, src);
      const uint32_t w = b < 8 ? (b < 4 ? w0 : w1) : (b < 12 ? w2 : w3);
      if ((w >> (8 * (b & 3))) & 0xFFu) alive |= 1u << j;
    }
    // a half-chunk's slots and values at once: the values of live rows
    // are read without waiting for their slots (a row whose slot is out of
    // range costs its value's read, not a second wait on memory)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int32_t s[kChunk / 64];
      int64_t v[kChunk / 64];
#pragma unroll
      for (int k = 0; k < kChunk / 64; ++k) {
        const int j = h * (kChunk / 64) + k;
        const int64_t i = base + 32 * j + lane;
        const bool on = (alive >> j) & 1u;
        s[k] = on ? slots[i] : -1;
        v[k] = on ? values[i] : 0;
      }
#pragma unroll
      for (int k = 0; k < kChunk / 64; ++k) add(s[k], v[k]);
    }
  }
  __syncthreads();

  // 2. this block's partials, every slot, to its workspace row: a warp
  // folds a slot's copies where each thread has one (lanes on
  // neighbouring words), else a thread (neighbouring threads on
  // neighbouring slots)
  unsigned long long* my_sum =
      ws_sum + static_cast<int64_t>(blockIdx.x) * width;
  unsigned int* my_cnt = ws_cnt + static_cast<int64_t>(blockIdx.x) * width;
  if (own) {
    for (int sl = warp; sl < width; sl += kWarps) {
      unsigned long long a = 0ull;
      unsigned int c = 0u;
      for (int k = lane; k < copies; k += 32) {
        a += s_sum[sl * kThreads + k];
        c += s_cnt[sl * kThreads + k];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_xor_sync(kFull, a, o);
        c += __shfl_xor_sync(kFull, c, o);
      }
      if (lane == 0) {
        my_sum[sl] = a;
        my_cnt[sl] = c;
      }
    }
  } else {
    for (int sl = threadIdx.x; sl < width; sl += kThreads) {
      unsigned long long a = 0ull;
      unsigned int c = 0u;
      for (int k = 0; k < copies; ++k) {
        a += s_sum[k * width + sl];
        c += s_cnt[k * width + sl];
      }
      my_sum[sl] = a;
      my_cnt[sl] = c;
    }
  }
  cg::this_grid().sync();

  // 3. slots [lo, hi) over every block's row, 32 slots a warp-column
  const int blocks = gridDim.x;
  const int per = ((width + blocks - 1) / blocks + 31) / 32 * 32;
  const int lo = blockIdx.x * per;
  const int hi = min(width, lo + per);
  const int ncol = hi > lo ? (hi - lo + 31) / 32 : 0;
  if (ncol == 0) return;
  if (ncol >= kWarps) {
    for (int col = warp; col < ncol; col += kWarps) {
      const int s = lo + col * 32 + lane;
      if (s >= hi) continue;
      unsigned long long a = 0ull;
      unsigned int c = 0u;
      for (int b = 0; b < blocks; ++b) {
        a += ws_sum[static_cast<int64_t>(b) * width + s];
        c += ws_cnt[static_cast<int64_t>(b) * width + s];
      }
      sums[s] = a;
      counts[s] = c;
    }
    return;
  }
  // fewer columns than warps: each column's blocks split over `parts`
  // warps, then folded through shared memory (free since step 2)
  const int parts = kWarps / ncol;
  const int col = warp / parts, part = warp % parts;
  const int s = lo + col * 32 + lane;
  const bool mine = col < ncol && s < hi;
  unsigned long long a = 0ull;
  unsigned int c = 0u;
  if (mine) {
    for (int b = part; b < blocks; b += parts) {
      a += ws_sum[static_cast<int64_t>(b) * width + s];
      c += ws_cnt[static_cast<int64_t>(b) * width + s];
    }
  }
  unsigned long long* p_sum = smem;
  unsigned int* p_cnt = reinterpret_cast<unsigned int*>(smem + kThreads);
  p_sum[threadIdx.x] = a;
  p_cnt[threadIdx.x] = c;
  __syncthreads();
  if (mine && part == 0) {
    for (int p = 1; p < parts; ++p) {
      a += p_sum[(warp + p) * 32 + lane];
      c += p_cnt[(warp + p) * 32 + lane];
    }
    sums[s] = a;
    counts[s] = c;
  }
}

struct Device {
  int sms;      // 0 until read
  int per_sm;   // resident blocks an SM at the largest shared memory
};
Device g_devices[kMaxDevices];

// The device's SM count and the kernel's residency, read once a device.
cudaError_t device_info(int* device, Device** info) {
  cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return err;
  if (*device < 0 || *device >= kMaxDevices) return cudaErrorInvalidDevice;
  Device& d = g_devices[*device];
  if (d.sms == 0) {
    int sms = 0, coop = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 *device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                   *device);
    if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ragged_groupby_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kMaxSmem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ragged_groupby_kernel, kThreads, kMaxSmem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    d.per_sm = per_sm;
    d.sms = sms;
  }
  *info = &d;
  return cudaSuccess;
}

}  // namespace

// The most blocks a call may take on the current device (its SM count),
// or a negative CUDA error.
extern "C" int srt_ragged_groupby_max_blocks() {
  int device = 0;
  Device* d = nullptr;
  const cudaError_t err = device_info(&device, &d);
  return err == cudaSuccess ? d->sms : -static_cast<int>(err);
}

// workspace: room for max_blocks * width * 12 bytes (the sums, then the
// counts); no input or output needs zeroing. copies: 1, 2, 4, 8, 16 or
// 32 (warp w adds into copy w % copies), or 1024 (a thread's own). A
// call gets a block for each kBlockRows rows, up to one an SM and
// max_blocks. Returns cudaGetLastError() after the launch (0 = success).
extern "C" int srt_ragged_groupby_sum_count(
    const void* slots, const void* live, const void* values, long long n,
    int width, int copies, int max_blocks, void* workspace, void* sums,
    void* counts, void* stream) {
  int device = 0;
  Device* d = nullptr;
  cudaError_t err = device_info(&device, &d);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t cells = static_cast<size_t>(copies) * width;
  size_t smem = cells * (sizeof(unsigned long long) + sizeof(unsigned int));
  if (smem < kPartsBytes) smem = kPartsBytes;
  if (width <= 0 || copies < 1 || (copies > kWarps && copies != kThreads) ||
      (copies & (copies - 1)) != 0 || smem > kMaxSmem || max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t want = (n + kBlockRows - 1) / kBlockRows;
  int blocks = static_cast<int>(std::min<int64_t>(
      want, std::min(d->sms, max_blocks)));
  if (blocks < 1) blocks = 1;
  // the attribute is per device: set it on every launch that needs it
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ragged_groupby_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto* ws_sum = static_cast<unsigned long long*>(workspace);
  auto* ws_cnt = reinterpret_cast<unsigned int*>(
      ws_sum + static_cast<int64_t>(blocks) * width);
  auto* p_slots = static_cast<const int32_t*>(slots);
  auto* p_live = static_cast<const uint8_t*>(live);
  auto* p_values = static_cast<const int64_t*>(values);
  int64_t rows = n;
  auto* p_sums = static_cast<unsigned long long*>(sums);
  auto* p_counts = static_cast<unsigned int*>(counts);
  void* args[] = {&p_slots, &p_live, &p_values, &rows, &width, &copies,
                  &ws_sum, &ws_cnt, &p_sums, &p_counts};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(ragged_groupby_kernel), dim3(blocks),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
