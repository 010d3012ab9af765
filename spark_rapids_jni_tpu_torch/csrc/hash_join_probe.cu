// K1: hash-join build + probe for the fused planner's dense joins.
//
// Replaces spark_rapids_jni_tpu/ops/pallas_kernels.py `_hash_join_probe`
// (probe kernel `_probe_kernel`, table build `_build_join_table`, wrapper
// `hash_join_probe_pallas`). Output contract is the reference's: per
// probe row (build_row_idx int32, found bool); unmatched and dead probe
// rows report (0, false); dead build rows never enter the table.
//
// What bounds it on an H100: bytes. The probe side streams 8 B of key
// (+1 B of live mask) in and 5 B out per row; the table (at most 32,768
// slots on the main path) sits in L2 or in shared memory, and a walk at
// load factor <= 0.5 reads about 1.5 slots. So the design cuts what each
// step of a walk costs and keeps many walks in flight:
//
// - Each slot is 16 bytes, (key int64, row int32, pad), read with one
//   128-bit load: one round trip a step, where separate key and row
//   arrays took two dependent ones. An empty slot has row -1 (the table
//   is filled with 0xFF bytes).
// - Each thread walks two probe rows at once, loading their next slots
//   together, so one walk's latency hides behind the other; their keys
//   and live bytes arrive as vector loads, (idx, found) leave as vector
//   stores. The kernels are held to 32 registers, so 2,048 threads (4,096
//   walks) fit on an SM: four walks a thread took 57 registers, half the
//   threads, and each thread waited for the longest of its four walks.
// - A small table (the caller passes none; ops/cuda_kernels.py
//   `probe_table_shared` allows 8,192 slots, 128 KB) is built by every
//   block of a persistent grid in its own shared memory from the build
//   keys, and probed there: one launch, no fill, no build kernel. The
//   build costs each block n_build key reads from L2; on the main path
//   (builds of 30 to 1,820 rows take this route, against probes of 31,622
//   to 10M rows) that is well under the probe's own bytes. A larger table
//   is filled with cudaMemsetAsync, built by its own kernel in global
//   memory and probed from L2.
//
// Inserts claim the first free slot of their linear-probe walk with
// atomicCAS on the slot's row word, then write the key. The reference's
// build is a lowest-row-wins tournament; the slot layout here depends on
// the atomics' order, but under the planner's precondition of unique live
// build keys the probe's (idx, found) does not depend on the layout. Every
// walk is bounded by the capacity, so duplicate keys still terminate.
//
// Slot hash: the reference's `_probe_hash`, murmur3 fmix32 of
// lo ^ hi * 0x85EBCA6B over the key's uint32 lanes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;         // build and global-table probe
constexpr int kSharedThreads = 1024;  // shared-table probe (one block an SM
                                      // at 128 KB still has 32 warps)
constexpr int kSmPerSm = 228 * 1024;  // shared memory of one SM
constexpr int kSmPerBlockOverhead = 1024;
constexpr int64_t kMaxBlocks = 1 << 20;

__device__ __forceinline__ uint32_t probe_hash(int64_t key) {
  const uint64_t bits = static_cast<uint64_t>(key);
  const uint32_t lo = static_cast<uint32_t>(bits & 0xFFFFFFFFull);
  const uint32_t hi = static_cast<uint32_t>(bits >> 32);
  uint32_t k = lo ^ (hi * 0x85EBCA6Bu);
  k ^= k >> 16;
  k *= 0x85EBCA6Bu;
  k ^= k >> 13;
  k *= 0xC2B2AE35u;
  k ^= k >> 16;
  return k;
}

__device__ __forceinline__ long long slot_key(int4 s) {
  return static_cast<long long>(
      static_cast<uint64_t>(static_cast<uint32_t>(s.y)) << 32 |
      static_cast<uint32_t>(s.x));
}

// insert build row `row` with `key` into a table in shared or global
// memory
__device__ __forceinline__ void insert(int4* table, uint32_t mask,
                                       int64_t key, int32_t row) {
  uint32_t h = probe_hash(key) & mask;
  // bounded by the capacity: at load <= 0.5 a free slot always exists
  for (uint32_t step = 0; step <= mask; ++step) {
    int* slot_row = reinterpret_cast<int*>(table + h) + 2;
    if (atomicCAS(slot_row, -1, row) == -1) {
      *reinterpret_cast<long long*>(table + h) = key;
      return;
    }
    h = (h + 1) & mask;
  }
}

template <bool kShared>
__device__ __forceinline__ int4 load_slot(const int4* table, uint32_t h) {
  if constexpr (kShared) {
    return table[h];
  } else {
    return __ldg(table + h);
  }
}

// Probe rows 2g and 2g + 1 for g = first, first + stride, ...: two walks
// in flight per thread.
template <bool kShared>
__device__ __forceinline__ void probe_rows(
    const int4* table, uint32_t mask, const int64_t* __restrict__ keys,
    const uint8_t* __restrict__ live, int64_t n, int32_t* __restrict__ out_idx,
    uint8_t* __restrict__ out_found, int64_t first, int64_t stride) {
  const bool vec = (reinterpret_cast<uintptr_t>(keys) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(live) & 1) == 0;
  const int64_t groups = (n + 1) / 2;
  for (int64_t g = first; g < groups; g += stride) {
    const int64_t i0 = 2 * g;
    const bool whole = i0 + 2 <= n;
    long long key[2];
    bool todo[2];
    if (vec && whole) {
      const longlong2 k = *reinterpret_cast<const longlong2*>(keys + i0);
      key[0] = k.x;
      key[1] = k.y;
      const uint32_t lv =
          live == nullptr ? 0x0101u
                          : *reinterpret_cast<const uint16_t*>(live + i0);
      todo[0] = lv & 0xFFu;
      todo[1] = lv >> 8;
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool in = i0 + j < n;
        key[j] = in ? keys[i0 + j] : 0;
        todo[j] = in && (live == nullptr || live[i0 + j]);
      }
    }
    int idx[2] = {0, 0};
    uint32_t found = 0;  // byte j = found of row i0 + j
    uint32_t h[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) h[j] = probe_hash(key[j]) & mask;
    for (uint32_t step = 0; step <= mask && (todo[0] || todo[1]); ++step) {
      int4 s[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (todo[j]) s[j] = load_slot<kShared>(table, h[j]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (!todo[j]) continue;
        if (s[j].z < 0) {  // an empty slot ends the walk: no match
          todo[j] = false;
        } else if (slot_key(s[j]) == key[j]) {
          idx[j] = s[j].z;
          found |= 1u << (8 * j);
          todo[j] = false;
        } else {
          h[j] = (h[j] + 1) & mask;
        }
      }
    }
    if (whole) {
      *reinterpret_cast<int2*>(out_idx + i0) = make_int2(idx[0], idx[1]);
      *reinterpret_cast<uint16_t*>(out_found + i0) =
          static_cast<uint16_t>(found);
    } else {
      out_idx[i0] = idx[0];
      out_found[i0] = found & 1u;
    }
  }
}

// One launch for a table that fits in shared memory: each block builds its
// own copy, then probes its share of the rows.
__global__ void __launch_bounds__(kSharedThreads, 2048 / kSharedThreads)
    build_probe_kernel(
    const int64_t* __restrict__ build_keys,
    const uint8_t* __restrict__ build_live, int64_t n_build, uint32_t mask,
    const int64_t* __restrict__ probe_keys,
    const uint8_t* __restrict__ probe_live, int64_t n_probe,
    int32_t* __restrict__ out_idx, uint8_t* __restrict__ out_found) {
  extern __shared__ int4 table[];
  for (uint32_t i = threadIdx.x; i <= mask; i += blockDim.x) {
    table[i] = make_int4(-1, -1, -1, -1);
  }
  __syncthreads();
  for (int64_t i = threadIdx.x; i < n_build; i += blockDim.x) {
    if (build_live == nullptr || build_live[i]) {
      insert(table, mask, build_keys[i], static_cast<int32_t>(i));
    }
  }
  __syncthreads();
  probe_rows<true>(table, mask, probe_keys, probe_live, n_probe, out_idx,
                   out_found,
                   static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x,
                   static_cast<int64_t>(gridDim.x) * blockDim.x);
}

__global__ void build_kernel(const int64_t* __restrict__ keys,
                             const uint8_t* __restrict__ live, int64_t n,
                             int4* table, uint32_t mask) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    if (live == nullptr || live[i]) {
      insert(table, mask, keys[i], static_cast<int32_t>(i));
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2048 / kThreads)
    probe_kernel(const int4* __restrict__ table, uint32_t mask,
                             const int64_t* __restrict__ keys,
                             const uint8_t* __restrict__ live, int64_t n,
                             int32_t* __restrict__ out_idx,
                             uint8_t* __restrict__ out_found) {
  probe_rows<false>(table, mask, keys, live, n, out_idx, out_found,
                    static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x,
                    static_cast<int64_t>(gridDim.x) * blockDim.x);
}

unsigned int blocks_for(int64_t n, int threads) {
  int64_t b = (n + threads - 1) / threads;
  return static_cast<unsigned int>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// capacity is a power of two. With no `table` (null), each block builds
// the table in its shared memory, capacity x 16 bytes of it, in one
// launch. Else `table` is capacity x 16 bytes on the card, which this call
// fills and builds. Returns the CUDA error of the calls (0 = success).
extern "C" int srt_hash_join_probe(const void* build_keys,
                                   const void* build_live, long long n_build,
                                   const void* probe_keys,
                                   const void* probe_live, long long n_probe,
                                   void* table, int capacity, void* out_idx,
                                   void* out_found, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t mask = static_cast<uint32_t>(capacity - 1);
  const int64_t* bk = static_cast<const int64_t*>(build_keys);
  const uint8_t* bl = static_cast<const uint8_t*>(build_live);
  const int64_t* pk = static_cast<const int64_t*>(probe_keys);
  const uint8_t* pl = static_cast<const uint8_t*>(probe_live);
  int32_t* idx = static_cast<int32_t*>(out_idx);
  uint8_t* found = static_cast<uint8_t*>(out_found);
  if (n_probe <= 0) return 0;
  const int64_t groups = (n_probe + 1) / 2;
  if (table == nullptr) {
    const int smem = capacity * static_cast<int>(sizeof(int4));
    if (smem > 48 * 1024) {
      // per device, so set before every such launch (it is cheap)
      const cudaError_t err = cudaFuncSetAttribute(
          build_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    int per_sm = kSmPerSm / (smem + kSmPerBlockOverhead);
    per_sm = per_sm < 2048 / kSharedThreads ? per_sm : 2048 / kSharedThreads;
    int64_t blocks = (groups + kSharedThreads - 1) / kSharedThreads;
    const int64_t resident = static_cast<int64_t>(sms) * per_sm;
    blocks = blocks < resident ? blocks : resident;
    build_probe_kernel<<<static_cast<unsigned int>(blocks), kSharedThreads,
                         smem, s>>>(bk, bl, n_build, mask, pk, pl, n_probe,
                                    idx, found);
    return static_cast<int>(cudaGetLastError());
  }
  int4* t = static_cast<int4*>(table);
  cudaError_t err = cudaMemsetAsync(
      t, 0xFF, static_cast<size_t>(capacity) * sizeof(int4), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_build > 0) {
    build_kernel<<<blocks_for(n_build, kThreads), kThreads, 0, s>>>(
        bk, bl, n_build, t, mask);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  probe_kernel<<<blocks_for(groups, kThreads), kThreads, 0, s>>>(
      t, mask, pk, pl, n_probe, idx, found);
  return static_cast<int>(cudaGetLastError());
}
