// K1: hash-join build + probe for the fused planner's dense joins.
//
// Replaces spark_rapids_jni_tpu/ops/pallas_kernels.py `_hash_join_probe`
// (probe kernel `_probe_kernel`, table build `_build_join_table`, wrapper
// `hash_join_probe_pallas`). Output contract is the reference's: per
// probe row (build_row_idx int32, found bool); unmatched and dead probe
// rows report (0, false); dead build rows never enter the table.
//
// What bounds it on an H100: bytes. The probe side streams 8 B of key
// (+1 B of live mask) in and 5 B out per row; the table at the main
// path's shapes is at most 32,768 slots x 12 B = 384 KB, so every table
// read after the first hits L2 (50 MB). The design keeps the table in
// L2 and makes one pass over the probe rows: one thread per probe row,
// coalesced key loads, a linear-probing walk whose expected length at
// load factor <= 0.5 is about 1.5 slots.
//
// The build is its own kernel: one thread per live build row claims the
// first free slot of its linear-probe walk with atomicCAS on the slot's
// row word, then writes the key. The reference's build is a lowest-row-
// wins tournament; the slot layout here depends on the atomics' order,
// but under the planner's precondition of unique live build keys the
// probe's (idx, found) does not depend on the layout.
//
// Slot hash: the reference's `_probe_hash`, murmur3 fmix32 of
// lo ^ hi * 0x85EBCA6B over the key's uint32 lanes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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

__global__ void build_kernel(const int64_t* __restrict__ keys,
                             const uint8_t* __restrict__ live, int64_t n,
                             int32_t* slot_row, int64_t* slot_key,
                             uint32_t slot_mask) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    if (live != nullptr && !live[i]) continue;
    const int64_t key = keys[i];
    uint32_t h = probe_hash(key) & slot_mask;
    // bounded by the capacity: at load <= 0.5 a free slot always exists
    for (uint32_t step = 0; step <= slot_mask; ++step) {
      if (atomicCAS(&slot_row[h], -1, static_cast<int32_t>(i)) == -1) {
        slot_key[h] = key;
        break;
      }
      h = (h + 1) & slot_mask;
    }
  }
}

__global__ void probe_kernel(const int32_t* __restrict__ slot_row,
                             const int64_t* __restrict__ slot_key,
                             uint32_t slot_mask,
                             const int64_t* __restrict__ keys,
                             const uint8_t* __restrict__ live, int64_t n,
                             int32_t* __restrict__ out_idx,
                             uint8_t* __restrict__ out_found) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    int32_t idx = 0;
    uint8_t found = 0;
    if (live == nullptr || live[i]) {
      const int64_t key = keys[i];
      uint32_t h = probe_hash(key) & slot_mask;
      for (uint32_t step = 0; step <= slot_mask; ++step) {
        const int32_t row = __ldg(&slot_row[h]);
        if (row < 0) break;  // empty slot ends the walk: no match
        if (__ldg(reinterpret_cast<const long long*>(&slot_key[h])) ==
            static_cast<long long>(key)) {
          idx = row;
          found = 1;
          break;
        }
        h = (h + 1) & slot_mask;
      }
    }
    out_idx[i] = idx;
    out_found[i] = found;
  }
}

unsigned int blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// slot_row (capacity int32) must arrive filled with -1; slot_key
// (capacity int64) needs no initialisation. capacity is a power of two.
// Returns cudaGetLastError() after the launches (0 = success).
extern "C" int srt_hash_join_probe(const void* build_keys,
                                   const void* build_live, long long n_build,
                                   const void* probe_keys,
                                   const void* probe_live, long long n_probe,
                                   void* slot_row, void* slot_key,
                                   int capacity, void* out_idx,
                                   void* out_found, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t slot_mask = static_cast<uint32_t>(capacity - 1);
  if (n_build > 0) {
    build_kernel<<<blocks_for(n_build), kThreads, 0, s>>>(
        static_cast<const int64_t*>(build_keys),
        static_cast<const uint8_t*>(build_live), n_build,
        static_cast<int32_t*>(slot_row), static_cast<int64_t*>(slot_key),
        slot_mask);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_probe > 0) {
    probe_kernel<<<blocks_for(n_probe), kThreads, 0, s>>>(
        static_cast<const int32_t*>(slot_row),
        static_cast<const int64_t*>(slot_key), slot_mask,
        static_cast<const int64_t*>(probe_keys),
        static_cast<const uint8_t*>(probe_live), n_probe,
        static_cast<int32_t*>(out_idx), static_cast<uint8_t*>(out_found));
  }
  return static_cast<int>(cudaGetLastError());
}
