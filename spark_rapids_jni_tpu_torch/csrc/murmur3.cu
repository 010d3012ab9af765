// K4 and K5: Spark murmur3 (Murmur3_x86_32) of one fixed-width value per
// row, from a per-row seed.
//
// K4 replaces spark_rapids_jni_tpu/ops/pallas_kernels.py
// `murmur3_int32_pallas` (kernel `_murmur3_int_kernel`): one 4-byte
// block, total length 4. K5 replaces `murmur3_int64_pallas` (kernel
// `_murmur3_int64_kernel`): the low word then the high word of an 8-byte
// value, total length 8. Chaining across the columns of a row hash (the
// running hash seeds the next column, `murmur3_int64_table_pallas`)
// stays on the host: one launch per column.
//
// What bounds them on an H100: bytes. K4 reads 4 B of block and 4 B of
// seed and writes 4 B per row; K5 reads 8 + 4 and writes 4. The dozen
// 32-bit multiplies, rotates and xors per row are far below the
// integer rate. The TPU kernels pad to 2048-row tiles and split int64
// into two uint32 lanes outside the kernel; here one thread hashes one
// row in a grid-stride loop, neighbouring threads on neighbouring rows,
// so every load and store coalesces, and K5 reads the int64 in place as
// a (lo, hi) uint2. Rotates are funnel shifts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ uint32_t mix_block(uint32_t h1, uint32_t k1) {
  k1 *= 0xCC9E2D51u;
  k1 = rotl32(k1, 15);
  k1 *= 0x1B873593u;
  h1 ^= k1;
  h1 = rotl32(h1, 13);
  return h1 * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t finalize(uint32_t h, uint32_t len) {
  h ^= len;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__global__ void murmur3_int32_kernel(const uint32_t* __restrict__ blocks,
                                     const uint32_t* __restrict__ seeds,
                                     uint32_t* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    out[i] = finalize(mix_block(seeds[i], blocks[i]), 4u);
  }
}

__global__ void murmur3_int64_kernel(const uint2* __restrict__ values,
                                     const uint32_t* __restrict__ seeds,
                                     uint32_t* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const uint2 v = values[i];  // little-endian: x is the low word
    out[i] = finalize(mix_block(mix_block(seeds[i], v.x), v.y), 8u);
  }
}

unsigned int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 = success).
extern "C" int srt_murmur3_int32(const void* blocks, const void* seeds,
                                 void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  murmur3_int32_kernel<<<grid_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(blocks),
      static_cast<const uint32_t*>(seeds), static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int srt_murmur3_int64(const void* values, const void* seeds,
                                 void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  murmur3_int64_kernel<<<grid_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(values), static_cast<const uint32_t*>(seeds),
      static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
