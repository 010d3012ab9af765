// K3: validity bitmask pack, bool (N,) -> uint32 words, LSB-first.
//
// Replaces spark_rapids_jni_tpu/ops/pallas_kernels.py
// `bitmask_pack_pallas` (kernel `_bitmask_pack_kernel`): bit r % 32 of
// word r / 32 is row r's validity; padding bits of the last word are 0.
//
// What bounds it on an H100: bytes (1 B read per row, 1/8 B written).
// The TPU kernel reduces (rows/32, 32) lanes with a weighted sum in
// VMEM; here each warp votes its 32 consecutive validity bytes with
// __ballot_sync and lane 0 writes the word, as the reference library's
// own row_conversion.cu does. The grid-stride loop runs over
// n_words * 32 positions, so every warp's 32 lanes stay converged at the
// ballot; positions past N vote 0, which zeroes the padding bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a multiple of the warp size
constexpr int64_t kMaxBlocks = 1 << 20;

__global__ void bitmask_pack_kernel(const uint8_t* __restrict__ valid,
                                    int64_t n, uint32_t* __restrict__ words,
                                    int64_t n_words) {
  const int64_t total = n_words * 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < total; r += stride) {
    const int bit = (r < n) && valid[r] != 0;
    const uint32_t word = __ballot_sync(0xFFFFFFFFu, bit);
    if ((threadIdx.x & 31) == 0) words[r >> 5] = word;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int srt_bitmask_pack(const void* valid, long long n, void* words,
                                long long n_words, void* stream) {
  if (n_words <= 0) return 0;
  int64_t blocks = (n_words * 32 + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  bitmask_pack_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(valid), n, static_cast<uint32_t*>(words),
      n_words);
  return static_cast<int>(cudaGetLastError());
}
