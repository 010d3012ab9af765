// K2: dense (ragged) groupby sum + count over int32 slot codes.
//
// Replaces spark_rapids_jni_tpu/ops/pallas_kernels.py `_ragged_groupby`
// (kernel `_ragged_groupby_kernel`, wrapper
// `ragged_groupby_sum_count_pallas`): per slot in [0, width), the int64
// sum (exact mod 2^64) and int32 count of the live rows' values.
//
// What bounds it on an H100: bytes on a spread slot space (13 B read per
// row: 4 B slot, 1 B live, 8 B value), and shared-memory atomic
// contention on a narrow one (every row of a block lands on a handful of
// slots). The TPU kernel splits values into 16-bit limbs so that a
// 32-bit one-hot matmul stays exact; here 64-bit atomicAdd on unsigned
// long long already wraps mod 2^64 in any order, so there are no limbs
// and no one-hot plane. Each block accumulates its grid-stride share of
// the rows into shared-memory sums and counts for all `width` slots
// (width <= 8192: 8192 x 12 B = 96 KB of dynamic shared memory, so the
// kernel opts in above 48 KB), then adds its non-empty slots into the
// global outputs with one atomic each. Rows that are dead or whose slot
// is out of range are skipped. The outputs must arrive zeroed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void ragged_groupby_kernel(const int32_t* __restrict__ slots,
                                      const uint8_t* __restrict__ live,
                                      const int64_t* __restrict__ values,
                                      int64_t n, int width,
                                      unsigned long long* sums,
                                      unsigned int* counts) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* s_sum = smem;
  unsigned int* s_cnt = reinterpret_cast<unsigned int*>(smem + width);
  for (int s = threadIdx.x; s < width; s += blockDim.x) {
    s_sum[s] = 0ull;
    s_cnt[s] = 0u;
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    if (!live[i]) continue;
    const int32_t s = slots[i];
    if (s < 0 || s >= width) continue;
    atomicAdd(&s_sum[s], static_cast<unsigned long long>(values[i]));
    atomicAdd(&s_cnt[s], 1u);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < width; s += blockDim.x) {
    const unsigned int c = s_cnt[s];
    if (c != 0u) {
      atomicAdd(&sums[s], s_sum[s]);
      atomicAdd(&counts[s], c);
    }
  }
}

}  // namespace

// sums (width int64) and counts (width int32) must arrive zeroed.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int srt_ragged_groupby_sum_count(const void* slots,
                                            const void* live,
                                            const void* values, long long n,
                                            int width, void* sums,
                                            void* counts, void* stream) {
  if (n <= 0 || width <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(width) *
                      (sizeof(unsigned long long) + sizeof(unsigned int));
  cudaError_t err = cudaFuncSetAttribute(
      ragged_groupby_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ragged_groupby_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) per_sm = 1;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  if (blocks > resident) blocks = resident;
  ragged_groupby_kernel<<<static_cast<unsigned int>(blocks), kThreads, smem,
                          s>>>(
      static_cast<const int32_t*>(slots), static_cast<const uint8_t*>(live),
      static_cast<const int64_t*>(values), n, width,
      static_cast<unsigned long long*>(sums),
      static_cast<unsigned int*>(counts));
  return static_cast<int>(cudaGetLastError());
}
