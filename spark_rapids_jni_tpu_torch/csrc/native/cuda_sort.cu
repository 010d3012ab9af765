// The one library primitive of the native engine: CUB's stable LSD radix
// sort of (uint64 key, int32 row) pairs. The reference computes these
// sorts with `lax.sort` outside any Pallas kernel (tools/
// export_stablehlo.py:131, :172), as the port leaves a plain product to
// torch.matmul. It sits in its own file so that its slow template
// instantiation compiles beside the engine's other sources, and so that
// one instantiation (64-bit keys; 4-byte keys sort on bits [0, 32)) serves
// every key type.

#include <cub/device/device_radix_sort.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace srt {
namespace native {

// With temp == nullptr, sets temp_bytes to what n pairs need. Stable:
// equal keys keep their input order.
cudaError_t radix_sort_pairs(void* temp, size_t& temp_bytes,
                             const uint64_t* keys_in, uint64_t* keys_out,
                             const int32_t* rows_in, int32_t* rows_out,
                             int n, int end_bit, cudaStream_t stream) {
  return cub::DeviceRadixSort::SortPairs(temp, temp_bytes, keys_in, keys_out,
                                         rows_in, rows_out, n, 0, end_bit,
                                         stream);
}

}  // namespace native
}  // namespace srt
