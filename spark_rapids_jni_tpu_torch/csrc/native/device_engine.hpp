/*
 * The device engine of the port's native library: the seam between the C
 * ABI (c_api.cpp) and the card.
 *
 * The reference library reaches its device through a PJRT plugin that
 * runs exported StableHLO programs (src/main/cpp/src/pjrt_engine.cpp).
 * The port's engine is the CUDA runtime itself (cuda_engine.cu): its
 * kernels are compiled into the library, so there is no program registry
 * and no compile step. A build without CUDA links no_device_engine.cpp
 * instead, where available() is false and every call fails cleanly.
 *
 * Buffers are device allocations named by int64 handles (> 0), owned by
 * the engine; the C ABI's resident tables hold them. Every kernel entry
 * below runs on the engine's one stream and returns after the stream has
 * drained, so a CUDA error is reported by the call that caused it:
 * 0 / false, with last_error() holding CUDA's text (an out-of-memory
 * error included). Calls are thread-safe; destroying a buffer waits for
 * the calls that use it.
 */
#pragma once

#include <cstddef>
#include <cstdint>
#include <string>
#include <vector>

#include "srt/types.hpp"

namespace srt {
namespace dev {

// A resident column: an engine buffer of n values of `dtype`.
struct column {
  int64_t buf = 0;
  data_type dtype{};
};

// -- engine ------------------------------------------------------------------

// Selects `device`, creates the engine's stream. Idempotent.
bool init(int32_t device);
bool available();
int32_t device_count();
std::string platform_name();
// The calling thread's last engine error.
std::string last_error();

// -- buffers -----------------------------------------------------------------

int64_t upload(const void* src, std::size_t bytes);  // 0 on error
bool download(int64_t buf, void* dst, std::size_t capacity);
int64_t buffer_bytes(int64_t buf);  // -1 for an unknown handle
void destroy(int64_t buf);
int64_t live_buffers();

// -- kernels -----------------------------------------------------------------
// The callers (c_api.cpp) admit only what these take: non-null columns of
// n > 0 rows; hashes over the types pjrt_type_of admits; the relational
// routes over integral keys (no floats).

// Spark murmur3 of each row, chained over the columns from `seed`
// (hashing.cpp murmur3_table): an int32 buffer of n values.
int64_t murmur3(const std::vector<column>& cols, int32_t n, int32_t seed);
// Spark xxhash64, chained the same way: an int64 buffer of n values.
int64_t xxhash64(const std::vector<column>& cols, int32_t n, int64_t seed);
// Rows [row0, row0 + count) of the columns in the row format
// (row_conversion.cpp convert_to_rows): count * size_per_row bytes.
int64_t to_rows(const std::vector<column>& cols, int32_t row0, int32_t count);
// n rows of `schema`'s layout starting `offset` bytes into `rows` ->
// 2 * schema.size() buffers: each column's data, then each column's
// validity words (convert_from_rows).
bool from_rows(int64_t rows, std::size_t offset, int32_t n,
               const std::vector<data_type>& schema,
               std::vector<int64_t>* out);
// Stable lexicographic argsort (relational.cpp sort_order without nulls):
// an int32 buffer of n row indices. `ascending` is empty (all ascending)
// or one flag a column.
int64_t sort_order(const std::vector<column>& keys, int32_t n,
                   const std::vector<uint8_t>& ascending);

// Unique-right inner join: pairs in the order srt::inner_join emits them
// (key order, left rows ascending within a key). `overflow` is set, and
// no pairs returned, when a left row matches more than one right row.
struct join_result {
  bool overflow = false;
  std::vector<int32_t> left, right;
};
bool inner_join(const std::vector<column>& left, int32_t nl,
                const std::vector<column>& right, int32_t nr,
                join_result* out);

// Groupby over all key columns (srt::groupby_sum_count without nulls):
// groups in first-occurrence order; per value column its sum, min and max
// (int64 for integral values, float64 bits for floats) and its mean.
struct groupby_result {
  std::vector<int32_t> rep_rows;
  std::vector<int64_t> sizes;
  std::vector<std::vector<int64_t>> sums, mins, maxs;  // float64 bits
  std::vector<std::vector<double>> means;
};
bool groupby(const std::vector<column>& keys,
             const std::vector<column>& values, int32_t n,
             groupby_result* out);

// -- launch counts -----------------------------------------------------------
// __global__ launches per kernel name since the last reset: K4
// "murmur3_int32", K5 "murmur3_int64", K6 "pack_rows" and the engine's own
// kernels; CUB's radix sort counts one "radix_sort" a sort call.
int64_t launches(const std::string& name);
std::vector<std::string> launch_names();
void reset_launches();

}  // namespace dev
}  // namespace srt
