/*
 * The device engine of a build without CUDA: nothing is available and
 * every call fails cleanly with the same error, so the C ABI's host-table
 * entry points take their host routes and its resident ones return 0.
 */
#include "device_engine.hpp"

namespace srt {
namespace dev {

namespace {
constexpr const char* kNoCuda =
    "CUDA engine not initialized: this library was built without CUDA";
}  // namespace

bool init(int32_t) { return false; }
bool available() { return false; }
int32_t device_count() { return 0; }
std::string platform_name() { return ""; }
std::string last_error() { return kNoCuda; }

int64_t upload(const void*, std::size_t) { return 0; }
bool download(int64_t, void*, std::size_t) { return false; }
int64_t buffer_bytes(int64_t) { return -1; }
void destroy(int64_t) {}
int64_t live_buffers() { return 0; }

int64_t murmur3(const std::vector<column>&, int32_t, int32_t) { return 0; }
int64_t xxhash64(const std::vector<column>&, int32_t, int64_t) { return 0; }
int64_t to_rows(const std::vector<column>&, int32_t, int32_t) { return 0; }
bool from_rows(int64_t, std::size_t, int32_t, const std::vector<data_type>&,
               std::vector<int64_t>*) {
  return false;
}
int64_t sort_order(const std::vector<column>&, int32_t,
                   const std::vector<uint8_t>&) {
  return 0;
}
bool inner_join(const std::vector<column>&, int32_t,
                const std::vector<column>&, int32_t, join_result*) {
  return false;
}
bool groupby(const std::vector<column>&, const std::vector<column>&, int32_t,
             groupby_result*) {
  return false;
}

int64_t launches(const std::string&) { return 0; }
std::vector<std::string> launch_names() { return {}; }
void reset_launches() {}

}  // namespace dev
}  // namespace srt
