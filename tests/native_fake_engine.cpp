/*
 * A stand-in for the port's CUDA engine (spark_rapids_jni_tpu_torch/
 * csrc/native/device_engine.hpp) that keeps its "device" buffers in host
 * memory and computes every route with the library's host kernels. Tests
 * link it in place of cuda_engine.cu to drive the C ABI's device half —
 * the engine start, the buffer registry, uploads and fetches, the route
 * sentinels, the resident entry points, the unique-right overflow — with
 * no card, as the reference's fake PJRT plugin does for its engine
 * (src/main/cpp/tests/fake_pjrt_plugin.cpp). Its launch counts name the
 * kernels the CUDA engine would launch: K4 "murmur3_int32" a 4-byte
 * column and K5 "murmur3_int64" an 8-byte column of a murmur3, K6
 * "pack_rows" a to_rows call.
 */
#include <cstring>
#include <map>
#include <mutex>
#include <stdexcept>
#include <vector>

#include "device_engine.hpp"
#include "srt/hashing.hpp"
#include "srt/relational.hpp"
#include "srt/row_conversion.hpp"
#include "srt/arena.hpp"
#include "srt/table.hpp"

namespace srt {
namespace dev {

namespace {

thread_local std::string t_error;

struct state {
  std::mutex mu;
  std::map<int64_t, std::vector<uint8_t>> buffers;
  std::map<std::string, int64_t> launches;
  int64_t next = 1;
  bool up = false;
};

state& S() {
  static state s;
  return s;
}

int64_t keep(std::vector<uint8_t> bytes) {
  std::lock_guard<std::mutex> lk(S().mu);
  int64_t h = S().next++;
  S().buffers[h] = std::move(bytes);
  return h;
}

std::vector<uint8_t>& at(int64_t h) {
  std::lock_guard<std::mutex> lk(S().mu);
  auto it = S().buffers.find(h);
  if (it == S().buffers.end()) {
    throw std::runtime_error("unknown device buffer handle " +
                             std::to_string(h));
  }
  return it->second;
}

void count(const std::string& name) {
  std::lock_guard<std::mutex> lk(S().mu);
  ++S().launches[name];
}

table view(const std::vector<column>& cols, int32_t n, int32_t row0 = 0) {
  table t;
  for (const auto& c : cols) {
    srt::column col;
    col.dtype = c.dtype;
    col.size = n;
    col.data = at(c.buf).data() + static_cast<size_t>(row0) *
                                      srt::size_of(c.dtype.id);
    t.columns.push_back(col);
  }
  return t;
}

template <typename T>
std::vector<uint8_t> bytes_of(const T* p, size_t n) {
  const auto* b = reinterpret_cast<const uint8_t*>(p);
  return std::vector<uint8_t>(b, b + n * sizeof(T));
}

template <typename F>
bool call(F&& f) {
  if (!S().up) {
    t_error = "CUDA engine not initialized";
    return false;
  }
  try {
    f();
    return true;
  } catch (const std::exception& e) {
    t_error = e.what();
    return false;
  }
}

}  // namespace

bool init(int32_t) {
  S().up = true;
  return true;
}
bool available() { return S().up; }
int32_t device_count() { return 1; }
std::string platform_name() { return S().up ? "host stand-in" : ""; }
std::string last_error() { return t_error; }

int64_t upload(const void* src, std::size_t bytes) {
  int64_t h = 0;
  call([&] {
    const auto* b = static_cast<const uint8_t*>(src);
    h = keep(std::vector<uint8_t>(b, b + bytes));
  });
  return h;
}

bool download(int64_t buf, void* dst, std::size_t capacity) {
  return call([&] {
    auto& b = at(buf);
    if (capacity < b.size()) throw std::runtime_error("destination too small");
    if (!b.empty()) std::memcpy(dst, b.data(), b.size());
  });
}

int64_t buffer_bytes(int64_t buf) {
  std::lock_guard<std::mutex> lk(S().mu);
  auto it = S().buffers.find(buf);
  return it == S().buffers.end() ? -1 : static_cast<int64_t>(it->second.size());
}

void destroy(int64_t buf) {
  std::lock_guard<std::mutex> lk(S().mu);
  S().buffers.erase(buf);
}

int64_t live_buffers() {
  std::lock_guard<std::mutex> lk(S().mu);
  return static_cast<int64_t>(S().buffers.size());
}

int64_t murmur3(const std::vector<column>& cols, int32_t n, int32_t seed) {
  int64_t h = 0;
  call([&] {
    std::vector<int32_t> out(n);
    srt::murmur3_table(view(cols, n), seed, out.data());
    for (const auto& c : cols) {
      count(srt::size_of(c.dtype.id) == 4 ? "murmur3_int32" : "murmur3_int64");
    }
    h = keep(bytes_of(out.data(), out.size()));
  });
  return h;
}

int64_t xxhash64(const std::vector<column>& cols, int32_t n, int64_t seed) {
  int64_t h = 0;
  call([&] {
    std::vector<int64_t> out(n);
    srt::xxhash64_table(view(cols, n), seed, out.data());
    count("xxhash64");
    h = keep(bytes_of(out.data(), out.size()));
  });
  return h;
}

int64_t to_rows(const std::vector<column>& cols, int32_t row0,
                int32_t count_rows) {
  int64_t h = 0;
  call([&] {
    std::vector<uint8_t> all;
    for (auto& b : srt::convert_to_rows(view(cols, count_rows, row0))) {
      all.insert(all.end(), b.data,
                 b.data + static_cast<size_t>(b.num_rows) * b.size_per_row);
      srt::arena::instance().deallocate(b.data);
    }
    count("pack_rows");
    h = keep(std::move(all));
  });
  return h;
}

bool from_rows(int64_t rows, std::size_t offset, int32_t n,
               const std::vector<data_type>& schema,
               std::vector<int64_t>* out) {
  std::vector<int64_t> made;
  bool ok = call([&] {
    auto cols = srt::convert_from_rows(at(rows).data() + offset, n, schema);
    std::vector<int64_t> valid;
    for (size_t i = 0; i < schema.size(); ++i) {
      made.push_back(keep(bytes_of(
          static_cast<const uint8_t*>(cols[i]->view.data),
          static_cast<size_t>(n) * srt::size_of(schema[i].id))));
      valid.push_back(keep(bytes_of(cols[i]->view.validity,
                                    srt::num_bitmask_words(n))));
    }
    made.insert(made.end(), valid.begin(), valid.end());
    count("unpack_rows");
  });
  if (ok) *out = std::move(made);
  return ok;
}

int64_t sort_order(const std::vector<column>& keys, int32_t n,
                   const std::vector<uint8_t>& ascending) {
  int64_t h = 0;
  call([&] {
    auto order = srt::sort_order(view(keys, n), ascending, {});
    count("radix_sort");
    h = keep(bytes_of(order.data(), order.size()));
  });
  return h;
}

bool inner_join(const std::vector<column>& left, int32_t nl,
                const std::vector<column>& right, int32_t nr,
                join_result* out) {
  join_result r;
  bool ok = call([&] {
    std::vector<int32_t> li, ri;
    srt::inner_join(view(left, nl), view(right, nr), &li, &ri);
    std::vector<uint8_t> seen(nl, 0);
    for (int32_t l : li) {
      if (seen[l]++) r.overflow = true;
    }
    count("join_probe");
    if (!r.overflow) {
      r.left = std::move(li);
      r.right = std::move(ri);
    }
  });
  if (ok) *out = std::move(r);
  return ok;
}

bool groupby(const std::vector<column>& keys,
             const std::vector<column>& values, int32_t n,
             groupby_result* out) {
  groupby_result g;
  bool ok = call([&] {
    auto h = srt::groupby_sum_count(view(keys, n), view(values, n));
    g.rep_rows = h.rep_rows;
    g.sizes = h.group_sizes;
    for (size_t v = 0; v < values.size(); ++v) {
      auto bits = [](const std::vector<double>& d) {
        std::vector<int64_t> b(d.size());
        if (!d.empty()) std::memcpy(b.data(), d.data(), d.size() * 8);
        return b;
      };
      const bool isf = h.sum_is_float[v] != 0;
      g.sums.push_back(isf ? bits(h.fsums[v]) : h.isums[v]);
      g.mins.push_back(isf ? bits(h.fmins[v]) : h.imins[v]);
      g.maxs.push_back(isf ? bits(h.fmaxs[v]) : h.imaxs[v]);
      g.means.push_back(h.means[v]);
    }
    count("group_aggregate");
  });
  if (ok) *out = std::move(g);
  return ok;
}

int64_t launches(const std::string& name) {
  std::lock_guard<std::mutex> lk(S().mu);
  auto it = S().launches.find(name);
  return it == S().launches.end() ? 0 : it->second;
}

std::vector<std::string> launch_names() {
  std::lock_guard<std::mutex> lk(S().mu);
  std::vector<std::string> out;
  for (const auto& kv : S().launches) out.push_back(kv.first);
  return out;
}

void reset_launches() {
  std::lock_guard<std::mutex> lk(S().mu);
  S().launches.clear();
}

}  // namespace dev
}  // namespace srt
