/*
 * The port's stable C ABI over the native runtime.
 *
 * A copy of the reference's src/main/cpp/src/c_api.cpp with the same
 * srt_* names and signatures: opaque int64 handles, (type-id, scale)
 * schemas, thread-local last-error strings, the handle registry, the
 * route sentinels. What differs is the device half. The reference routes
 * a call to an exported StableHLO program when the PJRT engine holds one
 * for the call's shape; here the engine is the CUDA runtime
 * (device_engine.hpp, cuda_engine.cu), whose kernels are compiled into the
 * library, so every admissible call routes to the card once the engine
 * is up. There is no program registry: the srt_pjrt_* functions are
 * replaced by srt_cuda_init / _available / _device_count /
 * _platform_name, and a resident buffer's named program
 * (srt_device_buffer_kernel) is one of the engine's hashes.
 *
 * No fallback hides the device: a device call that fails records the
 * sentinel 2 and returns its error (CUDA's text); it never retries on
 * the host. A call the device route does not admit (nulls, a type it
 * does not take, a duplicate right key of a join) takes the host route
 * and records 0.
 *
 * Beyond the reference's ABI: srt_sort_order_device and
 * srt_convert_from_rows_device (the resident twins of the sort and
 * from-rows routes), srt_cuda_kernel_launches / _reset_kernel_launches /
 * _live_buffers, and srt_pack_plan (K6's plan, for tests).
 */
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <functional>
#include <limits>
#include <memory>
#include <mutex>
#include <stdexcept>
#include <string>
#include <unordered_map>
#include <vector>

#include "device_engine.hpp"
#include "pack_plan.hpp"
#include "srt/arena.hpp"
#include "srt/arrow_interop.hpp"
#include "srt/hashing.hpp"
#include "srt/relational.hpp"
#include "srt/resource_adaptor.hpp"
#include "srt/row_conversion.hpp"
#include "srt/table.hpp"
#include "srt/types.hpp"

namespace {

thread_local std::string g_last_error;

constexpr const char* kNoEngine = "CUDA engine not initialized";

struct handle_registry {
  std::mutex mu;
  std::unordered_map<int64_t, srt::owned_column_ptr> columns;
  std::unordered_map<int64_t, std::unique_ptr<srt::table>> tables;
  std::unordered_map<int64_t, srt::row_batch> batches;
  // per-table teardown hooks (e.g. Arrow release callbacks) run on free
  std::unordered_map<int64_t, std::function<void()>> table_cleanups;
  int64_t next = 1;

  static handle_registry& instance() {
    static handle_registry r;
    return r;
  }
};

template <typename F>
int guarded(F&& f) {
  try {
    f();
    return 0;
  } catch (const std::exception& e) {
    g_last_error = e.what();
    return -1;
  } catch (...) {
    g_last_error = "unknown native error";
    return -1;
  }
}

srt::data_type dt_of(int32_t id, int32_t scale) {
  return srt::data_type{static_cast<srt::type_id>(id), scale};
}

// The types the device hashes, sorts, joins and groups: those whose hash
// AND ordering semantics are those of their raw storage (the reference's
// pjrt_type_of, c_api.cpp:145-182). DECIMAL32 is absent: its storage is 4
// bytes but Spark hashes Decimal(p<=18) as a widened long (hashing.cpp
// kind_of).
bool hash_type_ok(const srt::data_type& d) {
  switch (d.id) {
    case srt::type_id::INT32:
    case srt::type_id::TIMESTAMP_DAYS:
    case srt::type_id::INT64:
    case srt::type_id::TIMESTAMP_MICROSECONDS:
    case srt::type_id::DECIMAL64:
    case srt::type_id::UINT32:
    case srt::type_id::UINT64:
    case srt::type_id::FLOAT32:
    case srt::type_id::FLOAT64:
      return true;
    default:
      return false;
  }
}

// The row routes take every fixed-width type: row bytes are raw storage.
bool rows_type_ok(const srt::data_type& d) {
  return srt::is_fixed_width(d.id) && d.id != srt::type_id::EMPTY;
}

// -- route provenance --------------------------------------------------------
// Whether the LAST execution of each kernel on this thread took the
// device route (1) or the host route (0); -1 = never ran; 2 = the last
// call FAILED on the device (device routes record it on every failure;
// resident entry points record it at entry and overwrite it on success).
enum route_kernel : int32_t {
  RK_MURMUR3 = 0,
  RK_XXHASH64,
  RK_TO_ROWS,
  RK_FROM_ROWS,
  RK_SORT_ORDER,
  RK_INNER_JOIN,
  RK_GROUPBY,
  RK_COUNT
};

constexpr const char* kRouteKernelNames[RK_COUNT] = {
    "murmur3", "xxhash64", "to_rows", "from_rows",
    "sort_order", "inner_join", "groupby"};

thread_local int32_t g_kernel_route[RK_COUNT] = {-1, -1, -1, -1, -1, -1, -1};

void note_route(route_kernel k, bool device) {
  g_kernel_route[k] = device ? 1 : 0;
}

void note_route_failed(route_kernel k) { g_kernel_route[k] = 2; }

// -- device plumbing ---------------------------------------------------------

void check_dev(bool ok) {
  if (!ok) throw std::runtime_error(srt::dev::last_error());
}

// An engine buffer destroyed with its scope.
struct dev_buffer {
  int64_t h = 0;
  explicit dev_buffer(int64_t handle) : h(handle) { check_dev(h != 0); }
  dev_buffer(const dev_buffer&) = delete;
  dev_buffer& operator=(const dev_buffer&) = delete;
  ~dev_buffer() {
    if (h != 0) srt::dev::destroy(h);
  }
  int64_t release() {
    int64_t out = h;
    h = 0;
    return out;
  }
};

// A host table's columns uploaded for one call.
struct uploaded_table {
  std::vector<srt::dev::column> cols;
  std::vector<std::unique_ptr<dev_buffer>> bufs;

  explicit uploaded_table(const srt::table& tbl) {
    for (const auto& col : tbl.columns) {
      const auto bytes = static_cast<std::size_t>(col.size) *
                         srt::size_of(col.dtype.id);
      bufs.push_back(
          std::make_unique<dev_buffer>(srt::dev::upload(col.data, bytes)));
      cols.push_back({bufs.back()->h, col.dtype});
    }
  }
};

// Runs a device route: the sentinel is 1 after it, or 2 and the error
// rethrown when it fails (no host retry).
template <typename F>
void on_device(route_kernel k, F&& f) {
  try {
    f();
  } catch (...) {
    note_route_failed(k);
    throw;
  }
  note_route(k, true);
}

bool engine_up() { return srt::dev::available(); }

// Host-table gate shared by the routes: the engine is up, the table has
// columns and rows, no column carries validity, and `type_ok` takes each.
template <typename P>
bool device_table_ok(const srt::table& tbl, P&& type_ok) {
  if (!engine_up() || tbl.columns.empty() || tbl.num_rows() <= 0) {
    return false;
  }
  for (const auto& col : tbl.columns) {
    if (col.validity != nullptr || col.is_string() || !type_ok(col.dtype)) {
      return false;
    }
  }
  return true;
}

// Relational key gate: device-typed and no float KEYS — the host (Spark)
// total order treats NaN == NaN and -0.0 == +0.0, which an order over raw
// bits does not (the reference's relational_sig_of_types).
bool key_type_ok(const srt::data_type& d) {
  return d.id != srt::type_id::FLOAT32 && d.id != srt::type_id::FLOAT64 &&
         hash_type_ok(d);
}

// Groupby value gate: device-typed and signed (the host kernel sums
// unsigned storage through signed casts).
bool value_type_ok(const srt::data_type& d) {
  return d.id != srt::type_id::UINT32 && d.id != srt::type_id::UINT64 &&
         hash_type_ok(d);
}

constexpr std::size_t kMaxDeviceKeys = 32;  // the probe kernel's key columns

// Fills a groupby_result from the engine's — ONE implementation for the
// host-table and resident routes, as the reference's
// fill_groupby_from_program. Values are non-null: count(col) == count(*).
void fill_groupby(const std::vector<srt::data_type>& vtypes,
                  const srt::dev::groupby_result& g,
                  srt::groupby_result* out) {
  const size_t nv = vtypes.size();
  const size_t ng = g.rep_rows.size();
  out->rep_rows.assign(g.rep_rows.begin(), g.rep_rows.end());
  out->group_sizes.assign(g.sizes.begin(), g.sizes.end());
  out->sum_is_float.resize(nv);
  out->isums.resize(nv);
  out->fsums.resize(nv);
  out->counts.resize(nv);
  out->imins.resize(nv);
  out->imaxs.resize(nv);
  out->fmins.resize(nv);
  out->fmaxs.resize(nv);
  out->means.resize(nv);
  auto as_doubles = [ng](const std::vector<int64_t>& bits) {
    std::vector<double> d(ng);
    if (ng) std::memcpy(d.data(), bits.data(), ng * sizeof(double));
    return d;
  };
  for (size_t i = 0; i < nv; ++i) {
    const bool isf = vtypes[i].id == srt::type_id::FLOAT32 ||
                     vtypes[i].id == srt::type_id::FLOAT64;
    out->sum_is_float[i] = isf ? 1 : 0;
    if (isf) {
      out->fsums[i] = as_doubles(g.sums[i]);
      out->fmins[i] = as_doubles(g.mins[i]);
      out->fmaxs[i] = as_doubles(g.maxs[i]);
      out->isums[i].assign(ng, 0);  // host zero-fills the inactive
      out->imins[i].assign(ng, 0);
      out->imaxs[i].assign(ng, 0);
    } else {
      out->isums[i] = g.sums[i];
      out->imins[i] = g.mins[i];
      out->imaxs[i] = g.maxs[i];
      out->fsums[i].assign(ng, 0.0);
      out->fmins[i].assign(ng, 0.0);
      out->fmaxs[i].assign(ng, 0.0);
    }
    out->counts[i].assign(g.sizes.begin(), g.sizes.end());
    out->means[i] = g.means[i];
  }
}

}  // namespace

extern "C" {

const char* srt_last_error() { return g_last_error.c_str(); }

// -- arena / observability ---------------------------------------------------

int64_t srt_arena_bytes_in_use() {
  return static_cast<int64_t>(srt::arena::instance().bytes_in_use());
}
int64_t srt_arena_peak_bytes() {
  return static_cast<int64_t>(srt::arena::instance().peak_bytes());
}
int64_t srt_arena_outstanding() {
  return static_cast<int64_t>(srt::arena::instance().outstanding());
}
void srt_arena_set_log_level(int32_t level) {
  srt::arena::instance().set_log_level(level);
}

// Handle-leak tracking: live handle count (refcount-debug analog).
int64_t srt_live_handles() {
  auto& reg = handle_registry::instance();
  std::lock_guard<std::mutex> lk(reg.mu);
  return static_cast<int64_t>(reg.columns.size() + reg.tables.size() +
                              reg.batches.size());
}

// -- layout ------------------------------------------------------------------

// Fills starts/sizes (caller-allocated, n entries); returns size_per_row
// or -1 on error.
int32_t srt_compute_fixed_width_layout(const int32_t* type_ids,
                                       const int32_t* scales, int32_t n,
                                       int32_t* starts, int32_t* sizes) {
  int32_t result = -1;
  int rc = guarded([&] {
    std::vector<srt::data_type> schema;
    for (int32_t i = 0; i < n; ++i)
      schema.push_back(dt_of(type_ids[i], scales ? scales[i] : 0));
    std::vector<int32_t> st, sz;
    result = srt::compute_fixed_width_layout(schema, st, sz);
    std::memcpy(starts, st.data(), n * sizeof(int32_t));
    std::memcpy(sizes, sz.data(), n * sizeof(int32_t));
  });
  return rc == 0 ? result : -1;
}

// K6's plan for n byte widths (pack_plan.hpp) into out (capacity cap
// int32): returns the number of words, or -1 (error or too small).
int32_t srt_pack_plan(const int32_t* widths, int32_t n, int32_t* out,
                      int32_t cap) {
  int32_t result = -1;
  guarded([&] {
    std::vector<int> w(widths, widths + n);
    auto words = srt::native::make_pack_plan(w).words();
    if (static_cast<int32_t>(words.size()) > cap) {
      throw std::invalid_argument("pack plan buffer too small");
    }
    std::memcpy(out, words.data(), words.size() * sizeof(int32_t));
    result = static_cast<int32_t>(words.size());
  });
  return result;
}

// -- table construction from caller buffers ---------------------------------

// Builds a table view over caller-owned buffers (no copy). data[i] points at
// size*size_of bytes; validity[i] may be null (all valid). Returns handle or 0.
int64_t srt_table_create(const int32_t* type_ids, const int32_t* scales,
                         int32_t n_cols, int32_t num_rows,
                         const void** data, const uint32_t** validity) {
  int64_t handle = 0;
  guarded([&] {
    auto tbl = std::make_unique<srt::table>();
    for (int32_t c = 0; c < n_cols; ++c) {
      srt::column col;
      col.dtype = dt_of(type_ids[c], scales ? scales[c] : 0);
      col.size = num_rows;
      // a 0-row column reads no bytes, so only require a buffer when
      // there are rows to back
      if (num_rows > 0 && (data == nullptr || data[c] == nullptr)) {
        throw std::invalid_argument("column needs a data buffer");
      }
      col.data = const_cast<void*>(data ? data[c] : nullptr);
      col.validity = const_cast<uint32_t*>(validity ? validity[c] : nullptr);
      tbl->columns.push_back(col);
    }
    auto& reg = handle_registry::instance();
    std::lock_guard<std::mutex> lk(reg.mu);
    handle = reg.next++;
    reg.tables[handle] = std::move(tbl);
  });
  return handle;
}

// Table creation including STRING columns: per-column parallel arrays
// where a string column passes (offsets[i], chars[i]) and data[i] = null,
// and a fixed-width column passes data[i] with null offsets/chars.
int64_t srt_table_create2(const int32_t* type_ids, const int32_t* scales,
                          int32_t n_cols, int32_t num_rows,
                          const void** data, const uint32_t** validity,
                          const int32_t** offsets, const uint8_t** chars) {
  int64_t handle = 0;
  guarded([&] {
    auto tbl = std::make_unique<srt::table>();
    for (int32_t c = 0; c < n_cols; ++c) {
      srt::column col;
      col.dtype = dt_of(type_ids[c], scales ? scales[c] : 0);
      col.size = num_rows;
      col.validity = const_cast<uint32_t*>(validity ? validity[c] : nullptr);
      if (col.dtype.id == srt::type_id::STRING) {
        if (offsets == nullptr || chars == nullptr ||
            offsets[c] == nullptr) {
          throw std::invalid_argument(
              "STRING column needs offsets (+chars) buffers");
        }
        col.offsets = offsets[c];
        col.chars = chars[c];  // may be null only when all strings empty
        if (col.chars == nullptr && offsets[c][num_rows] != 0) {
          throw std::invalid_argument(
              "STRING column with non-zero total length needs chars");
        }
      } else {
        if (num_rows > 0 && (data == nullptr || data[c] == nullptr)) {
          throw std::invalid_argument(
              "fixed-width column needs a data buffer");
        }
        col.data = const_cast<void*>(data ? data[c] : nullptr);
      }
      tbl->columns.push_back(col);
    }
    auto& reg = handle_registry::instance();
    std::lock_guard<std::mutex> lk(reg.mu);
    handle = reg.next++;
    reg.tables[handle] = std::move(tbl);
  });
  return handle;
}

void srt_table_free(int64_t handle) {
  std::function<void()> cleanup;
  {
    auto& reg = handle_registry::instance();
    std::lock_guard<std::mutex> lk(reg.mu);
    reg.tables.erase(handle);
    auto it = reg.table_cleanups.find(handle);
    if (it != reg.table_cleanups.end()) {
      cleanup = std::move(it->second);
      reg.table_cleanups.erase(it);
    }
  }
  // run outside the lock: Arrow release callbacks are producer code
  if (cleanup) cleanup();
}

// Imports an Arrow C-Data-Interface struct array as a zero-copy table
// view. Takes ownership of *array_ptr per the spec's move protocol: the
// producer's struct is moved and released exactly once, when the table
// handle is freed; *schema_ptr is consumed immediately. Returns a handle
// (> 0) or 0 with srt_last_error.
int64_t srt_table_from_arrow(void* schema_ptr, void* array_ptr) {
  int64_t handle = 0;
  guarded([&] {
    auto* schema = static_cast<ArrowSchema*>(schema_ptr);
    auto* array = static_cast<ArrowArray*>(array_ptr);
    if (schema == nullptr || array == nullptr ||
        schema->release == nullptr || array->release == nullptr) {
      throw std::invalid_argument(
          "arrow import: null or already-released schema/array");
    }
    try {
      auto imported = std::make_shared<srt::arrow::imported_table>(
          srt::arrow::import_table(*schema, *array));
      auto tbl = std::make_unique<srt::table>(imported->tbl);
      auto moved = std::make_shared<ArrowArray>(*array);
      array->release = nullptr;
      try {
        auto& reg = handle_registry::instance();
        std::lock_guard<std::mutex> lk(reg.mu);
        handle = reg.next++;
        reg.tables[handle] = std::move(tbl);
        reg.table_cleanups[handle] = [imported, moved] {
          if (moved->release != nullptr) moved->release(moved.get());
        };
      } catch (...) {
        if (moved->release != nullptr) moved->release(moved.get());
        throw;
      }
    } catch (...) {
      // the producer exported ownership to us; release even on rejection
      schema->release(schema);
      if (array->release != nullptr) array->release(array);
      throw;
    }
    schema->release(schema);
  });
  return handle;
}

// -- row conversion ----------------------------------------------------------

extern "C++" {
namespace {

srt::table* lookup_table(int64_t handle) {
  auto& reg = handle_registry::instance();
  std::lock_guard<std::mutex> lk(reg.mu);
  auto it = reg.tables.find(handle);
  return it == reg.tables.end() ? nullptr : it->second.get();
}

srt::table* table_at(int64_t handle) {
  srt::table* t = lookup_table(handle);
  if (t == nullptr) throw std::invalid_argument("unknown table handle");
  return t;
}

// Device route for to-rows: the table's columns go up once, K6 packs each
// batch of the host route's split (row_conversion.cpp: at most
// INT_MAX / size_per_row rows, a multiple of 32) and each comes back into
// an arena buffer, so the batches equal the host route's.
std::vector<srt::row_batch> to_rows_on_device(const srt::table& tbl) {
  std::vector<srt::data_type> schema;
  for (const auto& c : tbl.columns) schema.push_back(c.dtype);
  std::vector<int32_t> starts, sizes;
  const int32_t spr = srt::compute_fixed_width_layout(schema, starts, sizes);
  const int32_t n = tbl.num_rows();
  const int32_t per_batch =
      (std::numeric_limits<int32_t>::max() / spr) / 32 * 32;
  uploaded_table up(tbl);
  std::vector<srt::row_batch> out;
  try {
    for (int32_t row0 = 0; row0 < n; row0 += per_batch) {
      const int32_t count = n - row0 < per_batch ? n - row0 : per_batch;
      dev_buffer rows(srt::dev::to_rows(up.cols, row0, count));
      const auto bytes = static_cast<std::size_t>(count) * spr;
      auto* data =
          static_cast<uint8_t*>(srt::arena::instance().allocate(bytes));
      out.push_back(srt::row_batch{data, count, spr});
      check_dev(srt::dev::download(rows.h, data, bytes));
    }
  } catch (...) {
    for (auto& b : out) srt::arena::instance().deallocate(b.data);
    throw;
  }
  return out;
}

}  // namespace
}  // extern "C++"

// Converts a table to row batches. Returns the number of batches (written to
// out_handles, caller provides capacity max_batches), or -1.
int32_t srt_convert_to_rows(int64_t table_handle, int64_t* out_handles,
                            int32_t max_batches) {
  int32_t n_out = -1;
  guarded([&] {
    srt::table* tbl = table_at(table_handle);
    std::vector<srt::row_batch> batches;
    if (device_table_ok(*tbl, rows_type_ok)) {
      on_device(RK_TO_ROWS, [&] { batches = to_rows_on_device(*tbl); });
    } else {
      note_route(RK_TO_ROWS, false);
      batches = srt::convert_to_rows(*tbl);
    }
    auto& reg = handle_registry::instance();
    std::lock_guard<std::mutex> lk(reg.mu);
    if (static_cast<int32_t>(batches.size()) > max_batches) {
      for (auto& b : batches) srt::arena::instance().deallocate(b.data);
      throw std::runtime_error("too many batches");
    }
    n_out = 0;
    for (auto& b : batches) {
      int64_t h = reg.next++;
      reg.batches[h] = b;
      out_handles[n_out++] = h;
    }
  });
  return n_out;
}

int32_t srt_row_batch_num_rows(int64_t batch_handle) {
  auto& reg = handle_registry::instance();
  std::lock_guard<std::mutex> lk(reg.mu);
  auto it = reg.batches.find(batch_handle);
  return it == reg.batches.end() ? -1 : it->second.num_rows;
}

int32_t srt_row_batch_size_per_row(int64_t batch_handle) {
  auto& reg = handle_registry::instance();
  std::lock_guard<std::mutex> lk(reg.mu);
  auto it = reg.batches.find(batch_handle);
  return it == reg.batches.end() ? -1 : it->second.size_per_row;
}

const uint8_t* srt_row_batch_data(int64_t batch_handle) {
  auto& reg = handle_registry::instance();
  std::lock_guard<std::mutex> lk(reg.mu);
  auto it = reg.batches.find(batch_handle);
  return it == reg.batches.end() ? nullptr : it->second.data;
}

void srt_row_batch_free(int64_t batch_handle) {
  auto& reg = handle_registry::instance();
  srt::row_batch b{};
  {
    std::lock_guard<std::mutex> lk(reg.mu);
    auto it = reg.batches.find(batch_handle);
    if (it == reg.batches.end()) return;
    b = it->second;
    reg.batches.erase(it);
  }
  srt::arena::instance().deallocate(b.data);
}

extern "C++" {
namespace {

bool schema_rows_ok(const std::vector<srt::data_type>& schema) {
  if (schema.empty()) return false;
  for (const auto& d : schema) {
    if (!rows_type_ok(d)) return false;
  }
  return true;
}

// Device route for rows -> columns: the rows go up once, the engine's
// unpack kernel writes each column's data and validity words, and they
// come back into owned columns (the host decoder's layout: trailing
// validity bits 0).
std::vector<srt::owned_column_ptr> from_rows_on_device(
    const uint8_t* rows, int32_t num_rows,
    const std::vector<srt::data_type>& schema) {
  std::vector<int32_t> starts, sizes;
  const int32_t spr = srt::compute_fixed_width_layout(schema, starts, sizes);
  dev_buffer in(srt::dev::upload(
      rows, static_cast<std::size_t>(num_rows) * spr));
  std::vector<int64_t> outs;
  check_dev(srt::dev::from_rows(in.h, 0, num_rows, schema, &outs));
  std::vector<std::unique_ptr<dev_buffer>> held;
  for (int64_t b : outs) held.push_back(std::make_unique<dev_buffer>(b));
  const size_t nc = schema.size();
  const auto vbytes =
      static_cast<std::size_t>(srt::num_bitmask_words(num_rows)) * 4;
  std::vector<srt::owned_column_ptr> cols;
  for (size_t i = 0; i < nc; ++i) {
    cols.push_back(srt::make_owned_column(schema[i], num_rows,
                                          /*with_validity=*/true));
    check_dev(srt::dev::download(
        outs[i], cols[i]->view.data,
        static_cast<std::size_t>(num_rows) * srt::size_of(schema[i].id)));
    check_dev(srt::dev::download(outs[nc + i], cols[i]->view.validity,
                                 vbytes));
  }
  return cols;
}

}  // namespace
}  // extern "C++"

// 1 when this thread's last srt_convert_from_rows decoded on the device
// (legacy accessor; srt_kernel_was_device("from_rows") is the general
// form and distinguishes never-ran and failed).
int32_t srt_from_rows_was_device() {
  return g_kernel_route[RK_FROM_ROWS] == 1 ? 1 : 0;
}

// Route provenance: 1 = this thread's last <kernel> call ran on the
// device, 0 = host route, 2 = the last device call failed, -1 = never
// ran / unknown kernel. Kernels: murmur3, xxhash64, to_rows, from_rows,
// sort_order, inner_join, groupby.
int32_t srt_kernel_was_device(const char* kernel) {
  if (kernel == nullptr) return -1;
  for (int32_t k = 0; k < RK_COUNT; ++k) {
    if (std::strcmp(kernel, kRouteKernelNames[k]) == 0) {
      return g_kernel_route[k];
    }
  }
  return -1;
}

int32_t srt_convert_from_rows(const uint8_t* rows, int32_t num_rows,
                              const int32_t* type_ids, const int32_t* scales,
                              int32_t n_cols, int64_t* out_handles) {
  return guarded([&] {
    std::vector<srt::data_type> schema;
    for (int32_t i = 0; i < n_cols; ++i)
      schema.push_back(dt_of(type_ids[i], scales ? scales[i] : 0));
    std::vector<srt::owned_column_ptr> cols;
    if (engine_up() && num_rows > 0 && schema_rows_ok(schema)) {
      on_device(RK_FROM_ROWS,
                [&] { cols = from_rows_on_device(rows, num_rows, schema); });
    } else {
      note_route(RK_FROM_ROWS, false);
      cols = srt::convert_from_rows(rows, num_rows, schema);
    }
    auto& reg = handle_registry::instance();
    std::lock_guard<std::mutex> lk(reg.mu);
    for (int32_t i = 0; i < n_cols; ++i) {
      int64_t h = reg.next++;
      reg.columns[h] = std::move(cols[i]);
      out_handles[i] = h;
    }
  });
}

const void* srt_column_data(int64_t col_handle) {
  auto& reg = handle_registry::instance();
  std::lock_guard<std::mutex> lk(reg.mu);
  auto it = reg.columns.find(col_handle);
  return it == reg.columns.end() ? nullptr : it->second->view.data;
}

const uint32_t* srt_column_validity(int64_t col_handle) {
  auto& reg = handle_registry::instance();
  std::lock_guard<std::mutex> lk(reg.mu);
  auto it = reg.columns.find(col_handle);
  return it == reg.columns.end() ? nullptr : it->second->view.validity;
}

void srt_column_free(int64_t col_handle) {
  auto& reg = handle_registry::instance();
  std::lock_guard<std::mutex> lk(reg.mu);
  reg.columns.erase(col_handle);
}

// -- the CUDA engine ---------------------------------------------------------

// Starts the engine on CUDA device `device` (the runtime's primary
// context, shared with any other user of the runtime in the process).
// Returns 0, or -1 with srt_last_error.
int32_t srt_cuda_init(int32_t device) {
  if (srt::dev::init(device)) return 0;
  g_last_error = srt::dev::last_error();
  return -1;
}

int32_t srt_cuda_available() { return srt::dev::available() ? 1 : 0; }

int32_t srt_cuda_device_count() { return srt::dev::device_count(); }

const char* srt_cuda_platform_name() {
  thread_local std::string name;
  name = srt::dev::platform_name();
  return name.c_str();
}

// __global__ launches of one kernel name since the last reset (the
// analog of ops/cuda_kernels.py LAUNCHES; K4 "murmur3_int32", K5
// "murmur3_int64", K6 "pack_rows", and the engine's own kernels).
int64_t srt_cuda_kernel_launches(const char* name) {
  return name == nullptr ? 0 : srt::dev::launches(name);
}

// The names srt_cuda_kernel_launches knows, comma-separated.
const char* srt_cuda_kernel_names() {
  thread_local std::string joined;
  joined.clear();
  for (const auto& n : srt::dev::launch_names()) {
    if (!joined.empty()) joined.push_back(',');
    joined += n;
  }
  return joined.c_str();
}

void srt_cuda_reset_kernel_launches() { srt::dev::reset_launches(); }

// Engine buffers alive (resident columns and results): the device half's
// leak check beside srt_live_device_handles.
int64_t srt_cuda_live_buffers() { return srt::dev::live_buffers(); }

// -- device-resident tables ---------------------------------------------------
// Columnar data lives on the device across calls and only 8-byte handles
// cross the language boundary (reference: RowConversionJni.cpp:36,63).
// srt_table_to_device uploads a host table's columns ONCE; the *_device
// entry points run the engine's kernels over the resident buffers with no
// per-call transfer of table data; srt_device_buffer_fetch pulls results.

extern "C++" {
namespace {

struct device_table {
  std::vector<int64_t> col_buffers;  // engine buffer handles, one a column
  std::vector<srt::data_type> dtypes;
  srt::size_type num_rows = 0;

  std::vector<srt::dev::column> cols() const {
    std::vector<srt::dev::column> out;
    for (size_t i = 0; i < col_buffers.size(); ++i) {
      out.push_back({col_buffers[i], dtypes[i]});
    }
    return out;
  }
};

struct device_table_registry {
  std::mutex mu;
  std::unordered_map<int64_t, device_table> tables;
  int64_t next = 1;

  static device_table_registry& instance() {
    static device_table_registry r;
    return r;
  }
};

bool find_device_table(int64_t handle, device_table* out) {
  auto& reg = device_table_registry::instance();
  std::lock_guard<std::mutex> lk(reg.mu);
  auto it = reg.tables.find(handle);
  if (it == reg.tables.end()) return false;
  *out = it->second;  // copies the small handle/dtype vectors
  return true;
}

// The resident entry points' shared frame: failed-until-proven sentinel
// (every early return leaves 2), the engine check, and the table lookup.
// Returns 0 with srt_last_error set, or what `run` returns (> 0), with the
// sentinel 1.
template <typename F>
int64_t resident(route_kernel k, F&& run) {
  note_route_failed(k);
  if (!engine_up()) {
    g_last_error = kNoEngine;
    return 0;
  }
  int64_t h = 0;
  if (guarded([&] { h = run(); }) != 0) return 0;
  note_route(k, true);
  return h;
}

device_table resident_table(int64_t handle) {
  device_table dt;
  if (!find_device_table(handle, &dt)) {
    throw std::invalid_argument("unknown device table handle");
  }
  return dt;
}

void require_types(const std::vector<srt::data_type>& types,
                   bool (*ok)(const srt::data_type&), const char* why) {
  if (types.empty()) throw std::invalid_argument(why);
  for (const auto& d : types) {
    if (!ok(d)) throw std::invalid_argument(why);
  }
}

int64_t resident_hash(route_kernel k, int64_t dev_table, int64_t seed) {
  return resident(k, [&] {
    device_table dt = resident_table(dev_table);
    require_types(dt.dtypes, hash_type_ok,
                  "device table schema has no device-typed signature");
    int64_t out = k == RK_MURMUR3
                      ? srt::dev::murmur3(dt.cols(), dt.num_rows,
                                          static_cast<int32_t>(seed))
                      : srt::dev::xxhash64(dt.cols(), dt.num_rows, seed);
    check_dev(out != 0);
    return out;
  });
}

}  // namespace
}  // extern "C++"

// Uploads a host table's columns to the device. All columns must be
// fixed-width and non-null (any fixed-width type: the row routes take
// them all; the hashes and relational routes check their own types).
// Returns a device table handle (> 0) or 0 with srt_last_error set.
int64_t srt_table_to_device(int64_t table_handle) {
  if (!engine_up()) {
    g_last_error = kNoEngine;
    return 0;
  }
  int64_t h = 0;
  guarded([&] {
    srt::table* tbl = table_at(table_handle);
    for (const auto& col : tbl->columns) {
      if (col.validity != nullptr || col.is_string() ||
          !rows_type_ok(col.dtype)) {
        throw std::invalid_argument(
            "column not device-typed (fixed-width, non-null only)");
      }
    }
    uploaded_table up(*tbl);
    device_table dt;
    dt.num_rows = tbl->num_rows();
    for (auto& b : up.bufs) dt.col_buffers.push_back(b->release());
    for (const auto& c : tbl->columns) dt.dtypes.push_back(c.dtype);
    auto& reg = device_table_registry::instance();
    std::lock_guard<std::mutex> lk(reg.mu);
    h = reg.next++;
    reg.tables[h] = std::move(dt);
  });
  return h;
}

void srt_device_table_free(int64_t handle) {
  device_table dt;
  {
    auto& reg = device_table_registry::instance();
    std::lock_guard<std::mutex> lk(reg.mu);
    auto it = reg.tables.find(handle);
    if (it == reg.tables.end()) return;
    dt = std::move(it->second);
    reg.tables.erase(it);
  }
  for (int64_t b : dt.col_buffers) srt::dev::destroy(b);
}

int32_t srt_device_table_num_rows(int64_t handle) {
  device_table dt;
  return find_device_table(handle, &dt) ? dt.num_rows : -1;
}

int64_t srt_live_device_handles() {
  auto& reg = device_table_registry::instance();
  std::lock_guard<std::mutex> lk(reg.mu);
  return static_cast<int64_t>(reg.tables.size());
}

// Device-resident kernels: return a device buffer handle (> 0) holding the
// result column (murmur3: i32, xxhash64: i64, sort: i32 row indices) or
// packed row bytes (to_rows), or 0 with srt_last_error set. No host
// transfer of table data happens.
int64_t srt_murmur3_table_device(int64_t dev_table, int32_t seed) {
  return resident_hash(RK_MURMUR3, dev_table, seed);
}

int64_t srt_xxhash64_table_device(int64_t dev_table, int64_t seed) {
  return resident_hash(RK_XXHASH64, dev_table, seed);
}

int64_t srt_convert_to_rows_device(int64_t dev_table) {
  return resident(RK_TO_ROWS, [&] {
    device_table dt = resident_table(dev_table);
    require_types(dt.dtypes, rows_type_ok, "device table has no columns");
    if (dt.num_rows <= 0) throw std::invalid_argument("device table is empty");
    int64_t out = srt::dev::to_rows(dt.cols(), 0, dt.num_rows);
    check_dev(out != 0);
    return out;
  });
}

// Stable lexicographic argsort of a resident key table (the resident twin
// of srt_sort_order's device route; integral keys only, as there).
// ascending: n_flags byte flags (null + 0 = all ascending).
int64_t srt_sort_order_device(int64_t dev_table, const uint8_t* ascending,
                              int32_t n_flags) {
  return resident(RK_SORT_ORDER, [&] {
    device_table dt = resident_table(dev_table);
    require_types(dt.dtypes, key_type_ok,
                  "sort keys not device-routable (float keys are "
                  "host-only: Spark NaN order)");
    if (ascending != nullptr &&
        static_cast<size_t>(n_flags) != dt.dtypes.size()) {
      throw std::invalid_argument(
          "sort flag arrays must have one entry per key column");
    }
    std::vector<uint8_t> asc;
    if (ascending != nullptr) asc.assign(ascending, ascending + n_flags);
    int64_t out = srt::dev::sort_order(dt.cols(), dt.num_rows, asc);
    check_dev(out != 0);
    return out;
  });
}

// Rows -> columns over a RESIDENT rows buffer (e.g. srt_convert_to_rows_device's
// result): writes 2 * n_cols buffer handles to out_bufs, each column's
// data then each column's validity words. Returns 0 / -1.
int32_t srt_convert_from_rows_device(int64_t rows_buf, int32_t num_rows,
                                     const int32_t* type_ids,
                                     const int32_t* scales, int32_t n_cols,
                                     int64_t* out_bufs) {
  int64_t ok = resident(RK_FROM_ROWS, [&]() -> int64_t {
    std::vector<srt::data_type> schema;
    for (int32_t i = 0; i < n_cols; ++i)
      schema.push_back(dt_of(type_ids[i], scales ? scales[i] : 0));
    if (!schema_rows_ok(schema) || num_rows <= 0) {
      throw std::invalid_argument(
          "from_rows_device needs rows of a fixed-width schema");
    }
    std::vector<int32_t> starts, sizes;
    const int32_t spr =
        srt::compute_fixed_width_layout(schema, starts, sizes);
    if (srt::dev::buffer_bytes(rows_buf) <
        static_cast<int64_t>(num_rows) * spr) {
      throw std::invalid_argument("rows buffer smaller than num_rows rows");
    }
    std::vector<int64_t> outs;
    check_dev(srt::dev::from_rows(rows_buf, 0, num_rows, schema, &outs));
    std::copy(outs.begin(), outs.end(), out_bufs);
    return 1;
  });
  return ok ? 0 : -1;
}

// Runs one of the engine's hashes over a resident buffer named like the
// reference's programs, "<kernel>:<sig>:<N>" (program_key,
// c_api.cpp:187): kernel murmur3 or xxhash64, sig one type character
// (i l u v f d), N the buffer's values; the seed is 42, the hashes'
// default. Any other name fails with the reference's "no AOT program"
// error: the engine compiles no programs.
int64_t srt_device_buffer_kernel(const char* program_name, int64_t in_buf) {
  const std::string name = program_name ? program_name : "";
  const auto c1 = name.find(':');
  const auto c2 = c1 == std::string::npos ? c1 : name.find(':', c1 + 1);
  const std::string kernel = name.substr(0, c1);
  route_kernel k = kernel == "murmur3"    ? RK_MURMUR3
                   : kernel == "xxhash64" ? RK_XXHASH64
                                          : RK_COUNT;
  srt::data_type dt{};
  bool known = k != RK_COUNT && c2 == c1 + 2;
  if (known) {
    switch (name[c1 + 1]) {
      case 'i': dt.id = srt::type_id::INT32; break;
      case 'l': dt.id = srt::type_id::INT64; break;
      case 'u': dt.id = srt::type_id::UINT32; break;
      case 'v': dt.id = srt::type_id::UINT64; break;
      case 'f': dt.id = srt::type_id::FLOAT32; break;
      case 'd': dt.id = srt::type_id::FLOAT64; break;
      default: known = false;
    }
  }
  int64_t n = -1;
  if (known) {
    try {
      size_t used = 0;
      n = std::stoll(name.substr(c2 + 1), &used);
      known = used == name.size() - c2 - 1 && n > 0 &&
              n <= std::numeric_limits<int32_t>::max();
    } catch (...) {
      known = false;
    }
  }
  if (!known) {
    g_last_error = "no AOT program registered for " + name +
                   " (the CUDA engine serves murmur3:<sig>:<N> and "
                   "xxhash64:<sig>:<N>)";
    return 0;
  }
  return resident(k, [&] {
    if (srt::dev::buffer_bytes(in_buf) != n * srt::size_of(dt.id)) {
      throw std::invalid_argument(name + " does not match the buffer's " +
                                  std::to_string(srt::dev::buffer_bytes(in_buf)) +
                                  " bytes");
    }
    std::vector<srt::dev::column> cols{{in_buf, dt}};
    const auto rows = static_cast<int32_t>(n);
    int64_t out = k == RK_MURMUR3 ? srt::dev::murmur3(cols, rows, 42)
                                  : srt::dev::xxhash64(cols, rows, 42);
    check_dev(out != 0);
    return out;
  });
}

int64_t srt_device_buffer_bytes(int64_t buf) {
  return srt::dev::buffer_bytes(buf);
}

int32_t srt_device_buffer_fetch(int64_t buf, void* dst, int64_t capacity) {
  if (!srt::dev::download(buf, dst, static_cast<std::size_t>(capacity))) {
    g_last_error = srt::dev::last_error();
    return -1;
  }
  return 0;
}

void srt_device_buffer_free(int64_t buf) { srt::dev::destroy(buf); }

// -- hashing -----------------------------------------------------------------

int32_t srt_murmur3_table(int64_t table_handle, int32_t seed, int32_t* out) {
  return guarded([&] {
    srt::table* tbl = table_at(table_handle);
    if (device_table_ok(*tbl, hash_type_ok)) {
      on_device(RK_MURMUR3, [&] {
        uploaded_table up(*tbl);
        const int32_t n = tbl->num_rows();
        dev_buffer h(srt::dev::murmur3(up.cols, n, seed));
        check_dev(srt::dev::download(h.h, out,
                                     static_cast<std::size_t>(n) * 4));
      });
      return;
    }
    note_route(RK_MURMUR3, false);
    srt::murmur3_table(*tbl, seed, out);
  });
}

int32_t srt_xxhash64_table(int64_t table_handle, int64_t seed, int64_t* out) {
  return guarded([&] {
    srt::table* tbl = table_at(table_handle);
    if (device_table_ok(*tbl, hash_type_ok)) {
      on_device(RK_XXHASH64, [&] {
        uploaded_table up(*tbl);
        const int32_t n = tbl->num_rows();
        dev_buffer h(srt::dev::xxhash64(up.cols, n, seed));
        check_dev(srt::dev::download(h.h, out,
                                     static_cast<std::size_t>(n) * 8));
      });
      return;
    }
    note_route(RK_XXHASH64, false);
    srt::xxhash64_table(*tbl, seed, out);
  });
}

int32_t srt_hive_hash_table(int64_t table_handle, int32_t* out) {
  return guarded([&] { srt::hive_hash_table(*table_at(table_handle), out); });
}

// -- relational kernels (sort / join / groupby) -------------------------------
// Handles in, handles out, data stays native; results with data-dependent
// sizes use the handle + accessor + free pattern (like row batches).

extern "C++" {
namespace {

struct join_result {
  std::vector<srt::size_type> left;
  std::vector<srt::size_type> right;
  bool has_right = true;  // false for semi/anti (left-only) results
};

struct relational_registry {
  std::mutex mu;
  std::unordered_map<int64_t, join_result> joins;
  std::unordered_map<int64_t, srt::groupby_result> groupbys;
  int64_t next = 1;

  static relational_registry& instance() {
    static relational_registry r;
    return r;
  }
};

int64_t keep_join(join_result&& jr) {
  auto& reg = relational_registry::instance();
  std::lock_guard<std::mutex> lk(reg.mu);
  int64_t h = reg.next++;
  reg.joins[h] = std::move(jr);
  return h;
}

int64_t keep_groupby(srt::groupby_result&& gr) {
  auto& reg = relational_registry::instance();
  std::lock_guard<std::mutex> lk(reg.mu);
  int64_t h = reg.next++;
  reg.groupbys[h] = std::move(gr);
  return h;
}

bool same_schema(const std::vector<srt::data_type>& a,
                 const std::vector<srt::data_type>& b) {
  if (a.size() != b.size()) return false;
  for (size_t c = 0; c < a.size(); ++c) {
    if (a[c].id != b[c].id || a[c].scale != b[c].scale) return false;
  }
  return true;
}

std::vector<srt::data_type> types_of(const srt::table& t) {
  std::vector<srt::data_type> out;
  for (const auto& c : t.columns) out.push_back(c.dtype);
  return out;
}

}  // namespace
}  // extern "C++"

// Table introspection for binding layers that hold only the handle.
int32_t srt_table_num_rows(int64_t handle) {
  srt::table* t = lookup_table(handle);
  return t == nullptr ? -1 : t->num_rows();
}

int32_t srt_table_num_columns(int64_t handle) {
  srt::table* t = lookup_table(handle);
  return t == nullptr ? -1 : static_cast<int32_t>(t->columns.size());
}

// Stable lexicographic argsort of the key table. ascending/nulls_first
// are per-column byte flags sized n_flags each (null pointer + n_flags 0
// = all ascending / nulls first); n_flags must equal the column count.
// Writes num_rows indices into out. Returns 0 / -1. Routes to the device
// for non-null integral keys (float keys stay on the host: Spark's NaN
// and -0.0 order); nulls_first is irrelevant there.
int32_t srt_sort_order(int64_t keys_handle, const uint8_t* ascending,
                       const uint8_t* nulls_first, int32_t n_flags,
                       int32_t* out) {
  return guarded([&] {
    srt::table* keys = table_at(keys_handle);
    size_t nc = keys->columns.size();
    if ((ascending != nullptr || nulls_first != nullptr) &&
        static_cast<size_t>(n_flags) != nc) {
      throw std::invalid_argument(
          "sort flag arrays must have one entry per key column");
    }
    std::vector<uint8_t> asc(ascending ? std::vector<uint8_t>(
                                             ascending, ascending + nc)
                                       : std::vector<uint8_t>());
    std::vector<uint8_t> nf(nulls_first ? std::vector<uint8_t>(
                                              nulls_first, nulls_first + nc)
                                        : std::vector<uint8_t>());
    if (device_table_ok(*keys, key_type_ok)) {
      on_device(RK_SORT_ORDER, [&] {
        uploaded_table up(*keys);
        const int32_t n = keys->num_rows();
        dev_buffer perm(srt::dev::sort_order(up.cols, n, asc));
        check_dev(srt::dev::download(perm.h, out,
                                     static_cast<std::size_t>(n) * 4));
      });
      return;
    }
    note_route(RK_SORT_ORDER, false);
    auto order = srt::sort_order(*keys, asc, nf);
    std::memcpy(out, order.data(), order.size() * sizeof(int32_t));
  });
}

// Inner equi-join on ALL columns of the key tables (pass key-projected
// tables, cudf-style). Returns a join-result handle (> 0) or 0 + error.
// Routes to the device under the reference program's unique-right
// contract (export_stablehlo.py:23-32): a left row that matches more than
// one right row sends the call to the host route (sentinel 0).
int64_t srt_inner_join(int64_t left_handle, int64_t right_handle) {
  int64_t h = 0;
  guarded([&] {
    srt::table* l = table_at(left_handle);
    srt::table* r = table_at(right_handle);
    join_result jr;
    bool done = false;
    if (device_table_ok(*l, key_type_ok) && device_table_ok(*r, key_type_ok) &&
        same_schema(types_of(*l), types_of(*r)) &&
        l->columns.size() <= kMaxDeviceKeys) {
      srt::dev::join_result dj;
      on_device(RK_INNER_JOIN, [&] {
        uploaded_table ul(*l), ur(*r);
        check_dev(srt::dev::inner_join(ul.cols, l->num_rows(), ur.cols,
                                       r->num_rows(), &dj));
      });
      if (!dj.overflow) {
        jr.left = std::move(dj.left);
        jr.right = std::move(dj.right);
        done = true;
      }
    }
    if (!done) {
      note_route(RK_INNER_JOIN, false);
      srt::inner_join(*l, *r, &jr.left, &jr.right);
    }
    h = keep_join(std::move(jr));
  });
  return h;
}

// Inner join over two RESIDENT tables under the unique-right contract.
// Returns a join-result handle readable through the srt_join_result_*
// accessors, or 0 + srt_last_error (float keys, schema mismatch, or a
// multi-match overflow — resident tables hold no host copy to fall back
// to, so overflow is an explicit error here).
int64_t srt_inner_join_device(int64_t dev_left, int64_t dev_right) {
  return resident(RK_INNER_JOIN, [&] {
    device_table lt = resident_table(dev_left);
    device_table rt = resident_table(dev_right);
    if (!same_schema(lt.dtypes, rt.dtypes)) {
      throw std::invalid_argument("join key schemas differ");
    }
    require_types(lt.dtypes, key_type_ok,
                  "join keys not device-routable (float keys are "
                  "host-only: Spark NaN order)");
    if (lt.dtypes.size() > kMaxDeviceKeys) {
      throw std::invalid_argument("too many join key columns for the device");
    }
    if (lt.num_rows <= 0 || rt.num_rows <= 0) {
      throw std::invalid_argument("inner_join_device: an empty table");
    }
    srt::dev::join_result dj;
    check_dev(srt::dev::inner_join(lt.cols(), lt.num_rows, rt.cols(),
                                   rt.num_rows, &dj));
    if (dj.overflow) {
      throw std::runtime_error(
          "inner_join_device: overflow: a left row matched more than one "
          "right row (unique-right contract)");
    }
    join_result jr;
    jr.left = std::move(dj.left);
    jr.right = std::move(dj.right);
    return keep_join(std::move(jr));
  });
}

// Left outer join: every left row appears; unmatched right index = -1.
int64_t srt_left_join(int64_t left_handle, int64_t right_handle) {
  int64_t h = 0;
  guarded([&] {
    join_result jr;
    srt::left_join(*table_at(left_handle), *table_at(right_handle),
                   &jr.left, &jr.right);
    h = keep_join(std::move(jr));
  });
  return h;
}

// Left semi (want_match=1) / anti (0): matching rows land in `left`,
// `right` stays empty.
int64_t srt_left_semi_anti_join(int64_t left_handle, int64_t right_handle,
                                int32_t want_match) {
  int64_t h = 0;
  guarded([&] {
    srt::table* l = table_at(left_handle);
    srt::table* r = table_at(right_handle);
    join_result jr;
    jr.left = want_match ? srt::left_semi_join(*l, *r)
                         : srt::left_anti_join(*l, *r);
    jr.has_right = false;
    h = keep_join(std::move(jr));
  });
  return h;
}

int64_t srt_join_result_size(int64_t handle) {
  auto& reg = relational_registry::instance();
  std::lock_guard<std::mutex> lk(reg.mu);
  auto it = reg.joins.find(handle);
  return it == reg.joins.end() ? -1
                               : static_cast<int64_t>(it->second.left.size());
}

const int32_t* srt_join_result_left(int64_t handle) {
  auto& reg = relational_registry::instance();
  std::lock_guard<std::mutex> lk(reg.mu);
  auto it = reg.joins.find(handle);
  return it == reg.joins.end() ? nullptr : it->second.left.data();
}

// 1 when the result carries right-side indices (pair joins), 0 for
// left-only (semi/anti) results, -1 for a bad handle.
int32_t srt_join_result_has_right(int64_t handle) {
  auto& reg = relational_registry::instance();
  std::lock_guard<std::mutex> lk(reg.mu);
  auto it = reg.joins.find(handle);
  return it == reg.joins.end() ? -1 : (it->second.has_right ? 1 : 0);
}

const int32_t* srt_join_result_right(int64_t handle) {
  auto& reg = relational_registry::instance();
  std::lock_guard<std::mutex> lk(reg.mu);
  auto it = reg.joins.find(handle);
  return it == reg.joins.end() ? nullptr : it->second.right.data();
}

void srt_join_result_free(int64_t handle) {
  auto& reg = relational_registry::instance();
  std::lock_guard<std::mutex> lk(reg.mu);
  reg.joins.erase(handle);
}

// Groupby over ALL key-table columns, aggregating every value-table
// column (sum dtype per Spark: int64 for integral, float64 for floating).
// Returns a groupby-result handle (> 0) or 0 + error. Routes to the
// device for non-null integral keys and non-null signed device-typed
// values: integral sums wrap in int64 and float sums accumulate in
// float64, each group's rows in input order, as the host route does.
int64_t srt_groupby(int64_t keys_handle, int64_t values_handle) {
  int64_t h = 0;
  guarded([&] {
    srt::table* k = table_at(keys_handle);
    srt::table* v = table_at(values_handle);
    srt::groupby_result gr;
    if (device_table_ok(*k, key_type_ok) &&
        device_table_ok(*v, value_type_ok) &&
        v->num_rows() == k->num_rows() &&
        k->columns.size() <= kMaxDeviceKeys) {
      on_device(RK_GROUPBY, [&] {
        uploaded_table uk(*k), uv(*v);
        srt::dev::groupby_result dg;
        check_dev(srt::dev::groupby(uk.cols, uv.cols, k->num_rows(), &dg));
        fill_groupby(types_of(*v), dg, &gr);
      });
    } else {
      note_route(RK_GROUPBY, false);
      gr = srt::groupby_sum_count(*k, *v);
    }
    h = keep_groupby(std::move(gr));
  });
  return h;
}

// Groupby over two RESIDENT tables (keys, values); only the per-group
// results come back. Returns a groupby-result handle for the
// srt_groupby_* accessors, or 0 + srt_last_error.
int64_t srt_groupby_device(int64_t dev_keys, int64_t dev_values) {
  return resident(RK_GROUPBY, [&] {
    device_table kt = resident_table(dev_keys);
    device_table vt = resident_table(dev_values);
    if (kt.num_rows != vt.num_rows || kt.num_rows <= 0) {
      throw std::invalid_argument(
          "groupby keys/values row counts differ or are empty");
    }
    require_types(kt.dtypes, key_type_ok,
                  "group keys not device-routable (float keys are "
                  "host-only: Spark NaN order)");
    if (kt.dtypes.size() > kMaxDeviceKeys) {
      throw std::invalid_argument("too many group key columns for the device");
    }
    require_types(vt.dtypes, value_type_ok,
                  "value columns must be device-typed and signed (the host "
                  "kernel sums unsigned storage through signed casts)");
    srt::dev::groupby_result dg;
    check_dev(srt::dev::groupby(kt.cols(), vt.cols(), kt.num_rows, &dg));
    srt::groupby_result gr;
    fill_groupby(vt.dtypes, dg, &gr);
    return keep_groupby(std::move(gr));
  });
}

int32_t srt_groupby_num_groups(int64_t handle) {
  auto& reg = relational_registry::instance();
  std::lock_guard<std::mutex> lk(reg.mu);
  auto it = reg.groupbys.find(handle);
  return it == reg.groupbys.end()
             ? -1
             : static_cast<int32_t>(it->second.rep_rows.size());
}

// Row index (into the ORIGINAL input) of each group's first occurrence —
// gather key values through these.
const int32_t* srt_groupby_rep_rows(int64_t handle) {
  auto& reg = relational_registry::instance();
  std::lock_guard<std::mutex> lk(reg.mu);
  auto it = reg.groupbys.find(handle);
  return it == reg.groupbys.end() ? nullptr : it->second.rep_rows.data();
}

const int64_t* srt_groupby_sizes(int64_t handle) {
  auto& reg = relational_registry::instance();
  std::lock_guard<std::mutex> lk(reg.mu);
  auto it = reg.groupbys.find(handle);
  return it == reg.groupbys.end() ? nullptr : it->second.group_sizes.data();
}

extern "C++" {
namespace {

// One accessor body for the per-value-column vectors of a groupby result.
template <typename T>
const T* groupby_column(int64_t handle, int32_t col,
                        std::vector<std::vector<T>> srt::groupby_result::*m) {
  auto& reg = relational_registry::instance();
  std::lock_guard<std::mutex> lk(reg.mu);
  auto it = reg.groupbys.find(handle);
  if (it == reg.groupbys.end() || col < 0 ||
      col >= static_cast<int32_t>((it->second.*m).size())) {
    return nullptr;
  }
  return (it->second.*m)[col].data();
}

}  // namespace
}  // extern "C++"

// 1 = sums for this value column are float64 (srt_groupby_fsums),
// 0 = int64 (srt_groupby_isums), -1 = bad handle/column.
int32_t srt_groupby_sum_is_float(int64_t handle, int32_t col) {
  auto& reg = relational_registry::instance();
  std::lock_guard<std::mutex> lk(reg.mu);
  auto it = reg.groupbys.find(handle);
  if (it == reg.groupbys.end() || col < 0 ||
      col >= static_cast<int32_t>(it->second.sum_is_float.size())) {
    return -1;
  }
  return it->second.sum_is_float[col];
}

const int64_t* srt_groupby_isums(int64_t handle, int32_t col) {
  return groupby_column(handle, col, &srt::groupby_result::isums);
}

const double* srt_groupby_fsums(int64_t handle, int32_t col) {
  return groupby_column(handle, col, &srt::groupby_result::fsums);
}

// min/max (widened: int64 for integral, double for floating — pick by
// srt_groupby_sum_is_float) and avg (double; NaN for all-null groups).
const int64_t* srt_groupby_imins(int64_t handle, int32_t col) {
  return groupby_column(handle, col, &srt::groupby_result::imins);
}

const int64_t* srt_groupby_imaxs(int64_t handle, int32_t col) {
  return groupby_column(handle, col, &srt::groupby_result::imaxs);
}

const double* srt_groupby_fmins(int64_t handle, int32_t col) {
  return groupby_column(handle, col, &srt::groupby_result::fmins);
}

const double* srt_groupby_fmaxs(int64_t handle, int32_t col) {
  return groupby_column(handle, col, &srt::groupby_result::fmaxs);
}

const double* srt_groupby_means(int64_t handle, int32_t col) {
  return groupby_column(handle, col, &srt::groupby_result::means);
}

const int64_t* srt_groupby_counts(int64_t handle, int32_t col) {
  return groupby_column(handle, col, &srt::groupby_result::counts);
}

void srt_groupby_free(int64_t handle) {
  auto& reg = relational_registry::instance();
  std::lock_guard<std::mutex> lk(reg.mu);
  reg.groupbys.erase(handle);
}

// ---------------------------------------------------------------------------
// Resource adaptor (SparkResourceAdaptor / RmmSpark analog)
// ---------------------------------------------------------------------------

void srt_ra_configure(int64_t pool_bytes) {
  srt::resource_adaptor::instance().configure(pool_bytes);
}

int64_t srt_ra_pool_bytes() {
  return srt::resource_adaptor::instance().pool_bytes();
}

int64_t srt_ra_in_use() { return srt::resource_adaptor::instance().in_use(); }

int64_t srt_ra_active_tasks() {
  return srt::resource_adaptor::instance().active_tasks();
}

void srt_ra_task_register(int64_t task_id) {
  srt::resource_adaptor::instance().task_register(task_id);
}

void srt_ra_task_done(int64_t task_id) {
  srt::resource_adaptor::instance().task_done(task_id);
}

void srt_ra_task_retry_done(int64_t task_id) {
  srt::resource_adaptor::instance().task_retry_done(task_id);
}

// Returns an alloc_status code: 0 OK, 1 RETRY_OOM, 2 SPLIT_AND_RETRY_OOM,
// 3 INVALID.
int32_t srt_ra_alloc(int64_t task_id, int64_t bytes, int64_t timeout_ms) {
  return static_cast<int32_t>(
      srt::resource_adaptor::instance().allocate(task_id, bytes, timeout_ms));
}

int32_t srt_ra_free(int64_t task_id, int64_t bytes) {
  return static_cast<int32_t>(
      srt::resource_adaptor::instance().deallocate(task_id, bytes));
}

// out: [allocated, peak, retry_oom, split_retry_oom, block_time_ms,
// blocked_count]; returns 0 on success, 3 for unknown task.
int32_t srt_ra_task_metrics(int64_t task_id, int64_t* out) {
  srt::task_metrics m;
  if (!srt::resource_adaptor::instance().get_metrics(task_id, &m)) return 3;
  out[0] = m.allocated;
  out[1] = m.peak;
  out[2] = m.retry_oom;
  out[3] = m.split_retry_oom;
  out[4] = m.block_time_ms;
  out[5] = m.blocked_count;
  return 0;
}

}  // extern "C"
