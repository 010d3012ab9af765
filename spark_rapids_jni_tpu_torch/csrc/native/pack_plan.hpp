/*
 * K6's plan for a schema of byte widths: the C++ copy of
 * spark_rapids_jni_tpu_torch/ops/cuda_kernels.py `pack_plan`, which
 * csrc/pack_rows.cu's `srt_pack_rows` reads. The two must give the same
 * words for every schema (tests/test_torch_native.py holds them equal
 * through `srt_pack_plan`).
 */
#pragma once

#include <algorithm>
#include <array>
#include <cstdint>
#include <stdexcept>
#include <vector>

namespace srt {
namespace native {

constexpr int kPackSmemBytes = 110 * 1024;   // PACK_SMEM_BYTES
constexpr int kPackSmemOneBlock = 220 * 1024;  // PACK_SMEM_ONE_BLOCK
constexpr int kPackMaxTile = 256;              // PACK_MAX_TILE

struct pack_plan {
  int size_per_row = 0;
  int n_words = 0;
  int validity_offset = 0;
  int tile_rows = 0;
  // (c0, c1, lo, hi, vc0, vc1, vst) a segment
  std::vector<std::array<int, 7>> segments;
  // (staged offset | width << 24, byte in the row) a column
  std::vector<std::array<int, 2>> cols;
  int buf_bytes = 0;
  int img_stride = 0;

  // The plan as the kernel reads it: 8 int32 a segment, then 2 a column.
  std::vector<int32_t> words() const {
    std::vector<int32_t> out;
    for (const auto& s : segments) {
      out.insert(out.end(), s.begin(), s.end());
      out.push_back(0);
    }
    for (const auto& c : cols) out.insert(out.end(), c.begin(), c.end());
    return out;
  }
};

namespace detail {

inline int align16(int n) { return (n + 15) & ~15; }

// (c0, c1, lo, hi, vc0, vc1) of row bytes [16 b0, 16 b1)
inline std::array<int, 6> segment(const std::vector<int>& starts, int voff,
                                  int size_per_row, int b0, int b1) {
  const int k = static_cast<int>(starts.size());
  const int lo = 16 * b0, hi = std::min(16 * b1, size_per_row);
  const int c0 = static_cast<int>(
      std::lower_bound(starts.begin(), starts.end(), lo) - starts.begin());
  const int c1 = static_cast<int>(
      std::lower_bound(starts.begin(), starts.end(), hi) - starts.begin());
  const int vb0 = std::max(lo - voff, 0);
  const int vb1 = std::min(hi - voff, (k + 7) / 8);
  int vc0 = 0, vc1 = 0;
  if (vb1 > vb0) {
    vc0 = 8 * vb0;
    vc1 = std::min(8 * vb1, k);
  }
  return {c0, c1, lo, hi, vc0, vc1};
}

inline int img_stride(const std::vector<std::array<int, 6>>& segs) {
  int most = 0;
  for (const auto& s : segs) most = std::max(most, s[3] - s[2]);
  return most % 16 == 8 ? most : most + 8;
}

// buf_bytes of tiles of `tile` rows
inline int buf_bytes(const std::vector<int>& prefix,
                     const std::vector<std::array<int, 6>>& segs, int tile) {
  int buf = 0;
  for (const auto& s : segs) {
    buf = std::max(buf, align16(tile * (prefix[s[1]] - prefix[s[0]])) +
                            align16(4 * (tile / 32) * (s[5] - s[4])));
  }
  return buf;
}

inline bool fits(const std::vector<int>& prefix,
                 const std::array<int, 6>& seg, int tile, int budget) {
  const std::vector<std::array<int, 6>> one{seg};
  return 2 * buf_bytes(prefix, one, tile) + tile * img_stride(one) <= budget;
}

inline int largest_tile(const std::vector<int>& prefix,
                        const std::array<int, 6>& seg, int budget) {
  for (int t = kPackMaxTile; t >= 32; t -= 32) {
    if (fits(prefix, seg, t, budget)) return t;
  }
  return 0;
}

}  // namespace detail

// The row format's layout and K6's tiles and segments for `widths` (each
// 1, 2, 4 or 8): see pack_plan in ops/cuda_kernels.py.
inline pack_plan make_pack_plan(const std::vector<int>& widths) {
  using detail::segment;
  std::vector<int> starts;
  int at = 0;
  for (int w : widths) {
    at = (at + w - 1) & ~(w - 1);
    starts.push_back(at);
    at += w;
  }
  const int k = static_cast<int>(widths.size());
  const int voff = at;
  const int size_per_row = (at + (k + 7) / 8 + 7) & ~7;
  const int blocks = (size_per_row + 15) / 16;
  std::vector<int> prefix{0};
  for (int w : widths) prefix.push_back(prefix.back() + w);

  auto seg = [&](int b0, int b1) {
    return segment(starts, voff, size_per_row, b0, b1);
  };
  std::vector<std::array<int, 6>> segs{seg(0, blocks)};
  int tile = detail::largest_tile(prefix, segs[0], kPackSmemBytes);
  if (tile < 128) {
    tile = std::max(tile,
                    detail::largest_tile(prefix, segs[0], kPackSmemOneBlock));
  }
  if (tile == 0) {
    tile = 32;
    segs.clear();
    int b0 = 0;
    while (b0 < blocks) {
      int b1 = b0 + 1;
      if (!detail::fits(prefix, seg(b0, b1), tile, kPackSmemBytes / 2)) {
        throw std::invalid_argument(
            "a 16-byte segment exceeds K6's shared memory");
      }
      while (b1 < blocks &&
             detail::fits(prefix, seg(b0, b1 + 1), tile, kPackSmemBytes / 2))
        ++b1;
      segs.push_back(seg(b0, b1));
      b0 = b1;
    }
  }
  pack_plan p;
  p.size_per_row = size_per_row;
  p.n_words = size_per_row / 4;
  p.validity_offset = voff;
  p.tile_rows = tile;
  p.cols.assign(k, {0, 0});
  for (const auto& s : segs) {
    for (int c = s[0]; c < s[1]; ++c) {
      p.cols[c] = {tile * (prefix[c] - prefix[s[0]]) | widths[c] << 24,
                   starts[c]};
    }
    p.segments.push_back({s[0], s[1], s[2], s[3], s[4], s[5],
                          detail::align16(tile * (prefix[s[1]] - prefix[s[0]]))});
  }
  p.buf_bytes = detail::buf_bytes(prefix, segs, tile);
  p.img_stride = detail::img_stride(segs);
  return p;
}

}  // namespace native
}  // namespace srt
