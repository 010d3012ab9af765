// K3: validity bitmask pack, LSB-first uint32 words, in two forms.
//
// Replaces spark_rapids_jni_tpu/ops/pallas_kernels.py
// `bitmask_pack_pallas` (kernel `_bitmask_pack_kernel`): bit r % 32 of
// word r / 32 is row r's validity; padding bits of the last word are 0.
//
// What bounds it on an H100: bytes. The TPU kernel reduces (rows/32, 32)
// lanes with a weighted sum in VMEM; here the work is placing bits, and
// each form is built so that every byte is loaded once, wide, and every
// word stored once, in whole sectors.
//
// Vector form, bool (N,) -> ceil(N/32) words (`bitmask_pack_kernel`): a
// lane loads 16 bool bytes in one aligned 16-byte load and gathers their
// bits with two 64-bit multiplies, ((x & 0x0101..01) * 0x0102040810204080)
// >> 56 (byte i lands on bit 56 + i; no two partial products share a bit,
// so nothing carries). A lane pair holds one 32-bit word; a warp covers
// 1024 rows from two loads a lane and stores 32 consecutive words, 128
// bytes. The loads are aligned down to 16 bytes from the view's start, m
// bytes before it: the words gathered so are the wanted ones shifted by m
// bits, so each output word is a funnel shift of two of them (lanes 0-1
// load one more 16-byte chunk for the warp's last word). Bytes outside
// [valid, valid + N) are masked to 0, which zeroes the padding bits, and
// a chunk holding none of them is not loaded.
//
// Table form, the row format's validity bytes (N, nbytes) at a row
// stride -> (n_fields, ceil(N/32)) words, row c = column c
// (`bitmask_pack_fields_kernel`): a block copies 512 rows' validity
// bytes, up to 32 a row at a time, into shared memory with neighbouring
// threads on neighbouring 4-byte words of a row, so each row's bytes are
// read from device memory once however many columns there are; then
// lane = row, and a 32 x 32 bit transpose across the warp (five shuffle
// rounds) turns 32 rows' 4 bytes into 32 columns' words; the words are
// staged in shared memory and each column's 16 words leave as 64
// contiguous bytes.
// One launch packs every column of a row batch, where the vector form
// would take a strided copy and a launch per column. The rows' bytes are
// strided (one 4-byte piece of each 200-byte row), so the card reads at
// least a 32-byte sector a row: that, not the 4 bytes, is what a call
// costs in device memory traffic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;  // 8 warps
constexpr int64_t kMaxBlocks = 1 << 20;

// bits of 8 bool bytes, LSB = lowest address
__device__ __forceinline__ uint32_t gather8(uint64_t x) {
  return static_cast<uint32_t>(
      ((x & 0x0101010101010101ull) * 0x0102040810204080ull) >> 56);
}

// The 16 bits of the aligned 16-byte chunk at `chunk`, bytes outside
// [lo, hi) read as 0 and a chunk with none inside is not loaded.
__device__ __forceinline__ uint32_t chunk_bits(uintptr_t chunk,
                                               uintptr_t lo,
                                               uintptr_t hi) {
  if (chunk + 16 <= lo || chunk >= hi) return 0u;
  const uint4 v = *reinterpret_cast<const uint4*>(chunk);
  uint32_t bits =
      gather8((static_cast<uint64_t>(v.y) << 32) | v.x) |
      (gather8((static_cast<uint64_t>(v.w) << 32) | v.z) << 8);
  if (chunk < lo) bits &= 0xFFFFu << (lo - chunk);
  if (chunk + 16 > hi) bits &= 0xFFFFu >> (chunk + 16 - hi);
  return bits;
}

__global__ void __launch_bounds__(kThreads)
bitmask_pack_kernel(const uint8_t* __restrict__ valid, int64_t n,
                    uint32_t* __restrict__ words, int64_t n_words) {
  const int lane = threadIdx.x & 31;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(valid);
  const uintptr_t hi = lo + static_cast<uintptr_t>(n);
  const uintptr_t base = lo & ~static_cast<uintptr_t>(15);
  const unsigned shift = static_cast<unsigned>(lo - base);  // m < 16
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  for (int64_t w0 = (static_cast<int64_t>(blockIdx.x) * kThreads +
                     threadIdx.x) / 32 * 32;
       w0 < n_words; w0 += warps * 32) {
    // gathered word k covers bytes [base + 32k, base + 32k + 32)
    const uintptr_t at = base + static_cast<uintptr_t>(w0) * 32;
    const uint32_t a = chunk_bits(at + 16 * lane, lo, hi);
    const uint32_t b = chunk_bits(at + 512 + 16 * lane, lo, hi);
    const uint32_t c =
        (shift && lane < 2) ? chunk_bits(at + 1024 + 16 * lane, lo, hi) : 0u;
    // lane l: gathered word w0 + l, from the lane pair 2l, 2l + 1 of a
    // (l < 16) or of b
    const int src = (2 * lane) & 31;
    const uint32_t a_lo = __shfl_sync(kFull, a, src);
    const uint32_t a_hi = __shfl_sync(kFull, a, src + 1);
    const uint32_t b_lo = __shfl_sync(kFull, b, src);
    const uint32_t b_hi = __shfl_sync(kFull, b, src + 1);
    const uint32_t mine =
        lane < 16 ? (a_lo | (a_hi << 16)) : (b_lo | (b_hi << 16));
    const uint32_t c_word =
        __shfl_sync(kFull, c, 0) | (__shfl_sync(kFull, c, 1) << 16);
    uint32_t next = __shfl_down_sync(kFull, mine, 1);
    if (lane == 31) next = c_word;
    const int64_t w = w0 + lane;
    if (w < n_words) words[w] = __funnelshift_r(mine, next, shift);
  }
}

constexpr int kFieldRows = 512;             // rows a block takes
constexpr int kGroups = kFieldRows / 32;    // words a column, per block
constexpr int kPassBytes = 32;              // validity bytes a row, a pass
constexpr int kPassWords = kPassBytes / 4;
constexpr int kPassFields = 8 * kPassBytes;

// A warp's 32 x 32 bit transpose: lane r holds row r (bit c = column
// c); lane c gets column c (bit r = row r). Five rounds, each swapping
// the off-diagonal j x j blocks of every 2j x 2j block with the lane
// j away: a shuffle and a few bit operations a round, where a ballot a
// column takes 32 votes and 32 selects.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    // the bits whose index has bit j clear: 0x0000FFFF, ..., 0x55555555
    const uint32_t m = 0xFFFFFFFFu / ((1u << j) + 1u);
    const uint32_t y = __shfl_xor_sync(kFull, x, j);
    x = (lane & j) ? ((x & ~m) | ((y >> j) & m))
                   : ((x & m) | ((y << j) & ~m));
  }
  return x;
}

// 4 validity bytes at `p`, of which the first `need` are inside the row's
// validity bytes: only the aligned words that hold those are loaded;
// bytes past them are columns that are never stored.
__device__ __forceinline__ uint32_t load4(const uint8_t* p, int need) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  const unsigned off = static_cast<unsigned>(a & 3);
  const uint32_t w0 = w[0];
  const uint32_t w1 = (off + need > 4) ? w[1] : 0u;
  return __funnelshift_r(w0, w1, 8 * off);
}

// A block takes 512 rows, 32 validity bytes (256 columns) a pass: the
// rows' bytes are copied to shared memory a 4-byte word a thread,
// neighbouring threads on neighbouring words of a row (so each row's
// bytes are read once, in whole sectors where the row has them); then a
// warp, lane = row, transposes 32 rows' words into 32 columns' words;
// then each column's 16 words leave as 64 contiguous bytes.
__global__ void __launch_bounds__(kThreads)
bitmask_pack_fields_kernel(const uint8_t* __restrict__ vbytes,
                           int64_t row_stride, int64_t n, int n_fields,
                           uint32_t* __restrict__ out, int64_t n_words) {
  __shared__ uint32_t in[kFieldRows][kPassWords + 1];
  __shared__ uint32_t stage[kPassFields][kGroups + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nbytes = (n_fields + 7) / 8;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kFieldRows;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * kGroups;
  for (int b0 = 0; b0 < nbytes; b0 += kPassBytes) {
    const int pass_bytes = min(kPassBytes, nbytes - b0);
    const int wpr = (pass_bytes + 3) / 4;  // words a row, this pass
    for (int i = threadIdx.x; i < kFieldRows * wpr; i += kThreads) {
      const int row = i / wpr, w = i - row * wpr;
      const int64_t r = r0 + row;
      in[row][w] = r < n ? load4(vbytes + r * row_stride + b0 + 4 * w,
                                 min(4, pass_bytes - 4 * w))
                         : 0u;
    }
    __syncthreads();
    const int f0 = 8 * b0;
    const int fields = min(kPassFields, n_fields - f0);
    for (int g = warp; g < kGroups; g += kThreads / 32)
      for (int w = 0; w < wpr; ++w)
        stage[32 * w + lane][g] = transpose32(in[g * 32 + lane][w], lane);
    __syncthreads();
    for (int i = threadIdx.x; i < fields * kGroups; i += kThreads) {
      const int c = i / kGroups, g = i - c * kGroups;
      if (g0 + g < n_words)
        out[static_cast<int64_t>(f0 + c) * n_words + g0 + g] = stage[c][g];
    }
    __syncthreads();
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int srt_bitmask_pack(const void* valid, long long n, void* words,
                                long long n_words, void* stream) {
  if (n_words <= 0) return 0;
  int64_t blocks = (n_words + kThreads - 1) / kThreads;  // a warp: 32 words
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  bitmask_pack_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(valid), n, static_cast<uint32_t*>(words),
      n_words);
  return static_cast<int>(cudaGetLastError());
}

// vbytes: row r's validity bytes at vbytes + r * row_stride; out:
// n_fields x n_words words. Returns cudaGetLastError() after the launch.
extern "C" int srt_bitmask_pack_fields(const void* vbytes,
                                       long long row_stride, long long n,
                                       int n_fields, void* out,
                                       long long n_words, void* stream) {
  if (n_words <= 0 || n_fields <= 0) return 0;
  const int64_t blocks = (n_words + kGroups - 1) / kGroups;
  bitmask_pack_fields_kernel<<<static_cast<unsigned int>(blocks), kThreads,
                               0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(vbytes), row_stride, n, n_fields,
      static_cast<uint32_t*>(out), n_words);
  return static_cast<int>(cudaGetLastError());
}
