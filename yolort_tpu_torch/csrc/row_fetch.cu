// Bit-exact row gather: out[b, s, :] = table[b, clamp(idx[b, s], 0, m - 1), :].
//
// Replaces yolort_tpu/ops/pallas/lookup_kernel.py (_fetch_kernel +
// _fetch_block_bits / pallas_row_fetch, pallas_call at :481) and its
// block-size sweep, tools/experiments/fetch_block_sweep.py (_fetch_kernel_p,
// pallas_call at :89).  The TPU kernel rebuilds each row from byte-plane
// one-hot MXU matmuls because XLA's TPU gather is latency-bound, and the
// sweep varies its VMEM blocks; a GPU gathers rows directly, so what there
// is to sweep is the launch: warps per block and rows a warp keeps in
// flight.  Rows are copied as integers, never through float arithmetic, so
// NaN payloads, -0.0 and every other bit pattern survive.
//
// What bounds it on the H100: memory latency before bytes.  The stage-2
// fetch moves k rows of 512 B an image (2 MB at batch 8, k = 4096) from a
// table of at most 1.3 MB an image, so a launch lasts microseconds: a chain
// of dependent accesses (the index, then the row, then the store), plus
// whatever serial work a warp adds to it.  The design keeps that chain as
// short as the old one-row-a-warp kernel's and widens it:
//
//   * a warp copies `rows` consecutive output slots of one image; lane i
//     loads slot i's index, so one coalesced load serves up to 32 rows, and
//     the clamped indices reach the copy by __shfl_sync;
//   * the warp issues the loads of all its slots' rows (up to
//     kMaxRowsInFlight a batch) before any of their stores, in
//     straight-line code, so their latencies overlap.  A lane holds 16
//     bytes of each row in flight: one uint4 of a 512-byte row.  Rows wider
//     than 512 bytes are copied in 512-byte column blocks, each with every
//     row's loads first;
//   * a slot that names the row of the slot before it takes that row's
//     registers and reads nothing.  The main path's indices are piecewise
//     sorted (stage-2 phys comes from exclusive offsets in two
//     index-ordered tiers), so every repeat of a row there is such a
//     neighbour: each distinct row is read once a batch (about two slots a
//     row at batch 8 eval), with one compare of warp-uniform values.  A
//     grouping of the whole warp by __match_any_sync, and blocks whose
//     warps share a run's distinct rows, were tried first: they read the
//     unsorted repeats once too, but the match, ballots and the per-slot
//     store loop made each warp's chain longer than the old kernel's at
//     batch 8 serving (PERF.md, section 6).  Unsorted and
//     out-of-range indices give the same bits, only more reads.
//
// Words are 16 bytes where the row width and the pointers allow, else 4,
// else 2.  A 2-byte word row (the 510-byte bf16 cells row, the 170-byte
// (300, 85) one) is copied the same way, 8 words a lane a row: such a row
// takes 8 load instructions of 64 bytes a warp, but with several rows in
// flight the copy waits on memory, not on the issue of those loads
// (132 SMs x 64 bytes a clock is several times the memory rate), so a
// layout that packs more than one row into a pass of 2-byte words would
// save instructions and no time; such rows take 2 slots a warp, not 4.
// Rows under 32 words leave lanes idle: no main-path table has them.
//
// The launch geometry, (warps_per_block, rows_per_warp), is the caller's:
// ops/cuda/lookup_kernel.py's row_fetch takes it from row_fetch_geometry
// (the row width and the grid), row_fetch_p from the sweep.  rows_per_warp is the slots a
// warp copies, all of them in flight up to kMaxRowsInFlight, or fewer where
// a block of that many warps would not have the registers (a 1024-thread
// block of 2-byte words); every geometry gives the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRowsInFlight = 8;

// kRows: the rows' registers (a power of two); rows: the slots a warp
// copies, a batch of at most kRows at a time
template <typename T, int kRows>
__global__ void row_fetch_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                                 T* __restrict__ out, int m, int k, int units, int rows) {
  constexpr int kWords = 16 / static_cast<int>(sizeof(T));  // a lane's words of a row a block
  constexpr int kBlock = 32 * kWords;                         // a column block: 512 bytes
  const long long first =
      ((long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * rows;  // this warp's
  if (first >= k) return;  // the whole warp
  const int n = (int)min((long long)rows, k - first);  // its slots
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int* ix = idx + (size_t)b * k + first;
  const T* tab = table + (size_t)b * m * units;
  T* dst = out + ((size_t)b * k + first) * units;
  for (int s0 = 0; s0 < n; s0 += 32) {  // 32 indices a load
    const int own = s0 + lane < n ? min(max(__ldg(ix + s0 + lane), 0), m - 1) : 0;
    for (int r0 = s0; r0 < n && r0 < s0 + 32; r0 += kRows) {  // kRows slots a batch
      int row[kRows];
      bool fresh[kRows];  // a row the batch has not just read: warp-uniform
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        row[r] = __shfl_sync(kFull, own, (r0 - s0 + r) & 31);
        fresh[r] = r0 + r < n && (r == 0 || row[r] != row[r - 1]);
      }
      for (int c0 = 0; c0 < units; c0 += kBlock) {
        T v[kRows][kWords];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {  // every load first
          if (!fresh[r]) continue;
          const T* src = tab + (size_t)row[r] * units + c0 + lane;
#pragma unroll
          for (int w = 0; w < kWords; ++w)
            if (c0 + lane + 32 * w < units) v[r][w] = __ldg(src + 32 * w);
        }
        T cur[kWords];  // the row of the slot being stored
#pragma unroll
        for (int r = 0; r < kRows; ++r) {  // then a store a slot
          if (r0 + r >= n) break;
          T* d = dst + (size_t)(r0 + r) * units + c0 + lane;
#pragma unroll
          for (int w = 0; w < kWords; ++w) {
            if (fresh[r]) cur[w] = v[r][w];
            if (c0 + lane + 32 * w < units) d[32 * w] = cur[w];
          }
        }
      }
    }
  }
}

// the largest block an instance can launch, given its registers
template <typename T, int kRows>
int max_threads() {
  static const int n = [] {
    cudaFuncAttributes a;
    return cudaFuncGetAttributes(&a, row_fetch_kernel<T, kRows>) == cudaSuccess
               ? a.maxThreadsPerBlock
               : 0;
  }();
  return n;
}

// the instance for batches of up to `rows` slots, smaller where the
// block's registers would not hold them
template <typename T, int kRows>
cudaError_t launch_rows(const T* t, const int* i, T* o, int m, int k, int units, int rows,
                        dim3 grid, dim3 block, cudaStream_t s) {
  if (kRows > 1 && (kRows / 2 >= rows || max_threads<T, kRows>() < (int)block.x))
    return launch_rows<T, (kRows > 1 ? kRows / 2 : 1)>(t, i, o, m, k, units, rows, grid, block,
                                                       s);
  row_fetch_kernel<T, kRows><<<grid, block, 0, s>>>(t, i, o, m, k, units, rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* table, const void* idx, void* out, int B, int m, int k,
                   int row_bytes, int warps_per_block, int rows_per_warp, cudaStream_t s) {
  const long long per_block = (long long)warps_per_block * rows_per_warp;
  const dim3 grid((unsigned)((k + per_block - 1) / per_block), B);
  return launch_rows<T, kMaxRowsInFlight>(
      static_cast<const T*>(table), static_cast<const int*>(idx), static_cast<T*>(out), m, k,
      row_bytes / static_cast<int>(sizeof(T)), rows_per_warp, grid, dim3(warps_per_block * 32),
      s);
}

}  // namespace

// The one entry point: ops/cuda/lookup_kernel.py's row_fetch calls it at
// row_fetch_geometry's (warps_per_block, rows_per_warp), row_fetch_p at the
// geometry it is given.
extern "C" int yt_row_fetch_p(const void* table, const void* idx, void* out, int B, int m,
                              int k, int row_bytes, int warps_per_block, int rows_per_warp,
                              void* stream) {
  if (warps_per_block < 1 || warps_per_block > 32 || rows_per_warp < 1)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || k <= 0) return 0;
  if (m <= 0 || row_bytes <= 0 || row_bytes % 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out);
  if (row_bytes % 16 == 0 && align % 16 == 0)
    return (int)launch<uint4>(table, idx, out, B, m, k, row_bytes, warps_per_block,
                              rows_per_warp, s);
  if (row_bytes % 4 == 0 && align % 4 == 0)
    return (int)launch<uint32_t>(table, idx, out, B, m, k, row_bytes, warps_per_block,
                                 rows_per_warp, s);
  return (int)launch<uint16_t>(table, idx, out, B, m, k, row_bytes, warps_per_block,
                               rows_per_warp, s);
}
