// Bit-exact row gather: out[b, s, :] = table[b, clamp(idx[b, s], 0, m - 1), :].
//
// Replaces yolort_tpu/ops/pallas/lookup_kernel.py (_fetch_kernel +
// _fetch_block_bits / pallas_row_fetch) and its block-size sweep,
// tools/experiments/fetch_block_sweep.py (_fetch_kernel_p / row_fetch_p).
// The TPU kernel rebuilds each row from byte-plane one-hot MXU matmuls
// because XLA's TPU gather is latency-bound, and the sweep varies its VMEM
// blocks (slots x table rows); a GPU gathers rows directly, so its launch
// geometry is what there is to sweep: warps per block (1-32) and rows per
// warp (consecutive output rows, copied one after the other).  One warp
// copies one row at a time, moving 16-byte vectors when the row width and
// the pointers allow (4- or 2-byte words otherwise: a 510-byte bf16 cells
// row takes the 2-byte path).  Rows are copied as integers, never through
// float arithmetic, so NaN payloads, -0.0 and every other bit pattern
// survive.
//
// What bounds it on the H100: memory latency and bytes (k rows of 512 B for
// the f32 stage-2 table); each row is one coalesced 512-byte transaction
// per warp, and the table (at most 1.3 MB per image) sits in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void row_fetch_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                                 T* __restrict__ out, int m, int k, int units,
                                 int warps_per_block, int rows_per_warp) {
  const int warp = blockIdx.x * warps_per_block + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const long long first = (long long)warp * rows_per_warp;
  for (int i = 0; i < rows_per_warp; ++i) {
    const long long row = first + i;
    if (row >= k) return;
    const int r = min(max(idx[(size_t)b * k + row], 0), m - 1);
    const T* src = table + ((size_t)b * m + r) * units;
    T* dst = out + ((size_t)b * k + row) * units;
    for (int u = lane; u < units; u += 32) dst[u] = src[u];
  }
}

template <typename T>
cudaError_t launch(const void* table, const void* idx, void* out, int B, int m, int k,
                   int row_bytes, int warps_per_block, int rows_per_warp, cudaStream_t s) {
  const long long per_block = (long long)warps_per_block * rows_per_warp;
  const dim3 grid((unsigned)((k + per_block - 1) / per_block), B);
  row_fetch_kernel<T><<<grid, warps_per_block * 32, 0, s>>>(
      static_cast<const T*>(table), static_cast<const int*>(idx), static_cast<T*>(out), m,
      k, row_bytes / static_cast<int>(sizeof(T)), warps_per_block, rows_per_warp);
  return cudaGetLastError();
}

}  // namespace

// The one entry point: ops/cuda/lookup_kernel.py's row_fetch calls it at
// (8, 1), row_fetch_p at the geometry it is given.
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
