// Bit-exact row gather: out[b, s, :] = table[b, clamp(idx[b, s], 0, m - 1), :].
//
// Replaces yolort_tpu/ops/pallas/lookup_kernel.py (_fetch_kernel +
// _fetch_block_bits / pallas_row_fetch).  The TPU kernel rebuilds each row
// from byte-plane one-hot MXU matmuls because XLA's TPU gather is
// latency-bound; a GPU gathers rows directly.  One warp copies one row,
// moving 16-byte vectors when the row width allows (4- or 2-byte words
// otherwise).  Rows are copied as integers, never through float arithmetic,
// so NaN payloads, -0.0 and every other bit pattern survive.
//
// What bounds it on the H100: memory latency and bytes (k rows of 512 B for
// the f32 stage-2 table); each row is one coalesced 512-byte transaction
// per warp, and the table (at most 1.3 MB per image) sits in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename T>
__global__ void row_fetch_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                                 T* __restrict__ out, int m, int k, int units) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  if (row >= k) return;
  const int r = min(max(idx[(size_t)b * k + row], 0), m - 1);
  const T* src = table + ((size_t)b * m + r) * units;
  T* dst = out + ((size_t)b * k + row) * units;
  for (int u = lane; u < units; u += 32) dst[u] = src[u];
}

template <typename T>
cudaError_t launch(const void* table, const void* idx, void* out, int B, int m, int k,
                   int row_bytes, cudaStream_t s) {
  const dim3 grid((k + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  row_fetch_kernel<T><<<grid, kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const T*>(table), static_cast<const int*>(idx), static_cast<T*>(out), m,
      k, row_bytes / static_cast<int>(sizeof(T)));
  return cudaGetLastError();
}

}  // namespace

extern "C" int yt_row_fetch(const void* table, const void* idx, void* out, int B, int m,
                            int k, int row_bytes, void* stream) {
  if (B <= 0 || k <= 0) return 0;
  if (m <= 0 || row_bytes <= 0 || row_bytes % 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out);
  if (row_bytes % 16 == 0 && align % 16 == 0)
    return (int)launch<uint4>(table, idx, out, B, m, k, row_bytes, s);
  if (row_bytes % 4 == 0 && align % 4 == 0)
    return (int)launch<uint32_t>(table, idx, out, B, m, k, row_bytes, s);
  return (int)launch<uint16_t>(table, idx, out, B, m, k, row_bytes, s);
}
