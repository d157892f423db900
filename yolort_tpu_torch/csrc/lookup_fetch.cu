// Slot -> chunk lookup plus the chunk-row fetch of the stage-2 selection.
//
// For output slot s of image b, over the 2m exclusive tier offsets
// off[b, :] (nondecreasing: m gt-tier chunks, then m eq-tier chunks):
//   c     = (number of offsets <= s) - 1, clipped to [0, 2m - 1]
//   is_eq = c >= m,  phys = c - m * is_eq,  p = s - off[b, c]
//   rows[b, s, :] = table[b, phys, :]   (128 float32, copied as bits)
//
// Replaces yolort_tpu/ops/pallas/lookup_kernel.py (_lookup_fetch_kernel /
// pallas_lookup_fetch).  The TPU kernel counts offsets against per-row
// maxima and fetches rows with byte-plane one-hot matmuls, both to avoid
// the TPU's slow gathers; a GPU searches and gathers directly.  One warp
// per slot: lane 0 runs the upper-bound binary search over the offsets
// (repeated offsets, where a chunk holds no entry of its tier, resolve to
// the last chunk whose offset is <= s), then the warp copies the 512-byte
// row as 32 16-byte vectors.  Slots at or past the selected total land on
// c = 2m - 1 and still read an in-range row.
//
// What bounds it on the H100: bytes written (k rows of 512 B per image:
// 16.8 MB at batch 8, k = 4096) and the latency of the search's dependent
// loads, which stay in L2 (the offsets are 20 KB per image); the table
// (1.3 MB per image at most) is read from L2 after its first touch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void lookup_fetch_kernel(const int4* __restrict__ table, const int* __restrict__ off,
                                    int m, int k, int4* __restrict__ rows,
                                    int* __restrict__ phys_out, int* __restrict__ p_out,
                                    unsigned char* __restrict__ is_eq_out) {
  const int s = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  if (s >= k) return;
  const int m2 = 2 * m;
  const int* o = off + (size_t)b * m2;
  int c = 0;
  if (lane == 0) {
    int lo = 0, hi = m2;  // first index whose offset is > s
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (o[mid] <= s)
        lo = mid + 1;
      else
        hi = mid;
    }
    c = min(max(lo - 1, 0), m2 - 1);
  }
  c = __shfl_sync(0xffffffffu, c, 0);
  const int eq = c >= m;
  const int ph = eq ? c - m : c;
  const size_t slot = (size_t)b * k + s;
  rows[slot * 32 + lane] = table[((size_t)b * m + ph) * 32 + lane];
  if (lane == 0) {
    phys_out[slot] = ph;
    p_out[slot] = s - o[c];
    is_eq_out[slot] = static_cast<unsigned char>(eq);
  }
}

}  // namespace

extern "C" int yt_lookup_fetch(const void* table, const void* off, int B, int m, int k,
                               void* rows, void* phys, void* p, void* is_eq, void* stream) {
  if (B <= 0 || k <= 0) return 0;
  if (m <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((k + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  lookup_fetch_kernel<<<grid, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(table), static_cast<const int*>(off), m, k,
      static_cast<int4*>(rows), static_cast<int*>(phys), static_cast<int*>(p),
      static_cast<unsigned char*>(is_eq));
  return (int)cudaGetLastError();
}
