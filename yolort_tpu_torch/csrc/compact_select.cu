// Stream-compaction placement of the exact top-k: every entry of chunk c's
// tier mask goes to output position off[b, c] + (its rank among the
// chunk's set lanes, in lane order) when that is < k.  Chunks are taken in
// tier-major order, c < m the gt tier (valid bits >= t+1) of chunk c,
// c >= m the eq tier (valid bits == t) of chunk c - m, so the output holds
// the strictly-above entries, then the boundary ties, each in index order.
// Writes the value and its int32 flat index (chunk * 128 + lane).
//
// Replaces yolort_tpu/ops/pallas/compact_kernel.py (_compact_kernel /
// compact_select).  The TPU kernel ranks lanes with a triangular matmul
// and scatters through one-hot placement matmuls into a VMEM-resident
// output across a sequential grid, and carries indices as float32 (exact
// below 2^24).  Here one warp per (chunk, tier) skips a chunk whose count
// is 0 or whose offset is >= k, else reads the chunk in four passes of 32
// consecutive lanes and ranks each set lane by __ballot_sync / popc, as
// csrc/select_extract.cu does.  Positions are disjoint by construction, so
// the stores need no atomics; the wrapper zero-fills the output first.
//
// What bounds it on the H100: bytes, data dependent: the chunks that hold
// selected entries are read (at most the whole table, 10.5 MB at batch 8,
// (2565, 128)) and min(total, k) * 8 B are written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void compact_place_kernel(const int* __restrict__ table, const int* __restrict__ cnt,
                                     const int* __restrict__ off, const int* __restrict__ t,
                                     int thr, int m, int k, float* __restrict__ vals,
                                     int* __restrict__ idx) {
  const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  if (c >= 2 * m) return;
  const size_t ci = (size_t)b * 2 * m + c;
  const int o = off[ci];
  if (cnt[ci] <= 0 || o >= k) return;
  const bool eq = c >= m;
  const int ph = eq ? c - m : c;
  const int tb = t[b];
  const int t1 = static_cast<int>(static_cast<unsigned>(tb) + 1u);  // int32 wrap, as in JAX
  const int* row = table + ((size_t)b * m + ph) * 128;
  const unsigned lt = (1u << lane) - 1u;
  int before = o;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int v = row[j * 32 + lane];
    const bool sel = v > thr && (eq ? v == tb : v >= t1);
    const unsigned ballot = __ballot_sync(0xffffffffu, sel);
    const int pos = before + __popc(ballot & lt);
    if (sel && pos < k) {
      vals[(size_t)b * k + pos] = __int_as_float(v);
      idx[(size_t)b * k + pos] = ph * 128 + j * 32 + lane;
    }
    before += __popc(ballot);
  }
}

}  // namespace

extern "C" int yt_compact_place(const void* table, const void* cnt, const void* off,
                                const void* t, int thr_bits, int B, int m, int k, void* vals,
                                void* idx, void* stream) {
  if (B <= 0 || k <= 0) return 0;
  if (m <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((2 * m + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  compact_place_kernel<<<grid, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(cnt), static_cast<const int*>(off),
      static_cast<const int*>(t), thr_bits, m, k, static_cast<float*>(vals),
      static_cast<int*>(idx));
  return (int)cudaGetLastError();
}
