// In-kernel extraction of the stage-2 selection: for each output slot,
// fetch its chunk row table[b, clamp(phys, 0, m - 1), :], recompute the
// slot's tier mask against the k-th value bits t[b] (gt tier: bits >= t+1;
// eq tier: bits == t; both only for valid bits > thr), and emit the p-th
// set lane, in lane order, as (value, lane).  A slot with no such lane
// gives (0.0, 0), as the JAX masked sums do.
//
// Replaces yolort_tpu/ops/pallas/lookup_kernel.py (_select_kernel /
// pallas_select_extract).  The TPU kernel fetches rows with byte-plane
// one-hot matmuls and ranks lanes with a triangular matmul; here one warp
// per slot reads the row in four passes of 32 consecutive lanes (lane
// index order, coalesced 128-byte reads), takes a __ballot_sync of the
// mask in each pass, and ranks a set lane as the popcount of the earlier
// passes plus popc(ballot & lanemask_lt).  Exactly one lane matches when
// 0 <= p < popcount, so every output is written once, with no atomics.
//
// What bounds it on the H100: bytes read (k rows of 512 B per image,
// 10.5 MB for the distinct rows at batch 8, (2565, 128), k = 4096, mostly
// from L2) against 8 B written per slot; the int32 compares are negligible.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void select_extract_kernel(const int* __restrict__ table,
                                      const int* __restrict__ phys, const int* __restrict__ p,
                                      const unsigned char* __restrict__ is_eq,
                                      const int* __restrict__ t, int thr, int m, int k,
                                      float* __restrict__ vals, int* __restrict__ lanes) {
  const int s = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  if (s >= k) return;
  const size_t slot = (size_t)b * k + s;
  const int ph = min(max(phys[slot], 0), m - 1);
  const int want = p[slot];
  const bool eq = is_eq[slot] != 0;
  const int tb = t[b];
  const int t1 = static_cast<int>(static_cast<unsigned>(tb) + 1u);  // int32 wrap, as in JAX
  const int* row = table + ((size_t)b * m + ph) * 128;
  const unsigned lt = (1u << lane) - 1u;
  int before = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int v = row[j * 32 + lane];
    const bool sel = v > thr && (eq ? v == tb : v >= t1);
    const unsigned ballot = __ballot_sync(0xffffffffu, sel);
    if (sel && before + __popc(ballot & lt) == want) {
      vals[slot] = __int_as_float(v);
      lanes[slot] = j * 32 + lane;
    }
    before += __popc(ballot);
  }
  if (lane == 0 && !(want >= 0 && want < before)) {
    vals[slot] = 0.0f;
    lanes[slot] = 0;
  }
}

}  // namespace

extern "C" int yt_select_extract(const void* table, const void* phys, const void* p,
                                 const void* is_eq, const void* t, int thr_bits, int B, int m,
                                 int k, void* vals, void* lanes, void* stream) {
  if (B <= 0 || k <= 0) return 0;
  if (m <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((k + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  select_extract_kernel<<<grid, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(phys), static_cast<const int*>(p),
      static_cast<const unsigned char*>(is_eq), static_cast<const int*>(t), thr_bits, m, k,
      static_cast<float*>(vals), static_cast<int*>(lanes));
  return (int)cudaGetLastError();
}
