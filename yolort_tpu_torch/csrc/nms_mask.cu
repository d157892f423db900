// Greedy NMS keep mask over score-sorted, class-offset candidates.
//
// Replaces yolort_tpu/ops/pallas/nms_kernel.py (_nms_kernel / pallas_nms_mask).
// The TPU kernel turns every suppression reduction into an MXU matmul to
// stay inside Mosaic's layout rules; none of that carries over.  Here the
// work splits in two launches:
//
//   1. iou_mask_kernel writes the strict upper-triangular relation
//      iou(i, j) > thr (j > i) as 64-bit words, one row of ceil(K/64) words
//      per candidate, into a scratch buffer the wrapper allocates
//      (K = 4096: 2 MB per image).  Rows of invalid candidates are never
//      read and are not computed.
//   2. greedy_walk_kernel runs one warp per image over the candidates in
//      score order.  The "removed" bitset lives in registers, spread over
//      the 32 lanes (word w on lane w % 32); a kept candidate ORs its mask
//      row into it, a removed one costs one shuffle.
//
// What bounds it on the H100: pass 1 is compute (K^2/2 IoUs per image, but
// only over the valid prefix); pass 2 is latency (one dependent step per
// candidate, one L2 read of a mask row per keep).  The walk visits tiles of
// `tile` candidates and stops at the first tile boundary where `stop_after`
// keeps are final, passing validity through for the rest, exactly as
// greedy_nms_mask in the JAX package does, so the whole mask is identical.
//
// Bit-level IoU: every product, sum and quotient is written with the
// round-to-nearest intrinsics, so no FMA contraction can flip `iou > thr`
// on a boundary pair; the operation order follows ops/nms.py:box_iou_matrix.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWordsPerLane = 8;  // K <= 64 * 32 * 8 = 16384

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

__global__ void iou_mask_kernel(const float4* __restrict__ boxes,
                                const uint8_t* __restrict__ valid,
                                unsigned long long* __restrict__ mask, int K, int W,
                                float thr) {
  const int cb = blockIdx.x, rb = blockIdx.y, b = blockIdx.z;
  if (cb < rb) return;  // lower-triangular words are never read
  __shared__ float4 cols[64];
  __shared__ float col_area[64];
  const float4* bx = boxes + (size_t)b * K;
  const uint8_t* vb = valid + (size_t)b * K;
  const int j = cb * 64 + threadIdx.x;
  if (j < K) {
    const float4 c = bx[j];
    cols[threadIdx.x] = c;
    col_area[threadIdx.x] = box_area(c);
  }
  __syncthreads();
  const int i = rb * 64 + threadIdx.x;
  if (i >= K || !vb[i]) return;
  const float4 a = bx[i];
  const float area_a = box_area(a);
  const int jn = min(64, K - cb * 64);
  unsigned long long bits = 0ull;
  for (int jj = (cb == rb) ? threadIdx.x + 1 : 0; jj < jn; ++jj) {
    const float4 c = cols[jj];
    const float w = fmaxf(__fsub_rn(fminf(a.z, c.z), fmaxf(a.x, c.x)), 0.f);
    const float h = fmaxf(__fsub_rn(fminf(a.w, c.w), fmaxf(a.y, c.y)), 0.f);
    const float inter = __fmul_rn(w, h);
    const float uni = __fsub_rn(__fadd_rn(area_a, col_area[jj]), inter);
    const float iou = __fdiv_rn(inter, fmaxf(uni, 1e-12f));
    if (iou > thr) bits |= 1ull << jj;
  }
  mask[((size_t)b * K + i) * W + cb] = bits;
}

__global__ void greedy_walk_kernel(const unsigned long long* __restrict__ mask,
                                   const uint8_t* __restrict__ valid,
                                   uint8_t* __restrict__ keep, int K, int W, int tile,
                                   int stop) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned long long* mb = mask + (size_t)b * K * W;
  const uint8_t* vb = valid + (size_t)b * K;
  uint8_t* kb = keep + (size_t)b * K;

  unsigned long long removed[kMaxWordsPerLane];
#pragma unroll
  for (int r = 0; r < kMaxWordsPerLane; ++r) removed[r] = 0ull;

  int kept = 0;
  int start = 0;
  for (; start < K && kept < stop; start += tile) {
    const int end = min(start + tile, K);
    for (int i = start; i < end; ++i) {
      const int w = i >> 6;
      unsigned long long word = 0ull;
#pragma unroll
      for (int r = 0; r < kMaxWordsPerLane; ++r)
        if (r == (w >> 5)) word = removed[r];
      word = __shfl_sync(0xffffffffu, word, w & 31);
      const bool k_i = vb[i] && !((word >> (i & 63)) & 1ull);
      if (lane == 0) kb[i] = k_i;
      if (k_i) {
        ++kept;
        const unsigned long long* row = mb + (size_t)i * W;
#pragma unroll
        for (int r = 0; r < kMaxWordsPerLane; ++r) {
          const int ww = lane + 32 * r;
          if (ww >= w && ww < W) removed[r] |= row[ww];
        }
      }
    }
  }
  // tiles past the early exit pass their validity through
  for (int i = start + lane; i < K; i += 32) kb[i] = vb[i];
}

}  // namespace

extern "C" int yt_nms_mask(const void* boxes, const void* valid, void* keep,
                           void* scratch, int B, int K, float iou_thresh, int tile,
                           int stop, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  const int W = (K + 63) / 64;
  if (W > 32 * kMaxWordsPerLane || tile <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  iou_mask_kernel<<<dim3(W, W, B), 64, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<unsigned long long*>(scratch), K, W, iou_thresh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  greedy_walk_kernel<<<B, 32, 0, s>>>(static_cast<const unsigned long long*>(scratch),
                                      static_cast<const uint8_t*>(valid),
                                      static_cast<uint8_t*>(keep), K, W, tile, stop);
  return (int)cudaGetLastError();
}
