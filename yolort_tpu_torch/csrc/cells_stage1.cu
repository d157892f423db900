// One pass over the head outputs: concatenate the L levels (B, R_l, C)
// into the cells table (B, sum R_l, C) and take the stage-1 screen's
// per-anchor maxima, obj_max[b, cell, a] = max(logit[a*kw + 4], -1e4) and
// cls_max[b, cell, a] = max(max_j logit[a*kw + 5 + j], -1e4), in the
// table's dtype (float32 or bfloat16).
//
// Replaces yolort_tpu/ops/pallas/s1_kernel.py (_kernel /
// fused_cells_stage1).  The TPU kernel walks a sequential (B, S) grid whose
// block rows must divide every level (_plan_blocks, else no kernel); here
// each block takes a tile of rows of one level, so any level geometry
// works.  The sigmoid product stays outside, as in JAX.
//
// What bounds it on the H100: bytes.  Every logit is read once and written
// once (batch 8 @640: 68.5 MB each way in float32), plus the maxima.  A
// row is C = 255 values (1020 B in float32, 510 B in bfloat16), so rows
// are not 16-byte aligned: the block copies its tile, a contiguous run of
// rows*C elements in source and destination, one element per thread per
// step (coalesced 4- or 2-byte accesses), as integer bits so NaN payloads
// survive.  The copy also stages the tile in shared memory as floats,
// where one thread per (row, anchor) takes both maxima, so the reduction
// costs no second pass over device memory.
//
// Maxima propagate NaN (as torch.amax and torch.maximum do; fmaxf would
// drop it), and the -1e4 floor is applied as the table's dtype rounds it
// (-9984 in bfloat16).  Every result is one of the inputs or the floor, so
// the bfloat16 store of the float value is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 4;
constexpr int kMaxRows = 16;            // rows of one level per block
constexpr int kSmemFloats = 12 * 1024;  // 48 KB of staged logits at most (no opt-in)

struct Levels {
  const void* src[kMaxLevels];
  int rows[kMaxLevels];        // R_l
  int cell0[kMaxLevels];       // first cell of level l in the table
  int tile0[kMaxLevels + 1];   // first block of level l; tile0[n] = blocks
  int n;
};

__device__ __forceinline__ float to_float(uint32_t v) { return __uint_as_float(v); }
__device__ __forceinline__ float to_float(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ uint32_t from_float<uint32_t>(float v) { return __float_as_uint(v); }
template <>
__device__ __forceinline__ uint16_t from_float<uint16_t>(float v) {
  return static_cast<uint16_t>(__float_as_uint(v) >> 16);  // v is a bfloat16 value
}

// max that keeps a NaN once it has seen one
__device__ __forceinline__ float nan_max(float m, float x) { return (x > m || x != x) ? x : m; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cells_stage1_kernel(Levels lv, int rows_per_block, int n_cells, int C, int A, int kw,
                        float neg, T* __restrict__ cells, T* __restrict__ obj,
                        T* __restrict__ cls) {
  extern __shared__ float tile[];  // rows_per_block * C floats
  const int b = blockIdx.y;
  int l = 0;
  while (l + 1 < lv.n && static_cast<int>(blockIdx.x) >= lv.tile0[l + 1]) ++l;
  const int r0 = (blockIdx.x - lv.tile0[l]) * rows_per_block;
  const int nr = min(rows_per_block, lv.rows[l] - r0);
  const int count = nr * C;
  const T* src = static_cast<const T*>(lv.src[l]) + ((size_t)b * lv.rows[l] + r0) * C;
  const size_t cell = (size_t)b * n_cells + lv.cell0[l] + r0;
  T* dst = cells + cell * C;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const T v = src[i];
    dst[i] = v;
    tile[i] = to_float(v);
  }
  __syncthreads();
  // thread q takes (row q / A, anchor q % A); consecutive threads read
  // shared memory kw words apart, an odd stride for kw = 85
  for (int q = threadIdx.x; q < nr * A; q += kThreads) {
    const int r = q / A, a = q - r * A;
    const float* seg = tile + r * C + a * kw;
    float c = seg[5];
    for (int j = 6; j < kw; ++j) c = nan_max(c, seg[j]);
    obj[cell * A + q] = from_float<T>(nan_max(neg, seg[4]));
    cls[cell * A + q] = from_float<T>(nan_max(neg, c));
  }
}

}  // namespace

extern "C" int yt_cells_stage1(const void* l0, const void* l1, const void* l2, const void* l3,
                               int r0, int r1, int r2, int r3, int n_levels, int B, int C,
                               int A, int kw, float neg, int elem_bytes, void* cells,
                               void* obj, void* cls, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || A < 1 || kw < 6 || C != A * kw)
    return (int)cudaErrorInvalidValue;
  if (elem_bytes != 2 && elem_bytes != 4) return (int)cudaErrorInvalidValue;
  const int rows_per_block = min(kMaxRows, kSmemFloats / C);
  if (rows_per_block < 1) return (int)cudaErrorInvalidValue;
  Levels lv;
  const void* src[kMaxLevels] = {l0, l1, l2, l3};
  const int rows[kMaxLevels] = {r0, r1, r2, r3};
  lv.n = n_levels;
  lv.tile0[0] = 0;
  int n_cells = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (rows[l] < 0) return (int)cudaErrorInvalidValue;
    lv.src[l] = src[l];
    lv.rows[l] = rows[l];
    lv.cell0[l] = n_cells;
    n_cells += rows[l];
    lv.tile0[l + 1] = lv.tile0[l] + (rows[l] + rows_per_block - 1) / rows_per_block;
  }
  const int blocks = lv.tile0[n_levels];
  if (B <= 0 || blocks == 0) return 0;
  const dim3 grid(blocks, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * rows_per_block * C;
  if (elem_bytes == 4)
    cells_stage1_kernel<uint32_t><<<grid, kThreads, smem, s>>>(
        lv, rows_per_block, n_cells, C, A, kw, neg, static_cast<uint32_t*>(cells),
        static_cast<uint32_t*>(obj), static_cast<uint32_t*>(cls));
  else
    cells_stage1_kernel<uint16_t><<<grid, kThreads, smem, s>>>(
        lv, rows_per_block, n_cells, C, A, kw, neg, static_cast<uint16_t*>(cells),
        static_cast<uint16_t*>(obj), static_cast<uint16_t*>(cls));
  return (int)cudaGetLastError();
}
