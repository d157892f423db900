// Slot -> chunk lookup plus the chunk-row fetch of the stage-2 selection,
// and the stripped variants that split its time.
//
// For output slot s of image b, over the 2m exclusive tier offsets
// off[b, :] (nondecreasing: m gt-tier chunks, then m eq-tier chunks):
//   c     = (number of offsets <= s) - 1, clipped to [0, 2m - 1]
//   is_eq = c >= m,  phys = c - m * is_eq,  p = s - off[b, c]
//   rows[b, s, :] = table[b, phys, :]   (128 float32, copied as bits)
//
// Replaces yolort_tpu/ops/pallas/lookup_kernel.py (_lookup_fetch_kernel /
// pallas_lookup_fetch) and the variants of
// tools/experiments/lookup_kernel_variants.py (make_kernel / run_variant).
// The TPU kernel counts offsets against per-row maxima and fetches rows
// with byte-plane one-hot matmuls, both to avoid the TPU's slow gathers; a
// GPU searches and gathers directly.  One warp per slot: lane 0 runs the
// search in two parts, as the TPU kernel counts: a coarse binary search
// over the whole 128-offset rows (their largest offset is their last, the
// offsets being sorted) and a fine one inside the row where s ends (the
// TPU's boundary loop).  Together they give the upper bound over all 2m
// offsets, so repeated offsets, where a chunk holds no entry of its tier,
// resolve to the last chunk whose offset is <= s, and slots at or past the
// selected total land on c = 2m - 1 and still read an in-range row.  Then
// the warp copies the 512-byte row as 32 16-byte vectors.
//
// The variants switch parts off at compile time (template flags):
//   LOOKUP    off: phys = min(s / 2, m - 1), no search at all
//   BOUNDARY  off: the coarse search alone, c = clip(128 R - 1), where R is
//                  the number of whole rows whose largest offset is <= s,
//                  and p = s - (that row's largest offset, 0 if R = 0)
//   META      off: p and is_eq are not written (phys always is)
//   FETCH     off: the table row is not read; every lane of the output row
//                  holds phys (the write stays)
// The all-on instance (variant 0) is the shipped lookup_fetch.
//
// What bounds it on the H100: bytes written (k rows of 512 B per image:
// 16.8 MB at batch 8, k = 4096) and the latency of the search's dependent
// loads, which stay in L2 (the offsets are 20 KB per image); the table
// (1.3 MB per image at most) is read from L2 after its first touch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kRow = 128;  // offsets per coarse row, the TPU kernel's lane width

template <bool LOOKUP, bool BOUNDARY, bool META, bool FETCH>
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
  int c = 0, base = 0;  // base: the offset p counts from
  if (lane == 0) {
    if (LOOKUP) {
      int lo = 0, hi = m2 / kRow;  // coarse: the first whole row whose last offset is > s
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (o[mid * kRow + kRow - 1] <= s)
          lo = mid + 1;
        else
          hi = mid;
      }
      int n = lo * kRow;  // offsets <= s in the rows before it
      if (BOUNDARY) {     // fine: the first offset > s inside that row
        int hi2 = min(n + kRow, m2);
        while (n < hi2) {
          const int mid = (n + hi2) >> 1;
          if (o[mid] <= s)
            n = mid + 1;
          else
            hi2 = mid;
        }
      }
      c = min(max(n - 1, 0), m2 - 1);
      base = BOUNDARY ? o[c] : (n > 0 ? o[n - 1] : 0);
    } else {
      c = min(s / 2, m - 1);
    }
  }
  c = __shfl_sync(0xffffffffu, c, 0);
  const int eq = LOOKUP && c >= m;
  const int ph = eq ? c - m : c;
  const size_t slot = (size_t)b * k + s;
  if (FETCH)
    rows[slot * 32 + lane] = table[((size_t)b * m + ph) * 32 + lane];
  else
    rows[slot * 32 + lane] = make_int4(ph, ph, ph, ph);
  if (lane == 0) {
    phys_out[slot] = ph;
    if (META) {
      p_out[slot] = s - base;
      is_eq_out[slot] = static_cast<unsigned char>(eq);
    }
  }
}

template <bool LOOKUP, bool BOUNDARY, bool META, bool FETCH>
int launch(const void* table, const void* off, int B, int m, int k, void* rows, void* phys,
           void* p, void* is_eq, void* stream) {
  if (B <= 0 || k <= 0) return 0;
  if (m <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((k + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  lookup_fetch_kernel<LOOKUP, BOUNDARY, META, FETCH>
      <<<grid, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int4*>(table), static_cast<const int*>(off), m, k,
          static_cast<int4*>(rows), static_cast<int*>(phys), static_cast<int*>(p),
          static_cast<unsigned char*>(is_eq));
  return (int)cudaGetLastError();
}

}  // namespace

// The one entry point.  variant: 0 full (ops/cuda/lookup_kernel.py's
// lookup_fetch), 1 no_boundary, 2 no_fetch, 3 fetch_only, 4 lookup_only
// (the order of lookup_kernel.py VARIANTS); p and is_eq may be
// null for the variants that do not write them (3 and 4).
extern "C" int yt_lookup_fetch_variant(const void* table, const void* off, int B, int m, int k,
                                       void* rows, void* phys, void* p, void* is_eq,
                                       int variant, void* stream) {
  switch (variant) {
    case 0:
      return launch<true, true, true, true>(table, off, B, m, k, rows, phys, p, is_eq, stream);
    case 1:
      return launch<true, false, true, true>(table, off, B, m, k, rows, phys, p, is_eq, stream);
    case 2:
      return launch<true, true, true, false>(table, off, B, m, k, rows, phys, p, is_eq, stream);
    case 3:
      return launch<false, false, false, true>(table, off, B, m, k, rows, phys, p, is_eq, stream);
    case 4:
      return launch<true, true, false, false>(table, off, B, m, k, rows, phys, p, is_eq, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
