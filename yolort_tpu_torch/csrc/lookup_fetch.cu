// Slot -> chunk lookup plus the chunk-row fetch of the stage-2 selection,
// and the stripped variants that split its time.
//
// For output slot s of image b, over the 2m exclusive tier offsets
// off[b, :] (nondecreasing: m gt-tier chunks, then m eq-tier chunks):
//   c     = (number of offsets <= s) - 1, clipped to [0, 2m - 1]
//   is_eq = c >= m,  phys = c - m * is_eq,  p = s - off[b, c]
//   rows[b, s, :] = table[b, phys, :]   (128 float32, copied as bits)
// So repeated offsets, where a chunk holds no entry of its tier, resolve to
// the last chunk whose offset is <= s, and slots at or past the selected
// total land on c = 2m - 1 and still read an in-range row.
//
// Replaces yolort_tpu/ops/pallas/lookup_kernel.py (_lookup_fetch_kernel /
// pallas_lookup_fetch) and the variants of
// tools/experiments/lookup_kernel_variants.py (make_kernel / run_variant).
// The TPU kernel counts offsets against per-row maxima and fetches rows
// with byte-plane one-hot matmuls, both to avoid the TPU's slow gathers; a
// GPU searches and gathers directly.
//
// What bounds it on the H100: bytes written, k rows of 512 B per image
// (16.8 MB at batch 8, k = 4096; the table, at most 1.3 MB per image, is
// read from L2 after its first touch), and, before any row can move, the
// latency of the search's dependent loads, which no lane should wait on
// serially (a binary search over 5,130 offsets is 13 of them).  So:
//   * a block owns kSlots consecutive slots of one image, one thread a slot;
//   * each of its threads loads one probe, evenly spaced over the offsets
//     (every 21st of 5,130), and two __syncthreads_count calls count the
//     probes at or below the run's first and last slots: one round trip
//     bounds every count in the run to a gap of one probe spacing on each
//     side;
//   * each thread then searches its own slot in that range; the probes
//     have just brought the range's lines into L1, so its dependent loads
//     are L1 hits (a shared-memory copy of the range was no faster);
//   * phys, p and is_eq are written one thread a slot, coalesced; then each
//     warp copies kRowsPerWarp rows, 16 B a lane, all its loads issued
//     before its stores (experiments/fetch_block_sweep.py: 2-4 rows a warp
//     beat one by 16-22% at 512-byte rows), one round for the whole run.
// The rows leave by plain stores: on the pallas_lookup route the next
// kernel reads them straight back, and at batch 8 they fit in L2, which
// evict-first (streaming) stores would give up; streaming stores were no
// faster alone.
//
// The variants switch parts off at compile time (template flags):
//   LOOKUP    off: phys = min(s / 2, m - 1), no search at all
//   BOUNDARY  off: the coarse search alone, c = clip(128 R - 1), where R is
//                  the number of whole rows of 128 offsets whose largest
//                  (last) offset is <= s, and p = s - (that row's largest
//                  offset, 0 if R = 0): the same search over the rows'
//                  last offsets in place of every offset
//   META      off: p and is_eq are not written (phys always is)
//   FETCH     off: the table row is not read; every lane of the output row
//                  holds phys (the write stays)
// The all-on instance (variant 0) is the shipped lookup_fetch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerWarp = 4;                      // rows a warp keeps in flight
constexpr int kSlots = 32;                           // slots a block owns
constexpr int kThreads = kSlots / kRowsPerWarp * 32;  // 256: one round of rows
constexpr int kRow = 128;  // offsets per coarse row, the TPU kernel's lane width
static_assert(kSlots <= kThreads, "a thread per slot");

template <bool LOOKUP, bool BOUNDARY, bool META, bool FETCH>
__global__ void __launch_bounds__(kThreads)
    lookup_fetch_kernel(const int4* __restrict__ table, const int* __restrict__ off, int m, int k,
                        int4* __restrict__ rows, int* __restrict__ phys_out,
                        int* __restrict__ p_out, unsigned char* __restrict__ is_eq_out) {
  __shared__ int phys_of[kSlots];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * kSlots;
  const int ns = min(kSlots, k - s0);
  const int m2 = 2 * m;
  // the searched entries: every offset, or the last offset of each whole row
  constexpr int kStride = BOUNDARY ? 1 : kRow;
  const int n_all = m2 / kStride;
  const int* a = off + (size_t)b * m2 + (kStride - 1);  // entry q at a[q * kStride]
  int lo = 0, hi = 0;
  if (LOOKUP) {
    // one probe a thread, evenly spaced: the probes at or below the run's
    // first and last slots bound every count in the run to [lo, hi]
    const int step = (n_all + kThreads - 1) / kThreads;
    const int q = tid * step;
    const int probe = q < n_all ? __ldg(a + (size_t)q * kStride) : 0;
    const int c0 = __syncthreads_count(q < n_all && probe <= s0);
    const int c1 = __syncthreads_count(q < n_all && probe <= s0 + ns - 1);
    lo = c0 > 0 ? (c0 - 1) * step + 1 : 0;
    hi = min(c1 * step, n_all);
  }
  if (tid < ns) {
    const int s = s0 + tid;
    auto at = [&](int q) { return __ldg(a + (size_t)q * kStride); };
    int c, base = 0;  // base: the offset p counts from
    if (LOOKUP) {
      int n = lo, end = hi;  // the count of entries <= s
      while (n < end) {
        const int mid = (n + end) >> 1;
        if (at(mid) <= s)
          n = mid + 1;
        else
          end = mid;
      }
      if (BOUNDARY) {
        c = max(n - 1, 0);  // n <= 2m
        base = at(c);
      } else {
        c = min(max(kRow * n - 1, 0), m2 - 1);
        base = n > 0 ? at(n - 1) : 0;
      }
    } else {
      c = min(s / 2, m - 1);
    }
    const bool eq = LOOKUP && c >= m;
    const int ph = eq ? c - m : c;
    const size_t slot = (size_t)b * k + s;
    phys_out[slot] = ph;
    if (META) {
      p_out[slot] = s - base;
      is_eq_out[slot] = static_cast<unsigned char>(eq);
    }
    phys_of[tid] = ph;
  }
  __syncthreads();
  int4 v[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {  // every load first
    const int i = warp * kRowsPerWarp + r;
    if (i < ns) {
      const int ph = phys_of[i];
      v[r] = FETCH ? table[((size_t)b * m + ph) * 32 + lane] : make_int4(ph, ph, ph, ph);
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = warp * kRowsPerWarp + r;
    if (i < ns) rows[((size_t)b * k + s0 + i) * 32 + lane] = v[r];
  }
}

template <bool LOOKUP, bool BOUNDARY, bool META, bool FETCH>
int launch(const void* table, const void* off, int B, int m, int k, void* rows, void* phys,
           void* p, void* is_eq, void* stream) {
  if (B <= 0 || k <= 0) return 0;
  if (m <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((k + kSlots - 1) / kSlots, B);
  lookup_fetch_kernel<LOOKUP, BOUNDARY, META, FETCH>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
