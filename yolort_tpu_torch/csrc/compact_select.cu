// Stream-compaction placement of the exact top-k: every entry of chunk c's
// tier goes to output position off[b, tier, c] + (its rank in the chunk's
// tier, in entry order) when that is < k, and every other output slot gets
// (0.0, 0).  cnt and off are (B, 2m): [gt tier of chunks 0..m-1, eq tier
// of chunks 0..m-1], off the exclusive prefix sum of cnt, so the output
// holds the strictly-above entries, then the boundary ties, each in index
// order; the selected total is off[2m-1] + cnt[2m-1].  Writes the value
// and its int32 flat index (chunk * 128 + entry).
//
// Replaces yolort_tpu/ops/pallas/compact_kernel.py (_compact_kernel /
// compact_select, pallas_call at :171).  The TPU kernel ranks lanes with a
// triangular matmul and scatters through one-hot placement matmuls into a
// VMEM-resident output across a sequential grid, carrying indices as
// float32.
//
// What bounds it on the H100: latency, then bytes.  It reads the chunk
// rows that hold a placed entry (up to the whole table, 10.5 MB at batch 8,
// (2565, 128)) and the four (B, m) metadata vectors, and writes k * 8 bytes
// an image: a few microseconds of work, a chain of dependent accesses (the
// metadata, then the rows, then the stores) and whatever serial work a warp
// does on top of it.  The design:
//
//   * a block owns a run of 32 consecutive chunks of one image: lane j of
//     each of its warps loads chunk j's gt and eq counts and offsets in four
//     coalesced loads (the block's other warps find them in L1), and the
//     warps ballot the chunks with work (a tier whose count is > 0 and whose
//     offset is < k) and walk only those;
//   * the busy chunks are shared among the block's warps (warp p takes the
//     p-th, (p + warps)-th, ...), because one warp walking a run's busy
//     chunks alone (about 26 at both stage-2 shapes) is a serial chain of
//     instructions many microseconds long, longer than the memory latency
//     it would hide; with the run shared out, a warp walks 1-4 chunks, one
//     row at a time (a second row in flight bought nothing on the H100);
//   * both tiers come from one read of a chunk row: tier::load_row and
//     tier::ballots (csrc/tier_rank.cuh, the tiers select_extract.cu takes
//     too, the tb + 1 wrap included), and lane l of pass j places its entry
//     at its tier's offset + tier::rank_of (popc of the earlier passes plus
//     popc of the pass below lane l);
//   * the empty tail [min(total, k), k) is written by the kernel, shared
//     among the image's threads, so every output slot is written exactly
//     once (the slots below min(total, k) are exactly the placed ones, the
//     offsets being an exclusive prefix sum) and a call is one launch: the
//     wrapper allocates its outputs with torch.empty.
//
// The grid and the block are chosen here, in yt_compact_place: a block each
// run of 32 chunks, grid (ceil(m / 32), B), for m from 1 to 12,500 (391 runs
// an image), B up to 65,535 (the grid's y limit) and any k from 1 to
// m * 128; the warps a block aim the launch at kGridWarps, as a power of two
// from 8 to 32: 32 below about 180 runs in all, 16 at batch 32 serving
// (352 runs), 8 from batch 8 eval (648 runs) up.  At batch 1 serving,
// (325, 128), that is 11 blocks of 32 warps, a block on each of 11 SMs, each
// warp with at most one or two busy chunks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tier_rank.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;         // a block's warps at most: they share its run of 32 chunks
constexpr int kGridWarps = 132 * 40;  // warps a launch aims at: 40 on each of the H100's 132 SMs

__global__ void __launch_bounds__(kMaxWarps * 32)
    compact_place_kernel(const int* __restrict__ table, const int* __restrict__ cnt,
                         const int* __restrict__ off, const int* __restrict__ t, int thr, int m,
                         int k, float* __restrict__ vals, int* __restrict__ idx) {
  const int warps = blockDim.x >> 5;
  const int part = threadIdx.x >> 5;  // this warp's share of the run's chunks
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * 32;  // the block's run of 32 chunks
  const int* cb = cnt + (size_t)b * 2 * m;
  const int* ob = off + (size_t)b * 2 * m;
  const bool have = c0 + lane < m;
  const int cnt_gt = have ? __ldg(cb + c0 + lane) : 0;
  const int cnt_eq = have ? __ldg(cb + m + c0 + lane) : 0;
  const int off_gt = have ? __ldg(ob + c0 + lane) : 0;
  const int off_eq = have ? __ldg(ob + m + c0 + lane) : 0;
  const int total = __ldg(ob + 2 * m - 1) + __ldg(cb + 2 * m - 1);
  const int tb = __ldg(t + b);
  // a tier without work places at k, which no entry reaches
  const int at_gt = cnt_gt > 0 && off_gt < k ? off_gt : k;
  const int at_eq = cnt_eq > 0 && off_eq < k ? off_eq : k;
  const unsigned busy = __ballot_sync(kFull, at_gt < k || at_eq < k);
  // this warp's chunks: the busy ones whose place among the run's busy
  // chunks is part, part + warps, ...
  const bool here = __popc(busy & ((1u << lane) - 1u)) % warps == part;
  unsigned todo = busy & __ballot_sync(kFull, here);
  float* vb = vals + (size_t)b * k;
  int* ib = idx + (size_t)b * k;
  const int step = gridDim.x * blockDim.x;  // the image's lanes
  for (int s = min(max(total, 0), k) + blockIdx.x * blockDim.x + threadIdx.x; s < k; s += step) {
    vb[s] = 0.0f;
    ib[s] = 0;
  }
  const int* tab = table + ((size_t)b * m + c0) * 128;
  for (; todo; todo &= todo - 1) {  // warp-uniform
    const int ch = __ffs(todo) - 1;
    int v[tier::kPasses];
    unsigned gt[tier::kPasses], eq[tier::kPasses];
    tier::load_row(tab + (size_t)ch * 128, lane, v);
    tier::ballots(v, thr, tb, gt, eq);
    const int pos_gt = __shfl_sync(kFull, at_gt, ch);
    const int pos_eq = __shfl_sync(kFull, at_eq, ch);
    const int base = (c0 + ch) * 128 + lane;
#pragma unroll
    for (int j = 0; j < tier::kPasses; ++j) {
      const bool in_gt = (gt[j] >> lane) & 1u, in_eq = (eq[j] >> lane) & 1u;
      const int pos = in_gt ? pos_gt + tier::rank_of(gt, j, lane)
                            : in_eq ? pos_eq + tier::rank_of(eq, j, lane) : k;
      if (pos < k) {
        vb[pos] = __int_as_float(v[j]);
        ib[pos] = base + 32 * j;
      }
    }
  }
}

}  // namespace

extern "C" int yt_compact_place(const void* table, const void* cnt, const void* off,
                                const void* t, int thr_bits, int B, int m, int k, void* vals,
                                void* idx, void* stream) {
  if (B <= 0 || k <= 0) return 0;
  if (m <= 0) return (int)cudaErrorInvalidValue;
  const int runs = (m + 31) / 32;  // of 32 chunks, each image; a block each
  // warps a run: kGridWarps over the runs, as a power of two in [8, 32]
  const long long want = kGridWarps / ((long long)runs * B);
  int warps = 8;
  while (warps < kMaxWarps && warps * 3 / 2 <= want) warps *= 2;
  compact_place_kernel<<<dim3(runs, B), warps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(cnt), static_cast<const int*>(off),
      static_cast<const int*>(t), thr_bits, m, k, static_cast<float*>(vals),
      static_cast<int*>(idx));
  return (int)cudaGetLastError();
}
