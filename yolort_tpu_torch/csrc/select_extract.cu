// In-kernel extraction of the stage-2 selection: for each output slot,
// fetch its chunk row table[b, clamp(phys, 0, m - 1), :], recompute the
// slot's tier mask against the k-th value bits t[b] (gt tier: bits >= t+1;
// eq tier: bits == t; both only for valid bits > thr), and emit the p-th
// set lane, in lane order, as (value, lane).  A slot with no such lane
// gives (0.0, 0), as the JAX masked sums do.
//
// Replaces yolort_tpu/ops/pallas/lookup_kernel.py (_select_kernel /
// pallas_select_extract).  The TPU kernel fetches rows with byte-plane
// one-hot matmuls and ranks lanes with a triangular matmul.
//
// What bounds it on the H100: bytes read, the distinct chunk rows (512 B
// each; 8.4 MB at batch 8, (2565, 128), k = 4096, from L2 after the
// selection's count read them) against 8 B written a slot.  Consecutive
// slots share rows: the slots are in chunk order, about two a row there.
// So a run of 32 consecutive slots belongs to a warp, one lane a slot, and
// each distinct row is read once: the lanes are grouped by clamped row
// (__match_any_sync), one leader a group, and the warp issues the loads of
// kRowsInFlight distinct rows before it takes their ballots, in straight-
// line code so the rows' ballots interleave.  A row's gt and eq ballots
// are taken once (csrc/tier_rank.cuh), so slots of both tiers on one row
// cost one read; each lane keeps its own tier's ballots when the row is
// its own, then finds its entry by popcounts and reads the value back from
// the row, which its warp has just loaded.  Lanes past k join lane 0's
// group with rank -1, which cannot hit, so every ballot and match sees the
// full warp.
//
// A row's ballots are a warp-wide chain, so a warp's time grows with its
// run's distinct rows (~16 at both stage-2 shapes).  Where the grid is
// small (B * ceil(k / 32) runs below kSmallGrid: 128 at batch 8, k = 512)
// the card would idle while a few warps walk their rows, so the launch
// gives each run `split` warps (up to kMaxSplit): all of them group the
// run's lanes, and warp `part` of the run walks the rows whose leaders
// are part, part + split, ... in leader order and writes those rows'
// slots.  split is chosen here, at launch, from the grid alone: on the
// H100, splits of 2-16 (with 1-8 rows in flight) helped only below 512
// runs, and 4 warps of 8 rows in flight was the fastest there.  What is
// left above a one-warp-a-slot kernel at such grids is the chain itself:
// the match, the leaders' shuffles and eight rows' ballots before the
// first store (PERF.md, section 6).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tier_rank.cuh"

namespace {

constexpr int kWarpsPerBlock = 2;
constexpr int kRowsInFlight = 8;  // distinct rows whose loads a warp issues together
constexpr int kSmallGrid = 512;   // fewer runs than this share each run among warps
constexpr int kMaxSplit = 4;      // warps a run at most (~4 of its ~16 rows each)

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    select_extract_kernel(const int* __restrict__ table, const int* __restrict__ phys,
                          const int* __restrict__ p, const unsigned char* __restrict__ is_eq,
                          const int* __restrict__ t, int thr, int m, int k, int split,
                          float* __restrict__ vals, int* __restrict__ lanes) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int part = warp % split;  // this warp's share of its run's rows
  const int first = warp / split * 32;
  const int b = blockIdx.y;
  if (first >= k) return;  // the whole warp: every lane agrees
  const int s = first + lane;
  const bool live = s < k;
  const size_t slot = (size_t)b * k + s;
  int ph = 0, want = -1;
  bool eq = false;
  if (live) {
    ph = min(max(phys[slot], 0), m - 1);
    want = p[slot];
    eq = is_eq[slot] != 0;
  }
  const int ph0 = __shfl_sync(0xffffffffu, ph, 0);  // lane 0 always holds a slot
  const int key = live ? ph : ph0;
  const unsigned group = __match_any_sync(0xffffffffu, key);
  const int leader = __ffs(group) - 1;
  const unsigned leaders = __ballot_sync(0xffffffffu, lane == leader);  // a leader a row
  // whether this lane's row is this warp's: its leader's place among the
  // run's leaders, modulo split
  const bool here = __popc(leaders & ((1u << leader) - 1u)) % split == part;
  unsigned todo = leaders & __ballot_sync(0xffffffffu, here);
  const int tb = t[b];
  const int* tab = table + (size_t)b * m * 128;
  unsigned mine[tier::kPasses] = {0u, 0u, 0u, 0u};  // this lane's tier ballots of its row
  while (todo) {  // straight-line inside: the rows' ballots interleave
    int row[kRowsInFlight];
    int v[kRowsInFlight][tier::kPasses];
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) {  // every load first
      const int key_r = __shfl_sync(0xffffffffu, key, todo ? __ffs(todo) - 1 : 0);
      row[r] = todo ? key_r : -1;  // -1: no row left; it reads row 0 and matches no lane
      todo &= todo - 1;
      tier::load_row(tab + (size_t)max(row[r], 0) * 128, lane, v[r]);
    }
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) {  // then the ballots
      unsigned gt[tier::kPasses], eqb[tier::kPasses];
      tier::ballots(v[r], thr, tb, gt, eqb);
      if (key == row[r]) {
#pragma unroll
        for (int j = 0; j < tier::kPasses; ++j) mine[j] = eq ? eqb[j] : gt[j];
      }
    }
  }
  if (!live || !here) return;
  const int e = tier::entry_of_rank(mine, want);
  vals[slot] = e < 0 ? 0.0f : __int_as_float(__ldg(tab + (size_t)key * 128 + e));
  lanes[slot] = e < 0 ? 0 : e;
}

}  // namespace

extern "C" int yt_select_extract(const void* table, const void* phys, const void* p,
                                 const void* is_eq, const void* t, int thr_bits, int B, int m,
                                 int k, void* vals, void* lanes, void* stream) {
  if (B <= 0 || k <= 0) return 0;
  if (m <= 0) return (int)cudaErrorInvalidValue;
  const int runs = (k + 31) / 32;  // of 32 slots, each image
  const int split = max(1, min(kMaxSplit, kSmallGrid / (B * runs)));
  const dim3 grid((runs * split + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  select_extract_kernel<<<grid, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(phys), static_cast<const int*>(p),
      static_cast<const unsigned char*>(is_eq), static_cast<const int*>(t), thr_bits, m, k, split,
      static_cast<float*>(vals), static_cast<int*>(lanes));
  return (int)cudaGetLastError();
}
