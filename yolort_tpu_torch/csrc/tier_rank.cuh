// The stage-2 tier step on one 128-entry chunk row, shared by the kernels
// that rank a row's entries (csrc/select_extract.cu, csrc/compact_select.cu):
// read the row as four passes of 32 consecutive entries, one 4-byte load a
// lane a pass (entry 32 j + lane in pass j, so every ballot is in entry
// order), take the gt- and eq-tier ballots of each pass, and find the entry
// of a given rank in a tier, or the rank of a given entry, by popcounts.
//
// Tiers, against the k-th value bits tb: valid bits > thr; gt tier valid
// and bits >= tb + 1 (int32 wrap-around, as in JAX); eq tier valid and
// bits == tb.

#pragma once

#include <climits>

#include <cuda_runtime.h>

namespace tier {

constexpr int kPasses = 4;  // 128 entries = 4 passes of 32 lanes

// the row's four words of this lane: v[j] = row[32 j + lane]
__device__ __forceinline__ void load_row(const int* __restrict__ row, int lane, int (&v)[kPasses]) {
#pragma unroll
  for (int j = 0; j < kPasses; ++j) v[j] = __ldg(row + 32 * j + lane);
}

// warp-collective: bit l of gt[j] / eq[j] says entry 32 j + l is in the
// gt / eq tier; every lane of the warp must call it.  One compare a tier:
// bits > thr && bits >= tb + 1 is bits > max(thr, tb), or bits > thr when
// tb + 1 wraps to INT_MIN; bits > thr && bits == tb is bits == tb when
// tb > thr, else nothing.
__device__ __forceinline__ void ballots(const int (&v)[kPasses], int thr, int tb,
                                        unsigned (&gt)[kPasses], unsigned (&eq)[kPasses]) {
  const int gt_above = tb == INT_MAX ? thr : max(thr, tb);
  const bool eq_valid = tb > thr;
#pragma unroll
  for (int j = 0; j < kPasses; ++j) {
    gt[j] = __ballot_sync(0xffffffffu, v[j] > gt_above);
    eq[j] = __ballot_sync(0xffffffffu, eq_valid && v[j] == tb);
  }
}

// position of the set bit of rank r (0-based, r < popc(x)) in x
__device__ __forceinline__ int nth_set(unsigned x, int r) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) {
    const int c = __popc(x & ((1u << w) - 1u));
    if (r >= c) {
      r -= c;
      x >>= w;
      pos += w;
    }
  }
  return pos;
}

// the entry (0-127) of rank r, in entry order, among the set bits of a
// tier's four pass ballots; -1 when r < 0 or r >= their popcount
__device__ __forceinline__ int entry_of_rank(const unsigned (&bal)[kPasses], int r) {
  unsigned x = 0;
  int pass = -1, rank = 0;
#pragma unroll
  for (int j = 0; j < kPasses; ++j) {
    const int c = __popc(bal[j]);
    if (pass < 0 && r >= 0 && r < c) {
      pass = j;
      x = bal[j];
      rank = r;
    }
    r -= c;
  }
  return pass < 0 ? -1 : 32 * pass + nth_set(x, rank);
}

// the rank of entry 32 j + lane in a tier, in entry order: the tier's set
// bits before it, over the earlier passes and this pass's lower lanes
__device__ __forceinline__ int rank_of(const unsigned (&bal)[kPasses], int j, int lane) {
  int r = __popc(bal[j] & ((1u << lane) - 1u));
#pragma unroll
  for (int i = 0; i < kPasses; ++i)
    if (i < j) r += __popc(bal[i]);
  return r;
}

}  // namespace tier
