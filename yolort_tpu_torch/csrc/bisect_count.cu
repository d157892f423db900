// Exact k-th largest score bits over a (m, 128) chunk table, plus the
// per-chunk counts of the strictly-above tier and the boundary tier.
//
// Replaces yolort_tpu/ops/pallas/lookup_kernel.py (_bisect_count_kernel /
// pallas_bisect_count).  The TPU kernel bisects with 4 arms over 16 passes
// on a VMEM-resident table.  Its result is the unique fixed point of
// count(bits >= t) >= k > count(bits >= t + 1) over the valid entries
// (bits > thr_bits), which is the k-th largest valid bit pattern, so any
// exact selection gives the same t.  Here: a 4-pass 8-bit radix select on
// the int32 patterns, one block of 1024 threads per image.
//
// What bounds it on the H100: memory reads (the eval table is 2565 x 128 x
// 4 B = 1.3 MB per image, larger than a block's 227 KB of shared memory, so
// it is re-read from L2 on each pass) and shared-memory atomics on the
// histogram, where score distributions pile into a few bins.  The design
// reads 16-byte vectors and aggregates each warp's equal bins with
// __match_any_sync before one atomic per distinct bin.
//
// Edges, as ops/select.py:_bisect_kth_bits defines them: with fewer than k
// valid entries t is the smallest valid pattern; with none, t is 0x40000000
// (the bits of 2.0f).  The contract holds for valid patterns in
// [0, 0x40000000), i.e. scores in [0, 2) and a threshold >= 0.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kNoBin = 256;

__device__ __forceinline__ unsigned order_key(int v) {
  return static_cast<unsigned>(v) ^ 0x80000000u;
}

__device__ __forceinline__ void hist_add(unsigned* hist, int bin) {
  const unsigned peers = __match_any_sync(0xffffffffu, bin);
  if (bin != kNoBin && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&hist[bin], __popc(peers));
}

// Warp 0: find the digit holding the need-th largest entry of hist.
// Writes the digit and the rank left inside it to digit_out / need_out, and
// the histogram total to total_out.
__device__ void select_digit(const unsigned* hist, unsigned need, int* digit_out,
                             unsigned* need_out, unsigned* total_out) {
  const int lane = threadIdx.x & 31;
  unsigned c[8];
  unsigned sum = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    c[q] = hist[255 - 8 * lane - q];  // lane 0 holds the highest bins
    sum += c[q];
  }
  unsigned incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned n = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += n;
  }
  const unsigned total = __shfl_sync(0xffffffffu, incl, 31);
  if (lane == 0) *total_out = total;
  const unsigned excl = incl - sum;
  const bool hit = need >= 1 && excl < need && need <= incl;
  if (hit) {
    unsigned cum = excl;
    for (int q = 0; q < 8; ++q) {
      if (cum + c[q] >= need) {
        *digit_out = 255 - 8 * lane - q;
        *need_out = need - cum;
        break;
      }
      cum += c[q];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    bisect_count_kernel(const int* __restrict__ bits, int m, int k, int thr,
                        int* __restrict__ t_out, int* __restrict__ cnt_gt,
                        int* __restrict__ cnt_eq) {
  __shared__ unsigned hist[256];
  __shared__ int warp_min[kThreads / 32];
  __shared__ unsigned s_prefix, s_need, s_total;
  __shared__ int s_digit, s_t, s_done;

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int4* x4 = reinterpret_cast<const int4*>(bits + (size_t)b * m * 128);
  const int n4 = m * 32;

  // pass 0: top digit histogram, smallest valid pattern
  for (int i = threadIdx.x; i < 256; i += kThreads) hist[i] = 0;
  __syncthreads();
  int lmin = INT_MAX;
  for (int base = 0; base < n4; base += kThreads) {
    const int q = base + threadIdx.x;
    const int4 v = q < n4 ? x4[q] : make_int4(thr, thr, thr, thr);
    const int e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool ok = e[u] > thr;
      if (ok) lmin = min(lmin, e[u]);
      hist_add(hist, ok ? static_cast<int>(order_key(e[u]) >> 24) : kNoBin);
    }
  }
  lmin = __reduce_min_sync(0xffffffffu, lmin);
  if (lane == 0) warp_min[warp] = lmin;
  __syncthreads();
  if (warp == 0) {
    const int wmin = __reduce_min_sync(0xffffffffu, warp_min[lane]);
    select_digit(hist, static_cast<unsigned>(k), &s_digit, &s_need, &s_total);
    __syncwarp();
    if (lane == 0) {
      if (s_total == 0) {
        s_t = 0x40000000;
        s_done = 1;
      } else if (s_total < static_cast<unsigned>(k)) {
        s_t = wmin;
        s_done = 1;
      } else {
        s_prefix = static_cast<unsigned>(s_digit);
        s_done = 0;
      }
    }
  }
  __syncthreads();

  // passes 1..3: next digit among the entries that share the prefix
  if (!s_done) {
    for (int pass = 1; pass < 4; ++pass) {
      const int shift = 24 - 8 * pass;
      for (int i = threadIdx.x; i < 256; i += kThreads) hist[i] = 0;
      __syncthreads();
      const unsigned prefix = s_prefix;
      for (int base = 0; base < n4; base += kThreads) {
        const int q = base + threadIdx.x;
        const int4 v = q < n4 ? x4[q] : make_int4(thr, thr, thr, thr);
        const int e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const unsigned key = order_key(e[u]);
          const bool ok = e[u] > thr && (key >> (shift + 8)) == prefix;
          hist_add(hist, ok ? static_cast<int>((key >> shift) & 255u) : kNoBin);
        }
      }
      __syncthreads();
      if (warp == 0) {
        const unsigned need = s_need;
        __syncwarp();  // every lane has read s_need before the hit lane rewrites it
        select_digit(hist, need, &s_digit, &s_need, &s_total);
        __syncwarp();
        if (lane == 0) s_prefix = (s_prefix << 8) | static_cast<unsigned>(s_digit);
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) s_t = static_cast<int>(s_prefix ^ 0x80000000u);
    __syncthreads();
  }

  // per-chunk tier counts: one warp per 128-entry row
  const int t = s_t;
  const int t1 = static_cast<int>(static_cast<unsigned>(t) + 1u);  // int32 wrap, as in JAX
  for (int row = warp; row < m; row += kThreads / 32) {
    const int4 v = x4[row * 32 + lane];
    const int e[4] = {v.x, v.y, v.z, v.w};
    int g = 0, q = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool ok = e[u] > thr;
      g += ok && e[u] >= t1;
      q += ok && e[u] == t;
    }
    g = __reduce_add_sync(0xffffffffu, g);
    q = __reduce_add_sync(0xffffffffu, q);
    if (lane == 0) {
      cnt_gt[(size_t)b * m + row] = g;
      cnt_eq[(size_t)b * m + row] = q;
    }
  }
  if (threadIdx.x == 0) t_out[b] = t;
}

}  // namespace

extern "C" int yt_bisect_count(const void* bits, int B, int m, int k, int thr_bits,
                               void* t, void* cnt_gt, void* cnt_eq, void* stream) {
  if (B <= 0 || m <= 0) return 0;
  if (k < 1) return (int)cudaErrorInvalidValue;
  bisect_count_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bits), m, k, thr_bits, static_cast<int*>(t),
      static_cast<int*>(cnt_gt), static_cast<int*>(cnt_eq));
  return (int)cudaGetLastError();
}
