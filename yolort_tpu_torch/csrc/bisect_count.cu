// Exact k-th largest score bits over a (m, 128) chunk table, plus the
// per-chunk counts of the strictly-above tier and the boundary tier.
//
// Replaces yolort_tpu/ops/pallas/lookup_kernel.py (_bisect_count_kernel /
// pallas_bisect_count).  The TPU kernel bisects with 4 arms over 16 passes
// on a VMEM-resident table.  Its result is the unique fixed point of
// count(bits >= t) >= k > count(bits >= t + 1) over the valid entries
// (bits > thr_bits), which is the k-th largest valid bit pattern, so any
// exact selection gives the same t.  Here: a 4-pass 8-bit radix select on
// the int32 patterns, by a thread-block cluster of C blocks per image
// (C = 2-16, launched with cudaLaunchKernelEx; the wrapper's bisect_plan
// picks C and the mode from the table).
//
// Each block of a cluster owns a contiguous run of whole 128-entry rows.
//   * resident mode: the block copies its rows into dynamic shared memory
//     once (16-byte cp.async; whole rows keep the copies aligned), and
//     every pass and the tier counts read them from there.  The eval table
//     (2565 x 128 x 4 B = 1.3 MB an image) is read from device memory once,
//     in slices of 82 KB a block.
//   * streaming mode, for a slice larger than half an SM's shared memory
//     (a 12,500-row table at pre_nms_topk = 20000 is 6.4 MB an image): the
//     same passes read the slice from device memory (L2) each time.  Half,
//     so that two blocks share an SM and a 16-block cluster needs 8 SMs of
//     a GPC, not 16.
// Each pass builds the block's 256-bin histogram in its own shared memory;
// after cluster.sync() every block sums the C histograms through
// distributed shared memory (cluster.map_shared_rank) and picks the digit
// itself, so no broadcast is needed and every block reaches the same
// prefix.  The histograms alternate between two buffers by pass, so no
// block clears one that a peer may still read: a peer reads pass p's
// buffer before it reaches pass p + 1's cluster.sync(), and the buffer is
// cleared again only after that barrier.  One last cluster.sync() keeps
// every block's shared memory alive until its peers are done reading it.
//
// What bounds it on the H100: device-memory bytes (the table once) and,
// past them, the latency of four dependent passes, each with a cluster
// barrier and a histogram exchange, and the shared-memory atomics of the
// histograms.  Plain atomicAdd per entry measured faster on the card than
// aggregating each warp's equal bins with __match_any_sync first (PERF.md).
//
// Edges, as ops/select.py:_bisect_kth_bits defines them: with fewer than k
// valid entries t is the smallest valid pattern; with none, t is 0x40000000
// (the bits of 2.0f).  The contract holds for valid patterns in
// [0, 0x40000000), i.e. scores in [0, 2) and a threshold >= 0.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kNoBin = 256;
constexpr int kMaxCluster = 16;
constexpr int kRowBytes = 128 * 4;

__device__ __forceinline__ unsigned order_key(int v) {
  return static_cast<unsigned>(v) ^ 0x80000000u;
}

__device__ __forceinline__ void hist_add(unsigned* hist, int bin) {
  if (bin != kNoBin) atomicAdd(&hist[bin], 1u);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
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

// What a block shows its cluster peers.
struct Exchange {
  unsigned hist[2][256];  // this block's histogram, double-buffered by pass
  int min;                // this block's smallest valid pattern (pass 0)
};

// The cluster's histogram of buffer `buf` into sum (256 threads), and in
// pass 0 the cluster's smallest valid pattern into *min_out.
__device__ void cluster_sum(cg::cluster_group& cluster, Exchange& ex, int buf, unsigned* sum,
                            int* min_out) {
  const unsigned nblocks = cluster.num_blocks();
  if (threadIdx.x < 256) {
    unsigned s = 0;
#pragma unroll
    for (unsigned r = 0; r < kMaxCluster; ++r)  // unrolled: the remote reads overlap
      if (r < nblocks) s += cluster.map_shared_rank(&ex.hist[buf][0], r)[threadIdx.x];
    sum[threadIdx.x] = s;
  }
  if (min_out != nullptr && threadIdx.x == 256) {
    int mn = INT_MAX;
    for (unsigned r = 0; r < nblocks; ++r) mn = min(mn, *cluster.map_shared_rank(&ex.min, r));
    *min_out = mn;
  }
  __syncthreads();
}

template <bool kResident>
__global__ void __launch_bounds__(kThreads)
    bisect_count_kernel(const int* __restrict__ bits, int m, int rows_per, int k, int thr,
                        int* __restrict__ t_out, int* __restrict__ cnt_gt,
                        int* __restrict__ cnt_eq) {
  extern __shared__ int4 s_rows[];  // resident mode: this block's rows
  __shared__ Exchange ex;
  __shared__ unsigned s_sum[256];
  __shared__ int warp_min[kWarps];
  __shared__ unsigned s_prefix, s_need, s_total;
  __shared__ int s_digit, s_t, s_done, s_min;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = min(m, rank * rows_per);
  const int nrows = min(m, row0 + rows_per) - row0;
  const int n4 = nrows * 32;
  const int4* g4 = reinterpret_cast<const int4*>(bits + ((size_t)b * m + row0) * 128);
  const int4* x4 = kResident ? s_rows : g4;

  if (kResident) {
    for (int q = threadIdx.x; q < n4; q += kThreads) cp_async16(s_rows + q, g4 + q);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < 2 * 256; i += kThreads) ex.hist[i >> 8][i & 255] = 0;
  __syncthreads();

  // pass 0: top digit histogram, smallest valid pattern
  int lmin = INT_MAX;
  for (int base = 0; base < n4; base += kThreads) {
    const int q = base + threadIdx.x;
    const int4 v = q < n4 ? x4[q] : make_int4(thr, thr, thr, thr);
    const int e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool ok = e[u] > thr;
      if (ok) lmin = min(lmin, e[u]);
      hist_add(ex.hist[0], ok ? static_cast<int>(order_key(e[u]) >> 24) : kNoBin);
    }
  }
  lmin = __reduce_min_sync(0xffffffffu, lmin);
  if (lane == 0) warp_min[warp] = lmin;
  __syncthreads();
  if (warp == 0) {
    const int wmin = __reduce_min_sync(0xffffffffu, lane < kWarps ? warp_min[lane] : INT_MAX);
    if (lane == 0) ex.min = wmin;
  }
  cluster.sync();
  cluster_sum(cluster, ex, 0, s_sum, &s_min);
  if (warp == 0) {
    select_digit(s_sum, static_cast<unsigned>(k), &s_digit, &s_need, &s_total);
    __syncwarp();
    if (lane == 0) {
      if (s_total == 0) {
        s_t = 0x40000000;
        s_done = 1;
      } else if (s_total < static_cast<unsigned>(k)) {
        s_t = s_min;
        s_done = 1;
      } else {
        s_prefix = static_cast<unsigned>(s_digit);
        s_done = 0;
      }
    }
  }
  __syncthreads();

  // passes 1..3: next digit among the entries that share the prefix; every
  // block of the cluster takes the same branch (same sums, same decisions)
  if (!s_done) {
    for (int pass = 1; pass < 4; ++pass) {
      const int shift = 24 - 8 * pass;
      unsigned* hist = ex.hist[pass & 1];
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
      cluster.sync();
      cluster_sum(cluster, ex, pass & 1, s_sum, nullptr);
      if (warp == 0) {
        const unsigned need = s_need;
        __syncwarp();  // every lane has read s_need before the hit lane rewrites it
        select_digit(s_sum, need, &s_digit, &s_need, &s_total);
        __syncwarp();
        if (lane == 0) s_prefix = (s_prefix << 8) | static_cast<unsigned>(s_digit);
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) s_t = static_cast<int>(s_prefix ^ 0x80000000u);
  }
  // no peer reads this block's shared memory after this barrier
  cluster.sync();

  // the block's rows' tier counts: one warp per 128-entry row
  const int t = s_t;
  const int t1 = static_cast<int>(static_cast<unsigned>(t) + 1u);  // int32 wrap, as in JAX
  for (int row = warp; row < nrows; row += kWarps) {
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
      cnt_gt[(size_t)b * m + row0 + row] = g;
      cnt_eq[(size_t)b * m + row0 + row] = q;
    }
  }
  if (rank == 0 && threadIdx.x == 0) t_out[b] = t;
}

template <bool kResident>
int launch(const int* bits, int B, int m, int k, int thr, int* t, int* cnt_gt, int* cnt_eq,
           int cluster, cudaStream_t stream) {
  auto kernel = bisect_count_kernel<kResident>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int rows_per = (m + cluster - 1) / cluster;
  const long long dyn = kResident ? (long long)rows_per * kRowBytes : 0;
  if (dyn > INT_MAX) return (int)cudaErrorInvalidValue;
  // per device: allow the 16-block cluster once, and raise the dynamic
  // shared-memory limit to what a launch asks for; the runtime refuses a
  // slice that does not fit beside the kernel's static part (the plan,
  // bisect_plan, keeps a block to half an SM)
  static long long limit[64] = {};  // 1 + the dynamic shared-memory limit set, per device
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (limit[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    limit[dev] = 1;
  }
  if (dyn + 1 > limit[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) {
      cudaGetLastError();  // refused here: leave no error for the next launch to report
      return (int)err;
    }
    limit[dev] = 1 + dyn;
  }

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)dyn;
  cfg.stream = stream;
  cudaLaunchAttribute cluster_dim[1];
  cluster_dim[0].id = cudaLaunchAttributeClusterDimension;
  cluster_dim[0].val.clusterDim.x = cluster;
  cluster_dim[0].val.clusterDim.y = 1;
  cluster_dim[0].val.clusterDim.z = 1;
  cfg.attrs = cluster_dim;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, bits, m, rows_per, k, thr, t, cnt_gt, cnt_eq);
  if (err != cudaSuccess) cudaGetLastError();  // reported here, not by the next launch
  return (int)err;
}

}  // namespace

// cluster: blocks per image, 2-16; resident: 1 to hold each block's rows
// in shared memory (it must fit), 0 to stream them from device memory.
extern "C" int yt_bisect_count(const void* bits, int B, int m, int k, int thr_bits, void* t,
                               void* cnt_gt, void* cnt_eq, int cluster, int resident,
                               void* stream) {
  if (B <= 0 || m <= 0) return 0;
  if (k < 1 || cluster < 2 || cluster > kMaxCluster || B > 65535)
    return (int)cudaErrorInvalidValue;
  auto fn = resident ? launch<true> : launch<false>;
  return fn(static_cast<const int*>(bits), B, m, k, thr_bits, static_cast<int*>(t),
            static_cast<int*>(cnt_gt), static_cast<int*>(cnt_eq), cluster,
            static_cast<cudaStream_t>(stream));
}
