// One pass over the head outputs: concatenate the L levels (B, R_l, C)
// into the cells table (B, sum R_l, C) and take the stage-1 screen's
// per-anchor maxima, obj_max[b, cell, a] = max(logit[a*kw + 4], -1e4) and
// cls_max[b, cell, a] = max(max_j logit[a*kw + 5 + j], -1e4), in the
// table's dtype (float32 or bfloat16).
//
// Replaces yolort_tpu/ops/pallas/s1_kernel.py:173 (fused_cells_stage1; its
// body, _kernel, at :110).  The TPU kernel walks a sequential (B, S) grid
// whose block rows must divide every level (_plan_blocks, else no kernel);
// here any level geometry works.  The sigmoid product stays outside, as in
// JAX.
//
// What bounds it on the H100: bytes.  Every logit is read once and written
// once (batch 8 @640 in float32: 68.5 MB each way, plus 1.6 MB of maxima,
// 0.0414 ms at 3.35 TB/s).  The maxima cost a few operations a byte.  So
// the design keeps device memory busy in both directions and takes the
// maxima on the side:
//   * A persistent grid: occupancy x SMs blocks (3 an SM at C = 255).  A
//     tile is (level, image, run of rows); block i takes tiles i, i + grid,
//     i + 2 * grid, ...  in order, so no block waits on a launch and the
//     blocks drift out of step: one block's reduction overlaps another's
//     copies on the same SM.
//   * A ring of shared-memory stages, filled by TMA 1D bulk copies
//     (cp.async.bulk ... mbarrier::complete_tx::bytes).  Thread 0 issues
//     them; each stage completes on its own mbarrier, armed with the byte
//     count (expect_tx).  While a block reduces one tile, the next
//     stages - 2 tiles are in flight, and stages - 1 after its refill.  The
//     stages hold raw bits, so the table's copy is bit for bit, NaN
//     payloads included.
//   * The cells write leaves from the same stage as a bulk store
//     (cp.async.bulk.global.shared::cta.bulk_group).  A stage is refilled
//     only after every thread has passed the block barrier that follows
//     its reads, and after cp.async.bulk.wait_group.read says the store
//     has read it; fence.proxy.async.shared::cta orders those generic reads
//     before the async refill.  Tile k + stages - 1 refills the stage of
//     tile k - 1, whose store has had a whole tile's time to leave.
//   * The maxima come from the stage while the later stages land: 8 lanes
//     take each (row, anchor) segment, about 10 class logits each for
//     kw = 85, nan_max in registers, finished with __shfl_xor_sync, so
//     every thread of the block works (a 32-row bfloat16 tile is 96
//     segments, one per 8 lanes).  The tile's (rows, A) maxima are one
//     contiguous run of obj and cls.
//   * The plan is chosen in one place, make_plan: 16 KB tiles (16 rows in
//     float32, 32 in bfloat16, at C = 255) in a ring of 4 stages, 64 KB of
//     dynamic shared memory a block.  On the H100 that beat 32 KB tiles at
//     one or two blocks an SM, 8 KB tiles and 6 stages in bfloat16, where
//     the reduction weighs twice as much a byte, and matched the best of
//     them in float32 (experiments/stage1_variants.py of commit bedd669;
//     PERF.md).
//
// Alignment.  Bulk copies need 16-byte-aligned global and shared addresses
// and sizes that are multiples of 16 bytes.  At 640 every tile is aligned
// at both ends (rows of 1020 / 510 bytes, tiles of 16 / 32 rows from a
// multiple of the tile, levels of a multiple of 8 rows), but the kernel
// takes any geometry (a 300-row bfloat16 level puts odd images 8 bytes
// off; a level may be a view that starts mid-allocation).  Tile byte i
// lives at stage + pad + i, pad = src % 16, so the source's aligned middle
// lands on an aligned shared address and goes by bulk copy; the head and
// tail (under 16 bytes each) go by lanes of warp 0, whose loads are issued
// before the stage's wait.  If dst % 16 == pad, the same middle leaves by
// bulk store and the lanes store the head and tail from their registers;
// otherwise the tile's stores go through the threads, element by element.
// No tile is refused and no level is copied first.
//
// Exactness.  Maxima propagate NaN (as torch.amax and torch.maximum do;
// fmaxf would drop it); max is exact in any order, so non-NaN maxima are
// the plain version's bits (but for which of -0.0 and +0.0 a tie between
// them returns, which follows the order in both).  NaN positions match the
// plain version.  A NaN's payload is carried through as a register move
// (the select in nan_max; max.NaN would return the canonical NaN), but
// which NaN of a segment comes out follows the reduction order, so
// payloads match where a segment holds one NaN (chip_smoke.py prints
// whether they did).  The -1e4 floor comes in as the table's dtype rounds
// it (-9984 in bfloat16).  Every result is one of the inputs or the floor,
// so the bfloat16 store of the float value's top half is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;                   // lanes per (row, anchor) segment
constexpr int kGroups = kThreads / kLanes;  // segments per pass
constexpr int kMaxLevels = 4;
constexpr int kMaxRows = 64;
constexpr int kTileBytes = 16 * 1024;  // the tile a stage aims to hold
constexpr int kMaxStages = 4;
constexpr int kMinStages = 2;
constexpr int kHeader = 128;  // the stages' mbarriers, before the ring
constexpr int kPieceLanes = 8;  // lanes 0-7 of warp 0 take the head, 16-23 the tail

struct Plan {
  int rows;         // rows of one level a tile
  int stages;       // depth of the ring
  int stage_bytes;  // a tile's bytes and 16 for its front pad, a multiple of 16
  int smem;         // dynamic shared memory of a block
};

// The one place the tile and the ring are chosen: about kTileBytes of
// whole rows, a multiple of 8 rows where there are 8 (so tiles of 510- and
// 1020-byte rows stay 16-byte multiples), as many stages as fit up to
// kMaxStages.  rows == 0 where two stages of one row do not fit.
Plan make_plan(int C, int esize, int smem_cap) {
  Plan p = {0, 0, 0, 0};
  const long long row = (long long)C * esize;
  long long rows = kTileBytes / row;
  rows = rows < 1 ? 1 : rows > kMaxRows ? kMaxRows : rows;
  if (rows >= 8) rows -= rows % 8;
  const long long stage = (rows * row + 15) / 16 * 16 + 16;
  long long stages = (smem_cap - kHeader) / stage;
  if (stages < kMinStages) return p;
  if (stages > kMaxStages) stages = kMaxStages;
  p.rows = (int)rows;
  p.stages = (int)stages;
  p.stage_bytes = (int)stage;
  p.smem = kHeader + p.stages * p.stage_bytes;
  return p;
}

struct Levels {
  const unsigned char* src[kMaxLevels];
  int rows[kMaxLevels];       // R_l
  int cell0[kMaxLevels];      // first cell of level l in the table
  int tiles[kMaxLevels];      // tiles of level l an image
  int tile0[kMaxLevels + 1];  // first tile of level l over the batch; tile0[n] = all
  int n;
};

struct Tile {
  const unsigned char* src;  // its run of rows in the level
  unsigned char* dst;        // where the run goes in the cells table
  size_t cell;               // b * n_cells + its first cell
  int rows, bytes;
  int pad;                   // src % 16: where the tile starts in its stage
  int head, mid, tail;       // bytes by lanes, by bulk copy, by lanes
  bool bulk_store;           // dst % 16 == pad: the middle leaves by bulk store
};

__device__ __forceinline__ Tile tile_at(const Levels& lv, int t, int tile_rows, int n_cells,
                                        int row_bytes, unsigned char* cells) {
  int l = 0;
  while (l + 1 < lv.n && t >= lv.tile0[l + 1]) ++l;
  const int u = t - lv.tile0[l];
  const int b = u / lv.tiles[l];
  const int r0 = (u - b * lv.tiles[l]) * tile_rows;
  Tile x;
  x.rows = min(tile_rows, lv.rows[l] - r0);
  x.bytes = x.rows * row_bytes;
  x.src = lv.src[l] + ((size_t)b * lv.rows[l] + r0) * row_bytes;
  x.cell = (size_t)b * n_cells + lv.cell0[l] + r0;
  x.dst = cells + x.cell * row_bytes;
  x.pad = (int)((uintptr_t)x.src & 15);
  x.head = min(x.bytes, (16 - x.pad) & 15);
  x.mid = (x.bytes - x.head) & ~15;
  x.tail = x.bytes - x.head - x.mid;
  x.bulk_store = (int)((uintptr_t)x.dst & 15) == x.pad;
  return x;
}

// --- mbarriers, bulk copies and fences (PTX, sm_90) ----------------------

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(shared_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(shared_addr(bar)),
               "r"(bytes)
               : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(shared_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(shared_addr(dst)),
      "l"(src), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(shared_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until all but the newest N bulk groups have read their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// --- values ----------------------------------------------------------------

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

// max that keeps a NaN once it has seen one (as torch.amax and
// torch.maximum do; fmaxf would drop it)
__device__ __forceinline__ float nan_max(float m, float x) { return (x > m || x != x) ? x : m; }

constexpr uint32_t kNegInf = 0xff800000u;  // float -inf

// Thread 0: arm the stage's barrier and start the tile's bulk copy, or
// only arrive where the tile has no aligned middle.
__device__ __forceinline__ void issue_load(const Tile& x, unsigned char* stage, uint64_t* full) {
  if (x.mid > 0) {
    mbar_arrive_expect_tx(full, x.mid);
    bulk_load(stage + x.pad + x.head, x.src + x.head, x.mid, full);
  } else {
    mbar_arrive(full);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cells_stage1_kernel(const __grid_constant__ Levels lv, int tile_rows, int stages,
                        int stage_bytes, int n_cells, int C, int A, int kw, float neg,
                        T* __restrict__ cells, T* __restrict__ obj, T* __restrict__ cls) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + kHeader;
  const int tid = threadIdx.x;
  const int group = tid / kLanes, lane = tid % kLanes;
  const int row_bytes = C * (int)sizeof(T);
  unsigned char* table = reinterpret_cast<unsigned char*>(cells);
  const int n_tiles = lv.tile0[lv.n];
  const int first = blockIdx.x, step = gridDim.x;
  const int mine = first < n_tiles ? (n_tiles - first + step - 1) / step : 0;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    fence_mbarrier_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int k = 0; k < stages - 1 && k < mine; ++k)
      issue_load(tile_at(lv, first + k * step, tile_rows, n_cells, row_bytes, table),
                 ring + k * stage_bytes, &full[k]);

  for (int k = 0; k < mine; ++k) {
    const int s = k % stages;
    unsigned char* stage = ring + s * stage_bytes;
    const Tile x = tile_at(lv, first + k * step, tile_rows, n_cells, row_bytes, table);
    T* tile = reinterpret_cast<T*>(stage + x.pad);
    const T* src = reinterpret_cast<const T*>(x.src);
    T* dst = reinterpret_cast<T*>(x.dst);

    // the head and tail pieces, loaded before the wait so that it hides them
    const int nh = x.head / (int)sizeof(T), nt = x.tail / (int)sizeof(T);
    int piece = -1;  // this lane's element of the tile
    if (tid < kPieceLanes && tid < nh)
      piece = tid;
    else if (tid >= 2 * kPieceLanes && tid < 2 * kPieceLanes + nt)
      piece = (x.head + x.mid) / (int)sizeof(T) + tid - 2 * kPieceLanes;
    T v = 0;
    if (piece >= 0) v = src[piece];
    mbar_wait(&full[s], (uint32_t)(k / stages) & 1u);
    if (nh + nt > 0) {  // the same for every thread
      if (piece >= 0) {
        tile[piece] = v;
        if (x.bulk_store) dst[piece] = v;
        fence_proxy_async();  // before the stage's next async write
      }
      __syncthreads();
    }
    const bool stored = x.bulk_store && x.mid > 0;
    if (tid == 0 && stored) bulk_store(x.dst + x.head, stage + x.pad + x.head, x.mid);
    if (!x.bulk_store) {  // source and destination misalign differently
      const int n = x.bytes / (int)sizeof(T);
      for (int i = tid; i < n; i += kThreads) dst[i] = tile[i];
    }

    // the maxima, from the stage; the loop's bounds are the block's, so
    // every lane of a warp takes part in the shuffles
    const int nseg = x.rows * A;
    T* obj_out = obj + x.cell * A;
    T* cls_out = cls + x.cell * A;
    for (int q0 = 0; q0 < nseg; q0 += kGroups) {
      const int q = q0 + group;
      const int r = q / A, a = q - r * A;
      const int seg = r * C + a * kw;  // the segment's first element in the tile
      float c = __uint_as_float(kNegInf);
      if (q < nseg)  // this lane's class logits: lane, lane + kLanes, ...
#pragma unroll 4
        for (int j = seg + 5 + lane; j < seg + kw; j += kLanes) c = nan_max(c, to_float(tile[j]));
      c = nan_max(c, __shfl_xor_sync(0xffffffffu, c, 4));
      c = nan_max(c, __shfl_xor_sync(0xffffffffu, c, 2));
      c = nan_max(c, __shfl_xor_sync(0xffffffffu, c, 1));
      if (q < nseg) {
        if (lane == 0)
          obj_out[q] = from_float<T>(nan_max(neg, to_float(tile[seg + 4])));
        else if (lane == 1)
          cls_out[q] = from_float<T>(nan_max(neg, c));
      }
    }
    __syncthreads();  // every thread is done reading this stage and the last

    // tile k + stages - 1 refills the stage of tile k - 1
    const int kn = k + stages - 1;
    if (tid == 0 && kn < mine) {
      if (stored)
        bulk_wait_read<1>();  // all but this tile's store have read their stage
      else
        bulk_wait_read<0>();
      fence_proxy_async();
      const int sn = kn % stages;
      issue_load(tile_at(lv, first + kn * step, tile_rows, n_cells, row_bytes, table),
                 ring + sn * stage_bytes, &full[sn]);
    }
  }
  if (tid == 0) bulk_wait_all();  // the stores are done before the block's shared memory goes
}

// The plan on the current device, and the persistent grid's size there
// (occupancy x SMs), after raising the kernel's shared-memory limit.
template <typename T>
cudaError_t plan_on_device(int C, Plan* p, int* grid_cap) {
  int dev = 0, cap = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *p = make_plan(C, (int)sizeof(T), cap);
  if (p->rows == 0) return cudaErrorInvalidValue;  // a row larger than half the shared memory
  auto kernel = cells_stage1_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p->smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, p->smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // reported here, not by the next launch
    return err;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid_cap = per_sm * sms;
  return cudaSuccess;
}

template <typename T>
int launch(const void* const* src, const int* rows, int n_levels, int B, int C, int A, int kw,
           float neg, void* cells, void* obj, void* cls, cudaStream_t stream) {
  Plan p;
  int grid_cap = 0;
  cudaError_t err = plan_on_device<T>(C, &p, &grid_cap);
  if (err != cudaSuccess) return (int)err;
  Levels lv;
  lv.n = n_levels;
  lv.tile0[0] = 0;
  long long n_cells = 0, tiles = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.src[l] = static_cast<const unsigned char*>(src[l]);
    lv.rows[l] = rows[l];
    lv.cell0[l] = (int)n_cells;
    lv.tiles[l] = (rows[l] + p.rows - 1) / p.rows;
    n_cells += rows[l];
    tiles += (long long)B * lv.tiles[l];
    if (n_cells > INT32_MAX || tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
    lv.tile0[l + 1] = (int)tiles;
  }
  if (tiles == 0) return 0;
  const int grid = (int)(tiles < grid_cap ? tiles : grid_cap);
  cells_stage1_kernel<T><<<grid, kThreads, p.smem, stream>>>(
      lv, p.rows, p.stages, p.stage_bytes, (int)n_cells, C, A, kw, neg, static_cast<T*>(cells),
      static_cast<T*>(obj), static_cast<T*>(cls));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int yt_cells_stage1(const void* l0, const void* l1, const void* l2, const void* l3,
                               int r0, int r1, int r2, int r3, int n_levels, int B, int C,
                               int A, int kw, float neg, int elem_bytes, void* cells,
                               void* obj, void* cls, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || A < 1 || kw < 6 || C != A * kw)
    return (int)cudaErrorInvalidValue;
  if (elem_bytes != 2 && elem_bytes != 4) return (int)cudaErrorInvalidValue;
  const void* src[kMaxLevels] = {l0, l1, l2, l3};
  const int rows[kMaxLevels] = {r0, r1, r2, r3};
  const void* outs[3] = {cells, obj, cls};
  for (int l = 0; l < n_levels; ++l)
    if (rows[l] < 0 || (uintptr_t)src[l] % elem_bytes) return (int)cudaErrorInvalidValue;
  for (const void* o : outs)
    if ((uintptr_t)o % elem_bytes) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return elem_bytes == 4
             ? launch<uint32_t>(src, rows, n_levels, B, C, A, kw, neg, cells, obj, cls, s)
             : launch<uint16_t>(src, rows, n_levels, B, C, A, kw, neg, cells, obj, cls, s);
}

// The kernel's plan on the current device for rows of C values of
// elem_bytes: out = {rows a tile, stages, bytes a stage, dynamic shared
// memory a block, the persistent grid's size}.
extern "C" int yt_cells_stage1_plan(int C, int elem_bytes, int* out) {
  if (C < 1 || (elem_bytes != 2 && elem_bytes != 4)) return (int)cudaErrorInvalidValue;
  Plan p;
  int grid_cap = 0;
  const cudaError_t err = elem_bytes == 4 ? plan_on_device<uint32_t>(C, &p, &grid_cap)
                                          : plan_on_device<uint16_t>(C, &p, &grid_cap);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.rows;
  out[1] = p.stages;
  out[2] = p.stage_bytes;
  out[3] = p.smem;
  out[4] = grid_cap;
  return 0;
}
