// Greedy NMS keep mask over score-sorted, class-offset candidates.
//
// Replaces yolort_tpu/ops/pallas/nms_kernel.py (_nms_kernel / pallas_nms_mask).
// The TPU kernel turns every suppression reduction into an MXU matmul to
// stay inside Mosaic's layout rules; none of that carries over.  Here one
// block of 1024 threads walks one image, a working tile of kTile = 256
// candidates at a time, in one launch:
//
//   1. suppression by earlier tiles: four threads take each candidate of
//      the tile, each testing it against every fourth box kept so far, and
//      OR their verdicts into a bit set by ballots.  The kept list lives
//      in a (B, yt_nms_scratch_rows, 4) f32 scratch that the wrapper
//      allocates (at most stop_after - 1 + tile boxes an image, K with
//      stop_after = 0) and is read back in pages of kPage boxes through
//      shared memory: one page at stop_after = 300.  K has no cap.
//   2. the tile's own relation: the strict upper-triangular iou > thr bit
//      matrix of the tile (256 x 256 bits, 8 KB of shared memory), one warp
//      per row and one ballot per 32 columns, only for the rows that step 1
//      left alive (the others can never be kept, so their rows are never read).
//   3. the walk: one thread holds the tile's alive set in 8 registers and
//      jumps from keep to keep with __ffs; a keep ANDs its row out of the
//      set.  Every read is from shared memory, so a keep costs tens of
//      cycles, not an L2 round trip, and a removed candidate costs nothing.
//      Step 2 marks the rows that hold an alive candidate ("busy"); in a
//      word with no exit check the walk keeps each run of quiet candidates
//      up to the next busy one at once, and reads only the busy rows.
//   4. the keeps are appended to the kept list and written out.
//
// The early exit is the caller's `tile` (NMSConfig.nms_tile_size), not the
// working tile: at each multiple of `tile` the walk stops once `stop` keeps
// are final, and every candidate from there on passes its validity through,
// exactly as greedy_nms_mask in the JAX package does, so the whole mask is
// identical, not only its first `stop` keeps.
//
// What bounds it on the H100: latency and instructions, not bytes (K = 4096
// boxes are 64 KB an image).  The old design computed the IoUs of every
// valid row against all later candidates (K^2/2 x valid, 2 MB of mask an
// image) and walked one candidate per L2 round trip; this one computes
// about visited x kept + visited x kTile / 2 IoUs and reads nothing but
// the boxes and its own kept list (L2) from device memory.  Steps 1 and 2
// are bound by IoU
// instruction throughput (the correctly rounded division stays: a fast
// __fdividef with an exact fallback near thr measured slower, PERF.md).
//
// Bit-level IoU: every product, sum and quotient is written with the
// round-to-nearest intrinsics, so no FMA contraction can flip `iou > thr`
// on a boundary pair; the operation order follows
// ops/boxes.py:box_iou_matrix.  Every operation there is commutative in its
// two boxes (fminf, fmaxf, __fmul_rn, __fadd_rn), so iou(a, b) and iou(b, a)
// have the same bits: step 1 takes the pair as (kept, candidate), where the
// plain version takes (candidate, kept).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;          // candidates a block takes per step
constexpr int kSplit = 4;           // threads that test one candidate in step 1
constexpr int kThreads = kTile * kSplit;
constexpr int kWarps = kThreads / 32;
constexpr int kWords = kTile / 32;  // 32-bit words of a tile's bit set
constexpr int kPage = 1024;         // kept boxes read back from the scratch at a time

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

__device__ __forceinline__ bool iou_above(float4 a, float area_a, float4 c, float area_c,
                                          float thr) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, c.z), fmaxf(a.x, c.x)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, c.w), fmaxf(a.y, c.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  if (inter == 0.f) return 0.f > thr;  // +-0 / max(union, 1e-12) is +-0
  const float uni = __fsub_rn(__fadd_rn(area_a, area_c), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-12f)) > thr;
}

// Does any of the n boxes at list[from], list[from + kSplit], ... suppress c?
__device__ __forceinline__ bool suppressed(const float4* list, const float* list_area, int from,
                                           int n, float4 c, float area_c, float thr) {
  for (int e = from; e < n; e += kSplit)
    if (iou_above(list[e], list_area[e], c, area_c, thr)) return true;
  return false;
}

__global__ void __launch_bounds__(kThreads)
    nms_mask_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
                    uint8_t* __restrict__ keep, float4* __restrict__ scratch, int rows,
                    int K, float thr, int tile, int stop) {
  __shared__ float4 s_box[kTile];
  __shared__ float s_area[kTile];
  __shared__ uint32_t s_rel[kTile * kWords];  // row r: bits j > r with iou(r, j) > thr
  __shared__ float4 s_page[kPage];
  __shared__ float s_page_area[kPage];
  __shared__ uint32_t s_valid[kWords], s_supp[kWords], s_keep[kWords];
  __shared__ uint32_t s_busy[kWords];  // alive candidates whose row holds an alive one
  __shared__ int s_kept_n, s_next_exit, s_exit;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = tid % kTile, part = tid / kTile;  // step 1: candidate j, kept part, part + kSplit...
  const float4* bx = boxes + (size_t)b * K;
  const uint8_t* vb = valid + (size_t)b * K;
  uint8_t* kb = keep + (size_t)b * K;
  float4* kept_list = scratch + (size_t)b * rows;

  if (tid == 0) {
    s_kept_n = 0;
    s_next_exit = tile;  // the first multiple of `tile` where the exit is checked
    s_exit = K;          // where the walk stopped; K while it runs
  }
  for (int start = 0;; start += kTile) {
    __syncthreads();
    const int kept = s_kept_n;
    if (start >= s_exit) break;
    const int i = start + j;
    const bool in = i < K;
    if (part == 0) {
      const float4 box = in ? bx[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      s_box[j] = box;
      s_area[j] = box_area(box);
      const uint32_t v = __ballot_sync(0xffffffffu, in && vb[i]);
      if (lane == 0) {
        s_valid[warp] = v;
        s_supp[warp] = 0u;
        s_busy[warp] = 0u;
      }
    }
    __syncthreads();

    // 1. suppression by the boxes kept in earlier tiles, kSplit threads a
    // candidate; the previous tiles' appends are visible after __syncthreads
    const float4 box = s_box[j];
    const float area = s_area[j];
    bool supp = false;
    for (int p0 = 0; p0 < kept; p0 += kPage) {
      const int n = min(kPage, kept - p0);
      if (p0 > 0) __syncthreads();  // every thread is done with the previous page
      for (int e = tid; e < n; e += kThreads) {
        const float4 kbox = kept_list[p0 + e];
        s_page[e] = kbox;
        s_page_area[e] = box_area(kbox);
      }
      __syncthreads();
      if (!supp && ((s_valid[j >> 5] >> (j & 31)) & 1u))
        supp = suppressed(s_page, s_page_area, part, n, box, area, thr);
    }
    const uint32_t supp_bits = __ballot_sync(0xffffffffu, supp);
    if (lane == 0 && supp_bits) atomicOr(&s_supp[(warp % (kTile / 32))], supp_bits);
    __syncthreads();

    // 2. the tile's relation, for the rows that can still be kept
    for (int r = warp; r < kTile; r += kWarps) {
      if (!(((s_valid[r >> 5] & ~s_supp[r >> 5]) >> (r & 31)) & 1u)) continue;
      const float4 a = s_box[r];
      const float area_a = s_area[r];
      uint32_t any = 0u;
      for (int w = r >> 5; w < kWords; ++w) {
        const uint32_t alive = s_valid[w] & ~s_supp[w];
        uint32_t bits = 0u;
        if (alive != 0u) {  // a word of dead candidates holds nothing to suppress
          const int c = 32 * w + lane;
          const bool hit = c > r && iou_above(a, area_a, s_box[c], s_area[c], thr);
          bits = __ballot_sync(0xffffffffu, hit) & alive;
        }
        if (lane == 0) s_rel[r * kWords + w] = bits;
        any |= bits;
      }
      if (lane == 0 && any) atomicOr(&s_busy[r >> 5], 1u << (r & 31));
    }
    __syncthreads();

    // 3. the walk, keep to keep; the exit checked at each multiple of `tile`
    if (tid == 0) {
      uint32_t live[kWords], kbits[kWords];
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        live[w] = s_valid[w] & ~s_supp[w];
        kbits[w] = 0u;
      }
      int n = kept, next = s_next_exit, exit_at = K;
      bool stopped = false;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        uint32_t word = live[w];
        if (next > start + 32 * w + 31) {
          // no exit check falls in this word: a run of quiet candidates up
          // to the next busy one is kept at once, and only a busy one's
          // row is read
          const uint32_t busy = s_busy[w];
          while (word != 0u) {
            const uint32_t loud = word & busy;
            const uint32_t upto = loud ? word & ((loud & (0u - loud)) * 2u - 1u) : word;
            kbits[w] |= upto;
            n += __popc(upto);
            word &= ~upto;
            if (loud) {
              const uint32_t* row = s_rel + (32 * w + __ffs(loud) - 1) * kWords;
              word &= ~row[w];
#pragma unroll
              for (int v = w + 1; v < kWords; ++v) live[v] &= ~row[v];
            }
          }
          continue;
        }
        while (word != 0u && !stopped) {
          const int bit = __ffs(word) - 1;
          const int pos = start + 32 * w + bit;
          for (; next <= pos; next += tile) {
            if (n >= stop) {
              exit_at = next;
              stopped = true;
              break;
            }
          }
          if (stopped) break;
          kbits[w] |= 1u << bit;
          ++n;
          const uint32_t* row = s_rel + (32 * w + bit) * kWords;
          word &= (word - 1u) & ~row[w];  // drop this bit and the ones it suppresses
#pragma unroll
          for (int v = w + 1; v < kWords; ++v) live[v] &= ~row[v];
        }
        if (stopped) break;
      }
      if (!stopped) {  // multiples of `tile` after the tile's last keep
        for (; next <= start + kTile; next += tile) {
          if (n >= stop) {
            exit_at = next;
            break;
          }
        }
      }
#pragma unroll
      for (int w = 0; w < kWords; ++w) s_keep[w] = kbits[w];
      s_kept_n = n;
      s_next_exit = next;
      s_exit = exit_at;
    }
    __syncthreads();

    // 4. append the tile's keeps to the kept list; write the tile out
    if (part == 0) {
      const bool k_i = (s_keep[warp] >> lane) & 1u;
      if (k_i) {
        int slot = kept + __popc(s_keep[warp] & ((1u << lane) - 1u));
        for (int w = 0; w < warp; ++w) slot += __popc(s_keep[w]);
        kept_list[slot] = box;
      }
      if (in && i < s_exit) kb[i] = k_i;
    }
  }
  // candidates past the early exit pass their validity through
  for (int i = s_exit + tid; i < K; i += kThreads) kb[i] = vb[i];
}

}  // namespace

// Rows per image of the kept-box scratch: the exit is checked at multiples
// of `tile` once `stop` keeps are final, so an image keeps at most
// min(K, stop - 1 + tile) boxes; stop > K never exits.
extern "C" int yt_nms_scratch_rows(int K, int tile, int stop) {
  const long long most = stop - 1LL + tile;
  return most < K ? static_cast<int>(most) : K;
}

// scratch: (B, yt_nms_scratch_rows(K, tile, stop), 4) f32.
extern "C" int yt_nms_mask(const void* boxes, const void* valid, void* keep, void* scratch,
                           int B, int K, float iou_thresh, int tile, int stop, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  if (tile <= 0 || stop <= 0 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  nms_mask_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), static_cast<float4*>(scratch),
      yt_nms_scratch_rows(K, tile, stop), K, iou_thresh, tile, stop);
  return (int)cudaGetLastError();
}
