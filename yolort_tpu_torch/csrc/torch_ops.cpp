// The serving routes' kernels as dispatcher ops for a process without
// Python: the schemas of yolort_tpu_torch/ops/library.py (SCHEMAS) with the
// same CUDA implementations, which call the kernels' C entry points
// (csrc/*.cu, built into libyolort_kernels_<hash>.so by ops/cuda/_build.py)
// on the current CUDA stream.  An AOTInductor package of the serving
// pipeline calls these ops by name; the C++ driver of deployment/libtorch
// dlopens this library before it loads the package.
//
// Loaded only by the C++ driver, never in a Python process: where
// ops/library.py has defined the yolort_tpu ops, loading this library
// fails with a duplicate definition of the namespace.
//
// The launch plans are copies of the Python ones (bisect_plan,
// row_fetch_geometry in ops/cuda/lookup_kernel.py; the stage-1 plan is the
// kernels' own C function yt_cells_stage1_plan): a different plan changes
// only the speed, never the result.  yt_ops_plans prints them for a check
// beside the Python plans; yt_ops_launches counts each kernel's launches,
// as the Python wrappers' `launches` attributes do.
//
// Build: ops/cuda/_build_cpp.py (g++ against the torch wheel's headers).

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <tuple>

extern "C" {
int yt_nms_mask(const void* boxes, const void* valid, void* keep, void* scratch, int B, int K,
                float iou_thresh, int tile, int stop, void* stream);
int yt_nms_scratch_rows(int K, int tile, int stop);
int yt_bisect_count(const void* bits, int B, int m, int k, int thr_bits, void* t, void* cnt_gt,
                    void* cnt_eq, int cluster, int resident, void* stream);
int yt_row_fetch_p(const void* table, const void* idx, void* out, int B, int m, int k,
                   int row_bytes, int warps_per_block, int rows_per_warp, void* stream);
int yt_cells_stage1(const void* l0, const void* l1, const void* l2, const void* l3, int r0,
                    int r1, int r2, int r3, int n_levels, int B, int C, int A, int kw, float neg,
                    int elem_bytes, void* cells, void* obj, void* cls, void* stream);
int yt_cells_stage1_plan(int C, int elem_bytes, int* out);
int yt_lookup_fetch_variant(const void* table, const void* off, int B, int m, int k, void* rows,
                            void* phys, void* p, void* is_eq, int variant, void* stream);
int yt_select_extract(const void* table, const void* phys, const void* p, const void* is_eq,
                      const void* t, int thr_bits, int B, int m, int k, void* vals, void* lanes,
                      void* stream);
}

namespace {

constexpr int64_t kChunk = 128;
constexpr int64_t kNoValidBits = 0x40000000;  // bits of 2.0f
constexpr int64_t kBisectSmemBytes = 100 * 1024;
constexpr int64_t kRowBytes = kChunk * 4;
constexpr int kFetchWarpsPerBlock = 4;
constexpr int64_t kFetchSmallSlots = 2048;
constexpr int kMaxLevels = 4;
constexpr float kNegLogit = -1.0e4f;

enum Kernel { kStage1, kBisect, kRowFetch, kLookupFetch, kSelectExtract, kNms, kKernels };
const char* const kKernelNames[kKernels] = {"fused_cells_stage1", "bisect_count", "row_fetch",
                                            "lookup_fetch", "select_extract", "nms_mask"};
std::atomic<long long> g_launches[kKernels];

// ops/cuda/lookup_kernel.py bisect_plan: 8 blocks an image while a block
// gets at most 64 rows, else 16, never more than the rows nor fewer than 2;
// resident when a block's rows fit in 100 KB of shared memory.
void bisect_plan(int64_t bsz, int64_t m, int* cluster, int* resident) {
  TORCH_CHECK(bsz >= 1 && bsz <= 65535 && m >= 1,
              "bisect_plan needs 1-65535 images and a row, got (", bsz, ", ", m, ")");
  const int64_t c = std::max<int64_t>(2, std::min<int64_t>(m <= 8 * 64 ? 8 : 16, m));
  *cluster = static_cast<int>(c);
  *resident = ((m + c - 1) / c) * kRowBytes <= kBisectSmemBytes;
}

// ops/cuda/lookup_kernel.py row_fetch_geometry: (warps a block, slots a warp)
void row_fetch_geometry(int64_t row_bytes, int64_t bsz, int64_t k, int* warps, int* rows) {
  *warps = kFetchWarpsPerBlock;
  *rows = (row_bytes % 16 == 0 && bsz * k >= kFetchSmallSlots) ? 4 : 2;
}

void check_rc(int rc, const char* name) {
  TORCH_CHECK(rc == 0, name, ": CUDA error ", rc, " at launch");
}

void* stream_of(const at::Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

void check_table(const at::Tensor& table, const char* name) {
  TORCH_CHECK(table.is_cuda() && table.dim() == 3 && table.size(2) == kChunk &&
                  table.scalar_type() == at::kFloat && table.size(1) >= 1,
              name, ": table must be a (B, m, 128) float32 CUDA tensor with a row");
  TORCH_CHECK(table.is_contiguous(), name, " needs contiguous inputs");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(table.data_ptr()) % 16 == 0, name,
              " needs a 16-byte aligned table (the kernel loads int4)");
}

void check_thr(int64_t thr_bits) {
  TORCH_CHECK(thr_bits >= 0 && thr_bits < kNoValidBits,
              "thr_bits must be the bits of a threshold in [0, 2), got ", thr_bits);
}

std::tuple<at::Tensor, at::Tensor, at::Tensor> fused_cells_stage1(at::TensorList levels,
                                                                  int64_t num_anchors,
                                                                  int64_t kw) {
  const int n = static_cast<int>(levels.size());
  TORCH_CHECK(n >= 1 && n <= kMaxLevels, "fused_cells_stage1 takes 1-4 levels, got ", n);
  TORCH_CHECK(num_anchors >= 1 && kw >= 6, "need num_anchors >= 1 and kw >= 6");
  const at::Tensor& first = levels[0];
  const int64_t C = num_anchors * kw;
  TORCH_CHECK(first.scalar_type() == at::kFloat || first.scalar_type() == at::kBFloat16,
              "levels must be float32 or bfloat16");
  const void* src[kMaxLevels] = {nullptr, nullptr, nullptr, nullptr};
  int rows[kMaxLevels] = {0, 0, 0, 0};
  int64_t n_cells = 0;
  for (int l = 0; l < n; ++l) {
    const at::Tensor& lv = levels[l];
    TORCH_CHECK(lv.is_cuda() && lv.dim() >= 3 && lv.size(0) == first.size(0) &&
                    lv.size(-1) == C && lv.scalar_type() == first.scalar_type() &&
                    lv.device() == first.device(),
                "levels must be (B, ..., ", C, ") CUDA tensors of one batch, dtype and device");
    TORCH_CHECK(lv.is_contiguous(),
                "fused_cells_stage1 needs contiguous levels (NHWC head outputs as views)");
    int64_t r = 1;
    for (int64_t d = 1; d < lv.dim() - 1; ++d) r *= lv.size(d);
    rows[l] = static_cast<int>(r);
    src[l] = lv.data_ptr();
    n_cells += r;
  }
  const c10::cuda::CUDAGuard guard(first.device());
  const int64_t bsz = first.size(0);
  auto cells = at::empty({bsz, n_cells, C}, first.options());
  auto obj = at::empty({bsz, n_cells, num_anchors}, first.options());
  auto cls = at::empty_like(obj);
  // the floor of the maxima in the levels' dtype: -9984.0 in bfloat16
  const float neg = first.scalar_type() == at::kBFloat16
                        ? static_cast<float>(c10::BFloat16(kNegLogit))
                        : kNegLogit;
  check_rc(yt_cells_stage1(src[0], src[1], src[2], src[3], rows[0], rows[1], rows[2], rows[3], n,
                           static_cast<int>(bsz), static_cast<int>(C),
                           static_cast<int>(num_anchors), static_cast<int>(kw), neg,
                           static_cast<int>(first.element_size()), cells.data_ptr(),
                           obj.data_ptr(), cls.data_ptr(), stream_of(first)),
           "fused_cells_stage1");
  ++g_launches[kStage1];
  return {cells, obj, cls};
}

std::tuple<at::Tensor, at::Tensor, at::Tensor> bisect_count(const at::Tensor& table, int64_t k,
                                                            int64_t thr_bits) {
  check_table(table, "bisect_count");
  TORCH_CHECK(k >= 1, "k must be >= 1, got ", k);
  check_thr(thr_bits);
  const int64_t bsz = table.size(0), m = table.size(1);
  int cluster = 0, resident = 0;
  bisect_plan(bsz, m, &cluster, &resident);
  const c10::cuda::CUDAGuard guard(table.device());
  const auto i32 = table.options().dtype(at::kInt);
  auto t = at::empty({bsz}, i32);
  auto cnt_gt = at::empty({bsz, m}, i32);
  auto cnt_eq = at::empty({bsz, m}, i32);
  check_rc(yt_bisect_count(table.data_ptr(), static_cast<int>(bsz), static_cast<int>(m),
                           static_cast<int>(k), static_cast<int>(thr_bits), t.data_ptr(),
                           cnt_gt.data_ptr(), cnt_eq.data_ptr(), cluster, resident,
                           stream_of(table)),
           "bisect_count");
  ++g_launches[kBisect];
  return {t, cnt_gt, cnt_eq};
}

at::Tensor row_fetch(const at::Tensor& table, const at::Tensor& idx) {
  TORCH_CHECK(table.is_cuda() && table.dim() == 3 &&
                  (table.scalar_type() == at::kFloat || table.scalar_type() == at::kBFloat16),
              "row_fetch: table must be a (B, m, w) float32 or bfloat16 CUDA tensor");
  TORCH_CHECK(idx.dim() == 2 && idx.size(0) == table.size(0) && idx.device() == table.device() &&
                  idx.scalar_type() == at::kInt,
              "row_fetch: idx must be (B, k) int32 on the table's device");
  TORCH_CHECK(table.size(1) >= 1, "row_fetch needs a table with at least one row");
  TORCH_CHECK(table.is_contiguous() && idx.is_contiguous(),
              "row_fetch needs contiguous table and idx");
  const int64_t bsz = table.size(0), m = table.size(1), w = table.size(2), k = idx.size(1);
  const int64_t row_bytes = w * table.element_size();
  int warps = 0, rows = 0;
  row_fetch_geometry(row_bytes, bsz, k, &warps, &rows);
  const c10::cuda::CUDAGuard guard(table.device());
  auto out = at::empty({bsz, k, w}, table.options());
  check_rc(yt_row_fetch_p(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                          static_cast<int>(bsz), static_cast<int>(m), static_cast<int>(k),
                          static_cast<int>(row_bytes), warps, rows, stream_of(table)),
           "row_fetch");
  ++g_launches[kRowFetch];
  return out;
}

std::tuple<at::Tensor, at::Tensor, at::Tensor, at::Tensor> lookup_fetch(const at::Tensor& table,
                                                                        const at::Tensor& off,
                                                                        int64_t k) {
  check_table(table, "lookup_fetch");
  const int64_t bsz = table.size(0), m = table.size(1);
  TORCH_CHECK(off.dim() == 2 && off.size(0) == bsz && off.size(1) == 2 * m &&
                  off.scalar_type() == at::kInt && off.device() == table.device() &&
                  off.is_contiguous(),
              "lookup_fetch: off must be (B, 2m) contiguous int32 on the table's device");
  TORCH_CHECK(k >= 1, "k must be >= 1, got ", k);
  const c10::cuda::CUDAGuard guard(table.device());
  const auto i32 = table.options().dtype(at::kInt);
  auto rows = at::empty({bsz, k, kChunk}, table.options());
  auto phys = at::empty({bsz, k}, i32);
  auto p = at::empty({bsz, k}, i32);
  auto is_eq = at::empty({bsz, k}, table.options().dtype(at::kBool));
  check_rc(yt_lookup_fetch_variant(table.data_ptr(), off.data_ptr(), static_cast<int>(bsz),
                                   static_cast<int>(m), static_cast<int>(k), rows.data_ptr(),
                                   phys.data_ptr(), p.data_ptr(), is_eq.data_ptr(), 0,
                                   stream_of(table)),
           "lookup_fetch");
  ++g_launches[kLookupFetch];
  return {rows, phys, p, is_eq};
}

std::tuple<at::Tensor, at::Tensor> select_extract(const at::Tensor& table, const at::Tensor& phys,
                                                  const at::Tensor& p, const at::Tensor& is_eq,
                                                  const at::Tensor& t, int64_t thr_bits) {
  check_table(table, "select_extract");
  const int64_t bsz = table.size(0), m = table.size(1);
  TORCH_CHECK(phys.dim() == 2 && phys.size(0) == bsz && p.sizes() == phys.sizes() &&
                  is_eq.sizes() == phys.sizes(),
              "select_extract: phys, p and is_eq must be (B, k)");
  TORCH_CHECK(t.dim() == 1 && t.size(0) == bsz, "select_extract: t must be (B,)");
  TORCH_CHECK(phys.scalar_type() == at::kInt && p.scalar_type() == at::kInt &&
                  is_eq.scalar_type() == at::kBool && t.scalar_type() == at::kInt,
              "select_extract: phys, p and t must be int32 and is_eq bool on cuda");
  for (const at::Tensor* x : {&phys, &p, &is_eq, &t}) {
    TORCH_CHECK(x->device() == table.device(),
                "select_extract: every input must be on the table's device");
    TORCH_CHECK(x->is_contiguous(), "select_extract needs contiguous inputs");
  }
  check_thr(thr_bits);
  const int64_t k = phys.size(1);
  const c10::cuda::CUDAGuard guard(table.device());
  auto vals = at::empty({bsz, k}, table.options());
  auto lane = at::empty({bsz, k}, table.options().dtype(at::kInt));
  check_rc(yt_select_extract(table.data_ptr(), phys.data_ptr(), p.data_ptr(), is_eq.data_ptr(),
                             t.data_ptr(), static_cast<int>(thr_bits), static_cast<int>(bsz),
                             static_cast<int>(m), static_cast<int>(k), vals.data_ptr(),
                             lane.data_ptr(), stream_of(table)),
           "select_extract");
  ++g_launches[kSelectExtract];
  return {vals, lane};
}

at::Tensor nms_mask(const at::Tensor& boxes, const at::Tensor& valid, double iou_thresh,
                    int64_t tile_size, int64_t stop_after) {
  TORCH_CHECK(boxes.is_cuda() && boxes.dim() == 3 && boxes.size(2) == 4 &&
                  boxes.scalar_type() == at::kFloat,
              "boxes must be a (B, K, 4) float32 CUDA tensor");
  TORCH_CHECK(valid.dim() == 2 && valid.size(0) == boxes.size(0) &&
                  valid.size(1) == boxes.size(1) && valid.scalar_type() == at::kBool &&
                  valid.device() == boxes.device(),
              "valid must be (B, K) bool on the boxes' device");
  TORCH_CHECK(tile_size > 0, "tile_size must be positive, got ", tile_size);
  TORCH_CHECK(boxes.is_contiguous() && valid.is_contiguous(),
              "nms_mask needs contiguous boxes and valid");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(boxes.data_ptr()) % 16 == 0,
              "nms_mask needs 16-byte aligned boxes (the kernel loads float4)");
  const int64_t bsz = boxes.size(0), k = boxes.size(1);
  const int tile = static_cast<int>(std::min(tile_size, k));
  // k + 1: no early exit
  const int stop = static_cast<int>(stop_after > 0 ? std::min(stop_after, k + 1) : k + 1);
  const c10::cuda::CUDAGuard guard(boxes.device());
  auto keep = at::empty_like(valid);
  // the kept-box list: as many rows an image as the kernel says it can keep
  const int rows = yt_nms_scratch_rows(static_cast<int>(k), tile, stop);
  auto scratch = at::empty({bsz, rows, 4}, boxes.options());
  check_rc(yt_nms_mask(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), scratch.data_ptr(),
                       static_cast<int>(bsz), static_cast<int>(k), static_cast<float>(iou_thresh),
                       tile, stop, stream_of(boxes)),
           "nms_mask");
  ++g_launches[kNms];
  return keep;
}

}  // namespace

TORCH_LIBRARY(yolort_tpu, m) {
  m.def("fused_cells_stage1(Tensor[] levels, int num_anchors, int kw) -> (Tensor, Tensor, Tensor)");
  m.def("bisect_count(Tensor table, int k, int thr_bits) -> (Tensor, Tensor, Tensor)");
  m.def("row_fetch(Tensor table, Tensor idx) -> Tensor");
  m.def("lookup_fetch(Tensor table, Tensor off, int k) -> (Tensor, Tensor, Tensor, Tensor)");
  m.def("select_extract(Tensor table, Tensor phys, Tensor p, Tensor is_eq, Tensor t, int thr_bits) -> (Tensor, Tensor)");
  m.def("nms_mask(Tensor boxes, Tensor valid, float iou_thresh, int tile_size, int stop_after) -> Tensor");
}

TORCH_LIBRARY_IMPL(yolort_tpu, CUDA, m) {
  m.impl("fused_cells_stage1", &fused_cells_stage1);
  m.impl("bisect_count", &bisect_count);
  m.impl("row_fetch", &row_fetch);
  m.impl("lookup_fetch", &lookup_fetch);
  m.impl("select_extract", &select_extract);
  m.impl("nms_mask", &nms_mask);
}

// The launches of kernel `name` in this process (-1 for an unknown name).
extern "C" long long yt_ops_launches(const char* name) {
  for (int i = 0; i < kKernels; ++i)
    if (std::strcmp(name, kKernelNames[i]) == 0) return g_launches[i].load();
  return -1;
}

// One JSON line of the C++ launch plans on the current device: bisect_plan
// of a (bsz, m, 128) table for each of the n_tables row counts,
// row_fetch_geometry of (row_bytes, bsz, k) for each of n_fetch triples,
// and the stage-1 plan of rows of C values in float32 and bfloat16.
// Returns 0, or the first error.
extern "C" int yt_ops_plans(int bsz, const int* tables, int n_tables, const int* fetch,
                            int n_fetch, int C) {
  std::printf("{\"bisect_plan\": [");
  for (int i = 0; i < n_tables; ++i) {
    int cluster = 0, resident = 0;
    bisect_plan(bsz, tables[i], &cluster, &resident);
    std::printf("%s[%d, %d, %d, %s]", i ? ", " : "", bsz, tables[i], cluster,
                resident ? "true" : "false");
  }
  std::printf("], \"row_fetch_geometry\": [");
  for (int i = 0; i < n_fetch; ++i) {
    int warps = 0, rows = 0;
    row_fetch_geometry(fetch[3 * i], fetch[3 * i + 1], fetch[3 * i + 2], &warps, &rows);
    std::printf("%s[%d, %d, %d, %d, %d]", i ? ", " : "", fetch[3 * i], fetch[3 * i + 1],
                fetch[3 * i + 2], warps, rows);
  }
  std::printf("], \"stage1_plan\": {");
  const int sizes[2] = {4, 2};
  const char* names[2] = {"float32", "bfloat16"};
  for (int d = 0; d < 2; ++d) {
    int out[5] = {0, 0, 0, 0, 0};
    const int rc = yt_cells_stage1_plan(C, sizes[d], out);
    if (rc != 0) return rc;
    std::printf("%s\"%s\": [%d, %d, %d, %d, %d]", d ? ", " : "", names[d], out[0], out[1],
                out[2], out[3], out[4]);
  }
  std::printf("}}\n");
  std::fflush(stdout);
  return 0;
}
