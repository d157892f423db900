// yolort_tpu_torch C++ serving driver: an AOTInductor package of the whole
// serving pipeline (uint8 frames -> letterbox -> network -> postprocess ->
// padded detections, the weights baked in), run on the card with no Python.
//
// The package calls the kernels as the dispatcher ops yolort_tpu::*; this
// driver dlopens their library (yolort_tpu_torch/csrc/torch_ops.cpp, built
// by yolort_tpu_torch/ops/cuda/_build_cpp.py) before it loads the package.
// The counterpart of deployment/pjrt/main.cpp, with the same readback dump.
//
// Build:  python deployment/libtorch/build.py   (g++ against the torch wheel)
// Usage:  yolort_libtorch_driver <ops_library.so> <package.pt2> <batch> <h> <w>
//             [iters=10] [input.bin] [dump_prefix]
//         yolort_libtorch_driver <ops_library.so> --plans <batch> <C> <m,m,...>
//             <row_bytes:batch:k,...>
// The first form reads raw uint8 (batch, h, w, 3) frames from input.bin (114
// everywhere without one), runs the package `iters` times with TF32 off
// (convolutions and matmuls in full float32, as the port's checks run), prints
// "detections per image: ...", the mean latency and each kernel's launches,
// and writes <dump_prefix>.boxes.f32, .scores.f32, .labels.i32, .num.i32.
// The second prints the op library's launch plans as one JSON line.

#include <dlfcn.h>

#include <ATen/Context.h>
#include <ATen/core/Tensor.h>
#include <ATen/ops/from_blob.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

namespace {

const char* const kKernels[] = {"fused_cells_stage1", "bisect_count", "row_fetch",
                                "lookup_fetch", "select_extract", "nms_mask"};

std::vector<int> parse_ints(const std::string& s, char sep) {
  std::vector<int> out;
  std::stringstream ss(s);
  std::string item;
  while (std::getline(ss, item, sep))
    if (!item.empty()) out.push_back(std::atoi(item.c_str()));
  return out;
}

int print_plans(void* ops, int argc, char** argv) {
  if (argc < 7) {
    std::fprintf(stderr, "usage: %s <ops.so> --plans <batch> <C> <m,...> <rb:b:k,...>\n",
                 argv[0]);
    return 2;
  }
  using PlansFn = int (*)(int, const int*, int, const int*, int, int);
  auto plans = reinterpret_cast<PlansFn>(dlsym(ops, "yt_ops_plans"));
  if (plans == nullptr) {
    std::fprintf(stderr, "the op library has no yt_ops_plans\n");
    return 1;
  }
  const std::vector<int> tables = parse_ints(argv[5], ',');
  std::vector<int> fetch;  // row_bytes, batch, k of each row_fetch launch
  std::stringstream ss(argv[6]);
  std::string triple;
  while (std::getline(ss, triple, ','))
    for (const int v : parse_ints(triple, ':')) fetch.push_back(v);
  if (fetch.size() % 3) {
    std::fprintf(stderr, "row_fetch shapes are row_bytes:batch:k triples\n");
    return 2;
  }
  const int rc = plans(std::atoi(argv[3]), tables.data(), static_cast<int>(tables.size()),
                       fetch.data(), static_cast<int>(fetch.size() / 3), std::atoi(argv[4]));
  if (rc != 0) std::fprintf(stderr, "yt_ops_plans: CUDA error %d\n", rc);
  return rc == 0 ? 0 : 1;
}

void dump(const std::string& path, const at::Tensor& t) {
  const at::Tensor host = t.contiguous().cpu();
  std::ofstream f(path, std::ios::binary);
  f.write(static_cast<const char*>(host.data_ptr()), host.nbytes());
  std::printf("dumped %s (%zu bytes)\n", path.c_str(), static_cast<size_t>(host.nbytes()));
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr,
                 "usage: %s <ops_library.so> <package.pt2> <batch> <h> <w> [iters=10] "
                 "[input.bin] [dump_prefix]\n       %s <ops_library.so> --plans <batch> <C> "
                 "<m,...> <row_bytes:batch:k,...>\n",
                 argv[0], argv[0]);
    return 2;
  }
  // the yolort_tpu ops register themselves as the library loads
  void* ops = dlopen(argv[1], RTLD_NOW | RTLD_GLOBAL);
  if (ops == nullptr) {
    std::fprintf(stderr, "dlopen(%s) failed: %s\n", argv[1], dlerror());
    return 1;
  }
  if (std::string(argv[2]) == "--plans") return print_plans(ops, argc, argv);
  if (argc < 6) {
    std::fprintf(stderr, "need <batch> <h> <w>\n");
    return 2;
  }
  const int64_t batch = std::atoll(argv[3]), height = std::atoll(argv[4]),
                width = std::atoll(argv[5]);
  const int iters = argc > 6 ? std::atoi(argv[6]) : 10;
  const char* input_path = argc > 7 ? argv[7] : nullptr;
  const char* dump_prefix = argc > 8 ? argv[8] : nullptr;
  try {
    at::globalContext().setAllowTF32CuDNN(false);
    at::globalContext().setAllowTF32CuBLAS(false);
    auto t0 = std::chrono::steady_clock::now();
    torch::inductor::AOTIModelPackageLoader loader(argv[2]);
    std::printf("package %s loaded in %.2f s\n", argv[2],
                std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count());

    std::vector<uint8_t> host(batch * height * width * 3, 114);
    if (input_path != nullptr) {
      std::ifstream f(input_path, std::ios::binary);
      const std::string raw((std::istreambuf_iterator<char>(f)), std::istreambuf_iterator<char>());
      if (raw.size() != host.size()) {
        std::fprintf(stderr, "input %s is %zu bytes, expected %zu\n", input_path, raw.size(),
                     host.size());
        return 1;
      }
      std::copy(raw.begin(), raw.end(), host.begin());
      std::printf("input: %s\n", input_path);
    }
    const at::Tensor input = at::from_blob(host.data(), {batch, height, width, 3}, at::kByte)
                                 .to(at::Device(at::kCUDA, 0));

    std::vector<at::Tensor> outs;
    double total = 0.0;
    for (int it = 0; it < iters; ++it) {
      t0 = std::chrono::steady_clock::now();
      outs = loader.run({input});
      const at::Tensor num = outs.at(3).cpu();  // waits for the stream
      const double dt =
          std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count();
      if (it > 0) total += dt;  // the first run warms up
    }
    if (iters > 1)
      std::printf("mean latency: %.3f ms, throughput: %.1f imgs/sec\n",
                  1e3 * total / (iters - 1), batch * (iters - 1) / total);
    if (outs.size() != 4) {
      std::fprintf(stderr, "the package returned %zu outputs, want 4\n", outs.size());
      return 1;
    }
    const at::Tensor num = outs[3].cpu();
    std::printf("detections per image:");
    for (int64_t i = 0; i < batch; ++i)
      std::printf(" %d", num.data_ptr<int32_t>()[i]);
    std::printf("\n");

    using LaunchesFn = long long (*)(const char*);
    auto launches = reinterpret_cast<LaunchesFn>(dlsym(ops, "yt_ops_launches"));
    if (launches != nullptr) {
      std::printf("launches over %d runs:", iters);
      for (const char* k : kKernels) std::printf(" %s %lld", k, launches(k));
      std::printf("\n");
    }
    if (dump_prefix != nullptr) {
      const std::string p(dump_prefix);
      dump(p + ".boxes.f32", outs[0]);
      dump(p + ".scores.f32", outs[1]);
      dump(p + ".labels.i32", outs[2]);
      dump(p + ".num.i32", outs[3]);
    }
  } catch (const std::exception& e) {
    std::fprintf(stderr, "error: %s\n", e.what());
    return 1;
  }
  std::printf("ok\n");
  return 0;
}
