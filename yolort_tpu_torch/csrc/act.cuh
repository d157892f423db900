// The epilogue activations shared by the int8 convs' epilogue
// (csrc/qconv.cu) and the float convs' bias-and-activation pass
// (csrc/bias_act.cu), each rounded an operation at a time in float32 as the
// plain PyTorch version it must equal bit for bit computes it (the library
// is built with -fmad=false, so no multiply and add contract).
//
// SiLU has two forms because the two plain versions differ: the int8
// epilogue's is y * torch.sigmoid(y) (the JAX package's qconv epilogue), the
// float convs' F.silu, y / (1 + exp(-y)).  expf is the precise libdevice
// function that ATen's CUDA kernels call.

#pragma once

#include <cuda_runtime.h>

// the activation codes of qconv_kernel.ACTS
enum Act { kActNone = 0, kActSilu = 1, kActHardswish = 2, kActLeakyRelu = 3, kActRelu = 4 };

// y * (1 / (1 + exp(-y))): y * torch.sigmoid(y)
__device__ __forceinline__ float silu_rn(float y) {
  const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-y)));
  return __fmul_rn(y, sig);
}

// y / (1 + exp(-y)): F.silu, as ATen's CUDA kernel computes it
__device__ __forceinline__ float silu_div_rn(float y) {
  return __fdiv_rn(y, __fadd_rn(1.0f, expf(-y)));
}

// float32 values as they are: the rounding of a float32 plain version
struct Exact {
  __device__ __forceinline__ float operator()(float v) const { return v; }
};

// y * clip(y + 3, 0, 6) * (1/6), rounded an operation at a time in that
// order, with 1/6 the float32 constant (the JAX package's hardswish);
// narrow(v) gives v as the plain version's tensors hold it after each of
// its operations but the last
template <typename Narrow>
__device__ __forceinline__ float hardswish_rn(float y, Narrow narrow) {
  const float c = fminf(fmaxf(narrow(__fadd_rn(y, 3.0f)), 0.0f), 6.0f);
  return __fmul_rn(narrow(__fmul_rn(y, c)), 1.0f / 6.0f);
}

__device__ __forceinline__ float hardswish_rn(float y) { return hardswish_rn(y, Exact{}); }

// where(y >= 0, y, 0.1 * y), 0.1 the float32 constant
__device__ __forceinline__ float leaky_relu_rn(float y) {
  return y >= 0.0f ? y : __fmul_rn(0.1f, y);
}

// max(y, 0) with NaN passed through, as torch.clamp_min and F.relu
__device__ __forceinline__ float relu_rn(float y) {
  return isnan(y) ? y : fmaxf(y, 0.0f);
}
