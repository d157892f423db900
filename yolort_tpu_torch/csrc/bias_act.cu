// The float convs' epilogue, in place on the conv's output:
//   y[i] = act(y[i] + bias[i % C]),
// y NHWC-contiguous (a channels_last NCHW tensor), float32, bfloat16 or
// float16, the bias of y's type; act none, SiLU (F.silu), Hardswish,
// LeakyReLU(0.1) or ReLU (csrc/act.cuh).  It rounds where ATen's eager ops
// round, so it is their result bit for bit in every type: the add computed
// in float32 and rounded to y's type, then the activation computed in
// float32 from that (Hardswish's multiply-add chain rounded to y's type
// after each of its operations, as its ATen ops are), rounded to y's type.
//
// Replaces no TPU kernel: XLA fuses a conv's bias and activation into the
// conv.  Under cuDNN, ATen runs a float conv without its bias and adds the
// bias in a second pass (output.add_(bias)), which on a channels_last
// output cannot coalesce the broadcast and takes its per-element kernel
// with an offset calculator; the activation is a third pass.  This kernel
// is both in one read and one write of the output.  (Rounding once, after
// the activation, is nearer float32 on most inputs, but it moves the
// bfloat16 networks' outputs off ATen's: on a network as sensitive as the
// C3TR's attention that changes which frames a bfloat16 run gets wrong.)
//
// What bounds it on the H100: bytes, the output read once and written once
// at 3.35 TB/s (2 bytes a value in bfloat16 against some 30 instructions
// for F.silu's expf and IEEE division).  The design:
//   * 16-byte vector loads and stores (4 float32 or 8 16-bit values), a
//     grid-stride loop over a grid that fills the card once (the occupancy
//     the compiler allowed, times the SMs), each thread with kUnroll vectors
//     in flight a step; outputs smaller than that take one vector a thread;
//   * the channel of a vector's first value is carried from step to step
//     and wrapped by one subtraction, no division per value;
//   * where C is a multiple of the vector width (every conv of the zoo but
//     the heads, C = A * (5 + nc)), a vector's channels are C-aligned and
//     its biases one 16-byte load; otherwise each value's bias is a scalar
//     load through L1, its channel stepped with wrap-around;
//   * values before the first 16-byte boundary and after the last whole
//     vector are done one by one by the grid's first threads.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // 16-byte vectors in flight a thread

enum Kind { kF32 = 0, kBf16 = 1, kF16 = 2 };  // epilogue_kernel.KINDS

// a storage type's values as float32 and back, from and to their bits in a
// 32-bit word (one float32, or two 16-bit values, low half first)
template <typename T>
struct Bits;

template <>
struct Bits<float> {
  using Raw = uint32_t;
  static constexpr int kPerWord = 1;
  static __device__ __forceinline__ float get(uint32_t w, int) { return __uint_as_float(w); }
  static __device__ __forceinline__ uint32_t put(uint32_t, int, float f) {
    return __float_as_uint(f);
  }
  static __device__ __forceinline__ float from_raw(Raw r) { return __uint_as_float(r); }
  static __device__ __forceinline__ Raw to_raw(float f) { return __float_as_uint(f); }
};

template <>
struct Bits<__nv_bfloat16> {
  using Raw = unsigned short;
  static constexpr int kPerWord = 2;
  static __device__ __forceinline__ float from_raw(Raw r) {
    return __uint_as_float(static_cast<uint32_t>(r) << 16);
  }
  static __device__ __forceinline__ Raw to_raw(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
  static __device__ __forceinline__ float get(uint32_t w, int h) {
    return from_raw(static_cast<Raw>(h ? w >> 16 : w & 0xffffu));
  }
  static __device__ __forceinline__ uint32_t put(uint32_t w, int h, float f) {
    const uint32_t r = to_raw(f);
    return h ? (w & 0xffffu) | (r << 16) : (w & 0xffff0000u) | r;
  }
};

template <>
struct Bits<__half> {
  using Raw = unsigned short;
  static constexpr int kPerWord = 2;
  static __device__ __forceinline__ float from_raw(Raw r) {
    return __half2float(__ushort_as_half(r));
  }
  static __device__ __forceinline__ Raw to_raw(float f) {
    return __half_as_ushort(__float2half_rn(f));
  }
  static __device__ __forceinline__ float get(uint32_t w, int h) {
    return from_raw(static_cast<Raw>(h ? w >> 16 : w & 0xffffu));
  }
  static __device__ __forceinline__ uint32_t put(uint32_t w, int h, float f) {
    const uint32_t r = to_raw(f);
    return h ? (w & 0xffffu) | (r << 16) : (w & 0xffff0000u) | r;
  }
};

// a float32 value as a tensor of T holds it
template <typename T>
struct RoundTo {
  __device__ __forceinline__ float operator()(float v) const {
    return Bits<T>::from_raw(Bits<T>::to_raw(v));
  }
};

// act(y + b) in float32, rounded to T where ATen's ops round but the last
// (which the store does)
template <typename T, int ACT>
__device__ __forceinline__ float epilogue(float y, float b) {
  const RoundTo<T> narrow{};
  const float t = narrow(__fadd_rn(y, b));
  switch (ACT) {
    case kActSilu: return silu_div_rn(t);
    case kActHardswish: return hardswish_rn(t, narrow);
    case kActLeakyRelu: return leaky_relu_rn(t);
    case kActRelu: return relu_rn(t);
    default: return t;
  }
}

// one 16-byte vector of y whose first value has channel c; BIAS_VEC: its
// kVec biases are one aligned vector at bias + c
template <typename T, int ACT, bool BIAS_VEC>
__device__ __forceinline__ uint4 apply(uint4 v, const typename Bits<T>::Raw* bias, int c, int C) {
  using B = Bits<T>;
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if (BIAS_VEC) {
    const uint4 bv = __ldg(reinterpret_cast<const uint4*>(bias + c));
    const uint32_t bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < B::kPerWord; ++h) {
        w[i] = B::put(w[i], h, epilogue<T, ACT>(B::get(w[i], h), B::get(bw[i], h)));
      }
    }
  } else {
    int cc = c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < B::kPerWord; ++h) {
        const float b = B::from_raw(__ldg(bias + cc));
        w[i] = B::put(w[i], h, epilogue<T, ACT>(B::get(w[i], h), b));
        if (++cc == C) cc = 0;
      }
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// one value, element i of y
template <typename T, int ACT>
__device__ __forceinline__ void apply_one(typename Bits<T>::Raw* y,
                                          const typename Bits<T>::Raw* bias, long long i, int C) {
  using B = Bits<T>;
  y[i] = B::to_raw(epilogue<T, ACT>(B::from_raw(y[i]), B::from_raw(__ldg(bias + i % C))));
}

// y: n values; the first `head` before a 16-byte boundary, then nv whole
// vectors, then `tail` values.  A step of the grid covers kUnroll slots of
// gridDim.x * kThreads vectors; cslot / cstep: the channel offset between
// two slots / two steps, mod C.
template <typename T, int ACT, bool BIAS_VEC>
__global__ void __launch_bounds__(kThreads) bias_act_kernel(
    typename Bits<T>::Raw* __restrict__ y, const typename Bits<T>::Raw* __restrict__ bias,
    int C, int head, long long nv, int tail, int cslot, int cstep) {
  constexpr int kVec = 16 / sizeof(T);
  const long long grid = static_cast<long long>(gridDim.x) * kThreads;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t < head) apply_one<T, ACT>(y, bias, t, C);
  if (t < tail) apply_one<T, ACT>(y, bias, head + nv * kVec + t, C);

  uint4* vy = reinterpret_cast<uint4*>(y + head);
  int c[kUnroll];
  c[0] = static_cast<int>((head + t * kVec) % C);
#pragma unroll
  for (int u = 1; u < kUnroll; ++u) {
    c[u] = c[u - 1] + cslot;
    if (c[u] >= C) c[u] -= C;
  }
  for (long long base = t; base < nv; base += grid * kUnroll) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = base + u * grid;
      if (v < nv) r[u] = vy[v];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = base + u * grid;
      if (v < nv) vy[v] = apply<T, ACT, BIAS_VEC>(r[u], bias, c[u], C);
      c[u] += cstep;
      if (c[u] >= C) c[u] -= C;
    }
  }
}

template <typename T, int ACT, bool BIAS_VEC>
int launch(void* y, const void* bias, long long n, int C, cudaStream_t stream) {
  using Raw = typename Bits<T>::Raw;
  constexpr int kVec = 16 / sizeof(T);
  auto kernel = bias_act_kernel<T, ACT, BIAS_VEC>;
  // blocks the card holds at once, read once a process (one kind of card)
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    resident = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  }
  const uintptr_t addr = reinterpret_cast<uintptr_t>(y);
  long long head = static_cast<long long>((16 - addr % 16) % 16 / sizeof(T));
  if (head > n) head = n;
  const long long nv = (n - head) / kVec;
  const int tail = static_cast<int>(n - head - nv * kVec);
  const long long want = (nv + kThreads - 1) / kThreads;
  const long long blocks = want < 1 ? 1 : want < resident ? want : resident;
  const long long grid_vecs = blocks * kThreads;
  const int cslot = static_cast<int>(grid_vecs * kVec % C);
  const int cstep = static_cast<int>(grid_vecs * kUnroll * kVec % C);
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<Raw*>(y), static_cast<const Raw*>(bias), C, static_cast<int>(head), nv, tail,
      cslot, cstep);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int ACT>
int launch_act(void* y, const void* bias, long long n, int C, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool bias_vec = C % kVec == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(bias) % 16 == 0;
  return bias_vec ? launch<T, ACT, true>(y, bias, n, C, stream)
                  : launch<T, ACT, false>(y, bias, n, C, stream);
}

template <typename T>
int launch_type(void* y, const void* bias, long long n, int C, int act, cudaStream_t stream) {
  switch (act) {
    case kActNone: return launch_act<T, kActNone>(y, bias, n, C, stream);
    case kActSilu: return launch_act<T, kActSilu>(y, bias, n, C, stream);
    case kActHardswish: return launch_act<T, kActHardswish>(y, bias, n, C, stream);
    case kActLeakyRelu: return launch_act<T, kActLeakyRelu>(y, bias, n, C, stream);
    case kActRelu: return launch_act<T, kActRelu>(y, bias, n, C, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// y: n values of an NHWC tensor of C channels, rewritten in place; bias: C
// values of y's type; act: an Act code; kind: a Kind code.
extern "C" int yt_bias_act(void* y, const void* bias, long long n, int C, int act, int kind,
                           cudaStream_t stream) {
  if (n <= 0) return 0;
  if (C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (kind) {
    case kF32: return launch_type<float>(y, bias, n, C, act, stream);
    case kBf16: return launch_type<__nv_bfloat16>(y, bias, n, C, act, stream);
    case kF16: return launch_type<__half>(y, bias, n, C, act, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
