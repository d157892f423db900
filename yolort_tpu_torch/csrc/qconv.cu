// int8 convolution with a fused float epilogue: s8 x s8 -> s32, then
//   y = f32(acc) * scale[co] + bias[co];  y = act(y);
//   out = clip(round_half_even(y * inv_out_scale), -127, 127) as int8,
//   or y cast to the float out type when there is no out scale.
//
// Replaces yolort_tpu/ops/pallas/qconv.py: qconv1x1 (_kernel_1x1) and
// qconv3x3 (_kernel_3x3), with the shared _epilogue.  The TPU kernels shape
// the conv as MXU matmuls (a blocked GEMM for 1x1, nine shifted-window
// matmuls over a width-padded flattening for 3x3) and exist to keep the s32
// accumulator out of HBM.  On the H100 there is no int8 convolution in core
// PyTorch at all, so these two kernels are the int8 conv of the port:
//   * yt_qconv1x1: a tiled GEMM (N*H*W, Cin) x (Cin, Cout);
//   * yt_qconv_kxk: the same tiling as an implicit GEMM over K = k*k*Cin in
//     (ky, kx, ci) order; the A-tile gather computes iy = oy*stride - pad + ky
//     (taps outside the image read 0).  It serves the 3x3 stride-1 convs of
//     the TPU kernel and also the 3x3 stride-2 downsamples and the 6x6/s2/p2
//     stem, which the JAX package leaves to XLA's int8 conv.
//
// Layout: activations are NHWC int8 (channels_last NCHW in PyTorch), so C
// is the contiguous reduction axis; weights are packed once at quantization
// to (Cout, Kpad) int8, Kpad = K rounded up to 4 with zeros.  Both tiles
// are staged through shared memory as 32-bit words of four int8 values and
// multiplied with __dp4a into s32 registers, 4x4 outputs per thread.
//
// What bounds it on the H100: instruction throughput.  __dp4a runs on the CUDA
// cores at a small fraction of the int8 tensor-core rate, and the kxk
// gather spends integer divisions per word; the simple design here trades
// speed for a kernel that is plainly right.  Tensor cores (mma.sync s8
// m16n8k32 or wgmma .s8), TMA and a cp.async pipeline are later work.
//
// Epilogue rounding follows the plain version operation by operation:
// __fmul_rn then __fadd_rn (no FMA: the library is built with -fmad=false,
// and the JAX package's eager int8 conv rounds the product too), SiLU as
// y * (1 / (1 + exp(-y))) as torch.sigmoid computes it, and __float2int_rn
// (round half to even) before the clamp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // output rows (pixels) per block
constexpr int kBN = 64;        // output channels per block
constexpr int kBKW = 8;        // K words (4 int8 each) per stage: 32 bytes
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

enum Act { kActNone = 0, kActSilu = 1 };
enum OutKind { kOutInt8 = 0, kOutF32 = 1, kOutBf16 = 2 };

struct Shape {
  int N, H, W, C;  // input, NHWC
  int Ho, Wo, Cout;
  int k, stride, pad;
  int K;   // k * k * C
  int Kw;  // Kpad / 4: words per weight row
};

__device__ __forceinline__ int8_t gather_byte(const int8_t* __restrict__ x, const Shape& s,
                                              int n, int oy, int ox, int kb) {
  if (kb >= s.K) return 0;
  const int tap = kb / s.C;
  const int ci = kb - tap * s.C;
  const int ky = tap / s.k;
  const int kx = tap - ky * s.k;
  const int iy = oy * s.stride - s.pad + ky;
  const int ix = ox * s.stride - s.pad + kx;
  if (iy < 0 || iy >= s.H || ix < 0 || ix >= s.W) return 0;
  return x[(((size_t)n * s.H + iy) * s.W + ix) * s.C + ci];
}

// One 32-bit word (four consecutive K entries) of the A row of pixel
// (n, oy, ox).  kOneByOne: the row is the pixel's C bytes; kVec (C % 4 == 0):
// the four entries share one tap and are one aligned load.
template <bool kOneByOne, bool kVec>
__device__ __forceinline__ int load_a(const int8_t* __restrict__ x, const Shape& s, int m,
                                      int n, int oy, int ox, int word) {
  if (kOneByOne) {
    if (word >= s.Kw) return 0;
    return reinterpret_cast<const int*>(x + (size_t)m * s.C)[word];
  }
  const int kb = word * 4;
  if (kVec) {
    if (kb >= s.K) return 0;
    const int tap = kb / s.C;
    const int ci = kb - tap * s.C;
    const int ky = tap / s.k;
    const int kx = tap - ky * s.k;
    const int iy = oy * s.stride - s.pad + ky;
    const int ix = ox * s.stride - s.pad + kx;
    if (iy < 0 || iy >= s.H || ix < 0 || ix >= s.W) return 0;
    return *reinterpret_cast<const int*>(x + (((size_t)n * s.H + iy) * s.W + ix) * s.C + ci);
  }
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    v |= (uint32_t)(uint8_t)gather_byte(x, s, n, oy, ox, kb + b) << (8 * b);
  return (int)v;
}

__device__ __forceinline__ float silu_rn(float y) {
  const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-y)));
  return __fmul_rn(y, sig);
}

template <bool kOneByOne, bool kVec, int kAct, int kOut>
__global__ void __launch_bounds__(kThreads)
    qconv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 float inv_out_scale, void* __restrict__ out, Shape s) {
  __shared__ int As[kBM][kBKW + 1];
  __shared__ int Bs[kBN][kBKW + 1];

  const int M = s.N * s.Ho * s.Wo;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  // each thread stages two words of one A row and of one B row per stage
  const int lr = tid >> 2;
  const int lw = (tid & 3) * 2;
  const int am = m0 + lr;
  const bool a_ok = am < M;
  int an = 0, aoy = 0, aox = 0;
  if (a_ok) {
    const int hw = s.Ho * s.Wo;
    an = am / hw;
    const int r = am - an * hw;
    aoy = r / s.Wo;
    aox = r - aoy * s.Wo;
  }
  const int bco = n0 + lr;
  const int* wrow = reinterpret_cast<const int*>(w) + (size_t)bco * s.Kw;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < s.Kw; k0 += kBKW) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int word = k0 + lw + t;
      As[lr][lw + t] = a_ok ? load_a<kOneByOne, kVec>(x, s, am, an, aoy, aox, word) : 0;
      Bs[lr][lw + t] = (bco < s.Cout && word < s.Kw) ? wrow[word] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBKW; ++kk) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty * 4 + i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[tx + 16 * j][kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tx + 16 * j;
      if (co >= s.Cout) continue;
      float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), scale[co]), bias[co]);
      if (kAct == kActSilu) y = silu_rn(y);
      const size_t o = (size_t)m * s.Cout + co;
      if (kOut == kOutInt8) {
        const int q = __float2int_rn(__fmul_rn(y, inv_out_scale));
        static_cast<int8_t*>(out)[o] = (int8_t)min(max(q, -127), 127);
      } else if (kOut == kOutF32) {
        static_cast<float*>(out)[o] = y;
      } else {
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
      }
    }
  }
}

template <bool kOneByOne, bool kVec, int kAct>
cudaError_t launch_out(const void* x, const void* w, const float* scale, const float* bias,
                       float inv_os, void* out, const Shape& s, int out_kind,
                       cudaStream_t stream) {
  const long long M = (long long)s.N * s.Ho * s.Wo;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((s.Cout + kBN - 1) / kBN));
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(w);
  switch (out_kind) {
    case kOutInt8:
      qconv_kernel<kOneByOne, kVec, kAct, kOutInt8>
          <<<grid, kThreads, 0, stream>>>(xi, wi, scale, bias, inv_os, out, s);
      break;
    case kOutF32:
      qconv_kernel<kOneByOne, kVec, kAct, kOutF32>
          <<<grid, kThreads, 0, stream>>>(xi, wi, scale, bias, inv_os, out, s);
      break;
    case kOutBf16:
      qconv_kernel<kOneByOne, kVec, kAct, kOutBf16>
          <<<grid, kThreads, 0, stream>>>(xi, wi, scale, bias, inv_os, out, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <bool kOneByOne, bool kVec>
cudaError_t launch(const void* x, const void* w, const void* scale, const void* bias,
                   float inv_os, void* out, const Shape& s, int act, int out_kind,
                   cudaStream_t stream) {
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  if (act == kActNone)
    return launch_out<kOneByOne, kVec, kActNone>(x, w, sc, b, inv_os, out, s, out_kind, stream);
  if (act == kActSilu)
    return launch_out<kOneByOne, kVec, kActSilu>(x, w, sc, b, inv_os, out, s, out_kind, stream);
  return cudaErrorInvalidValue;
}

bool aligned4(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 3) == 0; }

}  // namespace

// x (N, H, W, C) int8 with C % 4 == 0; w (Cout, C) int8; scale, bias (Cout,)
// f32; out (N, H, W, Cout) int8 | f32 | bf16 (out_kind 0 | 1 | 2).
extern "C" int yt_qconv1x1(const void* x, const void* w, const void* scale, const void* bias,
                           float inv_out_scale, void* out, int N, int H, int W, int C,
                           int Cout, int act, int out_kind, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cout <= 0) return 0;
  if (C <= 0 || C % 4 || !aligned4(x) || !aligned4(w)) return (int)cudaErrorInvalidValue;
  const Shape s{N, H, W, C, H, W, Cout, 1, 1, 0, C, C / 4};
  return (int)launch<true, true>(x, w, scale, bias, inv_out_scale, out, s, act, out_kind,
                                 static_cast<cudaStream_t>(stream));
}

// x (N, H, W, C) int8; w (Cout, Kpad) int8 with Kpad = round_up(k*k*C, 4),
// K in (ky, kx, ci) order; out (N, Ho, Wo, Cout).
extern "C" int yt_qconv_kxk(const void* x, const void* w, const void* scale, const void* bias,
                            float inv_out_scale, void* out, int N, int H, int W, int C,
                            int Cout, int k, int stride, int pad, int Ho, int Wo, int act,
                            int out_kind, void* stream) {
  if (N <= 0 || Ho <= 0 || Wo <= 0 || Cout <= 0) return 0;
  if (C <= 0 || k <= 0 || stride <= 0 || pad < 0 || !aligned4(w))
    return (int)cudaErrorInvalidValue;
  const int K = k * k * C;
  const Shape s{N, H, W, C, Ho, Wo, Cout, k, stride, pad, K, (K + 3) / 4};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % 4 == 0 && aligned4(x))
    return (int)launch<false, true>(x, w, scale, bias, inv_out_scale, out, s, act, out_kind, st);
  return (int)launch<false, false>(x, w, scale, bias, inv_out_scale, out, s, act, out_kind, st);
}
