// int8 convolution with a fused float epilogue: s8 x s8 -> s32, then
//   y = f32(acc) * scale[co] + bias[co];  y = act(y)  (none, SiLU, Hardswish,
//   LeakyReLU(0.1) or ReLU);
//   out = clip(round_half_even(y * inv_out_scale), -127, 127) as int8,
//   or y cast to the float out type when there is no out scale.
//
// Replaces yolort_tpu/ops/pallas/qconv.py: qconv1x1 (_kernel_1x1) and
// qconv3x3 (_kernel_3x3), with the shared _epilogue.  The TPU kernels shape
// the conv as MXU matmuls (a blocked GEMM for 1x1, nine shifted-window
// matmuls over a width-padded flattening for 3x3) and exist to keep the s32
// accumulator out of HBM.  Core PyTorch has no int8 CUDA convolution, so
// these are the int8 conv of the port, and one kernel serves both entry
// points as an implicit GEMM: A is (M = N*Ho*Wo pixels) x (K = k*k*C in
// (ky, kx, ci) order), gathered from the NHWC activations; B is the packed
// weight (Cout, Kpad).  Both are K-contiguous, which is what the tensor
// cores' "row.col" form wants, so nothing is transposed.  yt_qconv_kxk also
// runs the 3x3 stride-2 downsamples and the 6x6/s2/p2 stem, which the JAX
// package leaves to XLA's int8 conv.  The s32 accumulator stays in
// registers; it is exact in any order (|acc| <= K * 128^2 < 2^31, which the
// wrapper checks), so the kernel is bit-identical to the plain version.
//
// What bounds it on the H100, per yolov5s shape: by the card's rates the
// 1x1 convs and the large-image 3x3 convs are bound by bytes (activations
// in, int8 out at 3.35 TB/s), the 3x3 convs at 40x40 and 20x20 by a small
// margin by int8 operations (1,979 TOP/s).  Measured, every shape runs
// well above both (PERF.md section 6: chip_smoke.py per shape, and
// experiments/qconv_split.py, which times builds of this file with one
// part taken out).  The tensor-core products are the smallest part of a
// block's time.  The epilogue's arithmetic is the largest on the wide
// 1x1 convs: SiLU is expf and an IEEE division, some 30 instructions a
// value, for bits equal to torch.sigmoid's.  On the 3x3 convs the slab
// loads are the largest, on the stem its byte gather.  A block runs its
// loads, products and epilogue one after the other.  The design:
//   * the product runs on the int8 tensor cores, mma.sync m16n8k32
//     .s32.s8.s8.s32, fed by ldmatrix.x4 from an XOR-swizzled shared tile
//     (64-byte rows, 16-byte chunk c of row r stored at c ^ ((r >> 1) & 3):
//     the eight rows an ldmatrix phase reads fall in eight bank groups);
//   * global -> shared copies are cp.async.cg 16-byte copies in a 4-stage
//     ring of 64-byte K slabs, one __syncthreads per slab, so three slabs
//     are in flight while the tensor cores work on the fourth.  Where C %
//     16 == 0 (every yolov5s conv but the stem) a 16-byte chunk lies inside
//     one tap; each thread keeps its chunk's (ky, kx, ci) and advances it
//     by the slab instead of dividing per word, and taps outside the image
//     take the zero-fill form (src-size 0);
//   * the stem (C = 3, K = 108, weight rows not 16-byte aligned) and any
//     other C % 16 != 0 take a synchronous byte gather (predicated loads,
//     all in flight together) into the same shared tile, K tail
//     zero-filled, on the stem's 128x32 tile and the same tensor-core
//     mainloop;
//   * the tile (BM x BN, warps of 64x32 or 32x32) is chosen per conv
//     shape by qconv_kernel.qconv_plan in Python and passed in by index:
//     large tiles where M fills the 132 SMs, 64-row tiles where it does not
//     (the 20x20 layers);
//   * the epilogue runs on the accumulator fragments in registers, writes
//     the output tile to shared memory and copies it out in 16-byte runs
//     of NHWC rows (element stores only at a ragged Cout such as 255).
// Follow-up (ROADMAP): overlap a tile's epilogue with the next tile's
// loads, which warp specialisation with TMA (im2col tensor maps for the
// kxk A tile) and wgmma gives; a persistent grid of this same kernel and
// a higher register cap for more resident blocks measured no gain.
//
// Grouped convs (yt_qconv_grouped: the depth-wise 3x3 / 5x5 convs of
// MobileNetV3, DWConv, GhostConv's cheap half) replace no Pallas kernel:
// the JAX package runs them through XLA's int8 conv (ops/blocks.py
// _conv_int8).  Their reduction is short (k*k*C/G = 9 or 25 bytes for a
// depth-wise conv), so a 64-byte K slab of the tensor-core mainloop would
// be mostly zeros; they are bound by bytes, and run as a direct conv: a
// thread computes four consecutive output channels of one output pixel in
// s32 (one 4-byte load a tap for the four channels of a depth-wise conv,
// __dp4a where C/G % 4 == 0), then the same epilogue.  Neighbouring
// threads take neighbouring channels, so the NHWC loads and stores of a
// warp are contiguous.
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

constexpr int kBK = 64;             // K bytes per pipeline stage: two m16n8k32 steps
constexpr int kStages = 4;          // depth of the cp.async ring
constexpr int kChunks = kBK / 16;   // 16-byte chunks per stage row
constexpr int kOutPad = 16;         // bytes added to each staged output row

// the activation codes of qconv_kernel.ACTS
enum Act { kActNone = 0, kActSilu = 1, kActHardswish = 2, kActLeakyRelu = 3, kActRelu = 4 };
enum OutKind { kOutInt8 = 0, kOutF32 = 1, kOutBf16 = 2 };

struct Shape {
  int N, H, W, C;  // input, NHWC
  int Ho, Wo, Cout;
  int k, stride, pad;
  int K;     // k * k * C
  int Kpad;  // bytes per packed weight row
  int M;     // N * Ho * Wo
};

struct Epilogue {
  const float* scale;
  const float* bias;
  float inv_out_scale;
  int act;
  int out_kind;
};

// BM x BN output tile, WM x WN per warp.  The shared memory holds the ring
// of A and B slabs, then the staged output tile (f32 at the widest).
template <int BM, int BN, int WM, int WN>
struct Tile {
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kThreads = 32 * (BM / WM) * kWarpsN;
  static constexpr int kMinBlocks = 512 / kThreads;  // at most 128 registers a thread
  static constexpr int kMI = WM / 16;  // m16 fragments per warp
  static constexpr int kNI = WN / 8;   // n8 fragments per warp
  static constexpr int kRowStep = kThreads / kChunks;
  static constexpr int kRowsA = BM / kRowStep;  // A chunks per thread per slab
  static constexpr int kRowsB = BN / kRowStep;
  static constexpr int kStageBytes = (BM + BN) * kBK;
  static constexpr int kPipeBytes = kStages * kStageBytes;
  static constexpr int kOutBytes = BM * (BN * 4 + kOutPad);
  static constexpr int kSmem = kPipeBytes > kOutBytes ? kPipeBytes : kOutBytes;
  static_assert(BM % kRowStep == 0 && BN % kRowStep == 0, "loader rows");
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile");
};

__device__ __forceinline__ int swizzle(int row, int chunk) {
  return row * kBK + ((chunk ^ ((row >> 1) & 3)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float silu_rn(float y) {
  const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-y)));
  return __fmul_rn(y, sig);
}

// y * clip(y + 3, 0, 6) * (1/6), rounded an operation at a time in that
// order, with 1/6 the float32 constant (the JAX package's hardswish)
__device__ __forceinline__ float hardswish_rn(float y) {
  const float c = fminf(fmaxf(__fadd_rn(y, 3.0f), 0.0f), 6.0f);
  return __fmul_rn(__fmul_rn(y, c), 1.0f / 6.0f);
}

// where(y >= 0, y, 0.1 * y), 0.1 the float32 constant
__device__ __forceinline__ float leaky_relu_rn(float y) {
  return y >= 0.0f ? y : __fmul_rn(0.1f, y);
}

__device__ __forceinline__ float epilogue_value(int acc, float sc, float bi, int act) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), sc), bi);
  switch (act) {
    case kActSilu: return silu_rn(y);
    case kActHardswish: return hardswish_rn(y);
    case kActLeakyRelu: return leaky_relu_rn(y);
    case kActRelu: return fmaxf(y, 0.0f);  // max(y, 0) after the rounded multiply-add
    default: return y;
  }
}

__device__ __forceinline__ int8_t requantize(float y, float inv_out_scale) {
  const int q = __float2int_rn(__fmul_rn(y, inv_out_scale));
  return (int8_t)min(max(q, -127), 127);
}

// Where this thread's K chunk starts: byte kk of the A row, which is
// channel ci of tap (ky, kx).  Advanced by whole slabs, dividing only when
// a slab crosses into another tap.
struct KCursor {
  int kk, ci, kx, ky;
  __device__ __forceinline__ void start(int k0, const Shape& s) {
    kk = k0;
    const int tap = k0 / s.C;
    ci = k0 - tap * s.C;
    ky = tap / s.k;
    kx = tap - ky * s.k;
  }
  __device__ __forceinline__ void next_slab(const Shape& s) {
    kk += kBK;
    ci += kBK;
    if (ci >= s.C) {
      const int taps = ci / s.C;
      ci -= taps * s.C;
      kx += taps;
      ky += kx / s.k;
      kx %= s.k;
    }
  }
};

template <int BM, int BN, int WM, int WN, bool kGather>
__global__ void __launch_bounds__(Tile<BM, BN, WM, WN>::kThreads,
                                  Tile<BM, BN, WM, WN>::kMinBlocks)
    qconv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, Epilogue e,
                 void* __restrict__ out, Shape s) {
  using T = Tile<BM, BN, WM, WN>;
  extern __shared__ __align__(128) uint8_t smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm0 = (warp / T::kWarpsN) * WM;
  const int wn0 = (warp % T::kWarpsN) * WN;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nk = (s.K + kBK - 1) / kBK;

  // loader: this thread copies chunk column cc of rows r0 + j * kRowStep
  const int cc = tid % kChunks;
  const int r0 = tid / kChunks;
  const int8_t* a_img[T::kRowsA];
  int a_iy[T::kRowsA], a_ix[T::kRowsA];
  const int hw = s.Ho * s.Wo;
#pragma unroll
  for (int j = 0; j < T::kRowsA; ++j) {
    const int m = m0 + r0 + j * T::kRowStep;
    a_img[j] = x;
    a_iy[j] = -(1 << 30);  // a row past M reads nothing: every iy is < 0
    a_ix[j] = 0;
    if (m < s.M) {
      const int n = m / hw;
      const int r = m - n * hw;
      const int oy = r / s.Wo;
      a_img[j] = x + (size_t)n * s.H * s.W * s.C;
      a_iy[j] = oy * s.stride - s.pad;
      a_ix[j] = (r - oy * s.Wo) * s.stride - s.pad;
    }
  }
  const int8_t* b_row[T::kRowsB];
  bool b_ok[T::kRowsB];
#pragma unroll
  for (int j = 0; j < T::kRowsB; ++j) {
    const int co = n0 + r0 + j * T::kRowStep;
    b_ok[j] = co < s.Cout;
    b_row[j] = b_ok[j] ? w + (size_t)co * s.Kpad : w;
  }
  KCursor cur;
  cur.start(cc * 16, s);

  auto load_slab = [&](int stage) {
    uint8_t* As = smem + stage * T::kStageBytes;
    uint8_t* Bs = As + BM * kBK;
    if constexpr (!kGather) {
      const bool kin = cur.kk < s.K;
#pragma unroll
      for (int j = 0; j < T::kRowsA; ++j) {
        const int iy = a_iy[j] + cur.ky;
        const int ix = a_ix[j] + cur.kx;
        const bool ok = kin && (unsigned)iy < (unsigned)s.H && (unsigned)ix < (unsigned)s.W;
        const int8_t* src = ok ? a_img[j] + (iy * s.W + ix) * s.C + cur.ci : x;
        cp_async16(smem_addr(As + swizzle(r0 + j * T::kRowStep, cc)), src, ok);
      }
#pragma unroll
      for (int j = 0; j < T::kRowsB; ++j) {
        const bool ok = kin && b_ok[j];
        cp_async16(smem_addr(Bs + swizzle(r0 + j * T::kRowStep, cc)), ok ? b_row[j] + cur.kk : w,
                   ok);
      }
    } else {
      // one predicated byte load per K entry, with no branch between
      // them, so all of a thread's loads are in flight together
#pragma unroll
      for (int j = 0; j < T::kRowsA; ++j) {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        int ci = cur.ci, kx = cur.kx, ky = cur.ky;
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          const int iy = a_iy[j] + ky;
          const int ix = a_ix[j] + kx;
          const bool ok = (cur.kk + b < s.K) & ((unsigned)iy < (unsigned)s.H) &
                          ((unsigned)ix < (unsigned)s.W);
          const uint32_t byte = ok ? (uint8_t)a_img[j][(iy * s.W + ix) * s.C + ci] : 0u;
          v[b >> 2] |= byte << (8 * (b & 3));
          ++ci;  // the next K entry
          const bool wrap_c = ci == s.C;
          ci = wrap_c ? 0 : ci;
          kx += wrap_c;
          const bool wrap_x = kx == s.k;
          kx = wrap_x ? 0 : kx;
          ky += wrap_x;
        }
        *reinterpret_cast<uint4*>(As + swizzle(r0 + j * T::kRowStep, cc)) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
#pragma unroll
      for (int j = 0; j < T::kRowsB; ++j) {
        // packed rows are zero from K to Kpad (a multiple of 4)
        uint32_t v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kb = cur.kk + 4 * i;
          v[i] = (b_ok[j] && kb < s.Kpad) ? *reinterpret_cast<const uint32_t*>(b_row[j] + kb)
                                          : 0u;
        }
        *reinterpret_cast<uint4*>(Bs + swizzle(r0 + j * T::kRowStep, cc)) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    cur.next_slab(s);
  };

  int acc[T::kMI][T::kNI][4];
#pragma unroll
  for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::kNI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0;

  // prologue: slabs 0 .. kStages-2 in flight; one commit group per slab
  // (empty past the end) keeps wait_group's count right
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load_slab(st);
    cp_async_commit();
  }

  const uint32_t smem0 = smem_addr(smem);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // slab kt has landed (this thread's part)
    __syncthreads();               // ... everyone's; and slab kt-1's stage is free
    const int ahead = kt + kStages - 1;
    if (ahead < nk) load_slab(ahead % kStages);
    cp_async_commit();

    const uint32_t a_base = smem0 + (kt % kStages) * T::kStageBytes;
    const uint32_t b_base = a_base + BM * kBK;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t af[T::kMI][4];
      uint32_t bf[T::kNI][2];
#pragma unroll
      for (int mi = 0; mi < T::kMI; ++mi)
        ldmatrix_x4(af[mi], a_base + swizzle(wm0 + mi * 16 + (lane & 15), 2 * ks + (lane >> 4)));
#pragma unroll
      for (int nj = 0; nj < T::kNI / 2; ++nj) {
        uint32_t t[4];
        ldmatrix_x4(t, b_base + swizzle(wn0 + nj * 16 + (lane & 7) + ((lane >> 4) << 3),
                                        2 * ks + ((lane >> 3) & 1)));
        bf[2 * nj][0] = t[0];
        bf[2 * nj][1] = t[1];
        bf[2 * nj + 1][0] = t[2];
        bf[2 * nj + 1][1] = t[3];
      }
#pragma unroll
      for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < T::kNI; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the output tile

  // epilogue on the fragments: thread holds rows g, g+8 of each m16 block
  // and columns 2*tig, 2*tig+1 of each n8 block
  const int osz = e.out_kind == kOutInt8 ? 1 : (e.out_kind == kOutF32 ? 4 : 2);
  const int ostride = BN * osz + kOutPad;
  const int g = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int ni = 0; ni < T::kNI; ++ni) {
    const int col = wn0 + ni * 8 + 2 * tig;
    const int co = n0 + col;
    const float sc0 = co < s.Cout ? e.scale[co] : 0.0f;
    const float bi0 = co < s.Cout ? e.bias[co] : 0.0f;
    const float sc1 = co + 1 < s.Cout ? e.scale[co + 1] : 0.0f;
    const float bi1 = co + 1 < s.Cout ? e.bias[co + 1] : 0.0f;
#pragma unroll
    for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float y0 = epilogue_value(acc[mi][ni][2 * h], sc0, bi0, e.act);
        const float y1 = epilogue_value(acc[mi][ni][2 * h + 1], sc1, bi1, e.act);
        uint8_t* p = smem + (wm0 + mi * 16 + g + 8 * h) * ostride + col * osz;
        if (e.out_kind == kOutInt8) {
          const uint16_t lo = (uint8_t)requantize(y0, e.inv_out_scale);
          const uint16_t hi = (uint8_t)requantize(y1, e.inv_out_scale);
          *reinterpret_cast<uint16_t*>(p) = (uint16_t)(lo | (hi << 8));
        } else if (e.out_kind == kOutF32) {
          *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(p) =
              __halves2bfloat162(__float2bfloat16_rn(y0), __float2bfloat16_rn(y1));
        }
      }
  }
  __syncthreads();

  // copy out: 16-byte runs of each NHWC row where rows are whole 16-byte
  // runs (then no run crosses Cout); else one store per value, neighbouring
  // threads on neighbouring columns (the head's Cout = 255)
  uint8_t* const out8 = static_cast<uint8_t*>(out);
  if ((s.Cout * osz) % 16 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    const int chunks = BN * osz / 16;
    for (int i = tid; i < BM * chunks; i += T::kThreads) {
      const int row = i / chunks;
      const int c = i - row * chunks;
      const int m = m0 + row;
      const int col0 = n0 + c * 16 / osz;
      if (m >= s.M || col0 >= s.Cout) continue;
      *reinterpret_cast<uint4*>(out8 + ((size_t)m * s.Cout + col0) * osz) =
          *reinterpret_cast<const uint4*>(smem + row * ostride + c * 16);
    }
  } else {
    for (int i = tid; i < BM * BN; i += T::kThreads) {
      const int row = i / BN;
      const int col = i - row * BN;
      const int m = m0 + row;
      const int co = n0 + col;
      if (m >= s.M || co >= s.Cout) continue;
      const uint8_t* src = smem + row * ostride + col * osz;
      uint8_t* dst = out8 + ((size_t)m * s.Cout + co) * osz;
      if (osz == 4)
        *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
      else if (osz == 2)
        *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
      else
        *dst = *src;
    }
  }
}

template <int BM, int BN, int WM, int WN, bool kGather>
cudaError_t launch_tile(const int8_t* x, const int8_t* w, const Epilogue& e, void* out,
                        const Shape& s, int smem_bytes, cudaStream_t stream) {
  using T = Tile<BM, BN, WM, WN>;
  if (smem_bytes != T::kSmem) return cudaErrorInvalidValue;  // the Python plan disagrees
  auto kernel = qconv_kernel<BM, BN, WM, WN, kGather>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((s.M + BM - 1) / BM), (unsigned)((s.Cout + BN - 1) / BN));
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(x, w, e, out, s);
  return cudaGetLastError();
}

// tile index -> (BM, BN, WM, WN); qconv_kernel.TILES lists (BM, BN) in
// this order.  The gather loader runs on tile 2, the stem's
cudaError_t launch(int tile, bool gather, const int8_t* x, const int8_t* w, const Epilogue& e,
                   void* out, const Shape& s, int smem_bytes, cudaStream_t st) {
  if (gather)
    return tile == 2 ? launch_tile<128, 32, 32, 32, true>(x, w, e, out, s, smem_bytes, st)
                     : cudaErrorInvalidValue;
  switch (tile) {
    case 0: return launch_tile<128, 128, 64, 32, false>(x, w, e, out, s, smem_bytes, st);
    case 1: return launch_tile<128, 64, 32, 32, false>(x, w, e, out, s, smem_bytes, st);
    case 2: return launch_tile<128, 32, 32, 32, false>(x, w, e, out, s, smem_bytes, st);
    case 3: return launch_tile<64, 128, 32, 32, false>(x, w, e, out, s, smem_bytes, st);
    case 4: return launch_tile<64, 64, 32, 32, false>(x, w, e, out, s, smem_bytes, st);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned(const void* p, uintptr_t n) { return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0; }

bool valid_kinds(int act, int out_kind) {
  return act >= kActNone && act <= kActRelu &&
         (out_kind == kOutInt8 || out_kind == kOutF32 || out_kind == kOutBf16);
}

// --- grouped convs: a direct conv, four output channels a thread ---------

struct GroupShape {
  int N, H, W, C;  // input, NHWC
  int Ho, Wo, Cout;
  int k, stride, pad;
  int Cg, Coutg;  // channels of a group, in and out
  int Kpad;       // bytes per packed weight row: round_up(k * k * Cg, 4)
  int quads;      // ceil(Cout / 4): threads per output pixel
};

// how the s32 sums read their operands
enum GroupLoad { kBytes = 0, kDepthwiseWord = 1, kDp4a = 2 };

template <int kLoad>
__global__ void __launch_bounds__(256)
    qconv_grouped_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, Epilogue e,
                         void* __restrict__ out, GroupShape s, long long total) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long pix = i / s.quads;  // (n * Ho + oy) * Wo + ox
  const int co0 = (int)(i - pix * s.quads) * 4;
  const int ox = (int)(pix % s.Wo);
  const long long row = pix / s.Wo;
  const int oy = (int)(row % s.Ho);
  const int n = (int)(row / s.Ho);
  const int8_t* img = x + (size_t)n * s.H * s.W * s.C;
  const int iy0 = oy * s.stride - s.pad;
  const int ix0 = ox * s.stride - s.pad;
  const int nco = min(4, s.Cout - co0);

  int acc[4] = {0, 0, 0, 0};
  if constexpr (kLoad == kDepthwiseWord) {
    // C == Cout == G, C % 4 == 0: the four channels' inputs are one word
    for (int ky = 0; ky < s.k; ++ky) {
      const int iy = iy0 + ky;
      if ((unsigned)iy >= (unsigned)s.H) continue;
      for (int kx = 0; kx < s.k; ++kx) {
        const int ix = ix0 + kx;
        if ((unsigned)ix >= (unsigned)s.W) continue;
        const int v = *reinterpret_cast<const int*>(img + ((size_t)iy * s.W + ix) * s.C + co0);
        const int tap = ky * s.k + kx;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[j] += (int)(int8_t)(v >> (8 * j)) * (int)w[(size_t)(co0 + j) * s.Kpad + tap];
      }
    }
  } else {
    for (int j = 0; j < nco; ++j) {
      const int co = co0 + j;
      const int8_t* xg = img + (co / s.Coutg) * s.Cg;  // the channels of co's group
      const int8_t* wrow = w + (size_t)co * s.Kpad;
      int a = 0;
      for (int ky = 0; ky < s.k; ++ky) {
        const int iy = iy0 + ky;
        if ((unsigned)iy >= (unsigned)s.H) continue;
        for (int kx = 0; kx < s.k; ++kx) {
          const int ix = ix0 + kx;
          if ((unsigned)ix >= (unsigned)s.W) continue;
          const int8_t* xp = xg + ((size_t)iy * s.W + ix) * s.C;
          const int8_t* wp = wrow + (ky * s.k + kx) * s.Cg;
          if constexpr (kLoad == kDp4a) {
            for (int ci = 0; ci < s.Cg; ci += 4)
              a = __dp4a(*reinterpret_cast<const int*>(xp + ci),
                         *reinterpret_cast<const int*>(wp + ci), a);
          } else {
            for (int ci = 0; ci < s.Cg; ++ci) a += (int)xp[ci] * (int)wp[ci];
          }
        }
      }
      acc[j] = a;
    }
  }

  // epilogue and store: NHWC, the four channels together where whole
  const size_t o = (size_t)pix * s.Cout + co0;
  float y[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    y[j] = j < nco ? epilogue_value(acc[j], e.scale[co0 + j], e.bias[co0 + j], e.act) : 0.0f;
  const bool whole = nco == 4 && s.Cout % 4 == 0;
  if (e.out_kind == kOutInt8) {
    int8_t* dst = static_cast<int8_t*>(out) + o;
    if (whole) {
      uint32_t packed = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        packed |= (uint32_t)(uint8_t)requantize(y[j], e.inv_out_scale) << (8 * j);
      *reinterpret_cast<uint32_t*>(dst) = packed;
    } else {
      for (int j = 0; j < nco; ++j) dst[j] = requantize(y[j], e.inv_out_scale);
    }
  } else if (e.out_kind == kOutF32) {
    float* dst = static_cast<float*>(out) + o;
    if (whole)
      *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
    else
      for (int j = 0; j < nco; ++j) dst[j] = y[j];
  } else {
    __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out) + o;
    for (int j = 0; j < nco; ++j) dst[j] = __float2bfloat16_rn(y[j]);
  }
}

int run(const void* x, const void* w, const void* scale, const void* bias, float inv_out_scale,
        void* out, const Shape& s, int act, int out_kind, int tile, int gather, int smem_bytes,
        void* stream) {
  if (!valid_kinds(act, out_kind)) return (int)cudaErrorInvalidValue;
  // the gather loader reads weights as 4-byte words; the cp.async loader
  // needs whole 16-byte chunks inside one tap and 16-byte aligned rows
  if (s.Kpad % 4 || !aligned(w, 4)) return (int)cudaErrorInvalidValue;
  if ((long long)s.H * s.W * s.C >= (1LL << 31)) return (int)cudaErrorInvalidValue;  // int offsets
  if (!gather && (s.C % 16 || s.Kpad != s.K || !aligned(x, 16) || !aligned(w, 16)))
    return (int)cudaErrorInvalidValue;
  const Epilogue e{static_cast<const float*>(scale), static_cast<const float*>(bias),
                   inv_out_scale, act, out_kind};
  return (int)launch(tile, gather != 0, static_cast<const int8_t*>(x),
                     static_cast<const int8_t*>(w), e, out, s, smem_bytes,
                     static_cast<cudaStream_t>(stream));
}

}  // namespace

// x (N, H, W, C) int8 with C % 4 == 0; w (Cout, C) int8; scale, bias (Cout,)
// f32; out (N, H, W, Cout) int8 | f32 | bf16 (out_kind 0 | 1 | 2).  tile,
// gather and smem_bytes are the plan of qconv_kernel.qconv_plan.
extern "C" int yt_qconv1x1(const void* x, const void* w, const void* scale, const void* bias,
                           float inv_out_scale, void* out, int N, int H, int W, int C,
                           int Cout, int act, int out_kind, int tile, int gather,
                           int smem_bytes, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cout <= 0) return 0;
  if (C <= 0 || C % 4) return (int)cudaErrorInvalidValue;
  const Shape s{N, H, W, C, H, W, Cout, 1, 1, 0, C, C, N * H * W};
  return run(x, w, scale, bias, inv_out_scale, out, s, act, out_kind, tile, gather, smem_bytes,
             stream);
}

// x (N, H, W, C) int8 in G groups of C/G channels; w (Cout, Kpad) int8 with
// Kpad = round_up(k*k*C/G, 4), K in (ky, kx, ci-within-group) order; output
// channel co reads the channels of group co / (Cout/G).  out (N, Ho, Wo,
// Cout).  Needs x and w 4-byte aligned, out 16-byte aligned.
extern "C" int yt_qconv_grouped(const void* x, const void* w, const void* scale,
                                const void* bias, float inv_out_scale, void* out, int N, int H,
                                int W, int C, int Cout, int k, int stride, int pad, int Ho, int Wo,
                                int groups, int act, int out_kind, void* stream) {
  if (N <= 0 || Ho <= 0 || Wo <= 0 || Cout <= 0) return 0;
  if (C <= 0 || k <= 0 || stride <= 0 || pad < 0 || groups <= 0 || C % groups ||
      Cout % groups)
    return (int)cudaErrorInvalidValue;
  if (!valid_kinds(act, out_kind)) return (int)cudaErrorInvalidValue;
  if (!aligned(x, 4) || !aligned(w, 4) || !aligned(out, 16)) return (int)cudaErrorInvalidValue;
  if ((long long)H * W * C >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int Cg = C / groups;
  const GroupShape s{N, H, W, C, Ho, Wo, Cout, k, stride, pad, Cg, Cout / groups,
                     (k * k * Cg + 3) / 4 * 4, (Cout + 3) / 4};
  const Epilogue e{static_cast<const float*>(scale), static_cast<const float*>(bias),
                   inv_out_scale, act, out_kind};
  const long long total = (long long)N * Ho * Wo * s.quads;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  const auto xs = static_cast<const int8_t*>(x);
  const auto ws = static_cast<const int8_t*>(w);
  const auto st = static_cast<cudaStream_t>(stream);
  if (Cg == 1 && s.Coutg == 1 && C % 4 == 0)
    qconv_grouped_kernel<kDepthwiseWord><<<blocks, 256, 0, st>>>(xs, ws, e, out, s, total);
  else if (Cg % 4 == 0)
    qconv_grouped_kernel<kDp4a><<<blocks, 256, 0, st>>>(xs, ws, e, out, s, total);
  else
    qconv_grouped_kernel<kBytes><<<blocks, 256, 0, st>>>(xs, ws, e, out, s, total);
  return (int)cudaGetLastError();
}

// x (N, H, W, C) int8; w (Cout, Kpad) int8 with Kpad = round_up(k*k*C, 4),
// K in (ky, kx, ci) order; out (N, Ho, Wo, Cout).
extern "C" int yt_qconv_kxk(const void* x, const void* w, const void* scale, const void* bias,
                            float inv_out_scale, void* out, int N, int H, int W, int C,
                            int Cout, int k, int stride, int pad, int Ho, int Wo, int act,
                            int out_kind, int tile, int gather, int smem_bytes, void* stream) {
  if (N <= 0 || Ho <= 0 || Wo <= 0 || Cout <= 0) return 0;
  if (C <= 0 || k <= 0 || stride <= 0 || pad < 0) return (int)cudaErrorInvalidValue;
  const int K = k * k * C;
  const Shape s{N, H, W, C, Ho, Wo, Cout, k, stride, pad, K, (K + 3) / 4 * 4, N * Ho * Wo};
  return run(x, w, scale, bias, inv_out_scale, out, s, act, out_kind, tile, gather, smem_bytes,
             stream);
}
