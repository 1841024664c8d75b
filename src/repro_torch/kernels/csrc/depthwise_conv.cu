// Quantized K x K depthwise convolution, SAME padding, stride 1 or 2, with
// the requant epilogue  y = clip(round((acc + zpc) * mult) + bias, 0, qmax).
//
// Replaces src/repro/kernels/depthwise_conv.py::depthwise_conv_q (_dw_kernel).
//
// What bounds it on the H100: a depthwise conv has no channel reduction, K*K
// MACs per output and nothing for the tensor cores to do; it is bound by the
// bytes of its int32 input and output (the Head's 8 x 112 x 112 x 32 moves
// 25.7 MB: 7.7 us at 3.35 TB/s).
//
// Design, shaped for those bytes:
//   * a thread owns V = 4 neighbouring channels (16-byte loads and stores of
//     x and out) of an RY x RX patch of outputs; threads run channel group
//     fastest, so the threads of a pixel read its channels as whole lines;
//   * it walks the patch's input rows once: each row's window of
//     (RX - 1) * S + K pixels is loaded into registers and added, tap by
//     tap, into every output row of the patch it reaches, so an input is
//     loaded once a row window instead of once a tap;
//   * the K * K * 4 weights (one packed word a tap) and the channels'
//     zpc / mult / bias are loaded once a thread;
//   * 32-bit index math: a block row of threads per image (grid y = batch),
//     offsets within an image in int (the wrapper refuses 2^31 values);
//   * SAME padding inside the kernel: taps outside the image read zero;
//     outputs of a ragged patch past the edge are computed and not stored.
// Where C % 4 != 0 or a pointer is not 16-byte aligned, the same kernel runs
// with V = 1 (one channel a thread, scalar loads).
#include "common.cuh"

namespace {

constexpr int NT = 128;  // threads a block
constexpr int RX = 4;    // outputs a thread along x
constexpr int RY = 2;    // outputs a thread along y

__device__ __forceinline__ void load(const int* p, int (&v)[4]) {
  const int4 t = __ldg(reinterpret_cast<const int4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load(const int* p, int (&v)[1]) {
  v[0] = __ldg(p);
}
__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}
__device__ __forceinline__ void store(int* p, const int (&v)[4]) {
  *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store(int* p, const int (&v)[1]) {
  *p = v[0];
}
// one tap's weights for V channels, as bytes packed in a word
__device__ __forceinline__ unsigned load_w(const int8_t* p, int v) {
  return v == 4 ? __ldg(reinterpret_cast<const unsigned*>(p))
                : (unsigned)(uint8_t)__ldg(p);
}
// byte j of w, sign-extended
__device__ __forceinline__ int sbyte(unsigned w, int j) {
  return (int)(w << (24 - 8 * j)) >> 24;
}

template <int KS, int S, int V>
__global__ void __launch_bounds__(NT)
dw_kernel(const int* __restrict__ x, const int8_t* __restrict__ w,
          const float* __restrict__ mult, const int* __restrict__ zpc,
          const int* __restrict__ bias, int* __restrict__ out, int H, int W,
          int C, int Ho, int Wo, int pad_t, int pad_l, int qmax, int CG,
          int XR, int YR) {
  constexpr int WX = (RX - 1) * S + KS;  // input columns of a patch
  constexpr int WY = (RY - 1) * S + KS;  // input rows of a patch
  const int t = blockIdx.x * NT + threadIdx.x;
  if (t >= CG * XR * YR) return;
  const int cg = t % CG, r = t / CG;
  const int c = cg * V;
  const int ox0 = (r % XR) * RX, oy0 = (r / XR) * RY;
  const int iy0 = oy0 * S - pad_t, ix0 = ox0 * S - pad_l;
  const int* xb = x + (size_t)blockIdx.y * H * W * C;
  int* ob = out + (size_t)blockIdx.y * Ho * Wo * C;

  unsigned wt[KS * KS];
#pragma unroll
  for (int k = 0; k < KS * KS; ++k) wt[k] = load_w(w + k * C + c, V);
  int acc[RY][RX][V];
  {
    int z[V];
    load(zpc + c, z);
#pragma unroll
    for (int i = 0; i < RY; ++i)
#pragma unroll
      for (int j = 0; j < RX; ++j)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[i][j][v] = z[v];
  }

#pragma unroll
  for (int ry = 0; ry < WY; ++ry) {
    const int iy = iy0 + ry;
    if (iy < 0 || iy >= H) continue;  // a padding row adds nothing
    int win[WX][V];
#pragma unroll
    for (int j = 0; j < WX; ++j) {
      const int ix = ix0 + j;
      if (ix >= 0 && ix < W) {
        load(xb + (iy * W + ix) * C + c, win[j]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) win[j][v] = 0;
      }
    }
#pragma unroll
    for (int oy = 0; oy < RY; ++oy) {
      const int ki = ry - oy * S;  // known at compile time
      if (ki < 0 || ki >= KS) continue;
#pragma unroll
      for (int kj = 0; kj < KS; ++kj) {
        int wv[V];
#pragma unroll
        for (int v = 0; v < V; ++v) wv[v] = sbyte(wt[ki * KS + kj], v);
#pragma unroll
        for (int ox = 0; ox < RX; ++ox)
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[oy][ox][v] += win[ox * S + kj][v] * wv[v];
      }
    }
  }

  float m[V];
  int bi[V];
  load(mult + c, m);
  load(bias + c, bi);
#pragma unroll
  for (int oy = 0; oy < RY; ++oy) {
    if (oy0 + oy >= Ho) break;
#pragma unroll
    for (int ox = 0; ox < RX; ++ox) {
      if (ox0 + ox >= Wo) break;
      int y[V];
#pragma unroll
      for (int v = 0; v < V; ++v)
        y[v] = reprotorch::requant_clip(acc[oy][ox][v], m[v], bi[v], qmax);
      store(ob + ((oy0 + oy) * Wo + ox0 + ox) * C + c, y);
    }
  }
}

template <int KS, int S, int V>
int launch(const void* x, const void* w, const void* mult, const void* zpc,
           const void* bias, void* out, int B, int H, int W, int C, int Ho,
           int Wo, int pad_t, int pad_l, int qmax, cudaStream_t st) {
  const int CG = C / V, XR = (Wo + RX - 1) / RX, YR = (Ho + RY - 1) / RY;
  const dim3 grid((CG * XR * YR + NT - 1) / NT, B);
  dw_kernel<KS, S, V><<<grid, NT, 0, st>>>(
      static_cast<const int*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(mult), static_cast<const int*>(zpc),
      static_cast<const int*>(bias), static_cast<int*>(out), H, W, C, Ho, Wo,
      pad_t, pad_l, qmax, CG, XR, YR);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). kernel must be 3 or
// 5, stride 1 or 2; an image of x and of out must hold fewer than 2^31
// values.
extern "C" int depthwise_conv_q_launch(
    const void* x, const void* w, const void* mult, const void* zpc,
    const void* bias, void* out, int B, int H, int W, int C, int Ho, int Wo,
    int pad_t, int pad_l, int kernel, int stride, int qmax, void* stream) {
  if ((long)H * W * C >= (1L << 31) || (long)Ho * Wo * C >= (1L << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = C % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)out % 16 == 0 && (uintptr_t)mult % 16 == 0 &&
                   (uintptr_t)zpc % 16 == 0 && (uintptr_t)bias % 16 == 0 &&
                   (uintptr_t)w % 4 == 0;
#define DW_CASE(KS_, S_)                                                     \
  if (kernel == KS_ && stride == S_)                                         \
    return vec ? launch<KS_, S_, 4>(x, w, mult, zpc, bias, out, B, H, W, C,  \
                                    Ho, Wo, pad_t, pad_l, qmax, st)          \
               : launch<KS_, S_, 1>(x, w, mult, zpc, bias, out, B, H, W, C,  \
                                    Ho, Wo, pad_t, pad_l, qmax, st);
  DW_CASE(3, 1) DW_CASE(3, 2) DW_CASE(5, 1) DW_CASE(5, 2)
#undef DW_CASE
  return (int)cudaErrorInvalidValue;
}
