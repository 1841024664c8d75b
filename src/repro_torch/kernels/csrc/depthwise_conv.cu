// Quantized K x K depthwise convolution, SAME padding, stride 1 or 2, with
// the requant epilogue  y = clip(round((acc + zpc) * mult) + bias, 0, qmax).
//
// Replaces src/repro/kernels/depthwise_conv.py::depthwise_conv_q (_dw_kernel).
//
// What bounds it on the H100: a depthwise conv has no channel reduction, K*K
// MACs per output and nothing for the tensor cores to do; it is bound by the
// bytes of its int32 input and output. The design gives each thread one
// output (b, y, x, c) with c fastest, so a warp reads 32 neighbouring
// channels of one pixel (one coalesced 128-byte line per tap), and the K*K
// taps of neighbouring outputs overlap in L1/L2 instead of being staged by
// hand. SAME padding happens in the kernel: taps outside the image are
// skipped, which equals zero padding; no padded copy is made in memory.
#include "common.cuh"

namespace {

template <int KS, int S>
__global__ void __launch_bounds__(256)
dw_kernel(const int* __restrict__ x, const int8_t* __restrict__ w,
          const float* __restrict__ mult, const int* __restrict__ zpc,
          const int* __restrict__ bias, int* __restrict__ out, int B, int H,
          int W, int C, int Ho, int Wo, int pad_t, int pad_l, int qmax) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long total = (long)B * Ho * Wo * C;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  long r = idx / C;
  const int ox = (int)(r % Wo);
  r /= Wo;
  const int oy = (int)(r % Ho);
  const int b = (int)(r / Ho);
  int acc = zpc[c];
#pragma unroll
  for (int ki = 0; ki < KS; ++ki) {
    const int iy = oy * S - pad_t + ki;
    if (iy < 0 || iy >= H) continue;
#pragma unroll
    for (int kj = 0; kj < KS; ++kj) {
      const int ix = ox * S - pad_l + kj;
      if (ix < 0 || ix >= W) continue;
      acc += x[(((long)b * H + iy) * W + ix) * C + c] *
             (int)w[(ki * KS + kj) * C + c];
    }
  }
  out[idx] = reprotorch::requant_clip(acc, mult[c], bias[c], qmax);
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). kernel must be 3 or
// 5, stride 1 or 2.
extern "C" int depthwise_conv_q_launch(
    const void* x, const void* w, const void* mult, const void* zpc,
    const void* bias, void* out, int B, int H, int W, int C, int Ho, int Wo,
    int pad_t, int pad_l, int kernel, int stride, int qmax, void* stream) {
  const long total = (long)B * Ho * Wo * C;
  const dim3 grid((unsigned)((total + 255) / 256));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DW_CASE(KS_, S_)                                                     \
  if (kernel == KS_ && stride == S_) {                                       \
    dw_kernel<KS_, S_><<<grid, 256, 0, st>>>(                                \
        static_cast<const int*>(x), static_cast<const int8_t*>(w),           \
        static_cast<const float*>(mult), static_cast<const int*>(zpc),       \
        static_cast<const int*>(bias), static_cast<int*>(out), B, H, W, C,   \
        Ho, Wo, pad_t, pad_l, qmax);                                         \
    return (int)cudaGetLastError();                                          \
  }
  DW_CASE(3, 1) DW_CASE(3, 2) DW_CASE(5, 1) DW_CASE(5, 2)
#undef DW_CASE
  return (int)cudaErrorInvalidValue;
}
