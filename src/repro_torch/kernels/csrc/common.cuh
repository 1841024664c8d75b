// Shared device code of the quantized kernels: the Approximator & Clip
// epilogue (replaces src/repro/kernels/common.py::requant_clip) and a u8 x s8
// dot product of four bytes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace reprotorch {

// y = clip(round(acc * mult) + bias, 0, qmax), acc already holding the
// integer zero-point correction. The multiply is its own f32 rounding
// (__fmul_rn: nvcc may not contract it with anything), and __float2int_rn
// rounds half to even like jnp.round; roundf would round half away from
// zero.
__device__ __forceinline__ int requant_clip(int acc, float mult, int bias,
                                            int qmax) {
  const int r = __float2int_rn(__fmul_rn(__int2float_rn(acc), mult)) + bias;
  return min(max(r, 0), qmax);
}

// c + sum_k a.u8[k] * b.s8[k]: activations in [0, 255] do not fit int8, so
// the unsigned-by-signed form of dp4a.
__device__ __forceinline__ int dp4a_us(unsigned a, unsigned b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

}  // namespace reprotorch
