// Shared device code of the quantized kernels: the Approximator & Clip
// epilogue (replaces src/repro/kernels/common.py::requant_clip), a u8 x s8
// dot product of four bytes, and the byte permutes that pack int32
// activations and int8 weight blocks into 32-bit words.
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

// the low bytes of four int32 -> one word, first value in the low byte
__device__ __forceinline__ unsigned narrow4(int4 v) {
  return __byte_perm(__byte_perm(v.x, v.y, 0x0040),
                     __byte_perm(v.z, v.w, 0x0040), 0x5410);
}

// a 4 x 4 byte block: rows r[e] (4 columns each) -> columns c[j] (4 rows
// each, first row in the low byte)
__device__ __forceinline__ void transpose4x4(const unsigned (&r)[4],
                                             unsigned (&c)[4]) {
  const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);  // col 0, 1 of r0 r1
  const unsigned t1 = __byte_perm(r[2], r[3], 0x5140);
  const unsigned t2 = __byte_perm(r[0], r[1], 0x7362);  // col 2, 3 of r0 r1
  const unsigned t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

}  // namespace reprotorch
