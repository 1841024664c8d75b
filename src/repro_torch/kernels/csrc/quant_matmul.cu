// K5, weight-only quantized matmul: y[M, N] = x[M, K] @ (w_q * scale), f32
// out. x is f32 or bf16 (widened with __bfloat162float); w_q is int8
// [K, N] (8 bits) or uint8 [K, N/2] holding two signed nibbles a byte, the
// low one column 2j and the high one column 2j+1 (4 bits); scale is f32 or
// bf16 [K / group, N], one row per group of `group` consecutive k.
//
// Replaces src/repro/kernels/quant_matmul.py::quant_matmul (_qmm_kernel).
//
// What bounds it on the H100: at decode (M = 8) the weight bytes, which
// this kernel reads once per output tile; at M = 512 the operations, done
// here on the CUDA cores in f32, not on the tensor cores. The design is a
// plain tiled GEMM: one block owns a BM x 64 output tile, each of its 256
// threads a TM x 4 micro-tile of f32 accumulators in registers, and K
// streams through shared memory 32 rows at a time. Each weight is
// dequantized once, as it is stored to shared memory: sign-extended, then
// multiplied by the scale of its (k / group, n) in one f32 rounding, before
// the dot, as the TPU kernel does. Ragged M, N and K are masked (zeros), so
// any shape and any group size that divides K work. A GEMV split along K
// for decode, mma.sync/wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64, BK = 32, NT = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int nibble(int b) {  // sign-extend 4 bits
  return b >= 8 ? b - 16 : b;
}

// Thread (tm, tn) of the 16 x 16 grid holds rows tm + 16 i and columns
// tn + 16 j of the tile: neighbouring threads read neighbouring shared
// memory words and write neighbouring outputs.
template <int BM, int BITS, typename XT, typename ST>
__global__ void __launch_bounds__(NT)
qmm_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ w,
           const ST* __restrict__ scale, float* __restrict__ out, int M,
           int K, int N, int group) {
  constexpr int TM = BM / 16, TN = BN / 16;
  __shared__ float xs[BK][BM + 1];  // x tile, transposed: xs[k][m]
  __shared__ float ws[BK][BN];      // dequantized weight tile
  const int tid = threadIdx.x, tn = tid % 16, tm = tid / 16;
  const long m0 = (long)blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int mm = i / BK, kk = i % BK;  // k fastest: coalesced reads
      const long gm = m0 + mm;
      const int gk = k0 + kk;
      xs[kk][mm] = (gm < M && gk < K) ? widen(x[gm * K + gk]) : 0.f;
    }
    if (BITS == 8) {
      for (int i = tid; i < BK * BN; i += NT) {
        const int kk = i / BN, nn = i % BN;
        const int gk = k0 + kk, gn = n0 + nn;
        float v = 0.f;
        if (gk < K && gn < N) {
          const int q = (int)(int8_t)w[(long)gk * N + gn];
          v = __fmul_rn((float)q, widen(scale[(long)(gk / group) * N + gn]));
        }
        ws[kk][nn] = v;
      }
    } else {
      const int nb = N / 2;  // bytes a row
      for (int i = tid; i < BK * BN / 2; i += NT) {
        const int kk = i / (BN / 2), jj = i % (BN / 2);
        const int gk = k0 + kk, gj = n0 / 2 + jj;
        float lo = 0.f, hi = 0.f;
        if (gk < K && gj < nb) {
          const int b = w[(long)gk * nb + gj];
          const ST* s = scale + (long)(gk / group) * N + 2 * gj;
          lo = __fmul_rn((float)nibble(b & 0xF), widen(s[0]));
          hi = __fmul_rn((float)nibble(b >> 4), widen(s[1]));
        }
        ws[kk][2 * jj] = lo;
        ws[kk][2 * jj + 1] = hi;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][tm + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tn + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long gm = m0 + tm + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tn + 16 * j;
      if (gn < N) out[gm * N + gn] = acc[i][j];
    }
  }
}

template <int BITS, typename XT, typename ST>
int launch(const void* x, const void* w, const void* scale, void* out, int M,
           int K, int N, int group, cudaStream_t stream) {
  const XT* xp = static_cast<const XT*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const ST* sp = static_cast<const ST*>(scale);
  float* op = static_cast<float*>(out);
  if (M <= 32) {  // decode: few rows, a short tile wastes less
    const dim3 grid((N + BN - 1) / BN, (M + 15) / 16);
    qmm_kernel<16, BITS, XT, ST><<<grid, NT, 0, stream>>>(xp, wp, sp, op, M,
                                                          K, N, group);
  } else {
    const dim3 grid((N + BN - 1) / BN, (M + 63) / 64);
    qmm_kernel<64, BITS, XT, ST><<<grid, NT, 0, stream>>>(xp, wp, sp, op, M,
                                                          K, N, group);
  }
  return (int)cudaGetLastError();
}

template <int BITS>
int launch_bits(const void* x, const void* w, const void* scale, void* out,
                int M, int K, int N, int group, int x_bf16, int s_bf16,
                cudaStream_t st) {
  if (x_bf16 && s_bf16)
    return launch<BITS, __nv_bfloat16, __nv_bfloat16>(x, w, scale, out, M, K,
                                                      N, group, st);
  if (x_bf16)
    return launch<BITS, __nv_bfloat16, float>(x, w, scale, out, M, K, N,
                                              group, st);
  if (s_bf16)
    return launch<BITS, float, __nv_bfloat16>(x, w, scale, out, M, K, N,
                                              group, st);
  return launch<BITS, float, float>(x, w, scale, out, M, K, N, group, st);
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). bits is 4 or 8;
// x_bf16 / s_bf16 say whether x / scale are bf16 (else f32); group >= 1
// divides K; N is even when bits is 4.
extern "C" int quant_matmul_launch(const void* x, const void* w,
                                   const void* scale, void* out, int M, int K,
                                   int N, int group, int bits, int x_bf16,
                                   int s_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group < 1 || K % group || M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (bits == 8)
    return launch_bits<8>(x, w, scale, out, M, K, N, group, x_bf16, s_bf16, st);
  if (bits == 4 && N % 2 == 0)
    return launch_bits<4>(x, w, scale, out, M, K, N, group, x_bf16, s_bf16, st);
  return (int)cudaErrorInvalidValue;
}
