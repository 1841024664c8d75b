// Quantized pointwise convolution / dense layer: the int GEMM
// [M = B*H*W, K = C_in] x [K, N = C_out] with int32 accumulation and the
// requant epilogue  y = clip(round((acc + zpc) * mult) + bias, 0, qmax).
//
// Replaces src/repro/kernels/pointwise_conv.py::pointwise_conv_q (_pw_kernel).
//
// What bounds it on the H100: on the main path K and N are small (16..1280),
// so the GEMM moves more bytes than it does operations per byte could hide:
// x is int32 (4 bytes a value) and the output int32, and the bound is the
// bytes. The design keeps one BM x BN output tile's accumulators in
// registers (a TM x TN micro-tile a thread) while K streams through shared
// memory in BK slices, so x and w are read from device memory once per
// tile and the epilogue runs on the last slice, in registers. Integer MACs
// on the CUDA cores; no tensor cores yet.
#include "common.cuh"

namespace {

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(256)
pw_kernel(const int* __restrict__ x, const int8_t* __restrict__ w,
          const float* __restrict__ mult, const int* __restrict__ zpc,
          const int* __restrict__ bias, int* __restrict__ out, int M, int K,
          int N, int qmax) {
  constexpr int NT = 256, TM = BM / 16, TN = BN / 16;
  __shared__ int xs[BK][BM + 1];  // transposed tile of x: xs[k][m]
  __shared__ int ws[BK][BN];
  const int tid = threadIdx.x;
  const int tn = tid % 16, tm = tid / 16;
  const long m0 = (long)blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int mm = i / BK, kk = i % BK;  // k fastest: coalesced reads
      const long gm = m0 + mm;
      const int gk = k0 + kk;
      xs[kk][mm] = (gm < M && gk < K) ? x[gm * K + gk] : 0;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = i / BN, nn = i % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      ws[kk][nn] = (gk < K && gn < N) ? (int)w[(long)gk * N + gn] : 0;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][tm * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tn * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long gm = m0 + tm * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tn * TN + j;
      if (gn >= N) continue;
      out[gm * N + gn] = reprotorch::requant_clip(acc[i][j] + zpc[gn],
                                                  mult[gn], bias[gn], qmax);
    }
  }
}

template <int BM, int BN, int BK>
void launch(const int* x, const int8_t* w, const float* mult, const int* zpc,
            const int* bias, int* out, int M, int K, int N, int qmax,
            cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  pw_kernel<BM, BN, BK><<<grid, 256, 0, stream>>>(x, w, mult, zpc, bias, out,
                                                  M, K, N, qmax);
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). block_m must be 16,
// 64 or 128, block_n 16 or 64, block_k 16 or 32.
extern "C" int pointwise_conv_q_launch(
    const void* x, const void* w, const void* mult, const void* zpc,
    const void* bias, void* out, int M, int K, int N, int qmax, int block_m,
    int block_n, int block_k, void* stream) {
  const int* xp = static_cast<const int*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* mp = static_cast<const float*>(mult);
  const int* zp = static_cast<const int*>(zpc);
  const int* bp = static_cast<const int*>(bias);
  int* op = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PW_CASE(BM_, BN_, BK_)                                              \
  if (block_m == BM_ && block_n == BN_ && block_k == BK_) {                 \
    launch<BM_, BN_, BK_>(xp, wp, mp, zp, bp, op, M, K, N, qmax, st);       \
    return (int)cudaGetLastError();                                         \
  }
  PW_CASE(16, 16, 16) PW_CASE(16, 16, 32) PW_CASE(16, 64, 16)
  PW_CASE(16, 64, 32) PW_CASE(64, 16, 16) PW_CASE(64, 16, 32)
  PW_CASE(64, 64, 16) PW_CASE(64, 64, 32) PW_CASE(128, 16, 16)
  PW_CASE(128, 16, 32) PW_CASE(128, 64, 16) PW_CASE(128, 64, 32)
#undef PW_CASE
  return (int)cudaErrorInvalidValue;
}
