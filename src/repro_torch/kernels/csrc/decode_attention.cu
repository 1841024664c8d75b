// K6, flash-decode attention over a grouped (GQA) KV cache. For batch b and
// kv head g, the rep query rows q[b, g, :, :] attend over cache positions
// [0, min(kv_len, S)) of k/v[b, :, g, :]; positions at or past kv_len score
// -1e30 (the TPU kernel's mask), and the softmax is taken online as
// (m, l, acc), one tile of positions at a time. An int8 cache is
// dequantized by its per-(position, kv head) scale; the output is
// acc / max(l, 1e-30) in q's type.
//
// Replaces src/repro/kernels/decode_attention.py::decode_attention (_kernel).
//
// What bounds it on the H100: the cache bytes (4 flops a cached value
// against 1 byte of int8), so the kernel reads each cache byte below kv_len
// once and keeps scores, probabilities and the accumulator on chip. The
// design is one block per (b, g), walking S in tiles of 64 positions: the K
// and V tile are dequantized to f32 as they are stored to shared memory,
// the rep x 64 scores come from the tile, one warp a query row takes the
// row's max and sum with shuffles, and each thread updates its (row, dim)
// slots of the accumulator. expf, not __expf: the tolerance is 1e-5. With
// B x KV blocks (64 for Llama-3.2-1B at batch 8) most of the 132 SMs idle;
// splitting S across blocks is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64, NT = 256, NWARP = NT / 32;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename QT, typename CT, typename ST, bool QUANT>
__global__ void __launch_bounds__(NT)
decode_kernel(const QT* __restrict__ q, const CT* __restrict__ kc,
              const CT* __restrict__ vc, const ST* __restrict__ ks,
              const ST* __restrict__ vs, const int* __restrict__ len_ptr,
              QT* __restrict__ out, int len_val, int KV, int rep, int dh,
              int S, float scale) {
  extern __shared__ float smem[];
  float* kt = smem;                     // [TILE][dh + 1]
  float* vt = kt + TILE * (dh + 1);     // [TILE][dh]
  float* qs = vt + TILE * dh;           // [rep][dh]
  float* acc = qs + rep * dh;           // [rep][dh]
  float* ps = acc + rep * dh;           // [rep][TILE] scores, then p
  float* ms = ps + rep * TILE;          // [rep] running max
  float* ls = ms + rep;                 // [rep] running sum
  float* cs = ls + rep;                 // [rep] this tile's correction
  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int kv_len = len_ptr ? *len_ptr : len_val;
  const long qoff = ((long)b * KV + g) * rep * dh;
  const long row = (long)KV * dh;  // stride of one position in the cache

  for (int i = tid; i < rep * dh; i += NT) {
    qs[i] = widen(q[qoff + i]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < rep; r += NT) {
    ms[r] = -INFINITY;
    ls[r] = 0.f;
  }

  // Past kv_len every score is -1e30: such a tile adds exp(-1e30 - m) = 0
  // to l and acc and leaves m as it is, so the walk stops there.
  const int end = min(S, kv_len);
  for (int t0 = 0; t0 < end; t0 += TILE) {
    const int n = min(TILE, S - t0);
    const long base = ((long)b * S + t0) * row + (long)g * dh;
    for (int i = tid; i < n * dh; i += NT) {
      const int s = i / dh, d = i % dh;
      float kv = widen(kc[base + s * row + d]);
      float vv = widen(vc[base + s * row + d]);
      if (QUANT) {
        const long si = ((long)b * S + t0 + s) * KV + g;
        kv = __fmul_rn(kv, widen(ks[si]));
        vv = __fmul_rn(vv, widen(vs[si]));
      }
      kt[s * (dh + 1) + d] = kv;
      vt[s * dh + d] = vv;
    }
    __syncthreads();
    for (int i = tid; i < rep * TILE; i += NT) {
      const int r = i / TILE, s = i % TILE;
      float sc = -INFINITY;  // past S: no position, weight 0
      if (s < n) {
        float dot = 0.f;
        for (int d = 0; d < dh; ++d)
          dot = fmaf(qs[r * dh + d], kt[s * (dh + 1) + d], dot);
        sc = t0 + s < kv_len ? __fmul_rn(dot, scale) : NEG;
      }
      ps[i] = sc;
    }
    __syncthreads();
    for (int r = warp; r < rep; r += NWARP) {
      float* p = ps + r * TILE;
      float mx = fmaxf(p[lane], p[lane + 32]);
      for (int o = 16; o > 0; o /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = ms[r], m_new = fmaxf(m_prev, mx);
      const float p0 = expf(p[lane] - m_new), p1 = expf(p[lane + 32] - m_new);
      p[lane] = p0;
      p[lane + 32] = p1;
      float sum = p0 + p1;
      for (int o = 16; o > 0; o /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        cs[r] = corr;
        ls[r] = ls[r] * corr + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < rep * dh; i += NT) {
      const int r = i / dh, d = i % dh;
      const float* p = ps + r * TILE;
      float pv = 0.f;
      for (int s = 0; s < n; ++s) pv = fmaf(p[s], vt[s * dh + d], pv);
      acc[i] = acc[i] * cs[r] + pv;
    }
    __syncthreads();
  }

  __syncthreads();  // an empty walk had no barrier
  for (int i = tid; i < rep * dh; i += NT)
    store(&out[qoff + i], acc[i] / fmaxf(ls[i / dh], 1e-30f));
}

template <typename QT, typename CT, typename ST, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const int* len_ptr, void* out, int len_val, int B,
           int KV, int rep, int dh, int S, float scale, cudaStream_t st) {
  auto kern = decode_kernel<QT, CT, ST, QUANT>;
  const size_t smem =
      sizeof(float) * (TILE * (2 * dh + 1) + 2 * rep * dh + rep * TILE + 3 * rep);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(KV, B), NT, smem, st>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(k),
      static_cast<const CT*>(v), static_cast<const ST*>(ks),
      static_cast<const ST*>(vs), len_ptr, static_cast<QT*>(out), len_val, KV,
      rep, dh, S, scale);
  return (int)cudaGetLastError();
}

template <typename QT>
int launch_q(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const int* len_ptr, void* out, int len_val,
             int B, int KV, int rep, int dh, int S, int cache, int sc_bf16,
             float scale, cudaStream_t st) {
  if (cache == 0 && sc_bf16)
    return launch<QT, int8_t, __nv_bfloat16, true>(
        q, k, v, ks, vs, len_ptr, out, len_val, B, KV, rep, dh, S, scale, st);
  if (cache == 0)
    return launch<QT, int8_t, float, true>(
        q, k, v, ks, vs, len_ptr, out, len_val, B, KV, rep, dh, S, scale, st);
  if (cache == 1)
    return launch<QT, __nv_bfloat16, float, false>(
        q, k, v, ks, vs, len_ptr, out, len_val, B, KV, rep, dh, S, scale, st);
  if (cache == 2)
    return launch<QT, float, float, false>(
        q, k, v, ks, vs, len_ptr, out, len_val, B, KV, rep, dh, S, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). q_bf16: q and out
// are bf16 (else f32); cache: 0 int8 (scales ks/vs, bf16 when sc_bf16,
// else f32), 1 bf16, 2 f32. kv_len is read from len_ptr on the device when
// it is not null, else it is len_val.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* ks,
                                       const void* vs, const void* len_ptr,
                                       void* out, int len_val, int B, int KV,
                                       int rep, int dh, int S, int q_bf16,
                                       int cache, int sc_bf16, float scale,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lp = static_cast<const int*>(len_ptr);
  if (B < 1 || KV < 1 || rep < 1 || dh < 1 || S < 0)
    return (int)cudaErrorInvalidValue;
  if (q_bf16)
    return launch_q<__nv_bfloat16>(q, k, v, ks, vs, lp, out, len_val, B, KV,
                                   rep, dh, S, cache, sc_bf16, scale, st);
  return launch_q<float>(q, k, v, ks, vs, lp, out, len_val, B, KV, rep, dh,
                         S, cache, sc_bf16, scale, st);
}
