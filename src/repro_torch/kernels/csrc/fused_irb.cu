// Fused inverted-residual block (the Body CU): PW expand -> requant ->
// K x K depthwise (SAME) -> requant -> PW project -> requant -> optional
// residual add, with the expanded tensor kept in shared memory.
//
// Replaces src/repro/kernels/fused_irb.py::fused_irb_q (_irb_kernel), with
// the epilogue forms of the reference interpreter src/repro/core/cu.py
// ::run_block, so that the result is bit-exact with it:
//   * every stage takes the INTEGER zero-point correction before the
//     multiply, y = round((acc + zpc) * mult) + bias (the JAX kernel's float
//     form round(acc * mult + zcorr) rounds differently, ROADMAP F4);
//   * the residual is round((x + a_z) * ra + (y + b_z) * rb) - ryz, clipped,
//     each product and sum its own f32 rounding.
//
// What bounds it on the H100: at the card's peaks, the bytes it must move,
// which are only the block input, output and weights because the t-times
// expanded tensor never reaches device memory; as written, the MACs on the
// CUDA cores (expand and project are C x E and E x C_out a pixel) take the
// time. The TPU kernel kept K full rows of the expanded tensor per grid
// step; at 112 x 112 x 96 that does not fit a CUDA block's shared memory,
// so this kernel tiles the OUTPUT spatially (TH x TW pixels a block, all
// output channels) with the depthwise halo recomputed at the tile edge, and
// walks E in chunks of 32: per chunk it expands the input patch into shared
// memory as uint8, runs the depthwise on it into a uint8 tile, and adds that
// chunk's share of the projection into per-thread int32 accumulators held in
// registers. Expand and project use dp4a (u8 x s8, four MACs an
// instruction).
#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads a block
constexpr int EC = 32;   // expanded channels a chunk

struct IrbArgs {
  const int* x;
  const int8_t* w1;
  const float* m1;
  const int* z1;
  const int* b1;
  const int8_t* w2;
  const float* m2;
  const int* z2;
  const int* b2;
  const int8_t* w3;
  const float* m3;
  const int* z3;
  const int* b3;
  int* out;
  int B, H, W, C, E, Co, Ho, Wo, pad_t, pad_l, TH, TW, qmax;
  int residual;
  float a_z, ra, b_z, rb;
  int ryz;
};

__host__ __device__ inline int xwords(int C) { return (C + 3) / 4; }
__host__ __device__ inline int w1_stride(int C) { return xwords(C) | 1; }
constexpr int W3S = EC / 4 + 1;  // odd word stride: no bank conflicts

inline size_t smem_bytes(const IrbArgs& a, int KS, int S) {
  const int PH = (a.TH - 1) * S + KS, PW = (a.TW - 1) * S + KS;
  const size_t P = (size_t)PH * PW, TO = (size_t)a.TH * a.TW;
  return 4 * (P * xwords(a.C) + (size_t)EC * w1_stride(a.C) +
              (size_t)KS * KS * EC + (size_t)a.Co * W3S + TO * (EC / 4)) +
         P * EC;
}

template <int KS, int S, int NACC>
__global__ void __launch_bounds__(NT) irb_kernel(IrbArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int tiles_w = (a.Wo + a.TW - 1) / a.TW;
  const int ty0 = (blockIdx.x / tiles_w) * a.TH;
  const int tx0 = (blockIdx.x % tiles_w) * a.TW;
  const int b = blockIdx.y;
  const int PW = (a.TW - 1) * S + KS;
  const int P = ((a.TH - 1) * S + KS) * PW;
  const int TO = a.TH * a.TW;
  const int iy0 = ty0 * S - a.pad_t, ix0 = tx0 * S - a.pad_l;
  const int XW = xwords(a.C), W1S = w1_stride(a.C);

  unsigned* xs = reinterpret_cast<unsigned*>(smem);  // [P][XW] u8 x4
  unsigned* w1s = xs + P * XW;                        // [EC][W1S] s8 x4
  int* w2s = reinterpret_cast<int*>(w1s + EC * W1S);  // [KS*KS][EC]
  unsigned* w3s = reinterpret_cast<unsigned*>(w2s + KS * KS * EC);  // [Co][W3S]
  unsigned* ds = w3s + a.Co * W3S;                   // [TO][EC/4] u8 x4
  unsigned char* es = reinterpret_cast<unsigned char*>(ds + TO * (EC / 4));
  unsigned char* ds8 = reinterpret_cast<unsigned char*>(ds);

  // 1. the input patch (tile + depthwise halo) as packed uint8
  for (int i = tid; i < P * XW; i += NT) {
    const int p = i / XW, c4 = i % XW;
    const int gy = iy0 + p / PW, gx = ix0 + p % PW;
    unsigned v = 0;
    if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W) {
      const int* src = a.x + (((long)b * a.H + gy) * a.W + gx) * a.C;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = c4 * 4 + k;
        if (c < a.C) v |= ((unsigned)src[c] & 0xFFu) << (8 * k);
      }
    }
    xs[i] = v;
  }

  int acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0;

  for (int e0 = 0; e0 < a.E; e0 += EC) {
    const int ec = min(EC, a.E - e0);
    __syncthreads();  // xs written; the previous chunk's readers are done
    // this chunk's weights: w1 [C][E] -> w1s[e][c], w3 [E][Co] -> w3s[co][e]
    for (int i = tid; i < EC * XW; i += NT) {
      const int e = i / XW, c4 = i % XW;
      unsigned v = 0;
      if (e < ec) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = c4 * 4 + k;
          if (c < a.C)
            v |= (unsigned)(unsigned char)a.w1[(long)c * a.E + e0 + e]
                 << (8 * k);
        }
      }
      w1s[e * W1S + c4] = v;
    }
    for (int i = tid; i < KS * KS * EC; i += NT) {
      const int kk = i / EC, e = i % EC;
      w2s[i] = e < ec ? (int)a.w2[kk * a.E + e0 + e] : 0;
    }
    for (int i = tid; i < a.Co * (EC / 4); i += NT) {
      const int co = i / (EC / 4), e4 = i % (EC / 4);
      unsigned v = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = e4 * 4 + k;
        if (e < ec)
          v |= (unsigned)(unsigned char)a.w3[(long)(e0 + e) * a.Co + co]
               << (8 * k);
      }
      w3s[co * W3S + e4] = v;
    }
    __syncthreads();

    // 2. expand + requant; positions outside the image are the depthwise's
    //    SAME zero padding
    for (int i = tid; i < P * EC; i += NT) {
      const int p = i / EC, e = i % EC;
      const int gy = iy0 + p / PW, gx = ix0 + p % PW;
      int v = 0;
      if (e < ec && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W) {
        int s = a.z1[e0 + e];
        const unsigned* xr = xs + p * XW;
        const unsigned* wr = w1s + e * W1S;
        for (int c4 = 0; c4 < XW; ++c4) s = reprotorch::dp4a_us(xr[c4], wr[c4], s);
        v = reprotorch::requant_clip(s, a.m1[e0 + e], a.b1[e0 + e], a.qmax);
      }
      es[i] = (unsigned char)v;
    }
    __syncthreads();

    // 3. depthwise + requant
    for (int i = tid; i < TO * EC; i += NT) {
      const int o = i / EC, e = i % EC;
      int v = 0;
      if (e < ec) {
        const int oy = o / a.TW, ox = o % a.TW;
        int s = a.z2[e0 + e];
#pragma unroll
        for (int ki = 0; ki < KS; ++ki)
#pragma unroll
          for (int kj = 0; kj < KS; ++kj)
            s += (int)es[((oy * S + ki) * PW + ox * S + kj) * EC + e] *
                 w2s[(ki * KS + kj) * EC + e];
        v = reprotorch::requant_clip(s, a.m2[e0 + e], a.b2[e0 + e], a.qmax);
      }
      ds8[i] = (unsigned char)v;
    }
    __syncthreads();

    // 4. this chunk's share of the projection
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      const int idx = tid + j * NT;
      if (idx < TO * a.Co) {
        const unsigned* dr = ds + (idx / a.Co) * (EC / 4);
        const unsigned* wr = w3s + (idx % a.Co) * W3S;
#pragma unroll
        for (int e4 = 0; e4 < EC / 4; ++e4)
          acc[j] = reprotorch::dp4a_us(dr[e4], wr[e4], acc[j]);
      }
    }
  }

  // 5. projection epilogue, residual, store
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    const int idx = tid + j * NT;
    if (idx >= TO * a.Co) continue;
    const int o = idx / a.Co, co = idx % a.Co;
    const int oy = ty0 + o / a.TW, ox = tx0 + o % a.TW;
    if (oy >= a.Ho || ox >= a.Wo) continue;
    int y = reprotorch::requant_clip(acc[j] + a.z3[co], a.m3[co], a.b3[co],
                                     a.qmax);
    if (a.residual) {
      const int xin = a.x[(((long)b * a.H + oy) * a.W + ox) * a.C + co];
      const float fa = __fmul_rn(__fadd_rn(__int2float_rn(xin), a.a_z), a.ra);
      const float fb = __fmul_rn(__fadd_rn(__int2float_rn(y), a.b_z), a.rb);
      const int r = __float2int_rn(__fadd_rn(fa, fb)) - a.ryz;
      y = min(max(r, 0), a.qmax);
    }
    a.out[(((long)b * a.Ho + oy) * a.Wo + ox) * a.Co + co] = y;
  }
}

template <int KS, int S, int NACC>
int launch(const IrbArgs& a, size_t smem, cudaStream_t stream) {
  auto kern = irb_kernel<KS, S, NACC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((a.Ho + a.TH - 1) / a.TH) * ((a.Wo + a.TW - 1) / a.TW);
  kern<<<dim3(tiles, a.B), NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int KS, int S>
int dispatch_nacc(const IrbArgs& a, int nacc, size_t smem, cudaStream_t st) {
  switch (nacc) {
    case 4: return launch<KS, S, 4>(a, smem, st);
    case 8: return launch<KS, S, 8>(a, smem, st);
    case 16: return launch<KS, S, 16>(a, smem, st);
    case 32: return launch<KS, S, 32>(a, smem, st);
    case 64: return launch<KS, S, 64>(a, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success), including a refusal of
// the tile's shared memory (above 227 KB). kernel 3 or 5, stride 1 or 2;
// nacc (4, 8, 16, 32 or 64) must cover tile_h * tile_w * Co / 256.
extern "C" int fused_irb_q_launch(
    const void* x, const void* w1, const void* m1, const void* z1,
    const void* b1, const void* w2, const void* m2, const void* z2,
    const void* b2, const void* w3, const void* m3, const void* z3,
    const void* b3, void* out, int B, int H, int W, int C, int E, int Co,
    int Ho, int Wo, int pad_t, int pad_l, int tile_h, int tile_w, int kernel,
    int stride, int qmax, int nacc, int residual, float a_z, float ra,
    float b_z, float rb, int ryz, void* stream) {
  IrbArgs a;
  a.x = static_cast<const int*>(x);
  a.w1 = static_cast<const int8_t*>(w1);
  a.m1 = static_cast<const float*>(m1);
  a.z1 = static_cast<const int*>(z1);
  a.b1 = static_cast<const int*>(b1);
  a.w2 = static_cast<const int8_t*>(w2);
  a.m2 = static_cast<const float*>(m2);
  a.z2 = static_cast<const int*>(z2);
  a.b2 = static_cast<const int*>(b2);
  a.w3 = static_cast<const int8_t*>(w3);
  a.m3 = static_cast<const float*>(m3);
  a.z3 = static_cast<const int*>(z3);
  a.b3 = static_cast<const int*>(b3);
  a.out = static_cast<int*>(out);
  a.B = B; a.H = H; a.W = W; a.C = C; a.E = E; a.Co = Co; a.Ho = Ho;
  a.Wo = Wo; a.pad_t = pad_t; a.pad_l = pad_l; a.TH = tile_h; a.TW = tile_w;
  a.qmax = qmax; a.residual = residual; a.a_z = a_z; a.ra = ra; a.b_z = b_z;
  a.rb = rb; a.ryz = ryz;
  if ((long)tile_h * tile_w * Co > (long)nacc * NT)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a, kernel, stride);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kernel == 3 && stride == 1) return dispatch_nacc<3, 1>(a, nacc, smem, st);
  if (kernel == 3 && stride == 2) return dispatch_nacc<3, 2>(a, nacc, smem, st);
  if (kernel == 5 && stride == 1) return dispatch_nacc<5, 1>(a, nacc, smem, st);
  if (kernel == 5 && stride == 2) return dispatch_nacc<5, 2>(a, nacc, smem, st);
  return (int)cudaErrorInvalidValue;
}
