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
// instruction). Each chunk's weights are staged with 4-byte loads, 4 x 4
// byte blocks transposed in registers (byte by byte only where E or C_out is
// not a multiple of 4), and the patch with 16-byte loads where C allows.
//
// E split across blocks. At 14 x 14 and 7 x 7 the tiles of a batch give 32
// and 8 blocks for 132 SMs, each walking all of E (up to 30 chunks). The
// grid is tiles x splits x B: block (tile, s, b) expands, depthwises and
// projects only E slice s (`eslice` channels, whole chunks; the host's
// `plan` chooses). With splits > 1 its int32 partial projections go to a
// workspace [splits][B][Ho][Wo][Co], and a second kernel adds the slices in
// split order and runs the projection epilogue and the residual once an
// output. A fixed-order pass over a workspace, not atomics: it needs no
// zeroed accumulator, and the second kernel is where the epilogue has to
// run anyway (after every slice). Integer sums are exact in any order, so
// every split gives the bits of one block walking all of E.
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
  int* part;  // splits > 1: the partial projections
  int B, H, W, C, E, Co, Ho, Wo, pad_t, pad_l, TH, TW, qmax, eslice;
  int residual;
  int vec_x, vec_e, vec_co;  // 16-byte x loads; 4-byte w1/w2 and w3 loads
  float a_z, ra, b_z, rb;
  int ryz;
};

__host__ __device__ inline int xwords(int C) { return (C + 3) / 4; }
__host__ __device__ inline int w1_stride(int C) { return xwords(C) | 1; }
constexpr int W3S = EC / 4 + 1;  // odd word stride: no bank conflicts

// kept equal to kernels/fused_irb.py::Plan.smem_bytes (the launch checks)
inline size_t smem_bytes(const IrbArgs& a, int KS, int S) {
  const int PH = (a.TH - 1) * S + KS, PW = (a.TW - 1) * S + KS;
  const size_t P = (size_t)PH * PW, TO = (size_t)a.TH * a.TW;
  return 4 * (P * xwords(a.C) + (size_t)EC * w1_stride(a.C) +
              (size_t)KS * KS * EC + (size_t)a.Co * W3S + TO * (EC / 4)) +
         P * EC;
}

// the projection's epilogue and the residual (x at the output's position)
__device__ __forceinline__ int finish(const IrbArgs& a, int acc, int co,
                                      const int* xp) {
  int y = reprotorch::requant_clip(acc + a.z3[co], a.m3[co], a.b3[co],
                                   a.qmax);
  if (a.residual) {
    const float fa = __fmul_rn(__fadd_rn(__int2float_rn(*xp), a.a_z), a.ra);
    const float fb = __fmul_rn(__fadd_rn(__int2float_rn(y), a.b_z), a.rb);
    const int r = __float2int_rn(__fadd_rn(fa, fb)) - a.ryz;
    y = min(max(r, 0), a.qmax);
  }
  return y;
}

// chunk [e0, e0 + ec) of w1 [C][E] -> w1s[e][c / 4], 4 c a word
__device__ __forceinline__ void stage_w1(const IrbArgs& a, unsigned* w1s,
                                         int e0, int ec) {
  const int XW = xwords(a.C), W1S = w1_stride(a.C);
  if (a.vec_e) {  // lanes along e: a thread reads 4 rows of 4 bytes
    for (int u = threadIdx.x; u < XW * (EC / 4); u += NT) {
      const int e4 = u % (EC / 4), c4 = u / (EC / 4);
      unsigned r[4], col[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = 4 * c4 + k;
        r[k] = c < a.C && 4 * e4 < ec
                   ? __ldg(reinterpret_cast<const unsigned*>(
                         a.w1 + (long)c * a.E + e0 + 4 * e4))
                   : 0u;
      }
      reprotorch::transpose4x4(r, col);
#pragma unroll
      for (int j = 0; j < 4; ++j) w1s[(4 * e4 + j) * W1S + c4] = col[j];
    }
    return;
  }
  for (int i = threadIdx.x; i < EC * XW; i += NT) {
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
}

// chunk of w2 [K*K][E] -> w2s[kk][e] as int
template <int KS>
__device__ __forceinline__ void stage_w2(const IrbArgs& a, int* w2s, int e0,
                                         int ec) {
  if (a.vec_e) {
    for (int u = threadIdx.x; u < KS * KS * (EC / 4); u += NT) {
      const int kk = u / (EC / 4), e4 = u % (EC / 4);
      const unsigned wd = 4 * e4 < ec
                              ? __ldg(reinterpret_cast<const unsigned*>(
                                    a.w2 + kk * a.E + e0 + 4 * e4))
                              : 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w2s[kk * EC + 4 * e4 + j] = (int)(wd << (24 - 8 * j)) >> 24;
    }
    return;
  }
  for (int i = threadIdx.x; i < KS * KS * EC; i += NT) {
    const int kk = i / EC, e = i % EC;
    w2s[i] = e < ec ? (int)a.w2[kk * a.E + e0 + e] : 0;
  }
}

// chunk of w3 [E][Co] -> w3s[co][e / 4], 4 e a word
__device__ __forceinline__ void stage_w3(const IrbArgs& a, unsigned* w3s,
                                         int e0, int ec) {
  if (a.vec_co) {  // lanes along co: a thread reads 4 rows of 4 bytes
    const int CQ = a.Co / 4;
    for (int u = threadIdx.x; u < CQ * (EC / 4); u += NT) {
      const int cq = u % CQ, e4 = u / CQ;
      unsigned r[4], col[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = 4 * e4 + k;
        r[k] = e < ec ? __ldg(reinterpret_cast<const unsigned*>(
                            a.w3 + (long)(e0 + e) * a.Co + 4 * cq))
                      : 0u;
      }
      reprotorch::transpose4x4(r, col);
#pragma unroll
      for (int j = 0; j < 4; ++j) w3s[(4 * cq + j) * W3S + e4] = col[j];
    }
    return;
  }
  for (int i = threadIdx.x; i < a.Co * (EC / 4); i += NT) {
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
}

template <int KS, int S, int NACC>
__global__ void __launch_bounds__(NT) irb_kernel(IrbArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int tiles_w = (a.Wo + a.TW - 1) / a.TW;
  const int ty0 = (blockIdx.x / tiles_w) * a.TH;
  const int tx0 = (blockIdx.x % tiles_w) * a.TW;
  const int slice = blockIdx.y, b = blockIdx.z;
  const int e_lo = slice * a.eslice, e_hi = min(a.E, e_lo + a.eslice);
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
      const int* src = a.x + (((long)b * a.H + gy) * a.W + gx) * a.C + 4 * c4;
      if (a.vec_x) {
        v = reprotorch::narrow4(__ldg(reinterpret_cast<const int4*>(src)));
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * c4 + k < a.C) v |= ((unsigned)src[k] & 0xFFu) << (8 * k);
      }
    }
    xs[i] = v;
  }

  int acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0;

  for (int e0 = e_lo; e0 < e_hi; e0 += EC) {
    const int ec = min(EC, e_hi - e0);
    __syncthreads();  // xs written; the previous chunk's readers are done
    stage_w1(a, w1s, e0, ec);
    stage_w2<KS>(a, w2s, e0, ec);
    stage_w3(a, w3s, e0, ec);
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

  // 5. one slice: projection epilogue, residual, store; else the partials
  const size_t mn = (size_t)a.B * a.Ho * a.Wo * a.Co;
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    const int idx = tid + j * NT;
    if (idx >= TO * a.Co) continue;
    const int o = idx / a.Co, co = idx % a.Co;
    const int oy = ty0 + o / a.TW, ox = tx0 + o % a.TW;
    if (oy >= a.Ho || ox >= a.Wo) continue;
    const long at = (((long)b * a.Ho + oy) * a.Wo + ox) * a.Co + co;
    if (gridDim.y > 1) {
      a.part[slice * mn + at] = acc[j];
    } else {
      a.out[at] = finish(a, acc[j], co,
                         a.x + (((long)b * a.H + oy) * a.W + ox) * a.C + co);
    }
  }
}

// out = epilogue(sum over s of part[s]), the slices added in order. A
// residual block has stride 1 and C == Co, so x is laid out as out.
__global__ void __launch_bounds__(NT) irb_epilogue(IrbArgs a, int splits) {
  const int mn = a.B * a.Ho * a.Wo * a.Co;
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= mn) return;
  int acc = a.part[i];
  for (int s = 1; s < splits; ++s) acc += a.part[(size_t)s * mn + i];
  a.out[i] = finish(a, acc, i % a.Co, a.x + i);
}

// Allows `kern` the card's most dynamic shared memory (a launch asks for its
// tile's), once a device: `done`, one per instantiation, has a bit for each
// device already set.
template <typename KERN>
int allow_smem(KERN kern, unsigned& done) {
  int dev = 0, most = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (dev < 32 && (done >> dev & 1u)) return 0;
  if (cudaError_t e = cudaDeviceGetAttribute(
          &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
    return (int)e;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (e == cudaSuccess && dev < 32) done |= 1u << dev;
  return (int)e;
}

template <int KS, int S, int NACC>
int launch(const IrbArgs& a, int splits, size_t smem, cudaStream_t stream) {
  auto kern = irb_kernel<KS, S, NACC>;
  static unsigned done = 0;
  if (int e = allow_smem(kern, done)) return e;
  const int tiles = ((a.Ho + a.TH - 1) / a.TH) * ((a.Wo + a.TW - 1) / a.TW);
  kern<<<dim3(tiles, splits, a.B), NT, smem, stream>>>(a);
  if (splits == 1) return (int)cudaGetLastError();
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  const int mn = a.B * a.Ho * a.Wo * a.Co;
  irb_epilogue<<<(mn + NT - 1) / NT, NT, 0, stream>>>(a, splits);
  return (int)cudaGetLastError();
}

template <int KS, int S>
int dispatch_nacc(const IrbArgs& a, int nacc, int splits, size_t smem,
                  cudaStream_t st) {
  switch (nacc) {
    case 4: return launch<KS, S, 4>(a, splits, smem, st);
    case 8: return launch<KS, S, 8>(a, splits, smem, st);
    case 16: return launch<KS, S, 16>(a, splits, smem, st);
    case 32: return launch<KS, S, 32>(a, splits, smem, st);
    case 64: return launch<KS, S, 64>(a, splits, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success), including a refusal of
// the tile's shared memory (above 227 KB). kernel 3 or 5, stride 1 or 2;
// nacc (4, 8, 16, 32 or 64) must cover tile_h * tile_w * Co / 256; E is cut
// into `splits` slices of `eslice` channels (whole chunks of 32, none
// empty), and with splits > 1 `work` holds splits * B * Ho * Wo * Co int32;
// `smem` must be the bytes this kernel computes for the tile.
extern "C" int fused_irb_q_launch(
    const void* x, const void* w1, const void* m1, const void* z1,
    const void* b1, const void* w2, const void* m2, const void* z2,
    const void* b2, const void* w3, const void* m3, const void* z3,
    const void* b3, void* out, void* work, int B, int H, int W, int C, int E,
    int Co, int Ho, int Wo, int pad_t, int pad_l, int tile_h, int tile_w,
    int kernel, int stride, int qmax, int nacc, int splits, int eslice,
    int smem, int residual, float a_z, float ra, float b_z, float rb, int ryz,
    void* stream) {
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
  a.part = static_cast<int*>(work);
  a.B = B; a.H = H; a.W = W; a.C = C; a.E = E; a.Co = Co; a.Ho = Ho;
  a.Wo = Wo; a.pad_t = pad_t; a.pad_l = pad_l; a.TH = tile_h; a.TW = tile_w;
  a.qmax = qmax; a.eslice = eslice; a.residual = residual;
  a.vec_x = C % 4 == 0 && (uintptr_t)x % 16 == 0;
  a.vec_e = E % 4 == 0 && (uintptr_t)w1 % 4 == 0 && (uintptr_t)w2 % 4 == 0;
  a.vec_co = Co % 4 == 0 && (uintptr_t)w3 % 4 == 0;
  a.a_z = a_z; a.ra = ra; a.b_z = b_z; a.rb = rb; a.ryz = ryz;
  if ((long)tile_h * tile_w * Co > (long)nacc * NT ||
      (long)B * Ho * Wo * Co >= (1L << 31) || splits < 1 || eslice < EC ||
      eslice % EC || (long)(splits - 1) * eslice >= E ||
      (long)splits * eslice < E || (splits > 1 && work == nullptr) ||
      (size_t)smem != smem_bytes(a, kernel, stride))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kernel == 3 && stride == 1) return dispatch_nacc<3, 1>(a, nacc, splits, smem, st);
  if (kernel == 3 && stride == 2) return dispatch_nacc<3, 2>(a, nacc, splits, smem, st);
  if (kernel == 5 && stride == 1) return dispatch_nacc<5, 1>(a, nacc, splits, smem, st);
  if (kernel == 5 && stride == 2) return dispatch_nacc<5, 2>(a, nacc, splits, smem, st);
  return (int)cudaErrorInvalidValue;
}
