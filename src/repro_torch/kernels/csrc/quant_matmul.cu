// K5, weight-only quantized matmul: y[M, N] = x[M, K] @ (w_q * scale), f32
// out. x is f32 or bf16; w_q is int8 [K, N] (8 bits) or uint8 [K, N/2]
// holding two signed nibbles a byte, the low one column 2j and the high one
// column 2j+1 (4 bits); scale is f32 or bf16 [K / group, N], one row per
// group of `group` consecutive k.
//
// Replaces src/repro/kernels/quant_matmul.py::quant_matmul (_qmm_kernel).
//
// Three variants, chosen by `plan` in kernels/quant_matmul.py (shape-based,
// explicit; each has its own counter there):
//
// * decode (at most 16 rows): bound by the weight bytes. A split-K GEMV:
//   the mma kernel below with a 16 x 256 block tile (one m16 tile, 8 warps
//   across N), its rows of x zero-padded to 16. The weight streams through
//   a cp.async ring in 16-byte copies, coalesced along N in the JAX layout,
//   and is widened to bf16 without I2F; the tensor cores take the
//   multiply-adds, so a weight costs a few integer operations and the
//   kernel keeps up with the bytes (a CUDA-core GEMV spent about a dozen
//   instructions a weight and ran at half the speed).
// * mma (more rows): bound by operations. bf16 tensor cores
//   (mma.sync m16n8k16, f32 accumulate) over 128 x 128 block tiles, 8 warps
//   of 32 x 64, K in steps of 32 through a 3-stage cp.async ring. Integer
//   weights are exact in bf16 (|q| <= 128), so the products x * q are exact
//   for a bf16 x; an f32 x enters as three bf16 terms (hi, mid, lo: the
//   successive remainders), three MMAs a step. The weight tile is widened
//   to bf16 integers in shared memory (byte-to-mantissa tricks, no I2F) and
//   read with ldmatrix.trans. The scale multiplies each group's f32 partial
//   sum when the k walk leaves the group (once, at the end, per channel):
//   the scale is never folded into a bf16 weight. decode and mma need
//   group % 16 == 0 or one group, and K % 8 == 0.
// * tiled: the first port's plain tiled f32 GEMM on the CUDA cores (one
//   block a BM x 64 output tile, K through shared memory 32 rows at a time),
//   kept for the shapes neither of the others takes (rows not a multiple of
//   16 bytes, groups that are not a multiple of 16).
//
// decode and mma may split K across blocks (grid z). Each split writes
// its f32 partial to a workspace [splits, M, N] that the wrapper allocates;
// `reduce_splits` then adds them in split order: no float atomics, the same
// bits on every run.
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

// ---------------------------------------------------------------------------
// shared helpers of the decode and mma variants
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid (src is
// then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// A scale of either type, widened; `s_bf16` is uniform across the grid.
__device__ __forceinline__ float scale_at(const void* s, int s_bf16, long i) {
  return s_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(s)[i])
                : static_cast<const float*>(s)[i];
}

// Four int8 (one word, byte i = column i) -> four exact floats: the byte,
// biased by 128, becomes the low mantissa byte of 2^23; subtracting
// 2^23 + 128 leaves q: a byte permute and a subtract a weight instead of
// the quarter-rate I2F.
__device__ __forceinline__ void s8x4_to_f32(unsigned w, float f[4]) {
  const unsigned v = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7653)) - 8388736.f;
}

// out[i] = sum over s of part[s][i], in split order (float4 at a time).
__global__ void reduce_splits(const float4* __restrict__ part,
                              float4* __restrict__ out, long n4, int splits) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 a = part[i];
  for (int s = 1; s < splits; ++s) {
    const float4 b = part[s * n4 + i];
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  out[i] = a;
}

// ---------------------------------------------------------------------------
// mma: bf16 tensor cores; block tiles of 128 x 128 (many rows) or 16 x 256
// (a decode step: one m16 tile, the weight streamed wide)
// ---------------------------------------------------------------------------

constexpr int MMA_BK = 32, MMA_NT = 256, MMA_STAGES = 3;
constexpr int APL_ROW = MMA_BK * 2;  // bytes of a bf16 row of an x tile

// 16-byte chunk c of row r of a bf16 x tile (4 chunks a row) lives at
// chunk bswz(r, c): conflict-free ldmatrix. An f32 x tile (8 chunks a row)
// uses fswz: conflict-free 16-byte reads a quarter-warp.
__device__ __forceinline__ int bswz(int r, int c) { return c ^ ((r >> 1) & 3); }
__device__ __forceinline__ int fswz(int r, int c) { return c ^ (r & 7); }

__device__ __forceinline__ void ldmatrix_x4(unsigned (&d)[4], unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&d)[4],
                                                  unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2 by truncation; exact for the integers |v| <= 128
__device__ __forceinline__ unsigned hi16x2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// 16 int8 weights (4 words) -> 16 bf16 (8 words), column order kept
__device__ __forceinline__ void widen_s8(uint4 r, unsigned (&o)[8]) {
  const unsigned in[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
    s8x4_to_f32(in[i], f);
    o[2 * i] = hi16x2(f[0], f[1]);
    o[2 * i + 1] = hi16x2(f[2], f[3]);
  }
}

// 16 signed nibbles (2 words, byte i = columns 2i, 2i+1) -> 16 bf16: each
// byte's two nibbles, biased by 8, become the low mantissa bits of two bf16
// 128s (0x4300), then one bf16x2 FMA subtracts 136 (exact).
__device__ __forceinline__ void widen_s4(uint2 r, unsigned (&o)[8]) {
  const unsigned in[2] = {r.x, r.y};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const unsigned v = in[h] ^ 0x88888888u, sh = v >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned p =
          (__byte_perm(v, sh, i | ((4 + i) << 8)) & 0x000F000Fu) | 0x43004300u;
      unsigned d;
      asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
          : "=r"(d)
          : "r"(p), "r"(0x3F803F80u), "r"(0xC308C308u));  // p * 1 - 136
      o[4 * h + i] = d;
    }
  }
}

__device__ __forceinline__ unsigned bf16x2_rn(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&t);
}

// an f32 pair -> three bf16x2 terms whose sum is the pair (hi, mid, lo:
// each the bf16 rounding of what the earlier ones left; every remainder
// is exact in f32)
__device__ __forceinline__ void split3(float v0, float v1, unsigned& hi,
                                       unsigned& mid, unsigned& lo) {
  hi = bf16x2_rn(v0, v1);
  v0 -= __uint_as_float(hi << 16);
  v1 -= __uint_as_float(hi & 0xFFFF0000u);
  mid = bf16x2_rn(v0, v1);
  v0 -= __uint_as_float(mid << 16);
  v1 -= __uint_as_float(mid & 0xFFFF0000u);
  lo = bf16x2_rn(v0, v1);
}

// A block owns a BM x BN output tile and one slice of K. Its 8 warps form a
// WM x (8 / WM) grid; a warp owns MI m16 tiles and NJ n8 tiles. Each k step
// of 32: the raw x tile and weight tile arrive by cp.async; the weights are
// widened to bf16 into `wb`, an f32 x tile is split into its three bf16
// planes `pl` (bf16 x is read where it landed); then ldmatrix and
// mma.sync. GROUPED: more than one scale row, so each group's partial sum
// is kept apart in `part` and added into `acc` times its scale when the
// walk leaves the group.
template <int BM, int BN, int WM, int BITS, typename XT, bool GROUPED>
__global__ void __launch_bounds__(MMA_NT)
qmm_mma(const XT* __restrict__ x, const uint8_t* __restrict__ w,
        const void* __restrict__ scale, int s_bf16, float* __restrict__ out,
        int M, int K, int N, int group, int ksplit) {
  constexpr int WN = 8 / WM, MI = BM / WM / 16, NJ = BN / WN / 8;
  static_assert(MI >= 1 && NJ % 2 == 0, "warp tile of m16 x (2 n8) units");
  constexpr bool F32 = sizeof(XT) == 4;
  constexpr int NPLANE = F32 ? 3 : 1;
  constexpr int A_ROW = MMA_BK * (int)sizeof(XT);  // raw bytes of an x row
  constexpr int A_CPR = A_ROW / 16;
  constexpr int A_BYTES = BM * A_ROW;
  constexpr int B_ROW = BN * BITS / 8;  // raw bytes of a weight k row
  constexpr int B_CPR = B_ROW / 16;
  constexpr int STAGE = A_BYTES + MMA_BK * B_ROW;
  constexpr int WB_ROW = BN * 2;  // bytes of a widened k row
  constexpr int WB_BYTES = MMA_BK * WB_ROW;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* wb = smem + MMA_STAGES * STAGE;  // [BK][BN] bf16, swizzled
  uint8_t* pl = wb + WB_BYTES;              // f32 x: [3][BM][BK] bf16

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;
  const long m0 = (long)blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k0 = blockIdx.z * ksplit, k1 = min(K, k0 + ksplit);
  const int nsteps = (k1 - k0 + MMA_BK - 1) / MMA_BK;
  const long row_bytes = (long)N * BITS / 8;
  const long tile_byte = (long)n0 * BITS / 8;

  auto load_stage = [&](int st) {
    uint8_t* a = smem + (st % MMA_STAGES) * STAGE;
    uint8_t* b = a + A_BYTES;
    const int kb = k0 + st * MMA_BK;
    for (int i = tid; i < BM * A_CPR; i += MMA_NT) {
      const int r = i / A_CPR, c = i % A_CPR;
      const int k = kb + c * (16 / (int)sizeof(XT));
      const long m = m0 + r;
      const bool ok = m < M && k < k1;  // K % 8 == 0: whole chunks
      cp_async16(a + r * A_ROW + (F32 ? fswz(r, c) : bswz(r, c)) * 16,
                 ok ? x + m * K + k : x, ok);
    }
    for (int i = tid; i < MMA_BK * B_CPR; i += MMA_NT) {
      const int r = i / B_CPR, cb = (i % B_CPR) * 16;
      const int k = kb + r;
      const bool ok = k < k1 && tile_byte + cb < row_bytes;
      cp_async16(b + r * B_ROW + cb,
                 ok ? w + (long)k * row_bytes + tile_byte + cb : w, ok);
    }
  };

  // weights: 16 of one k row a unit, into logical chunks 2c, 2c + 1;
  // f32 x: 4 of one row a unit, into 8 bytes of each bf16 plane
  auto convert = [&](const uint8_t* a) {
    for (int u = tid; u < MMA_BK * (BN / 16); u += MMA_NT) {
      const int r = u / (BN / 16), c = u % (BN / 16);
      const uint8_t* src = a + A_BYTES + r * B_ROW;
      unsigned o[8];
      if (BITS == 8)
        widen_s8(*reinterpret_cast<const uint4*>(src + 16 * c), o);
      else
        widen_s4(*reinterpret_cast<const uint2*>(src + 8 * c), o);
      uint8_t* row = wb + r * WB_ROW;
      *reinterpret_cast<uint4*>(row + (((2 * c) ^ (r & 7)) << 4)) =
          make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(row + (((2 * c + 1) ^ (r & 7)) << 4)) =
          make_uint4(o[4], o[5], o[6], o[7]);
    }
    if constexpr (F32) {
      for (int u = tid; u < BM * A_CPR; u += MMA_NT) {
        const int r = u / A_CPR, c = u % A_CPR;
        const float4 v = *reinterpret_cast<const float4*>(
            a + r * A_ROW + (fswz(r, c) << 4));
        unsigned h[2], md[2], lo[2];
        split3(v.x, v.y, h[0], md[0], lo[0]);
        split3(v.z, v.w, h[1], md[1], lo[1]);
        const int off = r * APL_ROW + (bswz(r, c >> 1) << 4) + (c & 1) * 8;
        *reinterpret_cast<uint2*>(pl + off) = make_uint2(h[0], h[1]);
        *reinterpret_cast<uint2*>(pl + BM * APL_ROW + off) =
            make_uint2(md[0], md[1]);
        *reinterpret_cast<uint2*>(pl + 2 * BM * APL_ROW + off) =
            make_uint2(lo[0], lo[1]);
      }
    }
  };

  float acc[MI][NJ][4], part[MI][NJ][4];  // part: GROUPED only
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = part[i][j][e] = 0.f;

  // this thread's two columns of each n8 tile, from scale row gi
  auto load_scales = [&](int gi, float (&sc)[NJ][2]) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = n0 + wn * (BN / WN) + j * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        sc[j][e] = n < N ? scale_at(scale, s_bf16, (long)gi * N + n + e) : 0.f;
    }
  };
  // acc += part * sc, part = 0
  auto flush = [&](const float (&sc)[NJ][2]) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][j][e] = fmaf(part[i][j][e], sc[j][e & 1], acc[i][j][e]);
          part[i][j][e] = 0.f;
        }
  };

  for (int st = 0; st < MMA_STAGES - 1; ++st) {
    if (st < nsteps) load_stage(st);
    cp_async_commit();
  }
  // GROUPED: the scales of the group the walk is in, loaded as it enters
  // the group, so that they have the whole group to arrive
  float sc[NJ][2];
  if (GROUPED) load_scales(k0 / group, sc);
  for (int st = 0; st < nsteps; ++st) {
    cp_async_wait<MMA_STAGES - 2>();
    __syncthreads();  // stage st landed; everyone is done with st - 1
    if (st + MMA_STAGES - 1 < nsteps) load_stage(st + MMA_STAGES - 1);
    cp_async_commit();
    const uint8_t* a = smem + (st % MMA_STAGES) * STAGE;
    convert(a);  // wb and pl: the barrier above ends step st - 1's reads
    __syncthreads();
    const unsigned wb_s = smem_addr(wb);
    const unsigned a_s = F32 ? smem_addr(pl) : smem_addr(a);
#pragma unroll
    for (int sub = 0; sub < MMA_BK / 16; ++sub) {
      const int mi = lane >> 3;
      unsigned bf[NJ][2];
#pragma unroll
      for (int jj = 0; jj < NJ / 2; ++jj) {  // n8 tiles 2 jj and 2 jj + 1
        const int k = sub * 16 + (mi & 1) * 8 + (lane & 7);
        const int chunk = (wn * (BN / WN) + jj * 16 + (mi >> 1) * 8) >> 3;
        unsigned d[4];
        ldmatrix_x4_trans(d, wb_s + k * WB_ROW + ((chunk ^ (k & 7)) << 4));
        bf[2 * jj][0] = d[0];
        bf[2 * jj][1] = d[1];
        bf[2 * jj + 1][0] = d[2];
        bf[2 * jj + 1][1] = d[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        float(*c)[4] = GROUPED ? part[i] : acc[i];
        const int r = (wm * MI + i) * 16 + (mi & 1) * 8 + (lane & 7);
        const unsigned off = r * APL_ROW + (bswz(r, sub * 2 + (mi >> 1)) << 4);
#pragma unroll
        for (int p = NPLANE - 1; p >= 0; --p) {  // lo, mid, hi for f32 x
          unsigned af[4];
          ldmatrix_x4(af, a_s + p * BM * APL_ROW + off);
#pragma unroll
          for (int j = 0; j < NJ; ++j) mma_bf16(c[j], af, bf[j][0], bf[j][1]);
        }
      }
      const int kend = k0 + st * MMA_BK + sub * 16 + 16;
      if (GROUPED && kend % group == 0 && kend <= k1) {  // leaving a group
        flush(sc);
        if (kend < k1) load_scales(kend / group, sc);
      }
    }
  }
  // per channel (one scale row): the whole slice's sum, scaled once here;
  // grouped: the partial sum of a group the slice ends in the middle of
  if (!GROUPED || k1 % group) {
    if (GROUPED) {
      flush(sc);  // sc holds the scales of group (k1 - 1) / group
    } else {
      load_scales(0, sc);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] *= sc[j][e & 1];
    }
  }

  float* dst = out + (long)blockIdx.z * M * N;  // a split's partial, or out
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const long r = m0 + (wm * MI + i) * 16 + g;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = n0 + wn * (BN / WN) + j * 8 + 2 * t;
      if (n >= N) continue;
      if (r < M)
        *reinterpret_cast<float2*>(dst + r * N + n) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      if (r + 8 < M)
        *reinterpret_cast<float2*>(dst + (r + 8) * N + n) =
            make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

enum Variant { TILED = 0, DECODE = 1, MMA = 2 };

// Allows `kern` more than 48 KiB of dynamic shared memory, once a device:
// `done` (one per kernel) has a bit for each device already set.
template <typename KERN>
int set_smem(KERN kern, size_t bytes, unsigned& done) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (dev < 32 && (done >> dev & 1u)) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess && dev < 32) done |= 1u << dev;
  return (int)e;
}

template <int BITS, typename XT, typename ST>
int launch_tiled(const void* x, const void* w, const void* scale, void* out,
                 int M, int K, int N, int group, cudaStream_t stream) {
  const XT* xp = static_cast<const XT*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const ST* sp = static_cast<const ST*>(scale);
  float* op = static_cast<float*>(out);
  if (M <= 32) {  // few rows: a short tile wastes less
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

template <int BITS, typename XT>
int launch_tiled_s(const void* x, const void* w, const void* scale, void* out,
                   int M, int K, int N, int group, int s_bf16,
                   cudaStream_t st) {
  if (s_bf16)
    return launch_tiled<BITS, XT, __nv_bfloat16>(x, w, scale, out, M, K, N,
                                                 group, st);
  return launch_tiled<BITS, XT, float>(x, w, scale, out, M, K, N, group, st);
}

template <int BM, int BN, int WM, int BITS, typename XT>
int launch_mma(const void* x, const void* w, const void* scale, int s_bf16,
               float* dst, int M, int K, int N, int group, int splits,
               int ksplit, cudaStream_t st) {
  if (K % 8 || ksplit % MMA_BK || (group != K && group % 16))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      MMA_STAGES * (BM * MMA_BK * sizeof(XT) + MMA_BK * BN * BITS / 8) +
      MMA_BK * BN * 2 + (sizeof(XT) == 4 ? 3 * BM * APL_ROW : 0);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  const XT* xp = static_cast<const XT*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  if (group == K) {
    auto kern = qmm_mma<BM, BN, WM, BITS, XT, false>;
    static unsigned done = 0;
    if (int e = set_smem(kern, smem, done)) return e;
    kern<<<grid, MMA_NT, smem, st>>>(xp, wp, scale, s_bf16, dst, M, K, N,
                                     group, ksplit);
  } else {
    auto kern = qmm_mma<BM, BN, WM, BITS, XT, true>;
    static unsigned done = 0;
    if (int e = set_smem(kern, smem, done)) return e;
    kern<<<grid, MMA_NT, smem, st>>>(xp, wp, scale, s_bf16, dst, M, K, N,
                                     group, ksplit);
  }
  return (int)cudaGetLastError();
}

template <int BITS, typename XT>
int launch_split(int variant, const void* x, const void* w, const void* scale,
                 int s_bf16, void* out, void* work, int M, int K, int N,
                 int group, int splits, int ksplit, cudaStream_t st) {
  float* dst = static_cast<float*>(splits > 1 ? work : out);
  const int e =
      variant == DECODE
          ? (M > 16 ? (int)cudaErrorInvalidValue
                    : launch_mma<16, 256, 1, BITS, XT>(x, w, scale, s_bf16,
                                                       dst, M, K, N, group,
                                                       splits, ksplit, st))
          : launch_mma<128, 128, 4, BITS, XT>(x, w, scale, s_bf16, dst, M, K,
                                              N, group, splits, ksplit, st);
  if (e || splits == 1) return e;
  const long n4 = (long)M * N / 4;
  reduce_splits<<<(unsigned)((n4 + 255) / 256), 256, 0, st>>>(
      static_cast<const float4*>(work), static_cast<float4*>(out), n4, splits);
  return (int)cudaGetLastError();
}

template <int BITS>
int launch_bits(int variant, const void* x, const void* w, const void* scale,
                void* out, void* work, int M, int K, int N, int group,
                int x_bf16, int s_bf16, int splits, int ksplit,
                cudaStream_t st) {
  if (variant == TILED)
    return x_bf16 ? launch_tiled_s<BITS, __nv_bfloat16>(x, w, scale, out, M, K,
                                                        N, group, s_bf16, st)
                  : launch_tiled_s<BITS, float>(x, w, scale, out, M, K, N,
                                                group, s_bf16, st);
  // decode and mma: 16-byte copies of whole weight rows, float4 stores
  if (((long)N * BITS / 8) % 16 || splits < 1 || ksplit < 1 ||
      (long)splits * ksplit < K || (long)(splits - 1) * ksplit >= K ||
      ((uintptr_t)x | (uintptr_t)w | (uintptr_t)out | (uintptr_t)work) % 16)
    return (int)cudaErrorInvalidValue;
  return x_bf16 ? launch_split<BITS, __nv_bfloat16>(variant, x, w, scale,
                                                    s_bf16, out, work, M, K, N,
                                                    group, splits, ksplit, st)
                : launch_split<BITS, float>(variant, x, w, scale, s_bf16, out,
                                            work, M, K, N, group, splits,
                                            ksplit, st);
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). variant: 0 tiled,
// 1 decode (16-row tiles), 2 mma (128-row tiles). bits is 4 or 8; x_bf16 / s_bf16 say whether x / scale
// are bf16 (else f32); group >= 1 divides K; N is even when bits is 4.
// decode and mma: K is cut into `splits` slices of `ksplit` rows (the last
// one shorter); with splits > 1, `work` holds splits * M * N floats.
extern "C" int quant_matmul_launch(const void* x, const void* w,
                                   const void* scale, void* out, void* work,
                                   int M, int K, int N, int group, int bits,
                                   int x_bf16, int s_bf16, int variant,
                                   int splits, int ksplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group < 1 || K % group || M < 1 || N < 1 || variant < TILED ||
      variant > MMA)
    return (int)cudaErrorInvalidValue;
  if (bits == 8)
    return launch_bits<8>(variant, x, w, scale, out, work, M, K, N, group,
                          x_bf16, s_bf16, splits, ksplit, st);
  if (bits == 4 && N % 2 == 0)
    return launch_bits<4>(variant, x, w, scale, out, work, M, K, N, group,
                          x_bf16, s_bf16, splits, ksplit, st);
  return (int)cudaErrorInvalidValue;
}
