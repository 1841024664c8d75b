// Quantized pointwise convolution / dense layer: the int GEMM
// [M = B*H*W, K = C_in] x [K, N = C_out] with int32 accumulation and the
// requant epilogue  y = clip(round((acc + zpc) * mult) + bias, 0, qmax).
//
// Replaces src/repro/kernels/pointwise_conv.py::pointwise_conv_q (_pw_kernel).
//
// What bounds it on the H100: on the main path K and N are small (16..1280)
// and the activations int32 (4 bytes a value in, 4 out), so the bytes: the
// Head's [100352, 32] x [32, 16] moves 19 MB. With few rows (the
// Classifier's 8, the SE FCs' batch) it is the latency of one block walking
// all of K.
//
// Design: the integer tensor cores, mma.sync m16n8k32 u8 x s8 -> s32. A
// block owns a BM x BN output tile; warps own 16- or 32-row strips of it.
// K streams through shared memory BK at a time: x is read with 16-byte
// loads of int32 and narrowed to u8 as it is stored (the kernel's domain:
// x in [0, 255], which every act4/act8 activation meets), w is gathered
// into [n][k] so that a B fragment is one 32-bit word (4-byte loads of 4
// rows, transposed in registers with byte permutes). Where the tiles
// leave SMs idle and K is long (few rows), K is split across blocks
// (grid z): each split writes its int32 partial sums to a workspace, and
// `pw_epilogue` adds them in split order and runs the epilogue. Integer
// sums are exact in any order, so every tile and split gives the same bits.
// The epilogue stages the tile through shared memory and writes it with
// 16-byte stores where rows allow.
#include "common.cuh"

namespace {

__device__ __forceinline__ void mma_u8s8(int (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Warps: WM along M (16-row strips, 1 or 2 m16 tiles each), WN along N.
template <int BM, int BN>
struct Warps {
  static constexpr int WM = BM / 16 < 4 ? BM / 16 : 4;
  static constexpr int WN = 4 / WM < BN / 8 ? 4 / WM : BN / 8;
  static constexpr int MI = BM / 16 / WM;  // m16 tiles a warp
  static constexpr int NJ = BN / 8 / WN;   // n8 tiles a warp
  static constexpr int NT = 32 * WM * WN;
};

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(Warps<BM, BN>::NT)
pw_kernel(const int* __restrict__ x, const int8_t* __restrict__ w,
          const float* __restrict__ mult, const int* __restrict__ zpc,
          const int* __restrict__ bias, int* __restrict__ out, int M, int K,
          int N, int qmax, int ksplit, int vec_x, int vec_w, int vec_out) {
  using W = Warps<BM, BN>;
  constexpr int NT = W::NT;
  constexpr int RW = BK / 4 + 4;  // words a shared row: conflict-free frags
  constexpr int OUT_LD = BN + 4;  // ints a row of the staged output tile
  constexpr int TILE_WORDS = (BM + BN) * RW;
  constexpr int SMEM_WORDS =
      TILE_WORDS > BM * OUT_LD ? TILE_WORDS : BM * OUT_LD;
  static_assert(BM * (BK / 4) % NT == 0 && BN * (BK / 4) % NT == 0,
                "every thread stages the same number of words");
  __shared__ __align__(16) unsigned smem[SMEM_WORDS];
  unsigned* xs = smem;            // [BM][RW]: u8 x, k contiguous
  unsigned* ws = smem + BM * RW;  // [BN][RW]: s8 w transposed, k contiguous

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / W::WN, wn = warp % W::WN;
  const int g = lane >> 2, t = lane & 3;
  const long m0 = (long)blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k0 = blockIdx.z * ksplit, k1 = min(K, k0 + ksplit);

  int acc[W::MI][W::NJ][4];
#pragma unroll
  for (int i = 0; i < W::MI; ++i)
#pragma unroll
    for (int j = 0; j < W::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int kc = k0; kc < k1; kc += BK) {
    // x: BM rows x BK/4 words; vec_x: K % 4 == 0 and x on 16 bytes
#pragma unroll
    for (int it = 0; it < BM * (BK / 4) / NT; ++it) {
      const int i = tid + it * NT;
      const int r = i / (BK / 4), q = i % (BK / 4);
      const long m = m0 + r;
      const int k = kc + 4 * q;
      unsigned word = 0;
      if (m < M && k < k1) {
        const int* src = x + m * K + k;
        if (vec_x) {
          word = reprotorch::narrow4(*reinterpret_cast<const int4*>(src));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k + e < k1) word |= (unsigned)(src[e] & 0xFF) << (8 * e);
        }
      }
      xs[r * RW + q] = word;
    }
    // w: BN columns x BK/4 words. vec_w (N % 4 == 0, w on 4 bytes): a
    // thread reads a 4 x 4 byte block, 4 rows of 4 columns, and transposes
    // it in registers; else one byte at a time. Lanes run along n.
    if (vec_w) {
      constexpr int U = (BN / 4) * (BK / 4);
#pragma unroll
      for (int it = 0; it < (U + NT - 1) / NT; ++it) {
        const int u = tid + it * NT;
        if (U % NT != 0 && u >= U) break;
        const int cg = u % (BN / 4), q = u / (BN / 4);
        const int n = n0 + 4 * cg, k = kc + 4 * q;
        unsigned r[4], c[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          r[e] = (n < N && k + e < k1)
                     ? *reinterpret_cast<const unsigned*>(w + (long)(k + e) * N + n)
                     : 0u;
        reprotorch::transpose4x4(r, c);
#pragma unroll
        for (int j = 0; j < 4; ++j) ws[(4 * cg + j) * RW + q] = c[j];
      }
    } else {
#pragma unroll
      for (int it = 0; it < BN * (BK / 4) / NT; ++it) {
        const int i = tid + it * NT;
        const int c = i % BN, q = i / BN;
        const int n = n0 + c, k = kc + 4 * q;
        unsigned word = 0;
        if (n < N) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k + e < k1)
              word |= (unsigned)(uint8_t)w[(long)(k + e) * N + n] << (8 * e);
        }
        ws[c * RW + q] = word;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kb = 0; kb < BK / 4; kb += 8) {  // 32 k a step, in words
      unsigned bf[W::NJ][2];
#pragma unroll
      for (int j = 0; j < W::NJ; ++j) {
        const unsigned* row = ws + ((wn * W::NJ + j) * 8 + g) * RW + kb + t;
        bf[j][0] = row[0];
        bf[j][1] = row[4];
      }
#pragma unroll
      for (int i = 0; i < W::MI; ++i) {
        const unsigned* row = xs + ((wm * W::MI + i) * 16 + g) * RW + kb + t;
        const unsigned af[4] = {row[0], row[8 * RW], row[4], row[8 * RW + 4]};
#pragma unroll
        for (int j = 0; j < W::NJ; ++j) mma_u8s8(acc[i][j], af, bf[j][0],
                                                 bf[j][1]);
      }
    }
    __syncthreads();
  }

  // stage the tile (epilogue applied unless K is split), then store rows
  const bool split = gridDim.z > 1;
  int* ot = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int i = 0; i < W::MI; ++i)
#pragma unroll
    for (int j = 0; j < W::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (wm * W::MI + i) * 16 + g + (e >> 1) * 8;
        const int c = (wn * W::NJ + j) * 8 + 2 * t + (e & 1);
        const int n = n0 + c;
        int v = acc[i][j][e];
        if (!split && n < N)
          v = reprotorch::requant_clip(v + zpc[n], mult[n], bias[n], qmax);
        ot[r * OUT_LD + c] = v;
      }
  __syncthreads();
  int* dst = out + (long)blockIdx.z * M * N;  // a split's partial, or out
  if (vec_out) {  // N % 4 == 0, out on 16 bytes: 16-byte stores
    for (int i = tid; i < BM * (BN / 4); i += NT) {
      const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
      const long m = m0 + r;
      if (m < M && n0 + c < N)
        *reinterpret_cast<int4*>(dst + m * N + n0 + c) =
            *reinterpret_cast<const int4*>(ot + r * OUT_LD + c);
    }
  } else {
    for (int i = tid; i < BM * BN; i += NT) {
      const int r = i / BN, c = i % BN;
      const long m = m0 + r;
      if (m < M && n0 + c < N) dst[m * N + n0 + c] = ot[r * OUT_LD + c];
    }
  }
}

// out = epilogue(sum over s of part[s]), the splits added in order
__global__ void pw_epilogue(const int* __restrict__ part,
                            const float* __restrict__ mult,
                            const int* __restrict__ zpc,
                            const int* __restrict__ bias,
                            int* __restrict__ out, long MN, int N, int splits,
                            int qmax) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  int acc = part[i];
  for (int s = 1; s < splits; ++s) acc += part[s * MN + i];
  const int n = (int)(i % N);
  out[i] = reprotorch::requant_clip(acc + zpc[n], mult[n], bias[n], qmax);
}

template <int BM, int BN, int BK>
int launch(const int* x, const int8_t* w, const float* mult, const int* zpc,
           const int* bias, int* out, int* work, int M, int K, int N,
           int qmax, int splits, int ksplit, cudaStream_t stream) {
  int* dst = splits > 1 ? work : out;
  const int vec_x = K % 4 == 0 && (uintptr_t)x % 16 == 0;
  const int vec_w = N % 4 == 0 && (uintptr_t)w % 4 == 0;
  const int vec_out = N % 4 == 0 && (uintptr_t)dst % 16 == 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  pw_kernel<BM, BN, BK><<<grid, Warps<BM, BN>::NT, 0, stream>>>(
      x, w, mult, zpc, bias, dst, M, K, N, qmax, ksplit, vec_x, vec_w,
      vec_out);
  if (splits > 1) {
    const long mn = (long)M * N;
    pw_epilogue<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
        work, mult, zpc, bias, out, mn, N, splits, qmax);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). block_m must be 16,
// 64 or 128, block_n 16 or 64, block_k 32 or 128. K is cut into `splits`
// slices of `ksplit` rows (a multiple of block_k; the last one shorter);
// with splits > 1, `work` holds splits * M * N int32.
extern "C" int pointwise_conv_q_launch(
    const void* x, const void* w, const void* mult, const void* zpc,
    const void* bias, void* out, void* work, int M, int K, int N, int qmax,
    int block_m, int block_n, int block_k, int splits, int ksplit,
    void* stream) {
  const int* xp = static_cast<const int*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* mp = static_cast<const float*>(mult);
  const int* zp = static_cast<const int*>(zpc);
  const int* bp = static_cast<const int*>(bias);
  int* op = static_cast<int*>(out);
  int* wk = static_cast<int*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1 || N < 1 || splits < 1 || ksplit < 1 ||
      ksplit % block_k || (long)splits * ksplit < K ||
      (long)(splits - 1) * ksplit >= K)
    return (int)cudaErrorInvalidValue;
#define PW_CASE(BM_, BN_, BK_)                                             \
  if (block_m == BM_ && block_n == BN_ && block_k == BK_)                  \
    return launch<BM_, BN_, BK_>(xp, wp, mp, zp, bp, op, wk, M, K, N, qmax, \
                                 splits, ksplit, st);
  PW_CASE(16, 16, 32) PW_CASE(16, 16, 128) PW_CASE(16, 64, 32)
  PW_CASE(16, 64, 128) PW_CASE(64, 16, 32) PW_CASE(64, 16, 128)
  PW_CASE(64, 64, 32) PW_CASE(64, 64, 128) PW_CASE(128, 16, 32)
  PW_CASE(128, 16, 128) PW_CASE(128, 64, 32) PW_CASE(128, 64, 128)
#undef PW_CASE
  return (int)cudaErrorInvalidValue;
}
