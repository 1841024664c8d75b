// K6, flash-decode attention over a grouped (GQA) KV cache. For batch b and
// kv head g, the rep query rows q[b, g, :, :] attend over cache positions
// [0, min(kv_len, S)) of k/v[b, :, g, :] with scale dh^-0.5; positions at or
// past kv_len are the TPU kernel's -1e30 mask, whose weights exp(-1e30 - m)
// are exactly 0 once one position is attended, so they are skipped. An int8
// cache is dequantized by its per-(position, kv head) scale; the output is
// acc / max(l, 1e-30) in q's type.
//
// Replaces src/repro/kernels/decode_attention.py::decode_attention (_kernel).
//
// What bounds it on the H100: the cache bytes, read once each below kv_len,
// and at Llama-3.2-1B's rep 4 the CUDA cores' work on them (8 flops a byte
// of int8, plus the int8 -> f32 unpack). Measured there, a warp is bound by
// its own instruction latency, so the design cuts instructions and serial
// chains a position and keeps scores and weights on chip.
//
// Design (`plan` and `layout` in kernels/decode_attention.py choose the
// launch; the launcher checks their choice and computes none of it):
//   * grid (KV / H x row chunks, B, splits): S is cut into `splits` slices
//     of `per_split` positions where the (b, heads) blocks leave SMs idle.
//     Each block writes its unnormalised (m, l, acc) in f32 to a workspace;
//     a second kernel, launched programmatically (it waits on the device for
//     the first), adds the slices in split order (M = max m_i, weights
//     exp(m_i - M)): no atomics, so equal inputs give equal bits. With one
//     split the block writes the output itself.
//   * a block is NW = 2 warps that work alone until the end, each on its
//     half of the slice. G lanes share a (position, kv head), each holding
//     E = 16 bytes of the row (16 int8, 8 bf16; two 16-byte loads of 8 f32);
//     a warp takes H adjacent kv heads of a position, so that it reads 128
//     contiguous bytes where it can (int8 at dh 64: H = 2), and U slots of
//     32 / (G * H) positions a step (4 for int8, 2 else: the registers
//     that int8's 4 blocks an SM leave free). q (rows x E) and the
//     accumulator stay in registers.
//   * every lane streams its own 16-byte slices through a 4-stage cp.async
//     ring in shared memory (a tile's K steps, then its V steps, then the
//     next tile's); a lane reads only what it copied, so the ring needs no
//     barrier.
//   * a tile is three passes over a warp's positions: partial dots (each
//     lane's E products a row) to shared memory; then, B4 entries a lane at
//     a time, the G partials added in a fixed order, the tile's max per
//     (head, row) over the warp, one rescale, and the weights (expf, not
//     __expf: the tolerance is 1e-5); then the weighted sum of V. Barriers:
//     __syncwarp, and two __syncthreads to merge the warps at the end.
//   * int8 scales are folded: score = (q . k_int) * (k_scale * dh^-0.5),
//     and the weight of a position is p * v_scale, once a position, instead
//     of dequantizing all dh values. That moves the rounding of each
//     product by about one f32 ulp, well inside the 1e-5 tolerance. An int8
//     byte becomes a float through the exponent trick (byte permute, one
//     add): integer-to-float conversions run at 16 a clock an SM.
// Where k or v is not 16-byte aligned, or dh does not fill whole 16-byte
// loads, the same kernel runs with scalar loads of E = 16 values a lane, one
// head a warp, and no ring.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 64, NW = NT / 32;   // threads and warps a block
constexpr int NS = 4;                  // stages of a lane's cp.async ring
// positions a lane takes a stage: 4 for int8, 2 else (the same registers)
template <typename CT>
__host__ __device__ constexpr int slots() { return sizeof(CT) == 1 ? 4 : 2; }
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void *q, *k, *v, *ks, *vs;
  const int* len_ptr;
  void* out;
  float* work;
  int len_val, B, KV, rep, dh, S, q_bf16, sc_bf16, splits, per_split, tile,
      heads;
  float scale;
};

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

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }

// q, scales and out are f32 or bf16, a flag uniform across the grid
__device__ __forceinline__ float load_f(const void* p, int bf16, long i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void store_f(void* p, int bf16, long i, float v) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

// A lane's 16-byte slices of a row -> E floats.
// int8: byte + 128 is the low byte of the float 2^23 + (byte + 128), and
// subtracting 2^23 + 128 leaves the int8 exactly.
__device__ __forceinline__ void unpack(const uint4 (&s)[1], float (&x)[16],
                                       const int8_t*) {
  const uint4 w = s[0];
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned b = u[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[4 * i + j] =
          __uint_as_float(__byte_perm(b, 0x4b000000u, 0x7440 | j)) -
          8388736.f;
  }
}
__device__ __forceinline__ void unpack(const uint4 (&s)[1], float (&x)[8],
                                       const __nv_bfloat16*) {
  const uint4 w = s[0];
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4 (&s)[2], float (&x)[8],
                                       const float*) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 w = s[i];
    x[4 * i] = __uint_as_float(w.x);
    x[4 * i + 1] = __uint_as_float(w.y);
    x[4 * i + 2] = __uint_as_float(w.z);
    x[4 * i + 3] = __uint_as_float(w.w);
  }
}

// The next stage a lane's ring copies: tile c of its warp's positions, pass
// ph (0 K, 1 V), step t of the T steps tile c takes (T == 0: none left),
// and the lane's first position p (its others are pps, 2 pps, ... later).
struct Cursor {
  int c, ph, t, T, p;
};

struct Walk {
  int ws0, ws1, twp, pl;  // the warp's positions [ws0, ws1) in tiles
  int step;               // positions a warp step: U slots of pps
  __device__ __forceinline__ int steps(int c) const {
    const int n = min(ws1 - (ws0 + c * twp), twp);
    return n > 0 ? (n + step - 1) / step : 0;
  }
  __device__ __forceinline__ int base(int c) const { return ws0 + c * twp; }
  __device__ __forceinline__ void advance(Cursor& u) const {
    if (u.T == 0) return;
    if (++u.t < u.T) {
      u.p += step;
      return;
    }
    u.t = 0;
    if (++u.ph == 2) {
      u.ph = 0;
      u.T = steps(++u.c);
    }
    u.p = base(u.c) + pl;
  }
};

template <int E>
constexpr int rows_max() { return E == 16 ? 4 : 8; }
// thread blocks an SM holds at the registers the launch bounds give a
// thread: 16 values a lane, or 8 q rows, take more (`_blocks_per_sm` in the
// wrapper; the launcher refuses another count)
template <int E, int RC>
constexpr int blocks_per_sm() { return E == 16 || RC == 8 ? 4 : 6; }

// One block: rows [r0, r0 + RC) of kv heads [g0, g0 + H) for batch b, over
// the positions [s0, s1) of its split; each of its NW warps walks 1 / NW of
// them.
template <typename CT, int E, int RC, bool VEC>
__global__ void __launch_bounds__(NT, blocks_per_sm<E, RC>())
split_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ESZ = sizeof(CT), U = slots<CT>();
  constexpr int N16 = VEC ? E * ESZ / 16 : 0;  // 16-byte slices a lane
  const int H = a.heads, nrc = (a.rep + RC - 1) / RC;
  const int g0 = blockIdx.x / nrc * H, r0 = blockIdx.x % nrc * RC;
  const int b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int kv_len = a.len_ptr ? *a.len_ptr : a.len_val;

  int G = 1;  // lanes a (position, head) (the launcher checks G * E >= dh)
  while (G * E < a.dh) G <<= 1;
  const int hs = __ffs(H) - 1;   // H = 1 << hs (a power of two)
  const int pps = 32 / (G * H);  // positions a warp step
  const int eg = lane % G, hl = lane / G % H, pl = lane / (G * H);
  const int d0 = eg * E, g = g0 + hl;
  const long bg = (long)b * a.KV + g;
  // q, loaded while kv_len is on its way
  float qr[RC][E], acc[RC][E];
#pragma unroll
  for (int r = 0; r < RC; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = d0 + e;
      qr[r][e] = r0 + r < a.rep && d < a.dh
                     ? load_f(a.q, a.q_bf16, (bg * a.rep + r0 + r) * a.dh + d)
                     : 0.f;
      acc[r][e] = 0.f;
    }
  }

  const int s0 = split * a.per_split;
  const int s1 = min(min(a.S, kv_len), s0 + a.per_split);
  const long n1 = (long)a.B * a.KV * a.splits * a.rep;  // m, l in the work

  if (s0 >= s1) {  // nothing to attend to: m = -inf, l = 0 (or a zero out)
    for (int i = tid; i < H * RC; i += NT) {
      const int row = r0 + i % RC;
      if (row >= a.rep) continue;
      const long bgi = (long)b * a.KV + g0 + i / RC;
      if (a.splits > 1) {
        const long o = (bgi * a.splits + split) * a.rep + row;
        a.work[o] = -INFINITY;
        a.work[n1 + o] = 0.f;
      } else {
        for (int d = 0; d < a.dh; ++d)
          store_f(a.out, a.q_bf16, (bgi * a.rep + row) * a.dh + d, 0.f);
      }
    }
    return;
  }

  constexpr bool quant = sizeof(CT) == 1;  // an int8 cache has scales
  const int twp = a.tile / NW;
  const int pws = ((a.per_split + NW - 1) / NW + pps - 1) / pps * pps;
  const Walk wk{s0 + w * pws, min(s1, s0 + (w + 1) * pws), twp, pl, U * pps};

  // shared memory: the ring, then each warp's tile space
  unsigned char* ring = smem;  // [NS][U][N16][NT] x 16 bytes
  float* work = reinterpret_cast<float*>(smem + NS * U * N16 * NT * 16);
  const int ne = twp * H;  // (position, head) pairs of a warp's tile
  float* part = work + w * ne * ((RC + 1) * G + RC + (quant ? 2 : 0));
  float* sc = part + ne * (RC + 1) * G;  // [twp][H][RC] scores, weights
  float* kss = sc + ne * RC;             // [twp][H] k scale * dh^-0.5
  float* vss = kss + ne;                 // [twp][H] v scale
  // part: [twp][H][RC + 1][G] partial dots of the G lanes of a (position,
  // head), a row of G floats of padding after each pair so that the pairs
  // of a warp step fall in different banks
  const long rs = (long)a.KV * a.dh;  // a position's stride in the cache
  const CT* kl = static_cast<const CT*>(a.k) + (long)b * a.S * rs +
                 (long)g * a.dh + d0;  // this lane's slice at position 0
  const CT* vl = static_cast<const CT*>(a.v) + (kl - static_cast<const CT*>(a.k));

  // the softmax state of the (head, row) pair (lane / RC % H, lane % RC),
  // which this lane keeps with the other lanes of that pair: m, and its
  // share l of the sum (RC * H divides 32)
  const int rp = lane % RC;
  float m = -INFINITY, l = 0.f;

  // the ring: the stage of cursor u into slot `slot`
  auto copy_stage = [&](const Cursor& c, int slot) {
    if (c.T > 0) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = c.p + u * pps;
        const bool in = p < wk.ws1;
        const CT* row = (c.ph ? vl : kl) + (in ? p : 0) * rs;
#pragma unroll
        for (int i = 0; i < N16; ++i) {
          const bool ok = in && d0 + i * (16 / ESZ) < a.dh;
          cp_async16(ring + ((size_t)((slot * U + u) * N16 + i) * NT + tid) * 16,
                     ok ? row + i * (16 / ESZ) : kl - d0, ok);
        }
      }
    }
    cp_async_commit();  // an empty group keeps the count
  };
  Cursor in{0, 0, 0, wk.steps(0), wk.base(0) + pl};
  int js = 0;  // stages read so far
  // this lane's raw slices of its next stage (U positions), from the ring
  auto next = [&](uint4 (&raw)[U][N16 > 0 ? N16 : 1]) {
    if constexpr (VEC) {
      copy_stage(in, (js + NS - 1) % NS);
      wk.advance(in);
      cp_async_wait<NS - 1>();
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < N16; ++i)
          raw[u][i] = reinterpret_cast<const uint4*>(ring)[
              (((js % NS) * U + u) * N16 + i) * NT + tid];
    }
    ++js;
  };
  // slot u of a stage as E floats: unpacked from raw, or loaded (scalar)
  auto values = [&](float (&x)[E], const uint4 (&raw)[U][N16 > 0 ? N16 : 1],
                    int u, int ph, int p) {
    if constexpr (VEC) {
      unpack(raw[u], x, kl);
    } else {
      const bool ok = p < wk.ws1;
      const CT* row = (ph ? vl : kl) + (ok ? p : 0) * rs;
#pragma unroll
      for (int e = 0; e < E; ++e)
        x[e] = ok && d0 + e < a.dh ? widen(row[e]) : 0.f;
    }
  };
  if constexpr (VEC) {
    Cursor u = in;
#pragma unroll
    for (int i = 0; i < NS - 1; ++i) {
      copy_stage(u, i);
      wk.advance(u);
    }
    in = u;
  }

  const int ij = pl * H + hl;  // this lane's (position, head) in a step
  const int dpart = pps * H * (RC + 1) * G, dsc = pps * H * RC;
  for (int c = 0;; ++c) {
    const int T = wk.steps(c);
    if (T == 0) break;
    const int base = wk.base(c), n = T * U * pps * H;  // pairs of the tile
    if constexpr (quant) {  // the tile's scales
      for (int i = lane; i < n; i += 32) {
        const int pj = base + (i >> hs);
        const long si = ((long)b * a.S + pj) * a.KV + g0 + (i & (H - 1));
        kss[i] = pj < wk.ws1 ? load_f(a.ks, a.sc_bf16, si) * a.scale : 0.f;
        vss[i] = pj < wk.ws1 ? load_f(a.vs, a.sc_bf16, si) : 0.f;
      }
    }
    float* pdst = part + ij * (RC + 1) * G + eg;
#pragma unroll 1
    for (int t = 0; t < T; ++t) {  // partial dots
      uint4 raw[U][N16 > 0 ? N16 : 1];
      float x[U][E], dot[U][RC];
      next(raw);
#pragma unroll
      for (int u = 0; u < U; ++u)
        values(x[u], raw, u, 0, base + (t * U + u) * pps + pl);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < RC; ++r) dot[u][r] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int r = 0; r < RC; ++r)
            dot[u][r] = fmaf(qr[r][e], x[u][e], dot[u][r]);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < RC; ++r) pdst[u * dpart + r * G] = dot[u][r];
      pdst += U * dpart;
    }
    __syncwarp();
    {  // scores of this lane's pair: the G partials in a fixed order,
       // times the scale; the tile's max over the warp; one rescale. B4
       // entries a lane at a time, every load before any store.
      constexpr int B4 = 8;
      const int ne4 = n * RC;  // entries i = jh * RC + rp, jh = i / RC
      float mx = -INFINITY;
      for (int i0 = lane; i0 < ne4; i0 += 32 * B4) {
        float sv[B4];
#pragma unroll
        for (int k = 0; k < B4; ++k) {
          const int i = min(i0 + 32 * k, ne4 - 1), jh = i / RC;
          const float* pp = part + (jh * (RC + 1) + rp) * G;
          float sum = 0.f;
          if (G % 4 == 0) {
            for (int q4 = 0; q4 < G; q4 += 4) {
              const float4 v4 = *reinterpret_cast<const float4*>(pp + q4);
              sum += v4.x; sum += v4.y; sum += v4.z; sum += v4.w;
            }
          } else {
            for (int q4 = 0; q4 < G; ++q4) sum += pp[q4];
          }
          sv[k] = base + (jh >> hs) < wk.ws1
                      ? sum * (quant ? kss[jh] : a.scale) : -INFINITY;
        }
#pragma unroll
        for (int k = 0; k < B4; ++k) {
          if (i0 + 32 * k < ne4) {
            sc[i0 + 32 * k] = sv[k];
            mx = fmaxf(mx, sv[k]);
          }
        }
      }
      for (int o = RC * H; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float mn = fmaxf(m, mx);
      const float cp = mn > m ? expf(m - mn) : 1.f;  // 0 while m was -inf
      l *= cp;
      m = mn;
#pragma unroll
      for (int r = 0; r < RC; ++r) {  // this lane's head's rows
        const float cr = __shfl_sync(FULL, cp, hl * RC + r);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] *= cr;
      }
      const float mu = m == -INFINITY ? 0.f : m;  // all -inf: weights 0
      __syncwarp();
      for (int i0 = lane; i0 < ne4; i0 += 32 * B4) {  // the weights
        float sv[B4], vv[B4];
#pragma unroll
        for (int k = 0; k < B4; ++k) {
          const int i = min(i0 + 32 * k, ne4 - 1);
          sv[k] = sc[i];
          vv[k] = quant ? vss[i / RC] : 1.f;
        }
#pragma unroll
        for (int k = 0; k < B4; ++k) {
          const float pr = expf(sv[k] - mu);
          if (i0 + 32 * k < ne4) {
            l += pr;
            sc[i0 + 32 * k] = quant ? pr * vv[k] : pr;
          }
        }
      }
      __syncwarp();
    }
    const float* wsrc = sc + ij * RC;
#pragma unroll 1
    for (int t = 0; t < T; ++t) {  // the weighted sum
      uint4 raw[U][N16 > 0 ? N16 : 1];
      float wv[U][RC];
      next(raw);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float* src = wsrc + u * dsc;
        if constexpr (RC % 4 == 0) {
#pragma unroll
          for (int r = 0; r < RC; r += 4) {
            const float4 t4 = *reinterpret_cast<const float4*>(src + r);
            wv[u][r] = t4.x; wv[u][r + 1] = t4.y;
            wv[u][r + 2] = t4.z; wv[u][r + 3] = t4.w;
          }
        } else {
#pragma unroll
          for (int r = 0; r < RC; ++r) wv[u][r] = src[r];
        }
      }
      float x[U][E];
#pragma unroll
      for (int u = 0; u < U; ++u)
        values(x[u], raw, u, 1, base + (t * U + u) * pps + pl);
#pragma unroll
      for (int r = 0; r < RC; ++r)
#pragma unroll
        for (int e = 0; e < E; ++e)
#pragma unroll
          for (int u = 0; u < U; ++u)
            acc[r][e] = fmaf(wv[u][r], x[u][e], acc[r][e]);
      wsrc += U * dsc;
    }
    __syncwarp();  // the tile's weights and scales are read before reuse
  }
  if constexpr (VEC) cp_async_wait<0>();

  // the warp's sums: acc over its position groups, l over the lanes of a
  // (head, row) pair
  for (int o = G * H; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < RC; ++r)
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[r][e] += __shfl_xor_sync(FULL, acc[r][e], o);
  }
  for (int o = RC * H; o < 32; o <<= 1) l += __shfl_xor_sync(FULL, l, o);

  // merge the warps in warp order
  __syncthreads();  // every warp is done with its tile space
  float* mw = work;               // [NW][H][RC]
  float* lw = mw + NW * H * RC;   // [NW][H][RC]
  float* aw = lw + NW * H * RC;   // [NW][H][RC][dh]
  const int wh = (w * H + hl) * RC;
  if (lane < RC * H) {  // this lane's pair is (lane / RC, lane % RC)
    mw[w * H * RC + lane] = m;
    lw[w * H * RC + lane] = l;
  }
  if (pl == 0) {
#pragma unroll
    for (int r = 0; r < RC; ++r)
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (d0 + e < a.dh) aw[(wh + r) * a.dh + d0 + e] = acc[r][e];
  }
  __syncthreads();
  for (int i = tid; i < H * RC * a.dh; i += NT) {
    const int hr = i / a.dh, d = i % a.dh, r = hr % RC;
    if (r0 + r >= a.rep) continue;
    float M = -INFINITY;
#pragma unroll
    for (int u = 0; u < NW; ++u) M = fmaxf(M, mw[u * H * RC + hr]);
    const float mu = M == -INFINITY ? 0.f : M;
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int u = 0; u < NW; ++u) {
      const float f = expf(mw[u * H * RC + hr] - mu);
      L = fmaf(lw[u * H * RC + hr], f, L);
      A = fmaf(aw[(u * H * RC + hr) * a.dh + d], f, A);
    }
    const long bgo = (long)b * a.KV + g0 + hr / RC;
    if (a.splits == 1) {
      store_f(a.out, a.q_bf16, (bgo * a.rep + r0 + r) * a.dh + d,
              A / fmaxf(L, 1e-30f));
    } else {
      const long o = (bgo * a.splits + split) * a.rep + r0 + r;
      a.work[2 * n1 + o * a.dh + d] = A;
      if (d == 0) {
        a.work[o] = M;
        a.work[n1 + o] = L;
      }
    }
  }
  // this block's (m, l, acc) are written: the merge may start launching
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Adds the splits of (b, g) in split order and writes the output. Every
// split's (m, l, acc) is loaded at once; an empty split (m = -inf, acc not
// written) is selected away, never multiplied.
template <int MAXS>
__global__ void __launch_bounds__(256) merge_kernel(Args a) {
  // launched while the split kernel drains: wait for all of it
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int g = blockIdx.x, b = blockIdx.y;
  const long bg = (long)b * a.KV + g;
  const long n1 = (long)a.B * a.KV * a.splits * a.rep;
  const float *wm = a.work, *wl = wm + n1, *wa = wl + n1;
  for (int i = threadIdx.x; i < a.rep * a.dh; i += blockDim.x) {
    const int r = i / a.dh, d = i % a.dh;
    float M = -INFINITY, L = 0.f, A = 0.f;
    for (int s0 = 0; s0 < a.splits; s0 += MAXS) {
      float mi[MAXS], li[MAXS], ai[MAXS];
#pragma unroll
      for (int k = 0; k < MAXS; ++k) {
        const long o = (bg * a.splits + min(s0 + k, a.splits - 1)) * a.rep + r;
        mi[k] = s0 + k < a.splits ? wm[o] : -INFINITY;
        li[k] = wl[o];
        ai[k] = wa[o * a.dh + d];
      }
      float Mn = M;
#pragma unroll
      for (int k = 0; k < MAXS; ++k) Mn = fmaxf(Mn, mi[k]);
      const float mu = Mn == -INFINITY ? 0.f : Mn;
      const float c = expf(M - mu);  // 0 while M was -inf
      L *= c;
      A *= c;
#pragma unroll
      for (int k = 0; k < MAXS; ++k) {
        const bool live = mi[k] != -INFINITY;
        const float f = expf(mi[k] - mu);
        L = live ? fmaf(li[k], f, L) : L;
        A = live ? fmaf(ai[k], f, A) : A;
      }
      M = Mn;
    }
    store_f(a.out, a.q_bf16, (bg * a.rep + r) * a.dh + d,
            A / fmaxf(L, 1e-30f));
  }
}

// The bytes of shared memory a block takes: the ring, then the larger of
// the warps' tile space (partial dots, scores, and the scales of an int8
// cache) and the warps' (m, l, acc) at the merge (`smem_bytes` in the
// wrapper mirrors this).
size_t smem_bytes(bool vec, int e, int esz, int rc, int heads, int dh,
                  int tile, bool quant) {
  int lanes = 1;  // lanes a (position, head)
  while (lanes * e < dh) lanes <<= 1;
  const int u = esz == 1 ? slots<int8_t>() : slots<float>();
  const size_t ring = vec ? (size_t)NS * u * NT * e * esz : 0;
  const size_t ne = (size_t)tile / NW * heads;  // pairs of a warp's tile
  const size_t work = NW * ne * ((rc + 1) * lanes + rc + (quant ? 2 : 0));
  const size_t merge = (size_t)NW * heads * rc * (dh + 2);
  return ring + 4 * (work > merge ? work : merge);
}

// Allows `kern` the card's most dynamic shared memory (a launch asks for its
// plan's), once a device: `done`, one per instantiation, has a bit for each
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

template <typename CT, int E, int RC, bool VEC>
int launch(const Args& a, int bps, size_t smem, cudaStream_t st) {
  if (bps != blocks_per_sm<E, RC>()) return (int)cudaErrorInvalidValue;
  auto kern = split_kernel<CT, E, RC, VEC>;
  static unsigned done = 0;
  if (int e = allow_smem(kern, done)) return e;
  const int nrc = (a.rep + RC - 1) / RC;
  kern<<<dim3(a.KV / a.heads * nrc, a.B, a.splits), NT, smem, st>>>(a);
  if (a.splits == 1) return (int)cudaGetLastError();
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  // programmatic dependent launch: the merge is launched while the split
  // kernel's last blocks run, and waits for them on the device
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.KV, a.B);
  cfg.blockDim = dim3(256);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, merge_kernel<16>, a);
}

template <typename CT, int E, bool VEC>
int by_rows(const Args& a, int rc, int bps, size_t smem, cudaStream_t st) {
  if (rc == 1) return launch<CT, E, 1, VEC>(a, bps, smem, st);
  if (rc == 4) return launch<CT, E, 4, VEC>(a, bps, smem, st);
  if constexpr (rows_max<E>() == 8) {
    if (rc == 8) return launch<CT, E, 8, VEC>(a, bps, smem, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns the CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue for a plan this kernel does not take. q_bf16: q and
// out are bf16 (else f32); cache: 0 int8 (scales ks/vs, bf16 when sc_bf16,
// else f32), 1 bf16, 2 f32. kv_len is read from len_ptr on the device when
// it is not null, else it is len_val. S is cut into `splits` slices of
// `per_split` positions (none empty below S), walked in tiles of `tile`
// (a multiple of 128) by blocks of `rows` q rows of `heads` kv heads (a
// power of two that divides KV; more than one only with 16-byte loads);
// with splits > 1, `work` holds splits * B * KV * rep * (dh + 2) floats.
// The layout is the wrapper's and is only checked: `vec` 16-byte loads
// (k and v aligned, dh in whole loads) of `values` a lane (16 int8, 8
// else; 16 with scalar loads), `bps` the blocks an SM holds at the launch
// bounds of that instantiation, `smem` the bytes this kernel computes.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* len_ptr, void* out, void* work, int len_val,
    int B, int KV, int rep, int dh, int S, int q_bf16, int cache, int sc_bf16,
    int splits, int per_split, int tile, int vec, int e, int rc, int heads,
    int bps, int smem, float scale, void* stream) {
  if (B < 1 || B > 65535 || KV < 1 || rep < 1 || dh < 1 || S < 0 ||
      cache < 0 || cache > 2 || splits < 1 || splits > 65535 ||
      per_split < 0 || (long)splits * per_split < S ||
      (splits > 1 && ((long)(splits - 1) * per_split >= S ||
                      work == nullptr)) ||
      tile < NT || tile % NT || heads < 1 || (heads & (heads - 1)) ||
      KV % heads)
    return (int)cudaErrorInvalidValue;
  const int esz = cache == 0 ? 1 : cache == 1 ? 2 : 4;
  const int e_vec = cache == 0 ? 16 : 8;
  if ((vec && (((uintptr_t)k | (uintptr_t)v) % 16 ||
               (long)dh * esz % 16 || dh > 32 * e_vec)) ||
      e != (vec ? e_vec : 16))
    return (int)cudaErrorInvalidValue;
  int lanes = 1;  // lanes a (position, head)
  while (lanes * e < dh) lanes <<= 1;
  const int step = (esz == 1 ? slots<int8_t>() : slots<float>()) *
                   (32 / (lanes * heads));  // positions a warp step
  if (lanes > 32 || lanes * heads > 32 || rc * heads > 32 ||
      (heads > 1 && !vec) || (tile / NW) % step ||
      (size_t)smem != smem_bytes(vec, e, esz, rc, heads, dh, tile, cache == 0))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v;
  a.ks = cache == 0 ? ks : nullptr;
  a.vs = cache == 0 ? vs : nullptr;
  a.len_ptr = static_cast<const int*>(len_ptr);
  a.out = out;
  a.work = static_cast<float*>(work);
  a.len_val = len_val; a.B = B; a.KV = KV; a.rep = rep; a.dh = dh; a.S = S;
  a.q_bf16 = q_bf16; a.sc_bf16 = sc_bf16; a.splits = splits;
  a.per_split = per_split; a.tile = tile; a.heads = heads; a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cache == 0)
    return vec ? by_rows<int8_t, 16, true>(a, rc, bps, smem, st)
               : by_rows<int8_t, 16, false>(a, rc, bps, smem, st);
  if (cache == 1)
    return vec ? by_rows<__nv_bfloat16, 8, true>(a, rc, bps, smem, st)
               : by_rows<__nv_bfloat16, 16, false>(a, rc, bps, smem, st);
  return vec ? by_rows<float, 8, true>(a, rc, bps, smem, st)
             : by_rows<float, 16, false>(a, rc, bps, smem, st);
}
