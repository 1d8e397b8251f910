// Block- and warp-level pieces of the tensor-core attention kernels: B13's
// and B14's (csrc/fused_mha.cu), the whole encoder's forward
// (csrc/fused_encoder.cu) and its backward (csrc/fused_encoder_bwd.cu).
//
// A tile is E examples of Hp = round_up(H, 16) rows, bf16 by row in shared
// memory, each row padded by PAD bf16 (16 bytes) so the eight rows an
// ldmatrix reads fall in eight distinct bank groups.  Products run on
// mma.sync m16n8k16 (csrc/mma.cuh), bf16 in, f32 sums.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace tt {
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int PAD = 8;          // bf16 of padding per shared row (16 bytes)
constexpr int TILE_ROWS = 128;  // the most rows a tile holds (ops/fused_mha.py:_TC_ROWS)

// C [rows, N] = A [rows, K] . B [K, N], A and B bf16 in shared memory by
// row (strides sa, sb), K a multiple of 16, rows of 32, N of 8 * NT (NT
// even).  With BNK the shared matrix is B^T [N, K] by row (C = A . Bm^T).
// Each of the block's WARPS warps owns 32 x (8 NT) tiles of C; each k16
// step is added to the f32 sums rounded to nearest (tt::mma_bf16_add);
// epi(r, c, v0, v1) takes the sums at (r, c) and (r, c + 1).
template <int NT, bool BNK = false, int WARPS = 8, class Epi>
__device__ __forceinline__ void warp_gemm(int rows, int N, int K, const bf16* A, int sa,
                                          const bf16* Bm, int sb, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nt = N / (8 * NT);
  for (int item = warp; item < (rows / 32) * nt; item += WARPS) {
    const int r0 = (item / nt) * 32, n0 = (item % nt) * 8 * NT;
    float acc[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;
#pragma unroll 1  // unrolled, the rounded adds' temporaries spill
    for (int k0 = 0; k0 < K; k0 += 16) {
      unsigned a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        tt::ldmatrix_x4<false>(a[i], A + (r0 + 16 * i + lane % 16) * sa + k0 + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        unsigned b[4];
        if constexpr (BNK)
          tt::ldmatrix_x4<false>(
              b, Bm + (n0 + 16 * j + lane % 8 + (lane / 16) * 8) * sb + k0 + ((lane / 8) % 2) * 8);
        else
          tt::ldmatrix_x4<true>(
              b, Bm + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * sb + n0 + 16 * j + (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          tt::mma_bf16_add(acc[i][2 * j], a[i], b[0], b[1]);
          tt::mma_bf16_add(acc[i][2 * j + 1], a[i], b[2], b[3]);
        }
      }
    }
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int r = r0 + 16 * i + g, c = n0 + 8 * j + 2 * t;
        epi(r, c, acc[i][j][0], acc[i][j][1]);
        epi(r + 8, c, acc[i][j][2], acc[i][j][3]);
      }
  }
}

// x rows of tile `tile` (E examples of Hp rows) into X [E*Hp][D+PAD] with
// cp.async by a block of THREADS threads; rows past H and examples past B
// become zeros.
template <int THREADS = 256>
__device__ __forceinline__ void load_x(bf16* X, const bf16* x, int tile, int E, int Hp, int H,
                                       int D, int B) {
  const int cpr = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < E * Hp * cpr; i += THREADS) {
    const int r = i / cpr, c = i - r * cpr;
    const int ex = tile * E + r / Hp, hi = r % Hp;
    const bool ok = ex < B && hi < H;
    tt::cp_async16(X + r * (D + PAD) + c * 8, ok ? x + ((size_t)ex * H + hi) * D + c * 8 : x,
                   ok ? 16 : 0);
  }
}

// The sum of round(e) over one row of a lane quad's S accumulators (row g:
// co = 0, row g + 8: co = 2), in the order of the FMA kernel's softmax: a
// lane per key kj < 32 holds round(e_kj) + round(e_kj+32), then a butterfly
// over the 32 lanes at offsets 16, 8, 4, 2, 1.  Key 8j + 2 q4 + c sits at
// s[j][co + c], so offsets 16 and 8 pair j's of one lane, 4 and 2 pair
// lanes (shuffles), and 1 pairs c.  Padded keys hold e = 0 and add exactly
// nothing, so the result is the FMA kernel's bit for bit.
template <int HPB>
__device__ __forceinline__ float row_den(const float (&s)[2 * HPB][4], int co) {
  float a[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      a[j][c] = j < 2 * HPB ? tt::round_bf16(s[j][co + c]) : 0.0f;
      if (j + 4 < 2 * HPB) a[j][c] += tt::round_bf16(s[j + 4][co + c]);
    }
  float u[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    u[c] = (a[0][c] + a[2][c]) + (a[1][c] + a[3][c]);
    u[c] += __shfl_xor_sync(0xffffffffu, u[c], 2);
    u[c] += __shfl_xor_sync(0xffffffffu, u[c], 1);
  }
  return u[0] + u[1];
}

// One warp's (example, head, band of 16 queries) of a full attention layer.
// QO is the band's q at its head's columns, in a q | k | v tile by row
// (stride sq; K and V the example's first key row of k and v there); hd a
// multiple of 16.  S = Q_h K_h^T [16, Hp] over the head width stays in
// registers, scaled, then -1e30 at keys >= len and -inf at padded keys (>=
// H), so a padded key adds exactly 0 to its row whatever len is; the row
// max and the sum of round(e) are taken across the quad of lanes that
// share a row; p = e / max(den, 1e-30) is rounded and packed from the S
// accumulators straight into the A operand of P.V (the m16n8 C layout is
// the k16 A layout), and round(P.V_h) goes over q at QO: the warp's own rows
// and columns.  probs(pa) sees round(p) as packed: pa[kk] holds keys 16 kk
// .. 16 kk + 15, rows g and g + 8 (g = lane / 4), as the A fragment.
template <int HPB, class Probs>
__device__ __forceinline__ void band_attention(bf16* QO, const bf16* K, const bf16* V, int sq,
                                               int hd, int H, int len, float scale, Probs probs) {
  const int lane = threadIdx.x % 32, g = lane / 4, q4 = lane % 4;
  float s[2 * HPB][4];
#pragma unroll
  for (int j = 0; j < 2 * HPB; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.0f;
  for (int c0 = 0; c0 < hd; c0 += 16) {
    unsigned a[4];
    tt::ldmatrix_x4<false>(a, QO + (lane % 16) * sq + c0 + (lane / 16) * 8);
#pragma unroll
    for (int jp = 0; jp < HPB; ++jp) {
      unsigned b[4];  // K_h [key][c] by row is B = K_h^T in the col layout
      tt::ldmatrix_x4<false>(
          b, K + (jp * 16 + lane % 8 + (lane / 16) * 8) * sq + c0 + ((lane / 8) % 2) * 8);
      tt::mma_bf16(s[2 * jp], a, b[0], b[1]);
      tt::mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
    }
  }
  // rows g (s[.][0..1]) and g + 8 (s[.][2..3]); keys 8j + 2q4 + {0, 1}.
  // A key >= len scores -1e30 as in the FMA kernel; a padded key (>= H)
  // -inf, so it adds exactly 0 to the row whatever len is.
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 2 * HPB; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = 8 * j + 2 * q4 + (c & 1);
      s[j][c] = key >= H ? -INFINITY : key < len ? s[j][c] * scale : -1e30f;
      if (c < 2) m0 = fmaxf(m0, s[j][c]);
      else m1 = fmaxf(m1, s[j][c]);
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
#pragma unroll
  for (int j = 0; j < 2 * HPB; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = expf(s[j][c] - (c < 2 ? m0 : m1));
  const float d0 = fmaxf(row_den<HPB>(s, 0), 1e-30f);
  const float d1 = fmaxf(row_den<HPB>(s, 2), 1e-30f);
  // p = e / den.  A masked key's e is 0, and IEEE division takes its slow
  // path for a 0 numerator: a lane with e = 0 skips the division and
  // takes 0, the same value.  Dividing 1 there and selecting 0 made B13
  // with lengths a third slower on an H100; the branch costs about 5%
  // without lengths
  auto pdiv = [](float e, float den) { return e == 0.0f ? 0.0f : e / den; };
  unsigned pa[HPB][4];  // round(p) as the A operand of P.V, key band kk
#pragma unroll
  for (int kk = 0; kk < HPB; ++kk) {
    pa[kk][0] = tt::pack_bf16x2(pdiv(s[2 * kk][0], d0), pdiv(s[2 * kk][1], d0));
    pa[kk][1] = tt::pack_bf16x2(pdiv(s[2 * kk][2], d1), pdiv(s[2 * kk][3], d1));
    pa[kk][2] = tt::pack_bf16x2(pdiv(s[2 * kk + 1][0], d0), pdiv(s[2 * kk + 1][1], d0));
    pa[kk][3] = tt::pack_bf16x2(pdiv(s[2 * kk + 1][2], d1), pdiv(s[2 * kk + 1][3], d1));
  }
  probs(pa);
  for (int c0 = 0; c0 < hd; c0 += 16) {
    float o[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int kk = 0; kk < HPB; ++kk) {
      unsigned b[4];  // V_h [key][c] by row: B [K][N], transposed on load
      tt::ldmatrix_x4<true>(
          b, V + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * sq + c0 + (lane / 16) * 8);
      tt::mma_bf16(o[0], pa[kk], b[0], b[1]);
      tt::mma_bf16(o[1], pa[kk], b[2], b[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      *(unsigned*)(QO + g * sq + c0 + 8 * j + 2 * q4) = tt::pack_bf16x2(o[j][0], o[j][1]);
      *(unsigned*)(QO + (g + 8) * sq + c0 + 8 * j + 2 * q4) = tt::pack_bf16x2(o[j][2], o[j][3]);
    }
  }
}

// Rows < H of the tile's examples < B, from a tile [E*Hp][D+PAD] in shared
// memory to dst [B, H, D] in device memory, 16 bytes a store.
template <int THREADS>
__device__ __forceinline__ void store_rows(bf16* dst, const bf16* X, int tile, int E, int Hp,
                                           int H, int D, int B) {
  const int cpr = D / 8;
  for (int i = threadIdx.x; i < E * Hp * cpr; i += THREADS) {
    const int r = i / cpr, c = i - r * cpr;
    const int ex = tile * E + r / Hp, hi = r % Hp;
    if (ex < B && hi < H)
      *(uint4*)(dst + ((size_t)ex * H + hi) * D + c * 8) = *(const uint4*)(X + r * (D + PAD) + c * 8);
  }
}

// ---- the recompute backward of an attention layer: B14, B6 and B9 ----------

// The sum over one row of a lane quad's values f(j, c) (c = 0, 1: the
// row's two columns of n-tile j) in row_den's order, so in the FMA
// kernel's: a lane per key kj < 32 holds f at kj and kj + 32, then a
// butterfly over the 32 lanes at offsets 16, 8, 4, 2, 1.
template <int HPB, class F>
__device__ __forceinline__ float row_sum(F f) {
  float a[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      a[j][c] = j < 2 * HPB ? f(j, c) : 0.0f;
      if (j + 4 < 2 * HPB) a[j][c] += f(j + 4, c);
    }
  float u[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    u[c] = (a[0][c] + a[2][c]) + (a[1][c] + a[3][c]);
    u[c] += __shfl_xor_sync(0xffffffffu, u[c], 2);
    u[c] += __shfl_xor_sync(0xffffffffu, u[c], 1);
  }
  return u[0] + u[1];
}

// The two m16n8 accumulators of a 16 x 16 product, rounded to bf16, at dst
// (row stride ld): rows g and g + 8, columns 8j + 2q4 and the next.
__device__ __forceinline__ void store_c16(bf16* dst, int ld, const float (&o)[2][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, q4 = lane % 4;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    *(unsigned*)(dst + g * ld + 8 * j + 2 * q4) = tt::pack_bf16x2(o[j][0], o[j][1]);
    *(unsigned*)(dst + (g + 8) * ld + 8 * j + 2 * q4) = tt::pack_bf16x2(o[j][2], o[j][3]);
  }
}

// acc [16, 8 NTT] += A[0 : rows, m0 : m0 + 16]^T . Bm[0 : rows, n0 : n0 + 8 NTT],
// A and Bm bf16 by row in shared memory (strides sa, sb), rows a multiple
// of 16: a sum over rows, so A^T is read through ldmatrix.trans.  Each k16
// step (16 rows) is summed on its own and added rounded (tt::mma_bf16_add).
template <int NTT>
__device__ __forceinline__ void warp_gemm_tn(float (&acc)[NTT][4], int rows, const bf16* A,
                                             int sa, int m0, const bf16* Bm, int sb, int n0) {
  const int lane = threadIdx.x % 32;
#pragma unroll 1
  for (int k0 = 0; k0 < rows; k0 += 16) {
    unsigned a[4];  // a0 (m 0-7, k 0-7), a1 (m 8-15, k 0-7), a2 (m 0-7, k 8-15), a3
    tt::ldmatrix_x4<true>(a, A + (k0 + lane % 8 + (lane / 16) * 8) * sa + m0 + ((lane / 8) % 2) * 8);
    const bf16* brow = Bm + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * sb + n0;
#pragma unroll
    for (int j = 0; j + 1 < NTT; j += 2) {
      unsigned b[4];
      tt::ldmatrix_x4<true>(b, brow + 8 * j + (lane / 16) * 8);
      tt::mma_bf16_add(acc[j], a, b[0], b[1]);
      tt::mma_bf16_add(acc[j + 1], a, b[2], b[3]);
    }
    if constexpr (NTT % 2 == 1) {
      unsigned b[2];
      tt::ldmatrix_x2<true>(b, brow + 8 * (NTT - 1));
      tt::mma_bf16_add(acc[NTT - 1], a, b[0], b[1]);
    }
  }
}

// A backward tile's two projections on eight warps: q | k | v = round(X
// round(W_in) + b_in) into QKV [rows][sq], and do = round(G round(W_out)^T)
// into DO (G, DO and X by row of stride sx).  NTG: the warp tile width / 8
// of the D-wide product.
template <int NTG>
__device__ __forceinline__ void qkv_and_do(int rows, int D, const bf16* X, int sx, const bf16* Wi,
                                           int swi, const float* bi, bf16* QKV, int sq,
                                           const bf16* G, const bf16* Wo, int swo, bf16* DO) {
  warp_gemm<4>(rows, 3 * D, D, X, sx, Wi, swi, [&](int r, int c, float v0, float v1) {
    *(unsigned*)(QKV + r * sq + c) = tt::pack_bf16x2(v0 + bi[c], v1 + bi[c + 1]);
  });
  warp_gemm<NTG, true>(rows, D, D, G, sx, Wo, swo, [&](int r, int c, float v0, float v1) {
    *(unsigned*)(DO + r * sx + c) = tt::pack_bf16x2(v0, v1);
  });
}

// The probabilities of one band of 16 queries (Q: the band's first row of
// q at its head's columns, K the example's first key row of k there, both
// of row stride sq; hd a multiple of 16), as mha_fwd_tc_kernel computes
// them: S = Q_h K_h^T in registers, scaled, -1e30 at keys >= len and -inf
// at padded keys (>= H), the row max and the sum of round(e) over the quad
// of lanes that share a row, p = e / max(den, 1e-30) in f32 into s (keys
// 8j + 2 q4 + {0, 1} of rows g, g + 8 at s[j][0..1], s[j][2..3]).
template <int HPB>
__device__ __forceinline__ void band_probs(float (&s)[2 * HPB][4], const bf16* Q, const bf16* K,
                                           int sq, int hd, int H, int len, float scale) {
  const int lane = threadIdx.x % 32, q4 = lane % 4;
#pragma unroll
  for (int j = 0; j < 2 * HPB; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.0f;
  for (int c0 = 0; c0 < hd; c0 += 16) {
    unsigned a[4];
    tt::ldmatrix_x4<false>(a, Q + (lane % 16) * sq + c0 + (lane / 16) * 8);
#pragma unroll
    for (int jp = 0; jp < HPB; ++jp) {
      unsigned b[4];
      tt::ldmatrix_x4<false>(
          b, K + (jp * 16 + lane % 8 + (lane / 16) * 8) * sq + c0 + ((lane / 8) % 2) * 8);
      tt::mma_bf16(s[2 * jp], a, b[0], b[1]);
      tt::mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
    }
  }
  float m0r = -INFINITY, m1r = -INFINITY;
#pragma unroll
  for (int j = 0; j < 2 * HPB; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = 8 * j + 2 * q4 + (c & 1);
      s[j][c] = key >= H ? -INFINITY : key < len ? s[j][c] * scale : -1e30f;
      if (c < 2) m0r = fmaxf(m0r, s[j][c]);
      else m1r = fmaxf(m1r, s[j][c]);
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0r = fmaxf(m0r, __shfl_xor_sync(0xffffffffu, m0r, off));
    m1r = fmaxf(m1r, __shfl_xor_sync(0xffffffffu, m1r, off));
  }
#pragma unroll
  for (int j = 0; j < 2 * HPB; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = expf(s[j][c] - (c < 2 ? m0r : m1r));
  const float d0 = fmaxf(row_den<HPB>(s, 0), 1e-30f);
  const float d1 = fmaxf(row_den<HPB>(s, 2), 1e-30f);
#pragma unroll
  for (int j = 0; j < 2 * HPB; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float ev = s[j][c];  // a masked key's e is 0: skip the slow division
      s[j][c] = ev == 0.0f ? 0.0f : ev / (c < 2 ? d0 : d1);
    }
}

// round(p) from s, packed as P.V's A operand (pa[kk]: keys 16 kk .. 16 kk +
// 15), and, when P is not null, into the band's rows of a slab P (stride sp)
// for the products with P^T.
template <int HPB>
__device__ __forceinline__ void pack_probs(unsigned (&pa)[HPB][4], const float (&s)[2 * HPB][4],
                                           bf16* P, int sp) {
  const int lane = threadIdx.x % 32, g = lane / 4, q4 = lane % 4;
#pragma unroll
  for (int kk = 0; kk < HPB; ++kk) {
    pa[kk][0] = tt::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
    pa[kk][1] = tt::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
    pa[kk][2] = tt::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[kk][3] = tt::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    if (P) {
      bf16* pr = P + g * sp + 16 * kk + 2 * q4;
      *(unsigned*)pr = pa[kk][0];
      *(unsigned*)(pr + 8 * sp) = pa[kk][1];
      *(unsigned*)(pr + 8) = pa[kk][2];
      *(unsigned*)(pr + 8 * sp + 8) = pa[kk][3];
    }
  }
}

// The band's softmax backward, from p (s, f32) and round(p) (pa):
// out = round(P.V_h) over O (stride so), dp = do_h V_h^T in f32 (DOq: the
// band's first row of do at the head's columns, stride sd), pdp = the row
// sums of round(dp p) (row_sum's order), and ds = round(p (dp - pdp) scale)
// into the band's rows of the slab Sq (stride sp).  V is the example's
// first key row of v (stride sq).
template <int HPB>
__device__ __forceinline__ void band_bwd(const float (&s)[2 * HPB][4], const unsigned (&pa)[HPB][4],
                                         const bf16* V, int sq, const bf16* DOq, int sd, bf16* O,
                                         int so, bf16* Sq, int sp, int hd, float scale) {
  const int lane = threadIdx.x % 32, gq = lane / 4, q4 = lane % 4;
  for (int c0 = 0; c0 < hd; c0 += 16) {
    float o[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int kk = 0; kk < HPB; ++kk) {
      unsigned b[4];
      tt::ldmatrix_x4<true>(
          b, V + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * sq + c0 + (lane / 16) * 8);
      tt::mma_bf16(o[0], pa[kk], b[0], b[1]);
      tt::mma_bf16(o[1], pa[kk], b[2], b[3]);
    }
    store_c16(O + c0, so, o);
  }
  float dp[2 * HPB][4];
#pragma unroll
  for (int j = 0; j < 2 * HPB; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dp[j][c] = 0.0f;
  for (int c0 = 0; c0 < hd; c0 += 16) {
    unsigned a[4];
    tt::ldmatrix_x4<false>(a, DOq + (lane % 16) * sd + c0 + (lane / 16) * 8);
#pragma unroll
    for (int jp = 0; jp < HPB; ++jp) {
      unsigned b[4];
      tt::ldmatrix_x4<false>(
          b, V + (jp * 16 + lane % 8 + (lane / 16) * 8) * sq + c0 + ((lane / 8) % 2) * 8);
      tt::mma_bf16(dp[2 * jp], a, b[0], b[1]);
      tt::mma_bf16(dp[2 * jp + 1], a, b[2], b[3]);
    }
  }
  const float r0 = row_sum<HPB>([&](int j, int c) { return tt::round_bf16(dp[j][c] * s[j][c]); });
  const float r1 = row_sum<HPB>(
      [&](int j, int c) { return tt::round_bf16(dp[j][2 + c] * s[j][2 + c]); });
#pragma unroll
  for (int j = 0; j < 2 * HPB; ++j) {
    bf16* sr = Sq + gq * sp + 8 * j + 2 * q4;
    *(unsigned*)sr = tt::pack_bf16x2(s[j][0] * (dp[j][0] - r0) * scale,
                                    s[j][1] * (dp[j][1] - r0) * scale);
    *(unsigned*)(sr + 8 * sp) = tt::pack_bf16x2(s[j][2] * (dp[j][2] - r1) * scale,
                                               s[j][3] * (dp[j][3] - r1) * scale);
  }
}

// One (example, head)'s products from the warp's slabs of round(p) (Ps)
// and ds (Ss), [Hp][sp] each, over its query bands qb < NQB (the rest of
// both slabs is not read): dv_h = round(round(P)^T do_h) over v's columns
// (v is dead), then after_dv() (the slab Ps is free from there), dk_h =
// round(dS^T Q_h) over do_h (dead once dv is taken), dq_h = round(dS K_h)
// over q's columns, zeros at bands >= NQB (q is dead once dk is taken), and
// dk over k's columns.  P^T and dS^T through ldmatrix.trans; each head's
// columns are the warp's own, so no block barrier between heads.
template <int HPB, int NQB, class AfterDv>
__device__ __forceinline__ void head_grads(const bf16* Ps, const bf16* Ss, int sp, bf16* Qh,
                                           bf16* Kh, bf16* Vh, int sq, bf16* Dh, int sd, int hd,
                                           AfterDv after_dv) {
  const int lane = threadIdx.x % 32;
  __syncwarp();
  for (int kb = 0; kb < HPB; ++kb)
    for (int c0 = 0; c0 < hd; c0 += 16) {
      float o[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int qb = 0; qb < NQB; ++qb) {
        unsigned a[4], b[4];
        tt::ldmatrix_x4<true>(
            a, Ps + (qb * 16 + lane % 8 + (lane / 16) * 8) * sp + kb * 16 + ((lane / 8) % 2) * 8);
        tt::ldmatrix_x4<true>(
            b, Dh + (qb * 16 + lane % 8 + ((lane / 8) % 2) * 8) * sd + c0 + (lane / 16) * 8);
        tt::mma_bf16(o[0], a, b[0], b[1]);
        tt::mma_bf16(o[1], a, b[2], b[3]);
      }
      store_c16(Vh + kb * 16 * sq + c0, sq, o);
    }
  __syncwarp();
  after_dv();
  for (int kb = 0; kb < HPB; ++kb)
    for (int c0 = 0; c0 < hd; c0 += 16) {
      float o[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int qb = 0; qb < NQB; ++qb) {
        unsigned a[4], b[4];
        tt::ldmatrix_x4<true>(
            a, Ss + (qb * 16 + lane % 8 + (lane / 16) * 8) * sp + kb * 16 + ((lane / 8) % 2) * 8);
        tt::ldmatrix_x4<true>(
            b, Qh + (qb * 16 + lane % 8 + ((lane / 8) % 2) * 8) * sq + c0 + (lane / 16) * 8);
        tt::mma_bf16(o[0], a, b[0], b[1]);
        tt::mma_bf16(o[1], a, b[2], b[3]);
      }
      store_c16(Dh + kb * 16 * sd + c0, sd, o);
    }
  __syncwarp();
  for (int qb = 0; qb < HPB; ++qb)
    for (int c0 = 0; c0 < hd; c0 += 16) {
      float o[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      if (qb < NQB) {
#pragma unroll
        for (int kk = 0; kk < HPB; ++kk) {
          unsigned a[4], b[4];
          tt::ldmatrix_x4<false>(a, Ss + (qb * 16 + lane % 16) * sp + kk * 16 + (lane / 16) * 8);
          tt::ldmatrix_x4<true>(
              b, Kh + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * sq + c0 + (lane / 16) * 8);
          tt::mma_bf16(o[0], a, b[0], b[1]);
          tt::mma_bf16(o[1], a, b[2], b[3]);
        }
      }
      store_c16(Qh + qb * 16 * sq + c0, sq, o);
    }
  __syncwarp();
  for (int i = lane; i < 16 * HPB * hd / 8; i += 32) {
    const int r = i / (hd / 8), c = 8 * (i - r * (hd / 8));
    *(uint4*)(Kh + r * sq + c) = *(const uint4*)(Dh + r * sd + c);
  }
  __syncwarp();  // the slabs are free for this warp's next (example, head)
}

// The sum of a bf16 column (stride ld) over rows (a multiple of 4), four
// running sums over every fourth row, added pairwise at the end.
__device__ __forceinline__ float col_sum(const bf16* col, int ld, int rows) {
  float c4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int r = 0; r < rows; r += 4)
#pragma unroll
    for (int i = 0; i < 4; ++i) c4[i] += __bfloat162float(col[(r + i) * ld]);
  return (c4[0] + c4[1]) + (c4[2] + c4[3]);
}

// A warp's slice of a weight grad, acc [16, 8 NTT] at rows m0 .. m0 + 15 and
// columns n0 .., to dst (row stride ld) in f32; with ADD added to what dst
// holds (the warp's own slice, so no other warp touches it).
template <int NTT, bool ADD = false>
__device__ __forceinline__ void store_slice(float* dst, int ld, const float (&acc)[NTT][4], int m0,
                                            int n0) {
  const int lane = threadIdx.x % 32, g = lane / 4, q4 = lane % 4;
#pragma unroll
  for (int j = 0; j < NTT; ++j) {
    float2* p = (float2*)(dst + (m0 + g) * ld + n0 + 8 * j + 2 * q4);
    float2* p8 = (float2*)((float*)p + 8 * ld);
    float2 u = make_float2(acc[j][0], acc[j][1]), w = make_float2(acc[j][2], acc[j][3]);
    if (ADD) {
      u = make_float2(p->x + u.x, p->y + u.y);
      w = make_float2(p8->x + w.x, p8->y + w.y);
    }
    *p = u;
    *p8 = w;
  }
}

}  // namespace tc
}  // namespace tt
