// Block- and warp-level pieces of the tensor-core attention kernels: B13's
// and B14's (csrc/fused_mha.cu) and the whole encoder's (csrc/fused_encoder.cu).
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

}  // namespace tc
}  // namespace tt
