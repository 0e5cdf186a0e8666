// HAT's two attentions, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no HAT.  One launch runs the
// attention of one HAT block (models/hat.py) between its qkv and proj
// linears, with the semantics of ops/hat_attn.py's plain versions:
//   hatattn_sa   a hybrid attention block's (HAB) window attention: 16 x 16
//                windows of the canvas cyclically shifted by s (0 or 8); the
//                window (wr, wc) holds at position (a, b) the token at source
//                pixel ((16 wr + a + s) mod Hp, (16 wc + b + s) mod Wp), and
//                its output goes back there; 256 keys a query, the Swin
//                relative-position bias and, shifted, the -100 mask between
//                positions of different regions of the rolled canvas.
//   hatattn_oca  an overlapping cross-attention block's (OCA): each 16 x 16
//                query window (16 wr + a, 16 wc + b) against the 24 x 24 key
//                window (16 wr - 4 + a', 16 wc - 4 + b') of the same qkv;
//                keys and values outside the canvas are zeros that take part
//                in the softmax (the published nn.Unfold pads k and v with
//                zeros after the linear), no mask.
//   qkv  (B, Hp, Wp, 3 x heads x 32) bf16, each head's q, k and v padded
//        from hd to 32 channels (ops/window_attn.py::pack_qkv's layout)
//   out  (B, Hp, Wp, cout) bf16: head h's hd channels at h hd, channels
//        heads hd .. cout zero (the proj GEMM's 16-byte rows)
//   table  the block's relative-position table (rows, heads) fp32, read
//        through the index computed from the two positions: the Swin index
//        (rows 961) for the HAB, calculate_rpi_oca's (rows 1521; the
//        published index is negative for some pairs and PyTorch's indexing
//        wraps it, so the column is staged rotated by that wrap) for the OCA.
// For each window and head, over tiles of KT keys in order (an online
// softmax; ops/hat_attn.py::_attend is the same arithmetic):
//   q'  = bf16(q * scale)                  scale = hd^-0.5, passed by the caller
//   S   = q' k^T + bias (+ mask)           fp32 sums of the bf16 products
//   m'  = max(m, rowmax S); a = exp(m - m')
//   P   = exp(S - m')                      fp32 (on the SFU: exp_from)
//   l   = a l + rowsum P                   fp32, of the unrounded P
//   O   = a O + bf16(P) v                  fp32 sums
//   out = bf16(O / l)                      one rounding
//
// Bounds, at the 540 x 960 frame's 518,400 tokens, 6 heads of 30: bytes, q, k
// and v read once and the output written once (1,440 B a token): 0.223 ms a
// call; the tensor cores: 4 x 256 x 180 (HAB) or 4 x 576 x 180 (OCA)
// operations a token, 0.097 and 0.217 ms at 989 TFLOP/s; the exponentials,
// one a score (0.80 G and 1.79 G a call), about 0.21 and 0.48 ms at the SFU's
// 16 a clock per SM.  The plain composition materializes 6 x 256 x 256 (HAB)
// or 6 x 256 x 576 (OCA) fp32 scores a window: 3.2 and 7.2 GB a call.
//
// Design: a block of 8 warps per (window, head), the heads of a window in
// consecutive blocks, so that they read the same qkv rows and write the same
// output rows together in L2.  The block stages its head's q (256 rows) and
// k and v (256 or 576 rows; the OCA's rows outside the canvas zero-filled by
// cp.async) once, 64-byte rows swizzled in 16-byte chunks (chunk c of row r
// at c ^ ((r >> 1) & 3)) so that every ldmatrix reads eight rows from eight
// bank groups, and its head's column of the table (3.8 or 5.9 KB; the
// gathered (heads, N, M) bias would be 1.5 or 3.5 MB a layer, read by every
// window).  Shared memory: 52 KB (HAB) or 94 KB (OCA), two blocks an SM, so
// one stages while the other computes.  Warp w takes query rows 32 w .. + 31
// (two m16 tiles, two window rows) and walks the keys in tiles of 32: S on
// mma.sync m16n8k16 for both row tiles from one ldmatrix of k, the bias read
// from shared memory at the index computed from the two positions, the
// online softmax on the fp32 accumulators (a row's scores in the four lanes
// of a quad), bf16(P) repacked into A fragments and O += P v from
// ldmatrix.trans of v.  The output rows leave from registers, 4 bytes a lane.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WS = 16;               // the query window
constexpr int NQ = WS * WS;          // queries a window
constexpr int OWS = 24;              // the OCA's key window (overlap ratio 0.5)
constexpr int OPAD = (OWS - WS) / 2; // its offset: nn.Unfold's padding
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int HS = 32;               // a head's padded width in qkv
constexpr int ROW_B = HS * 2;        // a staged row: 64 bytes
constexpr int KT = 32;               // keys a tile of the online softmax
constexpr float MASK = -100.0f;
constexpr float L2E = 1.4426950408889634f;   // log2(e)

static_assert(NQ == WARPS * 32, "a warp takes two m16 tiles of queries");

// The two attentions' geometry.  Key j of a window at (aj, bj) of a KW-wide
// key window, query i at (ai, bi) of the 16-wide query window; the table row
// read is sgn (u(i) - u(j)) + C, u(p) = P a + b, after staging.
template <bool OCA>
struct Geo {
  static constexpr int KW = OCA ? OWS : WS;             // key window side
  static constexpr int NK = KW * KW;                    // keys a window
  static constexpr int P = OCA ? WS + OWS - 1 : 2 * WS - 1;
  static constexpr int ROWS = P * P;                    // table rows: 1521 or 961
  // Swin (HAB): (ai - aj + 15) 31 + (bi - bj + 15) = u(i) - u(j) + 480
  // OCA: (aj - ai - 7) 39 + (bj - bi - 7) = u(j) - u(i) - 280, from -880 to
  // 640; PyTorch reads a negative row r as ROWS + r, so the column is staged
  // with row t holding the table's row (t - 880) mod ROWS
  static constexpr int SGN = OCA ? -1 : 1;
  static constexpr int C = OCA ? 600 : 480;
  static constexpr int ROT = OCA ? 880 : 0;
  static constexpr int SMEM = (NQ + 2 * NK) * ROW_B + ((ROWS * 4 + 15) / 16) * 16;
  static_assert(NK % KT == 0 && KW % 8 == 0, "key tiles of whole n8 rows");
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// q' = bf16(q * scale) for a pair of staged q values, zero past the head's width
__device__ __forceinline__ uint32_t q_scaled(uint32_t q, float scale, bool in) {
  if (!in) return 0u;
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q));
  return pack2(f.x * scale, f.y * scale);
}

// exp(x - m) as 2^(x log2(e) - m log2(e)) on the SFU: one FFMA and one
// MUFU.EX2 (expf's range reduction would take some eight instructions a
// score, and the SFU's 16 a clock per SM bound the kernel already); its
// relative error, about 1e-6 at the scores' size, is far inside bf16(P)'s
// rounding step
__device__ __forceinline__ float exp_from(float x, float ml2e) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(fmaf(x, L2E, -ml2e)));
  return y;
}

// byte offset of 16-byte chunk c of staged row r
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * ROW_B + ((c ^ ((r >> 1) & 3)) << 4));
}

// region of a rolled coordinate along an axis of n: the published
// calculate_mask's slices (0, -16), (-16, -s), (-s, None)
__device__ __forceinline__ int region(int y, int n, int shift) {
  return y < n - WS ? 0 : (y < n - shift ? 1 : 2);
}

template <bool OCA>
__device__ __forceinline__ void attend(const __nv_bfloat16* __restrict__ qkv,
                                       const float* __restrict__ table,
                                       __nv_bfloat16* __restrict__ out, int Hp, int Wp,
                                       int heads, int hd, int cout, int shift, float scale) {
  using G = Geo<OCA>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sq = sbase, sk = sq + NQ * ROW_B, sv = sk + G::NK * ROW_B;
  float* stab = reinterpret_cast<float*>(smem_raw + (NQ + 2 * G::NK) * ROW_B);

  const int nwc = Wp / WS, nwr = Hp / WS;
  const int h = blockIdx.x % heads;
  const int win = blockIdx.x / heads;
  const int wc = win % nwc;
  const int wr = (win / nwc) % nwr;
  const int img = win / (nwc * nwr);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = 3 * heads * HS;                          // a token's qkv, bf16
  const __nv_bfloat16* base = qkv + (long long)img * Hp * Wp * row;

  // stage q (and, for the HAB, k and v) of the window's 256 tokens
  for (int i = tid; i < NQ * 4; i += THREADS) {
    const int t = i >> 2, c = i & 3;
    const int y = (WS * wr + t / WS + shift) % Hp, x = (WS * wc + t % WS + shift) % Wp;
    const __nv_bfloat16* src = base + ((long long)y * Wp + x) * row + 8 * c;
    cp_async16(sq + swz(t, c), src + h * HS, true);
    if (!OCA) {
      cp_async16(sk + swz(t, c), src + (heads + h) * HS, true);
      cp_async16(sv + swz(t, c), src + (2 * heads + h) * HS, true);
    }
  }
  if (OCA) {
    // k and v of the 24 x 24 key window, zeros outside the canvas
    for (int i = tid; i < G::NK * 4; i += THREADS) {
      const int t = i >> 2, c = i & 3;
      const int y = WS * wr - OPAD + t / OWS, x = WS * wc - OPAD + t % OWS;
      const bool in = y >= 0 && y < Hp && x >= 0 && x < Wp;
      const __nv_bfloat16* src = in ? base + ((long long)y * Wp + x) * row + 8 * c : qkv;
      cp_async16(sk + swz(t, c), src + (in ? (heads + h) * HS : 0), in);
      cp_async16(sv + swz(t, c), src + (in ? (2 * heads + h) * HS : 0), in);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int t = tid; t < G::ROWS; t += THREADS) {
    const int r = t >= G::ROT ? t - G::ROT : t - G::ROT + G::ROWS;
    stab[t] = __ldg(table + (long long)r * heads + h);
  }
  // the output's padding channels, once a token (head 0's blocks)
  const int C = heads * hd;
  if (h == 0 && cout > C) {
    for (int i = tid; i < NQ * (cout - C); i += THREADS) {
      const int t = i / (cout - C);
      const int y = (WS * wr + t / WS + shift) % Hp, x = (WS * wc + t % WS + shift) % Wp;
      out[(((long long)img * Hp + y) * Wp + x) * cout + C + i % (cout - C)] =
          __float2bfloat16(0.f);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const int g = lane >> 2, c = lane & 3;
  // q' fragments of the warp's two row tiles (window rows ai = 2 warp + mt)
  uint32_t qa[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int mi = lane >> 3;
      uint32_t r[4];
      ldsm_x4(r, sq + swz(32 * warp + 16 * mt + (lane & 7) + 8 * (mi & 1), 2 * ks + (mi >> 1)));
      const int d = 16 * ks + 2 * c;
      qa[mt][ks][0] = q_scaled(r[0], scale, d < hd);
      qa[mt][ks][1] = q_scaled(r[1], scale, d < hd);
      qa[mt][ks][2] = q_scaled(r[2], scale, d + 8 < hd);
      qa[mt][ks][3] = q_scaled(r[3], scale, d + 8 < hd);
    }
  }

  // shifted HAB: the regions of the lane's four query rows and of its key
  // columns (rolled canvas coordinates); only windows of the last window
  // row or column straddle two regions, the rest take no mask
  const bool masked = !OCA && shift && (wr == nwr - 1 || wc == nwc - 1);
  int regq[2][2] = {{0, 0}, {0, 0}};
  if (masked) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int rr = 3 * region(WS * wr + 2 * warp + mt, Hp, shift);
      regq[mt][0] = rr + region(WS * wc + g, Wp, shift);
      regq[mt][1] = rr + region(WS * wc + g + 8, Wp, shift);
    }
  }

  float o[2][4][4];
  float m[2][2], l[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) o[mt][nn][0] = o[mt][nn][1] = o[mt][nn][2] = o[mt][nn][3] = 0.f;
  }

  constexpr int NT8 = G::KW / 8;   // n8 tiles a key row
  for (int k0 = 0; k0 < G::NK; k0 += KT) {
    float s[2][4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      uint32_t kb[4];
      ldsm_x4(kb, sk + swz(k0 + 8 * n + (lane & 7), lane >> 3));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
        mma16816(s[mt][n], qa[mt][0], kb[0], kb[1]);
        mma16816(s[mt][n], qa[mt][1], kb[2], kb[3]);
      }
      // + bias (+ mask): key columns j = k0 + 8 n + 2 c + e at (aj, bj)
      const int t8 = (k0 >> 3) + n;
      const int aj = t8 / NT8, bj = 8 * (t8 % NT8) + 2 * c;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int ai = 2 * warp + mt;
        // rows bi = g (e = 0, 1) and g + 8 (e = 2, 3)
        const float* tb = stab + G::C + G::SGN * (G::P * (ai - aj) + g - bj);
        s[mt][n][0] += tb[0];
        s[mt][n][1] += tb[-G::SGN];
        s[mt][n][2] += tb[8 * G::SGN];
        s[mt][n][3] += tb[7 * G::SGN];
        if (masked) {
          const int rk = 3 * region(WS * wr + aj, Hp, shift);
          const int j0 = rk + region(WS * wc + bj, Wp, shift);
          const int j1 = rk + region(WS * wc + bj + 1, Wp, shift);
          s[mt][n][0] += j0 != regq[mt][0] ? MASK : 0.f;
          s[mt][n][1] += j1 != regq[mt][0] ? MASK : 0.f;
          s[mt][n][2] += j0 != regq[mt][1] ? MASK : 0.f;
          s[mt][n][3] += j1 != regq[mt][1] ? MASK : 0.f;
        }
      }
    }

    // the online softmax: each row's max over the tile (a quad's lanes)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        t0 = fmaxf(t0, fmaxf(s[mt][n][0], s[mt][n][1]));
        t1 = fmaxf(t1, fmaxf(s[mt][n][2], s[mt][n][3]));
      }
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, x));
        t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, x));
      }
      const float n0 = fmaxf(m[mt][0], t0), n1 = fmaxf(m[mt][1], t1);
      const float e0 = n0 * L2E, e1 = n1 * L2E;
      const float a0 = exp_from(m[mt][0], e0), a1 = exp_from(m[mt][1], e1);
      m[mt][0] = n0;
      m[mt][1] = n1;
      float p0 = 0.f, p1 = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        s[mt][n][0] = exp_from(s[mt][n][0], e0);
        s[mt][n][1] = exp_from(s[mt][n][1], e0);
        s[mt][n][2] = exp_from(s[mt][n][2], e1);
        s[mt][n][3] = exp_from(s[mt][n][3], e1);
        p0 += s[mt][n][0] + s[mt][n][1];
        p1 += s[mt][n][2] + s[mt][n][3];
      }
      l[mt][0] = l[mt][0] * a0 + p0;
      l[mt][1] = l[mt][1] * a1 + p1;
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        o[mt][nn][0] *= a0;
        o[mt][nn][1] *= a0;
        o[mt][nn][2] *= a1;
        o[mt][nn][3] *= a1;
      }
    }

    // O += bf16(P) v over the tile's two k16 steps
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t vb[2][4];
      const int mi = lane >> 3;
      const int vr = k0 + 16 * kk + (lane & 7) + 8 * (mi & 1);
      ldsm_x4_t(vb[0], sv + swz(vr, mi >> 1));
      ldsm_x4_t(vb[1], sv + swz(vr, 2 + (mi >> 1)));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t pa[4] = {pack2(s[mt][2 * kk][0], s[mt][2 * kk][1]),
                                pack2(s[mt][2 * kk][2], s[mt][2 * kk][3]),
                                pack2(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]),
                                pack2(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3])};
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
          mma16816(o[mt][nn], pa, vb[nn >> 1][2 * (nn & 1)], vb[nn >> 1][2 * (nn & 1) + 1]);
      }
    }
  }

  // out = bf16(O / l) at the queries' source pixels
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    float l0 = l[mt][0], l1 = l[mt][1];
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, x);
      l1 += __shfl_xor_sync(0xffffffffu, l1, x);
    }
    const int y = (WS * wr + 2 * warp + mt + shift) % Hp;
    const int x0 = (WS * wc + g + shift) % Wp, x1 = (WS * wc + g + 8 + shift) % Wp;
    __nv_bfloat16* r0 = out + (((long long)img * Hp + y) * Wp + x0) * cout + h * hd;
    __nv_bfloat16* r1 = out + (((long long)img * Hp + y) * Wp + x1) * cout + h * hd;
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) {
      const int d = 8 * nn + 2 * c;
      if (d < hd) {
        *reinterpret_cast<uint32_t*>(r0 + d) = pack2(o[mt][nn][0] / l0, o[mt][nn][1] / l0);
        *reinterpret_cast<uint32_t*>(r1 + d) = pack2(o[mt][nn][2] / l1, o[mt][nn][3] / l1);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
hatattn_sa(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ table,
           __nv_bfloat16* __restrict__ out, int Hp, int Wp, int heads, int hd, int cout,
           int shift, float scale) {
  attend<false>(qkv, table, out, Hp, Wp, heads, hd, cout, shift, scale);
}

__global__ void __launch_bounds__(THREADS, 2)
hatattn_oca(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ table,
            __nv_bfloat16* __restrict__ out, int Hp, int Wp, int heads, int hd, int cout,
            int shift, float scale) {
  attend<true>(qkv, table, out, Hp, Wp, heads, hd, cout, shift, scale);
}

template <bool OCA>
int launch(const void* qkv, const void* table, void* out, int B, int Hp, int Wp, int heads,
           int hd, int cout, int shift, float scale, cudaStream_t stream) {
  using G = Geo<OCA>;
  // the shared memory allowed once per device
  constexpr int kDevices = 16;
  static bool granted[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kDevices || !granted[dev]) {
    err = cudaFuncSetAttribute(OCA ? hatattn_oca : hatattn_sa,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev < kDevices) granted[dev] = true;
  }
  const long long blocks = (long long)B * (Hp / WS) * (Wp / WS) * heads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  (OCA ? hatattn_oca : hatattn_sa)<<<(unsigned)blocks, THREADS, G::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(table),
      static_cast<__nv_bfloat16*>(out), Hp, Wp, heads, hd, cout, shift, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int Hp, int Wp, int heads, int hd, int cout) {
  return B < 1 || Hp < WS || Wp < WS || Hp % WS || Wp % WS || heads < 1 || hd < 2 || hd % 2 ||
         hd > HS || cout % 2 || cout < heads * hd;
}

}  // namespace

extern "C" {

// qkv (B, Hp, Wp, 3 heads 32) bf16, table (961, heads) fp32, out (B, Hp, Wp,
// cout) bf16; Hp, Wp multiples of 16; hd even, at most 32; cout even, at
// least heads hd; shift 0 or 8; qkv 16-byte aligned (checked by the wrapper,
// ops/hat_attn.py).
int innfer_hat_window_attn(const void* qkv, const void* table, void* out, int B, int Hp, int Wp,
                           int heads, int hd, int cout, int shift, float scale,
                           cudaStream_t stream) {
  if (bad_shape(B, Hp, Wp, heads, hd, cout) || (shift != 0 && shift != WS / 2))
    return (int)cudaErrorInvalidValue;
  return launch<false>(qkv, table, out, B, Hp, Wp, heads, hd, cout, shift, scale, stream);
}

// the OCA: as above, table (1521, heads) fp32, no shift
int innfer_overlap_attn(const void* qkv, const void* table, void* out, int B, int Hp, int Wp,
                        int heads, int hd, int cout, float scale, cudaStream_t stream) {
  if (bad_shape(B, Hp, Wp, heads, hd, cout)) return (int)cudaErrorInvalidValue;
  return launch<true>(qkv, table, out, B, Hp, Wp, heads, hd, cout, 0, scale, stream);
}

const char* innfer_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
