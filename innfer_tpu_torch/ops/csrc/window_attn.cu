// SwinIR's shifted-window attention, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no SwinIR.  One launch runs
// the attention of one Swin transformer layer (models/swinir.py) between its
// qkv and proj linears, for an 8 x 8 window, with the semantics of
// ops/window_attn.py::window_attn_reference:
//   qkv  (B, Hp, Wp, 3 x heads x 32) bf16, the qkv projection in image layout,
//        each head's q, k and v padded from hd to 32 channels (q of head h at
//        32 h, k at 32 (heads + h), v at 32 (2 heads + h)), the padding zero
//   out  (B, Hp, Wp, cout) bf16: head h's hd channels at h hd, cout >= C =
//        heads hd, channels C .. cout zero (the proj GEMM's 16-byte rows)
//   window (wr, wc) of a layer shifted by s holds at position (a, b) the token
//   at source pixel ((8 wr + a + s) mod Hp, (8 wc + b + s) mod Wp), and its
//   output is written back there: the roll, the partition, the reverse and the
//   roll back of the published module cost no copy.
//   q'  = bf16(q * scale)        scale = hd^-0.5, passed by the caller
//   S   = q' k^T + bias[h] + M   fp32; bias (heads, 64, 64) fp32; M = -100
//                                between positions of different regions of
//                                the rolled canvas (rows and columns cut at
//                                Hp - 8 and Hp - s), else 0 (s > 0 only)
//   P   = bf16(softmax(S))       in fp32, rounded once
//   O   = bf16(P v)              fp32 sums, rounded once
//
// Bound: bytes.  A token's q, k and v are read once (6 C bytes) and its
// output written once (2 C): 1,440 B a token at C = 180, against 4 x 64 x C
// multiply-adds (46,080 operations at C = 180, 32 per byte, far below the
// H100's ridge).  A 544 x 960 canvas moves 752 MB a layer: 0.224 ms at
// 3.35 TB/s (the padded layout moves 6.5% more: 1,152 B of qkv and 368 B
// out a token).  The plain composition materializes the rolled copy, the
// windows, 6 x 64 x 64 fp32 scores a window (802 MB a layer), the softmax
// and the reversed copy.
//
// Design: one block of 8 warps per window.  The window's 64 qkv rows (each
// 192 heads bytes) are staged in shared memory once with 16-byte cp.async
// copies, a warp a row at a time, so each row is read whole and in order;
// the staged rows are 16 bytes longer, so a fragment's eight rows fall in
// eight bank groups.  Warp w takes rows 16 (w % 4) .. + 15 of heads w / 4,
// w / 4 + 2, ...: per head S = q' k^T on mma.sync m16n8k16 (the head width
// padded to 32: two k-steps, the padding's q and k zeroed in registers), the
// bias and mask added and the softmax taken on the fp32 accumulators (a
// row's 64 scores live in the four lanes of a quad), P repacked from the
// accumulators into bf16 A fragments, and O = P v on four n8 tiles.  Each
// head's output goes to a shared staging tile; the window's 64 output rows
// leave in whole 8-byte pieces.  Shared memory: 96 KB at 6 heads and cout
// 184, so two blocks share an SM and one stages while the other computes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIN = 8;
constexpr int N = WIN * WIN;       // tokens a window
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int HEAD_LANES = WARPS / 4;   // heads in flight: four warps of 16 rows each
constexpr int HS = 32;             // a head's padded width in qkv
constexpr int SKEW = 8;            // bf16 added to each staged row
constexpr int SMEM_MAX = 232448;   // an H100 block's opt-in shared memory
constexpr float MASK = -100.0f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack2h(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// q' = bf16(q * scale) for a pair of q values, zero past the head's width
__device__ __forceinline__ uint32_t q_scaled(const __nv_bfloat16* p, float scale, bool in) {
  if (!in) return 0u;
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return pack2(f.x * scale, f.y * scale);
}

// region of a rolled coordinate along an axis of n: the published
// calculate_mask's slices (0, -8), (-8, -s), (-s, None)
__device__ __forceinline__ int region(int y, int n, int shift) {
  return y < n - WIN ? 0 : (y < n - shift ? 1 : 2);
}

__global__ void __launch_bounds__(THREADS, 2)
winattn_fwd(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ bias,
            __nv_bfloat16* __restrict__ out, int Hp, int Wp, int heads, int hd, int cout,
            int shift, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int row = 3 * heads * HS;                // a token's qkv, bf16
  const int srow = row + SKEW;                   // its staged row
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [64][srow]
  __nv_bfloat16* so = sq + N * srow;                                 // [64][cout]

  const int nwc = Wp / WIN, nwr = Hp / WIN;
  const int wc = blockIdx.x % nwc;
  const int wr = (blockIdx.x / nwc) % nwr;
  const int img = blockIdx.x / (nwc * nwr);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = heads * hd;

  // stage the window's qkv rows: warp per row, 16-byte pieces along it
  const int pieces = row / 8;
  for (int t = warp; t < N; t += WARPS) {
    const int y = (WIN * wr + (t >> 3) + shift) % Hp;
    const int x = (WIN * wc + (t & 7) + shift) % Wp;
    const __nv_bfloat16* src = qkv + (((long long)img * Hp + y) * Wp + x) * row;
    __nv_bfloat16* dst = sq + t * srow;
    for (int p = lane; p < pieces; p += 32) cp_async16(dst + 8 * p, src + 8 * p);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = threadIdx.x; i < N * (cout - C); i += THREADS)
    so[(i / (cout - C)) * cout + C + i % (cout - C)] = __float2bfloat16(0.f);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const int g = lane >> 2, c = lane & 3;
  const int rt = warp & 3;
  const int r0 = 16 * rt + g, r1 = r0 + 8;     // this lane's two query rows
  // regions of the two rows (a = r >> 3, b = g) and of the key columns
  // j = 8 n + 2 c + e (a = n, b = 2 c + e)
  int reg0 = 0, reg1 = 0, rcol0 = 0, rcol1 = 0;
  if (shift) {
    const int xg = region(WIN * wc + g, Wp, shift);
    reg0 = 3 * region(WIN * wr + 2 * rt, Hp, shift) + xg;
    reg1 = 3 * region(WIN * wr + 2 * rt + 1, Hp, shift) + xg;
    rcol0 = region(WIN * wc + 2 * c, Wp, shift);
    rcol1 = region(WIN * wc + 2 * c + 1, Wp, shift);
  }

  for (int h = warp >> 2; h < heads; h += HEAD_LANES) {
    const __nv_bfloat16* qh = sq + h * HS;
    const __nv_bfloat16* kh = sq + (heads + h) * HS;
    const __nv_bfloat16* vh = sq + (2 * heads + h) * HS;

    // q' fragments, two k-steps over the padded width of 32
    uint32_t qa[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int d = 16 * ks + 2 * c;
      qa[ks][0] = q_scaled(qh + r0 * srow + d, scale, d < hd);
      qa[ks][1] = q_scaled(qh + r1 * srow + d, scale, d < hd);
      qa[ks][2] = q_scaled(qh + r0 * srow + d + 8, scale, d + 8 < hd);
      qa[ks][3] = q_scaled(qh + r1 * srow + d + 8, scale, d + 8 < hd);
    }

    // S = q' k^T: eight n8 tiles of key tokens
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = kh + (8 * n + g) * srow;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int d = 16 * ks + 2 * c;
        const uint32_t b0 = d < hd ? ld32(kr + d) : 0u;
        const uint32_t b1 = d + 8 < hd ? ld32(kr + d + 8) : 0u;
        mma16816(s[n], qa[ks][0], qa[ks][1], qa[ks][2], qa[ks][3], b0, b1);
      }
    }

    // + bias, + mask, softmax over each row's 64 scores (a quad's lanes)
    const float* bh = bias + (long long)h * N * N;
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 b0 = __ldg(reinterpret_cast<const float2*>(bh + r0 * N + 8 * n + 2 * c));
      const float2 b1 = __ldg(reinterpret_cast<const float2*>(bh + r1 * N + 8 * n + 2 * c));
      s[n][0] += b0.x;
      s[n][1] += b0.y;
      s[n][2] += b1.x;
      s[n][3] += b1.y;
      if (shift) {
        const int rown = 3 * region(WIN * wr + n, Hp, shift);
        const int j0 = rown + rcol0, j1 = rown + rcol1;
        s[n][0] += j0 != reg0 ? MASK : 0.f;
        s[n][1] += j1 != reg0 ? MASK : 0.f;
        s[n][2] += j0 != reg1 ? MASK : 0.f;
        s[n][3] += j1 != reg1 ? MASK : 0.f;
      }
      m0 = fmaxf(m0, fmaxf(s[n][0], s[n][1]));
      m1 = fmaxf(m1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = expf(s[n][0] - m0);
      s[n][1] = expf(s[n][1] - m0);
      s[n][2] = expf(s[n][2] - m1);
      s[n][3] = expf(s[n][3] - m1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }

    // O = P v: P's bf16 A fragments from the score tiles, four n8 tiles of v
    float o[4][4];
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) o[nn][0] = o[nn][1] = o[nn][2] = o[nn][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a0 = pack2(s[2 * kk][0] / l0, s[2 * kk][1] / l0);
      const uint32_t a1 = pack2(s[2 * kk][2] / l1, s[2 * kk][3] / l1);
      const uint32_t a2 = pack2(s[2 * kk + 1][0] / l0, s[2 * kk + 1][1] / l0);
      const uint32_t a3 = pack2(s[2 * kk + 1][2] / l1, s[2 * kk + 1][3] / l1);
      const __nv_bfloat16* v0 = vh + (16 * kk + 2 * c) * srow + g;
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        const __nv_bfloat16* vp = v0 + 8 * nn;   // past hd: zero, and discarded
        const uint32_t b0 = pack2h(vp[0], vp[srow]);
        const uint32_t b1 = pack2h(vp[8 * srow], vp[9 * srow]);
        mma16816(o[nn], a0, a1, a2, a3, b0, b1);
      }
    }
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) {
      const int d = 8 * nn + 2 * c;
      if (d < hd) {
        *reinterpret_cast<uint32_t*>(so + r0 * cout + h * hd + d) = pack2(o[nn][0], o[nn][1]);
        *reinterpret_cast<uint32_t*>(so + r1 * cout + h * hd + d) = pack2(o[nn][2], o[nn][3]);
      }
    }
  }
  __syncthreads();

  // the window's output rows back to their source pixels, whole
  const int opieces = cout / 4;
  for (int t = warp; t < N; t += WARPS) {
    const int y = (WIN * wr + (t >> 3) + shift) % Hp;
    const int x = (WIN * wc + (t & 7) + shift) % Wp;
    uint2* dst = reinterpret_cast<uint2*>(out + (((long long)img * Hp + y) * Wp + x) * cout);
    const uint2* src = reinterpret_cast<const uint2*>(so + t * cout);
    for (int p = lane; p < opieces; p += 32) dst[p] = src[p];
  }
}

size_t smem_bytes(int heads, int cout) {
  return (size_t)N * (3 * heads * HS + SKEW + cout) * sizeof(__nv_bfloat16);
}

}  // namespace

extern "C" {

// qkv (B, Hp, Wp, 3 heads 32) bf16, bias (heads, 64, 64) fp32, out (B, Hp,
// Wp, cout) bf16; Hp, Wp multiples of 8; hd even, at most 32; cout % 4 ==
// 0, heads hd <= cout; shift 0 or 4; qkv 16-byte and out 8-byte aligned
// (checked by the wrapper, ops/window_attn.py).
int innfer_window_attn(const void* qkv, const void* bias, void* out, int B, int Hp, int Wp,
                       int heads, int hd, int cout, int shift, float scale, cudaStream_t stream) {
  if (B < 1 || Hp < WIN || Wp < WIN || Hp % WIN || Wp % WIN || heads < 1 || hd < 2 || hd % 2 ||
      hd > HS || cout % 4 || cout < heads * hd || (shift != 0 && shift != WIN / 2) ||
      smem_bytes(heads, cout) > (size_t)SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  // the largest staging allowed once per device
  constexpr int kDevices = 16;
  static bool granted[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kDevices || !granted[dev]) {
    err = cudaFuncSetAttribute(winattn_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    if (dev < kDevices) granted[dev] = true;
  }
  const long long blocks = (long long)B * (Hp / WIN) * (Wp / WIN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  winattn_fwd<<<(unsigned)blocks, THREADS, smem_bytes(heads, cout), stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), Hp, Wp, heads, hd, cout, shift, scale);
  return (int)cudaGetLastError();
}

const char* innfer_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
