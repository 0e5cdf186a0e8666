// The 3x3 convolution core shared by rdb.cu and resnet_block.cu.
//
// Two conv kernels, chosen by the activation dtype (a documented design,
// not a fallback: a gated bf16 conv always takes the tensor cores):
//   * bf16: conv_wgmma, an implicit GEMM on Hopper's warpgroup MMA
//     (wgmma, sm_90a), bf16 operands and fp32 accumulators in registers;
//   * fp32: conv_ffma, a direct conv on the FP32 pipes.  fp32 is the
//     parity path: Hopper has no true-fp32 MMA, and TF32 (about three
//     decimal digits) would miss the parity bars.
// Both are templated on a padding policy (ZeroPad | ReflectPad) and an
// epilogue functor, and both read one packed weight layout.
//
// conv_wgmma.  The GEMM is M = output pixels, N = output channels, K =
// 9 taps x cin.  A block owns a tile of TH output rows x 64 columns and
// ALL of one N tile's output channels (up to 256), so each input pixel's
// halo is staged once per tile, not once per channel group.  Each m64 tile
// of a warpgroup is one output row of 64 consecutive pixels.  The halo
// (TH + 2 rows x 66 pixels x 16 channels) lies in shared memory as two
// 8-channel planes of 16-byte pixels, so 8 consecutive pixels form one
// wgmma core matrix (8 rows x 16 bytes, no swizzle): the A operand of tap
// (dy, dx) for output row r is the same halo at pixel offset
// (r + dy) * 66 + dx -- a descriptor offset, with no im2col buffer.  The
// weights of one 16-channel chunk, all 9 taps, are staged beside it in the
// layout the B descriptor reads (pack_conv3x3 writes it that way in device
// memory, so staging is a straight copy).  Staging is cp.async into a ring
// of STAGES buffers: with three, the copy of chunk k + 1 and the wgmmas of
// chunk k - 1 are in flight while chunk k's wgmmas are issued; with two
// (N = 256, whose 72 KB of weights per chunk leave room for no third),
// the copy of chunk k + 1 runs under chunk k's wgmmas.  Two blocks share
// an SM below N = 256.  cp.async takes per-pixel source addresses,
// so zero padding (16-byte zero fill) and reflect padding (reflected
// indices) cost nothing extra; TMA's tiled mode could only zero-fill.
// Channels past cin are zero-filled, so any cin % 8 == 0 works.  The
// epilogue reads the accumulator fragment (thread t of warp w holds rows
// 16w + t/4 (+8) and column pairs 8i + 2(t%4)), adds the fp32 bias and
// hands pairs of channels to the functor; ragged rows, columns and
// channels are masked there.  An epilogue with kStats also reduces each
// channel over the tile's valid pixels: the tile mean, then the centred
// M2 around it (two passes over registers, fixed order, no atomics).
//
// Packed weight layout (both kernels, written by ops/conv3x3.py):
//   [N tile g][16-channel chunk][tap ky*3+kx][8-channel half][n][8]
// with NT = n_tile(cout) output channels per N tile, zeros past cin and
// cout.
//
// rdb.cu's bf16 convs run on conv3x3_tma.cuh instead (zero padding by TMA,
// warp specialisation, a persistent grid); conv_wgmma is resnet_block.cu's.
// Left on the table here: those three, multicasting the weights over a
// cluster (each block streams the whole weight set from L2: 651 MB per
// N = 256 conv on the CycleGAN slab), a 20-byte register spill of the
// N = 32 conv, and stores staged through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace conv3x3 {

constexpr int KC = 16;  // input channels per staged chunk (one wgmma K step)

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// a value rounded through the activation dtype
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}
// two adjacent channels (d is 2-element aligned: channel offsets are even)
__device__ __forceinline__ void store2(float* d, float a, float b) {
  *reinterpret_cast<float2*>(d) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* d, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(a, b);
}

// Padding policies: the source index of padded coordinate i in [-1, n];
// an index outside [0, n) reads zero.
struct ZeroPad {
  __device__ static int map(int i, int) { return i; }
};
struct ReflectPad {  // torch ReflectionPad2d(1); needs n >= 2
  __device__ static int map(int i, int n) { return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i); }
};

// Output channels per N tile: the smallest wgmma width in {8, ..., 256}
// that holds cout, 256 beyond it.  ops/conv3x3.py::n_tile is the same rule.
__host__ __device__ inline int n_tile(int cout) {
  int nt = 8;
  while (nt < cout && nt < 256) nt *= 2;
  return nt;
}
__host__ __device__ inline int n_groups(int cout) { return (cout + n_tile(cout) - 1) / n_tile(cout); }
__host__ __device__ inline int chunks(int cin) { return (cin + KC - 1) / KC; }
// elements of one conv's packed weights
__host__ __device__ inline size_t packed_elems(int cin, int cout) {
  return (size_t)n_groups(cout) * chunks(cin) * 9 * KC * n_tile(cout);
}
__device__ __forceinline__ size_t packed_index(int c, int tap, int co, int cin, int nt) {
  const int g = co / nt, n = co % nt;
  return ((((size_t)g * chunks(cin) + c / KC) * 9 + tap) * 2 + (c % KC) / 8) * nt * 8 +
         (size_t)n * 8 + c % 8;
}

// One conv over input channels [0, cin) of (B, H, W) pixels: channels
// [0, head_ch) come from head (pixel stride head_stride), the others from
// src (pixel stride ctot), so an RDB's x need not be copied into its
// workspace; cout outputs; bias (cout,) fp32.  head_ch is a multiple of 8.
// The epilogue functor gets (pixel index b*H*W + y*W + x, channel co
// (even), acc + bias for co and co + 1).
struct Geom {
  const void* src;
  const void* head;
  const float* bias;
  int B, H, W, ctot, head_stride, head_ch, cin, cout;
};

// where input channel c of pixel p lies
template <typename T>
__device__ __forceinline__ const T* in_ptr(const Geom& g, size_t p, int c) {
  return c < g.head_ch ? static_cast<const T*>(g.head) + p * g.head_stride + c
                       : static_cast<const T*>(g.src) + p * g.ctot + c;
}

// ---------------------------------------------------------------------------
// conv_ffma: the fp32 direct conv.  A block computes a 16x16 output tile
// for COG output channels; it stages the 18x18 halo and the weight slice
// in shared memory 16 channels at a time, and each thread accumulates two
// pixels x COG channels in fp32 registers.
namespace ffma {
constexpr int TILE = 16;                  // output tile edge (pixels)
constexpr int HALO = TILE + 2;            // 18: tile plus a 1-pixel ring
constexpr int ROW_S = 24;                 // shared row stride (floats): a warp's
                                          // two pixel rows land in disjoint banks
constexpr int CH_S = HALO * ROW_S + 1;    // per-channel stride, odd
constexpr int THREADS = 128;              // 16 columns x 8 row pairs
}  // namespace ffma

template <typename T, int COG, class Pad, class Epi>
__global__ void __launch_bounds__(ffma::THREADS) conv_ffma(Geom g, const T* __restrict__ w,
                                                          Epi epi) {
  using namespace ffma;
  __shared__ float hs[KC * CH_S];
  __shared__ __align__(16) float wsm[KC * 9 * COG];
  const int tid = threadIdx.x;
  const int px = tid & (TILE - 1);
  const int py0 = (tid / TILE) * 2;
  const int x0 = blockIdx.x * TILE;
  const int y0 = blockIdx.y * TILE;
  const int groups = g.cout / COG;
  const int b = blockIdx.z / groups;
  const int co0 = (blockIdx.z % groups) * COG;
  const int nt = n_tile(g.cout);
  const size_t img = (size_t)b * g.H * g.W;

  float acc0[COG], acc1[COG];
#pragma unroll
  for (int co = 0; co < COG; ++co) acc0[co] = acc1[co] = 0.f;

  for (int c0 = 0; c0 < g.cin; c0 += KC) {
    for (int i = tid; i < HALO * HALO * KC; i += THREADS) {
      const int ci = i % KC, p = i / KC;
      const int hy = p / HALO, hx = p % HALO;
      const int gy = Pad::map(y0 + hy - 1, g.H), gx = Pad::map(x0 + hx - 1, g.W);
      const int c = c0 + ci;
      float v = 0.f;
      if (gy >= 0 && gy < g.H && gx >= 0 && gx < g.W && c < g.cin)
        v = to_f<T>(*in_ptr<T>(g, img + (size_t)gy * g.W + gx, c));
      hs[ci * CH_S + hy * ROW_S + hx] = v;
    }
    for (int i = tid; i < KC * 9 * COG; i += THREADS) {
      const int co = i % COG, r = i / COG;  // r = ci * 9 + tap (zeros past cin)
      wsm[i] = to_f<T>(w[packed_index(c0 + r / 9, r % 9, co0 + co, g.cin, nt)]);
    }
    __syncthreads();
#pragma unroll 2
    for (int ci = 0; ci < KC; ++ci) {
      const float* h = hs + ci * CH_S + py0 * ROW_S + px;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) v[r] = h[r * ROW_S + dx];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float4* wv =
              reinterpret_cast<const float4*>(wsm + (ci * 9 + dy * 3 + dx) * COG);
#pragma unroll
          for (int q = 0; q < COG / 4; ++q) {
            const float4 w4 = wv[q];
            acc0[4 * q + 0] += v[dy] * w4.x;
            acc0[4 * q + 1] += v[dy] * w4.y;
            acc0[4 * q + 2] += v[dy] * w4.z;
            acc0[4 * q + 3] += v[dy] * w4.w;
            acc1[4 * q + 0] += v[dy + 1] * w4.x;
            acc1[4 * q + 1] += v[dy + 1] * w4.y;
            acc1[4 * q + 2] += v[dy + 1] * w4.z;
            acc1[4 * q + 3] += v[dy + 1] * w4.w;
          }
        }
      }
    }
    __syncthreads();
  }

  const int gx = x0 + px;
  if (gx >= g.W) return;
  const int gy = y0 + py0;
#pragma unroll
  for (int co = 0; co < COG; co += 2) {
    const float b0 = g.bias[co0 + co], b1 = g.bias[co0 + co + 1];
    if (gy < g.H) epi(img + (size_t)gy * g.W + gx, co0 + co, acc0[co] + b0, acc0[co + 1] + b1);
    if (gy + 1 < g.H)
      epi(img + (size_t)(gy + 1) * g.W + gx, co0 + co, acc1[co] + b0, acc1[co + 1] + b1);
  }
}

// the widest output-channel group of conv_ffma that divides cout
template <typename T, class Pad, class Epi>
cudaError_t launch_ffma(const Geom& g, const T* w, const Epi& epi, cudaStream_t s) {
  const dim3 grid((g.W + ffma::TILE - 1) / ffma::TILE, (g.H + ffma::TILE - 1) / ffma::TILE, 1);
  if (g.cout % 32 == 0) {
    conv_ffma<T, 32, Pad, Epi><<<dim3(grid.x, grid.y, g.B * (g.cout / 32)), ffma::THREADS, 0, s>>>(g, w, epi);
  } else if (g.cout % 16 == 0) {
    conv_ffma<T, 16, Pad, Epi><<<dim3(grid.x, grid.y, g.B * (g.cout / 16)), ffma::THREADS, 0, s>>>(g, w, epi);
  } else {
    conv_ffma<T, 8, Pad, Epi><<<dim3(grid.x, grid.y, g.B * (g.cout / 8)), ffma::THREADS, 0, s>>>(g, w, epi);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// conv_wgmma: the bf16 tensor-core implicit GEMM (see the file note).

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// make this thread's generic-proxy shared writes visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Shared-memory matrix descriptor, no swizzle, K-major: start address,
// LBO = byte stride between the two 8-element K halves of a k16 step, SBO
// = byte stride between 8-row groups along M (or N).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// D[64 x N] += A[64 x 16] * B[16 x N], bf16 in, fp32 accumulate
template <int N> __device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a, uint64_t b);

template <> __device__ __forceinline__ void wgmma<8>(float (&d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma<16>(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma<32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma<256>(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

namespace tc {
constexpr int TW = 64;         // output columns per tile: one m64 tile = one row
constexpr int HP_W = TW + 2;   // halo pixels per row
constexpr int WG = 2;          // warpgroups per block
constexpr int THREADS = WG * 128;
}  // namespace tc

// m64 rows per warpgroup for an N tile: the accumulators (MT * NT / 2
// fp32 per thread) stay within 64 registers below N = 256, so that two
// blocks fit on an SM (N = 64 ran 1.6x slower per FLOP with MT = 4 and
// one block per SM).
__host__ __device__ constexpr int m_tiles(int nt) { return nt >= 256 ? 1 : (nt >= 64 ? 2 : 4); }

template <int NT> struct TcCfg {
  static constexpr int MT = m_tiles(NT);
  static constexpr int TH = tc::WG * MT;                    // output rows per tile
  static constexpr int HALO_PX = (TH + 2) * tc::HP_W;
  static constexpr int A_BYTES = HALO_PX * KC * 2;          // two 8-channel planes
  static constexpr int B_BYTES = 9 * KC * NT * 2;           // 9 taps x 16 ch x NT
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = NT >= 256 ? 2 : 3;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
  static constexpr int MIN_BLOCKS = NT <= 64 ? 2 : 1;
};

template <int NT, class Pad, class Epi>
__global__ void __launch_bounds__(tc::THREADS, TcCfg<NT>::MIN_BLOCKS)
conv_wgmma(Geom g, const __nv_bfloat16* __restrict__ w, Epi epi) {
  using C = TcCfg<NT>;
  constexpr int MT = C::MT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int x0 = blockIdx.x * tc::TW, y0 = blockIdx.y * C::TH;
  const int groups = (g.cout + NT - 1) / NT;
  const int b = blockIdx.z / groups, n0 = (blockIdx.z % groups) * NT;
  const int nchunks = chunks(g.cin);
  const size_t img = (size_t)b * g.H * g.W;
  const char* wsrc = reinterpret_cast<const char*>(w + (size_t)(n0 / NT) * nchunks * 9 * KC * NT);
  const uint32_t sbase = smem_addr(smem);

  // The halo: thread t < 2 * 66 copies pixel column t / 2, channel half
  // t % 2, of every halo row, so its column math is done once.
  const int hx = tid >> 1, half = tid & 1;
  const int gx = Pad::map(x0 + hx - 1, g.W);
  const bool okx = tid < 2 * tc::HP_W && gx >= 0 && gx < g.W;
  auto stage = [&](int ch, int s) {
    const uint32_t a = sbase + s * C::STAGE_BYTES;
    if (tid < 2 * tc::HP_W) {
      const int c = ch * KC + half * 8;
      const bool okc = okx && c < g.cin;
      const bool head = c < g.head_ch;
      const __nv_bfloat16* base =
          static_cast<const __nv_bfloat16*>(head ? g.head : g.src) + c;
      const size_t stride = head ? g.head_stride : g.ctot;
      const uint32_t dst = a + (half * C::HALO_PX + hx) * 16;
#pragma unroll
      for (int hy = 0; hy < C::TH + 2; ++hy) {
        const int gy = Pad::map(y0 + hy - 1, g.H);
        const bool ok = okc && gy >= 0 && gy < g.H;
        const void* p = ok ? base + (img + (size_t)gy * g.W + gx) * stride : g.src;
        cp_async16(dst + hy * tc::HP_W * 16, p, ok ? 16 : 0);
      }
    }
    const char* wc = wsrc + (size_t)ch * C::B_BYTES;
    for (int i = tid; i < C::B_BYTES / 16; i += tc::THREADS)
      cp_async16(a + C::A_BYTES + i * 16, wc + (size_t)i * 16, 16);
  };

  float acc[MT][NT / 2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) acc[m][j] = 0.f;

  // the 9 taps x MT rows of wgmmas of one staged chunk
  auto mma = [&](uint32_t a) {
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const uint64_t db = smem_desc(a + C::A_BYTES + tap * KC * NT * 2, NT * 16, 128);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int r = wg * MT + m;
        const uint64_t da = smem_desc(a + ((r + dy) * tc::HP_W + dx) * 16, C::HALO_PX * 16, 128);
        wgmma<NT>(acc[m], da, db);
      }
    }
    wgmma_commit();
  };
  constexpr int S = C::STAGES;
  if constexpr (S >= 3) {
    // Chunk k's wgmmas stay in flight while chunk k + 1 is waited for and
    // issued; the copy of chunk k + S - 2 goes into the buffer of chunk
    // k - 2, whose wgmmas wgmma_wait<1> has retired (in every warpgroup,
    // once past the barrier).
#pragma unroll
    for (int s = 0; s < S - 2; ++s) {
      if (s < nchunks) stage(s, s);
      cp_async_commit();
    }
    for (int k = 0; k < nchunks; ++k) {
      cp_async_wait<S - 3>();  // chunk k has landed (this thread's copies)
      fence_proxy_async();
      wgmma_wait<1>();         // chunk k - 2's wgmmas are done
      __syncthreads();
      if (k + S - 2 < nchunks) stage(k + S - 2, (k + S - 2) % S);
      cp_async_commit();
      mma(sbase + (k % S) * C::STAGE_BYTES);
    }
    wgmma_wait<0>();
  } else {
    // two buffers: chunk k + 1 is copied while chunk k's wgmmas run
    if (nchunks > 0) stage(0, 0);
    cp_async_commit();
    for (int k = 0; k < nchunks; ++k) {
      cp_async_wait<0>();  // chunk k has landed (this thread's copies)
      fence_proxy_async();
      __syncthreads();     // everyone's copies; chunk k - 1's wgmmas are done
      if (k + 1 < nchunks) stage(k + 1, (k + 1) % 2);
      cp_async_commit();
      mma(sbase + (k % 2) * C::STAGE_BYTES);
      wgmma_wait<0>();
    }
  }
  cp_async_wait<0>();

  // epilogue: thread (warp, lane) holds pixel columns 16*warp + lane/4 (+8)
  // of each of its rows and channel pairs 8i + 2*(lane%4)
  const int xa = x0 + 16 * warp + lane / 4;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int y = y0 + wg * MT + m;
#pragma unroll
    for (int j = 0; j < NT / 2; j += 2) {
      const int co = n0 + 8 * (j / 4) + 2 * (lane % 4);
      const int x = xa + 8 * ((j % 4) / 2);
      if (y < g.H && x < g.W && co < g.cout) {
        acc[m][j] += g.bias[co];
        acc[m][j + 1] += g.bias[co + 1];
        epi(img + (size_t)y * g.W + x, co, acc[m][j], acc[m][j + 1]);
      }
    }
  }
  if constexpr (Epi::kStats) {
    // Per channel over the tile's valid pixels: the mean, then the M2
    // around it.  red[8 warps][NT] partial sums, added in warp order.
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);
    float* mean_s = red + tc::WG * 4 * NT;
    const int rows = min(C::TH, g.H - y0), cols = min(tc::TW, g.W - x0);
    const float cnt = (float)(rows * cols);
    auto valid = [&](int m, int j) {
      return (y0 + wg * MT + m) < g.H && (xa + 8 * ((j % 4) / 2)) < g.W;
    };
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        if ((j % 4) >= 2) continue;  // the +8 rows are folded in with j + 2
        const int cc = 8 * (j / 4) + 2 * (lane % 4) + (j % 2);
        const float mu = pass ? mean_s[cc] : 0.f;
        float s = 0.f;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float d0 = acc[m][j] - mu, d1 = acc[m][j + 2] - mu;
          if (valid(m, j)) s += pass ? d0 * d0 : d0;
          if (valid(m, j + 2)) s += pass ? d1 * d1 : d1;
        }
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (lane < 4) red[(wg * 4 + warp) * NT + cc] = s;
      }
      __syncthreads();
      if (tid < NT) {
        float t = 0.f;
        for (int k = 0; k < tc::WG * 4; ++k) t += red[k * NT + tid];
        if (pass == 0) {
          mean_s[tid] = t / cnt;
        } else if (n0 + tid < g.cout) {
          epi.stats(b, blockIdx.y * gridDim.x + blockIdx.x, gridDim.x * gridDim.y, n0 + tid,
                    mean_s[tid], t, cnt);
        }
      }
      __syncthreads();
    }
  }
}

template <int NT, class Pad, class Epi>
cudaError_t launch_wgmma_nt(const Geom& g, const __nv_bfloat16* w, const Epi& epi,
                            cudaStream_t s) {
  using C = TcCfg<NT>;
  static_assert(C::SMEM <= 227 * 1024, "shared memory");
  static_assert(tc::WG * 4 * NT * 4 + NT * 4 <= C::SMEM, "stats scratch");
  // The attribute belongs to the current device: set it once per
  // instantiation and device (on every call past the table's devices).
  constexpr int kDevices = 64;
  static bool attr[kDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kDevices || !attr[dev]) {
    e = cudaFuncSetAttribute(conv_wgmma<NT, Pad, Epi>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return e;
    if (dev < kDevices) attr[dev] = true;
  }
  const dim3 grid((g.W + tc::TW - 1) / tc::TW, (g.H + C::TH - 1) / C::TH,
                  g.B * ((g.cout + NT - 1) / NT));
  conv_wgmma<NT, Pad, Epi><<<grid, tc::THREADS, C::SMEM, s>>>(g, w, epi);
  return cudaGetLastError();
}

// Tiles per image of conv_wgmma for this cout (the stats partials' count).
inline int wgmma_tiles(int H, int W, int cout) {
  const int th = tc::WG * m_tiles(n_tile(cout));
  return ((W + tc::TW - 1) / tc::TW) * ((H + th - 1) / th);
}

template <class Pad, class Epi>
cudaError_t launch_wgmma(const Geom& g, const __nv_bfloat16* w, const Epi& epi, cudaStream_t s) {
  switch (n_tile(g.cout)) {
    case 8: return launch_wgmma_nt<8, Pad, Epi>(g, w, epi, s);
    case 16: return launch_wgmma_nt<16, Pad, Epi>(g, w, epi, s);
    case 32: return launch_wgmma_nt<32, Pad, Epi>(g, w, epi, s);
    case 64: return launch_wgmma_nt<64, Pad, Epi>(g, w, epi, s);
    case 128: return launch_wgmma_nt<128, Pad, Epi>(g, w, epi, s);
    default: return launch_wgmma_nt<256, Pad, Epi>(g, w, epi, s);
  }
}

}  // namespace conv3x3

// The dynamic shared memory (bytes) of the bf16 conv for this cout: each
// library including this header exports it for its build report.
extern "C" int innfer_conv_tc_smem_bytes(int cout) {
  switch (conv3x3::n_tile(cout)) {
    case 8: return conv3x3::TcCfg<8>::SMEM;
    case 16: return conv3x3::TcCfg<16>::SMEM;
    case 32: return conv3x3::TcCfg<32>::SMEM;
    case 64: return conv3x3::TcCfg<64>::SMEM;
    case 128: return conv3x3::TcCfg<128>::SMEM;
    default: return conv3x3::TcCfg<256>::SMEM;
  }
}
