// LayerNorm over the channels of bf16 tokens, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no SwinIR, whose 73
// LayerNorms a forward runs over (tokens, C = 180) bf16 rows
// (models/swinir.py).  For each row x of C values it computes what
// ops/layer_norm.py::layer_norm_reference computes:
//   mean = sum(x) / C, var = sum((x - mean)^2) / C    fp32, two passes over
//                                                      the row in registers
//   y    = bf16((x - mean) * rsqrt(var + eps) * w + b)  w, b fp32; one rounding
// into a row of co >= C channels, zero after C: the next GEMM's 16-byte rows.
//
// Bound: bytes.  A row is read once and written once, 4 C bytes: 376 MB a
// 544 x 960 canvas at C = 180, 0.112 ms at 3.35 TB/s.  PyTorch's CUDA
// LayerNorm takes no fp32 affine for a bf16 input and, for rows of 180
// (not a multiple of its 8-wide vectors), ran at a sixth of that bound on
// an H100.
//
// Design: a warp per row.  The row's C / 4 8-byte pieces (C % 4 == 0) are
// spread over the lanes and held in registers, so the row is read once and
// the variance is a second pass over registers, never a sum of squares;
// the sums are warp shuffles.  The affine's fp32 w and b come from L1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = THREADS / 32;
constexpr int MAX_PIECES = 8;   // 8-byte pieces a lane holds: C <= 1024

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS)
lnorm_rows(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
           const float* __restrict__ b, __nv_bfloat16* __restrict__ y, long long M, int C,
           int co, float eps) {
  const long long row = (long long)blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (row >= M) return;
  const int lane = threadIdx.x & 31;
  const int pieces = C / 4;
  const uint2* src = reinterpret_cast<const uint2*>(x + row * C);
  float v[MAX_PIECES][4];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_PIECES; ++i) {
    const int p = lane + 32 * i;
    if (p < pieces) {
      const uint2 u = src[p];
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      v[i][0] = lo.x; v[i][1] = lo.y; v[i][2] = hi.x; v[i][3] = hi.y;
      s += (lo.x + lo.y) + (hi.x + hi.y);
    }
  }
  const float mean = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_PIECES; ++i) {
    if (lane + 32 * i < pieces) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = v[i][e] - mean;
        q += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / C + eps);
  uint2* dst = reinterpret_cast<uint2*>(y + row * co);
  for (int p = pieces + lane; p < co / 4; p += 32) dst[p] = make_uint2(0u, 0u);
#pragma unroll
  for (int i = 0; i < MAX_PIECES; ++i) {
    const int p = lane + 32 * i;
    if (p < pieces) {
      const float4 wv = __ldg(reinterpret_cast<const float4*>(w) + p);
      const float4 bv = __ldg(reinterpret_cast<const float4*>(b) + p);
      const __nv_bfloat162 lo = __floats2bfloat162_rn((v[i][0] - mean) * rstd * wv.x + bv.x,
                                                      (v[i][1] - mean) * rstd * wv.y + bv.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn((v[i][2] - mean) * rstd * wv.z + bv.z,
                                                      (v[i][3] - mean) * rstd * wv.w + bv.w);
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&lo);
      u.y = *reinterpret_cast<const uint32_t*>(&hi);
      dst[p] = u;
    }
  }
}

}  // namespace

extern "C" {

// x (M, C) and y (M, co) bf16, w, b (C,) fp32; C % 4 == 0, C <= 1024,
// co % 4 == 0, co >= C; x, y 8-byte and w, b 16-byte aligned (checked by the
// wrapper, ops/layer_norm.py).
int innfer_layer_norm(const void* x, const void* w, const void* b, void* y, long long M, int C,
                      int co, float eps, cudaStream_t stream) {
  if (M < 1 || C < 4 || C % 4 || C / 4 > 32 * MAX_PIECES || co < C || co % 4)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (M + ROWS - 1) / ROWS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  lnorm_rows<<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y), M, C, co, eps);
  return (int)cudaGetLastError();
}

const char* innfer_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
