// Fused Residual Dense Block (RDB_5C) forward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel innfer_tpu/ops/pallas/rdb.py::fused_rdb and
// computes the same function, with the same rounding points
// (rdb.py:242-292):
//   x_c = cast(LReLU0.2(conv3x3(cat(x, x1..x_{c-1})) + b_c))   c = 1..4
//   ESRGAN+ plus: x2 += cast(conv1x1(x)), x4 += x2 (adds in the act dtype)
//   out = cast(fp32(conv3x3(cat(x..x4)) + b5) * 0.2 + fp32(x))
// Accumulation is fp32; activations and weights are fp32 or bf16.
//
// Bound at the main-path shape, one call on the 1080p hybrid trunk canvas
// (1, 1088, 1920, 64), nf=64, gc=32: 239,616 MAC per pixel, 1.00 TFLOP
// and 0.53 GB of bf16 traffic (x in, out, weights).  Compute-bound: 1.01 ms
// at the H100's 989 TFLOP/s bf16 tensor rate (0.16 ms for the bytes at
// 3.35 TB/s); 14.9 ms in fp32 at 67 TFLOP/s outside the tensor cores.
//
// Design (the simple, correct first form).  The TPU kernel keeps a whole
// RDB in VMEM; one RDB's bf16 weights alone (468 KiB) exceed the 227 KB a
// block may hold, so here the RDB is five launches of one direct-conv
// kernel on a preallocated NHWC workspace [x | x1 | x2 | x3 | x4]
// (nf + 4*gc channels): conv c reads channels [0, nf + (c-1)*gc) and writes
// its gc outputs into its own channel slice, so no concat is materialized.
// A block computes a 16x16 output tile for one group of COG output
// channels; it stages the 18x18 input halo and the matching weight slice
// in shared memory, 16 input channels at a time, as fp32, and each thread
// accumulates two pixels x COG channels in fp32 registers (FFMA).  Zero
// padding at the tensor edge comes from the masked halo load; the ragged
// edge is masked at the store.
//
// Chain mode (innfer_rdb_forward_ws) replaces the TPU kernels
// rdb.py::fused_rdb_padded and, driven by the host loop in ops/rdb.py,
// rdb.py::fused_rrdb_trunk.  The RDB's input is the x-slice of a workspace
// that stays allocated across the calls of a trunk; conv5 writes straight
// into the x-slice of the next workspace (no copy of x, no allocation per
// call) and, for the last RDB of an RRDB, also applies the RRDB residual:
//   out = cast(cast(cast(fp32(x5) * 0.2 + fp32(x)) * s) + res)
// with s = 0.2 rounded to the activation dtype, each step rounded as the
// activation dtype's arithmetic does (rdb.py:292 and :304).  The bound per
// call is fused_rdb's plus one read of res.
//
// Left on the table: the tensor cores (wgmma bf16 -> fp32 would lift the
// ceiling from 67 to 989 TFLOP/s), TMA/cp.async double buffering of the
// halo, keeping x1..x4 on chip across the five convs, and one persistent
// launch per trunk.  Every conv re-reads its halo from L2 once per output
// channel group.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TILE = 16;                  // output tile edge (pixels)
constexpr int HALO = TILE + 2;            // 18: tile plus a 1-pixel ring
constexpr int ROW_S = 24;                 // shared row stride (floats): a warp's
                                          // two pixel rows land in disjoint banks
constexpr int CH_S = HALO * ROW_S + 1;    // per-channel stride, odd
constexpr int CK = 16;                    // input channels per staged chunk
constexpr int THREADS = 128;              // 16 columns x 8 row pairs
constexpr float SLOPE = 0.2f;

enum Epilogue {
  EPI_ACT = 0,        // bias + LReLU -> workspace slice
  EPI_ACT_1X1 = 1,    // conv 2 of plus: ... + cast(conv1x1(x))
  EPI_ACT_X2 = 2,     // conv 4 of plus: ... + x2
  EPI_RESIDUAL = 3,   // conv 5: (acc + b5) * 0.2 + x -> output tensor
  EPI_RRDB = 4,       // conv 5 of an RRDB's last RDB: ... then * s + res
};

struct ConvArgs {
  const void* ws;    // workspace (B, H, W, ctot); reads channels [0, cin)
  void* dst;         // workspace or output tensor
  const void* w;     // packed weights [cin][9][cout]
  const float* bias; // [cout], fp32
  const void* w1;    // plus: conv1x1 weights [nf][gc]
  const void* res;   // EPI_RRDB: the RRDB input, stride ctot (may alias dst)
  float res_scale;   // EPI_RRDB: 0.2 rounded to the activation dtype
  int B, H, W, ctot, cin, cout, nf, gc;
  int dst_stride, dst_off, x2_off;
};

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

template <typename T, int COG, int EPI>
__device__ __forceinline__ void epilogue(const ConvArgs& a, const float (&acc)[COG],
                                         size_t pix, int co0) {
  const T* ws = static_cast<const T*>(a.ws);
  T* dst = static_cast<T*>(a.dst) + pix * a.dst_stride + a.dst_off + co0;
  if (EPI == EPI_RESIDUAL || EPI == EPI_RRDB) {
    // res and dst may be the same memory: each element is read before it
    // is written, by the thread that writes it (no __restrict__ here)
    const T* res = static_cast<const T*>(a.res);
#pragma unroll
    for (int co = 0; co < COG; ++co) {
      const float xv = to_f<T>(ws[pix * a.ctot + co0 + co]);
      float v = (acc[co] + a.bias[co0 + co]) * SLOPE + xv;
      if (EPI == EPI_RRDB)
        v = __fadd_rn(rnd<T>(__fmul_rn(rnd<T>(v), a.res_scale)),
                      to_f<T>(res[pix * a.ctot + co0 + co]));
      dst[co] = from_f<T>(v);
    }
    return;
  }
  float p[COG];
  if (EPI == EPI_ACT_1X1) {
    const T* w1 = static_cast<const T*>(a.w1);
#pragma unroll
    for (int co = 0; co < COG; ++co) p[co] = 0.f;
    for (int ci = 0; ci < a.nf; ++ci) {
      const float xv = to_f<T>(ws[pix * a.ctot + ci]);
#pragma unroll
      for (int co = 0; co < COG; ++co)
        p[co] += xv * to_f<T>(w1[(size_t)ci * a.gc + co0 + co]);
    }
  }
#pragma unroll
  for (int co = 0; co < COG; ++co) {
    float v = acc[co] + a.bias[co0 + co];
    v = rnd<T>(v >= 0.f ? v : v * SLOPE);
    if (EPI == EPI_ACT_1X1) v += rnd<T>(p[co]);
    if (EPI == EPI_ACT_X2) v += to_f<T>(ws[pix * a.ctot + a.x2_off + co0 + co]);
    dst[co] = from_f<T>(v);
  }
}

template <typename T, int COG, int EPI>
__global__ void __launch_bounds__(THREADS) rdb_conv3x3(ConvArgs a) {
  __shared__ float hs[CK * CH_S];
  __shared__ __align__(16) float wsm[CK * 9 * COG];
  const T* src = static_cast<const T*>(a.ws);
  const T* wg = static_cast<const T*>(a.w);
  const int tid = threadIdx.x;
  const int px = tid & (TILE - 1);
  const int py0 = (tid / TILE) * 2;
  const int x0 = blockIdx.x * TILE;
  const int y0 = blockIdx.y * TILE;
  const int groups = a.cout / COG;
  const int b = blockIdx.z / groups;
  const int co0 = (blockIdx.z % groups) * COG;
  const size_t img = (size_t)b * a.H * a.W;

  float acc0[COG], acc1[COG];
#pragma unroll
  for (int co = 0; co < COG; ++co) acc0[co] = acc1[co] = 0.f;

  for (int c0 = 0; c0 < a.cin; c0 += CK) {
    for (int i = tid; i < HALO * HALO * CK; i += THREADS) {
      const int ci = i % CK, p = i / CK;
      const int hy = p / HALO, hx = p % HALO;
      const int gy = y0 + hy - 1, gx = x0 + hx - 1, c = c0 + ci;
      float v = 0.f;
      if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && c < a.cin)
        v = to_f<T>(src[(img + (size_t)gy * a.W + gx) * a.ctot + c]);
      hs[ci * CH_S + hy * ROW_S + hx] = v;
    }
    for (int i = tid; i < CK * 9 * COG; i += THREADS) {
      const int co = i % COG, r = i / COG;  // r = ci * 9 + tap
      const int c = c0 + r / 9;
      wsm[i] = c < a.cin ? to_f<T>(wg[((size_t)c * 9 + r % 9) * a.cout + co0 + co]) : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int ci = 0; ci < CK; ++ci) {
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
  if (gx >= a.W) return;
  const int gy = y0 + py0;
  if (gy < a.H) epilogue<T, COG, EPI>(a, acc0, img + (size_t)gy * a.W + gx, co0);
  if (gy + 1 < a.H) epilogue<T, COG, EPI>(a, acc1, img + (size_t)(gy + 1) * a.W + gx, co0);
}

template <typename T, int COG>
cudaError_t launch_cog(const ConvArgs& a, int epi, cudaStream_t s) {
  const dim3 grid((a.W + TILE - 1) / TILE, (a.H + TILE - 1) / TILE, a.B * (a.cout / COG));
  switch (epi) {
    case EPI_ACT: rdb_conv3x3<T, COG, EPI_ACT><<<grid, THREADS, 0, s>>>(a); break;
    case EPI_ACT_1X1: rdb_conv3x3<T, COG, EPI_ACT_1X1><<<grid, THREADS, 0, s>>>(a); break;
    case EPI_ACT_X2: rdb_conv3x3<T, COG, EPI_ACT_X2><<<grid, THREADS, 0, s>>>(a); break;
    case EPI_RESIDUAL: rdb_conv3x3<T, COG, EPI_RESIDUAL><<<grid, THREADS, 0, s>>>(a); break;
    default: rdb_conv3x3<T, COG, EPI_RRDB><<<grid, THREADS, 0, s>>>(a); break;
  }
  return cudaGetLastError();
}

// the widest output-channel group that divides cout (a multiple of 8)
template <typename T>
cudaError_t launch_conv(const ConvArgs& a, int epi, cudaStream_t s) {
  if (a.cout % 32 == 0) return launch_cog<T, 32>(a, epi, s);
  if (a.cout % 16 == 0) return launch_cog<T, 16>(a, epi, s);
  return launch_cog<T, 8>(a, epi, s);
}

// The five convs of one RDB whose input x is channels [0, nf) of ws.
// conv5 writes channels [0, nf) of dst (pixel stride dst_stride); with res
// it also applies the RRDB residual (EPI_RRDB).
cudaError_t run_rdb(void* ws, void* dst, int dst_stride, const void* res,
                    float res_scale, const void* w, const float* bias, const void* w1,
                    int B, int H, int W, int nf, int gc, int plus, int dtype,
                    cudaStream_t s) {
  const size_t es = dtype == 1 ? 2 : 4;
  const int ctot = nf + 4 * gc;
  cudaError_t e = cudaSuccess;
  size_t woff = 0;
  int boff = 0;
  for (int c = 1; c <= 5; ++c) {
    ConvArgs a;
    a.ws = ws;
    a.cin = nf + (c - 1) * gc;
    a.cout = c < 5 ? gc : nf;
    a.w = static_cast<const char*>(w) + woff * es;
    a.bias = bias + boff;
    a.w1 = w1;
    a.res = res;
    a.res_scale = res_scale;
    a.B = B; a.H = H; a.W = W;
    a.ctot = ctot; a.nf = nf; a.gc = gc;
    a.x2_off = nf + gc;
    if (c < 5) {
      a.dst = ws; a.dst_stride = ctot; a.dst_off = nf + (c - 1) * gc;
    } else {
      a.dst = dst; a.dst_stride = dst_stride; a.dst_off = 0;
    }
    const int epi = c == 5 ? (res != nullptr ? EPI_RRDB : EPI_RESIDUAL)
                    : (plus && c == 2) ? EPI_ACT_1X1
                    : (plus && c == 4) ? EPI_ACT_X2 : EPI_ACT;
    e = dtype == 1 ? launch_conv<__nv_bfloat16>(a, epi, s) : launch_conv<float>(a, epi, s);
    if (e != cudaSuccess) return e;
    woff += (size_t)a.cin * 9 * a.cout;
    boff += a.cout;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One RDB forward on `stream`.  x, out: (B, H, W, nf); ws: (B, H, W,
// nf + 4*gc) scratch; w: the five convs' weights packed [cin][9][cout] back
// to back; bias: the five biases back to back (fp32); w1: conv1x1 weights
// [nf][gc] when plus != 0.  dtype 0 = fp32, 1 = bf16.  Returns the first
// CUDA error (cudaSuccess = 0).
int innfer_rdb_forward(const void* x, void* ws, void* out, const void* w,
                       const float* bias, const void* w1, int B, int H, int W,
                       int nf, int gc, int plus, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t es = dtype == 1 ? 2 : 4;
  const int ctot = nf + 4 * gc;
  cudaError_t e = cudaMemcpy2DAsync(ws, ctot * es, x, nf * es, nf * es, (size_t)B * H * W,
                                    cudaMemcpyDeviceToDevice, s);
  if (e != cudaSuccess) return e;
  return run_rdb(ws, out, nf, nullptr, 0.f, w, bias, w1, B, H, W, nf, gc, plus, dtype, s);
}

// One RDB on persistent workspaces (chain mode).  ws, out_ws: (B, H, W,
// nf + 4*gc); the input x is channels [0, nf) of ws, convs 1-4 fill ws's
// other channels, and the output goes to channels [0, nf) of out_ws, which
// must not be ws.  res: NULL, or a workspace whose channels [0, nf) hold
// the RRDB input; it may be out_ws itself (the output then replaces the
// RRDB input in place).  res_scale: 0.2 rounded to the activation dtype.
int innfer_rdb_forward_ws(void* ws, void* out_ws, const void* res, const void* w,
                          const float* bias, const void* w1, int B, int H, int W,
                          int nf, int gc, int plus, int dtype, float res_scale,
                          void* stream) {
  return run_rdb(ws, out_ws, nf + 4 * gc, res, res_scale, w, bias, w1, B, H, W, nf, gc,
                 plus, dtype, static_cast<cudaStream_t>(stream));
}

const char* innfer_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
