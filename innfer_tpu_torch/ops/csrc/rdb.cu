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
// Design.  The TPU kernel keeps a whole RDB in VMEM; one RDB's bf16
// weights alone (468 KiB) exceed the 227 KB a block may hold, so the RDB
// is five conv launches on a preallocated NHWC workspace [x | x1 | x2 | x3
// | x4] (nf + 4*gc channels): conv c reads channels [0, nf + (c-1)*gc) and
// writes its outputs into its own channel slice, so no concat exists; the
// x channels are read from x where it lies (no copy into the workspace).  The
// conv is conv3x3_tc.cuh's: in bf16 the wgmma implicit GEMM with N = cout
// (gc = 32 for convs 1-4, nf = 64 for conv5: one block covers all output
// channels, so each halo is staged once), K = 9 x cin in 16-channel
// chunks through a cp.async ring, zero padding from cp.async's zero fill;
// in fp32 (the parity path) the FFMA direct conv.  Run on bf16 too, that
// FFMA conv reached 23.7 TFLOP/s on an H100 (2.4% of the bound) on FP32
// pipes, staged synchronously in fp32, and re-read conv5's halo per
// 32-channel group; those three are what the tensor-core design removes.  The five
// epilogues (RdbEpi) are applied to the accumulator plus the fp32 bias;
// the ESRGAN+ 1x1 term (off the main path) stays an FFMA sum there,
// rounded on its own as before.
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
// call is fused_rdb's plus one read of res.  Both modes run the same conv
// code in the same order, so the chain equals the per-RDB path bit for bit.
//
// Left on the table: conv3x3_tc.cuh's list, and here keeping x1..x4 on
// chip across the five convs (each conv reads its cin channels of the
// workspace from device memory: 2.7 GB per call at 1080p, 0.8 ms at 3.35
// TB/s) and one CUDA graph or persistent launch over the trunk.
#include "conv3x3_tc.cuh"

namespace {

using conv3x3::from_f;
using conv3x3::rnd;
using conv3x3::to_f;

constexpr float SLOPE = 0.2f;

enum Epilogue {
  EPI_ACT = 0,        // bias + LReLU -> workspace slice
  EPI_ACT_1X1 = 1,    // conv 2 of plus: ... + cast(conv1x1(x))
  EPI_ACT_X2 = 2,     // conv 4 of plus: ... + x2
  EPI_RESIDUAL = 3,   // conv 5: (acc + b5) * 0.2 + x -> output tensor
  EPI_RRDB = 4,       // conv 5 of an RRDB's last RDB: ... then * s + res
};

// v = conv sum + fp32 bias for channels co, co + 1 of pixel pix.
template <typename T>
struct RdbEpi {
  static constexpr bool kStats = false;
  const T* x;        // the RDB input (B, H, W, nf), pixel stride xs
  const T* ws;       // workspace (B, H, W, ctot)
  T* dst;            // workspace or output tensor
  const T* w1;       // plus: conv1x1 weights [nf][gc]
  const T* res;      // EPI_RRDB: the RRDB input, stride ctot (may alias dst)
  float res_scale;   // EPI_RRDB: 0.2 rounded to the activation dtype
  int kind, xs, ctot, nf, gc, dst_stride, dst_off, x2_off;

  // ESRGAN+ only: sum over ci of x[pix, ci] * w1[ci][co].  Not inlined:
  // the epilogue is unrolled over every accumulator pair, and inlining this
  // loop into each copy multiplied the kernels' compile time.
  __device__ __noinline__ float conv1x1(size_t pix, int co) const {
    float p = 0.f;
    for (int ci = 0; ci < nf; ++ci)
      p += to_f<T>(x[pix * xs + ci]) * to_f<T>(w1[(size_t)ci * gc + co]);
    return p;
  }

  __device__ __forceinline__ void operator()(size_t pix, int co, float v0, float v1) const {
    const float v[2] = {v0, v1};
    float o[2];
    T* d = dst + pix * dst_stride + dst_off + co;
    if (kind >= EPI_RESIDUAL) {
      // res and dst may be the same memory: each element is read before it
      // is written, by the thread that writes it (no __restrict__ here)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float r = v[e] * SLOPE + to_f<T>(x[pix * xs + co + e]);
        if (kind == EPI_RRDB)
          r = __fadd_rn(rnd<T>(__fmul_rn(rnd<T>(r), res_scale)),
                        to_f<T>(res[pix * ctot + co + e]));
        o[e] = r;
      }
      conv3x3::store2(d, o[0], o[1]);
      return;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float a = rnd<T>(v[e] >= 0.f ? v[e] : v[e] * SLOPE);
      if (kind == EPI_ACT_1X1) a += rnd<T>(conv1x1(pix, co + e));
      if (kind == EPI_ACT_X2) a += to_f<T>(ws[pix * ctot + x2_off + co + e]);
      o[e] = a;
    }
    conv3x3::store2(d, o[0], o[1]);
  }
};

// The five convs of one RDB on input x (pixel stride xs; channels [0, nf)
// of ws in chain mode), with x1..x4 in channels [nf, nf + 4*gc) of ws.
// conv5 writes channels [0, nf) of dst (pixel stride dst_stride); with res
// it also applies the RRDB residual (EPI_RRDB).
template <typename T>
cudaError_t run_rdb(const T* x, int xs, T* ws, T* dst, int dst_stride, const T* res,
                    float res_scale,
                    const T* w, const float* bias, const T* w1, int B, int H, int W,
                    int nf, int gc, int plus, cudaStream_t s) {
  const int ctot = nf + 4 * gc;
  size_t woff = 0;
  int boff = 0;
  for (int c = 1; c <= 5; ++c) {
    conv3x3::Geom g;
    g.src = ws;
    g.head = x;
    g.head_stride = xs;
    g.head_ch = nf;
    g.bias = bias + boff;
    g.B = B; g.H = H; g.W = W;
    g.ctot = ctot;
    g.cin = nf + (c - 1) * gc;
    g.cout = c < 5 ? gc : nf;
    RdbEpi<T> epi;
    epi.x = x;
    epi.xs = xs;
    epi.ws = ws;
    epi.w1 = w1;
    epi.res = res;
    epi.res_scale = res_scale;
    epi.ctot = ctot; epi.nf = nf; epi.gc = gc;
    epi.x2_off = nf + gc;
    if (c < 5) {
      epi.dst = ws; epi.dst_stride = ctot; epi.dst_off = nf + (c - 1) * gc;
    } else {
      epi.dst = dst; epi.dst_stride = dst_stride; epi.dst_off = 0;
    }
    epi.kind = c == 5 ? (res != nullptr ? EPI_RRDB : EPI_RESIDUAL)
               : (plus && c == 2) ? EPI_ACT_1X1
               : (plus && c == 4) ? EPI_ACT_X2 : EPI_ACT;
    cudaError_t e;
    if constexpr (sizeof(T) == 2)
      e = conv3x3::launch_wgmma<conv3x3::ZeroPad>(g, w + woff, epi, s);
    else
      e = conv3x3::launch_ffma<T, conv3x3::ZeroPad>(g, w + woff, epi, s);
    if (e != cudaSuccess) return e;
    woff += conv3x3::packed_elems(g.cin, g.cout);
    boff += g.cout;
  }
  return cudaGetLastError();
}

cudaError_t run_rdb_dtype(const void* x, int xs, void* ws, void* dst, int dst_stride,
                          const void* res,
                          float res_scale, const void* w, const float* bias, const void* w1,
                          int B, int H, int W, int nf, int gc, int plus, int dtype,
                          cudaStream_t s) {
  if (dtype == 1) {
    using T = __nv_bfloat16;
    return run_rdb<T>(static_cast<const T*>(x), xs, static_cast<T*>(ws), static_cast<T*>(dst),
                      dst_stride,
                      static_cast<const T*>(res), res_scale, static_cast<const T*>(w), bias,
                      static_cast<const T*>(w1), B, H, W, nf, gc, plus, s);
  }
  return run_rdb<float>(static_cast<const float*>(x), xs, static_cast<float*>(ws),
                        static_cast<float*>(dst), dst_stride,
                        static_cast<const float*>(res), res_scale,
                        static_cast<const float*>(w), bias, static_cast<const float*>(w1), B,
                        H, W, nf, gc, plus, s);
}

}  // namespace

extern "C" {

// One RDB forward on `stream`.  x, out: (B, H, W, nf); ws: (B, H, W,
// nf + 4*gc) scratch (its channels [0, nf) are not used: the convs read x
// where it lies); w: the five convs' weights in conv3x3_tc.cuh's
// packed layout, back to back; bias: the five biases back to back (fp32);
// w1: conv1x1 weights [nf][gc] when plus != 0.  dtype 0 = fp32, 1 = bf16
// (bf16 pointers 16-byte aligned).  Returns the first CUDA error
// (cudaSuccess = 0).
int innfer_rdb_forward(const void* x, void* ws, void* out, const void* w,
                       const float* bias, const void* w1, int B, int H, int W,
                       int nf, int gc, int plus, int dtype, void* stream) {
  return run_rdb_dtype(x, nf, ws, out, nf, nullptr, 0.f, w, bias, w1, B, H, W, nf, gc, plus,
                       dtype, static_cast<cudaStream_t>(stream));
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
  return run_rdb_dtype(ws, nf + 4 * gc, ws, out_ws, nf + 4 * gc, res, res_scale, w, bias, w1, B,
                       H, W, nf, gc, plus, dtype, static_cast<cudaStream_t>(stream));
}

const char* innfer_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
