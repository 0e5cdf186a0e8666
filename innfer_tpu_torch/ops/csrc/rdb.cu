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
// x channels are read from x where it lies (no copy into the workspace).
// In bf16 each conv is conv3x3_tma.cuh's: a persistent grid of one block
// per SM, a TMA producer warp filling an mbarrier ring with halo boxes
// (whose out-of-bounds zero fill is the padding) and weight chunks, and two
// wgmma consumer warpgroups with N = cout (gc = 32 for convs 1-4 on
// 16-row tiles, nf = 64 for conv5 on 8-row tiles: one block covers all
// output channels, so each halo is staged once).  In fp32 (the parity
// path) the conv is conv3x3_tc.cuh's FFMA direct conv.  The five
// epilogues (RdbEpi) are applied to the accumulator plus the fp32 bias;
// the ESRGAN+ 1x1 term (off the main path) is an FFMA sum of its own
// small kernel, rounded on its own into the x2 slice before conv2, whose
// epilogue adds it there as conv4's adds x2.
//
// The five convs' floors at the main-path shape (the larger of the
// operations at 989 TFLOP/s and the bytes of the workspace channels each
// reads and writes at 3.35 TB/s): 0.120, 0.160, 0.200, 0.239 and 0.467 ms.
// Keeping x1..x4 on chip could lower their 1.19 ms sum to the 1.01 ms of
// the operations alone.
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
// code in the same order, and each output pixel's sums are taken in the
// same order whichever block computes it, so the chain equals the per-RDB
// path bit for bit, and a stack of images equals its images one by one.
//
// Left on the table: conv3x3_tma.cuh's list, keeping x1..x4 on chip
// across the five convs, and one persistent launch over the trunk.
#include "conv3x3_tma.cuh"

namespace {

using conv3x3::from_f;
using conv3x3::rnd;
using conv3x3::to_f;

constexpr float SLOPE = 0.2f;

enum Epilogue {
  EPI_ACT = 0,        // bias + LReLU -> workspace slice
  EPI_ACT_ADD = 1,    // conv 2 and 4 of plus: ... + what the x2 slice holds
  EPI_RESIDUAL = 3,   // conv 5: (acc + b5) * 0.2 + x -> output tensor
  EPI_RRDB = 4,       // conv 5 of an RRDB's last RDB: ... then * s + res
};

// ESRGAN+ only: cast(sum over ci of x[pix, ci] * w1[ci][co]) into channel co
// of the x2 slice, before conv2, whose epilogue adds it there (EPI_ACT_ADD)
// and writes x2 over it.  One thread per output value.
template <typename T>
__global__ void conv1x1_into(const T* __restrict__ x, int xs, const T* __restrict__ w1, T* ws,
                             int ctot, int off, int nf, int gc, size_t npix) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npix * gc) return;
  const size_t pix = i / gc;
  const int co = (int)(i % gc);
  float p = 0.f;
  for (int ci = 0; ci < nf; ++ci)
    p += to_f<T>(x[pix * xs + ci]) * to_f<T>(w1[(size_t)ci * gc + co]);
  ws[pix * ctot + off + co] = from_f<T>(p);
}

template <typename T> struct Pair;  // two adjacent channels in one load
template <> struct Pair<float> {
  float2 v;
  __device__ float lo() const { return v.x; }
  __device__ float hi() const { return v.y; }
};
template <> struct Pair<__nv_bfloat16> {
  __nv_bfloat162 v;
  __device__ float lo() const { return __low2float(v); }
  __device__ float hi() const { return __high2float(v); }
};
template <typename T>
__device__ __forceinline__ Pair<T> load2(const T* p) {  // p is 2-element aligned
  return {*reinterpret_cast<const decltype(Pair<T>::v)*>(p)};
}
template <typename T> __device__ __forceinline__ Pair<T> pack2(float a, float b);
template <> __device__ __forceinline__ Pair<float> pack2<float>(float a, float b) {
  return {make_float2(a, b)};
}
template <> __device__ __forceinline__ Pair<__nv_bfloat16> pack2<__nv_bfloat16>(float a, float b) {
  return {__floats2bfloat162_rn(a, b)};
}

// The epilogue of channels co, co + 1 (co even) of pixel pix, in two steps
// so that a caller can issue a row's reads before its stores: load() reads
// what the kind adds besides the conv sum (x for conv5, res for EPI_RRDB,
// the x2 slice for EPI_ACT_ADD), store() applies the kind to v = conv sum +
// fp32 bias.
template <typename T>
struct RdbEpi {
  static constexpr bool kStats = false;
  const T* x;        // the RDB input (B, H, W, nf), pixel stride xs
  const T* ws;       // workspace (B, H, W, ctot)
  T* dst;            // workspace or output tensor
  const T* res;      // EPI_RRDB: the RRDB input, stride ctot (may alias dst)
  float res_scale;   // EPI_RRDB: 0.2 rounded to the activation dtype
  int kind, xs, ctot, nf, gc, dst_stride, dst_off, x2_off, cout_;

  struct Pre {
    Pair<T> a, r;    // x or x2; res
  };

  __device__ __forceinline__ Pre load(size_t pix, int co) const {
    Pre p{};
    if (kind >= EPI_RESIDUAL) {
      p.a = load2(x + pix * xs + co);
      // res and dst may be the same memory: each element is read before it
      // is written, by the thread that writes it (no __restrict__ here)
      if (kind == EPI_RRDB) p.r = load2(res + pix * ctot + co);
    } else if (kind == EPI_ACT_ADD) {
      p.a = load2(ws + pix * ctot + x2_off + co);
    }
    return p;
  }

  // the two outputs of channels co, co + 1, rounded to T
  __device__ __forceinline__ Pair<T> value(int co, float v0, float v1, const Pre& p) const {
    const float v[2] = {v0, v1}, a[2] = {p.a.lo(), p.a.hi()}, r[2] = {p.r.lo(), p.r.hi()};
    float o[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (kind >= EPI_RESIDUAL) {
        o[e] = v[e] * SLOPE + a[e];
        if (kind == EPI_RRDB) o[e] = __fadd_rn(rnd<T>(__fmul_rn(rnd<T>(o[e]), res_scale)), r[e]);
      } else {
        o[e] = rnd<T>(v[e] >= 0.f ? v[e] : v[e] * SLOPE);
        if (kind == EPI_ACT_ADD) o[e] += a[e];
      }
    }
    return pack2<T>(o[0], o[1]);
  }

  __device__ __forceinline__ void store(size_t pix, int co, float v0, float v1,
                                        const Pre& p) const {
    *reinterpret_cast<decltype(Pair<T>::v)*>(dst + pix * dst_stride + dst_off + co) =
        value(co, v0, v1, p).v;
  }

  __device__ __forceinline__ void operator()(size_t pix, int co, float v0, float v1) const {
    store(pix, co, v0, v1, load(pix, co));
  }

  // The bf16 TMA conv's epilogue: K consecutive channels c0.. of pixel pix,
  // moved in units of U = min(8, K) channels (16 bytes), each only where it
  // lies below cout (a multiple of 8), so that a warp's stores cover whole
  // 32-byte sectors.
  template <int K> struct Run {
    static constexpr int U = K < 8 ? K : 8;
    Pre p[K / 2];
  };

  template <int K>
  __device__ __forceinline__ Run<K> load(size_t pix, int c0) const {
    constexpr int U = Run<K>::U;
    Run<K> r{};
#pragma unroll
    for (int u = 0; u < K / U; ++u) {
      if (c0 + U * u >= cout_) break;
      if (kind != EPI_ACT) {
        const T* a = kind == EPI_ACT_ADD ? ws + pix * ctot + x2_off : x + pix * xs;
        copy_run<U>(r.p + U / 2 * u, &Pre::a, a + c0 + U * u);
        if (kind == EPI_RRDB) copy_run<U>(r.p + U / 2 * u, &Pre::r, res + pix * ctot + c0 + U * u);
      }
    }
    return r;
  }

  // v of channel c0 + c is acc[4 (c / 2) + 2 h + c % 2] + bias[c]: the
  // accumulator row of conv3x3_tma.cuh, h its pixel half
  template <int K>
  __device__ __forceinline__ void store(size_t pix, int c0, const float (&acc)[2 * K], int h,
                                        const Run<K>& r, const float (&bias)[K]) const {
    constexpr int U = Run<K>::U;
    T* d = dst + pix * dst_stride + dst_off + c0;
#pragma unroll
    for (int u = 0; u < K / U; ++u) {
      if (c0 + U * u >= cout_) break;
      uint32_t out[U / 2];
#pragma unroll
      for (int i = 0; i < U / 2; ++i) {
        const int k = U / 2 * u + i;
        const Pair<T> o = value(c0 + 2 * k, acc[4 * k + 2 * h] + bias[2 * k],
                                acc[4 * k + 2 * h + 1] + bias[2 * k + 1], r.p[k]);
        out[i] = *reinterpret_cast<const uint32_t*>(&o.v);
      }
      if constexpr (U == 8)
        *reinterpret_cast<uint4*>(d + U * u) = make_uint4(out[0], out[1], out[2], out[3]);
      else
#pragma unroll
        for (int i = 0; i < U / 2; ++i) reinterpret_cast<uint32_t*>(d + U * u)[i] = out[i];
    }
  }

 private:
  // U channels (a multiple of 2) at p into the member `f` of U / 2 Pres
  template <int U>
  __device__ __forceinline__ static void copy_run(Pre* dst_p, Pair<T> Pre::*f, const T* p) {
    static_assert(sizeof(T) == 2, "the TMA conv is bf16");
    if constexpr (U == 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(p);
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) (dst_p[i].*f).v = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    } else {
#pragma unroll
      for (int i = 0; i < U / 2; ++i) dst_p[i].*f = load2(p + 2 * i);
    }
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
    epi.res = res;
    epi.res_scale = res_scale;
    epi.ctot = ctot; epi.nf = nf; epi.gc = gc; epi.cout_ = g.cout;
    epi.x2_off = nf + gc;
    if (c < 5) {
      epi.dst = ws; epi.dst_stride = ctot; epi.dst_off = nf + (c - 1) * gc;
    } else {
      epi.dst = dst; epi.dst_stride = dst_stride; epi.dst_off = 0;
    }
    epi.kind = c == 5 ? (res != nullptr ? EPI_RRDB : EPI_RESIDUAL)
               : (plus && (c == 2 || c == 4)) ? EPI_ACT_ADD : EPI_ACT;
    cudaError_t e;
    if (plus && c == 2) {
      const size_t n = (size_t)B * H * W * gc;
      conv1x1_into<T><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(x, xs, w1, ws, ctot, nf + gc,
                                                                 nf, gc, (size_t)B * H * W);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
    if constexpr (sizeof(T) == 2)
      e = conv3x3::launch_tma(g, w + woff, epi, s);
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
