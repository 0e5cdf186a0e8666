// Fused CycleGAN ResnetBlock forward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel innfer_tpu/ops/pallas/resnet_block.py::
// fused_resnet_block and computes the same function, with the same
// rounding points (resnet_block.py:88-103):
//   h1  = cast(ReLU(IN(conv3x3(reflpad(x)) + b1)))
//   h2  = cast(IN(conv3x3(reflpad(h1)) + b2))
//   out = cast(fp32(x) + fp32(h2))
// The conv sum plus bias goes into the instance norm in fp32, unrounded.
// IN is per (image, channel) over H x W: biased variance, eps, no affine,
// mean and centred variance (never sum of squares minus squared sum).
//
// Bound at the CycleGAN path's shape, one call on a group of 8 tiles of
// 552x256 (slab (8, 138, 64, 256) bf16): 2 x 589,824 MAC per pixel over
// 70,656 pixels = 166.7 GFLOP, 0.17 ms at the H100's 989 TFLOP/s bf16
// tensor rate; x in and out are 72 MB (0.02 ms at 3.35 TB/s).
// Compute-bound.
//
// Design.  The TPU kernel keeps a whole slab in VMEM; on the card one slab
// is 4.5 MB, far past a block's 227 KB of shared memory, and IN reduces
// over the whole plane.  So the block is six launches on PyTorch's stream:
//   conv1 -> merge -> normalize+ReLU (h1) -> conv2 -> merge -> normalize+residual.
// In bf16 the conv is conv3x3_tc.cuh's wgmma implicit GEMM with N = all C
// (256) output channels per block, so the halo is staged once per tile
// (the FFMA conv, run on bf16 at 25.7 TFLOP/s on an H100 or 2.6% of the
// bound, staged it once per 32 channels, synchronously, in fp32).  Reflect padding comes
// from reflected source indices in the cp.async staging.  Its epilogue
// writes the fp32 pre-norm sum to a scratch tensor and, per tile and
// channel, the tile's pixel count, mean and centred M2; a small pass
// merges a plane's tiles in a fixed order with Chan's formula (in_merge), so the
// statistics are deterministic and the pre-norm sum is read once (by the
// normalize pass), not three times.  In fp32 (the parity path) the conv is
// the FFMA direct conv and the statistics a two-pass reduction over the
// scratch (one block per image and 32 channels, fixed order).  h1 lives in
// the output buffer until the last pass overwrites it with the output.
//
// Gate (checked by the wrapper, ops/resnet_block.py): H, W >= 2 (reflect
// needs two rows and columns), C % 32 == 0, fp32 or bf16.  No limit on
// H*W or on W % 16 (those were the TPU's VMEM and layout limits).
//
// Left on the table: conv3x3_tc.cuh's list, and here normalizing h1 in
// conv2's staging instead of a separate pass, and keeping the pre-norm
// sum in bf16 pairs or on chip (its 72 MB fp32 round trip per conv).
#include "conv3x3_tc.cuh"

namespace {

using conv3x3::from_f;
using conv3x3::to_f;

constexpr int ST_CH = 32;                 // channels per stats block (fp32)
constexpr int ST_LANES = 32;              // pixel lanes per stats block
constexpr int MG_CH = 32;                 // channels per merge block
constexpr int MG_LANES = 8;               // tile lanes per merge block
constexpr int EW_THREADS = 256;           // elementwise passes

// The conv epilogue: the fp32 pre-norm sum (conv + bias) into acc; with
// the wgmma conv also each tile's per-channel count, mean and M2.
struct InEpi {
  static constexpr bool kStats = true;
  float* acc;    // (B, H, W, C)
  float* part;   // [2][B][tiles][C]: tile mean, tile M2
  float* cnt;    // [B][tiles]
  int C;
  size_t nparts; // B * tiles * C

  __device__ __forceinline__ void operator()(size_t pix, int co, float v0, float v1) const {
    conv3x3::store2(acc + pix * C + co, v0, v1);
  }
  __device__ __forceinline__ void stats(int b, int tile, int tiles, int co, float mean,
                                        float m2, float n) const {
    const size_t i = ((size_t)b * tiles + tile) * C + co;
    part[i] = mean;
    part[nparts + i] = m2;
    if (co == 0) cnt[(size_t)b * tiles + tile] = n;
  }
};

// Chan's update of (n, mean, M2) with a part (nb, mb, m2b), nb > 0
__device__ __forceinline__ void chan(float& n, float& mu, float& m2, float nb, float mb,
                                     float m2b) {
  const float nab = n + nb, d = mb - mu;
  mu += d * (nb / nab);
  m2 += m2b + d * d * (n * nb / nab);
  n = nab;
}

// Per (image, channel): merge the tiles' (n, mean, M2) with Chan's formula
// in a fixed order -- lane l merges tiles l, l + MG_LANES, ... in turn,
// then the lanes are merged in lane order -- and write the mean and
// 1/sqrt(var + eps).  Grid (C / MG_CH, B); block (MG_CH, MG_LANES).
__global__ void __launch_bounds__(MG_CH * MG_LANES)
in_merge(const float* __restrict__ part, const float* __restrict__ cnt, float* __restrict__ mean,
         float* __restrict__ rstd, int C, int tiles, size_t nparts, float eps) {
  __shared__ float red[3][MG_LANES][MG_CH];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * MG_CH + tx;
  const int b = blockIdx.y;
  float n = 0.f, mu = 0.f, m2 = 0.f;
  for (int t = ty; t < tiles; t += MG_LANES) {
    const size_t i = ((size_t)b * tiles + t) * C + c;
    chan(n, mu, m2, cnt[(size_t)b * tiles + t], part[i], part[nparts + i]);
  }
  red[0][ty][tx] = n;
  red[1][ty][tx] = mu;
  red[2][ty][tx] = m2;
  __syncthreads();
  if (ty == 0) {
    for (int l = 1; l < MG_LANES; ++l)
      if (red[0][l][tx] > 0.f) chan(n, mu, m2, red[0][l][tx], red[1][l][tx], red[2][l][tx]);
    mean[(size_t)b * C + c] = mu;
    rstd[(size_t)b * C + c] = 1.0f / sqrtf(m2 / n + eps);
  }
}

// Per (image, channel): mean and 1/sqrt(var + eps) of acc over the H*W
// pixels, two-pass (the fp32 path).  Grid (C / ST_CH, B); block (ST_CH
// channels, ST_LANES pixel lanes); the lanes' partial sums are added in a
// fixed order.
__global__ void __launch_bounds__(ST_CH * ST_LANES)
in_stats(const float* __restrict__ acc, float* __restrict__ mean,
         float* __restrict__ rstd, int HW, int C, float eps) {
  __shared__ float red[ST_LANES][ST_CH];
  __shared__ float mu_s[ST_CH];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * ST_CH + tx;
  const int b = blockIdx.y;
  const float* base = acc + (size_t)b * HW * C + c;

  float s = 0.f;
#pragma unroll 4
  for (int p = ty; p < HW; p += ST_LANES) s += base[(size_t)p * C];
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0) {
    float t = 0.f;
    for (int k = 0; k < ST_LANES; ++k) t += red[k][tx];
    mu_s[tx] = t / HW;
  }
  __syncthreads();
  const float mu = mu_s[tx];
  float q = 0.f;
#pragma unroll 4
  for (int p = ty; p < HW; p += ST_LANES) {
    const float d = base[(size_t)p * C] - mu;
    q += d * d;
  }
  red[ty][tx] = q;
  __syncthreads();
  if (ty == 0) {
    float t = 0.f;
    for (int k = 0; k < ST_LANES; ++k) t += red[k][tx];
    mean[(size_t)b * C + c] = mu;
    rstd[(size_t)b * C + c] = 1.0f / sqrtf(t / HW + eps);
  }
}

// RESIDUAL false: dst = cast(ReLU((acc - mean) * rstd))        (h1)
// RESIDUAL true:  dst = cast(fp32(x) + fp32(cast((acc - mean) * rstd)))
// Four channels per thread and step (C % 4 == 0): 16-byte loads of acc.
template <typename T, bool RESIDUAL>
__global__ void __launch_bounds__(EW_THREADS)
in_apply(const float* __restrict__ acc, const float* __restrict__ mean,
         const float* __restrict__ rstd, const T* __restrict__ x, T* __restrict__ dst,
         size_t n, size_t hwc, int C) {
  for (size_t i = ((size_t)blockIdx.x * EW_THREADS + threadIdx.x) * 4; i < n;
       i += (size_t)gridDim.x * EW_THREADS * 4) {
    const size_t bc = (i / hwc) * C + i % C;
    const float4 a = *reinterpret_cast<const float4*>(acc + i);
    const float av[4] = {a.x, a.y, a.z, a.w};
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = (av[e] - mean[bc + e]) * rstd[bc + e];
      o[e] = RESIDUAL ? to_f<T>(x[i + e]) + to_f<T>(from_f<T>(v)) : fmaxf(v, 0.f);
    }
    conv3x3::store2(dst + i, o[0], o[1]);
    conv3x3::store2(dst + i + 2, o[2], o[3]);
  }
}

// Floats of the stats scratch: mean and rstd (2*B*C), and for the wgmma
// conv the tiles' partials (2*B*tiles*C) and counts (B*tiles).
size_t stats_floats(int B, int H, int W, int C, int dtype) {
  const size_t tiles = dtype == 1 ? conv3x3::wgmma_tiles(H, W, C) : 0;
  return 2 * (size_t)B * C + 2 * (size_t)B * tiles * C + (size_t)B * tiles;
}

template <typename T>
cudaError_t run_block(const T* x, T* out, float* acc, float* stats, const T* w1,
                      const float* b1, const T* w2, const float* b2, int B, int H,
                      int W, int C, float eps, cudaStream_t s) {
  const size_t n = (size_t)B * H * W * C, hwc = (size_t)H * W * C;
  const size_t want = (n / 4 + EW_THREADS - 1) / EW_THREADS;
  const int ew_grid = (int)(want < 132 * 32 ? want : 132 * 32);
  const int tiles = conv3x3::wgmma_tiles(H, W, C);
  float* mean = stats;
  float* rstd = stats + (size_t)B * C;
  InEpi epi;
  epi.acc = acc;
  epi.part = stats + 2 * (size_t)B * C;
  epi.nparts = (size_t)B * tiles * C;
  epi.cnt = epi.part + 2 * epi.nparts;
  epi.C = C;
  const T* srcs[2] = {x, out};
  const T* ws[2] = {w1, w2};
  const float* bs[2] = {b1, b2};
  for (int k = 0; k < 2; ++k) {
    conv3x3::Geom g;
    g.src = srcs[k];
    g.head = nullptr;
    g.head_stride = g.head_ch = 0;
    g.bias = bs[k];
    g.B = B; g.H = H; g.W = W;
    g.ctot = g.cin = g.cout = C;
    cudaError_t e;
    if constexpr (sizeof(T) == 2) {
      e = conv3x3::launch_wgmma<conv3x3::ReflectPad>(g, ws[k], epi, s);
      if (e != cudaSuccess) return e;
      in_merge<<<dim3(C / MG_CH, B), dim3(MG_CH, MG_LANES), 0, s>>>(
          epi.part, epi.cnt, mean, rstd, C, tiles, epi.nparts, eps);
    } else {
      e = conv3x3::launch_ffma<T, conv3x3::ReflectPad>(g, ws[k], epi, s);
      if (e != cudaSuccess) return e;
      in_stats<<<dim3(C / ST_CH, B), dim3(ST_CH, ST_LANES), 0, s>>>(acc, mean, rstd, H * W, C,
                                                                    eps);
    }
    if (k == 0)
      in_apply<T, false><<<ew_grid, EW_THREADS, 0, s>>>(acc, mean, rstd, x, out, n, hwc, C);
    else
      in_apply<T, true><<<ew_grid, EW_THREADS, 0, s>>>(acc, mean, rstd, x, out, n, hwc, C);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Floats the `stats` scratch of innfer_resnet_block_forward must hold.
long long innfer_resnet_block_stats_floats(int B, int H, int W, int C, int dtype) {
  return (long long)stats_floats(B, H, W, C, dtype);
}

// One ResnetBlock forward on `stream`.  x, out: (B, H, W, C) NHWC; acc:
// (B, H, W, C) fp32 scratch; stats: fp32 scratch of
// innfer_resnet_block_stats_floats floats; w1, w2: conv weights in
// conv3x3_tc.cuh's packed layout, in the activation dtype; b1, b2: (C,)
// fp32 (zeros for a bias-free conv).  dtype 0 = fp32, 1 = bf16 (bf16
// pointers 16-byte aligned).  Returns the first CUDA error (cudaSuccess = 0).
int innfer_resnet_block_forward(const void* x, void* out, float* acc, float* stats,
                                const void* w1, const float* b1, const void* w2,
                                const float* b2, int B, int H, int W, int C, float eps,
                                int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    using T = __nv_bfloat16;
    return run_block<T>(static_cast<const T*>(x), static_cast<T*>(out), acc, stats,
                        static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2, B, H, W,
                        C, eps, s);
  }
  return run_block<float>(static_cast<const float*>(x), static_cast<float*>(out), acc, stats,
                          static_cast<const float*>(w1), b1, static_cast<const float*>(w2), b2,
                          B, H, W, C, eps, s);
}

const char* innfer_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
