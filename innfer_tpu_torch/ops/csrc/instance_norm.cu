// Instance norm + ReLU on a conv's fp32 accumulator, for NVIDIA Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves instance norm to XLA
// (innfer_tpu/nn/functional.py::instance_norm).  It serves the five plain
// convs of the CycleGAN generator (models/resnet.py), each followed by
// ReLU(IN(.)), and computes, for an NHWC fp32 accumulator acc that already
// holds the conv's fp32 bias, what the model's plain composition
// relu(instance_norm(acc.to(bf16))) computes:
//   x    = bf16(acc)                        one rounding, to nearest even
//   mean, var over H x W per (image, channel), in fp32 of the rounded x,
//        biased variance
//   out  = bf16((x - mean) * rsqrt(var + eps)), then ReLU
//
// Bound: bytes.  It does no more than a few operations per element, so
// the least time is the fp32 accumulator read once and the bf16 output
// written once at 3.35 TB/s: 434 MB, 0.130 ms, at a group of 8 tiles of
// 552x256 with 64 channels.  The plain composition moves about 31 times
// the output's bytes through a dozen ATen passes (a cast, float copies,
// two means, two centrings, a multiply, a cast back, the ReLU).
//
// Design: two launches on PyTorch's stream, 2 reads of fp32 and 1 write of
// bf16 (the second read cannot stay in the 50 MB L2 at that shape, so the
// kernel can reach at most 60% of the bound above).
//   instnorm_stats  grid (chunks, B): each block walks a contiguous chunk
//             of one image's pixels; a thread reads 8 channels of a pixel as
//             two 16-byte loads (a pixel's channels are contiguous) and keeps
//             a Welford (count, mean, M2) per channel; the block merges its
//             pixel lanes by Chan's formula over all parts, mean = sum n_l
//             mean_l / n and M2 = sum M2_l + n_l (mean_l - mean)^2, and
//             writes the chunk's (mean, M2).  Never a sum of squares: a
//             conv's bias can make the mean large against the spread.
//   instnorm_apply  grid (chunks, B): each block merges its image's chunks
//             the same way, in a fixed order (so every block, and every
//             run, agrees), then walks its chunk backwards, so it first
//             reads the pixels that instnorm_stats read last and L2 may
//             still hold, and writes bf16.
// (The names keep clear of resnet_block.cu's in_stats and in_apply, which
// the benchmark counts as that kernel's.)
// The merges run in double: the threads' fp32 rounding errors then average
// out, and the mean lands within about half an fp32 ulp, where a chain of
// fp32 merges drifts by several ulps of a mean of 40 and flips roundings.
// Chunks: about 4 blocks per SM of an H100 over the whole tensor (one
// wave), and at least 4 pixels per lane.  On an H100 80GB HBM3 at 700 W a
// call at (8, 552, 256, 64) takes 0.25 ms, 52% of the bound (statistics
// 0.106 ms, normalization 0.149 ms); streaming loads (__ldcs) on the second
// read, a forward walk, two waves of blocks or 4 pixels a load ran 2-25%
// slower.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;              // channels per thread: two float4 loads
constexpr int MAX_C = 4 * THREADS;  // instnorm_apply's shared memory well within 48 KB
constexpr int TARGET_BLOCKS = 4 * 132;
constexpr int MIN_LANE_PX = 4;
constexpr int UNROLL = 2;           // pixels a thread loads before it updates
constexpr int MIN_BLOCKS = 4;       // resident a SM: TARGET_BLOCKS is one wave

__host__ __device__ inline int lanes_for(int C) { return THREADS / (C / VEC); }

__host__ __device__ inline long long chunk_lo(long long P, int nch, int k) {
  return P * k / nch;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void load8(const float* p, float (&v)[VEC]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// part: [B][nch][2][C] doubles, each chunk's mean and M2.
// Dynamic shared memory: lanes * C means, lanes * C M2s, lanes counts.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
instnorm_stats(const float* __restrict__ acc, double* __restrict__ part, int C,
               long long P, int nch) {
  extern __shared__ float sm[];
  const int cg = C / VEC, lanes = lanes_for(C);
  const int tid = threadIdx.x, lane = tid / cg, g = tid % cg;
  const int k = blockIdx.x, b = blockIdx.y;
  const long long lo = chunk_lo(P, nch, k), hi = chunk_lo(P, nch, k + 1);
  float* s_mu = sm;
  float* s_m2 = sm + lanes * C;
  float* s_n = sm + 2 * lanes * C;
  if (lane < lanes) {
    const float* base = acc + ((size_t)b * P) * C + g * VEC;
    float n = 0.f, mu[VEC], m2[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) mu[j] = m2[j] = 0.f;
    for (long long p0 = lo + lane; p0 < hi; p0 += (long long)UNROLL * lanes) {
      float v[UNROLL][VEC];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long p = p0 + (long long)u * lanes;
        if (p < hi) load8(base + (size_t)p * C, v[u]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (p0 + (long long)u * lanes >= hi) break;
        n += 1.f;
        const float inv = __frcp_rn(n);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float x = round_bf16(v[u][j]);
          const float d = x - mu[j];
          mu[j] += d * inv;
          m2[j] += d * (x - mu[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      s_mu[lane * C + g * VEC + j] = mu[j];
      s_m2[lane * C + g * VEC + j] = m2[j];
    }
    if (g == 0) s_n[lane] = n;
  }
  __syncthreads();
  // the chunk's lanes merged by Chan's formula over all parts, in double
  // and lane order: mean = sum n_l mean_l / n, M2 = sum M2_l + n_l (mean_l
  // - mean)^2 (a lane with no pixel adds nothing)
  double* out = part + ((size_t)b * nch + k) * 2 * C;
  const double n = (double)(hi - lo);
  for (int c = tid; c < C; c += THREADS) {
    double sum = 0.0;
    for (int l = 0; l < lanes; ++l) sum += (double)s_n[l] * s_mu[l * C + c];
    const double mean = sum / n;
    double m2 = 0.0;
    for (int l = 0; l < lanes; ++l) {
      const double d = s_mu[l * C + c] - mean;
      m2 += s_m2[l * C + c] + s_n[l] * d * d;
    }
    out[c] = mean;
    out[C + c] = m2;
  }
}

// Dynamic shared memory: R * C doubles of sub-lane sums, C double means and
// nch chunk counts, then C float means and C float rstds, with R = THREADS /
// C sub-lanes a channel (at least 1).
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
instnorm_apply(const float* __restrict__ acc, const double* __restrict__ part,
               __nv_bfloat16* __restrict__ out, float* __restrict__ stats, int C,
               long long P, int nch, float eps, int relu) {
  extern __shared__ double smd[];
  const int R = C >= THREADS ? 1 : THREADS / C;
  const int reds = R * C;
  double* red = smd;
  double* mean_d = smd + reds;
  double* cnt = mean_d + C;
  float* s_mean = reinterpret_cast<float*>(cnt + nch);
  float* s_rstd = s_mean + C;
  const int tid = threadIdx.x, k = blockIdx.x, b = blockIdx.y;
  const double* pb = part + (size_t)b * nch * 2 * C;
  for (int q = tid; q < nch; q += THREADS)
    cnt[q] = (double)(chunk_lo(P, nch, q + 1) - chunk_lo(P, nch, q));
  __syncthreads();
  // the image's chunks merged as instnorm_stats merges lanes, in double:
  // sub-lane r takes chunks r, r + R, ..., then the sub-lanes are added in
  // order (unrolled, a sub-lane's loads are in flight together)
  for (int i = tid; i < reds; i += THREADS) {
    const int c = i % C, r = i / C;
    double sum = 0.0;
#pragma unroll 8
    for (int q = r; q < nch; q += R) sum += cnt[q] * pb[(size_t)q * 2 * C + c];
    red[i] = sum;
  }
  __syncthreads();
  for (int c = tid; c < C; c += THREADS) {
    double sum = 0.0;
    for (int r = 0; r < R; ++r) sum += red[r * C + c];
    mean_d[c] = sum / (double)P;
  }
  __syncthreads();
  for (int i = tid; i < reds; i += THREADS) {
    const int c = i % C, r = i / C;
    const double mean = mean_d[c];
    double m2 = 0.0;
#pragma unroll 8
    for (int q = r; q < nch; q += R) {
      const double d = pb[(size_t)q * 2 * C + c] - mean;
      m2 += pb[(size_t)q * 2 * C + C + c] + cnt[q] * d * d;
    }
    red[i] = m2;
  }
  __syncthreads();
  for (int c = tid; c < C; c += THREADS) {
    double m2 = 0.0;
    for (int r = 0; r < R; ++r) m2 += red[r * C + c];
    const float mean = (float)mean_d[c], var = (float)(m2 / (double)P);
    s_mean[c] = mean;
    s_rstd[c] = rsqrtf(var + eps);
    if (stats != nullptr && k == 0) {
      stats[(size_t)b * 2 * C + c] = mean;
      stats[(size_t)b * 2 * C + C + c] = var;
    }
  }
  __syncthreads();
  const int cg = C / VEC, lanes = lanes_for(C);
  const int lane = tid / cg, g = tid % cg;
  if (lane >= lanes) return;
  float mean[VEC], rstd[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    mean[j] = s_mean[g * VEC + j];
    rstd[j] = s_rstd[g * VEC + j];
  }
  const long long lo = chunk_lo(P, nch, k), hi = chunk_lo(P, nch, k + 1);
  const size_t img = (size_t)b * P;
  const long long steps = (hi - lo - lane + lanes - 1) / lanes;   // this lane's pixels
#pragma unroll 2
  for (long long s = steps - 1; s >= 0; --s) {
    const size_t off = (img + lo + lane + s * lanes) * C + g * VEC;
    float v[VEC];
    load8(acc + off, v);
    uint32_t o[VEC / 2];
#pragma unroll
    for (int j = 0; j < VEC; j += 2) {
      float y0 = (round_bf16(v[j]) - mean[j]) * rstd[j];
      float y1 = (round_bf16(v[j + 1]) - mean[j + 1]) * rstd[j + 1];
      if (relu) {  // as torch.relu: a NaN stays NaN
        if (y0 < 0.f) y0 = 0.f;
        if (y1 < 0.f) y1 = 0.f;
      }
      const __nv_bfloat162 pair = __floats2bfloat162_rn(y0, y1);
      o[j / 2] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    *reinterpret_cast<uint4*>(out + off) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

int chunks_for(int B, long long P, int C) {
  const long long per_image = (TARGET_BLOCKS + B - 1) / B;
  const long long most = P / ((long long)MIN_LANE_PX * lanes_for(C));
  const long long n = per_image < most ? per_image : most;
  return (int)(n < 1 ? 1 : n);
}

}  // namespace

extern "C" {

// Chunks per image, and so doubles of the `part` workspace: B * chunks * 2 * C.
int innfer_instance_norm_chunks(int B, int H, int W, int C) {
  return chunks_for(B, (long long)H * W, C);
}

// acc (B, H, W, C) fp32 -> out (B, H, W, C) bf16; part: the workspace;
// stats: null, or (B, 2, C) fp32 that receives each mean and biased
// variance.  C % 8 == 0, C <= 1024, H * W >= 2, 16-byte aligned pointers
// (checked by the wrapper, ops/instance_norm.py).
int innfer_instance_norm(const void* acc, void* out, void* part, void* stats, int B, int H,
                         int W, int C, float eps, int relu, cudaStream_t stream) {
  if (C % VEC != 0 || C > MAX_C || B < 1 || (long long)H * W < 2)
    return (int)cudaErrorInvalidValue;
  const long long P = (long long)H * W;
  const int nch = chunks_for(B, P, C);
  const int lanes = lanes_for(C);
  const int R = C >= THREADS ? 1 : THREADS / C;
  const size_t stats_smem = (size_t)(2 * lanes * C + lanes) * sizeof(float);
  const size_t apply_smem = (size_t)(R * C + C + nch) * sizeof(double) + 2 * C * sizeof(float);
  const dim3 grid(nch, B);
  instnorm_stats<<<grid, THREADS, stats_smem, stream>>>(
      static_cast<const float*>(acc), static_cast<double*>(part), C, P, nch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  instnorm_apply<<<grid, THREADS, apply_smem, stream>>>(
      static_cast<const float*>(acc), static_cast<const double*>(part),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(stats), C, P, nch, eps, relu);
  return (int)cudaGetLastError();
}

const char* innfer_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
