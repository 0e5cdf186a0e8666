// The SR tail's bf16 3x3 convs for NVIDIA Hopper (sm_90a), with the bias,
// the activation and the next op's layout in the epilogue.
//
// Replaces no TPU kernel: the JAX package leaves these convs to XLA, which
// fuses bias, activation and layout into its conv.  In the port they went
// through the bias route of nn/functional.py (the bf16 input copied to
// fp32, a TF32 cuDNN conv with an fp32 output, a pass rounding it to bf16,
// the activation's passes) and, in phase space, through one merged conv of
// 16/9 the HR conv's operations, cropped four ways and concatenated.
// models/common.py calls this kernel for
//   * the upsample block's conv (collapsed upconv or pixelshuffle, factor
//     2): an LR conv whose 4 * cp outputs are written pixel-shuffled, as
//     NHWC at twice the size (layout SHUFFLE);
//   * the phase tail's first conv: the same conv written phase-major,
//     (B, H, W, 4 * cp) with channel q * cp + o for output phase q = 2 a + c
//     (layout PHASE);
//   * the phase tail's HR conv and conv_last, evaluated on the phase-major
//     grid at the HR conv's own operation count (mode PH, layout PHASE).
// Each output is cast(act(cast(acc + bias))): the fp32 bias added to the
// fp32 accumulator of bf16 products, one rounding to bf16, then LeakyReLU as
// F.leaky_relu computes it in bf16 (the slope bf16(0.2), the product
// rounded) or ReLU.  Only the order of the fp32 sums differs from the
// plain composition.
//
// Bound at the main-path cell (540x960 frames, 4 tiles of 576x256 LR
// pixels, nf = 64): the HR conv and the phase tail's first conv do 0.348
// TMAC each, 0.70 ms apiece at 989 TFLOP/s; each writes (and the next
// reads) a 1.21 GB phase-major bf16 activation, 0.36 ms a pass at 3.35
// TB/s.  Compute-bound, near the ridge; conv_last (cp = 3, padded to 8 a
// phase) is bound by reading its 1.21 GB input once.
//
// Design: conv3x3_tma.cuh's pipeline, shared with conv_tma (init_ring,
// produce, Ring, TileWalk, persistent_grid: a TMA producer thread, an
// mbarrier ring of halo boxes and weight chunks, two wgmma consumer
// warpgroups of R rows, a persistent grid); this file adds mode PH's tap
// loop and the epilogue.  The accumulator columns of a tile are four
// blocks of cpad (8..64) channels, one per output phase q.
//   * Mode PLAIN: conv_tma's GEMM (tap_mmas), in N tiles of NT = min(4
//     cpad, 128) columns: at 4 cpad = 256 two tiles of 2 rows a consumer,
//     where conv_tma's rule (n_tile) takes one of 256 columns and 1 row,
//     and the columns in phase blocks where conv_tma's epilogue wants
//     ops/conv3x3.py::tma_channels' order.
//   * Mode PH: the HR conv of C channels on the phase-major grid.  Output
//     phase (a, c), tap (dy, dx) reads input phase ((a + dy) mod 2,
//     (c + dx) mod 2) at grid offset (floor((a + dy) / 2), floor((c + dx) /
//     2)): a channel slice and a shift of at most one cell.  A chunk is 16
//     channels of one input phase, staged as the plain conv stages them,
//     and 9 of the 36 (output phase, tap) pairs read it (ph_tap): 9 wgmmas
//     of N = cpad, each into its output phase's accumulator, the HR conv's
//     own operations against the merged kernel's 16/9.  The tile holds all
//     four phases (NT = 4 cpad) so that each staged halo serves them all.
//     One wgmma per phase keeps each phase's accumulators an array of its
//     own: wgmmas of 2 or 4 cpad over adjacent phases, fewer and wider,
//     made ptxas serialize the wgmma pipeline (C7511) and ran 11-19% slower
//     on an H100.
// The epilogue hands each lane's column pairs to their phase's channels:
// pairs of channels are adjacent in both layouts (4-byte stores; scalar
// for an odd cp).
//
// Left on the table: the epilogue's stores through shared memory (16-byte
// or TMA stores), fusing the HR conv with conv_last (the 1.21 GB between
// them), multicasting the weights over a cluster (each 2-row tile of the
// cpad = 64 HR conv streams all 295 KB of them from L2), and wider TMA
// rows (16-byte box rows, as in conv3x3_tma.cuh).  A block of 288 threads
// (one producer warp) to raise ptxas's 168 registers a thread was tried:
// ptxas kept 168 and spilled.
#include "conv3x3_tma.cuh"

namespace {

using namespace conv3x3;

enum Act { ACT_NONE = 0, ACT_LRELU = 1, ACT_RELU = 2 };
enum Layout { OUT_PHASE = 0, OUT_SHUFFLE = 1 };

constexpr float SLOPE_BF16 = 0.2001953125f;  // bf16(0.2), the slope F.leaky_relu uses in bf16

// One wgmma of mode PH: output phase q's accumulator, the input at grid
// offset (oy, ox).
struct PhTap {
  int q, oy, ox;
};
// The j-th (of 9) tap (output phase q = 2 a + c, tap (dy, dx)) that reads
// input phase p = 2 pr + pc: (a + dy) mod 2 = pr and (c + dx) mod 2 = pc, at
// grid offset (floor((a + dy) / 2), floor((c + dx) / 2)); by q, dy, dx
// (ops/tail_conv.py::phase_taps is the same list).
__host__ __device__ constexpr PhTap ph_tap(int p, int j) {
  int n = 0;
  for (int q = 0; q < 4; ++q)
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx) {
        const int a = q / 2 + dy + 2, c = q % 2 + dx + 2;  // + 2: non-negative
        if (a % 2 == p / 2 && c % 2 == p % 2 && n++ == j) return {q, a / 2 - 1, c / 2 - 1};
      }
  return {-1, 0, 0};
}

// The stage ring of a tile of NT columns: mode PH stages one weight block
// of NT / 4 columns (one output phase) per tap.
template <int NT, bool PH> using TailCfg = TmaCfg<NT, PH ? NT / 4 : NT>;

struct TailGeom {
  const float* bias;    // ncols, fp32, in column order (zeros at padded columns)
  __nv_bfloat16* out;
  int B, H, W, cin, ncols, cp, act, layout;
};

// The accumulators of a tile's rows: mode PH one array per output phase,
// mode PLAIN one array of the N tile's columns (tap_mmas's).
template <int NT, int R, bool PH> struct Acc {
  using type = float[R][NT / 2];
};
template <int NT, int R> struct Acc<NT, R, true> {
  using type = float[R][4][NT / 8];
};
// Column j of row m.
template <int R, int N>
__device__ __forceinline__ float& col(float (&acc)[R][N], int m, int j) {
  return acc[m][j];
}
template <int R, int L>
__device__ __forceinline__ float& col(float (&acc)[R][4][L], int m, int j) {
  return acc[m][j / L][j % L];
}

// The wgmmas of one chunk of input phase P, tap J onwards: N = CP each, B
// the tap's [half][CP][8] block.
template <int CP, int R, int P, int J = 0>
__device__ __forceinline__ void phase_mmas(float (&acc)[R][4][CP / 2], uint32_t a, uint32_t b,
                                           int row0, int plane) {
  if constexpr (J < 9) {
    constexpr PhTap t = ph_tap(P, J);
    static_assert(t.q >= 0, "nine taps read each input phase");
    const uint64_t db = smem_desc(b + J * CP * KC * 2, CP * 16, 128);
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const uint64_t da =
          smem_desc(a + ((row0 + m + 1 + t.oy) * tma::HP_W + 1 + t.ox) * 16, plane, 128);
      wgmma<CP>(acc[m][t.q], da, db);
    }
    phase_mmas<CP, R, P, J + 1>(acc, a, b, row0, plane);
  }
}

// Mode PH: the n chunks of input phase P, each through the stage ring.
template <int NT, int P>
__device__ __forceinline__ void phase_chunks(typename Acc<NT, tma_rows(NT), true>::type& acc,
                                             Ring<TailCfg<NT, true>>& ring, int n,
                                             uint32_t sbase, uint32_t bars, int row0, int lane) {
  using C = TailCfg<NT, true>;
  for (int k = 0; k < n; ++k) {
    const uint32_t a = ring.acquire(sbase, bars);
    phase_mmas<NT / 4, C::R, P>(acc, a, a + C::A_BYTES, row0, C::PLANE);
    ring.release(bars, lane);
  }
}

// One rounding of the fp32 pair to bf16, then the activation in bf16:
// LeakyReLU as max(r, bf16(r * bf16(0.2))) (the product of two bf16 values
// is exact in fp32, so this is F.leaky_relu's rounded product), ReLU as
// max(r, 0).
__device__ __forceinline__ __nv_bfloat162 round_act(float v0, float v1, int act) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(v0, v1);
  if (act == ACT_LRELU) {
    const float2 f = __bfloat1622float2(r);
    return __hmax2(r, __floats2bfloat162_rn(f.x * SLOPE_BF16, f.y * SLOPE_BF16));
  }
  if (act == ACT_RELU) return __hmax2(r, __float2bfloat162_rn(0.f));
  return r;
}

template <int NT, int CPAD, bool PH>
__global__ void __launch_bounds__(tma::THREADS, 1)
conv_tail(const __grid_constant__ CUtensorMap x_map, TailGeom g,
          const __nv_bfloat16* __restrict__ w) {
  using C = TailCfg<NT, PH>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = (smem_addr(smem) + 127) & ~127u;
  const uint32_t bars = sbase + C::STAGES * C::STAGE;
  const int tid = threadIdx.x;
  const TileWalk walk(g.B, g.H, g.W, g.ncols / NT, C::TH);
  const int nchunks = chunks(g.cin);

  if (tid == 0) init_ring<C>(bars);
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(tma::PRODUCER_REGS));
    if (tid == 0) produce<C>(walk, nchunks, sbase, bars, w, &x_map, &x_map, g.cin, g.cin, g.cin);
  } else {
    // ---- consumer warpgroups: wgmma and the epilogue ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(tma::CONSUMER_REGS));
    const int cw = tid / 128 - 1, warp = (tid % 128) / 32, lane = tid % 32;
    const int per_phase = g.cin / 4 / KC;  // mode PH: chunks of one input phase
    const int row0 = cw * C::R;
    Ring<C> ring;
    for (int t = blockIdx.x; t < walk.count; t += gridDim.x) {
      const TileWalk::Tile tl = walk.at(t, C::TH);
      const int grp = tl.grp, b = tl.b, y0 = tl.y0 + row0, x0 = tl.x0;
      typename Acc<NT, C::R, PH>::type acc;
#pragma unroll
      for (int m = 0; m < C::R; ++m)
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) col(acc, m, j) = 0.f;

      if constexpr (PH) {  // the chunks in order: input phase 0's, 1's, 2's, 3's
        phase_chunks<NT, 0>(acc, ring, per_phase, sbase, bars, row0, lane);
        phase_chunks<NT, 1>(acc, ring, per_phase, sbase, bars, row0, lane);
        phase_chunks<NT, 2>(acc, ring, per_phase, sbase, bars, row0, lane);
        phase_chunks<NT, 3>(acc, ring, per_phase, sbase, bars, row0, lane);
      } else {
        for (int k = 0; k < nchunks; ++k) {
          const uint32_t a = ring.acquire(sbase, bars);
          tap_mmas<NT, C::R>(acc, a, a + C::A_BYTES, row0, C::PLANE);
          ring.release(bars, lane);
        }
      }
      ring.drain(bars, lane);

      // epilogue: thread (warp, lane) holds pixels 16 warp + lane / 4 (+ 8)
      // of each of its rows and columns 8 i + 2 (lane % 4) (+ 1); column n
      // is channel n % CPAD of output phase n / CPAD
      const int lq = 2 * (lane % 4);
#pragma unroll
      for (int m = 0; m < C::R; ++m) {
        const int y = y0 + m;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = x0 + 16 * warp + lane / 4 + 8 * h;
          if (y >= g.H || x >= g.W) continue;
          // where channel 0 of output phase (0, 0) of this pixel goes
          const size_t base = g.layout == OUT_PHASE
                                  ? (((size_t)b * g.H + y) * g.W + x) * 4 * g.cp
                                  : (((size_t)b * 2 * g.H + 2 * y) * 2 * g.W + 2 * x) * g.cp;
#pragma unroll
          for (int i = 0; i < NT / 8; ++i) {
            const int o = (8 * i) % CPAD + lq;
            if (o >= g.cp) continue;
            const int n = grp * NT + 8 * i + lq;
            const int q = n / CPAD;
            const int qoff = g.layout == OUT_PHASE ? q * g.cp : ((q / 2) * 2 * g.W + q % 2) * g.cp;
            const float2 bb = *reinterpret_cast<const float2*>(g.bias + n);
            const __nv_bfloat162 r = round_act(col(acc, m, 4 * i + 2 * h) + bb.x,
                                               col(acc, m, 4 * i + 2 * h + 1) + bb.y, g.act);
            __nv_bfloat16* d = g.out + base + qoff + o;
            if (g.cp % 2 == 0) {
              *reinterpret_cast<__nv_bfloat162*>(d) = r;
            } else {
              d[0] = r.x;
              if (o + 1 < g.cp) d[1] = r.y;
            }
          }
        }
      }
    }
  }
}

template <int NT, int CPAD, bool PH>
cudaError_t launch_tail(const TailGeom& g, const void* x, const __nv_bfloat16* w,
                        cudaStream_t s) {
  static_assert(NT == (PH ? 4 * CPAD : (4 * CPAD < 128 ? 4 * CPAD : 128)), "N tile");
  using C = TailCfg<NT, PH>;
  CUtensorMap map;
  cudaError_t e = tensor_map(&map, x, g.cin, g.cin, g.B, g.H, g.W, C::BOX_ROWS);
  int grid = 0;
  if (e == cudaSuccess)
    e = persistent_grid<KernelTag<TailGeom, Acc<NT, CPAD, PH>>>(
        conv_tail<NT, CPAD, PH>, C::SMEM, TileWalk(g.B, g.H, g.W, g.ncols / NT, C::TH).count,
        &grid);
  if (e != cudaSuccess) return e;
  conv_tail<NT, CPAD, PH><<<grid, tma::THREADS, C::SMEM, s>>>(map, g, w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One tail conv on `stream`.  x: (B, H, W, cin) bf16, 16-byte aligned, cin
// a multiple of 16 (mode PH: 4 C with C a multiple of 16); w: packed by
// ops/tail_conv.py (ncols = 4 cpad columns, cpad in {8, 16, 32, 64});
// bias: ncols fp32; cp <= cpad real channels a phase.  out: layout 0
// (B, H, W, 4 cp) phase-major, 1 (B, 2 H, 2 W, cp).  act: 0 none, 1
// LeakyReLU 0.2, 2 ReLU.  Returns the first CUDA error (0 = success).
int innfer_tail_conv(const void* x, const void* w, const float* bias, void* out, int B, int H,
                     int W, int cin, int ncols, int cp, int phase, int act, int layout,
                     void* stream) {
  TailGeom g;
  g.bias = bias;
  g.out = static_cast<__nv_bfloat16*>(out);
  g.B = B; g.H = H; g.W = W;
  g.cin = cin; g.ncols = ncols; g.cp = cp;
  g.act = act; g.layout = layout;
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto s = static_cast<cudaStream_t>(stream);
  if (phase) {
    switch (ncols) {
      case 32: return launch_tail<32, 8, true>(g, x, wb, s);
      case 64: return launch_tail<64, 16, true>(g, x, wb, s);
      case 128: return launch_tail<128, 32, true>(g, x, wb, s);
      case 256: return launch_tail<256, 64, true>(g, x, wb, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (ncols) {
    case 32: return launch_tail<32, 8, false>(g, x, wb, s);
    case 64: return launch_tail<64, 16, false>(g, x, wb, s);
    case 128: return launch_tail<128, 32, false>(g, x, wb, s);
    case 256: return launch_tail<128, 64, false>(g, x, wb, s);
    default: return cudaErrorInvalidValue;
  }
}

// The dynamic shared memory (bytes) of the kernel for ncols columns, for
// the build report.
int innfer_tail_conv_smem_bytes(int ncols, int phase) {
  switch (ncols) {
    case 32: return phase ? TailCfg<32, true>::SMEM : TailCfg<32, false>::SMEM;
    case 64: return phase ? TailCfg<64, true>::SMEM : TailCfg<64, false>::SMEM;
    case 128: return phase ? TailCfg<128, true>::SMEM : TailCfg<128, false>::SMEM;
    case 256: return phase ? TailCfg<256, true>::SMEM : TailCfg<128, false>::SMEM;
    default: return 0;
  }
}

const char* innfer_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
