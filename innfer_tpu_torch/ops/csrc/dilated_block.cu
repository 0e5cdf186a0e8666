// PPON's _ResBlock_32 (the dilated multi-rate block) for NVIDIA Hopper
// (sm_90a), in bf16 with fp32 accumulation.
//
// Replaces no TPU kernel: the JAX package leaves the block to XLA's convs
// (innfer_tpu/models/ppon.py::_res_block_32; its Pallas version was
// retired).  One block of x (B, H, W, 64) computes, at the rounding points
// of the plain path in models/ppon.py::_res_block_32:
//   h   = lrelu(cast(conv3x3(x; c1) + b1))                       64 ch.
//   v_r = cast(conv3x3_dilated(h, r; d_r) + b_r)                 32 ch, r = 1..8
//   s_1 = v_1, s_r = cast(s_{r-1} + v_r)                         the cascade
//   o   = cast(conv1x1(lrelu(cat(s_1..s_8)); c2) + b2)           64 ch.
//   y   = cast(x + cast(o * 0.2))      (the RRBlock's last: then cast(cast(y * 0.2) + x_in))
// Each conv's fp32 sum plus its fp32 bias is rounded to bf16 once; the
// cascade's adds, the LeakyReLUs (slope bf16(0.2), the product rounded)
// and both 0.2 residuals are bf16 arithmetic, as PyTorch does them on bf16
// tensors.  Only the order of each conv's fp32 sums differs from the plain
// path.
//
// Bound at the PPON cell's trunk (one 540x960 frame, 84 blocks): 200,704
// MACs per pixel (36,864 c1, 147,456 the eight dilated convs, 16,384 c2),
// 0.208 TFLOP and 0.210 ms per block at 989 TFLOP/s; x in, out and 0.40 MB
// of weights are 0.133 GB, 0.040 ms at 3.35 TB/s.  Compute-bound.
//
// Design: rdb.cu's workspace pattern, three launches a block, each a TMA
// producer thread, an mbarrier ring, two wgmma consumer warpgroups and a
// persistent grid (conv3x3_tma.cuh's init_ring, Ring, persistent_grid):
//   * dilated_block_c1: conv_tma's pipeline and tile loop (produce,
//     TileWalk, tap_mmas), N = 64 on 8-row tiles, its epilogue the bias, one
//     rounding and the LeakyReLU, into h (B, H, W, 64);
//   * dilated_block_rates: the eight dilated convs, N = 32 each, in one
//     launch over a halo staged once a tile: 16 x 24 output pixels, their
//     32 x 40-pixel halo of all 64 channels as one TMA box in 128-byte
//     swizzled rows, which every dilation's taps address by descriptor
//     offsets (wgmma blocks of 8 x 8 pixels); only the weights stream,
//     through a ring of seven 9 KB stages.  The running sum stays in the
//     consumer's registers, as bf16, across the eight; each dilation's
//     epilogue stores lrelu(s_r), the only form c2 reads, into its
//     32-channel slice of a (B, H, W, 256) workspace: the concat exists only
//     as that workspace;
//   * dilated_block_fuse: c2, a 1x1 GEMM of K = 256 (memory-bound: it
//     reads 512 bytes a pixel for 16 K MACs) on mma.sync, A straight from
//     the workspace into registers; its epilogue applies the 0.2 residual
//     and, with res, the RRBlock's.
// The wgmma epilogues hold K = N / 4 consecutive channels a lane
// (ops/conv3x3.py::tma_channels order) and move them in 16-byte pieces;
// c2's K and N orders are permuted the same way (dilated_block.py packs
// its weights), so a lane loads and stores 16-byte pieces too.  Each
// output's sums are taken in one order whichever block computes it.
//
// What the dilated convs stage a call at (1, 576, 960, 64): before, 8 x 64
// tiles restaging h for each dilation through its own box of 8 + 2 r rows
// x 64 + 2 r columns in 8-channel (16-byte) box rows: 1.396 GB of halo in
// 87.2 M box rows and 0.319 GB of weights over 1080 tiles, 1.714 GB.  Now,
// 1440 tiles of 16 x 24: 0.236 GB of halo in 1.84 M 128-byte box rows and
// 0.425 GB of weights in 9,216-byte bulk copies, 0.661 GB.
//
// Tried on an H100 (ms of the eight dilated convs a block at (1, 576, 960,
// 64), CUDA events; outputs bit-equal to the earlier design's): the
// earlier design, 1.087-1.100; this staging on 16 x 32 tiles (four blocks a
// warpgroup, three weight stages) 0.534-0.557, on 16 x 16 tiles (eight
// stages) 0.390-0.399, on 16 x 24 tiles 0.375-0.384 (four or five stages
// alike); an L2 prefetch of each block's next halo cost 0.014-0.023; the
// next dilation's first chunk issued before each epilogue (two accumulator
// sets) 0.381, the same; the halo in two boxes, dilation 1's rows first,
// and a bottom-up tile walk, both within 0.003.  As diagnostics, skipping
// the workspace stores saved 0.019 and loading each block's halo once 0.029.
// The eight convs now run at 43% of the tensor rate; what bounds them is
// shared memory: an m64n32k16 wgmma reads 2 KB of A and 1 KB of B for 16
// cycles of tensor work, 192 bytes a cycle against the 128 an SM reads,
// so at most 67% (0.25 ms).
//
// Left on the table: A from registers, shared by the taps whose windows
// coincide (dilation 8's columns: 5 distinct of 9 a row of taps); the
// weights multicast over a cluster of two (now the larger half of the
// bytes staged); c2 fed the dilated convs' results from registers (its N =
// 64 accumulator beside theirs leaves 2 rows a warpgroup).
#include "conv3x3_tma.cuh"

namespace {

using namespace conv3x3;

constexpr float SLOPE_BF16 = 0.2001953125f;  // bf16(0.2): F.leaky_relu's and res_scale's
constexpr int NF = 64, GC = 32, RATES = 8, CAT = RATES * GC;

__device__ __forceinline__ float lo(__nv_bfloat162 v) { return __low2float(v); }
__device__ __forceinline__ float hi(__nv_bfloat162 v) { return __high2float(v); }

// LeakyReLU in bf16 as F.leaky_relu: max(r, bf16(r * bf16(0.2))) (the
// product of two bf16 values is exact in fp32, so this is its rounding).
__device__ __forceinline__ __nv_bfloat162 lrelu2(__nv_bfloat162 r) {
  return __hmax2(r, __floats2bfloat162_rn(lo(r) * SLOPE_BF16, hi(r) * SLOPE_BF16));
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

// c1's epilogue: the bias, one rounding, the LeakyReLU, into h.
struct ConvEpi {
  __nv_bfloat16* dst;  // (B, H, W, 64)
};

using C1Cfg = TmaCfg<NF, NF>;

// c1 (3x3, 64 -> 64) over (B, H, W): conv_tma's pipeline and tile loop with
// ConvEpi's epilogue, under a kernel name of the block's own (the roofline
// readers tell kernels apart by name).
__global__ void __launch_bounds__(tma::THREADS, 1)
dilated_block_c1(const __grid_constant__ CUtensorMap map, Geom g,
                 const __nv_bfloat16* __restrict__ w, ConvEpi epi) {
  using C = C1Cfg;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = (smem_addr(smem) + 127) & ~127u;
  const uint32_t bars = sbase + C::STAGES * C::STAGE;
  const int tid = threadIdx.x;
  const TileWalk walk(g, C::TH);
  const int nchunks = chunks(g.cin);

  if (tid == 0) init_ring<C>(bars);
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(tma::PRODUCER_REGS));
    if (tid == 0) produce<C>(walk, nchunks, sbase, bars, w, &map, &map, g.cin, g.cin, g.cin);
  } else {
    // ---- consumer warpgroups: wgmma and the epilogue ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(tma::CONSUMER_REGS));
    const int cw = tid / 128 - 1, warp = (tid % 128) / 32, lane = tid % 32;
    // lane (lane % 4) holds K consecutive channels from c0 (tma_channels)
    constexpr int K = NF / 4;
    const int c0 = K * (lane % 4);
    float bias[K];
#pragma unroll
    for (int i = 0; i < K; ++i) bias[i] = g.bias[c0 + i];
    Ring<C> ring;
    for (int t = blockIdx.x; t < walk.count; t += gridDim.x) {
      const TileWalk::Tile tl = walk.at(t, C::TH);
      const int y0 = tl.y0 + cw * C::R, x0 = tl.x0;
      float acc[C::R][NF / 2];
#pragma unroll
      for (int m = 0; m < C::R; ++m)
#pragma unroll
        for (int j = 0; j < NF / 2; ++j) acc[m][j] = 0.f;

      for (int k = 0; k < nchunks; ++k) {
        const uint32_t a = ring.acquire(sbase, bars);
        tap_mmas<NF, C::R>(acc, a, a + C::A_BYTES, cw * C::R, C::PLANE);
        ring.release(bars, lane);
      }
      ring.drain(bars, lane);

      // epilogue: thread (warp, lane) holds pixels 16 warp + lane / 4 (+ 8)
      // of each of its rows; channel c0 + c of pixel half h is accumulator
      // column 4 (c / 2) + 2 h + c % 2.  Every value is rounded first (the
      // accumulators die), then every store is issued.
      uint32_t v[C::R][2][K / 2];
#pragma unroll
      for (int m = 0; m < C::R; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < K / 2; ++i)
            v[m][h][i] = as_u32(lrelu2(__floats2bfloat162_rn(
                acc[m][4 * i + 2 * h] + bias[2 * i], acc[m][4 * i + 2 * h + 1] + bias[2 * i + 1])));
      const size_t img = (size_t)tl.b * g.H * g.W;
#pragma unroll
      for (int m = 0; m < C::R; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int y = y0 + m, x = x0 + 16 * warp + lane / 4 + 8 * h;
          if (y >= g.H || x >= g.W) continue;
          uint4* d = reinterpret_cast<uint4*>(epi.dst + (img + (size_t)y * g.W + x) * NF + c0);
#pragma unroll
          for (int u = 0; u < K / 8; ++u)
            d[u] = make_uint4(v[m][h][4 * u], v[m][h][4 * u + 1], v[m][h][4 * u + 2],
                              v[m][h][4 * u + 3]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// The eight dilated convs in one persistent launch, over a halo staged once a
// tile.  A tile is 16 rows x 24 columns of one image.  Its halo for the widest
// dilation (8 pixels each side: 32 x 40 pixels, 163,840 bytes) is one TMA box
// of all 64 channels, each pixel one 128-byte row of the 128-byte swizzled
// layout, and it stays in shared memory while dilations 1..8 run over it in
// turn; the box's zero fill is every dilation's padding.  A wgmma's 64 rows
// are an 8 x 8 block of output pixels: 8 consecutive pixels of an image row
// are one core matrix (the swizzle atom's 8 rows), the block's 8 image rows
// lie one halo row (the descriptor's SBO) apart, a tap (dy, dx) of dilation r
// moves the descriptor's start by r (40 dy + dx) pixels, and a 16-channel
// chunk is a 32-byte step along the pixel's row.  Consumer warpgroup c
// computes rows 8 c .. 8 c + 7 of the tile as three blocks (columns 0, 8,
// 16).  Only the weights stream: each dilation's four chunks (9,216 bytes
// each) through a ring of the stages the halo leaves room for (seven).  Each
// consumer thread keeps its pixels' running sum in registers (bf16, as the
// plain path holds it) and stores lrelu(s_r), the only form c2 reads, into
// the workspace's slice r.
constexpr int RATE_TH = 16, RATE_TW = 24;  // tile rows, columns
constexpr int RATE_BLOCKS = RATE_TW / 8;   // 8 x 8 output blocks a consumer warpgroup
constexpr int HALO_ROWS = RATE_TH + 2 * RATES, HALO_COLS = RATE_TW + 2 * RATES;
constexpr int PX_BYTES = NF * 2;           // a staged pixel: one swizzled 128-byte row
constexpr int ROW_BYTES = HALO_COLS * PX_BYTES;  // a halo row: the blocks' SBO
constexpr int HALO_BYTES = HALO_ROWS * ROW_BYTES;
constexpr int RATE_BARS = 2 * tma::MAX_STAGES * 8 + 16;  // the ring's full[], empty[]; the halo's

struct RateRing {  // the weight ring: one 16-channel chunk of one dilated conv a stage
  static constexpr int STAGE = 9 * KC * GC * 2;
  static constexpr int FIT = (tma::SMEM_MAX - 1024 - HALO_BYTES - RATE_BARS) / STAGE;
  static constexpr int STAGES = FIT < tma::MAX_STAGES ? FIT : tma::MAX_STAGES;
};
// 1024: slack to align the halo to a swizzle atom; the ring and the barriers follow it
constexpr int RATE_SMEM = 1024 + HALO_BYTES + RateRing::STAGES * RateRing::STAGE + RATE_BARS;
static_assert(RateRing::STAGES >= 4 && RATE_SMEM <= tma::SMEM_MAX, "shared memory");
static_assert(HALO_ROWS <= 256 && HALO_COLS <= 256 && ROW_BYTES % 1024 == 0,
              "TMA box; each halo row starts a swizzle atom");

struct RateArgs {
  const float* bias;  // d1..d8's biases, 8 x 32 fp32
  __nv_bfloat16* ws;  // (B, H, W, 256): lrelu(s_r) in channels 32 (r - 1) ..
  int B, H, W;
};

struct RateWalk {  // the row-major order of the 16 x 24 tiles: image, tile row, tile column
  int tx_n, per_img, count;
  __host__ __device__ RateWalk(int B, int H, int W)
      : tx_n((W + RATE_TW - 1) / RATE_TW),
        per_img(tx_n * ((H + RATE_TH - 1) / RATE_TH)),
        count(B * per_img) {}
  __device__ TileWalk::Tile at(int t) const {
    const int ti = t % per_img;
    return {0, t / per_img, ti / tx_n * RATE_TH, ti % tx_n * RATE_TW};
  }
};

// The descriptor of a K-major wgmma operand in the 128-byte swizzled layout
// (layout type 1): core matrices of 8 rows of 128 bytes, sbo bytes apart,
// LBO unused, base offset 0.  The card swizzles by the address's bits, so a
// start at any 128-byte row of an atom reads as TMA wrote it (a base offset
// of (addr >> 7) & 7, as PTX describes it, gave wrong sums on an H100).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// One chunk's 27 wgmmas of dilation DIL for a consumer warpgroup: tap (ky,
// kx) of block j reads the halo DIL (40 (ky - 1) + kx - 1) + 8 j pixels past
// a, the warpgroup's first output pixel in the halo plus the chunk's 32
// bytes (so each descriptor is da plus a constant); its weights are the
// tap's [half][32][8] block at b.
template <int DIL>
__device__ __forceinline__ void rate_mmas(float (&acc)[RATE_BLOCKS][GC / 2], uint32_t a,
                                          uint32_t b) {
  const uint64_t da = sw128_desc(a, ROW_BYTES);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = (tap / 3 - 1) * DIL, dx = (tap % 3 - 1) * DIL;
    const uint64_t db = smem_desc(b + tap * KC * GC * 2, GC * 16, 128);
#pragma unroll
    for (int j = 0; j < RATE_BLOCKS; ++j) {
      const int px = dy * HALO_COLS + dx + 8 * j;  // may be negative: a stays inside the halo
      wgmma<GC>(acc[j], da + (uint64_t)(int64_t)(px * (PX_BYTES / 16)), db);
    }
  }
}

// A consumer warpgroup's part of a tile.  Thread (warp, lane) holds, of each
// block j, pixels (row 2 warp + h, column 8 j + lane / 4) for h = 0, 1
// (accumulator rows 16 warp + lane / 4 + 8 h) and channels c0 .. c0 + 7 of
// the dilation's 32 (tma_channels), channel c0 + c of half h in accumulator
// column 4 (c / 2) + 2 h + c % 2.
struct RateConsumer {
  using Acc = float[RATE_BLOCKS][GC / 2];
  using Sum = uint32_t[RATE_BLOCKS][2][4];  // bf16 pairs
  Ring<RateRing> ring;
  uint32_t wbase, bars, halo_empty;
  uint32_t a;  // the warpgroup's first output pixel in the halo
  int lane, c0;
  RateArgs g;
  size_t img;  // the tile's image: its first pixel
  int y0, x0;  // this thread's first pixel

  // v_r = cast(acc + b_r), s_r = cast(s_{r-1} + v_r), lrelu(s_r) stored.
  template <int DIL> __device__ __forceinline__ void epilogue(const Acc& acc, Sum& sum) {
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(g.bias + GC * (DIL - 1) + c0));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(g.bias + GC * (DIL - 1) + c0 + 4));
    const float bias[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int j = 0; j < RATE_BLOCKS; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          __nv_bfloat162 r = __floats2bfloat162_rn(acc[j][4 * i + 2 * h] + bias[2 * i],
                                                   acc[j][4 * i + 2 * h + 1] + bias[2 * i + 1]);
          if constexpr (DIL > 1) {
            const __nv_bfloat162 p = as_bf2(sum[j][h][i]);
            r = __floats2bfloat162_rn(lo(p) + lo(r), hi(p) + hi(r));
          }
          sum[j][h][i] = as_u32(r);
          o[i] = as_u32(lrelu2(r));
        }
        const int y = y0 + h, x = x0 + 8 * j;
        if (y < g.H && x < g.W)
          *reinterpret_cast<uint4*>(g.ws + (img + (size_t)y * g.W + x) * CAT + GC * (DIL - 1) +
                                    c0) = make_uint4(o[0], o[1], o[2], o[3]);
      }
  }

  // Dilation DIL's four chunks, then its epilogue; then DIL + 1's.  Once
  // dilation 8's wgmmas retire, each warp releases the halo.
  template <int DIL> __device__ __forceinline__ void run(Acc& acc, Sum& sum) {
    if constexpr (DIL <= RATES) {
#pragma unroll
      for (int j = 0; j < RATE_BLOCKS; ++j)
#pragma unroll
        for (int i = 0; i < GC / 2; ++i) acc[j][i] = 0.f;
#pragma unroll 1
      for (int k = 0; k < NF / KC; ++k) {
        const uint32_t b = ring.acquire(wbase, bars);
        rate_mmas<DIL>(acc, a + k * KC * 2, b);
        ring.release(bars, lane);
      }
      ring.drain(bars, lane);
      if constexpr (DIL == RATES)
        if (lane == 0) mbar_arrive(halo_empty);
      epilogue<DIL>(acc, sum);
      run<DIL + 1>(acc, sum);
    }
  }
};

__global__ void __launch_bounds__(tma::THREADS, 1)
dilated_block_rates(const __grid_constant__ CUtensorMap map, RateArgs g,
                    const __nv_bfloat16* __restrict__ w) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t halo = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t wbase = halo + HALO_BYTES;
  const uint32_t bars = wbase + RateRing::STAGES * RateRing::STAGE;
  const uint32_t halo_full = bars + 16 * tma::MAX_STAGES, halo_empty = halo_full + 8;
  const int tid = threadIdx.x;
  const RateWalk walk(g.B, g.H, g.W);

  if (tid == 0) {
    mbar_init(halo_full, 1);
    mbar_init(halo_empty, tma::CONSUMERS * 4);
    init_ring<RateRing>(bars);  // its fence covers the halo's barriers too
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer, one thread: per tile the halo, then d1..d8's 32 weight chunks ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(tma::PRODUCER_REGS));
    if (tid == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map))
                   : "memory");
      const char* wsrc = reinterpret_cast<const char*>(w);
      int s = 0;
      uint32_t phase = 0, hphase = 0;
      for (int t = blockIdx.x; t < walk.count; t += gridDim.x) {
        const TileWalk::Tile tl = walk.at(t);
        mbar_wait(halo_empty, hphase ^ 1);
        hphase ^= 1;
        mbar_expect_tx(halo_full, HALO_BYTES);
        tma_load_4d(halo, &map, halo_full, 0, tl.x0 - RATES, tl.y0 - RATES, tl.b);
#pragma unroll 1
        for (int i = 0; i < RATES * NF / KC; ++i) {  // dilation i / 4 + 1, chunk i % 4
          mbar_wait(bars + 8 * (tma::MAX_STAGES + s), phase ^ 1);
          const uint32_t full = bars + 8 * s;
          mbar_expect_tx(full, RateRing::STAGE);
          bulk_load(wbase + s * RateRing::STAGE, wsrc + (size_t)i * RateRing::STAGE,
                    RateRing::STAGE, full);
          if (++s == RateRing::STAGES) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: wgmma over the halo, the cascade, the stores ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(tma::CONSUMER_REGS));
    const int cw = tid / 128 - 1, warp = (tid % 128) / 32, lane = tid % 32;
    RateConsumer c{{}, wbase, bars, halo_empty,
                   halo + ((RATE_TH / 2 * cw + RATES) * HALO_COLS + RATES) * PX_BYTES, lane,
                   8 * (lane % 4), g, 0, 0, 0};
    RateConsumer::Acc acc;
    RateConsumer::Sum sum;
    uint32_t hphase = 0;
    for (int t = blockIdx.x; t < walk.count; t += gridDim.x) {
      const TileWalk::Tile tl = walk.at(t);
      c.img = (size_t)tl.b * g.H * g.W;
      c.y0 = tl.y0 + RATE_TH / 2 * cw + 2 * warp;
      c.x0 = tl.x0 + lane / 4;
      mbar_wait(halo_full, hphase);
      hphase ^= 1;
      c.run<1>(acc, sum);
    }
  }
}

cudaError_t launch_c1(const Geom& g, const __nv_bfloat16* w, const ConvEpi& epi,
                      cudaStream_t s) {
  using C = C1Cfg;
  CUtensorMap map;
  cudaError_t e = tensor_map(&map, g.src, g.cin, g.ctot, g.B, g.H, g.W, C::BOX_ROWS);
  int grid = 0;
  if (e == cudaSuccess)
    e = persistent_grid<KernelTag<C, ConvEpi>>(dilated_block_c1, C::SMEM, TileWalk(g, C::TH).count,
                                               &grid);
  if (e != cudaSuccess) return e;
  dilated_block_c1<<<grid, tma::THREADS, C::SMEM, s>>>(map, g, w, epi);
  return cudaGetLastError();
}

// h (B, H, W, 64) read in boxes of the whole halo: 64 channels (one swizzled
// 128-byte row a pixel) x 40 columns x 32 rows, zero fill.
cudaError_t launch_rates(const void* h, const __nv_bfloat16* w, const RateArgs& g,
                         cudaStream_t s) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t px = PX_BYTES;
  const cuuint64_t dims[4] = {NF, (cuuint64_t)g.W, (cuuint64_t)g.H, (cuuint64_t)g.B};
  const cuuint64_t strides[3] = {px, px * g.W, px * g.W * g.H};
  const cuuint32_t box[4] = {NF, HALO_COLS, HALO_ROWS, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  CUtensorMap map;
  if (fn(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(h), dims, strides, box,
         estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  int grid = 0;
  const cudaError_t e = persistent_grid<KernelTag<RateRing, RateArgs>>(
      dilated_block_rates, RATE_SMEM, RateWalk(g.B, g.H, g.W).count, &grid);
  if (e != cudaSuccess) return e;
  dilated_block_rates<<<grid, tma::THREADS, RATE_SMEM, s>>>(map, g, w);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// c2: out = residuals(cast(ws @ W2 + b2)), ws holding lrelu(s_1..s_8), one
// warp per 16 pixels,
// mma.sync m16n8k16 (bf16 in, fp32 accumulate).  Lane (g, t) = (lane / 4,
// lane % 4) holds rows g and g + 8 of the A fragment.  Its K order is
// permuted so that for each 32 channels m the lane loads one 16-byte piece
// a row, channels 32 m + 8 t ... + 7: k-step 2 m + e takes its words 2 e
// (logical k 2 t, 2 t + 1) and 2 e + 1 (k 2 t + 8, 2 t + 9).  Its N order
// is tma_channels(64): n8 tile i, column 2 t + e is channel 16 t + 2 i + e,
// so a lane's outputs are 16 consecutive channels of its two pixels.  W2
// is packed (dilated_block.py::pack_fuse) as the B fragments in the order
// they are read: [k-step][n8 tile][lane] of two 32-bit words.
constexpr int FUSE_WARPS = 8;
constexpr int KSTEPS = CAT / 16, NTILES = NF / 8;

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(FUSE_WARPS * 32, 2)
dilated_block_fuse(const __nv_bfloat16* __restrict__ ws, const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* res, const uint2* __restrict__ w2,
                   const float* __restrict__ b2, __nv_bfloat16* out, long long npix) {
  __shared__ uint2 wsm[KSTEPS * NTILES * 32];
  for (int i = threadIdx.x; i < KSTEPS * NTILES * 32; i += blockDim.x) wsm[i] = w2[i];
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const long long groups = (npix + 15) / 16;
  for (long long grp = (long long)blockIdx.x * FUSE_WARPS + warp; grp < groups;
       grp += (long long)gridDim.x * FUSE_WARPS) {
    const long long pix[2] = {16 * grp + g, 16 * grp + g + 8};
    uint4 a[2][CAT / 32];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int m = 0; m < CAT / 32; ++m)
        a[r][m] = pix[r] < npix
                      ? *reinterpret_cast<const uint4*>(ws + pix[r] * CAT + 32 * m + 8 * t)
                      : make_uint4(0, 0, 0, 0);
    float acc[NTILES][4];
#pragma unroll
    for (int i = 0; i < NTILES; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
    for (int m = 0; m < CAT / 32; ++m) {
      const uint32_t wd[2][4] = {{a[0][m].x, a[0][m].y, a[0][m].z, a[0][m].w},
                                 {a[1][m].x, a[1][m].y, a[1][m].z, a[1][m].w}};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 2 * m + e;
#pragma unroll
        for (int i = 0; i < NTILES; ++i) {
          const uint2 b = wsm[(j * NTILES + i) * 32 + lane];
          mma_bf16(acc[i], wd[0][2 * e], wd[1][2 * e], wd[0][2 * e + 1], wd[1][2 * e + 1], b.x,
                   b.y);
        }
      }
    }
    // epilogue: channel 16 t + c of row r is acc[c / 2][2 r + c % 2]
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (pix[r] >= npix) continue;
      const size_t base = (size_t)pix[r] * NF + 16 * t;
      const uint4* xp = reinterpret_cast<const uint4*>(x + base);
      uint4 xv[2] = {xp[0], xp[1]}, rv[2];
      if (res != nullptr) {
        const uint4* rp = reinterpret_cast<const uint4*>(res + base);
        rv[0] = rp[0];
        rv[1] = rp[1];
      }
      uint4* d = reinterpret_cast<uint4*>(out + base);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const uint32_t xw[4] = {xv[u].x, xv[u].y, xv[u].z, xv[u].w};
        const uint32_t rw[4] = {rv[u].x, rv[u].y, rv[u].z, rv[u].w};
        uint32_t o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = 8 * u + 2 * q, i = c / 2;
          const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + 16 * t + c));
          const __nv_bfloat162 v = __floats2bfloat162_rn(acc[i][2 * r] + bb.x,
                                                         acc[i][2 * r + 1] + bb.y);
          const __nv_bfloat162 p = __floats2bfloat162_rn(lo(v) * SLOPE_BF16, hi(v) * SLOPE_BF16);
          const __nv_bfloat162 xx = as_bf2(xw[q]);
          __nv_bfloat162 y = __floats2bfloat162_rn(lo(xx) + lo(p), hi(xx) + hi(p));
          if (res != nullptr) {
            const __nv_bfloat162 rr = as_bf2(rw[q]);
            const __nv_bfloat162 z = __floats2bfloat162_rn(lo(y) * SLOPE_BF16, hi(y) * SLOPE_BF16);
            y = __floats2bfloat162_rn(lo(z) + lo(rr), hi(z) + hi(rr));
          }
          o[q] = as_u32(y);
        }
        d[u] = make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
  }
}

int fuse_grid(long long npix) {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n_sm = 132;
  }
  const long long blocks = ((npix + 15) / 16 + FUSE_WARPS - 1) / FUSE_WARPS;
  return (int)(blocks < 8LL * n_sm ? blocks : 8LL * n_sm);
}

}  // namespace

extern "C" {

// One _ResBlock_32 on `stream`.  x, out: (B, H, W, 64) bf16; res: NULL, or
// the RRBlock's input (B, H, W, 64), whose residual the block then also
// applies; h: (B, H, W, 64) and ws: (B, H, W, 256) scratch (lrelu(s_r) in
// channels 32 (r - 1) ..); w: c1's and
// d1..d8's weights packed by ops/conv3x3.py (tma order) back to back; bias:
// their 64 + 8 x 32 fp32 biases back to back; w2, b2: c2 packed by
// ops/dilated_block.py::pack_fuse and its 64 fp32 biases.  Every pointer
// 16-byte aligned.  Returns the first CUDA error (0 = success).
int innfer_dilated_block(const void* x, void* h, void* ws, void* out, const void* res,
                         const void* w, const float* bias, const void* w2, const float* b2,
                         int B, int H, int W, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  Geom g;
  g.B = B; g.H = H; g.W = W;
  g.cin = NF; g.ctot = NF; g.head_ch = NF; g.head_stride = NF; g.cout = NF;
  g.src = x; g.head = x; g.bias = bias;
  cudaError_t e = launch_c1(g, wb, ConvEpi{hb}, s);
  if (e == cudaSuccess)
    e = launch_rates(hb, wb + packed_elems(NF, NF),
                     RateArgs{bias + NF, static_cast<__nv_bfloat16*>(ws), B, H, W}, s);
  if (e != cudaSuccess) return e;
  const long long npix = (long long)B * H * W;
  dilated_block_fuse<<<fuse_grid(npix), FUSE_WARPS * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(ws), static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(res), static_cast<const uint2*>(w2), b2,
      static_cast<__nv_bfloat16*>(out), npix);
  return cudaGetLastError();
}

// The dynamic shared memory (bytes) of c1's kernel (rates 0) and of the
// dilated convs' (rates 8), for the build report.
int innfer_dilated_block_smem_bytes(int rates) {
  return rates == 0 ? C1Cfg::SMEM : RATE_SMEM;
}

// The bytes dilated_block_rates stages into shared memory in one call on a
// (B, H, W, 64) h: its tiles' halo boxes (part 0) or their weights (part 1),
// for the build report.
long long innfer_dilated_block_staged_bytes(int B, int H, int W, int part) {
  const long long tiles = RateWalk(B, H, W).count;
  return tiles * (part == 0 ? HALO_BYTES : RATES * NF / KC * RateRing::STAGE);
}

const char* innfer_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
