// The zero-padded bf16 3x3 conv in Hopper's fast-kernel shape: a TMA
// producer warp, two warp-specialised wgmma consumer warpgroups, an
// mbarrier ring of stages, and a persistent grid.  rdb.cu's five convs run
// on it; resnet_block.cu keeps conv3x3_tc.cuh's conv_wgmma, whose reflect
// padding needs per-pixel addresses that a TMA box cannot give.  The
// pipeline's pieces (init_ring, produce, Ring, TileWalk, tap_mmas,
// persistent_grid) are also tail_conv.cu's, which adds its own tap loop and
// epilogue to them, and dilated_block.cu's: its c1 runs conv_tma's tile loop,
// its dilated convs keep the ring (init_ring, Ring) for their weights alone
// and stage their halo their own way (a swizzled box of all 64 channels).
//
// The GEMM is conv_wgmma's: M = output pixels, N = all cout output
// channels of one N tile, K = 9 taps x cin in 16-channel chunks.  A tile is
// TH = 2 R output rows x 64 columns; consumer warpgroup c computes rows
// [c R, c R + R), one m64 wgmma tile per row, so both share one stage: the
// halo of the tile's TH + 2 rows and the chunk's weights.  Each output row
// of a tap (dy, dx) is the halo at pixel offset (r + dy) * 66 + dx, a
// descriptor offset (no im2col).  R = 8 rows for N <= 32, 4 for N = 64,
// 2 for 128, 1 for 256 keeps the accumulators at 128 fp32 registers a
// thread (64 for N = 256 at R = 1): a 16-row tile for the RDB's N = 32
// convs and an 8-row one for its N = 64 conv5, where conv_wgmma's blocks
// covered 8 and 4 rows.
//
// One stage: the halo as two 8-channel planes of 16-byte pixels (one TMA
// box of 8 channels x 66 columns x TH + 2 rows each, no swizzle: 8
// consecutive pixels are one wgmma core matrix, and a one-pixel shift is a
// 16-byte descriptor offset), then the chunk's weights in the packed layout
// of ops/conv3x3.py (one contiguous cp.async.bulk copy).  The tensor map's
// out-of-bounds zero fill is the conv's zero padding, at the image's edges
// and for a ragged tile; a half-chunk past cin is loaded from a channel
// coordinate past the tensor, all zeros.  Channels [0, head_ch) come from
// the head tensor map, the others from the src one (Geom's split).
//
// Roles.  Warpgroup 0 is the producer: it gives up registers (setmaxnreg)
// and one thread keeps up to STAGES chunks in flight, waiting on each
// stage's "empty" mbarrier and arming its "full" one with the stage's byte
// count.  Warpgroups 1-2 are the consumers: each waits on "full", issues
// the chunk's 9 R wgmmas as one group, retires the previous chunk's group
// (wgmma.wait_group 1) and releases that stage with one arrive a warp.
// After a tile's last chunk they run the epilogue, while the producer
// already loads the next tile's chunks.  ptxas still allocates every
// thread within the 168 registers that 384 threads leave (no spill for
// N <= 64).
//
// Epilogue.  The packed weights order each N tile's columns so that
// accumulator lane q holds K = N / 4 consecutive channels of its pixels
// (ops/conv3x3.py::tma_channels); a lane then reads its addends and writes
// its outputs in 16-byte pieces, and a warp's stores cover whole 32-byte
// sectors (with 4-byte pair stores, as conv_wgmma has them, the epilogue
// took three times the wgmmas' time on an H100).  N = 128 and 256, which
// lack the registers for that, store pairs.
//
// Persistent grid: min(tiles, SMs) blocks of one per SM (the ring takes
// most of the 227 KB); block b walks tiles b, b + grid, ... of the
// row-major order (N group, image, tile row, tile column), so the tiles in
// flight at once are neighbours whose halo rows meet in L2.  Each output
// pixel's sums are taken in one order whichever block computes it.
//
// Every wait on an mbarrier that has not completed after 10 s traps: a lost
// arrival ends the kernel with an error instead of hanging the card.
//
// Tried on an H100 and left out (scripts/time_fused_rdb.py, ms per RDB at
// the main-path shape against this design's 2.38): ping-pong consumers on
// separate tiles of R rows, taking turns at the wgmmas so that one's
// epilogue overlaps the other's (2.38); the epilogue staged in shared
// memory and written by a TMA store, cooperative (3.76) or ping-pong
// (2.95-3.05), each spilling within the 168 registers.  The epilogue's global
// stores are what each tile waits on most (they take longer than its
// wgmmas).
//
// Left on the table: stores that overlap the wgmmas without spilling,
// multicasting the weights over a cluster of two, A from registers (each
// N = 32 wgmma reads 3 KB of shared memory per 32K MACs), and wider TMA
// rows (a 16-byte box row is the slowest case of TMA; a swizzled 64-channel
// layout would need 128-byte rows, which 16-row halos leave no room for:
// dilated_block.cu's dilated convs take them, on one halo their eight convs
// share).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time

#include "conv3x3_tc.cuh"

namespace conv3x3 {

namespace tma {
constexpr int TW = 64;                    // output columns per tile
constexpr int HP_W = TW + 2;              // halo columns
constexpr int CONSUMERS = 2;              // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int SMEM_MAX = 227 * 1024;      // a block's dynamic shared memory
constexpr int MAX_STAGES = 8;
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
constexpr unsigned long long WAIT_TRAP_NS = 10000000000ull;
}  // namespace tma

__host__ __device__ constexpr int tma_rows(int nt) {  // R: rows per consumer
  return nt >= 256 ? 1 : nt >= 128 ? 2 : nt >= 64 ? 4 : 8;
}

// A stage ring of tiles of NT accumulator columns whose chunks carry weight
// blocks BN columns wide, one per tap (BN = NT for conv_tma).
template <int NT, int BN = NT> struct TmaCfg {
  static constexpr int R = tma_rows(NT);
  static constexpr int TH = tma::CONSUMERS * R;              // output rows per tile
  static constexpr int BOX_ROWS = TH + 2;
  static constexpr int BOX_BYTES = BOX_ROWS * tma::HP_W * 16;  // one 8-channel plane
  static constexpr int PLANE = (BOX_BYTES + 127) / 128 * 128;  // TMA wants 128-byte dsts
  static constexpr int A_BYTES = 2 * PLANE;
  static constexpr int B_BYTES = 9 * KC * BN * 2;            // one 16-channel chunk's weights
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int BARS = 2 * tma::MAX_STAGES * 8;       // full[], empty[]
  static constexpr int STAGES_FIT = (tma::SMEM_MAX - 128 - BARS) / STAGE;
  static constexpr int STAGES = STAGES_FIT < tma::MAX_STAGES ? STAGES_FIT : tma::MAX_STAGES;
  static constexpr int SMEM = 128 + STAGES * STAGE + BARS;   // 128: alignment slack
  static constexpr uint32_t TX = 2 * BOX_BYTES + B_BYTES;    // bytes landing per stage
  static_assert(STAGES >= 2 && SMEM <= tma::SMEM_MAX, "shared memory");
  static_assert(BOX_ROWS <= 256 && PLANE / 16 < (1 << 14), "TMA box, descriptor LBO");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// Wait for the phase of `parity` to complete (try_wait suspends the thread
// for a while inside each attempt, so the loop spins little).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > tma::WAIT_TRAP_NS) __trap();
}
// One box of a 4-d tensor map (channel, column, row, image) into shared
// memory; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c, int x, int y, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(x), "r"(y), "r"(b)
      : "memory");
}
// `bytes` contiguous bytes (16-byte aligned, a multiple of 16) into shared memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

struct TileWalk {  // the row-major tile order of one conv: N group, image, tile row, column
  int tx_n, ty_n, per_img, per_group, count;
  __host__ __device__ TileWalk(int B, int H, int W, int groups, int th) {
    tx_n = (W + tma::TW - 1) / tma::TW;
    ty_n = (H + th - 1) / th;
    per_img = tx_n * ty_n;
    per_group = per_img * B;
    count = per_group * groups;
  }
  __host__ __device__ TileWalk(const Geom& g, int th)
      : TileWalk(g.B, g.H, g.W, n_groups(g.cout), th) {}
  struct Tile {
    int grp, b, y0, x0;  // N group, image, first row and column
  };
  __device__ Tile at(int t, int th) const {
    const int rem = t % per_group, ti = rem % per_img;
    return {t / per_group, rem / per_img, (ti / tx_n) * th, (ti % tx_n) * tma::TW};
  }
};

// Thread 0, before the block's __syncthreads: each stage's "full" barrier
// (armed by the producer) and "empty" one (an arrive from each consumer warp).
template <class C>
__device__ __forceinline__ void init_ring(uint32_t bars) {
  for (int s = 0; s < C::STAGES; ++s) {
    mbar_init(bars + 8 * s, 1);
    mbar_init(bars + 8 * (tma::MAX_STAGES + s), tma::CONSUMERS * 4);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer, one thread: for each of the block's tiles, each of its
// nchunks 16-channel chunks into the next free stage: the halo as two
// 8-channel boxes (channels [0, head_ch) from head_map, the others from
// src_map; a half past cin is read at channel ctot, past the tensor, all
// zeros) and the chunk's weights (the N group's chunks back to back in w)
// as one bulk copy.
template <class C>
__device__ __forceinline__ void produce(const TileWalk& walk, int nchunks, uint32_t sbase,
                                        uint32_t bars, const __nv_bfloat16* w,
                                        const CUtensorMap* head_map, const CUtensorMap* src_map,
                                        int head_ch, int cin, int ctot) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(head_map))
               : "memory");
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(src_map))
               : "memory");
  int s = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < walk.count; t += gridDim.x) {
    const TileWalk::Tile tl = walk.at(t, C::TH);
    const char* wsrc = reinterpret_cast<const char*>(w) + (size_t)tl.grp * nchunks * C::B_BYTES;
    for (int k = 0; k < nchunks; ++k) {
      mbar_wait(bars + 8 * (tma::MAX_STAGES + s), phase ^ 1);
      const uint32_t full = bars + 8 * s, a = sbase + s * C::STAGE;
      mbar_expect_tx(full, C::TX);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = k * KC + 8 * h;
        if (c < cin && c < head_ch)
          tma_load_4d(a + h * C::PLANE, head_map, full, c, tl.x0 - 1, tl.y0 - 1, tl.b);
        else
          tma_load_4d(a + h * C::PLANE, src_map, full, c < cin ? c : ctot, tl.x0 - 1,
                      tl.y0 - 1, tl.b);
      }
      bulk_load(a + C::A_BYTES, wsrc + (size_t)k * C::B_BYTES, C::B_BYTES, full);
      if (++s == C::STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
  }
}

// A consumer warpgroup's place in the stage ring: the next chunk's stage s
// and its phase, and the stage of the chunk whose wgmmas may still be in
// flight.  Per chunk: acquire() waits for its stage to fill and returns its
// address; the caller issues the chunk's wgmmas; release() commits them as
// one group, retires the previous chunk's group (wgmma.wait_group 1) and
// releases that stage with one arrive a warp.  drain() ends a tile.
template <class C> struct Ring {
  int s = 0, prev = -1;
  uint32_t phase = 0;
  __device__ __forceinline__ uint32_t acquire(uint32_t sbase, uint32_t bars) {
    mbar_wait(bars + 8 * s, phase);
    wgmma_fence();
    return sbase + s * C::STAGE;
  }
  __device__ __forceinline__ void release(uint32_t bars, int lane) {
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0 && lane == 0) mbar_arrive(bars + 8 * (tma::MAX_STAGES + prev));
    prev = s;
    if (++s == C::STAGES) {
      s = 0;
      phase ^= 1;
    }
  }
  __device__ __forceinline__ void drain(uint32_t bars, int lane) {
    wgmma_wait<0>();
    if (prev >= 0 && lane == 0) mbar_arrive(bars + 8 * (tma::MAX_STAGES + prev));
    prev = -1;
  }
};

// One chunk's 9 R wgmmas of the plain 3x3 conv: tap (dy, dx) of output row
// row0 + m reads the halo at pixel offset (row0 + m + dy) * 66 + dx of the
// stage at a; its weights are the tap's [half][NT][8] block at b.
template <int NT, int R>
__device__ __forceinline__ void tap_mmas(float (&acc)[R][NT / 2], uint32_t a, uint32_t b,
                                         int row0, int plane) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    const uint64_t db = smem_desc(b + tap * KC * NT * 2, NT * 16, 128);
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const uint64_t da = smem_desc(a + ((row0 + m + dy) * tma::HP_W + dx) * 16, plane, 128);
      wgmma<NT>(acc[m], da, db);
    }
  }
}

template <int NT, class Epi>
__global__ void __launch_bounds__(tma::THREADS, 1)
conv_tma(const __grid_constant__ CUtensorMap head_map, const __grid_constant__ CUtensorMap src_map,
         Geom g, const __nv_bfloat16* __restrict__ w, Epi epi) {
  using C = TmaCfg<NT>;
  static_assert(!Epi::kStats, "conv_tma has no statistics epilogue");
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
    if (tid == 0)
      produce<C>(walk, nchunks, sbase, bars, w, &head_map, &src_map, g.head_ch, g.cin, g.ctot);
  } else {
    // ---- consumer warpgroups: wgmma and the epilogue ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(tma::CONSUMER_REGS));
    const int cw = tid / 128 - 1, warp = (tid % 128) / 32, lane = tid % 32;
    // Output channels: the packed weights put channel c0 + 2 i + e of lane
    // (lane % 4) in accumulator column 8 i + 2 (lane % 4) + e, so each lane
    // holds K = NT / 4 consecutive channels of its pixels.
    // RUNS: store each pixel's K channels as 16-byte pieces, from registers
    // that only N <= 64 can spare; wider tiles store pairs of channels.
    constexpr int K = NT / 4;
    constexpr bool RUNS = NT <= 64;
    Ring<C> ring;
    for (int t = blockIdx.x; t < walk.count; t += gridDim.x) {
      const TileWalk::Tile tl = walk.at(t, C::TH);
      const int b = tl.b, y0 = tl.y0 + cw * C::R, x0 = tl.x0;
      const int c0 = tl.grp * NT + K * (lane % 4);
      float bias[RUNS ? K : 1];  // read ahead of the epilogue
#pragma unroll
      for (int i = 0; i < (RUNS ? K : 0); ++i) bias[i] = c0 + i < g.cout ? g.bias[c0 + i] : 0.f;
      float acc[C::R][NT / 2];
#pragma unroll
      for (int m = 0; m < C::R; ++m)
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) acc[m][j] = 0.f;

      for (int k = 0; k < nchunks; ++k) {
        const uint32_t a = ring.acquire(sbase, bars);
        tap_mmas<NT, C::R>(acc, a, a + C::A_BYTES, cw * C::R, C::PLANE);
        ring.release(bars, lane);
      }
      ring.drain(bars, lane);

      // epilogue: thread (warp, lane) holds pixels 16 warp + lane / 4 (+ 8)
      // of each of its rows, K channels from c0 each; a row's reads are
      // issued ahead of its stores, and a warp's stores cover whole sectors
      const size_t img = (size_t)b * g.H * g.W;
#pragma unroll
      for (int m = 0; m < C::R; ++m) {
        const int y = y0 + m;
        if constexpr (RUNS) {
          typename Epi::template Run<K> pre[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int x = x0 + 16 * warp + lane / 4 + 8 * h;
            if (y < g.H && x < g.W && c0 < g.cout)
              pre[h] = epi.template load<K>(img + (size_t)y * g.W + x, c0);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int x = x0 + 16 * warp + lane / 4 + 8 * h;
            if (y < g.H && x < g.W && c0 < g.cout)
              epi.template store<K>(img + (size_t)y * g.W + x, c0, acc[m], h, pre[h], bias);
          }
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int x = x0 + 16 * warp + lane / 4 + 8 * h;
#pragma unroll
            for (int k = 0; k < K / 2; ++k) {
              const int co = c0 + 2 * k;
              if (y < g.H && x < g.W && co < g.cout)
                epi(img + (size_t)y * g.W + x, co, acc[m][4 * k + 2 * h] + g.bias[co],
                    acc[m][4 * k + 2 * h + 1] + g.bias[co + 1]);
            }
          }
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up once at run time (no -lcuda).
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// The 4-d map (channel, column, row, image) of a bf16 NHWC tensor with
// `ch` channels at pixel stride `stride` elements, read in boxes of 8
// channels x 66 columns x `rows` rows with zero fill.
inline cudaError_t tensor_map(CUtensorMap* map, const void* base, int ch, int stride, int B,
                              int H, int W, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t px = (cuuint64_t)stride * 2;
  const cuuint64_t dims[4] = {(cuuint64_t)ch, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {px, px * W, px * W * H};
  const cuuint32_t box[4] = {8, (cuuint32_t)tma::HP_W, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
         estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <class...> struct KernelTag {};

// The persistent grid for `tiles` tiles of `kernel`: one block per SM, at
// most one per tile.  The shared-memory attribute and the SM count belong
// to the current device: read once per Tag (one per kernel instantiation)
// and device (on every call past the table's devices).
template <class Tag, class Kernel>
cudaError_t persistent_grid(Kernel kernel, int smem, long long tiles, int* grid) {
  constexpr int kDevices = 64;
  static int sms[kDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int n_sm = dev < kDevices ? sms[dev] : 0;
  if (n_sm == 0) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (dev < kDevices) sms[dev] = n_sm;
  }
  *grid = (int)(tiles < n_sm ? tiles : n_sm);
  return cudaSuccess;
}

template <int NT, class Epi>
cudaError_t launch_tma_nt(const Geom& g, const __nv_bfloat16* w, const Epi& epi,
                          cudaStream_t s) {
  using C = TmaCfg<NT>;
  CUtensorMap head, src;
  cudaError_t e = tensor_map(&head, g.head, g.head_ch, g.head_stride, g.B, g.H, g.W, C::BOX_ROWS);
  if (e == cudaSuccess) e = tensor_map(&src, g.src, g.ctot, g.ctot, g.B, g.H, g.W, C::BOX_ROWS);
  int grid = 0;
  if (e == cudaSuccess)
    e = persistent_grid<KernelTag<C, Epi>>(conv_tma<NT, Epi>, C::SMEM, TileWalk(g, C::TH).count,
                                           &grid);
  if (e != cudaSuccess) return e;
  conv_tma<NT, Epi><<<grid, tma::THREADS, C::SMEM, s>>>(head, src, g, w, epi);
  return cudaGetLastError();
}

// The zero-padded bf16 conv of g (cin % 8 == 0, head_ch % 8 == 0, the
// tensors 16-byte aligned with pixel strides of a multiple of 8 channels).
template <class Epi>
cudaError_t launch_tma(const Geom& g, const __nv_bfloat16* w, const Epi& epi, cudaStream_t s) {
  switch (n_tile(g.cout)) {
    case 8: return launch_tma_nt<8, Epi>(g, w, epi, s);
    case 16: return launch_tma_nt<16, Epi>(g, w, epi, s);
    case 32: return launch_tma_nt<32, Epi>(g, w, epi, s);
    case 64: return launch_tma_nt<64, Epi>(g, w, epi, s);
    case 128: return launch_tma_nt<128, Epi>(g, w, epi, s);
    default: return launch_tma_nt<256, Epi>(g, w, epi, s);
  }
}

}  // namespace conv3x3

// The dynamic shared memory (bytes) of conv_tma for this cout, for the
// build report.
extern "C" int innfer_conv_tma_smem_bytes(int cout) {
  switch (conv3x3::n_tile(cout)) {
    case 8: return conv3x3::TmaCfg<8>::SMEM;
    case 16: return conv3x3::TmaCfg<16>::SMEM;
    case 32: return conv3x3::TmaCfg<32>::SMEM;
    case 64: return conv3x3::TmaCfg<64>::SMEM;
    case 128: return conv3x3::TmaCfg<128>::SMEM;
    default: return conv3x3::TmaCfg<256>::SMEM;
  }
}
