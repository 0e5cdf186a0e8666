// SwinIR's token linears with their epilogues, for NVIDIA Hopper (sm_90a):
// one bf16 GEMM over the tokens whose epilogue adds the residual or applies
// GELU.
//
// Replaces no TPU kernel: the JAX package has no SwinIR.  A Swin
// transformer layer (models/swinir.py::swin_layer) runs three of its four
// linears on it, with the semantics of ops/token_gemm.py::
// token_linear_reference:
//   proj, fc2   out = bf16(x + y)          the residual
//   fc1         out = bf16(gelu(y))        the exact erf GELU
// where, for tokens a (M, K) bf16 and the linear's weight w (N, K) and bias
// b (N,) in bf16,
//   y = bf16(sum_k a[m, k] w[n, k] + float(b[n]))     fp32 sums, one rounding
// and x (M, N) is the residual stream.  These are the plain path's rounding
// points (cuBLAS's addmm with its bf16 bias, then ATen's bf16 add or GELU,
// each in fp32 and rounded once), so only the order of the GEMM's fp32 sums
// differs from it.  GELU is PyTorch's: (v * 0.5) * (1 + erff(v * 1/sqrt 2)).
//
// Bound: bytes.  At K = 184 or 360 the products are 2 N K operations a
// token against 2 (K + N) bytes read and 2 N written: about 60 operations a
// byte, a fifth of the H100's ridge.  SwinIR-M's cell (544 x 960 = 522,240
// tokens) moves 568 MB a layer for proj (a 184 wide, x and out 180 wide),
// 568 MB for fc1 (a 184 wide, out 360) and 752 MB for fc2 (a 360 wide, x
// and out 180): 0.170, 0.170 and 0.224 ms at 3.35 TB/s.  The plain path
// writes y, then reads it and x and writes the sum (or reads y and writes
// its GELU): 1.5 to 2 times the bytes, in two launches, and cuBLAS runs
// proj and fc2, whose 360-byte rows are not 16-byte aligned, on sm80
// kernels.
//
// Design: one persistent block per SM (conv3x3_tma.cuh's persistent_grid),
// a producer warpgroup of which one thread issues every load, and two
// consumer warpgroups that share each 64-token tile, splitting its N
// columns (multiples of 8: 96 + 88 for N = 180, 184 + 176 for fc1's 360,
// whose 64 x 360 fp32 accumulator one warpgroup could not hold).
//   * The weight stays in shared memory for the whole launch: TMA boxes of
//     64 K x up to 256 rows in the 128-byte swizzled layout, loaded once
//     (K past the tensor and rows past N read as zeros).  184 x 192 bf16
//     (69 KB) for proj, 368 x 192 (138 KB) for fc1, 184 x 384 (138 KB) for
//     fc2.
//   * The tokens stream through a ring of 64 x 64 chunks (8 KB, one TMA box
//     of 128-byte swizzled rows): K = 184 reads as three chunks, the box
//     past the tensor's last column zero-filled against the weight's zero
//     columns, so no byte beyond a's own is read.  Each consumer runs a
//     chunk's four k16 steps as wgmmas straight from shared memory and
//     releases it.  The ring holds 12 chunks at proj, 5 at fc1 and fc2, so
//     the next tile's tokens load during this one's epilogue.
//   * Residual (proj, fc2): a tile of 64 rows of x and of out is contiguous
//     (23,040 bytes at N = 180, 360-byte rows that no tensor map can
//     describe), so the residual arrives by one bulk copy into a staging
//     tile (two, alternating, so the next tile's residual loads during this
//     one's epilogue), both consumers rewrite it in place from their
//     accumulators, meet at a named barrier, and one bulk copy stores it.
//   * GELU (fc1): 46 KB of staging is all that is left beside the weight,
//     one tile.  Each consumer writes y = bf16(acc + b) for its columns into
//     its half, as two dense slices of rows; then applies GELU to each slice
//     in 16-byte pieces, eight values a piece, and stores it by a tensor map
//     of the slice's width while it works on the next.  The consumers take
//     turns at the wgmmas (an mbarrier each), so that one's GELU runs under
//     the other's products, and otherwise do not wait for each other.
// Each output's sums are taken in one order whichever block computes it.
//
// Tried on an H100 (fc1 at the SwinIR cell's 522,240 tokens, CUDA events):
// GELU applied straight from the accumulators, the way the residual is,
// 0.51 ms: erff's chain of dependent operations, a thread's values one
// after another within 168 registers, kept eight warps latency-bound (the
// same epilogue without GELU took 0.22 ms).  A branch-free copy of erff
// (its PTX, operation for operation) did not change that (0.52); the
// store of the whole tile by one bulk copy after both consumers met against
// four slice stores, the same.  The pass over 16-byte pieces: 0.37 ms; two
// pieces a loop iteration beat one (0.39) and four (0.48); the consumers
// taking turns at the wgmmas, against both at once, 0.358 against 0.373.
//
// Every wait on an mbarrier that has not completed after 10 s traps
// (conv3x3_tma.cuh's mbar_wait).
#include "conv3x3_tma.cuh"

namespace {

using namespace conv3x3;

constexpr int TM = 64;                 // tokens a tile: one m64 wgmma row block
constexpr int KW = 64;                 // K a chunk: one 128-byte swizzled row
constexpr int CHUNK = TM * KW * 2;     // an A chunk's bytes
constexpr int ROW = KW * 2;            // a swizzled row's bytes
constexpr int MAX_RING = 12;
constexpr int SMEM_MAX = tma::SMEM_MAX;
constexpr float SQRT1_2 = 0.707106781186547524f;

enum Epilogue { RESIDUAL = 0, GELU = 1 };

template <int K, int N0, int N1, int N, int EPI> struct Cfg {
  static constexpr int KCH = (K + KW - 1) / KW;               // chunks a tile
  static constexpr int LAST_STEPS = (K - (KCH - 1) * KW + 15) / 16;  // k16 steps of the last
  static constexpr int NP = N0 + N1;                          // accumulator columns
  static constexpr int OUT = N, E = EPI;                      // out's row, the epilogue
  static constexpr int NBOX = (NP + 255) / 256;               // weight boxes a chunk
  static constexpr int BOX_N = ((NP + NBOX - 1) / NBOX + 7) / 8 * 8;
  static constexpr int W_CHUNK = NBOX * BOX_N * ROW;
  static constexpr int W_BYTES = KCH * W_CHUNK;
  static constexpr int TILE_OUT = TM * N * 2;                 // a tile of x or out
  static constexpr int SBUF = EPI == RESIDUAL ? 2 : 1;        // staging tiles
  static constexpr int BARS = 8 * (1 + 2 * MAX_RING + 6);
  static constexpr int FIXED = 1024 + W_BYTES + SBUF * TILE_OUT + BARS;  // 1024: alignment
  static constexpr int RING_FIT = (SMEM_MAX - FIXED) / CHUNK;
  static constexpr int RING = RING_FIT < MAX_RING ? RING_FIT : MAX_RING;
  static constexpr int SMEM = FIXED + RING * CHUNK;
  static_assert(N0 % 8 == 0 && N1 % 8 == 0 && N0 <= 256 && N1 <= 256 && NP >= N && N % 2 == 0,
                "wgmma widths");
  static_assert(RING >= 3 && SMEM <= SMEM_MAX, "shared memory");
  static_assert(W_CHUNK % 1024 == 0 && TILE_OUT % 16 == 0, "swizzle atoms, bulk copies");
  static_assert(EPI == RESIDUAL || N0 + N1 == N, "the GELU epilogue's slices tile out");
};

// The descriptor of a K-major wgmma operand in the 128-byte swizzled layout
// (layout type 1): 8-row core matrices of 128-byte rows, 1024 bytes apart,
// LBO unused; a k16 step starts 32 bytes further (dilated_block.cu's).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// One box of a 2-d tensor map (column, row) into shared memory; its bytes
// complete on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c, int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(r)
      : "memory");
}
// `bytes` contiguous bytes of shared memory to global memory, in this
// thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk stores have read their shared memory (all but N)
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// the two consumer warpgroups (256 threads) meet
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
// ATen's GELU on a bf16 value, in fp32 (ActivationGeluKernel.cu's expression)
__device__ __forceinline__ float gelu_erf(float v) { return v * 0.5f * (1.0f + erff(v * SQRT1_2)); }

// D[64 x N] += A[64 x 16] * B[16 x N], bf16 in, fp32 accumulate, at the
// token GEMM's widths (conv3x3_tc.cuh's wgmma has the powers of two)
template <int N> __device__ __forceinline__ void wgmma_n(float (&d)[N / 2], uint64_t a, uint64_t b);

template <> __device__ __forceinline__ void wgmma_n<96>(float (&d)[48], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_n<88>(float (&d)[44], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %46, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n88k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43}, "
      "%44, %45, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
      : "l"(a), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_n<184>(float (&d)[92], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %94, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n184k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91}, "
      "%92, %93, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91])
      : "l"(a), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_n<176>(float (&d)[88], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %90, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87}, "
      "%88, %89, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
      : "l"(a), "l"(b), "r"(1));
}

struct Bars {  // the block's mbarriers, 8 bytes each from base
  uint32_t base;
  __device__ uint32_t w_full() const { return base; }
  __device__ uint32_t full(int s) const { return base + 8 * (1 + s); }
  __device__ uint32_t empty(int s) const { return base + 8 * (1 + MAX_RING + s); }
  __device__ uint32_t res_full(int b) const { return base + 8 * (1 + 2 * MAX_RING + b); }
  __device__ uint32_t stage_free(int b) const { return base + 8 * (3 + 2 * MAX_RING + b); }
  __device__ uint32_t mma_done(int c) const { return base + 8 * (5 + 2 * MAX_RING + c); }
};

// The GELU epilogue's stores: each consumer's columns in two slices of
// out, [COL0, COL0 + SA) and [COL0 + SA, COL0 + NW), each stored by a
// tensor map of its own width (c: consumer, j: slice).
struct OutMaps {
  CUtensorMap m[2][2];
};

// The first slice of NW columns: the least width >= NW / 2 that is 8 mod
// 16, whose rows of 16 (8 mod 16) bytes put a warp's eight rows of pairs
// in distinct banks.
__host__ __device__ constexpr int slice_a(int nw) { return (nw / 2 + 7) / 16 * 16 + 8; }

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c, int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c), "r"(r)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// one consumer warpgroup (128 threads) meets, at barrier 2 + c
__device__ __forceinline__ void consumer_sync(int c) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");
}

// A consumer warpgroup's part of each tile: accumulator columns [COL0, COL0
// + NW), its wgmmas over the tile's chunks, then its epilogue.  Thread
// (warp, lane) holds rows r0 and r0 + 8 of the tile and column pairs COL0 +
// 8 i + 2 (lane % 4).
//   residual: both consumers rewrite the tile's staged residual in place
//     (stage: its shared address, stage_p: the same as a pointer; two
//     tiles alternate) and `lead` (the first consumer thread) stores the
//     whole tile by one bulk copy.
//   gelu: each consumer writes y for its columns to its own part of the
//     staging tile, as two dense slices of rows of their own width, applies
//     GELU to each slice in 16-byte pieces, and its first thread stores
//     each slice by its tensor map once it is done; the two take turns at
//     the wgmmas and share no barrier.
template <class C, int CW, int NW, int COL0>
__device__ __forceinline__ void consume(uint32_t wsm, uint32_t ring, uint32_t stage,
                                        __nv_bfloat162* stage_p, Bars bars,
                                        const OutMaps& maps,
                                        const __nv_bfloat16* __restrict__ bias,
                                        __nv_bfloat16* __restrict__ out, int tiles) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const bool lead = tid == 0 && (C::E == GELU || CW == 0);
  const int r0 = 16 * warp + lane / 4, c0 = COL0 + 2 * (lane % 4);
  const __nv_bfloat162* bias2 = reinterpret_cast<const __nv_bfloat162*>(bias) + c0 / 2;
  constexpr int SA = slice_a(NW);
  int s = 0, n = 0;
  uint32_t phase = 0;
  mbar_wait(bars.w_full(), 0);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++n) {
    float acc[NW / 2];
#pragma unroll
    for (int j = 0; j < NW / 2; ++j) acc[j] = 0.f;
    int prev = -1;
    if (C::E == GELU) {  // the consumers take turns at the tensor cores: 0, 1, 0, ...
      if (CW == 1) mbar_wait(bars.mma_done(0), n & 1);
      else if (n > 0) mbar_wait(bars.mma_done(1), (n - 1) & 1);
    }
#pragma unroll
    for (int kc = 0; kc < C::KCH; ++kc) {
      mbar_wait(bars.full(s), phase);
      wgmma_fence();
      const uint32_t a = ring + s * CHUNK, b = wsm + kc * C::W_CHUNK + COL0 * ROW;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        if (kc + 1 < C::KCH || ks < C::LAST_STEPS)
          wgmma_n<NW>(acc, sw128_desc(a + 32 * ks), sw128_desc(b + 32 * ks));
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0 && lane == 0) mbar_arrive(bars.empty(prev));
      prev = s;
      if (++s == C::RING) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(bars.empty(prev));
    if (C::E == GELU && tid == 0) mbar_arrive(bars.mma_done(CW));

    if constexpr (C::E == RESIDUAL) {
      const int sb = n & 1;
      // tile n - 1's store has read its staging tile: tile n + 1's residual
      // may load there
      if (lead && n > 0) {
        bulk_wait_read<0>();
        mbar_arrive(bars.stage_free((n + 1) & 1));
      }
      mbar_wait(bars.res_full(sb), (n >> 1) & 1);
      __nv_bfloat162* row = stage_p + sb * (C::TILE_OUT / 4) + (r0 * C::OUT + c0) / 2;
#pragma unroll
      for (int i = 0; i < NW / 8; ++i) {
        if (c0 + 8 * i < C::OUT) {
          const float2 b = __bfloat1622float2(__ldg(bias2 + 4 * i));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            __nv_bfloat162* p = row + h * 4 * C::OUT + 4 * i;  // 8 rows down: 4 OUT pairs
            const float2 y = __bfloat1622float2(
                __floats2bfloat162_rn(acc[4 * i + 2 * h] + b.x, acc[4 * i + 2 * h + 1] + b.y));
            const float2 x = __bfloat1622float2(*p);
            *p = __floats2bfloat162_rn(x.x + y.x, x.y + y.y);
          }
        }
      }
      fence_proxy_async();  // the staging tile's writes, before the bulk store reads them
      consumers_sync();
      if (lead)
        bulk_store(out + (size_t)t * (C::TILE_OUT / 2), stage + sb * C::TILE_OUT, C::TILE_OUT);
    } else {
      // this consumer's part of the staging tile: slice 0, 64 rows of SA
      // columns, then slice 1, 64 rows of NW - SA, each dense
      const uint32_t part = stage + COL0 * TM * 2;
      __nv_bfloat162* part_p = stage_p + COL0 * TM / 2;
      // both slices' stores of the last tile have read them
      if (lead) bulk_wait_read<0>();
      consumer_sync(CW);
      // y = bf16(acc + b) into the slices
#pragma unroll
      for (int i = 0; i < NW / 8; ++i) {
        const int j = 8 * i < SA ? 0 : 1, w = j == 0 ? SA : NW - SA;
        __nv_bfloat162* row = part_p + (j * SA * TM + r0 * w + c0 - COL0 - j * SA) / 2;
        const float2 b = __bfloat1622float2(__ldg(bias2 + 4 * i));
#pragma unroll
        for (int h = 0; h < 2; ++h)
          row[h * 4 * w + 4 * i] =
              __floats2bfloat162_rn(acc[4 * i + 2 * h] + b.x, acc[4 * i + 2 * h + 1] + b.y);
      }
      consumer_sync(CW);
      // GELU over each slice in 16-byte pieces (eight independent chains a
      // thread), then the slice's store
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int w = j == 0 ? SA : NW - SA, off = j * SA * TM;  // the slice's width, start
        uint4* v = reinterpret_cast<uint4*>(part_p + off / 2);
#pragma unroll 2
        for (int k = tid; k < TM * w / 8; k += 128) {
          uint4 u = v[k];
          uint32_t* e = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 y = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(e + q));
            const __nv_bfloat162 g = __floats2bfloat162_rn(gelu_erf(y.x), gelu_erf(y.y));
            e[q] = *reinterpret_cast<const uint32_t*>(&g);
          }
          v[k] = u;
        }
        fence_proxy_async();
        consumer_sync(CW);
        if (lead) tma_store_2d(&maps.m[CW][j], part + off * 2, COL0 + j * SA, t * TM);
      }
    }
  }
  if (lead) bulk_wait_all();
}

template <int K, int N0, int N1, int N, int EPI>
__global__ void __launch_bounds__(tma::THREADS, 1)
token_gemm(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap w_map,
           const __grid_constant__ OutMaps out_maps, const __nv_bfloat16* __restrict__ bias,
           const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out, int tiles) {
  using C = Cfg<K, N0, N1, N, EPI>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t wsm = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t ring = wsm + C::W_BYTES, stage = ring + C::RING * CHUNK;
  __nv_bfloat162* stage_p = reinterpret_cast<__nv_bfloat162*>(smem + (stage - smem_addr(smem)));
  const Bars bars{stage + C::SBUF * C::TILE_OUT};
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bars.w_full(), 1);
    for (int s = 0; s < C::RING; ++s) {
      mbar_init(bars.full(s), 1);
      mbar_init(bars.empty(s), 8);  // one arrive a consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(bars.res_full(b), 1);
      mbar_init(bars.stage_free(b), 1);
      mbar_init(bars.mma_done(b), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(tma::PRODUCER_REGS));
    if (tid != 0) return;
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&a_map)) : "memory");
    // the weight, once: every chunk's boxes of rows
    mbar_expect_tx(bars.w_full(), C::W_BYTES);
    for (int kc = 0; kc < C::KCH; ++kc)
      for (int j = 0; j < C::NBOX; ++j)
        tma_load_2d(wsm + kc * C::W_CHUNK + j * C::BOX_N * ROW, &w_map, bars.w_full(), kc * KW,
                    j * C::BOX_N);
    int s = 0, n = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++n) {
      if constexpr (EPI == RESIDUAL) {
        // the tile's residual into its staging tile, once tile n - 2's
        // store has read it
        const int b = n & 1;
        mbar_wait(bars.stage_free(b), ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(bars.res_full(b), C::TILE_OUT);
        bulk_load(stage + b * C::TILE_OUT, res + (size_t)t * (C::TILE_OUT / 2), C::TILE_OUT,
                  bars.res_full(b));
      }
      for (int kc = 0; kc < C::KCH; ++kc) {
        mbar_wait(bars.empty(s), phase ^ 1);
        mbar_expect_tx(bars.full(s), CHUNK);
        tma_load_2d(ring + s * CHUNK, &a_map, bars.full(s), kc * KW, t * TM);
        if (++s == C::RING) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups: wgmma and the epilogue ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(tma::CONSUMER_REGS));
    if (tid < 256)
      consume<C, 0, N0, 0>(wsm, ring, stage, stage_p, bars, out_maps, bias, out, tiles);
    else
      consume<C, 1, N1, N0>(wsm, ring, stage, stage_p, bars, out_maps, bias, out, tiles);
  }
}

// The 2-d map (column, row) of a row-major bf16 (rows, cols) tensor, read
// or written in boxes of box_cols x box_rows: 128-byte swizzled for the
// wgmma operands (box_cols 64), plain rows for the GELU epilogue's stores.
cudaError_t tensor_map_2d(CUtensorMap* map, const void* base, long long rows, int cols,
                          int box_cols, int box_rows, bool swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
         estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
         swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int K, int N0, int N1, int N, int EPI>
cudaError_t launch(const void* a, const void* w, const void* bias, const void* res, void* out,
                   long long M, cudaStream_t s) {
  using C = Cfg<K, N0, N1, N, EPI>;
  CUtensorMap a_map, w_map;
  OutMaps out_maps = {};
  const long long tiles = M / TM;
  if (tiles > 0x7fffffffLL / TM) return cudaErrorInvalidValue;
  cudaError_t e = tensor_map_2d(&a_map, a, M, K, KW, TM, true);
  if (e == cudaSuccess) e = tensor_map_2d(&w_map, w, N, K, KW, C::BOX_N, true);
  if (EPI == GELU) {  // each consumer's two slices of out
    const int widths[2][2] = {{slice_a(N0), N0 - slice_a(N0)}, {slice_a(N1), N1 - slice_a(N1)}};
    for (int c = 0; c < 2; ++c)
      for (int j = 0; j < 2 && e == cudaSuccess; ++j)
        e = tensor_map_2d(&out_maps.m[c][j], out, M, N, widths[c][j], TM, false);
  }
  int grid = 0;
  if (e == cudaSuccess)
    e = persistent_grid<KernelTag<C>>(token_gemm<K, N0, N1, N, EPI>, C::SMEM, tiles, &grid);
  if (e != cudaSuccess) return e;
  token_gemm<K, N0, N1, N, EPI><<<grid, tma::THREADS, C::SMEM, s>>>(
      a_map, w_map, out_maps, static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(res), static_cast<__nv_bfloat16*>(out), (int)tiles);
  return cudaGetLastError();
}

// The instantiations, by (K, N, epilogue): ops/token_gemm.py::SHAPES lists
// the same.  -1: none.
#define INNFER_TOKEN_GEMM_SHAPES(X)   \
  X(184, 96, 88, 180, RESIDUAL)       \
  X(184, 184, 176, 360, GELU)         \
  X(360, 96, 88, 180, RESIDUAL)

}  // namespace

extern "C" {

// a (M, K), w (N, K), bias (N,), res and out (M, N) bf16, row-major and
// contiguous; M % 64 == 0; gelu 0 (out = res + linear) or 1 (out =
// gelu(linear), res unused); a, w, res, out 16-byte and bias 4-byte aligned
// (checked by the wrapper, ops/token_gemm.py).
int innfer_token_gemm(const void* a, const void* w, const void* bias, const void* res, void* out,
                      long long M, int K, int N, int gelu, cudaStream_t stream) {
  if (M < TM || M % TM) return (int)cudaErrorInvalidValue;
#define X(k, n0, n1, n, epi)                                   \
  if (K == k && N == n && gelu == (epi == GELU))               \
    return (int)launch<k, n0, n1, n, epi>(a, w, bias, res, out, M, stream);
  INNFER_TOKEN_GEMM_SHAPES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory (bytes) of the instantiation for (K, N, gelu),
// for the build report; -1 where there is none.
int innfer_token_gemm_smem_bytes(int K, int N, int gelu) {
#define X(k, n0, n1, n, epi) \
  if (K == k && N == n && gelu == (epi == GELU)) return Cfg<k, n0, n1, n, epi>::SMEM;
  INNFER_TOKEN_GEMM_SHAPES(X)
#undef X
  return -1;
}

const char* innfer_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
