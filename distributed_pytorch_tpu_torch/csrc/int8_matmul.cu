// int8 x int8 -> int32 matrix product with the dequantizing epilogue, for
// Hopper (sm_90a).  Built by ops/_build.py with nvcc into a shared library
// with a plain C interface and called through ctypes from
// ops/quantized.py (int8_matmul_q).
//
// Replaces the JAX package's Pallas TPU kernel
//   K5  distributed_pytorch_tpu/ops/quantized.py:91  _matmul_kernel
//
// What it computes, for qx int8 (m, k) row-major, qwt int8 (n, k) row-major
// (the weight's columns as rows), sx float32 (m,), sw float32 (n,):
//   out[i][j] = float(sum_t qx[i][t] * qwt[j][t]) * (sx[i] * sw[j])
// the exact int32 sum (|sum| <= 127^2 k < 2^31 for k <= MAX_K, so no
// saturation), converted round-to-nearest (__int2float_rn) and multiplied in
// the JAX association acc * (sx * sw), written as float32, or as that float
// rounded to bfloat16 (__float2bfloat16_rn) when the caller asks for bf16:
// the cast the bf16 forward applies to the float32 product anyway (JAX
// quantized_matmul's out.astype(x.dtype)), folded into the store.  Either
// output is bitwise the plain version's (ops/quantized.py
// int8_matmul_plain) and, in float32, the JAX kernel's on the same
// quantized operands.
//
// What bounds it on the card: at the transformer's shapes (m = 8192 tokens,
// k, n in {1024, 4096}) 2 m n k operations over 1,979 int8 TOP/s, except
// the 1024-deep products with a float32 output, where the output's 4 m n
// bytes over the memory rate take a little longer.  With a bf16 output
// every main-path shape is bound by operations.  The sm90 route runs its
// k loop near the tensor cores' rate; what it still pays is a fixed cost a
// launch (the ring's first fill, the last tile's epilogue) and, a tile,
// the epilogue the tensor cores wait through (PERF.md).
//
// Two routes, chosen by make_plan before the launch from the shape and the
// pointers' alignment alone:
// - sm90 (TMA can read the operands and write the output: k % 16 == 0, an
//   output row of whole 16-byte units, 16-byte-aligned pointers: every
//   main-path shape), int8_matmul_sm90_kernel:
//   - persistent: one block per SM walks the output tiles of 128 rows x
//     256 columns in the order tile_of gives (n fastest, so the blocks
//     running at once share the rows of qx they read);
//   - warp-specialized: warpgroups 0 and 1 consume, 64 rows of the tile
//     each; one thread of warpgroup 2 issues every TMA load; setmaxnreg
//     gives the consumers 240 registers and the producer 24;
//   - TMA brings 128-byte k slices of qx (128 rows) and qwt (256 rows),
//     128-byte swizzled, into a ring of 4 stages with a full and an empty
//     mbarrier each; the producer streams across tiles without a break,
//     so the next tile's loads run during this one's epilogue.  Bytes past
//     m, n or k arrive as zeros, which add nothing to an integer sum;
//   - the products are wgmma.m64n256k32.s32.s8.s8 from shared memory, both
//     operands K-major, the int32 accumulators in registers for the whole
//     k loop, one group of products kept in flight;
//   - the epilogue: the tile's row and column scales are loaded into
//     registers when the tile starts; each warpgroup writes its rows, a
//     panel of 64 rows x 128 bytes at a time, into the 128-byte swizzle
//     TMA reads, and one thread stores the panel by TMA (which drops what
//     lies past m or n) while the next is written, into two buffers taken
//     in turns.  The stores drain while the next tile's products run:
//     written from registers they stalled every SM at once at the memory
//     rate.
// - mma_sync (any other shape or alignment; k = 1000, a misaligned view, a
//   bf16 output of n % 8 != 0 columns), int8_matmul_kernel: one 128 x 128
//   tile per block of 8 warps, mma.sync.m16n8k32 from 64-byte k tiles
//   double-buffered by cp.async (byte by byte where k or a pointer forbids
//   16-byte copies), zero-padded edges, the same epilogue arithmetic stored
//   element by element.
// No atomics and a fixed order: two runs are bitwise equal.
//
// The launch plan (route, tile, persistent blocks, tile order, shared
// memory) is the plain C++ before the #ifdef below; the host compiler
// builds it alone for the tests (tests/test_torch_quantized.py).
//
// Tried and not kept (PERF.md section 6): 128 x 128 tiles (6 stages;
// slower in bf16 at every main-path shape); clusters of two blocks down m
// sharing each qwt tile by TMA multicast (a third less L2 traffic, no
// faster: the L2 was not the limit); a whole tile staged at once (3 ring
// stages, the long k loop slower).

#include <stdint.h>

#ifdef __CUDACC__
#define K5_HD __host__ __device__
#else
#define K5_HD
#endif

namespace {

constexpr int kErrBadArgs = 1;      // cudaErrorInvalidValue
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block can use
enum Route { kMmaSync = 0, kSm90 = 1 };

// sm90 route: output rows and columns a tile (2 consumer warpgroups x 64
// rows), k bytes a stage (one 128-byte swizzled row)
constexpr int kBM = 128, kBN = 256, kBK = 128;
// mma_sync route: tile rows, columns, k bytes a stage; padded shared row
constexpr int kSyncBM = 128, kSyncBN = 128, kSyncBK = 64;
constexpr int kSyncStride = kSyncBK + 16;

// sm90 epilogue: each consumer warpgroup stages its 64 output rows a panel
// of 64 rows x 128 bytes (64 bf16 or 32 float32 columns) at a time for a
// TMA store, in kPanels buffers taken in turns
constexpr int kPanel = 64 * 128, kPanels = 2;

// Dynamic shared memory of the sm90 kernel with `stages` ring stages: the
// qx and qwt rings, each consumer warpgroup's output staging, a full and
// an empty barrier a stage, and the slack that lets the base round up to
// 1024 bytes.
constexpr int sm90_smem(int stages) {
  return stages * (kBM + kBN) * kBK + 2 * kPanels * kPanel + 16 * stages +
         1024;
}

// As many stages as fit: 4.
constexpr int kStages =
    (kSmemLimit - sm90_smem(0)) / ((kBM + kBN) * kBK + 16);

struct Plan {
  int route;                    // kMmaSync or kSm90
  int bm, bn, bk;               // tile rows, columns; k bytes a stage
  int tiles_m, tiles_n, tiles;  // output tiles down, across, in all
  int blocks;                   // blocks launched
  int stages;                   // k stages in shared memory
  int smem;                     // shared memory of a block, bytes
};

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The plan of one launch over (M, N, K) with `out_size`-byte outputs (4
// float32, 2 bf16) on `n_sm` SMs.  `aligned` says the int8 operands, the
// column scales and the output are 16-byte aligned.  `route`: -1 the rule
// (sm90 where TMA can read the operands and write the output: `aligned`,
// k % 16 == 0 and N * out_size % 16 == 0), kMmaSync or kSm90 to ask for one
// (refused where it cannot run).  False for arguments no launch takes.
bool make_plan(int M, int N, int K, int out_size, int aligned, int route,
               int n_sm, Plan* p) {
  if (M < 1 || N < 1 || K < 1 || K > 133000 || n_sm < 1 || route < -1 ||
      route > kSm90 || (out_size != 2 && out_size != 4))
    return false;
  const bool tma =
      aligned && K % 16 == 0 && static_cast<int64_t>(N) * out_size % 16 == 0;
  if (route == -1) route = tma ? kSm90 : kMmaSync;
  if (route == kSm90 && !tma) return false;
  p->route = route;
  if (route == kSm90) {
    p->bm = kBM;
    p->bn = kBN;
    p->bk = kBK;
    p->stages = kStages;
    p->smem = sm90_smem(kStages);
  } else {
    p->bm = kSyncBM;
    p->bn = kSyncBN;
    p->bk = kSyncBK;
    p->stages = 2;
    p->smem = 2 * (kSyncBM + kSyncBN) * kSyncStride;
  }
  const int64_t tm = cdiv(M, p->bm), tn = cdiv(N, p->bn);
  if (tm * tn > 2147483647LL || (route == kMmaSync && tm > 65535))
    return false;
  p->tiles_m = static_cast<int>(tm);
  p->tiles_n = static_cast<int>(tn);
  p->tiles = static_cast<int>(tm * tn);
  p->blocks = route == kSm90 && n_sm < p->tiles ? n_sm : p->tiles;
  return true;
}

// The output tile (tile row *tm, tile column *tn) persistent block `block`
// of `blocks` takes in its round `r`: tile r * blocks + block, n fastest.
// False once the block has no tile left.
K5_HD inline bool tile_of(int block, int blocks, int r, int tiles,
                          int tiles_n, int* tm, int* tn) {
  const int64_t t = static_cast<int64_t>(r) * blocks + block;
  if (t >= tiles) return false;
  *tm = static_cast<int>(t / tiles_n);
  *tn = static_cast<int>(t % tiles_n);
  return true;
}

}  // namespace

// The plan of a launch (make_plan): out = route, bm, bn, bk, tiles_m,
// tiles_n, tiles, blocks, stages, smem.  Returns 0, or
// cudaErrorInvalidValue for arguments no launch takes.
extern "C" int int8_matmul_plan(int M, int N, int K, int out_size,
                                int aligned, int route, int n_sm,
                                int64_t* out) {
  Plan p;
  if (!make_plan(M, N, K, out_size, aligned, route, n_sm, &p))
    return kErrBadArgs;
  const int64_t v[10] = {p.route,   p.bm,    p.bn,     p.bk,     p.tiles_m,
                         p.tiles_n, p.tiles, p.blocks, p.stages, p.smem};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

// tile_of for the tests: 1 and the tile in out[0] (row), out[1] (column),
// or 0 once the block has no tile left.
extern "C" int int8_matmul_tile(int block, int blocks, int r, int tiles,
                                int tiles_n, int* out) {
  return tile_of(block, blocks, r, tiles, tiles_n, out, out + 1) ? 1 : 0;
}

#ifdef __CUDACC__

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

// The epilogue's value, acc * (sx * sw) in that order, stored as OutT.
__device__ __forceinline__ float dequant(int acc, float s_row, float s_col) {
  return __fmul_rn(__int2float_rn(acc), __fmul_rn(s_row, s_col));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ------------------------------------------------------- mma_sync route

constexpr int kSyncThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One 128-row x 64-byte k tile of a row-major (rows, k) int8 operand into
// shared memory, rows from r0 and k from k0; zeros past rows and k.
template <bool kVec>
__device__ __forceinline__ void load_tile(int8_t* smem, const int8_t* g,
                                          int rows, int k, int r0, int k0) {
#pragma unroll
  for (int i = 0; i < (kSyncBM * kSyncBK / 16) / kSyncThreads; ++i) {
    const int c = threadIdx.x + i * kSyncThreads;
    const int row = c / (kSyncBK / 16), col = (c % (kSyncBK / 16)) * 16;
    int8_t* dst = smem + row * kSyncStride + col;
    const int gr = r0 + row, gk = k0 + col;
    if constexpr (kVec) {
      // k % 16 == 0: a 16-byte chunk is wholly inside or wholly past k
      const bool in = gr < rows && gk < k;
      cp_async16(dst, in ? g + static_cast<int64_t>(gr) * k + gk : g,
                 in ? 16 : 0);
    } else {
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        dst[b] = (gr < rows && gk + b < k)
                     ? g[static_cast<int64_t>(gr) * k + gk + b]
                     : int8_t(0);
      }
    }
  }
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One 128 x 128 output tile per block: 8 warps (2 x 4), each 64 x 32 of it
// as 4 x 4 mma.sync.m16n8k32 tiles; every fragment register one aligned
// 32-bit shared load (rows padded to 80 bytes so the eight rows one load
// touches fall in distinct banks).
template <bool kVec, typename OutT>
__global__ void __launch_bounds__(kSyncThreads)
    int8_matmul_kernel(const int8_t* __restrict__ qx,
                       const int8_t* __restrict__ qwt,
                       const float* __restrict__ sx,
                       const float* __restrict__ sw, OutT* __restrict__ out,
                       int M, int N, int K) {
  __shared__ __align__(16) int8_t As[2][kSyncBM * kSyncStride];
  __shared__ __align__(16) int8_t Bs[2][kSyncBN * kSyncStride];

  const int m0 = blockIdx.y * kSyncBM, n0 = blockIdx.x * kSyncBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int gid = lane / 4, tig = lane % 4;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int n_k = (K + kSyncBK - 1) / kSyncBK;
  load_tile<kVec>(As[0], qx, M, K, m0, 0);
  load_tile<kVec>(Bs[0], qwt, N, K, n0, 0);
  cp_async_commit();

  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_k) {
      load_tile<kVec>(As[buf ^ 1], qx, M, K, m0, (kt + 1) * kSyncBK);
      load_tile<kVec>(Bs[buf ^ 1], qwt, N, K, n0, (kt + 1) * kSyncBK);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile kt has landed (tile kt + 1 may be in flight)
    __syncthreads();

    const int8_t* a = As[buf];
    const int8_t* b = Bs[buf];
#pragma unroll
    for (int ks = 0; ks < kSyncBK; ks += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = a + (wm + i * 16 + gid) * kSyncStride + ks + tig * 4;
        af[i][0] = lds32(p);
        af[i][1] = lds32(p + 8 * kSyncStride);
        af[i][2] = lds32(p + 16);
        af[i][3] = lds32(p + 8 * kSyncStride + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = b + (wn + j * 8 + gid) * kSyncStride + ks + tig * 4;
        bf[j][0] = lds32(p);
        bf[j][1] = lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3], bf[j][0],
                 bf[j][1]);
    }
    __syncthreads();  // everyone is done with buf before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + i * 16 + gid + h * 8;
      if (row >= M) continue;
      const float srow = sx[row];
      OutT* orow = out + static_cast<int64_t>(row) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + j * 8 + tig * 2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e < N)
            store1(orow + col + e,
                   dequant(acc[i][j][h * 2 + e], srow, sw[col + e]));
        }
      }
    }
  }
}

// ----------------------------------------------------------- sm90 route

constexpr int kSm90Threads = 384;  // warpgroups 0, 1 consume; 2 produces
constexpr uint32_t kConsumerRegs = 240, kProducerRegs = 24;

// Shared memory of int8_matmul_sm90_kernel, in bytes from a 1024-aligned
// base: the qx ring (128 rows x 128 bytes a stage), the qwt ring (256 rows
// x 128 bytes), each consumer warpgroup's output staging (kPanels panels),
// then per stage a full and an empty barrier.
struct Sm90 {
  static constexpr uint32_t a_stage = kBM * kBK, b_stage = kBN * kBK;
  static constexpr uint32_t b_off = kStages * a_stage;  // qx ring at 0
  static constexpr uint32_t out_off = b_off + kStages * b_stage;
  static constexpr uint32_t bar_off = out_off + 2 * kPanels * kPanel;
  static constexpr uint32_t smem = sm90_smem(kStages);
  static_assert(bar_off + 16 * kStages + 1024 == smem, "layout");
};

// Persistent and warp-specialized; the layout, the pipeline and the
// epilogue are in the header comment.
template <typename OutT>
__global__ void __launch_bounds__(kSm90Threads, 1)
    int8_matmul_sm90_kernel(const __grid_constant__ CUtensorMap tm_a,
                            const __grid_constant__ CUtensorMap tm_b,
                            const __grid_constant__ CUtensorMap tm_out,
                            const float* __restrict__ sx,
                            const float* __restrict__ sw, int M, int N,
                            int K, int tiles_n, int tiles) {
  using L = Sm90;
  extern __shared__ __align__(1024) unsigned char k5_smem[];
  const uint32_t base = (sm90::smem_addr(k5_smem) + 1023u) & ~1023u;
  auto full = [&](int s) { return base + L::bar_off + 16 * s; };
  auto empty = [&](int s) { return base + L::bar_off + 16 * s + 8; };
  const int n_k = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;
  int tm, tn;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), 2);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // ------------------------------------------- producer
    sm90::regs_dec<kProducerRegs>();
    if (threadIdx.x != 256) return;
    // k slice `it` (counted over all tiles) goes to stage it % S once the
    // consumers have released the stage's previous use (the first passes)
    int it = 0;
    for (int r = 0; tile_of(blockIdx.x, gridDim.x, r, tiles, tiles_n, &tm,
                            &tn);
         ++r) {
      for (int kt = 0; kt < n_k; ++kt, ++it) {
        const int s = it % kStages;
        sm90::mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(full(s), L::a_stage + L::b_stage);
        sm90::tma_load_2d(base + s * L::a_stage, &tm_a, full(s), kt * kBK,
                          tm * kBM);
        sm90::tma_load_2d(base + L::b_off + s * L::b_stage, &tm_b, full(s),
                          kt * kBK, tn * kBN);
      }
    }
  } else {  // ----------------------------------------------- consumers
    sm90::regs_inc<kConsumerRegs>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int rl = 16 * warp + lane / 4;  // acc[4j + e]: row rl + 8(e/2),
    const int cq = 2 * (lane % 4);        //   column 8j + cq + e%2
    const int sz = lane / 4;              // rl % 8: the rows' swizzle
    const uint32_t stage = base + L::out_off + wg * kPanels * kPanel;
    int acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
    int it = 0;
    for (int r = 0; tile_of(blockIdx.x, gridDim.x, r, tiles, tiles_n, &tm,
                            &tn);
         ++r) {
      const int row0 = tm * kBM + 64 * wg + rl, n0 = tn * kBN;
      // the tile's scales, loaded now and used after the k loop: the rows'
      // and a pair of columns a column group (the output rows are whole
      // 16-byte units, the plan's rule, so N is even and a pair is inside
      // N or wholly past it)
      const float sx0 = row0 < M ? sx[row0] : 0.f;
      const float sx1 = row0 + 8 < M ? sx[row0 + 8] : 0.f;
      float2 wv[kBN / 8];
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int c = n0 + 8 * j + cq;
        wv[j] = c < N ? __ldg(reinterpret_cast<const float2*>(sw + c))
                      : make_float2(0.f, 0.f);
      }

      for (int kt = 0; kt < n_k; ++kt, ++it) {
        const int s = it % kStages;
        sm90::mbar_wait(full(s), (it / kStages) & 1);
        const uint32_t a = base + s * L::a_stage + wg * 64 * kBK;
        const uint32_t b = base + L::b_off + s * L::b_stage;
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk)
          sm90::wgmma_m64n256k32_s8(
              acc, sm90::desc_sw128(a + 32 * kk, 16, 1024),
              sm90::desc_sw128(b + 32 * kk, 16, 1024), kt > 0 || kk > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // the previous slice's products are done
        sm90::fence_regs(acc);
        if (kt > 0 && t == 0)
          sm90::mbar_arrive(empty((it - 1) % kStages));
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      if (t == 0) sm90::mbar_arrive(empty((it - 1) % kStages));

      // epilogue: acc * (sx * sw) as OutT into staging panels (the
      // 128-byte swizzle TMA reads), each stored by TMA as soon as it is
      // written, into the buffers in turns; the stores drain while the
      // next panel is written and the next tile's products run
      constexpr int kCols = 128 / sizeof(OutT);  // columns a panel
      constexpr int kGroups = kCols / 8;         // acc column groups a panel
      const int row_g = tm * kBM + 64 * wg;
      // panel pn written: hand it to TMA
      auto store_panel = [&](int pn) {
        sm90::fence_proxy_async_smem();
        sm90::named_barrier_sync(1 + wg, 128);
        if (t == 0) {
          sm90::tma_store_2d(&tm_out, stage + (pn % kPanels) * kPanel,
                             n0 + pn * kCols, row_g);
          sm90::tma_store_commit();
        }
      };
      // one loop over the column groups, unrolled (a loop over panels
      // around it put acc in local memory)
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int pn = j / kGroups;
        if (j % kGroups == 0) {
          if (j > 0) store_panel(pn - 1);
          // the buffer's last store (kPanels panels ago) has read it
          if (t == 0) sm90::tma_store_wait_read_until<kPanels - 1>();
          sm90::named_barrier_sync(1 + wg, 128);
        }
        const int c = 8 * j + cq;  // the tile's column of acc[4j + e%2]
        const int byte = (c % kCols) * static_cast<int>(sizeof(OutT));
        const uint32_t panel = stage + (pn % kPanels) * kPanel;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float s_row = h ? sx1 : sx0;
          const float v0 = dequant(acc[4 * j + 2 * h], s_row, wv[j].x);
          const float v1 = dequant(acc[4 * j + 2 * h + 1], s_row, wv[j].y);
          const uint32_t a = panel + (rl + 8 * h) * 128 +
                             (((byte / 16) ^ sz) * 16) + byte % 16;
          if constexpr (sizeof(OutT) == 4)
            sm90::st_shared_v2_f32(a, v0, v1);
          else
            sm90::st_shared_u32(a, sm90::pack_bf16(v0, v1));
        }
      }
      store_panel(kBN / kCols - 1);
    }
    if (t == 0) sm90::tma_store_wait_all();
  }
}

// A row-major (rows, K) int8 matrix as a 2-D tensor {K, rows}, moved in
// boxes of kBK bytes x `box_rows` rows, 128-byte swizzled; bytes past the
// matrix read as zeros.
bool encode_i8(sm90::EncodeTiled enc, CUtensorMap* map, const void* ptr,
               int rows, int K, int box_rows) {
  const cuuint64_t dims[2] = {cuuint64_t(K), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(K)};
  const cuuint32_t box[2] = {kBK, cuuint32_t(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A row-major (M, N) output of `size`-byte values as a 2-D tensor {N, M},
// stored in boxes of one 128-byte panel row x 64 rows, 128-byte swizzled;
// the parts of a box past the matrix are not written.
bool encode_out(sm90::EncodeTiled enc, CUtensorMap* map, void* ptr, int M,
                int N, int size) {
  const cuuint64_t dims[2] = {cuuint64_t(N), cuuint64_t(M)};
  const cuuint64_t strides[1] = {cuuint64_t(N) * size};
  const cuuint32_t box[2] = {cuuint32_t(128 / size), 64};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map,
             size == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             2, ptr, dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Operands {
  const int8_t* qx;
  const int8_t* qwt;
  const float* sx;
  const float* sw;
  void* out;
  int M, N, K;
};

template <typename OutT>
int launch_sm90(const Plan& p, const Operands& o, cudaStream_t stream) {
  const sm90::EncodeTiled enc = sm90::tensor_map_encoder();
  if (!enc) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap ta, tb, to;
  if (!encode_i8(enc, &ta, o.qx, o.M, o.K, kBM) ||
      !encode_i8(enc, &tb, o.qwt, o.N, o.K, kBN) ||
      !encode_out(enc, &to, o.out, o.M, o.N, sizeof(OutT)))
    return kErrBadArgs;
  auto* kernel = int8_matmul_sm90_kernel<OutT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.blocks, kSm90Threads, p.smem, stream>>>(
      ta, tb, to, o.sx, o.sw, o.M, o.N, o.K, p.tiles_n, p.tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int launch(const Plan& p, const Operands& o, cudaStream_t stream) {
  if (p.route == kSm90) return launch_sm90<OutT>(p, o, stream);
  const dim3 grid(p.tiles_n, p.tiles_m);
  auto* out = static_cast<OutT*>(o.out);
  if (o.K % 16 == 0 && reinterpret_cast<uintptr_t>(o.qx) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(o.qwt) % 16 == 0)
    int8_matmul_kernel<true, OutT><<<grid, kSyncThreads, 0, stream>>>(
        o.qx, o.qwt, o.sx, o.sw, out, o.M, o.N, o.K);
  else
    int8_matmul_kernel<false, OutT><<<grid, kSyncThreads, 0, stream>>>(
        o.qx, o.qwt, o.sx, o.sw, out, o.M, o.N, o.K);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// K5: out (M, N) = (qx (M, K) int8 . qwt (N, K) int8^T) * (sx sw^T), as
// float32 (out_dtype 0) or bfloat16 (1).  `route` as make_plan takes it (-1:
// the rule); the route the launch took goes to *route_taken (kMmaSync 0,
// kSm90 1).  Returns 0 or a CUDA error code (cudaErrorInvalidValue for
// arguments no launch takes).
extern "C" int int8_matmul_launch(const void* qx, const void* qwt,
                                  const void* sx, const void* sw, void* out,
                                  int M, int N, int K, int out_dtype,
                                  int route, int* route_taken,
                                  void* stream) {
  Plan p;
  if ((out_dtype != 0 && out_dtype != 1) ||
      !make_plan(M, N, K, out_dtype == 0 ? 4 : 2,
                 aligned16(qx) && aligned16(qwt) && aligned16(out) &&
                     aligned16(sw),
                 route, sm90::sm_count(), &p))
    return kErrBadArgs;
  *route_taken = p.route;
  const Operands o{static_cast<const int8_t*>(qx),
                   static_cast<const int8_t*>(qwt),
                   static_cast<const float*>(sx),
                   static_cast<const float*>(sw), out, M, N, K};
  auto st = static_cast<cudaStream_t>(stream);
  return out_dtype == 0 ? launch<float>(p, o, st)
                        : launch<__nv_bfloat16>(p, o, st);
}

// Registers, spills and shared memory are in nvcc's -Xptxas -v report; the
// sm90 kernel's dynamic shared memory.
extern "C" int int8_matmul_sm90_smem() { return Sm90::smem; }

extern "C" const char* int8_matmul_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#endif  // __CUDACC__
