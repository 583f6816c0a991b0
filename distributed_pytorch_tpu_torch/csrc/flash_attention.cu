// Flash attention forward and backward for Hopper (sm_90a).  Built by
// ops/_build.py with nvcc into a shared library with a plain C interface and
// called through ctypes from ops/attention.py (flash_attention_fwd,
// flash_attention_bwd_dq, flash_attention_bwd_dkv).
//
// Replaces the JAX package's Pallas TPU kernels
//   K2  distributed_pytorch_tpu/ops/attention.py  _fwd_kernel      (fwd)
//   K3  distributed_pytorch_tpu/ops/attention.py  _bwd_dq_kernel   (dQ)
//   K4  distributed_pytorch_tpu/ops/attention.py  _bwd_dkv_kernel  (dK, dV)
// over (B*H, S, D) operands: q (BH, Sq, D), k and v (BH, Sk, D), all of one
// type T (float32 or bfloat16), D in {64, 128}.
//
// What they compute (the Pallas kernels' arithmetic, rounding points kept):
//   s = (q . k) * scale in float32, NEG_INF (-1e30) where masked (causal
//   kj > qi; keys past Sk; in K4 also queries past Sq);
//   K2: online softmax over key tiles, running max m and sum l in float32,
//       p = exp(s - m) rounded to T before P.V, float32 accumulator;
//       o = acc / max(l, 1e-30) in T, lse = m + log(max(l, 1e-30)) float32.
//   K3: p = exp(s - lse), dp = do . v, ds = p * (dp - delta) * scale,
//       dq = sum over key tiles of T(ds) . k   (delta = rowsum(do*o) - dlse,
//       computed by the caller).
//   K4: per key tile, over the query tiles at or after it (causal):
//       dv += T(p)^T . do, dk += T(ds)^T . q.
// Everything accumulates in float32.
//
// The bf16 instances are built for Hopper's own machinery, on sm90.cuh:
// K2 fwd_sm90_kernel, K3 bwd_dq_sm90_kernel, K4 bwd_dkv_sm90_kernel.
// - Persistent and warp-specialized: one block of 384 threads per SM walks
//   a list of work tiles of 128 rows of one (b, h), heaviest causal tiles
//   first (query tiles from the last in K2 and K3, key tiles from the
//   first in K4), dealt to the blocks in snake order so heavy and light
//   tiles even out.  Warpgroups 0 and 1 (the consumers) own 64 rows each;
//   warpgroup 2 is the producer, one thread of which issues every TMA
//   load.  setmaxnreg gives the consumers 240 registers and the producer
//   24.
// - TMA brings the work tile's own operands once (two stages, so the next
//   tile's land while this one runs) and streams the others through rings
//   of shared-memory stages, each stage with a "full" mbarrier (the
//   expected bytes, counted down by TMA) and an "empty" one (one arrival
//   per consumer warpgroup).  The producer streams across work tiles
//   without a break.  Tiles arrive 128-byte swizzled, the layout the wgmma
//   descriptors name; rows past Sq or Sk arrive as zeros.
//   K2: q once; k and v in 128-row tiles (2 stages each at D = 128, 4 at
//       D = 64), k issued a tile ahead of v.
//   K3: q and do once; k and v in 64-row tiles (3 stages each at D = 128,
//       4 at D = 64: a k stage is held until the dq product that reads it
//       is done, so a third stage gives its refill a whole step); each
//       thread keeps its two rows' lse (in base 2) and delta in
//       registers.
//   K4: k and v once; q, do and their 64 rows' lse and delta (flat f32
//       arrays through a 1-D tensor map) in 64-row tiles through one ring
//       (3 stages at D = 128, 4 at D = 64).
// - Every product is wgmma with f32 accumulators in registers: the scores
//   (S = q.k^T in K2 and K3; S^T = k.q^T in K4) and dP (do.v^T; v.do^T)
//   from shared memory, both operands K-major (m64n128k16 in K2,
//   m64n64k16 in K3 and K4).  The exponent runs on the accumulator layout
//   in base 2: p = 2^(s * scale log2 e - m) in K2 (online softmax, the max
//   taken on raw scores), p = 2^(s * scale log2 e - lse log2 e) in K3 and
//   K4; one FMA and one ex2.approx.ftz (2 ulp, results under 2^-126
//   flushed) an element, the mask applied only on tiles that cross the
//   diagonal, Sk or (K4) Sq.  The accumulator layout is the A layout:
//   p (K2, K4: dv += p^T . do) and ds (K3: dq += ds . k; K4: dk += ds^T .
//   q) are rounded to bf16 in registers and are the register A operand of
//   the next wgmma, whose B (v, k, do, q) is the tile already in shared
//   memory, read MN-major.  The accumulators (o; dq; dk and dv) stay in
//   registers for the whole loop: no product goes through shared memory.
// - Overlap: K2 issues S of key tile j and P.V of tile j-1, rescaling o
//   while S runs and taking tile j's softmax while P.V runs.  K3 issues S
//   and dP of key tile j with the dq product of tile j-1 still running and
//   takes p while dP runs.  K4 takes p while dP runs, then issues dv and
//   dk together (holding S, dP, dk and dv, 192 registers, leaves no room
//   for the next tile's products); its two warpgroups interleave on the
//   tensor cores instead.  Each issue opens its own wgmma.fence after
//   every register it touches is final, or ptxas serializes the products.
// - Under the causal mask a warpgroup skips the streamed tile that is
//   masked out for its 64 rows alone (K3: warpgroup 0's last key tile;
//   K4: warpgroup 1's first query tile): it waits for the tile and
//   releases it unread.
// - Epilogues: the outputs are written in bf16 into swizzled staging
//   rows and stored by TMA, which drops rows past Sq or Sk.  K2 stages o
//   (times 1/l; lse per row) in a tile of its own; K3 stages dq in the
//   warpgroup's own rows of the q tile and K4 dk and dv in its own rows
//   of the k and v tiles they came from, and each releases that stage
//   once the stores have read it (the 32 KB K3 saves are its third k/v
//   stage).
// No atomics and a fixed order: two runs are bitwise equal.  K3 and K4
// stay two kernels, as in the JAX package.
//
// The float32 instances keep the first layout: a block of 4 warps owns a
// 64-row tile (query rows in K2/K3, key rows in K4) and streams the other
// operand through shared memory in tiles of 32 rows; warp w owns rows
// 16w..16w+15 of every per-block matrix.  K4 is one block per key tile
// accumulating over query tiles.  Causal blocks loop only over the tiles
// that hold live entries.  They run on the CUDA cores in full float32 (no
// TF32): they are the numerics reference on the card.
//
// What bounds them: at the LM-base training shape (B*H = 64, S = 1024,
// D = 128, causal) the forward does 17.2 GFLOP of products against 67.4 MB
// of operands read and written once (255 operations per byte, just under
// the card's ~295 bf16 balance point, so bytes bound it by a hair); K3
// (306) and K4 (340) sit just above it.  Either way the bound is tens of
// microseconds.  The bf16 kernels reach 40-45% of it (PERF.md); what they
// still pay is per work tile (the first products and exponent and the
// last product overlap nothing, and both consumer warpgroups run them at
// the same time) and, in K4, the exponent between its products.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kM = 64;         // rows of the owned tile: 4 warps x 16 rows
constexpr float kNegInf = -1e30f;  // finite, as NEG_INF in ops/attention.py

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// Tiles of the float32 kernels (fwd_kernel, bwd_dq_kernel, bwd_dkv_kernel).
template <typename T, int D>
struct Cfg {
  static_assert(std::is_same<T, float>::value,
                "the bf16 kernels are the *_sm90_kernel ones");
  static constexpr int N = 32;          // rows of the streamed tile
  static constexpr int kCpl = N / 32;   // score columns per lane
  // leading dimensions in elements: +1 float keeps the column reads
  // conflict-free
  static constexpr int LDT = D + 1;  // T tiles (rows x D)
  static constexpr int LDS = N + 1;  // float scores (kM x N)
  static constexpr int LDP = LDS;    // p / ds overwrite the scores
  static constexpr int LDO = D + 1;  // float accumulators
  static constexpr size_t tile_m = align128(size_t(kM) * LDT * sizeof(T));
  static constexpr size_t tile_n = align128(size_t(N) * LDT * sizeof(T));
  static constexpr size_t score = align128(size_t(kM) * LDS * 4);
  static constexpr size_t acc = align128(size_t(kM) * LDO * 4);
  static constexpr size_t fwd_smem = tile_m + 2 * tile_n + score + acc;
  static constexpr size_t dq_smem =
      2 * tile_m + 2 * tile_n + 2 * score + acc + 2 * kM * 4;
  static constexpr size_t dkv_smem =
      2 * tile_m + 2 * tile_n + 2 * score + 2 * acc + 2 * N * 4;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy rows [row0, row0 + rows) of a (total, D) slab into a shared tile of
// leading dimension LD with 16-byte loads; rows past ``total`` are zeros.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int row0, int rows, int total) {
  constexpr int kEpc = 16 / sizeof(T);
  constexpr int kCpr = D / kEpc;
  for (int c = threadIdx.x; c < rows * kCpr; c += kThreads) {
    const int r = c / kCpr, e0 = (c % kCpr) * kEpc;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < total)
      raw = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * D + e0);
    if constexpr (LD % kEpc == 0) {
      *reinterpret_cast<uint4*>(dst + r * LD + e0) = raw;
    } else {
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kEpc; ++e) dst[r * LD + e0 + e] = v[e];
    }
  }
}

// Load ``rows`` float32 values starting at ``row0`` (zeros past ``total``).
__device__ __forceinline__ void load_vec(float* dst,
                                         const float* __restrict__ src,
                                         int row0, int rows, int total) {
  for (int i = threadIdx.x; i < rows; i += kThreads)
    dst[i] = row0 + i < total ? src[row0 + i] : 0.f;
}

// S[16w + r][c] = sum_d A[16w + r][d] * B[c][d] for the calling warp's 16
// rows of A (kM rows, LDT) and all N rows of B (LDT); S is float, LDS.
template <typename T, int D>
__device__ __forceinline__ void strip_abt(float* S, const T* A, const T* B,
                                          int warp, int lane) {
  using C = Cfg<T, D>;
  float acc[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) acc[r] = 0.f;
  const T* a = A + warp * 16 * C::LDT;
  const T* b = B + lane * C::LDT;  // N == 32: one column per lane
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float bv = b[d];
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[r] += a[r * C::LDT + d] * bv;
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) S[(warp * 16 + r) * C::LDS + lane] = acc[r];
}

// O[16w + r][n] += sum_j P[16w + r][j] * V[j][n] for the calling warp's 16
// rows: P is T (kM x N, LDP), V is T (N x D, LDT), O is float (kM x D, LDO).
template <typename T, int D>
__device__ __forceinline__ void strip_acc(float* O, const T* P, const T* V,
                                          int warp, int lane) {
  using C = Cfg<T, D>;
  constexpr int kCols = D / 32;
  float acc[16][kCols];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int t = 0; t < kCols; ++t)
      acc[r][t] = O[(warp * 16 + r) * C::LDO + lane + 32 * t];
  const T* p = P + warp * 16 * C::LDP;
#pragma unroll 2
  for (int j = 0; j < C::N; ++j) {
    float vv[kCols];
#pragma unroll
    for (int t = 0; t < kCols; ++t) vv[t] = V[j * C::LDT + lane + 32 * t];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float pv = p[r * C::LDP + j];
#pragma unroll
      for (int t = 0; t < kCols; ++t) acc[r][t] += pv * vv[t];
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int t = 0; t < kCols; ++t)
      O[(warp * 16 + r) * C::LDO + lane + 32 * t] = acc[r][t];
}

// Zero the calling warp's 16 rows of a float (kM x D, LDO) accumulator.
template <typename T, int D>
__device__ __forceinline__ void zero_rows(float* O, int warp, int lane) {
  using C = Cfg<T, D>;
  for (int r = 0; r < 16; ++r)
    for (int n = lane; n < D; n += 32) O[(warp * 16 + r) * C::LDO + n] = 0.f;
}

// Write the calling warp's rows of a float accumulator (times ``mul[r]``,
// or 1 without ``mul``) to rows row0 + 16w + r < total of a (total, D) slab
// of T.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ dst,
                                           const float* O, const float* mul,
                                           int row0, int total, int warp,
                                           int lane) {
  using C = Cfg<T, D>;
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + warp * 16 + r;
    if (row >= total) break;
    for (int n = lane; n < D; n += 32)
      dst[static_cast<size_t>(row) * D + n] =
          O[(warp * 16 + r) * C::LDO + n] * (mul ? mul[r] : 1.f);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* out0;    // o (K2), dq (K3), dk (K4)
  void* out1;    // dv (K4)
  float* lse;    // K2's lse output
  int Sq, Sk, causal;
  float scale;
};

// ------------------------------------------------------ K2, float32 ----
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) fwd_kernel(Args a) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + C::tile_m);
  T* Vs = reinterpret_cast<T*>(smem + C::tile_m + C::tile_n);
  float* Ss = reinterpret_cast<float*>(smem + C::tile_m + 2 * C::tile_n);
  T* Ps = Ss;  // float32: p overwrites the scores it came from
  float* Os = reinterpret_cast<float*>(smem + C::tile_m + 2 * C::tile_n +
                                       C::score);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kM;
  const size_t bh = blockIdx.y;
  const T* q = static_cast<const T*>(a.q) + bh * a.Sq * D;
  const T* k = static_cast<const T*>(a.k) + bh * a.Sk * D;
  const T* v = static_cast<const T*>(a.v) + bh * a.Sk * D;

  load_tile<T, D, C::LDT>(Qs, q, q0, kM, a.Sq);
  zero_rows<T, D>(Os, warp, lane);
  float m_run[16], l_run[16], alpha[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
  }
  int ntiles = (a.Sk + C::N - 1) / C::N;
  if (a.causal) ntiles = min(ntiles, (q0 + kM - 1) / C::N + 1);

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * C::N;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D, C::LDT>(Ks, k, k0, C::N, a.Sk);
    load_tile<T, D, C::LDT>(Vs, v, k0, C::N, a.Sk);
    __syncthreads();
    strip_abt<T, D>(Ss, Qs, Ks, warp, lane);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r, qi = q0 + row;
      float s[C::kCpl];
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < C::kCpl; ++t) {
        const int c = lane + 32 * t, kj = k0 + c;
        float x = Ss[row * C::LDS + c] * a.scale;
        if (kj >= a.Sk || (a.causal && kj > qi)) x = kNegInf;
        s[t] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m_run[r], warp_max(mx));
      alpha[r] = expf(m_run[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < C::kCpl; ++t) {
        const float p = expf(s[t] - m_new);
        sum += p;
        Ps[row * C::LDP + lane + 32 * t] = p;
      }
      l_run[r] = alpha[r] * l_run[r] + warp_sum(sum);
      m_run[r] = m_new;
      for (int n = lane; n < D; n += 32) Os[row * C::LDO + n] *= alpha[r];
    }
    __syncwarp();
    strip_acc<T, D>(Os, Ps, Vs, warp, lane);
    __syncwarp();
  }

  float inv[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float safe_l = fmaxf(l_run[r], 1e-30f);
    inv[r] = 1.f / safe_l;
    const int qi = q0 + warp * 16 + r;
    if (lane == 0 && qi < a.Sq)
      a.lse[bh * a.Sq + qi] = m_run[r] + logf(safe_l);
  }
  store_rows<T, D>(static_cast<T*>(a.out0) + bh * a.Sq * D, Os, inv, q0,
                   a.Sq, warp, lane);
}

// --------------------------------------------------------- K2, bf16 ----
constexpr int kFwdM = 128;        // query rows per work tile: 2 x 64
constexpr int kFwdN = 128;        // key rows per streamed k / v tile
constexpr int kFwdThreads = 384;  // warpgroups 0, 1 consume; 2 produces
constexpr uint32_t kConsumerRegs = 240, kProducerRegs = 24;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// Shared memory of fwd_sm90_kernel, in bytes from a 1024-aligned base.  A
// tile is D / 64 panels of rows x 128 bytes (sm90.cuh).
template <int D>
struct Fwd {
  static constexpr int kPanels = D / 64;
  static constexpr int kStages = D == 64 ? 4 : 2;  // per ring (k and v)
  static constexpr uint32_t q_panel = kFwdM * 128;
  static constexpr uint32_t kv_panel = kFwdN * 128;
  static constexpr uint32_t q_tile = kPanels * q_panel;    // q, or o staged
  static constexpr uint32_t kv_tile = kPanels * kv_panel;  // one k or v
  static constexpr uint32_t o_off = 2 * q_tile;            // q ring at 0
  static constexpr uint32_t k_off = o_off + q_tile;
  static constexpr uint32_t v_off = k_off + kStages * kv_tile;
  static constexpr uint32_t bar_off = v_off + kStages * kv_tile;
  // barriers, 8 bytes each: per q stage full, empty; then per k / v stage
  // k full, k empty, v full, v empty
  static constexpr uint32_t smem = bar_off + 8 * (4 + 4 * kStages) + 1024;
};

// Work tile i of the heaviest-first list: query tiles from the last (the
// most causal work) to the first, each over every (b, h).
__device__ __forceinline__ void work_tile(int i, int BH, int nq, int& bh,
                                          int& q0) {
  bh = i % BH;
  q0 = (nq - 1 - i / BH) * kFwdM;
}

// The list index of this block's work tile in round r: round r deals the
// next gridDim.x tiles of the list, even rounds in block order, odd rounds
// reversed, so heavy and light tiles even out across blocks.
__device__ __forceinline__ int work_index(int r) {
  return r * gridDim.x +
         (r % 2 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// Persistent: one block per SM walks its work tiles; the producer streams
// q of each tile and k, v of every key tile through the rings without a
// break between tiles, so the next tile's loads overlap this one's tail
// and epilogue.  The layout, the pipeline and the numerics are in the
// header comment.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_o,
                    float* __restrict__ lse, int Sq, int Sk, int causal,
                    float scale_log2, int BH) {
  using F = Fwd<D>;
  extern __shared__ __align__(1024) unsigned char fwd_smem[];
  const uint32_t base = (sm90::smem_addr(fwd_smem) + 1023u) & ~1023u;
  // q stage s (work tile r uses stage r % 2): full, empty
  auto q_full = [&](int s) { return base + F::bar_off + 16 * s; };
  auto q_empty = [&](int s) { return base + F::bar_off + 16 * s + 8; };
  // stage s of ring x (0 k full, 1 k empty, 2 v full, 3 v empty)
  auto bar = [&](int x, int s) {
    return base + F::bar_off + 32 + 8 * (4 * s + x);
  };
  const int nq = (Sq + kFwdM - 1) / kFwdM, n_work = nq * BH;
  auto key_tiles = [&](int q0) {
    const int n = (Sk + kFwdN - 1) / kFwdN;
    return causal ? min(n, (q0 + kFwdM - 1) / kFwdN + 1) : n;
  };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(q_full(s), 1);
      sm90::mbar_init(q_empty(s), 2);
    }
    for (int s = 0; s < F::kStages; ++s)
      for (int x = 0; x < 4; ++x) sm90::mbar_init(bar(x, s), x % 2 ? 2 : 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // ------------------------------------------- producer
    sm90::regs_dec<kProducerRegs>();
    if (threadIdx.x != 256) return;
    // Key tile ``it`` (counted over all work tiles) goes to stage it % S;
    // its refill waits for the stage's previous use to be released (the
    // first use passes at once).  k runs one tile ahead of v: v's stage
    // frees a step later (after P.V), and k must not queue behind it.
    auto load = [&](int x, int it, int row, int bh) {
      const int s = it % F::kStages;
      sm90::mbar_wait(bar(x + 1, s), ((it / F::kStages) & 1) ^ 1);
      sm90::mbar_arrive_expect_tx(bar(x, s), F::kv_tile);
      const uint32_t dst = base + (x ? F::v_off : F::k_off) + s * F::kv_tile;
      for (int p = 0; p < F::kPanels; ++p)
        sm90::tma_load_3d(dst + p * F::kv_panel, x ? &tm_v : &tm_k,
                          bar(x, s), 64 * p, row, bh);
    };
    int it = 0, v_row = 0, v_bh = -1;  // v_bh >= 0: v of tile it-1 owed
    for (int r = 0;; ++r) {
      const int i = work_index(r);
      if (i >= n_work) break;
      int bh, q0;
      work_tile(i, BH, nq, bh, q0);
      // the last S product of the tile before last has released q's stage
      const int qs = r % 2;
      sm90::mbar_wait(q_empty(qs), ((r / 2) & 1) ^ 1);
      sm90::mbar_arrive_expect_tx(q_full(qs), F::q_tile);
      for (int w = 0; w < 2; ++w)
        for (int p = 0; p < F::kPanels; ++p)
          sm90::tma_load_3d(base + qs * F::q_tile + p * F::q_panel +
                                w * 64 * 128,
                            &tm_q, q_full(qs), 64 * p, q0 + 64 * w, bh);
      const int n = key_tiles(q0);
      for (int j = 0; j < n; ++j, ++it) {
        load(0, it, j * kFwdN, bh);
        if (v_bh >= 0) load(2, it - 1, v_row, v_bh);
        v_row = j * kFwdN;
        v_bh = bh;
      }
    }
    if (v_bh >= 0) load(2, it - 1, v_row, v_bh);
  } else {  // ----------------------------------------------- consumers
    sm90::regs_inc<kConsumerRegs>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int cq = 2 * (lane % 4);  // d[4j + e]: column 8j + cq + e%2,
    const int rl = 16 * warp + lane / 4;  //   row rl + 8(e/2) of the 64
    uint32_t q_base = 0;  // this warpgroup's q rows in the tile's stage
    const uint32_t o_base = base + F::o_off + wg * 64 * 128;
    float o[D / 2];
    float m0, m1, l0, l1;  // running max (base 2, scaled), this lane's sums
    float sc[64];          // S of the newest key tile
    uint32_t pk[32];       // p of the tile before it, bf16: P.V's A operand
    int qw = 0, r0 = 0;    // this warpgroup's first row; the lane's row

    // S = q . k^T of the k tile in stage s, issued and committed
    auto issue_s = [&](int s) {
      const uint32_t k_base = base + F::k_off + s * F::kv_tile;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_m64n128k16_ss(
            sc,
            sm90::desc_sw128(q_base + (kk / 4) * F::q_panel + (kk % 4) * 32,
                             16, 1024),
            sm90::desc_sw128(k_base + (kk / 4) * F::kv_panel + (kk % 4) * 32,
                             16, 1024),
            kk > 0);
      sm90::wgmma_commit();
    };
    // o += p . v of the v tile in stage s, issued and committed
    auto issue_pv = [&](int s) {
      const uint32_t v_base = base + F::v_off + s * F::kv_tile;
#pragma unroll
      for (int kk = 0; kk < kFwdN / 16; ++kk) {
        const uint64_t dv =
            sm90::desc_sw128(v_base + kk * 16 * 128, F::kv_panel, 1024);
        if constexpr (D == 128)
          sm90::wgmma_m64n128k16_rs(o, pk + 4 * kk, dv);
        else
          sm90::wgmma_m64n64k16_rs(o, pk + 4 * kk, dv);
      }
      sm90::wgmma_commit();
    };
    // online softmax of the S tile at key k0 on the accumulator's layout:
    // mask (diagonal and Sk-edge tiles only), the new running max, p =
    // exp2(s * scale_log2 - m) (one FMA and one exp2 an element) into
    // ``next``, the row sums rescaled; the rescale factor of the rows'
    // earlier terms into a0, a1
    auto softmax = [&](int k0, uint32_t (&next)[32], float& a0, float& a1) {
      if (k0 + kFwdN > Sk || (causal && k0 + kFwdN - 1 > qw)) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int kj = k0 + 8 * (i / 4) + cq + (i % 2);
          const int qi = r0 + 8 * ((i / 2) % 2);
          if (kj >= Sk || (causal && kj > qi)) sc[i] = kNegInf;
        }
      }
      float mx0 = sc[0], mx1 = sc[2];
#pragma unroll
      for (int i = 0; i < 64; i += 4) {
        mx0 = fmaxf(mx0, fmaxf(sc[i], sc[i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[i + 2], sc[i + 3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      // scale_log2 > 0, so the max of the scaled scores is the scaled max
      mx0 = fmaxf(m0, mx0 * scale_log2);
      mx1 = fmaxf(m1, mx1 * scale_log2);
      a0 = sm90::exp2_ftz(m0 - mx0);
      a1 = sm90::exp2_ftz(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int i = 0; i < 64; i += 4) {
        const float p0 = sm90::exp2_ftz(fmaf(sc[i], scale_log2, -mx0));
        const float p1 = sm90::exp2_ftz(fmaf(sc[i + 1], scale_log2, -mx0));
        const float p2 = sm90::exp2_ftz(fmaf(sc[i + 2], scale_log2, -mx1));
        const float p3 = sm90::exp2_ftz(fmaf(sc[i + 3], scale_log2, -mx1));
        s0 += p0 + p1;
        s1 += p2 + p3;
        next[i / 2] = sm90::pack_bf16(p0, p1);
        next[i / 2 + 1] = sm90::pack_bf16(p2, p3);
      }
      l0 = l0 * a0 + s0;
      l1 = l1 * a1 + s1;
    };
    auto rescale_o = [&](float a0, float a1) {
#pragma unroll
      for (int i = 0; i < D / 2; i += 4) {
        o[i] *= a0;
        o[i + 1] *= a0;
        o[i + 2] *= a1;
        o[i + 3] *= a1;
      }
    };
    auto wait_ring = [&](int x, int it) {
      sm90::mbar_wait(bar(x, it % F::kStages), (it / F::kStages) & 1);
    };
    auto release = [&](uint32_t b) {
      if (t == 0) sm90::mbar_arrive(b);
    };

    int it = 0;  // key tiles consumed so far, over all work tiles
    for (int r = 0;; ++r) {
      const int i = work_index(r);
      if (i >= n_work) break;
      int bh, q0;
      work_tile(i, BH, nq, bh, q0);
      qw = q0 + 64 * wg;
      r0 = qw + rl;
      const int qs = r % 2;
      q_base = base + qs * F::q_tile + wg * 64 * 128;
      const int n = key_tiles(q0);
#pragma unroll
      for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
      m0 = m1 = kNegInf;
      l0 = l1 = 0.f;

      // Key tile 0 alone.  Then step j issues S of tile j, rescales o to
      // tile j-1's max while S runs, issues P.V of tile j-1, and runs tile
      // j's softmax while P.V is on the tensor cores.  Each issue opens its
      // own wgmma.fence, after every register it reads is final.
      sm90::mbar_wait(q_full(qs), (r / 2) & 1);
      wait_ring(0, it);
      sm90::wgmma_fence();
      issue_s(it % F::kStages);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      release(bar(1, it % F::kStages));  // k tile 0 read
      if (n == 1) release(q_empty(qs));   // the tile's last S product
      float a0, a1;  // the factors o still owes the last softmax
      softmax(0, pk, a0, a1);
      for (int j = 1; j < n; ++j) {
        const int s = (it + j) % F::kStages, prev = (it + j - 1) % F::kStages;
        wait_ring(0, it + j);
        sm90::fence_regs(sc);
        sm90::wgmma_fence();
        issue_s(s);
        rescale_o(a0, a1);
        wait_ring(2, it + j - 1);
        sm90::fence_regs(o);
        sm90::fence_regs(pk);
        sm90::wgmma_fence();
        issue_pv(prev);
        sm90::wgmma_wait<1>();  // S of tile j is in
        sm90::fence_regs(sc);
        release(bar(1, s));
        if (j == n - 1) release(q_empty(qs));
        uint32_t next[32];
        softmax(j * kFwdN, next, a0, a1);
        sm90::wgmma_wait<0>();  // P.V of tile j-1 is in
        sm90::fence_regs(o);
        sm90::fence_regs(pk);  // read until here: ``next`` may not reuse it
        release(bar(3, prev));
#pragma unroll
        for (int x = 0; x < 32; ++x) pk[x] = next[x];
      }
      const int last = (it + n - 1) % F::kStages;
      rescale_o(a0, a1);
      wait_ring(2, it + n - 1);
      sm90::fence_regs(o);
      sm90::fence_regs(pk);
      sm90::wgmma_fence();
      issue_pv(last);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      release(bar(3, last));
      it += n;

      // epilogue: whole-row sums, lse, o / l staged (swizzled) and stored
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, x);
        l1 += __shfl_xor_sync(0xffffffffu, l1, x);
      }
      const float sl0 = fmaxf(l0, 1e-30f), sl1 = fmaxf(l1, 1e-30f);
      const float inv0 = 1.f / sl0, inv1 = 1.f / sl1;
      if (lane % 4 == 0) {
        float* row_lse = lse + static_cast<size_t>(bh) * Sq;
        if (r0 < Sq) row_lse[r0] = m0 * kLn2 + logf(sl0);
        if (r0 + 8 < Sq) row_lse[r0 + 8] = m1 * kLn2 + logf(sl1);
      }
      // the previous tile's store has read the staging rows
      if (t == 0) sm90::tma_store_wait_read();
      sm90::named_barrier_sync(1 + wg, 128);
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb) {
        const uint32_t a = o_base + (jb / 8) * F::q_panel + rl * 128 +
                           (((jb % 8) ^ (rl % 8)) * 16) + cq * 2;
        sm90::st_shared_u32(a, sm90::pack_bf16(o[4 * jb] * inv0,
                                               o[4 * jb + 1] * inv0));
        sm90::st_shared_u32(a + 8 * 128,
                            sm90::pack_bf16(o[4 * jb + 2] * inv1,
                                            o[4 * jb + 3] * inv1));
      }
      sm90::fence_proxy_async_smem();
      sm90::named_barrier_sync(1 + wg, 128);
      if (t == 0) {
        for (int p = 0; p < F::kPanels; ++p)
          sm90::tma_store_3d(&tm_o, o_base + p * F::q_panel, 64 * p, qw, bh);
        sm90::tma_store_commit();
      }
    }
    if (t == 0) sm90::tma_store_wait_all();
  }
}

// ------------------------------------------------------- K3, float32 ----
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(Args a) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  size_t off = 0;
  T* Qs = reinterpret_cast<T*>(smem + off);
  off += C::tile_m;
  T* dOs = reinterpret_cast<T*>(smem + off);
  off += C::tile_m;
  T* Ks = reinterpret_cast<T*>(smem + off);
  off += C::tile_n;
  T* Vs = reinterpret_cast<T*>(smem + off);
  off += C::tile_n;
  float* Ss = reinterpret_cast<float*>(smem + off);
  off += C::score;
  float* dPs = reinterpret_cast<float*>(smem + off);
  off += C::score;
  T* Ps = Ss;  // ds overwrites the scores it came from
  float* dQs = reinterpret_cast<float*>(smem + off);
  off += C::acc;
  float* lse_s = reinterpret_cast<float*>(smem + off);
  float* delta_s = lse_s + kM;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kM;
  const size_t bh = blockIdx.y;
  const T* q = static_cast<const T*>(a.q) + bh * a.Sq * D;
  const T* k = static_cast<const T*>(a.k) + bh * a.Sk * D;
  const T* v = static_cast<const T*>(a.v) + bh * a.Sk * D;
  const T* dout = static_cast<const T*>(a.dout) + bh * a.Sq * D;

  load_tile<T, D, C::LDT>(Qs, q, q0, kM, a.Sq);
  load_tile<T, D, C::LDT>(dOs, dout, q0, kM, a.Sq);
  load_vec(lse_s, a.lse_in + bh * a.Sq, q0, kM, a.Sq);
  load_vec(delta_s, a.delta + bh * a.Sq, q0, kM, a.Sq);
  zero_rows<T, D>(dQs, warp, lane);
  int ntiles = (a.Sk + C::N - 1) / C::N;
  if (a.causal) ntiles = min(ntiles, (q0 + kM - 1) / C::N + 1);

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * C::N;
    __syncthreads();
    load_tile<T, D, C::LDT>(Ks, k, k0, C::N, a.Sk);
    load_tile<T, D, C::LDT>(Vs, v, k0, C::N, a.Sk);
    __syncthreads();
    strip_abt<T, D>(Ss, Qs, Ks, warp, lane);
    strip_abt<T, D>(dPs, dOs, Vs, warp, lane);  // do in v's type (T)
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r, qi = q0 + row;
      const float lse = lse_s[row], delta = delta_s[row];
#pragma unroll
      for (int t = 0; t < C::kCpl; ++t) {
        const int c = lane + 32 * t, kj = k0 + c;
        float x = Ss[row * C::LDS + c] * a.scale;
        if (kj >= a.Sk || (a.causal && kj > qi)) x = kNegInf;
        const float p = expf(x - lse);
        const float ds = p * (dPs[row * C::LDS + c] - delta) * a.scale;
        Ps[row * C::LDP + c] = ds;
      }
    }
    __syncwarp();
    strip_acc<T, D>(dQs, Ps, Ks, warp, lane);
    __syncwarp();
  }
  store_rows<T, D>(static_cast<T*>(a.out0) + bh * a.Sq * D, dQs, nullptr, q0,
                   a.Sq, warp, lane);
}

// ------------------------------------------------------- K4, float32 ----
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) bwd_dkv_kernel(Args a) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  size_t off = 0;
  T* Ks = reinterpret_cast<T*>(smem + off);
  off += C::tile_m;
  T* Vs = reinterpret_cast<T*>(smem + off);
  off += C::tile_m;
  T* Qs = reinterpret_cast<T*>(smem + off);
  off += C::tile_n;
  T* dOs = reinterpret_cast<T*>(smem + off);
  off += C::tile_n;
  float* Ss = reinterpret_cast<float*>(smem + off);  // s^T, then p^T
  off += C::score;
  float* dPs = reinterpret_cast<float*>(smem + off);  // dp^T
  off += C::score;
  T* Ps = Ss;  // p, then ds, overwrite the scores they came from
  float* dKs = reinterpret_cast<float*>(smem + off);
  off += C::acc;
  float* dVs = reinterpret_cast<float*>(smem + off);
  off += C::acc;
  float* lse_s = reinterpret_cast<float*>(smem + off);
  float* delta_s = lse_s + C::N;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * kM;
  const size_t bh = blockIdx.y;
  const T* q = static_cast<const T*>(a.q) + bh * a.Sq * D;
  const T* k = static_cast<const T*>(a.k) + bh * a.Sk * D;
  const T* v = static_cast<const T*>(a.v) + bh * a.Sk * D;
  const T* dout = static_cast<const T*>(a.dout) + bh * a.Sq * D;

  load_tile<T, D, C::LDT>(Ks, k, k0, kM, a.Sk);
  load_tile<T, D, C::LDT>(Vs, v, k0, kM, a.Sk);
  zero_rows<T, D>(dKs, warp, lane);
  zero_rows<T, D>(dVs, warp, lane);
  const int ntiles = (a.Sq + C::N - 1) / C::N;
  // causal: query tile i is live iff its last row i*N + N - 1 >= k0
  const int first = a.causal ? k0 / C::N : 0;

  for (int i = first; i < ntiles; ++i) {
    const int qt0 = i * C::N;
    __syncthreads();
    load_tile<T, D, C::LDT>(Qs, q, qt0, C::N, a.Sq);
    load_tile<T, D, C::LDT>(dOs, dout, qt0, C::N, a.Sq);
    load_vec(lse_s, a.lse_in + bh * a.Sq, qt0, C::N, a.Sq);
    load_vec(delta_s, a.delta + bh * a.Sq, qt0, C::N, a.Sq);
    __syncthreads();
    strip_abt<T, D>(Ss, Ks, Qs, warp, lane);  // s^T: key rows x query cols
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r, kj = k0 + row;
#pragma unroll
      for (int t = 0; t < C::kCpl; ++t) {
        const int c = lane + 32 * t, qi = qt0 + c;
        float x = Ss[row * C::LDS + c] * a.scale;
        if (qi >= a.Sq || kj >= a.Sk || (a.causal && kj > qi)) x = kNegInf;
        const float p = expf(x - lse_s[c]);
        Ss[row * C::LDS + c] = p;
      }
    }
    __syncwarp();
    strip_acc<T, D>(dVs, Ps, dOs, warp, lane);
    strip_abt<T, D>(dPs, Vs, dOs, warp, lane);  // dp^T = v . do^T
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
#pragma unroll
      for (int t = 0; t < C::kCpl; ++t) {
        const int c = lane + 32 * t;
        const float ds = Ss[row * C::LDS + c] *
                         (dPs[row * C::LDS + c] - delta_s[c]) * a.scale;
        Ps[row * C::LDP + c] = ds;
      }
    }
    __syncwarp();
    strip_acc<T, D>(dKs, Ps, Qs, warp, lane);
    __syncwarp();
  }
  store_rows<T, D>(static_cast<T*>(a.out0) + bh * a.Sk * D, dKs, nullptr, k0,
                   a.Sk, warp, lane);
  store_rows<T, D>(static_cast<T*>(a.out1) + bh * a.Sk * D, dVs, nullptr, k0,
                   a.Sk, warp, lane);
}

// ------------------------------------------------- K3 and K4, bf16 ----
constexpr int kBwdM = 128;  // rows of a work tile: 2 consumer warpgroups x 64
constexpr int kBwdN = 64;   // rows of a streamed tile (keys in K3, queries
                            // in K4)
static_assert(kBwdM == kFwdM, "K3 walks K2's work tiles (work_tile)");

// Shared memory of bwd_dq_sm90_kernel, in bytes from a 1024-aligned base.
// A tile is D / 64 panels of rows x 128 bytes (sm90.cuh).
template <int D>
struct BwdDq {
  static constexpr int kPanels = D / 64;
  static constexpr int kStages = D == 64 ? 4 : 3;  // per ring (k and v)
  static constexpr uint32_t m_panel = kBwdM * 128;
  static constexpr uint32_t n_panel = kBwdN * 128;
  static constexpr uint32_t m_tile = kPanels * m_panel;  // q (dq staged), do
  static constexpr uint32_t n_tile = kPanels * n_panel;  // one k or v
  // work-tile stage s: q at 2 s m_tile, do at (2 s + 1) m_tile
  static constexpr uint32_t k_off = 4 * m_tile;
  static constexpr uint32_t v_off = k_off + kStages * n_tile;
  static constexpr uint32_t bar_off = v_off + kStages * n_tile;
  // barriers, 8 bytes each: per work-tile stage full, empty; then per k / v
  // stage k full, k empty, v full, v empty
  static constexpr uint32_t smem = bar_off + 8 * (4 + 4 * kStages) + 1024;
};

// Shared memory of bwd_dkv_sm90_kernel.  dk and dv are staged for their
// TMA stores in the warpgroup's own rows of the k and v tiles they came
// from, so the work-tile stage is released after the stores have read it.
template <int D>
struct BwdDkv {
  static constexpr int kPanels = D / 64;
  static constexpr int kStages = D == 64 ? 4 : 3;  // q / do / lse / delta
  static constexpr uint32_t m_panel = kBwdM * 128;
  static constexpr uint32_t n_panel = kBwdN * 128;
  static constexpr uint32_t m_tile = kPanels * m_panel;  // k or v (dk, dv)
  static constexpr uint32_t n_tile = kPanels * n_panel;  // q or do
  // work-tile stage s: k at 2 s m_tile, v at (2 s + 1) m_tile
  static constexpr uint32_t q_off = 4 * m_tile;
  // ring stage s: q at q_off + 2 s n_tile, do at q_off + (2 s + 1) n_tile;
  // its 64 lse at vec_off + 512 s and 64 delta 256 bytes further
  static constexpr uint32_t vec_off = q_off + 2 * kStages * n_tile;
  static constexpr uint32_t bar_off = vec_off + 512 * kStages;
  // barriers: per work-tile stage full, empty; then per ring stage full,
  // empty
  static constexpr uint32_t smem = bar_off + 8 * (4 + 2 * kStages) + 1024;
};

// d (64 x 64) = A . B^T, both 64-row bf16 tiles K-major in shared memory
// (A this warpgroup's rows of a tile whose panels are a_panel bytes apart,
// B a 64-row tile with panels b_panel apart), issued and committed.
template <int D>
__device__ __forceinline__ void bwd_ss(float (&d)[32], uint32_t a,
                                       uint32_t a_panel, uint32_t b,
                                       uint32_t b_panel) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    sm90::wgmma_m64n64k16_ss(
        d, sm90::desc_sw128(a + (kk / 4) * a_panel + (kk % 4) * 32, 16, 1024),
        sm90::desc_sw128(b + (kk / 4) * b_panel + (kk % 4) * 32, 16, 1024),
        kk > 0);
  sm90::wgmma_commit();
}

// acc (64 x D) += A (64 x 64: bf16 fragments, 4 per 16-wide step) . B (a
// 64-row bf16 tile in shared memory read MN-major, panels b_panel apart),
// issued and committed.
template <int D>
__device__ __forceinline__ void bwd_rs(float (&acc)[D / 2],
                                       const uint32_t (&a)[16], uint32_t b,
                                       uint32_t b_panel) {
#pragma unroll
  for (int kk = 0; kk < kBwdN / 16; ++kk) {
    const uint64_t desc = sm90::desc_sw128(b + kk * 16 * 128, b_panel, 1024);
    if constexpr (D == 128)
      sm90::wgmma_m64n128k16_rs(acc, a + 4 * kk, desc);
    else
      sm90::wgmma_m64n64k16_rs(acc, a + 4 * kk, desc);
  }
  sm90::wgmma_commit();
}

// dQ.  Persistent and warp-specialized as fwd_sm90_kernel, over the same
// work tiles (128 query rows of one (b, h), heaviest causal tiles first):
// the producer brings q and do once per work tile and k, v in 64-row key
// tiles through two rings; each consumer warpgroup owns 64 query rows,
// keeps its rows' lse and delta in registers and dq in registers for the
// whole key loop, and stages dq for its TMA store in its own q rows, so
// the work-tile stage is released after the store has read it.  The
// layout, the pipeline and the numerics are in the header comment.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_dq,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, int Sq, int Sk,
                       int causal, float scale, float scale_log2, int BH) {
  using L = BwdDq<D>;
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  const uint32_t base = (sm90::smem_addr(bwd_smem) + 1023u) & ~1023u;
  // work-tile stage s (work tile r uses stage r % 2): full, empty
  auto q_full = [&](int s) { return base + L::bar_off + 16 * s; };
  auto q_empty = [&](int s) { return base + L::bar_off + 16 * s + 8; };
  // stage s of ring x (0 k full, 1 k empty, 2 v full, 3 v empty)
  auto bar = [&](int x, int s) {
    return base + L::bar_off + 32 + 8 * (4 * s + x);
  };
  const int nq = (Sq + kBwdM - 1) / kBwdM, n_work = nq * BH;
  const int nk = (Sk + kBwdN - 1) / kBwdN;
  // key tiles that hold a live entry for query rows up to q_last
  auto key_tiles = [&](int q_last) {
    return causal ? min(nk, q_last / kBwdN + 1) : nk;
  };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(q_full(s), 1);
      sm90::mbar_init(q_empty(s), 2);
    }
    for (int s = 0; s < L::kStages; ++s)
      for (int x = 0; x < 4; ++x) sm90::mbar_init(bar(x, s), x % 2 ? 2 : 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // ------------------------------------------- producer
    sm90::regs_dec<kProducerRegs>();
    if (threadIdx.x != 256) return;
    // key tile ``it`` (counted over all work tiles) of ring x goes to
    // stage it % S once the stage's previous use is released
    auto load = [&](int x, int it, int row, int bh) {
      const int s = it % L::kStages;
      sm90::mbar_wait(bar(x + 1, s), ((it / L::kStages) & 1) ^ 1);
      sm90::mbar_arrive_expect_tx(bar(x, s), L::n_tile);
      const uint32_t dst = base + (x ? L::v_off : L::k_off) + s * L::n_tile;
      for (int p = 0; p < L::kPanels; ++p)
        sm90::tma_load_3d(dst + p * L::n_panel, x ? &tm_v : &tm_k, bar(x, s),
                          64 * p, row, bh);
    };
    int it = 0;
    for (int r = 0;; ++r) {
      const int i = work_index(r);
      if (i >= n_work) break;
      int bh, q0;
      work_tile(i, BH, nq, bh, q0);
      const int qs = r % 2;
      sm90::mbar_wait(q_empty(qs), ((r / 2) & 1) ^ 1);
      sm90::mbar_arrive_expect_tx(q_full(qs), 2 * L::m_tile);
      for (int x = 0; x < 2; ++x)  // q, do
        for (int w = 0; w < 2; ++w)
          for (int p = 0; p < L::kPanels; ++p)
            sm90::tma_load_3d(base + (2 * qs + x) * L::m_tile +
                                  p * L::m_panel + w * 64 * 128,
                              x ? &tm_do : &tm_q, q_full(qs), 64 * p,
                              q0 + 64 * w, bh);
      const int n = key_tiles(q0 + kBwdM - 1);
      for (int j = 0; j < n; ++j, ++it) {
        load(0, it, j * kBwdN, bh);
        load(2, it, j * kBwdN, bh);
      }
    }
  } else {  // ----------------------------------------------- consumers
    sm90::regs_inc<kConsumerRegs>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int cq = 2 * (lane % 4);  // d[4j + e]: column 8j + cq + e%2,
    const int rl = 16 * warp + lane / 4;  //   row rl + 8(e/2) of the 64
    float dq[D / 2];
    float sc[32], dp[32];  // S, then p; dP of the newest key tile
    uint32_t pk[16];       // ds of the key tile before, bf16: dq's A operand
    auto wait_ring = [&](int x, int it) {
      sm90::mbar_wait(bar(x, it % L::kStages), (it / L::kStages) & 1);
    };
    auto release = [&](uint32_t b) {
      if (t == 0) sm90::mbar_arrive(b);
    };

    int it = 0;  // key tiles consumed so far, over all work tiles
    for (int r = 0;; ++r) {
      const int i = work_index(r);
      if (i >= n_work) break;
      int bh, q0;
      work_tile(i, BH, nq, bh, q0);
      const int qw = q0 + 64 * wg, r0 = qw + rl, qs = r % 2;
      // the work tile's key tiles, and those live for this warpgroup's
      // rows (under the causal mask warpgroup 0's last one is masked out)
      const int n = key_tiles(q0 + kBwdM - 1), mine = key_tiles(qw + 63);
      const uint32_t q_base = base + 2 * qs * L::m_tile + wg * 64 * 128;
      const uint32_t do_base = q_base + L::m_tile;
      const float* row_lse = lse + static_cast<size_t>(bh) * Sq;
      const float* row_delta = delta + static_cast<size_t>(bh) * Sq;
      // this lane's two rows: lse in base 2, delta (0 past Sq)
      const float l0 = r0 < Sq ? row_lse[r0] * kLog2e : 0.f;
      const float l1 = r0 + 8 < Sq ? row_lse[r0 + 8] * kLog2e : 0.f;
      const float d0 = r0 < Sq ? row_delta[r0] : 0.f;
      const float d1 = r0 + 8 < Sq ? row_delta[r0 + 8] : 0.f;
#pragma unroll
      for (int x = 0; x < D / 2; ++x) dq[x] = 0.f;

      // Step j issues S of key tile j and dP, with the dq product of tile
      // j-1 still on the tensor cores; takes p = exp2(s scale log2 e -
      // lse log2 e) while dP runs; then ds = p (dp - delta) scale, rounded
      // to bf16 in registers as dq's A operand, and issues dq += ds . k
      // (k of the same stage, read MN-major).  Each issue opens its own
      // wgmma.fence after every register it touches is final.
      sm90::mbar_wait(q_full(qs), (r / 2) & 1);
      for (int j = 0; j < mine; ++j) {
        const int c = it + j, s = c % L::kStages;
        const uint32_t k_base = base + L::k_off + s * L::n_tile;
        const uint32_t v_base = base + L::v_off + s * L::n_tile;
        wait_ring(0, c);
        sm90::fence_regs(sc);
        sm90::wgmma_fence();
        bwd_ss<D>(sc, q_base, L::m_panel, k_base, L::n_panel);
        wait_ring(2, c);
        sm90::fence_regs(dp);
        sm90::wgmma_fence();
        bwd_ss<D>(dp, do_base, L::m_panel, v_base, L::n_panel);
        sm90::wgmma_wait<1>();  // S is in, and tile j-1's dq product
        sm90::fence_regs(sc);
        sm90::fence_regs(dq);
        sm90::fence_regs(pk);
        if (j > 0) release(bar(1, (c - 1) % L::kStages));  // k of j-1 read
        const int k0 = j * kBwdN;
        if (k0 + kBwdN > Sk || (causal && k0 + kBwdN - 1 > qw)) {
#pragma unroll
          for (int x = 0; x < 32; ++x) {
            const int kj = k0 + 8 * (x / 4) + cq + (x % 2);
            const int qi = r0 + 8 * ((x / 2) % 2);
            if (kj >= Sk || (causal && kj > qi)) sc[x] = kNegInf;
          }
        }
#pragma unroll
        for (int x = 0; x < 32; x += 4) {
          sc[x] = sm90::exp2_ftz(fmaf(sc[x], scale_log2, -l0));
          sc[x + 1] = sm90::exp2_ftz(fmaf(sc[x + 1], scale_log2, -l0));
          sc[x + 2] = sm90::exp2_ftz(fmaf(sc[x + 2], scale_log2, -l1));
          sc[x + 3] = sm90::exp2_ftz(fmaf(sc[x + 3], scale_log2, -l1));
        }
        sm90::wgmma_wait<0>();  // dP is in
        sm90::fence_regs(dp);
        release(bar(3, s));  // v read
#pragma unroll
        for (int x = 0; x < 32; x += 4) {
          pk[x / 2] = sm90::pack_bf16(sc[x] * (dp[x] - d0) * scale,
                                      sc[x + 1] * (dp[x + 1] - d0) * scale);
          pk[x / 2 + 1] =
              sm90::pack_bf16(sc[x + 2] * (dp[x + 2] - d1) * scale,
                              sc[x + 3] * (dp[x + 3] - d1) * scale);
        }
        sm90::fence_regs(dq);
        sm90::fence_regs(pk);
        sm90::wgmma_fence();
        bwd_rs<D>(dq, pk, k_base, L::n_panel);
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq);
      sm90::fence_regs(pk);
      release(bar(1, (it + mine - 1) % L::kStages));
      // key tiles past this warpgroup's diagonal: released unread
      for (int j = mine; j < n; ++j) {
        wait_ring(0, it + j);
        wait_ring(2, it + j);
        release(bar(1, (it + j) % L::kStages));
        release(bar(3, (it + j) % L::kStages));
      }
      it += n;

      // epilogue: dq to bf16, staged (swizzled) in this warpgroup's q rows
      // and stored (rows past Sq dropped); the stage is released once the
      // store has read it
      const uint32_t dq_base = q_base;
      sm90::named_barrier_sync(1 + wg, 128);  // every warp's last read done
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb) {
        const uint32_t a = dq_base + (jb / 8) * L::m_panel + rl * 128 +
                           (((jb % 8) ^ (rl % 8)) * 16) + cq * 2;
        sm90::st_shared_u32(a, sm90::pack_bf16(dq[4 * jb], dq[4 * jb + 1]));
        sm90::st_shared_u32(a + 8 * 128, sm90::pack_bf16(dq[4 * jb + 2],
                                                         dq[4 * jb + 3]));
      }
      sm90::fence_proxy_async_smem();
      sm90::named_barrier_sync(1 + wg, 128);
      if (t == 0) {
        for (int p = 0; p < L::kPanels; ++p)
          sm90::tma_store_3d(&tm_dq, dq_base + p * L::m_panel, 64 * p, qw,
                             bh);
        sm90::tma_store_commit();
        sm90::tma_store_wait_read();
        sm90::mbar_arrive(q_empty(qs));
      }
    }
    if (t == 0) sm90::tma_store_wait_all();
  }
}

// dK and dV.  Persistent and warp-specialized over work tiles of 128 key
// rows of one (b, h), key tile 0 first (under the causal mask it sees
// every query tile): the producer brings k and v once per work tile (two
// stages) and q, do and their rows' lse and delta in 64-row query tiles
// through one ring; each consumer warpgroup owns 64 key rows and keeps dk
// and dv in registers for the whole query loop.  The layout, the pipeline
// and the numerics are in the header comment.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_dk,
                        const __grid_constant__ CUtensorMap tm_dv,
                        const __grid_constant__ CUtensorMap tm_lse,
                        const __grid_constant__ CUtensorMap tm_delta, int Sq,
                        int Sk, int causal, float scale, float scale_log2,
                        int BH) {
  using L = BwdDkv<D>;
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  const uint32_t base = (sm90::smem_addr(bwd_smem) + 1023u) & ~1023u;
  const unsigned char* gbase = bwd_smem + (base - sm90::smem_addr(bwd_smem));
  // work-tile stage s (k and v of work tile r in stage r % 2): full, empty
  auto kv_full = [&](int s) { return base + L::bar_off + 16 * s; };
  auto kv_empty = [&](int s) { return base + L::bar_off + 16 * s + 8; };
  // ring stage s (q, do, lse, delta of one query tile): full, empty
  auto q_full = [&](int s) { return base + L::bar_off + 32 + 16 * s; };
  auto q_empty = [&](int s) { return base + L::bar_off + 40 + 16 * s; };
  const int nkt = (Sk + kBwdM - 1) / kBwdM, n_work = nkt * BH;
  const int nqt = (Sq + kBwdN - 1) / kBwdN;
  // the first query tile with a live entry for key rows from k0 on
  auto first_tile = [&](int k0) { return causal ? k0 / kBwdN : 0; };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(kv_full(s), 1);
      sm90::mbar_init(kv_empty(s), 2);
    }
    for (int s = 0; s < L::kStages; ++s) {
      sm90::mbar_init(q_full(s), 1);
      sm90::mbar_init(q_empty(s), 2);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // ------------------------------------------- producer
    sm90::regs_dec<kProducerRegs>();
    if (threadIdx.x != 256) return;
    int it = 0;  // query tiles loaded, over all work tiles
    for (int r = 0;; ++r) {
      const int i = work_index(r);
      if (i >= n_work) break;
      const int bh = i % BH, k0 = (i / BH) * kBwdM, ks = r % 2;
      // the stores of work tile r-2 have read this stage
      sm90::mbar_wait(kv_empty(ks), ((r / 2) & 1) ^ 1);
      sm90::mbar_arrive_expect_tx(kv_full(ks), 2 * L::m_tile);
      for (int x = 0; x < 2; ++x)  // k, v
        for (int w = 0; w < 2; ++w)
          for (int p = 0; p < L::kPanels; ++p)
            sm90::tma_load_3d(base + (2 * ks + x) * L::m_tile +
                                  p * L::m_panel + w * 64 * 128,
                              x ? &tm_v : &tm_k, kv_full(ks), 64 * p,
                              k0 + 64 * w, bh);
      for (int qt = first_tile(k0); qt < nqt; ++qt, ++it) {
        const int s = it % L::kStages;
        sm90::mbar_wait(q_empty(s), ((it / L::kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(q_full(s), 2 * L::n_tile + 512);
        for (int x = 0; x < 2; ++x)  // q, do
          for (int p = 0; p < L::kPanels; ++p)
            sm90::tma_load_3d(base + L::q_off + (2 * s + x) * L::n_tile +
                                  p * L::n_panel,
                              x ? &tm_do : &tm_q, q_full(s), 64 * p,
                              qt * kBwdN, bh);
        // lse and delta are flat (BH * Sq) arrays: values past this (b, h)
        // arrive too, and those queries are masked
        const int v0 = bh * Sq + qt * kBwdN;
        sm90::tma_load_1d(base + L::vec_off + 512 * s, &tm_lse, q_full(s),
                          v0);
        sm90::tma_load_1d(base + L::vec_off + 512 * s + 256, &tm_delta,
                          q_full(s), v0);
      }
    }
  } else {  // ----------------------------------------------- consumers
    sm90::regs_inc<kConsumerRegs>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int cq = 2 * (lane % 4);  // d[4j + e]: query column 8j + cq +
    const int rl = 16 * warp + lane / 4;  //   e%2, key row rl + 8(e/2)
    float dk[D / 2], dv[D / 2];
    float sc[32], dp[32];   // S^T, then p^T; dP^T, then ds^T
    uint32_t pp[16], pd[16];  // p^T and ds^T in bf16: the A operands
    auto release = [&](uint32_t b) {
      if (t == 0) sm90::mbar_arrive(b);
    };

    int it = 0;  // query tiles consumed, over all work tiles
    for (int r = 0;; ++r) {
      const int i = work_index(r);
      if (i >= n_work) break;
      const int bh = i % BH, k0 = (i / BH) * kBwdM, ks = r % 2;
      const int kw = k0 + 64 * wg, kr = kw + rl;
      const uint32_t k_base = base + 2 * ks * L::m_tile + wg * 64 * 128;
      const uint32_t v_base = k_base + L::m_tile;
      // query tiles of the work tile, and the first live for this
      // warpgroup's rows (under the causal mask warpgroup 1's first one
      // is masked out)
      const int first = first_tile(k0), mine = first_tile(kw);
#pragma unroll
      for (int x = 0; x < D / 2; ++x) dk[x] = dv[x] = 0.f;
      sm90::mbar_wait(kv_full(ks), (r / 2) & 1);

      // Per query tile: S^T = k . q^T and dP^T = v . do^T issued together;
      // p^T = exp2(s scale log2 e - lse log2 e) while dP^T runs; then
      // ds^T = p^T (dp^T - delta) scale; both rounded to bf16 in registers
      // as the A operands of dv += p^T . do and dk += ds^T . q (do and q
      // of the same stage, read MN-major).
      for (int qt = first; qt < nqt; ++qt, ++it) {
        const int s = it % L::kStages;
        sm90::mbar_wait(q_full(s), (it / L::kStages) & 1);
        if (qt < mine) {  // masked out for these key rows: released unread
          release(q_empty(s));
          continue;
        }
        const uint32_t q_s = base + L::q_off + 2 * s * L::n_tile;
        const uint32_t do_s = q_s + L::n_tile;
        const float* lse_s =
            reinterpret_cast<const float*>(gbase + L::vec_off + 512 * s);
        const float* delta_s = lse_s + 64;
        sm90::fence_regs(sc);
        sm90::wgmma_fence();
        bwd_ss<D>(sc, k_base, L::m_panel, q_s, L::n_panel);
        sm90::fence_regs(dp);
        sm90::wgmma_fence();
        bwd_ss<D>(dp, v_base, L::m_panel, do_s, L::n_panel);
        sm90::wgmma_wait<1>();  // S^T is in
        sm90::fence_regs(sc);
        const int i0 = qt * kBwdN;
        // queries past Sq (their lse belongs to the next (b, h)), keys past
        // Sk, and the causal diagonal
        if (i0 + kBwdN > Sq || kw + 64 > Sk ||
            (causal && kw + 63 > i0)) {
#pragma unroll
          for (int x = 0; x < 32; ++x) {
            const int kj = kr + 8 * ((x / 2) % 2);
            const int qi = i0 + 8 * (x / 4) + cq + (x % 2);
            if (qi >= Sq || kj >= Sk || (causal && kj > qi)) sc[x] = kNegInf;
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + cq);
          const float la = l.x * kLog2e, lb = l.y * kLog2e;
          sc[4 * j] = sm90::exp2_ftz(fmaf(sc[4 * j], scale_log2, -la));
          sc[4 * j + 1] = sm90::exp2_ftz(fmaf(sc[4 * j + 1], scale_log2, -lb));
          sc[4 * j + 2] = sm90::exp2_ftz(fmaf(sc[4 * j + 2], scale_log2, -la));
          sc[4 * j + 3] = sm90::exp2_ftz(fmaf(sc[4 * j + 3], scale_log2, -lb));
        }
        sm90::wgmma_wait<0>();  // dP^T is in
        sm90::fence_regs(dp);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 dl =
              *reinterpret_cast<const float2*>(delta_s + 8 * j + cq);
          pp[2 * j] = sm90::pack_bf16(sc[4 * j], sc[4 * j + 1]);
          pp[2 * j + 1] = sm90::pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
          pd[2 * j] = sm90::pack_bf16(
              sc[4 * j] * (dp[4 * j] - dl.x) * scale,
              sc[4 * j + 1] * (dp[4 * j + 1] - dl.y) * scale);
          pd[2 * j + 1] = sm90::pack_bf16(
              sc[4 * j + 2] * (dp[4 * j + 2] - dl.x) * scale,
              sc[4 * j + 3] * (dp[4 * j + 3] - dl.y) * scale);
        }
        sm90::fence_regs(dv);
        sm90::fence_regs(dk);
        sm90::fence_regs(pp);
        sm90::fence_regs(pd);
        sm90::wgmma_fence();
        bwd_rs<D>(dv, pp, do_s, L::n_panel);
        bwd_rs<D>(dk, pd, q_s, L::n_panel);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dv);
        sm90::fence_regs(dk);
        sm90::fence_regs(pp);
        sm90::fence_regs(pd);
        release(q_empty(s));  // q, do, lse and delta read
      }

      // epilogue: dk and dv to bf16, staged (swizzled) in this warpgroup's
      // rows of the k and v tiles, and stored (rows past Sk dropped); the
      // stage is released once the stores have read it
      sm90::named_barrier_sync(1 + wg, 128);  // every warp's last read done
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb) {
        const uint32_t a = (jb / 8) * L::m_panel + rl * 128 +
                           (((jb % 8) ^ (rl % 8)) * 16) + cq * 2;
        sm90::st_shared_u32(k_base + a,
                            sm90::pack_bf16(dk[4 * jb], dk[4 * jb + 1]));
        sm90::st_shared_u32(k_base + a + 8 * 128,
                            sm90::pack_bf16(dk[4 * jb + 2], dk[4 * jb + 3]));
        sm90::st_shared_u32(v_base + a,
                            sm90::pack_bf16(dv[4 * jb], dv[4 * jb + 1]));
        sm90::st_shared_u32(v_base + a + 8 * 128,
                            sm90::pack_bf16(dv[4 * jb + 2], dv[4 * jb + 3]));
      }
      sm90::fence_proxy_async_smem();
      sm90::named_barrier_sync(1 + wg, 128);
      if (t == 0) {
        for (int p = 0; p < L::kPanels; ++p) {
          sm90::tma_store_3d(&tm_dk, k_base + p * L::m_panel, 64 * p, kw, bh);
          sm90::tma_store_3d(&tm_dv, v_base + p * L::m_panel, 64 * p, kw, bh);
        }
        sm90::tma_store_commit();
        sm90::tma_store_wait_read();
        sm90::mbar_arrive(kv_empty(ks));
      }
    }
    if (t == 0) sm90::tma_store_wait_all();
  }
}

// A contiguous (BH, S, D) bf16 slab as the 3-D tensor {D, S, BH}
// (innermost first), moved in boxes of 64 columns x ``rows`` rows of one
// (b, h), 128-byte swizzled; boxes past S read as zeros.
bool encode_slab(sm90::EncodeTiled enc, CUtensorMap* map, const void* ptr,
                 int BH, int S, int D, int rows) {
  const cuuint64_t dims[3] = {cuuint64_t(D), cuuint64_t(S), cuuint64_t(BH)};
  const cuuint64_t strides[2] = {cuuint64_t(D) * 2, cuuint64_t(S) * D * 2};
  const cuuint32_t box[3] = {64, cuuint32_t(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A contiguous float32 array of ``n`` values as a 1-D tensor, moved in
// boxes of 64 values; values past ``n`` read as zeros.
bool encode_f32_vec(sm90::EncodeTiled enc, CUtensorMap* map, const void* ptr,
                    size_t n) {
  const cuuint64_t dims[1] = {cuuint64_t(n)};
  const cuuint64_t strides[1] = {4};  // rank 1 has no strides to give
  const cuuint32_t box[1] = {64};
  const cuuint32_t unit[1] = {1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_fwd_sm90(const Args& a, int BH, cudaStream_t stream) {
  const sm90::EncodeTiled enc = sm90::tensor_map_encoder();
  if (!enc) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv, to;
  if (!encode_slab(enc, &tq, a.q, BH, a.Sq, D, 64) ||
      !encode_slab(enc, &tk, a.k, BH, a.Sk, D, kFwdN) ||
      !encode_slab(enc, &tv, a.v, BH, a.Sk, D, kFwdN) ||
      !encode_slab(enc, &to, a.out0, BH, a.Sq, D, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  int blocks;
  const cudaError_t err =
      sm90::persistent_grid(fwd_sm90_kernel<D>, Fwd<D>::smem,
                            (a.Sq + kFwdM - 1) / kFwdM * BH, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  fwd_sm90_kernel<D><<<blocks, kFwdThreads, Fwd<D>::smem, stream>>>(
      tq, tk, tv, to, a.lse, a.Sq, a.Sk, a.causal, a.scale * kLog2e, BH);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_dq_sm90(const Args& a, int BH, cudaStream_t stream) {
  const sm90::EncodeTiled enc = sm90::tensor_map_encoder();
  if (!enc) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv, tdo, tdq;
  if (!encode_slab(enc, &tq, a.q, BH, a.Sq, D, 64) ||
      !encode_slab(enc, &tk, a.k, BH, a.Sk, D, kBwdN) ||
      !encode_slab(enc, &tv, a.v, BH, a.Sk, D, kBwdN) ||
      !encode_slab(enc, &tdo, a.dout, BH, a.Sq, D, 64) ||
      !encode_slab(enc, &tdq, a.out0, BH, a.Sq, D, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  int blocks;
  const cudaError_t err =
      sm90::persistent_grid(bwd_dq_sm90_kernel<D>, BwdDq<D>::smem,
                            (a.Sq + kBwdM - 1) / kBwdM * BH, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq_sm90_kernel<D><<<blocks, kFwdThreads, BwdDq<D>::smem, stream>>>(
      tq, tk, tv, tdo, tdq, a.lse_in, a.delta, a.Sq, a.Sk, a.causal,
      a.scale, a.scale * kLog2e, BH);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_dkv_sm90(const Args& a, int BH, cudaStream_t stream) {
  const sm90::EncodeTiled enc = sm90::tensor_map_encoder();
  if (!enc) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv, tdo, tdk, tdv, tlse, tdelta;
  const size_t rows = static_cast<size_t>(BH) * a.Sq;
  if (!encode_slab(enc, &tq, a.q, BH, a.Sq, D, kBwdN) ||
      !encode_slab(enc, &tk, a.k, BH, a.Sk, D, 64) ||
      !encode_slab(enc, &tv, a.v, BH, a.Sk, D, 64) ||
      !encode_slab(enc, &tdo, a.dout, BH, a.Sq, D, kBwdN) ||
      !encode_slab(enc, &tdk, a.out0, BH, a.Sk, D, 64) ||
      !encode_slab(enc, &tdv, a.out1, BH, a.Sk, D, 64) ||
      !encode_f32_vec(enc, &tlse, a.lse_in, rows) ||
      !encode_f32_vec(enc, &tdelta, a.delta, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  int blocks;
  const cudaError_t err =
      sm90::persistent_grid(bwd_dkv_sm90_kernel<D>, BwdDkv<D>::smem,
                            (a.Sk + kBwdM - 1) / kBwdM * BH, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkv_sm90_kernel<D><<<blocks, kFwdThreads, BwdDkv<D>::smem, stream>>>(
      tq, tk, tv, tdo, tdk, tdv, tlse, tdelta, a.Sq, a.Sk, a.causal, a.scale,
      a.scale * kLog2e, BH);
  return static_cast<int>(cudaGetLastError());
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int D>
int launch(Which which, const Args& a, int BH, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {  // bf16: the sm90 kernels
    if (which == kFwd) return launch_fwd_sm90<D>(a, BH, stream);
    if (which == kDq) return launch_bwd_dq_sm90<D>(a, BH, stream);
    return launch_bwd_dkv_sm90<D>(a, BH, stream);
  } else {
    using C = Cfg<T, D>;
    void (*kernel)(Args);
    size_t smem;
    int rows;
    if (which == kFwd) {
      kernel = fwd_kernel<T, D>;
      smem = C::fwd_smem;
      rows = a.Sq;
    } else if (which == kDq) {
      kernel = bwd_dq_kernel<T, D>;
      smem = C::dq_smem;
      rows = a.Sq;
    } else {
      kernel = bwd_dkv_kernel<T, D>;
      smem = C::dkv_smem;
      rows = a.Sk;
    }
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((rows + kM - 1) / kM, BH);
    kernel<<<grid, kThreads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int launch_d(Which which, int D, const Args& a, int BH, cudaStream_t stream) {
  if (D == 64) return launch<T, 64>(which, a, BH, stream);
  if (D == 128) return launch<T, 128>(which, a, BH, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(Which which, int dtype, int D, const Args& a, int BH,
             void* stream) {
  if (BH < 1 || a.Sq < 1 || a.Sk < 1 || BH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(which, D, a, BH, st);
  if (dtype == 1) return launch_d<__nv_bfloat16>(which, D, a, BH, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v, do and the outputs share it).
// Operands are contiguous (BH, S, D) slabs, 16-byte aligned; lse and delta
// are contiguous float32 (BH, Sq).  Each returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for an unsupported
// combination.
extern "C" int flash_fwd_launch(int dtype, int D, const void* q, const void* k,
                                const void* v, void* o, float* lse, int BH,
                                int Sq, int Sk, int causal, float scale,
                                void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, o, nullptr, lse, Sq, Sk, causal,
         scale};
  return dispatch(kFwd, dtype, D, a, BH, stream);
}

extern "C" int flash_bwd_dq_launch(int dtype, int D, const void* q,
                                   const void* k, const void* v,
                                   const void* dout, const float* lse,
                                   const float* delta, void* dq, int BH,
                                   int Sq, int Sk, int causal, float scale,
                                   void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, Sq, Sk, causal,
         scale};
  return dispatch(kDq, dtype, D, a, BH, stream);
}

extern "C" int flash_bwd_dkv_launch(int dtype, int D, const void* q,
                                    const void* k, const void* v,
                                    const void* dout, const float* lse,
                                    const float* delta, void* dk, void* dv,
                                    int BH, int Sq, int Sk, int causal,
                                    float scale, void* stream) {
  Args a{q, k, v, dout, lse, delta, dk, dv, nullptr, Sq, Sk, causal, scale};
  return dispatch(kDkv, dtype, D, a, BH, stream);
}

// Dynamic shared memory of the bf16 kernel ``which`` (0 K2, 1 K3, 2 K4;
// fwd_sm90_kernel, bwd_dq_sm90_kernel, bwd_dkv_sm90_kernel) at head dim D
// (0 if none).
extern "C" int flash_sm90_smem(int which, int D) {
  if (D != 64 && D != 128) return 0;
  const bool d64 = D == 64;
  if (which == kFwd) return d64 ? Fwd<64>::smem : Fwd<128>::smem;
  if (which == kDq) return d64 ? BwdDq<64>::smem : BwdDq<128>::smem;
  if (which == kDkv) return d64 ? BwdDkv<64>::smem : BwdDkv<128>::smem;
  return 0;
}

extern "C" const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
