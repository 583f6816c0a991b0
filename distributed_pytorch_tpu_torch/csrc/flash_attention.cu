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
// K2 in bf16 (fwd_sm90_kernel) is built for Hopper's own machinery:
// - Persistent: one block of 384 threads per SM walks a list of work tiles
//   (128 query rows of one (b, h)), heaviest causal tiles first, dealt to
//   the blocks in snake order so heavy and light tiles even out.
//   Warpgroups 0 and 1 (the consumers) own 64 rows each; warpgroup 2 is
//   the producer, one thread of which issues every TMA load.
// - TMA brings q once per work tile (two stages, so the next tile's q
//   lands while this one runs) and k, v in tiles of 128 rows through two
//   rings of shared-memory stages (2 each at D = 128: 224 KB in all with
//   q and the o staging tile; 4 each at D = 64), each stage with a "full"
//   mbarrier (the expected bytes, counted down by TMA) and an "empty" one
//   (one arrival per consumer warpgroup).  The producer streams across
//   work tiles without a break.  Tiles arrive 128-byte swizzled, the layout the
//   wgmma descriptors name.  Rows past Sq or Sk arrive as zeros; keys past
//   Sk are still masked.
// - S = q.k^T is wgmma m64n128k16 from shared memory (both K-major) into
//   64 f32 registers a thread; the online softmax runs on that register
//   layout (a row's max and sum combine over the 4 lanes that share it), in
//   base 2: the max is taken on raw scores and scaled, p = 2^(s *
//   scale*log2(e) - m) is one FMA and one ex2.approx.ftz (2 ulp, results
//   under 2^-126 flushed), and lse converts back (m ln 2 + log l).  The
//   mask is applied only on tiles that cross the diagonal or Sk.
// - p is rounded to bf16 in registers and is the register A operand of the
//   P.V wgmma (v from shared memory, MN-major); o stays in registers for
//   the whole key loop.  Each step issues S of tile j, rescales o while S
//   runs, issues P.V of tile j-1 and runs tile j's softmax while P.V is on
//   the tensor cores.  setmaxnreg gives the consumers 240 registers and
//   leaves the producer 24.
// - The epilogue multiplies o by 1/l, writes bf16 into a staging tile in
//   shared memory (swizzled) and TMA stores it, which also drops rows past
//   Sq; the f32 lse goes out per row.
// No atomics and a fixed order: two runs are bitwise equal.
//
// K3, K4 and K2's float32 instance keep the first layout: a block of 4
// warps owns a 64-row tile (query rows in K2/K3, key rows in K4) and
// streams the other operand through shared memory in tiles of N rows (64
// for bf16, 32 for float32); warp w owns rows 16w..16w+15 of every
// per-block matrix.  K4 is one block per key tile accumulating over query
// tiles: no atomics, deterministic, like the Pallas version.  Causal blocks
// loop only over the tiles that hold live entries.  The float32 instance
// runs on the CUDA cores in full float32 (no TF32): it is the numerics
// reference on the card.
//
// What bounds them: at the LM-base training shape (B*H = 64, S = 1024,
// D = 128, causal) the forward does 17.2 GFLOP of products against 67.4 MB
// of operands read and written once (255 operations per byte, just under
// the card's ~295 bf16 balance point, so bytes bound it by a hair); K3
// (306) and K4 (340) sit just above it.  Either way the bound is tens of
// microseconds.  K2 in bf16 reaches about 44% of it; what it still pays
// is per work tile: the first S product and softmax, the last P.V and the
// epilogue overlap nothing, and both consumer warpgroups run them at the
// same time.  What still holds K3 and K4 far from it: their bf16
// products run through WMMA 16x16x16 fragments whose accumulators
// round-trip through shared memory every tile (strip_abt, strip_acc), with
// no register blocking and no overlap of loads and compute; sm90.cuh has
// the TMA, mbarrier and wgmma pieces to rebuild them as K2 is built.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "sm90.cuh"

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;  // 4 warps
constexpr int kM = 64;         // rows of the owned tile: 4 warps x 16 rows
constexpr float kNegInf = -1e30f;  // finite, as NEG_INF in ops/attention.py

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

template <typename T, int D>
struct Cfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int N = kF32 ? 32 : 64;  // rows of the streamed tile
  static constexpr int kCpl = N / 32;       // score columns per lane
  // leading dimensions in elements: +1 float keeps the scalar path's
  // column reads conflict-free; +8 bf16 / +4 float keep WMMA's 32-byte
  // fragment alignment while breaking the power-of-two row stride
  static constexpr int LDT = kF32 ? D + 1 : D + 8;  // T tiles (rows x D)
  static constexpr int LDS = kF32 ? N + 1 : N + 4;  // float scores (kM x N)
  static constexpr int LDP = kF32 ? LDS : N + 8;    // T probabilities / ds
  static constexpr int LDO = kF32 ? D + 1 : D + 4;  // float accumulators
  static constexpr size_t tile_m = align128(size_t(kM) * LDT * sizeof(T));
  static constexpr size_t tile_n = align128(size_t(N) * LDT * sizeof(T));
  static constexpr size_t score = align128(size_t(kM) * LDS * 4);
  // float32: the T copy of p / ds is the float score buffer itself
  static constexpr size_t prob = kF32 ? 0 : align128(size_t(kM) * LDP * 2);
  static constexpr size_t acc = align128(size_t(kM) * LDO * 4);
  static constexpr size_t fwd_smem = tile_m + 2 * tile_n + score + prob + acc;
  static constexpr size_t dq_smem =
      2 * tile_m + 2 * tile_n + 2 * score + prob + acc + 2 * kM * 4;
  static constexpr size_t dkv_smem =
      2 * tile_m + 2 * tile_n + 2 * score + prob + 2 * acc + 2 * N * 4;
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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
  if constexpr (C::kF32) {
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
  } else {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>
        fb;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
#pragma unroll
    for (int cb = 0; cb < C::N / 16; ++cb) {
      wmma::fill_fragment(fc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::load_matrix_sync(fa, A + warp * 16 * C::LDT + kk * 16, C::LDT);
        // col-major B: element (k, n) at B[(cb*16 + n) * LDT + kk*16 + k]
        wmma::load_matrix_sync(fb, B + cb * 16 * C::LDT + kk * 16, C::LDT);
        wmma::mma_sync(fc, fa, fb, fc);
      }
      wmma::store_matrix_sync(S + warp * 16 * C::LDS + cb * 16, fc, C::LDS,
                              wmma::mem_row_major);
    }
  }
}

// O[16w + r][n] += sum_j P[16w + r][j] * V[j][n] for the calling warp's 16
// rows: P is T (kM x N, LDP), V is T (N x D, LDT), O is float (kM x D, LDO).
template <typename T, int D>
__device__ __forceinline__ void strip_acc(float* O, const T* P, const T* V,
                                          int warp, int lane) {
  using C = Cfg<T, D>;
  if constexpr (C::kF32) {
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
  } else {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        fb;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
    float* o = O + warp * 16 * C::LDO;
#pragma unroll
    for (int nb = 0; nb < D / 16; ++nb) {
      wmma::load_matrix_sync(fc, o + nb * 16, C::LDO, wmma::mem_row_major);
#pragma unroll
      for (int jj = 0; jj < C::N / 16; ++jj) {
        wmma::load_matrix_sync(fa, P + warp * 16 * C::LDP + jj * 16, C::LDP);
        wmma::load_matrix_sync(fb, V + jj * 16 * C::LDT + nb * 16, C::LDT);
        wmma::mma_sync(fc, fa, fb, fc);
      }
      wmma::store_matrix_sync(o + nb * 16, fc, C::LDO, wmma::mem_row_major);
    }
  }
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
          from_float<T>(O[(warp * 16 + r) * C::LDO + n] *
                        (mul ? mul[r] : 1.f));
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
  static_assert(C::kF32, "the bf16 forward is fwd_sm90_kernel");
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
        Ps[row * C::LDP + lane + 32 * t] = from_float<T>(p);  // p in T
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

// ---------------------------------------------------------------- K3 ----
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
  T* Ps = C::kF32 ? reinterpret_cast<T*>(Ss) : reinterpret_cast<T*>(smem + off);
  off += C::prob;
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
        Ps[row * C::LDP + c] = from_float<T>(ds);  // ds in k's type
      }
    }
    __syncwarp();
    strip_acc<T, D>(dQs, Ps, Ks, warp, lane);
    __syncwarp();
  }
  store_rows<T, D>(static_cast<T*>(a.out0) + bh * a.Sq * D, dQs, nullptr, q0,
                   a.Sq, warp, lane);
}

// ---------------------------------------------------------------- K4 ----
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
  T* Ps = C::kF32 ? reinterpret_cast<T*>(Ss) : reinterpret_cast<T*>(smem + off);
  off += C::prob;
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
        if constexpr (!C::kF32)
          Ps[row * C::LDP + c] = from_float<T>(p);  // p in do's type
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
        Ps[row * C::LDP + c] = from_float<T>(ds);  // ds in q's type
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

// cuTensorMapEncodeTiled, a driver function, taken from the runtime so the
// library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A contiguous (BH, S, D) bf16 slab as the 3-D tensor {D, S, BH}
// (innermost first), moved in boxes of 64 columns x ``rows`` rows of one
// (b, h), 128-byte swizzled; boxes past S read as zeros.
bool encode_slab(EncodeTiled enc, CUtensorMap* map, const void* ptr, int BH,
                 int S, int D, int rows) {
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

template <int D>
int launch_fwd_sm90(const Args& a, int BH, cudaStream_t stream) {
  const EncodeTiled enc = tensor_map_encoder();
  if (!enc) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv, to;
  if (!encode_slab(enc, &tq, a.q, BH, a.Sq, D, 64) ||
      !encode_slab(enc, &tk, a.k, BH, a.Sk, D, kFwdN) ||
      !encode_slab(enc, &tv, a.v, BH, a.Sk, D, kFwdN) ||
      !encode_slab(enc, &to, a.out0, BH, a.Sq, D, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Fwd<D>::smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return static_cast<int>(err);
  const int n_work = (a.Sq + kFwdM - 1) / kFwdM * BH;  // one block per SM
  fwd_sm90_kernel<D><<<std::min(n_work, sms), kFwdThreads, Fwd<D>::smem,
                       stream>>>(tq, tk, tv, to, a.lse, a.Sq, a.Sk,
                                 a.causal, a.scale * kLog2e, BH);
  return static_cast<int>(cudaGetLastError());
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int D>
int launch(Which which, const Args& a, int BH, cudaStream_t stream) {
  using C = Cfg<T, D>;
  void (*kernel)(Args);
  size_t smem;
  int rows;
  if (which == kFwd) {
    if constexpr (C::kF32) {
      kernel = fwd_kernel<T, D>;
      smem = C::fwd_smem;
      rows = a.Sq;
    } else {
      return launch_fwd_sm90<D>(a, BH, stream);
    }
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

// Dynamic shared memory of the bf16 forward at head dim D (0 if none).
extern "C" int flash_fwd_sm90_smem(int D) {
  return D == 64 ? static_cast<int>(Fwd<64>::smem)
                 : D == 128 ? static_cast<int>(Fwd<128>::smem) : 0;
}

extern "C" const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
