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
// Layout, designed for the GPU rather than copied from the TPU grid: a
// block of 4 warps owns a 64-row tile (query rows in K2/K3, key rows in K4)
// and streams the other operand through shared memory in tiles of N rows
// (64 for bf16, 32 for float32, so the float32 instance fits in shared
// memory).  Warp w owns rows 16w..16w+15 of every per-block matrix (scores,
// probabilities, the float32 accumulators), so the softmax statistics and
// the accumulators of a row are touched by one warp only and the block
// synchronizes only around each streamed tile's load.  K4 is one block per
// key tile accumulating over query tiles: no atomics, deterministic, like the
// Pallas version.  Causal blocks loop only over the tiles that hold live
// entries.
//
// What bounds it: both, nearly equally.  At the LM-base training shape
// (B*H = 64, S = 1024, D = 128, causal) the forward does 17.2 GFLOP of
// products against 67.4 MB of operands read and written once (255
// operations per byte, just under the card's ~295 bf16 balance point, so
// bytes bound it by a hair); K3 (306) and K4 (340) sit just above it.
// Either way the bound is tens of microseconds, and a simple kernel is far
// from it.  The bf16 products run on the tensor cores through WMMA
// 16x16x16 fragments (float32
// accumulators); the float32 instance runs on the CUDA cores in full float32
// (no TF32), since it is the numerics reference on the card.  Known limits:
// the accumulators round-trip through shared memory every tile, operand
// fragments are re-read from shared memory for every product (no register
// blocking), loads are not pipelined with compute, and one or two blocks fit
// an SM.  wgmma, TMA and a producer/consumer pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

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

// ---------------------------------------------------------------- K2 ----
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) fwd_kernel(Args a) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + C::tile_m);
  T* Vs = reinterpret_cast<T*>(smem + C::tile_m + C::tile_n);
  float* Ss = reinterpret_cast<float*>(smem + C::tile_m + 2 * C::tile_n);
  T* Ps = C::kF32 ? reinterpret_cast<T*>(Ss)
                  : reinterpret_cast<T*>(smem + C::tile_m + 2 * C::tile_n +
                                         C::score);
  float* Os = reinterpret_cast<float*>(smem + C::tile_m + 2 * C::tile_n +
                                       C::score + C::prob);

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

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int D>
int launch(Which which, const Args& a, int BH, cudaStream_t stream) {
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

extern "C" const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
