// Fused BatchNorm+ReLU backward for Hopper (sm_90a): two kernels over the
// (M, C) rows of a channels_last activation.  Built by ops/_build.py with
// nvcc into a shared library with a plain C interface and called through
// ctypes from ops/fused_bn.py (bn_relu_bwd_reduce, bn_relu_bwd_apply).
//
// Replaces the JAX package's Pallas TPU kernels
//   K1a  distributed_pytorch_tpu/ops/fused_bn.py:106  _reduce_kernel
//   K1b  distributed_pytorch_tpu/ops/fused_bn.py:121  _apply_kernel
//
// What they compute, per channel c over the M rows (a, dr in the compute
// dtype T, float32 or bf16; mean, rstd, gamma, beta float32):
//   y     = ((a - T(mean)) * T(rstd * gamma)) + T(beta), each of the three
//           operations rounded to T: the forward's eager arithmetic
//           (ops/nn.py normalize), so the ReLU mask y > 0 is the forward's,
//           bit for bit;
//   dy    = y > 0 ? dr : 0, xhat = (a - mean) * rstd, in float32;
//   K1a:  s1 = sum(dy), s2 = sum(dy * xhat)                 (dbeta, dgamma)
//   K1b:  da = T(gamma * rstd * (dy - (s1 + xhat * s2) * (1 / M)))
// The mask and the da arithmetic use __fadd_rn / __fmul_rn: nvcc would
// otherwise contract a multiply and an add into one FMA, which rounds once
// where PyTorch rounds twice and flips the mask where y lands near 0.
//
// Their floor is bytes: K1a reads dr and a once (2 M C itemsize bytes),
// K1b reads them again and writes da (3 M C itemsize), a few operations an
// element.  What bounds them on the card, measured over VGG-11's eight BN
// layers at batch 256 (chip_smoke.py phase 12; PERF.md section 6):
//   - a fixed cost a launch: K1b takes ~4 us on the smallest layers (2 MB
//     read, bound 0.9), K1a ~7, for its blocks must all arrive before the
//     last one merges (~1 us to arrive, ~1.6 us + the partial rows' L2
//     round trips to merge); six of the eight layers read 2-17 MB (bf16),
//     where this is most of the time (bf16 over the eight: K1a at 44%, K1b
//     at 70% of their bounds);
//   - on the largest layer, bf16 K1a's arithmetic between batches of loads
//     (59% of its bound there; f32 K1a 81%, K1b 79-80%).
// The design:
//   - one launch each, one wave: the plan (make_plan, computed here alone;
//     ops/fused_bn.py reads it through fused_bn_plan) cuts C into channel
//     tiles of one 128-byte line of a row and each tile's rows into row
//     blocks, 2 blocks an SM over all tiles, never fewer rows a block than
//     threads down it; a thread walks its rows 4 at a time, all their
//     16-byte loads issued before any is used, the first batch before the
//     block meets for its constants; a thread with no rows in its block
//     loads nothing;
//   - a block's per-channel constants are derived once into shared memory
//     (the mask's, rounded to T, there); each thread keeps its channels';
//   - K1a: each block folds its sums in a fixed-order tree over all its
//     threads, writes one partial row and arrives on its tile's counter
//     (one atom.acq_rel.gpu after the block's barrier); the tile's last
//     block sums the partial rows in ascending order and resets the
//     counter.  No float atomics: two runs on one input are bitwise equal;
//   - the bf16 mask runs two channels an instruction (bf16x2 fmas, exact:
//     see Chans<__nv_bfloat16, 8>), and da is packed two channels a
//     conversion;
//   - K1b walks each row block last batch first: right after K1a, which
//     walked it first to last, its last rows are the likeliest in L2;
//   - both launch as programmatic dependents (follow_previous_grid), so a
//     launch's blocks are resident when the previous kernel drains, where
//     that kernel lets its dependents go early: K1b after K1a does; K1a
//     after the step's convolution backward does not.
// Tried and not kept (PERF.md section 6): a per-thread cp.async ring of 8 rows
// in shared memory (bf16 no faster, f32 K1a +19%); 3 blocks an SM (spills,
// both kernels slower); each row's registers refilled with the next batch's
// row as soon as it is used (K1b +10% bf16, +13% f32); K1a and K1b as one
// cooperative launch keeping the rows in shared memory where they fit (~1 us a
// layer: the second launch and re-read already cost little).

#include <stdint.h>

// ---- The launch plan: plain C++, the one place it is computed.  nvcc
// builds the whole file; the tests build this part alone with the host
// compiler (the CUDA part below is nvcc's only) and check the plan there.
// ops/fused_bn.py reads it through fused_bn_plan to size K1a's workspace.

namespace {

constexpr int kThreads = 256;
constexpr int kTileBytes = 128;
constexpr int kBlocksPerSm = 2;
// K1a's workspace: one int32 arrival counter for every channel tile a
// launch can have (grid.y's limit), all 0 between launches, then the
// partial rows.  The counters keep their place whatever the plan, so no
// launch finds another's partials where it counts arrivals; they share
// one buffer with the partials because K1a's C entry has one workspace
// slot (its ctypes signature is ops/_build.py's).  256 KB a stream.
constexpr int kMaxTiles = 65535;
constexpr int kErrBadArgs = 1;  // cudaErrorInvalidValue

// Channel tiles of `tile` vectors of `vec` channels (one 128-byte line of
// a row, or all of C), `tiles` of them across C, ty_n threads down each
// column of a block; each tile's rows cut into `blocks` row blocks of
// `rows` rows (the last one shorter, none empty): about kBlocksPerSm
// blocks an SM over all tiles, one wave, but never fewer rows a block
// than threads down it.  K1a: one partial row of `stride` floats a block
// (s1 then s2 of the tile's channels, padded to whole float4s), and
// `ws_floats` floats of workspace in all.
struct Plan {
  int tile, tiles, ty_n, blocks, rows, stride;
  int64_t ws_floats;
};

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// False for arguments no launch takes.
bool make_plan(int M, int C, int vec, int itemsize, int n_sm, Plan* p) {
  if (M < 1 || C < 1 || n_sm < 1 || (itemsize != 2 && itemsize != 4) ||
      !(vec == 1 || vec * itemsize == 16) || C % vec ||
      static_cast<int64_t>(M) * C >= (int64_t{1} << 31))
    return false;
  const int cv = C / vec, line = kTileBytes / (vec * itemsize);
  p->tile = cv < line ? cv : line;
  p->tiles = static_cast<int>(cdiv(cv, p->tile));
  if (p->tiles > kMaxTiles) return false;
  p->ty_n = kThreads / p->tile;
  int64_t blocks = cdiv(int64_t{kBlocksPerSm} * n_sm, p->tiles);
  if (blocks > cdiv(M, p->ty_n)) blocks = cdiv(M, p->ty_n);
  p->rows = static_cast<int>(cdiv(M, blocks));
  p->blocks = static_cast<int>(cdiv(M, p->rows));
  p->stride = (2 * p->tile * vec + 3) / 4 * 4;
  p->ws_floats = kMaxTiles + 1 +
                 static_cast<int64_t>(p->tiles) * p->blocks * p->stride;
  return true;
}

}  // namespace

// The plan of K1a and K1b over (M, C) rows of `itemsize`-byte values,
// `vec` channels a load, on `n_sm` SMs: out = tile, tiles, ty_n, blocks,
// rows, stride, ws_floats.  Returns 0, or cudaErrorInvalidValue for
// arguments no launch takes.
extern "C" int fused_bn_plan(int M, int C, int vec, int itemsize, int n_sm,
                             int64_t* out) {
  Plan p;
  if (!make_plan(M, C, vec, itemsize, n_sm, &p)) return kErrBadArgs;
  const int64_t v[7] = {p.tile, p.tiles, p.ty_n,     p.blocks,
                        p.rows, p.stride, p.ws_floats};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

#ifdef __CUDACC__

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

static_assert(kErrBadArgs == static_cast<int>(cudaErrorInvalidValue),
              "fused_bn_plan's error code is a CUDA error code");

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the rounding PyTorch applies after each eager
// operation in T (float32: none)
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_f<T>(from_f<T>(x));
}

// Two floats rounded to bf16 (round to nearest even, as __float2bfloat16_rn
// rounds each) and packed, lo in the low half: one conversion for two.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// a * b + c on two bf16 pairs, rounded once to bf16.
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ float lo_f(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  if constexpr (VEC * sizeof(T) == 16 && sizeof(T) == 2) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = pack_bf16x2(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = from_f<T>(in[i]);
  }
}

// Rows a thread has in flight: each batch issues all its loads before any
// of them is used.
constexpr int kRowsInFlight = 4;

template <typename T, int VEC>
struct Rows {
  static constexpr bool kWide = VEC * sizeof(T) == 16;
  static_assert(kWide || VEC == 1, "16-byte vectors or one channel");
  using Raw = typename std::conditional<kWide, uint4, T>::type;
  static __device__ __forceinline__ Raw load(const T* p) {
    return *reinterpret_cast<const Raw*>(p);
  }
  static __device__ __forceinline__ void to_float(const Raw& r, float* out) {
    const T* v = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f<T>(v[i]);
  }
};

// Programmatic dependent launch: both kernels are launched so that the
// next kernel on the stream may put its blocks on the SMs while this one's
// last blocks still merge and drain.  Every block lets the next launch go
// at once, then waits for the previous kernel on the stream to finish and
// its writes to be visible before it touches memory.
__device__ __forceinline__ void follow_previous_grid() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Batch [r, r + kRowsInFlight * ty_n) of a thread's rows (stride ty_n,
// below r1) of a and dr at channel c0: all loads issued, none used.
template <typename R, typename T>
__device__ __forceinline__ void load_rows(typename R::Raw (&ra)[kRowsInFlight],
                                          typename R::Raw (&rd)[kRowsInFlight],
                                          const T* __restrict__ a,
                                          const T* __restrict__ dr, int64_t r,
                                          int64_t r1, int ty_n, int C,
                                          int c0) {
#pragma unroll
  for (int u = 0; u < kRowsInFlight; ++u) {
    const int64_t ru = r + u * ty_n;
    if (ru < r1) {
      ra[u] = R::load(a + ru * C + c0);
      rd[u] = R::load(dr + ru * C + c0);
    }
  }
}

// atomicAdd(counter, 1) with acquire and release semantics at GPU scope.
__device__ __forceinline__ int arrive(int* counter) {
  int before;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(before)
               : "l"(counter)
               : "memory");
  return before;
}

// The last block of tile y to arrive: s1, s2 of the tile's channels = its
// blocks' partial rows summed in ascending order, spread over the block:
// thread (g, lane) sums float4 lane `lane` of rows g, g + G, ... in order,
// then thread o adds the G group sums of value o in group order.  With
// kBatched (the bf16 instances, whose largest layer merges 33 rows a
// thread) a thread loads kMergeLoads rows before it adds any: without it
// each load waited on the add before it, one L2 round trip a row.  The
// float32 instances measured ~2 us a launch slower so and keep the loop
// (PERF.md section 6).
constexpr int kMergeLoads = 8;

template <bool kBatched>
__device__ __forceinline__ void merge_tile(const float* __restrict__ part,
                                           float* __restrict__ s1,
                                           float* __restrict__ s2,
                                           float4* red, int n_rows, int S,
                                           int width, int c_base, int C) {
  const int L = S / 4, G = kThreads / L;
  const float4* p4 = reinterpret_cast<const float4*>(part);
  if (threadIdx.x < G * L) {
    const int lane = threadIdx.x % L, g = threadIdx.x / L;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (kBatched) {
      for (int j0 = g; j0 < n_rows; j0 += kMergeLoads * G) {
        float4 v[kMergeLoads];
#pragma unroll
        for (int u = 0; u < kMergeLoads; ++u) {
          const int j = j0 + u * G;
          if (j < n_rows)
            v[u] = __ldcg(p4 + static_cast<int64_t>(j) * L + lane);
        }
#pragma unroll
        for (int u = 0; u < kMergeLoads; ++u) {
          if (j0 + u * G < n_rows) {
            acc.x += v[u].x;
            acc.y += v[u].y;
            acc.z += v[u].z;
            acc.w += v[u].w;
          }
        }
      }
    } else {
#pragma unroll 16
      for (int j = g; j < n_rows; j += G) {
        const float4 v = __ldcg(p4 + static_cast<int64_t>(j) * L + lane);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
    }
    red[threadIdx.x] = acc;
  }
  __syncthreads();
  const float* redf = reinterpret_cast<const float*>(red);
  for (int o = threadIdx.x; o < 2 * width; o += kThreads) {
    float t = 0.f;
    for (int g = 0; g < G; ++g) t += redf[g * S + o];
    const int c = c_base + o % width;
    if (c < C) (o < width ? s1 : s2)[c] = t;
  }
}

// A block's per-channel constants: threads 0 .. width - 1 derive those of
// the tile's channels once (channel c = c_base + thread, 0 past C) into
// kc[i][thread]: mean, rstd, then the mask's constants cast to T, then
// gamma * rstd, s1, s2 where K1b needs them (n = 8).
template <typename T, int N>
__device__ __forceinline__ void tile_constants(
    float (*kc)[kTileBytes / sizeof(T)], const float* __restrict__ mean,
    const float* __restrict__ rstd, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ s1,
    const float* __restrict__ s2, int width, int c_base, int C) {
  if (threadIdx.x < width) {
    const int c = c_base + threadIdx.x;
    const bool in = c < C;
    const float mu = in ? mean[c] : 0.f, rs = in ? rstd[c] : 0.f;
    const float g = in ? gamma[c] : 0.f, b = in ? beta[c] : 0.f;
    kc[0][threadIdx.x] = mu;
    kc[1][threadIdx.x] = rs;
    kc[2][threadIdx.x] = rnd<T>(mu);
    kc[3][threadIdx.x] = rnd<T>(__fmul_rn(rs, g));
    kc[4][threadIdx.x] = rnd<T>(b);
    if constexpr (N == 8) {
      kc[5][threadIdx.x] = __fmul_rn(g, rs);
      kc[6][threadIdx.x] = in ? s1[c] : 0.f;
      kc[7][threadIdx.x] = in ? s2[c] : 0.f;
    }
  }
  __syncthreads();
}

// A thread's VEC channels, from the block's constants kc at i0: mean and
// rstd for xhat = (a - mean) * rstd in float32, and the mask's constants
// cast to T for the forward's y > 0, operation for operation:
// y = T(T(T(a - mean_t) * inv_t) + beta_t).
template <typename T, int VEC>
struct Chans {
  float mean[VEC], rstd[VEC], mean_t[VEC], inv_t[VEC], beta_t[VEC];

  __device__ __forceinline__ void load(
      const float (*kc)[kTileBytes / sizeof(T)], int i0) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      mean[v] = kc[0][i0 + v];
      rstd[v] = kc[1][i0 + v];
      mean_t[v] = kc[2][i0 + v];
      inv_t[v] = kc[3][i0 + v];
      beta_t[v] = kc[4][i0 + v];
    }
  }
  template <typename Raw>
  __device__ __forceinline__ void live(const Raw&, const float* a,
                                       bool* out) const {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float y = rnd<T>(__fsub_rn(a[v], mean_t[v]));
      y = rnd<T>(__fmul_rn(y, inv_t[v]));
      y = rnd<T>(__fadd_rn(y, beta_t[v]));
      out[v] = y > 0.f;
    }
  }
  __device__ __forceinline__ float xhat(float a, int v) const {
    return __fmul_rn(__fsub_rn(a, mean[v]), rstd[v]);
  }
};

// 16 bytes of bf16: the mask two channels an operation.  The difference
// and the sum are bf16x2 fmas (a + (-1) * mean_t, y * 1 + beta_t), rounded
// once to bf16: a sum of two bf16 values is exact in float32, or too far
// from a bf16 tie to round otherwise, so this is the eager float32
// operation rounded to bf16, bit for bit.  The product keeps float32 (a
// product in float32's subnormal range rounds twice there) and rounds two
// channels in one conversion.
template <>
struct Chans<__nv_bfloat16, 8> {
  static constexpr uint32_t kOne = 0x3f803f80u, kMinusOne = 0xbf80bf80u;
  float mean[8], rstd[8], inv_t[8];
  uint32_t mean_t[4], beta_t[4];  // channel pairs, bf16x2

  __device__ __forceinline__ void load(const float (*kc)[64], int i0) {
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      mean[v] = kc[0][i0 + v];
      rstd[v] = kc[1][i0 + v];
      inv_t[v] = kc[3][i0 + v];
    }
    // exact: the values are bf16 already
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mean_t[i] = (__float_as_uint(kc[2][i0 + 2 * i]) >> 16) |
                  (__float_as_uint(kc[2][i0 + 2 * i + 1]) & 0xffff0000u);
      beta_t[i] = (__float_as_uint(kc[4][i0 + 2 * i]) >> 16) |
                  (__float_as_uint(kc[4][i0 + 2 * i + 1]) & 0xffff0000u);
    }
  }
  __device__ __forceinline__ void live(const uint4& raw, const float*,
                                       bool* out) const {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t d = fma_bf16x2(mean_t[i], kMinusOne, w[i]);
      const uint32_t p =
          pack_bf16x2(__fmul_rn(lo_f(d), inv_t[2 * i]),
                      __fmul_rn(hi_f(d), inv_t[2 * i + 1]));
      const uint32_t y = fma_bf16x2(p, kOne, beta_t[i]);
      out[2 * i] = lo_f(y) > 0.f;
      out[2 * i + 1] = hi_f(y) > 0.f;
    }
  }
  __device__ __forceinline__ float xhat(float a, int v) const {
    return __fmul_rn(__fsub_rn(a, mean[v]), rstd[v]);
  }
};

// K1a: block (row block x, tile y) sums its rows into a partial row; the
// last block of the tile to arrive merges the tile's partials into s1, s2
// and leaves the tile's arrival counter at 0.  Thread t owns channel
// vector y * tile + t % tile and rows t / tile, + ty_n, ... of the block.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    reduce_kernel(const T* __restrict__ dr, const T* __restrict__ a,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta, int* __restrict__ counters,
                  float* __restrict__ partial, float* __restrict__ s1,
                  float* __restrict__ s2, int M, int C, const Plan p) {
  using R = Rows<T, VEC>;
  follow_previous_grid();
  // the block's sums, ty_n rows of S floats (reused by the merge)
  __shared__ float4 sh4[kThreads * (2 * VEC + 2) / 4];
  __shared__ float red[kThreads];
  __shared__ __align__(16) float kc[5][kTileBytes / sizeof(T)];
  __shared__ int is_last;
  const int tile = p.tile, ty_n = p.ty_n;
  const int tx = threadIdx.x % tile, ty = threadIdx.x / tile;
  const int width = tile * VEC, c0 = blockIdx.y * width + tx * VEC;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * p.rows + ty;
  const int64_t r1 = min(static_cast<int64_t>(M),
                         (static_cast<int64_t>(blockIdx.x) + 1) * p.rows);
  // a thread with no rows in its block (rows < ty_n) loads nothing
  const bool on = ty < ty_n && c0 < C && r0 < r1;
  const int64_t step = kRowsInFlight * ty_n;
  typename R::Raw ra[kRowsInFlight], rd[kRowsInFlight];
  // the first batch's loads go out before the block meets for its constants
  if (on) load_rows<R>(ra, rd, a, dr, r0, r1, ty_n, C, c0);
  tile_constants<T, 5>(kc, mean, rstd, gamma, beta, nullptr, nullptr, width,
                       blockIdx.y * width, C);
  float s1v[VEC], s2v[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) s1v[v] = s2v[v] = 0.f;
  if (on) {
    Chans<T, VEC> k;
    k.load(kc, tx * VEC);
    for (int64_t r = r0; r < r1; r += step) {
      if (r != r0) load_rows<R>(ra, rd, a, dr, r, r1, ty_n, C, c0);
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        if (r + u * ty_n < r1) {
          float av[VEC], dv[VEC];
          bool on_v[VEC];
          R::to_float(ra[u], av);
          R::to_float(rd[u], dv);
          k.live(ra[u], av, on_v);
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            if (on_v[v]) {
              s1v[v] += dv[v];
              s2v[v] = fmaf(dv[v], k.xhat(av[v], v), s2v[v]);
            }
          }
        }
      }
    }
  }
  // the block's partial row: thread (g, o) sums value o over rows g,
  // g + G, ... of the block's sums in order, then thread o adds the G
  // group sums in group order
  const int S = p.stride;
  float* sh = reinterpret_cast<float*>(sh4);
  if (ty < ty_n) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      sh[ty * S + tx * VEC + v] = s1v[v];
      sh[ty * S + width + tx * VEC + v] = s2v[v];
    }
  }
  __syncthreads();
  const int G = kThreads / S;
  if (threadIdx.x < G * S) {
    const int o = threadIdx.x % S, g = threadIdx.x / S;
    float t = 0.f;
    for (int j = g; j < ty_n; j += G) t += sh[j * S + o];
    red[threadIdx.x] = t;
  }
  __syncthreads();
  float* part = partial + static_cast<int64_t>(blockIdx.y) * gridDim.x * S;
  if (threadIdx.x < S) {
    float t = 0.f;
    for (int g = 0; g < G; ++g) t += red[g * S + threadIdx.x];
    part[static_cast<int64_t>(blockIdx.x) * S + threadIdx.x] = t;
  }
  // arrive: one thread, after the block's barrier, adds to the tile's
  // counter with release and acquire semantics, which order the block's
  // partial row before the arrival and the other blocks' rows before the
  // last block's merge; the last block merges the tile's partials
  __syncthreads();
  if (threadIdx.x == 0) {
    const int before = arrive(counters + blockIdx.y);
    is_last = before == static_cast<int>(gridDim.x) - 1;
    if (is_last) counters[blockIdx.y] = 0;  // every block has arrived
  }
  __syncthreads();
  if (!is_last) return;
  merge_tile<sizeof(T) == 2 && VEC == 8>(part, s1, s2, sh4, gridDim.x, S,
                                         width, blockIdx.y * width, C);
}

// K1b: da for every row of the block (row block x, tile y), the same
// tiling and row blocks as K1a.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    apply_kernel(const T* __restrict__ dr, const T* __restrict__ a,
                 const float* __restrict__ mean,
                 const float* __restrict__ rstd,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta,
                 const float* __restrict__ s1, const float* __restrict__ s2,
                 T* __restrict__ da, int M, int C, const Plan p,
                 float inv_n) {
  using R = Rows<T, VEC>;
  follow_previous_grid();
  __shared__ __align__(16) float kc[8][kTileBytes / sizeof(T)];
  const int tile = p.tile, ty_n = p.ty_n;
  const int tx = threadIdx.x % tile, ty = threadIdx.x / tile;
  const int width = tile * VEC, c0 = blockIdx.y * width + tx * VEC;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * p.rows + ty;
  const int64_t r1 = min(static_cast<int64_t>(M),
                         (static_cast<int64_t>(blockIdx.x) + 1) * p.rows);
  // a thread with no rows in its block (rows < ty_n) loads nothing
  const bool on = ty < ty_n && c0 < C && r0 < r1;
  // the block's batches of rows last first: right after K1a, which walked
  // the same rows first to last, the last ones are the likeliest in L2;
  // every row a thread loads lies in [r0, r1)
  const int64_t step = kRowsInFlight * ty_n;
  const int64_t last = on ? r0 + (r1 - 1 - r0) / step * step : r0;
  typename R::Raw ra[kRowsInFlight], rd[kRowsInFlight];
  // the first batch's loads go out before the block meets for its constants
  if (on) load_rows<R>(ra, rd, a, dr, last, r1, ty_n, C, c0);
  tile_constants<T, 8>(kc, mean, rstd, gamma, beta, s1, s2, width,
                       blockIdx.y * width, C);
  if (!on) return;
  Chans<T, VEC> k;
  k.load(kc, tx * VEC);
  float coef[VEC], t1[VEC], t2[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const int i = tx * VEC + v;
    coef[v] = kc[5][i];
    t1[v] = kc[6][i];
    t2[v] = kc[7][i];
  }
  for (int64_t r = last; r >= r0; r -= step) {
    if (r != last) load_rows<R>(ra, rd, a, dr, r, r1, ty_n, C, c0);
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int64_t ru = r + u * ty_n;
      if (ru < r1) {
        float av[VEC], dv[VEC], out[VEC];
        bool on_v[VEC];
        R::to_float(ra[u], av);
        R::to_float(rd[u], dv);
        k.live(ra[u], av, on_v);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float dy = on_v[v] ? dv[v] : 0.f;
          const float xh = k.xhat(av[v], v);
          const float t =
              __fmul_rn(__fadd_rn(t1[v], __fmul_rn(xh, t2[v])), inv_n);
          out[v] = __fmul_rn(coef[v], __fsub_rn(dy, t));
        }
        store_vec<T, VEC>(da + ru * C + c0, out);
      }
    }
  }
}

// The SM count of the current device (cached).
int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cached[dev]) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = n;
  }
  return cached[dev];
}

// Launch `kernel` over the plan's grid on `stream` as a programmatic
// dependent of the previous kernel there (see follow_previous_grid).
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), const Plan& p, cudaStream_t stream,
           Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.blocks, p.tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
}

template <typename T, int VEC>
int reduce_launch(const void* dr, const void* a, const float* mean,
                  const float* rstd, const float* gamma, const float* beta,
                  float* ws, float* s1, float* s2, int M, int C,
                  int ws_floats, cudaStream_t stream) {
  Plan p;
  if (!make_plan(M, C, VEC, sizeof(T), sm_count(), &p) ||
      p.ws_floats > ws_floats)
    return kErrBadArgs;
  int* counters = reinterpret_cast<int*>(ws);
  float* partial = ws + kMaxTiles + 1;
  return launch(reduce_kernel<T, VEC>, p, stream, static_cast<const T*>(dr),
                static_cast<const T*>(a), mean, rstd, gamma, beta, counters,
                partial, s1, s2, M, C, p);
}

template <typename T, int VEC>
int apply_launch(const void* dr, const void* a, const float* mean,
                 const float* rstd, const float* gamma, const float* beta,
                 const float* s1, const float* s2, void* da, int M, int C,
                 float inv_n, cudaStream_t stream) {
  Plan p;
  if (!make_plan(M, C, VEC, sizeof(T), sm_count(), &p)) return kErrBadArgs;
  return launch(apply_kernel<T, VEC>, p, stream, static_cast<const T*>(dr),
                static_cast<const T*>(a), mean, rstd, gamma, beta, s1, s2,
                static_cast<T*>(da), M, C, p, inv_n);
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// K1a over (M, C) rows: dtype 0 = float32, 1 = bf16; vec = channels per
// load (16 / itemsize, needing C % vec == 0 and 16-byte aligned rows, or
// 1); ws the float32 workspace of ws_floats floats (kMaxTiles + 1 int32
// arrival counters, all 0, then the partial rows), at least the plan's
// (fused_bn_plan); s1, s2 float32 (C,).  Returns 0 or a CUDA error code
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int bn_relu_bwd_reduce_launch(
    int dtype, int vec, const void* dr, const void* a, const void* mean,
    const void* rstd, const void* gamma, const void* beta, void* ws,
    void* s1, void* s2, int M, int C, int ws_floats, void* stream) {
  const auto* mu = static_cast<const float*>(mean);
  const auto* rs = static_cast<const float*>(rstd);
  const auto* g = static_cast<const float*>(gamma);
  const auto* b = static_cast<const float*>(beta);
  auto* w = static_cast<float*>(ws);
  auto* o1 = static_cast<float*>(s1);
  auto* o2 = static_cast<float*>(s2);
  auto st = static_cast<cudaStream_t>(stream);
  const bool wide = aligned(dr) && aligned(a);
  if (!aligned(ws)) return kErrBadArgs;
  if (dtype == 0) {
    if (vec == 4 && wide)
      return reduce_launch<float, 4>(dr, a, mu, rs, g, b, w, o1, o2, M, C,
                                     ws_floats, st);
    if (vec == 1)
      return reduce_launch<float, 1>(dr, a, mu, rs, g, b, w, o1, o2, M, C,
                                     ws_floats, st);
  } else if (dtype == 1) {
    if (vec == 8 && wide)
      return reduce_launch<__nv_bfloat16, 8>(dr, a, mu, rs, g, b, w, o1, o2,
                                             M, C, ws_floats, st);
    if (vec == 1)
      return reduce_launch<__nv_bfloat16, 1>(dr, a, mu, rs, g, b, w, o1, o2,
                                             M, C, ws_floats, st);
  }
  return kErrBadArgs;
}

// K1b over (M, C) rows: da in the compute dtype; inv_n = float32(1 / M).
// Returns as bn_relu_bwd_reduce_launch does.
extern "C" int bn_relu_bwd_apply_launch(
    int dtype, int vec, const void* dr, const void* a, const void* mean,
    const void* rstd, const void* gamma, const void* beta, const void* s1,
    const void* s2, void* da, int M, int C, float inv_n, void* stream) {
  const auto* mu = static_cast<const float*>(mean);
  const auto* rs = static_cast<const float*>(rstd);
  const auto* g = static_cast<const float*>(gamma);
  const auto* b = static_cast<const float*>(beta);
  const auto* t1 = static_cast<const float*>(s1);
  const auto* t2 = static_cast<const float*>(s2);
  auto st = static_cast<cudaStream_t>(stream);
  const bool wide = aligned(dr) && aligned(a) && aligned(da);
  if (dtype == 0) {
    if (vec == 4 && wide)
      return apply_launch<float, 4>(dr, a, mu, rs, g, b, t1, t2, da, M, C,
                                    inv_n, st);
    if (vec == 1)
      return apply_launch<float, 1>(dr, a, mu, rs, g, b, t1, t2, da, M, C,
                                    inv_n, st);
  } else if (dtype == 1) {
    if (vec == 8 && wide)
      return apply_launch<__nv_bfloat16, 8>(dr, a, mu, rs, g, b, t1, t2, da,
                                            M, C, inv_n, st);
    if (vec == 1)
      return apply_launch<__nv_bfloat16, 1>(dr, a, mu, rs, g, b, t1, t2, da,
                                            M, C, inv_n, st);
  }
  return kErrBadArgs;
}

// Resident blocks an SM of the current device holds of one instance:
// kernel 0 = K1a, 1 = K1b; dtype and vec as the launchers take them; -1
// for an instance that does not exist.
extern "C" int fused_bn_occupancy(int kernel, int dtype, int vec) {
  const void* fn = nullptr;
  if (dtype == 0 && vec == 4)
    fn = kernel ? reinterpret_cast<const void*>(apply_kernel<float, 4>)
                : reinterpret_cast<const void*>(reduce_kernel<float, 4>);
  else if (dtype == 0 && vec == 1)
    fn = kernel ? reinterpret_cast<const void*>(apply_kernel<float, 1>)
                : reinterpret_cast<const void*>(reduce_kernel<float, 1>);
  else if (dtype == 1 && vec == 8)
    fn = kernel
             ? reinterpret_cast<const void*>(apply_kernel<__nv_bfloat16, 8>)
             : reinterpret_cast<const void*>(reduce_kernel<__nv_bfloat16, 8>);
  else if (dtype == 1 && vec == 1)
    fn = kernel
             ? reinterpret_cast<const void*>(apply_kernel<__nv_bfloat16, 1>)
             : reinterpret_cast<const void*>(reduce_kernel<__nv_bfloat16, 1>);
  if (!fn) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads, 0) !=
      cudaSuccess)
    return -1;
  return n;
}

extern "C" const char* fused_bn_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#endif  // __CUDACC__
