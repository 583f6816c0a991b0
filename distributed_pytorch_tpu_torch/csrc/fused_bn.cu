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
// What bounds them: bytes.  K1a reads dr and a once (2 M C itemsize bytes),
// K1b reads them again and writes da (3 M C itemsize); a few flops per
// element, far below the card's balance point.  So the design streams:
//   - threads walk channels innermost, VEC channels each (16-byte vector
//     loads where C and the pointers allow), so a warp reads contiguous
//     rows; the Pallas kernel's lane fold (C < 128) is a TPU layout device
//     and has no counterpart: channels are indexed directly;
//   - the per-channel constants live in registers for the whole walk;
//   - K1a: a 2-D grid of row strips x channel tiles; each block reduces its
//     strip through shared memory in a fixed order and writes float32
//     partials (n_strips, 2, C); a second small launch sums the partials
//     over the strips in a fixed order (8 warps over the strips, then the
//     warps in order).  No float atomics: two runs on the same input are
//     bitwise equal.
//   - K1b: a grid-stride elementwise pass over the same tiling.
// Known limit: nothing overlaps a block's loads with its arithmetic beyond
// what the warps in flight give, and K1b re-reads what K1a read; a
// single-pass cooperative version (grid-wide barrier between the sums and
// da) would save 2 of the 5 passes when the activation fits in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVec = 8;  // 16 bytes of bf16

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

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f<T>(v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f<T>(p[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = from_f<T>(in[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = from_f<T>(in[i]);
  }
}

// The per-channel constants of one channel.
struct Chan {
  float mean, rstd;          // float32, for xhat
  float mean_t, inv_t, beta_t;  // cast to T, for the mask
};

template <typename T>
__device__ __forceinline__ Chan load_chan(const float* mean,
                                          const float* rstd,
                                          const float* gamma,
                                          const float* beta, int c) {
  Chan k;
  k.mean = mean[c];
  k.rstd = rstd[c];
  k.mean_t = rnd<T>(k.mean);
  k.inv_t = rnd<T>(__fmul_rn(k.rstd, gamma[c]));
  k.beta_t = rnd<T>(beta[c]);
  return k;
}

// The forward's y > 0, operation for operation.
template <typename T>
__device__ __forceinline__ bool live(float a, const Chan& k) {
  float y = rnd<T>(__fsub_rn(a, k.mean_t));
  y = rnd<T>(__fmul_rn(y, k.inv_t));
  y = rnd<T>(__fadd_rn(y, k.beta_t));
  return y > 0.f;
}

__device__ __forceinline__ float xhat_of(float a, const Chan& k) {
  return __fmul_rn(__fsub_rn(a, k.mean), k.rstd);
}

// K1a, pass 1: block (strip, channel tile) sums its strip's rows.
// Thread t owns channel vector blockIdx.y * tx_n + t % tx_n and rows
// t / tx_n, + ty_n, ... of the strip.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    reduce_strips_kernel(const T* __restrict__ dr, const T* __restrict__ a,
                         const float* __restrict__ mean,
                         const float* __restrict__ rstd,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         float* __restrict__ partial, int M, int C, int tx_n,
                         int rows_per_strip) {
  __shared__ float sh1[kThreads * kMaxVec];
  __shared__ float sh2[kThreads * kMaxVec];
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n;
  const int ty_n = kThreads / tx_n;
  const int c0 = (blockIdx.y * tx_n + tx) * VEC;
  const bool on = c0 < C;
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) s1[v] = s2[v] = 0.f;
  if (on) {
    Chan k[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      k[v] = load_chan<T>(mean, rstd, gamma, beta, c0 + v);
    const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_strip;
    const int64_t r1 = min(static_cast<int64_t>(M), r0 + rows_per_strip);
#pragma unroll 4
    for (int64_t r = r0 + ty; r < r1; r += ty_n) {
      float av[VEC], dv[VEC];
      load_vec<T, VEC>(a + r * C + c0, av);
      load_vec<T, VEC>(dr + r * C + c0, dv);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        if (live<T>(av[v], k[v])) {
          s1[v] += dv[v];
          s2[v] = fmaf(dv[v], xhat_of(av[v], k[v]), s2[v]);
        }
      }
    }
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    sh1[threadIdx.x * VEC + v] = s1[v];
    sh2[threadIdx.x * VEC + v] = s2[v];
  }
  __syncthreads();
  if (ty == 0 && on) {
    float* out = partial + static_cast<int64_t>(blockIdx.x) * 2 * C;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float t1 = 0.f, t2 = 0.f;
      for (int j = 0; j < ty_n; ++j) {  // fixed order
        t1 += sh1[(j * tx_n + tx) * VEC + v];
        t2 += sh2[(j * tx_n + tx) * VEC + v];
      }
      out[c0 + v] = t1;
      out[C + c0 + v] = t2;
    }
  }
}

// K1a, pass 2: s1, s2 = the strips' partials summed in a fixed order.  A
// block takes 32 channels (one per lane, so loads coalesce along C); warp w
// sums strips w, w + 8, ... in order, then lane c of warp 0 adds the eight
// warp sums in warp order.
__global__ void __launch_bounds__(kThreads)
    reduce_final_kernel(const float* __restrict__ partial,
                        float* __restrict__ s1, float* __restrict__ s2,
                        int C, int n_strips) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float sh1[kThreads];
  __shared__ float sh2[kThreads];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  float t1 = 0.f, t2 = 0.f;
  if (c < C) {
#pragma unroll 4
    for (int s = w; s < n_strips; s += kWarps) {
      t1 += partial[static_cast<int64_t>(2 * s) * C + c];
      t2 += partial[static_cast<int64_t>(2 * s + 1) * C + c];
    }
  }
  sh1[threadIdx.x] = t1;
  sh2[threadIdx.x] = t2;
  __syncthreads();
  if (w == 0 && c < C) {
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      a1 += sh1[j * 32 + lane];
      a2 += sh2[j * 32 + lane];
    }
    s1[c] = a1;
    s2[c] = a2;
  }
}

// K1b: da for every row, grid-stride over rows, same channel tiling.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    apply_kernel(const T* __restrict__ dr, const T* __restrict__ a,
                 const float* __restrict__ mean,
                 const float* __restrict__ rstd,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta,
                 const float* __restrict__ s1, const float* __restrict__ s2,
                 T* __restrict__ da, int M, int C, int tx_n, float inv_n) {
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n;
  const int ty_n = kThreads / tx_n;
  const int c0 = (blockIdx.y * tx_n + tx) * VEC;
  if (c0 >= C) return;
  Chan k[VEC];
  float coef[VEC], t1[VEC], t2[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const int c = c0 + v;
    k[v] = load_chan<T>(mean, rstd, gamma, beta, c);
    coef[v] = __fmul_rn(gamma[c], rstd[c]);
    t1[v] = s1[c];
    t2[v] = s2[c];
  }
  const int64_t step = static_cast<int64_t>(gridDim.x) * ty_n;
#pragma unroll 4
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * ty_n + ty; r < M;
       r += step) {
    float av[VEC], dv[VEC], out[VEC];
    load_vec<T, VEC>(a + r * C + c0, av);
    load_vec<T, VEC>(dr + r * C + c0, dv);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const float dy = live<T>(av[v], k[v]) ? dv[v] : 0.f;
      const float xh = xhat_of(av[v], k[v]);
      const float t =
          __fmul_rn(__fadd_rn(t1[v], __fmul_rn(xh, t2[v])), inv_n);
      out[v] = __fmul_rn(coef[v], __fsub_rn(dy, t));
    }
    store_vec<T, VEC>(da + r * C + c0, out);
  }
}

// Channel-vector lanes per block: a power of two up to a warp.
int lanes(int cv) {
  int tx = 1;
  while (tx < cv && tx < 32) tx *= 2;
  return tx;
}

constexpr int kErrBadArgs = static_cast<int>(cudaErrorInvalidValue);

template <typename T, int VEC>
int reduce_launch(const void* dr, const void* a, const float* mean,
                  const float* rstd, const float* gamma, const float* beta,
                  float* partial, float* s1, float* s2, int M, int C,
                  int n_strips, cudaStream_t stream) {
  const int cv = C / VEC, tx = lanes(cv);
  const dim3 grid(n_strips, (cv + tx - 1) / tx);
  if (grid.y > 65535) return kErrBadArgs;
  const int rows = (M + n_strips - 1) / n_strips;
  reduce_strips_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dr), static_cast<const T*>(a), mean, rstd, gamma,
      beta, partial, M, C, tx, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_final_kernel<<<(C + 31) / 32, kThreads, 0, stream>>>(
      partial, s1, s2, C, n_strips);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int apply_launch(const void* dr, const void* a, const float* mean,
                 const float* rstd, const float* gamma, const float* beta,
                 const float* s1, const float* s2, void* da, int M, int C,
                 float inv_n, cudaStream_t stream) {
  const int cv = C / VEC, tx = lanes(cv), ty = kThreads / tx;
  const int gy = (cv + tx - 1) / tx;
  if (gy > 65535) return kErrBadArgs;
  // enough blocks to fill the card several times over, each thread walking
  // a few rows
  const int64_t want = (static_cast<int64_t>(M) + ty - 1) / ty;
  const int gx = static_cast<int>(
      want < 2112 / gy ? want : (2112 / gy > 0 ? 2112 / gy : 1));
  apply_kernel<T, VEC><<<dim3(gx, gy), kThreads, 0, stream>>>(
      static_cast<const T*>(dr), static_cast<const T*>(a), mean, rstd, gamma,
      beta, s1, s2, static_cast<T*>(da), M, C, tx, inv_n);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// K1a over (M, C) rows: dtype 0 = float32, 1 = bf16; vec = channels per
// load (16 / itemsize, needing C % vec == 0 and 16-byte aligned rows, or
// 1); partial is float32 scratch (n_strips, 2, C); s1, s2 float32 (C,).
// Returns 0 or a CUDA error code (cudaErrorInvalidValue for arguments the
// kernel does not take).
extern "C" int bn_relu_bwd_reduce_launch(
    int dtype, int vec, const void* dr, const void* a, const void* mean,
    const void* rstd, const void* gamma, const void* beta, void* partial,
    void* s1, void* s2, int M, int C, int n_strips, void* stream) {
  if (M < 1 || C < 1 || n_strips < 1 || n_strips > M || vec < 1 ||
      C % vec)
    return kErrBadArgs;
  const auto* mu = static_cast<const float*>(mean);
  const auto* rs = static_cast<const float*>(rstd);
  const auto* g = static_cast<const float*>(gamma);
  const auto* b = static_cast<const float*>(beta);
  auto* p = static_cast<float*>(partial);
  auto* o1 = static_cast<float*>(s1);
  auto* o2 = static_cast<float*>(s2);
  auto st = static_cast<cudaStream_t>(stream);
  const bool wide = aligned(dr) && aligned(a);
  if (dtype == 0) {
    if (vec == 4 && wide)
      return reduce_launch<float, 4>(dr, a, mu, rs, g, b, p, o1, o2, M, C,
                                     n_strips, st);
    if (vec == 1)
      return reduce_launch<float, 1>(dr, a, mu, rs, g, b, p, o1, o2, M, C,
                                     n_strips, st);
  } else if (dtype == 1) {
    if (vec == 8 && wide)
      return reduce_launch<__nv_bfloat16, 8>(dr, a, mu, rs, g, b, p, o1, o2,
                                             M, C, n_strips, st);
    if (vec == 1)
      return reduce_launch<__nv_bfloat16, 1>(dr, a, mu, rs, g, b, p, o1, o2,
                                             M, C, n_strips, st);
  }
  return kErrBadArgs;
}

// K1b over (M, C) rows: da in the compute dtype; inv_n = float32(1 / M).
// Returns as bn_relu_bwd_reduce_launch does.
extern "C" int bn_relu_bwd_apply_launch(
    int dtype, int vec, const void* dr, const void* a, const void* mean,
    const void* rstd, const void* gamma, const void* beta, const void* s1,
    const void* s2, void* da, int M, int C, float inv_n, void* stream) {
  if (M < 1 || C < 1 || vec < 1 || C % vec) return kErrBadArgs;
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

extern "C" const char* fused_bn_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
