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
// as float32 (m, n): the exact int32 sum, converted round-to-nearest
// (__int2float_rn) and multiplied in the JAX association acc * (sx * sw),
// so the output is bitwise the plain version's (ops/quantized.py
// int8_matmul_plain) and the JAX kernel's on the same quantized operands.
//
// What bounds it on the card: at the transformer's shapes (m = 8192 tokens,
// k, n in {1024, 4096}) the 1024-wide projections are bound by bytes (the
// float32 output, 4 m n, is the largest term) and the 4096-deep one by
// operations (2 m n k over 1,979 int8 TOP/s).  The design is the simple
// tensor-core GEMM, one output tile per block:
//   - a 128 x 128 output tile per block of 256 threads (8 warps, 2 x 4),
//     each warp 64 x 32 of it as 4 x 4 mma.sync.m16n8k32 s8 tiles; the
//     int32 accumulators stay in registers over the whole k loop (the
//     TPU kernel's VMEM accumulator carried across grid steps has no
//     counterpart: the k loop is inside the block);
//   - k tiles of 64 bytes double-buffered in shared memory, filled with
//     16-byte cp.async where k and the pointers allow (zero-filled past the
//     edges), byte by byte otherwise; rows padded to 80 bytes so the eight
//     rows one fragment load touches fall in distinct banks;
//   - both operands k-contiguous, so every fragment register is one aligned
//     32-bit shared load (the .row.col layout of m16n8k32);
//   - edge tiles bounds-checked, the k tail zero-padded (zeros add nothing
//     to an integer sum): any m, n, k is taken, none routes elsewhere.
// Known limits: mma.sync, not wgmma; no TMA, a two-stage pipeline, and the
// float32 output written from registers without staging through shared
// memory.  Faster versions are later work (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;  // tile: rows, cols, k bytes
constexpr int kStride = kBK + 16;              // padded shared row, bytes
constexpr int kThreads = 256;
constexpr int kErrBadArgs = 1;  // cudaErrorInvalidValue

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
  for (int i = 0; i < (kBM * kBK / 16) / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = c / (kBK / 16), col = (c % (kBK / 16)) * 16;
    int8_t* dst = smem + row * kStride + col;
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

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_kernel(const int8_t* __restrict__ qx,
                       const int8_t* __restrict__ qwt,
                       const float* __restrict__ sx,
                       const float* __restrict__ sw, float* __restrict__ out,
                       int M, int N, int K) {
  __shared__ __align__(16) int8_t As[2][kBM * kStride];
  __shared__ __align__(16) int8_t Bs[2][kBN * kStride];

  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
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

  const int n_k = (K + kBK - 1) / kBK;
  load_tile<kVec>(As[0], qx, M, K, m0, 0);
  load_tile<kVec>(Bs[0], qwt, N, K, n0, 0);
  cp_async_commit();

  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_k) {
      load_tile<kVec>(As[buf ^ 1], qx, M, K, m0, (kt + 1) * kBK);
      load_tile<kVec>(Bs[buf ^ 1], qwt, N, K, n0, (kt + 1) * kBK);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile kt has landed (tile kt + 1 may be in flight)
    __syncthreads();

    const int8_t* a = As[buf];
    const int8_t* b = Bs[buf];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = a + (wm + i * 16 + gid) * kStride + ks + tig * 4;
        af[i][0] = lds32(p);
        af[i][1] = lds32(p + 8 * kStride);
        af[i][2] = lds32(p + 16);
        af[i][3] = lds32(p + 8 * kStride + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = b + (wn + j * 8 + gid) * kStride + ks + tig * 4;
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

  // epilogue: out = float(acc) * (sx[row] * sw[col]), exactly that order
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + i * 16 + gid + h * 8;
      if (row >= M) continue;
      const float srow = sx[row];
      float* orow = out + static_cast<int64_t>(row) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + j * 8 + tig * 2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e < N) {
            orow[col + e] = __fmul_rn(__int2float_rn(acc[i][j][h * 2 + e]),
                                      __fmul_rn(srow, sw[col + e]));
          }
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// K5: out (M, N) float32 = (qx (M, K) int8 . qwt (N, K) int8^T) * (sx sw^T).
// Returns 0 or a CUDA error code (cudaErrorInvalidValue for arguments the
// kernel does not take).
extern "C" int int8_matmul_launch(const void* qx, const void* qwt,
                                  const void* sx, const void* sw, void* out,
                                  int M, int N, int K, void* stream) {
  if (M < 1 || N < 1 || K < 1 || K > 133000) return kErrBadArgs;
  const int64_t gy = (static_cast<int64_t>(M) + kBM - 1) / kBM;
  const int64_t gx = (static_cast<int64_t>(N) + kBN - 1) / kBN;
  if (gy > 65535 || gx > 2147483647LL) return kErrBadArgs;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  auto st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const int8_t*>(qx);
  const auto* b = static_cast<const int8_t*>(qwt);
  const auto* s1 = static_cast<const float*>(sx);
  const auto* s2 = static_cast<const float*>(sw);
  auto* o = static_cast<float*>(out);
  if (K % 16 == 0 && aligned16(qx) && aligned16(qwt)) {
    int8_matmul_kernel<true><<<grid, kThreads, 0, st>>>(a, b, s1, s2, o, M,
                                                        N, K);
  } else {
    int8_matmul_kernel<false><<<grid, kThreads, 0, st>>>(a, b, s1, s2, o, M,
                                                         N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_matmul_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
