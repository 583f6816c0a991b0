// Hopper (sm_90a) building blocks in raw PTX: mbarriers, TMA tensor loads
// and stores, wgmma shared-memory descriptors and the bf16 and s8 wgmma
// products, register hand-over between warpgroups; on the host, the TMA
// tensor-map encoder and the persistent kernels' grid.  Header-only;
// included by the kernels under csrc/ that stream tiles through a TMA /
// mbarrier ring into wgmma (flash_attention.cu's bf16 forward and backward,
// int8_matmul.cu's sm90 route).
//
// Conventions every user of this header keeps:
// - Tiles are stored the way TMA writes them with CU_TENSOR_MAP_SWIZZLE_128B:
//   rows of 128 bytes (64 bf16), 16-byte chunk c of row r at chunk
//   c ^ (r % 8), in 1024-byte atoms of 8 rows.  A tile wider than 64 bf16
//   is a sequence of such 64-column panels.  Every tile starts on a
//   1024-byte boundary, so the descriptors' base offset is 0.
// - wgmma descriptors name the same 128-byte swizzle (layout type 1):
//   K-major (the reduction dimension contiguous, as q and k are stored):
//     SBO = 1024 bytes (next 8 rows); LBO unused; the k-th 16-wide step of
//     a panel starts 32 k bytes into it (the hardware applies the swizzle
//     to the address it forms).
//   An s8 k32 step is 32 bytes too, so int8 operands step exactly as bf16
//   ones do (int8 wgmma takes K-major operands only).
//   MN-major (the output dimension contiguous, as v is stored for P.V):
//     SBO = 1024 bytes (next 8 rows of the reduction dimension), LBO = the
//     bytes from one 64-column panel to the next; the k-th 16-row step
//     starts 16 k rows (2048 k bytes) in.
// - Accumulator fragment of wgmma.m64nNk16 (f32): warp w of the warpgroup
//   owns rows 16w..16w+15; lane l holds d[4j + e] at row 16w + l/4 + 8(e/2),
//   column 8j + 2(l%4) + e%2 (the s32 accumulator of the s8 products has
//   the same layout).  A register A fragment (bf16) for one k16
//   step is 4 x b32 = (row l/4, cols 2(l%4)+{0,1}), (row l/4+8, same),
//   (row l/4, +8), (row l/4+8, +8): the accumulator's layout, so a
//   product's f32 result converts to the next product's A operand in place.

#pragma once

#include <cuda.h>  // CUtensorMap (a type only: nothing links against libcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the initialized barriers visible to the async proxy (TMA) and to
// the other threads; follow with a block-wide barrier.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also announces ``bytes`` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity ``parity`` has completed.  A fresh barrier
// is in phase 0: waiting on parity 1 passes at once (the phase before it
// counts as complete), waiting on parity 0 blocks until the first phase
// completes.  The k-th completion of a barrier ends the phase of parity
// k % 2.  A wait still unmet after ~2^34 cycles (seconds; a tile arrives in
// microseconds) traps: a lost transaction or a parity slip then fails the
// launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// --------------------------------------------------------------------- TMA

// Copy the box at coordinates (c0, c1, c2) (innermost first) of the tensor
// ``map`` describes into shared memory at ``dst``; completion is counted in
// bytes on ``bar``.  Elements outside the tensor arrive as zeros.  ``map``
// must live in parameter space (a __grid_constant__ kernel argument).
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// The 2-D form (a row-major matrix: c0 the column, c1 the row).
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The 1-D form: ``map`` describes a flat array (float32 row vectors).
__device__ __forceinline__ void tma_load_1d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

// Store the box at ``src`` to coordinates (c0, c1, c2); parts outside the
// tensor are not written.  Completion through the bulk-group functions.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The 2-D form (a row-major matrix: c0 the column, c1 the row).
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until every committed store has read its shared-memory source.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Wait until at most the newest ``kPending`` committed store groups still
// read their shared-memory sources.
template <int kPending>
__device__ __forceinline__ void tma_store_wait_read_until() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kPending)
               : "memory");
}

// Wait until every committed store has completed (its writes are done).
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Order this thread's generic shared-memory writes before later async-proxy
// (TMA, wgmma) reads of them.
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_v2_f32(uint32_t addr, float a,
                                                 float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(addr), "f"(a),
               "f"(b)
               : "memory");
}

// Barrier ``id`` (1..15; 0 is __syncthreads) over ``count`` threads.
__device__ __forceinline__ void named_barrier_sync(uint32_t id,
                                                   uint32_t count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------- register hand-over

template <uint32_t kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kRegs));
}

template <uint32_t kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kRegs));
}

// ------------------------------------------------------------------- wgmma

// Descriptor of a 128-byte-swizzled operand at shared address ``addr``
// (LBO and SBO in bytes, see the conventions above).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending)
               : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across a wgmma issue or wait (the hardware writes them asynchronously).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define SM90_F8(d, i)                                                  \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define SM90_F32(d, i) \
  SM90_F8(d, i), SM90_F8(d, (i) + 8), SM90_F8(d, (i) + 16), SM90_F8(d, (i) + 24)

#define SM90_R8(d, i)                                                  \
  "+r"(d[(i)]), "+r"(d[(i) + 1]), "+r"(d[(i) + 2]), "+r"(d[(i) + 3]), \
      "+r"(d[(i) + 4]), "+r"(d[(i) + 5]), "+r"(d[(i) + 6]), "+r"(d[(i) + 7])
#define SM90_R32(d, i) \
  SM90_R8(d, i), SM90_R8(d, (i) + 8), SM90_R8(d, (i) + 16), SM90_R8(d, (i) + 24)

#define SM90_OPS32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define SM90_OPS64                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

#define SM90_OPS128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, " \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, " \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, " \
  "%122, %123, %124, %125, %126, %127}"

// d (64 x 128, f32) = (scale_d ? d : 0) + A (64 x 16) . B (16 x 128), both
// bf16 operands in shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_OPS64
      ", %64, %65, p, 1, 1, 0, 0;\n\t}"
      : SM90_F32(d, 0), SM90_F32(d, 32)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, f32) = (scale_d ? d : 0) + A (64 x 16) . B (16 x 64), both
// bf16 operands in shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_OPS32
      ", %32, %33, p, 1, 1, 0, 0;\n\t}"
      : SM90_F32(d, 0)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x N, f32) += A (64 x 16, bf16 in registers: a[0..3], the fragment
// above) . B (16 x N, bf16 in shared memory, MN-major).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t* a,
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_OPS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n\t}"
      : SM90_F32(d, 0), SM90_F32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t* a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_OPS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : SM90_F32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 256, s32) = (scale_d ? d : 0) + A (64 x 32) . B (32 x 256), both
// s8 operands in shared memory, K-major; the exact integer sum (no
// .satfinite: the caller keeps |d| < 2^31).
__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %130, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " SM90_OPS128
      ", %128, %129, p;\n\t}"
      : SM90_R32(d, 0), SM90_R32(d, 32), SM90_R32(d, 64), SM90_R32(d, 96)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

#undef SM90_F8
#undef SM90_F32
#undef SM90_R8
#undef SM90_R32
#undef SM90_OPS32
#undef SM90_OPS64
#undef SM90_OPS128

// 2^x by the special-function unit alone (ex2.approx, 2 ulp); results
// below 2^-126 flush to 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as one bf16x2 register, ``lo`` in the low half (round to
// nearest even).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------- host side

// cuTensorMapEncodeTiled, a driver function, taken from the runtime so the
// library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
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

// The current device's SM count (0 if it cannot be read).
inline int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cached[dev]) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) ==
        cudaSuccess)
      cached[dev] = n;
  }
  return cached[dev];
}

// The persistent kernels' grid: one block per SM, at most one per work
// tile.  Also sets the kernel's dynamic shared memory.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, uint32_t smem, int n_work,
                            int* blocks) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  *blocks = std::min(n_work, sms);
  return cudaSuccess;
}

}  // namespace sm90
