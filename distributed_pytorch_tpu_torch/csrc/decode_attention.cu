// Single-token decode attention over a contiguous KV cache or a paged KV
// pool, for Hopper (sm_90a).  Built by ops/_build.py with nvcc into a shared
// library with a plain C interface and called through ctypes from
// ops/attention.py (decode_attention, decode_attention_paged).
//
// Replaces the JAX package's Pallas TPU kernels
//   K6  distributed_pytorch_tpu/ops/attention.py:507  _decode_kernel
//   K7  distributed_pytorch_tpu/ops/attention.py:515  _decode_kernel_q
//   K8  distributed_pytorch_tpu/ops/attention.py:684  _decode_kernel_paged
//   K9  distributed_pytorch_tpu/ops/attention.py:696  _decode_kernel_paged_q
// (all four bodies are _decode_kernel_body): one kernel here, templated on
// the cache type (float / bf16, or int8 with per-row float32 scales) and on
// where a tile's rows come from (kPaged).
//
// What it computes, per sequence b and query head h (kv head h / g):
//   s_j = (q . k_j) * sm_scale in float32, for slots j <= pos[b], else
//   NEG_INF; online-softmax max m and sum l; p cast to the value dtype
//   (q's dtype) before the P.V product; float32 accumulator;
//   out = acc / max(l, 1e-30), cast to q's dtype.
// Under int8 each K/V row dequantizes as (int8 -> f32) * row_scale, cast to
// q's dtype, inside the tile: no dense dequantized cache is ever built.
//
// Paged (K8/K9): the cache is a pool (P, Hkv, page, D) shared by all
// sequences, and sequence b's logical slots [j*page, (j+1)*page) live in
// pool page table[b, j].  The page size must be a multiple of the 32-key
// tile (the wrapper raises otherwise), so a tile never straddles two pages:
// tile t reads pool page table[b, t*32 / page] from row (t*32) % page on,
// and its rows stay contiguous, 16-byte loads coalesced as in the dense
// case.  The loop visits only live tiles, so no table entry past
// pos[b] / page and no pool row past pos[b] is ever read (entries past a
// sequence's live pages may be garbage).  The int8 scales of a row sit at
// the same (page, head, row) index of their (P, Hkv, page, 1) pools.  Only
// the address of a tile differs from the dense instance: the arithmetic,
// and its order, is the same, so K8 over a shuffled pool is bitwise equal
// to K6 over the same rows laid out contiguously, and K9 to K7.
//
// What bounds it: bytes.  One decode step reads each live cache row once
// per kv head (sum_b (pos_b + 1) * Hkv * D * 2 * itemsize, plus 8 B per row
// for the int8 scales, plus one int32 table entry per tile when paged) and
// does ~4 * g flops per byte of bf16 cache, far below the card's ~295
// flops/byte balance point.  So the design reads as little as it can:
//   - grid (B, Hkv), one block per (sequence, kv head); the g query heads
//     that share a kv head are rows of one tile, so every cache line is read
//     once per kv head, not once per query head (the GQA fold);
//   - the block loops only over tiles holding live slots,
//     ceil((pos[b] + 1) / 32) of them, and loads no row past pos[b]: dead
//     rows are neither read nor computed (what the Pallas clamped index map
//     did at block granularity);
//   - K/V tiles are staged in shared memory with 16-byte loads, every load
//     of a tile issued before any is consumed.
// Known limit: B * Hkv blocks (64 at 8 slots x 8 heads) occupy about half
// of the 132 SMs, and each block loads, then computes, with no overlap
// between the two.  Splitting along the sequence (flash-decoding), a
// multi-stage cp.async / TMA pipeline and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 32;          // keys per tile: one key per lane
constexpr int kThreads = 128;      // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;          // query heads per kv head
constexpr float kNegInf = -1e30f;  // finite, as NEG_INF in ops/attention.py

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round a float32 value to QT and back: the cast to the compute dtype.
template <typename QT>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<QT>(x));
}

// Unpack one 16-byte chunk of cache values into floats in shared memory.
// int8 values dequantize with the row's scale and round to QT.
template <typename QT, typename CT>
__device__ __forceinline__ void unpack(const uint4& raw, float* dst,
                                       float scale) {
  if constexpr (std::is_same<CT, float>::value) {
    const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[e] = f[e];
  } else if constexpr (std::is_same<CT, __nv_bfloat16>::value) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float2 f = __bfloat1622float2(h[e]);
      dst[2 * e] = f.x;
      dst[2 * e + 1] = f.y;
    }
  } else {
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int e = 0; e < 16; ++e)
      dst[e] = round_to<QT>(static_cast<float>(c[e]) * scale);
  }
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

// Kernel arguments.  Dense: k/v (B, Hkv, S, D), ks/vs (B, Hkv, S, 1),
// table null.  Paged: k/v (P, Hkv, page, D), ks/vs (P, Hkv, page, 1), table
// (B, n_pages) int32, and S = page * n_pages, the logical cache length.
struct Args {
  const void *q, *k, *v, *ks, *vs, *pos, *table;
  void* out;
  int B, H, Hkv, S, page, n_pages;
  float sm_scale;
};

template <typename QT, typename CT, int D, bool kPaged>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const QT* __restrict__ q, const CT* __restrict__ k,
              const CT* __restrict__ v, const float* __restrict__ ks,
              const float* __restrict__ vs, const int* __restrict__ pos,
              const int* __restrict__ table, QT* __restrict__ out, int H,
              int Hkv, int S, int page, int n_pages, float sm_scale) {
  constexpr bool kQuant = std::is_same<CT, int8_t>::value;
  constexpr int kEpc = 16 / sizeof(CT);            // elements per chunk
  constexpr int kCpr = D / kEpc;                   // chunks per row
  constexpr int kChunks = kTile * kCpr / kThreads;  // chunks per thread
  static_assert(kTile * kCpr % kThreads == 0, "tile must split evenly");
  constexpr int kTpc = kThreads / D;               // threads per P.V column
  constexpr int kRowsPv = kMaxG / kTpc;            // P.V rows per thread
  constexpr int kRowsS = kMaxG / kWarps;           // score rows per warp

  __shared__ float q_s[kMaxG][D];
  __shared__ float k_s[kTile][D + 1];  // +1: conflict-free column reads
  __shared__ float v_s[kTile][D];
  __shared__ float p_s[kMaxG][kTile];
  __shared__ float alpha_s[kMaxG];
  __shared__ float l_s[kMaxG];

  const int b = blockIdx.x, kvh = blockIdx.y;
  const int g = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int last = min(pos[b], S - 1);  // inclusive read bound
  const int ntiles = last >= 0 ? last / kTile + 1 : 0;

  const size_t head = static_cast<size_t>(b) * Hkv + kvh;
  const QT* qb = q + (static_cast<size_t>(b) * H + kvh * g) * D;

  for (int i = tid; i < g * D; i += kThreads) q_s[i / D][i % D] = to_float(qb[i]);

  float m_run[kRowsS], l_run[kRowsS];
#pragma unroll
  for (int i = 0; i < kRowsS; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
  }
  const int col = tid % D, row0 = tid / D;
  float acc[kRowsPv];
#pragma unroll
  for (int i = 0; i < kRowsPv; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int t = 0; t < ntiles; ++t) {
    const int base = t * kTile;
    // the tile's first row in the cache, or in its pool page: the only
    // place the two instances differ.  base <= last, so the table column
    // base / page never passes pos[b] / page.
    size_t tile_row;
    if constexpr (kPaged) {
      const int pid = table[static_cast<size_t>(b) * n_pages + base / page];
      tile_row = (static_cast<size_t>(pid) * Hkv + kvh) * page + base % page;
    } else {
      tile_row = head * S + base;
    }
    const CT* kt = k + tile_row * D;
    const CT* vt = v + tile_row * D;
    // every 16-byte load of the tile in flight before any is consumed
    uint4 kr[kChunks], vr[kChunks];
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = tid + i * kThreads;
      const int slot = base + c / kCpr;
      const int off = (c / kCpr) * D + (c % kCpr) * kEpc;
      if (slot <= last) {
        kr[i] = *reinterpret_cast<const uint4*>(kt + off);
        vr[i] = *reinterpret_cast<const uint4*>(vt + off);
      } else {
        kr[i] = make_uint4(0u, 0u, 0u, 0u);
        vr[i] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / kCpr, e0 = (c % kCpr) * kEpc;
      const int slot = base + r;
      float ksc = 1.f, vsc = 1.f;
      if (kQuant && slot <= last) {
        ksc = ks[tile_row + r];
        vsc = vs[tile_row + r];
      }
      unpack<QT, CT>(kr[i], &k_s[r][e0], ksc);
      unpack<QT, CT>(vr[i], &v_s[r][e0], vsc);
    }
    __syncthreads();

    // scores and the online-softmax update: warp w owns rows w, w+4, ...;
    // lane j owns key base + j
#pragma unroll
    for (int i = 0; i < kRowsS; ++i) {
      const int r = warp + i * kWarps;
      if (r < g) {
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) s += q_s[r][d] * k_s[lane][d];
        s *= sm_scale;
        if (base + lane > last) s = kNegInf;
        const float m_new = fmaxf(m_run[i], warp_max(s));
        const float alpha = expf(m_run[i] - m_new);
        const float p = expf(s - m_new);
        l_run[i] = alpha * l_run[i] + warp_sum(p);
        m_run[i] = m_new;
        p_s[r][lane] = round_to<QT>(p);  // p in the value dtype
        if (lane == 0) alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // P.V: thread owns column col of rows row0, row0 + kTpc, ...
#pragma unroll
    for (int i = 0; i < kRowsPv; ++i) {
      const int r = row0 + i * kTpc;
      if (r < g) {
        float a = acc[i] * alpha_s[r];
#pragma unroll 8
        for (int j = 0; j < kTile; ++j) a += p_s[r][j] * v_s[j][col];
        acc[i] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRowsS; ++i) {
    const int r = warp + i * kWarps;
    if (r < g && lane == 0) l_s[r] = l_run[i];
  }
  __syncthreads();
  QT* ob = out + (static_cast<size_t>(b) * H + kvh * g) * D;
#pragma unroll
  for (int i = 0; i < kRowsPv; ++i) {
    const int r = row0 + i * kTpc;
    if (r < g) ob[r * D + col] = from_float<QT>(acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename QT, typename CT, int D, bool kPaged>
void launch(const Args& a, cudaStream_t stream) {
  dim3 grid(a.B, a.Hkv);
  decode_kernel<QT, CT, D, kPaged><<<grid, kThreads, 0, stream>>>(
      static_cast<const QT*>(a.q), static_cast<const CT*>(a.k),
      static_cast<const CT*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.pos),
      static_cast<const int*>(a.table), static_cast<QT*>(a.out), a.H, a.Hkv,
      a.S, a.page, a.n_pages, a.sm_scale);
}

template <typename QT, typename CT, bool kPaged>
bool launch_d(int D, const Args& a, cudaStream_t stream) {
  if (D == 64) {
    launch<QT, CT, 64, kPaged>(a, stream);
  } else if (D == 128) {
    launch<QT, CT, 128, kPaged>(a, stream);
  } else {
    return false;
  }
  return true;
}

// qtype: 0 float32, 1 bfloat16.  ctype: 0 float32, 1 bfloat16, 2 int8
// (then ks/vs are the float32 row scales).  The cache type must equal the
// query type unless it is int8.
template <bool kPaged>
int dispatch(int qtype, int ctype, int D, const Args& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.B < 1 || a.Hkv < 1 || a.H % a.Hkv || a.H / a.Hkv > kMaxG || a.S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  bool ok = false;
  if (qtype == 0 && ctype == 0)
    ok = launch_d<float, float, kPaged>(D, a, st);
  else if (qtype == 1 && ctype == 1)
    ok = launch_d<__nv_bfloat16, __nv_bfloat16, kPaged>(D, a, st);
  else if (qtype == 0 && ctype == 2)
    ok = launch_d<float, int8_t, kPaged>(D, a, st);
  else if (qtype == 1 && ctype == 2)
    ok = launch_d<__nv_bfloat16, int8_t, kPaged>(D, a, st);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dense decode over (B, Hkv, S, D) caches.  Returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for an
// unsupported combination.
extern "C" int decode_attention_launch(int qtype, int ctype, int D,
                                       const void* q, const void* k,
                                       const void* v, const void* ks,
                                       const void* vs, const void* pos,
                                       void* out, int B, int H, int Hkv,
                                       int S, float sm_scale, void* stream) {
  const Args a{q, k, v, ks, vs, pos, nullptr, out, B, H, Hkv, S, 0, 0,
               sm_scale};
  return dispatch<false>(qtype, ctype, D, a, stream);
}

// Paged decode over (P, Hkv, page, D) pools through the (B, n_pages) int32
// block table.  The page must be a positive multiple of the 32-key tile.
// Returns as decode_attention_launch does.
extern "C" int decode_attention_paged_launch(
    int qtype, int ctype, int D, const void* q, const void* k, const void* v,
    const void* ks, const void* vs, const void* pos, const void* table,
    void* out, int B, int H, int Hkv, int page, int n_pages, float sm_scale,
    void* stream) {
  if (page < kTile || page % kTile || n_pages < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, ks, vs, pos, table, out, B, H, Hkv, page * n_pages,
               page, n_pages, sm_scale};
  return dispatch<true>(qtype, ctype, D, a, stream);
}

extern "C" const char* decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
