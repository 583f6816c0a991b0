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
// the cache type (float / bf16, or int8 with per-row float32 scales), on
// the query heads a block holds (1, or a group of 4), and on where a
// tile's rows come from (kPaged).
//
// What it computes, per sequence b and query head h (kv head h / g):
//   s_j = (q . k_j) * sm_scale in float32, for slots j <= pos[b], else
//   NEG_INF; online-softmax max m and sum l; p cast to the value dtype
//   (q's dtype) before the P.V product; float32 accumulator;
//   out = acc / max(l, 1e-30), cast to q's dtype.
// Under int8 each K/V row dequantizes as (int8 -> f32) * row_scale, cast to
// q's dtype, element by element as it is read: no dense dequantized cache
// is ever built.
//
// Paged (K8/K9): the cache is a pool (P, Hkv, page, D) shared by all
// sequences, and sequence b's logical slots [j*page, (j+1)*page) live in
// pool page table[b, j].  The page size must be a multiple of the 32-key
// tile (the wrapper raises otherwise), so a tile never straddles two pages:
// tile t reads pool page table[b, t*32 / page] from row (t*32) % page on.
// Only tiles holding live slots are visited, so no table entry past
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
// flops/byte balance point.  So the design streams the live rows at the
// memory rate and reads nothing else:
//   - Split along the sequence (flash-decoding).  Sequence b's slots split
//     into splits of L slots, split i covering [i*L, (i+1)*L).  The wrapper
//     picks L, a multiple of the 32-key tile, from B * Hkv alone, and the
//     grid from the capacity (S, or page * n_pages): one block per
//     (sequence, unit, split) there could be, where a unit is a kv head
//     and its group of query heads.  The host never reads pos, so a launch
//     needs no sync and its grid is fixed for a CUDA graph.  Block i takes
//     the i-th LIVE work item in sequence-major order (warp 0 reads pos
//     and finds it by a prefix sum), so the live splits fill the first
//     blocks and spread evenly over the SMs whatever the depths; the
//     blocks past them exit at once.  Split boundaries are logical slots,
//     the same for dense and paged, and the result does not depend on the
//     number of splits (only live ones take part).
//   - The splits merge inside the same launch.  A live split writes its
//     (m, l, acc[g][D]) in float32 to the wrapper's workspace, fences, and
//     adds one to an arrival counter per (sequence, unit); the block that
//     arrives last merges the live splits in ascending order and resets
//     the counter to 0.  The fixed order keeps the output deterministic,
//     bitwise from run to run.  A sequence with one live split writes its
//     output directly.  Nothing is memset per call and no second kernel
//     runs.  The wrapper keeps a workspace and counters per device and
//     stream: launches on one stream run in turn, and launches on two
//     streams, which may overlap, never share them.
//   - Each of the 4 warps owns 8 consecutive keys of every 32-key tile and
//     streams them through its own ring of shared-memory stages with
//     16-byte cp.async.cg copies (4-byte ones for the int8 scales): 12 KB
//     a warp, 3-8 stages in flight, rows past pos zero-filled through the
//     src-size operand.  A warp waits only for its own copies, so the loop
//     has no block-wide barrier.  Tiles stay in their storage type in
//     shared memory and convert in registers as they are read: bf16 by a
//     shift, int8 by a byte permute into a float's mantissa, one multiply
//     by the row's scale, and one bf16x2 rounding for two values.
//   - All warps work at g = 1.  Lanes split a row along D (16-byte reads
//     of bf16 or int8 at g = 1), a butterfly of shuffles finishes each
//     dot product, and the lanes that read a key's K row read its V row,
//     so p never leaves the lane that computed it.  Each warp keeps its
//     own running max, sum and accumulator over its keys of the split (p
//     is rounded to the value dtype at the warp's running max); the four
//     merge in warp order at the end of the split.
//   - g > 1: a block holds a group of up to 4 query heads of one kv head;
//     g up to 4 reads each cache row once per kv head, larger g once per
//     group of 4.
// Known limit (scripts/decode_probe.py on an H100 SXM at 700 W, the
// LM-base serving shape): a launch costs ~4 us with nothing to read
// (launch, the pos scan, one block a unit), the in-launch merge ~2.4-3 us
// (a fence, an atomic, a read of the partials), and the rows stream at
// ~2.1-2.4 TB/s, not the 3.35 of the data sheet: with every block's
// compute removed, or with the copies made by TMA bulk copies instead,
// the bf16 time does not move.  The int8 instances add ~5-6 us of
// dequantizing on top of their streaming (per element a permute, an add,
// a multiply and half a rounding beside the product): tensor-core
// products on the bf16x2 values would remove the unpacking and the scalar
// products, at g = 1 computing 16 rows for one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kTile = 32;          // keys per tile: a page holds whole tiles
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpKeys = kTile / kWarps;  // each warp's rows of a tile
constexpr int kHeadGroup = 4;      // query heads per block when g > 1
constexpr int kMaxG = 16;          // query heads per kv head
constexpr int kRingBytes = 12288;  // each warp's ring of stages
constexpr float kNegInf = -1e30f;  // finite, as NEG_INF in ops/attention.py
constexpr int kMaxDevices = 64;    // cards a process may launch on

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

// The compile-time shape of one instance: CT the cache type, D the head
// dim, G the query heads a block holds.
template <typename CT, int D, int G>
struct Shape {
  static constexpr bool kQuant = std::is_same<CT, int8_t>::value;
  // elements each lane reads of a row: 16 bytes, or 8 for int8 with a
  // head group (its registers hold G x E accumulators)
  static constexpr int kE = (G == 1 || sizeof(CT) >= 2)
                                ? 16 / static_cast<int>(sizeof(CT)) : 8;
  static constexpr int kLpr = D / kE;      // lanes per row
  static constexpr int kRpw = 32 / kLpr;   // rows a warp reads at once
  static constexpr int kPasses = kWarpKeys / kRpw;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(CT));
  static constexpr int kKvBytes = kWarpKeys * kRowBytes;  // K or V rows
  static constexpr int kStage = 2 * kKvBytes + (kQuant ? 2 * kWarpKeys * 4
                                                       : 0);
  static constexpr int kStages = kRingBytes / kStage < 2 ? 2
                                 : kRingBytes / kStage > 8 ? 8
                                 : kRingBytes / kStage;
  static constexpr int kWarpSmem = kStages * kStage;
  static constexpr int kSmem = kWarps * kWarpSmem;
  static constexpr int kChunks = kKvBytes / 16 / 32;  // per lane per matrix
  static_assert(kLpr >= 4 && kLpr <= 32 && kPasses >= 1, "lane layout");
  static_assert(kChunks >= 1 && kKvBytes % (16 * 32) == 0, "copy layout");
  // the warp merge reuses the warp's ring: acc[G][D], then m[G], l[G]
  static_assert(kWarpSmem >= (G * D + 2 * G) * 4, "merge area");
};

// 16-byte global -> shared copy; src_bytes 0 fills the 16 bytes with zeros
// and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// E cache values from shared memory as floats; int8 dequantizes with the
// row's scale and rounds to QT, as the JAX kernel's tile does.
template <typename QT, typename CT, int E>
__device__ __forceinline__ void load_row(const char* src, float scale,
                                         float (&x)[E]) {
  if constexpr (std::is_same<CT, float>::value) {
    static_assert(E == 4, "float rows are read 16 bytes a lane");
    const float4 f = *reinterpret_cast<const float4*>(src);
    x[0] = f.x;
    x[1] = f.y;
    x[2] = f.z;
    x[3] = f.w;
  } else if constexpr (std::is_same<CT, __nv_bfloat16>::value) {
    static_assert(E == 8, "bf16 rows are read 16 bytes a lane");
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      x[2 * e] = f.x;
      x[2 * e + 1] = f.y;
    }
  } else {
    static_assert(E == 16 || E == 8, "int8 rows are read 16 or 8 bytes");
    using Raw = typename std::conditional<E == 16, uint4, uint2>::type;
    const Raw raw = *reinterpret_cast<const Raw*>(src);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
    for (int j = 0; j < E / 4; ++j) {
      const uint32_t u = w[j] ^ 0x80808080u;  // each byte + 128, unsigned
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // the float 2^23 + byte, less 2^23 + 128: the int8 value, exactly,
        // by a byte permute and an add instead of a conversion
        const float f =
            __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + e)) -
            8388736.f;
        x[4 * j + e] = f * scale;
      }
    }
    if constexpr (std::is_same<QT, __nv_bfloat16>::value) {
      // round to bf16 two values a conversion
#pragma unroll
      for (int e = 0; e < E; e += 2) {
        const float2 f =
            __bfloat1622float2(__floats2bfloat162_rn(x[e], x[e + 1]));
        x[e] = f.x;
        x[e + 1] = f.y;
      }
    }
  }
}

// Merge the partial states (m_i, l_i, acc_i) of one output element, i in
// ascending order: every partial rescaled to their common max.  ``at(i)``
// returns partial i as a float3 (m, l, acc); the result is (m, l, acc).
// The partials are read kChunk at a time, all of a chunk before any is
// used, so up to kChunk of them cost one round trip to memory; more are
// read twice, once for the max and once for the sums.
template <typename F>
__device__ __forceinline__ float3 merge_parts(int n, F at) {
  constexpr int kChunk = 8;
  float3 p[kChunk];
  auto read = [&](int i0) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (i0 + i < n) p[i] = at(i0 + i);
  };
  float m = kNegInf;
  for (int i0 = 0; i0 < n; i0 += kChunk) {
    read(i0);
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (i0 + i < n) m = fmaxf(m, p[i].x);
  }
  float l = 0.f, a = 0.f;
  for (int i0 = 0; i0 < n; i0 += kChunk) {
    if (n > kChunk) read(i0);  // else p still holds the only chunk
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i0 + i < n) {
        const float f = expf(p[i].x - m);
        l += f * p[i].y;
        a += f * p[i].z;
      }
    }
  }
  return make_float3(m, l, a);
}

template <typename QT, typename CT, int D, int G, bool kPaged>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const QT* __restrict__ q, const CT* __restrict__ k,
              const CT* __restrict__ v, const float* __restrict__ ks,
              const float* __restrict__ vs, const int* __restrict__ pos,
              const int* __restrict__ table, QT* __restrict__ out,
              float* __restrict__ ws, int* __restrict__ counters, int B,
              int H, int Hkv, int S, int page, int n_pages, int split_len,
              float sm_scale) {
  using Sh = Shape<CT, D, G>;
  constexpr int E = Sh::kE, kLpr = Sh::kLpr, kRpw = Sh::kRpw;
  constexpr int kPasses = Sh::kPasses, kStages = Sh::kStages;
  constexpr int kPart = G * (D + 2);  // one split's partials in ws
  extern __shared__ __align__(16) char smem[];

  const int g = H / Hkv;
  const int n_groups = (g + G - 1) / G;
  const int Y = Hkv * n_groups;                         // units a sequence
  const int n_splits = (S + split_len - 1) / split_len;  // the capacity's
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // Block i takes the i-th live work item (b, y, split), sequence-major:
  // the live splits fill the first blocks, so every SM gets an even share
  // of them whatever the depths, and the blocks past the live items exit
  // at once.  A sequence with nothing live (pos < 0) counts one item a
  // unit, which writes its zero output.  Warp 0 reads pos 32 sequences at
  // a time and finds the block's sequence by a prefix sum of their items.
  __shared__ int found[3];  // the block's sequence, its item, its bound
  if (warp == 0) {
    const int want = blockIdx.x;
    int base = 0, b0 = 0;
    for (; b0 < B; b0 += 32) {
      const int bb = b0 + lane;
      int items = 0, lst = -1;
      if (bb < B) {
        lst = min(pos[bb], S - 1);
        items = max(lst < 0 ? 0 : lst / split_len + 1, 1) * Y;
      }
      int incl = items;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      const bool mine = want >= base + incl - items && want < base + incl;
      const unsigned hit = __ballot_sync(0xffffffffu, mine);
      if (mine) {
        found[0] = bb;
        found[1] = want - (base + incl - items);
        found[2] = lst;
      }
      if (hit) break;
      base += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (b0 >= B && lane == 0) found[0] = B;
  }
  __syncthreads();
  const int b = found[0], item = found[1];
  if (b == B) return;  // past the live items
  const int last = found[2];  // inclusive read bound: min(pos[b], S - 1)
  const int n_live = last < 0 ? 0 : last / split_len + 1;
  const int y = item / max(n_live, 1), split = item % max(n_live, 1);
  const int kvh = y / n_groups, h0 = (y % n_groups) * G;
  const int start = split * split_len;
  const size_t unit = static_cast<size_t>(b) * Y + y;
  QT* ob = out + (static_cast<size_t>(b) * H + kvh * g + h0) * D;

  if (n_live == 0) {  // nothing live: the output is 0 / max(0, 1e-30)
    for (int j = tid; j < G * D; j += kThreads)
      if (h0 + j / D < g) ob[j] = from_float<QT>(0.f);
    return;
  }

  // this lane's place in a row: row group rg reads elements [c*E, c*E+E)
  const int rg = lane / kLpr, c = lane % kLpr;
  float qr[G][E];
  {
    const QT* qb = q + (static_cast<size_t>(b) * H + kvh * g + h0) * D + c * E;
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int e = 0; e < E; ++e)
        qr[gi][e] = h0 + gi < g ? to_float(qb[gi * D + e]) : 0.f;
  }

  // this warp's sub-tiles of the split: tile t's rows [w*8, w*8+8), live
  // when their first slot is
  const int tiles = split_len / kTile;
  const int first = start + warp * kWarpKeys;
  const int n_sub = first > last ? 0 : min(tiles, (last - first) / kTile + 1);
  const size_t head = static_cast<size_t>(b) * Hkv + kvh;
  char* ring = smem + warp * Sh::kWarpSmem;

  auto issue = [&](int t) {
    char* st = ring + (t % kStages) * Sh::kStage;
    const int base = start + t * kTile;  // the tile's first slot, <= last
    size_t row0;  // the warp's first row in the cache, or in its pool page
    if constexpr (kPaged) {
      const int pid = table[static_cast<size_t>(b) * n_pages + base / page];
      row0 = (static_cast<size_t>(pid) * Hkv + kvh) * page + base % page +
             warp * kWarpKeys;
    } else {
      row0 = head * S + base + warp * kWarpKeys;
    }
    const int sub = base + warp * kWarpKeys;  // its first slot, <= last
    const char* kg = reinterpret_cast<const char*>(k + row0 * D);
    const char* vg = reinterpret_cast<const char*>(v + row0 * D);
#pragma unroll
    for (int i = 0; i < Sh::kChunks; ++i) {
      const int ch = lane + 32 * i;
      const int r = ch / (Sh::kRowBytes / 16);
      const bool live = sub + r <= last;
      // a dead row reads nothing; its address stays on the live row 0
      const int off = live ? ch * 16 : (ch % (Sh::kRowBytes / 16)) * 16;
      cp_async16(st + ch * 16, kg + off, live ? 16 : 0);
      cp_async16(st + Sh::kKvBytes + ch * 16, vg + off, live ? 16 : 0);
    }
    if constexpr (Sh::kQuant) {
      if (lane < 2 * kWarpKeys) {
        const int r = lane % kWarpKeys;
        const bool live = sub + r <= last;
        const float* src = (lane < kWarpKeys ? ks : vs) + row0 + (live ? r : 0);
        cp_async4(st + 2 * Sh::kKvBytes + lane * 4, src, live ? 4 : 0);
      }
    }
  };

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[gi][e] = 0.f;
  }

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_sub) issue(t);
    cp_commit();
  }
  for (int t = 0; t < n_sub; ++t) {
    if (t + kStages - 1 < n_sub) issue(t + kStages - 1);
    cp_commit();
    cp_wait<kStages - 1>();  // sub-tile t's copies (this lane's) landed
    __syncwarp();            // ... and every lane's
    const char* st = ring + (t % kStages) * Sh::kStage;
    const float* kss = reinterpret_cast<const float*>(st + 2 * Sh::kKvBytes);
    const int sub = start + t * kTile + warp * kWarpKeys;

    // scores: row group rg holds key p*kRpw + rg of each pass p
    float s[kPasses][G];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int r = p * kRpw + rg;
      float x[E];
      load_row<QT, CT, E>(st + r * Sh::kRowBytes + c * E * sizeof(CT),
                          Sh::kQuant ? kss[r] : 1.f, x);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        // four interleaved partial sums: a chain of E / 4 products
        float dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int e = 0; e < E; ++e) dp[e % 4] = fmaf(qr[gi][e], x[e], dp[e % 4]);
        float d = (dp[0] + dp[1]) + (dp[2] + dp[3]);
#pragma unroll
        for (int o = kLpr / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        s[p][gi] = sub + r <= last ? d * sm_scale : kNegInf;
      }
    }
    // the warp's online-softmax update over its 8 keys
    float pr[kPasses][G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float mx = s[0][gi];
#pragma unroll
      for (int p = 1; p < kPasses; ++p) mx = fmaxf(mx, s[p][gi]);
#pragma unroll
      for (int o = kLpr; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[gi], mx);
      const float alpha = expf(m[gi] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const float e = expf(s[p][gi] - m_new);
        ps += e;
        pr[p][gi] = round_to<QT>(e);  // p in the value dtype
      }
#pragma unroll
      for (int o = kLpr; o < 32; o <<= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[gi] = alpha * l[gi] + ps;
      m[gi] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[gi][e] *= alpha;
    }
    // P.V over the same rows this lane scored
    const float* vss = kss + kWarpKeys;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int r = p * kRpw + rg;
      float x[E];
      load_row<QT, CT, E>(
          st + Sh::kKvBytes + r * Sh::kRowBytes + c * E * sizeof(CT),
          Sh::kQuant ? vss[r] : 1.f, x);
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[gi][e] = fmaf(pr[p][gi], x[e], acc[gi][e]);
    }
    __syncwarp();  // every lane is done with the stage before it refills
  }
  cp_wait<0>();

  // the warp's accumulator, summed over its row groups, into its ring
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int o = kLpr; o < 32; o <<= 1)
        acc[gi][e] += __shfl_xor_sync(0xffffffffu, acc[gi][e], o);
  __syncwarp();
  float* wacc = reinterpret_cast<float*>(ring);
  float* wml = wacc + G * D;
  if (rg == 0) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int e = 0; e < E; ++e) wacc[gi * D + c * E + e] = acc[gi][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      wml[gi] = m[gi];
      wml[G + gi] = l[gi];
    }
  }
  __syncthreads();

  // the split's state: the four warps merged in warp order, one output
  // element (gi, d) a thread
  float* part = ws + (unit * n_splits + split) * kPart;
  for (int i = tid; i < G * D; i += kThreads) {
    const int gi = i / D;
    const float3 mla = merge_parts(kWarps, [&](int w) {
      const float* wb =
          reinterpret_cast<const float*>(smem + w * Sh::kWarpSmem);
      return make_float3(wb[G * D + gi], wb[G * D + G + gi], wb[i]);
    });
    if (n_live == 1) {
      if (h0 + gi < g) ob[i] = from_float<QT>(mla.z / fmaxf(mla.y, 1e-30f));
    } else {
      part[i] = mla.z;
      if (i % D == 0) {
        part[G * D + gi] = mla.x;
        part[G * D + G + gi] = mla.y;
      }
    }
  }
  if (n_live == 1) return;

  // arrive; the last live split to arrive merges them all
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int before = atomicAdd(counters + unit, 1);
    is_last = before == n_live - 1;
    if (is_last) counters[unit] = 0;  // every live split has arrived
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* parts = ws + unit * n_splits * kPart;
  for (int i = tid; i < G * D; i += kThreads) {
    const int gi = i / D;
    if (h0 + gi >= g) continue;
    auto at = [&](int j) {
      const float* pj = parts + static_cast<size_t>(j) * kPart;
      return make_float3(__ldcg(pj + G * D + gi), __ldcg(pj + G * D + G + gi),
                         __ldcg(pj + i));
    };
    const float3 mla = merge_parts(n_live, at);
    ob[i] = from_float<QT>(mla.z / fmaxf(mla.y, 1e-30f));
  }
}

// Kernel arguments.  Dense: k/v (B, Hkv, S, D), ks/vs (B, Hkv, S, 1),
// table null.  Paged: k/v (P, Hkv, page, D), ks/vs (P, Hkv, page, 1), table
// (B, n_pages) int32, and S = page * n_pages, the logical cache length.
// ws holds B * Hkv * ceil(g / G) * n_splits * G * (D + 2) floats and
// counters B * Hkv * ceil(g / G) zeroed ints (G = 1 at g = 1, else 4).
struct Args {
  const void *q, *k, *v, *ks, *vs, *pos, *table;
  void *out, *ws, *counters;
  int B, H, Hkv, S, page, n_pages, split_len;
  float sm_scale;
};

template <typename QT, typename CT, int D, int G, bool kPaged>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = decode_kernel<QT, CT, D, G, kPaged>;
  constexpr int smem = Shape<CT, D, G>::kSmem;
  // the shared-memory limit is an attribute of the kernel on each card:
  // set it once per instance and card (the f32 D=128 instances need more
  // than the 48 KB default)
  static std::atomic<bool> set_on[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!set_on[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    set_on[dev].store(true, std::memory_order_release);
  }
  // one block per (sequence, unit, split) of the capacity: the most work
  // items there can be; those past the live ones exit at once
  const int g = a.H / a.Hkv;
  const int blocks = (a.S + a.split_len - 1) / a.split_len * a.Hkv *
                     ((g + G - 1) / G) * a.B;
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const QT*>(a.q), static_cast<const CT*>(a.k),
      static_cast<const CT*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.pos),
      static_cast<const int*>(a.table), static_cast<QT*>(a.out),
      static_cast<float*>(a.ws), static_cast<int*>(a.counters), a.B, a.H,
      a.Hkv, a.S, a.page, a.n_pages, a.split_len, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename CT, int D, bool kPaged>
int launch_g(const Args& a, cudaStream_t stream) {
  return a.H == a.Hkv ? launch<QT, CT, D, 1, kPaged>(a, stream)
                      : launch<QT, CT, D, kHeadGroup, kPaged>(a, stream);
}

template <typename QT, typename CT, bool kPaged>
int launch_d(int D, const Args& a, cudaStream_t stream) {
  if (D == 64) return launch_g<QT, CT, 64, kPaged>(a, stream);
  if (D == 128) return launch_g<QT, CT, 128, kPaged>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// qtype: 0 float32, 1 bfloat16.  ctype: 0 float32, 1 bfloat16, 2 int8
// (then ks/vs are the float32 row scales).  The cache type must equal the
// query type unless it is int8.
template <bool kPaged>
int dispatch(int qtype, int ctype, int D, const Args& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.B < 1 || a.Hkv < 1 || a.H % a.Hkv || a.H / a.Hkv > kMaxG ||
      a.S < 1 || a.split_len < kTile || a.split_len % kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  if (qtype == 0 && ctype == 0)
    return launch_d<float, float, kPaged>(D, a, st);
  if (qtype == 1 && ctype == 1)
    return launch_d<__nv_bfloat16, __nv_bfloat16, kPaged>(D, a, st);
  if (qtype == 0 && ctype == 2)
    return launch_d<float, int8_t, kPaged>(D, a, st);
  if (qtype == 1 && ctype == 2)
    return launch_d<__nv_bfloat16, int8_t, kPaged>(D, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename CT, int D>
int smem_g(int G) {
  return G == 1 ? Shape<CT, D, 1>::kSmem : Shape<CT, D, kHeadGroup>::kSmem;
}

template <typename CT>
int smem_d(int D, int G) {
  return D == 64 ? smem_g<CT, 64>(G) : D == 128 ? smem_g<CT, 128>(G) : -1;
}

}  // namespace

// Dense decode over (B, Hkv, S, D) caches in splits of split_len slots.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an unsupported combination.
extern "C" int decode_attention_launch(int qtype, int ctype, int D,
                                       const void* q, const void* k,
                                       const void* v, const void* ks,
                                       const void* vs, const void* pos,
                                       void* out, void* ws, void* counters,
                                       int B, int H, int Hkv, int S,
                                       int split_len, float sm_scale,
                                       void* stream) {
  const Args a{q,   k, v,   ks, vs, pos, nullptr, out, ws,        counters,
               B,   H, Hkv, S,  0,  0,   split_len, sm_scale};
  return dispatch<false>(qtype, ctype, D, a, stream);
}

// Paged decode over (P, Hkv, page, D) pools through the (B, n_pages) int32
// block table.  The page must be a positive multiple of the 32-key tile.
// Returns as decode_attention_launch does.
extern "C" int decode_attention_paged_launch(
    int qtype, int ctype, int D, const void* q, const void* k, const void* v,
    const void* ks, const void* vs, const void* pos, const void* table,
    void* out, void* ws, void* counters, int B, int H, int Hkv, int page,
    int n_pages, int split_len, float sm_scale, void* stream) {
  if (page < kTile || page % kTile || n_pages < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k,   v,   ks,           vs,   pos,     table,
               out, ws, counters, B, H, Hkv, page * n_pages, page,
               n_pages, split_len, sm_scale};
  return dispatch<true>(qtype, ctype, D, a, stream);
}

// Dynamic shared memory of the instance for cache type ctype (0 float32,
// 1 bfloat16, 2 int8), head dim D and G query heads a block (1 or 4), in
// bytes; -1 for a combination the kernel does not take.
extern "C" int decode_attention_smem(int ctype, int D, int G) {
  if (G != 1 && G != kHeadGroup) return -1;
  if (ctype == 0) return smem_d<float>(D, G);
  if (ctype == 1) return smem_d<__nv_bfloat16>(D, G);
  if (ctype == 2) return smem_d<int8_t>(D, G);
  return -1;
}

extern "C" const char* decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
