// Paged decode attention for Hopper (sm_90a): one query token per row over
// a paged KV pool (an attention kernel, then a small kernel that merges the
// split partials of long rows).
//
// Replaces the TPU kernel `_decode_kernel` of paddle_tpu/incubate/nn/
// pallas/paged_attention.py, reached there through `paged_attention`, over
// a bf16 or f32 pool (pa_launch). The same function over an int8 pool
// {"q8": int8 [n_kv, total_pages, page, d], "s": f32 [n_kv, total_pages,
// page]} (pa_q8_launch) is a route of the port: the JAX package sends
// int8 pools to its XLA composition `_xla_paged_attention`. Its key and
// value rows decode by the one rule of `_dequant`: value = float(q8) * s.
// Layouts and semantics are the JAX package's:
//
//   q            [n_rows, n_heads, d]            one query token per row
//   k/v pages    [n_kv, total_pages, page, d]
//   block_tables [n_rows, pages_per_seq] int32   page id per slot
//   context_lens [n_rows] int32                  keys the row attends
//   out          [n_rows, n_heads, d]            zeroed by the caller
//
// Row r attends to its keys 0 .. context_lens[r] - 1, cut at the
// block-table window (pages_per_seq * page). Rows with no key are never
// written, so they keep the caller's zeros. Block-table ids are clamped
// into the pool. GQA: the `group` = n_heads / n_kv query heads of one kv
// head share its pages. The serving engine's two-program layout calls it
// for every decode batch (one row a slot, each with its own table) and
// every prefill chunk (one row a chunk token, each with its own causal
// length over a copy of one block table).
//
// What bounds it: each row's K and V are read once, n_kv * 2 * len rows
// of 2 d bytes (bf16) or d + 4 bytes (int8 with its f32 scale), against
// 4 * d flops per (query head, key). A decode row does 1-4 flops per byte,
// two orders of magnitude below the ~295 flops/byte at which an H100's
// bf16 tensor cores would be the limit: the kernel is bound by the bytes
// of K/V it must read, and its design is about reading each of them once
// and keeping enough of them in flight on every SM.
//
// The design follows K4's (ragged_paged_attention.cu; copied, not shared):
// * Work items are (row, kv head, key split). The split size is chosen per
//   call from the shapes alone (a multiple of 64 keys, 128 to 2048): the
//   (row, kv head) pairs times the window's splits fill the SMs about four
//   times over, or, in a call of more than one tile of rows (a prefill
//   chunk), the (tile, kv head) pairs about once. A decode batch of 8 rows
//   x 16 kv heads over a 1072-key window walks 256-key splits; a 128-row
//   prefill chunk over 1024 keys walks 512-key splits at 16 kv heads, one
//   1024-key split at 32. A block takes one item, or in a call of more than
//   one tile of rows the items of one tile's rows (of one kv head and
//   split), one after another, so that it decides once whether they
//   share; an item past its row's length costs one load. A row whose keys
//   fit one split writes `out`; otherwise each split writes its partial
//   (m, l, acc) in f32 to the caller's workspace, and
//   paged_decode_merge_kernel combines them in split order with
//   `_decode_kernel`'s guarded -inf arithmetic (an empty split adds
//   nothing, a row that saw no key writes 0). Nothing is sized from device
//   values and nothing waits on the host, so a call can be captured in a
//   CUDA graph; the sums run in a fixed order, so two launches on the same
//   inputs give the same bits.
// * Rows that name the same pages share one read. A tile is 16 query
//   vectors: 16 consecutive rows at group 1, 16 / group at GQA. For each
//   (tile, split) the block reads the tile's lengths and compares, block
//   wide, every live row's page ids with those of the tile's longest row
//   over the pages that row itself sees in the split (garbage ids past a
//   row's length and rows of length 0 play no part). When at least two
//   rows are live and all match, the item of the tile's first row runs the
//   whole tile, each K/V chunk read once for all of its query vectors,
//   each row masked by its own length, and the tile's other rows return
//   at once; otherwise each row runs alone. The decision depends on the
//   inputs alone, so it is the same for every item of the tile. A prefill
//   chunk's 128 rows over one table read its prefix 8 times, not 128.
// * The feed: the block's page ids are read into shared memory first; each
//   of the 4 warps owns a ring of kStages = 3 chunks of 16 keys (8 for f32
//   queries) in shared memory, filled by cp.async, chunk c of the item
//   going to warp c % 4 (64 keys a block a round); lane r finds key r's
//   pool row and the lanes copy whole 16-byte pieces of consecutive key
//   rows. K/V stay in the pool's type there; an int8 row decodes q8 * s as
//   it is read from shared memory (template flag kQ8).
// * A bf16 tile of more than one query vector (a shared tile, a GQA row)
//   runs Q.K^T and P.V on the tensor cores: mma.sync m16n8k16 with f32
//   accumulators, P rounded to bf16 for P.V. One query vector (a decode
//   row at group 1), and every f32 query, runs on FFMA (exact f32) from
//   shared memory. Each warp keeps its own online softmax in registers
//   (scores scaled by scale * log2(e), exp2), and the block merges the
//   warps once, in warp order.
// What holds it back now (PERF.md, tools/decode_ab.py): at decode, per-item
// latency (page ids, the tile check, the ring's first chunks, the merges:
// without its products the kernel takes 70% of its time at GPT's decode
// batch); at prefill, decoding int8 codes to bf16 for the tensor cores
// (K6-q8's Llama prefill chunk takes 0.0252 of its 0.0553 ms without its
// products; decoding each chunk once into bf16 staging rows first was
// slower, 0.0777 against 0.0566 ms in one run: as many conversions, more
// shared-memory traffic, 2 blocks an SM instead of 3) and the prefix read
// once a tile.
// Not done yet (later work): sharing across tiles of a longer run of rows
// (a prefill chunk's 8 tiles still read its prefix 8 times, from L2), a
// plan of the live items made once rather than by every block, and int8
// tensor-core products.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxQ = 16;                  // query vectors per tile
constexpr int kQPerWarp = 4;               // FFMA: query vectors of a warp
constexpr int kStages = 3;                 // depth of each warp's ring
constexpr int kMinBlocks = 2;              // blocks an SM, head_dim <= 128
constexpr int kMinSplit = 128;             // keys of one work item: at least,
constexpr int kMaxSplit = 2048;            // at most, a multiple of 64
constexpr int kMaxIds = kMaxSplit / 8 + 2; // page ids of one split (page >= 8)
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// The shapes a kernel instance is built for. kD is a head_dim bucket (64,
// 128 or 256): register arrays and lane layouts are sized by it, and d is
// any multiple of 8 (16 over int8 pools) up to kD.
// * C: keys a ring stage holds: one m16n8k16 k-step of P.V (16) for bf16
//   queries, 8 for f32 queries (rows twice as wide); set by the query's
//   type alone, so an int8 pool under an f32 query chunks its keys as an
//   f32 pool does.
// * FFMA: kLpr lanes hold a key row, 8 dims each; kKg key groups a warp;
//   kKeys keys a lane scores in a chunk.
// * copies: kSegs 16-byte pieces a full row, kLpc lanes copy a row.
template <typename T, bool kQ8, int kD>
struct Cfg {
  using E = typename std::conditional<kQ8, int8_t, T>::type;
  static constexpr int C = sizeof(T) == 4 ? 8 : 16;
  static constexpr bool kMma = std::is_same<T, bf16>::value && kD <= 128;
  static constexpr int kLpr = kD / 8 > 32 / C ? kD / 8 : 32 / C;
  static constexpr int kKg = 32 / kLpr;
  static constexpr int kKeys = C / kKg;
  static constexpr int kSegs = kD * (int)sizeof(E) / 16;
  static constexpr int kLpc = kSegs < 32 ? kSegs : 32;
  static constexpr int kD_ = kD;
};

// a staged row: the pool row plus 16 bytes, so that 8 lanes reading 16
// bytes of 8 different rows (or ldmatrix's 8 row addresses) hit 8
// different bank groups
__host__ __device__ inline int pitch_of(int d, int elt) {
  return d * elt + 16;
}

// one warp's ring: kStages x {K rows, V rows} of C rows, then (int8 pools)
// kStages x {K scales, V scales} of C floats
__host__ __device__ inline int ring_bytes(int d, int elt, int C, bool q8) {
  return kStages * 2 * C * (pitch_of(d, elt) + (q8 ? 4 : 0));
}

// After the key loop, over the rings: each warp's partial of each query
// vector, acc [kWarps][kMaxQ][d + 4] (rows padded against bank conflicts),
// then m and l [kWarps][kMaxQ], f32.
__host__ __device__ inline int merge_bytes(int d) {
  return kWarps * kMaxQ * (d + 6) * 4;
}

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;
  const float* v_scales;
  const int* block_tables;
  const int* context_lens;
  void* out;
  float* ws;   // acc [n_rows * n_heads * n_splits][d], then m, then l
  int n_rows, n_heads, d, total_pages, page, pages_per_seq, group, n_kv;
  int split, n_splits;     // keys of a split, splits of the window
  int tile_rows;           // rows of a tile: 16 query vectors
  int run;                 // rows a block walks: 1, or a tile
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; src_bytes 0
// reads nothing and fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 as a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 8 consecutive values of a row as f32: of T, or int8 codes times the
// row's scale s (`_dequant`, in f32)
template <typename E>
__device__ __forceinline__ void load8(const void* p, float s, float (&v)[8]) {
  if constexpr (std::is_same<E, int8_t>::value) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = (float)x[u] * s;
  } else if constexpr (std::is_same<E, float>::value) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const bf16* x = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = __bfloat162float(x[u]);
  }
}

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// One unit of work: the query vectors of rows row0 .. row0 + nq / group
// - 1 (a whole tile, or one row).
struct Tile {
  int row0, nq;
};

// Where a warp's chunks live and how they are filled.
template <class Cf>
struct Ring {
  using E = typename Cf::E;
  static constexpr int C = Cf::C;
  static constexpr bool kQ8 = std::is_same<E, int8_t>::value;
  uint8_t* base;           // [kStages][2][C][pitch]
  float* scl;              // [kStages][2][C]
  int pitch;
  const uint8_t* kp;
  const uint8_t* vp;
  const float* ks;
  const float* vs;
  const int* ids;          // clamped page ids of the split, from page p0
  int p0, page, d, k_hi;
  int head_base;           // kvh * total_pages

  __device__ __forceinline__ const uint8_t* krow(int s, int key) const {
    return base + (s * 2 * C + key) * pitch;
  }
  __device__ __forceinline__ const uint8_t* vrow(int s, int key) const {
    return base + (s * 2 * C + C + key) * pitch;
  }
  __device__ __forceinline__ const float* kscale(int s) const {
    return scl + s * 2 * C;
  }
  __device__ __forceinline__ const float* vscale(int s) const {
    return scl + s * 2 * C + C;
  }

  // keys k0 .. k0 + C - 1 into stage s (those at or past k_hi as zeros):
  // lane r < C finds key k0 + r's pool row, then kLpc lanes copy each row
  __device__ __forceinline__ void fill(int s, int k0, int lane) const {
    const int t = k0 + lane;
    const bool ok = lane < C && t < k_hi;
    const int tt = ok ? t : k0;              // a row in the pool
    const int slot = (head_base + ids[tt / page - p0]) * page + tt % page;
    const int segs = d * (int)sizeof(E) / 16;
    uint8_t* kd = base + s * 2 * C * pitch;
    uint8_t* vd = kd + C * pitch;
#pragma unroll
    for (int r0 = 0; r0 < C; r0 += 32 / Cf::kLpc) {
      const int r = r0 + lane / Cf::kLpc;
      const int rs = __shfl_sync(kFull, slot, r);
      const int n = k0 + r < k_hi ? 16 : 0;
      const size_t src = (size_t)rs * d * sizeof(E);
#pragma unroll
      for (int sg0 = 0; sg0 < Cf::kSegs; sg0 += Cf::kLpc) {
        const int sg = sg0 + lane % Cf::kLpc;
        if (sg < segs) {
          cp_async16(kd + r * pitch + sg * 16, kp + src + sg * 16, n);
          cp_async16(vd + r * pitch + sg * 16, vp + src + sg * 16, n);
        }
      }
    }
    if constexpr (kQ8) {
      if (lane < C) {
        float* sd = scl + s * 2 * C;
        cp_async4(sd + lane, ks + slot, ok ? 4 : 0);
        cp_async4(sd + C + lane, vs + slot, ok ? 4 : 0);
      }
    }
  }
};

// Walk the warp's n_mine chunks (the j-th starts at key first(j)) through
// its ring: chunk j + kStages - 1 is copied while chunk j is consumed.
template <class RingT, class First, class Consume>
__device__ __forceinline__ void walk(const RingT& ring, int n_mine,
                                     First first, Consume consume) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_mine) ring.fill(s, first(s), lane);
    cp_async_commit();
  }
  for (int j = 0; j < n_mine; ++j) {
    const int nxt = j + kStages - 1;
    if (nxt < n_mine) ring.fill(nxt % kStages, first(nxt), lane);
    cp_async_commit();
    cp_async_wait<kStages - 1>();            // chunk j has landed
    __syncwarp();
    consume(j % kStages, first(j));
    __syncwarp();                            // before its stage is refilled
  }
  cp_async_wait<0>();
}

// The merge area of a block (see merge_bytes).
struct Part {
  float* acc;              // [kWarps][kMaxQ][dp]
  float* m;                // [kWarps][kMaxQ]
  float* l;                // [kWarps][kMaxQ]
  int dp;
  __device__ explicit Part(uint8_t* smem, int d)
      : acc(reinterpret_cast<float*>(smem)),
        m(acc + kWarps * kMaxQ * (d + 4)),
        l(m + kWarps * kMaxQ),
        dp(d + 4) {}
};

// The tensor-core route of one warp (bf16 queries, 2 to 16 query vectors,
// d a multiple of 16 up to kD <= 128): the warp's chunks through
// m16n8k16; leaves its partial (m, l, acc) of query vectors 0..15 in the
// merge area under index kw. Query vector i sees keys below qlen[i].
template <class Cf>
__device__ __forceinline__ void warp_mma(const Ring<Cf>& ring,
                                         const uint8_t* qtile, int pitch_q,
                                         const Tile& t, const int* qlen,
                                         int k_lo, int k_hi, int n_mine,
                                         int kw, int nkw, float c,
                                         const Part& part) {
  constexpr int C = 16, kD = Cf::kD_;
  constexpr bool kQ8 = std::is_same<typename Cf::E, int8_t>::value;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int d = ring.d;

  uint32_t qa[kD / 16][4];                   // the query tile, once
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    if (kk * 16 < d)
      ldsm_x4(smem_u32(qtile + (lane & 15) * pitch_q +
                       (kk * 16 + (lane >> 4) * 8) * 2),
              qa[kk]);
  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // rows g and g + 8 of the tile: their key limits (exclusive) and state
  const int lim0 = g < t.nq ? min(qlen[g], k_hi) : 0;
  const int lim1 = g + 8 < t.nq ? min(qlen[g + 8], k_hi) : 0;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  auto first = [&](int j) { return k_lo + (kw + j * nkw) * C; };
  walk(ring, n_mine, first, [&](int s, int k0) {
    // S = Q . K^T: n-tile 0 holds keys 0-7 of the chunk, n-tile 1 keys
    // 8-15; even and odd k-steps in two accumulators (shorter chains)
    float sc[2][2][4] = {};
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      if (kk * 16 >= d) break;
      uint32_t b[4];
      if constexpr (!kQ8) {
        const int key = (lane & 7) + ((lane >> 4) << 3);
        const int col = kk * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4(smem_u32(ring.krow(s, key) + col * 2), b);
      } else {                               // K = q8 * s, read as bf16
        const float* ksc = ring.kscale(s);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int key = 8 * nt + g;
          const int8_t* kr =
              reinterpret_cast<const int8_t*>(ring.krow(s, key));
          const float sk = ksc[key];
          const char2 lo = *reinterpret_cast<const char2*>(kr + 16 * kk +
                                                           2 * tg);
          const char2 hi = *reinterpret_cast<const char2*>(kr + 16 * kk + 8 +
                                                           2 * tg);
          b[2 * nt] = pack_bf16((float)lo.x * sk, (float)lo.y * sk);
          b[2 * nt + 1] = pack_bf16((float)hi.x * sk, (float)hi.y * sk);
        }
      }
      mma_bf16(sc[kk & 1][0], qa[kk], b[0], b[1]);
      mma_bf16(sc[kk & 1][1], qa[kk], b[2], b[3]);
    }
    // mask, then the online softmax of rows g (.[0..1]) and g + 8 (.[2..3])
    float p[2][4];
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int key = k0 + 8 * nt + 2 * tg + u;
        const float x0 = sc[0][nt][u] + sc[1][nt][u];
        const float x1 = sc[0][nt][2 + u] + sc[1][nt][2 + u];
        p[nt][u] = key < lim0 ? x0 * c : -INFINITY;
        p[nt][2 + u] = key < lim1 ? x1 * c : -INFINITY;
        mx0 = fmaxf(mx0, p[nt][u]);
        mx1 = fmaxf(mx1, p[nt][2 + u]);
      }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a fully masked step keeps m at -inf and adds nothing
    const float u0 = mn0 == -INFINITY ? 0.f : mn0;
    const float u1 = mn1 == -INFINITY ? 0.f : mn1;
    const float a0 = exp2f(m0 - u0), a1 = exp2f(m1 - u1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        p[nt][u] = exp2f(p[nt][u] - u0);
        p[nt][2 + u] = exp2f(p[nt][2 + u] - u1);
        ps0 += p[nt][u];
        ps1 += p[nt][2 + u];
      }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      o[n][0] *= a0; o[n][1] *= a0;
      o[n][2] *= a1; o[n][3] *= a1;
    }
    // P (bf16) as the A operand: keys 2tg, 2tg+1 | 8+2tg, 9+2tg
    const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]),
                            pack_bf16(p[0][2], p[0][3]),
                            pack_bf16(p[1][0], p[1][1]),
                            pack_bf16(p[1][2], p[1][3])};
    // O += P . V, 16 dims (two n-tiles) at a time
#pragma unroll
    for (int dt = 0; dt < kD / 16; ++dt) {
      if (dt * 16 >= d) break;
      uint32_t b[4];
      if constexpr (!kQ8) {
        const int key = (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = dt * 16 + (lane >> 4) * 8;
        ldsm_x4_t(smem_u32(ring.vrow(s, key) + col * 2), b);
      } else {                               // V = q8 * s, read as bf16
        const float* vsc = ring.vscale(s);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int dim = dt * 16 + 8 * h + g;
          float v[4];
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const int key = 2 * tg + (w & 1) + (w >> 1) * 8;
            v[w] = (float)reinterpret_cast<const int8_t*>(
                       ring.vrow(s, key))[dim] * vsc[key];
          }
          b[2 * h] = pack_bf16(v[0], v[1]);
          b[2 * h + 1] = pack_bf16(v[2], v[3]);
        }
      }
      mma_bf16(o[2 * dt], pa, b[0], b[1]);
      mma_bf16(o[2 * dt + 1], pa, b[2], b[3]);
    }
  });
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {          // the rows' sums over the quad
    l0 += __shfl_xor_sync(kFull, l0, x);
    l1 += __shfl_xor_sync(kFull, l1, x);
  }
  __syncthreads();                           // every ring is consumed
  float* pacc = part.acc + kw * kMaxQ * part.dp;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    if (n * 8 >= d) break;
    const int dim = 8 * n + 2 * tg;
    *reinterpret_cast<float2*>(pacc + g * part.dp + dim) =
        make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(pacc + (g + 8) * part.dp + dim) =
        make_float2(o[n][2], o[n][3]);
  }
  if (tg == 0) {
    part.m[kw * kMaxQ + g] = m0;
    part.m[kw * kMaxQ + g + 8] = m1;
    part.l[kw * kMaxQ + g] = l0;
    part.l[kw * kMaxQ + g + 8] = l1;
  }
}

// The FFMA route of one warp: query vectors kNQ qg .. kNQ qg + kNQ - 1 of
// the tile over the warp's chunks. Lane (kg, sl) holds dims 8 sl .. 8 sl
// + 7 of each and scores keys kg, kg + kKg, ... of a chunk; leaves its
// partial in the merge area under index kw. Query vector i sees keys below
// qlen[i]; query slots past the tile have no key below their limit, so
// they stay at m = -inf and add nothing.
template <class Cf, int kNQ, typename T>
__device__ __forceinline__ void warp_ffma(const Ring<Cf>& ring, const T* q,
                                          const Tile& t, int n_heads,
                                          int kvh, int group, const int* qlen,
                                          int k_lo, int k_hi, int n_mine,
                                          int qg, int kw, int nkw, float c,
                                          const Part& part) {
  using E = typename Cf::E;
  constexpr bool kQ8 = std::is_same<E, int8_t>::value;
  constexpr int C = Cf::C, kLpr = Cf::kLpr, kKg = Cf::kKg;
  constexpr int kKeys = Cf::kKeys;
  const int lane = threadIdx.x & 31;
  const int d = ring.d;
  const int sl = lane % kLpr, kg = lane / kLpr, e0 = 8 * sl;
  const bool act = e0 < d;
  const int n_q = max(0, min(kNQ, t.nq - qg * kNQ));

  float qv[kNQ][8], acc[kNQ][8], m[kNQ], l[kNQ];
  int lim[kNQ];
#pragma unroll
  for (int i = 0; i < kNQ; ++i) {
    const int qi = qg * kNQ + i;
    m[i] = -INFINITY;
    l[i] = 0.f;
    lim[i] = 0;
#pragma unroll
    for (int u = 0; u < 8; ++u) qv[i][u] = acc[i][u] = 0.f;
    if (i < n_q) {
      const int tk = qi / group, hh = qi - tk * group;
      lim[i] = min(qlen[qi], k_hi);
      if (act)
        load8<T>(q + ((size_t)(t.row0 + tk) * n_heads +
                      (size_t)kvh * group + hh) * d + e0, 1.f, qv[i]);
    }
  }

  auto first = [&](int j) { return k_lo + (kw + j * nkw) * C; };
  walk(ring, n_q > 0 ? n_mine : 0, first, [&](int s, int k0) {
    float sc[kKeys][kNQ];
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) {
      const int key = kg + kKg * jj;
      float kv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) kv[u] = 0.f;
      if (act)
        load8<E>(ring.krow(s, key) + e0 * sizeof(E),
                 kQ8 ? ring.kscale(s)[key] : 1.f, kv);
#pragma unroll
      for (int i = 0; i < kNQ; ++i) {
        float x = 0.f;
#pragma unroll
        for (int u = 0; u < 8; ++u) x = fmaf(qv[i][u], kv[u], x);
        sc[jj][i] = x;
      }
    }
    // full dot products: the sum over the kLpr lanes of a row
#pragma unroll
    for (int x = 1; x < kLpr; x <<= 1)
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj)
#pragma unroll
        for (int i = 0; i < kNQ; ++i)
          sc[jj][i] += __shfl_xor_sync(kFull, sc[jj][i], x);
    float mx[kNQ];
#pragma unroll
    for (int i = 0; i < kNQ; ++i) {
      mx[i] = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) {
        const bool ok = k0 + kg + kKg * jj < lim[i];
        sc[jj][i] = ok ? sc[jj][i] * c : -INFINITY;
        mx[i] = fmaxf(mx[i], sc[jj][i]);
      }
    }
#pragma unroll
    for (int x = kLpr; x < 32; x <<= 1)
#pragma unroll
      for (int i = 0; i < kNQ; ++i)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], x));
#pragma unroll
    for (int i = 0; i < kNQ; ++i) {
      const float mn = fmaxf(m[i], mx[i]);
      const float um = mn == -INFINITY ? 0.f : mn;
      const float alpha = exp2f(m[i] - um);
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) {
        sc[jj][i] = exp2f(sc[jj][i] - um);
        ps += sc[jj][i];
      }
      l[i] = l[i] * alpha + ps;              // this key group's share
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[i][u] *= alpha;
      m[i] = mn;
    }
    if (act)
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) {
        const int key = kg + kKg * jj;
        float vv[8];
        load8<E>(ring.vrow(s, key) + e0 * sizeof(E),
                 kQ8 ? ring.vscale(s)[key] : 1.f, vv);
#pragma unroll
        for (int i = 0; i < kNQ; ++i)
#pragma unroll
          for (int u = 0; u < 8; ++u)
            acc[i][u] = fmaf(sc[jj][i], vv[u], acc[i][u]);
      }
  });
  // the key groups' shares: same m (warp-wide), so they add
#pragma unroll
  for (int x = kLpr; x < 32; x <<= 1)
#pragma unroll
    for (int i = 0; i < kNQ; ++i) {
      l[i] += __shfl_xor_sync(kFull, l[i], x);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        acc[i][u] += __shfl_xor_sync(kFull, acc[i][u], x);
    }
  __syncthreads();                           // every ring is consumed
#pragma unroll
  for (int i = 0; i < kNQ; ++i) {
    if (i >= n_q) break;
    const int qi = qg * kNQ + i;
    float* dst = part.acc + (kw * kMaxQ + qi) * part.dp + e0;
    if (kg == 0 && act) {
      reinterpret_cast<float4*>(dst)[0] =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      reinterpret_cast<float4*>(dst)[1] =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    if (lane == 0) {
      part.m[kw * kMaxQ + qi] = m[i];
      part.l[kw * kMaxQ + qi] = l[i];
    }
  }
}

// 4 values of out (T), or of the f32 workspace
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// kQ8: the pools are int8 with one f32 scale per (kv head, page, slot);
// otherwise they hold T, and the scales are not read. kD: the head_dim
// bucket (see Cfg).
template <typename T, bool kQ8, int kD>
__global__ void __launch_bounds__(kThreads, kD <= 128 ? kMinBlocks : 1)
paged_decode_kernel(const Args a) {
  using Cf = Cfg<T, kQ8, kD>;
  using E = typename Cf::E;
  constexpr int C = Cf::C;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int ids[kMaxIds];
  __shared__ float wts[kWarps][kMaxQ];       // the warps' merge weights
  __shared__ float qm[kMaxQ], qlsum[kMaxQ];  // the block's m and l
  __shared__ int qlen[kMaxQ];                // the unit's keys a query vector
  __shared__ int tlen[kMaxQ];                // the tile's rows' lengths
  __shared__ int rlen[kMaxQ];                // the block's rows' lengths

  const int d = a.d;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int pitch = pitch_of(d, sizeof(E));
  const int rbytes = ring_bytes(d, sizeof(E), C, kQ8);
  const int pitch_q = pitch_of(d, 2);
  uint8_t* qtile = smem + kWarps * rbytes;   // [kMaxQ][pitch_q] bf16
  const Part part(smem, d);
  const float c = a.scale * kLog2e;
  const T* q = static_cast<const T*>(a.q);
  T* out = static_cast<T*>(a.out);
  const size_t n_ws = (size_t)a.n_rows * a.n_heads * a.n_splits;
  float* ws_m = a.ws + n_ws * d;             // after acc [n_ws][d]
  float* ws_l = ws_m + n_ws;
  const int window = a.page * a.pages_per_seq;
  const int R = a.tile_rows;

  // the block's items: `run` consecutive rows (one, or a tile) of one kv
  // head and split
  const int n_runs = cdiv(a.n_rows, a.run);
  const int kvh = (int)(blockIdx.x / n_runs % a.n_kv);
  const int split = (int)(blockIdx.x / ((long long)n_runs * a.n_kv));
  const int k_lo = split * a.split;
  const int first_row = (int)(blockIdx.x % n_runs) * a.run;
  const int last_row = min(first_row + a.run, a.n_rows);
  // whether the block's tile shares one read in this split, its longest
  // row and that row's length: decided once, by every thread alike
  bool decided = false, shared = false;
  int ref = 0, end = 0;
  if (tid < last_row - first_row)            // every length at once
    rlen[tid] = min(max(a.context_lens[first_row + tid], 0), window);
  __syncthreads();
  for (int row = first_row; row < last_row; ++row) {
    const int len = rlen[row - first_row];
    const int r0 = row - row % R;            // the tile's first row
    if (row != r0 && len <= k_lo) continue;  // no key here, not the first
    __syncthreads();                         // the last item's smem is read

    // Does the tile share one read in this split? The block's rows are of
    // one tile, so it decides once; every item of the tile (every kv
    // head) decides alike.
    const int rn = min(R, a.n_rows - r0);
    if (!decided) {
      if (tid < kMaxQ)
        tlen[tid] = tid < rn
            ? min(max(a.context_lens[r0 + tid], 0), window) : 0;
      __syncthreads();
      int live = 0;
      for (int i = 0; i < rn; ++i) {
        const int x = tlen[i];
        if (x > end) {
          end = x;
          ref = i;
        }
        live += x > k_lo;
      }
      // every live row's page ids over the pages it sees in the split
      // against the longest row's (both clamped: the pages read)
      bool diff = false;
      if (live >= 2) {
        const int p_lo = k_lo / a.page;
        const int np = (min(k_lo + a.split, end) - 1) / a.page - p_lo + 1;
        const int* bref =
            a.block_tables + (size_t)(r0 + ref) * a.pages_per_seq;
        for (int x = tid; x < rn * np; x += kThreads) {
          const int i = x / np, p = p_lo + x % np;
          if (i == ref || p * a.page >= min(tlen[i], k_lo + a.split))
            continue;                        // not a page row i sees here
          const int* bi =
              a.block_tables + (size_t)(r0 + i) * a.pages_per_seq;
          diff |= min(max(bi[p], 0), a.total_pages - 1) !=
                  min(max(bref[p], 0), a.total_pages - 1);
        }
      }
      const bool any_diff = __syncthreads_or(diff);
      shared = live >= 2 && !any_diff;
      decided = true;
    }

    // the unit: the whole tile (run by its first row's item), or this row
    Tile t;
    int kv_end, src;
    if (shared) {
      if (row != r0) continue;               // the tile's first row runs it
      t.row0 = r0;
      t.nq = rn * a.group;
      kv_end = end;
      src = r0 + ref;
    } else {
      if (len <= k_lo) continue;
      t.row0 = row;
      t.nq = a.group;
      kv_end = len;
      src = row;
    }
    const int k_hi = min(k_lo + a.split, kv_end);
    const bool mma = Cf::kMma && t.nq > 1 && d % 16 == 0;

    const int p0 = k_lo / a.page;
    const int n_ids = (k_hi - 1) / a.page - p0 + 1;
    const int* bt = a.block_tables + (size_t)src * a.pages_per_seq;
    for (int i = tid; i < n_ids; i += kThreads)
      ids[i] = min(max(bt[p0 + i], 0), a.total_pages - 1);
    if (tid < kMaxQ)
      qlen[tid] = tid >= t.nq ? 0
          : shared ? tlen[tid / a.group] : len;
    if (Cf::kMma && mma) {                   // the query tile, rows >= nq 0
      const int segs = d / 8;
      for (int i = tid; i < kMaxQ * segs; i += kThreads) {
        const int r = i / segs, sg = i - r * segs;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < t.nq) {
          const int tk = r / a.group, hh = r - tk * a.group;
          val = *reinterpret_cast<const uint4*>(
              q + ((size_t)(t.row0 + tk) * a.n_heads +
                   (size_t)kvh * a.group + hh) * d + sg * 8);
        }
        *reinterpret_cast<uint4*>(qtile + r * pitch_q + sg * 16) = val;
      }
    }
    __syncthreads();

    // warps split the keys (chunk c to warp c % nkw) and, on FFMA tiles of
    // more than 4 query vectors, the queries (nqg groups of 4)
    const int nqg = (mma || t.nq <= 4) ? 1 : t.nq <= 8 ? 2 : 4;
    const int nkw = kWarps / nqg;
    const int qg = warp % nqg, kw = warp / nqg;
    const int n_chunks = cdiv(k_hi - k_lo, C);
    const int n_mine = n_chunks > kw ? cdiv(n_chunks - kw, nkw) : 0;
    const Ring<Cf> ring{smem + warp * rbytes,
                        reinterpret_cast<float*>(smem + warp * rbytes +
                                                 kStages * 2 * C * pitch),
                        pitch,
                        static_cast<const uint8_t*>(a.k_pages),
                        static_cast<const uint8_t*>(a.v_pages),
                        a.k_scales, a.v_scales, ids, p0, a.page, d, k_hi,
                        kvh * a.total_pages};
    if constexpr (Cf::kMma) {
      if (mma) {
        warp_mma<Cf>(ring, qtile, pitch_q, t, qlen, k_lo, k_hi, n_mine, kw,
                     nkw, c, part);
      } else if (t.nq == 1) {
        warp_ffma<Cf, 1>(ring, q, t, a.n_heads, kvh, a.group, qlen, k_lo,
                         k_hi, n_mine, 0, kw, nkw, c, part);
      } else {
        warp_ffma<Cf, kQPerWarp>(ring, q, t, a.n_heads, kvh, a.group, qlen,
                                 k_lo, k_hi, n_mine, qg, kw, nkw, c, part);
      }
    } else if (t.nq == 1) {
      warp_ffma<Cf, 1>(ring, q, t, a.n_heads, kvh, a.group, qlen, k_lo,
                       k_hi, n_mine, 0, kw, nkw, c, part);
    } else {
      warp_ffma<Cf, kQPerWarp>(ring, q, t, a.n_heads, kvh, a.group, qlen,
                               k_lo, k_hi, n_mine, qg, kw, nkw, c, part);
    }
    __syncthreads();

    // the warps' partials, in warp order: each query vector's weights
    // once, then out (a row whose keys fit one split) or this split's
    // partial, 4 dims a thread; query vectors of rows with no key in this
    // split write nothing
    if (tid < t.nq) {
      float mx = -INFINITY;
      for (int w = 0; w < nkw; ++w) mx = fmaxf(mx, part.m[w * kMaxQ + tid]);
      float f[kWarps], ls = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = w < nkw ? part.m[w * kMaxQ + tid] : -INFINITY;
        f[w] = mw == -INFINITY ? 0.f : exp2f(mw - mx);   // saw no key: 0
        if (w < nkw) ls += f[w] * part.l[w * kMaxQ + tid];
      }
      const bool single = qlen[tid] <= a.split;
      const float inv = single ? 1.f / (ls == 0.f ? 1.f : ls) : 1.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) wts[w][tid] = f[w] * inv;
      qm[tid] = mx;
      qlsum[tid] = ls;
    }
    __syncthreads();
    const int d4 = d / 4;
    for (int i = tid; i < t.nq * d4; i += kThreads) {
      const int qi = i / d4, e = (i - qi * d4) * 4;
      if (qlen[qi] <= k_lo) continue;
      float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int w = 0; w < nkw; ++w) {
        const float wt = wts[w][qi];
        const float4 x = *reinterpret_cast<const float4*>(
            part.acc + (w * kMaxQ + qi) * part.dp + e);
        r.x += wt * x.x; r.y += wt * x.y; r.z += wt * x.z; r.w += wt * x.w;
      }
      const int tk = qi / a.group, hh = qi - tk * a.group;
      const size_t th = (size_t)(t.row0 + tk) * a.n_heads +
                        (size_t)kvh * a.group + hh;
      if (qlen[qi] <= a.split) {
        store4(out + th * d + e, r);
      } else {
        const size_t idx = th * a.n_splits + split;
        store4(a.ws + idx * d + e, r);
        if (e == 0) {
          ws_m[idx] = qm[qi];
          ws_l[idx] = qlsum[qi];
        }
      }
    }
  }
}

// Combines the split partials of every row whose keys span more than one
// split, in split order: out = sum_j 2^(m_j - M) acc_j / sum_j 2^(m_j - M)
// l_j over the splits that saw a key (M their largest m); 0 where none
// did. Block (row, kv head). Templated as the attention kernel so that a
// profile groups it with K6 or K6-q8.
template <typename T, bool kQ8>
__global__ void __launch_bounds__(kThreads)
paged_decode_merge_kernel(const Args a) {
  const int row = blockIdx.x, kvh = blockIdx.y, d = a.d, d4 = d / 4;
  const int len = min(max(a.context_lens[row], 0), a.page * a.pages_per_seq);
  if (len <= a.split) return;                // written by its one split
  const int n_used = cdiv(len, a.split);
  const size_t n_ws = (size_t)a.n_rows * a.n_heads * a.n_splits;
  const float* ws_m = a.ws + n_ws * d;
  const float* ws_l = ws_m + n_ws;
  T* out = static_cast<T*>(a.out);
  for (int i = threadIdx.x; i < a.group * d4; i += kThreads) {
    const int hh = i / d4, e = (i - hh * d4) * 4;
    const size_t th = (size_t)row * a.n_heads + (size_t)kvh * a.group + hh;
    const size_t idx = th * a.n_splits;
    float mx = -INFINITY;
    for (int j = 0; j < n_used; ++j) mx = fmaxf(mx, ws_m[idx + j]);
    float ls = 0.f;
    float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
    if (mx != -INFINITY)
      for (int j = 0; j < n_used; ++j) {
        const float mj = ws_m[idx + j];
        if (mj == -INFINITY) continue;       // this split saw no key
        const float f = exp2f(mj - mx);
        ls += f * ws_l[idx + j];
        const float4 x =
            *reinterpret_cast<const float4*>(a.ws + (idx + j) * d + e);
        r.x += f * x.x; r.y += f * x.y; r.z += f * x.z; r.w += f * x.w;
      }
    const float inv = 1.f / (ls == 0.f ? 1.f : ls);
    store4(out + th * d + e,
           make_float4(r.x * inv, r.y * inv, r.z * inv, r.w * inv));
  }
}

inline int host_cdiv(long long a, long long b) {
  return (int)((a + b - 1) / b);
}

int sm_count() {
  int dev = 0, n_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n_sm;
}

// Keys of a split for these shapes (see the note at the top), a multiple
// of 64 keys in [kMinSplit, kMaxSplit]: the units that walk keys on their
// own times the window's splits about four times the SMs when a unit is a
// (row, kv head) pair (a decode batch: rows end at their own lengths, so
// many of the window's splits are empty), and about once when it is a
// (tile, kv head) pair (a call of more than one tile of rows, a prefill
// chunk: its tiles share their reads and see about the whole window, and
// a tile's item does 16 rows' work). Read on an H100 (decode_ab.py): 4x
// for the prefill chunks cost 35-40% more, 1x for the decode batches 7-14%.
int split_of(int n_rows, int tile_rows, int n_kv, int window, int n_sm) {
  const bool rows = n_rows <= tile_rows;
  const long long units =
      (long long)(rows ? n_rows : host_cdiv(n_rows, tile_rows)) * n_kv;
  const long long target = (rows ? 4LL : 1LL) * n_sm;
  const long long want = std::max<long long>(1, (target + units - 1) /
                                                    std::max(units, 1LL));
  const int s = host_cdiv(host_cdiv(window, want), 64) * 64;
  return std::min(kMaxSplit, std::max(kMinSplit, s));
}

template <typename T, bool kQ8, int kD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using Cf = Cfg<T, kQ8, kD>;
  const int d = a.d;
  const size_t smem = std::max<size_t>(
      (size_t)kWarps * ring_bytes(d, sizeof(typename Cf::E), Cf::C, kQ8) +
          (Cf::kMma ? kMaxQ * pitch_of(d, 2) : 0),
      (size_t)merge_bytes(d));
  auto kernel = paged_decode_kernel<T, kQ8, kD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long grid =
      (long long)host_cdiv(a.n_rows, a.run) * a.n_kv * a.n_splits;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (a.n_splits > 1) {
    paged_decode_merge_kernel<T, kQ8>
        <<<dim3(a.n_rows, a.n_kv), kThreads, 0, stream>>>(a);
    err = cudaGetLastError();
  }
  return err;
}

// the head_dim bucket of the call
template <typename T, bool kQ8>
cudaError_t launch_bucket(const Args& a, cudaStream_t stream) {
  if (a.d <= 64) return launch<T, kQ8, 64>(a, stream);
  if (a.d <= 128) return launch<T, kQ8, 128>(a, stream);
  return launch<T, kQ8, 256>(a, stream);
}

cudaError_t make_args(Args& a, const void* q, const void* k_pages,
                      const void* v_pages, const float* k_scales,
                      const float* v_scales, const int* block_tables,
                      const int* context_lens, void* out, float* ws,
                      int n_rows, int n_heads, int n_kv, int d,
                      int total_pages, int page, int pages_per_seq,
                      float scale) {
  const int n_sm = sm_count();
  if (n_sm == 0) return cudaErrorInvalidDevice;
  a.q = q; a.k_pages = k_pages; a.v_pages = v_pages;
  a.k_scales = k_scales; a.v_scales = v_scales;
  a.block_tables = block_tables; a.context_lens = context_lens;
  a.out = out; a.ws = ws;
  a.n_rows = n_rows; a.n_heads = n_heads; a.n_kv = n_kv; a.d = d;
  a.total_pages = total_pages; a.page = page;
  a.pages_per_seq = pages_per_seq; a.group = n_heads / n_kv;
  a.tile_rows = std::max(1, kMaxQ / a.group);
  a.split = split_of(n_rows, a.tile_rows, n_kv, page * pages_per_seq, n_sm);
  a.run = n_rows > a.tile_rows ? a.tile_rows : 1;
  a.n_splits = host_cdiv(page * pages_per_seq, a.split);
  a.scale = scale;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Keys of a split for a call of these shapes on the current card.
int pa_split(int n_rows, int n_heads, int n_kv, int window) {
  const int n_sm = sm_count();
  const int tile_rows = std::max(1, kMaxQ / (n_heads / n_kv));
  return n_sm == 0 ? 0 : split_of(n_rows, tile_rows, n_kv, window, n_sm);
}

// f32 words of the workspace that a call with these shapes needs on the
// current card (0 when every row fits one split): m, l and acc of every
// (row, head, split).
long long pa_workspace_floats(int n_rows, int n_heads, int n_kv, int d,
                              int window) {
  const int split = pa_split(n_rows, n_heads, n_kv, window);
  const long long n_splits = split > 0 ? host_cdiv(window, split) : 0;
  if (n_splits <= 1) return 0;
  return (long long)n_rows * n_heads * n_splits * (d + 2);
}

// Launches on `stream`, does not synchronise, allocates nothing: `ws` is
// the caller's workspace of pa_workspace_floats(...) f32 words. The
// caller has checked shapes, dtypes, contiguity and 16-byte alignment, that
// d is a multiple of 8 and at most 256, the page size a multiple of 8, and
// that n_heads / n_kv <= 16. q, the pools and out are bf16 (is_bf16) or
// f32. Returns the CUDA error of the launches (0 on success).
int pa_launch(const void* q, const void* k_pages, const void* v_pages,
              const int* block_tables, const int* context_lens, void* out,
              float* ws, int n_rows, int n_heads, int n_kv, int d,
              int total_pages, int page, int pages_per_seq, float scale,
              int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a;
  const cudaError_t err = make_args(
      a, q, k_pages, v_pages, nullptr, nullptr, block_tables, context_lens,
      out, ws, n_rows, n_heads, n_kv, d, total_pages, page, pages_per_seq,
      scale);
  if (err != cudaSuccess) return (int)err;
  return (int)(is_bf16 ? launch_bucket<bf16, false>(a, s)
                       : launch_bucket<float, false>(a, s));
}

// The same over an int8 pool: k8/v8 int8 [n_kv, total_pages, page, d] and
// their scales ks/vs f32 [n_kv, total_pages, page]; q and out bf16
// (is_bf16) or f32. The caller has also checked that d is a multiple of 16.
int pa_q8_launch(const void* q, const void* k8, const float* ks,
                 const void* v8, const float* vs, const int* block_tables,
                 const int* context_lens, void* out, float* ws, int n_rows,
                 int n_heads, int n_kv, int d, int total_pages, int page,
                 int pages_per_seq, float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a;
  const cudaError_t err = make_args(
      a, q, k8, v8, ks, vs, block_tables, context_lens, out, ws, n_rows,
      n_heads, n_kv, d, total_pages, page, pages_per_seq, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)(is_bf16 ? launch_bucket<bf16, true>(a, s)
                       : launch_bucket<float, true>(a, s));
}

const char* pa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
