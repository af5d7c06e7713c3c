// Ragged paged attention for Hopper (sm_90a): mixed prefill + decode rows
// over one paged KV pool, in one launch.
//
// Replaces two TPU kernels of paddle_tpu/incubate/nn/pallas/
// paged_attention.py, both reached there through `ragged_paged_attention`:
// `_ragged_kernel` (with `_ragged_accumulate`) over a bf16 or f32 pool
// (rpa_launch), and `_ragged_kernel_q8` over an int8 pool (rpa_q8_launch),
// whose pages are {"q8": int8 [n_kv, total_pages, page, d], "s": f32
// [n_kv, total_pages, page]} and whose key rows decode by the one rule of
// `_dequant`: value = float(q8) * s (the row's scale). Same layouts and
// semantics:
//
//   q            [n_tokens, n_heads, d]           flat token axis
//   k/v pages    [n_kv, total_pages, page, d]
//   block_tables [n_rows, pages_per_seq] int32    page id per slot
//   context_lens [n_rows] int32   KV length INCLUDING this step's tokens
//   query_lens   [n_rows] int32   tokens the row owns (0 = idle row)
//   q_starts     [n_rows] int32   first token of the row on the flat axis
//   out          [n_tokens, n_heads, d]           zeroed by the caller
//
// Token j of row r attends to KV positions < cl[r] - ql[r] + j + 1, cut at
// the block-table window (pages_per_seq * page). Idle rows and padding
// tokens are never written, so they keep the caller's zeros. Block-table
// ids are clamped into the pool. GQA: the `group` query heads of one kv
// head share its pages.
//
// What bounds it: on the serving path the kernel reads every live row's
// K and V once per layer, sum_r cl[r] * n_kv * 2 (K and V) * (2 d bytes in
// bf16, or d + 4 bytes in int8 with the row's f32 scale), and does 4 * d
// flops per (query head, key) pair. A decode row does 2-4 flops per byte,
// far below the ~295 flops/byte at which an H100's bf16 tensor cores, not
// its 3.35 TB/s memory, would be the limit, so the kernel is bound by the
// bytes of K/V it must read; the int8 pool halves them.
//
// What the design does about that, kept simple on purpose:
// * The TPU grid ran in order and kept one scratch that spanned the whole
//   token axis; that has no meaning on a GPU. Here one block owns one
//   (query tile, kv head, row): a tile is up to `tile_tokens` tokens of
//   the row times the `group` heads, at most 16 query vectors. The block
//   reads its own qs/ql/cl/bt; blocks past the row's tokens (and whole
//   idle rows) exit at once, so no K/V byte is read for them.
// * A block walks only the keys below the causal limit of its last token,
//   32 keys (one per lane) at a time: the 32 K rows and 32 V rows are
//   staged in shared memory as f32 through 16-byte loads, with a padded
//   row stride so that each lane reading its own key row hits its own
//   bank. Each page is read once per tile. The int8 pool differs only
//   here (template flag kQ8): a 16-byte load brings 16 int8 values of a
//   row (8 loads a row at d = 128, 4 at d = 64), which are decoded with
//   the row's scale as they are staged, so the rest of the kernel is one.
// * Each warp owns 4 query vectors and keeps their online softmax
//   (m, l, acc) in f32 registers, with the guarded -inf arithmetic of
//   `_ragged_accumulate`: a fully masked step keeps m at -inf and adds
//   nothing, and a query that saw no key writes acc / 1 = 0.
// Not done yet (later work): wgmma on the tensor cores, TMA and a
// multi-stage ring of pages, and splitting a long context across blocks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kQPerWarp = 4;                   // query vectors per warp
constexpr int kMaxQ = kWarps * kQPerWarp;      // query vectors per block
constexpr int kChunk = 32;                     // keys per step, one a lane
constexpr int kMaxR = 8;                       // dims per lane: d <= 256

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
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

// kQ8: the pools are int8 with one f32 scale per (kv head, page, slot);
// otherwise they hold T, and the scales are not read.
template <typename T, bool kQ8>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(
    const T* __restrict__ q, const void* __restrict__ k_pages,
    const void* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, const int* __restrict__ query_lens,
    const int* __restrict__ q_starts, T* __restrict__ out, int n_tokens,
    int n_heads, int d, int total_pages, int page, int pages_per_seq,
    int group, int tile_tokens, float scale) {
  const int tile = blockIdx.x;
  const int kvh = blockIdx.y;
  const int row = blockIdx.z;
  const int ql = query_lens[row];
  const int tok0 = tile * tile_tokens;
  if (tok0 >= ql) return;                      // idle row or tile past it
  const int cl = context_lens[row];
  const int qs = q_starts[row];
  // a span running off the token axis is cut there, never written past it
  const int n_tok = min(min(tile_tokens, ql - tok0), n_tokens - qs - tok0);
  if (qs < 0 || n_tok <= 0) return;
  const int nq = n_tok * group;                // live query vectors
  const int window = page * pages_per_seq;
  // keys below the causal limit of the tile's last token, inside the window
  const int kv_end = min(cl - ql + tok0 + n_tok, window);
  const int* bt = block_tables + (size_t)row * pages_per_seq;

  extern __shared__ float smem[];
  const int ld = d + 1;                        // padded row: lane l -> bank l
  float* ks = smem;                            // [kChunk][ld]
  float* vs = ks + kChunk * ld;                // [kChunk][ld]
  float* qsm = vs + kChunk * ld;               // [kMaxQ][d]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // query vector i of the tile is token i / group, head kvh*group + i%group
  for (int i = tid; i < nq * d; i += kThreads) {
    const int qi = i / d, e = i - qi * d;
    const int t = qi / group, g = qi - t * group;
    const size_t src =
        ((size_t)(qs + tok0 + t) * n_heads + (size_t)kvh * group + g) * d + e;
    qsm[i] = to_f32(q[src]);
  }

  const int q_first = warp * kQPerWarp;        // this warp's query vectors
  const int n_mine = max(0, min(kQPerWarp, nq - q_first));
  int limit[kQPerWarp];
  float m[kQPerWarp], l[kQPerWarp], acc[kQPerWarp][kMaxR];
#pragma unroll
  for (int i = 0; i < kQPerWarp; ++i) {
    limit[i] = cl - ql + tok0 + (q_first + i) / group + 1;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) acc[i][r] = 0.f;
  }

  // pool elements per 16-byte load
  constexpr int kVec = kQ8 ? 16 : 16 / (int)sizeof(T);
  const int vec_per_row = d / kVec;
  const size_t head_base = (size_t)kvh * total_pages;

  for (int c0 = 0; c0 < kv_end; c0 += kChunk) {
    __syncthreads();                           // previous chunk consumed
    for (int i = tid; i < kChunk * vec_per_row; i += kThreads) {
      const int key = i / vec_per_row, seg = i - key * vec_per_row;
      const int t = c0 + key;
      float* kd = ks + key * ld + seg * kVec;
      float* vd = vs + key * ld + seg * kVec;
      if (t < kv_end) {
        int pg = bt[t / page];
        pg = min(max(pg, 0), total_pages - 1);
        const size_t slot = (head_base + pg) * page + (t % page);
        const size_t off = slot * (size_t)d + seg * kVec;
        if constexpr (kQ8) {
          const uint4 kraw = *reinterpret_cast<const uint4*>(
              static_cast<const int8_t*>(k_pages) + off);
          const uint4 vraw = *reinterpret_cast<const uint4*>(
              static_cast<const int8_t*>(v_pages) + off);
          const int8_t* kx = reinterpret_cast<const int8_t*>(&kraw);
          const int8_t* vx = reinterpret_cast<const int8_t*>(&vraw);
          const float k_s = k_scales[slot], v_s = v_scales[slot];
#pragma unroll
          for (int w = 0; w < kVec; ++w) {     // _dequant: q8 * s, in f32
            kd[w] = (float)kx[w] * k_s;
            vd[w] = (float)vx[w] * v_s;
          }
        } else {
          const uint4 kraw = *reinterpret_cast<const uint4*>(
              static_cast<const T*>(k_pages) + off);
          const uint4 vraw = *reinterpret_cast<const uint4*>(
              static_cast<const T*>(v_pages) + off);
          const T* kx = reinterpret_cast<const T*>(&kraw);
          const T* vx = reinterpret_cast<const T*>(&vraw);
#pragma unroll
          for (int w = 0; w < kVec; ++w) {
            kd[w] = to_f32(kx[w]);
            vd[w] = to_f32(vx[w]);
          }
        }
      } else {                                 // no garbage reaches acc
#pragma unroll
        for (int w = 0; w < kVec; ++w) {
          kd[w] = 0.f;
          vd[w] = 0.f;
        }
      }
    }
    __syncthreads();
    if (n_mine == 0) continue;                 // warp-uniform

    // scores: lane owns key c0 + lane
    float s[kQPerWarp];
#pragma unroll
    for (int i = 0; i < kQPerWarp; ++i) s[i] = 0.f;
    const float* krow = ks + lane * ld;
    for (int e = 0; e < d; ++e) {
      const float kv = krow[e];
#pragma unroll
      for (int i = 0; i < kQPerWarp; ++i)
        s[i] += qsm[(q_first + i) * d + e] * kv;   // broadcast read
    }

    const int t = c0 + lane;
    float p[kQPerWarp];
#pragma unroll
    for (int i = 0; i < kQPerWarp; ++i) {
      const bool live = i < n_mine;            // warp-uniform
      const bool valid = live && t < kv_end && t < limit[i];
      const float si = valid ? s[i] * scale : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(si));
      const float safe_m = isfinite(m_new) ? m_new : 0.f;
      const float alpha = isfinite(m[i]) ? expf(m[i] - safe_m) : 0.f;
      p[i] = valid ? expf(si - safe_m) : 0.f;
      l[i] = l[i] * alpha + warp_sum(p[i]);
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) acc[i][r] *= alpha;
      m[i] = m_new;
    }

    // acc[i][dim] += sum_j p_j V[j][dim]; lane owns dims lane + 32 r
    for (int j = 0; j < kChunk; ++j) {
      const float* vrow = vs + j * ld;
      float vv[kMaxR];
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) {
        const int e = lane + 32 * r;
        vv[r] = e < d ? vrow[e] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kQPerWarp; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) acc[i][r] += pj * vv[r];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kQPerWarp; ++i) {          // constant trip count keeps
    if (i >= n_mine) break;                      // acc[][] in registers
    const int qi = q_first + i;
    const int t = qi / group, g = qi - t * group;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    T* dst = out + ((size_t)(qs + tok0 + t) * n_heads +
                    (size_t)kvh * group + g) * d;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      const int e = lane + 32 * r;
      if (e < d) store_as(dst + e, acc[i][r] * inv);
    }
  }
}

template <typename T, bool kQ8>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const float* k_scales, const float* v_scales,
                   const int* block_tables, const int* context_lens,
                   const int* query_lens, const int* q_starts, void* out,
                   int n_tokens, int n_heads, int n_kv, int d,
                   int total_pages, int page, int n_rows, int pages_per_seq,
                   int tile_tokens, float scale, cudaStream_t stream) {
  const int group = n_heads / n_kv;
  const size_t smem = (size_t)(2 * kChunk * (d + 1) + kMaxQ * d) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ragged_paged_attention_kernel<T, kQ8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n_tokens + tile_tokens - 1) / tile_tokens, n_kv, n_rows);
  ragged_paged_attention_kernel<T, kQ8><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), k_pages, v_pages, k_scales, v_scales,
      block_tables, context_lens, query_lens,
      q_starts, static_cast<T*>(out), n_tokens, n_heads, d, total_pages,
      page, pages_per_seq, group, tile_tokens, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronise, allocates nothing. The
// caller has checked shapes, dtypes, contiguity and alignment, and that
// tile_tokens * (n_heads / n_kv) <= 16 query vectors. Returns the CUDA
// error of the launch (0 on success).
int rpa_launch(const void* q, const void* k_pages, const void* v_pages,
               const int* block_tables, const int* context_lens,
               const int* query_lens, const int* q_starts, void* out,
               int n_tokens, int n_heads, int n_kv, int d, int total_pages,
               int page, int n_rows, int pages_per_seq, int tile_tokens,
               float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16, false>(
        q, k_pages, v_pages, nullptr, nullptr, block_tables, context_lens,
        query_lens, q_starts, out, n_tokens, n_heads, n_kv, d, total_pages,
        page, n_rows, pages_per_seq, tile_tokens, scale, s);
  return (int)launch<float, false>(
      q, k_pages, v_pages, nullptr, nullptr, block_tables, context_lens,
      query_lens, q_starts, out, n_tokens, n_heads, n_kv, d, total_pages,
      page, n_rows, pages_per_seq, tile_tokens, scale, s);
}

// The same over an int8 pool: k8/v8 int8 [n_kv, total_pages, page, d] and
// their scales ks/vs f32 [n_kv, total_pages, page]; q and out bf16
// (is_bf16) or f32. The caller has also checked that d is a multiple of 16.
int rpa_q8_launch(const void* q, const void* k8, const float* ks,
                  const void* v8, const float* vs, const int* block_tables,
                  const int* context_lens, const int* query_lens,
                  const int* q_starts, void* out, int n_tokens, int n_heads,
                  int n_kv, int d, int total_pages, int page, int n_rows,
                  int pages_per_seq, int tile_tokens, float scale,
                  int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16, true>(
        q, k8, v8, ks, vs, block_tables, context_lens, query_lens, q_starts,
        out, n_tokens, n_heads, n_kv, d, total_pages, page, n_rows,
        pages_per_seq, tile_tokens, scale, s);
  return (int)launch<float, true>(
      q, k8, v8, ks, vs, block_tables, context_lens, query_lens, q_starts,
      out, n_tokens, n_heads, n_kv, d, total_pages, page, n_rows,
      pages_per_seq, tile_tokens, scale, s);
}

const char* rpa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
