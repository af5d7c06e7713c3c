// Paged decode attention for Hopper (sm_90a): one query token per row over
// a paged KV pool.
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
// for every decode batch (one row a slot) and every prefill chunk (one row
// a chunk token, each with its own causal length over one block table).
//
// What bounds it: each row's K and V are read once, n_kv * 2 * len rows
// of 2 d bytes (bf16) or d + 4 bytes (int8 with its f32 scale), against
// 4 * d flops per (query head, key). A decode row does 1-4 flops per byte,
// two orders of magnitude below the ~295 flops/byte at which an H100's
// bf16 tensor cores would be the limit: the kernel is bound by the bytes
// of K/V it must read. The rows of a prefill chunk read the same pages, so
// there the bytes from device memory are one chunk's prefix and the rest
// comes from L2.
//
// What the design does about that, kept simple on purpose:
// * The TPU walked a row's pages as a sequential grid axis, one page per
//   step, with (m, l, acc) in VMEM scratch. Here one block of 8 warps owns
//   one (row, kv head) and the warps split the row's keys: warp w takes
//   keys 32 w .. 32 w + 31, then 32 (w + 8) .., so that up to 8 x 32 key
//   rows of a long context are in flight at once rather than 32.
// * A lane owns one key of its warp's chunk and reads that key's row from
//   device memory itself, 16 bytes a load (8 bf16, 4 f32 or 16 int8
//   values), with no staging through shared memory; the chunk's 32 rows
//   lie in one or two pages, so the warp's loads stay in a few contiguous
//   runs. The block's `group` query vectors sit in shared memory as f32
//   and are read as broadcasts. Then the lanes swap roles: lane l owns
//   dims l, l + 32, .. of the output, and each key's V row is one
//   coalesced read of the warp.
// * Each warp keeps its own f32 online softmax (m, l, acc) in registers,
//   with the guarded -inf arithmetic of `_decode_kernel`: a fully masked
//   step keeps m at -inf and adds nothing, and a row that saw no key
//   writes acc / 1 = 0.
// * The warps' states are merged once, at the end, through shared memory,
//   in a fixed order (the result does not depend on which warp finished
//   first).
// Not done yet (later work): wgmma on the tensor cores for the GQA groups
// and prefill chunks, TMA and a ring of pages, and splitting a long row
// across blocks when there are fewer (row, kv head) pairs than SMs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;                     // keys a warp step, one a lane

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
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

// T: q and out (and the pool unless kQ8). kQ8: the pools are int8 with one
// f32 scale per (kv head, page, slot). kG >= group query vectors a block;
// kR >= d / 32 output dims a lane.
template <typename T, bool kQ8, int kG, int kR>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const void* __restrict__ k_pages,
                    const void* __restrict__ v_pages,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ context_lens, T* __restrict__ out,
                    int n_heads, int d, int total_pages, int page,
                    int pages_per_seq, int group, float scale) {
  using P = typename std::conditional<kQ8, int8_t, T>::type;
  const int row = blockIdx.x;
  const int kvh = blockIdx.y;
  const int n = min(context_lens[row], page * pages_per_seq);
  if (n <= 0) return;                          // no key: keeps the zeros
  const int* bt = block_tables + (size_t)row * pages_per_seq;

  extern __shared__ __align__(16) float smem[];
  float* qsm = smem;                           // [kG][d], rows >= group 0
  float* wm = qsm + kG * d;                    // [kWarps][kG] warp maxima
  float* wl = wm + kWarps * kG;                // [kWarps][kG] warp sums
  float* part = wl + kWarps * kG;              // [kWarps][group][d]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // the group's query heads kvh*group .. are contiguous in q's row
  const T* qrow = q + ((size_t)row * n_heads + (size_t)kvh * group) * d;
  for (int i = tid; i < kG * d; i += kThreads)
    qsm[i] = i < group * d ? to_f32(qrow[i]) : 0.f;
  __syncthreads();

  float m[kG], l[kG], acc[kG][kR];
#pragma unroll
  for (int i = 0; i < kG; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[i][r] = 0.f;
  }

  constexpr int kVec = 16 / (int)sizeof(P);    // pool values a 16-byte load
  const int n_vec = d / kVec;
  const size_t head_base = (size_t)kvh * total_pages;
  const P* kp = static_cast<const P*>(k_pages);
  const P* vp = static_cast<const P*>(v_pages);

  for (int c0 = warp * kChunk; c0 < n; c0 += kWarps * kChunk) {
    const int t = c0 + lane;
    const bool valid = t < n;
    long long slot = 0;
    float s[kG];
#pragma unroll
    for (int i = 0; i < kG; ++i) s[i] = 0.f;
    if (valid) {
      const int pg = min(max(bt[t / page], 0), total_pages - 1);
      slot = (long long)(head_base + pg) * page + (t % page);
      const float k_s = kQ8 ? k_scales[slot] : 1.f;
      const uint4* krow = reinterpret_cast<const uint4*>(kp + slot * d);
#pragma unroll 2
      for (int v = 0; v < n_vec; ++v) {
        const uint4 raw = krow[v];
        const P* x = reinterpret_cast<const P*>(&raw);
        float kf[kVec];
#pragma unroll
        for (int w = 0; w < kVec; ++w)     // _dequant: q8 * s, in f32
          kf[w] = kQ8 ? to_f32(x[w]) * k_s : to_f32(x[w]);
#pragma unroll
        for (int i = 0; i < kG; ++i) {
          const float4* q4 =
              reinterpret_cast<const float4*>(qsm + i * d + v * kVec);
#pragma unroll
          for (int w4 = 0; w4 < kVec / 4; ++w4) {
            const float4 qv = q4[w4];       // broadcast read
            s[i] += qv.x * kf[4 * w4] + qv.y * kf[4 * w4 + 1] +
                    qv.z * kf[4 * w4 + 2] + qv.w * kf[4 * w4 + 3];
          }
        }
      }
    }

    float p[kG];
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      const float si = valid ? s[i] * scale : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(si));
      const float safe_m = isfinite(m_new) ? m_new : 0.f;
      const float alpha = isfinite(m[i]) ? expf(m[i] - safe_m) : 0.f;
      p[i] = valid ? expf(si - safe_m) : 0.f;
      l[i] = l[i] * alpha + warp_sum(p[i]);
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[i][r] *= alpha;
      m[i] = m_new;
    }

    // acc[i][r] += sum_j p_j V[j][lane + 32 r]; keys past n add nothing
    const int nk = min(kChunk, n - c0);        // warp-uniform
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      const long long sj = __shfl_sync(0xffffffffu, slot, j);
      const float v_s = kQ8 ? v_scales[sj] : 1.f;
      const P* vrow = vp + sj * d;
      float vv[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int e = lane + 32 * r;
        vv[r] = e < d ? (kQ8 ? to_f32(vrow[e]) * v_s : to_f32(vrow[e]))
                      : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kG; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
        for (int r = 0; r < kR; ++r) acc[i][r] += pj * vv[r];
      }
    }
  }

  // merge the warps: rescale each to the block's max, then sum in order
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kG; ++i) wm[warp * kG + i] = m[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kG; ++i) {
    float mb = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, wm[w * kG + i]);
    const float safe_m = isfinite(mb) ? mb : 0.f;
    const float c = isfinite(m[i]) ? expf(m[i] - safe_m) : 0.f;
    if (lane == 0) wl[warp * kG + i] = l[i] * c;
    if (i < group) {
      float* dst = part + ((size_t)warp * group + i) * d;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int e = lane + 32 * r;
        if (e < d) dst[e] = acc[i][r] * c;
      }
    }
  }
  __syncthreads();
  T* orow = out + ((size_t)row * n_heads + (size_t)kvh * group) * d;
  for (int idx = tid; idx < group * d; idx += kThreads) {
    const int i = idx / d;
    float a = 0.f, lb = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      a += part[(size_t)w * group * d + idx];
      lb += wl[w * kG + i];
    }
    store_as(orow + idx, a / (lb == 0.f ? 1.f : lb));
  }
}

template <typename T, bool kQ8, int kG, int kR>
cudaError_t launch_g(const void* q, const void* k_pages, const void* v_pages,
                     const float* k_scales, const float* v_scales,
                     const int* block_tables, const int* context_lens,
                     void* out, int n_rows, int n_heads, int n_kv, int d,
                     int total_pages, int page, int pages_per_seq,
                     float scale, cudaStream_t stream) {
  const int group = n_heads / n_kv;
  const size_t smem =
      (size_t)(kG * d + 2 * kWarps * kG + kWarps * group * d) * sizeof(float);
  auto kernel = paged_decode_kernel<T, kQ8, kG, kR>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_rows, n_kv);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), k_pages, v_pages, k_scales, v_scales,
      block_tables, context_lens, static_cast<T*>(out), n_heads, d,
      total_pages, page, pages_per_seq, group, scale);
  return cudaGetLastError();
}

template <typename T, bool kQ8, int kR>
cudaError_t launch_r(const void* q, const void* k_pages, const void* v_pages,
                     const float* k_scales, const float* v_scales,
                     const int* block_tables, const int* context_lens,
                     void* out, int n_rows, int n_heads, int n_kv, int d,
                     int total_pages, int page, int pages_per_seq,
                     float scale, cudaStream_t stream) {
  const int group = n_heads / n_kv;
#define PA_LAUNCH_G(G)                                                      \
  return launch_g<T, kQ8, G, kR>(q, k_pages, v_pages, k_scales, v_scales,  \
                                 block_tables, context_lens, out, n_rows,  \
                                 n_heads, n_kv, d, total_pages, page,      \
                                 pages_per_seq, scale, stream)
  if (group <= 1) PA_LAUNCH_G(1);
  if (group <= 2) PA_LAUNCH_G(2);
  if (group <= 4) PA_LAUNCH_G(4);
  if (group <= 8) PA_LAUNCH_G(8);
  if (group <= 16) PA_LAUNCH_G(16);
#undef PA_LAUNCH_G
  return cudaErrorInvalidValue;
}

template <typename T, bool kQ8>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const float* k_scales, const float* v_scales,
                   const int* block_tables, const int* context_lens,
                   void* out, int n_rows, int n_heads, int n_kv, int d,
                   int total_pages, int page, int pages_per_seq, float scale,
                   cudaStream_t stream) {
  if (d <= 128)
    return launch_r<T, kQ8, 4>(q, k_pages, v_pages, k_scales, v_scales,
                               block_tables, context_lens, out, n_rows,
                               n_heads, n_kv, d, total_pages, page,
                               pages_per_seq, scale, stream);
  return launch_r<T, kQ8, 8>(q, k_pages, v_pages, k_scales, v_scales,
                             block_tables, context_lens, out, n_rows, n_heads,
                             n_kv, d, total_pages, page, pages_per_seq, scale,
                             stream);
}

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronise, allocates nothing. The
// caller has checked shapes, dtypes, contiguity and 16-byte alignment, that
// d is a multiple of 8 and at most 256, the page size a multiple of 8, and
// that n_heads / n_kv <= 16. q, the pools and out are bf16 (is_bf16) or
// f32. Returns the CUDA error of the launch (0 on success).
int pa_launch(const void* q, const void* k_pages, const void* v_pages,
              const int* block_tables, const int* context_lens, void* out,
              int n_rows, int n_heads, int n_kv, int d, int total_pages,
              int page, int pages_per_seq, float scale, int is_bf16,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16, false>(
        q, k_pages, v_pages, nullptr, nullptr, block_tables, context_lens,
        out, n_rows, n_heads, n_kv, d, total_pages, page, pages_per_seq,
        scale, s);
  return (int)launch<float, false>(
      q, k_pages, v_pages, nullptr, nullptr, block_tables, context_lens, out,
      n_rows, n_heads, n_kv, d, total_pages, page, pages_per_seq, scale, s);
}

// The same over an int8 pool: k8/v8 int8 [n_kv, total_pages, page, d] and
// their scales ks/vs f32 [n_kv, total_pages, page]; q and out bf16
// (is_bf16) or f32. The caller has also checked that d is a multiple of 16.
int pa_q8_launch(const void* q, const void* k8, const float* ks,
                 const void* v8, const float* vs, const int* block_tables,
                 const int* context_lens, void* out, int n_rows, int n_heads,
                 int n_kv, int d, int total_pages, int page,
                 int pages_per_seq, float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16, true>(
        q, k8, v8, ks, vs, block_tables, context_lens, out, n_rows, n_heads,
        n_kv, d, total_pages, page, pages_per_seq, scale, s);
  return (int)launch<float, true>(
      q, k8, v8, ks, vs, block_tables, context_lens, out, n_rows, n_heads,
      n_kv, d, total_pages, page, pages_per_seq, scale, s);
}

const char* pa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
