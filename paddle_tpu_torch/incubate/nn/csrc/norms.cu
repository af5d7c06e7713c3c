// Row norms for Hopper (sm_90a): RMSNorm (with or without a bias) and
// LayerNorm over the last axis of an [n, d] tensor, each optionally after
// adding a bias and a residual to its input (the fused form).
//
// Replaces the TPU kernels `_rms_kernel`, `_rms_kernel_bias` and
// `_ln_kernel` of paddle_tpu/incubate/nn/pallas/norms.py, reached there
// through `_rowwise_call`, and with them the adds in front of them in
// paddle_tpu/incubate/nn/functional/fused_ops.py (`fused_rms_norm`,
// `fused_layer_norm` with `bias=` and `residual=`). Same function, row by
// row:
//
//   s         = round(round(y + bias) + residual)    (fused form; else y)
//   RMSNorm   out = s * rsqrt(mean(s^2) + eps) * w  (+ b)
//   LayerNorm out = (s - mu) * rsqrt(mean((s - mu)^2) + eps) * w + b
//
// Each add is taken in f32 and rounded to the input type, as PyTorch adds
// two tensors of that type, so the sum (a second output) is bitwise the
// unfused adds'. Statistics are f32 and taken from the rounded sum;
// LayerNorm's variance is centred, never E[s^2] - E[s]^2 (two exchanges:
// the mean, then the centred squares, from the row held in registers).
// The output is rounded once.
//
// What bounds it: a row of d values is read once (twice with a residual)
// and written once (twice), at ~4 flops a value: bytes, far from the
// card's operations. At a serving step's rows (1-136, 4-16 KB a row) a
// call is bound by latency instead: its launch, one round trip to memory,
// the exchange.
//
// What the design does about that:
// * Every load a row needs (y and the residual first, then w, b and the
//   added bias) is issued before the row's first exchange, so one memory
//   round trip sits on the critical path. An exchange across the block's
//   warps takes one __syncthreads: its slots are double-buffered, so
//   consecutive exchanges never wait for the readers of the previous one.
//   (Chan's merge of per-thread centred statistics in one exchange, and
//   programmatic dependent launch, measured slower: tools/norm_ab.py.)
// * Two forms by n, one kernel. Up to one wave of the persistent form's
//   resident blocks (SMs x blocks an SM), a block a row, one vector of 8
//   values a thread (512 threads at d = 4096, 256 at 2048: the shortest
//   latency). Past it, a persistent grid of one wave, each block walking
//   ceil(n / grid) rows with two vectors a thread (256 / 128 threads):
//   the next row's loads are issued before the current row's exchange
//   and stores, so loads stay in flight while a block reduces, and bf16
//   RMSNorm keeps w in registers across the block's rows.
// * A thread holds kIters vectors of 8 values (16-byte loads), doubled
//   while the row would need more than 512 threads, up to 4 (1024
//   threads at d = 32768, 64 registers: no prefetch, and w and b read
//   after the exchange, as they are used).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kVec = 8;             // values a thread loads per step
constexpr int kVecsRows = 1;        // vectors a thread, a block a row
constexpr int kVecsPersistent = 2;  // and in the persistent form
constexpr int kNarrowThreads = 512; // past this, 4 vectors a thread
constexpr int kCrossWaves = 1;      // a block a row up to this many waves

// Eight values of T as they sit in memory: one 16-byte load for bf16, two
// for f32.
template <typename T>
struct Pack {
  uint4 u[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ Pack<T> ld(const T* p) {
  Pack<T> r;
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i) r.u[i] = q[i];
  return r;
}

template <typename T>
__device__ __forceinline__ void st(T* p, const Pack<T>& r) {
  uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i) q[i] = r.u[i];
}

__device__ __forceinline__ void unpack(const Pack<__nv_bfloat16>& r,
                                       float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(r.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const Pack<float>& r, float* v) {
  const float* f = reinterpret_cast<const float*>(r.u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = f[i];
}

__device__ __forceinline__ Pack<__nv_bfloat16> pack_bf16(const float* v) {
  Pack<__nv_bfloat16> r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(r.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i],
                                                           v[2 * i + 1]);
  return r;
}

__device__ __forceinline__ Pack<float> pack_f32(const float* v) {
  Pack<float> r;
  float* f = reinterpret_cast<float*>(r.u);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = v[i];
  return r;
}

template <typename T>
__device__ __forceinline__ Pack<T> pack(const float* v);
template <>
__device__ __forceinline__ Pack<__nv_bfloat16> pack<__nv_bfloat16>(
    const float* v) {
  return pack_bf16(v);
}
template <>
__device__ __forceinline__ Pack<float> pack<float>(const float* v) {
  return pack_f32(v);
}

// a + b in f32, rounded to T as PyTorch's add of two T tensors rounds
template <typename T>
__device__ __forceinline__ float add_round(float a, float b);
template <>
__device__ __forceinline__ float add_round<__nv_bfloat16>(float a, float b) {
  return __bfloat162float(__float2bfloat16_rn(a + b));
}
template <>
__device__ __forceinline__ float add_round<float>(float a, float b) {
  return a + b;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sum of x over the block, in every thread; one __syncthreads. `slot`
// holds 32 floats and is not written again before the next exchange's
// __syncthreads (the caller alternates two slots).
__device__ __forceinline__ float block_sum(float x, float* slot) {
  x = warp_sum(x);
  const int lane = threadIdx.x & 31;
  if (lane == 0) slot[threadIdx.x >> 5] = x;
  __syncthreads();
  return warp_sum(lane < (int)(blockDim.x >> 5) ? slot[lane] : 0.f);
}

struct Args {
  const void* y;      // [n, d] input (x of the plain form)
  const void* res;    // [n, d] residual or null
  const void* bias;   // [d] added to y first, or null
  const void* w;      // [d]
  const void* b;      // [d] norm bias (kKind 1, 2)
  void* out;          // [n, d]
  void* sum;          // [n, d] the rounded sum (with a residual)
  int n, d;
  float eps;
};

// kKind: 0 RMSNorm, 1 RMSNorm + b, 2 LayerNorm. kRes: a residual is added
// (and the sum written). The added bias is a runtime option (a.bias).
template <typename T, int kIters, int kKind, bool kRes>
__global__ void __launch_bounds__(kIters == 4 ? 1024 : kNarrowThreads)
row_norm_kernel(const Args a) {
  constexpr bool kCentre = kKind == 2;
  constexpr bool kNormBias = kKind != 0;
  // At <= 512 threads (kIters <= 2) every load of a row comes before its
  // exchange and the persistent form prefetches the next row; bf16
  // RMSNorm holds w across rows (with a norm bias, and in f32, the
  // registers cost more blocks an SM than reading them again from L1
  // saves). Wider rows (1024 threads, 64 registers) read w and b after
  // the exchange, as they are used.
  constexpr bool kPrefetch = kIters <= 2;
  constexpr bool kEarly = kIters <= 2;
  constexpr bool kHold = kEarly && sizeof(T) == 2 && !kNormBias;
  __shared__ float red[2][32];

  const T* __restrict__ y = static_cast<const T*>(a.y);
  const T* __restrict__ res = static_cast<const T*>(a.res);
  const T* __restrict__ bias = static_cast<const T*>(a.bias);
  const T* __restrict__ w = static_cast<const T*>(a.w);
  const T* __restrict__ b = static_cast<const T*>(a.b);
  T* __restrict__ out = static_cast<T*>(a.out);
  T* __restrict__ sum = static_cast<T*>(a.sum);
  const int d = a.d;
  const int n_vec = d / kVec;
  const float inv_d = 1.f / (float)d;
  const bool has_bias = bias != nullptr;

  Pack<T> pw[kIters], pb[kIters], pbias[kIters], px[kIters], pr[kIters];
  // the added bias (used before the exchange) and w, b (after it)
  auto load_bias = [&]() {
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = threadIdx.x + it * blockDim.x;
      if (has_bias && i < n_vec) pbias[it] = ld(bias + (size_t)i * kVec);
    }
  };
  auto load_wb = [&]() {
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = threadIdx.x + it * blockDim.x;
      if (i < n_vec) {
        pw[it] = ld(w + (size_t)i * kVec);
        if constexpr (kNormBias) pb[it] = ld(b + (size_t)i * kVec);
      }
    }
  };
  auto load_row = [&](int row, Pack<T>* lx, Pack<T>* lr) {
    const size_t base = (size_t)row * d;
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = threadIdx.x + it * blockDim.x;
      if (i < n_vec) {
        lx[it] = ld(y + base + (size_t)i * kVec);
        if constexpr (kRes) lr[it] = ld(res + base + (size_t)i * kVec);
      }
    }
  };

  int row = blockIdx.x;
  load_row(row, px, pr);       // the row first: its exchange waits for it
  if constexpr (kHold) {
    load_bias();
    load_wb();
  }
  int phase = 0;
  for (;;) {
    if constexpr (!kHold) load_bias();
    if constexpr (kEarly && !kHold) load_wb();
    const int next = row + gridDim.x;
    Pack<T> nx[kIters], nr[kIters];
    if (kPrefetch && next < a.n) load_row(next, nx, nr);
    const size_t base = (size_t)row * d;

    // s = round(round(y + bias) + residual), kept in f32 registers
    float v[kIters][kVec];
    float s1 = 0.f;
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = threadIdx.x + it * blockDim.x;
      if (i < n_vec) {
        unpack(px[it], v[it]);
        if (has_bias) {
          float t[kVec];
          unpack(pbias[it], t);
#pragma unroll
          for (int e = 0; e < kVec; ++e) v[it][e] = add_round<T>(v[it][e],
                                                                 t[e]);
        }
        if constexpr (kRes) {
          float t[kVec];
          unpack(pr[it], t);
#pragma unroll
          for (int e = 0; e < kVec; ++e) v[it][e] = add_round<T>(v[it][e],
                                                                 t[e]);
          st(sum + base + (size_t)i * kVec, pack<T>(v[it]));
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          s1 += (kCentre ? v[it][e] : v[it][e] * v[it][e]);
      }
    }

    float mu = 0.f, var;
    if constexpr (!kCentre) {
      var = block_sum(s1, red[phase]) * inv_d;
      phase ^= 1;
    } else {
      // two exchanges: the mean, then the centred squares
      mu = block_sum(s1, red[phase]) * inv_d;
      phase ^= 1;
      float M = 0.f;
#pragma unroll
      for (int it = 0; it < kIters; ++it) {
        if (threadIdx.x + it * blockDim.x < n_vec) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const float c = v[it][e] - mu;
            M += c * c;
          }
        }
      }
      var = block_sum(M, red[phase]) * inv_d;
      phase ^= 1;
    }
    const float inv = rsqrtf(var + a.eps);
    if constexpr (!kEarly) load_wb();

#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = threadIdx.x + it * blockDim.x;
      if (i < n_vec) {
        float wv[kVec], bv[kVec];
        unpack(pw[it], wv);
        if constexpr (kNormBias) unpack(pb[it], bv);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          v[it][e] = (v[it][e] - mu) * inv * wv[e];
          if constexpr (kNormBias) v[it][e] += bv[e];
        }
        st(out + base + (size_t)i * kVec, pack<T>(v[it]));
      }
    }
    if (next >= a.n) break;
    row = next;
    if constexpr (kPrefetch) {
#pragma unroll
      for (int it = 0; it < kIters; ++it) {
        px[it] = nx[it];
        if constexpr (kRes) pr[it] = nr[it];
      }
    } else {
      load_row(row, px, pr);
    }
  }
}

// Vectors a thread: `vecs`, doubled while the row would need more than
// kNarrowThreads threads (up to 4: 1024 threads at d = 32768).
int iters_for(int d, int vecs) {
  const int n_vec = d / kVec;
  int iters = vecs;
  while (iters < 4 && (n_vec + iters - 1) / iters > kNarrowThreads)
    iters *= 2;
  return iters;
}

int threads_for(int d, int iters) {
  const int t = ((d / kVec + iters - 1) / iters + 31) / 32 * 32;
  return t < 32 ? 32 : t;
}

template <typename T>
struct Type {
  using type = T;
};
template <int V>
using Int = std::integral_constant<int, V>;

// f(Type<T>, Int<kIters>, Int<kKind>, bool_constant<kRes>) for the
// kernel instance these runtime values name.
template <typename F>
cudaError_t visit(int is_bf16, int iters, int kind, bool res, F&& f) {
  auto by_res = [&](auto t, auto it, auto kd) {
    return res ? f(t, it, kd, std::true_type())
               : f(t, it, kd, std::false_type());
  };
  auto by_kind = [&](auto t, auto it) {
    switch (kind) {
      case 0: return by_res(t, it, Int<0>());
      case 1: return by_res(t, it, Int<1>());
      default: return by_res(t, it, Int<2>());
    }
  };
  auto by_iters = [&](auto t) {
    switch (iters) {
      case 1: return by_kind(t, Int<1>());
      case 2: return by_kind(t, Int<2>());
      default: return by_kind(t, Int<4>());
    }
  };
  return is_bf16 ? by_iters(Type<__nv_bfloat16>())
                 : by_iters(Type<float>());
}

// Resident blocks an SM of one instance at `threads`, cached.
template <typename T, int kIters, int kKind, bool kRes>
cudaError_t per_sm(int threads, int* out) {
  static int cache[1024 / 32 + 1];
  int& occ = cache[threads / 32];
  if (occ == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, row_norm_kernel<T, kIters, kKind, kRes>, threads, 0);
    if (e != cudaSuccess) return e;
    if (occ < 1) occ = 1;
  }
  *out = occ;
  return cudaSuccess;
}

cudaError_t sm_count(int* out) {
  static int cache[64];                 // by device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    e = cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
  }
  *out = cache[dev];
  return cudaSuccess;
}

struct Plan {
  int grid, threads, iters, persistent;
};

// The form: a block a row, kVecsRows vectors a thread, up to kCrossWaves
// waves of the persistent form's resident blocks; past that, one wave of
// blocks of kVecsPersistent vectors a thread, each walking ceil(n / wave)
// rows, the grid cut so that every block walks as many.
cudaError_t plan_of(int n, int d, int kind, bool res, int is_bf16,
                    Plan* p) {
  int sms = 0, occ = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const int iters = iters_for(d, kVecsPersistent);
  const int threads = threads_for(d, iters);
  e = visit(is_bf16, iters, kind, res, [&](auto t, auto it, auto kd,
                                           auto rs) {
    return per_sm<typename decltype(t)::type, decltype(it)::value,
                  decltype(kd)::value, decltype(rs)::value>(threads, &occ);
  });
  if (e != cudaSuccess) return e;
  const long long wave = (long long)sms * occ;
  if ((long long)n > wave * kCrossWaves) {
    const long long rows = ((long long)n + wave - 1) / wave;
    *p = Plan{(int)(((long long)n + rows - 1) / rows), threads, iters, 1};
  } else {
    const int it = iters_for(d, kVecsRows);
    *p = Plan{n, threads_for(d, it), it, 0};
  }
  return cudaSuccess;
}

template <typename T, int kIters, int kKind, bool kRes>
cudaError_t launch_instance(const Args& a, const Plan& p, cudaStream_t s) {
  row_norm_kernel<T, kIters, kKind, kRes><<<p.grid, p.threads, 0, s>>>(a);
  return cudaGetLastError();
}

cudaError_t launch(const Args& a, int kind, int is_bf16, cudaStream_t s) {
  Plan p;
  const bool res = a.res != nullptr;
  const cudaError_t e = plan_of(a.n, a.d, kind, res, is_bf16, &p);
  if (e != cudaSuccess) return e;
  return visit(is_bf16, p.iters, kind, res, [&](auto t, auto it, auto kd,
                                                auto rs) {
    return launch_instance<typename decltype(t)::type, decltype(it)::value,
                           decltype(kd)::value, decltype(rs)::value>(a, p, s);
  });
}

}  // namespace

extern "C" {

// kind: 0 RMSNorm, 1 RMSNorm + b, 2 LayerNorm. `bias` (added to y first)
// and `res` (added next; the sum then written to `sum`) may be null.
// Launches on `stream`, does not synchronise, allocates nothing. The
// caller has checked that y, res, out and sum are contiguous [n, d], w, b
// and bias contiguous [d], all of one type and 16-byte aligned, d a
// multiple of 8 and at most 32768, and n >= 1. Returns the CUDA error of
// the launch (0 on success).
int norm_launch(const void* y, const void* res, const void* bias,
                const void* w, const void* b, void* out, void* sum, int n,
                int d, float eps, int kind, int is_bf16, void* stream) {
  const Args a{y, res, bias, w, b, out, sum, n, d, eps};
  return (int)launch(a, kind, is_bf16, static_cast<cudaStream_t>(stream));
}

// What norm_launch would launch for these arguments: out[0] 1 for the
// persistent form (0: a block a row), out[1] blocks, out[2] threads a
// block, out[3] vectors of 8 values a thread. Returns a CUDA error.
int norm_plan(int n, int d, int kind, int has_res, int is_bf16, int* out) {
  Plan p{0, 0, 0, 0};
  const cudaError_t e = plan_of(n, d, kind, has_res != 0, is_bf16, &p);
  out[0] = p.persistent;
  out[1] = p.grid;
  out[2] = p.threads;
  out[3] = p.iters;
  return (int)e;
}

const char* norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
