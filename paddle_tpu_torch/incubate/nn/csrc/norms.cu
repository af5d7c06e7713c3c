// Row norms for Hopper (sm_90a): RMSNorm (with or without a bias) and
// LayerNorm over the last axis of an [n, d] tensor.
//
// Replaces the TPU kernels `_rms_kernel`, `_rms_kernel_bias` and
// `_ln_kernel` of paddle_tpu/incubate/nn/pallas/norms.py, reached there
// through `_rowwise_call`. Same function, row by row:
//
//   RMSNorm   out = x * rsqrt(mean(x^2) + eps) * w  (+ b)
//   LayerNorm out = (x - mu) * rsqrt(mean((x - mu)^2) + eps) * w + b
//
// Statistics are f32 whatever the input type, and LayerNorm takes two
// passes over the row as the TPU kernel does (the mean, then the mean of
// the centred squares), never E[x^2] - E[x]^2. The output is rounded to the
// input type once.
//
// What bounds it: a row of d values is read once and written once, with
// about 4 flops per value; at < 1 flop per byte the kernel is bound by the
// bytes it moves (x in, out back, w and b once), nowhere near the card's
// operations.
//
// What the design does about that:
// * Rows are independent: one block owns one row, so n rows are n blocks
//   and nothing crosses blocks. The block has 32-1024 threads, sized so
//   that each thread holds at most kMaxIters vectors of 8 values (256
//   threads x 2 vectors at d = 4096, 128 x 2 at d = 2048).
// * The row is read from device memory once, 16 bytes a load, into f32
//   registers, and both passes and the output are computed from there.
// * Each sum is a warp-shuffle reduction, then one across the block's
//   warps through 32 floats of shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;            // values a thread loads per step
constexpr int kMaxIters = 4;       // steps a thread keeps in registers
constexpr int kMaxThreads = 1024;  // so d <= 1024 * 4 * 8 = 32768

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// Sum of x over the block; every thread gets it. `red` holds 32 floats.
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float t = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  __syncthreads();                             // red is reused next call
  return t;
}

// kBias: add b after the scale. kCentre: LayerNorm (subtract the mean).
template <typename T, bool kBias, bool kCentre>
__global__ void __launch_bounds__(kMaxThreads)
row_norm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ b, T* __restrict__ out, int d,
                float eps) {
  __shared__ float red[32];
  const size_t base = (size_t)blockIdx.x * d;
  const int n_vec = d / kVec;
  const float inv_d = 1.f / (float)d;

  float v[kMaxIters][kVec];
  float sum = 0.f;
#pragma unroll
  for (int it = 0; it < kMaxIters; ++it) {
    const int i = threadIdx.x + it * blockDim.x;
    if (i < n_vec) {
      load8(x + base + (size_t)i * kVec, v[it]);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        sum += kCentre ? v[it][e] : v[it][e] * v[it][e];
    }
  }
  float mu = 0.f;
  if (kCentre) {                               // second pass, centred
    mu = block_sum(sum, red) * inv_d;
    sum = 0.f;
#pragma unroll
    for (int it = 0; it < kMaxIters; ++it) {
      if (threadIdx.x + it * blockDim.x < n_vec) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float c = v[it][e] - mu;
          sum += c * c;
        }
      }
    }
  }
  const float inv = rsqrtf(block_sum(sum, red) * inv_d + eps);

#pragma unroll
  for (int it = 0; it < kMaxIters; ++it) {
    const int i = threadIdx.x + it * blockDim.x;
    if (i < n_vec) {
      float wv[kVec], bv[kVec], y[kVec];
      load8(w + (size_t)i * kVec, wv);
      if (kBias) load8(b + (size_t)i * kVec, bv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        y[e] = (v[it][e] - mu) * inv * wv[e];
        if (kBias) y[e] += bv[e];
      }
      store8(out + base + (size_t)i * kVec, y);
    }
  }
}

int threads_for(int d) {
  const int n_vec = d / kVec;
  int t = (n_vec + 1) / 2;                     // two vectors a thread
  t = ((t + 31) / 32) * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* out,
                   int n, int d, float eps, int kind, cudaStream_t stream) {
  const dim3 grid(n), block(threads_for(d));
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(b);
  T* op = static_cast<T*>(out);
  if (kind == 0)
    row_norm_kernel<T, false, false><<<grid, block, 0, stream>>>(
        xp, wp, bp, op, d, eps);
  else if (kind == 1)
    row_norm_kernel<T, true, false><<<grid, block, 0, stream>>>(
        xp, wp, bp, op, d, eps);
  else
    row_norm_kernel<T, true, true><<<grid, block, 0, stream>>>(
        xp, wp, bp, op, d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// kind: 0 RMSNorm, 1 RMSNorm + bias, 2 LayerNorm. Launches on `stream`,
// does not synchronise, allocates nothing. The caller has checked that x
// and out are contiguous [n, d], w (and b) contiguous [d], all of one type
// and 16-byte aligned, d a multiple of 8 and at most 32768, and n >= 1.
// Returns the CUDA error of the launch (0 on success).
int norm_launch(const void* x, const void* w, const void* b, void* out,
                int n, int d, float eps, int kind, int is_bf16,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(x, w, b, out, n, d, eps, kind, s);
  return (int)launch<float>(x, w, b, out, n, d, eps, kind, s);
}

const char* norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
