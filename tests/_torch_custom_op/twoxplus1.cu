// twoxplus1: y = x * 2 + 1, elementwise, in x's type (f32, bf16, f16).
//
// Replaces the Pallas kernel of the custom-op registry's test fixture,
// tests/test_custom_op.py `twoxplus1` (its `pl.pallas_call` of
// `_kernel`: `o_ref[...] = x_ref[...] * 2.0 + 1.0`), which shows that a
// hand-written kernel registers like any custom op. Registered the same
// way in the port: tests/_torch_custom_op/twoxplus1.py wraps this
// library and `paddle_tpu_torch.utils.register_op` mounts the wrapper.
//
// Bound by bytes: one read and one write an element, no reuse (2 x 4
// bytes an f32 element against one FMA). The design is the plainest
// that streams at the memory's rate: a grid-stride loop over 16-byte
// vectors (4 f32 or 8 bf16 / f16 a load and a store), a few blocks an
// SM, and a scalar loop for the tail past the last whole vector (and
// for all of a pointer that is not 16-byte aligned). Each element is
// fmaf(x, 2, 1) in f32: x * 2 is exact, so the one rounding of the fma
// (then the one to bf16 / f16) is the rounding PyTorch's `x * 2 + 1`
// does, bit for bit.
//
// C interface (ctypes): twoxplus1_launch(x, y, n, dtype, stream) with
// dtype 0 f32, 1 bf16, 2 f16; returns the cudaError_t of the launch.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

template <typename T>
__device__ __forceinline__ T twoxplus1(T x) {
  return from_f32<T>(fmaf(to_f32(x), 2.0f, 1.0f));
}

template <typename T>
__global__ void __launch_bounds__(256)
twoxplus1_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                 long long n_vec) {
  constexpr int kVec = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  for (long long i = first; i < n_vec; i += stride) {
    uint4 v = xv[i];
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) e[j] = twoxplus1(e[j]);
    yv[i] = v;
  }
  for (long long i = n_vec * kVec + first; i < n; i += stride)
    y[i] = twoxplus1(x[i]);
}

template <typename T>
cudaError_t launch(const void* x, void* y, long long n, cudaStream_t s) {
  constexpr int kThreads = 256, kVec = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  const long long n_vec = aligned ? n / kVec : 0;
  const long long items = n_vec > 0 ? n_vec : n;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // enough blocks for every vector up to 8 resident a SM; the grid-stride
  // loop takes the rest
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  if (blocks < 1) blocks = 1;
  twoxplus1_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, n_vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" int twoxplus1_launch(const void* x, void* y, long long n,
                                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(x, y, n, s);
    case 1: return (int)launch<__nv_bfloat16>(x, y, n, s);
    case 2: return (int)launch<__half>(x, y, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* twoxplus1_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
