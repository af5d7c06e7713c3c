// Ring steps between the cards of a ring of devices on Hopper (sm_90a): K9
// (a TP ring step: copy to the neighbour overlapped with the GEMM) and K10
// (a ring shift).
//
// K9 replaces the TPU kernel `_pallas_mm_step` of
// paddle_tpu/fusion/overlap_mm.py (its `pl.pallas_call`), which `_agmm_impl`
// runs at every ring step but the last of the all-gather-matmul forward.
// One launch on rank r's card computes
//
//   partial = buf @ w        (buf [t, k] rows, w [k, n]; f32 accumulate,
//                             rounded once to the input type)
//   next    = buf            (stored into rank r+1's receive buffer)
//
// K10 replaces `_pallas_shift_impl` of
// paddle_tpu/distributed/pipeline/transport.py: rank r's tensor copied into
// rank (r + step) % size's buffer, the compiled pipeline's stage-boundary
// hop (forward step 1, backward step size - 1).
//
// On the TPU both kernels start a remote DMA to a logical device id
// (`make_async_remote_copy`). Here the receive buffer is ordinary memory of
// the neighbour's card, allocated by the caller, and the kernel stores into
// it through a peer pointer (unified addressing, `cudaDeviceEnablePeerAccess`
// done once per pair by `ring_enable_peer`), so the copy runs over NVLink
// from the SMs of the sending card. When two ranks share one card the
// "remote" buffer is another buffer of the same card: the same code path,
// a local copy. The caller orders the streams across cards (the receive
// buffer's stream before the write, the write before the receiver's reads);
// the kernels synchronise nothing and allocate nothing.
//
// What bounds them on an H100. K9 at bench.py's TP shape (mp 2: buf [8192,
// 4096], w [4096, 512]) does 34.4 GFLOP a rank: in f32, outside the tensor
// cores, 0.513 ms at 67 TFLOP/s, against 0.298 ms for its 134 MB over
// NVLink (450 GB/s each way) or 0.080 ms for a local copy's 268 MB of reads
// and writes: bound by operations. In bf16 the product is 0.035 ms of
// tensor-core time and the 67 MB copy 0.149 ms over NVLink: bound by the
// link. K10 at bench.py's pipeline leg moves 8.4 MB ([1, 1024, 2048] f32):
// 0.019 ms over NVLink, 0.005 ms as a local copy: bound by bytes, and at
// that size by its launch.
//
// What the simple design does about it. K9 is one launch whose first blocks
// copy and whose other blocks compute, so the copy overlaps the product
// inside one kernel as the Pallas kernel overlapped its DMA with the MXU:
// the copy blocks are scheduled first (lowest block ids) and stream `buf` in
// 16-byte loads and stores, four in flight a thread, while the GEMM blocks
// fill the rest of the card. The GEMM is K8's tile (moe_dispatch.cu, copied
// and not shared, so that K8 does not change): one 8-warp block computes a
// 128 x 128 output tile in bf16 on the tensor cores (WMMA 16x16x16, f32
// accumulate, K in 32-deep tiles double-buffered with cp.async) or a
// 128 x 64 tile in f32 as FFMA loops, plus a row bound, since t need not be
// a multiple of 128. One copy block per MiB of `buf`, at most 128. The copy
// is pure data movement and bit-exact. K10 is the same copy on a
// grid-stride loop, plus a byte tail for sizes that are not a multiple of 16
// bytes. Not done yet (later work): wgmma and TMA for the product, a tuned
// split between copy and GEMM blocks, and the copy engine for K10.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kBM = 128;                 // rows of an output tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;               // 16-byte loads in flight a thread

// bf16: a 128 x 128 tile, K in steps of 32; rows padded by 16 bytes so that
// each 16x16 fragment starts 32-byte aligned, as WMMA needs.
constexpr int kBN16 = 128, kBK16 = 32;
constexpr int kLdA16 = kBK16 + 8;        // [128][40] bf16
constexpr int kLdB16 = kBN16 + 8;        // [32][136] bf16
// f32: a 128 x 64 tile, K in steps of 16; A is kept transposed ([k][m]).
constexpr int kBN32 = 64, kBK32 = 16;
constexpr int kLdA32 = kBM + 4;          // [16][132] f32

// n16 chunks of 16 bytes from src to dst, shared out over `nblk` blocks of
// which this is block `blk`: kUnroll loads in flight before their stores.
__device__ __forceinline__ void copy16(uint4* __restrict__ dst,
                                       const uint4* __restrict__ src,
                                       size_t n16, size_t blk, size_t nblk) {
  const size_t stride = nblk * kThreads;
  size_t i = blk * kThreads + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n16; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = src[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dst[i + u * stride] = v[u];
  }
  for (; i < n16; i += stride) dst[i] = src[i];
}

// 16 bytes from device memory into shared memory, or 16 zero bytes when
// `valid` is false (the source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Output tile (tm, tn) of a [t, k] @ w [k, n], bf16 in and out.
__device__ void mm_tile(const bf16* __restrict__ a, const bf16* __restrict__ w,
                        bf16* __restrict__ out, int t, int k, int n, int tm,
                        int tn) {
  __shared__ __align__(128) bf16 a_s[2][kBM * kLdA16];
  __shared__ __align__(128) bf16 b_s[2][kBK16 * kLdB16];
  __shared__ __align__(128) float stage[kWarps][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2;              // 64-row half of the tile
  const int wn = warp & 3;               // 32-column quarter of the tile
  const int row0 = tm * kBM;
  const int n0 = tn * kBN16;
  const bf16* a_g = a + (size_t)row0 * k;

  // 512 chunks of 8 values in each operand tile, two a thread
  auto load = [&](int kt, int buf) {
    const int k0 = kt * kBK16;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int ra = c >> 2, ca = (c & 3) * 8;          // A: 128 x 4 chunks
      const bool oka = row0 + ra < t && k0 + ca < k;
      cp_async16(&a_s[buf][ra * kLdA16 + ca],
                 oka ? a_g + (size_t)ra * k + k0 + ca : a, oka);
      const int rb = c >> 4, cb = (c & 15) * 8;         // B: 32 x 16 chunks
      const bool okb = k0 + rb < k && n0 + cb < n;
      cp_async16(&b_s[buf][rb * kLdB16 + cb],
                 okb ? w + (size_t)(k0 + rb) * n + n0 + cb : w, okb);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (k + kBK16 - 1) / kBK16;
  load(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      load(kt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK16; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(
            af[i], &a_s[buf][(wm * 64 + i * 16) * kLdA16 + kk], kLdA16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(
            bfr[j], &b_s[buf][kk * kLdB16 + wn * 32 + j * 16], kLdB16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();                     // the next load reuses this buffer
  }

  // each fragment through the warp's 16x16 f32 stage: a lane rounds 8
  // values of one row to bf16 and stores them as one 16-byte write
  float* st = stage[warp];
  const int r = lane >> 1, c = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int col = n0 + wn * 32 + j * 16 + c;
      const int row = row0 + wm * 64 + i * 16 + r;
      if (col < n && row < t) {
        const float* v = st + r * 16 + c;
        uint4 raw;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
        *reinterpret_cast<uint4*>(out + (size_t)row * n + col) = raw;
      }
      __syncwarp();
    }
  }
}

// Output tile (tm, tn) of a [t, k] @ w [k, n], f32 in and out.
__device__ void mm_tile(const float* __restrict__ a,
                        const float* __restrict__ w, float* __restrict__ out,
                        int t, int k, int n, int tm, int tn) {
  __shared__ __align__(16) float a_s[kBK32][kLdA32];
  __shared__ __align__(16) float b_s[kBK32][kBN32];

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;   // rows 8 ty.., columns 4 tx..
  const int row0 = tm * kBM;
  const int n0 = tn * kBN32;
  const float* a_g = a + (size_t)row0 * k;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK32) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {          // A: 128 rows x 4 chunks of 4
      const int ch = tid + i * kThreads;
      const int ra = ch >> 2, ka = (ch & 3) * 4;
      const float4 v = row0 + ra < t && k0 + ka < k
          ? *reinterpret_cast<const float4*>(a_g + (size_t)ra * k + k0 + ka)
          : zero;
      a_s[ka][ra] = v.x;
      a_s[ka + 1][ra] = v.y;
      a_s[ka + 2][ra] = v.z;
      a_s[ka + 3][ra] = v.w;
    }
    {                                      // B: 16 rows x 16 chunks of 4
      const int rb = tid >> 4, cb = (tid & 15) * 4;
      const float4 v = k0 + rb < k && n0 + cb < n
          ? *reinterpret_cast<const float4*>(w + (size_t)(k0 + rb) * n +
                                             n0 + cb)
          : zero;
      *reinterpret_cast<float4*>(&b_s[rb][cb]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK32; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[kk][ty * 8]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&a_s[kk][ty * 8 + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int col = n0 + tx * 4;
  if (col < n) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + ty * 8 + i;
      if (row < t)
        *reinterpret_cast<float4*>(out + (size_t)row * n + col) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// K9: blocks [0, copy_blocks) copy buf into the neighbour's buffer `next`;
// block copy_blocks + j computes output tile (j / tiles_n, j % tiles_n), so
// consecutive GEMM blocks walk the columns of one row block and share its
// rows in L2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_mm_step_kernel(const T* __restrict__ buf, const T* __restrict__ w,
                    T* __restrict__ partial, T* __restrict__ next, int t,
                    int k, int n, int copy_blocks, int tiles_n) {
  const int b = blockIdx.x;
  if (b < copy_blocks) {
    copy16(reinterpret_cast<uint4*>(next),
           reinterpret_cast<const uint4*>(buf),
           (size_t)t * k * sizeof(T) / 16, b, copy_blocks);
    return;
  }
  const int j = b - copy_blocks;
  mm_tile(buf, w, partial, t, k, n, j / tiles_n, j % tiles_n);
}

// K10: nbytes from src into the neighbour's buffer dst.
__global__ void __launch_bounds__(kThreads)
ring_shift_kernel(const unsigned char* __restrict__ src,
                  unsigned char* __restrict__ dst, size_t nbytes) {
  const size_t n16 = nbytes / 16;
  copy16(reinterpret_cast<uint4*>(dst), reinterpret_cast<const uint4*>(src),
         n16, blockIdx.x, gridDim.x);
  const size_t tail = nbytes - n16 * 16;
  if (blockIdx.x == 0 && threadIdx.x < tail)
    dst[n16 * 16 + threadIdx.x] = src[n16 * 16 + threadIdx.x];
}

template <typename T>
cudaError_t launch_mm_step(const void* buf, const void* w, void* partial,
                           void* next, int t, int k, int n,
                           cudaStream_t stream) {
  const int bn = std::is_same<T, bf16>::value ? kBN16 : kBN32;
  const int tiles_m = (t + kBM - 1) / kBM, tiles_n = (n + bn - 1) / bn;
  const size_t mib = (size_t)t * k * sizeof(T) >> 20;
  const int copy_blocks = mib < 1 ? 1 : (mib > 128 ? 128 : (int)mib);
  ring_mm_step_kernel<T><<<copy_blocks + tiles_m * tiles_n, kThreads, 0,
                           stream>>>(
      static_cast<const T*>(buf), static_cast<const T*>(w),
      static_cast<T*>(partial), static_cast<T*>(next), t, k, n, copy_blocks,
      tiles_n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K9 on `stream` (of buf's card, which must be current): partial [t, n] =
// buf [t, k] @ w [k, n] (f32 accumulate, rounded to the input type) and
// next [t, k] = buf, where `next` may lie on another card that this one has
// peer access to. Does not synchronise, allocates nothing. The caller has
// checked that buf, w, partial and next are contiguous, of one type (bf16 or
// f32), 16-byte aligned, that next does not overlap buf, t >= 1, and k and n
// positive multiples of 8. Returns the CUDA error of the launch (0 on
// success).
int ring_mm_step_launch(const void* buf, const void* w, void* partial,
                        void* next, int t, int k, int n, int is_bf16,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch_mm_step<bf16>(buf, w, partial, next, t, k, n, s);
  return (int)launch_mm_step<float>(buf, w, partial, next, t, k, n, s);
}

// K10 on `stream` (of src's card, which must be current): nbytes of src into
// dst, which may lie on another card that this one has peer access to. Both
// 16-byte aligned, not overlapping, nbytes >= 1. Returns the CUDA error of
// the launch.
int ring_shift_launch(const void* src, void* dst, long long nbytes,
                      void* stream) {
  const size_t n = static_cast<size_t>(nbytes);
  const size_t per_block = (size_t)kThreads * kUnroll * 16;
  size_t blocks = (n + per_block - 1) / per_block;
  blocks = blocks < 1 ? 1 : (blocks > 1024 ? 1024 : blocks);
  ring_shift_kernel<<<(unsigned)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src),
      static_cast<unsigned char*>(dst), n);
  return (int)cudaGetLastError();
}

// Let kernels on card `dev` read and write card `peer`'s memory. Peer access
// that is already enabled (PyTorch's own copies may have done it) counts as
// success. Restores the current device. Returns the CUDA error.
int ring_enable_peer(int dev, int peer) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();                  // clear it: not a failure here
    err = cudaSuccess;
  }
  const cudaError_t back = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : back);
}

const char* ring_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
