// Block-aligned grouped GEMM for the sorted MoE dispatch on Hopper (sm_90a):
// K8.
//
// Replaces the TPU kernel `_gmm_kernel` of
// paddle_tpu/incubate/nn/pallas/moe_dispatch.py, reached there through
// `grouped_matmul` (its `pl.pallas_call`). Same function, block by block:
//
//   out[128 i : 128 (i + 1), :] = xp[128 i : 128 (i + 1), :] @ w[block_gid[i]]
//
// with xp [P, K] (P a multiple of 128), w [E, K, N], block_gid int32 [P/128],
// products summed in f32 and the output rounded to the input type once.
// `sort_dispatch` pads each expert's rows to whole 128-row blocks, so every
// row block belongs to one expert; the kernel reads nothing of the layout
// but the block's expert id, so block_gid may be in any order. An id
// outside [0, E) is clamped into it (the Pallas index map would read out of
// bounds; on the card that would read outside w), as K6 clamps block ids.
//
// What bounds it on an H100: at bench.py's MoE shape (8192 tokens x 2048,
// 8 experts, SwiGLU dff 2816, top-2; P = 17408) the first product does
// 2 * 16384 * 2048 * 5632 = 378 GFLOP over ~0.44 GB of real rows, weights
// and output: 0.38 ms of tensor-core time against 0.13 ms of memory time,
// so it is bound by operations (the second, K 2816 x N 2048, likewise). At
// a decode batch (8 tokens at Mixtral-8x7B's widths, P = 1152, nearly all
// padding) it is the other way round: each touched expert's weight slice
// (235 MB for the first product) is read for a handful of real rows, so
// the weight bytes bound it.
//
// What the simple design does about it: one block of 8 warps computes one
// 128-row x 128-column output tile of one expert (f32: 128 x 64), walking
// K in 32-deep tiles through shared memory, double-buffered with cp.async
// so the next tile's loads fly while the tensor cores work on this one;
// bf16 products run on the tensor cores through WMMA (16x16x16 fragments,
// f32 accumulate, each warp a 64 x 32 sub-tile), f32 products as plain
// FFMA loops (8 x 4 outputs a thread) so that f32 matches an f32 reference
// closely. Consecutive blocks walk the columns of one row block, so they
// share the block's rows and its expert's weight slice in L2. Loads are 16
// bytes a thread, so K and N must be multiples of 8 (the wrapper checks);
// a K tile past K is zero-filled by the copy itself, and columns past N are
// neither read nor written, so any N that is a multiple of 8 is covered
// (the Pallas grid needed N divisible by its column block). Not done yet
// (later work): skipping row blocks that hold only padding, which at a
// decode batch re-read a whole expert slice for zero rows; wgmma and TMA
// with a deeper ring of tiles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kBM = 128;                 // rows of a block: one row block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// bf16: a 128 x 128 tile, K in steps of 32; rows padded by 16 bytes so that
// each 16x16 fragment starts 32-byte aligned, as WMMA needs.
constexpr int kBN16 = 128, kBK16 = 32;
constexpr int kLdA16 = kBK16 + 8;        // [128][40] bf16
constexpr int kLdB16 = kBN16 + 8;        // [32][136] bf16
// f32: a 128 x 64 tile, K in steps of 16; A is kept transposed ([k][m]).
constexpr int kBN32 = 64, kBK32 = 16;
constexpr int kLdA32 = kBM + 4;          // [16][132] f32

__device__ __forceinline__ int expert_of(const int* __restrict__ block_gid,
                                         int e) {
  const int g = block_gid[blockIdx.y];
  return g < 0 ? 0 : (g >= e ? e - 1 : g);
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

__device__ void gmm_tile(const bf16* __restrict__ xp,
                         const bf16* __restrict__ w,
                         const int* __restrict__ block_gid,
                         bf16* __restrict__ out, int k, int n, int e) {
  __shared__ __align__(128) bf16 a_s[2][kBM * kLdA16];
  __shared__ __align__(128) bf16 b_s[2][kBK16 * kLdB16];
  __shared__ __align__(128) float stage[kWarps][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2;              // 64-row half of the tile
  const int wn = warp & 3;               // 32-column quarter of the tile
  const size_t row0 = (size_t)blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN16;
  const bf16* a_g = xp + row0 * k;
  const bf16* b_g = w + (size_t)expert_of(block_gid, e) * k * n;

  // 512 chunks of 8 values in each operand tile, two a thread
  auto load = [&](int kt, int buf) {
    const int k0 = kt * kBK16;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int ra = c >> 2, ca = (c & 3) * 8;          // A: 128 x 4 chunks
      const bool oka = k0 + ca < k;
      cp_async16(&a_s[buf][ra * kLdA16 + ca],
                 oka ? a_g + (size_t)ra * k + k0 + ca : a_g, oka);
      const int rb = c >> 4, cb = (c & 15) * 8;         // B: 32 x 16 chunks
      const bool okb = k0 + rb < k && n0 + cb < n;
      cp_async16(&b_s[buf][rb * kLdB16 + cb],
                 okb ? b_g + (size_t)(k0 + rb) * n + n0 + cb : b_g, okb);
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
      if (col < n) {
        const float* v = st + r * 16 + c;
        uint4 raw;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
        *reinterpret_cast<uint4*>(
            out + (row0 + wm * 64 + i * 16 + r) * n + col) = raw;
      }
      __syncwarp();
    }
  }
}

__device__ void gmm_tile(const float* __restrict__ xp,
                         const float* __restrict__ w,
                         const int* __restrict__ block_gid,
                         float* __restrict__ out, int k, int n, int e) {
  __shared__ __align__(16) float a_s[kBK32][kLdA32];
  __shared__ __align__(16) float b_s[kBK32][kBN32];

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;   // rows 8 ty.., columns 4 tx..
  const size_t row0 = (size_t)blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN32;
  const float* a_g = xp + row0 * k;
  const float* b_g = w + (size_t)expert_of(block_gid, e) * k * n;
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
      const float4 v = k0 + ka < k
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
          ? *reinterpret_cast<const float4*>(b_g + (size_t)(k0 + rb) * n +
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
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(out + (row0 + ty * 8 + i) * n + col) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// One block: one 128-row block of xp times one column tile of its expert.
template <typename T>
__global__ void __launch_bounds__(kThreads)
grouped_matmul_kernel(const T* __restrict__ xp, const T* __restrict__ w,
                      const int* __restrict__ block_gid, T* __restrict__ out,
                      int k, int n, int e) {
  gmm_tile(xp, w, block_gid, out, k, n, e);
}

template <typename T>
cudaError_t launch(const void* xp, const void* w, const int* block_gid,
                   void* out, int p, int k, int n, int e,
                   cudaStream_t stream) {
  const int bn = std::is_same<T, bf16>::value ? kBN16 : kBN32;
  const dim3 grid((n + bn - 1) / bn, p / kBM);
  grouped_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(w), block_gid,
      static_cast<T*>(out), k, n, e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out [p, n] = per 128-row block i of xp [p, k], xp_i @ w[block_gid[i]]
// with w [e, k, n]. Launches on `stream`, does not synchronise, allocates
// nothing. The caller has checked that xp, w and out are contiguous, of one
// type (bf16 or f32) and 16-byte aligned, block_gid contiguous int32
// [p / 128], p a positive multiple of 128 with p / 128 <= 65535, k and n
// positive multiples of 8, and e >= 1. Returns the CUDA error of the launch
// (0 on success).
int gmm_launch(const void* xp, const void* w, const void* block_gid,
               void* out, int p, int k, int n, int e, int is_bf16,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gid = static_cast<const int*>(block_gid);
  if (is_bf16) return (int)launch<bf16>(xp, w, gid, out, p, k, n, e, s);
  return (int)launch<float>(xp, w, gid, out, p, k, n, e, s);
}

const char* gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
