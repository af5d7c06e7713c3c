// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/incubate/nn/pallas/flash_attn.py:
//   K1  flash_fwd_wgmma_kernel (bf16, head_dim 64 and 128) and
//       flash_fwd_kernel (f32, head_dim 256)
//                                 <- `_fwd_kernel` (via `_flash_fwd`)
//   K2  flash_bwd_dkv_wgmma_kernel<D, true> (bf16, head_dim 64 and 128) and
//       flash_bwd_dkv_kernel<..., true> (f32, head_dim 256), between
//       flash_bwd_preprocess_kernel and flash_bwd_dq_convert_kernel
//                                 <- `_bwd_fused_kernel` (via `_flash_bwd_fused`)
//   K3  flash_bwd_dkv_wgmma_kernel<D, false> + flash_bwd_dq_wgmma_kernel<D>
//       (bf16, head_dim 64 and 128) and flash_bwd_dkv_kernel<..., false> +
//       flash_bwd_dq_kernel (f32, head_dim 256), after the pre-pass
//                                 <- `_bwd_dkv_kernel` + `_bwd_dq_kernel`
//                                    (via `_flash_bwd_split`)
//
// Routes: bf16 at head_dim 64 and 128 (the training path) takes the TMA +
// wgmma kernels of K1, K2 and K3. f32 (exact
// FFMA, what the tests hold the algorithm to) and head_dim 256 (whose
// f32 accumulator tiles outgrow a warpgroup's registers) keep the first
// port's WMMA / FFMA kernels, flash_fwd_kernel, flash_bwd_dkv_kernel and
// flash_bwd_dq_kernel. Both routes share the backward's pre-pass and, for
// K2, its post-pass.
//
// Semantics are the TPU kernels': scores s = (q . k) * scale in f32; causal
// masking is bottom-right aligned (query row i sees keys j <= i + sk - sq);
// the forward keeps the online softmax (m, l, acc) in f32 and writes out =
// acc / l in the input type and lse = m + log(l) in f32, with out 0 and lse
// -1e30 for a row that sees no key; p (and ds) are rounded to the input type
// before the p.v, p^T.do, ds^T.q and ds.k products. The backward takes the
// saved lse and delta = rowsum(do * out) (the pre-pass computes it) and
// recomputes p = exp(s - lse), forced to 0 outside the mask by a select
// (never by a multiply: a masked row's lse of -1e30 overflows the exp).
//
// Layouts: q, k, v, out, do, dq, dk, dv are [b, s, h, d] views with unit
// stride on d and any other strides (multiples of 16 bytes), so the
// training path hands the q/k/v slices of its fused qkv projection over
// without a copy. lse is contiguous f32 [b*h, sq]. The backward's
// pre-pass writes delta and lse * log2(e) as f32 [b*h, sq_pad] (sq
// rounded up to 128; rows past sq hold 0 and +inf, which make p 0 there);
// K2's dq is summed in an f32 [b, sq, h, d] workspace that the pre-pass
// zeroes and the post-pass turns into dq in the input type.
//
// What bounds them on an H100: at the training shapes (b 8, h 16, s 1024,
// d 128, bf16, causal) K1 does 4*d flops per unmasked (query, key) pair,
// ~34 GFLOP, and must move q, k, v, out and lse, ~135 MB: 0.035 ms of
// tensor-core time against 0.040 ms of memory time, so it is close to
// balanced. K2 does 10*d flops per pair (five products), ~86 GFLOP, and
// its call moves ~269 MB (q, k, v, out, do and lse in, dq, dk, dv out):
// 0.087 ms of tensor-core time against 0.080 ms of memory time, so it is
// bound by operations. K3 recomputes s and dp in both its kernels: 14*d
// flops per pair, ~120 GFLOP.
//
// What the design does about it. K1 for bf16 at head_dim 64 and 128 is
// flash_fwd_wgmma_kernel:
// * one block per (128-row query tile, batch*head), the longest causal
//   tiles first; a producer warpgroup (one thread issues the copies; the
//   group gives its registers to the others by setmaxnreg) and two
//   consumer warpgroups of 64 rows;
// * the producer loads the query tile once, then K and V tiles of 128 keys
//   into a ring of 3 stages, by TMA (4-D tensor maps of the strided
//   [b, s, h, d] views, encoded on the host through the driver's
//   cuTensorMapEncodeTiled, found by cudaGetDriverEntryPoint; rows past s
//   read as zeros), each stage behind a "full" and an "empty" mbarrier;
// * S = Q.K^T is wgmma m64n128k16 with both operands in shared memory under
//   the 128-byte swizzle that TMA writes; the online softmax runs on the S
//   fragment in registers with exp2 (scale * log2(e) folded into one
//   multiply); P is rounded to bf16 in registers and is the register A
//   operand of O += P.V (wgmma RS, V MN-major); O stays in registers. The
//   epilogue writes out in bf16 and lse = m + log(l) in f32.
// * inside a warpgroup, tile j's S product and tile j - 1's P.V are issued
//   together, and tile j's softmax runs while that P.V is on the tensor
//   cores (the exponentials, on the special function unit, take about as
//   long as the products at this shape); across the two warpgroups, named
//   barriers make them take turns to issue, so that one's softmax runs
//   while the other's products do.
// Not done yet for K1: a persistent grid, a TMA store of out.
//
// K2 and K3 for bf16 at head_dim 64 and 128, on the same pieces:
// * flash_bwd_preprocess_kernel reads do and out once and writes delta
//   and lse * log2(e) (padded as above) and, for K2, zeroes the dq
//   workspace; flash_bwd_dq_convert_kernel writes K2's dq in bf16.
// * flash_bwd_dkv_wgmma_kernel (K2, and K3's first kernel): one block per
//   (batch*head, 128-key tile), the key tiles that see the most query rows
//   first. TMA loads the block's K and V once; the producer streams tiles
//   of 64 query rows of Q and dO, with their lse and delta (1-D bulk
//   copies), through a ring of 2 (K2) or 3 (K3) stages. Each consumer
//   warpgroup owns 64 keys and computes S^T = K.Q^T and dP^T = V.dO^T
//   (wgmma SS, keys on M, so each thread reads the lse and delta of its
//   query columns from shared memory); P^T and dS^T, rounded to bf16 in
//   registers, are the A operands of dV += P^T.dO and dK += dS^T.Q (wgmma
//   RS, dO and Q MN-major); dK and dV stay in f32 registers until the
//   epilogue. A warpgroup whose keys no row of the tile sees (causal)
//   skips the tile. K2 also writes dS^T to shared memory (double-buffered)
//   and computes a 64-row dQ tile as dS.K (wgmma SS, dS read transposed:
//   both operands MN-major), the two warpgroups splitting d (head_dim
//   128) or the keys (64), stages it in shared memory under the 128-byte
//   swizzle and adds it to the f32 workspace by TMA reduce-adds (so dq's
//   summation order changes from run to run; dk's and dv's do not).
// * flash_bwd_dq_wgmma_kernel (K3's second kernel, no atomics): one block
//   per (batch*head, 128-row query tile), the longest causal rows first,
//   on K1's template: Q and dO loaded once, K and V tiles of 64 keys
//   through a 3-stage ring; S = Q.K^T and dP = dO.V^T (SS), dS in
//   registers, dQ += dS.K (RS, K MN-major); dq written in bf16.
// * exp2 with scale * log2(e) folded into one multiply (lse arrives in
//   log2 units); masks only on the tiles that cross the causal diagonal or
//   the key edge; rows past sq read zeros and an lse of +inf, so p is 0.
// What holds K2 back on an H100 is the L2's rate of f32 reduce-adds: its
// ~300 MB of dQ partial sums at the training shape cost ~0.11 ms more as
// adds than as plain stores. Not done yet for K2 and K3: a persistent
// grid; overlap of one query tile's products with the previous tile's
// exponentials inside a warpgroup; pairs of key-tile blocks in a cluster
// that sum their dQ tiles in shared memory before one reduce-add.

// The f32 and head_dim 256 kernels are the first port's design: the
// products on the tensor cores through WMMA (16x16x16 bf16 fragments, f32
// accumulate) for bf16 inputs, and as plain f32 FMA loops for f32 inputs;
// every operand tile in shared memory, which the fragments load from and
// store back to, so the elementwise softmax steps see plain f32 tiles;
// tiles are 64x64 (32x32 at d 256 in bf16, smaller still in f32) so that a
// block's tiles fit in 227 KB. The TPU grid ran in order with m/l/acc
// (K1), dk/dv (K2, K3) and a whole-sequence dq (K2) carried in VMEM across
// the sequential axis; on a GPU blocks run in parallel and in no order, so
// each block owns one (batch*head, tile) and loops over the other axis
// itself. K2's dq, which every k tile adds into, goes to the f32 workspace
// by atomicAdd.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kMaskedLse = -1e30f;   // lse of a row that sees no key

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// Tile shapes of the first port's kernels per (input type, head_dim): f32,
// and bf16 at head_dim 256 (bf16 at 64 and 128 takes the wgmma kernels),
// sized so that the largest block (K2's) stays inside 227 KB of shared
// memory.
template <typename T, int D> struct Tiles;
template <> struct Tiles<bf16, 256> { static constexpr int BQ = 32, BK = 32; };
template <> struct Tiles<float, 64>  { static constexpr int BQ = 32, BK = 32; };
template <> struct Tiles<float, 128> { static constexpr int BQ = 32, BK = 32; };
template <> struct Tiles<float, 256> { static constexpr int BQ = 16, BK = 32; };

// Padded leading dimensions (elements). Rows stay 16-byte aligned for the
// vector loads, and every 16x16 fragment 32-byte aligned, as WMMA needs.
template <typename T, int D> struct Ld {
  static constexpr int BQ = Tiles<T, D>::BQ, BK = Tiles<T, D>::BK;
  static constexpr int PAD = 16 / (int)sizeof(T);
  static constexpr int T_ROW = D + PAD;    // [rows][D] tiles of the input type
  static constexpr int S_ROW = BK + 4;     // [BQ][BK] f32 score tiles
  static constexpr int P_ROW = BK + PAD;   // [BQ][BK] input-type score tiles
  static constexpr int A_ROW = D + 4;      // [rows][D] f32 accumulators
};

// Hands out 128-byte aligned pieces of one shared-memory block; with base
// 0 it only counts, which is how the host learns a kernel's size.
struct Carver {
  uintptr_t base;
  size_t off = 0;
  template <typename X>
  __host__ __device__ X* take(size_t n) {
    off = (off + 127) & ~(size_t)127;
    X* p = reinterpret_cast<X*>(base + off);
    off += n * sizeof(X);
    return p;
  }
};

template <typename T, int D> struct FwdSmem {
  using L = Ld<T, D>;
  T *q, *k, *v, *p;
  float *s, *o, *alpha, *l;
  size_t bytes;
  __host__ __device__ explicit FwdSmem(uintptr_t base) {
    Carver c{base};
    q = c.take<T>(L::BQ * L::T_ROW);
    k = c.take<T>(L::BK * L::T_ROW);
    v = c.take<T>(L::BK * L::T_ROW);
    s = c.take<float>(L::BQ * L::S_ROW);
    p = c.take<T>(L::BQ * L::P_ROW);
    o = c.take<float>(L::BQ * L::A_ROW);
    alpha = c.take<float>(L::BQ);
    l = c.take<float>(L::BQ);
    bytes = c.off;
  }
};

template <typename T, int D, bool FUSED> struct DkvSmem {
  using L = Ld<T, D>;
  T *k, *v, *q, *dout, *ps;
  float *s, *dp, *dk, *dv, *dqt, *lse, *delta;
  size_t bytes;
  __host__ __device__ explicit DkvSmem(uintptr_t base) {
    Carver c{base};
    k = c.take<T>(L::BK * L::T_ROW);
    v = c.take<T>(L::BK * L::T_ROW);
    q = c.take<T>(L::BQ * L::T_ROW);
    dout = c.take<T>(L::BQ * L::T_ROW);
    s = c.take<float>(L::BQ * L::S_ROW);
    dp = c.take<float>(L::BQ * L::S_ROW);
    ps = c.take<T>(L::BQ * L::P_ROW);
    dk = c.take<float>(L::BK * L::A_ROW);
    dv = c.take<float>(L::BK * L::A_ROW);
    dqt = c.take<float>(FUSED ? L::BQ * L::A_ROW : 0);
    lse = c.take<float>(L::BQ);
    delta = c.take<float>(L::BQ);
    bytes = c.off;
  }
};

template <typename T, int D> struct DqSmem {
  using L = Ld<T, D>;
  T *q, *dout, *k, *v, *ds;
  float *s, *dp, *dq, *lse, *delta;
  size_t bytes;
  __host__ __device__ explicit DqSmem(uintptr_t base) {
    Carver c{base};
    q = c.take<T>(L::BQ * L::T_ROW);
    dout = c.take<T>(L::BQ * L::T_ROW);
    k = c.take<T>(L::BK * L::T_ROW);
    v = c.take<T>(L::BK * L::T_ROW);
    s = c.take<float>(L::BQ * L::S_ROW);
    dp = c.take<float>(L::BQ * L::S_ROW);
    ds = c.take<T>(L::BQ * L::P_ROW);
    dq = c.take<float>(L::BQ * L::A_ROW);
    lse = c.take<float>(L::BQ);
    delta = c.take<float>(L::BQ);
    bytes = c.off;
  }
};

// A [b, s, h, d] view: element (bi, row, hi, e) at p[bi*sb + row*ss + hi*sh + e].
struct View {
  void* p;
  long long sb, ss, sh;
};

struct Params {
  View q, k, v, o, dout, dq, dk, dv;
  const float* lse_in;   // [b*h, sq]
  float* delta;          // [b*h, sq_pad]: rowsum(do * out), 0 past sq
  float* lse2;           // [b*h, sq_pad]: lse * log2(e), +inf past sq
  float* dq_acc;         // K2: f32 [b, sq, h, d] dq workspace, else null
  float* lse_out;        // [b*h, sq]
  int b, h, sq, sk, sq_pad, causal, offset;   // offset = sk - sq
  float scale;
};

template <typename T>
__device__ __forceinline__ T* head_base(const View& t, int bh, int h) {
  const int bi = bh / h, hi = bh - bi * h;
  return static_cast<T*>(t.p) + bi * t.sb + hi * t.sh;
}

// Copy rows [row0, row0 + rows) of one head into a padded tile, 16 bytes a
// thread; rows at or past n_total are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long ss,
                                          int row0, int rows, int n_total) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int VPR = D / VEC;
  constexpr int LD = Ld<T, D>::T_ROW;
  for (int i = threadIdx.x; i < rows * VPR; i += kThreads) {
    const int r = i / VPR, seg = i - r * VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_total)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * ss + seg * VEC);
    *reinterpret_cast<uint4*>(dst + r * LD + seg * VEC) = val;
  }
}

// C[M][N] (+)= op(A)[M][Kd] . op(B)[Kd][N] on shared-memory tiles, where
// op(A)[m][k] = TA ? A[k*lda + m] : A[m*lda + k] and
// op(B)[k][n] = TB ? B[n*ldb + k] : B[k*ldb + n]. C is f32. The block's
// warps split C into 16x16 fragments. Ends without a barrier.
template <int M, int N, int Kd, bool TA, bool TB, bool ACC>
__device__ __forceinline__ void tile_mm(float* C, int ldc, const bf16* A,
                                        int lda, const bf16* B, int ldb) {
  using namespace nvcuda;
  using LA = typename std::conditional<TA, wmma::col_major,
                                       wmma::row_major>::type;
  using LB = typename std::conditional<TB, wmma::col_major,
                                       wmma::row_major>::type;
  constexpr int FM = M / 16, FN = N / 16;
  const int warp = threadIdx.x >> 5;
  for (int f = warp; f < FM * FN; f += kWarps) {
    const int fm = f / FN, fn = f - fm * FN;
    float* cp = C + fm * 16 * ldc + fn * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    if (ACC)
      wmma::load_matrix_sync(c, cp, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(c, 0.f);
#pragma unroll 4
    for (int k0 = 0; k0 < Kd; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
      wmma::load_matrix_sync(
          a, TA ? A + k0 * lda + fm * 16 : A + fm * 16 * lda + k0, lda);
      wmma::load_matrix_sync(
          b, TB ? B + fn * 16 * ldb + k0 : B + k0 * ldb + fn * 16, ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(cp, c, ldc, wmma::mem_row_major);
  }
}

// The same product for f32 tiles, by plain FMA (exact f32, no TF32).
template <int M, int N, int Kd, bool TA, bool TB, bool ACC>
__device__ __forceinline__ void tile_mm(float* C, int ldc, const float* A,
                                        int lda, const float* B, int ldb) {
  for (int i = threadIdx.x; i < M * N; i += kThreads) {
    const int m = i / N, n = i - m * N;
    float acc = ACC ? C[m * ldc + n] : 0.f;
    for (int k = 0; k < Kd; ++k) {
      const float a = TA ? A[k * lda + m] : A[m * lda + k];
      const float b = TB ? B[n * ldb + k] : B[k * ldb + n];
      acc = fmaf(a, b, acc);
    }
    C[m * ldc + n] = acc;
  }
}

template <int TPR>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int TPR>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Key `key` is visible to query row `row` (global indices).
__device__ __forceinline__ bool visible(const Params& p, int row, int key) {
  return key < p.sk && (!p.causal || key <= row + p.offset);
}

// ---------------------------------------------------------------- K1
// One block per (query tile, batch*head); it walks the key tiles below
// the tile's causal limit with the online softmax. Each query row belongs
// to TPR consecutive threads, which keep its running max and sum in
// registers.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  using L = Ld<T, D>;
  constexpr int BQ = L::BQ, BK = L::BK, TPR = kThreads / BQ;
  constexpr int CPT = BK / TPR;                 // score columns per thread
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const FwdSmem<T, D> sm(reinterpret_cast<uintptr_t>(smem_raw));

  const int qt = gridDim.x - 1 - blockIdx.x;    // longest causal rows first
  const int bh = blockIdx.y;
  const int q0 = qt * BQ;
  const int nq = min(BQ, p.sq - q0);
  const int tid = threadIdx.x;

  load_rows<T, D>(sm.q, head_base<T>(p.q, bh, p.h), p.q.ss, q0, BQ, p.sq);
  for (int i = tid; i < BQ * D; i += kThreads)
    sm.o[(i / D) * L::A_ROW + i % D] = 0.f;

  const int r = tid / TPR, sub = tid % TPR;     // this thread's query row
  float m_run = -INFINITY, l_run = 0.f;
  const int kv_end = p.causal ? min(p.sk, q0 + nq + p.offset) : p.sk;
  const T* kb = head_base<T>(p.k, bh, p.h);
  const T* vb = head_base<T>(p.v, bh, p.h);

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();                            // previous tiles consumed
    load_rows<T, D>(sm.k, kb, p.k.ss, k0, BK, p.sk);
    load_rows<T, D>(sm.v, vb, p.v.ss, k0, BK, p.sk);
    __syncthreads();
    tile_mm<BQ, BK, D, false, true, false>(sm.s, L::S_ROW, sm.q, L::T_ROW,
                                           sm.k, L::T_ROW);
    __syncthreads();

    float sv[CPT];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = sub + j * TPR;
      sv[j] = visible(p, q0 + r, k0 + c) ? sm.s[r * L::S_ROW + c] * p.scale
                                         : -INFINITY;
      mx = fmaxf(mx, sv[j]);
    }
    mx = group_max<TPR>(mx);
    const float m_new = fmaxf(m_run, mx);
    float alpha = 1.f, sum = 0.f;
    if (m_new != -INFINITY) {                   // uniform across the group
      alpha = expf(m_run - m_new);              // 0 while m_run is -inf
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float e = expf(sv[j] - m_new);    // masked: exp(-inf) = 0
        sum += e;
        sm.p[r * L::P_ROW + sub + j * TPR] = from_f32<T>(e);
      }
    } else {
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        sm.p[r * L::P_ROW + sub + j * TPR] = from_f32<T>(0.f);
    }
    sum = group_sum<TPR>(sum);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    if (sub == 0) sm.alpha[r] = alpha;
    __syncthreads();
    for (int i = tid; i < BQ * D; i += kThreads)
      sm.o[(i / D) * L::A_ROW + i % D] *= sm.alpha[i / D];
    __syncthreads();
    tile_mm<BQ, D, BK, false, false, true>(sm.o, L::A_ROW, sm.p, L::P_ROW,
                                           sm.v, L::T_ROW);
  }

  if (sub == 0) {
    sm.l[r] = l_run;
    if (r < nq)
      p.lse_out[(size_t)bh * p.sq + q0 + r] =
          l_run == 0.f ? kMaskedLse : m_run + logf(l_run);
  }
  __syncthreads();
  T* ob = head_base<T>(p.o, bh, p.h);
  for (int i = tid; i < nq * D; i += kThreads) {
    const int rr = i / D, e = i - rr * D;
    const float l = sm.l[rr];
    ob[(q0 + rr) * p.o.ss + e] =
        from_f32<T>(sm.o[rr * L::A_ROW + e] / (l == 0.f ? 1.f : l));
  }
}

// ---------------------------------------------------------------- K2, K3a
// One block per (key tile, batch*head); it walks the query tiles that see
// the tile, accumulating dk and dv in shared memory. FUSED (K2) also adds
// each query tile's share of dq, ds . k, into the f32 workspace p.dq.
template <typename T, int D, bool FUSED>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const Params p) {
  using L = Ld<T, D>;
  constexpr int BQ = L::BQ, BK = L::BK;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const DkvSmem<T, D, FUSED> sm(reinterpret_cast<uintptr_t>(smem_raw));

  const int kt = blockIdx.x;                    // low tiles see most rows
  const int bh = blockIdx.y;
  const int k0 = kt * BK;
  const int nk = min(BK, p.sk - k0);
  const int tid = threadIdx.x;

  load_rows<T, D>(sm.k, head_base<T>(p.k, bh, p.h), p.k.ss, k0, BK, p.sk);
  load_rows<T, D>(sm.v, head_base<T>(p.v, bh, p.h), p.v.ss, k0, BK, p.sk);
  for (int i = tid; i < BK * D; i += kThreads) {
    sm.dk[(i / D) * L::A_ROW + i % D] = 0.f;
    sm.dv[(i / D) * L::A_ROW + i % D] = 0.f;
  }
  const T* qb = head_base<T>(p.q, bh, p.h);
  const T* dob = head_base<T>(p.dout, bh, p.h);
  const float* lse = p.lse_in + (size_t)bh * p.sq;
  const float* delta = p.delta + (size_t)bh * p.sq_pad;
  // first query row that sees key k0: row + offset >= k0
  const int q_begin = p.causal ? max(0, k0 - p.offset) : 0;

  for (int q0 = (q_begin / BQ) * BQ; q0 < p.sq; q0 += BQ) {
    __syncthreads();                            // previous tiles consumed
    load_rows<T, D>(sm.q, qb, p.q.ss, q0, BQ, p.sq);
    load_rows<T, D>(sm.dout, dob, p.dout.ss, q0, BQ, p.sq);
    for (int i = tid; i < BQ; i += kThreads) {
      const bool in = q0 + i < p.sq;
      sm.lse[i] = in ? lse[q0 + i] : 0.f;
      sm.delta[i] = in ? delta[q0 + i] : 0.f;
    }
    __syncthreads();
    tile_mm<BQ, BK, D, false, true, false>(sm.s, L::S_ROW, sm.q, L::T_ROW,
                                           sm.k, L::T_ROW);
    __syncthreads();
    for (int i = tid; i < BQ * BK; i += kThreads) {
      const int r = i / BK, c = i - r * BK;
      const bool ok = q0 + r < p.sq && visible(p, q0 + r, k0 + c);
      const float pv =
          ok ? expf(sm.s[r * L::S_ROW + c] * p.scale - sm.lse[r]) : 0.f;
      sm.s[r * L::S_ROW + c] = pv;              // p in f32, for ds
      sm.ps[r * L::P_ROW + c] = from_f32<T>(pv);
    }
    __syncthreads();
    // dv += p^T . do ; dp = do . v^T
    tile_mm<BK, D, BQ, true, false, true>(sm.dv, L::A_ROW, sm.ps, L::P_ROW,
                                          sm.dout, L::T_ROW);
    tile_mm<BQ, BK, D, false, true, false>(sm.dp, L::S_ROW, sm.dout,
                                           L::T_ROW, sm.v, L::T_ROW);
    __syncthreads();
    for (int i = tid; i < BQ * BK; i += kThreads) {
      const int r = i / BK, c = i - r * BK;
      const float ds = sm.s[r * L::S_ROW + c] *
                       (sm.dp[r * L::S_ROW + c] - sm.delta[r]) * p.scale;
      sm.ps[r * L::P_ROW + c] = from_f32<T>(ds);
    }
    __syncthreads();
    // dk += ds^T . q ; (fused) dq_tile = ds . k
    tile_mm<BK, D, BQ, true, false, true>(sm.dk, L::A_ROW, sm.ps, L::P_ROW,
                                          sm.q, L::T_ROW);
    if (FUSED) {
      tile_mm<BQ, D, BK, false, false, false>(sm.dqt, L::A_ROW, sm.ps,
                                              L::P_ROW, sm.k, L::T_ROW);
      __syncthreads();
      float* dqb = p.dq_acc +
                   ((size_t)(bh / p.h) * p.sq * p.h + bh % p.h) * D;
      const int nq = min(BQ, p.sq - q0);
      for (int i = tid; i < nq * D; i += kThreads) {
        const int r = i / D, e = i - r * D;
        atomicAdd(dqb + (size_t)(q0 + r) * p.h * D + e,
                  sm.dqt[r * L::A_ROW + e]);
      }
    }
  }
  __syncthreads();
  T* dkb = head_base<T>(p.dk, bh, p.h);
  T* dvb = head_base<T>(p.dv, bh, p.h);
  for (int i = tid; i < nk * D; i += kThreads) {
    const int r = i / D, e = i - r * D;
    dkb[(k0 + r) * p.dk.ss + e] = from_f32<T>(sm.dk[r * L::A_ROW + e]);
    dvb[(k0 + r) * p.dv.ss + e] = from_f32<T>(sm.dv[r * L::A_ROW + e]);
  }
}

// ---------------------------------------------------------------- K3b
// One block per (query tile, batch*head); it walks the key tiles below the
// tile's causal limit, accumulating dq in shared memory. No atomics.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Params p) {
  using L = Ld<T, D>;
  constexpr int BQ = L::BQ, BK = L::BK;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const DqSmem<T, D> sm(reinterpret_cast<uintptr_t>(smem_raw));

  const int qt = gridDim.x - 1 - blockIdx.x;    // longest causal rows first
  const int bh = blockIdx.y;
  const int q0 = qt * BQ;
  const int nq = min(BQ, p.sq - q0);
  const int tid = threadIdx.x;

  load_rows<T, D>(sm.q, head_base<T>(p.q, bh, p.h), p.q.ss, q0, BQ, p.sq);
  load_rows<T, D>(sm.dout, head_base<T>(p.dout, bh, p.h), p.dout.ss, q0, BQ,
                  p.sq);
  for (int i = tid; i < BQ; i += kThreads) {
    const bool in = i < nq;
    sm.lse[i] = in ? p.lse_in[(size_t)bh * p.sq + q0 + i] : 0.f;
    sm.delta[i] = in ? p.delta[(size_t)bh * p.sq_pad + q0 + i] : 0.f;
  }
  for (int i = tid; i < BQ * D; i += kThreads)
    sm.dq[(i / D) * L::A_ROW + i % D] = 0.f;
  const int kv_end = p.causal ? min(p.sk, q0 + nq + p.offset) : p.sk;
  const T* kb = head_base<T>(p.k, bh, p.h);
  const T* vb = head_base<T>(p.v, bh, p.h);

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();
    load_rows<T, D>(sm.k, kb, p.k.ss, k0, BK, p.sk);
    load_rows<T, D>(sm.v, vb, p.v.ss, k0, BK, p.sk);
    __syncthreads();
    tile_mm<BQ, BK, D, false, true, false>(sm.s, L::S_ROW, sm.q, L::T_ROW,
                                           sm.k, L::T_ROW);
    tile_mm<BQ, BK, D, false, true, false>(sm.dp, L::S_ROW, sm.dout,
                                           L::T_ROW, sm.v, L::T_ROW);
    __syncthreads();
    for (int i = tid; i < BQ * BK; i += kThreads) {
      const int r = i / BK, c = i - r * BK;
      const bool ok = r < nq && visible(p, q0 + r, k0 + c);
      const float pv =
          ok ? expf(sm.s[r * L::S_ROW + c] * p.scale - sm.lse[r]) : 0.f;
      const float ds = pv * (sm.dp[r * L::S_ROW + c] - sm.delta[r]) * p.scale;
      sm.ds[r * L::P_ROW + c] = from_f32<T>(ds);
    }
    __syncthreads();
    tile_mm<BQ, D, BK, false, false, true>(sm.dq, L::A_ROW, sm.ds, L::P_ROW,
                                           sm.k, L::T_ROW);
  }
  __syncthreads();
  T* dqb = head_base<T>(p.dq, bh, p.h);
  for (int i = tid; i < nq * D; i += kThreads) {
    const int r = i / D, e = i - r * D;
    dqb[(q0 + r) * p.dq.ss + e] = from_f32<T>(sm.dq[r * L::A_ROW + e]);
  }
}

// ---------------------------------------------------------------- K1, Hopper
// The forward for bf16 at head_dim 64 and 128 (see the note at the top):
// one block per (128-row query tile, batch*head), 2 consumer warpgroups
// of 64 rows and a producer warpgroup. The producer loads the query tile once
// and K/V tiles of kBK keys into a ring of kStages stages by TMA, each
// stage behind a "full" and an "empty" mbarrier; the consumers run
// S = Q.K^T and O += P.V on wgmma, with S, P and O in registers.
constexpr int kBQ = 128;                 // query rows a block
constexpr int kBK = 128;                 // keys a ring stage
constexpr int kStages = 3;
// two consumer warpgroups and a producer warpgroup: wgmma kernels get
// registers by whole warpgroups, so the producer holds a warpgroup's
// share in any case; setmaxnreg moves it to the consumers
constexpr int kWgThreads = 3 * 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of the block, 1024-byte aligned pieces: Q [D/64][kBQ][64],
// then kStages x K [D/64][kBK][64] and kStages x V, each [rows][64] block
// in TMA's 128-byte swizzle; then the barriers.
template <int D> struct WgSmem {
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor under the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N of this warpgroup's committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 2^x on the special function unit (2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The two consumer warpgroups take turns to issue their wgmma (named
// barriers 1 and 2): warpgroup w waits for its turn on barrier 1 + w and
// hands the turn over on 2 - w, so that one's softmax runs while the
// other's products are on the tensor cores.
__device__ __forceinline__ void wg_turn(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void wg_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 128 f32, registers) = [d +] a . b^T: a (64 x 16) and b
// (128 x 16) bf16 in shared memory, both K-major under the 128-byte swizzle
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 f32, registers) += a (64 x 16 bf16, registers) . b
// (16 x 64 bf16 in shared memory, MN-major under the 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 f32, registers) += a (64 x 16 bf16, registers) . b
// (16 x 128 bf16 in shared memory, MN-major under the 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}

// S = Q . K^T of one K tile into sc (issued and committed, not awaited):
// qs is the warpgroup's 64 query rows, ks the stage's K tile
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[kBK / 2],
                                         const uint8_t* qs,
                                         const uint8_t* ks) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {         // 16 dims a step
    const int cb = kk >> 2, off = (kk & 3) * 32;
    wgmma_ss_n128(sc, sw128_desc(qs + cb * kBQ * 128 + off, 16, 1024),
                  sw128_desc(ks + cb * kBK * 128 + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P . V of one V tile (issued and committed, not awaited)
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[kBK / 16][4],
                                         const uint8_t* vs) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)         // V rows 16 kk .. 16 kk + 15
    wgmma_pv<D>(o, pa[kk], sw128_desc(vs + kk * 16 * 128, kBK * 128, 1024));
  wgmma_commit();
}

// The online softmax of the scores of the tile of keys k0 .. k0 + kBK - 1
// in sc, in place (sc becomes p, f32), for rows r0 and r0 + 8 of the
// warpgroup whose first row is q_wg; each row's rescale factor of O in
// alpha.
__device__ __forceinline__ void softmax_tile(float (&sc)[kBK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             const Params& p, float c,
                                             int k0, int q_wg, int r0,
                                             int tg) {
  // mask (bottom-right causal, keys past sk) where the tile needs it
  const bool edge = k0 + kBK > p.sk ||
                    (p.causal && k0 + kBK - 1 > q_wg + p.offset);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    const int h = (i >> 1) & 1;                 // row r0 or r0 + 8
    float x = sc[i] * c;
    if (edge) {
      const int key = k0 + 8 * (i >> 2) + 2 * tg + (i & 1);
      if (key >= p.sk || (p.causal && key > r0 + 8 * h + p.offset))
        x = -INFINITY;
    }
    sc[i] = x;
    mx[h] = fmaxf(mx[h], x);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float mn = fmaxf(m[h], mx[h]);
    // a row that has seen no key keeps m at -inf and adds nothing
    const float u = mn == -INFINITY ? 0.f : mn;
    alpha[h] = fast_exp2(m[h] - u);
    m[h] = mn;
    mx[h] = u;                                  // the exponent's offset
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    const int h = (i >> 1) & 1;
    sc[i] = fast_exp2(sc[i] - mx[h]);
    ps[h] += sc[i];
  }
  l[0] = l[0] * alpha[0] + ps[0];
  l[1] = l[1] * alpha[1] + ps[1];
}

// An accumulator fragment (P, or dS), rounded to bf16, as the register A
// operand of 16 columns a step
template <int N>
__device__ __forceinline__ void pack_p(const float (&sc)[N],
                                       uint32_t (&pa)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// tq, tk, tv: 4-D tensor maps of the [b, s, h, d] views, dims (d, s, h, b),
// boxes of 64 dims x kBQ (or kBK) rows x one head x one batch.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const Params p) {
  using L = WgSmem<D>;
  constexpr int kCols = D / 64;                 // 128-byte column blocks
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int qt = gridDim.x - 1 - blockIdx.x;    // longest causal rows first
  const int bh = blockIdx.y;
  const int bi = bh / p.h, hi = bh - bi * p.h;
  const int q0 = qt * kBQ;
  const int nq = min(kBQ, p.sq - q0);
  const int kv_end = p.causal ? min(p.sk, q0 + nq + p.offset) : p.sk;
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2 * 128);            // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {                              // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < kCols; ++c)
        tma_load(sm + c * kBQ * 128, &tq, q_full, 64 * c, q0, hi, bi);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty + s, (j / kStages - 1) & 1);
        mbar_expect_tx(full + s, 2 * L::kTileBytes);
        uint8_t* ks = sm + L::kK + s * L::kTileBytes;
        uint8_t* vs = sm + L::kV + s * L::kTileBytes;
        for (int c = 0; c < kCols; ++c) {
          tma_load(ks + c * kBK * 128, &tk, full + s, 64 * c, j * kBK, hi,
                   bi);
          tma_load(vs + c * kBK * 128, &tv, full + s, 64 * c, j * kBK, hi,
                   bi);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  // a consumer: warpgroup wg owns query rows q0 + 64 wg .. + 63; this
  // thread rows r0 and r0 + 8 of them, columns 2 tg, 2 tg + 1 of every
  // 8-column block of the accumulators
  const int wg = warp >> 2;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = q0 + 64 * wg + 16 * (warp & 3) + g;
  const float c = p.scale * kLog2e;             // scores in log2 units
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const uint8_t* qs = sm + 64 * wg * 128;       // this warpgroup's Q rows

  // Tile j's S product is in flight while tile j - 1's P.V runs, and tile
  // j's softmax runs while that P.V is still on the tensor cores.
  const uint8_t* kt = sm + L::kK;     // stage s at kt + s * L::kTileBytes
  const uint8_t* vt = sm + L::kV;
  const int q_wg = q0 + 64 * wg;                // the warpgroup's first row
  float sc[kBK / 2];
  uint32_t pa[kBK / 16][4];
  float alpha[2];
  if (wg == 1) wg_pass(wg);                     // warpgroup 0 issues first
  mbar_wait(q_full, 0);
  if (n_tiles > 0) {
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
    mbar_wait(full, 0);
    fence_regs(sc);
    wg_turn(wg);
    wgmma_fence();
    issue_qk<D>(sc, qs, kt);
    wg_pass(wg);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile(sc, m, l, alpha, p, c, 0, q_wg, r0, tg);  // O is 0
    pack_p(sc, pa);
  }
  for (int j = 1; j < n_tiles; ++j) {
    const int s = j % kStages, sp = (j - 1) % kStages;
    mbar_wait(full + s, (j / kStages) & 1);
    fence_regs(sc);
    fence_regs(o);
    wg_turn(wg);
    wgmma_fence();
    issue_qk<D>(sc, qs, kt + s * L::kTileBytes);
    issue_pv<D>(o, pa, vt + sp * L::kTileBytes);
    wg_pass(wg);
    wgmma_wait<1>();                            // S of tile j
    fence_regs(sc);
    softmax_tile(sc, m, l, alpha, p, c, j * kBK, q_wg, r0, tg);
    wgmma_wait<0>();                            // P.V of tile j - 1
    fence_regs(o);
    mbar_arrive(empty + sp);                    // its stage is read
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    pack_p(sc, pa);
  }
  if (n_tiles > 0) {
    const int sp = (n_tiles - 1) % kStages;
    fence_regs(o);
    wg_turn(wg);
    wgmma_fence();
    issue_pv<D>(o, pa, vt + sp * L::kTileBytes);
    wg_pass(wg);
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(empty + sp);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  bf16* ob = head_base<bf16>(p.o, bh, p.h);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= p.sq) continue;
    if (tg == 0)
      p.lse_out[(size_t)bh * p.sq + r] =
          l[h] == 0.f ? kMaskedLse : m[h] * kLn2 + logf(l[h]);
    const float inv = 1.f / (l[h] == 0.f ? 1.f : l[h]);
    bf16* orow = ob + (long long)r * p.o.ss;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * tg) =
          pack_bf16(o[4 * n + 2 * h] * inv, o[4 * n + 2 * h + 1] * inv);
  }
}

// ---------------------------------------------------------------- K2, K3 pre- and post-pass
// One group of G threads a row (b, q, h) of do and out, 16 bytes a thread
// and step: delta = rowsum(do * out) and lse2 = lse * log2(e) into the
// padded [b*h, sq_pad] rows (0 and +inf past sq), and, when there is a dq
// workspace (K2), its row zeroed.
template <typename T> __device__ __forceinline__ float dot16(uint4 a, uint4 b);
template <> __device__ __forceinline__ float dot16<bf16>(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}
template <> __device__ __forceinline__ float dot16<float>(uint4 a, uint4 b) {
  const float4 x = *reinterpret_cast<const float4*>(&a);
  const float4 y = *reinterpret_cast<const float4*>(&b);
  return fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, x.x * y.x)));
}

template <typename T, int D> struct RowGroup {
  static constexpr int kVecs = D * (int)sizeof(T) / 16;   // 16-byte vectors a row
  static constexpr int G = kVecs < 32 ? kVecs : 32;       // threads a row
};

template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_preprocess_kernel(const Params p) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int G = RowGroup<T, D>::G;
  constexpr int PER = RowGroup<T, D>::kVecs / G;
  const long long t = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long row = t / G;                  // bh * sq_pad + q
  const int sub = (int)(t - row * G);
  const long long n_rows = (long long)p.b * p.h * p.sq_pad;
  const int bh = (int)(row / p.sq_pad);
  const int q = (int)(row - (long long)bh * p.sq_pad);
  const bool in = row < n_rows && q < p.sq;
  float acc = 0.f;
  if (in) {
    const T* o = head_base<T>(p.o, bh, p.h) + (long long)q * p.o.ss;
    const T* d = head_base<T>(p.dout, bh, p.h) + (long long)q * p.dout.ss;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = (sub + i * G) * VEC;
      acc += dot16<T>(*reinterpret_cast<const uint4*>(o + e),
                      *reinterpret_cast<const uint4*>(d + e));
    }
  }
  acc = group_sum<G>(acc);                      // every lane takes part
  if (row < n_rows && sub == 0) {
    p.delta[row] = in ? acc : 0.f;
    p.lse2[row] = in ? p.lse_in[(size_t)bh * p.sq + q] * kLog2e : INFINITY;
  }
  if (in && p.dq_acc != nullptr) {
    const int bi = bh / p.h, hi = bh - bi * p.h;
    float4* a = reinterpret_cast<float4*>(
        p.dq_acc + (((size_t)bi * p.sq + q) * p.h + hi) * D + sub * (D / G));
#pragma unroll
    for (int i = 0; i < D / G / 4; ++i) a[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ void store8(bf16* dst, float4 a, float4 b) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                 pack_bf16(b.z, b.w));
}
__device__ __forceinline__ void store8(float* dst, float4 a, float4 b) {
  reinterpret_cast<float4*>(dst)[0] = a;
  reinterpret_cast<float4*>(dst)[1] = b;
}

// K2's dq: the f32 workspace, 8 values a thread, into the strided view in
// the input type.
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_dq_convert_kernel(const Params p) {
  const long long i = ((long long)blockIdx.x * 256 + threadIdx.x) * 8;
  if (i >= (long long)p.b * p.sq * p.h * D) return;
  const long long row = i / D;                  // (bi * sq + q) * h + hi
  const int e = (int)(i - row * D);
  const int hi = (int)(row % p.h);
  const long long bq = row / p.h;
  const int q = (int)(bq % p.sq), bi = (int)(bq / p.sq);
  const float4* src = reinterpret_cast<const float4*>(p.dq_acc + i);
  T* dst = static_cast<T*>(p.dq.p) + bi * p.dq.sb + (long long)q * p.dq.ss +
           hi * p.dq.sh + e;
  store8(dst, src[0], src[1]);
}

// ---------------------------------------------------------------- K2, K3, Hopper
constexpr int kBwdBK = 128;      // keys a K2 / K3a block, 64 a warpgroup
constexpr int kBwdBQ = 64;       // query rows a K2 / K3a ring stage
constexpr int kBwdQ = 128;       // query rows a K3b block, 64 a warpgroup
constexpr int kBwdKs = 64;       // keys a K3b ring stage
// ring stages: K3's kernels 3; K2 2 (3 fit its shared memory at head_dim
// 128 by 456 bytes, and were slower on an H100: its time goes to the dQ
// reduce-adds, not to waiting for tiles)
constexpr int kBwdStages = 3;
constexpr int kFusedStages = 2;

// 1-D bulk copy of `bytes` (a multiple of 16, 16-byte aligned) from global
// to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// adds one box of a 4-D f32 tensor map from shared memory into global
// memory, element by element and atomically (elements past the tensor's
// edge are left out), as a bulk operation of this thread's group
__device__ __forceinline__ void tma_reduce_add(const CUtensorMap* map,
                                               const void* src, int c0,
                                               int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.tile.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until this thread's bulk operations have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// until they are complete
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// the threads' own shared-memory writes, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// this thread's warpgroup, as a value the compiler knows to be the same
// across the warp (so that branches on it around wgmma stay convergent)
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// d (64 x 64 f32, registers) = [d +] op(a) . op(b) with a (64 x 16) and b
// (16 x 64) bf16 in shared memory under the 128-byte swizzle: TA / TB 0
// for K-major operands (a [m][k], b [n][k]), 1 for MN-major ones (a
// [k][m], b [k][n])
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// 64 rows x (64 x D) of the m-side tile ms against the n-side tile ns,
// both K-major [D/64][rows][64] under the 128-byte swizzle (ms_rows and
// ns_rows: the rows of each tile's column block), issued, not committed
template <int D>
__device__ __forceinline__ void issue_nt(float (&d)[32], const uint8_t* ms,
                                         int ms_rows, const uint8_t* ns,
                                         int ns_rows) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {         // 16 dims a step
    const int cb = kk >> 2, off = (kk & 3) * 32;
    wgmma_ss_n64<0, 0>(d, sw128_desc(ms + cb * ms_rows * 128 + off, 16, 1024),
                       sw128_desc(ns + cb * ns_rows * 128 + off, 16, 1024),
                       kk > 0);
  }
}

// acc (64 x D) += a (64 x 64, bf16 registers) . b (64 rows x D, MN-major
// [D/64][rows][64] under the 128-byte swizzle), issued, not committed
template <int D>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2],
                                         const uint32_t (&a)[4][4],
                                         const uint8_t* b, int b_rows) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)                // b rows 16 kk .. 16 kk + 15
    wgmma_pv<D>(acc, a[kk], sw128_desc(b + kk * 16 * 128, b_rows * 128, 1024));
}

// A warpgroup's 64 x 64 f32 dQ tile staged for its reduce: two boxes of
// 32 dims x 64 rows, each row 128 bytes under the 128-byte swizzle.
constexpr int kDqStage = 64 * 64 * 4;

// Shared memory of a K2 / K3a block (1024-byte aligned pieces): K and V
// [D/64][128][64]; S x Q and dO [D/64][64][64]; (K2) two dS^T
// tiles [128 keys][64 queries] and a dQ block a warpgroup; S x
// lse2 and delta [64]; the barriers.
template <int D, bool FUSED> struct DkvWgSmem {
  static constexpr int kKV = kBwdBK * D * 2;
  static constexpr int kRow = kBwdBQ * D * 2;
  static constexpr int kDsTile = kBwdBK * kBwdBQ * 2;
  static constexpr int kK = 0, kV = kKV, kQ = 2 * kKV;
  static constexpr int S = FUSED ? kFusedStages : kBwdStages;
  static constexpr int kDo = kQ + S * kRow;
  static constexpr int kDs = kDo + S * kRow;
  static constexpr int kStage = kDs + (FUSED ? 2 * kDsTile : 0);
  static constexpr int kLse = kStage + (FUSED ? 2 * kDqStage : 0);
  static constexpr int kDelta = kLse + S * kBwdBQ * 4;
  static constexpr int kBar = kDelta + S * kBwdBQ * 4;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * S) + 1024;
};

// K2 (FUSED) and K3a: see the note at the top. tk, tv: boxes of 128 rows;
// tq, tdo: boxes of 64 rows; tacc (K2): K2's f32 dq workspace, boxes of
// 32 dims x 64 rows.
template <int D, bool FUSED>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tacc,
                           const Params p) {
  using L = DkvWgSmem<D, FUSED>;
  constexpr int kCols = D / 64;
  constexpr int S = L::S;
  // dQ: at head_dim 128 warpgroup wg takes dims 64 wg .. + 63 over the
  // block's 128 keys; at 64 all dims over its own 64 keys
  constexpr bool kDqSplitKeys = D == 64;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + S;

  const int bh = blockIdx.x;
  const int bi = bh / p.h, hi = bh - bi * p.h;
  const int k0 = blockIdx.y * kBwdBK;          // low key tiles see most rows
  // the first query tile with a row that sees key k0: row + offset >= k0
  const int q_first = (p.causal ? max(0, k0 - p.offset) : 0) / kBwdBQ *
                      kBwdBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2 * 128);            // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {                              // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(kv_full, 2 * L::kKV);
      for (int c = 0; c < kCols; ++c) {
        tma_load(sm + L::kK + c * kBwdBK * 128, &tk, kv_full, 64 * c, k0, hi,
                 bi);
        tma_load(sm + L::kV + c * kBwdBK * 128, &tv, kv_full, 64 * c, k0, hi,
                 bi);
      }
      const float* lse2 = p.lse2 + (size_t)bh * p.sq_pad;
      const float* delta = p.delta + (size_t)bh * p.sq_pad;
      for (int j = 0, q0 = q_first; q0 < p.sq; ++j, q0 += kBwdBQ) {
        const int s = j % S;
        if (j >= S) mbar_wait(empty + s, (j / S - 1) & 1);
        mbar_expect_tx(full + s, 2 * L::kRow + 2 * kBwdBQ * 4);
        for (int c = 0; c < kCols; ++c) {
          tma_load(sm + L::kQ + s * L::kRow + c * kBwdBQ * 128, &tq, full + s,
                   64 * c, q0, hi, bi);
          tma_load(sm + L::kDo + s * L::kRow + c * kBwdBQ * 128, &tdo,
                   full + s, 64 * c, q0, hi, bi);
        }
        bulk_load(sm + L::kLse + s * kBwdBQ * 4, lse2 + q0, kBwdBQ * 4,
                  full + s);
        bulk_load(sm + L::kDelta + s * kBwdBQ * 4, delta + q0, kBwdBQ * 4,
                  full + s);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  // a consumer: warpgroup wg owns keys k0 + 64 wg .. + 63; this thread key
  // rows kr and kr + 8 of them, query columns 2 tg, 2 tg + 1 of every
  // 8-column block of S^T and dP^T, dims likewise of dK and dV
  const int wg = warpgroup();
  const int g = lane >> 2, tg = lane & 3;
  const int kr = 16 * (warp & 3) + g;
  const int k_wg = k0 + 64 * wg;
  const float c = p.scale * kLog2e;             // scores in log2 units
  float dk[D / 2], dv[D / 2], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
  const uint8_t* ks = sm + L::kK + 64 * wg * 128;   // the warpgroup's keys
  const uint8_t* vs = sm + L::kV + 64 * wg * 128;
  mbar_wait(kv_full, 0);

  for (int j = 0, q0 = q_first; q0 < p.sq; ++j, q0 += kBwdBQ) {
    const int s = j % S;
    const uint8_t* qs = sm + L::kQ + s * L::kRow;
    const uint8_t* dos = sm + L::kDo + s * L::kRow;
    // no row of the tile sees a key of this warpgroup (causal; only the
    // second warpgroup, on a block's first tiles): nothing to add to dK,
    // dV, or dQ
    const bool dead = p.causal && k_wg > q0 + kBwdBQ - 1 + p.offset;
    if (!dead) {
      const float* lse2 =
          reinterpret_cast<const float*>(sm + L::kLse) + s * kBwdBQ;
      const float* dl =
          reinterpret_cast<const float*>(sm + L::kDelta) + s * kBwdBQ;
      mbar_wait(full + s, (j / S) & 1);
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
      issue_nt<D>(st, ks, kBwdBK, qs, kBwdBQ);    // S^T = K . Q^T
      issue_nt<D>(dpt, vs, kBwdBK, dos, kBwdBQ);  // dP^T = V . dO^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T = exp(S^T - lse) and dS^T = P^T (dP^T - delta) scale, in
      // place; masked (by a select) only where the tile crosses the
      // causal diagonal or the key edge
      const bool edge =
          k_wg + 64 > p.sk || (p.causal && k_wg + 63 > q0 + p.offset);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(lse2 + 8 * n + 2 * tg);
        const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * n + 2 * tg);
#pragma unroll
        for (int i = 4 * n; i < 4 * n + 4; ++i) {
          const int e = i & 1, h = (i >> 1) & 1;
          float pv = fast_exp2(st[i] * c - (e ? l2.y : l2.x));
          if (edge) {
            const int key = k_wg + kr + 8 * h, q = q0 + 8 * n + 2 * tg + e;
            if (key >= p.sk || (p.causal && key > q + p.offset)) pv = 0.f;
          }
          st[i] = pv;
          dpt[i] = pv * (dpt[i] - (e ? d2.y : d2.x)) * p.scale;
        }
      }
      uint32_t pa[4][4], da[4][4];
      pack_p(st, pa);
      pack_p(dpt, da);
      if constexpr (FUSED) {
        // dS^T for the dQ product: key rows of 128 bytes (64 queries)
        // under the 128-byte swizzle, one of two buffers a tile
        uint8_t* dst = sm + L::kDs + (j & 1) * L::kDsTile;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int r = 64 * wg + kr + 8 * (x & 1);    // key row, r & 7 = g
            const int chunk = 2 * kk + (x >> 1);         // 8 queries
            *reinterpret_cast<uint32_t*>(dst + r * 128 + ((chunk ^ g) << 4) +
                                         4 * tg) = da[kk][x];
          }
        fence_async_smem();
      }
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
      issue_rs<D>(dv, pa, dos, kBwdBQ);           // dV += P^T . dO
      issue_rs<D>(dk, da, qs, kBwdBQ);            // dK += dS^T . Q
      wgmma_commit();
    }
    if constexpr (FUSED) {
      // dQ = dS . K into st, free once packed: at head_dim 64 over the
      // warpgroup's own keys (its half of dS^T); at 128 over both halves
      // (the second left out when dead for the second warpgroup), once
      // both warpgroups wrote theirs
      if (threadIdx.x == 128 * wg) bulk_wait_read();   // staging free
      if constexpr (kDqSplitKeys)
        named_sync(2 + wg, 128);
      else
        named_sync(1, 256);
      const bool none = kDqSplitKeys && dead;
      if (!none) {
        const uint8_t* dsb = sm + L::kDs + (j & 1) * L::kDsTile;
        const uint8_t* kb = sm + L::kK;
        fence_regs(st);
        wgmma_fence();
        if constexpr (kDqSplitKeys) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int r = 64 * wg + 16 * kk;
            wgmma_ss_n64<1, 1>(
                st, sw128_desc(dsb + r * 128, kBwdBK * 128, 1024),
                sw128_desc(kb + r * 128, kBwdBK * 128, 1024), kk > 0);
          }
        } else {
          const int steps =
              p.causal && k0 + 64 > q0 + kBwdBQ - 1 + p.offset ? 4 : 8;
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            const int r = 16 * kk;
            if (kk < steps)
              wgmma_ss_n64<1, 1>(
                  st, sw128_desc(dsb + r * 128, kBwdBK * 128, 1024),
                  sw128_desc(kb + wg * kBwdBK * 128 + r * 128, kBwdBK * 128,
                             1024),
                  kk > 0);
          }
        }
        wgmma_commit();
      }
      wgmma_wait<1>();                          // dV and dK
      fence_regs(dv);
      fence_regs(dk);
      mbar_arrive(empty + s);                   // Q and dO of the stage read
      if (!none) {
        wgmma_wait<0>();
        fence_regs(st);
        // the dQ tile through shared memory (the previous tile's reduce
        // has read it: its issuer waited before the dS^T barrier), then
        // two TMA reduce-adds into the workspace
        uint8_t* stg = sm + L::kStage + wg * kDqStage;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * (warp & 3) + g + 8 * h;   // r & 7 = g
            const int chunk = 2 * (n & 3) + (tg >> 1);   // 4 dims
            *reinterpret_cast<float2*>(stg + (n >> 2) * (kDqStage / 2) +
                                       r * 128 + ((chunk ^ g) << 4) +
                                       8 * (tg & 1)) =
                make_float2(st[4 * n + 2 * h], st[4 * n + 2 * h + 1]);
          }
        fence_async_smem();
        named_sync(2 + wg, 128);
        if (threadIdx.x == 128 * wg) {
          const int e0 = kDqSplitKeys ? 0 : 64 * wg;
          const int b_ = blockIdx.x / p.h, h_ = blockIdx.x - b_ * p.h;
          tma_reduce_add(&tacc, stg, e0, q0, h_, b_);
          tma_reduce_add(&tacc, stg + kDqStage / 2, e0 + 32, q0, h_, b_);
          bulk_commit();
        }
      }
    } else {
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      mbar_arrive(empty + s);
    }
  }

  if (FUSED && threadIdx.x == 128 * wg) bulk_wait_all();
  bf16* dkb = head_base<bf16>(p.dk, bh, p.h);
  bf16* dvb = head_base<bf16>(p.dv, bh, p.h);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k_wg + kr + 8 * h;
    if (key >= p.sk) continue;
    bf16* krow = dkb + (long long)key * p.dk.ss;
    bf16* vrow = dvb + (long long)key * p.dv.ss;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(krow + 8 * n + 2 * tg) =
          pack_bf16(dk[4 * n + 2 * h], dk[4 * n + 2 * h + 1]);
      *reinterpret_cast<uint32_t*>(vrow + 8 * n + 2 * tg) =
          pack_bf16(dv[4 * n + 2 * h], dv[4 * n + 2 * h + 1]);
    }
  }
}

// Shared memory of a K3b block: Q and dO [D/64][128][64], then kBwdStages
// x K and V [D/64][64][64], then the barriers.
template <int D> struct DqWgSmem {
  static constexpr int kRows = kBwdQ * D * 2;
  static constexpr int kTile = kBwdKs * D * 2;
  static constexpr int kQ = 0, kDo = kRows, kK = 2 * kRows;
  static constexpr int kV = kK + kBwdStages * kTile;
  static constexpr int kBar = kV + kBwdStages * kTile;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kBwdStages) + 1024;
};

// K3b: see the note at the top. tq, tdo: boxes of 128 rows; tk, tv: 64.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const Params p) {
  using L = DqWgSmem<D>;
  constexpr int kCols = D / 64;
  constexpr int S = kBwdStages;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  const int bh = blockIdx.x;
  const int bi = bh / p.h, hi = bh - bi * p.h;
  const int qt = gridDim.y - 1 - blockIdx.y;    // longest causal rows first
  const int q0 = qt * kBwdQ;
  const int nq = min(kBwdQ, p.sq - q0);
  const int kv_end = p.causal ? min(p.sk, q0 + nq + p.offset) : p.sk;
  const int n_tiles = kv_end > 0 ? (kv_end + kBwdKs - 1) / kBwdKs : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(q_full, 2 * L::kRows);
      for (int c = 0; c < kCols; ++c) {
        tma_load(sm + L::kQ + c * kBwdQ * 128, &tq, q_full, 64 * c, q0, hi,
                 bi);
        tma_load(sm + L::kDo + c * kBwdQ * 128, &tdo, q_full, 64 * c, q0, hi,
                 bi);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % S;
        if (j >= S) mbar_wait(empty + s, (j / S - 1) & 1);
        mbar_expect_tx(full + s, 2 * L::kTile);
        for (int c = 0; c < kCols; ++c) {
          tma_load(sm + L::kK + s * L::kTile + c * kBwdKs * 128, &tk,
                   full + s, 64 * c, j * kBwdKs, hi, bi);
          tma_load(sm + L::kV + s * L::kTile + c * kBwdKs * 128, &tv,
                   full + s, 64 * c, j * kBwdKs, hi, bi);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  // a consumer: warpgroup wg owns rows q0 + 64 wg .. + 63; this thread
  // rows r0 and r0 + 8, key columns 2 tg, 2 tg + 1 of every 8-column block
  const int wg = warpgroup();
  const int g = lane >> 2, tg = lane & 3;
  const int q_wg = q0 + 64 * wg;
  const int r0 = q_wg + 16 * (warp & 3) + g;
  const float c = p.scale * kLog2e;
  float lr[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {                 // padded rows: +inf and 0
    lr[h] = p.lse2[(size_t)bh * p.sq_pad + r0 + 8 * h];
    dl[h] = p.delta[(size_t)bh * p.sq_pad + r0 + 8 * h];
  }
  float dq[D / 2], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
  const uint8_t* qs = sm + L::kQ + 64 * wg * 128;
  const uint8_t* dos = sm + L::kDo + 64 * wg * 128;
  mbar_wait(q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % S, k0 = j * kBwdKs;
    const uint8_t* ks = sm + L::kK + s * L::kTile;
    const uint8_t* vs = sm + L::kV + s * L::kTile;
    mbar_wait(full + s, (j / S) & 1);
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
    issue_nt<D>(st, qs, kBwdQ, ks, kBwdKs);     // S = Q . K^T
    issue_nt<D>(dpt, dos, kBwdQ, vs, kBwdKs);   // dP = dO . V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    const bool edge = k0 + kBwdKs > p.sk ||
                      (p.causal && k0 + kBwdKs - 1 > q_wg + p.offset);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      float pv = fast_exp2(st[i] * c - lr[h]);
      if (edge) {
        const int key = k0 + 8 * (i >> 2) + 2 * tg + (i & 1);
        if (key >= p.sk || (p.causal && key > r0 + 8 * h + p.offset))
          pv = 0.f;
      }
      dpt[i] = pv * (dpt[i] - dl[h]) * p.scale;
    }
    uint32_t da[4][4];
    pack_p(dpt, da);
    fence_regs(dq);
    wgmma_fence();
    issue_rs<D>(dq, da, ks, kBwdKs);            // dQ += dS . K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    mbar_arrive(empty + s);
  }

  bf16* dqb = head_base<bf16>(p.dq, bh, p.h);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= p.sq) continue;
    bf16* row = dqb + (long long)r * p.dq.ss;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + 8 * n + 2 * tg) =
          pack_bf16(dq[4 * n + 2 * h], dq[4 * n + 2 * h + 1]);
  }
}

// ---------------------------------------------------------------- launch
template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, dim3 grid, size_t smem,
                          const Params& p, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// cuTensorMapEncodeTiled, found through the runtime: the library is not
// linked against the driver library
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A bf16 [b, s, h, d] view (f32 with `f32`) as a tensor map of dims (d,
// s, h, b) and boxes of 128 bytes of a row (64 bf16 or 32 f32 dims) x
// `rows` rows, 128-byte swizzled; rows past s read as zeros and are left
// out of writes.
bool tensor_map(CUtensorMap* map, const View& v, int b, int s, int h, int d,
                int rows, bool f32 = false) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const int elem = f32 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)v.ss * elem,
                                 (cuuint64_t)v.sh * elem,
                                 (cuuint64_t)v.sb * elem};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / elem), (cuuint32_t)rows, 1,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            4, v.p, dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t fwd_wgmma(const Params& p, int bh, cudaStream_t s) {
  const int b = bh / p.h;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, p.q, b, p.sq, p.h, D, kBQ) ||
      !tensor_map(&tk, p.k, b, p.sk, p.h, D, kBK) ||
      !tensor_map(&tv, p.v, b, p.sk, p.h, D, kBK))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_wgmma_kernel<D>;
  constexpr int smem = WgSmem<D>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((p.sq + kBQ - 1) / kBQ, bh), kWgThreads, smem, s>>>(
      tq, tk, tv, p);
  return cudaGetLastError();
}

// K1's route: bf16 at head_dim 64 and 128 takes the wgmma + TMA kernel;
// f32 (exact FFMA) and head_dim 256 (whose tiles outgrow the registers)
// take flash_fwd_kernel.
template <typename T, int D>
cudaError_t fwd(const Params& p, int bh, cudaStream_t s) {
  if constexpr (std::is_same<T, bf16>::value && D <= 128) {
    return fwd_wgmma<D>(p, bh, s);
  } else {
    const dim3 grid(cdiv(p.sq, Tiles<T, D>::BQ), bh);
    return launch_kernel(flash_fwd_kernel<T, D>, grid,
                         FwdSmem<T, D>(0).bytes, p, s);
  }
}

// The backward's pre-pass: delta and lse2 (and K2's zeroed workspace).
template <typename T, int D>
cudaError_t bwd_preprocess(const Params& p, cudaStream_t s) {
  const long long threads =
      (long long)p.b * p.h * p.sq_pad * RowGroup<T, D>::G;
  flash_bwd_preprocess_kernel<T, D>
      <<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(p);
  return cudaGetLastError();
}

// K2's post-pass: the f32 workspace into dq in the input type.
template <typename T, int D>
cudaError_t bwd_dq_convert(const Params& p, cudaStream_t s) {
  const long long threads = (long long)p.b * p.sq * p.h * D / 8;
  flash_bwd_dq_convert_kernel<T, D>
      <<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(p);
  return cudaGetLastError();
}

// K2 (fused) or K3 on the TMA + wgmma kernels (bf16, head_dim 64 / 128),
// after the pre-pass. A tensor map that does not encode is an error.
template <int D>
cudaError_t bwd_wgmma(const Params& p, bool fused, cudaStream_t s) {
  const int bh = p.b * p.h;
  CUtensorMap tk, tv, tq, tdo;
  if (!tensor_map(&tk, p.k, p.b, p.sk, p.h, D, kBwdBK) ||
      !tensor_map(&tv, p.v, p.b, p.sk, p.h, D, kBwdBK) ||
      !tensor_map(&tq, p.q, p.b, p.sq, p.h, D, kBwdBQ) ||
      !tensor_map(&tdo, p.dout, p.b, p.sq, p.h, D, kBwdBQ))
    return cudaErrorInvalidValue;
  const dim3 gk(bh, cdiv(p.sk, kBwdBK));
  cudaError_t err;
  if (fused) {
    // K2's workspace: contiguous f32 [b, sq, h, d]
    const View acc{p.dq_acc, (long long)p.sq * p.h * D, (long long)p.h * D,
                   D};
    CUtensorMap tacc;
    if (!tensor_map(&tacc, acc, p.b, p.sq, p.h, D, 64, true))
      return cudaErrorInvalidValue;
    auto kernel = flash_bwd_dkv_wgmma_kernel<D, true>;
    constexpr int smem = DkvWgSmem<D, true>::kBytes;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<gk, kWgThreads, smem, s>>>(tk, tv, tq, tdo, tacc, p);
    return cudaGetLastError();
  }
  auto dkv = flash_bwd_dkv_wgmma_kernel<D, false>;
  constexpr int dkv_smem = DkvWgSmem<D, false>::kBytes;
  err = cudaFuncSetAttribute(
      dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_smem);
  if (err != cudaSuccess) return err;
  dkv<<<gk, kWgThreads, dkv_smem, s>>>(tk, tv, tq, tdo, tk, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap tq2, tdo2, tk2, tv2;
  if (!tensor_map(&tq2, p.q, p.b, p.sq, p.h, D, kBwdQ) ||
      !tensor_map(&tdo2, p.dout, p.b, p.sq, p.h, D, kBwdQ) ||
      !tensor_map(&tk2, p.k, p.b, p.sk, p.h, D, kBwdKs) ||
      !tensor_map(&tv2, p.v, p.b, p.sk, p.h, D, kBwdKs))
    return cudaErrorInvalidValue;
  auto dq = flash_bwd_dq_wgmma_kernel<D>;
  constexpr int dq_smem = DqWgSmem<D>::kBytes;
  err = cudaFuncSetAttribute(
      dq, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (err != cudaSuccess) return err;
  dq<<<dim3(bh, cdiv(p.sq, kBwdQ)), kWgThreads, dq_smem, s>>>(tq2, tdo2,
                                                               tk2, tv2, p);
  return cudaGetLastError();
}

// K2: the pre-pass, the dk/dv kernel that adds dq into the workspace, the
// post-pass. K3: the pre-pass, the dk/dv kernel, the dq kernel. bf16 at
// head_dim 64 and 128 takes the wgmma + TMA kernels; f32 and head_dim
// 256 the first port's.
template <typename T, int D>
cudaError_t bwd(const Params& p, bool fused, cudaStream_t s) {
  cudaError_t err = bwd_preprocess<T, D>(p, s);
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same<T, bf16>::value && D <= 128) {
    err = bwd_wgmma<D>(p, fused, s);
  } else if (fused) {
    err = launch_kernel(flash_bwd_dkv_kernel<T, D, true>,
                        dim3(cdiv(p.sk, Tiles<T, D>::BK), p.b * p.h),
                        DkvSmem<T, D, true>(0).bytes, p, s);
  } else {
    err = launch_kernel(flash_bwd_dkv_kernel<T, D, false>,
                        dim3(cdiv(p.sk, Tiles<T, D>::BK), p.b * p.h),
                        DkvSmem<T, D, false>(0).bytes, p, s);
    if (err == cudaSuccess)
      err = launch_kernel(flash_bwd_dq_kernel<T, D>,
                          dim3(cdiv(p.sq, Tiles<T, D>::BQ), p.b * p.h),
                          DqSmem<T, D>(0).bytes, p, s);
  }
  if (err != cudaSuccess || !fused) return err;
  return bwd_dq_convert<T, D>(p, s);
}

// which: 0 K1, 1 K2, 2 K3, 3 the backward's pre-pass alone
template <typename T>
cudaError_t dispatch(int which, int d, const Params& p, cudaStream_t s) {
#define FA_CASE(D)                                          \
  case D:                                                   \
    return which == 0   ? fwd<T, D>(p, p.b * p.h, s)        \
           : which == 3 ? bwd_preprocess<T, D>(p, s)        \
                        : bwd<T, D>(p, which == 1, s);
  switch (d) {
    FA_CASE(64)
    FA_CASE(128)
    FA_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FA_CASE
}

View view(const void* ptr, const long long* st) {
  return View{const_cast<void*>(ptr), st[0], st[1], st[2]};
}

int run(int which, Params& p, int b, int d, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  p.b = b;
  p.offset = p.sk - p.sq;
  p.sq_pad = cdiv(p.sq, 128) * 128;
  return (int)(is_bf16 ? dispatch<bf16>(which, d, p, s)
                       : dispatch<float>(which, d, p, s));
}

}  // namespace

extern "C" {

// Every entry launches on `stream`, does not synchronise and allocates
// nothing. `strides` holds (batch, seq, head) strides in elements, three
// per tensor, in the order of the tensor arguments. The caller has checked
// dtypes, shapes, head_dim (64, 128 or 256), unit stride on d and 16-byte
// alignment. Each returns the CUDA error of its launches (0 on success).

// K1: out [b, sq, h, d] and lse [b*h, sq] from q, k, v.
int fa_fwd(const void* q, const void* k, const void* v, void* out,
           float* lse, const long long* strides, int b, int h, int sq,
           int sk, int d, int causal, float scale, int is_bf16,
           void* stream) {
  Params p{};
  p.q = view(q, strides);
  p.k = view(k, strides + 3);
  p.v = view(v, strides + 6);
  p.o = view(out, strides + 9);
  p.lse_out = lse;
  p.h = h; p.sq = sq; p.sk = sk; p.causal = causal; p.scale = scale;
  return run(0, p, b, d, is_bf16, stream);
}

// K2 (fused = 1) and K3 (fused = 0): dq, dk, dv in the input type.
// Tensors: q, k, v, out, do, dq, dk, dv; lse is [b*h, sq] f32; `rows` is
// f32 scratch [2, b*h, sq_pad] (sq_pad = sq rounded up to 128) for the
// pre-pass's delta and lse2; `dq_acc` (K2 only, else null) is f32 scratch
// [b, sq, h, d], contiguous, which the pre-pass zeroes.
int fa_bwd(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* rows, float* dq_acc,
           void* dq, void* dk, void* dv, const long long* strides, int b,
           int h, int sq, int sk, int d, int causal, float scale,
           int is_bf16, int fused, void* stream) {
  Params p{};
  p.q = view(q, strides);
  p.k = view(k, strides + 3);
  p.v = view(v, strides + 6);
  p.o = view(out, strides + 9);
  p.dout = view(dout, strides + 12);
  p.dq = view(dq, strides + 15);
  p.dk = view(dk, strides + 18);
  p.dv = view(dv, strides + 21);
  p.lse_in = lse;
  p.delta = rows;
  p.lse2 = rows + (size_t)b * h * (cdiv(sq, 128) * 128);
  p.dq_acc = fused ? dq_acc : nullptr;
  p.h = h; p.sq = sq; p.sk = sk; p.causal = causal; p.scale = scale;
  return run(fused ? 1 : 2, p, b, d, is_bf16, stream);
}

// The backward's pre-pass alone, into `rows` as fa_bwd's: tensors out,
// do ([b, sq, h, d]); lse [b*h, sq] f32.
int fa_bwd_preprocess(const void* out, const void* dout, const float* lse,
                      float* rows, const long long* strides, int b, int h,
                      int sq, int d, int is_bf16, void* stream) {
  Params p{};
  p.o = view(out, strides);
  p.dout = view(dout, strides + 3);
  p.lse_in = lse;
  p.delta = rows;
  p.lse2 = rows + (size_t)b * h * (cdiv(sq, 128) * 128);
  p.h = h; p.sq = sq; p.sk = sq;
  return run(3, p, b, d, is_bf16, stream);
}

const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
