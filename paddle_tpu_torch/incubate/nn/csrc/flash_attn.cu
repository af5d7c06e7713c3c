// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/incubate/nn/pallas/flash_attn.py:
//   K1  flash_fwd_kernel          <- `_fwd_kernel` (via `_flash_fwd`)
//   K2  flash_bwd_dkv_kernel<..., fused=true>
//                                 <- `_bwd_fused_kernel` (via `_flash_bwd_fused`)
//   K3  flash_bwd_dkv_kernel<..., fused=false> + flash_bwd_dq_kernel
//                                 <- `_bwd_dkv_kernel` + `_bwd_dq_kernel`
//                                    (via `_flash_bwd_split`)
//
// Semantics are the TPU kernels': scores s = (q . k) * scale in f32; causal
// masking is bottom-right aligned (query row i sees keys j <= i + sk - sq);
// the forward keeps the online softmax (m, l, acc) in f32 and writes out =
// acc / l in the input type and lse = m + log(l) in f32, with out 0 and lse
// -1e30 for a row that sees no key; p (and ds) are rounded to the input type
// before the p.v, p^T.do, ds^T.q and ds.k products. The backward takes the
// saved lse and delta = rowsum(do * out) (computed by the caller) and
// recomputes p = exp(s - lse), forced to 0 outside the mask by a select
// (never by a multiply: a masked row's lse of -1e30 overflows the exp).
//
// Layouts: q, k, v, out, do, dq, dk, dv are [b, s, h, d] views with unit
// stride on d and any other strides (multiples of 16 bytes), so the
// training path hands the q/k/v slices of its fused qkv projection over
// without a copy. lse and delta are contiguous f32 [b*h, sq]. K2's dq is an
// f32 [b, sq, h, d] workspace zeroed by the caller.
//
// What bounds them on an H100: at the training shapes (b 8, h 16, s 1024,
// d 128, bf16, causal) K1 does 4*d flops per unmasked (query, key) pair,
// ~34 GFLOP, and must move q, k, v, out and lse, ~135 MB: 0.035 ms of
// tensor-core time against 0.040 ms of memory time, so it is close to
// balanced. K2 does 10*d flops per pair (five products), ~86 GFLOP, and
// its call moves ~269 MB (q, k, v, out, do and lse in, dq, dk, dv out):
// 0.087 ms of tensor-core time against 0.080 ms of memory time, so it is
// bound by operations. K3 recomputes s and dp in both its kernels: 14*d flops per
// pair, ~120 GFLOP.
//
// What the simple design does about it: the products run on the tensor
// cores through WMMA (16x16x16 bf16 fragments, f32 accumulate) for bf16
// inputs, and as plain f32 FMA loops for f32 inputs (exact, slow: f32 is
// for tests and the CPU-parity checks). Every operand tile sits in shared
// memory, which the fragments load from and store back to, so the
// elementwise softmax steps see plain f32 tiles; tiles are 64x64 (32x32 at
// d 256 in bf16, smaller still in f32) so that a block's tiles fit in
// 227 KB. The TPU grid ran in order with m/l/acc (K1), dk/dv (K2, K3) and
// a whole-sequence dq (K2) carried in VMEM across the sequential axis; on
// a GPU blocks run in parallel and in no order, so each block owns one
// (batch*head, tile) and loops over the other axis itself. K2's dq, which
// every k tile adds into, goes to an f32 workspace in device memory by
// atomicAdd (so its summation order changes from run to run). Not done
// yet (later work): wgmma, TMA and a multi-stage ring of tiles, keeping
// accumulators in registers, and exp2 with a folded log2(e) scale.

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

// Tile shapes per (input type, head_dim), sized so that the largest block
// (K2's) stays inside 227 KB of shared memory.
template <typename T, int D> struct Tiles;
template <> struct Tiles<bf16, 64>  { static constexpr int BQ = 64, BK = 64; };
template <> struct Tiles<bf16, 128> { static constexpr int BQ = 64, BK = 64; };
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
  const float* delta;    // [b*h, sq]
  float* lse_out;        // [b*h, sq]
  int h, sq, sk, causal, offset;   // offset = sk - sq
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
  const float* delta = p.delta + (size_t)bh * p.sq;
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
      float* dqb = head_base<float>(p.dq, bh, p.h);
      const int nq = min(BQ, p.sq - q0);
      for (int i = tid; i < nq * D; i += kThreads) {
        const int r = i / D, e = i - r * D;
        atomicAdd(dqb + (q0 + r) * p.dq.ss + e, sm.dqt[r * L::A_ROW + e]);
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
    sm.delta[i] = in ? p.delta[(size_t)bh * p.sq + q0 + i] : 0.f;
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

template <typename T, int D>
cudaError_t fwd(const Params& p, int bh, cudaStream_t s) {
  const dim3 grid(cdiv(p.sq, Tiles<T, D>::BQ), bh);
  return launch_kernel(flash_fwd_kernel<T, D>, grid,
                       FwdSmem<T, D>(0).bytes, p, s);
}

template <typename T, int D>
cudaError_t bwd_fused(const Params& p, int bh, cudaStream_t s) {
  const dim3 grid(cdiv(p.sk, Tiles<T, D>::BK), bh);
  return launch_kernel(flash_bwd_dkv_kernel<T, D, true>, grid,
                       DkvSmem<T, D, true>(0).bytes, p, s);
}

template <typename T, int D>
cudaError_t bwd_split(const Params& p, int bh, cudaStream_t s) {
  const dim3 gk(cdiv(p.sk, Tiles<T, D>::BK), bh);
  cudaError_t err = launch_kernel(flash_bwd_dkv_kernel<T, D, false>, gk,
                                  DkvSmem<T, D, false>(0).bytes, p, s);
  if (err != cudaSuccess) return err;
  const dim3 gq(cdiv(p.sq, Tiles<T, D>::BQ), bh);
  return launch_kernel(flash_bwd_dq_kernel<T, D>, gq, DqSmem<T, D>(0).bytes,
                       p, s);
}

template <typename T>
cudaError_t dispatch(int which, int d, const Params& p, int bh,
                     cudaStream_t s) {
#define FA_CASE(D)                                     \
  case D:                                              \
    return which == 0   ? fwd<T, D>(p, bh, s)          \
           : which == 1 ? bwd_fused<T, D>(p, bh, s)    \
                        : bwd_split<T, D>(p, bh, s);
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
  p.offset = p.sk - p.sq;
  const int bh = b * p.h;
  return (int)(is_bf16 ? dispatch<bf16>(which, d, p, bh, s)
                       : dispatch<float>(which, d, p, bh, s));
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

// K2 (fused = 1): dk, dv, and dq added into the zeroed f32 workspace `dq`.
// K3 (fused = 0): dk, dv, then dq written in the input type.
// Tensors: q, k, v, do, dq, dk, dv; lse and delta are [b*h, sq] f32.
int fa_bwd(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk,
           void* dv, const long long* strides, int b, int h, int sq, int sk,
           int d, int causal, float scale, int is_bf16, int fused,
           void* stream) {
  Params p{};
  p.q = view(q, strides);
  p.k = view(k, strides + 3);
  p.v = view(v, strides + 6);
  p.dout = view(dout, strides + 9);
  p.dq = view(dq, strides + 12);
  p.dk = view(dk, strides + 15);
  p.dv = view(dv, strides + 18);
  p.lse_in = lse;
  p.delta = delta;
  p.h = h; p.sq = sq; p.sk = sk; p.causal = causal; p.scale = scale;
  return run(fused ? 1 : 2, p, b, d, is_bf16, stream);
}

const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
