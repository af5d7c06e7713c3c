// Ring steps between the cards of a ring of devices on Hopper (sm_90a): K9
// (a TP ring step: the copy to the neighbour riding on the GEMM's loads)
// and K10 (a ring shift).
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
// 4096], w [4096, 512] a rank) does 34.4 GFLOP a rank. In f32, outside the
// tensor cores, that is 0.513 ms at 67 TFLOP/s, against 0.298 ms for its
// 134 MB over NVLink (450 GB/s each way) or 0.080 ms for a local copy's
// 268 MB of reads and writes: bound by operations. In bf16 the product is
// 0.035 ms of tensor-core time against 0.043 ms for a rank's 146 MB of HBM
// traffic (buf read once, next written, w and partial) on one card, or
// 0.149 ms for the 67 MB copy over NVLink: bound by bytes. K10 at bench.py's
// pipeline leg moves 8.4 MB ([1, 1024, 2048] f32): 0.019 ms over NVLink,
// 0.005 ms as a local copy: bound by bytes, and at that size by its launch.
//
// The design. The copy rides on the product's own loads, as the TPU kernel
// staged `buf` into VMEM while its remote DMA ran: every K step of a row
// block's A tile is loaded by each of the row block's column tiles, and the
// one whose index is the step's index modulo the column tiles also stores
// what it loaded into `next`. So `buf` is read from device memory once for
// both uses (the other column tiles find it in L2), and the copy's stores
// are spread evenly over the whole kernel.
// * bf16 (`ring_mm_step_wgmma_kernel<BN>`, K8's design copied from
//   moe_dispatch.cu and not shared, so that K8 does not change): a
//   persistent grid, one block an SM, over (128-row block, BN-column tile)
//   items, row block by row block. A producer warpgroup (registers given
//   away by setmaxnreg) feeds a 3-stage ring by TMA: 128 rows x 64 K of buf
//   and BN/64 boxes of 64 K x 64 columns of w, under the 128-byte swizzle.
//   Two consumer warpgroups run wgmma m64nBNk16 on 64 rows each, w read as
//   an MN-major B operand, one stage's products in flight while the next is
//   awaited. The producer's other three warps are the copy: they read each
//   arrived A stage from shared memory, undo the swizzle and store it with
//   16-byte stores (a plain store reaches a peer card too). A stage is
//   released only when the consumers and the copy warps are done with it.
//   The epilogue rounds to bf16 once and stores by TMA. BN is chosen from
//   the item count: 256 while the items fill three quarters of the SMs,
//   else 64 (mp 4's [4096, 4096] x [4096, 256] block is 32 items at 256
//   columns, 128 at 64; 128 columns ran 13% slower there, 256 twice as
//   slow: ring_ab.py). No split K and no atomics: every output is
//   one warpgroup's sum in a fixed order, the same bits every launch.
// * f32 (`ring_mm_step_f32_kernel<BM>`): exact f32 on the CUDA cores (FFMA;
//   TF32 would change the rounding). A 128 x 128 block tile, or 64 x 128
//   when 128-row tiles would leave SMs without one (mp 4's block: 128
//   tiles; 64 x 64 tiles, 256 of them, ran 12% slower), (BM / 16) x 8
//   outputs a thread in a warp layout whose shared-memory reads are
//   conflict-free broadcasts, K in steps of 16 through a 2-stage ring: A
//   through registers (stored transposed, and into `next` by the thread
//   that loaded it when the step is its tile's to copy), B by cp.async,
//   both for step k + 1 in flight while step k's products run, one barrier
//   a step; two blocks an SM.
// What holds them back now (PERF.md, tools/ring_ab.py): in bf16 the feed,
// not the tensor cores (without its products the kernel takes 93-97% of its
// time; every item reads its w slice and its A tiles from L2) and the copy
// (a third of the time); in f32 FFMA issue (63% of the peak at mp 2) and
// the copy (6%). Separate copy blocks (the A/B tool's `copy_blocks`) lost
// at mp 2 and 4 on one card, and in f32 across cards (a tie in bf16).
// Not done yet (later work): 2-block clusters sharing tiles by TMA
// multicast, the copy engine for K10, and a TMA store of `next` (a tensor
// map over a peer buffer, untried).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;            // K10's blocks, and f32 K9's
constexpr int kUnroll = 4;               // 16-byte loads in flight a thread

// n16 chunks of 16 bytes from src to dst, shared out over `nblk` blocks of
// which this is block `blk`: kUnroll loads in flight before their stores.
__device__ __forceinline__ void copy16(uint4* __restrict__ dst,
                                       const uint4* __restrict__ src,
                                       size_t n16, size_t blk, size_t nblk) {
  const size_t stride = nblk * blockDim.x;
  size_t i = blk * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n16; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = src[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dst[i + u * stride] = v[u];
  }
  for (; i < n16; i += stride) dst[i] = src[i];
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory, or 16 zero bytes when
// `valid` is false (the source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------------------------ bf16
constexpr int kBM = 128;                 // rows of an item: 2 x 64
constexpr int kTK = 64;                  // K of a ring stage: 128 bytes
constexpr int kStages = 3;
constexpr int kABytes = kBM * kTK * 2;   // 16 KB: 128 rows x 64 K
constexpr int kBoxBytes = kTK * 64 * 2;  // 8 KB: 64 K x 64 columns of w
constexpr int kOutBox = 64 * 64 * 2;     // 8 KB: 64 rows x 64 columns
// two consumer warpgroups and a producer warpgroup (one TMA thread, three
// copy warps); setmaxnreg moves the producer's registers to the consumers
// (40 + 2 x 232 = 3 x 168, the block's allocation)
constexpr int kWgThreads = 3 * 128;
constexpr int kCopyThreads = 96;         // warps 9-11
// arrivals that release a stage: every consumer and copy thread
constexpr int kRelease = 2 * 128 + kCopyThreads;

// Shared memory of a block, 1024-byte aligned pieces: the ring's A and B
// stages, each consumer warpgroup's output tile, then the barriers.
template <int BN>
struct Smem {
  static constexpr int kBBytes = BN / 64 * kBoxBytes;
  static constexpr int kOutWg = BN / 64 * kOutBox;
  static constexpr int kA = 0;
  static constexpr int kB = kA + kStages * kABytes;
  static constexpr int kOut = kB + kStages * kBBytes;
  static constexpr int kBar = kOut + 2 * kOutWg;
  static constexpr int kBytes = kBar + 8 * 2 * kStages + 1024;
};

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

// one box of a 2-D tensor map into shared memory, completing on `bar`
// (elements past the tensor's edge read as zeros)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// one box of shared memory into a 2-D tensor map (elements past the
// tensor's edge are left out), as a bulk operation of this thread's group
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
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

// the threads' own shared-memory writes, made visible to TMA's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// this thread's warpgroup, as a value the compiler knows to be the same
// across the warp (so that branches on it around wgmma stay convergent)
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
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

// d (64 x N f32, registers) += a . b: a (64 x 16) bf16 K-major and b
// (16 x N) bf16 MN-major, both in shared memory under the 128-byte swizzle
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db);

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<256>(float (&d)[128], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// K9 in bf16 (see the note at the top). ta: buf [t, k] as dims (k, t),
// boxes of 64 K x 128 rows; tb: w [k, n] as dims (n, k), boxes of 64
// columns x 64 K; tc: partial [t, n] as dims (n, t), boxes of 64 columns x
// 64 rows; all under the 128-byte swizzle. Item i is row block i / n_tiles,
// column tile i % n_tiles.
template <int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
ring_mm_step_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                          const __grid_constant__ CUtensorMap tb,
                          const __grid_constant__ CUtensorMap tc,
                          const bf16* __restrict__ buf,
                          bf16* __restrict__ next, int t, int k,
                          int n) {
  using S = Smem<BN>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::kBar);
  uint64_t* empty = full + kStages;

  const int n_tiles = (n + BN - 1) / BN;
  const int items = (t + kBM - 1) / kBM * n_tiles;
  const int nk = (k + kTK - 1) / kTK;
  const int first = (int)blockIdx.x;
  const int stride = (int)gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kRelease);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == 2) {                                // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8) {                            // one thread issues TMA
      if (lane == 0) {
        int it = 0;                             // stages filled so far
        for (int i = first; i < items; i += stride) {
          const int blk = i / n_tiles, n0 = (i - blk * n_tiles) * BN;
          const int nb = min(BN / 64, (n - n0 + 63) / 64);
          for (int kt = 0; kt < nk; ++kt, ++it) {
            const int s = it % kStages;
            if (it >= kStages) mbar_wait(empty + s, (it / kStages - 1) & 1);
            mbar_expect_tx(full + s, kABytes + nb * kBoxBytes);
            tma_load_2d(sm + S::kA + s * kABytes, &ta, full + s, kt * kTK,
                        blk * kBM);
            uint8_t* bs = sm + S::kB + s * S::kBBytes;
            for (int c = 0; c < nb; ++c)
              tma_load_2d(bs + c * kBoxBytes, &tb, full + s, n0 + 64 * c,
                          kt * kTK);
          }
        }
      }
      return;
    }
    // the copy warps: stage kt of row block blk is stored into `next` by
    // the item of column tile kt % n_tiles; rows 128 bytes, the 16-byte
    // chunk c of row q at c ^ (q & 7) under the swizzle
    const int ct = threadIdx.x - (kWgThreads - kCopyThreads);
    int it = 0;
    for (int i = first; i < items; i += stride) {
      const int blk = i / n_tiles, tn = i - blk * n_tiles;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(full + s, (it / kStages) & 1);
        if (kt % n_tiles == tn) {
          const uint8_t* as = sm + S::kA + s * kABytes;
#pragma unroll 2
          for (int c = ct; c < kBM * 8; c += kCopyThreads) {
            const int q = c >> 3, ch = c & 7;
            const int row = blk * kBM + q, col = kt * kTK + ch * 8;
            if (row < t && col < k)
              *reinterpret_cast<uint4*>(next + (size_t)row * k + col) =
                  *reinterpret_cast<const uint4*>(as + q * 128 +
                                                  ((ch ^ (q & 7)) << 4));
          }
        }
        mbar_arrive(empty + s);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // a consumer: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile;
  // this thread rows r and r + 8 of them, columns 2 tg, 2 tg + 1 of every
  // 8-column group of the accumulators
  const int g8 = lane >> 2, tg = lane & 3;
  const int r = 16 * (warp & 3) + g8;
  uint8_t* ep = sm + S::kOut + wg * S::kOutWg;
  const bool leader = (threadIdx.x & 127) == 0;
  float acc[BN / 2];
  int it = 0;                                   // stages consumed so far
  for (int i = first; i < items; i += stride) {
    const int blk = i / n_tiles, n0 = (i - blk * n_tiles) * BN;
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
    fence_regs(acc);
    // no access to acc in the loop: one stage's products stay in flight
    // while the next stage is awaited
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(full + s, (it / kStages) & 1);
      const uint8_t* as = sm + S::kA + s * kABytes + wg * 64 * 128;
      const uint8_t* bs = sm + S::kB + s * S::kBBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk)     // 16 K a step
        wgmma<BN>(acc, sw128_desc(as + kk * 32, 16, 1024),
                  sw128_desc(bs + kk * 16 * 128, kBoxBytes, 1024));
      wgmma_commit();
      wgmma_wait<1>();                          // the last stage's products
      if (kt > 0) mbar_arrive(empty + (it - 1) % kStages);
    }
    wgmma_wait<0>();
    mbar_arrive(empty + (it - 1) % kStages);
    fence_regs(acc);

    // rounded once to bf16 into the warpgroup's 64 x 64 boxes (128-byte
    // rows, swizzled: q & 7 = g8 here), then stored by TMA (rows past t
    // and columns past n are left out)
    if (leader) bulk_wait_read();               // the last tile's store
    named_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = r + 8 * h;
        *reinterpret_cast<uint32_t*>(ep + (j >> 3) * kOutBox + q * 128 +
                                     (((j & 7) ^ g8) << 4) + 4 * tg) =
            pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    fence_async_smem();
    named_sync(1 + wg, 128);
    if (leader) {
      for (int c = 0; c < BN / 64 && n0 + 64 * c < n; ++c)
        tma_store_2d(&tc, ep + c * kOutBox, n0 + 64 * c,
                     blk * kBM + 64 * wg);
      bulk_commit();
    }
  }
  if (leader) bulk_wait_all();
}

// ------------------------------------------------------------------- f32
// K9 in f32 (see the note at the top): a BM x 128 tile a block of 256
// threads, K in steps of 16. Warps 2 (rows) x 4 (columns), each a (BM / 2)
// x 32 tile; lane (lm, ln) = (lane / 4, lane % 4) holds rows lm * 4 + 32 i
// + 0..3 and columns ln * 4 + 16 j + 0..3 of it, so that a warp's reads of
// a K step's A and B values are 8 and 4 distinct 16-byte words.
constexpr int kBN32 = 128, kBK32 = 16;

template <int BM>
__global__ void __launch_bounds__(kThreads, 2)
ring_mm_step_f32_kernel(const float* __restrict__ a,
                        const float* __restrict__ w, float* __restrict__ out,
                        float* __restrict__ next, int t, int k, int n,
                        int tiles_n) {
  constexpr int TM = BM / 16;              // a thread's rows: 8 or 4
  constexpr int LDA = BM + 4;              // A transposed, [k][m], padded
  constexpr int A_PER = BM / 64;           // 16-byte A loads a thread
  __shared__ __align__(16) float as[2][kBK32][LDA];
  __shared__ __align__(16) float bs[2][kBK32][kBN32];
  const int b = (int)blockIdx.x;
  const int tm = b / tiles_n, tn = b - tm * tiles_n;
  const int row0 = tm * BM, n0 = tn * kBN32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mrow = (warp >> 2) * (BM / 2) + (lane >> 2) * 4;
  const int ncol = (warp & 3) * 32 + (lane & 3) * 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // A: 16 bytes of rows tid / 4 + 64 i, K 4 (tid % 4) .. + 3 of a step,
  // stored transposed (LDA = BM + 4: a warp's 8 rows x 4 K groups land on
  // banks two to one at most) and, on the steps this tile copies
  // (kt % tiles_n == tn), into `next` at a_src's offset (a pointer of its
  // own made ptxas spill at 128 registers: tools/ring_ab.py). B: rows
  // tid / 32 + 8 i of a step, columns 4 (tid % 32) .. + 3, by cp.async.
  const int ra = tid >> 2, ka = (tid & 3) * 4;
  const int rb = tid >> 5, cb = (tid & 31) * 4;
  const bool b_in = n0 + cb < n;
  const float* a_src = a + (size_t)(row0 + ra) * k + ka;

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 av[A_PER];
  auto load_a = [&](int kt) {
    const int kc = kt * kBK32;
#pragma unroll
    for (int i = 0; i < A_PER; ++i)
      av[i] = row0 + ra + 64 * i < t && kc + ka < k
          ? *reinterpret_cast<const float4*>(a_src + (size_t)64 * i * k +
                                             kc)
          : zero;
  };
  auto load_b = [&](int kt) {
    const int s = kt & 1, kr = kt * kBK32 + rb;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool ok = b_in && kr + 8 * i < k;
      cp_async16(&bs[s][rb + 8 * i][cb],
                 ok ? w + (size_t)(kr + 8 * i) * n + n0 + cb : w, ok);
    }
    cp_async_commit();
  };
  auto store_a = [&](int kt) {
    const int s = kt & 1, kc = kt * kBK32;
    const bool copy = kt % tiles_n == tn && kc + ka < k;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int r = ra + 64 * i;
      as[s][ka][r] = av[i].x;
      as[s][ka + 1][r] = av[i].y;
      as[s][ka + 2][r] = av[i].z;
      as[s][ka + 3][r] = av[i].w;
      if (copy && row0 + r < t)
        *reinterpret_cast<float4*>(next + (a_src - a) + (size_t)64 * i * k +
                                   kc) = av[i];
    }
  };

  const int nk = (k + kBK32 - 1) / kBK32;
  load_a(0);
  load_b(0);
  store_a(0);
  cp_async_wait_all();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) {                     // step kt + 1 in flight
      load_a(kt + 1);
      load_b(kt + 1);
    }
#pragma unroll
    for (int kk = 0; kk < kBK32; ++kk) {
      float af[TM], bf[8];
#pragma unroll
      for (int i4 = 0; i4 < TM / 4; ++i4) {
        const float4 x =
            *reinterpret_cast<const float4*>(&as[s][kk][mrow + 32 * i4]);
        af[4 * i4] = x.x; af[4 * i4 + 1] = x.y;
        af[4 * i4 + 2] = x.z; af[4 * i4 + 3] = x.w;
      }
#pragma unroll
      for (int j4 = 0; j4 < 2; ++j4) {
        const float4 y =
            *reinterpret_cast<const float4*>(&bs[s][kk][ncol + 16 * j4]);
        bf[4 * j4] = y.x; bf[4 * j4 + 1] = y.y;
        bf[4 * j4 + 2] = y.z; bf[4 * j4 + 3] = y.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(af[i], bf[j], acc[i][j]);
    }
    if (kt + 1 < nk) {
      store_a(kt + 1);                     // its buffer was last read at kt-1
      cp_async_wait_all();
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + mrow + 32 * (i / 4) + (i % 4);
    if (row >= t) continue;
#pragma unroll
    for (int j4 = 0; j4 < 2; ++j4) {
      const int col = n0 + ncol + 16 * j4;
      if (col < n)
        *reinterpret_cast<float4*>(out + (size_t)row * n + col) =
            make_float4(acc[i][4 * j4], acc[i][4 * j4 + 1],
                        acc[i][4 * j4 + 2], acc[i][4 * j4 + 3]);
    }
  }
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

// ---------------------------------------------------------------- launch
// cuTensorMapEncodeTiled, found through the runtime: the library is not
// linked against libcuda
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

// A row-major bf16 [rows, cols] matrix as a tensor map of dims (cols,
// rows) with boxes of box_c x box_r, 128-byte swizzled.
bool tensor_map(CUtensorMap* map, const void* base, int rows, int cols,
                int box_c, int box_r) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_c, (cuuint32_t)box_r};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

inline int cdiv(long long a, int b) { return (int)((a + b - 1) / b); }

// The shape of a call: rows and columns of a tile, items (output tiles)
// and the blocks that compute them (bf16: a persistent grid; f32: one
// block a tile). No blocks copy on their own: the product's loads carry
// the copy (separate copy blocks lost: tools/ring_ab.py, PERF.md).
struct Plan {
  int bm, bn, items, grid;
};

Plan plan_of(int t, int k, int n, bool is_bf16, int sms) {
  Plan p;
  if (is_bf16) {
    p.bm = kBM;                                 // fill 3/4 of the SMs
    p.bn = 4LL * cdiv(t, kBM) * cdiv(n, 256) >= 3LL * sms ? 256 : 64;
    p.items = cdiv(t, kBM) * cdiv(n, p.bn);
    p.grid = p.items < sms ? p.items : sms;
  } else {                                      // at least a block an SM
    p.bm = (long long)cdiv(t, 128) * cdiv(n, kBN32) >= sms ? 128 : 64;
    p.bn = kBN32;
    p.items = cdiv(t, p.bm) * cdiv(n, kBN32);
    p.grid = p.items;
  }
  return p;
}

template <int BN>
cudaError_t launch_wgmma(const Plan& p, const void* buf, const void* w,
                         void* partial, void* next, int t, int k, int n,
                         cudaStream_t stream) {
  CUtensorMap m[3];
  if (!tensor_map(&m[0], buf, t, k, kTK, kBM) ||
      !tensor_map(&m[1], w, k, n, 64, kTK) ||
      !tensor_map(&m[2], partial, t, n, 64, 64))
    return cudaErrorInvalidValue;
  auto kernel = ring_mm_step_wgmma_kernel<BN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<BN>::kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<p.grid, kWgThreads, Smem<BN>::kBytes, stream>>>(
      m[0], m[1], m[2], static_cast<const bf16*>(buf),
      static_cast<bf16*>(next), t, k, n);
  return cudaGetLastError();
}

cudaError_t launch_mm_step(const void* buf, const void* w, void* partial,
                           void* next, int t, int k, int n,
                           bool is_bf16, cudaStream_t stream) {
  const int sms = sm_count();
  if (sms == 0) return cudaErrorInvalidDevice;
  const Plan p = plan_of(t, k, n, is_bf16, sms);
  if (is_bf16) {
    if (p.bn == 256)
      return launch_wgmma<256>(p, buf, w, partial, next, t, k, n, stream);
    return launch_wgmma<64>(p, buf, w, partial, next, t, k, n, stream);
  }
  const float* a = static_cast<const float*>(buf);
  const float* b = static_cast<const float*>(w);
  float* c = static_cast<float*>(partial);
  float* d = static_cast<float*>(next);
  const int tiles_n = cdiv(n, kBN32);
  if (p.bm == 128)
    ring_mm_step_f32_kernel<128><<<p.grid, kThreads, 0, stream>>>(
        a, b, c, d, t, k, n, tiles_n);
  else
    ring_mm_step_f32_kernel<64><<<p.grid, kThreads, 0, stream>>>(
        a, b, c, d, t, k, n, tiles_n);
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
  return (int)launch_mm_step(buf, w, partial, next, t, k, n, is_bf16 != 0,
                             static_cast<cudaStream_t>(stream));
}

// The shape of a K9 launch of these sizes on the current card, into out:
// tile rows, tile columns, items (output tiles), the items that run at
// once (bf16: the persistent grid; f32: two blocks an SM). Returns the
// CUDA error (0 on success).
int ring_mm_step_plan(int t, int k, int n, int is_bf16, int* out) {
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  const Plan p = plan_of(t, k, n, is_bf16 != 0, sms);
  out[0] = p.bm;
  out[1] = p.bn;
  out[2] = p.items;
  out[3] = is_bf16 ? p.grid : 2 * sms;
  return 0;
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
