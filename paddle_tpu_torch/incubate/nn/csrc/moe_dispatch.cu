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
// An optional row count a block (`rows`, int32 [P/128]: the block's real
// rows, which sort_dispatch puts first) makes rows past the count zero: a
// block with no real row reads no weight, and a warpgroup whose 64 rows
// are all past the count runs no product. The TPU kernel has no such
// argument; without it every row is computed.
//
// What bounds it on an H100: at bench.py's MoE shape (8192 tokens x 2048, 8
// experts, SwiGLU dff 2816, top-2; P = 17408) the first product does 2 *
// 16384 * 2048 * 5632 = 378 GFLOP over ~0.44 GB of real rows, weights and
// output: 0.38 ms of tensor-core time against 0.13 ms of memory time, so it
// is bound by operations (the second, K 2816 x N 2048, likewise). At a decode
// batch (8 tokens at Mixtral-8x7B's widths, P = 1152: nine row blocks, at
// most eight with real rows, 1-4 each) it is the other way round: each
// touched expert's weight slice (235 MB for the first product) is read for a
// handful of real rows, so the weight bytes bound it.
//
// The design for bf16 (`gmm_wgmma_kernel`): a persistent grid, one block an
// SM, walks (row block, 256-column tile) items in groups of 16 row blocks, in
// each group column tile by column tile and, within a tile, the group's
// blocks one after another. The ~132 items in flight then run in step through
// K on at most 16 row blocks and ~9 column tiles, so each xp and w tile they
// load is shared in L2 (w's among the blocks of one expert: sort_dispatch
// puts an expert's blocks side by side). Walking the column tiles of one
// block first instead read Mixtral's 235 MB expert slice of w1 anew for every
// row block (at a 2048-token prefill on an H100 its first product then took
// 1.6x torch._grouped_mm's time). With row counts the blocks that hold a real
// row come first in that walk and the blocks of padding (written as zeros)
// last, so that skipped items leave no hole in the first waves (Mixtral's
// decode second product: 6 real blocks x 16 tiles is one wave once compacted,
// two without).
//
// In a block a producer warpgroup (one thread issuing copies, its registers
// given away by setmaxnreg) loads each item's K in 64-deep stages by TMA into
// a ring of 3 stages (16 KB of xp: 128 rows x 64 K, and 32 KB of w: four
// boxes of 64 K x 64 columns, all under the 128-byte swizzle) behind "full" /
// "empty" mbarriers; two consumer warpgroups take 64 rows each and run wgmma
// m64n256k16 (f32 accumulators, 128 a thread) with w read as an MN-major B
// operand, one stage's products in flight while the next stage is awaited.
// The epilogue rounds to bf16 once, zeroes rows past the count, and stores
// each warpgroup's 64 x 256 tile through swizzled shared memory by TMA
// (columns past N are left out), while the producer already fills the ring
// for the next item. TMA's zero fill covers a K past the last full stage.
//
// f32 (`gmm_f32_kernel`) keeps plain FFMA loops (8 x 4 outputs a thread, a
// 128 x 64 tile a block), which match an f32 reference closely (wgmma has no
// full-f32 product; TF32 keeps three digits). Every output element is one
// thread's sum in a fixed order: no split K, no atomics, so a call's result
// is the same bits every time. Loads are 16 bytes, so K and N must be
// multiples of 8 (the wrapper checks).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <chrono>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;                 // rows of a block: one row block

__device__ __forceinline__ int clamp_id(int g, int e) {
  return g < 0 ? 0 : (g >= e ? e - 1 : g);
}

// real rows of row block `blk`: its count clamped into [0, 128], or 128
// without counts
__device__ __forceinline__ int rows_of(const int* __restrict__ rows,
                                       int blk) {
  if (rows == nullptr) return kBM;
  const int r = rows[blk];
  return r < 0 ? 0 : (r > kBM ? kBM : r);
}

// ------------------------------------------------------------------ bf16
constexpr int kTN = 256;                 // columns of an output tile
constexpr int kTK = 64;                  // K of a ring stage: 128 bytes
constexpr int kStages = 3;
constexpr int kBoxes = kTN / 64;         // 64-column boxes of w and out
constexpr int kABytes = kBM * kTK * 2;   // 16 KB: 128 rows x 64 K
constexpr int kBoxBytes = kTK * 64 * 2;  // 8 KB: 64 K x 64 columns
constexpr int kBBytes = kBoxes * kBoxBytes;
constexpr int kOutBox = 64 * 64 * 2;     // 8 KB: 64 rows x 64 columns
constexpr int kOutWg = kBoxes * kOutBox; // a warpgroup's 64 x 256 tile
constexpr int kGroup = 16;               // row blocks of an item group
// row blocks whose order a block compacts (see gmm_wgmma_kernel); past
// it the items keep the blocks' own order
constexpr int kMaxOrder = 4096;
// two consumer warpgroups and a producer warpgroup: wgmma kernels get
// registers by whole warpgroups, so the producer holds a warpgroup's
// share in any case; setmaxnreg moves it to the consumers (40 + 2 x 232
// = 3 x 168, the block's allocation: a split that asks for more than the
// block holds waits in setmaxnreg.inc for ever)
constexpr int kWgThreads = 3 * 128;

// Shared memory of the block, 1024-byte aligned pieces: the ring's xp and
// w stages, each warpgroup's output tile, the order of the row blocks,
// then the barriers.
struct Smem {
  static constexpr int kA = 0;
  static constexpr int kB = kA + kStages * kABytes;
  static constexpr int kOut = kB + kStages * kBBytes;
  static constexpr int kOrder = kOut + 2 * kOutWg;
  static constexpr int kLive = kOrder + 2 * kMaxOrder;   // an int
  static constexpr int kBar = kLive + 8;
  static constexpr int kBytes = kBar + 8 * 2 * kStages + 1024;
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

// one box of a 2-D / 3-D tensor map into shared memory, completing on
// `bar` (elements past the tensor's edge read as zeros)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
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

// d (64 x 256 f32, registers) += a . b: a (64 x 16) bf16 K-major and b
// (16 x 256) bf16 MN-major, both in shared memory under the 128-byte
// swizzle
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
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
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// item t's row block and first column (see the note at the top): with an
// order, the items of its first n_live blocks (those with a real row),
// then those of the rest; without, the blocks' own order. Each part in
// groups of kGroup row blocks (the last may be short), in a group column
// tile by column tile, in a tile block by block.
__device__ __forceinline__ void item_of(int t, int n_blocks, int n_live,
                                        int n_tiles, const uint16_t* order,
                                        int& blk, int& n0) {
  int base = 0, count = n_blocks;
  if (order != nullptr) {
    if (t < n_live * n_tiles) {
      count = n_live;
    } else {
      t -= n_live * n_tiles;
      base = n_live;
      count = n_blocks - n_live;
    }
  }
  const int group = t / (kGroup * n_tiles);
  const int first = group * kGroup;
  const int size = min(kGroup, count - first);
  const int local = t - first * n_tiles;
  const int nt = local / size;
  const int pos = base + first + (local - nt * size);
  blk = order != nullptr ? order[pos] : pos;
  n0 = nt * kTN;
}

// ta: xp [P, K] as dims (K, P), boxes of 64 K x 128 rows; tb: w [E, K, N]
// as dims (N, K, E), boxes of 64 columns x 64 K x one expert; tc: out
// [P, N] as dims (N, P), boxes of 64 columns x 64 rows; all bf16 under
// the 128-byte swizzle.
__global__ void __launch_bounds__(kWgThreads, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tc,
                 const int* __restrict__ block_gid,
                 const int* __restrict__ rows, int k, int n, int e,
                 int n_blocks) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Smem::kBar);
  uint64_t* empty = full + kStages;

  const int n_tiles = (n + kTN - 1) / kTN;
  const int items = n_blocks * n_tiles;
  const int nk = (k + kTK - 1) / kTK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2 * 128);            // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // With row counts, the items walk the blocks that hold a real row
  // first, in their order, and the blocks of padding after them (written
  // as zeros): skipped items then leave no hole in the persistent grid's
  // first waves. Warp 0 orders them by ballots.
  uint16_t* order = nullptr;
  int* n_live = reinterpret_cast<int*>(sm + Smem::kLive);
  if (rows != nullptr && n_blocks <= kMaxOrder) {
    order = reinterpret_cast<uint16_t*>(sm + Smem::kOrder);
    if (warp == 0) {
      int live = 0, dead = 0;
      for (int b0 = 0; b0 < n_blocks; b0 += 32) {
        const int b = b0 + lane;
        const bool in = b < n_blocks;
        const bool real = in && rows_of(rows, b) > 0;
        const unsigned lv = __ballot_sync(0xffffffffu, real);
        const unsigned dd = __ballot_sync(0xffffffffu, in && !real);
        const unsigned below = (1u << lane) - 1;
        if (real)
          order[live + __popc(lv & below)] = (uint16_t)b;
        else if (in)
          order[n_blocks - 1 - dead - __popc(dd & below)] = (uint16_t)b;
        live += __popc(lv);
        dead += __popc(dd);
      }
      if (lane == 0) *n_live = live;
    }
  }
  __syncthreads();
  const int live = order != nullptr ? *n_live : n_blocks;

  const int wg = warpgroup();
  if (wg == 2) {                                // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      int it = 0;                               // stages filled so far
      for (int t = blockIdx.x; t < items; t += gridDim.x) {
        int blk, n0;
        item_of(t, n_blocks, live, n_tiles, order, blk, n0);
        if (rows_of(rows, blk) == 0) continue;  // no real row: no weight
        const int g = clamp_id(block_gid[blk], e);
        const int nb = min(kBoxes, (n - n0 + 63) / 64);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(empty + s, (it / kStages - 1) & 1);
          mbar_expect_tx(full + s, kABytes + nb * kBoxBytes);
          tma_load_2d(sm + Smem::kA + s * kABytes, &ta, full + s, kt * kTK,
                      blk * kBM);
          uint8_t* bs = sm + Smem::kB + s * kBBytes;
          for (int c = 0; c < nb; ++c)
            tma_load_3d(bs + c * kBoxBytes, &tb, full + s, n0 + 64 * c,
                        kt * kTK, g);
        }
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
  uint8_t* ep = sm + Smem::kOut + wg * kOutWg;
  const bool leader = (threadIdx.x & 127) == 0;
  float acc[128];
  int it = 0;                                   // stages consumed so far
  for (int t = blockIdx.x; t < items; t += gridDim.x) {
    int blk, n0;
    item_of(t, n_blocks, live, n_tiles, order, blk, n0);
    // uniform across the warpgroup, and known to be so (see warpgroup())
    const int cnt = __shfl_sync(0xffffffffu, rows_of(rows, blk), 0);
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    fence_regs(acc);
    if (cnt > 0) {
      const bool mine = cnt > 64 * wg;          // a real row among ours
      // no access to acc in the loop: one stage's products stay in
      // flight while the next stage is awaited (an access would make the
      // compiler wait for them first)
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(full + s, (it / kStages) & 1);
        if (mine) {
          const uint8_t* as = sm + Smem::kA + s * kABytes + wg * 64 * 128;
          const uint8_t* bs = sm + Smem::kB + s * kBBytes;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kTK / 16; ++kk)   // 16 K a step
            wgmma_n256(acc, sw128_desc(as + kk * 32, 16, 1024),
                       sw128_desc(bs + kk * 16 * 128, kBoxBytes, 1024));
          wgmma_commit();
          wgmma_wait<1>();                      // the last stage's products
        }
        if (kt > 0) mbar_arrive(empty + (it - 1) % kStages);
      }
      wgmma_wait<0>();          // unconditional: ptxas sees no path
      mbar_arrive(empty + (it - 1) % kStages);   // to acc with one pending
    }
    fence_regs(acc);

    // rounded once to bf16, rows past the count zero, into the
    // warpgroup's four 64 x 64 boxes (128-byte rows, swizzled: the 16-byte
    // chunk c of row q at c ^ (q & 7), and q & 7 = g8 here), then stored
    // by TMA
    if (leader) bulk_wait_read();               // the last tile's store
    named_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < kTN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = r + 8 * h;
        const uint32_t v = 64 * wg + q < cnt
            ? pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]) : 0u;
        *reinterpret_cast<uint32_t*>(ep + (j >> 3) * kOutBox + q * 128 +
                                     (((j & 7) ^ g8) << 4) + 4 * tg) = v;
      }
    }
    fence_async_smem();
    named_sync(1 + wg, 128);
    if (leader) {
      for (int c = 0; c < kBoxes && n0 + 64 * c < n; ++c)
        tma_store_2d(&tc, ep + c * kOutBox, n0 + 64 * c,
                     blk * kBM + 64 * wg);
      bulk_commit();
    }
  }
  if (leader) bulk_wait_all();
}

// ------------------------------------------------------------------- f32
// a 128 x 64 tile a block of 256 threads, K in steps of 16; A is kept
// transposed ([k][m])
constexpr int kF32Threads = 256;
constexpr int kBN32 = 64, kBK32 = 16;
constexpr int kLdA32 = kBM + 4;          // [16][132] f32

__global__ void __launch_bounds__(kF32Threads)
gmm_f32_kernel(const float* __restrict__ xp, const float* __restrict__ w,
               const int* __restrict__ block_gid,
               const int* __restrict__ rows, float* __restrict__ out, int k,
               int n, int e) {
  __shared__ __align__(16) float a_s[kBK32][kLdA32];
  __shared__ __align__(16) float b_s[kBK32][kBN32];

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;   // rows 8 ty.., columns 4 tx..
  const size_t row0 = (size_t)blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN32;
  const int cnt = rows_of(rows, blockIdx.y);
  const float* a_g = xp + row0 * k;
  const float* b_g = w + (size_t)clamp_id(block_gid[blockIdx.y], e) * k * n;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // a block with no real row reads nothing and writes zeros
  for (int k0 = 0; cnt > 0 && k0 < k; k0 += kBK32) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {          // A: 128 rows x 4 chunks of 4
      const int ch = tid + i * kF32Threads;
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
          ty * 8 + i < cnt
              ? make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3])
              : zero;
  }
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

// A row-major bf16 tensor of `rank` dims (innermost first, `dims`) as a
// tensor map with boxes `box`, 128-byte swizzled.
bool tensor_map(CUtensorMap* map, const void* base, int rank,
                const cuuint64_t* dims, const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t strides[2];
  cuuint64_t stride = 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = stride *= dims[i];
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the three tensor maps of a bf16 call (see gmm_wgmma_kernel)
bool gmm_maps(CUtensorMap (&m)[3], const void* xp, const void* w,
              const void* out, int p, int k, int n, int e) {
  const cuuint64_t da[2] = {(cuuint64_t)k, (cuuint64_t)p};
  const cuuint32_t ba[2] = {kTK, kBM};
  const cuuint64_t db[3] = {(cuuint64_t)n, (cuuint64_t)k, (cuuint64_t)e};
  const cuuint32_t bb[3] = {64, kTK, 1};
  const cuuint64_t dc[2] = {(cuuint64_t)n, (cuuint64_t)p};
  const cuuint32_t bc[2] = {64, 64};
  return tensor_map(&m[0], xp, 2, da, ba) &&
         tensor_map(&m[1], w, 3, db, bb) && tensor_map(&m[2], out, 2, dc, bc);
}

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

cudaError_t launch_bf16(const void* xp, const void* w, const int* gid,
                        const int* rows, void* out, int p, int k, int n,
                        int e, cudaStream_t stream) {
  CUtensorMap m[3];
  if (!gmm_maps(m, xp, w, out, p, k, n, e)) return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms == 0) return cudaErrorInvalidDevice;
  const cudaError_t err = cudaFuncSetAttribute(
      gmm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem::kBytes);
  if (err != cudaSuccess) return err;
  const int n_blocks = p / kBM;
  const int items = n_blocks * ((n + kTN - 1) / kTN);
  const int grid = items < sms ? items : sms;   // persistent: one an SM
  gmm_wgmma_kernel<<<grid, kWgThreads, Smem::kBytes, stream>>>(
      m[0], m[1], m[2], gid, rows, k, n, e, n_blocks);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* xp, const void* w, const int* gid,
                       const int* rows, void* out, int p, int k, int n,
                       int e, cudaStream_t stream) {
  const dim3 grid((n + kBN32 - 1) / kBN32, p / kBM);
  gmm_f32_kernel<<<grid, kF32Threads, 0, stream>>>(
      static_cast<const float*>(xp), static_cast<const float*>(w), gid, rows,
      static_cast<float*>(out), k, n, e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out [p, n] = per 128-row block i of xp [p, k], xp_i @ w[block_gid[i]]
// with w [e, k, n]; with `rows` (int32 [p / 128], may be null), rows of
// block i at or past rows[i] are zero. Launches on `stream`, does not
// synchronise, allocates nothing. The caller has checked that xp, w and
// out are contiguous, of one type (bf16 or f32) and 16-byte aligned,
// block_gid (and rows) contiguous int32 [p / 128], p a positive multiple
// of 128 with p / 128 <= 65535, k and n positive multiples of 8, and
// e >= 1. Returns the CUDA error of the launch (0 on success).
int gmm_launch(const void* xp, const void* w, const void* block_gid,
               const void* rows, void* out, int p, int k, int n, int e,
               int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gid = static_cast<const int*>(block_gid);
  const int* cnt = static_cast<const int*>(rows);
  if (is_bf16)
    return (int)launch_bf16(xp, w, gid, cnt, out, p, k, n, e, s);
  return (int)launch_f32(xp, w, gid, cnt, out, p, k, n, e, s);
}

// Host microseconds to encode the three tensor maps of a bf16 call of
// these shapes on these pointers, the mean of `iters` encodings; -1 when
// an encoding fails.
double gmm_encode_us(const void* xp, const void* w, const void* out, int p,
                     int k, int n, int e, int iters) {
  CUtensorMap m[3];
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    if (!gmm_maps(m, xp, w, out, p, k, n, e)) return -1.0;
  const std::chrono::duration<double, std::micro> dt =
      std::chrono::steady_clock::now() - t0;
  return dt.count() / (iters > 0 ? iters : 1);
}

const char* gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
