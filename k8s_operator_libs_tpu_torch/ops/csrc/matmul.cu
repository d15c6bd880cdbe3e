// K1: C[M,N] (f32) = A[M,K] (bf16) @ B[K,N] (bf16), all row-major.
//
// Replaces the Pallas kernel `_matmul_kernel` reached through `matmul` in
// k8s_operator_libs_tpu/ops/matmul.py. That kernel writes one output tile
// per grid step with the whole K extent resident in VMEM (up to 13 MiB a
// step); a Hopper block has at most 227 KB of shared memory, so here K
// streams through a ring of shared-memory stages instead.
//
// What bounds it: at the health probe's sizes (1024-4096, square) the
// product does 2*M*N*K operations on 2*(M*K + K*N) + 4*M*N bytes, hundreds
// of operations per byte, so the tensor cores bound it from 2048 up; at
// 1024 the bytes bound it, and what holds a kernel back there is filling
// 132 SMs with few output tiles and feeding them from L2.
//
// Two kernels, and the entry point picks one by one test: can TMA describe
// the operands (K % 8 == 0, N % 8 == 0, both bases 16-byte aligned, so every
// row starts on a 16-byte boundary)?
//
// Yes: `matmul_wgmma_kernel`, Hopper's own path to the tensor cores.
//  - One producer warpgroup and two consumer warpgroups (`setmaxnreg`
//    moves registers from the first to the others). One producer thread
//    keeps a ring of 4 stages full: each stage is a 128x64 A tile and a
//    64xBN B tile, brought by TMA (`cp.async.bulk.tensor.2d`) in the
//    128-byte swizzle, with a full and an empty `mbarrier` per stage.
//  - Each consumer runs `wgmma.mma_async.m64nBNk16` (bf16 in, f32 sums in
//    registers) on its 64 rows, both operands read from shared memory. A is
//    K-major; B is row-major, so N-major, and the instruction's transpose
//    flag for B is set. One k-block's group stays in flight while the next
//    is started; a stage is freed once the group that reads it is done.
//  - A persistent grid of min(tiles, SMs) blocks walks the output tiles, so
//    the producer loads the next tile while the consumers write this one.
//    The tile is 128x64 while 128x256 tiles would give fewer than half as
//    many tiles as SMs (1024^3: 128 tiles), and 128x256 above that (more
//    operations per byte of shared memory read).
//  - The epilogue writes f32 straight from the accumulator registers,
//    masking rows and columns past M and N (TMA fills loads past the edges
//    with zeros).
//  - The tensor maps are encoded on the host for each call and passed by
//    value as `__grid_constant__` parameters, so a CUDA graph captures them
//    with the launch. `cuTensorMapEncodeTiled` is reached through
//    `cudaGetDriverEntryPoint` (no -lcuda); it, the SM count and the
//    shared-memory attribute are set up once per device, at the first call.
//
// No: `matmul_masked_kernel`, kept for the shapes above. 128x128 output
// tiles on 8 warps, WMMA (`mma.sync`) 16x16 fragments, bf16 in and f32
// sums, two shared-memory stages of 32-deep K slices loaded element by
// element with zeros past the edge, and an epilogue that stages each
// fragment through shared memory and writes the in-bounds part.
//
// Measured on an H100 (PERF.md): 2-CTA clusters that multicast the shared A
// tile were slower up to 2048^3 (launching a cluster costs more than the L2
// traffic it saves) and no faster at 4096^3, and a deeper ring (6 or 8
// stages of 128x64) changed nothing, so neither is kept. A stream-K split
// of K is left for later.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <mutex>

using namespace nvcuda;

namespace {

constexpr int MAX_DEVICES = 64;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// The masked WMMA kernel: any shape, any alignment.

namespace masked {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // 64 x 32 per warp
constexpr int FM = WM / 16, FN = WN / 16;            // 4 x 2 fragments
constexpr int THREADS = WARPS_M * WARPS_N * 32;
constexpr int A_LD = BK + 8;                         // 40 bf16 = 80 B rows
constexpr int B_LD = BN + 8;                         // 136 bf16 = 272 B rows
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD;
constexpr int C_LD = 16 + 4;                         // epilogue staging, floats

// The A slice rows [m0, m0+BM) x cols [k0, k0+BK) and the B slice rows
// [k0, k0+BK) x cols [n0, n0+BN) into one stage, zeros past the edges.
__device__ __forceinline__ void load_stage(__nv_bfloat16* As, __nv_bfloat16* Bs,
                                           const __nv_bfloat16* A, const __nv_bfloat16* B,
                                           int M, int N, int K, int m0, int n0, int k0,
                                           int tid) {
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  for (int c = tid; c < BM * BK; c += THREADS) {
    const int row = c / BK, col = c % BK, gr = m0 + row, gk = k0 + col;
    As[row * A_LD + col] = (gr < M && gk < K) ? A[(size_t)gr * K + gk] : zero;
  }
  for (int c = tid; c < BK * BN; c += THREADS) {
    const int row = c / BN, col = c % BN, gk = k0 + row, gc = n0 + col;
    Bs[row * B_LD + col] = (gk < K && gc < N) ? B[(size_t)gk * N + gc] : zero;
  }
}

__global__ void __launch_bounds__(THREADS)
matmul_masked_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
                     float* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(128) __nv_bfloat16 smem[2 * (A_STAGE + B_STAGE)];
  __nv_bfloat16* As[2] = {smem, smem + A_STAGE};
  __nv_bfloat16* Bs[2] = {smem + 2 * A_STAGE, smem + 2 * A_STAGE + B_STAGE};

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int n_k = cdiv(K, BK);
  load_stage(As[0], Bs[0], A, B, M, N, K, m0, n0, 0, tid);
  for (int kt = 0; kt < n_k; ++kt) {
    const int cur = kt & 1;
    __syncthreads();  // stage cur is written; stage cur ^ 1 is free
    if (kt + 1 < n_k)
      load_stage(As[cur ^ 1], Bs[cur ^ 1], A, B, M, N, K, m0, n0, (kt + 1) * BK, tid);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], As[cur] + (wm * WM + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bf[j], Bs[cur] + kk * B_LD + wn * WN + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
  }
  __syncthreads();  // every warp is done with the stages

  // Epilogue: each warp stages one 16x16 fragment at a time in its own
  // slice of the (now idle) shared memory and writes the in-bounds part.
  float* stage = reinterpret_cast<float*>(smem) + warp * 16 * C_LD;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], C_LD, wmma::mem_row_major);
      __syncwarp();
      const int row0 = m0 + wm * WM + i * 16, col0 = n0 + wn * WN + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16, c = e % 16;
        if (row0 + r < M && col0 + c < N)
          C[(size_t)(row0 + r) * N + col0 + c] = stage[r * C_LD + c];
      }
      __syncwarp();
    }
  }
}

}  // namespace masked

// ---------------------------------------------------------------------------
// The wgmma kernel: TMA, an mbarrier ring, warp specialisation.

namespace tma {

constexpr int BM = 128, BK = 64, STAGES = 4;
constexpr int CONSUMERS = 2;                    // warpgroups of 64 rows each
constexpr int THREADS = 128 * (1 + CONSUMERS);  // warpgroup 0 produces
constexpr int ROW_BYTES = 128;                  // one swizzled row: 64 bf16
constexpr int BOX = ROW_BYTES / 2;

template <int BN>
struct Layout {
  static_assert(BN % BOX == 0, "B arrives in 64-column boxes");
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BOX_BYTES = BK * ROW_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + (BN / BOX) * B_BOX_BYTES;
  // 1024 bytes of slack to align the stages, then the barriers.
  static constexpr size_t BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t);
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor in the 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from touching the accumulators across a wgmma wait.
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d (+)= A (64x16, K-major) * B (16xN, N-major: transpose flag 1).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                    const __grid_constant__ CUtensorMap tm_b, float* __restrict__ C, int M, int N,
                    int K) {
  using L = Layout<BN>;
  extern __shared__ __align__(1024) unsigned char smem[];
  // The 128-byte swizzle repeats every 1024 bytes; tiles start on that.
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t bars = base + STAGES * L::STAGE_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };

  const int tiles_n = cdiv(N, BN), tiles = cdiv(M, BM) * tiles_n, n_k = cdiv(K, BK);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS * 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
        for (int kb = 0; kb < n_k; ++kb) {
          mbar_wait(empty(stage), phase ^ 1);
          const uint32_t a_dst = base + stage * L::STAGE_BYTES, b_dst = a_dst + L::A_BYTES;
          mbar_expect_tx(full(stage), L::STAGE_BYTES);
          tma_load_2d(a_dst, &tm_a, kb * BK, m0, full(stage));
#pragma unroll
          for (int j = 0; j < BN / BOX; ++j)
            tma_load_2d(b_dst + j * L::B_BOX_BYTES, &tm_b, n0 + j * BOX, kb * BK, full(stage));
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    float d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.0f;  // each tile's first wgmma overwrites them
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
      int held = -1;  // the stage the wgmma group still in flight reads
      for (int kb = 0; kb < n_k; ++kb) {
        mbar_wait(full(stage), phase);
        const uint32_t a_tile = base + stage * L::STAGE_BYTES + c * 64 * ROW_BYTES;
        const uint32_t b_tile = base + stage * L::STAGE_BYTES + L::A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // A: 16 K-columns are 32 bytes along a swizzled row; 8-row groups
          // 1024 bytes apart. B: 16 K-rows are 2048 bytes down the box;
          // 8-row groups 1024 bytes apart, 64-column boxes B_BOX_BYTES apart.
          const uint64_t da = smem_desc(a_tile + kk * 32, 16, 1024);
          const uint64_t db = smem_desc(b_tile + kk * 16 * ROW_BYTES, L::B_BOX_BYTES, 1024);
          const int accumulate = (kb > 0 || kk > 0) ? 1 : 0;
          if constexpr (BN == 64)
            wgmma_m64n64k16(d, da, db, accumulate);
          else
            wgmma_m64n256k16(d, da, db, accumulate);
        }
        wgmma_commit();
        // Keep this k-block's group in flight while the next one is
        // started: wait for the previous group only, then free its stage.
        wgmma_wait<1>();
        if (held >= 0 && lane == 0) mbar_arrive(empty(held));
        held = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(d[i]);
      if (lane == 0) mbar_arrive(empty(held));
      // Accumulator fragment: n8 tile j holds rows g and g + 8 of the
      // warp's 16, columns 8j + 2t and 8j + 2t + 1 (g = lane / 4, t = lane % 4).
      const int row = m0 + c * 64 + warp * 16 + lane / 4;
      const int col0 = n0 + (lane % 4) * 2;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = col0 + j * 8;
        if (col >= N) continue;  // N is even, so col + 1 < N too
        if (row < M)
          *reinterpret_cast<float2*>(C + (size_t)row * N + col) = make_float2(d[4 * j], d[4 * j + 1]);
        if (row + 8 < M)
          *reinterpret_cast<float2*>(C + (size_t)(row + 8) * N + col) =
              make_float2(d[4 * j + 2], d[4 * j + 3]);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled = nullptr;

// A 2-D bf16 row-major tensor map with (inner, outer) extents, a box of
// (BOX, box_outer) elements, the 128-byte swizzle and zeros past the edges.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int inner, int outer, int box_outer) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BOX), static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode_tiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN>
cudaError_t launch(const void* a, const void* b, float* C, int M, int N, int K, int sms,
                   cudaStream_t stream) {
  CUtensorMap tm_a, tm_b;
  cudaError_t err = make_map(&tm_a, a, K, M, BM);
  if (err == cudaSuccess) err = make_map(&tm_b, b, N, K, BK);
  if (err != cudaSuccess) return err;
  const int tiles = cdiv(M, BM) * cdiv(N, BN);
  matmul_wgmma_kernel<BN><<<tiles < sms ? tiles : sms, THREADS, Layout<BN>::BYTES, stream>>>(
      tm_a, tm_b, C, M, N, K);
  return cudaGetLastError();
}

}  // namespace tma

// Once per device, at the first call there (outside any graph capture):
// the SM count, the wgmma kernels' shared-memory allowance, and the entry
// point of the tensor-map encoder.
cudaError_t device_setup(int* sms) {
  static std::once_flag entry_once;
  static cudaError_t entry_err = cudaSuccess;
  std::call_once(entry_once, [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    entry_err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                 cudaEnableDefault, &found);
#else
    entry_err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (entry_err == cudaSuccess && found != cudaDriverEntryPointSuccess)
      entry_err = cudaErrorSymbolNotFound;
    tma::encode_tiled = reinterpret_cast<tma::EncodeTiled>(fn);
  });
  if (entry_err != cudaSuccess) return entry_err;

  static std::once_flag once[MAX_DEVICES];
  static cudaError_t errs[MAX_DEVICES];
  static int counts[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    cudaError_t e = cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(tma::matmul_wgmma_kernel<64>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(tma::Layout<64>::BYTES));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(tma::matmul_wgmma_kernel<256>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(tma::Layout<256>::BYTES));
    errs[dev] = e;
  });
  *sms = counts[dev];
  return errs[dev];
}

// The kernel a call takes: 0 the masked WMMA kernel, 1 wgmma with 128x64
// tiles, 2 wgmma with 128x256 tiles.
int pick_path(const void* a, const void* b, int M, int N, int K, int sms) {
  const bool tma_ok = K % 8 == 0 && N % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (!tma_ok) return 0;
  return 2 * cdiv(M, tma::BM) * cdiv(N, 256) >= sms ? 2 : 1;
}

}  // namespace

// Which kernel k1_matmul_bf16_f32 takes for these operands (see pick_path),
// or minus a CUDA error code.
extern "C" int k1_matmul_path(const void* a, const void* b, int M, int N, int K) {
  int sms = 0;
  const cudaError_t err = device_setup(&sms);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return pick_path(a, b, M, N, K, sms);
}

// *path is set to the kernel the call launched (see pick_path).
extern "C" int k1_matmul_bf16_f32(const void* a, const void* b, void* c, int M, int N, int K,
                                  void* stream, int* path) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = device_setup(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* C = static_cast<float*>(c);
  auto s = static_cast<cudaStream_t>(stream);
  *path = pick_path(a, b, M, N, K, sms);
  switch (*path) {
    case 1: return static_cast<int>(tma::launch<64>(a, b, C, M, N, K, sms, s));
    case 2: return static_cast<int>(tma::launch<256>(a, b, C, M, N, K, sms, s));
    default: break;
  }
  const dim3 grid(cdiv(N, masked::BN), cdiv(M, masked::BM));
  masked::matmul_masked_kernel<<<grid, masked::THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), C, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
