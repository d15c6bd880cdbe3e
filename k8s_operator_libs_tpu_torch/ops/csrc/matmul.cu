// K1: C[M,N] (f32) = A[M,K] (bf16) @ B[K,N] (bf16), all row-major.
//
// Replaces the Pallas kernel `_matmul_kernel` reached through `matmul` in
// k8s_operator_libs_tpu/ops/matmul.py. That kernel writes one output tile
// per grid step with the whole K extent resident in VMEM (up to 13 MiB a
// step). Hopper gives a block at most 227 KB of shared memory, and one
// 128-row bf16 A tile with K = 1024 alone is 256 KB, so this kernel loops
// over K in 32-wide slices instead.
//
// What bounds it: at the probe's sizes (1024-4096, square) the product
// does 2*M*N*K operations on 2*(M*K + K*N) + 4*M*N bytes, hundreds of
// operations per byte, so the tensor cores bound it from 2048 up; at 1024
// the bound is the bytes, and the 64-block grid fills only half the card.
//
// Design: a 128x128 output tile per block of 8 warps (256 threads), each
// warp a 64x32 sub-tile held as 4x2 WMMA 16x16 f32 accumulators (bf16 in,
// f32 sum, the tensor cores through `mma.sync`). A and B slices of 32 in K
// stream through two shared-memory stages with `cp.async`, so the next
// slice loads while the tensor cores work on this one. A 128x128 tile does
// 128 operations per byte it loads, 37 KB of shared memory holds both
// stages, and 64 accumulator registers a thread leave room for two blocks
// on an SM. Rows are padded by 8 bf16 so the fragment loads spread over
// the banks. The kernel masks the ragged edge itself: partial slices load
// element by element with zeros past the edge, and the epilogue stages each
// 16x16 fragment through shared memory and writes only in-bounds elements.
// `wgmma`, TMA and warp specialisation are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Loads the A slice rows [m0, m0+BM) x cols [k0, k0+BK) and the B slice
// rows [k0, k0+BK) x cols [n0, n0+BN) into one stage, 8 bf16 a chunk.
template <bool VEC>
__device__ __forceinline__ void load_stage(
    __nv_bfloat16* As, __nv_bfloat16* Bs, const __nv_bfloat16* A,
    const __nv_bfloat16* B, int M, int N, int K, int m0, int n0, int k0, int tid) {
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
#pragma unroll
  for (int i = 0; i < (BM * BK / 8) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int row = c / (BK / 8), col = (c % (BK / 8)) * 8;
    const int gr = m0 + row, gk = k0 + col;
    __nv_bfloat16* dst = As + row * A_LD + col;
    if (VEC && gr < M && gk + 8 <= K) {
      cp_async16(dst, A + (size_t)gr * K + gk);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = (gr < M && gk + j < K) ? A[(size_t)gr * K + gk + j] : zero;
    }
  }
#pragma unroll
  for (int i = 0; i < (BK * BN / 8) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int row = c / (BN / 8), col = (c % (BN / 8)) * 8;
    const int gk = k0 + row, gc = n0 + col;
    __nv_bfloat16* dst = Bs + row * B_LD + col;
    if (VEC && gk < K && gc + 8 <= N) {
      cp_async16(dst, B + (size_t)gk * N + gc);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = (gk < K && gc + j < N) ? B[(size_t)gk * N + gc + j] : zero;
    }
  }
}

// VEC: rows of A and B start on 16-byte boundaries (K % 8 == 0, N % 8 == 0,
// 16-byte aligned bases), so whole in-bounds chunks go through cp.async.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
matmul_bf16_f32_kernel(const __nv_bfloat16* __restrict__ A,
                       const __nv_bfloat16* __restrict__ B,
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

  const int n_k = (K + BK - 1) / BK;
  load_stage<VEC>(As[0], Bs[0], A, B, M, N, K, m0, n0, 0, tid);
  cp_async_commit();

  for (int kt = 0; kt < n_k; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < n_k) {
      load_stage<VEC>(As[cur ^ 1], Bs[cur ^ 1], A, B, M, N, K, m0, n0,
                      (kt + 1) * BK, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
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
    // The stage just read is the one the next iteration loads into.
    __syncthreads();
  }

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

}  // namespace

extern "C" int k1_matmul_bf16_f32(const void* a, const void* b, void* c, int M,
                                  int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const bool vec = K % 8 == 0 && N % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const auto* A = static_cast<const __nv_bfloat16*>(a);
  const auto* B = static_cast<const __nv_bfloat16*>(b);
  auto* C = static_cast<float*>(c);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec)
    matmul_bf16_f32_kernel<true><<<grid, THREADS, 0, s>>>(A, B, C, M, N, K);
  else
    matmul_bf16_f32_kernel<false><<<grid, THREADS, 0, s>>>(A, B, C, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
