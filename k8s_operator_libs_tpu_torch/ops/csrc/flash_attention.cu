// K2: softmax attention forward over (batch*heads, seq, head_dim), bf16 in
// and out, causal or not.
//
// Replaces the Pallas kernel `_flash_kernel` reached through
// `flash_attention` in k8s_operator_libs_tpu/ops/flash_attention.py, and
// computes what it computes: scores scaled by head_dim^-0.5 in f32, an
// online softmax over K/V tiles (running max m, denominator l, f32
// accumulator, correction exp(m_old - m_new)), the finite mask value -1e30,
// the causal skip of K/V tiles past the diagonal (n_kv = cdiv((iq+1)*BQ,
// BKV)), and the output cast to the input dtype.
//
// Where it differs: the Pallas kernel keeps K and V of the whole sequence
// resident in VMEM (512 KB at seq 1024, head_dim 128); that does not fit in
// a Hopper block's 227 KB, so this kernel streams 64-row K/V tiles through
// shared memory in a loop inside the block, the loop taking the place of
// the Pallas `fori_loop`. The Pallas kernel multiplies in f32; here both
// products run on the tensor cores with bf16 operands and f32 sums. Q.K^T
// is still exact (bf16 products are exact in f32) and is scaled in f32
// after the product, which equals the f32 pre-scaled q up to one rounding.
// P.V takes P rounded to bf16: a relative error of up to 2^-9 on each
// weight, which the probe's 2e-2 tolerance covers.
//
// What bounds it: at the probe's (1, 4, 1024, 128) shape the causal
// forward does 4*d operations for each of s(s+1)/2 pairs a head (1.07
// GFLOP) on 4.19 MB, so neither bound is far off, but the grid is only
// batch*heads x seq/64 = 64 blocks on 132 SMs and the kernel sits far from
// either. Nothing here fixes that yet.
//
// Design: a block of 4 warps owns 64 query rows; each warp owns 16 of
// them and every per-row quantity of those rows. Per K/V tile: WMMA
// Q.K^T into an f32 staging tile; the warp's lanes run the online softmax
// across each row (two columns a lane, shuffles for max and sum) and write
// P as bf16; WMMA P.V into the staging tile; each lane folds its fixed
// slice of the 16 x head_dim output rows (held in registers) with the row's
// correction. Q, K, V, the staging tile and P take 96 KB of dynamic shared
// memory at head_dim 128. Rows and columns past seq are masked, so the
// sequence need not divide the tiles. Double-buffered K/V, mma.sync with
// register-resident P, `wgmma` and TMA are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <cmath>

using namespace nvcuda;

namespace {

constexpr int BQ = 64, BKV = 64, WARPS = 4, THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = BQ / WARPS;  // 16
constexpr float MASKED = -1e30f;

template <int D>
struct Layout {
  static constexpr int D_LD = D + 8;    // bf16 row stride of Q, K, V tiles
  static constexpr int S_LD = D + 4;    // f32 row stride of the staging tile
  static constexpr int P_LD = BKV + 8;  // bf16 row stride of P
  static constexpr size_t Q_OFF = 0;
  static constexpr size_t K_OFF = Q_OFF + sizeof(__nv_bfloat16) * BQ * D_LD;
  static constexpr size_t V_OFF = K_OFF + sizeof(__nv_bfloat16) * BKV * D_LD;
  static constexpr size_t S_OFF = V_OFF + sizeof(__nv_bfloat16) * BKV * D_LD;
  static constexpr size_t P_OFF = S_OFF + sizeof(float) * BQ * S_LD;
  static constexpr size_t ROW_OFF = P_OFF + sizeof(__nv_bfloat16) * BQ * P_LD;
  static constexpr size_t BYTES = ROW_OFF + sizeof(float) * 3 * BQ;
  static_assert(D >= BKV, "the staging tile holds a score tile in its first BKV columns");
  static_assert(D % 32 == 0, "each lane owns whole 32-column chunks of the output");
};

// Rows [r0, r0 + 64) of a (seq, D) matrix into a padded tile, 16 bytes a
// thread at a time; rows past seq are zero so they add nothing to P.V.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int r0, int seq, int tid) {
  constexpr int CHUNKS = D / 8;
  for (int c = tid; c < 64 * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < seq) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + col);
    *reinterpret_cast<uint4*>(dst + r * Layout<D>::D_LD + col) = val;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                 int seq, float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  auto* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::Q_OFF);
  auto* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::K_OFF);
  auto* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::V_OFF);
  auto* Ss = reinterpret_cast<float*>(smem + L::S_OFF);
  auto* Ps = reinterpret_cast<__nv_bfloat16*>(smem + L::P_OFF);
  auto* row_m = reinterpret_cast<float*>(smem + L::ROW_OFF);
  float* row_l = row_m + BQ;
  float* row_c = row_l + BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int iq = blockIdx.x;
  const int q0 = iq * BQ;
  const size_t base = (size_t)blockIdx.y * seq * D;
  const int w0 = warp * ROWS_PER_WARP;  // first local row of this warp

  load_tile<D>(Qs, q + base, q0, seq, tid);
  if (tid < BQ) {
    row_m[tid] = MASKED;
    row_l[tid] = 0.0f;
  }

  // Lane-owned output slice: element i is row w0 + i / CPR, column
  // (i % CPR) * 32 + lane of the warp's 16 x D rows.
  constexpr int CPR = D / 32;
  constexpr int N_ACC = ROWS_PER_WARP * CPR;
  float acc[N_ACC];
#pragma unroll
  for (int i = 0; i < N_ACC; ++i) acc[i] = 0.0f;

  const int n_all = (seq + BKV - 1) / BKV;
  const int n_kv = CAUSAL ? min(n_all, ((iq + 1) * BQ + BKV - 1) / BKV) : n_all;

  for (int t = 0; t < n_kv; ++t) {
    const int kv0 = t * BKV;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(Ks, k + base, kv0, seq, tid);
    load_tile<D>(Vs, v + base, kv0, seq, tid);
    __syncthreads();

    // Scores of the warp's 16 rows against the 64 keys of this tile.
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf[BKV / 16];
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j) wmma::fill_fragment(sf[j], 0.0f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa;
        wmma::load_matrix_sync(qa, Qs + w0 * L::D_LD + kk * 16, L::D_LD);
#pragma unroll
        for (int j = 0; j < BKV / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kb;
          wmma::load_matrix_sync(kb, Ks + j * 16 * L::D_LD + kk * 16, L::D_LD);
          wmma::mma_sync(sf[j], qa, kb, sf[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j)
        wmma::store_matrix_sync(Ss + w0 * L::S_LD + j * 16, sf[j], L::S_LD, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax, one row at a time across the warp's lanes.
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int lr = w0 + r, qrow = q0 + lr;
      float s[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h, col = kv0 + c;
        const bool masked = col >= seq || (CAUSAL && col > qrow);
        s[h] = masked ? MASKED : Ss[lr * L::S_LD + c] * scale;
      }
      const float m_old = row_m[lr];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s[0], s[1])));
      const float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
      const float sum = warp_sum(p0 + p1);
      Ps[lr * L::P_LD + lane] = __float2bfloat16(p0);
      Ps[lr * L::P_LD + lane + 32] = __float2bfloat16(p1);
      __syncwarp();  // every lane has read row_m[lr]
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        row_m[lr] = m_new;
        row_l[lr] = row_l[lr] * corr + sum;
        row_c[lr] = corr;
      }
    }
    __syncwarp();

    // P.V for the warp's rows, one 16-column slice of the output at a time,
    // into the staging tile (the scores there are consumed).
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::fill_fragment(of, 0.0f);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vb;
        wmma::load_matrix_sync(pa, Ps + w0 * L::P_LD + kk * 16, L::P_LD);
        wmma::load_matrix_sync(vb, Vs + kk * 16 * L::D_LD + n * 16, L::D_LD);
        wmma::mma_sync(of, pa, vb, of);
      }
      wmma::store_matrix_sync(Ss + w0 * L::S_LD + n * 16, of, L::S_LD, wmma::mem_row_major);
    }
    __syncwarp();

#pragma unroll
    for (int i = 0; i < N_ACC; ++i) {
      const int lr = w0 + i / CPR, c = (i % CPR) * 32 + lane;
      acc[i] = acc[i] * row_c[lr] + Ss[lr * L::S_LD + c];
    }
  }

#pragma unroll
  for (int i = 0; i < N_ACC; ++i) {
    const int lr = w0 + i / CPR, c = (i % CPR) * 32 + lane;
    if (q0 + lr < seq)
      out[base + (size_t)(q0 + lr) * D + c] = __float2bfloat16(acc[i] / row_l[lr]);
  }
}

template <int D, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int bh, int seq,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D, CAUSAL>;
  const size_t bytes = Layout<D>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + BQ - 1) / BQ, bh);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), seq, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int k2_flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                       int bh, int seq, int head_dim, int causal,
                                       void* stream) {
  if (bh <= 0 || seq <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (head_dim == 128)
    err = causal ? launch<128, true>(q, k, v, out, bh, seq, s)
                 : launch<128, false>(q, k, v, out, bh, seq, s);
  else
    err = cudaErrorInvalidValue;  // the only head_dim on the probe's path
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
