// K2: softmax attention forward over (batch*heads, seq, head_dim), bf16 in
// and out, causal or not, head_dim 16, 32, 64 or 128.
//
// Replaces the Pallas kernel `_flash_kernel` reached through
// `flash_attention` in k8s_operator_libs_tpu/ops/flash_attention.py, and
// computes what it computes: scores scaled by head_dim^-0.5 in f32, an
// online softmax over K/V tiles (running max m, denominator l, f32
// accumulator, correction by exp(m_old - m_new)), the finite mask value
// -1e30, the causal skip of K/V tiles past the diagonal, and the output cast
// to the input dtype. Unlike the Pallas kernel it takes any seq: rows and
// keys past seq are masked.
//
// Where it differs: the Pallas kernel keeps K and V of the whole sequence
// resident in VMEM and walks them in one grid step; a Hopper block has 227
// KB of shared memory and the card has 132 SMs, so here 64-row K/V tiles
// stream through shared memory, and the K/V range of one (batch*head, Q
// tile) may be split over several blocks. Both products run on the tensor
// cores with bf16 operands and f32 sums: Q.K^T is exact and scaled in f32
// after the product; P is rounded to bf16 before P.V (a relative error of
// up to 2^-9 on each weight). The softmax runs in base 2: the scores are
// scaled by head_dim^-0.5 * log2(e) in one multiply and exponentiated with
// exp2f, which is exp() of the same numbers.
//
// What bounds it: a causal head of seq s does 4*d operations on each of
// s(s+1)/2 pairs, so at seq 1024 and up the tensor cores bound it and the
// bytes (q, k, v, out once each) are a small share. At the health probe's
// (1, 4, 1024, 128) the real limit is filling the card: the (batch*head,
// Q tile) grid has only 64 blocks, and a causal Q tile near the end walks
// 16 K/V tiles while the first walks one.
//
// Design, in the order that matters at that shape:
//  1. Fill the card. When the (batch*head, Q tile) grid is too small for
//     the card, the caller passes `split` > 0 and each Q tile's K/V range
//     is cut into ceil(n_kv / split) balanced chunks of at most `split`
//     tiles, one block each. A block writes its unnormalised f32 output
//     and its (m, l) per row to scratch, and a second kernel,
//     `flash_combine_kernel`, folds the chunks of each Q tile with the
//     usual rescale. A Q tile whose range is one chunk writes its output
//     directly, and with split == 0 the combine kernel is not launched. The
//     combine kernel is a programmatic dependent launch, so its launch
//     overlaps the forward grid's tail. The heaviest Q tiles get the lowest
//     block indices, so they start first.
//  2. Keep S, P and O in registers. Each of the block's 4 warps owns 16 Q
//     rows. Products are `mma.sync.m16n8k16` (bf16 in, f32 sums) through
//     inline PTX, with operands read by `ldmatrix` (Q, K) and
//     `ldmatrix.trans` (V). The score fragment of a row lives in one quad
//     of 4 lanes, so the row max is two `__shfl_xor_sync` inside the quad,
//     and the row sum is kept per lane and reduced once at the end. P is
//     packed to bf16 straight into the A fragments of P.V: the C fragments
//     of two adjacent n8 tiles are the A fragment of one k16 slice. O is
//     rescaled in registers.
//  3. Overlap loads with math: K and V are double-buffered through
//     `cp.async`, so tile t+1 loads while tile t multiplies. Shared rows
//     are padded by 16 bytes, so the 8 rows one `ldmatrix` reads fall in 8
//     different bank groups at every head_dim. Q is read into registers
//     once and its tile is then reused as a K buffer, so at head_dim 128
//     two blocks fit an SM (three at the smaller head_dims).
//  4. Cheap elementwise work: one f32 multiply for scale and log2(e), the
//     causal mask only on the diagonal tile (and the ragged mask only on
//     the last), and `cudaFuncSetAttribute` once per instantiation and
//     device, not per launch.
// On an H100 the forward runs at about 1.5 TFLOP/s per SM, a fifth of the
// tensor cores' rate (PERF.md). Giving each warp 32 rows instead of 16 spilled
// at head_dim 128 and was slower; `wgmma`/TMA attention in the
// FlashAttention-3 style, which overlaps the softmax with the products, is
// left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <mutex>

namespace {

constexpr int BQ = 64, BKV = 64, WARPS = 4, THREADS = WARPS * 32;
// Blocks an SM holds at once, which bounds the registers a thread may use
// (at head_dim 128 three blocks would spill).
template <int D>
constexpr int min_blocks() {
  return D == 128 ? 2 : 3;
}
constexpr int COMBINE_THREADS = 256;
static_assert(BQ == BKV, "the diagonal K/V tile of Q tile i is tile i");
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_DEVICES = 64;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int D>
struct Smem {
  static_assert(D % 16 == 0 && D <= 128, "head_dim is a multiple of 16, at most 128");
  static constexpr int LD = D + 8;  // bf16 row stride: 16 bytes of padding
  static constexpr int TILE = BQ * LD;
  // K[0], K[1], V[0], V[1]; Q arrives in K[1], which its first refill
  // overwrites once every warp holds its Q fragments in registers.
  static constexpr size_t BYTES = sizeof(__nv_bfloat16) * 4 * TILE;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 sums.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [r0, r0 + 64) of a (seq, D) matrix into a padded shared tile, 16
// bytes a thread at a time; rows past seq are zeros.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                                          int seq, int tid) {
  constexpr int CHUNKS = D / 8;
  static_assert((BQ * CHUNKS) % THREADS == 0, "every thread loads whole chunks");
#pragma unroll
  for (int i = 0; i < BQ * CHUNKS / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    const bool in = r0 + r < seq;
    const __nv_bfloat16* g = src + (size_t)(in ? r0 + r : 0) * D + col;
    cp_async16(smem_u32(dst + r * Smem<D>::LD + col), g, in ? 16 : 0);
  }
}

// K/V tiles a Q tile sees, and the chunks they are cut into.
__device__ __forceinline__ int kv_tiles(int iq, int n_all, bool causal) {
  return causal ? min(n_all, iq + 1) : n_all;
}
__device__ __forceinline__ int chunk_count(int n_kv, int split) {
  return split > 0 ? cdiv(n_kv, split) : 1;
}

// grid (n_q * max_chunks, batch*heads); block (Q tile, chunk). part_o is
// [bh][n_q][max_chunks][BQ][D] f32 and part_ml [bh][n_q][max_chunks][BQ][2].
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, min_blocks<D>())
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ part_o, float* __restrict__ part_ml, int seq, int split,
                 int max_chunks, float scale_log2) {
  using S = Smem<D>;
  constexpr int LD = S::LD;
  constexpr int KD = D / 16;   // k16 steps of Q.K^T
  constexpr int NO = D / 8;    // n8 tiles of an output row
  constexpr int NS = BKV / 8;  // n8 tiles of a score row
  extern __shared__ __align__(128) unsigned char smem[];
  auto* tiles = reinterpret_cast<__nv_bfloat16*>(smem);
  auto Ks = [&](int b) { return tiles + b * S::TILE; };
  auto Vs = [&](int b) { return tiles + (2 + b) * S::TILE; };
  __nv_bfloat16* const Qs = Ks(1);

  const int n_q = cdiv(seq, BQ), n_all = cdiv(seq, BKV);
  const int iq = n_q - 1 - static_cast<int>(blockIdx.x) / max_chunks;  // heaviest first
  const int chunk = static_cast<int>(blockIdx.x) % max_chunks;
  const int n_kv = kv_tiles(iq, n_all, CAUSAL);
  const int n_chunks = chunk_count(n_kv, split);
  if (chunk >= n_chunks) return;
  const int t0 = chunk * n_kv / n_chunks, t1 = (chunk + 1) * n_kv / n_chunks;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;  // fragment row and column pair
  const int q0 = iq * BQ;
  const int row_g = q0 + warp * 16 + g;  // global row of fragment halves 0, 1; +8 for 2, 3
  const size_t base = (size_t)blockIdx.y * seq * D;

  load_tile<D>(Qs, q + base, q0, seq, tid);
  load_tile<D>(Ks(0), k + base, t0 * BKV, seq, tid);
  load_tile<D>(Vs(0), v + base, t0 * BKV, seq, tid);
  cp_async_commit();

  uint32_t qf[KD][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_row[2] = {MASKED, MASKED};  // rows row_g and row_g + 8, log2 domain
  float l_row[2] = {0.0f, 0.0f};      // this lane's share of the row sums

  for (int tt = t0; tt < t1; ++tt) {
    const int buf = (tt - t0) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile tt is in; every warp is done with tile tt - 1
    if (tt == t0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(smem_u32(Qs + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8),
                qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
      __syncthreads();  // every warp holds Q before K[1] is refilled
    }
    if (tt + 1 < t1) {
      load_tile<D>(Ks(buf ^ 1), k + base, (tt + 1) * BKV, seq, tid);
      load_tile<D>(Vs(buf ^ 1), v + base, (tt + 1) * BKV, seq, tid);
      cp_async_commit();
    }

    // S = Q.K^T for the warp's 16 rows and the tile's 64 keys.
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    const __nv_bfloat16* Kb = Ks(buf);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t b0, b1, b2, b3;
        const int key = jp * 16 + (lane / 16) * 8 + lane % 8;
        const int dim = kk * 16 + ((lane / 8) % 2) * 8;
        ldsm_x4(smem_u32(Kb + key * LD + dim), b0, b1, b2, b3);
        mma_16816(s[2 * jp], qf[kk], b0, b1);
        mma_16816(s[2 * jp + 1], qf[kk], b2, b3);
      }
    }

    const int kv0 = tt * BKV;
    const bool edge = (CAUSAL && tt == iq) || kv0 + BKV > seq;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int col = kv0 + j * 8 + t4 * 2 + (e & 1);
          const int row = row_g + (e >= 2 ? 8 : 0);
          if (col >= seq || (CAUSAL && col > row)) x = MASKED;
        }
        s[j][e] = x;
      }
    }

    // Online softmax on the fragments: a row lives in one quad of lanes.
    float m_new[2] = {m_row[0], m_row[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      m_new[0] = fmaxf(m_new[0], fmaxf(s[j][0], s[j][1]));
      m_new[1] = fmaxf(m_new[1], fmaxf(s[j][2], s[j][3]));
    }
    m_new[0] = quad_max(m_new[0]);
    m_new[1] = quad_max(m_new[1]);
    const float corr0 = exp2f(m_row[0] - m_new[0]), corr1 = exp2f(m_row[1] - m_new[1]);
    m_row[0] = m_new[0];
    m_row[1] = m_new[1];

    uint32_t p[NS][2];  // bf16 pairs: [0] row g, [1] row g + 8
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p0 = exp2f(s[j][0] - m_new[0]), p1 = exp2f(s[j][1] - m_new[0]);
      const float p2 = exp2f(s[j][2] - m_new[1]), p3 = exp2f(s[j][3] - m_new[1]);
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      p[j][0] = pack_bf16(p0, p1);
      p[j][1] = pack_bf16(p2, p3);
    }
    l_row[0] = l_row[0] * corr0 + sum0;
    l_row[1] = l_row[1] * corr1 + sum1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= corr0;
      o[n][1] *= corr0;
      o[n][2] *= corr1;
      o[n][3] *= corr1;
    }

    // O += P.V, P straight from the score fragments.
    const __nv_bfloat16* Vb = Vs(buf);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t a[4] = {p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0], p[2 * kk + 1][1]};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b0, b1, b2, b3;
        const int key = kk * 16 + lane % 8 + ((lane / 8) % 2) * 8;
        const int dim = np * 16 + (lane / 16) * 8;
        ldsm_x4_trans(smem_u32(Vb + key * LD + dim), b0, b1, b2, b3);
        mma_16816(o[2 * np], a, b0, b1);
        mma_16816(o[2 * np + 1], a, b2, b3);
      }
    }
  }

  const float l0 = quad_sum(l_row[0]), l1 = quad_sum(l_row[1]);
  if (n_chunks == 1) {
    const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
    __nv_bfloat16* dst = out + base;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + t4 * 2;
      if (row_g < seq)
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row_g * D + col) =
            __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
      if (row_g + 8 < seq)
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)(row_g + 8) * D + col) =
            __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
    }
    return;
  }
  const size_t slot = ((size_t)blockIdx.y * n_q + iq) * max_chunks + chunk;
  const int lr = warp * 16 + g;
  float* po = part_o + slot * BQ * D;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + t4 * 2;
    *reinterpret_cast<float2*>(po + lr * D + col) = make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(po + (lr + 8) * D + col) = make_float2(o[n][2], o[n][3]);
  }
  if (t4 == 0) {
    float* pml = part_ml + slot * BQ * 2;
    *reinterpret_cast<float2*>(pml + lr * 2) = make_float2(m_row[0], l0);
    *reinterpret_cast<float2*>(pml + (lr + 8) * 2) = make_float2(m_row[1], l1);
  }
}

// Folds the chunks of each split Q tile, one float4 of the output a thread:
// out = sum_c O_c 2^(m_c - M) / sum_c l_c 2^(m_c - M), M = max_c m_c.
// grid (n_q * combine_blocks<D>, batch*heads), launched as a programmatic
// dependent of the forward kernel: its launch overlaps the forward grid's
// tail, and `griddepcontrol.wait` holds it until that grid is done.
template <int D>
__host__ __device__ constexpr int combine_blocks() {
  return cdiv(BQ * D / 4, COMBINE_THREADS);
}

template <int D>
__global__ void __launch_bounds__(COMBINE_THREADS)
flash_combine_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                     __nv_bfloat16* __restrict__ out, int seq, int split, int max_chunks,
                     int causal) {
  constexpr int C4 = D / 4;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the forward grid is done
  const int iq = blockIdx.x / combine_blocks<D>();
  const int i = (blockIdx.x % combine_blocks<D>()) * COMBINE_THREADS + threadIdx.x;
  const int n_q = cdiv(seq, BQ);
  const int n_chunks = chunk_count(kv_tiles(iq, n_q, causal != 0), split);
  const int r = i / C4, col = (i % C4) * 4, row = iq * BQ + r;
  // A Q tile of one chunk was written by the forward kernel.
  if (n_chunks == 1 || r >= BQ || row >= seq) return;
  const size_t slot0 = ((size_t)blockIdx.y * n_q + iq) * max_chunks;
  const float* po = part_o + slot0 * BQ * D;
  const float* pml = part_ml + slot0 * BQ * 2;
  float m_max = MASKED;
  for (int c = 0; c < n_chunks; ++c) m_max = fmaxf(m_max, pml[(c * BQ + r) * 2]);
  float denom = 0.0f;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c = 0; c < n_chunks; ++c) {
    const float2 ml = *reinterpret_cast<const float2*>(pml + (c * BQ + r) * 2);
    const float w = exp2f(ml.x - m_max);
    denom += ml.y * w;
    const float4 x = *reinterpret_cast<const float4*>(po + ((size_t)c * BQ + r) * D + col);
    acc.x += x.x * w;
    acc.y += x.y * w;
    acc.z += x.z * w;
    acc.w += x.w * w;
  }
  const float inv = 1.0f / denom;
  __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
  __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
  *reinterpret_cast<uint2*>(out + (size_t)blockIdx.y * seq * D + (size_t)row * D + col) =
      make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}

template <int D, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* scratch, int bh,
                   int seq, int split, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D, CAUSAL>;
  constexpr size_t bytes = Smem<D>::BYTES;
  // Once per device, at the first launch there, never per launch.
  static std::once_flag once[MAX_DEVICES];
  static cudaError_t allowed[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [&] {
    allowed[dev] = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(bytes));
  });
  if (allowed[dev] != cudaSuccess) return allowed[dev];

  const int n_q = cdiv(seq, BQ), n_all = cdiv(seq, BKV);
  const int max_chunks = split > 0 ? cdiv(n_all, split) : 1;
  if (max_chunks == 1) split = 0;
  if (split > 0 && scratch == nullptr) return cudaErrorInvalidValue;
  float* part_o = static_cast<float*>(scratch);
  float* part_ml = split > 0 ? part_o + (size_t)bh * n_q * max_chunks * BQ * D : nullptr;
  const float scale_log2 = static_cast<float>(1.0 / sqrt(static_cast<double>(D))) * LOG2E;
  kernel<<<dim3(n_q * max_chunks, bh), THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), part_o, part_ml,
      seq, split, max_chunks, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 0) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n_q * combine_blocks<D>(), bh);
  config.blockDim = dim3(COMBINE_THREADS);
  config.stream = stream;
  cudaLaunchAttribute overlap[1];
  overlap[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = overlap;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, flash_combine_kernel<D>, static_cast<const float*>(part_o),
                            static_cast<const float*>(part_ml), static_cast<__nv_bfloat16*>(out),
                            seq, split, max_chunks, CAUSAL ? 1 : 0);
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out, void* scratch, int bh,
                     int seq, int causal, int split, cudaStream_t stream) {
  return causal ? launch<D, true>(q, k, v, out, scratch, bh, seq, split, stream)
                : launch<D, false>(q, k, v, out, scratch, bh, seq, split, stream);
}

}  // namespace

// The f32 elements of scratch that k2_flash_attention_bf16 needs for this
// split, written to *elems: 0 when split is 0 or one chunk covers every Q
// tile's range (no combine), else room for each chunk's partial O and (m, l).
extern "C" int k2_scratch_elems(int bh, int seq, int head_dim, int split, long long* elems) {
  if (bh <= 0 || seq <= 0 || split < 0 || head_dim <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_q = cdiv(seq, BQ), max_chunks = split > 0 ? cdiv(cdiv(seq, BKV), split) : 1;
  *elems = max_chunks == 1 ? 0 : (long long)bh * n_q * max_chunks * BQ * (head_dim + 2);
  return static_cast<int>(cudaSuccess);
}

// scratch: k2_scratch_elems f32 elements; unused (may be null) when that
// is 0.
extern "C" int k2_flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                       void* scratch, int bh, int seq, int head_dim, int causal,
                                       int split, void* stream) {
  if (bh <= 0 || bh > 65535 || seq <= 0 || split < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (head_dim) {
    case 16: err = launch_d<16>(q, k, v, out, scratch, bh, seq, causal, split, s); break;
    case 32: err = launch_d<32>(q, k, v, out, scratch, bh, seq, causal, split, s); break;
    case 64: err = launch_d<64>(q, k, v, out, scratch, bh, seq, causal, split, s); break;
    case 128: err = launch_d<128>(q, k, v, out, scratch, bh, seq, causal, split, s); break;
    default: err = cudaErrorInvalidValue;  // KERNEL_HEAD_DIMS in ops/flash_attention.py
  }
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
