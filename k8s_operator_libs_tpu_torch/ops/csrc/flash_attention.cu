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
// KB of shared memory and the card has 132 SMs, so here K/V tiles stream
// through shared memory, and the K/V range of one (batch*head, Q tile) may
// be split over several blocks. Both products run on the tensor cores with
// bf16 operands and f32 sums: Q.K^T is exact and scaled in f32 after the
// product; P is rounded to bf16 before P.V (a relative error of up to 2^-9
// on each weight). The softmax runs in base 2: the scores are scaled by
// head_dim^-0.5 * log2(e) and exponentiated with exp2f or `ex2.approx`,
// which is exp() of the same numbers.
//
// What bounds it: a causal head of seq s does 4*d operations on each of
// s(s+1)/2 pairs, so at seq 1024 and up the tensor cores bound it and the
// bytes (q, k, v, out once each) are a small share. At the health probe's
// (1, 4, 1024, 128) the real limit is filling the card: the grid of
// (batch*head, Q tile) has a few dozen blocks, and a causal Q tile near the
// end walks every K/V tile while the first walks one.
//
// Two kernel families. The wrapper (`kernel_family` in
// ops/flash_attention.py) picks one by one test: is head_dim 64 or 128, and
// is every base 16-byte aligned, so that TMA can describe q, k and v?
//
// Yes: `hopper::flash_wgmma_kernel`, in the FlashAttention-3 shape.
//  - One block per (batch*head, 128-row Q tile, chunk), 384 threads: one
//    producer warpgroup and two consumer warpgroups of 64 Q rows each.
//    `setmaxnreg` moves registers from the first (24 a thread) to the
//    others (240).
//  - One producer thread brings Q once, then K and V tiles of 128 rows
//    through a ring of 2 stages by TMA (`cp.async.bulk.tensor.3d`) in the
//    128-byte swizzle. K and V each have a full and an empty mbarrier per
//    stage, so Q.K^T of a tile starts before its V has landed. q, k and v
//    are described to TMA as 3-D (head_dim, seq, batch*head) tensors: rows
//    past seq load as zeros and never reach into the next head. At
//    head_dim 128 that is 32 KB of Q and 2 x 64 KB of K/V stages.
//  - S = Q.K^T is `wgmma.m64n128k16` with both operands in shared memory
//    (K, row-major, is K-major). O += P.V is `wgmma.m64n{64,128}k16` with P
//    taken from registers: the f32 score fragments of two adjacent n8
//    columns, rounded to bf16, are the A fragment of one k16 slice. V comes
//    from shared memory with the transpose flag of an N-major B.
//  - The softmax overlaps the products. Within a warpgroup, tile j's S is
//    issued with tile j-1's P.V queued behind it; the warpgroup waits for S
//    alone, runs tile j's softmax while P.V runs, then waits for P.V and
//    rescales O. Between the two warpgroups, two named barriers pass the
//    turn to issue products back and forth (ping-pong), so that one
//    warpgroup's softmax runs while the other's products do.
//  - A row of the m64 accumulator lives in one quad of lanes, so the row
//    max is two shuffles inside the quad; the row sum is kept per lane and
//    reduced once at the end. The max is taken over the raw scores, and
//    each weight is then one FFMA (scale and subtract the scaled max) and
//    one `ex2.approx` instruction.
//  - The epilogue writes bf16 straight from the accumulator registers and
//    leaves out rows past seq.
//  - The tensor maps are encoded on the host at each call and passed by
//    value as `__grid_constant__` parameters, so a CUDA graph captures them
//    with the launch. `cuTensorMapEncodeTiled` is reached through
//    `cudaGetDriverEntryPoint` (no -lcuda) once, and the shared-memory
//    allowance is set once per device.
//
// No: `mma::flash_fwd_kernel`, the first family, for head_dim 16 and 32
// (the burn-in's and the entry's widths) and for misaligned views.
//  - Each of the block's 4 warps owns 16 of its 64 Q rows. Products are
//    `mma.sync.m16n8k16` (bf16 in, f32 sums) through inline PTX, with
//    operands read by `ldmatrix` (Q, K) and `ldmatrix.trans` (V). P is
//    packed to bf16 straight into the A fragments of P.V, as above, and O
//    is rescaled in registers.
//  - K and V of 64 rows are double-buffered through `cp.async`, so tile t+1
//    loads while tile t multiplies. `cp.async` reads 16 aligned bytes, so
//    the entry point refuses a base that is not 16-byte aligned, and the
//    wrapper hands a view that starts between an aligned copy. Shared rows
//    are padded by 16 bytes, so the 8 rows one `ldmatrix` reads fall in 8
//    different bank groups at every head_dim. Q is read into registers once and its tile is then
//    reused as a K buffer, so at head_dim 128 two blocks fit an SM (three
//    at the smaller head_dims).
//  - On an H100 it runs at about 1.5 TFLOP/s per SM, a fifth of the tensor
//    cores' rate (PERF.md, where the wgmma family's times stand beside it);
//    giving each warp 32 rows instead of 16 spilled at head_dim 128 and was
//    slower.
//
// Both families:
//  - Fill the card. When the (batch*head, Q tile) grid is too small for
//    the card, the caller passes `split` > 0 and each Q tile's K/V range
//    is cut into ceil(n_kv / split) balanced chunks of at most `split`
//    tiles, one block each (`split_plan` and `wgmma_plan` in
//    ops/flash_attention.py). A block writes its unnormalised f32 output
//    and its (m, l) per row to scratch, and `flash_combine_kernel` folds the
//    chunks of each Q tile with the usual rescale. A Q tile whose range is
//    one chunk writes its output directly, and with split == 0 the combine
//    kernel is not launched. The combine kernel is a programmatic dependent
//    launch, so its launch overlaps the forward grid's tail. The heaviest Q
//    tiles get the lowest block indices, so they start first.
//  - Cheap elementwise work: the causal mask only on the diagonal tile (and
//    the ragged mask only on the last); in the first family one f32
//    multiply for scale and log2(e) before the max.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <initializer_list>
#include <mutex>

namespace {

constexpr int COMBINE_THREADS = 256;
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_DEVICES = 64;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// K/V tiles a Q tile sees (Q and K/V tiles have one size in each family),
// and the chunks they are cut into.
__device__ __forceinline__ int kv_tiles(int iq, int n_all, bool causal) {
  return causal ? min(n_all, iq + 1) : n_all;
}
__device__ __forceinline__ int chunk_count(int n_kv, int split) {
  return split > 0 ? cdiv(n_kv, split) : 1;
}

// Chunks of the longest K/V range at this split: 1 means no combine.
__host__ __device__ constexpr int max_chunks_of(int n_tiles, int split) {
  return split > 0 ? cdiv(n_tiles, split) : 1;
}

// The f32 scratch a family with `tile` rows per Q tile needs at this split:
// each chunk's partial O and its (m, l) per row, or nothing without a combine.
long long scratch_elems(int tile, int bh, int seq, int head_dim, int split) {
  const int n_q = cdiv(seq, tile), chunks = max_chunks_of(n_q, split);
  return chunks == 1 ? 0 : (long long)bh * n_q * chunks * tile * (head_dim + 2);
}

// Whether every pointer starts on 16 bytes, as `cp.async` and TMA read them.
bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// head_dim^-0.5 * log2(e): one multiply takes a score to the base-2 domain.
template <int D>
float scale_log2() {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(D))) * LOG2E;
}

// Folds the chunks of each split Q tile of TILE rows, one float4 of the
// output a thread:
// out = sum_c O_c 2^(m_c - M) / sum_c l_c 2^(m_c - M), M = max_c m_c.
// grid (n_q * combine_blocks<TILE, D>, batch*heads), launched as a programmatic
// dependent of the forward kernel: its launch overlaps the forward grid's
// tail, and `griddepcontrol.wait` holds it until that grid is done.
template <int TILE, int D>
__host__ __device__ constexpr int combine_blocks() {
  return cdiv(TILE * D / 4, COMBINE_THREADS);
}

template <int TILE, int D>
__global__ void __launch_bounds__(COMBINE_THREADS)
flash_combine_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                     __nv_bfloat16* __restrict__ out, int seq, int split, int max_chunks,
                     int causal) {
  constexpr int C4 = D / 4;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the forward grid is done
  const int iq = blockIdx.x / combine_blocks<TILE, D>();
  const int i = (blockIdx.x % combine_blocks<TILE, D>()) * COMBINE_THREADS + threadIdx.x;
  const int n_q = cdiv(seq, TILE);
  const int n_chunks = chunk_count(kv_tiles(iq, n_q, causal != 0), split);
  const int r = i / C4, col = (i % C4) * 4, row = iq * TILE + r;
  // A Q tile of one chunk was written by the forward kernel.
  if (n_chunks == 1 || r >= TILE || row >= seq) return;
  const size_t slot0 = ((size_t)blockIdx.y * n_q + iq) * max_chunks;
  const float* po = part_o + slot0 * TILE * D;
  const float* pml = part_ml + slot0 * TILE * 2;
  float m_max = MASKED;
  for (int c = 0; c < n_chunks; ++c) m_max = fmaxf(m_max, pml[(c * TILE + r) * 2]);
  float denom = 0.0f;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c = 0; c < n_chunks; ++c) {
    const float2 ml = *reinterpret_cast<const float2*>(pml + (c * TILE + r) * 2);
    const float w = exp2f(ml.x - m_max);
    denom += ml.y * w;
    const float4 x = *reinterpret_cast<const float4*>(po + ((size_t)c * TILE + r) * D + col);
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

// Launches flash_combine_kernel<TILE, D> behind the forward grid just
// launched on `stream`.
template <int TILE, int D>
cudaError_t launch_combine(const float* part_o, const float* part_ml, void* out, int bh, int seq,
                           int split, int max_chunks, bool causal, cudaStream_t stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cdiv(seq, TILE) * combine_blocks<TILE, D>(), bh);
  config.blockDim = dim3(COMBINE_THREADS);
  config.stream = stream;
  cudaLaunchAttribute overlap[1];
  overlap[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = overlap;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, flash_combine_kernel<TILE, D>, part_o, part_ml,
                            static_cast<__nv_bfloat16*>(out), seq, split, max_chunks,
                            causal ? 1 : 0);
}

// ---------------------------------------------------------------------------
// The mma.sync family: any head_dim of KERNEL_HEAD_DIMS, any alignment.

namespace mma {

constexpr int BQ = 64, BKV = 64, WARPS = 4, THREADS = WARPS * 32;
// Blocks an SM holds at once, which bounds the registers a thread may use
// (at head_dim 128 three blocks would spill).
template <int D>
constexpr int min_blocks() {
  return D == 128 ? 2 : 3;
}
static_assert(BQ == BKV, "the diagonal K/V tile of Q tile i is tile i");

template <int D>
struct Smem {
  static_assert(D % 16 == 0 && D <= 128, "head_dim is a multiple of 16, at most 128");
  static constexpr int LD = D + 8;  // bf16 row stride: 16 bytes of padding
  static constexpr int TILE = BQ * LD;
  // K[0], K[1], V[0], V[1]; Q arrives in K[1], which its first refill
  // overwrites once every warp holds its Q fragments in registers.
  static constexpr size_t BYTES = sizeof(__nv_bfloat16) * 4 * TILE;
};

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

  const int n_q = cdiv(seq, BQ), max_chunks = max_chunks_of(cdiv(seq, BKV), split);
  if (max_chunks == 1) split = 0;
  if (split > 0 && scratch == nullptr) return cudaErrorInvalidValue;
  float* part_o = static_cast<float*>(scratch);
  float* part_ml = split > 0 ? part_o + (size_t)bh * n_q * max_chunks * BQ * D : nullptr;
  kernel<<<dim3(n_q * max_chunks, bh), THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), part_o, part_ml,
      seq, split, max_chunks, scale_log2<D>());
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 0) return err;
  return launch_combine<BQ, D>(part_o, part_ml, out, bh, seq, split, max_chunks, CAUSAL,
                              stream);
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out, void* scratch, int bh,
                     int seq, int causal, int split, cudaStream_t stream) {
  return causal ? launch<D, true>(q, k, v, out, scratch, bh, seq, split, stream)
                : launch<D, false>(q, k, v, out, scratch, bh, seq, split, stream);
}

}  // namespace mma

// ---------------------------------------------------------------------------
// The wgmma family: TMA, an mbarrier ring, warp specialisation, ping-pong.

namespace hopper {

constexpr int BQ = 128, BKV = 128, STAGES = 2;
constexpr int CONSUMERS = 2;                    // warpgroups of 64 Q rows each
constexpr int THREADS = 128 * (1 + CONSUMERS);  // warpgroup 0 produces
constexpr int ROW_BYTES = 128;                  // one swizzled row: 64 bf16
constexpr int BOX = ROW_BYTES / 2;
constexpr int NS = BKV / 8;                     // n8 tiles of a score row
// Consumer c waits on named barrier TURN + c for its turn to issue products
// (barrier 0 is __syncthreads'); both consumer warpgroups take part in each.
constexpr int TURN = 1, TURN_THREADS = 128 * CONSUMERS;
static_assert(BQ == BKV, "the diagonal K/V tile of Q tile i is tile i");

template <int D>
struct Layout {
  static_assert(D == 64 || D == 128, "the wgmma family is built for head_dim 64 and 128");
  static constexpr int BOX_BYTES = BQ * ROW_BYTES;           // 64 columns of 128 rows
  static constexpr int TILE_BYTES = (D / BOX) * BOX_BYTES;   // Q, or one K or V stage
  static constexpr int K_OFF = TILE_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * TILE_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * TILE_BYTES;
  // 1024 bytes of slack to align the tiles, then q_full and, per stage,
  // k_full, v_full, k_empty and v_empty.
  static constexpr size_t BYTES = 1024 + BAR_OFF + (1 + 4 * STAGES) * sizeof(uint64_t);
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

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
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
// Keep the compiler from touching (or reusing) registers that an
// asynchronous wgmma reads or writes until the wait that covers it.
template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (+)= A (64x16, K-major) * B (16x128, K-major), both from shared memory.
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d += A (64x16 from registers) * B (16x128, N-major: transpose flag 1).
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += A (64x16 from registers) * B (16x64, N-major: transpose flag 1).
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// S = Q.K^T for the warpgroup's 64 rows and one K tile, as one group. Both
// operands are K-major: 16 columns are 32 bytes along a swizzled row, 8-row
// groups 1024 bytes apart, 64-column boxes BOX_BYTES apart.
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[BKV / 2], uint32_t q_rows,
                                             uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * Layout<D>::BOX_BYTES + (kk % 4) * 32;
    wgmma_ss_m64n128k16(s, smem_desc(q_rows + off, 16, 1024), smem_desc(k_tile + off, 16, 1024),
                        kk > 0 ? 1 : 0);
  }
  wgmma_commit();
}

// O += P.V for one V tile, P the bf16 A fragments in p, as one group. V is
// N-major: 16 K/V rows are 2048 bytes down a box, 8-row groups 1024 bytes
// apart, 64-column boxes BOX_BYTES apart.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[BKV / 4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    const uint64_t db = smem_desc(v_tile + kk * 16 * ROW_BYTES, Layout<D>::BOX_BYTES, 1024);
    if constexpr (D == 128)
      wgmma_rs_m64n128k16(o, a, db);
    else
      wgmma_rs_m64n64k16(o, a, db);
  }
  wgmma_commit();
}

// 2^x in one MUFU instruction (flushing denormals, which P's bf16 rounding
// would lose anyway).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The raw scores of K/V tile t, masked, folded into the running max m (of
// raw scores) and this lane's share of the row sums l; s is left holding
// the weights 2^((x - m) * scale_log2) in f32, one FFMA and one MUFU each,
// and corr the factors O is to be rescaled by. Every row of a tile keeps at
// least one key (key kv0 <= row on the diagonal, kv0 < seq on the ragged
// edge), so m is finite after the first tile. Accumulator fragment: n8
// tile j holds rows `row` and `row + 8`, columns 8j + 2*t4 and 8j + 2*t4 + 1.
template <bool CAUSAL>
__device__ __forceinline__ void softmax_tile(float (&s)[BKV / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int t, int iq, int row, int t4,
                                             int seq, float scale_log2) {
  const int kv0 = t * BKV;
  if ((CAUSAL && t == iq) || kv0 + BKV > seq) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + j * 8 + t4 * 2 + (e & 1);
        if (col >= seq || (CAUSAL && col > row + (e >= 2 ? 8 : 0))) s[4 * j + e] = MASKED;
      }
    }
  }
  float m_new[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    m_new[0] = fmaxf(m_new[0], fmaxf(s[4 * j], s[4 * j + 1]));
    m_new[1] = fmaxf(m_new[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float neg_max[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m_new[h] = quad_max(m_new[h]);
    corr[h] = exp2_approx((m[h] - m_new[h]) * scale_log2);
    m[h] = m_new[h];
    neg_max[h] = -m_new[h] * scale_log2;
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float w = exp2_approx(fmaf(s[4 * j + e], scale_log2, neg_max[e >> 1]));
      sum[e >> 1] += w;
      s[4 * j + e] = w;
    }
  }
  l[0] = l[0] * corr[0] + sum[0];
  l[1] = l[1] * corr[1] + sum[1];
}

// grid (n_q * max_chunks, batch*heads); block (Q tile, chunk). part_o is
// [bh][n_q][max_chunks][BQ][D] f32 and part_ml [bh][n_q][max_chunks][BQ][2].
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ part_o, float* __restrict__ part_ml, int seq, int split,
                   int max_chunks, float scale_log2) {
  using L = Layout<D>;
  extern __shared__ __align__(1024) unsigned char smem[];
  // The 128-byte swizzle repeats every 1024 bytes; tiles start on that.
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t bars = base + L::BAR_OFF;
  const uint32_t q_full = bars;
  auto k_tile = [&](int s) { return base + L::K_OFF + s * L::TILE_BYTES; };
  auto v_tile = [&](int s) { return base + L::V_OFF + s * L::TILE_BYTES; };
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto k_empty = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return bars + 8u * (1 + 3 * STAGES + s); };

  const int n_q = cdiv(seq, BQ);
  const int iq = n_q - 1 - static_cast<int>(blockIdx.x) / max_chunks;  // heaviest first
  const int chunk = static_cast<int>(blockIdx.x) % max_chunks;
  const int n_kv = kv_tiles(iq, n_q, CAUSAL);
  const int n_chunks = chunk_count(n_kv, split);
  if (chunk >= n_chunks) return;
  const int t0 = chunk * n_kv / n_chunks, t1 = (chunk + 1) * n_kv / n_chunks;
  const int bh = static_cast<int>(blockIdx.y);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), CONSUMERS * 4);  // lane 0 of every consumer warp
      mbar_init(v_empty(s), CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::TILE_BYTES);
#pragma unroll
      for (int j = 0; j < D / BOX; ++j)
        tma_load_3d(base + j * L::BOX_BYTES, &tm_q, j * BOX, iq * BQ, bh, q_full);
      for (int i = 0; i < t1 - t0; ++i) {
        const int s = i % STAGES;
        const uint32_t free_parity = ((i / STAGES) & 1) ^ 1;
        const int row = (t0 + i) * BKV;
        mbar_wait(k_empty(s), free_parity);
        mbar_expect_tx(k_full(s), L::TILE_BYTES);
#pragma unroll
        for (int j = 0; j < D / BOX; ++j)
          tma_load_3d(k_tile(s) + j * L::BOX_BYTES, &tm_k, j * BOX, row, bh, k_full(s));
        mbar_wait(v_empty(s), free_parity);
        mbar_expect_tx(v_full(s), L::TILE_BYTES);
#pragma unroll
        for (int j = 0; j < D / BOX; ++j)
          tma_load_3d(v_tile(s) + j * L::BOX_BYTES, &tm_v, j * BOX, row, bh, v_full(s));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int t4 = lane % 4;
    const int row = iq * BQ + c * 64 + warp * 16 + lane / 4;  // and row + 8
    const uint32_t q_rows = base + c * 64 * ROW_BYTES;
    float o[D / 2], s[BKV / 2];
    uint32_t p[BKV / 4];  // bf16 pairs: the A fragments of P.V
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) s[i] = 0.0f;
    float m[2] = {MASKED, MASKED}, l[2] = {0.0f, 0.0f}, corr[2];
    auto pack = [&] {
#pragma unroll
      for (int i = 0; i < BKV / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    };
    auto rescale = [&] {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n] *= corr[0];
        o[4 * n + 1] *= corr[0];
        o[4 * n + 2] *= corr[1];
        o[4 * n + 3] *= corr[1];
      }
    };
    // The n = t1 - t0 tiles take n + 1 turns: turn 0 issues S of tile 0,
    // turn i issues S of tile i and P.V of tile i - 1, turn n P.V of tile
    // n - 1. Consumer 0 takes each turn first. After each turn a consumer
    // hands the turn to the other, except consumer 1 after its last; the
    // arrive below stands for consumer 1's turn -1.
    const int n = t1 - t0;
    if (c == 1) bar_arrive(TURN, TURN_THREADS);
    mbar_wait(q_full, 0);

    mbar_wait(k_full(0), 0);
    bar_sync(TURN + c, TURN_THREADS);
    wgmma_fence();
    issue_scores<D>(s, q_rows, k_tile(0));
    bar_arrive(TURN + 1 - c, TURN_THREADS);
    wgmma_wait<0>();
    fence_operands(s);
    if (lane == 0) mbar_arrive(k_empty(0));
    softmax_tile<CAUSAL>(s, m, l, corr, t0, iq, row, t4, seq, scale_log2);
    pack();

    for (int i = 1; i < n; ++i) {
      const int ks = i % STAGES, vs = (i - 1) % STAGES;
      mbar_wait(k_full(ks), (i / STAGES) & 1);
      mbar_wait(v_full(vs), ((i - 1) / STAGES) & 1);
      bar_sync(TURN + c, TURN_THREADS);
      wgmma_fence();
      issue_scores<D>(s, q_rows, k_tile(ks));
      issue_pv<D>(o, p, v_tile(vs));
      bar_arrive(TURN + 1 - c, TURN_THREADS);
      wgmma_wait<1>();  // S is in; P.V may still run
      fence_operands(s);
      if (lane == 0) mbar_arrive(k_empty(ks));
      softmax_tile<CAUSAL>(s, m, l, corr, t0 + i, iq, row, t4, seq, scale_log2);
      wgmma_wait<0>();
      fence_operands(o);
      fence_operands(p);
      if (lane == 0) mbar_arrive(v_empty(vs));
      rescale();
      pack();
    }

    const int vs = (n - 1) % STAGES;
    mbar_wait(v_full(vs), ((n - 1) / STAGES) & 1);
    bar_sync(TURN + c, TURN_THREADS);
    wgmma_fence();
    issue_pv<D>(o, p, v_tile(vs));
    if (c == 0) bar_arrive(TURN + 1, TURN_THREADS);
    wgmma_wait<0>();
    fence_operands(o);
    fence_operands(p);

    const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
    if (n_chunks == 1) {
      const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
      __nv_bfloat16* dst = out + (size_t)bh * seq * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = j * 8 + t4 * 2;
        if (row < seq)
          *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * D + col) =
              __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
        if (row + 8 < seq)
          *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)(row + 8) * D + col) =
              __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
    } else {
      const size_t slot = ((size_t)bh * n_q + iq) * max_chunks + chunk;
      const int lr = c * 64 + warp * 16 + lane / 4;
      float* po = part_o + slot * BQ * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = j * 8 + t4 * 2;
        *reinterpret_cast<float2*>(po + lr * D + col) = make_float2(o[4 * j], o[4 * j + 1]);
        *reinterpret_cast<float2*>(po + (lr + 8) * D + col) =
            make_float2(o[4 * j + 2], o[4 * j + 3]);
      }
      if (t4 == 0) {
        float* pml = part_ml + slot * BQ * 2;
        // The combine kernel works in the base-2 domain.
        *reinterpret_cast<float2*>(pml + lr * 2) = make_float2(m[0] * scale_log2, l0);
        *reinterpret_cast<float2*>(pml + (lr + 8) * 2) = make_float2(m[1] * scale_log2, l1);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled = nullptr;

// A bf16 (head_dim, seq, batch*head) tensor map with boxes of 64 x 128 x 1
// elements in the 128-byte swizzle; rows past seq read as zeros.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int d, int seq, int bh) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(seq) * d * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(BOX), static_cast<cuuint32_t>(BQ), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode_tiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* scratch, int bh,
                   int seq, int split, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = make_map(&tm_q, q, D, seq, bh);
  if (err == cudaSuccess) err = make_map(&tm_k, k, D, seq, bh);
  if (err == cudaSuccess) err = make_map(&tm_v, v, D, seq, bh);
  if (err != cudaSuccess) return err;
  const int n_q = cdiv(seq, BQ), max_chunks = max_chunks_of(n_q, split);
  if (max_chunks == 1) split = 0;
  if (split > 0 && scratch == nullptr) return cudaErrorInvalidValue;
  float* part_o = static_cast<float*>(scratch);
  float* part_ml = split > 0 ? part_o + (size_t)bh * n_q * max_chunks * BQ * D : nullptr;
  flash_wgmma_kernel<D, CAUSAL><<<dim3(n_q * max_chunks, bh), THREADS, Layout<D>::BYTES, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), part_o, part_ml, seq, split, max_chunks,
      scale_log2<D>());
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 0) return err;
  return launch_combine<BQ, D>(part_o, part_ml, out, bh, seq, split, max_chunks, CAUSAL, stream);
}

template <int D>
cudaError_t allow_smem() {
  const int bytes = static_cast<int>(Layout<D>::BYTES);
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_kernel<D, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(flash_wgmma_kernel<D, false>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Once a process, the entry point of the tensor-map encoder, and once per
// device, at the first call there (outside any graph capture), the kernels'
// shared-memory allowance.
cudaError_t setup() {
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
    encode_tiled = reinterpret_cast<EncodeTiled>(fn);
  });
  if (entry_err != cudaSuccess) return entry_err;

  static std::once_flag once[MAX_DEVICES];
  static cudaError_t errs[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    cudaError_t e = allow_smem<64>();
    errs[dev] = e == cudaSuccess ? allow_smem<128>() : e;
  });
  return errs[dev];
}

}  // namespace hopper

}  // namespace

// The f32 elements of scratch that k2_flash_attention_bf16 needs for this
// split, written to *elems: 0 when split is 0 or one chunk covers every Q
// tile's range (no combine), else room for each chunk's partial O and (m, l).
extern "C" int k2_scratch_elems(int bh, int seq, int head_dim, int split, long long* elems) {
  if (bh <= 0 || seq <= 0 || split < 0 || head_dim <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  *elems = scratch_elems(mma::BQ, bh, seq, head_dim, split);
  return static_cast<int>(cudaSuccess);
}

// The same for k2_flash_attention_wgmma_bf16, whose Q tiles have 128 rows.
extern "C" int k2_wgmma_scratch_elems(int bh, int seq, int head_dim, int split,
                                      long long* elems) {
  if (bh <= 0 || seq <= 0 || split < 0 || head_dim <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  *elems = scratch_elems(hopper::BQ, bh, seq, head_dim, split);
  return static_cast<int>(cudaSuccess);
}

// The first family (mma.sync): any head_dim of KERNEL_HEAD_DIMS; q, k, v
// and out 16-byte aligned, as `cp.async` reads them. scratch:
// k2_scratch_elems f32 elements; unused (may be null) when that is 0.
extern "C" int k2_flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                       void* scratch, int bh, int seq, int head_dim, int causal,
                                       int split, void* stream) {
  if (bh <= 0 || bh > 65535 || seq <= 0 || split < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16({q, k, v, out})) return static_cast<int>(cudaErrorMisalignedAddress);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (head_dim) {
    case 16: err = mma::launch_d<16>(q, k, v, out, scratch, bh, seq, causal, split, s); break;
    case 32: err = mma::launch_d<32>(q, k, v, out, scratch, bh, seq, causal, split, s); break;
    case 64: err = mma::launch_d<64>(q, k, v, out, scratch, bh, seq, causal, split, s); break;
    case 128: err = mma::launch_d<128>(q, k, v, out, scratch, bh, seq, causal, split, s); break;
    default: err = cudaErrorInvalidValue;  // KERNEL_HEAD_DIMS in ops/flash_attention.py
  }
  return static_cast<int>(err);
}

// The wgmma family: head_dim 64 or 128, q, k, v and out 16-byte aligned
// (WGMMA_HEAD_DIMS and kernel_family in ops/flash_attention.py). scratch:
// k2_wgmma_scratch_elems f32 elements; unused (may be null) when that is 0.
extern "C" int k2_flash_attention_wgmma_bf16(const void* q, const void* k, const void* v,
                                             void* out, void* scratch, int bh, int seq,
                                             int head_dim, int causal, int split, void* stream) {
  if (bh <= 0 || bh > 65535 || seq <= 0 || split < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16({q, k, v, out})) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err = hopper::setup();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      err = causal ? hopper::launch<64, true>(q, k, v, out, scratch, bh, seq, split, s)
                   : hopper::launch<64, false>(q, k, v, out, scratch, bh, seq, split, s);
      break;
    case 128:
      err = causal ? hopper::launch<128, true>(q, k, v, out, scratch, bh, seq, split, s)
                   : hopper::launch<128, false>(q, k, v, out, scratch, bh, seq, split, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
