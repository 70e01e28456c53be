// FlashAttention forward for Hopper (sm_90a), bf16: TMA loads into a ring of
// K/V stages, warp-specialised producer and consumers, both products on wgmma.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_fwd_kernel / flash_attention) for bf16 inputs:
// O = softmax(Q K^T / sqrt(D) + mask) V with an online softmax over key/value
// tiles, the causal tile skip, the -1e30 sentinel, acc / max(l, 1e-30) at the
// end and the GQA map h -> h / G. Its shape is the one the simulator models in
// src/repro/core/kprog/fa3.py (FA3PingPong): one producer, two consumer
// warpgroups of 64 query rows, a K/V ring of mbarrier-guarded stages filled
// by TMA over (B, S, H, D) tensors, ping-pong between the consumers.
//
// Bound: at the serving shape (B 1, H 16, Hkv 2, L = S = 512, D 128, causal)
// a call moves 4.7 MB (1.41 us at 3.35 TB/s) and does 1.08 GFLOP (1.09 us at
// 989 TFLOP/s bf16): both bounds are about equal. What the design does about
// each:
// - bytes: every K/V tile is fetched by TMA once per CTA and feeds the CTA's
//   128 query rows from shared memory; CTAs of one KV head run side by side so
//   the other query heads of the group find the tile in L2. Tiles wholly above
//   the diagonal are never loaded; ragged rows and head dims are zero-filled
//   by TMA, never padded in device memory; the output is stored by TMA, which
//   clips rows >= L and head dims >= D.
// - operations: Q K^T and P V are wgmma (bf16 in, fp32 accumulators in
//   registers). The online softmax runs in registers in fp32, with exp2 (the
//   MUFU ex2.approx instruction) and log2(e) folded into the score scale (the
//   -1e30 sentinel is applied to the scaled scores, so a row masked so far
//   still gives exp(0) = 1 as in the TPU kernel). P goes into P V from registers as bf16, as in FA3; the TPU
//   kernel keeps P fp32 there (the deliberate deviation of this route).
// - overlap: one producer thread keeps STAGES K and V tiles in flight. The two
//   consumers take turns at the tensor cores through two named barriers
//   (ping-pong): one consumer's softmax runs while the other's wgmmas do. In
//   each consumer the P V of tile j - 1 is issued behind the Q K^T of tile j,
//   so it also overlaps that tile's softmax; acc is rescaled for tile j before
//   the P V of tile j is issued.
//
// Work split: a CTA is 3 warpgroups (2 consumers, then the producer, which
// gives its registers to the consumers with setmaxnreg). It owns two adjacent
// 64-row query tiles of one (batch, head), one per consumer, and walks the K/V
// tiles up to the diagonal of its last row. At the serving shape that is 4 row blocks x 16 heads = 64 CTAs, one
// wave on 132 SMs. The grid is ordered so the row blocks with the most K/V
// tiles (causal) start first, and within a row block the query heads of one
// KV head are adjacent.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BM = 64;                        // query rows of one consumer warpgroup
constexpr int BN = 128;                       // key/value rows of a tile
constexpr int CONSUMERS = 2;
constexpr int NTHREADS = (CONSUMERS + 1) * 128;   // consumer warpgroups 0, 1; producer 2
// registers a thread of each role keeps after setmaxnreg: 128 x 24 + 256 x 240
// = 64512 of the SM's 65536 (the launch gives every thread 168)
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int SW = 64;                        // bf16 columns of one 128-byte swizzle row
constexpr int BAR_TURN = 1;                   // named barriers 1, 2: consumer c's turn
constexpr int BAR_EPILOGUE = 3;               // named barriers 3, 4: consumer c's epilogue
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory, from a 1024-byte aligned base. Each tile is stored as
// DP / 64 column blocks of (rows x 128 bytes) in TMA's 128-byte swizzle.
template <int DP, int STAGES>
struct Layout {
  static constexpr int KB = DP / SW;
  static constexpr int Q_BLOCK = BM * SW * 2;
  static constexpr int KV_BLOCK = BN * SW * 2;
  static constexpr int Q_TILE = KB * Q_BLOCK;
  static constexpr int KV_TILE = KB * KV_BLOCK;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = CONSUMERS * Q_TILE;
  static constexpr int V_OFF = K_OFF + STAGES * KV_TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_TILE;
  static constexpr int ALLOC = BAR_OFF + (1 + 4 * STAGES) * 8 + 1024;
};

// S (64 x 128) = Q (64 x DP, shared) K^T (K: 128 x DP, shared), both K-major;
// issued and committed as one group
template <int DP>
__device__ __forceinline__ void qk_gemm(float (&sc)[BN / 2], const uint8_t* q, const uint8_t* k) {
  constexpr int Q_BLOCK = BM * SW * 2;
  constexpr int KV_BLOCK = BN * SW * 2;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int off = (kk % 4) * 32;             // byte offset of 16 columns in a 128-byte row
    const uint64_t da = wgmma_desc_sw128(q + (kk / 4) * Q_BLOCK + off, 16, 1024);
    const uint64_t db = wgmma_desc_sw128(k + (kk / 4) * KV_BLOCK + off, 16, 1024);
    wgmma_ss(sc, da, db, kk > 0);
  }
  wgmma_commit();
}

// O (64 x DP) += P (64 x 128, registers) V (128 x DP, shared, MN-major);
// issued and committed as one group
template <int DP>
__device__ __forceinline__ void pv_gemm(float (&o)[DP / 2], const uint32_t (&p)[BN / 16][4],
                                        const uint8_t* v) {
  constexpr int KV_BLOCK = BN * SW * 2;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    // 16 key rows per step (2 groups of 8 rows, 1024 bytes apart); the
    // head-dim blocks of 64 columns are KV_BLOCK bytes apart
    const uint64_t db = wgmma_desc_sw128(v + kk * 16 * 128, KV_BLOCK, 1024);
    wgmma_rs(o, p[kk], db, 1);
  }
  wgmma_commit();
}

// 2^x in one MUFU instruction (ex2.approx, relative error about 2^-22; inputs
// below -126 give 0, which the sentinel -1e30 relies on)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of tile j's scores `sc` (fp32, in registers, log2 units):
// mask, row max across the quad of threads that share a row, P = exp2(s - m),
// row sums. Then, once the previous tile's P V is done (with AFTER_PV, which
// also releases that tile's V stage `v_free`), acc is rescaled and P is packed
// to bf16 for the next P V.
template <int DP, bool AFTER_PV>
__device__ __forceinline__ void online_softmax(float (&sc)[BN / 2], float (&m_run)[2],
                                               float (&l_run)[2], float (&o)[DP / 2],
                                               uint32_t (&p)[BN / 16][4], int j, int S,
                                               int causal, int row0, int first_row,
                                               float scale_log2, int lane,
                                               uint64_t* v_free) {
  const int col0 = j * BN;
  const bool edge = col0 + BN > S || (causal && col0 + BN - 1 > first_row);
  // Row max and row sum each run as 4 independent chains per row (8 steps
  // deep, not 32): with two warps per scheduler there is little else to hide
  // the latency of a long dependent chain behind.
  float mx4[2][4], rs4[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      mx4[r][k] = m_run[r];
      rs4[r][k] = 0.f;
    }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    float x = sc[i] * scale_log2;
    if (edge) {
      const int col = col0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
      const int row = row0 + 8 * ((i % 4) / 2);
      if (col >= S || (causal && col > row)) x = NEG_INF;
    }
    sc[i] = x;
    mx4[(i % 4) / 2][(i / 4) % 4] = fmaxf(mx4[(i % 4) / 2][(i / 4) % 4], x);
  }
  float mx[2], corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(fmaxf(mx4[r][0], mx4[r][1]), fmaxf(mx4[r][2], mx4[r][3]));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = fast_exp2(m_run[r] - mx[r]);
    m_run[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const float e = fast_exp2(sc[i] - mx[(i % 4) / 2]);
    sc[i] = e;
    rs4[(i % 4) / 2][(i / 4) % 4] += e;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l_run[r] = l_run[r] * corr[r] + ((rs4[r][0] + rs4[r][1]) + (rs4[r][2] + rs4[r][3]));

  if constexpr (AFTER_PV) {
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(v_free);
  }
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i % 4) / 2];
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    p[kk][0] = pack_bf16x2(sc[8 * kk + 0], sc[8 * kk + 1]);
    p[kk][1] = pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
    p[kk][2] = pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
    p[kk][3] = pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

template <int DP, int STAGES>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_o,
                      int B, int H, int G, int L, int S, float scale_log2, int causal) {
  using Ly = Layout<DP, STAGES>;
  constexpr int KB = Ly::KB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + Ly::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + STAGES;
  uint64_t* v_full = k_empty + STAGES;
  uint64_t* v_empty = v_full + STAGES;

  // work item: the last row block first, then batch, then head (h = hk * G + g)
  const int n_mblk = (L + CONSUMERS * BM - 1) / (CONSUMERS * BM);
  int item = blockIdx.x;
  const int h = item % H;
  item /= H;
  const int b = item % B;
  item /= B;
  const int m0 = (n_mblk - 1 - item) * CONSUMERS * BM;
  const int hk = h / G;
  int n_tiles = (S + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (m0 + CONSUMERS * BM + BN - 1) / BN);

  // the role is uniform across each warp; the shuffle tells the compiler so
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], CONSUMERS * 4);   // one arrival per consumer warp
      mbar_init(&v_empty[s], CONSUMERS * 4);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp / 4 == CONSUMERS) {
    // ---------------- producer: one thread issues every TMA load ----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMERS * 4 && lane == 0) {
      prefetch_tensor_map(&tm_q);
      prefetch_tensor_map(&tm_k);
      prefetch_tensor_map(&tm_v);
      mbar_expect_tx(q_full, CONSUMERS * Ly::Q_TILE);
#pragma unroll
      for (int c = 0; c < CONSUMERS; ++c)
#pragma unroll
        for (int kb = 0; kb < KB; ++kb)
          tma_load_4d(smem + Ly::Q_OFF + c * Ly::Q_TILE + kb * Ly::Q_BLOCK, &tm_q, q_full,
                      kb * SW, m0 + c * BM, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const uint32_t ph = (j / STAGES) & 1;
        mbar_wait(&k_empty[s], ph ^ 1);
        mbar_expect_tx(&k_full[s], Ly::KV_TILE);
#pragma unroll
        for (int kb = 0; kb < KB; ++kb)
          tma_load_4d(smem + Ly::K_OFF + s * Ly::KV_TILE + kb * Ly::KV_BLOCK, &tm_k, &k_full[s],
                      kb * SW, j * BN, hk, b);
        mbar_wait(&v_empty[s], ph ^ 1);
        mbar_expect_tx(&v_full[s], Ly::KV_TILE);
#pragma unroll
        for (int kb = 0; kb < KB; ++kb)
          tma_load_4d(smem + Ly::V_OFF + s * Ly::KV_TILE + kb * Ly::KV_BLOCK, &tm_v, &v_full[s],
                      kb * SW, j * BN, hk, b);
      }
    }
  } else {
    // ---------------- consumers --------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int c = warp / 4;                      // consumer warpgroup
    const int w = warp % 4;                      // warp within it: rows 16w .. 16w + 15
    const int row0 = m0 + c * BM + 16 * w + lane / 4;   // this thread's rows: row0, row0 + 8
    const uint8_t* q_s = smem + Ly::Q_OFF + c * Ly::Q_TILE;

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m_run[2] = {NEG_INF, NEG_INF};         // running max, in log2 units
    float l_run[2] = {0.f, 0.f};                 // this thread's share of the row sums
    uint32_t p[BN / 16][4];                      // P of the previous tile, bf16 pairs
    float sc[BN / 2];                            // scores of the current tile

    if (c == 1) named_bar_arrive(BAR_TURN + 0, CONSUMERS * 128);   // consumer 0 starts
    mbar_wait(q_full, 0);

    // Tile 0 is peeled off the loop, so that every wgmma below is issued
    // unconditionally (a wgmma under a branch is serialised by the compiler).
    mbar_wait(&k_full[0], 0);
    named_bar_sync(BAR_TURN + c, CONSUMERS * 128);
    qk_gemm<DP>(sc, q_s, smem + Ly::K_OFF);
    if (c == 0 || n_tiles > 1) named_bar_arrive(BAR_TURN + (1 - c), CONSUMERS * 128);
    wgmma_wait<0>();
    fence_regs(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&k_empty[0]);
    online_softmax<DP, false>(sc, m_run, l_run, o, p, 0, S, causal, row0, m0 + c * BM, scale_log2,
                              lane, nullptr);

    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const int sp = (j - 1) % STAGES;
      mbar_wait(&k_full[s], (j / STAGES) & 1);

      // --- my turn at the tensor cores: S_j = Q K_j^T, then O += P_{j-1} V_{j-1}
      named_bar_sync(BAR_TURN + c, CONSUMERS * 128);
      fence_regs(o);
      qk_gemm<DP>(sc, q_s, smem + Ly::K_OFF + s * Ly::KV_TILE);
      mbar_wait(&v_full[sp], ((j - 1) / STAGES) & 1);
      pv_gemm<DP>(o, p, smem + Ly::V_OFF + sp * Ly::KV_TILE);
      // the other consumer's turn (consumer 1 owes consumer 0 no turn after its last tile)
      if (c == 0 || j + 1 < n_tiles) named_bar_arrive(BAR_TURN + (1 - c), CONSUMERS * 128);

      wgmma_wait<1>();                           // S_j is done; P V may still run
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&k_empty[s]);
      // softmax of S_j overlaps P_{j-1} V_{j-1}, which must be done before acc is
      // rescaled for tile j: online_softmax waits for it between the two
      online_softmax<DP, true>(sc, m_run, l_run, o, p, j, S, causal, row0, m0 + c * BM,
                               scale_log2, lane, &v_empty[sp]);
    }

    // --- O += P V of the last tile
    {
      const int sp = (n_tiles - 1) % STAGES;
      mbar_wait(&v_full[sp], ((n_tiles - 1) / STAGES) & 1);
      fence_regs(o);
      pv_gemm<DP>(o, p, smem + Ly::V_OFF + sp * Ly::KV_TILE);
      wgmma_wait<0>();
      fence_regs(o);
    }

    // --- epilogue: O / max(l, 1e-30) as bf16 into this consumer's Q tile
    // (swizzled as TMA expects), then one TMA store that clips rows >= L. One
    // reciprocal per row: an IEEE division per element is a long sequence.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = 1.f / fmaxf(l, L_FLOOR);
    }
    uint8_t* o_s = smem + Ly::Q_OFF + c * Ly::Q_TILE;
#pragma unroll
    for (int i = 0; i < DP / 2; i += 2) {
      const int r = (i % 4) / 2;
      const int row = 16 * w + lane / 4 + 8 * r;             // row within the 64-row tile
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      const int cc = col % SW;
      const int off = (col / SW) * Ly::Q_BLOCK + row * 128 + (((cc / 8) ^ (row % 8)) * 16) +
                      (cc % 8) * 2;
      *reinterpret_cast<uint32_t*>(o_s + off) = pack_bf16x2(o[i] * inv[r], o[i + 1] * inv[r]);
    }
    fence_proxy_async();
    named_bar_sync(BAR_EPILOGUE + c, 128);
    if (threadIdx.x % 128 == 0 && m0 + c * BM < L) {
#pragma unroll
      for (int kb = 0; kb < KB; ++kb)
        tma_store_4d(&tm_o, o_s + kb * Ly::Q_BLOCK, kb * SW, m0 + c * BM, h, b);
      tma_store_drain();
    }
  }  // consumers
}

// 4-D map over a strided (batch, head, seq, D) tensor, dims innermost first:
// (D, seq, head, batch); element strides. Boxes are 64 columns x box_rows.
int encode(CUtensorMap* map, const void* ptr, int D, int rows, int heads, int batch,
           int64_t s_batch, int64_t s_head, int64_t s_row, int box_rows) {
  TensorMapEncodeTiledFn fn = tensor_map_encoder();
  if (fn == nullptr) return -1;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const int64_t st[3] = {s_row, s_head, s_batch};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    // an axis of extent 1 is never stepped along: give it a stride TMA accepts
    const int64_t bytes = dims[i + 1] == 1 ? 16 * (((int64_t)D * 2 + 15) / 16) : st[i] * 2;
    if (bytes <= 0 || bytes % 16 != 0 || bytes >= ((int64_t)1 << 40)) return -1;
    strides[i] = (cuuint64_t)bytes;
  }
  const cuuint32_t box[4] = {(cuuint32_t)SW, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1;
}

template <int DP, int STAGES>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const CUtensorMap& to, int B, int H, int Hkv, int L, int S, float scale,
           int causal, cudaStream_t stream) {
  const int bytes = Layout<DP, STAGES>::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<DP, STAGES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_mblk = (L + CONSUMERS * BM - 1) / (CONSUMERS * BM);
  flash_fwd_sm90_kernel<DP, STAGES><<<n_mblk * B * H, NTHREADS, bytes, stream>>>(
      tq, tk, tv, to, B, H, H / Hkv, L, S, scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 only. Strides are in elements: q (b, h, l), k (b, h, s), v (b, h, s),
// o (b, h, l); the head dim is contiguous. Every pointer must be 16-byte
// aligned and every stride a multiple of 8 elements (16 bytes), as TMA needs.
// Returns cudaGetLastError() of the launch (0 on success), -1 on a bad argument.
extern "C" int repro_flash_fwd_sm90(
    const void* q, const void* k, const void* v, void* o,
    int B, int H, int Hkv, int L, int S, int D,
    int64_t q_sb, int64_t q_sh, int64_t q_sl,
    int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t o_sb, int64_t o_sh, int64_t o_sl,
    float scale, int causal, void* stream) {
  if (D < 1 || D > 128 || B < 1 || Hkv < 1 || H % Hkv != 0 || L < 1 || S < 1) return -1;
  if (causal && L != S) return -1;
  const void* ptrs[4] = {q, k, v, o};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return -1;
  CUtensorMap tq, tk, tv, to;
  if (encode(&tq, q, D, L, H, B, q_sb, q_sh, q_sl, BM) ||
      encode(&tk, k, D, S, Hkv, B, k_sb, k_sh, k_ss, BN) ||
      encode(&tv, v, D, S, Hkv, B, v_sb, v_sh, v_ss, BN) ||
      encode(&to, o, D, L, H, B, o_sb, o_sh, o_sl, BM))
    return -1;
  cudaStream_t cs = (cudaStream_t)stream;
  if (D > 64) return launch<128, 2>(tq, tk, tv, to, B, H, Hkv, L, S, scale, causal, cs);
  return launch<64, 4>(tq, tk, tv, to, B, H, Hkv, L, S, scale, causal, cs);
}
