// FlashAttention forward for Hopper (sm_90a), fp32 inputs and fp32 arithmetic.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_fwd_kernel / flash_attention) for fp32 inputs: O = softmax(Q K^T /
// sqrt(D) + mask) V with an online softmax over key/value tiles, fp32 (acc, m,
// l), the -1e30 sentinel, acc / max(l, 1e-30) at the end, P kept fp32 into
// P.V, GQA h -> h / G. The TPU grid's sequential key/value axis, which carried
// (acc, m, l) in scratch memory, is a loop inside the block. bf16 inputs go to
// flash_fwd_sm90.cu.
//
// Bound: operations. The fp32 route must agree with an fp32 reference to 2e-5,
// which TF32 does not, and wgmma takes no fp32 input, so both products are
// fp32 FMAs. At the serving shape (B 1, H 16, Hkv 2, L = S = 512, D 128,
// causal) the call needs 4 * 16 * 128 * (512 * 513 / 2) = 1.077 GFLOP, 16.1 us
// at the card's 67 TFLOP/s fp32 rate, and moves 9.4 MB, 2.8 us at 3.35 TB/s.
// What the design does about it:
// - causal balance: a block owns query row tile i and row tile n - 1 - i of
//   one (batch, head) and walks each up to its own diagonal, one after the
//   other, so every block of a head does the same number of K/V tile steps (9
//   of 32 x 64 at the serving shape, 128 blocks). An odd row-tile count leaves
//   the middle tile alone; a non-causal call does not pair.
// - register tiling: each of the 4 warps owns 8 query rows. A lane owns a
//   4 x 4 block of S (4 rows, columns c, c + 16, c + 32, c + 48) and a 4 x 8
//   (D > 64) or 4 x 4 block of O, with the operands in registers: per 4-deep
//   step of Q.K^T a lane reads 4 Q and 4 K float4 for 64 FMAs, per 4 columns
//   of P.V 4 P and 4 or 8 V float4 for 64 or 128 FMAs. Shared rows are padded
//   or read by neighbouring lanes so that no read has a bank conflict, and the
//   lanes of a half-warp that share rows read them as one broadcast. P goes
//   through shared memory once per tile, into rows only its own warp reads.
// - asynchronous copies: K and V tiles land in a 2-stage ring through 16-byte
//   cp.async copies issued one tile ahead, so the next tile is in flight while
//   the current one is consumed; both query tiles of the block are copied
//   once, at the start. One block barrier per tile step. Rows past S (or L)
//   and head dims past D are zero-filled and read nothing.
// - the softmax works in base 2 with log2(e) folded into the score scale; the
//   mask is applied only on diagonal and ragged tiles; the row max is shared
//   across the 16 lanes of a row by shuffles, the row sum only at the end.
// Shared memory: 175,616 bytes a block for D > 64 (one block an SM), 93,696
// for D <= 64 (two).
//
// Tensors are addressed through element strides for batch, head and sequence
// (the head dim is contiguous), so the model-side (B, L, H, D) layout is read
// in place; the 16-byte copies need a 16-byte aligned base and strides that
// are multiples of 16 bytes, which the wrapper checks.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BM = 32;                 // query rows of a row tile
constexpr int BN = 64;                 // key/value rows of a K/V tile
constexpr int NTHREADS = 128;          // 4 warps of 8 query rows
constexpr int NSTAGES = 2;             // K/V ring
constexpr int PSTRIDE = BN + 4;        // P rows, padded: the two half-warps hit other banks
constexpr float LOG2E = 1.4426950408889634f;

template <int DP>
struct Layout {
  // Q and K rows are padded by 16 bytes, so that the float4 reads of
  // neighbouring rows (same head-dim offset) fall into different banks
  static constexpr int QSTRIDE = DP + 4;
  static constexpr int KSTRIDE = DP + 4;
  static constexpr int Q_FLOATS = BM * QSTRIDE;
  static constexpr int STAGE_FLOATS = BN * KSTRIDE + BN * DP;
  static constexpr int FLOATS = 2 * Q_FLOATS + NSTAGES * STAGE_FLOATS + BM * PSTRIDE;
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int G, L, S, D, causal, n_row_tiles, n_kv_tiles;
  int64_t q_sb, q_sh, q_sl, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_sl;
  float scale_log2;                    // 1 / sqrt(D) * log2(e)
};

// Copies rows [r0, r0 + ROWS) of a matrix with row stride `ld` (elements) into
// a shared tile with row stride `sstride`, as 16-byte cp.async chunks; rows >=
// n_rows and head dims >= D read nothing and are zero-filled.
template <int ROWS, int DP>
__device__ __forceinline__ void load_tile(float* dst, int sstride, const float* src,
                                          int64_t ld, int r0, int n_rows, int D, int tid) {
  constexpr int CHUNKS = DP / 4;
  constexpr int PER_THREAD = ROWS * CHUNKS / NTHREADS;
  static_assert(PER_THREAD * NTHREADS == ROWS * CHUNKS, "tile must split evenly");
#pragma unroll
  for (int it = 0; it < PER_THREAD; ++it) {
    const int c = tid + it * NTHREADS;
    const int r = c / CHUNKS, d = (c % CHUNKS) * 4;
    const int row = r0 + r;
    const float* g = src;
    uint32_t bytes = 0;
    if (row < n_rows && d < D) {
      g = src + (int64_t)row * ld + d;
      bytes = D - d >= 4 ? 16u : (uint32_t)(D - d) * 4u;
    }
    cp_async_16(dst + r * sstride + d, g, bytes);
  }
}

// K/V tiles a row tile walks: up to its diagonal when causal (L == S).
__device__ __forceinline__ int kv_tiles(const Params& p, int t) {
  if (!p.causal) return p.n_kv_tiles;
  const int last_row = min(p.L, (t + 1) * BM) - 1;
  return last_row / BN + 1;
}

template <int DP>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_f32_kernel(const Params p) {
  using Lay = Layout<DP>;
  constexpr int QSTRIDE = Lay::QSTRIDE, KSTRIDE = Lay::KSTRIDE;
  constexpr int NV = DP / 64;          // float4 of O a lane owns in each of its rows
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                                   // [2][BM][QSTRIDE]
  float* ring = Qs + 2 * Lay::Q_FLOATS;               // NSTAGES x {K [BN][KSTRIDE], V [BN][DP]}
  float* Ps = ring + NSTAGES * Lay::STAGE_FLOATS;     // [BM][PSTRIDE]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cg = lane & 15;                           // column group: S columns cg + 16 j
  const int r_base = (tid >> 5) * 8 + (lane >> 4) * 4;  // first of the lane's 4 rows
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.G;

  const int tile_a = blockIdx.x;
  const int mirror = p.n_row_tiles - 1 - tile_a;
  const int tile_b = (p.causal && mirror != tile_a) ? mirror : -1;
  const int n_a = kv_tiles(p, tile_a);
  const int total = n_a + (tile_b >= 0 ? kv_tiles(p, tile_b) : 0);

  const float* qb = p.q + (int64_t)b * p.q_sb + (int64_t)h * p.q_sh;
  const float* kb = p.k + (int64_t)b * p.k_sb + (int64_t)hk * p.k_sh;
  const float* vb = p.v + (int64_t)b * p.v_sb + (int64_t)hk * p.v_sh;
  float* ob = p.o + (int64_t)b * p.o_sb + (int64_t)h * p.o_sh;

  auto load_kv = [&](int step) {
    const int kt = step < n_a ? step : step - n_a;
    float* st = ring + (step % NSTAGES) * Lay::STAGE_FLOATS;
    load_tile<BN, DP>(st, KSTRIDE, kb, p.k_ss, kt * BN, p.S, p.D, tid);
    load_tile<BN, DP>(st + BN * KSTRIDE, DP, vb, p.v_ss, kt * BN, p.S, p.D, tid);
  };

  load_tile<BM, DP>(Qs, QSTRIDE, qb, p.q_sl, tile_a * BM, p.L, p.D, tid);
  if (tile_b >= 0)
    load_tile<BM, DP>(Qs + Lay::Q_FLOATS, QSTRIDE, qb, p.q_sl, tile_b * BM, p.L, p.D, tid);
  load_kv(0);
  cp_async_commit();

  float m[4], l[4], acc[4][4 * NV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * NV; ++e) acc[i][e] = 0.f;
  }

  for (int step = 0; step < total; ++step) {
    cp_async_wait<0>();                // this step's tile (and at step 0 the Q tiles) landed
    __syncthreads();                   // ... for every thread; the previous step is done
    if (step + 1 < total) {
      load_kv(step + 1);               // into the slot the previous step read
      cp_async_commit();
    }
    const bool in_a = step < n_a;
    const int t = in_a ? tile_a : tile_b;
    const int kt = in_a ? step : step - n_a;
    const float* Qt = Qs + (in_a ? 0 : Lay::Q_FLOATS);
    const float* Kt = ring + (step % NSTAGES) * Lay::STAGE_FLOATS;
    const float* Vt = Kt + BN * KSTRIDE;

    // S = Q K^T for the lane's rows r_base + i and columns cg + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qq[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qq[i] = *reinterpret_cast<const float4*>(Qt + (r_base + i) * QSTRIDE + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kk[j] = *reinterpret_cast<const float4*>(Kt + (cg + 16 * j) * KSTRIDE + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qq[i].x, kk[j].x, s[i][j]);
          s[i][j] = fmaf(qq[i].y, kk[j].y, s[i][j]);
          s[i][j] = fmaf(qq[i].z, kk[j].z, s[i][j]);
          s[i][j] = fmaf(qq[i].w, kk[j].w, s[i][j]);
        }
    }

    // online softmax in base 2; masks only where a column can pass S or a row
    const int row0 = t * BM + r_base;
    const int col0 = kt * BN + cg;
    const bool masked = (kt + 1) * BN > p.S || (p.causal && (kt + 1) * BN - 1 > t * BM);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * p.scale_log2;
        if (masked) {
          const int col = col0 + 16 * j;
          if (col >= p.S || (p.causal && col > row0 + i)) x = NEG_INF;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - m_new);
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = exp2f(s[i][j] - m_new);
        rs += pj;
        Ps[(r_base + i) * PSTRIDE + cg + 16 * j] = pj;
      }
      l[i] = l[i] * corr + rs;         // this lane's share of the row sum
#pragma unroll
      for (int e = 0; e < 4 * NV; ++e) acc[i][e] *= corr;
    }
    __syncwarp();                      // P rows are written and read by one warp

    // acc += P V for the lane's head dims 64 n + 4 cg .. + 3
#pragma unroll 2
    for (int j = 0; j < BN; j += 4) {
      float4 pp[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pp[i] = *reinterpret_cast<const float4*>(Ps + (r_base + i) * PSTRIDE + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float4 vv[NV];
#pragma unroll
        for (int n = 0; n < NV; ++n)
          vv[n] = *reinterpret_cast<const float4*>(Vt + (j + jj) * DP + 64 * n + 4 * cg);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pij = jj == 0 ? pp[i].x : jj == 1 ? pp[i].y : jj == 2 ? pp[i].z : pp[i].w;
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            acc[i][4 * n + 0] = fmaf(pij, vv[n].x, acc[i][4 * n + 0]);
            acc[i][4 * n + 1] = fmaf(pij, vv[n].y, acc[i][4 * n + 1]);
            acc[i][4 * n + 2] = fmaf(pij, vv[n].z, acc[i][4 * n + 2]);
            acc[i][4 * n + 3] = fmaf(pij, vv[n].w, acc[i][4 * n + 3]);
          }
        }
      }
    }

    if (step == n_a - 1 || step == total - 1) {
      // the row tile is done: normalise, store, and start the next from scratch
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float lt = l[i];
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) lt += __shfl_xor_sync(0xffffffffu, lt, o);
        const float denom = fmaxf(lt, L_FLOOR);
        const int row = row0 + i;
        if (row < p.L) {
          float* orow = ob + (int64_t)row * p.o_sl;
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            const int d = 64 * n + 4 * cg;
            const float4 val = make_float4(acc[i][4 * n] / denom, acc[i][4 * n + 1] / denom,
                                           acc[i][4 * n + 2] / denom, acc[i][4 * n + 3] / denom);
            if (d + 4 <= p.D) {
              *reinterpret_cast<float4*>(orow + d) = val;
            } else {
              if (d < p.D) orow[d] = val.x;
              if (d + 1 < p.D) orow[d + 1] = val.y;
              if (d + 2 < p.D) orow[d + 2] = val.z;
            }
          }
        }
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int e = 0; e < 4 * NV; ++e) acc[i][e] = 0.f;
      }
    }
  }
}

template <int DP>
int launch(const Params& p, int B, int H, cudaStream_t stream) {
  const int bytes = Layout<DP>::FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = p.causal ? (p.n_row_tiles + 1) / 2 : p.n_row_tiles;
  flash_fwd_f32_kernel<DP><<<dim3(blocks, H, B), NTHREADS, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// fp32 only. Strides are in elements: q (b, h, l), k (b, h, s), v (b, h, s),
// o (b, h, l); the head dim is contiguous, bases and strides 16-byte aligned.
// A causal call needs L == S. Returns cudaGetLastError() of the launch (0 on
// success), -1 on a bad argument.
extern "C" int repro_flash_fwd(
    const void* q, const void* k, const void* v, void* o,
    int B, int H, int Hkv, int L, int S, int D,
    int64_t q_sb, int64_t q_sh, int64_t q_sl,
    int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t o_sb, int64_t o_sh, int64_t o_sl,
    float scale, int causal, void* stream) {
  if (D < 1 || D > 128 || Hkv < 1 || H % Hkv != 0 || L < 1 || S < 1 || (causal && L != S))
    return -1;
  Params p{(const float*)q, (const float*)k, (const float*)v, (float*)o,
           H / Hkv, L, S, D, causal ? 1 : 0, (L + BM - 1) / BM, (S + BN - 1) / BN,
           q_sb, q_sh, q_sl, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_sl,
           scale * LOG2E};
  cudaStream_t cs = (cudaStream_t)stream;
  return D > 64 ? launch<128>(p, B, H, cs) : launch<64>(p, B, H, cs);
}
