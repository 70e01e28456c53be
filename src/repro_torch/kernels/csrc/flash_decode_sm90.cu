// Split-KV flash-decode for Hopper (sm_90a), bf16: asynchronous copies into
// an mbarrier-guarded ring, both products on the tensor cores (mma.sync), and
// the merge of the splits in the same launch through distributed shared
// memory.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (_decode_kernel / flash_decode) for bf16 inputs: one query token per
// sequence against the key/value cache, the G query heads of a KV head
// sharing every K/V row, columns >= cache_len masked, the -1e30 sentinel,
// acc / max(l, 1e-30) at the end, or the merged fp32 (acc, m, l) partials.
// Its shape is the one the simulator models in src/repro/core/kprog/decode.py
// (SplitKVDecode): split CTAs in which a producer streams K/V tiles to
// consumers that run the G grouped heads as the rows of their products, then
// a log-sum-exp merge of the fp32 partials.
//
// Bound: bytes. Every K and V row in [0, cache_len) is needed once and there
// are only 2 * G operations per byte of it (at the serving shape, B 4, Hkv 2,
// cache_len 520, D 128: 2.1 MB, 0.64 us at 3.35 TB/s). What the design does:
// - enough in flight: one CTA per (batch, kv-head, split), each split a
//   balanced run of whole 16-row tiles; the wrapper picks the split count so
//   that B * Hkv * splits nears the 132 SMs (128 CTAs at the serving shape).
//   Four producer warps copy each tile in 16-byte cp.async chunks, through
//   the load/store units, into a ring of RING tile slots with full and empty
//   mbarriers; each producer thread's copies arrive on the tile's full barrier
//   when they land. At the serving shape the ring holds the whole split, so
//   every load is in flight at once. (TMA, with tensor maps or one bulk copy
//   per row, fed a CTA a few times slower at these 16-row tiles, and fewer
//   producer threads keep fewer copies in flight.)
// - only [0, cache_len) is read: the copies of rows past it, and of columns
//   past D, read nothing and zero-fill, and only the ragged last tile is
//   masked. Nothing is encoded on the host per call.
// - products on the tensor cores, transposed: S^T = K Q^T and O^T = V^T P^T
//   are mma.sync.m16n8k16 with the tile's 16 cache rows (or 16 head-dim rows)
//   as the MMA rows and the G <= 16 query heads as one or two 8-column blocks,
//   so no MMA row is padding. K and V^T come in through ldmatrix and
//   ldmatrix.trans (tile rows padded by 16 bytes, so that an ldmatrix's eight
//   rows fall on distinct banks), Q^T sits in registers, and movmatrix turns
//   the S^T accumulators into P^T's B operand. P keeps fp32 precision as in
//   the TPU kernel: it is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi),
//   and the product is V^T P_hi^T + V^T P_lo^T (16 significant bits of P).
//   The softmax is fp32 in registers with exp2 and log2(e) folded into the
//   score scale.
// - one launch: four consumer warps take the CTA's tiles in turn, each with
//   its own running (m, l, acc), and merge in shared memory into the CTA's
//   partial. The splits of one (batch, kv-head) form a thread-block cluster
//   (at most 16 CTAs, the non-portable size). Column quad c belongs to CTA
//   c % n: every CTA pushes its partial's quads, and its row max and sum, into
//   the owners' inboxes with stores to distributed shared memory, then one
//   cluster barrier, then each CTA merges its own columns from its inbox and
//   writes them. Partials never go to device memory, nothing is read
//   remotely, and a single split skips the cluster altogether. decode.py
//   models separate reduction CTAs that read the partials from device memory.
//
// The caches are addressed through element strides for batch, head and
// sequence (head dim contiguous): one layer's (B, S_max, Hkv, D) slice is read
// in place. q and the output are contiguous (B, H, D).
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int TN = 16;                     // cache rows of a tile = the k of one P V step
constexpr int NW = 4;                      // consumer warps
constexpr int NP = 4;                      // producer warps
constexpr int NTHREADS = (NW + NP) * 32;   // consumer warps 0..3, producer warps 4..7
constexpr int RING = 8;                    // tile slots; consumer warp w owns slots w, w + NW
constexpr int MAX_SPLIT = 16;              // CTAs of a cluster, with the non-portable size
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared memory: RING slots of a K tile then a V tile, TN rows each, a row
// being DP bf16 values and 16 bytes of padding (so that the eight rows of an
// ldmatrix fall on distinct banks); the barriers; each warp's row max and row
// sum; the inbox of the cluster merge, which the other CTAs of the cluster
// write: every split's row max [MAX_SPLIT][16] and row sum [MAX_SPLIT][16],
// then its acc over this CTA's columns [n_split][16][share]. After the tile
// loop the ring holds each warp's weighted acc [NW][16][APITCH].
template <int DP>
struct Layout {
  static constexpr int ROW = DP * 2 + 16;
  static constexpr int TILE = TN * ROW;
  static constexpr int SLOT = 2 * TILE;                   // K, then V
  static constexpr int BAR_OFF = RING * SLOT;
  static constexpr int ML_W = BAR_OFF + 2 * RING * 8;
  static constexpr int INBOX = ML_W + 2 * NW * 16 * 4;
  // share = 4 * ceil(DP / 4 / n_split) columns, so n_split * share <= DP + 4 * (MAX_SPLIT - 1)
  static constexpr int INBOX_FLOATS = 2 * MAX_SPLIT * 16 + 16 * (DP + 4 * (MAX_SPLIT - 1));
  static constexpr int ALLOC = INBOX + INBOX_FLOATS * 4;
  static constexpr int APITCH = DP + 8;                   // padded; rows stay 16-byte aligned
  static_assert(NW * 16 * APITCH * 4 <= BAR_OFF, "the warps' acc does not fit in the ring");
  static_assert(ML_W % 16 == 0 && INBOX % 16 == 0, "misaligned shared-memory regions");
};

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;      // normalised output, or nullptr when the partials are asked for
  float* out_acc;
  float* out_m;
  float* out_l;
  int64_t k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int G, D, clen, tiles;
  float scale_log2;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// D (16 x 8, fp32) += A (16 x 16, bf16, row-major) B (16 x 8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Transposes an 8 x 8 matrix of 16-bit values held one pair a thread (row
// lane / 4, columns 2 (lane % 4), + 1), in place of the fragment.
__device__ __forceinline__ uint32_t transpose_8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ void add4(float4& a, float4 x) {
  a.x += x.x;
  a.y += x.y;
  a.z += x.z;
  a.w += x.w;
}

// Four output columns of one (batch, head) row: normalised to bf16, or the
// fp32 partials (with the row's m, in natural-log units, and l at column 0).
// m is in log2 units of the scaled scores.
__device__ __forceinline__ void write_quad(const Params& p, int64_t row, int col, float4 a,
                                           float m, float l) {
  const int64_t off = row * p.D + col;
  if (p.out == nullptr) {
    *reinterpret_cast<float4*>(p.out_acc + off) = a;
    if (col == 0) {
      p.out_m[row] = m * LN2;
      p.out_l[row] = l;
    }
  } else {
    const float inv = 1.f / fmaxf(l, L_FLOOR);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(a.x * inv, a.y * inv);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(a.z * inv, a.w * inv);
    *reinterpret_cast<uint2*>(p.out + off) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
  }
}

// Up to 8 heads a KV head (NB = 1): two CTAs an SM (at most 128 registers a
// thread), so that a 16-CTA cluster fits the SMs of one GPC however they are
// split. With 16 heads the second block of accumulators needs more registers
// than that leaves, so one CTA an SM.
template <int DP, int NB>
__global__ void __launch_bounds__(NTHREADS, NB == 1 ? 2 : 1)
    flash_decode_sm90_kernel(const Params p) {
  using Ly = Layout<DP>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Ly::BAR_OFF);
  uint64_t* empty = full + RING;

  const int split = blockIdx.x, n_split = gridDim.x;
  const int hk = blockIdx.y, Hkv = gridDim.y;
  const int b = blockIdx.z;
  const int G = p.G, D = p.D, clen = p.clen;
  const int H = Hkv * G;
  // balanced runs of whole tiles; none is empty, since n_split <= tiles
  const int t_begin = (int)((int64_t)split * p.tiles / n_split);
  const int n_tiles = (int)((int64_t)(split + 1) * p.tiles / n_split) - t_begin;

  // the role is uniform across each warp; the shuffle tells the compiler so
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < RING; ++s) {
      mbar_init(&full[s], NP * 32);
      mbar_init(&empty[s], 1);
    }
    fence_mbar_init();
  }
  __syncthreads();
  // peers may write this CTA's inbox once every CTA of the cluster has arrived here
  if (n_split > 1) cluster_arrive_relaxed();

  if (warp >= NW) {
    // ---------------- producers: each tile in 16-byte chunks, coalesced rows ---
    constexpr int CH = DP / 8;                            // chunks of a tile row
    constexpr int PER = 2 * TN * CH / (NP * 32);          // chunks a thread copies a tile
    static_assert(PER * NP * 32 == 2 * TN * CH, "the producers split a tile evenly");
    const int pt = threadIdx.x - NW * 32;
    const __nv_bfloat16* kp = p.k + b * p.k_sb + hk * p.k_sh;
    const __nv_bfloat16* vp = p.v + b * p.v_sb + hk * p.v_sh;
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % RING;
      mbar_wait(&empty[s], ((j / RING) & 1) ^ 1);
      const int row0 = (t_begin + j) * TN;
      uint8_t* slot = smem + s * Ly::SLOT;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int idx = pt + i * NP * 32;
        const int kv = idx / (TN * CH), r = (idx / CH) % TN, c = idx % CH;
        // rows past cache_len and columns past D: read nothing, store zeros
        const bool in = row0 + r < clen && c * 8 < D;
        const __nv_bfloat16* src = kv ? vp + (in ? (int64_t)(row0 + r) * p.v_ss + c * 8 : 0)
                                      : kp + (in ? (int64_t)(row0 + r) * p.k_ss + c * 8 : 0);
        cp_async_16(slot + kv * Ly::TILE + r * Ly::ROW + c * 16, src, in ? 16u : 0u);
      }
      cp_async_arrive(&full[s]);
    }
  } else {
    // ---------------- consumers: warp w takes tiles w, w + NW, ... -----------
    // The products run transposed, S^T = K Q^T and O^T = V^T P^T, so that the
    // 16 cache rows of a tile fill the MMA's rows and the heads its 8 columns
    // (NB blocks of 8 heads): thread (g, t) holds rows g and g + 8 (cache rows
    // of S^T, head-dim rows of O^T) of heads 8 nb + 2t and 8 nb + 2t + 1.
    const int g = lane / 4, t = lane % 4;
    // Q^T as the B operand of each k-step: head 8 nb + g, dims 16 kk + 2t (+1), + 8 r
    uint32_t qf[NB][DP / 16][2];
    const __nv_bfloat16* qb = p.q + ((int64_t)b * H + hk * G) * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int head = 8 * nb + g, col = 16 * kk + 2 * t + 8 * r;
          qf[nb][kk][r] = (head < G && col < D)
                              ? __ldg(reinterpret_cast<const unsigned int*>(qb + head * D + col))
                              : 0u;
        }

    float o[NB][DP / 16][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int mb = 0; mb < DP / 16; ++mb)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nb][mb][e] = 0.f;
    float m_run[NB][2], l_run[NB][2];       // heads 8 nb + 2t, + 1: running max (log2 units), sum
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m_run[nb][h] = NEG_INF;
        l_run[nb][h] = 0.f;
      }

    // ldmatrix row addresses of this lane: K as the A operand, V^T as the A
    // operand (V read transposed)
    const int k_row = lane % 8 + 8 * ((lane / 8) % 2), k_col = 8 * (lane / 16);
    const int v_row = lane % 8 + 8 * (lane / 16), v_col = 8 * ((lane / 8) % 2);

    for (int j = warp; j < n_tiles; j += NW) {
      const int s = j % RING;
      mbar_wait(&full[s], (j / RING) & 1);
      const uint32_t k_base = smem_u32(smem + s * Ly::SLOT);
      const uint32_t v_base = k_base + Ly::TILE;

      // S^T (16 cache rows x 8 heads per block) = K Q^T
      float sc[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t kf[4];
        ldsm_x4(kf, k_base + k_row * Ly::ROW + (kk * 16 + k_col) * 2);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) mma_bf16(sc[nb], kf, qf[nb][kk][0], qf[nb][kk][1]);
      }

      // online softmax per head (a column of S^T) in log2 units; only the
      // ragged last tile is masked; P^T = P_hi + P_lo as the B operand of O^T
      const int row0 = (t_begin + j) * TN;
      const bool edge = row0 + TN > clen;
      uint32_t ph[NB][2], pl[NB][2];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        float mx[2] = {m_run[nb][0], m_run[nb][1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[nb][e] * p.scale_log2;
          if (edge && row0 + g + 8 * (e / 2) >= clen) x = NEG_INF;
          sc[nb][e] = x;
          mx[e % 2] = fmaxf(mx[e % 2], x);
        }
        float corr[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int off = 4; off < 32; off *= 2)
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], off));
          // the tile holds a valid row, so mx is a real score: exp2 of the
          // sentinel minus it is exactly 0
          corr[h] = fast_exp2(m_run[nb][h] - mx[h]);
          m_run[nb][h] = mx[h];
          l_run[nb][h] *= corr[h];
        }
        float e[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          e[k] = fast_exp2(sc[nb][k] - mx[k % 2]);
          l_run[nb][k % 2] += e[k];
        }
        // rows g (e0, e1) and g + 8 (e2, e3) of S^T's two 8 x 8 blocks; the
        // transposes give rows 2t, 2t + 1 (+ 8) of head g, P^T's B layout
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const __nv_bfloat162 hi = __floats2bfloat162_rn(e[2 * half], e[2 * half + 1]);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(e[2 * half] - __low2float(hi),
                                                          e[2 * half + 1] - __high2float(hi));
          ph[nb][half] = transpose_8x8(*reinterpret_cast<const uint32_t*>(&hi));
          pl[nb][half] = transpose_8x8(*reinterpret_cast<const uint32_t*>(&lo));
        }
#pragma unroll
        for (int mb = 0; mb < DP / 16; ++mb) {
          o[nb][mb][0] *= corr[0];
          o[nb][mb][1] *= corr[1];
          o[nb][mb][2] *= corr[0];
          o[nb][mb][3] *= corr[1];
        }
      }
      // O^T (DP head-dim rows x 8 heads per block) += V^T P^T
#pragma unroll
      for (int mb = 0; mb < DP / 16; ++mb) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, v_base + v_row * Ly::ROW + (mb * 16 + v_col) * 2);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          mma_bf16(o[nb][mb], vf, ph[nb][0], ph[nb][1]);
          mma_bf16(o[nb][mb], vf, pl[nb][0], pl[nb][1]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int off = 4; off < 32; off *= 2)
          l_run[nb][h] += __shfl_xor_sync(0xffffffffu, l_run[nb][h], off);
    float* m_w = reinterpret_cast<float*>(smem + Ly::ML_W);
    if (g == 0) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        m_w[warp * 16 + 8 * nb + 2 * t] = m_run[nb][0];
        m_w[warp * 16 + 8 * nb + 2 * t + 1] = m_run[nb][1];
      }
    }
    // every tile of the CTA has been consumed, so no copy is pending: the ring
    // is free once all consumers are here
    named_bar_sync(1, NW * 32);
    // this warp's weight in its heads against the CTA's max (a warp that had
    // no tile holds m = -1e30, l = 0, acc = 0 and weighs 0)
    float wgt[NB][2];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mm = NEG_INF;
#pragma unroll
        for (int w = 0; w < NW; ++w) mm = fmaxf(mm, m_w[w * 16 + 8 * nb + 2 * t + h]);
        wgt[nb][h] = fast_exp2(m_run[nb][h] - mm);
      }
    // this warp's weighted acc, [head][APITCH]
    float* acc_w = reinterpret_cast<float*>(smem) + warp * 16 * Ly::APITCH;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int mb = 0; mb < DP / 16; ++mb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc_w[(8 * nb + 2 * t + e % 2) * Ly::APITCH + 16 * mb + g + 8 * (e / 2)] =
              o[nb][mb][e] * wgt[nb][e % 2];
    if (g == 0) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        m_w[NW * 16 + warp * 16 + 8 * nb + 2 * t] = l_run[nb][0] * wgt[nb][0];
        m_w[NW * 16 + warp * 16 + 8 * nb + 2 * t + 1] = l_run[nb][1] * wgt[nb][1];
      }
    }
  }
  __syncthreads();

  // ---------------- the CTA's partial: the sum of the warps' weighted states ----
  const float* m_w = reinterpret_cast<const float*>(smem + Ly::ML_W);    // [NW][16]
  const float* l_w = m_w + NW * 16;                                       // [NW][16], weighted
  const float* acc_w = reinterpret_cast<const float*>(smem);              // [NW][16][APITCH]
  const int64_t obase = (int64_t)b * H + hk * G;          // (b, first head of the group)
  const int quads = D / 4;
  const int share = 4 * ((quads + n_split - 1) / n_split);
  const int rank = n_split > 1 ? (int)cluster_ctarank() : 0;
  float* in_m = reinterpret_cast<float*>(smem + Ly::INBOX);     // [MAX_SPLIT][16]
  float* in_l = in_m + MAX_SPLIT * 16;                          // [MAX_SPLIT][16]
  float* in_acc = in_l + MAX_SPLIT * 16;                        // [n_split][16][share]
  if (n_split > 1) cluster_wait();          // every CTA of the cluster runs: inboxes may be written
  for (int idx = threadIdx.x; idx < G * quads; idx += NTHREADS) {
    const int r = idx / quads, d4 = idx % quads;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < NW; ++w)
      add4(a, *reinterpret_cast<const float4*>(&acc_w[(w * 16 + r) * Ly::APITCH + 4 * d4]));
    if (n_split == 1) {
      float mm = NEG_INF, ll = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        mm = fmaxf(mm, m_w[w * 16 + r]);
        ll += l_w[w * 16 + r];
      }
      write_quad(p, obase + r, 4 * d4, a, mm, ll);
    } else {
      // quad d4 belongs to CTA d4 % n_split, as its (d4 / n_split)-th
      const uint32_t dst = smem_u32(&in_acc[(rank * 16 + r) * share + 4 * (d4 / n_split)]);
      st_cluster_f32x4(map_to_rank(dst, d4 % n_split), a);
    }
  }
  if (n_split == 1) return;
  for (int idx = threadIdx.x; idx < G * n_split; idx += NTHREADS) {
    const int r = idx % G, to = idx / G;    // row r's max and sum, to every CTA of the cluster
    float mm = NEG_INF, ll = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      mm = fmaxf(mm, m_w[w * 16 + r]);
      ll += l_w[w * 16 + r];
    }
    st_cluster_f32(map_to_rank(smem_u32(&in_m[rank * 16 + r]), to), mm);
    st_cluster_f32(map_to_rank(smem_u32(&in_l[rank * 16 + r]), to), ll);
  }
  cluster_arrive();                         // this CTA's pushes are released ...
  cluster_wait();                           // ... and every peer's have landed here

  // ---------------- merge of this CTA's columns: quads rank, rank + n_split, ... -
  const int nq = (quads - rank + n_split - 1) / n_split;
  for (int idx = threadIdx.x; idx < G * nq; idx += NTHREADS) {
    const int r = idx / nq, k = idx % nq;
    float mm = NEG_INF;
    for (int s = 0; s < n_split; ++s) mm = fmaxf(mm, in_m[s * 16 + r]);
    float ll = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < n_split; ++s) {
      const float w = fast_exp2(in_m[s * 16 + r] - mm);
      ll += in_l[s * 16 + r] * w;
      const float4 x = *reinterpret_cast<const float4*>(&in_acc[(s * 16 + r) * share + 4 * k]);
      a.x += x.x * w;
      a.y += x.y * w;
      a.z += x.z * w;
      a.w += x.w * w;
    }
    write_quad(p, obase + r, 4 * (rank + k * n_split), a, mm, ll);
  }
  // Nothing of this CTA's shared memory is read by its peers, and every write
  // into it landed before the barrier: it may leave without waiting.
}

template <int DP, int NB>
int launch(const Params& p, int B, int Hkv, int n_split, cudaStream_t stream) {
  constexpr int bytes = Layout<DP>::ALLOC;
  static uint64_t attr_set = 0;          // devices whose attributes are set (once each)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !(attr_set >> dev & 1)) {
    err = cudaFuncSetAttribute(flash_decode_sm90_kernel<DP, NB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_decode_sm90_kernel<DP, NB>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) attr_set |= (uint64_t)1 << dev;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;    // the splits of one (batch, kv-head)
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, Hkv, B);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_decode_sm90_kernel<DP, NB>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// One call's arguments, packed by the wrapper as 19 little-endian int64s
// (kernels/flash_decode.py: _ARGS), so that the call has one argument.
struct DecodeArgs {
  int64_t q, k, v, out, out_m, out_l, stream;   // addresses; out_m = 0: normalised output
  int64_t B, H, Hkv, D, clen, n_split;
  int64_t k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;   // element strides (batch, kv-head, position)
};
static_assert(sizeof(DecodeArgs) == 19 * 8, "DecodeArgs is 19 int64s");

// bf16 only. q (B, H, D) contiguous; caches addressed by element strides, head
// dim contiguous, D a multiple of 8, the bases 16-byte aligned and every
// stride a multiple of 8 elements (a dim of extent 1 aside), as the 16-byte
// copies need. With out_m == 0, `out` (B, H, D, contiguous, bf16)
// receives the normalised result; otherwise `out` (B, H, D), out_m and out_l
// (B, H), all fp32, receive the merged partials. clen must already be clamped
// to [1, S]; 1 <= n_split <= min(16, ceil(clen / 16)). Returns
// cudaGetLastError() of the launch (0 on success), -1 on a bad argument.
extern "C" int repro_flash_decode_sm90(const DecodeArgs* a) {
  if (a == nullptr) return -1;
  const int64_t B = a->B, H = a->H, Hkv = a->Hkv, D = a->D, clen = a->clen;
  const int64_t n_split = a->n_split;
  if (D < 8 || D > 128 || D % 8 != 0 || B < 1 || Hkv < 1 || H % Hkv != 0 || H / Hkv > 16 ||
      clen < 1 || clen >= ((int64_t)1 << 31) || n_split < 1 || n_split > MAX_SPLIT)
    return -1;
  const int64_t tiles = (clen + TN - 1) / TN;
  if (n_split > tiles) return -1;                             // an empty split
  auto bad = [](int64_t stride, int64_t extent) { return extent > 1 && (stride * 2) % 16 != 0; };
  if ((a->q | a->k | a->v | a->out) % 16 != 0 || bad(a->k_sb, B) || bad(a->k_sh, Hkv) ||
      bad(a->k_ss, clen) || bad(a->v_sb, B) || bad(a->v_sh, Hkv) || bad(a->v_ss, clen))
    return -1;
  Params p;
  p.q = reinterpret_cast<const __nv_bfloat16*>(a->q);
  p.k = reinterpret_cast<const __nv_bfloat16*>(a->k);
  p.v = reinterpret_cast<const __nv_bfloat16*>(a->v);
  const bool partials = a->out_m != 0;
  p.out = partials ? nullptr : reinterpret_cast<__nv_bfloat16*>(a->out);
  p.out_acc = partials ? reinterpret_cast<float*>(a->out) : nullptr;
  p.out_m = reinterpret_cast<float*>(a->out_m);
  p.out_l = reinterpret_cast<float*>(a->out_l);
  p.k_sb = a->k_sb;
  p.k_sh = a->k_sh;
  p.k_ss = a->k_ss;
  p.v_sb = a->v_sb;
  p.v_sh = a->v_sh;
  p.v_ss = a->v_ss;
  p.G = (int)(H / Hkv);
  p.D = (int)D;
  p.clen = (int)clen;
  p.tiles = (int)tiles;
  p.scale_log2 = LOG2E / sqrtf((float)D);
  cudaStream_t cs = reinterpret_cast<cudaStream_t>(a->stream);
  const bool wide = p.G > 8;               // two blocks of 8 heads
  if (D > 64)
    return wide ? launch<128, 2>(p, (int)B, (int)Hkv, (int)n_split, cs)
                : launch<128, 1>(p, (int)B, (int)Hkv, (int)n_split, cs);
  return wide ? launch<64, 2>(p, (int)B, (int)Hkv, (int)n_split, cs)
              : launch<64, 1>(p, (int)B, (int)Hkv, (int)n_split, cs);
}
