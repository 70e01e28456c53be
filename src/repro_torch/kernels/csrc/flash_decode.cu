// Split-KV flash-decode for Hopper (sm_90a), fp32: asynchronous copies into
// an mbarrier-guarded ring, both products as fp32 FMAs laid out so that every
// float read from shared memory feeds all G heads of the group, and the merge
// of the splits in the same launch through distributed shared memory.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (_decode_kernel / flash_decode) for fp32 inputs: one query token per
// sequence against the key/value cache, the G query heads of a KV head
// sharing every K/V row, columns >= cache_len masked, the -1e30 sentinel,
// acc / max(l, 1e-30) at the end, or the merged fp32 (acc, m, l) partials
// with m in natural-log units of the scaled scores. bf16 inputs go to
// flash_decode_sm90.cu, whose ring, split rule and cluster merge this kernel
// shares.
//
// Bound: bytes. Every K and V row in [0, cache_len) is needed once and there
// are 2 * G operations per 4-byte element of it (at the serving shape, B 4,
// Hkv 2, cache_len 520, D 128: 4.3 MB, 1.29 us at 3.35 TB/s; at a 32k cache
// 268 MB, 80 us). The fp32 rate is not the limit (G 8: 13 TFLOP/s at the
// memory rate, a fifth of 67), but shared-memory reads can be, so the loops
// are laid out for them. What the design does:
// - one launch, no scratch: one CTA per (batch, kv-head, split), each split a
//   balanced run of whole 16-row tiles, the split count chosen by the wrapper
//   (num_splits_sm90: 16 splits, 128 CTAs, at the serving shape and at 32k).
//   The splits of one (batch, kv-head) form a thread-block cluster (at most
//   16 CTAs, the non-portable size). Column quad c belongs to CTA c % n:
//   every CTA pushes its partial's quads, and its row max and sum, into the
//   owners' inboxes with stores to distributed shared memory, then one
//   cluster barrier, then each CTA merges its own columns and writes them.
//   A single split skips the cluster altogether.
// - enough bytes in flight: four producer warps copy each K and V tile in
//   16-byte cp.async chunks, a warp to a 512-byte row, into a ring of RING
//   slots with full and empty mbarriers; each producer thread's copies arrive
//   on the tile's full barrier when they land. At the serving shape a split
//   is 2-3 tiles and the ring holds all of them, so every load is in flight
//   at once; at 32k the ring keeps the next four tiles in flight while the
//   consumers work. Rows past cache_len are zero-filled and read nothing;
//   head dims past D are neither copied nor read. 97,360 bytes of shared
//   memory and at most 128 registers a thread, so two CTAs fit an SM: with
//   one an SM, 16-CTA clusters do not all fit the card at once.
// - fp32 FMAs fed from registers: each of the four consumer warps owns four
//   rows of every tile, and a lane owns four head dims (a float4 column) of
//   q and of acc for all G heads. Q K^T: the lane reads each of its rows' K
//   float4 once (a warp reads a 512-byte row, no bank conflict) and does 4 G
//   FMAs with it, G per float; the warp's 4 x 8 partial dots (G 8; 2 x 16 at
//   G 16) are summed across lanes by a shuffle reduce-scatter that leaves one
//   score a lane (31 shuffles for 32 scores, no selects: each lane computes
//   its partials in the order the halvings consume them). The online softmax
//   runs one score a lane, in base 2 with log2(e) folded into the scale, the
//   max and sum of a head over the lanes that hold it by shuffles. P V: the
//   probabilities and the heads' corrections go through 48 floats of shared
//   memory that the warp reads back as broadcasts (the rescale is skipped
//   when no head's max moved); a lane reads each of its rows' V float4 once
//   and does 4 G FMAs with it. No tensor cores: TF32 would not agree with an
//   fp32 reference to 2e-5.
// - the four warps' states merge in shared memory when the CTA's tiles are
//   done, into the CTA's partial, as in flash_decode_sm90.cu.
// What bounds it at 32k: the 8 clusters of 16 do not each get 16 SMs, so some
// SMs hold two CTAs, and those CTAs, with twice the copies and the
// arithmetic on their SM, finish last; the others stream near the memory
// rate (PERF.md).
// Where it departs from src/repro/core/kprog/decode.py (SplitKVDecode): the
// consumers run fp32 FMAs rather than tensor-core products, and the merge is
// inside the cluster rather than in separate reduction CTAs that read the
// partials from device memory.
//
// The caches are addressed through element strides for batch, head and
// sequence (head dim contiguous, D a multiple of 4, the bases 16-byte aligned
// and the strides multiples of 4 elements, which the wrapper checks): one
// layer's (B, S_max, Hkv, D) slice is read in place. q and the output are
// contiguous (B, H, D).
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int TN = 16;                     // cache rows of a tile
constexpr int DP = 128;                    // head dims a tile row holds: four a lane
constexpr int NW = 4;                      // consumer warps, TN / NW rows of each tile each
constexpr int NP = 4;                      // producer warps
constexpr int NTHREADS = (NW + NP) * 32;   // consumer warps 0..3, producer warps 4..7
constexpr int ROWS_W = TN / NW;            // rows of a tile a consumer warp owns
constexpr int RING = 5;                    // tile slots
constexpr int MAX_SPLIT = 16;              // CTAs of a cluster, with the non-portable size
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared memory: RING slots of a K tile then a V tile, TN rows of DP floats;
// the barriers; each consumer warp's probabilities [32] and corrections [16];
// each warp's row max and row sum [NW][16]; the inbox of the cluster merge,
// which the other CTAs of the cluster write: every split's row max
// [MAX_SPLIT][16] and row sum [MAX_SPLIT][16], then its acc over this CTA's
// columns [n_split][16][share]. After the tile loop the ring holds each
// warp's weighted acc [NW][16][DP].
struct Layout {
  static constexpr int TILE = TN * DP * 4;
  static constexpr int SLOT = 2 * TILE;                   // K, then V
  static constexpr int BAR_OFF = RING * SLOT;
  static constexpr int STAGE = BAR_OFF + 2 * RING * 8;
  static constexpr int STAGE_W = 48;                      // floats a warp
  static constexpr int ML_W = STAGE + NW * STAGE_W * 4;
  static constexpr int INBOX = ML_W + 2 * NW * 16 * 4;
  // share = 4 * ceil(DP / 4 / n_split) columns, so n_split * share <= DP + 4 * (MAX_SPLIT - 1)
  static constexpr int INBOX_FLOATS = 2 * MAX_SPLIT * 16 + 16 * (DP + 4 * (MAX_SPLIT - 1));
  static constexpr int ALLOC = INBOX + INBOX_FLOATS * 4;
  static_assert(NW * 16 * DP * 4 <= BAR_OFF, "the warps' acc does not fit in the ring");
  static_assert(STAGE % 16 == 0 && ML_W % 16 == 0 && INBOX % 16 == 0,
                "misaligned shared-memory regions");
  static_assert(ALLOC <= 113 * 1024, "two CTAs an SM need at most 113 KB each");
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* out;              // normalised output, or acc when the partials are asked for
  float* out_m;            // nullptr: normalised output
  float* out_l;
  int64_t k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int G, D, clen, tiles;
  float scale_log2;
};

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

__device__ __forceinline__ void add4(float4& a, float4 x) {
  a.x += x.x;
  a.y += x.y;
  a.z += x.z;
  a.w += x.w;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

// One halving of reduce_scatter: keep the low HALF values and add the
// partner lane's copies of them, sent from its high half.
template <int HALF, int OFF>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[32]) {
#pragma unroll
  for (int i = 0; i < HALF; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i + HALF], OFF);
}

// Sums 32 values over the 32 lanes of a warp and scatters the sums: a lane
// holds value s ^ lane in slot s, so that after the five halvings (16 + 8 + 4
// + 2 + 1 shuffles) slot 0 holds the warp's sum of value `lane`. The order of
// the slots is what lets every lane keep its low half and send its high half,
// with no select; the steps are templates so that every index is a constant
// and v stays in registers.
__device__ __forceinline__ void reduce_scatter(float (&v)[32]) {
  reduce_scatter_step<16, 16>(v);
  reduce_scatter_step<8, 8>(v);
  reduce_scatter_step<4, 4>(v);
  reduce_scatter_step<2, 2>(v);
  reduce_scatter_step<1, 1>(v);
}

// Four output columns of one (batch, head) row: normalised, or the partials
// (with the row's m, in natural-log units, and l at column 0). m is in log2
// units of the scaled scores.
__device__ __forceinline__ void write_quad(const Params& p, int64_t row, int col, float4 a,
                                           float m, float l) {
  float* dst = p.out + row * p.D + col;
  if (p.out_m != nullptr) {
    *reinterpret_cast<float4*>(dst) = a;
    if (col == 0) {
      p.out_m[row] = m * LN2;
      p.out_l[row] = l;
    }
  } else {
    const float lf = fmaxf(l, L_FLOOR);
    *reinterpret_cast<float4*>(dst) = make_float4(a.x / lf, a.y / lf, a.z / lf, a.w / lf);
  }
}

// GP: heads of a group, padded (8 or 16). A step of a consumer warp is
// RS = 32 / GP of its rows, RS x GP scores, one a lane. Up to 8 heads: two
// CTAs an SM (at most 128 registers a thread). With 16 heads q and acc take
// 128 registers of their own, so one CTA an SM.
template <int GP>
__global__ void __launch_bounds__(NTHREADS, GP == 8 ? 2 : 1)
    flash_decode_kernel(const Params p) {
  using Ly = Layout;
  constexpr int RS = 32 / GP;
  static_assert(RS * GP == 32 && ROWS_W % RS == 0, "a step is one score a lane");
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
      mbar_init(&empty[s], NW);
    }
    fence_mbar_init();
  }
  __syncthreads();
  // peers may write this CTA's inbox once every CTA of the cluster has arrived here
  if (n_split > 1) cluster_arrive_relaxed();

  float* m_w = reinterpret_cast<float*>(smem + Ly::ML_W);   // [NW][16] maxima, then sums
  if (warp >= NW) {
    // ---------------- producers: each tile in 16-byte chunks, a warp to a row ---
    constexpr int CH = DP / 4;                            // chunks of a tile row
    constexpr int PER = 2 * TN * CH / (NP * 32);          // chunks a thread copies a tile
    static_assert(PER * NP * 32 == 2 * TN * CH, "the producers split a tile evenly");
    const int pt = threadIdx.x - NW * 32;
    const float* kp = p.k + b * p.k_sb + hk * p.k_sh;
    const float* vp = p.v + b * p.v_sb + hk * p.v_sh;
    const bool copies = pt % CH < D / 4;                  // head dims past D: never copied
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % RING;
      mbar_wait(&empty[s], ((j / RING) & 1) ^ 1);
      const int row0 = (t_begin + j) * TN;
      uint8_t* slot = smem + s * Ly::SLOT;
      if (copies) {
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int idx = pt + i * NP * 32;
          const int kv = idx / (TN * CH), r = (idx / CH) % TN, c = idx % CH;
          // rows past cache_len: read nothing, store zeros
          const bool in = row0 + r < clen;
          const float* src = kv ? vp + (in ? (int64_t)(row0 + r) * p.v_ss + c * 4 : 0)
                                : kp + (in ? (int64_t)(row0 + r) * p.k_ss + c * 4 : 0);
          cp_async_16(slot + kv * Ly::TILE + (r * DP + c * 4) * 4, src, in ? 16u : 0u);
        }
      }
      cp_async_arrive(&full[s]);
    }
  } else {
    // ---------------- consumers: warp w takes rows 4w .. 4w + 3 of every tile ---
    const int col = 4 * lane;                 // this lane's four head dims
    const bool owns = col < D;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    // this lane's score in a step is value `lane`: row lane / GP of the step,
    // head lane % GP. Its partial dots are in the reduce-scatter's order, slot
    // s holding value s ^ lane: row (s / GP) ^ r_l, head (s % GP) ^ g_l. So q
    // is held in that head order (qx[h] is head h ^ g_l), and acc by head.
    const int r_l = lane / GP, g_l = lane % GP;
    float4 qx[GP], acc[GP];
    const float* qb = p.q + ((int64_t)b * H + hk * G) * D;
#pragma unroll
    for (int h = 0; h < GP; ++h) {
      const int g = h ^ g_l;
      qx[h] = (g < G && owns) ? __ldg(reinterpret_cast<const float4*>(qb + g * D + col)) : zero;
      acc[h] = zero;
    }
    // the running max (log2 units) and sum of head g_l, alike in its lanes
    float m_run = NEG_INF, l_run = 0.f;
    float* p_w = reinterpret_cast<float*>(smem + Ly::STAGE) + warp * Ly::STAGE_W;   // [RS][GP]
    float* c_w = p_w + 32;                                                            // [GP]

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % RING;
      mbar_wait(&full[s], (j / RING) & 1);
      const float* k_t = reinterpret_cast<const float*>(smem + s * Ly::SLOT) + warp * ROWS_W * DP;
      const float* v_t = k_t + Ly::TILE / 4;
      const int row0 = (t_begin + j) * TN + warp * ROWS_W;
#pragma unroll
      for (int st = 0; st < ROWS_W / RS; ++st) {
        // Q K^T: partial dots over this lane's head dims, RS rows x GP heads,
        // in slot order
        float part[32];
#pragma unroll
        for (int r = 0; r < RS; ++r) {
          const int row = st * RS + (r ^ r_l);
          const float4 kk = owns ? *reinterpret_cast<const float4*>(k_t + row * DP + col) : zero;
#pragma unroll
          for (int h = 0; h < GP; ++h) part[r * GP + h] = dot4(qx[h], kk);
        }
        reduce_scatter(part);                 // part[0]: score (r_l, g_l)

        // online softmax, one score a lane; a head's lanes are lane % GP + GP k
        const bool valid = row0 + st * RS + r_l < clen;
        const float x = part[0] * p.scale_log2;
        float mx = valid ? x : NEG_INF;
#pragma unroll
        for (int off = GP; off < 32; off *= 2)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        mx = fmaxf(mx, m_run);
        const float corr = exp2f(m_run - mx);
        const float pr = valid ? exp2f(x - mx) : 0.f;
        float ps = pr;
#pragma unroll
        for (int off = GP; off < 32; off *= 2) ps += __shfl_xor_sync(0xffffffffu, ps, off);
        l_run = l_run * corr + ps;
        m_run = mx;
        p_w[lane] = pr;
        if (lane < GP) c_w[lane] = corr;
        __syncwarp();

        // P V: rescale (unless no head's max moved), then add the step's rows;
        // P and the corrections are broadcasts
        if (__any_sync(0xffffffffu, corr != 1.f))
#pragma unroll
        for (int g4 = 0; g4 < GP / 4; ++g4) {
          const float4 c = reinterpret_cast<const float4*>(c_w)[g4];
          acc[4 * g4] = scale4(acc[4 * g4], c.x);
          acc[4 * g4 + 1] = scale4(acc[4 * g4 + 1], c.y);
          acc[4 * g4 + 2] = scale4(acc[4 * g4 + 2], c.z);
          acc[4 * g4 + 3] = scale4(acc[4 * g4 + 3], c.w);
        }
#pragma unroll
        for (int r = 0; r < RS; ++r) {
          const float4 vv = owns ? *reinterpret_cast<const float4*>(v_t + (st * RS + r) * DP + col)
                                 : zero;
#pragma unroll
          for (int g4 = 0; g4 < GP / 4; ++g4) {
            const float4 pp = reinterpret_cast<const float4*>(p_w + r * GP)[g4];
            const float pg[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float4& a = acc[4 * g4 + e];
              a.x = fmaf(pg[e], vv.x, a.x);
              a.y = fmaf(pg[e], vv.y, a.y);
              a.z = fmaf(pg[e], vv.z, a.z);
              a.w = fmaf(pg[e], vv.w, a.w);
            }
          }
        }
        __syncwarp();                          // p_w and c_w are rewritten by the next step
      }
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // a lane below GP holds head `lane`'s state
    if (lane < GP) m_w[warp * 16 + lane] = m_run;
    // every tile of the CTA has been consumed, so no copy is pending: the ring
    // is free once all consumers are here
    named_bar_sync(1, NW * 32);
    // this warp's weighted acc, [head][DP], and weighted sums; its weight in a
    // head against the CTA's max (a warp that saw no valid row holds m = -1e30,
    // l = 0, acc = 0 and weighs 0)
    float* acc_w = reinterpret_cast<float*>(smem) + warp * 16 * DP;
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      float mm = NEG_INF;
#pragma unroll
      for (int w = 0; w < NW; ++w) mm = fmaxf(mm, m_w[w * 16 + g]);
      const float wgt = exp2f(m_w[warp * 16 + g] - mm);
      if (owns) *reinterpret_cast<float4*>(acc_w + g * DP + col) = scale4(acc[g], wgt);
      if (lane == g) m_w[NW * 16 + warp * 16 + g] = l_run * wgt;
    }
  }
  __syncthreads();

  // ---------------- the CTA's partial: the sum of the warps' weighted states ----
  const float* l_w = m_w + NW * 16;                                       // [NW][16], weighted
  const float* acc_w = reinterpret_cast<const float*>(smem);              // [NW][16][DP]
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
      add4(a, *reinterpret_cast<const float4*>(&acc_w[(w * 16 + r) * DP + 4 * d4]));
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
      const float w = exp2f(in_m[s * 16 + r] - mm);
      ll += in_l[s * 16 + r] * w;
      add4(a, scale4(*reinterpret_cast<const float4*>(&in_acc[(s * 16 + r) * share + 4 * k]), w));
    }
    write_quad(p, obase + r, 4 * (rank + k * n_split), a, mm, ll);
  }
  // Nothing of this CTA's shared memory is read by its peers, and every write
  // into it landed before the barrier: it may leave without waiting.
}

template <int GP>
int launch(const Params& p, int B, int Hkv, int n_split, cudaStream_t stream) {
  constexpr int bytes = Layout::ALLOC;
  static uint64_t attr_set = 0;          // devices whose attributes are set (once each)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !(attr_set >> dev & 1)) {
    err = cudaFuncSetAttribute(flash_decode_kernel<GP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_decode_kernel<GP>,
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
  err = cudaLaunchKernelEx(&cfg, flash_decode_kernel<GP>, p);
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

// fp32 only. q (B, H, D) contiguous; caches addressed by element strides, head
// dim contiguous, D a multiple of 4 and at most 128, at most 16 heads a KV
// head, the bases 16-byte aligned and every stride a multiple of 4 elements
// (a dim of extent 1 aside), as the 16-byte copies need. With out_m == 0,
// `out` (B, H, D, contiguous) receives the normalised result; otherwise `out`
// (B, H, D), out_m and out_l (B, H) receive the merged partials. clen must
// already be clamped to [1, S]; 1 <= n_split <= min(16, ceil(clen / 16)).
// Returns cudaGetLastError() of the launch (0 on success), -1 on a bad
// argument.
extern "C" int repro_flash_decode(const DecodeArgs* a) {
  if (a == nullptr) return -1;
  const int64_t B = a->B, H = a->H, Hkv = a->Hkv, D = a->D, clen = a->clen;
  const int64_t n_split = a->n_split;
  if (D < 4 || D > DP || D % 4 != 0 || B < 1 || Hkv < 1 || H % Hkv != 0 || H / Hkv > 16 ||
      clen < 1 || clen >= ((int64_t)1 << 31) || n_split < 1 || n_split > MAX_SPLIT)
    return -1;
  const int64_t tiles = (clen + TN - 1) / TN;
  if (n_split > tiles) return -1;                             // an empty split
  auto bad = [](int64_t stride, int64_t extent) { return extent > 1 && (stride * 4) % 16 != 0; };
  if ((a->q | a->k | a->v | a->out) % 16 != 0 || bad(a->k_sb, B) || bad(a->k_sh, Hkv) ||
      bad(a->k_ss, clen) || bad(a->v_sb, B) || bad(a->v_sh, Hkv) || bad(a->v_ss, clen))
    return -1;
  Params p;
  p.q = reinterpret_cast<const float*>(a->q);
  p.k = reinterpret_cast<const float*>(a->k);
  p.v = reinterpret_cast<const float*>(a->v);
  p.out = reinterpret_cast<float*>(a->out);
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
  return p.G > 8 ? launch<16>(p, (int)B, (int)Hkv, (int)n_split, cs)
                 : launch<8>(p, (int)B, (int)Hkv, (int)n_split, cs);
}
