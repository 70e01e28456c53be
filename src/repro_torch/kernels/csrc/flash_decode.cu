// Split-KV flash-decode for Hopper (sm_90a), fp32 arithmetic throughout.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (_decode_kernel / flash_decode): one query token per sequence against the
// key/value cache, the G query heads of a KV head sharing every K/V row,
// columns >= cache_len masked, unnormalised fp32 (acc, m, l) emitted.
//
// Bound: bytes. Every K and V row in [0, cache_len) is needed exactly once and
// there are only 2*G FLOP per byte of it, so the least time is the cache slice
// over the memory rate. The TPU kernel walked the cache sequentially per
// (batch, kv-head); B*Hkv blocks (8 when serving) would leave most of the 132
// SMs without a memory request in flight, so the KV axis is split:
//
//   (a) decode_split_kernel: one block of 128 threads per (batch, kv-head,
//       split) walks its share of [0, cache_len) in tiles of 128 rows; rows
//       beyond cache_len are never read. Per tile: (1) thread t owns K row t and
//       computes its score against all G query rows (q staged in shared memory
//       as fp32, the K row read once with 16-byte loads), so each exp of the
//       softmax is computed once, not once per lane; (2) the block reduces the
//       tile's max and sum per query row and updates the running (m, l); (3)
//       thread t owns head dim t of the output for all G rows and adds
//       P[g][j] * V[j][t] over the tile's rows, V read coalesced.
//   (b) decode_merge_kernel: one block per (batch, head) merges the splits
//       with the log-sum-exp combine (m = max m_i, l = sum l_i e^{m_i - m},
//       acc = sum acc_i e^{m_i - m}) and writes either acc / max(l, 1e-30) in
//       the query's type or the merged unnormalised partials.
//
// Caches are addressed through element strides for batch, head and sequence
// (head dim contiguous): one layer's (B, S_max, Hkv, D) slice is read in place.
#include "common.cuh"

namespace {

constexpr int TN = 128;                // K/V rows of a tile = threads of a split block
constexpr int NW = TN / 32;
constexpr int DMAX = 128;              // largest head dim
constexpr int MAX_SPLIT = 64;

template <typename T> struct Chunk;    // elements of a 16-byte load
template <> struct Chunk<float> { static constexpr int N = 4; };
template <> struct Chunk<__nv_bfloat16> { static constexpr int N = 8; };

// N elements starting at p as fp32; the first n_valid are read, the rest are 0.
// `vec` (uniform over the launch) says that p is 16-byte aligned and n_valid == N.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* p, float (&out)[Chunk<T>::N],
                                           bool vec, int n_valid) {
  constexpr int N = Chunk<T>::N;
  if (vec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = i < n_valid ? to_float(p[i]) : 0.f;
  }
}

template <typename T, int GP>
__global__ void __launch_bounds__(TN)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ part_acc,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    int G, int D, int clen, int chunk, int vec,
                    int64_t q_sb, int64_t q_sh,
                    int64_t k_sb, int64_t k_sh, int64_t k_ss,
                    int64_t v_sb, int64_t v_sh, int64_t v_ss, float scale) {
  constexpr int N = Chunk<T>::N;
  __shared__ __align__(16) float q_s[GP][DMAX];   // query rows, zero beyond G and D
  __shared__ __align__(16) float p_s[GP][TN];     // the tile's probabilities
  __shared__ float red_max[NW][GP];
  __shared__ float red_sum[NW][GP];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int hk = blockIdx.y, Hkv = gridDim.y;
  const int b = blockIdx.z;

  for (int idx = tid; idx < GP * DMAX; idx += TN) {
    const int g = idx / DMAX, d = idx % DMAX;
    q_s[g][d] = (g < G && d < D)
        ? to_float(q[(int64_t)b * q_sb + (int64_t)(hk * G + g) * q_sh + d]) : 0.f;
  }

  // running state: m and l are kept alike in every thread, acc[g] is the
  // thread's head dim (tid) of query row g
  float m[GP], l[GP], acc[GP], s[GP];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
    acc[g] = 0.f;
  }

  const T* kb = k + (int64_t)b * k_sb + (int64_t)hk * k_sh;
  const T* vb = v + (int64_t)b * v_sb + (int64_t)hk * v_sh;
  const int start = split * chunk;
  const int end = (start + chunk < clen) ? start + chunk : clen;
  __syncthreads();

  for (int t0 = start; t0 < end; t0 += TN) {
    const int j = t0 + tid;
    const bool valid = j < end;

    // (1) scores of K row j against the G query rows
#pragma unroll
    for (int g = 0; g < GP; ++g) s[g] = 0.f;
    if (valid) {
      const T* kr = kb + (int64_t)j * k_ss;
#pragma unroll 4
      for (int d0 = 0; d0 < D; d0 += N) {
        float kf[N];
        load_chunk<T>(kr + d0, kf, vec != 0, D - d0);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          if (g < G) {                   // G is uniform across the block
#pragma unroll
            for (int i = 0; i < N; i += 4) {
              const float4 qq = *reinterpret_cast<const float4*>(&q_s[g][d0 + i]);
              s[g] = fmaf(qq.x, kf[i], s[g]);
              s[g] = fmaf(qq.y, kf[i + 1], s[g]);
              s[g] = fmaf(qq.z, kf[i + 2], s[g]);
              s[g] = fmaf(qq.w, kf[i + 3], s[g]);
            }
          }
        }
      }
    }

    // (2) tile max and sum per query row, online-softmax update
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      s[g] = valid ? s[g] * scale : NEG_INF;
      const float mx = warp_max(s[g]);
      if (lane == 0) red_max[warp][g] = mx;
    }
    __syncthreads();
    float m_new[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      float mx = m[g];
#pragma unroll
      for (int w = 0; w < NW; ++w) mx = fmaxf(mx, red_max[w][g]);
      m_new[g] = mx;
      // the tile holds at least one valid row, so m_new is a real score and a
      // masked row's exp(-1e30 - m_new) is exactly 0
      const float p = expf(s[g] - mx);
      p_s[g][tid] = p;
      const float ps = warp_sum(p);
      if (lane == 0) red_sum[warp][g] = ps;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      float ps = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) ps += red_sum[w][g];
      const float corr = expf(m[g] - m_new[g]);
      l[g] = l[g] * corr + ps;
      m[g] = m_new[g];
      acc[g] *= corr;
    }

    // (3) acc[g] += sum_j P[g][j] * V[j][tid]; P is 0 on rows beyond `end`
    if (tid < D) {
      const int n_rows = (end - t0 < TN) ? end - t0 : TN;
      const T* vr = vb + (int64_t)t0 * v_ss + tid;
#pragma unroll 2
      for (int j4 = 0; j4 < n_rows; j4 += 4) {
        float vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          vv[i] = (j4 + i < n_rows) ? to_float(vr[(int64_t)(j4 + i) * v_ss]) : 0.f;
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          if (g < G) {
            const float4 pp = *reinterpret_cast<const float4*>(&p_s[g][j4]);
            acc[g] = fmaf(pp.x, vv[0], acc[g]);
            acc[g] = fmaf(pp.y, vv[1], acc[g]);
            acc[g] = fmaf(pp.z, vv[2], acc[g]);
            acc[g] = fmaf(pp.w, vv[3], acc[g]);
          }
        }
      }
    }
    __syncthreads();                     // p_s and the reductions are reused
  }

  const int64_t pbase = ((int64_t)(b * Hkv + hk) * n_split + split) * G;
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (g < G) {
      if (tid < D) part_acc[(pbase + g) * D + tid] = acc[g];
      if (tid == 0) {
        part_m[pbase + g] = m[g];
        part_l[pbase + g] = l[g];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(128)
decode_merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_m,
                    const float* __restrict__ part_l, T* __restrict__ out,
                    float* __restrict__ out_acc, float* __restrict__ out_m,
                    float* __restrict__ out_l, int G, int D, int n_split, int partials) {
  __shared__ float w[MAX_SPLIT];
  __shared__ float s_ml[2];
  const int h = blockIdx.x, H = gridDim.x;
  const int b = blockIdx.y;
  const int hk = h / G, g = h % G, Hkv = H / G;
  const int tid = threadIdx.x;
  const int64_t base = (int64_t)(b * Hkv + hk) * n_split;   // index of split 0

  if (tid < 32) {
    // n_split <= MAX_SPLIT = 64: two entries per lane
    float mm = NEG_INF;
    for (int s = tid; s < n_split; s += 32) mm = fmaxf(mm, part_m[(base + s) * G + g]);
    mm = warp_max(mm);
    float ll = 0.f;
    for (int s = tid; s < n_split; s += 32) {
      const float c = expf(part_m[(base + s) * G + g] - mm);
      w[s] = c;
      ll = fmaf(part_l[(base + s) * G + g], c, ll);
    }
    ll = warp_sum(ll);
    if (tid == 0) {
      s_ml[0] = mm;
      s_ml[1] = ll;
    }
  }
  __syncthreads();

  const int64_t obase = (int64_t)b * H + h;
  for (int d = tid; d < D; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < n_split; ++s)
      a = fmaf(part_acc[((base + s) * G + g) * D + d], w[s], a);
    if (partials) out_acc[obase * D + d] = a;
    else from_float(out + obase * D + d, a / fmaxf(s_ml[1], L_FLOOR));
  }
  if (partials && tid == 0) {
    out_m[obase] = s_ml[0];
    out_l[obase] = s_ml[1];
  }
}

template <typename T, int GP>
int launch(const void* q, const void* k, const void* v, float* part_acc, float* part_m,
           float* part_l, void* out, float* out_acc, float* out_m, float* out_l,
           int B, int H, int Hkv, int D, int clen, int n_split,
           const int64_t* st, float scale, int partials, cudaStream_t stream) {
  const int G = H / Hkv;
  const int chunk = (clen + n_split - 1) / n_split;
  // 16-byte loads of K rows need every row start aligned and whole chunks
  constexpr int N = Chunk<T>::N;
  const bool vec = D % N == 0 && (uintptr_t)k % 16 == 0 && st[2] % N == 0 &&
                   st[3] % N == 0 && st[4] % N == 0;
  dim3 grid_a(n_split, Hkv, B);
  decode_split_kernel<T, GP><<<grid_a, TN, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, part_acc, part_m, part_l, G, D, clen, chunk,
      vec ? 1 : 0, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_b(H, B);
  decode_merge_kernel<T><<<grid_b, 128, 0, stream>>>(
      part_acc, part_m, part_l, (T*)out, out_acc, out_m, out_l, G, D, n_split, partials);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, float* part_acc, float* part_m,
             float* part_l, void* out, float* out_acc, float* out_m, float* out_l,
             int B, int H, int Hkv, int D, int clen, int n_split,
             const int64_t* st, float scale, int partials, cudaStream_t stream) {
#define REPRO_DECODE_ARGS q, k, v, part_acc, part_m, part_l, out, out_acc, out_m, out_l, \
                          B, H, Hkv, D, clen, n_split, st, scale, partials, stream
  if (H / Hkv <= 8) return launch<T, 8>(REPRO_DECODE_ARGS);
  return launch<T, 16>(REPRO_DECODE_ARGS);
#undef REPRO_DECODE_ARGS
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q is (B, H, D) with element strides
// (q_sb, q_sh); caches are addressed by element strides (b, kv-head, position);
// the head dim is contiguous everywhere. part_* are fp32 scratch of
// B*Hkv*n_split*G*(D | 1 | 1) elements. With partials == 0, `out` (B, H, D,
// contiguous, query type) receives the normalised result; otherwise out_acc
// (B, H, D), out_m and out_l (B, H), all fp32, receive the merged partials.
// clen must already be clamped to [1, S]. Returns cudaGetLastError() of the
// launches (0 on success), -1 on a bad argument.
extern "C" int repro_flash_decode(
    const void* q, const void* k, const void* v,
    void* part_acc, void* part_m, void* part_l,
    void* out, void* out_acc, void* out_m, void* out_l, int dtype,
    int B, int H, int Hkv, int D, int clen, int n_split,
    int64_t q_sb, int64_t q_sh,
    int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss,
    float scale, int partials, void* stream) {
  if (D < 1 || D > 128 || Hkv < 1 || H % Hkv != 0 || H / Hkv > 16 || clen < 1 ||
      n_split < 1 || n_split > MAX_SPLIT)
    return -1;
  const int64_t st[8] = {q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  cudaStream_t cs = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, (float*)part_acc, (float*)part_m, (float*)part_l, out,
                           (float*)out_acc, (float*)out_m, (float*)out_l,
                           B, H, Hkv, D, clen, n_split, st, scale, partials, cs);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, (float*)part_acc, (float*)part_m, (float*)part_l, out,
                                   (float*)out_acc, (float*)out_m, (float*)out_l,
                                   B, H, Hkv, D, clen, n_split, st, scale, partials, cs);
  return -1;
}
