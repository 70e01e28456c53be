// FlashAttention forward for Hopper (sm_90a), fp32 arithmetic throughout.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_fwd_kernel / flash_attention): O = softmax(Q K^T / sqrt(D) + mask) V
// with an online softmax over key/value tiles.
//
// The TPU grid's innermost sequential axis, which carried (acc, m, l) in
// scratch memory from one key/value tile to the next, is a loop inside the
// block here: one block owns one (batch, head, 64-row query tile) and walks the
// key/value tiles up to the diagonal (causal) or to S. K and V tiles are staged
// in shared memory as fp32 and reused by all 64 query rows of the block; each
// of the 8 warps keeps 8 query rows' running (m, l, acc) in registers.
//
// Bound: at serving shapes (B 1, 16 heads, L = S = 512, D = 128, bf16, causal)
// the call moves 4.7 MB (1.4 us at the memory rate) and does 1.08 GFLOP (1.1 us
// at the bf16 tensor-core rate): the two bounds are about equal, bytes just
// ahead. This version does the two products with fp32 FMAs (no tensor cores,
// and no TF32: the fp32 path must agree with an fp32 reference to 2e-5), so it
// is bound by its own FMA and shared-memory rate, two orders of magnitude above
// either bound; what it does about cost is tile reuse (each K/V element is read
// from device memory once per 64 query rows and from shared memory once per 8
// rows, as a 16-byte load) and the causal tile skip. P stays fp32 into P.V, as
// in the TPU kernel. Tensor-core products for bf16 are the next step.
//
// Ragged L, S and D are masked here: rows >= L and head dims >= D are staged
// as zeros and never stored, columns >= S get the -1e30 sentinel. Tensors are
// addressed through element strides for batch, head and sequence (the head dim
// is contiguous), so the model-side (B, L, H, D) layout is read in place.
#include "common.cuh"

namespace {

constexpr int BM = 64;                 // query rows of a block
constexpr int BN = 64;                 // key/value rows of a tile
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int R = BM / NWARPS;         // query rows of a warp
constexpr int CPL = BN / 32;           // score columns of a lane

template <int DP>
struct Smem {
  // K rows are padded by 4 floats so that the 16-byte reads of 8 neighbouring
  // lanes (8 different rows, same head-dim offset) fall into different banks.
  static constexpr int KSTRIDE = DP + 4;
  static constexpr int FLOATS = BM * DP + BN * KSTRIDE + BN * DP + NWARPS * R * BN;
};

template <typename T, int DP>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int G, int L, int S, int D,
                 int64_t q_sb, int64_t q_sh, int64_t q_sl,
                 int64_t k_sb, int64_t k_sh, int64_t k_ss,
                 int64_t v_sb, int64_t v_sh, int64_t v_ss,
                 int64_t o_sb, int64_t o_sh, int64_t o_sl,
                 float scale, int causal) {
  constexpr int VEC = DP / 32;         // output head dims of a lane
  constexpr int KSTRIDE = Smem<DP>::KSTRIDE;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                    // [BM][DP]
  float* Ks = Qs + BM * DP;            // [BN][KSTRIDE]
  float* Vs = Ks + BN * KSTRIDE;       // [BN][DP]
  float* Ps = Vs + BN * DP;            // [NWARPS][R][BN]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q_start = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / G;

  const T* qb = q + (int64_t)b * q_sb + (int64_t)h * q_sh;
  const T* kb = k + (int64_t)b * k_sb + (int64_t)hk * k_sh;
  const T* vb = v + (int64_t)b * v_sb + (int64_t)hk * v_sh;
  T* ob = o + (int64_t)b * o_sb + (int64_t)h * o_sh;

  for (int idx = tid; idx < BM * DP; idx += NTHREADS) {
    const int r = idx / DP, d = idx % DP;
    const int row = q_start + r;
    Qs[idx] = (row < L && d < D) ? to_float(qb[(int64_t)row * q_sl + d]) : 0.f;
  }

  float m[R], l[R], acc[R][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
  }

  int n_tiles = (S + BN - 1) / BN;
  if (causal) {
    // tiles wholly above the diagonal contribute nothing: do not visit them
    const int last = (q_start + BM - 1) / BN + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }
  float* Pw = Ps + warp * R * BN;
  const float* Qw = Qs + warp * R * DP;

  for (int t = 0; t < n_tiles; ++t) {
    const int k_start = t * BN;
    __syncthreads();                   // Q staged; previous tile fully consumed
    for (int idx = tid; idx < BN * DP; idx += NTHREADS) {
      const int r = idx / DP, d = idx % DP;
      const int col = k_start + r;
      const bool ok = col < S && d < D;
      Ks[r * KSTRIDE + d] = ok ? to_float(kb[(int64_t)col * k_ss + d]) : 0.f;
      Vs[r * DP + d] = ok ? to_float(vb[(int64_t)col * v_ss + d]) : 0.f;
    }
    __syncthreads();

    // scores of this warp's R rows against the lane's CPL columns
    float s[R][CPL];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < CPL; ++c) s[r][c] = 0.f;

#pragma unroll 4
    for (int d4 = 0; d4 < DP; d4 += 4) {
      float4 kk[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        kk[c] = *reinterpret_cast<const float4*>(Ks + (lane + 32 * c) * KSTRIDE + d4);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(Qw + r * DP + d4);
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          s[r][c] = fmaf(qq.x, kk[c].x, s[r][c]);
          s[r][c] = fmaf(qq.y, kk[c].y, s[r][c]);
          s[r][c] = fmaf(qq.z, kk[c].z, s[r][c]);
          s[r][c] = fmaf(qq.w, kk[c].w, s[r][c]);
        }
      }
    }

    // online softmax, one row at a time across the warp
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = q_start + warp * R + r;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int col = k_start + lane + 32 * c;
        float x = s[r][c] * scale;
        if (col >= S || (causal && col > row)) x = NEG_INF;
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m[r], mx);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const float p = expf(s[r][c] - m_new);
        Pw[r * BN + lane + 32 * c] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + psum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][e] *= corr;
    }
    __syncwarp();

    // acc += P V : the lane owns head dims [lane*VEC, lane*VEC + VEC)
#pragma unroll 2
    for (int j4 = 0; j4 < BN; j4 += 4) {
      float vv[4][VEC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < VEC; ++e) vv[jj][e] = Vs[(j4 + jj) * DP + lane * VEC + e];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 pp = *reinterpret_cast<const float4*>(Pw + r * BN + j4);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          acc[r][e] = fmaf(pp.x, vv[0][e], acc[r][e]);
          acc[r][e] = fmaf(pp.y, vv[1][e], acc[r][e]);
          acc[r][e] = fmaf(pp.z, vv[2][e], acc[r][e]);
          acc[r][e] = fmaf(pp.w, vv[3][e], acc[r][e]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = q_start + warp * R + r;
    if (row >= L) continue;
    const float denom = fmaxf(l[r], L_FLOOR);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int d = lane * VEC + e;
      if (d < D) from_float(ob + (int64_t)row * o_sl + d, acc[r][e] / denom);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o,
           int B, int H, int Hkv, int L, int S, int D,
           const int64_t* st, float scale, int causal, cudaStream_t stream) {
  const size_t bytes = Smem<DP>::FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + BM - 1) / BM, H, B);
  flash_fwd_kernel<T, DP><<<grid, NTHREADS, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H / Hkv, L, S, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements:
// q (b, h, l), k (b, h, s), v (b, h, s), o (b, h, l); the head dim is contiguous.
// Returns cudaGetLastError() of the launch (0 on success), -1 on a bad argument.
extern "C" int repro_flash_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int H, int Hkv, int L, int S, int D,
    int64_t q_sb, int64_t q_sh, int64_t q_sl,
    int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t o_sb, int64_t o_sh, int64_t o_sl,
    float scale, int causal, void* stream) {
  if (D < 1 || D > 128 || Hkv < 1 || H % Hkv != 0 || L < 1 || S < 1) return -1;
  const int64_t st[12] = {q_sb, q_sh, q_sl, k_sb, k_sh, k_ss,
                          v_sb, v_sh, v_ss, o_sb, o_sh, o_sl};
  cudaStream_t cs = (cudaStream_t)stream;
  const bool wide = D > 64;
  if (dtype == 0) {
    return wide ? launch<float, 128>(q, k, v, o, B, H, Hkv, L, S, D, st, scale, causal, cs)
                : launch<float, 64>(q, k, v, o, B, H, Hkv, L, S, D, st, scale, causal, cs);
  }
  if (dtype == 1) {
    return wide ? launch<__nv_bfloat16, 128>(q, k, v, o, B, H, Hkv, L, S, D, st, scale, causal, cs)
                : launch<__nv_bfloat16, 64>(q, k, v, o, B, H, Hkv, L, S, D, st, scale, causal, cs);
  }
  return -1;
}
