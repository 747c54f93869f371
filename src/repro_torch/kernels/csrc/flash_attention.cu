// Prefill attention for Hopper: K3 (flash attention with position-array
// masks) and K2 (a prefill chunk against paged history).
//
// Replaces (TPU, Pallas):
//   K3  src/repro/kernels/flash_attention.py  flash_attention / _flash_kernel
//   K2  src/repro/kernels/flash_attention.py  paged_flash_prefill /
//                                             _paged_prefill_kernel
//
// Both compute, per query row, an online softmax over key tiles in fp32 and
// return the normalised output plus lse (B, H, Sq); a row with no valid key
// gives o = 0 and lse = -1e30, as the Pallas kernels do.  Masks:
//   valid = key exists && (!causal || kv_pos <= q_pos)
//           && (window < 0 || q_pos - kv_pos < window)
// K2 keys are the flat history index j (position j, page table[b, j/page],
// slot j%page), valid while j < hist_len[b]; its key loop stops there.
//
// Bound on the H100: operations.  A chunk of L queries over Sk keys does
// 4*L*Sk*H*D flops (halved by the causal mask) against O((L+Sk)*H*D)
// bytes, far above the card's ~295 flop/byte balance point.  This first
// version runs its products on the CUDA cores in fp32 (67 TFLOP/s peak),
// not the tensor cores: each 128-thread block owns a 64-query tile of one
// head, stages 32-key K/V tiles in shared memory as fp32, and keeps a
// 4x4 score micro-tile and a 4 x D/8 output micro-tile per thread in
// registers.  Tiles whose every (query, key) pair is masked are skipped.
// Unlike the Pallas kernel (which asserts Sq % 128 == 0 and keeps the whole
// chunk in VMEM for K2), ragged Sq and Sk tails are masked here and Sq is
// tiled, so any chunk length runs.

#include "common.cuh"

namespace {

constexpr int BQ = 64;       // queries per block
constexpr int BK = 32;       // keys per tile
constexpr int NT = 128;      // threads per block (16 x 8)

struct AttnParams {
  const void* q;             // (B, Sq, H, D)
  const void* k;             // K3: (B, Sk, KVH, D); K2: pool (P, page, KVH, D)
  const void* v;
  const int* q_pos;          // (B, Sq)
  const int* kv_pos;         // K3: (B, Sk)
  const int* table;          // K2: (B, npg)
  const int* hist_len;       // K2: (B,)
  void* o;                   // (B, Sq, H, D)
  float* lse;                // (B, H, Sq)
  int B, Sq, Sk, H, KVH, npg, page, causal, window;
  float scale;
};

__device__ __forceinline__ bool pair_valid(bool qok, int qp, bool kok, int kp,
                                           int causal, int window) {
  return qok && kok && (!causal || kp <= qp) &&
         (window < 0 || qp - kp < window);
}

template <int D>
constexpr int smem_bytes() {
  return (BQ * (D + 4) + 2 * BK * (D + 4) + BQ * (BK + 4)) * 4 +
         (BQ + 2 * BK) * 4 + BK * 8;
}

template <typename T, int D, bool PAGED>
__global__ void __launch_bounds__(NT) attn_kernel(AttnParams p) {
  constexpr int DP = D + 4;          // padded row: float4-aligned, spread banks
  constexpr int PP = BK + 4;
  constexpr int NJ = D / 32;         // float4 output column groups per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * DP;
  int* qpos_s = reinterpret_cast<int*>(Ps + BQ * PP);
  int* kpos_s = qpos_s + BQ;
  int* kok_s = kpos_s + BK;
  long long* koff_s = reinterpret_cast<long long*>(kok_s + BK);

  const T* __restrict__ Q = static_cast<const T*>(p.q);
  const T* __restrict__ K = static_cast<const T*>(p.k);
  const T* __restrict__ V = static_cast<const T*>(p.v);

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i - r * D, qi = q0 + r;
    float x = 0.f;
    if (qi < p.Sq) x = to_f(Q[((size_t(b) * p.Sq + qi) * p.H + h) * D + c]) * p.scale;
    Qs[r * DP + c] = x;
  }
  for (int r = tid; r < BQ; r += NT)
    qpos_s[r] = (q0 + r < p.Sq) ? p.q_pos[size_t(b) * p.Sq + q0 + r] : 0;

  float m[4], l[4], acc[4][NJ * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NJ * 4; ++e) acc[i][e] = 0.f;
  }

  int n_keys = p.Sk;
  if (PAGED) n_keys = min(p.hist_len[b], p.npg * p.page);

  for (int k0 = 0; k0 < n_keys; k0 += BK) {
    __syncthreads();                       // previous tile fully consumed
    if (tid < BK) {
      const int j = k0 + tid;
      const bool ok = j < n_keys;
      int pos = 0;
      long long off = 0;
      if (ok) {
        if (PAGED) {
          const int col = j / p.page, slot = j - col * p.page;
          const int phys = p.table[size_t(b) * p.npg + col];
          off = ((static_cast<long long>(phys) * p.page + slot) * p.KVH + kvh) * D;
          pos = j;
        } else {
          off = ((static_cast<long long>(b) * p.Sk + j) * p.KVH + kvh) * D;
          pos = p.kv_pos[size_t(b) * p.Sk + j];
        }
      }
      kok_s[tid] = ok;
      kpos_s[tid] = pos;
      koff_s[tid] = off;
    }
    __syncthreads();
    int any = 0;
    for (int i = tid; i < BQ * BK; i += NT) {
      const int r = i / BK, c = i - r * BK;
      any |= pair_valid(q0 + r < p.Sq, qpos_s[r], kok_s[c], kpos_s[c],
                        p.causal, p.window);
    }
    if (!__syncthreads_or(any)) continue;  // whole tile masked: skip it

    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i - r * D;
      float kx = 0.f, vx = 0.f;
      if (kok_s[r]) {
        kx = to_f(K[koff_s[r] + c]);
        vx = to_f(V[koff_s[r] + c]);
      }
      Ks[r * DP + c] = kx;
      Vs[r * DP + c] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * DP + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 8 * j) * DP + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                     qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const bool qok = q0 + r < p.Sq;
      bool ok[4];
      float mx = NEG_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 8 * j;
        ok[j] = pair_valid(qok, qpos_s[r], kok_s[c], kpos_s[c], p.causal,
                           p.window);
        s[i][j] = ok[j] ? s[i][j] : NEG_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 8 threads sharing a query row are lanes tx = 0..7 of one warp
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pe = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[r * PP + tx + 8 * j] = pe;
        rs += pe;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < NJ * 4; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();                       // P tile complete

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty * 4 + i) * PP + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &Vs[(kk + u) * DP + tx * 4 + 32 * jj]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pp = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                           : u == 2 ? pv[i].z : pv[i].w;
            acc[i][jj * 4 + 0] += pp * vv.x;
            acc[i][jj * 4 + 1] += pp * vv.y;
            acc[i][jj * 4 + 2] += pp * vv.z;
            acc[i][jj * 4 + 3] += pp * vv.w;
          }
        }
      }
    }
  }

  T* __restrict__ O = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= p.Sq) continue;
    const bool live = l[i] > 0.f;
    const float inv = live ? 1.f / l[i] : 0.f;
    T* orow = O + ((size_t(b) * p.Sq + qi) * p.H + h) * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        orow[tx * 4 + 32 * jj + u] = from_f<T>(acc[i][jj * 4 + u] * inv);
    if (tx == 0)
      p.lse[(size_t(b) * p.H + h) * p.Sq + qi] =
          live ? m[i] + logf(l[i]) : NEG_INF_F;
  }
}

template <typename T, int D, bool PAGED>
int launch(const AttnParams& p, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_kernel<T, D, PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  attn_kernel<T, D, PAGED><<<grid, NT, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool PAGED>
int dispatch(const AttnParams& p, int D, int dtype, cudaStream_t stream) {
  if (p.Sq == 0) return 0;
  if (dtype == DTYPE_BF16) {
    if (D == 128) return launch<__nv_bfloat16, 128, PAGED>(p, stream);
    if (D == 32) return launch<__nv_bfloat16, 32, PAGED>(p, stream);
  } else if (dtype == DTYPE_F32) {
    if (D == 128) return launch<float, 128, PAGED>(p, stream);
    if (D == 32) return launch<float, 32, PAGED>(p, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* kv_pos, void* o, float* lse, int B, int Sq, int Sk, int H,
    int KVH, int D, int causal, int window, float scale, int dtype,
    void* stream) {
  AttnParams p{q, k, v, q_pos, kv_pos, nullptr, nullptr, o, lse,
               B, Sq, Sk, H, KVH, 0, 1, causal, window, scale};
  return dispatch<false>(p, D, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int paged_prefill_fwd(
    const void* q, const void* k_pool, const void* v_pool, const int* table,
    const int* hist_len, const int* q_pos, void* o, float* lse, int B, int Sq,
    int H, int KVH, int D, int npg, int page, int causal, int window,
    float scale, int dtype, void* stream) {
  AttnParams p{q, k_pool, v_pool, q_pos, nullptr, table, hist_len, o, lse,
               B, Sq, 0, H, KVH, npg, page, causal, window, scale};
  return dispatch<true>(p, D, dtype, static_cast<cudaStream_t>(stream));
}
