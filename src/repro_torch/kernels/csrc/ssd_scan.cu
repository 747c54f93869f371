// Mamba-2 chunked SSD scan for Hopper.
//
// Replaces (TPU, Pallas):
//   K5  src/repro/kernels/ssd_scan.py  ssd_scan / _ssd_kernel
//
// Per (batch b, head h), over chunks of L tokens (a_cum the inclusive
// cumsum of dt * A within a chunk, a_total its last value):
//   within a chunk  y_i += sum_{j<=i} exp(a_cum_i - a_cum_j) dt_j (C_i.B_j) x_j
//   across chunks   y_i += exp(a_cum_i) C_i h_prev^T
//                   h    = exp(a_total) h + sum_j exp(a_total - a_cum_j) dt_j x_j B_j^T
// Head h reads B/C group h / (H / G).  y is stored in x's type; states are
// fp32 throughout.
//
// The Pallas kernel walks the chunks of one (b, h) in order on one core,
// carrying h in VMEM.  Here that order would leave the card idle (B * H = 64
// blocks at the main shape, 132 SMs), so the work is split the way
// Mamba-2's own GPU kernels split it, into three launches:
//   1. ssd_state_kernel, grid (nc, H, B): a_cum of the chunk (one thread,
//      in order, as torch.cumsum on the host does), and the chunk's own
//      state contribution sum_j w_j x_j B_j^T (P x N, K = L);
//   2. ssd_pass_kernel, grid (P*N/256, H, B): the short sequential pass
//      over chunks, h = exp(a_total) h + s_c, which overwrites each chunk's
//      contribution with the state BEFORE that chunk and writes h_final;
//   3. ssd_out_kernel, grid (L/64, nc, B*H): for 64 rows of a chunk, the
//      inter-chunk term from C and the state before the chunk, then the
//      causal intra-chunk product tile by tile (64 keys at a time).
// Rows past S (the ragged last chunk) are loaded as zeros with dt = 0, the
// identity of the recurrence, so h_final is the state after the last real
// token and no padding is materialised.  Masked entries of the decay
// matrix (j > i, whose exp(a_cum_i - a_cum_j) overflows) are selected out
// before the exp, never multiplied by zero.
//
// Bound on the H100: bytes.  At the main shape (B 1, S 3072, H 64, P 64,
// N 128, G 1, L 256) the function reads x, B, C, dt and h0 and writes y
// and h_final once, 57 MB: 0.0170 ms at 3.35 TB/s; its causal chunks need
// ~9.8 GFLOP (C.B^T once per group, the masked product with x, the chunk
// states and the inter-chunk output per head): 0.010 ms at 989 TFLOP/s.
// Both dtypes run their products in fp32 on the CUDA cores from
// shared-memory tiles (4 x 4 register tiles per thread), ~26 GFLOP of FMA
// work at that shape: with G = 1 every head recomputes the same C.B^T.
// tools/ssd_scan_tc.cu is a bf16 version on the tensor cores, kept off
// the serving path.

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int MAX_L = 256;
constexpr int TS = 32;        // keys per tile of the state product
constexpr int TI = 64;        // rows of a y tile
constexpr int TJ = 64;        // keys of an intra-chunk tile
constexpr int SP = TI + 4;    // padded row of the transposed tiles

struct SsdParams {
  const void* x;              // (B, S, H, P), token stride xs
  const float* dt;            // (B, S, H)
  const float* A;             // (H,)
  const void* Bm;             // (B, S, G, N), token stride bs
  const void* Cm;
  const float* h0;            // (B, H, P, N) or null
  void* y;                    // (B, S, H, P)
  float* h_final;             // (B, H, P, N)
  float* states;              // (B, H, nc, P, N)
  float* a_cum;               // (B, H, nc * L)
  float* a_tot;               // (B, H, nc)
  long long xb, xs, bb, bs, cb, cs;
  int B, S, H, G, L, nc;
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(NT) ssd_state_kernel(SsdParams p) {
  constexpr int NG = NT / N;          // thread groups over the rows p
  constexpr int PT = P / NG;          // rows p per thread
  static_assert(NG * N == NT && PT * NG == P, "unsupported (P, N)");
  __shared__ float s_ac[MAX_L];
  __shared__ float s_w[MAX_L];
  __shared__ __align__(16) float s_x[TS][P];
  __shared__ __align__(16) float s_b[TS][N];

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int t0 = c * p.L;
  const int len = min(p.L, p.S - t0);
  const int tid = threadIdx.x;

  for (int i = tid; i < p.L; i += NT)
    s_w[i] = i < len ? p.dt[(size_t(b) * p.S + t0 + i) * p.H + h] : 0.f;
  __syncthreads();
  if (tid == 0) {
    const float A = p.A[h];
    float run = 0.f;
    for (int i = 0; i < p.L; ++i) {
      run += s_w[i] * A;
      s_ac[i] = run;
    }
  }
  __syncthreads();
  const float atot = s_ac[p.L - 1];
  float* ac_out = p.a_cum + (size_t(b) * p.H + h) * p.nc * p.L +
                  size_t(c) * p.L;
  for (int i = tid; i < p.L; i += NT) {
    ac_out[i] = s_ac[i];
    s_w[i] = expf(atot - s_ac[i]) * s_w[i];
  }
  if (tid == 0) p.a_tot[(size_t(b) * p.H + h) * p.nc + c] = atot;

  const T* X = static_cast<const T*>(p.x) + size_t(b) * p.xb + size_t(h) * P;
  const T* Bq = static_cast<const T*>(p.Bm) + size_t(b) * p.bb + size_t(g) * N;
  const int n = tid % N, p0 = (tid / N) * PT;
  float acc[PT];
#pragma unroll
  for (int i = 0; i < PT; ++i) acc[i] = 0.f;
  for (int j0 = 0; j0 < len; j0 += TS) {
    __syncthreads();
    for (int e = tid; e < TS * P; e += NT) {
      const int jj = e / P, pp = e - jj * P, j = j0 + jj;
      s_x[jj][pp] = j < len ? to_f(X[size_t(t0 + j) * p.xs + pp]) * s_w[j]
                            : 0.f;
    }
    for (int e = tid; e < TS * N; e += NT) {
      const int jj = e / N, nn = e - jj * N, j = j0 + jj;
      s_b[jj][nn] = j < len ? to_f(Bq[size_t(t0 + j) * p.bs + nn]) : 0.f;
    }
    __syncthreads();
    const int jn = min(TS, len - j0);
    for (int jj = 0; jj < jn; ++jj) {
      const float bv = s_b[jj][n];
#pragma unroll
      for (int i = 0; i < PT; ++i) acc[i] += s_x[jj][p0 + i] * bv;
    }
  }
  float* st = p.states + ((size_t(b) * p.H + h) * p.nc + c) * P * N;
#pragma unroll
  for (int i = 0; i < PT; ++i) st[(p0 + i) * N + n] = acc[i];
}

__global__ void __launch_bounds__(NT) ssd_pass_kernel(SsdParams p, int PN) {
  const int e = blockIdx.x * NT + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  const size_t bh = size_t(b) * p.H + h;
  float hv = p.h0 ? p.h0[bh * PN + e] : 0.f;
  for (int c = 0; c < p.nc; ++c) {
    float* slot = p.states + (bh * p.nc + c) * PN + e;
    const float s = *slot;
    *slot = hv;                                  // the state BEFORE chunk c
    hv = hv * expf(p.a_tot[bh * p.nc + c]) + s;
  }
  p.h_final[bh * PN + e] = hv;
}

template <int P, int N>
constexpr int out_smem_floats() {
  return 2 * N * SP + TJ * P + TJ * SP + TI + 2 * TJ;
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(NT) ssd_out_kernel(SsdParams p) {
  constexpr int CP = P / 16;          // y columns per thread
  static_assert(CP * 16 == P && P <= TJ, "unsupported P");
  extern __shared__ __align__(16) float smem[];
  float* s_ct = smem;                 // [N][SP]  C rows i, transposed
  float* s_bt = s_ct + N * SP;        // [N][SP]  B rows j (or h_prev), transposed
  float* s_x = s_bt + N * SP;         // [TJ][P]
  float* s_st = s_x + TJ * P;         // [TJ][SP] masked scores, transposed
  float* s_aci = s_st + TJ * SP;      // [TI]
  float* s_acj = s_aci + TI;          // [TJ]
  float* s_dtj = s_acj + TJ;          // [TJ]

  const int it = blockIdx.x, c = blockIdx.y;
  const int b = blockIdx.z / p.H, h = blockIdx.z - b * p.H;
  const int g = h / (p.H / p.G);
  const int t0 = c * p.L;
  const int len = min(p.L, p.S - t0);
  const int i0 = it * TI;
  if (i0 >= len) return;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid - ty * 16;
  const size_t bh = size_t(b) * p.H + h;
  const float* ac = p.a_cum + bh * p.nc * p.L + size_t(c) * p.L;

  const T* X = static_cast<const T*>(p.x) + size_t(b) * p.xb + size_t(h) * P;
  const T* Bq = static_cast<const T*>(p.Bm) + size_t(b) * p.bb + size_t(g) * N;
  const T* Cq = static_cast<const T*>(p.Cm) + size_t(b) * p.cb + size_t(g) * N;

  // C rows of this tile and the state before the chunk
  for (int e = tid; e < TI * N; e += NT) {
    const int ii = e / N, k = e - ii * N, i = i0 + ii;
    s_ct[k * SP + ii] = i < len ? to_f(Cq[size_t(t0 + i) * p.cs + k]) : 0.f;
  }
  const float* hp = p.states + (bh * p.nc + c) * P * N;
  for (int e = tid; e < P * N; e += NT) {
    const int pp = e / N, k = e - pp * N;
    s_bt[k * SP + pp] = hp[e];
  }
  for (int ii = tid; ii < TI; ii += NT) {
    const int i = i0 + ii;
    s_aci[ii] = ac[i < len ? i : len - 1];
  }
  __syncthreads();

  // inter-chunk: y_i = exp(a_cum_i) C_i h_prev^T
  float yacc[4][CP];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < CP; ++q) yacc[r][q] = 0.f;
  for (int k = 0; k < N; ++k) {
    const float4 cv = *reinterpret_cast<const float4*>(s_ct + k * SP + ty * 4);
    const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
    for (int q = 0; q < CP; ++q) {
      const float hv = s_bt[k * SP + tx * CP + q];
#pragma unroll
      for (int r = 0; r < 4; ++r) yacc[r][q] += cr[r] * hv;
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float d = expf(s_aci[ty * 4 + r]);
#pragma unroll
    for (int q = 0; q < CP; ++q) yacc[r][q] *= d;
  }

  // intra-chunk, one 64-key tile at a time up to the diagonal
  const int j_end = min(i0 + TI, len);
  for (int j0 = 0; j0 < j_end; j0 += TJ) {
    __syncthreads();
    for (int e = tid; e < TJ * N; e += NT) {
      const int jj = e / N, k = e - jj * N, j = j0 + jj;
      s_bt[k * SP + jj] = j < len ? to_f(Bq[size_t(t0 + j) * p.bs + k]) : 0.f;
    }
    for (int e = tid; e < TJ * P; e += NT) {
      const int jj = e / P, pp = e - jj * P, j = j0 + jj;
      s_x[jj * P + pp] = j < len ? to_f(X[size_t(t0 + j) * p.xs + pp]) : 0.f;
    }
    for (int jj = tid; jj < TJ; jj += NT) {
      const int j = j0 + jj;
      const bool ok = j < len;
      s_acj[jj] = ac[ok ? j : len - 1];
      s_dtj[jj] = ok ? p.dt[(size_t(b) * p.S + t0 + j) * p.H + h] : 0.f;
    }
    __syncthreads();

    // scores C_i.B_j for rows ty*4.. and keys tx*4..
    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) sc[r][q] = 0.f;
    for (int k = 0; k < N; ++k) {
      const float4 cv =
          *reinterpret_cast<const float4*>(s_ct + k * SP + ty * 4);
      const float4 bv =
          *reinterpret_cast<const float4*>(s_bt + k * SP + tx * 4);
      const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) sc[r][q] += cr[r] * br[q];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int jj = tx * 4 + q, j = j0 + jj;
      float4 out;
      float* o = reinterpret_cast<float*>(&out);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ii = ty * 4 + r, i = i0 + ii;
        const bool keep = j <= i && j < len && i < len;
        o[r] = keep ? sc[r][q] * expf(s_aci[ii] - s_acj[jj]) * s_dtj[jj]
                    : 0.f;
      }
      *reinterpret_cast<float4*>(s_st + jj * SP + ty * 4) = out;
    }
    __syncthreads();

    const int jn = min(TJ, j_end - j0);
    for (int jj = 0; jj < jn; ++jj) {
      const float4 sv =
          *reinterpret_cast<const float4*>(s_st + jj * SP + ty * 4);
      const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int q = 0; q < CP; ++q) {
        const float xv = s_x[jj * P + tx * CP + q];
#pragma unroll
        for (int r = 0; r < 4; ++r) yacc[r][q] += sr[r] * xv;
      }
    }
  }

  T* Y = static_cast<T*>(p.y) + size_t(b) * p.S * p.H * P + size_t(h) * P;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= len) continue;
#pragma unroll
    for (int q = 0; q < CP; ++q)
      Y[size_t(t0 + i) * p.H * P + tx * CP + q] = from_f<T>(yacc[r][q]);
  }
}

template <typename T, int P, int N>
int launch(const SsdParams& p, cudaStream_t stream) {
  ssd_state_kernel<T, P, N><<<dim3(p.nc, p.H, p.B), NT, 0, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_pass_kernel<<<dim3((P * N + NT - 1) / NT, p.H, p.B), NT, 0, stream>>>(
      p, P * N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int smem = out_smem_floats<P, N>() * sizeof(float);
  e = cudaFuncSetAttribute(ssd_out_kernel<T, P, N>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_out_kernel<T, P, N>
      <<<dim3((p.L + TI - 1) / TI, p.nc, p.B * p.H), NT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_shape(const SsdParams& p, int P, int N, cudaStream_t stream) {
  if (P == 64 && N == 128) return launch<T, 64, 128>(p, stream);
  if (P == 32 && N == 64) return launch<T, 32, 64>(p, stream);
  if (P == 16 && N == 32) return launch<T, 16, 32>(p, stream);
  if (P == 16 && N == 16) return launch<T, 16, 16>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int ssd_scan_fwd(
    const void* x, const float* dt, const float* A, const void* Bm,
    const void* Cm, const float* h0, void* y, float* h_final, float* states,
    float* a_cum, float* a_tot, long long xb, long long xs, long long bb,
    long long bs, long long cb, long long cs, int B, int S, int H, int G,
    int P, int N, int L, int nc, int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (L < 1 || L > MAX_L || G < 1 || H % G) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SsdParams p{x, dt, A, Bm, Cm, h0, y, h_final, states, a_cum, a_tot,
              xb, xs, bb, bs, cb, cs, B, S, H, G, L, nc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16) return by_shape<__nv_bfloat16>(p, P, N, s);
  if (dtype == DTYPE_F32) return by_shape<float>(p, P, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
