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
// (b, h) pairs at the main shape, 132 SMs), so the work is split the way
// Mamba-2's own GPU kernels split it, into three launches: the chunk
// states, a short sequential pass over chunks (h = exp(a_total) h + s_c,
// handing each chunk the state BEFORE it, and h_final), and the output.
// Rows past S (the ragged last chunk) are loaded as zeros with dt = 0, the
// identity of the recurrence, so h_final is the state after the last real
// token and no padding is materialised.  Masked entries of the decay
// matrix (j > i, whose exp(a_cum_i - a_cum_j) overflows) are selected out
// before the exp, never multiplied by zero.  ssd_scan_fwd picks the kernels
// by dtype; a launch that fails returns its error, nothing falls back.
//
// bf16 (the served path), on the tensor cores, namespace tc:
//   - ssd_state_tc_kernel, grid (nc, heads / SHEADS, B * G), two
//     warpgroups taking the heads in turn over the chunk's B, copied once:
//     a_cum (each warp scans for itself), then s_c = (w x)^T B as wgmma
//     products (M = P, K = the chunk's tokens), B read N-major from its
//     bf16 rows; s_c in fp32.  SHEADS = 6 (one wave of 132 CTAs at the main
//     shape) was the fastest of 2-8 (tools/ssd_tc.py).
//   - ssd_pass_split_kernel: the pass in fp32, four elements a thread
//     (float4), handing each chunk the state before it as a bf16 head and
//     tail (h_split), the form the out kernel multiplies.
//   - ssd_out_tc_kernel, grid (nc, heads / HEADS, row tiles * B * G), two
//     warpgroups on the same 64 rows: C.B^T once for the CTA's HEADS heads
//     (kept in shared memory in fp32), then per head, the warpgroups taking
//     heads in turn, y = exp(a_cum_i) C h_prev^T plus the masked,
//     decay-weighted scores times x, key tile by key tile, the scores of
//     tile u + 1 formed while the products of tile u run.  HEADS = 8 was
//     the fastest of 1-16 (tools/ssd_tc.py).
//   - Every product is bf16 x bf16 with fp32 accumulators.  x, B and C are
//     bf16 already, so C.B^T is exact in one pass; each fp32 operand (the
//     scores, w x and h_prev) enters as a bf16 head plus the bf16 rounding
//     of its remainder, two products.  A single bf16 rounding of the scores
//     misses K5's elementwise check (y 1e-3 / 1e-2 after the bf16 rounding)
//     in the CPU emulation of tests/test_torch_ssm.py.  The row factor
//     exp(a_cum_i) multiplies the fp32 accumulator of C.h_prev^T, not C,
//     so C stays exact.
//   - The scores' decay: the diagonal key tile selects keys j > i out
//     before the exp; below it every key precedes every row, and the decay
//     factors as exp(a_cum_i - a_cum_r) exp(a_cum_r - a_cum_j) (r the
//     tile's last key, both factors <= 1), two exps a row and one a key.
//   - Tiles of 64 rows come by cp.async into 128-byte-swizzled shared
//     memory, read in place from the model's fused projection (any row
//     stride that is a whole 16 bytes); rows past S and columns past P or
//     N are zero-filled, so P < 64 and N < 64 run as zero-padded tiles and
//     the ragged last chunk counts as dt = 0.  A warpgroup copies its next
//     head's h_prev while this head's intra-chunk products run, and each x
//     tile as soon as its product has read it.
//   - x, B and C must be 16-byte aligned with batch and row strides of
//     whole 16 bytes, and h0 16-byte aligned (the pass reads it as
//     float4): ssd_scan_fwd returns cudaErrorInvalidValue otherwise, so
//     the call raises and the card stays usable.
//
// fp32, on the CUDA cores, namespace simt: wgmma takes no fp32 inputs, so
// fp32 calls keep fp32 products, from shared-memory tiles (4 x 4 register
// tiles per thread):
//   1. ssd_state_kernel, grid (nc, H, B): a_cum of the chunk (one thread,
//      in order, as torch.cumsum on the host does), and the chunk's own
//      state contribution sum_j w_j x_j B_j^T (P x N, K = L);
//   2. ssd_pass_kernel, grid (P*N/256, H, B): the pass, overwriting each
//      chunk's contribution with the state before that chunk;
//   3. ssd_out_kernel, grid (L/64, nc, B*H): for 64 rows of a chunk, the
//      inter-chunk term from C and the state before the chunk, then the
//      causal intra-chunk product tile by tile (64 keys at a time); C.B^T
//      is recomputed for every head.
// They take any alignment.
//
// Bound on the H100: bytes.  At the main shape (B 1, S 3072, H 64, P 64,
// N 128, G 1, L 256) the function reads x, B, C, dt and h0 and writes y
// and h_final once, 57 MB: 0.0170 ms at 3.35 TB/s; its causal chunks need
// ~9.8 GFLOP (C.B^T once per group, the masked product with x, the chunk
// states and the inter-chunk output per head): 0.010 ms at 989 TFLOP/s.
// The bf16 kernels do ~15.5 GFLOP of products with the split terms; the
// out kernel runs one CTA per SM (217 KB of shared memory) and is bound by
// latency, not by either rate.

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int NT = 256;       // threads of the CUDA-core kernels and the passes
constexpr int MAX_L = 256;

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
  __nv_bfloat16* h_split;     // bf16: (B, H, nc, 2, P, N), h_prev head, tail
  float* a_cum;               // (B, H, nc * L)
  float* a_tot;               // (B, H, nc)
  long long xb, xs, bb, bs, cb, cs;
  int B, S, H, G, L, nc;
};

// ---------------------------------------------------------------- fp32
namespace simt {

constexpr int TS = 32;        // keys per tile of the state product
constexpr int TI = 64;        // rows of a y tile
constexpr int TJ = 64;        // keys of an intra-chunk tile
constexpr int SP = TI + 4;    // padded row of the transposed tiles

template <int P, int N>
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

  const float* X =
      static_cast<const float*>(p.x) + size_t(b) * p.xb + size_t(h) * P;
  const float* Bq =
      static_cast<const float*>(p.Bm) + size_t(b) * p.bb + size_t(g) * N;
  const int n = tid % N, p0 = (tid / N) * PT;
  float acc[PT];
#pragma unroll
  for (int i = 0; i < PT; ++i) acc[i] = 0.f;
  for (int j0 = 0; j0 < len; j0 += TS) {
    __syncthreads();
    for (int e = tid; e < TS * P; e += NT) {
      const int jj = e / P, pp = e - jj * P, j = j0 + jj;
      s_x[jj][pp] = j < len ? X[size_t(t0 + j) * p.xs + pp] * s_w[j]
                            : 0.f;
    }
    for (int e = tid; e < TS * N; e += NT) {
      const int jj = e / N, nn = e - jj * N, j = j0 + jj;
      s_b[jj][nn] = j < len ? Bq[size_t(t0 + j) * p.bs + nn] : 0.f;
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

template <int P, int N>
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

  const float* X =
      static_cast<const float*>(p.x) + size_t(b) * p.xb + size_t(h) * P;
  const float* Bq =
      static_cast<const float*>(p.Bm) + size_t(b) * p.bb + size_t(g) * N;
  const float* Cq =
      static_cast<const float*>(p.Cm) + size_t(b) * p.cb + size_t(g) * N;

  // C rows of this tile and the state before the chunk
  for (int e = tid; e < TI * N; e += NT) {
    const int ii = e / N, k = e - ii * N, i = i0 + ii;
    s_ct[k * SP + ii] = i < len ? Cq[size_t(t0 + i) * p.cs + k] : 0.f;
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
      s_bt[k * SP + jj] = j < len ? Bq[size_t(t0 + j) * p.bs + k] : 0.f;
    }
    for (int e = tid; e < TJ * P; e += NT) {
      const int jj = e / P, pp = e - jj * P, j = j0 + jj;
      s_x[jj * P + pp] = j < len ? X[size_t(t0 + j) * p.xs + pp] : 0.f;
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

  float* Y =
      static_cast<float*>(p.y) + size_t(b) * p.S * p.H * P + size_t(h) * P;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= len) continue;
#pragma unroll
    for (int q = 0; q < CP; ++q)
      Y[size_t(t0 + i) * p.H * P + tx * CP + q] = yacc[r][q];
  }
}

template <int P, int N>
int launch(const SsdParams& p, cudaStream_t stream) {
  ssd_state_kernel<P, N><<<dim3(p.nc, p.H, p.B), NT, 0, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_pass_kernel<<<dim3((P * N + NT - 1) / NT, p.H, p.B), NT, 0, stream>>>(
      p, P * N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int smem = out_smem_floats<P, N>() * sizeof(float);
  e = cudaFuncSetAttribute(ssd_out_kernel<P, N>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_out_kernel<P, N>
      <<<dim3((p.L + TI - 1) / TI, p.nc, p.B * p.H), NT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ---------------------------------------------------------------- bf16
namespace tc {

// 4 bytes global -> shared (through L1); ok = false writes 4 zero bytes
// and reads nothing.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
// Wait until at most N of this thread's newest copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Barrier among `count` threads (whole warps) on named barrier `id` (1..15;
// __syncthreads() uses 0).
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The short sequential pass over chunks, h = exp(a_total) h + s_c: hands
// each chunk the state BEFORE it in h_split as a bf16 head and the bf16
// rounding of its remainder, and writes h_final.
__global__ void __launch_bounds__(NT)
    ssd_pass_split_kernel(SsdParams p, int PN) {
  const int e = (blockIdx.x * NT + threadIdx.x) * 4;   // 4 elements a thread
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  const size_t bh = size_t(b) * p.H + h;
  const int step = PN / 4;                             // float4s a chunk
  const float4* st =
      reinterpret_cast<const float4*>(p.states + bh * p.nc * PN + e);
  const float* at = p.a_tot + bh * p.nc;
  float4 hv = p.h0 ? *reinterpret_cast<const float4*>(p.h0 + bh * PN + e)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 s = st[0];
  float a = at[0];
  for (int c = 0; c < p.nc; ++c) {
    // the next chunk's contribution is read while this one's state is
    // stored
    float4 s_next = s;
    float a_next = a;
    if (c + 1 < p.nc) {
      s_next = st[(c + 1) * step];
      a_next = at[c + 1];
    }
    __nv_bfloat16* hs = p.h_split + (bh * p.nc + c) * 2 * PN + e;
    uint2 head, tail;
    split_bf16(hv.x, hv.y, head.x, tail.x);
    split_bf16(hv.z, hv.w, head.y, tail.y);
    *reinterpret_cast<uint2*>(hs) = head;
    *reinterpret_cast<uint2*>(hs + PN) = tail;
    const float d = expf(a);
    hv = make_float4(hv.x * d + s.x, hv.y * d + s.y, hv.z * d + s.z,
                     hv.w * d + s.w);
    s = s_next;
    a = a_next;
  }
  *reinterpret_cast<float4*>(p.h_final + bh * PN + e) = hv;
}

constexpr int TILE = 64;             // rows, keys or tokens of a tile
constexpr int PANEL = TILE * 128;    // 64 rows x 64 bf16, SW128
constexpr int NT_TC = 256;           // two warpgroups
constexpr int HEADS = 8;             // heads per out CTA, sharing C.B^T
constexpr int SHEADS = 6;            // heads per state CTA, sharing B
constexpr int MAX_SMEM = 232448;

template <int N>
constexpr int panels() { return N > 64 ? 2 : 1; }    // N padded to 64 / 128

// A 64-row tile of a bf16 operand (row stride ld elements, `cols` columns
// per row, a multiple of 8) into NP SW128 panels at dst by cp.async, 16
// bytes a copy.  Rows >= nrows and columns >= cols are zeros: nothing past
// S or past the operand's width is read.  Threads t of nthr share it.
template <int NP>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long ld, int nrows, int cols,
                                          int t, int nthr) {
  for (int i = t; i < TILE * NP * 8; i += nthr) {
    const int r = i / (NP * 8), c = i % (NP * 8);
    const bool ok = r < nrows && c * 8 < cols;
    cp_async16(dst + (c >> 3) * PANEL + sw128(r, c & 7),
               ok ? src + r * ld + c * 8 : src, ok);
  }
}

// Chunk states s_c = (w x)^T B for one chunk and up to SHEADS heads of one
// group.  The chunk's B (all N columns) is copied once and read by every
// head; the two warpgroups take the heads in turn, each with its own x / dt
// stage, the next head's copies in flight while this head's products and
// stores run.  Per head: a_cum (each warp scans the chunk's dt * A for
// itself), w_j = exp(a_total - a_cum_j) dt_j, then wgmma m64nNk16 products
// (M = P, rows past P zero; K = the chunk's tokens) of w x, entered as the
// A fragments of a bf16 head and the bf16 rounding of its remainder, with
// B read N-major from its bf16 rows.  Writes s_c (fp32), a_cum, a_total.
template <int N>
struct StateSmem {
  static constexpr int NP = panels<N>();
  static constexpr int B_OFF = 0;                        // 4 x NP panels
  static constexpr int ST_OFF = B_OFF + 4 * NP * PANEL;  // 2 stages
  static constexpr int X_OFF = 0;                        // 4 token tiles
  static constexpr int DT_OFF = X_OFF + 4 * PANEL;       // MAX_L fp32
  static constexpr int STAGE = DT_OFF + MAX_L * 4;
  static constexpr int W_OFF = ST_OFF + 2 * STAGE;       // MAX_L fp32 a warp
  static constexpr int BYTES = W_OFF + 8 * MAX_L * 4 + 1024;
  static_assert(BYTES <= MAX_SMEM, "shared memory");
};

template <int P, int N>
__global__ void __launch_bounds__(NT_TC, 1)
    ssd_state_tc_kernel(SsdParams p) {
  using Lo = StateSmem<N>;
  constexpr int NP = Lo::NP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t align = (1024u - (raw & 1023u)) & 1023u;
  uint8_t* smem = smem_raw + align;
  const uint32_t sbase = raw + align;

  const int R = p.H / p.G;
  const int c = blockIdx.x, hb = blockIdx.y;
  const int b = blockIdx.z / p.G, g = blockIdx.z - b * p.G;
  const int t0 = c * p.L;
  const int len = min(p.L, p.S - t0);
  const int ntile = (len + TILE - 1) / TILE;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31;
  const int row0 = warp * 16 + (lane >> 2);   // rows p row0, row0 + 8
  const int r_end = min(R, (hb + 1) * SHEADS);
  const uint32_t stage = sbase + Lo::ST_OFF + wg * Lo::STAGE;
  const uint8_t* sm = smem + Lo::ST_OFF + wg * Lo::STAGE;
  const float* dts = reinterpret_cast<const float*>(sm + Lo::DT_OFF);
  float* w_s = reinterpret_cast<float*>(smem + Lo::W_OFF) + (tid >> 5) * MAX_L;

  const __nv_bfloat16* Bq = static_cast<const __nv_bfloat16*>(p.Bm) +
                            size_t(b) * p.bb + size_t(t0) * p.bs + g * N;
  for (int u = 0; u < ntile; ++u)
    load_tile<NP>(sbase + Lo::B_OFF + u * NP * PANEL,
                  Bq + size_t(u) * TILE * p.bs, p.bs,
                  min(TILE, len - u * TILE), N, tid, NT_TC);
  // head r's x tile u, and its dt (zeros past the chunk's tokens)
  auto load_x = [&](int r, int u) {
    const __nv_bfloat16* X = static_cast<const __nv_bfloat16*>(p.x) +
                             size_t(b) * p.xb + size_t(t0) * p.xs +
                             (g * R + r) * P;
    load_tile<1>(stage + Lo::X_OFF + u * PANEL, X + size_t(u) * TILE * p.xs,
                 p.xs, min(TILE, len - u * TILE), P, wt, 128);
  };
  auto load_dt = [&](int r) {
    const float* dt = p.dt + (size_t(b) * p.S + t0) * p.H + g * R + r;
    for (int j = wt; j < MAX_L; j += 128) {
      const bool ok = j < len;
      cp_async4(stage + Lo::DT_OFF + j * 4, ok ? dt + size_t(j) * p.H : dt,
                ok);
    }
  };
  int r = hb * SHEADS + wg;                   // this warpgroup's next head
  if (r < r_end) {
    load_dt(r);
    for (int u = 0; u < ntile; ++u) load_x(r, u);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();                            // B, copied by all threads

  for (bool first = true; r < r_end; r += 2, first = false) {
    const int h = g * R + r;
    const size_t bh = size_t(b) * p.H + h;
    const bool next = r + 2 < r_end;
    if (!first) {
      cp_async_wait<0>();
      bar_sync(1 + wg, 128);
    }
    fence_async_shared();

    // a_cum: lane l sums slots 8l..8l+7 in order, then a warp scan
    const float A = p.A[h];
    float ac[8], run = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      run += dts[8 * lane + k] * A;
      ac[k] = run;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(~0u, run, o);
      if (lane >= o) run += v;
    }
    float off = __shfl_up_sync(~0u, run, 1);
    if (lane == 0) off = 0.f;
    float last = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      ac[k] += off;
      if (k == ((p.L - 1) & 7)) last = ac[k];
    }
    const float atot = __shfl_sync(~0u, last, (p.L - 1) >> 3);
    float* ac_out = p.a_cum + (bh * p.nc + c) * p.L;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int j = 8 * lane + k;
      if (warp == 0 && j < p.L) ac_out[j] = ac[k];
      w_s[j] = j < len ? expf(atot - ac[k]) * dts[j] : 0.f;
    }
    if (warp == 0 && lane == 0) p.a_tot[bh * p.nc + c] = atot;
    __syncwarp();
    bar_sync(1 + wg, 128);                    // dt read by all
    if (next) load_dt(r + 2);

    float acc[NP * 32];
#pragma unroll
    for (int i = 0; i < NP * 32; ++i) acc[i] = 0.f;
    for (int u = 0; u < ntile; ++u) {
      // A fragments of (w x)^T: row p, columns (tokens) 16kk + 8(q/2) +
      // 2(lane%4) and one more, read down the x tile's rows
      uint32_t ah[4][4], al[4][4];
      const uint8_t* xt = sm + Lo::X_OFF + u * PANEL;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int pp = row0 + 8 * (q & 1);
          const int jl = 16 * kk + 8 * (q >> 1) + 2 * (lane & 3);
          const uint32_t col = 2 * (pp & 7);
          const float x0 = __bfloat162float(*reinterpret_cast<
              const __nv_bfloat16*>(xt + sw128(jl, pp >> 3) + col));
          const float x1 = __bfloat162float(*reinterpret_cast<
              const __nv_bfloat16*>(xt + sw128(jl + 1, pp >> 3) + col));
          split_bf16(w_s[u * TILE + jl] * x0, w_s[u * TILE + jl + 1] * x1,
                     ah[kk][q], al[kk][q]);
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = desc_sw128(
            sbase + Lo::B_OFF + u * NP * PANEL + kk * 16 * 128, PANEL, 1024);
        if constexpr (NP == 2) {
          wgmma_m64n128k16_rs<1>(acc, ah[kk], db, 1);
          wgmma_m64n128k16_rs<1>(acc, al[kk], db, 1);
        } else {
          wgmma_m64n64k16_rs<1>(acc, ah[kk], db, 1);
          wgmma_m64n64k16_rs<1>(acc, al[kk], db, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        reg_fence(ah[kk]);
        reg_fence(al[kk]);
      }
      if (next) {
        bar_sync(1 + wg, 128);                // x tile u read by all
        load_x(r + 2, u);
      }
    }
    if (next) cp_async_commit();

    // s_c: acc[4j + e] is row row0 + 8(e/2), column 8j + 2(lane%4) + e%2
    float* st = p.states + (bh * p.nc + c) * P * N;
#pragma unroll
    for (int j = 0; j < NP * 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int pp = row0 + 8 * (e >> 1), n = 8 * j + 2 * (lane & 3);
        if (pp < P && n < N)
          *reinterpret_cast<float2*>(st + pp * N + n) =
              make_float2(acc[4 * j + e], acc[4 * j + e + 1]);
      }
  }
}

// y for 64 rows of a chunk and up to HEADS heads of one group.  The two
// warpgroups hold the same rows and take the heads in turn.
//   1. C.B^T of the rows against keys 0..i0+63, once for all the heads:
//      64-key tiles from the bf16 rows (one pass, fp32 accumulators),
//      kept in shared memory as each thread's accumulator fragment.
//   2. Per head: y = exp(a_cum_i) (C h_head^T + C h_tail^T), the row
//      factor applied to the fp32 sum; then per key tile
//      S_ij = (C.B^T)_ij exp(a_cum_i - a_cum_j) dt_j, keys j > i selected
//      out before the exp, and y += S_head x + S_tail x.
//   Each warpgroup's stage holds one head's x tiles, h_prev head and tail,
//   and two slots of dt / a_cum; the next head's h_prev and dt / a_cum are
//   copied in while this head's intra-chunk products run, its x once they
//   are done.
template <int N>
struct OutSmem {
  static constexpr int NP = panels<N>();
  static constexpr int C_OFF = 0;                           // NP panels
  static constexpr int CB_OFF = C_OFF + NP * PANEL;         // 4 fp32 tiles
  static constexpr int CB_TILE = TILE * TILE * 4;
  static constexpr int ST_OFF = CB_OFF + 4 * CB_TILE;       // 2 stages
  static constexpr int X_OFF = 0;                           // 4 panels
  static constexpr int HH_OFF = X_OFF + 4 * PANEL;          // NP panels
  static constexpr int HT_OFF = HH_OFF + NP * PANEL;
  static constexpr int DA_OFF = HT_OFF + NP * PANEL;        // 2 x (dt, a_cum)
  static constexpr int DA_SLOT = 2 * MAX_L * 4;
  static constexpr int STAGE = DA_OFF + 2 * DA_SLOT;
  static constexpr int BYTES = ST_OFF + 2 * STAGE + 1024;
  static_assert(4 * NP * PANEL <= DA_OFF, "B tiles must fit a stage");
  static_assert(BYTES <= MAX_SMEM, "shared memory");
};

template <int P, int N>
__global__ void __launch_bounds__(NT_TC, 1)
    ssd_out_tc_kernel(SsdParams p, int nit) {
  using Lo = OutSmem<N>;
  constexpr int NP = Lo::NP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t align = (1024u - (raw & 1023u)) & 1023u;
  uint8_t* smem = smem_raw + align;
  const uint32_t sbase = raw + align;

  const int R = p.H / p.G;
  const int c = blockIdx.x, hb = blockIdx.y;
  const int bg = blockIdx.z % (p.B * p.G);
  const int it = nit - 1 - static_cast<int>(blockIdx.z) / (p.B * p.G);
  const int b = bg / p.G, g = bg - b * p.G;
  const int t0 = c * p.L;
  const int len = min(p.L, p.S - t0);
  const int i0 = it * TILE;                   // longest row tiles first
  if (i0 >= len) return;
  const int nkt = it + 1;                     // key tiles 0..it
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31;
  const int row0 = warp * 16 + (lane >> 2);   // rows row0, row0 + 8
  const int r_end = min(R, (hb + 1) * HEADS);

  const __nv_bfloat16* Bq = static_cast<const __nv_bfloat16*>(p.Bm) +
                            size_t(b) * p.bb + size_t(t0) * p.bs + g * N;
  const __nv_bfloat16* Cq = static_cast<const __nv_bfloat16*>(p.Cm) +
                            size_t(b) * p.cb + size_t(t0) * p.cs + g * N;
  const uint32_t stage = sbase + Lo::ST_OFF + wg * Lo::STAGE;
  float* da_s = reinterpret_cast<float*>(smem + Lo::ST_OFF +
                                        wg * Lo::STAGE + Lo::DA_OFF);

  // head r's h_prev (head, tail) and its keys' dt and a_cum into this
  // warpgroup's stage, dt / a_cum into slot `slot`
  auto load_h = [&](int r, int slot) {
    const int h = g * R + r;
    const __nv_bfloat16* hs =
        p.h_split + ((size_t(b) * p.H + h) * p.nc + c) * 2 * P * N;
    load_tile<NP>(stage + Lo::HH_OFF, hs, N, P, N, wt, 128);
    load_tile<NP>(stage + Lo::HT_OFF, hs + P * N, N, P, N, wt, 128);
    const float* dt = p.dt + (size_t(b) * p.S + t0) * p.H + h;
    const float* ac = p.a_cum + (size_t(b) * p.H + h) * p.nc * p.L +
                      size_t(c) * p.L;
    const uint32_t d = stage + Lo::DA_OFF + slot * Lo::DA_SLOT;
    for (int j = wt; j < nkt * TILE; j += 128) {
      const bool dok = j < len, aok = j < p.L;
      cp_async4(d + j * 4, dok ? dt + size_t(j) * p.H : dt, dok);
      cp_async4(d + MAX_L * 4 + j * 4, aok ? ac + j : ac, aok);
    }
  };
  auto load_x = [&](int r, int u) {
    const __nv_bfloat16* X = static_cast<const __nv_bfloat16*>(p.x) +
                             size_t(b) * p.xb + size_t(t0) * p.xs +
                             (g * R + r) * P;
    load_tile<1>(stage + Lo::X_OFF + u * PANEL, X + size_t(u) * TILE * p.xs,
                 p.xs, min(TILE, len - u * TILE), P, wt, 128);
  };

  // C rows of the tile, and B tile u where C.B^T tile u will be kept
  load_tile<NP>(sbase + Lo::C_OFF, Cq + size_t(i0) * p.cs, p.cs,
                min(TILE, len - i0), N, tid, NT_TC);
  for (int u = 0; u < nkt; ++u)
    load_tile<NP>(sbase + Lo::CB_OFF + u * Lo::CB_TILE,
                  Bq + size_t(u) * TILE * p.bs, p.bs,
                  min(TILE, len - u * TILE), N, tid, NT_TC);
  cp_async_commit();
  int r = hb * HEADS + wg;                    // this warpgroup's next head
  if (r < r_end) {
    load_h(r, 0);
    for (int u = 0; u < nkt; ++u) load_x(r, u);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  fence_async_shared();

  // C's A fragments (rows row0, row0 + 8), for C.B^T and C.h^T
  uint32_t cf[NP * 4][4];
#pragma unroll
  for (int kk = 0; kk < NP * 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      cf[kk][q] = *reinterpret_cast<const uint32_t*>(
          smem + Lo::C_OFF + (kk >> 2) * PANEL +
          sw128(row0 + 8 * (q & 1), 2 * (kk & 3) + (q >> 1)) +
          4 * (lane & 3));

  // 1. C.B^T, key tile u by warpgroup u % 2; s[4j + e] is row
  //    row0 + 8(e/2), key 8j + 2(lane%4) + e%2; stored as [q][thread] float4
  //    over B tile u once the warpgroup's product has read it
  for (int u = wg; u < nkt; u += 2) {
    float s[32];
    const uint32_t bt = sbase + Lo::CB_OFF + u * Lo::CB_TILE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP * 4; ++kk)
      wgmma_m64n64k16_rs<0>(
          s, cf[kk],
          desc_sw128(bt + (kk >> 2) * PANEL + (kk & 3) * 32, 16, 1024),
          kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    bar_sync(1 + wg, 128);
    float4* dst = reinterpret_cast<float4*>(smem + Lo::CB_OFF +
                                            u * Lo::CB_TILE) + wt;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      dst[q * 128] = make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2],
                                 s[4 * q + 3]);
  }
  __syncthreads();                            // C.B^T shared

  // the scores of key tile u for this head as bf16 head and tail A
  // fragments, S_ij = (C.B^T)_ij exp(a_cum_i - a_cum_j) dt_j.  The diagonal
  // tile selects keys j > i (and rows past S) out before the exp.  Below
  // it every key precedes every row, and with r the tile's last key the
  // decay factors as exp(a_cum_i - a_cum_r) exp(a_cum_r - a_cum_j), each
  // <= 1 (a_cum falls): two exps a row and one a key, not one a pair.
  auto scores = [&](int u, const float* dt_s, const float* ac_s,
                    const int (&irow)[2], const float (&ai)[2],
                    uint32_t (&sh)[4][4], uint32_t (&sl)[4][4]) {
    const float4* cbt = reinterpret_cast<const float4*>(
        smem + Lo::CB_OFF + u * Lo::CB_TILE) + wt;
    float s[32];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 v = cbt[q * 128];
      s[4 * q] = v.x;
      s[4 * q + 1] = v.y;
      s[4 * q + 2] = v.z;
      s[4 * q + 3] = v.w;
    }
    if (u < it) {                 // dt_s holds the key factors here
      const float ar = ac_s[u * TILE + TILE - 1];
      float rf[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        rf[e] = irow[e] < len ? __expf(ai[e] - ar) : 0.f;
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8) {
        const float2 kf = *reinterpret_cast<const float2*>(
            dt_s + u * TILE + 8 * j8 + 2 * (lane & 3));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * j8 + e] = s[4 * j8 + e] * rf[e >> 1] * (e & 1 ? kf.y : kf.x);
      }
    } else {
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8) {
        const int j = u * TILE + 8 * j8 + 2 * (lane & 3);
        const float2 aj = *reinterpret_cast<const float2*>(ac_s + j);
        const float2 dj = *reinterpret_cast<const float2*>(dt_s + j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = irow[e >> 1], jj = j + (e & 1);
          const bool keep = jj <= i && i < len;
          const float a = (e & 1) ? aj.y : aj.x;
          const float d = (e & 1) ? dj.y : dj.x;
          const float v = s[4 * j8 + e];
          s[4 * j8 + e] = keep ? v * __expf(ai[e >> 1] - a) * d : 0.f;
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split_bf16(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1], sh[kk][q],
                   sl[kk][q]);
  };
  // y += S_head x_u + S_tail x_u
  auto issue_sx = [&](int u, float (&y)[32], const uint32_t (&sh)[4][4],
                      const uint32_t (&sl)[4][4]) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dx = desc_sw128(
          stage + Lo::X_OFF + u * PANEL + kk * 16 * 128, PANEL, 1024);
      wgmma_m64n64k16_rs<1>(y, sh[kk], dx, 1);
      wgmma_m64n64k16_rs<1>(y, sl[kk], dx, 1);
    }
    wgmma_commit();
  };

  __nv_bfloat16* Y = static_cast<__nv_bfloat16*>(p.y) +
                     (size_t(b) * p.S + t0) * p.H * P;
  for (int k = 0; r < r_end; r += 2, ++k) {
    const int slot = k & 1;
    cp_async_wait<0>();
    bar_sync(1 + wg, 128);
    float* dt_s = da_s + slot * (Lo::DA_SLOT / 4);
    const float* ac_s = dt_s + MAX_L;
    // keys below the diagonal tile: dt_j becomes the key factor
    // exp(a_cum_r - a_cum_j) dt_j, r the last key of j's tile
    for (int j = wt; j < it * TILE; j += 128)
      dt_s[j] *= __expf(ac_s[j | (TILE - 1)] - ac_s[j]);
    bar_sync(1 + wg, 128);
    fence_async_shared();
    const bool next = r + 2 < r_end;

    // 2a. inter-chunk: C h_prev^T, h_prev as head + tail (K-major: rows p)
    float y[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) y[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP * 4; ++kk)
      wgmma_m64n64k16_rs<0>(
          y, cf[kk],
          desc_sw128(stage + Lo::HH_OFF + (kk >> 2) * PANEL + (kk & 3) * 32,
                     16, 1024),
          1);
#pragma unroll
    for (int kk = 0; kk < NP * 4; ++kk)
      wgmma_m64n64k16_rs<0>(
          y, cf[kk],
          desc_sw128(stage + Lo::HT_OFF + (kk >> 2) * PANEL + (kk & 3) * 32,
                     16, 1024),
          1);
    wgmma_commit();
    int irow[2];
    float ai[2], ei[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      irow[e] = i0 + row0 + 8 * e;
      ai[e] = ac_s[irow[e]];
      ei[e] = expf(ai[e]);
    }
    // the first key tile's scores while the tensor cores run
    uint32_t sh0[4][4], sl0[4][4], sh1[4][4], sl1[4][4];
    scores(0, dt_s, ac_s, irow, ai, sh0, sl0);
    wgmma_wait<0>();
    reg_fence(y);
    bar_sync(1 + wg, 128);                    // h_prev read by all
    if (next) load_h(r + 2, slot ^ 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) y[i] *= ei[(i >> 1) & 1];

    // 2b. intra-chunk: the products of key tile u run while the scores of
    // tile u + 1 are formed; then tile u's x slot takes the next head's
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u >= nkt) break;
      if (u & 1) {
        issue_sx(u, y, sh1, sl1);
        if (u + 1 < nkt) scores(u + 1, dt_s, ac_s, irow, ai, sh0, sl0);
      } else {
        issue_sx(u, y, sh0, sl0);
        if (u + 1 < nkt) scores(u + 1, dt_s, ac_s, irow, ai, sh1, sl1);
      }
      wgmma_wait<0>();
      reg_fence(y);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        reg_fence(sh0[kk]);
        reg_fence(sl0[kk]);
        reg_fence(sh1[kk]);
        reg_fence(sl1[kk]);
      }
      if (next) {
        bar_sync(1 + wg, 128);                // x_u read by all
        load_x(r + 2, u);
      }
    }
    if (next) cp_async_commit();

    // y[4j + e]: row row0 + 8(e/2), column p = 8j + 2(lane%4) + e%2
    const int h = g * R + r;
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int i = irow[e >> 1];
      if (i >= len) continue;
      __nv_bfloat16* yr = Y + (size_t(i) * p.H + h) * P;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int pp = 8 * j + 2 * (lane & 3);
        if (pp < P)
          *reinterpret_cast<__nv_bfloat162*>(yr + pp) =
              __floats2bfloat162_rn(y[4 * j + e], y[4 * j + e + 1]);
      }
    }
  }
}

template <int P, int N>
int launch(const SsdParams& p, cudaStream_t stream) {
  constexpr int ssmem = StateSmem<N>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_state_tc_kernel<P, N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, ssmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_state_tc_kernel<P, N>
      <<<dim3(p.nc, (p.H / p.G + SHEADS - 1) / SHEADS, p.B * p.G),
         NT_TC, ssmem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_pass_split_kernel
      <<<dim3((P * N / 4 + NT - 1) / NT, p.H, p.B), NT, 0, stream>>>(p, P * N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int osmem = OutSmem<N>::BYTES;
  e = cudaFuncSetAttribute(ssd_out_tc_kernel<P, N>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, osmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nit = (p.L + TILE - 1) / TILE;
  const int nhb = (p.H / p.G + HEADS - 1) / HEADS;
  ssd_out_tc_kernel<P, N>
      <<<dim3(p.nc, nhb, nit * p.B * p.G), NT_TC, osmem, stream>>>(
          p, nit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

template <int P, int N>
int launch(const SsdParams& p, bool tensor_cores, cudaStream_t stream) {
  return tensor_cores ? tc::launch<P, N>(p, stream)
                      : simt::launch<P, N>(p, stream);
}

int by_shape(const SsdParams& p, int P, int N, bool tensor_cores,
             cudaStream_t stream) {
  if (P == 64 && N == 128) return launch<64, 128>(p, tensor_cores, stream);
  if (P == 32 && N == 64) return launch<32, 64>(p, tensor_cores, stream);
  if (P == 16 && N == 32) return launch<16, 32>(p, tensor_cores, stream);
  if (P == 16 && N == 16) return launch<16, 16>(p, tensor_cores, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* q, long long batch_stride, long long row_stride) {
  return reinterpret_cast<uintptr_t>(q) % 16 == 0 && batch_stride % 8 == 0 &&
         row_stride % 8 == 0;
}

}  // namespace

// x, Bm, Cm and y in `dtype`; dt, A, h0 (or null), h_final, states, a_cum,
// a_tot fp32; h_split bf16 (B, H, nc, 2, P, N) for bf16, unused (null) for
// fp32.  Strides in elements.
extern "C" int ssd_scan_fwd(
    const void* x, const float* dt, const float* A, const void* Bm,
    const void* Cm, const float* h0, void* y, float* h_final, float* states,
    void* h_split, float* a_cum, float* a_tot, long long xb, long long xs,
    long long bb, long long bs, long long cb, long long cs, int B, int S,
    int H, int G, int P, int N, int L, int nc, int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (L < 1 || L > MAX_L || G < 1 || H % G) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SsdParams p{x, dt, A, Bm, Cm, h0, y, h_final, states,
              static_cast<__nv_bfloat16*>(h_split), a_cum, a_tot,
              xb, xs, bb, bs, cb, cs, B, S, H, G, L, nc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16) {
    // cp.async copies x, B and C 16 bytes at a time; the pass reads h0 as
    // float4
    if (!h_split || !aligned16(x, xb, xs) || !aligned16(Bm, bb, bs) ||
        !aligned16(Cm, cb, cs) || reinterpret_cast<uintptr_t>(h0) % 16) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return by_shape(p, P, N, true, s);
  }
  if (dtype == DTYPE_F32) return by_shape(p, P, N, false, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
