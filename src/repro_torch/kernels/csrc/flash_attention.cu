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
// slot j%page), valid while j < hist_len[b].  Ragged Sq and Sk are masked
// here and Sq is tiled, so any chunk length runs (the Pallas K3 asserts
// Sq % 128 == 0; its K2 keeps the whole chunk in VMEM).
//
// Bound on the H100: operations.  A chunk of L queries over Sk keys does
// 4*L*Sk*H*D flops (halved by the causal mask) against O((L+Sk)*H*D)
// bytes, far above the card's ~295 flop/byte balance point.  What limits
// the bf16 kernel is the tensor cores, which also run the tail product
// below (1.5x the products), and the softmax's exp2 and conversions
// between them (PERF.md section 6 has the measured split).
//
// bf16 (the serving path): attn_tc_kernel, on the tensor cores.
//   - A CTA is two warpgroups holding 128 query rows, the queries x heads
//     of one GQA group (32 x 4 for Llama-3-8B): each K/V tile is loaded
//     once for the whole group.  Query tiles start last-first, so the
//     longest causal rows start first.
//   - Keys come in tiles of 64 (one 64-token page) through a four-stage
//     ring, two tiles ahead of the one computed.  head_dim 64 and 128 load
//     them by TMA on a per-stage mbarrier, one box per 64-column panel (K3
//     always; K2 when a page holds whole tiles or a tile whole pages of 8
//     or more rows); head_dim 32 and other pages by cp.async, 16 bytes a
//     thread, each K2 key row through the page table.  head_dim 32 runs
//     padded to 64 columns; 64 is one 128-byte panel with no padding, 128
//     two panels.
//   - S = Q.K^T and O += P.V are wgmma m64nNk16 bf16 products with fp32
//     accumulators.  Q's A fragments stay in registers; K sits K-major in
//     128-byte-swizzled panels of 64 columns; V, in the same layout, is
//     read N-major (the transpose bit); P goes from the S accumulator into
//     A registers.  S of tile t is in flight with P.V of tile t-1, so the
//     softmax of t overlaps the tensor cores' P.V.
//   - The softmax scale, folded with log2 e, multiplies S in fp32 after the
//     product.  l sums the fp32 P.  P.V takes P as a bf16 head plus the
//     bf16 rounding of its remainder, two products: one bf16 rounding of P
//     missed the fixed elementwise check (|o - o_plain| <= 1e-3 + 1e-2
//     |o_plain|) by up to 2x on causal rows whose terms cancel, on the card
//     and in the CPU emulation in tests/test_torch_kernels.py.
//   - Zero-fill rule: every key row that is not valid (past hist_len, past
//     Sk, an unused pool slot) is zeros in shared memory before any
//     product.  TMA loads only boxes whose rows are all keys (K2: row
//     groups wholly below hist_len) or rows past the end of K3's map, which
//     arrive as zeros; every other row of a tile comes by cp.async, with
//     src-size 0 (zeros, nothing read) where no key exists.  A tensor-core
//     product cannot select per element, and a NaN
//     in an unused slot times P = 0 would poison the whole output row.
//     The mask on S stays a select (to -inf), never a multiply.
//   - Each key tile is classified before its products from the minimum
//     and maximum of the CTA's query positions and the tile's key
//     positions (K3's position arrays are not assumed sorted): every pair
//     valid (no mask), some (select), none (skipped: not loaded, not
//     multiplied).  A GQA group must fit one CTA (H / KVH <= 128).
//   - q, k and v (K2: the pools) must be 16-byte aligned, as cp.async and
//     TMA read them 16 bytes at a time; dispatch() returns
//     cudaErrorInvalidValue for a tensor that is not, so the call raises.
//
// fp32: attn_simt_kernel, on the CUDA cores (fp32 products, 64 queries x
// 32 keys of one head per block).  wgmma takes no
// fp32 inputs and TF32 would not meet the fp32 check, so dispatch()
// chooses the kernel by dtype; a bf16 launch that fails raises, it never
// falls back.

#include <cuda.h>   // CUtensorMap

#include "common.cuh"
#include "hopper.cuh"

namespace {

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

// ------------------------------------------------------ bf16: tensor cores
namespace tc {

constexpr int BM = 128;          // query rows per CTA (queries x group heads)
constexpr int BN = 64;           // keys per tile
constexpr int NT = 256;          // two warpgroups of 64 rows
constexpr int DEPTH = 2;         // tiles loaded ahead of the one computed
constexpr int STAGES = DEPTH + 2;  // + the tile computed, + the one whose V
                                   //   its P.V still reads
constexpr int MAX_SMEM = 232448;
enum : int { SKIP = 0, PARTIAL = 1, FULL = 2 };

template <int D>
struct Smem {
  static constexpr int DP = D < 64 ? 64 : D;   // head_dim in shared memory
  static constexpr int NP = DP / 64;           // 128-byte panels per row
  static constexpr int Q_PANEL = BM * 128;
  static constexpr int KV_PANEL = BN * 128;
  static constexpr int KV_TILE = NP * KV_PANEL;          // one K or V stage
  static constexpr int K_OFF = NP * Q_PANEL;
  static constexpr int V_OFF = K_OFF + STAGES * KV_TILE;
  static constexpr int KINFO_OFF = V_OFF + STAGES * KV_TILE;  // (ok, pos)
  static constexpr int BAR_OFF = KINFO_OFF + STAGES * BN * 8;  // full, empty
  static constexpr int CLS_OFF = BAR_OFF + 2 * STAGES * 8;     // K3 classes
  // + 1024: the dynamic window is aligned up to the swizzle's 1024 bytes
  static constexpr int FIXED = CLS_OFF + 1024;
};

// Tile class from the CTA's valid query positions [qmin, qmax] and the
// tile's valid key positions [kmin, kmax] (nvalid of BN keys exist).
__device__ __forceinline__ int classify(int qmin, int qmax, int kmin,
                                        int kmax, int nvalid, int causal,
                                        int window) {
  if (nvalid == 0 || (causal && kmin > qmax) ||
      (window >= 0 && qmin - kmax >= window))
    return SKIP;
  const bool all = nvalid == BN && (!causal || kmax <= qmin) &&
                   (window < 0 || qmax - kmin < window);
  return all ? FULL : PARTIAL;
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

// S = Q K^T for one warpgroup's 64 rows and a 64-key tile (issued, not
// waited); Q's A fragments of each k-step are in registers.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[32],
                                         const uint32_t (&qf)[D / 16][4],
                                         uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n64k16_rs<0>(
        s, qf[kk],
        desc_sw128(k_addr + (kk >> 2) * Smem<D>::KV_PANEL + (kk & 3) * 32,
                   16, 1024),
        kk > 0);
}

// O += P V for a 64-key tile at v_addr, P as head + tail bf16 fragments.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[Smem<D>::DP / 2],
                                         const uint32_t (&ph)[4][4],
                                         const uint32_t (&pl)[4][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dv =
        desc_sw128(v_addr + kk * 16 * 128, Smem<D>::KV_PANEL, 1024);
    if constexpr (Smem<D>::DP == 128) {
      wgmma_m64n128k16_rs<1>(o, ph[kk], dv, 1);
      wgmma_m64n128k16_rs<1>(o, pl[kk], dv, 1);
    } else {
      wgmma_m64n64k16_rs<1>(o, ph[kk], dv, 1);
      wgmma_m64n64k16_rs<1>(o, pl[kk], dv, 1);
    }
  }
}

// Online softmax of one S tile, in place (s[4j + e]: row e/2 of this
// thread, key 8j + 2(lane%4) + e%2): scale to log2 units, mask by select
// where the tile is not FULL, update m and l (l sums the fp32 P), leave P
// in s and return the rescale factor of the rows' running output.
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], bool masked, const int2* ki, const bool (&qok)[2],
    const int (&qp)[2], int causal, int window, float sl2, int lane,
    float (&m)[2], float (&l)[2], float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] *= sl2;
  if (masked) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int2 k = ki[8 * j + 2 * (lane & 3) + (e & 1)];
        if (!pair_valid(qok[e >> 1], qp[e >> 1], k.x, k.y, causal, window))
          s[4 * j + e] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY}, mu[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(~0u, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(~0u, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    mu[i] = m_new == -INFINITY ? 0.f : m_new;     // a row masked so far
    alpha[i] = ex2(m[i] - mu[i]);
    m[i] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = ex2(s[i] - mu[(i >> 1) & 1]);
    rs[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
}

// P (in s, fp32) as the A fragments of the four k-steps of P.V, split
// into a bf16 head and the bf16 rounding of the remainder.  P.V in one
// bf16 rounding of P misses the elementwise check where a row's terms
// cancel (the CPU emulation in tests/test_torch_kernels.py); head + tail
// keeps ~16 bits of P.
__device__ __forceinline__ void p_fragments(const float (&s)[32],
                                            uint32_t (&ph)[4][4],
                                            uint32_t (&pl)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], ph[kk][r],
                 pl[kk][r]);
}

// TMA (template argument TMA): K/V tiles arrive as boxes of 64 columns (one
// SW128 panel) by box_rows key rows, one K and one V box per panel and row
// group, on the stage's full barrier.  K3 maps K/V as (D, KVH, Sk, B):
// rows past Sk are outside the map and arrive as zeros.  K2 maps a pool as
// (D, KVH, pages * page); a box never crosses a page, and TMA reads only
// row groups whose keys are all valid (the rest of K2's last tile comes by
// cp.async, zero-filled past hist_len).
template <int D, bool PAGED, bool TMA>
__global__ void __launch_bounds__(NT, 1)
    attn_tc_kernel(AttnParams p, const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv) {
  using L = Smem<D>;
  constexpr int DP = L::DP;
  constexpr int CPR = D / 8;                 // 16-byte chunks per key row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t align = (1024u - (raw & 1023u)) & 1023u;
  uint8_t* smem = smem_raw + align;
  const uint32_t sbase = raw + align;
  int2* kinfo = reinterpret_cast<int2*>(smem + L::KINFO_OFF);
  const uint32_t bars = sbase + L::BAR_OFF;
  uint8_t* cls_s = smem + L::CLS_OFF;

  const __nv_bfloat16* __restrict__ Q =
      static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* __restrict__ K =
      static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* __restrict__ V =
      static_cast<const __nv_bfloat16*>(p.v);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = tid >> 7;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = p.H / p.KVH, nq = BM / G;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * nq;   // longest tiles first
  const int nqv = min(nq, p.Sq - q0);                 // valid queries
  const int nrows = nqv * G;                          // valid rows

  // Stage s has two mbarriers.  full(s): the 32 lanes of warp 0, which
  // loads every tile, each arrive once its copies and key entries are in
  // (lane 0 also expects the TMA bytes).  empty(s): one lane of each warp
  // arrives once its warpgroup's P.V has read the stage.
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (STAGES + st); };
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 32);
      mbar_init(empty(st), NT / 32);
    }
    mbar_fence_init();
  }
  // head_dim 32: zero the padding columns of Q and of every K/V stage once
  // (64 and 128 fill whole panels and have none)
  if constexpr (DP > D) {
    constexpr int PADC = 8 - CPR;
    for (int i = tid; i < (BM + 2 * STAGES * BN) * PADC; i += NT) {
      const int row = i / PADC, c = CPR + i % PADC;
      const int off = row < BM ? sw128(row, c)
                               : L::K_OFF + ((row - BM) / BN) * L::KV_TILE +
                                     sw128((row - BM) % BN, c);
      *reinterpret_cast<uint4*>(smem + off) = make_uint4(0, 0, 0, 0);
    }
    fence_async_shared();
  }
  // Q rows (query-major, then the group's heads); rows past Sq are zeros
  for (int i = tid; i < BM * CPR; i += NT) {
    const int r = i / CPR, c = i - r * CPR;
    const bool ok = r < nrows;
    const __nv_bfloat16* src = Q;
    if (ok)
      src = Q + ((size_t(b) * p.Sq + q0 + r / G) * p.H + kvh * G + r % G) *
                    D + c * 8;
    cp_async16(sbase + (c >> 3) * L::Q_PANEL + sw128(r, c & 7), src, ok);
  }
  cp_async_commit();

  // the CTA's query-position range, reduced by every warp for itself
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int i = lane; i < nqv; i += 32) {
    const int v = p.q_pos[size_t(b) * p.Sq + q0 + i];
    qmin = min(qmin, v);
    qmax = max(qmax, v);
  }
  qmin = warp_min(qmin);
  qmax = warp_max(qmax);

  // this thread's accumulator rows: lane/4 and lane/4 + 8 of its warp
  const int row0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  bool qok[2];
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    qok[i] = r < nrows;
    qp[i] = qok[i] ? p.q_pos[size_t(b) * p.Sq + q0 + r / G] : 0;
  }

  int n_keys = p.Sk;
  if (PAGED) n_keys = max(0, min(p.hist_len[b], p.npg * p.page));
  const int ntiles = (n_keys + BN - 1) / BN;

  if (!PAGED) {
    // K3: classify every key tile up front, one warp a tile, four tiles'
    // positions in flight per warp
    const int* kpos = p.kv_pos + size_t(b) * p.Sk;
    for (int t0 = warp; t0 < ntiles; t0 += 4 * (NT / 32)) {
      int kp[4][2];
      bool kk[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = (t0 + u * (NT / 32)) * BN + lane + 32 * h;
          kk[u][h] = j < n_keys;
          kp[u][h] = kk[u][h] ? kpos[j] : 0;
        }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = t0 + u * (NT / 32);
        if (t >= ntiles) break;
        const int nvalid = __popc(__ballot_sync(~0u, kk[u][0])) +
                           __popc(__ballot_sync(~0u, kk[u][1]));
        const int kmin = warp_min(min(kk[u][0] ? kp[u][0] : INT_MAX,
                                      kk[u][1] ? kp[u][1] : INT_MAX));
        const int kmax = warp_max(max(kk[u][0] ? kp[u][0] : INT_MIN,
                                      kk[u][1] ? kp[u][1] : INT_MIN));
        if (lane == 0)
          cls_s[t] = static_cast<uint8_t>(
              classify(qmin, qmax, kmin, kmax, nvalid, p.causal, p.window));
      }
    }
  }
  __syncthreads();

  auto tile_class = [&](int t) -> int {
    if (!PAGED) return cls_s[t];
    const int nvalid = min(BN, n_keys - t * BN);
    return classify(qmin, qmax, t * BN, t * BN + nvalid - 1, nvalid,
                    p.causal, p.window);
  };
  auto next_tile = [&](int t) -> int {
    while (t < ntiles && tile_class(t) == SKIP) ++t;
    return t;
  };

  // Warp 0 loads every tile.  What it needs of tile t is fetched one tile
  // before the copies are issued, so the reads are in flight meanwhile:
  // pre[0], with TMA into K2's pages, the first pool row of this lane's
  // box of row group lane / BOXES (-1: no box); pre[1..2], K3's positions
  // of keys lane and lane + 32.  A row group takes BOXES boxes: one per
  // panel, of K and of V.
  constexpr int BOXES = 2 * L::NP;
  const int box_rows = PAGED ? min(p.page, BN) : BN;
  const bool pow2 = (p.page & (p.page - 1)) == 0;
  const int lp = __ffs(p.page) - 1;
  auto pool_row = [&](int j) -> long long {
    const int col = pow2 ? j >> lp : j / p.page;
    return static_cast<long long>(p.table[size_t(b) * p.npg + col]) *
               p.page + (j - col * p.page);
  };
  auto prefetch = [&](int t, long long (&pre)[3]) {
    pre[0] = -1;
    if (TMA && PAGED) {
      const int j = t * BN + (lane / BOXES) * box_rows;
      if (lane / BOXES < BN / box_rows && j < n_keys) pre[0] = pool_row(j);
    }
    if (!PAGED)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = t * BN + lane + 32 * h;
        pre[1 + h] = j < n_keys ? p.kv_pos[size_t(b) * p.Sk + j] : 0;
      }
  };
  // Warp 0: tile t's K and V rows and its keys' (valid, position) into
  // stage s, once both warpgroups are done with the stage.  TMA brings
  // whole boxes of valid keys; the rest of the tile (K2's last, partial
  // tile; everything where TMA is not used) comes by cp.async, zero-filled
  // where there is no key, and is waited for here.
  uint32_t empty_phase = 0;
  auto load_tile = [&](int t, int st, const long long (&pre)[3]) {
    mbar_wait(empty(st), ((empty_phase >> st) & 1) ^ 1);
    empty_phase ^= 1u << st;
    const int nv = min(BN, n_keys - t * BN);            // keys in the tile
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h;
      kinfo[st * BN + r] =
          make_int2(r < nv, PAGED ? t * BN + r : static_cast<int>(pre[1 + h]));
    }
    int tma_rows = 0;
    uint32_t bytes = 0;
    if constexpr (TMA) {
      // K3: one box per panel and tensor, rows past Sk arrive as zeros
      const int groups = PAGED ? nv / box_rows : 1;
      tma_rows = PAGED ? groups * box_rows : BN;
      bytes = groups * BOXES * box_rows * 128;
      const int g = lane / BOXES, panel = (lane >> 1) % L::NP, isv = lane & 1;
      if (g < groups) {
        const uint32_t dst = sbase + (isv ? L::V_OFF : L::K_OFF) +
                             st * L::KV_TILE + panel * L::KV_PANEL +
                             g * box_rows * 128;
        const uint64_t map = reinterpret_cast<uint64_t>(isv ? &tmv : &tmk);
        if (PAGED)
          tma_load_3d(dst, map, full(st), panel * 64, kvh,
                      static_cast<int>(pre[0]));
        else
          tma_load_4d(dst, map, full(st), panel * 64, kvh, t * BN, b);
      }
    }
    if (tma_rows < BN) {
      for (int i = lane; i < (BN - tma_rows) * CPR * 2; i += 32) {
        const int isv = i & 1, c = (i >> 1) % CPR;
        const int r = tma_rows + (i >> 1) / CPR, j = t * BN + r;
        const bool ok = r < nv;
        long long src = 0;
        if (ok)
          src = ((PAGED ? pool_row(j) : static_cast<long long>(b) * p.Sk + j) *
                     p.KVH + kvh) * D + c * 8;
        cp_async16(sbase + (isv ? L::V_OFF : L::K_OFF) + st * L::KV_TILE +
                       (c >> 3) * L::KV_PANEL + sw128(r, c & 7),
                   (isv ? V : K) + src, ok);
      }
      cp_async_commit();
      cp_async_wait_all();
    }
    if (lane == 0)
      mbar_arrive_expect_tx(full(st), bytes);
    else
      mbar_arrive(full(st));
  };
  // Tile t has landed in stage st, for this thread and for its wgmma.
  uint32_t full_phase = 0;
  auto acquire = [&](int st) {
    mbar_wait(full(st), (full_phase >> st) & 1);
    full_phase ^= 1u << st;
    fence_async_shared();
  };
  // this warp is done with stage st (its warpgroup's P.V has completed)
  auto release = [&](int st) {
    if (lane == 0) mbar_arrive(empty(st));
  };

  const float sl2 = p.scale * 1.4426950408889634f;   // scale * log2(e)
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // tiles in order of use: t (next to compute), tn (loaded ahead), tl
  // (next to load; warp 0 has prefetched for it)
  long long pre[3];
  int t = next_tile(0);
  int tn = t < ntiles ? next_tile(t + 1) : ntiles;
  if (warp == 0) {
    if (t < ntiles) {
      prefetch(t, pre);
      load_tile(t, 0, pre);
    }
    if (tn < ntiles) {
      prefetch(tn, pre);
      load_tile(tn, 1, pre);
    }
  }
  int tl = tn < ntiles ? next_tile(tn + 1) : ntiles;
  if (warp == 0 && tl < ntiles) prefetch(tl, pre);
  // after tile t: the loads move one tile on
  auto advance = [&]() {
    const int tr = tl < ntiles ? next_tile(tl + 1) : ntiles;
    if (warp == 0 && tr < ntiles) prefetch(tr, pre);
    t = tn;
    tn = tl;
    tl = tr;
  };

  // Q's A fragments, read once: rows row0 and row0 + 8, columns
  // 16kk + 2(lane%4) (+1) and 8 further
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      qf[kk][r] = *reinterpret_cast<const uint32_t*>(
          smem + (kk >> 2) * L::Q_PANEL +
          sw128(row0 + 8 * (r & 1), 2 * (kk & 3) + (r >> 1)) +
          4 * (lane & 3));

  // S of tile t and P.V of the previous tile are in flight together: the
  // softmax of t runs while the tensor cores finish the previous P.V.  The
  // warpgroups meet only at the stages' barriers.
  uint32_t ph[4][4], pl[4][4];
  if (t < ntiles) {
    // the first tile (peeled: no wgmma of the loop sits in a branch)
    acquire(0);
    float s[32];
    wgmma_fence();
    issue_qk<D>(s, qf, sbase + L::K_OFF);
    wgmma_commit();
    if (warp == 0 && tl < ntiles) load_tile(tl, DEPTH, pre);
    const int t0 = t;
    advance();
    wgmma_wait<0>();
    reg_fence(s);
    float alpha[2];
    softmax_tile(s, tile_class(t0) != FULL, kinfo, qok, qp, p.causal,
                 p.window, sl2, lane, m, l, alpha);
    p_fragments(s, ph, pl);
    int sp = 0, st = 1;
    while (t < ntiles) {
      acquire(st);
      wgmma_fence();
      issue_qk<D>(s, qf, sbase + L::K_OFF + st * L::KV_TILE);
      wgmma_commit();
      // the previous tile: rescale O to its running maximum where that
      // moved, then O += P V
      if (__any_sync(~0u, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      }
      wgmma_fence();
      issue_pv<D>(o, ph, pl, sbase + L::V_OFF + sp * L::KV_TILE);
      wgmma_commit();
      if (warp == 0 && tl < ntiles) load_tile(tl, (st + DEPTH) % STAGES, pre);
      const int tc = t;
      advance();
      wgmma_wait<1>();
      reg_fence(s);
      softmax_tile(s, tile_class(tc) != FULL, kinfo + st * BN, qok, qp,
                   p.causal, p.window, sl2, lane, m, l, alpha);
      wgmma_wait<0>();
      reg_fence(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        reg_fence(ph[kk]);
        reg_fence(pl[kk]);
      }
      release(sp);
      p_fragments(s, ph, pl);
      sp = st;
      st = st + 1 == STAGES ? 0 : st + 1;
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    wgmma_fence();
    issue_pv<D>(o, ph, pl, sbase + L::V_OFF + sp * L::KV_TILE);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
  }
  // every tile loaded was computed and waited for: no copy is in flight

  // ---- normalise and store; l was summed per thread, the row is 4 lanes
  __nv_bfloat16* __restrict__ O = static_cast<__nv_bfloat16*>(p.o);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(~0u, l[i], 1);
    l[i] += __shfl_xor_sync(~0u, l[i], 2);
    const int r = row0 + 8 * i;
    if (r >= nrows) continue;
    const int qi = q0 + r / G, h = kvh * G + r % G;
    const bool live = l[i] > 0.f;
    const float inv = live ? 1.f / l[i] : 0.f;
    __nv_bfloat16* orow = O + ((size_t(b) * p.Sq + qi) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float a = live ? o[4 * j + 2 * i] * inv : 0.f;
      const float c = live ? o[4 * j + 2 * i + 1] * inv : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * (lane & 3)) =
          __floats2bfloat162_rn(a, c);
    }
    if ((lane & 3) == 0)
      p.lse[(size_t(b) * p.H + h) * p.Sq + qi] =
          live ? m[i] * 0.6931471805599453f + logf(l[i]) : NEG_INF_F;
  }
}


// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A bf16 tensor map of `rank` dims (innermost first; strides in bytes for
// dims 1..rank-1) read in SW128 boxes; 0 or a CUDA error code.
int tensor_map(CUtensorMap* map, const void* base, int rank,
               const cuuint64_t* dims, const cuuint64_t* strides,
               const cuuint32_t* box) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<int>(cudaErrorSymbolNotFound);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
      dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D, bool PAGED, bool TMA>
int launch_kernel(const AttnParams& p, const CUtensorMap& tmk,
                  const CUtensorMap& tmv, cudaStream_t stream) {
  const int G = p.H / p.KVH;
  const int ntiles = PAGED ? 0 : (p.Sk + BN - 1) / BN;
  const size_t bytes = Smem<D>::FIXED + ((ntiles + 15) & ~15);
  const int nqt = (p.Sq + BM / G - 1) / (BM / G);
  if (bytes > MAX_SMEM || nqt > 65535 || p.B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_tc_kernel<D, PAGED, TMA>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid(p.KVH, p.B, nqt);
  attn_tc_kernel<D, PAGED, TMA><<<grid, NT, bytes, stream>>>(p, tmk, tmv);
  return static_cast<int>(cudaGetLastError());
}

// head_dim 64 and 128 load K/V by TMA where its boxes fit: K3 always, K2
// when a page holds whole 64-key tiles or a tile whole pages of at least 8
// rows (boxes stay 1024-byte aligned for the swizzle).  A box is 64 columns
// (one SW128 panel) of one KV head by box_rows keys: head_dim 64 takes one
// box per row group and tensor, 128 two.  Rows past K3's Sk lie outside
// the map and arrive as zeros, so the zero-fill rule holds at both widths.
// head_dim 32 (half a panel) and every other page size copy by cp.async.
// Both paths compute the same function; the choice is made from the shapes
// alone.
template <int D, bool PAGED>
int launch_tc(const AttnParams& p, cudaStream_t stream) {
  if (p.H / p.KVH > BM) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tmk{}, tmv{};
  if constexpr (D % 64 == 0) {
    const bool boxes = !PAGED || p.page % BN == 0 ||
                       (p.page >= 8 && BN % p.page == 0);
    if (boxes) {
      const cuuint64_t row = static_cast<cuuint64_t>(p.KVH) * D * 2;
      int rc;
      if (PAGED) {
        // (D, KVH, pool rows): rows past the pool are never addressed
        const cuuint64_t dims[3] = {D, static_cast<cuuint64_t>(p.KVH),
                                    (1ull << 31) - 1};
        const cuuint64_t strides[2] = {D * 2, row};
        const cuuint32_t box[3] = {
            64, 1, static_cast<cuuint32_t>(p.page < BN ? p.page : BN)};
        rc = tensor_map(&tmk, p.k, 3, dims, strides, box);
        if (!rc) rc = tensor_map(&tmv, p.v, 3, dims, strides, box);
      } else {
        const cuuint64_t dims[4] = {D, static_cast<cuuint64_t>(p.KVH),
                                    static_cast<cuuint64_t>(p.Sk),
                                    static_cast<cuuint64_t>(p.B)};
        const cuuint64_t strides[3] = {D * 2, row, row * p.Sk};
        const cuuint32_t box[4] = {64, 1, BN, 1};
        rc = tensor_map(&tmk, p.k, 4, dims, strides, box);
        if (!rc) rc = tensor_map(&tmv, p.v, 4, dims, strides, box);
      }
      if (rc) return rc;
      return launch_kernel<D, PAGED, true>(p, tmk, tmv, stream);
    }
  }
  return launch_kernel<D, PAGED, false>(p, tmk, tmv, stream);
}

}  // namespace tc

// ------------------------------------------------------- fp32: CUDA cores
namespace simt {

constexpr int BQ = 64;       // queries per block
constexpr int BK = 32;       // keys per tile
constexpr int NT = 128;      // threads per block (16 x 8)

template <int D>
constexpr int smem_bytes() {
  return (BQ * (D + 4) + 2 * BK * (D + 4) + BQ * (BK + 4)) * 4 +
         (BQ + 2 * BK) * 4 + BK * 8;
}

template <int D, bool PAGED>
__global__ void __launch_bounds__(NT) attn_simt_kernel(AttnParams p) {
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

  const float* __restrict__ Q = static_cast<const float*>(p.q);
  const float* __restrict__ K = static_cast<const float*>(p.k);
  const float* __restrict__ V = static_cast<const float*>(p.v);

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i - r * D, qi = q0 + r;
    float x = 0.f;
    if (qi < p.Sq) x = (Q[((size_t(b) * p.Sq + qi) * p.H + h) * D + c]) * p.scale;
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
        kx = (K[koff_s[r] + c]);
        vx = (V[koff_s[r] + c]);
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

  float* __restrict__ O = static_cast<float*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= p.Sq) continue;
    const bool live = l[i] > 0.f;
    const float inv = live ? 1.f / l[i] : 0.f;
    float* orow = O + ((size_t(b) * p.Sq + qi) * p.H + h) * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        orow[tx * 4 + 32 * jj + u] = acc[i][jj * 4 + u] * inv;
    if (tx == 0)
      p.lse[(size_t(b) * p.H + h) * p.Sq + qi] =
          live ? m[i] + logf(l[i]) : NEG_INF_F;
  }
}

template <int D, bool PAGED>
int launch_simt(const AttnParams& p, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_simt_kernel<D, PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  attn_simt_kernel<D, PAGED><<<grid, NT, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

template <bool PAGED>
int dispatch(const AttnParams& p, int D, int dtype, cudaStream_t stream) {
  if (p.Sq == 0) return 0;
  if (dtype == DTYPE_BF16) {
    // cp.async and TMA read q, k and v 16 bytes at a time
    if ((reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
         reinterpret_cast<uintptr_t>(p.v)) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    if (D == 128) return tc::launch_tc<128, PAGED>(p, stream);
    if (D == 64) return tc::launch_tc<64, PAGED>(p, stream);
    if (D == 32) return tc::launch_tc<32, PAGED>(p, stream);
  } else if (dtype == DTYPE_F32) {
    if (D == 128) return simt::launch_simt<128, PAGED>(p, stream);
    if (D == 64) return simt::launch_simt<64, PAGED>(p, stream);
    if (D == 32) return simt::launch_simt<32, PAGED>(p, stream);
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
