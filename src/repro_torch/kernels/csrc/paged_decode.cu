// Flash decode for Hopper: paged, with the fused append of the decode tick
// (K1), and over a dense cache (K4).
//
// Replaces (TPU, Pallas):
//   K1  src/repro/kernels/flash_decode.py  paged_flash_decode /
//       _paged_decode_kernel, reached through paged_append_attend
//       (append: fused_append_attend)
//   K4  src/repro/kernels/flash_decode.py  flash_decode / _decode_kernel
//
// One query token per row attends to a paged pool (P, page, KVH, D)
// through a block table (B, npg).  Key t of table column j sits at logical
// position page_pos[b, j] + t and is valid while pos < length and, with a
// window, pos >= length - window.  Columns past a row's allocation carry
// POS_PAD (2^30), which masks them without int32 overflow.  A row with no
// valid key gives o = 0 and lse = -1e30.
//
// Dense mode (K4, table == null): the cache is (B, S, KVH, D) and key f of
// row b sits at position kv_offset + f, valid while pos < length and, with
// a window, pos >= length - window.  The row's S keys are cut into
// virtual pages of `page` keys so that the split and merge below serve
// both layouts unchanged; the last page is cut at S, so any S works.
//
// Fused append: with k_new/v_new, the new token's K/V lands at
// (append_page[b], append_slot[b]) and the row attends over lengths[b] + 1
// keys.  The split-0 block of (b, kvh) writes the pool; every block of the
// row copies that slot's row from k_new/v_new (the bytes the write stores)
// instead of from the pool, so no block waits on another block's write and
// a stale or NaN pool slot never enters a tile.  Padded rows all point at
// the scratch page and write it at once: benign, since only masked reads
// of other rows ever touch it.  Live rows never share the page they append
// to (the engine splits a shared page copy-on-write first).
//
// Bound on the H100: bytes.  A row reads 2 * len * KVH * D * sizeof(T)
// bytes of K/V per layer and does ~4 flops per byte (far below the card's
// ridge, so the products stay fp32 on the CUDA cores).  Design:
//   - Rows are few (the decode batch times KVH), so a row's pages are split
//     over blocks (flash-decoding): grid (splits, KVH, B), each block
//     serving the G = H / KVH query heads of one KV head.  The host sizes
//     the splits from the table width, B and KVH alone (plan_splits in
//     flash_decode.py: full rows give two waves of three blocks per SM);
//     a block whose keys all lie outside the row's valid range exits at
//     once.  A second small kernel merges the splits' (m, l, acc)
//     partials.  It stays a launch of its own: fusing it into the last
//     block of a row needs a counter per row, which the C interface has no
//     room for, and static counters would not be safe across streams.
//   - A block walks its keys in tiles of TK = 64 rows (one page at page 64,
//     several pages or half a page otherwise).  Each tile's K and V rows
//     are copied by every thread with cp.async, 16 bytes a copy, into a
//     ring of NS shared-memory stages (bf16, head_dim 128: two, so one
//     tile lands while the other is computed, and three blocks per SM keep
//     96 KB in flight).  A row that holds no valid key is zero-filled by
//     the copy (src-size 0: nothing is read), so NaN in unused slots never
//     reaches a product; its score is a select to -1e30, never a multiply.
//   - The tile's rows (pool row, or k_new, or none) are worked out once
//     per tile, one tile ahead of its copies: the table and page_pos loads
//     are issued before a tile's arithmetic and stored after it.
//   - One softmax step per tile: scores (thread = key x part of D, q in
//     shared memory, pre-scaled by scale * log2 e), one block-wide max per
//     head, one rescale of the accumulators, exp2f, then P.V (thread =
//     16-byte column chunk x key group) from the staged V rows.  P stays
//     fp32.
//   - head_dim 32, 64 and 128.  A key row is CH 16-byte chunks (bf16: 4,
//     8, 16); at bf16 head_dim 64 a tile is 8 KB, so the ring holds four
//     stages (NS is capped at 4) and a block keeps three tiles in flight.
//   - GQA groups of 1, 2, 4, 6, 8 and 16 heads.  Above 8 heads, the two
//     halves of the block's threads each keep the P.V accumulators of half
//     the group over the same staged V tile (K/V leave device memory once
//     per tile for all 16 heads), and the block runs at two per SM (77 KB
//     of shared memory at bf16, head_dim 128), with up to 255 registers a
//     thread for the softmax state of 16 heads.
//   - K/V rows are XOR-swizzled by 16-byte chunk so that the score reads,
//     the P.V reads and the copies are free of bank conflicts.
//   - q, the pools and k_new/v_new must be 16-byte aligned (cp.async reads
//     16 bytes at a time); dispatch() returns cudaErrorInvalidValue for a
//     tensor that is not, so the call raises.

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int NT = 128;                   // threads per block
constexpr int NW = NT / 32;
constexpr int TK = 64;                    // keys per tile
constexpr int TPK = NT / TK;              // score threads per key
// Shared memory for the K/V ring: two stages of 32 KB at bf16, head_dim
// 128, so that three blocks fit an SM (measured faster than three stages
// and two blocks, than 256 threads a block and than 32-key tiles:
// tools/decode_variants.py, PERF.md).
constexpr int RING_BYTES = 64 * 1024;
constexpr int MIN_BLOCKS = 3;             // blocks per SM the registers allow
                                          //   (Cfg::MINB: fewer where the
                                          //   group or the ring asks more)
// A GQA group above 8 heads (ChatGLM3's 16) is served by this many halves
// of the block's threads in P.V, each holding the accumulators of G / 2
// heads over the same staged V tile (1: every thread holds all G heads,
// which takes two blocks per SM; tools/decode_variants.py, PERF.md).
constexpr int BIG_GROUP_SPLIT = 2;
constexpr int MERGE_GROUPS = 4;           // split groups of the merge kernel
constexpr int ROW_NONE = -1;              // no valid key: zero-filled
constexpr int ROW_NEW = -2;               // the appended key: from k_new
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct DecodeParams {
  const void* q;              // (B, H, D)
  void* k_pool;               // (P, page, KVH, D)
  void* v_pool;
  const int* table;           // (B, npg)
  const int* lengths;         // (B,) valid keys, excluding an appended one
  const int* page_pos;        // (B, npg), or null for j * page
  const void* k_new;          // (B, KVH, D) or null
  const void* v_new;
  const int* append_page;     // (B,)
  const int* append_slot;     // (B,)
  int S, kv_offset;           // dense mode: keys per row, first position
  float* part_m;              // (B, H, splits), log2 units
  float* part_l;
  float* part_acc;            // (B, H, splits, D)
  void* o;                    // (B, H, D)
  float* lse;                 // (B, H)
  int B, H, KVH, npg, page, splits, pages_per_split, window;
  float scale;
};

template <typename T, int D, int G>
struct Cfg {
  static constexpr int EV = 16 / sizeof(T);          // elements per chunk
  static constexpr int CH = D / EV;                  // chunks per key row
  static constexpr int ROW = D * sizeof(T);          // bytes per key row
  static constexpr int TILE = TK * ROW;              // bytes per K (V) tile
  static constexpr int NS_ = RING_BYTES / (2 * TILE);
  static constexpr int NS = NS_ < 2 ? 2 : (NS_ > 4 ? 4 : NS_);
  static constexpr int RING = NS * 2 * TILE;
  // P.V: HS halves of NTH threads, each for GH of the G heads, with KG
  // key groups of CH chunk threads
  static constexpr int HS = G > 8 ? BIG_GROUP_SPLIT : 1;
  static constexpr int GH = G / HS;
  static constexpr int NTH = NT / HS;
  static constexpr int KG = NTH / CH;
  static_assert(G % HS == 0 && NTH % 32 == 0 && NTH % CH == 0,
                "head halves: whole heads, whole warps, whole key rows");
  // [ring | q (G x D fp32) | p (TK x G) | warp maxima (NW x G) | rows];
  // the warps' final sums reuse the ring
  static_assert(NW * G * D * 4 <= RING, "final sums fit the ring");
  static constexpr int OFF_Q = RING;
  static constexpr int OFF_P = OFF_Q + G * D * 4;
  static constexpr int OFF_W = OFF_P + TK * G * 4;
  static constexpr int OFF_ROW = OFF_W + NW * G * 4;
  static constexpr int SMEM = OFF_ROW + NS * TK * 4;
  // blocks per SM for the registers: MIN_BLOCKS, two above 8 heads (the
  // per-head softmax state of 16 heads alone holds ~80 registers a
  // thread), and no more than the SM's 228 KB of shared memory holds
  // (fp32 head_dim 128: one)
  static constexpr int FIT = 228 * 1024 / (SMEM + 1024);
  static constexpr int WANT = G > 8 ? 2 : MIN_BLOCKS;
  static constexpr int MINB = FIT < 1 ? 1 : (FIT < WANT ? FIT : WANT);
  static_assert(CH % TPK == 0 && NT % CH == 0 && TK % KG == 0,
                "thread mapping");
  static_assert((TK * CH) % NT == 0, "copy mapping");
  // rows per 128-byte line, and the chunk XOR that spreads the score
  // reads (TPK parts of 8 / TPK keys per quarter warp) over the banks
  static constexpr int RPL = CH >= 8 ? 1 : 8 / CH;
  static constexpr int PER = 8 / (TPK * RPL) > 0 ? 8 / (TPK * RPL) : 1;
  __device__ static __forceinline__ int chunk(int row, int c) {
    return row * CH + (c ^ (TPK * ((row / RPL) % PER)));
  }
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of T (EV elements) from shared memory into fp32.
__device__ __forceinline__ void unpack16(const void* src, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void unpack16(const void* src, float (&f)[4]) {
  const float4 raw = *reinterpret_cast<const float4*>(src);
  f[0] = raw.x; f[1] = raw.y; f[2] = raw.z; f[3] = raw.w;
}

// N fp32 values from shared memory (16- or 8-byte loads where N allows;
// the callers' offsets are multiples of 4 floats, or of N).
template <int N>
__device__ __forceinline__ void lds(const float* src, float (&f)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(src)[i];
      f[4 * i] = x.x; f[4 * i + 1] = x.y; f[4 * i + 2] = x.z;
      f[4 * i + 3] = x.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 x = reinterpret_cast<const float2*>(src)[i];
      f[2 * i] = x.x; f[2 * i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = src[i];
  }
}

template <typename T, int D, int G, bool DENSE>
__global__ void __launch_bounds__(NT, Cfg<T, D, G>::MINB)
    decode_split_kernel(DecodeParams p) {
  using C = Cfg<T, D, G>;
  constexpr int EV = C::EV, CH = C::CH, NS = C::NS, KG = C::KG;
  constexpr int HS = C::HS, GH = C::GH, NWH = C::NTH / 32;
  extern __shared__ __align__(128) uint8_t smem[];
  float* qs = reinterpret_cast<float*>(smem + C::OFF_Q);
  float* sp = reinterpret_cast<float*>(smem + C::OFF_P);
  float* sw = reinterpret_cast<float*>(smem + C::OFF_W);
  int* srow = reinterpret_cast<int*>(smem + C::OFF_ROW);

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool append = p.k_new != nullptr;
  const int length = p.lengths[b] + (append ? 1 : 0);
  const int apage = append ? p.append_page[b] : -1;
  const int aslot = append ? p.append_slot[b] : -1;
  const T* Kp = static_cast<const T*>(p.k_pool);
  const T* Vp = static_cast<const T*>(p.v_pool);
  const size_t new_off = (size_t(b) * p.KVH + kvh) * D;
  const T* kn = append ? static_cast<const T*>(p.k_new) + new_off : Kp;
  const T* vn = append ? static_cast<const T*>(p.v_new) + new_off : Vp;

  if (append && split == 0) {
    T* kd = static_cast<T*>(p.k_pool) +
            ((size_t(apage) * p.page + aslot) * p.KVH + kvh) * D;
    T* vd = static_cast<T*>(p.v_pool) +
            ((size_t(apage) * p.page + aslot) * p.KVH + kvh) * D;
    for (int d = tid; d < D; d += NT) {
      kd[d] = kn[d];
      vd[d] = vn[d];
    }
  }

  // This block's keys: flat indices [f0, f1) of the row.  With positions
  // that follow the flat index (dense, or no page_pos), cut the range to
  // the valid positions first.
  int f0 = split * p.pages_per_split * p.page;
  int f1 = min(p.npg, (split + 1) * p.pages_per_split) * p.page;
  if (DENSE) f1 = min(f1, p.S);
  if (DENSE || p.page_pos == nullptr) {
    const int off = DENSE ? p.kv_offset : 0;
    const int hi = length - off;
    const int lo = p.window >= 0 ? length - p.window - off : INT_MIN;
    if (lo > f0) f0 += (lo - f0) / TK * TK;
    f1 = min(f1, hi);
  }
  const size_t prow = (size_t(b) * p.H + kvh * G) * p.splits + split;
  if (f0 >= f1) {
    if (tid < G) {
      p.part_m[prow + size_t(tid) * p.splits] = NEG_INF_F;
      p.part_l[prow + size_t(tid) * p.splits] = 0.f;
    }
    return;
  }
  const int n_tiles = (f1 - f0 + TK - 1) / TK;

  // Row of tile `i`'s key `kk`: a pool (or dense cache) row index, ROW_NEW
  // or ROW_NONE.  fetch() issues the loads, resolve() finishes from them,
  // so the loads of a tile ahead stay in flight across a tile's work.
  struct Fetch { int f, base, phys; };
  auto fetch = [&](int i, int kk) {
    Fetch r{f0 + i * TK + kk, 0, 0};
    if (!DENSE && r.f < f1) {
      const int j = r.f / p.page;
      r.phys = p.table[size_t(b) * p.npg + j];
      r.base = p.page_pos ? p.page_pos[size_t(b) * p.npg + j] : j * p.page;
    }
    return r;
  };
  auto resolve = [&](const Fetch& r) {
    if (r.f >= f1) return ROW_NONE;
    const int t = DENSE ? 0 : r.f - (r.f / p.page) * p.page;
    const int pos = DENSE ? p.kv_offset + r.f : r.base + t;
    const bool ok = pos < length && (p.window < 0 || pos >= length - p.window);
    if (!ok) return ROW_NONE;
    if (DENSE) return b * p.S + r.f;
    if (r.phys == apage && t == aslot) return ROW_NEW;
    return r.phys * p.page + t;
  };
  // copy tile i's K and V rows into its stage
  auto issue = [&](int i) {
    const int st = i % NS;
    const uint32_t kdst = smem_u32(smem + st * 2 * C::TILE);
    const uint32_t vdst = kdst + C::TILE;
    const int* rows = srow + st * TK;
#pragma unroll
    for (int n = 0; n < TK * CH / NT; ++n) {
      const int idx = tid + n * NT, r = idx / CH, c = idx % CH;
      const int row = rows[r];
      const size_t off = (size_t(row) * p.KVH + kvh) * D + c * EV;
      const T* ks = row >= 0 ? Kp + off : kn + c * EV;
      const T* vs = row >= 0 ? Vp + off : vn + c * EV;
      const uint32_t o = C::chunk(r, c) * 16;
      cp_async16(kdst + o, ks, row != ROW_NONE);
      cp_async16(vdst + o, vs, row != ROW_NONE);
    }
  };

  // the first NS tiles' rows, and q of the G heads scaled into log2
  // units: every load issued before the first store
  Fetch first[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i)
    if (tid < TK && i < n_tiles) first[i] = fetch(i, tid);
  {
    const T* qb = static_cast<const T*>(p.q) + (size_t(b) * p.H + kvh * G) * D;
    const float qscale = p.scale * LOG2E;
    float qv[G * D / NT > 0 ? G * D / NT : 1];
#pragma unroll
    for (int j = 0; j < G * D / NT; ++j) qv[j] = to_f(qb[tid + j * NT]);
#pragma unroll
    for (int j = 0; j < G * D / NT; ++j) qs[tid + j * NT] = qv[j] * qscale;
    for (int i = G * D / NT * NT + tid; i < G * D; i += NT)
      qs[i] = to_f(qb[i]) * qscale;
  }
#pragma unroll
  for (int i = 0; i < NS; ++i)
    if (tid < TK) srow[i * TK + tid] = i < n_tiles ? resolve(first[i])
                                                   : ROW_NONE;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }

  // m and l of all G heads (every thread), acc of this thread's GH heads
  float m[G], l[G], acc[GH][EV];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF_F;
    l[g] = 0.f;
  }
#pragma unroll
  for (int g = 0; g < GH; ++g)
#pragma unroll
    for (int e = 0; e < EV; ++e) acc[g][e] = 0.f;
  const int kk = tid / TPK, part = tid % TPK;   // score mapping
  // P.V mapping: head half hh, chunk pc, key group pg
  const int hh = tid / C::NTH, pc = tid % CH, pg = (tid % C::NTH) / CH;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % NS;
    cp_async_wait<NS - 2>();
    // tile i has landed (every thread's copies), stage (i - 1) % NS is free
    __syncthreads();
    if (i + NS - 1 < n_tiles) issue(i + NS - 1);
    cp_async_commit();
    Fetch ahead{0, 0, 0};
    const bool fetching = tid < TK && i + NS < n_tiles;
    if (fetching) ahead = fetch(i + NS, tid);

    const uint8_t* kt = smem + st * 2 * C::TILE;
    const uint8_t* vt = kt + C::TILE;
    // scores of key kk for the G heads, over this thread's chunks
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
#pragma unroll
    for (int ci = 0; ci < CH / TPK; ++ci) {
      const int c = ci * TPK + part;
      float kf[EV];
      unpack16(kt + C::chunk(kk, c) * 16, kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float qf[EV];
        lds<EV>(qs + g * D + c * EV, qf);
#pragma unroll
        for (int e = 0; e < EV; ++e) s[g] = fmaf(qf[e], kf[e], s[g]);
      }
    }
    const bool ok = srow[st * TK + kk] != ROW_NONE;
    float mx[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int o = 1; o < TPK; o <<= 1)
        s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
      s[g] = ok ? s[g] : NEG_INF_F;
      mx[g] = s[g];
#pragma unroll
      for (int o = TPK; o < 32; o <<= 1)
        mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], o));
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) sw[warp * G + g] = mx[g];
    }
    __syncthreads();
    // one max, one rescale per tile (every thread holds the same m)
    float alpha[G];
    bool moved = false;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float t = m[g];
#pragma unroll
      for (int w = 0; w < NW; ++w) t = fmaxf(t, sw[w * G + g]);
      alpha[g] = exp2f(m[g] - t);
      moved |= t != m[g];
      m[g] = t;
    }
    if (part == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pe = ok ? exp2f(s[g] - m[g]) : 0.f;
        l[g] = l[g] * alpha[g] + pe;
        sp[kk * G + g] = pe;
      }
    }
    __syncthreads();
    if (moved) {
      // this half's factors, picked by selects (no indexed registers)
      float ah[GH];
#pragma unroll
      for (int g = 0; g < GH; ++g) ah[g] = alpha[g];
#pragma unroll
      for (int h = 1; h < HS; ++h)
#pragma unroll
        for (int g = 0; g < GH; ++g)
          ah[g] = hh == h ? alpha[h * GH + g] : ah[g];
#pragma unroll
      for (int g = 0; g < GH; ++g)
#pragma unroll
        for (int e = 0; e < EV; ++e) acc[g][e] *= ah[g];
    }
#pragma unroll
    for (int j = 0; j < TK / KG; ++j) {
      const int r = pg + j * KG;
      float vf[EV], pe[GH];
      unpack16(vt + C::chunk(r, pc) * 16, vf);
      lds<GH>(sp + r * G + hh * GH, pe);
#pragma unroll
      for (int g = 0; g < GH; ++g)
#pragma unroll
        for (int e = 0; e < EV; ++e)
          acc[g][e] = fmaf(pe[g], vf[e], acc[g][e]);
    }
    // tile i's rows are read (scores) before the barrier above, so its
    // slot takes tile i + NS now
    if (tid < TK) srow[st * TK + tid] = fetching ? resolve(ahead) : ROW_NONE;
  }

  // Sum the key groups' accumulators: lanes of one chunk within a warp by
  // shuffles, then the warps through shared memory (the ring is free).
  cp_async_wait<0>();
  __syncthreads();
  // A warp lies in one head half: its slots of red hold that half's
  // heads, and a head sums the NWH warps of its half.
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int g = 0; g < GH; ++g) {
#pragma unroll
    for (int e = 0; e < EV; ++e) {
#pragma unroll
      for (int o = CH; o < 32; o <<= 1)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float lw = warp_sum(l[g]);
    if (lane == 0) sw[warp * G + g] = lw;
  }
  if (lane < CH) {
#pragma unroll
    for (int g = 0; g < GH; ++g)
#pragma unroll
      for (int e = 0; e < EV; ++e)
        red[(warp * G + hh * GH + g) * D + pc * EV + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D, d = i - g * D;
    const int w0 = g / GH * NWH;
    float A = 0.f;
#pragma unroll
    for (int w = 0; w < NWH; ++w) A += red[((w0 + w) * G + g) * D + d];
    const size_t row = prow + size_t(g) * p.splits;
    p.part_acc[row * D + d] = A;
    if (d == 0) {
      float L = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) L += sw[w * G + g];
      p.part_m[row] = m[g];
      p.part_l[row] = L;
    }
  }
}

// One block per (row, head): merge the splits' partials by their maxima
// (log2 units); a split with l = 0 saw no valid key and is skipped (its acc
// is never written).  MERGE_GROUPS groups of D threads take every
// MERGE_GROUPS-th split, so that several splits' loads are in flight.
template <typename T, int D>
__global__ void __launch_bounds__(MERGE_GROUPS * D)
    decode_merge_kernel(DecodeParams p) {
  constexpr int MT = MERGE_GROUPS * D, MW = MT / 32;
  __shared__ float red_m[MW], red_l[MERGE_GROUPS], red_a[MERGE_GROUPS][D];
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int d = tid % D, grp = tid / D;
  const size_t base = size_t(bh) * p.splits;
  const float* pm = p.part_m + base;
  const float* pl = p.part_l + base;
  float M = NEG_INF_F;
  for (int s = tid; s < p.splits; s += MT)
    if (pl[s] > 0.f) M = fmaxf(M, pm[s]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  if ((tid & 31) == 0) red_m[tid >> 5] = M;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < MW; ++w) M = fmaxf(M, red_m[w]);
  const float* pa = p.part_acc + base * D + d;
  float L = 0.f, A = 0.f;
#pragma unroll 4
  for (int s = grp; s < p.splits; s += MERGE_GROUPS) {
    const float ls = pl[s];
    if (ls > 0.f) {
      const float c = exp2f(pm[s] - M);
      L += ls * c;
      A += pa[size_t(s) * D] * c;
    }
  }
  red_a[grp][d] = A;
  if (d == 0) red_l[grp] = L;
  __syncthreads();
  if (grp != 0) return;
#pragma unroll
  for (int g = 1; g < MERGE_GROUPS; ++g) {
    A += red_a[g][d];
    L += red_l[g];
  }
  const bool live = L > 0.f;
  static_cast<T*>(p.o)[size_t(bh) * D + d] = from_f<T>(live ? A / L : 0.f);
  if (d == 0) p.lse[bh] = live ? (M + log2f(L)) * LN2 : NEG_INF_F;
}

template <typename T, int D, int G, bool DENSE>
int launch_split(const DecodeParams& p, cudaStream_t stream) {
  constexpr int bytes = Cfg<T, D, G>::SMEM;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<T, D, G, DENSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid(p.splits, p.KVH, p.B);
  decode_split_kernel<T, D, G, DENSE><<<grid, NT, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, int G>
int launch(const DecodeParams& p, cudaStream_t stream) {
  const int e = p.table == nullptr ? launch_split<T, D, G, true>(p, stream)
                                   : launch_split<T, D, G, false>(p, stream);
  if (e != 0) return e;
  decode_merge_kernel<T, D><<<p.B * p.H, MERGE_GROUPS * D, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int by_group(const DecodeParams& p, cudaStream_t stream) {
  switch (p.H / p.KVH) {
    case 1: return launch<T, D, 1>(p, stream);
    case 2: return launch<T, D, 2>(p, stream);
    case 4: return launch<T, D, 4>(p, stream);
    case 6: return launch<T, D, 6>(p, stream);
    case 8: return launch<T, D, 8>(p, stream);
    case 16: return launch<T, D, 16>(p, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* a) {
  return reinterpret_cast<uintptr_t>(a) % 16 == 0;
}

int dispatch(const DecodeParams& p, int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // cp.async copies 16 bytes at a time
  if (!aligned16(p.q) || !aligned16(p.k_pool) || !aligned16(p.v_pool) ||
      !aligned16(p.k_new) || !aligned16(p.v_new) || p.splits > 65535 ||
      p.KVH > 65535 || p.B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DTYPE_BF16) {
    if (D == 128) return by_group<__nv_bfloat16, 128>(p, s);
    if (D == 64) return by_group<__nv_bfloat16, 64>(p, s);
    if (D == 32) return by_group<__nv_bfloat16, 32>(p, s);
  } else if (dtype == DTYPE_F32) {
    if (D == 128) return by_group<float, 128>(p, s);
    if (D == 64) return by_group<float, 64>(p, s);
    if (D == 32) return by_group<float, 32>(p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int paged_decode_fwd(
    const void* q, void* k_pool, void* v_pool, const int* table,
    const int* lengths, const int* page_pos, const void* k_new,
    const void* v_new, const int* append_page, const int* append_slot,
    float* part_m, float* part_l, float* part_acc, void* o, float* lse,
    int B, int H, int KVH, int D, int npg, int page, int splits,
    int pages_per_split, int window, float scale, int dtype, void* stream) {
  if (B == 0) return 0;
  if (table == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  DecodeParams p{q, k_pool, v_pool, table, lengths, page_pos, k_new, v_new,
                 append_page, append_slot, 0, 0, part_m, part_l, part_acc, o,
                 lse, B, H, KVH, npg, page, splits, pages_per_split, window,
                 scale};
  return dispatch(p, D, dtype, stream);
}

// K4: one query per row over a dense (B, S, KVH, D) cache, cut into
// virtual pages of `page` keys (npg = ceil(S / page)).
extern "C" int dense_decode_fwd(
    const void* q, const void* k, const void* v, const int* lengths,
    float* part_m, float* part_l, float* part_acc, void* o, float* lse,
    int B, int H, int KVH, int D, int S, int kv_offset, int page,
    int splits, int pages_per_split, int window, float scale, int dtype,
    void* stream) {
  if (B == 0) return 0;
  const int npg = (S + page - 1) / page;
  DecodeParams p{q, const_cast<void*>(k), const_cast<void*>(v), nullptr,
                 lengths, nullptr, nullptr, nullptr, nullptr, nullptr,
                 S, kv_offset, part_m, part_l, part_acc, o, lse, B, H, KVH,
                 npg, page, splits, pages_per_split, window, scale};
  return dispatch(p, D, dtype, stream);
}
