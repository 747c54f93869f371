// Paged flash decode for Hopper, with the fused append of the decode tick.
//
// Replaces (TPU, Pallas):
//   K1  src/repro/kernels/flash_decode.py  paged_flash_decode /
//       _paged_decode_kernel, reached through paged_append_attend
//       (append: fused_append_attend)
//
// One query token per row attends to a paged pool (P, page, KVH, D)
// through a block table (B, npg).  Key t of table column j sits at logical
// position page_pos[b, j] + t and is valid while pos < length and, with a
// window, pos >= length - window.  Columns past a row's allocation carry
// POS_PAD (2^30), which masks them without int32 overflow.  Softmax runs
// online in fp32; a row with no valid key gives o = 0 and lse = -1e30.
//
// Fused append: with k_new/v_new, the new token's K/V lands at
// (append_page[b], append_slot[b]) and the row attends over lengths[b] + 1
// keys.  The split-0 block of (b, kvh) writes the pool; every block of the
// row that meets that slot reads k_new/v_new (rounded to the pool type, the
// bytes the write stores) instead of the pool, so no block waits on another
// block's write.  Padded rows all point at the scratch page and write it at
// once: benign, since only masked reads of other rows ever touch it.  Live
// rows never share the page they append to (the engine splits a shared
// page copy-on-write first).
//
// Bound on the H100: bytes.  A row reads 2 * len * KVH * D * sizeof(T)
// bytes of K/V per layer and does ~4 flops per byte.  Rows are few (the
// decode batch times KVH), so the pages of a row are split over several
// blocks (flash-decoding): grid (splits, KVH, B), each 128-thread block
// serves the G = H/KVH query heads of one KV head, every warp streams its
// own keys (lanes over D, one vector load per lane per key), and a second
// small kernel merges the splits' (m, l, acc) partials by their maxima.

#include "common.cuh"

namespace {

constexpr int NT = 128;
constexpr int NW = NT / 32;
constexpr int U = 4;          // keys in flight per warp

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
  float* part_m;              // (B, H, splits)
  float* part_l;
  float* part_acc;            // (B, H, splits, D)
  void* o;                    // (B, H, D)
  float* lse;                 // (B, H)
  int B, H, KVH, npg, page, splits, pages_per_split, window;
  float scale;
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(NT) decode_split_kernel(DecodeParams p) {
  constexpr int E = D / 32;
  __shared__ float sm_m[NW][G], sm_l[NW][G];
  __shared__ float sm_acc[NW][G][D];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool append = p.k_new != nullptr;
  const int length = p.lengths[b] + (append ? 1 : 0);
  const int lo = p.window >= 0 ? length - p.window : INT_MIN;
  const int apage = append ? p.append_page[b] : -1;
  const int aslot = append ? p.append_slot[b] : -1;

  T* __restrict__ Kp = static_cast<T*>(p.k_pool);
  T* __restrict__ Vp = static_cast<T*>(p.v_pool);
  const size_t new_off = (size_t(b) * p.KVH + kvh) * D + lane * E;

  if (append && split == 0 && warp == 0) {
    const T* kn = static_cast<const T*>(p.k_new) + new_off;
    const T* vn = static_cast<const T*>(p.v_new) + new_off;
    const size_t dst =
        ((size_t(apage) * p.page + aslot) * p.KVH + kvh) * D + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      Kp[dst + e] = kn[e];
      Vp[dst + e] = vn[e];
    }
  }

  float qr[G][E];
  {
    const T* qb = static_cast<const T*>(p.q) + (size_t(b) * p.H + kvh * G) * D;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      load_vec<T, E>(qb + g * D + lane * E, qr[g]);
#pragma unroll
      for (int e = 0; e < E; ++e) qr[g][e] *= p.scale;
    }
  }
  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF_F;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const int f_begin = split * p.pages_per_split * p.page;
  const int f_end = min(p.npg, (split + 1) * p.pages_per_split) * p.page;
  for (int f0 = f_begin + warp * U; f0 < f_end; f0 += NW * U) {
    float kr[U][E], vr[U][E];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int f = f0 + u;
      ok[u] = false;
      if (f < f_end) {
        const int j = f / p.page, t = f - j * p.page;
        const int base = p.page_pos ? p.page_pos[size_t(b) * p.npg + j]
                                    : j * p.page;
        const int pos = base + t;
        ok[u] = pos < length && pos >= lo;
        if (ok[u]) {
          const int phys = p.table[size_t(b) * p.npg + j];
          if (phys == apage && t == aslot) {
            load_vec<T, E>(static_cast<const T*>(p.k_new) + new_off, kr[u]);
            load_vec<T, E>(static_cast<const T*>(p.v_new) + new_off, vr[u]);
          } else {
            const size_t off =
                ((size_t(phys) * p.page + t) * p.KVH + kvh) * D + lane * E;
            load_vec<T, E>(Kp + off, kr[u]);
            load_vec<T, E>(Vp + off, vr[u]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;                // warp-uniform: f is per warp
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part += qr[g][e] * kr[u][e];
        const float s = warp_sum(part);
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float pe = expf(s - m_new);
        l[g] = l[g] * alpha + pe;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = acc[g][e] * alpha + pe * vr[u][e];
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][g][lane * E + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += NT) {
    const int g = i / D, d = i - g * D;
    float M = NEG_INF_F;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(sm_m[w][g] - M);
      L += sm_l[w][g] * c;
      A += sm_acc[w][g][d] * c;
    }
    const size_t row = (size_t(b) * p.H + kvh * G + g) * p.splits + split;
    p.part_acc[row * D + d] = A;
    if (d == 0) {
      p.part_m[row] = M;
      p.part_l[row] = L;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(D) decode_merge_kernel(DecodeParams p) {
  const int bh = blockIdx.x, d = threadIdx.x;
  const size_t base = size_t(bh) * p.splits;
  float M = NEG_INF_F;
  for (int s = 0; s < p.splits; ++s) M = fmaxf(M, p.part_m[base + s]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    const float c = expf(p.part_m[base + s] - M);
    L += p.part_l[base + s] * c;
    A += p.part_acc[(base + s) * D + d] * c;
  }
  const bool live = L > 0.f;
  static_cast<T*>(p.o)[size_t(bh) * D + d] = from_f<T>(live ? A / L : 0.f);
  if (d == 0) p.lse[bh] = live ? M + logf(L) : NEG_INF_F;
}

template <typename T, int D, int G>
int launch(const DecodeParams& p, cudaStream_t stream) {
  dim3 grid(p.splits, p.KVH, p.B);
  decode_split_kernel<T, D, G><<<grid, NT, 0, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_merge_kernel<T, D><<<p.B * p.H, D, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int by_group(const DecodeParams& p, cudaStream_t stream) {
  switch (p.H / p.KVH) {
    case 1: return launch<T, D, 1>(p, stream);
    case 2: return launch<T, D, 2>(p, stream);
    case 4: return launch<T, D, 4>(p, stream);
    case 8: return launch<T, D, 8>(p, stream);
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
  DecodeParams p{q, k_pool, v_pool, table, lengths, page_pos, k_new, v_new,
                 append_page, append_slot, part_m, part_l, part_acc, o, lse,
                 B, H, KVH, npg, page, splits, pages_per_split, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16) {
    if (D == 128) return by_group<__nv_bfloat16, 128>(p, s);
    if (D == 32) return by_group<__nv_bfloat16, 32>(p, s);
  } else if (dtype == DTYPE_F32) {
    if (D == 128) return by_group<float, 128>(p, s);
    if (D == 32) return by_group<float, 32>(p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
