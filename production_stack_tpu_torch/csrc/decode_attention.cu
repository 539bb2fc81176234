// Ragged paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel` of
// production_stack_tpu/ops/pallas/paged_attention.py (launched by
// `ragged_paged_attention_decode`): bf16 and f32 pools, sliding window, logit
// softcap, the in-register burst window (k_cur/v_cur), a layer index into the
// stacked [L, P, page, KH, D] pools (no per-layer copy), and the int8 pool
// mode: int8 pages with per-page, per-KV-head f32 scales [L, P, KH]
// (ops/quant.py), the burst window and q staying in bf16/f32.
//
// What bounds it on the card: memory. A decode step reads every live KV slot
// of every row once (2 * kv_len * KH * D * bytes) and does ~4 flops per
// element read, far below the ~295 flop/byte at which the H100 turns compute
// bound. The design therefore streams each KV byte once and keeps loads in
// flight while it computes:
//  - one thread block per (KV head, batch row), one warp per query head of
//    the GQA group (G = NH / KH warps), so a staged K/V tile serves all G
//    heads and GQA costs no extra bytes;
//  - the block walks only the row's LIVE slots [max(kv_len - window, 0),
//    kv_len - cur_len) through its page table, in tiles of BK slots; each
//    slot's head row is D contiguous elements, copied with 16-byte cp.async
//    into a double buffer, so tile i+1 loads while tile i is folded;
//  - scores: lane j owns slots j, j + 32, ... of the tile and takes the whole
//    dot product itself (q in shared memory, rows padded by 16 bytes so the
//    lanes' 16-byte reads hit distinct banks); one max and one sum reduction
//    per tile, then P.V with lanes splitting D;
//  - int8 pools halve the bytes: tiles stage the raw int8 rows, and each
//    slot's page scales (looked up per slot: a 128-slot tile spans pages)
//    are applied in f32, the K scale to the slot's score and the V scale to
//    its probability -- dequantize-then-dot up to the order of the sums;
//  - the cur_len burst entries fold in last, straight from k_cur/v_cur.
// Slots outside the live range are never staged or read (stale pool slots
// may hold NaN). Later work, not here: a split-KV (flash-decoding) variant so
// that small batches at long context fill all 132 SMs.
#include "attention_common.cuh"

namespace {

using namespace pst;

constexpr int MAX_G = 8;  // query heads per KV head, one warp each

// Pool tiles (element KV: T, or int8_t) and burst-window tiles (element T):
// BK slots per tile, 128 for rows of <= 128 bytes, else 64 (the
// double-buffered K and V tiles then stay within ~140 KB of shared memory);
// rows padded by 16 bytes. Lane j owns slots j, j + 32, ...
template <typename T, typename KV, int D>
struct DecodeSmem {
  static constexpr bool QUANT = sizeof(KV) == 1;
  static constexpr int BK = D * sizeof(KV) <= 128 ? 128 : 64;
  static constexpr int ROW = D + 16 / (int)sizeof(KV);
  static constexpr int WBK = D * sizeof(T) <= 128 ? 128 : 64;
  static constexpr int WROW = D + 16 / (int)sizeof(T);
  static constexpr size_t POOL = 4 * (size_t)BK * ROW * sizeof(KV);  // K, V x 2 buffers
  static constexpr size_t WIN = 2 * (size_t)WBK * WROW * sizeof(T);   // K, V of the window
  static constexpr size_t TILES = POOL > WIN ? POOL : WIN;
  static constexpr size_t SCALES = QUANT ? 4 * (size_t)BK * sizeof(float) : 0;  // K, V x 2 buffers
  static constexpr size_t bytes(int G) { return TILES + SCALES + (size_t)G * D * sizeof(float); }
};

// Fold the first n slots of a staged tile (BK slots, rows of stride ROW,
// elements E) into one warp's row state (m in log2 units); slot j is
// visible iff vis(j). SCALED: slot j's K and V values carry the scales
// ksc[j] and vsc[j].
template <typename E, int D, int BK, int ROW, bool SCALED, typename Vis>
__device__ __forceinline__ void fold_tile_lanes(const float* qs, const E* ks, const E* vs, const float* ksc,
                                                const float* vsc, int n, Vis vis, float softcap, float& m,
                                                float& l, float (&acc)[D / 32]) {
  constexpr int EL = D / 32;
  const int lane = threadIdx.x & 31;
  float s[BK / 32];
  bool ok[BK / 32];
  bool any_ok = false;
  float m_tile = NEG_INF;
#pragma unroll
  for (int u = 0; u < BK / 32; ++u) {
    const int j = lane + 32 * u;
    ok[u] = j < n && vis(j);
    any_ok |= ok[u];
    s[u] = NEG_INF;
    if (ok[u]) {
      const E* kr = ks + j * ROW;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < D; c += 8) {
        float f[8];
        load8(kr + c, f);
        const float4 q0 = *reinterpret_cast<const float4*>(qs + c);
        const float4 q1 = *reinterpret_cast<const float4*>(qs + c + 4);
        a[0] += q0.x * f[0] + q1.x * f[4];
        a[1] += q0.y * f[1] + q1.y * f[5];
        a[2] += q0.z * f[2] + q1.z * f[6];
        a[3] += q0.w * f[3] + q1.w * f[7];
      }
      float x = (a[0] + a[1]) + (a[2] + a[3]);  // q carries sm_scale
      if constexpr (SCALED) x *= ksc[j];
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      s[u] = x * LOG2E;
      m_tile = fmaxf(m_tile, s[u]);
    }
  }
  if (!__any_sync(FULL, any_ok)) return;
  const float m_new = fmaxf(m, warp_max(m_tile));
  const float alpha = exp2f(fminf(m - m_new, 0.f));
  float p[BK / 32], psum = 0.f;
#pragma unroll
  for (int u = 0; u < BK / 32; ++u) {
    p[u] = ok[u] ? exp2f(s[u] - m_new) : 0.f;
    psum += p[u];
    // P.V takes p times the slot's V scale, formed once by the slot's lane
    if constexpr (SCALED) p[u] = ok[u] ? p[u] * vsc[lane + 32 * u] : 0.f;
  }
  l = l * alpha + warp_sum(psum);
#pragma unroll
  for (int e = 0; e < EL; ++e) acc[e] *= alpha;
  // every slot below n is live (the caller stages no stale slot), so a
  // masked slot's p = 0 meets a finite V: the loop needs no branch, and
  // unrolled it issues the V loads ahead of the shuffles they wait for
#pragma unroll
  for (int u = 0; u < BK / 32; ++u) {
    const int jn = min(32, n - 32 * u);
#pragma unroll 8
    for (int jj = 0; jj < jn; ++jj) {
      const float pj = __shfl_sync(FULL, p[u], jj);
      float v[EL];
      load_e<EL>(vs + (32 * u + jj) * ROW + lane * EL, v);
#pragma unroll
      for (int e = 0; e < EL; ++e) acc[e] += pj * v[e];
    }
  }
  m = m_new;
}

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(32 * MAX_G, 1) decode_attention_kernel(
    const T* __restrict__ q, const KV* __restrict__ k_pages, const KV* __restrict__ v_pages,
    const float* __restrict__ k_scales, const float* __restrict__ v_scales,
    const T* __restrict__ k_cur, const T* __restrict__ v_cur,
    const int* __restrict__ page_table, const int* __restrict__ seq_lens,
    const int* __restrict__ cur_lens, T* __restrict__ out, int NH, int KH, int P,
    int page_size, int max_pages, int layer, int C, int window, float sm_scale,
    float softcap) {
  using S = DecodeSmem<T, KV, D>;
  constexpr int BK = S::BK;
  constexpr int ROW = S::ROW;
  constexpr int E = D / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  KV* kbuf = reinterpret_cast<KV*>(smem_raw);  // [2][BK][ROW]
  KV* vbuf = kbuf + 2 * BK * ROW;              // [2][BK][ROW]
  float* kscl = reinterpret_cast<float*>(smem_raw + S::TILES);  // [2][BK], int8 pools
  float* vscl = kscl + 2 * BK;
  float* qs_all = reinterpret_cast<float*>(smem_raw + S::TILES + S::SCALES);  // [G][D]

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = NH / KH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = kh * G + warp;  // blockDim.x == 32 * G

  const int kv_len = seq_lens[b];
  const int cl = C > 0 ? cur_lens[b] : 0;
  const int paged_end = kv_len - cl;        // pool slots at/after it are stale
  const int lo = max(kv_len - window, 0);   // first visible position
  const int live_end = min(paged_end, max_pages * page_size);

  float* qs = qs_all + warp * D;
  for (int d = lane; d < D; d += 32) qs[d] = to_f(q[((size_t)b * NH + h) * D + d]) * sm_scale;
  float m = NEG_INF, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  const size_t slot_stride = (size_t)KH * D;  // elements between pool slots
  const size_t layer_off = (size_t)layer * P * page_size * slot_stride + (size_t)kh * D;
  const int* pt = page_table + (size_t)b * max_pages;
  const int n_tiles = live_end > lo ? (live_end - lo + BK - 1) / BK : 0;

  auto issue = [&](int i) {
    const int t0 = lo + i * BK;
    const int n = min(BK, live_end - t0);
    KV* kd = kbuf + (i & 1) * BK * ROW;
    KV* vd = vbuf + (i & 1) * BK * ROW;
    auto row_of = [&](const KV* pool) {
      return [=](int r) -> const KV* {
        const int slot = t0 + r;
        const int pg = slot / page_size;
        return pool + layer_off + ((size_t)pt[pg] * page_size + (slot - pg * page_size)) * slot_stride;
      };
    };
    stage_rows_async<KV, D>(kd, ROW, n, row_of(k_pages));
    stage_rows_async<KV, D>(vd, ROW, n, row_of(v_pages));
    if constexpr (S::QUANT) {
      // each slot's page scales, in the same asynchronous group as its rows
      for (int r = threadIdx.x; r < n; r += blockDim.x) {
        const size_t sc = ((size_t)layer * P + pt[(t0 + r) / page_size]) * KH + kh;
        cp_async4(kscl + (i & 1) * BK + r, k_scales + sc);
        cp_async4(vscl + (i & 1) * BK + r, v_scales + sc);
      }
    }
    cp_async_commit();
  };

  if (n_tiles > 0) issue(0);
  __syncthreads();  // qs visible to the warp's lanes
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      issue(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int n = min(BK, live_end - (lo + i * BK));
    fold_tile_lanes<KV, D, BK, ROW, S::QUANT>(qs, kbuf + (i & 1) * BK * ROW, vbuf + (i & 1) * BK * ROW,
                                              kscl + (i & 1) * BK, vscl + (i & 1) * BK, n,
                                              [](int) { return true; }, softcap, m, l, acc);
    __syncthreads();  // the buffer is refilled by issue(i + 2)
  }

  // the burst window (in q's dtype, never quantized): entry j holds the
  // token at position paged_end + j
  T* wk = reinterpret_cast<T*>(smem_raw);
  T* wv = wk + S::WBK * S::WROW;
  for (int j0 = 0; j0 < cl; j0 += S::WBK) {
    const int n = min(S::WBK, cl - j0);
    auto cur_row = [&](const T* cur) {
      return [=](int r) -> const T* { return cur + (((size_t)b * C + j0 + r) * KH + kh) * D; };
    };
    stage_rows<T, D>(wk, S::WROW, n, cur_row(k_cur));
    stage_rows<T, D>(wv, S::WROW, n, cur_row(v_cur));
    __syncthreads();
    const int first = paged_end + j0;
    fold_tile_lanes<T, D, S::WBK, S::WROW, false>(qs, wk, wv, nullptr, nullptr, n,
                                                  [=](int j) { return first + j >= lo; }, softcap, m, l, acc);
    __syncthreads();
  }

  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < E; ++e) store_f(&out[((size_t)b * NH + h) * D + lane * E + e], acc[e] * inv);
}

template <typename T, typename KV, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp, const float* ks, const float* vs,
                   const void* kc, const void* vc, const int* pt, const int* lens, const int* cl, void* out,
                   int B, int NH, int KH, int P, int page_size, int max_pages, int layer, int C, int window,
                   float sm_scale, float softcap, cudaStream_t stream) {
  const int G = NH / KH;
  if (G > MAX_G) return cudaErrorInvalidValue;
  const size_t smem = DecodeSmem<T, KV, D>::bytes(G);
  static int configured = 0;  // the largest size allowed so far; a race only repeats the call
  if ((int)smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<T, KV, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = (int)smem;
  }
  decode_attention_kernel<T, KV, D><<<dim3(KH, B), 32 * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kp), static_cast<const KV*>(vp), ks, vs,
      static_cast<const T*>(kc), static_cast<const T*>(vc), pt, lens, cl, static_cast<T*>(out),
      NH, KH, P, page_size, max_pages, layer, C, window, sm_scale, softcap);
  return cudaGetLastError();
}

}  // namespace

// dtype (of q, the burst window and out): 0 = float32, 1 = bfloat16. kv_int8
// = 0: pools of that dtype (k_scales/v_scales ignored); 1: int8 pools with
// f32 scales [L, P, KH]. C = 0 means no burst window (k_cur, v_cur and
// cur_lens are then ignored). window: huge = full causal; softcap <= 0 = none.
extern "C" int decode_attention_launch(int dtype, int kv_int8, int head_dim, const void* q,
                                       const void* k_pages, const void* v_pages, const void* k_scales,
                                       const void* v_scales, const void* k_cur, const void* v_cur,
                                       const void* page_table, const void* seq_lens,
                                       const void* cur_lens, void* out, int B, int NH, int KH,
                                       int P, int page_size, int max_pages, int layer, int C,
                                       int window, float sm_scale, float softcap, void* stream) {
  const int* pt = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(seq_lens);
  const int* cl = static_cast<const int*>(cur_lens);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PST_ARGS q, k_pages, v_pages, ks, vs, k_cur, v_cur, pt, lens, cl, out, B, NH, KH, P, page_size, \
                 max_pages, layer, C, window, sm_scale, softcap, s
  using bf16 = __nv_bfloat16;
  if (!kv_int8) {
    if (dtype == 0 && head_dim == 64) return (int)launch<float, float, 64>(PST_ARGS);
    if (dtype == 0 && head_dim == 128) return (int)launch<float, float, 128>(PST_ARGS);
    if (dtype == 1 && head_dim == 64) return (int)launch<bf16, bf16, 64>(PST_ARGS);
    if (dtype == 1 && head_dim == 128) return (int)launch<bf16, bf16, 128>(PST_ARGS);
  } else {
    if (dtype == 0 && head_dim == 64) return (int)launch<float, int8_t, 64>(PST_ARGS);
    if (dtype == 0 && head_dim == 128) return (int)launch<float, int8_t, 128>(PST_ARGS);
    if (dtype == 1 && head_dim == 64) return (int)launch<bf16, int8_t, 64>(PST_ARGS);
    if (dtype == 1 && head_dim == 128) return (int)launch<bf16, int8_t, 128>(PST_ARGS);
  }
#undef PST_ARGS
  return (int)cudaErrorInvalidValue;
}
