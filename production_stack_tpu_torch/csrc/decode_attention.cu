// Ragged paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel` of
// production_stack_tpu/ops/pallas/paged_attention.py (launched by
// `ragged_paged_attention_decode`), fp modes: bf16 and f32 pools, sliding
// window, logit softcap, the in-register burst window (k_cur/v_cur), and a
// layer index into the stacked [L, P, page, KH, D] pools (no per-layer copy).
// The int8 pool mode is not ported yet: the Python wrapper refuses scales.
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
//  - the cur_len burst entries fold in last, straight from k_cur/v_cur.
// Slots outside the live range are never staged or read (stale pool slots
// may hold NaN). Later work, not here: a split-KV (flash-decoding) variant so
// that small batches at long context fill all 132 SMs.
#include "attention_common.cuh"

namespace {

using namespace pst;

constexpr int MAX_G = 8;  // query heads per KV head, one warp each

// BK: KV slots per staged tile, 128 for rows of <= 128 bytes, else 64
// (the double-buffered K and V tiles then stay within ~140 KB of shared
// memory); lane j owns slots j, j + 32, ...

template <typename T, int D>
struct DecodeSmem {
  static constexpr int BK = D * sizeof(T) <= 128 ? 128 : 64;
  static constexpr int ROW = D + 16 / (int)sizeof(T);  // padded row, elements
  static constexpr size_t bytes(int G) {
    return 4 * (size_t)BK * ROW * sizeof(T) + (size_t)G * D * sizeof(float);
  }
};

// Fold the first n slots of a staged tile (rows of stride ROW) into one
// warp's row state (m in log2 units); slot j is visible iff vis(j).
template <typename T, int D, typename Vis>
__device__ __forceinline__ void fold_tile_lanes(const float* qs, const T* ks, const T* vs, int n, Vis vis,
                                                float softcap, float& m, float& l, float (&acc)[D / 32]) {
  constexpr int BK = DecodeSmem<T, D>::BK;
  constexpr int ROW = DecodeSmem<T, D>::ROW;
  constexpr int E = D / 32;
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
      const T* kr = ks + j * ROW;
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
  }
  l = l * alpha + warp_sum(psum);
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
  for (int u = 0; u < BK / 32; ++u) {
    const int jn = min(32, n - 32 * u);
    for (int jj = 0; jj < jn; ++jj) {
      const float pj = __shfl_sync(FULL, p[u], jj);
      if (pj == 0.f) continue;  // masked (or underflowed): its V is not read
      float v[E];
      load_e<E>(vs + (32 * u + jj) * ROW + lane * E, v);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] += pj * v[e];
    }
  }
  m = m_new;
}

template <typename T, int D>
__global__ void __launch_bounds__(32 * MAX_G, 1) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    const T* __restrict__ k_cur, const T* __restrict__ v_cur,
    const int* __restrict__ page_table, const int* __restrict__ seq_lens,
    const int* __restrict__ cur_lens, T* __restrict__ out, int NH, int KH, int P,
    int page_size, int max_pages, int layer, int C, int window, float sm_scale,
    float softcap) {
  constexpr int BK = DecodeSmem<T, D>::BK;
  constexpr int ROW = DecodeSmem<T, D>::ROW;
  constexpr int E = D / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kbuf = reinterpret_cast<T*>(smem_raw);  // [2][BK][ROW]
  T* vbuf = kbuf + 2 * BK * ROW;             // [2][BK][ROW]
  float* qs_all = reinterpret_cast<float*>(vbuf + 2 * BK * ROW);  // [G][D]

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
    T* kd = kbuf + (i & 1) * BK * ROW;
    T* vd = vbuf + (i & 1) * BK * ROW;
    auto row_of = [&](const T* pool) {
      return [=](int r) -> const T* {
        const int slot = t0 + r;
        const int pg = slot / page_size;
        return pool + layer_off + ((size_t)pt[pg] * page_size + (slot - pg * page_size)) * slot_stride;
      };
    };
    stage_rows_async<T, D>(kd, ROW, n, row_of(k_pages));
    stage_rows_async<T, D>(vd, ROW, n, row_of(v_pages));
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
    fold_tile_lanes<T, D>(qs, kbuf + (i & 1) * BK * ROW, vbuf + (i & 1) * BK * ROW, n,
                          [](int) { return true; }, softcap, m, l, acc);
    __syncthreads();  // the buffer is refilled by issue(i + 2)
  }

  // the burst window: entry j holds the token at position paged_end + j
  for (int j0 = 0; j0 < cl; j0 += BK) {
    const int n = min(BK, cl - j0);
    auto cur_row = [&](const T* cur) {
      return [=](int r) -> const T* { return cur + (((size_t)b * C + j0 + r) * KH + kh) * D; };
    };
    stage_rows<T, D>(kbuf, ROW, n, cur_row(k_cur));
    stage_rows<T, D>(vbuf, ROW, n, cur_row(v_cur));
    __syncthreads();
    const int first = paged_end + j0;
    fold_tile_lanes<T, D>(qs, kbuf, vbuf, n, [=](int j) { return first + j >= lo; }, softcap, m, l, acc);
    __syncthreads();
  }

  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < E; ++e) store_f(&out[((size_t)b * NH + h) * D + lane * E + e], acc[e] * inv);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp, const void* kc, const void* vc,
                   const int* pt, const int* lens, const int* cl, void* out, int B, int NH,
                   int KH, int P, int page_size, int max_pages, int layer, int C, int window,
                   float sm_scale, float softcap, cudaStream_t stream) {
  const int G = NH / KH;
  if (G > MAX_G) return cudaErrorInvalidValue;
  const size_t smem = DecodeSmem<T, D>::bytes(G);
  static int configured = 0;  // the largest size allowed so far; a race only repeats the call
  if ((int)smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = (int)smem;
  }
  decode_attention_kernel<T, D><<<dim3(KH, B), 32 * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const T*>(kc), static_cast<const T*>(vc), pt, lens, cl, static_cast<T*>(out),
      NH, KH, P, page_size, max_pages, layer, C, window, sm_scale, softcap);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. C = 0 means no burst window (k_cur,
// v_cur and cur_lens are then ignored). window: huge = full causal;
// softcap <= 0 = none.
extern "C" int decode_attention_launch(int dtype, int head_dim, const void* q, const void* k_pages,
                                       const void* v_pages, const void* k_cur, const void* v_cur,
                                       const void* page_table, const void* seq_lens,
                                       const void* cur_lens, void* out, int B, int NH, int KH,
                                       int P, int page_size, int max_pages, int layer, int C,
                                       int window, float sm_scale, float softcap, void* stream) {
  const int* pt = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(seq_lens);
  const int* cl = static_cast<const int*>(cur_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PST_ARGS q, k_pages, v_pages, k_cur, v_cur, pt, lens, cl, out, B, NH, KH, P, page_size, \
                 max_pages, layer, C, window, sm_scale, softcap, s
  if (dtype == 0 && head_dim == 64) return (int)launch<float, 64>(PST_ARGS);
  if (dtype == 0 && head_dim == 128) return (int)launch<float, 128>(PST_ARGS);
  if (dtype == 1 && head_dim == 64) return (int)launch<__nv_bfloat16, 64>(PST_ARGS);
  if (dtype == 1 && head_dim == 128) return (int)launch<__nv_bfloat16, 128>(PST_ARGS);
#undef PST_ARGS
  return (int)cudaErrorInvalidValue;
}
