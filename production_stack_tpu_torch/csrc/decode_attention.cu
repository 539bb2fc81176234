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
// bound. The design therefore spreads those bytes over every SM and keeps
// loads in flight while it computes:
//  - split-KV (flash-decoding): the grid is (splits, KH, B). The wrapper
//    picks the number of splits from the bucket's shapes alone
//    (ops/kernels/decode_attention.py `split_plan`, about two blocks per
//    SM), so one row at long context fills the card as 32 rows do. Block s
//    takes the s-th contiguous, tile-aligned share of its row's LIVE slots
//    [max(kv_len - window, 0), kv_len - cur_len), computed here from
//    seq_lens, so ragged rows cost their real context and a split past a
//    short row's end only writes an empty state. The last split also folds
//    the burst window;
//  - each split leaves its unnormalised state (m, l, acc[D]) in f32 scratch
//    and a second kernel, decode_attention_merge_kernel, merges a row's
//    splits in split order and writes the output (with one split the
//    kernel writes the output itself and no merge runs). No atomics: two
//    calls on the same inputs give the same bytes;
//  - bf16 q (every served model): the fold runs on the tensor cores
//    (mma.sync m16n8k16, f32 accumulators; the section "bf16 q" below):
//    the G query heads of a KV head are the rows of one 16-row A tile, so a
//    staged K/V tile serves all G heads and GQA costs no extra bytes; the
//    warps of a block split each tile's keys, 16 each; tiles of 64 slots
//    (128 for int8 rows at D = 64) ride a 3-4-stage ring of 16-byte
//    cp.async with one block barrier per tile, the lanes of a warp copying
//    whole rows; each row's page is found by a multiply and a shift
//    (PageDiv) and read from the page table a tile ahead of its copy. int8
//    pools stage their raw rows and each slot's page scales, and are
//    converted to fp16 operands in registers. At D = 256 (Gemma-2) a
//    thread's O takes 128 registers: the bf16 ring has 3 stages (202 KB,
//    one block per SM, which split_plan counts), Q's fragments sit in
//    shared memory for bf16 pools, and the int8 D order runs in two
//    128-column halves (key_row, swz, v_d);
//  - f32 q (tests and references only) keeps a CUDA-core fold in the same
//    split structure: one warp per query head, a double buffer, lane j
//    taking slots j, j + 32, ... of a tile and the whole dot product (a TF32
//    product would break the f32 tolerance); int8 scales applied in f32, the
//    K scale to the score and the V scale to the probability; f32 pools at
//    D = 256 stage 32-slot tiles (64 would take 266 KB of the 227 KB a block
//    may hold);
//  - the cur_len burst entries fold in last, straight from k_cur/v_cur.
// Slots outside the live range are never staged or read (stale pool slots
// may hold NaN): a tile's rows past the live range are zero-filled.
#include <cuda_fp16.h>

#include <type_traits>

#include "attention_common.cuh"

namespace {

using namespace pst;

constexpr int MAX_G = 8;  // query heads per KV head: one warp each in the f32 fold, A-tile rows in the mma fold

// Everything a launch passes to its blocks. Partials (splits > 1), f32:
// acc[((b * NH + h) * splits + s) * D + d], then m and l as
// ml[((b * NH + h) * splits + s) * 2 + {0, 1}].
struct DecodeArgs {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;
  const float* v_scales;
  const void* k_cur;
  const void* v_cur;
  const int* page_table;
  const int* seq_lens;
  const int* cur_lens;
  void* out;
  float* part_ml;
  float* part_acc;
  int NH, KH, P, page_size, max_pages, layer, C, window, splits;
  float sm_scale, softcap;
  PageDiv pdiv;
};

// Lets the merge kernel, launched next with programmatic stream
// serialization, start its blocks; they wait for this grid's writes.
__device__ __forceinline__ void allow_dependent_launch() { asm volatile("griddepcontrol.launch_dependents;\n" ::); }

// Row b's live slots and split s's share of them, in tiles of BK slots from
// the first visible slot: tiles [t_begin, t_end) of the row's n_tiles; the
// shares are ceil(n_tiles / splits) tiles each, the last ones short or
// empty.
struct RowSplit {
  int lo, live_end, paged_end, cl, t_begin, t_end;
};

template <int BK>
__device__ __forceinline__ RowSplit row_split(const DecodeArgs& a, int b, int s) {
  RowSplit r;
  const int kv_len = a.seq_lens[b];
  r.cl = a.C > 0 ? a.cur_lens[b] : 0;
  r.paged_end = kv_len - r.cl;        // pool slots at/after it are stale
  r.lo = max(kv_len - a.window, 0);   // first visible position
  r.live_end = min(r.paged_end, a.max_pages * a.page_size);
  const int n_tiles = r.live_end > r.lo ? (r.live_end - r.lo + BK - 1) / BK : 0;
  const int per = (n_tiles + a.splits - 1) / a.splits;
  r.t_begin = min(s * per, n_tiles);
  r.t_end = min(r.t_begin + per, n_tiles);
  return r;
}

// Pool tiles (element KV: T, or int8_t) and burst-window tiles (element T):
// BK slots per tile, 128 for rows of <= 64 bytes, 32 for rows of 1 KB (f32
// at D = 256), else 64 (the rule of split_plan in
// ops/kernels/decode_attention.py, whose split count stays right for any
// tile); rows padded by 16 bytes. Lane j owns slots j, j + 32, ...
template <typename T, typename KV, int D>
struct DecodeSmem {
  static constexpr bool QUANT = sizeof(KV) == 1;
  static constexpr int BK = D * sizeof(KV) <= 64 ? 128 : D * sizeof(KV) >= 1024 ? 32 : 64;
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

// The end of a split for head h of row b: with one split the output, else
// the split's unnormalised state. `val(i)` is acc at d = d_of(i), i < N.
template <typename T, int D, int N, typename DOf, typename Val>
__device__ __forceinline__ void store_split(const DecodeArgs& a, int b, int h, float m, float l, DOf d_of,
                                            Val val, bool write_ml) {
  const size_t row = (size_t)b * a.NH + h;
  if (a.splits == 1) {
    const float inv = 1.f / fmaxf(l, 1e-30f);  // a row with no visible key: l = 0, acc = 0 -> 0
    T* o = static_cast<T*>(a.out) + row * D;
#pragma unroll
    for (int i = 0; i < N; ++i) store_f(&o[d_of(i)], val(i) * inv);
    return;
  }
  const size_t part = row * a.splits + blockIdx.x;
  float* o = a.part_acc + part * D;
#pragma unroll
  for (int i = 0; i < N; ++i) o[d_of(i)] = val(i);
  if (write_ml) {
    a.part_ml[part * 2] = m;
    a.part_ml[part * 2 + 1] = l;
  }
}

// CUDA-core fold: one block per (split, KV head, row), one warp per query
// head.
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(32 * MAX_G) decode_attention_kernel(const DecodeArgs a) {
  using S = DecodeSmem<T, KV, D>;
  constexpr int BK = S::BK;
  constexpr int ROW = S::ROW;
  constexpr int E = D / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  allow_dependent_launch();
  KV* kbuf = reinterpret_cast<KV*>(smem_raw);  // [2][BK][ROW]
  KV* vbuf = kbuf + 2 * BK * ROW;              // [2][BK][ROW]
  float* kscl = reinterpret_cast<float*>(smem_raw + S::TILES);  // [2][BK], int8 pools
  float* vscl = kscl + 2 * BK;
  float* qs_all = reinterpret_cast<float*>(smem_raw + S::TILES + S::SCALES);  // [G][D]

  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int KH = a.KH;
  const int G = a.NH / KH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = kh * G + warp;  // blockDim.x == 32 * G
  const RowSplit rs = row_split<BK>(a, b, blockIdx.x);
  const bool last_split = blockIdx.x == a.splits - 1;

  const T* q = static_cast<const T*>(a.q);
  float* qs = qs_all + warp * D;
  for (int d = lane; d < D; d += 32) qs[d] = to_f(q[((size_t)b * a.NH + h) * D + d]) * a.sm_scale;
  float m = NEG_INF, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  const KV* k_pages = static_cast<const KV*>(a.k_pages);
  const KV* v_pages = static_cast<const KV*>(a.v_pages);
  const int page_size = a.page_size;
  const size_t slot_stride = (size_t)KH * D;  // elements between pool slots
  const size_t layer_off = (size_t)a.layer * a.P * page_size * slot_stride + (size_t)kh * D;
  const int* pt = a.page_table + (size_t)b * a.max_pages;
  const int n_tiles = rs.t_end - rs.t_begin;

  auto issue = [&](int i) {
    const int t0 = rs.lo + (rs.t_begin + i) * BK;
    const int n = min(BK, rs.live_end - t0);
    KV* kd = kbuf + (i & 1) * BK * ROW;
    KV* vd = vbuf + (i & 1) * BK * ROW;
    auto row_of = [&](const KV* pool) {
      return [=](int r) -> const KV* {
        const int slot = t0 + r;
        const int pg = a.pdiv.page(slot);
        return pool + layer_off + ((size_t)pt[pg] * page_size + (slot - pg * page_size)) * slot_stride;
      };
    };
    stage_rows_async<KV, D>(kd, ROW, n, row_of(k_pages));
    stage_rows_async<KV, D>(vd, ROW, n, row_of(v_pages));
    if constexpr (S::QUANT) {
      // each slot's page scales, in the same asynchronous group as its rows
      for (int r = threadIdx.x; r < n; r += blockDim.x) {
        const size_t sc = ((size_t)a.layer * a.P + pt[a.pdiv.page(t0 + r)]) * KH + kh;
        cp_async4(kscl + (i & 1) * BK + r, a.k_scales + sc);
        cp_async4(vscl + (i & 1) * BK + r, a.v_scales + sc);
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
    const int n = min(BK, rs.live_end - (rs.lo + (rs.t_begin + i) * BK));
    fold_tile_lanes<KV, D, BK, ROW, S::QUANT>(qs, kbuf + (i & 1) * BK * ROW, vbuf + (i & 1) * BK * ROW,
                                              kscl + (i & 1) * BK, vscl + (i & 1) * BK, n,
                                              [](int) { return true; }, a.softcap, m, l, acc);
    __syncthreads();  // the buffer is refilled by issue(i + 2)
  }

  // the burst window (in q's dtype, never quantized), folded by the last
  // split: entry j holds the token at position paged_end + j
  if (last_split) {
    const T* k_cur = static_cast<const T*>(a.k_cur);
    const T* v_cur = static_cast<const T*>(a.v_cur);
    T* wk = reinterpret_cast<T*>(smem_raw);
    T* wv = wk + S::WBK * S::WROW;
    for (int j0 = 0; j0 < rs.cl; j0 += S::WBK) {
      const int n = min(S::WBK, rs.cl - j0);
      auto cur_row = [&](const T* cur) {
        return [=](int r) -> const T* { return cur + (((size_t)b * a.C + j0 + r) * KH + kh) * D; };
      };
      stage_rows<T, D>(wk, S::WROW, n, cur_row(k_cur));
      stage_rows<T, D>(wv, S::WROW, n, cur_row(v_cur));
      __syncthreads();
      const int first = rs.paged_end + j0;
      const int lo = rs.lo;
      fold_tile_lanes<T, D, S::WBK, S::WROW, false>(qs, wk, wv, nullptr, nullptr, n,
                                                    [=](int j) { return first + j >= lo; }, a.softcap, m, l,
                                                    acc);
      __syncthreads();
    }
  }

  store_split<T, D, E>(a, b, h, m, l, [&](int e) { return lane * E + e; }, [&](int e) { return acc[e]; },
                    lane == 0);
}

// Merge a row's split states in split order: one warp per (row, head);
// the lanes first take the splits' m and l (lane i: splits i, i + 32, ...)
// and leave each split's weight exp2(m_s - M) in shared memory, then split
// D and sum the splits' acc, several loads in flight. Grid (ceil(NH / 4),
// B), 128 threads; dynamic shared memory 4 * splits floats.
template <typename T, int D>
__global__ void __launch_bounds__(128) decode_attention_merge_kernel(const float* __restrict__ ml,
                                                                     const float* __restrict__ acc,
                                                                     T* __restrict__ out, int NH, int splits) {
  constexpr int E = D / 32;
  extern __shared__ float wts[];  // [4 warps][splits]
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the split kernel's writes are visible
  const int warp = threadIdx.x >> 5;
  const int h = blockIdx.x * 4 + warp;
  const int lane = threadIdx.x & 31;
  if (h >= NH) return;
  const size_t row = (size_t)blockIdx.y * NH + h;
  const float* pm = ml + row * splits * 2;
  float* w = wts + warp * splits;
  float M = NEG_INF;
  for (int s = lane; s < splits; s += 32) M = fmaxf(M, pm[2 * s]);
  M = warp_max(M);
  float L = 0.f;
  for (int s = lane; s < splits; s += 32) {
    const float c = exp2f(pm[2 * s] - M);  // an empty split: m = NEG_INF, l = 0, acc = 0
    w[s] = c;
    L += c * pm[2 * s + 1];
  }
  L = warp_sum(L);  // lane sums in a fixed order: the same bytes every call
  __syncwarp();
  const float* pa = acc + row * splits * D + lane * E;
  float o[E];
#pragma unroll
  for (int e = 0; e < E; ++e) o[e] = 0.f;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) {
    float v[E];
    load_e<E>(pa + (size_t)s * D, v);
    const float c = w[s];
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] += c * v[e];
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
#pragma unroll
  for (int e = 0; e < E; ++e) store_f(&out[row * D + lane * E + e], o[e] * inv);
}

// ---- bf16 q: the fold on tensor cores ------------------------------------
//
// mma.sync m16n8k16 with f32 accumulators. The G <= 8 query heads of the
// group are rows 0..G-1 of the 16-row A tile (the other rows are zero: decode
// does ~4 flops a byte, so padding rows cost nothing, where wgmma's 64 rows
// would be 8x padding); S = Q K^T takes 16 keys as two n8 blocks, O += P V
// reuses the S accumulators as P's A operand (FlashAttention-2's layout).
// A block has one warp per 16 keys of a tile (BK / 16 warps), so no two
// warps read the same K or V row; each warp keeps its own (m, l, acc) and
// the warps merge once, at the end of the split, through shared memory.
//  - bf16 pools: K by ldmatrix, V by ldmatrix.trans, from rows padded by 16
//    bytes (the 8 rows of an 8x8 matrix hit 8 distinct 16-byte bank groups).
//  - int8 pools: the raw rows ride the ring (half the bytes a slot: 128-slot
//    tiles at D = 64) with their slots' page scales, and each thread turns
//    the bytes it loads into fp16 operands in registers (int8 is exact in
//    fp16: one byte permute puts b ^ 0x80 under the exponent of 1024, one
//    half2 subtraction of 1152 leaves b), so the pool's products run in
//    fp16 with q converted to fp16 (exact for 2^-14 <= |q| <= 65504;
//    smaller values round at 2^-24). A thread loads whole 16-byte (K) or
//    8/16-byte (V) pieces of a row, so the order of D inside a k-step
//    (load_q, s_int8), the keys behind S's columns (key_row) and the D of
//    P V's columns (v_d) are permuted, consistently on both operands; rows
//    are XOR-swizzled by 16-byte chunk (swz) and key_row picks the rows so
//    that those loads are free of bank conflicts. The K scale multiplies
//    the score column and the V scale the probability before it is rounded
//    to fp16 for P V, in f32.
// The burst window stays bf16 and folds with the bf16 path.

template <typename KV, int D>
struct MmaSmem {
  static constexpr bool QUANT = sizeof(KV) == 1;
  static constexpr int BK = D * (int)sizeof(KV) <= 64 ? 128 : 64;  // split_plan's tile
  static constexpr int NW = BK / 16;                              // warps: 16 keys each per tile
  static constexpr int THREADS = 32 * NW;
  static constexpr int WIN_BK = BK;                               // window entries per window tile
  static constexpr int ROWB = QUANT ? D : 2 * D + 16;             // bytes per staged pool row
  static constexpr int NS = QUANT || D >= 128 ? 3 : 4;            // ring stages (4 bf16 stages at D = 256: 270 KB)
  static constexpr int TILE = BK * ROWB;                          // one K or V tile
  static constexpr int STAGE = 2 * TILE + (QUANT ? 2 * BK * 4 : 0);  // K, V, their slots' scales
  static constexpr int WROWB = 2 * D + 16;                        // window rows, bf16
  static constexpr int WIN = 2 * WIN_BK * WROWB;
  static constexpr int MSTRIDE = D + 8;                           // floats per merged row
  static constexpr int MERGE = NW * 8 * (MSTRIDE + 2) * 4;
  static constexpr int RING = NS * STAGE;
  static constexpr int BODY = RING > WIN ? (RING > MERGE ? RING : MERGE) : (WIN > MERGE ? WIN : MERGE);
  // Q's A fragments [D / 16][32 lanes][2 words] in shared memory for bf16
  // pools at D = 256, where O's 128 accumulator registers a thread leave no
  // room for them (ptxas spilled 112 bytes; int8 pools keep Q in registers:
  // their 96 bytes of spill cost less than the shared-memory reads)
  static constexpr bool Q_SMEM = D == 256 && !QUANT;
  static constexpr int QOFF = BODY;
  static constexpr int bytes = BODY + (Q_SMEM ? D / 16 * 32 * 8 : 0);
  static_assert(bytes <= 232448, "a block holds at most 227 KB of shared memory");
};

// int8 layouts (D = 64 | 128 | 256). key_row(n): the tile row behind S
// column n (0..15) of a 16-key chunk; XOR swizzle of the 16-byte chunk c of
// row r. A 256-byte row (D = 256) spans the 32 banks twice, so chunks c and
// c + 8 share a bank group: bit 3 of c flips bit 1 of the group, which keeps
// s_int8's chunks 4t + i of rows g and pv_int8's chunks g, 8 + g of rows
// 2t + e apart, eight groups for the eight lanes of each 16-byte phase.
template <int D>
__device__ __forceinline__ int key_row(int n) {
  return D == 64 ? n ^ ((n >> 2) & 1) : n;
}
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return D == 64 ? c ^ (r & 2) : D == 128 ? c ^ (r & 7) : c ^ ((c >> 2) & 2) ^ (r & 7);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// bytes sel of the word x (already XORed with 0x80808080) as two fp16: the
// byte permute makes 1024 + (b + 128), the subtraction leaves b, exactly
__device__ __forceinline__ uint32_t i8pair_f16(uint32_t x, uint32_t sel) {
  const uint32_t h = __byte_perm(x, 0x64646464u, sel);
  __half2 v = __hsub2(*reinterpret_cast<const __half2*>(&h), __float2half2_rn(1152.f));
  return *reinterpret_cast<uint32_t*>(&v);
}
// the byte-pair selector of int8x2 operand j (0 or 1) of a word: bytes 2j, 2j + 1
constexpr uint32_t SEL_LO = 0x4140u, SEL_HI = 0x4342u;

// S (two n8 blocks of 16 keys at tile row kb) = Q K^T from a bf16 tile;
// qf(ks, a) gives q's A fragment of k-step ks
template <int D, int ROWB, typename QF>
__device__ __forceinline__ void s_bf16(float (&s)[2][4], QF qf, uint32_t tile, int kb) {
  const int lane = threadIdx.x & 31;
  const uint32_t base = tile + (kb + (lane & 7) + ((lane >> 4) << 3)) * ROWB + ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t r[4], qa[4];
    ldmatrix_x4(r, base + ks * 32);
    qf(ks, qa);
    mma_bf16(s[0], qa, r[0], r[1]);
    mma_bf16(s[1], qa, r[2], r[3]);
  }
}

// O += P V for 16 keys at tile row kb of a bf16 tile
template <int D, int ROWB>
__device__ __forceinline__ void pv_bf16(float (&o)[D / 8][4], const uint32_t (&pa)[4], uint32_t tile, int kb) {
  const int lane = threadIdx.x & 31;
  const uint32_t base = tile + (kb + (lane & 7) + ((lane >> 3) & 1) * 8) * ROWB + (lane >> 4) * 16;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, base + j * 32);
    mma_bf16(o[2 * j], pa, r[0], r[1]);
    mma_bf16(o[2 * j + 1], pa, r[2], r[3]);
  }
}

// S from an int8 tile (rows of D bytes, swizzled). Thread (g, t) loads the
// D / 4 bytes [t D / 4, (t + 1) D / 4) of key row key_row(8 nb + g); k-step
// ks takes its bytes 4 ks .. 4 ks + 3, which q's fragment matches (k_d).
template <int D, typename QF>
__device__ __forceinline__ void s_int8(float (&s)[2][4], QF qf, const unsigned char* tile, int kb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nb = 0; nb < 2; ++nb) {
    const int r = kb + key_row<D>(8 * nb + g);
    uint32_t w[D / 16];
#pragma unroll
    for (int i = 0; i < D / 64; ++i) {
      const uint4 u = *reinterpret_cast<const uint4*>(tile + r * D + swz<D>(r, t * (D / 64) + i) * 16);
      w[4 * i] = u.x ^ 0x80808080u;
      w[4 * i + 1] = u.y ^ 0x80808080u;
      w[4 * i + 2] = u.z ^ 0x80808080u;
      w[4 * i + 3] = u.w ^ 0x80808080u;
    }
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t qa[4];
      qf(ks, qa);
      mma_f16(s[nb], qa, i8pair_f16(w[ks], SEL_LO), i8pair_f16(w[ks], SEL_HI));
    }
  }
}

// O += P V for 16 keys of an int8 tile. Thread (g, t) loads its bytes of
// its four key rows (P's columns 2t, 2t + 1, 8 + 2t, 9 + 2t): at D = 64 the
// 8 bytes [8 g, 8 g + 8); at D = 128 | 256 the 16 bytes [16 g, 16 g + 16)
// of each 128-column half, one half at a time. n8 block db then holds d =
// v_d(db, column).
template <int D>
__device__ __forceinline__ void pv_int8(float (&o)[D / 8][4], const uint32_t (&pa)[4], const unsigned char* tile,
                                        int kb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr int HD = D < 128 ? D : 128;  // columns per half
  constexpr int W = HD / 32;             // words per thread per row of a half
#pragma unroll
  for (int h = 0; h < D / HD; ++h) {
    uint32_t w[4][W];  // rows of columns 2t, 2t + 1, 8 + 2t, 9 + 2t
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = kb + key_row<D>(8 * (k >> 1) + 2 * t + (k & 1));
      if constexpr (D == 64) {
        const uint2 u = *reinterpret_cast<const uint2*>(tile + r * D + swz<D>(r, g >> 1) * 16 + (g & 1) * 8);
        w[k][0] = u.x ^ 0x80808080u;
        w[k][1] = u.y ^ 0x80808080u;
      } else {
        const uint4 u = *reinterpret_cast<const uint4*>(tile + r * D + swz<D>(r, g + 8 * h) * 16);
        w[k][0] = u.x ^ 0x80808080u;
        w[k][1] = u.y ^ 0x80808080u;
        w[k][2] = u.z ^ 0x80808080u;
        w[k][3] = u.w ^ 0x80808080u;
      }
    }
#pragma unroll
    for (int db = 0; db < HD / 8; db += 2) {
      // bytes db, db + 1 of the rows, interleaved (row a, row b) per byte
      const int wi = db >> 2, sh = db & 3;
      const uint32_t sel = (uint32_t)(sh | (4 + sh) << 4 | (sh + 1) << 8 | (5 + sh) << 12);
      const uint32_t lo = __byte_perm(w[0][wi], w[1][wi], sel);  // keys of columns 2t, 2t + 1
      const uint32_t hi = __byte_perm(w[2][wi], w[3][wi], sel);  // 8 + 2t, 9 + 2t
      mma_f16(o[HD / 8 * h + db], pa, i8pair_f16(lo, SEL_LO), i8pair_f16(hi, SEL_LO));
      mma_f16(o[HD / 8 * h + db + 1], pa, i8pair_f16(lo, SEL_HI), i8pair_f16(hi, SEL_HI));
    }
  }
}

// O += P V for 16 window entries of a bf16 tile (row kb, stride ROWB bytes)
// in the int8 pools' column order (v_d): thread (g, t) reads the values
// [HD h + g HD / 8, HD h + (g + 1) HD / 8) of its four entries, one
// HD-column half h at a time (HD = min(D, 128))
template <int D, int ROWB>
__device__ __forceinline__ void pv_bf16_vd(float (&o)[D / 8][4], const uint32_t (&pa)[4], const unsigned char* tile,
                                           int kb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr int HD = D < 128 ? D : 128;
  constexpr int W = HD / 16;  // bf16 pairs per thread per row of a half
#pragma unroll
  for (int h = 0; h < D / HD; ++h) {
    uint32_t w[4][W];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint4* p = reinterpret_cast<const uint4*>(tile + (kb + 8 * (k >> 1) + 2 * t + (k & 1)) * ROWB +
                                                      (HD * h + g * HD / 8) * 2);
#pragma unroll
      for (int i = 0; i < W / 4; ++i) {
        const uint4 u = p[i];
        w[k][4 * i] = u.x;
        w[k][4 * i + 1] = u.y;
        w[k][4 * i + 2] = u.z;
        w[k][4 * i + 3] = u.w;
      }
    }
#pragma unroll
    for (int db = 0; db < HD / 8; ++db) {
      const uint32_t sel = db & 1 ? 0x7632u : 0x5410u;  // the high or low bf16 of each word
      mma_bf16(o[HD / 8 * h + db], pa, __byte_perm(w[0][db >> 1], w[1][db >> 1], sel),
               __byte_perm(w[2][db >> 1], w[3][db >> 1], sel));
    }
  }
}

// the d of accumulator column c (0..7) of n8 block db: int8 pools take each
// HD-column half (HD = min(D, 128)) in c-major order
template <typename KV, int D>
__device__ __forceinline__ int v_d(int db, int c) {
  constexpr int NBH = (D < 128 ? D : 128) / 8;  // n8 blocks per half
  if (sizeof(KV) != 1) return 8 * db + c;
  return (db / NBH) * 8 * NBH + c * NBH + db % NBH;
}

// q's A fragments (rows g < G of the 16; rows g + 8 stay zero). bf16 in
// the natural order of D; for int8 pools fp16, k-step ks holding d =
// t D / 4 + 4 ks + {0, 1} (k = 2t, 2t + 1) and {2, 3} (k = 2t + 8, 2t + 9).
template <bool F16, int D>
__device__ __forceinline__ void load_q(uint32_t (&qa)[D / 16][4], const __nv_bfloat16* qrow, bool live) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    qa[ks][1] = qa[ks][3] = 0u;
    qa[ks][0] = qa[ks][2] = 0u;
    if (!live) continue;
    if constexpr (F16) {
      const uint2 u = *reinterpret_cast<const uint2*>(qrow + t * (D / 4) + 4 * ks);
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      qa[ks][0] = pack_f16(x.x, x.y);
      qa[ks][2] = pack_f16(y.x, y.y);
    } else {
      qa[ks][0] = *reinterpret_cast<const uint32_t*>(qrow + 16 * ks + 2 * t);
      qa[ks][2] = *reinterpret_cast<const uint32_t*>(qrow + 16 * ks + 8 + 2 * t);
    }
  }
}

// load_q's fragments of every lane into shared memory, [ks][lane] as words
// 0 and 2 (the others are zero), by the first warp; then a block barrier
template <bool F16, int D>
__device__ __forceinline__ void stage_q(unsigned char* dst, const __nv_bfloat16* qrow, bool live) {
  if (threadIdx.x < 32) {
    uint32_t qa[D / 16][4];
    load_q<F16, D>(qa, qrow, live);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      reinterpret_cast<uint2*>(dst)[ks * 32 + threadIdx.x] = make_uint2(qa[ks][0], qa[ks][2]);
  }
  __syncthreads();
}

// q's A fragment of k-step ks from registers (qa) or shared memory (qs)
template <bool SMEM, int D>
__device__ __forceinline__ void q_frag(uint32_t (&f)[4], const uint32_t (&qa)[SMEM ? 1 : D / 16][4],
                                       const unsigned char* qs, int ks) {
  if constexpr (SMEM) {
    const uint2 v = reinterpret_cast<const uint2*>(qs)[ks * 32 + (threadIdx.x & 31)];
    f[0] = v.x;
    f[2] = v.y;
    f[1] = f[3] = 0u;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = qa[ks][e];
  }
}

// One warp's online-softmax state: row g's m (log2 units) and partial l
// over this thread's columns; acc of row g in columns 2t, 2t + 1 of each
// n8 block (registers 2, 3 belong to the zero rows).
template <int D>
struct WarpState {
  float m, l;
  float o[D / 8][4];
};

// Fold 16 keys whose raw scores are s (n8 block nb, columns 2t + e) into
// the warp's state; ok(nb, e) says a column is visible, kscale/vscale give
// its K and V scales (1 for fp), pv(pa) runs O += P V.
template <int D, bool F16, typename Ok, typename KScale, typename VScale, typename PV>
__device__ __forceinline__ void softmax_fold(WarpState<D>& st, float (&s)[2][4], Ok ok, KScale kscale, VScale vscale,
                                             float qk_scale, float sm_scale, float softcap, PV pv) {
  float mt = -INFINITY;
#pragma unroll
  for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x = s[nb][e] * kscale(nb, e);
      x = softcap > 0.f ? softcap * tanhf(x * sm_scale / softcap) * LOG2E : x * qk_scale;
      s[nb][e] = ok(nb, e) ? x : -INFINITY;
      mt = fmaxf(mt, s[nb][e]);
    }
  }
  mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 1));
  mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 2));
  const float m_new = fmaxf(st.m, mt);
  const float alpha = fast_exp2(st.m - m_new);
  st.m = m_new;
  st.l *= alpha;
#pragma unroll
  for (int db = 0; db < D / 8; ++db) {
    st.o[db][0] *= alpha;
    st.o[db][1] *= alpha;
  }
  float p[2][2];
#pragma unroll
  for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      p[nb][e] = fast_exp2(s[nb][e] - m_new);  // a masked column: exp2(-inf) = 0
      st.l += p[nb][e];
      p[nb][e] *= vscale(nb, e);
    }
  }
  uint32_t pa[4];
  pa[0] = F16 ? pack_f16(p[0][0], p[0][1]) : pack_bf16(p[0][0], p[0][1]);
  pa[2] = F16 ? pack_f16(p[1][0], p[1][1]) : pack_bf16(p[1][0], p[1][1]);
  pa[1] = pa[3] = 0u;
  pv(pa);
}

template <typename KV, int D>
__global__ void __launch_bounds__(MmaSmem<KV, D>::THREADS) decode_attention_mma_kernel(const DecodeArgs a) {
  using S = MmaSmem<KV, D>;
  constexpr bool QUANT = S::QUANT;
  constexpr int BK = S::BK, ROWB = S::ROWB, NS = S::NS, NW = S::NW, THREADS = S::THREADS;
  constexpr int CH = D * (int)sizeof(KV) / 16;  // 16-byte chunks per pool row
  constexpr int RPT = BK * CH / THREADS;    // chunks a thread copies per tile, one row each
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];

  allow_dependent_launch();
  const int kh = blockIdx.y, b = blockIdx.z;
  const int KH = a.KH, G = a.NH / KH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const RowSplit rs = row_split<BK>(a, b, blockIdx.x);
  const int n_tiles = rs.t_end - rs.t_begin;
  const float qk_scale = a.sm_scale * LOG2E;

  const bf16* qrow = static_cast<const bf16*>(a.q) + ((size_t)b * a.NH + kh * G + min(g, G - 1)) * D;
  uint32_t qa[S::Q_SMEM ? 1 : D / 16][4];
  unsigned char* qs = smem + S::QOFF;
  if constexpr (S::Q_SMEM) {
    stage_q<QUANT, D>(qs, qrow, g < G);
  } else {
    load_q<QUANT, D>(qa, qrow, g < G);
  }
  auto qf = [&](int ks, uint32_t(&f)[4]) { q_frag<S::Q_SMEM, D>(f, qa, qs, ks); };
  WarpState<D> st;
  st.m = NEG_INF;
  st.l = 0.f;
#pragma unroll
  for (int db = 0; db < D / 8; ++db) st.o[db][0] = st.o[db][1] = st.o[db][2] = st.o[db][3] = 0.f;

  const unsigned char* k_pages = static_cast<const unsigned char*>(a.k_pages);
  const unsigned char* v_pages = static_cast<const unsigned char*>(a.v_pages);
  const int page_size = a.page_size;
  const size_t slot_stride = (size_t)KH * D * sizeof(KV);  // bytes between pool slots
  const size_t layer_off = ((size_t)a.layer * a.P * page_size * KH + kh) * D * sizeof(KV);
  const int* pt = a.page_table + (size_t)b * a.max_pages;
  // chunk k of this thread's copies: row (k * 128 + tid) / CH, so the lanes
  // of a warp read whole rows, contiguous 16-byte pieces
  auto row_of = [&](int k) { return (k * THREADS + tid) / CH; };
  auto first_slot = [&](int i) { return rs.lo + (rs.t_begin + i) * BK; };

  // the pool page of each row this thread copies for tile i (-1 past the
  // live range), loaded a tile ahead of its copies so that the copies
  // never wait on the page table
  int pid[RPT];
  auto lookup = [&](int i) {
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int slot = first_slot(i) + row_of(k);
      pid[k] = i < n_tiles && slot < rs.live_end ? pt[a.pdiv.page(slot)] : -1;
    }
  };
  // copy tile i into its ring stage (rows past the live range as zeros),
  // then commit; past the last tile only the (empty) commit
  auto issue = [&](int i) {
    if (i < n_tiles) {
      unsigned char* st_k = smem + (i % NS) * S::STAGE;
      unsigned char* st_v = st_k + S::TILE;
      float* scl = reinterpret_cast<float*>(st_v + S::TILE);
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int r = row_of(k), c = (k * THREADS + tid) % CH;
        const int slot = first_slot(i) + r;
        const bool ok = pid[k] >= 0;
        const int pg = a.pdiv.page(slot);
        const size_t off = ok ? layer_off + ((size_t)pid[k] * page_size + (slot - pg * page_size)) * slot_stride : 0;
        const int pc = QUANT ? swz<D>(r, c) : c;
        cp_async16_or_zero(st_k + r * ROWB + pc * 16, k_pages + off + c * 16, ok);
        cp_async16_or_zero(st_v + r * ROWB + pc * 16, v_pages + off + c * 16, ok);
        if constexpr (QUANT) {
          if (c == 0) {  // the row's page scales
            const size_t sc = ok ? ((size_t)a.layer * a.P + pid[k]) * KH + kh : 0;
            cp_async4_or_zero(scl + r, a.k_scales + sc, ok);
            cp_async4_or_zero(scl + BK + r, a.v_scales + sc, ok);
          }
        }
      }
    }
    cp_async_commit();
  };

  lookup(0);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    issue(i);
    lookup(i + 1);
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // tile i landed for every thread; stage (i - 1) % NS is free
    issue(i + NS - 1);
    lookup(i + NS);
    const int n = min(BK, rs.live_end - first_slot(i));  // live rows of the tile
    const int kb = warp * 16;  // the warp's 16 keys
    if (kb >= n) continue;     // warp-uniform: all of them are past the live range
    const unsigned char* st_k = smem + (i % NS) * S::STAGE;
    const unsigned char* st_v = st_k + S::TILE;
    const float* ksc = reinterpret_cast<const float*>(st_v + S::TILE);
    const float* vsc = ksc + BK;
    float s[2][4] = {};
    auto row = [&](int nb, int e) { return kb + (QUANT ? key_row<D>(8 * nb + 2 * t + e) : 8 * nb + 2 * t + e); };
    auto ok = [&](int nb, int e) { return row(nb, e) < n; };  // rows past n are zeros
    if constexpr (QUANT) {
      s_int8<D>(s, qf, st_k, kb);
      softmax_fold<D, true>(
          st, s, ok, [&](int nb, int e) { return ksc[row(nb, e)]; }, [&](int nb, int e) { return vsc[row(nb, e)]; },
          qk_scale, a.sm_scale, a.softcap, [&](const uint32_t(&pa)[4]) { pv_int8<D>(st.o, pa, st_v, kb); });
    } else {
      s_bf16<D, ROWB>(s, qf, smem_u32(st_k), kb);
      softmax_fold<D, false>(
          st, s, ok, [](int, int) { return 1.f; }, [](int, int) { return 1.f; }, qk_scale, a.sm_scale, a.softcap,
          [&](const uint32_t(&pa)[4]) { pv_bf16<D, ROWB>(st.o, pa, smem_u32(st_v), kb); });
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free

  // the burst window (bf16), folded by the last split: entry j holds the
  // token at position paged_end + j
  if (blockIdx.x == a.splits - 1 && rs.cl > 0) {
    uint32_t qb[S::Q_SMEM ? 1 : D / 16][4];
    if constexpr (QUANT) {
      load_q<false, D>(qb, qrow, g < G);
    } else if constexpr (!S::Q_SMEM) {  // else qs holds them
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) qb[ks][e] = qa[ks][e];
    }
    auto qbf = [&](int ks, uint32_t(&f)[4]) { q_frag<S::Q_SMEM, D>(f, qb, qs, ks); };
    constexpr int WCH = 2 * D / 16;  // 16-byte chunks per window row
    const unsigned char* k_cur = static_cast<const unsigned char*>(a.k_cur);
    const unsigned char* v_cur = static_cast<const unsigned char*>(a.v_cur);
    unsigned char* wk = smem;
    unsigned char* wv = smem + S::WIN_BK * S::WROWB;
    for (int j0 = 0; j0 < rs.cl; j0 += S::WIN_BK) {
      const int n = min(S::WIN_BK, rs.cl - j0);
#pragma unroll
      for (int k = 0; k < S::WIN_BK * WCH / THREADS; ++k) {
        const int r = (k * THREADS + tid) / WCH, c = (k * THREADS + tid) % WCH;
        const bool ok = r < n;
        const size_t off = ok ? (((size_t)b * a.C + j0 + r) * KH + kh) * D * 2 : 0;
        cp_async16_or_zero(wk + r * S::WROWB + c * 16, k_cur + off + c * 16, ok);
        cp_async16_or_zero(wv + r * S::WROWB + c * 16, v_cur + off + c * 16, ok);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      const int kb = warp * 16;
      if (kb < n) {
        const int first = rs.paged_end + j0, lo = rs.lo;
        float s[2][4] = {};
        s_bf16<D, S::WROWB>(s, qbf, smem_u32(wk), kb);
        softmax_fold<D, false>(
            st, s,
            [&](int nb, int e) {
              const int j = kb + 8 * nb + 2 * t + e;
              return j < n && first + j >= lo;
            },
            [](int, int) { return 1.f; }, [](int, int) { return 1.f; }, qk_scale, a.sm_scale, a.softcap,
            [&](const uint32_t(&pa)[4]) {
              if constexpr (QUANT) {  // acc columns in the pool's order
                pv_bf16_vd<D, S::WROWB>(st.o, pa, wv, kb);
              } else {
                pv_bf16<D, S::WROWB>(st.o, pa, smem_u32(wv), kb);
              }
            });
      }
      __syncthreads();  // the window tile is refilled, or the merge below reuses it
    }
  }

  // merge the warps' states: [warp][row] m and l, then acc rows
  st.l += __shfl_xor_sync(FULL, st.l, 1);
  st.l += __shfl_xor_sync(FULL, st.l, 2);
  float* mm = reinterpret_cast<float*>(smem);
  float* ll = mm + NW * 8;
  float* acc = ll + NW * 8;
  const int wr = warp * 8 + g;
  if (t == 0) {
    mm[wr] = st.m;
    ll[wr] = st.l;
  }
#pragma unroll
  for (int db = 0; db < D / 8; ++db) {
    acc[wr * S::MSTRIDE + v_d<KV, D>(db, 2 * t)] = st.o[db][0];
    acc[wr * S::MSTRIDE + v_d<KV, D>(db, 2 * t + 1)] = st.o[db][1];
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, mm[w * 8 + r]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = fast_exp2(mm[w * 8 + r] - M);
      L += c * ll[w * 8 + r];
      O += c * acc[(w * 8 + r) * S::MSTRIDE + d];
    }
    store_split<bf16, D, 1>(a, b, kh * G + r, M, L, [&](int) { return d; }, [&](int) { return O; }, d == 0);
  }
}

// allow the kernel `smem` bytes of dynamic shared memory (once per size)
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, int& configured) {
  if ((int)smem > configured) {  // a race only repeats the call
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = (int)smem;
  }
  return cudaSuccess;
}

template <typename T, typename KV, int D>
cudaError_t launch(const DecodeArgs& a, int B, cudaStream_t stream) {
  const int G = a.NH / a.KH;
  if (G > MAX_G || a.splits < 1) return cudaErrorInvalidValue;
  static int configured = 0;
  cudaError_t err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {  // the tensor-core fold
    const size_t smem = MmaSmem<KV, D>::bytes;
    err = allow_smem(decode_attention_mma_kernel<KV, D>, smem, configured);
    if (err != cudaSuccess) return err;
    decode_attention_mma_kernel<KV, D><<<dim3(a.splits, a.KH, B), MmaSmem<KV, D>::THREADS, smem, stream>>>(a);
  } else {  // f32 q: the CUDA-core fold (a TF32 product would break the f32 tolerance)
    const size_t smem = DecodeSmem<T, KV, D>::bytes(G);
    err = allow_smem(decode_attention_kernel<T, KV, D>, smem, configured);
    if (err != cudaSuccess) return err;
    decode_attention_kernel<T, KV, D><<<dim3(a.splits, a.KH, B), 32 * G, smem, stream>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  // programmatic stream serialization: the merge's blocks launch while the
  // split kernel runs and wait for its writes (griddepcontrol.wait)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.NH + 3) / 4, B);
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = 4 * a.splits * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_attention_merge_kernel<T, D>, (const float*)a.part_ml,
                            (const float*)a.part_acc, static_cast<T*>(a.out), a.NH, a.splits);
}

}  // namespace

// dtype (of q, the burst window and out): 0 = float32, 1 = bfloat16. kv_int8
// = 0: pools of that dtype (k_scales/v_scales ignored); 1: int8 pools with
// f32 scales [L, P, KH]. C = 0 means no burst window (k_cur, v_cur and
// cur_lens are then ignored). window: huge = full causal; softcap <= 0 =
// none. splits >= 1 blocks per (KV head, row); with splits > 1, partials
// holds B * NH * splits * (D + 2) f32 of scratch.
extern "C" int decode_attention_launch(int dtype, int kv_int8, int head_dim, const void* q,
                                       const void* k_pages, const void* v_pages, const void* k_scales,
                                       const void* v_scales, const void* k_cur, const void* v_cur,
                                       const void* page_table, const void* seq_lens,
                                       const void* cur_lens, void* out, int B, int NH, int KH,
                                       int P, int page_size, int max_pages, int layer, int C,
                                       int window, float sm_scale, float softcap, int splits,
                                       void* partials, void* stream) {
  DecodeArgs a;
  a.q = q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.k_scales = static_cast<const float*>(k_scales);
  a.v_scales = static_cast<const float*>(v_scales);
  a.k_cur = k_cur;
  a.v_cur = v_cur;
  a.page_table = static_cast<const int*>(page_table);
  a.seq_lens = static_cast<const int*>(seq_lens);
  a.cur_lens = static_cast<const int*>(cur_lens);
  a.out = out;
  a.part_acc = static_cast<float*>(partials);
  a.part_ml = a.part_acc ? a.part_acc + (size_t)B * NH * splits * head_dim : nullptr;
  a.NH = NH;
  a.KH = KH;
  a.P = P;
  a.page_size = page_size;
  a.max_pages = max_pages;
  a.layer = layer;
  a.C = C;
  a.window = window;
  a.splits = splits;
  a.sm_scale = sm_scale;
  a.softcap = softcap;
  a.pdiv = page_div(page_size);
  if (splits > 1 && !partials) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (!kv_int8) {
    if (dtype == 0 && head_dim == 64) return (int)launch<float, float, 64>(a, B, s);
    if (dtype == 0 && head_dim == 128) return (int)launch<float, float, 128>(a, B, s);
    if (dtype == 1 && head_dim == 64) return (int)launch<bf16, bf16, 64>(a, B, s);
    if (dtype == 1 && head_dim == 128) return (int)launch<bf16, bf16, 128>(a, B, s);
    if (dtype == 0 && head_dim == 256) return (int)launch<float, float, 256>(a, B, s);
    if (dtype == 1 && head_dim == 256) return (int)launch<bf16, bf16, 256>(a, B, s);
  } else {
    if (dtype == 0 && head_dim == 64) return (int)launch<float, int8_t, 64>(a, B, s);
    if (dtype == 0 && head_dim == 128) return (int)launch<float, int8_t, 128>(a, B, s);
    if (dtype == 1 && head_dim == 64) return (int)launch<bf16, int8_t, 64>(a, B, s);
    if (dtype == 1 && head_dim == 128) return (int)launch<bf16, int8_t, 128>(a, B, s);
    if (dtype == 0 && head_dim == 256) return (int)launch<float, int8_t, 256>(a, B, s);
    if (dtype == 1 && head_dim == 256) return (int)launch<bf16, int8_t, 256>(a, B, s);
  }
  return (int)cudaErrorInvalidValue;
}
