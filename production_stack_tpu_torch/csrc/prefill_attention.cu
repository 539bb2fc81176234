// Causal chunked-prefill attention over paged KV, plus the chunk's paged KV
// write, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_prefill_kernel` of
// production_stack_tpu/ops/pallas/prefill_attention.py (launched by
// `ragged_paged_attention_prefill`) with `fused_write=True`: bf16 and f32
// pools, sliding window, logit softcap, a layer index into the stacked
// [L, P, page, KH, D] pools, and the int8 pool mode (per-page, per-KV-head
// f32 scales [L, P, KH], ops/quant.py): the history is int8, the chunk's own
// K/V and q stay bf16/f32, and the write quantizes the chunk into its pages.
//
// Masking model (ops/attention.py): pool slot s holds position s and is
// valid while s < paged_end = kv_len - cur_len; chunk entry j holds the
// token at positions[b, j] (valid for j < cur_len), which the scheduler
// makes contiguous from paged_end. Query t at position p sees a key at
// position k iff k <= p and k > p - window.
//
// What bounds it on the card: operations. A 512-token chunk over 1.5k
// tokens of history does ~4 * T * NH * D * S flops against ~2 * S * KH * D
// KV bytes, well above the ~295 flop/byte compute line, so the bf16 path
// (every serving model) runs its two products on the tensor cores:
//  - one thread block per (16 query tokens, KV head, batch row), one
//    warp per query head of the GQA group and key share (D = 64: two
//    warps per head, each folding half of every tile, merged at the end),
//    so a staged K/V tile serves all G heads of the group;
//  - the block walks history slots [max(min query pos - window + 1, 0),
//    min(paged_end, max query pos + 1)) through the page table, then the
//    chunk's own entries up to its last token (the causal upper triangle is
//    never loaded), in 64-key tiles copied with 16-byte cp.async into a
//    double buffer, so tile i+1 loads while tile i is folded;
//  - S = Q K^T and O += P V are mma.sync m16n8k16 (bf16 in, f32 out), the
//    fragments read with ldmatrix from rows padded by 16 bytes; the masked
//    online softmax runs in f32 registers, P is rounded to bf16 for P V;
//  - rows past a tile's last key are zeroed in shared memory, so a masked
//    key never brings stale bytes (NaN) into P V.
// f32 inputs take a CUDA-core fold of the same tiles (tests and references;
// no served model runs f32). Later work: wgmma with TMA-fed tiles and warp
// specialisation, and a query tile wider than one warp per head.
//
// int8 history (the bf16 path): |q| <= 127 is exact in bf16, so history
// rows convert int8 -> bf16 in shared memory WITHOUT rounding (loaded
// synchronously, not through cp.async, while the previous tile's products
// run), and the tensor-core products stay as they are; each score column is
// then multiplied by its key's page K scale in f32, and each probability by
// its key's V scale before it is rounded to bf16 for P V. Scales are looked
// up per key, so any page size works. The f32 kernel dequantizes history
// rows in f32 as it stages them.
//
// The KV write is a second kernel, `kv_page_write` (fp pools) or
// `kv_page_write_quant` (int8 pools), launched by the same wrapper after
// attention: it writes the chunk's K/V rows into their pool slots in place.
// Attention reads only slots below paged_end and the fp write touches only
// slots at or above it; the int8 write also rewrites a head page's scale
// row only when the page is fresh, so running it after attention keeps it
// clear of the attention's reads (the race the JAX kernel's comment at
// prefill_attention.py:317-320 describes). Fusing the write into the
// attention kernel's epilogue, so that the chunk's K/V cross device memory
// once, is later work.
#include "attention_common.cuh"

namespace {

using namespace pst;

// ---- bf16: tensor cores (mma.sync m16n8k16, f32 accumulate) -------------

constexpr int BKV = 64;      // keys per staged K/V tile
constexpr int MMA_MAX_G = 8; // query heads per KV head (one warp each)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// tiles [K, V][2][BKV][D + 8] bf16, key positions [2][BKV], and with int8
// pools the keys' page scales [K, V][2][BKV]
template <int D, bool QUANT>
constexpr size_t mma_smem_bytes() {
  return 4 * (size_t)BKV * (D + 8) * sizeof(__nv_bfloat16) + 2 * BKV * sizeof(int) +
         (QUANT ? 4 * BKV * sizeof(float) : 0);
}

// 16 int8 pool values -> 16 bf16 in shared memory, exactly (|q| <= 127).
__device__ __forceinline__ void int8x16_to_bf16(const int8_t* src, __nv_bfloat16* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
    int8x4_to_f32(w[i], f);
    o[2 * i] = pack_bf16(f[0], f[1]);
    o[2 * i + 1] = pack_bf16(f[2], f[3]);
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// KSPLIT warps per query head: each takes its 64 / KSPLIT keys of every
// tile, and their softmax states merge at the end (more warps in flight
// per SM at the same shared-memory traffic).
template <int D>
__host__ __device__ constexpr int ksplit() { return D == 64 ? 2 : 1; }

// One block per (16 query tokens, KV head, batch row). Warp w is query head
// kh * G + w % G and takes key share w / G of each tile. Fragment layouts
// are those of mma.m16n8k16: lane = 4 * g + qd holds rows g and g + 8 and
// column pairs 2 * qd (+ 8).
template <int D, typename KV>
__global__ void __launch_bounds__(32 * MMA_MAX_G * ksplit<D>()) prefill_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const int* __restrict__ positions,
    const KV* __restrict__ k_pages, const KV* __restrict__ v_pages,
    const float* __restrict__ k_scales, const float* __restrict__ v_scales,
    const __nv_bfloat16* __restrict__ k_cur, const __nv_bfloat16* __restrict__ v_cur,
    const int* __restrict__ page_table, const int* __restrict__ kv_lens,
    const int* __restrict__ cur_lens, __nv_bfloat16* __restrict__ out, int Tn, int NH, int KH, int P,
    int page_size, int max_pages, int layer, int window, float sm_scale, float softcap) {
  using T = __nv_bfloat16;
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int KS = ksplit<D>();
  constexpr int BQ = 16;           // query tokens per block
  constexpr int ROW = D + 8;       // padded smem row: 16 bytes of pad keep ldmatrix conflict-free
  constexpr int VPR = D / 8;       // 16-byte vectors per row
  constexpr int NB = BKV / 8 / KS; // 8-key score blocks per warp per tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kbuf = reinterpret_cast<T*>(smem_raw);                      // [2][BKV][ROW]
  T* vbuf = kbuf + 2 * BKV * ROW;                                 // [2][BKV][ROW]
  int* kpos_buf = reinterpret_cast<int*>(vbuf + 2 * BKV * ROW);   // [2][BKV], -1 = no key
  float* kscl_buf = reinterpret_cast<float*>(kpos_buf + 2 * BKV); // [2][BKV], int8 pools
  float* vscl_buf = kscl_buf + 2 * BKV;
  __shared__ int s_qmin, s_qmax;

  const int t_base = blockIdx.x * BQ;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = NH / KH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int gi = warp % G, share = warp / G;
  const int h = kh * G + gi;
  const int* pos_b = positions + (size_t)b * Tn;

  if (threadIdx.x == 0) {
    int lo_p = 0x7fffffff, hi_p = -1;
    for (int t = t_base; t < min(t_base + BQ, Tn); ++t) {
      const int p = pos_b[t];
      if (p >= 0) {
        lo_p = min(lo_p, p);
        hi_p = max(hi_p, p);
      }
    }
    s_qmin = lo_p;
    s_qmax = hi_p;
  }

  // this thread's rows: tokens t_base + g (hf = 0) and t_base + g + 8 (hf = 1)
  int qpos[2];
  uint32_t qa[D / 16][4];
  float m_r[2], l_r[2], oacc[D / 8][4];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int t = t_base + g + 8 * hf;
    qpos[hf] = t < Tn ? pos_b[t] : -1;
    m_r[hf] = NEG_INF;
    l_r[hf] = 0.f;
  }
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = t_base + g + 8 * (r & 1);
      const int d = kc * 16 + 8 * (r >> 1) + 2 * qd;
      qa[kc][r] = t < Tn ? *reinterpret_cast<const uint32_t*>(q + (((size_t)b * Tn + t) * NH + h) * D + d) : 0u;
    }
  }
#pragma unroll
  for (int db = 0; db < D / 8; ++db) {
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[db][e] = 0.f;
  }
  __syncthreads();
  const int qmin = s_qmin, qmax = s_qmax;

  const size_t slot_stride = (size_t)KH * D;
  const size_t layer_off = (size_t)layer * P * page_size * slot_stride + (size_t)kh * D;
  const int* pt = page_table + (size_t)b * max_pages;
  int lo = 0, hi = 0, jend = 0, n_hist = 0, n_tiles = 0;
  if (qmax >= 0) {  // the block holds at least one real query
    const int paged_end = kv_lens[b] - cur_lens[b];
    lo = max(qmin - window + 1, 0);
    hi = min(min(paged_end, qmax + 1), max_pages * page_size);
    // causal: chunk entries past the block's last token are invisible to it
    jend = min(cur_lens[b], min(t_base + BQ, Tn));
    n_hist = hi > lo ? (hi - lo + BKV - 1) / BKV : 0;
    n_tiles = n_hist + (jend + BKV - 1) / BKV;
  }

  // tile i: history slots [lo + i * BKV, ...) through the page table, then
  // the chunk's own entries; rows past the tile's n keys are zeroed, so a
  // masked key never carries stale bytes into P.V
  auto issue = [&](int i) {
    T* kd = kbuf + (i & 1) * BKV * ROW;
    T* vd = vbuf + (i & 1) * BKV * ROW;
    int* kp = kpos_buf + (i & 1) * BKV;
    float* ksc = kscl_buf + (i & 1) * BKV;
    float* vsc = vscl_buf + (i & 1) * BKV;
    int n;
    if (i < n_hist) {
      const int t0 = lo + i * BKV;
      n = min(BKV, hi - t0);
      auto row_of = [&](const KV* pool) {
        return [=](int r) -> const KV* {
          const int slot = t0 + r;
          const int pg = slot / page_size;
          return pool + layer_off + ((size_t)pt[pg] * page_size + (slot - pg * page_size)) * slot_stride;
        };
      };
      if constexpr (QUANT) {
        // int8 rows -> bf16 rows, exactly; plain loads and stores, visible
        // after the barrier that precedes this tile's products
        auto k_row = row_of(k_pages), v_row = row_of(v_pages);
        for (int x = threadIdx.x; x < n * (D / 16); x += blockDim.x) {
          const int r = x / (D / 16), c = x % (D / 16);
          int8x16_to_bf16(k_row(r) + 16 * c, kd + r * ROW + 16 * c);
          int8x16_to_bf16(v_row(r) + 16 * c, vd + r * ROW + 16 * c);
        }
        for (int r = threadIdx.x; r < n; r += blockDim.x) {
          const size_t sc = ((size_t)layer * P + pt[(t0 + r) / page_size]) * KH + kh;
          ksc[r] = k_scales[sc];
          vsc[r] = v_scales[sc];
        }
      } else {
        stage_rows_async<T, D>(kd, ROW, n, row_of(k_pages));
        stage_rows_async<T, D>(vd, ROW, n, row_of(v_pages));
      }
      for (int r = threadIdx.x; r < n; r += blockDim.x) kp[r] = t0 + r;
    } else {
      const int j0 = (i - n_hist) * BKV;
      n = min(BKV, jend - j0);
      auto cur_row = [&](const T* cur) {
        return [=](int r) -> const T* { return cur + (((size_t)b * Tn + j0 + r) * KH + kh) * D; };
      };
      stage_rows_async<T, D>(kd, ROW, n, cur_row(k_cur));
      stage_rows_async<T, D>(vd, ROW, n, cur_row(v_cur));
      for (int r = threadIdx.x; r < n; r += blockDim.x) kp[r] = pos_b[j0 + r];
      if constexpr (QUANT) {
        for (int r = threadIdx.x; r < n; r += blockDim.x) ksc[r] = vsc[r] = 1.f;  // fp chunk
      }
    }
    for (int x = threadIdx.x; x < (BKV - n) * VPR; x += blockDim.x) {
      const int r = n + x / VPR, c = x % VPR;
      reinterpret_cast<uint4*>(kd + r * ROW)[c] = make_uint4(0u, 0u, 0u, 0u);
      reinterpret_cast<uint4*>(vd + r * ROW)[c] = make_uint4(0u, 0u, 0u, 0u);
    }
    for (int r = n + threadIdx.x; r < BKV; r += blockDim.x) kp[r] = -1;
    if constexpr (QUANT) {
      for (int r = n + threadIdx.x; r < BKV; r += blockDim.x) ksc[r] = vsc[r] = 1.f;
    }
    cp_async_commit();
  };

  if (n_tiles > 0) issue(0);
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      issue(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // this warp's keys of the tile: [share * 8 * NB, (share + 1) * 8 * NB)
    const T* kt = kbuf + (i & 1) * BKV * ROW + share * 8 * NB * ROW;
    const T* vt = vbuf + (i & 1) * BKV * ROW + share * 8 * NB * ROW;
    const int* kp = kpos_buf + (i & 1) * BKV + share * 8 * NB;
    const float* ksc = kscl_buf + (i & 1) * BKV + share * 8 * NB;
    const float* vsc = vscl_buf + (i & 1) * BKV + share * 8 * NB;

    // S = Q K^T: B fragments are K rows (keys) read with ldmatrix
    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
      for (int kc2 = 0; kc2 < D / 32; ++kc2) {
        uint32_t r[4];
        ldmatrix_x4(r, kt + (nb * 8 + (lane & 7)) * ROW + kc2 * 32 + (lane >> 3) * 8);
        mma_bf16(s[nb], qa[2 * kc2], r[0], r[1]);
        mma_bf16(s[nb], qa[2 * kc2 + 1], r[2], r[3]);
      }
    }

    // masked online softmax in log2 units; p overwrites s
    int kpv[NB][2];
    float ksv[NB][2], vsv[NB][2];  // the keys' page scales (int8 pools)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        kpv[nb][e] = kp[nb * 8 + 2 * qd + e];
        ksv[nb][e] = QUANT ? ksc[nb * 8 + 2 * qd + e] : 1.f;
        vsv[nb][e] = QUANT ? vsc[nb * 8 + 2 * qd + e] : 1.f;
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int qp = qpos[hf];
      float mx = NEG_INF;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = kpv[nb][e];
          const bool vis = kpos >= 0 && qp >= 0 && kpos <= qp && kpos > qp - window;
          float x = s[nb][2 * hf + e] * sm_scale;
          if constexpr (QUANT) x *= ksv[nb][e];
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          x = vis ? x * LOG2E : NEG_INF;
          s[nb][2 * hf + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m_r[hf], mx);
      const float alpha = exp2f(fminf(m_r[hf] - m_new, 0.f));
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[nb][2 * hf + e];
          const float p = x == NEG_INF ? 0.f : exp2f(x - m_new);
          // P V takes p times the key's V scale, rounded to bf16 once
          s[nb][2 * hf + e] = QUANT ? p * vsv[nb][e] : p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(FULL, sum, 1);
      sum += __shfl_xor_sync(FULL, sum, 2);
      l_r[hf] = l_r[hf] * alpha + sum;
      m_r[hf] = m_new;
#pragma unroll
      for (int db = 0; db < D / 8; ++db) {
        oacc[db][2 * hf] *= alpha;
        oacc[db][2 * hf + 1] *= alpha;
      }
    }

    // O += P V: P from the score registers, B fragments are V read with
    // ldmatrix.trans (V rows are keys)
#pragma unroll
    for (int kc2 = 0; kc2 < NB / 2; ++kc2) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kc2][0], s[2 * kc2][1]), pack_bf16(s[2 * kc2][2], s[2 * kc2][3]),
          pack_bf16(s[2 * kc2 + 1][0], s[2 * kc2 + 1][1]), pack_bf16(s[2 * kc2 + 1][2], s[2 * kc2 + 1][3]),
      };
#pragma unroll
      for (int db2 = 0; db2 < D / 16; ++db2) {
        uint32_t r[4];
        const int mi = lane >> 3;
        ldmatrix_x4_trans(r, vt + (kc2 * 16 + (mi & 1) * 8 + (lane & 7)) * ROW + (2 * db2 + (mi >> 1)) * 8);
        mma_bf16(oacc[2 * db2], pa, r[0], r[1]);
        mma_bf16(oacc[2 * db2 + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();  // the buffer is refilled by issue(i + 2)
  }

  if constexpr (KS > 1) {
    // merge the key shares: share s > 0 parks its state in the (now idle)
    // tile buffers, share 0 folds it in and writes the output
    constexpr int W = 4 + D / 2;  // floats per lane: m[2], l[2], o[D / 8][4]
    float* park = reinterpret_cast<float*>(smem_raw);
    if (share > 0) {
      float* dst = park + ((size_t)((share - 1) * G + gi) * 32 + lane) * W;
      dst[0] = m_r[0]; dst[1] = m_r[1]; dst[2] = l_r[0]; dst[3] = l_r[1];
#pragma unroll
      for (int db = 0; db < D / 8; ++db) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[4 + 4 * db + e] = oacc[db][e];
      }
    }
    __syncthreads();
    if (share > 0) return;
#pragma unroll
    for (int so = 1; so < KS; ++so) {
      const float* src = park + ((size_t)((so - 1) * G + gi) * 32 + lane) * W;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float m_o = src[hf], l_o = src[2 + hf];
        const float m_new = fmaxf(m_r[hf], m_o);
        const float a = exp2f(fminf(m_r[hf] - m_new, 0.f));
        const float a_o = exp2f(fminf(m_o - m_new, 0.f));
        l_r[hf] = l_r[hf] * a + l_o * a_o;
        m_r[hf] = m_new;
#pragma unroll
        for (int db = 0; db < D / 8; ++db) {
          oacc[db][2 * hf] = oacc[db][2 * hf] * a + src[4 + 4 * db + 2 * hf] * a_o;
          oacc[db][2 * hf + 1] = oacc[db][2 * hf + 1] * a + src[4 + 4 * db + 2 * hf + 1] * a_o;
        }
      }
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int t = t_base + g + 8 * hf;
    if (t >= Tn) continue;
    const float inv = 1.f / fmaxf(l_r[hf], 1e-30f);
    T* o = out + (((size_t)b * Tn + t) * NH + h) * D + 2 * qd;
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      *reinterpret_cast<uint32_t*>(o + db * 8) = pack_bf16(oacc[db][2 * hf] * inv, oacc[db][2 * hf + 1] * inv);
    }
  }
}

template <int D, typename KV>
cudaError_t launch_mma(const void* q, const int* pos, const void* kp, const void* vp, const float* ks,
                       const float* vs, const void* kc, const void* vc, const int* pt, const int* lens,
                       const int* cl, void* out, int B, int Tn, int NH, int KH, int P, int page_size,
                       int max_pages, int layer, int window, float sm_scale, float softcap, cudaStream_t s) {
  using T = __nv_bfloat16;
  const size_t smem = mma_smem_bytes<D, sizeof(KV) == 1>();
  static bool configured = false;  // idempotent; a race only repeats it
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        prefill_attention_mma_kernel<D, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((Tn + 15) / 16, KH, B);
  prefill_attention_mma_kernel<D, KV><<<grid, 32 * (NH / KH) * ksplit<D>(), smem, s>>>(
      static_cast<const T*>(q), pos, static_cast<const KV*>(kp), static_cast<const KV*>(vp), ks, vs,
      static_cast<const T*>(kc), static_cast<const T*>(vc), pt, lens, cl, static_cast<T*>(out), Tn, NH, KH,
      P, page_size, max_pages, layer, window, sm_scale, softcap);
  return cudaGetLastError();
}

// ---- f32: CUDA cores ----------------------------------------------------

constexpr int WARPS = 8;  // warps per block
constexpr int RPW = 8;    // max query rows per warp (rows per block <= 64)

template <int D, typename KV>
__global__ void __launch_bounds__(WARPS * 32, 1) prefill_attention_f32_kernel(
    const float* __restrict__ q, const int* __restrict__ positions, const KV* __restrict__ k_pages,
    const KV* __restrict__ v_pages, const float* __restrict__ k_scales, const float* __restrict__ v_scales,
    const float* __restrict__ k_cur, const float* __restrict__ v_cur,
    const int* __restrict__ page_table, const int* __restrict__ kv_lens,
    const int* __restrict__ cur_lens, float* __restrict__ out, int Tn, int NH, int KH, int P,
    int page_size, int max_pages, int layer, int TQ, int window, float sm_scale,
    float softcap) {
  using T = float;
  constexpr int E = D / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + TILE * D;
  __shared__ int s_qmin, s_qmax;

  const int t_base = blockIdx.x * TQ;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = NH / KH;
  const int rows = TQ * G;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int* pos_b = positions + (size_t)b * Tn;

  if (threadIdx.x == 0) {
    int lo_p = 0x7fffffff, hi_p = -1;
    for (int t = t_base; t < min(t_base + TQ, Tn); ++t) {
      const int p = pos_b[t];
      if (p >= 0) {
        lo_p = min(lo_p, p);
        hi_p = max(hi_p, p);
      }
    }
    s_qmin = lo_p;
    s_qmax = hi_p;
  }
  __syncthreads();
  const int qmin = s_qmin, qmax = s_qmax;

  // this warp's rows: r = warp + WARPS * i -> (token t, head h)
  float qv[RPW][E], acc[RPW][E], m[RPW], l[RPW];
  int qpos[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + WARPS * i;
    const int t = t_base + r / G;
    const int h = kh * G + r % G;
    qpos[i] = (r < rows && t < Tn) ? pos_b[t] : -1;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      acc[i][e] = 0.f;
      qv[i][e] = qpos[i] >= 0
                     ? to_f(q[(((size_t)b * Tn + t) * NH + h) * D + lane * E + e]) * sm_scale
                     : 0.f;
    }
  }

  if (qmax >= 0) {  // the tile holds at least one real query
    const int kv_len = kv_lens[b];
    const int cl = cur_lens[b];
    const int paged_end = kv_len - cl;
    const size_t slot_stride = (size_t)KH * D;
    const size_t layer_off = (size_t)layer * P * page_size * slot_stride + (size_t)kh * D;
    const int* pt = page_table + (size_t)b * max_pages;

    // ---- paged history ----
    const int lo = max(qmin - window + 1, 0);
    const int hi = min(min(paged_end, qmax + 1), max_pages * page_size);
    for (int t0 = lo; t0 < hi; t0 += TILE) {
      const int n = min(TILE, hi - t0);
      auto pool_row = [&](const KV* pool) {
        return [=](int r) -> const KV* {
          const int slot = t0 + r;
          const int pg = slot / page_size;
          return pool + layer_off +
                 ((size_t)pt[pg] * page_size + (slot - pg * page_size)) * slot_stride;
        };
      };
      if constexpr (sizeof(KV) == 1) {
        // int8 history: dequantize in f32 as the rows are staged
        auto k_row = pool_row(k_pages), v_row = pool_row(v_pages);
        for (int x = threadIdx.x; x < n * (D / 4); x += blockDim.x) {
          const int r = x / (D / 4), c = x % (D / 4);
          const size_t sc = ((size_t)layer * P + pt[(t0 + r) / page_size]) * KH + kh;
          const char4 a = reinterpret_cast<const char4*>(k_row(r))[c];
          const char4 bq = reinterpret_cast<const char4*>(v_row(r))[c];
          const float fk = k_scales[sc], fv = v_scales[sc];
          reinterpret_cast<float4*>(ks + r * D)[c] = make_float4(a.x * fk, a.y * fk, a.z * fk, a.w * fk);
          reinterpret_cast<float4*>(vs + r * D)[c] = make_float4(bq.x * fv, bq.y * fv, bq.z * fv, bq.w * fv);
        }
      } else {
        stage_rows<T, D>(ks, D, n, pool_row(k_pages));
        stage_rows<T, D>(vs, D, n, pool_row(v_pages));
      }
      __syncthreads();
      const int kpos = t0 + lane;
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const bool vis = lane < n && qpos[i] >= 0 && kpos <= qpos[i] && kpos > qpos[i] - window;
        fold_tile<T, D>(qv[i], m[i], l[i], acc[i], ks, vs, __ballot_sync(FULL, vis), softcap);
      }
      __syncthreads();
    }

    // ---- the chunk's own K/V (causal: entries past the tile's last query
    // are invisible under the contiguous-chunk contract) ----
    const int jend = min(cl, min(t_base + TQ, Tn));
    for (int j0 = 0; j0 < jend; j0 += TILE) {
      const int n = min(TILE, jend - j0);
      auto cur_row = [&](const T* cur) {
        return [=](int r) -> const T* {
          return cur + (((size_t)b * Tn + j0 + r) * KH + kh) * D;
        };
      };
      stage_rows<T, D>(ks, D, n, cur_row(k_cur));
      stage_rows<T, D>(vs, D, n, cur_row(v_cur));
      __syncthreads();
      const int kpos = lane < n ? pos_b[j0 + lane] : -1;
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const bool vis = kpos >= 0 && qpos[i] >= 0 && kpos <= qpos[i] && kpos > qpos[i] - window;
        fold_tile<T, D>(qv[i], m[i], l[i], acc[i], ks, vs, __ballot_sync(FULL, vis), softcap);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + WARPS * i;
    const int t = t_base + r / G;
    if (r >= rows || t >= Tn) continue;
    const int h = kh * G + r % G;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < E; ++e)
      store_f(&out[(((size_t)b * Tn + t) * NH + h) * D + lane * E + e], acc[i][e] * inv);
  }
}

// Copy chunk K/V rows [b, t < cur_lens[b]] to pool slot positions[b, t] of
// `layer` (rows with position -1, or beyond the row's pages, are dropped) —
// the same bytes as ops/attention.write_kv_pages_all_layers writes for one
// layer. One block per chunk row; each thread moves 16-byte vectors.
template <typename T>
__global__ void kv_page_write_kernel(const T* __restrict__ k_cur, const T* __restrict__ v_cur,
                                     const int* __restrict__ positions,
                                     const int* __restrict__ cur_lens,
                                     const int* __restrict__ page_table, T* __restrict__ k_pages,
                                     T* __restrict__ v_pages, int Tn, int KH, int D, int P,
                                     int page_size, int max_pages, int layer) {
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  if (t >= cur_lens[b]) return;
  const int pos = positions[(size_t)b * Tn + t];
  if (pos < 0) return;
  const int pg = pos / page_size;
  if (pg >= max_pages) return;
  const int pid = page_table[(size_t)b * max_pages + pg];
  const size_t row = (size_t)KH * D;
  const size_t dst = (((size_t)layer * P + pid) * page_size + (pos - pg * page_size)) * row;
  const size_t src = ((size_t)b * Tn + t) * row;
  const int nvec = (int)(row * sizeof(T) / 16);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    reinterpret_cast<uint4*>(k_pages + dst)[i] = reinterpret_cast<const uint4*>(k_cur + src)[i];
    reinterpret_cast<uint4*>(v_pages + dst)[i] = reinterpret_cast<const uint4*>(v_cur + src)[i];
  }
}

// One value quantized into a page of scale `scale`: round(x / scale), half
// to even, clipped to +-127 (ops/quant.py). An IEEE division, never a
// multiply by the reciprocal: the same bytes as the JAX package.
__device__ __forceinline__ signed char quant1(float x, float scale) {
  return (signed char)max(-127, min(127, __float2int_rn(__fdiv_rn(x, scale))));
}

// The int8 pools' chunk write (the JAX kernel's fused int8 write,
// prefill_attention.py:304-394). One block of QW_THREADS per (written page
// j, K or V and KV head task, row b): row b's chunk holds positions [s0,
// e0) = [kv_len - cur_len, kv_len), and page j is logical page s0 / page +
// j. The block takes an f32 abs-max over the page's kept slots x D for its
// KV head, then writes the page's values. A fresh page (slot 0 at or after s0) takes scale
// max(amax * f32(1 / 127), 1e-8) and is written whole, zeros past the chunk; a head
// page that starts before s0 keeps its scale, and only its kept slots are
// written (clipped). Bound by bytes: the chunk's fp K/V are read twice
// (the second time from L2) and the int8 pages written once.
constexpr int QW_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(QW_THREADS) kv_page_write_quant_kernel(const T* __restrict__ k_cur, const T* __restrict__ v_cur,
                                           const int* __restrict__ kv_lens,
                                           const int* __restrict__ cur_lens,
                                           const int* __restrict__ page_table,
                                           int8_t* __restrict__ k_pages, int8_t* __restrict__ v_pages,
                                           float* __restrict__ k_scales, float* __restrict__ v_scales,
                                           int Tn, int KH, int D, int P, int page_size, int max_pages,
                                           int layer) {
  const int task = blockIdx.y;  // K heads 0..KH-1, then V heads
  const int b = blockIdx.z;
  const int cl = cur_lens[b];
  if (cl <= 0) return;
  const int e0 = kv_lens[b];
  const int s0 = e0 - cl;
  const int lp = s0 / page_size + blockIdx.x;
  const int start = lp * page_size;
  if (start >= e0 || lp >= max_pages) return;
  const int pid = page_table[(size_t)b * max_pages + lp];
  const bool fresh = start >= s0;
  const int groups = page_size * D / 4;  // 4 values of one slot per thread step
  const size_t row = (size_t)KH * D;
  const size_t page_off = ((size_t)layer * P + pid) * page_size * row;
  const int kh = task % KH;
  const T* cur = task < KH ? k_cur : v_cur;
  int8_t* dst = (task < KH ? k_pages : v_pages) + page_off + (size_t)kh * D;
  float* sc = (task < KH ? k_scales : v_scales) + ((size_t)layer * P + pid) * KH + kh;
  // group g = slot g * 4 / D, values [d0, d0 + 4); false (x = 0) past the chunk
  auto load = [&](int g, float (&x)[4]) -> bool {
    const int slot = 4 * g / D;
    const int pos = start + slot;
    if (pos < s0 || pos >= e0) {
      x[0] = x[1] = x[2] = x[3] = 0.f;
      return false;
    }
    load_e<4>(cur + ((size_t)b * Tn + (pos - s0)) * row + (size_t)kh * D + 4 * g % D, x);
    return true;
  };
  float amax = 0.f;
  if (fresh) {  // block-uniform
    __shared__ float s_amax[QW_THREADS / 32];
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
      float x[4];
      load(g, x);
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(x[0]), fabsf(x[1])), fmaxf(fabsf(x[2]), fabsf(x[3]))));
    }
    amax = warp_max(amax);
    if ((threadIdx.x & 31) == 0) s_amax[threadIdx.x >> 5] = amax;
    __syncthreads();
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) amax = fmaxf(amax, s_amax[w]);
  }
  // amax * f32(1 / 127): the JAX package's compiled programs fold amax / 127
  // into this multiply (ops/quant.py)
  const float scale = fresh ? fmaxf(__fmul_rn(amax, 1.f / 127.f), 1e-8f) : *sc;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float x[4];
    if (!load(g, x) && !fresh) continue;  // a head page keeps its earlier slots
    char4 qv;
    qv.x = quant1(x[0], scale);
    qv.y = quant1(x[1], scale);
    qv.z = quant1(x[2], scale);
    qv.w = quant1(x[3], scale);
    *reinterpret_cast<char4*>(dst + (size_t)(4 * g / D) * row + 4 * g % D) = qv;
  }
  if (fresh && threadIdx.x == 0) *sc = scale;
}

}  // namespace

// dtype (of q, the chunk K/V and out): 0 = float32, 1 = bfloat16. kv_int8 =
// 0: pools of that dtype (k_scales/v_scales ignored); 1: int8 pools with f32
// scales [L, P, KH]. window: huge = full causal; softcap <= 0 = none. bf16
// takes at most 8 query heads per KV head; TQ is the f32 kernel's query
// tokens per block (TQ * NH / KH <= 64).
extern "C" int prefill_attention_launch(int dtype, int kv_int8, int head_dim, const void* q,
                                        const void* positions, const void* k_pages,
                                        const void* v_pages, const void* k_scales,
                                        const void* v_scales, const void* k_cur,
                                        const void* v_cur, const void* page_table,
                                        const void* kv_lens, const void* cur_lens, void* out,
                                        int B, int Tn, int NH, int KH, int P, int page_size,
                                        int max_pages, int layer, int TQ, int window,
                                        float sm_scale, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pos = static_cast<const int*>(positions);
  const int* pt = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(kv_lens);
  const int* cl = static_cast<const int*>(cur_lens);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int G = NH / KH;
  using bf16 = __nv_bfloat16;
  if (dtype == 1) {
    if (G > MMA_MAX_G) return (int)cudaErrorInvalidValue;
#define PST_ARGS q, pos, k_pages, v_pages, ks, vs, k_cur, v_cur, pt, lens, cl, out, B, Tn, NH, KH, P, \
                 page_size, max_pages, layer, window, sm_scale, softcap, s
    if (head_dim == 64) return (int)(kv_int8 ? launch_mma<64, int8_t>(PST_ARGS) : launch_mma<64, bf16>(PST_ARGS));
    if (head_dim == 128) return (int)(kv_int8 ? launch_mma<128, int8_t>(PST_ARGS) : launch_mma<128, bf16>(PST_ARGS));
#undef PST_ARGS
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 0 || TQ * G > WARPS * RPW) return (int)cudaErrorInvalidValue;
  const dim3 grid((Tn + TQ - 1) / TQ, KH, B);
#define PST_LAUNCH(DIM, KV)                                                                      \
  prefill_attention_f32_kernel<DIM, KV><<<grid, WARPS * 32, 2 * TILE * DIM * sizeof(float), s>>>( \
      static_cast<const float*>(q), pos, static_cast<const KV*>(k_pages),                          \
      static_cast<const KV*>(v_pages), ks, vs, static_cast<const float*>(k_cur),                   \
      static_cast<const float*>(v_cur), pt, lens, cl, static_cast<float*>(out), Tn, NH, KH, P,     \
      page_size, max_pages, layer, TQ, window, sm_scale, softcap);                                 \
  return (int)cudaGetLastError()
  if (head_dim == 64 && !kv_int8) { PST_LAUNCH(64, float); }
  if (head_dim == 128 && !kv_int8) { PST_LAUNCH(128, float); }
  if (head_dim == 64 && kv_int8) { PST_LAUNCH(64, int8_t); }
  if (head_dim == 128 && kv_int8) { PST_LAUNCH(128, int8_t); }
#undef PST_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" int kv_page_write_launch(int dtype, const void* k_cur, const void* v_cur,
                                    const void* positions, const void* cur_lens,
                                    const void* page_table, void* k_pages, void* v_pages, int B,
                                    int Tn, int KH, int D, int P, int page_size, int max_pages,
                                    int layer, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(Tn, B);
  const int* pos = static_cast<const int*>(positions);
  const int* cl = static_cast<const int*>(cur_lens);
  const int* pt = static_cast<const int*>(page_table);
  if (dtype == 0) {
    kv_page_write_kernel<float><<<grid, 128, 0, s>>>(
        static_cast<const float*>(k_cur), static_cast<const float*>(v_cur), pos, cl, pt,
        static_cast<float*>(k_pages), static_cast<float*>(v_pages), Tn, KH, D, P, page_size,
        max_pages, layer);
  } else if (dtype == 1) {
    kv_page_write_kernel<__nv_bfloat16><<<grid, 128, 0, s>>>(
        static_cast<const __nv_bfloat16*>(k_cur), static_cast<const __nv_bfloat16*>(v_cur), pos,
        cl, pt, static_cast<__nv_bfloat16*>(k_pages), static_cast<__nv_bfloat16*>(v_pages), Tn,
        KH, D, P, page_size, max_pages, layer);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The int8 pools' chunk write: grid (max_write = ceil(T / page) + 1 pages a
// chunk can touch, 2 * KH tasks, B) of QW_THREADS each.
extern "C" int kv_page_write_quant_launch(int dtype, const void* k_cur, const void* v_cur,
                                          const void* kv_lens, const void* cur_lens,
                                          const void* page_table, void* k_pages, void* v_pages,
                                          void* k_scales, void* v_scales, int B, int Tn, int KH, int D,
                                          int P, int page_size, int max_pages, int layer, int max_write,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 4) return (int)cudaErrorInvalidValue;
  const dim3 grid(max_write, 2 * KH, B);
  const int threads = QW_THREADS;
  const int* lens = static_cast<const int*>(kv_lens);
  const int* cl = static_cast<const int*>(cur_lens);
  const int* pt = static_cast<const int*>(page_table);
  int8_t* kp = static_cast<int8_t*>(k_pages);
  int8_t* vp = static_cast<int8_t*>(v_pages);
  float* ks = static_cast<float*>(k_scales);
  float* vs = static_cast<float*>(v_scales);
  if (dtype == 0) {
    kv_page_write_quant_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(k_cur), static_cast<const float*>(v_cur), lens, cl, pt, kp, vp, ks, vs, Tn,
        KH, D, P, page_size, max_pages, layer);
  } else if (dtype == 1) {
    kv_page_write_quant_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(k_cur), static_cast<const __nv_bfloat16*>(v_cur), lens, cl, pt, kp,
        vp, ks, vs, Tn, KH, D, P, page_size, max_pages, layer);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
