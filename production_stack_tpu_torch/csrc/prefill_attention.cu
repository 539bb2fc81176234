// Causal chunked-prefill attention over paged KV, plus the chunk's paged KV
// write, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_prefill_kernel` of
// production_stack_tpu/ops/pallas/prefill_attention.py (launched by
// `ragged_paged_attention_prefill`), fp modes with `fused_write=True`: bf16
// and f32 pools, sliding window, logit softcap, a layer index into the
// stacked [L, P, page, KH, D] pools. The int8 modes are not ported yet: the
// Python wrapper refuses scales.
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
// The KV write is a second kernel, `kv_page_write`, launched by the same
// wrapper: it copies the chunk's K/V rows into their pool slots in place.
// Attention reads only slots below paged_end and the write touches only
// slots at or above it, so the two launches never touch the same bytes.
// Fusing the write into the attention kernel's epilogue, so that the
// chunk's K/V cross device memory once, is later work.
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

template <int D>
constexpr size_t mma_smem_bytes() {
  return 4 * (size_t)BKV * (D + 8) * sizeof(__nv_bfloat16) + 2 * BKV * sizeof(int);
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
template <int D>
__global__ void __launch_bounds__(32 * MMA_MAX_G * ksplit<D>()) prefill_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const int* __restrict__ positions,
    const __nv_bfloat16* __restrict__ k_pages, const __nv_bfloat16* __restrict__ v_pages,
    const __nv_bfloat16* __restrict__ k_cur, const __nv_bfloat16* __restrict__ v_cur,
    const int* __restrict__ page_table, const int* __restrict__ kv_lens,
    const int* __restrict__ cur_lens, __nv_bfloat16* __restrict__ out, int Tn, int NH, int KH, int P,
    int page_size, int max_pages, int layer, int window, float sm_scale, float softcap) {
  using T = __nv_bfloat16;
  constexpr int KS = ksplit<D>();
  constexpr int BQ = 16;           // query tokens per block
  constexpr int ROW = D + 8;       // padded smem row: 16 bytes of pad keep ldmatrix conflict-free
  constexpr int VPR = D / 8;       // 16-byte vectors per row
  constexpr int NB = BKV / 8 / KS; // 8-key score blocks per warp per tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kbuf = reinterpret_cast<T*>(smem_raw);                      // [2][BKV][ROW]
  T* vbuf = kbuf + 2 * BKV * ROW;                                 // [2][BKV][ROW]
  int* kpos_buf = reinterpret_cast<int*>(vbuf + 2 * BKV * ROW);   // [2][BKV], -1 = no key
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
    int n;
    if (i < n_hist) {
      const int t0 = lo + i * BKV;
      n = min(BKV, hi - t0);
      auto row_of = [&](const T* pool) {
        return [=](int r) -> const T* {
          const int slot = t0 + r;
          const int pg = slot / page_size;
          return pool + layer_off + ((size_t)pt[pg] * page_size + (slot - pg * page_size)) * slot_stride;
        };
      };
      stage_rows_async<T, D>(kd, ROW, n, row_of(k_pages));
      stage_rows_async<T, D>(vd, ROW, n, row_of(v_pages));
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
    }
    for (int x = threadIdx.x; x < (BKV - n) * VPR; x += blockDim.x) {
      const int r = n + x / VPR, c = x % VPR;
      reinterpret_cast<uint4*>(kd + r * ROW)[c] = make_uint4(0u, 0u, 0u, 0u);
      reinterpret_cast<uint4*>(vd + r * ROW)[c] = make_uint4(0u, 0u, 0u, 0u);
    }
    for (int r = n + threadIdx.x; r < BKV; r += blockDim.x) kp[r] = -1;
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
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      kpv[nb][0] = kp[nb * 8 + 2 * qd];
      kpv[nb][1] = kp[nb * 8 + 2 * qd + 1];
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
          s[nb][2 * hf + e] = p;
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

template <int D>
cudaError_t launch_mma(const void* q, const int* pos, const void* kp, const void* vp, const void* kc,
                       const void* vc, const int* pt, const int* lens, const int* cl, void* out, int B,
                       int Tn, int NH, int KH, int P, int page_size, int max_pages, int layer, int window,
                       float sm_scale, float softcap, cudaStream_t s) {
  using T = __nv_bfloat16;
  const size_t smem = mma_smem_bytes<D>();
  static bool configured = false;  // idempotent; a race only repeats it
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        prefill_attention_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((Tn + 15) / 16, KH, B);
  prefill_attention_mma_kernel<D><<<grid, 32 * (NH / KH) * ksplit<D>(), smem, s>>>(
      static_cast<const T*>(q), pos, static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const T*>(kc), static_cast<const T*>(vc), pt, lens, cl, static_cast<T*>(out), Tn, NH, KH,
      P, page_size, max_pages, layer, window, sm_scale, softcap);
  return cudaGetLastError();
}

// ---- f32: CUDA cores ----------------------------------------------------

constexpr int WARPS = 8;  // warps per block
constexpr int RPW = 8;    // max query rows per warp (rows per block <= 64)

template <int D>
__global__ void __launch_bounds__(WARPS * 32, 1) prefill_attention_f32_kernel(
    const float* __restrict__ q, const int* __restrict__ positions, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const float* __restrict__ k_cur, const float* __restrict__ v_cur,
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
      auto pool_row = [&](const T* pool) {
        return [=](int r) -> const T* {
          const int slot = t0 + r;
          const int pg = slot / page_size;
          return pool + layer_off +
                 ((size_t)pt[pg] * page_size + (slot - pg * page_size)) * slot_stride;
        };
      };
      stage_rows<T, D>(ks, D, n, pool_row(k_pages));
      stage_rows<T, D>(vs, D, n, pool_row(v_pages));
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window: huge = full causal; softcap <= 0
// = none. bf16 takes at most 8 query heads per KV head; TQ is the f32
// kernel's query tokens per block (TQ * NH / KH <= 64).
extern "C" int prefill_attention_launch(int dtype, int head_dim, const void* q,
                                        const void* positions, const void* k_pages,
                                        const void* v_pages, const void* k_cur,
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
  const int G = NH / KH;
  if (dtype == 1) {
    if (G > MMA_MAX_G) return (int)cudaErrorInvalidValue;
#define PST_ARGS q, pos, k_pages, v_pages, k_cur, v_cur, pt, lens, cl, out, B, Tn, NH, KH, P, \
                 page_size, max_pages, layer, window, sm_scale, softcap, s
    if (head_dim == 64) return (int)launch_mma<64>(PST_ARGS);
    if (head_dim == 128) return (int)launch_mma<128>(PST_ARGS);
#undef PST_ARGS
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 0 || TQ * G > WARPS * RPW) return (int)cudaErrorInvalidValue;
  const dim3 grid((Tn + TQ - 1) / TQ, KH, B);
#define PST_LAUNCH(DIM)                                                                        \
  prefill_attention_f32_kernel<DIM><<<grid, WARPS * 32, 2 * TILE * DIM * sizeof(float), s>>>(  \
      static_cast<const float*>(q), pos, static_cast<const float*>(k_pages),                   \
      static_cast<const float*>(v_pages), static_cast<const float*>(k_cur),                    \
      static_cast<const float*>(v_cur), pt, lens, cl, static_cast<float*>(out), Tn, NH, KH, P, \
      page_size, max_pages, layer, TQ, window, sm_scale, softcap);                             \
  return (int)cudaGetLastError()
  if (head_dim == 64) { PST_LAUNCH(64); }
  if (head_dim == 128) { PST_LAUNCH(128); }
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
