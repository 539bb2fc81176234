// Shared pieces of the paged-attention kernels: dtype conversion, warp
// reductions, cp.async staging, the page lookup by multiply and shift,
// ldmatrix, and (prefill_attention.cu) the f32 CUDA-core fold of one
// staged KV tile.
//
// Stale or out-of-range pool slots may hold any bytes, and 0 * NaN is NaN:
// they are never staged, and a tile row that is not staged is never read.
// fold_tile skips masked slots; the decode fold multiplies a staged slot
// that is masked (a live, finite value) by p = 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pst {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;  // scores carry this factor so exp2f is the softmax exp
constexpr int TILE = 32;  // KV slots per staged tile of the f32 fold (one per lane)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// 16-byte asynchronous global -> shared copy (Ampere+ cp.async, L2 only).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
// 4-byte asynchronous copy (cp.async.ca: through L1), for scalars such as
// a page's scale.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async that copies `ok ? 16 : 0` bytes and zero-fills the rest of the
// 16 (or 4): a row past a tile's keys lands as zeros without a branch
__device__ __forceinline__ void cp_async16_or_zero(void* smem, const void* gmem, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)), "l"(gmem), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4_or_zero(void* smem, const void* gmem, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)), "l"(gmem), "r"(ok ? 4 : 0));
}

// slot -> page for a page size fixed per launch, any size, by a multiply
// and a shift (CUTLASS's FastDivmod, exact for slots below 2^31): an
// integer division spends three conversion or MUFU ops per lookup, on the
// pipe the softmax's exp2 saturates
struct PageDiv {
  int size;
  uint32_t mul, shr;
  __device__ __forceinline__ int page(int slot) const {
    return size == 1 ? slot : (int)(__umulhi((uint32_t)slot, mul) >> shr);
  }
};

inline PageDiv page_div(int size) {
  PageDiv d{size, 0u, 0u};
  if (size > 1) {
    const int p = 31 + (32 - __builtin_clz(size - 1));  // 31 + ceil(log2 size)
    d.mul = (uint32_t)(((1ull << p) + size - 1) / size);
    d.shr = p - 32;
  }
  return d;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Eight elements (16 bytes of T = bf16, or two 16-byte loads of f32) of a
// staged row, as floats.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// Four int8 values packed in a word, as exact floats, without the I2F
// conversion (a quarter-rate instruction that bound the int8 decode fold):
// byte b ^ 0x80 = b + 128 becomes the low mantissa bits of 2^23 (one
// byte_perm), and subtracting 2^23 + 128 is exact.
__device__ __forceinline__ void int8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) - 8388736.f;
}

// Eight int8 pool elements (8 bytes, one load) as floats: |q| <= 127, exact.
__device__ __forceinline__ void load8(const int8_t* p, float (&f)[8]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  int8x4_to_f32(w.x, f);
  int8x4_to_f32(w.y, f + 4);
}

// E consecutive elements (E = 2 or 4) of a staged row, as floats, in one
// vector load.
template <int E>
__device__ __forceinline__ void load_e(const __nv_bfloat16* p, float (&f)[E]) {
  if constexpr (E == 2) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    f[0] = x.x;
    f[1] = x.y;
  } else {
    static_assert(E == 4, "E is 2 or 4");
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    f[0] = x.x; f[1] = x.y; f[2] = y.x; f[3] = y.y;
  }
}
template <int E>
__device__ __forceinline__ void load_e(const float* p, float (&f)[E]) {
  if constexpr (E == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    f[0] = x.x;
    f[1] = x.y;
  } else {
    static_assert(E == 4, "E is 2 or 4");
    const float4 x = *reinterpret_cast<const float4*>(p);
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  }
}
template <int E>
__device__ __forceinline__ void load_e(const int8_t* p, float (&f)[E]) {
  static_assert(E == 2 || E == 4, "E is 2 or 4");
  float x[4];
  int8x4_to_f32(E == 2 ? *reinterpret_cast<const uint16_t*>(p) : *reinterpret_cast<const uint32_t*>(p), x);
#pragma unroll
  for (int i = 0; i < E; ++i) f[i] = x[i];
}

// Copy `n` rows of D elements (16-byte vectors) into a shared tile of row
// stride `stride` elements; `src_of` maps a tile row to its global address.
// Every thread of the block joins.
template <typename T, int D, typename SrcOf>
__device__ __forceinline__ void stage_rows(T* dst, int stride, int n, SrcOf src_of) {
  constexpr int VPR = D * (int)sizeof(T) / 16;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < n * VPR; i += blockDim.x) {
    const int r = i / VPR;
    const int c = i - r * VPR;
    reinterpret_cast<uint4*>(dst + r * stride)[c] = reinterpret_cast<const uint4*>(src_of(r))[c];
  }
}

// The same copy through cp.async (the caller commits and waits).
template <typename T, int D, typename SrcOf>
__device__ __forceinline__ void stage_rows_async(T* dst, int stride, int n, SrcOf src_of) {
  constexpr int VPR = D * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < n * VPR; i += blockDim.x) {
    const int r = i / VPR;
    const int c = i - r * VPR;
    cp_async16(reinterpret_cast<uint4*>(dst + r * stride) + c, reinterpret_cast<const uint4*>(src_of(r)) + c);
  }
}

// One online-softmax update of a row with the slots of a staged tile (row
// stride D) that `ok` marks visible; one warp per row, lanes splitting D.
// q is pre-scaled by sm_scale; softcap <= 0 means none.
template <typename T, int D>
__device__ __forceinline__ void fold_tile(const float (&q)[D / 32], float& m, float& l,
                                          float (&acc)[D / 32], const T* ks, const T* vs,
                                          uint32_t ok, float softcap) {
  constexpr int E = D / 32;
  if (ok == 0u) return;  // warp-uniform: ok comes from a ballot
  const int lane = threadIdx.x & 31;
  float my_s = NEG_INF;
  for (int j = 0; j < TILE; ++j) {
    if (!((ok >> j) & 1u)) continue;
    const T* kr = ks + j * D + lane * E;
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) s += q[e] * to_f(kr[e]);
    s = warp_sum(s);
    if (softcap > 0.f) s = softcap * tanhf(s / softcap);
    if (lane == j) my_s = s;
  }
  const bool mine = (ok >> lane) & 1u;
  const float m_new = fmaxf(m, warp_max(mine ? my_s : NEG_INF));
  const float alpha = expf(fminf(m - m_new, 0.f));
  const float p = mine ? expf(my_s - m_new) : 0.f;
  l = l * alpha + warp_sum(p);
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] *= alpha;
  for (int j = 0; j < TILE; ++j) {
    if (!((ok >> j) & 1u)) continue;
    const float pj = __shfl_sync(FULL, p, j);
    const T* vr = vs + j * D + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += pj * to_f(vr[e]);
  }
  m = m_new;
}

}  // namespace pst
