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
// (every serving model) runs both products on the tensor cores, with
// wgmma (sm_90a), and the design is about keeping them fed:
//  - GQA-packed rows: a warpgroup holds 64 (token, head) rows of one KV
//    head's group, tpw = 64 / G tokens x G heads (padding rows when G does
//    not divide 64), so one staged K/V tile feeds every head of the group
//    in one 64-row product; a block is two such warpgroups (2 tpw tokens,
//    256 threads; one warpgroup at D = 256), grid (ceil(T / (2 tpw)), KH, B);
//  - the block walks history slots [max(min query pos - window + 1, 0),
//    min(paged_end, max query pos + 1)) through the page table, then the
//    chunk's own entries up to its last token (the causal upper triangle
//    is never loaded), in
//    64-key tiles (32 at D = 256) copied with 16-byte cp.async into a ring
//    of NS stages (5 at D = 64, 4 at D = 128 and 256) with one block
//    barrier per tile; rows are stored in wgmma's 128-byte-swizzled K-major
//    layout (a D = 64 bf16 row is one 128-byte line; D = 128 and 256 are
//    two and four 64-column halves), rows past a tile's last key as zeros,
//    so a masked key never brings stale bytes (NaN) into P V;
//  - S = Q K^T is wgmma m64n64k16 with K from the swizzled tile and Q in
//    registers (read once with ldmatrix from its swizzled rows: Q from
//    shared memory doubled the tile's shared-memory reads, which bounded
//    the product's issue); O += P V is m64n{D}k16 with P in registers (the
//    S accumulator layout repacked to bf16) and V from the same tile,
//    transposed; f32 accumulators, the masked online softmax in f32
//    registers, unmasked for a warp whose rows all see all of a tile;
//  - D = 256 (Gemma-2) breaks both budgets of that plan: a thread's O is
//    128 f32 registers, so Q (64 more) stays in shared memory and S = Q K^T
//    reads both operands from there (m64n32k16); and a 4-stage ring of
//    64-key tiles would take 256 KB beside Q's 64 KB, so tiles hold 32 keys
//    (a 128 KB ring). P V runs as two m64n128k16 products per 16 keys, one
//    per 128-column half of V. A block is one warpgroup, with three tiles
//    in flight; one warp per scheduler leaves every latency bare, so the
//    capped softmax takes tanh from the SFU's exp2 and reciprocal;
//  - the products overlap the rest: S of tile i + 1 and P V of tile i run
//    while the next copy is issued and the softmax of tile i + 1 is
//    computed, and every iteration issues and waits the same two wgmma
//    groups, so ptxas keeps them asynchronous (a row that cannot see a
//    tile still runs its products, with p = 0).
// f32 inputs take a CUDA-core fold of the same tiles (tests and references;
// no served model runs f32). Later work: TMA-fed tiles with a producer warp
// (the cp.async copies cost as much issue time as the softmax).
//
// int8 history (the bf16 path): the raw int8 rows and their pages' K and V
// scales ride the same ring (16-byte and 4-byte cp.async); each thread
// converts the rows it copied to bf16 in shared memory, exactly (|q| <= 127),
// two tiles ahead at D = 64 (one at D = 128), so no extra barrier stands
// between copy and conversion; the products are those of the bf16 path.
// Each score column is then multiplied by its key's page K scale in f32,
// and each probability by its key's V scale before it is rounded to bf16
// for P V. Scales are looked up per key, so any page size works. The f32
// kernel dequantizes history rows in f32 as it stages them.
//
// The chunk's KV write runs in the same launch (fused_write = 1), as the
// TPU kernel's fused write does, after each block has stored its output:
// every cp.async and wgmma group has been waited on, the accumulators are
// dead, and the write reads k_cur/v_cur from device memory (the rows the
// block's chunk tiles just read, so mostly from L2), off the ring and the
// tile loop's registers, in a function of its own (write_chunk, not
// inlined: the tile loop keeps its register allocation). A standalone
// write kernel spent 7-20 us a launch on ~1 MB of copies (0.5-1.3 us at
// the card's bandwidth); in the launch that cost goes. The write runs once
// per block, so it is latency-bound: its loads are issued together (fp) or
// staged by cp.async (int8). Work per block (x, kh, b), every thread
// joining:
//  - fp pools: KV head kh's D-element rows, K and V, of the block's own
//    query tokens [x * N_WG * tpw, ...) (f32: [x * TQ, ...)) below
//    cur_lens[b], each to slot positions[b, t] (-1, or a page past the
//    table, drops), in 16-byte vectors: each (token, KV head) once;
//  - int8 pools: row b's page tasks, one per (page overlapping the chunk's
//    positions [kv_len - cur_len, kv_len) inside the table, K or V): task
//    i goes to block x = i mod ceil(gridDim.x / 2), the lower half of the
//    x-blocks, lowest x first: under the causal mask those see the fewest
//    chunk keys and finish first, while the highest x sets the launch's
//    end. A task is the quantizing write of one page for KV head kh: its
//    chunk rows staged by cp.async in the block's shared memory (the Q
//    rows and rings, free now), a block-wide f32 amax over the page's kept
//    slots x D, a barrier, then the int8 stores; a fresh page (slot 0 at
//    or after the chunk start)
//    takes scale max(amax * f32(1/127), 1e-8) and is written whole, zeros
//    past the chunk; an unaligned head page keeps its scale, clips, and
//    only its slots in the chunk change. No thread returns early, so a
//    block whose tokens are all padding still takes its tasks.
// Why blocks may write while others of the launch still read:
//  - attention reads only pool slots below paged_end = kv_len - cur_len,
//    and the scales of the pages that hold them;
//  - the fp write touches only slots at or above paged_end (the
//    scheduler's chunks are contiguous from paged_end);
//  - the int8 write rewrites a scale only on a fresh page, whose slot 0 is
//    at or above paged_end, and never rewrites a history slot of a head
//    page (the hazard the JAX kernel's comment at prefill_attention.py:
//    312-320 names);
//  - no page is one row's history and another row's written page in one
//    batch: engine/kv_manager.py shares only whole cached pages, all below
//    a row's paged_end (match_prefix counts page_size tokens a page), and
//    publishes a page only once full (register_filled), after which its
//    owner writes no slot of it; a row's written pages are its own.
// So the pools are plain pointers here (written in the launch), never
// const __restrict__.
#include <type_traits>

#include "attention_common.cuh"

// Marks between the steps of the bf16 kernel's tile loop, empty here;
// scripts/prefill_phase_clocks.py defines them as clock probes.
#ifndef PHASE_MARK
#define PHASE_LOOP_BEGIN
#define PHASE_MARK(step)
#define PHASE_LOOP_END
#endif

namespace {

using namespace pst;

// ---- bf16: tensor cores -------------------------------------------------

constexpr int MMA_MAX_G = 8;    // query heads per KV head
constexpr int WG_ROWS = 64;     // (token, head) rows of one warpgroup

// Shared memory of one block, every tile 1024-byte aligned (the SW128 atom):
// Q rows [N_WG][64][D], K and V tiles [NS][BKV][D] in bf16, both in wgmma's
// K-major SW128 layout (sw128 below); with int8 pools the raw history
// tiles [RAW_NS][BKV][D] int8 and the keys' page scales; the keys'
// positions; the query range and the int8 write's per-warp amax.
template <int D, bool QUANT>
struct MmaSmem {
  static constexpr int BKV = D == 256 ? 32 : 64;  // keys per staged K/V tile
  static constexpr bool Q_SMEM = D == 256;        // S = Q K^T reads Q from shared memory
  // warpgroups per block: one at D = 256, so a 512-token chunk of a G = 2
  // model makes 16 blocks per KV head, not 8 (one block fills an SM's
  // shared memory either way)
  static constexpr int N_WG = D == 256 ? 1 : 2;
  static constexpr int THREADS = 128 * N_WG;
  static constexpr int NS = D == 64 ? 5 : 4;  // bf16 ring stages
  // tiles in flight ahead of the one being folded: NS - 2 keeps a stage
  // idle; at D = 256, whose one warpgroup issues its copies late in the
  // tile, NS - 1 gives each copy two tiles' time to land (the stage it
  // fills held tile i - 1, free after the barrier that opens tile i)
  static constexpr int AHEAD = D == 256 ? NS - 1 : NS - 2;
  // int8 stages: one per tile in flight, so a raw tile converts before the
  // ring wraps to it
  static constexpr int RAW_NS = AHEAD;
  static constexpr int TILE = BKV * D * 2;    // one bf16 K or V tile
  static constexpr int QB = WG_ROWS * D * 2;  // one warpgroup's Q rows
  static constexpr int RAW = BKV * D;         // one int8 K or V tile
  static constexpr int q = 0;
  static constexpr int k = q + N_WG * QB;
  static constexpr int v = k + NS * TILE;
  static constexpr int raw_k = v + NS * TILE;
  static constexpr int raw_v = raw_k + (QUANT ? RAW_NS * RAW : 0);
  static constexpr int kpos = raw_v + (QUANT ? RAW_NS * RAW : 0);
  static constexpr int kscl = kpos + NS * BKV * 4;
  static constexpr int vscl = kscl + (QUANT ? NS * BKV * 4 : 0);
  static constexpr int qrange = vscl + (QUANT ? NS * BKV * 4 : 0);  // [N_WG][2 warps][min, max]
  static constexpr int amax = qrange + N_WG * 16;                   // the int8 write's [warps] f32
  static constexpr int bytes = amax + N_WG * 16 + 1024;            // + slack to align the base
  static_assert(bytes <= 232448, "a block holds at most 227 KB of shared memory");
};

// Byte offset of 16-byte chunk c (along D) of row r in a [ROWS][D] bf16
// tile laid out as wgmma's K-major SW128 operand: 64-column halves of ROWS
// rows x 128 B, chunk c of row r stored at chunk c ^ (r % 8) of its row.
// The 8 rows of an ldmatrix, or of a 16-byte store per row, then hit 8
// distinct bank groups.
template <int ROWS>
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (uint32_t)((c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// ---- wgmma (sm_90a): one warpgroup, 64 rows, f32 accumulators in the
// mma.m16n8 layout per 8-column block (register 4 j + e of a thread is
// element e of block j) ----------------------------------------------------

// Shared-memory matrix descriptor of an SW128 operand (bits 0-13 address,
// 16-29 leading and 32-45 stride byte offsets, all in 16-byte units; 62-63
// the 128-byte swizzle). K-major tiles (Q, K): stride = 1024 B between
// 8-row groups, leading unused (1). MN-major (V, transposed): leading =
// 8 KB between 64-column halves, stride = 1024 B between 8-key groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lead, uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lead >> 4) << 16) | ((uint64_t)(stride >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory (cp.async, stores) made visible to
// wgmma's reads; each writer runs it before the barrier
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// keeps the compiler from moving accesses of accumulator registers across
// the asynchronous products
template <int M>
__device__ __forceinline__ void fence_regs(float (&r)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(r[i][e])::"memory");
  }
}

// d (+)= A B, m64n64k16, A (bf16 pairs) in registers, B K-major in shared
// memory; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_rs_k_n64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d += A B, m64n64k16, A (bf16 pairs) in registers, B MN-major in shared
// memory (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[O .. O + 15] += A B, m64n128k16, A (bf16 pairs) in registers, B MN-major
// in shared memory (transposed)
#define PST_D4(i) "+f"(d[O + i][0]), "+f"(d[O + i][1]), "+f"(d[O + i][2]), "+f"(d[O + i][3])
template <int O = 0, int N>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[N][4], const uint32_t (&a)[4], uint64_t b) {
  static_assert(O + 16 <= N, "16 accumulator blocks");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : PST_D4(0), PST_D4(1), PST_D4(2), PST_D4(3), PST_D4(4), PST_D4(5), PST_D4(6), PST_D4(7), PST_D4(8),
        PST_D4(9), PST_D4(10), PST_D4(11), PST_D4(12), PST_D4(13), PST_D4(14), PST_D4(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (+)= A B, m64n32k16, A and B both K-major in shared memory; scale_d = 0
// overwrites d
__device__ __forceinline__ void wgmma_ss_k_n32(float (&d)[4][4], uint64_t a, uint64_t b, int scale_d) {
  constexpr int O = 0;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : PST_D4(0), PST_D4(1), PST_D4(2), PST_D4(3)
      : "l"(a), "l"(b), "r"(scale_d));
}
#undef PST_D4

// d += P V over the D columns of a V tile of `rows` keys whose 16 keys start
// at shared address v: one product, or at D = 256 one per 128-column half
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 8][4], const uint32_t (&a)[4], uint32_t v, int rows) {
  const uint64_t b = sw128_desc(v, rows * 128, 1024);
  if constexpr (D == 64) {
    wgmma_rs_n64(d, a, b);
  } else if constexpr (D == 128) {
    wgmma_rs_n128(d, a, b);
  } else {
    wgmma_rs_n128<0>(d, a, b);
    wgmma_rs_n128<16>(d, a, sw128_desc(v + 2 * rows * 128, rows * 128, 1024));
  }
}

// 16 int8 pool values -> 16 bf16 (two 16-byte chunks), exactly (|q| <= 127).
__device__ __forceinline__ void int8x16_to_bf16(uint4 raw, uint4& lo, uint4& hi) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
    int8x4_to_f32(w[i], f);
    o[2 * i] = pack_bf16(f[0], f[1]);
    o[2 * i + 1] = pack_bf16(f[2], f[3]);
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

// ---- the chunk's KV write, run by every thread of a block after its
// attention (the header says which block takes what) -----------------------

// fp rows: 16-byte loads in flight per thread, so that a block's share of
// the write costs a round or two of device-memory latency, not one per
// access. The write's code runs once per block, with the instruction cache
// cold: unrolled wider (8) it took longer on the H100.
constexpr int WRITE_ILP = 4;

// fp pools: chunk tokens [t0, t1) of row b (t1 <= cur_lens[b]), KV head
// kh, K and V: token t's D-element row to slot positions[b, t] of `layer`,
// in 16-byte vectors; a position of -1, or on a page past the table, drops.
// The same bytes as ops/attention.write_kv_pages_all_layers for one layer.
template <int D, typename T>
__device__ __forceinline__ void write_rows(const T* __restrict__ k_cur, const T* __restrict__ v_cur,
                                           T* k_pages, T* v_pages, const int* __restrict__ pos_b,
                                           const int* __restrict__ pt, int b, int kh, int Tn, int KH, int P,
                                           PageDiv pdiv, int max_pages, int layer, int t0, int t1) {
  constexpr int VPR = D * (int)sizeof(T) / 16;  // 16-byte vectors per row
  const int n = (t1 - t0) * VPR;
  for (int i0 = threadIdx.x; i0 < n; i0 += WRITE_ILP * blockDim.x) {
    uint4 k[WRITE_ILP], v[WRITE_ILP];
    size_t dst[WRITE_ILP];
    bool ok[WRITE_ILP];
#pragma unroll
    for (int r = 0; r < WRITE_ILP; ++r) {  // every load first, then every store
      const int i = i0 + r * blockDim.x;
      const int t = t0 + i / VPR, c = i % VPR;
      const int pos = i < n ? pos_b[t] : -1;
      const int pg = pos < 0 ? max_pages : pdiv.page(pos);
      ok[r] = pg < max_pages;
      if (ok[r]) {
        // row starts, in 16-byte vectors
        dst[r] = ((((size_t)layer * P + pt[pg]) * pdiv.size + pos - pg * pdiv.size) * KH + kh) * VPR + c;
        const size_t src = (((size_t)b * Tn + t) * KH + kh) * VPR + c;
        k[r] = reinterpret_cast<const uint4*>(k_cur)[src];
        v[r] = reinterpret_cast<const uint4*>(v_cur)[src];
      }
    }
#pragma unroll
    for (int r = 0; r < WRITE_ILP; ++r) {
      if (ok[r]) {
        reinterpret_cast<uint4*>(k_pages)[dst[r]] = k[r];
        reinterpret_cast<uint4*>(v_pages)[dst[r]] = v[r];
      }
    }
  }
}

// One value quantized into a page of scale `scale`: round(x / scale), half
// to even, clipped to +-127 (ops/quant.py). An IEEE division, never a
// multiply by the reciprocal: the same bytes as the JAX package.
__device__ __forceinline__ signed char quant1(float x, float scale) {
  return (signed char)max(-127, min(127, __float2int_rn(__fdiv_rn(x, scale))));
}

// 16 bytes of chunk K/V (8 bf16 or 4 f32 values) as floats, exactly
template <typename T>
__device__ __forceinline__ void unpack16(uint4 u, float (&f)[16 / sizeof(T)]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 2) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
      f[i] = __uint_as_float(w[i]);
    }
  }
}

// int8 pools: the quantizing write of logical page lp of row b for KV head
// kh, from `cur` (k_cur or v_cur) into `pool` and its `scales` [L, P, KH]
// (the JAX kernel's fused int8 write, prefill_attention.py:304-394). The
// chunk holds positions [s0, e0) = [kv_len - cur_len, kv_len). A fresh page
// (slot 0 at or after s0) takes scale max(amax * f32(1 / 127), 1e-8) over
// its kept slots x D and is written whole, zeros past the chunk; a head
// page that starts before s0 keeps its scale, and only its kept slots are
// written (clipped). The page's chunk rows are staged by cp.async in the
// block's shared memory, free once attention is done (`stage`, room for
// `stage_slots` slots, at most the page's per copy): every copy of a slab in
// flight at once, then the amax and the stores read shared memory; a page
// that fits is staged once. s_amax holds one float per warp; every thread
// joins.
template <int D, typename T>
__device__ __forceinline__ void write_page_quant(const T* __restrict__ cur, int8_t* pool, float* scales,
                                                 float* s_amax, T* stage, int stage_slots,
                                                 const int* __restrict__ pt, int b, int kh, int lp, int s0, int e0,
                                                 int Tn, int KH, int P, int page_size, int max_pages, int layer) {
  constexpr int E = 16 / (int)sizeof(T);  // values of one slot per 16-byte group
  constexpr int GPR = D / E;              // groups per slot
  const int NT = blockDim.x;
  const int start = lp * page_size;
  const int pid = pt[(size_t)b * max_pages + lp];
  const bool fresh = start >= s0;  // block-uniform
  const size_t row = (size_t)KH * D;
  int8_t* dst = pool + ((size_t)layer * P + pid) * page_size * row + (size_t)kh * D;
  float* sc = scales + ((size_t)layer * P + pid) * KH + kh;
  const int slab = min(page_size, stage_slots);
  auto kept = [&](int s) { return start + s >= s0 && start + s < e0; };
  // the page's slots [lo, lo + n) -> stage, zeros outside the chunk
  auto stage_slab = [&](int lo, int n) {
    __syncthreads();  // every earlier read of the stage is done
    for (int i = threadIdx.x; i < n * GPR; i += NT) {
      const int s = lo + i / GPR;
      const int t = kept(s) ? start + s - s0 : 0;
      cp_async16_or_zero(stage + (size_t)i * E, cur + ((size_t)b * Tn + t) * row + (size_t)kh * D + (i % GPR) * E,
                         kept(s));
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  };
  auto values = [&](int i, float (&x)[E]) { unpack16<T>(reinterpret_cast<const uint4*>(stage)[i], x); };
  float scale;
  if (fresh) {
    float amax = 0.f;
    for (int lo = 0; lo < page_size; lo += slab) {
      const int n = min(slab, page_size - lo);
      stage_slab(lo, n);
      for (int i = threadIdx.x; i < n * GPR; i += NT) {
        float x[E];
        values(i, x);
#pragma unroll
        for (int e = 0; e < E; ++e) amax = fmaxf(amax, fabsf(x[e]));
      }
    }
    amax = warp_max(amax);
    // the previous task's reads of s_amax came before this task's first stage barrier
    if ((threadIdx.x & 31) == 0) s_amax[threadIdx.x >> 5] = amax;
    __syncthreads();
    for (int w = 0; w < NT / 32; ++w) amax = fmaxf(amax, s_amax[w]);
    // amax * f32(1 / 127): the JAX package's compiled programs fold amax /
    // 127 into this multiply (ops/quant.py)
    scale = fmaxf(__fmul_rn(amax, 1.f / 127.f), 1e-8f);
  } else {
    scale = *sc;
  }
  for (int lo = 0; lo < page_size; lo += slab) {
    const int n = min(slab, page_size - lo);
    if (!fresh || slab < page_size) stage_slab(lo, n);  // else the page is still staged
    for (int i = threadIdx.x; i < n * GPR; i += NT) {
      const int s = lo + i / GPR;
      if (!fresh && !kept(s)) continue;  // a head page keeps its earlier slots
      float x[E];
      values(i, x);
      uint32_t w[E / 4];
#pragma unroll
      for (int h = 0; h < E / 4; ++h) {
        w[h] = (uint32_t)(uint8_t)quant1(x[4 * h], scale) | (uint32_t)(uint8_t)quant1(x[4 * h + 1], scale) << 8 |
               (uint32_t)(uint8_t)quant1(x[4 * h + 2], scale) << 16 |
               (uint32_t)(uint8_t)quant1(x[4 * h + 3], scale) << 24;
      }
      int8_t* o = dst + (size_t)s * row + (i % GPR) * E;
      if constexpr (E == 8) {
        *reinterpret_cast<uint2*>(o) = make_uint2(w[0], w[1]);
      } else {
        *reinterpret_cast<uint32_t*>(o) = w[0];
      }
    }
  }
  if (fresh && threadIdx.x == 0) *sc = scale;
}

// Block (x, kh, b)'s share of the chunk's write: its query tokens [t0, t1)
// (fp pools), or row b's page tasks x, x + H, ... with H = ceil(gridDim.x /
// 2), none for x >= H (int8 pools; K of page j is task 2 j, V task 2 j + 1),
// staged through the block's shared memory [smem, smem + smem_bytes).
// Not inlined, so the write's code leaves the register allocation of the
// attention before it as it was (inlined, the int8 D = 256 kernel went from
// 227 to 234 registers and its attention-only launch 4% slower on the H100).
template <int D, typename T, typename KV>
__device__ __noinline__ void write_chunk(const T* __restrict__ k_cur, const T* __restrict__ v_cur, KV* k_pages,
                                         KV* v_pages, float* k_scales, float* v_scales, float* s_amax,
                                         unsigned char* smem, int smem_bytes, const int* __restrict__ pos_b,
                                         const int* __restrict__ page_table, const int* __restrict__ kv_lens,
                                         const int* __restrict__ cur_lens, int b, int kh, int Tn, int KH, int P,
                                         PageDiv pdiv, int max_pages, int layer, int t0, int t1) {
  const int cl = cur_lens[b];
  if constexpr (sizeof(KV) == 1) {
    if (cl <= 0) return;  // block-uniform
    const int e0 = kv_lens[b], s0 = e0 - cl;
    const int lp0 = pdiv.page(s0);
    const int n_pages = min(pdiv.page(e0 - 1) + 1, max_pages) - lp0;
    const int H = (gridDim.x + 1) / 2;  // the blocks that take tasks
    for (int i = blockIdx.x; blockIdx.x < H && i < 2 * n_pages; i += H) {
      const bool v = i & 1;
      write_page_quant<D>(v ? v_cur : k_cur, v ? v_pages : k_pages, v ? v_scales : k_scales, s_amax,
                          reinterpret_cast<T*>(smem), smem_bytes / (D * (int)sizeof(T)), page_table, b, kh,
                          lp0 + i / 2, s0, e0, Tn, KH, P, pdiv.size, max_pages, layer);
    }
  } else {
    write_rows<D>(k_cur, v_cur, k_pages, v_pages, pos_b, page_table + (size_t)b * max_pages, b, kh, Tn, KH, P,
                  pdiv, max_pages, layer, t0, min(t1, min(cl, Tn)));
  }
}

// One block per (2 * tpw query tokens, KV head, batch row): two warpgroups,
// each of 64 rows = tpw tokens x G heads of the KV head's group (row r is
// token r / G, head r % G; rows past tpw * G are padding). Warp w of a
// warpgroup holds its rows 16 w .. 16 w + 15 of the wgmma accumulators,
// laid out per 8-column block as mma.m16n8k16's: lane = 4 * g + qd holds
// rows g and g + 8 and column pairs 2 * qd (+ 8).
template <int D, typename KV>
__global__ void __launch_bounds__(MmaSmem<D, sizeof(KV) == 1>::THREADS) prefill_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const int* __restrict__ positions, KV* k_pages, KV* v_pages,
    float* k_scales, float* v_scales, const __nv_bfloat16* __restrict__ k_cur,
    const __nv_bfloat16* __restrict__ v_cur, const int* __restrict__ page_table, const int* __restrict__ kv_lens,
    const int* __restrict__ cur_lens, __nv_bfloat16* __restrict__ out, int Tn, int NH, int KH, int P,
    PageDiv pdiv, int max_pages, int layer, int window, float sm_scale, float softcap, int tpw, int fused_write) {
  using T = __nv_bfloat16;
  constexpr bool QUANT = sizeof(KV) == 1;
  using L = MmaSmem<D, QUANT>;
  constexpr int NS = L::NS;
  constexpr int BKV = L::BKV;
  constexpr int N_WG = L::N_WG;
  constexpr int CPR = D / 8;  // 16-byte bf16 chunks per row
  constexpr int NB = BKV / 8; // 8-key score blocks per tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  int* s_qr = reinterpret_cast<int*>(sm + L::qrange);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;  // warp within its warpgroup
  const int lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = NH / KH;
  const int rows = tpw * G;
  const int page_size = pdiv.size;
  const int cta_t0 = blockIdx.x * N_WG * tpw;
  const int wg_t0 = cta_t0 + wg * tpw;
  const int* pos_b = positions + (size_t)b * Tn;

  {  // the block's query positions: each warpgroup's first two warps reduce its tokens
    const int x = tid & 127;
    int lo_p = 0x7fffffff, hi_p = -1;
    if (x < tpw && wg_t0 + x < Tn) {
      const int p = pos_b[wg_t0 + x];
      if (p >= 0) lo_p = hi_p = p;
    }
    if (x < 64) {  // tpw <= 64 (warp-uniform)
      lo_p = __reduce_min_sync(FULL, lo_p);
      hi_p = __reduce_max_sync(FULL, hi_p);
      if (lane == 0) {
        s_qr[4 * wg + 2 * warp] = lo_p;
        s_qr[4 * wg + 2 * warp + 1] = hi_p;
      }
    }
  }
  // this warpgroup's Q rows -> shared (the first cp.async group), pad rows 0
  unsigned char* qs = sm + L::q + wg * L::QB;
  for (int x = tid & 127; x < WG_ROWS * CPR; x += 128) {
    const int r = x / CPR, c = x % CPR;
    const int t = wg_t0 + r / G;
    if (r < rows && t < Tn) {
      cp_async16(qs + sw128<WG_ROWS>(r, c), q + (((size_t)b * Tn + t) * NH + kh * G + r % G) * D + 8 * c);
    } else {
      *reinterpret_cast<uint4*>(qs + sw128<WG_ROWS>(r, c)) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __syncthreads();
  int qmin = 0x7fffffff, qmax = -1;
#pragma unroll
  for (int x = 0; x < 2 * N_WG; ++x) {
    qmin = min(qmin, s_qr[2 * x]);
    qmax = max(qmax, s_qr[2 * x + 1]);
  }

  // this thread's rows: 16 warp + g (hf = 0) and 16 warp + g + 8 (hf = 1)
  int qpos[2];
  float m_r[2], l_r[2], oacc[D / 8][4];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = 16 * warp + g + 8 * hf;
    const int t = wg_t0 + r / G;
    qpos[hf] = (r < rows && t < Tn) ? pos_b[t] : -1;
    m_r[hf] = NEG_INF;
    l_r[hf] = 0.f;
  }
  // this warp's 16 rows' positions (-1 in the min if any row is padding)
  const int w_qmin = __reduce_min_sync(FULL, min(qpos[0], qpos[1]));
  const int w_qmax = __reduce_max_sync(FULL, max(qpos[0], qpos[1]));
#pragma unroll
  for (int db = 0; db < D / 8; ++db) {
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[db][e] = 0.f;
  }

  const size_t slot_stride = (size_t)KH * D;
  const size_t layer_off = (size_t)layer * P * page_size * slot_stride + (size_t)kh * D;
  const int* pt = page_table + (size_t)b * max_pages;
  int lo = 0, hi = 0, jend = 0, n_hist = 0, n_tiles = 0;
  if (qmax >= 0) {  // the block holds at least one real query
    const int paged_end = kv_lens[b] - cur_lens[b];
    lo = max(qmin - window + 1, 0);
    hi = min(min(paged_end, qmax + 1), max_pages * page_size);
    // causal: chunk entries past the block's last token are invisible to it
    jend = min(cur_lens[b], min(cta_t0 + N_WG * tpw, Tn));
    n_hist = hi > lo ? (hi - lo + BKV - 1) / BKV : 0;
    n_tiles = n_hist + (jend + BKV - 1) / BKV;
  }
  // history slot -> its pool row through the page table (a cached read:
  // the tiles of a block walk a few consecutive entries)
  auto slot_row = [&](int slot) -> size_t {
    const int pg = pdiv.page(slot);
    return layer_off + (size_t)(pt[pg] * page_size + slot - pg * page_size) * slot_stride;
  };

  // Tile j into ring stage j % NS (int8 history rows into raw stage j %
  // RAW_NS): history slots [lo + j * BKV, ...) through the page table, then
  // the chunk's own entries; bf16 rows land swizzled. Warpgroup w copies
  // rows [32 w, 32 w + 32) of K and V, each thread the same rows and
  // 16-byte column of every tile, rows past the tile's n keys as zeros (so
  // a masked key never carries stale bytes, NaN, into P.V). Every call
  // commits one cp.async group.
  constexpr int HALF = BKV / N_WG;                     // rows a warpgroup copies
  constexpr int RSTEP = 128 / CPR;                     // rows apart of one thread's chunks
  constexpr int RAW_CPR = D / 16;                      // 16-byte int8 chunks per row
  constexpr int RAW_RSTEP = 128 / RAW_CPR;
  const int x0 = tid & 127;                            // this thread's index in its warpgroup
  const int cr = wg * HALF + x0 / CPR, cc = x0 % CPR;  // bf16: rows cr + k RSTEP, column chunk cc
  const int rr = wg * HALF + x0 / RAW_CPR, rc = x0 % RAW_CPR;  // int8: rows rr + k RAW_RSTEP, chunk rc
  const int kr = wg * HALF + x0;                       // key position and scales of row kr (x0 < HALF)
  auto issue = [&](int j) {
    if (j < n_tiles) {
      const int st = j % NS;
      unsigned char* kd = sm + L::k + st * L::TILE;
      unsigned char* vd = sm + L::v + st * L::TILE;
      int* kp = reinterpret_cast<int*>(sm + L::kpos) + st * BKV;
      float* ksc = reinterpret_cast<float*>(sm + L::kscl) + st * BKV;
      float* vsc = reinterpret_cast<float*>(sm + L::vscl) + st * BKV;
      if (j < n_hist) {
        const int t0 = lo + j * BKV;
        const int n = min(BKV, hi - t0);
        if constexpr (QUANT) {
          int8_t* rk = reinterpret_cast<int8_t*>(sm + L::raw_k) + (j % L::RAW_NS) * L::RAW;
          int8_t* rv = reinterpret_cast<int8_t*>(sm + L::raw_v) + (j % L::RAW_NS) * L::RAW;
#pragma unroll
          for (int k = 0; k < HALF / RAW_RSTEP; ++k) {
            const int r = rr + k * RAW_RSTEP;
            const size_t off = slot_row(t0 + (r < n ? r : 0)) + 16 * rc;
            cp_async16_or_zero(rk + r * D + 16 * rc, k_pages + off, r < n);
            cp_async16_or_zero(rv + r * D + 16 * rc, v_pages + off, r < n);
          }
          if (x0 < HALF) {
            const size_t sc = ((size_t)layer * P + pt[pdiv.page(t0 + (kr < n ? kr : 0))]) * KH + kh;
            cp_async4_or_zero(ksc + kr, k_scales + sc, kr < n);
            cp_async4_or_zero(vsc + kr, v_scales + sc, kr < n);
          }
        } else {
#pragma unroll
          for (int k = 0; k < HALF / RSTEP; ++k) {
            const int r = cr + k * RSTEP;
            const size_t off = slot_row(t0 + (r < n ? r : 0)) + 8 * cc;
            cp_async16_or_zero(kd + sw128<BKV>(r, cc), k_pages + off, r < n);
            cp_async16_or_zero(vd + sw128<BKV>(r, cc), v_pages + off, r < n);
          }
        }
        if (x0 < HALF) kp[kr] = kr < n ? t0 + kr : -1;
      } else {
        const int j0 = (j - n_hist) * BKV;
        const int n = min(BKV, jend - j0);
#pragma unroll
        for (int k = 0; k < HALF / RSTEP; ++k) {
          const int r = cr + k * RSTEP;
          const size_t off = (((size_t)b * Tn + j0 + (r < n ? r : 0)) * KH + kh) * D + 8 * cc;
          cp_async16_or_zero(kd + sw128<BKV>(r, cc), k_cur + off, r < n);
          cp_async16_or_zero(vd + sw128<BKV>(r, cc), v_cur + off, r < n);
        }
        if (x0 < HALF) {
          if (kr < n) {
            cp_async4(kp + kr, pos_b + j0 + kr);
          } else {
            kp[kr] = -1;
          }
          if constexpr (QUANT) ksc[kr] = vsc[kr] = 1.f;  // the chunk is fp
        }
      }
    }
    cp_async_commit();
  };

  // int8 history tile j, whose copies by this thread have landed: the
  // chunks this thread copied -> bf16 in the tile's stage, exactly (zeros
  // stay zeros). Each thread converts its own chunks, so no barrier stands
  // between copy and conversion.
  auto convert = [&](int j) {
    if constexpr (QUANT) {
      if (j >= n_hist) return;
      const int8_t* rk = reinterpret_cast<const int8_t*>(sm + L::raw_k) + (j % L::RAW_NS) * L::RAW;
      const int8_t* rv = reinterpret_cast<const int8_t*>(sm + L::raw_v) + (j % L::RAW_NS) * L::RAW;
      unsigned char* kd = sm + L::k + (j % NS) * L::TILE;
      unsigned char* vd = sm + L::v + (j % NS) * L::TILE;
#pragma unroll
      for (int k = 0; k < HALF / RAW_RSTEP; ++k) {
        const int r = rr + k * RAW_RSTEP;
        uint4 k0, k1, v0, v1;
        int8x16_to_bf16(*reinterpret_cast<const uint4*>(rk + r * D + 16 * rc), k0, k1);
        int8x16_to_bf16(*reinterpret_cast<const uint4*>(rv + r * D + 16 * rc), v0, v1);
        *reinterpret_cast<uint4*>(kd + sw128<BKV>(r, 2 * rc)) = k0;
        *reinterpret_cast<uint4*>(kd + sw128<BKV>(r, 2 * rc + 1)) = k1;
        *reinterpret_cast<uint4*>(vd + sw128<BKV>(r, 2 * rc)) = v0;
        *reinterpret_cast<uint4*>(vd + sw128<BKV>(r, 2 * rc + 1)) = v1;
      }
    }
  };
  // with five or more stages, int8 tile i + 2 converts during tile i, off
  // the barrier's path; with four, tile i + 1 converts just before it
  constexpr bool EARLY = QUANT && NS >= 5;

  // the positions [kmin, kmax] of tile j's n keys
  auto tile_keys = [&](int j, int& kmin, int& kmax, int& n) {
    if (j < n_hist) {
      kmin = lo + j * BKV;
      n = min(BKV, hi - kmin);
      kmax = kmin + n - 1;
    } else {
      const int j0 = (j - n_hist) * BKV;
      n = min(BKV, jend - j0);
      kmin = pos_b[j0];
      kmax = pos_b[j0 + n - 1];
    }
  };

  // S = Q K(j)^T on the tensor cores, asynchronously: D / 16 steps of 16
  // columns (32 bytes) along the swizzled rows, then a tile's rows x 128 B
  // to the next half
  uint32_t qa[L::Q_SMEM ? 1 : D / 16][4];  // Q (A of S = Q K^T) in registers, read once from its swizzled rows
  auto vt_addr = [&](int j) { return smem_u32(sm + L::v + (j % NS) * L::TILE); };
  auto issue_s = [&](int j, float (&acc)[NB][4]) {
    const uint32_t kt = smem_u32(sm + L::k + (j % NS) * L::TILE);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * (BKV * 128) + (kk & 3) * 32;
      if constexpr (L::Q_SMEM) {
        const uint32_t qoff = (kk >> 2) * (WG_ROWS * 128) + (kk & 3) * 32;
        wgmma_ss_k_n32(acc, sw128_desc(smem_u32(qs) + qoff, 16, 1024), sw128_desc(kt + off, 16, 1024), kk > 0);
      } else {
        wgmma_rs_k_n64(acc, qa[kk], sw128_desc(kt + off, 16, 1024), kk > 0);
      }
    }
    wgmma_commit();
  };

  float s[NB][4], alpha[2];
  uint32_t pa[NB / 2][4];
  // online softmax of tile i in log2 units; p overwrites s, and alpha
  // rescales O. Column (nb, e) of this thread is key nb * 8 + 2 qd + e.
  // MASKED: some row of this warp cannot see some key of the tile; CAPPED:
  // logit softcap; SCALED: int8 keys from more than one page, so K and V
  // scales go per column (else one factor each for the tile). Unmasked,
  // uncapped, one-factor tiles (nearly every tile of a long prefill) take
  // the maximum of the raw scores and one FFMA per score into exp2.
  auto softmax = [&](auto masked, auto capped, auto scaled, int i) {
    constexpr bool MASKED = decltype(masked)::value;
    constexpr bool CAPPED = decltype(capped)::value;
    constexpr bool SCALED = decltype(scaled)::value;
    constexpr bool FOLD = !MASKED && !CAPPED && !SCALED;
    const int* kp = reinterpret_cast<const int*>(sm + L::kpos) + (i % NS) * BKV;
    const float* ksc = reinterpret_cast<const float*>(sm + L::kscl) + (i % NS) * BKV;
    const float* vsc = reinterpret_cast<const float*>(sm + L::vscl) + (i % NS) * BKV;
    const float f = CAPPED ? sm_scale : sm_scale * LOG2E;
    const float inv_cap = CAPPED ? 1.f / softcap : 0.f, capf = softcap * LOG2E;
    const float kf0 = QUANT && !SCALED ? f * ksc[0] : f;  // score -> log2 domain
    const float vs0 = QUANT && !SCALED ? vsc[0] : 1.f;
    float kf[NB][2];  // per column, SCALED only
    if constexpr (SCALED) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) kf[nb][e] = f * ksc[nb * 8 + 2 * qd + e];
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
          float x = s[nb][2 * hf + e];
          if constexpr (!FOLD) {
            x *= SCALED ? kf[nb][e] : kf0;
            if constexpr (CAPPED) {
              // D = 256: tanh_sfu and a multiply (as accurate as tanhf),
              // where the one warp a scheduler leaves tanhf's branches and
              // the division bare
              x = D == 256 ? capf * tanh_sfu(x * inv_cap) : softcap * LOG2E * tanhf(x / softcap);
            }
            if constexpr (MASKED) {
              const int kpos = kp[nb * 8 + 2 * qd + e];
              x = kpos >= 0 && kpos <= qp && kpos > qp - window ? x : NEG_INF;
            }
            s[nb][2 * hf + e] = x;
          }
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m_r[hf], FOLD ? mx * kf0 : mx);  // kf0 > 0 on this path
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[nb][2 * hf + e];
          // a row that has seen no key yet keeps m = NEG_INF: its masked p is 0
          const float p = FOLD ? fast_exp2(fmaf(x, kf0, -m_new))
                               : (MASKED && x == NEG_INF ? 0.f : fast_exp2(x - m_new));
          // P V takes p times the key's V scale, rounded to bf16 once
          s[nb][2 * hf + e] = QUANT ? p * (SCALED ? vsc[nb * 8 + 2 * qd + e] : vs0) : p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(FULL, sum, 1);
      sum += __shfl_xor_sync(FULL, sum, 2);
      alpha[hf] = fast_exp2(m_r[hf] - m_new);
      l_r[hf] = l_r[hf] * alpha[hf] + sum;
      m_r[hf] = m_new;
    }
  };

  // The loop, per tile i, with P(i) packed and alpha(i) pending for O:
  // (1) tile i + 1 has landed (and is converted), one barrier; (2) S(i + 1)
  // goes to the tensor cores; (3) O *= alpha(i), and P.V(i) goes to the
  // tensor cores; (4) the softmax of S(i + 1) runs beside P.V(i) (then int8
  // tile i + 2 converts); (5) P(i + 1) is packed once P.V(i) is done. The
  // copy of tile i + AHEAD starts before (2) in warpgroup 1 and after (4)
  // in warpgroup 0.
  // Every iteration issues and waits the same two wgmma groups (the last
  // repeats S of its own tile), so ptxas keeps them asynchronous; no row
  // skips a tile it cannot see, its masked p is 0. Stages in use across a
  // barrier: i, i + 1, and the copies in flight.
  auto softmax_tile = [&](int j) {
    int kmin, kmax, n;
    tile_keys(j, kmin, kmax, n);
    // every row of this warp sees every key of the tile: no masks (the
    // folded maximum needs a positive scale)
    const bool full = n == BKV && kmax <= w_qmin && kmin > w_qmax - window && sm_scale > 0.f;
    const bool scaled = QUANT && j < n_hist && pdiv.page(kmin) != pdiv.page(kmax);
    auto with_mask = [&](auto masked) {
      const std::true_type yes{};
      const std::false_type no{};
      if (softcap > 0.f) {
        scaled ? softmax(masked, yes, yes, j) : softmax(masked, yes, no, j);
      } else {
        scaled ? softmax(masked, no, yes, j) : softmax(masked, no, no, j);
      }
    };
    if (full) {
      with_mask(std::false_type{});
    } else {
      with_mask(std::true_type{});
    }
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int kc = 0; kc < NB / 2; ++kc) {
      pa[kc][0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[kc][1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[kc][2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[kc][3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
    }
  };
  if (n_tiles == 0) {
    cp_async_commit();  // the Q copies
    cp_async_wait<0>();
  } else {
#pragma unroll 1
    for (int j = 0; j < L::AHEAD; ++j) issue(j);
    cp_async_wait<L::AHEAD - 1>();  // Q and tile 0
    convert(0);
    fence_async_smem();
    __syncthreads();
    if constexpr (!L::Q_SMEM) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int r = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
        ldmatrix_x4(qa[kk], smem_u32(qs) + sw128<WG_ROWS>(r, 2 * kk + (lane >> 4)));
      }
    }
    issue_s(0, s);
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile(0);
    pack_p();
  }

  PHASE_LOOP_BEGIN
  for (int i = 0; i < n_tiles; ++i) {
    const bool has_next = i + 1 < n_tiles;
    if (has_next) {
      cp_async_wait<L::AHEAD - 2>();  // this thread's copies of tile i + 1
      if (!EARLY || i == 0) convert(i + 1);
    }
    fence_async_smem();
    __syncthreads();  // the one barrier per tile: tile i + 1 visible, stage (i - 2) % NS free
    PHASE_MARK(0)
    // the warpgroups copy at opposite ends of the tile's steps, so that one's
    // softmax (bound by the exp2 unit) overlaps the other's copies and products
    if (wg == 1) issue(i + L::AHEAD);
    PHASE_MARK(1)
    fence_regs(s);
    issue_s(has_next ? i + 1 : i, s);
    PHASE_MARK(2)
    // O *= alpha(i), then O += P(i) V(i): V from the tile, transposed, 16
    // keys per step
    fence_regs(oacc);
    if (__any_sync(FULL, alpha[0] != 1.f || alpha[1] != 1.f)) {  // a row's maximum moved
#pragma unroll
      for (int db = 0; db < D / 8; ++db) {
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[db][e] *= alpha[e >> 1];
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < NB / 2; ++kc) {
      wgmma_rs<D>(oacc, pa[kc], vt_addr(i) + kc * 16 * 128, BKV);
    }
    wgmma_commit();
    PHASE_MARK(3)
    wgmma_wait<1>();  // S(i + 1) done; P.V(i) runs on
    PHASE_MARK(4)
    fence_regs(s);
    if (has_next) softmax_tile(i + 1);
    PHASE_MARK(5)
    if (wg == 0) issue(i + L::AHEAD);
    PHASE_MARK(6)
    if constexpr (EARLY) {
      if (i + 2 < n_tiles) {
        cp_async_wait<NS - 4>();  // this thread's copies of tile i + 2
        convert(i + 2);
      }
    }
    wgmma_wait<0>();  // P.V(i) done: its A registers may change
    PHASE_MARK(7)
    fence_regs(oacc);
    if (has_next) pack_p();
    PHASE_MARK(8)
  }
  PHASE_LOOP_END

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = 16 * warp + g + 8 * hf;
    const int t = wg_t0 + r / G;
    if (r >= rows || t >= Tn) continue;
    const float inv = 1.f / fmaxf(l_r[hf], 1e-30f);
    T* o = out + (((size_t)b * Tn + t) * NH + kh * G + r % G) * D + 2 * qd;
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      *reinterpret_cast<uint32_t*>(o + db * 8) = pack_bf16(oacc[db][2 * hf] * inv, oacc[db][2 * hf + 1] * inv);
    }
  }

  if (fused_write) {  // launch-uniform
    // the int8 write stages pages in the Q rows and the rings, free now
    write_chunk<D>(k_cur, v_cur, k_pages, v_pages, k_scales, v_scales, reinterpret_cast<float*>(sm + L::amax), sm,
                   L::kpos, pos_b, page_table, kv_lens, cur_lens, b, kh, Tn, KH, P, pdiv, max_pages, layer, cta_t0,
                   cta_t0 + N_WG * tpw);
  }
}

template <int D, typename KV>
cudaError_t launch_mma(const void* q, const int* pos, void* kp, void* vp, float* ks, float* vs, const void* kc,
                       const void* vc, const int* pt, const int* lens, const int* cl, void* out, int B, int Tn,
                       int NH, int KH, int P, int page_size, int max_pages, int layer, int window, float sm_scale,
                       float softcap, int fused_write, cudaStream_t s) {
  using T = __nv_bfloat16;
  const int smem = MmaSmem<D, sizeof(KV) == 1>::bytes;
  static bool configured = false;  // idempotent; a race only repeats it
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        prefill_attention_mma_kernel<D, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int tpw = WG_ROWS / (NH / KH);  // tokens per warpgroup
  constexpr int N_WG = MmaSmem<D, sizeof(KV) == 1>::N_WG;
  const dim3 grid((Tn + N_WG * tpw - 1) / (N_WG * tpw), KH, B);
  prefill_attention_mma_kernel<D, KV><<<grid, 128 * N_WG, smem, s>>>(
      static_cast<const T*>(q), pos, static_cast<KV*>(kp), static_cast<KV*>(vp), ks, vs,
      static_cast<const T*>(kc), static_cast<const T*>(vc), pt, lens, cl, static_cast<T*>(out), Tn, NH, KH,
      P, page_div(page_size), max_pages, layer, window, sm_scale, softcap, tpw, fused_write);
  return cudaGetLastError();
}

// ---- f32: CUDA cores ----------------------------------------------------

constexpr int WARPS = 8;  // warps per block
constexpr int RPW = 8;    // max query rows per warp (rows per block <= 64)

template <int D, typename KV>
__global__ void __launch_bounds__(WARPS * 32, 1) prefill_attention_f32_kernel(
    const float* __restrict__ q, const int* __restrict__ positions, KV* k_pages, KV* v_pages, float* k_scales,
    float* v_scales, const float* __restrict__ k_cur, const float* __restrict__ v_cur,
    const int* __restrict__ page_table, const int* __restrict__ kv_lens,
    const int* __restrict__ cur_lens, float* __restrict__ out, int Tn, int NH, int KH, int P,
    PageDiv pdiv, int max_pages, int layer, int TQ, int window, float sm_scale,
    float softcap, int fused_write) {
  using T = float;
  constexpr int E = D / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + TILE * D;
  __shared__ int s_qmin, s_qmax;
  __shared__ float s_amax[WARPS];  // the int8 write's per-warp amax
  const int page_size = pdiv.size;

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

  if (fused_write) {  // launch-uniform
    // the int8 write stages pages in the K and V tiles, free now
    write_chunk<D>(k_cur, v_cur, k_pages, v_pages, k_scales, v_scales, s_amax, smem_raw,
                   2 * TILE * D * (int)sizeof(T), pos_b, page_table, kv_lens, cur_lens, b, kh, Tn, KH, P, pdiv,
                   max_pages, layer, t_base, t_base + TQ);
  }
}

}  // namespace

// Build units. Without PST_UNIT the file is one unit. _build.py compiles it
// as _build.UNITS["prefill_attention"] units at once (nvcc is
// single-threaded, and the six bf16 kernels take most of its time):
// PST_UNIT = 0 holds the launcher and the f32 kernels, PST_UNIT = 1..6 one
// bf16 kernel each, behind a function of its own that the launcher calls;
// the units link into one library.
#define PST_MMA_PARAMS                                                                                       \
  const void *q, const int *pos, void *kp, void *vp, float *ks, float *vs, const void *kc, const void *vc,   \
      const int *pt, const int *lens, const int *cl, void *out, int B, int Tn, int NH, int KH, int P,        \
      int page_size, int max_pages, int layer, int window, float sm_scale, float softcap, int fused_write,   \
      cudaStream_t s
#define PST_MMA_UNIT(D, NAME, KV)                                                                            \
  cudaError_t pst_prefill_mma_##D##_##NAME(PST_MMA_PARAMS) {                                                 \
    return launch_mma<D, KV>(q, pos, kp, vp, ks, vs, kc, vc, pt, lens, cl, out, B, Tn, NH, KH, P, page_size, \
                             max_pages, layer, window, sm_scale, softcap, fused_write, s);                  \
  }

cudaError_t pst_prefill_mma_64_bf16(PST_MMA_PARAMS);
cudaError_t pst_prefill_mma_64_int8(PST_MMA_PARAMS);
cudaError_t pst_prefill_mma_128_bf16(PST_MMA_PARAMS);
cudaError_t pst_prefill_mma_128_int8(PST_MMA_PARAMS);
cudaError_t pst_prefill_mma_256_bf16(PST_MMA_PARAMS);
cudaError_t pst_prefill_mma_256_int8(PST_MMA_PARAMS);

#if !defined(PST_UNIT) || PST_UNIT == 1
PST_MMA_UNIT(64, bf16, __nv_bfloat16)
#endif
#if !defined(PST_UNIT) || PST_UNIT == 2
PST_MMA_UNIT(64, int8, int8_t)
#endif
#if !defined(PST_UNIT) || PST_UNIT == 3
PST_MMA_UNIT(128, bf16, __nv_bfloat16)
#endif
#if !defined(PST_UNIT) || PST_UNIT == 4
PST_MMA_UNIT(128, int8, int8_t)
#endif
#if !defined(PST_UNIT) || PST_UNIT == 5
PST_MMA_UNIT(256, bf16, __nv_bfloat16)
#endif
#if !defined(PST_UNIT) || PST_UNIT == 6
PST_MMA_UNIT(256, int8, int8_t)
#endif

#if !defined(PST_UNIT) || PST_UNIT == 0
// dtype (of q, the chunk K/V and out): 0 = float32, 1 = bfloat16. kv_int8 =
// 0: pools of that dtype (k_scales/v_scales ignored); 1: int8 pools with f32
// scales [L, P, KH]. window: huge = full causal; softcap <= 0 = none. bf16
// takes at most 8 query heads per KV head; TQ is the f32 kernel's query
// tokens per block (TQ * NH / KH <= 64). fused_write = 1: the same launch
// also writes the chunk's K/V into `layer` of the pools (and scales) in
// place; 0: attention only, the pools untouched.
extern "C" int prefill_attention_launch(int dtype, int kv_int8, int head_dim, const void* q,
                                        const void* positions, void* k_pages, void* v_pages, void* k_scales,
                                        void* v_scales, const void* k_cur, const void* v_cur,
                                        const void* page_table, const void* kv_lens, const void* cur_lens,
                                        void* out, int B, int Tn, int NH, int KH, int P, int page_size,
                                        int max_pages, int layer, int TQ, int window, float sm_scale,
                                        float softcap, int fused_write, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pos = static_cast<const int*>(positions);
  const int* pt = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(kv_lens);
  const int* cl = static_cast<const int*>(cur_lens);
  float* ks = static_cast<float*>(k_scales);
  float* vs = static_cast<float*>(v_scales);
  const int G = NH / KH;
  if (dtype == 1) {
    if (G > MMA_MAX_G) return (int)cudaErrorInvalidValue;
#define PST_ARGS q, pos, k_pages, v_pages, ks, vs, k_cur, v_cur, pt, lens, cl, out, B, Tn, NH, KH, P, \
                 page_size, max_pages, layer, window, sm_scale, softcap, fused_write, s
    if (head_dim == 64)
      return (int)(kv_int8 ? pst_prefill_mma_64_int8(PST_ARGS) : pst_prefill_mma_64_bf16(PST_ARGS));
    if (head_dim == 128)
      return (int)(kv_int8 ? pst_prefill_mma_128_int8(PST_ARGS) : pst_prefill_mma_128_bf16(PST_ARGS));
    if (head_dim == 256)
      return (int)(kv_int8 ? pst_prefill_mma_256_int8(PST_ARGS) : pst_prefill_mma_256_bf16(PST_ARGS));
#undef PST_ARGS
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 0 || TQ * G > WARPS * RPW) return (int)cudaErrorInvalidValue;
  const dim3 grid((Tn + TQ - 1) / TQ, KH, B);
  // K and V tiles of TILE rows in f32: 64 KB at D = 256, above the 48 KB a
  // launch gets unless the kernel's limit is raised
#define PST_LAUNCH(DIM, KV)                                                                          \
  {                                                                                                  \
    constexpr int smem = 2 * TILE * DIM * sizeof(float);                                             \
    static bool configured = false;                                                                  \
    if (smem > 48 * 1024 && !configured) {                                                           \
      const cudaError_t err = cudaFuncSetAttribute(prefill_attention_f32_kernel<DIM, KV>,            \
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem); \
      if (err != cudaSuccess) return (int)err;                                                       \
      configured = true;                                                                             \
    }                                                                                                \
    prefill_attention_f32_kernel<DIM, KV><<<grid, WARPS * 32, smem, s>>>(                            \
        static_cast<const float*>(q), pos, static_cast<KV*>(k_pages), static_cast<KV*>(v_pages), ks, vs, \
        static_cast<const float*>(k_cur), static_cast<const float*>(v_cur), pt, lens, cl,            \
        static_cast<float*>(out), Tn, NH, KH, P, page_div(page_size), max_pages, layer, TQ, window,  \
        sm_scale, softcap, fused_write);                                                             \
    return (int)cudaGetLastError();                                                                  \
  }
  if (head_dim == 64 && !kv_int8) PST_LAUNCH(64, float)
  if (head_dim == 128 && !kv_int8) PST_LAUNCH(128, float)
  if (head_dim == 256 && !kv_int8) PST_LAUNCH(256, float)
  if (head_dim == 64 && kv_int8) PST_LAUNCH(64, int8_t)
  if (head_dim == 128 && kv_int8) PST_LAUNCH(128, int8_t)
  if (head_dim == 256 && kv_int8) PST_LAUNCH(256, int8_t)
#undef PST_LAUNCH
  return (int)cudaErrorInvalidValue;
}
#endif  // PST_UNIT == 0
