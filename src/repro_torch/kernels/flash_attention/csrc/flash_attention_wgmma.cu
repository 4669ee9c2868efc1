// Flash-attention forward on Hopper's tensor cores (sm_90a), causal or
// not: the variant for a bf16 query with head dims (DQK, DV) = (64, 64),
// (128, 128), (192, 192) or (192, 128), over an f32 or a bf16 cache.
// That is every flash launch of the full-width serve paths (qwen2-72b,
// qwen3-moe and qwen2-vl-7b at 128, nemotron-4-340b at 192,
// seamless-m4t-large-v2 at 64: its non-causal encoder and
// cross-attention, and its causal decoder self-attention; and
// deepseek-v3's MLA one-shot prefill at (192, 128)).
//
// Replaces, like flash_attention.cu, the Pallas TPU kernel
// `flash_attention_bhsd` / `_flash_kernel` in
// src/repro/kernels/flash_attention/kernel.py.  flash_attention.cu keeps
// the f32-query kernel (held to 1e-4, which bf16 products cannot meet)
// and the reduced head dim 16; its C entry `flash_attention_fwd` calls
// `flash_wgmma_launch` below for q bf16 at the head dims above, by type
// and head dims, never as a fallback.
//
// Function.  q (B, Sq, H, DQK) bf16; k (B, Skv, Hkv, DQK) and v (B, Skv,
// Hkv, DV) f32 or bf16, strided views (a layer of the stacked cache
// arena; MLA's v is the tail of each head's 256-wide row of its
// up-projection, 256 bytes past the allocation's base); o (B, Sq, H, DV)
// bf16.  The kernel is a template on (DQK, DV), both multiples of 64;
// the library instantiates (64, 64), (128, 128), (192, 192) and (192,
// 128).  Query head h reads KV head h / (H / Hkv).  Query row
// i sits at absolute position q_offset + i and sees keys at positions <=
// that (causal) and < Skv; with causal = 0 every row sees all Skv keys
// (a cross-attention decode step is Sq = 1).  The Pallas kernel's
// arithmetic for a bf16 cache:
// S = Q.K^T as bf16 products with f32 accumulation, scaled and
// soft-maxed online in f32, then P rounded to bf16 and O += P.V again in
// f32; a row that sees no key writes 0.  An f32 cache is rounded to bf16
// as it enters shared memory (K and V each once per block).
//
// What bounds it.  At the serve path's late chunk (Sq 256 at offset
// 3840, 64/8 heads) the work is 4 * 64 * 128 * 1,015,936 = 3.3e10 FLOPs,
// 0.034 ms at the bf16 tensor-core peak, against 42 MB of q, o and f32
// K/V prefix, 0.013 ms at the memory rate (H100 SXM data sheet at its
// 700 W limit: 989 TFLOP/s, 3.35 TB/s): the tensor cores set the least
// time.  At nemotron-4-340b's late chunk (96/8 heads, D 192) it is
// 4 * 96 * 192 * 1,015,936 = 7.5e10 FLOPs, 0.076 ms.  MLA's one-shot
// (1000 tokens, 128 heads each with its own K/V) is 2 * 128 * (192 + 128)
// * 500,500 = 4.1e10 FLOPs, 0.041 ms, against 164 MB of q, o and one read
// of K/V, 0.049 ms: there the bytes set the least time, if each head's
// K/V is read from HBM once.  PERF.md has the measured times against
// both.
//
// Design.
// - Block: consumer warpgroups, each owning 64 query rows of one head
//   (`Plan::CONSUMERS`: 3 at D 64 and at (192, 192) over a bf16 cache, 2
//   elsewhere), and one producer warpgroup.  A block holds 64 rows of a
//   head a consumer; at (192, 192) over a bf16 cache, where a KV group's
//   query heads divide among the consumers (`Plan::PACK_HEADS`), the
//   consumers take one head each of one group at the same 64 rows, so a
//   K/V tile serves three heads.  `setmaxnreg` moves registers from the
//   producer to the consumers (`Plan::PRODUCER_REGS`): the producer keeps
//   24 over a bf16 cache (one thread issues TMA), 56 over an f32 cache
//   (it converts); the consumers share the rest of the SM's 64K (240 or
//   224 a thread with 2 consumers, 160 or 152 with 3).  ptxas reports the
//   launch's registers (168 or 128 a thread) whatever the split, and
//   allocates each branch to its own count unless code there may trap
//   (below).  Grid (B * H / heads a block, Sq / rows a block):
//   consecutive blocks are the heads of one KV group, which read the
//   same K/V through L2; query tiles run last-first so the longest
//   causal rows start earliest.  At (192, 128) with a KV head a query
//   head (MLA), a wave of blocks in that order is ~132 heads at one query
//   tile, whose K/V (640 KB a head at 1000 tokens, 82 MB in all) outgrow
//   the 50 MB L2, so each head's K/V prefix would come from HBM once a
//   tile; there consecutive blocks are one head's query tiles instead,
//   last-first, and its K/V is read about once.
// - Products: `wgmma.mma_async` m64nNk16 bf16 -> f32, accumulators in
//   registers.  Q is either in registers for the block's life, already
//   in wgmma's A-fragment layout (DQK / 4 registers a thread), so S =
//   Q.K^T (m64n64, DQK / 16 k-steps) reads only K from shared memory; or,
//   where registers would not hold it beside O (`Plan::Q_SMEM`: (192,
//   128), and (192, 192) over a bf16 cache), each consumer writes its 64
//   Q rows once into shared memory in a K tile's swizzled layout and S =
//   Q.K^T reads both from there (an SS wgmma).  P is converted to bf16
//   in registers, and its S-accumulator fragment is exactly the A
//   fragment of O += P.V (m64nDV, 4 k-steps over 64 keys): P never goes
//   through shared memory.  K is B in K-major form; V [keys][d] is B in
//   MN-major form through the transpose bit that 16-bit types allow.
// - Schedule over a bf16 cache (FA3's intra-warpgroup overlap,
//   `Plan::OVERLAP`): a consumer issues S(j) = Q.K(j)^T and then O +=
//   P(j-1).V(j-1) as two wgmma groups, waits for the first, and computes
//   tile j's online softmax (exp2 on the multi-function unit) while the
//   tensor cores run the second; then it waits for O, hands tile j-1's
//   stage back, rescales O and converts P(j).  At D 64 a score's exp2
//   costs about what its products do, so in series the tensor cores sat
//   idle half of each tile.  Over an f32 cache the producer's conversion
//   sets the pace, and a consumer runs each tile in series (S, softmax,
//   P.V), which hands each stage back a tile sooner; so does each of the
//   three at (192, 192), whose 160 registers do not hold S, P and O at
//   once (three warps a scheduler hide the softmax instead).  Scores are
//   scaled inside the exp2's argument (one FFMA), and exp2 is
//   `ex2.approx.ftz`.
// - Short queries (`Plan::SPLIT_KEYS`, D 64, Sq <= 64: a cross-attention
//   decode step or prompt): the block's rows fit one warpgroup, so every
//   consumer owns the same 64 rows and they take the key tiles in turn
//   (consumer c tiles c, c + 3, ...); at the end the others write their
//   (m, l, O) to shared memory and the first folds them in (a consumer
//   that saw no key has m = -inf and weighs 0) and writes the output.
//   The stages' empty barriers then count one consumer's arrivals.
// - Shared layout: a K (V) tile is 64 keys x DQK (DV) d in bf16 as
//   DQK / 64 (DV / 64) 64-column parts of 64 rows x 128 bytes, 128-byte
//   swizzled (TMA's SWIZZLE_128B; 1024-byte aligned atoms of 8 rows).  K
//   descriptors: K-major, SBO 1024 (8 rows), a k-step moves 32 bytes
//   inside the atom or to the next part.  V descriptors: MN-major, LBO
//   8192 (the next 64-column part), SBO 1024 (8 keys), a k-step moves 16
//   keys.
// - Loads: a ring of K/V stages in shared memory with full/empty
//   mbarriers, so the producer fills the next tiles while the consumers
//   compute.  A bf16 cache: one producer thread issues TMA loads straight
//   into the swizzled ring ((DQK + DV) / 64 boxes of 64 x 64 a stage).
//   An f32 cache: TMA cannot convert, so one thread TMA-loads f32 K and
//   V tiles (unswizzled) into staging half-slots, K and V each a slot of
//   its own, as many halves ahead as there are slots, and the whole
//   producer warpgroup converts each half to bf16 into the swizzled ring,
//   one float4 a thread a step so that reads and 8-byte writes are free
//   of bank conflicts: one half's load overlaps the other's conversion.
//   Staging through TMA keeps 64-128 KB of loads in flight an SM with
//   few registers a producer thread; loading through the producer's
//   registers instead (32 float4s a thread, 64 KB in flight) was measured
//   slower at D 128.  What bounds the f32 path is the staging's
//   shared-memory traffic (f32 written and read again, on top of the
//   bf16 writes and the wgmma reads).  `Plan` sizes the ring, the
//   half-slots, Q and the merge area within the 227 KB a block has (the
//   arithmetic is there).  Tensor maps are encoded on the host at every
//   launch (the serve path's arena views move each step), with
//   `cuTensorMapEncodeTiled` looked up in the libcuda the CUDA runtime
//   has already loaded.
// - Masking: the tensor maps end at the launch's last visible key
//   (min(Skv, q_offset + Sq) when causal), so TMA zero-fills every key
//   past it: garbage in unwritten cache pages never meets a masked
//   probability as 0 * NaN.  The consumers mask keys >= Skv and keys > a
//   row's position only on the tiles that hold any (the last one or
//   two), so the rest run unmasked.  KV tiles past the block's last
//   query are never loaded (the causal skip), and a consumer hands back
//   unread the tiles past its own last row's keys (the block's last
//   tile, for the first consumer).
// - A barrier wait that spins for ~2^24 polls stores to address 0, so a
//   protocol fault ends the launch with an error instead of hanging the
//   card.  Not a `trap`: with one in the consumers' waits ptxas (CUDA
//   12.9) holds their code to the launch's 168 registers whatever
//   `setmaxnreg` gives them, and at D 128 and 192 spills and serializes
//   every wgmma (C7512).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace fa_wgmma {

constexpr int BM = 64;                          // query rows a consumer
constexpr int BK = 64;                          // keys a tile
constexpr int HALF_BYTES = BK * 64 * 2;         // 64 keys x 64 d bf16: 8 KB
constexpr int SMEM_BUDGET = 232448;             // a block's, on an H100
constexpr int REGS_PER_SM = 65536;
constexpr float LOG2E = 1.4426950408889634f;

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The plan of head dims (DQK, DV) over a bf16 or f32 cache: shared
// memory, registers, and which consumer features the instantiation has.
// Shared memory (KB of the 227 a block has; 1.1 fixed):
//   (64, 64)    bf16: 8 stages x 16 + merge 2 x 18 = 164
//               f32:  4 stages x 16 + 4 half-slots x 16 + merge 36 = 164
//   (128, 128)  bf16: 4 stages x 32 = 128
//               f32:  2 stages x 32 + 4 half-slots x 32 = 192
//   (192, 192)  bf16: 3 stages x 48 + Q 3 x 24 = 216
//               f32:  2 stages x 48 + 2 half-slots x 48 = 192 (Q in
//                     registers: with Q here, 240)
//   (192, 128)  bf16: 4 stages x 40 + Q 48 = 208
//               f32:  2 stages x 40 + 2 half-slots x 48 + Q 48 = 224
template <int DQK, int DV, bool F32KV>
struct Plan {
  static_assert(DQK % 64 == 0 && DV % 64 == 0, "head dims of 64-col parts");
  // Consumer warpgroups of 64 query rows each: three at D 64, where a
  // score's exp2 costs about what its products do and a third warp on
  // each scheduler hides more of the softmax's latency (the encoder 13%
  // faster on an H100 than with two), and at (192, 192) over a bf16
  // cache, whose blocks take a head each (PACK_HEADS); two elsewhere.
  static constexpr int CONSUMERS =
      DQK == 64 || (DQK == 192 && DV == 192 && !F32KV) ? 3 : 2;
  // Where a KV group's query heads divide among the consumers, a block
  // takes 64 rows of as many heads of one group, a consumer a head: each
  // K/V tile it loads serves 192 rows, and nemotron-4-340b's 256-row
  // chunks (96 heads) make 128 blocks, one wave, where 128-row blocks
  // of one head made 192, two.
  static constexpr bool PACK_HEADS = DQK == 192 && DV == 192 && !F32KV;
  static constexpr int BQ = BM * CONSUMERS;           // query rows a block
  static constexpr int NTHREADS = 128 * (CONSUMERS + 1);
  static constexpr int K_TILE = BK * DQK * 2;         // bf16 K tile
  static constexpr int V_TILE = BK * DV * 2;          // bf16 V tile
  static constexpr int STAGE_BYTES = K_TILE + V_TILE;
  static constexpr int F32_K = BK * DQK * 4;          // f32 K tile
  static constexpr int F32_V = BK * DV * 4;           // f32 V tile
  static constexpr int HALF_SLOT = cmax(F32_K, F32_V);
  static constexpr int FIXED = 1024 /* alignment slack */ + 128 /* bars */;
  // MLA's materialized prefill, (192, 128): one head's query tiles back
  // to back when every query head has its own K/V.
  static constexpr bool MLA = DQK == 192 && DV == 128;
  // Q in shared memory (an SS wgmma) where registers would not hold it
  // beside O: (192, 128), and (192, 192) over a bf16 cache.  Over an f32
  // cache (192, 192) needs the room for its staging, and Q stays in
  // registers.
  static constexpr bool Q_SMEM = DQK == 192 && (MLA || !F32KV);
  static constexpr int Q_BYTES = Q_SMEM ? BQ * DQK * 2 : 0;  // bf16 Q tile
  // Short queries split the keys between the consumers (D 64: the
  // encoder-decoder's cross-attention); the merge area holds every
  // consumer's O, m and l but the first's, a float a thread each.
  static constexpr bool SPLIT_KEYS = DQK == 64;
  static constexpr int MERGE_FLOATS = DV / 2 + 4;
  static constexpr int MERGE_BYTES =
      SPLIT_KEYS ? (CONSUMERS - 1) * 128 * MERGE_FLOATS * 4 : 0;
  static constexpr int AVAIL = SMEM_BUDGET - FIXED - Q_BYTES - MERGE_BYTES;
  // bf16 K/V stages: as many as fit, up to 8 at D 64 (its loads are
  // what a cross-attention decode step waits on) and 4 elsewhere; 2 (4
  // at D 64) beside an f32 cache's staging
  static constexpr int RING = F32KV ? (DQK == 64 ? 4 : 2)
      : cmin(DQK == 64 ? 8 : 4, AVAIL / STAGE_BYTES);
  // f32 K and V half-slots: as many as fit, up to 4
  static constexpr int STAGING = !F32KV ? 0
      : cmin(4, (AVAIL - RING * STAGE_BYTES) / HALF_SLOT);
  static constexpr int FULL_COUNT = F32KV ? 128 : 1;  // arrivals a fill
  static constexpr int SMEM = FIXED + RING * STAGE_BYTES
      + STAGING * HALF_SLOT + Q_BYTES + MERGE_BYTES;
  // Registers a thread after `setmaxnreg`: the producer keeps what it
  // needs (one TMA thread; an f32 conversion, four float4s in flight a
  // thread), the consumers take the rest of the SM's 64K.
  static constexpr int PRODUCER_REGS = F32KV ? 56 : 24;
  static constexpr int CONSUMER_REGS =
      (REGS_PER_SM / 128 - PRODUCER_REGS) / CONSUMERS / 8 * 8;
  // A tile's softmax overlapped with the last tile's P . V (S, P and O
  // in registers at once) over a bf16 cache; over an f32 cache, where
  // the producer's conversion sets the pace, in series, so that each
  // stage is handed back a tile sooner (at D 128 the overlap was 10%
  // slower there).
  // (At (192, 192) three consumers' 160 registers do not hold S, P and
  // O at once: in series there too.)
  static constexpr bool OVERLAP = !F32KV && !PACK_HEADS;
  static_assert(SMEM <= SMEM_BUDGET, "shared-memory plan over budget");
  static_assert(RING >= 2 && (!F32KV || STAGING >= 2), "too few stages");
  static_assert(2 * RING + STAGING <= 16, "barrier space");
  static_assert(128 * (PRODUCER_REGS + CONSUMERS * CONSUMER_REGS)
                <= REGS_PER_SM, "register split over the SM's file");
};

// ---------------------------------------------------------------- PTX --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(n) : "memory");
}

// End the launch with an error: a store to address 0 (not `trap`: the
// design note says why).
__device__ __forceinline__ void fault() {
  asm volatile("st.global.u32 [%0], %1;\n" :: "l"(0ull), "r"(0u) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (spins > (1u << 24)) fault();
  }
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void producer_bar_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// The 128 threads of consumer warpgroup `wg` (named barriers 2 and 3).
__device__ __forceinline__ void consumer_bar_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.  Offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
      | (static_cast<uint64_t>(lbo >> 4) << 16)
      | (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (the registers are in flight until the wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define F4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define F16(a, i) F4(a, i), F4(a, i + 4), F4(a, i + 8), F4(a, i + 12)

// d[64 x 64] (+)= A[64 x 16] (registers) . B[16 x 64] (K-major in smem).
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : F16(d, 0), F16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], both K-major in smem.
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32],
                                                uint64_t adesc,
                                                uint64_t bdesc,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F16(d, 0), F16(d, 16)
      : "l"(adesc), "l"(bdesc), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] (registers) . B[16 x 64] (MN-major in smem).
__device__ __forceinline__ void wgmma_m64n64_tb(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F16(d, 0), F16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d[64 x 128] += A[64 x 16] (registers) . B[16 x 128] (MN-major in smem).
__device__ __forceinline__ void wgmma_m64n128_tb(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F16(d, 0), F16(d, 16), F16(d, 32), F16(d, 48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d[64 x 192] += A[64 x 16] (registers) . B[16 x 192] (MN-major in smem).
__device__ __forceinline__ void wgmma_m64n192_tb(float (&d)[96],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : F16(d, 0), F16(d, 16), F16(d, 32), F16(d, 48), F16(d, 64),
        F16(d, 80)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// O += P . V at V's width: m64n64, m64n128 or m64n192.
__device__ __forceinline__ void wgmma_pv(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  wgmma_m64n64_tb(d, a, desc);
}
__device__ __forceinline__ void wgmma_pv(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  wgmma_m64n128_tb(d, a, desc);
}
__device__ __forceinline__ void wgmma_pv(float (&d)[96],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  wgmma_m64n192_tb(d, a, desc);
}

#undef F16
#undef F4

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the multi-function unit; 2^-inf = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 1/x on the multi-function unit, where IEEE division would call a
// slow-path subroutine from the consumers' code.
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------ kernel --

struct Args {
  const __nv_bfloat16* q;
  __nv_bfloat16* o;
  int Sq, Skv, H, group, causal, q_offset;
  int heads_per_block;         // 1, or the consumers' count (PACK_HEADS)
  int64_t q_sb, q_ss, q_sh, o_sb, o_ss, o_sh;
  float scale_log2;            // softmax scale * log2(e): exp2 domain
};

// An f32 tile of 64 rows x D as TMA staged it (row-major, unswizzled)
// into D / 64 bf16 parts, 128-byte swizzled.  A warp converts 128
// contiguous values a step: 32 float4 reads of 512 contiguous bytes, 32
// 8-byte writes to swizzled 128-byte lines.
template <int D>
__device__ __forceinline__ void convert_tile(const uint8_t* src,
                                             uint8_t* dst, int tid) {
#pragma unroll 4
  for (int i = 0; i < BK * D / 4 / 128; ++i) {
    const int it = tid + 128 * i;
    const int row = it / (D / 4), f = it % (D / 4);
    const float4 x = *reinterpret_cast<const float4*>(src + row * D * 4
                                                      + f * 16);
    const int part = f / 16, chunk = (f % 16) / 2, sub = f % 2;
    uint8_t* out = dst + part * HALF_BYTES + row * 128
                   + ((chunk ^ (row & 7)) << 4) + sub * 8;
    *reinterpret_cast<uint2*>(out) =
        make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
  }
}

// Producer: fill ring stage j % RING with K/V tile j.
template <int DQK, int DV, bool F32KV>
__device__ __forceinline__ void produce(const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v,
                                        uint8_t* ring, uint8_t* staging,
                                        uint64_t* full, uint64_t* empty,
                                        uint64_t* staged, int n_tiles, int hk,
                                        int b) {
  using P = Plan<DQK, DV, F32KV>;
  const int tid = threadIdx.x % 128;
  if constexpr (!F32KV) {
    if (tid == 0) {
      for (int j = 0; j < n_tiles; ++j) {
        const int r = j % P::RING;
        mbar_wait(&empty[r], ((j / P::RING) & 1) ^ 1);
        mbar_expect_tx(&full[r], P::STAGE_BYTES);
        uint8_t* kdst = ring + r * P::STAGE_BYTES;
        uint8_t* vdst = kdst + P::K_TILE;
        // K's and V's parts interleaved: at D 128, all of K's parts before
        // V's ran 8-10% slower over a bf16 cache on an H100.
        for (int part = 0; part < (DQK > DV ? DQK : DV) / 64; ++part) {
          if (part < DQK / 64) {
            tma_load_4d(kdst + part * HALF_BYTES, tm_k, &full[r], 64 * part,
                        hk, j * BK, b);
          }
          if (part < DV / 64) {
            tma_load_4d(vdst + part * HALF_BYTES, tm_v, &full[r], 64 * part,
                        hk, j * BK, b);
          }
        }
      }
    }
  } else {
    // Half u of the f32 stream is K (u even) or V (u odd) of tile u / 2,
    // staged in half-slot u % NS, so that one half's load overlaps the
    // conversion of the one before.
    constexpr int NS = P::STAGING;
    const int n_halves = 2 * n_tiles;
    auto stage = [&](int u) {
      uint8_t* dst = staging + (u % NS) * P::HALF_SLOT;
      uint64_t* bar = &staged[u % NS];
      mbar_expect_tx(bar, u % 2 ? P::F32_V : P::F32_K);
      tma_load_4d(dst, u % 2 ? tm_v : tm_k, bar, 0, hk, u / 2 * BK, b);
    };
    if (tid == 0) {
      for (int u = 0; u < NS && u < n_halves; ++u) stage(u);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int r = j % P::RING;
      uint8_t* dst = ring + r * P::STAGE_BYTES;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int u = 2 * j + half;
        mbar_wait(&staged[u % NS], (u / NS) & 1);
        const uint8_t* src = staging + (u % NS) * P::HALF_SLOT;
        if (half == 0) {
          mbar_wait(&empty[r], ((j / P::RING) & 1) ^ 1);
          convert_tile<DQK>(src, dst, tid);
        } else {
          convert_tile<DV>(src, dst + P::K_TILE, tid);
          fence_proxy_async();   // the generic writes, before wgmma reads
          mbar_arrive(&full[r]);
        }
        producer_bar_sync();     // every thread is done with the half-slot
        if (tid == 0 && u + NS < n_halves) stage(u + NS);
      }
    }
  }
}

// S = Q . K^T for the K tile at `kaddr`, Q from registers (`qf`) or
// from shared memory at `qaddr`.  Element i of s: row (i >> 1) & 1 of
// the thread's two, key 8 (i >> 2) + 2t + (i & 1) of the tile.
template <int DQK, bool Q_SMEM, int NQ>
__device__ __forceinline__ void issue_s(float (&s)[BK / 2],
                                        const uint32_t (&qf)[NQ][4],
                                        uint32_t qaddr, uint32_t kaddr) {
#pragma unroll
  for (int kk = 0; kk < DQK / 16; ++kk) {
    const uint32_t step = (kk / 4) * HALF_BYTES + (kk % 4) * 32;
    if constexpr (Q_SMEM) {
      wgmma_m64n64_ss(s, sw128_desc(qaddr + step, 16, 1024),
                      sw128_desc(kaddr + step, 16, 1024), kk > 0);
    } else {
      wgmma_m64n64(s, qf[kk], sw128_desc(kaddr + step, 16, 1024), kk > 0);
    }
  }
}

// O += P . V for the V tile at `vaddr`.
template <int DV>
__device__ __forceinline__ void issue_pv(float (&acc)[DV / 2],
                                         const uint32_t (&pf)[BK / 16][4],
                                         uint32_t vaddr) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    wgmma_pv(acc, pf[kk], sw128_desc(vaddr + kk * 16 * 128, HALF_BYTES,
                                     1024));
  }
}

// Online softmax of one S tile in the exp2 domain: s becomes P in f32
// (keys >= a row's limit masked where `masked`), alpha the factor that
// brings O and l to the new running max m, and l takes this tile's row
// sums (this thread's share).  A row's 64 scores sit on the 4 threads of
// a quad.
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2],
                                               float scale_log2, bool masked,
                                               int k0, const int (&lim)[2],
                                               int t) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (key >= lim[(i >> 1) & 1]) s[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
  float mu[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
    const float m_new = fmaxf(m[e], mx[e] * scale_log2);
    mu[e] = (m_new == -INFINITY) ? 0.f : m_new;
    alpha[e] = exp2_approx(m[e] - mu[e]);   // 0 while the row saw nothing
    m[e] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    // the scale folded into one FFMA; masked: exp2(-inf) = 0
    s[i] = exp2_approx(fmaf(s[i], scale_log2, -mu[(i >> 1) & 1]));
    rs[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) l[e] = l[e] * alpha[e] + rs[e];
}

// P in bf16: the S fragment of keys 16 kk .. + 15 is the A fragment.
__device__ __forceinline__ void pack_p(uint32_t (&pf)[BK / 16][4],
                                       const float (&s)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pf[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
    }
  }
}

// The threads of all N consumers (named barrier 4).
template <int N>
__device__ __forceinline__ void consumers_bar_sync() {
  asm volatile("bar.sync 4, %0;\n" :: "n"(128 * N) : "memory");
}

// Consumer warpgroup `wg`: query rows q0 + 64 wg .. + 63 of head h over
// every tile the block loads; with the keys split (short queries), rows
// q0 .. + 63 over tiles wg, wg + CONSUMERS, ...
template <int DQK, int DV, bool F32KV>
__device__ __forceinline__ void consume(const Args& a, uint8_t* ring,
                                        uint8_t* qsmem, float* merge,
                                        uint64_t* full, uint64_t* empty,
                                        int n_tiles, int wg, int b, int h,
                                        int q0) {
  using P = Plan<DQK, DV, F32KV>;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const bool split = P::SPLIT_KEYS && a.Sq <= BM;
  const int first = split ? wg : 0, stride = split ? P::CONSUMERS : 1;
  const int row0 = split || a.heads_per_block > 1 ? q0 : q0 + wg * BM;
  // This thread's two rows in every m64 fragment.
  const int rows[2] = {row0 + warp * 16 + g, row0 + warp * 16 + g + 8};
  const __nv_bfloat16* qb = a.q + b * a.q_sb + h * a.q_sh;

  // Q in the A-fragment layout: k-step kk holds columns 16 kk .. + 15;
  // register e holds row rows[e & 1], columns 16 kk + 8 (e >> 1) + 2t,
  // +1.  Or Q's 64 rows in shared memory, laid out as a K tile (DQK / 64
  // parts of 64 rows x 128 bytes, 128-byte swizzled), each thread
  // issuing all its 16-byte loads before its first store.  Rows past Sq
  // are zero.
  uint32_t qf[P::Q_SMEM ? 1 : DQK / 16][4];
  uint32_t qaddr = 0;
  if constexpr (P::Q_SMEM) {
    constexpr int PIECES = BM * DQK / 8 / 128;   // 16-byte pieces a thread
    uint8_t* qs = qsmem + wg * (BM * DQK * 2);
    qaddr = smem_u32(qs);
    uint4 x[PIECES];
#pragma unroll
    for (int n = 0; n < PIECES; ++n) {
      const int i = tid + 128 * n, r = i / (DQK / 8), c = i % (DQK / 8);
      const int row = row0 + r;
      x[n] = row < a.Sq ? *reinterpret_cast<const uint4*>(
                              qb + static_cast<int64_t>(row) * a.q_ss + 8 * c)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int n = 0; n < PIECES; ++n) {
      const int i = tid + 128 * n, r = i / (DQK / 8), c = i % (DQK / 8);
      *reinterpret_cast<uint4*>(qs + (c / 8) * HALF_BYTES + r * 128
                                + (((c % 8) ^ (r & 7)) << 4)) = x[n];
    }
    fence_proxy_async();       // the generic writes, before wgmma reads
    consumer_bar_sync(wg);
  } else {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = rows[e] < a.Sq;
      const __nv_bfloat16* qrow =
          qb + static_cast<int64_t>(ok ? rows[e] : 0) * a.q_ss;
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          qf[kk][e + 2 * hi] =
              ok ? *reinterpret_cast<const uint32_t*>(qrow + 16 * kk + 8 * hi
                                                      + 2 * t)
                 : 0u;
        }
      }
    }
  }

  // Keys a row sees: < lim[e]; every row of this warpgroup sees keys
  // < mask_from, so tiles below it need no mask.  Causal, the block's
  // last tiles may hold no key this warpgroup's rows see: it reads the
  // first own_tiles and hands the rest back unread.
  int lim[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    lim[e] = a.causal ? min(a.Skv, a.q_offset + rows[e] + 1) : a.Skv;
  }
  const int mask_from = a.causal ? min(a.Skv, a.q_offset + row0 + 1) : a.Skv;
  int own_tiles = n_tiles;
  if (a.causal) {
    const int seen = min(a.Skv, a.q_offset + min(row0 + BM, a.Sq));
    own_tiles = min(n_tiles, (max(seen, 0) + BK - 1) / BK);
  }
  if (row0 >= a.Sq) own_tiles = 0;     // every row past Sq: nothing to read

  float acc[DV / 2];           // O: 64 rows x DV, m64nDV layout
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};     // this thread's share of the row sums
  float s[BK / 2];             // S, then P in f32; a first k-step ignores it
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  uint32_t pf[BK / 16][4];     // P in bf16
  float alpha[2];

  if constexpr (P::OVERLAP) {
    // Tile j: S, softmax, P; its P . V is issued with the next tile's S.
    int j = first;
    if (j < own_tiles) {
      mbar_wait(&full[j % P::RING], (j / P::RING) & 1);
      fence_regs(s);
      wg_fence();
      issue_s<DQK, P::Q_SMEM>(
          s, qf, qaddr, smem_u32(ring + (j % P::RING) * P::STAGE_BYTES));
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      online_softmax(s, m, l, alpha, a.scale_log2, j * BK + BK > mask_from,
                     j * BK, lim, t);
      pack_p(pf, s);
    }
    for (int jn = j + stride; jn < own_tiles; jn += stride) {
      mbar_wait(&full[jn % P::RING], (jn / P::RING) & 1);
      fence_regs(s);
      fence_regs(acc);
      wg_fence();
      issue_s<DQK, P::Q_SMEM>(
          s, qf, qaddr, smem_u32(ring + (jn % P::RING) * P::STAGE_BYTES));
      wg_commit();
      issue_pv<DV>(acc, pf, smem_u32(ring + (j % P::RING) * P::STAGE_BYTES)
                                + P::K_TILE);
      wg_commit();
      wg_wait<1>();            // S(jn) is in; P(j) . V(j) runs on
      fence_regs(s);
      online_softmax(s, m, l, alpha, a.scale_log2,
                     jn * BK + BK > mask_from, jn * BK, lim, t);
      wg_wait<0>();
      fence_regs(acc);
      fence_regs(s);
      mbar_arrive(&empty[j % P::RING]);
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      pack_p(pf, s);
      j = jn;
    }
    if (j < own_tiles) {
      fence_regs(acc);
      wg_fence();
      issue_pv<DV>(acc, pf, smem_u32(ring + (j % P::RING) * P::STAGE_BYTES)
                                + P::K_TILE);
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[j % P::RING]);
    }
  } else {
    // In series: S, softmax, P . V, each tile's products waited for.
    for (int j = first; j < own_tiles; j += stride) {
      mbar_wait(&full[j % P::RING], (j / P::RING) & 1);
      const uint32_t kaddr = smem_u32(ring + (j % P::RING) * P::STAGE_BYTES);
      fence_regs(s);
      wg_fence();
      issue_s<DQK, P::Q_SMEM>(s, qf, qaddr, kaddr);
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      online_softmax(s, m, l, alpha, a.scale_log2, j * BK + BK > mask_from,
                     j * BK, lim, t);
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      pack_p(pf, s);
      fence_regs(acc);
      wg_fence();
      issue_pv<DV>(acc, pf, kaddr + P::K_TILE);
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[j % P::RING]);
    }
  }
  for (int jj = own_tiles; jj < n_tiles; ++jj) {   // never with the split
    mbar_wait(&full[jj % P::RING], (jj / P::RING) & 1);
    mbar_arrive(&empty[jj % P::RING]);
  }

  // With the keys split, every consumer but the first hands its (O, m,
  // l) to the first through shared memory (a float a thread at
  // merge[i * 128 + tid]: all hold the same rows and columns in the same
  // registers), and the first folds them in one by one, each weighed by
  // the running maximum.  A consumer that saw no key (m = -inf) weighs 0,
  // never NaN.
  if constexpr (P::SPLIT_KEYS) {
    if (split) {
      constexpr int MF = P::MERGE_FLOATS * 128;
      if (wg > 0) {
        float* mine = merge + (wg - 1) * MF;
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) mine[i * 128 + tid] = acc[i];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mine[(DV / 2 + e) * 128 + tid] = m[e];
          mine[(DV / 2 + 2 + e) * 128 + tid] = l[e];
        }
      }
      consumers_bar_sync<P::CONSUMERS>();
      if (wg > 0) return;
#pragma unroll
      for (int c = 1; c < P::CONSUMERS; ++c) {
        const float* other = merge + (c - 1) * MF;
        float w[2], wo[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float mo = other[(DV / 2 + e) * 128 + tid];
          const float mt = fmaxf(m[e], mo);
          w[e] = m[e] == -INFINITY ? 0.f : exp2_approx(m[e] - mt);
          wo[e] = mo == -INFINITY ? 0.f : exp2_approx(mo - mt);
          l[e] = l[e] * w[e] + other[(DV / 2 + 2 + e) * 128 + tid] * wo[e];
          m[e] = mt;
        }
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) {
          acc[i] = acc[i] * w[(i >> 1) & 1]
                   + other[i * 128 + tid] * wo[(i >> 1) & 1];
        }
      }
    }
  }

  // Epilogue: O / l in bf16.  Element i of acc: row rows[(i >> 1) & 1],
  // column 8 (i >> 2) + 2t + (i & 1).
  float inv[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    inv[e] = rcp_approx(l[e] == 0.f ? 1.f : l[e]);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (rows[e] >= a.Sq) continue;
    __nv_bfloat16* orow = a.o + b * a.o_sb
        + static_cast<int64_t>(rows[e]) * a.o_ss + h * a.o_sh;
#pragma unroll
    for (int c = 0; c < DV / 8; ++c) {
      const int i = 4 * c + 2 * e;
      *reinterpret_cast<uint32_t*>(orow + 8 * c + 2 * t) =
          pack_bf16(acc[i] * inv[e], acc[i + 1] * inv[e]);
    }
  }
}

template <int DQK, int DV, bool F32KV>
__global__ void __launch_bounds__((Plan<DQK, DV, F32KV>::NTHREADS), 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ Args a) {
  using P = Plan<DQK, DV, F32KV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* staging = ring + P::RING * P::STAGE_BYTES;
  uint8_t* qsmem = staging + P::STAGING * P::HALF_SLOT;
  float* merge = reinterpret_cast<float*>(qsmem + P::Q_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(qsmem + P::Q_BYTES
                                               + P::MERGE_BYTES);
  uint64_t* empty = full + P::RING;
  uint64_t* staged = empty + P::RING;

  // Block (batch x head, query tile).  In launch order blocks walk the
  // heads of one query tile (a KV group's heads share K/V through L2).
  // At MLA's (192, 128) with a KV head a query head they walk one head's
  // query tiles instead, so its K/V is read from HBM about once, not once
  // a tile.  Tiles run last-first either way.
  unsigned bh = blockIdx.x, tile = blockIdx.y;
  if constexpr (P::MLA) {
    if (a.group == 1) {
      const unsigned linear = blockIdx.y * gridDim.x + blockIdx.x;
      bh = linear / gridDim.y;
      tile = linear % gridDim.y;
    }
  }
  // With heads packed, the block's heads are h .. h + CONSUMERS - 1 at
  // the same 64 rows.
  const int hpb = a.heads_per_block;
  const int rows = hpb > 1 ? BM : P::BQ;       // a head's rows a block
  const int b = bh / (a.H / hpb);
  const int h = bh % (a.H / hpb) * hpb;
  const int q0 = (gridDim.y - 1 - tile) * rows;
  int kv_end = a.Skv;                  // keys the block's last row sees
  if (a.causal) {
    kv_end = max(0, min(a.Skv, a.q_offset + min(q0 + rows, a.Sq)));
  }
  const int n_tiles = (kv_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    // with the keys split, one consumer reads each stage
    const int readers = P::SPLIT_KEYS && a.Sq <= BM ? 1 : P::CONSUMERS;
    for (int s = 0; s < P::RING; ++s) {
      mbar_init(&full[s], P::FULL_COUNT);
      mbar_init(&empty[s], readers * 128);
    }
    for (int s = 0; s < P::STAGING; ++s) mbar_init(&staged[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The warpgroup, warp-uniform as the compiler sees it, so that each
  // branch below is allocated to its own `setmaxnreg` count.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == P::CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(P::PRODUCER_REGS));
    produce<DQK, DV, F32KV>(&tm_k, &tm_v, ring, staging, full, empty,
                            staged, n_tiles, h / a.group, b);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(P::CONSUMER_REGS));
    consume<DQK, DV, F32KV>(a, ring, qsmem, merge, full, empty, n_tiles,
                            wg, b, hpb > 1 ? h + wg : h, q0);
  }
}

// ------------------------------------------------------------- host --

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's encoder, from the copy the CUDA runtime has loaded: no link
// against libcuda, and no entry-point API that differs by toolkit.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr : reinterpret_cast<EncodeTiled>(
        dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A 4-d map over keys [0, n_keys) of one K or V view (B, Skv, Hkv, d),
// innermost first; boxes of 64 keys x one head x 64 d (bf16, 128-byte
// swizzle) or x d (f32, unswizzled).  Strides of size-1 axes may be 0
// and are replaced.
int encode_kv(CUtensorMap* map, const void* base, bool f32, int d, int B,
              int n_keys, int Hkv, int64_t sb, int64_t ss, int64_t sh) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return -1;
  const uint64_t es = f32 ? 4 : 2;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                        static_cast<cuuint64_t>(Hkv),
                        static_cast<cuuint64_t>(n_keys),
                        static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * es,
                           static_cast<cuuint64_t>(ss) * es,
                           static_cast<cuuint64_t>(sb) * es};
  if (strides[0] == 0) strides[0] = d * es;
  if (strides[1] == 0) strides[1] = strides[0] * dims[1];
  if (strides[2] == 0) strides[2] = strides[1] * dims[2];
  cuuint32_t box[4] = {f32 ? static_cast<cuuint32_t>(d) : 64u, 1u,
                       static_cast<cuuint32_t>(BK), 1u};
  cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  const CUresult res = encode(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      f32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : -2;
}

template <int DQK, int DV, bool F32KV>
int launch(const CUtensorMap& tm_k, const CUtensorMap& tm_v, const Args& a,
           int B, cudaStream_t stream) {
  constexpr int smem = Plan<DQK, DV, F32KV>::SMEM;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma_kernel<DQK, DV, F32KV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  using P = Plan<DQK, DV, F32KV>;
  Args args = a;
  args.heads_per_block =
      P::PACK_HEADS && a.group % P::CONSUMERS == 0 ? P::CONSUMERS : 1;
  const int rows = args.heads_per_block > 1 ? BM : P::BQ;
  const dim3 grid(B * a.H / args.heads_per_block, (a.Sq + rows - 1) / rows);
  flash_wgmma_kernel<DQK, DV, F32KV><<<grid, P::NTHREADS, smem, stream>>>(
      tm_k, tm_v, args);
  return static_cast<int>(cudaGetLastError());
}

template <int DQK, int DV>
int launch(const CUtensorMap& tm_k, const CUtensorMap& tm_v, const Args& a,
           bool kv_f32, int B, cudaStream_t stream) {
  return kv_f32 ? launch<DQK, DV, true>(tm_k, tm_v, a, B, stream)
                : launch<DQK, DV, false>(tm_k, tm_v, a, B, stream);
}

}  // namespace fa_wgmma

// Whether the tensor-core kernel is built for head dims (dqk, dv).
bool flash_wgmma_takes(int dqk, int dv) {
  return (dqk == 64 && dv == 64) || (dqk == 128 && dv == 128)
      || (dqk == 192 && (dv == 192 || dv == 128));
}

// Called by flash_attention.cu's C entry for q bf16 at head dims that
// `flash_wgmma_takes`.  Strides in elements.  Returns 0, a cudaError_t,
// or kErrTensorMap (-4) when a K/V view gets no TMA tensor map from
// libcuda.
int flash_wgmma_launch(const void* q, const void* k, const void* v, void* o,
                       bool kv_f32, int B, int Sq, int Skv, int H, int Hkv,
                       int dqk, int dv, int64_t q_sb, int64_t q_ss,
                       int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                       int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
                       int64_t o_ss, int64_t o_sh, int causal, int q_offset,
                       float scale, cudaStream_t stream) {
  using namespace fa_wgmma;
  // Keys any query of the launch sees; TMA zero-fills past them.  (With
  // none, no tile is loaded and the map's one key is never read.)
  const int n_keys = max(1, causal ? min(Skv, q_offset + Sq) : Skv);
  CUtensorMap tm_k, tm_v;
  if (encode_kv(&tm_k, k, kv_f32, dqk, B, n_keys, Hkv, k_sb, k_ss, k_sh) != 0
      || encode_kv(&tm_v, v, kv_f32, dv, B, n_keys, Hkv, v_sb, v_ss,
                   v_sh) != 0) {
    return -4;
  }
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.Sq = Sq; a.Skv = Skv; a.H = H; a.group = H / Hkv;
  a.heads_per_block = 1;
  a.causal = causal; a.q_offset = q_offset;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.o_sb = o_sb; a.o_ss = o_ss; a.o_sh = o_sh;
  a.scale_log2 = scale * LOG2E;
  if (dqk == 192 && dv == 128) {
    return launch<192, 128>(tm_k, tm_v, a, kv_f32, B, stream);
  }
  if (dqk == 192) return launch<192, 192>(tm_k, tm_v, a, kv_f32, B, stream);
  if (dqk == 64) return launch<64, 64>(tm_k, tm_v, a, kv_f32, B, stream);
  return launch<128, 128>(tm_k, tm_v, a, kv_f32, B, stream);
}
