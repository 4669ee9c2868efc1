// Blockwise (flash) attention forward for Hopper (sm_90a), causal or
// not: the CUDA-core variant, and the C entry of both variants.
//
// The C entry `flash_attention_fwd` (end of file) chooses by type and
// head dims: a bf16 query at (DQK, DV) = (64, 64), (128, 128), (192,
// 192) or MLA's (192, 128) (every launch of the full-width serve paths)
// runs the tensor-core kernel of flash_attention_wgmma.cu; any other
// query (f32, whose output is held to 1e-4, or the reduced head dim 16)
// runs the kernel below.  The choice is explicit and reported to the
// caller; nothing retries on the other kernel.
//
// Replaces the Pallas TPU kernel `flash_attention_bhsd` /
// `_flash_kernel` in src/repro/kernels/flash_attention/kernel.py, and
// serves the model's two prefill paths: `chunk_attention` (a page-sized
// chunk of queries against the whole max_len cache, causal at a runtime
// `q_offset`) and the one-shot `flash_attention`, and the
// encoder-decoder's non-causal encoder and cross-attention.
//
// Function.  q (B, Sq, H, DQK), k (B, Skv, Hkv, DQK), v (B, Skv, Hkv,
// DV), o (B, Sq, H, DV) in q's dtype.  Query head h reads KV head h / (H / Hkv) (GQA, no repeated
// KV in memory).  Query row i sits at absolute position q_offset + i and
// sees keys at positions <= that (causal) and < Skv; with causal = 0
// every row sees all Skv keys.  Each operand is
// loaded in its own dtype (f32 or bf16) and converted to f32; q is
// scaled on load, scores, the online softmax and P.V run in f32, and a
// row that sees no key writes 0 (the TPU kernel's l == 0 guard).
//
// What bounds it.  A serving chunk is Sq = 256 queries against the
// causal prefix of the cache, q_offset + 256 keys.  Every K/V byte of the
// prefix is used by Sq * (H / Hkv) query rows, so at late chunks the
// score and P.V arithmetic, not the bytes, sets the least time; at early
// chunks the bytes of q and o do.  This variant computes on the CUDA
// cores in f32, so f32 FMA throughput (67 TFLOP/s on an H100 SXM) and
// shared-memory traffic set its time; PERF.md has it against the bound.
//
// Design.  One block per (batch * head, 64-query tile), 128 threads as a
// 16 x 8 grid.  The q tile sits in shared memory for the block's life;
// 64-key K and V tiles are staged through shared memory one at a time,
// rows past Skv zero-filled, so Sq and Skv need not be tile multiples.
// Each thread owns 4 query rows x 8 keys of a score tile and 4 rows x DV/8
// output columns of the accumulator (DV = 64, 128 or 192 at full width,
// 16 in the reduced configs); row max and row sum reduce over the
// 8 lanes sharing a row with warp shuffles, so m, l and the accumulator
// live in registers.  KV tiles past the tile's last query are never
// loaded (the causal skip: in the chunked path Skv is the whole max_len
// arena, so this is the main saving), and the tail tile's P.V loop stops
// at the last visible key.  Query tiles are issued last-first so the
// longest causal rows start earliest, and consecutive blocks are the
// heads of one KV group, which share K/V through L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per staged tile
constexpr int TY = 16;          // thread grid: TY x TX
constexpr int TX = 8;
constexpr int NTHREADS = TY * TX;
constexpr int RPT = BQ / TY;    // query rows per thread
constexpr int CPT = BK / TX;    // score columns per thread
constexpr int P_STRIDE = BK + 1;

// Per head dims (DQK, DV): output columns per thread and the
// shared-memory plan (164 KB at (192, 192), the largest).
template <int DQK, int DV>
struct Tile {
  static_assert(DQK % 4 == 0 && DV % TX == 0 && DV % 4 == 0,
                "unsupported head dims");
  static constexpr int DPT = DV / TX;        // output columns per thread
  static constexpr int QK_STRIDE = DQK + 1;  // padded: conflict-free columns
  static constexpr int SMEM_FLOATS =
      BQ * QK_STRIDE + BK * QK_STRIDE + BK * DV + BQ * P_STRIDE;
};

// head dims built: (16, 16) reduced, (64, 64), (128, 128), (192, 192),
// (192, 128)
constexpr int kErrHeadDim = -1;
constexpr int kErrHeads = -2;
constexpr int kErrDtype = -3;
constexpr int kErrTensorMap = -4;  // from flash_wgmma_launch

__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Stage rows [row0, row0 + 64) of one head's (S, D) slab into shared
// memory as f32 (times `mul`), with `stride` floats per row; rows at or
// past `nrows` are zero.
template <int D, typename T>
__device__ __forceinline__ void stage_tile(float* dst, int stride,
                                           const T* base, int64_t row_step,
                                           int row0, int nrows, float mul) {
  constexpr int GROUPS = BK * D / 4;            // float4 groups per tile
  for (int g = threadIdx.x; g < GROUPS; g += NTHREADS) {
    const int r = g / (D / 4);
    const int c = (g % (D / 4)) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < nrows) {
      load4(base + (int64_t)(row0 + r) * row_step + c, x);
    }
    float* d = dst + r * stride + c;
    d[0] = x[0] * mul; d[1] = x[1] * mul; d[2] = x[2] * mul; d[3] = x[3] * mul;
  }
}

template <int DQK, int DV, typename TQ, typename TKV>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                 const TKV* __restrict__ v, TQ* __restrict__ o,
                 int Sq, int Skv, int H, int group,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh,
                 int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 int64_t o_sb, int64_t o_ss, int64_t o_sh,
                 int causal, int q_offset, float scale) {
  constexpr int DPT = Tile<DQK, DV>::DPT;
  constexpr int QK_STRIDE = Tile<DQK, DV>::QK_STRIDE;
  extern __shared__ float smem[];
  float* Qs = smem;                          // [BQ][QK_STRIDE]
  float* Ks = Qs + BQ * QK_STRIDE;           // [BK][QK_STRIDE]
  float* Vs = Ks + BK * QK_STRIDE;           // [BK][DV]
  float* Ps = Vs + BK * DV;                  // [BQ][P_STRIDE]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;

  const TQ* qb = q + b * q_sb + h * q_sh;
  const TKV* kb = k + b * k_sb + hk * k_sh;
  const TKV* vb = v + b * v_sb + hk * v_sh;

  // Keys this tile can see: up to its last query's position (causal).
  int kv_end = Skv;
  if (causal) {
    const int last_q = q_offset + min(q0 + BQ, Sq) - 1;
    kv_end = max(0, min(Skv, last_q + 1));
  }

  stage_tile<DQK>(Qs, QK_STRIDE, qb, q_ss, q0, Sq, scale);

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();                         // previous tile fully consumed
    stage_tile<DQK>(Ks, QK_STRIDE, kb, k_ss, k0, Skv, 1.f);
    stage_tile<DV>(Vs, DV, vb, v_ss, k0, Skv, 1.f);
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DQK; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty + i * TY) * QK_STRIDE + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tx + j * TX) * QK_STRIDE + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float alpha[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + i * TY;
      const int qpos = q_offset + q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + j * TX;
        const bool ok = kpos < kv_end && (!causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < TX; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      alpha[i] = expf(m[i] - m_use);         // 0 while the row saw nothing
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_use);   // masked: exp(-inf) = 0
        Ps[r * P_STRIDE + tx + j * TX] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 1; off < TX; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha[i] * l[i] + rs;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha[i];
    const int ncols = min(BK, kv_end - k0);
    for (int c = 0; c < ncols; ++c) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty + i * TY) * P_STRIDE + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = Vs[c * DV + tx + j * TX];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + i * TY;
    if (row >= Sq) continue;
    const float denom = (l[i] == 0.f) ? 1.f : l[i];
    TQ* orow = o + b * o_sb + (int64_t)row * o_ss + h * o_sh;
#pragma unroll
    for (int j = 0; j < DPT; ++j) store1(orow + tx + j * TX, acc[i][j] / denom);
  }
}

template <int DQK, int DV, typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int Hkv, int64_t q_sb, int64_t q_ss,
           int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
           int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
           int64_t o_ss, int64_t o_sh, int causal, int q_offset, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = Tile<DQK, DV>::SMEM_FLOATS * sizeof(float);
  // Set per launch: the attribute is per device, and the call is cheap.
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<DQK, DV, TQ, TKV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel<DQK, DV, TQ, TKV><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<TQ*>(o), Sq, Skv, H, H / Hkv,
      q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
      causal, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// flash_attention_wgmma.cu
bool flash_wgmma_takes(int dqk, int dv);
int flash_wgmma_launch(const void* q, const void* k, const void* v, void* o,
                       bool kv_f32, int B, int Sq, int Skv, int H, int Hkv,
                       int dqk, int dv, int64_t q_sb, int64_t q_ss,
                       int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                       int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
                       int64_t o_ss, int64_t o_sh, int causal, int q_offset,
                       float scale, cudaStream_t stream);

// dtype codes: 0 = float32, 1 = bfloat16.  head_dim is q's and k's,
// v_head_dim v's and o's.  Strides are in elements; the last (head-dim)
// axis is contiguous.  Sets *variant to the kernel chosen
// (0: CUDA cores, f32; 1: tensor cores, wgmma) before launching it.
// Returns 0, a cudaError_t, or a negative code for arguments the kernel
// does not take.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int q_dtype,
    int kv_dtype, int B, int Sq, int Skv, int H, int Hkv, int head_dim,
    int v_head_dim, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
    int64_t o_ss, int64_t o_sh, int causal, int q_offset, float scale,
    void* stream, int* variant) {
  if (Hkv <= 0 || H % Hkv != 0) return kErrHeads;
  if (q_dtype < 0 || q_dtype > 1 || kv_dtype < 0 || kv_dtype > 1)
    return kErrDtype;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 1 && flash_wgmma_takes(head_dim, v_head_dim)) {
    *variant = 1;
    return flash_wgmma_launch(q, k, v, o, kv_dtype == 0, B, Sq, Skv, H, Hkv,
                              head_dim, v_head_dim, q_sb, q_ss, q_sh, k_sb,
                              k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                              causal, q_offset, scale, st);
  }
  *variant = 0;
#define FA_ARGS q, k, v, o, B, Sq, Skv, H, Hkv, q_sb, q_ss, q_sh, k_sb, k_ss, \
    k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, causal, q_offset, scale, st
#define FA_DTYPES(DQK, DV)                                                 \
  if (q_dtype == 0 && kv_dtype == 0)                                       \
    return launch<DQK, DV, float, float>(FA_ARGS);                         \
  if (q_dtype == 1 && kv_dtype == 0)                                       \
    return launch<DQK, DV, __nv_bfloat16, float>(FA_ARGS);                 \
  if (q_dtype == 0 && kv_dtype == 1)                                       \
    return launch<DQK, DV, float, __nv_bfloat16>(FA_ARGS);                 \
  return launch<DQK, DV, __nv_bfloat16, __nv_bfloat16>(FA_ARGS);
  if (head_dim == 128 && v_head_dim == 128) { FA_DTYPES(128, 128) }
  if (head_dim == 192 && v_head_dim == 192) { FA_DTYPES(192, 192) }
  if (head_dim == 192 && v_head_dim == 128) { FA_DTYPES(192, 128) }
  if (head_dim == 64 && v_head_dim == 64) { FA_DTYPES(64, 64) }
  if (head_dim == 16 && v_head_dim == 16) { FA_DTYPES(16, 16) }
#undef FA_DTYPES
#undef FA_ARGS
  return kErrHeadDim;
}

extern "C" const char* flash_attention_error_string(int code) {
  switch (code) {
    case kErrHeadDim:
      return "head dims (q/k, v) must be (16, 16), (64, 64), (128, 128), "
             "(192, 192) or (192, 128)";
    case kErrHeads: return "num_heads must be a multiple of num_kv_heads";
    case kErrDtype: return "dtypes must be float32 or bfloat16";
    case kErrTensorMap:
      return "no TMA tensor map for a K/V view (libcuda's encoder is "
             "missing or refused the view's strides)";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
