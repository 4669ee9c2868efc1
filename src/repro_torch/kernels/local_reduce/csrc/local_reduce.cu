// k-way chunk reduction for Hopper (sm_90a): the ring reduce-scatter
// combine.
//
// Replaces the Pallas TPU kernel `sum_chunks_3d` / `_sum_kernel` in
// src/repro/kernels/local_reduce/kernel.py.  The ring and bidirectional
// ring reduce-scatter (core/protocols/ring.py `_combine`) call it with
// k = 2: the partial sum a rank received plus its own chunk.
//
// Function.  out[i] = (((0 + x_0[i]) + x_1[i]) + ...) + x_{k-1}[i], each
// input converted to f32 and every addition rounded to nearest (f32),
// then the sum converted once to the output type (f32, or bf16 rounded
// to nearest even).  That is the TPU kernel's order: its output block
// starts at zero and accumulates the k inputs j = 0..k-1 in turn.  For
// f32, 0 + a + b is a + b bit for bit; for bf16 inputs and output it is
// the f32 sum rounded once, which is what a bf16 `a + b` computes.
//
// What bounds it.  Each output value reads k inputs and writes one
// value and does k - 1 additions, so bytes set the least time: 6 n bytes
// at k = 2 in bf16 (12 n in f32) over 3.35 TB/s (H100 SXM data sheet).
//
// Design.  Every dtype pair moves 16-byte vectors: a thread takes one
// group of E values (8 when either side is bf16, 4 for f32 -> f32), read
// as one or two 16-byte loads an input (k is a template parameter, so
// the k loads issue before the first add) and written as one or two
// 16-byte stores.  Loads carry the L2 256-byte prefetch hint and stores
// are streaming (`__stcs`): each chunk is read once and the sum written
// once.  A block of 1024 threads (512 where a thread loads more than two
// words) takes as many consecutive groups and the grid covers the whole
// length, so every load instruction of a warp reads 512 contiguous bytes
// and the blocks stream through memory in order; no device query sizes
// the grid.  (On H100s this layout beat a grid-stride loop with 4 groups
// a thread in flight, 1024-thread blocks beat 512, and the prefetch hint
// beat streaming loads on one card and tied on others: all of it at the
// DRAM limit `torch.add` reaches.)
// A scalar head and tail take the values before the first 16-byte
// boundary and after the last whole group when every pointer sits at the
// same offset from one; pointers at different offsets take the scalar
// path throughout, 4 values a thread in flight.  The k input pointers
// travel in the kernel's parameter block, so the chunks need not be
// stacked.  The additions are __fadd_rn so no compiler contraction can
// change them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunks = 8;
constexpr int64_t kMaxGrid = 1 << 30;
constexpr int kScalarIlp = 4;         // scalar values a thread keeps going
constexpr int kErrChunks = -1;
constexpr int kErrDtype = -2;

struct ChunkPtrs {
  const void* p[kMaxChunks];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// E values of type T as 16-byte words.
template <typename T, int E>
struct Vec {
  static constexpr int WORDS = E * static_cast<int>(sizeof(T)) / 16;
  uint4 w[WORDS];

  // Each chunk is read once: ask L2 to fetch whole 256-byte blocks.
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < WORDS; ++i) {
      asm volatile("ld.global.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(w[i].x), "=r"(w[i].y), "=r"(w[i].z), "=r"(w[i].w)
                   : "l"(reinterpret_cast<const uint4*>(p) + i));
    }
  }
  __device__ __forceinline__ void store(T* p) const {
#pragma unroll
    for (int i = 0; i < WORDS; ++i)
      __stcs(reinterpret_cast<uint4*>(p) + i, w[i]);
  }
  __device__ __forceinline__ T get(int e) const {
    return reinterpret_cast<const T*>(w)[e];
  }
  __device__ __forceinline__ void set(int e, T v) {
    reinterpret_cast<T*>(w)[e] = v;
  }
};

template <typename TI, typename TO, int K>
struct Shape {
  static constexpr int E = (sizeof(TI) == 2 || sizeof(TO) == 2) ? 8 : 4;
  // 1024 threads a block where a thread loads at most two 16-byte words
  // (k = 2 in bf16 or f32 -> f32; 64 registers a thread suffice), 512
  // where it loads more.
  static constexpr int THREADS =
      K * E * static_cast<int>(sizeof(TI)) <= 32 ? 1024 : 512;
};

template <typename TI, typename TO, int K>
__global__ void __launch_bounds__(Shape<TI, TO, K>::THREADS)
    sum_chunks_kernel(ChunkPtrs in, TO* __restrict__ out, int64_t n,
                      int64_t head, int64_t n_groups) {
  constexpr int E = Shape<TI, TO, K>::E;
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;

  // Body: group g holds elements head + E g .. + E - 1.
  for (int64_t g = tid; g < n_groups; g += stride) {
    Vec<TI, E> v[K];
#pragma unroll
    for (int j = 0; j < K; ++j)
      v[j].load(static_cast<const TI*>(in.p[j]) + head + g * E);
    Vec<TO, E> r;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < K; ++j) acc = __fadd_rn(acc, to_f32(v[j].get(e)));
      r.set(e, from_f32<TO>(acc));
    }
    r.store(out + head + g * E);
  }

  // Head [0, head) and tail [head + E n_groups, n): kScalarIlp values a
  // thread, a grid apart so that each load of a warp is contiguous.
  const int64_t tail0 = head + E * n_groups;
  const int64_t rest = head + (n - tail0);
  for (int64_t r0 = tid; r0 < rest; r0 += stride * kScalarIlp) {
    float acc[kScalarIlp];
#pragma unroll
    for (int u = 0; u < kScalarIlp; ++u) {
      const int64_t r = r0 + u * stride;
      const int64_t i = r < head ? r : tail0 + (r - head);
      acc[u] = 0.0f;
      if (r < rest) {
#pragma unroll
        for (int j = 0; j < K; ++j)
          acc[u] = __fadd_rn(acc[u],
                             to_f32(static_cast<const TI*>(in.p[j])[i]));
      }
    }
#pragma unroll
    for (int u = 0; u < kScalarIlp; ++u) {
      const int64_t r = r0 + u * stride;
      if (r < rest) {
        out[r < head ? r : tail0 + (r - head)] = from_f32<TO>(acc[u]);
      }
    }
  }
}

template <typename TI, typename TO, int K>
int launch(const ChunkPtrs& in, void* out, int64_t n, cudaStream_t stream) {
  constexpr int E = Shape<TI, TO, K>::E;
  constexpr int T = Shape<TI, TO, K>::THREADS;
  // Head: values before input 0 reaches a 16-byte boundary.  The vector
  // body needs every input and the output 16-byte aligned from there.
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(in.p[0]);
  int64_t head = 0, n_groups = 0;
  if (a0 % sizeof(TI) == 0) {
    head = static_cast<int64_t>((16 - a0 % 16) % 16 / sizeof(TI));
    bool vec = head < n;
    for (int j = 0; j < K; ++j)
      vec = vec && reinterpret_cast<uintptr_t>(in.p[j]) % 16 == a0 % 16;
    vec = vec && (reinterpret_cast<uintptr_t>(out) + head * sizeof(TO)) % 16
                     == 0;
    if (vec) n_groups = (n - head) / E;
  }
  if (n_groups == 0) head = 0;
  const int64_t scalar = (n - E * n_groups + kScalarIlp - 1) / kScalarIlp;
  const int64_t work = n_groups > scalar ? n_groups : scalar;
  const int64_t want = (work + T - 1) / T;
  const int grid = static_cast<int>(want < kMaxGrid ? want : kMaxGrid);
  sum_chunks_kernel<TI, TO, K><<<grid, T, 0, stream>>>(
      in, static_cast<TO*>(out), n, head, n_groups);
  return static_cast<int>(cudaGetLastError());
}

template <typename TI, typename TO>
int launch_k(const ChunkPtrs& in, int k, void* out, int64_t n,
             cudaStream_t st) {
  switch (k) {
    case 1: return launch<TI, TO, 1>(in, out, n, st);
    case 2: return launch<TI, TO, 2>(in, out, n, st);
    case 3: return launch<TI, TO, 3>(in, out, n, st);
    case 4: return launch<TI, TO, 4>(in, out, n, st);
    case 5: return launch<TI, TO, 5>(in, out, n, st);
    case 6: return launch<TI, TO, 6>(in, out, n, st);
    case 7: return launch<TI, TO, 7>(in, out, n, st);
    default: return launch<TI, TO, 8>(in, out, n, st);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns 0 or an error code.
extern "C" int local_reduce_sum_chunks(const void* const* chunks, int k,
                                       void* out, int64_t n, int in_dtype,
                                       int out_dtype, void* stream) {
  if (k < 1 || k > kMaxChunks) return kErrChunks;
  if (in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return kErrDtype;
  ChunkPtrs in{};
  for (int j = 0; j < k; ++j) in.p[j] = chunks[j];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch_k<float, float>(in, k, out, n, st);
  if (in_dtype == 0 && out_dtype == 1)
    return launch_k<float, __nv_bfloat16>(in, k, out, n, st);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_k<__nv_bfloat16, float>(in, k, out, n, st);
  return launch_k<__nv_bfloat16, __nv_bfloat16>(in, k, out, n, st);
}

extern "C" const char* local_reduce_error_string(int code) {
  switch (code) {
    case kErrChunks: return "k must be between 1 and 8";
    case kErrDtype: return "dtypes must be float32 or bfloat16";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
