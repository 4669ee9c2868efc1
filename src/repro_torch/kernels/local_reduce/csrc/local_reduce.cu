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
// value and does k - 1 additions, so bytes set the least time: 12 n bytes
// at k = 2 in f32 over 3.35 TB/s.
//
// Design.  A grid-stride loop over the flat (ragged) length; no padding
// to the TPU's (8, 128) tiles.  When every operand is f32 and 16-byte
// aligned, each thread moves four values at a time as float4 (the body),
// and a scalar loop takes the tail; other types and alignments take the
// scalar loop throughout.  The k input pointers travel in the kernel's
// parameter block, so the k chunks need not be stacked into one buffer.
// The additions are __fadd_rn so no compiler contraction can change them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunks = 8;
constexpr int kThreads = 256;
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

template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
    sum_chunks_kernel(ChunkPtrs in, int k, TO* __restrict__ out, int64_t n,
                      int64_t n_vec4) {
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t body = 0;
  if constexpr (sizeof(TI) == 4 && sizeof(TO) == 4) {
    // n_vec4 > 0 only when all pointers are 16-byte aligned (host side).
    for (int64_t v = tid; v < n_vec4; v += stride) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int j = 0; j < k; ++j) {
        const float4 x = reinterpret_cast<const float4*>(in.p[j])[v];
        acc.x = __fadd_rn(acc.x, x.x);
        acc.y = __fadd_rn(acc.y, x.y);
        acc.z = __fadd_rn(acc.z, x.z);
        acc.w = __fadd_rn(acc.w, x.w);
      }
      reinterpret_cast<float4*>(out)[v] = acc;
    }
    body = 4 * n_vec4;
  }
  for (int64_t i = body + tid; i < n; i += stride) {
    float acc = 0.0f;
    for (int j = 0; j < k; ++j)
      acc = __fadd_rn(acc, to_f32(static_cast<const TI*>(in.p[j])[i]));
    out[i] = from_f32<TO>(acc);
  }
}

int grid_for(int64_t work) {
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t want = (work + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 8;
  return static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
}

template <typename TI, typename TO>
int launch(const ChunkPtrs& in, int k, void* out, int64_t n,
           cudaStream_t stream) {
  bool aligned = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int j = 0; j < k; ++j)
    aligned = aligned && reinterpret_cast<uintptr_t>(in.p[j]) % 16 == 0;
  const int64_t n_vec4 =
      (sizeof(TI) == 4 && sizeof(TO) == 4 && aligned) ? n / 4 : 0;
  const int64_t work = n_vec4 > 0 ? n_vec4 : n;
  sum_chunks_kernel<TI, TO><<<grid_for(work), kThreads, 0, stream>>>(
      in, k, static_cast<TO*>(out), n, n_vec4);
  return static_cast<int>(cudaGetLastError());
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
    return launch<float, float>(in, k, out, n, st);
  if (in_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(in, k, out, n, st);
  if (in_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(in, k, out, n, st);
  return launch<__nv_bfloat16, __nv_bfloat16>(in, k, out, n, st);
}

extern "C" const char* local_reduce_error_string(int code) {
  switch (code) {
    case kErrChunks: return "k must be between 1 and 8";
    case kErrDtype: return "dtypes must be float32 or bfloat16";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
