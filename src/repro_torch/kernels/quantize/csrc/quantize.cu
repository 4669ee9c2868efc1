// Blockwise symmetric int8 quantize / dequantize / dequant-add for Hopper
// (sm_90a): the int8 ring of the compressed gradient all-reduce.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/quantize/kernel.py:
//   quantize_2d   (_quantize_kernel)    -> quantize_int8
//   dequantize_2d (_dequantize_kernel)  -> dequantize_int8
//   dequant_add_2d (_dequant_add_kernel) -> dequant_add_int8
// core/compression.py calls them on every hop of the int8 ring, for the
// all-gather payload and for the error-feedback residual.
//
// Function (QBLOCK = 256 values share one f32 scale):
//   quantize:    amax = max |x| over the block; scale = amax * fl(1/127),
//                the f32 product with the rounded reciprocal, or 1.0 for
//                an all-zero block.  XLA rewrites the reference's
//                `amax / 127.0` into that product wherever the reference
//                is compiled (its jitted steps and its kernel in
//                interpret mode), so this is the reference's bit pattern;
//                q = clamp(rint(x / scale), -127, 127) (true division,
//                round half to even), stored as int8.
//   dequantize:  out = q * scale, in f32.
//   dequant_add: out = acc + q * scale, rounded once (a fused
//                multiply-add): XLA contracts the reference's
//                dequantize-then-add into one, in its jitted steps and
//                its kernel in interpret mode alike.
// Every division, product and multiply-add is an explicitly rounded
// intrinsic (__fdiv_rn, __fmul_rn, __fmaf_rn), so no compiler
// contraction or reciprocal rewrite can change a bit.  The build passes
// no --use_fast_math.
//
// What bounds them.  All three are one pass over memory with a few
// operations a value: bytes set the least time.  Per value, quantize
// reads 4 bytes and writes 1 (plus 4 per 256 for the scale), dequantize
// reads 1 and writes 4, dequant_add reads 5 and writes 4.
//
// Design.  quantize: one warp per 256-value block, 8 values a lane read
// as two float4, the block's max reduced across the warp with
// __shfl_xor_sync, each lane writing its 8 codes as one 8-byte store and
// lane 0 the scale; warps stride over blocks.  dequantize and
// dequant_add: four values a thread (a char4 of codes, float4 in and
// out, one scale since 4 divides 256), grid-stride.  The wrappers hand
// over 16-byte-aligned contiguous buffers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQBlock = 256;
constexpr int kThreads = 256;
constexpr int kErrLength = -1;
constexpr float kInv127 = 1.0f / 127.0f;  // rounded once, at compile time

int grid_for(int64_t work) {
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t want = (work + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  return static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
}

__device__ __forceinline__ int8_t code(float x, float scale) {
  float t = rintf(__fdiv_rn(x, scale));
  t = fminf(fmaxf(t, -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(t));
}

__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ scale, int64_t rows) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t r = warp; r < rows; r += n_warps) {
    const float4* src =
        reinterpret_cast<const float4*>(x + r * kQBlock) + 2 * lane;
    const float4 a = src[0];
    const float4 b = src[1];
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    float amax = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float s = amax > 0.0f ? __fmul_rn(amax, kInv127) : 1.0f;
    union {
      int8_t c[8];
      int2 packed;
    } out;
#pragma unroll
    for (int j = 0; j < 8; ++j) out.c[j] = code(v[j], s);
    reinterpret_cast<int2*>(q + r * kQBlock)[lane] = out.packed;
    if (lane == 0) scale[r] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ scale,
                      float* __restrict__ out, int64_t n4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       v < n4; v += stride) {
    const char4 c = reinterpret_cast<const char4*>(q)[v];
    const float s = scale[(4 * v) / kQBlock];
    float4 o;
    o.x = __fmul_rn(static_cast<float>(c.x), s);
    o.y = __fmul_rn(static_cast<float>(c.y), s);
    o.z = __fmul_rn(static_cast<float>(c.z), s);
    o.w = __fmul_rn(static_cast<float>(c.w), s);
    reinterpret_cast<float4*>(out)[v] = o;
  }
}

__global__ void __launch_bounds__(kThreads)
    dequant_add_kernel(const float* __restrict__ acc,
                       const int8_t* __restrict__ q,
                       const float* __restrict__ scale,
                       float* __restrict__ out, int64_t n4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       v < n4; v += stride) {
    const char4 c = reinterpret_cast<const char4*>(q)[v];
    const float4 a = reinterpret_cast<const float4*>(acc)[v];
    const float s = scale[(4 * v) / kQBlock];
    float4 o;
    o.x = __fmaf_rn(static_cast<float>(c.x), s, a.x);
    o.y = __fmaf_rn(static_cast<float>(c.y), s, a.y);
    o.z = __fmaf_rn(static_cast<float>(c.z), s, a.z);
    o.w = __fmaf_rn(static_cast<float>(c.w), s, a.w);
    reinterpret_cast<float4*>(out)[v] = o;
  }
}

}  // namespace

// x: rows * 256 f32 -> q: rows * 256 int8, scale: rows f32.
extern "C" int quantize_int8(const void* x, void* q, void* scale,
                             int64_t rows, void* stream) {
  if (rows <= 0) return kErrLength;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  quantize_kernel<<<grid_for(rows * 32), kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scale), rows);
  return static_cast<int>(cudaGetLastError());
}

// q: n int8, scale: n / 256 f32 -> out: n f32 (n a multiple of 256).
extern "C" int dequantize_int8(const void* q, const void* scale, void* out,
                               int64_t n, void* stream) {
  if (n <= 0 || n % kQBlock) return kErrLength;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  dequantize_kernel<<<grid_for(n / 4), kThreads, 0, st>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<float*>(out), n / 4);
  return static_cast<int>(cudaGetLastError());
}

// acc: n f32, q: n int8, scale: n / 256 f32 -> out: n f32.
extern "C" int dequant_add_int8(const void* acc, const void* q,
                                const void* scale, void* out, int64_t n,
                                void* stream) {
  if (n <= 0 || n % kQBlock) return kErrLength;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  dequant_add_kernel<<<grid_for(n / 4), kThreads, 0, st>>>(
      static_cast<const float*>(acc), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<float*>(out), n / 4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* quantize_error_string(int code) {
  if (code == kErrLength)
    return "length must be a positive multiple of the 256-value block";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
