// Fused RMSNorm of a (rows, d) slab: y = x * rsqrt(mean(x^2) + eps) * scale,
// summed and scaled in f32, cast to x's type.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm/kernel.py
// (rmsnorm_kernel / _rmsnorm_kernel).  The TPU wrapper padded d to 128 lanes
// and the rows to whole blocks and divided by the unpadded d; here the kernel
// masks its own ragged edges, so nothing is padded or copied.
//
// What bounds it on an H100: bytes.  Each element is read once and written
// once with three operations in between, far below the card's 295 operations
// per byte, so the kernel is a streaming pass:
//   * one warp per row, kWarpsPerBlock rows per block, so a row's sum is a
//     warp-shuffle reduction with no shared memory and no barrier;
//   * 16-byte loads and stores where the row allows: a row that starts off a
//     16-byte boundary (d * sizeof(T) not a multiple of 16) takes scalar
//     elements up to the boundary, 16-byte vectors after it, and a scalar
//     tail for what is left;
//   * a second pass over the row for the output, which finds the row in L1
//     or L2 (it was read a moment before), so device memory sees each byte
//     once;
//   * rows past the last one (a ragged last block) return at once.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kWarpsPerBlock = 16;   // rows per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

template <typename T, typename S>
__global__ void __launch_bounds__(kWarpsPerBlock * 32) rmsnorm_kernel(
    const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ out, int rows, int d,
    float eps, int vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const long row = (long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* yr = out + row * d;

  // [0, head) scalar, [head, tail) 16-byte vectors, [tail, d) scalar.  x and
  // out share their alignment (vec_ok), so one split serves both.
  int head = d, tail = d;
  if (vec_ok) {
    const int mis = (int)(reinterpret_cast<uintptr_t>(xr) % 16) / (int)sizeof(T);
    head = min(d, mis ? VEC - mis : 0);
    tail = head + (d - head) / VEC * VEC;
  }
  const uint4* xv = reinterpret_cast<const uint4*>(xr + head);
  const int nvec = (tail - head) / VEC;

  float ss = 0.f;
  for (int i = lane; i < head; i += 32) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
  for (int k = lane; k < nvec; k += 32) {
    const uint4 u = __ldg(xv + k);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float v = to_f32(e[j]);
      ss = fmaf(v, v, ss);
    }
  }
  for (int i = tail + lane; i < d; i += 32) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float inv = rsqrtf(ss / (float)d + eps);

  for (int i = lane; i < head; i += 32)
    yr[i] = from_f32<T>(to_f32(xr[i]) * inv * to_f32(scale[i]));
  uint4* yv = reinterpret_cast<uint4*>(yr + head);
  for (int k = lane; k < nvec; k += 32) {
    const uint4 u = __ldg(xv + k);
    const T* e = reinterpret_cast<const T*>(&u);
    const S* s = scale + head + k * VEC;   // the scale is small and stays in L1
    uint4 o;
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int j = 0; j < VEC; ++j) oe[j] = from_f32<T>(to_f32(e[j]) * inv * to_f32(s[j]));
    yv[k] = o;
  }
  for (int i = tail + lane; i < d; i += 32)
    yr[i] = from_f32<T>(to_f32(xr[i]) * inv * to_f32(scale[i]));
}

template <typename T, typename S>
static int launch(const void* x, const void* scale, void* out, int rows, int d, float eps,
                  int vec_ok, cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rmsnorm_kernel<T, S><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(out), rows, d, eps,
      vec_ok);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// x, out (rows, d) contiguous, scale (d,) contiguous, all on one device;
// rows, d >= 1.  dtype codes: 0 = bfloat16, 1 = float32, 2 = float16; the
// scale has x's type or float32.  vec_ok: x and out share their address
// modulo 16, so a row's 16-byte boundaries fall at the same element in both.
// Returns a cudaError_t; a type pair the kernel does not take returns -1.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out, int rows, int d,
                              int dtype, int scale_dtype, float eps, int vec_ok, void* stream) {
  using namespace repro_torch;
  if (rows <= 0 || d <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && scale_dtype == 0)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d, eps, vec_ok, s);
  if (dtype == 0 && scale_dtype == 1)
    return launch<__nv_bfloat16, float>(x, scale, out, rows, d, eps, vec_ok, s);
  if (dtype == 1 && scale_dtype == 1)
    return launch<float, float>(x, scale, out, rows, d, eps, vec_ok, s);
  if (dtype == 2 && scale_dtype == 2)
    return launch<__half, __half>(x, scale, out, rows, d, eps, vec_ok, s);
  if (dtype == 2 && scale_dtype == 1)
    return launch<__half, float>(x, scale, out, rows, d, eps, vec_ok, s);
  return -1;
}
