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
//   * the row kept in registers: for d up to kRegVectors 16-byte vectors a
//     row (16384 bf16 or f16, 8192 f32), each of the row's tpr threads issues
//     all its loads (up to VPL vectors, a compile-time count) before the
//     reduction, and writes its output from those registers: x is read once.
//     A slab larger than kStreamBytes (two thirds of the 50 MB L2) is read
//     and written with streaming accesses (__ldcs, __stcs), which leave the
//     L2 first; a smaller one keeps cached accesses, since it fits in the L2
//     beside what the calls around it use.  On an H100 80GB HBM3 at 700 W
//     (chip_smoke.py phase 1, a fresh output each call): 8192 x 4096 bf16
//     streamed 0.047 ms against 0.055 cached; 1000 x 4100 bf16 cached
//     0.0063 ms against 0.0072 streamed;
//   * tpr = 32 .. 256 threads a row, chosen by the launch: enough that a
//     thread holds at most 4 vectors, and more for short slabs, so that the
//     slab keeps about kFillThreads threads busy (1000 rows of 4100 would
//     otherwise fill half the SMs).  A row's warps sum through shared memory;
//   * the scale in 16-byte vectors where its start allows;
//   * a row that starts off a 16-byte boundary (d * sizeof(T) not a multiple
//     of 16) takes scalar elements up to the boundary, 16-byte vectors after
//     it, and a scalar tail for what is left;
//   * rows above the cap take a two-pass kernel, a warp per row, whose
//     second pass finds the row in L1 or L2.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

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

constexpr int kThreads = 256;                       // register path: threads a block
constexpr int kRegVectors = 2048;                   // ... vectors a row at most (256 x 8)
constexpr long kFillThreads = 1 << 18;              // threads a slab should keep busy
constexpr long kStreamBytes = 32l << 20;            // x larger than this: streaming accesses

// [0, head) scalar, [head, tail) 16-byte vectors, [tail, d) scalar.  x and
// out share their alignment (vec_ok), so one split serves both.
template <typename T>
__device__ __forceinline__ void row_split(const T* xr, int d, int vec_ok, int& head, int& tail) {
  constexpr int VEC = 16 / sizeof(T);
  head = d;
  tail = d;
  if (vec_ok) {
    const int mis = (int)(reinterpret_cast<uintptr_t>(xr) % 16) / (int)sizeof(T);
    head = min(d, mis ? VEC - mis : 0);
    tail = head + (d - head) / VEC * VEC;
  }
}

// The scale of VEC elements at s, as f32; 16-byte loads when s allows.
template <typename T, typename S>
__device__ __forceinline__ void load_scale(const S* s, float (&f)[16 / sizeof(T)]) {
  constexpr int VEC = 16 / sizeof(T), PER = 16 / sizeof(S);
  if (reinterpret_cast<uintptr_t>(s) % 16 == 0) {
#pragma unroll
    for (int n = 0; n < VEC / PER; ++n) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(s) + n);
      const S* e = reinterpret_cast<const S*>(&u);
#pragma unroll
      for (int j = 0; j < PER; ++j) f[n * PER + j] = to_f32(e[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) f[j] = to_f32(s[j]);
  }
}

// grid ceil(rows / (kThreads / tpr)), kThreads threads; tpr threads a row,
// each holding up to VPL of its row's vectors (VPL * tpr >= the row's).
// STREAM: x and out through streaming accesses, a compile-time choice (as a
// run-time flag its branch slowed the kernel by a fifth).
template <typename T, typename S, int VPL, bool STREAM>
__global__ void __launch_bounds__(kThreads) rmsnorm_regs_kernel(
    const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ out, int rows, int d,
    float eps, int vec_ok, int tpr) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float warp_ss[kThreads / 32];
  const int t = threadIdx.x % tpr, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long row = (long)blockIdx.x * (kThreads / tpr) + threadIdx.x / tpr;
  const bool live = row < rows;
  const T* xr = x + (live ? row : 0) * d;
  T* yr = out + row * d;
  int head, tail;
  row_split(xr, d, vec_ok, head, tail);
  const uint4* xv = reinterpret_cast<const uint4*>(xr + head);
  const int nvec = (tail - head) / VEC;

  uint4 buf[VPL];
#pragma unroll
  for (int u = 0; u < VPL; ++u)
    if (live && t + u * tpr < nvec)
      buf[u] = STREAM ? __ldcs(xv + t + u * tpr) : __ldg(xv + t + u * tpr);
  float ss = 0.f;
  if (live) {
    for (int i = t; i < head; i += tpr) {
      const float v = to_f32(xr[i]);
      ss = fmaf(v, v, ss);
    }
    for (int i = tail + t; i < d; i += tpr) {
      const float v = to_f32(xr[i]);
      ss = fmaf(v, v, ss);
    }
  }
#pragma unroll
  for (int u = 0; u < VPL; ++u) {
    if (live && t + u * tpr < nvec) {
      const T* e = reinterpret_cast<const T*>(&buf[u]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float v = to_f32(e[j]);
        ss = fmaf(v, v, ss);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (tpr > 32) {   // the row's warps: warp_ss[first .. first + tpr / 32)
    if (lane == 0) warp_ss[warp] = ss;
    __syncthreads();
    const int first = (threadIdx.x / tpr) * (tpr / 32);
    ss = 0.f;
    for (int w = 0; w < tpr / 32; ++w) ss += warp_ss[first + w];
  }
  if (!live) return;
  const float inv = rsqrtf(ss / (float)d + eps);

  for (int i = t; i < head; i += tpr) yr[i] = from_f32<T>(to_f32(xr[i]) * inv * to_f32(scale[i]));
  uint4* yv = reinterpret_cast<uint4*>(yr + head);
#pragma unroll
  for (int u = 0; u < VPL; ++u) {
    const int k = t + u * tpr;
    if (k < nvec) {
      float sf[VEC];
      load_scale<T, S>(scale + head + k * VEC, sf);
      const T* e = reinterpret_cast<const T*>(&buf[u]);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < VEC; ++j) oe[j] = from_f32<T>(to_f32(e[j]) * inv * sf[j]);
      if (STREAM)
        __stcs(yv + k, o);
      else
        yv[k] = o;
    }
  }
  for (int i = tail + t; i < d; i += tpr)
    yr[i] = from_f32<T>(to_f32(xr[i]) * inv * to_f32(scale[i]));
}

constexpr int kWarpsPerBlock = 16;   // two-pass path: rows per block

// Rows above the cap: a warp per row, the row read twice.
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
  int head, tail;
  row_split(xr, d, vec_ok, head, tail);
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
    float sf[VEC];
    load_scale<T, S>(scale + head + k * VEC, sf);
    uint4 o;
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int j = 0; j < VEC; ++j) oe[j] = from_f32<T>(to_f32(e[j]) * inv * sf[j]);
    yv[k] = o;
  }
  for (int i = tail + lane; i < d; i += 32)
    yr[i] = from_f32<T>(to_f32(xr[i]) * inv * to_f32(scale[i]));
}

template <typename T, typename S, int VPL>
static int launch_regs(const T* x, const S* scale, T* out, int rows, int d, float eps, int vec_ok,
                       int tpr, cudaStream_t stream) {
  const int rows_per_block = kThreads / tpr;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  if ((long)rows * d * (long)sizeof(T) > kStreamBytes)
    rmsnorm_regs_kernel<T, S, VPL, true><<<blocks, kThreads, 0, stream>>>(x, scale, out, rows, d,
                                                                        eps, vec_ok, tpr);
  else
    rmsnorm_regs_kernel<T, S, VPL, false><<<blocks, kThreads, 0, stream>>>(x, scale, out, rows,
                                                                         d, eps, vec_ok, tpr);
  return (int)cudaGetLastError();
}

template <typename T, typename S>
static int launch(const void* xp, const void* sp, void* op, int rows, int d, float eps,
                  int vec_ok, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xp);
  const S* scale = static_cast<const S*>(sp);
  T* out = static_cast<T*>(op);
  const int nv = d / VEC;   // at least the vectors of any row
  if (nv <= kRegVectors) {
    // threads a row: at most 4 vectors each, then more while the slab is short
    int tpr = 32;
    while (tpr < kThreads && nv > 4 * tpr) tpr *= 2;
    while (tpr < kThreads && (long)rows * tpr < kFillThreads) tpr *= 2;
    const int vpl = (nv + tpr - 1) / tpr;
    if (vpl <= 1) return launch_regs<T, S, 1>(x, scale, out, rows, d, eps, vec_ok, tpr, stream);
    if (vpl <= 2) return launch_regs<T, S, 2>(x, scale, out, rows, d, eps, vec_ok, tpr, stream);
    if (vpl <= 4) return launch_regs<T, S, 4>(x, scale, out, rows, d, eps, vec_ok, tpr, stream);
    return launch_regs<T, S, 8>(x, scale, out, rows, d, eps, vec_ok, tpr, stream);
  }
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rmsnorm_kernel<T, S><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(x, scale, out, rows, d, eps,
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
