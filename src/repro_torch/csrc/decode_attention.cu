// Decode attention: one new query token per sequence against its KV cache.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention/kernel.py
// (decode_attention_kernel / _decode_kernel): GQA rows grouped per
// (batch, kv head), ragged valid lengths, an f32 online softmax, blocks
// past the length skipped.
//
// What bounds it on an H100: bytes.  Every valid K and V row of the cache is
// read once and the arithmetic is two dot products per row and query head,
// far below the card's 295 operations per byte.  The design therefore
//   * reads each (batch, kv head)'s K/V once for all g = Hq/Hkv query heads
//     (the g heads are the rows of one block),
//   * splits each sequence across blocks (flash-decoding): at the llama3-8b
//     decode shape only B*Hkv = 32 (batch, kv head) pairs exist, too few for
//     132 SMs, so each pair is cut into short chunks whose partial
//     (m, l, acc) a second small kernel combines; a block whose chunk starts
//     past the length exits at once, so ragged lengths balance over the SMs,
//   * never reads a cache row at or past a sequence's length: the split
//     kernel stops at the length and the combine pass ignores splits that
//     start past it, so a row of length 0 gives 0.
// Keys move through shared memory in 16-byte vector loads; the dot products
// and the softmax run on the CUDA cores in f32.
#include "attention_simt.cuh"

namespace repro_torch {

constexpr int kMaxGroup = 8;   // query heads per kv head handled by one block
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> struct DecodeTile;
template <> struct DecodeTile<__nv_bfloat16> { static constexpr int TK = 64; };
template <> struct DecodeTile<float> { static constexpr int TK = 32; };

// grid (n_split, B*Hkv), D threads.  Writes unnormalised partials for every
// split that starts before the sequence's length.
template <typename T, int D>
__global__ void __launch_bounds__(D) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int Hq, int Hkv, int Smax, int g, int chunk,
    float qscale) {
  constexpr int TK = DecodeTile<T>::TK;
  __shared__ SimtSmem<T, D, kMaxGroup, TK> sm;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int bh = blockIdx.y, b = bh / Hkv, h = bh % Hkv;
  const int tid = threadIdx.x;
  const int len = min(max(lengths[b], 0), Smax);
  const int begin = split * chunk;
  const int end = min(begin + chunk, len);
  if (begin >= end) return;

  for (int i = tid; i < g * D; i += D) {
    const int r = i / D, d = i % D;
    sm.q[r][d] = to_f32(q[((long)b * Hq + h * g + r) * D + d]) * qscale;
  }
  if (tid < kMaxGroup) {
    sm.m[tid] = -INFINITY;
    sm.l[tid] = 0.f;
    sm.row_end[tid] = end;
  }
  __syncthreads();

  float acc[kMaxGroup];
#pragma unroll
  for (int r = 0; r < kMaxGroup; ++r) acc[r] = 0.f;
  const long base = ((long)b * Smax * Hkv + h) * D;
  simt_attend<T, D, kMaxGroup, TK>(sm, k + base, v + base, (long)Hkv * D, begin, end, g, acc);

  const long slot = (long)bh * n_split + split;
#pragma unroll
  for (int r = 0; r < kMaxGroup; ++r)
    if (r < g) part_acc[(slot * g + r) * D + tid] = acc[r];
  if (tid < g) {
    part_ml[(slot * g + tid) * 2] = sm.m[tid];
    part_ml[(slot * g + tid) * 2 + 1] = sm.l[tid];
  }
}

// grid (B*Hkv), D threads: merge the splits that saw keys.
template <typename T, int D>
__global__ void __launch_bounds__(D) decode_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ lengths, T* __restrict__ out, int Hq, int Hkv, int Smax,
    int g, int chunk, int n_split) {
  const int bh = blockIdx.x, b = bh / Hkv, h = bh % Hkv;
  const int d = threadIdx.x;
  const int len = min(max(lengths[b], 0), Smax);
  const int n_seen = (len + chunk - 1) / chunk;
  for (int r = 0; r < g; ++r) {
    float M = -INFINITY;
    for (int s = 0; s < n_seen; ++s)
      M = fmaxf(M, part_ml[(((long)bh * n_split + s) * g + r) * 2]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < n_seen; ++s) {
      const long slot = ((long)bh * n_split + s) * g + r;
      const float w = exp2f(part_ml[slot * 2] - M);
      L = fmaf(w, part_ml[slot * 2 + 1], L);
      A = fmaf(w, part_acc[slot * D + d], A);
    }
    out[((long)b * Hq + h * g + r) * D + d] = from_f32<T>(L > 0.f ? A / L : 0.f);
  }
}

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
                  float* part_acc, float* part_ml, int B, int Hq, int Hkv, int Smax, int n_split,
                  int chunk, float scale, cudaStream_t stream) {
  const int g = Hq / Hkv;
  decode_split_kernel<T, D><<<dim3(n_split, B * Hkv), D, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      part_acc, part_ml, Hq, Hkv, Smax, g, chunk, scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T, D><<<B * Hkv, D, 0, stream>>>(
      part_acc, part_ml, lengths, static_cast<T*>(out), Hq, Hkv, Smax, g, chunk, n_split);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// q (B, Hq, D); k, v (B, Smax, Hkv, D); lengths (B,) int32; out (B, Hq, D);
// all contiguous, on one device; D = 128 (llama3-8b's heads).  part_acc
// holds B*Hkv*n_split*g*D floats, part_ml B*Hkv*n_split*g*2.  dtype:
// 0 = bfloat16, 1 = float32.  Returns a cudaError_t; a shape the kernel does
// not take returns -1.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const int* lengths, void* out, float* part_acc,
                                       float* part_ml, int B, int Hq, int Hkv, int Smax, int D,
                                       int dtype, int n_split, int chunk, float scale,
                                       void* stream) {
  using namespace repro_torch;
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxGroup) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DECODE(T, DD) \
  return launch<T, DD>(q, k, v, lengths, out, part_acc, part_ml, B, Hq, Hkv, Smax, n_split, chunk, scale, s)
  if (dtype == 0 && D == 128) REPRO_DECODE(__nv_bfloat16, 128);
  if (dtype == 1 && D == 128) REPRO_DECODE(float, 128);
#undef REPRO_DECODE
  return -1;
}
