// Online-softmax attention of a few query rows over a run of keys, on the
// CUDA cores (no tensor cores).  Shared by the decode kernel (the g query
// heads of one kv head) and the float32 flash kernel (a few consecutive
// query positions of one head).
//
// One block of D threads.  Keys stream through shared memory TK rows at a
// time; each row r of the block has its own key limit row_end[r] (the
// sequence length for decode, the causal limit for prefill), so keys at or
// past a row's limit never contribute.  Keys at or past kv_end are never
// read from device memory.  Scores are kept in the log2 domain: the caller
// pre-scales q by softmax_scale * log2(e).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_torch {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory of one block.  K/V rows are padded by 16 bytes so that the
// 16-byte reads of neighbouring rows by neighbouring threads hit distinct
// banks.
template <typename T, int D, int R, int TK>
struct __align__(16) SimtSmem {
  static constexpr int PAD = 16 / sizeof(T);
  float q[R][D];
  T k[TK][D + PAD];
  T v[TK][D + PAD];
  float s[R][TK];
  float m[R];       // running max (log2 domain)
  float l[R];       // running denominator
  float alpha[R];   // rescale factor of the current tile
  int row_end[R];   // keys [0, row_end[r]) are visible to row r
};

template <typename T, int N>
__device__ __forceinline__ void unpack16(const uint4& raw, float (&out)[N]);

template <>
__device__ __forceinline__ void unpack16<float, 4>(const uint4& raw, float (&out)[4]) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}

template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16, 8>(const uint4& raw, float (&out)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Attend rows [0, nrows) to keys [kv_begin, kv_end).  Key s of this head
// lives at kbase + s * kv_stride (likewise V).  The caller has filled
// sm.q, sm.row_end, sm.m = -inf and sm.l = 0, zeroed acc and synchronised.
// On return acc[r] holds column threadIdx.x of row r's unnormalised output
// and sm.m / sm.l the row statistics.
template <typename T, int D, int R, int TK>
__device__ void simt_attend(SimtSmem<T, D, R, TK>& sm, const T* __restrict__ kbase,
                            const T* __restrict__ vbase, long kv_stride, int kv_begin,
                            int kv_end, int nrows, float (&acc)[R]) {
  constexpr int NT = D;                 // threads in the block
  constexpr int VEC = 16 / sizeof(T);   // elements in 16 bytes
  constexpr int CHUNKS = D / VEC;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  for (int t0 = kv_begin; t0 < kv_end; t0 += TK) {
    const int nvalid = min(TK, kv_end - t0);
    for (int i = tid; i < nvalid * CHUNKS; i += NT) {
      const int row = i / CHUNKS, c = i % CHUNKS;
      const long off = (long)(t0 + row) * kv_stride + c * VEC;
      *reinterpret_cast<uint4*>(&sm.k[row][c * VEC]) = *reinterpret_cast<const uint4*>(kbase + off);
      *reinterpret_cast<uint4*>(&sm.v[row][c * VEC]) = *reinterpret_cast<const uint4*>(vbase + off);
    }
    __syncthreads();

    for (int i = tid; i < nrows * TK; i += NT) {
      const int r = i / TK, j = i % TK;
      float s = -INFINITY;
      if (j < nvalid && t0 + j < sm.row_end[r]) {
        s = 0.f;
#pragma unroll 4
        for (int c = 0; c < CHUNKS; ++c) {
          float kv[VEC];
          unpack16<T, VEC>(*reinterpret_cast<const uint4*>(&sm.k[j][c * VEC]), kv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) s = fmaf(sm.q[r][c * VEC + e], kv[e], s);
        }
      }
      sm.s[r][j] = s;
    }
    __syncthreads();

    for (int r = warp; r < nrows; r += NT / 32) {
      float mx = -INFINITY;
      for (int j = lane; j < TK; j += 32) mx = fmaxf(mx, sm.s[r][j]);
      mx = warp_max(mx);
      const float m_old = sm.m[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;   // row still fully masked
      float sum = 0.f;
      for (int j = lane; j < TK; j += 32) {
        const float p = exp2f(sm.s[r][j] - m_use);
        sm.s[r][j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = exp2f(m_old - m_use);
        sm.alpha[r] = a;
        sm.l[r] = sm.l[r] * a + sum;
        sm.m[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < nrows) acc[r] *= sm.alpha[r];
    for (int j = 0; j < nvalid; ++j) {
      const float vj = to_f32(sm.v[j][tid]);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < nrows) acc[r] = fmaf(sm.s[r][j], vj, acc[r]);
    }
    __syncthreads();   // the next tile overwrites k, v and s
  }
}

}  // namespace repro_torch
