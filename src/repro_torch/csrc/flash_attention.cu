// Flash attention, forward: blocked online-softmax attention for prefill.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (flash_attention_kernel / _flash_kernel): GQA with the kv head taken as
// q head // group, right-aligned causal masking (q_offset = Skv - Sq), kv
// padding masked, blocks above the diagonal skipped, f32 running max /
// denominator / accumulator, rows with no visible key give 0.
//
// What bounds it on an H100: operations.  At the llama3-8b prefill shape
// (8192 tokens, 32 heads of 128) it does about 0.55 TFLOP per layer and
// reads about 40 MB, hundreds of operations per byte.  The design keeps the
// work on the tensor cores and the scores out of device memory:
//   * one block of 4 warps per (batch * q head, 64-row q tile); each warp
//     owns 16 q rows, held in registers as mma A fragments;
//   * K and V move through shared memory 64 rows at a time (rows padded by
//     16 bytes so ldmatrix reads are free of bank conflicts);
//   * S = Q K^T and O += P V run as mma.sync m16n8k16 bf16 products with f32
//     accumulation; the softmax stays in registers (log2 domain);
//   * kv tiles wholly above the diagonal are never loaded, and the q tiles
//     with the most work are scheduled first.
// This is the simple form: one shared-memory stage and mma.sync.  Three
// blocks share an SM (52 KB of shared memory and 168 registers a thread
// each), so one block's loads overlap the others' products; a two-stage
// cp.async ring measured no faster, since it leaves room for two.  wgmma,
// TMA and warp specialisation are later work.
//
// float32 inputs take a CUDA-core path (the tensor cores would round them
// to TF32): the same online softmax over the shared SIMT tile routine, a
// few q rows per block.
#include "attention_simt.cuh"

namespace repro_torch {

constexpr float kLog2eF = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // kv rows per tile
constexpr int kThreads = 128;  // 4 warps x 16 q rows

template <int D>
constexpr int flash_smem_bytes() {
  return 3 * kBQ * (D + 8) * 2;   // Q, K, V tiles
}

// Copy rows [r0, r0 + 64) of one head into a padded shared tile; rows at or
// past n_rows are zero (they reach the mma, and 0 * garbage could be NaN).
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long row_stride, int r0, int n_rows) {
  constexpr int LD = D + 8, CH = D / 8;
  for (int i = threadIdx.x; i < kBQ * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n_rows) val = *reinterpret_cast<const uint4*>(src + (long)(r0 + r) * row_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

// grid (ceil(Sq/64), B*Hq), 128 threads; q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D).
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Sq, int Skv,
    int Hq, int Hkv, int causal, int q_offset, float qk_scale_log2) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBQ * LD;
  __nv_bfloat16* sV = sK + kBK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;   // most work first
  const int bh = blockIdx.y, b = bh / Hq, hq = bh % Hq;
  const int hk = hq / (Hq / Hkv);
  const long q_stride = (long)Hq * D, kv_stride = (long)Hkv * D;
  const __nv_bfloat16* qb = q + ((long)b * Sq * Hq + hq) * D;
  const __nv_bfloat16* kb = k + ((long)b * Skv * Hkv + hk) * D;
  const __nv_bfloat16* vb = v + ((long)b * Skv * Hkv + hk) * D;
  __nv_bfloat16* ob = o + ((long)b * Sq * Hq + hq) * D;
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // keys visible to the block's last row: kv tiles past it are above the diagonal
  const int kv_end = causal ? min(Skv, q0 + kBQ + q_offset) : Skv;
  const int n_kt = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;
  const int warp_row0 = q0 + warp * 16 + q_offset;   // global position of the warp's first row

  load_tile<D>(sQ, qb, q_stride, q0, Sq);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane % 16)) * LD + kk * 16 + (lane / 16) * 8);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};   // rows lane/4 and lane/4 + 8 of the warp
  float l_run[2] = {0.f, 0.f};               // this thread's share of the row sums

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // every warp is done with the previous K/V tile
    load_tile<D>(sK, kb, kv_stride, k0, Skv);
    load_tile<D>(sV, vb, kv_stride, k0, Skv);
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < kBK / 16; ++n2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, sK + (n2 * 16 + (lane / 16) * 8 + (lane % 8)) * LD + kk * 16 +
                            ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * n2], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * n2 + 1], qf[kk], kf[2], kf[3]);
      }
    }

    const bool masked = (k0 + kBK > Skv) || (causal && k0 + kBK - 1 > warp_row0);
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * qk_scale_log2;
        if (masked) {
          const int col = k0 + n * 8 + (lane % 4) * 2 + (e & 1);
          const int row = warp_row0 + lane / 4 + (e >= 2 ? 8 : 0);
          if (col >= Skv || (causal && col > row)) x = -INFINITY;
        }
        s[n][e] = x;
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;   // row still fully masked
      const float alpha = exp2f(m_run[h] - m_use);
      m_run[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        s[n][2 * h] = exp2f(s[n][2 * h] - m_use);
        s[n][2 * h + 1] = exp2f(s[n][2 * h + 1] - m_use);
        sum += s[n][2 * h] + s[n][2 * h + 1];
      }
      l_run[h] = l_run[h] * alpha + sum;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * h] *= alpha;
        acc[n][2 * h + 1] *= alpha;
      }
    }

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, sV + (kk * 16 + ((lane / 8) % 2) * 8 + (lane % 8)) * LD + n2 * 16 +
                                  (lane / 16) * 8);
        mma_bf16(acc[2 * n2], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * n2 + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const int row = q0 + warp * 16 + lane / 4 + 8 * h;
    if (row < Sq) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = n * 8 + (lane % 4) * 2;
        *reinterpret_cast<__nv_bfloat162*>(ob + (long)row * q_stride + col) =
            __floats2bfloat162_rn(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
      }
    }
  }
}

// float32 path: grid (ceil(Sq/R), B*Hq), D threads, R consecutive q rows per block.
template <typename T, int D>
__global__ void __launch_bounds__(D) flash_fwd_simt_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
    int Sq, int Skv, int Hq, int Hkv, int causal, int q_offset, float qk_scale_log2) {
  constexpr int R = 8, TK = 32;
  __shared__ SimtSmem<T, D, R, TK> sm;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / Hq, hq = bh % Hq;
  const int hk = hq / (Hq / Hkv);
  const long q_stride = (long)Hq * D, kv_stride = (long)Hkv * D;
  const int q0 = qt * R, nrows = min(R, Sq - q0);
  const int tid = threadIdx.x;

  for (int r = 0; r < nrows; ++r)
    sm.q[r][tid] = to_f32(q[((long)b * Sq + q0 + r) * q_stride + (long)hq * D + tid]) * qk_scale_log2;
  if (tid < R) {
    sm.m[tid] = -INFINITY;
    sm.l[tid] = 0.f;
    sm.row_end[tid] = causal ? min(max(q0 + tid + q_offset + 1, 0), Skv) : Skv;
  }
  __syncthreads();
  const int kv_end = causal ? min(max(q0 + nrows + q_offset, 0), Skv) : Skv;

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  const long base = ((long)b * Skv * Hkv + hk) * D;
  simt_attend<T, D, R, TK>(sm, k + base, v + base, kv_stride, 0, kv_end, nrows, acc);

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < nrows) {
      const float l = sm.l[r];
      o[((long)b * Sq + q0 + r) * q_stride + (long)hq * D + tid] =
          from_f32<T>(l > 0.f ? acc[r] / l : 0.f);
    }
  }
}

template <int D>
static int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                       int Skv, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  constexpr int smem = flash_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ - 1) / kBQ, B * Hq);
  flash_fwd_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Skv, Hq, Hkv,
      causal, Skv - Sq, scale * kLog2eF);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                      int Skv, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  dim3 grid((Sq + 7) / 8, B * Hq);
  flash_fwd_simt_kernel<float, D><<<grid, D, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Sq, Skv, Hq, Hkv, causal, Skv - Sq, scale * kLog2eF);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D); o (B, Sq, Hq, D); contiguous, one
// device; D = 128 (llama3-8b's heads).  dtype: 0 = bfloat16 (tensor cores),
// 1 = float32 (CUDA cores).  Returns a cudaError_t; a shape the kernel does
// not take returns -1.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int Sq, int Skv, int Hq, int Hkv, int D, int dtype,
                                      int causal, float scale, void* stream) {
  using namespace repro_torch;
  if (Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 128) return launch_bf16<128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, scale, s);
  if (dtype == 1 && D == 128) return launch_f32<128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, scale, s);
  return -1;
}
