// Decode attention: one new query token per sequence against its KV cache.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention/kernel.py
// (decode_attention_kernel / _decode_kernel): GQA rows grouped per
// (batch, kv head), ragged valid lengths, an f32 online softmax, blocks
// past the length skipped.
//
// What bounds it on an H100: bytes.  Every valid K and V row of the cache is
// read once and the arithmetic is two dot products per row and query head,
// far below the card's 295 operations per byte.  So the kernel is built to
// keep device memory busy with the valid rows and nothing else.
//
// bfloat16 (the decode tenant's path):
//   * An even split decided on the device.  The valid 32-key tiles of all
//     (batch, kv head) pairs, pair after pair, are numbered 0 .. T - 1 and
//     block i of n takes [i T / n, (i + 1) T / n): whole tiles, shares that
//     differ by at most one, whatever the lengths (the spec is
//     kernels/decode_attention/ops.py: work_ranges).  A share that runs from
//     one pair into the next writes one partial (m, l, acc) per pair, to
//     workspace slot i + p; a second kernel merges each pair's partials, a
//     block per (pair, query head), weights first, then the accumulators
//     with independent loads.
//     The grid is one wave of a few small blocks per SM, so that a block of
//     the decode tenant gets an SM as soon as any block of another tenant
//     leaves it.
//   * An asynchronous ring.  One producer warp copies each valid K and V
//     row (256 bytes) with cp.async.bulk into a ring of kStages tiles; rows
//     at or past a length are never copied.  A stage completes on its
//     "full" mbarrier by the bytes it expects, and the consumer warp hands
//     it back on its "empty" mbarrier.  Rows are 272 bytes apart in shared
//     memory, so the eight rows one ldmatrix reads fall in distinct banks.
//     (Whole tiles as one TMA box each, rows 256 bytes apart, measured 12%
//     slower on an H100 80GB HBM3 at 700 W.)  4 blocks of 51 KB fit on an SM.
//   * Tensor-core products with the roles swapped: the g <= 8 query heads of
//     a kv head are the N = 8 side of mma.sync m16n8k16.  S^T (32 keys x 8)
//     = K Q^T takes K from shared memory by ldmatrix and Q^T from registers
//     (loaded once per pair); O^T (128 x 8) += V^T P^T takes V by
//     ldmatrix.trans and P^T from S^T's accumulator, transposed in registers
//     by movmatrix.  The softmax runs in f32 in the log2 domain; a key's
//     score lives in one thread, a head's running max and sum in the four
//     lanes that share lane % 4.  Keys at or past the length are masked to
//     -inf and their V entries taken as 0 (the stage may hold another row's
//     data there), so a row of length 0, whose pairs have no tile, gives 0.
//
// float32 takes the CUDA cores (the tensor cores would round to TF32):
// each sequence is cut into chunks of 8 tiles of 32 keys, a block per chunk
// over the shared SIMT tile routine, chunks past the length exit at once,
// and a combine pass merges them.
#include "attention_simt.cuh"
#include "mbarrier.cuh"

namespace repro_torch {

constexpr int kMaxGroup = 8;   // query heads per kv head
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bfloat16: bulk-copy ring, mma.sync
// ---------------------------------------------------------------------------

constexpr int kD = 128;                          // head size
constexpr int kTK = 32;                          // keys per tile
constexpr int kStages = 3;                       // ring depth
constexpr int kRowBytes = kD * 2;                // one K or V row in device memory
constexpr int kRowPitch = kRowBytes + 16;        // ... and in shared memory
constexpr int kTileBytes = kTK * kRowPitch;
constexpr int kStageBytes = 2 * kTileBytes;      // K tile, then V tile
constexpr int kBarOffset = kStages * kStageBytes;
constexpr int kSmemBytes = kBarOffset + 8 * 2 * kStages;
constexpr int kThreads = 64;                     // warp 0 produces, warp 1 consumes
// The combine pass is launched as a programmatic dependent of the split
// kernel: its blocks start while the split runs and wait for it at
// griddepcontrol.wait, so that its launch and prologue overlap the split.
constexpr bool kDependentLaunch = true;

__device__ __forceinline__ int valid_len(const int* lengths, int b, int Smax) {
  return min(max(lengths[b], 0), Smax);
}

// Where the walk over the valid tiles stands: pair (b, h), tile j of the
// pair's ntiles, the pair's length.
struct TileWalk {
  int b, h, j, ntiles, len;
};

// The walk positioned at global tile t (t < the number of valid tiles).
__device__ __forceinline__ TileWalk walk_to(const int* lengths, int Hkv, int Smax, long t) {
  TileWalk w{0, 0, 0, 0, 0};
  for (long acc = 0;; ++w.b) {
    w.len = valid_len(lengths, w.b, Smax);
    w.ntiles = (w.len + kTK - 1) / kTK;
    const long pair_tiles = (long)Hkv * w.ntiles;
    if (t < acc + pair_tiles) {
      w.h = (int)((t - acc) / w.ntiles);
      w.j = (int)((t - acc) % w.ntiles);
      return w;
    }
    acc += pair_tiles;
  }
}

// The next tile; only called while one remains.
__device__ __forceinline__ void walk_next(TileWalk& w, const int* lengths, int Hkv, int Smax) {
  if (++w.j < w.ntiles) return;
  w.j = 0;
  if (++w.h < Hkv) return;
  w.h = 0;
  do {
    ++w.b;
    w.len = valid_len(lengths, w.b, Smax);
    w.ntiles = (w.len + kTK - 1) / kTK;
  } while (w.ntiles == 0);
}

// Valid tiles of all pairs, and the tiles before batch b.
__device__ __forceinline__ long count_tiles(const int* lengths, int B, int Hkv, int Smax, int b_end) {
  long n = 0;
  for (int b = 0; b < b_end && b < B; ++b) n += (long)Hkv * ((valid_len(lengths, b, Smax) + kTK - 1) / kTK);
  return n;
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += A (16 x 16, row) B (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 8 x 8 b16 matrix whose row lane / 4 holds columns 2 (lane % 4), + 1
// in ``x``, transposed.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// grid n_blocks, 64 threads, kSmemBytes of dynamic shared memory.
// q (B, Hq, D), k/v (B, Smax, Hkv, D).  Writes the partial of every segment
// of its share to slot blockIdx.x + pair.
__global__ void __launch_bounds__(kThreads) decode_split_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int B, int Hq, int Hkv, int Smax,
    int g, float qk_scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t full = base + kBarOffset, empty = full + 8 * kStages;
  const int lane = threadIdx.x % 32;

  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");   // the combine may start
  const long total = count_tiles(lengths, B, Hkv, Smax, B);
  const int i = blockIdx.x, n_blocks = gridDim.x;
  const long t_begin = i * total / n_blocks, t_end = (i + 1) * total / n_blocks;
  if (t_begin >= t_end) return;
  const int n_it = (int)(t_end - t_begin);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  TileWalk w = walk_to(lengths, Hkv, Smax, t_begin);

  if (threadIdx.x < 32) {
    // producer: lane r copies row r of the K tile and of the V tile
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kStages;
      const int nvalid = min(kTK, w.len - w.j * kTK);
      const uint32_t k_dst = base + s * kStageBytes, v_dst = k_dst + kTileBytes;
      mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);   // the first round passes
      if (lane == 0) mbar_expect_tx(full + 8 * s, 2 * nvalid * kRowBytes);
      __syncwarp();
      if (lane < nvalid) {
        const long row = ((long)w.b * Smax + w.j * kTK + lane) * Hkv + w.h;
        bulk_load(k_dst + lane * kRowPitch, k + row * kD, kRowBytes, full + 8 * s);
        bulk_load(v_dst + lane * kRowPitch, v + row * kD, kRowBytes, full + 8 * s);
      }
      if (it + 1 < n_it) walk_next(w, lengths, Hkv, Smax);
    }
    return;
  }

  // consumer warp.  Thread roles in the m16n8 fragments: rows (keys, or d)
  // lane / 4 and lane / 4 + 8 of each 16-row block, columns (query heads)
  // 2 c and 2 c + 1 with c = lane % 4.
  const int c = lane % 4, r8 = lane / 4;
  float acc[8][4];            // O^T: d = 16 m + r8 (+ 8), heads 2 c (+ 1)
  float m_run[2], l_run[2];   // heads 2 c and 2 c + 1
  uint32_t qf[8][2];          // Q^T as B fragments: k-step kk, head r8
  int seg_b = -1, seg_h = -1;

  // one pair's partial: slot i + p
  auto flush = [&]() {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l = l_run[hh];
      l += __shfl_xor_sync(0xffffffffu, l, 4);
      l += __shfl_xor_sync(0xffffffffu, l, 8);
      l += __shfl_xor_sync(0xffffffffu, l, 16);
      const int n = 2 * c + hh;
      if (n < g) {
        const long slot = (long)i + (long)seg_b * Hkv + seg_h;
        float* pa = part_acc + (slot * g + n) * kD;
#pragma unroll
        for (int mb = 0; mb < 8; ++mb) {
          pa[16 * mb + r8] = acc[mb][hh];
          pa[16 * mb + r8 + 8] = acc[mb][hh + 2];
        }
        if (r8 == 0) {
          part_ml[(slot * g + n) * 2] = m_run[hh];
          part_ml[(slot * g + n) * 2 + 1] = l;
        }
      }
    }
  };

  for (int it = 0; it < n_it; ++it) {
    if (w.b != seg_b || w.h != seg_h) {   // a new segment: a new pair
      if (seg_b >= 0) flush();
      seg_b = w.b;
      seg_h = w.h;
#pragma unroll
      for (int mb = 0; mb < 8; ++mb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mb][e] = 0.f;
      m_run[0] = m_run[1] = -INFINITY;
      l_run[0] = l_run[1] = 0.f;
      const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
          q + ((long)w.b * Hq + (long)w.h * g + r8) * kD);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        qf[kk][0] = r8 < g ? __ldg(qrow + 8 * kk + c) : 0u;
        qf[kk][1] = r8 < g ? __ldg(qrow + 8 * kk + 4 + c) : 0u;
      }
    }
    const int s = it % kStages;
    const uint32_t k_tile = base + s * kStageBytes, v_tile = k_tile + kTileBytes;
    const int k0 = w.j * kTK;
    const int nvalid = min(kTK, w.len - k0);
    mbar_wait(full + 8 * s, (it / kStages) & 1);

    // S^T = K Q^T: two 16-key blocks, eight 16-column steps of D
    float sc[2][4];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[mb][e] = 0.f;
    // ldmatrix x4 of A: lane l gives row (l % 8) + 8 ((l / 8) % 2), column chunk l / 16
    const uint32_t k_lane = k_tile + ((lane % 8) + 8 * ((lane / 8) % 2)) * kRowPitch + (lane / 16) * 16;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        uint32_t a[4];
        ldsm_x4(a, k_lane + 16 * mb * kRowPitch + kk * 32);
        mma_16816(sc[mb], a, qf[kk][0], qf[kk][1]);
      }
    }

    // online softmax over this tile's keys, per head
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int e = hh; e < 4; e += 2) {
          const int key = 16 * mb + r8 + (e >= 2 ? 8 : 0);
          float x = sc[mb][e] * qk_scale_log2;
          x = key < nvalid ? x : -INFINITY;
          sc[mb][e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float m_new = fmaxf(m_run[hh], mx);
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;   // row still fully masked
      alpha[hh] = fast_exp2(m_run[hh] - m_use);
      m_run[hh] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int e = hh; e < 4; e += 2) {
          sc[mb][e] = fast_exp2(sc[mb][e] - m_use);
          sum += sc[mb][e];
        }
      l_run[hh] = l_run[hh] * alpha[hh] + sum;
    }
#pragma unroll
    for (int mb = 0; mb < 8; ++mb) {
      acc[mb][0] *= alpha[0];
      acc[mb][1] *= alpha[1];
      acc[mb][2] *= alpha[0];
      acc[mb][3] *= alpha[1];
    }

    // P^T as B fragments: 16-key step ks is S^T block ks, transposed
    uint32_t pb[2][2];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      pb[ks][0] = movmatrix_trans(pack_bf16x2(sc[ks][0], sc[ks][1]));
      pb[ks][1] = movmatrix_trans(pack_bf16x2(sc[ks][2], sc[ks][3]));
    }

    // O^T += V^T P^T: eight 16-row blocks of D, two 16-key steps.  ldmatrix
    // x4 trans of A: lane l gives key row (l % 8) + 8 (l / 16), d chunk (l / 8) % 2.
    const uint32_t v_lane = v_tile + ((lane % 8) + 8 * (lane / 16)) * kRowPitch + ((lane / 8) % 2) * 16;
    const bool partial = nvalid < kTK;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int mb = 0; mb < 8; ++mb) {
        uint32_t a[4];
        ldsm_x4_trans(a, v_lane + 16 * ks * kRowPitch + mb * 32);
        if (partial) {   // keys past the length: the stage holds stale rows there
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = 16 * ks + 8 * (e / 2) + 2 * c;
            a[e] &= (key < nvalid ? 0x0000ffffu : 0u) | (key + 1 < nvalid ? 0xffff0000u : 0u);
          }
        }
        mma_16816(acc[mb], a, pb[ks][0], pb[ks][1]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);   // the stage goes back to the producer
    if (it + 1 < n_it) walk_next(w, lengths, Hkv, Smax);
  }
  flush();
}

__device__ __forceinline__ float block_reduce(float x, float* scratch, bool is_max) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  const int warp = threadIdx.x / 32;
  __syncthreads();   // scratch may still be read from an earlier call
  if (threadIdx.x % 32 == 0) scratch[warp] = x;
  __syncthreads();
  x = scratch[0];
  for (int w = 1; w < kD / 32; ++w) x = is_max ? fmaxf(x, scratch[w]) : x + scratch[w];
  return x;
}

// grid (B*Hkv, g), D threads, 4 * n_blocks bytes of dynamic shared memory:
// query head r of pair p merges the partials of the blocks that saw the
// pair's keys.  The threads first take one partial each (its weight
// 2^(m - M) into shared memory), then sum the weighted accumulators of all
// partials, column d by thread d, with independent loads.
__global__ void __launch_bounds__(kD) decode_combine_bf16_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out, int B, int Hq, int Hkv,
    int Smax, int g, int n_blocks) {
  extern __shared__ float wgt[];
  __shared__ float scratch[kD / 32];
  const int p = blockIdx.x, r = blockIdx.y, b = p / Hkv, h = p % Hkv;
  const int d = threadIdx.x;
  const int ntiles = (valid_len(lengths, b, Smax) + kTK - 1) / kTK;
  __nv_bfloat16* ob = out + ((long)b * Hq + (long)h * g + r) * kD + d;
  if (ntiles == 0) {   // length 0: no block saw a key
    *ob = __float2bfloat16(0.f);
    return;
  }
  const long total = count_tiles(lengths, B, Hkv, Smax, B);
  const long first = count_tiles(lengths, B, Hkv, Smax, b) + (long)h * ntiles;
  const long last = first + ntiles - 1;
  // the block whose share holds tile t: ops.py: block_of
  const long i_lo = ((first + 1) * n_blocks - 1) / total;
  const long i_hi = ((last + 1) * n_blocks - 1) / total;
  // a block of an empty share (more blocks than tiles) wrote nothing
  auto empty_share = [&](long i) { return i * total / n_blocks == (i + 1) * total / n_blocks; };
  asm volatile("griddepcontrol.wait;\n" ::: "memory");   // the split kernel's partials are written

  float m = -INFINITY;
  for (long i = i_lo + d; i <= i_hi; i += kD)
    if (!empty_share(i)) m = fmaxf(m, part_ml[((i + p) * g + r) * 2]);
  const float M = block_reduce(m, scratch, true);
  float l = 0.f;
  for (long i = i_lo + d; i <= i_hi; i += kD) {
    float w = 0.f;
    if (!empty_share(i)) {
      const long slot = (i + p) * g + r;
      w = exp2f(part_ml[slot * 2] - M);
      l = fmaf(w, part_ml[slot * 2 + 1], l);
    }
    wgt[i - i_lo] = w;
  }
  const float L = block_reduce(l, scratch, false);   // its barriers publish wgt
  float A = 0.f;
#pragma unroll 4
  for (long i = i_lo; i <= i_hi; ++i) {
    const float w = wgt[i - i_lo];
    if (w != 0.f) A = fmaf(w, part_acc[((i + p) * g + r) * kD + d], A);
  }
  *ob = __float2bfloat16(L > 0.f ? A / L : 0.f);
}

static int launch_bf16(const void* q, const void* k, const void* v, const int* lengths, void* out,
                       float* part_acc, float* part_ml, int B, int Hq, int Hkv, int Smax,
                       int n_blocks, float scale, cudaStream_t stream) {
  const int g = Hq / Hkv;
  cudaError_t err = cudaFuncSetAttribute(decode_split_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  decode_split_bf16_kernel<<<n_blocks, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lengths, part_acc, part_ml, B, Hq, Hkv, Smax, g,
      scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * Hkv, g);
  cfg.blockDim = dim3(kD);
  cfg.dynamicSmemBytes = 4 * n_blocks;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = kDependentLaunch ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, decode_combine_bf16_kernel, (const float*)part_acc,
                                 (const float*)part_ml, lengths,
                                 static_cast<__nv_bfloat16*>(out), B, Hq, Hkv, Smax, g, n_blocks);
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kTKf32 = 32;

// grid (n_split, B*Hkv), D threads.  Writes unnormalised partials for every
// split that starts before the sequence's length.
template <int D>
__global__ void __launch_bounds__(D) decode_split_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ lengths, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int Hq, int Hkv, int Smax, int g, int chunk,
    float qscale) {
  __shared__ SimtSmem<float, D, kMaxGroup, kTKf32> sm;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int bh = blockIdx.y, b = bh / Hkv, h = bh % Hkv;
  const int tid = threadIdx.x;
  const int len = min(max(lengths[b], 0), Smax);
  const int begin = split * chunk;
  const int end = min(begin + chunk, len);
  if (begin >= end) return;

  for (int i = tid; i < g * D; i += D) {
    const int r = i / D, d = i % D;
    sm.q[r][d] = q[((long)b * Hq + h * g + r) * D + d] * qscale;
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
  simt_attend<float, D, kMaxGroup, kTKf32>(sm, k + base, v + base, (long)Hkv * D, begin, end, g,
                                           acc);

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
template <int D>
__global__ void __launch_bounds__(D) decode_combine_f32_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ lengths, float* __restrict__ out, int Hq, int Hkv, int Smax,
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
    out[((long)b * Hq + h * g + r) * D + d] = L > 0.f ? A / L : 0.f;
  }
}

template <int D>
static int launch_f32(const void* q, const void* k, const void* v, const int* lengths, void* out,
                      float* part_acc, float* part_ml, int B, int Hq, int Hkv, int Smax,
                      int n_split, int chunk, float scale, cudaStream_t stream) {
  const int g = Hq / Hkv;
  decode_split_f32_kernel<D><<<dim3(n_split, B * Hkv), D, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      lengths, part_acc, part_ml, Hq, Hkv, Smax, g, chunk, scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_f32_kernel<D><<<B * Hkv, D, 0, stream>>>(
      part_acc, part_ml, lengths, static_cast<float*>(out), Hq, Hkv, Smax, g, chunk, n_split);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// q (B, Hq, D); k, v (B, Smax, Hkv, D); lengths (B,) int32; out (B, Hq, D);
// all contiguous, on one device, q, k and v on 16-byte boundaries; D = 128
// (llama3-8b's heads).  dtype 0 = bfloat16: n_split is the split kernel's
// grid and chunk is ignored; part_acc holds (n_split + B*Hkv)*g*D floats,
// part_ml (n_split + B*Hkv)*g*2.  dtype 1 = float32: n_split chunks of
// ``chunk`` keys per sequence; part_acc holds B*Hkv*n_split*g*D floats,
// part_ml B*Hkv*n_split*g*2.  Returns a cudaError_t; a shape the kernel does
// not take returns -1.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const int* lengths, void* out, float* part_acc,
                                       float* part_ml, int B, int Hq, int Hkv, int Smax, int D,
                                       int dtype, int n_split, int chunk, float scale,
                                       void* stream) {
  using namespace repro_torch;
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxGroup || n_split <= 0 ||
      (dtype == 0 && n_split > 8192))   // the bf16 combine keeps a weight a block
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == kD)
    return launch_bf16(q, k, v, lengths, out, part_acc, part_ml, B, Hq, Hkv, Smax, n_split,
                       scale, s);
  if (dtype == 1 && D == 128)
    return launch_f32<128>(q, k, v, lengths, out, part_acc, part_ml, B, Hq, Hkv, Smax, n_split,
                           chunk, scale, s);
  return -1;
}
