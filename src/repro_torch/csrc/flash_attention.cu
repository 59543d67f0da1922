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
// reads about 40 MB, hundreds of operations per byte, so the design is
// Hopper's: the tensor cores fed by TMA, with the scores kept on chip.
//   * One block of three warpgroups per (batch * q head, 128-row q tile).
//     Warpgroups 0 and 1 consume: each owns 64 q rows.  Warpgroup 2
//     produces: one thread issues every TMA load; setmaxnreg hands its
//     registers to the consumers (24 against 240 a thread; ptxas fits the
//     consumers in 168 all the same).
//   * Q, K and V are read by TMA through one tensor map each over their
//     (D, H, S, B) layout.  A row of 128 bf16 is 256 bytes, two 128-byte
//     swizzle spans, so each 128-row tile is two 64-column boxes.  TMA
//     fills rows past Sq / Skv with zeros (they reach the products, where
//     0 * garbage could be NaN).  Q is loaded once; K and V move through a
//     ring of kStages stages, each with "full" barriers (K and V apart, so
//     the first S = Q K^T starts before V lands) and an "empty" barrier the
//     eight consumer warps arrive on when they are done with the stage.
//   * S = Q K^T is wgmma m64n128k16 with both operands in shared memory,
//     K-major.  O += P V takes P from registers (S's f32 accumulator packed
//     to bf16 pairs in place: the accumulator's layout is the A fragment's)
//     and V from shared memory, MN-major.  O stays in registers for the
//     whole kv loop; the softmax runs in registers, in the log2 domain.
//   * The two consumer warpgroups take turns on the tensor cores (named
//     barriers 1 and 2, "ping-pong"): in its turn a warpgroup issues
//     O += P V of the previous tile, waits for it, and issues S = Q K^T of
//     the next; then it hands the turn over and runs its softmax while the
//     other's products run.  Waiting for P V before S is issued keeps P's
//     registers and S's accumulator apart: where the two were in flight
//     together, ptxas moved P through local memory and serialised every
//     wgmma.
//   * Only tiles that cross the diagonal or Skv are masked; kv tiles wholly
//     above the diagonal are never loaded, and the q tiles with the most
//     work run first (the q tile is the grid's slow axis).
//   * A barrier wait that has not completed after kWaitLimitNs traps (a
//     launch error) instead of hanging the card.
// 128 KB of the K/V ring plus 32 KB of Q leave one block per SM.
//
// float32 inputs take a CUDA-core path (the tensor cores would round them
// to TF32): the same online softmax over the shared SIMT tile routine, a
// few q rows per block.
#include <cuda.h>
#include <dlfcn.h>

#include "attention_simt.cuh"
#include "mbarrier.cuh"

namespace repro_torch {

constexpr float kLog2eF = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bfloat16: TMA, mbarriers, wgmma
// ---------------------------------------------------------------------------

constexpr int kD = 128;                       // head size
constexpr int kBQ = 128;                      // q rows per block (2 consumer warpgroups x 64)
constexpr int kBK = 128;                      // kv rows per tile
constexpr int kStages = 2;                    // K/V ring depth
constexpr int kThreads = 384;                 // 2 consumer warpgroups + 1 producer warpgroup
constexpr int kSpan = 64;                     // bf16 columns in one 128-byte swizzle span
constexpr int kQBox = kBQ * kSpan * 2;        // bytes of one 64-column box of the Q tile
constexpr int kKVBox = kBK * kSpan * 2;       // ... of a K or V tile
constexpr int kQBytes = 2 * kQBox;
constexpr int kKVBytes = 2 * kKVBox;
constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
constexpr int kSmemBytes = 1024 + kBarOffset + 8 * (1 + 3 * kStages);   // + 1024: alignment

// One box of a 4-d tensor map into shared memory; completes on ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {   // every committed product is done
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from touching accumulator registers across an async product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WG_ACC64 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63" \
  "}"
#define WG_D8(i) "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), \
                 "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define WG_D64 WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)

// d (64 x 128, f32) = (accumulate ? d : 0) + A (64 x 16) B (16 x 128); A and B
// in shared memory, both K-major.  Accumulator: thread t of the warpgroup
// holds rows 16 (t / 32) + (t % 32) / 4 (+ 8), columns 8 j + 2 (t % 4) (+ 1).
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_ACC64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D64
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d += A B; A (64 x 16, bf16) in registers as mma fragments, B (16 x 128) in
// shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_ACC64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Named barriers 1 and 2 pass the turn on the tensor cores between the two
// consumer warpgroups (barrier 0 is __syncthreads).
__device__ __forceinline__ void named_bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Online softmax of one tile of scores, in place: sc becomes P (log2
// domain, not yet normalised), m_run moves on, and alpha[h] is the factor
// that row h's accumulator and denominator take; sum[h] is this thread's
// share of the row's new terms.  Keys past Skv, and with ``causal`` keys
// after the row's position, are masked where ``masked`` says the tile
// reaches them.  Row h of the thread is the warp's row lane / 4 + 8 h,
// whose key position is row0 + lane / 4 + 8 h.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m_run)[2],
                                             float (&alpha)[2], float (&sum)[2], bool masked,
                                             int k0, int row0, int lane, int Skv, int causal,
                                             float qk_scale_log2) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    float x = sc[i] * qk_scale_log2;
    if (masked) {
      const int col = k0 + (i / 4) * 8 + (lane % 4) * 2 + (i & 1);
      const int row = row0 + lane / 4 + ((i & 2) ? 8 : 0);
      if (col >= Skv || (causal && col > row)) x = -INFINITY;
    }
    sc[i] = x;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[h], mx);
    const float m_use = (m_new == -INFINITY) ? 0.f : m_new;   // row still fully masked
    alpha[h] = fast_exp2(m_run[h] - m_use);
    m_run[h] = m_new;
    sum[h] = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      sc[4 * j + 2 * h] = fast_exp2(sc[4 * j + 2 * h] - m_use);
      sc[4 * j + 2 * h + 1] = fast_exp2(sc[4 * j + 2 * h + 1] - m_use);
      sum[h] += sc[4 * j + 2 * h] + sc[4 * j + 2 * h + 1];
    }
  }
}

// O += P V for kv tile t: waits for its V, runs the product to completion
// (P's registers are free afterwards) and releases the tile's ring stage.
__device__ __forceinline__ void pv_product(float (&acc)[64], const uint32_t (&pa)[kBK / 16][4],
                                           uint32_t base, uint32_t full_v, uint32_t empty, int t,
                                           int lane) {
  const int s = t % kStages;
  const uint32_t v_tile = base + kQBytes + s * 2 * kKVBytes + kKVBytes;
  mbar_wait(full_v + 8 * s, (t / kStages) & 1);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)   // 16 kv rows: 8-row groups 1024 bytes apart
    wgmma_rs(acc, pa[kk], smem_desc(v_tile + kk * 16 * kSpan * 2, kKVBox, 1024));
  wgmma_commit();
  wgmma_wait();
  fence_regs(acc);
  if (lane == 0) mbar_arrive(empty + 8 * s);   // this warp is done with the stage
}

// grid (B * Hq, ceil(Sq / 128)), 384 threads; q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D)
// through their tensor maps, o (B,Sq,Hq,D).
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o, int Sq, int Skv,
    int Hq, int Hkv, int causal, int q_offset, float qk_scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  // Q tile, then stage s's K tile and V tile; each tile two 64-column boxes
  // of 128-byte rows.  The swizzle repeats every 1024 bytes: align to it.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + kBarOffset;
  const uint32_t full_k = bar_q + 8, full_v = full_k + 8 * kStages, empty = full_v + 8 * kStages;

  const int bh = blockIdx.x, b = bh / Hq, hq = bh % Hq, hk = hq / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // most work first
  // keys visible to the block's last row: kv tiles past it are above the diagonal
  const int kv_end = causal ? min(Skv, q0 + kBQ + q_offset) : Skv;
  const int n_kt = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256 && n_kt > 0) {
      mbar_expect_tx(bar_q, kQBytes);
      tma_load(base, &tm_q, bar_q, 0, hq, q0, b);
      tma_load(base + kQBox, &tm_q, bar_q, kSpan, hq, q0, b);
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % kStages;
        const uint32_t k_dst = base + kQBytes + s * 2 * kKVBytes, v_dst = k_dst + kKVBytes;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);   // the first round passes
        mbar_expect_tx(full_k + 8 * s, kKVBytes);
        tma_load(k_dst, &tm_k, full_k + 8 * s, 0, hk, it * kBK, b);
        tma_load(k_dst + kKVBox, &tm_k, full_k + 8 * s, kSpan, hk, it * kBK, b);
        mbar_expect_tx(full_v + 8 * s, kKVBytes);
        tma_load(v_dst, &tm_v, full_v + 8 * s, 0, hk, it * kBK, b);
        tma_load(v_dst + kKVBox, &tm_v, full_v + 8 * s, kSpan, hk, it * kBK, b);
      }
    }
  } else {
    // consumer warpgroups: 64 q rows each, 16 per warp
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int warp_row0 = q0 + wg * 64 + warp * 16 + q_offset;   // key position of the warp's row 0
    const uint32_t q_rows = base + wg * 64 * kSpan * 2;          // this warpgroup's rows of a Q box

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};   // rows lane/4 and lane/4 + 8 of the warp
    float l_run[2] = {0.f, 0.f};               // this thread's share of the row sums
    uint32_t pa[kBK / 16][4];                  // P of the previous tile as wgmma A fragments
    if (n_kt > 0) {
      if (wg == 1) named_bar_arrive(1);   // warpgroup 0 takes the first turn
      mbar_wait(bar_q, 0);
    }

    // Tile kt.  In this warpgroup's turn on the tensor cores: O += P V of
    // the previous tile, then S = Q K of this one; the turn passes on and
    // the softmax of S runs while the other warpgroup's products do.  P V
    // is waited for before S is issued, so that P's registers are free
    // when S's accumulator is written (they are the same registers).
    int kt = 0;
    for (; kt < n_kt; ++kt) {
      const int s = kt % kStages;
      const uint32_t k_tile = base + kQBytes + s * 2 * kKVBytes;
      mbar_wait(full_k + 8 * s, (kt / kStages) & 1);
      named_bar_sync(1 + wg);
      if (kt > 0) pv_product(acc, pa, base, full_v, empty, kt - 1, lane);
      float sc[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {   // 16 columns of D: a 32-byte step in a span
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss(sc, smem_desc(q_rows + (kk / 4) * kQBox + col, 16, 1024),
                 smem_desc(k_tile + (kk / 4) * kKVBox + col, 16, 1024), kk);
      }
      wgmma_commit();
      named_bar_arrive(2 - wg);   // the other warpgroup's turn
      wgmma_wait();
      fence_regs(sc);

      const int k0 = kt * kBK;
      const bool masked = (k0 + kBK > Skv) || (causal && k0 + kBK - 1 > warp_row0);
      float alpha[2], sum[2];
      softmax_tile(sc, m_run, alpha, sum, masked, k0, warp_row0, lane, Skv, causal,
                   qk_scale_log2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l_run[h] = l_run[h] * alpha[h] + sum[h];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          acc[4 * j + 2 * h] *= alpha[h];
          acc[4 * j + 2 * h + 1] *= alpha[h];
        }
      }
      // P as the A operand: k columns 16 kk .. 16 kk + 15 are S's n-blocks 2 kk, 2 kk + 1
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        pa[kk][0] = pack_bf16x2(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    }
    if (kt > 0) {   // the last tile's P V
      if (wg == 0) named_bar_sync(1);   // takes warpgroup 1's last turn signal
      pv_product(acc, pa, base, full_v, empty, kt - 1, lane);
    }

    __nv_bfloat16* ob = o + ((long)b * Sq * Hq + hq) * kD;
    const long q_stride = (long)Hq * kD;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_run[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = l > 0.f ? 1.f / l : 0.f;
      const int row = q0 + wg * 64 + warp * 16 + lane / 4 + 8 * h;
      if (row < Sq) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<__nv_bfloat162*>(ob + row * q_stride + j * 8 + (lane % 4) * 2) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

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

using EncodeTiledFn = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled from libcuda.so.1, which the process already holds
// (the runtime API has no tensor-map call)
static EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// x (B, S, H, 128) bf16 as a 4-d map (D, H, S, B) of boxes 64 columns x rows,
// 128-byte swizzle; rows past S read as zeros.
static bool encode_map(CUtensorMap* map, const void* x, int B, int S, int H, int rows) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)kD * 2, (cuuint64_t)H * kD * 2,
                                 (cuuint64_t)S * H * kD * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kSpan, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

static int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                       int Skv, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;   // they hold this call's pointers: encoded for each launch
  if (!encode_map(&tm_q, q, B, Sq, Hq, kBQ) || !encode_map(&tm_k, k, B, Skv, Hkv, kBK) ||
      !encode_map(&tm_v, v, B, Skv, Hkv, kBK))
    return -2;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * Hq, (Sq + kBQ - 1) / kBQ);
  flash_fwd_wgmma_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), Sq, Skv, Hq, Hkv, causal, Skv - Sq,
      scale * kLog2eF);
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
// device, 16-byte aligned; D = 128 (llama3-8b's heads).  dtype: 0 = bfloat16
// (tensor cores), 1 = float32 (CUDA cores).  Returns a cudaError_t; a shape
// the kernel does not take returns -1, a tensor map libcuda refuses -2.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int Sq, int Skv, int Hq, int Hkv, int D, int dtype,
                                      int causal, float scale, void* stream) {
  using namespace repro_torch;
  if (Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 128) return launch_bf16(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, scale, s);
  if (dtype == 1 && D == 128) return launch_f32<128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, scale, s);
  return -1;
}
