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
// Heads of 64 (seamless-m4t's encoder: 16 x 4096 frames, 16/16 heads) take
// a kernel of their own, flash_fwd_overlap_kernel.  What bounds it: three
// resources need about the same time there, 4.3e9 visible (q, k) pairs at
// the encoder's shape: the tensor cores (256 flops a pair, 1.11 ms at 989
// TFLOP/s), the exp unit (one ex2 a pair at 16 a clock an SM, 1.11 ms), and
// the issue slots of the rest of the softmax (some 4.5 instructions a pair).
// At D = 128 the products take twice as long against the same softmax; at
// 64 the kernel reaches its bound only if every ex2 runs under a product.
//   * One warpgroup's S = Q K^T of tile t and O += P V of tile t - 1 are in
//     flight together: both are issued in the warpgroup's turn (wgmma
//     wait_group 1 lets P V run on), the softmax of S runs while P V does,
//     and P V is waited for only before P of tile t is handed on.
//   * P goes through shared memory (stmatrix into Q's swizzled layout, two
//     buffers a warpgroup, fence.proxy.async and a warpgroup barrier), so P V
//     is an SS product and the registers hold S (64) and O (32) only; that
//     is what lets three consumer warpgroups (192 q rows a block, 160
//     registers a thread after setmaxnreg) share an SM.  Three take a grid
//     that fills the card twice or more; smaller grids (the teacher-forcing
//     cross-attention, 2 x 512 queries: 96 blocks of 192 rows for 132 SMs)
//     take two (128 q rows, 240 registers), whose block finishes sooner.
//   * The softmax: the scale folds into one fma a score (exp2(s c - m c),
//     the max taken over raw scores since c > 0), the max in four short
//     chains, P packed with cvt.rn.bf16x2.f32, O rescaled only where a row
//     of the warp has a new max (alpha exactly 1 otherwise).  At two
//     warpgroups 2^x of one n-block in 8 is a cubic on the FMA pipe
//     (exp2_poly), an eighth of the ex2s off the exp unit.
//   * The q tile is the grid's fast axis, so that the blocks in flight share
//     a head's K and V in L2: with the heads as the fast axis (the order of
//     the kernel above) 132 blocks of different heads each stream their own
//     1 MB from device memory, 8.6 GB a call.
//   * K and V of a stage land on one barrier; 3 stages at 3 warpgroups (4
//     at 2) of 32 KB each; the masked softmax only on tiles that need it.
// ptxas: 128 registers at three warpgroups, 168 at two (the launch bound's
// counts; setmaxnreg gives the consumers 160 and 240), no spills, no
// serialised wgmma.  tools/kernel_variants.py on an H100 80GB HBM3 at 700 W
// (medians of 8 rounds; identical kernels differ by up to 3% in a call):
// 2.63-2.69 ms at the encoder's shape and 0.047 ms at the cross-attention's
// against 3.70-3.81 and 0.055 for the kernel above instantiated at D = 64.
// What lost, against the committed design in the same call (encoder shape
// unless named): two warpgroups on every grid +8%, and with P in registers
// there +5% (three warpgroups cannot keep P in registers: ptxas serialises
// every wgmma); heads as the grid's fast axis +19%; 2 stages at three
// warpgroups +43%; a 192-row kv tile (2 stages, all shared memory allows)
// +16%; no ping-pong +4%, and +27% at the cross-attention's shape; the
// exp unit alone at two warpgroups +5% at the cross-attention's shape, but
// 2^x of one n-block in 8 on the FMA pipe at three +7% (one in 4 +10%);
// ex2.approx.bf16x2 (two exps an instruction, 7.8e-3 row error against
// 5.2e-3) +11%, with spills; one P buffer with 4 stages, and a rescale
// decided by each thread, within the spread.  At D = 128 the overlapped
// design lost (P in shared memory leaves room for 2 stages: 1.25-1.33 ms
// against 1.04-1.07) and so did the q tile as the fast axis (+5%): heads of
// 128 keep the kernel above.
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

constexpr int kBQ = 128;                      // q rows per block (2 consumer warpgroups x 64)
constexpr int kBK = 128;                      // kv rows per tile
constexpr int kStages = 2;                    // K/V ring depth
constexpr int kThreads = 384;                 // 2 consumer warpgroups + 1 producer warpgroup
constexpr int kSpan = 64;                     // bf16 columns in one 128-byte swizzle span
constexpr int kQBox = kBQ * kSpan * 2;        // bytes of one 64-column box of the Q tile
constexpr int kKVBox = kBK * kSpan * 2;       // ... of a K or V tile

// Shared-memory layout for heads of D (64 or 128): the Q tile, then each
// stage's K tile and V tile, each tile D / 64 boxes of 128-byte rows.
template <int D>
struct Tiles {
  static constexpr int kBoxes = D / kSpan;
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKVBox;
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kSmemBytes = 1024 + kBarOffset + 8 * (1 + 3 * kStages);   // + alignment
};

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
template <int N>
__device__ __forceinline__ void wgmma_wait() {   // at most the N latest committed products run on
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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

#define WG_ACC32 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31" \
  "}"
#define WG_D32 WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)

// d (64 x 64, f32) += A (64 x 16) B (16 x 64), A K-major and B MN-major,
// both in shared memory: O += P V at heads of 64, P in shared memory.
__device__ __forceinline__ void wgmma_ss_tb(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_ACC32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : WG_D32
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// Four 8 x 8 bf16 matrices from registers (the mma fragment layout) to
// shared memory; lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// Make this thread's shared-memory writes visible to the tensor cores' reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The 128 threads of one warpgroup (barriers 8 + warpgroup).
__device__ __forceinline__ void warpgroup_bar(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(8 + wg) : "memory");
}

// Named barriers 1 and 2 pass the turn on the tensor cores between the two
// consumer warpgroups (1 to 3 between the three of the kernel at heads of
// 64; barrier 0 is __syncthreads).
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
// O (64 x D) is D / 2 floats a thread.
template <int D>
__device__ __forceinline__ void pv_product(float (&acc)[D / 2], const uint32_t (&pa)[kBK / 16][4],
                                           uint32_t base, uint32_t full_v, uint32_t empty, int t,
                                           int lane) {
  using L = Tiles<D>;
  const int s = t % kStages;
  const uint32_t v_tile = base + L::kQBytes + s * 2 * L::kKVBytes + L::kKVBytes;
  mbar_wait(full_v + 8 * s, (t / kStages) & 1);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)   // 16 kv rows: 8-row groups 1024 bytes apart
    wgmma_rs(acc, pa[kk], smem_desc(v_tile + kk * 16 * kSpan * 2, kKVBox, 1024));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  if (lane == 0) mbar_arrive(empty + 8 * s);   // this warp is done with the stage
}

// grid (B * Hq, ceil(Sq / 128)), 384 threads; q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D)
// through their tensor maps, o (B,Sq,Hq,D).
template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o, int Sq, int Skv,
    int Hq, int Hkv, int causal, int q_offset, float qk_scale_log2) {
  using L = Tiles<D>;
  extern __shared__ unsigned char smem_raw[];
  // Q tile, then stage s's K tile and V tile; each tile D / 64 boxes of
  // 128-byte rows.  The swizzle repeats every 1024 bytes: align to it.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBarOffset;
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
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int c = 0; c < L::kBoxes; ++c)
        tma_load(base + c * kQBox, &tm_q, bar_q, c * kSpan, hq, q0, b);
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % kStages;
        const uint32_t k_dst = base + L::kQBytes + s * 2 * L::kKVBytes, v_dst = k_dst + L::kKVBytes;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);   // the first round passes
        mbar_expect_tx(full_k + 8 * s, L::kKVBytes);
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load(k_dst + c * kKVBox, &tm_k, full_k + 8 * s, c * kSpan, hk, it * kBK, b);
        mbar_expect_tx(full_v + 8 * s, L::kKVBytes);
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load(v_dst + c * kKVBox, &tm_v, full_v + 8 * s, c * kSpan, hk, it * kBK, b);
      }
    }
  } else {
    // consumer warpgroups: 64 q rows each, 16 per warp
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int warp_row0 = q0 + wg * 64 + warp * 16 + q_offset;   // key position of the warp's row 0
    const uint32_t q_rows = base + wg * 64 * kSpan * 2;          // this warpgroup's rows of a Q box

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
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
      const uint32_t k_tile = base + L::kQBytes + s * 2 * L::kKVBytes;
      mbar_wait(full_k + 8 * s, (kt / kStages) & 1);
      named_bar_sync(1 + wg);
      if (kt > 0) pv_product<D>(acc, pa, base, full_v, empty, kt - 1, lane);
      float sc[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {   // 16 columns of D: a 32-byte step in a span
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss(sc, smem_desc(q_rows + (kk / 4) * kQBox + col, 16, 1024),
                 smem_desc(k_tile + (kk / 4) * kKVBox + col, 16, 1024), kk);
      }
      wgmma_commit();
      named_bar_arrive(2 - wg);   // the other warpgroup's turn
      wgmma_wait<0>();
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
        for (int j = 0; j < D / 8; ++j) {
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
      pv_product<D>(acc, pa, base, full_v, empty, kt - 1, lane);
    }

    __nv_bfloat16* ob = o + ((long)b * Sq * Hq + hq) * D;
    const long q_stride = (long)Hq * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_run[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = l > 0.f ? 1.f / l : 0.f;
      const int row = q0 + wg * 64 + warp * 16 + lane / 4 + 8 * h;
      if (row < Sq) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(ob + row * q_stride + j * 8 + (lane % 4) * 2) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 at heads of 64: one warpgroup's products and softmax in flight together
// ---------------------------------------------------------------------------

// Tiles and pipeline of the kernel at heads of D (64; the note at the top).
template <int D>
struct Fwd;
template <>
struct Fwd<64> {
  static constexpr int kMaxWG = 3;       // consumer warpgroups of 64 q rows on a large grid
  static constexpr int kBK = 128;        // kv rows a tile
  static constexpr int kStages2 = 4;     // K/V ring depth with 2 consumer warpgroups
  static constexpr int kStages3 = 3;     // K/V ring depth with 3 consumer warpgroups
  // 2^x of every k-th n-block of S on the FMA pipe (exp2_poly), 0 for none:
  // with 2 consumer warpgroups, and with 3
  static constexpr int kPoly2 = 8;
  static constexpr int kPoly3 = 0;
};

// ... with W consumer warpgroups (2 or 3).  Shared memory: the Q tile, the
// K/V ring (each stage's K tile, then its V tile), then two P buffers a
// warpgroup (64 rows by kBK columns in Q's layout), then the barriers.
template <int D, int W>
struct Overlap : Fwd<D> {
  using C = Fwd<D>;
  static constexpr int kWG = W, kStages = W == 3 ? C::kStages3 : C::kStages2;
  static constexpr int kPolyEvery = W == 3 ? C::kPoly3 : C::kPoly2;
  static constexpr int kBQ = 64 * W;                 // q rows a block
  static constexpr int kThreads = 128 * (W + 1);     // + the producer warpgroup
  static constexpr int kRegs = W == 2 ? 240 : 160;   // a consumer thread's, after setmaxnreg
  static constexpr int kBoxes = D / kSpan;
  static constexpr int kQBox = kBQ * kSpan * 2, kKVBox = C::kBK * kSpan * 2;
  static constexpr int kQBytes = kBoxes * kQBox, kKVBytes = kBoxes * kKVBox;
  static constexpr int kPSpan = 64 * kSpan * 2, kPBytes = C::kBK / kSpan * kPSpan;
  static constexpr int kPOffset = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kBarOffset = kPOffset + 2 * W * kPBytes;
  static constexpr int kSmemBytes = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
};

// 2^x for x <= 0 on the FMA pipe: x = n + f, |f| <= 1/2, 2^f by a cubic
// (relative error 7.5e-5, below bf16's rounding of P), n added to the
// exponent.  x is clamped at -126, whose 2^x is the smallest normal float.
__device__ __forceinline__ float exp2_poly(float x) {
  x = fmaxf(x, -126.f);
  const float t = x + 12582912.f;   // 1.5 * 2^23: round(x) in the low bits of t
  const float f = x - (t - 12582912.f);
  const float p = fmaf(fmaf(fmaf(0.05517155f, f, 0.24261114f), f, 0.69326103f), f, 0.99992806f);
  return __uint_as_float(__float_as_uint(p) + (__float_as_uint(t) << 23));
}

// cvt.rn.bf16x2.f32: two floats into one register of bf16, lo in the low half
__device__ __forceinline__ uint32_t cvt_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Online softmax of one tile of raw scores S, in place: sc becomes
// P = 2^(S c - m c) with m the row's running max of S (c > 0, so the max of
// the raw scores is the max of the scaled ones, and the scale folds into one
// fma a score); l_run takes the row's new terms; alpha[h] = 2^(m_old c - m c)
// is the factor row h's O takes, exactly 1 where the max did not move.
// With kMasked, keys past Skv, and with ``causal`` keys after the row's
// position, are masked.  Row h of the thread is the warp's row lane / 4 + 8 h,
// whose key position is row0 + lane / 4 + 8 h.
template <int kPoly, bool kMasked, int N>
__device__ __forceinline__ void softmax_scaled(float (&sc)[N], float (&m_run)[2], float (&l_run)[2],
                                               float (&alpha)[2], int k0, int row0, int lane,
                                               int Skv, int causal, float c) {
  constexpr int kEvery = kPoly > 0 ? kPoly : 1;
  if constexpr (kMasked) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int col = k0 + (i / 4) * 8 + (lane % 4) * 2 + (i & 1);
      const int row = row0 + lane / 4 + ((i & 2) ? 8 : 0);
      if (col >= Skv || (causal && col > row)) sc[i] = -INFINITY;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float part[4] = {m_run[h], -INFINITY, -INFINITY, -INFINITY};   // four short chains
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      part[j % 4] = fmaxf(part[j % 4], fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
    float mx = fmaxf(fmaxf(part[0], part[1]), fmaxf(part[2], part[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float ms = (mx == -INFINITY) ? 0.f : mx * c;   // row still fully masked
    alpha[h] = (mx == m_run[h]) ? 1.f : fast_exp2(m_run[h] * c - ms);
    m_run[h] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const int i = 4 * j + 2 * h;
      if (!kMasked && kPoly > 0 && j % kEvery == kEvery - 1) {
        sc[i] = exp2_poly(fmaf(sc[i], c, -ms));
        sc[i + 1] = exp2_poly(fmaf(sc[i + 1], c, -ms));
      } else {
        sc[i] = fast_exp2(fmaf(sc[i], c, -ms));
        sc[i + 1] = fast_exp2(fmaf(sc[i + 1], c, -ms));
      }
      sum += sc[i] + sc[i + 1];
    }
    l_run[h] = fmaf(l_run[h], alpha[h], sum);
  }
}

// The softmax of kv tile kt; only tiles that reach past Skv or, for a
// causal run, past the warp's first row's position are masked.
template <int D, int W>
__device__ __forceinline__ void softmax_tile_at(int kt, float (&sc)[Fwd<D>::kBK / 2],
                                                float (&m_run)[2], float (&l_run)[2],
                                                float (&alpha)[2], int row0, int lane, int Skv,
                                                int causal, float c) {
  constexpr int kBK = Fwd<D>::kBK, kPoly = Overlap<D, W>::kPolyEvery;
  const int k0 = kt * kBK;
  if ((k0 + kBK > Skv) || (causal && k0 + kBK - 1 > row0))
    softmax_scaled<kPoly, true>(sc, m_run, l_run, alpha, k0, row0, lane, Skv, causal, c);
  else
    softmax_scaled<kPoly, false>(sc, m_run, l_run, alpha, k0, row0, lane, Skv, causal, c);
}

// S = Q K^T of one tile: wgmma m64n(kBK)k16, both operands K-major in shared memory.
template <int D, int W>
__device__ __forceinline__ void qk_issue(float (&sc)[Fwd<D>::kBK / 2], uint32_t q_rows,
                                         uint32_t k_tile) {
  using T = Overlap<D, W>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {   // 16 columns of D: a 32-byte step in a span
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss(sc, smem_desc(q_rows + (kk / 4) * T::kQBox + col, 16, 1024),
             smem_desc(k_tile + (kk / 4) * T::kKVBox + col, 16, 1024), kk);
  }
}

// O += P V of one tile: P K-major and V MN-major, both in shared memory.
template <int D, int W>
__device__ __forceinline__ void pv_issue(float (&acc)[D / 2], uint32_t p_tile, uint32_t v_tile) {
  using T = Overlap<D, W>;
#pragma unroll
  for (int kk = 0; kk < T::kBK / 16; ++kk)   // 16 kv rows: 8-row groups 1024 bytes apart
    wgmma_ss_tb(acc, smem_desc(p_tile + (kk / 4) * T::kPSpan + (kk % 4) * 32, 16, 1024),
                smem_desc(v_tile + kk * 16 * kSpan * 2, T::kKVBox, 1024));
}

// P (f32, in place of S) to the warpgroup's P buffer as bf16 in Q's swizzled
// layout, this warp's rows 16 warp .. 16 warp + 15: per 16 columns, the
// 8-column blocks of rows 0-7 and 8-15 as four 8 x 8 matrices (the packed
// pairs of S's accumulator layout are the matrices' fragments); then fenced
// for the tensor cores, and the warpgroup waits for all four warps' rows.
template <int N>
__device__ __forceinline__ void store_p(uint32_t p_tile, const float (&sc)[N], int wg, int warp,
                                        int lane) {
  const int row = warp * 16 + (lane % 8) + ((lane / 8) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    const int blk = 2 * kk + lane / 16;   // 8-column block: 16 bytes of a 128-byte row
    const uint32_t addr = p_tile + (blk / 8) * (64 * kSpan * 2) + row * 128 +
                          (((blk % 8) ^ (row % 8)) * 16);
    stmatrix_x4(addr, cvt_bf16x2(sc[8 * kk + 0], sc[8 * kk + 1]),
                cvt_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]),
                cvt_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]),
                cvt_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]));
  }
  fence_async_shared();
  warpgroup_bar(wg);
}

// O *= alpha where some row of the warp has a new max (a row whose max did
// not move has alpha exactly 1); one branch for the whole warp.
template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2], const float (&alpha)[2]) {
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
  }
}

// The consumer warpgroups' turns on the tensor cores ("ping-pong"):
// warpgroup g waits on named barrier 1 + g and hands the turn to
// 1 + (g + 1) % W.
__device__ __forceinline__ void take_turn(int wg) {
  named_bar_sync(1 + wg);
}
template <int W>
__device__ __forceinline__ void pass_turn(int wg) {
  named_bar_arrive(1 + (wg + 1) % W);
}

// grid (ceil(Sq / kBQ), B * Hq), kThreads threads; q (B,Sq,Hq,D), k/v
// (B,Skv,Hkv,D) through their tensor maps, o (B,Sq,Hq,D).
template <int D, int W>
__global__ void __launch_bounds__(Overlap<D, W>::kThreads, 1) flash_fwd_overlap_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o, int Sq, int Skv,
    int Hq, int Hkv, int causal, int q_offset, float qk_scale_log2) {
  using T = Overlap<D, W>;
  constexpr int kBK = T::kBK, kStages = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  // The swizzle repeats every 1024 bytes: align to it.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + T::kBarOffset;
  const uint32_t full = bar_q + 8, empty = full + 8 * kStages;   // a stage's K and V landed; freed

  // the q tile is the grid's fast axis: the blocks in flight at once share
  // one head's K and V, which stay in L2 (a head's 1 MB at seamless's 4096
  // frames), and a head's q tiles with the most work run first
  const int bh = blockIdx.y, b = bh / Hq, hq = bh % Hq, hk = hq / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * T::kBQ;
  // keys visible to the block's last row: kv tiles past it are above the diagonal
  const int kv_end = causal ? min(Skv, q0 + T::kBQ + q_offset) : Skv;
  const int n_kt = max(0, (kv_end + kBK - 1) / kBK);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * W);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * W) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * W && n_kt > 0) {
      mbar_expect_tx(bar_q, T::kQBytes);
      for (int c = 0; c < T::kBoxes; ++c)
        tma_load(base + c * T::kQBox, &tm_q, bar_q, c * kSpan, hq, q0, b);
      for (int it = 0; it < n_kt; ++it) {   // tile it into stage it % kStages
        const int s = it % kStages;
        const uint32_t k_dst = base + T::kQBytes + s * 2 * T::kKVBytes, v_dst = k_dst + T::kKVBytes;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);   // the first round passes
        mbar_expect_tx(full + 8 * s, 2 * T::kKVBytes);
        for (int c = 0; c < T::kBoxes; ++c) {
          tma_load(k_dst + c * T::kKVBox, &tm_k, full + 8 * s, c * kSpan, hk, it * kBK, b);
          tma_load(v_dst + c * T::kKVBox, &tm_v, full + 8 * s, c * kSpan, hk, it * kBK, b);
        }
      }
    }
  } else {
    // consumer warpgroups: 64 q rows each, 16 per warp
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::kRegs) : "memory");
    const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int warp_row0 = q0 + wg * 64 + warp * 16 + q_offset;   // key position of the warp's row 0
    const uint32_t q_rows = base + wg * 64 * kSpan * 2;          // this warpgroup's rows of a Q box
    const uint32_t kv_tiles = base + T::kQBytes;   // stage s: K at + 2 s kKVBytes, V after it
    const uint32_t p_bufs = base + T::kPOffset + wg * 2 * T::kPBytes;   // P of tile kt: + kt % 2
    const float c = qk_scale_log2;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};   // rows lane/4 and lane/4 + 8 of the warp: raw max
    float l_run[2] = {0.f, 0.f};               // this thread's share of the row sums
    float alpha[2] = {1.f, 1.f};               // the factor O takes before the next P V
    float sc[kBK / 2];                         // S of the current tile, then its P in f32

    // Tile kt: S = Q K of tile kt and O += P V of tile kt - 1 are issued
    // together (in this warpgroup's turn), O's rescale by the previous
    // tile's alpha between them; the softmax of S runs once S is done, while
    // P V runs on, and stores P into the buffer P V does not read; then P V
    // is waited for and its stage released.
    if (n_kt > 0) {
      if (wg == W - 1) named_bar_arrive(1);   // warpgroup 0 takes the first turn
      mbar_wait(bar_q, 0);
      mbar_wait(full, 0);
      take_turn(wg);
      wgmma_fence();
      qk_issue<D, W>(sc, q_rows, kv_tiles);
      wgmma_commit();
      pass_turn<W>(wg);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_tile_at<D, W>(0, sc, m_run, l_run, alpha, warp_row0, lane, Skv, causal, c);
      store_p(p_bufs, sc, wg, warp, lane);
    }
    for (int kt = 1; kt < n_kt; ++kt) {
      const int s = kt % kStages, sp = (kt - 1) % kStages;
      mbar_wait(full + 8 * s, (kt / kStages) & 1);   // K and V of tile kt
      take_turn(wg);
      wgmma_fence();
      qk_issue<D, W>(sc, q_rows, kv_tiles + s * 2 * T::kKVBytes);
      wgmma_commit();
      rescale<D>(acc, alpha);
      wgmma_fence();
      pv_issue<D, W>(acc, p_bufs + ((kt - 1) % 2) * T::kPBytes, kv_tiles + (2 * sp + 1) * T::kKVBytes);
      wgmma_commit();
      pass_turn<W>(wg);
      wgmma_wait<1>();   // S is done; P V runs on
      fence_regs(sc);
      softmax_tile_at<D, W>(kt, sc, m_run, l_run, alpha, warp_row0, lane, Skv, causal, c);
      store_p(p_bufs + (kt % 2) * T::kPBytes, sc, wg, warp, lane);
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + 8 * sp);   // this warp is done with the stage
    }
    if (n_kt > 0) {   // the last tile's P V
      const int sp = (n_kt - 1) % kStages;
      rescale<D>(acc, alpha);
      wgmma_fence();
      pv_issue<D, W>(acc, p_bufs + ((n_kt - 1) % 2) * T::kPBytes,
                     kv_tiles + (2 * sp + 1) * T::kKVBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (wg == 0) named_bar_sync(1);   // takes the last warpgroup's last turn signal
    }

    __nv_bfloat16* ob = o + ((long)b * Sq * Hq + hq) * D;
    const long q_stride = (long)Hq * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_run[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = l > 0.f ? 1.f / l : 0.f;
      const int row = q0 + wg * 64 + warp * 16 + lane / 4 + 8 * h;
      if (row < Sq) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(ob + row * q_stride + j * 8 + (lane % 4) * 2) =
              cvt_bf16x2(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
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

// x (B, S, H, D) bf16 as a 4-d map (D, H, S, B) of boxes 64 columns x rows,
// 128-byte swizzle; rows past S read as zeros.
static bool encode_map(CUtensorMap* map, const void* x, int B, int S, int H, int D, int rows) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kSpan, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int D>
static int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                       int Skv, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;   // they hold this call's pointers: encoded for each launch
  if (!encode_map(&tm_q, q, B, Sq, Hq, D, kBQ) || !encode_map(&tm_k, k, B, Skv, Hkv, D, kBK) ||
      !encode_map(&tm_v, v, B, Skv, Hkv, D, kBK))
    return -2;
  constexpr int smem = Tiles<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * Hq, (Sq + kBQ - 1) / kBQ);
  flash_fwd_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), Sq, Skv, Hq, Hkv, causal, Skv - Sq,
      scale * kLog2eF);
  return (int)cudaGetLastError();
}

template <int D, int W>
static int launch_overlap(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                          int Skv, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  using T = Overlap<D, W>;
  CUtensorMap tm_q, tm_k, tm_v;   // they hold this call's pointers: encoded for each launch
  if (!encode_map(&tm_q, q, B, Sq, Hq, D, T::kBQ) ||
      !encode_map(&tm_k, k, B, Skv, Hkv, D, T::kBK) || !encode_map(&tm_v, v, B, Skv, Hkv, D, T::kBK))
    return -2;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_overlap_kernel<D, W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + T::kBQ - 1) / T::kBQ, B * Hq);
  flash_fwd_overlap_kernel<D, W><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), Sq, Skv, Hq, Hkv, causal, Skv - Sq,
      scale * kLog2eF);
  return (int)cudaGetLastError();
}

// Three consumer warpgroups (192 q rows a block) where their grid fills the
// card at least twice; two where it does not, since a block of three takes
// longer and fewer blocks leave SMs idle (seamless's teacher-forcing
// cross-attention, 2 x 512 queries, is 96 blocks of 192 rows for 132 SMs).
template <int D>
static int launch_overlap_sized(const void* q, const void* k, const void* v, void* o, int B,
                                int Sq, int Skv, int Hq, int Hkv, int causal, float scale,
                                cudaStream_t stream) {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  constexpr int W = Fwd<D>::kMaxWG;
  if (B * Hq > 65535) return -1;   // the grid's second axis
  if (W == 3 && (long)((Sq + 64 * W - 1) / (64 * W)) * B * Hq >= 2L * sms)
    return launch_overlap<D, W>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, scale, stream);
  return launch_overlap<D, 2>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, scale, stream);
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
// device, 16-byte aligned; D = 128 (llama3-8b's heads) or 64 (seamless-m4t's).
// dtype: 0 = bfloat16
// (tensor cores), 1 = float32 (CUDA cores).  Returns a cudaError_t; a shape
// the kernel does not take returns -1, a tensor map libcuda refuses -2.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int Sq, int Skv, int Hq, int Hkv, int D, int dtype,
                                      int causal, float scale, void* stream) {
  using namespace repro_torch;
  if (Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 128)
    return launch_bf16<128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, scale, s);
  if (dtype == 0 && D == 64)
    return launch_overlap_sized<64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, scale, s);
  if (dtype == 1 && D == 128)
    return launch_f32<128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, scale, s);
  if (dtype == 1 && D == 64)
    return launch_f32<64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, scale, s);
  return -1;
}
