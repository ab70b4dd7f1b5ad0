// Flash attention forward on Hopper's tensor cores (sm_90a): wgmma + TMA.
//
// Replaces the reference's Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:flash_attention_bhsd (body
// _attn_kernel) for bf16 operands with at least 64 query rows and a head dim
// of 64, 80, 128 or 256 (``kernel.route`` in kernel.py); flash_attention.cu
// keeps f32 and the other head dims, flash_attention_short.cu short query
// blocks (the cascade's 8 tokens).  It computes the same function as that
// kernel:
//
//   s      = (q . k) * scale            scale = 1/sqrt(D)
//   s      = softcap * tanh(s / softcap)                  (optional)
//   mask   key j of query row i (at position q_pos) is live iff
//            j < kv_len  and  (not causal or j <= q_pos)
//                        and  (no window or j > q_pos - window)
//   out    = sum_j softmax(s)_j v_j over the live keys, 0 for a row with none
//
// with q_pos = i, or kv_len - Sq + i when q_offset_from_kv_len.  kv_len is
// read ON THE DEVICE from an int32[1] tensor (a null pointer means Skv).
// q and o are [B, Sq, H, D], k and v [B, Skv, KV, D], contiguous bf16, read
// and written in place; query head h reads kv head h / (H / KV).
//
// What bounds it: a long causal prefill (qwen3-1.7b: 8 x 2,048 queries, H 16,
// KV 8, D 128) does 4 * D operations per live (query, key) pair and head
// against 2 bytes per element moved once, so the bf16 tensor-core rate
// bounds it (137.5 GFLOP: 0.139 ms at 989 TFLOP/s).  Beside the products,
// each score takes an exponential on the special-function unit and a few
// CUDA-core operations: at D 128 one 64 x 128 score tile costs a warpgroup
// about half as long on those units as its two products on the tensor
// cores, so the design keeps the tensor cores fed while the softmax runs
// (FlashAttention-3, Shah et al. 2024, sections 3.1-3.2):
//
//   * One block an SM (384 threads): a producer warpgroup and two consumer
//     warpgroups of 64 query rows each.  The producer gives its registers to
//     the consumers with setmaxnreg (24 for the producer, 240 for each
//     consumer thread at D 64 / 80 / 128; 40 / 232 at D 256), so a consumer
//     holds O, one f32 score tile and the previous tile's P in bf16 at once.
//   * The work is items of 128 query rows of one (b, h).  They are ordered
//     in sections of heads whose K and V fit in half the L2 (24 MiB), and in
//     each section longest causal key range first: the items in flight at
//     once then read the K / V tiles of a few heads, from the L2.  (Ordered
//     by query tile over all heads, the qwen3 prefill_32k layer streamed the
//     K / V of all 64 (b, kv head) pairs at once and ran 13% slower.)  A
//     block takes item blockIdx.x, then the next one not yet taken, counted
//     up atomically in a pair of int32 kept per stream (the last block sets
//     them back to 0), so the blocks finish together; with no more items
//     than SMs nothing is counted.
//   * The producer's one thread hands each item to the consumers with its Q
//     tile, through a ring of two Q tiles (one at D 256): it writes the item
//     into the slot and loads Q and then the item's K / V tiles of 128 keys
//     into a 2-stage ring by TMA (4-D maps over (D, heads, S, B) as the
//     tensors lie, 128-byte swizzle, boxes of 64 columns x 128 rows, so keys
//     past Skv and rows past Sq read as zeros and no box crosses a batch),
//     completing on mbarriers.  The next item's Q and first tiles load while
//     the consumers finish this one.  K and V have "empty" barriers of their
//     own: a K stage frees once its score product retires, a V stage once
//     its P V product does, a Q tile once the item's last score product does.
//   * S = Q K^T: wgmma m64n128k16, Q and K from shared memory (K-major,
//     128-byte swizzle descriptors), f32 accumulators.  The online softmax
//     runs in registers on the accumulator layout (each thread holds two
//     rows, a row spread over four threads: two xor shuffles per reduction),
//     on the raw scores, with scale * log2(e) folded into one FFMA before
//     ex2.approx.  P is rounded to bf16 in registers, where the accumulator
//     layout already is the A operand's, and O += P V runs as wgmma with A
//     from registers and V read D-contiguous from shared memory through the
//     transpose bit.
//   * Two products in flight in each consumer warpgroup: tile j's S = Q K_j^T
//     is issued (committed, not waited for), O is rescaled by tile j - 1's
//     correction, O += P_{j-1} V_{j-1} is issued, and wgmma.wait_group 1
//     retires only S_j: the softmax of S_j runs on the CUDA cores while P V
//     runs on the tensor cores, and wait_group 0 retires it before P_j
//     overwrites P_{j-1}'s registers.  Every read of an accumulator sits
//     behind the wait that retires it (fence_regs).
//   * Ping-pong: the two consumer warpgroups take turns to issue their
//     products, through two named barriers (bar.sync / bar.arrive over the
//     256 consumer threads), so one warpgroup's products run while the other
//     computes its softmax.  Both warpgroups walk the same items and tiles,
//     so both take the same turns; warpgroup 0 takes warpgroup 1's last
//     arrive with a last bar.sync, and no barrier is left half passed.
//   * Each item's live key-tile range comes from kv_len, causal and window
//     on the device: tiles outside it are never loaded (at a prefill
//     into a larger cache the rows past kv_len are never read).  Element
//     masks run only on boundary tiles (the diagonal, the window's edge, the
//     kv_len edge).  Keys past kv_len inside the edge tile are read and
//     weighted by 0, as in the TPU kernel and the plain twin.
//   * m, l and O are f32; a row with no live key writes 0 (the TPU kernel's
//     l == 0 rule), and a row whose first tiles hold no live key keeps m =
//     -inf and subtracts 0, so its p and correction are 0, never
//     exp(-inf - -inf).  Rounding P to bf16 before P V is what SDPA does too.
//
// The other two head dims (h2o-danube-1.8b: D 80; gemma2-9b: D 256):
//
//   * D 80 runs the D 128 design on a tile padded by the TMA unit.  The maps
//     have an inner extent of 80 and keep 64-column boxes, so the second box
//     reads columns 64-127 and the hardware fills 80-127 with zeros (the
//     mbarriers expect the whole box, zeros included).  S = Q K^T takes only
//     the 5 k-steps of the real columns; O += P V runs at N 128 and the 48
//     zero columns are discarded; the epilogue stores columns < 80 with a row
//     stride of 80.  That spends (80 + 128) / (80 + 80) = 1.3x the needed
//     operations: at most 77% of the bound.  Shared memory is the D 128
//     layout (192 KB: two Q tiles, two K / V stages).
//   * D 256 does not fit the D 128 design (Q + 2 stages of 128-key K / V
//     tiles are 320 KB of shared memory; O alone is 128 registers a thread).
//     It takes FlashAttention-3's shape for this head dim: key tiles of 64
//     (Q 64 KB + 2 x (32 + 32) KB = 192 KB: one Q tile), S = Q K^T as
//     m64n64k16, O += P V as two m64n128k16 halves, the producer warpgroup
//     at 40 registers and the consumers at 232, and one product at a time in
//     each consumer (no second tile in flight, no ping-pong).
//   * The softcap (gemma2's 50) runs tanh.approx.f32 at every head dim.
//     chip_smoke.py phase 2 holds it, and a build with libdevice's tanhf,
//     against the plain twin where q is scaled so that |s / cap| reaches ~2
//     (there the kernel without its cap misses the twin by more than 1):
//     both stay within 2e-2, their mean distances from an f32 twin within
//     0.3% of each other.  The kernel is built with and without the cap
//     (kSoftcap), so that a layer without it runs none of its code.
//
// Measured (tools/flash_tc_timings.py on an NVIDIA H100 80GB HBM3 at a
// 700 W power limit, medians of 6 runs, ms; the design with one product at a
// time, a producer warp and one block an item in parentheses; SDPA beside):
// qwen3-1.7b's prefill (B 8 x 2,048 queries in a 4,096-row cache) 0.2557
// (0.3477), SDPA 0.2533; its prefill_32k layer (B 8 x 32,768, causal)
// 53.47 (71.25), SDPA 55.18, 66.5% of the 35.58 ms bound; hymba's D 64
// prefill 0.0438 (0.0524), SDPA 0.0493; h2o-danube's D 80 prefill 0.2450
// (0.3132); gemma2's D 256 global layer 0.3309 (0.3304).  ptxas: every
// instantiation 168 registers at entry, 0 bytes of stack and spills.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 128;        // query rows an item: two warpgroups of 64
constexpr int kBlockN = 128;        // keys a K / V tile (64 at D 256)
constexpr int kStages = 2;          // K / V ring depth
constexpr int kConsumers = 256;     // two consumer warpgroups
constexpr int kProducers = 128;     // one producer warpgroup (setmaxnreg)
constexpr int kThreads = kConsumers + kProducers;
constexpr int kSwizzleBytes = 128;  // one row of a TMA box: 64 bf16 columns
constexpr long long kSectionBytes = 24ll << 20;  // K / V of a section of heads: half the L2
constexpr int kTurnBar = 1;         // named barriers 1, 2: the consumers' turns (0 is __syncthreads)
constexpr float kLog2e = 1.4426950408889634f;

// The tiling of head dim D, and the block's shared memory as offsets from a
// 1024-byte aligned base.  A tile of R rows x kDP columns is kDP / 64
// "halves" of R rows x 128 bytes (one TMA box each); 8 rows of a half form
// one 1024-byte swizzle atom.
template <int D>
struct Tile {
  static constexpr int kDP = D == 80 ? 128 : D;          // columns held (D 80: 48 zeros)
  static constexpr int kBN = D == 256 ? 64 : kBlockN;    // keys a K / V tile
  static constexpr bool kPipelined = D != 256;           // two products in flight, ping-pong
  // Q tiles in shared memory: two (the next item's Q loads during this
  // one's products), one at D 256 (no room)
  static constexpr int kQBufs = kPipelined ? 2 : 1;
  // setmaxnreg: 128 x producer + 256 x consumer <= 65,536
  static constexpr int kProducerRegs = kPipelined ? 24 : 40;
  static constexpr int kConsumerRegs = kPipelined ? 240 : 232;
  static constexpr int kAccN = kDP >= 128 ? 128 : 64;    // O columns of one wgmma
  static constexpr int kAccParts = kDP / kAccN;
  static constexpr int kQHalf = kBlockM * kSwizzleBytes;
  static constexpr int kKVHalf = kBN * kSwizzleBytes;
  static constexpr int kQBytes = kBlockM * kDP * 2;
  static constexpr int kKVBytes = kBN * kDP * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBufs * kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  // barriers: full Q, empty Q (one a Q tile each), then full K, full V,
  // empty K, empty V (one a stage each)
  static constexpr int kBar = kV + kStages * kKVBytes;
  static constexpr int kItem = kBar + 8 * (2 * kQBufs + 4 * kStages);  // the Q tiles' items
  static constexpr int kBytes = kItem + 4 * kQBufs + 1024;  // + alignment slack
};
static_assert(Tile<128>::kBytes <= 232448 && Tile<256>::kBytes <= 232448,
              "each tiling fits the 227 KB a block can use");
static_assert(kProducers * Tile<128>::kProducerRegs + kConsumers * Tile<128>::kConsumerRegs <=
                  65536 &&
              kProducers * Tile<256>::kProducerRegs + kConsumers * Tile<256>::kConsumerRegs <=
                  65536,
              "the setmaxnreg split fits the SM's registers");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Out of line: a trap inlined into the consumers' code makes ptxas drop
// their setmaxnreg budget (the D 256 instantiation then spills).
__device__ __noinline__ void watchdog_trap() { __trap(); }

// Waits for the phase of parity `parity` to complete.  A wait that lasts
// kWatchdogNs traps (the launch then fails) instead of hanging the card.
constexpr unsigned long long kWatchdogNs = 4000000000ull;
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  unsigned long long t0, now;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t0));
  while (!mbar_try(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (now - t0 > kWatchdogNs) watchdog_trap();
  }
}

// One TMA box (64 columns x rows) at (d0, head, row0, batch) into dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d0, int head, int row0, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(head), "r"(row0), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N of this warpgroup's committed product groups are
// still running (they retire in the order they were committed).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's accumulators
// (and of its A operand in registers) across the asynchronous product (the
// asm above names no registers).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Named barrier `id` over the 256 consumer threads: bar.sync waits for the
// other warpgroup's bar.arrive, bar.arrive does not wait.
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumers) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumers) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The softcap's tanh: tanh.approx.f32, one special-function op, relative
// error about 2^-11.  Built with -DFLASH_TC_TANHF, libdevice's accurate tanhf
// (many instructions a score) instead: chip_smoke.py builds both and holds
// both against the plain twin where the scores reach the cap.
__device__ __forceinline__ float softcap_tanh(float x) {
#ifdef FLASH_TC_TANHF
  return tanhf(x);
#else
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
#endif
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// m64nNk16 bf16 -> f32.  _ss: A and B by descriptor (both K-major);
// _rs: A from registers, B by descriptor read MN-major (transpose bit).
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                     uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// One work item: the query tile at row i0 of (b, h), its kv head, and its live
// key-tile range: n_tiles tiles walked down from t_hi - 1 (from the diagonal
// down).  The same for the producer and both consumer warpgroups, so all
// three walk the same tiles and pass the turn barriers equally often.
struct Item {
  int b, h, kvh, i0, t_hi, n_tiles;
};

template <int BN>
__device__ __forceinline__ Item make_item(int idx, int q_tiles, int section_heads, int heads,
                                          int kv_heads, int sq, int kv_end, int off, int causal,
                                          int window) {
  // idx -> (section, query tile, b, h): the (b, h) pairs in sections of
  // section_heads, and in each section every head's last tile first (longest
  // causal range), so the items in flight at once share few K / V heads
  Item t;
  const int section_items = q_tiles * section_heads;
  const int section = idx / section_items, r = idx % section_items;
  const int bh = section * section_heads + r % section_heads;
  t.h = bh % heads;
  t.b = bh / heads;
  t.kvh = t.h / (heads / kv_heads);
  t.i0 = (q_tiles - 1 - r / section_heads) * kBlockM;
  // the live key range [lo, hi) over the tile's rows, on whole tiles
  int hi = kv_end;
  if (causal) hi = min(hi, min(t.i0 + kBlockM, sq) - 1 + off + 1);
  int lo = 0;
  if (window >= 0) lo = max(0, t.i0 + off - window + 1);
  t.t_hi = (hi + BN - 1) / BN;
  t.n_tiles = hi > lo ? t.t_hi - lo / BN : 0;
  return t;
}

// kSoftcap: a build for each, so that a layer without the cap runs no code of it
template <int D, bool kSoftcap>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          __nv_bfloat16* __restrict__ o, const int* __restrict__ kv_len_ptr,
                          int sq, int skv, int heads, int kv_heads, int causal, int window,
                          float softcap, float scale, int q_offset_from_kv_len, int q_tiles,
                          int section_heads, int items, int* __restrict__ counts) {
  using T = Tile<D>;
  constexpr int BN = T::kBN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = raw + ((1024u - (raw & 1023u)) & 1023u);
  const uint32_t s_q = base + T::kQ, s_k = base + T::kK, s_v = base + T::kV;
  const uint32_t bars = base + T::kBar;
  auto bar_q = [&](int s) { return bars + 8u * s; };
  auto bar_q_empty = [&](int s) { return bars + 8u * (T::kQBufs + s); };
  auto bar_k = [&](int s) { return bars + 8u * (2 * T::kQBufs + s); };
  auto bar_v = [&](int s) { return bars + 8u * (2 * T::kQBufs + kStages + s); };
  auto bar_empty_k = [&](int s) { return bars + 8u * (2 * T::kQBufs + 2 * kStages + s); };
  auto bar_empty_v = [&](int s) { return bars + 8u * (2 * T::kQBufs + 3 * kStages + s); };
  // the item of each Q tile, or -1: no more items
  volatile int* item_of = reinterpret_cast<volatile int*>(smem_raw + (base - raw) + T::kItem);

  const int kvl = kv_len_ptr ? *kv_len_ptr : skv;
  const int off = q_offset_from_kv_len ? kvl - sq : 0;
  const int kv_end = min(kvl, skv);
  auto item = [&](int idx) {
    return make_item<BN>(idx, q_tiles, section_heads, heads, kv_heads, sq, kv_end, off, causal,
                         window);
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kQBufs; ++s) {
      mbar_init(bar_q(s), 1);
      mbar_init(bar_q_empty(s), kConsumers);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
      mbar_init(bar_empty_k(s), kConsumers);
      mbar_init(bar_empty_v(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Items: a block takes item blockIdx.x first, then the next one not yet
  // taken (gridDim.x + counts[0], counted up atomically), so the blocks
  // finish together; the last block to find no item left sets counts[0] and
  // counts[1] (the blocks that found none) back to 0 for the next launch.
  // With no more items than blocks, nothing is counted.  The
  // producer hands each item to the consumers with its Q tile: it writes the
  // item into the Q tile's slot before the Q load's arrive (an item with no
  // live key tile, and the -1 that ends the work, come with a plain arrive).
  // Q tiles and K / V tiles are counted over the block's items: load n of a
  // ring of S slots goes to slot n % S and completes phase (n / S) & 1.
  if (warp >= kConsumers / 32) {  // ---------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::kProducerRegs));
    if (threadIdx.x != kConsumers) return;
    int idx = (int)blockIdx.x;
    for (int q_count = 0, kv_count = 0;; ++q_count) {
      const int qs = q_count % T::kQBufs;
      mbar_wait(bar_q_empty(qs), ((q_count / T::kQBufs) & 1) ^ 1);  // a fresh slot is free
      item_of[qs] = idx < items ? idx : -1;
      if (idx >= items) {
        mbar_arrive(bar_q(qs));
        if ((int)gridDim.x == items) return;  // a block an item: nothing counted
        __threadfence();  // this block's last count before its "done"
        if (atomicAdd(&counts[1], 1) == (int)gridDim.x - 1) {
          counts[0] = 0;
          counts[1] = 0;
        }
        return;
      }
      const Item t = item(idx);
      if (t.n_tiles == 0) {
        mbar_arrive(bar_q(qs));
      } else {
        mbar_expect_tx(bar_q(qs), T::kQBytes);  // whole boxes: D 80's zero-filled columns count
#pragma unroll
        for (int hf = 0; hf < T::kDP / 64; ++hf)
          tma_load(s_q + qs * T::kQBytes + hf * T::kQHalf, &q_map, bar_q(qs), hf * 64, t.h,
                   t.i0, t.b);
      }
      for (int it = 0; it < t.n_tiles; ++it) {
        const int g = kv_count + it, s = g % kStages;
        const uint32_t phase = (g / kStages) & 1;
        const int j0 = (t.t_hi - 1 - it) * BN;
        mbar_wait(bar_empty_k(s), phase ^ 1);
        mbar_expect_tx(bar_k(s), T::kKVBytes);
#pragma unroll
        for (int hf = 0; hf < T::kDP / 64; ++hf)
          tma_load(s_k + s * T::kKVBytes + hf * T::kKVHalf, &k_map, bar_k(s), hf * 64, t.kvh, j0,
                   t.b);
        mbar_wait(bar_empty_v(s), phase ^ 1);
        mbar_expect_tx(bar_v(s), T::kKVBytes);
#pragma unroll
        for (int hf = 0; hf < T::kDP / 64; ++hf)
          tma_load(s_v + s * T::kKVBytes + hf * T::kKVHalf, &v_map, bar_v(s), hf * 64, t.kvh, j0,
                   t.b);
      }
      kv_count += t.n_tiles;
      idx = (int)gridDim.x < items ? (int)gridDim.x + atomicAdd(&counts[0], 1) : items;
    }
  }

  // ------------------------------------------------------------ consumers --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::kConsumerRegs));
  const int wg = warp / 4;  // rows [64 wg, 64 wg + 64) of the tile
  const int row_a = (warp % 4) * 16 + lane / 4;  // this thread's rows: row_a and row_a + 8
  const int col0 = 2 * (lane % 4);
  // scores enter the exponent as fmaf(s, unit, -m * unit): raw scores times
  // scale * log2(e), or capped scores already in log2 units
  const float unit = kSoftcap ? 1.f : scale * kLog2e;
  const float cap_log2 = softcap * kLog2e, inv_cap = scale / softcap;

  // O in kAccParts wgmma accumulators of kAccN columns each; one score tile;
  // P of the tile before it in bf16
  float acc[T::kAccParts][T::kAccN / 2];
  float sc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) sc[e] = 0.f;
  uint32_t pf[BN / 16][4];
  float m_a, m_b, l_a, l_b, corr_a, corr_b;
  // the current item's query tile in shared memory, and its rows' positions
  uint32_t s_qt = s_q;
  int pa = 0, pb = 0, wg_first = 0, wg_last = 0;

  // S = Q K^T of stage s over the real columns in steps of 16 (32 bytes
  // inside a swizzle row, then the next half): D 80's zero columns add
  // nothing.  Committed, not waited for.
  auto issue_s = [&](int s) {
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t desc_q =
          smem_desc(s_qt + wg * 64 * kSwizzleBytes + (kk / 4) * T::kQHalf + (kk % 4) * 32, 16, 1024);
      const uint64_t desc_k =
          smem_desc(s_k + s * T::kKVBytes + (kk / 4) * T::kKVHalf + (kk % 4) * 32, 16, 1024);
      if constexpr (BN == 128) wgmma_m64n128k16_ss(sc, desc_q, desc_k, kk > 0);
      else wgmma_m64n64k16_ss(sc, desc_q, desc_k, kk > 0);
    }
    wgmma_commit();
  };

  // O += P V of stage s over the tile's keys in steps of 16 (two 8-row
  // swizzle atoms); accumulator part p reads V's halves [p kAccN / 64,
  // (p + 1) kAccN / 64).  Committed, not waited for.
  auto issue_pv = [&](int s) {
#pragma unroll
    for (int p = 0; p < T::kAccParts; ++p) fence_regs(acc[p]);
    fence_regs(pf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int p = 0; p < T::kAccParts; ++p) {
        const uint64_t desc_v =
            smem_desc(s_v + s * T::kKVBytes + p * (T::kAccN / 64) * T::kKVHalf +
                          kk * 16 * kSwizzleBytes,
                      T::kKVHalf, 1024);
        if constexpr (T::kAccN == 128) wgmma_m64n128k16_rs(acc[p], pf[kk], desc_v, 1);
        else wgmma_m64n64k16_rs(acc[p], pf[kk], desc_v, 1);
      }
    }
    wgmma_commit();
  };

  // The online softmax of the retired score tile of keys [j0, j0 + BN): the
  // tile's p in sc (f32), l updated, and corr = exp(m_old - m_new), by which
  // O has yet to be scaled.  Accumulator element e sits at row (e / 2) % 2 ?
  // b : a, column 8 (e / 4) + col0 + e % 2.
  auto softmax = [&](int j0) {
    if constexpr (kSoftcap) {
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) sc[e] = cap_log2 * softcap_tanh(sc[e] * inv_cap);
    }
    const bool boundary = j0 + BN > kv_end || (causal && j0 + BN - 1 > wg_first) ||
                          (window >= 0 && j0 <= wg_last - window);
    if (boundary) {
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        const int key = j0 + 8 * (e / 4) + col0 + (e % 2);
        const int p = (e / 2) % 2 ? pb : pa;
        const bool live = key < kv_end && (!causal || key <= p) && (window < 0 || key > p - window);
        if (!live) sc[e] = -INFINITY;
      }
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      if ((e / 2) % 2) mx_b = fmaxf(mx_b, sc[e]);
      else mx_a = fmaxf(mx_a, sc[e]);
    }
#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, sh));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, sh));
    }
    const float new_a = fmaxf(m_a, mx_a), new_b = fmaxf(m_b, mx_b);
    // a row with no live key yet keeps m = -inf and subtracts 0: its p and corr are 0
    const float use_a = new_a == -INFINITY ? 0.f : new_a;
    const float use_b = new_b == -INFINITY ? 0.f : new_b;
    corr_a = ex2((m_a - use_a) * unit);
    corr_b = ex2((m_b - use_b) * unit);
    m_a = new_a;
    m_b = new_b;
    const float sub_a = use_a * unit, sub_b = use_b * unit;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      if ((e / 2) % 2) {
        sc[e] = ex2(fmaf(sc[e], unit, -sub_b));
        sum_b += sc[e];
      } else {
        sc[e] = ex2(fmaf(sc[e], unit, -sub_a));
        sum_a += sc[e];
      }
    }
    l_a = l_a * corr_a + sum_a;  // this thread's columns; summed over the row at the end
    l_b = l_b * corr_b + sum_b;
  };

  auto rescale = [&]() {
#pragma unroll
    for (int p = 0; p < T::kAccParts; ++p)
#pragma unroll
      for (int e = 0; e < T::kAccN / 2; ++e) acc[p][e] *= (e / 2) % 2 ? corr_b : corr_a;
  };

  // P in bf16: accumulator columns [16 kk, 16 kk + 16) are the A fragment of key step kk
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) pf[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    }
  };

  // Turns (kPipelined): warpgroup w issues its products after bar.sync on
  // barrier kTurnBar + w and then lets the other go with bar.arrive on its
  // barrier; warpgroup 0's first turn is its own arrive.  The turns alternate
  // over all the block's items, and warpgroup 0 takes warpgroup 1's last
  // arrive with a last bar.sync, so every pass of a barrier is one sync and
  // one arrive (128 threads each) and none is left half passed.
  const int mine = kTurnBar + wg, other = kTurnBar + (1 - wg);
  bool turned = false;
  auto take_turn = [&]() {
    if (wg == 0 && !turned) turn_pass(mine);
    turned = true;
    turn_wait(mine);
  };

  for (int q_count = 0, kv_count = 0;; ++q_count) {
    const int qs = q_count % T::kQBufs;
    mbar_wait(bar_q(qs), (q_count / T::kQBufs) & 1);
    const int idx = item_of[qs];
    if (idx < 0) break;
    const Item t = item(idx);
    const int ia = t.i0 + wg * 64 + row_a, ib = ia + 8;
    pa = ia + off;
    pb = ib + off;
    wg_first = t.i0 + wg * 64 + off;                   // least position of the warpgroup's
    wg_last = min(t.i0 + wg * 64 + 63, sq - 1) + off;  // rows, and most
#pragma unroll
    for (int p = 0; p < T::kAccParts; ++p)
#pragma unroll
      for (int e = 0; e < T::kAccN / 2; ++e) acc[p][e] = 0.f;
    m_a = m_b = -INFINITY;
    l_a = l_b = corr_a = corr_b = 0.f;
    const int n = t.n_tiles;
    auto stage = [&](int it) { return (kv_count + it) % kStages; };
    auto phase = [&](int it) { return (uint32_t)((kv_count + it) / kStages) & 1; };

    if (n == 0) {
      mbar_arrive(bar_q_empty(qs));  // the slot's item is read
    } else {
      s_qt = s_q + qs * T::kQBytes;
      if constexpr (T::kPipelined) {
        mbar_wait(bar_k(stage(0)), phase(0));
        take_turn();
        issue_s(stage(0));
        turn_pass(other);
        wgmma_wait<0>();
        fence_regs(sc);
        mbar_arrive(bar_empty_k(stage(0)));
        if (n == 1) mbar_arrive(bar_q_empty(qs));  // the item's last product reading Q
        softmax((t.t_hi - 1) * BN);
        pack_p();
        for (int it = 1; it < n; ++it) {
          mbar_wait(bar_k(stage(it)), phase(it));
          take_turn();
          issue_s(stage(it));                // S_it on the tensor cores ...
          rescale();                         // ... while O takes tile it - 1's correction
          mbar_wait(bar_v(stage(it - 1)), phase(it - 1));
          issue_pv(stage(it - 1));           // O += P_{it-1} V_{it-1}
          turn_pass(other);
          wgmma_wait<1>();                   // S_it retired, P V still running
          fence_regs(sc);
          mbar_arrive(bar_empty_k(stage(it)));
          if (it + 1 == n) mbar_arrive(bar_q_empty(qs));
          softmax((t.t_hi - 1 - it) * BN);
          wgmma_wait<0>();                   // P V retired: P_{it-1}'s registers are free
#pragma unroll
          for (int p = 0; p < T::kAccParts; ++p) fence_regs(acc[p]);
          fence_regs(pf);
          mbar_arrive(bar_empty_v(stage(it - 1)));
          pack_p();
        }
        rescale();
        mbar_wait(bar_v(stage(n - 1)), phase(n - 1));
        issue_pv(stage(n - 1));
        wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < T::kAccParts; ++p) fence_regs(acc[p]);
        mbar_arrive(bar_empty_v(stage(n - 1)));
      } else {  // one product at a time
        for (int it = 0; it < n; ++it) {
          mbar_wait(bar_k(stage(it)), phase(it));
          issue_s(stage(it));
          wgmma_wait<0>();
          fence_regs(sc);
          if (it + 1 == n) mbar_arrive(bar_q_empty(qs));
          softmax((t.t_hi - 1 - it) * BN);
          rescale();
          pack_p();
          mbar_wait(bar_v(stage(it)), phase(it));
          issue_pv(stage(it));
          wgmma_wait<0>();
#pragma unroll
          for (int p = 0; p < T::kAccParts; ++p) fence_regs(acc[p]);
          mbar_arrive(bar_empty_k(stage(it)));
          mbar_arrive(bar_empty_v(stage(it)));
        }
      }
      kv_count += n;
    }

#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, sh);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, sh);
    }
    const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
    const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
    // rows of D columns (the real head dim): D 80 drops its 48 padding columns
    __nv_bfloat16* o_a = o + (((long long)t.b * sq + ia) * heads + t.h) * D + col0;
    __nv_bfloat16* o_b = o_a + 8LL * heads * D;
#pragma unroll
    for (int p = 0; p < T::kAccParts; ++p) {
#pragma unroll
      for (int j = 0; j < T::kAccN / 8; ++j) {
        const int c = p * T::kAccN + 8 * j;
        if (c >= D) continue;
        if (ia < sq)
          *reinterpret_cast<__nv_bfloat162*>(o_a + c) =
              __floats2bfloat162_rn(acc[p][4 * j] * inv_a, acc[p][4 * j + 1] * inv_a);
        if (ib < sq)
          *reinterpret_cast<__nv_bfloat162*>(o_b + c) =
              __floats2bfloat162_rn(acc[p][4 * j + 2] * inv_b, acc[p][4 * j + 3] * inv_b);
      }
    }
  }
  if (T::kPipelined && wg == 0 && turned) turn_wait(mine);  // warpgroup 1's last arrive
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map (D, heads, rows, B) over a contiguous [B, rows, heads, D] bf16
// tensor, boxes of 64 x 1 x box_rows x 1 with 128-byte swizzle; reads outside
// the tensor (columns past D, rows past `rows`) fill zeros.
bool make_map(CUtensorMap* map, const void* ptr, int batch, int rows, int nheads, int d,
              int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)nheads, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)nheads * d * 2,
                                 (cuuint64_t)rows * nheads * d * 2};
  const cuuint32_t box[4] = {kSwizzleBytes / 2, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The SMs of the current device, asked once a device.
cudaError_t sm_count(int* sms) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev] > 0) {
    *sms = cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) cached[dev] = *sms;
  return err;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const void* kv_len,
                   int batch, int sq, int skv, int heads, int kv_heads, int causal, int window,
                   int has_softcap, float softcap, float scale, int q_offset_from_kv_len,
                   void* counts, cudaStream_t stream) {
  using T = Tile<D>;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, batch, sq, heads, D, kBlockM) ||
      !make_map(&km, k, batch, skv, kv_heads, D, T::kBN) ||
      !make_map(&vm, v, batch, skv, kv_heads, D, T::kBN))
    return cudaErrorInvalidValue;
  const auto kernel =
      has_softcap ? flash_attention_tc_kernel<D, true> : flash_attention_tc_kernel<D, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kBytes);
  if (err != cudaSuccess) return err;
  const int q_tiles = (sq + kBlockM - 1) / kBlockM;
  const long long items = (long long)q_tiles * batch * heads;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  // one block an SM, taking items until none is left
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)(sms < items ? sms : items);
  // a section: the most kv heads (a divisor of batch x kv_heads) whose K and
  // V fit in kSectionBytes, with their query heads
  const long long kv_bytes = 4LL * skv * D;
  int section_kv = batch * kv_heads;
  while (section_kv > 1 && (long long)section_kv * kv_bytes > kSectionBytes) {
    do --section_kv;
    while ((batch * kv_heads) % section_kv);
  }
  kernel<<<blocks, kThreads, T::kBytes, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), static_cast<const int*>(kv_len), sq, skv,
      heads, kv_heads, causal, window, softcap, scale, q_offset_from_kv_len, q_tiles,
      section_kv * (heads / kv_heads), (int)items, static_cast<int*>(counts));
  return cudaGetLastError();
}

}  // namespace

// Returns 0 on success, else a cudaError_t (cudaErrorInvalidValue when the
// tensor maps cannot be made or D is not 64, 80, 128 or 256).  The wrapper
// (kernel.py) has checked devices, dtypes (bf16), shapes, contiguity,
// 16-byte alignment and the route (those head dims, Sq >= 64).  counts: two
// int32 on the device, 0 before the first launch; each launch leaves them 0,
// so launches that share them must be ordered (one pair a stream).
extern "C" int flash_attention_tc_fwd(const void* q, const void* k, const void* v, void* o,
                                      const void* kv_len, int batch, int sq, int skv, int heads,
                                      int kv_heads, int d, int causal, int window,
                                      int has_softcap, float softcap, float scale,
                                      int q_offset_from_kv_len, void* counts,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)batch * sq * heads == 0) return 0;
  if (d != 64 && d != 80 && d != 128 && d != 256) return (int)cudaErrorInvalidValue;
  if (skv == 0)  // no key at all: every row writes 0
    return (int)cudaMemsetAsync(o, 0, (size_t)batch * sq * heads * d * 2, s);
  switch (d) {
    case 64:
      return (int)launch<64>(q, k, v, o, kv_len, batch, sq, skv, heads, kv_heads, causal, window,
                             has_softcap, softcap, scale, q_offset_from_kv_len, counts, s);
    case 80:
      return (int)launch<80>(q, k, v, o, kv_len, batch, sq, skv, heads, kv_heads, causal, window,
                             has_softcap, softcap, scale, q_offset_from_kv_len, counts, s);
    case 128:
      return (int)launch<128>(q, k, v, o, kv_len, batch, sq, skv, heads, kv_heads, causal,
                              window, has_softcap, softcap, scale, q_offset_from_kv_len, counts, s);
    default:
      return (int)launch<256>(q, k, v, o, kv_len, batch, sq, skv, heads, kv_heads, causal,
                              window, has_softcap, softcap, scale, q_offset_from_kv_len, counts, s);
  }
}
