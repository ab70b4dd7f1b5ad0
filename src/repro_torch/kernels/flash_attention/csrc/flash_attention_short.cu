// Flash attention forward for short query blocks on Hopper's tensor cores
// (sm_90a): mma.sync over one 16-row tile a warp.
//
// Replaces the reference's Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:flash_attention_bhsd (body
// _attn_kernel) for bf16 operands with fewer than 64 query rows and a head
// dim of 64 or 128 (``kernel.route`` in kernel.py: the "short" route; the
// model cascade's 8 tokens a lane).  flash_attention_tc.cu keeps the long
// bf16 blocks, flash_attention.cu f32 and the other head dims.  It computes
// the same function as that kernel:
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
// and written in place; query head h reads kv head h / G (G = H / KV).
//
// What bounds it: at the cascade's shape (B 512 lanes, Sq = Skv = 8, H 16,
// KV 8, D 128) each key row meets only G * Sq = 16 query rows, so the work
// is ~0.27 GFLOP against 50.3 MB moved once: device-memory bytes bound it
// (0.0150 ms at 3.35 TB/s).  The simt kernel reached a quarter of that: each
// thread read K and V in 4-byte pieces and ran load -> FMA -> shuffle -> exp
// in sequence, so a warp had few bytes in flight.  This design keeps the
// loads wide and early and the arithmetic off the critical path:
//
//   * One warp per (b, kv head, tile of 16 query rows): the G * Sq rows that
//     share a kv head, in (token, head within the group) order, so a tile
//     is one mma m16 A operand (at the cascade's shape exactly one tile per
//     (lane, kv head): 4,096 warps, 4 a block).  Warps share nothing, so the
//     block never synchronises: each warp owns its slice of shared memory.
//   * The Q tile and 16-key tiles of K and V reach shared memory by 16-byte
//     cp.async, all issued before the first product (keys from the tile's
//     live range only; rows past it zero-filled, nothing read).  With Skv
//     <= 16 the whole key range is one tile and a warp needs ~13 KB (D 128),
//     so four blocks share an SM; longer key ranges loop over a 2-stage ring.
//   * S = Q K^T and O += P V on mma.sync m16n8k16 (bf16 in, f32 accumulate),
//     operands by ldmatrix (V by its transposing form) from rows padded by
//     16 bytes, so the eight rows of each ldmatrix hit distinct banks.
//   * The online softmax runs on the accumulator fragments: each thread
//     holds two rows' scores, a row spread over a quad (two xor shuffles for
//     its max and sum), log2(e) folded in after the softcap; the mask (the
//     reference's full contract, per row) is applied before exp.  P is
//     rounded to bf16 straight from the S fragments into the A-fragment
//     layout of P V, as the tc kernel and SDPA do.
//   * m, l and O are f32; a row with no live key writes 0 (the TPU kernel's
//     l == 0 rule).  O is staged through the Q tile's shared memory and
//     written in bf16 with 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;  // query rows a warp: one m16 tile
constexpr int kKeys = 16;  // keys a tile: two n8 tiles of S, one k16 step of P V
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool copy) {
  const int n = copy ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const int* kv_len;
  int sq, skv, heads, kv_heads, g, rows, tiles;  // rows = G * Sq, tiles = ceil(rows / 16)
  long long warps;                                // B * KV * tiles
  int causal, window, has_softcap, q_offset_from_kv_len;
  float softcap, scale;
};

// The live key range [lo, hi) of query token i.
struct KeyRange {
  int hi_all, off, window, causal;
  __device__ __forceinline__ int lo(int i) const {
    return window >= 0 ? max(0, off + i - window + 1) : 0;
  }
  __device__ __forceinline__ int hi(int i) const {
    return causal ? min(hi_all, off + i + 1) : hi_all;
  }
};

// Shared memory a warp: the Q tile (reused for O), then STAGES K and V tiles,
// each 16 rows of D + 8 halves.
template <int D, int STAGES>
__host__ __device__ constexpr size_t warp_smem() {
  return static_cast<size_t>(1 + 2 * STAGES) * kRows * (D + 8) * sizeof(bf16);
}

// D: 64 or 128.  STAGES: 1 when the key range fits one tile (Skv <= 16),
// else 2 (a ring: the next tile loads while one is used).
template <int D, int STAGES>
__global__ void __launch_bounds__(kThreads, 4) flash_attention_short_kernel(Args a) {
  constexpr int LD = D + 8;  // padded row (halves): conflict-free ldmatrix
  constexpr int CH = D / 8;  // 16-byte chunks a row
  constexpr int TILE = kRows * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (w >= a.warps) return;  // warps never synchronise with each other
  bf16* s_q = reinterpret_cast<bf16*>(smem + warp * warp_smem<D, STAGES>());
  bf16* s_k = s_q + TILE;
  bf16* s_v = s_k + STAGES * TILE;

  const int tile = static_cast<int>(w % a.tiles);
  const long long bkv = w / a.tiles;
  const int kvh = static_cast<int>(bkv % a.kv_heads);
  const long long b = bkv / a.kv_heads;
  const int r0 = tile * kRows;
  const int kvl = a.kv_len ? *a.kv_len : a.skv;
  const KeyRange kr{min(kvl, a.skv), a.q_offset_from_kv_len ? kvl - a.sq : 0, a.window,
                    a.causal};
  // the tile's key range: the first row's lo to the last row's hi
  const int klo = kr.lo(r0 / a.g);
  const int khi = kr.hi((min(r0 + kRows, a.rows) - 1) / a.g);
  const int nkt = khi > klo ? (khi - klo + kKeys - 1) / kKeys : 0;

  // row r of the (b, kv head) block: token r / G, head kvh * G + r % G
  auto row_offset = [&](int r) {
    return ((b * a.sq + r / a.g) * a.heads + kvh * a.g + r % a.g) * static_cast<long long>(D);
  };
  for (int e = lane; e < kRows * CH; e += 32) {
    const int r = e / CH, c = e % CH;
    const bool ok = r0 + r < a.rows;  // past the last row: zero-filled
    cp_async16(s_q + r * LD + c * 8, a.q + (ok ? row_offset(r0 + r) : 0) + c * 8, ok);
  }
  auto issue = [&](int t) {  // key tile t into stage t % STAGES; always one group
    if (t < nkt) {
      const int k0 = klo + t * kKeys;
      bf16* ks = s_k + (t % STAGES) * TILE;
      bf16* vs = s_v + (t % STAGES) * TILE;
      for (int e = lane; e < kKeys * CH; e += 32) {
        const int r = e / CH, c = e % CH;
        const bool ok = k0 + r < khi;  // past the range: zero-filled, nothing read
        const long long off =
            ((b * a.skv + (ok ? k0 + r : klo)) * a.kv_heads + kvh) * static_cast<long long>(D) +
            c * 8;
        cp_async16(ks + r * LD + c * 8, a.k + off, ok);
        cp_async16(vs + r * LD + c * 8, a.v + off, ok);
      }
    }
    cp_async_commit();
  };
  for (int t = 0; t < STAGES; ++t) issue(t);  // the Q tile rides in the first group

  const int gq = lane >> 2, t4 = lane & 3;  // fragment row and column pair
  int lo[2], hi[2];  // rows gq and gq + 8 of the tile; a row past the block is dead
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + gq + 8 * h;
    lo[h] = r < a.rows ? kr.lo(r / a.g) : 0;
    hi[h] = r < a.rows ? kr.hi(r / a.g) : 0;
  }
  float o[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's keys

  for (int t = 0; t < nkt; ++t) {
    cp_async_wait<STAGES - 1>();  // tile t (and Q) have landed
    __syncwarp();
    const bf16* kt = s_k + (t % STAGES) * TILE;
    const bf16* vt = s_v + (t % STAGES) * TILE;
    float sc[2][4] = {};  // S: 16 rows x 16 keys
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      unsigned qa[4], kb[4];
      ldsm_x4(qa, s_q + (lane & 15) * LD + 16 * ks + (lane >> 4) * 8);
      ldsm_x4(kb, kt + ((lane & 7) + ((lane >> 4) << 3)) * LD + 16 * ks + ((lane >> 3) & 1) * 8);
      mma(sc[0], qa, kb[0], kb[1]);
      mma(sc[1], qa, kb[2], kb[3]);
    }
    // sc[nt][2h + j]: row gq + 8h, key k0 + 8nt + 2t4 + j
    const int k0 = klo + t * kKeys;
    float x[2][4];  // [h][2nt + j], log2 units, -inf where masked
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tm = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = k0 + 8 * nt + 2 * t4 + j;
          float s = sc[nt][2 * h + j] * a.scale;
          if (a.has_softcap) s = a.softcap * tanhf(s / a.softcap);
          const bool live = key >= lo[h] && key < hi[h];
          x[h][2 * nt + j] = live ? s * kLog2e : -INFINITY;  // mask before exp
          tm = fmaxf(tm, x[h][2 * nt + j]);
        }
      }
      tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
      tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 2));
      const float m_new = fmaxf(m[h], tm);
      const float base = m_new == -INFINITY ? 0.f : m_new;  // a row with no live key yet
      corr[h] = exp2f(m[h] - base);  // 0 while m is -inf
      m[h] = m_new;
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[h][e] = exp2f(x[h][e] - base);  // 0 where masked
        psum += x[h][e];
      }
      l[h] = fmaf(l[h], corr[h], psum);
    }
    // P in the A-fragment layout of P V: k 0-7 is n-tile 0, k 8-15 n-tile 1
    const unsigned pa[4] = {pack_bf16(x[0][0], x[0][1]), pack_bf16(x[1][0], x[1][1]),
                            pack_bf16(x[0][2], x[0][3]), pack_bf16(x[1][2], x[1][3])};
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      unsigned vb[4];
      ldsm_x4_t(vb, vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + 16 * np + (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        o[2 * np + n][0] *= corr[0];
        o[2 * np + n][1] *= corr[0];
        o[2 * np + n][2] *= corr[1];
        o[2 * np + n][3] *= corr[1];
      }
      mma(o[2 * np], pa, vb[0], vb[1]);
      mma(o[2 * np + 1], pa, vb[2], vb[3]);
    }
    __syncwarp();  // every lane is done with this stage before it is refilled
    issue(t + STAGES);
  }
  cp_async_wait<0>();  // the trailing (empty) groups, and Q when no key tile ran
  __syncwarp();

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;  // the l == 0 rule
  }
  // O through the Q tile, then 16-byte stores of the live rows
#pragma unroll
  for (int n8 = 0; n8 < D / 8; ++n8) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<unsigned*>(s_q + (gq + 8 * h) * LD + 8 * n8 + 2 * t4) =
          pack_bf16(o[n8][2 * h] * inv[h], o[n8][2 * h + 1] * inv[h]);
  }
  __syncwarp();
  for (int e = lane; e < kRows * CH; e += 32) {
    const int r = e / CH, c = e % CH;
    if (r0 + r < a.rows)
      *reinterpret_cast<uint4*>(a.o + row_offset(r0 + r) + c * 8) =
          *reinterpret_cast<const uint4*>(s_q + r * LD + c * 8);
  }
}

template <int D, int STAGES>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kern = flash_attention_short_kernel<D, STAGES>;
  constexpr size_t smem = kWarps * warp_smem<D, STAGES>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (a.warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  The wrapper
// (kernel.py, ops.py) has checked devices, dtypes (bf16), shapes,
// contiguity, 16-byte alignment and D (64 or 128).
extern "C" int flash_attention_short_fwd(const void* q, const void* k, const void* v, void* o,
                                         const void* kv_len, int batch, int sq, int skv,
                                         int heads, int kv_heads, int d, int causal, int window,
                                         int has_softcap, float softcap, float scale,
                                         int q_offset_from_kv_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)batch * sq * heads == 0) return 0;
  if ((d != 64 && d != 128) || kv_heads <= 0 || heads % kv_heads) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<bf16*>(o);
  a.kv_len = static_cast<const int*>(kv_len);
  a.sq = sq;
  a.skv = skv;
  a.heads = heads;
  a.kv_heads = kv_heads;
  a.g = heads / kv_heads;
  a.rows = a.g * sq;
  a.tiles = (a.rows + kRows - 1) / kRows;
  a.warps = (long long)batch * kv_heads * a.tiles;
  a.causal = causal;
  a.window = window;
  a.has_softcap = has_softcap;
  a.q_offset_from_kv_len = q_offset_from_kv_len;
  a.softcap = softcap;
  a.scale = scale;
  const bool one_tile = skv <= kKeys;
  if (d == 128) return (int)(one_tile ? launch<128, 1>(a, s) : launch<128, 2>(a, s));
  return (int)(one_tile ? launch<64, 1>(a, s) : launch<64, 2>(a, s));
}
