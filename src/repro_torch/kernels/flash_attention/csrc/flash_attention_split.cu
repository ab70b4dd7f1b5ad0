// Flash attention forward for a few query rows over many keys on Hopper
// (sm_90a): the keys split over a thread-block cluster, Q.K^T and P.V on
// mma.sync, the splits merged through distributed shared memory.
//
// Replaces the reference's Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:flash_attention_bhsd (body
// _attn_kernel) for bf16 operands whose G * Sq query rows of a kv head
// number at most 8 over more than 64 keys, at a head dim of 64 or 128
// (``kernel.route`` in kernel.py: the "split" route; seamless's
// cross-attention at a decode step, one query over 1,024 encoder frames).
// flash_attention_short.cu keeps the other short bf16 blocks (the
// cascade's 16 rows over 8 keys).  It computes the same function as that
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
// and written in place; query head h reads kv head h / G (G = H / KV).
//
// What bounds it: at seamless's decode shape (B 1, Sq 1, Skv 1,024, H 16,
// KV 16, D 64) the call reads 4.2 MB of K and V for 4.2 MFLOP, so
// device-memory bytes bound it (1.3 us at 3.35 TB/s), and in practice one
// launch's latency.  The short kernel gave each (b, kv head) one warp: 16
// warps on 132 SMs, each walking 64 serial 16-key tiles with one of its 16
// A-tile rows live.  This design spreads the keys over the card:
//
//   * Grid: one cluster of ns <= 8 blocks (the portable cluster size) per
//     (b, kv head), launched with cudaLaunchKernelEx; the wrapper picks ns
//     by the fused decode kernel's rule (ops.fused_num_splits): at
//     seamless's shape 8, so 128 blocks.  The G * Sq <= 8 rows, in (token,
//     head within the group) order, fill the top of one m16 A tile.
//   * Block `rank` takes the share [lo + floor(rank*L/ns), lo +
//     floor((rank+1)*L/ns)) of the union [lo, hi) of the rows' live keys
//     (lo the first token's, hi the last token's: both grow with the token),
//     so no block walks keys outside it and the shares differ by at most one
//     key.  It walks its share in 64-key tiles, 16 keys a warp, through a
//     3-stage 16-byte cp.async ring (rows past the share zero-filled, no
//     load), padded by 16 bytes a row so each ldmatrix is conflict-free.
//   * S = Q K^T and O += P V on mma.sync m16n8k16 (bf16 in, f32
//     accumulate).  Each row gets its own mask (the reference's contract
//     above) before exp; each warp keeps its own online softmax (one update
//     a tile, log2(e) folded in after the softcap, P rounded to bf16 for
//     P V as the short kernel does).
//   * The 4 warps merge in shared memory, then the ns blocks of the cluster
//     merge through distributed shared memory (map_shared_rank after
//     cluster.sync()), each block a slice of the rows x D outputs, written
//     in bf16.  No partial reaches device memory.  A row with no live key
//     writes 0 (m = -1e30, l = 0, acc = 0 combine to 0, the TPU kernel's
//     l == 0 rule).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;    // query rows a (b, kv head), at most: the top of an m16 A tile
constexpr int kTile = 64;   // keys a tile: 16 a warp
constexpr int kStages = 3;  // the ring: one block an SM (ops.fused_num_splits) has room
constexpr int kMaxSplits = 8;
constexpr float kNegInf = -1e30f;  // the reference kernel's NEG_INF
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

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const int* kv_len;
  int sq, skv, heads, kv_heads, g, rows, ns;  // rows = G * Sq <= kRows
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

// Shared memory: the block's merged (m[kRows], l[kRows], acc[kRows * D]),
// read by the cluster's other blocks, then the K / V ring, which the warps'
// merge reuses.
template <int D>
__host__ __device__ constexpr size_t result_bytes() {
  return static_cast<size_t>(2 * kRows + kRows * D) * sizeof(float);
}
template <int D>
__host__ __device__ constexpr size_t ring_bytes() {
  return static_cast<size_t>(kStages) * 2 * kTile * (D + 8) * sizeof(bf16);
}

// D: 64 or 128.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_split_kernel(Args a) {
  constexpr int LD = D + 8;  // a padded row (halves): conflict-free ldmatrix
  constexpr int CH = D / 8;  // 16-byte chunks a row
  static_assert(ring_bytes<D>() >= kWarps * (2 * kRows + kRows * D) * sizeof(float),
                "the warps' partials fit over the ring");
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ns = a.ns;
  const long long bkv = blockIdx.x / ns;  // a cluster is ns consecutive blocks
  const long long b = bkv / a.kv_heads;
  const int kvh = static_cast<int>(bkv % a.kv_heads);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;  // fragment row and column pair

  float* res = reinterpret_cast<float*>(smem);
  bf16* kbuf = reinterpret_cast<bf16*>(smem + result_bytes<D>());
  bf16* vbuf = kbuf + kStages * kTile * LD;

  // ---- this block's share of the union of the rows' live keys
  const int kvl = a.kv_len ? *a.kv_len : a.skv;
  const KeyRange kr{min(kvl, a.skv), a.q_offset_from_kv_len ? kvl - a.sq : 0, a.window,
                    a.causal};
  const int klo = kr.lo(0), khi = kr.hi(a.sq - 1);
  const long long live = max(khi - klo, 0);
  const int s_lo = klo + static_cast<int>(rank * live / ns);
  const int s_hi = klo + static_cast<int>((rank + 1) * live / ns);
  const int ntiles = s_hi > s_lo ? (s_hi - s_lo + kTile - 1) / kTile : 0;

  const long long kstride = static_cast<long long>(a.kv_heads) * D;  // from one key to the next
  const long long kv_off = (b * a.skv * a.kv_heads + kvh) * static_cast<long long>(D);
  const bf16* k_base = a.k + kv_off;
  const bf16* v_base = a.v + kv_off;
  auto issue = [&](int t) {  // tile t into stage t % kStages; always one group
    if (t < ntiles) {
      const int st = t % kStages;
      const int k0 = s_lo + t * kTile;
      for (int e = tid; e < kTile * CH; e += kThreads) {
        const int r = e / CH, c = e % CH;
        const bool ok = k0 + r < s_hi;  // past the share: zero-filled, nothing read
        const long long key = ok ? k0 + r : s_lo;  // a valid address either way
        cp_async16(kbuf + (st * kTile + r) * LD + c * 8, k_base + key * kstride + c * 8, ok);
        cp_async16(vbuf + (st * kTile + r) * LD + c * 8, v_base + key * kstride + c * 8, ok);
      }
    }
    cp_async_commit();
  };
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  // row r of the (b, kv head) block: token r / G, head kvh * G + r % G
  auto row_offset = [&](int r) {
    return ((b * a.sq + r / a.g) * a.heads + kvh * a.g + r % a.g) * static_cast<long long>(D);
  };
  // Q as A fragments: row gq (< rows); rows gq + 8 are zero
  const bool qlive = gq < a.rows;
  const bf16* qrow = a.q + (qlive ? row_offset(gq) : 0);
  unsigned qf[D / 16][2];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    qf[ks][0] = qlive ? *reinterpret_cast<const unsigned*>(qrow + 16 * ks + 2 * t4) : 0u;
    qf[ks][1] = qlive ? *reinterpret_cast<const unsigned*>(qrow + 16 * ks + 8 + 2 * t4) : 0u;
  }
  // row gq's live keys within this share (none for a row past the block)
  const int lo = qlive ? kr.lo(gq / a.g) : 0;
  const int hi = qlive ? min(kr.hi(gq / a.g), s_hi) : 0;
  float o[D / 8][4] = {};
  float m = kNegInf, l = 0.f;  // row gq; l sums this lane's keys

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed
    __syncthreads();  // ... for every thread, and stage (t - 1) % kStages is free
    issue(t + kStages - 1);
    const int st = t % kStages;
    const bf16* kt = kbuf + (st * kTile + 16 * warp) * LD;
    const bf16* vt = vbuf + (st * kTile + 16 * warp) * LD;
    const int key0 = s_lo + t * kTile + 16 * warp;
    float sc[2][4] = {};  // S: 16 rows (the top 8 live) x the warp's 16 keys
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      unsigned bfr[4];
      ldsm_x4(bfr, kt + ((lane & 7) + ((lane >> 4) << 3)) * LD + 16 * ks + ((lane >> 3) & 1) * 8);
      const unsigned af[4] = {qf[ks][0], 0u, qf[ks][1], 0u};
      mma(sc[0], af, bfr[0], bfr[1]);
      mma(sc[1], af, bfr[2], bfr[3]);
    }
    float x[4];  // row gq at keys key0 + 8 * nt + 2 * t4 + j, log2 units, -inf where masked
    float tm = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = key0 + 8 * nt + 2 * t4 + j;
        float s = sc[nt][j] * a.scale;
        if (a.has_softcap) s = a.softcap * tanhf(s / a.softcap);
        x[2 * nt + j] = key >= lo && key < hi ? s * kLog2e : -INFINITY;  // mask before exp
        tm = fmaxf(tm, x[2 * nt + j]);
      }
    }
    tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
    tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 2));
    const float m_new = fmaxf(m, tm);
    const float corr = exp2f(m - m_new);  // 0 on the row's first live tile
    m = m_new;
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = exp2f(x[i] - m_new);  // 0 where masked
    l = fmaf(l, corr, (p[0] + p[1]) + (p[2] + p[3]));
    const __nv_bfloat162 p01 = __floats2bfloat162_rn(p[0], p[1]);
    const __nv_bfloat162 p23 = __floats2bfloat162_rn(p[2], p[3]);
    const unsigned pa[4] = {*reinterpret_cast<const unsigned*>(&p01), 0u,
                            *reinterpret_cast<const unsigned*>(&p23), 0u};
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      unsigned bfr[4];
      ldsm_x4_t(bfr, vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + 16 * np + (lane >> 4) * 8);
      o[2 * np][0] *= corr;
      o[2 * np][1] *= corr;
      o[2 * np + 1][0] *= corr;
      o[2 * np + 1][1] *= corr;
      mma(o[2 * np], pa, bfr[0], bfr[1]);
      mma(o[2 * np + 1], pa, bfr[2], bfr[3]);
    }
  }
  cp_async_wait<0>();  // the trailing (empty) groups
  __syncthreads();     // the ring is free for the merge
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);

  // ---- the 4 warps' partials into shared memory (over the ring)
  const int rows = a.rows, n = rows * D;
  float* wm = reinterpret_cast<float*>(kbuf);  // [kWarps][kRows]
  float* wl = wm + kWarps * kRows;             // [kWarps][kRows]
  float* wacc = wl + kWarps * kRows;           // [kWarps][rows * D]
  if (qlive) {
    if (t4 == 0) {
      wm[warp * kRows + gq] = m;
      wl[warp * kRows + gq] = l;
    }
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
      *reinterpret_cast<float2*>(wacc + warp * n + gq * D + 8 * n8 + 2 * t4) =
          make_float2(o[n8][0], o[n8][1]);
  }
  __syncthreads();
  // ---- the block's (m, l, acc), then the cluster's merge, a slice a block
  for (int e = tid; e < n; e += kThreads) {
    const int r = e / D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * kRows + r]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(wm[w * kRows + r] - mx);
      num = fmaf(wacc[w * n + e], wt, num);
      den = fmaf(wl[w * kRows + r], wt, den);
    }
    res[2 * kRows + e] = num;
    if (e % D == 0) {
      res[r] = mx;
      res[kRows + r] = den;
    }
  }
  cluster.sync();
  const float* peers[kMaxSplits];
#pragma unroll
  for (int r = 0; r < kMaxSplits; ++r) peers[r] = r < ns ? cluster.map_shared_rank(res, r) : res;
  for (int e = rank * kThreads + tid; e < n; e += ns * kThreads) {
    const int r = e / D;
    float mx = kNegInf;
#pragma unroll
    for (int p = 0; p < kMaxSplits; ++p)
      if (p < ns) mx = fmaxf(mx, peers[p][r]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxSplits; ++p) {
      if (p < ns) {
        const float wt = exp2f(peers[p][r] - mx);
        num = fmaf(peers[p][2 * kRows + e], wt, num);
        den = fmaf(peers[p][kRows + r], wt, den);
      }
    }
    a.o[row_offset(r) + e % D] = __float2bfloat16(num / fmaxf(den, 1e-20f));  // 0: no live key
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// ns * B * KV blocks, one cluster of ns per (b, kv head).
template <int D>
cudaError_t launch(const Args& a, long long bkv, cudaStream_t stream) {
  auto kern = flash_attention_split_kernel<D>;
  constexpr size_t smem = result_bytes<D>() + ring_bytes<D>();
  const cudaError_t attr_err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr_err != cudaSuccess) return attr_err;
  const long long blocks = bkv * a.ns;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.ns);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  The wrapper
// (kernel.py, ops.py) has checked devices, dtypes (bf16), shapes,
// contiguity, 16-byte alignment, D (64 or 128), G * Sq <= 8 and 1 <= ns <= 8.
extern "C" int flash_attention_split_fwd(const void* q, const void* k, const void* v, void* o,
                                         const void* kv_len, int batch, int sq, int skv,
                                         int heads, int kv_heads, int d, int causal, int window,
                                         int has_softcap, float softcap, float scale,
                                         int q_offset_from_kv_len, int ns, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)batch * sq * heads == 0) return 0;
  if ((d != 64 && d != 128) || kv_heads <= 0 || heads % kv_heads || ns < 1 || ns > kMaxSplits ||
      (long long)(heads / kv_heads) * sq > kRows)
    return (int)cudaErrorInvalidValue;
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
  a.ns = ns;
  a.causal = causal;
  a.window = window;
  a.has_softcap = has_softcap;
  a.q_offset_from_kv_len = q_offset_from_kv_len;
  a.softcap = softcap;
  a.scale = scale;
  const long long bkv = (long long)batch * kv_heads;
  return (int)(d == 128 ? launch<128>(a, bkv, s) : launch<64>(a, bkv, s));
}
