// Fused split-KV decode attention for NVIDIA Hopper (sm_90a): splits over the
// live keys, their combine fused through a thread-block cluster.
//
// Replaces the reference's Pallas TPU kernel
// src/repro/kernels/decode_attention/kernel.py:decode_attention_partials
// (body _decode_kernel) together with the jnp combine that follows it
// (repro/kernels/decode_attention/ops.py:combine_partials): one launch takes
// one query token per (batch, kv head) group of G query heads to its output
// row.  The query sits at position kv_len and attends to the live keys
//
//   [lo, hi),  hi = min(kv_len, Skv),  lo = max(0, kv_len - window + 1) (0 with no window)
//   s_gj = (q_g . k_j) / sqrt(D),  s = softcap * tanh(s / softcap)  (optional)
//   out_g = sum_j softmax_j(s_g) v_j   (0 when no key is live, as the combine gives)
//
// kv_len is read ON THE DEVICE from an int32[1] tensor, so the launch needs
// no host sync and its grid does not depend on it.
//
// Layout: q and out [BKV, G, D] contiguous (the model's [B, 1, H, D]); k and
// v are read in place through (batch, position, kv-head) strides, so the
// model's [B, S_max, KV, D] cache is read with no transposed copy.
//
// What bounds it: one query token reads every live key and value row once:
// at qwen3-1.7b decode (B 8, KV 8, G 2, D 128, kv_len 2048, bf16) that is
// 67 MB for ~0.27 GFLOP, so device-memory bytes bound it (~0.020 ms at
// 3.35 TB/s).  Nothing else is written: the partials stay on chip.
//
// Design:
//   * Grid (ns, B*KV), one cluster of ns <= 8 blocks (the portable cluster
//     size) per (b, kv head); the wrapper picks ns (ops.fused_num_splits)
//     so that the blocks fit on the SMs at once: at the qwen3 decode shape
//     2 in the tensor-core form and 4 in the simt form, the fastest there.
//     Block `rank` takes the share [lo + floor(rank*L/ns), lo +
//     floor((rank+1)*L/ns)) of the L = hi - lo LIVE keys: no block walks
//     keys past kv_len or outside the window, the shares differ by at most
//     one key, and none is empty unless L < ns.
//   * Keys arrive in tiles of 32 rows of K and of V (simt form; 64 in the
//     tensor-core form) through 16-byte cp.async into a 2-stage (3-stage)
//     shared-memory ring: the next tiles are in flight while one is scored.
//     Rows past the share are zero-filled (no load) and masked.
//   * 128 threads = 16 teams of 8; a team scores keys team and team + 16 of
//     a tile.  Each thread holds 16-byte chunks of the G query rows and of
//     the G f32 accumulators in registers; a team reads one key row as 8
//     consecutive 16-byte chunks (conflict-free), and a score is reduced over
//     the team with three xor shuffles.
//   * One online-softmax update per warp and tile: the warp's scores of a
//     row g in the tile give one maximum, one rescale of the accumulators
//     and one exponential a key (exp2 with log2(e) folded in after the
//     softcap).  Every thread of a warp shares its maximum, so the
//     team-partial sums merge by plain addition at the end.
//   * The 4 warps merge in shared memory, then the ns blocks of the cluster
//     merge through distributed shared memory (map_shared_rank after
//     cluster.sync()), each block combining a slice of the G*D outputs and
//     writing them in q's dtype.  No f32 partial reaches device memory.
//   * kv_len = 0 gives 0 (the combine's m = -1e30, l = 0, acc = 0 algebra).
//   * bf16 at head dim 64, 80, 128 or 256 takes the tensor-core form
//     (decode_fused_tc_kernel, chosen by kernel.py fused_route): the same
//     shares, ring and combine, with K.Q^T and V^T.P^T as mma.sync (the
//     G <= 8 query rows on the n8 side, so no tile row is padding); f32 and
//     the other head dims take the form above, which keeps f32 math for
//     f32.  At D 80 a row is 88 halves (176 B: 16-byte aligned, and the
//     eight rows of an ldmatrix start 12 banks apart, so none conflict):
//     5 k-steps and 5 output slices of 16 columns, no operand padded.  At
//     D 256 the 3-stage ring of 64-key tiles takes 3 x 2 x 64 x 264 x 2 =
//     202,752 B, which with the result floats stays under the 227 KB a
//     block may use (one block an SM, as fused_num_splits assumes); a
//     thread holds 64 f32 accumulators and 32 registers of Q fragments
//     (160 registers, no spill).  In the simt form bf16 at D 80 / 256
//     reached 12% / 27% of its bound: 8-thread teams of FMAs and 3 shuffles
//     a score.
//
// The partials' tensor-core form (decode_partials_tc_kernel; kernel.py
// partials_route: bf16 at D 64, 80, 128 or 256) is the reference kernel's
// function (split i over the cache rows [i*ck, (i+1)*ck) that are live, f32
// (m, l, acc) of exp(s - m) out, the combine left to the caller) on the tc
// form's body (tc_block): the same ring, mma.sync operands and warp merge,
// but no cluster: grid (ns, B*KV), each block writes its merged partials to
// device memory.  Held within 2e-5 of its f32 twin, so it keeps natural
// units (expf) and runs V^T.P^T three times, on three bf16 terms of P.  The
// shares and splits are decode_span.cuh's, which decode_attention.cu reads
// too.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_span.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kTeam = 8;
constexpr int kTeams = kThreads / kTeam;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // keys per tile
constexpr int kKeys = kTile / kTeams;  // keys a team scores in a tile
constexpr int kStages = 2;
constexpr int kTcTile = 64;  // keys a tile of the tensor-core form: 16 a warp
constexpr int kTcStages = 3;  // its ring: one block an SM (ops.fused_num_splits) has room
constexpr int kMaxSplits = 8;
constexpr float kNegInf = -1e30f;  // the reference kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Vec;  // 16 bytes of T, widened to f32

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  static __device__ __forceinline__ float store(float v) { return v; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) { return __float2bfloat16(v); }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool copy) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = copy ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
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
// the 8 x 8 b16 matrix whose row lane / 4 this lane holds (2 values), transposed
__device__ __forceinline__ unsigned movmatrix_t(unsigned x) {
  unsigned y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}
// (v0, v1) -> three bf16 pairs whose sum is v to ~2^-24: hi = bf16(v), mid =
// bf16(v - hi), lo = bf16(v - hi - mid) (each difference exact in f32); v0
// in the low half of each pair.  Two terms leave up to 2^-16 of v.
__device__ __forceinline__ void split3(float v0, float v1, unsigned (&t)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    const float2 hf = __bfloat1622float2(h);
    t[i] = *reinterpret_cast<const unsigned*>(&h);
    v0 -= hf.x;
    v1 -= hf.y;
  }
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

// The fused kernels' parameters: 128 bytes.  On the H100 the fused tc form
// ran slower a call once its parameters passed 128 bytes (three more
// pointers, wherever they sat in the struct), so the partials' tc form has
// its own 128-byte struct, PartialsArgs.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_len;
  void* out;
  int kv_heads, g, d, skv, ns;
  long long skb, sks, skh, svb, svs, svh;
  int window, has_softcap;
  float softcap, scale;
};

// The partials' tc form's parameters (128 bytes): the outputs m, l [BKV, ns,
// G] and acc [BKV, ns, G, D] in place of `out`; the softcap's flag folded
// into softcap > 0, and the scale 1 / sqrt(D) a constant of the template
// (cap_of, scale_of).  32-bit strides would fit too, but ran slower on the
// card than these.
struct PartialsArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_len;
  float *m_out, *l_out, *acc_out;
  long long skb, sks, skh, svb, svs, svh;
  int kv_heads, g, skv, ns, window;
  float softcap;  // > 0: s = softcap * tanh(s / softcap)
};
static_assert(sizeof(Args) <= 128 && sizeof(PartialsArgs) <= 128, "kernel parameters");

__device__ __forceinline__ bool cap_of(const Args& a) { return a.has_softcap; }
__device__ __forceinline__ bool cap_of(const PartialsArgs& a) { return a.softcap > 0.f; }
template <int D>
__device__ __forceinline__ float scale_of(const Args& a) { return a.scale; }
template <int D>
__device__ __forceinline__ float scale_of(const PartialsArgs&) {  // the host's float(1 / sqrt(D))
  return static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
}

// Shared memory: the block's merged (m, l, acc) first (read by the cluster's
// other blocks), then the K / V ring, which the warps' merge reuses.
__host__ __device__ inline size_t result_floats(int maxg, int g, int d) {
  return ((2 * maxg + g * d + 3) / 4) * 4;
}

// exp in the units the scores are kept in: log2 (the fused kernel: log2(e)
// folded into the scores, exp2) or natural (the partials, whose m and l
// leave the chip and must be those of exp(s - m)).
template <bool NATURAL>
__device__ __forceinline__ float exp_units(float x) {
  return NATURAL ? expf(x) : exp2f(x);
}

// The warps' partials (wm, wl [kWarps][MAXG], wacc [kWarps][g * d]) merge
// into one (m [g], l [g], acc [g * d]) at m_dst, l_dst, acc_dst (shared or
// device memory).  A warp that saw no live key holds (-1e30, 0, 0) and adds
// nothing; no live key at all gives (-1e30, 0, 0).  Every thread calls it.
template <int MAXG, bool NATURAL>
__device__ __forceinline__ void merge_warps(int g, int d, const float* wm, const float* wl,
                                            const float* wacc, float* m_dst, float* l_dst,
                                            float* acc_dst) {
  __syncthreads();
  for (int e = threadIdx.x; e < g * d; e += kThreads) {
    const int gg = e / d;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * MAXG + gg]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp_units<NATURAL>(wm[w * MAXG + gg] - mx);
      num = fmaf(wacc[w * g * d + e], wt, num);
      den = fmaf(wl[w * MAXG + gg], wt, den);
    }
    acc_dst[e] = num;
    if (e % d == 0) {
      m_dst[gg] = mx;
      l_dst[gg] = den;
    }
  }
}

// The warps' partials (in log2 units) merge into the block's (res: m[MAXG],
// l[MAXG], acc[G * D]); then the cluster's ns blocks merge through
// distributed shared memory, each block a slice of the G * D outputs, written
// in T.  Every thread calls it.
template <typename T, int MAXG>
__device__ void merge_and_store(const Args& a, float* res, const float* wm, const float* wl,
                                const float* wacc, long long bkv, cg::cluster_group& cluster) {
  const int tid = threadIdx.x, g = a.g, d = a.d, ns = a.ns;
  const int rank = static_cast<int>(cluster.block_rank());
  merge_warps<MAXG, false>(g, d, wm, wl, wacc, res, res + MAXG, res + 2 * MAXG);
  cluster.sync();
  const float* peers[kMaxSplits];
#pragma unroll
  for (int r = 0; r < kMaxSplits; ++r) peers[r] = r < ns ? cluster.map_shared_rank(res, r) : res;
  T* out = static_cast<T*>(a.out) + bkv * g * d;
  for (int e = rank * kThreads + tid; e < g * d; e += ns * kThreads) {
    const int gg = e / d;
    float mx = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < ns) mx = fmaxf(mx, peers[r][gg]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < ns) {
        const float wt = exp2f(peers[r][gg] - mx);
        num = fmaf(peers[r][2 * MAXG + e], wt, num);
        den = fmaf(peers[r][MAXG + gg], wt, den);
      }
    }
    out[e] = Vec<T>::store(num / fmaxf(den, 1e-20f));
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// NCH: 16-byte chunks of a row a thread holds; MAXG: query rows of a group
// (G rounded up).  A thread keeps MAXG * NCH * VEC query values and as many
// accumulators in registers.
template <typename T, int NCH, int MAXG>
__global__ void __launch_bounds__(kThreads) decode_fused_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int VEC = Vec<T>::N;
  constexpr int PER = NCH * VEC;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ns = a.ns, g = a.g, d = a.d;
  const long long bkv = blockIdx.y;
  const long long b = bkv / a.kv_heads;
  const int kvh = static_cast<int>(bkv % a.kv_heads);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int team = tid / kTeam, tl = tid % kTeam;
  const int chunks = d / VEC;

  float* res = reinterpret_cast<float*>(smem);  // bm[MAXG], bl[MAXG], bacc[g * d]
  T* kbuf = reinterpret_cast<T*>(smem + result_floats(MAXG, g, d) * sizeof(float));
  T* vbuf = kbuf + kStages * kTile * d;

  // ---- this block's share of the live keys
  const KeySpan share = live_share(live_keys(*a.kv_len, a.skv, a.window), rank, ns);
  const int s_lo = share.lo, s_hi = share.hi;
  const int ntiles = s_hi > s_lo ? (s_hi - s_lo + kTile - 1) / kTile : 0;

  const T* k_base = static_cast<const T*>(a.k) + b * a.skb + (long long)kvh * a.skh;
  const T* v_base = static_cast<const T*>(a.v) + b * a.svb + (long long)kvh * a.svh;

  // The tile copy: with chunks a power of two each thread copies the same
  // chunk of every (kThreads / chunks)-th row, so its offsets are set once.
  const bool fixed = kThreads % chunks == 0;
  const int rstep = fixed ? kThreads / chunks : 0;
  const int r_thr = fixed ? tid / chunks : 0, c_thr = fixed ? tid % chunks : 0;
  auto issue = [&](int t) {  // tile t into stage t % kStages; always one group
    if (t < ntiles) {
      const int st = t % kStages;
      const int k0 = s_lo + t * kTile;
      if (fixed) {
        const T* kp = k_base + (long long)(k0 + r_thr) * a.sks + c_thr * VEC;
        const T* vp = v_base + (long long)(k0 + r_thr) * a.svs + c_thr * VEC;
        const long long kstep = (long long)rstep * a.sks, vstep = (long long)rstep * a.svs;
        T* ks = kbuf + (st * kTile + r_thr) * d + c_thr * VEC;
        T* vs = vbuf + (st * kTile + r_thr) * d + c_thr * VEC;
        for (int r = r_thr; r < kTile; r += rstep) {
          const bool ok = k0 + r < s_hi;  // past the share: zero-filled, nothing read
          cp_async16(ks, ok ? kp : k_base, ok);
          cp_async16(vs, ok ? vp : v_base, ok);
          kp += kstep;
          vp += vstep;
          ks += rstep * d;
          vs += rstep * d;
        }
      } else {
        for (int e = tid; e < kTile * chunks; e += kThreads) {
          const int r = e / chunks, c = e - r * chunks;
          const bool ok = k0 + r < s_hi;
          const long long key = ok ? k0 + r : s_lo;  // a valid address either way
          cp_async16(kbuf + (st * kTile + r) * d + c * VEC, k_base + key * a.sks + c * VEC, ok);
          cp_async16(vbuf + (st * kTile + r) * d + c * VEC, v_base + key * a.svs + c * VEC, ok);
        }
      }
    }
    cp_async_commit();
  };
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  float qr[MAXG][PER], acc[MAXG][PER], m[MAXG], l[MAXG];
  const T* q_base = static_cast<const T*>(a.q) + bkv * g * d;
#pragma unroll
  for (int gg = 0; gg < MAXG; ++gg) {
    m[gg] = kNegInf;
    l[gg] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int ch = tl + c * kTeam;
      if (gg < g && ch < chunks) {
        Vec<T>::load(q_base + gg * d + ch * VEC, &qr[gg][c * VEC]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) qr[gg][c * VEC + i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[gg][c * VEC + i] = 0.f;
    }
  }

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed (later ones may be in flight)
    __syncthreads();  // ... for every thread, and stage (t - 1) % kStages is free
    issue(t + kStages - 1);
    const int st = t % kStages;
    const int k0 = s_lo + t * kTile;
    float s[kKeys][MAXG];
#pragma unroll
    for (int kk = 0; kk < kKeys; ++kk) {
      const T* kr = kbuf + (st * kTile + team + kTeams * kk) * d;
      float kx[PER];
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int ch = tl + c * kTeam;
        if (ch < chunks) {
          Vec<T>::load(kr + ch * VEC, &kx[c * VEC]);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) kx[c * VEC + i] = 0.f;
        }
      }
#pragma unroll
      for (int gg = 0; gg < MAXG; ++gg) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < PER; ++e) part = fmaf(qr[gg][e], kx[e], part);
        s[kk][gg] = part;
      }
    }
#pragma unroll
    for (int off = 1; off < kTeam; off <<= 1) {
#pragma unroll
      for (int kk = 0; kk < kKeys; ++kk)
#pragma unroll
        for (int gg = 0; gg < MAXG; ++gg) s[kk][gg] += __shfl_xor_sync(0xffffffffu, s[kk][gg], off);
    }
    float p[kKeys][MAXG];
#pragma unroll
    for (int gg = 0; gg < MAXG; ++gg) {
      float tm = -INFINITY;
#pragma unroll
      for (int kk = 0; kk < kKeys; ++kk) {
        float x = s[kk][gg] * a.scale;
        if (a.has_softcap) x = a.softcap * tanhf(x / a.softcap);
        s[kk][gg] = k0 + team + kTeams * kk < s_hi ? x * kLog2e : -INFINITY;  // mask before exp
        tm = fmaxf(tm, s[kk][gg]);
      }
      tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 8));
      tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 16));
      const float m_new = fmaxf(m[gg], tm);
      const float corr = exp2f(m[gg] - m_new);  // 0 on the warp's first live tile
      m[gg] = m_new;
      float psum = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKeys; ++kk) {
        p[kk][gg] = exp2f(s[kk][gg] - m_new);
        psum += p[kk][gg];
      }
      l[gg] = fmaf(l[gg], corr, psum);
#pragma unroll
      for (int e = 0; e < PER; ++e) acc[gg][e] *= corr;
    }
#pragma unroll
    for (int kk = 0; kk < kKeys; ++kk) {
      const T* vr = vbuf + (st * kTile + team + kTeams * kk) * d;
      float vx[PER];
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int ch = tl + c * kTeam;
        if (ch < chunks) {
          Vec<T>::load(vr + ch * VEC, &vx[c * VEC]);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) vx[c * VEC + i] = 0.f;
        }
      }
#pragma unroll
      for (int gg = 0; gg < MAXG; ++gg)
#pragma unroll
        for (int e = 0; e < PER; ++e) acc[gg][e] = fmaf(p[kk][gg], vx[e], acc[gg][e]);
    }
  }
  cp_async_wait<0>();  // the trailing (empty) groups
  __syncthreads();     // the ring is free for the merge

  // ---- the warp's 4 teams (m is warp-uniform): plain sums
#pragma unroll
  for (int gg = 0; gg < MAXG; ++gg) {
    l[gg] += __shfl_xor_sync(0xffffffffu, l[gg], 8);
    l[gg] += __shfl_xor_sync(0xffffffffu, l[gg], 16);
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      acc[gg][e] += __shfl_xor_sync(0xffffffffu, acc[gg][e], 8);
      acc[gg][e] += __shfl_xor_sync(0xffffffffu, acc[gg][e], 16);
    }
  }
  // ---- the 4 warps' partials into shared memory (over the ring)
  float* wm = reinterpret_cast<float*>(kbuf);  // [kWarps][MAXG]
  float* wl = wm + kWarps * MAXG;               // [kWarps][MAXG]
  float* wacc = wl + kWarps * MAXG;             // [kWarps][g * d]
  if (lane < kTeam) {
#pragma unroll
    for (int gg = 0; gg < MAXG; ++gg) {
      if (gg < g) {
        if (lane == 0) {
          wm[warp * MAXG + gg] = m[gg];
          wl[warp * MAXG + gg] = l[gg];
        }
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const int ch = tl + c * kTeam;
          if (ch < chunks) {
#pragma unroll
            for (int i = 0; i < VEC; ++i)
              wacc[warp * g * d + gg * d + ch * VEC + i] = acc[gg][c * VEC + i];
          }
        }
      }
    }
  }
  merge_and_store<T, MAXG>(a, res, wm, wl, wacc, bkv, cluster);
}

// The tensor-core body (bf16, D 64, 80, 128 or 256, G <= 8), shared by the
// fused kernel's tc form and the partials' tc form: the block's keys [s_lo,
// s_hi) through a 3-stage ring of 64-key tiles at `ring`, 16 keys a warp,
// each warp its own online softmax (one update a tile), and the products on
// mma.sync m16n8k16 (bf16 in, f32 accumulate) with the operands swapped so
// that the <= 8 query rows are the n8 side: S^T = K Q^T (A = 16 keys x 16
// of D from the K tile, B = Q^T from registers) and O^T = V^T P^T (A = V^T
// by the transposing ldmatrix, B = P^T).  No tile row is padding: one mma a
// k-step for S and one a 16-column slice of D for O, and a thread holds
// D / 4 f32 accumulators (64 at D 256).  P moves from the S^T accumulator
// layout to the B operand's by movmatrix's 8 x 8 transpose.  The warps'
// partials (wm, wl [kWarps][8], wacc [kWarps][g * D]) are left in shared
// memory over the ring for merge_warps.
//   EXACT = false (the fused kernel): scores in log2 units (log2(e) folded
//     in after the softcap, exp2), P rounded to bf16 for V^T.P^T, as the
//     tensor-core flash kernel does.
//   EXACT = true (the partials, held within 2e-5 of their f32 twin): scores
//     in natural units with expf, and P split into three bf16 terms
//     (split3: hi, mid, lo) with the three products summed into the same
//     accumulators, which leaves ~2^-24 of p; l sums the unrounded f32 p.
//     Two terms (hi + lo) leave up to 2^-16 of p, and at the qwen3 decode
//     shape (256 keys a split) that missed 2e-5 on the card.  The extra
//     products reuse the V^T fragments and the accumulators: 4 more
//     registers, not D / 2.
template <int D, bool EXACT, typename A>
__device__ __forceinline__ void tc_block(const A& a, long long bkv, int s_lo, int s_hi,
                                         unsigned char* ring) {
  typedef __nv_bfloat16 bf16;
  constexpr int MAXG = 8;
  constexpr int LD = D + 8;      // a padded row (halves): conflict-free ldmatrix
  constexpr int CH = D / 8;      // 16-byte chunks of a row
  constexpr int KS = D / 16;     // k-steps of S^T, and 16-column slices of O^T
  const int g = a.g;
  const long long b = bkv / a.kv_heads;
  const int kvh = static_cast<int>(bkv % a.kv_heads);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;  // fragment row and column pair
  const float units = EXACT ? 1.f : kLog2e;

  bf16* kbuf = reinterpret_cast<bf16*>(ring);
  bf16* vbuf = kbuf + kTcStages * kTcTile * LD;
  const int ntiles = s_hi > s_lo ? (s_hi - s_lo + kTcTile - 1) / kTcTile : 0;

  const bf16* k_base = static_cast<const bf16*>(a.k) + b * a.skb + (long long)kvh * a.skh;
  const bf16* v_base = static_cast<const bf16*>(a.v) + b * a.svb + (long long)kvh * a.svh;
  auto issue = [&](int t) {  // tile t into stage t % kTcStages; always one group
    if (t < ntiles) {
      const int st = t % kTcStages;
      const int k0 = s_lo + t * kTcTile;
      for (int e = tid; e < kTcTile * CH; e += kThreads) {
        const int r = e / CH, c = e % CH;
        const bool ok = k0 + r < s_hi;  // past the share: zero-filled, nothing read
        const long long key = ok ? k0 + r : s_lo;
        cp_async16(kbuf + (st * kTcTile + r) * LD + c * 8, k_base + key * a.sks + c * 8, ok);
        cp_async16(vbuf + (st * kTcTile + r) * LD + c * 8, v_base + key * a.svs + c * 8, ok);
      }
    }
    cp_async_commit();
  };
  for (int t = 0; t < kTcStages - 1; ++t) issue(t);

  // Q^T as B fragments (k: D, n: the query row gq < G; rows past G are zero)
  unsigned qf[KS][2];
  const bf16* qrow = static_cast<const bf16*>(a.q) + (bkv * g + gq) * D;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    qf[ks][0] = gq < g ? *reinterpret_cast<const unsigned*>(qrow + 16 * ks + 2 * t4) : 0u;
    qf[ks][1] = gq < g ? *reinterpret_cast<const unsigned*>(qrow + 16 * ks + 8 + 2 * t4) : 0u;
  }
  // O^T: slice i holds columns 16 i + gq (+ 8) of the query rows 2 t4, 2 t4 + 1
  float o[KS][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows 2 t4 + j; l: this lane's keys

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kTcStages - 2>();  // tile t has landed
    __syncthreads();  // ... for every thread, and stage (t - 1) % kTcStages is free
    issue(t + kTcStages - 1);
    const int st = t % kTcStages;
    const bf16* kt = kbuf + (st * kTcTile + 16 * warp) * LD;
    const bf16* vt = vbuf + (st * kTcTile + 16 * warp) * LD;
    const int key0 = s_lo + t * kTcTile + 16 * warp;
    float sc[2][4] = {};  // S^T over even / odd k-steps: keys key0 + gq (+ 8) x rows 2 t4 + j
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      unsigned af[4];
      ldsm_x4(af, kt + (lane & 15) * LD + 16 * ks + (lane >> 4) * 8);
      mma(sc[ks & 1], af, qf[ks][0], qf[ks][1]);
    }
    float x[4];  // [2 h + j]: key key0 + gq + 8 h, row 2 t4 + j; -inf past the share
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = (sc[0][e] + sc[1][e]) * scale_of<D>(a);
      if (cap_of(a)) v = a.softcap * tanhf(v / a.softcap);
      x[e] = key0 + gq + 8 * (e >> 1) < s_hi ? v * units : -INFINITY;  // mask before exp
    }
    float corr[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // a row's keys lie across the lanes of one t4
      float tm = fmaxf(x[j], x[2 + j]);
      tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 4));
      tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 8));
      tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 16));
      const float m_new = fmaxf(m[j], tm);
      corr[j] = exp_units<EXACT>(m[j] - m_new);  // 0 on the warp's first live tile
      m[j] = m_new;
    }
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = exp_units<EXACT>(x[e] - m[e & 1]);
#pragma unroll
    for (int j = 0; j < 2; ++j) l[j] = fmaf(l[j], corr[j], p[j] + p[2 + j]);
    // P^T as the B operand: rows 2 t4 + j of keys gq (+ 8), transposed 8 x 8;
    // NP bf16 terms of P (EXACT: split3's three, else P rounded once)
    constexpr int NP = EXACT ? 3 : 1;
    unsigned pb[NP][2];
    if constexpr (EXACT) {
      unsigned t01[3], t23[3];
      split3(p[0], p[1], t01);
      split3(p[2], p[3], t23);
#pragma unroll
      for (int u = 0; u < NP; ++u) {
        pb[u][0] = movmatrix_t(t01[u]);
        pb[u][1] = movmatrix_t(t23[u]);
      }
    } else {
      const __nv_bfloat162 p01 = __floats2bfloat162_rn(p[0], p[1]);
      const __nv_bfloat162 p23 = __floats2bfloat162_rn(p[2], p[3]);
      pb[0][0] = movmatrix_t(*reinterpret_cast<const unsigned*>(&p01));
      pb[0][1] = movmatrix_t(*reinterpret_cast<const unsigned*>(&p23));
    }
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      unsigned vf[4];
      ldsm_x4_t(vf, vt + ((lane & 7) + ((lane >> 4) << 3)) * LD + 16 * i + ((lane >> 3) & 1) * 8);
      o[i][0] *= corr[0];
      o[i][1] *= corr[1];
      o[i][2] *= corr[0];
      o[i][3] *= corr[1];
#pragma unroll
      for (int u = 0; u < NP; ++u) mma(o[i], vf, pb[u][0], pb[u][1]);
    }
  }
  cp_async_wait<0>();  // the trailing (empty) groups
  __syncthreads();     // the ring is free for the warps' partials
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 4);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 8);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 16);
  }

  float* wm = reinterpret_cast<float*>(ring);  // [kWarps][MAXG]
  float* wl = wm + kWarps * MAXG;               // [kWarps][MAXG]
  float* wacc = wl + kWarps * MAXG;             // [kWarps][g * D]
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = 2 * t4 + j;
    if (row < g) {
      if (gq == 0) {
        wm[warp * MAXG + row] = m[j];
        wl[warp * MAXG + row] = l[j];
      }
      float* dst = wacc + (warp * g + row) * D + gq;
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        dst[16 * i] = o[i][j];
        dst[16 * i + 8] = o[i][2 + j];
      }
    }
  }
}

// The fused kernel's tensor-core form: the block's share of the live keys
// through tc_block, then the combine through the cluster.
template <int D>
__global__ void __launch_bounds__(kThreads) decode_fused_tc_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int MAXG = 8;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long bkv = blockIdx.y;
  float* res = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + result_floats(MAXG, a.g, D) * sizeof(float);
  const KeySpan share = live_share(live_keys(*a.kv_len, a.skv, a.window), rank, a.ns);
  tc_block<D, false>(a, bkv, share.lo, share.hi, ring);
  const float* wm = reinterpret_cast<const float*>(ring);  // tc_block's warp partials
  merge_and_store<__nv_bfloat16, MAXG>(a, res, wm, wm + kWarps * MAXG, wm + 2 * kWarps * MAXG,
                                       bkv, cluster);
}

// The partials' tensor-core form (bf16, D 64, 80, 128 or 256, G <= 8): the
// reference's signature and splits.  Block (split, bkv) takes the cache rows
// [split * ck, (split + 1) * ck), ck = Skv / ns, that are live, through
// tc_block (EXACT: natural units, P in three bf16 terms), merges its 4 warps and
// writes (m, l, acc) of exp(s - m) to device memory: m [BKV, ns, G], l
// [BKV, ns, G], acc [BKV, ns, G, D], f32.  A split with no live key loads
// nothing and writes (-1e30, 0, 0).  No cluster: the combine is the
// caller's.  kv_len is read on the device.
template <int D>
__global__ void __launch_bounds__(kThreads) decode_partials_tc_kernel(PartialsArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int MAXG = 8;
  const int split = blockIdx.x, g = a.g;
  const long long bkv = blockIdx.y;
  const KeySpan span = cache_split(live_keys(*a.kv_len, a.skv, a.window), split, a.skv / a.ns);
  const long long out_row = bkv * a.ns + split;
  float* m_o = a.m_out + out_row * g;
  float* l_o = a.l_out + out_row * g;
  float* acc_o = a.acc_out + out_row * g * D;
  if (span.lo >= span.hi) {  // a dead split: nothing loaded
    for (int e = threadIdx.x; e < g; e += kThreads) {
      m_o[e] = kNegInf;
      l_o[e] = 0.f;
    }
    for (int e = threadIdx.x; e < g * D; e += kThreads) acc_o[e] = 0.f;
    return;
  }
  tc_block<D, true>(a, bkv, span.lo, span.hi, smem);
  const float* wm = reinterpret_cast<const float*>(smem);  // tc_block's warp partials
  merge_warps<MAXG, true>(g, D, wm, wm + kWarps * MAXG, wm + 2 * kWarps * MAXG, m_o, l_o, acc_o);
}

// Dynamic shared memory: the block's merged (m, l, acc), then the larger of
// the K / V ring and the warps' partials.
size_t smem_simt(const Args& a, size_t esize, int maxg) {
  const size_t ring = static_cast<size_t>(kStages) * 2 * kTile * a.d * esize;
  const size_t merge = static_cast<size_t>(kWarps) * (2 * maxg + a.g * a.d) * sizeof(float);
  return result_floats(maxg, a.g, a.d) * sizeof(float) + (ring > merge ? ring : merge);
}

size_t smem_tc(const Args& a, int d) {
  const size_t ring = static_cast<size_t>(kTcStages) * 2 * kTcTile * (d + 8) * 2;
  const size_t merge = static_cast<size_t>(kWarps) * (2 * 8 + a.g * d) * sizeof(float);
  return result_floats(8, a.g, d) * sizeof(float) + (ring > merge ? ring : merge);
}

// The partials' tc form: the larger of the ring and the warps' partials.
size_t smem_partials_tc(const PartialsArgs& a, int d) {
  const size_t ring = static_cast<size_t>(kTcStages) * 2 * kTcTile * (d + 8) * 2;
  const size_t merge = static_cast<size_t>(kWarps) * (2 * 8 + a.g * d) * sizeof(float);
  return ring > merge ? ring : merge;
}

// One cluster of ns blocks per (b, kv head).
template <typename Kernel>
cudaError_t launch_one(Kernel kern, const Args& a, long long bkv, size_t smem,
                       cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.ns), static_cast<unsigned>(bkv), 1);
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

template <typename T>
cudaError_t launch(const Args& a, long long bkv, cudaStream_t stream) {
  if (bkv == 0) return cudaSuccess;
  if (a.ns < 1 || a.ns > kMaxSplits || bkv > 65535) return cudaErrorInvalidValue;
  const int chunks = a.d / Vec<T>::N;
  const int nch = chunks <= 8 ? 1 : chunks <= 16 ? 2 : chunks <= 32 ? 4 : 8;
  const int maxg = a.g <= 2 ? 2 : a.g <= 4 ? 4 : 8;
#define DF_LAUNCH(C, G) \
  if (nch == C && maxg == G) return launch_one(decode_fused_kernel<T, C, G>, a, bkv, \
                                               smem_simt(a, sizeof(T), G), stream)
  DF_LAUNCH(1, 2);
  DF_LAUNCH(1, 4);
  DF_LAUNCH(1, 8);
  DF_LAUNCH(2, 2);
  DF_LAUNCH(2, 4);
  DF_LAUNCH(4, 2);
  if (Vec<T>::N == 4) {  // f32: a thread holds twice the chunks for the same registers
    DF_LAUNCH(2, 8);
    DF_LAUNCH(4, 4);
    DF_LAUNCH(8, 2);
  }
#undef DF_LAUNCH
  return cudaErrorInvalidValue;  // the wrapper refuses these shapes first
}

cudaError_t launch_tc(const Args& a, long long bkv, cudaStream_t stream) {
  if (bkv == 0) return cudaSuccess;
  if (a.ns < 1 || a.ns > kMaxSplits || bkv > 65535 || a.g > 8) return cudaErrorInvalidValue;
  if (a.d == 64) return launch_one(decode_fused_tc_kernel<64>, a, bkv, smem_tc(a, 64), stream);
  if (a.d == 80) return launch_one(decode_fused_tc_kernel<80>, a, bkv, smem_tc(a, 80), stream);
  if (a.d == 128) return launch_one(decode_fused_tc_kernel<128>, a, bkv, smem_tc(a, 128), stream);
  if (a.d == 256) return launch_one(decode_fused_tc_kernel<256>, a, bkv, smem_tc(a, 256), stream);
  return cudaErrorInvalidValue;
}

// Grid (ns, B * KV), no cluster.
template <int D>
cudaError_t launch_partials_one(const PartialsArgs& a, long long bkv, cudaStream_t stream) {
  auto kern = decode_partials_tc_kernel<D>;
  const size_t smem = smem_partials_tc(a, D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<dim3(static_cast<unsigned>(a.ns), static_cast<unsigned>(bkv), 1), kThreads, smem,
         stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_partials_tc(const PartialsArgs& a, int d, long long bkv, cudaStream_t stream) {
  if (bkv == 0 || a.ns == 0) return cudaSuccess;
  if (a.ns < 1 || bkv > 65535 || a.g < 1 || a.g > 8 || a.skv % a.ns) return cudaErrorInvalidValue;
  if (d == 64) return launch_partials_one<64>(a, bkv, stream);
  if (d == 80) return launch_partials_one<80>(a, bkv, stream);
  if (d == 128) return launch_partials_one<128>(a, bkv, stream);
  if (d == 256) return launch_partials_one<256>(a, bkv, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  The wrapper
// (kernel.py) has checked devices, dtypes, shapes and strides: D a multiple
// of 16 up to 256, G <= 8, the registers a thread holds (kernel.py
// supports_fused), 16-byte aligned rows, 1 <= ns <= 8; tc: the tensor-core
// form (kernel.py fused_route: bf16, D 64, 80, 128 or 256); the simt form
// takes any dtype, so a caller may time it on the tc form's inputs.
extern "C" int decode_attention_fused_fwd(
    const void* q, const void* k, const void* v, const void* kv_len, void* out, long long bkv,
    int kv_heads, int g, int d, int skv, int ns, long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh, int window, int has_softcap, float softcap,
    float scale, int is_bf16, int tc, void* stream) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.kv_len = static_cast<const int*>(kv_len);
  a.out = out;
  a.kv_heads = kv_heads;
  a.g = g;
  a.d = d;
  a.skv = skv;
  a.ns = ns;
  a.skb = skb; a.sks = sks; a.skh = skh;
  a.svb = svb; a.svs = svs; a.svh = svh;
  a.window = window;
  a.has_softcap = has_softcap;
  a.softcap = softcap;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc) return static_cast<int>(is_bf16 ? launch_tc(a, bkv, s) : cudaErrorInvalidValue);
  if (is_bf16) return static_cast<int>(launch<__nv_bfloat16>(a, bkv, s));
  return static_cast<int>(launch<float>(a, bkv, s));
}

// The partials' tensor-core form (decode_partials_tc_kernel): the same
// operands as decode_attention_partials_fwd in decode_attention.cu.  The
// wrapper (kernel.py partials_route) has checked: bf16, D 64, 80, 128 or
// 256, 1 <= G <= 8, B * KV <= 65535, 16-byte aligned rows, ns dividing
// Skv, a positive softcap, scale = 1 / sqrt(D).
extern "C" int decode_attention_partials_tc_fwd(
    const void* q, const void* k, const void* v, const void* kv_len, void* m, void* l, void* acc,
    long long bkv, int kv_heads, int g, int d, int skv, int ns, long long skb, long long sks,
    long long skh, long long svb, long long svs, long long svh, int window, int has_softcap,
    float softcap, float scale, void* stream) {
  PartialsArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.kv_len = static_cast<const int*>(kv_len);
  a.m_out = static_cast<float*>(m);
  a.l_out = static_cast<float*>(l);
  a.acc_out = static_cast<float*>(acc);
  a.skb = skb; a.sks = sks; a.skh = skh;
  a.svb = svb; a.svs = svs; a.svh = svh;
  a.kv_heads = kv_heads;
  a.g = g;
  a.skv = skv;
  a.ns = ns;
  a.window = window;
  a.softcap = has_softcap ? softcap : 0.f;  // the wrapper's caps are positive
  (void)scale;  // 1 / sqrt(D): scale_of<D>
  return static_cast<int>(launch_partials_tc(a, d, bkv, static_cast<cudaStream_t>(stream)));
}
