// Split-KV decode attention partials for NVIDIA Hopper (sm_90a).
//
// Replaces the reference's Pallas TPU kernel
// src/repro/kernels/decode_attention/kernel.py:decode_attention_partials
// (body _decode_kernel).  It computes that kernel's function, not its blocks.
// One query token per (batch, kv head) group of G query heads sits at
// position kv_len; split i of ns covers the keys [i*ck, (i+1)*ck), ck = Skv/ns:
//
//   s_gj = (q_g . k_j) / sqrt(D),  s = softcap * tanh(s / softcap)  (optional)
//   key j is live iff j < kv_len and (no window or j > kv_len - window)
//   m_g   = max over the split's live keys of s_gj     (-1e30 when none)
//   l_g   = sum_j exp(s_gj - m_g)                      (0 when none)
//   acc_g = sum_j exp(s_gj - m_g) v_j                  (0 when none)
//
// The logsumexp combine over the splits runs in PyTorch (ops.py), as the
// reference runs it in jnp outside its Pallas call.  kv_len is read ON THE
// DEVICE from an int32[1] tensor: a decode step never syncs for it.
//
// Layout: q [BKV, G, D] contiguous (the model's [B, 1, H, D] query is that
// view); k and v are read in place through (batch, position, kv-head) strides,
// so the model's [B, S_max, KV, D] cache is read with no transposed copy and
// the reference kernel's [BKV, Skv, D] layout is the same call with KV = 1.
// Outputs, contiguous f32: m and l [BKV, ns, G] (the TPU's 128-lane padding
// goes), acc [BKV, ns, G, D].
//
// What bounds it: one query token reads every live key and value row once:
// at qwen3-1.7b decode (B 8, KV 8, G 2, D 128, kv_len 2048, bf16) that is
// 67 MB a layer for ~0.27 GFLOP, so device-memory bytes bound it (~0.020 ms
// at 3.35 TB/s).
//
// Design:
//   * One 128-thread block per (b*kv, split, sub-group of query rows): 16
//     teams of 8 threads.  A team walks keys lo + team, lo + team + 16, ...;
//     each thread holds D/8 of the sub-group's query rows and of its f32
//     accumulators in registers, as interleaved pairs (neighbouring threads
//     on neighbouring addresses), and scores are reduced over the team with
//     three xor shuffles.
//   * A sub-group holds at most min(8, 32 / MAXP) rows, MAXP = D / 16 rounded
//     up to a power of two (8 rows at D <= 64, 4 at D 128, 2 at D 256), so
//     the rows fit the registers and the teams' G * D <= kMaxGD merge area:
//     a group of more rows (G 6 / 7 at D 128: nemotron, grok-1, arctic)
//     runs as 2 sub-groups in grid.y.  Each row's (m, l, acc) depends on no
//     other row, so the split is exact.
//   * Each team runs its own online softmax; the 16 teams' (m, l, acc) then
//     merge in shared memory with the same logsumexp algebra.
//   * A split that lies wholly at or beyond kv_len, or outside the window,
//     loads nothing and writes m = -1e30, l = 0, acc = 0, the TPU kernel's
//     outputs for such a split.  Keys past kv_len in a live split are never
//     loaded either.
//   * bf16 at head dim 64, 80, 128 or 256 takes the tensor-core form instead
//     (decode_partials_tc_kernel in decode_attention_fused.cu, chosen by
//     kernel.py partials_route); this kernel keeps f32 math for f32 and the
//     other head dims, and runs on bf16 only for comparisons.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_span.cuh"

namespace {

constexpr int kTeam = 8;
constexpr int kThreads = 128;
constexpr int kTeams = kThreads / kTeam;
constexpr float kNegInf = -1e30f;  // the reference kernel's NEG_INF
constexpr int kMaxGD = 512;        // a sub-group's rows * D, held per team in shared memory

template <typename T>
struct Pair;

template <>
struct Pair<float> {
  static __device__ __forceinline__ float2 load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};

template <>
struct Pair<__nv_bfloat16> {
  static __device__ __forceinline__ float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

// MAXP: the most dimension pairs one thread holds (D / 16 rounded up to a
// power of two); MAXG: the most query rows of a sub-group (rounded up).
// The block takes rows [blockIdx.y * gsub, + gsub) of the group's g.
template <typename T, int MAXP, int MAXG>
__global__ void __launch_bounds__(kThreads)
decode_partials_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ kv_len_ptr,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       float* __restrict__ acc_out, int kv_heads, int g, int gsub, int d,
                       int skv, int ns, long long skb, long long sks, long long skh, long long svb,
                       long long svs, long long svh, int window, int has_softcap,
                       float softcap, float scale) {
  __shared__ float sm_m[kTeams][MAXG];
  __shared__ float sm_l[kTeams][MAXG];
  __shared__ float sm_acc[kTeams][kMaxGD];

  const int split = (int)(blockIdx.x % ns);
  const long long bkv = blockIdx.x / ns;
  const long long b = bkv / kv_heads;
  const int kvh = (int)(bkv % kv_heads);
  const int g0 = blockIdx.y * gsub;  // this block's rows of the group
  const int gn = min(gsub, g - g0);
  const int team = threadIdx.x / kTeam;
  const int lane = threadIdx.x % kTeam;
  const unsigned mask = 0xFFu << ((threadIdx.x & 31) & ~(kTeam - 1));
  const int np = d / (2 * kTeam);

  const KeySpan span = cache_split(live_keys(*kv_len_ptr, skv, window), split, skv / ns);
  const int lo = span.lo, hi = span.hi;

  const long long out_row = bkv * ns + split;
  float* m_o = m_out + out_row * g + g0;
  float* l_o = l_out + out_row * g + g0;
  float* acc_o = acc_out + (out_row * g + g0) * d;
  if (lo >= hi) {  // a dead split: nothing loaded
    for (int e = threadIdx.x; e < gn; e += kThreads) {
      m_o[e] = kNegInf;
      l_o[e] = 0.f;
    }
    for (int e = threadIdx.x; e < gn * d; e += kThreads) acc_o[e] = 0.f;
    return;
  }

  const T* q_base = q + (bkv * g + g0) * d;
  const T* k_base = k + b * skb + (long long)kvh * skh;
  const T* v_base = v + b * svb + (long long)kvh * svh;

  float qr[MAXG][2 * MAXP], acc[MAXG][2 * MAXP], m[MAXG], l[MAXG];
#pragma unroll
  for (int gg = 0; gg < MAXG; ++gg) {
    m[gg] = kNegInf;
    l[gg] = 0.f;
#pragma unroll
    for (int p = 0; p < MAXP; ++p) {
      float2 x = make_float2(0.f, 0.f);
      if (gg < gn && p < np) x = Pair<T>::load(q_base + gg * d + 2 * (p * kTeam + lane));
      qr[gg][2 * p] = x.x;
      qr[gg][2 * p + 1] = x.y;
      acc[gg][2 * p] = 0.f;
      acc[gg][2 * p + 1] = 0.f;
    }
  }

  for (int j = lo + team; j < hi; j += kTeams) {
    const T* kr = k_base + (long long)j * sks;
    float kx[2 * MAXP];
#pragma unroll
    for (int p = 0; p < MAXP; ++p) {
      float2 x = make_float2(0.f, 0.f);
      if (p < np) x = Pair<T>::load(kr + 2 * (p * kTeam + lane));
      kx[2 * p] = x.x;
      kx[2 * p + 1] = x.y;
    }
    float s[MAXG];
#pragma unroll
    for (int gg = 0; gg < MAXG; ++gg) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < 2 * MAXP; ++e) part = fmaf(qr[gg][e], kx[e], part);
      s[gg] = part;
    }
#pragma unroll
    for (int off = 1; off < kTeam; off <<= 1) {
#pragma unroll
      for (int gg = 0; gg < MAXG; ++gg) s[gg] += __shfl_xor_sync(mask, s[gg], off);
    }
    const T* vr = v_base + (long long)j * svs;
    float vx[2 * MAXP];
#pragma unroll
    for (int p = 0; p < MAXP; ++p) {
      float2 x = make_float2(0.f, 0.f);
      if (p < np) x = Pair<T>::load(vr + 2 * (p * kTeam + lane));
      vx[2 * p] = x.x;
      vx[2 * p + 1] = x.y;
    }
#pragma unroll
    for (int gg = 0; gg < MAXG; ++gg) {
      float x = s[gg] * scale;
      if (has_softcap) x = softcap * tanhf(x / softcap);
      const float m_new = fmaxf(m[gg], x);
      const float corr = expf(m[gg] - m_new);  // 0 on a team's first key
      const float pj = expf(x - m_new);
      l[gg] = l[gg] * corr + pj;
      m[gg] = m_new;
#pragma unroll
      for (int e = 0; e < 2 * MAXP; ++e) acc[gg][e] = fmaf(pj, vx[e], acc[gg][e] * corr);
    }
  }

  // merge the 16 teams' partials (a team with no key holds -1e30, 0, 0)
#pragma unroll
  for (int gg = 0; gg < MAXG; ++gg) {
    if (gg < gn) {
      if (lane == 0) {
        sm_m[team][gg] = m[gg];
        sm_l[team][gg] = l[gg];
      }
#pragma unroll
      for (int p = 0; p < MAXP; ++p) {
        if (p < np) {
          const int dim = 2 * (p * kTeam + lane);
          sm_acc[team][gg * d + dim] = acc[gg][2 * p];
          sm_acc[team][gg * d + dim + 1] = acc[gg][2 * p + 1];
        }
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < gn * d; e += kThreads) {
    const int gg = e / d;
    float mx = kNegInf;
    for (int t = 0; t < kTeams; ++t) mx = fmaxf(mx, sm_m[t][gg]);
    float num = 0.f, den = 0.f;
    for (int t = 0; t < kTeams; ++t) {
      const float w = expf(sm_m[t][gg] - mx);
      num = fmaf(sm_acc[t][e], w, num);
      den = fmaf(sm_l[t][gg], w, den);
    }
    acc_o[e] = num;
    if (e % d == 0) {
      m_o[gg] = mx;
      l_o[gg] = den;
    }
  }
}

template <typename T, int MAXP, int MAXG>
cudaError_t launch_one(const void* q, const void* k, const void* v, const void* kv_len, void* m,
                       void* l, void* acc, long long bkv, int kv_heads, int g, int gsub, int d,
                       int skv, int ns, long long skb, long long sks, long long skh,
                       long long svb, long long svs, long long svh, int window, int has_softcap,
                       float softcap, float scale, cudaStream_t stream) {
  const dim3 grid((unsigned)(bkv * ns), (unsigned)((g + gsub - 1) / gsub), 1);
  decode_partials_kernel<T, MAXP, MAXG><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_len), static_cast<float*>(m), static_cast<float*>(l),
      static_cast<float*>(acc), kv_heads, g, gsub, d, skv, ns, skb, sks, skh, svb, svs, svh,
      window, has_softcap, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kv_len, void* m,
                   void* l, void* acc, long long bkv, int kv_heads, int g, int d, int skv,
                   int ns, long long skb, long long sks, long long skh, long long svb,
                   long long svs, long long svh, int window, int has_softcap, float softcap,
                   float scale, cudaStream_t stream) {
  if (bkv * ns == 0) return cudaSuccess;
  if (g < 1 || g > 8 || d % 16 || d > 256 || bkv * ns > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int np = d / (2 * kTeam);
  const int maxp = np <= 2 ? 2 : np <= 4 ? 4 : np <= 8 ? 8 : 16;
  const int gsub = min(g, min(8, 32 / maxp));  // rows a block: gsub * d <= kMaxGD
  const int maxg = gsub <= 2 ? 2 : gsub <= 4 ? 4 : 8;
#define DA_LAUNCH(P, G)                                                                       \
  if (maxp == P && maxg == G)                                                                 \
  return launch_one<T, P, G>(q, k, v, kv_len, m, l, acc, bkv, kv_heads, g, gsub, d, skv, ns,  \
                             skb, sks, skh, svb, svs, svh, window, has_softcap, softcap,      \
                             scale, stream)
  DA_LAUNCH(2, 2);
  DA_LAUNCH(2, 4);
  DA_LAUNCH(2, 8);
  DA_LAUNCH(4, 2);
  DA_LAUNCH(4, 4);
  DA_LAUNCH(4, 8);
  DA_LAUNCH(8, 2);
  DA_LAUNCH(8, 4);
  DA_LAUNCH(16, 2);
#undef DA_LAUNCH
  return cudaErrorInvalidValue;  // unreachable: every (maxp, maxg) above is instantiated
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  The wrapper
// (kernel.py) has checked devices, dtypes, shapes and strides: D a multiple
// of 16 up to 256, G <= 8 (any G: the rows run in sub-groups), Skv a
// multiple of ns.
extern "C" int decode_attention_partials_fwd(
    const void* q, const void* k, const void* v, const void* kv_len, void* m, void* l, void* acc,
    long long bkv, int kv_heads, int g, int d, int skv, int ns, long long skb, long long sks,
    long long skh, long long svb, long long svs, long long svh, int window, int has_softcap,
    float softcap, float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(q, k, v, kv_len, m, l, acc, bkv, kv_heads, g, d, skv, ns,
                                      skb, sks, skh, svb, svs, svh, window, has_softcap,
                                      softcap, scale, s);
  return (int)launch<float>(q, k, v, kv_len, m, l, acc, bkv, kv_heads, g, d, skv, ns, skb, sks,
                            skh, svb, svs, svh, window, has_softcap, softcap, scale, s);
}
