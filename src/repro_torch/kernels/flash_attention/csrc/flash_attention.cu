// Flash attention forward (one pass, online softmax) for NVIDIA Hopper (sm_90a).
//
// Replaces the reference's Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:flash_attention_bhsd (body
// _attn_kernel).  It computes that kernel's function, not its blocks:
//
//   s      = (q . k) * scale            scale = 1/sqrt(D)
//   s      = softcap * tanh(s / softcap)                  (optional)
//   mask   key j of query row i (at position q_pos) is live iff
//            j < kv_len  and  (not causal or j <= q_pos)
//                        and  (no window or j > q_pos - window)
//   out    = sum_j softmax(s)_j v_j over the live keys, 0 for a row with none
//
// with q_pos = i, or kv_len - Sq + i when q_offset_from_kv_len (queries at the
// end of the valid cache).  kv_len is read ON THE DEVICE from an int32[1]
// tensor (a null pointer means Skv), so a caller never syncs for it.
//
// Layout: q and o are [B, Sq, H, D], k and v [B, Skv, KV, D], all contiguous,
// one dtype (f32 or bf16); the output is in q's dtype.  GQA maps query head h
// to kv head h / (H / KV) by index: K and V are never replicated.
//
// What bounds it: at the cascade backbone's shape (B = 512 lanes, Sq = Skv =
// 8, H = 16, KV = 8, D = 128, bf16) each key row is dotted with only 2 x 8
// query rows, so the work is ~0.27 GFLOP against ~50 MB moved: memory bytes
// bound it (~15 us at 3.35 TB/s on the H100).  A long causal prefill (S =
// 4096) is operation-bound instead, and far from that bound in this kernel's
// f32 FMAs: ``kernel.route`` sends bf16 calls with >= 64 query rows and D 64
// or 128 to the tensor-core kernel (flash_attention_tc.cu).  This one keeps
// f32 (exact FMAs, no TF32), short query blocks and the other head dims.
//
// Design:
//   * A team of 8 threads owns one query row.  Each thread holds D/8 of the
//     row's dimensions of q and of the f32 accumulator in registers, as
//     interleaved pairs, so a team reads one whole key or value row per
//     step with neighbouring threads on neighbouring addresses.  Scores are
//     reduced over the team with three xor shuffles.
//   * A 128-thread block holds 16 consecutive query rows in (b, kv head,
//     q head, i) order, so the rows that share a kv head (qpk x Sq of them;
//     16 at the backbone's shape) sit in one block and read the same K / V
//     rows through L1.  That packs several (lane, head) pairs into a block
//     when Sq is small; no Sq or Skv divisibility is needed.
//   * Each row walks only its live key range [lo, hi), so key ranges no row
//     can reach (causal upper triangle, outside the window, past kv_len) are
//     never loaded: the per-row form of the TPU kernel's block skip.
//   * The online softmax runs over chunks of 8 keys: 8 scores, one running
//     max update and one rescale per chunk.  m, l and the accumulator are
//     f32; a row with no live key writes 0 (the TPU kernel's l == 0 rule).
//   * Blocks are issued in reverse query order within a head, so the longest
//     causal rows start first and the grid's tail is short.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTeam = 8;                      // threads per query row
constexpr int kThreads = 128;                 // threads per block
constexpr int kRowsPerBlock = kThreads / kTeam;
constexpr int kChunk = 8;                     // keys per online-softmax step

template <typename T>
struct Pair;

template <>
struct Pair<float> {
  static __device__ __forceinline__ float2 load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <>
struct Pair<__nv_bfloat16> {
  static __device__ __forceinline__ float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

// MAXP: the most dimension pairs one thread holds (D / 16 rounded up to a
// power of two); np <= MAXP is this call's count.
template <typename T, int MAXP>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       const int* __restrict__ kv_len_ptr,
                       int sq, int skv, int heads, int kv_heads, int d,
                       int causal, int window, int has_softcap, float softcap,
                       float scale, int q_offset_from_kv_len, long long rows) {
  const int team = threadIdx.x / kTeam;
  const int lane = threadIdx.x % kTeam;
  const unsigned mask = 0xFFu << ((threadIdx.x & 31) & ~(kTeam - 1));
  const long long row = (long long)blockIdx.x * kRowsPerBlock + team;
  if (row >= rows) return;  // the whole team leaves together

  // row = (b * H + h) * Sq + (Sq - 1 - i): reverse query order in a head
  const int i = sq - 1 - (int)(row % sq);
  const long long bh = row / sq;
  const int h = (int)(bh % heads);
  const long long b = bh / heads;
  const int kvh = h / (heads / kv_heads);
  const int np = d / (2 * kTeam);

  const int kvl = kv_len_ptr ? *kv_len_ptr : skv;
  const int q_pos = q_offset_from_kv_len ? kvl - sq + i : i;
  int hi = min(kvl, skv);
  if (causal) hi = min(hi, q_pos + 1);
  int lo = 0;
  if (window >= 0) lo = max(lo, q_pos - window + 1);

  const long long kv_stride = (long long)kv_heads * d;
  const T* q_row = q + ((b * sq + i) * heads + h) * d;
  const T* k_base = k + b * skv * kv_stride + (long long)kvh * d;
  const T* v_base = v + b * skv * kv_stride + (long long)kvh * d;
  T* o_row = o + ((b * sq + i) * heads + h) * d;

  float qr[2 * MAXP], acc[2 * MAXP];
#pragma unroll
  for (int p = 0; p < MAXP; ++p) {
    float2 x = make_float2(0.f, 0.f);
    if (p < np) x = Pair<T>::load(q_row + 2 * (p * kTeam + lane));
    qr[2 * p] = x.x;
    qr[2 * p + 1] = x.y;
    acc[2 * p] = 0.f;
    acc[2 * p + 1] = 0.f;
  }

  float m = -INFINITY, l = 0.f;
  for (int j0 = lo; j0 < hi; j0 += kChunk) {
    float s[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      float part = 0.f;
      if (j0 + c < hi) {
        const T* kr = k_base + (long long)(j0 + c) * kv_stride;
#pragma unroll
        for (int p = 0; p < MAXP; ++p) {
          if (p < np) {
            const float2 x = Pair<T>::load(kr + 2 * (p * kTeam + lane));
            part = fmaf(qr[2 * p], x.x, part);
            part = fmaf(qr[2 * p + 1], x.y, part);
          }
        }
      }
      s[c] = part;
    }
#pragma unroll
    for (int off = 1; off < kTeam; off <<= 1) {
#pragma unroll
      for (int c = 0; c < kChunk; ++c) s[c] += __shfl_xor_sync(mask, s[c], off);
    }
    float cmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      float x = s[c] * scale;
      if (has_softcap) x = softcap * tanhf(x / softcap);
      s[c] = x;
      if (j0 + c < hi) cmax = fmaxf(cmax, x);
    }
    const float m_new = fmaxf(m, cmax);  // finite: the chunk holds a live key
    const float corr = expf(m - m_new);  // 0 on the first chunk (m = -inf)
    l *= corr;
#pragma unroll
    for (int e = 0; e < 2 * MAXP; ++e) acc[e] *= corr;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (j0 + c < hi) {
        const float pc = expf(s[c] - m_new);
        l += pc;
        const T* vr = v_base + (long long)(j0 + c) * kv_stride;
#pragma unroll
        for (int p = 0; p < MAXP; ++p) {
          if (p < np) {
            const float2 x = Pair<T>::load(vr + 2 * (p * kTeam + lane));
            acc[2 * p] = fmaf(pc, x.x, acc[2 * p]);
            acc[2 * p + 1] = fmaf(pc, x.y, acc[2 * p + 1]);
          }
        }
      }
    }
    m = m_new;
  }

  const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
  for (int p = 0; p < MAXP; ++p) {
    if (p < np) Pair<T>::store(o_row + 2 * (p * kTeam + lane), acc[2 * p] * inv, acc[2 * p + 1] * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const void* kv_len,
                   int batch, int sq, int skv, int heads, int kv_heads, int d, int causal,
                   int window, int has_softcap, float softcap, float scale,
                   int q_offset_from_kv_len, cudaStream_t stream) {
  const long long rows = (long long)batch * heads * sq;
  if (rows == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const int np = d / (2 * kTeam);
#define FA_LAUNCH(MAXP)                                                              \
  flash_attention_kernel<T, MAXP><<<blocks, kThreads, 0, stream>>>(                  \
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), \
      static_cast<T*>(o), static_cast<const int*>(kv_len), sq, skv, heads, kv_heads, \
      d, causal, window, has_softcap, softcap, scale, q_offset_from_kv_len, rows)
  if (np <= 1) FA_LAUNCH(1);
  else if (np <= 2) FA_LAUNCH(2);
  else if (np <= 4) FA_LAUNCH(4);
  else if (np <= 8) FA_LAUNCH(8);
  else FA_LAUNCH(16);
#undef FA_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  The wrapper
// (kernel.py) has checked devices, dtypes, shapes, contiguity and D (a
// multiple of 16, at most 256).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   const void* kv_len, int batch, int sq, int skv, int heads,
                                   int kv_heads, int d, int causal, int window, int has_softcap,
                                   float softcap, float scale, int q_offset_from_kv_len,
                                   int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(q, k, v, o, kv_len, batch, sq, skv, heads, kv_heads, d,
                                      causal, window, has_softcap, softcap, scale,
                                      q_offset_from_kv_len, s);
  return (int)launch<float>(q, k, v, o, kv_len, batch, sq, skv, heads, kv_heads, d, causal,
                            window, has_softcap, softcap, scale, q_offset_from_kv_len, s);
}
