// Mamba-2 SSD intra-chunk term for NVIDIA Hopper (sm_90a): the "simt" and
// "packed" routes (bf16 chunks of 64 to 256 with P, N in {64, 128} take the
// tensor-core kernel, ssd_scan_tc.cu; kernel.py:route picks).
//
// Replaces the reference's Pallas TPU kernel
// src/repro/kernels/ssd_scan/kernel.py:ssd_intra_chunk (body _ssd_kernel).
// It computes that kernel's function, not its blocks.  For one (batch, head,
// chunk) of Q positions, with a < 0 the head's decay rate:
//
//   cum_i     = sum_{t <= i} dt_t * a                       (inclusive scan)
//   y_i       = sum_{j <= i} exp(cum_i - cum_j) (C_i . B_j) dt_j x_j
//   S         = sum_j (x_j * dt_j * exp(cum_{Q-1} - cum_j)) B_j^T    [P, N]
//   cumexp_i  = exp(cum_i)
//
// y and S feed the inter-chunk recurrence (ops.py, PyTorch).  All math is f32;
// x, B and C load as f32 or bf16, dt and a as f32.
//
// Layout (the model's, read in place through strides, innermost stride 1):
// x [B, S, H, P], dt [B, S, H], a [B, H] (a head stride of 1 and a batch
// stride of 0 in the model), B and C [B, S, N]: ONE group shared by the H
// heads, so the model passes them with no H-fold copy.  The reference
// kernel's [BH, ...] layout is the same call with H = 1.  Outputs, contiguous:
// y [B, S, H, P], S [B, H, nc_state, P, N], cumexp [B, H, S].  nc_state is nc,
// or nc - 1 when the caller wants no final state: the last chunk's S then is
// neither computed nor written.  At the cascade backbone's 8 tokens (nc = 1)
// that is the whole [BH, P, N] f32 output, 16x the bytes of y.
//
// What bounds it: at a chunk of 256 (B 2, S 4096, H 32, P 64, N 128) the
// function moves ~0.14 GB but does ~17 GFLOP of f32 products (C.B^T over
// the lower triangle, W.X, X^T.B), so on the CUDA cores (67 TFLOP/s f32)
// operations bound this kernel; the tc route runs bf16 inputs on the
// tensor cores.  At the cascade's 8 tokens bytes bound it.
//
// Design (simt, any chunk up to 256; f32 inputs and shapes tc does not take):
//   * One 256-thread block per (b, h, chunk); Q <= 256, so the scan of dt*a
//     is one value a thread: warp shuffles, then a scan of the 8 warp
//     totals.  The TPU's tril-ones matmul for the cumsum goes.
//   * The three products are 64 x 64 output tiles, each thread a 4 x 4
//     register tile, fed from two k-major shared-memory tiles (padded rows
//     of 68 floats keep the float4 reads aligned).  C.B^T runs over the
//     j-tiles up to the diagonal only, N in steps of 64.
//   * The decay weight is masked to j <= i BEFORE exp: exp(cum_i - cum_j)
//     for j > i overflows to inf, and inf * 0 would be NaN.
//   * A thread whose 4 x 4 tile lies outside the chunk, the head dim or the
//     state dim skips the products.
//   * Chunks of 4, 8, 16 or 32 positions (the cascade's 8 tokens) take the
//     packed kernel instead (below): one block per lane covering all heads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 64;       // output tile edge
constexpr int kLd = kT + 4;  // padded shared-memory row (multiple of 4 floats)
constexpr int kMaxChunk = 256;
constexpr int kMaxPBlocks = 2;  // P <= 128

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Args {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  float* y;
  float* s;
  float* ce;
  int seq, heads, p, n, chunk, nc, nc_state;
  long long sxb, sxt, sxh;  // x strides (elements)
  long long sdb, sdt, sdh;  // dt strides
  long long sab, sah;       // a strides
  long long sbb, sbt;       // B strides
  long long scb, sct;       // C strides
};

// acc[r][c] += sum_{k < kk} A[k][r0 + r] * B[k][c0 + c] over k-major tiles.
__device__ __forceinline__ void tile_product(const float* A, const float* B, int kk, int r0,
                                             int c0, float acc[4][4]) {
  for (int k = 0; k < kk; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(A + k * kLd + r0);
    const float4 bv = *reinterpret_cast<const float4*>(B + k * kLd + c0);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[r][cc] = fmaf(ar[r], br[cc], acc[r][cc]);
    }
  }
}

// dst[k][r] = src[r * row_stride + k] for r < rows, k < cols (a transposed load).
template <typename T>
__device__ __forceinline__ void load_transposed(float* dst, const T* src, int rows, int cols,
                                                long long row_stride) {
  for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
    const int r = e / cols, k = e % cols;
    dst[k * kLd + r] = to_f32(src[r * row_stride + k]);
  }
}

// dst[r][k] = src[r * row_stride + k] * (scale ? scale[r] : 1) for r < rows, k < cols.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int rows, int cols,
                                          long long row_stride, const float* scale) {
  for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
    const int r = e / cols, k = e % cols;
    const float v = to_f32(src[r * row_stride + k]);
    dst[r * kLd + k] = scale ? v * scale[r] : v;
  }
}

// S[p][n] = sum_{j < Q} x_j[p] xscale_j B_j[n], one chunk and head, into s
// ([P, N] f32, contiguous).  Every thread of the block calls it.
template <typename T>
__device__ void chunk_state(float* As, float* Bs, const T* x, const T* B, const float* xscale,
                            int Q, int P, int N, long long sxt, long long sbt, float* s) {
  const int r0 = (threadIdx.x >> 4) * 4, c0 = (threadIdx.x & 15) * 4;
  for (int p0 = 0; p0 < P; p0 += kT) {
    const int npb = min(kT, P - p0);
    for (int n0 = 0; n0 < N; n0 += kT) {
      const int nn = min(kT, N - n0);
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.f;
      for (int j0 = 0; j0 < Q; j0 += kT) {
        const int nj = min(kT, Q - j0);
        __syncthreads();
        load_rows(As, x + j0 * sxt + p0, nj, npb, sxt, xscale + j0);  // As[j][p]
        load_rows(Bs, B + j0 * sbt + n0, nj, nn, sbt, (const float*)nullptr);  // Bs[j][n]
        __syncthreads();
        if (r0 < npb && c0 < nn) tile_product(As, Bs, nj, r0, c0, acc);
      }
      if (r0 < npb && c0 < nn) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          *reinterpret_cast<float4*>(s + (long long)(p0 + r0 + r) * N + n0 + c0) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_intra_chunk_kernel(Args g) {
  __shared__ __align__(16) float As[kT * kLd];
  __shared__ __align__(16) float Bs[kT * kLd];
  __shared__ float cum[kMaxChunk];
  __shared__ float dts[kMaxChunk];
  __shared__ float xscale[kMaxChunk];  // dt_j * exp(cum_{Q-1} - cum_j)
  __shared__ float warp_total[kWarps];

  const int tid = threadIdx.x;
  const int ci = (int)(blockIdx.x % g.nc);
  const long long bh = blockIdx.x / g.nc;
  const int h = (int)(bh % g.heads);
  const long long b = bh / g.heads;
  const int Q = g.chunk, P = g.p, N = g.n;
  const long long t0 = (long long)ci * Q;

  const T* x = static_cast<const T*>(g.x) + b * g.sxb + t0 * g.sxt + h * g.sxh;
  const float* dt = g.dt + b * g.sdb + t0 * g.sdt + h * g.sdh;
  const T* B = static_cast<const T*>(g.b) + b * g.sbb + t0 * g.sbt;
  const T* C = static_cast<const T*>(g.c) + b * g.scb + t0 * g.sct;
  const float a = g.a[b * g.sab + h * g.sah];

  // ---- 1. inclusive scan of dt * a over the chunk
  const int lane = tid & 31, warp = tid >> 5;
  float d = 0.f, v = 0.f;
  if (tid < Q) {
    d = dt[tid * g.sdt];
    v = d * a;
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) warp_total[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kWarps ? warp_total[lane] : 0.f;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += u;
    }
    if (lane < kWarps) warp_total[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += warp_total[warp - 1];
  if (tid < Q) {
    cum[tid] = v;
    dts[tid] = d;
    g.ce[bh * g.seq + t0 + tid] = expf(v);
  }
  __syncthreads();
  if (tid < Q) xscale[tid] = dts[tid] * expf(cum[Q - 1] - cum[tid]);
  // (xscale is read after the first __syncthreads of a later stage)

  const int r0 = (tid >> 4) * 4, c0 = (tid & 15) * 4;
  const long long y_row = (long long)g.heads * P;
  float* y = g.y + ((b * g.seq + t0) * g.heads + h) * P;

  // ---- 2. y_i = sum_{j <= i} W_ij x_j, W = mask(exp(cum_i - cum_j)) (C_i . B_j) dt_j
  for (int i0 = 0; i0 < Q; i0 += kT) {
    const int ni = min(kT, Q - i0);
    float yacc[kMaxPBlocks][4][4];
#pragma unroll
    for (int pb = 0; pb < kMaxPBlocks; ++pb)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) yacc[pb][r][cc] = 0.f;

    for (int j0 = 0; j0 <= i0; j0 += kT) {
      const int nj = min(kT, Q - j0);
      float sacc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) sacc[r][cc] = 0.f;
      for (int n0 = 0; n0 < N; n0 += kT) {
        const int nn = min(kT, N - n0);
        __syncthreads();
        load_transposed(As, C + i0 * g.sct + n0, ni, nn, g.sct);  // As[n][i]
        load_transposed(Bs, B + j0 * g.sbt + n0, nj, nn, g.sbt);  // Bs[n][j]
        __syncthreads();
        if (r0 < ni && c0 < nj) tile_product(As, Bs, nn, r0, c0, sacc);
      }
      __syncthreads();
      // W into As, k-major in j: As[j][i]; zero outside the chunk and above
      // the diagonal, and the exponent masked before exp
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int i = r0 + r, j = c0 + cc;
          float w = 0.f;
          if (i < ni && j < nj && j0 + j <= i0 + i) {
            w = expf(cum[i0 + i] - cum[j0 + j]) * sacc[r][cc] * dts[j0 + j];
          }
          As[j * kLd + i] = w;
        }
      }
#pragma unroll
      for (int pb = 0; pb < kMaxPBlocks; ++pb) {
        if (pb * kT < P) {
          const int npb = min(kT, P - pb * kT);
          __syncthreads();
          load_rows(Bs, x + j0 * g.sxt + pb * kT, nj, npb, g.sxt, (const float*)nullptr);
          __syncthreads();
          if (r0 < ni && c0 < npb) tile_product(As, Bs, nj, r0, c0, yacc[pb]);
        }
      }
    }
#pragma unroll
    for (int pb = 0; pb < kMaxPBlocks; ++pb) {
      if (pb * kT + c0 < P) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (r0 + r < ni) {
            *reinterpret_cast<float4*>(y + (i0 + r0 + r) * y_row + pb * kT + c0) =
                make_float4(yacc[pb][r][0], yacc[pb][r][1], yacc[pb][r][2], yacc[pb][r][3]);
          }
        }
      }
    }
  }

  // ---- 3. the chunk's state contribution
  if (ci >= g.nc_state) return;  // the last chunk's state is not wanted
  chunk_state(As, Bs, x, B, xscale, Q, P, N, g.sxt, g.sbt,
              g.s + ((bh * g.nc_state + ci) * (long long)P) * N);
}

// The packed kernel for chunks of Q in {4, 8, 16, 32} positions (the cascade
// backbone's 8 tokens): bytes bound it (at 512 lanes x 8 tokens, H 32, P 64,
// N 128 it reads 19 MB of x and writes 34 MB of y, and does 0.05 GFLOP).
// One block per lane (b, chunk) covers ALL H heads, so C.B^T is computed
// once a lane (B and C are shared by the heads).  B, C, dt, the scans and
// C.B^T sit in shared memory; then for a group of heads at a time (all 32
// at the cascade's shape) the block stages their x rows with 16-byte
// cp.async and their decay weights W[h][i][j] (masked before exp) in shared
// memory, and threads take (head, 4 rows, 16 bytes of P) items of y
// (16-byte shared-memory reads, float4 stores) and, for the state, one warp
// a (head, p) row of S with a lane a float4 of N (512-byte stores).  A block
// holds ~53 KB of shared memory and <= 64 registers a thread at the
// cascade's shape, so four lanes share an SM and their loads are in flight
// together.
constexpr int kPackedStage = 40 * 1024;  // x rows and W of one head group

template <typename T>
__host__ __device__ inline int packed_heads(int q, int p, int heads) {
  const int per_head = q * p * static_cast<int>(sizeof(T)) + q * q * 4;
  const int hg = kPackedStage / per_head;
  return hg < 1 ? 1 : hg > heads ? heads : hg;
}

template <typename T>
__host__ __device__ inline size_t packed_smem(int q, int p, int n, int heads) {
  const int hg = packed_heads<T>(q, p, heads);
  const size_t xs = ((size_t)hg * q * p * sizeof(T) + 15) / 16 * 16;
  return xs + (2 * (size_t)q * (n + 4) + (size_t)q * q + 3 * (size_t)heads * q +
               (size_t)hg * q * q) * sizeof(float);
}

// CW values of T from shared memory (16 bytes when vec), zero past `valid`
template <typename T>
__device__ __forceinline__ void read_vec(const T* p, float* out, int valid, bool vec);

template <>
__device__ __forceinline__ void read_vec<float>(const float* p, float* out, int valid, bool vec) {
  if (vec) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    return;
  }
  for (int c = 0; c < 4; ++c) out[c] = c < valid ? p[c] : 0.f;
}

template <>
__device__ __forceinline__ void read_vec<__nv_bfloat16>(const __nv_bfloat16* p, float* out,
                                                        int valid, bool vec) {
  if (vec) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
    return;
  }
  for (int c = 0; c < 8; ++c) out[c] = c < valid ? __bfloat162float(p[c]) : 0.f;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// vec: x's base and strides keep 16-byte rows aligned and P is a multiple
// of 16 bytes of T (else scalar loads and stores).
template <typename T>
__global__ void __launch_bounds__(kThreads, 4) ssd_intra_chunk_packed_kernel(Args g, int vec) {
  extern __shared__ __align__(16) unsigned char pk_smem[];
  constexpr int CW = 16 / sizeof(T);  // P values an item holds: 16 bytes of x
  const int Q = g.chunk, P = g.p, N = g.n, H = g.heads;
  const int HG = packed_heads<T>(Q, P, H);
  const int ldn = N + 4;  // rows keep 16-byte alignment; bank-shifted for C.B^T
  T* Xs = reinterpret_cast<T*>(pk_smem);  // [Q][HG][P]
  float* Bs = reinterpret_cast<float*>(pk_smem + ((size_t)HG * Q * P * sizeof(T) + 15) / 16 * 16);
  float* Cs = Bs + Q * ldn;   // [Q][ldn]
  float* CB = Cs + Q * ldn;   // [Q][Q]
  float* cum = CB + Q * Q;    // [H][Q]
  float* dts = cum + H * Q;   // [H][Q]
  float* xsc = dts + H * Q;   // [H][Q]: dt_j * exp(cum_{Q-1} - cum_j)
  float* W = xsc + H * Q;     // [HG][Q][Q]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ci = static_cast<int>(blockIdx.x % g.nc);
  const long long b = blockIdx.x / g.nc;
  const long long t0 = (long long)ci * Q;
  const T* x = static_cast<const T*>(g.x) + b * g.sxb + t0 * g.sxt;
  const T* Bg = static_cast<const T*>(g.b) + b * g.sbb + t0 * g.sbt;
  const T* Cg = static_cast<const T*>(g.c) + b * g.scb + t0 * g.sct;

  // ---- 1. B, C and dt of the lane
  for (int e = tid; e < Q * N; e += kThreads) {
    const int i = e / N, n = e - i * N;
    Bs[i * ldn + n] = to_f32(Bg[i * g.sbt + n]);
    Cs[i * ldn + n] = to_f32(Cg[i * g.sct + n]);
  }
  for (int e = tid; e < Q * H; e += kThreads) {
    const int i = e / H, h = e - i * H;
    dts[h * Q + i] = g.dt[b * g.sdb + (t0 + i) * g.sdt + (long long)h * g.sdh];
  }
  __syncthreads();

  // ---- 2. each head's scan of dt * a (a thread a head), cumexp, the tail
  // scale; C.B^T once for all heads (the lower triangle)
  for (int h = tid; h < H; h += kThreads) {
    const float av = g.a[b * g.sab + (long long)h * g.sah];
    float v = 0.f;
    for (int i = 0; i < Q; ++i) {
      v += dts[h * Q + i] * av;
      cum[h * Q + i] = v;
      g.ce[(b * H + h) * g.seq + t0 + i] = expf(v);
    }
    for (int i = 0; i < Q; ++i) xsc[h * Q + i] = dts[h * Q + i] * expf(v - cum[h * Q + i]);
  }
  for (int e = tid; e < Q * Q; e += kThreads) {
    const int i = e / Q, j = e - i * Q;
    float acc = 0.f;
    if (j <= i)
      for (int n = 0; n < N; ++n) acc = fmaf(Cs[i * ldn + n], Bs[j * ldn + n], acc);
    CB[e] = acc;
  }
  __syncthreads();

  const int npc = (P + CW - 1) / CW;
  const long long yrow = (long long)H * P;
  float* y = g.y + (b * g.seq + t0) * yrow;
  const bool state = ci < g.nc_state;
  for (int h0 = 0; h0 < H; h0 += HG) {
    const int nh = min(HG, H - h0);
    // ---- 3. the group's x rows (16-byte cp.async) and decay weights
    if (vec) {
      const int chunks = nh * P / CW;
      for (int e = tid; e < Q * chunks; e += kThreads) {
        const int j = e / chunks, r = e - j * chunks;
        const int hh = r * CW / P, p = r * CW - hh * P;
        cp_async16(Xs + (j * HG + hh) * P + p, x + j * g.sxt + (long long)(h0 + hh) * g.sxh + p);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    } else {
      for (int e = tid; e < Q * nh * P; e += kThreads) {
        const int j = e / (nh * P), r = e - j * nh * P;
        const int hh = r / P, p = r - hh * P;
        Xs[(j * HG + hh) * P + p] = x[j * g.sxt + (long long)(h0 + hh) * g.sxh + p];
      }
    }
    for (int e = tid; e < nh * Q * Q; e += kThreads) {
      const int hh = e / (Q * Q), ij = e - hh * Q * Q;
      const int i = ij / Q, j = ij - i * Q;
      const float* ch = cum + (h0 + hh) * Q;
      // masked before exp: exp(-inf) = 0
      W[e] = expf(j <= i ? ch[i] - ch[j] : -INFINITY) * CB[ij] * dts[(h0 + hh) * Q + j];
    }
    if (vec) asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    // ---- 4. y: an item is (head, 4 rows, CW values of P)
    const int nib = (Q + 3) / 4;
    for (int item = tid; item < nh * nib * npc; item += kThreads) {
      const int pc = item % npc, rest = item / npc;
      const int ib = rest % nib, hh = rest / nib;
      const int p0 = pc * CW, i0 = ib * 4, valid = min(CW, P - p0);
      const float* w = W + hh * Q * Q;
      float acc[4][CW];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[r][c] = 0.f;
      const int jend = min(i0 + 4, Q);
      for (int j = 0; j < jend; ++j) {
        float xv[CW];
        read_vec<T>(Xs + (j * HG + hh) * P + p0, xv, valid, vec);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float wr = i0 + r < Q ? w[(i0 + r) * Q + j] : 0.f;  // 0 above the diagonal
#pragma unroll
          for (int c = 0; c < CW; ++c) acc[r][c] = fmaf(wr, xv[c], acc[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (i0 + r >= Q) break;
        float* yo = y + (i0 + r) * yrow + (long long)(h0 + hh) * P + p0;
        if (vec) {
#pragma unroll
          for (int c = 0; c < CW; c += 4)
            *reinterpret_cast<float4*>(yo + c) =
                make_float4(acc[r][c], acc[r][c + 1], acc[r][c + 2], acc[r][c + 3]);
        } else {
          for (int c = 0; c < valid; ++c) yo[c] = acc[r][c];
        }
      }
    }

    // ---- 5. the group's state contributions, when wanted: a warp a (head, p)
    // row of S, a lane a float4 of N
    if (state) {
      for (int row = warp; row < nh * P; row += kWarps) {
        const int hh = row / P, p = row - hh * P;
        const int h = h0 + hh;
        float* so = g.s + (((b * H + h) * g.nc_state + ci) * (long long)P + p) * N;
        for (int n4 = lane; n4 < N / 4; n4 += 32) {
          float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
          for (int j = 0; j < Q; ++j) {
            const float xw = to_f32(Xs[(j * HG + hh) * P + p]) * xsc[h * Q + j];
            const float4 bv = *reinterpret_cast<const float4*>(Bs + j * ldn + 4 * n4);
            acc.x = fmaf(xw, bv.x, acc.x);
            acc.y = fmaf(xw, bv.y, acc.y);
            acc.z = fmaf(xw, bv.z, acc.z);
            acc.w = fmaf(xw, bv.w, acc.w);
          }
          *reinterpret_cast<float4*>(so + 4 * n4) = acc;
        }
      }
    }
    __syncthreads();  // Xs and W are restaged for the next group
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  The wrapper
// (kernel.py) has checked devices, dtypes, shapes and strides: chunk <= 256
// divides seq, P <= 128, P and N multiples of 4, innermost strides 1;
// vec_x: x's rows allow 16-byte loads (the packed kernel reads it).
extern "C" int ssd_intra_chunk_fwd(
    const void* x, const void* dt, const void* a, const void* b, const void* c, void* y,
    void* s, void* ce, int batch, int seq, int heads, int p, int n, int chunk, int nc_state,
    long long sxb, long long sxt, long long sxh, long long sdb, long long sdt, long long sdh,
    long long sab, long long sah, long long sbb, long long sbt, long long scb, long long sct,
    int is_bf16, int vec_x, void* stream) {
  Args g;
  g.x = x;
  g.dt = static_cast<const float*>(dt);
  g.a = static_cast<const float*>(a);
  g.b = b;
  g.c = c;
  g.y = static_cast<float*>(y);
  g.s = static_cast<float*>(s);
  g.ce = static_cast<float*>(ce);
  g.seq = seq;
  g.heads = heads;
  g.p = p;
  g.n = n;
  g.chunk = chunk;
  g.nc = seq / chunk;
  g.nc_state = nc_state;
  g.sxb = sxb; g.sxt = sxt; g.sxh = sxh;
  g.sdb = sdb; g.sdt = sdt; g.sdh = sdh;
  g.sab = sab; g.sah = sah;
  g.sbb = sbb; g.sbt = sbt;
  g.scb = scb; g.sct = sct;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunk == 4 || chunk == 8 || chunk == 16 || chunk == 32) {
    const long long blocks = (long long)batch * g.nc;
    if (blocks == 0) return 0;
    if (is_bf16) {
      const size_t smem = packed_smem<__nv_bfloat16>(chunk, p, n, heads);
      if (smem > 48 * 1024 && cudaFuncSetAttribute(ssd_intra_chunk_packed_kernel<__nv_bfloat16>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(smem)) != cudaSuccess)
        return (int)cudaGetLastError();
      ssd_intra_chunk_packed_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, smem, st>>>(
          g, vec_x);
    } else {
      const size_t smem = packed_smem<float>(chunk, p, n, heads);
      if (smem > 48 * 1024 && cudaFuncSetAttribute(ssd_intra_chunk_packed_kernel<float>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(smem)) != cudaSuccess)
        return (int)cudaGetLastError();
      ssd_intra_chunk_packed_kernel<float><<<(unsigned)blocks, kThreads, smem, st>>>(g, vec_x);
    }
    return (int)cudaGetLastError();
  }
  const long long blocks = (long long)batch * heads * g.nc;
  if (blocks == 0) return 0;
  if (is_bf16)
    ssd_intra_chunk_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, st>>>(g);
  else
    ssd_intra_chunk_kernel<float><<<(unsigned)blocks, kThreads, 0, st>>>(g);
  return (int)cudaGetLastError();
}
