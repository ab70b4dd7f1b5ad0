// Mamba-2 SSD intra-chunk term for NVIDIA Hopper (sm_90a).
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
// What bounds it: at the mamba2-370m prefill shape (B 2, S 4096, H 32, P 64,
// N 128, Q 256) the function moves ~0.14 GB (x bf16, y and S f32) but does
// ~17 GFLOP of f32 products (C.B^T over the lower triangle, W.X, X^T.B), so
// on the CUDA cores (67 TFLOP/s f32) operations bound it; the same products
// in bf16 on the tensor cores (wgmma) would make it byte-bound, which is
// later work.  At the cascade's 8 tokens bytes bound it.
//
// Design:
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
//     packed kernel instead: one block per 64 / Q heads, C.B^T computed once
//     for all of them (B and C are shared), and W.X over 64 packed (head, i)
//     rows.  One block per head there left 7 of 8 warps idle, repeated
//     C.B^T for every head and ran 37x its byte bound.

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
// backbone's 8 tokens): one block per (b, chunk, group of G = 64 / Q heads).
// C.B^T is computed ONCE for the G heads (B and C are shared by all heads)
// and kept in the registers of the threads whose 4 x 4 tile it is; the G
// heads' decay weights then fill the 64 packed rows (head, i) of one W tile,
// and W.X runs over all of them at once, each thread's 4 rows inside one
// head.  A kernel block per head would leave 7 of its 8 warps idle at Q = 8
// and repeat C.B^T for every head.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_intra_chunk_packed_kernel(Args g) {
  __shared__ __align__(16) float As[kT * kLd];
  __shared__ __align__(16) float Bs[kT * kLd];
  __shared__ float cum[kT];  // packed (head, i)
  __shared__ float dts[kT];
  __shared__ float xscale[kT];

  const int tid = threadIdx.x;
  const int Q = g.chunk, P = g.p, N = g.n;
  const int heads_per_block = kT / Q;
  const int groups = (g.heads + heads_per_block - 1) / heads_per_block;
  const int ci = (int)(blockIdx.x % g.nc);
  const long long rest = blockIdx.x / g.nc;
  const int h0 = (int)(rest % groups) * heads_per_block;
  const long long b = rest / groups;
  const int nh = min(heads_per_block, g.heads - h0);
  const int rows = nh * Q;
  const long long t0 = (long long)ci * Q;

  const T* x = static_cast<const T*>(g.x) + b * g.sxb + t0 * g.sxt + h0 * g.sxh;
  const T* B = static_cast<const T*>(g.b) + b * g.sbb + t0 * g.sbt;
  const T* C = static_cast<const T*>(g.c) + b * g.scb + t0 * g.sct;

  // ---- 1. segmented inclusive scans of dt * a, one segment of Q lanes a head
  // (Q divides 32, so no segment crosses a warp; warps 0 and 1 hold the 64 rows)
  if (tid < kT) {
    const int hh = tid / Q, i = tid % Q;
    float d = 0.f, v = 0.f;
    if (hh < nh) {
      d = g.dt[b * g.sdb + (t0 + i) * g.sdt + (long long)(h0 + hh) * g.sdh];
      v = d * g.a[b * g.sab + (long long)(h0 + hh) * g.sah];
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (off < Q && i >= off) v += u;
    }
    cum[tid] = v;
    dts[tid] = d;
    if (hh < nh) g.ce[(b * g.heads + h0 + hh) * g.seq + t0 + i] = expf(v);
  }
  __syncthreads();
  if (tid < kT) xscale[tid] = dts[tid] * expf(cum[(tid / Q) * Q + Q - 1] - cum[tid]);

  // ---- 2. C.B^T once for the block's heads (rows and columns < Q)
  const int r0 = (tid >> 4) * 4, c0 = (tid & 15) * 4;
  const bool holds_cb = r0 < Q && c0 < Q;
  float sacc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) sacc[r][cc] = 0.f;
  for (int n0 = 0; n0 < N; n0 += kT) {
    const int nn = min(kT, N - n0);
    __syncthreads();
    load_transposed(As, C + n0, Q, nn, g.sct);  // As[n][i]
    load_transposed(Bs, B + n0, Q, nn, g.sbt);  // Bs[n][j]
    __syncthreads();
    if (holds_cb) tile_product(As, Bs, nn, r0, c0, sacc);
  }
  __syncthreads();
  // every head's W into As, k-major in j: As[j][hh * Q + i], masked before exp
  if (holds_cb) {
    for (int hh = 0; hh < nh; ++hh) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int i = r0 + r, j = c0 + cc;
          float w = 0.f;
          if (j <= i) w = expf(cum[hh * Q + i] - cum[hh * Q + j]) * sacc[r][cc] * dts[hh * Q + j];
          As[j * kLd + hh * Q + i] = w;
        }
      }
    }
  }

  // ---- 3. y over the packed rows: y[(hh, i)][p] = sum_j W[j][(hh, i)] x_hh[j][p]
  const long long y_row = (long long)g.heads * P;
  float* y = g.y + ((b * g.seq + t0) * g.heads + h0) * P;
#pragma unroll
  for (int pb = 0; pb < kMaxPBlocks; ++pb) {
    if (pb * kT < P) {
      const int npb = min(kT, P - pb * kT);
      __syncthreads();
      for (int e = tid; e < rows * npb; e += kThreads) {  // Bs[hh * Q + j][p]
        const int row = e / npb, pp = e % npb;
        Bs[row * kLd + pp] = to_f32(x[(row % Q) * g.sxt + (long long)(row / Q) * g.sxh +
                                      pb * kT + pp]);
      }
      __syncthreads();
      if (r0 < rows && c0 < npb) {
        const int hh = r0 / Q;  // the thread's 4 rows lie in one head (Q % 4 == 0)
        float acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.f;
        tile_product(As, Bs + hh * Q * kLd, Q, r0, c0, acc);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = (r0 + r) - hh * Q;
          *reinterpret_cast<float4*>(y + i * y_row + (long long)hh * P + pb * kT + c0) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        }
      }
    }
  }

  // ---- 4. each head's state contribution, when wanted
  if (ci >= g.nc_state) return;
  for (int hh = 0; hh < nh; ++hh) {
    chunk_state(As, Bs, x + (long long)hh * g.sxh, B, xscale + hh * Q, Q, P, N, g.sxt, g.sbt,
                g.s + (((b * g.heads + h0 + hh) * g.nc_state + ci) * (long long)P) * N);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  The wrapper
// (kernel.py) has checked devices, dtypes, shapes and strides: chunk <= 256
// divides seq, P <= 128, P and N multiples of 4, innermost strides 1.
extern "C" int ssd_intra_chunk_fwd(
    const void* x, const void* dt, const void* a, const void* b, const void* c, void* y,
    void* s, void* ce, int batch, int seq, int heads, int p, int n, int chunk, int nc_state,
    long long sxb, long long sxt, long long sxh, long long sdb, long long sdt, long long sdh,
    long long sab, long long sah, long long sbb, long long sbt, long long scb, long long sct,
    int is_bf16, void* stream) {
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
    const int per_block = kT / chunk;
    const long long blocks = (long long)batch * ((heads + per_block - 1) / per_block) * g.nc;
    if (blocks == 0) return 0;
    if (is_bf16)
      ssd_intra_chunk_packed_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, st>>>(g);
    else
      ssd_intra_chunk_packed_kernel<float><<<(unsigned)blocks, kThreads, 0, st>>>(g);
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
