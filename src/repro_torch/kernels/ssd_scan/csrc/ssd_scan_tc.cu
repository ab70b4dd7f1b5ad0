// Mamba-2 SSD intra-chunk term on Hopper's tensor cores (sm_90a): the "tc" route.
//
// Replaces the reference's Pallas TPU kernel
// src/repro/kernels/ssd_scan/kernel.py:ssd_intra_chunk (body _ssd_kernel)
// for bf16 x, B and C, chunks of 64, 128 or 256 positions, head dim P of 64
// or 128 and state dim N of 16, 64 or 128.  It computes that kernel's
// function; for one (batch, head, chunk) of Q positions, with a < 0 the
// head's decay rate:
//
//   cum_i     = sum_{t <= i} dt_t * a                       (inclusive scan)
//   y_i       = sum_{j <= i} exp(cum_i - cum_j) (C_i . B_j) dt_j x_j
//   S         = sum_j (x_j * dt_j * exp(cum_{Q-1} - cum_j)) B_j^T    [P, N]
//   cumexp_i  = exp(cum_i)
//
// Layout, read in place through strides (innermost stride 1, rows 16-byte
// aligned): x [B, S, H, P], dt [B, S, H] f32, a [B, H] f32, B and C [B, S, N]
// (one group shared by the H heads).  Outputs, contiguous f32: y [B, S, H, P],
// S [B, H, nc_state, P, N] (nc_state is nc, or nc - 1 when the last chunk's
// state is not wanted), cumexp [B, H, S].
//
// Arithmetic: mma.sync m16n8k16, bf16 operands, f32 accumulation.
//   * C.B^T: C and B are bf16, so each product is exact in f32 and one bf16
//     product per tile gives the reference's f32 dot_general up to the order
//     of the sums.
//   * W.X and X^T.B have one f32 operand, W = mask(exp(cum_i - cum_j)) C.B^T dt_j
//     and xw = x dt tail.  It is split into bf16 hi + lo (hi = bf16(w), lo =
//     bf16(w - hi)) and the two products summed: about 2^-16 of |w| is lost,
//     within the f32 twin's 1e-4 of the output's scale.
//   * The decay is masked to j <= i BEFORE exp (exp(-inf) = 0): exp(cum_i -
//     cum_j) for j > i overflows, and inf * 0 would be NaN.  k16 steps wholly
//     above the diagonal are skipped.
//
// What bounds it: at the mamba2-370m prefill shape (B 2, S 4096, H 32, P 64,
// N 128, Q 256) the function moves ~0.14 GB (x bf16, y and S f32), ~0.042 ms
// at 3.35 TB/s; the products (with the hi / lo splits and C.B^T once per head
// group) are ~19 GFLOP, ~0.02 ms at the bf16 tensor-core peak.  Bytes bound.
//
// Design:
//   * One 256-thread block (8 warps) per (b, chunk, group of 256 / P heads:
//     4 at P 64, 2 at P 128): C.B^T is computed once for the heads of the
//     group, which share B and C (8 times a chunk at H 32, not 32), and the
//     prefill still has 256 blocks for 132 SMs.  A cluster sharing C.B^T
//     across all heads would cut that to once a chunk but leave 32 (b,
//     chunk) pairs to spread C.B^T over; the head group keeps the kernel to
//     plain shared memory.
//   * y, one 64-row i-tile at a time, in one loop over its j-tiles: the C
//     rows, the B j-tile and the group's X j-tiles arrive by 16-byte
//     cp.async into padded shared memory (rows of N + 8 and P + 8 halves:
//     conflict-free ldmatrix), the next j-tile in flight while this one is
//     multiplied.  The 8 warps compute the 64 x 64 C.B^T tile into shared
//     memory (f32); then each warp (16 rows, 256 / P / 2 heads) builds W in
//     registers straight from that tile in the A-fragment layout, splits it
//     hi / lo and multiplies the X tile (ldmatrix.trans) into f32
//     accumulators that live across the j-tiles: 64 values a thread.  y
//     leaves as float2 stores from the fragments.  Two barriers a j-tile.
//   * The chunk's state: for each head, xw^T (ldmatrix.trans of X, scaled
//     and split in registers) times B over the Q positions, P / 16 warps a
//     head, 16 rows of P and all N columns a warp, double-buffered too.
//   * N 16 (hymba's SSD heads): C.B^T is one k16 step and the state two n8
//     tiles; a row of C or B is 24 halves (48 B: the eight rows of an
//     ldmatrix start 12 banks apart, so none conflict).  C.B^T is then ~1/8
//     of a head's W.X products, so sharing it over many heads saves little,
//     and the head group shrinks to heads_a_block(P, 16) = SSD_TC_HEADS_N16
//     = 2 heads, two blocks an SM (blocks_an_sm: 128 registers a thread):
//     at hymba's prefill (S 2,048, H 50, P 64: 1 x 8 chunks x 25 groups =
//     200 blocks, one wave on 132 SMs) 0.046 ms on an H100, against 0.054
//     with 4 heads (104 blocks, one an SM) and 0.071 with 1 (400 blocks).
//     With one head a block the 8 warps of the y loop split P in two
//     halves instead of the heads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 64;      // i / j tile edge
constexpr int kLdt = kT + 8;  // a C.B^T tile's padded f32 row
constexpr int kMaxChunk = 256;

// Heads a block: the y accumulators of a 64-row i-tile for all of them, 64
// values a thread (4 heads at P 64, 2 at P 128); at N 16 at most
// SSD_TC_HEADS_N16 (1, 2 or 4; a build flag, so that the three can be timed).
#ifndef SSD_TC_HEADS_N16
#define SSD_TC_HEADS_N16 2
#endif
__host__ __device__ constexpr int heads_a_block(int p, int n) {
  return n == 16 && SSD_TC_HEADS_N16 < 256 / p ? SSD_TC_HEADS_N16 : 256 / p;
}
// Blocks an SM holds: two where a thread's y accumulators are 32 floats or
// fewer (a smaller head group at N 16; 128 registers a thread), else one.
__host__ __device__ constexpr int blocks_an_sm(int p, int n) {
  return heads_a_block(p, n) * p <= 128 ? 2 : 1;
}

typedef __nv_bfloat16 bf16;

struct Args {
  const bf16* x;
  const float* dt;
  const float* a;
  const bf16* b;
  const bf16* c;
  float* y;
  float* s;
  float* ce;
  int seq, heads, chunk, nc, nc_state;
  long long sxb, sxt, sxh;
  long long sdb, sdt, sdh;
  long long sab, sah;
  long long sbb, sbt;
  long long scb, sct;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
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
// (v0, v1) -> bf16 pairs hi = bf16(v), lo = bf16(v - hi); v0 in the low half
__device__ __forceinline__ void split2(float v0, float v1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}
// a bf16 pair times (s0, s1), split hi / lo
__device__ __forceinline__ void scale_split(unsigned pair, float s0, float s1, unsigned& hi,
                                            unsigned& lo) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pair));
  split2(f.x * s0, f.y * s1, hi, lo);
}

// rows [0, rows) x COLS halves of a strided bf16 matrix into dst [rows][ld]
template <int COLS>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src, long long stride,
                                          int rows) {
  constexpr int kChunks = COLS / 8;
  for (int e = threadIdx.x; e < rows * kChunks; e += kThreads) {
    const int r = e / kChunks, ch = e - r * kChunks;
    cp_async16(dst + r * ld + ch * 8, src + r * stride + ch * 8);
  }
}

__host__ __device__ inline size_t smem_bytes(int p, int n, int q) {
  const int hg = heads_a_block(p, n);
  return 3 * (size_t)kT * (n + 8) * sizeof(bf16)        // C i-tile, two B j-tiles
         + (size_t)kT * kLdt * sizeof(float)            // one C.B^T tile
         + 2 * (size_t)hg * kT * (p + 8) * sizeof(bf16)  // two X j-tiles of each head
         + 3 * (size_t)hg * q * sizeof(float);          // cum, dt, xscale
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, blocks_an_sm(P, N)) ssd_intra_chunk_tc_kernel(Args g) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LDN = N + 8, LDP = P + 8;
  constexpr int kHG = heads_a_block(P, N);  // heads a block
  // the y loop's warps: 4 row groups x 2 halves of the group's heads, or of
  // P's columns when the group is one head
  constexpr int kHW = kHG >= 2 ? kHG / 2 : 1;  // heads a warp
  constexpr int kPW = kHG >= 2 ? P : P / 2;     // columns of P a warp
  const int Q = g.chunk;
  bf16* Cs = reinterpret_cast<bf16*>(smem);  // [kT][LDN]: the C i-tile
  bf16* Bt = Cs + kT * LDN;                  // [2][kT][LDN]: the ring of B j-tiles
  float* CBt = reinterpret_cast<float*>(Bt + 2 * kT * LDN);  // [kT][kLdt]
  bf16* Xs = reinterpret_cast<bf16*>(CBt + kT * kLdt);      // [2][kHG][kT][LDP]
  float* cum = reinterpret_cast<float*>(Xs + 2 * kHG * kT * LDP);
  float* dts = cum + kHG * Q;
  float* xsc = dts + kHG * Q;
  __shared__ float warp_total[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;  // fragment row and column pair
  const int groups = (g.heads + kHG - 1) / kHG;
  const int grp = static_cast<int>(blockIdx.x % groups);
  const long long rest = blockIdx.x / groups;
  const int ci = static_cast<int>(rest % g.nc);
  const long long b = rest / g.nc;
  const int h0 = grp * kHG;
  const int nh = min(kHG, g.heads - h0);
  const long long t0 = (long long)ci * Q;
  const int nt = Q / kT;

  const bf16* X = g.x + b * g.sxb + t0 * g.sxt + (long long)h0 * g.sxh;
  const bf16* B = g.b + b * g.sbb + t0 * g.sbt;
  const bf16* C = g.c + b * g.scb + t0 * g.sct;

  // ---- 1. inclusive scans of dt * a, one per head of the group
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    const float av = g.a[b * g.sab + (long long)h * g.sah];
    float d = 0.f, v = 0.f;
    if (tid < Q) {
      d = g.dt[b * g.sdb + (t0 + tid) * g.sdt + (long long)h * g.sdh];
      v = d * av;
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
      cum[hh * Q + tid] = v;
      dts[hh * Q + tid] = d;
      g.ce[(b * g.heads + h) * g.seq + t0 + tid] = expf(v);
    }
    __syncthreads();
  }
  for (int e = tid; e < nh * Q; e += kThreads) {
    const int hh = e / Q;
    xsc[e] = dts[e] * expf(cum[hh * Q + Q - 1] - cum[e]);
  }

  auto load_b = [&](int jt) {
    load_tile<N>(Bt + (jt & 1) * kT * LDN, LDN, B + (long long)jt * kT * g.sbt, g.sbt, kT);
  };
  auto load_x = [&](int jt, int hp, int nslots) {  // heads hp, hp + 1, .. of the group
    for (int s2 = 0; s2 < nslots && hp + s2 < nh; ++s2)
      load_tile<P>(Xs + ((jt & 1) * kHG + s2) * kT * LDP, LDP,
                   X + (long long)jt * kT * g.sxt + (long long)(hp + s2) * g.sxh, g.sxt, kT);
  };

  // ---- 2. y, one 64-row i-tile at a time: for each j-tile, C.B^T once for
  // the group, then W.X for every head; the next j-tile's B and X are in
  // flight meanwhile.  Warps: 4 row groups x 2 head sets of kHW heads.
  const int rg = warp & 3, hs = warp >> 2, cgp = warp >> 2;
  const int pc = kHG >= 2 ? 0 : hs * kPW;  // this warp's first column of P
  for (int it = 0; it < nt; ++it) {
    const int i_a = it * kT + 16 * rg + gq, i_b = i_a + 8;  // this thread's rows
    float yacc[kHW][kPW / 8][4] = {};
    __syncthreads();  // Cs and the ring are free
    load_tile<N>(Cs, LDN, C + (long long)it * kT * g.sct, g.sct, kT);
    load_b(0);
    load_x(0, 0, kHG);
    cp_async_commit();
    for (int jt = 0; jt <= it; ++jt) {
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();  // tile jt has landed; every warp is done with tile jt - 1
      if (jt < it) {
        load_b(jt + 1);
        load_x(jt + 1, 0, kHG);
      }
      cp_async_commit();
      // C.B^T tile (64 x 64): warp -> 16 rows x 32 columns
      const bf16* bt = Bt + (jt & 1) * kT * LDN;
      float acc[4][4] = {};
      if (!(jt == it && 32 * cgp > 16 * rg + 15)) {  // not wholly above the diagonal
#pragma unroll
        for (int k0 = 0; k0 < N; k0 += 16) {
          unsigned af[4];
          ldsm_x4(af, Cs + (16 * rg + (lane & 15)) * LDN + k0 + (lane >> 4) * 8);
#pragma unroll
          for (int p2 = 0; p2 < 2; ++p2) {
            unsigned bfr[4];
            ldsm_x4(bfr, bt + (32 * cgp + 16 * p2 + (lane & 7) + ((lane >> 4) << 3)) * LDN + k0 +
                             ((lane >> 3) & 1) * 8);
            mma(acc[2 * p2], af, bfr[0], bfr[1]);
            mma(acc[2 * p2 + 1], af, bfr[2], bfr[3]);
          }
        }
      }
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8) {
        const int col = 32 * cgp + 8 * n8 + 2 * t4;
        *reinterpret_cast<float2*>(CBt + (16 * rg + gq) * kLdt + col) =
            make_float2(acc[n8][0], acc[n8][1]);
        *reinterpret_cast<float2*>(CBt + (16 * rg + gq + 8) * kLdt + col) =
            make_float2(acc[n8][2], acc[n8][3]);
      }
      __syncthreads();  // the C.B^T tile is whole
#pragma unroll
      for (int u = 0; u < kHW; ++u) {
        const int hh = kHG >= 2 ? hs * kHW + u : 0;
        if (hh >= nh) break;
        const float* cumh = cum + hh * Q;
        const float* dth = dts + hh * Q;
        const float ci_a = cumh[i_a], ci_b = cumh[i_b];
        const bf16* xs = Xs + ((jt & 1) * kHG + hh) * kT * LDP;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (jt == it && ks > rg) break;  // wholly above the diagonal
          unsigned ahi[4], alo[4];
#pragma unroll
          for (int half = 0; half < 2; ++half) {  // columns jl, jl + 1: a0 / a1, then a2 / a3
            const int jl = 16 * ks + 2 * t4 + 8 * half, j0 = jt * kT + jl;
            const float cj0 = cumh[j0], cj1 = cumh[j0 + 1];
            const float d0 = dth[j0], d1 = dth[j0 + 1];
            const float2 cba = *reinterpret_cast<const float2*>(CBt + (16 * rg + gq) * kLdt + jl);
            const float2 cbb =
                *reinterpret_cast<const float2*>(CBt + (16 * rg + gq + 8) * kLdt + jl);
            // the exponent is masked before exp: exp(-inf) = 0
            const float wa0 = expf(j0 <= i_a ? ci_a - cj0 : -INFINITY) * cba.x * d0;
            const float wa1 = expf(j0 + 1 <= i_a ? ci_a - cj1 : -INFINITY) * cba.y * d1;
            const float wb0 = expf(j0 <= i_b ? ci_b - cj0 : -INFINITY) * cbb.x * d0;
            const float wb1 = expf(j0 + 1 <= i_b ? ci_b - cj1 : -INFINITY) * cbb.y * d1;
            split2(wa0, wa1, ahi[2 * half], alo[2 * half]);
            split2(wb0, wb1, ahi[2 * half + 1], alo[2 * half + 1]);
          }
#pragma unroll
          for (int np = 0; np < kPW / 16; ++np) {
            unsigned bfr[4];
            ldsm_x4_t(bfr, xs + (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * LDP + pc +
                               16 * np + (lane >> 4) * 8);
            mma(yacc[u][2 * np], ahi, bfr[0], bfr[1]);
            mma(yacc[u][2 * np], alo, bfr[0], bfr[1]);
            mma(yacc[u][2 * np + 1], ahi, bfr[2], bfr[3]);
            mma(yacc[u][2 * np + 1], alo, bfr[2], bfr[3]);
          }
        }
      }
    }
    const long long row = (long long)g.heads * P;
#pragma unroll
    for (int u = 0; u < kHW; ++u) {
      const int hh = kHG >= 2 ? hs * kHW + u : 0;
      if (hh >= nh) break;
      float* y = g.y + ((b * g.seq + t0) * g.heads + h0 + hh) * P;
#pragma unroll
      for (int n8 = 0; n8 < kPW / 8; ++n8) {
        const int p = pc + 8 * n8 + 2 * t4;
        *reinterpret_cast<float2*>(y + i_a * row + p) =
            make_float2(yacc[u][n8][0], yacc[u][n8][1]);
        *reinterpret_cast<float2*>(y + i_b * row + p) =
            make_float2(yacc[u][n8][2], yacc[u][n8][3]);
      }
    }
  }

  // ---- 3. the chunk's state contribution, when wanted: S = xw^T B
  if (ci >= g.nc_state) return;
  constexpr int kWph = P / 16;          // warps a head (16 rows of P each)
  constexpr int kHpp = kWarps / kWph;   // heads a pass
  const int ps = warp / kWph, pr = warp % kWph;
  for (int hp = 0; hp < nh; hp += kHpp) {
    const int hh = hp + ps;
    const bool active = hh < nh;
    float sacc[N / 8][4] = {};
    __syncthreads();  // the ring is free
    load_x(0, hp, kHpp);
    load_b(0);
    cp_async_commit();
    for (int jt = 0; jt < nt; ++jt) {
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();  // tile jt has landed; every warp is done with tile jt - 1
      if (jt + 1 < nt) {
        load_x(jt + 1, hp, kHpp);
        load_b(jt + 1);
      }
      cp_async_commit();
      if (!active) continue;
      const float* xs_h = xsc + hh * Q;
      const bf16* xs = Xs + ((jt & 1) * kHG + ps) * kT * LDP;
      const bf16* bt = Bt + (jt & 1) * kT * LDN;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        unsigned xf[4];  // x^T (16 rows of P x 16 positions)
        ldsm_x4_t(xf, xs + (16 * ks + (lane & 7) + (lane >> 4) * 8) * LDP + 16 * pr +
                          ((lane >> 3) & 1) * 8);
        const int jj = jt * kT + 16 * ks + 2 * t4;
        unsigned ahi[4], alo[4];
        scale_split(xf[0], xs_h[jj], xs_h[jj + 1], ahi[0], alo[0]);
        scale_split(xf[1], xs_h[jj], xs_h[jj + 1], ahi[1], alo[1]);
        scale_split(xf[2], xs_h[jj + 8], xs_h[jj + 9], ahi[2], alo[2]);
        scale_split(xf[3], xs_h[jj + 8], xs_h[jj + 9], ahi[3], alo[3]);
#pragma unroll
        for (int np = 0; np < N / 16; ++np) {
          unsigned bfr[4];
          ldsm_x4_t(bfr, bt + (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * LDN + 16 * np +
                             (lane >> 4) * 8);
          mma(sacc[2 * np], ahi, bfr[0], bfr[1]);
          mma(sacc[2 * np], alo, bfr[0], bfr[1]);
          mma(sacc[2 * np + 1], ahi, bfr[2], bfr[3]);
          mma(sacc[2 * np + 1], alo, bfr[2], bfr[3]);
        }
      }
    }
    if (active) {
      float* s = g.s + (((b * g.heads + h0 + hh) * g.nc_state + ci) * (long long)P) * N;
      const int pa = 16 * pr + gq;
#pragma unroll
      for (int n8 = 0; n8 < N / 8; ++n8) {
        const int n = 8 * n8 + 2 * t4;
        *reinterpret_cast<float2*>(s + pa * N + n) = make_float2(sacc[n8][0], sacc[n8][1]);
        *reinterpret_cast<float2*>(s + (pa + 8) * N + n) = make_float2(sacc[n8][2], sacc[n8][3]);
      }
    }
  }
}

template <int P, int N>
cudaError_t launch(const Args& g, int batch, cudaStream_t st) {
  auto kern = ssd_intra_chunk_tc_kernel<P, N>;
  const size_t smem = smem_bytes(P, N, g.chunk);
  // dynamic shared memory this instantiation may use: set on first use, since
  // the static warp_total counts against the 48 KB default too
  static size_t opted = 0;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  constexpr int hg = heads_a_block(P, N);
  const long long blocks = (long long)batch * g.nc * ((g.heads + hg - 1) / hg);
  if (blocks == 0) return cudaSuccess;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(g);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  The wrapper
// (kernel.py) has checked devices, dtypes, shapes and strides: bf16 x, B and
// C with 16-byte aligned rows, chunk in {64, 128, 256} dividing seq, P in
// {64, 128}, N in {16, 64, 128}, f32 dt and a.
extern "C" int ssd_intra_chunk_tc_fwd(
    const void* x, const void* dt, const void* a, const void* b, const void* c, void* y,
    void* s, void* ce, int batch, int seq, int heads, int p, int n, int chunk, int nc_state,
    long long sxb, long long sxt, long long sxh, long long sdb, long long sdt, long long sdh,
    long long sab, long long sah, long long sbb, long long sbt, long long scb, long long sct,
    void* stream) {
  if (chunk % kT || chunk > kMaxChunk || seq % chunk) return static_cast<int>(cudaErrorInvalidValue);
  Args g;
  g.x = static_cast<const bf16*>(x);
  g.dt = static_cast<const float*>(dt);
  g.a = static_cast<const float*>(a);
  g.b = static_cast<const bf16*>(b);
  g.c = static_cast<const bf16*>(c);
  g.y = static_cast<float*>(y);
  g.s = static_cast<float*>(s);
  g.ce = static_cast<float*>(ce);
  g.seq = seq;
  g.heads = heads;
  g.chunk = chunk;
  g.nc = seq / chunk;
  g.nc_state = nc_state;
  g.sxb = sxb; g.sxt = sxt; g.sxh = sxh;
  g.sdb = sdb; g.sdt = sdt; g.sdh = sdh;
  g.sab = sab; g.sah = sah;
  g.sbb = sbb; g.sbt = sbt;
  g.scb = scb; g.sct = sct;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (p == 64 && n == 16) err = launch<64, 16>(g, batch, st);
  if (p == 128 && n == 16) err = launch<128, 16>(g, batch, st);
  if (p == 64 && n == 64) err = launch<64, 64>(g, batch, st);
  if (p == 64 && n == 128) err = launch<64, 128>(g, batch, st);
  if (p == 128 && n == 64) err = launch<128, 64>(g, batch, st);
  if (p == 128 && n == 128) err = launch<128, 128>(g, batch, st);
  return static_cast<int>(err);
}
