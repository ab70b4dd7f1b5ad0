// Mamba-2 SSD inter-chunk recurrence on Hopper's tensor cores (sm_90a).
//
// Replaces the jnp scan over chunks that src/repro/kernels/ssd_scan/ops.py:
// ssd_scan runs after the Pallas intra-chunk kernel (kernel.py:
// ssd_intra_chunk; in the model src/repro/models/ssm.py:ssd_chunked).  It
// computes that scan's function; for one (batch, head), with h_0 = h0 (or 0):
//
//   for chunk i = 0 .. nc - 1:
//     y_t     += cumexp_t * (C_t . h_i)         for the Q positions t of chunk i
//     h_{i+1}  = h_i * cumexp_{last t of chunk i} + S_i     (i < nc_state)
//   h_final  = h_nc                             (when wanted)
//
// y_t is a row of P values and h_i a [P, N] state, so C_t . h_i is h_i C_t.
// Layout: y [B, S, H, P] f32 contiguous (the intra-chunk term y_intra,
// updated in place), S [B, H, nc_state, P, N] f32 and cumexp [B, H, S] f32
// contiguous (the intra-chunk kernels' outputs), C [B, S, N] bf16 or f32 read
// in place through strides (innermost stride 1: a slice of the projection),
// h0 and h_final [B, H, P, N] f32 contiguous.  nc_state is nc, or nc - 1 when
// the last chunk's state is not wanted (then h_final is not written).
//
// Arithmetic: mma.sync m16n8k16, bf16 operands, f32 accumulation.  C is the
// A operand (Q rows x N), h^T the B operand.  A bf16 C is exact; h is f32,
// so it is split into bf16 hi + lo (hi = bf16(h), lo = bf16(h - hi)) and the
// two products summed: about 2^-16 of |h| is lost, within the f32 twin's 1e-4
// of the output's scale (the split ssd_scan_tc.cu makes of W and xw).  An
// f32 C (the f32 models) is split the same way and Chi.hhi + Chi.hlo +
// Clo.hhi summed (Clo.hlo, ~2^-16 of the rest, is dropped).  The recurrence
// is f32, a rounded product then a rounded sum, as the twin computes it.
//
// What bounds it: at the mamba2-370m prefill_32k layer (B 16, S 32,768, H
// 32, P 64, N 128, Q 256: 128 chunks) it reads y_intra (4.29 GB) and S (2.15
// GB), C and cumexp, and writes y (4.29 GB): ~10.9 GB, ~3.3 ms at 3.35 TB/s.
// The products are 2 (hi / lo) x 2 B S H P N = 550 GFLOP, ~0.56 ms at the
// bf16 tensor-core peak.  Bytes bound.
//
// Design:
//   * One block walks one (batch, head, group of P columns) through every
//     chunk in order; its state lives in registers across the whole walk, in
//     the B-fragment layout of the products (N / 2 floats a thread: 64 at N
//     128), so the recurrence is elementwise in registers.  A warp owns 16
//     columns of P and 64 / ROWS of a tile's 64 rows (ROWS warps share the
//     columns, each with a copy of the state); a block holds 1, 2 or 4 warps.
//     The wrapper picks the layout so that the blocks fill the SMs: at the
//     prefill_32k layer 512 blocks of 4 column warps; at B 2 x 32 heads, where
//     that gives 64 blocks, 256 blocks of 4 row warps over 16 columns, so a
//     tile's rows are multiplied by four warps at once.  Blocks are ordered
//     head-fastest, so the heads of one batch row, which share C, run
//     together and C's rows come from L2.
//   * A chunk runs in tiles of 64 rows: the tile's C rows arrive by 16-byte
//     cp.async into padded shared memory (rows of NK + 8 halves: conflict-free
//     ldmatrix), the next tile in flight while this one is multiplied; S_i
//     arrives the same way at the chunk's first tile and is read at its end.
//     Each warp loads its y_intra values straight into registers in the
//     accumulator layout before its products, so the loads are in flight
//     during them, then writes y = y_intra + cumexp * acc as float2.
//   * N is padded to NK in {16, 32, 64, 128} with zero columns in shared
//     memory and zero state; a chunk shorter than 64 rows (the cascade's
//     chunks of 8) or a tile past the chunk's end masks its rows.  Without h0
//     the state entering chunk 0 is zero, so chunk 0's rows are left as they
//     are (not read, not written) and the walk starts from h_1 = S_0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxWarps = 4;
constexpr int kR = 64;  // rows a tile

typedef __nv_bfloat16 bf16;

struct Args {
  float* y;
  const float* s;
  const float* ce;
  const void* c;
  const float* h0;
  float* hf;
  int seq, heads, p, n, chunk, nc, nc_state, groups;
  long long scb, sct;
  int vec;  // C rows 16-byte aligned (bf16, N a multiple of 8): cp.async
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

template <typename CT, int NK>
struct Layout {
  static constexpr int kLd = NK + 8;                          // a C row, halves
  static constexpr int kSplit = std::is_same<CT, float>::value ? 2 : 1;  // hi (and lo)
  static constexpr int kTile = kSplit * kR * kLd;            // one buffer, halves
  static constexpr int kLds = NK + 8;                         // an S row, floats
  static size_t bytes(int warps) {
    return 2 * (size_t)kTile * sizeof(bf16) + (size_t)warps * 16 * kLds * sizeof(float);
  }
};

// the state's registers: st[ks][j][e] = h[p][k], p = pw + 8 j + gq, k = 16 ks
// + 2 t4 + (e & 1) + 8 (e >> 1) -- the B fragment of k-step ks, n8 tile j
template <int NK>
__device__ __forceinline__ void load_state(float (&st)[NK / 16][2][4], const float* src, int pw,
                                           int p_dim, int n_dim, int gq, int t4) {
#pragma unroll
  for (int ks = 0; ks < NK / 16; ++ks)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = pw + 8 * j + gq, k = 16 * ks + 8 * hf + 2 * t4;
        float2 v = make_float2(0.f, 0.f);
        if (src != nullptr && p < p_dim && k < n_dim)
          v = *reinterpret_cast<const float2*>(src + (long long)p * n_dim + k);
        st[ks][j][2 * hf] = v.x;
        st[ks][j][2 * hf + 1] = v.y;
      }
}

template <typename CT, int NK, int ROWS>
__global__ void __launch_bounds__(kMaxWarps * 32) ssd_inter_chunk_kernel(Args g) {
  using L = Layout<CT, NK>;
  constexpr int KS = NK / 16;
  constexpr int MT = 4 / ROWS;  // m16 tiles of a 64-row tile a warp multiplies
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Cs = reinterpret_cast<bf16*>(smem);            // [2][kSplit][kR][kLd]
  float* Ss = reinterpret_cast<float*>(Cs + 2 * L::kTile);  // [column warps * 16][kLds]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, warps = (nthreads >> 5) / ROWS;  // column warps
  const int rw = warp % ROWS, cw = warp / ROWS;  // this warp's rows and columns
  const int gq = lane >> 2, t4 = lane & 3;  // fragment row and column pair
  const int pg = static_cast<int>(blockIdx.x % g.groups);
  const long long bh = blockIdx.x / g.groups;  // b * heads + h
  const long long b = bh / g.heads;
  const int h = static_cast<int>(bh % g.heads);
  const int pb = pg * warps * 16;  // the block's first column of P
  const int pw = pb + cw * 16;     // the warp's
  const int prow = min(warps * 16, g.p - pb);  // columns of P the block holds
  const int Q = g.chunk, tpc = (Q + kR - 1) / kR;
  const long long S = g.seq;
  const float* ce = g.ce + bh * S;
  const float* s_bh = g.s + bh * g.nc_state * (long long)g.p * g.n;
  const CT* C = static_cast<const CT*>(g.c) + b * g.scb;

  // zero the padding columns [n, NK) of every C tile once: the products read them
  if (g.n < NK) {
    const int w = NK - g.n;
    for (int e = tid; e < 2 * L::kSplit * kR * w; e += nthreads)
      Cs[(e / w) * L::kLd + g.n + e % w] = __float2bfloat16(0.f);
  }

  // the state entering the first chunk whose rows change
  float st[KS][2][4];
  int first = 0;
  if (g.h0 != nullptr) {
    load_state<NK>(st, g.h0 + bh * (long long)g.p * g.n, pw, g.p, g.n, gq, t4);
  } else {  // h_0 = 0: chunk 0's rows keep y_intra, and h_1 = S_0
    load_state<NK>(st, g.nc_state > 0 ? s_bh : nullptr, pw, g.p, g.n, gq, t4);
    first = 1;
  }

  // C rows [t0, t0 + rows) into buffer buf (hi, and lo for an f32 C)
  auto stage = [&](int u, int buf) {
    const int i = first + u / tpc, k = u % tpc;
    const long long t0 = (long long)i * Q + k * kR;
    const int rows = min(kR, Q - k * kR);
    bf16* dst = Cs + buf * L::kTile;
    if constexpr (std::is_same<CT, bf16>::value) {
      if (g.vec) {
        const int chunks = g.n / 8;
        for (int e = tid; e < rows * chunks; e += nthreads) {
          const int r = e / chunks, ch = e - r * chunks;
          cp_async16(dst + r * L::kLd + ch * 8, C + (t0 + r) * g.sct + ch * 8);
        }
        return;
      }
      for (int e = tid; e < rows * g.n; e += nthreads) {
        const int r = e / g.n, col = e - r * g.n;
        dst[r * L::kLd + col] = C[(t0 + r) * g.sct + col];
      }
    } else {
      for (int e = tid; e < rows * g.n; e += nthreads) {
        const int r = e / g.n, col = e - r * g.n;
        const float v = C[(t0 + r) * g.sct + col];
        const bf16 hi = __float2bfloat16_rn(v);
        dst[r * L::kLd + col] = hi;
        dst[kR * L::kLd + r * L::kLd + col] = __float2bfloat16_rn(v - __bfloat162float(hi));
      }
    }
  };

  const bool active = pw < g.p;  // a warp past P's last column only loads and waits
  const long long row = (long long)g.heads * g.p;  // y's stride between positions
  float* yb = g.y + (b * S * g.heads + h) * (long long)g.p;
  const int tiles = (g.nc - first) * tpc;
  if (tiles > 0) {
    stage(0, 0);
    cp_async_commit();
  }
  for (int i = first; i < g.nc; ++i) {
    const bool update = i < g.nc_state;
    for (int k = 0; k < tpc; ++k) {
      const int u = (i - first) * tpc + k;
      cp_async_wait_all();
      __syncthreads();  // tile u has landed; every warp is done with tile u - 1 and S_{i-1}
      if (k == 0 && update) {  // S_i, read at this chunk's end
        const int chunks = g.n / 4;
        const float* src = s_bh + (long long)i * g.p * g.n + (long long)pb * g.n;
        for (int e = tid; e < prow * chunks; e += nthreads) {
          const int r = e / chunks, ch = e - r * chunks;
          cp_async16(Ss + r * L::kLds + ch * 4, src + (long long)r * g.n + ch * 4);
        }
      }
      if (u + 1 < tiles) stage(u + 1, (u + 1) & 1);
      cp_async_commit();
      if (!active) continue;

      const long long t0 = (long long)i * Q + k * kR;
      const int rows = min(kR, Q - k * kR);
      const int mts = (rows + 15) >> 4;
      // this thread's y_intra values and cumexp, in the accumulator layout;
      // the warp's m16 tiles are rw, rw + ROWS, ..
      float2 yv[MT][2][2];
      float cev[MT][2];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int mt = rw + ROWS * m, r = 16 * mt + gq + 8 * hr;
          const bool live = mt < mts && r < rows;
          cev[m][hr] = live ? ce[t0 + r] : 0.f;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int p = pw + 8 * j + 2 * t4;
            yv[m][j][hr] = live && p < g.p
                               ? *reinterpret_cast<const float2*>(yb + (t0 + r) * row + p)
                               : make_float2(0.f, 0.f);
          }
        }
      float acc[MT][2][4] = {};
      const bf16* ct = Cs + (u & 1) * L::kTile;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        unsigned bhi[2][2], blo[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          split2(st[ks][j][0], st[ks][j][1], bhi[j][0], blo[j][0]);
          split2(st[ks][j][2], st[ks][j][3], bhi[j][1], blo[j][1]);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int mt = rw + ROWS * m;
          if (mt >= mts) break;
          unsigned a[4];
          ldsm_x4(a, ct + (16 * mt + (lane & 15)) * L::kLd + 16 * ks + (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            mma(acc[m][j], a, bhi[j][0], bhi[j][1]);
            mma(acc[m][j], a, blo[j][0], blo[j][1]);
          }
          if constexpr (L::kSplit == 2) {  // an f32 C: its lo part times h's hi part
            ldsm_x4(a, ct + kR * L::kLd + (16 * mt + (lane & 15)) * L::kLd + 16 * ks +
                           (lane >> 4) * 8);
#pragma unroll
            for (int j = 0; j < 2; ++j) mma(acc[m][j], a, bhi[j][0], bhi[j][1]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int mt = rw + ROWS * m, r = 16 * mt + gq + 8 * hr;
          if (mt >= mts || r >= rows) continue;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int p = pw + 8 * j + 2 * t4;
            if (p >= g.p) continue;
            const float2 v = yv[m][j][hr];
            *reinterpret_cast<float2*>(yb + (t0 + r) * row + p) =
                make_float2(v.x + cev[m][hr] * acc[m][j][2 * hr],
                            v.y + cev[m][hr] * acc[m][j][2 * hr + 1]);
          }
        }
    }
    if (update) {  // h_{i+1} = h_i * cumexp_last + S_i
      cp_async_wait_all();
      __syncthreads();  // S_i has landed for every thread
      const float decay = ce[(long long)(i + 1) * Q - 1];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int pr = cw * 16 + 8 * j + gq, k = 16 * ks + 8 * hf + 2 * t4;
            float2 sv = make_float2(0.f, 0.f);
            if (pr < prow && k < g.n) sv = *reinterpret_cast<const float2*>(Ss + pr * L::kLds + k);
            st[ks][j][2 * hf] = __fadd_rn(__fmul_rn(st[ks][j][2 * hf], decay), sv.x);
            st[ks][j][2 * hf + 1] = __fadd_rn(__fmul_rn(st[ks][j][2 * hf + 1], decay), sv.y);
          }
    }
  }

  if (g.hf != nullptr && active && rw == 0) {  // one copy of the state writes it
    float* dst = g.hf + bh * (long long)g.p * g.n;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = pw + 8 * j + gq, k = 16 * ks + 8 * hf + 2 * t4;
          if (p < g.p && k < g.n)
            *reinterpret_cast<float2*>(dst + (long long)p * g.n + k) =
                make_float2(st[ks][j][2 * hf], st[ks][j][2 * hf + 1]);
        }
  }
}

template <typename CT, int NK, int ROWS>
cudaError_t launch(const Args& g, long long blocks, int warps, cudaStream_t st) {
  auto kern = ssd_inter_chunk_kernel<CT, NK, ROWS>;
  const size_t smem = Layout<CT, NK>::bytes(warps / ROWS);
  static size_t opted = 48 * 1024;  // dynamic shared memory set so far
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  if (blocks == 0) return cudaSuccess;
  kern<<<static_cast<unsigned>(blocks), warps * 32, smem, st>>>(g);
  return cudaGetLastError();
}

template <typename CT, int ROWS>
cudaError_t dispatch(const Args& g, long long blocks, int warps, cudaStream_t st) {
  if (g.n <= 16) return launch<CT, 16, ROWS>(g, blocks, warps, st);
  if (g.n <= 32) return launch<CT, 32, ROWS>(g, blocks, warps, st);
  if (g.n <= 64) return launch<CT, 64, ROWS>(g, blocks, warps, st);
  if (g.n <= 128) return launch<CT, 128, ROWS>(g, blocks, warps, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  The wrapper
// (kernel.py) has checked devices, dtypes, shapes and strides: y, s, ce, h0
// and hf contiguous f32, C with a unit innermost stride, P and N multiples of
// 4, N <= 128, the chunk dividing seq, nc_state nc or nc - 1, warps 1, 2 or 4
// a block, of them row_warps (1 or 4) sharing each 16 columns of P.
extern "C" int ssd_inter_chunk_fwd(void* y, const void* s, const void* ce, const void* c,
                                   const void* h0, void* hf, int batch, int seq, int heads,
                                   int p, int n, int chunk, int nc_state, long long scb,
                                   long long sct, int c_is_bf16, int vec, int warps,
                                   int row_warps, void* stream) {
  if (chunk <= 0 || seq % chunk || p % 4 || n % 4 || n > 128 ||
      (warps != 1 && warps != 2 && warps != 4) || (row_warps != 1 && row_warps != 4) ||
      warps % row_warps || (vec && (!c_is_bf16 || n % 8)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args g;
  g.y = static_cast<float*>(y);
  g.s = static_cast<const float*>(s);
  g.ce = static_cast<const float*>(ce);
  g.c = c;
  g.h0 = static_cast<const float*>(h0);
  g.hf = static_cast<float*>(hf);
  g.seq = seq;
  g.heads = heads;
  g.p = p;
  g.n = n;
  g.chunk = chunk;
  g.nc = seq / chunk;
  g.nc_state = nc_state;
  const int cols = 16 * (warps / row_warps);  // columns of P a block holds
  g.groups = (p + cols - 1) / cols;
  g.scb = scb;
  g.sct = sct;
  g.vec = vec;
  const long long blocks = (long long)batch * heads * g.groups;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (row_warps == 4)
    err = c_is_bf16 ? dispatch<bf16, 4>(g, blocks, warps, st)
                    : dispatch<float, 4>(g, blocks, warps, st);
  else
    err = c_is_bf16 ? dispatch<bf16, 1>(g, blocks, warps, st)
                    : dispatch<float, 1>(g, blocks, warps, st);
  return static_cast<int>(err);
}
