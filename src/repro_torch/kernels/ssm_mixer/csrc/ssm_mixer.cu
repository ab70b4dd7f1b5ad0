// The Mamba-2 mixer's elementwise work around the SSD, on Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference's mixer (src/repro/models/ssm.py:
// ssm_apply, _causal_conv :73) is jnp, which XLA fuses into a few passes on
// the TPU.  PyTorch runs the same chain eagerly as about twenty passes a
// layer, several with f32 temporaries of [B, S, d_inner]; these two kernels
// take it in two passes, one on each side of the SSD.
//
//   ssm_mixer_front_kernel: the in-projection's row [z | xBC | dt_raw] ->
//     xbc  = SiLU(bias + sum_i w_i x_{t-W+1+i})   (depthwise causal conv)
//     gate = SiLU(z)
//     dt   = softplus(dt_raw + dt_bias)            (f32)
//     and, when asked, the new conv tail: the last W-1 rows of
//     [tail or zeros; xBC] (before the conv).
//   ssm_mixer_gated_norm_kernel: the SSD output y, x (a view of xbc) and
//     the gate -> rmsnorm((y + x D) * gate) * norm_w.
//
// Layout: proj [B, S, 2 di + 2 N + H] read through its batch and row
// strides (channels unit-stride: hymba's rows of 6,482 values leave every
// row after the first 4-byte aligned only); the tail [B, W-1, C] (C = di +
// 2 N) in proj's dtype through its strides, or none (zeros enter); conv_w
// [W, C] f32 through its row stride; conv_b [C], dt_bias [H], D [H], norm_w
// [di] f32.  Outputs contiguous: xbc [B, S, C] and gate [B, S, di] in proj's
// dtype, dt [B, S, H] f32, the tail [B, W-1, C], the norm's [B, S, di].  The
// norm reads y [B, S, H, P], x and the gate as rows of di values through
// their batch and row strides.
//
// Arithmetic: the eager chain's roundings, so that the outputs equal the
// twins (../ref.py) where the formulas are the same.  The conv weights and
// bias are rounded to the activation dtype T first; each tap's product and
// each partial sum is rounded to T, tap 0 (the oldest row) first, then the
// bias; SiLU x / (1 + expf(-x)) and softplus (x > 20 ? x : log1pf(expf(x)),
// beta 1, threshold 20) in f32, as PyTorch's kernels compute them; the
// norm's input bf16(bf16(y + bf16(x D)) * gate), its sum of squares in f32
// (another order than torch.mean's), rsqrtf, then (v * r) * w and one cast.
// Every product and sum is __fmul_rn / __fadd_rn, which nvcc never fuses
// into an FMA.
//
// What bounds them: at the mamba2-370m prefill_32k layer (B 32 x 32,768
// tokens, di 2,048, N 128, H 32) the front reads 8,768 B a token and writes
// 8,832 B (18.45 GB a layer: 5.51 ms at 3.35 TB/s), the norm reads 12,288 B
// and writes 4,096 B (17.18 GB: 5.13 ms).  Their f32 operations (tens a
// value) are under a tenth of that at 67 TFLOP/s.  Bytes bound.
//
// Design:
//   * Front: one thread owns 2 adjacent channels (one 4-byte load in bf16:
//     hymba's rows stay aligned to that) and walks a tile of kFrontRows
//     consecutive rows of one batch row, its W-1 previous inputs in
//     registers, so each input value is read once, plus W-1 halo rows a
//     tile.  A tile's first rows take the rows before it, the tail, or
//     zeros: never another batch row's.  The z channels take the gate, the
//     dt channels (one thread a head, scalar loads) the softplus.  The last
//     tile of a batch row writes its window as the new tail.  Channels run
//     fastest across a block, so a warp's loads of one row are contiguous.
//   * Norm: one block of 128 threads (more past di 1,024 x VEC) a row, each
//     thread K vectors of VEC values (16 bytes' worth) kept in registers
//     between the sum and the scaling, so the row is read once; the sum
//     through warp shuffles, then one value a warp through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kFrontThreads = 128;
constexpr int kFrontVec = 2;    // channels a front thread owns
constexpr int kFrontRows = 32;  // rows of one batch row a front thread walks
constexpr int kWidth = 4;  // the conv width of every Mamba-2 configuration
constexpr int kNormThreads = 128;
constexpr int kNormMaxK = 8;

// raw bits of T, and their conversion to and from f32 (bf16: round to
// nearest even, as c10::BFloat16 on the card)
template <typename T> struct Traits;
template <> struct Traits<float> {
  typedef uint32_t raw;
  static __device__ __forceinline__ float to_f(uint32_t r) { return __uint_as_float(r); }
  static __device__ __forceinline__ uint32_t from_f(float v) { return __float_as_uint(v); }
};
template <> struct Traits<bf16> {
  typedef uint16_t raw;
  static __device__ __forceinline__ float to_f(uint16_t r) {
    return __bfloat162float(__ushort_as_bfloat16(r));
  }
  static __device__ __forceinline__ uint16_t from_f(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// v rounded to T and back: where the eager chain stores an intermediate in T
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return Traits<T>::to_f(Traits<T>::from_f(v));
}

template <int BYTES> struct Word;
template <> struct Word<16> { typedef uint4 t; };
template <> struct Word<8> { typedef uint2 t; };
template <> struct Word<4> { typedef uint32_t t; };

// N values of T (at most 16 bytes, aligned to their size) in one access
template <typename T, int N>
__device__ __forceinline__ void load_word(const T* p, float* out) {
  typedef typename Word<sizeof(T) * N>::t W;
  union {
    W w;
    typename Traits<T>::raw v[N];
  } u;
  u.w = *reinterpret_cast<const W*>(p);
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = Traits<T>::to_f(u.v[j]);
}

template <typename T, int N>
__device__ __forceinline__ void store_word(T* p, const float* in) {
  typedef typename Word<sizeof(T) * N>::t W;
  union {
    W w;
    typename Traits<T>::raw v[N];
  } u;
#pragma unroll
  for (int j = 0; j < N; ++j) u.v[j] = Traits<T>::from_f(in[j]);
  *reinterpret_cast<W*>(p) = u.w;
}

// VEC values of T at p as f32, in accesses of up to 16 bytes
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&out)[VEC]) {
  constexpr int kPer = (int)(16 / sizeof(T)) < VEC ? (int)(16 / sizeof(T)) : VEC;
#pragma unroll
  for (int q = 0; q < VEC; q += kPer) load_word<T, kPer>(p + q, out + q);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&in)[VEC]) {
  constexpr int kPer = (int)(16 / sizeof(T)) < VEC ? (int)(16 / sizeof(T)) : VEC;
#pragma unroll
  for (int q = 0; q < VEC; q += kPer) store_word<T, kPer>(p + q, in + q);
}

// PyTorch's SiLU: x / (1 + exp(-x)) in f32
__device__ __forceinline__ float silu(float x) { return x / __fadd_rn(1.0f, expf(-x)); }

struct FrontArgs {
  const void* proj;
  long long psb, pss;  // proj's batch and row strides, in values
  const void* tail;    // or null: zeros
  long long tsb, tss;
  const float* conv_w;
  long long wsw;  // conv_w's row stride
  const float* conv_b;
  const float* dt_bias;
  void* xbc;
  void* gate;
  float* dt;
  void* new_tail;  // or null: not written
  int seq, di, c, h;
  int tiles;  // tiles of kFrontRows a batch row
};

template <typename T, int VEC, int W>
__global__ void __launch_bounds__(kFrontThreads) ssm_mixer_front_kernel(FrontArgs a) {
  const int vec_units = (a.di + a.c) / VEC;
  const int u = blockIdx.y * kFrontThreads + threadIdx.x;
  if (u >= vec_units + a.h) return;
  const long long b = blockIdx.x / a.tiles;
  const int s0 = (blockIdx.x % a.tiles) * kFrontRows;
  const int s1 = min(s0 + kFrontRows, a.seq);
  const T* prow = static_cast<const T*>(a.proj) + b * a.psb;
  const long long out_row = b * a.seq;  // the batch row's first output row

  if (u >= vec_units) {  // dt: one head, scalar loads
    const int hh = u - vec_units;
    const float bias = a.dt_bias[hh];
    const T* src = prow + a.di + a.c + hh;
    for (int s = s0; s < s1; ++s) {
      const float v = __fadd_rn(Traits<T>::to_f(*reinterpret_cast<const typename Traits<T>::raw*>(
                                    src + s * a.pss)),
                                bias);
      a.dt[(out_row + s) * a.h + hh] = v > 20.0f ? v : log1pf(expf(v));
    }
    return;
  }
  const int ch0 = u * VEC;
  if (ch0 < a.di) {  // the gate
    T* dst = static_cast<T*>(a.gate) + out_row * a.di + ch0;
#pragma unroll 4
    for (int s = s0; s < s1; ++s) {
      float z[VEC];
      load<T, VEC>(prow + s * a.pss + ch0, z);
#pragma unroll
      for (int j = 0; j < VEC; ++j) z[j] = silu(z[j]);
      store<T, VEC>(dst + (long long)s * a.di, z);
    }
    return;
  }

  // the conv: channels c0 .. c0 + VEC - 1 of xBC
  const int c0 = ch0 - a.di;
  const T* xrow = prow + ch0;
  float w[W][VEC], bias[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
#pragma unroll
    for (int i = 0; i < W; ++i) w[i][j] = rnd<T>(a.conv_w[i * a.wsw + c0 + j]);
    bias[j] = rnd<T>(a.conv_b[c0 + j]);
  }
  // the W-1 inputs before row s0: earlier rows, else the tail's, else zeros
  float win[W - 1][VEC];
#pragma unroll
  for (int i = 0; i < W - 1; ++i) {
    const int t = s0 - (W - 1) + i;
    if (t >= 0) {
      load<T, VEC>(xrow + t * a.pss, win[i]);
    } else if (a.tail != nullptr) {
      load<T, VEC>(static_cast<const T*>(a.tail) + b * a.tsb + (t + W - 1) * a.tss + c0,
                   win[i]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) win[i][j] = 0.0f;
    }
  }
  T* dst = static_cast<T*>(a.xbc) + out_row * a.c + c0;
#pragma unroll 4
  for (int s = s0; s < s1; ++s) {
    float cur[VEC], out[VEC];
    load<T, VEC>(xrow + s * a.pss, cur);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float acc = rnd<T>(__fmul_rn(win[0][j], w[0][j]));
#pragma unroll
      for (int i = 1; i < W; ++i) {
        const float x = i < W - 1 ? win[i][j] : cur[j];
        acc = rnd<T>(__fadd_rn(acc, rnd<T>(__fmul_rn(x, w[i][j]))));
      }
      out[j] = silu(rnd<T>(__fadd_rn(acc, bias[j])));
    }
    store<T, VEC>(dst + (long long)s * a.c, out);
#pragma unroll
    for (int i = 0; i < W - 2; ++i) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) win[i][j] = win[i + 1][j];
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) win[W - 2][j] = cur[j];
  }
  if (a.new_tail != nullptr && s1 == a.seq) {  // the last W-1 inputs, in order
    T* tail = static_cast<T*>(a.new_tail) + b * (W - 1) * a.c + c0;
#pragma unroll
    for (int i = 0; i < W - 1; ++i) store<T, VEC>(tail + i * a.c, win[i]);
  }
}

struct NormArgs {
  const void* y;
  long long ysb, yss;
  const void* x;
  long long xsb, xss;
  const void* g;
  long long gsb, gss;
  const float* d_skip;
  const float* norm_w;
  void* out;
  int seq, di, p;
  float eps, inv_di;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T, int VEC, int K>
__global__ void ssm_mixer_gated_norm_kernel(NormArgs a) {
  __shared__ float part[32];
  const long long row = blockIdx.x;
  const long long b = row / a.seq, s = row % a.seq;
  const T* y = static_cast<const T*>(a.y) + b * a.ysb + s * a.yss;
  const T* x = static_cast<const T*>(a.x) + b * a.xsb + s * a.xss;
  const T* g = static_cast<const T*>(a.g) + b * a.gsb + s * a.gss;
  float v[K][VEC];
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c0 = (k * blockDim.x + threadIdx.x) * VEC;
    if (c0 < a.di) {
      float yv[VEC], xv[VEC], gv[VEC];
      load<T, VEC>(y + c0, yv);
      load<T, VEC>(x + c0, xv);
      load<T, VEC>(g + c0, gv);
      const float d = rnd<T>(a.d_skip[c0 / a.p]);  // VEC divides P: one head
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float skip = rnd<T>(__fadd_rn(yv[j], rnd<T>(__fmul_rn(xv[j], d))));
        const float q = rnd<T>(__fmul_rn(skip, gv[j]));
        v[k][j] = q;
        ss = __fadd_rn(ss, __fmul_rn(q, q));
      }
    }
  }
  ss = warp_sum(ss);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < (int)(blockDim.x >> 5) ? part[lane] : 0.0f;
    ss = warp_sum(ss);
    if (lane == 0) part[0] = ss;
  }
  __syncthreads();
  const float r = rsqrtf(__fadd_rn(__fmul_rn(part[0], a.inv_di), a.eps));
  T* out = static_cast<T*>(a.out) + row * a.di;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c0 = (k * blockDim.x + threadIdx.x) * VEC;
    if (c0 < a.di) {
      float wv[VEC], o[VEC];
      load<float, VEC>(a.norm_w + c0, wv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = __fmul_rn(__fmul_rn(v[k][j], r), wv[j]);
      store<T, VEC>(out + c0, o);
    }
  }
}

template <typename T>
cudaError_t front(const FrontArgs& a, dim3 grid, cudaStream_t st) {
  ssm_mixer_front_kernel<T, kFrontVec, kWidth><<<grid, kFrontThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int VEC = 16 / sizeof(T)>
cudaError_t norm_k(const NormArgs& a, int k, long long rows, int threads, cudaStream_t st) {
  switch (k) {
    case 1: ssm_mixer_gated_norm_kernel<T, VEC, 1><<<rows, threads, 0, st>>>(a); break;
    case 2: ssm_mixer_gated_norm_kernel<T, VEC, 2><<<rows, threads, 0, st>>>(a); break;
    case 4: ssm_mixer_gated_norm_kernel<T, VEC, 4><<<rows, threads, 0, st>>>(a); break;
    case 8: ssm_mixer_gated_norm_kernel<T, VEC, 8><<<rows, threads, 0, st>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// The caller checked that proj's and the tail's bases and strides, di and c
// are multiples of kFrontVec values.
extern "C" int ssm_mixer_front_fwd(const void* proj, long long psb, long long pss,
                                   const void* tail, long long tsb, long long tss,
                                   const void* conv_w, long long wsw, const void* conv_b,
                                   const void* dt_bias, void* xbc, void* gate, void* dt,
                                   void* new_tail, int batch, int seq, int di, int c, int h,
                                   int width, int is_bf16, void* stream) {
  if (batch <= 0 || seq <= 0 || di <= 0 || c <= 0 || h <= 0 || width != kWidth ||
      di % kFrontVec || c % kFrontVec)
    return static_cast<int>(cudaErrorInvalidValue);
  FrontArgs a;
  a.proj = proj;
  a.psb = psb;
  a.pss = pss;
  a.tail = tail;
  a.tsb = tsb;
  a.tss = tss;
  a.conv_w = static_cast<const float*>(conv_w);
  a.wsw = wsw;
  a.conv_b = static_cast<const float*>(conv_b);
  a.dt_bias = static_cast<const float*>(dt_bias);
  a.xbc = xbc;
  a.gate = gate;
  a.dt = static_cast<float*>(dt);
  a.new_tail = new_tail;
  a.seq = seq;
  a.di = di;
  a.c = c;
  a.h = h;
  a.tiles = (seq + kFrontRows - 1) / kFrontRows;
  const long long tiles = (long long)batch * a.tiles;
  const int units = (di + c) / kFrontVec + h;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)tiles, (units + kFrontThreads - 1) / kFrontThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? front<bf16>(a, grid, st) : front<float>(a, grid, st));
}

// The caller checked that 16 bytes' worth of values (vec: 8 bf16, 4 f32)
// divides di, P, every row's base and norm_w's.
extern "C" int ssm_mixer_gated_norm_fwd(const void* y, long long ysb, long long yss,
                                        const void* x, long long xsb, long long xss,
                                        const void* g, long long gsb, long long gss,
                                        const void* d_skip, const void* norm_w, void* out,
                                        int batch, int seq, int di, int p, float eps,
                                        int is_bf16, void* stream) {
  const int vec = is_bf16 ? 8 : 4;
  if (batch <= 0 || seq <= 0 || di <= 0 || p <= 0 || di % p || p % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_k = kNormThreads * vec;  // values a thread's vector round covers
  int threads = kNormThreads, k = 1;
  while (k < kNormMaxK && k * per_k < di) k *= 2;
  if (k * per_k < di) {  // past 8 rounds of 128 threads: more threads
    threads = ((di + kNormMaxK * vec - 1) / (kNormMaxK * vec) + 31) / 32 * 32;
    if (threads > 1024) return static_cast<int>(cudaErrorInvalidValue);
  }
  NormArgs a;
  a.y = y;
  a.ysb = ysb;
  a.yss = yss;
  a.x = x;
  a.xsb = xsb;
  a.xss = xss;
  a.g = g;
  a.gsb = gsb;
  a.gss = gss;
  a.d_skip = static_cast<const float*>(d_skip);
  a.norm_w = static_cast<const float*>(norm_w);
  a.out = out;
  a.seq = seq;
  a.di = di;
  a.p = p;
  a.eps = eps;
  a.inv_di = 1.0f / (float)di;
  const long long rows = (long long)batch * seq;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? norm_k<bf16>(a, k, rows, threads, st)
                                  : norm_k<float>(a, k, rows, threads, st));
}
