// PIQUE benefit scoring (paper Eq. 11) for NVIDIA Hopper (sm_90a).
//
// Replaces the reference's Pallas TPU kernels in
// src/repro/kernels/enrich_score/kernel.py:
//   enrich_score_table_kernel  <- enrich_score_tiles_batched      (table mode)
//   enrich_score_best_kernel   <- enrich_score_best_tiles_batched (best mode)
//   enrich_score_single_kernel <- enrich_score_tiles              (one query,
//                                 table mode, with a candidate mask)
//
// Per (object c, predicate p) lane, with h the stored uncertainty, pp the
// predicate probability and j the per-tenant joint probability:
//   bin     = floor(clip(h, 0, 1-1e-7) * B)
//   delta   = table_delta[p, state, bin]           (table mode also: next_fn)
//   h_hat   = clip(h + delta, 0, 1)
//   p_hat   = lerp of the 4096-bin inverse-entropy LUT at h_hat
//   est_j   = clip(j / max(pp, 1e-12) * p_hat, 0, 1)   (0 where pp == 0)
//   cost    = max(costs[p, max(fn, 0)], 1e-9)
//   benefit = j * est_j / cost,  -inf where no function remains
// Best mode prices every remaining function and keeps the first strict
// maximum; nothing F-shaped is written.  The single-query kernel also sets
// -inf where the object is no candidate (cand[c] == 0), and writes the
// UNFLOORED cost costs[p, max(fn, 0)] that its function returns (the benefit
// still divides by the floored one).  Table mode and the single-query kernel
// share the per-lane math (table_lane), so the two agree by construction.
//
// What bounds them: memory bytes.  A handful of f32 ops per lane and tenant
// (per function in best mode) against 16 bytes written per lane and tenant,
// far below the H100's ridge point.
// At the session's main-path shape (C = 1,048,576, P = 4, Q = 8, f32 rows)
// the batched kernels read ~84 MB (pred_prob, uncertainty, state id, joint)
// and write 4 x [8, 1M, 4] x 4 B = 537 MB: ~621 MB, a bound of ~0.185 ms at
// 3.35 TB/s (bf16 rows: ~579 MB, ~0.173 ms).  At the operator's shape
// (C = 1,048,576, P = 2) the single-query kernel reads pred_prob, unc and
// state_id (3 x 8.4 MB), joint (4.2 MB) and cand (1 MB) and writes the four
// [C, P] outputs its function returns (33.6 MB): ~64 MB, ~0.019 ms.
//
// Design, against that bound:
//   * The TPU kernel's one-hot matmul gathers were a workaround for weak
//     vector gathers; here the decision table(s), the [P, F] costs and the
//     f32 LUT (16 KB) are staged once per block in shared memory and read
//     with indexed loads.  Blocks are persistent (grid-stride loop, grid
//     sized by occupancy) so the tables are staged a few hundred times, not
//     once per 256 lanes.
//   * The [C, P] rows are read in place (no TILE re-layout): the TPU
//     wrapper's broadcast [N*P] rows of joint, candidate mask and predicate
//     index are gone; joint and cand are read per object, the predicate is
//     lane % P, the state id is int32.  In the batched kernels one thread
//     owns one (c, p) lane and loops over the Q tenants, so the shared rows
//     and everything Q-invariant (bin, table lookups, p_hat, costs) are
//     loaded and computed once, whatever Q is.  Output writes are
//     contiguous across the threads of a warp.
//   * next_fn is written as int32 and invalid benefits as -inf directly; in
//     best mode an unavailable function is a +inf delta, tested with isinf.
//   * bf16 probabilities are upcast exactly on first touch; all arithmetic
//     is f32, rounded op by op (explicit _rn intrinsics, and the file is
//     built with --fmad=false) so the kernel matches the plain PyTorch
//     version in ref.py bit for bit.
//   * Best mode moves the same bytes as table mode but prices every
//     remaining function for every tenant, and its first form ran half
//     again as long: per (lane, tenant, function) two IEEE divisions under
//     a runtime F, four scalar stores per (lane, tenant) between the
//     compare chains, and the joint row read once per lane.  Its kernel is
//     templated on F (1..8) and, for P <= 4 (the session's 4, the
//     cascade's 3), on P: one thread per object covers its P lanes, reads
//     the object's rows as vectors and each tenant's joint once, hoists
//     r = j / max(pp, 1e-12) out of the function loop (the plain version
//     computes (j / max(pp)) * p_hat left to right, so this is bitwise the
//     same), and writes each output row with one streaming store
//     (st.global.cs; 16 bytes at P = 4).  What remains
//     per (lane, tenant, function) is one multiply, a clip and the
//     benefit's IEEE division.  P > 4 keeps one thread per lane.
//   * Two table routes, picked by the wrapper (kernel.table_route), each
//     kernel templated on it.  "smem": the tables staged in shared memory,
//     as above; "global": the table read from device memory, where it does
//     not fit a block's 227 KB, or past F 8 in best mode, or where the
//     smem route would be the slower (kernel.py's GLOBAL_FROM: a block that
//     stages a large table holds its SM with few warps).  A table has 2^F
//     states.  The global route stages only the LUT and the [P, F] costs;
//     each lane reads its one table entry (table mode) or its contiguous
//     [F] row (best mode) through the read-only path, indexed in int64.
//     Tables of 0.3-10 MB stay resident in the 50 MB L2.
//   * Best mode on the global route (and on the smem route at P > 4) runs
//     one thread a lane: enrich_score_best_lane_kernel<T, F, ROUTE>, unrolled
//     for F <= 10 (global past F 8: F 9 and 10, the ten-function session's
//     bank), p_hat and the reciprocal costs in registers;
//     enrich_score_best_wide_kernel<T> past F 10 (a runtime F <= 32: the
//     lane's p_hat and reciprocals computed once into its thread's columns of
//     shared memory, [F][256]).  A lane's remaining functions are one 32-bit
//     mask.  At F 10 the unrolled form ran faster on the card than the wide
//     kernel, and unrolling the wide kernel itself to 16 or 32 slots with a
//     masked tail did not help: its per-function shared-memory reads, not
//     its loop, cost it.  Past F 10 no served path scores, so one kernel
//     takes every F there.
//     Everything no tenant enters is hoisted: per block the floored costs
//     and their correctly rounded reciprocals, staged function-major beside
//     the LUT; per (lane, function) the delta, whether it remains and p_hat.
//     Per tenant the divisions are screened (best_screened): the first form
//     did one IEEE division per (lane, tenant, function), 64 a lane at F 8
//     with 8 tenants, and was issue-bound at 40% of its bound.
//   * The screen, and why it is bitwise.  Per remaining function f, with u =
//     2^-24: a_f = RN(j * est_f) exactly as the plain version rounds it,
//     c_f the floored cost, benefit b_f = RN(q_f) with q_f = a_f / c_f, and
//     the estimate e_f = RN(a_f * RN(1 / c_f)).  g is the first function
//     with the largest estimate e1, e2 the largest estimate of any other.
//     Claim: if c_f <= 2^126 for every f, 2^-125 <= e1 <= 2^125 and e2 <
//     t = RN(e1 * k), k = 1 - 2^-20, then b_f < b_g for every f != g, so g
//     is the plain version's first strict maximum and its benefit is the
//     one division RN(a_g / c_g).  Proof: 1 / c_f >= 2^-126 is normal, so
//     RN(1 / c_f) = (1 / c_f)(1 + d), |d| <= u.  e1 is normal, so q_g >=
//     e1 / (1 + u)^2 > 2^-126 is normal and b_g >= q_g (1 - u) >= e1 (1 -
//     u) / (1 + u)^2.  For f != g, e_f <= e2 < t <= e1 k (1 + u).  If e_f
//     is normal, q_f <= e_f / (1 - u)^2 and b_f <= q_f (1 + u) < e1 k (1 +
//     u)^2 / (1 - u)^2 <= b_g, since k = 1 - 16u <= (1 - u)^3 / (1 + u)^4;
//     if e_f < 2^-126, a_f RN(1 / c_f) < 2^-126 and b_f <= 2^-126 (1 + 2u)
//     < 2^-125 (1 - u) / (1 + u)^2 <= b_g.  Monotone rounding does the rest;
//     e1 <= 2^125 keeps every product finite.  Where every a_f is zero each
//     benefit is a signed zero and the first remaining function wins (its
//     division gives the sign).  Anywhere else (a near tie, e1 out of range,
//     a cost past 2^126) the lane and tenant take the exact fold: every
//     division, in function order, as before.  ref.best_screen is the same
//     computation in PyTorch: it counts the divisions and lets the CPU tests
//     hold the screen's choice against the plain version.  On chip_smoke.py
//     phase 2's inputs (C 1M, P 4, Q 8) it counts 0.993 benefit divisions a
//     (lane, tenant) at F 8 and 0.999 at F 10, where the fold without the
//     screen divided once per remaining function: 3.97 and 5.00.
//   * A running screen (divide when a function may beat the running best)
//     was not taken: a warp divides wherever any of its 32 lanes must, and
//     at F 8 in random order a lane's best changes at function f with
//     probability 1 / (f + 1), so nearly every warp would divide at every
//     function.  Keeping the top two estimates and deciding at the end
//     costs one division per (lane, tenant) outside near ties.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFunctions = 8;  // the smem route's best-mode kernels: F 1..8
constexpr int kMaxLane = 10;  // the global route's unrolled lane kernels: F 1..10
constexpr int kMaxWide = 32;  // the wide kernel: a lane's remaining functions in one mask
// f32 roundings of the double constants the reference applies to f32 data
constexpr float kClipHi = (float)(1.0 - 1e-7);
constexpr float kMinP = (float)1e-12;
constexpr float kMinCost = (float)1e-9;
// The screen (header): an estimate below e1 * (1 - 2^-20) cannot be a new
// maximum; it applies where e1 lies in [2^-125, 2^125] and every floored cost
// is <= 2^126 (so its reciprocal is normal).
constexpr float kScreen = 1.0f - 0x1p-20f;
constexpr float kScreenLo = 0x1p-125f;
constexpr float kScreenHi = 0x1p125f;
constexpr float kCostHi = 0x1p126f;

__device__ __forceinline__ float load_prob(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_prob(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

__device__ __forceinline__ int bin_of(float h, int num_bins) {
  return (int)floorf(__fmul_rn(fminf(fmaxf(h, 0.0f), kClipHi), (float)num_bins));
}

// Upper entropy root: p_lo * (1 - frac) + p_hi * frac, each term rounded.
__device__ __forceinline__ float lut_lerp(float h_hat, const float* lut, int lut_bins) {
  const float top = (float)(lut_bins - 1);
  const float x = __fmul_rn(h_hat, top);
  const float lo = floorf(x);
  const float frac = __fsub_rn(x, lo);
  const float hi = fminf(__fadd_rn(lo, 1.0f), top);
  return __fadd_rn(__fmul_rn(lut[(int)lo], __fsub_rn(1.0f, frac)),
                   __fmul_rn(lut[(int)hi], frac));
}

__device__ __forceinline__ float est_joint(float j, float pp, float p_hat) {
  return pp > 0.0f ? clip01(__fmul_rn(__fdiv_rn(j, fmaxf(pp, kMinP)), p_hat)) : 0.0f;
}

__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// The decision-table mode's tables: [P*S*B] deltas and next functions, [P*F]
// costs, the LUT.  The "smem" route stages all four in shared memory; the
// "global" route stages the costs and the LUT and leaves the deltas and next
// functions in device memory.
struct TableRefs {
  const float* delta;
  const int32_t* next;
  const float* cost;
  const float* lut;
};

template <bool GLOBAL>
__device__ __forceinline__ TableRefs stage_table(
    float* smem, const float* delta_tab, const int32_t* next_tab, const float* cost_tab,
    const float* lut, int P, int num_states, int num_bins, int F, int lut_bins) {
  const int PF = P * F;
  if constexpr (GLOBAL) {
    stage(smem, cost_tab, PF);
    stage(smem + PF, lut, lut_bins);
    __syncthreads();
    return TableRefs{delta_tab, next_tab, smem, smem + PF};
  } else {
    const int tsize = P * num_states * num_bins;
    float* s_delta = smem;
    int32_t* s_next = reinterpret_cast<int32_t*>(s_delta + tsize);
    float* s_cost = reinterpret_cast<float*>(s_next + tsize);
    float* s_lut = s_cost + PF;
    stage(s_delta, delta_tab, tsize);
    for (int i = threadIdx.x; i < tsize; i += blockDim.x) s_next[i] = next_tab[i];
    stage(s_cost, cost_tab, PF);
    stage(s_lut, lut, lut_bins);
    __syncthreads();
    return TableRefs{s_delta, s_next, s_cost, s_lut};
  }
}

// Everything of one (object, predicate) lane that no joint probability
// enters: the table's function choice, p_hat and the floored cost.
struct TableLane {
  int fn;
  float p_hat;
  float cost;
};

template <bool GLOBAL>
__device__ __forceinline__ TableLane table_lane(TableRefs t, float h, int p, int state,
                                                int num_states, int num_bins, int F, int lut_bins) {
  TableLane r;
  float delta;
  if constexpr (GLOBAL) {  // one entry from device memory (read-only path)
    const int64_t k = ((int64_t)p * num_states + state) * num_bins + bin_of(h, num_bins);
    r.fn = __ldg(t.next + k);
    delta = __ldg(t.delta + k);
  } else {
    const int k = (p * num_states + state) * num_bins + bin_of(h, num_bins);
    r.fn = t.next[k];
    delta = t.delta[k];
  }
  r.p_hat = lut_lerp(clip01(__fadd_rn(h, delta)), t.lut, lut_bins);
  r.cost = fmaxf(t.cost[p * F + max(r.fn, 0)], kMinCost);
  return r;
}

__device__ __forceinline__ float benefit_of(float j, float est, float cost) {
  return __fdiv_rn(__fmul_rn(j, est), cost);  // (j * est) / cost, in that order
}

template <typename T, bool GLOBAL>
__global__ void __launch_bounds__(kThreads) enrich_score_table_kernel(
    const T* __restrict__ pred_prob, const T* __restrict__ unc,
    const int32_t* __restrict__ state_id, const T* __restrict__ joint,
    const float* __restrict__ delta_tab, const int32_t* __restrict__ next_tab,
    const float* __restrict__ cost_tab, const float* __restrict__ lut,
    float* __restrict__ benefit, int32_t* __restrict__ next_fn,
    float* __restrict__ est_out, float* __restrict__ cost_out,
    int64_t num_rows, int P, int Q, int num_states, int num_bins, int F, int lut_bins) {
  extern __shared__ float smem[];
  const TableRefs tab = stage_table<GLOBAL>(smem, delta_tab, next_tab, cost_tab, lut, P,
                                            num_states, num_bins, F, lut_bins);
  const int64_t lanes = num_rows * P;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < lanes; i += stride) {
    const int64_t c = i / P;
    const int p = (int)(i - c * P);
    const float pp = load_prob(pred_prob, i);
    const TableLane s = table_lane<GLOBAL>(tab, load_prob(unc, i), p, state_id[i], num_states,
                                           num_bins, F, lut_bins);
    for (int q = 0; q < Q; ++q) {
      const float j = load_prob(joint, (int64_t)q * num_rows + c);
      const float est = est_joint(j, pp, s.p_hat);
      const int64_t o = (int64_t)q * lanes + i;
      benefit[o] = s.fn >= 0 ? benefit_of(j, est, s.cost) : -INFINITY;
      next_fn[o] = s.fn;
      est_out[o] = est;
      cost_out[o] = s.cost;
    }
  }
}

// One query (Q = 1), f32 rows, and the candidate mask: a lane is valid when
// a function remains AND its object is a candidate.  next_fn, est_joint and
// cost are written as computed for every lane, as the TPU kernel does; cost
// is the table entry unfloored, the one the function returns.
template <bool GLOBAL>
__global__ void __launch_bounds__(kThreads) enrich_score_single_kernel(
    const float* __restrict__ pred_prob, const float* __restrict__ unc,
    const int32_t* __restrict__ state_id, const float* __restrict__ joint,
    const bool* __restrict__ cand,
    const float* __restrict__ delta_tab, const int32_t* __restrict__ next_tab,
    const float* __restrict__ cost_tab, const float* __restrict__ lut,
    float* __restrict__ benefit, int32_t* __restrict__ next_fn,
    float* __restrict__ est_out, float* __restrict__ cost_out,
    int64_t num_rows, int P, int num_states, int num_bins, int F, int lut_bins) {
  extern __shared__ float smem[];
  const TableRefs tab = stage_table<GLOBAL>(smem, delta_tab, next_tab, cost_tab, lut, P,
                                            num_states, num_bins, F, lut_bins);
  const int64_t lanes = num_rows * P;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < lanes; i += stride) {
    const int64_t c = i / P;
    const int p = (int)(i - c * P);
    const TableLane s = table_lane<GLOBAL>(tab, unc[i], p, state_id[i], num_states, num_bins,
                                           F, lut_bins);
    const float j = joint[c];
    const float est = est_joint(j, pred_prob[i], s.p_hat);
    benefit[i] = (s.fn >= 0 && cand[c]) ? benefit_of(j, est, s.cost) : -INFINITY;
    next_fn[i] = s.fn;
    est_out[i] = est;
    cost_out[i] = tab.cost[p * F + max(s.fn, 0)];
  }
}

// ---- best mode (see the header) -------------------------------------------

// What no joint probability enters, per (object, predicate) lane: p_hat for
// each of the F functions and whether it remains.
template <int F>
struct BestLane {
  float p_hat[F];
  bool ok[F];
};

// The start of a lane's [F] row in a [P, S, B, F] delta_all table (in
// shared or device memory), indexed in int64.
__device__ __forceinline__ const float* delta_row(const float* delta_all, int p, int state,
                                                  float h, int num_states, int num_bins, int F) {
  return delta_all + (((int64_t)p * num_states + state) * num_bins + bin_of(h, num_bins)) * F;
}

// The lane's [F] row of the table: in shared memory, or (GLOBAL) in device
// memory, read through the read-only path.
template <int F, bool GLOBAL>
__device__ __forceinline__ BestLane<F> best_lane(const float* delta_all, const float* s_lut,
                                                 float h, int p, int state, int num_states,
                                                 int num_bins, int lut_bins) {
  const float* d = delta_row(delta_all, p, state, h, num_states, num_bins, F);
  BestLane<F> r;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    float delta;
    if constexpr (GLOBAL) {
      delta = __ldg(d + f);
    } else {
      delta = d[f];
    }
    r.ok[f] = !isinf(delta);  // +inf: the function already ran
    r.p_hat[f] = lut_lerp(clip01(__fadd_rn(h, r.ok[f] ? delta : 0.0f)), s_lut, lut_bins);
  }
  return r;
}

struct BestOut {
  float benefit;
  int fn;
  float est;
  float cost;
};

// The first strict maximum of Eq. 11 over the remaining functions of one
// lane and one tenant, in function order (strict: ties keep the FIRST
// maximum; cost: the floored cost of the chosen function, of function 0 when
// none remains): every division.  phat(f), cost(f): p_hat and the floored
// cost of function f; bit f of ok: whether it remains; r = j / max(pp,
// 1e-12), once for all functions: the plain version's (j / max(pp)) * p_hat,
// bitwise.  W > 0 unrolls W functions; W == 0 walks a runtime F.
template <int W, typename PHat, typename Cost>
__device__ __forceinline__ BestOut best_fold(PHat phat, Cost cost, uint32_t ok, int F, float j,
                                             float r, float pp) {
  BestOut o{-INFINITY, -1, 0.0f, cost(0)};
#pragma unroll
  for (int f = 0; f < (W > 0 ? W : F); ++f) {
    if (ok >> f & 1u) {
      const float est = pp > 0.0f ? clip01(__fmul_rn(r, phat(f))) : 0.0f;
      const float ben = benefit_of(j, est, cost(f));
      if (ben > o.benefit) {
        o.benefit = ben;
        o.fn = f;
        o.est = est;
        o.cost = cost(f);
      }
    }
  }
  return o;
}

// The object kernel's fold over all F functions of a lane (cost[] floored).
template <int F>
__device__ __forceinline__ BestOut best_of(const BestLane<F>& s, const float* cost, float j,
                                           float pp) {
  uint32_t ok = 0;
#pragma unroll
  for (int f = 0; f < F; ++f) ok |= (uint32_t)s.ok[f] << f;
  return best_fold<F>([&](int f) { return s.p_hat[f]; }, [&](int f) { return cost[f]; }, ok, F,
                      j, __fdiv_rn(j, fmaxf(pp, kMinP)), pp);
}

// The object kernel's tables, staged in shared memory: [P*S*B*F] deltas,
// [P*F] costs, the LUT.
struct BestTables {
  const float* delta;
  const float* cost;
  const float* lut;
};

__device__ __forceinline__ BestTables stage_best(float* smem, const float* delta_all,
                                                 const float* cost_tab, const float* lut, int P,
                                                 int num_states, int num_bins, int F,
                                                 int lut_bins) {
  const int PF = P * F;
  const int tsize = P * num_states * num_bins * F;
  stage(smem, delta_all, tsize);
  stage(smem + tsize, cost_tab, PF);
  stage(smem + tsize + PF, lut, lut_bins);
  __syncthreads();
  return BestTables{smem, smem + tsize, smem + tsize + PF};
}

// [P] values of row c of a [C, P] tensor, widened to f32 (16 bytes for P = 4
// in f32, 8 in bf16: one load; 8 / 4 bytes for P = 2).
template <int P, typename T>
__device__ __forceinline__ void load_row(const T* base, int64_t c, float (&out)[P]) {
  const T* row = base + c * P;
  if constexpr (P == 4 && sizeof(T) == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (P == 4) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(row));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  } else if constexpr (P == 2 && sizeof(T) == 4) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(row));
    out[0] = v.x; out[1] = v.y;
  } else if constexpr (P == 2) {
    const float2 v = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(row)));
    out[0] = v.x; out[1] = v.y;
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p) out[p] = load_prob(row, p);
  }
}

template <int P>
__device__ __forceinline__ void load_ids(const int32_t* base, int64_t c, int (&out)[P]) {
  const int32_t* row = base + c * P;
  if constexpr (P == 4) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(row));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (P == 2) {
    const int2 v = __ldg(reinterpret_cast<const int2*>(row));
    out[0] = v.x; out[1] = v.y;
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p) out[p] = __ldg(row + p);
  }
}

// The [P] outputs of one (tenant, object) row, written once and never read
// here again: streaming stores (st.global.cs), 16 bytes each for P = 4.
template <int P>
__device__ __forceinline__ void store_row(float* benefit, int32_t* next_fn, float* est_out,
                                          float* cost_out, int64_t o, const BestOut (&r)[P]) {
  if constexpr (P == 4) {
    __stcs(reinterpret_cast<float4*>(benefit + o),
           make_float4(r[0].benefit, r[1].benefit, r[2].benefit, r[3].benefit));
    __stcs(reinterpret_cast<int4*>(next_fn + o), make_int4(r[0].fn, r[1].fn, r[2].fn, r[3].fn));
    __stcs(reinterpret_cast<float4*>(est_out + o),
           make_float4(r[0].est, r[1].est, r[2].est, r[3].est));
    __stcs(reinterpret_cast<float4*>(cost_out + o),
           make_float4(r[0].cost, r[1].cost, r[2].cost, r[3].cost));
  } else if constexpr (P == 2) {
    __stcs(reinterpret_cast<float2*>(benefit + o), make_float2(r[0].benefit, r[1].benefit));
    __stcs(reinterpret_cast<int2*>(next_fn + o), make_int2(r[0].fn, r[1].fn));
    __stcs(reinterpret_cast<float2*>(est_out + o), make_float2(r[0].est, r[1].est));
    __stcs(reinterpret_cast<float2*>(cost_out + o), make_float2(r[0].cost, r[1].cost));
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      __stcs(benefit + o + p, r[p].benefit);
      __stcs(next_fn + o + p, r[p].fn);
      __stcs(est_out + o + p, r[p].est);
      __stcs(cost_out + o + p, r[p].cost);
    }
  }
}

// P <= 4: one thread per object covers its P lanes: one read of the object's
// rows, one joint load per (object, tenant) for all P lanes, each output row
// of a tenant as one store (16 bytes at P = 4).  The P lanes' F divisions of
// a tenant are independent, so a thread keeps P * F of them in flight; a
// second tenant in flight as well took more registers than it hid latency
// (fewer blocks an SM, a slower kernel on the card).
template <typename T, int P, int F>
__global__ void __launch_bounds__(kThreads) enrich_score_best_kernel(
    const T* __restrict__ pred_prob, const T* __restrict__ unc,
    const int32_t* __restrict__ state_id, const T* __restrict__ joint,
    const float* __restrict__ delta_all, const float* __restrict__ cost_tab,
    const float* __restrict__ lut,
    float* __restrict__ benefit, int32_t* __restrict__ next_fn,
    float* __restrict__ est_out, float* __restrict__ cost_out,
    int64_t num_rows, int Q, int num_states, int num_bins, int lut_bins) {
  extern __shared__ float smem[];
  const BestTables t = stage_best(smem, delta_all, cost_tab, lut, P, num_states, num_bins, F,
                                  lut_bins);
  float cost[P][F];  // floored, the same for every object
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int f = 0; f < F; ++f) cost[p][f] = fmaxf(t.cost[p * F + f], kMinCost);

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; c < num_rows; c += stride) {
    float pp[P], h[P];
    int sid[P];
    load_row<P>(pred_prob, c, pp);
    load_row<P>(unc, c, h);
    load_ids<P>(state_id, c, sid);
    BestLane<F> lane[P];
#pragma unroll
    for (int p = 0; p < P; ++p)
      lane[p] = best_lane<F, false>(t.delta, t.lut, h[p], p, sid[p], num_states, num_bins,
                                    lut_bins);
    for (int q = 0; q < Q; ++q) {
      const float j = load_prob(joint, (int64_t)q * num_rows + c);
      BestOut r[P];
#pragma unroll
      for (int p = 0; p < P; ++p) r[p] = best_of<F>(lane[p], cost[p], j, pp[p]);
      store_row<P>(benefit, next_fn, est_out, cost_out, ((int64_t)q * num_rows + c) * P, r);
    }
  }
}

__device__ __forceinline__ void store_lane(float* benefit, int32_t* next_fn, float* est_out,
                                           float* cost_out, int64_t o, const BestOut& r) {
  __stcs(benefit + o, r.benefit);
  __stcs(next_fn + o, r.fn);
  __stcs(est_out + o, r.est);
  __stcs(cost_out + o, r.cost);
}

// ---- the screened fold (the lane and wide kernels; see the header) -------

// The lane kernels' per-block tables: the floored costs and their correctly
// rounded reciprocals, function-major ([F][P]: a warp's P predicates read
// neighbouring banks), and the LUT; the smem route also stages the deltas.
// screen: every floored cost is <= 2^126, so every reciprocal is a normal
// number, as the screen's proof needs; else every lane takes the exact fold.
struct ScreenTables {
  const float* delta;
  const float* cost;
  const float* inv;
  const float* lut;
  bool screen;
};

template <bool GLOBAL>
__device__ __forceinline__ ScreenTables stage_screen(float* smem, const float* delta_all,
                                                     const float* cost_tab, const float* lut,
                                                     int P, int num_states, int num_bins, int F,
                                                     int lut_bins) {
  const int PF = P * F;
  const int tsize = GLOBAL ? 0 : P * num_states * num_bins * F;
  float* s_cost = smem + tsize;
  float* s_inv = s_cost + PF;
  float* s_lut = s_inv + PF;
  if constexpr (!GLOBAL) stage(smem, delta_all, tsize);
  bool normal = true;
  for (int i = threadIdx.x; i < PF; i += blockDim.x) {
    const int f = i / P;
    const float c = fmaxf(cost_tab[(i - f * P) * F + f], kMinCost);
    s_cost[i] = c;
    s_inv[i] = __frcp_rn(c);
    normal = normal && c <= kCostHi;
  }
  stage(s_lut, lut, lut_bins);
  const bool screen = __syncthreads_and(normal) != 0;
  return ScreenTables{GLOBAL ? delta_all : smem, s_cost, s_inv, s_lut, screen};
}

// The running state of the screen over one lane and tenant: the largest
// estimate e1 (its first function g, with g's exact a = j * est and est) and
// the largest estimate of any other function e2.  A function that no longer
// remains has the reciprocal -inf: its estimate is -inf (or NaN where a is
// 0), which never becomes e1; a NaN may raise e2 to e1, which only sends the
// tenant to the exact fold.  Branch-free: min / max and selects.
struct Screen {
  float e1 = -INFINITY, e2 = -INFINITY, a1 = 0.0f, est1 = 0.0f;
  int g = -1;

  __device__ __forceinline__ void add(int f, float est, float a, float inv) {
    const float e = __fmul_rn(a, inv);  // a / cost within (1 + 2^-24)^2
    e2 = fmaxf(e2, fminf(e, e1));
    const bool up = e > e1;
    e1 = up ? e : e1;
    g = up ? f : g;
    a1 = up ? a : a1;
    est1 = up ? est : est1;
  }

  // The proof's condition (header): g is the first strict maximum.
  __device__ __forceinline__ bool decided(bool screen) const {
    return screen && e1 >= kScreenLo && e1 <= kScreenHi && e2 < __fmul_rn(e1, kScreen);
  }
};

// Best mode for one lane and tenant: the screen over the remaining functions
// (bit f of ok), then ONE correctly rounded division for the chosen function;
// where the screen cannot decide, the exact fold in function order (strict:
// ties keep the first maximum).  phat(f): p_hat of function f; inv(f): its
// reciprocal cost, -inf where it no longer remains; cost: the lane's column
// of the [F][P] floored costs.  W > 0 unrolls W functions; W == 0 walks a
// runtime F.
template <int W, typename PHat, typename Inv>
__device__ __forceinline__ BestOut best_screened(PHat phat, Inv inv, uint32_t ok,
                                                 const float* cost, int P, int F, float j,
                                                 float pp, bool screen) {
  const int n = W > 0 ? W : F;
  const bool live = pp > 0.0f;  // else est = 0 (the plain version's where)
  const float r = __fdiv_rn(j, fmaxf(pp, kMinP));  // the plain version's j / max(pp), bitwise
  Screen s;
#pragma unroll
  for (int f = 0; f < n; ++f) {
    const float est = live ? clip01(__fmul_rn(r, phat(f))) : 0.0f;
    s.add(f, est, __fmul_rn(j, est), inv(f));
  }
  if (ok == 0) return BestOut{-INFINITY, -1, 0.0f, cost[0]};  // no function remains
  // Every a = j * est is a signed zero (j zero, or est zero for every
  // function with j finite): each benefit is that zero, the first remaining
  // function wins and g is it (its estimate 0 is the first above -inf).
  const bool zero = j == 0.0f || (!live && fabsf(j) < INFINITY);
  if (s.g >= 0 && (zero || s.decided(screen))) {
    const float c = cost[s.g * P];
    return BestOut{__fdiv_rn(s.a1, c), s.g, s.est1, c};
  }
  // a near tie: every division, in order
  return best_fold<W>(phat, [&](int f) { return cost[f * P]; }, ok, F, j, r, pp);
}

// P > 4 on the smem route, and every P on the global route (F <= 10): one
// thread per (object, predicate) lane, looping over the tenants.  The
// lane's p_hat and reciprocal costs live in registers; per tenant the
// screen, then one division.  Unbounded, ptxas leaves room for only 3
// blocks an SM at F 8; from F 8 it is held to 64 registers (4 blocks),
// which ran faster on the card at F 8 and slower at F 4.
template <typename T, int F, bool GLOBAL>
__global__ void __launch_bounds__(kThreads, F >= kMaxFunctions ? 4 : 1)
    enrich_score_best_lane_kernel(
    const T* __restrict__ pred_prob, const T* __restrict__ unc,
    const int32_t* __restrict__ state_id, const T* __restrict__ joint,
    const float* __restrict__ delta_all, const float* __restrict__ cost_tab,
    const float* __restrict__ lut,
    float* __restrict__ benefit, int32_t* __restrict__ next_fn,
    float* __restrict__ est_out, float* __restrict__ cost_out,
    int64_t num_rows, int P, int Q, int num_states, int num_bins, int lut_bins) {
  extern __shared__ float smem[];
  const ScreenTables t = stage_screen<GLOBAL>(smem, delta_all, cost_tab, lut, P, num_states,
                                              num_bins, F, lut_bins);
  const int64_t lanes = num_rows * P;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < lanes; i += stride) {
    const int64_t c = i / P;
    const int p = (int)(i - c * P);
    const float pp = load_prob(pred_prob, i);
    const BestLane<F> lane = best_lane<F, GLOBAL>(t.delta, t.lut, load_prob(unc, i), p,
                                                  state_id[i], num_states, num_bins, lut_bins);
    float inv[F];  // -inf where the function no longer remains
    uint32_t ok = 0;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      inv[f] = lane.ok[f] ? t.inv[f * P + p] : -INFINITY;
      ok |= (uint32_t)lane.ok[f] << f;
    }
    float j = load_prob(joint, c);
    for (int q = 0; q < Q; ++q) {  // the next tenant's joint loads while this one scores
      const float j_next = q + 1 < Q ? load_prob(joint, (int64_t)(q + 1) * num_rows + c) : 0.0f;
      const BestOut r = best_screened<F>(
          [&](int f) { return lane.p_hat[f]; }, [&](int f) { return inv[f]; }, ok, t.cost + p,
          P, F, j, pp, t.screen);
      store_lane(benefit, next_fn, est_out, cost_out, (int64_t)q * lanes + i, r);
      j = j_next;
    }
  }
}

// F > kMaxLane (global route only): one thread per lane, a runtime F (<=
// kMaxWide).  The lane's p_hat and reciprocal costs are computed once (F
// lerps, not F per tenant) into the thread's two columns of shared memory,
// [F][kThreads] each, and its remaining functions into one 32-bit mask; per
// tenant the screen reads both columns, then one division.
template <typename T>
__global__ void __launch_bounds__(kThreads) enrich_score_best_wide_kernel(
    const T* __restrict__ pred_prob, const T* __restrict__ unc,
    const int32_t* __restrict__ state_id, const T* __restrict__ joint,
    const float* __restrict__ delta_all, const float* __restrict__ cost_tab,
    const float* __restrict__ lut,
    float* __restrict__ benefit, int32_t* __restrict__ next_fn,
    float* __restrict__ est_out, float* __restrict__ cost_out,
    int64_t num_rows, int P, int Q, int num_states, int num_bins, int F, int lut_bins) {
  extern __shared__ float smem[];
  const ScreenTables t = stage_screen<true>(smem, delta_all, cost_tab, lut, P, num_states,
                                            num_bins, F, lut_bins);
  // this thread's columns: p_hat, then the reciprocal costs (-inf where the
  // function no longer remains)
  float* row = smem + 2 * P * F + lut_bins + threadIdx.x;
  float* row_inv = row + F * kThreads;
  const int64_t lanes = num_rows * P;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < lanes; i += stride) {
    const int64_t c = i / P;
    const int p = (int)(i - c * P);
    const float pp = load_prob(pred_prob, i);
    const float h = load_prob(unc, i);
    const float* d = delta_row(t.delta, p, state_id[i], h, num_states, num_bins, F);
    uint32_t ok = 0;
    for (int f = 0; f < F; ++f) {
      const float delta = __ldg(d + f);
      const bool remains = !isinf(delta);  // +inf: the function already ran
      ok |= (uint32_t)remains << f;
      row[f * kThreads] = lut_lerp(clip01(__fadd_rn(h, remains ? delta : 0.0f)), t.lut,
                                   lut_bins);
      row_inv[f * kThreads] = remains ? t.inv[f * P + p] : -INFINITY;
    }
    float j = load_prob(joint, c);
    for (int q = 0; q < Q; ++q) {
      const float j_next = q + 1 < Q ? load_prob(joint, (int64_t)(q + 1) * num_rows + c) : 0.0f;
      const BestOut r = best_screened<0>(
          [&](int f) { return row[f * kThreads]; },
          [&](int f) { return row_inv[f * kThreads]; }, ok, t.cost + p, P, F, j, pp, t.screen);
      store_lane(benefit, next_fn, est_out, cost_out, (int64_t)q * lanes + i, r);
      j = j_next;
    }
  }
}

template <typename K>
cudaError_t launch_grid(K kernel, size_t smem, int64_t lanes, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int64_t need = (lanes + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  *grid = (int)(need < cap ? need : cap);
  return cudaSuccess;
}

// Dynamic shared memory of each kernel (the Python wrapper picks the route
// and refuses what even the global route's costs and LUT cannot hold).
size_t table_smem(int P, int num_states, int num_bins, int F, int lut_bins, bool global) {
  const size_t tables = global ? 0 : (size_t)P * num_states * num_bins * 2;
  return sizeof(float) * (tables + (size_t)P * F + lut_bins);
}

size_t best_smem(int P, int num_states, int num_bins, int F, int lut_bins) {
  return sizeof(float) * ((size_t)P * num_states * num_bins * F + (size_t)P * F + lut_bins);
}

// The lane kernels: the staged deltas (smem route), costs and reciprocals,
// the LUT and, in the wide kernel, two columns of F floats a thread.
size_t lane_smem(int P, int num_states, int num_bins, int F, int lut_bins, bool global,
                 bool wide) {
  const size_t tables = global ? 0 : (size_t)P * num_states * num_bins * F;
  const size_t rows = wide ? 2 * (size_t)kThreads * F : 0;
  return sizeof(float) * (tables + 2 * (size_t)P * F + lut_bins + rows);
}

// The best-mode launch: F (1..10), the route and, for P <= 4 on the smem
// route, P are template parameters of the kernel; past F 10 the wide kernel
// takes a runtime F (<= kMaxWide).
struct BestArgs {
  const void *pred_prob, *unc, *state_id, *joint, *delta_all, *cost_tab, *lut;
  void *benefit, *next_fn, *est_joint, *cost;
  int64_t num_rows;
  int P, Q, num_states, num_bins, F, lut_bins;
  cudaStream_t stream;
};

template <typename T, int P, int F>
cudaError_t launch_best_obj(const BestArgs& a) {
  auto k = enrich_score_best_kernel<T, P, F>;
  const size_t smem = best_smem(P, a.num_states, a.num_bins, F, a.lut_bins);
  int grid = 0;
  cudaError_t err = launch_grid(k, smem, a.num_rows, &grid);
  if (err != cudaSuccess) return err;
  k<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.pred_prob), static_cast<const T*>(a.unc),
      static_cast<const int32_t*>(a.state_id), static_cast<const T*>(a.joint),
      static_cast<const float*>(a.delta_all), static_cast<const float*>(a.cost_tab),
      static_cast<const float*>(a.lut), static_cast<float*>(a.benefit),
      static_cast<int32_t*>(a.next_fn), static_cast<float*>(a.est_joint),
      static_cast<float*>(a.cost), a.num_rows, a.Q, a.num_states, a.num_bins, a.lut_bins);
  return cudaGetLastError();
}

template <typename T, int F, bool GLOBAL>
cudaError_t launch_best_lanes(const BestArgs& a) {
  auto k = enrich_score_best_lane_kernel<T, F, GLOBAL>;
  const size_t smem = lane_smem(a.P, a.num_states, a.num_bins, F, a.lut_bins, GLOBAL, false);
  int grid = 0;
  cudaError_t err = launch_grid(k, smem, a.num_rows * a.P, &grid);
  if (err != cudaSuccess) return err;
  k<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.pred_prob), static_cast<const T*>(a.unc),
      static_cast<const int32_t*>(a.state_id), static_cast<const T*>(a.joint),
      static_cast<const float*>(a.delta_all), static_cast<const float*>(a.cost_tab),
      static_cast<const float*>(a.lut), static_cast<float*>(a.benefit),
      static_cast<int32_t*>(a.next_fn), static_cast<float*>(a.est_joint),
      static_cast<float*>(a.cost), a.num_rows, a.P, a.Q, a.num_states, a.num_bins, a.lut_bins);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_best_wide(const BestArgs& a) {
  auto k = enrich_score_best_wide_kernel<T>;
  const size_t smem = lane_smem(a.P, a.num_states, a.num_bins, a.F, a.lut_bins, true, true);
  int grid = 0;
  cudaError_t err = launch_grid(k, smem, a.num_rows * a.P, &grid);
  if (err != cudaSuccess) return err;
  k<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.pred_prob), static_cast<const T*>(a.unc),
      static_cast<const int32_t*>(a.state_id), static_cast<const T*>(a.joint),
      static_cast<const float*>(a.delta_all), static_cast<const float*>(a.cost_tab),
      static_cast<const float*>(a.lut), static_cast<float*>(a.benefit),
      static_cast<int32_t*>(a.next_fn), static_cast<float*>(a.est_joint),
      static_cast<float*>(a.cost), a.num_rows, a.P, a.Q, a.num_states, a.num_bins, a.F,
      a.lut_bins);
  return cudaGetLastError();
}

template <typename T, int F, bool GLOBAL>
cudaError_t best_dispatch_p(const BestArgs& a) {
  if constexpr (GLOBAL) {
    return launch_best_lanes<T, F, true>(a);
  } else {
    switch (a.P) {
      case 1: return launch_best_obj<T, 1, F>(a);
      case 2: return launch_best_obj<T, 2, F>(a);
      case 3: return launch_best_obj<T, 3, F>(a);
      case 4: return launch_best_obj<T, 4, F>(a);
      default: return launch_best_lanes<T, F, false>(a);
    }
  }
}

template <typename T, bool GLOBAL>
cudaError_t best_dispatch_f(const BestArgs& a) {
  switch (a.F) {
    case 1: return best_dispatch_p<T, 1, GLOBAL>(a);
    case 2: return best_dispatch_p<T, 2, GLOBAL>(a);
    case 3: return best_dispatch_p<T, 3, GLOBAL>(a);
    case 4: return best_dispatch_p<T, 4, GLOBAL>(a);
    case 5: return best_dispatch_p<T, 5, GLOBAL>(a);
    case 6: return best_dispatch_p<T, 6, GLOBAL>(a);
    case 7: return best_dispatch_p<T, 7, GLOBAL>(a);
    default: return best_dispatch_p<T, 8, GLOBAL>(a);
  }
}

// Past F 8 (global route): unrolled lane kernels to F 10, then the wide kernel.
template <typename T>
cudaError_t best_dispatch_wide(const BestArgs& a) {
  static_assert(kMaxLane == 10, "one case per F up to kMaxLane");
  switch (a.F) {
    case 9: return launch_best_lanes<T, 9, true>(a);
    case 10: return launch_best_lanes<T, 10, true>(a);
    default: return launch_best_wide<T>(a);
  }
}

template <typename T>
cudaError_t best_dispatch(const BestArgs& a, bool global) {
  if (a.F > kMaxFunctions)
    return global && a.F <= kMaxWide ? best_dispatch_wide<T>(a) : cudaErrorInvalidValue;
  return global ? best_dispatch_f<T, true>(a) : best_dispatch_f<T, false>(a);
}

// The table-mode and single-query launches, templated on the probability
// type and the route (cand: the single-query kernel's candidate mask).
struct TableArgs {
  const void *pred_prob, *unc, *state_id, *joint, *cand, *delta_tab, *next_tab, *cost_tab, *lut;
  void *benefit, *next_fn, *est_joint, *cost;
  int64_t num_rows;
  int P, Q, num_states, num_bins, F, lut_bins;
  cudaStream_t stream;
};

template <typename T, bool GLOBAL>
cudaError_t launch_table(const TableArgs& a) {
  auto k = enrich_score_table_kernel<T, GLOBAL>;
  const size_t smem = table_smem(a.P, a.num_states, a.num_bins, a.F, a.lut_bins, GLOBAL);
  int grid = 0;
  cudaError_t err = launch_grid(k, smem, a.num_rows * a.P, &grid);
  if (err != cudaSuccess) return err;
  k<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.pred_prob), static_cast<const T*>(a.unc),
      static_cast<const int32_t*>(a.state_id), static_cast<const T*>(a.joint),
      static_cast<const float*>(a.delta_tab), static_cast<const int32_t*>(a.next_tab),
      static_cast<const float*>(a.cost_tab), static_cast<const float*>(a.lut),
      static_cast<float*>(a.benefit), static_cast<int32_t*>(a.next_fn),
      static_cast<float*>(a.est_joint), static_cast<float*>(a.cost),
      a.num_rows, a.P, a.Q, a.num_states, a.num_bins, a.F, a.lut_bins);
  return cudaGetLastError();
}

template <bool GLOBAL>
cudaError_t launch_single(const TableArgs& a) {
  auto k = enrich_score_single_kernel<GLOBAL>;
  const size_t smem = table_smem(a.P, a.num_states, a.num_bins, a.F, a.lut_bins, GLOBAL);
  int grid = 0;
  cudaError_t err = launch_grid(k, smem, a.num_rows * a.P, &grid);
  if (err != cudaSuccess) return err;
  k<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.pred_prob), static_cast<const float*>(a.unc),
      static_cast<const int32_t*>(a.state_id), static_cast<const float*>(a.joint),
      static_cast<const bool*>(a.cand), static_cast<const float*>(a.delta_tab),
      static_cast<const int32_t*>(a.next_tab), static_cast<const float*>(a.cost_tab),
      static_cast<const float*>(a.lut), static_cast<float*>(a.benefit),
      static_cast<int32_t*>(a.next_fn), static_cast<float*>(a.est_joint),
      static_cast<float*>(a.cost), a.num_rows, a.P, a.num_states, a.num_bins, a.F, a.lut_bins);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 == success).  global:
// the route (0 "smem", 1 "global"), as kernel.table_route picks it.
int enrich_score_table(const void* pred_prob, const void* unc, const void* state_id,
                       const void* joint, const void* delta_tab, const void* next_tab,
                       const void* cost_tab, const void* lut, void* benefit, void* next_fn,
                       void* est_joint, void* cost, int64_t num_rows, int P, int Q,
                       int num_states, int num_bins, int F, int lut_bins, int bf16, int global,
                       void* stream) {
  if (num_rows * P == 0 || Q == 0) return (int)cudaSuccess;
  TableArgs a{pred_prob, unc, state_id, joint, nullptr, delta_tab, next_tab, cost_tab, lut,
              benefit, next_fn, est_joint, cost, num_rows, P, Q, num_states, num_bins, F,
              lut_bins, static_cast<cudaStream_t>(stream)};
  if (bf16)
    return (int)(global ? launch_table<__nv_bfloat16, true>(a)
                        : launch_table<__nv_bfloat16, false>(a));
  return (int)(global ? launch_table<float, true>(a) : launch_table<float, false>(a));
}

int enrich_score_single(const void* pred_prob, const void* unc, const void* state_id,
                        const void* joint, const void* cand, const void* delta_tab,
                        const void* next_tab, const void* cost_tab, const void* lut,
                        void* benefit, void* next_fn, void* est_joint, void* cost,
                        int64_t num_rows, int P, int num_states, int num_bins, int F,
                        int lut_bins, int global, void* stream) {
  if (num_rows * P == 0) return (int)cudaSuccess;
  TableArgs a{pred_prob, unc, state_id, joint, cand, delta_tab, next_tab, cost_tab, lut,
              benefit, next_fn, est_joint, cost, num_rows, P, 1, num_states, num_bins, F,
              lut_bins, static_cast<cudaStream_t>(stream)};
  return (int)(global ? launch_single<true>(a) : launch_single<false>(a));
}

int enrich_score_best(const void* pred_prob, const void* unc, const void* state_id,
                      const void* joint, const void* delta_all, const void* cost_tab,
                      const void* lut, void* benefit, void* next_fn, void* est_joint,
                      void* cost, int64_t num_rows, int P, int Q, int num_states,
                      int num_bins, int F, int lut_bins, int bf16, int global, void* stream) {
  if (num_rows * P == 0 || Q == 0) return (int)cudaSuccess;
  if (F < 1) return (int)cudaErrorInvalidValue;
  BestArgs a{pred_prob, unc, state_id, joint, delta_all, cost_tab, lut, benefit, next_fn,
             est_joint, cost, num_rows, P, Q, num_states, num_bins, F, lut_bins,
             static_cast<cudaStream_t>(stream)};
  return (int)(bf16 ? best_dispatch<__nv_bfloat16>(a, global != 0)
                    : best_dispatch<float>(a, global != 0));
}

}  // extern "C"
