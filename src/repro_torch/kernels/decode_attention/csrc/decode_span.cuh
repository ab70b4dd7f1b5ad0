// The keys a decode query attends to, and how the decode kernels split them.
// Shared by decode_attention.cu (the simt partials kernel) and
// decode_attention_fused.cu (the fused kernel and the partials' tensor-core
// form), so that every kernel reads one definition of the reference
// kernel's mask (src/repro/kernels/decode_attention/kernel.py:51): the query
// sits at kv_len and key j is live iff j < kv_len and, under a window,
// j > kv_len - window.

#pragma once

struct KeySpan {
  int lo, hi;  // the keys [lo, hi); empty when lo >= hi
};

// The live keys of a cache of skv rows: [max(0, kv_len - window + 1), min(kv_len,
// skv)), from 0 with no window (window < 0).
__device__ __forceinline__ KeySpan live_keys(int kv_len, int skv, int window) {
  KeySpan s;
  s.hi = min(kv_len, skv);
  s.lo = window >= 0 ? max(0, kv_len - window + 1) : 0;
  return s;
}

// Split `split` of the cache length in rows of ck ([split * ck, (split + 1) *
// ck)), intersected with the live keys: the reference's splits.
__device__ __forceinline__ KeySpan cache_split(KeySpan live, int split, int ck) {
  KeySpan s;
  s.lo = max(live.lo, split * ck);
  s.hi = min(live.hi, split * ck + ck);
  return s;
}

// Share `rank` of ns of the L live keys: [lo + floor(rank * L / ns), lo +
// floor((rank + 1) * L / ns)).  The shares differ by at most one key, and
// one is empty only when L < ns (the fused kernel's splits).
__device__ __forceinline__ KeySpan live_share(KeySpan live, int rank, int ns) {
  const long long n = max(live.hi - live.lo, 0);
  KeySpan s;
  s.lo = live.lo + static_cast<int>(rank * n / ns);
  s.hi = live.lo + static_cast<int>((rank + 1) * n / ns);
  return s;
}
