// Lane bodies of the relax kernels, shared by relax.cu (B1, B2) and by the
// fused fixed point (fused.cu): the message, the activation test and the
// fold of one candidate, B2's gather-and-fold of a group of loaded lanes,
// and B1's rank-and-relax over one tile of merge-path lanes.
//
// Two things differ between the callers, and both are template arguments:
//   * how a lane reads the arrays it gathers from (`Ld`).  B1 and B2 never
//     write `dist` or their slot tables during a launch, so they read them
//     through the read-only path (`ReadOnly`: __ldg, cp.async.ca).  The
//     fused kernel writes its snapshot and its slot tables between grid
//     barriers of the same launch, and the read-only path is not kept
//     coherent with writes of the launch, so it reads them from L2
//     (`Coherent`: ld.global.cg) and stages with plain L2 loads;
//   * what an improving lane does besides the fold (`Hook`): nothing in
//     B1/B2, a note of the destination in the fused kernel, which carries
//     the improved entries into its other value buffer after the chunk.
// `col` and `wt` are never written by any launch and always take __ldg.
//
// A user-defined operator (repro_torch.kernels.opgen) is one more message
// code, MSG_CUSTOM: its message and activation test are the functions
// repro_op_message and repro_op_improves of a generated header, which a
// custom build (kernels/_build.py custom_lib) names in
// REPRO_CUSTOM_OP_HEADER before it includes relax.cu or fused.cu.  Such a
// build instantiates every kernel for that one operator, <MSG_CUSTOM,
// REPRO_OP_COMB>, and nothing else; the base build never sees MSG_CUSTOM.
//
// The value type.  The values (dist, the proposal, the fused kernel's two
// buffers) are `Val` (values.cuh): int32_t in the base build and an int32
// operator's, float in a float32 operator's build (its header defines
// REPRO_OP_FLOAT).
// Indices, slot tables and weights stay int32 everywhere: a float message
// takes its int32 weight and converts it as torch promotes it (the
// lowered header's repro_op_i2f, __int2float_rn).  A float min or max
// folds as IEEE 754-2019 minimum/maximum (-0.0 below +0.0, NaN absorbing),
// which is what the reference's .at[].min/max and the port's
// EdgeOp.scatter give, whatever the lanes' order; a float add folds by a
// compare-and-swap of the rounded sum, which depends on the order of its
// terms.
//
// A sub-word operator's header (REPRO_OP_SUBWORD) names its value type,
// repro_op_val: int16_t, int8_t, uint8_t, or a bfloat16 or float16 held as
// its bits (uint16_t), and the type of its message's result, repro_op_msg,
// which may be wider (int16 + an int32 weight is int32, as torch and the
// reference promote it).  The activation test compares the wide candidate;
// repro_op_narrow then narrows it to the value type as .to(dist.dtype)
// does, before the fold.  No 8- or 16-bit atomic exists, so the fold is a
// compare-and-swap loop on the aligned 32-bit word that holds the value,
// which rewrites only the value's own bytes of it, with values.cuh's
// fold_value (min, max or add in that type: integers wrap, a 16-bit
// float's min and max are IEEE minimum and maximum, -0.0 below +0.0 and
// NaN absorbing, its add rounds float(a) + float(b) to the type once).
// A quad of the batch contract is 8 bytes of 16-bit values and 4 of 8-bit
// ones.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#ifdef REPRO_CUSTOM_OP_HEADER
#include REPRO_CUSTOM_OP_HEADER
#endif
#include "values.cuh"

namespace relax_lanes {

// four values of one node's rows, loaded at once (the batch contract)
template <class T>
struct Quad;
template <>
struct Quad<int32_t> { using type = int4; };
template <>
struct Quad<float> { using type = float4; };
template <>
struct Quad<int16_t> { using type = short4; };
template <>
struct Quad<uint16_t> { using type = ushort4; };
template <>
struct Quad<int8_t> { using type = char4; };
template <>
struct Quad<uint8_t> { using type = uchar4; };
using Val4 = typename Quad<Val>::type;

// message codes (repro_torch.core.operators.KERNEL_MESSAGES, MSG_CUSTOM)
constexpr int MSG_SUM = 0;         // v + w (wrapping)
constexpr int MSG_COPY = 1;        // v
constexpr int MSG_BOTTLENECK = 2;  // min(v, w)
constexpr int MSG_CUSTOM = 3;      // repro_op_message, repro_op_improves

constexpr int THREADS = 256;
// B1: lanes a thread takes, and the lanes a block tile covers
constexpr int B1_LANES = 4;
constexpr int B1_TILE = THREADS * B1_LANES;
// B1: slots a tile stages in shared memory (4 int32 tables: 32 KB)
constexpr int B1_SLOTS = 2 * B1_TILE;

// the (msg, comb) pairs the build has instances for: the nine built-in
// pairs, or a custom build's one
inline bool codes_ok(int msg, int comb) {
#ifdef REPRO_CUSTOM_OP_HEADER
  return msg == MSG_CUSTOM && comb == REPRO_OP_COMB;
#else
  return msg >= MSG_SUM && msg <= MSG_BOTTLENECK && comb >= COMB_MIN &&
         comb <= COMB_ADD;
#endif
}

template <int V>
using Code = std::integral_constant<int, V>;

// Calls f(Code<MSG>{}, Code<COMB>{}) with the build's instance of the
// codes codes_ok accepted, so that each entry point names its launch once.
// IDEMPOTENT: min and max only (the delta mode has no add instances).
template <bool IDEMPOTENT = false, class F>
inline void with_codes(int msg, int comb, F&& f) {
#ifdef REPRO_CUSTOM_OP_HEADER
  (void)msg;
  (void)comb;
  if constexpr (!IDEMPOTENT || REPRO_OP_COMB != COMB_ADD)
    f(Code<MSG_CUSTOM>{}, Code<REPRO_OP_COMB>{});
#else
  const auto by_comb = [&](auto m) {
    if (comb == COMB_MIN) f(m, Code<COMB_MIN>{});
    else if (comb == COMB_MAX) f(m, Code<COMB_MAX>{});
    else if constexpr (!IDEMPOTENT) f(m, Code<COMB_ADD>{});
  };
  if (msg == MSG_SUM) by_comb(Code<MSG_SUM>{});
  else if (msg == MSG_COPY) by_comb(Code<MSG_COPY>{});
  else by_comb(Code<MSG_BOTTLENECK>{});
#endif
}

// the instance the block-attribute reports describe: shortest_path's in
// the base build, the operator's in a custom build
template <int M, int C>
struct Codes {
  static constexpr int msg = M, comb = C;
};
#ifdef REPRO_CUSTOM_OP_HEADER
using AttrCodes = Codes<MSG_CUSTOM, REPRO_OP_COMB>;
#else
using AttrCodes = Codes<MSG_SUM, COMB_MIN>;
#endif

struct ReadOnly {
  template <class T>
  static __device__ __forceinline__ T ld(const T* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void stage(int32_t* smem,
                                               const int32_t* gmem) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  }
  static __device__ __forceinline__ void stage_wait() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
};

struct Coherent {
  template <class T>
  static __device__ __forceinline__ T ld(const T* p) {
    return __ldcg(p);
  }
  // cp.async.cg copies 16 bytes only; a slot slice starts anywhere
  static __device__ __forceinline__ void stage(int32_t* smem,
                                               const int32_t* gmem) {
    *smem = __ldcg(gmem);
  }
  static __device__ __forceinline__ void stage_wait() {}
};

struct NoHook {
  __device__ __forceinline__ void operator()(int32_t) const {}
};

// the candidate of an edge: of the value type, or of the operator's
// message type (repro_op_msg) in a sub-word build
template <int MSG>
__device__ __forceinline__ auto message(Val v, int32_t w) {
#ifdef REPRO_CUSTOM_OP_HEADER
  if constexpr (MSG == MSG_CUSTOM) {
    return repro_op_message(v, w);
  } else
#endif
  if constexpr (MSG == MSG_SUM) {
    return (Val)(int32_t)((uint32_t)v + (uint32_t)w);
  } else if constexpr (MSG == MSG_COPY) {
    return v;
  } else {
    return (Val)(v < w ? v : w);
  }
}

// the activation test: the operator's own for MSG_CUSTOM (its update
// predicate, or the combine's default), else the built-in operators'; for
// add the identity is 0, so "a real contribution" is cand != 0
template <int MSG, int COMB, class M>
__device__ __forceinline__ bool improves(M cand, Val cur) {
#ifdef REPRO_CUSTOM_OP_HEADER
  if constexpr (MSG == MSG_CUSTOM) {
    return repro_op_improves(cand, cur);
  } else
#endif
  {
    if (COMB == COMB_MIN) return cand < cur;
    if (COMB == COMB_MAX) return cand > cur;
    return cand != 0;
  }
}

// a candidate narrowed to the value type, as .to(dist.dtype) narrows it
template <int MSG, class M>
__device__ __forceinline__ Val narrow(M cand) {
#ifdef REPRO_OP_SUBWORD
  if constexpr (MSG == MSG_CUSTOM) {
    return repro_op_narrow(cand);
  } else
#endif
  {
    return cand;
  }
}

template <int COMB>
__device__ __forceinline__ void fold(int32_t* p, int32_t cand) {
  if (COMB == COMB_MIN) atomicMin(p, cand);
  else if (COMB == COMB_MAX) atomicMax(p, cand);
  else atomicAdd(p, cand);
}

#ifdef REPRO_OP_FLOAT
// A float fold.  min and max by the sign split: the bits of a float with
// the sign clear order as int32 as the values do, those of a float with
// it set order as uint32 in reverse, and every set sign's bits exceed
// every clear sign's as uint32 and fall below them as int32.  So min
// takes atomicMin on the int32 bits of a candidate >= +0.0 and atomicMax
// on the uint32 bits of one <= -0.0 (max the other way round), which
// ranks -0.0 below +0.0, and the fold does not depend on the lanes' order.
// A NaN candidate writes the combine's NaN, the one pattern each of those
// atomics keeps (min: 0xffffffff, -1 as int32 and the largest uint32;
// max: 0x7fffffff); a target that holds a NaN already (an operand the
// chunk began with) is left alone, read first.  operators.FOLD_NAN_BITS
// holds the same two patterns.
template <int COMB>
__device__ __forceinline__ void fold(float* p, float cand) {
  if (COMB == COMB_ADD) {
    // a CAS loop with __fadd_rn, not atomicAdd(float*): the atomic's add
    // flushes subnormal inputs and results to zero (PTX atom.add.f32),
    // where torch's CPU sum keeps them
    unsigned* const pu = reinterpret_cast<unsigned*>(p);
    unsigned old = __float_as_uint(__ldcg(p)), seen;
    do {
      seen = old;
      old = atomicCAS(pu, seen,
                      __float_as_uint(__fadd_rn(__uint_as_float(seen), cand)));
    } while (old != seen);
    return;
  }
  if (isnan(__ldcg(p))) return;
  int32_t* const pi = reinterpret_cast<int32_t*>(p);
  unsigned* const pu = reinterpret_cast<unsigned*>(p);
  if (isnan(cand)) {
    if (COMB == COMB_MIN) atomicMax(pu, 0xffffffffu);
    else atomicMax(pi, 0x7fffffff);
    return;
  }
  const int32_t b = __float_as_int(cand);
  if (COMB == COMB_MIN) {
    if (b >= 0) atomicMin(pi, b);
    else atomicMax(pu, (unsigned)b);
  } else {
    if (b >= 0) atomicMax(pi, b);
    else atomicMin(pu, (unsigned)b);
  }
}
#endif

#ifdef REPRO_OP_SUBWORD
// A sub-word fold: a compare-and-swap loop on the aligned 32-bit word that
// holds *p, which rewrites only *p's bytes (the other values of the word
// are read and written back as they were, so a concurrent fold or store
// of a neighbour fails the swap and the loop retries).  fold_value
// (values.cuh) is the combine in the value type; a fold that changes nothing stores
// nothing.  Order-free for min and max (and for integer add, which
// wraps); a 16-bit float add depends on the order of its terms.
template <int COMB>
__device__ __forceinline__ void fold(Val* p, Val cand) {
  using U = std::make_unsigned_t<Val>;
  constexpr unsigned MASK = (1u << (8 * sizeof(Val))) - 1u;
  const uintptr_t at = reinterpret_cast<uintptr_t>(p);
  unsigned* const word = reinterpret_cast<unsigned*>(at & ~(uintptr_t)3);
  const unsigned shift = (unsigned)(at & 3) * 8u;
  unsigned old = __ldcg(word), seen;
  do {
    seen = old;
    const unsigned bits = (seen >> shift) & MASK;
    const unsigned next = (U)fold_value<COMB>((Val)(U)bits, cand);
    if (next == bits) return;
    old = atomicCAS(word, seen, (seen & ~(MASK << shift)) | (next << shift));
  } while (old != seen);
}
#endif

__device__ __forceinline__ int32_t clamp_index(int64_t i, int32_t n) {
  return (int32_t)(i < 0 ? 0 : (i >= n ? n - 1 : i));
}

// the fold of one lane whose gathers are done; returns "improves"
template <int MSG, int COMB, class Hook>
__device__ __forceinline__ bool fold_lane(Val dsrc, Val ddst, int32_t w,
                                          int32_t d, Val* target,
                                          uint8_t* upd, const Hook& hook) {
  const auto cand = message<MSG>(dsrc, w);
  if (!improves<MSG, COMB>(cand, ddst)) return false;
  fold<COMB>(target + d, narrow<MSG>(cand));
  upd[d] = 1;
  hook(d);
  return true;
}

// B2's lane body: L lanes whose (src, dst, w) are loaded and whose
// validity is v[j] clamp their ends into [0, n), gather both from `dist`
// (all loads first, then the folds) and fold the improving candidates
// into `target`; imp[j] says which improved.
template <int L, int MSG, int COMB, class Ld, class Hook>
__device__ __forceinline__ void relax_group(
    const Val* dist, int32_t n, const bool (&v)[L], int32_t (&s)[L],
    int32_t (&d)[L], const int32_t (&w)[L], Val* target, uint8_t* upd,
    bool (&imp)[L], const Hook& hook) {
  Val ds[L] = {}, dd[L] = {};
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (v[j]) {
      s[j] = clamp_index(s[j], n);
      d[j] = clamp_index(d[j], n);
      ds[j] = Ld::ld(dist + s[j]);
      dd[j] = Ld::ld(dist + d[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < L; ++j)
    imp[j] = v[j] && fold_lane<MSG, COMB>(ds[j], dd[j], w[j], d[j], target,
                                          upd, hook);
}

// #{i < f : prefix[i] <= k} for a non-decreasing prefix — searchsorted
// side="right".  One thread alone; B1's fallback and B3.
template <class Ld>
__device__ __forceinline__ int32_t upper_bound(const int32_t* prefix,
                                               int32_t f, int32_t k) {
  int32_t lo = 0, hi = f;
  while (lo < hi) {
    int32_t mid = (int32_t)(((uint32_t)lo + (uint32_t)hi) >> 1);
    if (Ld::ld(prefix + mid) <= k) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The same count by the 32 lanes of a warp together, all of which must
// call it with the same arguments.  Each round probes 32 evenly spaced
// points of [lo, hi); the answer lies between the last point <= k and the
// next one, so the range shrinks 32-fold a round.
template <class Ld>
__device__ __forceinline__ int32_t warp_upper_bound(const int32_t* prefix,
                                                    int32_t f, int32_t k) {
  const int lane = threadIdx.x & 31;
  int32_t lo = 0, hi = f;             // the answer lies in [lo, hi]
  while (lo < hi) {
    const int64_t step = ((int64_t)hi - lo + 31) / 32;
    const int64_t p = lo + lane * step;
    const bool le = p < hi && Ld::ld(prefix + p) <= k;
    const int c = __popc(__ballot_sync(0xffffffffu, le));
    if (c == 0) break;                // prefix[lo] > k: the answer is lo
    const int64_t last = lo + (int64_t)(c - 1) * step;   // prefix <= k
    lo = (int32_t)(last + 1);
    if (last + step < hi) hi = (int32_t)(last + step);   // prefix > k
  }
  return lo;
}

// the same count over a slice in shared memory
__device__ __forceinline__ int32_t smem_upper_bound(const int32_t* p,
                                                    int32_t m, int32_t k) {
  int32_t lo = 0, hi = m;
  while (lo < hi) {
    int32_t mid = (lo + hi) >> 1;
    if (p[mid] <= k) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// a B1 tile's slot slice, staged in shared memory
struct WdSmem {
  int32_t prefix[B1_SLOTS], excl[B1_SLOTS], start[B1_SLOTS], src[B1_SLOTS];
  int32_t bounds[2];
};

// B1's rank-and-relax body for block tile t of a merge path over
// `cap_work` lanes (Merrill and Garland's partition): the tile finds the
// slots of its first and last valid lane (k < total) with one 32-ary warp
// search each, stages that slot slice of prefix/exclusive/start/src_ids
// in shared memory, and every lane ranks itself there, takes edge
// start + k - exclusive and relaxes it.  A slice wider than B1_SLOTS (long
// runs of zero-degree slots, HP's tail cursors past the end) keeps the
// per-lane global search, narrowed to the slice.  Every thread of the
// block calls it with the same t; imp (may be null) gets each lane's
// improve flag.
template <int MSG, int COMB, class Ld, class Hook>
__device__ __forceinline__ void wd_tile(
    int64_t t, const Val* dist, int32_t n, const int32_t* prefix,
    const int32_t* excl, const int32_t* start, const int32_t* src_ids,
    int32_t f, const int32_t* col, const int32_t* wt, int32_t e,
    int32_t cap_work, int64_t total, Val* target, uint8_t* upd,
    uint8_t* imp, WdSmem& sm, const Hook& hook) {
  constexpr int L = B1_LANES;
  const int64_t k0 = t * B1_TILE;
  const int64_t k_end = k0 + B1_TILE < cap_work ? k0 + B1_TILE : cap_work;
  const int64_t v_end = k_end < total ? k_end : total;
  if (k0 >= v_end) {                    // no valid lane in the tile
    if (imp)
      for (int64_t k = k0 + threadIdx.x; k < k_end; k += THREADS) imp[k] = 0;
    return;
  }
  // the slots of the tile's first and last valid lane; every valid lane
  // ranks below f, since k < total = prefix[f - 1]
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int32_t r = warp_upper_bound<Ld>(
        prefix, f, (int32_t)(warp == 0 ? k0 : v_end - 1));
    if ((threadIdx.x & 31) == 0) sm.bounds[warp] = r;
  }
  __syncthreads();
  const int32_t lo = sm.bounds[0], hi = sm.bounds[1];
  const int32_t cnt = hi - lo + 1;      // slots [lo, hi]
  const bool staged = cnt <= B1_SLOTS;
  if (staged) {
    for (int32_t i = threadIdx.x; i < cnt; i += THREADS) {
      Ld::stage(sm.prefix + i, prefix + lo + i);
      Ld::stage(sm.excl + i, excl + lo + i);
      Ld::stage(sm.start + i, start + lo + i);
      Ld::stage(sm.src + i, src_ids + lo + i);
    }
    Ld::stage_wait();
  }
  __syncthreads();

  // rank(k) = lo + #{i in [lo, hi) : prefix[i] <= k} for k in the tile
  bool v[L];
  int32_t s[L] = {}, c[L] = {}, wv[L] = {};
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int64_t k = k0 + j * THREADS + threadIdx.x;
    v[j] = k < v_end;
    if (!v[j]) continue;
    int32_t ex, st;
    if (staged) {
      const int32_t li = smem_upper_bound(sm.prefix, cnt - 1, (int32_t)k);
      ex = sm.excl[li];
      st = sm.start[li];
      s[j] = sm.src[li];
    } else {
      const int32_t i =
          lo + upper_bound<Ld>(prefix + lo, cnt - 1, (int32_t)k);
      ex = Ld::ld(excl + i);
      st = Ld::ld(start + i);
      s[j] = Ld::ld(src_ids + i);
    }
    const int32_t ec = clamp_index((int64_t)st + (k - ex), e);
    c[j] = __ldg(col + ec);
    wv[j] = wt ? __ldg(wt + ec) : 1;
  }
  bool improved[L];
  relax_group<L, MSG, COMB, Ld>(dist, n, v, s, c, wv, target, upd, improved,
                                hook);
  if (imp) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int64_t k = k0 + j * THREADS + threadIdx.x;
      if (k < k_end) imp[k] = improved[j];
    }
  }
  __syncthreads();                      // the slice is free for the next tile
}

}  // namespace relax_lanes
