// Relax kernels of the PyTorch port, CUDA C++ for sm_90a.
//
// Three kernels with a plain C interface (built with nvcc into a shared
// library and loaded with ctypes by repro_torch/kernels/_build.py):
//
//   B1 repro_wd_relax_lanes  replaces repro/kernels/relax.py wd_relax_lanes
//                            (Pallas body _wd_kernel): the WD merge-path
//                            search fused with the relax.
//      repro_wd_relax_union  B1's batch contract, the reference's jax.vmap
//                            of it in multi_source.batched_wd_relax (a grid
//                            axis of the pallas_call): one merge path over
//                            the union of the K rows' frontiers, on
//                            node-major [n, kp] values and frontier bytes.
//   B2 repro_relax_lanes     replaces repro/kernels/relax.py relax_lanes
//                            (Pallas body _lanes_kernel): the relax over
//                            direct-mapped (src, dst, w, valid) lanes.
//   B3 repro_find_offsets    replaces repro/kernels/find_offsets.py
//                            find_offsets: rank(k) = #{i : prefix[i] <= k}.
//
// The Pallas kernels fake every gather and scatter with broadcast compares
// over 128-wide VMEM chunks because the TPU vector unit cannot gather per
// lane.  Hopper gathers natively, so B1 and B2 gather per lane and fold
// with atomics into a target buffer the caller gives: int32 ones, or a
// float32 operator's sign-split fold (relax_lanes.cuh, whose Val is the
// value type of the build).
//
// Parity with the reference (bit for bit on int32):
//   * every lane reads dist[src] and dist[dst] from the unmodified `dist`
//     (through the read-only path) and folds improving candidates into
//     `target`, which must not alias it.  The wrapper passes either the
//     monoid identity (relax_lanes / wd_relax_lanes: the proposal) or a
//     copy of dist (apply_relax / wd_apply_relax: the next dist, with no
//     elementwise fold afterwards).  min, max and wrapping int32 add are
//     associative and commutative, so both give the reference's bits.
//     No lane of a launch sees another lane's write.
//   * int32 atomicMin/atomicMax do not depend on order, and atomicAdd wraps
//     like the reference's int32 add, so any atomic order gives the same
//     bits; so does the float fold of min and max (a float add's sum
//     depends on the order of its terms, in the reference too).  The
//     `sum` message v + w wraps through unsigned arithmetic (signed
//     overflow is undefined in C++).
//   * updated[dst] = 1 wherever a lane improves dst: a benign race, every
//     writer stores the same byte, into the caller's running mask.
//
// What bounds them on the H100: memory and launch.  A lane is a chain of
// dependent loads (B2: valid -> src/dst/w -> two dist gathers -> an
// atomic; B1: a search -> the slot entries -> col/wt -> two dist gathers
// -> an atomic) with a handful of integer operations.  The main path's
// B2 launches are mostly invalid lanes: a BS column is ~340,000 lanes of
// which ~0.6% are valid, an HP tile ~2% valid.  The design keeps several
// chains in flight a thread and does shared work once a tile:
//   * B2: a thread takes B2_LANES lanes of a block tile, strided by the
//     block so that each load of a warp is coalesced, and issues all
//     their independent loads before the dependent gathers; an invalid
//     lane loads nothing past its valid byte and gathers nothing.
//   * B1: Merrill and Garland's merge-path partition.  A block tile of
//     B1_TILE lanes finds its first and last slot with one 32-ary search
//     each (a warp probes 32 points per round: 4 rounds of one load a lane
//     for 2^20 slots, not 20 dependent loads per lane), stages that slot
//     slice of prefix/exclusive/start/src_ids in shared memory with
//     cp.async, and every lane ranks itself in shared memory.  A slice
//     wider than B1_SLOTS (long runs of zero-degree slots, HP's tail
//     cursors past the end) keeps the per-lane global search, narrowed to
//     the slice.
//   * B1's batch contract: the K rows of a stepped batch share most of
//     their frontiers (the K = 8 rmat20 batch's widest launch: 58 M row
//     lanes over 8.4 M edges), so one merge path runs over the union of
//     the rows' frontiers and reads each edge, slot and frontier word
//     once, with a node's values of four rows in one 16-byte load; a pass
//     a row would read them K times.
//   * B3: the items are consecutive, so a tile stages its prefix slice
//     and ranks every item in shared memory, as B1 does, and writes
//     16-byte runs.
//   * every grid is one wave of resident blocks on the card's SMs, each
//     block striding over the tiles.
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit by
// tools/compare_relax_kernels.py, against the one-lane-a-thread kernels
// and the proposal fold they replaced, in one process, on launches kept
// from the rmat20 runs themselves (device time, L2-cold / warm):
//   * a BS column's apply_relax (copy + launch) 0.0128 / 0.0092 ms
//     against 0.0228 / 0.0171 for fill + zero + launch + minimum + OR;
//     an HP tile 0.229 ms against 0.316; a WD iteration's wd_relax
//     0.0481 / 0.0416 ms against 0.0655 / 0.0594;
//   * the kernels alone on the path (torch.profiler, the same launches,
//     median us a launch): B2 2.57 a BS column against 2.52, 219.9 an HP
//     tile against 319.8, 2.71 an AD launch against 3.08; B1 37.0 a WD
//     launch against 44.8, but 5.1-5.4 a small HP-tail or AD launch
//     against 3.7-3.9 (the tile's search and staging do not pay for
//     ~30,000 lanes).
// A BS column is mostly launch and the 4 MB copy: the kernel reads a
// valid byte and writes an improve byte for ~340,000 lanes, ~0.6% of
// them valid.  Four lanes a thread were about 17% slower there than two,
// and a 16-byte vector branch for aligned groups 4-7% faster in BS and
// 7% in HP, for a second code path.  PERF.md has the tables.
// The lane bodies (message, activation test, fold, B2's gather-and-fold
// and B1's rank-and-relax tile) live in relax_lanes.cuh, which the fused
// fixed point (fused.cu) shares.  A user-defined operator's build
// (REPRO_CUSTOM_OP_HEADER, MSG_CUSTOM there) instantiates each kernel here
// for that operator alone.
// Each entry point launches on the given stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "attrs.cuh"
#include "relax_lanes.cuh"

namespace {

using namespace relax_lanes;

// B2: lanes a thread takes, and the lanes a block tile covers.  Two beat
// one and four on the main path's own launches (PERF.md).
constexpr int B2_LANES = 2;
constexpr int B2_TILE = THREADS * B2_LANES;

// ---------------------------------------------------------------- B2 ---
// A block tile covers B2_TILE lanes; thread t takes lanes t and
// t + THREADS of it, so every load of a warp is one coalesced run.
template <int MSG, int COMB>
__global__ void __launch_bounds__(THREADS)
relax_lanes_kernel(const Val* __restrict__ dist, int32_t n,
                   const int32_t* __restrict__ src,
                   const int32_t* __restrict__ dst,
                   const int32_t* __restrict__ w,
                   const uint8_t* __restrict__ valid, int32_t lanes,
                   Val* __restrict__ target, uint8_t* __restrict__ upd,
                   uint8_t* __restrict__ imp) {
  constexpr int L = B2_LANES;
  const int64_t tiles = ((int64_t)lanes + B2_TILE - 1) / B2_TILE;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t k0 = t * B2_TILE + threadIdx.x;
    bool v[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int64_t k = k0 + j * THREADS;
      v[j] = k < lanes && __ldg(valid + k);
    }
    int32_t s[L] = {}, d[L] = {}, wv[L] = {};
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (v[j]) {
        const int64_t k = k0 + j * THREADS;
        s[j] = __ldg(src + k);
        d[j] = __ldg(dst + k);
        wv[j] = __ldg(w + k);
      }
    }
    bool improved[L];
    relax_group<L, MSG, COMB, ReadOnly>(dist, n, v, s, d, wv, target, upd,
                                        improved, NoHook());
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int64_t k = k0 + j * THREADS;
      if (k < lanes) imp[k] = improved[j];
    }
  }
}

// ---------------------------------------------------------------- B1 ---
template <int MSG, int COMB>
__global__ void __launch_bounds__(THREADS)
wd_relax_lanes_kernel(const Val* __restrict__ dist, int32_t n,
                      const int32_t* __restrict__ prefix,
                      const int32_t* __restrict__ excl,
                      const int32_t* __restrict__ start,
                      const int32_t* __restrict__ src_ids, int32_t f,
                      const int32_t* __restrict__ col,
                      const int32_t* __restrict__ wt, int32_t e,
                      int32_t cap_work, Val* __restrict__ target,
                      uint8_t* __restrict__ upd, uint8_t* __restrict__ imp) {
  __shared__ WdSmem sm;
  const int64_t total = __ldg(prefix + f - 1);    // valid lanes: k < total
  const int64_t tiles = ((int64_t)cap_work + B1_TILE - 1) / B1_TILE;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x)
    wd_tile<MSG, COMB, ReadOnly>(t, dist, n, prefix, excl, start, src_ids, f,
                                 col, wt, e, cap_work, total, target, upd,
                                 imp, sm, NoHook());
}

// ----------------------------------------------------------- B1 batch ---
// B1's batch contract over the union frontier, node-major.  The K rows'
// values and frontier bytes are node-major, dist/target [n, kp] int32 and
// front/upd [n, kp] bytes with kp = K rounded up to 4, so one node's
// values of four rows are one 16-byte Val4 (int4; float4 in a float
// build) and their frontier bytes one
// 4-byte word.  A slot is a node active in any row (the union frontier)
// and a lane one out-edge of a slot: the merge path runs once over the
// union's lanes, not once a row.  A lane takes kp / 4 items, one a thread,
// each owning four rows (a quad): it loads col/wt once, the source's four
// frontier bytes in one load, and, if any of them is set, the source's
// and the destination's four values as one int4 each; each row whose
// byte is set folds its candidate against the snapshot.  Padded rows
// (past K) have no frontier byte set and are never written.
//
// A row cut short (the reference's cap_work, a row's own lane budget)
// needs each row's lane index of the edge: row_excl [f, kp] holds each
// row's exclusive degree prefix at the slot, and a row relaxes the edge
// only if row_excl + (k - excl) < cap_work.  row_excl == nullptr: no row
// is cut (run_batch's capacities hold every row), and nothing is read.
// The union's lane count is read on the device (prefix[f - 1]); the
// grid is a wave of resident blocks striding over the tiles.  Two items
// a thread (46 registers, 5 blocks a SM) beat four (78, 3 blocks) by 7%
// over the K = 8 and 9% over the K = 32 rmat20 batch's launches, and
// eight (140 registers) lost 1.75x: the gathers want warps in flight
// (tools/compare_batch_runs.py, PERF.md).
constexpr int UB_ITEMS = 2;                   // items a thread takes
constexpr int UB_TILE = THREADS * UB_ITEMS;   // items a block tile covers

template <int MSG, int COMB>
__device__ __forceinline__ void fold_quad(uint32_t fr, Val4 ds, Val4 dd,
                                          int32_t w, int64_t at,
                                          const int32_t* row_excl,
                                          int64_t rx_at, int32_t off,
                                          int32_t cap_work, Val* target,
                                          uint8_t* upd) {
  int4 rx = make_int4(0, 0, 0, 0);
  if (row_excl) rx = __ldg(reinterpret_cast<const int4*>(row_excl + rx_at));
  const Val dsv[4] = {ds.x, ds.y, ds.z, ds.w};
  const Val ddv[4] = {dd.x, dd.y, dd.z, dd.w};
  const int32_t rxv[4] = {rx.x, rx.y, rx.z, rx.w};
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (!((fr >> (8 * b)) & 0xffu)) continue;
    if (row_excl && (int64_t)rxv[b] + off >= cap_work) continue;
    const auto cand = message<MSG>(dsv[b], w);
    if (!improves<MSG, COMB>(cand, ddv[b])) continue;
    fold<COMB>(target + at + b, narrow<MSG>(cand));
    upd[at + b] = 1;
  }
}

template <int MSG, int COMB>
__global__ void __launch_bounds__(THREADS)
wd_relax_union_kernel(const Val* __restrict__ dist, int32_t n,
                      int32_t kp, const uint8_t* __restrict__ front,
                      const int32_t* __restrict__ prefix,
                      const int32_t* __restrict__ excl,
                      const int32_t* __restrict__ start,
                      const int32_t* __restrict__ src_ids, int32_t f,
                      const int32_t* __restrict__ row_excl, int32_t cap_work,
                      const int32_t* __restrict__ col,
                      const int32_t* __restrict__ wt, int32_t e,
                      Val* __restrict__ target,
                      uint8_t* __restrict__ upd) {
  constexpr int L = UB_ITEMS;
  __shared__ WdSmem sm;
  const int32_t quads = kp >> 2;
  const int64_t items = (int64_t)__ldg(prefix + f - 1) * quads;
  const int64_t tiles = (items + UB_TILE - 1) / UB_TILE;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t m0 = t * UB_TILE;
    const int64_t m_end = m0 + UB_TILE < items ? m0 + UB_TILE : items;
    // the slots of the tile's first and last lane (all lanes are valid:
    // the tile ends at the union's last item)
    const int warp = threadIdx.x >> 5;
    if (warp < 2) {
      const int64_t k = (warp == 0 ? m0 : m_end - 1) / quads;
      const int32_t r = warp_upper_bound<ReadOnly>(prefix, f, (int32_t)k);
      if ((threadIdx.x & 31) == 0) sm.bounds[warp] = r;
    }
    __syncthreads();
    const int32_t lo = sm.bounds[0], hi = sm.bounds[1];
    const int32_t cnt = hi - lo + 1;          // slots [lo, hi]
    const bool staged = cnt <= B1_SLOTS;
    if (staged) {
      for (int32_t i = threadIdx.x; i < cnt; i += THREADS) {
        ReadOnly::stage(sm.prefix + i, prefix + lo + i);
        ReadOnly::stage(sm.excl + i, excl + lo + i);
        ReadOnly::stage(sm.start + i, start + lo + i);
        ReadOnly::stage(sm.src + i, src_ids + lo + i);
      }
      ReadOnly::stage_wait();
    }
    __syncthreads();

    bool v[L];
    int32_t s[L] = {}, c[L] = {}, wv[L] = {}, off[L] = {}, slot[L] = {};
    int32_t q[L] = {};
    uint32_t fr[L] = {};
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int64_t m = m0 + j * THREADS + threadIdx.x;
      v[j] = m < m_end;
      if (!v[j]) continue;
      const int32_t k = (int32_t)(m / quads);
      q[j] = (int32_t)(m - (int64_t)k * quads);
      int32_t ex, st, li;
      if (staged) {
        li = smem_upper_bound(sm.prefix, cnt - 1, k);
        ex = sm.excl[li];
        st = sm.start[li];
        s[j] = sm.src[li];
      } else {
        li = upper_bound<ReadOnly>(prefix + lo, cnt - 1, k);
        ex = __ldg(excl + lo + li);
        st = __ldg(start + lo + li);
        s[j] = __ldg(src_ids + lo + li);
      }
      slot[j] = lo + li;
      off[j] = k - ex;
      const int32_t ec = clamp_index((int64_t)st + off[j], e);
      s[j] = clamp_index(s[j], n);
      c[j] = clamp_index(__ldg(col + ec), n);
      wv[j] = wt ? __ldg(wt + ec) : 1;
      fr[j] = __ldg(reinterpret_cast<const unsigned int*>(
          front + (int64_t)s[j] * kp + 4 * q[j]));
    }
    Val4 ds[L], dd[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (v[j] && fr[j]) {
        ds[j] = __ldg(reinterpret_cast<const Val4*>(
            dist + (int64_t)s[j] * kp + 4 * q[j]));
        dd[j] = __ldg(reinterpret_cast<const Val4*>(
            dist + (int64_t)c[j] * kp + 4 * q[j]));
      }
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (v[j] && fr[j])
        fold_quad<MSG, COMB>(fr[j], ds[j], dd[j], wv[j],
                             (int64_t)c[j] * kp + 4 * q[j], row_excl,
                             (int64_t)slot[j] * kp + 4 * q[j], off[j],
                             cap_work, target, upd);
    }
    __syncthreads();                    // the slice is free for the next tile
  }
}

// ---------------------------------------------------------------- B3 ---
// rank(k) = #{i < f : prefix[i] <= k} for every k < cap_work.  The items
// are consecutive integers, so rank is a step function over a tile: a
// block tile of B3_TILE items finds the ranks of its first and last item
// with one 32-ary warp search each, stages that prefix slice in shared
// memory with cp.async, and each thread ranks its B3_ITEMS consecutive
// items there (its first and last by a search of the slice, the others
// between those two ranks, mostly one probe) and writes them as int4s.
// A slice wider than B3_SLOTS (long runs of equal prefix entries: zero-
// degree slots) keeps the search in global memory, narrowed to the slice.
constexpr int B3_ITEMS = 8;
constexpr int B3_TILE = THREADS * B3_ITEMS;
constexpr int B3_SLOTS = 2 * B3_TILE;

// lo + #{i in [lo, hi) : p[i] <= k} for a non-decreasing p, in shared
// memory (STAGED) or in global memory
template <bool STAGED>
__device__ __forceinline__ int32_t count_le(const int32_t* p, int32_t lo,
                                            int32_t hi, int32_t k) {
  return lo + (STAGED ? smem_upper_bound(p + lo, hi - lo, k)
                      : upper_bound<ReadOnly>(p + lo, hi - lo, k));
}

// the ranks, relative to the slice p [0, m), of items a .. b (b - a <
// B3_ITEMS)
template <bool STAGED>
__device__ __forceinline__ void rank_run(const int32_t* p, int32_t m,
                                         int32_t a, int32_t b,
                                         int32_t (&r)[B3_ITEMS]) {
  const int32_t ra = count_le<STAGED>(p, 0, m, a);
  const int32_t rb = count_le<STAGED>(p, ra, m, b);
  r[0] = ra;
#pragma unroll
  for (int j = 1; j < B3_ITEMS; ++j)
    r[j] = a + j <= b ? count_le<STAGED>(p, ra, rb, a + j) : rb;
}

__global__ void __launch_bounds__(THREADS)
find_offsets_kernel(const int32_t* __restrict__ prefix, int32_t f,
                    int32_t cap_work, int32_t* __restrict__ out) {
  __shared__ int32_t sp[B3_SLOTS];
  __shared__ int32_t bounds[2];
  const int64_t tiles = ((int64_t)cap_work + B3_TILE - 1) / B3_TILE;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t k0 = t * B3_TILE;
    const int64_t k_end = k0 + B3_TILE < cap_work ? k0 + B3_TILE : cap_work;
    const int warp = threadIdx.x >> 5;
    if (warp < 2) {
      const int32_t r = warp_upper_bound<ReadOnly>(
          prefix, f, (int32_t)(warp == 0 ? k0 : k_end - 1));
      if ((threadIdx.x & 31) == 0) bounds[warp] = r;
    }
    __syncthreads();
    // every item of the tile ranks in [lo, hi]: the slots below lo hold
    // prefix <= k0, those from hi on prefix > k_end - 1
    const int32_t lo = bounds[0], m = bounds[1] - lo;
    const bool staged = m <= B3_SLOTS;
    if (staged) {
      for (int32_t i = threadIdx.x; i < m; i += THREADS)
        ReadOnly::stage(sp + i, prefix + lo + i);
      ReadOnly::stage_wait();
    }
    __syncthreads();
    const int64_t a = k0 + (int64_t)threadIdx.x * B3_ITEMS;
    if (a < k_end) {
      const int64_t b = a + B3_ITEMS <= k_end ? a + B3_ITEMS - 1 : k_end - 1;
      int32_t r[B3_ITEMS];
      if (staged)
        rank_run<true>(sp, m, (int32_t)a, (int32_t)b, r);
      else
        rank_run<false>(prefix + lo, m, (int32_t)a, (int32_t)b, r);
      if (b - a == B3_ITEMS - 1) {      // a whole run: 16-byte stores
        int4* o = reinterpret_cast<int4*>(out + a);
#pragma unroll
        for (int j = 0; j < B3_ITEMS / 4; ++j)
          o[j] = make_int4(lo + r[4 * j], lo + r[4 * j + 1],
                           lo + r[4 * j + 2], lo + r[4 * j + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < B3_ITEMS; ++j)
          if (a + j <= b) out[a + j] = lo + r[j];
      }
    }
    __syncthreads();                    // the slice is free for the next tile
  }
}

// The resident blocks of one wave of `kernel` on the current device,
// `per_sm` cached by the caller (one static per instantiation).
template <typename Kernel>
int64_t wave_blocks(Kernel kernel, int* per_sm) {
  static int sms[64];
  int dev = 0;
  cudaGetDevice(&dev);
  int& count = sms[dev & 63];
  if (count == 0)
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  if (*per_sm == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, THREADS, 0);
  return (int64_t)count * *per_sm;
}

inline unsigned grid_for(int64_t blocks, int64_t wave) {
  return (unsigned)(blocks < wave ? blocks : wave);
}

template <int MSG, int COMB>
void launch_lanes_t(cudaStream_t st, const Val* dist, int32_t n,
                    const int32_t* src, const int32_t* dst, const int32_t* w,
                    const uint8_t* valid, int32_t lanes, Val* target,
                    uint8_t* upd, uint8_t* imp) {
  static int per_sm = 0;
  const int64_t tiles = ((int64_t)lanes + B2_TILE - 1) / B2_TILE;
  const unsigned grid = grid_for(
      tiles, wave_blocks(relax_lanes_kernel<MSG, COMB>, &per_sm));
  relax_lanes_kernel<MSG, COMB><<<grid, THREADS, 0, st>>>(
      dist, n, src, dst, w, valid, lanes, target, upd, imp);
}

template <int MSG, int COMB>
void launch_wd_t(cudaStream_t st, const Val* dist, int32_t n,
                 const int32_t* prefix, const int32_t* excl,
                 const int32_t* start, const int32_t* src_ids, int32_t f,
                 const int32_t* col, const int32_t* wt, int32_t e,
                 int32_t cap_work, Val* target, uint8_t* upd,
                 uint8_t* imp) {
  static int per_sm = 0;
  const int64_t tiles = ((int64_t)cap_work + B1_TILE - 1) / B1_TILE;
  const unsigned grid = grid_for(
      tiles, wave_blocks(wd_relax_lanes_kernel<MSG, COMB>, &per_sm));
  wd_relax_lanes_kernel<MSG, COMB><<<grid, THREADS, 0, st>>>(
      dist, n, prefix, excl, start, src_ids, f, col, wt, e, cap_work, target,
      upd, imp);
}

template <int MSG, int COMB>
void launch_union_t(cudaStream_t st, const Val* dist, int32_t n,
                    int32_t kp, const uint8_t* front, const int32_t* prefix,
                    const int32_t* excl, const int32_t* start,
                    const int32_t* src_ids, int32_t f,
                    const int32_t* row_excl, int32_t cap_work,
                    const int32_t* col, const int32_t* wt, int32_t e,
                    int64_t max_lanes, Val* target, uint8_t* upd) {
  static int per_sm = 0;
  const int64_t tiles = (max_lanes * (kp >> 2) + UB_TILE - 1) / UB_TILE;
  const unsigned grid = grid_for(
      tiles > 0 ? tiles : 1,
      wave_blocks(wd_relax_union_kernel<MSG, COMB>, &per_sm));
  wd_relax_union_kernel<MSG, COMB><<<grid, THREADS, 0, st>>>(
      dist, n, kp, front, prefix, excl, start, src_ids, f, row_excl,
      cap_work, col, wt, e, target, upd);
}

}  // namespace

extern "C" {

// B2: lanes >= 1, n >= 1; dist and target [n] hold the build's Val;
// target (not dist) and upd [n] are folded into, not initialised.
int repro_relax_lanes(const Val* dist, int32_t n, const int32_t* src,
                      const int32_t* dst, const int32_t* w,
                      const uint8_t* valid, int32_t lanes, int msg, int comb,
                      Val* target, uint8_t* upd, uint8_t* imp,
                      void* stream) {
  if (!codes_ok(msg, comb) || lanes < 1 || n < 1 || target == dist)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  with_codes(msg, comb, [&](auto m, auto c) {
    launch_lanes_t<decltype(m)::value, decltype(c)::value>(
        st, dist, n, src, dst, w, valid, lanes, target, upd, imp);
  });
  return (int)cudaGetLastError();
}

// B1: f >= 1, e >= 1, cap_work >= 1; wt == nullptr means weight 1;
// target [n] (not dist) and upd [n] are folded into, not initialised.
int repro_wd_relax_lanes(const Val* dist, int32_t n,
                         const int32_t* prefix, const int32_t* excl,
                         const int32_t* start, const int32_t* src_ids,
                         int32_t f, const int32_t* col, const int32_t* wt,
                         int32_t e, int32_t cap_work, int msg, int comb,
                         Val* target, uint8_t* upd, uint8_t* imp,
                         void* stream) {
  if (!codes_ok(msg, comb) || f < 1 || e < 1 || n < 1 || cap_work < 1 ||
      target == dist)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  with_codes(msg, comb, [&](auto m, auto c) {
    launch_wd_t<decltype(m)::value, decltype(c)::value>(
        st, dist, n, prefix, excl, start, src_ids, f, col, wt, e, cap_work,
        target, upd, imp);
  });
  return (int)cudaGetLastError();
}

// B1's batch contract over the union frontier: dist, target [n, kp]
// Val and front, upd [n, kp] bytes (kp a multiple of 4, each row of 16
// bytes' alignment), the union's slot tables [f], row_excl [f, kp] or
// nullptr (no row cut); f, e, n >= 1; max_lanes (>= 0) bounds the union's
// lanes and sizes the grid only.  target (a copy of dist, not dist) and
// upd are folded into, not initialised.
int repro_wd_relax_union(const Val* dist, int32_t n, int32_t kp,
                         const uint8_t* front, const int32_t* prefix,
                         const int32_t* excl, const int32_t* start,
                         const int32_t* src_ids, int32_t f,
                         const int32_t* row_excl, int32_t cap_work,
                         const int32_t* col, const int32_t* wt, int32_t e,
                         long long max_lanes, int msg, int comb,
                         Val* target, uint8_t* upd, void* stream) {
  if (!codes_ok(msg, comb) || f < 1 || e < 1 || n < 1 || kp < 4 ||
      kp % 4 != 0 || max_lanes < 0 || cap_work < 0 || target == dist)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  with_codes(msg, comb, [&](auto m, auto c) {
    launch_union_t<decltype(m)::value, decltype(c)::value>(
        st, dist, n, kp, front, prefix, excl, start, src_ids, f, row_excl,
        cap_work, col, wt, e, max_lanes, target, upd);
  });
  return (int)cudaGetLastError();
}

// B3: cap_work >= 1; f == 0 ranks every item to 0.
int repro_find_offsets(const int32_t* prefix, int32_t f, int32_t cap_work,
                       int32_t* out, void* stream) {
  if (cap_work < 1 || f < 0) return (int)cudaErrorInvalidValue;
  static int per_sm = 0;
  const unsigned grid = grid_for(((int64_t)cap_work + B3_TILE - 1) / B3_TILE,
                                 wave_blocks(find_offsets_kernel, &per_sm));
  find_offsets_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      prefix, f, cap_work, out);
  return (int)cudaGetLastError();
}

// The block shape of B2 (which 0), B1 (1), B1's batch contract (2) or B3
// (3), the build's AttrCodes instance where templated (shortest_path's,
// or a custom build's operator), for the block-feasibility report: out
// [ATTR_CELLS] as repro_block_attrs (attrs.cuh); none of them takes
// dynamic shared memory.
int repro_relax_block_attrs(int which, int* out) {
  constexpr int M = AttrCodes::msg, C = AttrCodes::comb;
  const void* kernels[] = {(const void*)relax_lanes_kernel<M, C>,
                           (const void*)wd_relax_lanes_kernel<M, C>,
                           (const void*)wd_relax_union_kernel<M, C>,
                           (const void*)find_offsets_kernel};
  if (which < 0 || which > 3) return (int)cudaErrorInvalidValue;
  return (int)repro_block_attrs(kernels[which], THREADS, 0, out);
}

const char* repro_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
