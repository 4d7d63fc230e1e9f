// Relax kernels of the PyTorch port, CUDA C++ for sm_90a.
//
// Three kernels with a plain C interface (built with nvcc into a shared
// library and loaded with ctypes by repro_torch/kernels/_build.py):
//
//   B1 repro_wd_relax_lanes  replaces repro/kernels/relax.py wd_relax_lanes
//                            (Pallas body _wd_kernel): the WD merge-path
//                            search fused with the relax.
//      repro_wd_relax_lanes_batch  B1 over K rows at once, the reference's
//                            jax.vmap of it in multi_source.batched_wd_relax
//                            (a grid axis of the pallas_call): dist, target
//                            and upd are [K, n], the slot tables [K, f].
//   B2 repro_relax_lanes     replaces repro/kernels/relax.py relax_lanes
//                            (Pallas body _lanes_kernel): the relax over
//                            direct-mapped (src, dst, w, valid) lanes.
//   B3 repro_find_offsets    replaces repro/kernels/find_offsets.py
//                            find_offsets: rank(k) = #{i : prefix[i] <= k}.
//
// The Pallas kernels fake every gather and scatter with broadcast compares
// over 128-wide VMEM chunks because the TPU vector unit cannot gather per
// lane.  Hopper gathers natively, so B1 and B2 gather per lane and fold
// with int32 atomics into a target buffer the caller gives.
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
//     bits.  The `sum` message v + w wraps through unsigned arithmetic
//     (signed overflow is undefined in C++).
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
//   * both grids are one wave of resident blocks on the card's SMs, each
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
// fixed point (fused.cu) shares.
// Each entry point launches on the given stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

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
relax_lanes_kernel(const int32_t* __restrict__ dist, int32_t n,
                   const int32_t* __restrict__ src,
                   const int32_t* __restrict__ dst,
                   const int32_t* __restrict__ w,
                   const uint8_t* __restrict__ valid, int32_t lanes,
                   int32_t* __restrict__ target, uint8_t* __restrict__ upd,
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
wd_relax_lanes_kernel(const int32_t* __restrict__ dist, int32_t n,
                      const int32_t* __restrict__ prefix,
                      const int32_t* __restrict__ excl,
                      const int32_t* __restrict__ start,
                      const int32_t* __restrict__ src_ids, int32_t f,
                      const int32_t* __restrict__ col,
                      const int32_t* __restrict__ wt, int32_t e,
                      int32_t cap_work, int32_t* __restrict__ target,
                      uint8_t* __restrict__ upd, uint8_t* __restrict__ imp) {
  __shared__ WdSmem sm;
  const int64_t total = __ldg(prefix + f - 1);    // valid lanes: k < total
  const int64_t tiles = ((int64_t)cap_work + B1_TILE - 1) / B1_TILE;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x)
    wd_tile<MSG, COMB, ReadOnly>(t, dist, n, prefix, excl, start, src_ids, f,
                                 col, wt, e, cap_work, total, target, upd,
                                 imp, sm, NoHook());
}

// B1 over K rows: the row is folded into the tile index, so no tile spans
// two rows, and the tile body runs on the row's slices (its pointers moved
// by the row before the call, so the body is the single-row one).  A tile
// whose first lane lies at or past its row's total returns after that one
// read: an empty or short row costs a load a tile.  Writes no improve (the
// reference's batched relax drops it).
template <int MSG, int COMB>
__global__ void __launch_bounds__(THREADS)
wd_relax_lanes_batch_kernel(const int32_t* __restrict__ dist, int32_t n,
                            const int32_t* __restrict__ prefix,
                            const int32_t* __restrict__ excl,
                            const int32_t* __restrict__ start,
                            const int32_t* __restrict__ src_ids, int32_t f,
                            const int32_t* __restrict__ col,
                            const int32_t* __restrict__ wt, int32_t e,
                            int32_t cap_work, int32_t rows,
                            int32_t* __restrict__ target,
                            uint8_t* __restrict__ upd) {
  __shared__ WdSmem sm;
  const int64_t per_row = ((int64_t)cap_work + B1_TILE - 1) / B1_TILE;
  const int64_t tiles = per_row * rows;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t row = t / per_row, tr = t - row * per_row;
    const int64_t so = row * f, no = row * n;
    const int64_t total = __ldg(prefix + so + f - 1);
    if (tr * B1_TILE >= total) continue;     // the same for the whole block
    wd_tile<MSG, COMB, ReadOnly>(tr, dist + no, n, prefix + so, excl + so,
                                 start + so, src_ids + so, f, col, wt, e,
                                 cap_work, total, target + no, upd + no,
                                 nullptr, sm, NoHook());
  }
}

// ---------------------------------------------------------------- B3 ---
__global__ void __launch_bounds__(THREADS)
find_offsets_kernel(const int32_t* __restrict__ prefix, int32_t f,
                    int32_t cap_work, int32_t* __restrict__ out) {
  int64_t k = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (k >= cap_work) return;
  out[k] = upper_bound<ReadOnly>(prefix, f, (int32_t)k);
}

inline unsigned blocks_for(int64_t items) {
  return (unsigned)((items + THREADS - 1) / THREADS);
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
void launch_lanes_t(cudaStream_t st, const int32_t* dist, int32_t n,
                    const int32_t* src, const int32_t* dst, const int32_t* w,
                    const uint8_t* valid, int32_t lanes, int32_t* target,
                    uint8_t* upd, uint8_t* imp) {
  static int per_sm = 0;
  const int64_t tiles = ((int64_t)lanes + B2_TILE - 1) / B2_TILE;
  const unsigned grid = grid_for(
      tiles, wave_blocks(relax_lanes_kernel<MSG, COMB>, &per_sm));
  relax_lanes_kernel<MSG, COMB><<<grid, THREADS, 0, st>>>(
      dist, n, src, dst, w, valid, lanes, target, upd, imp);
}

template <int MSG>
void launch_lanes(int comb, cudaStream_t st, const int32_t* dist, int32_t n,
                  const int32_t* src, const int32_t* dst, const int32_t* w,
                  const uint8_t* valid, int32_t lanes, int32_t* target,
                  uint8_t* upd, uint8_t* imp) {
  if (comb == COMB_MIN)
    launch_lanes_t<MSG, COMB_MIN>(st, dist, n, src, dst, w, valid, lanes,
                                  target, upd, imp);
  else if (comb == COMB_MAX)
    launch_lanes_t<MSG, COMB_MAX>(st, dist, n, src, dst, w, valid, lanes,
                                  target, upd, imp);
  else
    launch_lanes_t<MSG, COMB_ADD>(st, dist, n, src, dst, w, valid, lanes,
                                  target, upd, imp);
}

template <int MSG, int COMB>
void launch_wd_t(cudaStream_t st, const int32_t* dist, int32_t n,
                 const int32_t* prefix, const int32_t* excl,
                 const int32_t* start, const int32_t* src_ids, int32_t f,
                 const int32_t* col, const int32_t* wt, int32_t e,
                 int32_t cap_work, int32_t* target, uint8_t* upd,
                 uint8_t* imp) {
  static int per_sm = 0;
  const int64_t tiles = ((int64_t)cap_work + B1_TILE - 1) / B1_TILE;
  const unsigned grid = grid_for(
      tiles, wave_blocks(wd_relax_lanes_kernel<MSG, COMB>, &per_sm));
  wd_relax_lanes_kernel<MSG, COMB><<<grid, THREADS, 0, st>>>(
      dist, n, prefix, excl, start, src_ids, f, col, wt, e, cap_work, target,
      upd, imp);
}

template <int MSG>
void launch_wd(int comb, cudaStream_t st, const int32_t* dist, int32_t n,
               const int32_t* prefix, const int32_t* excl,
               const int32_t* start, const int32_t* src_ids, int32_t f,
               const int32_t* col, const int32_t* wt, int32_t e,
               int32_t cap_work, int32_t* target, uint8_t* upd, uint8_t* imp) {
  if (comb == COMB_MIN)
    launch_wd_t<MSG, COMB_MIN>(st, dist, n, prefix, excl, start, src_ids, f,
                               col, wt, e, cap_work, target, upd, imp);
  else if (comb == COMB_MAX)
    launch_wd_t<MSG, COMB_MAX>(st, dist, n, prefix, excl, start, src_ids, f,
                               col, wt, e, cap_work, target, upd, imp);
  else
    launch_wd_t<MSG, COMB_ADD>(st, dist, n, prefix, excl, start, src_ids, f,
                               col, wt, e, cap_work, target, upd, imp);
}

template <int MSG, int COMB>
void launch_wd_batch_t(cudaStream_t st, const int32_t* dist, int32_t n,
                       const int32_t* prefix, const int32_t* excl,
                       const int32_t* start, const int32_t* src_ids,
                       int32_t f, const int32_t* col, const int32_t* wt,
                       int32_t e, int32_t cap_work, int32_t rows,
                       int32_t* target, uint8_t* upd) {
  static int per_sm = 0;
  const int64_t tiles =
      ((int64_t)cap_work + B1_TILE - 1) / B1_TILE * rows;
  const unsigned grid = grid_for(
      tiles, wave_blocks(wd_relax_lanes_batch_kernel<MSG, COMB>, &per_sm));
  wd_relax_lanes_batch_kernel<MSG, COMB><<<grid, THREADS, 0, st>>>(
      dist, n, prefix, excl, start, src_ids, f, col, wt, e, cap_work, rows,
      target, upd);
}

template <int MSG>
void launch_wd_batch(int comb, cudaStream_t st, const int32_t* dist,
                     int32_t n, const int32_t* prefix, const int32_t* excl,
                     const int32_t* start, const int32_t* src_ids, int32_t f,
                     const int32_t* col, const int32_t* wt, int32_t e,
                     int32_t cap_work, int32_t rows, int32_t* target,
                     uint8_t* upd) {
  if (comb == COMB_MIN)
    launch_wd_batch_t<MSG, COMB_MIN>(st, dist, n, prefix, excl, start,
                                     src_ids, f, col, wt, e, cap_work, rows,
                                     target, upd);
  else if (comb == COMB_MAX)
    launch_wd_batch_t<MSG, COMB_MAX>(st, dist, n, prefix, excl, start,
                                     src_ids, f, col, wt, e, cap_work, rows,
                                     target, upd);
  else
    launch_wd_batch_t<MSG, COMB_ADD>(st, dist, n, prefix, excl, start,
                                     src_ids, f, col, wt, e, cap_work, rows,
                                     target, upd);
}

}  // namespace

extern "C" {

// B2: lanes >= 1, n >= 1; target [n] (not dist) and upd [n] are folded
// into, not initialised.
int repro_relax_lanes(const int32_t* dist, int32_t n, const int32_t* src,
                      const int32_t* dst, const int32_t* w,
                      const uint8_t* valid, int32_t lanes, int msg, int comb,
                      int32_t* target, uint8_t* upd, uint8_t* imp,
                      void* stream) {
  if (!codes_ok(msg, comb) || lanes < 1 || n < 1 || target == dist)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (msg == MSG_SUM)
    launch_lanes<MSG_SUM>(comb, st, dist, n, src, dst, w, valid, lanes,
                          target, upd, imp);
  else if (msg == MSG_COPY)
    launch_lanes<MSG_COPY>(comb, st, dist, n, src, dst, w, valid, lanes,
                           target, upd, imp);
  else
    launch_lanes<MSG_BOTTLENECK>(comb, st, dist, n, src, dst, w, valid, lanes,
                                 target, upd, imp);
  return (int)cudaGetLastError();
}

// B1: f >= 1, e >= 1, cap_work >= 1; wt == nullptr means weight 1;
// target [n] (not dist) and upd [n] are folded into, not initialised.
int repro_wd_relax_lanes(const int32_t* dist, int32_t n,
                         const int32_t* prefix, const int32_t* excl,
                         const int32_t* start, const int32_t* src_ids,
                         int32_t f, const int32_t* col, const int32_t* wt,
                         int32_t e, int32_t cap_work, int msg, int comb,
                         int32_t* target, uint8_t* upd, uint8_t* imp,
                         void* stream) {
  if (!codes_ok(msg, comb) || f < 1 || e < 1 || n < 1 || cap_work < 1 ||
      target == dist)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (msg == MSG_SUM)
    launch_wd<MSG_SUM>(comb, st, dist, n, prefix, excl, start, src_ids, f,
                       col, wt, e, cap_work, target, upd, imp);
  else if (msg == MSG_COPY)
    launch_wd<MSG_COPY>(comb, st, dist, n, prefix, excl, start, src_ids, f,
                        col, wt, e, cap_work, target, upd, imp);
  else
    launch_wd<MSG_BOTTLENECK>(comb, st, dist, n, prefix, excl, start, src_ids,
                              f, col, wt, e, cap_work, target, upd, imp);
  return (int)cudaGetLastError();
}

// B1 over rows >= 1 rows: dist, target and upd are [rows, n], prefix, excl,
// start and src_ids [rows, f]; f, e, n, cap_work >= 1, as for one row.
int repro_wd_relax_lanes_batch(const int32_t* dist, int32_t n,
                               const int32_t* prefix, const int32_t* excl,
                               const int32_t* start, const int32_t* src_ids,
                               int32_t f, const int32_t* col,
                               const int32_t* wt, int32_t e, int32_t cap_work,
                               int32_t rows, int msg, int comb,
                               int32_t* target, uint8_t* upd, void* stream) {
  if (!codes_ok(msg, comb) || f < 1 || e < 1 || n < 1 || cap_work < 1 ||
      rows < 1 || target == dist)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (msg == MSG_SUM)
    launch_wd_batch<MSG_SUM>(comb, st, dist, n, prefix, excl, start, src_ids,
                             f, col, wt, e, cap_work, rows, target, upd);
  else if (msg == MSG_COPY)
    launch_wd_batch<MSG_COPY>(comb, st, dist, n, prefix, excl, start,
                              src_ids, f, col, wt, e, cap_work, rows, target,
                              upd);
  else
    launch_wd_batch<MSG_BOTTLENECK>(comb, st, dist, n, prefix, excl, start,
                                    src_ids, f, col, wt, e, cap_work, rows,
                                    target, upd);
  return (int)cudaGetLastError();
}

// B3: cap_work >= 1; f == 0 ranks every item to 0.
int repro_find_offsets(const int32_t* prefix, int32_t f, int32_t cap_work,
                       int32_t* out, void* stream) {
  if (cap_work < 1 || f < 0) return (int)cudaErrorInvalidValue;
  find_offsets_kernel<<<blocks_for(cap_work), THREADS, 0,
                        (cudaStream_t)stream>>>(prefix, f, cap_work, out);
  return (int)cudaGetLastError();
}

// The block shape of B2 (which 0) or B1 (which 1), shortest_path's
// instance, for the block-feasibility report: out [6] gets threads a
// block, static shared bytes, registers a thread, local bytes a thread,
// blocks resident per SM and the SMs.
int repro_relax_block_attrs(int which, int* out) {
  if (which < 0 || which > 1) return (int)cudaErrorInvalidValue;
  const void* kernel =
      which == 0 ? (const void*)relax_lanes_kernel<MSG_SUM, COMB_MIN>
                 : (const void*)wd_relax_lanes_kernel<MSG_SUM, COMB_MIN>;
  cudaFuncAttributes a;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = THREADS;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = a.numRegs;
  out[3] = (int)a.localSizeBytes;
  out[4] = per_sm;
  out[5] = sms;
  return 0;
}

const char* repro_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
