// Relax kernels of the PyTorch port, CUDA C++ for sm_90a.
//
// Three kernels with a plain C interface (built with nvcc into a shared
// library and loaded with ctypes by repro_torch/kernels/_build.py):
//
//   B1 repro_wd_relax_lanes  replaces repro/kernels/relax.py wd_relax_lanes
//                            (Pallas body _wd_kernel): the WD merge-path
//                            search fused with the relax.
//   B2 repro_relax_lanes     replaces repro/kernels/relax.py relax_lanes
//                            (Pallas body _lanes_kernel): the relax over
//                            direct-mapped (src, dst, w, valid) lanes.
//   B3 repro_find_offsets    replaces repro/kernels/find_offsets.py
//                            find_offsets: rank(k) = #{i : prefix[i] <= k}.
//
// The Pallas kernels fake every gather and scatter with broadcast compares
// over 128-wide VMEM chunks because the TPU vector unit cannot gather per
// lane.  Hopper gathers natively, so each kernel here is one thread per
// lane: per-lane binary search (B1, B3), per-lane gathers, and an int32
// atomic fold into a separate proposal buffer.
//
// Parity with the reference (bit for bit on int32):
//   * every lane reads dist[src] and dist[dst] from the unmodified input;
//     improving candidates go to `prop`, which the wrapper fills with the
//     monoid identity, and the wrapper folds `prop` into dist afterwards
//     (apply_proposal).  No lane of a launch sees another lane's write.
//   * int32 atomicMin/atomicMax do not depend on order, and atomicAdd wraps
//     like the reference's int32 add, so any atomic order gives the same
//     bits.  The `sum` message v + w wraps through unsigned arithmetic
//     (signed overflow is undefined in C++).
//   * updated[dst] = 1 wherever a lane improves dst: a benign race, every
//     writer stores the same byte.
//
// What bounds them on the H100: memory.  Per lane, B1 reads its slot
// entries (prefix search, exclusive, start, src_ids: 4-byte each), the
// edge's col and wt, and two dist values, and writes improve, a proposal
// atomic and an updated byte -- on the order of 36 bytes against a handful
// of integer operations, plus a log2(F) binary search over the prefix,
// whose upper levels every lane shares in L2.  B2 moves ~21 bytes per lane
// (src, dst, w, valid, two dist reads, the fold), B3 4 bytes per item plus
// the search.  The design's answer is to move each byte once: the rank,
// the gathered slot entry and the message stay in registers (the Pallas
// version likewise never materialises the rank array), invalid lanes skip
// every gather after the mask, and the fold is one atomic on the
// destination.  No shared memory is used: at one int32 per lane there is
// nothing to reuse within a block.  Coalescing is what the graph allows:
// lane k reads lane-contiguous src/dst/w/valid (B2) and consecutive edges
// of one node (B1), while dist[src], dist[dst] and prop[dst] are scattered
// by nature.  Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a
// 700 W power limit, at rmat20's shapes: B1 0.223 ms against a 0.030 ms
// byte bound (2^23 lanes), B2 0.177 ms against 0.038 ms (2^23 lanes), B3
// 0.135 ms against 0.011 ms; PERF.md has the table.
//
// Each entry point launches on the given stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// message codes (repro_torch.core.operators.KERNEL_MESSAGES)
constexpr int MSG_SUM = 0;         // v + w (wrapping)
constexpr int MSG_COPY = 1;        // v
constexpr int MSG_BOTTLENECK = 2;  // min(v, w)
// combine codes (repro_torch.core.operators.KERNEL_COMBINES)
constexpr int COMB_MIN = 0;
constexpr int COMB_MAX = 1;
constexpr int COMB_ADD = 2;

constexpr int THREADS = 256;

template <int MSG>
__device__ __forceinline__ int32_t message(int32_t v, int32_t w) {
  if (MSG == MSG_SUM) return (int32_t)((uint32_t)v + (uint32_t)w);
  if (MSG == MSG_COPY) return v;
  return v < w ? v : w;
}

// the activation test of the built-in operators; for add the identity is
// 0, so "a real contribution" is cand != 0
template <int COMB>
__device__ __forceinline__ bool improves(int32_t cand, int32_t cur) {
  if (COMB == COMB_MIN) return cand < cur;
  if (COMB == COMB_MAX) return cand > cur;
  return cand != 0;
}

template <int COMB>
__device__ __forceinline__ void fold(int32_t* p, int32_t cand) {
  if (COMB == COMB_MIN) atomicMin(p, cand);
  else if (COMB == COMB_MAX) atomicMax(p, cand);
  else atomicAdd(p, cand);
}

__device__ __forceinline__ int32_t clamp_index(int64_t i, int32_t n) {
  return (int32_t)(i < 0 ? 0 : (i >= n ? n - 1 : i));
}

// #{i < f : prefix[i] <= k} for a non-decreasing prefix — searchsorted
// side="right".  Shared by B1 and B3.
__device__ __forceinline__ int32_t upper_bound(const int32_t* __restrict__ prefix,
                                               int32_t f, int32_t k) {
  int32_t lo = 0, hi = f;
  while (lo < hi) {
    int32_t mid = (int32_t)(((uint32_t)lo + (uint32_t)hi) >> 1);
    if (__ldg(prefix + mid) <= k) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// the relax of one lane against the dist snapshot; returns "improves"
template <int MSG, int COMB>
__device__ __forceinline__ bool relax_one(const int32_t* __restrict__ dist,
                                          int32_t s, int32_t d, int32_t w,
                                          int32_t* __restrict__ prop,
                                          uint8_t* __restrict__ upd) {
  int32_t cand = message<MSG>(__ldg(dist + s), w);
  if (!improves<COMB>(cand, __ldg(dist + d))) return false;
  fold<COMB>(prop + d, cand);
  upd[d] = 1;
  return true;
}

// ---------------------------------------------------------------- B2 ---
template <int MSG, int COMB>
__global__ void __launch_bounds__(THREADS)
relax_lanes_kernel(const int32_t* __restrict__ dist, int32_t n,
                   const int32_t* __restrict__ src,
                   const int32_t* __restrict__ dst,
                   const int32_t* __restrict__ w,
                   const uint8_t* __restrict__ valid, int32_t lanes,
                   int32_t* __restrict__ prop, uint8_t* __restrict__ upd,
                   uint8_t* __restrict__ imp) {
  int64_t k = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (k >= lanes) return;
  bool ok = false;
  if (valid[k]) {
    ok = relax_one<MSG, COMB>(dist, clamp_index(src[k], n),
                              clamp_index(dst[k], n), w[k], prop, upd);
  }
  imp[k] = ok;
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
                      int32_t cap_work, int32_t* __restrict__ prop,
                      uint8_t* __restrict__ upd, uint8_t* __restrict__ imp) {
  int64_t k64 = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (k64 >= cap_work) return;
  int32_t k = (int32_t)k64;
  bool ok = false;
  if (k < __ldg(prefix + f - 1)) {          // valid = k < total work
    int32_t rank = upper_bound(prefix, f, k);
    int32_t i = rank < f - 1 ? rank : f - 1;
    int64_t eidx = (int64_t)__ldg(start + i) + (k - __ldg(excl + i));
    int32_t ec = clamp_index(eidx, e);
    int32_t wv = wt ? __ldg(wt + ec) : 1;
    ok = relax_one<MSG, COMB>(dist, clamp_index(__ldg(src_ids + i), n),
                              clamp_index(__ldg(col + ec), n), wv, prop, upd);
  }
  imp[k] = ok;
}

// ---------------------------------------------------------------- B3 ---
__global__ void __launch_bounds__(THREADS)
find_offsets_kernel(const int32_t* __restrict__ prefix, int32_t f,
                    int32_t cap_work, int32_t* __restrict__ out) {
  int64_t k = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (k >= cap_work) return;
  out[k] = upper_bound(prefix, f, (int32_t)k);
}

inline unsigned blocks_for(int32_t items) {
  return (unsigned)(((int64_t)items + THREADS - 1) / THREADS);
}

template <int MSG>
void launch_lanes(int comb, cudaStream_t st, unsigned grid,
                  const int32_t* dist, int32_t n, const int32_t* src,
                  const int32_t* dst, const int32_t* w, const uint8_t* valid,
                  int32_t lanes, int32_t* prop, uint8_t* upd, uint8_t* imp) {
  if (comb == COMB_MIN)
    relax_lanes_kernel<MSG, COMB_MIN><<<grid, THREADS, 0, st>>>(
        dist, n, src, dst, w, valid, lanes, prop, upd, imp);
  else if (comb == COMB_MAX)
    relax_lanes_kernel<MSG, COMB_MAX><<<grid, THREADS, 0, st>>>(
        dist, n, src, dst, w, valid, lanes, prop, upd, imp);
  else
    relax_lanes_kernel<MSG, COMB_ADD><<<grid, THREADS, 0, st>>>(
        dist, n, src, dst, w, valid, lanes, prop, upd, imp);
}

template <int MSG>
void launch_wd(int comb, cudaStream_t st, unsigned grid, const int32_t* dist,
               int32_t n, const int32_t* prefix, const int32_t* excl,
               const int32_t* start, const int32_t* src_ids, int32_t f,
               const int32_t* col, const int32_t* wt, int32_t e,
               int32_t cap_work, int32_t* prop, uint8_t* upd, uint8_t* imp) {
  if (comb == COMB_MIN)
    wd_relax_lanes_kernel<MSG, COMB_MIN><<<grid, THREADS, 0, st>>>(
        dist, n, prefix, excl, start, src_ids, f, col, wt, e, cap_work, prop,
        upd, imp);
  else if (comb == COMB_MAX)
    wd_relax_lanes_kernel<MSG, COMB_MAX><<<grid, THREADS, 0, st>>>(
        dist, n, prefix, excl, start, src_ids, f, col, wt, e, cap_work, prop,
        upd, imp);
  else
    wd_relax_lanes_kernel<MSG, COMB_ADD><<<grid, THREADS, 0, st>>>(
        dist, n, prefix, excl, start, src_ids, f, col, wt, e, cap_work, prop,
        upd, imp);
}

bool codes_ok(int msg, int comb) {
  return msg >= MSG_SUM && msg <= MSG_BOTTLENECK && comb >= COMB_MIN &&
         comb <= COMB_ADD;
}

}  // namespace

extern "C" {

// B2: lanes >= 1, n >= 1; prop pre-filled with the identity, upd zeroed.
int repro_relax_lanes(const int32_t* dist, int32_t n, const int32_t* src,
                      const int32_t* dst, const int32_t* w,
                      const uint8_t* valid, int32_t lanes, int msg, int comb,
                      int32_t* prop, uint8_t* upd, uint8_t* imp,
                      void* stream) {
  if (!codes_ok(msg, comb) || lanes < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned grid = blocks_for(lanes);
  if (msg == MSG_SUM)
    launch_lanes<MSG_SUM>(comb, st, grid, dist, n, src, dst, w, valid, lanes,
                          prop, upd, imp);
  else if (msg == MSG_COPY)
    launch_lanes<MSG_COPY>(comb, st, grid, dist, n, src, dst, w, valid, lanes,
                           prop, upd, imp);
  else
    launch_lanes<MSG_BOTTLENECK>(comb, st, grid, dist, n, src, dst, w, valid,
                                 lanes, prop, upd, imp);
  return (int)cudaGetLastError();
}

// B1: f >= 1, e >= 1, cap_work >= 1; wt == nullptr means weight 1.
int repro_wd_relax_lanes(const int32_t* dist, int32_t n,
                         const int32_t* prefix, const int32_t* excl,
                         const int32_t* start, const int32_t* src_ids,
                         int32_t f, const int32_t* col, const int32_t* wt,
                         int32_t e, int32_t cap_work, int msg, int comb,
                         int32_t* prop, uint8_t* upd, uint8_t* imp,
                         void* stream) {
  if (!codes_ok(msg, comb) || f < 1 || e < 1 || n < 1 || cap_work < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned grid = blocks_for(cap_work);
  if (msg == MSG_SUM)
    launch_wd<MSG_SUM>(comb, st, grid, dist, n, prefix, excl, start, src_ids,
                       f, col, wt, e, cap_work, prop, upd, imp);
  else if (msg == MSG_COPY)
    launch_wd<MSG_COPY>(comb, st, grid, dist, n, prefix, excl, start, src_ids,
                        f, col, wt, e, cap_work, prop, upd, imp);
  else
    launch_wd<MSG_BOTTLENECK>(comb, st, grid, dist, n, prefix, excl, start,
                              src_ids, f, col, wt, e, cap_work, prop, upd,
                              imp);
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

const char* repro_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
