// The fused fixed point of the PyTorch port: a whole traversal of one
// strategy as ONE persistent cooperative launch, CUDA C++ for sm_90a.
//
//   repro_fused_fixed_point  the port's form of the reference's
//                            repro/core/fused.py _fixed_point (a
//                            lax.while_loop over the dense step bodies
//                            _bs_step, _wd_step, _hp_step, _ep_step,
//                            _ns_step and _ad_step, whose relaxes go
//                            through the Pallas kernels B1/B2 under
//                            backend="pallas").  It is not itself a TPU
//                            kernel: it carries the lane bodies of B1 and
//                            B2 (relax_lanes.cuh) inside one launch.
//
// The loop.  Every block of a grid sized to be resident all at once
// (occupancy x SMs) runs the reference's `while frontier_live and it <
// max_iterations` loop, and the blocks meet at a grid barrier (a
// generation counter, below) wherever one needs another's writes.  Every
// branch and trip count the blocks must agree on (the frontier's count,
// degree sum and max degree, HP's live count, a tail's total, AD's
// choice) is computed from global cells read after a barrier, so every
// block takes the same path; a disagreement would deadlock the launch.
//
// The chunks are the reference's, so (dist, iterations, edges_relaxed)
// and AD's choices equal it bit for bit: one chunk per BS or NS column,
// per HP tile and for HP's cursor-aware WD tail, one per WD or EP
// iteration; AD takes BS, WD or HP.  A chunk's lanes read the snapshot A
// and fold improving candidates with int32 atomics into B, which equals A
// at every chunk boundary; an improving lane notes its destination once
// (a per-node stamp of the chunk number), and after a barrier the noted
// entries are copied from B into A, then another barrier.  Two barriers a
// chunk and no full-array copy.  The running `updated` mask is the next
// iteration's frontier: the two masks alternate between iterations.
//
// The lanes are formed inside the kernel from compact tables: each
// iteration compacts the frontier into ascending node ids with their
// degree, first edge and the inclusive/exclusive prefix of their degrees
// (block scans, a barrier, then each block sums the block totals before
// its own).  BS/NS column d: a thread a slot, valid where d < degree.  HP
// tile at cursor c: a warp per slot with edges past c (found by ballot),
// its lanes over [c, min(c + MDT, degree)).  WD and HP's tail: B1's
// merge-path tile (relax_lanes.cuh) over the prefix of the (remaining)
// degrees.  EP: every edge a lane, valid where its source is in the
// frontier.  NS: the child <- parent gather at the start of an iteration.
//
// Reads.  A, the masks and the tables are written by this launch, so they
// are read from L2 (ld.global.cg), never through the read-only path (no
// __ldg, no const __restrict__ on them): that path is not kept coherent
// with the launch's own writes.  row_ptr, col, wt and aux are never
// written and take __ldg.
//
// What bounds it on the H100: on the paper's rmat20 the traversal moves a
// few hundred MB (each relaxed edge's col, wt and two dist gathers, the
// frontier's row_ptr and masks), a fraction of a millisecond at 3.35
// TB/s; what it pays instead is the barriers (two a chunk: BS runs one
// chunk per column, thousands a traversal) and the dependent gathers of
// each lane.  The design keeps the host out of the loop entirely; its
// times beside its bound are in PERF.md.
//
// A batch of K queries (WD only, the reference's _batch_fixed_point: the
// dense WD step vmapped over the sources).  The K rows of n values are one
// flat array of K * n, and so are the masks: the frontier of an iteration
// is compacted over all K * n entries, a slot's degree comes from row_ptr
// at its node (flat id mod n), and a merge-path lane's destination is its
// source's row plus col[e] (FlatRows).  One chunk covers every row's edges
// in an iteration; the rows never interact and the int32 atomics do not
// depend on order, so this gives the bits of one synchronous merge path per
// row per iteration.  The loop runs while any row is live, and the edge
// total sums the rows.  The caller keeps K * n and K * e below 2^31.
//
// AD's selector computes mean = f32(degree_sum) / f32(max(count, 1)) and
// imbalance = f32(max_degree) / mean with IEEE division (__fdiv_rn; the
// library is never built with fast math), the float32 order of the
// reference, so both selectors agree at every threshold.  With a measured
// cost model (costmodel.py, the reference's _ad_step with coeffs) it takes
// the first argmin of a + b*es + c*cn per kernel, each product and sum
// rounded on its own (__fmul_rn, __fadd_rn: nvcc would otherwise contract
// them into an FMA, which rounds once and can flip a near tie).
//
// Delta-stepping (repro/core/priority.py _delta_fixed_point: the same
// dense steps inside bucket epochs).  fused_delta_kernel takes two Params:
// p over the light graph (w <= delta) and ph, equal but for the heavy
// graph's row_ptr, col, wt and e (e = 0: no heavy graph).  Each epoch
// finds the minimum live bucket with one grid-wide pass (the frontier M
// merged with the last phase's improvements U), then closes it over the
// light graph: a pass takes C = M & bucket(A) == b out of M into the
// settled set S (each node's bucket recomputed from the current values,
// b fixed for the epoch), and the strategy's step relaxes C into U, until
// no node of M lies in b.  Then the settled nodes relax their heavy edges
// once.  Rounds count the light passes and a heavy pass with edges; the
// loop caps epochs at max_iterations.  A pass's block totals alternate
// between two halves of btot, so consecutive passes need no extra barrier.
// One launch capped at one epoch is the stepped driver's epoch; it returns
// M, the bucket settled and the frontier's count beside the values.

#include <cuda_runtime.h>
#include <stdint.h>

#include "relax_lanes.cuh"

namespace {

using namespace relax_lanes;

// kernel codes (repro_torch.kernels.fused.KERNEL_CODES)
constexpr int K_BS = 0;
constexpr int K_WD = 1;
constexpr int K_HP = 2;
constexpr int K_EP = 3;
constexpr int K_NS = 4;
constexpr int K_AD = 5;

constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// control words, zeroed before the launch: the barrier, then three chunk
// slots of (noted destinations, HP's live slots)
constexpr int CTRL_BAR = 0;
constexpr int CTRL_SLOTS = 4;
constexpr int CTRL_WORDS = 16;

struct Params {
  const int32_t* row_ptr;
  const int32_t* col;
  const int32_t* wt;         // null: weight 1
  const int32_t* aux;        // EP: edge sources [e]; NS: child -> parent [n]
  const int32_t* dist0;
  const uint8_t* mask0;
  int32_t n, e;
  int32_t rows;              // queries in the batch (1: one traversal)
  int32_t nk;                // values: rows * n
  int kernel, max_iterations, mdt, switch_threshold, small_frontier,
      hp_edges_threshold;
  float imbalance_threshold;
  int measured;              // AD: 1 takes the cost model's argmin
  float coeffs[9];           // AD's [3, 3] cost model: (a, b, c) per kernel
  int32_t delta;             // delta mode: the bucket width
  int32_t* A;                // the snapshot; the final dist
  int32_t* B;                // fold target, equal to A between chunks
  int32_t* stamp;            // [n] the chunk that last noted a destination
  int32_t* dirty;            // [n] destinations noted in this chunk
  int32_t* list;             // [n] the frontier's nodes, ascending
  int32_t* deg;              // [n] their degrees
  int32_t* pfx;              // [n] inclusive prefix of the merge-path work
  int32_t* exc;              // [n] exclusive prefix
  int32_t* start;            // [n] first edge of a slot's (remaining) run
  uint8_t* mask[2];          // frontier masks of alternate iterations
                             // (delta mode: C and U)
  uint8_t* live;             // delta mode: the frontier M, the output mask
  uint8_t* settled;          // delta mode: S, the nodes settled this epoch
  int32_t* btot;             // [2][grid * 4] block totals of the last scan
  unsigned* ctrl;            // CTRL_WORDS
  long long* result;         // iterations, edges, AD's BS/WD/HP counts
};

// The frontier of one iteration: grid totals, and the counts of the
// blocks before this one (where its slots start in the tables).
struct Frontier {
  int32_t count, degsum, maxdeg, before_count, before_deg;
};

__device__ __forceinline__ int64_t gtid() {
  return (int64_t)blockIdx.x * THREADS + threadIdx.x;
}

__device__ __forceinline__ int64_t gthreads() {
  return (int64_t)gridDim.x * THREADS;
}

// Grid barrier: every block adds to one word, block 0 so much more that
// the last arrival flips its top bit (cooperative groups' scheme).  The
// fences order each block's writes before its arrival and its reads after
// the flip; the cooperative launch makes every block resident.  A block
// that waits longer than BARRIER_TIMEOUT cycles (blocks that disagree on
// a branch never arrive) traps, so a fault ends the launch with an error
// instead of hanging the card.
constexpr long long BARRIER_TIMEOUT = 20000000000LL;   // ~10 s at 2 GHz

__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned nb =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned old = atomicAdd(bar, nb);
    const long long t0 = clock64();
    while (((old ^ *(volatile unsigned*)bar) & 0x80000000u) == 0) {
      __nanosleep(32);
      if (clock64() - t0 > BARRIER_TIMEOUT) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// a, b summed and c maximised over the block; every thread gets them
__device__ __forceinline__ void block_reduce3(int32_t& a, int32_t& b,
                                              int32_t& c) {
  __shared__ int32_t r[3][WARPS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    a += __shfl_xor_sync(FULL, a, o);
    b += __shfl_xor_sync(FULL, b, o);
    c = max(c, __shfl_xor_sync(FULL, c, o));
  }
  if (lane == 0) {
    r[0][w] = a;
    r[1][w] = b;
    r[2][w] = c;
  }
  __syncthreads();
  a = b = c = 0;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) {
    a += r[0][i];
    b += r[1][i];
    c = max(c, r[2][i]);
  }
  __syncthreads();
}

// inclusive scans of a and b over the block, in thread order; ta, tb get
// the block's totals
__device__ __forceinline__ void block_scan2(int32_t& a, int32_t& b,
                                            int32_t& ta, int32_t& tb) {
  __shared__ int32_t wa[WARPS], wb[WARPS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t x = __shfl_up_sync(FULL, a, o);
    const int32_t y = __shfl_up_sync(FULL, b, o);
    if (lane >= o) {
      a += x;
      b += y;
    }
  }
  if (lane == 31) {
    wa[w] = a;
    wb[w] = b;
  }
  __syncthreads();
  int32_t pa = 0, pb = 0;
  ta = tb = 0;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) {
    if (i < w) {
      pa += wa[i];
      pb += wb[i];
    }
    ta += wa[i];
    tb += wb[i];
  }
  a += pa;
  b += pb;
  __syncthreads();
}

// block b's contiguous segment [lo, hi) of m items
__device__ __forceinline__ void segment(int32_t m, int32_t& lo, int32_t& hi) {
  const int64_t per = ((int64_t)m + gridDim.x - 1) / gridDim.x;
  const int64_t l = per * blockIdx.x;
  lo = (int32_t)(l < m ? l : m);
  hi = (int32_t)(l + per < m ? l + per : m);
}

// After the barrier that follows the blocks' writes of btot: the grid
// totals of its three columns (sum, sum, max) and the sums of the first
// two over the blocks before this one.
__device__ __forceinline__ void scan_totals(const int32_t* btot, int32_t& t0,
                                            int32_t& t1, int32_t& t2,
                                            int32_t& p0, int32_t& p1) {
  t0 = t1 = t2 = p0 = p1 = 0;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += THREADS) {
    const int32_t x = __ldcg(btot + 4 * i), y = __ldcg(btot + 4 * i + 1);
    t0 += x;
    t1 += y;
    t2 = max(t2, __ldcg(btot + 4 * i + 2));
    if (i < (int)blockIdx.x) {
      p0 += x;
      p1 += y;
    }
  }
  block_reduce3(t0, t1, t2);
  int32_t unused = 0;
  block_reduce3(p0, p1, unused);
}

__device__ __forceinline__ int32_t degree(const Params& p, int32_t i) {
  return __ldg(p.row_ptr + i + 1) - __ldg(p.row_ptr + i);
}

// the graph node of flat value i ([rows, n], row-major)
__device__ __forceinline__ int32_t node_of(const Params& p, int32_t i) {
  return p.rows == 1 ? i : i % p.n;
}

// The frontier's count, degree sum and max degree (ends in a barrier);
// zeroes the next iteration's mask on the way.
__device__ Frontier frontier_count(const Params& p, const uint8_t* M,
                                   uint8_t* next) {
  int32_t lo, hi;
  segment(p.nk, lo, hi);
  int32_t cnt = 0, sum = 0, mx = 0;
  for (int32_t i = lo + threadIdx.x; i < hi; i += THREADS) {
    next[i] = 0;
    if (__ldcg(M + i)) {
      const int32_t d = degree(p, node_of(p, i));
      ++cnt;
      sum += d;
      mx = max(mx, d);
    }
  }
  block_reduce3(cnt, sum, mx);
  if (threadIdx.x == 0) {
    p.btot[4 * blockIdx.x] = cnt;
    p.btot[4 * blockIdx.x + 1] = sum;
    p.btot[4 * blockIdx.x + 2] = mx;
  }
  grid_sync(p.ctrl + CTRL_BAR);
  Frontier f;
  scan_totals(p.btot, f.count, f.degsum, f.maxdeg, f.before_count,
              f.before_deg);
  return f;
}

// Write the frontier's slot tables in ascending node order; the caller
// waits at a barrier before any block reads them.
__device__ void frontier_compact(const Params& p, const uint8_t* M,
                                 const Frontier& f) {
  int32_t lo, hi;
  segment(p.nk, lo, hi);
  int32_t pc = f.before_count, pd = f.before_deg;
  for (int32_t base = lo; base < hi; base += THREADS) {
    const int32_t i = base + threadIdx.x;
    int32_t on = 0, d = 0;
    if (i < hi && __ldcg(M + i)) {
      on = 1;
      d = degree(p, node_of(p, i));
    }
    int32_t a = on, b = d, ta, tb;
    block_scan2(a, b, ta, tb);
    if (on) {
      const int32_t pos = pc + a - 1;
      p.list[pos] = i;
      p.deg[pos] = d;
      p.start[pos] = __ldg(p.row_ptr + node_of(p, i));
      p.pfx[pos] = pd + b;
      p.exc[pos] = pd + b - d;
    }
    pc += ta;
    pd += tb;
  }
}

// HP's tail at cursor c: remaining work max(deg - c, 0) of every slot,
// its prefix into pfx/exc and start moved past the cursor; returns the
// total (ends in a barrier).
__device__ int64_t tail_tables(const Params& p, int32_t count, int32_t c) {
  int32_t lo, hi;
  segment(count, lo, hi);
  int32_t sum = 0, unused0 = 0, unused1 = 0;
  for (int32_t i = lo + threadIdx.x; i < hi; i += THREADS)
    sum += max(__ldcg(p.deg + i) - c, 0);
  block_reduce3(sum, unused0, unused1);
  if (threadIdx.x == 0) {
    p.btot[4 * blockIdx.x] = sum;
    p.btot[4 * blockIdx.x + 1] = 0;
    p.btot[4 * blockIdx.x + 2] = 0;
  }
  grid_sync(p.ctrl + CTRL_BAR);
  int32_t total, t1, t2, off, p1;
  scan_totals(p.btot, total, t1, t2, off, p1);
  for (int32_t base = lo; base < hi; base += THREADS) {
    const int32_t i = base + threadIdx.x;
    const int32_t r = i < hi ? max(__ldcg(p.deg + i) - c, 0) : 0;
    int32_t a = r, b = 0, ta, tb;
    block_scan2(a, b, ta, tb);
    if (i < hi) {
      p.pfx[i] = off + a;
      p.exc[i] = off + a - r;
      p.start[i] = __ldcg(p.start + i) + c;
    }
    off += ta;
  }
  grid_sync(p.ctrl + CTRL_BAR);
  return total;
}

// An improving lane notes its destination once a chunk.  The lanes of a
// warp that note together take their slots with one atomic (opportunistic
// warp aggregation): one counter for the whole grid would otherwise take
// an atomic from every improving lane.
struct NoteHook {
  int32_t* stamp;
  int32_t* dirty;
  unsigned* noted;
  int32_t chunk;
  __device__ __forceinline__ void operator()(int32_t d) const {
    if (atomicExch(stamp + d, chunk) == chunk) return;
    const unsigned active = __activemask();
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(active) - 1;
    unsigned base = 0;
    if (lane == leader) base = atomicAdd(noted, (unsigned)__popc(active));
    base = __shfl_sync(active, base, leader);
    dirty[base + __popc(active & ((1u << lane) - 1u))] = d;
  }
};

__device__ __forceinline__ unsigned* chunk_slot(const Params& p, int seq) {
  return p.ctrl + CTRL_SLOTS + 2 * (seq % 3);
}

// Chunk seq notes into slot seq % 3 and clears the slot of chunk seq + 1:
// that slot was last read by chunk seq - 2, two barriers ago.
__device__ __forceinline__ NoteHook begin_chunk(const Params& p, int seq) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned* next = chunk_slot(p, seq + 1);
    next[0] = 0;
    next[1] = 0;
  }
  return NoteHook{p.stamp, p.dirty, chunk_slot(p, seq), seq};
}

// Wait for every fold of the chunk, copy the noted entries of B into A,
// wait again.  Returns the chunk's HP live count.
__device__ unsigned end_chunk(const Params& p, int& seq) {
  const unsigned* slot = chunk_slot(p, seq);
  grid_sync(p.ctrl + CTRL_BAR);
  const unsigned noted = __ldcg(slot), live = __ldcg(slot + 1);
  for (int64_t k = gtid(); k < noted; k += gthreads()) {
    const int32_t d = __ldcg(p.dirty + k);
    p.A[d] = __ldcg(p.B + d);
  }
  grid_sync(p.ctrl + CTRL_BAR);
  ++seq;
  return live;
}

template <int MSG, int COMB>
__device__ __forceinline__ void relax_one(const Params& p, bool valid,
                                          int32_t src, int32_t eidx,
                                          uint8_t* upd, const NoteHook& h) {
  bool v[1] = {valid};
  int32_t s[1] = {src}, d[1] = {0}, w[1] = {1};
  if (valid) {
    const int32_t ec = clamp_index(eidx, p.e);
    d[0] = __ldg(p.col + ec);
    if (p.wt) w[0] = __ldg(p.wt + ec);
  }
  bool imp[1];
  relax_group<1, MSG, COMB, Coherent>(p.A, p.n, v, s, d, w, p.B, upd, imp,
                                      h);
}

// BS/NS column d: the d-th edge of every frontier slot
template <int MSG, int COMB>
__device__ void bs_column(const Params& p, int32_t count, int32_t d,
                          uint8_t* upd, const NoteHook& h) {
  for (int64_t i = gtid(); i < count; i += gthreads()) {
    const bool valid = d < __ldcg(p.deg + i);
    int32_t src = 0, eidx = 0;
    if (valid) {
      src = __ldcg(p.list + i);
      eidx = __ldcg(p.start + i) + d;
    }
    relax_one<MSG, COMB>(p, valid, src, eidx, upd, h);
  }
}

// HP tile at cursor c: every slot's edges [c, min(c + mdt, deg)), a warp
// a slot that has any (found 32 slots at a time by ballot); counts the
// slots with edges left past c + mdt into the chunk's live count.
template <int MSG, int COMB>
__device__ void hp_tile(const Params& p, int32_t count, int32_t c,
                        uint8_t* upd, const NoteHook& h) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = gtid() >> 5, nwarps = gthreads() >> 5;
  const int64_t cend = (int64_t)c + p.mdt;
  int32_t live = 0;
  for (int64_t base = warp * 32; base < count; base += nwarps * 32) {
    const int64_t i = base + lane;
    const int32_t di = i < count ? __ldcg(p.deg + i) : 0;
    live += di > cend;
    unsigned work = __ballot_sync(FULL, di > c);
    while (work) {
      const int l = __ffs(work) - 1;
      work &= work - 1;
      const int32_t dl = __shfl_sync(FULL, di, l);
      const int32_t hi = (int32_t)(dl < cend ? dl : cend);
      const int32_t src = __ldcg(p.list + base + l);
      const int32_t st = __ldcg(p.start + base + l);
      for (int32_t j0 = c; j0 < hi; j0 += 32) {
        const int32_t j = j0 + lane;
        relax_one<MSG, COMB>(p, j < hi, src, st + j, upd, h);
      }
    }
  }
  int32_t unused0 = 0, unused1 = 0;
  block_reduce3(live, unused0, unused1);
  if (threadIdx.x == 0 && live) atomicAdd(h.noted + 1, (unsigned)live);
}

// EP: every edge a lane, valid where its source is in the frontier
template <int MSG, int COMB>
__device__ void ep_edges(const Params& p, const uint8_t* M, uint8_t* upd,
                         const NoteHook& h) {
  for (int64_t k = gtid(); k < p.e; k += gthreads()) {
    const int32_t src = clamp_index(__ldg(p.aux + k), p.n);
    relax_one<MSG, COMB>(p, __ldcg(M + src) != 0, src, (int32_t)k, upd, h);
  }
}

// WD, and HP's tail: B1's merge-path tiles over `total` lanes (over every
// row's frontier at once in a batch)
template <int MSG, int COMB>
__device__ void merge_path(const Params& p, int32_t count, int64_t total,
                           uint8_t* upd, const NoteHook& h, WdSmem& sm) {
  const int64_t tiles = (total + B1_TILE - 1) / B1_TILE;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    if (p.rows == 1)
      wd_tile<MSG, COMB, Coherent>(t, p.A, p.n, p.pfx, p.exc, p.start,
                                   p.list, count, p.col, p.wt, p.e,
                                   (int32_t)total, total, p.B, upd, nullptr,
                                   sm, h);
    else
      wd_tile<MSG, COMB, Coherent>(t, p.A, p.nk, p.pfx, p.exc, p.start,
                                   p.list, count, p.col, p.wt, p.e,
                                   (int32_t)total, total, p.B, upd, nullptr,
                                   sm, h, FlatRows{p.n});
  }
}

template <int MSG, int COMB>
__device__ void wd_step(const Params& p, const Frontier& f, uint8_t* upd,
                        int& seq, WdSmem& sm) {
  const NoteHook h = begin_chunk(p, seq);
  merge_path<MSG, COMB>(p, f.count, f.degsum, upd, h, sm);
  end_chunk(p, seq);
}

// HP: WD for a small frontier; else MDT-wide tiles while more than
// switch_threshold slots have edges left (at least one tile), then the
// cursor-aware WD tail
template <int MSG, int COMB>
__device__ void hp_step(const Params& p, const Frontier& f, uint8_t* upd,
                        int& seq, WdSmem& sm) {
  if (f.count <= p.switch_threshold) {
    wd_step<MSG, COMB>(p, f, upd, seq, sm);
    return;
  }
  int32_t c = 0;
  unsigned live;
  do {
    const NoteHook h = begin_chunk(p, seq);
    hp_tile<MSG, COMB>(p, f.count, c, upd, h);
    live = end_chunk(p, seq);
    c += p.mdt;
  } while ((int64_t)live > p.switch_threshold);
  const int64_t total = tail_tables(p, f.count, c);
  if (total > 0) {                      // an empty tail relaxes nothing
    const NoteHook h = begin_chunk(p, seq);
    merge_path<MSG, COMB>(p, f.count, total, upd, h, sm);
    end_chunk(p, seq);
  }
}

// NS's ns_activate: children take their parent's value and activity
// (parents map to themselves and are not written)
__device__ __forceinline__ void ns_gather(const Params& p, uint8_t* M) {
  for (int64_t i = gtid(); i < p.n; i += gthreads()) {
    const int32_t par = __ldg(p.aux + i);
    if (par != i) {
      const int32_t v = __ldcg(p.A + par);
      p.A[i] = v;
      p.B[i] = v;
      if (__ldcg(M + par)) M[i] = 1;
    }
  }
}

// AD's choice: 0 BS, 1 WD, 2 HP.  Measured: the first argmin of the cost
// model's float32 predictions, each operation rounded (a NaN counts as the
// minimum, as numpy's argmin has it).  Else the fixed decision tree
// (strategies.choose_kernel) in the reference's float32 order.
__device__ __forceinline__ int ad_choice(const Params& p, const Frontier& f) {
  const bool degenerate = f.degsum == 0 || f.count == 0;
  if (p.measured) {
    if (degenerate) return 0;
    const float es = __int2float_rn(f.degsum), cn = __int2float_rn(f.count);
    int best = 0;
    float lo = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float cost =
          __fadd_rn(__fadd_rn(p.coeffs[3 * k], __fmul_rn(p.coeffs[3 * k + 1],
                                                          es)),
                    __fmul_rn(p.coeffs[3 * k + 2], cn));
      if (k == 0 || (!isnan(lo) && (isnan(cost) || cost < lo))) {
        best = k;
        lo = cost;
      }
    }
    return best;
  }
  const float mean = __fdiv_rn(__int2float_rn(f.degsum),
                               __int2float_rn(max(f.count, 1)));
  const float imbalance =
      mean > 0.0f ? __fdiv_rn(__int2float_rn(f.maxdeg), mean) : 1.0f;
  const bool take_bs =
      degenerate || (f.count <= p.small_frontier &&
                     imbalance <= p.imbalance_threshold);
  const bool take_hp =
      f.maxdeg > p.mdt && f.degsum >= p.hp_edges_threshold;
  return take_bs ? 0 : (take_hp ? 2 : 1);
}

template <int MSG, int COMB>
__global__ void __launch_bounds__(THREADS)
fused_fixed_point_kernel(Params p) {
  __shared__ WdSmem sm;
  for (int64_t i = gtid(); i < p.nk; i += gthreads()) {
    const int32_t v = __ldg(p.dist0 + i);
    p.A[i] = v;
    p.B[i] = v;
    p.stamp[i] = -1;
    p.mask[0][i] = __ldg(p.mask0 + i) != 0;
  }
  grid_sync(p.ctrl + CTRL_BAR);

  int cur = 0, it = 0, seq = 0;
  unsigned long long edges = 0;
  long long chosen[3] = {0, 0, 0};
  for (;;) {
    uint8_t* M = p.mask[cur];
    uint8_t* next = p.mask[cur ^ 1];
    Frontier f = frontier_count(p, M, next);
    // EP stops when the frontier has no outgoing edges
    const bool live = p.kernel == K_EP ? f.degsum > 0 : f.count > 0;
    if (!live || it >= p.max_iterations) break;
    if (p.kernel == K_NS) {
      // ns_activate, inside the iteration as in the reference's loop body,
      // then the split frontier's counts
      ns_gather(p, M);
      grid_sync(p.ctrl + CTRL_BAR);
      f = frontier_count(p, M, next);
    }
    if (p.kernel != K_EP) {
      frontier_compact(p, M, f);
      grid_sync(p.ctrl + CTRL_BAR);
    }
    int which = p.kernel;
    if (which == K_AD) {
      const int idx = ad_choice(p, f);
      ++chosen[idx];
      which = idx == 0 ? K_BS : (idx == 1 ? K_WD : K_HP);
    }
    if (which == K_BS || which == K_NS) {
      for (int32_t d = 0; d < f.maxdeg; ++d) {
        const NoteHook h = begin_chunk(p, seq);
        bs_column<MSG, COMB>(p, f.count, d, next, h);
        end_chunk(p, seq);
      }
    } else if (which == K_WD) {
      wd_step<MSG, COMB>(p, f, next, seq, sm);
    } else if (which == K_HP) {
      hp_step<MSG, COMB>(p, f, next, seq, sm);
    } else {
      const NoteHook h = begin_chunk(p, seq);
      ep_edges<MSG, COMB>(p, M, next, h);
      end_chunk(p, seq);
    }
    // BS, WD, HP, NS: the frontier's degree sum; EP: its valid edge lanes,
    // the same number
    edges += (unsigned)f.degsum;
    ++it;
    cur ^= 1;
  }
  if (gtid() == 0) {
    p.result[0] = it;
    p.result[1] = (long long)edges;
    p.result[2] = chosen[0];
    p.result[3] = chosen[1];
    p.result[4] = chosen[2];
  }
}

// ---------------------------------------------------------------------------
// delta mode: bucket epochs around the same dense steps
// ---------------------------------------------------------------------------

constexpr int32_t VALUE_INF = 1073741823;     // core/graph.py INF
constexpr int32_t NO_BUCKET = 2147483647;     // core/worklist.py NO_BUCKET

// worklist.bucket_index: the rank clipped to [0, INF], reflected for a max
// monoid, over delta
template <int COMB>
__device__ __forceinline__ int32_t bucket_of(int32_t v, int32_t delta) {
  const int32_t r = min(max(v, 0), VALUE_INF);
  return (COMB == COMB_MAX ? VALUE_INF - r : r) / delta;
}

// One pass over this block's segment of the values: fn(i, a, b, c) adds to
// the block's two sums and its max.  The block totals go through half
// `pass % 2` of btot; ends in a barrier.  Returns the grid totals and the
// sums of the blocks before this one (a frontier's counts, in the segments
// frontier_compact walks).
template <class Fn>
__device__ __forceinline__ Frontier delta_pass(const Params& p, int& pass,
                                               Fn fn) {
  int32_t lo, hi;
  segment(p.nk, lo, hi);
  int32_t a = 0, b = 0, c = 0;
  for (int32_t i = lo + threadIdx.x; i < hi; i += THREADS) fn(i, a, b, c);
  block_reduce3(a, b, c);
  int32_t* bt = p.btot + 4 * gridDim.x * (pass++ & 1);
  if (threadIdx.x == 0) {
    bt[4 * blockIdx.x] = a;
    bt[4 * blockIdx.x + 1] = b;
    bt[4 * blockIdx.x + 2] = c;
  }
  grid_sync(p.ctrl + CTRL_BAR);
  Frontier f;
  scan_totals(bt, f.count, f.degsum, f.maxdeg, f.before_count,
              f.before_deg);
  return f;
}

// One phase of an epoch (priority._phase): the strategy's dense step from
// the frontier P over q's graph (q: the light or the heavy Params), its
// improvements noted in U.  f holds P's counts on q from the pass that
// built P; NS gathers its children first and counts again.  Returns the
// phase's edges.  Not inlined: one copy serves the light and the heavy
// Params (kernel parameters, __grid_constant__, so passing their address
// copies nothing), and the kernel keeps two resident blocks a SM without
// spilling.
template <int MSG, int COMB>
__device__ __noinline__ int32_t delta_phase(const Params& q, uint8_t* P,
                                            Frontier f, uint8_t* U, int& seq,
                                            WdSmem& sm) {
  if (q.kernel == K_NS) {
    ns_gather(q, P);
    grid_sync(q.ctrl + CTRL_BAR);
    f = frontier_count(q, P, U);       // U is clear: clearing it is harmless
  }
  frontier_compact(q, P, f);
  grid_sync(q.ctrl + CTRL_BAR);
  int which = q.kernel;
  if (which == K_AD) {
    const int idx = ad_choice(q, f);
    which = idx == 0 ? K_BS : (idx == 1 ? K_WD : K_HP);
  }
  if (which == K_BS || which == K_NS) {
    for (int32_t d = 0; d < f.maxdeg; ++d) {
      const NoteHook h = begin_chunk(q, seq);
      bs_column<MSG, COMB>(q, f.count, d, U, h);
      end_chunk(q, seq);
    }
  } else if (which == K_WD) {
    wd_step<MSG, COMB>(q, f, U, seq, sm);
  } else {
    hp_step<MSG, COMB>(q, f, U, seq, sm);
  }
  return f.degsum;
}

template <int MSG, int COMB>
__global__ void __launch_bounds__(THREADS)
fused_delta_kernel(const __grid_constant__ Params p,
                   const __grid_constant__ Params ph) {
  __shared__ WdSmem sm;
  uint8_t* const M = p.live;
  uint8_t* const C = p.mask[0];
  uint8_t* const U = p.mask[1];
  uint8_t* const S = p.settled;
  for (int64_t i = gtid(); i < p.nk; i += gthreads()) {
    const int32_t v = __ldg(p.dist0 + i);
    p.A[i] = v;
    p.B[i] = v;
    p.stamp[i] = -1;
    M[i] = __ldg(p.mask0 + i) != 0;
    U[i] = 0;
  }
  grid_sync(p.ctrl + CTRL_BAR);

  int it = 0, seq = 0, pass = 0;
  int32_t b = NO_BUCKET, count = 0;
  long long rounds = 0;
  unsigned long long edges = 0;
  for (;;) {
    // M |= U; the live count and the minimum bucket (as NO_BUCKET - b,
    // maximised); U and S cleared for the epoch
    const Frontier live = delta_pass(
        p, pass, [&](int32_t i, int32_t& a, int32_t&, int32_t& c) {
          const uint8_t m = __ldcg(M + i) | __ldcg(U + i);
          M[i] = m;
          U[i] = 0;
          S[i] = 0;
          if (m) {
            ++a;
            c = max(c, NO_BUCKET - bucket_of<COMB>(__ldcg(p.A + i), p.delta));
          }
        });
    count = live.count;
    if (count == 0 || it >= p.max_iterations) break;
    const int32_t bk = NO_BUCKET - live.maxdeg;
    b = bk;
    for (;;) {
      // the light closure: C = (M | U) & bucket == b moves from M into S
      const Frontier f = delta_pass(
          p, pass, [&](int32_t i, int32_t& a, int32_t& sum, int32_t& c) {
            const uint8_t m = __ldcg(M + i) | __ldcg(U + i);
            U[i] = 0;
            const bool cur =
                m && bucket_of<COMB>(__ldcg(p.A + i), p.delta) == bk;
            C[i] = cur;
            M[i] = cur ? 0 : m;
            if (cur) {
              S[i] = 1;
              const int32_t d = degree(p, i);
              ++a;
              sum += d;
              c = max(c, d);
            }
          });
      if (f.count == 0) break;
      ++rounds;
      if (p.e > 0)              // an edgeless light graph relaxes nothing
        edges += (unsigned)delta_phase<MSG, COMB>(p, C, f, U, seq, sm);
    }
    if (ph.e > 0) {
      // the heavy pass: every settled node's heavy edges, once
      const Frontier f = delta_pass(
          ph, pass, [&](int32_t i, int32_t& a, int32_t& sum, int32_t& c) {
            if (__ldcg(S + i)) {
              const int32_t d = degree(ph, i);
              ++a;
              sum += d;
              c = max(c, d);
            }
          });
      const int32_t e = delta_phase<MSG, COMB>(ph, S, f, U, seq, sm);
      edges += (unsigned)e;
      rounds += e > 0;
    }
    ++it;
  }
  if (gtid() == 0) {
    p.result[0] = it;
    p.result[1] = (long long)edges;
    p.result[2] = rounds;
    p.result[3] = b;
    p.result[4] = count;
  }
}

// AD's selector alone, for the card tests: out[i] = ad_choice of the
// measured model on (count[i], degsum[i])
__global__ void ad_choice_probe_kernel(Params p, const int32_t* count,
                                       const int32_t* degsum, int m,
                                       int32_t* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  Frontier f{};
  f.count = count[i];
  f.degsum = degsum[i];
  out[i] = ad_choice(p, f);
}

// The workspace, carved from one buffer: each piece on a 256-byte boundary.
struct Layout {
  size_t ctrl, B, stamp, dirty, list, deg, pfx, exc, start, mask0, mask1,
      settled, btot, total;
};

Layout layout(int64_t n, int64_t max_grid) {
  Layout l{};
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off += (bytes + 255) & ~(size_t)255;
    return at;
  };
  l.ctrl = take(CTRL_WORDS * sizeof(unsigned));
  l.B = take(n * 4);
  l.stamp = take(n * 4);
  l.dirty = take(n * 4);
  l.list = take(n * 4);
  l.deg = take(n * 4);
  l.pfx = take(n * 4);
  l.exc = take(n * 4);
  l.start = take(n * 4);
  l.mask0 = take(n);
  l.mask1 = take(n);
  l.settled = take(n);
  l.btot = take(max_grid * 2 * 4 * 4);
  l.total = off;
  return l;
}

// The most blocks of THREADS threads the current card keeps resident: the
// grid can be no larger.
cudaError_t max_grid(int64_t* out) {
  int dev = 0, sms = 0, threads = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &threads, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  *out = (int64_t)sms * (threads / THREADS);
  return err;
}

// A cooperative launch of `kernel` with `args`: the grid is as many blocks
// as the card keeps resident.
cudaError_t launch_coop(const void* kernel, void** args, cudaStream_t st) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, 0);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  return cudaLaunchCooperativeKernel(kernel, dim3((unsigned)(sms * per_sm)),
                                     dim3(THREADS), args, 0, st);
}

template <int MSG, int COMB>
cudaError_t launch_t(Params p, cudaStream_t st) {
  void* args[] = {&p};
  return launch_coop((const void*)fused_fixed_point_kernel<MSG, COMB>, args,
                     st);
}

template <int MSG>
cudaError_t launch_msg(int comb, const Params& p, cudaStream_t st) {
  if (comb == COMB_MIN) return launch_t<MSG, COMB_MIN>(p, st);
  if (comb == COMB_MAX) return launch_t<MSG, COMB_MAX>(p, st);
  return launch_t<MSG, COMB_ADD>(p, st);
}

// delta mode: idempotent operators only (no COMB_ADD instances)
template <int MSG, int COMB>
cudaError_t launch_delta_t(Params p, Params ph, cudaStream_t st) {
  void* args[] = {&p, &ph};
  return launch_coop((const void*)fused_delta_kernel<MSG, COMB>, args, st);
}

template <int MSG>
cudaError_t launch_delta_msg(int comb, const Params& p, const Params& ph,
                             cudaStream_t st) {
  if (comb == COMB_MIN) return launch_delta_t<MSG, COMB_MIN>(p, ph, st);
  return launch_delta_t<MSG, COMB_MAX>(p, ph, st);
}

// The Params of one launch over n values (rows * nodes), the workspace
// carved by its layout; zeroes the control words.
cudaError_t make_params(Params& p, const int32_t* row_ptr, const int32_t* col,
                        const int32_t* wt, int32_t n, int32_t rows,
                        int32_t e, const int32_t* aux, const int32_t* dist0,
                        const uint8_t* mask0, int kernel, int max_iterations,
                        int mdt, int switch_threshold, int small_frontier,
                        float imbalance_threshold, int hp_edges_threshold,
                        int32_t* dist, void* workspace,
                        long long workspace_bytes, long long* result,
                        cudaStream_t st) {
  int64_t grid = 0;
  cudaError_t err = max_grid(&grid);
  if (err != cudaSuccess) return err;
  const Layout l = layout((int64_t)rows * n, grid);
  if (workspace_bytes < (long long)l.total) return cudaErrorInvalidValue;
  char* ws = static_cast<char*>(workspace);
  p = Params{};
  p.row_ptr = row_ptr;
  p.col = col;
  p.wt = wt;
  p.aux = aux;
  p.dist0 = dist0;
  p.mask0 = mask0;
  p.n = n;
  p.e = e;
  p.rows = rows;
  p.nk = rows * n;
  p.kernel = kernel;
  p.max_iterations = max_iterations;
  p.mdt = mdt;
  p.switch_threshold = switch_threshold;
  p.small_frontier = small_frontier;
  p.hp_edges_threshold = hp_edges_threshold;
  p.imbalance_threshold = imbalance_threshold;
  p.A = dist;
  p.B = reinterpret_cast<int32_t*>(ws + l.B);
  p.stamp = reinterpret_cast<int32_t*>(ws + l.stamp);
  p.dirty = reinterpret_cast<int32_t*>(ws + l.dirty);
  p.list = reinterpret_cast<int32_t*>(ws + l.list);
  p.deg = reinterpret_cast<int32_t*>(ws + l.deg);
  p.pfx = reinterpret_cast<int32_t*>(ws + l.pfx);
  p.exc = reinterpret_cast<int32_t*>(ws + l.exc);
  p.start = reinterpret_cast<int32_t*>(ws + l.start);
  p.mask[0] = reinterpret_cast<uint8_t*>(ws + l.mask0);
  p.mask[1] = reinterpret_cast<uint8_t*>(ws + l.mask1);
  p.settled = reinterpret_cast<uint8_t*>(ws + l.settled);
  p.btot = reinterpret_cast<int32_t*>(ws + l.btot);
  p.ctrl = reinterpret_cast<unsigned*>(ws + l.ctrl);
  p.result = result;
  return cudaMemsetAsync(p.ctrl, 0, CTRL_WORDS * sizeof(unsigned), st);
}

// Kernel attributes for the block-feasibility report: threads a block,
// static shared bytes, registers a thread, local bytes a thread, blocks
// resident per SM, SMs.
cudaError_t block_attrs(const void* kernel, int* out) {
  cudaFuncAttributes a;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, 0);
  if (err != cudaSuccess) return err;
  out[0] = THREADS;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = a.numRegs;
  out[3] = (int)a.localSizeBytes;
  out[4] = per_sm;
  out[5] = sms;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Bytes of workspace a traversal of n values (rows * nodes) needs on the
// current card.
int repro_fused_workspace_bytes(int32_t n, long long* bytes) {
  int64_t grid = 0;
  const cudaError_t err = max_grid(&grid);
  if (err != cudaSuccess) return (int)err;
  if (n < 1) return (int)cudaErrorInvalidValue;
  *bytes = (long long)layout(n, grid).total;
  return 0;
}

// One traversal, or a batch of `rows` WD traversals: n >= 1, e >= 0;
// wt == nullptr means weight 1; aux holds EP's edge sources [e] or NS's
// child -> parent map [n] (else unused); dist0 [rows, n] and mask0
// [rows, n] are read, dist [rows, n] receives the result; result [5]
// (int64) gets iterations, edges relaxed and AD's BS/WD/HP counts.
// coeffs (host memory, 9 floats, row-major (a, b, c) for BS, WD, HP) makes
// AD take the measured model; nullptr keeps the fixed tree.
// rows > 1 takes only kernel WD, and rows * n must stay below 2^31.
// workspace holds repro_fused_workspace_bytes(rows * n) bytes.
// Returns the status of the launch (cudaErrorCooperativeLaunchTooLarge
// if the grid cannot be resident).
int repro_fused_fixed_point(
    const int32_t* row_ptr, const int32_t* col, const int32_t* wt,
    int32_t n, int32_t rows, int32_t e, const int32_t* aux,
    const int32_t* dist0,
    const uint8_t* mask0, int kernel, int msg, int comb, int max_iterations,
    int mdt, int switch_threshold, int small_frontier,
    float imbalance_threshold, int hp_edges_threshold, const float* coeffs,
    int32_t* dist, void* workspace, long long workspace_bytes,
    long long* result, void* stream) {
  if (!codes_ok(msg, comb) || kernel < K_BS || kernel > K_AD || n < 1 ||
      e < 0 || mdt < 1 || dist == dist0 || rows < 1 ||
      (rows > 1 && kernel != K_WD) || (int64_t)rows * n >= (1LL << 31) ||
      ((kernel == K_EP || kernel == K_NS) && aux == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Params p;
  cudaError_t err = make_params(
      p, row_ptr, col, wt, n, rows, e, aux, dist0, mask0, kernel,
      max_iterations, mdt, switch_threshold, small_frontier,
      imbalance_threshold, hp_edges_threshold, dist, workspace,
      workspace_bytes, result, st);
  if (err != cudaSuccess) return (int)err;
  if (coeffs != nullptr) {
    p.measured = 1;
    for (int k = 0; k < 9; ++k) p.coeffs[k] = coeffs[k];
  }
  if (msg == MSG_SUM) err = launch_msg<MSG_SUM>(comb, p, st);
  else if (msg == MSG_COPY) err = launch_msg<MSG_COPY>(comb, p, st);
  else err = launch_msg<MSG_BOTTLENECK>(comb, p, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// A delta-stepping traversal of one query: the light graph (row_ptr, col,
// wt, e >= 0) and the heavy graph (hrow_ptr, hcol, hwt, he >= 1; he == 0:
// none) over the same n >= 1 nodes; kernel BS, WD, HP, NS (aux: the child
// -> parent map [n]) or AD (the fixed tree); an idempotent operator (comb
// MIN or MAX); delta >= 1; at most max_epochs epochs.  dist0 [n] and
// mask0 [n] are read; dist [n] and mask [n] receive the values and the
// frontier; result [5] (int64) gets epochs, edges relaxed, relax rounds,
// the last bucket settled and the frontier's count.  workspace holds
// repro_fused_workspace_bytes(n) bytes.
int repro_fused_delta(
    const int32_t* row_ptr, const int32_t* col, const int32_t* wt, int32_t e,
    const int32_t* hrow_ptr, const int32_t* hcol, const int32_t* hwt,
    int32_t he, int32_t n, const int32_t* aux, const int32_t* dist0,
    const uint8_t* mask0, int kernel, int msg, int comb, int delta,
    int max_epochs, int mdt, int switch_threshold, int small_frontier,
    float imbalance_threshold, int hp_edges_threshold, int32_t* dist,
    uint8_t* mask, void* workspace, long long workspace_bytes,
    long long* result, void* stream) {
  if (!codes_ok(msg, comb) || comb == COMB_ADD || kernel < K_BS ||
      kernel > K_AD || kernel == K_EP || n < 1 || e < 0 || he < 0 ||
      (he > 0 && hrow_ptr == nullptr) || delta < 1 || mdt < 1 ||
      dist == dist0 || (kernel == K_NS && aux == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Params p;
  cudaError_t err = make_params(
      p, row_ptr, col, wt, n, 1, e, aux, dist0, mask0, kernel, max_epochs,
      mdt, switch_threshold, small_frontier, imbalance_threshold,
      hp_edges_threshold, dist, workspace, workspace_bytes, result, st);
  if (err != cudaSuccess) return (int)err;
  p.delta = delta;
  p.live = mask;
  Params ph = p;
  if (he > 0) {
    ph.row_ptr = hrow_ptr;
    ph.col = hcol;
    ph.wt = hwt;
  }
  ph.e = he;
  if (msg == MSG_SUM) err = launch_delta_msg<MSG_SUM>(comb, p, ph, st);
  else if (msg == MSG_COPY) err = launch_delta_msg<MSG_COPY>(comb, p, ph, st);
  else err = launch_delta_msg<MSG_BOTTLENECK>(comb, p, ph, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// AD's measured selector on m (count, degree sum) pairs (device arrays),
// with the cost model coeffs (host memory, 9 floats): out[i] in {0, 1, 2}.
int repro_fused_ad_choice_probe(const float* coeffs, const int32_t* count,
                                const int32_t* degsum, int m, int32_t* out,
                                void* stream) {
  if (m < 1 || coeffs == nullptr) return (int)cudaErrorInvalidValue;
  Params p{};
  p.measured = 1;
  for (int k = 0; k < 9; ++k) p.coeffs[k] = coeffs[k];
  ad_choice_probe_kernel<<<(m + THREADS - 1) / THREADS, THREADS, 0,
                           (cudaStream_t)stream>>>(p, count, degsum, m, out);
  return (int)cudaGetLastError();
}

// which 0: the fused kernel (shortest_path's instance), 1: its delta mode;
// out [6] as block_attrs.
int repro_fused_block_attrs(int which, int* out) {
  if (which < 0 || which > 1) return (int)cudaErrorInvalidValue;
  const void* kernel =
      which == 0 ? (const void*)fused_fixed_point_kernel<MSG_SUM, COMB_MIN>
                 : (const void*)fused_delta_kernel<MSG_SUM, COMB_MIN>;
  return (int)block_attrs(kernel, out);
}

}  // extern "C"
