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
// choice, where a BS column's one-block tail starts) is computed from
// global cells read after a barrier, so every block takes the same path; a
// disagreement would deadlock the launch.
//
// The chunks are the reference's, so (dist, iterations, edges_relaxed)
// and AD's choices equal it bit for bit: one chunk per BS or NS column,
// per HP tile and for HP's cursor-aware WD tail, one per WD or EP
// iteration; AD takes BS, WD or HP.  A chunk's lanes read a snapshot that
// no lane of the chunk writes and fold improving candidates with int32
// atomics into the other of two value buffers; an improving lane notes its
// destination once (a per-node stamp of the chunk number, into one of two
// lists by the chunk's parity).  What a chunk costs:
//   * min and max (shortest_path, min_label, widest_path): ONE grid
//     barrier.  The buffers swap roles at every chunk: chunk s + 1 reads
//     the target of chunk s as its snapshot and folds into chunk s's
//     snapshot, into which it also folds chunk s's noted entries (their
//     values in its snapshot, with the same atomic).  The fold is
//     idempotent, so the target ends as fold(snapshot, candidates), as two
//     equal buffers would give.  The latest values lie in val[cur]; before
//     anything reads the other buffer (a one-block tail, the end of the
//     launch) the noted entries are copied across ("settle").
//   * add (reach_count) is not idempotent: the lanes read val[0] and fold
//     into val[1]; after a barrier the noted entries are copied back into
//     val[0], then a second barrier.
// The three chunk slots of control words (noted count, HP's live count)
// are reused every third chunk: slot s is written in chunk s, read after
// its barrier and in chunk s + 1, and cleared in chunk s + 2, a barrier
// after its last read.
//
// Narrow BS/NS columns inside one block.  In one iteration the live count
// of column d (the slots of degree > d) cannot grow with d.  The
// compaction counts the frontier's slots by the bit length of their degree
// (a 32-bin histogram, read by every block after the compaction's
// barrier); the tail starts at column 0 when at most tail_width slots have
// edges, else at the least power of two D with at most tail_width slots of
// degree >= D, and is taken when it has at least TAIL_MIN_COLUMNS columns.
// Columns below D run grid-wide; the slots of degree > D are
// gathered into a list meanwhile, and after one barrier (which also
// settles the buffers) block 0 runs every column from D on alone, each
// still its own chunk: its lanes read the snapshot and fold into the other
// buffer, a __syncthreads (which orders the block's global writes for its
// own threads) ends the column, and each thread folds the destinations its
// own lanes improved into the next target (or copies them back, for add).
// The other blocks go straight to the iteration's closing barrier.  Where
// the tail starts changes no bits: any start at which the live count is
// at most the block's width would do.
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
// Reads.  The value buffers, the masks and the tables are written by this
// launch, so they are read from L2 (ld.global.cg), never through the
// read-only path (no __ldg, no const __restrict__ on them): that path is
// not kept coherent with the launch's own writes.  row_ptr, col, wt and
// aux are never written and take __ldg.
//
// What bounds it on the H100: on the paper's rmat20 the traversal moves a
// few hundred MB (each relaxed edge's col, wt and two value gathers, the
// frontier's row_ptr and masks), a fraction of a millisecond at 3.35
// TB/s; what it pays instead is the grid barriers (a few microseconds
// each, counted in the result: thousands a BS traversal before the
// one-block tail) and the dependent gathers of each lane.  The design
// keeps the host out of the loop entirely; its times beside its bound are
// in PERF.md.
//
// A batch of K queries (the reference's _batch_fixed_point) is K launches,
// one a row (kernels/fused.py): rows never interact, and one launch over
// K flat rows measured slower than K single-row launches on the H100
// (likely because K rows of values and their second buffer outgrow the
// L2).
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
// dense steps inside bucket epochs).  fused_delta_kernel takes Params p
// over the light graph (w <= delta) and the heavy graph's row_ptr, col,
// wt and e beside it (e = 0: no heavy graph); every step reads its graph
// through a Graph, so the light and the heavy phases share one inlined
// copy of the steps, and the launch keeps three blocks a SM.  Each epoch
// finds the minimum live bucket with one grid-wide pass (the frontier M
// merged with the last phase's improvements U), then closes it over the
// light graph: a pass takes C = M & bucket(values) == b out of M into the
// settled set S (each node's bucket recomputed from the current values,
// b fixed for the epoch), and the strategy's step relaxes C into U, until
// no node of M lies in b.  Then the settled nodes relax their heavy edges
// once.  Rounds count the light passes and a heavy pass with edges; the
// loop caps epochs at max_iterations.  A pass's block totals alternate
// between two halves of btot, so consecutive passes need no extra barrier.
// One launch capped at one epoch is the stepped driver's epoch; it returns
// M, the bucket settled and the frontier's count beside the values.
//
// Every launch's result ends with its grid-wide chunks, its block-local
// chunks and its grid barriers.

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
// control words, zeroed before the launch: the barrier, the counts of
// barriers passed and of block-local chunks (block 0 keeps both); three
// chunk slots of (noted destinations, HP's live slots); by the parity of
// the frontier compaction, two counts of a BS tail's slots and two
// histograms of the frontier's degree bit lengths, each HIST_COPIES copies
// of 32 bins (block b adds into copy b % HIST_COPIES, so that fewer
// blocks queue on one word's atomics)
constexpr int HIST_COPIES = 8;
constexpr int HIST_WORDS = 32 * HIST_COPIES;
constexpr int CTRL_BAR = 0;
constexpr int CTRL_NBAR = 1;
constexpr int CTRL_NBLOCK = 2;
constexpr int CTRL_SLOTS = 4;
constexpr int CTRL_TAIL = 10;
constexpr int CTRL_HIST = 16;
constexpr int CTRL_WORDS = CTRL_HIST + 2 * HIST_WORDS;
static_assert(HIST_WORDS <= THREADS, "a block zeroes a histogram at once");
// the most slots a one-block BS/NS tail takes, 4 a thread; B1's staged
// slot slice holds their tables in shared memory
constexpr int TAIL_MAX = B1_TILE;
constexpr int TAIL_LANES = TAIL_MAX / THREADS;
// lanes a thread of the tail loads before it folds
constexpr int TAIL_GROUP = 2;
// the fewest columns a one-block tail takes (kernels/fused.py
// TAIL_MIN_COLUMNS): it costs two grid barriers of its own (one before,
// one after) and saves about one a column
constexpr int TAIL_MIN_COLUMNS = 4;
// int64 cells of a launch's result
constexpr int RESULT_CELLS = 8;
// resident blocks a SM the fused kernels are built for (at most 80
// registers a thread, which both fit with no spill): more blocks hide more
// of each lane's dependent gathers
constexpr int MIN_BLOCKS = 3;

struct Params {
  const int32_t* row_ptr;
  const int32_t* col;
  const int32_t* wt;         // null: weight 1
  const int32_t* aux;        // EP: edge sources [e]; NS: child -> parent [n]
  const int32_t* dist0;
  const uint8_t* mask0;
  int32_t n, e;
  int kernel, max_iterations, mdt, switch_threshold, small_frontier,
      hp_edges_threshold;
  float imbalance_threshold;
  int measured;              // AD: 1 takes the cost model's argmin
  float coeffs[9];           // AD's [3, 3] cost model: (a, b, c) per kernel
  int32_t delta;             // delta mode: the bucket width
  int32_t tail_width;        // most live slots of a one-block BS column
  int32_t* val[2];           // the two value buffers; val[0] is the result
  int32_t* stamp;            // [n] the chunk that last noted a destination
  int32_t* dirty[2];         // [n] destinations noted, by chunk parity
  int32_t* list;             // [n] the frontier's nodes, ascending
  int32_t* deg;              // [n] their degrees
  int32_t* pfx;              // [n] inclusive prefix of the merge-path work
  int32_t* exc;              // [n] exclusive prefix
  int32_t* start;            // [n] first edge of a slot's (remaining) run
  int32_t* tail;             // [TAIL_MAX] slots of a one-block BS tail
  uint8_t* mask[2];          // frontier masks of alternate iterations
                             // (delta mode: C and U)
  uint8_t* live;             // delta mode: the frontier M, the output mask
  uint8_t* settled;          // delta mode: S, the nodes settled this epoch
  int32_t* btot;             // [2][grid * 4] block totals of the last scan
  unsigned* ctrl;            // CTRL_WORDS
  long long* result;         // RESULT_CELLS: see the kernels' ends
};

// The graph a step relaxes: Params' own, or the delta mode's heavy graph
// over the same nodes (e = 0: none).
struct Graph {
  const int32_t* row_ptr;
  const int32_t* col;
  const int32_t* wt;         // null: weight 1
  int32_t e;
};

__host__ __device__ __forceinline__ Graph graph_of(const Params& p) {
  return Graph{p.row_ptr, p.col, p.wt, p.e};
}

// The frontier of one iteration: grid totals, and the counts of the
// blocks before this one (where its slots start in the tables).
struct Frontier {
  int32_t count, degsum, maxdeg, before_count, before_deg;
};

// Where a launch stands in its chunk sequence; every block holds the same.
// Four bits of state share one word (each thread of the grid holds it):
// which buffer holds the latest values, whether the last chunk's noted
// entries are still to be folded into the other one (min, max), the
// parity of the frontier compactions (which picks a compaction's
// histogram and tail count) and, in delta mode, of the grid-wide passes
// (which picks a pass's half of btot).
struct Chunking {
  int seq = 0;               // grid-wide chunks begun (the next's stamp)
  unsigned bits = 0;
  __device__ int cur() const { return bits & 1; }
  __device__ bool pending() const { return bits & 2; }
  __device__ void swap() { bits = (bits ^ 1) | 2; }   // and pending
  __device__ void settled() { bits &= ~2u; }
  // the parity of the next compaction, which it then counts
  __device__ int compaction() {
    const int par = (bits >> 2) & 1;
    bits ^= 4;
    return par;
  }
  __device__ int last_compaction() const { return ((bits >> 2) & 1) ^ 1; }
  __device__ int pass() {
    const int par = (bits >> 3) & 1;
    bits ^= 8;
    return par;
  }
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
// instead of hanging the card.  Block 0 counts the barriers in the word
// after the barrier's.
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
    if (blockIdx.x == 0) ++bar[CTRL_NBAR - CTRL_BAR];
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

__device__ __forceinline__ int32_t degree(const Graph& gr, int32_t i) {
  return __ldg(gr.row_ptr + i + 1) - __ldg(gr.row_ptr + i);
}

// The frontier's count, degree sum and max degree (ends in a barrier);
// zeroes the next iteration's mask on the way.
__device__ Frontier frontier_count(const Params& p, const Graph& graph,
                                   const uint8_t* M, uint8_t* next) {
  const Graph gr = graph;   // held by the loop, not reloaded after stores
  int32_t lo, hi;
  segment(p.n, lo, hi);
  int32_t cnt = 0, sum = 0, mx = 0;
  for (int32_t i = lo + threadIdx.x; i < hi; i += THREADS) {
    next[i] = 0;
    if (__ldcg(M + i)) {
      const int32_t d = degree(gr, i);
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

// Write the frontier's slot tables in ascending node order and, where a
// BS or NS step may take a one-block tail (`bins`: more than tail_width
// slots; with fewer it starts at column 0), add the bit lengths of the
// slots' nonzero degrees into this compaction's histogram (the other parity's histogram and tail
// count are zeroed for the next one: their last reads were a barrier ago);
// the caller waits at a barrier before any block reads them.
__device__ void frontier_compact(const Params& p, const Graph& graph,
                                 const uint8_t* M, const Frontier& f,
                                 Chunking& ch, bool bins) {
  const Graph gr = graph;
  __shared__ int32_t hist[32];
  const int par = ch.compaction();
  if (threadIdx.x < 32) hist[threadIdx.x] = 0;
  if (blockIdx.x == 0) {
    if (threadIdx.x < HIST_WORDS)
      p.ctrl[CTRL_HIST + HIST_WORDS * (par ^ 1) + threadIdx.x] = 0;
    if (threadIdx.x == 0) p.ctrl[CTRL_TAIL + (par ^ 1)] = 0;
  }
  __syncthreads();
  int32_t lo, hi;
  segment(p.n, lo, hi);
  int32_t pc = f.before_count, pd = f.before_deg;
  for (int32_t base = lo; base < hi; base += THREADS) {
    const int32_t i = base + threadIdx.x;
    int32_t on = 0, d = 0;
    if (i < hi && __ldcg(M + i)) {
      on = 1;
      d = degree(gr, i);
      if (bins && d) atomicAdd(hist + (32 - __clz(d)), 1);
    }
    int32_t a = on, b = d, ta, tb;
    block_scan2(a, b, ta, tb);
    if (on) {
      const int32_t pos = pc + a - 1;
      p.list[pos] = i;
      p.deg[pos] = d;
      p.start[pos] = __ldg(gr.row_ptr + i);
      p.pfx[pos] = pd + b;
      p.exc[pos] = pd + b - d;
    }
    pc += ta;
    pd += tb;
  }
  __syncthreads();
  if (bins && threadIdx.x < 32 && hist[threadIdx.x])
    atomicAdd(p.ctrl + CTRL_HIST + HIST_WORDS * par +
                  32 * (blockIdx.x % HIST_COPIES) + threadIdx.x,
              (unsigned)hist[threadIdx.x]);
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
__device__ __forceinline__ unsigned* chunk_slot(const Params& p, int seq) {
  return p.ctrl + CTRL_SLOTS + 2 * (seq % 3);
}

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

// A grid-wide chunk: the snapshot its lanes read, the buffer they fold
// into, and the note of an improving lane.
struct Chunk {
  const int32_t* snap;
  int32_t* tgt;
  NoteHook note;
};

// Chunk seq notes into slot seq % 3 and list seq % 2, and clears the slot
// of chunk seq + 1 (last read in chunk seq - 1, a barrier ago).  After a
// chunk of a min or max, its noted entries are folded into this chunk's
// target, with the lanes' own folds.
template <int COMB>
__device__ Chunk begin_chunk(const Params& p, const Chunking& ch) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned* next = chunk_slot(p, ch.seq + 1);
    next[0] = 0;
    next[1] = 0;
  }
  const int32_t* snap = p.val[ch.cur()];
  int32_t* tgt = p.val[ch.cur() ^ 1];
  if (ch.pending()) {
    const unsigned noted = __ldcg(chunk_slot(p, ch.seq - 1));
    const int32_t* dirty = p.dirty[(ch.seq - 1) & 1];
    for (int64_t k = gtid(); k < noted; k += gthreads()) {
      const int32_t d = __ldcg(dirty + k);
      fold<COMB>(tgt + d, __ldcg(snap + d));
    }
  }
  return Chunk{snap, tgt,
               NoteHook{p.stamp, p.dirty[ch.seq & 1], chunk_slot(p, ch.seq),
                        ch.seq}};
}

// Wait for every fold of the chunk.  min, max: the target holds the
// latest values and the buffers swap roles.  add: copy the noted entries
// of val[1] into val[0] and wait again.  Returns the chunk's HP live
// count.
template <int COMB>
__device__ unsigned end_chunk(const Params& p, Chunking& ch) {
  const unsigned* slot = chunk_slot(p, ch.seq);
  grid_sync(p.ctrl + CTRL_BAR);
  const unsigned live = __ldcg(slot + 1);
  if (COMB == COMB_ADD) {
    const unsigned noted = __ldcg(slot);
    const int32_t* dirty = p.dirty[ch.seq & 1];
    for (int64_t k = gtid(); k < noted; k += gthreads()) {
      const int32_t d = __ldcg(dirty + k);
      p.val[0][d] = __ldcg(p.val[1] + d);
    }
    grid_sync(p.ctrl + CTRL_BAR);
  } else {
    ch.swap();
  }
  ++ch.seq;
  return live;
}

// Copy the last chunk's noted entries into the other buffer (plain
// stores: nothing else writes it now), so that both hold the latest
// values once the caller's barrier, or the launch's end, has passed.
__device__ void settle(const Params& p, Chunking& ch) {
  if (!ch.pending()) return;
  const unsigned noted = __ldcg(chunk_slot(p, ch.seq - 1));
  const int32_t* dirty = p.dirty[(ch.seq - 1) & 1];
  const int32_t* from = p.val[ch.cur()];
  int32_t* to = p.val[ch.cur() ^ 1];
  for (int64_t k = gtid(); k < noted; k += gthreads()) {
    const int32_t d = __ldcg(dirty + k);
    to[d] = __ldcg(from + d);
  }
  ch.settled();
}

template <int MSG, int COMB>
__device__ __forceinline__ void relax_one(const Params& p, const Graph& gr,
                                          const Chunk& c, bool valid,
                                          int32_t src, int32_t eidx,
                                          uint8_t* upd) {
  bool v[1] = {valid};
  int32_t s[1] = {src}, d[1] = {0}, w[1] = {1};
  if (valid) {
    const int32_t ec = clamp_index(eidx, gr.e);
    d[0] = __ldg(gr.col + ec);
    if (gr.wt) w[0] = __ldg(gr.wt + ec);
  }
  bool imp[1];
  relax_group<1, MSG, COMB, Coherent>(c.snap, p.n, v, s, d, w, c.tgt, upd,
                                      imp, c.note);
}

// BS/NS column d, grid-wide: the d-th edge of every frontier slot
template <int MSG, int COMB>
__device__ void bs_column(const Params& p, const Graph& gr, const Chunk& c,
                          int32_t count, int32_t d, uint8_t* upd) {
  for (int64_t i = gtid(); i < count; i += gthreads()) {
    const bool valid = d < __ldcg(p.deg + i);
    int32_t src = 0, eidx = 0;
    if (valid) {
      src = __ldcg(p.list + i);
      eidx = __ldcg(p.start + i) + d;
    }
    relax_one<MSG, COMB>(p, gr, c, valid, src, eidx, upd);
  }
}

// HP tile at cursor c: every slot's edges [c, min(c + mdt, deg)), a warp
// a slot that has any (found 32 slots at a time by ballot); counts the
// slots with edges left past c + mdt into the chunk's live count.
template <int MSG, int COMB>
__device__ void hp_tile(const Params& p, const Graph& gr, const Chunk& ck,
                        int32_t count, int32_t c, uint8_t* upd) {
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
        relax_one<MSG, COMB>(p, gr, ck, j < hi, src, st + j, upd);
      }
    }
  }
  int32_t unused0 = 0, unused1 = 0;
  block_reduce3(live, unused0, unused1);
  if (threadIdx.x == 0 && live)
    atomicAdd(ck.note.noted + 1, (unsigned)live);
}

// EP: every edge a lane, valid where its source is in the frontier
template <int MSG, int COMB>
__device__ void ep_edges(const Params& p, const Chunk& c, const uint8_t* M,
                         uint8_t* upd) {
  for (int64_t k = gtid(); k < p.e; k += gthreads()) {
    const int32_t src = clamp_index(__ldg(p.aux + k), p.n);
    relax_one<MSG, COMB>(p, graph_of(p), c, __ldcg(M + src) != 0, src,
                         (int32_t)k, upd);
  }
}

// WD, and HP's tail: B1's merge-path tiles over `total` lanes
template <int MSG, int COMB>
__device__ void merge_path(const Params& p, const Graph& gr, const Chunk& c,
                           int32_t count, int64_t total, uint8_t* upd,
                           WdSmem& sm) {
  const int64_t tiles = (total + B1_TILE - 1) / B1_TILE;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x)
    wd_tile<MSG, COMB, Coherent>(t, c.snap, p.n, p.pfx, p.exc, p.start,
                                 p.list, count, gr.col, gr.wt, gr.e,
                                 (int32_t)total, total, c.tgt, upd, nullptr,
                                 sm, c.note);
}

template <int MSG, int COMB>
__device__ void wd_step(const Params& p, const Graph& gr, const Frontier& f,
                        uint8_t* upd, Chunking& ch, WdSmem& sm) {
  const Chunk c = begin_chunk<COMB>(p, ch);
  merge_path<MSG, COMB>(p, gr, c, f.count, f.degsum, upd, sm);
  end_chunk<COMB>(p, ch);
}

// HP: WD for a small frontier; else MDT-wide tiles while more than
// switch_threshold slots have edges left (at least one tile), then the
// cursor-aware WD tail
template <int MSG, int COMB>
__device__ void hp_step(const Params& p, const Graph& gr, const Frontier& f,
                        uint8_t* upd, Chunking& ch, WdSmem& sm) {
  if (f.count <= p.switch_threshold) {
    wd_step<MSG, COMB>(p, gr, f, upd, ch, sm);
    return;
  }
  int32_t c = 0;
  unsigned live;
  do {
    const Chunk ck = begin_chunk<COMB>(p, ch);
    hp_tile<MSG, COMB>(p, gr, ck, f.count, c, upd);
    live = end_chunk<COMB>(p, ch);
    c += p.mdt;
  } while ((int64_t)live > p.switch_threshold);
  const int64_t total = tail_tables(p, f.count, c);
  if (total > 0) {                      // an empty tail relaxes nothing
    const Chunk ck = begin_chunk<COMB>(p, ch);
    merge_path<MSG, COMB>(p, gr, ck, f.count, total, upd, sm);
    end_chunk<COMB>(p, ch);
  }
}

// The first BS/NS column of the one-block tail, from the histogram of
// compaction `par` (read after its barrier) of a frontier of `count`
// slots: 0 when at most tail_width slots have edges, else the least power
// of two D with at most tail_width slots of degree >= D (#(deg >= 2^j)
// sums the bins of bit length > j); INT32_MAX for none (tail_width 0).
// core/fused.py tail_start is the same rule.
__device__ int32_t tail_start(const Params& p, int par, int32_t count) {
  const int32_t w = p.tail_width;
  if (w <= 0) return INT32_MAX;
  if (count <= w) return 0;             // no histogram was built
  // every warp alone: lane b sums bin b over the copies, then the suffix
  // sums S(b) = #(bit length >= b) = #(deg >= 2^(b - 1)); the start is
  // 2^b for the highest b >= 1 with S(b) > w
  const int lane = threadIdx.x & 31;
  const unsigned* h = p.ctrl + CTRL_HIST + HIST_WORDS * par + lane;
  int32_t s = 0;
#pragma unroll
  for (int c = 0; c < HIST_COPIES; ++c) s += (int32_t)__ldcg(h + 32 * c);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t x = __shfl_down_sync(FULL, s, o);
    if (lane + o < 32) s += x;
  }
  const unsigned over = __ballot_sync(FULL, lane >= 1 && s > w);
  if (!over) return 0;
  const int b = 31 - __clz(over);
  return b >= 31 ? INT32_MAX : 1 << b;
}

// The tail's slots (degree > d0), appended in any order: the column's
// lanes fold with atomics, so the order changes no bits.  At most
// tail_width of them, by tail_start's rule.
__device__ void gather_tail(const Params& p, int32_t count, int32_t d0,
                            int par) {
  int32_t lo, hi;
  segment(count, lo, hi);
  unsigned* n_tail = p.ctrl + CTRL_TAIL + par;
  for (int32_t i0 = lo; i0 < hi; i0 += THREADS) {
    const int32_t i = i0 + threadIdx.x;
    const bool take = i < hi && __ldcg(p.deg + i) > d0;
    const unsigned mask = __ballot_sync(FULL, take);
    if (!mask) continue;
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(mask) - 1;
    unsigned base = 0;
    if (lane == leader) base = atomicAdd(n_tail, (unsigned)__popc(mask));
    base = __shfl_sync(FULL, base, leader);
    if (take) p.tail[base + __popc(mask & ((1u << lane) - 1u))] = i;
  }
}

// BS/NS columns [d0, d1) inside one block, over the m tail slots; val[cur]
// holds the latest values and equals the other buffer.  Each column is its
// own chunk: the lanes read one buffer and fold into the other, and a
// __syncthreads ends it.  Then, for min and max, each thread folds the
// destinations its own lanes improved into the next column's target (the
// column's snapshot), with the next column's lanes; for add it copies them
// back from val[1] into val[0] and waits again.  Leaves both buffers
// equal.  Slot i's source, first edge and degree, and the destination its
// lane improved in the last column (-1: none), are staged in B1's shared
// slot tables; thread t takes slots t, t + THREADS, ...
template <int MSG, int COMB>
__device__ void tail_columns(const Params& p, const Graph& gr, int32_t d0,
                             int32_t d1, int32_t m, int cur, uint8_t* upd,
                             WdSmem& sm) {
  int32_t* const improved = sm.excl;
  for (int32_t i = threadIdx.x; i < TAIL_MAX; i += THREADS) {
    improved[i] = -1;
    if (i < m) {
      const int32_t slot = __ldcg(p.tail + i);
      sm.src[i] = __ldcg(p.list + slot);
      sm.start[i] = __ldcg(p.start + slot);
      sm.prefix[i] = __ldcg(p.deg + slot);
    }
  }
  __syncthreads();
  for (int32_t d = d0; d < d1; ++d) {
    const int32_t* snap = p.val[cur];
    int32_t* tgt = p.val[cur ^ 1];
#pragma unroll
    for (int j0 = 0; j0 < TAIL_LANES; j0 += TAIL_GROUP) {
      bool v[TAIL_GROUP], imp[TAIL_GROUP];
      int32_t s[TAIL_GROUP] = {}, c[TAIL_GROUP] = {}, w[TAIL_GROUP] = {};
#pragma unroll
      for (int g = 0; g < TAIL_GROUP; ++g) {
        const int32_t i = threadIdx.x + (j0 + g) * THREADS;
        const int32_t last = improved[i];
        if (COMB != COMB_ADD && last >= 0)
          fold<COMB>(tgt + last, __ldcg(snap + last));
        v[g] = i < m && d < sm.prefix[i];
        if (v[g]) {
          s[g] = sm.src[i];
          const int32_t ec = clamp_index((int64_t)sm.start[i] + d, gr.e);
          c[g] = __ldg(gr.col + ec);
          w[g] = gr.wt ? __ldg(gr.wt + ec) : 1;
        }
      }
      relax_group<TAIL_GROUP, MSG, COMB, Coherent>(snap, p.n, v, s, c, w,
                                                   tgt, upd, imp, NoHook{});
#pragma unroll
      for (int g = 0; g < TAIL_GROUP; ++g)
        improved[threadIdx.x + (j0 + g) * THREADS] = imp[g] ? c[g] : -1;
    }
    __syncthreads();
    if (COMB == COMB_ADD) {
#pragma unroll
      for (int j = 0; j < TAIL_LANES; ++j) {
        const int32_t last = improved[threadIdx.x + j * THREADS];
        if (last >= 0) p.val[0][last] = __ldcg(p.val[1] + last);
      }
      __syncthreads();
    } else {
      cur ^= 1;
    }
  }
  if (COMB != COMB_ADD) {
#pragma unroll
    for (int j = 0; j < TAIL_LANES; ++j) {
      const int32_t last = improved[threadIdx.x + j * THREADS];
      if (last >= 0) p.val[cur ^ 1][last] = __ldcg(p.val[cur] + last);
    }
  }
}

// BS/NS: the frontier's max degree columns, after frontier_compact and its
// barrier.  Columns below the tail's start run grid-wide, a chunk each;
// the rest in block 0 (tail_columns), after a barrier that settles the
// buffers and publishes the tail's slots, and before the closing one.
template <int MSG, int COMB>
__device__ void bs_step(const Params& p, const Graph& gr, const Frontier& f,
                        uint8_t* upd, Chunking& ch, WdSmem& sm) {
  const int par = ch.last_compaction();
  int32_t d0 = min(tail_start(p, par, f.count), f.maxdeg);
  if (f.maxdeg - d0 < TAIL_MIN_COLUMNS) d0 = f.maxdeg;
  if (d0 < f.maxdeg) gather_tail(p, f.count, d0, par);
  for (int32_t d = 0; d < d0; ++d) {
    const Chunk c = begin_chunk<COMB>(p, ch);
    bs_column<MSG, COMB>(p, gr, c, f.count, d, upd);
    end_chunk<COMB>(p, ch);
  }
  if (d0 == f.maxdeg) return;
  settle(p, ch);
  grid_sync(p.ctrl + CTRL_BAR);
  if (blockIdx.x == 0)
    tail_columns<MSG, COMB>(p, gr, d0, f.maxdeg,
                            (int32_t)__ldcg(p.ctrl + CTRL_TAIL + par),
                            ch.cur(), upd, sm);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    p.ctrl[CTRL_NBLOCK] += f.maxdeg - d0;
  grid_sync(p.ctrl + CTRL_BAR);
}

// NS's ns_activate: children take their parent's value and activity
// (parents map to themselves and are not written); both buffers, so a
// pending fold finds the child equal in both
__device__ __forceinline__ void ns_gather(const Params& p,
                                          const Chunking& ch, uint8_t* M) {
  for (int64_t i = gtid(); i < p.n; i += gthreads()) {
    const int32_t par = __ldg(p.aux + i);
    if (par != i) {
      const int32_t v = __ldcg(p.val[ch.cur()] + par);
      p.val[0][i] = v;
      p.val[1][i] = v;
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

// The launch's last words: the result's chunk and barrier counts, after
// cells 0-4 (the caller's)
static_assert(RESULT_CELLS == 8, "the result ends with cells 5, 6 and 7");
__device__ __forceinline__ void write_counts(const Params& p,
                                             const Chunking& ch) {
  p.result[5] = ch.seq;
  p.result[6] = __ldcg(p.ctrl + CTRL_NBLOCK);
  p.result[7] = __ldcg(p.ctrl + CTRL_NBAR);
}

template <int MSG, int COMB>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fused_fixed_point_kernel(Params p) {
  __shared__ WdSmem sm;
  for (int64_t i = gtid(); i < p.n; i += gthreads()) {
    const int32_t v = __ldg(p.dist0 + i);
    p.val[0][i] = v;
    p.val[1][i] = v;
    p.stamp[i] = -1;
    p.mask[0][i] = __ldg(p.mask0 + i) != 0;
  }
  grid_sync(p.ctrl + CTRL_BAR);

  const Graph gr = graph_of(p);
  Chunking ch;
  int cur = 0, it = 0;
  unsigned long long edges = 0;
  int chosen[3] = {0, 0, 0};
  for (;;) {
    uint8_t* M = p.mask[cur];
    uint8_t* next = p.mask[cur ^ 1];
    Frontier f = frontier_count(p, gr, M, next);
    // EP stops when the frontier has no outgoing edges
    const bool live = p.kernel == K_EP ? f.degsum > 0 : f.count > 0;
    if (!live || it >= p.max_iterations) break;
    if (p.kernel == K_NS) {
      // ns_activate, inside the iteration as in the reference's loop body,
      // then the split frontier's counts
      ns_gather(p, ch, M);
      grid_sync(p.ctrl + CTRL_BAR);
      f = frontier_count(p, gr, M, next);
    }
    int which = p.kernel;
    if (which == K_AD) {
      const int idx = ad_choice(p, f);
      ++chosen[idx];
      which = idx == 0 ? K_BS : (idx == 1 ? K_WD : K_HP);
    }
    if (which != K_EP) {
      frontier_compact(p, gr, M, f, ch,
                       (which == K_BS || which == K_NS) &&
                           p.tail_width > 0 && f.count > p.tail_width);
      grid_sync(p.ctrl + CTRL_BAR);
    }
    if (which == K_BS || which == K_NS) {
      bs_step<MSG, COMB>(p, gr, f, next, ch, sm);
    } else if (which == K_WD) {
      wd_step<MSG, COMB>(p, gr, f, next, ch, sm);
    } else if (which == K_HP) {
      hp_step<MSG, COMB>(p, gr, f, next, ch, sm);
    } else {
      const Chunk c = begin_chunk<COMB>(p, ch);
      ep_edges<MSG, COMB>(p, c, M, next);
      end_chunk<COMB>(p, ch);
    }
    // BS, WD, HP, NS: the frontier's degree sum; EP: its valid edge lanes,
    // the same number
    edges += (unsigned)f.degsum;
    ++it;
    cur ^= 1;
  }
  settle(p, ch);                        // the result lies in val[0]
  if (gtid() == 0) {
    p.result[0] = it;
    p.result[1] = (long long)edges;
    p.result[2] = chosen[0];
    p.result[3] = chosen[1];
    p.result[4] = chosen[2];
    write_counts(p, ch);
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
// the block's two sums and its max.  The block totals go through the half
// of btot the parity of the passes picks; ends in a barrier.  Returns the grid totals and the
// sums of the blocks before this one (a frontier's counts, in the segments
// frontier_compact walks).
template <class Fn>
__device__ __forceinline__ Frontier delta_pass(const Params& p, Chunking& ch,
                                               Fn fn) {
  int32_t lo, hi;
  segment(p.n, lo, hi);
  int32_t a = 0, b = 0, c = 0;
  for (int32_t i = lo + threadIdx.x; i < hi; i += THREADS) fn(i, a, b, c);
  block_reduce3(a, b, c);
  int32_t* bt = p.btot + 4 * gridDim.x * ch.pass();
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
// the frontier P over graph gr (the light graph or the heavy one), its
// improvements noted in U.  f holds P's counts on gr from the pass that
// built P; NS gathers its children first and counts again.  Returns the
// phase's edges.  The kernel has one call site, so it is inlined once.
template <int MSG, int COMB>
__device__ __forceinline__ int32_t delta_phase(const Params& p,
                                               const Graph& gr, uint8_t* P,
                                               Frontier f, uint8_t* U,
                                               Chunking& ch, WdSmem& sm) {
  if (p.kernel == K_NS) {
    ns_gather(p, ch, P);
    grid_sync(p.ctrl + CTRL_BAR);
    f = frontier_count(p, gr, P, U);   // U is clear: clearing it is harmless
  }
  int which = p.kernel;
  if (which == K_AD) {
    const int idx = ad_choice(p, f);
    which = idx == 0 ? K_BS : (idx == 1 ? K_WD : K_HP);
  }
  frontier_compact(p, gr, P, f, ch,
                   (which == K_BS || which == K_NS) && p.tail_width > 0 &&
                       f.count > p.tail_width);
  grid_sync(p.ctrl + CTRL_BAR);
  if (which == K_BS || which == K_NS) {
    bs_step<MSG, COMB>(p, gr, f, U, ch, sm);
  } else if (which == K_WD) {
    wd_step<MSG, COMB>(p, gr, f, U, ch, sm);
  } else {
    hp_step<MSG, COMB>(p, gr, f, U, ch, sm);
  }
  return f.degsum;
}

// p carries the light graph (w <= delta) and heavy the heavy one (e = 0:
// none).  Each epoch's light passes and its heavy pass take turns at the
// one phase call site.
template <int MSG, int COMB>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fused_delta_kernel(const __grid_constant__ Params p,
                   const __grid_constant__ Graph heavy,
                   const __grid_constant__ Graph light) {
  __shared__ WdSmem sm;
  uint8_t* const M = p.live;
  uint8_t* const C = p.mask[0];
  uint8_t* const U = p.mask[1];
  uint8_t* const S = p.settled;
  for (int64_t i = gtid(); i < p.n; i += gthreads()) {
    const int32_t v = __ldg(p.dist0 + i);
    p.val[0][i] = v;
    p.val[1][i] = v;
    p.stamp[i] = -1;
    M[i] = __ldg(p.mask0 + i) != 0;
    U[i] = 0;
  }
  grid_sync(p.ctrl + CTRL_BAR);

  Chunking ch;
  int it = 0;
  // rounds, edges, the last bucket and the frontier's count go straight
  // into the result cells, kept by thread 0 (no register of every thread
  // holds them)
  const bool keeper = gtid() == 0;
  if (keeper) {
    p.result[1] = 0;
    p.result[2] = 0;
    p.result[3] = NO_BUCKET;
  }
  for (;;) {
    // M |= U; the live count and the minimum bucket (as NO_BUCKET - b,
    // maximised); U and S cleared for the epoch
    const int32_t* vals = p.val[ch.cur()];
    const Frontier live = delta_pass(
        p, ch, [&](int32_t i, int32_t& a, int32_t&, int32_t& c) {
          const uint8_t m = __ldcg(M + i) | __ldcg(U + i);
          M[i] = m;
          U[i] = 0;
          S[i] = 0;
          if (m) {
            ++a;
            c = max(c, NO_BUCKET - bucket_of<COMB>(__ldcg(vals + i),
                                                   p.delta));
          }
        });
    if (keeper) p.result[4] = live.count;
    if (live.count == 0 || it >= p.max_iterations) break;
    int32_t bk = NO_BUCKET - live.maxdeg;
    if (keeper) p.result[3] = bk;
    // after a pass, bk is read back from the cell thread 0 wrote before
    // it (a barrier ago), so no register holds it through the phase
    for (bool heavy_turn = false; !heavy_turn;
         bk = (int32_t)__ldcg(p.result + 3)) {
      // the light closure: C = (M | U) & bucket == b moves from M into S
      const int32_t* now = p.val[ch.cur()];
      Frontier f = delta_pass(
          p, ch, [&](int32_t i, int32_t& a, int32_t& sum, int32_t& c) {
            const uint8_t m = __ldcg(M + i) | __ldcg(U + i);
            U[i] = 0;
            const bool cur =
                m && bucket_of<COMB>(__ldcg(now + i), p.delta) == bk;
            C[i] = cur;
            M[i] = cur ? 0 : m;
            if (cur) {
              S[i] = 1;
              const int32_t d = degree(light, i);
              ++a;
              sum += d;
              c = max(c, d);
            }
          });
      if (f.count == 0) {
        if (heavy.e == 0) break;
        // the heavy pass: every settled node's heavy edges, once
        heavy_turn = true;
        f = delta_pass(
            p, ch, [&](int32_t i, int32_t& a, int32_t& sum, int32_t& c) {
              if (__ldcg(S + i)) {
                const int32_t d = degree(heavy, i);
                ++a;
                sum += d;
                c = max(c, d);
              }
            });
      } else {
        if (keeper) ++p.result[2];
        if (p.e == 0) continue;  // an edgeless light graph relaxes nothing
      }
      // the phase's graph by the address of a kernel parameter, so that
      // no register holds its arrays through the phase (the passes over
      // every node copy the one array they read)
      const Graph* gp = heavy_turn ? &heavy : &light;
      const int32_t e = delta_phase<MSG, COMB>(
          p, *gp, heavy_turn ? S : C, f, U, ch, sm);
      if (keeper) {
        p.result[1] += (unsigned)e;
        if (heavy_turn && e > 0) ++p.result[2];
      }
    }
    ++it;
  }
  settle(p, ch);                        // the result lies in val[0]
  if (keeper) {
    p.result[0] = it;
    write_counts(p, ch);
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

// k grid barriers and nothing else, for the barrier's cost alone
__global__ void __launch_bounds__(THREADS)
barrier_probe_kernel(unsigned* bar, int k) {
  for (int i = 0; i < k; ++i) grid_sync(bar);
}

// The workspace, carved from one buffer: each piece on a 256-byte boundary.
struct Layout {
  size_t ctrl, B, stamp, dirty0, dirty1, list, deg, pfx, exc, start, tail,
      mask0, mask1, settled, btot, total;
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
  l.dirty0 = take(n * 4);
  l.dirty1 = take(n * 4);
  l.list = take(n * 4);
  l.deg = take(n * 4);
  l.pfx = take(n * 4);
  l.exc = take(n * 4);
  l.start = take(n * 4);
  l.tail = take(TAIL_MAX * 4);
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
// of `sized_as` as the card keeps resident (sized_as: kernel itself when
// null).
cudaError_t launch_coop(const void* kernel, void** args, cudaStream_t st,
                        const void* sized_as = nullptr) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sized_as ? sized_as : kernel, THREADS, 0);
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
cudaError_t launch_delta_t(Params p, Graph heavy, cudaStream_t st) {
  Graph light = graph_of(p);
  void* args[] = {&p, &heavy, &light};
  return launch_coop((const void*)fused_delta_kernel<MSG, COMB>, args, st);
}

template <int MSG>
cudaError_t launch_delta_msg(int comb, const Params& p, const Graph& heavy,
                             cudaStream_t st) {
  if (comb == COMB_MIN) return launch_delta_t<MSG, COMB_MIN>(p, heavy, st);
  return launch_delta_t<MSG, COMB_MAX>(p, heavy, st);
}

// The Params of one launch over n nodes, the workspace
// carved by its layout; zeroes the control words.
cudaError_t make_params(Params& p, const int32_t* row_ptr, const int32_t* col,
                        const int32_t* wt, int32_t n, int32_t e,
                        const int32_t* aux, const int32_t* dist0,
                        const uint8_t* mask0, int kernel, int max_iterations,
                        int mdt, int switch_threshold, int small_frontier,
                        float imbalance_threshold, int hp_edges_threshold,
                        int tail_width, int32_t* dist, void* workspace,
                        long long workspace_bytes, long long* result,
                        cudaStream_t st) {
  int64_t grid = 0;
  cudaError_t err = max_grid(&grid);
  if (err != cudaSuccess) return err;
  const Layout l = layout(n, grid);
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
  p.kernel = kernel;
  p.max_iterations = max_iterations;
  p.mdt = mdt;
  p.switch_threshold = switch_threshold;
  p.small_frontier = small_frontier;
  p.hp_edges_threshold = hp_edges_threshold;
  p.imbalance_threshold = imbalance_threshold;
  p.tail_width = tail_width;
  p.val[0] = dist;
  p.val[1] = reinterpret_cast<int32_t*>(ws + l.B);
  p.stamp = reinterpret_cast<int32_t*>(ws + l.stamp);
  p.dirty[0] = reinterpret_cast<int32_t*>(ws + l.dirty0);
  p.dirty[1] = reinterpret_cast<int32_t*>(ws + l.dirty1);
  p.tail = reinterpret_cast<int32_t*>(ws + l.tail);
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

// Bytes of workspace a traversal of n nodes needs on the current card.
int repro_fused_workspace_bytes(int32_t n, long long* bytes) {
  int64_t grid = 0;
  const cudaError_t err = max_grid(&grid);
  if (err != cudaSuccess) return (int)err;
  if (n < 1) return (int)cudaErrorInvalidValue;
  *bytes = (long long)layout(n, grid).total;
  return 0;
}

// One traversal: n >= 1, e >= 0; wt == nullptr means weight 1; aux holds
// EP's edge sources [e] or NS's child -> parent map [n] (else unused);
// dist0 [n] and mask0 [n] are read, dist [n] receives the result; result
// [RESULT_CELLS] (int64) gets iterations, edges relaxed and AD's BS/WD/HP
// counts, then the grid-wide chunks, the block-local chunks and the grid
// barriers.
// coeffs (host memory, 9 floats, row-major (a, b, c) for BS, WD, HP) makes
// AD take the measured model; nullptr keeps the fixed tree.  tail_width
// (0..TAIL_MAX) is the most live slots of a BS/NS column run inside one
// block (0: none).  workspace holds repro_fused_workspace_bytes(n) bytes.
// Returns the status of the launch (cudaErrorCooperativeLaunchTooLarge
// if the grid cannot be resident).
int repro_fused_fixed_point(
    const int32_t* row_ptr, const int32_t* col, const int32_t* wt,
    int32_t n, int32_t e, const int32_t* aux, const int32_t* dist0,
    const uint8_t* mask0, int kernel, int msg, int comb, int max_iterations,
    int mdt, int switch_threshold, int small_frontier,
    float imbalance_threshold, int hp_edges_threshold, int tail_width,
    const float* coeffs, int32_t* dist, void* workspace,
    long long workspace_bytes, long long* result, void* stream) {
  if (!codes_ok(msg, comb) || kernel < K_BS || kernel > K_AD || n < 1 ||
      e < 0 || mdt < 1 || dist == dist0 || tail_width < 0 ||
      tail_width > TAIL_MAX ||
      ((kernel == K_EP || kernel == K_NS) && aux == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Params p;
  cudaError_t err = make_params(
      p, row_ptr, col, wt, n, e, aux, dist0, mask0, kernel, max_iterations, mdt, switch_threshold, small_frontier,
      imbalance_threshold, hp_edges_threshold, tail_width, dist, workspace,
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
// frontier; result [RESULT_CELLS] (int64) gets epochs, edges relaxed,
// relax rounds, the last bucket settled and the frontier's count, then the
// chunk and barrier counts as repro_fused_fixed_point's.  tail_width as
// there.  workspace holds repro_fused_workspace_bytes(n) bytes.
int repro_fused_delta(
    const int32_t* row_ptr, const int32_t* col, const int32_t* wt, int32_t e,
    const int32_t* hrow_ptr, const int32_t* hcol, const int32_t* hwt,
    int32_t he, int32_t n, const int32_t* aux, const int32_t* dist0,
    const uint8_t* mask0, int kernel, int msg, int comb, int delta,
    int max_epochs, int mdt, int switch_threshold, int small_frontier,
    float imbalance_threshold, int hp_edges_threshold, int tail_width,
    int32_t* dist, uint8_t* mask, void* workspace, long long workspace_bytes,
    long long* result, void* stream) {
  if (!codes_ok(msg, comb) || comb == COMB_ADD || kernel < K_BS ||
      kernel > K_AD || kernel == K_EP || n < 1 || e < 0 || he < 0 ||
      tail_width < 0 || tail_width > TAIL_MAX ||
      (he > 0 && hrow_ptr == nullptr) || delta < 1 || mdt < 1 ||
      dist == dist0 || (kernel == K_NS && aux == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Params p;
  cudaError_t err = make_params(
      p, row_ptr, col, wt, n, e, aux, dist0, mask0, kernel, max_epochs,
      mdt, switch_threshold, small_frontier, imbalance_threshold,
      hp_edges_threshold, tail_width, dist, workspace, workspace_bytes,
      result, st);
  if (err != cudaSuccess) return (int)err;
  p.delta = delta;
  p.live = mask;
  const Graph heavy = he > 0 ? Graph{hrow_ptr, hcol, hwt, he}
                             : Graph{nullptr, nullptr, nullptr, 0};
  if (msg == MSG_SUM) err = launch_delta_msg<MSG_SUM>(comb, p, heavy, st);
  else if (msg == MSG_COPY)
    err = launch_delta_msg<MSG_COPY>(comb, p, heavy, st);
  else err = launch_delta_msg<MSG_BOTTLENECK>(comb, p, heavy, st);
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

// k grid barriers by a cooperative grid the size of the fused kernel's
// (shortest_path's instance); bar: two zeroed words (the barrier and its
// count).
int repro_fused_barrier_probe(int k, unsigned* bar, void* stream) {
  if (k < 0 || bar == nullptr) return (int)cudaErrorInvalidValue;
  void* args[] = {&bar, &k};
  const cudaError_t err = launch_coop(
      (const void*)barrier_probe_kernel, args, (cudaStream_t)stream,
      (const void*)fused_fixed_point_kernel<MSG_SUM, COMB_MIN>);
  if (err != cudaSuccess) return (int)err;
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
