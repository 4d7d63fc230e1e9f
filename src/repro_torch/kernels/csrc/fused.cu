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
// no lane of the chunk writes and fold improving candidates with atomics
// (relax_lanes.cuh fold: int32, or a float32 build's sign split) into the
// other of two value buffers; an improving lane notes its
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
// degree >= D, and is taken when it has at least tail_min_columns columns
// (a launch argument: kernels/fused.py TAIL_MIN_COLUMNS holds the value).
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
// copy of the steps.  A round's work follows its bucket, not N: the far
// set M, the settled set S, the round's frontier C and the last phase's
// improvements U are lists.  An epoch passes twice over M's list (the
// minimum live bucket b, then C = the nodes of b out of M into S); a
// round relaxes C with the strategy's step and notes what it improves in
// U; its filter takes the nodes of U in b as the next round's C (their
// slot tables written as they are appended: no pass of their own) and
// puts the rest into M, until C is empty; the heavy pass relaxes S's
// heavy edges and its filter puts U into M.  The next C is exactly U's
// nodes in b: a node of M that U does not hold kept its value, so its
// bucket.  The order of a frontier's slots changes no bits (a chunk's
// lanes read a snapshot and fold with atomics).  A stage runs in block 0
// alone, with __syncthreads for grid barriers, while it is narrow (an
// epoch over at most tail_width list entries; a round or heavy pass of at
// most tail_width nodes and narrow_edges edges, not NS), and on the grid
// otherwise; the choice comes from cells every block reads after a
// barrier.  NS keeps its rounds grid-wide and widens C (or S) to the
// children of its nodes from a list too, mirroring only the children of
// the last phase's U.  Rounds count the light rounds and a heavy pass
// with edges, split between the grid and one block as
// core/fused.py delta_round_split has it; the loop caps epochs at
// max_iterations.  One launch capped at one epoch is the stepped
// driver's epoch; it returns M, the bucket settled and the frontier's
// count beside the values.  The delta kernel is built for 2 blocks a SM
// (DELTA_MIN_BLOCKS, 128 registers), the fused fixed point for 3.
//
// Every launch's result ends with three counts: the fused fixed point's
// grid-wide chunks, block-local chunks and grid barriers; the delta
// mode's grid-wide rounds, narrow rounds and grid barriers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "attrs.cuh"
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
// delta mode: the stage state block 0 hands the grid after a narrow
// stretch (DeltaState, 4 words, 2 spare); the two M lists' lengths; by
// the parity of the phase that reads it, C as one 64-bit cell (low word:
// its light edges, high word: its slots; c_cell); by the parity of the
// epoch, S's length and then its heavy degree sum, and the live count and
// then NO_BUCKET - the minimum bucket; the U lists' lengths by phase % 3;
// by phase parity, C's largest light degree
constexpr int CTRL_STATE = CTRL_HIST + 2 * HIST_WORDS;
constexpr int CTRL_MCOUNT = CTRL_STATE + 6;
constexpr int CTRL_C = CTRL_STATE + 8;
constexpr int CTRL_SCOUNT = CTRL_STATE + 12;
constexpr int CTRL_LIVE = CTRL_STATE + 16;
constexpr int CTRL_UCOUNT = CTRL_STATE + 20;
constexpr int CTRL_CMAX = CTRL_STATE + 24;
// NS: by phase parity, the children a phase's frontier widens to, their
// edges and their largest degree
constexpr int CTRL_EXT = CTRL_STATE + 26;
constexpr int CTRL_WORDS = CTRL_STATE + 32;
static_assert(CTRL_C % 2 == 0, "C's cells are 64-bit");
static_assert(HIST_WORDS <= THREADS, "a block zeroes a histogram at once");
// the most slots a one-block BS/NS tail takes, 4 a thread; B1's staged
// slot slice holds their tables in shared memory
constexpr int TAIL_MAX = B1_TILE;
constexpr int TAIL_LANES = TAIL_MAX / THREADS;
// lanes a thread of the tail loads before it folds
constexpr int TAIL_GROUP = 2;
// int64 cells of a launch's result
constexpr int RESULT_CELLS = 8;
// resident blocks a SM the fused fixed point is built for (at most 80
// registers a thread, which it fits with no spill): more blocks hide more
// of each lane's dependent gathers
constexpr int MIN_BLOCKS = 3;
// the delta kernel's: its stage loop holds more state (128 registers, no
// spill), and at 3 blocks a SM it spilled and ran slower on road1024's
// WD runs (PERF.md)
constexpr int DELTA_MIN_BLOCKS = 2;

struct Params {
  const int32_t* row_ptr;
  const int32_t* col;
  const int32_t* wt;         // null: weight 1
  const int32_t* aux;        // EP: edge sources [e]; NS: child -> parent [n]
  const Val* dist0;
  const uint8_t* mask0;
  int32_t n, e;
  int kernel, max_iterations, mdt, switch_threshold, small_frontier,
      hp_edges_threshold;
  float imbalance_threshold;
  int measured;              // AD: 1 takes the cost model's argmin
  float coeffs[9];           // AD's [3, 3] cost model: (a, b, c) per kernel
  int32_t delta;             // delta mode: the bucket width
  int32_t tail_width;        // most live slots of a one-block BS column
  int32_t tail_min_columns;  // fewest columns a one-block BS tail takes
  int32_t narrow_edges;      // delta mode: most edges of a narrow phase
  Val* val[2];               // the two value buffers; val[0] is the result
  int32_t* stamp;            // [n] the chunk that last noted a destination
  int32_t* dirty[2];         // [n] destinations noted, by chunk parity
  int32_t* list;             // [n] the frontier's nodes, ascending
  int32_t* deg;              // [n] their degrees
  int32_t* pfx;              // [n] inclusive prefix of the merge-path work
  int32_t* exc;              // [n] exclusive prefix
  int32_t* start;            // [n] first edge of a slot's (remaining) run
  int32_t* tail;             // [TAIL_MAX] slots of a one-block BS tail
  uint8_t* mask[2];          // frontier masks of alternate iterations
                             // (delta mode: mask[1] takes the lanes'
                             // update bytes, unread)
  // delta mode only (layout(delta = true)); the far set M is `live` (the
  // output mask) and its lists; an M list keeps stale entries of nodes
  // that left M, and `listed` marks the nodes it holds an entry of.  The
  // chunk notes (stamp, dirty) are not used there: NS keeps each node's
  // children, [dirty[0][v], dirty[1][v]), in the dirty lists instead, and
  // in stamp the phase whose C holds the node
  uint8_t* live;             // M, exact
  uint8_t* listed;           // [n] an M list entry exists
  uint8_t* settled;          // S, the nodes settled this epoch
  int32_t* mlist[2];         // [n] the M lists, one an epoch in turn
  int32_t* slist;            // [n] S as a list
  int32_t* ulist[2];         // U: the nodes a phase improved, by phase
                             // parity (NS mirrors the last phase's)
  int32_t* ustamp;           // [n] the phase that last listed a node in U
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
// Three bits of state share one word (each thread of the grid holds it):
// which buffer holds the latest values, whether the last chunk's noted
// entries are still to be folded into the other one (min, max), and the
// parity of the frontier compactions (which picks a compaction's
// histogram and tail count); the delta mode keeps two more things in
// bits 3-5 (DeltaState).  The chunk number is a stamp in int32: it
// wraps after 2^31 chunks, over half an hour of one launch at the
// fastest chunk's ~1 µs.
struct Chunking {
  int seq = 0;               // chunks begun (the next's stamp)
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

// Append d to list (count: its length); the lanes of a warp that append
// together take their slots with one atomic (opportunistic warp
// aggregation: one counter for the grid would otherwise take an atomic
// from every lane).
__device__ __forceinline__ void warp_push(unsigned* count, int32_t* list,
                                          int32_t d) {
  const unsigned active = __activemask();
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(active) - 1;
  unsigned base = 0;
  if (lane == leader) base = atomicAdd(count, (unsigned)__popc(active));
  base = __shfl_sync(active, base, leader);
  list[base + __popc(active & ((1u << lane) - 1u))] = d;
}

// An improving lane notes its destination: into `list` (its length in
// `count`), once for each `tag` (a stamp a node, where `once`).  The fused
// fixed point notes each chunk's destinations (the tag is the chunk's
// number); the delta mode notes a phase's, its U list (the tag is the
// phase's number; a narrow phase lists every lane and its filter drops
// the repeats).
struct NoteHook {
  int32_t* stamp;
  int32_t* list;
  unsigned* count;
  int32_t tag;
  bool once;
  __device__ __forceinline__ void operator()(int32_t d) const {
    if (once && atomicExch(stamp + d, tag) == tag) return;
    warp_push(count, list, d);
  }
};

// Where the steps below run.  The fused fixed point runs them on the
// whole grid (GridScope: every choice folds at compile time).  The delta
// mode runs a stage on the grid or, when it is narrow, in block 0 alone
// (DeltaScope, below), and notes the nodes a phase improves instead of a
// chunk's (hook()).  Block 0 takes part in both, so "block 0, thread 0"
// is one thread of either scope.
__device__ __forceinline__ unsigned* chunk_slot(const Params& p, int seq) {
  return p.ctrl + CTRL_SLOTS + 2 * (seq % 3);
}

struct GridScope {
  static constexpr bool kPhase = false;   // notes go to the chunk's list
  __device__ bool one() const { return false; }
  // chunk ch.seq's note
  __device__ NoteHook hook(const Params& p, const Chunking& ch) const {
    return NoteHook{p.stamp, p.dirty[ch.seq & 1], chunk_slot(p, ch.seq),
                    ch.seq, true};
  }
  // what the last chunk noted: its slot's count and its list
  __device__ void last_noted(const Params& p, const Chunking& ch,
                             unsigned& n, const int32_t*& list) const {
    n = __ldcg(chunk_slot(p, ch.seq - 1));
    list = p.dirty[(ch.seq - 1) & 1];
  }
};

template <class Sc>
__device__ __forceinline__ int64_t s_tid(const Sc& sc) {
  return sc.one() ? (int64_t)threadIdx.x : gtid();
}

template <class Sc>
__device__ __forceinline__ int64_t s_threads(const Sc& sc) {
  return sc.one() ? (int64_t)THREADS : gthreads();
}

template <class Sc>
__device__ __forceinline__ int s_blk(const Sc& sc) {
  return sc.one() ? 0 : (int)blockIdx.x;
}

template <class Sc>
__device__ __forceinline__ int s_nblk(const Sc& sc) {
  return sc.one() ? 1 : (int)gridDim.x;
}

// a grid barrier, or __syncthreads (which orders the block's global
// writes for its own threads) in one block
template <class Sc>
__device__ __forceinline__ void s_sync(const Sc& sc, unsigned* ctrl) {
  if (sc.one()) __syncthreads();
  else grid_sync(ctrl + CTRL_BAR);
}

// Append v where take; every lane of the warp calls it.
__device__ __forceinline__ void warp_take(unsigned* count, int32_t* list,
                                          bool take, int32_t v) {
  const unsigned mask = __ballot_sync(FULL, take);
  if (!mask) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(mask) - 1;
  unsigned base = 0;
  if (lane == leader) base = atomicAdd(count, (unsigned)__popc(mask));
  base = __shfl_sync(FULL, base, leader);
  if (take) list[base + __popc(mask & ((1u << lane) - 1u))] = v;
}

// a, b summed and c maximised over the block; every thread gets them
// c's maximum is taken as unsigned: the delta mode's bucket key
// (epoch_stage) lies above 2^31 for a negative bucket; every other
// caller's c is non-negative, where the two orders agree.
__device__ __forceinline__ void block_reduce3(int32_t& a, int32_t& b,
                                              int32_t& c) {
  __shared__ int32_t r[3][WARPS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    a += __shfl_xor_sync(FULL, a, o);
    b += __shfl_xor_sync(FULL, b, o);
    c = (int32_t)max((unsigned)c, (unsigned)__shfl_xor_sync(FULL, c, o));
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
    c = (int32_t)max((unsigned)c, (unsigned)r[2][i]);
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

// this block's contiguous segment [lo, hi) of m items in the scope
template <class Sc = GridScope>
__device__ __forceinline__ void segment(int32_t m, int32_t& lo, int32_t& hi,
                                        const Sc& sc = Sc{}) {
  const int nb = s_nblk(sc);
  const int64_t per = ((int64_t)m + nb - 1) / nb;
  const int64_t l = per * s_blk(sc);
  lo = (int32_t)(l < m ? l : m);
  hi = (int32_t)(l + per < m ? l + per : m);
}

// After the sync that follows the scope's blocks' writes of btot: the
// totals of its three columns (sum, sum, max) and the sums of the first
// two over the blocks before this one.
template <class Sc = GridScope>
__device__ __forceinline__ void scan_totals(const int32_t* btot, int32_t& t0,
                                            int32_t& t1, int32_t& t2,
                                            int32_t& p0, int32_t& p1,
                                            const Sc& sc = Sc{}) {
  t0 = t1 = t2 = p0 = p1 = 0;
  for (int i = threadIdx.x; i < s_nblk(sc); i += THREADS) {
    const int32_t x = __ldcg(btot + 4 * i), y = __ldcg(btot + 4 * i + 1);
    t0 += x;
    t1 += y;
    t2 = max(t2, __ldcg(btot + 4 * i + 2));
    if (i < s_blk(sc)) {
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
// total (ends in a sync of the scope).
template <class Sc>
__device__ int64_t tail_tables(const Params& p, int32_t count, int32_t c,
                               const Sc& sc) {
  int32_t lo, hi;
  segment(count, lo, hi, sc);
  int32_t sum = 0, unused0 = 0, unused1 = 0;
  for (int32_t i = lo + threadIdx.x; i < hi; i += THREADS)
    sum += max(__ldcg(p.deg + i) - c, 0);
  block_reduce3(sum, unused0, unused1);
  if (threadIdx.x == 0) {
    p.btot[4 * blockIdx.x] = sum;
    p.btot[4 * blockIdx.x + 1] = 0;
    p.btot[4 * blockIdx.x + 2] = 0;
  }
  s_sync(sc, p.ctrl);
  int32_t total, t1, t2, off, p1;
  scan_totals(p.btot, total, t1, t2, off, p1, sc);
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
  s_sync(sc, p.ctrl);
  return total;
}

// A one-block tail's lanes note only in delta mode (the fused fixed
// point's tail folds its own improvements)
template <class Sc>
struct PhaseNote {
  NoteHook h;
  __device__ __forceinline__ void operator()(int32_t d) const {
    if (Sc::kPhase) h(d);
  }
};

// A chunk: the snapshot its lanes read, the buffer they fold into, the
// note of an improving lane, the scope and the chunk's control slot.
template <class Sc>
struct Chunk {
  const Val* snap;
  Val* tgt;
  NoteHook note;
  Sc sc;
  unsigned* slot;
};

// Chunk seq notes into slot seq % 3 and list seq % 2, and clears the slot
// of chunk seq + 1 (last read in chunk seq - 1, a sync ago).  After a
// chunk of a min or max, its noted entries are folded into this chunk's
// target, with the lanes' own folds.
template <int COMB, class Sc>
__device__ Chunk<Sc> begin_chunk(const Params& p, const Chunking& ch,
                                 const Sc& sc) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned* next = chunk_slot(p, ch.seq + 1);
    next[0] = 0;
    next[1] = 0;
  }
  const Val* snap = p.val[ch.cur()];
  Val* tgt = p.val[ch.cur() ^ 1];
  if (ch.pending()) {
    unsigned noted;
    const int32_t* dirty;
    sc.last_noted(p, ch, noted, dirty);
    for (int64_t k = s_tid(sc); k < noted; k += s_threads(sc)) {
      const int32_t d = __ldcg(dirty + k);
      fold<COMB>(tgt + d, __ldcg(snap + d));
    }
  }
  return Chunk<Sc>{snap, tgt, sc.hook(p, ch), sc, chunk_slot(p, ch.seq)};
}

// Wait for every fold of the chunk.  min, max: the target holds the
// latest values and the buffers swap roles.  add: copy the noted entries
// of val[1] into val[0] and wait again.  Returns the chunk's HP live
// count.
template <int COMB, class Sc>
__device__ unsigned end_chunk(const Params& p, Chunking& ch, const Sc& sc) {
  const unsigned* slot = chunk_slot(p, ch.seq);
  s_sync(sc, p.ctrl);
  const unsigned live = __ldcg(slot + 1);
  if (COMB == COMB_ADD) {
    const unsigned noted = __ldcg(slot);
    const int32_t* dirty = p.dirty[ch.seq & 1];
    for (int64_t k = s_tid(sc); k < noted; k += s_threads(sc)) {
      const int32_t d = __ldcg(dirty + k);
      p.val[0][d] = __ldcg(p.val[1] + d);
    }
    s_sync(sc, p.ctrl);
  } else {
    ch.swap();
  }
  ++ch.seq;
  return live;
}

// Copy the last chunk's noted entries into the other buffer (plain
// stores: nothing else writes it now), so that both hold the latest
// values once the caller's sync, or the launch's end, has passed.
template <class Sc>
__device__ void settle(const Params& p, Chunking& ch, const Sc& sc) {
  if (!ch.pending()) return;
  unsigned noted;
  const int32_t* dirty;
  sc.last_noted(p, ch, noted, dirty);
  const Val* from = p.val[ch.cur()];
  Val* to = p.val[ch.cur() ^ 1];
  for (int64_t k = s_tid(sc); k < noted; k += s_threads(sc)) {
    const int32_t d = __ldcg(dirty + k);
    to[d] = __ldcg(from + d);
  }
  ch.settled();
}

template <int MSG, int COMB, class Sc>
__device__ __forceinline__ void relax_one(const Params& p, const Graph& gr,
                                          const Chunk<Sc>& c, bool valid,
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

// BS/NS column d over the scope: the d-th edge of every frontier slot
template <int MSG, int COMB, class Sc>
__device__ void bs_column(const Params& p, const Graph& gr,
                          const Chunk<Sc>& c, int32_t count, int32_t d,
                          uint8_t* upd) {
  const Sc& sc = c.sc;
  for (int64_t i = s_tid(sc); i < count; i += s_threads(sc)) {
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
template <int MSG, int COMB, class Sc>
__device__ void hp_tile(const Params& p, const Graph& gr,
                        const Chunk<Sc>& ck, int32_t count, int32_t c,
                        uint8_t* upd) {
  const Sc& sc = ck.sc;
  const int lane = threadIdx.x & 31;
  const int64_t warp = s_tid(sc) >> 5, nwarps = s_threads(sc) >> 5;
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
    atomicAdd(ck.slot + 1, (unsigned)live);
}

// EP: every edge a lane, valid where its source is in the frontier
template <int MSG, int COMB>
__device__ void ep_edges(const Params& p, const Chunk<GridScope>& c,
                         const uint8_t* M, uint8_t* upd) {
  for (int64_t k = gtid(); k < p.e; k += gthreads()) {
    const int32_t src = clamp_index(__ldg(p.aux + k), p.n);
    relax_one<MSG, COMB>(p, graph_of(p), c, __ldcg(M + src) != 0, src,
                         (int32_t)k, upd);
  }
}

// WD, and HP's tail: B1's merge-path tiles over `total` lanes
template <int MSG, int COMB, class Sc>
__device__ void merge_path(const Params& p, const Graph& gr,
                           const Chunk<Sc>& c, int32_t count, int64_t total,
                           uint8_t* upd, WdSmem& sm) {
  const Sc& sc = c.sc;
  const int64_t tiles = (total + B1_TILE - 1) / B1_TILE;
  for (int64_t t = s_blk(sc); t < tiles; t += s_nblk(sc))
    wd_tile<MSG, COMB, Coherent>(t, c.snap, p.n, p.pfx, p.exc, p.start,
                                 p.list, count, gr.col, gr.wt, gr.e,
                                 (int32_t)total, total, c.tgt, upd, nullptr,
                                 sm, c.note);
}

// WD over a narrow frontier (block 0 alone, at most TAIL_MAX slots): its
// slot tables staged in shared memory once (thread t takes slots
// [TAIL_LANES t, TAIL_LANES (t + 1)), all loads in flight together), then
// B1's lanes, each ranked by a search of the staged prefix, with no
// global search or staging a tile.
template <int MSG, int COMB, class Sc>
__device__ void narrow_merge_path(const Params& p, const Graph& gr,
                                  const Chunk<Sc>& c, int32_t count,
                                  int64_t total, uint8_t* upd, WdSmem& sm) {
  constexpr int L = B1_LANES;
  {
    const int32_t i0 = threadIdx.x * TAIL_LANES;
    int32_t a[TAIL_LANES], b[TAIL_LANES], x[TAIL_LANES], y[TAIL_LANES];
#pragma unroll
    for (int j = 0; j < TAIL_LANES; ++j) {
      if (i0 + j < count) {
        a[j] = __ldcg(p.list + i0 + j);
        b[j] = __ldcg(p.start + i0 + j);
        x[j] = __ldcg(p.pfx + i0 + j);
        y[j] = __ldcg(p.exc + i0 + j);
      }
    }
#pragma unroll
    for (int j = 0; j < TAIL_LANES; ++j) {
      if (i0 + j < count) {
        sm.src[i0 + j] = a[j];
        sm.start[i0 + j] = b[j];
        sm.prefix[i0 + j] = x[j];
        sm.excl[i0 + j] = y[j];
      }
    }
  }
  __syncthreads();
  for (int64_t k0 = 0; k0 < total; k0 += B1_TILE) {
    bool v[L], imp[L];
    int32_t s[L] = {}, d[L] = {}, w[L] = {};
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int64_t k = k0 + j * THREADS + threadIdx.x;
      v[j] = k < total;
      if (!v[j]) continue;
      const int32_t i = smem_upper_bound(sm.prefix, count - 1, (int32_t)k);
      s[j] = sm.src[i];
      const int32_t ec =
          clamp_index((int64_t)sm.start[i] + (k - sm.excl[i]), gr.e);
      d[j] = __ldg(gr.col + ec);
      w[j] = gr.wt ? __ldg(gr.wt + ec) : 1;
    }
    relax_group<L, MSG, COMB, Coherent>(c.snap, p.n, v, s, d, w, c.tgt, upd,
                                        imp, c.note);
  }
}

template <int MSG, int COMB, class Sc>
__device__ void wd_step(const Params& p, const Graph& gr, const Frontier& f,
                        uint8_t* upd, Chunking& ch, WdSmem& sm,
                        const Sc& sc) {
  const Chunk<Sc> c = begin_chunk<COMB>(p, ch, sc);
  if (sc.one()) narrow_merge_path<MSG, COMB>(p, gr, c, f.count, f.degsum,
                                             upd, sm);
  else merge_path<MSG, COMB>(p, gr, c, f.count, f.degsum, upd, sm);
  end_chunk<COMB>(p, ch, sc);
}

// HP: WD for a small frontier; else MDT-wide tiles while more than
// switch_threshold slots have edges left (at least one tile), then the
// cursor-aware WD tail
template <int MSG, int COMB, class Sc>
__device__ void hp_step(const Params& p, const Graph& gr, const Frontier& f,
                        uint8_t* upd, Chunking& ch, WdSmem& sm,
                        const Sc& sc) {
  if (f.count <= p.switch_threshold) {
    wd_step<MSG, COMB>(p, gr, f, upd, ch, sm, sc);
    return;
  }
  int32_t c = 0;
  unsigned live;
  do {
    const Chunk<Sc> ck = begin_chunk<COMB>(p, ch, sc);
    hp_tile<MSG, COMB>(p, gr, ck, f.count, c, upd);
    live = end_chunk<COMB>(p, ch, sc);
    c += p.mdt;
  } while ((int64_t)live > p.switch_threshold);
  const int64_t total = tail_tables(p, f.count, c, sc);
  if (total > 0) {                      // an empty tail relaxes nothing
    const Chunk<Sc> ck = begin_chunk<COMB>(p, ch, sc);
    merge_path<MSG, COMB>(p, gr, ck, f.count, total, upd, sm);
    end_chunk<COMB>(p, ch, sc);
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
template <class Sc>
__device__ void gather_tail(const Params& p, int32_t count, int32_t d0,
                            int par, const Sc& sc) {
  int32_t lo, hi;
  segment(count, lo, hi, sc);
  for (int32_t i0 = lo; i0 < hi; i0 += THREADS) {
    const int32_t i = i0 + threadIdx.x;
    warp_take(p.ctrl + CTRL_TAIL + par, p.tail,
              i < hi && __ldcg(p.deg + i) > d0, i);
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
template <int MSG, int COMB, class Sc>
__device__ void tail_columns(const Params& p, const Graph& gr, int32_t d0,
                             int32_t d1, int32_t m, int cur, uint8_t* upd,
                             WdSmem& sm, const NoteHook& note) {
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
    const Val* snap = p.val[cur];
    Val* tgt = p.val[cur ^ 1];
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
      relax_group<TAIL_GROUP, MSG, COMB, Coherent>(
          snap, p.n, v, s, c, w, tgt, upd, imp, PhaseNote<Sc>{note});
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

// BS/NS: the frontier's max degree columns, after the frontier's tables
// and their sync.  Columns below the tail's start run over the scope, a
// chunk each; the rest in block 0 (tail_columns), after a sync that
// settles the buffers and publishes the tail's slots, and before the
// closing one.
template <int MSG, int COMB, class Sc>
__device__ void bs_step(const Params& p, const Graph& gr, const Frontier& f,
                        uint8_t* upd, Chunking& ch, WdSmem& sm,
                        const Sc& sc) {
  const int par = ch.last_compaction();
  int32_t d0 = min(tail_start(p, par, f.count), f.maxdeg);
  if (f.maxdeg - d0 < p.tail_min_columns) d0 = f.maxdeg;
  if (d0 < f.maxdeg) gather_tail(p, f.count, d0, par, sc);
  for (int32_t d = 0; d < d0; ++d) {
    const Chunk<Sc> c = begin_chunk<COMB>(p, ch, sc);
    bs_column<MSG, COMB>(p, gr, c, f.count, d, upd);
    end_chunk<COMB>(p, ch, sc);
  }
  if (d0 == f.maxdeg) return;
  settle(p, ch, sc);
  s_sync(sc, p.ctrl);
  if (blockIdx.x == 0)
    tail_columns<MSG, COMB, Sc>(p, gr, d0, f.maxdeg,
                                (int32_t)__ldcg(p.ctrl + CTRL_TAIL + par),
                                ch.cur(), upd, sm, sc.hook(p, ch));
  if (blockIdx.x == 0 && threadIdx.x == 0)
    p.ctrl[CTRL_NBLOCK] += f.maxdeg - d0;
  s_sync(sc, p.ctrl);
}

// NS's ns_activate: children take their parent's value and activity
// (parents map to themselves and are not written); both buffers, so a
// pending fold finds the child equal in both
__device__ __forceinline__ void ns_gather(const Params& p,
                                          const Chunking& ch, uint8_t* M) {
  for (int64_t i = gtid(); i < p.n; i += gthreads()) {
    const int32_t par = __ldg(p.aux + i);
    if (par != i) {
      const Val v = __ldcg(p.val[ch.cur()] + par);
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
    const Val v = __ldg(p.dist0 + i);
    p.val[0][i] = v;
    p.val[1][i] = v;
    p.stamp[i] = -1;
    p.mask[0][i] = __ldg(p.mask0 + i) != 0;
  }
  grid_sync(p.ctrl + CTRL_BAR);

  const Graph gr = graph_of(p);
  const GridScope grid{};
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
      bs_step<MSG, COMB>(p, gr, f, next, ch, sm, grid);
    } else if (which == K_WD) {
      wd_step<MSG, COMB>(p, gr, f, next, ch, sm, grid);
    } else if (which == K_HP) {
      hp_step<MSG, COMB>(p, gr, f, next, ch, sm, grid);
    } else {
      const Chunk<GridScope> c = begin_chunk<COMB>(p, ch, grid);
      ep_edges<MSG, COMB>(p, c, M, next);
      end_chunk<COMB>(p, ch, grid);
    }
    // BS, WD, HP, NS: the frontier's degree sum; EP: its valid edge lanes,
    // the same number
    edges += (unsigned)f.degsum;
    ++it;
    cur ^= 1;
  }
  settle(p, ch, grid);                  // the result lies in val[0]
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
// delta mode: bucket epochs over node lists, each stage on the grid or in
// one block
// ---------------------------------------------------------------------------

constexpr int32_t NO_BUCKET = 2147483647;     // core/worklist.py NO_BUCKET
// how long block 0 runs narrow stages alone before the grid meets again
// (~0.5 s at 2 GHz; one stage takes microseconds to milliseconds): the
// other blocks wait at one barrier meanwhile, and must never near its
// BARRIER_TIMEOUT
constexpr long long NARROW_CYCLES = 1LL << 30;
// a stage: an epoch's passes over M, a light round, the heavy pass; done
constexpr unsigned ST_EPOCH = 0, ST_ROUND = 1, ST_HEAVY = 2, ST_DONE = 3;

// A delta stage's scope: the grid, or block 0 alone.  A phase's improved
// nodes go into U, and U is the only note.  A grid-wide phase lists a
// node once (a stamp of the phase's number q a node: int32, 2^31 phases
// of at least a microsecond each before it wraps).  A narrow phase lists
// every improving lane (at most narrow_edges of them, which U has room
// for) and its filter drops the repeats with the same stamp, where that
// atomic overlaps the filter's other loads instead of ending a tile's
// chain.  A chunk folds into its target everything the phase has noted
// so far, a superset of the last chunk's notes (the fold of a
// snapshot's value is idempotent for any node).  An entry a lane of this
// chunk appends while the fold reads the count may not be written yet:
// it then holds an older node id (the list is initialised), whose fold
// is as harmless.  The filter leaves both buffers equal after a phase.
struct DeltaScope {
  static constexpr bool kPhase = true;
  bool alone;
  int32_t q;
  __device__ bool one() const { return alone; }
  __device__ unsigned* ucount(const Params& p) const {
    return p.ctrl + CTRL_UCOUNT + q % 3;
  }
  __device__ NoteHook hook(const Params& p, const Chunking&) const {
    return NoteHook{p.ustamp, p.ulist[q & 1], ucount(p), q, !alone};
  }
  __device__ void last_noted(const Params& p, const Chunking&, unsigned& n,
                             const int32_t*& list) const {
    n = __ldcg(ucount(p));
    list = p.ulist[q & 1];
  }
};

// What every block holds of a delta launch: the chunk sequence, the phase
// and epoch counts, and, in the chunking word's spare bits, the next
// stage (bits 3-4) and which M list is live (bit 5).  Block 0 hands it to
// the grid through CTRL_STATE after a narrow stretch.
struct DeltaState {
  Chunking ch;
  int32_t q = 0;             // phases begun
  int32_t it = 0;            // epochs completed
  __device__ unsigned stage() const { return (ch.bits >> 3) & 3u; }
  __device__ void set_stage(unsigned s) {
    ch.bits = (ch.bits & ~(3u << 3)) | (s << 3);
  }
  __device__ unsigned msel() const { return (ch.bits >> 5) & 1u; }
  __device__ void flip_msel() { ch.bits ^= 1u << 5; }
  __device__ void store(unsigned* c) const {
    c[0] = (unsigned)ch.seq;
    c[1] = ch.bits;
    c[2] = (unsigned)q;
    c[3] = (unsigned)it;
  }
  __device__ void load(const unsigned* c) {
    ch.seq = (int)__ldcg(c);
    ch.bits = __ldcg(c + 1);
    q = (int32_t)__ldcg(c + 2);
    it = (int32_t)__ldcg(c + 3);
  }
};

// C of phase parity par: low word its light edges, high word its slots
__device__ __forceinline__ unsigned long long* c_cell(const Params& p,
                                                      int par) {
  return reinterpret_cast<unsigned long long*>(p.ctrl + CTRL_C) + par;
}

// The lists a filter or an epoch's extraction fills with node v: where c,
// a slot of the next round's frontier of light degree dl and first edge
// sl, whose slot tables (list, deg, start, pfx, exc) are written here, in
// no pass of their own; where s, an entry of S's list; where m, an entry
// of the M list ml.  One 64-bit atomic a warp takes its slots and their
// edge ranges together (high word: slots before, low word: edges
// before), so the prefix ascends with the slot index as merge path's
// search needs; the order of the slots changes no bits.  The three
// lists' atomics are issued together.  Every lane of the warp calls it.
__device__ __forceinline__ void warp_append(const Params& p,
                                            unsigned long long* ccell,
                                            unsigned* scount,
                                            unsigned* mcount, int32_t* ml,
                                            int32_t v, bool c, int32_t dl,
                                            int32_t sl, bool s, bool m) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const unsigned cm = __ballot_sync(FULL, c), sm = __ballot_sync(FULL, s),
                 mm = __ballot_sync(FULL, m);
  if (!(cm | sm | mm)) return;
  int32_t e = c ? dl : 0;               // inclusive scan of the degrees
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(FULL, e, o);
    if (lane >= o) e += y;
  }
  const int32_t te = __shfl_sync(FULL, e, 31);
  unsigned long long cb = 0;
  unsigned sb = 0, mb = 0;
  if (lane == 0) {
    if (cm) cb = atomicAdd(ccell, ((unsigned long long)__popc(cm) << 32) |
                                      (unsigned)te);
    if (sm) sb = atomicAdd(scount, (unsigned)__popc(sm));
    if (mm) mb = atomicAdd(mcount, (unsigned)__popc(mm));
  }
  cb = __shfl_sync(FULL, cb, 0);
  sb = __shfl_sync(FULL, sb, 0);
  mb = __shfl_sync(FULL, mb, 0);
  if (c) {
    const int32_t i = (int32_t)(cb >> 32) + __popc(cm & below);
    const int32_t pf = (int32_t)(unsigned)cb + e;
    p.list[i] = v;
    p.deg[i] = dl;
    p.start[i] = sl;
    p.pfx[i] = pf;
    p.exc[i] = pf - dl;
  }
  if (s) p.slist[sb + __popc(sm & below)] = v;
  if (m) ml[mb + __popc(mm & below)] = v;
}

// Whether the next stage runs in block 0 alone: an epoch whose M list
// has at most tail_width entries; a light round or heavy pass (not NS's,
// which stay grid-wide) of at most tail_width nodes and narrow_edges
// edges (core/fused.py delta_round_split).  Read from cells written
// before the last sync, which no stage rewrites before every block has
// read them.
__device__ __forceinline__ bool stage_narrow(const Params& p,
                                             const DeltaState& st) {
  const int32_t w = p.tail_width;
  if (w <= 0) return false;
  if (st.stage() == ST_EPOCH)
    return __ldcg(p.ctrl + CTRL_MCOUNT + st.msel()) <= (unsigned)w;
  if (p.kernel == K_NS) return false;
  unsigned n, e;
  if (st.stage() == ST_ROUND) {
    const unsigned long long c = __ldcg(c_cell(p, st.q & 1));
    n = (unsigned)(c >> 32);
    e = (unsigned)c;
  } else {
    n = __ldcg(p.ctrl + CTRL_SCOUNT + (st.it & 1));
    e = __ldcg(p.ctrl + CTRL_SCOUNT + 2 + (st.it & 1));
  }
  return n <= (unsigned)w && e <= (unsigned)p.narrow_edges;
}

// The slot tables of a frontier given as a list of `count` nodes (in any
// order: a chunk's lanes read a snapshot and fold with atomics, so the
// order changes no bits), over graph gr.  list_count: the count, degree
// sum and max degree, and the sums before this block's segment (ends in
// a sync of the scope).  list_compact: the tables in the list's order,
// and the histogram of degree bit lengths where `bins` (as
// frontier_compact); the caller syncs before they are read.
__device__ __forceinline__ Frontier list_count(const Params& p,
                                               const DeltaScope& sc,
                                               const Graph& graph,
                                               const int32_t* from,
                                               int32_t count) {
  const Graph gr = graph;
  int32_t lo, hi;
  segment(count, lo, hi, sc);
  int32_t cnt = threadIdx.x == 0 ? hi - lo : 0, sum = 0, mx = 0;
  for (int32_t i = lo + threadIdx.x; i < hi; i += THREADS) {
    const int32_t d = degree(gr, __ldcg(from + i));
    sum += d;
    mx = max(mx, d);
  }
  block_reduce3(cnt, sum, mx);
  if (threadIdx.x == 0) {
    p.btot[4 * blockIdx.x] = cnt;
    p.btot[4 * blockIdx.x + 1] = sum;
    p.btot[4 * blockIdx.x + 2] = mx;
  }
  s_sync(sc, p.ctrl);
  Frontier f;
  scan_totals(p.btot, f.count, f.degsum, f.maxdeg, f.before_count,
              f.before_deg, sc);
  return f;
}

__device__ __forceinline__ void list_compact(const Params& p,
                                             const DeltaScope& sc,
                                             const Graph& graph,
                                             const int32_t* from,
                                             const Frontier& f, Chunking& ch,
                                             bool bins) {
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
  segment(f.count, lo, hi, sc);
  int32_t pd = f.before_deg;
  for (int32_t base = lo; base < hi; base += THREADS) {
    const int32_t i = base + threadIdx.x;
    int32_t v = 0, d = 0;
    if (i < hi) {
      v = __ldcg(from + i);
      d = degree(gr, v);
      if (bins && d) atomicAdd(hist + (32 - __clz(d)), 1);
    }
    int32_t a = d, unused = 0, ta, tb;
    block_scan2(a, unused, ta, tb);
    if (i < hi) {
      p.list[i] = v;
      p.deg[i] = d;
      p.start[i] = __ldg(gr.row_ptr + v);
      p.pfx[i] = pd + a;
      p.exc[i] = pd + a - d;
    }
    pd += ta;
  }
  __syncthreads();
  if (bins && threadIdx.x < 32 && hist[threadIdx.x])
    atomicAdd(p.ctrl + CTRL_HIST + HIST_WORDS * par +
                  32 * (blockIdx.x % HIST_COPIES) + threadIdx.x,
              (unsigned)hist[threadIdx.x]);
}

// The histogram of the degree bit lengths of a frontier built slot by
// slot (BS and AD kernels read it in bs_step's tail_start): bins_begin
// takes the compaction's parity and clears the other parity's cells, as
// list_compact does, and this block's shared bins; bins_end adds them
// into the parity's histogram.
__device__ __forceinline__ int bins_begin(const Params& p, Chunking& ch,
                                          int32_t* bins) {
  const int par = ch.compaction();
  if (threadIdx.x < 32) bins[threadIdx.x] = 0;
  if (blockIdx.x == 0) {
    if (threadIdx.x < HIST_WORDS)
      p.ctrl[CTRL_HIST + HIST_WORDS * (par ^ 1) + threadIdx.x] = 0;
    if (threadIdx.x == 0) p.ctrl[CTRL_TAIL + (par ^ 1)] = 0;
  }
  __syncthreads();
  return par;
}

__device__ __forceinline__ void bins_end(const Params& p, int par,
                                         const int32_t* bins) {
  __syncthreads();
  if (threadIdx.x < 32 && bins[threadIdx.x])
    atomicAdd(p.ctrl + CTRL_HIST + HIST_WORDS * par +
                  32 * (blockIdx.x % HIST_COPIES) + threadIdx.x,
              (unsigned)bins[threadIdx.x]);
}

// An epoch's start (priority._epoch up to its first round), two passes
// over the live M list.  Pass 1 clears the last epoch's S (by its list)
// and finds the live count and the minimum bucket, skipping the stale
// entries; after its sync the stage ends the launch when nothing is live
// or the epochs are spent.  Pass 2 takes the nodes of the minimum bucket
// b out of M into C (the first round's frontier: warp_append writes its
// tables) and S, drops the stale entries, and copies the rest into the
// other M list.  The
// cells this epoch and the next phase fill are cleared here, a sync
// before the first add and a stage after their last read.
template <int COMB>
__device__ __forceinline__ void epoch_stage(const Params& p,
                                            const Graph& heavy,
                                            const Graph& light,
                                            DeltaState& st,
                                            const DeltaScope& sc) {
  unsigned* const ctrl = p.ctrl;
  const int lane = threadIdx.x & 31, ep = st.it & 1, pq = st.q & 1;
  const unsigned nxt = st.msel() ^ 1;
  const Val* vals = p.val[st.ch.cur()];
  const int32_t* ml = p.mlist[st.msel()];
  const int32_t m = (int32_t)__ldcg(ctrl + CTRL_MCOUNT + st.msel());
  const int32_t s_last = (int32_t)__ldcg(ctrl + CTRL_SCOUNT + (ep ^ 1));
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    ctrl[CTRL_MCOUNT + nxt] = 0;
    ctrl[CTRL_SCOUNT + ep] = 0;
    ctrl[CTRL_SCOUNT + 2 + ep] = 0;
    ctrl[CTRL_LIVE + (ep ^ 1)] = 0;
    ctrl[CTRL_LIVE + 2 + (ep ^ 1)] = 0;
  }
  for (int64_t i = s_tid(sc); i < s_last; i += s_threads(sc))
    p.settled[__ldcg(p.slist + i)] = 0;
  int32_t live = 0, unused = 0, top = 0;
  for (int64_t i = s_tid(sc); i < m; i += s_threads(sc)) {
    const int32_t v = __ldcg(ml + i);
    if (__ldcg(p.live + v)) {
      ++live;
      // NO_BUCKET - b in unsigned arithmetic, so that the smallest bucket
      // has the largest key even below 0 (an int16 or int8 rank is -1)
      top = (int32_t)max((unsigned)top,
                         (unsigned)NO_BUCKET -
                             (unsigned)bucket_of<COMB>(__ldcg(vals + v),
                                                       p.delta));
    }
  }
  block_reduce3(live, unused, top);
  if (threadIdx.x == 0 && live) {
    atomicAdd(ctrl + CTRL_LIVE + ep, (unsigned)live);
    atomicMax(ctrl + CTRL_LIVE + 2 + ep, (unsigned)top);
  }
  s_sync(sc, ctrl);
  live = (int32_t)__ldcg(ctrl + CTRL_LIVE + ep);
  if (gtid() == 0) p.result[4] = live;
  if (live == 0 || st.it >= p.max_iterations) {
    st.set_stage(ST_DONE);
    return;
  }
  const int32_t b =
      (int32_t)((unsigned)NO_BUCKET - __ldcg(ctrl + CTRL_LIVE + 2 + ep));
  if (gtid() == 0) p.result[3] = b;
  __shared__ int32_t bins[32];
  const bool binned =
      p.kernel == K_BS || p.kernel == K_AD || p.kernel == K_NS;
  const int par = binned ? bins_begin(p, st.ch, bins) : 0;
  int32_t sdeg = 0, mx = 0;
  unused = 0;
  for (int64_t i0 = s_tid(sc) - lane; i0 < m; i0 += s_threads(sc)) {
    const int64_t i = i0 + lane;
    int32_t v = 0, sl = 0, dl = 0;
    bool take = false, keep = false;
    if (i < m) {
      v = __ldcg(ml + i);
      if (__ldcg(p.live + v)) {
        take = bucket_of<COMB>(__ldcg(vals + v), p.delta) == b;
        keep = !take;
      }
      if (!keep) p.listed[v] = 0;
      if (take) {
        p.live[v] = 0;
        p.settled[v] = 1;
        if (p.kernel == K_NS) p.stamp[v] = st.q;
        sl = __ldg(light.row_ptr + v);
        dl = __ldg(light.row_ptr + v + 1) - sl;
        mx = max(mx, dl);
        if (binned && dl) atomicAdd(bins + (32 - __clz(dl)), 1);
        if (heavy.e) sdeg += degree(heavy, v);
      }
    }
    warp_append(p, c_cell(p, pq), ctrl + CTRL_SCOUNT + ep,
                ctrl + CTRL_MCOUNT + nxt, p.mlist[nxt], v, take, dl, sl,
                take, keep);
  }
  block_reduce3(sdeg, unused, mx);
  if (threadIdx.x == 0) {
    if (sdeg) atomicAdd(ctrl + CTRL_SCOUNT + 2 + ep, (unsigned)sdeg);
    if (mx) atomicMax(ctrl + CTRL_CMAX + pq, (unsigned)mx);
  }
  if (binned) bins_end(p, par, bins);
  s_sync(sc, ctrl);
  st.flip_msel();
  st.set_stage(ST_ROUND);
}

// NS's ns_activate in a delta phase, values: every child takes its
// parent's value, in both buffers.  Children mirror their parents after
// every NS phase that runs, so a phase mirrors only the children of what
// the last phase improved (its U list); the launch's first phase, and
// every phase when the light graph has no edges (its light phases then
// mirror nothing, as priority._phase skips them), mirror every child.  A
// child of M whose value moves is a candidate of the next round as an
// improved node is, so it is noted into U.  Grid-wide; the caller syncs.
// ns_mirror and ns_widen are calls, not inlined: inlined, the delta
// kernel spills past its 128 registers.
__device__ __noinline__ void ns_mirror(const Params& p, const Graph& light,
                                       const DeltaState& st,
                                       const DeltaScope& sc) {
  const Val* cur = p.val[st.ch.cur()];
  const NoteHook note = sc.hook(p, st.ch);
  auto mirror = [&](int32_t c, Val v) {
    const bool moved = val_ne(v, __ldcg(cur + c));
    p.val[0][c] = v;
    p.val[1][c] = v;
    if (moved && __ldcg(p.live + c)) note(c);
  };
  if (st.q == 0 || light.e == 0) {
    for (int64_t i = gtid(); i < p.n; i += gthreads()) {
      const int32_t par = __ldg(p.aux + i);
      if (par != i) mirror((int32_t)i, __ldcg(cur + par));
    }
    return;
  }
  const unsigned u = __ldcg(p.ctrl + CTRL_UCOUNT + (st.q - 1) % 3);
  const int32_t* last = p.ulist[(st.q - 1) & 1];
  for (int64_t k = gtid(); k < u; k += gthreads()) {
    const int32_t v = __ldcg(last + k);
    const Val x = __ldcg(cur + v);
    const int32_t c1 = __ldcg(p.dirty[1] + v);
    for (int32_t c = __ldcg(p.dirty[0] + v); c < c1; ++c) mirror(c, x);
  }
}

// NS: whether node c is a slot of phase q's frontier itself (in C, whose
// filter stamped it with q; in S, for the heavy pass)
__device__ __forceinline__ bool own_slot(const Params& p, int32_t c,
                                         bool heavy_turn, int32_t q) {
  return heavy_turn ? __ldcg(p.settled + c) != 0 : __ldcg(p.stamp + c) == q;
}

// NS's ns_activate in a delta phase, the frontier: its slots [0,
// f.count) widened to their nodes' children, appended after them (one
// atomic a warp), whose degrees over gr join the frontier's counts and
// the histogram of compaction par (ends in a barrier).  A child that is
// a slot itself (in C, stamped with the phase q; in S, the heavy pass's
// frontier) is not appended again.  The order of the slots changes no
// bits.
__device__ __noinline__ Frontier ns_widen(const Params& p,
                                          const Graph& graph, Frontier f,
                                          int par, unsigned* ext,
                                          bool heavy_turn, int32_t q) {
  const Graph gr = graph;
  __shared__ int32_t bins[32];
  if (threadIdx.x < 32) bins[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  int32_t sum = 0, mx = 0, unused = 0;
  for (int64_t i0 = gtid() - lane; i0 < f.count; i0 += gthreads()) {
    const int64_t i = i0 + lane;
    int32_t k0 = 0, k1 = 0, nk = 0;
    if (i < f.count) {
      const int32_t v = __ldcg(p.list + i);
      k0 = __ldcg(p.dirty[0] + v);
      k1 = __ldcg(p.dirty[1] + v);
      for (int32_t c = k0; c < k1; ++c) nk += !own_slot(p, c, heavy_turn, q);
    }
    int32_t x = nk;                     // inclusive scan of the children
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    const int32_t total = __shfl_sync(FULL, x, 31);
    unsigned base = 0;
    if (lane == 0 && total) base = atomicAdd(ext, (unsigned)total);
    base = __shfl_sync(FULL, base, 0);
    int32_t slot = f.count + (int32_t)base + x - nk;
    for (int32_t c = k0; c < k1; ++c) {
      if (own_slot(p, c, heavy_turn, q)) continue;
      const int32_t st = __ldg(gr.row_ptr + c);
      const int32_t d = __ldg(gr.row_ptr + c + 1) - st;
      p.list[slot] = c;
      p.deg[slot] = d;
      p.start[slot] = st;
      ++slot;
      sum += d;
      mx = max(mx, d);
      if (d) atomicAdd(bins + (32 - __clz(d)), 1);
    }
  }
  block_reduce3(sum, unused, mx);
  if (threadIdx.x == 0) {
    if (sum) atomicAdd(ext + 1, (unsigned)sum);
    if (mx) atomicMax(ext + 2, (unsigned)mx);
  }
  bins_end(p, par, bins);
  grid_sync(p.ctrl + CTRL_BAR);
  f.count += (int32_t)__ldcg(ext);
  f.degsum += (int32_t)__ldcg(ext + 1);
  f.maxdeg = max(f.maxdeg, (int32_t)__ldcg(ext + 2));
  return f;
}

// U after a phase (the closure's filter): a light round's nodes of bucket
// b leave M for the next round's C (warp_append writes its tables, and the
// degree histogram for BS, AD and NS) and join S; every other
// improved node joins M (its list gets an entry unless it holds one).
// Each value of U is copied into the other buffer on the way, which
// leaves both equal (the caller marks the chunking settled).
template <int COMB>
__device__ __forceinline__ void filter_stage(const Params& p,
                                             const Graph& heavy,
                                             const Graph& light,
                                             DeltaState& st,
                                             const DeltaScope& sc,
                                             bool heavy_turn) {
  unsigned* const ctrl = p.ctrl;
  const int lane = threadIdx.x & 31, ep = st.it & 1, pn = (st.q & 1) ^ 1;
  const int32_t u = (int32_t)__ldcg(ctrl + CTRL_UCOUNT + st.q % 3);
  const Val* vals = p.val[st.ch.cur()];
  const int32_t b =
      (int32_t)((unsigned)NO_BUCKET - __ldcg(ctrl + CTRL_LIVE + 2 + ep));
  __shared__ int32_t bins[32];
  const bool binned = !heavy_turn && (p.kernel == K_BS || p.kernel == K_AD ||
                                      p.kernel == K_NS);
  const int par = binned ? bins_begin(p, st.ch, bins) : 0;
  int32_t sdeg = 0, mx = 0, unused = 0;
  Val* const other = p.val[st.ch.cur() ^ 1];
  for (int64_t i0 = s_tid(sc) - lane; i0 < u; i0 += s_threads(sc)) {
    const int64_t i = i0 + lane;
    int32_t v = 0, sl = 0, dl = 0;
    bool take = false, snew = false, mnew = false;
    if (i < u) {
      v = __ldcg(p.ulist[st.q & 1] + i);
      // every load (and the narrow phase's stamp) the node may need, at
      // once
      const bool again = sc.alone && atomicExch(p.ustamp + v, st.q) == st.q;
      const Val x = __ldcg(vals + v);
      const bool in_m = __ldcg(p.live + v), in_s = __ldcg(p.settled + v),
                 held = __ldcg(p.listed + v);
      sl = __ldg(light.row_ptr + v);
      const int32_t sl_end = __ldg(light.row_ptr + v + 1);
      const int32_t dh = heavy.e ? degree(heavy, v) : 0;
      other[v] = x;
      take = !again && !heavy_turn && bucket_of<COMB>(x, p.delta) == b;
      if (again) {
        // listed before in this filter
      } else if (take) {
        p.live[v] = 0;
        if (p.kernel == K_NS) p.stamp[v] = st.q + 1;
        dl = sl_end - sl;
        mx = max(mx, dl);
        if (binned && dl) atomicAdd(bins + (32 - __clz(dl)), 1);
        if (!in_s) {
          p.settled[v] = 1;
          snew = true;
          sdeg += dh;
        }
      } else if (!in_m) {
        p.live[v] = 1;
        mnew = !held;
        if (mnew) p.listed[v] = 1;
      }
    }
    warp_append(p, c_cell(p, pn), ctrl + CTRL_SCOUNT + ep,
                ctrl + CTRL_MCOUNT + st.msel(), p.mlist[st.msel()], v, take, dl,
                sl, snew, mnew);
  }
  block_reduce3(sdeg, unused, mx);
  if (threadIdx.x == 0) {
    if (sdeg) atomicAdd(ctrl + CTRL_SCOUNT + 2 + ep, (unsigned)sdeg);
    if (mx) atomicMax(ctrl + CTRL_CMAX + pn, (unsigned)mx);
  }
  if (binned) bins_end(p, par, bins);
}

// One phase (priority._phase) and its filter: a light round over C or the
// heavy pass over S.  The strategy's step relaxes the frontier's tables
// (a light round's were written by the last filter or extraction; the
// heavy pass builds S's from its list; NS widens them to the children,
// always grid-wide) and notes what it improves in U.  A light round
// counts even when the light graph has no edges (then it relaxes
// nothing); the heavy pass counts only when it has edges; block 0's
// thread 0 keeps the counts (edges, rounds, grid-wide and narrow rounds)
// in `tally`, its block's shared memory.  The kernel has one call site,
// so the steps are inlined once.  Ends in a sync of the scope; then the
// next stage follows from C's length.
template <int MSG, int COMB>
__device__ __forceinline__ void phase_stage(const Params& p,
                                            const Graph& heavy,
                                            const Graph& light,
                                            DeltaState& st,
                                            const DeltaScope& sc,
                                            WdSmem& sm, long long* tally) {
  unsigned* const ctrl = p.ctrl;
  const bool heavy_turn = st.stage() == ST_HEAVY;
  const int pq = st.q & 1;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *c_cell(p, pq ^ 1) = 0;
    ctrl[CTRL_CMAX + (pq ^ 1)] = 0;
    ctrl[CTRL_UCOUNT + (st.q + 1) % 3] = 0;
    for (int k = 0; k < 3; ++k) ctrl[CTRL_EXT + 3 * (pq ^ 1) + k] = 0;
  }
  int32_t count, edges;
  if (heavy_turn) {
    count = (int32_t)__ldcg(ctrl + CTRL_SCOUNT + (st.it & 1));
    edges = (int32_t)__ldcg(ctrl + CTRL_SCOUNT + 2 + (st.it & 1));
  } else {
    const unsigned long long c = __ldcg(c_cell(p, pq));
    count = (int32_t)(c >> 32);
    edges = (int32_t)(unsigned)c;
  }
  // the phase's graph by the address of a kernel parameter, so that no
  // register holds its arrays through the phase
  const Graph* gp = heavy_turn ? &heavy : &light;
  const bool run =
      gp->e > 0 && (p.kernel == K_NS || !heavy_turn || edges > 0);
  if (run) {
    Frontier f;
    int which = p.kernel;
    if (p.kernel == K_NS) ns_mirror(p, light, st, sc);   // NS: grid-wide
    if (heavy_turn) {
      f = list_count(p, sc, *gp, p.slist, count);
    } else {
      f.count = count;
      f.degsum = edges;
      f.maxdeg = (int32_t)__ldcg(ctrl + CTRL_CMAX + pq);
      f.before_count = f.before_deg = 0;
    }
    if (which == K_AD) {
      const int idx = ad_choice(p, f);
      which = idx == 0 ? K_BS : (idx == 1 ? K_WD : K_HP);
    }
    if (heavy_turn) {
      list_compact(p, sc, *gp, p.slist, f, st.ch,
                   (which == K_BS || which == K_NS) && p.tail_width > 0 &&
                       (which == K_NS || f.count > p.tail_width));
      s_sync(sc, ctrl);
    }
    if (p.kernel == K_NS)
      f = ns_widen(p, *gp, f, st.ch.last_compaction(),
                   ctrl + CTRL_EXT + 3 * pq, heavy_turn, st.q);
    const int32_t e = f.degsum;
    if (gtid() == 0 && (!heavy_turn || e > 0)) {
      tally[0] += e;
      ++tally[1];
      ++tally[sc.alone ? 3 : 2];
    }
    // p.mask[1] takes the lanes' update bytes: nothing reads them
    if (which == K_BS || which == K_NS) {
      bs_step<MSG, COMB>(p, *gp, f, p.mask[1], st.ch, sm, sc);
    } else if (which == K_WD) {
      wd_step<MSG, COMB>(p, *gp, f, p.mask[1], st.ch, sm, sc);
    } else {
      hp_step<MSG, COMB>(p, *gp, f, p.mask[1], st.ch, sm, sc);
    }
    filter_stage<COMB>(p, heavy, light, st, sc, heavy_turn);
    st.ch.settled();
  } else if (gtid() == 0 && !heavy_turn) {
    ++tally[1];                         // a light round relaxes nothing
    ++tally[sc.alone ? 3 : 2];
  }
  s_sync(sc, ctrl);
  ++st.q;
  if (!heavy_turn && (__ldcg(c_cell(p, st.q & 1)) >> 32) > 0) {
    st.set_stage(ST_ROUND);
  } else if (!heavy_turn && heavy.e > 0) {
    st.set_stage(ST_HEAVY);
  } else {
    ++st.it;
    st.set_stage(ST_EPOCH);
  }
}

// p carries the light graph (w <= delta) and heavy the heavy one (e = 0:
// none).  Every block runs the stage loop; a narrow stage runs in block 0
// alone, which goes on alone while the stages stay narrow (for at most
// NARROW_CYCLES), as the rest of the grid waits at a barrier:
// a barrier first, so that every block has read the cells the choice
// came from before block 0 moves on, then the one after the stretch,
// after which every block loads the state block 0 stored.
template <int MSG, int COMB>
__global__ void __launch_bounds__(THREADS, DELTA_MIN_BLOCKS)
fused_delta_kernel(const __grid_constant__ Params p,
                   const __grid_constant__ Graph heavy,
                   const __grid_constant__ Graph light) {
  __shared__ WdSmem sm;
  const int lane = threadIdx.x & 31;
  for (int64_t i0 = gtid() - lane; i0 < p.n; i0 += gthreads()) {
    const int64_t i = i0 + lane;
    bool on = false;
    if (i < p.n) {
      const Val v = __ldg(p.dist0 + i);
      p.val[0][i] = v;
      p.val[1][i] = v;
      p.ustamp[i] = -1;
      on = __ldg(p.mask0 + i) != 0;
      p.live[i] = on;
      p.listed[i] = on;
      p.settled[i] = 0;
      if (p.kernel == K_NS) {
        p.dirty[0][i] = p.dirty[1][i] = 0;
        p.stamp[i] = -1;
      }
    }
    warp_take(p.ctrl + CTRL_MCOUNT, p.mlist[0], on, (int32_t)i);
  }
  for (int64_t i = gtid(); i < max(p.n, p.narrow_edges); i += gthreads()) {
    p.ulist[0][i] = 0;                  // DeltaScope: valid node ids
    p.ulist[1][i] = 0;
  }
  if (p.kernel == K_NS) {
    // each node's children: the split graph keeps a node's children
    // together, after every original node
    grid_sync(p.ctrl + CTRL_BAR);
    for (int64_t i = gtid(); i < p.n; i += gthreads()) {
      const int32_t par = __ldg(p.aux + i);
      if (par == i) continue;
      const int32_t before = __ldg(p.aux + i - 1);   // an original: itself
      if (before != par || before == i - 1) p.dirty[0][par] = (int32_t)i;
      if (i + 1 == p.n || __ldg(p.aux + i + 1) != par)
        p.dirty[1][par] = (int32_t)i + 1;
    }
  }
  // the last bucket and the frontier's count go straight into the result
  // cells, and edges, rounds, grid-wide and narrow rounds at the end, kept
  // by block 0's thread 0 meanwhile
  __shared__ long long tally[4];
  if (gtid() == 0) {
    p.result[3] = NO_BUCKET;
    for (int k = 0; k < 4; ++k) tally[k] = 0;
  }
  grid_sync(p.ctrl + CTRL_BAR);

  DeltaState st;
  while (st.stage() != ST_DONE) {
    const bool narrow = stage_narrow(p, st);
    if (narrow) grid_sync(p.ctrl + CTRL_BAR);
    if (!narrow || blockIdx.x == 0) {
      const long long t0 = clock64();
      for (;;) {
        const DeltaScope sc{narrow, st.q};
        if (st.stage() == ST_EPOCH) epoch_stage<COMB>(p, heavy, light, st, sc);
        else phase_stage<MSG, COMB>(p, heavy, light, st, sc, sm, tally);
        if (!narrow || st.stage() == ST_DONE || !stage_narrow(p, st)) break;
        // thread 0's clock decides for the whole block
        if (__syncthreads_or(threadIdx.x == 0 &&
                             clock64() - t0 > NARROW_CYCLES))
          break;
      }
    }
    if (narrow) {
      if (blockIdx.x == 0 && threadIdx.x == 0)
        st.store(p.ctrl + CTRL_STATE);
      grid_sync(p.ctrl + CTRL_BAR);
      st.load(p.ctrl + CTRL_STATE);
    }
  }
  // every phase ends in its filter, which leaves both buffers equal: the
  // result lies in val[0]
  if (gtid() == 0) {
    p.result[0] = st.it;
    p.result[1] = tally[0];
    p.result[2] = tally[1];
    p.result[5] = tally[2];
    p.result[6] = tally[3];
    p.result[7] = __ldcg(p.ctrl + CTRL_NBAR);
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
// The delta mode's lists and bytes come last, in its layout only.
struct Layout {
  size_t ctrl, B, stamp, dirty0, dirty1, list, deg, pfx, exc, start, tail,
      mask0, mask1, settled, btot, listed, mlist0, mlist1, slist, ulist0,
      ulist1, ustamp, total;
};

Layout layout(int64_t n, int64_t max_grid, bool delta,
              int64_t narrow_edges = 0) {
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
  if (delta) {
    l.listed = take(n);
    l.mlist0 = take(n * 4);
    l.mlist1 = take(n * 4);
    l.slist = take(n * 4);
    l.ulist0 = take((n > narrow_edges ? n : narrow_edges) * 4);
    l.ulist1 = take((n > narrow_edges ? n : narrow_edges) * 4);
    l.ustamp = take(n * 4);
  }
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

// delta mode: idempotent operators only (no COMB_ADD instances)
template <int MSG, int COMB>
cudaError_t launch_delta_t(Params p, Graph heavy, cudaStream_t st) {
  Graph light = graph_of(p);
  void* args[] = {&p, &heavy, &light};
  return launch_coop((const void*)fused_delta_kernel<MSG, COMB>, args, st);
}

// The Params of one launch over n nodes, the workspace
// carved by its layout (the delta mode's: with its lists); zeroes the
// control words.
cudaError_t make_params(Params& p, const int32_t* row_ptr, const int32_t* col,
                        const int32_t* wt, int32_t n, int32_t e,
                        const int32_t* aux, const Val* dist0,
                        const uint8_t* mask0, int kernel, int max_iterations,
                        int mdt, int switch_threshold, int small_frontier,
                        float imbalance_threshold, int hp_edges_threshold,
                        int tail_width, int tail_min_columns,
                        Val* dist, void* workspace,
                        long long workspace_bytes, long long* result,
                        cudaStream_t st, bool delta = false,
                        int32_t narrow_edges = 0) {
  int64_t grid = 0;
  cudaError_t err = max_grid(&grid);
  if (err != cudaSuccess) return err;
  const Layout l = layout(n, grid, delta, narrow_edges);
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
  p.tail_min_columns = tail_min_columns;
  p.narrow_edges = narrow_edges;
  p.val[0] = dist;
  p.val[1] = reinterpret_cast<Val*>(ws + l.B);
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
  if (delta) {
    p.listed = reinterpret_cast<uint8_t*>(ws + l.listed);
    p.mlist[0] = reinterpret_cast<int32_t*>(ws + l.mlist0);
    p.mlist[1] = reinterpret_cast<int32_t*>(ws + l.mlist1);
    p.slist = reinterpret_cast<int32_t*>(ws + l.slist);
    p.ulist[0] = reinterpret_cast<int32_t*>(ws + l.ulist0);
    p.ulist[1] = reinterpret_cast<int32_t*>(ws + l.ulist1);
    p.ustamp = reinterpret_cast<int32_t*>(ws + l.ustamp);
  }
  p.ctrl = reinterpret_cast<unsigned*>(ws + l.ctrl);
  p.result = result;
  return cudaMemsetAsync(p.ctrl, 0, CTRL_WORDS * sizeof(unsigned), st);
}

template <int MSG, int COMB>
int delta_block_attrs(int* out) {
  if constexpr (COMB == COMB_ADD) {
    return (int)cudaErrorInvalidValue;
  } else {
    return (int)repro_block_attrs((const void*)fused_delta_kernel<MSG, COMB>,
                                  THREADS, 0, out);
  }
}

}  // namespace

extern "C" {

// Bytes of workspace a traversal of n nodes needs on the current card
// (delta != 0: a delta-stepping traversal's whose narrow phases relax at
// most narrow_edges edges).
int repro_fused_workspace_bytes(int32_t n, int delta, int narrow_edges,
                                long long* bytes) {
  int64_t grid = 0;
  const cudaError_t err = max_grid(&grid);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || narrow_edges < 0) return (int)cudaErrorInvalidValue;
  *bytes = (long long)layout(n, grid, delta != 0, narrow_edges).total;
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
// block (0: none), and tail_min_columns (>= 1) the fewest columns such a
// one-block tail takes.  workspace holds repro_fused_workspace_bytes(n, 0,
// 0) bytes.
// Returns the status of the launch (cudaErrorCooperativeLaunchTooLarge
// if the grid cannot be resident).
int repro_fused_fixed_point(
    const int32_t* row_ptr, const int32_t* col, const int32_t* wt,
    int32_t n, int32_t e, const int32_t* aux, const Val* dist0,
    const uint8_t* mask0, int kernel, int msg, int comb, int max_iterations,
    int mdt, int switch_threshold, int small_frontier,
    float imbalance_threshold, int hp_edges_threshold, int tail_width,
    int tail_min_columns, const float* coeffs, Val* dist,
    void* workspace, long long workspace_bytes, long long* result,
    void* stream) {
  if (!codes_ok(msg, comb) || kernel < K_BS || kernel > K_AD || n < 1 ||
      e < 0 || mdt < 1 || dist == dist0 || tail_width < 0 ||
      tail_width > TAIL_MAX || tail_min_columns < 1 ||
      ((kernel == K_EP || kernel == K_NS) && aux == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Params p;
  cudaError_t err = make_params(
      p, row_ptr, col, wt, n, e, aux, dist0, mask0, kernel, max_iterations,
      mdt, switch_threshold, small_frontier, imbalance_threshold,
      hp_edges_threshold, tail_width, tail_min_columns, dist, workspace,
      workspace_bytes, result, st);
  if (err != cudaSuccess) return (int)err;
  if (coeffs != nullptr) {
    p.measured = 1;
    for (int k = 0; k < 9; ++k) p.coeffs[k] = coeffs[k];
  }
  with_codes(msg, comb, [&](auto m, auto c) {
    err = launch_t<decltype(m)::value, decltype(c)::value>(p, st);
  });
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
// grid-wide rounds, the narrow rounds (in one block) and the grid
// barriers.  tail_width (0..TAIL_MAX) is the most nodes of a narrow round
// and of a one-block BS tail (0: neither), tail_min_columns (>= 1) the
// fewest columns of such a tail, narrow_edges (>= 0) the most edges of a
// narrow round.  workspace holds
// repro_fused_workspace_bytes(n, 1, narrow_edges) bytes.
int repro_fused_delta(
    const int32_t* row_ptr, const int32_t* col, const int32_t* wt, int32_t e,
    const int32_t* hrow_ptr, const int32_t* hcol, const int32_t* hwt,
    int32_t he, int32_t n, const int32_t* aux, const Val* dist0,
    const uint8_t* mask0, int kernel, int msg, int comb, int delta,
    int max_epochs, int mdt, int switch_threshold, int small_frontier,
    float imbalance_threshold, int hp_edges_threshold, int tail_width,
    int tail_min_columns, int narrow_edges, Val* dist, uint8_t* mask,
    void* workspace, long long workspace_bytes, long long* result,
    void* stream) {
  if (!codes_ok(msg, comb) || comb == COMB_ADD || kernel < K_BS ||
      kernel > K_AD || kernel == K_EP || n < 1 || e < 0 || he < 0 ||
      tail_width < 0 || tail_width > TAIL_MAX || tail_min_columns < 1 ||
      narrow_edges < 0 ||
      (he > 0 && hrow_ptr == nullptr) || delta < 1 || mdt < 1 ||
      dist == dist0 || (kernel == K_NS && aux == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Params p;
  cudaError_t err = make_params(
      p, row_ptr, col, wt, n, e, aux, dist0, mask0, kernel, max_epochs,
      mdt, switch_threshold, small_frontier, imbalance_threshold,
      hp_edges_threshold, tail_width, tail_min_columns, dist, workspace,
      workspace_bytes, result, st, true, narrow_edges);
  if (err != cudaSuccess) return (int)err;
  p.delta = delta;
  p.live = mask;
  const Graph heavy = he > 0 ? Graph{hrow_ptr, hcol, hwt, he}
                             : Graph{nullptr, nullptr, nullptr, 0};
  with_codes<true>(msg, comb, [&](auto m, auto c) {
    err = launch_delta_t<decltype(m)::value, decltype(c)::value>(p, heavy,
                                                                  st);
  });
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
// (the build's AttrCodes instance); bar: two zeroed words (the barrier
// and its count).
int repro_fused_barrier_probe(int k, unsigned* bar, void* stream) {
  if (k < 0 || bar == nullptr) return (int)cudaErrorInvalidValue;
  void* args[] = {&bar, &k};
  const cudaError_t err = launch_coop(
      (const void*)barrier_probe_kernel, args, (cudaStream_t)stream,
      (const void*)fused_fixed_point_kernel<AttrCodes::msg,
                                            AttrCodes::comb>);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The fused fixed point (which 0) or the delta kernel (1), the build's
// AttrCodes instance (shortest_path's, or a custom build's operator; an
// add operator has no delta kernel): out [ATTR_CELLS] as
// repro_block_attrs (attrs.cuh).
int repro_fused_block_attrs(int which, int* out) {
  constexpr int M = AttrCodes::msg, C = AttrCodes::comb;
  if (which == 0)
    return (int)repro_block_attrs(
        (const void*)fused_fixed_point_kernel<M, C>, THREADS, 0, out);
  if (which == 1) return delta_block_attrs<M, C>(out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
