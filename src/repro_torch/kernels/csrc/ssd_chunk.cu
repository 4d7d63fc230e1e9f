// B5: the Mamba-2 SSD intra-chunk dual form of the PyTorch port, CUDA C++
// for sm_90a.
//
// repro_ssd_chunk_dual replaces repro/kernels/ssd_chunk.py ssd_chunk_dual
// (Pallas body _kernel).  For every (chunk-batch bn, head h), with x̄ [c,P]
// (xbar), the decay log-cumsum cum [c] and the head-shared B, C [c,N]:
//
//   y[i]  = sum_{j<=i} (C_i . B_j) * exp(cum_i - cum_j) * x̄_j       [c,P]
//   state = sum_j (B_j * exp(cum_{c-1} - cum_j)) (x) x̄_j            [N,P]
//
// The operation order is the reference's: the decay matrix entry
// multiplies the C.B product (M = CB * L), and the state scales B by the
// decay before the product with x̄.  Both outputs are f32.  Two kernels,
// chosen by dtype (a fixed dispatch: neither falls back to the other):
//
// bf16: ssd_bf16_kernel, on the tensor cores (mma.sync m16n8k16 bf16 ->
// f32, mma.cuh).  x̄, B and C arrive in bf16, so C.B and the products with
// x̄ take them as bf16 operands exactly.  The factors formed in f32, M =
// CB * L and B * decay, are split into bf16 hi + lo and enter the product
// with x̄ as two terms, which keeps 16 significant bits (residual
// <= 2^-17 of the factor).  One block of 4 warps (16 rows each) owns one
// chunk bn, one 64-row strip and a group of HG heads; HG is chosen at
// launch so that the grid still has two waves of blocks at the call's BN.
// Phase 1, head-independent: a y strip (rows i of y) forms its rows of
// C.B for every j-tile it needs (j <= i) once, C strip and B tiles as
// bf16 operands in shared memory, and keeps the f32 product W[i][j] in
// shared memory; a state strip (rows n of the state) keeps W[n][j] =
// B[j][n].  So C.B costs BN x (H/HG), not BN x H, tile products.  Phase 2,
// for each head of the group: 64-row tiles of x̄ arrive through cp.async
// into a two-stage ring; each warp builds the A fragments of its 16 rows
// from W times the head's factor (exp(cum_i - cum_j) masked to j <= i < c
// for y, exp(cum_{c-1} - cum_j) for the state), split hi/lo, and
// multiplies them into the x̄ tile (ldmatrix.trans) with f32 accumulators
// in registers.  The [c, c] matrix is never formed: W holds 64 rows of it,
// 64 x (c + 8) f32, 66 KB at c = 256.  Shared memory at the serving
// shape (c = 256, N = 128, P = 64, HG = 4): 106 KB, two blocks to an SM.
// c, N (<= 128), P (<= 128) and a ragged c stay run-time arguments; W
// grows with c, and a c whose shared memory does not fit the card fails
// at launch (the wrapper takes c <= 512).  N or P not a multiple of 8
// take element-wise loads.
//
// f32: ssd_chunk_kernel, f32 FMA on the CUDA cores.  The reference's f32
// path needs f32 products (the tests hold it to 1e-5).  The grid is
// (strips + 1, H, BN): block x < S (S = ceil(c/64) strips) owns one 64-row
// strip of y and walks the 64-row j-tiles with j <= i only; per tile it
// forms the 64x64 product C_i . B_j in registers, scales it by
// exp(cum_i - cum_j) (0 above the diagonal and past c), stages it in
// shared memory, and multiplies it into that tile of x̄.  Block x = S
// computes the chunk state by walking all j-tiles.  Thread (r, cg) owns
// rows 4r..4r+3 of a strip and columns cg, cg+16, ...  Shared memory:
// 102 KB at N = 128, P = 64.  It recomputes C.B for every head.
//
// What bounds it on the H100.  At the serving path's shape (BN = 8 chunks
// of c = 256, H = 48, P = 64, N = 128) the function needs the causal half
// of C.B once per chunk (c(c+1)/2*N*2 FLOP), and per head the causal half
// of M.x̄ (c(c+1)/2*P*2) and the state (c*N*P*2): 3.3 GFLOP.  For bf16
// inputs that is 0.003 ms at the tensor cores' 989 TFLOP/s, below the
// 0.016 ms of its 52 MB of inputs and f32 outputs at 3.35 TB/s: bytes
// bound it.  For f32 inputs it is 0.049 ms at the CUDA cores' 67 TFLOP/s:
// operations bound it.  The measured times are in PERF.md (chip_smoke.py).
//
// The backward pass, repro_ssd_chunk_dual_bwd, replaces no TPU kernel: the
// reference trains through jax.grad of ssd_chunked's einsums
// (repro/models/mamba.py).  From the cotangents (dy, dstate) it gives
// dx̄, dcum, dB and dC in f32.  ssd_bwd_kernel runs one block of 256
// threads per (chunk-batch row bn, group of heads): the block alone owns
// its heads' dx̄ and dcum, and writes the dB and dC that its heads add up
// to, shared by all heads, into a partial of its own ([BN, groups, c, N]);
// ssd_bwd_fold_kernel then sums the groups' partials in their order (no
// float atomics, the same sums on every run).  A group is as many heads
// as leave one wave of blocks, one a SM (bwd_heads_per_block); with one
// group the block writes dB and dC itself and nothing is folded.  dx̄,
// dcum and dC are summed into in place, each element by one thread
// between barriers, in a fixed order.  For each 64-row
// j-tile J: per head the state's share (d_j = exp(cum_last - cum_j) <= 1;
// dx̄ += d (B dstate), dB += d (x̄ dstate^T), dcum from dd_j = sum
// dstate o (B_j (x) x̄_j)); then per strip I >= J the C.B tile once, and
// per head dM = dy x̄^T, L = exp(cum_i - cum_j) masked to j <= i BEFORE
// the exponential (so a strong decay, a span past ~88 where the
// reference's where(mask, exp(seg), 0) overflows and its gradient turns
// NaN, stays finite), M = CB o L, dx̄ += M^T dy, dcum += rows of dM o M
// minus its columns, and dCB = dM o L summed over the group's heads; then
// dC += dCB B, dB += dCB^T C.  f32 FMA on the CUDA cores for both dtypes.
// What bounds it: at mamba2's training shape (BN 16, c 256, H 48, P 64,
// N 128) 13.3 GFLOP against 132 MB, so bytes at 3.35 TB/s (0.04 ms) for
// bf16 inputs.  There a group is 6 heads: 16 x 8 = 128 blocks on the 132
// SMs, each recomputing C.B and the dC/dB products for its group (1.4x
// the FLOP of one block a chunk, which left 116 SMs idle); the time is in
// PERF.md.
//
// The entry points launch on the given stream, allocate nothing, do not
// synchronise, and return cudaGetLastError() of their launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attrs.cuh"
#include "mma.cuh"

namespace {

constexpr int TILE = 64;      // rows of a strip of y, rows of a j-tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int LDM = TILE + 4;
constexpr int MAX_NP = 128;   // largest N and P the register tiles hold
constexpr int MC = MAX_NP / 16;

constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

size_t smem_floats(int N, int P) {
  const int ldn = ((N + 3) & ~3) + 4;
  return (size_t)2 * TILE * ldn + (size_t)TILE * P + (size_t)TILE * LDM +
         2 * TILE;
}

__global__ void __launch_bounds__(THREADS, 2)
    ssd_chunk_kernel(const float* __restrict__ xbar,
                     const float* __restrict__ cum,
                     const float* __restrict__ Bm,
                     const float* __restrict__ Cm,
                     float* __restrict__ y, float* __restrict__ state, int c,
                     int H, int P, int N) {
  const int ldn = ((N + 3) & ~3) + 4;  // row stride of the C / B tiles
  const int np4 = (N + 3) & ~3;        // N rounded up; padding holds zeros
  extern __shared__ float4 smem4[];
  float* Cs = reinterpret_cast<float*>(smem4);  // [TILE][ldn]
  float* Bs = Cs + TILE * ldn;                  // [TILE][ldn]
  float* Xs = Bs + TILE * ldn;                  // [TILE][P]
  float* Ms = Xs + TILE * P;                    // [TILE][LDM]
  float* cum_i = Ms + TILE * LDM;               // [TILE]
  float* cum_j = cum_i + TILE;                  // [TILE]

  const int n_strips = (c + TILE - 1) / TILE;
  const int h = blockIdx.y, bn = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)bn * c;  // first row of this chunk

  // one j-tile of B (times `decay` when scaling for the state) and x̄
  auto load_j = [&](int j0, bool scale_by_decay, float cum_last) {
    for (int idx = tid; idx < TILE; idx += THREADS) {
      const int j = j0 + idx;
      cum_j[idx] = j < c ? cum[(row0 + j) * H + h] : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < TILE * np4; idx += THREADS) {
      const int jj = idx / np4, n = idx % np4;
      const int j = j0 + jj;
      float b = (j < c && n < N) ? Bm[(row0 + j) * N + n] : 0.f;
      if (scale_by_decay && j < c) b *= expf(cum_last - cum_j[jj]);
      Bs[jj * ldn + n] = b;
    }
    for (int idx = tid; idx < TILE * P; idx += THREADS) {
      const int jj = idx / P, p = idx % P;
      const int j = j0 + jj;
      Xs[jj * P + p] = j < c ? xbar[((row0 + j) * H + h) * P + p] : 0.f;
    }
    __syncthreads();
  };

  if ((int)blockIdx.x == n_strips) {
    // ---- the chunk state: state[n][p] = sum_j (B_j[n] d_j) x̄_j[p]
    const int tn = tid >> 4, tp = tid & 15;
    const float cum_last = cum[(row0 + c - 1) * H + h];
    float acc[MC][MC];
#pragma unroll
    for (int a = 0; a < MC; ++a)
#pragma unroll
      for (int b = 0; b < MC; ++b) acc[a][b] = 0.f;
    for (int j0 = 0; j0 < c; j0 += TILE) {
      __syncthreads();  // the previous tile is consumed
      load_j(j0, true, cum_last);
      const int jn = min(TILE, c - j0);
      for (int jj = 0; jj < jn; ++jj) {
        float bv[MC], xv[MC];
#pragma unroll
        for (int a = 0; a < MC; ++a) {
          const int n = tn + 16 * a;
          bv[a] = n < N ? Bs[jj * ldn + n] : 0.f;
        }
#pragma unroll
        for (int b = 0; b < MC; ++b) {
          const int p = tp + 16 * b;
          xv[b] = p < P ? Xs[jj * P + p] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < MC; ++a)
#pragma unroll
          for (int b = 0; b < MC; ++b) acc[a][b] = fmaf(bv[a], xv[b], acc[a][b]);
      }
    }
    float* st = state + ((size_t)bn * H + h) * N * P;
#pragma unroll
    for (int a = 0; a < MC; ++a) {
      const int n = tn + 16 * a;
      if (n >= N) continue;
#pragma unroll
      for (int b = 0; b < MC; ++b) {
        const int p = tp + 16 * b;
        if (p < P) st[(size_t)n * P + p] = acc[a][b];
      }
    }
    return;
  }

  // ---- one 64-row strip of y; the longest walks (last strips) go first
  const int strip = n_strips - 1 - blockIdx.x;
  const int i0 = strip * TILE;
  const int r = tid >> 4, cg = tid & 15;

  for (int idx = tid; idx < TILE; idx += THREADS) {
    const int i = i0 + idx;
    cum_i[idx] = i < c ? cum[(row0 + i) * H + h] : 0.f;
  }
  for (int idx = tid; idx < TILE * np4; idx += THREADS) {
    const int ii = idx / np4, n = idx % np4;
    const int i = i0 + ii;
    Cs[ii * ldn + n] = (i < c && n < N) ? Cm[(row0 + i) * N + n] : 0.f;
  }

  float acc[4][MC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < MC; ++b) acc[a][b] = 0.f;

  for (int jt = 0; jt <= strip; ++jt) {
    const int j0 = jt * TILE;
    __syncthreads();  // the previous tile's M and x̄ are consumed
    load_j(j0, false, 0.f);

    // M[i][j] = (C_i . B_j) * exp(cum_i - cum_j) for j <= i, j < c; else 0
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[a][q] = 0.f;
    for (int n = 0; n < np4; n += 4) {
      float4 ca[4], bb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        ca[a] = *reinterpret_cast<const float4*>(&Cs[(4 * r + a) * ldn + n]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        bb[q] = *reinterpret_cast<const float4*>(&Bs[(cg + 16 * q) * ldn + n]);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          s[a][q] = fmaf(ca[a].x, bb[q].x, s[a][q]);
          s[a][q] = fmaf(ca[a].y, bb[q].y, s[a][q]);
          s[a][q] = fmaf(ca[a].z, bb[q].z, s[a][q]);
          s[a][q] = fmaf(ca[a].w, bb[q].w, s[a][q]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + 4 * r + a;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int jj = cg + 16 * q;
        const int j = j0 + jj;
        Ms[(4 * r + a) * LDM + jj] =
            (j < c && i >= j)
                ? s[a][q] * expf(cum_i[4 * r + a] - cum_j[jj])
                : 0.f;
      }
    }
    __syncthreads();

    // acc[i][p] += sum_j M[i][j] x̄[j][p]
    for (int jj = 0; jj < TILE; jj += 4) {
      float4 ma[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        ma[a] = *reinterpret_cast<const float4*>(&Ms[(4 * r + a) * LDM + jj]);
#pragma unroll
      for (int b = 0; b < MC; ++b) {
        const int p = cg + 16 * b;
        if (p >= P) continue;
        const float x0 = Xs[(jj + 0) * P + p];
        const float x1 = Xs[(jj + 1) * P + p];
        const float x2 = Xs[(jj + 2) * P + p];
        const float x3 = Xs[(jj + 3) * P + p];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          acc[a][b] = fmaf(ma[a].x, x0, acc[a][b]);
          acc[a][b] = fmaf(ma[a].y, x1, acc[a][b]);
          acc[a][b] = fmaf(ma[a].z, x2, acc[a][b]);
          acc[a][b] = fmaf(ma[a].w, x3, acc[a][b]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + 4 * r + a;
    if (i >= c) continue;
    float* yr = y + ((row0 + i) * H + h) * P;
#pragma unroll
    for (int b = 0; b < MC; ++b) {
      const int p = cg + 16 * b;
      if (p < P) yr[p] = acc[a][b];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;  // 4 warps x 16 rows of a 64-row strip
constexpr int MAX_HG = 8;
constexpr int TARGET_BLOCKS = 2 * 2 * 132;  // two waves of two blocks a SM

// shared-memory shapes of one bf16 block
struct TcLayout {
  int cw;        // c rounded up to 64: the columns of W
  int ldw;       // row stride of W in floats, 8 mod 32: float2 reads of
                 // 8 rows x 4 column pairs hit distinct banks
  int np, ldn;   // N rounded up to 16; row stride of a C / B tile (bf16)
  int pp, ldx;   // P rounded up to 16; row stride of an x̄ tile (bf16)
  __host__ __device__ TcLayout(int c, int N, int P)
      : cw((c + 63) & ~63), ldw(cw + 8), np((N + 15) & ~15), ldn(np + 8),
        pp((P + 15) & ~15), ldx(pp + 8) {}
  __host__ __device__ size_t bytes(int HG) const {
    const int u = 2 * TILE * (ldn > ldx ? ldn : ldx);
    return (size_t)TILE * ldw * 4 + (size_t)HG * cw * 4 + (size_t)u * 2;
  }
};

__global__ void __launch_bounds__(TC_THREADS, 2)
    ssd_bf16_kernel(const __nv_bfloat16* __restrict__ xbar,
                    const float* __restrict__ cum,
                    const __nv_bfloat16* __restrict__ Bm,
                    const __nv_bfloat16* __restrict__ Cm,
                    float* __restrict__ y, float* __restrict__ state, int c,
                    int H, int P, int N, int HG) {
  using namespace repro_mma;
  using bf16 = __nv_bfloat16;
  const TcLayout L(c, N, P);
  extern __shared__ float4 smem4[];
  float* Ws = reinterpret_cast<float*>(smem4);  // [TILE][ldw]
  float* cums = Ws + TILE * L.ldw;              // [HG][cw], 0 past c
  bf16* U = reinterpret_cast<bf16*>(cums + HG * L.cw);
  bf16* Cs = U;                // phase 1: [TILE][ldn] C strip
  bf16* Bt = U + TILE * L.ldn;  //          [TILE][ldn] B tile
  bf16* Xs = U;                // phase 2: [2][TILE][ldx] x̄ ring

  const int n_strips = (c + TILE - 1) / TILE;
  const int n_state = (N + TILE - 1) / TILE;
  const int bn = blockIdx.z, h0 = blockIdx.y * HG;
  const int nh = min(HG, H - h0);
  // state strips first, then y strips from the longest walk down
  const bool is_state = (int)blockIdx.x < n_state;
  const int strip =
      is_state ? blockIdx.x : n_strips - 1 - ((int)blockIdx.x - n_state);
  const int r_base = strip * TILE;  // first row: of y (i) or of state (n)
  const int cols = is_state ? L.cw : (strip + 1) * TILE;  // j extent
  const size_t row0 = (size_t)bn * c;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rr = warp * 16 + (lane >> 2);  // this lane's rows: rr, rr + 8
  const int tq = 2 * (lane & 3);           // first of its column pair

  for (int idx = tid; idx < nh * cols; idx += TC_THREADS) {
    const int hh = idx % nh, j = idx / nh;
    cums[hh * L.cw + j] = j < c ? cum[(row0 + j) * H + h0 + hh] : 0.f;
  }

  // ---- phase 1: W, shared by the heads of the group
  if (is_state) {  // W[r][j] = B[j][n], n = r_base + r
    for (int idx = tid; idx < TILE * L.cw; idx += TC_THREADS) {
      const int j = idx / TILE, r = idx % TILE;
      const int n = r_base + r;
      Ws[r * L.ldw + j] =
          (j < c && n < N) ? __bfloat162float(Bm[(row0 + j) * N + n]) : 0.f;
    }
  } else {  // W[i][j] = C_i . B_j for the strip's rows, j-tiles <= strip
    // rows first..first+63 of a [c, N] matrix into [TILE][ldn], zero-padded
    auto load_rows = [&](bf16* dst, const bf16* src, int first) {
      if ((N & 7) == 0) {
        const int chunks = L.np / 8;
        for (int idx = tid; idx < TILE * chunks; idx += TC_THREADS) {
          const int r = idx / chunks, ch = idx % chunks;
          const int row = first + r;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (row < c && ch * 8 < N)
            val = *reinterpret_cast<const uint4*>(src + (row0 + row) * N +
                                                  ch * 8);
          *reinterpret_cast<uint4*>(dst + r * L.ldn + ch * 8) = val;
        }
      } else {
        for (int idx = tid; idx < TILE * L.np; idx += TC_THREADS) {
          const int r = idx / L.np, n = idx % L.np;
          const int row = first + r;
          dst[r * L.ldn + n] = (row < c && n < N)
                                   ? src[(row0 + row) * N + n]
                                   : __float2bfloat16(0.f);
        }
      }
    };
    load_rows(Cs, Cm, r_base);
    for (int jt = 0; jt <= strip; ++jt) {
      if (jt > 0) __syncthreads();  // the previous B tile is consumed
      load_rows(Bt, Bm, jt * TILE);
      __syncthreads();
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      for (int ks = 0; ks < L.np / 16; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, Cs + (warp * 16 + (lane & 15)) * L.ldn + ks * 16 +
                       (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldsm_x4(b, Bt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * L.ldn +
                         ks * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], a, b[0], b[1]);
          mma_bf16(s[2 * np + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int a = 0; a < 2; ++a)
          *reinterpret_cast<float2*>(
              &Ws[(rr + 8 * a) * L.ldw + jt * TILE + 8 * j + tq]) =
              make_float2(s[j][2 * a], s[j][2 * a + 1]);
    }
  }
  __syncthreads();  // W complete; the phase-1 tiles are dead

  // ---- phase 2: per head, (W * factor) . x̄ over the j-tiles
  const int nj = cols / TILE;
  const int total = nh * nj;
  auto load_x = [&](int it, int buf) {  // x̄ tile (head, j-tile) of step it
    const int hh = it / nj, j0 = (it % nj) * TILE;
    bf16* dst = Xs + buf * TILE * L.ldx;
    const bf16* src = xbar + (size_t)(h0 + hh) * P;
    if ((P & 7) == 0) {
      const int chunks = L.pp / 8;
      for (int idx = tid; idx < TILE * chunks; idx += TC_THREADS) {
        const int r = idx / chunks, ch = idx % chunks;
        const int j = j0 + r;
        const bool ok = j < c && ch * 8 < P;
        cp_async16(dst + r * L.ldx + ch * 8,
                   ok ? src + (row0 + j) * H * P + ch * 8 : xbar, ok);
      }
    } else {
      for (int idx = tid; idx < TILE * L.pp; idx += TC_THREADS) {
        const int r = idx / L.pp, p = idx % L.pp;
        const int j = j0 + r;
        dst[r * L.ldx + p] = (j < c && p < P) ? src[(row0 + j) * H * P + p]
                                              : __float2bfloat16(0.f);
      }
    }
  };

  float acc[16][4];  // 16 rows x up to 128 columns of P
  const int ntp = L.pp / 16;
  load_x(0, 0);
  cp_async_commit();
  for (int it = 0; it < total; ++it) {
    const int hh = it / nj, jt = it % nj;
    if (it + 1 < total) {  // the next tile into the stage step it-1 used
      load_x(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (jt == 0) {
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    }
    const bf16* Xt = Xs + (it & 1) * TILE * L.ldx;
    const float* cumh = cums + hh * L.cw;
    // the factor's row term: cum_i of rows rr, rr+8 (y), cum_{c-1} (state)
    float cum_row[2];
    cum_row[0] = is_state ? cumh[c - 1] : cumh[r_base + rr];
    cum_row[1] = is_state ? cumh[c - 1] : cumh[r_base + rr + 8];
#pragma unroll
    for (int ks = 0; ks < TILE / 16; ++ks) {
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // a_e: row rr + 8(e&1), col + 8(e>>1)
        const int row = rr + 8 * (e & 1);
        const int j = jt * TILE + ks * 16 + tq + 8 * (e >> 1);
        const float2 w =
            *reinterpret_cast<const float2*>(&Ws[row * L.ldw + j]);
        const int i = r_base + row;
        const float f0 = (j < c && (is_state || j <= i))
                             ? expf(cum_row[e & 1] - cumh[j])
                             : 0.f;
        const float f1 = (j + 1 < c && (is_state || j + 1 <= i))
                             ? expf(cum_row[e & 1] - cumh[j + 1])
                             : 0.f;
        float h0v, l0v, h1v, l1v;
        split_bf16(w.x * f0, h0v, l0v);
        split_bf16(w.y * f1, h1v, l1v);
        ahi[e] = pack_bf16(h0v, h1v);
        alo[e] = pack_bf16(l0v, l1v);
      }
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        if (np < ntp) {
          uint32_t xb[4];
          ldsm_x4_t(xb, Xt + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 L.ldx +
                            np * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * np], ahi, xb[0], xb[1]);
          mma_bf16(acc[2 * np], alo, xb[0], xb[1]);
          mma_bf16(acc[2 * np + 1], ahi, xb[2], xb[3]);
          mma_bf16(acc[2 * np + 1], alo, xb[2], xb[3]);
        }
      }
    }
    if (jt == nj - 1) {
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int r = r_base + rr + 8 * a;
        if (r >= (is_state ? N : c)) continue;
        float* dst =
            is_state ? state + (((size_t)bn * H + h0 + hh) * N + r) * P
                     : y + ((row0 + r) * H + h0 + hh) * P;
#pragma unroll
        for (int nt = 0; nt < 16; ++nt)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int p = nt * 8 + tq + u;
            if (nt < 2 * ntp && p < P) dst[p] = acc[nt][2 * a + u];
          }
      }
    }
    __syncthreads();  // every warp is done with this stage of the ring
  }
}

int launch_f32(const void* xbar, const float* cum, const void* Bm,
               const void* Cm, float* y, float* state, int BN, int c, int H,
               int P, int N, cudaStream_t st) {
  const size_t bytes = smem_floats(N, P) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((c + TILE - 1) / TILE + 1, H, BN);
  ssd_chunk_kernel<<<grid, THREADS, bytes, st>>>(
      static_cast<const float*>(xbar), cum, static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), y, state, c, H, P, N);
  return (int)cudaGetLastError();
}

// Heads a bf16 block takes: as many as keep two waves of blocks, at most 8.
int heads_per_block(int BN, int c, int H, int N) {
  const int per_group = BN * ((c + TILE - 1) / TILE + (N + TILE - 1) / TILE);
  int HG = 1;
  while (HG < MAX_HG && HG < H &&
         (long long)per_group * ((H + 2 * HG - 1) / (2 * HG)) >=
             TARGET_BLOCKS)
    HG *= 2;
  return HG;
}

int launch_bf16(const void* xbar, const float* cum, const void* Bm,
                const void* Cm, float* y, float* state, int BN, int c, int H,
                int P, int N, cudaStream_t st) {
  const int HG = heads_per_block(BN, c, H, N);
  const size_t bytes = TcLayout(c, N, P).bytes(HG);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((c + TILE - 1) / TILE + (N + TILE - 1) / TILE, (H + HG - 1) / HG,
            BN);
  ssd_bf16_kernel<<<grid, TC_THREADS, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(xbar), cum,
      static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), y, state, c, H, P, N, HG);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the backward pass (f32, CUDA cores)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// sum over the 16 threads of a half-warp (the threads of one row group)
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o, 16);
  return x;
}

size_t bwd_smem_floats(int N, int P) {
  const int ldn = ((N + 3) & ~3) + 4, ldp = ((P + 3) & ~3) + 4;
  return (size_t)2 * TILE * ldn + (size_t)2 * TILE * ldp + (size_t)N * ldp +
         (size_t)TILE * LDM + 16 * TILE + 3 * TILE;
}

// One block a (chunk bn, group g of heads) walks the group's heads and
// writes the rows of dB and dC that they add up to into its partial (row
// (bn * groups + g) * c of dBp and dCp).  For the j-tile J (64 rows) and
// each head of the group: the state's share, then for every strip I >= J
// the tile of C.B (once for the group), and per head dM = dy x̄^T, the
// decay L (masked to j <= i BEFORE the exponential: exp(cum_i - cum_j)
// with i < j is never formed, so a strong decay cannot overflow), M = CB
// o L, dx̄ += M^T dy, dcum from Q = dM o M (rows +, columns -), and dCB =
// dM o L summed over the group; then dC[I] += dCB B[J], dB[J] += dCB^T
// C[I].  Thread (r, cg) owns rows 4r..4r+3 of a tile and columns cg +
// 16k.  dx̄, dcum and dC are summed into in place, each element by one
// thread between barriers, in a fixed order.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    ssd_bwd_kernel(const T* __restrict__ xbar, const float* __restrict__ cum,
                   const T* __restrict__ Bm, const T* __restrict__ Cm,
                   const float* __restrict__ dy,
                   const float* __restrict__ dstate,
                   float* __restrict__ dxbar, float* __restrict__ dcum,
                   float* __restrict__ dBp, float* __restrict__ dCp, int c,
                   int H, int P, int N, int HB) {
  const int ldn = ((N + 3) & ~3) + 4, np4 = (N + 3) & ~3;
  const int ldp = ((P + 3) & ~3) + 4, pp4 = (P + 3) & ~3;
  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);  // [TILE][ldn]: B[J]
  float* Cs = Bs + TILE * ldn;                  // [TILE][ldn]: C[I]
  float* Xs = Cs + TILE * ldn;                  // [TILE][ldp]: x̄[J, h]
  float* Ys = Xs + TILE * ldp;                  // [TILE][ldp]: dy[I, h]
  float* Ss = Ys + TILE * ldp;                  // [N][ldp]: dstate[h]
  float* Ms = Ss + N * ldp;                     // [TILE][LDM]
  float* colpart = Ms + TILE * LDM;             // [16][TILE]
  float* rowv = colpart + 16 * TILE;            // [TILE]
  float* cum_i = rowv + TILE;                   // [TILE]
  float* cum_j = cum_i + TILE;                  // [TILE]

  const int bn = blockIdx.x;
  const int h0 = blockIdx.y * HB, h1 = min(H, h0 + HB), hw = h1 - h0;
  const int tid = threadIdx.x, r = tid >> 4, cg = tid & 15;
  const size_t row0 = (size_t)bn * c;
  // the block's rows of the dB / dC partials
  const size_t part0 = ((size_t)bn * gridDim.y + blockIdx.y) * c * N;
  float* __restrict__ dB = dBp + part0;
  float* __restrict__ dC = dCp + part0;
  const int n_tiles = (c + TILE - 1) / TILE;

  for (size_t idx = tid; idx < (size_t)c * hw * P; idx += THREADS) {
    const size_t i = idx / ((size_t)hw * P), rest = idx % ((size_t)hw * P);
    dxbar[((row0 + i) * H + h0) * P + rest] = 0.f;
  }
  for (size_t idx = tid; idx < (size_t)c * hw; idx += THREADS)
    dcum[(row0 + idx / hw) * H + h0 + idx % hw] = 0.f;
  for (size_t idx = tid; idx < (size_t)c * N; idx += THREADS) dC[idx] = 0.f;

  // rows [t0, t0 + TILE) of a [c, width] slice into shared rows of stride
  // ld, zero past c and in the columns up to `padded`
  auto load_rows = [&](float* dst, int ld, auto src, size_t stride,
                       int t0, int width, int padded) {
    for (int idx = tid; idx < TILE * padded; idx += THREADS) {
      const int i = idx / padded, d = idx % padded;
      const int row = t0 + i;
      dst[i * ld + d] =
          (row < c && d < width) ? to_f(src[(row0 + row) * stride + d]) : 0.f;
    }
  };

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int j0 = jt * TILE;
    __syncthreads();  // the previous tile is done with Bs
    load_rows(Bs, ldn, Bm, (size_t)N, j0, N, np4);
    float dBa[4][MC] = {};

    // (1) the state's share: state = sum_j d_j B_j (x) x̄_j, d_j =
    // exp(cum_last - cum_j) <= 1
    for (int h = h0; h < h1; ++h) {
      __syncthreads();  // Xs, Ss, cum_j and rowv are free
      load_rows(Xs, ldp, xbar + h * P, (size_t)H * P, j0, P, pp4);
      for (int idx = tid; idx < N * pp4; idx += THREADS) {
        const int n = idx / pp4, p = idx % pp4;
        Ss[n * ldp + p] =
            p < P ? dstate[(((size_t)bn * H + h) * N + n) * P + p] : 0.f;
      }
      for (int i = tid; i < TILE; i += THREADS)
        cum_j[i] = j0 + i < c ? cum[(row0 + j0 + i) * H + h] : 0.f;
      const float cum_last = cum[(row0 + c - 1) * H + h];
      __syncthreads();
      // tt[j][n] = sum_p x̄[j][p] dstate[n][p]; uu[j][p] = sum_n B[j][n]
      // dstate[n][p]
      float tt[4][MC] = {}, uu[4][MC] = {};
      for (int p = 0; p < pp4; p += 4) {
        float4 x[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          x[a] = *reinterpret_cast<const float4*>(&Xs[(4 * r + a) * ldp + p]);
#pragma unroll
        for (int k = 0; k < MC; ++k) {
          const int n = cg + 16 * k;
          if (n >= N) break;
          const float4 sv = *reinterpret_cast<const float4*>(&Ss[n * ldp + p]);
#pragma unroll
          for (int a = 0; a < 4; ++a)
            tt[a][k] += x[a].x * sv.x + x[a].y * sv.y + x[a].z * sv.z +
                        x[a].w * sv.w;
        }
      }
      for (int n = 0; n < N; ++n) {
        float bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) bv[a] = Bs[(4 * r + a) * ldn + n];
#pragma unroll
        for (int k = 0; k < MC; ++k) {
          const int p = cg + 16 * k;
          if (p >= P) break;
          const float sv = Ss[n * ldp + p];
#pragma unroll
          for (int a = 0; a < 4; ++a) uu[a][k] = fmaf(bv[a], sv, uu[a][k]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = j0 + 4 * r + a;
        const float d = j < c ? expf(cum_last - cum_j[4 * r + a]) : 0.f;
        float dd = 0.f;
#pragma unroll
        for (int k = 0; k < MC; ++k) {
          const int n = cg + 16 * k;
          if (n >= N) break;
          dd = fmaf(Bs[(4 * r + a) * ldn + n], tt[a][k], dd);
          dBa[a][k] = fmaf(d, tt[a][k], dBa[a][k]);
        }
        dd = half_warp_sum(dd);
        if (cg == 0) rowv[4 * r + a] = dd * d;
        if (j < c) {
          float* dst = dxbar + ((row0 + j) * H + h) * P;
#pragma unroll
          for (int k = 0; k < MC; ++k) {
            const int p = cg + 16 * k;
            if (p >= P) break;
            dst[p] = fmaf(d, uu[a][k], dst[p]);
          }
        }
      }
      __syncthreads();
      if (tid < TILE && j0 + tid < c)
        dcum[(row0 + j0 + tid) * H + h] -= rowv[tid];
      __syncthreads();
      if (tid == 0) {  // d/dcum_last of every d_j in the tile
        float total = 0.f;
        for (int i = 0; i < TILE; ++i) total += rowv[i];
        dcum[(row0 + c - 1) * H + h] += total;
      }
    }

    // (2) the strips I >= J
    for (int it = jt; it < n_tiles; ++it) {
      const int i0 = it * TILE;
      __syncthreads();  // Cs and Ms are free
      load_rows(Cs, ldn, Cm, (size_t)N, i0, N, np4);
      __syncthreads();
      float cb[4][4] = {}, dcbt[4][4] = {};
      for (int n = 0; n < np4; n += 4) {
        float4 x[4], y4[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          x[a] = *reinterpret_cast<const float4*>(&Cs[(4 * r + a) * ldn + n]);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          y4[q] =
              *reinterpret_cast<const float4*>(&Bs[(cg + 16 * q) * ldn + n]);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            cb[a][q] += x[a].x * y4[q].x + x[a].y * y4[q].y +
                        x[a].z * y4[q].z + x[a].w * y4[q].w;
      }

      for (int h = h0; h < h1; ++h) {
        __syncthreads();  // Xs, Ys, Ms, cum_i/j, rowv, colpart are free
        load_rows(Ys, ldp, dy + h * P, (size_t)H * P, i0, P, pp4);
        load_rows(Xs, ldp, xbar + h * P, (size_t)H * P, j0, P, pp4);
        for (int i = tid; i < TILE; i += THREADS) {
          cum_i[i] = i0 + i < c ? cum[(row0 + i0 + i) * H + h] : 0.f;
          cum_j[i] = j0 + i < c ? cum[(row0 + j0 + i) * H + h] : 0.f;
        }
        __syncthreads();
        float dm[4][4] = {};
        for (int p = 0; p < pp4; p += 4) {
          float4 x[4], y4[4];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            x[a] =
                *reinterpret_cast<const float4*>(&Ys[(4 * r + a) * ldp + p]);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            y4[q] =
                *reinterpret_cast<const float4*>(&Xs[(cg + 16 * q) * ldp + p]);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              dm[a][q] += x[a].x * y4[q].x + x[a].y * y4[q].y +
                          x[a].z * y4[q].z + x[a].w * y4[q].w;
        }
        float colq[4] = {};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int ii = 4 * r + a, i = i0 + ii;
          float rowq = 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int jj = cg + 16 * q, j = j0 + jj;
            const bool keep = i < c && j <= i;
            const float L = keep ? expf(cum_i[ii] - cum_j[jj]) : 0.f;
            const float m = cb[a][q] * L;
            const float qv = dm[a][q] * m;
            dcbt[a][q] = fmaf(dm[a][q], L, dcbt[a][q]);
            Ms[ii * LDM + jj] = m;
            rowq += qv;
            colq[q] += qv;
          }
          rowq = half_warp_sum(rowq);
          if (cg == 0) rowv[ii] = rowq;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) colpart[r * TILE + cg + 16 * q] = colq[q];
        __syncthreads();
        if (tid < TILE) {
          if (i0 + tid < c) dcum[(row0 + i0 + tid) * H + h] += rowv[tid];
          float cs = 0.f;
          for (int rr = 0; rr < 16; ++rr) cs += colpart[rr * TILE + tid];
          if (j0 + tid < c) dcum[(row0 + j0 + tid) * H + h] -= cs;
        }
        // dx̄[J, h] += M^T dy[I, h]
        float acc[4][MC] = {};
        for (int i = 0; i < TILE; ++i) {
          float mv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) mv[a] = Ms[i * LDM + 4 * r + a];
#pragma unroll
          for (int k = 0; k < MC; ++k) {
            const int p = cg + 16 * k;
            if (p >= P) break;
            const float yv = Ys[i * ldp + p];
#pragma unroll
            for (int a = 0; a < 4; ++a) acc[a][k] = fmaf(mv[a], yv, acc[a][k]);
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int j = j0 + 4 * r + a;
          if (j >= c) continue;
          float* dst = dxbar + ((row0 + j) * H + h) * P;
#pragma unroll
          for (int k = 0; k < MC; ++k) {
            const int p = cg + 16 * k;
            if (p >= P) break;
            dst[p] += acc[a][k];
          }
        }
      }

      // dC[I] += dCB B[J], dB[J] += dCB^T C[I], dCB summed over the group
      __syncthreads();
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) Ms[(4 * r + a) * LDM + cg + 16 * q] =
            dcbt[a][q];
      __syncthreads();
      float acc[4][MC] = {};
      for (int j = 0; j < TILE; ++j) {
        float w[4], u[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          w[a] = Ms[(4 * r + a) * LDM + j];  // dCB[i = 4r+a][j]
          u[a] = Ms[j * LDM + 4 * r + a];    // dCB[i = j][j' = 4r+a]
        }
#pragma unroll
        for (int k = 0; k < MC; ++k) {
          const int n = cg + 16 * k;
          if (n >= N) break;
          const float bv = Bs[j * ldn + n], cv = Cs[j * ldn + n];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            acc[a][k] = fmaf(w[a], bv, acc[a][k]);
            dBa[a][k] = fmaf(u[a], cv, dBa[a][k]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + 4 * r + a;
        if (i >= c) continue;
#pragma unroll
        for (int k = 0; k < MC; ++k) {
          const int n = cg + 16 * k;
          if (n >= N) break;
          dC[(size_t)i * N + n] += acc[a][k];
        }
      }
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = j0 + 4 * r + a;
      if (j >= c) continue;
#pragma unroll
      for (int k = 0; k < MC; ++k) {
        const int n = cg + 16 * k;
        if (n >= N) break;
        dB[(size_t)j * N + n] = dBa[a][k];
      }
    }
  }
}

// dB, dC [BN][c * N] = the sums over g of part[2][BN][groups][c * N] (dB's
// partials, then dC's), g in order
__global__ void ssd_bwd_fold_kernel(const float* __restrict__ part,
                                    float* __restrict__ dB,
                                    float* __restrict__ dC, int BN,
                                    int groups, int cN) {
  const size_t per = (size_t)BN * cN;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= per) return;
  const float* src = part + blockIdx.y * per * groups +
                     (idx / cN) * groups * (size_t)cN + idx % cN;
  float acc = 0.f;
  for (int g = 0; g < groups; ++g) acc += src[(size_t)g * cN];
  (blockIdx.y ? dC : dB)[idx] = acc;
}

// Heads a backward block walks: few enough that BN x groups fills one
// wave of blocks, one a SM (its shared memory holds one).
constexpr int BWD_TARGET_BLOCKS = 132;
int bwd_heads_per_block(int BN, int H) {
  const int want = (BWD_TARGET_BLOCKS + BN - 1) / BN;
  const int groups = want < H ? want : H;
  return (H + groups - 1) / groups;
}

int bwd_groups(int BN, int H) {
  const int HB = bwd_heads_per_block(BN, H);
  return (H + HB - 1) / HB;
}

template <typename T>
int launch_bwd(const void* xbar, const float* cum, const void* Bm,
               const void* Cm, const float* dy, const float* dstate,
               float* dxbar, float* dcum, float* dB, float* dC, float* work,
               int BN, int c, int H, int P, int N, cudaStream_t st) {
  const int HB = bwd_heads_per_block(BN, H), groups = bwd_groups(BN, H);
  if (groups > 1 && work == nullptr) return (int)cudaErrorInvalidValue;
  const size_t bytes = bwd_smem_floats(N, P) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const size_t per = (size_t)BN * groups * c * N;
  ssd_bwd_kernel<T><<<dim3(BN, groups), THREADS, bytes, st>>>(
      static_cast<const T*>(xbar), cum, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), dy, dstate, dxbar, dcum,
      groups > 1 ? work : dB, groups > 1 ? work + per : dC, c, H, P, N, HB);
  if (groups > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t out = (size_t)BN * c * N;
    ssd_bwd_fold_kernel<<<dim3((unsigned)((out + 255) / 256), 2), 256, 0,
                          st>>>(work, dB, dC, BN, groups, c * N);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// xbar [BN,c,H,P], Bm/Cm [BN,c,N] of dtype `dtype` (0 f32: CUDA-core
// kernel, 1 bf16: tensor-core kernel, 16-byte aligned), cum
// [BN,c,H] f32 -> y [BN,c,H,P], state [BN,H,N,P] f32; all contiguous.
// 1 <= N, P <= 128; BN, H < 65536; c >= 1.
int repro_ssd_chunk_dual(const void* xbar, const float* cum, const void* Bm,
                         const void* Cm, float* y, float* state, int BN,
                         int c, int H, int P, int N, int dtype,
                         void* stream) {
  if (BN < 1 || c < 1 || H < 1 || P < 1 || N < 1 || P > MAX_NP ||
      N > MAX_NP || BN > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return launch_f32(xbar, cum, Bm, Cm, y, state, BN, c, H, P, N, st);
  if (dtype == DTYPE_BF16)
    return launch_bf16(xbar, cum, Bm, Cm, y, state, BN, c, H, P, N, st);
  return (int)cudaErrorInvalidValue;
}

// The block of the kernel a call of `dtype` at shape (BN, c, H, P, N)
// launches, with the dynamic shared bytes its launcher requests:
// out [ATTR_CELLS] as repro_block_attrs (attrs.cuh).
int repro_ssd_block_attrs(int dtype, int BN, int c, int H, int P, int N,
                          int* out) {
  if (BN < 1 || c < 1 || H < 1 || P < 1 || N < 1 || P > MAX_NP ||
      N > MAX_NP)
    return (int)cudaErrorInvalidValue;
  if (dtype == DTYPE_F32)
    return (int)repro_block_attrs((const void*)ssd_chunk_kernel, THREADS,
                                  (int)(smem_floats(N, P) * sizeof(float)),
                                  out);
  if (dtype == DTYPE_BF16)
    return (int)repro_block_attrs(
        (const void*)ssd_bf16_kernel, TC_THREADS,
        (int)TcLayout(c, N, P).bytes(heads_per_block(BN, c, H, N)), out);
  return (int)cudaErrorInvalidValue;
}

// Head groups of a backward call at (BN, H): with more than one, the call
// needs a work buffer of 2 * BN * groups * c * N floats.
int repro_ssd_bwd_groups(int BN, int H) {
  if (BN < 1 || H < 1) return -1;
  return bwd_groups(BN, H);
}

// The backward pass of repro_ssd_chunk_dual: the inputs as above, dy
// [BN,c,H,P] and dstate [BN,H,N,P] f32 (the cotangents of y and state)
// -> dxbar [BN,c,H,P], dcum [BN,c,H], dB, dC [BN,c,N], all f32.  `work`
// holds the head groups' dB / dC partials (repro_ssd_bwd_groups; null for
// one group).  A launch of BN x groups blocks on `stream`, then, for more
// than one group, one that folds the partials.
int repro_ssd_chunk_dual_bwd(const void* xbar, const float* cum,
                             const void* Bm, const void* Cm, const float* dy,
                             const float* dstate, float* dxbar, float* dcum,
                             float* dB, float* dC, float* work, int BN, int c,
                             int H, int P, int N, int dtype, void* stream) {
  if (BN < 1 || c < 1 || H < 1 || P < 1 || N < 1 || P > MAX_NP ||
      N > MAX_NP || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return launch_bwd<float>(xbar, cum, Bm, Cm, dy, dstate, dxbar, dcum, dB,
                             dC, work, BN, c, H, P, N, st);
  if (dtype == DTYPE_BF16)
    return launch_bwd<__nv_bfloat16>(xbar, cum, Bm, Cm, dy, dstate, dxbar,
                                     dcum, dB, dC, work, BN, c, H, P, N, st);
  return (int)cudaErrorInvalidValue;
}

// The backward kernel's block for `dtype` at (P, N): out [ATTR_CELLS] as
// repro_block_attrs.
int repro_ssd_bwd_block_attrs(int dtype, int P, int N, int* out) {
  if (P < 1 || N < 1 || P > MAX_NP || N > MAX_NP)
    return (int)cudaErrorInvalidValue;
  const int bytes = (int)(bwd_smem_floats(N, P) * sizeof(float));
  if (dtype == DTYPE_F32)
    return (int)repro_block_attrs((const void*)ssd_bwd_kernel<float>,
                                  THREADS, bytes, out);
  if (dtype == DTYPE_BF16)
    return (int)repro_block_attrs((const void*)ssd_bwd_kernel<__nv_bfloat16>,
                                  THREADS, bytes, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
