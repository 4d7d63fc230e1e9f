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
// The entry point launches on the given stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of its launch.

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

}  // extern "C"
