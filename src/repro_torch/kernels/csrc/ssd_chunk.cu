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
// Inputs are upcast to f32 (x̄, B, C may be bf16; cum is f32); all math and
// both outputs are f32.  The operation order is the reference's: the
// decay matrix entry multiplies the C.B product (CB * L), and the state
// scales B by the decay before the product with x̄.
//
// Design.  The Pallas kernel holds the whole [c, c] f32 decay matrix in
// VMEM: 256 KB at c = 256, more than the 227 KB a Hopper block can have.
// This kernel never forms it.  The grid is (strips + 1, H, BN): block x < S
// (S = ceil(c/64) strips) owns rows i of one 64-row strip of y and walks
// the 64-row j-tiles with j <= i only; per tile it forms the 64x64 product
// C_i . B_j in registers, scales it by exp(cum_i - cum_j) (0 above the
// diagonal and past c), stages it in shared memory, and multiplies it into
// that tile of x̄, accumulating y in registers.  Block x = S computes the
// chunk state by walking all j-tiles.  So each launch is one grid and the
// state costs no second pass.  Thread (r, cg) owns rows 4r..4r+3 of a
// strip and columns cg, cg+16, ... of the 64-wide M tile and of y's P
// columns; for the state, rows tn, tn+16, ... of N and columns tp, tp+16,
// ... of P.  Everything is f32 FMA on the CUDA cores.  Shared memory, in
// floats: C strip and B tile 64*(N'+4) each (N' = N rounded up to 4), the
// x̄ tile 64*P, the M tile 64*68 and two 64-entry cum vectors: 102 KB at
// N = 128, P = 64, two blocks to an SM.  c, N (<= 128) and P (<= 128) are
// run-time arguments; a ragged c (not a multiple of 64) is masked.
//
// What bounds it on the H100: operations.  At the serving path's shape
// (BN = 8 chunks of c = 256, H = 48, P = 64, N = 128, bf16 inputs) the
// function needs the causal half of C.B once per chunk (c(c+1)/2*N*2
// FLOP), and per head the causal half of M.x̄ (c(c+1)/2*P*2) and the state
// (c*N*P*2): 3.3 GFLOP of f32 math over 67 TFLOP/s = 0.049 ms, against
// 52 MB of inputs and f32 outputs over 3.35 TB/s = 0.016 ms.  This kernel
// recomputes C.B for every head, as the Pallas kernel does (6.5 GFLOP in
// all); sharing it across heads, and bf16 tensor cores, are later work.
// Its measured time is in PERF.md (chip_smoke.py).
//
// The entry point launches on the given stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;      // rows of a strip of y, rows of a j-tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int LDM = TILE + 4;
constexpr int MAX_NP = 128;   // largest N and P the register tiles hold
constexpr int MC = MAX_NP / 16;

constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

size_t smem_floats(int N, int P) {
  const int ldn = ((N + 3) & ~3) + 4;
  return (size_t)2 * TILE * ldn + (size_t)TILE * P + (size_t)TILE * LDM +
         2 * TILE;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    ssd_chunk_kernel(const T* __restrict__ xbar, const float* __restrict__ cum,
                     const T* __restrict__ Bm, const T* __restrict__ Cm,
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
      float b = (j < c && n < N) ? to_f(Bm[(row0 + j) * N + n]) : 0.f;
      if (scale_by_decay && j < c) b *= expf(cum_last - cum_j[jj]);
      Bs[jj * ldn + n] = b;
    }
    for (int idx = tid; idx < TILE * P; idx += THREADS) {
      const int jj = idx / P, p = idx % P;
      const int j = j0 + jj;
      Xs[jj * P + p] = j < c ? to_f(xbar[((row0 + j) * H + h) * P + p]) : 0.f;
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
    Cs[ii * ldn + n] = (i < c && n < N) ? to_f(Cm[(row0 + i) * N + n]) : 0.f;
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

template <typename T>
int launch(const void* xbar, const float* cum, const void* Bm, const void* Cm,
           float* y, float* state, int BN, int c, int H, int P, int N,
           cudaStream_t st) {
  const size_t bytes = smem_floats(N, P) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((c + TILE - 1) / TILE + 1, H, BN);
  ssd_chunk_kernel<T><<<grid, THREADS, bytes, st>>>(
      static_cast<const T*>(xbar), cum, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), y, state, c, H, P, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// xbar [BN,c,H,P], Bm/Cm [BN,c,N] of dtype `dtype` (0 f32, 1 bf16), cum
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
    return launch<float>(xbar, cum, Bm, Cm, y, state, BN, c, H, P, N, st);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(xbar, cum, Bm, Cm, y, state, BN, c, H, P, N,
                                 st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
