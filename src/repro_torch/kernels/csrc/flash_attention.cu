// B4: GQA flash attention forward of the PyTorch port, CUDA C++ for sm_90a.
//
// repro_flash_attention replaces repro/kernels/flash_attention.py
// flash_attention (Pallas body _kernel).  Same function, same rounding
// points:
//   * q is multiplied by scale = hd^-0.5 in q's dtype (the wrapper passes
//     the scale already rounded to that dtype; the product is rounded back
//     to it here), then every logit accumulates in f32;
//   * the causal mask is top-left, q_pos >= k_pos, and masked logits are
//     -1e30 (not -inf); keys at k >= Sk (a ragged tail) are masked too;
//   * the online softmax keeps (m, l, acc) in f32; P is rounded to V's
//     dtype before the PV product, l sums the unrounded P;
//   * out = acc / max(l, 1e-30), rounded to q's dtype;
//   * query head h reads KV head h / G, G = Hq / Hkv.
//
// Q and K have head dim HD, V and out HDV.  The instances are the pairs
// (HD, HDV) of REPRO_FLASH_PAIRS: (32, 32), (64, 64) and (128, 128) for
// GQA, (192, 128) for MLA's prefill (repro/models/attention.py:257-279:
// q and k are [nope 128; rope 64], v is 128 wide), and (48, 32) for MLA
// at the configs' smoke width.  Any other pair is refused.
//
// Two kernels, chosen by dtype (a fixed dispatch: neither falls back to
// the other):
//
// bf16: flash_bf16_kernel, on the tensor cores.  Both products are
// mma.sync.m16n8k16 bf16 x bf16 -> f32 (mma.cuh), which matches the
// reference's dot_general(..., preferred_element_type=f32) on bf16
// operands up to the order of the sums.  One block of 4 warps owns 64
// "packed" rows of one (batch, KV head): packed row m is query m / G of
// query head hk*G + m % G, so the G = Hq/Hkv query heads of a KV head share
// every K/V tile the block loads (at 16/8 heads that halves K/V traffic),
// and the causal extent of a tile stays one range of query positions.
// Each warp owns 16 rows.  The scaled Q tile sits in registers as A
// fragments for the whole walk; 64-key tiles of K and V arrive through
// cp.async into a two-stage ring (K of tile t+1 loads while tile t's logits
// are formed, V of t+1 while t's PV runs).  QK^T reads K with ldmatrix as
// the B operand; the f32 logit fragments, masked and exponentiated, are
// rounded to bf16 pairs and become PV's A fragments in registers
// (FlashAttention-2's layout), with V read by ldmatrix.trans.  Rows of
// every shared tile are padded by 16 bytes, which keeps ldmatrix free of
// bank conflicts.  Shared memory: 3 tiles of 64 x (HD+8) bf16 (Q, two
// stages of K) and 2 of 64 x (HDV+8) (V), 87 KB at 128/128 and 109 KB at
// 192/128, so two blocks (8 warps) fit on an SM.  At 192/128 a thread
// holds 48 registers of Q fragments and 64 of output accumulators.  The query tile is 64
// packed rows: the serving path's prompts of 285-1781 tokens at 16/8 heads
// give 72-448 blocks, 0.3-1.7 waves of 264 resident blocks on the 132 SMs,
// and 128-row tiles (two m-tiles a warp, as FlashAttention-2 takes them)
// need 255 registers and spill at hd = 128; measured on the H100 they were
// slower at S = 2048 (PERF.md).  This is the mma.sync design, not
// wgmma: its fragments are register-resident and need no shared-memory
// descriptors, so the accumulator-to-A-operand reuse is direct.  wgmma
// (the full tensor-core rate) is later work.
//
// f32: flash_f32_kernel, f32 FMA on the CUDA cores.  The reference's f32
// path needs f32 products (the tests hold it to 2e-6), which neither bf16
// nor TF32 tensor cores give.  One block of 256 threads owns one (batch,
// query head, 64-row query tile) and walks 64-key tiles of K and V through
// shared memory.  Thread (r, c) owns rows 4r..4r+3 of the tile and the
// columns c, c+16, ...; a row's max and sum are reduced across a half-warp
// with shuffles.  Shared memory: (HD+4 + max(HD,HDV)+4 + 68)*64*4 bytes,
// 85 KB at 128/128 and 115 KB at 192/128, where only one block fits an
// SM (min_blocks: the launch bound asks for two where two fit).
//
// Causal tiles that lie wholly above the diagonal are skipped by both.
// Key tile 0 holds position 0, which every row may see, so every row's
// running max is finite after it; a skipped tile would have given
// exp(-1e30 - m) = 0 to every P and a factor exp(0) = 1 to acc and l, so
// skipping changes no bit.  Query tiles are issued in reverse order so the
// longest walks start first.
//
// What bounds it on the H100: operations.  At the serving path's shape
// (B=1, 16 query heads over 8 KV heads, hd=128, S=2048, bf16, causal) the
// function needs 2*2*S*S/2*hd*16 = 17.2 GFLOP against 25 MB of Q, K, V and
// out, so the bound is 17.2 GFLOP at 989 TFLOP/s (bf16 tensor cores) =
// 0.017 ms, above the 0.008 ms of bytes.  mma.sync reaches a part of that
// rate (wgmma alone reaches all of it); the bf16 kernel's measured time
// and the f32 kernel's are in PERF.md (chip_smoke.py).
//
// The forward kernels take an optional lse [B,Hq,Sq] f32 (m + log l of
// each row): training's launch asks for it, serving's passes null and the
// store is skipped, so the output is bit-identical either way.
//
// The backward pass, repro_flash_attention_bwd, replaces no TPU kernel:
// the reference trains through jax.grad of blocked_attention
// (repro/models/layers.py), the XLA oracle of its forward.  It is
// FlashAttention-2's, three launches, no float atomics: D = rowsum(dO o
// O) in f32, a warp a row (flash_bwd_dot_kernel), then a dK/dV kernel and
// a dQ kernel, chosen by dtype as the forward's are (neither falls back
// to the other).  Both recompute P = exp(S - lse) from the forward's lse
// under the forward's mask, with q*scale rounded to q's dtype as the
// forward rounds it, and dS = P o (dP - D); dV = P^T dO takes P rounded
// to V's dtype, as the forward's PV product does.
//
// bf16: flash_bwd_dkdv_bf16_kernel and flash_bwd_dq_bf16_kernel, every
// product on mma.sync.m16n8k16 (mma.cuh), every sum in f32; P and dS are
// rounded to bf16 where they enter their products (A fragments straight
// from the C fragments, as the forward's P).
//   * dK/dV: one block of 4 warps per (64-key tile, KV head, batch), 16
//     keys a warp, walks the G query heads of its group and, for each, the
//     query tiles that see its keys (causal: from the key tile's own on),
//     so it alone writes its rows of dK and dV.  K and V stay in shared
//     memory; tiles of q (scaled and rounded in shared memory by the
//     thread that copied them), dO, lse and D arrive through cp.async into
//     a two-stage ring, the next tile's copies running under this tile's
//     products.  Per tile: S^T = K (q*scale)^T, P^T, dP^T = V dO^T, dS^T,
//     dV += P^T dO and dK += dS^T (q*scale), dO and q*scale read by
//     ldmatrix.trans for the last two.  A thread sums 16 x HD of dK and 16
//     x HDV of dV in registers: 64 + 64 at 128/128, 96 + 64 at 192/128,
//     where the query tile is 32 rows (tc_bwd_span) so that S^T and dP^T
//     take 16 registers each, not 32.  Shared memory: K, V and two stages
//     of QT rows of Q and dO, 105,472 bytes at 128/128 (QT 64) and 86,528
//     at 192/128 (QT 32): two blocks a SM.
//   * dQ: one block of 4 warps per 64 packed rows of one (KV head, batch),
//     packed as the forward packs them, so the G heads of a group share
//     every K/V tile; q*scale sits in registers as A fragments, each
//     row's lse and D in registers, the block's dO rows in their own
//     shared tile (A fragments read per sub-step: 8 ldmatrix against ~190
//     mma a tile at 128/128; held in registers as well they made the
//     192/128 instance spill), and 64-key tiles of K and V come through a
//     two-stage cp.async ring (the staged q borrows its second stage).
//     Per tile, in sub-steps of tc_bwd_span keys: S, dP = dO V^T, dS, dQ
//     += dS K with K by ldmatrix.trans; out dQ*scale.  Causal tiles
//     wholly above the diagonal are skipped, as in the forward.
//     Registers: 32 of q fragments and 64 of dQ at 128/128, 48 and 96 at
//     192/128 (32-key sub-steps).  Shared memory: 87,040 bytes at
//     128/128, 103,424 at 192/128: two blocks a SM.
//   Both grids are (KV head, batch, tile), the tile slowest, so the
//   longest causal walks of every (KV head, batch) are issued first: key
//   tile 0 for dK/dV, the last 64 packed rows for dQ (on the H100 at
//   qwen3's shape 1.025 ms, against 1.191 with the tile fastest; PERF.md).
//   The grid's z caps the tiles at 65535: Sk, and G * Sq, at most
//   4,194,240.  At 32/32, 48/32, 64/64, 128/128 and 192/128: shared
//   bytes dK/dV 31,744, 37,888, 56,320, 105,472, 86,528 and dQ 25,600,
//   29,696, 46,080, 87,040, 103,424 (analysis/smem.py models them);
//   ptxas's registers a thread, no spill in any instance, dK/dV 158, 182,
//   202, 255, 255 and dQ 162, 201, 212, 244, 251 (chip_smoke.py's build
//   line prints them).
//
// f32: flash_bwd_dkdv_kernel and flash_bwd_dq_kernel, unchanged since
// they were written: the same walks with 256 threads, every tile widened
// to f32 in shared memory and f32 FMA on the CUDA cores, because float32
// gradients need f32 products to meet 1e-4 and neither bf16 nor TF32
// tensor cores give that.  dK/dV 170 KB at 128/128 and 203 KB at 192/128,
// dQ 153 and 186 KB, one block a SM; dQ one block per (64-query tile,
// query head, batch).
//
// What bounds it: operations, 2 FLOP a multiply-add of the recomputed
// logits (hd), dV, dP (hd_v each), dQ and dK (hd each) over the kept
// pairs: 171.9 GFLOP at qwen3's training shape (4 x 2048, 16/8 heads, hd
// 128, causal), 0.174 ms at the bf16 tensor cores' 989 TFLOP/s.  The two
// bf16 kernels recompute S and dP, so they issue 7 products against the
// bound's 5, about 1.4x its FLOP, on mma.sync, which reaches a part of
// that rate (wgmma alone reaches all of it); PERF.md has the times.
//
// The entry points launch on the given stream, allocate nothing, do not
// synchronise, and return cudaGetLastError() of their launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attrs.cuh"
#include "mma.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 row groups x 16 column groups
constexpr int LDP = BK + 4;   // row stride of the P tile (floats)
constexpr float NEG_INF = -1e30f;

constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

// an SM's shared memory (228 KB) and what the runtime reserves a block:
// a kernel's launch bound asks for two blocks a SM where two fit
constexpr int SMEM_PER_SM = 233472;
constexpr int SMEM_RESERVED = 1024;

constexpr int min_blocks(size_t smem) {
  return 2 * ((int)smem + SMEM_RESERVED) <= SMEM_PER_SM ? 2 : 1;
}

// max / sum over the 16 threads of a half-warp that share a row group
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o, 16));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o, 16);
  return x;
}

template <int HD, int HDV>
constexpr size_t smem_bytes() {  // Q, K or V, and P
  return (size_t)(BQ * (HD + 4) + BK * ((HD > HDV ? HD : HDV) + 4) +
                  BQ * LDP) *
         sizeof(float);
}

template <int HD, int HDV>
__global__ void __launch_bounds__(THREADS,
                                  min_blocks(smem_bytes<HD, HDV>()))
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
                     int causal, float scale) {
  constexpr int LD = HD + 4;    // row stride of the Q and K tiles (floats)
  constexpr int LDV = HDV + 4;  // row stride of the V tile
  constexpr int NC = HDV / 16;  // acc columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][LD], scaled q
  float* KVs = Qs + BQ * LD;  // [BK][LD] K, then [BK][LDV] V
  float* Ps = KVs + BK * (LD > LDV ? LD : LDV);  // [BQ][LDP]

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal walks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const float* qh = q + ((size_t)b * Hq + h) * Sq * HD;
  const float* kh = k + ((size_t)b * Hkv + hk) * Sk * HD;
  const float* vh = v + ((size_t)b * Hkv + hk) * Sk * HDV;
  float* oh = out + ((size_t)b * Hq + h) * Sq * HDV;

  const int tid = threadIdx.x;
  const int r = tid >> 4;   // rows 4r .. 4r+3
  const int cg = tid & 15;  // columns cg + 16j

  for (int idx = tid; idx < BQ * HD; idx += THREADS) {
    const int i = idx / HD, d = idx % HD;
    const int qi = q0 + i;
    Qs[i * LD + d] =
        qi < Sq ? qh[(size_t)qi * HD + d] * scale : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = NEG_INF;
    l[a] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[a][j] = 0.f;
  }

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) {  // tiles past the block's last row are all masked
    const int last = (min(q0 + BQ, Sq) - 1) / BK + 1;
    n_tiles = min(n_tiles, last);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // previous tile's PV is done with KVs and Ps
    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int j = idx / HD, d = idx % HD;
      const int kj = k0 + j;
      KVs[j * LD + d] = kj < Sk ? kh[(size_t)kj * HD + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qa[a] = *reinterpret_cast<const float4*>(&Qs[(4 * r + a) * LD + d]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kb[c] =
            *reinterpret_cast<const float4*>(&KVs[(cg + 16 * c) * LD + d]);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[a][c] = fmaf(qa[a].x, kb[c].x, s[a][c]);
          s[a][c] = fmaf(qa[a].y, kb[c].y, s[a][c]);
          s[a][c] = fmaf(qa[a].z, kb[c].z, s[a][c]);
          s[a][c] = fmaf(qa[a].w, kb[c].w, s[a][c]);
        }
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qi = q0 + 4 * r + a;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + cg + 16 * c;
        if (kj >= Sk || (causal && qi < kj)) s[a][c] = NEG_INF;
        mx = fmaxf(mx, s[a][c]);
      }
      const float m_new = fmaxf(m[a], row_max(mx));
      const float corr = expf(m[a] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[a][c] - m_new);
        sum += p;
        Ps[(4 * r + a) * LDP + cg + 16 * c] = p;
      }
      l[a] = l[a] * corr + row_sum(sum);
      m[a] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[a][j] *= corr;
    }
    __syncthreads();  // all logits read KVs as K; all of P written

    for (int idx = tid; idx < BK * HDV; idx += THREADS) {
      const int j = idx / HDV, d = idx % HDV;
      const int kj = k0 + j;
      KVs[j * LDV + d] = kj < Sk ? vh[(size_t)kj * HDV + d] : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        pa[a] = *reinterpret_cast<const float4*>(&Ps[(4 * r + a) * LDP + j]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float v0 = KVs[(j + 0) * LDV + cg + 16 * c];
        const float v1 = KVs[(j + 1) * LDV + cg + 16 * c];
        const float v2 = KVs[(j + 2) * LDV + cg + 16 * c];
        const float v3 = KVs[(j + 3) * LDV + cg + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          acc[a][c] = fmaf(pa[a].x, v0, acc[a][c]);
          acc[a][c] = fmaf(pa[a].y, v1, acc[a][c]);
          acc[a][c] = fmaf(pa[a].z, v2, acc[a][c]);
          acc[a][c] = fmaf(pa[a].w, v3, acc[a][c]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qi = q0 + 4 * r + a;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      oh[(size_t)qi * HDV + cg + 16 * c] = acc[a][c] / den;
    if (lse != nullptr && cg == 0)
      lse[((size_t)b * Hq + h) * Sq + qi] = m[a] + logf(l[a]);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;             // 16 packed rows each
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_ROWS = 16 * TC_WARPS;  // packed rows per block
constexpr int TC_KEYS = 64;             // keys per K/V tile

template <int HD, int HDV>
constexpr size_t tc_smem_bytes() {  // Q, and K and V in two stages each
  return (size_t)((TC_ROWS + 2 * TC_KEYS) * (HD + 8) +
                  2 * TC_KEYS * (HDV + 8)) *
         sizeof(__nv_bfloat16);
}

template <int HD, int HDV>
__global__ void __launch_bounds__(TC_THREADS,
                                  min_blocks(tc_smem_bytes<HD, HDV>()))
    flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int Hq, int Hkv, int Sq,
                      int Sk, int causal, float scale) {
  using namespace repro_mma;
  using bf16 = __nv_bfloat16;
  constexpr int LDS = HD + 8;      // row stride of the Q and K tiles
  constexpr int LDSV = HDV + 8;    // row stride of the V tiles (bf16)
  constexpr int CHUNKS = HD / 8;   // 16-byte chunks of a Q or K row
  constexpr int KS = HD / 16;      // k-steps of QK^T
  constexpr int NT = HDV / 8;      // 8-column tiles of the output
  constexpr int TILE = TC_KEYS * LDS;
  constexpr int TILE_V = TC_KEYS * LDSV;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // [TC_ROWS][LDS]
  bf16* Ks = Qs + TC_ROWS * LDS;              // [2][TC_KEYS][LDS]
  bf16* Vs = Ks + 2 * TILE;                   // [2][TC_KEYS][LDSV]

  const int G = Hq / Hkv;
  const int rows = G * Sq;                                   // packed rows
  const int m0 = (gridDim.x - 1 - blockIdx.x) * TC_ROWS;  // longest first
  const int hk = blockIdx.y, b = blockIdx.z;
  const bf16* kh = k + ((size_t)b * Hkv + hk) * Sk * HD;
  const bf16* vh = v + ((size_t)b * Hkv + hk) * Sk * HDV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int idx = tid; idx < TC_ROWS * CHUNKS; idx += TC_THREADS) {
    const int r = idx / CHUNKS, ch = idx % CHUNKS;
    const int m = m0 + r;
    const bool ok = m < rows;
    const int qi = ok ? m / G : 0, g = ok ? m % G : 0;
    cp_async16(Qs + r * LDS + ch * 8,
               q + (((size_t)b * Hq + hk * G + g) * Sq + qi) * HD + ch * 8,
               ok);
  }
  // a tile of TC_KEYS rows of `width` (HD for K, HDV for V) into rows of
  // stride `ld`
  auto load_tile = [&](bf16* dst, const bf16* src, int k0, int width,
                       int ld) {
    const int chunks = width / 8;
    for (int idx = tid; idx < TC_KEYS * chunks; idx += TC_THREADS) {
      const int r = idx / chunks, ch = idx % chunks;
      const bool ok = k0 + r < Sk;
      cp_async16(dst + r * ld + ch * 8,
                 src + (size_t)(ok ? k0 + r : 0) * width + ch * 8, ok);
    }
  };

  // query positions: the block's first, and the last its rows reach
  const int q_first = m0 / G;
  int n_tiles = (Sk + TC_KEYS - 1) / TC_KEYS;
  if (causal)  // tiles past the block's last query are all masked
    n_tiles = min(n_tiles, (min(m0 + TC_ROWS, rows) - 1) / G / TC_KEYS + 1);

  load_tile(Ks, kh, 0, HD, LDS);
  cp_async_commit();  // group: Q and K tile 0
  load_tile(Vs, vh, 0, HDV, LDSV);
  cp_async_commit();  // group: V tile 0
  cp_async_wait<1>();
  __syncthreads();

  // Q as A fragments, times the scale and rounded back to bf16
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    ldsm_x4(qf[ks], Qs + (warp * 16 + (lane & 15)) * LDS + ks * 16 +
                        (lane >> 4) * 8);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack_bf16(qf[ks][e]);
      qf[ks][e] = pack_bf16(f.x * scale, f.y * scale);
    }
  }

  // this thread's rows: packed rows r0 and r0 + 8 of the warp's 16
  const int r0 = m0 + warp * 16 + (lane >> 2);
  const int qpos[2] = {r0 / G, (r0 + 8) / G};
  const int tq = 2 * (lane & 3);  // first of the thread's column pair
  float o[NT][4], m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const bf16* Kt = Ks + (t & 1) * TILE;
    const bf16* Vt = Vs + (t & 1) * TILE_V;
    const bool more = t + 1 < n_tiles;
    if (more) {  // K of t+1 into the stage K of t-1 left
      load_tile(Ks + ((t + 1) & 1) * TILE, kh, (t + 1) * TC_KEYS, HD, LDS);
      cp_async_commit();
    }

    // S = Q K^T, 16 x 64 per warp, f32
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, Kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LDS +
                        ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[ks], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kb[2], kb[3]);
      }

    const int k0 = t * TC_KEYS;
    if (k0 + TC_KEYS > Sk || (causal && k0 + TC_KEYS - 1 > q_first)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + tq + (e & 1);
          if (key >= Sk || (causal && qpos[e >> 1] < key)) s[j][e] = NEG_INF;
        }
    }

    // online softmax in f32; a row is shared by the 4 lanes of a quad
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * a], s[j][2 * a + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[a], mx);
      const float corr = expf(m_run[a] - m_new);
      m_run[a] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * a; e < 2 * a + 2; ++e) {
          s[j][e] = expf(s[j][e] - m_new);
          sum += s[j][e];
        }
      l_run[a] = l_run[a] * corr + sum;  // this lane's columns only
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        o[nt][2 * a] *= corr;
        o[nt][2 * a + 1] *= corr;
      }
    }

    if (more)
      cp_async_wait<1>();  // V of t (K of t+1 may still be in flight)
    else
      cp_async_wait<0>();
    __syncthreads();  // V of t visible; every warp is past PV of t-1
    if (more) {  // V of t+1 into the stage V of t-1 left
      load_tile(Vs + ((t + 1) & 1) * TILE_V, vh, (t + 1) * TC_KEYS, HDV,
                LDSV);
      cp_async_commit();
    }

    // O += P V: P rounded to bf16 pairs as the A fragments, V via .trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < NT / 2; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               LDSV +
                          dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }

    if (more) {
      cp_async_wait<1>();  // K of t+1
      __syncthreads();     // visible, and every warp is done with K of t
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    float l = l_run[a];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int m = r0 + 8 * a;
    if (m >= rows) continue;
    const float den = fmaxf(l, 1e-30f);
    const size_t row = ((size_t)b * Hq + hk * G + m % G) * Sq + m / G;
    if (lse != nullptr && (lane & 3) == 0) lse[row] = m_run[a] + logf(l);
    bf16* dst = out + row * HDV;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<uint32_t*>(dst + nt * 8 + tq) =
          pack_bf16(o[nt][2 * a] / den, o[nt][2 * a + 1] / den);
  }
}

// ---------------------------------------------------------------------------
// the backward pass: D = rowsum(dO o O), then dK/dV and dQ (f32, CUDA cores)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T (round to nearest even) and back
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

constexpr int DOT_WARPS = 8;  // rows of D a block of the dot kernel

// D[row] = sum_e dO[row][e] * O[row][e] in f32, a warp a row
template <typename T, int HDV>
__global__ void __launch_bounds__(32 * DOT_WARPS)
    flash_bwd_dot_kernel(const T* __restrict__ out,
                         const T* __restrict__ dout, float* __restrict__ D,
                         long long rows) {
  const long long row =
      (long long)blockIdx.x * DOT_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp
  float acc = 0.f;
  for (int e = lane; e < HDV; e += 32)
    acc = fmaf(to_f(out[row * HDV + e]), to_f(dout[row * HDV + e]), acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) D[row] = acc;
}

template <int HD, int HDV>
constexpr size_t bwd_dkdv_smem_bytes() {  // K, Q; V, dO; P^T, dS^T; lse, D
  return (size_t)(2 * BK * (HD + 4) + 2 * BK * (HDV + 4) + 2 * BK * LDP +
                  2 * BQ) *
         sizeof(float);
}
template <int HD, int HDV>
constexpr size_t bwd_dq_smem_bytes() {  // Q, K; dO, V; dS; lse, D
  return (size_t)(2 * BK * (HD + 4) + 2 * BK * (HDV + 4) + BQ * LDP +
                  2 * BQ) *
         sizeof(float);
}

// rows [r0, r0 + 64) of a [n, width] tensor of T into shared f32 rows of
// stride ld, each times `mul` and rounded back to T (mul = 1: as stored);
// rows at or past n read as zeros
template <typename T>
__device__ __forceinline__ void load_tile_f32(float* dst, int ld,
                                              const T* src, int r0, int n,
                                              int width, float mul) {
  for (int idx = threadIdx.x; idx < 64 * width; idx += THREADS) {
    const int i = idx / width, d = idx % width;
    dst[i * ld + d] =
        r0 + i < n
            ? round_to<T>(to_f(src[(size_t)(r0 + i) * width + d]) * mul)
            : 0.f;
  }
}

// 4 x 4 dot products of rows 4r+a of A with rows cg+16c of B over `width`
// (a multiple of 4), both f32 in shared memory
template <int WIDTH>
__device__ __forceinline__ void dot_4x4(float (&acc)[4][4], const float* A,
                                        const float* B, int ld, int r,
                                        int cg) {
#pragma unroll 4
  for (int d = 0; d < WIDTH; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      x[a] = *reinterpret_cast<const float4*>(&A[(4 * r + a) * ld + d]);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      y[c] = *reinterpret_cast<const float4*>(&B[(cg + 16 * c) * ld + d]);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[a][c] = fmaf(x[a].x, y[c].x, acc[a][c]);
        acc[a][c] = fmaf(x[a].y, y[c].y, acc[a][c]);
        acc[a][c] = fmaf(x[a].z, y[c].z, acc[a][c]);
        acc[a][c] = fmaf(x[a].w, y[c].w, acc[a][c]);
      }
  }
}

// acc[a][c] += sum_i W[4r+a][i] * X[i][cg+16c] over the 64 columns i of
// the f32 tile W (stride LDP) and rows of X (stride ldx), NCOLS columns
template <int NCOLS>
__device__ __forceinline__ void tile_mac(float (&acc)[4][NCOLS],
                                         const float* W, const float* X,
                                         int ldx, int r, int cg) {
#pragma unroll 2
  for (int i = 0; i < 64; i += 4) {
    float4 w[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      w[a] = *reinterpret_cast<const float4*>(&W[(4 * r + a) * LDP + i]);
#pragma unroll
    for (int c = 0; c < NCOLS; ++c) {
      const float x0 = X[(i + 0) * ldx + cg + 16 * c];
      const float x1 = X[(i + 1) * ldx + cg + 16 * c];
      const float x2 = X[(i + 2) * ldx + cg + 16 * c];
      const float x3 = X[(i + 3) * ldx + cg + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        acc[a][c] = fmaf(w[a].x, x0, acc[a][c]);
        acc[a][c] = fmaf(w[a].y, x1, acc[a][c]);
        acc[a][c] = fmaf(w[a].z, x2, acc[a][c]);
        acc[a][c] = fmaf(w[a].w, x3, acc[a][c]);
      }
    }
  }
}

// dK and dV of one (64-key tile, KV head, batch): the block walks the G
// query heads of its group and, for each, the query tiles that see its
// keys, so it alone writes its rows of dK and dV (no atomics).  Thread
// (r, cg) owns keys 4r..4r+3 and, per query tile, the (key, query) pairs
// with queries cg + 16c.
template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ Dsum, T* __restrict__ dk,
                          T* __restrict__ dv, int Hq, int Hkv, int Sq,
                          int Sk, int causal, float scale) {
  constexpr int LD = HD + 4, LDV = HDV + 4;
  constexpr int NC = HD / 16, NCV = HDV / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [BK][LD]
  float* Qs = Ks + BK * LD;                     // [BQ][LD], scaled
  float* Vs = Qs + BQ * LD;                     // [BK][LDV]
  float* dOs = Vs + BK * LDV;                   // [BQ][LDV]
  float* Ps = dOs + BQ * LDV;                   // [BK][LDP]: P^T
  float* dSs = Ps + BK * LDP;                   // [BK][LDP]: dS^T
  float* lse_s = dSs + BK * LDP;                // [BQ]
  float* D_s = lse_s + BQ;                      // [BQ]

  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, r = tid >> 4, cg = tid & 15;
  const size_t kv_head = (size_t)b * Hkv + hk;
  load_tile_f32(Ks, LD, k + kv_head * Sk * HD, k0, Sk, HD, 1.f);
  load_tile_f32(Vs, LDV, v + kv_head * Sk * HDV, k0, Sk, HDV, 1.f);

  float dka[4][NC], dva[4][NCV];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[a][c] = 0.f;
#pragma unroll
    for (int c = 0; c < NCV; ++c) dva[a][c] = 0.f;
  }

  const int nq = (Sq + BQ - 1) / BQ;
  // causal (top-left): query i sees key j when j <= i, so the query tiles
  // from the key tile's index on see some of its keys (BQ == BK)
  const int qt0 = causal ? k0 / BQ : 0;
  for (int g = 0; g < G; ++g) {
    const size_t head = (size_t)b * Hq + hk * G + g;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's products are done
      load_tile_f32(Qs, LD, q + head * Sq * HD, q0, Sq, HD, scale);
      load_tile_f32(dOs, LDV, dout + head * Sq * HDV, q0, Sq, HDV, 1.f);
      for (int i = tid; i < BQ; i += THREADS) {
        lse_s[i] = q0 + i < Sq ? lse[head * Sq + q0 + i] : 0.f;
        D_s[i] = q0 + i < Sq ? Dsum[head * Sq + q0 + i] : 0.f;
      }
      __syncthreads();

      float s[4][4] = {}, dp[4][4] = {};
      dot_4x4<HD>(s, Ks, Qs, LD, r, cg);
      dot_4x4<HDV>(dp, Vs, dOs, LDV, r, cg);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = k0 + 4 * r + a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int ii = cg + 16 * c, i = q0 + ii;
          const bool keep = i < Sq && j < Sk && (!causal || j <= i);
          const float p = keep ? expf(s[a][c] - lse_s[ii]) : 0.f;
          // dV takes P as the forward's PV product does: in V's dtype
          Ps[(4 * r + a) * LDP + ii] = round_to<T>(p);
          dSs[(4 * r + a) * LDP + ii] = p * (dp[a][c] - D_s[ii]);
        }
      }
      __syncthreads();
      tile_mac<NCV>(dva, Ps, dOs, LDV, r, cg);
      tile_mac<NC>(dka, dSs, Qs, LD, r, cg);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = k0 + 4 * r + a;
    if (j >= Sk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dk[(kv_head * Sk + j) * HD + cg + 16 * c] = from_f<T>(dka[a][c]);
#pragma unroll
    for (int c = 0; c < NCV; ++c)
      dv[(kv_head * Sk + j) * HDV + cg + 16 * c] = from_f<T>(dva[a][c]);
  }
}

// dQ of one (64-query tile, query head, batch): the block walks the key
// tiles its queries see.  dQ = scale * dS K, dS = P o (dP - D), with P
// recomputed from the forward's lse.
template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ Dsum, T* __restrict__ dq,
                        int Hq, int Hkv, int Sq, int Sk, int causal,
                        float scale) {
  constexpr int LD = HD + 4, LDV = HDV + 4;
  constexpr int NC = HD / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][LD], scaled
  float* Ks = Qs + BQ * LD;                     // [BK][LD]
  float* dOs = Ks + BK * LD;                    // [BQ][LDV]
  float* Vs = dOs + BQ * LDV;                   // [BK][LDV]
  float* dSs = Vs + BK * LDV;                   // [BQ][LDP]
  float* lse_s = dSs + BQ * LDP;                // [BQ]
  float* D_s = lse_s + BQ;                      // [BQ]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest walks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, r = tid >> 4, cg = tid & 15;
  const size_t head = (size_t)b * Hq + h, kv_head = (size_t)b * Hkv + hk;
  load_tile_f32(Qs, LD, q + head * Sq * HD, q0, Sq, HD, scale);
  load_tile_f32(dOs, LDV, dout + head * Sq * HDV, q0, Sq, HDV, 1.f);
  for (int i = tid; i < BQ; i += THREADS) {
    lse_s[i] = q0 + i < Sq ? lse[head * Sq + q0 + i] : 0.f;
    D_s[i] = q0 + i < Sq ? Dsum[head * Sq + q0 + i] : 0.f;
  }

  float dqa[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dqa[a][c] = 0.f;

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal)  // tiles past the block's last query are all masked
    n_tiles = min(n_tiles, (min(q0 + BQ, Sq) - 1) / BK + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's dQ product is done
    load_tile_f32(Ks, LD, k + kv_head * Sk * HD, k0, Sk, HD, 1.f);
    load_tile_f32(Vs, LDV, v + kv_head * Sk * HDV, k0, Sk, HDV, 1.f);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    dot_4x4<HD>(s, Qs, Ks, LD, r, cg);
    dot_4x4<HDV>(dp, dOs, Vs, LDV, r, cg);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int ii = 4 * r + a, i = q0 + ii;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + cg + 16 * c;
        const bool keep = i < Sq && j < Sk && (!causal || j <= i);
        const float p = keep ? expf(s[a][c] - lse_s[ii]) : 0.f;
        dSs[ii * LDP + cg + 16 * c] = p * (dp[a][c] - D_s[ii]);
      }
    }
    __syncthreads();
    tile_mac<NC>(dqa, dSs, Ks, LD, r, cg);
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + 4 * r + a;
    if (i >= Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dq[(head * Sq + i) * HD + cg + 16 * c] = from_f<T>(dqa[a][c] * scale);
  }
}

// ---------------------------------------------------------------------------
// the backward pass, bf16: dK/dV and dQ on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_BWD_KEYS = 64;  // keys a dK/dV block owns; a dQ K/V tile
constexpr int TC_BWD_WIDE = 32;  // the span below at q/k head dims > 128

// Query rows of a dK/dV step, and keys of a dQ sub-step: 64, or 32 at q/k
// head dims above 128 (MLA's 192), where dK's or dQ's 96 accumulators a
// thread beside 64-wide S and dP tiles would spill, and 64-row dK/dV
// stages would leave one block a SM.
template <int HD>
__host__ __device__ constexpr int tc_bwd_span() {
  return HD > 128 ? TC_BWD_WIDE : TC_BWD_KEYS;
}

template <int HD, int HDV>
constexpr size_t tc_bwd_dkdv_smem_bytes() {  // K, V; two stages of Q, dO;
  constexpr int QT = tc_bwd_span<HD>();     // two of lse and D
  return (size_t)(TC_BWD_KEYS + 2 * QT) * ((HD + 8) + (HDV + 8)) *
             sizeof(__nv_bfloat16) +
         (size_t)2 * 2 * QT * sizeof(float);
}
template <int HD, int HDV>
constexpr size_t tc_bwd_dq_smem_bytes() {  // two stages of K and V; dO
  return ((size_t)2 * TC_BWD_KEYS * ((HD + 8) + (HDV + 8)) +
          (size_t)TC_ROWS * (HDV + 8)) *
         sizeof(__nv_bfloat16);
}

// rows [r0, r0 + ROWS) of a [limit, WIDTH] bf16 tensor into shared rows of
// stride LD by cp.async, 16 bytes a copy; rows at or past `limit` are
// zero-filled
template <int ROWS, int WIDTH, int LD>
__device__ __forceinline__ void cp_rows(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src, int r0,
                                        int limit) {
  constexpr int CHUNKS = WIDTH / 8;
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += TC_THREADS) {
    const int r = idx / CHUNKS, ch = idx % CHUNKS;
    const bool ok = r0 + r < limit;
    repro_mma::cp_async16(dst + r * LD + ch * 8,
                          src + (size_t)(ok ? r0 + r : 0) * WIDTH + ch * 8,
                          ok);
  }
}

// the 16-byte chunks this thread copied by cp_rows<ROWS, WIDTH, LD> (after
// its cp.async wait), times `mul` and rounded back to bf16
template <int ROWS, int WIDTH, int LD>
__device__ __forceinline__ void scale_rows(__nv_bfloat16* dst, float mul) {
  using namespace repro_mma;
  constexpr int CHUNKS = WIDTH / 8;
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += TC_THREADS) {
    const int r = idx / CHUNKS, ch = idx % CHUNKS;
    uint4* p = reinterpret_cast<uint4*>(dst + r * LD + ch * 8);
    uint4 x = *p;
    uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack_bf16(w[e]);
      w[e] = pack_bf16(f.x * mul, f.y * mul);
    }
    *p = x;
  }
}

// dK and dV of one (64-key tile, KV head, batch) on the tensor cores: the
// block walks the G query heads of its group and, for each, the QT-row
// query tiles that see its keys, so it alone writes its rows of dK and dV
// (no atomics).  Each warp owns 16 keys; per step, with K and V rows as A
// fragments and the step's tiles as B fragments:
//   S^T = K (q*scale)^T, P^T = exp(S^T - lse) under the forward's mask,
//   dP^T = V dO^T, dS^T = P^T o (dP^T - D),
//   dV += P^T dO and dK += dS^T (q*scale), P^T and dS^T rounded to bf16 as
//   A fragments straight from the C fragments, dO and q*scale by
//   ldmatrix.trans.
template <int HD, int HDV>
__global__ void __launch_bounds__(
    TC_THREADS, min_blocks(tc_bwd_dkdv_smem_bytes<HD, HDV>()))
    flash_bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ Dsum,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int Hq,
                               int Hkv, int Sq, int Sk, int causal,
                               float scale) {
  using namespace repro_mma;
  using bf16 = __nv_bfloat16;
  constexpr int QT = tc_bwd_span<HD>();  // query rows a step
  constexpr int LDK = HD + 8;            // row stride of K and Q tiles
  constexpr int LDV = HDV + 8;           // row stride of V and dO tiles
  constexpr int KS = HD / 16, KSV = HDV / 16;  // k-steps of S^T, dP^T
  constexpr int NQ = QT / 8;                   // 8-query tiles of S^T
  constexpr int NT = HD / 8, NTV = HDV / 8;    // 8-column tiles of dK, dV
  constexpr int Q_STAGE = QT * LDK, DO_STAGE = QT * LDV;
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);  // [TC_BWD_KEYS][LDK]
  bf16* Vs = Ks + TC_BWD_KEYS * LDK;          // [TC_BWD_KEYS][LDV]
  bf16* Qs = Vs + TC_BWD_KEYS * LDV;          // [2][QT][LDK], q*scale
  bf16* dOs = Qs + 2 * Q_STAGE;               // [2][QT][LDV]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * DO_STAGE);  // [2][QT]
  float* D_s = lse_s + 2 * QT;                                   // [2][QT]

  // the grid is (KV head, batch, key tile), the key tile slowest: under
  // the causal mask key tile 0 has the longest walk, so every (KV head,
  // batch)'s longest block is issued first
  const int G = Hq / Hkv;
  const int k0 = blockIdx.z * TC_BWD_KEYS, hk = blockIdx.x, b = blockIdx.y;
  const size_t kv_head = (size_t)b * Hkv + hk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tq = 2 * (lane & 3);  // first of the thread's column pair
  // this thread's keys in the tile: kr and kr + 8
  const int kr = warp * 16 + (lane >> 2);

  // causal (top-left): query i sees key j when j <= i, so the query tiles
  // from the one holding the key tile's first key on see some of its keys
  const int nq = (Sq + QT - 1) / QT;
  const int qt0 = causal ? min(k0 / QT, nq) : 0;
  const int per_head = nq - qt0;
  const int steps = G * per_head;

  auto issue = [&](int s) {  // step s's Q, dO, lse and D into stage s & 1
    const int g = s / per_head, q0 = (qt0 + s % per_head) * QT;
    const size_t head = (size_t)b * Hq + hk * G + g;
    const int st = s & 1;
    cp_rows<QT, HD, LDK>(Qs + st * Q_STAGE, q + head * Sq * HD, q0, Sq);
    cp_rows<QT, HDV, LDV>(dOs + st * DO_STAGE, dout + head * Sq * HDV, q0,
                          Sq);
    if (tid < QT) {
      const bool ok = q0 + tid < Sq;
      const size_t at = head * Sq + (ok ? q0 + tid : 0);
      cp_async4(lse_s + st * QT + tid, lse + at, ok);
      cp_async4(D_s + st * QT + tid, Dsum + at, ok);
    }
  };

  cp_rows<TC_BWD_KEYS, HD, LDK>(Ks, k + kv_head * Sk * HD, k0, Sk);
  cp_rows<TC_BWD_KEYS, HDV, LDV>(Vs, v + kv_head * Sk * HDV, k0, Sk);
  if (steps > 0) issue(0);
  cp_async_commit();
  cp_async_wait<0>();
  if (steps > 0) scale_rows<QT, HD, LDK>(Qs, scale);
  __syncthreads();

  float dka[NT][4], dva[NTV][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nt][e] = 0.f;
#pragma unroll
  for (int nt = 0; nt < NTV; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[nt][e] = 0.f;
  const bf16* Kw = Ks + warp * 16 * LDK;  // the warp's 16 keys
  const bf16* Vw = Vs + warp * 16 * LDV;

  for (int s = 0; s < steps; ++s) {
    const int st = s & 1;
    const bool more = s + 1 < steps;
    if (more) {  // step s+1 into the stage step s-1 left
      issue(s + 1);
      cp_async_commit();
    }
    const bf16* Qt = Qs + st * Q_STAGE;
    const bf16* dOt = dOs + st * DO_STAGE;
    const float* lse_t = lse_s + st * QT;
    const float* D_t = D_s + st * QT;
    const int q0 = (qt0 + s % per_head) * QT;

    // S^T = K (q*scale)^T and dP^T = V dO^T, 16 keys x QT queries a warp
    float sT[NQ][4], dpT[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ka[4];
      ldsm_x4(ka, Kw + (lane & 15) * LDK + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t qb[4];
        ldsm_x4(qb, Qt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LDK +
                        ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sT[2 * np], ka, qb[0], qb[1]);
        mma_bf16(sT[2 * np + 1], ka, qb[2], qb[3]);
      }
    }
#pragma unroll
    for (int ks = 0; ks < KSV; ++ks) {
      uint32_t va[4];
      ldsm_x4(va, Vw + (lane & 15) * LDV + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t ob[4];
        ldsm_x4(ob, dOt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LDV +
                        ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(dpT[2 * np], va, ob[0], ob[1]);
        mma_bf16(dpT[2 * np + 1], va, ob[2], ob[3]);
      }
    }

    // P^T (in sT) and dS^T (in dpT) in f32; the mask only where the tile
    // holds a ragged row or column or straddles the diagonal
    const bool edge = q0 + QT > Sq || k0 + TC_BWD_KEYS > Sk ||
                      (causal && q0 < k0 + TC_BWD_KEYS - 1);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + j * 8 + tq);
      const float2 d2 = *reinterpret_cast<const float2*>(D_t + j * 8 + tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + j * 8 + tq + (e & 1);
        const int key = k0 + kr + 8 * (e >> 1);
        const bool keep =
            !edge || (qi < Sq && key < Sk && (!causal || key <= qi));
        const float p =
            keep ? expf(sT[j][e] - ((e & 1) ? l2.y : l2.x)) : 0.f;
        sT[j][e] = p;
        dpT[j][e] = p * (dpT[j][e] - ((e & 1) ? d2.y : d2.x));
      }
    }

    // dV += P^T dO and dK += dS^T (q*scale), 16 queries a k-step
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(sT[2 * kk][0], sT[2 * kk][1]),
          pack_bf16(sT[2 * kk][2], sT[2 * kk][3]),
          pack_bf16(sT[2 * kk + 1][0], sT[2 * kk + 1][1]),
          pack_bf16(sT[2 * kk + 1][2], sT[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < NTV / 2; ++dp) {
        uint32_t ob[4];
        ldsm_x4_t(ob, dOt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                LDV +
                          dp * 16 + (lane >> 4) * 8);
        mma_bf16(dva[2 * dp], pa, ob[0], ob[1]);
        mma_bf16(dva[2 * dp + 1], pa, ob[2], ob[3]);
      }
      const uint32_t da[4] = {
          pack_bf16(dpT[2 * kk][0], dpT[2 * kk][1]),
          pack_bf16(dpT[2 * kk][2], dpT[2 * kk][3]),
          pack_bf16(dpT[2 * kk + 1][0], dpT[2 * kk + 1][1]),
          pack_bf16(dpT[2 * kk + 1][2], dpT[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < NT / 2; ++dp) {
        uint32_t qb[4];
        ldsm_x4_t(qb, Qt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               LDK +
                          dp * 16 + (lane >> 4) * 8);
        mma_bf16(dka[2 * dp], da, qb[0], qb[1]);
        mma_bf16(dka[2 * dp + 1], da, qb[2], qb[3]);
      }
    }

    if (more) {
      cp_async_wait<0>();  // step s+1, issued before this step's products
      scale_rows<QT, HD, LDK>(Qs + (st ^ 1) * Q_STAGE, scale);
      __syncthreads();     // visible and scaled; every warp done with st
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int key = k0 + kr + 8 * a;
    if (key >= Sk) continue;
    bf16* dkr = dk + (kv_head * Sk + key) * HD;
    bf16* dvr = dv + (kv_head * Sk + key) * HDV;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<uint32_t*>(dkr + nt * 8 + tq) =
          pack_bf16(dka[nt][2 * a], dka[nt][2 * a + 1]);
#pragma unroll
    for (int nt = 0; nt < NTV; ++nt)
      *reinterpret_cast<uint32_t*>(dvr + nt * 8 + tq) =
          pack_bf16(dva[nt][2 * a], dva[nt][2 * a + 1]);
  }
}

// dQ of 64 packed rows of one (KV head, batch) on the tensor cores, packed
// as the forward packs them (row m: query m / G of query head hk*G + m % G),
// so the G heads of a group share every K/V tile.  q*scale sits in
// registers as A fragments, dO in its own shared tile (its A fragments
// read per sub-step: held in registers they made dQ<192,128> spill), each
// row's lse and D in registers; 64-key tiles of K and V arrive through a
// two-stage cp.async ring.  Per KN-key sub-step: S = (q*scale) K^T, dP =
// dO V^T, dS = P o (dP - D), dQ += dS K (dS rounded to bf16 as A
// fragments, K by ldmatrix.trans); out dQ*scale.
template <int HD, int HDV>
__global__ void __launch_bounds__(
    TC_THREADS, min_blocks(tc_bwd_dq_smem_bytes<HD, HDV>()))
    flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ Dsum,
                             __nv_bfloat16* __restrict__ dq, int Hq, int Hkv,
                             int Sq, int Sk, int causal, float scale) {
  using namespace repro_mma;
  using bf16 = __nv_bfloat16;
  constexpr int KN = tc_bwd_span<HD>();        // keys a sub-step
  constexpr int LDK = HD + 8, LDV = HDV + 8;   // row strides (bf16)
  constexpr int KS = HD / 16, KSV = HDV / 16;  // k-steps of S, dP
  constexpr int NK = KN / 8;                   // 8-key tiles of S
  constexpr int NT = HD / 8;                   // 8-column tiles of dQ
  constexpr int K_STAGE = TC_BWD_KEYS * LDK, V_STAGE = TC_BWD_KEYS * LDV;
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);  // [2][TC_BWD_KEYS][LDK]
  bf16* Vs = Ks + 2 * K_STAGE;                // [2][TC_BWD_KEYS][LDV]
  bf16* dOs = Vs + 2 * V_STAGE;               // [TC_ROWS][LDV]

  // the grid is (KV head, batch, row tile), the row tile slowest and the
  // last rows first: under the causal mask they walk the most keys, so
  // every (KV head, batch)'s longest block is issued first
  const int G = Hq / Hkv;
  const int rows = G * Sq;                                   // packed rows
  const int m0 = (gridDim.z - 1 - blockIdx.z) * TC_ROWS;
  const int hk = blockIdx.x, b = blockIdx.y;
  const bf16* kh = k + ((size_t)b * Hkv + hk) * Sk * HD;
  const bf16* vh = v + ((size_t)b * Hkv + hk) * Sk * HDV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the block's rows of q into K's second stage (tile 1 fills it only
  // after the fragments are read) and of dO into its tile, tile 0 into
  // the first stages
  auto cp_packed = [&](bf16* dst, const bf16* src, int width, int ld) {
    const int chunks = width / 8;
    for (int idx = tid; idx < TC_ROWS * chunks; idx += TC_THREADS) {
      const int r = idx / chunks, ch = idx % chunks;
      const int m = m0 + r;
      const bool ok = m < rows;
      const int qi = ok ? m / G : 0, g = ok ? m % G : 0;
      cp_async16(dst + r * ld + ch * 8,
                 src + (((size_t)b * Hq + hk * G + g) * Sq + qi) * width +
                     ch * 8,
                 ok);
    }
  };
  cp_packed(Ks + K_STAGE, q, HD, LDK);
  cp_packed(dOs, dout, HDV, LDV);
  cp_rows<TC_BWD_KEYS, HD, LDK>(Ks, kh, 0, Sk);
  cp_rows<TC_BWD_KEYS, HDV, LDV>(Vs, vh, 0, Sk);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // q*scale as A fragments, rounded back to bf16 as the forward takes it
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    ldsm_x4(qf[ks], Ks + K_STAGE + (warp * 16 + (lane & 15)) * LDK +
                        ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack_bf16(qf[ks][e]);
      qf[ks][e] = pack_bf16(f.x * scale, f.y * scale);
    }
  }

  // this thread's rows: packed rows r0 and r0 + 8 of the warp's 16
  const int r0 = m0 + warp * 16 + (lane >> 2);
  const int tq = 2 * (lane & 3);
  int qpos[2];
  float lse_r[2], D_r[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int m = r0 + 8 * a;
    const bool ok = m < rows;
    const size_t row =
        ok ? ((size_t)b * Hq + hk * G + m % G) * Sq + m / G : 0;
    qpos[a] = m / G;
    lse_r[a] = ok ? lse[row] : 0.f;
    D_r[a] = ok ? Dsum[row] : 0.f;
  }
  __syncthreads();  // every warp has its q fragments: stage 1 is free
  const bf16* dOw = dOs + warp * 16 * LDV;  // the warp's 16 rows of dO

  // query positions: the block's first, and the last its rows reach
  const int q_first = m0 / G;
  const int q_last = (min(m0 + TC_ROWS, rows) - 1) / G;
  int n_tiles = (Sk + TC_BWD_KEYS - 1) / TC_BWD_KEYS;
  if (causal)  // tiles past the block's last query are all masked
    n_tiles = min(n_tiles, q_last / TC_BWD_KEYS + 1);

  float dqa[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[nt][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const bf16* Kt = Ks + (t & 1) * K_STAGE;
    const bf16* Vt = Vs + (t & 1) * V_STAGE;
    const bool more = t + 1 < n_tiles;
    if (more) {  // tile t+1 into the stage tile t-1 left
      const int k1 = (t + 1) * TC_BWD_KEYS;
      cp_rows<TC_BWD_KEYS, HD, LDK>(Ks + ((t + 1) & 1) * K_STAGE, kh, k1,
                                    Sk);
      cp_rows<TC_BWD_KEYS, HDV, LDV>(Vs + ((t + 1) & 1) * V_STAGE, vh, k1,
                                     Sk);
      cp_async_commit();
    }

#pragma unroll
    for (int h = 0; h < TC_BWD_KEYS / KN; ++h) {
      const int kb0 = t * TC_BWD_KEYS + h * KN;  // the sub-step's first key
      if (causal && kb0 > q_last) break;  // wholly above the diagonal
      const bf16* Kh = Kt + h * KN * LDK;
      const bf16* Vh = Vt + h * KN * LDV;

      // S = (q*scale) K^T and dP = dO V^T, 16 rows x KN keys a warp
      float s[NK][4], dp[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int np = 0; np < NK / 2; ++np) {
          uint32_t kb[4];
          ldsm_x4(kb, Kh + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LDK +
                          ks * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qf[ks], kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qf[ks], kb[2], kb[3]);
        }
#pragma unroll
      for (int ks = 0; ks < KSV; ++ks) {
        uint32_t oa[4];
        ldsm_x4(oa, dOw + (lane & 15) * LDV + ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NK / 2; ++np) {
          uint32_t vb[4];
          ldsm_x4(vb, Vh + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LDV +
                          ks * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(dp[2 * np], oa, vb[0], vb[1]);
          mma_bf16(dp[2 * np + 1], oa, vb[2], vb[3]);
        }
      }

      // P and dS (in dp) in f32, masked where the sub-step is ragged or
      // straddles the diagonal
      const bool edge =
          kb0 + KN > Sk || (causal && kb0 + KN - 1 > q_first);
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int a = e >> 1;
          const int key = kb0 + 8 * j + tq + (e & 1);
          const bool keep =
              !edge || (key < Sk && (!causal || key <= qpos[a]));
          const float p = keep ? expf(s[j][e] - lse_r[a]) : 0.f;
          dp[j][e] = p * (dp[j][e] - D_r[a]);
        }

      // dQ += dS K, 16 keys a k-step
#pragma unroll
      for (int kk = 0; kk < KN / 16; ++kk) {
        const uint32_t da[4] = {
            pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
            pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
            pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
            pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
        for (int dd = 0; dd < NT / 2; ++dd) {
          uint32_t kb[4];
          ldsm_x4_t(kb, Kh + (kk * 16 + (lane & 7) +
                              ((lane >> 3) & 1) * 8) * LDK +
                            dd * 16 + (lane >> 4) * 8);
          mma_bf16(dqa[2 * dd], da, kb[0], kb[1]);
          mma_bf16(dqa[2 * dd + 1], da, kb[2], kb[3]);
        }
      }
    }

    if (more) {
      cp_async_wait<0>();  // tile t+1, issued before this tile's products
      __syncthreads();     // visible, and every warp is done with tile t
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int m = r0 + 8 * a;
    if (m >= rows) continue;
    bf16* dst = dq + (((size_t)b * Hq + hk * G + m % G) * Sq + m / G) * HD;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<uint32_t*>(dst + nt * 8 + tq) =
          pack_bf16(dqa[nt][2 * a] * scale, dqa[nt][2 * a + 1] * scale);
  }
}

template <typename T, int HD, int HDV>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, float* D, void* dq,
               void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Sk,
               int causal, float scale, cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const long long rows = (long long)B * Hq * Sq;
  flash_bwd_dot_kernel<T, HDV>
      <<<(unsigned)((rows + DOT_WARPS - 1) / DOT_WARPS), 32 * DOT_WARPS, 0,
         st>>>(static_cast<const T*>(out), dot, D, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t kv_bytes = bwd_dkdv_smem_bytes<HD, HDV>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, HD, HDV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kv_bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<T, HD, HDV>
      <<<dim3((Sk + BK - 1) / BK, Hkv, B), THREADS, kv_bytes, st>>>(
          qt, kt, vt, dot, lse, D, static_cast<T*>(dk), static_cast<T*>(dv),
          Hq, Hkv, Sq, Sk, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t q_bytes = bwd_dq_smem_bytes<HD, HDV>();
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD, HDV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)q_bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<T, HD, HDV>
      <<<dim3((Sq + BQ - 1) / BQ, Hq, B), THREADS, q_bytes, st>>>(
          qt, kt, vt, dot, lse, D, static_cast<T*>(dq), Hq, Hkv, Sq, Sk,
          causal, scale);
  return (int)cudaGetLastError();
}

// the bf16 backward: the D kernel, then the tensor-core dK/dV and dQ
// kernels
template <int HD, int HDV>
int launch_bwd_bf16(const void* q, const void* k, const void* v,
                    const void* out, const void* dout, const float* lse,
                    float* D, void* dq, void* dk, void* dv, int B, int Hq,
                    int Hkv, int Sq, int Sk, int causal, float scale,
                    cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  const long long rows = (long long)B * Hq * Sq;
  flash_bwd_dot_kernel<bf16, HDV>
      <<<(unsigned)((rows + DOT_WARPS - 1) / DOT_WARPS), 32 * DOT_WARPS, 0,
         st>>>(static_cast<const bf16*>(out), dot, D, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t kv_bytes = tc_bwd_dkdv_smem_bytes<HD, HDV>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_bf16_kernel<HD, HDV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kv_bytes);
  if (err != cudaSuccess) return (int)err;
  // the tiles are the grid's z: at most 65535 (Sk, and G * Sq packed
  // rows, up to 4,194,240)
  const long long kv_tiles = (Sk + TC_BWD_KEYS - 1) / TC_BWD_KEYS;
  const long long q_tiles =
      ((long long)(Hq / Hkv) * Sq + TC_ROWS - 1) / TC_ROWS;
  if (kv_tiles > 65535 || q_tiles > 65535) return (int)cudaErrorInvalidValue;
  flash_bwd_dkdv_bf16_kernel<HD, HDV>
      <<<dim3(Hkv, B, (unsigned)kv_tiles), TC_THREADS, kv_bytes, st>>>(
          qt, kt, vt, dot, lse, D, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), Hq, Hkv, Sq, Sk, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t q_bytes = tc_bwd_dq_smem_bytes<HD, HDV>();
  err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<HD, HDV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)q_bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_bf16_kernel<HD, HDV>
      <<<dim3(Hkv, B, (unsigned)q_tiles), TC_THREADS, q_bytes, st>>>(
          qt, kt, vt, dot, lse, D, static_cast<bf16*>(dq), Hq, Hkv, Sq, Sk,
          causal, scale);
  return (int)cudaGetLastError();
}

template <int HD, int HDV>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int causal,
               float scale, cudaStream_t st) {
  const size_t bytes = smem_bytes<HD, HDV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_f32_kernel<HD, HDV><<<grid, THREADS, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, Hq, Hkv,
      Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

template <int HD, int HDV>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int causal,
                float scale, cudaStream_t st) {
  const size_t bytes = tc_smem_bytes<HD, HDV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)(Hq / Hkv) * Sq;
  dim3 grid((unsigned)((rows + TC_ROWS - 1) / TC_ROWS), Hkv, B);
  flash_bf16_kernel<HD, HDV><<<grid, TC_THREADS, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), lse, Hq, Hkv, Sq, Sk, causal,
      scale);
  return (int)cudaGetLastError();
}

// the (HD, HDV) instances: any other pair is refused
#define REPRO_FLASH_PAIRS(X) \
  X(32, 32) X(64, 64) X(128, 128) X(48, 32) X(192, 128)

#define REPRO_FLASH_ARGS \
  q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, causal, scale, st

int dispatch(int dtype, int hd, int hd_v, const void* q, const void* k,
             const void* v, void* out, float* lse, int B, int Hq, int Hkv,
             int Sq, int Sk, int causal, float scale, cudaStream_t st) {
#define REPRO_FLASH_CASE(HD, HDV)                                 \
  if (hd == HD && hd_v == HDV) {                                  \
    if (dtype == DTYPE_F32) return launch_f32<HD, HDV>(REPRO_FLASH_ARGS);  \
    if (dtype == DTYPE_BF16) return launch_bf16<HD, HDV>(REPRO_FLASH_ARGS); \
  }
  REPRO_FLASH_PAIRS(REPRO_FLASH_CASE)
#undef REPRO_FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

#undef REPRO_FLASH_ARGS

#define REPRO_FLASH_BWD_ARGS \
  q, k, v, out, dout, lse, D, dq, dk, dv, B, Hq, Hkv, Sq, Sk, causal, scale, st

int dispatch_bwd(int dtype, int hd, int hd_v, const void* q, const void* k,
                 const void* v, const void* out, const void* dout,
                 const float* lse, float* D, void* dq, void* dk, void* dv,
                 int B, int Hq, int Hkv, int Sq, int Sk, int causal,
                 float scale, cudaStream_t st) {
#define REPRO_FLASH_CASE(HD, HDV)                                          \
  if (hd == HD && hd_v == HDV) {                                           \
    if (dtype == DTYPE_F32)                                                \
      return launch_bwd<float, HD, HDV>(REPRO_FLASH_BWD_ARGS);             \
    if (dtype == DTYPE_BF16)                                               \
      return launch_bwd_bf16<HD, HDV>(REPRO_FLASH_BWD_ARGS);               \
  }
  REPRO_FLASH_PAIRS(REPRO_FLASH_CASE)
#undef REPRO_FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

#undef REPRO_FLASH_BWD_ARGS

template <int HD, int HDV>
int bwd_attrs_bf16(int which, int* out) {
  if (which == 0)
    return (int)repro_block_attrs(
        (const void*)flash_bwd_dkdv_bf16_kernel<HD, HDV>, TC_THREADS,
        (int)tc_bwd_dkdv_smem_bytes<HD, HDV>(), out);
  if (which == 1)
    return (int)repro_block_attrs(
        (const void*)flash_bwd_dq_bf16_kernel<HD, HDV>, TC_THREADS,
        (int)tc_bwd_dq_smem_bytes<HD, HDV>(), out);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int HD, int HDV>
int bwd_attrs(int which, int* out) {
  if (which == 0)
    return (int)repro_block_attrs(
        (const void*)flash_bwd_dkdv_kernel<T, HD, HDV>, THREADS,
        (int)bwd_dkdv_smem_bytes<HD, HDV>(), out);
  if (which == 1)
    return (int)repro_block_attrs(
        (const void*)flash_bwd_dq_kernel<T, HD, HDV>, THREADS,
        (int)bwd_dq_smem_bytes<HD, HDV>(), out);
  return (int)cudaErrorInvalidValue;
}

template <int HD, int HDV>
int attrs(int dtype, int* out) {
  if (dtype == DTYPE_F32)
    return (int)repro_block_attrs((const void*)flash_f32_kernel<HD, HDV>,
                                  THREADS, (int)smem_bytes<HD, HDV>(), out);
  if (dtype == DTYPE_BF16)
    return (int)repro_block_attrs((const void*)flash_bf16_kernel<HD, HDV>,
                                  TC_THREADS, (int)tc_smem_bytes<HD, HDV>(),
                                  out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q [B,Hq,Sq,hd], k [B,Hkv,Sk,hd], v [B,Hkv,Sk,hd_v], out [B,Hq,Sq,hd_v],
// contiguous, all of dtype `dtype`; lse [B,Hq,Sq] f32 (m + log l of every
// row, for the backward pass) or null, which skips its store (0 f32: CUDA-core kernel, 1 bf16:
// tensor-core kernel); (hd, hd_v) one of REPRO_FLASH_PAIRS; Hq % Hkv == 0;
// B, Hq < 65536; Sq, Sk >= 1.  `scale` is the logits' scale rounded to the
// dtype (hd^-0.5 unless the caller gives its own).
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, float* lse, int B, int Hq, int Hkv,
                          int Sq, int Sk, int hd, int hd_v, int causal,
                          int dtype, float scale, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Sk < 1 ||
      B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  return dispatch(dtype, hd, hd_v, q, k, v, out, lse, B, Hq, Hkv, Sq, Sk,
                  causal, scale, (cudaStream_t)stream);
}

// The block of the kernel a call of `dtype` and head dims (`hd`, `hd_v`)
// launches, with the dynamic shared bytes its launcher requests: out
// [ATTR_CELLS] as repro_block_attrs (attrs.cuh).
int repro_flash_block_attrs(int dtype, int hd, int hd_v, int* out) {
#define REPRO_FLASH_CASE(HD, HDV) \
  if (hd == HD && hd_v == HDV) return attrs<HD, HDV>(dtype, out);
  REPRO_FLASH_PAIRS(REPRO_FLASH_CASE)
#undef REPRO_FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

// The backward pass of repro_flash_attention: q, k, v, out and dout (the
// cotangent of out) as above, lse [B,Hq,Sq] f32 from the forward, D
// [B,Hq,Sq] f32 workspace; writes dq [B,Hq,Sq,hd], dk [B,Hkv,Sk,hd] and
// dv [B,Hkv,Sk,hd_v] in `dtype`.  Three launches on `stream`: D, dK/dV,
// dQ.  bf16 takes at most 65535 tiles of 64 keys and of 64 packed rows
// (Sk and (Hq / Hkv) * Sq up to 4,194,240).
int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* out, const void* dout,
                              const float* lse, float* D, void* dq, void* dk,
                              void* dv, int B, int Hq, int Hkv, int Sq,
                              int Sk, int hd, int hd_v, int causal, int dtype,
                              float scale, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Sk < 1 ||
      B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  return dispatch_bwd(dtype, hd, hd_v, q, k, v, out, dout, lse, D, dq, dk,
                      dv, B, Hq, Hkv, Sq, Sk, causal, scale,
                      (cudaStream_t)stream);
}

// The blocks of the backward kernels (`which` 0: dK/dV, 1: dQ) at `dtype`
// and head dims (`hd`, `hd_v`): out [ATTR_CELLS] as repro_block_attrs.
int repro_flash_bwd_block_attrs(int dtype, int hd, int hd_v, int which,
                                int* out) {
#define REPRO_FLASH_CASE(HD, HDV)                                  \
  if (hd == HD && hd_v == HDV) {                                   \
    if (dtype == DTYPE_F32) return bwd_attrs<float, HD, HDV>(which, out); \
    if (dtype == DTYPE_BF16) return bwd_attrs_bf16<HD, HDV>(which, out);  \
  }
  REPRO_FLASH_PAIRS(REPRO_FLASH_CASE)
#undef REPRO_FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
