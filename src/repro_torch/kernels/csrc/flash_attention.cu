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
// FlashAttention-2's, three launches, no float atomics:
//   * flash_bwd_dot_kernel: D = rowsum(dO o O) in f32, a warp a row;
//   * flash_bwd_dkdv_kernel: one block of 256 threads per (64-key tile,
//     KV head, batch) keeps its K and V tiles in shared memory and walks
//     the G query heads of its group and, for each, the query tiles that
//     see its keys (causal: from the key tile's own on); per query tile
//     it recomputes S^T = K (q*scale)^T, P = exp(S - lse) under the
//     forward's mask, dP^T = V dO^T and dS = P o (dP - D), and sums dV +=
//     P^T dO (P rounded to V's dtype, as the forward's PV product takes
//     it) and dK += dS^T (q*scale) in registers; so the block alone writes
//     its rows of dK and dV;
//   * flash_bwd_dq_kernel: one block per (64-query tile, query head,
//     batch) walks the key tiles its queries see and sums dQ = scale * dS K.
// Both keep every tile as f32 in shared memory and run f32 FMA on the
// CUDA cores for both dtypes (a bf16 input is widened on load, q*scale
// rounded to bf16 first as in the forward): dK/dV 170 KB at 128/128 and
// 203 KB at 192/128, dQ 153 and 186 KB, one block a SM.  What bounds it:
// operations, 2 FLOP a multiply-add of the recomputed logits (hd), dV,
// dP (hd_v each), dQ and dK (hd each) over the kept pairs: 172 GFLOP at
// qwen3's training shape (4 x 2048, 16/8 heads, hd 128, causal), 0.17 ms
// at the bf16 tensor cores' rate; this first kernel runs on the CUDA
// cores (PERF.md has its time); mma.sync/wgmma is later work.
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
      return launch_bwd<__nv_bfloat16, HD, HDV>(REPRO_FLASH_BWD_ARGS);     \
  }
  REPRO_FLASH_PAIRS(REPRO_FLASH_CASE)
#undef REPRO_FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

#undef REPRO_FLASH_BWD_ARGS

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
// dQ.
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
    if (dtype == DTYPE_BF16)                                        \
      return bwd_attrs<__nv_bfloat16, HD, HDV>(which, out);         \
  }
  REPRO_FLASH_PAIRS(REPRO_FLASH_CASE)
#undef REPRO_FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
