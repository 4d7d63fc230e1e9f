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
// Design.  The Pallas kernel runs its grid in order on one core with the
// whole KV row of a head in VMEM.  Here one block of 256 threads owns one
// (batch, query head, 64-row query tile) and walks 64-key tiles of K and V
// through shared memory; blocks run in parallel on the 132 SMs.  The query
// tile, scaled, sits in shared memory as f32 for the whole walk; K and then
// V of a tile share one f32 buffer; P goes through a third.  Thread (r, c)
// of the block owns rows 4r..4r+3 of the tile and, of every 64-wide (or
// hd-wide) row, the columns c, c+16, c+32, ...: its logits and its slice of
// acc stay in f32 registers, and a row's max and sum are reduced across the
// 16 threads of a half-warp with shuffles.  Both products are f32 FMA on
// the CUDA cores (no tensor cores, no wgmma): simple, and the same code for
// f32 and bf16 inputs.  Row strides of hd+4 floats keep the float4 reads of
// Q and K free of bank conflicts.  Shared memory: (2*(hd+4) + 68)*64*4
// bytes, 85 KB at hd = 128, so two blocks fit on an SM.
//
// Causal tiles that lie wholly above the diagonal are skipped.  Key tile 0
// holds position 0, which every row may see, so every row's running max is
// finite after it; a skipped tile would have given exp(-1e30 - m) = 0 to
// every P and a factor exp(0) = 1 to acc and l, so skipping changes no bit.
// Query tiles are issued in reverse order so the longest walks start first.
//
// What bounds it on the H100: operations.  At the serving path's shape
// (B=1, 16 query heads over 8 KV heads, hd=128, S=2048, bf16, causal) the
// function needs 2*2*S*S/2*hd*16 = 17.2 GFLOP against 25 MB of Q, K, V and
// out, so the bound is 17.2 GFLOP at 989 TFLOP/s (bf16 tensor cores) =
// 0.017 ms, far above the 0.008 ms of bytes.  This kernel does that work on
// the CUDA cores in f32, whose peak is 67 TFLOP/s, so it cannot come near
// the bound; reaching it needs wgmma on bf16 tiles fed by TMA, which is
// later work.  Its measured time is in PERF.md (chip_smoke.py).
//
// The entry point launches on the given stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 row groups x 16 column groups
constexpr int LDP = BK + 4;   // row stride of the P tile (floats)
constexpr float NEG_INF = -1e30f;

constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

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
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// x rounded through T and back (the reference's casts to q's / V's dtype)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
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

template <int HD>
constexpr size_t smem_bytes() {
  return (size_t)(2 * BQ * (HD + 4) + BQ * LDP) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int Hq,
                 int Hkv, int Sq, int Sk, int causal, float scale) {
  constexpr int LD = HD + 4;   // row stride of the Q and K/V tiles (floats)
  constexpr int NC = HD / 16;  // acc columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][LD], scaled q
  float* KVs = Qs + BQ * LD;                    // [BK][LD], K then V
  float* Ps = KVs + BK * LD;                    // [BQ][LDP]

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal walks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const T* qh = q + ((size_t)b * Hq + h) * Sq * HD;
  const T* kh = k + ((size_t)b * Hkv + hk) * Sk * HD;
  const T* vh = v + ((size_t)b * Hkv + hk) * Sk * HD;
  T* oh = out + ((size_t)b * Hq + h) * Sq * HD;

  const int tid = threadIdx.x;
  const int r = tid >> 4;   // rows 4r .. 4r+3
  const int cg = tid & 15;  // columns cg + 16j

  for (int idx = tid; idx < BQ * HD; idx += THREADS) {
    const int i = idx / HD, d = idx % HD;
    const int qi = q0 + i;
    Qs[i * LD + d] =
        qi < Sq ? round_to<T>(to_f(qh[(size_t)qi * HD + d]) * scale) : 0.f;
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
      KVs[j * LD + d] = kj < Sk ? to_f(kh[(size_t)kj * HD + d]) : 0.f;
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
        Ps[(4 * r + a) * LDP + cg + 16 * c] = round_to<T>(p);
      }
      l[a] = l[a] * corr + row_sum(sum);
      m[a] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[a][j] *= corr;
    }
    __syncthreads();  // all logits read KVs as K; all of P written

    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int j = idx / HD, d = idx % HD;
      const int kj = k0 + j;
      KVs[j * LD + d] = kj < Sk ? to_f(vh[(size_t)kj * HD + d]) : 0.f;
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
        const float v0 = KVs[(j + 0) * LD + cg + 16 * c];
        const float v1 = KVs[(j + 1) * LD + cg + 16 * c];
        const float v2 = KVs[(j + 2) * LD + cg + 16 * c];
        const float v3 = KVs[(j + 3) * LD + cg + 16 * c];
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
      oh[(size_t)qi * HD + cg + 16 * c] = from_f<T>(acc[a][c] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Sq, int Sk, int causal, float scale,
           cudaStream_t st) {
  const size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_kernel<T, HD><<<grid, THREADS, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, Sq, Sk,
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                void* out, int B, int Hq, int Hkv, int Sq, int Sk,
                int causal, float scale, cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, Hq, Hkv, Sq, Sk, causal, scale,
                           st);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Hq, Hkv, Sq, Sk, causal, scale,
                           st);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Hq, Hkv, Sq, Sk, causal, scale,
                            st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B,Hq,Sq,hd], k/v [B,Hkv,Sk,hd], out [B,Hq,Sq,hd], contiguous, all of
// dtype `dtype` (0 f32, 1 bf16); hd in {32, 64, 128}; Hq % Hkv == 0;
// B, Hq < 65536; Sq, Sk >= 1.  `scale` is hd^-0.5 rounded to the dtype.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int B, int Hq, int Hkv, int Sq, int Sk,
                          int hd, int causal, int dtype, float scale,
                          void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Sk < 1 ||
      B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return dispatch_hd<float>(hd, q, k, v, out, B, Hq, Hkv, Sq, Sk, causal,
                              scale, st);
  if (dtype == DTYPE_BF16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, Hq, Hkv, Sq, Sk,
                                      causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
