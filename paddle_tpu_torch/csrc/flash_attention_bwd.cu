// Flash-attention backward for Hopper: dQ, dK and dV for causal or full,
// GQA attention, from the forward's O and log-sum-exp.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/flash_attention.py:_bwd
// (:303; _bwd_dq_kernel :177 and _bwd_dkv_kernel :237, two pallas_calls)
// and the GQA group sum of _bwd_grouped (:778-789). Same math:
//   delta = rowsum(dO * O) in fp32,
//   p     = exp(s - lse), an lse of -inf taken as 0,
//   ds    = p * (dp - delta) * scale,  dp = dO . V^T,
//   dQ    = ds(rounded to K's dtype) . K,
//   dK    = ds^T(rounded to Q's dtype) . Q,  dV = p^T(rounded to dO's dtype) . dO,
// dK and dV summed over the query heads of each kv head in fp32 and
// returned in K's dtype; dQ in Q's dtype.
//
// Bound on the H100: operations (10*d flops per visible (query, key) pair
// and head against 3 reads of the tiles: far above the card's ridge).
// This first version runs the products on the CUDA cores in fp32, like the
// forward (csrc/flash_attention.cu); tensor cores are later work. What it
// does about the bound: no score, probability or ds matrix reaches device
// memory, and causal tiles above the diagonal are skipped.
//
// Design: three launches on the caller's stream.
//  1. delta: one warp per (batch, row, head).
//  2. dQ: one block of 256 threads per (64-row query tile, batch*head); the
//     TPU kernel's sequential key axis is a loop in the block. Each thread
//     owns a 4x4 patch of the 64x64 score and dp tiles and a 4 x D/16 patch
//     of the dQ accumulator. ds goes through shared memory for ds . K.
//  3. dK/dV: one block per (64-key tile, batch*kv head), looping over the
//     GQA group's query heads and the query tiles that see the key tile, so
//     the group sum happens in the block's fp32 registers: no atomics, and
//     runs repeat bitwise. Each thread owns 4 keys x 4 queries of the
//     transposed tiles and 4 keys x D/16 columns of dK and dV.
// Layout as the forward: q/o/dO [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] read in
// place, lse and delta [B, Hq, Sq] fp32. Masks use the true lengths
// (col < Sk, row < Sq, causal col <= row).
#include "common.cuh"

namespace {

constexpr int kB = 64, kThreads = 256;

template <typename T>
__global__ void flash_bwd_delta_kernel(const T* __restrict__ o,
                                       const T* __restrict__ dout,
                                       float* __restrict__ delta, int B, int Sq,
                                       int Hq, int D) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * (blockDim.x / 32) +
                     threadIdx.x / 32;  // (b, row, h) in memory order
  const int lane = threadIdx.x & 31;
  if (idx >= static_cast<size_t>(B) * Sq * Hq) return;
  const T* orow = o + idx * D;
  const T* drow = dout + idx * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += to_f<T>(drow[c]) * to_f<T>(orow[c]);
  s = warp_sum(s);
  if (lane == 0) {
    const int h = static_cast<int>(idx % Hq);
    const size_t br = idx / Hq;
    const int row = static_cast<int>(br % Sq);
    const size_t b = br / Sq;
    delta[(b * Hq + h) * Sq + row] = s;
  }
}

template <int D> struct BwdSmem {
  static constexpr int DP = D + 1;   // padded fp32 row of a Q/dO/K/V tile
  static constexpr int PP = kB + 1;  // padded row of a p / ds tile
  static constexpr size_t dq_bytes = (4 * kB * DP + kB * PP) * sizeof(float);
  static constexpr size_t dkv_bytes =
      (4 * kB * DP + 2 * kB * PP + 2 * kB) * sizeof(float);
};

template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, size_t row_stride,
                                          int r0, int n) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, c = i % D, gr = r0 + r;
    dst[r * DP + c] = gr < n ? to_f<T>(src[gr * row_stride + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv,
                    int causal, float scale) {
  using S = BwdSmem<D>;
  constexpr int DP = S::DP, PP = S::PP, NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;            // [kB][DP]
  float* dOs = Qs + kB * DP;   // [kB][DP]
  float* Ks = dOs + kB * DP;   // [kB][DP]
  float* Vs = Ks + kB * DP;    // [kB][DP]
  float* dSs = Vs + kB * DP;   // [kB][PP]

  // late query tiles see the most keys: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t q_row = static_cast<size_t>(Hq) * D;
  const size_t kv_row = static_cast<size_t>(Hkv) * D;
  const size_t q_off = (static_cast<size_t>(b) * Sq) * q_row + h * D;
  const T* kb = k + (static_cast<size_t>(b) * Sk) * kv_row + hk * D;
  const T* vb = v + (static_cast<size_t>(b) * Sk) * kv_row + hk * D;

  load_tile<T, D>(Qs, q + q_off, q_row, q0, Sq);
  load_tile<T, D>(dOs, dout + q_off, q_row, q0, Sq);
  float lse_s[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const float l = row < Sq ? lse[static_cast<size_t>(bh) * Sq + row] : 0.f;
    lse_s[i] = l == -CUDART_INF_F ? 0.f : l;
    dl[i] = row < Sq ? delta[static_cast<size_t>(bh) * Sq + row] : 0.f;
  }
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;

  const int k_end = causal ? min(Sk, q0 + kB) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kB) {
    __syncthreads();  // previous tile's K/dS reads are done (Q/dO stored)
    load_tile<T, D>(Ks, kb, kv_row, k0, Sk);
    load_tile<T, D>(Vs, vb, kv_row, k0, Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty * 4 + i) * DP + c];
        dov[i] = dOs[(ty * 4 + i) * DP + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * DP + c];
        vv[j] = Vs[(tx + 16 * j) * DP + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < Sk && (!causal || col <= row);
        const float sv = ok ? s[i][j] * scale : -CUDART_INF_F;
        const float p = expf(sv - lse_s[i]);  // masked: exp(-inf) = 0
        const float ds = p * (dp[i][j] - dl[i]) * scale;
        dSs[(ty * 4 + i) * PP + tx + 16 * j] = round_through<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kB; ++j) {
      float kv[NC];
#pragma unroll
      for (int n = 0; n < NC; ++n) kv[n] = Ks[j * DP + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = dSs[(ty * 4 + i) * PP + j];
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(d, kv[n], acc[i][n]);
      }
    }
  }

  T* dqb = dq + q_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
#pragma unroll
    for (int n = 0; n < NC; ++n) dqb[row * q_row + tx + 16 * n] = from_f<T>(acc[i][n]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk,
                     int Hq, int Hkv, int causal, float scale) {
  using S = BwdSmem<D>;
  constexpr int DP = S::DP, PP = S::PP, NC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;            // [kB][DP]
  float* Vs = Ks + kB * DP;    // [kB][DP]
  float* Qs = Vs + kB * DP;    // [kB][DP]
  float* dOs = Qs + kB * DP;   // [kB][DP]
  float* Pt = dOs + kB * DP;   // [kB keys][PP], p rounded to dO's dtype
  float* dSt = Pt + kB * PP;   // [kB keys][PP], ds rounded to Q's dtype
  float* Ls = dSt + kB * PP;   // [kB] lse of the query tile (-inf -> 0)
  float* Ds = Ls + kB;         // [kB] delta of the query tile

  const int k0 = blockIdx.x * kB;  // early key tiles see the most queries
  const int bhk = blockIdx.y;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int group = Hq / Hkv;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t q_row = static_cast<size_t>(Hq) * D;
  const size_t kv_row = static_cast<size_t>(Hkv) * D;
  const size_t kv_off = (static_cast<size_t>(b) * Sk) * kv_row + hk * D;

  load_tile<T, D>(Ks, k + kv_off, kv_row, k0, Sk);
  load_tile<T, D>(Vs, v + kv_off, kv_row, k0, Sk);
  float adk[4][NC], adv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) adk[i][n] = adv[i][n] = 0.f;

  // causal: query tiles that end before the key tile starts see none of it
  const int q_begin = causal ? (k0 / kB) * kB : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const size_t bh = static_cast<size_t>(b) * Hq + h;
    const size_t q_off = (static_cast<size_t>(b) * Sq) * q_row + h * D;
    for (int q0 = q_begin; q0 < Sq; q0 += kB) {
      __syncthreads();  // previous tile's Q/dO/P/dS reads are done
      load_tile<T, D>(Qs, q + q_off, q_row, q0, Sq);
      load_tile<T, D>(dOs, dout + q_off, q_row, q0, Sq);
      if (tid < kB) {
        const int row = q0 + tid;
        const float l = row < Sq ? lse[bh * Sq + row] : 0.f;
        Ls[tid] = l == -CUDART_INF_F ? 0.f : l;
        Ds[tid] = row < Sq ? delta[bh * Sq + row] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];  // [key ty*4+i][query tx+16j]
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(ty * 4 + i) * DP + c];
          vv[i] = Vs[(ty * 4 + i) * DP + c];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = Qs[(tx + 16 * j) * DP + c];
          dov[j] = dOs[(tx + 16 * j) * DP + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[j], kv[i], s[i][j]);
            dp[i][j] = fmaf(dov[j], vv[i], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = tx + 16 * j, row = q0 + qi;
          const bool ok = key < Sk && row < Sq && (!causal || key <= row);
          const float sv = ok ? s[i][j] * scale : -CUDART_INF_F;
          const float p = expf(sv - Ls[qi]);
          const float ds = p * (dp[i][j] - Ds[qi]) * scale;
          Pt[(ty * 4 + i) * PP + qi] = round_through<T>(p);
          dSt[(ty * 4 + i) * PP + qi] = round_through<T>(ds);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int j = 0; j < kB; ++j) {
        float qv[NC], dov[NC];
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          qv[n] = Qs[j * DP + tx + 16 * n];
          dov[n] = dOs[j * DP + tx + 16 * n];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = Pt[(ty * 4 + i) * PP + j];
          const float d = dSt[(ty * 4 + i) * PP + j];
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            adv[i][n] = fmaf(p, dov[n], adv[i][n]);
            adk[i][n] = fmaf(d, qv[n], adk[i][n]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= Sk) continue;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const size_t at = kv_off + key * kv_row + tx + 16 * n;
      dk[at] = from_f<T>(adk[i][n]);
      dv[at] = from_f<T>(adv[i][n]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq, void* dk,
           void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int causal,
           float scale, cudaStream_t stream) {
  using S = BwdSmem<D>;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *dot = static_cast<const T*>(dout);

  const size_t rows = static_cast<size_t>(B) * Sq * Hq;
  const int warps = 8;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + warps - 1) / warps),
                              warps * 32, 0, stream>>>(
      static_cast<const T*>(o), dot, delta, B, Sq, Hq, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  auto dq_kern = flash_bwd_dq_kernel<T, D>;
  e = cudaFuncSetAttribute(dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(S::dq_bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_kern<<<dim3((Sq + kB - 1) / kB, B * Hq), kThreads, S::dq_bytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), Sq, Sk, Hq, Hkv, causal,
      scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  if (Sk == 0) return 0;
  auto dkv_kern = flash_bwd_dkv_kernel<T, D>;
  e = cudaFuncSetAttribute(dkv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(S::dkv_bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  dkv_kern<<<dim3((Sk + kB - 1) / kB, B * Hkv), kThreads, S::dkv_bytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq,
      Sk, Hq, Hkv, causal, scale);
  PTT_RETURN_LAUNCH_ERROR();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int D,
               int causal, float scale, cudaStream_t s) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk,
                           Hq, Hkv, causal, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk,
                            Hq, Hkv, causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o, dout, dq: [B, Sq, Hq, D]; k, v, dk, dv: [B, Sk, Hkv, D]; lse and the
// scratch delta: [B, Hq, Sq] fp32. All tensors share the dtype code.
extern "C" int ptt_flash_attn_bwd(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, void* delta, void* dq,
                                  void* dk, void* dv, int B, int Sq, int Sk,
                                  int Hq, int Hkv, int D, int causal,
                                  float scale, int dtype, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == PTT_F32)
    return dispatch_d<float>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq,
                             Hkv, D, causal, scale, s);
  if (dtype == PTT_BF16)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq,
                                     Sk, Hq, Hkv, D, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
