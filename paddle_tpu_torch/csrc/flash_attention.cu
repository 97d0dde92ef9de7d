// Flash-attention forward for Hopper: causal or full, GQA, fp32 online
// softmax; emits O and the log-sum-exp.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py:_fwd_kernel
// (grid and specs in _fwd, flash_attention.py:130; wrapper logic of _prep /
// flash_attention_with_lse, :844-921).
//
// Bound on the H100: operations at the serving and training shapes (a
// 2048-token causal head does ~2*2*2048*2048/2*128 flops on 2048*128*2*4
// bytes — hundreds of flops per byte, above the card's ~295 flop/byte
// ridge). This first version runs the products on the CUDA cores in fp32
// (67 TFLOP/s peak), not on the tensor cores: wgmma, TMA and pipelining are
// later work. What it does about the bound is the FlashAttention-2 shape:
// Q, K and V are read once per (query tile, key tile) pair, scores never
// reach device memory, and causal key tiles above the diagonal are skipped.
//
// Design: one block of 256 threads per (64-row query tile, batch*head).
// The TPU kernel's sequential key-tile grid axis becomes a loop inside the
// block. A 16x16 thread grid owns a 4x4 patch of the 64x64 score tile (key
// columns strided by 16 so shared-memory reads hit distinct banks) and a
// 4 x D/16 patch of the output accumulator, in registers. The row's max and
// sum are reduced across its 16 threads with shuffles. Probabilities are
// rounded through V's dtype before the PV product (flash_attention.py:95),
// while the row sum l uses them unrounded, as the reference does.
// Layout: q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] (Paddle's flash layout, read
// in place — no transposes), o like q, lse [B, Hq, Sq] fp32. GQA: query head
// h reads kv head h / (Hq/Hkv). Masks use the true lengths: col < Sk, and
// for causal col <= row (top-left aligned). A row with nothing visible gives
// O = 0 and lse = -inf.
#include "common.cuh"

namespace {

constexpr int kBQ = 64, kBK = 64, kThreads = 256;

template <int D> struct Smem {
  static constexpr int DP = D + 1;   // padded fp32 row of Q and K tiles
  static constexpr int PP = kBK + 1; // padded row of the probability tile
  static constexpr size_t floats = kBQ * DP + kBK * DP + kBK * D + kBQ * PP;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
                 int causal, float scale) {
  using S = Smem<D>;
  constexpr int DP = S::DP, PP = S::PP, NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // [kBQ][DP]
  float* Ks = Qs + kBQ * DP;     // [kBK][DP]
  float* Vs = Ks + kBK * DP;     // [kBK][D]
  float* Ps = Vs + kBK * D;      // [kBQ][PP]

  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t q_row = static_cast<size_t>(Hq) * D;   // stride between tokens
  const size_t kv_row = static_cast<size_t>(Hkv) * D;
  const T* qb = q + (static_cast<size_t>(b) * Sq) * q_row + h * D;
  const T* kb = k + (static_cast<size_t>(b) * Sk) * kv_row + hk * D;
  const T* vb = v + (static_cast<size_t>(b) * Sk) * kv_row + hk * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D, gr = q0 + r;
    Qs[r * DP + c] = gr < Sq ? to_f<T>(qb[gr * q_row + c]) : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }

  // causal: keys past the tile's last row are masked for every row
  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // previous tile's K/V/P reads are done (and Q is stored)
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D, gr = k0 + r;
      const bool in = gr < Sk;
      Ks[r * DP + c] = in ? to_f<T>(kb[gr * kv_row + c]) : 0.f;
      Vs[r * D + c] = in ? to_f<T>(vb[gr * kv_row + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * DP + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < Sk && (!causal || col <= row);
        s[i][j] = ok ? s[i][j] * scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)  // the row's 16 threads
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = expf(m[i] - m_safe);  // exp(-inf) = 0 on first use
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_safe);  // masked: exp(-inf) = 0
        sum += p;
        Ps[(ty * 4 + i) * PP + tx + 16 * j] = round_through<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[NC];
#pragma unroll
      for (int n = 0; n < NC; ++n) vv[n] = Vs[j * D + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty * 4 + i) * PP + j];
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(p, vv[n], acc[i][n]);
      }
    }
  }

  T* ob = o + (static_cast<size_t>(b) * Sq) * q_row + h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int n = 0; n < NC; ++n)
      ob[row * q_row + tx + 16 * n] = from_f<T>(acc[i][n] / l_safe);
    if (tx == 0)
      lse[static_cast<size_t>(bh) * Sq + row] =
          m[i] == -CUDART_INF_F ? -CUDART_INF_F : m[i] + logf(l_safe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Sk, int Hq, int Hkv, int causal, float scale,
           cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D>;
  const size_t bytes = Smem<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Sq + kBQ - 1) / kBQ, B * Hq);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, Hq, Hkv,
      causal, scale);
  PTT_RETURN_LAUNCH_ERROR();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, float* lse,
               int B, int Sq, int Sk, int Hq, int Hkv, int D, int causal,
               float scale, cudaStream_t s) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int ptt_flash_attn_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int B, int Sq, int Sk,
                                  int Hq, int Hkv, int D, int causal,
                                  float scale, int dtype, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == PTT_F32)
    return dispatch_d<float>(q, k, v, o, l, B, Sq, Sk, Hq, Hkv, D, causal, scale, s);
  if (dtype == PTT_BF16)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, l, B, Sq, Sk, Hq, Hkv, D, causal,
                                     scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
