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
// and head against 3 reads of the tiles: far above the card's ridge). No
// score, probability or ds matrix reaches device memory, and causal tiles
// above the diagonal are never loaded.
//
// bf16 (the training paths): the products on the tensor cores, wgmma fed by
// TMA rings guarded by mbarriers (hopper.cuh), in two launches on the
// caller's stream; neither uses atomics, so two runs give the same bits.
//  1. dQ and delta: one block of 288 threads per (128-row query tile,
//     batch*head): two consumer warpgroups of 64 rows and one producer
//     warp. The producer TMA-loads the Q and dO tiles once, then K and V
//     tiles of BN keys (4-D tensor maps over [B, S, H, D] read in place,
//     out-of-range rows zero-filled per batch) into a 4-stage ring. Each
//     warpgroup first forms delta for its rows from dO in shared memory and
//     O from device memory (the delta pass folded into the prologue: one
//     launch and one read of dO fewer) and stores it for launch 2; then,
//     per key tile, S = Q.K^T and dP = dO.V^T (both operands K-major), p
//     and ds in registers (the scale folded into the exponent's FFMA, 2^x
//     on the special-function unit), ds rounded to bf16 in the accumulator
//     layout that is wgmma's register-A fragment, and dQ += ds.K with K read
//     MN-major in place through the transpose bit.
//  2. dK and dV: one block per (128-key tile, batch*kv head) of two
//     consumer warpgroups of 64 keys and one producer warp at head dim 64;
//     at head dim 128 a block per 64-key tile with one consumer warpgroup,
//     since dK and dV alone hold 128 fp32 registers a thread there and a
//     block of two consumer warpgroups gets 168 registers a thread. The
//     producer TMA-loads K and V once, then streams the Q and dO tiles of
//     64 queries (with their lse and delta, staged by the producer's lanes)
//     for every query head of the group and every query tile at or below
//     the diagonal through a 4-stage ring. Each warpgroup computes
//     S^T = K.Q^T and dP^T = V.dO^T (shared-memory A, both K-major), p^T
//     and ds^T in registers, and dV += p^T.dO, dK += ds^T.Q with register A
//     and dO, Q read MN-major in place. dK and dV stay in fp32 registers
//     across the whole group and are rounded once: the group sum, with no
//     atomics.
// Determinism has a price: dQ in its own kernel recomputes S and dP for
// each (query tile, key tile) pair, 7 products a pair where a kernel that
// adds dQ with fp32 atomics (FlashAttention-3) does 5, and whose sums
// would change from run to run. Only the tiles on the diagonal or the
// ragged edge are masked (the mask hoisted out of the common loop); keys
// past Sk read as zero, and queries past Sq carry an lse of +inf (p = 0) in
// launch 2. When one head's tiles do not fill the card (the training
// shapes), blocks run the longest causal tiles of every head first; else
// (train-cp's 32k tokens) one head at a time, so the blocks in flight share
// one head's K/V (launch 1) or one group's Q/dO (launch 2) in L2.
//
// fp32: the first port's design on the CUDA cores in full fp32, three
// launches:
//  1. delta: one warp per (batch, row, head).
//  2. dQ: one block of 256 threads per (64-row query tile, batch*head); the
//     TPU kernel's sequential key axis is a loop in the block. Each thread
//     owns a 4x4 patch of the 64x64 score and dp tiles and a 4 x D/16 patch
//     of the dQ accumulator. ds goes through shared memory for ds . K.
//  3. dK/dV: one block per (64-key tile, batch*kv head), looping over the
//     GQA group's query heads and the query tiles that see the key tile, so
//     the group sum happens in the block's fp32 registers. Each thread owns
//     4 keys x 4 queries of the transposed tiles and 4 keys x D/16 columns
//     of dK and dV.
// Layout as the forward: q/o/dO [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] read in
// place, lse and delta [B, Hq, Sq] fp32. Masks use the true lengths
// (col < Sk, row < Sq, causal col <= row).
#include "common.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------- bf16
namespace wg {

using bf16 = __nv_bfloat16;
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(empty);
}

// ------------------------------------------------------------ 1. dQ, delta
template <int D> struct DqCfg {
  static constexpr int BM = 128;                 // query rows a block
  static constexpr int BN = 64;                  // keys a tile (at 128, S and dP spill)
  static constexpr int kStages = 4;
  static constexpr int kAtoms = D / 64;          // 64-column atoms of a row
  static constexpr int kQBytes = BM * D * 2;     // the Q or the dO tile
  static constexpr int kTile = BN * D * 2;       // one K or V tile
  static constexpr int kDoOff = kQBytes;
  static constexpr int kKOff = 2 * kQBytes;
  static constexpr int kVOff = kKOff + kStages * kTile;
  static constexpr int kBarOff = kVOff + kStages * kTile;
  static constexpr int kBytes = kBarOff + (1 + 2 * kStages) * 8 + hopper::kSmemAlign;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_do,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, const bf16* __restrict__ o,
                   const float* __restrict__ lse, float* __restrict__ delta,
                   bf16* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, int causal,
                   float scale, int heads_fastest) {
  using C = DqCfg<D>;
  constexpr int BM = C::BM, BN = C::BN, kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align_smem(smem_raw);
  unsigned char* Qs = sm;
  unsigned char* dOs = sm + C::kDoOff;
  unsigned char* Ks = sm + C::kKOff;
  unsigned char* Vs = sm + C::kVOff;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + C::kBarOff);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = heads_fastest ? blockIdx.x : blockIdx.y;
  const int qt = heads_fastest ? blockIdx.y : blockIdx.x;
  const int b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  // late query tiles see the most keys: start them first
  const int q0 = ((heads_fastest ? gridDim.y : gridDim.x) - 1 - qt) * BM;
  const int k_end = causal ? min(Sk, q0 + BM) : Sk;
  const int n_tiles = (k_end + BN - 1) / BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers / 32);  // one arrival a consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer warp
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(q_full, 2 * C::kQBytes);
      for (int a = 0; a < C::kAtoms; ++a) {
        hopper::tma_load_4d(Qs + a * BM * 128, &map_q, q_full, a * 64, h, q0, b);
        hopper::tma_load_4d(dOs + a * BM * 128, &map_do, q_full, a * 64, h, q0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) hopper::mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * C::kTile);
        for (int a = 0; a < C::kAtoms; ++a) {
          hopper::tma_load_4d(Ks + s * C::kTile + a * BN * 128, &map_k, &full[s], a * 64, hk,
                              t * BN, b);
          hopper::tma_load_4d(Vs + s * C::kTile + a * BN * 128, &map_v, &full[s], a * 64, hk,
                              t * BN, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: query rows q0 + 64g .. q0 + 64g + 63
  const int g = warp >> 2, wq = warp & 3;
  const int first = q0 + 64 * g, last = first + 63;
  const int r_lo = first + 16 * wq + (lane >> 2), r_hi = r_lo + 8;
  // causal: tiles past n_live hold only keys above every row of this
  // warpgroup; they are waited for and freed, never computed
  const int n_live = causal ? min(n_tiles, (last + BN) / BN) : n_tiles;
  const size_t row_stride = static_cast<size_t>(Hq) * D;
  const size_t head_off = static_cast<size_t>(b) * Sq * row_stride + static_cast<size_t>(h) * D;

  hopper::mbar_wait(q_full, 0);
  // delta = rowsum(dO * O) for rows r_lo and r_hi: the row's four lanes
  // take a quarter of D each, dO from the swizzled tile, O from memory
  float dl[2], l2[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = hi ? r_hi : r_lo, r = row - q0;
    float sum = 0.f;
    if (row < Sq) {
      const bf16* orow = o + head_off + static_cast<size_t>(row) * row_stride;
#pragma unroll
      for (int c8 = 0; c8 < D / 32; ++c8) {
        const int ch = (lane & 3) * (D / 32) + c8;  // 8-column chunk of the row
        const uint4 uo = *reinterpret_cast<const uint4*>(orow + ch * 8);
        const uint4 ud = *reinterpret_cast<const uint4*>(
            dOs + (ch / 8) * BM * 128 + r * 128 + (((ch % 8) ^ (r & 7)) << 4));
        float fo[8], fd[8];
        unpack<bf16>(uo, fo);
        unpack<bf16>(ud, fd);
#pragma unroll
        for (int e = 0; e < 8; ++e) sum = fmaf(fd[e], fo[e], sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    dl[hi] = sum;
    const size_t at = static_cast<size_t>(bh) * Sq + row;
    if ((lane & 3) == 0 && row < Sq) delta[at] = sum;
    const float l = row < Sq ? lse[at] : 0.f;
    l2[hi] = (l == -CUDART_INF_F ? 0.f : l) * kLog2e;
  }

  const float scale_log2 = scale * kLog2e;
  float acc[D / 2], sc[BN / 2], dp[BN / 2];
  uint32_t da[BN / 16][4];  // ds in bf16: the A fragments of dQ += ds.K
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < n_live; ++t) {
    const int s = t % kStages, k0 = t * BN;
    hopper::mbar_wait(&full[s], (t / kStages) & 1);
    const unsigned char* Kt = Ks + s * C::kTile;
    const unsigned char* Vt = Vs + s * C::kTile;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int qa = (kk / 4) * BM * 128 + g * 64 * 128 + (kk % 4) * 32;
      const int kb = (kk / 4) * BN * 128 + (kk % 4) * 32;
      hopper::wgmma_ss<BN, 0>(sc, hopper::desc_sw128(Qs + qa, 16, 1024),
                              hopper::desc_sw128(Kt + kb, 16, 1024), kk > 0);
      hopper::wgmma_ss<BN, 0>(dp, hopper::desc_sw128(dOs + qa, 16, 1024),
                              hopper::desc_sw128(Vt + kb, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    if (k0 + BN > Sk || (causal && k0 + BN - 1 > first)) {  // the edge tiles only
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int col = k0 + 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
        const int row = (i & 2) ? r_hi : r_lo;
        if (col >= Sk || (causal && col > row)) sc[i] = -CUDART_INF_F;
      }
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int hi = (i >> 1) & 1;
      const float p = hopper::exp2_approx(fmaf(sc[i], scale_log2, -l2[hi]));
      dp[i] = p * (dp[i] - dl[hi]) * scale;
    }
    hopper::pack_a(da, dp);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
      hopper::wgmma_rs<D, 1>(acc, da[j], hopper::desc_sw128(Kt + j * 16 * 128, BN * 128, 1024),
                             1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    release(&empty[s]);
  }
  for (int t = n_live; t < n_tiles; ++t) {  // no key here is visible
    const int s = t % kStages;
    hopper::mbar_wait(&full[s], (t / kStages) & 1);
    release(&empty[s]);
  }

  bf16* qb = dq + head_off;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = (i & 2) ? r_hi : r_lo;
    if (row < Sq)
      *reinterpret_cast<__nv_bfloat162*>(qb + row * row_stride + 8 * (i / 4) +
                                         2 * (lane & 3)) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

// ------------------------------------------------------------- 2. dK, dV
template <int D> struct DkvCfg {
  // head dim 128: one consumer warpgroup of 64 keys, whose dK and dV alone
  // hold 128 fp32 registers a thread (ptxas counts whole warpgroups, so two
  // consumer warpgroups and a producer warp get 168 registers a thread,
  // and spilled); head dim 64: two warpgroups of 64 keys
  static constexpr int kWG = D == 128 ? 1 : 2;
  static constexpr int BK = 64 * kWG;         // keys a block
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 32;  // and one producer warp
  static constexpr int BQ = 64;               // queries a tile
  static constexpr int kStages = 4;
  static constexpr int kAtoms = D / 64;
  static constexpr int kKBytes = BK * D * 2;  // K or V
  static constexpr int kQTile = BQ * D * 2;   // one Q or dO tile
  static constexpr int kVOff = kKBytes;
  static constexpr int kQOff = 2 * kKBytes;
  static constexpr int kDoOff = kQOff + kStages * kQTile;
  static constexpr int kLseOff = kDoOff + kStages * kQTile;  // lse * log2(e)
  static constexpr int kDeltaOff = kLseOff + kStages * BQ * 4;
  static constexpr int kBarOff = kDeltaOff + kStages * BQ * 4;
  static constexpr int kBytes = kBarOff + (1 + 2 * kStages) * 8 + hopper::kSmemAlign;
};

template <int D>
__global__ void __launch_bounds__(DkvCfg<D>::kThreads, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv, int causal,
                    float scale, int heads_fastest) {
  using C = DkvCfg<D>;
  constexpr int BK = C::BK, BQ = C::BQ, kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align_smem(smem_raw);
  unsigned char* Ks = sm;
  unsigned char* Vs = sm + C::kVOff;
  unsigned char* Qs = sm + C::kQOff;
  unsigned char* dOs = sm + C::kDoOff;
  float* Ls = reinterpret_cast<float*>(sm + C::kLseOff);
  float* Ds = reinterpret_cast<float*>(sm + C::kDeltaOff);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + C::kBarOff);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int bhk = heads_fastest ? blockIdx.x : blockIdx.y;
  const int kt = heads_fastest ? blockIdx.y : blockIdx.x;  // early key tiles see the most queries
  const int b = bhk / Hkv, hk = bhk % Hkv, group = Hq / Hkv;
  const int k0 = kt * BK;
  // causal: query tiles that end before the key tile starts see none of it
  const int t_begin = causal ? k0 / BQ : 0;
  const int per_head = max(0, (Sq + BQ - 1) / BQ - t_begin);
  const int n_iter = group * per_head;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 33);  // the producer's 32 lanes and the TMA's expect_tx
      hopper::mbar_init(&empty[s], C::kConsumers / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == C::kConsumers / 32) {  // the producer warp
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(kv_full, 2 * C::kKBytes);
      for (int a = 0; a < C::kAtoms; ++a) {
        hopper::tma_load_4d(Ks + a * BK * 128, &map_k, kv_full, a * 64, hk, k0, b);
        hopper::tma_load_4d(Vs + a * BK * 128, &map_v, kv_full, a * 64, hk, k0, b);
      }
    }
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % kStages;
      const int h = hk * group + it / per_head, q0 = (t_begin + it % per_head) * BQ;
      if (it >= kStages) hopper::mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
      // lse (times log2 e; +inf past Sq, so p = 0 there) and delta of the tile
      const size_t at = (static_cast<size_t>(b) * Hq + h) * Sq;
      for (int i = lane; i < BQ; i += 32) {
        const int row = q0 + i;
        float l2 = CUDART_INF_F, dd = 0.f;
        if (row < Sq) {
          const float l = lse[at + row];
          l2 = (l == -CUDART_INF_F ? 0.f : l) * kLog2e;
          dd = delta[at + row];
        }
        Ls[s * BQ + i] = l2;
        Ds[s * BQ + i] = dd;
      }
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&full[s], 2 * C::kQTile);
        for (int a = 0; a < C::kAtoms; ++a) {
          hopper::tma_load_4d(Qs + s * C::kQTile + a * BQ * 128, &map_q, &full[s], a * 64, h,
                              q0, b);
          hopper::tma_load_4d(dOs + s * C::kQTile + a * BQ * 128, &map_do, &full[s], a * 64,
                              h, q0, b);
        }
      }
      hopper::mbar_arrive(&full[s]);
    }
    return;
  }

  // a consumer warpgroup: keys kw .. kw + 63
  const int g = warp >> 2, wq = warp & 3;
  const int kw = k0 + 64 * g;
  const int key_lo = kw + 16 * wq + (lane >> 2), key_hi = key_lo + 8;
  const float scale_log2 = scale * kLog2e;
  float adk[D / 2], adv[D / 2], st[BQ / 2], dpt[BQ / 2];
  uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];  // p^T and ds^T: register A
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.f;

  hopper::mbar_wait(kv_full, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kStages;
    const int q0 = (t_begin + it % per_head) * BQ;
    hopper::mbar_wait(&full[s], (it / kStages) & 1);
    if (causal && q0 + BQ - 1 < kw) {  // every query of the tile is above these keys
      release(&empty[s]);
      continue;
    }
    const unsigned char* Qt = Qs + s * C::kQTile;
    const unsigned char* dOt = dOs + s * C::kQTile;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int ka = (kk / 4) * BK * 128 + g * 64 * 128 + (kk % 4) * 32;
      const int qb = (kk / 4) * BQ * 128 + (kk % 4) * 32;
      hopper::wgmma_ss<BQ, 0>(st, hopper::desc_sw128(Ks + ka, 16, 1024),
                              hopper::desc_sw128(Qt + qb, 16, 1024), kk > 0);
      hopper::wgmma_ss<BQ, 0>(dpt, hopper::desc_sw128(Vs + ka, 16, 1024),
                              hopper::desc_sw128(dOt + qb, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);
    if (causal && kw + 63 > q0) {  // the diagonal tiles only
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int col = q0 + 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
        if (((i & 2) ? key_hi : key_lo) > col) st[i] = -CUDART_INF_F;
      }
    }
    const float* ls = Ls + s * BQ;
    const float* ds = Ds + s * BQ;
#pragma unroll
    for (int i = 0; i < BQ / 2; i += 2) {  // elements i, i+1: adjacent queries
      const int c = 8 * (i / 4) + 2 * (lane & 3);
      const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
      const float2 d2 = *reinterpret_cast<const float2*>(ds + c);
      const float p0 = hopper::exp2_approx(fmaf(st[i], scale_log2, -l2.x));
      const float p1 = hopper::exp2_approx(fmaf(st[i + 1], scale_log2, -l2.y));
      st[i] = p0;
      st[i + 1] = p1;
      dpt[i] = p0 * (dpt[i] - d2.x) * scale;
      dpt[i + 1] = p1 * (dpt[i + 1] - d2.y) * scale;
    }
    hopper::pack_a(pa, st);
    hopper::pack_a(dsa, dpt);
    hopper::fence_regs(adv);
    hopper::fence_regs(adk);
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      hopper::wgmma_rs<D, 1>(adv, pa[j],
                             hopper::desc_sw128(dOt + j * 16 * 128, BQ * 128, 1024), 1);
      hopper::wgmma_rs<D, 1>(adk, dsa[j],
                             hopper::desc_sw128(Qt + j * 16 * 128, BQ * 128, 1024), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(adv);
    hopper::fence_regs(adk);
    release(&empty[s]);
  }

  const size_t row_stride = static_cast<size_t>(Hkv) * D;
  const size_t off = static_cast<size_t>(b) * Sk * row_stride + static_cast<size_t>(hk) * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int key = (i & 2) ? key_hi : key_lo;
    if (key < Sk) {
      const size_t at = off + key * row_stride + 8 * (i / 4) + 2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(adk[i], adk[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) = __floats2bfloat162_rn(adv[i], adv[i + 1]);
    }
  }
}

// [B, S, H, D] as a 4-D map, innermost first; a box is 64 columns of one
// head over `rows` rows of one batch
int map_bshd(CUtensorMap* map, const void* base, int B, int S, int H, int D, int rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(H),
                            static_cast<uint64_t>(S), static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {dims[0] * 2, dims[1] * dims[0] * 2,
                               dims[2] * dims[1] * dims[0] * 2};
  const uint32_t box[4] = {64, 1, static_cast<uint32_t>(rows), 1};
  return hopper::bf16_map(map, base, 4, dims, strides, box);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Sq, int Sk,
           int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  using C1 = DqCfg<D>;
  using C2 = DkvCfg<D>;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                         reinterpret_cast<uintptr_t>(dout);
  if (bits % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = hopper::sm_count();
  const int q_tiles = (Sq + C1::BM - 1) / C1::BM;
  const int k_tiles = (Sk + C2::BK - 1) / C2::BK;
  const bool hf1 = q_tiles < sms, hf2 = k_tiles < sms;
  if ((hf1 ? q_tiles : B * Hq) > 65535 || (hf2 ? k_tiles : B * Hkv) > 65535)  // grid.y
    return static_cast<int>(cudaErrorInvalidValue);
  // no keys: no K/V tile is loaded, so the maps may describe Q's memory
  const bool none = Sk == 0;
  CUtensorMap mq1, mdo1, mk1, mv1, mq2, mdo2, mk2, mv2;
  int err = map_bshd(&mq1, q, B, Sq, Hq, D, C1::BM);
  if (err == 0) err = map_bshd(&mdo1, dout, B, Sq, Hq, D, C1::BM);
  if (err == 0) err = map_bshd(&mk1, none ? q : k, B, none ? Sq : Sk, none ? Hq : Hkv, D, C1::BN);
  if (err == 0) err = map_bshd(&mv1, none ? q : v, B, none ? Sq : Sk, none ? Hq : Hkv, D, C1::BN);
  if (err != 0) return err;
  auto k1 = flash_bwd_dq_wgmma<D>;
  cudaError_t e =
      cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, C1::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 g1 = hf1 ? dim3(B * Hq, q_tiles) : dim3(q_tiles, B * Hq);
  k1<<<g1, kThreads, C1::kBytes, stream>>>(mq1, mdo1, mk1, mv1, static_cast<const bf16*>(o), lse,
                                           delta, static_cast<bf16*>(dq), Sq, Sk, Hq, Hkv,
                                           causal, scale, hf1);
  e = cudaGetLastError();
  if (e != cudaSuccess || none) return static_cast<int>(e);

  err = map_bshd(&mq2, q, B, Sq, Hq, D, C2::BQ);
  if (err == 0) err = map_bshd(&mdo2, dout, B, Sq, Hq, D, C2::BQ);
  if (err == 0) err = map_bshd(&mk2, k, B, Sk, Hkv, D, C2::BK);
  if (err == 0) err = map_bshd(&mv2, v, B, Sk, Hkv, D, C2::BK);
  if (err != 0) return err;
  auto k2 = flash_bwd_dkv_wgmma<D>;
  e = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, C2::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 g2 = hf2 ? dim3(B * Hkv, k_tiles) : dim3(k_tiles, B * Hkv);
  k2<<<g2, C2::kThreads, C2::kBytes, stream>>>(mq2, mdo2, mk2, mv2, lse, delta,
                                           static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq,
                                           Sk, Hq, Hkv, causal, scale, hf2);
  PTT_RETURN_LAUNCH_ERROR();
}

}  // namespace wg

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
  if (dtype == PTT_BF16 && D == 64)
    return wg::launch<64>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv,
                          causal, scale, s);
  if (dtype == PTT_BF16 && D == 128)
    return wg::launch<128>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv,
                           causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
