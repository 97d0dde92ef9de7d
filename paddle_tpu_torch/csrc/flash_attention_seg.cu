// Segment-causal flash attention for Hopper, forward and backward: causal
// attention over a local q/k window made of two chunks that sit at
// arbitrary global positions (the zig-zag ring's per-step problem).
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/flash_attention.py:
//   forward   _fwd_seg (:458, pallas_call :466; body _fwd_seg_kernel :394),
//   backward  _bwd_seg (:622; dQ pallas_call :633, dK/dV :664) and the GQA
//             group sum of _bwd_grouped_seg (:707).
// A descriptor seg = [q_off0, q_off1, q_split, k_off0, k_off1, k_split]
// maps local rows and columns to global positions through two monotone maps
// (SegMap, segment.cuh), and the mask is g(row) >= g(col) in global
// coordinates. The six ints cross by value: each rank knows its rank and
// the ring step on the host.
//
// Bound on the H100: operations, as for the dense kernels (4*d flops per
// live (row, col) pair and head forward, 10*d backward, against one read of
// each tile).
//
// Routes of the backward, chosen by the wrapper from shape and alignment
// before the launch (the `tma` flag): bf16 with 16-byte-aligned q, k, v, o
// and dO and grids within 65535 takes #2's wgmma dQ and dK/dV kernels with
// the segment mask as their compile-time policy (csrc/flash_attention_bwd.cu,
// flash_bwd_seg_wgmma): TMA rings, 128-row query tiles in dQ, 64-key tiles
// a consumer warpgroup in dK/dV, no atomics. Every other call (fp32, or a
// misaligned bf16 base) takes this file's kernels below.
//
// This file's kernels are #1/#2's first design (PR 6) with the segment
// mask: products in fp32 on the CUDA cores, no score, probability or ds
// matrix in device memory.
// What it does about the bound is skip dead work: the maps are monotone, so
// a key tile is dead for a query tile once g_k(its first column) > g_q(the
// tile's last row), and every later key tile is dead too; the walks stop
// there instead of masking. A tile pair with g_q(first row) >= g_k(last
// column) is interior and builds no mask. A tile may straddle a split (the
// chunk need not be a multiple of 64): the predicates read the mapped first
// and last rows and columns, which stays exact under monotone maps.
//
// Design: as #1 and #2. Forward and dQ: one block of 256 threads per
// (64-row query tile, batch*head), walking key tiles from 0 to the first
// dead one; a 16x16 thread grid owns 4x4 patches of the 64x64 tiles. dK/dV:
// one block per (64-key tile, batch*kv head) walking the GQA group's query
// heads and the query tiles from the first live one, the group summed in
// fp32 registers (no atomics: bitwise repeatable); dK and dV come out in
// K's dtype, dQ in Q's. A row with nothing visible gives O = 0 and lse =
// -inf (_fwd_seg_kernel's _finish, flash_attention.py:449-455).
// Layout: q/o/dO [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] read in place, lse and
// delta [B, Hq, Sq] fp32.
#include "common.cuh"
#include "segment.cuh"

namespace {

constexpr int kB = 64, kThreads = 256;

template <int D> struct SegSmem {
  static constexpr int DP = D + 1;   // padded fp32 row of a tile
  static constexpr int PP = kB + 1;  // padded row of a p / ds tile
  static constexpr size_t fwd_bytes = (3 * kB * DP + kB * D) * sizeof(float);
  static constexpr size_t dq_bytes = (4 * kB * DP + kB * PP) * sizeof(float);
  static constexpr size_t dkv_bytes =
      (4 * kB * DP + 2 * kB * PP + 2 * kB) * sizeof(float);
};

template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, size_t row_stride,
                                          int r0, int n, int dst_stride) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, c = i % D, gr = r0 + r;
    dst[r * dst_stride + c] = gr < n ? to_f<T>(src[gr * row_stride + c]) : 0.f;
  }
}

// ------------------------------------------------------------- forward
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
seg_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
               SegMap gq, SegMap gk, float scale) {
  using S = SegSmem<D>;
  constexpr int DP = S::DP, PP = S::PP, NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // [kB][DP]
  float* Ks = Qs + kB * DP;      // [kB][DP]
  float* Vs = Ks + kB * DP;      // [kB][D]
  float* Ps = Vs + kB * D;       // [kB][PP]

  const int q0 = blockIdx.x * kB;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t q_row = static_cast<size_t>(Hq) * D;
  const size_t kv_row = static_cast<size_t>(Hkv) * D;
  const T* qb = q + (static_cast<size_t>(b) * Sq) * q_row + h * D;
  const T* kb = k + (static_cast<size_t>(b) * Sk) * kv_row + hk * D;
  const T* vb = v + (static_cast<size_t>(b) * Sk) * kv_row + hk * D;

  load_tile<T, D>(Qs, qb, q_row, q0, Sq, DP);
  const int g_first = gq(q0), g_last = gq(min(q0 + kB, Sq) - 1);
  int grow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) grow[i] = gq(q0 + ty * 4 + i);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }

  // monotone maps: once a key tile's first column is past the query tile's
  // last row, it and every later key tile are dead
  for (int k0 = 0; k0 < Sk && gk(k0) <= g_last; k0 += kB) {
    const bool interior = k0 + kB <= Sk && g_first >= gk(k0 + kB - 1);
    __syncthreads();  // previous tile's K/V/P reads are done (and Q is stored)
    for (int i = tid; i < kB * D; i += kThreads) {
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
    int gcol[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) gcol[j] = gk(k0 + tx + 16 * j);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = interior || (col < Sk && grow[i] >= gcol[j]);
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
    for (int j = 0; j < kB; ++j) {
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

// ------------------------------------------------------------ backward
template <typename T>
__global__ void seg_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                 float* __restrict__ delta, int B, int Sq, int Hq,
                                 int D) {
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
seg_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, SegMap gq,
              SegMap gk, float scale) {
  using S = SegSmem<D>;
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

  load_tile<T, D>(Qs, q + q_off, q_row, q0, Sq, DP);
  load_tile<T, D>(dOs, dout + q_off, q_row, q0, Sq, DP);
  const int g_first = gq(q0), g_last = gq(min(q0 + kB, Sq) - 1);
  float lse_s[4], dl[4];
  int grow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const float l = row < Sq ? lse[static_cast<size_t>(bh) * Sq + row] : 0.f;
    lse_s[i] = l == -CUDART_INF_F ? 0.f : l;
    dl[i] = row < Sq ? delta[static_cast<size_t>(bh) * Sq + row] : 0.f;
    grow[i] = gq(row);
  }
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;

  for (int k0 = 0; k0 < Sk && gk(k0) <= g_last; k0 += kB) {
    const bool interior = k0 + kB <= Sk && g_first >= gk(k0 + kB - 1);
    __syncthreads();  // previous tile's K/dS reads are done (Q/dO stored)
    load_tile<T, D>(Ks, kb, kv_row, k0, Sk, DP);
    load_tile<T, D>(Vs, vb, kv_row, k0, Sk, DP);
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
    int gcol[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) gcol[j] = gk(k0 + tx + 16 * j);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = interior || (col < Sk && grow[i] >= gcol[j]);
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
seg_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int Hq,
               int Hkv, SegMap gq, SegMap gk, float scale) {
  using S = SegSmem<D>;
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
  __shared__ int Gq[kB];       // global positions of the query tile's rows

  const int k0 = blockIdx.x * kB;
  const int bhk = blockIdx.y;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int group = Hq / Hkv;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t q_row = static_cast<size_t>(Hq) * D;
  const size_t kv_row = static_cast<size_t>(Hkv) * D;
  const size_t kv_off = (static_cast<size_t>(b) * Sk) * kv_row + hk * D;

  load_tile<T, D>(Ks, k + kv_off, kv_row, k0, Sk, DP);
  load_tile<T, D>(Vs, v + kv_off, kv_row, k0, Sk, DP);
  float adk[4][NC], adv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) adk[i][n] = adv[i][n] = 0.f;

  // the first live query tile: its last row sees the key tile's first
  // column; with monotone maps every later tile is live too
  const int gk_first = gk(k0), gk_last = gk(k0 + kB - 1);
  int q_begin = 0;
  while (q_begin < Sq && gq(min(q_begin + kB, Sq) - 1) < gk_first) q_begin += kB;
  int gkey[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) gkey[i] = gk(k0 + ty * 4 + i);

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const size_t bh = static_cast<size_t>(b) * Hq + h;
    const size_t q_off = (static_cast<size_t>(b) * Sq) * q_row + h * D;
    for (int q0 = q_begin; q0 < Sq; q0 += kB) {
      const bool interior = k0 + kB <= Sk && q0 + kB <= Sq && gq(q0) >= gk_last;
      __syncthreads();  // previous tile's Q/dO/P/dS reads are done
      load_tile<T, D>(Qs, q + q_off, q_row, q0, Sq, DP);
      load_tile<T, D>(dOs, dout + q_off, q_row, q0, Sq, DP);
      if (tid < kB) {
        const int row = q0 + tid;
        const float l = row < Sq ? lse[bh * Sq + row] : 0.f;
        Ls[tid] = l == -CUDART_INF_F ? 0.f : l;
        Ds[tid] = row < Sq ? delta[bh * Sq + row] : 0.f;
        Gq[tid] = gq(row);
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
          const bool ok =
              interior || (key < Sk && row < Sq && Gq[qi] >= gkey[i]);
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

// -------------------------------------------------------------- launch
template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
               int B, int Sq, int Sk, int Hq, int Hkv, SegMap gq, SegMap gk,
               float scale, cudaStream_t stream) {
  auto kern = seg_fwd_kernel<T, D>;
  const size_t bytes = SegSmem<D>::fwd_bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3((Sq + kB - 1) / kB, B * Hq), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, Hq, Hkv, gq,
      gk, scale);
  PTT_RETURN_LAUNCH_ERROR();
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int Sq, int Sk, int Hq, int Hkv,
               SegMap gq, SegMap gk, float scale, cudaStream_t stream) {
  using S = SegSmem<D>;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *dot = static_cast<const T*>(dout);

  const size_t rows = static_cast<size_t>(B) * Sq * Hq;
  const int warps = 8;
  seg_delta_kernel<T><<<static_cast<unsigned>((rows + warps - 1) / warps),
                        warps * 32, 0, stream>>>(static_cast<const T*>(o), dot,
                                                 delta, B, Sq, Hq, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  auto dq_kern = seg_dq_kernel<T, D>;
  e = cudaFuncSetAttribute(dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(S::dq_bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_kern<<<dim3((Sq + kB - 1) / kB, B * Hq), kThreads, S::dq_bytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), Sq, Sk, Hq, Hkv, gq, gk,
      scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  if (Sk == 0) return 0;
  auto dkv_kern = seg_dkv_kernel<T, D>;
  e = cudaFuncSetAttribute(dkv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(S::dkv_bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  dkv_kern<<<dim3((Sk + kB - 1) / kB, B * Hkv), kThreads, S::dkv_bytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq,
      Sk, Hq, Hkv, gq, gk, scale);
  PTT_RETURN_LAUNCH_ERROR();
}

}  // namespace

// q, o: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D]; lse: [B, Hq, Sq] fp32. The
// descriptor's six ints by value; the wrapper has checked the contract.
extern "C" int ptt_flash_attn_fwd_seg(const void* q, const void* k, const void* v,
                                      void* o, void* lse, int B, int Sq, int Sk,
                                      int Hq, int Hkv, int D, int q_off0,
                                      int q_off1, int q_split, int k_off0,
                                      int k_off1, int k_split, float scale,
                                      int dtype, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const SegMap gq{q_off0, q_off1, q_split}, gk{k_off0, k_off1, k_split};
  const bool f32 = dtype == PTT_F32;
  if (!f32 && dtype != PTT_BF16) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64:
      return f32 ? launch_fwd<float, 64>(q, k, v, o, l, B, Sq, Sk, Hq, Hkv, gq, gk, scale, s)
                 : launch_fwd<__nv_bfloat16, 64>(q, k, v, o, l, B, Sq, Sk, Hq, Hkv, gq,
                                                 gk, scale, s);
    case 128:
      return f32 ? launch_fwd<float, 128>(q, k, v, o, l, B, Sq, Sk, Hq, Hkv, gq, gk, scale, s)
                 : launch_fwd<__nv_bfloat16, 128>(q, k, v, o, l, B, Sq, Sk, Hq, Hkv, gq,
                                                  gk, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, o, dout, dq: [B, Sq, Hq, D]; k, v, dk, dv: [B, Sk, Hkv, D]; lse and the
// scratch delta: [B, Hq, Sq] fp32. All tensors share the dtype code. tma 1
// (bf16 only) takes the wgmma route (see the header).
extern "C" int ptt_flash_attn_bwd_seg(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout,
                                      const void* lse, void* delta, void* dq,
                                      void* dk, void* dv, int B, int Sq, int Sk,
                                      int Hq, int Hkv, int D, int q_off0,
                                      int q_off1, int q_split, int k_off0,
                                      int k_off1, int k_split, float scale,
                                      int dtype, int tma, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const SegMap gq{q_off0, q_off1, q_split}, gk{k_off0, k_off1, k_split};
  const bool f32 = dtype == PTT_F32;
  if (!f32 && dtype != PTT_BF16) return static_cast<int>(cudaErrorInvalidValue);
  if (tma)
    return f32 ? static_cast<int>(cudaErrorInvalidValue)
               : flash_bwd_seg_wgmma(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv,
                                     D, gq, gk, scale, s);
  switch (D) {
    case 64:
      return f32 ? launch_bwd<float, 64>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq,
                                         Sk, Hq, Hkv, gq, gk, scale, s)
                 : launch_bwd<__nv_bfloat16, 64>(q, k, v, o, dout, l, dl, dq, dk, dv,
                                                 B, Sq, Sk, Hq, Hkv, gq, gk, scale, s);
    case 128:
      return f32 ? launch_bwd<float, 128>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq,
                                          Sk, Hq, Hkv, gq, gk, scale, s)
                 : launch_bwd<__nv_bfloat16, 128>(q, k, v, o, dout, l, dl, dq, dk, dv,
                                                  B, Sq, Sk, Hq, Hkv, gq, gk, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
