// Segment-causal flash attention for Hopper, forward and backward: causal
// attention over a local q/k window made of two chunks that sit at
// arbitrary global positions (the zig-zag ring's per-step problem), and the
// edge route of the whole flash family.
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
// Routes, chosen by the wrappers from shape and alignment before the launch
// (the `tma` flag of each C entry):
//  - bf16 at head dim 64 or 128 with 16-byte-aligned bases and grids within
//    65535: the wgmma kernels with the segment mask as their compile-time
//    policy, #1's forward (csrc/flash_attention.cu, flash_fwd_seg_wgmma) and
//    #2's dQ and dK/dV (csrc/flash_attention_bwd.cu, flash_bwd_seg_wgmma);
//  - every other call (fp32, a misaligned bf16 base, any other head dim):
//    this file's kernels, the edge route. #1 and #2 take it too, under the
//    descriptor of dense attention (segment.cuh: dense_rows, dense_cols).
//
// The edge kernels are #1/#2's first design with the segment mask:
// products in fp32 on the CUDA cores, no score, probability or ds matrix in
// device memory. Head dims: the kernels are instantiated at a padded head
// dim D of 64, 128 or 256 (head_dim_bucket, common.cuh) and told the real d
// (a multiple of 16): columns at or past d load as zero and are never
// stored, and zero columns leave q.k, p.v and every gradient of the real
// columns exactly as they are; the scale is 1/sqrt(d) with the real d. At
// D 256 the tiles are 32 rows, so that fp32 tiles of Q, K and V (rows padded
// to D + 1 against bank conflicts) fit a block's 227 KB.
// What the design does about the bound is skip dead work: the maps are
// monotone, so a key tile is dead for a query tile once g_k(its first
// column) > g_q(the tile's last row), and every later key tile is dead too;
// the walks stop there instead of masking. A tile pair with g_q(first row)
// >= g_k(last column) is interior and builds no mask. A tile may straddle a
// split (the chunk need not be a multiple of the tile): the predicates read
// the mapped first and last rows and columns, which stays exact under
// monotone maps.
//
// Design: forward and dQ: one block of 256 threads per (query tile,
// batch*head), walking key tiles from 0 to the first dead one; a 16x16
// thread grid owns R x R patches of the score tile (R = tile / 16). dK/dV:
// one block per (key tile, batch*kv head) walking the GQA group's query
// heads and the query tiles from the first live one, the group summed in
// fp32 registers (no atomics: bitwise repeatable); dK and dV come out in
// K's dtype, dQ in Q's. The grids are one-dimensional (tiles fastest), so
// batch x heads has no 65535 limit. A row with nothing visible gives O = 0
// and lse = -inf (_fwd_seg_kernel's _finish, flash_attention.py:449-455).
// Layout: q/o/dO [B, Sq, Hq, d], k/v [B, Sk, Hkv, d] read in place, lse and
// delta [B, Hq, Sq] fp32.
#include "common.cuh"
#include "segment.cuh"

namespace {

constexpr int kThreads = 256;

template <int D> struct Tile {
  static constexpr int B = D > 128 ? 32 : 64;  // rows (and columns) of a tile
  static constexpr int R = B / 16;             // a thread's rows and columns
  static constexpr int DP = D + 1;             // padded fp32 row of a tile
  static constexpr int PP = B + 1;             // padded row of a p / ds tile
  static constexpr size_t fwd_bytes = (2 * B * DP + B * D + B * PP) * sizeof(float);
  static constexpr size_t dq_bytes = (4 * B * DP + B * PP) * sizeof(float);
  static constexpr size_t dkv_bytes = (4 * B * DP + 2 * B * PP + 2 * B) * sizeof(float);
};

// rows r0 .. r0 + B - 1 (below n) of a [., row_stride] matrix, columns below
// d, into dst [B][dst_stride]; everything else zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, size_t row_stride,
                                          int r0, int n, int d, int dst_stride) {
  for (int i = threadIdx.x; i < Tile<D>::B * D; i += kThreads) {
    const int r = i / D, c = i % D, gr = r0 + r;
    dst[r * dst_stride + c] = gr < n && c < d ? to_f<T>(src[gr * row_stride + c]) : 0.f;
  }
}

// ------------------------------------------------------------- forward
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
edge_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o,
                float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv, int d,
                SegMap gq, SegMap gk, float scale) {
  using G = Tile<D>;
  constexpr int BT = G::B, R = G::R, DP = G::DP, PP = G::PP, NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BT][DP]
  float* Ks = Qs + BT * DP;      // [BT][DP]
  float* Vs = Ks + BT * DP;      // [BT][D]
  float* Ps = Vs + BT * D;       // [BT][PP]

  const int n_qt = (Sq + BT - 1) / BT;
  const int q0 = static_cast<int>(blockIdx.x % n_qt) * BT;
  const int bh = static_cast<int>(blockIdx.x / n_qt);
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t q_row = static_cast<size_t>(Hq) * d;
  const size_t kv_row = static_cast<size_t>(Hkv) * d;
  const T* qb = q + (static_cast<size_t>(b) * Sq) * q_row + static_cast<size_t>(h) * d;
  const T* kb = k + (static_cast<size_t>(b) * Sk) * kv_row + static_cast<size_t>(hk) * d;
  const T* vb = v + (static_cast<size_t>(b) * Sk) * kv_row + static_cast<size_t>(hk) * d;

  load_tile<T, D>(Qs, qb, q_row, q0, Sq, d, DP);
  const int g_first = gq(q0), g_last = gq(min(q0 + BT, Sq) - 1);
  int grow[R];
#pragma unroll
  for (int i = 0; i < R; ++i) grow[i] = gq(q0 + ty * R + i);

  float m[R], l[R], acc[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }

  // monotone maps: once a key tile's first column is past the query tile's
  // last row, it and every later key tile are dead
  for (int k0 = 0; k0 < Sk && gk(k0) <= g_last; k0 += BT) {
    const bool interior = k0 + BT <= Sk && g_first >= gk(k0 + BT - 1);
    __syncthreads();  // previous tile's K/V/P reads are done (and Q is stored)
    load_tile<T, D>(Ks, kb, kv_row, k0, Sk, d, DP);
    load_tile<T, D>(Vs, vb, kv_row, k0, Sk, d, D);
    __syncthreads();

    float s[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[R], kv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) qv[i] = Qs[(ty * R + i) * DP + c];
#pragma unroll
      for (int j = 0; j < R; ++j) kv[j] = Ks[(tx + 16 * j) * DP + c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
    int gcol[R];
#pragma unroll
    for (int j = 0; j < R; ++j) gcol[j] = gk(k0 + tx + 16 * j);

#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < R; ++j) {
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
      for (int j = 0; j < R; ++j) {
        const float p = expf(s[i][j] - m_safe);  // masked: exp(-inf) = 0
        sum += p;
        Ps[(ty * R + i) * PP + tx + 16 * j] = round_through<T>(p);
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
    for (int j = 0; j < BT; ++j) {
      float vv[NC];
#pragma unroll
      for (int n = 0; n < NC; ++n) vv[n] = Vs[j * D + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float p = Ps[(ty * R + i) * PP + j];
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(p, vv[n], acc[i][n]);
      }
    }
  }

  T* ob = o + (static_cast<size_t>(b) * Sq) * q_row + static_cast<size_t>(h) * d;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
    if (row >= Sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int n = 0; n < NC; ++n)
      if (tx + 16 * n < d) ob[row * q_row + tx + 16 * n] = from_f<T>(acc[i][n] / l_safe);
    if (tx == 0)
      lse[static_cast<size_t>(bh) * Sq + row] =
          m[i] == -CUDART_INF_F ? -CUDART_INF_F : m[i] + logf(l_safe);
  }
}

// ------------------------------------------------------------ backward
template <typename T>
__global__ void edge_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                  float* __restrict__ delta, int B, int Sq, int Hq,
                                  int d) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * (blockDim.x / 32) +
                     threadIdx.x / 32;  // (b, row, h) in memory order
  const int lane = threadIdx.x & 31;
  if (idx >= static_cast<size_t>(B) * Sq * Hq) return;
  const T* orow = o + idx * d;
  const T* drow = dout + idx * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += to_f<T>(drow[c]) * to_f<T>(orow[c]);
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
edge_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, int d, SegMap gq,
               SegMap gk, float scale) {
  using G = Tile<D>;
  constexpr int BT = G::B, R = G::R, DP = G::DP, PP = G::PP, NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;            // [BT][DP]
  float* dOs = Qs + BT * DP;   // [BT][DP]
  float* Ks = dOs + BT * DP;   // [BT][DP]
  float* Vs = Ks + BT * DP;    // [BT][DP]
  float* dSs = Vs + BT * DP;   // [BT][PP]

  // late query tiles see the most keys: start them first
  const int n_qt = (Sq + BT - 1) / BT;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x % n_qt)) * BT;
  const int bh = static_cast<int>(blockIdx.x / n_qt);
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t q_row = static_cast<size_t>(Hq) * d;
  const size_t kv_row = static_cast<size_t>(Hkv) * d;
  const size_t q_off = (static_cast<size_t>(b) * Sq) * q_row + static_cast<size_t>(h) * d;
  const T* kb = k + (static_cast<size_t>(b) * Sk) * kv_row + static_cast<size_t>(hk) * d;
  const T* vb = v + (static_cast<size_t>(b) * Sk) * kv_row + static_cast<size_t>(hk) * d;

  load_tile<T, D>(Qs, q + q_off, q_row, q0, Sq, d, DP);
  load_tile<T, D>(dOs, dout + q_off, q_row, q0, Sq, d, DP);
  const int g_first = gq(q0), g_last = gq(min(q0 + BT, Sq) - 1);
  float lse_s[R], dl[R];
  int grow[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
    const float l = row < Sq ? lse[static_cast<size_t>(bh) * Sq + row] : 0.f;
    lse_s[i] = l == -CUDART_INF_F ? 0.f : l;
    dl[i] = row < Sq ? delta[static_cast<size_t>(bh) * Sq + row] : 0.f;
    grow[i] = gq(row);
  }
  float acc[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;

  for (int k0 = 0; k0 < Sk && gk(k0) <= g_last; k0 += BT) {
    const bool interior = k0 + BT <= Sk && g_first >= gk(k0 + BT - 1);
    __syncthreads();  // previous tile's K/dS reads are done (Q/dO stored)
    load_tile<T, D>(Ks, kb, kv_row, k0, Sk, d, DP);
    load_tile<T, D>(Vs, vb, kv_row, k0, Sk, d, DP);
    __syncthreads();

    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[R], dov[R], kv[R], vv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = Qs[(ty * R + i) * DP + c];
        dov[i] = dOs[(ty * R + i) * DP + c];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        kv[j] = Ks[(tx + 16 * j) * DP + c];
        vv[j] = Vs[(tx + 16 * j) * DP + c];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
    int gcol[R];
#pragma unroll
    for (int j = 0; j < R; ++j) gcol[j] = gk(k0 + tx + 16 * j);
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = interior || (col < Sk && grow[i] >= gcol[j]);
        const float sv = ok ? s[i][j] * scale : -CUDART_INF_F;
        const float p = expf(sv - lse_s[i]);  // masked: exp(-inf) = 0
        const float ds = p * (dp[i][j] - dl[i]) * scale;
        dSs[(ty * R + i) * PP + tx + 16 * j] = round_through<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      float kv[NC];
#pragma unroll
      for (int n = 0; n < NC; ++n) kv[n] = Ks[j * DP + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float dsv = dSs[(ty * R + i) * PP + j];
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(dsv, kv[n], acc[i][n]);
      }
    }
  }

  T* dqb = dq + q_off;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
    if (row >= Sq) continue;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      if (tx + 16 * n < d) dqb[row * q_row + tx + 16 * n] = from_f<T>(acc[i][n]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
edge_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int Hq,
                int Hkv, int d, SegMap gq, SegMap gk, float scale) {
  using G = Tile<D>;
  constexpr int BT = G::B, R = G::R, DP = G::DP, PP = G::PP, NC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;            // [BT][DP]
  float* Vs = Ks + BT * DP;    // [BT][DP]
  float* Qs = Vs + BT * DP;    // [BT][DP]
  float* dOs = Qs + BT * DP;   // [BT][DP]
  float* Pt = dOs + BT * DP;   // [BT keys][PP], p rounded to dO's dtype
  float* dSt = Pt + BT * PP;   // [BT keys][PP], ds rounded to Q's dtype
  float* Ls = dSt + BT * PP;   // [BT] lse of the query tile (-inf -> 0)
  float* Ds = Ls + BT;         // [BT] delta of the query tile
  __shared__ int Gq[BT];       // global positions of the query tile's rows

  const int n_kt = (Sk + BT - 1) / BT;
  const int k0 = static_cast<int>(blockIdx.x % n_kt) * BT;
  const int bhk = static_cast<int>(blockIdx.x / n_kt);
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int group = Hq / Hkv;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t q_row = static_cast<size_t>(Hq) * d;
  const size_t kv_row = static_cast<size_t>(Hkv) * d;
  const size_t kv_off = (static_cast<size_t>(b) * Sk) * kv_row + static_cast<size_t>(hk) * d;

  load_tile<T, D>(Ks, k + kv_off, kv_row, k0, Sk, d, DP);
  load_tile<T, D>(Vs, v + kv_off, kv_row, k0, Sk, d, DP);
  float adk[R][NC], adv[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) adk[i][n] = adv[i][n] = 0.f;

  // the first live query tile: its last row sees the key tile's first
  // column; with monotone maps every later tile is live too
  const int gk_first = gk(k0), gk_last = gk(k0 + BT - 1);
  int q_begin = 0;
  while (q_begin < Sq && gq(min(q_begin + BT, Sq) - 1) < gk_first) q_begin += BT;
  int gkey[R];
#pragma unroll
  for (int i = 0; i < R; ++i) gkey[i] = gk(k0 + ty * R + i);

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const size_t bh = static_cast<size_t>(b) * Hq + h;
    const size_t q_off = (static_cast<size_t>(b) * Sq) * q_row + static_cast<size_t>(h) * d;
    for (int q0 = q_begin; q0 < Sq; q0 += BT) {
      const bool interior = k0 + BT <= Sk && q0 + BT <= Sq && gq(q0) >= gk_last;
      __syncthreads();  // previous tile's Q/dO/P/dS reads are done
      load_tile<T, D>(Qs, q + q_off, q_row, q0, Sq, d, DP);
      load_tile<T, D>(dOs, dout + q_off, q_row, q0, Sq, d, DP);
      if (tid < BT) {
        const int row = q0 + tid;
        const float l = row < Sq ? lse[bh * Sq + row] : 0.f;
        Ls[tid] = l == -CUDART_INF_F ? 0.f : l;
        Ds[tid] = row < Sq ? delta[bh * Sq + row] : 0.f;
        Gq[tid] = gq(row);
      }
      __syncthreads();

      float s[R][R], dp[R][R];  // [key ty*R+i][query tx+16j]
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        float kv[R], vv[R], qv[R], dov[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          kv[i] = Ks[(ty * R + i) * DP + c];
          vv[i] = Vs[(ty * R + i) * DP + c];
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
          qv[j] = Qs[(tx + 16 * j) * DP + c];
          dov[j] = dOs[(tx + 16 * j) * DP + c];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) {
            s[i][j] = fmaf(qv[j], kv[i], s[i][j]);
            dp[i][j] = fmaf(dov[j], vv[i], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int key = k0 + ty * R + i;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int qi = tx + 16 * j, row = q0 + qi;
          const bool ok =
              interior || (key < Sk && row < Sq && Gq[qi] >= gkey[i]);
          const float sv = ok ? s[i][j] * scale : -CUDART_INF_F;
          const float p = expf(sv - Ls[qi]);
          const float ds = p * (dp[i][j] - Ds[qi]) * scale;
          Pt[(ty * R + i) * PP + qi] = round_through<T>(p);
          dSt[(ty * R + i) * PP + qi] = round_through<T>(ds);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int j = 0; j < BT; ++j) {
        float qv[NC], dov[NC];
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          qv[n] = Qs[j * DP + tx + 16 * n];
          dov[n] = dOs[j * DP + tx + 16 * n];
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float p = Pt[(ty * R + i) * PP + j];
          const float dsv = dSt[(ty * R + i) * PP + j];
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            adv[i][n] = fmaf(p, dov[n], adv[i][n]);
            adk[i][n] = fmaf(dsv, qv[n], adk[i][n]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + ty * R + i;
    if (key >= Sk) continue;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      if (tx + 16 * n >= d) continue;
      const size_t at = kv_off + key * kv_row + tx + 16 * n;
      dk[at] = from_f<T>(adk[i][n]);
      dv[at] = from_f<T>(adv[i][n]);
    }
  }
}

// -------------------------------------------------------------- launch
// (tiles x batch*heads) blocks on one grid axis, or an error past its limit
bool edge_grid(int tiles, long long heads, unsigned* blocks) {
  const long long n = static_cast<long long>(tiles) * heads;
  *blocks = static_cast<unsigned>(n);
  return n <= 0x7fffffffLL;
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
               int B, int Sq, int Sk, int Hq, int Hkv, int d, SegMap gq, SegMap gk,
               float scale, cudaStream_t stream) {
  using G = Tile<D>;
  unsigned blocks;
  if (!edge_grid((Sq + G::B - 1) / G::B, static_cast<long long>(B) * Hq, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = edge_fwd_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(G::fwd_bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<blocks, kThreads, G::fwd_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, Hq, Hkv, d, gq,
      gk, scale);
  PTT_RETURN_LAUNCH_ERROR();
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int d,
               SegMap gq, SegMap gk, float scale, cudaStream_t stream) {
  using G = Tile<D>;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *dot = static_cast<const T*>(dout);
  unsigned dq_blocks, dkv_blocks;
  if (!edge_grid((Sq + G::B - 1) / G::B, static_cast<long long>(B) * Hq, &dq_blocks) ||
      !edge_grid((Sk + G::B - 1) / G::B, static_cast<long long>(B) * Hkv, &dkv_blocks))
    return static_cast<int>(cudaErrorInvalidValue);

  const size_t rows = static_cast<size_t>(B) * Sq * Hq;
  const int warps = 8;
  edge_delta_kernel<T><<<static_cast<unsigned>((rows + warps - 1) / warps),
                         warps * 32, 0, stream>>>(static_cast<const T*>(o), dot,
                                                  delta, B, Sq, Hq, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  auto dq_kern = edge_dq_kernel<T, D>;
  e = cudaFuncSetAttribute(dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(G::dq_bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_kern<<<dq_blocks, kThreads, G::dq_bytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), Sq, Sk, Hq, Hkv, d, gq, gk,
      scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  if (Sk == 0) return 0;
  auto dkv_kern = edge_dkv_kernel<T, D>;
  e = cudaFuncSetAttribute(dkv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(G::dkv_bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  dkv_kern<<<dkv_blocks, kThreads, G::dkv_bytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq,
      Sk, Hq, Hkv, d, gq, gk, scale);
  PTT_RETURN_LAUNCH_ERROR();
}

template <typename T>
int fwd_bucket(const void* q, const void* k, const void* v, void* o, float* lse, int B,
               int Sq, int Sk, int Hq, int Hkv, int d, SegMap gq, SegMap gk, float scale,
               cudaStream_t s) {
  switch (head_dim_bucket(d)) {
    case 64:
      return launch_fwd<T, 64>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, d, gq, gk, scale, s);
    case 128:
      return launch_fwd<T, 128>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, d, gq, gk, scale, s);
    case 256:
      return launch_fwd<T, 256>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, d, gq, gk, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int bwd_bucket(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Sq,
               int Sk, int Hq, int Hkv, int d, SegMap gq, SegMap gk, float scale,
               cudaStream_t s) {
  switch (head_dim_bucket(d)) {
    case 64:
      return launch_bwd<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv,
                               d, gq, gk, scale, s);
    case 128:
      return launch_bwd<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv,
                                d, gq, gk, scale, s);
    case 256:
      return launch_bwd<T, 256>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv,
                                d, gq, gk, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

int flash_fwd_edge(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Sq, int Sk, int Hq, int Hkv, int D, SegMap gq, SegMap gk, float scale,
                   int dtype, cudaStream_t stream) {
  if (B == 0 || Sq == 0) return 0;
  if (dtype == PTT_F32)
    return fwd_bucket<float>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, D, gq, gk, scale, stream);
  if (dtype == PTT_BF16)
    return fwd_bucket<__nv_bfloat16>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, D, gq, gk, scale,
                                     stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

int flash_bwd_edge(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int D, SegMap gq,
                   SegMap gk, float scale, int dtype, cudaStream_t stream) {
  if (B == 0 || Sq == 0) return 0;
  if (dtype == PTT_F32)
    return bwd_bucket<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D,
                             gq, gk, scale, stream);
  if (dtype == PTT_BF16)
    return bwd_bucket<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq,
                                     Hkv, D, gq, gk, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q, o: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D]; lse: [B, Hq, Sq] fp32. The
// descriptor's six ints by value; the wrapper has checked the contract. tma
// 1 (bf16 at head dim 64 or 128 only) takes the wgmma route (see the header).
extern "C" int ptt_flash_attn_fwd_seg(const void* q, const void* k, const void* v,
                                      void* o, void* lse, int B, int Sq, int Sk,
                                      int Hq, int Hkv, int D, int q_off0,
                                      int q_off1, int q_split, int k_off0,
                                      int k_off1, int k_split, float scale,
                                      int dtype, int tma, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const SegMap gq{q_off0, q_off1, q_split}, gk{k_off0, k_off1, k_split};
  if (tma)
    return dtype == PTT_BF16
               ? flash_fwd_seg_wgmma(q, k, v, o, l, B, Sq, Sk, Hq, Hkv, D, gq, gk, scale, s)
               : static_cast<int>(cudaErrorInvalidValue);
  return flash_fwd_edge(q, k, v, o, l, B, Sq, Sk, Hq, Hkv, D, gq, gk, scale, dtype, s);
}

// q, o, dout, dq: [B, Sq, Hq, D]; k, v, dk, dv: [B, Sk, Hkv, D]; lse and the
// scratch delta: [B, Hq, Sq] fp32. All tensors share the dtype code. tma 1
// (bf16 at head dim 64 or 128 only) takes the wgmma route (see the header).
extern "C" int ptt_flash_attn_bwd_seg(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout,
                                      const void* lse, void* delta, void* dq,
                                      void* dk, void* dv, int B, int Sq, int Sk,
                                      int Hq, int Hkv, int D, int q_off0,
                                      int q_off1, int q_split, int k_off0,
                                      int k_off1, int k_split, float scale,
                                      int dtype, int tma, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const SegMap gq{q_off0, q_off1, q_split}, gk{k_off0, k_off1, k_split};
  if (tma)
    return dtype == PTT_BF16 ? flash_bwd_seg_wgmma(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq,
                                                   Sk, Hq, Hkv, D, gq, gk, scale, s)
                             : static_cast<int>(cudaErrorInvalidValue);
  return flash_bwd_edge(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D, gq, gk,
                        scale, dtype, s);
}
