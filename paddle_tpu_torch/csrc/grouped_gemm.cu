// Grouped (ragged) GEMMs of the MoE expert MLP for Hopper: gmm, gmm2 and
// tgmm over an expert-major token buffer.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/grouped_gemm.py:
//   _gmm_call  (:166, body _gmm_kernel :149)   out[r] = x[r] . w[e]
//   _gmm2_call (:303, body _gmm2_kernel :281)  (x[r] . w1[e], x[r] . w2[e])
//   _tgmm_call (:216, body _tgmm_kernel :195)  dw[e] = x_e^T . dy_e
// The buffer holds expert e's tokens in rows [e*c_pad, e*c_pad + counts[e]);
// the rows after them, up to (e+1)*c_pad, are padding. Same contract as the
// TPU kernels: fp32 accumulation, gmm/gmm2 outputs rounded to x's dtype and
// zero past counts[e], tgmm's dw in fp32 over the live rows only.
//
// Bound on the H100: at the MoE training shapes (65,536 buffer rows of which
// 32,768 live, K/N 1024 and 704, bf16) every call does 2*32768*1024*704 flops
// per weight stream and is bound by operations on the tensor cores; the down
// gmm, whose output includes the 32,768 zero rows, is nearer its byte bound.
// The serving step's fp32 calls (<= 128 live rows) are bound by reading the
// expert weights.
//
// Design:
// * One block of 256 threads per (64-column tile, 64-row tile, expert). The
//   block reads counts[e] itself (the TPU's scalar prefetch). A gmm/gmm2 row
//   tile that starts at or past counts[e] writes zeros and does no math:
//   the ragged skip of _gmm_kernel. Inside a live tile the A loader zeroes
//   rows past counts[e], so the output rows there are exact zeros too.
// * tgmm: one block owns one [64 x 64] tile of one expert's dw and walks the
//   expert's live rows in order, 32 at a time. That loop takes the place of
//   the TPU's sequential "arbitrary" row-tile grid axis: no atomics, one
//   rounding, the same bits on every run.
// * No padding copies. The loaders mask the ragged K and N edges (704 is no
//   multiple of 64) and read w[e] transposed in place for the dx of the
//   backward (kGmmT), so nothing pads or transposes the weights in memory.
// * gmm2 loads each x tile into shared memory once and feeds both weight
//   streams from it, the point of the TPU kernel.
// * bf16 x bf16 runs on the tensor cores through warp-level WMMA 16x16x16
//   fragments with fp32 accumulators (8 warps, each 16 rows x 32 columns of
//   the tile). fp32 x (the serving step) runs on the CUDA cores in full fp32
//   (no TF32), each thread a 4x4 register tile; a bf16 weight is widened in
//   registers, which gives the values of the reference's per-call
//   wg.astype(fp32) without writing the fp32 copy.
// This first version loads tiles with scalar loads and no pipelining;
// TMA, wgmma and a multi-stage ring are later work.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kBM = 64, kBN = 64, kBK = 32, kThreads = 256;
constexpr int kLDA = kBM + 8;  // As[kk][m]: A tile stored k-major
constexpr int kLDB = kBN + 8;  // Bs[kk][n]
constexpr int kLDC = kBN + 4;  // Cs[m][n], fp32 staging of the WMMA result

enum Mode { kGmm = 0, kGmmT = 1, kTgmm = 2 };

// shared-memory element type: bf16 feeds the tensor cores as it is; every
// other combination is widened to fp32 on load
template <typename TA, typename TB> struct Smem { using type = float; };
template <> struct Smem<__nv_bfloat16, __nv_bfloat16> { using type = __nv_bfloat16; };

template <typename S, typename T>
__device__ __forceinline__ S load_as(const T* p, size_t i) {
  if constexpr (std::is_same<S, T>::value) {
    return p[i];
  } else {
    return to_f<T>(p[i]);
  }
}

// C[e][m][n] = sum_kk A(e, m, kk) * B(e, kk, n), per mode:
//   kGmm : A = x [E*c_pad, K] (rows past counts[e] read as 0), B = w [E, K, N],
//          C = out [E*c_pad, N];                            M = c_pad
//   kGmmT: as kGmm with B = w [E, N, K] read transposed (dx = dy . w[e]^T)
//   kTgmm: A(m, kk) = x[e*c_pad + kk][m] with x [E*c_pad, M], B = dy
//          [E*c_pad, N], the sum over kk < counts[e]; C = dw fp32 [E, M, N]
template <Mode MODE, int NB, typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(kThreads)
grouped_gemm_kernel(const TA* __restrict__ a, const TB* __restrict__ b1,
                    const TB* __restrict__ b2, TC* __restrict__ c1,
                    TC* __restrict__ c2, const int* __restrict__ counts, int c_pad,
                    int M, int N, int K) {
  using S = typename Smem<TA, TB>::type;
  constexpr bool kMma = std::is_same<S, __nv_bfloat16>::value;
  // the A and B tiles; the WMMA path stages its fp32 result over them
  constexpr int kTiles = kBK * (kLDA + NB * kLDB) * static_cast<int>(sizeof(S));
  constexpr int kStage = kMma ? kBM * kLDC * 4 : 0;
  __shared__ __align__(128) unsigned char smem[kTiles > kStage ? kTiles : kStage];
  S* As = reinterpret_cast<S*>(smem);                   // [kBK][kLDA]
  S* Bs1 = As + kBK * kLDA;                             // [kBK][kLDB]
  S* Bs2 = Bs1 + kBK * kLDB;                            // gmm2's second stream

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int count = min(max(counts[e], 0), c_pad);     // live rows of expert e
  const size_t row0 = static_cast<size_t>(e) * c_pad;  // its first buffer row
  const S zero = from_f<S>(0.f);

  if (MODE != kTgmm && m0 >= count) {  // the ragged skip: a dead row tile
    const int rows = min(kBM, c_pad - m0);
    for (int i = tid; i < rows * kBN; i += kThreads) {
      const int n = n0 + i % kBN;
      if (n >= N) continue;
      const size_t o = (row0 + m0 + i / kBN) * N + n;
      c1[o] = from_f<TC>(0.f);
      if constexpr (NB == 2) c2[o] = from_f<TC>(0.f);
    }
    return;
  }

  const int depth = MODE == kTgmm ? count : K;  // the contraction's length
  const TB* w1 = b1;
  const TB* w2 = b2;
  if constexpr (MODE != kTgmm) {
    w1 += static_cast<size_t>(e) * K * N;
    if constexpr (NB == 2) w2 += static_cast<size_t>(e) * K * N;
  }

  // fp32 path: each thread a 4x4 register tile; WMMA path: fragments
  const int ty = tid >> 4, tx = tid & 15;
  float acc[NB][4][4];
  const int warp = tid >> 5, wm = warp & 3, wn = warp >> 2;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  FragC frag[kMma ? NB : 1][2];
  if constexpr (kMma) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      wmma::fill_fragment(frag[j][0], 0.f);
      wmma::fill_fragment(frag[j][1], 0.f);
    }
  } else {
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][r][c] = 0.f;
  }

  for (int k0 = 0; k0 < depth; k0 += kBK) {
    __syncthreads();  // the previous tile's reads are done
    // ---- A tile: the global layout's contiguous index runs across threads
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      int m, kk;
      if constexpr (MODE == kTgmm) {
        m = i % kBM, kk = i / kBM;
      } else {
        kk = i % kBK, m = i / kBK;
      }
      const int gm = m0 + m, gk = k0 + kk;
      S v = zero;
      if constexpr (MODE == kTgmm) {
        if (gm < M && gk < count) v = load_as<S>(a, (row0 + gk) * M + gm);
      } else {
        if (gm < count && gk < K) v = load_as<S>(a, (row0 + gm) * K + gk);
      }
      As[kk * kLDA + m] = v;
    }
    // ---- B tile(s)
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      int n, kk;
      if constexpr (MODE == kGmmT) {
        kk = i % kBK, n = i / kBK;
      } else {
        n = i % kBN, kk = i / kBN;
      }
      const int gn = n0 + n, gk = k0 + kk;
      S v1 = zero, v2 = zero;
      if constexpr (MODE == kTgmm) {
        if (gn < N && gk < count) v1 = load_as<S>(w1, (row0 + gk) * N + gn);
      } else if constexpr (MODE == kGmmT) {
        if (gn < N && gk < K) v1 = load_as<S>(w1, static_cast<size_t>(gn) * K + gk);
      } else {
        if (gn < N && gk < K) {
          v1 = load_as<S>(w1, static_cast<size_t>(gk) * N + gn);
          if constexpr (NB == 2) v2 = load_as<S>(w2, static_cast<size_t>(gk) * N + gn);
        }
      }
      Bs1[kk * kLDB + n] = v1;
      if constexpr (NB == 2) Bs2[kk * kLDB + n] = v2;
    }
    __syncthreads();

    if constexpr (kMma) {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa;
        wmma::load_matrix_sync(fa, As + kk * kLDA + wm * 16, kLDA);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, Bs1 + kk * kLDB + wn * 32 + f * 16, kLDB);
          wmma::mma_sync(frag[0][f], fa, fb, frag[0][f]);
          if constexpr (NB == 2) {
            wmma::load_matrix_sync(fb, Bs2 + kk * kLDB + wn * 32 + f * 16, kLDB);
            wmma::mma_sync(frag[NB - 1][f], fa, fb, frag[NB - 1][f]);
          }
        }
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(As + kk * kLDA + ty * 4);
        const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const float4 bv = *reinterpret_cast<const float4*>(
              (j == 0 ? Bs1 : Bs2) + kk * kLDB + tx * 4);
          const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[j][r][c] = fmaf(ar[r], br[c], acc[j][r][c]);
        }
      }
    }
  }

  // ---- epilogue: rows past the tile's range belong to the next expert
  const int m_end = MODE == kTgmm ? M : min(c_pad, m0 + kBM);
  const size_t c_base = MODE == kTgmm ? static_cast<size_t>(e) * M * N : row0 * N;
  if constexpr (kMma) {
    float* Cs = reinterpret_cast<float*>(smem);  // [kBM][kLDC], over As/Bs
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      __syncthreads();  // the last tile's reads (or the previous output's)
      wmma::store_matrix_sync(Cs + wm * 16 * kLDC + wn * 32, frag[j][0], kLDC,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(Cs + wm * 16 * kLDC + wn * 32 + 16, frag[j][1], kLDC,
                              wmma::mem_row_major);
      __syncthreads();
      TC* c = j == 0 ? c1 : c2;
      for (int i = tid; i < kBM * kBN; i += kThreads) {
        const int m = m0 + i / kBN, n = n0 + i % kBN;
        if (m < m_end && n < N)
          c[c_base + static_cast<size_t>(m) * N + n] =
              from_f<TC>(Cs[(i / kBN) * kLDC + i % kBN]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      TC* c = j == 0 ? c1 : c2;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + ty * 4 + r;
        if (m >= m_end) continue;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int n = n0 + tx * 4 + cc;
          if (n < N) c[c_base + static_cast<size_t>(m) * N + n] = from_f<TC>(acc[j][r][cc]);
        }
      }
    }
  }
}

template <Mode MODE, int NB, typename TA, typename TB, typename TC>
int launch(const void* a, const void* b1, const void* b2, void* c1, void* c2,
           const int* counts, int E, int c_pad, int M, int N, int K,
           cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, E);
  grouped_gemm_kernel<MODE, NB, TA, TB, TC><<<grid, kThreads, 0, stream>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b1),
      static_cast<const TB*>(b2), static_cast<TC*>(c1), static_cast<TC*>(c2),
      counts, c_pad, M, N, K);
  PTT_RETURN_LAUNCH_ERROR();
}

template <typename TA, typename TB, typename TC>
int gmm_modes(const void* x, const void* w1, const void* w2, void* o1, void* o2,
              const int* counts, int E, int c_pad, int K, int N, int trans_w,
              cudaStream_t s) {
  if (trans_w) {
    if (w2 != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch<kGmmT, 1, TA, TB, TC>(x, w1, nullptr, o1, nullptr, counts, E, c_pad,
                                        c_pad, N, K, s);
  }
  if (w2 != nullptr)
    return launch<kGmm, 2, TA, TB, TC>(x, w1, w2, o1, o2, counts, E, c_pad, c_pad, N,
                                       K, s);
  return launch<kGmm, 1, TA, TB, TC>(x, w1, nullptr, o1, nullptr, counts, E, c_pad,
                                     c_pad, N, K, s);
}

}  // namespace

// gmm / gmm2 over x [E*c_pad, K] (dtype x_dtype) and w1 (and w2, for gmm2;
// null for gmm) [E, K, N] (dtype w_dtype), or, with trans_w, w1 [E, N, K]
// read as w1[e]^T (no gmm2). o1 (o2) [E*c_pad, N] in x's dtype. counts [E]
// int32 on the device. bf16 x takes bf16 w (tensor cores); fp32 x takes fp32
// or bf16 w (CUDA cores, fp32).
extern "C" int ptt_gmm(const void* x, const void* w1, const void* w2, void* o1,
                       void* o2, const void* counts, int E, int c_pad, int K, int N,
                       int trans_w, int x_dtype, int w_dtype, void* stream) {
  if (E == 0 || c_pad == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* cnt = static_cast<const int*>(counts);
  if (x_dtype == PTT_BF16 && w_dtype == PTT_BF16)
    return gmm_modes<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
        x, w1, w2, o1, o2, cnt, E, c_pad, K, N, trans_w, s);
  if (x_dtype == PTT_F32 && w_dtype == PTT_F32)
    return gmm_modes<float, float, float>(x, w1, w2, o1, o2, cnt, E, c_pad, K, N,
                                          trans_w, s);
  if (x_dtype == PTT_F32 && w_dtype == PTT_BF16)
    return gmm_modes<float, __nv_bfloat16, float>(x, w1, w2, o1, o2, cnt, E, c_pad, K,
                                                  N, trans_w, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// tgmm: dw [E, K, N] fp32 = x_e^T . dy_e over each expert's live rows, for
// x [E*c_pad, K] and dy [E*c_pad, N] of one dtype.
extern "C" int ptt_tgmm(const void* x, const void* dy, void* dw, const void* counts,
                        int E, int c_pad, int K, int N, int dtype, void* stream) {
  if (E == 0 || K == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* cnt = static_cast<const int*>(counts);
  if (dtype == PTT_BF16)
    return launch<kTgmm, 1, __nv_bfloat16, __nv_bfloat16, float>(
        x, dy, nullptr, dw, nullptr, cnt, E, c_pad, K, N, 0, s);
  if (dtype == PTT_F32)
    return launch<kTgmm, 1, float, float, float>(x, dy, nullptr, dw, nullptr, cnt, E,
                                                 c_pad, K, N, 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
