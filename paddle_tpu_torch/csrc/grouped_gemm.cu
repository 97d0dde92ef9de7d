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
// * The block reads counts[e] itself (the TPU's scalar prefetch). A gmm/gmm2
//   row tile that starts at or past counts[e] writes zeros and does no math:
//   the ragged skip of _gmm_kernel; inside a live tile the rows past
//   counts[e] are stored as exact zeros whatever the buffer holds there.
// * bf16 gmm, gmm2 and gmm_t (the training paths): wgmma over a TMA ring
//   (hopper.cuh), one block of 288 threads per (256 output columns, or 128
//   of gmm2, 128-row tile, expert): two consumer warpgroups of 64 rows and one producer warp
//   keeping a 4-stage ring of 64-deep stages full, guarded by full/empty
//   mbarriers; each warpgroup keeps two m64n128 accumulators, so a block
//   covers 256 output columns of gmm and gmm_t, or the same 128 columns of
//   gmm2's two weight streams. A arrives by a 3-D tensor map over x as
//   [E, c_pad, K]: a
//   box never reads the next expert's rows (rows past c_pad, when c_pad is
//   no multiple of 128, land as zeros and are not stored), and K's ragged
//   edge zero-fills. B arrives by a 3-D map over w: [E, K, N] for gmm and
//   gmm2, read MN-major in place through the transpose bit, and [E, N, K]
//   for gmm_t (dx = dy . w[e]^T), read K-major. gmm2 feeds both weight
//   streams from each A stage (two m64n128 accumulators a warpgroup), the
//   point of the TPU kernel. Each output element has one block and one
//   summation order (no split-K, no atomics): repeats are bitwise. K and N
//   must be multiples of 8 (TMA's 16-byte strides).
// * tgmm: one block of 256 threads owns one [64 x 64] tile of one expert's
//   dw and walks the expert's live rows in order, 32 at a time. That loop
//   takes the place of the TPU's sequential "arbitrary" row-tile grid axis:
//   no atomics, one rounding, the same bits on every run. bf16 runs on warp-
//   level WMMA 16x16x16 fragments with fp32 accumulators (8 warps, each 16
//   rows x 32 columns of the tile), from scalar loads with no pipelining.
// * fp32 x (the serving step, and tgmm in fp32): the same template's CUDA-
//   core branch, each thread a 4x4 register tile in full fp32 (no TF32); a bf16
//   weight is widened in registers, which gives the values of the
//   reference's per-call wg.astype(fp32) without writing the fp32 copy. Its
//   loaders mask the ragged K and N edges (704 is no multiple of 64) and read
//   w[e] transposed in place for the dx (kGmmT).
#include <mma.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

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

// ------------------------------------------------------------------ bf16
// gmm, gmm2 and gmm_t on wgmma over a TMA ring (hopper.cuh): see the header.
namespace wg {

using bf16 = __nv_bfloat16;
constexpr int kRows = 128;                 // a row tile: two warpgroups of 64
constexpr int kNH = 128;                   // output columns of one accumulator
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kStages = 4;
constexpr int kA = kRows * 128;            // a 64-deep A stage, [128][64] bf16
constexpr int kB = kNH * 128;              // a 64-deep B stage of 128 columns
constexpr int kStage = kA + 2 * kB;        // A and the two accumulators' B
constexpr int kBarOff = kStages * kStage;
constexpr int kBytes = kBarOff + 2 * kStages * 8 + hopper::kSmemAlign;

// Every block keeps two m64n128 accumulators a warpgroup, fed by each A
// stage: kGmm2, the same 128 columns of w1 and of w2 (o1, o2); kGmm and
// kGmmT, 256 columns of one weight (o1). kGmm/kGmm2 read B = w [E, K, N] in
// 64x64 boxes, MN-major through the transpose bit; kGmmT reads B = w [E, N,
// K] in 128-row boxes, K-major.
enum Kind { kOne = 0, kTwo = 1, kOneT = 2 };

template <int KIND>
__global__ void __launch_bounds__(kThreads, 1)
gmm_wgmma(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w1,
          const __grid_constant__ CUtensorMap map_w2, const int* __restrict__ counts,
          bf16* __restrict__ o1, bf16* __restrict__ o2, int c_pad, int K, int N) {
  constexpr bool kTrans = KIND == kOneT, kPair = KIND == kTwo;
  constexpr int kCols = kPair ? kNH : 2 * kNH;  // output columns a block
  const int e = blockIdx.z;
  const int count = min(max(counts[e], 0), c_pad);  // live rows of expert e
  const int m0 = blockIdx.y * kRows, n0 = blockIdx.x * kCols;
  const int rows = min(kRows, c_pad - m0);  // the tile's rows in this expert
  const size_t row0 = static_cast<size_t>(e) * c_pad + m0;
  if (m0 >= count) {  // the ragged skip: a dead row tile writes zeros, 8 a store
    const int cols = min(kCols, N - n0) / 8;  // N % 8 == 0
    const uint4 z = make_uint4(0, 0, 0, 0);
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const size_t at = (row0 + i / cols) * N + n0 + 8 * (i % cols);
      *reinterpret_cast<uint4*>(o1 + at) = z;
      if constexpr (kPair) *reinterpret_cast<uint4*>(o2 + at) = z;
    }
    return;
  }
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kBarOff);
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers / 32);  // one arrival a consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int n_k = (K + 63) / 64;
  // the second accumulator's columns, where any lies below N
  const int n_acc = kPair || n0 + kNH < N ? 2 : 1;
  if (warp == kConsumers / 32) {  // the producer warp
    if (lane == 0) {
      for (int t = 0; t < n_k; ++t) {
        const int s = t % kStages, k0 = t * 64;
        if (t >= kStages) hopper::mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
        unsigned char* st = sm + s * kStage;
        hopper::mbar_arrive_expect_tx(&full[s], kA + n_acc * kB);
        // A: rows past c_pad are out of expert e's box and land as zeros
        hopper::tma_load_3d(st, &map_x, &full[s], k0, m0, e);
        for (int j = 0; j < n_acc; ++j) {
          unsigned char* bt = st + kA + j * kB;
          const CUtensorMap* mw = kPair && j == 1 ? &map_w2 : &map_w1;
          const int nb = kPair ? n0 : n0 + j * kNH;
          if constexpr (kTrans) {
            hopper::tma_load_3d(bt, mw, &full[s], k0, nb, e);
          } else {
            hopper::tma_load_3d(bt, mw, &full[s], nb, k0, e);
            hopper::tma_load_3d(bt + kB / 2, mw, &full[s], nb + 64, k0, e);
          }
        }
      }
    }
    return;
  }

  const int g = warp >> 2;
  float acc[2][64];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[j][i] = 0.f;
  for (int t = 0; t < n_k; ++t) {
    const int s = t % kStages;
    hopper::mbar_wait(&full[s], (t / kStages) & 1);
    const unsigned char* st = sm + s * kStage;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = hopper::desc_sw128(st + g * 64 * 128 + kk * 32, 16, 1024);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const unsigned char* bt = st + kA + j * kB;
        const uint64_t db = kTrans ? hopper::desc_sw128(bt + kk * 32, 16, 1024)
                                   : hopper::desc_sw128(bt + kk * 16 * 128, kB / 2, 1024);
        if (j < n_acc) hopper::wgmma_m64n128_ss<kTrans ? 0 : 1>(acc[j], da, db, 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc[0]);
    hopper::fence_regs(acc[1]);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  // rows past counts[e] are exact zeros whatever x holds there
  const int wq = warp & 3;
  const int rt = 64 * g + 16 * wq + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    bf16* out = kPair && j == 1 ? o2 : o1;
    const int nb = kPair ? n0 : n0 + j * kNH;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = rt + ((i & 2) ? 8 : 0);
      const int col = nb + 8 * (i / 4) + 2 * (lane & 3);
      const bool live = m0 + r < count;
      if (r < rows && col < N)  // N is even: the pair is in or out
        *reinterpret_cast<__nv_bfloat162*>(out + (row0 + r) * N + col) =
            __floats2bfloat162_rn(live ? acc[j][i] : 0.f, live ? acc[j][i + 1] : 0.f);
    }
  }
}

template <int KIND>
int launch(const void* x, const void* w1, const void* w2, void* o1, void* o2,
           const int* counts, int E, int c_pad, int K, int N, cudaStream_t stream) {
  constexpr bool kTrans = KIND == kOneT;
  constexpr int kCols = KIND == kTwo ? kNH : 2 * kNH;
  // TMA: 16-byte aligned bases and row strides (and the dead tiles' stores)
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1) |
                         reinterpret_cast<uintptr_t>(w2) | reinterpret_cast<uintptr_t>(o1) |
                         reinterpret_cast<uintptr_t>(o2);
  if (K % 8 != 0 || N % 8 != 0 || bits % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int row_tiles = (c_pad + kRows - 1) / kRows;
  if (row_tiles > 65535 || E > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t k = K, n = N, e = E, cp = c_pad;
  CUtensorMap mx, m1, m2;
  const uint64_t dx[3] = {k, cp, e}, sx[2] = {k * 2, cp * k * 2};  // x [E, c_pad, K]
  const uint32_t bx[3] = {64, kRows, 1};
  int err = hopper::bf16_map(&mx, x, 3, dx, sx, bx);
  // w [E, N, K] (kOneT) in 128-row boxes, or w [E, K, N] in 64x64 boxes
  const uint64_t dw[3] = {kTrans ? k : n, kTrans ? n : k, e};
  const uint64_t sw[2] = {dw[0] * 2, k * n * 2};
  const uint32_t bw[3] = {64, kTrans ? static_cast<uint32_t>(kNH) : 64u, 1};
  if (err == 0) err = hopper::bf16_map(&m1, w1, 3, dw, sw, bw);
  if (err == 0) err = hopper::bf16_map(&m2, KIND == kTwo ? w2 : w1, 3, dw, sw, bw);
  if (err != 0) return err;
  auto kern = gmm_wgmma<KIND>;
  cudaError_t r = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (r != cudaSuccess) return static_cast<int>(r);
  const dim3 grid((N + kCols - 1) / kCols, row_tiles, E);
  kern<<<grid, kThreads, kBytes, stream>>>(mx, m1, m2, counts, static_cast<bf16*>(o1),
                                           static_cast<bf16*>(o2), c_pad, K, N);
  PTT_RETURN_LAUNCH_ERROR();
}

int gmm_modes(const void* x, const void* w1, const void* w2, void* o1, void* o2,
              const int* counts, int E, int c_pad, int K, int N, int trans_w, cudaStream_t s) {
  if (trans_w) {
    if (w2 != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch<kOneT>(x, w1, nullptr, o1, nullptr, counts, E, c_pad, K, N, s);
  }
  if (w2 != nullptr) return launch<kTwo>(x, w1, w2, o1, o2, counts, E, c_pad, K, N, s);
  return launch<kOne>(x, w1, nullptr, o1, nullptr, counts, E, c_pad, K, N, s);
}

}  // namespace wg

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
    return wg::gmm_modes(x, w1, w2, o1, o2, cnt, E, c_pad, K, N, trans_w, s);
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
