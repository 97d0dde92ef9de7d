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
// The mask is a compile-time policy of both kernels: DenseMask (causal or
// full, chosen at run time: #2) or SegMask, the segment-causal mask of the
// zig-zag ring's steps (segment.cuh), through which these same kernels are
// #4's bf16 route (flash_bwd_seg_wgmma, called by
// csrc/flash_attention_seg.cu; it replaces the TPU kernel
// paddle_tpu/ops/pallas/flash_attention.py:_bwd_seg, :622). Under either
// policy a query row sees a prefix of the keys and a key a suffix of the
// queries, so the walks stop at the first dead key tile (dQ) and start at
// the first live query tile (dK/dV), only tiles that are not interior build
// a mask, and late query tiles (dQ) and early key tiles (dK/dV), which the
// schedule starts first, are the longest. A segment step can leave a whole
// tile with nothing visible: its block walks no tile and stores zeros.
//
// Every other call (fp32, head dims other than 64 and 128, a misaligned
// bf16 base, a grid past 65535) takes the edge route, the CUDA-core kernels
// of csrc/flash_attention_seg.cu under the descriptor of dense attention
// (three launches: delta, dQ, dK/dV summed over the group in registers); the
// wrapper picks the route from shape and alignment before the launch.
// Layout as the forward: q/o/dO [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] read in
// place, lse and delta [B, Hq, Sq] fp32. Masks use the true lengths
// (col < Sk, row < Sq, causal col <= row).
#include "common.cuh"
#include "hopper.cuh"
#include "segment.cuh"

namespace {

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

template <int D, class Mask>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_do,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, const bf16* __restrict__ o,
                   const float* __restrict__ lse, float* __restrict__ delta,
                   bf16* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, Mask mask,
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
  const int k_end = mask.keys(q0, BM, Sq, Sk);
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
  // tiles past n_live hold only keys that no row of this warpgroup sees;
  // they are waited for and freed, never computed
  const int n_live = mask.live_tiles(n_tiles, last, BN, Sq, Sk);
  const int p_lo = mask.qpos(r_lo), p_hi = mask.qpos(r_hi);
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
    if (mask.dq_edge(k0, BN, first, Sk)) {  // the edge tiles only
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int col = k0 + 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
        if (mask.dq_hidden((i & 2) ? p_hi : p_lo, col, Sk)) sc[i] = -CUDART_INF_F;
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

template <int D, class Mask>
__global__ void __launch_bounds__(DkvCfg<D>::kThreads, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv, Mask mask,
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
  // query tiles that end before the key tile starts see none of it
  const int t_begin = mask.first_q_tile(k0, BQ, Sq);
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
  const int kp_lo = mask.kpos(key_lo), kp_hi = mask.kpos(key_hi);
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
    if (mask.q_tile_dead(q0, BQ, kw, Sq)) {  // every query of the tile precedes these keys
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
    if (mask.dkv_edge(kw, q0)) {  // the diagonal tiles only
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int col = q0 + 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
        if (mask.dkv_hidden((i & 2) ? kp_hi : kp_lo, col)) st[i] = -CUDART_INF_F;
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

template <int D, class Mask>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Sq, int Sk,
           int Hq, int Hkv, Mask mask, float scale, cudaStream_t stream) {
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
  auto k1 = flash_bwd_dq_wgmma<D, Mask>;
  cudaError_t e =
      cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, C1::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 g1 = hf1 ? dim3(B * Hq, q_tiles) : dim3(q_tiles, B * Hq);
  k1<<<g1, kThreads, C1::kBytes, stream>>>(mq1, mdo1, mk1, mv1, static_cast<const bf16*>(o), lse,
                                           delta, static_cast<bf16*>(dq), Sq, Sk, Hq, Hkv,
                                           mask, scale, hf1);
  e = cudaGetLastError();
  if (e != cudaSuccess || none) return static_cast<int>(e);

  err = map_bshd(&mq2, q, B, Sq, Hq, D, C2::BQ);
  if (err == 0) err = map_bshd(&mdo2, dout, B, Sq, Hq, D, C2::BQ);
  if (err == 0) err = map_bshd(&mk2, k, B, Sk, Hkv, D, C2::BK);
  if (err == 0) err = map_bshd(&mv2, v, B, Sk, Hkv, D, C2::BK);
  if (err != 0) return err;
  auto k2 = flash_bwd_dkv_wgmma<D, Mask>;
  e = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, C2::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 g2 = hf2 ? dim3(B * Hkv, k_tiles) : dim3(k_tiles, B * Hkv);
  k2<<<g2, C2::kThreads, C2::kBytes, stream>>>(mq2, mdo2, mk2, mv2, lse, delta,
                                           static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq,
                                           Sk, Hq, Hkv, mask, scale, hf2);
  PTT_RETURN_LAUNCH_ERROR();
}

}  // namespace wg

}  // namespace

// q, o, dout, dq: [B, Sq, Hq, D]; k, v, dk, dv: [B, Sk, Hkv, D]; lse and the
// scratch delta: [B, Hq, Sq] fp32. All tensors share the dtype code. tma 1
// (bf16 at head dim 64 or 128, 16-byte-aligned bases) takes the wgmma
// kernels; tma 0 the edge route (csrc/flash_attention_seg.cu) under the
// dense descriptor. The wrapper picks the route from shape and alignment.
extern "C" int ptt_flash_attn_bwd(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, void* delta, void* dq,
                                  void* dk, void* dv, int B, int Sq, int Sk,
                                  int Hq, int Hkv, int D, int causal,
                                  float scale, int dtype, int tma, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (!tma)
    return flash_bwd_edge(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D,
                          dense_rows(Sq, Sk, causal), dense_cols(Sk), scale, dtype, s);
  if (dtype == PTT_BF16 && D == 64)
    return wg::launch<64>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv,
                          DenseMask{causal}, scale, s);
  if (dtype == PTT_BF16 && D == 128)
    return wg::launch<128>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv,
                           DenseMask{causal}, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int flash_bwd_seg_wgmma(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* delta, void* dq, void* dk,
                        void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int D, SegMap gq,
                        SegMap gk, float scale, cudaStream_t stream) {
  if (B == 0 || Sq == 0) return 0;
  if (D == 64)
    return wg::launch<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv,
                          SegMask{gq, gk}, scale, stream);
  if (D == 128)
    return wg::launch<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv,
                           SegMask{gq, gk}, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
