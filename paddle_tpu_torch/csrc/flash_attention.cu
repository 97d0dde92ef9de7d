// Flash-attention forward for Hopper: causal (top-left aligned) or full,
// GQA, fp32 online softmax; emits O and the log-sum-exp.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py:_fwd_kernel
// (grid and specs in _fwd, flash_attention.py:130 -> pallas_call :146;
// wrapper logic of _prep / flash_attention_with_lse, :844-921).
//
// Bound on the H100: operations. A 2048-token causal head does
// ~2*2*2048*2048/2*128 flops on 2048*128*2*4 bytes, hundreds of flops per
// byte, above the card's ~295 flop/byte bf16 ridge, so the products belong
// on the tensor cores and the operands must reach them without stalling.
//
// bf16 (the training and serving path): the FlashAttention-3 layout, kept
// simple. One block of 288 threads per (128-row query tile, batch*head):
// two consumer warpgroups of 64 query rows and one producer warp. The
// producer's lane 0 loads the Q tile once and then K/V tiles of BN keys by
// TMA (4-D tensor maps over [B, S, H, D] read in place: row stride H*D*2
// bytes, out-of-range keys zero-filled per batch) into a ring of
// 128-byte-swizzled atoms guarded by full/empty mbarriers. Each consumer
// warpgroup runs S = Q.K^T with wgmma (K is K-major), the online softmax
// on the accumulator fragments in registers (row max and sum across the
// four lanes of a row by shuffles; the scale folded into the exponent's
// FFMA, 2^x on the special-function unit), casts P to bf16 in registers as
// the A operand of O += P.V (V MN-major: the transpose bit, no transposed
// copy), and frees the stage. At head dim 64, tile t's S is issued before
// tile t-1's P.V, so tile t's softmax runs while the tensor cores do t-1's
// P.V (the warpgroup holds two stages: a 4-stage ring); at head dim 128 a
// tile at a time (a 3-stage ring), which keeps S, P and O of a 128-key tile
// in registers (with the overlap, ptxas serialized the wgmmas for want of
// registers; 64-key tiles were slower on the card). Key tiles above the causal diagonal are
// never loaded; only diagonal and ragged-edge tiles are masked. Blocks run
// the longest causal tiles first, across all heads where every head's K/V
// fits a third of L2, else within one head at a time, so the blocks in
// flight share one kv head's K/V in L2 (32k tokens x 8 kv heads of 64 is
// 64 MB). P is rounded through V's dtype for the product while l sums the
// unrounded p (flash_attention.py:95). At head dim 64 a 128x128 tile's
// 16,384 exps take the special-function units as long as its products take
// the tensor cores; overlapping the two across the warpgroups is the next
// step.
//
// fp32: the CUDA-core kernel below (the first port's design, full fp32 and
// no TF32): one block of 256 threads per (64-row query tile, batch*head),
// a 16x16 thread grid owning a 4x4 patch of the 64x64 score tile and a
// 4 x D/16 patch of the output accumulator in registers.
//
// Layout: q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] (Paddle's flash layout, read
// in place: no transposes), o like q, lse [B, Hq, Sq] fp32. GQA: query head
// h reads kv head h / (Hq/Hkv). Masks use the true lengths: col < Sk, and
// for causal col <= row. A row with nothing visible gives O = 0 and
// lse = -inf.
#include "common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------- bf16
namespace wg {

using bf16 = __nv_bfloat16;
constexpr int kBM = 128;                  // query rows a block
constexpr int kConsumers = 256;           // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32; // and one producer warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D> struct Cfg {
  static constexpr int BN = 128;                 // keys a tile
  // D 64: tile t's softmax overlaps t-1's P.V (a warpgroup holds two
  // stages); D 128: one tile at a time, which keeps S, P and O in registers
  static constexpr bool kOverlap = D == 64;
  static constexpr int kStages = kOverlap ? 4 : 3;
  static constexpr int kAtoms = D / 64;          // 64-column atoms of a row
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kTile = BN * D * 2;       // one K or V tile
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kTile;
  static constexpr int kBarOff = kVOff + kStages * kTile;
  static constexpr int kBytes = kBarOff + (1 + 2 * kStages) * 8 + hopper::kSmemAlign;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
                float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv, int causal,
                float scale_log2, int heads_fastest) {
  using C = Cfg<D>;
  constexpr int BN = C::BN, kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align_smem(smem_raw);
  unsigned char* Qs = sm;
  unsigned char* Ks = sm + C::kKOff;
  unsigned char* Vs = sm + C::kVOff;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + C::kBarOff);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  // the longest causal tiles first: across all heads when every head's
  // K/V fits in L2 together, else within one head at a time (query tiles
  // varying fastest), so that the blocks in flight share one kv head's K/V
  const int bh = heads_fastest ? blockIdx.x : blockIdx.y;
  const int qt = heads_fastest ? blockIdx.y : blockIdx.x;
  const int b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const int q0 = ((heads_fastest ? gridDim.y : gridDim.x) - 1 - qt) * kBM;
  const int k_end = causal ? min(Sk, q0 + kBM) : Sk;
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
      hopper::mbar_arrive_expect_tx(q_full, C::kQBytes);
      for (int a = 0; a < C::kAtoms; ++a)
        hopper::tma_load_4d(Qs + a * kBM * 128, &map_q, q_full, a * 64, h, q0, b);
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
  float acc_o[D / 2], sc[BN / 2];
  uint32_t pa[BN / 16][4];  // P in bf16: the A fragments of O += P.V
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
  float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F, l_lo = 0.f, l_hi = 0.f;
  float al_lo = 0.f, al_hi = 0.f;

  auto issue_s = [&](int s) {  // sc = Q.K^T of stage s
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da = hopper::desc_sw128(
          Qs + (kk / 4) * kBM * 128 + g * 64 * 128 + (kk % 4) * 32, 16, 1024);
      const uint64_t db = hopper::desc_sw128(
          Ks + s * C::kTile + (kk / 4) * BN * 128 + (kk % 4) * 32, 16, 1024);
      hopper::wgmma_m64n128_ss<0>(sc, da, db, kk > 0);
    }
    hopper::wgmma_commit();
  };
  auto issue_pv = [&](int s) {  // acc_o += P.V of stage s
    hopper::fence_regs(acc_o);
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
      hopper::wgmma_rs<D, 1>(acc_o, pa[j],
                             hopper::desc_sw128(Vs + s * C::kTile + j * 16 * 128, BN * 128, 1024),
                             1);
    hopper::wgmma_commit();
  };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  };
  // the online softmax of the scores in sc for keys k0..: sc becomes p, m
  // and this lane's share of l are updated, al_* rescale the old O
  auto softmax = [&](int k0) {
    if (k0 + BN > Sk || (causal && k0 + BN - 1 > first)) {  // the edge tiles only
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int col = k0 + 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
        const int row = (i & 2) ? r_hi : r_lo;
        if (col >= Sk || (causal && col > row)) sc[i] = -CUDART_INF_F;
      }
    }
    float mx_lo = -CUDART_INF_F, mx_hi = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      if (i & 2)
        mx_hi = fmaxf(mx_hi, sc[i]);
      else
        mx_lo = fmaxf(mx_lo, sc[i]);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {  // the row's four lanes
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    // raw scores; p = 2^(s*c - m*c) with c = scale*log2(e), one FFMA each
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float ms_lo = mn_lo == -CUDART_INF_F ? 0.f : mn_lo * scale_log2;
    const float ms_hi = mn_hi == -CUDART_INF_F ? 0.f : mn_hi * scale_log2;
    al_lo = hopper::exp2_approx(m_lo * scale_log2 - ms_lo);  // 2^-inf = 0 on first use
    al_hi = hopper::exp2_approx(m_hi * scale_log2 - ms_hi);
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const float p = hopper::exp2_approx(fmaf(sc[i], scale_log2, (i & 2) ? -ms_hi : -ms_lo));
      sc[i] = p;  // masked: 0
      if (i & 2)
        sum_hi += p;
      else
        sum_lo += p;
    }
    l_lo = l_lo * al_lo + sum_lo;
    l_hi = l_hi * al_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
  };
  auto rescale_pack = [&]() {  // only once no P.V is in flight
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_o[i] *= (i & 2) ? al_hi : al_lo;
    hopper::pack_a(pa, sc);
  };

  hopper::mbar_wait(q_full, 0);
  if constexpr (C::kOverlap) {  // tile t's softmax beside tile t-1's P.V
    if (n_live > 0) {
      hopper::mbar_wait(&full[0], 0);
      issue_s(0);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      softmax(0);
      rescale_pack();
    }
    for (int t = 1; t < n_live; ++t) {
      const int s = t % kStages, sp = (t - 1) % kStages;
      hopper::mbar_wait(&full[s], (t / kStages) & 1);
      issue_s(s);
      issue_pv(sp);
      hopper::wgmma_wait<1>();  // S of tile t has landed; P.V of t-1 runs on
      hopper::fence_regs(sc);
      softmax(t * BN);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc_o);
      release(sp);
      rescale_pack();
    }
    if (n_live > 0) {
      const int sp = (n_live - 1) % kStages;
      issue_pv(sp);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc_o);
      release(sp);
    }
  } else {  // a tile at a time
    for (int t = 0; t < n_live; ++t) {
      const int s = t % kStages;
      hopper::mbar_wait(&full[s], (t / kStages) & 1);
      issue_s(s);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      softmax(t * BN);
      rescale_pack();
      issue_pv(s);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc_o);
      release(s);
    }
  }
  for (int t = n_live; t < n_tiles; ++t) {  // no key here is visible
    const int s = t % kStages;
    hopper::mbar_wait(&full[s], (t / kStages) & 1);
    release(s);
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float ls_lo = l_lo == 0.f ? 1.f : l_lo, ls_hi = l_hi == 0.f ? 1.f : l_hi;
  const float inv_lo = 1.f / ls_lo, inv_hi = 1.f / ls_hi;
  const size_t row_stride = static_cast<size_t>(Hq) * D;
  bf16* ob = o + static_cast<size_t>(b) * Sq * row_stride + static_cast<size_t>(h) * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = (i & 2) ? r_hi : r_lo;
    const float inv = (i & 2) ? inv_hi : inv_lo;
    if (row < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row * row_stride + 8 * (i / 4) +
                                         2 * (lane & 3)) =
          __floats2bfloat162_rn(acc_o[i] * inv, acc_o[i + 1] * inv);
  }
  if ((lane & 3) == 0) {
    float* lb = lse + static_cast<size_t>(bh) * Sq;
    if (r_lo < Sq)
      lb[r_lo] = m_lo == -CUDART_INF_F ? -CUDART_INF_F
                                       : (m_lo * scale_log2 + log2f(ls_lo)) * kLn2;
    if (r_hi < Sq)
      lb[r_hi] = m_hi == -CUDART_INF_F ? -CUDART_INF_F
                                       : (m_hi * scale_log2 + log2f(ls_hi)) * kLn2;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq,
           int Sk, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  // [B, S, H, D] as 4-D maps, innermost first; a box is 64 columns of one
  // head over kBM (Q) or BN (K, V) rows of one batch
  CUtensorMap mq, mk, mv;
  const uint64_t dq[4] = {D, static_cast<uint64_t>(Hq), static_cast<uint64_t>(Sq),
                          static_cast<uint64_t>(B)};
  const uint64_t sq[3] = {D * 2ull, static_cast<uint64_t>(Hq) * D * 2,
                          static_cast<uint64_t>(Sq) * Hq * D * 2};
  const uint32_t bq[4] = {64, 1, kBM, 1};
  // no keys: no K/V tile is loaded, so the maps may describe Q's memory
  const bool none = Sk == 0;
  const uint64_t skv = none ? Sq : Sk;
  const uint64_t hkv = none ? Hq : Hkv;
  const uint64_t dk[4] = {D, hkv, skv, static_cast<uint64_t>(B)};
  const uint64_t sk[3] = {D * 2ull, hkv * D * 2, skv * hkv * D * 2};
  const uint32_t bk[4] = {64, 1, C::BN, 1};
  // every head's K and V together against a third of the 50 MB L2
  const bool heads_fastest = static_cast<uint64_t>(B) * Hkv * Sk * D * 4 <= (16ull << 20);
  const int q_tiles = (Sq + kBM - 1) / kBM;
  if ((heads_fastest ? q_tiles : B * Hq) > 65535)  // grid.y
    return static_cast<int>(cudaErrorInvalidValue);
  int err = hopper::bf16_map(&mq, q, 4, dq, sq, bq);
  if (err == 0) err = hopper::bf16_map(&mk, none ? q : k, 4, dk, sk, bk);
  if (err == 0) err = hopper::bf16_map(&mv, none ? q : v, 4, dk, sk, bk);
  if (err != 0) return err;
  auto kern = flash_fwd_wgmma<D>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid = heads_fastest ? dim3(B * Hq, q_tiles) : dim3(q_tiles, B * Hq);
  kern<<<grid, kThreads, C::kBytes, stream>>>(mq, mk, mv, static_cast<bf16*>(o), lse, Sq, Sk,
                                              Hq, Hkv, causal, scale * kLog2e,
                                              heads_fastest);
  PTT_RETURN_LAUNCH_ERROR();
}

}  // namespace wg

// ---------------------------------------------------------------- fp32
namespace f32 {

constexpr int kBQ = 64, kBK = 64, kThreads = 256;

template <int D> struct Smem {
  static constexpr int DP = D + 1;   // padded row of the Q and K tiles
  static constexpr int PP = kBK + 1; // padded row of the probability tile
  static constexpr size_t floats = kBQ * DP + kBK * DP + kBK * D + kBQ * PP;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
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
  const float* qb = q + (static_cast<size_t>(b) * Sq) * q_row + h * D;
  const float* kb = k + (static_cast<size_t>(b) * Sk) * kv_row + hk * D;
  const float* vb = v + (static_cast<size_t>(b) * Sk) * kv_row + hk * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D, gr = q0 + r;
    Qs[r * DP + c] = gr < Sq ? qb[gr * q_row + c] : 0.f;
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
      Ks[r * DP + c] = in ? kb[gr * kv_row + c] : 0.f;
      Vs[r * D + c] = in ? vb[gr * kv_row + c] : 0.f;
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
        Ps[(ty * 4 + i) * PP + tx + 16 * j] = p;
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

  float* ob = o + (static_cast<size_t>(b) * Sq) * q_row + h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int n = 0; n < NC; ++n) ob[row * q_row + tx + 16 * n] = acc[i][n] / l_safe;
    if (tx == 0)
      lse[static_cast<size_t>(bh) * Sq + row] =
          m[i] == -CUDART_INF_F ? -CUDART_INF_F : m[i] + logf(l_safe);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq,
           int Sk, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<D>;
  const size_t bytes = Smem<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Sq + kBQ - 1) / kBQ, B * Hq);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Sk, Hq, Hkv,
      causal, scale);
  PTT_RETURN_LAUNCH_ERROR();
}

}  // namespace f32

}  // namespace

extern "C" int ptt_flash_attn_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int B, int Sq, int Sk,
                                  int Hq, int Hkv, int D, int causal,
                                  float scale, int dtype, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == PTT_F32 && D == 64)
    return f32::launch<64>(q, k, v, o, l, B, Sq, Sk, Hq, Hkv, causal, scale, s);
  if (dtype == PTT_F32 && D == 128)
    return f32::launch<128>(q, k, v, o, l, B, Sq, Sk, Hq, Hkv, causal, scale, s);
  if (dtype == PTT_BF16 && D == 64)
    return wg::launch<64>(q, k, v, o, l, B, Sq, Sk, Hq, Hkv, causal, scale, s);
  if (dtype == PTT_BF16 && D == 128)
    return wg::launch<128>(q, k, v, o, l, B, Sq, Sk, Hq, Hkv, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
