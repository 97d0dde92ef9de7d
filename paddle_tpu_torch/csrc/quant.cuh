// Ragged paged attention over quantized KV pages (int8 or fp8 e4m3, with
// per-row, per-head fp32 scales) for Hopper: the compiled serving step's
// attention when the KV cache is quantized. The kernels and their launchers;
// quant.cu (fp32 q, and the C entry) and quant_bf16.cu (bf16 q) each
// instantiate half of them, so the two compile in parallel.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/quant.py:_kernel (grid and
// scalar prefetch in ragged_paged_attention_quant, :110). Packed token-major
// queries: token t reads block-table row rows[t] and sees its first
// valids[t] cached positions; only blocks j with j*block_size < valids[t]
// are loaded, and valids[t] == 0 gives exactly 0. Page row i of kv head g
// stands for page[i, g, :] * scale[i, g]. Scores, the online softmax and the
// PV sum run in fp32; the output takes q's dtype. GQA folds each query head
// onto its kv head.
//
// Bound on the H100: each token reads its visible K/V history, one byte an
// element plus 8 bytes of scales a row and head, and does 4 flops per
// (query head, element) in fp32 on the CUDA cores; chip_smoke.py computes
// the larger of the two times from each run's inputs. What holds the wide
// schedule below (one block per (token, kv head) walking its pages through a
// two-stage ring, each page's scores an in-order chain of d dependent FMAs
// on the softmax's own warp) at a decode step is latency: a small grid, one
// page in flight, and the score chain, the softmax and PV in series.
//
// Arithmetic, the same under both schedules bit for bit, since serving
// streams depend on the order of operations (a greedy stream flips on
// rounding order alone). A score of row r is one
// chain dot = fmaf(q[c], k_f[c], dot) over the columns in order, then
// s = dot * Ksc[r] * scale; the K scale multiplies each score once and the V
// scale each softmax weight (p * Vsc[r]) before PV, one multiply a row
// instead of one an element. The online softmax runs once per page in a
// warp per query head: lane r holds rows r, r + 32, ..., the page's max
// (exact in any order), alpha, p = expf(s - m), the lane's partial sum over
// its rows in order then warp_sum, l = alpha * l + sum; PV scales acc by
// alpha and adds fmaf(p * Vsc[r], v_f, acc) over rows lane / CH, + RP, ...
// in order; the lanes of a column chunk are summed by xor shuffles and acc
// divided by l. The plain twin dequantizes first, so the two round in
// another order; the port holds the kernel to 1e-4 x the twin's largest
// magnitude for an fp32 output and to the bf16 tier for a bf16 one.
//
// Schedule (free to change, as none of it changes a bit):
//   * A copy warp keeps the page ring (NS stages: 4 where the grid fits on
//     the card at that depth, else 2 so that more blocks share an SM) full
//     with cp.async, each lane arriving on the stage's mbarrier when its
//     copies land, and refills a stage as soon as every head is done with
//     it. Scoring warps score the landed pages into a ring of score rows,
//     running ahead of the consumers: a thread a row, its bytes unpacked
//     once for every head of the block (one independent chain a head), as
//     many pages at once as 128 threads have rows for.
//   * Consumer warps run the softmax and PV from the score ring and the V
//     page, then release the stage; a consumer waits only on its page's
//     mbarriers, never on a block-wide barrier. A head has 2 or 4 of them,
//     each accumulating its share of every lane's 16 columns (lane layout
//     and order per column as above) after the same softmax, so a page's PV
//     chain is 2-4 times shorter.
//   * The grid fills the card: a (token, kv head) item's GQA group is split
//     over group / HB blocks of HB = 4, 2 or 1 query heads, the widest that
//     still gives two blocks an SM.
// That pipelined schedule is for steps whose (token, kv head) items leave
// the card idle (a decode step: 8 tokens x 8 kv heads). A step of more than
// two items an SM (a prefill chunk) takes the wide schedule (below), which
// measured faster there; a token's bits are the same in
// either (ops/kernels/quant.py:launch_plan mirrors the choice and the
// shared-memory sums).
// Splitting a context over blocks (flash decoding) would merge partial
// softmaxes and change bits, so it is not done.
//
// Head dims: the kernel is instantiated at a padded head dim D of 64, 128 or
// 256 (head_dim_bucket, common.cuh) and told the real d, a multiple of 16, so
// a row is whole 16-byte chunks: only the d / 16 chunks that exist are copied,
// scored, summed and stored, with d as the row length in device memory. K
// rows are padded by 16 bytes in shared memory so that neighbouring producer
// threads, one a row, read distinct banks.
#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMaxStages = 4;       // page stages in the ring
constexpr int kMinStages = 2;
constexpr int kSMs = 132;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void scorers_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

struct PageI8 {};
struct PageF8 {};

// 16 one-byte page values unpacked into floats, element i from byte i.
// int8 without the quarter-rate integer-to-float conversion: with its sign
// bit flipped the byte is v + 128 in [0, 255]; placed under the exponent of
// 2^23 (0x4B0000xx) it is the float 2^23 + v + 128, exact, and one add
// takes 2^23 + 128 off. A byte permute and an add, both full rate.
__device__ __forceinline__ void unpack_word(uint32_t w, float* f, PageI8) {
  w ^= 0x80808080u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | b)) - 8388736.f;
}

__device__ __forceinline__ void unpack_word(uint32_t w, float* f, PageF8) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {  // e4m3 -> fp16 is exact, so is fp16 -> fp32
    const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w >> (16 * p)), __NV_E4M3);
    const float2 f2 = __half22float2(__half2(hr));
    f[2 * p] = f2.x;  // the low byte is the lower element
    f[2 * p + 1] = f2.y;
  }
}

template <typename PT>
__device__ __forceinline__ void unpack_page(const uint4& u, float* f, PT) {
  unpack_word(u.x, f, PT());
  unpack_word(u.y, f + 4, PT());
  unpack_word(u.z, f + 8, PT());
  unpack_word(u.w, f + 12, PT());
}

// EW one-byte values from a 4- or 8-byte aligned address, element i from
// byte i (EW = 4, 8 or 16)
template <int EW, typename PT>
__device__ __forceinline__ void unpack_part(const uint8_t* p, float* f) {
  if constexpr (EW == 16) {
    unpack_page(*reinterpret_cast<const uint4*>(p), f, PT());
  } else if constexpr (EW == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    unpack_word(u.x, f, PT());
    unpack_word(u.y, f + 4, PT());
  } else {
    unpack_word(*reinterpret_cast<const uint32_t*>(p), f, PT());
  }
}

template <int D> struct Geo {
  static constexpr int CH = D / 16;  // 16-byte chunks per padded row
  static constexpr int RP = 32 / CH; // row phases per warp in PV
  static constexpr int KS = D + 16;  // padded K row, bytes
  static_assert(CH >= 1 && CH <= 32 && 32 % CH == 0, "unsupported head_dim");
};

// one stage: [K page (padded rows) | V page | K scales | V scales], rounded
// up to 16 bytes so the next stage's copies stay aligned
__host__ __device__ inline int stage_bytes(int D, int bs) {
  const int raw = bs * ((D + 16) + D + 2 * static_cast<int>(sizeof(float)));
  return (raw + 15) / 16 * 16;
}

constexpr int kConsumers = 4;  // consumer warps a block (Consumers, below)

// [NS stages | 3 NS mbarriers | NS x HB x bs score rows | HB q rows | a row
// of bs softmax weights a consumer warp | NS x HB x 4 scoring-warp maxima |
// the token's table row], fp32 scores, q, weights and maxima, int32 table
// entries
inline size_t smem_bytes(int D, int bs, int hb, int ns, int width) {
  return static_cast<size_t>(ns) * stage_bytes(D, bs) + 3 * ns * sizeof(uint64_t) +
         static_cast<size_t>(ns) * hb * bs * sizeof(float) +
         static_cast<size_t>(hb) * D * sizeof(float) +
         static_cast<size_t>(kConsumers) * bs * sizeof(float) +
         static_cast<size_t>(ns) * hb * 4 * sizeof(float) +
         static_cast<size_t>(width) * sizeof(int);
}

// Blocks of `threads` threads and `smem` bytes an SM holds at once, by its
// shared memory and threads (registers are not counted).
inline int blocks_per_sm(size_t smem, int threads) {
  const int by_smem = static_cast<int>(233472 / (smem + 1024));  // 1 KB reserved a block
  const int by_threads = 2048 / threads;
  return by_smem < by_threads ? by_smem : by_threads;
}

// The ring's depth: the most stages (up to kMaxStages) that fit, unless the
// grid is more than the card holds at that depth; then 2 stages, so that
// more blocks share an SM (the card is busy, and their latencies overlap).
// 0 where not even kMinStages fit.
inline int ring_stages(int D, int bs, int hb, int width, long long blocks, int threads) {
  int ns = kMaxStages;
  while (ns >= kMinStages && smem_bytes(D, bs, hb, ns, width) > static_cast<size_t>(kSmemLimit))
    --ns;
  if (ns < kMinStages) return 0;
  if (blocks > static_cast<long long>(kSMs) *
                   blocks_per_sm(smem_bytes(D, bs, hb, ns, width), threads))
    return kMinStages;
  return ns;
}

// Pages `nthreads` scorers take at once: a thread a row, so up to
// nthreads / bs pages; a divisor of the ring's depth, so that a group waits
// on its own stages' mbarriers one phase after another.
inline int score_groups(int bs, int ns, int nthreads) {
  int g = 1;
  while (g * 2 <= ns && ns % (g * 2) == 0 && g * 2 * bs <= nthreads) g *= 2;
  return g;
}

// Scores of the rows r = r0, r0 + step, ... of a page for the query heads
// [hb0, hb0 + HBS): a row's bytes unpacked once, one in-order FMA chain a
// head, then dot * Ksc[r] * scale (rows past rmax: -inf).
// Scores of the rows r = r0, r0 + step, ... of a page for the block's HB
// query heads: a row's bytes unpacked once, one in-order FMA chain a head,
// then dot * Ksc[r] * scale (rows past rmax: -inf); mx[h] is the largest of
// the thread's scores of head h.
template <int HB, int D, typename PT, bool FULL>
__device__ __forceinline__ void score_rows(const uint8_t* Kst, const float* Ksc,
                                           const float* Qs, float* Sj, int r0,
                                           int step, int bs, int rmax, int chd,
                                           float scale, float* mx) {
  constexpr int CH = Geo<D>::CH, KS = Geo<D>::KS;
#pragma unroll
  for (int hb = 0; hb < HB; ++hb) mx[hb] = -CUDART_INF_F;
  for (int r = r0; r < bs; r += step) {
    if (r < rmax) {
      float dot[HB];
#pragma unroll
      for (int hb = 0; hb < HB; ++hb) dot[hb] = 0.f;
#pragma unroll
      for (int ch = 0; ch < CH; ++ch) {
        if (!FULL && ch >= chd) break;  // FULL: d is the padded head dim
        float kf[16];
        unpack_page(*reinterpret_cast<const uint4*>(Kst + r * KS + ch * 16), kf, PT());
#pragma unroll
        for (int hb = 0; hb < HB; ++hb)
#pragma unroll
          for (int e = 0; e < 16; ++e)
            dot[hb] = fmaf(Qs[hb * D + ch * 16 + e], kf[e], dot[hb]);
      }
#pragma unroll
      for (int hb = 0; hb < HB; ++hb) {
        const float sv = dot[hb] * Ksc[r] * scale;  // the K scale, once a row
        Sj[hb * bs + r] = sv;
        mx[hb] = fmaxf(mx[hb], sv);
      }
    } else {
#pragma unroll
      for (int hb = 0; hb < HB; ++hb) Sj[hb * bs + r] = -CUDART_INF_F;
    }
  }
}

// A block of HB query heads: 4 consumer warps, ES a head, each taking
// 16 / ES of the 16 columns a lane accumulates (every column's sum still one
// chain in the order above; the ES warps of a head run the same
// softmax side by side), a copy warp, and SW scoring warps (4 where one
// head leaves the card idle, 2 where the grid is large).
template <int HB> struct Consumers {
  static constexpr int ES = kConsumers / HB;  // warps a head
  static constexpr int EW = 16 / ES;   // columns a warp of a lane's chunk
  static constexpr int CW = kConsumers;
  static constexpr int SW = HB == 1 ? 4 : 2;
  static constexpr int THREADS = (CW + 1 + SW) * 32;
};

// Warps: [0, CW) consumers, CW the copy warp, then SW scoring warps. The
// scorers form `groups` groups of min(bs, 32 SW) threads, group k scoring
// pages k, k + groups, ... (a thread a row, every head of the block); where
// a group is whole warps (bs >= 32) they also leave each warp's largest
// score of every head, so a consumer's page max is one load a warp.
template <typename QT, typename PT, int D, int HB>
__global__ void __launch_bounds__(Consumers<HB>::THREADS, 1)
ragged_attn_quant_kernel(const QT* __restrict__ q, const uint8_t* __restrict__ kc,
                         const uint8_t* __restrict__ vc, const float* __restrict__ ks,
                         const float* __restrict__ vs, const int* __restrict__ tables,
                         const int* __restrict__ rows, const int* __restrict__ valids,
                         QT* __restrict__ out, int Hq, int Hkv, int d, int bs,
                         int width, float scale, int ns, int groups) {
  using G = Geo<D>;
  constexpr int CH = G::CH, RP = G::RP, KS = G::KS;
  constexpr int CW = Consumers<HB>::CW;
  constexpr int NS = Consumers<HB>::SW * 32;
  const int chd = d / 16;  // the chunks of a row that exist
  extern __shared__ uint4 smem_raw[];
  const int t = blockIdx.x, g = blockIdx.y;
  const int group = Hq / Hkv;
  const int h0 = g * group + blockIdx.z * HB;  // the block's first query head
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tp = bs < NS ? bs : NS;  // scoring threads a page (groups pages at once)

  const int stage = stage_bytes(D, bs);
  uint8_t* st0 = reinterpret_cast<uint8_t*>(smem_raw);
  uint64_t* page_bar = reinterpret_cast<uint64_t*>(st0 + ns * stage);  // a page landed
  uint64_t* full_bar = page_bar + ns;   // a page's scores written
  uint64_t* empty_bar = full_bar + ns;  // a page consumed by every head
  float* Ssc = reinterpret_cast<float*>(empty_bar + ns);  // [ns][HB][bs]
  float* Qs = Ssc + ns * HB * bs;                          // [HB][D]
  float* Ps = Qs + HB * D;                                 // [CW][bs] weights
  float* Pm = Ps + CW * bs;                                // [ns][HB][4] warp maxima
  int* Tb = reinterpret_cast<int*>(Pm + ns * HB * 4);      // the table row
  const int nwm = tp % 32 == 0 ? tp / 32 : 0;              // warp maxima a page

  const int valid = valids[t];
  int nblk = valid > 0 ? (valid + bs - 1) / bs : 0;
  if (nblk > width) nblk = width;
  const int* trow = tables + static_cast<size_t>(rows[t]) * width;
  for (int j = threadIdx.x; j < nblk; j += blockDim.x) Tb[j] = trow[j];

  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      hopper::mbar_init(&page_bar[s], 32);
      hopper::mbar_init(&full_bar[s], tp);
      hopper::mbar_init(&empty_bar[s], CW);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == CW) {  // ------------------------------------------ copy warp
    const size_t page_row = static_cast<size_t>(Hkv) * d;  // bytes per cache row
    for (int j = 0; j < nblk; ++j) {  // page j into stage j % ns, ns pages ahead
      const int s = j % ns;
      if (j >= ns) hopper::mbar_wait(&empty_bar[s], ((j - ns) / ns) & 1);
      uint8_t* Kst = st0 + s * stage;
      uint8_t* Vst = Kst + bs * KS;
      float* Ksc = reinterpret_cast<float*>(Vst + bs * D);
      float* Vsc = Ksc + bs;
      const size_t base = static_cast<size_t>(Tb[j]) * bs;
      const uint8_t* kp = kc + base * page_row + static_cast<size_t>(g) * d;
      const uint8_t* vp = vc + base * page_row + static_cast<size_t>(g) * d;
      for (int i = lane; i < bs * CH; i += 32) {
        const int r = i / CH, ch = i % CH;  // CH a power of two: shifts
        if (ch >= chd) continue;
        const size_t off = static_cast<size_t>(r) * page_row + ch * 16;
        cp_async16(Kst + r * KS + ch * 16, kp + off);
        cp_async16(Vst + r * D + ch * 16, vp + off);
      }
      for (int r = lane; r < bs; r += 32) {
        const size_t si = (base + r) * Hkv + g;
        cp_async4(Ksc + r, ks + si);
        cp_async4(Vsc + r, vs + si);
      }
      hopper::cp_async_arrive(&page_bar[s]);
    }
    return;
  }

  if (warp > CW) {  // ----------------------------------------------- scorers
    const int st = threadIdx.x - (CW + 1) * 32;
    for (int i = st; i < HB * d; i += NS) {
      const int hb = i / d, c = i % d;
      Qs[hb * D + c] = to_f<QT>(q[(static_cast<size_t>(t) * Hq + h0 + hb) * d + c]);
    }
    scorers_sync(NS);  // Qs visible to every scorer
    const int grp = st / tp;
    if (grp >= groups) return;
    for (int j = grp; j < nblk; j += groups) {
      const int s = j % ns;
      hopper::mbar_wait(&page_bar[s], (j / ns) & 1);  // page j landed
      const uint8_t* Kst = st0 + s * stage;
      const float* Ksc = reinterpret_cast<const float*>(Kst + bs * KS + bs * D);
      float* Sj = Ssc + s * HB * bs;
      const int rmax = min(bs, valid - j * bs);  // rows of page j it sees
      float mx[HB];
      if (chd == CH)
        score_rows<HB, D, PT, true>(Kst, Ksc, Qs, Sj, st % tp, tp, bs, rmax, chd, scale, mx);
      else
        score_rows<HB, D, PT, false>(Kst, Ksc, Qs, Sj, st % tp, tp, bs, rmax, chd, scale, mx);
      if (nwm > 0) {  // the group is whole warps: each warp's maxima
#pragma unroll
        for (int hb = 0; hb < HB; ++hb) {
          mx[hb] = warp_max(mx[hb]);
          if (lane == 0) Pm[(s * HB + hb) * 4 + (st % tp) / 32] = mx[hb];
        }
      }
      hopper::mbar_arrive(&full_bar[s]);
    }
    return;
  }

  // ------------------------------- consumers: ES warps a head, EW columns each
  constexpr int ES = Consumers<HB>::ES, EW = Consumers<HB>::EW;
  const int hb = warp / ES, ep = warp % ES;  // the warp's head and column part
  float* pw = Ps + warp * bs;                // the warp's softmax weights
  float m = -CUDART_INF_F, l = 0.f, acc[EW];
#pragma unroll
  for (int e = 0; e < EW; ++e) acc[e] = 0.f;

  for (int j = 0; j < nblk; ++j) {
    const int s = j % ns;
    const uint32_t par = (j / ns) & 1;
    hopper::mbar_wait(&page_bar[s], par);
    hopper::mbar_wait(&full_bar[s], par);
    const uint8_t* Kst = st0 + s * stage;
    const uint8_t* Vst = Kst + bs * KS;
    const float* Vsc = reinterpret_cast<const float*>(Vst + bs * D) + bs;
    const float* sc = Ssc + (s * HB + hb) * bs;  // the head's scores of page j
    const int rmax = min(bs, valid - j * bs);   // rows of page j it sees
    float mloc = -CUDART_INF_F;  // the page's largest score (exact in any order)
    if (nwm > 0) {
      for (int w = 0; w < nwm; ++w) mloc = fmaxf(mloc, Pm[(s * HB + hb) * 4 + w]);
    } else {
      for (int r = lane; r < bs; r += 32) mloc = fmaxf(mloc, sc[r]);
      mloc = warp_max(mloc);
    }
    const float m_new = fmaxf(m, mloc);
    const float m_safe = m_new == -CUDART_INF_F ? 0.f : m_new;
    const float alpha = m == -CUDART_INF_F ? 0.f : expf(m - m_safe);
    float lsum = 0.f;
    for (int r = lane; r < bs; r += 32) {
      const float pr = r < rmax ? expf(sc[r] - m_safe) : 0.f;
      pw[r] = pr;
      lsum += pr;
    }
    lsum = warp_sum(lsum);
    l = alpha * l + lsum;
    m = m_new;
    __syncwarp();  // pw[] complete before other lanes read it
#pragma unroll
    for (int e = 0; e < EW; ++e) acc[e] *= alpha;
    const int ch = lane % CH;
    if (ch < chd) {
      // rows lane / CH, + RP, ... in order; four rows' loads issued together
      const uint8_t* vb = Vst + ch * 16 + ep * EW;
      int r = lane / CH;
      for (; r + 3 * RP < rmax; r += 4 * RP) {
        float vf[4][EW], pr[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          unpack_part<EW, PT>(vb + (r + k * RP) * D, vf[k]);
          pr[k] = pw[r + k * RP] * Vsc[r + k * RP];  // the V scale, once a row
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int e = 0; e < EW; ++e) acc[e] = fmaf(pr[k], vf[k][e], acc[e]);
      }
      for (; r < rmax; r += RP) {
        float vf[EW];
        unpack_part<EW, PT>(vb + r * D, vf);
        const float pr = pw[r] * Vsc[r];
#pragma unroll
        for (int e = 0; e < EW; ++e) acc[e] = fmaf(pr, vf[e], acc[e]);
      }
    }
    __syncwarp();  // every lane done with the stage and its weights
    if (lane == 0) hopper::mbar_arrive(&empty_bar[s]);
  }

  // lanes holding the same column chunk (different row phases) add up
#pragma unroll
  for (int off = CH; off < 32; off <<= 1)
#pragma unroll
    for (int e = 0; e < EW; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  if (lane < chd) {
    const float l_safe = l == 0.f ? 1.f : l;
    QT* o = out + (static_cast<size_t>(t) * Hq + h0 + hb) * d + lane * 16 + ep * EW;
#pragma unroll
    for (int e = 0; e < EW; ++e) o[e] = from_f<QT>(acc[e] / l_safe);
  }
}

template <typename QT, typename PT, int D, int HB>
int launch(const void* q, const void* kc, const void* vc, const float* ks,
           const float* vs, const int* tables, const int* rows, const int* valids,
           void* out, int T, int Hq, int Hkv, int d, int bs, int width, float scale,
           cudaStream_t stream) {
  const int threads = Consumers<HB>::THREADS;
  const int ns = ring_stages(D, bs, HB, width,
                             static_cast<long long>(T) * Hkv * (Hq / Hkv / HB), threads);
  if (ns == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(D, bs, HB, ns, width);
  auto kern = ragged_attn_quant_kernel<QT, PT, D, HB>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(T, Hkv, Hq / Hkv / HB);
  kern<<<grid, threads, bytes, stream>>>(
      static_cast<const QT*>(q), static_cast<const uint8_t*>(kc),
      static_cast<const uint8_t*>(vc), ks, vs, tables, rows, valids,
      static_cast<QT*>(out), Hq, Hkv, d, bs, width, scale, ns,
      score_groups(bs, ns, Consumers<HB>::SW * 32));
  PTT_RETURN_LAUNCH_ERROR();
}

// ------------------------------------------------------- the wide schedule
// The wide schedule, for grids that fill the card: one block per
// (token, kv head), the group's query heads one warp each (at least
// kMinWarps warps, the others only copy), pages walked in order through a
// two-stage cp.async ring, each warp scoring its rows, then the softmax and
// PV, between two block barriers a page. Its arithmetic is the one above.
constexpr int kMinWarps = 4;

// one stage: [K page (padded rows) | V page | K scales | V scales], rounded
// up to 16 bytes so the second stage's copies stay aligned
template <int D> __host__ __device__ int wide_stage_bytes(int bs) {
  const int raw = bs * (Geo<D>::KS + D + 2 * static_cast<int>(sizeof(float)));
  return (raw + 15) / 16 * 16;
}

// two stages, then the group's q rows and p rows in fp32
template <int D> size_t wide_smem_bytes(int bs, int group) {
  return 2 * static_cast<size_t>(wide_stage_bytes<D>(bs)) +
         static_cast<size_t>(group) * D * sizeof(float) +
         static_cast<size_t>(group) * bs * sizeof(float);
}

template <typename QT, typename PT, int D>
__global__ void __launch_bounds__(1024)
ragged_attn_quant_wide(const QT* __restrict__ q, const uint8_t* __restrict__ kc,
                         const uint8_t* __restrict__ vc, const float* __restrict__ ks,
                         const float* __restrict__ vs, const int* __restrict__ tables,
                         const int* __restrict__ rows, const int* __restrict__ valids,
                         QT* __restrict__ out, int Hq, int Hkv, int d, int bs,
                         int width, float scale) {
  using G = Geo<D>;
  constexpr int CH = G::CH, RP = G::RP, KS = G::KS;
  const int chd = d / 16;  // the chunks of a row that exist
  extern __shared__ uint4 smem_raw[];
  const int t = blockIdx.x, g = blockIdx.y;
  const int group = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool scores = warp < group;  // the other warps only copy pages
  const int h = g * group + warp;

  const int stage = wide_stage_bytes<D>(bs);
  uint8_t* st0 = reinterpret_cast<uint8_t*>(smem_raw);
  float* Qs = reinterpret_cast<float*>(st0 + 2 * stage);  // [group][D]
  float* Ps = Qs + group * D;                              // [group][bs]
  float* qw = Qs + warp * D;
  float* pw = Ps + warp * bs;

  const int valid = valids[t];
  int nblk = valid > 0 ? (valid + bs - 1) / bs : 0;
  if (nblk > width) nblk = width;
  const int* trow = tables + static_cast<size_t>(rows[t]) * width;
  const size_t page_row = static_cast<size_t>(Hkv) * d;  // bytes per cache row

  auto issue = [&](int j) {  // copies of page j into stage j % 2
    uint8_t* Kst = st0 + (j & 1) * stage;
    uint8_t* Vst = Kst + bs * KS;
    float* Ksc = reinterpret_cast<float*>(Vst + bs * D);
    float* Vsc = Ksc + bs;
    const size_t base = static_cast<size_t>(trow[j]) * bs;
    for (int i = threadIdx.x; i < bs * CH; i += blockDim.x) {
      const int r = i / CH, ch = i % CH;  // CH a power of two: shifts
      if (ch >= chd) continue;
      const size_t src = (base + r) * page_row + static_cast<size_t>(g) * d + ch * 16;
      cp_async16(Kst + r * KS + ch * 16, kc + src);
      cp_async16(Vst + r * D + ch * 16, vc + src);
    }
    for (int r = threadIdx.x; r < bs; r += blockDim.x) {
      const size_t si = (base + r) * Hkv + g;
      cp_async4(Ksc + r, ks + si);
      cp_async4(Vsc + r, vs + si);
    }
    cp_async_commit();
  };

  if (nblk > 0) issue(0);
  if (scores)
    for (int c = lane; c < d; c += 32)
      qw[c] = to_f<QT>(q[(static_cast<size_t>(t) * Hq + h) * d + c]);

  float m = -CUDART_INF_F, l = 0.f, acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;

  for (int j = 0; j < nblk; ++j) {
    if (j + 1 < nblk) {
      issue(j + 1);  // its stage was last read before the previous barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // page j (and qw) visible to every warp
    if (scores) {
      const uint8_t* Kst = st0 + (j & 1) * stage;
      const uint8_t* Vst = Kst + bs * KS;
      const float* Ksc = reinterpret_cast<const float*>(Vst + bs * D);
      const float* Vsc = Ksc + bs;
      const int rmax = min(bs, valid - j * bs);  // rows of page j it sees
      float mloc = -CUDART_INF_F;
      for (int r = lane; r < bs; r += 32) {
        float s = -CUDART_INF_F;
        if (r < rmax) {
          float dot = 0.f;
#pragma unroll
          for (int ch = 0; ch < CH; ++ch) {
            if (ch >= chd) break;
            float kf[16];
            unpack_page(*reinterpret_cast<const uint4*>(Kst + r * KS + ch * 16), kf, PT());
#pragma unroll
            for (int e = 0; e < 16; ++e) dot = fmaf(qw[ch * 16 + e], kf[e], dot);
          }
          s = dot * Ksc[r] * scale;  // the K scale, once a row
        }
        pw[r] = s;
        mloc = fmaxf(mloc, s);
      }
      mloc = warp_max(mloc);
      const float m_new = fmaxf(m, mloc);
      const float m_safe = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = m == -CUDART_INF_F ? 0.f : expf(m - m_safe);
      float lsum = 0.f;
      for (int r = lane; r < bs; r += 32) {
        const float pr = r < rmax ? expf(pw[r] - m_safe) : 0.f;
        pw[r] = pr;
        lsum += pr;
      }
      lsum = warp_sum(lsum);
      l = alpha * l + lsum;
      m = m_new;
      __syncwarp();  // pw[] complete before other lanes read it
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] *= alpha;
      const int ch = lane % CH;
      for (int r = lane / CH; ch < chd && r < rmax; r += RP) {
        float vf[16];
        unpack_page(*reinterpret_cast<const uint4*>(Vst + r * D + ch * 16), vf, PT());
        const float pr = pw[r] * Vsc[r];  // the V scale, once a row
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e] = fmaf(pr, vf[e], acc[e]);
      }
    }
    __syncthreads();  // stage j % 2 is free for page j + 2
  }
  if (!scores) return;

  // lanes holding the same column chunk (different row phases) add up
#pragma unroll
  for (int off = CH; off < 32; off <<= 1)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  if (lane < chd) {
    const float l_safe = l == 0.f ? 1.f : l;
    QT* o = out + (static_cast<size_t>(t) * Hq + h) * d + lane * 16;
#pragma unroll
    for (int e = 0; e < 16; ++e) o[e] = from_f<QT>(acc[e] / l_safe);
  }
}

template <typename QT, typename PT, int D>
int launch_wide(const void* q, const void* kc, const void* vc, const float* ks,
           const float* vs, const int* tables, const int* rows, const int* valids,
           void* out, int T, int Hq, int Hkv, int d, int bs, int width, float scale,
           cudaStream_t stream) {
  const int group = Hq / Hkv;
  const size_t bytes = wide_smem_bytes<D>(bs, group);
  auto kern = ragged_attn_quant_wide<QT, PT, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int warps = group > kMinWarps ? group : kMinWarps;
  dim3 grid(T, Hkv);
  kern<<<grid, 32 * warps, bytes, stream>>>(
      static_cast<const QT*>(q), static_cast<const uint8_t*>(kc),
      static_cast<const uint8_t*>(vc), ks, vs, tables, rows, valids,
      static_cast<QT*>(out), Hq, Hkv, d, bs, width, scale);
  PTT_RETURN_LAUNCH_ERROR();
}

// The query heads a block takes: the widest of 4, 2 and 1 that divides the
// group and still gives two blocks an SM (1 if none does).
inline int heads_per_block(int T, int Hq, int Hkv) {
  const int group = Hq / Hkv;
  const long long items = static_cast<long long>(T) * Hkv;
  for (int hb = 4; hb > 1; hb >>= 1)
    if (group % hb == 0 && items * (group / hb) >= 2 * 132) return hb;
  return 1;
}

// The schedule a launch takes: the wide one where its grid, one block per
// (token, kv head), already gives the card more than two blocks
// an SM; else the pipelined one, its group split over blocks of HB heads.
inline bool wide_schedule(int T, int Hkv) {
  return static_cast<long long>(T) * Hkv > 2 * kSMs;
}

template <typename QT, typename PT, int D>
int dispatch_hb(const void* q, const void* kc, const void* vc, const float* ks,
                const float* vs, const int* tables, const int* rows,
                const int* valids, void* out, int T, int Hq, int Hkv, int d, int bs,
                int width, float scale, cudaStream_t s) {
  if (wide_schedule(T, Hkv))
    return launch_wide<QT, PT, D>(q, kc, vc, ks, vs, tables, rows, valids, out, T, Hq,
                                  Hkv, d, bs, width, scale, s);
  switch (heads_per_block(T, Hq, Hkv)) {
    case 4:
      return launch<QT, PT, D, 4>(q, kc, vc, ks, vs, tables, rows, valids, out, T,
                                  Hq, Hkv, d, bs, width, scale, s);
    case 2:
      return launch<QT, PT, D, 2>(q, kc, vc, ks, vs, tables, rows, valids, out, T,
                                  Hq, Hkv, d, bs, width, scale, s);
    default:
      return launch<QT, PT, D, 1>(q, kc, vc, ks, vs, tables, rows, valids, out, T,
                                  Hq, Hkv, d, bs, width, scale, s);
  }
}

template <typename QT, typename PT>
int dispatch_d(const void* q, const void* kc, const void* vc, const float* ks,
               const float* vs, const int* tables, const int* rows,
               const int* valids, void* out, int T, int Hq, int Hkv, int D, int bs,
               int width, float scale, cudaStream_t s) {
  switch (head_dim_bucket(D)) {
    case 64:
      return dispatch_hb<QT, PT, 64>(q, kc, vc, ks, vs, tables, rows, valids, out,
                                     T, Hq, Hkv, D, bs, width, scale, s);
    case 128:
      return dispatch_hb<QT, PT, 128>(q, kc, vc, ks, vs, tables, rows, valids, out,
                                      T, Hq, Hkv, D, bs, width, scale, s);
    case 256:
      return dispatch_hb<QT, PT, 256>(q, kc, vc, ks, vs, tables, rows, valids, out,
                                      T, Hq, Hkv, D, bs, width, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename QT>
int dispatch_page(int page_dtype, const void* q, const void* kc, const void* vc,
                  const float* ks, const float* vs, const int* tables,
                  const int* rows, const int* valids, void* out, int T, int Hq,
                  int Hkv, int D, int bs, int width, float scale, cudaStream_t s) {
  if (page_dtype == PTT_I8)
    return dispatch_d<QT, PageI8>(q, kc, vc, ks, vs, tables, rows, valids, out, T,
                                  Hq, Hkv, D, bs, width, scale, s);
  if (page_dtype == PTT_F8E4M3)
    return dispatch_d<QT, PageF8>(q, kc, vc, ks, vs, tables, rows, valids, out, T,
                                  Hq, Hkv, D, bs, width, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The bf16-q launches (quant_bf16.cu).
int ptt_quant_dispatch_bf16(int page_dtype, const void* q, const void* kc, const void* vc,
                            const float* ks, const float* vs, const int* tables,
                            const int* rows, const int* valids, void* out, int T, int Hq,
                            int Hkv, int D, int bs, int width, float scale, cudaStream_t s);
