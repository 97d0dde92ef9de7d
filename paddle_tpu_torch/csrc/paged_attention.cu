// Paged decode attention for Hopper: one new query token per sequence over a
// paged KV cache addressed through a block table (the eager engine's decode).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py:_kernel
// (grid and scalar prefetch in paged_decode_attention, :106). Sequence b
// reads block-table row b and sees its first lens[b] cached positions; only
// blocks j with j*block_size < lens[b] are loaded, and lens[b] == 0 gives
// exactly 0. Scores, the online softmax and the PV sum run in fp32 whatever
// the storage types; the output takes q's dtype. GQA folds each query head
// onto its kv head.
//
// Bound on the H100: bytes. Each sequence reads its whole visible K/V history
// and does ~4 flops per byte of it, so the least time is those K/V bytes over
// 3.35 TB/s.
//
// Design: one block per (kv head, sequence). The block loads its own table
// row and length (the TPU kernel's scalar prefetch) and walks its pages in
// order; the group's Hq/Hkv query heads, one warp each, share every page the
// block loads, so a page is read once per kv head. Pages are double buffered
// in shared memory: the next page's cp.async copies are in flight while the
// warps score and sum the current one. The block has at least kMinWarps warps
// so that a 1:1 group still issues its copies from 128 threads; the warps past
// the group only copy. K rows are padded by 16 bytes so that lane r reading row
// r in 16-byte pieces hits distinct banks. Scores: lane r owns rows r, r+32,
// ...; the online-softmax max and sum are warp reductions. PV: each lane owns
// one 16-byte column chunk of a row phase; the phases are summed with shuffles
// at the end. Splitting a long context over several blocks (flash decoding)
// is left for later.
//
// Head dims: as the ragged kernel (csrc/ragged_paged_attention.cu), the kernel
// is instantiated at a padded head dim D of 64, 128 or 256 (head_dim_bucket,
// common.cuh) and told the real d, a multiple of 16: only the d / V chunks of
// a row that exist are copied and stored, with d as the row length in device
// memory; the chunks past d are zeros in shared memory, written once, so the
// score and PV loops are those of d == D. At D 256 in fp32 a row is 64 chunks, so a lane
// owns two chunks of one row phase in PV. Where two [K | V] stages do not fit
// one block's shared memory (D 256 over fp32 pages of 64 rows: 264,192 bytes),
// the host gives the kernel one stage: the page's copies then wait for the
// previous page's reads, and the block takes exactly the ragged kernel's
// shared memory, so a shape the ragged kernel takes is never refused here.
#include "common.cuh"

namespace {

constexpr int kMinWarps = 4;
constexpr int kSmemMax = 232448;  // dynamic shared memory one block may use

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename KT, int D> struct Geo {
  static constexpr int V = 16 / sizeof(KT);  // elements per 16-byte chunk
  static constexpr int CH = D / V;           // chunks per padded row
  static constexpr int CL = CH < 32 ? CH : 32;  // chunks one row phase covers
  static constexpr int LC = CH / CL;         // chunks a lane owns in PV
  static constexpr int RP = 32 / CL;         // row phases per warp in PV
  static constexpr int KS = D + V;           // padded K row (elements)
  static_assert(CH >= 1 && 32 % CL == 0 && CH % CL == 0, "unsupported head_dim");
};

// `stages` stages of [K page | V page], then the group's q rows and p rows
// (ops/kernels/paged_attention.py:_smem_bytes agrees)
template <typename KT, int D>
size_t smem_bytes(int bs, int group, int stages) {
  using G = Geo<KT, D>;
  return stages * static_cast<size_t>(bs) * (G::KS + D) * sizeof(KT) +
         static_cast<size_t>(group) * D * sizeof(float) +
         static_cast<size_t>(group) * bs * sizeof(float);
}

template <typename QT, typename KT, int D>
__global__ void paged_decode_attn_kernel(
    const QT* __restrict__ q, const KT* __restrict__ kc,
    const KT* __restrict__ vc, const int* __restrict__ tables,
    const int* __restrict__ lens, QT* __restrict__ out, int Hq, int Hkv, int d,
    int bs, int max_blocks, float scale, int stages) {
  using G = Geo<KT, D>;
  constexpr int V = G::V, CH = G::CH, CL = G::CL, LC = G::LC, RP = G::RP, KS = G::KS;
  const int chd = d / V;  // the chunks of a row that exist
  extern __shared__ uint4 smem_raw[];
  const int g = blockIdx.x, b = blockIdx.y;
  const int group = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool scores = warp < group;  // the other warps only copy pages
  const int h = g * group + warp;

  const int stage = bs * (KS + D);  // elements of one [K | V] stage
  KT* st0 = reinterpret_cast<KT*>(smem_raw);
  float* Qs = reinterpret_cast<float*>(st0 + stages * stage);  // [group][D]
  float* Ps = Qs + group * D;                              // [group][bs]
  float* qw = Qs + warp * D;
  float* pw = Ps + warp * bs;

  const int len = lens[b];
  int nblk = len > 0 ? (len + bs - 1) / bs : 0;
  if (nblk > max_blocks) nblk = max_blocks;
  const int* trow = tables + static_cast<size_t>(b) * max_blocks;
  const size_t page_row = static_cast<size_t>(Hkv) * d;  // elements per cache row
  const bool two = stages == 2;

  auto fetch = [&](int j) {  // copies of page j into its stage
    KT* Ks = st0 + (two ? j & 1 : 0) * stage;
    KT* Vs = Ks + bs * KS;
    const size_t base = static_cast<size_t>(trow[j]) * bs;
    for (int i = threadIdx.x; i < bs * CH; i += blockDim.x) {
      const int r = i / CH, ch = i % CH;  // CH a power of two: shifts
      if (ch >= chd) continue;
      const size_t src = (base + r) * page_row + static_cast<size_t>(g) * d + ch * V;
      cp_async16(Ks + r * KS + ch * V, kc + src);
      cp_async16(Vs + r * D + ch * V, vc + src);
    }
    cp_async_commit();
  };

  // the chunks past d hold zeros in every stage, written once (the copies
  // never touch them), as do q's columns past d: the loops below run over
  // all CH chunks, with no test of d inside them
  const int pad = CH - chd;
  for (int i = threadIdx.x; i < stages * bs * pad; i += blockDim.x) {
    const int r = i / pad % bs, ch = chd + i % pad;
    KT* Ks = st0 + i / (pad * bs) * stage;
    *reinterpret_cast<uint4*>(Ks + r * KS + ch * V) = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(Ks + bs * KS + r * D + ch * V) = make_uint4(0, 0, 0, 0);
  }
  if (nblk > 0) fetch(0);
  if (scores)
    for (int c = lane; c < D; c += 32)
      qw[c] = c < d ? to_f<QT>(q[(static_cast<size_t>(b) * Hq + h) * d + c]) : 0.f;

  float m = -CUDART_INF_F, l = 0.f, acc[LC][V];
#pragma unroll
  for (int u = 0; u < LC; ++u)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[u][e] = 0.f;

  for (int j = 0; j < nblk; ++j) {
    if (!two) {
      if (j > 0) fetch(j);  // the one stage was freed by the previous barrier
      cp_async_wait<0>();
    } else if (j + 1 < nblk) {
      fetch(j + 1);  // its stage was last read before the previous barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // page j (and qw) visible to every warp
    if (scores) {
      const KT* Ks = st0 + (two ? j & 1 : 0) * stage;
      const KT* Vs = Ks + bs * KS;
      float mloc = -CUDART_INF_F;
      for (int r = lane; r < bs; r += 32) {
        float s = 0.f;
#pragma unroll
        for (int ch = 0; ch < CH; ++ch) {
          float kf[V];
          unpack<KT>(*reinterpret_cast<const uint4*>(Ks + r * KS + ch * V), kf);
#pragma unroll
          for (int e = 0; e < V; ++e) s = fmaf(qw[ch * V + e], kf[e], s);
        }
        s = j * bs + r < len ? s * scale : -CUDART_INF_F;
        pw[r] = s;
        mloc = fmaxf(mloc, s);
      }
      mloc = warp_max(mloc);
      const float m_new = fmaxf(m, mloc);
      const float m_safe = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = m == -CUDART_INF_F ? 0.f : expf(m - m_safe);
      float lsum = 0.f;
      for (int r = lane; r < bs; r += 32) {
        const float pr = j * bs + r < len ? expf(pw[r] - m_safe) : 0.f;
        pw[r] = pr;
        lsum += pr;
      }
      lsum = warp_sum(lsum);
      l = alpha * l + lsum;
      m = m_new;
      __syncwarp();  // pw[] complete before other lanes read it
#pragma unroll
      for (int u = 0; u < LC; ++u)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[u][e] *= alpha;
      for (int r = lane / CL; r < bs; r += RP) {
        const float pr = pw[r];
#pragma unroll
        for (int u = 0; u < LC; ++u) {
          const int ch = lane % CL + 32 * u;
          float vf[V];
          unpack<KT>(*reinterpret_cast<const uint4*>(Vs + r * D + ch * V), vf);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[u][e] = fmaf(pr, vf[e], acc[u][e]);
        }
      }
    }
    __syncthreads();  // page j's stage is free for the next copies into it
  }
  if (!scores) return;

  // lanes holding the same column chunk (different row phases) add up
#pragma unroll
  for (int off = CL; off < 32; off <<= 1)
#pragma unroll
    for (int u = 0; u < LC; ++u)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[u][e] += __shfl_xor_sync(0xffffffffu, acc[u][e], off);
  if (lane < CL) {
    const float l_safe = l == 0.f ? 1.f : l;
#pragma unroll
    for (int u = 0; u < LC; ++u) {
      const int ch = lane + 32 * u;
      if (ch >= chd) break;
      QT* o = out + (static_cast<size_t>(b) * Hq + h) * d + ch * V;
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = from_f<QT>(acc[u][e] / l_safe);
    }
  }
}

template <typename QT, typename KT, int D>
int launch(const void* q, const void* kc, const void* vc, const int* tables,
           const int* lens, void* out, int B, int Hq, int Hkv, int d, int bs,
           int max_blocks, float scale, cudaStream_t stream) {
  const int group = Hq / Hkv;
  const int stages = smem_bytes<KT, D>(bs, group, 2) <= kSmemMax ? 2 : 1;
  const size_t bytes = smem_bytes<KT, D>(bs, group, stages);
  auto kern = paged_decode_attn_kernel<QT, KT, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int warps = group > kMinWarps ? group : kMinWarps;
  dim3 grid(Hkv, B);
  kern<<<grid, 32 * warps, bytes, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kc),
      static_cast<const KT*>(vc), tables, lens, static_cast<QT*>(out), Hq, Hkv,
      d, bs, max_blocks, scale, stages);
  PTT_RETURN_LAUNCH_ERROR();
}

template <typename QT, typename KT>
int dispatch_d(const void* q, const void* kc, const void* vc, const int* tables,
               const int* lens, void* out, int B, int Hq, int Hkv, int D, int bs,
               int max_blocks, float scale, cudaStream_t s) {
  switch (head_dim_bucket(D)) {
    case 64:
      return launch<QT, KT, 64>(q, kc, vc, tables, lens, out, B, Hq, Hkv, D, bs,
                                max_blocks, scale, s);
    case 128:
      return launch<QT, KT, 128>(q, kc, vc, tables, lens, out, B, Hq, Hkv, D, bs,
                                 max_blocks, scale, s);
    case 256:
      return launch<QT, KT, 256>(q, kc, vc, tables, lens, out, B, Hq, Hkv, D, bs,
                                 max_blocks, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: [B, Hq, D]; k_cache/v_cache: [rows, Hkv, D] (one layer, flat token-major);
// tables: [B, max_blocks] int32; lens: [B] int32; out like q.
extern "C" int ptt_paged_decode_attn(const void* q, const void* kc, const void* vc,
                                     const void* tables, const void* lens, void* out,
                                     int B, int Hq, int Hkv, int D, int bs,
                                     int max_blocks, float scale, int q_dtype,
                                     int kv_dtype, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lens);
  if (q_dtype == PTT_F32 && kv_dtype == PTT_BF16)
    return dispatch_d<float, __nv_bfloat16>(q, kc, vc, tb, ln, out, B, Hq, Hkv, D,
                                            bs, max_blocks, scale, s);
  if (q_dtype == PTT_F32 && kv_dtype == PTT_F32)
    return dispatch_d<float, float>(q, kc, vc, tb, ln, out, B, Hq, Hkv, D, bs,
                                    max_blocks, scale, s);
  if (q_dtype == PTT_BF16 && kv_dtype == PTT_BF16)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(q, kc, vc, tb, ln, out, B, Hq,
                                                    Hkv, D, bs, max_blocks, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
