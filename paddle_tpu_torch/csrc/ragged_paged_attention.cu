// Ragged paged attention for Hopper: mixed prefill/decode attention of packed
// query tokens over a paged KV cache addressed through a block table.
//
// Replaces the TPU kernel
// paddle_tpu/ops/pallas/ragged_paged_attention.py:_kernel (grid and scalar
// prefetch in ragged_paged_attention, :105). Token t reads block-table row
// rows[t] and sees the first valids[t] cached positions; valids[t] == 0 (a
// pad token) gives exactly 0. Scores, softmax and the PV sum run in fp32
// whatever the storage types (the compiled decode step feeds fp32 q over
// bf16 pages); the output takes q's dtype.
//
// Bound on the H100: bytes. Every query token of a decode step reads its
// whole visible K/V history and does ~4 flops per byte of it, so the least
// time is the K/V bytes the step's tokens need over 3.35 TB/s.
//
// Design: one block per (kv head, token). Its Hq/Hkv query heads — one warp
// each — share every K/V page the block loads, so a page is read from device
// memory once per kv head instead of once per query head (the TPU kernel
// folded the group into one dot for the same reason). There is no scalar
// prefetch: the block reads its own rows[t], valids[t] and table entries,
// and only loads blocks j with j*block_size < valids[t]; the TPU grid's
// sequential block axis becomes a loop inside the block. Pages arrive with
// 16-byte loads into shared memory; K rows are padded by 16 bytes so that
// lane r reading row r in 16-byte pieces hits distinct banks. Scores: lane r
// owns cache rows r, r+32, ...; the online-softmax max and sum are warp
// reductions. PV: lane owns one 16-byte column chunk of a row phase, and
// the row phases are summed with shuffles at the end.
#include "common.cuh"

namespace {

template <typename KT, int D> struct Geo {
  static constexpr int V = 16 / sizeof(KT);  // elements per 16-byte chunk
  static constexpr int CH = D / V;           // chunks per row
  static constexpr int RP = 32 / CH;         // row phases per warp in PV
  static constexpr int KS = D + V;           // padded K row (elements)
  static_assert(CH >= 1 && CH <= 32 && 32 % CH == 0, "unsupported head_dim");
};

template <typename KT, int D>
size_t smem_bytes(int bs, int group) {
  using G = Geo<KT, D>;
  return static_cast<size_t>(bs) * G::KS * sizeof(KT) +
         static_cast<size_t>(bs) * D * sizeof(KT) +
         static_cast<size_t>(group) * D * sizeof(float) +
         static_cast<size_t>(group) * bs * sizeof(float);
}

template <typename QT, typename KT, int D>
__global__ void ragged_paged_attn_kernel(
    const QT* __restrict__ q, const KT* __restrict__ kc,
    const KT* __restrict__ vc, const int* __restrict__ tables,
    const int* __restrict__ rows, const int* __restrict__ valids,
    QT* __restrict__ out, int Hq, int Hkv, int bs, int width, float scale) {
  using G = Geo<KT, D>;
  constexpr int V = G::V, CH = G::CH, RP = G::RP, KS = G::KS;
  extern __shared__ uint4 smem_raw[];
  const int g = blockIdx.x, t = blockIdx.y;
  const int group = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = g * group + warp;

  KT* Ks = reinterpret_cast<KT*>(smem_raw);  // [bs][KS]
  KT* Vs = Ks + bs * KS;                      // [bs][D]
  float* Qs = reinterpret_cast<float*>(Vs + bs * D);  // [group][D]
  float* Ps = Qs + group * D;                          // [group][bs]
  float* qw = Qs + warp * D;
  float* pw = Ps + warp * bs;

  const int valid = valids[t];
  const int row = rows[t];
  for (int c = lane; c < D; c += 32)
    qw[c] = to_f<QT>(q[(static_cast<size_t>(t) * Hq + h) * D + c]);

  float m = -CUDART_INF_F, l = 0.f, acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;

  int nblk = valid > 0 ? (valid + bs - 1) / bs : 0;
  if (nblk > width) nblk = width;
  const size_t page_row = static_cast<size_t>(Hkv) * D;  // elements per cache row
  for (int j = 0; j < nblk; ++j) {
    const size_t base = static_cast<size_t>(tables[static_cast<size_t>(row) * width + j]) * bs;
    __syncthreads();  // the previous page's K/V reads are done (and qw is stored)
    for (int i = threadIdx.x; i < bs * CH; i += blockDim.x) {
      const int r = i / CH, ch = i % CH;
      const size_t src = (base + r) * page_row + static_cast<size_t>(g) * D + ch * V;
      *reinterpret_cast<uint4*>(Ks + r * KS + ch * V) =
          *reinterpret_cast<const uint4*>(kc + src);
      *reinterpret_cast<uint4*>(Vs + r * D + ch * V) =
          *reinterpret_cast<const uint4*>(vc + src);
    }
    __syncthreads();

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
      s = j * bs + r < valid ? s * scale : -CUDART_INF_F;
      pw[r] = s;
      mloc = fmaxf(mloc, s);
    }
    mloc = warp_max(mloc);
    const float m_new = fmaxf(m, mloc);
    const float m_safe = m_new == -CUDART_INF_F ? 0.f : m_new;
    const float alpha = m == -CUDART_INF_F ? 0.f : expf(m - m_safe);
    float lsum = 0.f;
    for (int r = lane; r < bs; r += 32) {
      const float p = j * bs + r < valid ? expf(pw[r] - m_safe) : 0.f;
      pw[r] = p;
      lsum += p;
    }
    lsum = warp_sum(lsum);
    l = alpha * l + lsum;
    m = m_new;
    __syncwarp();  // pw[] complete before other lanes read it

#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] *= alpha;
    const int ch = lane % CH;
    for (int r = lane / CH; r < bs; r += RP) {
      float vf[V];
      unpack<KT>(*reinterpret_cast<const uint4*>(Vs + r * D + ch * V), vf);
      const float p = pw[r];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
    }
    __syncwarp();
  }

  // lanes holding the same column chunk (different row phases) add up
#pragma unroll
  for (int off = CH; off < 32; off <<= 1)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  if (lane < CH) {
    const float l_safe = l == 0.f ? 1.f : l;
    QT* o = out + (static_cast<size_t>(t) * Hq + h) * D + lane * V;
#pragma unroll
    for (int e = 0; e < V; ++e) o[e] = from_f<QT>(acc[e] / l_safe);
  }
}

template <typename QT, typename KT, int D>
int launch(const void* q, const void* kc, const void* vc, const int* tables,
           const int* rows, const int* valids, void* out, int T, int Hq, int Hkv,
           int bs, int width, float scale, cudaStream_t stream) {
  const int group = Hq / Hkv;
  const size_t bytes = smem_bytes<KT, D>(bs, group);
  auto kern = ragged_paged_attn_kernel<QT, KT, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(Hkv, T);
  kern<<<grid, 32 * group, bytes, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kc),
      static_cast<const KT*>(vc), tables, rows, valids, static_cast<QT*>(out),
      Hq, Hkv, bs, width, scale);
  PTT_RETURN_LAUNCH_ERROR();
}

template <typename QT, typename KT>
int dispatch_d(const void* q, const void* kc, const void* vc, const int* tables,
               const int* rows, const int* valids, void* out, int T, int Hq,
               int Hkv, int D, int bs, int width, float scale, cudaStream_t s) {
  switch (D) {
    case 64:
      return launch<QT, KT, 64>(q, kc, vc, tables, rows, valids, out, T, Hq, Hkv,
                                bs, width, scale, s);
    case 128:
      return launch<QT, KT, 128>(q, kc, vc, tables, rows, valids, out, T, Hq, Hkv,
                                 bs, width, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: [T, Hq, D]; k_cache/v_cache: [rows, Hkv, D] (one layer, flat token-major);
// tables: [S, width] int32; rows/valids: [T] int32; out like q.
extern "C" int ptt_ragged_paged_attn(const void* q, const void* kc, const void* vc,
                                     const void* tables, const void* rows,
                                     const void* valids, void* out, int T, int Hq,
                                     int Hkv, int D, int bs, int width, float scale,
                                     int q_dtype, int kv_dtype, void* stream) {
  if (T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* rw = static_cast<const int*>(rows);
  const int* vl = static_cast<const int*>(valids);
  if (q_dtype == PTT_F32 && kv_dtype == PTT_BF16)
    return dispatch_d<float, __nv_bfloat16>(q, kc, vc, tb, rw, vl, out, T, Hq, Hkv,
                                            D, bs, width, scale, s);
  if (q_dtype == PTT_F32 && kv_dtype == PTT_F32)
    return dispatch_d<float, float>(q, kc, vc, tb, rw, vl, out, T, Hq, Hkv, D, bs,
                                    width, scale, s);
  if (q_dtype == PTT_BF16 && kv_dtype == PTT_BF16)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(q, kc, vc, tb, rw, vl, out, T,
                                                    Hq, Hkv, D, bs, width, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
