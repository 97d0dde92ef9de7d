// Ragged paged attention over quantized KV pages (int8 or fp8 e4m3, with
// per-row, per-head fp32 scales) for Hopper: the compiled serving step's
// attention when the KV cache is quantized.
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
// the larger of the two times from each run's inputs.
//
// Design, from the paged decode kernel (csrc/paged_attention.cu): one block
// per (token, kv head). The block loads its own rows[t], valids[t] and table
// row (the TPU kernel's scalar prefetch) and walks its pages in order; the
// group's Hq/Hkv query heads, one warp each, share every page the block
// loads. Pages are double buffered in shared memory with 16-byte cp.async
// copies (16 one-byte values each, half the copies of a bf16 page), and the
// page's two scale columns ride beside it in 4-byte copies; the block has at
// least kMinWarps warps so a small group still issues its copies from 128
// threads. K rows are padded by 16 bytes so that lane r reading row r hits
// distinct banks.
//
// Dequant is folded where it costs least: q.(k_q * s_k) = (q.k_q) * s_k, so
// the K scale multiplies each score once, and p * (v_q * s_v) = (p * s_v) *
// v_q, so the V scale multiplies each softmax weight before PV; one multiply
// a row instead of one an element. The plain twin dequantizes first, so the
// two round in another order; the port holds the kernel to 1e-4 x the
// twin's largest magnitude for an fp32 output and to the bf16 tier for a
// bf16 one. Splitting a long context over several blocks (flash decoding),
// TMA and wgmma are left for later.
//
// Head dims: the kernel is instantiated at a padded head dim D of 64, 128 or
// 256 (head_dim_bucket, common.cuh) and told the real d, a multiple of 16, so
// a row is whole 16-byte chunks: only the d / 16 chunks that exist are copied,
// scored, summed and stored, with d as the row length in device memory. At D
// 256 a stage is 34,304 bytes at 64 rows, so two stages fit every group.
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "common.cuh"

namespace {

constexpr int kMinWarps = 4;

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

struct PageI8 {};
struct PageF8 {};

// 16 one-byte page values unpacked into floats, element i from byte i.
// int8 without the quarter-rate integer-to-float conversion: with its sign
// bit flipped the byte is v + 128 in [0, 255]; placed under the exponent of
// 2^23 (0x4B0000xx) it is the float 2^23 + v + 128, exact, and one add
// takes 2^23 + 128 off. A byte permute and an add, both full rate.
__device__ __forceinline__ void unpack_page(const uint4& u, float* f, PageI8) {
  const uint32_t w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u,
                         u.z ^ 0x80808080u, u.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[4 * i + b] =
          __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540u | b)) - 8388736.f;
}

__device__ __forceinline__ void unpack_page(const uint4& u, float* f, PageF8) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {  // e4m3 -> fp16 is exact, so is fp16 -> fp32
      const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w[i] >> (16 * p)), __NV_E4M3);
      const float2 f2 = __half22float2(__half2(hr));
      f[4 * i + 2 * p] = f2.x;  // the low byte is the lower element
      f[4 * i + 2 * p + 1] = f2.y;
    }
  }
}

template <int D> struct Geo {
  static constexpr int CH = D / 16;  // 16-byte chunks per padded row
  static constexpr int RP = 32 / CH; // row phases per warp in PV
  static constexpr int KS = D + 16;  // padded K row, bytes
  static_assert(CH >= 1 && CH <= 32 && 32 % CH == 0, "unsupported head_dim");
};

// one stage: [K page (padded rows) | V page | K scales | V scales], rounded
// up to 16 bytes so the second stage's copies stay aligned
template <int D> __host__ __device__ int stage_bytes(int bs) {
  const int raw = bs * (Geo<D>::KS + D + 2 * static_cast<int>(sizeof(float)));
  return (raw + 15) / 16 * 16;
}

// two stages, then the group's q rows and p rows in fp32
template <int D> size_t smem_bytes(int bs, int group) {
  return 2 * static_cast<size_t>(stage_bytes<D>(bs)) +
         static_cast<size_t>(group) * D * sizeof(float) +
         static_cast<size_t>(group) * bs * sizeof(float);
}

template <typename QT, typename PT, int D>
__global__ void __launch_bounds__(1024)
ragged_attn_quant_kernel(const QT* __restrict__ q, const uint8_t* __restrict__ kc,
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

  const int stage = stage_bytes<D>(bs);
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
int launch(const void* q, const void* kc, const void* vc, const float* ks,
           const float* vs, const int* tables, const int* rows, const int* valids,
           void* out, int T, int Hq, int Hkv, int d, int bs, int width, float scale,
           cudaStream_t stream) {
  const int group = Hq / Hkv;
  const size_t bytes = smem_bytes<D>(bs, group);
  auto kern = ragged_attn_quant_kernel<QT, PT, D>;
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

template <typename QT, typename PT>
int dispatch_d(const void* q, const void* kc, const void* vc, const float* ks,
               const float* vs, const int* tables, const int* rows,
               const int* valids, void* out, int T, int Hq, int Hkv, int D, int bs,
               int width, float scale, cudaStream_t s) {
  switch (head_dim_bucket(D)) {
    case 64:
      return launch<QT, PT, 64>(q, kc, vc, ks, vs, tables, rows, valids, out, T,
                                Hq, Hkv, D, bs, width, scale, s);
    case 128:
      return launch<QT, PT, 128>(q, kc, vc, ks, vs, tables, rows, valids, out, T,
                                 Hq, Hkv, D, bs, width, scale, s);
    case 256:
      return launch<QT, PT, 256>(q, kc, vc, ks, vs, tables, rows, valids, out, T,
                                 Hq, Hkv, D, bs, width, scale, s);
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

// q: [T, Hq, D] fp32 or bf16; k_cache/v_cache: [rows, Hkv, D] int8 or fp8 e4m3
// (one layer, flat token-major); k_scale/v_scale: [rows, Hkv] fp32; tables:
// [S, width] int32; rows/valids: [T] int32; out like q.
extern "C" int ptt_ragged_paged_attn_quant(
    const void* q, const void* kc, const void* vc, const void* k_scale,
    const void* v_scale, const void* tables, const void* rows, const void* valids,
    void* out, int T, int Hq, int Hkv, int D, int bs, int width, float scale,
    int q_dtype, int page_dtype, void* stream) {
  if (T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tb = static_cast<const int*>(tables);
  const int* rw = static_cast<const int*>(rows);
  const int* vl = static_cast<const int*>(valids);
  if (q_dtype == PTT_F32)
    return dispatch_page<float>(page_dtype, q, kc, vc, ks, vs, tb, rw, vl, out, T,
                                Hq, Hkv, D, bs, width, scale, s);
  if (q_dtype == PTT_BF16)
    return dispatch_page<__nv_bfloat16>(page_dtype, q, kc, vc, ks, vs, tb, rw, vl,
                                        out, T, Hq, Hkv, D, bs, width, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
