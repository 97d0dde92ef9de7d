// Fused decoder block for Hopper: causal GQA flash attention, the
// o-projection folded into an fp32 residual, RMSNorm and the SwiGLU MLP in
// one kernel.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_block.py:_fused_fwd
// (:222, kernel body _fused_kernel :121-219). Same math and rounding points:
//   h   = resid (fp32) + sum over heads of (attention_h rounded to T) . Wo_h,
//   hn  = (h * rsqrt(mean(h^2) + eps) * wn) rounded to T   (wn fp32),
//   h  += act . Wd_f  over blocks f of ffn, with
//   act = (silu(hn . Wg_f -> T) * (hn . Wu_f -> T)) -> T,
//   out = h rounded to T.
// Attention is the forward kernel's math (csrc/flash_attention.cu): fp32
// online softmax, p rounded to T for the PV product, l summed unrounded.
//
// Bound on the H100: operations. Per 16-row tile the block streams the
// layer's weights (Wo, Wg, Wu, Wd; 21M values at the flagship widths) from
// L2 and does 2*16 flops per weight value, plus the causal attention; no
// intermediate (attention output, h, hn, gate/up activations) ever reaches
// device memory, only q, k, v and the residual are read and the block's
// output written. This first version runs every product on the CUDA cores
// in fp32 (67 TFLOP/s peak); tensor cores, TMA and weight reuse across
// tiles are later work.
//
// Design: one block of 256 threads per (16-row query tile, batch), late
// tiles first (they see the most keys). The TPU kernel's sequential grid
// axis over (head, key block) then ffn block is a loop in the block.
// Shared memory holds the fp32 residual accumulator H [16][hidden] for the
// block's lifetime (6 KB per row at hidden 1536, which is what caps the
// tile at 16 rows), and one union region that serves the attention phase
// (Q tile, a 64-key K/V tile, p, the head's output) and then the MLP phase
// (hn as [hidden][16] in T, the act tile [256][16] fp32). At the flagship
// widths that is ~181 KB in bf16, above the 48 KB default, so the launch
// raises the block's dynamic shared-memory limit first.
// Products against a weight matrix (Wo_h, Wd_f) give each thread 16 rows x
// 6 columns of fp32 accumulators; the 16 row values of one k come from
// shared memory as four float4 broadcasts, the 6 weights from L2.
#include "common.cuh"

namespace {

constexpr int kRows = 16;      // query rows per block
constexpr int kBK = 64;        // keys per attention tile
constexpr int kBF = 256;       // ffn columns per MLP step (one per thread)
constexpr int kThreads = 256;
constexpr int kCols = 6;       // hidden columns per thread per pass
static_assert(kThreads == kBF, "one ffn column per thread");
static_assert(kThreads == kRows * 16, "16 threads per query row");

struct Layout {  // byte offsets into dynamic shared memory
  size_t h, rstat, qs, ks, vs, ps, os, hn, act, total;
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__host__ __device__ inline Layout layout(int hidden, int D, int esize) {
  Layout L;
  L.h = 0;
  L.rstat = align16(L.h + size_t(kRows) * hidden * 4);
  const size_t u = align16(L.rstat + kRows * 4);
  // attention phase
  L.qs = u;
  L.ks = align16(L.qs + size_t(kRows) * D * 4);
  L.vs = align16(L.ks + size_t(kBK) * (D + 1) * 4);
  L.ps = align16(L.vs + size_t(kBK) * D * 4);
  L.os = align16(L.ps + size_t(kRows) * (kBK + 1) * 4);
  const size_t attn_end = align16(L.os + size_t(D) * kRows * 4);
  // MLP phase, over the same bytes
  L.hn = u;
  L.act = align16(L.hn + size_t(hidden) * kRows * esize);
  const size_t mlp_end = align16(L.act + size_t(kBF) * kRows * 4);
  L.total = attn_end > mlp_end ? attn_end : mlp_end;
  return L;
}

// H[r][c] += sum_{k < K} A[k][r] * W[k][c] for r < 16, c < hidden; A is
// [K][16] fp32 in shared memory, W [K][hidden] row-major in device memory.
// Each thread owns the columns c0 + tid + kThreads*m: no column is shared.
template <typename T>
__device__ __forceinline__ void fold_rows(const float* A, int K, const T* W,
                                          int hidden, float* H) {
  for (int c0 = 0; c0 < hidden; c0 += kThreads * kCols) {
    float acc[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int m = 0; m < kCols; ++m) acc[r][m] = 0.f;
    int col[kCols];
#pragma unroll
    for (int m = 0; m < kCols; ++m) col[m] = c0 + threadIdx.x + kThreads * m;
#pragma unroll 2
    for (int kk = 0; kk < K; ++kk) {
      float w[kCols];
#pragma unroll
      for (int m = 0; m < kCols; ++m)
        w[m] = col[m] < hidden ? to_f<T>(W[static_cast<size_t>(kk) * hidden + col[m]])
                               : 0.f;
      const float4* av = reinterpret_cast<const float4*>(A + kk * kRows);
#pragma unroll
      for (int i = 0; i < kRows / 4; ++i) {
        const float4 a = av[i];
#pragma unroll
        for (int m = 0; m < kCols; ++m) {
          acc[4 * i][m] = fmaf(a.x, w[m], acc[4 * i][m]);
          acc[4 * i + 1][m] = fmaf(a.y, w[m], acc[4 * i + 1][m]);
          acc[4 * i + 2][m] = fmaf(a.z, w[m], acc[4 * i + 2][m]);
          acc[4 * i + 3][m] = fmaf(a.w, w[m], acc[4 * i + 3][m]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kCols; ++m) {
      if (col[m] >= hidden) continue;
#pragma unroll
      for (int r = 0; r < kRows; ++r) H[r * hidden + col[m]] += acc[r][m];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fused_block_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ resid,
                   const float* __restrict__ wn, const T* __restrict__ wo,
                   const T* __restrict__ wg, const T* __restrict__ wu,
                   const T* __restrict__ wd, T* __restrict__ out, int S, int nh,
                   int nkv, int hidden, int ffn, float scale, float eps) {
  constexpr int NC = D / 16, DP = D + 1, PP = kBK + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(hidden, D, sizeof(T));
  float* H = reinterpret_cast<float*>(smem + L.h);       // [kRows][hidden]
  float* rstat = reinterpret_cast<float*>(smem + L.rstat);
  float* Qs = reinterpret_cast<float*>(smem + L.qs);     // [kRows][D]
  float* Ks = reinterpret_cast<float*>(smem + L.ks);     // [kBK][DP]
  float* Vs = reinterpret_cast<float*>(smem + L.vs);     // [kBK][D]
  float* Ps = reinterpret_cast<float*>(smem + L.ps);     // [kRows][PP]
  float* Os = reinterpret_cast<float*>(smem + L.os);     // [D][kRows]
  T* Hn = reinterpret_cast<T*>(smem + L.hn);             // [hidden][kRows]
  float* Act = reinterpret_cast<float*>(smem + L.act);   // [kBF][kRows]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int group = nh / nkv;
  const size_t q_row = static_cast<size_t>(nh) * D;
  const size_t kv_row = static_cast<size_t>(nkv) * D;
  const size_t tok0 = static_cast<size_t>(b) * S;

  for (int i = tid; i < kRows * hidden; i += kThreads) {
    const int r = i / hidden, c = i % hidden, gr = q0 + r;
    H[i] = gr < S ? to_f<T>(resid[(tok0 + gr) * hidden + c]) : 0.f;
  }

  // ---- attention, one head at a time, each folded through its Wo slice
  const int row = q0 + ty;  // this thread's query row
  const int k_end = min(S, q0 + kRows);
  for (int hh = 0; hh < nh; ++hh) {
    const int hk = hh / group;
    const T* qb = q + tok0 * q_row + hh * D;
    const T* kb = k + tok0 * kv_row + hk * D;
    const T* vb = v + tok0 * kv_row + hk * D;
    __syncthreads();  // the previous head's Qs/Os reads are done
    for (int i = tid; i < kRows * D; i += kThreads) {
      const int r = i / D, c = i % D, gr = q0 + r;
      Qs[i] = gr < S ? to_f<T>(qb[gr * q_row + c]) : 0.f;
    }
    float m = -CUDART_INF_F, l = 0.f, acc[NC];
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[n] = 0.f;

    for (int k0 = 0; k0 < k_end; k0 += kBK) {
      __syncthreads();  // previous tile's K/V/P reads are done
      for (int i = tid; i < kBK * D; i += kThreads) {
        const int r = i / D, c = i % D, gr = k0 + r;
        const bool in = gr < S;
        Ks[r * DP + c] = in ? to_f<T>(kb[gr * kv_row + c]) : 0.f;
        Vs[r * D + c] = in ? to_f<T>(vb[gr * kv_row + c]) : 0.f;
      }
      __syncthreads();

      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        const float qv = Qs[ty * D + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] = fmaf(qv, Ks[(tx + 16 * j) * DP + c], s[j]);
      }
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        s[j] = (col < S && col <= row) ? s[j] * scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)  // the row's 16 threads
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m, mx);
      const float m_safe = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = expf(m - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[j] - m_safe);
        sum += p;
        Ps[ty * PP + tx + 16 * j] = round_through<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l = alpha * l + sum;
      m = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[n] *= alpha;
      __syncthreads();

#pragma unroll 4
      for (int j = 0; j < kBK; ++j) {
        const float p = Ps[ty * PP + j];
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[n] = fmaf(p, Vs[j * D + tx + 16 * n], acc[n]);
      }
    }
    const float l_safe = l == 0.f ? 1.f : l;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      Os[(tx + 16 * n) * kRows + ty] = round_through<T>(acc[n] / l_safe);
    __syncthreads();
    fold_rows<T>(Os, D, wo + static_cast<size_t>(hh) * D * hidden, hidden, H);
  }
  __syncthreads();

  // ---- post-attention RMSNorm of the fp32 rows into hn (T)
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    float ss = 0.f;
    for (int c = lane; c < hidden; c += 32) ss = fmaf(H[r * hidden + c], H[r * hidden + c], ss);
    ss = warp_sum(ss);
    if (lane == 0) rstat[r] = rsqrtf(ss / static_cast<float>(hidden) + eps);
  }
  __syncthreads();
  for (int i = tid; i < kRows * hidden; i += kThreads) {
    const int r = i / hidden, c = i % hidden;
    Hn[c * kRows + r] = from_f<T>(H[i] * rstat[r] * wn[c]);
  }
  __syncthreads();

  // ---- SwiGLU MLP over ffn blocks, accumulated into H
  constexpr int V = 16 / sizeof(T);
  for (int f0 = 0; f0 < ffn; f0 += kBF) {
    const int f = f0 + tid;
    float g[kRows], u[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) g[r] = u[r] = 0.f;
    if (f < ffn) {
#pragma unroll 2
      for (int kk = 0; kk < hidden; ++kk) {
        const float wgv = to_f<T>(wg[static_cast<size_t>(kk) * ffn + f]);
        const float wuv = to_f<T>(wu[static_cast<size_t>(kk) * ffn + f]);
        const uint4* hv = reinterpret_cast<const uint4*>(Hn + kk * kRows);
#pragma unroll
        for (int i = 0; i < kRows / V; ++i) {
          float x[V];
          unpack<T>(hv[i], x);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            g[i * V + e] = fmaf(x[e], wgv, g[i * V + e]);
            u[i * V + e] = fmaf(x[e], wuv, u[i * V + e]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float gr = round_through<T>(g[r]);
      const float ur = round_through<T>(u[r]);
      const float a = round_through<T>(gr / (1.f + expf(-gr)));  // silu
      Act[tid * kRows + r] = f < ffn ? round_through<T>(a * ur) : 0.f;
    }
    __syncthreads();
    fold_rows<T>(Act, min(kBF, ffn - f0), wd + static_cast<size_t>(f0) * hidden,
                 hidden, H);
    __syncthreads();  // Act is rewritten by the next ffn block
  }

  for (int i = tid; i < kRows * hidden; i += kThreads) {
    const int r = i / hidden, c = i % hidden, gr = q0 + r;
    if (gr < S) out[(tok0 + gr) * hidden + c] = from_f<T>(H[i]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* resid,
           const float* wn, const void* wo, const void* wg, const void* wu,
           const void* wd, void* out, int B, int S, int nh, int nkv, int hidden,
           int ffn, float scale, float eps, cudaStream_t stream) {
  auto kern = fused_block_kernel<T, D>;
  const size_t bytes = layout(hidden, D, sizeof(T)).total;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((S + kRows - 1) / kRows, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(resid), wn, static_cast<const T*>(wo),
      static_cast<const T*>(wg), static_cast<const T*>(wu),
      static_cast<const T*>(wd), static_cast<T*>(out), S, nh, nkv, hidden, ffn,
      scale, eps);
  PTT_RETURN_LAUNCH_ERROR();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* resid,
               const float* wn, const void* wo, const void* wg, const void* wu,
               const void* wd, void* out, int B, int S, int nh, int nkv, int D,
               int hidden, int ffn, float scale, float eps, cudaStream_t s) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, resid, wn, wo, wg, wu, wd, out, B, S, nh, nkv,
                           hidden, ffn, scale, eps, s);
    case 128:
      return launch<T, 128>(q, k, v, resid, wn, wo, wg, wu, wd, out, B, S, nh,
                            nkv, hidden, ffn, scale, eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Dynamic shared memory the kernel needs (the wrapper checks it against
// the card's per-block limit before launching).
extern "C" long long ptt_fused_block_smem_bytes(int hidden, int D, int dtype) {
  return static_cast<long long>(
      layout(hidden, D, dtype == PTT_BF16 ? 2 : 4).total);
}

// q [B, S, nh, D], k/v [B, S, nkv, D], resid/out [B, S, hidden], wo
// [nh*D, hidden], wg/wu [hidden, ffn], wd [ffn, hidden], all dtype code
// `dtype`; wn [hidden] fp32.
extern "C" int ptt_fused_block_fwd(const void* q, const void* k, const void* v,
                                   const void* resid, const void* wn,
                                   const void* wo, const void* wg, const void* wu,
                                   const void* wd, void* out, int B, int S, int nh,
                                   int nkv, int D, int hidden, int ffn,
                                   float scale, float eps, int dtype,
                                   void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(wn);
  if (dtype == PTT_F32)
    return dispatch_d<float>(q, k, v, resid, w, wo, wg, wu, wd, out, B, S, nh, nkv,
                             D, hidden, ffn, scale, eps, s);
  if (dtype == PTT_BF16)
    return dispatch_d<__nv_bfloat16>(q, k, v, resid, w, wo, wg, wu, wd, out, B, S,
                                     nh, nkv, D, hidden, ffn, scale, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
