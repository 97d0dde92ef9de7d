// Fused decoder block for Hopper: causal GQA flash attention, the
// o-projection folded into an fp32 residual, RMSNorm and the SwiGLU MLP.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_block.py:_fused_fwd
// (:222 -> pallas_call :245, kernel body _fused_kernel :121-219). Same math
// and rounding points, for T the residual's dtype:
//   h   = resid (fp32) + sum over heads of (attention_h rounded to T) . Wo_h,
//   hn  = (h * rsqrt(mean(h^2) + eps) * wn) rounded to T   (wn fp32),
//   act = (silu(hn . Wg -> T) -> T) * (hn . Wu -> T), rounded to T,
//   out = (h + act . Wd) rounded to T.
// Attention is the forward kernel's math (csrc/flash_attention.cu): fp32
// online softmax, p rounded to T for the PV product, l summed unrounded.
//
// Bound on the H100: operations. At the flagship layer (4 x 2048 tokens,
// 12:4 heads of 128, hidden 1536, ffn 4096, bf16) the products are ~400
// GFLOP against ~135 MB of inputs and output: above the card's ~295
// flop/byte bf16 ridge, so every product belongs on the tensor cores.
//
// The TPU kernel keeps one row tile's fp32 residual, attention output and
// activations in VMEM for the whole layer. That design cannot carry over at
// tensor-core tile sizes: a 128-row tile's fp32 residual at hidden 1536 is
// 768 KB, and an SM has 227 KB. So the bf16 route (the training path) is a
// chain of five launches on the caller's stream, each a hand-written
// tensor-core kernel, with the intermediates in scratch the wrapper
// allocates (o, lse, h fp32, hn, act; ~170 MB at the flagship):
//   1. attention: #1's host launcher (ptt_flash_attn_fwd, DenseMask causal):
//      its wgmma kernel at head dims 64 and 128, its edge route at any other
//      multiple of 16 up to 256; o [b, s, nh, d] in T is the o-projection's
//      A as [M, nh*d] (M = b*s) in place;
//   2. o-projection: fused_block_gemm<OProj>, h = float(resid) + o . Wo,
//      stored in fp32;
//   3. RMSNorm: #5's kernel instantiated for an fp32 input and a T output
//      (csrc/rms_norm.cu, rms_norm_fwd_f32_bf16): hn;
//   4. gate/up: fused_block_gemm<GateUp>, both weight streams fed from each
//      A stage (as #13's gmm2): a thread holds g and u of the same element
//      and stores act with the four roundings above;
//   5. down: fused_block_gemm<Down>, out = T(h + act . Wd).
// The GEMM (below) is a dense wgmma kernel with the epilogue as a
// compile-time policy, on #11/#13's layout (csrc/grouped_gemm.cu): 128 x 256
// output tiles (128 x 128 of each stream for GateUp), two consumer
// warpgroups of 64 rows and a producer warp keeping a 4-stage TMA ring of
// 64-deep stages full, guarded by full/empty mbarriers; B ([K, N]
// row-major: Wo, Wg, Wu, Wd as stored) read MN-major in place through the
// transpose bit; the ragged M, N and K edges zero-filled by TMA and masked
// in the epilogue. Unlike #11/#13 it keeps one wgmma batch in flight
// (wgmma_wait<1>) and frees the stage behind it, so the tensor cores do not
// wait on the ring between stages, and a warpgroup runs one m64n256 product
// a k16 step over both 128-column halves (GateUp's two streams sit side by
// side in the stage). Each output element has one block and one summation
// order (no split-K, no atomics): repeats are bitwise. On an H100 80GB HBM3
// at 700 W the three GEMMs run at 340-552 TFLOP/s, against 772-785 for
// cuBLAS's four in the composed forward (PERF.md); sharing B between two blocks of a
// cluster by TMA multicast timed the same, so the L2 is not what bounds
// them.
//
// The edge route (fp32, and bf16 on a base TMA cannot map) is the first
// port's single kernel, fused_block_kernel below, unchanged: one block of
// 256 threads per (16-row query tile, batch), late tiles first; the fp32
// residual H [16][hidden] in shared memory for the block's lifetime (what
// caps the tile at 16 rows) and one union region for the attention phase
// (Q tile, a 64-key K/V tile, p, the head's output) and then the MLP phase
// (hn as [hidden][16] in T, the act tile [256][16] fp32); every product in
// fp32 on the CUDA cores. It takes head dims 64 and 128 and shared memory
// up to one block's 227 KB (the wrapper checks both).
#include "common.cuh"
#include "hopper.cuh"

// #1's host launcher (csrc/flash_attention.cu) and #5's fp32-in, bf16-out
// forward (csrc/rms_norm.cu): steps 1 and 3 of the bf16 chain.
extern "C" int ptt_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                                  int causal, float scale, int dtype, int tma, void* stream);
int rms_norm_fwd_f32_bf16(const void* x, const void* w, void* y, int rows, int d, float eps,
                          cudaStream_t s);

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

// ------------------------------------------------------------------ bf16
// The chain's GEMM: C [M, N] = A [M, K] . B [K, N] (B1 and B2 for GateUp),
// bf16 in, fp32 accumulators, the epilogue a policy (see the header).
namespace chain {

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

// Epilogues. put(at, a0, a1): the accumulators of C's elements at and at + 1
// (row-major, at even: N is a multiple of 8); GateUp's put2 gets g's and u's.
struct OProj {  // h = float(resid) + o . Wo, fp32
  static constexpr bool kPair = false;
  const bf16* resid;
  float* h;
  __device__ __forceinline__ void put(size_t at, float a0, float a1) const {
    const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(resid + at));
    *reinterpret_cast<float2*>(h + at) = make_float2(r.x + a0, r.y + a1);
  }
};

struct GateUp {  // act = T(T(silu(T(g))) * T(u))
  static constexpr bool kPair = true;
  bf16* act;
  __device__ __forceinline__ static float swiglu(float g, float u) {
    const float gr = round_through<bf16>(g), ur = round_through<bf16>(u);
    return round_through<bf16>(gr / (1.f + expf(-gr))) * ur;
  }
  __device__ __forceinline__ void put2(size_t at, float g0, float g1, float u0,
                                       float u1) const {
    *reinterpret_cast<__nv_bfloat162*>(act + at) =
        __floats2bfloat162_rn(swiglu(g0, u0), swiglu(g1, u1));
  }
};

struct Down {  // out = T(h + act . Wd)
  static constexpr bool kPair = false;
  const float* h;
  bf16* out;
  __device__ __forceinline__ void put(size_t at, float a0, float a1) const {
    const float2 r = *reinterpret_cast<const float2*>(h + at);
    *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(r.x + a0, r.y + a1);
  }
};

// One block per (256 output columns, or 128 of each stream for GateUp;
// 128-row tile). A by a 2-D map over [M, K] in [128][64] boxes; B by 2-D
// maps over [K, N] in 64 x 64 boxes, read MN-major through the transpose bit.
template <class Epi>
__global__ void __launch_bounds__(kThreads, 1)
fused_block_gemm(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b1,
                 const __grid_constant__ CUtensorMap map_b2, int M, int K, int N,
                 Epi epi) {
  constexpr bool kPair = Epi::kPair;
  constexpr int kCols = kPair ? kNH : 2 * kNH;  // output columns a block
  const int m0 = blockIdx.y * kRows, n0 = blockIdx.x * kCols;
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
  if (warp == kConsumers / 32) {  // the producer warp
    if (lane == 0) {
      for (int t = 0; t < n_k; ++t) {
        const int s = t % kStages, k0 = t * 64;
        if (t >= kStages) hopper::mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
        unsigned char* st = sm + s * kStage;
        hopper::mbar_arrive_expect_tx(&full[s], kStage);
        // rows past M, columns past K and columns past N land as zeros
        hopper::tma_load_2d(st, &map_a, &full[s], k0, m0);
        for (int j = 0; j < 2; ++j) {
          unsigned char* bt = st + kA + j * kB;
          const CUtensorMap* mb = kPair && j == 1 ? &map_b2 : &map_b1;
          const int nb = kPair ? n0 : n0 + j * kNH;
          hopper::tma_load_2d(bt, mb, &full[s], nb, k0);
          hopper::tma_load_2d(bt + kB / 2, mb, &full[s], nb + 64, k0);
        }
      }
    }
    return;
  }

  // the stage's B is four 64-column atoms (B1's 128 columns, then B2's or
  // B1's next 128), one m64n256 product a k16 step: accumulator columns
  // 0-127 are the first stream's, 128-255 the second's
  const int g = warp >> 2;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  for (int t = 0; t < n_k; ++t) {
    const int s = t % kStages;
    hopper::mbar_wait(&full[s], (t / kStages) & 1);
    const unsigned char* st = sm + s * kStage;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = hopper::desc_sw128(st + g * 64 * 128 + kk * 32, 16, 1024);
      const uint64_t db = hopper::desc_sw128(st + kA + kk * 16 * 128, kB / 2, 1024);
      hopper::wgmma_m64n256_ss<1>(acc, da, db, 1);
    }
    hopper::wgmma_commit();
    // stage t's products may still run; stage t - 1's have finished, so its
    // buffers go back to the producer
    hopper::wgmma_wait<1>();
    if (t > 0) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[(t - 1) % kStages]);
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // thread (warp w of warpgroup g, lane l) holds rows 64g + 16w + l/4 (+ 8)
  // and column pairs 8(i/4) + 2(l%4) of each accumulator
  const int rt = m0 + 64 * g + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = rt + ((i & 2) ? 8 : 0);
    if (r >= M) continue;
    const int c = 8 * (i / 4) + 2 * (lane & 3);
    if constexpr (kPair) {
      if (n0 + c < N)
        epi.put2(static_cast<size_t>(r) * N + n0 + c, acc[i], acc[i + 1], acc[64 + i],
                 acc[64 + i + 1]);
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = n0 + j * kNH + c;
        if (col < N)
          epi.put(static_cast<size_t>(r) * N + col, acc[64 * j + i], acc[64 * j + i + 1]);
      }
    }
  }
}

// C = A . B (B1 and B2 for GateUp) with epilogue `epi`: A [M, K], B [K, N],
// bf16 row-major; K and N multiples of 8 and 16-byte-aligned bases (TMA).
template <class Epi>
int gemm(const void* a, const void* b1, const void* b2, int M, int K, int N, Epi epi,
         cudaStream_t stream) {
  constexpr int kCols = Epi::kPair ? kNH : 2 * kNH;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b1) |
                         reinterpret_cast<uintptr_t>(b2);
  const int row_tiles = (M + kRows - 1) / kRows;
  if (K % 8 != 0 || N % 8 != 0 || bits % 16 != 0 || row_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, m1, m2;
  const uint64_t da[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t sa[1] = {static_cast<uint64_t>(K) * 2};
  const uint32_t ba[2] = {64, kRows};
  const uint64_t db[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K)};
  const uint64_t sb[1] = {static_cast<uint64_t>(N) * 2};
  const uint32_t bb[2] = {64, 64};
  int err = hopper::bf16_map(&ma, a, 2, da, sa, ba);
  if (err == 0) err = hopper::bf16_map(&m1, b1, 2, db, sb, bb);
  if (err == 0) err = hopper::bf16_map(&m2, Epi::kPair ? b2 : b1, 2, db, sb, bb);
  if (err != 0) return err;
  auto kern = fused_block_gemm<Epi>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + kCols - 1) / kCols, row_tiles);
  kern<<<grid, kThreads, kBytes, stream>>>(ma, m1, m2, M, K, N, epi);
  PTT_RETURN_LAUNCH_ERROR();
}

// The five launches of the bf16 route (see the header).
int launch(const void* q, const void* k, const void* v, const void* resid, const float* wn,
           const void* wo, const void* wg, const void* wu, const void* wd, void* out, void* o,
           float* lse, float* h, void* hn, void* act, int B, int S, int nh, int nkv, int D,
           int hidden, int ffn, float scale, float eps, int attn_tma, cudaStream_t s) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(resid) | reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(hn) |
                         reinterpret_cast<uintptr_t>(act);
  if (bits % 16 != 0 || nh * D != hidden) return static_cast<int>(cudaErrorInvalidValue);
  const int M = B * S;
  int err = ptt_flash_attn_fwd(q, k, v, o, lse, B, S, S, nh, nkv, D, 1, scale, PTT_BF16,
                               attn_tma, s);
  if (err == 0)
    err = gemm(o, wo, nullptr, M, hidden, hidden, OProj{static_cast<const bf16*>(resid), h}, s);
  if (err == 0) err = rms_norm_fwd_f32_bf16(h, wn, hn, M, hidden, eps, s);
  if (err == 0) err = gemm(hn, wg, wu, M, hidden, ffn, GateUp{static_cast<bf16*>(act)}, s);
  if (err == 0)
    err = gemm(act, wd, nullptr, M, ffn, hidden, Down{h, static_cast<bf16*>(out)}, s);
  return err;
}

}  // namespace chain

}  // namespace

// Dynamic shared memory the kernel needs (the wrapper checks it against
// the card's per-block limit before launching).
extern "C" long long ptt_fused_block_smem_bytes(int hidden, int D, int dtype) {
  return static_cast<long long>(
      layout(hidden, D, dtype == PTT_BF16 ? 2 : 4).total);
}

// q [B, S, nh, D], k/v [B, S, nkv, D], resid/out [B, S, hidden], wo
// [nh*D, hidden], wg/wu [hidden, ffn], wd [ffn, hidden], all dtype code
// `dtype`; wn [hidden] fp32. chain 1 (bf16, 16-byte-aligned bases, hidden
// and ffn multiples of 8, a head dim #1 takes) runs the five launches of the
// bf16 route over the wrapper's scratch: o like q, lse [B, nh, S] fp32, h
// [B*S, hidden] fp32, hn [B*S, hidden] and act [B*S, ffn] in bf16; attn_tma
// is #1's route flag for q, k and v. chain 0 runs the edge route's single
// kernel (head dims 64 and 128; the scratch is not read). The wrapper picks
// the route from dtype, shape and alignment.
extern "C" int ptt_fused_block_fwd(const void* q, const void* k, const void* v,
                                   const void* resid, const void* wn,
                                   const void* wo, const void* wg, const void* wu,
                                   const void* wd, void* out, void* o, void* lse,
                                   void* h, void* hn, void* act, int B, int S,
                                   int nh, int nkv, int D, int hidden, int ffn,
                                   float scale, float eps, int dtype, int chain,
                                   int attn_tma, void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(wn);
  if (chain) {
    if (dtype != PTT_BF16) return static_cast<int>(cudaErrorInvalidValue);
    return chain::launch(q, k, v, resid, w, wo, wg, wu, wd, out, o,
                         static_cast<float*>(lse), static_cast<float*>(h), hn, act,
                         B, S, nh, nkv, D, hidden, ffn, scale, eps, attn_tma, s);
  }
  if (dtype == PTT_F32)
    return dispatch_d<float>(q, k, v, resid, w, wo, wg, wu, wd, out, B, S, nh, nkv,
                             D, hidden, ffn, scale, eps, s);
  if (dtype == PTT_BF16)
    return dispatch_d<__nv_bfloat16>(q, k, v, resid, w, wo, wg, wu, wd, out, B, S,
                                     nh, nkv, D, hidden, ffn, scale, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
