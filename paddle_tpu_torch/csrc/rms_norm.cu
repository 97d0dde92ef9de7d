// RMSNorm forward and backward for Hopper.
//
// Forward replaces the TPU kernel paddle_tpu/ops/pallas/rms_norm.py:_fwd_kernel
// (called by _fwd, rms_norm.py:64): y = x * rsqrt(sum(x^2)/d + eps) * w per
// row, statistics in fp32 over the true width, y in x's dtype, w fp32.
// Backward replaces _bwd_kernel (called by _bwd, rms_norm.py:116): r is
// recomputed from x,
//   dx = r*(dy*w) - (r^3/d) * x * sum(dy*w*x)   in x's dtype,
//   dw = sum over rows of dy*x*r                in fp32.
//
// Bound on the H100: bytes. The forward reads x and writes y once (w is
// tiny), ~4 flops an element; the backward reads x and dy and writes dx once,
// ~12 flops an element. Both are far below the card's flop rate, so the least
// time is their bytes over 3.35 TB/s.
//
// Design. The register route (every base 16-byte aligned, d a multiple of the
// 16-byte vector, at most kMaxCpt vectors a thread): a row belongs to a row
// group, a warp for rows of up to 256 vectors (d 2048 in bf16, 1024 in fp32)
// and a warpgroup for rows of up to 1024. Thread t of a group owns vectors t,
// t + TPR, ... of every row it touches, so its columns never change: the
// forward loads its slice of w once, as float4, and the backward keeps its
// columns' share of dw in fp32 registers. A row is read once with 16-byte
// loads and stays in registers through its reduction: shuffles in a warp; a
// warpgroup adds its four warp sums from shared memory behind a named barrier
// of its own, one barrier a row. Blocks of 256 threads (8 warps or 2
// warpgroups) make a persistent grid sized from the SM count and the
// kernel's occupancy; each row group strides over the rows in a fixed order.
// In the forward the next row's loads are in flight during the current row's
// reduction; the backward loads each row at the top of its iteration (loading
// a row ahead timed the same on an H100, PERF.md).
//
// The backward's dw is reduced with no atomics and gives the same bits on
// every run: the row groups of a block add their registers through shared
// memory in group order into the block's partial row, and a second launch
// sums the partials over blocks, a block for each tile of 32 columns: each
// of its slices adds every S-th partial in block order, then a fixed tree
// adds the slices. One launch that elected the last blocks to finish by a
// ticket (an atomicAdd after a __threadfence) to sum the partials in the
// same orders took 5.7 us more device time on an H100 at [8192, 1536]
// (PERF.md), so the second launch stays. The wrapper sizes the
// partials from the grid's cap (kBwdBlocksPerSm blocks an SM,
// ops/kernels/rms_norm.py agrees).
//
// The general route (a misaligned base, d no multiple of the vector, wider
// rows): the forward runs one block per row and reads the row twice (the
// second time from L1/L2); the backward runs 256-thread blocks striding over
// rows with dw in shared memory, then the same second launch.
//
// The forward also has an fp32-in, bf16-out instantiation of both routes
// (the output type TO; TO = T everywhere else): the fused decoder block's
// hn = T(h * rsqrt(mean(h^2) + eps) * wn) over its fp32 residual h
// (csrc/fused_block.cu, rms_norm_fwd_f32_bf16). A thread then stores each
// 4-float vector of x as 8 bytes of y.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;       // threads a block, every kernel here
constexpr int kMaxCpt = 8;          // 16-byte vectors a thread holds
constexpr int kWarpVecs = 32 * kMaxCpt;    // widest row a warp takes
constexpr int kGroupVecs = 128 * kMaxCpt;  // widest row a warpgroup takes
constexpr int kBwdBlocksPerSm = 2;  // the backward's grid cap an SM
constexpr int kSmemMax = 232448;    // dynamic shared memory a block may use

__device__ __forceinline__ void bar_named(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Sums of v[0..N) over the TPR threads of row group grp, given to each of
// them. A warp adds by shuffles; a wider group adds its warps' sums, in warp
// order, from red (this row's parity's slots of the group: N * TPR/32
// floats), so one barrier a row suffices.
template <int TPR, int N>
__device__ __forceinline__ void group_sum(float (&v)[N], float* red, int grp) {
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = warp_sum(v[k]);
  if (TPR > 32) {
    constexpr int W = TPR / 32;
    const int wi = (threadIdx.x % TPR) >> 5;
    if ((threadIdx.x & 31) == 0)
#pragma unroll
      for (int k = 0; k < N; ++k) red[k * W + wi] = v[k];
    bar_named(1 + grp, TPR);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float s = red[k * W];
#pragma unroll
      for (int i = 1; i < W; ++i) s += red[k * W + i];
      v[k] = s;
    }
  }
}

// Thread t's vectors of row `row` (t, t + TPR, ...); nothing past the rows.
template <int CPT, int TPR>
__device__ __forceinline__ void load_row(uint4 (&v)[CPT], const uint4* p, int row,
                                         int rows, int vecs, int t) {
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * vecs;
#pragma unroll
  for (int i = 0; i < CPT; ++i)
    if (t + i * TPR < vecs) v[i] = __ldg(p + base + t + i * TPR);
}

template <int V>
__device__ __forceinline__ void load4(float* f, const float4* p) {
#pragma unroll
  for (int e = 0; e < V; e += 4) {
    const float4 q = p[e / 4];
    f[e] = q.x;
    f[e + 1] = q.y;
    f[e + 2] = q.z;
    f[e + 3] = q.w;
  }
}

// ------------------------------------------------------------------ forward
// y's vector `at` (the V = 16 / sizeof(T) elements of x's vector `at`) from
// the floats f: 16 bytes where TO is T, 8 bytes for fp32 in and bf16 out.
template <typename T, typename TO>
__device__ __forceinline__ void store_vec(TO* y, size_t at, const float* f) {
  if constexpr (std::is_same<T, TO>::value) {
    reinterpret_cast<uint4*>(y)[at] = pack<T>(f);
  } else {
    static_assert(std::is_same<T, float>::value &&
                      std::is_same<TO, __nv_bfloat16>::value,
                  "the mixed instantiation is fp32 in, bf16 out");
    reinterpret_cast<uint2*>(y)[at] =
        make_uint2(hopper::pack_bf16(f[0], f[1]), hopper::pack_bf16(f[2], f[3]));
  }
}

template <typename T, int CPT, int TPR, typename TO = T>
__global__ void __launch_bounds__(kThreads)
rms_norm_fwd_reg(const T* __restrict__ x, const float* __restrict__ w,
                 TO* __restrict__ y, int rows, int d, float eps) {
  constexpr int V = 16 / sizeof(T);
  constexpr int G = kThreads / TPR;  // row groups a block
  __shared__ float red[2][kThreads / 32];
  const int vecs = d / V;
  const int t = threadIdx.x % TPR, grp = threadIdx.x / TPR;
  const int step = gridDim.x * G;
  const uint4* xv = reinterpret_cast<const uint4*>(x);

  float wf[CPT][V];  // this thread's columns of w, loaded once
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = t + i * TPR;
    if (c < vecs) {
      load4<V>(wf[i], reinterpret_cast<const float4*>(w) + c * (V / 4));
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) wf[i][e] = 0.f;
    }
  }

  int row = blockIdx.x * G + grp;
  uint4 cur[CPT], nxt[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) cur[i] = nxt[i] = make_uint4(0, 0, 0, 0);
  load_row<CPT, TPR>(cur, xv, row, rows, vecs, t);
  for (int it = 0; row < rows; ++it, row += step) {
    load_row<CPT, TPR>(nxt, xv, row + step, rows, vecs, t);  // one row ahead
    float ss[1] = {0.f};
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      if (t + i * TPR < vecs) {
        float f[V];
        unpack<T>(cur[i], f);
#pragma unroll
        for (int e = 0; e < V; ++e) ss[0] = fmaf(f[e], f[e], ss[0]);
      }
    }
    group_sum<TPR>(ss, red[it & 1] + grp * (TPR / 32), grp);
    const float r = rsqrtf(ss[0] / static_cast<float>(d) + eps);
    const size_t base = static_cast<size_t>(row) * vecs;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = t + i * TPR;
      if (c < vecs) {
        float f[V];
        unpack<T>(cur[i], f);
#pragma unroll
        for (int e = 0; e < V; ++e) f[e] = f[e] * r * wf[i][e];
        store_vec<T, TO>(y, base + c, f);
      }
    }
#pragma unroll
    for (int i = 0; i < CPT; ++i) cur[i] = nxt[i];
  }
}

// The general route: one block per row, two passes.
template <typename T, bool kVec, typename TO = T>
__global__ void __launch_bounds__(kThreads)
rms_norm_fwd_any(const T* __restrict__ x, const float* __restrict__ w,
                 TO* __restrict__ y, int d, float eps) {
  constexpr int V = 16 / sizeof(T);
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  TO* yr = y + row * d;

  float ss = 0.f;
  if (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < d / V; i += blockDim.x) {
      float f[V];
      unpack<T>(xv[i], f);
#pragma unroll
      for (int e = 0; e < V; ++e) ss = fmaf(f[e], f[e], ss);
    }
  } else {
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      const float f = to_f<T>(xr[c]);
      ss = fmaf(f, f, ss);
    }
  }
  ss = block_sum(ss);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  if (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < d / V; i += blockDim.x) {
      float f[V];
      unpack<T>(xv[i], f);
#pragma unroll
      for (int e = 0; e < V; ++e) f[e] = f[e] * r * w[i * V + e];
      store_vec<T, TO>(yr, i, f);
    }
  } else {
    for (int c = threadIdx.x; c < d; c += blockDim.x)
      yr[c] = from_f<TO>(to_f<T>(xr[c]) * r * w[c]);
  }
}

// ----------------------------------------------------------------- backward
__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
__device__ __forceinline__ void add_to(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// dw = the sum of the nb partial rows ([nb][d] fp32), in a fixed order: a
// block takes 32 columns as U units (float4s where d allows, else floats);
// slice sl of its S = kThreads / U slices adds partials sl, sl + S, ... in
// block order, then a tree over the slices in shared memory.
template <typename Unit>
__global__ void __launch_bounds__(kThreads)
rms_norm_bwd_dw(const float* __restrict__ part, int nb, int d,
                float* __restrict__ dw) {
  constexpr int W = sizeof(Unit) / sizeof(float);  // floats a unit
  constexpr int U = 32 / W;
  constexpr int S = kThreads / U;
  __shared__ Unit red[S][U];
  const int units = d / W;
  const int j = threadIdx.x % U, sl = threadIdx.x / U;
  const int c = blockIdx.x * U + j;
  const Unit* p = reinterpret_cast<const Unit*>(part);
  Unit a{};
  if (c < units) {
#pragma unroll 4
    for (int b = sl; b < nb; b += S) add_to(a, p[static_cast<size_t>(b) * units + c]);
  }
  red[sl][j] = a;
#pragma unroll
  for (int h = S / 2; h > 0; h >>= 1) {
    __syncthreads();
    if (sl < h) add_to(red[sl][j], red[sl + h][j]);
  }
  if (sl == 0 && c < units) reinterpret_cast<Unit*>(dw)[c] = red[0][j];
}

template <typename T, int CPT, int TPR>
__global__ void __launch_bounds__(kThreads, 1)
rms_norm_bwd_reg(const T* __restrict__ x, const float* __restrict__ w,
                 const T* __restrict__ dy, T* __restrict__ dx,
                 float* __restrict__ part, int rows, int d, float eps) {
  constexpr int V = 16 / sizeof(T);
  constexpr int G = kThreads / TPR;
  extern __shared__ float4 smem4[];
  float4* ws = smem4;                   // [d/4] the weight
  float4* accs = smem4 + d / 4;         // [G][d/4] each row group's dw
  __shared__ float red[2][2 * (kThreads / 32)];
  const int vecs = d / V;
  const int t = threadIdx.x % TPR, grp = threadIdx.x / TPR;
  const int step = gridDim.x * G;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* gv = reinterpret_cast<const uint4*>(dy);
  uint4* dxv = reinterpret_cast<uint4*>(dx);
  for (int i = threadIdx.x; i < d / 4; i += kThreads)
    ws[i] = __ldg(reinterpret_cast<const float4*>(w) + i);
  __syncthreads();

  float acc[CPT][V];
#pragma unroll
  for (int i = 0; i < CPT; ++i)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[i][e] = 0.f;

  int row = blockIdx.x * G + grp;
  uint4 cx[CPT], cg[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) cx[i] = cg[i] = make_uint4(0, 0, 0, 0);
  for (int it = 0; row < rows; ++it, row += step) {
    load_row<CPT, TPR>(cx, xv, row, rows, vecs, t);
    load_row<CPT, TPR>(cg, gv, row, rows, vecs, t);
    float s[2] = {0.f, 0.f};  // sum(x^2), sum(dy*w*x)
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = t + i * TPR;
      if (c < vecs) {
        float xf[V], gf[V], wf[V];
        unpack<T>(cx[i], xf);
        unpack<T>(cg[i], gf);
        load4<V>(wf, ws + c * (V / 4));
#pragma unroll
        for (int e = 0; e < V; ++e) {
          s[0] = fmaf(xf[e], xf[e], s[0]);
          s[1] = fmaf(gf[e] * wf[e], xf[e], s[1]);
        }
      }
    }
    group_sum<TPR>(s, red[it & 1] + grp * 2 * (TPR / 32), grp);
    const float r = rsqrtf(s[0] / static_cast<float>(d) + eps);
    const float coef = (r * r * r) * s[1] / static_cast<float>(d);
    const size_t base = static_cast<size_t>(row) * vecs;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = t + i * TPR;
      if (c < vecs) {
        float xf[V], gf[V], wf[V], o[V];
        unpack<T>(cx[i], xf);
        unpack<T>(cg[i], gf);
        load4<V>(wf, ws + c * (V / 4));
#pragma unroll
        for (int e = 0; e < V; ++e) {
          o[e] = r * (gf[e] * wf[e]) - coef * xf[e];
          acc[i][e] += (gf[e] * xf[e]) * r;
        }
        dxv[base + c] = pack<T>(o);
      }
    }
  }

  // the block's partial: its row groups' registers added in group order
  const int q4 = d / 4;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = t + i * TPR;
    if (c < vecs)
#pragma unroll
      for (int e = 0; e < V; e += 4)
        accs[grp * q4 + (c * V + e) / 4] =
            make_float4(acc[i][e], acc[i][e + 1], acc[i][e + 2], acc[i][e + 3]);
  }
  __syncthreads();
  float4* prow = reinterpret_cast<float4*>(part + static_cast<size_t>(blockIdx.x) * d);
  for (int q = threadIdx.x; q < q4; q += kThreads) {
    float4 a = accs[q];
#pragma unroll
    for (int g = 1; g < G; ++g) {
      const float4 v = accs[g * q4 + q];
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
    prow[q] = a;
  }
}

// The general route: blocks stride over rows; column c's dw is owned by
// thread c % blockDim in shared memory, rows in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_norm_bwd_any(const T* __restrict__ x, const float* __restrict__ w,
                 const T* __restrict__ dy, T* __restrict__ dx,
                 float* __restrict__ part, int rows, int d, float eps) {
  extern __shared__ float4 smem4[];
  float* dw_acc = reinterpret_cast<float*>(smem4);  // [d]
  for (int c = threadIdx.x; c < d; c += blockDim.x) dw_acc[c] = 0.f;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t base = static_cast<size_t>(row) * d;
    float ss = 0.f, st = 0.f;
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      const float xf = to_f<T>(x[base + c]);
      const float t = to_f<T>(dy[base + c]) * w[c];
      ss = fmaf(xf, xf, ss);
      st = fmaf(t, xf, st);
    }
    ss = block_sum(ss);
    st = block_sum(st);
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    const float coef = (r * r * r) * st / static_cast<float>(d);
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      const float xf = to_f<T>(x[base + c]);
      const float g = to_f<T>(dy[base + c]);
      dx[base + c] = from_f<T>(r * (g * w[c]) - coef * xf);
      dw_acc[c] += (g * xf) * r;
    }
  }
  float* prow = part + static_cast<size_t>(blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) prow[c] = dw_acc[c];
}

// ------------------------------------------------------------------- host
// The register route's row group (32 or 128 threads), or 0 for the general
// route.
template <typename T>
int route(int d, bool aligned) {
  constexpr int V = 16 / sizeof(T);
  if (!aligned || d % V != 0) return 0;
  const int vecs = d / V;
  return vecs <= kWarpVecs ? 32 : vecs <= kGroupVecs ? 128 : 0;
}

// vectors a thread holds: 2, 4, 6 or 8 (the instantiations)
int cpt_for(int vecs, int tpr) {
  const int c = (vecs + tpr - 1) / tpr;
  return c <= 2 ? 2 : (c + 1) & ~1;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename Kern>
int occupancy(Kern kern, size_t smem) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kThreads, smem) !=
          cudaSuccess || n <= 0)
    n = 1;
  return n;
}

template <typename T, int CPT, int TPR, typename TO>
int fwd_reg(const T* x, const float* w, TO* y, int rows, int d, float eps,
            cudaStream_t s) {
  auto kern = rms_norm_fwd_reg<T, CPT, TPR, TO>;
  static int occ = 0;
  if (occ == 0) occ = occupancy(kern, 0);
  constexpr int G = kThreads / TPR;
  const long long need = (static_cast<long long>(rows) + G - 1) / G;
  const long long cap = static_cast<long long>(hopper::sm_count()) * occ;
  const int grid = static_cast<int>(need < cap ? need : cap);
  kern<<<grid, kThreads, 0, s>>>(x, w, y, rows, d, eps);
  PTT_RETURN_LAUNCH_ERROR();
}

template <typename T, int TPR, typename TO>
int fwd_cpt(const T* x, const float* w, TO* y, int rows, int d, float eps,
            cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  switch (cpt_for(d / V, TPR)) {
    case 2: return fwd_reg<T, 2, TPR>(x, w, y, rows, d, eps, s);
    case 4: return fwd_reg<T, 4, TPR>(x, w, y, rows, d, eps, s);
    case 6: return fwd_reg<T, 6, TPR>(x, w, y, rows, d, eps, s);
    case 8: return fwd_reg<T, 8, TPR>(x, w, y, rows, d, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename TO = T>
int launch_fwd(const void* xp, const void* wp, void* yp, int rows, int d,
               float eps, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xp);
  const float* w = static_cast<const float*>(wp);
  TO* y = static_cast<TO*>(yp);
  switch (route<T>(d, aligned16(x) && aligned16(y) && aligned16(w))) {
    case 32: return fwd_cpt<T, 32>(x, w, y, rows, d, eps, s);
    case 128: return fwd_cpt<T, 128>(x, w, y, rows, d, eps, s);
    default: break;
  }
  if (d % V == 0 && aligned16(x) && aligned16(y))
    rms_norm_fwd_any<T, true, TO><<<rows, kThreads, 0, s>>>(x, w, y, d, eps);
  else
    rms_norm_fwd_any<T, false, TO><<<rows, kThreads, 0, s>>>(x, w, y, d, eps);
  PTT_RETURN_LAUNCH_ERROR();
}

struct BwdArgs {
  const void* x;
  const float* w;
  const void* dy;
  void* dx;
  float* part;
  int part_rows;
  float* dw;
  int rows, d;
  float eps;
  cudaStream_t s;
};

// What launch_bwd_grid keeps for one kernel: its occupancy at a size.
struct KernCache {
  size_t occ_smem = 0;
  int occ = 0;
};

// Launch `kern` over `need` blocks' worth of rows, capped at the blocks that
// fit on the card (at most kBwdBlocksPerSm an SM), after checking that the
// partials hold that grid, then the sum of the partials into dw. `kc` is
// the kernel's own cache.
template <typename T, typename Kern>
int launch_bwd_grid(Kern kern, KernCache& kc, long long need, size_t smem,
                    const BwdArgs& a) {
  if (smem > static_cast<size_t>(kSmemMax)) return static_cast<int>(cudaErrorInvalidValue);
  // set on every call (it is per device), and below 48 KB too: the static
  // shared memory counts against the same limit
  if (smem >= 32 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (kc.occ == 0 || kc.occ_smem != smem) {
    const int occ = occupancy(kern, smem);
    kc.occ = occ < kBwdBlocksPerSm ? occ : kBwdBlocksPerSm;
    kc.occ_smem = smem;
  }
  const long long cap = static_cast<long long>(hopper::sm_count()) * kc.occ;
  const int grid = static_cast<int>(need < cap ? need : cap);
  if (grid > a.part_rows) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<grid, kThreads, smem, a.s>>>(
      static_cast<const T*>(a.x), a.w, static_cast<const T*>(a.dy),
      static_cast<T*>(a.dx), a.part, a.rows, a.d, a.eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (a.d % 4 == 0)  // the partials' rows are 16-byte aligned
    rms_norm_bwd_dw<float4><<<(a.d / 4 + 7) / 8, kThreads, 0, a.s>>>(a.part, grid, a.d, a.dw);
  else
    rms_norm_bwd_dw<float><<<(a.d + 31) / 32, kThreads, 0, a.s>>>(a.part, grid, a.d, a.dw);
  PTT_RETURN_LAUNCH_ERROR();
}

template <typename T, int CPT, int TPR>
int bwd_reg(const BwdArgs& a) {
  constexpr int G = kThreads / TPR;
  static KernCache kc;
  const size_t smem = static_cast<size_t>(1 + G) * a.d * sizeof(float);
  return launch_bwd_grid<T>(rms_norm_bwd_reg<T, CPT, TPR>, kc,
                            (static_cast<long long>(a.rows) + G - 1) / G, smem, a);
}

template <typename T, int TPR>
int bwd_cpt(const BwdArgs& a) {
  constexpr int V = 16 / sizeof(T);
  switch (cpt_for(a.d / V, TPR)) {
    case 2: return bwd_reg<T, 2, TPR>(a);
    case 4: return bwd_reg<T, 4, TPR>(a);
    case 6: return bwd_reg<T, 6, TPR>(a);
    case 8: return bwd_reg<T, 8, TPR>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_bwd(const BwdArgs& a) {
  const bool aligned = aligned16(a.x) && aligned16(a.dy) && aligned16(a.dx) &&
                       aligned16(a.w) && aligned16(a.part) && aligned16(a.dw);
  switch (route<T>(a.d, aligned)) {
    case 32: return bwd_cpt<T, 32>(a);
    case 128: return bwd_cpt<T, 128>(a);
    default: {
      static KernCache kc;
      return launch_bwd_grid<T>(rms_norm_bwd_any<T>, kc, a.rows,
                                static_cast<size_t>(a.d) * sizeof(float), a);
    }
  }
}

}  // namespace

// x, y: [rows, d] contiguous, dtype code `dtype`; w: [d] fp32.
extern "C" int ptt_rms_norm_fwd(const void* x, const void* w, void* y, int rows,
                                int d, float eps, int dtype, void* stream) {
  if (rows == 0 || d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == PTT_F32) return launch_fwd<float>(x, w, y, rows, d, eps, s);
  if (dtype == PTT_BF16) return launch_fwd<__nv_bfloat16>(x, w, y, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x: [rows, d] fp32, y: [rows, d] bf16, w: [d] fp32, all contiguous: #5's
// forward with its output rounded to bf16 (the fused decoder block's RMSNorm
// of its fp32 residual, csrc/fused_block.cu).
int rms_norm_fwd_f32_bf16(const void* x, const void* w, void* y, int rows, int d,
                          float eps, cudaStream_t s) {
  if (rows == 0 || d == 0) return 0;
  return launch_fwd<float, __nv_bfloat16>(x, w, y, rows, d, eps, s);
}

// x, dy, dx: [rows, d] contiguous, dtype code `dtype`; w, dw: [d] fp32;
// part: [part_rows, d] fp32 scratch (16-byte aligned), part_rows at least
// the grid's cap, SMs x kBwdBlocksPerSm (ops/kernels/rms_norm.py:_partials).
extern "C" int ptt_rms_norm_bwd(const void* x, const void* w, const void* dy,
                                void* dx, void* part, int part_rows, void* dw,
                                int rows, int d, float eps, int dtype,
                                void* stream) {
  if (d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0)  // no rows: dw is 0, as the sum over none
    return static_cast<int>(cudaMemsetAsync(dw, 0, static_cast<size_t>(d) * sizeof(float), s));
  const BwdArgs a{x, static_cast<const float*>(w), dy, dx, static_cast<float*>(part),
                  part_rows, static_cast<float*>(dw), rows, d, eps, s};
  if (dtype == PTT_F32) return launch_bwd<float>(a);
  if (dtype == PTT_BF16) return launch_bwd<__nv_bfloat16>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
