// RMSNorm forward and backward for Hopper.
//
// Forward replaces the TPU kernel paddle_tpu/ops/pallas/rms_norm.py:_fwd_kernel
// (called by _fwd, rms_norm.py:64): y = x * rsqrt(sum(x^2)/d + eps) * w per
// row, statistics in fp32, y in x's dtype, w fp32.
//
// Bound on the H100: bytes. Each row is read and written once and w is
// tiny, so the least time is (rows*d*(in+out bytes)) / 3.35 TB/s; the
// arithmetic is ~4 flops per element, far below the card's rate.
//
// Design: one block per row (the TPU kernel's row-block grid, but the
// blocks run in parallel on 132 SMs instead of in order on one core).
// Threads stride the row with 16-byte loads when the row allows it, sum the
// squares in fp32, reduce across the block with warp shuffles, then make a
// second pass over the row — it is still in L1/L2 after the first, so device
// memory sees one read. The TPU version padded d to 128 lanes and divided by
// the true width; here no padding exists and the divisor is d itself.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
rms_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    T* __restrict__ y, int d, float eps) {
  constexpr int V = 16 / sizeof(T);
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;

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
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = threadIdx.x; i < d / V; i += blockDim.x) {
      float f[V];
      unpack<T>(xv[i], f);
#pragma unroll
      for (int e = 0; e < V; ++e) f[e] = f[e] * r * w[i * V + e];
      yv[i] = pack<T>(f);
    }
  } else {
    for (int c = threadIdx.x; c < d; c += blockDim.x)
      yr[c] = from_f<T>(to_f<T>(xr[c]) * r * w[c]);
  }
}

template <typename T>
void launch(const void* x, const void* w, void* y, int rows, int d, float eps,
            cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  const float* wt = static_cast<const float*>(w);
  T* yt = static_cast<T*>(y);
  if (vec)
    rms_norm_fwd_kernel<T, true><<<rows, kThreads, 0, stream>>>(xt, wt, yt, d, eps);
  else
    rms_norm_fwd_kernel<T, false><<<rows, kThreads, 0, stream>>>(xt, wt, yt, d, eps);
}

}  // namespace

// x, y: [rows, d] contiguous, dtype code `dtype`; w: [d] fp32.
extern "C" int ptt_rms_norm_fwd(const void* x, const void* w, void* y, int rows,
                                int d, float eps, int dtype, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == PTT_F32)
    launch<float>(x, w, y, rows, d, eps, s);
  else if (dtype == PTT_BF16)
    launch<__nv_bfloat16>(x, w, y, rows, d, eps, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  PTT_RETURN_LAUNCH_ERROR();
}

// ---------------------------------------------------------------- backward
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/rms_norm.py:_bwd_kernel
// (called by _bwd, rms_norm.py:116). Same math: r is recomputed from x,
//   dx = r*(dy*w) - (r^3/d) * x * sum(dy*w*x)   in x's dtype,
//   dw = sum over rows of dy*x*r                in fp32.
//
// Bound on the H100: bytes (x and dy read once, dx written once, w and dw
// tiny; ~12 flops per element).
//
// Design: the TPU kernel carried dw in scratch across its sequential grid.
// Here blocks run in parallel, so dw is a two-stage reduction with no
// atomics, and runs repeat bitwise: stage 1 gives each block kBwdRows
// consecutive rows; per row it reduces sum(x^2) and sum(dy*w*x) across the
// block, writes dx, and adds dy*x*r into a per-block fp32 column
// accumulator in shared memory (each column owned by one thread, rows in
// order). The block stores that accumulator as its partial row. Stage 2
// sums the partials over blocks, in block order, one thread per column.

constexpr int kBwdRows = 32;  // rows per stage-1 block (the wrapper agrees)

template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const T* __restrict__ dy, T* __restrict__ dx,
                    float* __restrict__ dw_part, int rows, int d, float eps) {
  extern __shared__ float dw_acc[];  // [d]
  for (int c = threadIdx.x; c < d; c += blockDim.x) dw_acc[c] = 0.f;
  const int r0 = blockIdx.x * kBwdRows;
  const int r1 = min(rows, r0 + kBwdRows);
  for (int row = r0; row < r1; ++row) {
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
  float* part = dw_part + static_cast<size_t>(blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) part[c] = dw_acc[c];
}

__global__ void rms_norm_dw_reduce_kernel(const float* __restrict__ part,
                                          float* __restrict__ dw, int nblk,
                                          int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int b = 0; b < nblk; ++b) s += part[static_cast<size_t>(b) * d + c];
  dw[c] = s;
}

template <typename T>
int launch_bwd(const void* x, const void* w, const void* dy, void* dx,
               void* dw_part, void* dw, int rows, int d, float eps,
               cudaStream_t stream) {
  auto kern = rms_norm_bwd_kernel<T>;
  const size_t bytes = static_cast<size_t>(d) * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int nblk = (rows + kBwdRows - 1) / kBwdRows;
  kern<<<nblk, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(dw_part), rows, d, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rms_norm_dw_reduce_kernel<<<(d + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(dw_part), static_cast<float*>(dw), nblk, d);
  PTT_RETURN_LAUNCH_ERROR();
}

// x, dy, dx: [rows, d] contiguous, dtype code `dtype`; w, dw: [d] fp32;
// dw_part: [ceil(rows / 32), d] fp32 scratch.
extern "C" int ptt_rms_norm_bwd(const void* x, const void* w, const void* dy,
                                void* dx, void* dw_part, void* dw, int rows,
                                int d, float eps, int dtype, void* stream) {
  if (rows == 0 || d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == PTT_F32)
    return launch_bwd<float>(x, w, dy, dx, dw_part, dw, rows, d, eps, s);
  if (dtype == PTT_BF16)
    return launch_bwd<__nv_bfloat16>(x, w, dy, dx, dw_part, dw, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
