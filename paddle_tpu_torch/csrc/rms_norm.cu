// RMSNorm forward for Hopper.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/rms_norm.py:_fwd_kernel
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
