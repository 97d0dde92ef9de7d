// Shared helpers for the port's Hopper kernels: dtype codes, bf16 <-> fp32
// conversion of 16-byte vectors, and warp / block reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

// dtype codes used across the C interface (see ops/kernels/_launch.py; the
// one-byte page types of quantized KV caches in ops/kernels/quant.py)
enum PttDtype { PTT_F32 = 0, PTT_BF16 = 1, PTT_I8 = 2, PTT_F8E4M3 = 3 };

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round-to-nearest-even, as torch and XLA cast
}

// fp32 value rounded through T (the reference casts p to V's dtype)
template <typename T> __device__ __forceinline__ float round_through(float v) {
  return to_f<T>(from_f<T>(v));
}

// A 16-byte vector of T unpacked into 16/sizeof(T) floats.
__device__ __forceinline__ void unpack16(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack16(const uint4& u, float* f, __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);           // low half: element 2i
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T> __device__ __forceinline__ void unpack(const uint4& u, float* f) {
  unpack16(u, f, T());
}

__device__ __forceinline__ uint4 pack16(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

__device__ __forceinline__ uint4 pack16(const float* f, __nv_bfloat16) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i]));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1]));
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T> __device__ __forceinline__ uint4 pack(const float* f) {
  return pack16(f, T());
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the whole block; every thread gets the result. blockDim.x must
// be a multiple of 32 and at most 1024.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // part[] may still be read by a previous call
  if (lane == 0) part[warp] = v;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  v = lane < nwarps ? part[lane] : 0.f;
  return warp_sum(v);
}

// The padded head dim that the CUDA-core attention kernels are instantiated
// at for a head dim d (a multiple of 16 up to 256; those kernels take the real
// d and mask the columns past it), or 0 where d is not one. Mirrored by
// ops/kernels/_launch.py:head_dim_bucket.
inline int head_dim_bucket(int d) {
  if (d < 16 || d > 256 || d % 16 != 0) return 0;
  return d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

// Each C entry returns the launch's error (0 = cudaSuccess).
#define PTT_RETURN_LAUNCH_ERROR() return static_cast<int>(cudaGetLastError())
