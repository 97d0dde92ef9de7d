// The segment-causal mask of the zig-zag ring's per-step problem, shared by
// csrc/flash_attention_seg.cu (#3, #4's fp32 and CUDA-core routes) and the
// segment instantiation of #2's wgmma kernels in csrc/flash_attention_bwd.cu
// (#4's bf16 route).
//
// A descriptor seg = [q_off0, q_off1, q_split, k_off0, k_off1, k_split] maps
// local row i to the global position g(i) = i < split ? off0 + i
// : off1 + (i - split) (columns the same), and a pair is visible iff
// g_q(row) >= g_k(col). The wrapper checks off1 >= off0 + split, so both
// maps are monotone: each row sees a prefix of the columns and each column
// is seen by a suffix of the rows.
#pragma once

#include <cuda_runtime.h>

// local index -> global position; monotone when off1 >= off0 + split
struct SegMap {
  int off0, off1, split;
  __device__ __forceinline__ int operator()(int i) const {
    return i < split ? off0 + i : off1 + (i - split);
  }
  // how many of the local indices 0 .. n-1 sit at global positions <= pos:
  // under a monotone map, the length of the prefix they form
  __device__ __forceinline__ int count_le(int pos, int n) const {
    const int a = min(split, n);
    return min(max(pos - off0 + 1, 0), a) + min(max(pos - off1 + 1, 0), n - a);
  }
};

// #4's bf16 route (flash_attention_bwd.cu): #2's wgmma dQ and dK/dV kernels
// under the segment mask. q, o, dout, dq: [B, Sq, Hq, D]; k, v, dk, dv:
// [B, Sk, Hkv, D]; lse and the scratch delta [B, Hq, Sq] fp32; bf16, D 64 or
// 128, 16-byte-aligned bases. Returns a cudaError_t code.
int flash_bwd_seg_wgmma(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* delta, void* dq, void* dk,
                        void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int D, SegMap gq,
                        SegMap gk, float scale, cudaStream_t stream);
