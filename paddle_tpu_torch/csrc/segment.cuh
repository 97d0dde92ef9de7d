// The attention masks of the flash family, shared by csrc/flash_attention.cu
// (#1, and #3's bf16 route), csrc/flash_attention_bwd.cu (#2, and #4's bf16
// route) and csrc/flash_attention_seg.cu (the CUDA-core kernels every other
// call of #1-#4 takes: the edge route).
//
// A descriptor seg = [q_off0, q_off1, q_split, k_off0, k_off1, k_split] maps
// local row i to the global position g(i) = i < split ? off0 + i
// : off1 + (i - split) (columns the same), and a pair is visible iff
// g_q(row) >= g_k(col). The wrapper checks off1 >= off0 + split, so both
// maps are monotone: each row sees a prefix of the columns and each column
// is seen by a suffix of the rows. Dense attention is a descriptor too:
// top-left causal is g(i) = i on both sides, and full attention starts the
// rows at Sk - 1, so every row sees every column (dense_rows below).
#pragma once

#include <cuda_runtime.h>

// local index -> global position; monotone when off1 >= off0 + split
struct SegMap {
  int off0, off1, split;
  __host__ __device__ __forceinline__ int operator()(int i) const {
    return i < split ? off0 + i : off1 + (i - split);
  }
  // how many of the local indices 0 .. n-1 sit at global positions <= pos:
  // under a monotone map, the length of the prefix they form
  __device__ __forceinline__ int count_le(int pos, int n) const {
    const int a = min(split, n);
    return min(max(pos - off0 + 1, 0), a) + min(max(pos - off1 + 1, 0), n - a);
  }
};

// The descriptors of dense attention over Sq rows and Sk columns.
inline SegMap dense_cols(int Sk) { return SegMap{0, Sk, Sk}; }
inline SegMap dense_rows(int Sq, int Sk, int causal) {
  const int off0 = causal ? 0 : (Sk > 0 ? Sk - 1 : 0);
  return SegMap{off0, off0 + Sq, Sq};
}

// ------------------------------------------------- the wgmma kernels' masks
// Compile-time policies of the wgmma kernels (#1/#3 forward, #2/#4 dQ and
// dK/dV). Positions of rows and columns past Sq or Sk follow the maps: those
// rows are never stored, and queries past Sq carry p = 0 in the dK/dV pass.
struct DenseMask {  // #1, #2: causal (col <= row) or full
  int causal;
  // keys a block of the query rows [q0, q0 + bm) walks
  __device__ __forceinline__ int keys(int q0, int bm, int Sq, int Sk) const {
    return causal ? min(Sk, q0 + bm) : Sk;
  }
  // of n_tiles key tiles, those with a key that a row up to `last` sees
  __device__ __forceinline__ int live_tiles(int n_tiles, int last, int bn, int Sq, int Sk) const {
    return causal ? min(n_tiles, (last + bn) / bn) : n_tiles;
  }
  __device__ __forceinline__ int qpos(int row) const { return row; }
  __device__ __forceinline__ int kpos(int col) const { return col; }
  // the key tile [k0, k0 + bn) needs a mask for the rows from `first`
  __device__ __forceinline__ bool dq_edge(int k0, int bn, int first, int Sk) const {
    return k0 + bn > Sk || (causal && k0 + bn - 1 > first);
  }
  // column col is hidden from the row at position pos
  __device__ __forceinline__ bool dq_hidden(int pos, int col, int Sk) const {
    return col >= Sk || (causal && col > pos);
  }
  // the first query tile of bq rows that sees key k0
  __device__ __forceinline__ int first_q_tile(int k0, int bq, int Sq) const {
    return causal ? k0 / bq : 0;
  }
  // no query of the tile [q0, q0 + bq) sees key kw, nor any later key
  __device__ __forceinline__ bool q_tile_dead(int q0, int bq, int kw, int Sq) const {
    return causal && q0 + bq - 1 < kw;
  }
  // the keys [kw, kw + 64) against the queries from q0 need a mask
  __device__ __forceinline__ bool dkv_edge(int kw, int q0) const { return causal && kw + 63 > q0; }
  // the key at position kp is hidden from query col
  __device__ __forceinline__ bool dkv_hidden(int kp, int col) const { return kp > col; }
};

struct SegMask {  // #3, #4: g_q(row) >= g_k(col) through two monotone maps
  SegMap gq, gk;
  __device__ __forceinline__ int keys(int q0, int bm, int Sq, int Sk) const {
    return gk.count_le(gq(min(q0 + bm, Sq) - 1), Sk);
  }
  __device__ __forceinline__ int live_tiles(int n_tiles, int last, int bn, int Sq, int Sk) const {
    return min(n_tiles, (gk.count_le(gq(min(last, Sq - 1)), Sk) + bn - 1) / bn);
  }
  __device__ __forceinline__ int qpos(int row) const { return gq(row); }
  __device__ __forceinline__ int kpos(int col) const { return gk(col); }
  __device__ __forceinline__ bool dq_edge(int k0, int bn, int first, int Sk) const {
    return k0 + bn > Sk || gk(k0 + bn - 1) > gq(first);
  }
  __device__ __forceinline__ bool dq_hidden(int pos, int col, int Sk) const {
    return col >= Sk || gk(col) > pos;
  }
  __device__ __forceinline__ int first_q_tile(int k0, int bq, int Sq) const {
    return gq.count_le(gk(k0) - 1, Sq) / bq;  // the rows before key k0
  }
  __device__ __forceinline__ bool q_tile_dead(int q0, int bq, int kw, int Sq) const {
    return gq(min(q0 + bq, Sq) - 1) < gk(kw);
  }
  __device__ __forceinline__ bool dkv_edge(int kw, int q0) const { return gk(kw + 63) > gq(q0); }
  __device__ __forceinline__ bool dkv_hidden(int kp, int col) const { return kp > gq(col); }
};

// ------------------------------------------------------------ the routes
// Each returns a cudaError_t code. q, o, dout, dq: [B, Sq, Hq, D]; k, v, dk,
// dv: [B, Sk, Hkv, D]; lse and the scratch delta [B, Hq, Sq] fp32.

// #3's bf16 route (flash_attention.cu): #1's wgmma kernel under the segment
// mask. D 64 or 128, 16-byte-aligned bases.
int flash_fwd_seg_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int Sq, int Sk, int Hq, int Hkv, int D, SegMap gq, SegMap gk,
                        float scale, cudaStream_t stream);

// #4's bf16 route (flash_attention_bwd.cu): #2's wgmma dQ and dK/dV kernels
// under the segment mask. D 64 or 128, 16-byte-aligned bases.
int flash_bwd_seg_wgmma(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* delta, void* dq, void* dk,
                        void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int D, SegMap gq,
                        SegMap gk, float scale, cudaStream_t stream);

// The edge route of #1-#4 (flash_attention_seg.cu): the CUDA-core kernels
// under any descriptor, fp32 or bf16 (dtype a PttDtype code), any head dim
// D that is a multiple of 16 up to 256, any alignment of the element type.
int flash_fwd_edge(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Sq, int Sk, int Hq, int Hkv, int D, SegMap gq, SegMap gk, float scale,
                   int dtype, cudaStream_t stream);
int flash_bwd_edge(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int D, SegMap gq,
                   SegMap gk, float scale, int dtype, cudaStream_t stream);
