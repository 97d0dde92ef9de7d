// Paged decode attention for Hopper: one new query token per sequence over a
// paged KV cache addressed through a block table (the eager engine's decode).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py:_kernel
// (grid and scalar prefetch in paged_decode_attention, :106). Sequence b
// reads block-table row b and sees its first lens[b] cached positions;
// lens[b] <= 0 gives exactly 0. Scores, the online softmax and the PV sum run
// in fp32 whatever the storage types; the output takes q's dtype. GQA folds
// each query head onto its kv head.
//
// The function is #8's decode special case (rows = 0..B-1, valids = lens), so
// the kernel is the split-context family of csrc/ragged.cuh (its notes give the
// bound and the design) instantiated for decode only: token t reads table row
// t, every token is a tile of its own, and the plan has no multi-token tiles.
// A decode row's bits are those of the same row in #8's call (compiled and
// eager engines agree). This file dispatches on the dtypes and the head dim.
#include "ragged.cuh"

// q: [B, Hq, D]; k_cache/v_cache: [rows, Hkv, D] (one layer, flat token-major);
// tables: [B, max_blocks] int32; lens: [B] int32; out like q, followed in the
// same allocation by the split partials as for ptt_ragged_paged_attn (the
// wrapper sizes it with ragged_paged_attention.empty_out).
extern "C" int ptt_paged_decode_attn(const void* q, const void* kc, const void* vc,
                                     const void* tables, const void* lens, void* out,
                                     int B, int Hq, int Hkv, int D, int bs,
                                     int max_blocks, float scale, int q_dtype,
                                     int kv_dtype, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ragged::Args a{};
  a.q = q;
  a.kc = static_cast<const uint8_t*>(kc);
  a.vc = static_cast<const uint8_t*>(vc);
  a.tables = static_cast<const int*>(tables);
  a.valids = static_cast<const int*>(lens);
  a.out = out;
  a.T = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.d = D;
  a.bs = bs;
  a.width = max_blocks;
  a.scale = scale;
  if (q_dtype == PTT_F32 && kv_dtype == PTT_BF16)
    return ragged::dispatch_d<float, ragged::PageBF16, true>(a, s);
  if (q_dtype == PTT_F32 && kv_dtype == PTT_F32)
    return ragged::dispatch_d<float, ragged::PageF32, true>(a, s);
  if (q_dtype == PTT_BF16 && kv_dtype == PTT_BF16)
    return ragged::dispatch_d<__nv_bfloat16, ragged::PageBF16, true>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
