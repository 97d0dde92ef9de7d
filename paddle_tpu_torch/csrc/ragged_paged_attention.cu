// Ragged paged attention for Hopper: mixed prefill/decode attention of packed
// query tokens over a paged KV cache of bf16 or fp32 pages, addressed through
// a block table.
//
// Replaces the TPU kernel
// paddle_tpu/ops/pallas/ragged_paged_attention.py:_kernel (grid and scalar
// prefetch in ragged_paged_attention, :105). Token t reads block-table row
// rows[t] and sees the first valids[t] cached positions; valids[t] == 0 (a
// pad token) gives exactly 0. Scores, softmax and the PV sum run in fp32
// whatever the storage types (the compiled decode step feeds fp32 q over
// bf16 pages); the output takes q's dtype.
//
// The kernel is the split-context family of csrc/ragged.cuh (its notes give
// the bound and the design) with bf16 or fp32 pages as its page policy; this
// file instantiates it and dispatches on the dtypes and the head dim.
#include "ragged.cuh"

// q: [T, Hq, D]; k_cache/v_cache: [rows, Hkv, D] (one layer, flat token-major);
// tables: [S, width] int32; rows/valids: [T] int32; out like q, followed in
// the same allocation (256-byte aligned) by the fp32 partials of tokens whose
// keys span several splits when width * bs > ragged::kSplitKeys (the wrapper
// sizes it: T * Hq * nsp * (D + 2) floats, nsp the splits of width * bs keys).
extern "C" int ptt_ragged_paged_attn(const void* q, const void* kc, const void* vc,
                                     const void* tables, const void* rows,
                                     const void* valids, void* out, int T, int Hq,
                                     int Hkv, int D, int bs, int width, float scale,
                                     int q_dtype, int kv_dtype, void* stream) {
  if (T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ragged::Args a{};
  a.q = q;
  a.kc = static_cast<const uint8_t*>(kc);
  a.vc = static_cast<const uint8_t*>(vc);
  a.tables = static_cast<const int*>(tables);
  a.rows = static_cast<const int*>(rows);
  a.valids = static_cast<const int*>(valids);
  a.out = out;
  a.T = T;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.d = D;
  a.bs = bs;
  a.width = width;
  a.scale = scale;
  if (q_dtype == PTT_F32 && kv_dtype == PTT_BF16)
    return ragged::dispatch_d<float, ragged::PageBF16>(a, s);
  if (q_dtype == PTT_F32 && kv_dtype == PTT_F32)
    return ragged::dispatch_d<float, ragged::PageF32>(a, s);
  if (q_dtype == PTT_BF16 && kv_dtype == PTT_BF16)
    return ragged::dispatch_d<__nv_bfloat16, ragged::PageBF16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

