// Ragged paged attention over quantized KV pages (#10): the C entry and the
// fp32-q launches. The kernels, their design and launchers are in quant.cuh;
// quant_bf16.cu holds the bf16-q launches.
#include "quant.cuh"

// q: [T, Hq, D] fp32 or bf16; k_cache/v_cache: [rows, Hkv, D] int8 or fp8 e4m3
// (one layer, flat token-major); k_scale/v_scale: [rows, Hkv] fp32; tables:
// [S, width] int32; rows/valids: [T] int32; out like q.
extern "C" int ptt_ragged_paged_attn_quant(
    const void* q, const void* kc, const void* vc, const void* k_scale,
    const void* v_scale, const void* tables, const void* rows, const void* valids,
    void* out, int T, int Hq, int Hkv, int D, int bs, int width, float scale,
    int q_dtype, int page_dtype, void* stream) {
  if (T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tb = static_cast<const int*>(tables);
  const int* rw = static_cast<const int*>(rows);
  const int* vl = static_cast<const int*>(valids);
  if (q_dtype == PTT_F32)
    return dispatch_page<float>(page_dtype, q, kc, vc, ks, vs, tb, rw, vl, out, T,
                                Hq, Hkv, D, bs, width, scale, s);
  if (q_dtype == PTT_BF16)
    return ptt_quant_dispatch_bf16(page_dtype, q, kc, vc, ks, vs, tb, rw, vl, out, T, Hq,
                                   Hkv, D, bs, width, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
