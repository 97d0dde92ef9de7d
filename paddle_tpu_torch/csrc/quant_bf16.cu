// Ragged paged attention over quantized KV pages (#10): the bf16-q launches
// (quant.cuh), compiled apart from quant.cu's fp32 ones.
#include "quant.cuh"

int ptt_quant_dispatch_bf16(int page_dtype, const void* q, const void* kc, const void* vc,
                            const float* ks, const float* vs, const int* tables,
                            const int* rows, const int* valids, void* out, int T, int Hq,
                            int Hkv, int D, int bs, int width, float scale, cudaStream_t s) {
  return dispatch_page<__nv_bfloat16>(page_dtype, q, kc, vc, ks, vs, tables, rows, valids,
                                      out, T, Hq, Hkv, D, bs, width, scale, s);
}
