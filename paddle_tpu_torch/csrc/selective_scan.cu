// Chunked SSD selective scan for Hopper: the state-space mixer's prefill.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/selective_scan.py:_scan_kernel
// (grid (batch, heads, chunks) in _scan_pallas, :172). Per (batch, head) and
// per chunk of L positions, with cs = cumsum(la) over the chunk (fp32):
//
//   M      = (C . B^T) o exp(cs_t - cs_j) on j <= t, rounded to x's dtype
//   y      = M @ dtx + (C o exp(cs)) @ S
//   S'     = exp(cs_L) . S + (B o exp(cs_L - cs))^T @ dtx
//
// dtx = dt*x in x's dtype [b, lp, h, dh]; la = dt*A fp32 [b, h, lp]; B, C in
// x's dtype [b, lp, ds], one state group shared by every head. Outputs y
// [b, lp, h, dh] in x's dtype and the final state [b, h, ds, dh] fp32. The
// wrapper pads the tail with zeros (dtx, B, C) and zero log-decay, so the
// carry passes through the padding unchanged.
//
// Bound on the H100: at the serving prefill shape (fp32, dh 32, ds 16, L 128)
// the fp32 operations; at the training shape (bf16, dh 64, ds 64, L 256) the
// bytes of dtx and y. This kernel runs every product on the CUDA cores in
// fp32; moving M @ dtx and C . B^T onto the tensor cores is later work.
//
// Design: the TPU grid's sequential chunk axis becomes a loop inside one block
// per (batch, head) that keeps the fp32 state S (ds x dh) in shared memory, so
// there are no atomics and a second launch gives the same bits. The L x L
// decay matrix is never held whole (at L = 256 it is 256 KB of fp32, past the
// 227 KB a block may use): each output row of M depends only on its own row,
// so M is built and consumed kRows rows at a time. B and C sit in shared
// memory as fp32 rows padded by one word, so the threads that own M's columns
// read B conflict-free while C's row is a broadcast. Only exponents on the
// causal half are ever evaluated, where cs_t - cs_j <= 0.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;       // rows of M built at once
constexpr int kMaxChunk = 256;  // one thread per column of M

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// The dynamic shared memory layout, in bytes (ops/kernels/selective_scan.py
// repeats this sum to refuse a shape before launching).
__host__ __device__ inline size_t scan_smem_bytes(int L, int dh, int ds, int esize) {
  return 2 * align16(static_cast<size_t>(L) * (ds + 1) * 4)  // B, C (fp32)
         + align16(static_cast<size_t>(L) * dh * esize)      // dtx chunk
         + align16(static_cast<size_t>(ds) * dh * 4)         // S
         + align16(static_cast<size_t>(kRows) * L * 4)       // rows of M
         + 3 * align16(static_cast<size_t>(L) * 4);          // cs, exp(cs_L-cs), exp(cs)
}

template <typename T>
__global__ void __launch_bounds__(kThreads) selective_scan_kernel(
    const T* __restrict__ dtx, const float* __restrict__ la,
    const T* __restrict__ Bg, const T* __restrict__ Cg, T* __restrict__ y,
    float* __restrict__ state, int lp, int H, int dh, int ds, int L) {
  extern __shared__ uint4 smem_raw[];
  const int hh = blockIdx.x, bb = blockIdx.y, tid = threadIdx.x;
  const int dsp = ds + 1;
  char* p = reinterpret_cast<char*>(smem_raw);
  float* Bs = reinterpret_cast<float*>(p);  // [L][ds+1]
  p += align16(static_cast<size_t>(L) * dsp * 4);
  float* Cs = reinterpret_cast<float*>(p);  // [L][ds+1]
  p += align16(static_cast<size_t>(L) * dsp * 4);
  T* Xs = reinterpret_cast<T*>(p);  // [L][dh]
  p += align16(static_cast<size_t>(L) * dh * sizeof(T));
  float* Ss = reinterpret_cast<float*>(p);  // [ds][dh]
  p += align16(static_cast<size_t>(ds) * dh * 4);
  float* Ms = reinterpret_cast<float*>(p);  // [kRows][L]
  p += align16(static_cast<size_t>(kRows) * L * 4);
  float* cs = reinterpret_cast<float*>(p);  // [L]
  p += align16(static_cast<size_t>(L) * 4);
  float* eb = reinterpret_cast<float*>(p);  // exp(cs_L - cs) [L]
  p += align16(static_cast<size_t>(L) * 4);
  float* ec = reinterpret_cast<float*>(p);  // exp(cs) [L]

  for (int i = tid; i < ds * dh; i += kThreads) Ss[i] = 0.f;

  const size_t xrow = static_cast<size_t>(H) * dh;  // dtx/y elements per position
  const size_t xcol = static_cast<size_t>(hh) * dh;
  const float* la_bh = la + (static_cast<size_t>(bb) * H + hh) * lp;
  const int nc = lp / L;
  for (int c = 0; c < nc; ++c) {
    const size_t p0 = static_cast<size_t>(bb) * lp + static_cast<size_t>(c) * L;
    __syncthreads();  // the previous chunk's reads and state update are done
    for (int i = tid; i < L * ds; i += kThreads) {
      const int r = i / ds, k = i % ds;
      const size_t g = (p0 + r) * ds + k;
      Bs[r * dsp + k] = to_f<T>(Bg[g]);
      Cs[r * dsp + k] = to_f<T>(Cg[g]);
    }
    for (int i = tid; i < L * dh; i += kThreads) {
      const int r = i / dh, col = i % dh;
      Xs[i] = dtx[(p0 + r) * xrow + xcol + col];
    }
    if (tid < L) cs[tid] = la_bh[static_cast<size_t>(c) * L + tid];
    __syncthreads();
    if (tid == 0) {  // the chunk's cumulative log-decay, in order
      float run = 0.f;
      for (int r = 0; r < L; ++r) {
        run += cs[r];
        cs[r] = run;
      }
    }
    __syncthreads();
    const float total = cs[L - 1];
    if (tid < L) {
      eb[tid] = expf(total - cs[tid]);
      ec[tid] = expf(cs[tid]);
    }
    __syncthreads();

    for (int r0 = 0; r0 < L; r0 += kRows) {
      // rows r0.. of M: thread j owns column j
      if (tid < L) {
        const int j = tid;
        float acc[kRows];
#pragma unroll
        for (int t = 0; t < kRows; ++t) acc[t] = 0.f;
        if (j < r0 + kRows) {  // later columns are masked in every row here
          for (int k = 0; k < ds; ++k) {
            const float bj = Bs[j * dsp + k];
#pragma unroll
            for (int t = 0; t < kRows; ++t) acc[t] = fmaf(Cs[(r0 + t) * dsp + k], bj, acc[t]);
          }
        }
#pragma unroll
        for (int t = 0; t < kRows; ++t) {
          const int row = r0 + t;
          Ms[t * L + j] = j <= row ? round_through<T>(acc[t] * expf(cs[row] - cs[j])) : 0.f;
        }
      }
      __syncthreads();
      // y for those rows: the chunk's own part through M, the carry through S
      for (int i = tid; i < kRows * dh; i += kThreads) {
        const int t = i / dh, col = i % dh, row = r0 + t;
        float intra = 0.f;
        for (int j = 0; j <= row; ++j)
          intra = fmaf(Ms[t * L + j], to_f<T>(Xs[j * dh + col]), intra);
        float inter = 0.f;
        const float e = ec[row];
        for (int k = 0; k < ds; ++k) inter = fmaf(Cs[row * dsp + k] * e, Ss[k * dh + col], inter);
        y[(p0 + row) * xrow + xcol + col] = from_f<T>(intra + inter);
      }
      __syncthreads();  // Ms is rebuilt for the next rows; S is read above
    }

    // the carry to the next chunk; each thread owns its entries of S
    const float decay = expf(total);
    for (int i = tid; i < ds * dh; i += kThreads) {
      const int k = i / dh, col = i % dh;
      float acc = 0.f;
      for (int j = 0; j < L; ++j)
        acc = fmaf(Bs[j * dsp + k] * eb[j], to_f<T>(Xs[j * dh + col]), acc);
      Ss[i] = decay * Ss[i] + acc;
    }
  }
  __syncthreads();
  float* out = state + (static_cast<size_t>(bb) * H + hh) * ds * dh;
  for (int i = tid; i < ds * dh; i += kThreads) out[i] = Ss[i];
}

template <typename T>
int launch(const void* dtx, const void* la, const void* B, const void* C, void* y,
           void* state, int batch, int lp, int H, int dh, int ds, int L,
           cudaStream_t stream) {
  const size_t bytes = scan_smem_bytes(L, dh, ds, sizeof(T));
  auto kern = selective_scan_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(H, batch);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(dtx), static_cast<const float*>(la),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<T*>(y),
      static_cast<float*>(state), lp, H, dh, ds, L);
  PTT_RETURN_LAUNCH_ERROR();
}

}  // namespace

// dtx: [batch, lp, H, dh] (dtype); la: [batch, H, lp] fp32; B, C: [batch, lp,
// ds] (dtype); y like dtx; state: [batch, H, ds, dh] fp32. lp a multiple of L.
extern "C" int ptt_selective_scan(const void* dtx, const void* la, const void* B,
                                  const void* C, void* y, void* state, int batch,
                                  int lp, int H, int dh, int ds, int L, int dtype,
                                  void* stream) {
  if (L < kRows || L > kMaxChunk || L % kRows != 0 || lp % L != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || H == 0 || lp == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == PTT_F32)
    return launch<float>(dtx, la, B, C, y, state, batch, lp, H, dh, ds, L, s);
  if (dtype == PTT_BF16)
    return launch<__nv_bfloat16>(dtx, la, B, C, y, state, batch, lp, H, dh, ds, L, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
