// Chunked SSD selective scan for Hopper: the state-space mixer's prefill, and
// (ptt_selective_scan_bwd, below the forward) its gradient for training.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/selective_scan.py:_scan_kernel
// (grid (batch, heads, chunks) in _scan_pallas, :172). Per (batch, head) and
// per chunk of L positions, with cs = cumsum(la) over the chunk (fp32):
//
//   M      = (C . B^T) o exp(cs_t - cs_j) on j <= t, rounded to x's dtype
//   y      = M @ dtx + (C o exp(cs)) @ S,  rounded to x's dtype once
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
// bytes of dtx and y.
//
// Design: the TPU grid's sequential chunk axis is the only thing that does
// not parallelise, and only the carried state needs it. So the scan is three
// launches, with no atomics (a second call gives the same bits):
//   1. scan_chunk_state (grid: chunks x batch x head groups): each chunk's
//      cumulative log-decay cs (one thread's in-order sum a head, written to
//      the cs scratch) and the chunk's own state contribution
//      (B o exp(cs_L - cs))^T @ dtx, as if it started from zero.
//   2. scan_state_pass (grid: batch x heads x ds x dh): the carry, in chunk
//      order, S = exp(cs_L) * S + contribution; each chunk's slot of the
//      state scratch is overwritten with the state entering it, and the
//      final state is written out.
//   3. scan_chunk_out: M, M @ dtx, the carried term (C o exp(cs)) @ S_prev
//      and y = intra + inter, rounded once. fp32: a block a 64-row tile of
//      a chunk for a group of heads, G = C . B^T formed once for them; bf16:
//      a block a (chunk, batch, head), G's pieces formed on the tensor cores
//      as each k-step needs them (an fp32 G shared by heads would take 32-66
//      KB a block and halve the warps an SM holds).
// Head groups split the heads so each launch has at least two blocks an SM
// (ops/kernels/selective_scan.py:launch_plan mirrors the rule and the
// shared-memory sums, and refuses a shape that does not fit). Every load
// into shared memory is a cp.async issued all at once, so a block waits
// one memory latency, not one a loop trip.
//
// fp32 (serve-ssm's prefill) runs on the CUDA cores in one fixed order for
// every element, that of the chunk-sequential form (a block walking a head's
// chunks), so its bits do not depend on the grid: the serial cumsum, G as an FMA chain over ds, M = G * exp(...) (no rounding in
// fp32), intra an FMA chain over j <= t in order, inter an FMA chain over ds
// of (C * exp(cs_t)) * S, y = intra + inter, the contribution an FMA chain
// over j of (B * exp(cs_L - cs_j)) * dtx, the carry decay * S + contribution.
// bf16 (training) runs G, M @ dtx and the contribution on the tensor cores
// (mma.sync m16n8k16, bf16 operands, fp32 accumulation): B, C, dtx and M
// are bf16 already (M rounded as the TPU kernel rounds it); the fp32 operands
// B o exp(cs_L - cs) and S_prev are split into two bf16 terms (hi + lo, ~16
// mantissa bits) against exact bf16 partners, and the carried term is
// (C @ S_prev) scaled by exp(cs_t) a row.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 256;
constexpr int kSmemLimit = 232448;
constexpr int kMinBlocks = 2 * 132;  // two blocks an SM

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }
__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }
// rows of y an fp32 chunk_out block takes
__host__ __device__ inline int row_tile(int L) { return L < 64 ? L : 64; }

// ---------------------------------------------------------- launch plan
// Shared-memory layouts, in bytes (ops/kernels/selective_scan.py repeats
// these sums). A chunk_out block needs the columns of M up to its last row
// (J); the sums take the largest, J = L.
__host__ __device__ inline size_t state_smem_f32(int L, int dh, int ds, int hg) {
  return align16(static_cast<size_t>(L) * (ds + 1) * 4)  // B (fp32)
         + align16(static_cast<size_t>(L) * ds * 4)      // B o exp(cs_L - cs)
         + align16(static_cast<size_t>(L) * dh * 4)      // dtx (fp32)
         + align16(static_cast<size_t>(hg) * L * 4)      // cs, a row a head
         + align16(static_cast<size_t>(L) * 4);          // exp(cs_L - cs)
}
__host__ __device__ inline size_t state_smem_bf16(int L, int dh, int ds, int hg) {
  return align16(static_cast<size_t>(L) * (round16(ds) + 8) * 2)  // B (bf16)
         + align16(static_cast<size_t>(hg) * L * 4)               // cs
         + align16(static_cast<size_t>(L) * 4)                    // exp(cs_L - cs)
         + align16(static_cast<size_t>(L) * (dh + 8) * 2);        // dtx
}
__host__ __device__ inline size_t out_smem_f32(int L, int dh, int ds) {
  const int R = row_tile(L);
  return align16(static_cast<size_t>(L) * (ds + 1) * 4)  // B
         + 2 * align16(static_cast<size_t>(ds) * R * 4)  // C^T, (C o exp(cs_t))^T
         + 2 * align16(static_cast<size_t>(L) * R * 4)   // G^T, M^T
         + align16(static_cast<size_t>(L) * dh * 4)      // dtx
         + align16(static_cast<size_t>(ds) * dh * 4)     // S_prev
         + align16(static_cast<size_t>(L) * 4)           // cs
         + align16(static_cast<size_t>(R) * 4);          // exp(cs_t)
}
__host__ __device__ inline size_t out_smem_bf16(int L, int dh, int ds) {
  const int d16 = round16(ds);
  return align16(static_cast<size_t>(L) * (d16 + 8) * 2)   // B (bf16)
         + align16(static_cast<size_t>(L) * (dh + 8) * 2)   // dtx
         + align16(static_cast<size_t>(d16) * (dh + 4) * 4)  // S_prev (fp32)
         + align16(static_cast<size_t>(L) * 4);             // cs
}

// The head groups a launch splits H into: the fewest (a divisor of H) that
// give `base` x groups >= kMinBlocks blocks, or H.
inline int head_groups(int H, long long base) {
  for (int g = 1; g <= H; ++g)
    if (H % g == 0 && base * g >= kMinBlocks) return g;
  return H;
}

// ------------------------------------------------------------- helpers
// The chunk's cumulative log-decay of one head, in order (run += la_r), in
// place in `cs` (shared, 16-byte aligned, the raw log-decays on entry) and
// into `gcs` (the scratch); L a multiple of 16.
__device__ __forceinline__ void chunk_cumsum(float* cs, float* gcs, int L) {
  float run = 0.f;
  for (int r0 = 0; r0 < L; r0 += 8) {
    const float4 a = *reinterpret_cast<const float4*>(cs + r0);
    const float4 b = *reinterpret_cast<const float4*>(cs + r0 + 4);
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      run += v[i];
      o[i] = run;
    }
    *reinterpret_cast<float4*>(cs + r0) = make_float4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<float4*>(cs + r0 + 4) = make_float4(o[4], o[5], o[6], o[7]);
#pragma unroll
    for (int i = 0; i < 8; ++i) gcs[r0 + i] = o[i];
  }
}

// mma.sync m16n8k16, fp32 += bf16 x bf16 (lane l of the warp, g = l / 4,
// q = l % 4: A a0 (row g, k 2q..2q+1), a1 (row g + 8), a2 (k + 8), a3 (both);
// B b0 (k 2q..2q+1, column g), b1 (k + 8); C c0/c1 (row g, columns 2q,
// 2q + 1), c2/c3 (row g + 8))
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}
__device__ __forceinline__ float2 unpack2(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}
// v = hi + lo with hi = bf16(v), lo = bf16(v - hi), for a pair of values
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack2(a, b);
  const float2 h = unpack2(hi);
  lo = pack2(a - h.x, b - h.y);
}

// B fragment of rows k0.. (the reduction), columns n0.. of a row-major bf16
// tile [k][n] (n contiguous; ld = 8 mod 16, rows 16-byte aligned), through
// ldmatrix's transpose.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[2], const __nv_bfloat16* B,
                                          int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const uint32_t addr = hopper::smem_u32(B + (k0 + (lane & 15)) * ld + n0);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(addr));
}

// B fragment of columns n0.., rows k0.. of a bf16 tile stored [n][k] (k
// contiguous, ld = 8 mod 16).
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[2], const __nv_bfloat16* B,
                                          int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const __nv_bfloat16* p = B + (n0 + g) * ld + k0 + 2 * q;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// n rows of `bytes` bytes (a multiple of 16) from global memory, `sstride`
// bytes apart, into shared memory rows `dstride` bytes apart, as 16-byte
// cp.async copies of the whole block (every copy in flight at once; the
// caller commits and waits).
__device__ __forceinline__ void copy_rows(void* dst, int dstride, const void* src,
                                          size_t sstride, int n, int bytes) {
  const int vecs = bytes / 16;
  for (int i = threadIdx.x; i < n * vecs; i += blockDim.x) {
    const int r = i / vecs, v = i % vecs;
    cp_async16(static_cast<char*>(dst) + r * dstride + v * 16,
               static_cast<const char*>(src) + r * sstride + v * 16);
  }
}

// ------------------------------------------------------- 1. chunk state
// fp32: one FMA chain over j in order per entry (k, col) of the state,
// acc = fmaf(B[j][k] * exp(cs_L - cs_j), dtx[j][col], acc).
// The products B * e are formed once a head (the same multiplies), and a
// thread runs the chains of two neighbouring columns together.
__global__ void __launch_bounds__(kThreads, 1) scan_chunk_state_f32(
    const float* __restrict__ dtx, const float* __restrict__ la,
    const float* __restrict__ Bg, float* __restrict__ gcs, float* __restrict__ st,
    int lp, int H, int dh, int ds, int L, int hg) {
  extern __shared__ uint4 smem_raw[];
  const int c = blockIdx.x, bb = blockIdx.y, h0 = blockIdx.z * hg, tid = threadIdx.x;
  const int nc = lp / L, dsp = ds + 1;
  char* p = reinterpret_cast<char*>(smem_raw);
  float* Bs = reinterpret_cast<float*>(p);  // [L][ds+1]
  p += align16(static_cast<size_t>(L) * dsp * 4);
  float* BE = reinterpret_cast<float*>(p);  // [L][ds]
  p += align16(static_cast<size_t>(L) * ds * 4);
  float* Xs = reinterpret_cast<float*>(p);  // [L][dh]
  p += align16(static_cast<size_t>(L) * dh * 4);
  float* cs = reinterpret_cast<float*>(p);  // [hg][L]
  p += align16(static_cast<size_t>(hg) * L * 4);
  float* eb = reinterpret_cast<float*>(p);  // exp(cs_L - cs) [L]

  const size_t p0 = static_cast<size_t>(bb) * lp + static_cast<size_t>(c) * L;
  for (int i = tid; i < L * ds; i += kThreads) {
    const int r = i / ds, k = i % ds;
    cp_async4(Bs + r * dsp + k, Bg + (p0 + r) * ds + k);
  }
  copy_rows(cs, L * 4, la + (static_cast<size_t>(bb) * H + h0) * lp + static_cast<size_t>(c) * L,
            static_cast<size_t>(lp) * 4, hg, L * 4);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  for (int g = tid; g < hg; g += kThreads)
    chunk_cumsum(cs + g * L,
                 gcs + (static_cast<size_t>(bb) * H + h0 + g) * lp + static_cast<size_t>(c) * L, L);
  const size_t xrow = static_cast<size_t>(H) * dh;
  const int half = dh / 2;
  for (int g = 0; g < hg; ++g) {
    const int hh = h0 + g;
    __syncthreads();  // cs ready; the previous head's reads done
    copy_rows(Xs, dh * 4, dtx + p0 * xrow + static_cast<size_t>(hh) * dh, xrow * 4, L, dh * 4);
    cp_async_commit();
    const float total = cs[g * L + L - 1];
    for (int r = tid; r < L; r += kThreads) eb[r] = expf(total - cs[g * L + r]);
    cp_async_wait_all();
    __syncthreads();
    for (int i = tid; i < L * ds; i += kThreads) {
      const int r = i / ds, k = i % ds;
      BE[i] = Bs[r * dsp + k] * eb[r];
    }
    __syncthreads();
    float* out = st + ((static_cast<size_t>(bb) * nc + c) * H + hh) * ds * dh;
    for (int i = tid; i < ds * half; i += kThreads) {
      const int k = i / half, c0 = 2 * (i % half);
      float a0 = 0.f, a1 = 0.f;
      for (int j = 0; j < L; ++j) {
        const float be = BE[j * ds + k];
        const float2 x = *reinterpret_cast<const float2*>(Xs + j * dh + c0);
        a0 = fmaf(be, x.x, a0);
        a1 = fmaf(be, x.y, a1);
      }
      *reinterpret_cast<float2*>(out + k * dh + c0) = make_float2(a0, a1);
    }
  }
}

// bf16: (B o e)^T @ dtx on the tensor cores, B o e formed in each A
// fragment from B's rows and split into hi + lo.
__global__ void __launch_bounds__(kThreads, 1) scan_chunk_state_bf16(
    const __nv_bfloat16* __restrict__ dtx, const float* __restrict__ la,
    const __nv_bfloat16* __restrict__ Bg, float* __restrict__ gcs,
    float* __restrict__ st, int lp, int H, int dh, int ds, int L, int hg) {
  extern __shared__ uint4 smem_raw[];
  const int c = blockIdx.x, bb = blockIdx.y, h0 = blockIdx.z * hg, tid = threadIdx.x;
  const int nc = lp / L, d16 = round16(ds), ldb = d16 + 8, ldx = dh + 8;
  const int warp = tid >> 5, lane = tid & 31, gr = lane >> 2, q = lane & 3;
  char* p = reinterpret_cast<char*>(smem_raw);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(p);  // B [L][d16+8]
  p += align16(static_cast<size_t>(L) * ldb * 2);
  float* cs = reinterpret_cast<float*>(p);  // [hg][L]
  p += align16(static_cast<size_t>(hg) * L * 4);
  float* eb = reinterpret_cast<float*>(p);  // [L]
  p += align16(static_cast<size_t>(L) * 4);
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(p);  // [L][dh+8]

  const size_t p0 = static_cast<size_t>(bb) * lp + static_cast<size_t>(c) * L;
  copy_rows(Bs, ldb * 2, Bg + p0 * ds, static_cast<size_t>(ds) * 2, L, ds * 2);
  copy_rows(cs, L * 4, la + (static_cast<size_t>(bb) * H + h0) * lp + static_cast<size_t>(c) * L,
            static_cast<size_t>(lp) * 4, hg, L * 4);
  cp_async_commit();
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int i = tid; i < L * (d16 - ds); i += kThreads)  // columns past ds: 0
    Bs[(i / (d16 - ds)) * ldb + ds + i % (d16 - ds)] = zero;
  cp_async_wait_all();
  __syncthreads();
  for (int g = tid; g < hg; g += kThreads)
    chunk_cumsum(cs + g * L,
                 gcs + (static_cast<size_t>(bb) * H + h0 + g) * lp + static_cast<size_t>(c) * L, L);
  const size_t xrow = static_cast<size_t>(H) * dh;
  const int mtiles = d16 / 16, nt_all = dh / 8;
  for (int g = 0; g < hg; ++g) {
    const int hh = h0 + g;
    __syncthreads();  // cs ready; the previous head's products done
    copy_rows(Xs, ldx * 2, dtx + p0 * xrow + static_cast<size_t>(hh) * dh, xrow * 2, L, dh * 2);
    cp_async_commit();
    const float total = cs[g * L + L - 1];
    for (int r = tid; r < L; r += kThreads) eb[r] = expf(total - cs[g * L + r]);
    cp_async_wait_all();
    __syncthreads();
    float* out = st + ((static_cast<size_t>(bb) * nc + c) * H + hh) * ds * dh;
    // warp tiles: a 16-row m-tile of the state and half of its n-tiles
    for (int tile = warp; tile < 2 * mtiles; tile += kThreads / 32) {
      const int mt = tile >> 1, half = tile & 1;
      const int nt0 = half ? (nt_all + 1) / 2 : 0, nt1 = half ? nt_all : (nt_all + 1) / 2;
      float acc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      const int ka = mt * 16 + gr, kb = ka + 8;  // the lane's two state rows
      for (int k0 = 0; k0 < L; k0 += 16) {
        // A = (B o e)^T: rows ka, kb; columns (positions) k0 + 2q (+1, +8, +9)
        const int j = k0 + 2 * q;
        const float2 e0 = *reinterpret_cast<const float2*>(eb + j);
        const float2 e8 = *reinterpret_cast<const float2*>(eb + j + 8);
        uint32_t ah[4], al[4];
        split2(__bfloat162float(Bs[j * ldb + ka]) * e0.x,
               __bfloat162float(Bs[(j + 1) * ldb + ka]) * e0.y, ah[0], al[0]);
        split2(__bfloat162float(Bs[j * ldb + kb]) * e0.x,
               __bfloat162float(Bs[(j + 1) * ldb + kb]) * e0.y, ah[1], al[1]);
        split2(__bfloat162float(Bs[(j + 8) * ldb + ka]) * e8.x,
               __bfloat162float(Bs[(j + 9) * ldb + ka]) * e8.y, ah[2], al[2]);
        split2(__bfloat162float(Bs[(j + 8) * ldb + kb]) * e8.x,
               __bfloat162float(Bs[(j + 9) * ldb + kb]) * e8.y, ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          if (nt0 + n >= nt1) break;
          uint32_t b[2];
          load_b_kn(b, Xs, ldx, k0, (nt0 + n) * 8);
          mma16816(acc[n], ah, b);
          mma16816(acc[n], al, b);
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (nt0 + n >= nt1) break;
        const int col = (nt0 + n) * 8 + 2 * q;
        for (int hf = 0; hf < 2; ++hf) {
          const int row = mt * 16 + gr + 8 * hf;
          if (row < ds)
            *reinterpret_cast<float2*>(out + row * dh + col) =
                make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
        }
      }
    }
  }
}

// --------------------------------------------------------- 2. state pass
// The carry in chunk order, one thread an entry of S: each chunk's slot of
// `st` becomes the state entering the chunk; the last state is the output.
// Eight chunks' contributions and decays are loaded before they are used.
__global__ void __launch_bounds__(kThreads, 1) scan_state_pass(
    const float* __restrict__ gcs, float* __restrict__ st, float* __restrict__ state,
    int batch, int lp, int H, int dh, int ds, int L) {
  const size_t per = static_cast<size_t>(ds) * dh;
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<size_t>(batch) * H * per) return;
  const int nc = lp / L;
  const size_t e = i % per;
  const int hh = static_cast<int>((i / per) % H), bb = static_cast<int>(i / per / H);
  const float* cs_bh = gcs + (static_cast<size_t>(bb) * H + hh) * lp;
  const size_t cstride = static_cast<size_t>(H) * per;
  float* base = st + (static_cast<size_t>(bb) * nc * H + hh) * per + e;
  float s = 0.f;
  for (int c0 = 0; c0 < nc; c0 += 8) {
    float acc[8], lg[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c0 + u < nc) {
        acc[u] = base[(c0 + u) * cstride];
        lg[u] = cs_bh[static_cast<size_t>(c0 + u) * L + L - 1];
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c0 + u < nc) {
        const float decay = expf(lg[u]);
        base[(c0 + u) * cstride] = s;
        s = decay * s + acc[u];
      }
    }
  }
  state[i] = s;
}

// ---------------------------------------------------------- 3. chunk out
// fp32: the fixed chains for every element (above), G once for the heads.
// G and M are kept transposed ([j][t]) so a thread reads four rows' values
// of a column in one load; a thread runs the chains of 4 rows x 2 columns.
__global__ void __launch_bounds__(kThreads, 1) scan_chunk_out_f32(
    const float* __restrict__ dtx, const float* __restrict__ Bg,
    const float* __restrict__ Cg, const float* __restrict__ gcs,
    const float* __restrict__ st, float* __restrict__ y, int lp, int H, int dh,
    int ds, int L, int hg) {
  extern __shared__ uint4 smem_raw[];
  const int R = row_tile(L);
  const int rt = blockIdx.x, c = blockIdx.y;
  const int bb = blockIdx.z / (H / hg), h0 = (blockIdx.z % (H / hg)) * hg;
  const int r0 = rt * R, nr = min(R, L - r0), J = r0 + nr;  // rows; columns of M
  const int nc = lp / L, dsp = ds + 1, tid = threadIdx.x;
  char* p = reinterpret_cast<char*>(smem_raw);
  float* Bs = reinterpret_cast<float*>(p);  // [L][ds+1]
  p += align16(static_cast<size_t>(L) * dsp * 4);
  float* Ct = reinterpret_cast<float*>(p);  // C^T [ds][R]
  p += align16(static_cast<size_t>(ds) * R * 4);
  float* CEt = reinterpret_cast<float*>(p);  // (C o exp(cs_t))^T [ds][R]
  p += align16(static_cast<size_t>(ds) * R * 4);
  float* Gt = reinterpret_cast<float*>(p);  // G^T [J][R]
  p += align16(static_cast<size_t>(L) * R * 4);
  float* Mt = reinterpret_cast<float*>(p);  // M^T [J][R]
  p += align16(static_cast<size_t>(L) * R * 4);
  float* Xs = reinterpret_cast<float*>(p);  // [J][dh]
  p += align16(static_cast<size_t>(L) * dh * 4);
  float* Ss = reinterpret_cast<float*>(p);  // [ds][dh]
  p += align16(static_cast<size_t>(ds) * dh * 4);
  float* csv = reinterpret_cast<float*>(p);  // [J]
  p += align16(static_cast<size_t>(L) * 4);
  float* ec = reinterpret_cast<float*>(p);  // exp(cs_t) [R]

  const size_t p0 = static_cast<size_t>(bb) * lp + static_cast<size_t>(c) * L;
  for (int i = tid; i < J * ds; i += kThreads) {
    const int r = i / ds, k = i % ds;
    cp_async4(Bs + r * dsp + k, Bg + (p0 + r) * ds + k);
  }
  for (int i = tid; i < nr * ds; i += kThreads) {  // t fastest: no store conflicts
    const int k = i / nr, t = i % nr;
    cp_async4(Ct + k * R + t, Cg + (p0 + r0 + t) * ds + k);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int nt4 = nr / 4;
  for (int i = tid; i < J * nt4; i += kThreads) {  // G on the causal half, 4 rows a thread
    const int j = i / nt4, t0 = 4 * (i % nt4);
    if (j > r0 + t0 + 3) continue;
    float g[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < ds; ++k) {
      const float4 cv = *reinterpret_cast<const float4*>(Ct + k * R + t0);
      const float bv = Bs[j * dsp + k];
      g[0] = fmaf(cv.x, bv, g[0]);
      g[1] = fmaf(cv.y, bv, g[1]);
      g[2] = fmaf(cv.z, bv, g[2]);
      g[3] = fmaf(cv.w, bv, g[3]);
    }
    *reinterpret_cast<float4*>(Gt + j * R + t0) = make_float4(g[0], g[1], g[2], g[3]);
  }
  const size_t xrow = static_cast<size_t>(H) * dh;
  const int half = dh / 2;
  for (int g = 0; g < hg; ++g) {
    const int hh = h0 + g;
    __syncthreads();  // G ready; the previous head's reads done
    copy_rows(csv, J * 4, gcs + (static_cast<size_t>(bb) * H + hh) * lp + static_cast<size_t>(c) * L,
              0, 1, J * 4);
    copy_rows(Xs, dh * 4, dtx + p0 * xrow + static_cast<size_t>(hh) * dh, xrow * 4, J, dh * 4);
    copy_rows(Ss, ds * dh * 4, st + ((static_cast<size_t>(bb) * nc + c) * H + hh) * ds * dh, 0, 1,
              ds * dh * 4);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    for (int t = tid; t < nr; t += kThreads) ec[t] = expf(csv[r0 + t]);
    for (int i = tid; i < J * nr; i += kThreads) {
      const int j = i / nr, t = i % nr, row = r0 + t;
      Mt[j * R + t] = j <= row ? Gt[j * R + t] * expf(csv[row] - csv[j]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < ds * nr; i += kThreads) {
      const int k = i / nr, t = i % nr;
      CEt[k * R + t] = Ct[k * R + t] * ec[t];
    }
    __syncthreads();
    for (int i = tid; i < nt4 * half; i += kThreads) {
      const int t0 = 4 * (i / half), c0 = 2 * (i % half), rlast = r0 + t0;
      float a[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u][0] = a[u][1] = 0.f;
      // every chain runs j = 0 .. its row in order; rows t0 + u end u later
      for (int j = 0; j <= rlast; ++j) {
        const float4 m = *reinterpret_cast<const float4*>(Mt + j * R + t0);
        const float2 x = *reinterpret_cast<const float2*>(Xs + j * dh + c0);
        a[0][0] = fmaf(m.x, x.x, a[0][0]);
        a[0][1] = fmaf(m.x, x.y, a[0][1]);
        a[1][0] = fmaf(m.y, x.x, a[1][0]);
        a[1][1] = fmaf(m.y, x.y, a[1][1]);
        a[2][0] = fmaf(m.z, x.x, a[2][0]);
        a[2][1] = fmaf(m.z, x.y, a[2][1]);
        a[3][0] = fmaf(m.w, x.x, a[3][0]);
        a[3][1] = fmaf(m.w, x.y, a[3][1]);
      }
#pragma unroll
      for (int j = 1; j < 4; ++j) {
        const float4 m = *reinterpret_cast<const float4*>(Mt + (rlast + j) * R + t0);
        const float2 x = *reinterpret_cast<const float2*>(Xs + (rlast + j) * dh + c0);
        const float mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
        for (int u = 1; u < 4; ++u) {
          if (u >= j) {
            a[u][0] = fmaf(mv[u], x.x, a[u][0]);
            a[u][1] = fmaf(mv[u], x.y, a[u][1]);
          }
        }
      }
      float n[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u) n[u][0] = n[u][1] = 0.f;
      for (int k = 0; k < ds; ++k) {
        const float4 ce = *reinterpret_cast<const float4*>(CEt + k * R + t0);
        const float2 sv = *reinterpret_cast<const float2*>(Ss + k * dh + c0);
        n[0][0] = fmaf(ce.x, sv.x, n[0][0]);
        n[0][1] = fmaf(ce.x, sv.y, n[0][1]);
        n[1][0] = fmaf(ce.y, sv.x, n[1][0]);
        n[1][1] = fmaf(ce.y, sv.y, n[1][1]);
        n[2][0] = fmaf(ce.z, sv.x, n[2][0]);
        n[2][1] = fmaf(ce.z, sv.y, n[2][1]);
        n[3][0] = fmaf(ce.w, sv.x, n[3][0]);
        n[3][1] = fmaf(ce.w, sv.y, n[3][1]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<float2*>(y + (p0 + rlast + u) * xrow + static_cast<size_t>(hh) * dh +
                                   c0) = make_float2(a[u][0] + n[u][0], a[u][1] + n[u][1]);
    }
  }
}

// bf16: one block a (chunk, batch, head), 8 warps; warp w takes the 16-row
// m-tiles w and 15 - w, 23 - w ... (so the causal work is even). For an
// m-tile it keeps C's A fragments in registers, puts (C @ S_prev) o exp(cs_t)
// into the accumulator (S_prev as hi + lo), then walks the k-steps up to its
// rows: G's two 8-column pieces from C and B on the tensor cores, M =
// bf16(G o exp(cs_t - cs_j)) on j <= t built in registers as the next
// product's A fragment (an accumulator's layout is an A fragment's), and
// M @ dtx added. Nothing but y leaves the block.
template <int NT>
__global__ void __launch_bounds__(kThreads, 1) scan_chunk_out_bf16(
    const __nv_bfloat16* __restrict__ dtx, const __nv_bfloat16* __restrict__ Bg,
    const __nv_bfloat16* __restrict__ Cg, const float* __restrict__ gcs,
    const float* __restrict__ st, __nv_bfloat16* __restrict__ y, int lp, int H,
    int dh, int ds, int L) {
  extern __shared__ uint4 smem_raw[];
  const int c = blockIdx.x, bb = blockIdx.y, hh = blockIdx.z;
  const int nc = lp / L, d16 = round16(ds), tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, gr = lane >> 2, q = lane & 3;
  const int ldb = d16 + 8, ldx = dh + 8, lds = dh + 4, nt_all = dh / 8;
  char* p = reinterpret_cast<char*>(smem_raw);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(p);  // [L][d16+8]
  p += align16(static_cast<size_t>(L) * ldb * 2);
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(p);  // [L][dh+8]
  p += align16(static_cast<size_t>(L) * ldx * 2);
  float* Ss = reinterpret_cast<float*>(p);  // S_prev [d16][dh+4]
  p += align16(static_cast<size_t>(d16) * lds * 4);
  float* csv = reinterpret_cast<float*>(p);  // [L]

  const size_t p0 = static_cast<size_t>(bb) * lp + static_cast<size_t>(c) * L;
  const size_t xrow = static_cast<size_t>(H) * dh;
  copy_rows(Bs, ldb * 2, Bg + p0 * ds, static_cast<size_t>(ds) * 2, L, ds * 2);
  copy_rows(Xs, ldx * 2, dtx + p0 * xrow + static_cast<size_t>(hh) * dh, xrow * 2, L, dh * 2);
  copy_rows(Ss, lds * 4, st + ((static_cast<size_t>(bb) * nc + c) * H + hh) * ds * dh,
            static_cast<size_t>(dh) * 4, ds, dh * 4);
  copy_rows(csv, L * 4, gcs + (static_cast<size_t>(bb) * H + hh) * lp + static_cast<size_t>(c) * L,
            0, 1, L * 4);
  cp_async_commit();
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int i = tid; i < L * (d16 - ds); i += kThreads)  // B's columns past ds: 0
    Bs[(i / (d16 - ds)) * ldb + ds + i % (d16 - ds)] = zero;
  for (int i = tid; i < (d16 - ds) * dh; i += kThreads)  // S_prev's rows past ds: 0
    Ss[(ds + i / dh) * lds + i % dh] = 0.f;
  cp_async_wait_all();
  __syncthreads();

  const int mtiles = L / 16;
  for (int k = 0;; ++k) {
    const int mt = (k & 1) ? 8 * k + 7 - warp : 8 * k + warp;
    if (mt >= mtiles) break;
    const int ta = mt * 16 + gr, tb = ta + 8;  // the lane's two rows
    uint32_t ac[8][4];  // C's A fragments, d16 / 16 of them (d_state <= 128)
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (16 * kk >= d16) break;
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int row = (f & 1) ? tb : ta, col = 16 * kk + 2 * q + 8 * (f >> 1);
        ac[kk][f] = col < ds ? *reinterpret_cast<const uint32_t*>(Cg + (p0 + row) * ds + col)
                             : 0u;
      }
    }
    const float ca = csv[ta], cb = csv[tb];
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    // the carried term: C @ S_prev, then each row times exp(cs_t)
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (16 * kk >= d16) break;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n >= nt_all) break;
        const int col = n * 8 + gr, k0 = 16 * kk + 2 * q;
        uint32_t bh[2], bl[2];
        split2(Ss[k0 * lds + col], Ss[(k0 + 1) * lds + col], bh[0], bl[0]);
        split2(Ss[(k0 + 8) * lds + col], Ss[(k0 + 9) * lds + col], bh[1], bl[1]);
        mma16816(acc[n], ac[kk], bh);
        mma16816(acc[n], ac[kk], bl);
      }
    }
    const float ea = expf(ca), eb = expf(cb);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= ea;
      acc[n][1] *= ea;
      acc[n][2] *= eb;
      acc[n][3] *= eb;
    }
    // the chunk's own term, k-step by k-step up to the m-tile's last row
    for (int j0 = 0; j0 <= mt * 16; j0 += 16) {
      float g0[4] = {0.f, 0.f, 0.f, 0.f}, g1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (16 * kk >= d16) break;
        uint32_t b0[2], b1[2];
        load_b_nk(b0, Bs, ldb, j0, 16 * kk);
        load_b_nk(b1, Bs, ldb, j0 + 8, 16 * kk);
        mma16816(g0, ac[kk], b0);
        mma16816(g1, ac[kk], b1);
      }
      const float2 c0 = *reinterpret_cast<const float2*>(csv + j0 + 2 * q);
      const float2 c8 = *reinterpret_cast<const float2*>(csv + j0 + 8 + 2 * q);
      const int ja = j0 + 2 * q, jb = ja + 8;
      // M = bf16(G o exp(cs_t - cs_j)) on j <= t, as the A fragment
      uint32_t a[4];
      a[0] = pack2(ja <= ta ? g0[0] * expf(ca - c0.x) : 0.f,
                   ja + 1 <= ta ? g0[1] * expf(ca - c0.y) : 0.f);
      a[1] = pack2(ja <= tb ? g0[2] * expf(cb - c0.x) : 0.f,
                   ja + 1 <= tb ? g0[3] * expf(cb - c0.y) : 0.f);
      a[2] = pack2(jb <= ta ? g1[0] * expf(ca - c8.x) : 0.f,
                   jb + 1 <= ta ? g1[1] * expf(ca - c8.y) : 0.f);
      a[3] = pack2(jb <= tb ? g1[2] * expf(cb - c8.x) : 0.f,
                   jb + 1 <= tb ? g1[3] * expf(cb - c8.y) : 0.f);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n >= nt_all) break;
        uint32_t bx[2];
        load_b_kn(bx, Xs, ldx, j0, n * 8);
        mma16816(acc[n], a, bx);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n >= nt_all) break;
      const int col = n * 8 + 2 * q;
      *reinterpret_cast<uint32_t*>(y + (p0 + ta) * xrow + static_cast<size_t>(hh) * dh + col) =
          pack2(acc[n][0], acc[n][1]);
      *reinterpret_cast<uint32_t*>(y + (p0 + tb) * xrow + static_cast<size_t>(hh) * dh + col) =
          pack2(acc[n][2], acc[n][3]);
    }
  }
}

// ----------------------------------------------------------------- host
// Launches 1 and 2: each chunk's cumsums and own state, then the carry.
template <typename SK, typename T>
int launch_state(SK state_k, size_t smem, int g1, const T* x, const float* la, const T* B,
                 float* state, float* cs, float* st, int batch, int lp, int H, int dh,
                 int ds, int L, cudaStream_t stream) {
  if (smem > static_cast<size_t>(kSmemLimit)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(state_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  state_k<<<dim3(lp / L, batch, g1), kThreads, smem, stream>>>(x, la, B, cs, st, lp, H, dh,
                                                               ds, L, H / g1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t n = static_cast<size_t>(batch) * H * ds * dh;
  scan_state_pass<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
                    stream>>>(cs, st, state, batch, lp, H, dh, ds, L);
  return static_cast<int>(cudaGetLastError());
}

// Launch 3 in bf16: a block a (chunk, batch, head), NT n-tiles of 8 columns.
template <int NT>
int launch_out_bf16(const __nv_bfloat16* x, const __nv_bfloat16* B, const __nv_bfloat16* C,
                    const float* cs, const float* st, __nv_bfloat16* y, int batch, int lp,
                    int H, int dh, int ds, int L, cudaStream_t stream) {
  const size_t smem = out_smem_bf16(L, dh, ds);
  if (smem > static_cast<size_t>(kSmemLimit)) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = scan_chunk_out_bf16<NT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(lp / L, batch, H), kThreads, smem, stream>>>(x, B, C, cs, st, y, lp, H, dh, ds,
                                                           L);
  PTT_RETURN_LAUNCH_ERROR();
}

// ============================================================== backward
// The scan's gradient (ptt_selective_scan_bwd): what the reference's
// jax.vjp of the chunked form (paddle_tpu/ops/pallas/selective_scan.py:237,
// _scan_core_bwd; no TPU kernel) computes. Per chunk and (batch, head), with
// cs, T = cs_{L-1}, D_ij = exp(cs_i - cs_j) on j <= i, G = C B^T, M = G o D,
// Mr = M rounded to x's dtype, S_prev the state entering the chunk (saved by
// the forward) and dS the cotangent of the state leaving it:
//
//   dX      = Mr^T dy + (B o e^{T-cs}) dS
//   dM      = dy X^T (kept fp32), dG = dM o D, dP = dM o M
//   dC     += dG B + (dy S_prev^T) o e^{cs}
//   dB     += dG^T C + (X dS^T) o e^{T-cs}
//   dS_prev = e^T dS + (C o e^{cs})^T dy
//   dcs_i   = sum_j dP_ij - sum_j dP_ji + <(dy S_prev^T)_i o e^{cs_i}, C_i>
//             - <(X dS^T)_i, B_i o e^{T-cs_i}>, and dcs_{L-1} += that last
//             term summed over the chunk + e^T <dS, S_prev>
//   d_la    = the reverse cumsum of dcs within the chunk.
//
// Bound on the H100 at the training shape (bf16, dh 64, ds 64, L 256): the
// bytes of dtx, dy, d_dtx and the saved states (the operations of G, dM,
// Mr^T dy, dG B and dG^T C over the causal half take less); at the serving
// shape the fp32 operations.
//
// Schedule, chunk-parallel as the forward, no atomics (a repeat is bitwise):
//   1. chunk U: each chunk's cs (the forward's serial sum, so its bits) and
//      its own (C o e^{cs})^T dy.
//   2. scan_bwd_state_pass (an entry of dS a thread): the dS carry in reverse
//      chunk order, each chunk's slot becoming the cotangent leaving it.
//   3. rows: a tile of rows i walks the column tiles j <= i: dC's rows and
//      dP's row sums.
//   4. cols: a tile of columns j walks the row tiles i >= j: dX's and dB's
//      rows and dP's column sums (the flash backward's dQ / dK-dV split: G
//      and dM formed in both).
//   5. scan_bwd_dla (chunks x batch*heads): <dS, S_prev> and d_la.
//   6. scan_bwd_dbc: dB and dC summed over the partials in order.
// Two routes, picked by the wrapper from shape and alignment (the C entry's
// tma flag; ops/kernels/selective_scan.py:bwd_route mirrors the rule):
//  * wgmma (bf16, dh and ds 64 or 128, L a multiple of 64, 16-byte-aligned
//    bases): 1, 3 and 4 are wgmma kernels over TMA rings, a block walking a
//    group of heads (namespace wgb below); the state pass also writes dS and
//    S_prev as bf16 hi + lo planes for their TMA loads; the partials are a
//    head group's.
//  * edge (every other call): 1, 3 and 4 are a block a head (scan_bwd_chunk_u,
//    scan_bwd_rows, scan_bwd_cols over row tiles x chunks x batch*heads);
//    fp32 runs every product as FMA chains on the CUDA cores, bf16 on
//    mma.sync (m16n8k16, fp32 accumulation); tiles are R rows (64, 32, 16,
//    or 8 in fp32: the largest whose shared memory fits;
//    ops/kernels/selective_scan.py:bwd_launch_plan mirrors the sums); the
//    partials are each head's.
// Both routes split the fp32 operands (dG, S_prev, dS and the decay-scaled B
// and C) into two bf16 terms (hi + lo) as the forward splits its own.

// One element pad of a shared-memory row: 16 bytes (keeps cp.async rows
// 16-byte aligned and moves rows across banks).
__host__ __device__ inline int pad_el(int E) { return 16 / E; }

__host__ __device__ inline size_t bwd_u_smem(int L, int dh, int ds, int R, int E) {
  const int p = pad_el(E);
  return 2 * align16(static_cast<size_t>(L) * 4)             // cs, exp(cs)
         + align16(static_cast<size_t>(R) * (ds + p) * E)    // C rows
         + align16(static_cast<size_t>(R) * (dh + p) * E)    // dy rows
         + align16(static_cast<size_t>(ds) * (dh + 4) * 4);  // the chunk's U
}
__host__ __device__ inline size_t bwd_rows_smem(int L, int dh, int ds, int R, int E) {
  const int p = pad_el(E);
  return align16(static_cast<size_t>(L) * 4)                 // cs
         + 2 * align16(static_cast<size_t>(R) * 4)            // exp(cs_i), row sums
         + 2 * align16(static_cast<size_t>(R) * (dh + p) * E)  // dy_i, X_j
         + 2 * align16(static_cast<size_t>(R) * (ds + p) * E)  // C_i, B_j
         + align16(static_cast<size_t>(ds) * (dh + 4) * 4)    // S_prev
         + 2 * align16(static_cast<size_t>(R) * (R + 4) * 4)  // G / dG, dM / dP
         + align16(static_cast<size_t>(R) * (ds + 4) * 4);    // dC rows
}
__host__ __device__ inline size_t bwd_cols_smem(int L, int dh, int ds, int R, int E) {
  const int p = pad_el(E);
  return align16(static_cast<size_t>(L) * 4)                 // cs
         + 3 * align16(static_cast<size_t>(R) * 4)            // e^{T-cs_j}, col sums, q
         + 2 * align16(static_cast<size_t>(R) * (dh + p) * E)  // X_j, dy_i
         + 2 * align16(static_cast<size_t>(R) * (ds + p) * E)  // B_j, C_i
         + align16(static_cast<size_t>(ds) * (dh + 4) * 4)    // dS
         + align16(static_cast<size_t>(R) * (R + p) * E)      // Mr
         + 2 * align16(static_cast<size_t>(R) * (R + 4) * 4)  // G / dG, dM / dP
         + align16(static_cast<size_t>(R) * (dh + 4) * 4)     // dX rows
         + align16(static_cast<size_t>(R) * (ds + 4) * 4);    // dB rows
}
// The tile rows: the largest of 64, 32, 16 (and 8 in fp32) up to L whose
// three kernels fit; 0 where none does.
__host__ __device__ inline int bwd_tile_rows(int L, int dh, int ds, int E) {
  const int opts[4] = {64, 32, 16, 8};
  for (int i = 0; i < (E == 4 ? 4 : 3); ++i) {
    const int R = opts[i];
    if (R > L) continue;
    if (bwd_u_smem(L, dh, ds, R, E) <= static_cast<size_t>(kSmemLimit) &&
        bwd_rows_smem(L, dh, ds, R, E) <= static_cast<size_t>(kSmemLimit) &&
        bwd_cols_smem(L, dh, ds, R, E) <= static_cast<size_t>(kSmemLimit))
      return R;
  }
  return 0;
}

// A shared-memory carve: successive 16-byte-aligned regions.
struct Carve {
  char* p;
  template <typename U> __device__ __forceinline__ U* take(size_t count) {
    U* r = reinterpret_cast<U*>(p);
    p += align16(count * sizeof(U));
    return r;
  }
};

// Fragments of m16n8k16 from element accessors (0 outside M x K, K x N);
// kSplit: the fp32 values as hi + lo bf16 terms.
template <bool kSplit, class F>
__device__ __forceinline__ void frag_a(const F& a, int M, int K, int m0, int k0,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int r = m0 + g + 8 * (f & 1), k = k0 + 2 * q + 8 * (f >> 1);
    const float v0 = r < M && k < K ? a(r, k) : 0.f;
    const float v1 = r < M && k + 1 < K ? a(r, k + 1) : 0.f;
    if (kSplit)
      split2(v0, v1, hi[f], lo[f]);
    else
      hi[f] = pack2(v0, v1);
  }
}
template <bool kSplit, class F>
__device__ __forceinline__ void frag_b(const F& b, int K, int N, int k0, int n0,
                                       uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int k = k0 + 2 * q + 8 * f, n = n0 + g;
    const float v0 = n < N && k < K ? b(k, n) : 0.f;
    const float v1 = n < N && k + 1 < K ? b(k + 1, n) : 0.f;
    if (kSplit)
      split2(v0, v1, hi[f], lo[f]);
    else
      hi[f] = pack2(v0, v1);
  }
}

// out(m, n) = sum_k a(m, k) b(k, n) over the block, each (m, n) handed once
// to epi(m, n, v). kMma: a warp takes a 16-row tile and four 8-column tiles
// at a time on mma.sync (SA / SB: the operand split into hi + lo); else one
// thread an element, one FMA chain over k in order.
template <bool kMma, bool SA, bool SB, class FA, class FB, class Epi>
__device__ __forceinline__ void block_gemm(int M, int N, int K, const FA& a, const FB& b,
                                           const Epi& epi) {
  if constexpr (kMma) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, q = lane & 3;
    const int mt = (M + 15) / 16, ng = (N + 31) / 32;
    for (int t = warp; t < mt * ng; t += kThreads / 32) {
      const int m0 = (t / ng) * 16, nb = (t % ng) * 32;
      float acc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      for (int k0 = 0; k0 < K; k0 += 16) {
        uint32_t ah[4], al[4];
        frag_a<SA>(a, M, K, m0, k0, ah, al);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          if (nb + 8 * n >= N) break;
          uint32_t bh[2], bl[2];
          frag_b<SB>(b, K, N, k0, nb + 8 * n, bh, bl);
          mma16816(acc[n], ah, bh);
          if (SA) mma16816(acc[n], al, bh);
          if (SB) mma16816(acc[n], ah, bl);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (nb + 8 * n >= N) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = m0 + g + 8 * (e >> 1), c = nb + 8 * n + 2 * q + (e & 1);
          if (r < M && c < N) epi(r, c, acc[n][e]);
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < M * N; i += kThreads) {
      const int m = i / N, n = i % N;
      float acc = 0.f;
      for (int k = 0; k < K; ++k) acc = fmaf(a(m, k), b(k, n), acc);
      epi(m, n, acc);
    }
  }
}

template <typename T> constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

// 1. (edge) Each chunk's cs (into gcs) and U = (C o e^{cs})^T dy (into its
//    slot of st), over k-tiles of R positions.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) scan_bwd_chunk_u(
    const float* __restrict__ la, const T* __restrict__ Cg, const T* __restrict__ dy,
    float* __restrict__ gcs, float* __restrict__ st, int lp, int H, int dh, int ds, int L,
    int R) {
  extern __shared__ uint4 smem_raw[];
  const int c = blockIdx.x, bb = blockIdx.y, hh = blockIdx.z, tid = threadIdx.x;
  const int nc = lp / L, E = sizeof(T), p = pad_el(E), ldc = ds + p, ldy = dh + p, lda = dh + 4;
  Carve cv{reinterpret_cast<char*>(smem_raw)};
  float* cs = cv.take<float>(L);
  float* ecs = cv.take<float>(L);
  T* Ct = cv.take<T>(static_cast<size_t>(R) * ldc);
  T* Yt = cv.take<T>(static_cast<size_t>(R) * ldy);
  float* U = cv.take<float>(static_cast<size_t>(ds) * lda);

  const size_t p0 = static_cast<size_t>(bb) * lp + static_cast<size_t>(c) * L;
  const size_t csoff = (static_cast<size_t>(bb) * H + hh) * lp + static_cast<size_t>(c) * L;
  const size_t xrow = static_cast<size_t>(H) * dh;
  copy_rows(cs, L * 4, la + csoff, 0, 1, L * 4);
  cp_async_commit();
  for (int i = tid; i < ds * lda; i += kThreads) U[i] = 0.f;
  cp_async_wait_all();
  __syncthreads();
  if (tid == 0) chunk_cumsum(cs, gcs + csoff, L);
  __syncthreads();
  for (int r = tid; r < L; r += kThreads) ecs[r] = expf(cs[r]);
  for (int k0 = 0; k0 < L; k0 += R) {
    const int nk = min(R, L - k0);
    __syncthreads();  // ecs ready; the previous tile's products done
    copy_rows(Ct, ldc * E, Cg + (p0 + k0) * ds, static_cast<size_t>(ds) * E, nk, ds * E);
    copy_rows(Yt, ldy * E, dy + (p0 + k0) * xrow + static_cast<size_t>(hh) * dh, xrow * E, nk,
              dh * E);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    block_gemm<kIsBf16<T>, true, false>(
        ds, dh, nk, [=](int m, int k) { return to_f(Ct[k * ldc + m]) * ecs[k0 + k]; },
        [=](int k, int n) { return to_f(Yt[k * ldy + n]); },
        [=](int m, int n, float v) { U[m * lda + n] += v; });
  }
  __syncthreads();
  float* out = st + ((static_cast<size_t>(bb) * nc + c) * H + hh) * ds * dh;
  for (int i = tid; i < ds * dh; i += kThreads) out[i] = U[(i / dh) * lda + i % dh];
}

// 2. The dS carry in reverse chunk order, one thread an entry: each chunk's
//    slot of st (its U on entry) becomes the cotangent of the state leaving
//    the chunk; dsf (the final state's cotangent) may be null (zeros). The
//    wgmma route (split non-null) also writes each slot's dS and S_prev
//    (states) as bf16 hi + lo terms, the operand tiles its TMA loads read.
__global__ void __launch_bounds__(kThreads, 1) scan_bwd_state_pass(
    const float* __restrict__ gcs, float* __restrict__ st, const float* __restrict__ dsf,
    int batch, int lp, int H, int dh, int ds, int L, const float* __restrict__ states,
    __nv_bfloat16* __restrict__ split) {
  const size_t per = static_cast<size_t>(ds) * dh;
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<size_t>(batch) * H * per) return;
  const int nc = lp / L;
  const size_t e = i % per;
  const int hh = static_cast<int>((i / per) % H), bb = static_cast<int>(i / per / H);
  const float* cs_bh = gcs + (static_cast<size_t>(bb) * H + hh) * lp;
  const size_t cstride = static_cast<size_t>(H) * per;
  const size_t off = (static_cast<size_t>(bb) * nc * H + hh) * per + e;
  float* base = st + off;
  // the four bf16 planes [batch, nc, H, ds, dh]: dS hi, dS lo, S_prev hi, S_prev lo
  const size_t plane = static_cast<size_t>(batch) * nc * H * per;
  float s = dsf != nullptr ? dsf[i] : 0.f;
  for (int c0 = nc - 1; c0 >= 0; c0 -= 8) {
    float u[8], lg[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (c0 - k >= 0) {
        u[k] = base[(c0 - k) * cstride];
        lg[k] = cs_bh[static_cast<size_t>(c0 - k) * L + L - 1];
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (c0 - k >= 0) {
        const size_t at = (c0 - k) * cstride;
        base[at] = s;
        if (split != nullptr) {
          const float sp = states[off + at];
          const __nv_bfloat16 dhi = __float2bfloat16_rn(s), shi = __float2bfloat16_rn(sp);
          split[off + at] = dhi;
          split[plane + off + at] = __float2bfloat16_rn(s - __bfloat162float(dhi));
          split[2 * plane + off + at] = shi;
          split[3 * plane + off + at] = __float2bfloat16_rn(sp - __bfloat162float(shi));
        }
        s = expf(lg[k]) * s + u[k];
      }
    }
  }
}

// 3. (edge) A tile of rows i: (dy S_prev^T) o e^{cs} and its row sums with
//    C, then over the column tiles j <= i: G and dM, dP's row sums,
//    dC += dG B_j.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) scan_bwd_rows(
    const T* __restrict__ dtx, const T* __restrict__ Bg, const T* __restrict__ Cg,
    const float* __restrict__ gcs, const float* __restrict__ states, const T* __restrict__ dy,
    float* __restrict__ rr, float* __restrict__ dCp, int lp, int H, int dh, int ds, int L, int R) {
  extern __shared__ uint4 smem_raw[];
  constexpr bool kMma = kIsBf16<T>;
  const int it = blockIdx.x, c = blockIdx.y, bh = blockIdx.z, tid = threadIdx.x;
  const int bb = bh / H, hh = bh % H, nc = lp / L;
  const int E = sizeof(T), p = pad_el(E), ldx = dh + p, ldb = ds + p, ldr = R + 4;
  const int lds = dh + 4, lda = ds + 4;
  const int i0 = it * R, ni = min(R, L - i0);
  Carve cv{reinterpret_cast<char*>(smem_raw)};
  float* cs = cv.take<float>(L);
  float* ecs = cv.take<float>(R);
  float* rs = cv.take<float>(R);
  T* Yi = cv.take<T>(static_cast<size_t>(R) * ldx);
  T* Xj = cv.take<T>(static_cast<size_t>(R) * ldx);
  T* Ci = cv.take<T>(static_cast<size_t>(R) * ldb);
  T* Bj = cv.take<T>(static_cast<size_t>(R) * ldb);
  float* Sp = cv.take<float>(static_cast<size_t>(ds) * lds);
  float* Gt = cv.take<float>(static_cast<size_t>(R) * ldr);
  float* Dt = cv.take<float>(static_cast<size_t>(R) * ldr);
  float* acc = cv.take<float>(static_cast<size_t>(R) * lda);

  const size_t p0 = static_cast<size_t>(bb) * lp + static_cast<size_t>(c) * L;
  const size_t csoff = static_cast<size_t>(bh) * lp + static_cast<size_t>(c) * L;
  const size_t xrow = static_cast<size_t>(H) * dh;
  copy_rows(cs, L * 4, gcs + csoff, 0, 1, L * 4);
  copy_rows(Yi, ldx * E, dy + (p0 + i0) * xrow + static_cast<size_t>(hh) * dh, xrow * E, ni,
            dh * E);
  copy_rows(Ci, ldb * E, Cg + (p0 + i0) * ds, static_cast<size_t>(ds) * E, ni, ds * E);
  copy_rows(Sp, lds * 4, states + ((static_cast<size_t>(bb) * nc + c) * H + hh) * ds * dh,
            static_cast<size_t>(dh) * 4, ds, dh * 4);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  for (int m = tid; m < ni; m += kThreads) ecs[m] = expf(cs[i0 + m]);
  __syncthreads();
  block_gemm<kMma, false, true>(
      ni, ds, dh, [=](int m, int k) { return to_f(Yi[m * ldx + k]); },
      [=](int k, int n) { return Sp[n * lds + k]; },
      [=](int m, int n, float v) { acc[m * lda + n] = v * ecs[m]; });
  __syncthreads();
  for (int m = tid; m < ni; m += kThreads) {
    float s = 0.f;
    for (int n = 0; n < ds; ++n) s = fmaf(acc[m * lda + n], to_f(Ci[m * ldb + n]), s);
    rs[m] = s;
  }
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * R, nj = min(R, L - j0);
    __syncthreads();  // the previous tile's products done
    copy_rows(Xj, ldx * E, dtx + (p0 + j0) * xrow + static_cast<size_t>(hh) * dh, xrow * E, nj,
              dh * E);
    copy_rows(Bj, ldb * E, Bg + (p0 + j0) * ds, static_cast<size_t>(ds) * E, nj, ds * E);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    block_gemm<kMma, false, false>(
        ni, nj, ds, [=](int m, int k) { return to_f(Ci[m * ldb + k]); },
        [=](int k, int n) { return to_f(Bj[n * ldb + k]); },
        [=](int m, int n, float v) { Gt[m * ldr + n] = v; });
    block_gemm<kMma, false, false>(
        ni, nj, dh, [=](int m, int k) { return to_f(Yi[m * ldx + k]); },
        [=](int k, int n) { return to_f(Xj[n * ldx + k]); },
        [=](int m, int n, float v) { Dt[m * ldr + n] = v; });
    __syncthreads();
    for (int e = tid; e < ni * nj; e += kThreads) {
      const int m = e / nj, n = e % nj, i = i0 + m, j = j0 + n;
      float dg = 0.f, dp = 0.f;
      if (j <= i) {
        const float d = expf(cs[i] - cs[j]), dm = Dt[m * ldr + n];
        dp = dm * (Gt[m * ldr + n] * d);
        dg = dm * d;
      }
      Gt[m * ldr + n] = dg;
      Dt[m * ldr + n] = dp;
    }
    __syncthreads();
    for (int m = tid; m < ni; m += kThreads) {
      float s = rs[m];
      for (int n = 0; n < nj; ++n) s += Dt[m * ldr + n];
      rs[m] = s;
    }
    block_gemm<kMma, true, false>(
        ni, ds, nj, [=](int m, int k) { return Gt[m * ldr + k]; },
        [=](int k, int n) { return to_f(Bj[k * ldb + n]); },
        [=](int m, int n, float v) { acc[m * lda + n] += v; });
  }
  __syncthreads();
  for (int m = tid; m < ni; m += kThreads) rr[csoff + i0 + m] = rs[m];
  float* out = dCp + (csoff + i0) * ds;
  for (int e = tid; e < ni * ds; e += kThreads) out[e] = acc[(e / ds) * lda + e % ds];
}

// 4. (edge) A tile of columns j: (B o e^{T-cs}) dS, (X dS^T) o e^{T-cs} and q, then
//    over the row tiles i >= j: G and dM, Mr, dP's column sums,
//    dX += Mr^T dy_i, dB += dG^T C_i; dX rounded once to x's dtype.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) scan_bwd_cols(
    const T* __restrict__ dtx, const T* __restrict__ Bg, const T* __restrict__ Cg,
    const float* __restrict__ gcs, const float* __restrict__ st, const T* __restrict__ dy,
    T* __restrict__ ddtx, float* __restrict__ cc, float* __restrict__ qq,
    float* __restrict__ dBp, int lp, int H, int dh, int ds, int L, int R) {
  extern __shared__ uint4 smem_raw[];
  constexpr bool kMma = kIsBf16<T>;
  const int jt = blockIdx.x, c = blockIdx.y, bh = blockIdx.z, tid = threadIdx.x;
  const int bb = bh / H, hh = bh % H, nc = lp / L, nrt = (L + R - 1) / R;
  const int E = sizeof(T), p = pad_el(E), ldx = dh + p, ldb = ds + p, ldr = R + 4, ldm = R + p;
  const int lds = dh + 4, ldax = dh + 4, ldab = ds + 4;
  const int j0 = jt * R, nj = min(R, L - j0);
  Carve cv{reinterpret_cast<char*>(smem_raw)};
  float* cs = cv.take<float>(L);
  float* eb = cv.take<float>(R);
  float* csum = cv.take<float>(R);
  float* qv = cv.take<float>(R);
  T* Xj = cv.take<T>(static_cast<size_t>(R) * ldx);
  T* Yi = cv.take<T>(static_cast<size_t>(R) * ldx);
  T* Bj = cv.take<T>(static_cast<size_t>(R) * ldb);
  T* Ci = cv.take<T>(static_cast<size_t>(R) * ldb);
  float* dS = cv.take<float>(static_cast<size_t>(ds) * lds);
  T* Mt = cv.take<T>(static_cast<size_t>(R) * ldm);
  float* Gt = cv.take<float>(static_cast<size_t>(R) * ldr);
  float* Dt = cv.take<float>(static_cast<size_t>(R) * ldr);
  float* ax = cv.take<float>(static_cast<size_t>(R) * ldax);
  float* ab = cv.take<float>(static_cast<size_t>(R) * ldab);

  const size_t p0 = static_cast<size_t>(bb) * lp + static_cast<size_t>(c) * L;
  const size_t csoff = static_cast<size_t>(bh) * lp + static_cast<size_t>(c) * L;
  const size_t xrow = static_cast<size_t>(H) * dh;
  copy_rows(cs, L * 4, gcs + csoff, 0, 1, L * 4);
  copy_rows(Xj, ldx * E, dtx + (p0 + j0) * xrow + static_cast<size_t>(hh) * dh, xrow * E, nj,
            dh * E);
  copy_rows(Bj, ldb * E, Bg + (p0 + j0) * ds, static_cast<size_t>(ds) * E, nj, ds * E);
  copy_rows(dS, lds * 4, st + ((static_cast<size_t>(bb) * nc + c) * H + hh) * ds * dh,
            static_cast<size_t>(dh) * 4, ds, dh * 4);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const float total = cs[L - 1];
  for (int m = tid; m < nj; m += kThreads) eb[m] = expf(total - cs[j0 + m]);
  __syncthreads();
  block_gemm<kMma, true, true>(
      nj, dh, ds, [=](int m, int k) { return to_f(Bj[m * ldb + k]) * eb[m]; },
      [=](int k, int n) { return dS[k * lds + n]; },
      [=](int m, int n, float v) { ax[m * ldax + n] = v; });
  block_gemm<kMma, false, true>(
      nj, ds, dh, [=](int m, int k) { return to_f(Xj[m * ldx + k]); },
      [=](int k, int n) { return dS[n * lds + k]; },
      [=](int m, int n, float v) { ab[m * ldab + n] = v * eb[m]; });
  __syncthreads();
  for (int m = tid; m < nj; m += kThreads) {
    float s = 0.f;
    for (int n = 0; n < ds; ++n) s = fmaf(ab[m * ldab + n], to_f(Bj[m * ldb + n]), s);
    qv[m] = s;
    csum[m] = 0.f;
  }
  for (int it = jt; it < nrt; ++it) {
    const int i0 = it * R, ni = min(R, L - i0);
    __syncthreads();  // the previous tile's products done
    copy_rows(Yi, ldx * E, dy + (p0 + i0) * xrow + static_cast<size_t>(hh) * dh, xrow * E, ni,
              dh * E);
    copy_rows(Ci, ldb * E, Cg + (p0 + i0) * ds, static_cast<size_t>(ds) * E, ni, ds * E);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    block_gemm<kMma, false, false>(
        ni, nj, ds, [=](int m, int k) { return to_f(Ci[m * ldb + k]); },
        [=](int k, int n) { return to_f(Bj[n * ldb + k]); },
        [=](int m, int n, float v) { Gt[m * ldr + n] = v; });
    block_gemm<kMma, false, false>(
        ni, nj, dh, [=](int m, int k) { return to_f(Yi[m * ldx + k]); },
        [=](int k, int n) { return to_f(Xj[n * ldx + k]); },
        [=](int m, int n, float v) { Dt[m * ldr + n] = v; });
    __syncthreads();
    for (int e = tid; e < ni * nj; e += kThreads) {
      const int m = e / nj, n = e % nj, i = i0 + m, j = j0 + n;
      float mm = 0.f, dg = 0.f, dp = 0.f;
      if (j <= i) {
        const float d = expf(cs[i] - cs[j]), dm = Dt[m * ldr + n];
        mm = Gt[m * ldr + n] * d;
        dp = dm * mm;
        dg = dm * d;
      }
      Mt[m * ldm + n] = from_f<T>(mm);
      Gt[m * ldr + n] = dg;
      Dt[m * ldr + n] = dp;
    }
    __syncthreads();
    for (int n = tid; n < nj; n += kThreads) {
      float s = csum[n];
      for (int m = 0; m < ni; ++m) s += Dt[m * ldr + n];
      csum[n] = s;
    }
    block_gemm<kMma, false, false>(
        nj, dh, ni, [=](int m, int k) { return to_f(Mt[k * ldm + m]); },
        [=](int k, int n) { return to_f(Yi[k * ldx + n]); },
        [=](int m, int n, float v) { ax[m * ldax + n] += v; });
    block_gemm<kMma, true, false>(
        nj, ds, ni, [=](int m, int k) { return Gt[k * ldr + m]; },
        [=](int k, int n) { return to_f(Ci[k * ldb + n]); },
        [=](int m, int n, float v) { ab[m * ldab + n] += v; });
  }
  __syncthreads();
  for (int m = tid; m < nj; m += kThreads) {
    cc[csoff + j0 + m] = csum[m];
    qq[csoff + j0 + m] = qv[m];
  }
  for (int e = tid; e < nj * dh; e += kThreads) {
    const int m = e / dh, n = e % dh;
    ddtx[(p0 + j0 + m) * xrow + static_cast<size_t>(hh) * dh + n] = from_f<T>(ax[m * ldax + n]);
  }
  float* outb = dBp + (csoff + j0) * ds;
  for (int e = tid; e < nj * ds; e += kThreads) outb[e] = ab[(e / ds) * ldab + e % ds];
}

// 5. Per (chunk, batch, head): <dS, S_prev> (a fixed tree), then dcs and its
//    reverse cumsum in order by one thread.
__global__ void __launch_bounds__(kThreads, 1) scan_bwd_dla(
    const float* __restrict__ gcs, const float* __restrict__ st,
    const float* __restrict__ states, const float* __restrict__ rr,
    const float* __restrict__ cc, const float* __restrict__ qq, float* __restrict__ dla,
    int lp, int H, int dh, int ds, int L) {
  __shared__ float dcs[kMaxChunk], qs[kMaxChunk];
  const int c = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int bb = bh / H, hh = bh % H, nc = lp / L;
  const size_t slot = ((static_cast<size_t>(bb) * nc + c) * H + hh) * ds * dh;
  const size_t csoff = static_cast<size_t>(bh) * lp + static_cast<size_t>(c) * L;
  float part = 0.f;
  for (int i = tid; i < ds * dh; i += kThreads) part = fmaf(st[slot + i], states[slot + i], part);
  for (int j = tid; j < L; j += kThreads) {
    qs[j] = qq[csoff + j];
    dcs[j] = rr[csoff + j] - cc[csoff + j] - qs[j];
  }
  const float inner = block_sum(part);  // syncs: dcs and qs are ready after it
  if (tid == 0) {
    float sq = 0.f;
    for (int j = 0; j < L; ++j) sq += qs[j];
    dcs[L - 1] += sq + expf(gcs[csoff + L - 1]) * inner;
    float run = 0.f;
    for (int j = L - 1; j >= 0; --j) {
      run += dcs[j];
      dla[csoff + j] = run;
    }
  }
}

// 6. dB and dC: the fp32 partials (a head's or a head group's) summed in
//    order, rounded once.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) scan_bwd_dbc(
    const float* __restrict__ dBp, const float* __restrict__ dCp, T* __restrict__ dB,
    T* __restrict__ dC, int batch, int lp, int parts, int ds) {
  const size_t per = static_cast<size_t>(lp) * ds;
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<size_t>(batch) * per) return;
  const size_t bb = i / per, e = i % per;
  float sb = 0.f, sc = 0.f;
  for (int k = 0; k < parts; ++k) {
    sb += dBp[(bb * parts + k) * per + e];
    sc += dCp[(bb * parts + k) * per + e];
  }
  dB[i] = from_f<T>(sb);
  dC[i] = from_f<T>(sc);
}

template <typename K>
int set_smem(K kern, size_t smem) {
  if (smem > static_cast<size_t>(kSmemLimit)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)));
}

// ------------------------------------------------------- bf16 on wgmma
// The tiled launches of the bf16 route (dh and ds 64 or 128, chunks of
// whole 64-row tiles, TMA-mappable bases): #2's dQ / dK-dV split
// (csrc/flash_attention_bwd.cu) in place of scan_bwd_rows / scan_bwd_cols.
// A block is one consumer warpgroup and a producer warp; the producer
// TMA-loads operand tiles (hopper.cuh's 128-byte-swizzled atoms; x and dy
// through 4-D maps over [batch, lp, H, dh], B and C through 3-D maps over
// [batch, lp, ds], the state pass's bf16 planes of dS and S_prev through
// 3-D maps over [slots, ds, dh]) into an mbarrier-guarded ring ahead of the
// consumers. Every product is a wgmma; G, dM, D, M, dG and dP stay in the
// accumulator layout, Mr and dG (hi + lo) reach the next product as
// register-A fragments (pack_a). A block walks a group of g heads in order
// (the last group may be smaller), so B and C tiles are loaded once a
// group where the walk allows and dB / dC are summed over the group's heads
// in fp32 registers: the partials are [batch, groups, lp, ds], summed over
// the groups in order by scan_bwd_dbc. Grid (batch x chunks x groups, row
// tiles): blockIdx.y 0 holds the longest tiles, which go out first.
//  rows: a row tile i. Per head, E = (dy_i S_prev^T) o e^{cs_i} (S_prev's
//    hi and lo terms) into dC and <E_i, C_i> into the row sums; then over
//    the column tiles j <= i, G = C_i B_j^T once for the group, and per
//    head dM = dy_i X_j^T, dG = dM o D, dP's row sums (quad shuffles, one
//    row a quad), dC += dG B_j (B_j read MN-major in place).
//  cols: a column tile j, the tiles formed transposed (G^T = B_j C_i^T,
//    dM^T = X_j dy_i^T), so dX_j += Mr^T dy_i and dB_j += dG^T C_i take A
//    from registers and dP's column sums are the tile's row sums. Per head,
//    dX = (B_j o e^{T-cs}) dS (3 products: hi.hi, lo.hi, hi.lo) and F = X_j
//    dS^T (dB's decayed term and q), then the row tiles i >= j; dX is the
//    head's alone (an accumulator a head, so G^T is formed a head).
// No atomics; every sum in a fixed order, so a repeat is bitwise.
namespace wgb {

using bf16 = __nv_bfloat16;
constexpr int kConsumers = 128;            // one warpgroup
constexpr int kWgThreads = kConsumers + 32;  // and one producer warp
constexpr int kMaxGroup = 16;              // heads a block at most
constexpr int kFill = 4 * 132;             // two waves of two blocks an SM
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int stages(int dh, int ds) { return dh == 128 && ds == 128 ? 3 : 4; }
// Operand tiles of a block, in bytes (each a multiple of 1024): the
// resident tile (C_i or B_j), the two-stage outer ring (B_j a column tile
// for rows; X_j^h a head for cols), and the item ring's stages of slot A
// (dy_i^h, 64 x dh) and slot B (ds x dh: X_j^h, C_i or a state term).
__host__ __device__ inline size_t tiles_rows(int dh, int ds) {
  return static_cast<size_t>(64) * ds * 2 * 3 +
         static_cast<size_t>(stages(dh, ds)) * (64 * dh * 2 + ds * dh * 2);
}
__host__ __device__ inline size_t tiles_cols(int dh, int ds) {
  return static_cast<size_t>(64) * ds * 2 + static_cast<size_t>(2) * 64 * dh * 2 +
         static_cast<size_t>(stages(dh, ds)) * (64 * dh * 2 + ds * dh * 2);
}
__host__ __device__ inline int n_bars(int dh, int ds) { return 5 + 2 * stages(dh, ds); }
// dynamic shared memory: the tiles, cs * log2(e) of the group's heads, the
// row sums (rows only), the barriers and the alignment slack
__host__ __device__ inline size_t smem_rows(int dh, int ds, int L, int g) {
  return tiles_rows(dh, ds) + static_cast<size_t>(g) * L * 4 + static_cast<size_t>(g) * 64 * 4 +
         n_bars(dh, ds) * 8 + hopper::kSmemAlign;
}
__host__ __device__ inline size_t smem_cols(int dh, int ds, int L, int g) {
  return tiles_cols(dh, ds) + static_cast<size_t>(g) * L * 4 + n_bars(dh, ds) * 8 +
         hopper::kSmemAlign;
}
// Heads a block: ceil(H / groups) for the fewest groups that give base x
// groups >= kFill blocks (and at most kMaxGroup heads a block), no more
// groups than heads; groups = ceil(H / g), so the last may be smaller.
inline int heads_a_block(int H, long long base) {
  long long groups = (kFill + base - 1) / base;
  groups = groups > (H + kMaxGroup - 1) / kMaxGroup ? groups : (H + kMaxGroup - 1) / kMaxGroup;
  groups = groups < H ? groups : H;
  return static_cast<int>((H + groups - 1) / groups);
}

template <int DH, int DS> struct Cfg {
  static constexpr int kStages = stages(DH, DS);
  static constexpr int kMinBlocks = DH == 64 && DS == 64 ? 2 : 1;
  static constexpr int kRes = 64 * DS * 2;  // a 64-row tile of B or C
  static constexpr int kX = 64 * DH * 2;    // a 64-row tile of x or dy (slot A)
  static constexpr int kSlotB = DS * DH * 2;
  // cols at ds 128: F and dX's decayed term in two passes over dS's terms
  // (F, dX, dB and B_j's fragments would not fit the registers together)
  static constexpr bool kTwoPasses = DS == 128;
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}
__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(empty);
}
// The sum over the quad that holds an accumulator row.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
// Elements (r, c) and (r, c + 1) of a swizzled bf16 tile of `rows` rows.
__device__ __forceinline__ float2 ld_pair(const unsigned char* tile, int rows, int r, int c) {
  const int cc = c & 63;
  return unpack2(*reinterpret_cast<const uint32_t*>(
      tile + (c >> 6) * rows * 128 + r * 128 + (((cc >> 3) ^ (r & 7)) << 4) + (cc & 7) * 2));
}
// Register-A fragments of an fp32 accumulator as bf16 hi + lo terms.
template <int R>
__device__ __forceinline__ void pack_a_split(uint32_t (&hi)[R / 8][4], uint32_t (&lo)[R / 8][4],
                                             const float (&d)[R]) {
#pragma unroll
  for (int j = 0; j < R / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) split2(d[8 * j + 2 * r], d[8 * j + 2 * r + 1], hi[j][r], lo[j][r]);
}
// K-major operand descriptor of k16 step kk of a tile of `rows` rows.
__device__ __forceinline__ uint64_t desc_k(const unsigned char* t, int rows, int kk) {
  return hopper::desc_sw128(t + (kk >> 2) * rows * 128 + (kk & 3) * 32, 16, 1024);
}
// MN-major (B, N contiguous) descriptor of k16 step kk of a tile of `rows` K rows.
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* t, int rows, int kk) {
  return hopper::desc_sw128(t + kk * 16 * 128, rows * 128, 1024);
}

template <int DH, int DS>
__global__ void __launch_bounds__(kWgThreads, Cfg<DH, DS>::kMinBlocks)
scan_bwd_rows_wgmma(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_dy,
                    const __grid_constant__ CUtensorMap map_b,
                    const __grid_constant__ CUtensorMap map_c,
                    const __grid_constant__ CUtensorMap map_sph,
                    const __grid_constant__ CUtensorMap map_spl, const float* __restrict__ gcs,
                    float* __restrict__ rr, float* __restrict__ dCp, int lp, int H, int L, int nc,
                    int g, int groups) {
  using Cf = Cfg<DH, DS>;
  constexpr int S = Cf::kStages, kRes = Cf::kRes, kX = Cf::kX, kSlotB = Cf::kSlotB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Cs = hopper::align_smem(smem_raw);
  unsigned char* Bs = Cs + kRes;       // 2 stages
  unsigned char* As = Bs + 2 * kRes;   // S stages of slot A: dy_i^h
  unsigned char* Ss = As + S * kX;     // S stages of slot B: X_j^h or S_prev^h's term
  float* cs2 = reinterpret_cast<float*>(Ss + S * kSlotB);  // [g][L]
  float* rs = cs2 + g * L;                                 // [g][64]
  uint64_t* c_full = reinterpret_cast<uint64_t*>(rs + g * 64);
  uint64_t* b_full = c_full + 1;
  uint64_t* b_empty = b_full + 2;
  uint64_t* full = b_empty + 2;
  uint64_t* empty = full + S;

  const int nrt = L / 64, it = nrt - 1 - static_cast<int>(blockIdx.y);
  const int grp = blockIdx.x % groups, bc = blockIdx.x / groups, c = bc % nc, b = bc / nc;
  const int h0 = grp * g, gh = min(g, H - h0), i0 = it * 64, p0 = c * L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    hopper::mbar_init(c_full, 1);
    for (int k = 0; k < 2; ++k) {
      hopper::mbar_init(&b_full[k], 1);
      hopper::mbar_init(&b_empty[k], kConsumers / 32);
    }
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer warp
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(c_full, kRes);
      for (int a = 0; a < DS / 64; ++a)
        hopper::tma_load_3d(Cs + a * 64 * 128, &map_c, c_full, a * 64, p0 + i0, b);
      int n = 0;
      auto stage = [&](int bytes) {
        const int s = n % S;
        if (n >= S) hopper::mbar_wait(&empty[s], ((n / S) - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], bytes);
        ++n;
        return s;
      };
      auto load_dy = [&](int s, int hh) {
        for (int a = 0; a < DH / 64; ++a)
          hopper::tma_load_4d(As + s * kX + a * 64 * 128, &map_dy, &full[s], a * 64, h0 + hh,
                              p0 + i0, b);
      };
      for (int hh = 0; hh < gh; ++hh)
        for (int part = 0; part < 2; ++part) {
          const int s = stage(kX + kSlotB);
          load_dy(s, hh);
          const int slot = (b * nc + c) * H + h0 + hh;
          for (int a = 0; a < DH / 64; ++a)
            hopper::tma_load_3d(Ss + s * kSlotB + a * DS * 128, part ? &map_spl : &map_sph,
                                &full[s], a * 64, 0, slot);
        }
      for (int j = 0; j <= it; ++j) {
        const int sb = j & 1;
        if (j >= 2) hopper::mbar_wait(&b_empty[sb], ((j >> 1) - 1) & 1);
        hopper::mbar_arrive_expect_tx(&b_full[sb], kRes);
        for (int a = 0; a < DS / 64; ++a)
          hopper::tma_load_3d(Bs + sb * kRes + a * 64 * 128, &map_b, &b_full[sb], a * 64,
                              p0 + j * 64, b);
        for (int hh = 0; hh < gh; ++hh) {
          const int s = stage(2 * kX);
          load_dy(s, hh);
          for (int a = 0; a < DH / 64; ++a)
            hopper::tma_load_4d(Ss + s * kSlotB + a * 64 * 128, &map_x, &full[s], a * 64,
                                h0 + hh, p0 + j * 64, b);
        }
      }
    }
    return;
  }

  for (int k = threadIdx.x; k < gh * L; k += kConsumers)
    cs2[k] = gcs[(static_cast<size_t>(b) * H + h0 + k / L) * lp + p0 + k % L] * kLog2e;
  consumer_sync();
  const int r_lo = 16 * warp + (lane >> 2), r_hi = r_lo + 8, qd = 2 * (lane & 3);

  float dC[DS / 2];
#pragma unroll
  for (int k = 0; k < DS / 2; ++k) dC[k] = 0.f;
  hopper::mbar_wait(c_full, 0);
  int n = 0;
  // the carried term of each head: E = (dy_i S_prev^T) o e^{cs_i}
  for (int hh = 0; hh < gh; ++hh) {
    float E[DS / 2];
    for (int part = 0; part < 2; ++part, ++n) {
      const int s = n % S;
      hopper::mbar_wait(&full[s], (n / S) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        hopper::wgmma_ss<DS, 0>(E, desc_k(As + s * kX, 64, kk), desc_k(Ss + s * kSlotB, DS, kk),
                                part > 0 || kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(E);
      release(&empty[s]);
    }
    const float* c2 = cs2 + hh * L;
    const float e_lo = hopper::exp2_approx(c2[i0 + r_lo]);
    const float e_hi = hopper::exp2_approx(c2[i0 + r_hi]);
    float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
    for (int k = 0; k < DS / 2; k += 2) {
      const bool hi = k & 2;
      const int row = hi ? r_hi : r_lo, col = 8 * (k / 4) + qd;
      const float e = hi ? e_hi : e_lo;
      const float2 cv = ld_pair(Cs, 64, row, col);
      const float v0 = E[k] * e, v1 = E[k + 1] * e;
      dC[k] += v0;
      dC[k + 1] += v1;
      float& acc = hi ? s_hi : s_lo;
      acc = fmaf(v0, cv.x, acc);
      acc = fmaf(v1, cv.y, acc);
    }
    s_lo = quad_sum(s_lo);
    s_hi = quad_sum(s_hi);
    if ((lane & 3) == 0) {
      rs[hh * 64 + r_lo] = s_lo;
      rs[hh * 64 + r_hi] = s_hi;
    }
  }

  // the column tiles j <= i: G once for the group, then each head's dM
  float G[32], dM[32];
  uint32_t ah[4][4], al[4][4];
  for (int j = 0; j <= it; ++j) {
    const int sb = j & 1;
    hopper::mbar_wait(&b_full[sb], (j >> 1) & 1);
    const unsigned char* Bt = Bs + sb * kRes;
    const bool diag = j == it;
    for (int hh = 0; hh < gh; ++hh, ++n) {
      const int s = n % S;
      hopper::mbar_wait(&full[s], (n / S) & 1);
      hopper::wgmma_fence();
      if (hh == 0) {
#pragma unroll
        for (int kk = 0; kk < DS / 16; ++kk)
          hopper::wgmma_ss<64, 0>(G, desc_k(Cs, 64, kk), desc_k(Bt, 64, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        hopper::wgmma_ss<64, 0>(dM, desc_k(As + s * kX, 64, kk), desc_k(Ss + s * kSlotB, 64, kk),
                                kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(G);
      hopper::fence_regs(dM);
      const float* c2 = cs2 + hh * L;
      const float ci_lo = c2[i0 + r_lo], ci_hi = c2[i0 + r_hi];
      float p_lo = 0.f, p_hi = 0.f;
#pragma unroll
      for (int k = 0; k < 32; k += 2) {
        const bool hi = k & 2;
        const int row = hi ? r_hi : r_lo, col = 8 * (k / 4) + qd;
        const float ci = hi ? ci_hi : ci_lo;
        const float2 cj = *reinterpret_cast<const float2*>(c2 + j * 64 + col);
        float d0 = hopper::exp2_approx(ci - cj.x), d1 = hopper::exp2_approx(ci - cj.y);
        if (diag) {  // j <= i: column <= row
          if (col > row) d0 = 0.f;
          if (col + 1 > row) d1 = 0.f;
        }
        const float dp0 = dM[k] * (G[k] * d0), dp1 = dM[k + 1] * (G[k + 1] * d1);
        dM[k] *= d0;  // dG
        dM[k + 1] *= d1;
        float& acc = hi ? p_hi : p_lo;
        acc += dp0;
        acc += dp1;
      }
      p_lo = quad_sum(p_lo);
      p_hi = quad_sum(p_hi);
      if ((lane & 3) == 0) {
        rs[hh * 64 + r_lo] += p_lo;
        rs[hh * 64 + r_hi] += p_hi;
      }
      pack_a_split(ah, al, dM);
      hopper::fence_regs(dC);
      hopper::wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        hopper::wgmma_rs<DS, 1>(dC, ah[jj], desc_mn(Bt, 64, jj), 1);
        hopper::wgmma_rs<DS, 1>(dC, al[jj], desc_mn(Bt, 64, jj), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dC);
      release(&empty[s]);
    }
    release(&b_empty[sb]);
  }

  if ((lane & 3) == 0)
    for (int hh = 0; hh < gh; ++hh) {
      float* out = rr + (static_cast<size_t>(b) * H + h0 + hh) * lp + p0 + i0;
      out[r_lo] = rs[hh * 64 + r_lo];
      out[r_hi] = rs[hh * 64 + r_hi];
    }
  float* out = dCp + ((static_cast<size_t>(b) * groups + grp) * lp + p0 + i0) * DS;
#pragma unroll
  for (int k = 0; k < DS / 2; k += 2) {
    const int row = (k & 2) ? r_hi : r_lo, col = 8 * (k / 4) + qd;
    *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * DS + col) =
        make_float2(dC[k], dC[k + 1]);
  }
}

template <int DH, int DS>
__global__ void __launch_bounds__(kWgThreads, Cfg<DH, DS>::kMinBlocks)
scan_bwd_cols_wgmma(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_dy,
                    const __grid_constant__ CUtensorMap map_b,
                    const __grid_constant__ CUtensorMap map_c,
                    const __grid_constant__ CUtensorMap map_dsh,
                    const __grid_constant__ CUtensorMap map_dsl, const float* __restrict__ gcs,
                    bf16* __restrict__ ddtx, float* __restrict__ cc, float* __restrict__ qq,
                    float* __restrict__ dBp, int lp, int H, int L, int nc, int g, int groups) {
  using Cf = Cfg<DH, DS>;
  constexpr int S = Cf::kStages, kRes = Cf::kRes, kX = Cf::kX, kSlotB = Cf::kSlotB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Bsm = hopper::align_smem(smem_raw);  // B_j
  unsigned char* Xs = Bsm + kRes;                     // 2 stages: X_j^h
  unsigned char* As = Xs + 2 * kX;                    // S stages of slot A: dy_i^h
  unsigned char* Ss = As + S * kX;                    // S stages of slot B: C_i or dS^h's term
  float* cs2 = reinterpret_cast<float*>(Ss + S * kSlotB);  // [g][L]
  uint64_t* b_full = reinterpret_cast<uint64_t*>(cs2 + g * L);
  uint64_t* x_full = b_full + 1;
  uint64_t* x_empty = x_full + 2;
  uint64_t* full = x_empty + 2;
  uint64_t* empty = full + S;

  const int nrt = L / 64, jt = blockIdx.y;  // the first column tiles walk the most row tiles
  const int grp = blockIdx.x % groups, bc = blockIdx.x / groups, c = bc % nc, b = bc / nc;
  const int h0 = grp * g, gh = min(g, H - h0), j0 = jt * 64, p0 = c * L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    hopper::mbar_init(b_full, 1);
    for (int k = 0; k < 2; ++k) {
      hopper::mbar_init(&x_full[k], 1);
      hopper::mbar_init(&x_empty[k], kConsumers / 32);
    }
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer warp
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(b_full, kRes);
      for (int a = 0; a < DS / 64; ++a)
        hopper::tma_load_3d(Bsm + a * 64 * 128, &map_b, b_full, a * 64, p0 + j0, b);
      int n = 0;
      auto stage = [&](int bytes) {
        const int s = n % S;
        if (n >= S) hopper::mbar_wait(&empty[s], ((n / S) - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], bytes);
        ++n;
        return s;
      };
      for (int hh = 0; hh < gh; ++hh) {
        const int sx = hh & 1;
        if (hh >= 2) hopper::mbar_wait(&x_empty[sx], ((hh >> 1) - 1) & 1);
        hopper::mbar_arrive_expect_tx(&x_full[sx], kX);
        for (int a = 0; a < DH / 64; ++a)
          hopper::tma_load_4d(Xs + sx * kX + a * 64 * 128, &map_x, &x_full[sx], a * 64, h0 + hh,
                              p0 + j0, b);
        const int slot = (b * nc + c) * H + h0 + hh;
        for (int part = 0; part < (Cf::kTwoPasses ? 4 : 2); ++part) {
          const int s = stage(kSlotB);
          for (int a = 0; a < DH / 64; ++a)
            hopper::tma_load_3d(Ss + s * kSlotB + a * DS * 128, part & 1 ? &map_dsl : &map_dsh,
                                &full[s], a * 64, 0, slot);
        }
        for (int i = jt; i < nrt; ++i) {
          const int s = stage(kX + kRes);
          for (int a = 0; a < DH / 64; ++a)
            hopper::tma_load_4d(As + s * kX + a * 64 * 128, &map_dy, &full[s], a * 64, h0 + hh,
                                p0 + i * 64, b);
          for (int a = 0; a < DS / 64; ++a)
            hopper::tma_load_3d(Ss + s * kSlotB + a * 64 * 128, &map_c, &full[s], a * 64,
                                p0 + i * 64, b);
        }
      }
    }
    return;
  }

  for (int k = threadIdx.x; k < gh * L; k += kConsumers)
    cs2[k] = gcs[(static_cast<size_t>(b) * H + h0 + k / L) * lp + p0 + k % L] * kLog2e;
  consumer_sync();
  const int r_lo = 16 * warp + (lane >> 2), r_hi = r_lo + 8, qd = 2 * (lane & 3);
  const size_t xrow = static_cast<size_t>(H) * DH;

  float dB[DS / 2];
#pragma unroll
  for (int k = 0; k < DS / 2; ++k) dB[k] = 0.f;
  hopper::mbar_wait(b_full, 0);
  int n = 0;
  for (int hh = 0; hh < gh; ++hh) {
    const int sx = hh & 1;
    hopper::mbar_wait(&x_full[sx], (hh >> 1) & 1);
    const unsigned char* Xt = Xs + sx * kX;
    const float* c2 = cs2 + hh * L;
    const float total = c2[L - 1];
    const float cj_lo = c2[j0 + r_lo], cj_hi = c2[j0 + r_hi];
    const float eb_lo = hopper::exp2_approx(total - cj_lo);
    const float eb_hi = hopper::exp2_approx(total - cj_hi);
    // the decayed term: dX = (B_j o e^{T-cs}) dS (A from registers, hi + lo)
    // and F = X_j dS^T, over dS's hi and lo terms (twice at ds 128: F, then dX)
    float F[DS / 2], dX[DH / 2];
    using On = std::true_type;
    using Off = std::false_type;
    auto items = [&](auto with_f, auto with_x) {
      uint32_t bh[DS / 16][4], bl[DS / 16][4];
      if constexpr (decltype(with_x)::value) {
#pragma unroll
        for (int k = 0; k < DS / 2; k += 2) {
          const bool hi = k & 2;
          const float e = hi ? eb_hi : eb_lo;
          const float2 bv = ld_pair(Bsm, 64, hi ? r_hi : r_lo, 8 * (k / 4) + qd);
          split2(bv.x * e, bv.y * e, bh[k / 8][(k % 8) / 2], bl[k / 8][(k % 8) / 2]);
        }
      }
      for (int part = 0; part < 2; ++part, ++n) {
        const int s = n % S;
        hopper::mbar_wait(&full[s], (n / S) & 1);
        const unsigned char* St = Ss + s * kSlotB;
        hopper::wgmma_fence();
        if constexpr (decltype(with_f)::value) {
#pragma unroll
          for (int kk = 0; kk < DH / 16; ++kk)
            hopper::wgmma_ss<DS, 0>(F, desc_k(Xt, 64, kk), desc_k(St, DS, kk), part > 0 || kk > 0);
        }
        if constexpr (decltype(with_x)::value) {
#pragma unroll
          for (int kk = 0; kk < DS / 16; ++kk) {
            hopper::wgmma_rs<DH, 1>(dX, bh[kk], desc_mn(St, DS, kk), part > 0 || kk > 0);
            if (part == 0) hopper::wgmma_rs<DH, 1>(dX, bl[kk], desc_mn(St, DS, kk), 1);
          }
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(F);
        hopper::fence_regs(dX);
        release(&empty[s]);
      }
    };
    if constexpr (Cf::kTwoPasses)
      items(On{}, Off{});
    else
      items(On{}, On{});
    // F o e^{T-cs}: dB's decayed term, and q = <F o e^{T-cs}, B_j>
    float q_lo = 0.f, q_hi = 0.f;
#pragma unroll
    for (int k = 0; k < DS / 2; k += 2) {
      const bool hi = k & 2;
      const float e = hi ? eb_hi : eb_lo;
      const float2 bv = ld_pair(Bsm, 64, hi ? r_hi : r_lo, 8 * (k / 4) + qd);
      const float v0 = F[k] * e, v1 = F[k + 1] * e;
      dB[k] += v0;
      dB[k + 1] += v1;
      float& acc = hi ? q_hi : q_lo;
      acc = fmaf(v0, bv.x, acc);
      acc = fmaf(v1, bv.y, acc);
    }
    q_lo = quad_sum(q_lo);
    q_hi = quad_sum(q_hi);
    if constexpr (Cf::kTwoPasses) items(Off{}, On{});

    // the row tiles i >= j
    float G[32], dM[32], p_lo = 0.f, p_hi = 0.f;
    uint32_t mr[4][4], gh_[4][4], gl_[4][4];
    for (int i = jt; i < nrt; ++i, ++n) {
      const int s = n % S;
      hopper::mbar_wait(&full[s], (n / S) & 1);
      const unsigned char* Yt = As + s * kX;
      const unsigned char* Ct = Ss + s * kSlotB;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DS / 16; ++kk)
        hopper::wgmma_ss<64, 0>(G, desc_k(Bsm, 64, kk), desc_k(Ct, 64, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        hopper::wgmma_ss<64, 0>(dM, desc_k(Xt, 64, kk), desc_k(Yt, 64, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(G);
      hopper::fence_regs(dM);
      const bool diag = i == jt;
#pragma unroll
      for (int k = 0; k < 32; k += 2) {
        const bool hi = k & 2;
        const int row = hi ? r_hi : r_lo, col = 8 * (k / 4) + qd;
        const float cj = hi ? cj_hi : cj_lo;
        const float2 ci = *reinterpret_cast<const float2*>(c2 + i * 64 + col);
        float d0 = hopper::exp2_approx(ci.x - cj), d1 = hopper::exp2_approx(ci.y - cj);
        if (diag) {  // j <= i: row <= column
          if (row > col) d0 = 0.f;
          if (row > col + 1) d1 = 0.f;
        }
        G[k] *= d0;  // M^T
        G[k + 1] *= d1;
        const float dp0 = dM[k] * G[k], dp1 = dM[k + 1] * G[k + 1];
        dM[k] *= d0;  // dG^T
        dM[k + 1] *= d1;
        float& acc = hi ? p_hi : p_lo;
        acc += dp0;
        acc += dp1;
      }
      hopper::pack_a(mr, G);
      pack_a_split(gh_, gl_, dM);
      hopper::fence_regs(dX);
      hopper::fence_regs(dB);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::wgmma_rs<DH, 1>(dX, mr[kk], desc_mn(Yt, 64, kk), 1);
        hopper::wgmma_rs<DS, 1>(dB, gh_[kk], desc_mn(Ct, 64, kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hopper::wgmma_rs<DS, 1>(dB, gl_[kk], desc_mn(Ct, 64, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dX);
      hopper::fence_regs(dB);
      release(&empty[s]);
    }
    release(&x_empty[sx]);
    p_lo = quad_sum(p_lo);
    p_hi = quad_sum(p_hi);
    const size_t at = (static_cast<size_t>(b) * H + h0 + hh) * lp + p0 + j0;
    if ((lane & 3) == 0) {
      cc[at + r_lo] = p_lo;
      cc[at + r_hi] = p_hi;
      qq[at + r_lo] = q_lo;
      qq[at + r_hi] = q_hi;
    }
    bf16* xo = ddtx + (static_cast<size_t>(b) * lp + p0 + j0) * xrow +
               static_cast<size_t>(h0 + hh) * DH;
#pragma unroll
    for (int k = 0; k < DH / 2; k += 2) {
      const int row = (k & 2) ? r_hi : r_lo, col = 8 * (k / 4) + qd;
      *reinterpret_cast<__nv_bfloat162*>(xo + row * xrow + col) =
          __floats2bfloat162_rn(dX[k], dX[k + 1]);
    }
  }
  float* out = dBp + ((static_cast<size_t>(b) * groups + grp) * lp + p0 + j0) * DS;
#pragma unroll
  for (int k = 0; k < DS / 2; k += 2) {
    const int row = (k & 2) ? r_hi : r_lo, col = 8 * (k / 4) + qd;
    *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * DS + col) =
        make_float2(dB[k], dB[k + 1]);
  }
}

// Chunk U on wgmma: a block a (batch x chunk x head group). The chunk's C
// [L x ds] stays in shared memory and is A = C^T, read MN-major in place;
// each head's dy arrives in 64-row pieces through the TMA ring, and the
// consumers form B' = e^{cs} o dy as bf16 hi + lo pieces (at the same
// swizzled byte offsets, double-buffered), so U = C^T B'_hi + C^T B'_lo,
// accumulated over the pieces in order with one product group in flight.
// Each head's cs is the forward's serial sum (chunk_cumsum), as on the edge
// route.
__host__ __device__ inline size_t smem_chunk_u(int dh, int ds, int L, int g) {
  return static_cast<size_t>(L) * ds * 2 + static_cast<size_t>(4 + 4) * 64 * dh * 2 +
         static_cast<size_t>(g) * L * 4 + 9 * 8 + hopper::kSmemAlign;
}

template <int DH, int DS>
__global__ void __launch_bounds__(kWgThreads, 1)
scan_bwd_chunk_u_wgmma(const __grid_constant__ CUtensorMap map_dy,
                       const __grid_constant__ CUtensorMap map_c, const float* __restrict__ la,
                       float* __restrict__ gcs, float* __restrict__ st, int lp, int H, int L,
                       int nc, int g, int groups) {
  constexpr int S = 4, kX = 64 * DH * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Cs = hopper::align_smem(smem_raw);  // DS / 64 atoms of L rows
  unsigned char* Ys = Cs + L * DS * 2;               // S stages: 64-row pieces of dy
  unsigned char* Ps = Ys + S * kX;                   // 2 buffers of (hi, lo) pieces
  float* cs = reinterpret_cast<float*>(Ps + 4 * kX);  // [g][L]
  uint64_t* c_full = reinterpret_cast<uint64_t*>(cs + g * L);
  uint64_t* full = c_full + 1;
  uint64_t* empty = full + S;

  const int grp = blockIdx.x % groups, bc = blockIdx.x / groups, c = bc % nc, b = bc / nc;
  const int h0 = grp * g, gh = min(g, H - h0), p0 = c * L, npc = L / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    hopper::mbar_init(c_full, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer warp
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(c_full, L * DS * 2);
      for (int a = 0; a < DS / 64; ++a)
        for (int r = 0; r < npc; ++r)
          hopper::tma_load_3d(Cs + a * L * 128 + r * 64 * 128, &map_c, c_full, a * 64,
                              p0 + r * 64, b);
      for (int n = 0; n < gh * npc; ++n) {
        const int s = n % S;
        if (n >= S) hopper::mbar_wait(&empty[s], ((n / S) - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], kX);
        for (int a = 0; a < DH / 64; ++a)
          hopper::tma_load_4d(Ys + s * kX + a * 64 * 128, &map_dy, &full[s], a * 64,
                              h0 + n / npc, p0 + (n % npc) * 64, b);
      }
    }
    return;
  }

  for (int k = threadIdx.x; k < gh * L; k += kConsumers)
    cs[k] = la[(static_cast<size_t>(b) * H + h0 + k / L) * lp + p0 + k % L];
  consumer_sync();
  if (threadIdx.x < gh)
    chunk_cumsum(cs + threadIdx.x * L, gcs + (static_cast<size_t>(b) * H + h0 + threadIdx.x) * lp + p0,
                 L);
  consumer_sync();
  for (int k = threadIdx.x; k < gh * L; k += kConsumers) cs[k] = expf(cs[k]);
  consumer_sync();
  hopper::mbar_wait(c_full, 0);

  const int r_lo = 16 * warp + (lane >> 2), r_hi = r_lo + 8, qd = 2 * (lane & 3);
  float U[DS / 64][DH / 2];
  int n = 0;
  for (int hh = 0; hh < gh; ++hh) {
    const float* e = cs + hh * L;
    for (int pc = 0; pc < npc; ++pc, ++n) {
      const int s = n % S;
      hopper::mbar_wait(&full[s], (n / S) & 1);
      // the product group that read this buffer (two items back) is done
      unsigned char* Ph = Ps + (n & 1) * 2 * kX;
      unsigned char* Pl = Ph + kX;
      const unsigned char* Yt = Ys + s * kX;
      for (int q = threadIdx.x; q < kX / 16; q += kConsumers) {
        const int off = q * 16;
        const float ep = e[pc * 64 + (off % (64 * 128)) / 128];
        float v[8];
        unpack<bf16>(*reinterpret_cast<const uint4*>(Yt + off), v);
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) split2(v[2 * k] * ep, v[2 * k + 1] * ep, hi[k], lo[k]);
        *reinterpret_cast<uint4*>(Ph + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(Pl + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
      hopper::fence_proxy_async();
      consumer_sync();
      release(&empty[s]);
#pragma unroll
      for (int mt = 0; mt < DS / 64; ++mt) hopper::fence_regs(U[mt]);
      hopper::wgmma_fence();
#pragma unroll
      for (int mt = 0; mt < DS / 64; ++mt)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da =
              hopper::desc_sw128(Cs + mt * L * 128 + (pc * 64 + kk * 16) * 128, L * 128, 1024);
          hopper::wgmma_ss<DH, 1, 1>(U[mt], da, desc_mn(Ph, 64, kk), pc > 0 || kk > 0);
          hopper::wgmma_ss<DH, 1, 1>(U[mt], da, desc_mn(Pl, 64, kk), 1);
        }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
#pragma unroll
      for (int mt = 0; mt < DS / 64; ++mt) hopper::fence_regs(U[mt]);
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < DS / 64; ++mt) hopper::fence_regs(U[mt]);
    float* out = st + ((static_cast<size_t>(b) * nc + c) * H + h0 + hh) * DS * DH;
#pragma unroll
    for (int mt = 0; mt < DS / 64; ++mt)
#pragma unroll
      for (int k = 0; k < DH / 2; k += 2) {
        const int row = mt * 64 + ((k & 2) ? r_hi : r_lo), col = 8 * (k / 4) + qd;
        *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * DH + col) =
            make_float2(U[mt][k], U[mt][k + 1]);
      }
  }
}

// [batch, lp, H, D] as a 4-D map (innermost first): a box is 64 columns of
// one head over 64 rows of one batch
int map_x4(CUtensorMap* m, const void* base, int batch, int lp, int H, int D) {
  const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(H),
                            static_cast<uint64_t>(lp), static_cast<uint64_t>(batch)};
  const uint64_t strides[3] = {dims[0] * 2, dims[1] * dims[0] * 2, dims[2] * dims[1] * dims[0] * 2};
  const uint32_t box[4] = {64, 1, 64, 1};
  return hopper::bf16_map(m, base, 4, dims, strides, box);
}
// [batch, lp, ds]: a box is 64 columns over 64 rows
int map_bc3(CUtensorMap* m, const void* base, int batch, int lp, int ds) {
  const uint64_t dims[3] = {static_cast<uint64_t>(ds), static_cast<uint64_t>(lp),
                            static_cast<uint64_t>(batch)};
  const uint64_t strides[2] = {dims[0] * 2, dims[1] * dims[0] * 2};
  const uint32_t box[3] = {64, 64, 1};
  return hopper::bf16_map(m, base, 3, dims, strides, box);
}
// [slots, ds, dh] (a bf16 plane of the state pass): a box is 64 columns of
// one slot's ds rows
int map_st3(CUtensorMap* m, const void* base, size_t slots, int ds, int dh) {
  const uint64_t dims[3] = {static_cast<uint64_t>(dh), static_cast<uint64_t>(ds),
                            static_cast<uint64_t>(slots)};
  const uint64_t strides[2] = {dims[0] * 2, dims[1] * dims[0] * 2};
  const uint32_t box[3] = {64, static_cast<uint32_t>(ds), 1};
  return hopper::bf16_map(m, base, 3, dims, strides, box);
}

// The two tiled launches; planes: dS hi, dS lo, S_prev hi, S_prev lo.
template <int DH, int DS>
int launch(const bf16* x, const bf16* B, const bf16* C, const bf16* dy, const float* gcs,
           const bf16* planes, float* rr, float* cc, float* qq, float* dBp, float* dCp,
           bf16* ddtx, int batch, int lp, int H, int L, cudaStream_t s) {
  const int nc = lp / L, nrt = L / 64;
  const int g = heads_a_block(H, static_cast<long long>(batch) * nc * nrt);
  const int groups = (H + g - 1) / g;
  const size_t slots = static_cast<size_t>(batch) * nc * H, plane = slots * DS * DH;
  CUtensorMap mx, mdy, mb, mc, m0, m1, m2, m3;
  int e = map_x4(&mx, x, batch, lp, H, DH);
  if (e == 0) e = map_x4(&mdy, dy, batch, lp, H, DH);
  if (e == 0) e = map_bc3(&mb, B, batch, lp, DS);
  if (e == 0) e = map_bc3(&mc, C, batch, lp, DS);
  if (e == 0) e = map_st3(&m0, planes, slots, DS, DH);
  if (e == 0) e = map_st3(&m1, planes + plane, slots, DS, DH);
  if (e == 0) e = map_st3(&m2, planes + 2 * plane, slots, DS, DH);
  if (e == 0) e = map_st3(&m3, planes + 3 * plane, slots, DS, DH);
  if (e != 0) return e;
  const size_t sr = smem_rows(DH, DS, L, g), sc = smem_cols(DH, DS, L, g);
  if ((e = set_smem(scan_bwd_rows_wgmma<DH, DS>, sr)) != 0) return e;
  if ((e = set_smem(scan_bwd_cols_wgmma<DH, DS>, sc)) != 0) return e;
  const dim3 grid(static_cast<unsigned>(batch) * nc * groups, nrt);
  scan_bwd_rows_wgmma<DH, DS><<<grid, kWgThreads, sr, s>>>(mx, mdy, mb, mc, m2, m3, gcs, rr, dCp,
                                                          lp, H, L, nc, g, groups);
  if ((e = static_cast<int>(cudaGetLastError())) != 0) return e;
  scan_bwd_cols_wgmma<DH, DS><<<grid, kWgThreads, sc, s>>>(mx, mdy, mb, mc, m0, m1, gcs, ddtx, cc,
                                                          qq, dBp, lp, H, L, nc, g, groups);
  PTT_RETURN_LAUNCH_ERROR();
}

// Chunk U's launch: each chunk's cs into gcs and U into st.
template <int DH, int DS>
int launch_u(const bf16* dy, const bf16* C, const float* la, float* gcs, float* st, int batch,
             int lp, int H, int L, cudaStream_t s) {
  const int nc = lp / L;
  const int g = heads_a_block(H, static_cast<long long>(batch) * nc), groups = (H + g - 1) / g;
  CUtensorMap mdy, mc;
  int e = map_x4(&mdy, dy, batch, lp, H, DH);
  if (e == 0) e = map_bc3(&mc, C, batch, lp, DS);
  if (e != 0) return e;
  const size_t su = smem_chunk_u(DH, DS, L, g);
  if ((e = set_smem(scan_bwd_chunk_u_wgmma<DH, DS>, su)) != 0) return e;
  scan_bwd_chunk_u_wgmma<DH, DS><<<static_cast<unsigned>(batch) * nc * groups, kWgThreads, su, s>>>(
      mdy, mc, la, gcs, st, lp, H, L, nc, g, groups);
  PTT_RETURN_LAUNCH_ERROR();
}

}  // namespace wgb

// The wgmma route's rule (ops/kernels/selective_scan.py:bwd_route): bf16,
// dh and ds 64 or 128, chunks of whole 64-row tiles, 16-byte-aligned bases.
inline bool wgmma_ok(int dtype, int dh, int ds, int L, const void* const* bases, int n) {
  uintptr_t bits = 0;
  for (int k = 0; k < n; ++k) bits |= reinterpret_cast<uintptr_t>(bases[k]);
  return dtype == PTT_BF16 && (dh == 64 || dh == 128) && (ds == 64 || ds == 128) && L % 64 == 0 &&
         bits % 16 == 0;
}

int launch_bwd_wgmma(const __nv_bfloat16* x, const float* la, const __nv_bfloat16* B,
                     const __nv_bfloat16* C, const float* states, const __nv_bfloat16* dy,
                     const float* dsf, __nv_bfloat16* ddtx, float* dla, __nv_bfloat16* dB,
                     __nv_bfloat16* dC, float* scratch, int batch, int lp, int H, int dh, int ds,
                     int L, cudaStream_t s) {
  using bf = __nv_bfloat16;
  const int nc = lp / L, nrt = L / 64;
  const int g = wgb::heads_a_block(H, static_cast<long long>(batch) * nc * nrt);
  const int groups = (H + g - 1) / g;
  const size_t ncs = static_cast<size_t>(batch) * H * lp;
  const size_t nst = static_cast<size_t>(batch) * nc * H * ds * dh;
  const size_t npart = static_cast<size_t>(batch) * groups * lp * ds;
  float* gcs = scratch;
  float* st = gcs + ncs;
  float* rr = st + nst;
  float* cc = rr + ncs;
  float* qq = cc + ncs;
  float* dBp = qq + ncs;
  float* dCp = dBp + npart;
  bf* planes = reinterpret_cast<bf*>(dCp + npart);
  int e;
  if (dh == 64 && ds == 64)
    e = wgb::launch_u<64, 64>(dy, C, la, gcs, st, batch, lp, H, L, s);
  else if (dh == 64)
    e = wgb::launch_u<64, 128>(dy, C, la, gcs, st, batch, lp, H, L, s);
  else if (ds == 64)
    e = wgb::launch_u<128, 64>(dy, C, la, gcs, st, batch, lp, H, L, s);
  else
    e = wgb::launch_u<128, 128>(dy, C, la, gcs, st, batch, lp, H, L, s);
  if (e != 0) return e;
  const size_t n = static_cast<size_t>(batch) * H * ds * dh;
  scan_bwd_state_pass<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      gcs, st, dsf, batch, lp, H, dh, ds, L, states, planes);
  if ((e = static_cast<int>(cudaGetLastError())) != 0) return e;
  if (dh == 64 && ds == 64)
    e = wgb::launch<64, 64>(x, B, C, dy, gcs, planes, rr, cc, qq, dBp, dCp, ddtx, batch, lp, H, L, s);
  else if (dh == 64)
    e = wgb::launch<64, 128>(x, B, C, dy, gcs, planes, rr, cc, qq, dBp, dCp, ddtx, batch, lp, H, L, s);
  else if (ds == 64)
    e = wgb::launch<128, 64>(x, B, C, dy, gcs, planes, rr, cc, qq, dBp, dCp, ddtx, batch, lp, H, L, s);
  else
    e = wgb::launch<128, 128>(x, B, C, dy, gcs, planes, rr, cc, qq, dBp, dCp, ddtx, batch, lp, H, L, s);
  if (e != 0) return e;
  scan_bwd_dla<<<dim3(nc, batch * H), kThreads, 0, s>>>(gcs, st, states, rr, cc, qq, dla, lp, H,
                                                        dh, ds, L);
  if ((e = static_cast<int>(cudaGetLastError())) != 0) return e;
  const size_t nb = static_cast<size_t>(batch) * lp * ds;
  scan_bwd_dbc<bf><<<static_cast<unsigned>((nb + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      dBp, dCp, dB, dC, batch, lp, groups, ds);
  PTT_RETURN_LAUNCH_ERROR();
}

template <typename T>
int launch_bwd(const T* x, const float* la, const T* B, const T* C, const float* states,
               const T* dy, const float* dsf, T* ddtx, float* dla, T* dB, T* dC, float* scratch,
               int batch, int lp, int H, int dh, int ds, int L, cudaStream_t s) {
  const int E = sizeof(T), R = bwd_tile_rows(L, dh, ds, E);
  if (R == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nc = lp / L, nrt = (L + R - 1) / R;
  const size_t ncs = static_cast<size_t>(batch) * H * lp;
  float* gcs = scratch;
  float* st = gcs + ncs;
  float* rr = st + static_cast<size_t>(batch) * nc * H * ds * dh;
  float* cc = rr + ncs;
  float* qq = cc + ncs;
  float* dBp = qq + ncs;
  float* dCp = dBp + ncs * ds;
  int e;
  const size_t su = bwd_u_smem(L, dh, ds, R, E), sr = bwd_rows_smem(L, dh, ds, R, E),
               sc = bwd_cols_smem(L, dh, ds, R, E);
  if ((e = set_smem(scan_bwd_chunk_u<T>, su)) != 0) return e;
  if ((e = set_smem(scan_bwd_rows<T>, sr)) != 0) return e;
  if ((e = set_smem(scan_bwd_cols<T>, sc)) != 0) return e;
  scan_bwd_chunk_u<T><<<dim3(nc, batch, H), kThreads, su, s>>>(la, C, dy, gcs, st, lp, H, dh,
                                                               ds, L, R);
  if ((e = static_cast<int>(cudaGetLastError())) != 0) return e;
  const size_t n = static_cast<size_t>(batch) * H * ds * dh;
  scan_bwd_state_pass<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      gcs, st, dsf, batch, lp, H, dh, ds, L, nullptr, nullptr);
  if ((e = static_cast<int>(cudaGetLastError())) != 0) return e;
  scan_bwd_rows<T><<<dim3(nrt, nc, batch * H), kThreads, sr, s>>>(x, B, C, gcs, states, dy, rr,
                                                                  dCp, lp, H, dh, ds, L, R);
  if ((e = static_cast<int>(cudaGetLastError())) != 0) return e;
  scan_bwd_cols<T><<<dim3(nrt, nc, batch * H), kThreads, sc, s>>>(
      x, B, C, gcs, st, dy, ddtx, cc, qq, dBp, lp, H, dh, ds, L, R);
  if ((e = static_cast<int>(cudaGetLastError())) != 0) return e;
  scan_bwd_dla<<<dim3(nc, batch * H), kThreads, 0, s>>>(gcs, st, states, rr, cc, qq, dla, lp, H,
                                                        dh, ds, L);
  if ((e = static_cast<int>(cudaGetLastError())) != 0) return e;
  const size_t nb = static_cast<size_t>(batch) * lp * ds;
  scan_bwd_dbc<T><<<static_cast<unsigned>((nb + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      dBp, dCp, dB, dC, batch, lp, H, ds);
  PTT_RETURN_LAUNCH_ERROR();
}

}  // namespace

// dtx: [batch, lp, H, dh] (dtype); la: [batch, H, lp] fp32; B, C: [batch, lp,
// ds] (dtype); y like dtx; state: [batch, H, ds, dh] fp32; scratch the
// wrapper allocates: cs [batch, H, lp] fp32, st [batch, lp / L, H, ds, dh]
// fp32. lp a multiple of L; L a multiple of 16 up to 256; dh and ds
// multiples of 8 (bf16: dh and ds at most 128).
extern "C" int ptt_selective_scan(const void* dtx, const void* la, const void* B,
                                  const void* C, void* y, void* state, void* cs,
                                  void* st, int batch, int lp, int H, int dh, int ds,
                                  int L, int dtype, void* stream) {
  if (L < 16 || L > kMaxChunk || L % 16 != 0 || lp % L != 0 || dh % 8 != 0 ||
      ds % 8 != 0 || (dtype == PTT_BF16 && (dh > 128 || ds > 128)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || H == 0 || lp == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = lp / L;
  const int g1 = head_groups(H, static_cast<long long>(nc) * batch);
  const float* lf = static_cast<const float*>(la);
  float* sf = static_cast<float*>(state);
  float* csf = static_cast<float*>(cs);
  float* stf = static_cast<float*>(st);
  if (dtype == PTT_F32) {
    const float* x = static_cast<const float*>(dtx);
    int e = launch_state(scan_chunk_state_f32, state_smem_f32(L, dh, ds, H / g1), g1, x, lf,
                         static_cast<const float*>(B), sf, csf, stf, batch, lp, H, dh, ds, L, s);
    if (e != 0) return e;
    const int R = row_tile(L), nrt = (L + R - 1) / R;
    const int g3 = head_groups(H, static_cast<long long>(nc) * batch * nrt);
    const size_t smem = out_smem_f32(L, dh, ds);
    if (smem > static_cast<size_t>(kSmemLimit)) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t ce = cudaFuncSetAttribute(
        scan_chunk_out_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (ce != cudaSuccess) return static_cast<int>(ce);
    scan_chunk_out_f32<<<dim3(nrt, nc, batch * g3), kThreads, smem, s>>>(
        x, static_cast<const float*>(B), static_cast<const float*>(C), csf, stf,
        static_cast<float*>(y), lp, H, dh, ds, L, H / g3);
    PTT_RETURN_LAUNCH_ERROR();
  }
  if (dtype == PTT_BF16) {
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(dtx);
    const __nv_bfloat16* Bb = static_cast<const __nv_bfloat16*>(B);
    const __nv_bfloat16* Cb = static_cast<const __nv_bfloat16*>(C);
    __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
    int e = launch_state(scan_chunk_state_bf16, state_smem_bf16(L, dh, ds, H / g1), g1, x, lf,
                         Bb, sf, csf, stf, batch, lp, H, dh, ds, L, s);
    if (e != 0) return e;
    if (dh <= 32) return launch_out_bf16<4>(x, Bb, Cb, csf, stf, yb, batch, lp, H, dh, ds, L, s);
    if (dh <= 64) return launch_out_bf16<8>(x, Bb, Cb, csf, stf, yb, batch, lp, H, dh, ds, L, s);
    return launch_out_bf16<16>(x, Bb, Cb, csf, stf, yb, batch, lp, H, dh, ds, L, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The gradient of the call above (the backward's comment): dtx, la, B, C as
// the forward took them; states [batch, lp / L, H, ds, dh] fp32, the state
// entering each chunk (the forward's st scratch after its call); dy like
// dtx; dsf [batch, H, ds, dh] fp32 the final state's cotangent, or null for
// zeros. Outputs ddtx like dtx, dla like la, dB and dC like B. scratch, the
// wrapper's: cs and U / dS as the forward's, then r, c, q [batch, H, lp] and
// the heads' dB and dC partials [batch, H, lp, ds], all fp32; tma 1 (the
// wgmma route): cs, U / dS, r, c, q, the groups' dB and dC partials
// [batch, groups, lp, ds] fp32, then the state pass's four bf16 planes of
// [batch, lp / L, H, ds, dh] (ops/kernels/selective_scan.py:bwd_scratch_floats).
// tma 1 takes the wgmma kernels (bf16, dh and ds 64 or 128, L a multiple of
// 64, 16-byte-aligned dtx, B, C and dy); tma 0 the mma.sync (bf16) or
// CUDA-core (fp32) kernels. The wrapper picks the route before the launch.
extern "C" int ptt_selective_scan_bwd(const void* dtx, const void* la, const void* B,
                                      const void* C, const void* states, const void* dy,
                                      const void* dsf, void* ddtx, void* dla, void* dB,
                                      void* dC, void* scratch, int batch, int lp, int H,
                                      int dh, int ds, int L, int dtype, int tma, void* stream) {
  if (L < 16 || L > kMaxChunk || L % 16 != 0 || lp % L != 0 || dh % 8 != 0 ||
      ds % 8 != 0 || (dtype == PTT_BF16 && (dh > 128 || ds > 128)))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* bases[4] = {dtx, B, C, dy};
  if (tma && !wgmma_ok(dtype, dh, ds, L, bases, 4)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || H == 0 || lp == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(la);
  const float* sf = static_cast<const float*>(states);
  const float* dsff = static_cast<const float*>(dsf);
  float* dlaf = static_cast<float*>(dla);
  float* scr = static_cast<float*>(scratch);
  if (tma) {
    using bf = __nv_bfloat16;
    return launch_bwd_wgmma(static_cast<const bf*>(dtx), lf, static_cast<const bf*>(B),
                            static_cast<const bf*>(C), sf, static_cast<const bf*>(dy), dsff,
                            static_cast<bf*>(ddtx), dlaf, static_cast<bf*>(dB),
                            static_cast<bf*>(dC), scr, batch, lp, H, dh, ds, L, s);
  }
  if (dtype == PTT_F32)
    return launch_bwd(static_cast<const float*>(dtx), lf, static_cast<const float*>(B),
                      static_cast<const float*>(C), sf, static_cast<const float*>(dy), dsff,
                      static_cast<float*>(ddtx), dlaf, static_cast<float*>(dB),
                      static_cast<float*>(dC), scr, batch, lp, H, dh, ds, L, s);
  if (dtype == PTT_BF16) {
    using bf = __nv_bfloat16;
    return launch_bwd(static_cast<const bf*>(dtx), lf, static_cast<const bf*>(B),
                      static_cast<const bf*>(C), sf, static_cast<const bf*>(dy), dsff,
                      static_cast<bf*>(ddtx), dlaf, static_cast<bf*>(dB), static_cast<bf*>(dC),
                      scr, batch, lp, H, dh, ds, L, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
