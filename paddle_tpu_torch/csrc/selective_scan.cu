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
// tensor-core operations of G, dM (each formed twice, below), Mr^T dy, dG B
// and dG^T C over the causal half; at the serving shape the fp32 operations.
//
// Schedule, chunk-parallel as the forward, no atomics (a repeat is bitwise):
//   1. scan_bwd_chunk_u (chunks x batch x heads): each chunk's cs (the
//      forward's serial sum, so its bits) and its own (C o e^{cs})^T dy.
//   2. scan_bwd_state_pass (an entry of dS a thread): the dS carry in reverse
//      chunk order, each chunk's slot becoming the cotangent leaving it.
//   3. scan_bwd_rows (row tiles x chunks x batch*heads): a tile of rows i
//      walks the column tiles j <= i: dC's rows and dP's row sums.
//   4. scan_bwd_cols (column tiles x chunks x batch*heads): a tile of columns
//      j walks the row tiles i >= j: dX's and dB's rows and dP's column
//      sums (the flash backward's dQ / dK-dV split: G and dM formed in both).
//   5. scan_bwd_dla (chunks x batch*heads): <dS, S_prev> and d_la.
//   6. scan_bwd_dbc: dB and dC summed over the heads' partials in head order.
// fp32 runs every product as FMA chains on the CUDA cores; bf16 on mma.sync
// (m16n8k16, fp32 accumulation), the fp32 operands (dG, S_prev, dS and the
// decay-scaled B and C) split into two bf16 terms (hi + lo) as the forward
// splits its own. Tiles are R rows (64, 32, 16, or 8 in fp32: the largest
// whose shared memory fits; ops/kernels/selective_scan.py:bwd_launch_plan
// mirrors the sums).

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

// 1. Each chunk's cs (into gcs) and U = (C o e^{cs})^T dy (into its slot of
//    st), over k-tiles of R positions.
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
//    the chunk; dsf (the final state's cotangent) may be null (zeros).
__global__ void __launch_bounds__(kThreads, 1) scan_bwd_state_pass(
    const float* __restrict__ gcs, float* __restrict__ st, const float* __restrict__ dsf,
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
        base[(c0 - k) * cstride] = s;
        s = expf(lg[k]) * s + u[k];
      }
    }
  }
}

// 3. A tile of rows i: (dy S_prev^T) o e^{cs} and its row sums with C, then
//    over the column tiles j <= i: G and dM, dP's row sums, dC += dG B_j.
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

// 4. A tile of columns j: (B o e^{T-cs}) dS, (X dS^T) o e^{T-cs} and q, then
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

// 6. dB and dC: the heads' fp32 partials summed in head order, rounded once.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) scan_bwd_dbc(
    const float* __restrict__ dBp, const float* __restrict__ dCp, T* __restrict__ dB,
    T* __restrict__ dC, int batch, int lp, int H, int ds) {
  const size_t per = static_cast<size_t>(lp) * ds;
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<size_t>(batch) * per) return;
  const size_t bb = i / per, e = i % per;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < H; ++h) {
    sb += dBp[(bb * H + h) * per + e];
    sc += dCp[(bb * H + h) * per + e];
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
      gcs, st, dsf, batch, lp, H, dh, ds, L);
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
// the heads' dB and dC partials [batch, H, lp, ds], all fp32
// (ops/kernels/selective_scan.py:bwd_scratch_floats).
extern "C" int ptt_selective_scan_bwd(const void* dtx, const void* la, const void* B,
                                      const void* C, const void* states, const void* dy,
                                      const void* dsf, void* ddtx, void* dla, void* dB,
                                      void* dC, void* scratch, int batch, int lp, int H,
                                      int dh, int ds, int L, int dtype, void* stream) {
  if (L < 16 || L > kMaxChunk || L % 16 != 0 || lp % L != 0 || dh % 8 != 0 ||
      ds % 8 != 0 || (dtype == PTT_BF16 && (dh > 128 || ds > 128)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || H == 0 || lp == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(la);
  const float* sf = static_cast<const float*>(states);
  const float* dsff = static_cast<const float*>(dsf);
  float* dlaf = static_cast<float*>(dla);
  float* scr = static_cast<float*>(scratch);
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
