// Exchanges between the ranks of one host through CUDA IPC: the ring's KV
// hop (#16), the tiled all-to-all (#15) and the comm-fused MoE dispatch +
// expert MLP (#17), all from paddle_tpu/ops/pallas/async_collectives.py.
//
// The TPU kernels drive remote DMA between chips from inside the kernel.
// On the card there is no remote DMA engine to drive from a kernel, so every
// exchange is a pull through CUDA IPC. Every rank owns one device buffer of
// two slots, exported with cudaIpcGetMemHandle; each rank maps its peers'
// buffers once (cudaIpcOpenMemHandle, lazy peer access, so ranks on other
// cards of the host are reached over NVLink). An exchange is:
//
//   1. stage: the rank copies what it sends into its own slot s
//      (ptt_ring_copy);
//   2. (host) the stage has finished on every rank: a stream synchronize and
//      a barrier of the group, the TPU kernels' entry barrier;
//   3. pull: one launch reads the peers' slot s (IPC-mapped).
//
// Slots alternate between exchanges, whichever of the three kernels makes
// them, so a pull still in flight never races the next stage: a rank
// restages slot s two exchanges later, after a barrier that every rank
// reached only once its pull of slot s had finished (step 2 of the exchange
// in between synchronizes the stream that ran it). No kernel ever waits on
// another process, so a fault on one rank cannot hang the card.
//
// #16, one hop of the ring-attention KV rotation (replaces
// _ring_rotate_kernel, called by ring_kv_rotate, async_collectives.py:294):
// the pull is ptt_ring_copy from the source rank's slot. Bound: bytes, K and
// V in once and out once.
//
// #15, the square tiled all-to-all (replaces _a2a_kernel, called by
// tiled_a2a, async_collectives.py:187): row block j of x lands as block
// `rank` on rank j, the semantics of lax.all_to_all(tiled=True). The pull,
// ptt_a2a_pull, is one launch over the w peer blocks (the rank's own block
// straight from x); blockIdx.y picks a block, starting at the rank's
// successor as the TPU kernel staggers its peers. Bound: bytes, x in once
// and the output out once.
//
// #17 comm-fused dispatch + expert MLP (replaces _fused_kernel, called by
// fused_a2a_expert_mlp, async_collectives.py:480): see ptt_fused_a2a_mlp
// below.
//
// The copies: up to kMaxSeg segments per launch, blockIdx.y picks one;
// 16-byte vectors in a grid-stride loop when every pointer and size allows
// it, bytes otherwise.
#include <string.h>

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSeg = 8;  // segments of one copy launch: the peers of #15

struct Segments {
  const unsigned char* src[kMaxSeg];
  unsigned char* dst[kMaxSeg];
  long long bytes[kMaxSeg];
};

template <bool kVec>
__global__ void __launch_bounds__(kThreads) ring_copy_kernel(Segments seg) {
  const int s = blockIdx.y;
  const long long n = seg.bytes[s];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (kVec) {
    const uint4* src = reinterpret_cast<const uint4*>(seg.src[s]);
    uint4* dst = reinterpret_cast<uint4*>(seg.dst[s]);
    for (long long i = first; i < n / 16; i += stride) dst[i] = src[i];
  } else {
    for (long long i = first; i < n; i += stride) seg.dst[s][i] = seg.src[s][i];
  }
}

// Launch the copy of seg's first n segments.
int copy_segments(const Segments& seg, int n, cudaStream_t stream) {
  bool vec = true;
  long long most = 0;
  for (int i = 0; i < n; ++i) {
    const uintptr_t bits = reinterpret_cast<uintptr_t>(seg.src[i]) |
                           reinterpret_cast<uintptr_t>(seg.dst[i]) |
                           static_cast<uintptr_t>(seg.bytes[i]);
    vec = vec && (bits % 16 == 0);
    most = seg.bytes[i] > most ? seg.bytes[i] : most;
  }
  const long long units = vec ? most / 16 : most;
  long long blocks = (units + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > 4 * 132 ? 4 * 132 : blocks);
  const dim3 grid(static_cast<unsigned>(blocks), n);
  if (vec)
    ring_copy_kernel<true><<<grid, kThreads, 0, stream>>>(seg);
  else
    ring_copy_kernel<false><<<grid, kThreads, 0, stream>>>(seg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bytes -> a device buffer and its 64-byte IPC handle (cudaIpcMemHandle_t).
extern "C" int ptt_ipc_alloc(int device, long long bytes, void** ptr, void* handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (err == cudaSuccess) {
    cudaIpcMemHandle_t h;
    err = cudaIpcGetMemHandle(&h, *ptr);
    if (err == cudaSuccess) memcpy(handle, &h, sizeof(h));
  }
  return static_cast<int>(err);
}

extern "C" int ptt_ipc_free(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaFree(ptr);
  return static_cast<int>(err);
}

// A peer's handle -> its buffer mapped into this process.
extern "C" int ptt_ipc_open(int device, const void* handle, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    cudaIpcMemHandle_t h;
    memcpy(&h, handle, sizeof(h));
    err = cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  }
  return static_cast<int>(err);
}

extern "C" int ptt_ipc_close(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaIpcCloseMemHandle(ptr);
  return static_cast<int>(err);
}

// Copy segment i (i < n, n in {1, 2}) of nbytes[i] from src[i] to dst[i].
extern "C" int ptt_ring_copy(const void* src0, void* dst0, long long n0,
                             const void* src1, void* dst1, long long n1, int n,
                             cudaStream_t stream) {
  if (n < 1 || n > 2) return static_cast<int>(cudaErrorInvalidValue);
  Segments seg{};
  seg.src[0] = static_cast<const unsigned char*>(src0);
  seg.dst[0] = static_cast<unsigned char*>(dst0);
  seg.bytes[0] = n0;
  seg.src[1] = static_cast<const unsigned char*>(src1);
  seg.dst[1] = static_cast<unsigned char*>(dst1);
  seg.bytes[1] = n > 1 ? n1 : 0;
  return copy_segments(seg, n, stream);
}

// #15's pull: out block j (block_bytes each, j < w) <- srcs[j], where srcs[j]
// is block `rank` of peer j's staged slot (x's own block for j == rank).
// Segment y of the launch is block (rank + 1 + y) % w: each rank starts at
// its successor, as the TPU kernel staggers its peers.
extern "C" int ptt_a2a_pull(const void* const* srcs, void* out, long long block_bytes,
                            int w, int rank, cudaStream_t stream) {
  if (w < 1 || w > kMaxSeg || rank < 0 || rank >= w)
    return static_cast<int>(cudaErrorInvalidValue);
  if (block_bytes == 0) return 0;
  Segments seg{};
  for (int y = 0; y < w; ++y) {
    const int j = (rank + 1 + y) % w;
    seg.src[y] = static_cast<const unsigned char*>(srcs[j]);
    seg.dst[y] = static_cast<unsigned char*>(out) + static_cast<long long>(j) * block_bytes;
    seg.bytes[y] = block_bytes;
  }
  return copy_segments(seg, w, stream);
}

// ---------------------------------------------------------------------------
// #17: the comm-fused MoE dispatch + expert SwiGLU MLP.
//
// Replaces paddle_tpu/ops/pallas/async_collectives.py:_fused_kernel (called
// by fused_a2a_expert_mlp, :480 -> pallas_call :547). Per chunk c the TPU
// kernel lands every peer's packed token tiles by remote DMA, gathers them
// expert-major through `inv`, and runs gate/up, silu(g)*u cast to the compute
// dtype, and the down projection with an fp32 accumulator over ffn tiles,
// while chunk c+1's DMA is in flight. The TPU kernel keeps g and u in fp32;
// this one rounds them to the compute dtype first, as the composed path's
// gmm2 outputs are, so that its rows equal the composed reference's, the
// row identity the reference's backward assumes (moe_a2a.py:255-262): the
// fp32 path is unchanged, and in bf16 the expert-parallel forward then
// equals the one-device path's on the card (a bf16 routing flip downstream
// of a rounding difference moves the gate's gradient by percents).
//
// Here every rank has staged its x_send [chunks*w*bucket, M] into its slot
// (the exchange protocol above), and the kernel reads the peers' slots
// directly: row src of chunk c's landing buffer (src < w*bucket) is row
// (c*w + rank)*bucket + src % bucket of peer src / bucket's slot. So the
// TPU kernel's "DMA of chunk c+1 behind chunk c's GEMMs" becomes loads of
// peer memory inside the GEMMs' own tile loads: a global read on one card,
// an NVLink read across cards. Sentinel rows (inv >= w*bucket) and rows past
// counts[c, e] read as zero, and a row tile at or past counts[c, e] writes
// zeros and does no math, as _emit does.
//
// Bound on the H100: operations. Every live row costs 6*M*F flops (gate,
// up, down); at the MoE training path (16,384 live rows a rank and layer,
// M 1024, F 704, bf16) that is ~71 GFLOP, ~0.072 ms at 989 TFLOP/s.
//
// Design: one block of 256 threads per (64-row tile, local expert, chunk).
// Phase 1 walks the ffn in 64-column tiles: for each, gate and up over
// K = M from one load of each gathered A tile (gmm2's point), then
// act = silu(g)*u rounded to the compute dtype into an act scratch (the
// block's own rows; F is 2816 in the layer-level run, too wide for shared
// memory at 64 rows, so the rows go through L2). Phase 2 walks the output
// in 64-column tiles: act @ wd[e] over K = F with an fp32 accumulator,
// rounded into y. Tiles, loads and the WMMA (bf16, tensor cores) and
// register-tile (fp32, CUDA cores, full fp32) inner loops are those of
// csrc/grouped_gemm.cu; each output element has one block and one summation
// order, so repeats are bitwise. This first version loads tiles with scalar
// loads and no pipelining; TMA, wgmma and keeping act in shared memory are
// later work.
namespace {

using namespace nvcuda;

constexpr int kPeers = kMaxSeg;
constexpr int kFM = 64, kFN = 64, kFK = 32;
constexpr int kFLDA = kFM + 8;  // As[kk][m]
constexpr int kFLDB = kFN + 8;  // Bs[kk][n]
constexpr int kFLDC = kFN + 4;  // Cs[m][n] fp32 staging

struct PeerSlots {
  const void* base[kPeers];
};

// silu(g) * u with the composed path's rounding points: gmm2 rounds g and u
// to T, torch's silu rounds its result to T, and the product is rounded to
// T on the store (torch's silu: v / (1 + exp(-v)) in fp32).
template <typename T> __device__ __forceinline__ float swiglu(float g, float u) {
  const float gt = round_through<T>(g);
  return round_through<T>(gt / (1.f + expf(-gt))) * round_through<T>(u);
}

// One [kFM x kFN] tile C = sum_kk A(m, kk) B_j(kk, n) for NB weight streams
// over depth `depth`, then store(m, n, value) for every element of the tile.
// With kSwiglu (NB == 2) the value is silu(C_0) * C_1 in fp32.
template <int NB, bool kSwiglu, typename T, class LoadA, class LoadB, class Store>
__device__ __forceinline__ void tile_gemm(unsigned char* smem, int depth, LoadA load_a,
                                          LoadB load_b, Store store) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  T* As = reinterpret_cast<T*>(smem);  // [kFK][kFLDA]
  T* Bs1 = As + kFK * kFLDA;           // [kFK][kFLDB]
  T* Bs2 = Bs1 + kFK * kFLDB;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, wm = warp & 3, wn = warp >> 2;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  FragC frag[kMma ? NB : 1][2];
  float acc[kMma ? 1 : NB][4][4];
  if constexpr (kMma) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      wmma::fill_fragment(frag[j][0], 0.f);
      wmma::fill_fragment(frag[j][1], 0.f);
    }
  } else {
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][r][c] = 0.f;
  }

  for (int k0 = 0; k0 < depth; k0 += kFK) {
    __syncthreads();  // the previous tile's (or the staging's) reads are done
    for (int i = tid; i < kFM * kFK; i += kThreads) {
      const int kk = i % kFK, m = i / kFK;
      As[kk * kFLDA + m] = k0 + kk < depth ? load_a(m, k0 + kk) : from_f<T>(0.f);
    }
    for (int i = tid; i < kFK * kFN; i += kThreads) {
      const int n = i % kFN, kk = i / kFN;
      const bool in = k0 + kk < depth;
      Bs1[kk * kFLDB + n] = in ? load_b(0, k0 + kk, n) : from_f<T>(0.f);
      if constexpr (NB == 2) Bs2[kk * kFLDB + n] = in ? load_b(1, k0 + kk, n) : from_f<T>(0.f);
    }
    __syncthreads();
    if constexpr (kMma) {
#pragma unroll
      for (int kk = 0; kk < kFK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa;
        wmma::load_matrix_sync(fa, As + kk * kFLDA + wm * 16, kFLDA);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, Bs1 + kk * kFLDB + wn * 32 + f * 16, kFLDB);
          wmma::mma_sync(frag[0][f], fa, fb, frag[0][f]);
          if constexpr (NB == 2) {
            wmma::load_matrix_sync(fb, Bs2 + kk * kFLDB + wn * 32 + f * 16, kFLDB);
            wmma::mma_sync(frag[NB - 1][f], fa, fb, frag[NB - 1][f]);
          }
        }
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < kFK; ++kk) {
        float ar[4], br[NB][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) ar[r] = to_f<T>(As[kk * kFLDA + ty * 4 + r]);
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            br[j][c] = to_f<T>((j == 0 ? Bs1 : Bs2)[kk * kFLDB + tx * 4 + c]);
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[j][r][c] = fmaf(ar[r], br[j][c], acc[j][r][c]);
      }
    }
  }

  if constexpr (kMma) {
    if constexpr (kSwiglu) {  // both accumulators share one element layout
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int t = 0; t < frag[0][f].num_elements; ++t)
          frag[0][f].x[t] = swiglu<T>(frag[0][f].x[t], frag[NB - 1][f].x[t]);
    }
    float* Cs = reinterpret_cast<float*>(smem);  // [kFM][kFLDC], over As/Bs
    __syncthreads();                              // the last tile's reads
    wmma::store_matrix_sync(Cs + wm * 16 * kFLDC + wn * 32, frag[0][0], kFLDC,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(Cs + wm * 16 * kFLDC + wn * 32 + 16, frag[0][1], kFLDC,
                            wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < kFM * kFN; i += kThreads)
      store(i / kFN, i % kFN, Cs[(i / kFN) * kFLDC + i % kFN]);
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float v = kSwiglu ? swiglu<T>(acc[0][r][c], acc[NB - 1][r][c]) : acc[0][r][c];
        store(ty * 4 + r, tx * 4 + c, v);
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_a2a_mlp_kernel(PeerSlots peers, int w, int rank, int bucket,
                     const int* __restrict__ inv, const int* __restrict__ counts,
                     const T* __restrict__ wg, const T* __restrict__ wu,
                     const T* __restrict__ wd, T* __restrict__ act, T* __restrict__ y,
                     int e_local, int c_pad, int M, int F) {
  constexpr int kTiles = kFK * (kFLDA + 2 * kFLDB) * static_cast<int>(sizeof(T));
  constexpr int kStage = kFM * kFLDC * 4;
  __shared__ __align__(128) unsigned char smem[kTiles > kStage ? kTiles : kStage];
  __shared__ const T* rowp[kFM];

  const int i = blockIdx.x, e = blockIdx.y, c = blockIdx.z;
  const int tid = threadIdx.x;
  const int count = min(max(counts[c * e_local + e], 0), c_pad);
  const int m0 = i * kFM;
  const size_t row0 = (static_cast<size_t>(c) * e_local + e) * c_pad + m0;
  if (m0 >= count) {  // the ragged skip: a dead row tile writes zeros
    for (size_t o = tid; o < static_cast<size_t>(kFM) * M; o += kThreads)
      y[row0 * M + o] = from_f<T>(0.f);
    return;
  }
  if (tid < kFM) {
    const int src = inv[row0 + tid];
    const T* p = nullptr;
    if (m0 + tid < count && src >= 0 && src < w * bucket) {
      const int peer = src / bucket;
      p = static_cast<const T*>(peers.base[peer]) +
          (static_cast<size_t>(c * w + rank) * bucket + src % bucket) * M;
    }
    rowp[tid] = p;
  }
  __syncthreads();

  const T* wg_e = wg + static_cast<size_t>(e) * M * F;
  const T* wu_e = wu + static_cast<size_t>(e) * M * F;
  const T* wd_e = wd + static_cast<size_t>(e) * F * M;
  T* act_rows = act + row0 * F;

  // phase 1: act = silu(x wg[e]) * (x wu[e]), one 64-column ffn tile at a time
  for (int f0 = 0; f0 < F; f0 += kFN) {
    tile_gemm<2, true, T>(
        smem, M,
        [&](int m, int k) {
          const T* p = rowp[m];
          return p != nullptr ? p[k] : from_f<T>(0.f);
        },
        [&](int j, int k, int n) {
          const int gn = f0 + n;
          if (gn >= F) return from_f<T>(0.f);
          return (j == 0 ? wg_e : wu_e)[static_cast<size_t>(k) * F + gn];
        },
        [&](int m, int n, float v) {
          if (f0 + n < F) act_rows[static_cast<size_t>(m) * F + f0 + n] = from_f<T>(v);
        });
  }
  __syncthreads();  // the block's act rows are written (and visible to it)

  // phase 2: y = act wd[e], fp32 accumulation over the ffn
  for (int n0 = 0; n0 < M; n0 += kFN) {
    tile_gemm<1, false, T>(
        smem, F,
        [&](int m, int k) { return act_rows[static_cast<size_t>(m) * F + k]; },
        [&](int, int k, int n) {
          const int gn = n0 + n;
          return gn < M ? wd_e[static_cast<size_t>(k) * M + gn] : from_f<T>(0.f);
        },
        [&](int m, int n, float v) {
          if (n0 + n < M) y[(row0 + m) * M + n0 + n] = from_f<T>(v);
        });
  }
}

}  // namespace

// #17: y [chunks*e_local*c_pad, M] = the expert MLP of every chunk's
// expert-major rows gathered from the peers' staged slots. peers: w device
// pointers (host array), peer j's staged x_send [chunks*w*bucket, M]; inv
// [chunks*e_local*c_pad] int32 landing-buffer rows (>= w*bucket: none);
// counts [chunks*e_local] int32; wg, wu [e_local, M, F], wd [e_local, F, M];
// act [chunks*e_local*c_pad, F] scratch. All of one dtype, bf16 or fp32.
extern "C" int ptt_fused_a2a_mlp(const void* const* peers, int w, int rank, int bucket,
                                 const void* inv, const void* counts, const void* wg,
                                 const void* wu, const void* wd, void* act, void* y,
                                 int chunks, int e_local, int c_pad, int M, int F,
                                 int dtype, void* stream) {
  if (w < 1 || w > kPeers || rank < 0 || rank >= w || bucket < 1 || c_pad % kFM != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (chunks == 0 || e_local == 0 || c_pad == 0 || M == 0) return 0;
  PeerSlots ps{};
  for (int j = 0; j < w; ++j) ps.base[j] = peers[j];
  const dim3 grid(c_pad / kFM, e_local, chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* iv = static_cast<const int*>(inv);
  const int* cn = static_cast<const int*>(counts);
  if (dtype == PTT_BF16) {
    using T = __nv_bfloat16;
    fused_a2a_mlp_kernel<T><<<grid, kThreads, 0, s>>>(
        ps, w, rank, bucket, iv, cn, static_cast<const T*>(wg), static_cast<const T*>(wu),
        static_cast<const T*>(wd), static_cast<T*>(act), static_cast<T*>(y), e_local,
        c_pad, M, F);
  } else if (dtype == PTT_F32) {
    fused_a2a_mlp_kernel<float><<<grid, kThreads, 0, s>>>(
        ps, w, rank, bucket, iv, cn, static_cast<const float*>(wg),
        static_cast<const float*>(wu), static_cast<const float*>(wd),
        static_cast<float*>(act), static_cast<float*>(y), e_local, c_pad, M, F);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PTT_RETURN_LAUNCH_ERROR();
}
