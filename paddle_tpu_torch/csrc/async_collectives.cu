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
// The copies (#16's stage and pull, #15's pull): up to kMaxSeg segments per
// launch, blockIdx.y picks one. Bound: bytes, each segment in once and out
// once. When every pointer and size is a multiple of 16 bytes, the segment
// takes copy.cuh's streaming loop (kUnroll independent 16-byte streaming
// loads a thread, a full-occupancy grid split over the segments; #18 shares
// it). Bytes otherwise.
#include <string.h>

#include "common.cuh"
#include "copy.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = stream_copy::kThreads;
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
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (kVec) {
    stream_copy::vectors(reinterpret_cast<const uint4*>(seg.src[s]),
                         reinterpret_cast<uint4*>(seg.dst[s]), n / 16, i, stride);
  } else {
    for (; i < n; i += stride) seg.dst[s][i] = seg.src[s][i];
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
  const long long blocks = stream_copy::blocks(vec ? most / 16 : most, n, vec);
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
// M 1024, F 704, bf16) that is ~71 GFLOP, ~0.072 ms at 989 TFLOP/s. Its
// operands must therefore reach the tensor cores from a ring of copies in
// flight, and the work must spread over many more blocks than the
// (row tile, expert, chunk) grid's ~256 live ones.
//
// bf16: two launches on the caller's stream, each over (output tile,
// 128-row tile, chunk*expert) blocks of 288 threads: two consumer
// warpgroups of 64 rows issuing wgmma and one producer warp feeding a
// 4-stage ring of 128-byte-swizzled 64-deep stages guarded by full/empty
// mbarriers.
//   1. gate/up, one block per (128 ffn columns, row tile): the producer
//      gathers the tile's A rows straight from the peers' slots with 16-byte
//      cp.async into the swizzled layout (TMA has no gather; sentinel, dead
//      and out-of-region rows are zero-filled) and loads the wg and wu tiles
//      by TMA (3-D maps over [E, M, F], read MN-major in place through the
//      transpose bit); the consumers accumulate g and u in fp32 and store
//      act = silu(g)*u with the composed path's rounding points into the
//      act scratch [rows, F] (16,642 x 704 bf16 is ~23 MB: it stays in the
//      50 MB L2 for the second launch).
//   2. down, one block per (128 output columns, row tile): act tiles and
//      the wd tiles ([E, F, M], MN-major) by TMA, y = act.wd accumulated in
//      fp32 over the ffn in one order, rounded once on the store. A dead
//      row tile writes its zeros here.
// Two launches rather than one persistent kernel with per-row-tile ready
// counters: the act round trip through L2 is a few microseconds, and no
// block ever waits on another. A 128-row tile that runs past c_pad (c_pad
// is a multiple of 64) computes its second half and stores none of it.
// Each output element has one block and one summation order (no split-K,
// no atomics), so repeats are bitwise.
//
// Every other call (fp32, the layer-level run's dtype; bf16 with M or F not
// a multiple of 8, which TMA's strides cannot map, or a base off 16-byte
// alignment): the first port's design on the CUDA cores, templated on the
// element type, full fp32 arithmetic (no TF32): one block of 256 threads
// per (64-row tile, local expert, chunk), phase 1 walking the ffn in
// 64-column tiles into the act scratch, phase 2 the output, from register
// tiles over scalar-loaded shared-memory tiles. In bf16 it rounds where the
// wgmma route rounds: g and u and silu(g)*u through swiglu<T>, act stored in
// bf16, y accumulated in fp32 over the ffn and rounded once on the store.
// The wrapper picks the route from shape and alignment before the launch
// (the `tma` flag).
namespace {

constexpr int kPeers = kMaxSeg;

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

// ------------------------------------------------------------------ bf16
namespace fused_wg {

using bf16 = __nv_bfloat16;
constexpr int kRows = 128;                 // a row tile: two warpgroups of 64
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kStages = 4;
constexpr int kFT = 128;                   // ffn columns of a gate/up block
constexpr int kNT = 128;                   // output columns of a down block
constexpr int kA = kRows * 128;            // a 64-deep A stage, [128][64] bf16
constexpr int kB = 64 * 128;               // a [64][64] bf16 weight atom
// gate/up: A, then wg's and wu's two atoms each (48 KB a stage); down: A,
// then wd's two atoms (32 KB)
constexpr int kGUStage = kA + 4 * kB, kDStage = kA + 2 * kB;
constexpr int kRowpOff = kStages * kGUStage;  // gate/up: the rows' sources
constexpr int kGUBarOff = kRowpOff + kRows * 8, kDBarOff = kStages * kDStage;
constexpr int kGUBytes = kGUBarOff + 2 * kStages * 8 + hopper::kSmemAlign;
constexpr int kDBytes = kDBarOff + 2 * kStages * 8 + hopper::kSmemAlign;

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int full_count) {
  for (int s = 0; s < kStages; ++s) {
    hopper::mbar_init(&full[s], full_count);
    hopper::mbar_init(&empty[s], kConsumers / 32);  // one arrival a consumer warp
  }
  hopper::fence_barrier_init();
}

// Store a warpgroup's m64n{2R} accumulator pair-wise into out [., ld] at
// (row0 + tile row, col0 + column), rows below `rows`, columns below `cols`;
// v(i) gives element i's value.
template <int R, class V>
__device__ __forceinline__ void store_rows(bf16* out, size_t ld, size_t row0, int col0,
                                           int rows, int cols, int g, V v) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int rt = 64 * g + 16 * warp + (lane >> 2);
#pragma unroll
  for (int i = 0; i < R; i += 2) {
    const int r = rt + ((i & 2) ? 8 : 0);
    const int col = col0 + 8 * (i / 4) + 2 * (lane & 3);
    if (r < rows && col < cols)  // cols is even: the pair is in or out
      *reinterpret_cast<__nv_bfloat162*>(out + (row0 + r) * ld + col) =
          __floats2bfloat162_rn(v(i), v(i + 1));
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fused_gate_up_wgmma(PeerSlots peers, int w, int rank, int bucket, const int* __restrict__ inv,
                    const int* __restrict__ counts, const __grid_constant__ CUtensorMap map_wg,
                    const __grid_constant__ CUtensorMap map_wu, bf16* __restrict__ act,
                    int e_local, int c_pad, int M, int F) {
  const int ce = blockIdx.z, c = ce / e_local, e = ce % e_local;
  const int count = min(max(counts[ce], 0), c_pad);
  const int m0 = blockIdx.y * kRows;
  if (m0 >= count) return;  // a dead row tile: the down launch writes its zeros
  const int f0 = blockIdx.x * kFT;
  const int rows = min(kRows, c_pad - m0);  // the tile's rows in this expert
  const size_t row0 = static_cast<size_t>(ce) * c_pad + m0;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align_smem(smem_raw);
  const bf16** rowp = reinterpret_cast<const bf16**>(sm + kRowpOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kGUBarOff);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid < kRows) {  // each row's source in a peer's staged slot, or none
    const bf16* p = nullptr;
    if (tid < rows && m0 + tid < count) {
      const int src = inv[row0 + tid];
      if (src >= 0 && src < w * bucket)
        p = static_cast<const bf16*>(peers.base[src / bucket]) +
            (static_cast<size_t>(c * w + rank) * bucket + src % bucket) * M;
    }
    rowp[tid] = p;
  }
  // full: the 32 producer lanes' cp.async arrivals and the TMA's expect_tx
  if (tid == 0) init_ring(full, empty, 33);
  __syncthreads();

  const int n_k = (M + 63) / 64;
  if (warp == kConsumers / 32) {  // the producer warp
    const void* zero_src = peers.base[0];
    for (int t = 0; t < n_k; ++t) {
      const int s = t % kStages;
      if (t >= kStages) hopper::mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
      unsigned char* st = sm + s * kGUStage;
      const int k0 = t * 64;
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&full[s], 4 * kB);
        for (int a = 0; a < 2; ++a) {
          hopper::tma_load_3d(st + kA + a * kB, &map_wg, &full[s], f0 + 64 * a, k0, e);
          hopper::tma_load_3d(st + kA + (2 + a) * kB, &map_wu, &full[s], f0 + 64 * a, k0, e);
        }
      }
      // 128 rows x 8 chunks of 16 bytes, 32 a lane; chunk ch of row r lands
      // at chunk ch ^ (r % 8) of the row's 128 bytes (the 128B swizzle)
#pragma unroll 4
      for (int it = 0; it < kRows * 8 / 32; ++it) {
        const int idx = it * 32 + lane, r = idx >> 3, ch = idx & 7;
        const bf16* p = rowp[r];
        const int k = k0 + ch * 8;
        const bool ok = p != nullptr && k < M;  // M % 8 == 0
        hopper::cp_async16(st + r * 128 + ((ch ^ (r & 7)) << 4),
                           ok ? static_cast<const void*>(p + k) : zero_src, ok ? 16 : 0);
      }
      hopper::cp_async_arrive(&full[s]);
    }
    return;
  }

  const int g = warp >> 2;
  float ag[64], au[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) ag[i] = au[i] = 0.f;
  for (int t = 0; t < n_k; ++t) {
    const int s = t % kStages;
    hopper::mbar_wait(&full[s], (t / kStages) & 1);
    hopper::fence_proxy_async();  // the cp.async rows, for wgmma's reads
    const unsigned char* st = sm + s * kGUStage;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = hopper::desc_sw128(st + g * 64 * 128 + kk * 32, 16, 1024);
      const uint64_t dg = hopper::desc_sw128(st + kA + kk * 16 * 128, kB, 1024);
      const uint64_t du = hopper::desc_sw128(st + kA + 2 * kB + kk * 16 * 128, kB, 1024);
      hopper::wgmma_m64n128_ss<1>(ag, da, dg, 1);
      hopper::wgmma_m64n128_ss<1>(au, da, du, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(ag);
    hopper::fence_regs(au);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }
  store_rows<64>(act, F, row0, f0, rows, F, g,
                 [&](int i) { return swiglu<bf16>(ag[i], au[i]); });
}

__global__ void __launch_bounds__(kThreads, 1)
fused_down_wgmma(const __grid_constant__ CUtensorMap map_act,
                 const __grid_constant__ CUtensorMap map_wd, const int* __restrict__ counts,
                 bf16* __restrict__ y, int e_local, int c_pad, int M, int F) {
  const int ce = blockIdx.z, e = ce % e_local;
  const int count = min(max(counts[ce], 0), c_pad);
  const int m0 = blockIdx.y * kRows, n0 = blockIdx.x * kNT;
  const int rows = min(kRows, c_pad - m0);
  const size_t row0 = static_cast<size_t>(ce) * c_pad + m0;
  if (m0 >= count) {  // the ragged skip: a dead row tile writes zeros
    for (int i = threadIdx.x; i < rows * kNT; i += kThreads) {
      const int col = n0 + i % kNT;
      if (col < M) y[(row0 + i / kNT) * M + col] = __float2bfloat16_rn(0.f);
    }
    return;
  }
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kDBarOff);
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) init_ring(full, empty, 1);
  __syncthreads();

  const int n_k = (F + 63) / 64;
  if (warp == kConsumers / 32) {  // the producer warp
    if (lane == 0) {
      for (int t = 0; t < n_k; ++t) {
        const int s = t % kStages;
        if (t >= kStages) hopper::mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
        unsigned char* st = sm + s * kDStage;
        const int k0 = t * 64;
        hopper::mbar_arrive_expect_tx(&full[s], kDStage);
        hopper::tma_load_2d(st, &map_act, &full[s], k0, static_cast<int>(row0));
        hopper::tma_load_3d(st + kA, &map_wd, &full[s], n0, k0, e);
        hopper::tma_load_3d(st + kA + kB, &map_wd, &full[s], n0 + 64, k0, e);
      }
    }
    return;
  }

  const int g = warp >> 2;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int t = 0; t < n_k; ++t) {
    const int s = t % kStages;
    hopper::mbar_wait(&full[s], (t / kStages) & 1);
    const unsigned char* st = sm + s * kDStage;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = hopper::desc_sw128(st + g * 64 * 128 + kk * 32, 16, 1024);
      const uint64_t db = hopper::desc_sw128(st + kA + kk * 16 * 128, kB, 1024);
      hopper::wgmma_m64n128_ss<1>(acc, da, db, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }
  store_rows<64>(y, M, row0, n0, rows, M, g, [&](int i) { return acc[i]; });
}

int launch(const PeerSlots& ps, int w, int rank, int bucket, const int* inv, const int* counts,
           const void* wg, const void* wu, const void* wd, void* act, void* y, int chunks,
           int e_local, int c_pad, int M, int F, cudaStream_t s) {
  // TMA: 16-byte aligned bases and row strides
  const uintptr_t bits = reinterpret_cast<uintptr_t>(wg) | reinterpret_cast<uintptr_t>(wu) |
                         reinterpret_cast<uintptr_t>(wd) | reinterpret_cast<uintptr_t>(act);
  if (M % 8 != 0 || F % 8 != 0 || bits % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int j = 0; j < w; ++j)
    if (reinterpret_cast<uintptr_t>(ps.base[j]) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t m = M, f = F, el = e_local;
  const uint64_t rows = static_cast<uint64_t>(chunks) * e_local * c_pad;
  CUtensorMap mg, mu, md, ma;
  const uint64_t dw[3] = {f, m, el}, sw[2] = {f * 2, m * f * 2};  // wg, wu [E, M, F]
  const uint64_t dd[3] = {m, f, el}, sd[2] = {m * 2, f * m * 2};  // wd [E, F, M]
  const uint64_t da[2] = {f, rows}, sa[1] = {f * 2};              // act [rows, F]
  const uint32_t box_w[3] = {64, 64, 1}, box_a[2] = {64, kRows};
  int err = hopper::bf16_map(&mg, wg, 3, dw, sw, box_w);
  if (err == 0) err = hopper::bf16_map(&mu, wu, 3, dw, sw, box_w);
  if (err == 0) err = hopper::bf16_map(&md, wd, 3, dd, sd, box_w);
  if (err == 0) err = hopper::bf16_map(&ma, act, 2, da, sa, box_a);
  if (err != 0) return err;
  cudaError_t e =
      cudaFuncSetAttribute(fused_gate_up_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kGUBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fused_down_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int row_tiles = (c_pad + kRows - 1) / kRows;
  const dim3 grid1((F + kFT - 1) / kFT, row_tiles, chunks * e_local);
  fused_gate_up_wgmma<<<grid1, kThreads, kGUBytes, s>>>(ps, w, rank, bucket, inv, counts, mg, mu,
                                                      static_cast<bf16*>(act), e_local, c_pad,
                                                      M, F);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid2((M + kNT - 1) / kNT, row_tiles, chunks * e_local);
  fused_down_wgmma<<<grid2, kThreads, kDBytes, s>>>(ma, md, counts, static_cast<bf16*>(y),
                                                   e_local, c_pad, M, F);
  PTT_RETURN_LAUNCH_ERROR();
}

}  // namespace fused_wg

// ------------------------------------------------------------ CUDA cores
namespace fused_cc {

constexpr int kFM = 64, kFN = 64, kFK = 32;
constexpr int kFLDA = kFM + 8;  // As[kk][m]
constexpr int kFLDB = kFN + 8;  // Bs[kk][n]

// One [kFM x kFN] tile C = sum_kk A(m, kk) B_j(kk, n) for NB weight streams
// over depth `depth`, then store(m, n, value) for every element of the tile.
// With kSwiglu (NB == 2) the value is silu(C_0) * C_1 with T's rounding
// points (swiglu<T>).
template <typename T, int NB, bool kSwiglu, class LoadA, class LoadB, class Store>
__device__ __forceinline__ void tile_gemm(float* smem, int depth, LoadA load_a, LoadB load_b,
                                          Store store) {
  float* As = smem;               // [kFK][kFLDA]
  float* Bs1 = As + kFK * kFLDA;  // [kFK][kFLDB]
  float* Bs2 = Bs1 + kFK * kFLDB;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  float acc[NB][4][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][r][c] = 0.f;

  for (int k0 = 0; k0 < depth; k0 += kFK) {
    __syncthreads();  // the previous tile's reads are done
    for (int i = tid; i < kFM * kFK; i += kThreads) {
      const int kk = i % kFK, m = i / kFK;
      As[kk * kFLDA + m] = k0 + kk < depth ? load_a(m, k0 + kk) : 0.f;
    }
    for (int i = tid; i < kFK * kFN; i += kThreads) {
      const int n = i % kFN, kk = i / kFN;
      const bool in = k0 + kk < depth;
      Bs1[kk * kFLDB + n] = in ? load_b(0, k0 + kk, n) : 0.f;
      if constexpr (NB == 2) Bs2[kk * kFLDB + n] = in ? load_b(1, k0 + kk, n) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kFK; ++kk) {
      float ar[4], br[NB][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) ar[r] = As[kk * kFLDA + ty * 4 + r];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) br[j][c] = (j == 0 ? Bs1 : Bs2)[kk * kFLDB + tx * 4 + c];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[j][r][c] = fmaf(ar[r], br[j][c], acc[j][r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float v = kSwiglu ? swiglu<T>(acc[0][r][c], acc[NB - 1][r][c]) : acc[0][r][c];
      store(ty * 4 + r, tx * 4 + c, v);
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_a2a_mlp_kernel(PeerSlots peers, int w, int rank, int bucket,
                     const int* __restrict__ inv, const int* __restrict__ counts,
                     const T* __restrict__ wg, const T* __restrict__ wu,
                     const T* __restrict__ wd, T* __restrict__ act,
                     T* __restrict__ y, int e_local, int c_pad, int M, int F) {
  __shared__ float smem[kFK * (kFLDA + 2 * kFLDB)];
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
    tile_gemm<T, 2, true>(
        smem, M,
        [&](int m, int k) {
          const T* p = rowp[m];
          return p != nullptr ? to_f<T>(p[k]) : 0.f;
        },
        [&](int j, int k, int n) {
          const int gn = f0 + n;
          if (gn >= F) return 0.f;
          return to_f<T>((j == 0 ? wg_e : wu_e)[static_cast<size_t>(k) * F + gn]);
        },
        [&](int m, int n, float v) {
          if (f0 + n < F) act_rows[static_cast<size_t>(m) * F + f0 + n] = from_f<T>(v);
        });
  }
  __syncthreads();  // the block's act rows are written (and visible to it)

  // phase 2: y = act wd[e], fp32 accumulation over the ffn
  for (int n0 = 0; n0 < M; n0 += kFN) {
    tile_gemm<T, 1, false>(
        smem, F, [&](int m, int k) { return to_f<T>(act_rows[static_cast<size_t>(m) * F + k]); },
        [&](int, int k, int n) {
          const int gn = n0 + n;
          return gn < M ? to_f<T>(wd_e[static_cast<size_t>(k) * M + gn]) : 0.f;
        },
        [&](int m, int n, float v) {
          if (n0 + n < M) y[(row0 + m) * M + n0 + n] = from_f<T>(v);
        });
  }
}

template <typename T>
int launch(const PeerSlots& ps, int w, int rank, int bucket, const int* inv, const int* counts,
           const void* wg, const void* wu, const void* wd, void* act, void* y, int chunks,
           int e_local, int c_pad, int M, int F, cudaStream_t s) {
  const dim3 grid(c_pad / kFM, e_local, chunks);
  fused_a2a_mlp_kernel<T><<<grid, kThreads, 0, s>>>(
      ps, w, rank, bucket, inv, counts, static_cast<const T*>(wg), static_cast<const T*>(wu),
      static_cast<const T*>(wd), static_cast<T*>(act), static_cast<T*>(y), e_local, c_pad, M,
      F);
  PTT_RETURN_LAUNCH_ERROR();
}

}  // namespace fused_cc

}  // namespace

// #17: y [chunks*e_local*c_pad, M] = the expert MLP of every chunk's
// expert-major rows gathered from the peers' staged slots. peers: w device
// pointers (host array), peer j's staged x_send [chunks*w*bucket, M]; inv
// [chunks*e_local*c_pad] int32 landing-buffer rows (>= w*bucket: none);
// counts [chunks*e_local] int32; wg, wu [e_local, M, F], wd [e_local, F, M];
// act [chunks*e_local*c_pad, F] scratch. All of one dtype, bf16 or fp32.
// tma 1 (bf16 with M and F multiples of 8 and every pointer 16-byte
// aligned) takes the wgmma kernels, tma 0 the CUDA cores (see above).
extern "C" int ptt_fused_a2a_mlp(const void* const* peers, int w, int rank, int bucket,
                                 const void* inv, const void* counts, const void* wg,
                                 const void* wu, const void* wd, void* act, void* y,
                                 int chunks, int e_local, int c_pad, int M, int F,
                                 int dtype, int tma, void* stream) {
  if (w < 1 || w > kPeers || rank < 0 || rank >= w || bucket < 1 || c_pad % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (chunks == 0 || e_local == 0 || c_pad == 0 || M == 0) return 0;
  PeerSlots ps{};
  for (int j = 0; j < w; ++j) ps.base[j] = peers[j];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* iv = static_cast<const int*>(inv);
  const int* cn = static_cast<const int*>(counts);
  if (dtype == PTT_BF16 && tma)
    return fused_wg::launch(ps, w, rank, bucket, iv, cn, wg, wu, wd, act, y, chunks, e_local,
                            c_pad, M, F, s);
  if (dtype == PTT_BF16)
    return fused_cc::launch<__nv_bfloat16>(ps, w, rank, bucket, iv, cn, wg, wu, wd, act, y,
                                           chunks, e_local, c_pad, M, F, s);
  if (dtype != PTT_F32 || tma) return static_cast<int>(cudaErrorInvalidValue);
  return fused_cc::launch<float>(ps, w, rank, bucket, iv, cn, wg, wu, wd, act, y, chunks,
                                 e_local, c_pad, M, F, s);
}
