// #18, the KV-page remote copy of the prefill -> decode handoff.
//
// Replaces paddle_tpu/inference/kv_handoff.py:_pages_kernel, called by
// kv_pages_remote_copy (:393 -> pallas_call :427). The TPU kernel pushes a
// packed page tensor [rows, kv_heads, head_dim] from rank src to rank dst
// with make_async_remote_copy, in `chunks` ordered pieces, starting piece
// c+1 before waiting on piece c, behind an entry barrier with its peer.
//
// On the card there is no remote DMA engine a kernel can drive. The source
// process has gathered its pages into a device buffer it exported with CUDA
// IPC (ptt_ipc_alloc in async_collectives.cu); the destination maps that
// buffer (ptt_ipc_open) and this kernel pulls one segment of it (the K
// pages, the V pages, a quantized pool's scales, a hybrid's state planes)
// into a buffer of its own. The entry barrier is the host protocol around
// the launch: the source synchronised its gather before advertising the
// buffer, and the destination confirms the buffer with the source before
// and after the pull (inference/kv_handoff.py, ops/kernels/kv_handoff.py).
//
// `chunks`: the TPU kernel's pieces exist to overlap one piece's DMA with
// the wait on the previous one. A launch has no such order: the segment is
// cut into `chunks` equal pieces of whole 16-byte units, blockIdx.y picks
// the piece, and all pieces are in flight at once, so the count only
// partitions the grid (the caller's chunk count is kept, as the reference
// clamps it, to a divisor of the rows). No semaphores are copied block by
// block: each block grid-strides over its piece with copy.cuh's streaming
// loop (8 independent 16-byte streaming loads a thread before their stores,
// #16's copy), and the bytes past the last whole vector (rows that do not
// divide by 16 bytes) take a masked byte loop. A pointer that is not
// 16-byte aligned takes the byte loop throughout. The grid is #16's rule:
// enough blocks for one pass of 8 vectors a thread, capped at full
// occupancy (8 blocks of 256 an SM) shared by the pieces: one load in
// flight a thread on ~4 blocks an SM keeps too few bytes in flight (it took
// 1.1-1.25x Tensor.copy_'s time on an H100 80GB HBM3 at 700 W, PERF.md).
//
// Bound on the H100: bytes. The segment is read once (from the peer's
// buffer: a global read on one card, an NVLink read across cards) and
// written once: 2 * bytes / 3.35 TB/s, 0.040 ms for the 64 MiB K (or V)
// segment of a 1024-token record at Llama-3-8B widths.
#include "common.cuh"
#include "copy.cuh"

namespace {

constexpr int kThreads = stream_copy::kThreads;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    kv_pages_copy_kernel(const unsigned char* __restrict__ src,
                         unsigned char* __restrict__ dst, long long bytes,
                         long long piece) {
  const long long begin = static_cast<long long>(blockIdx.y) * piece;
  if (begin >= bytes) return;
  const long long end = begin + piece < bytes ? begin + piece : bytes;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long tail = begin;
  if (kVec) {
    // piece is a multiple of 16, so every piece starts on a vector
    const long long n16 = (end - begin) / 16;
    stream_copy::vectors(reinterpret_cast<const uint4*>(src + begin),
                         reinterpret_cast<uint4*>(dst + begin), n16, first, stride);
    tail = begin + n16 * 16;
  }
  for (long long i = tail + first; i < end; i += stride) dst[i] = src[i];
}

}  // namespace

// Copy `bytes` from src (a peer's IPC-mapped buffer, or any device memory)
// to dst, as `chunks` pieces, on `stream`.
extern "C" int ptt_kv_pages_copy(const void* src, void* dst, long long bytes,
                                 int chunks, cudaStream_t stream) {
  if (bytes < 0 || chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes == 0) return 0;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(dst);
  const bool vec = bits % 16 == 0;
  long long piece = (bytes + chunks - 1) / chunks;
  piece = (piece + 15) / 16 * 16;
  const long long blocks = stream_copy::blocks(vec ? piece / 16 : piece, chunks, vec);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(chunks));
  const unsigned char* s = static_cast<const unsigned char*>(src);
  unsigned char* d = static_cast<unsigned char*>(dst);
  if (vec)
    kv_pages_copy_kernel<true><<<grid, kThreads, 0, stream>>>(s, d, bytes, piece);
  else
    kv_pages_copy_kernel<false><<<grid, kThreads, 0, stream>>>(s, d, bytes, piece);
  return static_cast<int>(cudaGetLastError());
}
