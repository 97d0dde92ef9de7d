// One hop of the ring-attention KV rotation between ranks of one host.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/async_collectives.py:
// _ring_rotate_kernel (called by ring_kv_rotate, async_collectives.py:294):
// rank i's K and V land in rank i+1's output buffers through remote DMA,
// with an entry barrier so that no successor writes into a buffer its owner
// has not yet given up.
//
// On the card there is no remote DMA engine to drive from a kernel, so the
// hop is a pull through CUDA IPC. Every rank owns one device buffer of two
// slots, exported with cudaIpcGetMemHandle; each rank maps its peers'
// buffers once (cudaIpcOpenMemHandle, lazy peer access, so ranks on other
// cards of the host are reached over NVLink). A hop is two launches of one
// copy kernel:
//
//   1. stage: the rank's K and V -> its own slot s;
//   2. (host) the stage has finished on every rank: a stream synchronize and
//      a barrier of the group, the entry barrier's counterpart;
//   3. pull: the source rank's slot s (IPC-mapped) -> the rank's new K and V.
//
// Slots alternate between hops, so a pull still in flight never races the
// next stage: a rank restages slot s two hops later, after a barrier that
// every rank reached only once its pull of slot s had finished (step 2 of the
// hop in between synchronizes the stream that ran it).
//
// Bound on the H100: bytes. The function moves each byte once in and once
// out; the kernel moves it twice (stage and pull) within one card, or once
// over NVLink for the pull.
//
// Design: up to two segments (K and V) per launch, blockIdx.y picks one;
// 16-byte vectors in a grid-stride loop when every pointer and size allows
// it, bytes otherwise.
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Segments {
  const unsigned char* src[2];
  unsigned char* dst[2];
  long long bytes[2];
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
  Segments seg{};
  seg.src[0] = static_cast<const unsigned char*>(src0);
  seg.dst[0] = static_cast<unsigned char*>(dst0);
  seg.bytes[0] = n0;
  seg.src[1] = static_cast<const unsigned char*>(src1);
  seg.dst[1] = static_cast<unsigned char*>(dst1);
  seg.bytes[1] = n > 1 ? n1 : 0;
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
