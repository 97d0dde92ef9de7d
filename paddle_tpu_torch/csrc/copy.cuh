// The streaming device copy shared by #16's hop and #15's pull
// (ring_copy_kernel, async_collectives.cu) and #18's KV-page pull
// (kv_pages_copy_kernel, kv_handoff.cu).
//
// Bound on the H100: bytes, each in once and out once. One 16-byte load in
// flight a thread on a grid of ~4 x 132 blocks keeps ~2 MB in flight across
// the card, too little for the bandwidth-delay product; here each thread of
// a grid-stride loop issues kUnroll independent 16-byte streaming loads
// (ld.global.cs: read once, no reuse to keep in cache) before their
// streaming stores, and the grid fills every SM at full occupancy (8 blocks
// of 256 threads an SM, shared by the pieces of the launch): ~17 MB in
// flight.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace stream_copy {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;                     // independent loads a thread
constexpr int kBlocksPerSm = 2048 / kThreads;  // full occupancy

// dst[j] = src[j] for this thread's j of [0, n16): i is its first vector
// (its index in the grid of one piece), stride the piece's grid in threads.
// The last pass masks its loads and stores, so it too keeps kUnroll loads
// in flight: at a capped grid the unrolled passes cover only part of a
// segment (about half of #18's 64 MiB in two pieces), and a remainder loop
// of one vector at a time would keep one.
__device__ __forceinline__ void vectors(const uint4* __restrict__ src,
                                        uint4* __restrict__ dst, long long n16,
                                        long long i, long long stride) {
  for (; i < n16; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u * stride < n16) v[u] = __ldcs(src + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u * stride < n16) __stcs(dst + i + u * stride, v[u]);
  }
}

// Blocks of kThreads along x for each of `pieces` pieces of at most `units`
// units (16-byte vectors where vec, else bytes): enough for one pass of
// kUnroll vectors a thread, at most the card's full occupancy shared by the
// pieces, at least one.
inline long long blocks(long long units, long long pieces, bool vec) {
  const long long per_block = static_cast<long long>(kThreads) * (vec ? kUnroll : 1);
  const long long cap = static_cast<long long>(hopper::sm_count()) * kBlocksPerSm / pieces;
  long long n = (units + per_block - 1) / per_block;
  if (n > cap) n = cap;
  return n < 1 ? 1 : n;
}

}  // namespace stream_copy
