// The split-context kernel family of ragged paged attention for Hopper, with
// the page format as a compile-time policy, as the mask is one for the flash
// kernels (segment.cuh). #8 (csrc/ragged_paged_attention.cu) instantiates it
// over bf16 and fp32 pages, and #9 (csrc/paged_attention.cu) over the same
// pages for decode only (token t reads table row t).
//
// The function: packed token-major queries q [T, Hq, d]; token t reads
// block-table row rows[t] and sees its first valids[t] cached positions
// (at most the table's width x block size); valids[t] <= 0 (a pad) gives
// exactly 0. GQA folds query head h onto kv head h / (Hq / Hkv). Scores, the
// online softmax and the PV sum run in fp32 whatever the storage types; the
// output takes q's type.
//
// Bound on the H100: a decode token reads its visible K/V once for its group
// of query heads, about `group` fp32 flops a byte against the card's ~20, so a
// decode step is bytes-bound; a prompt chunk's tokens share their pages, so a
// chunk is operations-bound on the fp32 CUDA cores.
//
// Design (flash decoding):
// - The work plan is built on the device by every block from rows/valids, with
//   no host read. Consecutive live tokens of one table row form a run; a run is
//   cut into tiles of at most MT = kTileRows / group tokens, counted from the
//   run's first token, so a tile is at most kTileRows query rows (token x
//   head). A token's keys are cut into splits of kSplitKeys keys at fixed
//   positions (0, 256, 512, ...): a split's bounds depend only on the token's
//   own valids[t]. A work item is (tile, split, kv head). The grid is
//   persistent (at most the blocks the card holds at once) and block b takes
//   items b, b + grid, ... in one fixed order: tiles of several tokens first,
//   and within each class every tile's full splits before any tile's last,
//   partial one, so that where there are more items than blocks the later
//   rounds hold the lighter items (serve-ssm's fp32 decode step, 8 rows of
//   1040 keys over 8 kv heads: 256 full-split items, then 64 of 16 keys).
// - Copies: an item streams its split's keys through a ring of P::kRing
//   stages of SK keys in shared memory with 16-byte cp.async; K and V rows are
//   padded by 16 bytes against bank conflicts. Keys past the tile's last
//   visible one and columns past d are zero-filled, not read. The block has
//   kThreads threads whatever the group. A stage holds about P::kStageBytes
//   of K rows: fp32 pages take twice bf16's, so at a group of 1 a narrow warp
//   scores 4 keys a stage, not 2, in a ring one stage shorter, which keeps two
//   blocks an SM.
// - Products, fp32 on the CUDA cores: a tile of at most kNarrowRows rows (a
//   decode token of a group up to 8) runs the narrow path: each warp takes an
//   eighth of every stage's keys for all rows, a score a lane, keeps its own
//   online softmax, and the eight are merged in warp order at the split's
//   end. A larger tile runs the wide path, register-tiled as an SGEMM: each
//   warp owns 4 rows, a thread a 2-row micro-tile of scores and then of the
//   PV sum, q rows and the softmax weights read from shared memory. On both
//   paths a score is one fp32 FMA chain over the columns in order, as the
//   previous kernels and a SIMT GEMM form a dot product: the scores are
//   exponentiated, so their rounding is the one that moves the output most.
// - Output: a token whose keys fit one split is written by its split-0 item;
//   otherwise each of its splits writes fp32 partials (m, l, acc) behind the
//   output, and a second launch merges each (token, head)'s splits in split
//   order. No atomics anywhere: bitwise on repeat, and a token's bits depend
//   only on its q, its pages, its valids[t] and the tile it belongs to (a
//   decode token is a tile of its own, alone or in a full step).
//
// On the H100 an item's dependent chains (the plan, the table slice, the
// first copy, the merge), not the copies in flight, set its time; deeper or
// larger bf16 ring stages, the next item's table slice and first stages
// fetched during an item's merge, and a programmatic dependent launch of the
// merge did not shorten it (PERF.md).
//
// Head dims: instantiated at a padded head dim D of 64, 128 or 256
// (head_dim_bucket, common.cuh) and told the real d, a multiple of 16; only
// the columns that exist are copied, multiplied and stored.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace ragged {

constexpr int kThreads = 256;                 // 8 warps whatever the group
constexpr int kWarps = kThreads / 32;
constexpr int kSplitKeys = 256;               // keys of a context split
constexpr int kTileRows = 32;                 // query rows of a tile
constexpr int kNarrowRows = 8;                // a tile this small: narrow path
constexpr int kTableSlice = kSplitKeys + 2;   // table entries one split touches
constexpr int kPlanSpan = kThreads + 1 + kTileRows;  // tokens a plan chunk reads

// The launch's arguments. part: the fp32 partials of tokens of several
// splits, acc [T, Hq, nsp, d] then (m, l) [T, Hq, nsp], nsp the splits of a
// full table row. The decode instantiation (#9) reads no rows: token t reads
// table row t.
struct Args {
  const void* q;
  const uint8_t* kc;
  const uint8_t* vc;
  const int* tables;
  const int* rows;
  const int* valids;
  void* out;
  float* part;
  int T, Hq, Hkv, d, bs, width, nsp;
  int bs_shift;  // log2(bs) where bs is a power of two, else -1
  float scale;
};

// ------------------------------------------------------------ page formats
// A page policy: bytes an element, the bytes of K rows a ring stage holds (as
// many of V ride beside them), the ring's depth, and the unpack of a 32-bit
// word of elements into floats, element i from the low bytes up.
struct PageBF16 {
  static constexpr int kBytes = 2;
  static constexpr int kStageBytes = 8192;
  static constexpr int kRing = 3;
  __device__ __forceinline__ static void word(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
};

struct PageF32 {
  static constexpr int kBytes = 4;
  static constexpr int kStageBytes = 16384;
  static constexpr int kRing = 2;
  __device__ __forceinline__ static void word(uint32_t w, float* f) {
    f[0] = __uint_as_float(w);
  }
};

// N elements of a page row in shared memory (aligned to their size, at most
// 16 bytes) into floats.
template <class P, int N>
__device__ __forceinline__ void load_elems(const uint8_t* p, float* f) {
  constexpr int kB = N * P::kBytes;
  constexpr int kE = 4 / P::kBytes;  // elements a word
  static_assert(kB % 4 == 0, "whole words");
  if constexpr (kB % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kB / 16; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      P::word(u.x, f + (4 * i) * kE);
      P::word(u.y, f + (4 * i + 1) * kE);
      P::word(u.z, f + (4 * i + 2) * kE);
      P::word(u.w, f + (4 * i + 3) * kE);
    }
  } else if constexpr (kB == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    P::word(u.x, f);
    P::word(u.y, f + kE);
  } else {
    static_assert(kB == 4, "4, 8 or a multiple of 16 bytes");
    P::word(*reinterpret_cast<const uint32_t*>(p), f);
  }
}

// ------------------------------------------------------------- geometry
template <class P, int D>
struct Geo {
  static constexpr int kRowBytes = D * P::kBytes;   // a padded head row
  static constexpr int kRow = kRowBytes + 16;       // K and V rows in smem
  static constexpr int kChunk = 16 / P::kBytes;     // elements of 16 bytes
  static constexpr int kChunks = D / kChunk;
  static constexpr int kStages = P::kRing;
  // keys a stage: about P::kStageBytes of K rows, 16 to 64 keys
  static constexpr int kSkRaw = P::kStageBytes / kRowBytes;
  static constexpr int SK = kSkRaw < 16 ? 16 : kSkRaw > 64 ? 64 : kSkRaw;
  static constexpr int kStage = SK * 2 * kRow;
  // wide path: keys a thread a stage in scores, columns a thread in PV
  static constexpr int KM = SK / 16;
  static constexpr int CW = D / 16;
  // shared memory: the ring, q rows [kTileRows][D + 4] fp32, softmax
  // weights [kTileRows][SK + 4] fp32, the split's table entries
  static constexpr int kQRow = D + 4;
  static constexpr int kPRow = SK + 4;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kQOff = kRing;
  static constexpr int kPOff = kQOff + kTileRows * kQRow * 4;
  static constexpr int kTblOff = kPOff + kTileRows * kPRow * 4;
  static constexpr int kSmem = kTblOff + kTableSlice * 4;
  static_assert(kStages >= 2 && SK % 16 == 0 && KM >= 1 && CW >= 4, "lanes");
  // the narrow path's weights: each warp's [SK / kWarps][8] and 8 rescales
  static_assert(kWarps * (SK / kWarps + 1) * kNarrowRows <= kTileRows * kPRow, "weights");
  // the narrow path's merge reuses the ring, q and weight rows: each warp's
  // m and l a row, then its acc rows
  static_assert(kWarps * kNarrowRows * (D + 4) * 4 <= kTblOff, "merge buffer");
};

// ------------------------------------------------------------- cp.async
// 16 or 4 bytes global -> shared; a source size of 0 writes zeros and reads
// nothing.
__device__ __forceinline__ void cp16(void* dst, const void* src, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------ block scans
// Inclusive max of v over threads 0..tid; *all gets the block's max.
__device__ __forceinline__ int scan_max(int v, int* sh, int* all) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = max(v, y);
  }
  if (lane == 31) sh[warp] = v;
  __syncthreads();
  int pre = -1, tot = -1;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) pre = max(pre, sh[w]);
    tot = max(tot, sh[w]);
  }
  __syncthreads();
  *all = tot;
  return max(pre, v);
}

// Exclusive sums of v and of w over threads 0..tid-1, in one scan; *all gets
// the block's two sums.
__device__ __forceinline__ int2 scan_sum2(int v, int w, int* sh, int2* all) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v, y = w;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int xu = __shfl_up_sync(0xffffffffu, x, o);
    const int yu = __shfl_up_sync(0xffffffffu, y, o);
    if (lane >= o) {
      x += xu;
      y += yu;
    }
  }
  if (lane == 31) {
    sh[warp] = x;
    sh[kWarps + warp] = y;
  }
  __syncthreads();
  int2 pre = make_int2(0, 0), tot = make_int2(0, 0);
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    if (i < warp) {
      pre.x += sh[i];
      pre.y += sh[kWarps + i];
    }
    tot.x += sh[i];
    tot.y += sh[kWarps + i];
  }
  __syncthreads();
  *all = tot;
  return make_int2(pre.x + x - v, pre.y + y - w);
}

__host__ __device__ __forceinline__ int splits_of(int keys) {
  return (keys + kSplitKeys - 1) / kSplitKeys;
}

// One output element of row (token t, head h): the attention itself where
// the token's keys fit one split (written by its split-0 item), else the
// split's partial.
template <typename QT>
__device__ __forceinline__ void put(const Args& a, int t, int h, int c, int valid, int sp,
                                    float acc, float m, float l) {
  const int n = splits_of(valid);
  if (n == 1) {
    if (sp == 0) {
      const float l_safe = l == 0.f ? 1.f : l;
      static_cast<QT*>(a.out)[(static_cast<size_t>(t) * a.Hq + h) * a.d + c] =
          from_f<QT>(acc / l_safe);
    }
  } else if (sp < n) {
    const size_t slot = (static_cast<size_t>(t) * a.Hq + h) * a.nsp + sp;
    a.part[slot * a.d + c] = acc;
    if (c == 0) {
      float2* ml = reinterpret_cast<float2*>(
          a.part + static_cast<size_t>(a.T) * a.Hq * a.nsp * a.d);
      ml[slot] = make_float2(m, l);
    }
  }
}

// ------------------------------------------------------------- one item
// An item's context: tile [t0, t0 + nt) of table row `row` (tv: its tokens'
// valids), split sp, kv head g; keys [k0, k1) stream through the ring in nst
// stages of SK keys. Every stage holds all D columns of a row: those past d
// and the keys past k1 are zero-filled, so the products run over compile-time
// widths with no test of d inside them.
template <class P, int D>
struct Item {
  using G = Geo<P, D>;
  const Args& a;
  uint8_t* smem;
  const int* tv;
  const int* tbl;
  int t0, nt, sp, g, group, R, k0, k1, nst, p0;

  __device__ __forceinline__ const uint8_t* stage(int st) const {
    return smem + (st % G::kStages) * G::kStage;
  }

  // the cache row of key `key` of the item's table row
  __device__ __forceinline__ size_t cache_row(int key) const {
    if (a.bs_shift >= 0)
      return (static_cast<size_t>(tbl[(key >> a.bs_shift) - p0]) << a.bs_shift) |
             static_cast<size_t>(key & (a.bs - 1));
    return static_cast<size_t>(tbl[key / a.bs - p0]) * a.bs + key % a.bs;
  }

  // keys of stage st into ring slot st % kStages; a thread copies the same
  // 16-byte chunk of its rows at every stage
  __device__ __forceinline__ void issue(int st) const {
    constexpr int kRowsAPass = kThreads / G::kChunks;
    static_assert(kThreads % G::kChunks == 0 && G::SK % kRowsAPass == 0, "copy lanes");
    uint8_t* Ks = const_cast<uint8_t*>(stage(st));
    uint8_t* Vs = Ks + G::SK * G::kRow;
    const int kb = k0 + st * G::SK;
    const int kn = min(G::SK, k1 - kb);
    const int ch = threadIdx.x % G::kChunks;
    const bool live = ch < a.d / G::kChunk;  // a chunk of the real row
    const size_t rowbytes = static_cast<size_t>(a.d) * P::kBytes;
#pragma unroll
    for (int r = threadIdx.x / G::kChunks; r < G::SK; r += kRowsAPass) {
      const uint8_t* ksrc = a.kc;
      const uint8_t* vsrc = a.vc;
      int n = 0;
      if (live && r < kn) {
        const size_t off = (cache_row(kb + r) * a.Hkv + g) * rowbytes + ch * 16;
        ksrc += off;
        vsrc += off;
        n = 16;
      }
      cp16(Ks + r * G::kRow + ch * 16, ksrc, n);
      cp16(Vs + r * G::kRow + ch * 16, vsrc, n);
    }
  }

  // stage st has landed and every thread is done with stage st - 1; then the
  // copies of stage st + kStages - 1 go into the slot st - 1 freed
  __device__ __forceinline__ void next_stage(int st) const {
    cp_wait<G::kStages - 2>();
    __syncthreads();
    if (st + G::kStages - 1 < nst) issue(st + G::kStages - 1);
    cp_commit();
  }

  // q row r of the tile (token r / group, head g * group + r % group),
  // columns [c, c + 4) in fp32; zeros past the tile's rows and past d
  template <typename QT>
  __device__ __forceinline__ float4 q4(int r, int c) const {
    if (r >= R || c >= a.d) return make_float4(0.f, 0.f, 0.f, 0.f);
    const int j = r / group;
    const QT* p = static_cast<const QT*>(a.q) +
                  (static_cast<size_t>(t0 + j) * a.Hq + g * group + (r - j * group)) * a.d + c;
    if constexpr (sizeof(QT) == 4) {
      return *reinterpret_cast<const float4*>(p);
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      float f[4];
      PageBF16::word(u.x, f);
      PageBF16::word(u.y, f + 2);
      return make_float4(f[0], f[1], f[2], f[3]);
    }
  }
};

// A tile of at most RN rows (RN 1, 4 or 8; a decode token of a group up to
// 8): each warp takes an eighth of every stage's keys (KPW). Scores: lane l
// owns row l % RN and keys l / RN, l / RN + 32 / RN, ..., each score one
// fp32 FMA chain over the columns in order, from q and K rows in shared
// memory (the order of the previous kernels' and of a SIMT GEMM's dot
// products); the warp's online softmax then runs on a value a lane, its
// row's max and sum over the lanes of that row. PV: a key's row is split
// over LPK = D / 8 lanes, 8 columns each, KPP = 32 / LPK keys at once, the
// weights and rescales read from the warp's shared-memory rows. At the
// split's end the warp's key lanes add up and the eight warps merge in warp
// order.
template <typename QT, class P, int D, int RN>
__device__ __forceinline__ void narrow(const Item<P, D>& it) {
  using G = Geo<P, D>;
  constexpr int SK = G::SK, kRow = G::kRow, kChunk = G::kChunk;
  constexpr int KPW = SK / kWarps;                 // keys a warp a stage
  constexpr int KL = 32 / RN, NJ = (KPW + KL - 1) / KL;  // scores: lanes a row, key passes
  constexpr int LPK = D / 8, KPP = 32 / LPK, NP = KPW / KPP;  // PV
  static_assert(KPW % KPP == 0 && NP >= 1, "narrow lanes");
  const Args& a = it.a;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = it.R, group = it.group;
  float* Qs = reinterpret_cast<float*>(it.smem + G::kQOff);
  float* Pw = reinterpret_cast<float*>(it.smem + G::kPOff) + warp * (KPW * RN + RN);
  float* Aw = Pw + KPW * RN;  // the warp's rescale of each row this stage
  for (int i = tid; i < RN * D / 4; i += kThreads) {  // before the first barrier
    const int r = i / (D / 4), c4 = i % (D / 4);
    *reinterpret_cast<float4*>(Qs + r * G::kQRow + c4 * 4) = it.template q4<QT>(r, c4 * 4);
  }
  const int sr = lane % RN, sk = lane / RN;  // scores: row, first key
  const int vr = sr < R ? it.tv[sr / group] : 0;
  const float* qrow = Qs + sr * G::kQRow;
  const int c = lane % LPK, kp = lane / LPK;  // PV: column chunk, key of a pass
  float m = -CUDART_INF_F, l = 0.f;           // row sr's, on each of its lanes
  float acc[RN][8];
#pragma unroll
  for (int r = 0; r < RN; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  for (int st = 0; st < it.nst; ++st) {
    it.next_stage(st);
    const uint8_t* Ks = it.stage(st);
    const uint8_t* Vs = Ks + SK * kRow;
    const int kb = it.k0 + st * SK;
    if (warp * KPW >= it.k1 - kb) continue;  // none of this warp's keys: a no-op stage
    float sc[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int k = sk + j * KL;
      const int kloc = warp * KPW + k;
      sc[j] = -CUDART_INF_F;
      if (k < KPW && kb + kloc < vr) {
        float x = 0.f;
#pragma unroll 4
        for (int ch = 0; ch < G::kChunks; ++ch) {
          float kf[kChunk];
          load_elems<P, kChunk>(Ks + kloc * kRow + ch * 16, kf);
#pragma unroll
          for (int e = 0; e < kChunk / 4; ++e) {
            const float4 q = *reinterpret_cast<const float4*>(qrow + ch * kChunk + 4 * e);
            x = fmaf(q.x, kf[4 * e], x);
            x = fmaf(q.y, kf[4 * e + 1], x);
            x = fmaf(q.z, kf[4 * e + 2], x);
            x = fmaf(q.w, kf[4 * e + 3], x);
          }
        }
        sc[j] = x * a.scale;
      }
    }
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < NJ; ++j) mx = fmaxf(mx, sc[j]);
#pragma unroll
    for (int o = RN; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m, mx);
    const float m_safe = m_new == -CUDART_INF_F ? 0.f : m_new;
    const float alpha = m == -CUDART_INF_F ? 0.f : expf(m - m_safe);
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float pj = sc[j] == -CUDART_INF_F ? 0.f : expf(sc[j] - m_safe);
      const int k = sk + j * KL;
      if (k < KPW) Pw[k * RN + sr] = pj;
      ls += pj;
    }
#pragma unroll
    for (int o = RN; o < 32; o <<= 1) ls += __shfl_xor_sync(0xffffffffu, ls, o);
    l = alpha * l + ls;
    m = m_new;
    if (lane < RN) Aw[lane] = alpha;
    __syncwarp();  // the warp's weights and rescales are whole
    float sacc[RN][8];  // this stage's sums, from zero
#pragma unroll
    for (int r = 0; r < RN; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e) sacc[r][e] = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int k = p * KPP + kp;
      const int kloc = warp * KPW + k;
      float vf[8];
      load_elems<P, 8>(Vs + kloc * kRow + c * 8 * P::kBytes, vf);
#pragma unroll
      for (int r = 0; r < RN; ++r) {
        const float pr = Pw[k * RN + r];
#pragma unroll
        for (int e = 0; e < 8; ++e) sacc[r][e] = fmaf(pr, vf[e], sacc[r][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < RN; ++r) {  // the running sum rescaled, plus the stage's
      const float al = Aw[r];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(acc[r][e], al, sacc[r][e]);
    }
    __syncwarp();  // the weights are read before the next stage's
  }
  // the warp's key lanes add up, then the eight warps merge in order
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < RN; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
  cp_wait<0>();
  __syncthreads();  // the ring, q and weight rows are free: they hold the merge
  float* mb = reinterpret_cast<float*>(it.smem);  // [kWarps][kNarrowRows]
  float* lb = mb + kWarps * kNarrowRows;          // [kWarps][kNarrowRows]
  float* ab = lb + kWarps * kNarrowRows;          // [kWarps][kNarrowRows][D]
  if (lane < RN) {
    mb[warp * kNarrowRows + lane] = m;
    lb[warp * kNarrowRows + lane] = l;
  }
  if (kp == 0)
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      float4* dst = reinterpret_cast<float4*>(ab + (warp * kNarrowRows + r) * D + c * 8);
      dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
  __syncthreads();
  const int d = a.d;
  for (int i = tid; i < R * d; i += kThreads) {
    const int r = i / d, col = i - r * d;
    float M = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, mb[w * kNarrowRows + r]);
    const float M_safe = M == -CUDART_INF_F ? 0.f : M;
    float A = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = mb[w * kNarrowRows + r];
      const float wt = mw == -CUDART_INF_F ? 0.f : expf(mw - M_safe);
      L = fmaf(wt, lb[w * kNarrowRows + r], L);
      A = fmaf(wt, ab[(w * kNarrowRows + r) * D + col], A);
    }
    const int j = r / group;
    put<QT>(a, it.t0 + j, it.g * group + (r - j * group), col, it.tv[j], it.sp, A, M, L);
  }
}

// A tile of more rows (up to kTileRows), register-tiled as an SGEMM: warp w
// owns rows rg + kGroups i (rg = 2w, 2w + 1 by half-warp, i < RPT); in
// scores a thread holds an RPT-row x KM-key micro-tile, in PV an RPT-row x
// CW-column one, q rows and the softmax weights read from shared memory.
// Rows past the tile's are zero q rows whose keys are all masked.
template <typename QT, class P, int D>
__device__ __forceinline__ void wide(const Item<P, D>& it) {
  using G = Geo<P, D>;
  constexpr int SK = G::SK, kRow = G::kRow, KM = G::KM, CW = G::CW;
  constexpr int kGroups = 2 * kWarps, RPT = kTileRows / kGroups;
  const Args& a = it.a;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* Qs = reinterpret_cast<float*>(it.smem + G::kQOff);
  float* Ps = reinterpret_cast<float*>(it.smem + G::kPOff);
  // the tile's q rows, zero-padded, before the first stage's barrier
#pragma unroll
  for (int i = tid; i < kTileRows * D / 4; i += kThreads) {
    const int r = i / (D / 4), c4 = i % (D / 4);
    *reinterpret_cast<float4*>(Qs + r * G::kQRow + c4 * 4) = it.template q4<QT>(r, c4 * 4);
  }
  const int rg = (warp << 1) | (lane >> 4), kl = lane & 15;  // rows rg + kGroups i
  const int c0 = kl * CW;
  int vr[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + kGroups * i;
    vr[i] = r < it.R ? it.tv[r / it.group] : 0;
  }
  float m[RPT], l[RPT], acc[RPT][CW];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < CW; ++e) acc[i][e] = 0.f;
  }
  for (int st = 0; st < it.nst; ++st) {
    it.next_stage(st);
    const uint8_t* Ks = it.stage(st);
    const uint8_t* Vs = Ks + SK * kRow;
    const int kb = it.k0 + st * SK;
    float s[RPT][KM], al[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int u = 0; u < KM; ++u) s[i][u] = 0.f;
#pragma unroll 8
    for (int c4 = 0; c4 < D / 4; ++c4) {
      float kf[KM][4];
#pragma unroll
      for (int u = 0; u < KM; ++u)
        load_elems<P, 4>(Ks + (kl + 16 * u) * kRow + c4 * 4 * P::kBytes, kf[u]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(Qs + (rg + kGroups * i) * G::kQRow + c4 * 4);
#pragma unroll
        for (int u = 0; u < KM; ++u) {
          s[i][u] = fmaf(x.x, kf[u][0], s[i][u]);
          s[i][u] = fmaf(x.y, kf[u][1], s[i][u]);
          s[i][u] = fmaf(x.z, kf[u][2], s[i][u]);
          s[i][u] = fmaf(x.w, kf[u][3], s[i][u]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mloc = -CUDART_INF_F;
#pragma unroll
      for (int u = 0; u < KM; ++u) {
        const int kloc = kl + 16 * u;
        const float sc = kb + kloc < vr[i] ? s[i][u] * a.scale : -CUDART_INF_F;
        s[i][u] = sc;
        mloc = fmaxf(mloc, sc);
      }
      // rows of different i are independent: the compiler interleaves them
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, o));
      const float m_new = fmaxf(m[i], mloc);
      const float m_safe = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = m[i] == -CUDART_INF_F ? 0.f : expf(m[i] - m_safe);
      float* pw = Ps + (rg + kGroups * i) * G::kPRow;
      float ls = 0.f;
#pragma unroll
      for (int u = 0; u < KM; ++u) {
        const float pu = s[i][u] == -CUDART_INF_F ? 0.f : expf(s[i][u] - m_safe);
        pw[kl + 16 * u] = pu;
        ls += pu;
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) ls += __shfl_xor_sync(0xffffffffu, ls, o);
      l[i] = alpha * l[i] + ls;
      m[i] = m_new;
      al[i] = alpha;
    }
    __syncwarp();  // the warp's rows of Ps are whole
    float sacc[RPT][CW];  // this stage's sums, from zero
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int e = 0; e < CW; ++e) sacc[i][e] = 0.f;
    // keys past the stage's are zero rows with weight 0
#pragma unroll 4
    for (int k = 0; k < SK; k += 4) {
      float4 pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (rg + kGroups * i) * G::kPRow + k);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vf[CW];
        load_elems<P, CW>(Vs + (k + u) * kRow + c0 * P::kBytes, vf);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float pr = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int e = 0; e < CW; ++e) sacc[i][e] = fmaf(pr, vf[e], sacc[i][e]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)  // the running sum rescaled, plus the stage's
#pragma unroll
      for (int e = 0; e < CW; ++e) acc[i][e] = fmaf(acc[i][e], al[i], sacc[i][e]);
  }
  if (c0 < a.d)
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg + kGroups * i;
      if (r >= it.R) continue;
      const int j = r / it.group;
#pragma unroll
      for (int e = 0; e < CW; ++e)
        put<QT>(a, it.t0 + j, it.g * it.group + (r - j * it.group), c0 + e, vr[i], it.sp,
                acc[i][e], m[i], l[i]);
    }
  cp_wait<0>();
}

// One item: the split's table entries, the ring's first stages, then the
// narrow or the wide path. Ends with a barrier, so the caller may reuse
// shared memory.
template <typename QT, class P, int D>
__device__ __forceinline__ void run_item(const Args& a, uint8_t* smem, int t0, int nt, int sp,
                                         int g, int row, const int* tv, int group) {
  using G = Geo<P, D>;
  int* tbl = reinterpret_cast<int*>(smem + G::kTblOff);
  int vmax = 0;
  for (int j = 0; j < nt; ++j) vmax = max(vmax, tv[j]);
  const int k0 = sp * kSplitKeys;
  const int k1 = min(k0 + kSplitKeys, vmax);
  const int p0 = k0 / a.bs;
  const int np = (k1 - 1) / a.bs - p0 + 1;
  for (int i = threadIdx.x; i < np; i += kThreads)
    tbl[i] = a.tables[static_cast<size_t>(row) * a.width + p0 + i];
  __syncthreads();  // the table slice, before the copies read it
  const Item<P, D> it{a, smem, tv, tbl, t0, nt, sp, g, group, nt * group, k0, k1,
                      (k1 - k0 + G::SK - 1) / G::SK, p0};
#pragma unroll
  for (int st = 0; st < G::kStages - 1; ++st) {
    if (st < it.nst) it.issue(st);
    cp_commit();
  }
  if (it.R == 1)
    narrow<QT, P, D, 1>(it);
  else if (it.R <= 4)
    narrow<QT, P, D, 4>(it);
  else if (it.R <= kNarrowRows)
    narrow<QT, P, D, 8>(it);
  else
    wide<QT, P, D>(it);
  __syncthreads();  // shared memory is the next item's
}

// ------------------------------------------------------------- kernels
// kDecode (#9): token t reads table row t, so every live token is a tile of
// its own and only single-token tiles are planned.
template <typename QT, class P, int D, bool kDecode>
__global__ void __launch_bounds__(kThreads, 2) attn_kernel(const Args a) {
  extern __shared__ uint4 smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_raw);
  __shared__ int s_row[kPlanSpan], s_val[kPlanSpan], s_red[2 * kWarps], s_item[4];
  constexpr int kFirst = kDecode ? 1 : 0;  // the first class of tiles planned
  const int tid = threadIdx.x;
  const int group = a.Hq / a.Hkv;
  const int mt = group >= kTileRows ? 1 : kTileRows / group;  // tokens a tile
  const int cap = a.width * a.bs;                              // keys a table row holds
  int next = blockIdx.x;  // this block's next item
  int base = 0;           // items before the current chunk of tokens
  for (int cls = kFirst; cls < 2; ++cls) {  // tiles of several tokens first
    int carry = -1;                         // the last run head before the chunk
    for (int c0 = 0; c0 < a.T; c0 += kThreads) {
      if (cls == kFirst || a.T > kThreads) {  // one chunk is read once
        for (int i = tid; i < kPlanSpan; i += kThreads) {
          const int t = c0 - 1 + i;
          const bool in = t >= 0 && t < a.T;
          s_val[i] = in ? min(a.valids[t], cap) : 0;  // <= 0: not live
          s_row[i] = in ? (kDecode ? t : a.rows[t]) : -1;
        }
        __syncthreads();
      }
      const int t = c0 + tid, i = tid + 1;
      const bool live = s_val[i] > 0;
      const bool head = live && (s_val[i - 1] <= 0 || s_row[i - 1] != s_row[i]);
      int chunk_head;
      const int rs = max(carry, scan_max(head ? t : -1, s_red, &chunk_head));
      carry = max(carry, chunk_head);
      int ntok = 0, full = 0, part = 0;  // the tile's full splits, its partial one
      if (live && (t - rs) % mt == 0) {  // a tile starts at t
        int vmax = s_val[i];
        ntok = 1;
        while (ntok < mt && s_val[i + ntok] > 0 && s_row[i + ntok] == s_row[i]) {
          vmax = max(vmax, s_val[i + ntok]);
          ++ntok;
        }
        if ((ntok > 1) == (cls == 0)) {
          full = vmax / kSplitKeys;
          part = splits_of(vmax) - full;
        }
      }
      // the chunk's items: every tile's full splits, then the partial ones
      int2 total;
      const int2 off = scan_sum2(full * a.Hkv, part * a.Hkv, s_red, &total);
      for (; next < base + total.x + total.y; next += gridDim.x) {
        const int n = next - base;
        const int m = n < total.x ? n - off.x : n - total.x - off.y;
        if (m >= 0 && m < (n < total.x ? full : part) * a.Hkv) {
          s_item[0] = tid;
          s_item[1] = ntok;
          s_item[2] = (n < total.x ? 0 : full) + m / a.Hkv;  // split
          s_item[3] = m % a.Hkv;                             // kv head
        }
        __syncthreads();
        const int j0 = s_item[0] + 1;
        run_item<QT, P, D>(a, smem, c0 + s_item[0], s_item[1], s_item[2], s_item[3], s_row[j0],
                           s_val + j0, group);
      }
      base += total.x + total.y;
    }
  }
  // pads: this block zeroes tokens b, b + grid, ... with valids <= 0
  QT* out = static_cast<QT*>(a.out);
  const int hd = a.Hq * a.d;
  for (int t = blockIdx.x; t < a.T; t += gridDim.x)
    if (a.valids[t] <= 0)
      for (int c = tid; c < hd; c += kThreads) out[static_cast<size_t>(t) * hd + c] = from_f<QT>(0.f);
}

// The merge of the tokens of several splits: a warp per (token, head), its
// splits in split order (loads a batch of splits ahead).
template <typename QT>
__global__ void __launch_bounds__(kThreads) combine_kernel(const Args a) {
  constexpr int kBatch = 8;
  const int t = blockIdx.x;
  const int h = blockIdx.y * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (h >= a.Hq) return;
  const int valid = min(a.valids[t], a.width * a.bs);
  const int n = splits_of(valid);
  if (valid <= 0 || n < 2) return;
  const size_t slot = (static_cast<size_t>(t) * a.Hq + h) * a.nsp;
  const float2* ml =
      reinterpret_cast<const float2*>(a.part + static_cast<size_t>(a.T) * a.Hq * a.nsp * a.d);
  float M = -CUDART_INF_F;
  for (int s0 = 0; s0 < n; s0 += kBatch) {
    float mb[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) mb[b] = s0 + b < n ? ml[slot + s0 + b].x : -CUDART_INF_F;
#pragma unroll
    for (int b = 0; b < kBatch; ++b) M = fmaxf(M, mb[b]);
  }
  float L = 0.f, acc[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) acc[u] = 0.f;
  for (int s0 = 0; s0 < n; s0 += kBatch) {
    float2 e[kBatch];
    float x[kBatch][8];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const bool in = s0 + b < n;
      e[b] = in ? ml[slot + s0 + b] : make_float2(-CUDART_INF_F, 0.f);
      const float* src = a.part + (slot + s0 + b) * a.d;
#pragma unroll
      for (int u = 0; u < 8; ++u) x[b][u] = in && lane + 32 * u < a.d ? src[lane + 32 * u] : 0.f;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (s0 + b >= n) break;
      const float w = expf(e[b].x - M);
      L = fmaf(w, e[b].y, L);
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[u] = fmaf(w, x[b][u], acc[u]);
    }
  }
  QT* o = static_cast<QT*>(a.out) + (static_cast<size_t>(t) * a.Hq + h) * a.d;
#pragma unroll
  for (int u = 0; u < 8; ++u)
    if (lane + 32 * u < a.d) o[lane + 32 * u] = from_f<QT>(acc[u] / L);
}

// ---------------------------------------------------------------- host
// Bytes of `out` before the partials: q's bytes rounded up to 256.
inline size_t out_bytes(const Args& a, int q_bytes) {
  return (static_cast<size_t>(a.T) * a.Hq * a.d * q_bytes + 255) / 256 * 256;
}

template <typename QT, class P, int D, bool kDecode>
int launch(Args a, cudaStream_t stream) {
  using G = Geo<P, D>;
  auto kern = attn_kernel<QT, P, D, kDecode>;
  // blocks an SM holds, per device (the attribute is set once a device)
  static int occupancy[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int& occ = occupancy[dev & 63];
  if (occ == 0) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    int n = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kThreads, G::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    occ = n > 0 ? n : 1;
  }
  a.nsp = splits_of(a.width * a.bs);
  a.bs_shift = (a.bs & (a.bs - 1)) == 0 ? __builtin_ctz(static_cast<unsigned>(a.bs)) : -1;
  a.part = reinterpret_cast<float*>(static_cast<uint8_t*>(a.out) + out_bytes(a, sizeof(QT)));
  const long long items = static_cast<long long>(a.T) * a.nsp * a.Hkv;
  const long long cap = static_cast<long long>(hopper::sm_count()) * occ;
  const int grid = static_cast<int>(items < cap ? items : cap);
  kern<<<grid, kThreads, G::kSmem, stream>>>(a);
  if (a.nsp > 1) {
    dim3 cgrid(a.T, (a.Hq + kWarps - 1) / kWarps);
    combine_kernel<QT><<<cgrid, kThreads, 0, stream>>>(a);
  }
  PTT_RETURN_LAUNCH_ERROR();
}

template <typename QT, class P, bool kDecode = false>
int dispatch_d(const Args& a, cudaStream_t s) {
  switch (head_dim_bucket(a.d)) {
    case 64:
      return launch<QT, P, 64, kDecode>(a, s);
    case 128:
      return launch<QT, P, 128, kDecode>(a, s);
    case 256:
      return launch<QT, P, 256, kDecode>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace ragged
