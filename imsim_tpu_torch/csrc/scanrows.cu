// K1: ordinal-order prefix sum of slot-layout deltas, and K4: the plain
// lane prefix sum.  Both are one pass with a decoupled look-back whose
// bits repeat (one copy, `resolve_tile`, serves both).
//
// K1 replaces imsim_tpu/ops/scanrows.py::scan_slot_prefix (Pallas
// _kernel_slot_mxu, a triangular-matmul scan on the TPU's matrix unit
// over a sequential grid that carries the running total in VMEM).
// K4 replaces imsim_tpu/ops/scanrows.py::scan_lanes (Pallas _kernel, a
// sequential grid carrying the running row total in VMEM).
//
// K1.  Input d (C, pe, mp) float32: plane beta, column q holds the delta
// of photon ordinal j = pe*q + mu(beta).  Output out[c, beta, q] = sum of
// d[c] over all slots with ordinal <= that of (beta, q).  Column q
// therefore holds pe consecutive ordinals, and the ordinal sequence is:
// columns in q order, and within a column the planes in mu order.
//
// Bound on the H100: bytes.  One add per element against 4 B read once
// and 4 B written once (the bench CCD: C = 24, pe = 16, mp = 1.17e6,
// 3.59 GB a call, >= 1.07 ms at 3.35 TB/s).  The card has no ordered
// grid, so the carry between tiles goes through device memory.  Design,
// one read and one write of each element:
//   * a tile is one row c: all pe planes of W consecutive columns, W a
//     multiple of 128 with pe * W <= 16,384 floats (64 KB of dynamic
//     shared memory, three blocks an SM), whatever pe is; a block of 256
//     threads loads it once with coalesced 16-byte __ldg loads (each
//     plane row is contiguous in q; masked scalar loads where mp % 4 != 0
//     or a base is off 16 bytes, zeros past the row's end);
//   * thread t owns the four columns of quad k = r * 256 + t in each round
//     r (one round at pe = 16): it sums each column's planes from shared
//     memory, scans the quad serially; the quad totals go through
//     interleaved warp shuffle scans and one warp scan of the (round,
//     warp) parts (K4's scheme);
//   * tile ids come from an atomicAdd counter in row-major (row, tile)
//     order, not from blockIdx, so a tile waits only on tiles that took
//     their id earlier and are running; each tile publishes a 64-bit
//     status word {flag in the high half: 0 none, 1 the tile's aggregate,
//     2 its inclusive prefix; the float's bits in the low half} with
//     st.release.gpu (read with ld.acquire.gpu), its aggregate before the
//     look-back and its prefix after it;
//   * the look-back folds serially, oldest first: warp 0 watches the 32
//     nearest predecessors, waits until the window holds an inclusive
//     prefix P_j and every tile after j has its aggregate, and computes
//     fl(...fl(fl(P_j + a_{j+1}) + a_{j+2})... + a_{i-1}); with no prefix
//     in the window it waits (the window's oldest tile took its id first
//     and will publish).  The tile publishes P_i = fl(excl + a_i), so by
//     induction every P_i is the chained fl(P_{i-1} + a_i) whichever
//     tiles happened to publish first: the output repeats bit for bit;
//   * then each thread walks its columns' planes in mu order from shared
//     memory and writes each running sum once, as a streaming float4
//     store (__stcs; scalar where mp % 4 != 0);
//   * one launch a call; the wrapper zeroes the status words and the
//     counter on the stream (torch allocator memory, nothing static), so
//     back-to-back calls and calls on two streams share no state.
// Order of the float32 sum: a column's planes in plane order for its
// total and in mu order for its running sums; serial within a quad, a
// tree (warp shuffles, then one warp) across the tile's quads; a chain
// across the tiles of a row.  The tail q >= mp is masked, so any mp
// works.  No tensor cores and no TF32: a prefix sum in slot order is
// not a matrix product on this card.
//
// K4.  out[c, n] = sum of x[c, 0..n] over x (C, N) float32, any N.  Bound:
// bytes, one read and one write (3.22 GB at the probe's 24 x 16,777,216,
// >= 0.96 ms at 3.35 TB/s).  Design, one pass with the same look-back
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA NVR-2016-002):
//   * a tile is kLbTile = 16,384 columns of one row; a block of 512
//     threads loads it as 8 coalesced float4s per thread (__ldg: thread
//     t holds float4 t of each 2,048-column chunk, 128 B in flight per
//     thread), scans each float4 serially, the eight chunks' float4
//     totals with eight interleaved warp shuffle scans, and the 128
//     (chunk, warp) totals in warp 0 (`resolve_tile`): two barriers per
//     tile.  Fewer columns per tile measured slower (4,096: 1.60 ms),
//     more no faster (PERF.md);
//   * one tile per block: a persistent block that loads its next tile
//     during the look-back measured 2x slower, since each tile's
//     aggregate then goes out a whole tile later and the look-backs
//     behind it wait;
//   * outputs are __stcs float4s (nothing re-reads them).
// Order of the float32 sum: serial within a float4, a tree within the
// tile, a chain across the tiles of a row (the serial look-back), so K4
// too repeats bit for bit.  N % 4 != 0 or a base off 16 bytes takes
// masked scalar loads and stores.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned long long kFlagAggregate = 1ull << 32;
constexpr unsigned long long kFlagPrefix = 2ull << 32;

// ---- the look-back, shared by K1 and K4 ---------------------------------

__device__ __forceinline__ void publish(unsigned long long* p, float v,
                                        unsigned long long flag) {
  const unsigned long long word = flag | __float_as_uint(v);
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(word)
               : "memory");
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* p) {
  unsigned long long word;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(word)
               : "l"(p)
               : "memory");
  return word;
}

// The tile's exclusive prefix from its predecessors' status words st[0 ..
// tile - 1]; run by one whole warp, tile > 0.  Lane l watches tile - 1 -
// l.  Waits until the window holds an inclusive prefix P_j and every tile
// after j has published its aggregate, then folds serially from P_j,
// oldest first, so the result is the chained scan's value bit for bit.
__device__ float look_back(const unsigned long long* st, int tile) {
  const int lane = threadIdx.x & 31;
  const int idx = tile - 1 - lane;
  // before the row's first tile: a zero prefix (never reached: tile 0
  // always publishes its prefix, and lies nearer)
  unsigned long long word = idx >= 0 ? peek(st + idx) : kFlagPrefix;
  for (;;) {
    const unsigned flag = static_cast<unsigned>(word >> 32);
    const unsigned prefixes = __ballot_sync(kAll, flag == 2u);
    const unsigned missing = __ballot_sync(kAll, flag == 0u);
    if (prefixes) {
      const int s = __ffs(prefixes) - 1;  // the nearest prefix
      if ((missing & ((1u << s) - 1u)) == 0u) {
        const float v = __uint_as_float(static_cast<unsigned>(word));
        float acc = 0.f;
#pragma unroll
        for (int l = 31; l >= 0; --l) {
          const float w = __shfl_sync(kAll, v, l);
          if (l == s) {
            acc = w;
          } else if (l < s) {
            acc += w;
          }
        }
        return acc;
      }
    }
    if (flag != 2u) word = peek(st + idx);
  }
}

// Warp 0 of a tile: part[0 .. NP) holds the tile's partial totals in
// column order.  Scans them, publishes the tile's aggregate, looks back
// for its exclusive prefix, publishes its inclusive prefix fl(excl +
// aggregate) and replaces each part by the row's sum before it.
template <int NP>
__device__ void resolve_tile(float* part, unsigned long long* st,
                             int tile) {
  constexpr int kPerLane = (NP + 31) / 32;
  const int lane = threadIdx.x & 31;
  float q[kPerLane];  // lane l: parts l * kPerLane + e, inclusive
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const int i = lane * kPerLane + e;
    q[e] = i < NP ? part[i] : 0.f;
    if (e > 0) q[e] += q[e - 1];
  }
  float p = q[kPerLane - 1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kAll, p, o);
    if (lane >= o) p += y;
  }
  const float aggregate = __shfl_sync(kAll, p, 31);
  float within = __shfl_up_sync(kAll, p, 1);
  if (lane == 0) within = 0.f;
  float before = 0.f;
  if (tile > 0) {
    if (lane == 0) publish(st + tile, aggregate, kFlagAggregate);
    before = look_back(st, tile);
  }
  if (lane == 0) publish(st + tile, before + aggregate, kFlagPrefix);
  const float head = before + within;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const int i = lane * kPerLane + e;
    if (i < NP) part[i] = e > 0 ? head + q[e - 1] : head;
  }
}

// ---- K1: the slot-order scan ---------------------------------------------

constexpr int kMaxPe = 64;
constexpr int kSlotThreads = 256;
constexpr int kSlotWarps = kSlotThreads / 32;
constexpr int kSlotTileFloats = 16384;  // pe planes x W columns, at most
constexpr int kSlotLoads = kSlotTileFloats / 4 / kSlotThreads;  // float4s
constexpr int kSlotLoadBatch = 8;       // float4 loads in flight a thread
static_assert(kSlotLoads % kSlotLoadBatch == 0, "whole load batches");

struct MuOrder {
  int beta[kMaxPe];  // plane of member mu
};

// Columns per tile: a multiple of 128 with pe * W <= kSlotTileFloats.
__host__ __device__ inline int slot_tile_columns(int pe) {
  const int w = 128 * (kSlotTileFloats / 128 / pe);
  return w > 128 ? w : 128;
}

// ROUNDS: quads a thread owns, at least ceil(W / 4 / kSlotThreads).
template <bool VEC, int ROUNDS>
__global__ void __launch_bounds__(kSlotThreads)
slot_scan_kernel(const float* __restrict__ d, float* __restrict__ out,
                 int pe, long long mp, int width, int ntr,
                 unsigned long long* status, unsigned long long* counter,
                 const __grid_constant__ MuOrder ord) {
  extern __shared__ float4 tile_s[];  // plane b, quad k: [b * quads + k]
  __shared__ int tile_id;
  __shared__ float part[ROUNDS * kSlotWarps];  // (round, warp) totals
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) tile_id = static_cast<int>(atomicAdd(counter, 1ull));
  __syncthreads();
  const int row = tile_id / ntr;
  const int tile = tile_id - row * ntr;
  const size_t plane0 = static_cast<size_t>(row) * pe * mp;
  const float* dr = d + plane0;
  float* orow = out + plane0;
  const long long q0 = static_cast<long long>(tile) * width;
  const int quads = width >> 2;
  const int nf = pe * quads;  // float4s in the tile, <= kSlotLoads * 256

  // ---- load: float4 f = u * 256 + t of the tile, zeros past the row
#pragma unroll
  for (int u0 = 0; u0 < kSlotLoads; u0 += kSlotLoadBatch) {
    float4 v[kSlotLoadBatch];
#pragma unroll
    for (int u = 0; u < kSlotLoadBatch; ++u) {
      const int f = (u0 + u) * kSlotThreads + t;
      const int b = f / quads;
      const long long q = q0 + 4 * (f - b * quads);
      const float* src = dr + static_cast<size_t>(b) * mp + q;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (f < nf) {
        if (VEC) {
          if (q < mp) v[u] = __ldg(reinterpret_cast<const float4*>(src));
        } else {
          if (q < mp) v[u].x = __ldg(src);
          if (q + 1 < mp) v[u].y = __ldg(src + 1);
          if (q + 2 < mp) v[u].z = __ldg(src + 2);
          if (q + 3 < mp) v[u].w = __ldg(src + 3);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kSlotLoadBatch; ++u) {
      const int f = (u0 + u) * kSlotThreads + t;
      if (f < nf) tile_s[f] = v[u];
    }
  }
  __syncthreads();

  // ---- column totals, the quad's serial scan, the warps' scans
  float4 col[ROUNDS];  // inclusive across the quad's four columns
  float s[ROUNDS];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int k = r * kSlotThreads + t;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < quads) {
      for (int b = 0; b < pe; ++b) {
        const float4 x = tile_s[b * quads + k];
        a.x += x.x;
        a.y += x.y;
        a.z += x.z;
        a.w += x.w;
      }
    }
    a.y += a.x;
    a.z += a.y;
    a.w += a.z;
    col[r] = a;
    s[r] = a.w;
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const float y = __shfl_up_sync(kAll, s[r], o);
      if (lane >= o) s[r] += y;
    }
  }
  float excl[ROUNDS];  // the lanes before this one, per round
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    excl[r] = __shfl_up_sync(kAll, s[r], 1);
    if (lane == 0) excl[r] = 0.f;
    if (lane == 31) part[r * kSlotWarps + warp] = s[r];
  }
  __syncthreads();

  // ---- warp 0: the parts' prefixes, the tile's status, the look-back
  if (warp == 0) {
    resolve_tile<ROUNDS * kSlotWarps>(
        part, status + static_cast<size_t>(row) * ntr, tile);
  }
  __syncthreads();

  // ---- outputs: each column's planes in mu order, one store each
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int k = r * kSlotThreads + t;
    const long long q = q0 + 4 * k;
    if (k >= quads || q >= mp) continue;
    const float pre = part[r * kSlotWarps + warp] + excl[r];
    float4 acc = make_float4(pre, pre + col[r].x, pre + col[r].y,
                             pre + col[r].z);
    for (int m = 0; m < pe; ++m) {
      const int b = ord.beta[m];
      const float4 x = tile_s[b * quads + k];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
      float* dst = orow + static_cast<size_t>(b) * mp + q;
      if (VEC) {
        __stcs(reinterpret_cast<float4*>(dst), acc);
      } else {
        __stcs(dst, acc.x);
        if (q + 1 < mp) __stcs(dst + 1, acc.y);
        if (q + 2 < mp) __stcs(dst + 2, acc.z);
        if (q + 3 < mp) __stcs(dst + 3, acc.w);
      }
    }
  }
}

template <bool VEC, int ROUNDS>
int launch_slot_scan(const float* d, float* out, int C, int pe, long long mp,
                     int width, int ntr, unsigned long long* status,
                     const MuOrder& ord, cudaStream_t s) {
  auto kernel = slot_scan_kernel<VEC, ROUNDS>;
  // the 64 KB tile needs the opt-in above 48 KB (set on the current
  // device, so every launch sets it)
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSlotTileFloats * static_cast<int>(sizeof(float)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = pe * width * static_cast<int>(sizeof(float));
  const unsigned blocks = static_cast<unsigned>(ntr) * C;
  unsigned long long* counter = status + static_cast<size_t>(ntr) * C;
  kernel<<<blocks, kSlotThreads, smem, s>>>(d, out, pe, mp, width, ntr,
                                            status, counter, ord);
  return imsim_last_error();
}

template <bool VEC>
int slot_scan(const float* d, float* out, int C, int pe, long long mp,
              unsigned long long* status, const MuOrder& ord,
              cudaStream_t s) {
  const int width = slot_tile_columns(pe);
  const int ntr = static_cast<int>((mp + width - 1) / width);
  const int rounds = (width / 4 + kSlotThreads - 1) / kSlotThreads;
  if (rounds <= 1) {
    return launch_slot_scan<VEC, 1>(d, out, C, pe, mp, width, ntr, status,
                                    ord, s);
  }
  if (rounds <= 4) {
    return launch_slot_scan<VEC, 4>(d, out, C, pe, mp, width, ntr, status,
                                    ord, s);
  }
  return launch_slot_scan<VEC, 16>(d, out, C, pe, mp, width, ntr, status,
                                   ord, s);
}

// ---- K4: the lane scan ---------------------------------------------------

constexpr int kLbThreads = 512;
constexpr int kLbVec = 8;                          // float4s per thread
constexpr int kLbChunk = 4 * kLbThreads;           // columns per chunk
constexpr int kLbTile = kLbVec * kLbChunk;         // 16,384 columns
constexpr int kLbWarps = kLbThreads / 32;
constexpr int kLbParts = kLbVec * kLbWarps;        // (chunk, warp) totals
static_assert(kLbParts % 32 == 0, "one warp scans the tile's parts");

template <bool VEC>
__global__ void __launch_bounds__(kLbThreads)
lookback_scan_kernel(const float* __restrict__ x, float* __restrict__ out,
                     long long N, int ntr, unsigned long long* status,
                     unsigned long long* counter) {
  __shared__ int tile_id;
  __shared__ float part[kLbParts];  // (chunk, warp) totals, then prefixes
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) tile_id = static_cast<int>(atomicAdd(counter, 1ull));
  __syncthreads();
  const int row = tile_id / ntr;
  const int tile = tile_id - row * ntr;
  const float* xr = x + static_cast<size_t>(row) * N;
  float* orow = out + static_cast<size_t>(row) * N;
  const long long c0 = static_cast<long long>(tile) * kLbTile + 4 * t;

  // ---- load: float4 t of each chunk, masked past the row's end
  float4 v[kLbVec];
#pragma unroll
  for (int u = 0; u < kLbVec; ++u) {
    const long long c = c0 + u * kLbChunk;
    if (VEC) {
      v[u] = c < N ? __ldg(reinterpret_cast<const float4*>(xr + c))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      v[u].x = c < N ? __ldg(xr + c) : 0.f;
      v[u].y = c + 1 < N ? __ldg(xr + c + 1) : 0.f;
      v[u].z = c + 2 < N ? __ldg(xr + c + 2) : 0.f;
      v[u].w = c + 3 < N ? __ldg(xr + c + 3) : 0.f;
    }
  }

  // ---- inclusive scans: each float4, then the float4 totals per warp
  float s[kLbVec];
#pragma unroll
  for (int u = 0; u < kLbVec; ++u) {
    v[u].y += v[u].x;
    v[u].z += v[u].y;
    v[u].w += v[u].z;
    s[u] = v[u].w;
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int u = 0; u < kLbVec; ++u) {
      const float y = __shfl_up_sync(kAll, s[u], o);
      if (lane >= o) s[u] += y;
    }
  }
  float excl[kLbVec];  // the lanes before this one, per chunk
#pragma unroll
  for (int u = 0; u < kLbVec; ++u) {
    excl[u] = __shfl_up_sync(kAll, s[u], 1);
    if (lane == 0) excl[u] = 0.f;
    if (lane == 31) part[u * kLbWarps + warp] = s[u];
  }
  __syncthreads();

  // ---- warp 0: the parts' prefixes, the tile's status, the look-back
  if (warp == 0) {
    resolve_tile<kLbParts>(part, status + static_cast<size_t>(row) * ntr,
                           tile);
  }
  __syncthreads();

  // ---- outputs
#pragma unroll
  for (int u = 0; u < kLbVec; ++u) {
    const long long c = c0 + u * kLbChunk;
    const float pre = part[u * kLbWarps + warp] + excl[u];
    const float4 o = make_float4(pre + v[u].x, pre + v[u].y, pre + v[u].z,
                                 pre + v[u].w);
    if (VEC) {
      if (c < N) __stcs(reinterpret_cast<float4*>(orow + c), o);
    } else {
      if (c < N) __stcs(orow + c, o.x);
      if (c + 1 < N) __stcs(orow + c + 1, o.y);
      if (c + 2 < N) __stcs(orow + c + 2, o.z);
      if (c + 3 < N) __stcs(orow + c + 3, o.w);
    }
  }
}

}  // namespace

// K1: the status words (one a tile, then the tile counter) that
// imsim_scan_slot_prefix needs for d (C, pe, mp).
IMSIM_API long long imsim_scan_slot_status_words(int C, int pe,
                                                 long long mp) {
  if (C <= 0 || mp <= 0 || pe <= 0 || pe > kMaxPe) return 1;
  const int width = slot_tile_columns(pe);
  return static_cast<long long>(C) * ((mp + width - 1) / width) + 1;
}

// K1: ordinal-order prefix sum of d (C, pe, mp); mu_to_beta[m] is the
// plane of member m; status holds imsim_scan_slot_status_words(C, pe,
// mp) zeroed 64-bit words.
IMSIM_API int imsim_scan_slot_prefix(const float* d, float* out,
                                     unsigned long long* status, int C,
                                     int pe, long long mp,
                                     const int* mu_to_beta, void* stream) {
  if (C <= 0 || mp <= 0) return 0;
  if (pe <= 0 || pe > kMaxPe) return static_cast<int>(cudaErrorInvalidValue);
  const long long ntr = (mp + slot_tile_columns(pe) - 1) /
                        slot_tile_columns(pe);
  if (ntr * C > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  MuOrder ord;
  for (int m = 0; m < kMaxPe; ++m) ord.beta[m] = m < pe ? mu_to_beta[m] : 0;
  const bool vec = mp % 4 == 0 && reinterpret_cast<uintptr_t>(d) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? slot_scan<true>(d, out, C, pe, mp, status, ord, s)
             : slot_scan<false>(d, out, C, pe, mp, status, ord, s);
}

// K4: inclusive prefix sum along axis 1 of x (C, N), any N.  status holds
// C * ceil(N / imsim_scan_lanes_tile_columns()) + 1 zeroed 64-bit words
// (the tiles' status words, then the tile counter).
IMSIM_API int imsim_scan_lanes(const float* x, float* out,
                               unsigned long long* status, int C, long long N,
                               void* stream) {
  if (C <= 0 || N <= 0) return 0;
  const long long ntr = (N + kLbTile - 1) / kLbTile;
  if (ntr * C > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const unsigned blocks = static_cast<unsigned>(ntr * C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* counter = status + ntr * C;
  if (vec) {
    lookback_scan_kernel<true><<<blocks, kLbThreads, 0, s>>>(
        x, out, N, static_cast<int>(ntr), status, counter);
  } else {
    lookback_scan_kernel<false><<<blocks, kLbThreads, 0, s>>>(
        x, out, N, static_cast<int>(ntr), status, counter);
  }
  return imsim_last_error();
}

IMSIM_API int imsim_scan_lanes_tile_columns() { return kLbTile; }

IMSIM_API const char* imsim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
