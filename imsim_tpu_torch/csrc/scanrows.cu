// K1: ordinal-order prefix sum of slot-layout deltas, and K4: the plain
// lane prefix sum.
//
// K1 replaces imsim_tpu/ops/scanrows.py::scan_slot_prefix (Pallas
// _kernel_slot_mxu, a triangular-matmul scan on the TPU's matrix unit).
// K4 replaces imsim_tpu/ops/scanrows.py::scan_lanes (Pallas _kernel, a
// sequential grid carrying the running row total in VMEM).
//
// K1.  Input d (C, pe, mp) float32: plane beta, column q holds the delta
// of photon ordinal j = pe*q + mu(beta).  Output out[c, beta, q] = sum of
// d over all slots with ordinal <= that of (beta, q).  Column q therefore
// holds pe consecutive ordinals, and the ordinal sequence is: columns in
// q order, and within a column the planes in mu order.
//
// Bound on the H100: memory.  About 3 flops per element against 4 B read
// twice and 4 B written once (production: C = 24, pe = 16, mp ~ 1.04M,
// 1.6 GB per pass).  The card has no ordered grid, so nothing carries
// between blocks.  Design, simple and right first:
//   (a) tile_sum: each block sums its tile of kTile columns over all
//       planes, for one c (blockIdx.y);
//   (b) carry_scan: one block per c turns the tile totals into exclusive
//       carries;
//   (c) tile_scan: each block rescans its tile with its carry: a block
//       exclusive scan of the column sums (kThreads consecutive columns
//       per round, so loads coalesce), then a walk down each column's
//       planes in mu order.
// Accumulation is float32 in cumsum order class (sequential within a
// column, tree within a block, sequential across blocks).  The tail
// q >= mp is masked, so any mp works.  No tensor cores: a prefix sum is
// not a matrix product on this card.
//
// K4.  out[c, n] = sum of x[c, 0..n] over x (C, N) float32, any N.  Bound:
// memory, one read and one write (3.22 GB at the probe's 24 x 16,777,216,
// >= 0.96 ms at 3.35 TB/s).  Design, one pass with decoupled look-back
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA NVR-2016-002):
//   * a tile is kLbTile = 16,384 columns of one row; a block of 512
//     threads loads it as 8 coalesced float4s per thread (__ldg: thread
//     t holds float4 t of each 2,048-column chunk, 128 B in flight per
//     thread), scans each float4 serially, the eight chunks' float4
//     totals with eight interleaved warp shuffle scans, and the 128
//     (chunk, warp) totals in warp 0, four per lane serially and one warp
//     scan: two barriers per tile.  Fewer columns per tile measured
//     slower (4,096: 1.60 ms), more no faster (PERF.md);
//   * tile ids come from an atomicAdd counter in row-major (row, tile)
//     order, not from blockIdx: a tile then only waits on tiles that
//     took their id earlier and are running, never on an unscheduled
//     block;
//   * each tile publishes one 64-bit status word, {flag in the high
//     half: 0 none, 1 the tile's aggregate, 2 its inclusive prefix; the
//     float's bits in the low half}, so a reader never sees a flag
//     without its value; stores are st.release.gpu, loads ld.acquire.gpu;
//     the aggregate goes out before the look-back, the prefix after it;
//   * warp 0 looks back over up to 32 predecessors per step: it waits
//     until none of them shows flag 0, takes the nearest one with a
//     prefix, and adds that prefix and the aggregates in between (a warp
//     sum); with no prefix in the window it adds all 32 aggregates and
//     steps back;
//   * outputs are __stcs float4s (nothing re-reads them);
//   * one tile per block: a persistent block that loads its next tile
//     during the look-back measured 2x slower, since each tile's
//     aggregate then goes out a whole tile later and the look-backs
//     behind it wait;
//   * the status words and the counter are zeroed on the stream by the
//     wrapper before each call (torch allocator memory, nothing static),
//     so back-to-back calls and calls on two streams share no state.
// Order of the float32 sum: serial within a float4, a tree within the
// tile, a chain across the tiles of a row.  Where a look-back adds three
// or more of its predecessors' words, the warp sum's order depends on
// which of them had published their prefix, so two runs may round
// differently (both within the bar; exact sums agree bitwise).  N % 4 != 0 or a base off 16
// bytes takes masked scalar loads and stores.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 4;
constexpr int kTile = kThreads * kRounds;  // columns per block
constexpr int kMaxPe = 64;

struct MuOrder {
  int beta[kMaxPe];  // plane of member mu
};

// Exclusive block-wide scan of one float per thread; *total gets the
// block sum.  Must be reached by every thread of the block.
__device__ float block_exclusive_scan(float v, float* total) {
  __shared__ float warp_tot[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    float y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  float excl = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) excl = 0.f;
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kThreads / 32 ? warp_tot[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      float y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kThreads / 32) warp_tot[lane] = w;  // inclusive
  }
  __syncthreads();
  const float before = warp > 0 ? warp_tot[warp - 1] : 0.f;
  *total = warp_tot[kThreads / 32 - 1];
  __syncthreads();  // warp_tot is reused by the next call
  return before + excl;
}

__global__ void __launch_bounds__(kThreads)
tile_sum_kernel(const float* __restrict__ d, float* __restrict__ tot,
                int pe, long long mp, int ntiles) {
  const int c = blockIdx.y;
  const int tile = blockIdx.x;
  const float* dc = d + (size_t)c * pe * mp;
  float s = 0.f;
  const long long q0 = (long long)tile * kTile;
  for (int r = 0; r < kRounds; ++r) {
    const long long q = q0 + (long long)r * kThreads + threadIdx.x;
    if (q < mp) {
      for (int b = 0; b < pe; ++b) s += dc[(size_t)b * mp + q];
    }
  }
  float total;
  block_exclusive_scan(s, &total);
  if (threadIdx.x == 0) tot[(size_t)c * ntiles + tile] = total;
}

__global__ void __launch_bounds__(kThreads)
carry_scan_kernel(float* __restrict__ tot, int ntiles) {
  float* t = tot + (size_t)blockIdx.x * ntiles;
  float run = 0.f;
  for (int base = 0; base < ntiles; base += kThreads) {
    const int i = base + threadIdx.x;
    const float v = i < ntiles ? t[i] : 0.f;
    float total;
    const float excl = block_exclusive_scan(v, &total);
    if (i < ntiles) t[i] = run + excl;
    run += total;
  }
}

__global__ void __launch_bounds__(kThreads)
tile_scan_kernel(const float* __restrict__ d, float* __restrict__ out,
                 const float* __restrict__ carry, int pe, long long mp,
                 int ntiles, const __grid_constant__ MuOrder ord) {
  const int c = blockIdx.y;
  const int tile = blockIdx.x;
  const size_t off = (size_t)c * pe * mp;
  const float* dc = d + off;
  float* oc = out + off;
  float run = carry[(size_t)c * ntiles + tile];
  const long long q0 = (long long)tile * kTile;
  for (int r = 0; r < kRounds; ++r) {
    const long long q = q0 + (long long)r * kThreads + threadIdx.x;
    const bool ok = q < mp;
    float col = 0.f;
    if (ok) {
      for (int b = 0; b < pe; ++b) col += dc[(size_t)b * mp + q];
    }
    float total;
    const float excl = block_exclusive_scan(col, &total);
    if (ok) {
      float acc = run + excl;
      for (int m = 0; m < pe; ++m) {
        const size_t i = (size_t)ord.beta[m] * mp + q;
        acc += dc[i];
        oc[i] = acc;
      }
    }
    run += total;
  }
}

// The three passes over d (C, pe, mp) with the planes' mu order.
int scan_passes(const float* d, float* out, float* scratch, int C, int pe,
                long long mp, const MuOrder& ord, cudaStream_t s) {
  const long long nt = (mp + kTile - 1) / kTile;
  if (nt > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = static_cast<int>(nt);
  dim3 grid(ntiles, C);
  tile_sum_kernel<<<grid, kThreads, 0, s>>>(d, scratch, pe, mp, ntiles);
  int err = imsim_last_error();
  if (err) return err;
  carry_scan_kernel<<<C, kThreads, 0, s>>>(scratch, ntiles);
  err = imsim_last_error();
  if (err) return err;
  tile_scan_kernel<<<grid, kThreads, 0, s>>>(d, out, scratch, pe, mp,
                                             ntiles, ord);
  return imsim_last_error();
}

// ---- K4: one pass with decoupled look-back ------------------------------

constexpr int kLbThreads = 512;
constexpr int kLbVec = 8;                          // float4s per thread
constexpr int kLbChunk = 4 * kLbThreads;           // columns per chunk
constexpr int kLbTile = kLbVec * kLbChunk;         // 16,384 columns
constexpr int kLbWarps = kLbThreads / 32;
constexpr int kLbParts = kLbVec * kLbWarps;        // (chunk, warp) totals
constexpr int kLbPartsPerLane = kLbParts / 32;
static_assert(kLbParts % 32 == 0, "one warp scans the tile's parts");
constexpr unsigned long long kFlagAggregate = 1ull << 32;
constexpr unsigned long long kFlagPrefix = 2ull << 32;

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
// tile - 1]; run by one whole warp, tile > 0.
__device__ float look_back(const unsigned long long* st, int tile) {
  const int lane = threadIdx.x & 31;
  float before = 0.f;
  for (int last = tile - 1;; last -= 32) {
    const int idx = last - lane;  // lane 0: the nearest predecessor
    // past tile 0 (which always holds its prefix) reads as a zero prefix
    unsigned long long word = idx >= 0 ? peek(st + idx) : kFlagPrefix;
    while (__any_sync(0xffffffffu, (word >> 32) == 0)) {
      if ((word >> 32) == 0) word = peek(st + idx);
    }
    const unsigned prefixes =
        __ballot_sync(0xffffffffu, (word >> 32) == (kFlagPrefix >> 32));
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    float v = lane <= stop ? __uint_as_float(static_cast<unsigned>(word))
                           : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    before += v;
    if (prefixes) break;
  }
  return before;
}

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
      const float y = __shfl_up_sync(0xffffffffu, s[u], o);
      if (lane >= o) s[u] += y;
    }
  }
  float excl[kLbVec];  // the lanes before this one, per chunk
#pragma unroll
  for (int u = 0; u < kLbVec; ++u) {
    excl[u] = __shfl_up_sync(0xffffffffu, s[u], 1);
    if (lane == 0) excl[u] = 0.f;
    if (lane == 31) part[u * kLbWarps + warp] = s[u];
  }
  __syncthreads();

  // ---- warp 0: the parts' prefixes, the tile's status, the look-back
  if (warp == 0) {
    // lane l takes kLbPartsPerLane consecutive parts (column order)
    float q[kLbPartsPerLane];
#pragma unroll
    for (int e = 0; e < kLbPartsPerLane; ++e) {
      q[e] = part[lane * kLbPartsPerLane + e];
      if (e > 0) q[e] += q[e - 1];
    }
    float p = q[kLbPartsPerLane - 1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, p, o);
      if (lane >= o) p += y;
    }
    const float aggregate = __shfl_sync(0xffffffffu, p, 31);
    float within = __shfl_up_sync(0xffffffffu, p, 1);
    if (lane == 0) within = 0.f;
    unsigned long long* st = status + static_cast<size_t>(row) * ntr;
    float before = 0.f;
    if (tile == 0) {
      if (lane == 0) publish(st, aggregate, kFlagPrefix);
    } else {
      if (lane == 0) publish(st + tile, aggregate, kFlagAggregate);
      before = look_back(st, tile);
      if (lane == 0) publish(st + tile, before + aggregate, kFlagPrefix);
    }
    const float head = before + within;
#pragma unroll
    for (int e = 0; e < kLbPartsPerLane; ++e) {
      part[lane * kLbPartsPerLane + e] = e > 0 ? head + q[e - 1] : head;
    }
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

IMSIM_API int imsim_scan_tile_columns() { return kTile; }

IMSIM_API int imsim_scan_slot_prefix(const float* d, float* out,
                                     float* scratch, int C, int pe,
                                     long long mp, const int* mu_to_beta,
                                     void* stream) {
  if (C <= 0 || mp <= 0) return 0;
  if (pe <= 0 || pe > kMaxPe || C > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MuOrder ord;
  for (int m = 0; m < kMaxPe; ++m) ord.beta[m] = m < pe ? mu_to_beta[m] : 0;
  return scan_passes(d, out, scratch, C, pe, mp, ord,
                     static_cast<cudaStream_t>(stream));
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
