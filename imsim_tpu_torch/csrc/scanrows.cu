// K1: ordinal-order prefix sum of slot-layout deltas, and K4: the plain
// lane prefix sum, which is K1 with one plane (pe = 1).
//
// K1 replaces imsim_tpu/ops/scanrows.py::scan_slot_prefix (Pallas
// _kernel_slot_mxu, a triangular-matmul scan on the TPU's matrix unit).
// K4 replaces imsim_tpu/ops/scanrows.py::scan_lanes (Pallas _kernel, a
// sequential grid carrying the running row total in VMEM).
//
// Input d (C, pe, mp) float32: plane beta, column q holds the delta of
// photon ordinal j = pe*q + mu(beta).  Output out[c, beta, q] = sum of d
// over all slots with ordinal <= that of (beta, q).  Column q therefore
// holds pe consecutive ordinals, and the ordinal sequence is: columns in
// q order, and within a column the planes in mu order.  With pe = 1 this
// is the inclusive prefix sum of each row of a (C, N) matrix.
//
// Bound on the H100: memory.  About 3 flops per element against 4 B read
// twice and 4 B written once (K1 production: C = 24, pe = 16,
// mp ~ 1.04M, 1.6 GB per pass; K4 probe: C = 24, N = 16,777,216, also
// 1.6 GB, so one read and one write take >= 0.96 ms at 3.35 TB/s).
// The card has no ordered grid, so nothing carries between blocks.
// Design, simple and right first:
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

// K4: inclusive prefix sum along axis 1 of x (C, N); scratch holds
// C * ceil(N / kTile) floats.
IMSIM_API int imsim_scan_lanes(const float* x, float* out, float* scratch,
                               int C, long long N, void* stream) {
  if (C <= 0 || N <= 0) return 0;
  if (C > 65535) return static_cast<int>(cudaErrorInvalidValue);
  MuOrder ord = {};
  return scan_passes(x, out, scratch, C, 1, N, ord,
                     static_cast<cudaStream_t>(stream));
}

IMSIM_API const char* imsim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
