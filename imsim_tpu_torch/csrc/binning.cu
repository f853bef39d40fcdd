// K5: the binning scatter.  Each photon's flux is added into the pixel
// that its rounded (x, y) falls in; photons outside the frame are
// dropped.
//
// Replaces no TPU kernel: the JAX package bins with XLA's scatter-add.
// Its plain twin, ops/binning.bin_scatter_plain, is one masked
// `index_put_(accumulate=True)`, which on the card sorts its int64 keys
// and then sums each run of equal indices in one warp.  On a flat
// nearly every pixel gets one photon a sub-batch, so the sort buys
// nothing and the runs are one photon long.
//
// Bound on the H100: memory.  A photon reads x, y and flux (12 B, plain
// coalesced loads) and adds into a float32 frame of H * W pixels with a
// reduction (`atomicAdd` whose result is unused compiles to RED, which
// the L2 executes; the frame of a 4004 x 4096 CCD, 65.6 MB, is a little
// larger than the 50 MB L2).  Design:
//   * one grid-stride pass over the photons, kUnroll photons a thread
//     an iteration, all loads issued before the first reduction;
//   * x and y rounded as torch.round (rintf: half to even) and tested
//     against the frame in float, before any integer cast: NaN, inf and
//     huge coordinates are never indexed;
//   * every in-frame photon adds its flux, 0 included;
//   * with `stats`, three sums each reduced over the block and added
//     once a block: stats[0] += the in-frame flux, stats[1] += the
//     photons outside the frame, stats[2] += the photons whose flux is
//     neither 0 nor 1 (all in float64: exact for whole fluxes and for
//     counts below 2^53).
// The order in which a pixel's additions meet is the hardware's.  For
// fluxes of 0 and 1 every partial sum is a whole number below 2^24, so
// the frame comes out the same bit for bit in any order.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kBlocksPerSm = 8;

template <bool STATS>
__global__ void __launch_bounds__(kThreads)
bin_scatter_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ flux, long long n,
                   float* __restrict__ frame, int H, int W,
                   double* __restrict__ stats) {
  const float fw = static_cast<float>(W);
  const float fh = static_cast<float>(H);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  double in_flux = 0.0, off = 0.0, nonunit = 0.0;
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
       base < n; base += stride * kUnroll) {
    float px[kUnroll], py[kUnroll], pf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      const bool live = i < n;
      px[u] = live ? __ldg(x + i) : -1.0f;
      py[u] = live ? __ldg(y + i) : -1.0f;
      pf[u] = live ? __ldg(flux + i) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float fx = rintf(px[u]);
      const float fy = rintf(py[u]);
      const bool inb = fx >= 0.0f && fx < fw && fy >= 0.0f && fy < fh;
      if (inb) {
        atomicAdd(frame + static_cast<int>(fy) * W + static_cast<int>(fx),
                  pf[u]);
      }
      if (STATS && base + u * stride < n) {
        if (inb) {
          in_flux += pf[u];
        } else {
          off += 1.0;
        }
        if (pf[u] != 0.0f && pf[u] != 1.0f) nonunit += 1.0;
      }
    }
  }
  if (STATS) {
    __shared__ double part[3][kWarps];
    for (int o = 16; o > 0; o /= 2) {
      in_flux += __shfl_down_sync(0xffffffffu, in_flux, o);
      off += __shfl_down_sync(0xffffffffu, off, o);
      nonunit += __shfl_down_sync(0xffffffffu, nonunit, o);
    }
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    if (lane == 0) {
      part[0][warp] = in_flux;
      part[1][warp] = off;
      part[2][warp] = nonunit;
    }
    __syncthreads();
    if (threadIdx.x < 3) {
      double s = 0.0;
      for (int w = 0; w < kWarps; ++w) s += part[threadIdx.x][w];
      atomicAdd(stats + threadIdx.x, s);
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      sms = 0;
      return 132;
    }
  }
  return sms;
}

}  // namespace

// Adds each in-frame photon's flux into frame (H, W), in place; stats
// (3 float64, or null) as the kernel's note says.  The frame is indexed
// in int, so H * W must stay below 2^31.
IMSIM_API int imsim_bin_scatter(const float* x, const float* y,
                                const float* flux, long long n, float* frame,
                                int H, int W, double* stats, void* stream) {
  if (H <= 0 || W <= 0 || n < 0 ||
      static_cast<long long>(H) * W > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const long long per_block = kThreads * kUnroll;
  const long long need = (n + per_block - 1) / per_block;
  const long long most = static_cast<long long>(sm_count()) * kBlocksPerSm;
  const int grid = static_cast<int>(need < most ? need : most);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stats != nullptr) {
    bin_scatter_kernel<true><<<grid, kThreads, 0, s>>>(x, y, flux, n, frame,
                                                       H, W, stats);
  } else {
    bin_scatter_kernel<false><<<grid, kThreads, 0, s>>>(x, y, flux, n, frame,
                                                        H, W, nullptr);
  }
  return imsim_last_error();
}
