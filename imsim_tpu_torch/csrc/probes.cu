// P1-P7: the kernels of the on-chip stencil probes.
//
// Replaces benchmarks/probe_pallas.py::p1 (copy_kernel) with
// scale_copy_kernel, and probe_pallas.py::p2..p5 (dma_kernel,
// smem_kernel, sten1_kernel, sten2_kernel) and probe_pallas2.py::mk and
// mk2 (bodies ka..kh, ki, kh2, kh3) with window_taps_kernel.
//
// P1: out = s * x over n floats.  Bound on the H100: memory, 4 B read and
// 4 B written per element (134 MB for the probe's 4096^2 frame, >= 0.04 ms
// at 3.35 TB/s).  Each thread moves one float4 (16-byte loads and stores,
// neighbouring threads on neighbouring addresses); the n % 4 tail is done
// by the first threads with scalar accesses.
//
// P2-P7: out_o[r, c] = sum_t w_o[t] * P[r + di[t], c + dj[t]] for o < nout
// (1 or 2), over a tap list in the TPU body's own order: one tap of unit
// weight (P2, P6 a and b: a window copy), one weighted tap (P3), the k
// taps of one row or one column (P6 c, d), or the k^2 taps of the full
// stencil (P4, P5, P6 e-h, P7).  The TPU bodies DMA a (TH + k - 1, Wp)
// halo slab into VMEM and read taps as unaligned slices or pltpu.roll
// shifts; the rolls never wrap inside the output window, so every body is
// this window sum.  Bound: the one-tap windows are copies (memory); the
// k^2-tap stencils are FMA throughput and shared-memory reads (compute).
// Design, as csrc/stencil.cu:
//   * one block per 32 x 32 output tile, 32 x 8 threads, each thread 4
//     rows; the (32 + k - 1)^2 halo of P is staged once in shared memory
//     (loads past P's edge are masked to zero; no valid output reads them);
//   * the tap list (shared-memory offset di * SW + dj, weight per output)
//     crosses by value in a __grid_constant__ struct, so tap reads are
//     warp-uniform constant-bank loads and concurrent launches with other
//     taps cannot race;
//   * k is a template parameter (the halo size), the tap count is not.
// Accumulation: one float32 FMA per tap in list order; a one-tap window
// is therefore a single rounding of w * P, exact for w = 1.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kCopyThreads = 256;
constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kRowsPerPass = 8;
constexpr int kMaxK = 11;
constexpr int kMaxTaps = kMaxK * kMaxK;

__global__ void __launch_bounds__(kCopyThreads)
scale_copy_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                  long long n4, const float* __restrict__ x_tail,
                  float* __restrict__ out_tail, int tail, float s) {
  const long long i = (long long)blockIdx.x * kCopyThreads + threadIdx.x;
  if (i < n4) {
    float4 v = x[i];
    v.x *= s;
    v.y *= s;
    v.z *= s;
    v.w *= s;
    out[i] = v;
  }
  if (i < tail) out_tail[i] = x_tail[i] * s;
}

struct WindowTaps {
  int ntaps;
  int off[kMaxTaps];      // di * SW + dj inside the shared halo tile
  float w[2][kMaxTaps];   // weight of each tap, per output
};

template <int K, int NOUT>
__global__ void __launch_bounds__(kTileW * kRowsPerPass)
window_taps_kernel(const float* __restrict__ P, float* __restrict__ o0,
                   float* __restrict__ o1, int Hp, int Wp, int H, int W,
                   const __grid_constant__ WindowTaps taps) {
  constexpr int SW = kTileW + K - 1;
  constexpr int SH = kTileH + K - 1;
  __shared__ float tile[SH * SW];
  const int gx0 = blockIdx.x * kTileW;
  const int gy0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int i = tid; i < SH * SW; i += kTileW * kRowsPerPass) {
    const int ty = i / SW;
    const int tx = i - ty * SW;
    const int gy = gy0 + ty;
    const int gx = gx0 + tx;
    tile[i] = (gy < Hp && gx < Wp) ? P[(size_t)gy * Wp + gx] : 0.f;
  }
  __syncthreads();
  const int x = gx0 + threadIdx.x;
  for (int r = threadIdx.y; r < kTileH; r += kRowsPerPass) {
    const int y = gy0 + r;
    const float* base = tile + r * SW + threadIdx.x;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 9
    for (int t = 0; t < taps.ntaps; ++t) {
      const float v = base[taps.off[t]];
      a0 = fmaf(taps.w[0][t], v, a0);
      if (NOUT == 2) a1 = fmaf(taps.w[1][t], v, a1);
    }
    if (x < W && y < H) {
      o0[(size_t)y * W + x] = a0;
      if (NOUT == 2) o1[(size_t)y * W + x] = a1;
    }
  }
}

template <int K>
int launch_window(const float* P, float* o0, float* o1, int Hp, int Wp,
                  int H, int W, int nout, const WindowTaps& taps,
                  cudaStream_t s) {
  dim3 block(kTileW, kRowsPerPass);
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  if (nout == 1) {
    window_taps_kernel<K, 1><<<grid, block, 0, s>>>(P, o0, o1, Hp, Wp, H, W,
                                                    taps);
  } else {
    window_taps_kernel<K, 2><<<grid, block, 0, s>>>(P, o0, o1, Hp, Wp, H, W,
                                                    taps);
  }
  return imsim_last_error();
}

}  // namespace

// P1: out = s * x, n floats; x and out 16-byte aligned.
IMSIM_API int imsim_scale_copy(const float* x, float* out, long long n,
                               float s, void* stream) {
  if (n <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
      15) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const long long n4 = n / 4;
  const int tail = static_cast<int>(n - 4 * n4);
  long long blocks = (n4 + kCopyThreads - 1) / kCopyThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  scale_copy_kernel<<<static_cast<unsigned>(blocks), kCopyThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), n4,
      x + 4 * n4, out + 4 * n4, tail, s);
  return imsim_last_error();
}

// P2-P7: out_o (H, W) = sum_t w_o[t] * P[r + di[t], c + dj[t]] over P
// (Hp, Wp); 0 <= di, dj < k (odd k <= 11); w1 is read only for nout = 2.
IMSIM_API int imsim_window_taps(const float* P, float* o0, float* o1,
                                int Hp, int Wp, int H, int W, int k,
                                int ntaps, int nout, const int* di,
                                const int* dj, const float* w0,
                                const float* w1, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  if (k < 1 || k > kMaxK || k % 2 == 0 || ntaps < 1 || ntaps > kMaxTaps ||
      nout < 1 || nout > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int SW = kTileW + k - 1;
  WindowTaps taps = {};
  taps.ntaps = ntaps;
  int max_di = 0, max_dj = 0;
  for (int t = 0; t < ntaps; ++t) {
    if (di[t] < 0 || di[t] >= k || dj[t] < 0 || dj[t] >= k) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    max_di = di[t] > max_di ? di[t] : max_di;
    max_dj = dj[t] > max_dj ? dj[t] : max_dj;
    taps.off[t] = di[t] * SW + dj[t];
    taps.w[0][t] = w0[t];
    taps.w[1][t] = nout == 2 ? w1[t] : 0.f;
  }
  if (H + max_di > Hp || W + max_dj > Wp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 3: return launch_window<3>(P, o0, o1, Hp, Wp, H, W, nout, taps, s);
    case 5: return launch_window<5>(P, o0, o1, Hp, Wp, H, W, nout, taps, s);
    case 7: return launch_window<7>(P, o0, o1, Hp, Wp, H, W, nout, taps, s);
    case 9: return launch_window<9>(P, o0, o1, Hp, Wp, H, W, nout, taps, s);
    case 11:
      return launch_window<11>(P, o0, o1, Hp, Wp, H, W, nout, taps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
