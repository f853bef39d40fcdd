// P1-P7: the kernels of the on-chip stencil probes.
//
// Replaces benchmarks/probe_pallas.py::p1 (copy_kernel) with
// scale_copy_kernel; probe_pallas.py::p2, p3 (dma_kernel, smem_kernel)
// and probe_pallas2.py::mk's one-tap bodies ka, kb with
// window_copy_kernel; probe_pallas.py::p4, p5 (sten1_kernel,
// sten2_kernel) and probe_pallas2.py::mk and mk2 (bodies kc..kh, ki, kh2,
// kh3) with window_taps_kernel.
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
// this window sum.  imsim_window_taps sends one tap with one output to
// window_copy_kernel and every other tap list to window_taps_kernel.
//
// One tap (P2, P3, P6 a and b; replaces probe_pallas.py::p2, p3 and
// probe_pallas2.py::mk bodies ka, kb): out[r, c] = w * P[r + di, c + dj].
// Bound: bytes, 4 read and 4 written per output (134.2 MB for the probes'
// 4096^2 window, >= 0.040 ms at 3.35 TB/s).  Design, a copy on Hopper's
// memory path:
//   * no shared memory, no halo, no barrier: each thread stores float4s
//     of an output row with __stcs (nothing re-reads the output),
//     neighbouring threads on neighbouring addresses, and keeps
//     kWinUnroll 16-byte loads (__ldg, the read-only path) in flight;
//   * a work item is kWinSeg float4s of one row: a 256-thread block takes
//     4 x 1024 floats of a row per item, one item per block;
//   * each row is split at its own addresses (any W, Wp and base of P or
//     out): a head of up to 6 floats (until out is 16-byte aligned, 4
//     more where the source's boundary would fall before P's row),
//     float4 stores, and a tail of up to 6 floats, head and tail
//     scalar.  The
//     source of the body then starts s = 0..3 floats past a 16-byte
//     boundary; for s != 0 each thread loads its aligned float4, takes
//     the next one from lane + 1 with __shfl_down_sync (lane 31 loads its
//     own) and funnels the pair.  s is a template parameter of the row
//     body, switched per row and uniform across the block;
//   * every vector load lies inside the row of P it serves (no read
//     outside P) and holds a needed element;
//   * w * v, one rounding, exact for w = 1: outputs equal the twin's
//     bitwise, the sign of a zero included (fmaf(w, v, 0) would turn
//     w * v = -0 into +0).
// Not TMA: it would stage every byte through shared memory for a pass
// that does no arithmetic, and it needs 16-byte global strides and a
// 16-byte-aligned base, which the window's contract does not give.
//
// More taps: bound by FMA throughput and shared-memory reads (compute).
// Design, as csrc/stencil.cu:
//   * one block per 32 x 32 output tile, 32 x 8 threads, each thread 4
//     rows; the (32 + k - 1)^2 halo of P is staged once in shared memory
//     (loads past P's edge are masked to zero; no valid output reads them);
//   * the tap list (shared-memory offset di * SW + dj, weight per output)
//     crosses by value in a __grid_constant__ struct, so tap reads are
//     warp-uniform constant-bank loads and concurrent launches with other
//     taps cannot race;
//   * k is a template parameter (the halo size), the tap count is not.
// Accumulation: one float32 FMA per tap in list order.
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

constexpr int kWinThreads = 256;
constexpr int kWinUnroll = 4;
constexpr int kWinSeg = kWinThreads * kWinUnroll;  // float4s per work item

// The four floats that start S floats into the pair (a, b).
template <int S>
__device__ __forceinline__ float4 funnel(float4 a, float4 b) {
  if constexpr (S == 0) return a;
  else if constexpr (S == 1) return make_float4(a.y, a.z, a.w, b.x);
  else if constexpr (S == 2) return make_float4(a.z, a.w, b.x, b.y);
  else return make_float4(a.w, b.x, b.y, b.z);
}

// Body vectors q = q0 + u * kWinThreads (u < kWinUnroll) of one row:
// D4[q] = w * (the four floats at A4 + q, S floats in), for q < n4.  S > 0
// also reads A4[n4] if n4 > 0.  Every thread of the block calls it (the
// shuffle).
template <int S>
__device__ __forceinline__ void copy_row_body(const float4* __restrict__ A4,
                                              float4* __restrict__ D4,
                                              int q0, int n4, float w) {
  const int lane = threadIdx.x & 31;
  const int last = S && n4 > 0 ? n4 : n4 - 1;  // the last float4 read
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 v[kWinUnroll], e[kWinUnroll];
#pragma unroll
  for (int u = 0; u < kWinUnroll; ++u) {
    const int q = q0 + u * kWinThreads;
    v[u] = q <= last ? __ldg(A4 + q) : zero;
    // lane 31's next float4 belongs to the next warp: load it here
    if constexpr (S != 0) {
      e[u] = (lane == 31 && q < n4) ? __ldg(A4 + q + 1) : zero;
    }
  }
#pragma unroll
  for (int u = 0; u < kWinUnroll; ++u) {
    const int q = q0 + u * kWinThreads;
    float4 nx = zero;
    if constexpr (S != 0) {
      nx.x = __shfl_down_sync(0xffffffffu, v[u].x, 1);
      nx.y = __shfl_down_sync(0xffffffffu, v[u].y, 1);
      nx.z = __shfl_down_sync(0xffffffffu, v[u].z, 1);
      nx.w = __shfl_down_sync(0xffffffffu, v[u].w, 1);
      if (lane == 31) nx = e[u];
    }
    if (q < n4) {
      const float4 t = funnel<S>(v[u], nx);
      __stcs(D4 + q, make_float4(w * t.x, w * t.y, w * t.z, w * t.w));
    }
  }
}

// out (H, W) = w * P[r + di, c + dj] over P (., Wp): work item i is
// segment i % nseg of row i / nseg.
__global__ void __launch_bounds__(kWinThreads)
window_copy_kernel(const float* __restrict__ P, float* __restrict__ out,
                   int Wp, int H, int W, int di, int dj, int nseg, float w) {
  const long long items = static_cast<long long>(H) * nseg;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int r = static_cast<int>(item / nseg);
    const int seg = static_cast<int>(item - static_cast<long long>(r) * nseg);
    const float* row = P + static_cast<size_t>(r + di) * Wp;
    const float* src = row + dj;
    float* dst = out + static_cast<size_t>(r) * W;
    // head: floats until dst is 16-byte aligned; s: the source's shift
    // there; A4 = row + a, the 16-byte boundary at or below it, kept
    // inside the row (one more float4 of head if not)
    int h = static_cast<int>(
        (0u - static_cast<unsigned>(reinterpret_cast<uintptr_t>(dst) >> 2)) &
        3u);
    const int s = static_cast<int>(
        (reinterpret_cast<uintptr_t>(src + h) >> 2) & 3u);
    int a = dj + h - s;
    if (a < 0) {
      h += 4;
      a += 4;
    }
    // body float4s: stores inside the output row (h + 4 n4 <= W), loads
    // inside P's row (a + 4 * last + 4 <= Wp)
    const int room = min(W - h, Wp - a - (s ? 4 : 0));
    const int n4 = room > 0 ? room / 4 : 0;
    const float4* A4 = reinterpret_cast<const float4*>(row + a);
    float4* D4 = reinterpret_cast<float4*>(dst + h);
    const int q0 = seg * kWinSeg + static_cast<int>(threadIdx.x);
    switch (s) {
      case 0: copy_row_body<0>(A4, D4, q0, n4, w); break;
      case 1: copy_row_body<1>(A4, D4, q0, n4, w); break;
      case 2: copy_row_body<2>(A4, D4, q0, n4, w); break;
      default: copy_row_body<3>(A4, D4, q0, n4, w); break;
    }
    if (seg == 0) {
      // the scalar head (threads 0..5) and tail (threads 32..37)
      const int t = static_cast<int>(threadIdx.x);
      const int tail0 = h + 4 * n4;
      int c = -1;
      if (t < min(h, W)) c = t;
      else if (t >= 32 && t - 32 < W - tail0) c = tail0 + t - 32;
      if (c >= 0) __stcs(dst + c, w * __ldg(src + c));
    }
  }
}

int launch_window_copy(const float* P, float* out, int Wp, int H, int W,
                       int di, int dj, float w, cudaStream_t s) {
  const int nseg = (W + 4 * kWinSeg - 1) / (4 * kWinSeg);
  long long blocks = static_cast<long long>(H) * nseg;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
  window_copy_kernel<<<static_cast<unsigned>(blocks), kWinThreads, 0, s>>>(
      P, out, Wp, H, W, di, dj, nseg, w);
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
// One tap with one output launches window_copy_kernel, any other tap list
// window_taps_kernel.
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
  if (ntaps == 1 && nout == 1) {
    if ((reinterpret_cast<uintptr_t>(P) | reinterpret_cast<uintptr_t>(o0)) &
        3) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    return launch_window_copy(P, o0, Wp, H, W, di[0], dj[0], w0[0], s);
  }
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
