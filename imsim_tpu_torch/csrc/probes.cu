// P1-P7: the kernels of the on-chip stencil probes.
//
// Replaces benchmarks/probe_pallas.py::p1 (copy_kernel) with
// scale_copy_kernel; probe_pallas.py::p2, p3 (dma_kernel, smem_kernel)
// and probe_pallas2.py::mk's one-tap bodies ka, kb with
// window_copy_kernel; probe_pallas.py::p4, p5 (sten1_kernel,
// sten2_kernel) and probe_pallas2.py::mk and mk2 (bodies kc..kh, ki, kh2,
// kh3) with window_full_kernel, window_row_kernel and
// window_column_kernel.
//
// P1: out = s * x over n floats.  Bound on the H100: memory, 4 B read and
// 4 B written per element (134 MB for the probe's 4096^2 frame, >= 0.04 ms
// at 3.35 TB/s).  Each thread moves one float4 (16-byte loads and stores,
// neighbouring threads on neighbouring addresses); the n % 4 tail is done
// by the first threads with scalar accesses.
//
// P2-P7: out_o[r, c] = sum_t w_o[t] * P[r + di[t], c + dj[t]] for o < nout
// (1 or 2) over the probes' zero-padded frame P (Hp, Wp).  The TPU bodies
// DMA a (TH + k - 1, Wp) halo slab into VMEM and read taps as unaligned
// slices or pltpu.roll shifts; the rolls never wrap inside the output
// window, so every body is this window sum.  ops/probes.py sorts each
// body's taps into one of four shapes, and each has its own kernel:
//   * one tap with one output (P2, P3, P6 a and b): window_copy_kernel,
//     entry imsim_window_copy;
//   * full, the k^2 taps (P4, P5, P6 e-h, P7): window_full_kernel;
//   * row, the k taps (0, j) (P6 c): window_row_kernel;
//   * column, the k taps (i, k / 2) (P6 d): window_column_kernel;
// the last three through imsim_window_taps, which takes the pattern and
// the weights in the pattern's canonical order (full: (i, j) row-major;
// row: j; column: i).  Every output accumulates its taps in that order,
// one float32 FMA per tap, whatever the body's own order (the
// column-major bodies h, h2, h3 included: 81 float32 terms in another
// order differ by about 1e-6 of max |out|, against the 1e-5 bar).
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
// Full pattern (P4, P5, P6 e-h, P7).  Bound: FMA issue, k^2 FMAs per
// output (161 operations per pixel for one output at k = 9, 322 for two)
// against 8-12 B of device traffic.  Design, K3's (csrc/stencil.cu) with
// VALID addressing over P:
//   * one block of 16 x 16 threads per 64 x 64 output tile; the
//     (64 + k - 1)-row halo tile is staged once in shared memory with
//     16-byte loads when P is 16-byte aligned and Wp % 4 == 0 (a float4
//     then lies wholly inside or outside P), else masked scalar loads;
//     loads past P's edge are zero (no valid output reads them);
//   * register blocking: each thread computes a 4 x 4 patch of every
//     output in rolled passes of 16 accumulators (4 rows for one output,
//     2 rows for two); for each input row of a pass it reads the
//     4 + k - 1 values it needs with 128-bit shared loads and feeds each
//     to every tap of the pass it meets (36 LDS.128 for 1,296 FFMA at
//     k = 9, one output);
//   * the weights cross by value in a __grid_constant__ struct and are
//     indexed only at compile-time positions, so each FFMA reads its tap
//     as a constant-bank operand;
//   * k and nout are template parameters: every tap loop unrolls;
//   * 8 blocks per SM (__launch_bounds__ caps registers at 32, no
//     spills; k = 3 with one output takes 6): 2 blocks per SM measured
//     5-6% slower (PERF.md).
// Kept apart from K3's kernel: the addressing (VALID, no negative
// offsets), the outputs per pass and the weights' layout differ, and K3
// stays byte for byte as measured.
//
// Row and column patterns (P6 c, d).  Bound: bytes, k FMAs per output
// (17 operations at k = 9) against 8 B.  No shared memory:
//   * row: each thread makes a float4 of outputs of one row from the
//     4 + k - 1 floats of P's row it needs (three 16-byte loads at k = 9
//     when P is 16-byte aligned and Wp % 4 == 0; the neighbours' overlap
//     comes from L1);
//   * column: each thread walks down a strip of 4k rows of one float4 of
//     columns with a ring of k float4s in registers, so each input float
//     of the strip is read once (the k - 1 rows where the next strip
//     starts are read by both).  The source columns start k / 2 floats
//     right of the outputs: for k / 2 % 4 != 0 each row is two aligned
//     float4s funnelled (the second is the right neighbour's first, an
//     L1 hit);
//   * float4 stores with __stcs where W % 4 == 0 and the outputs are
//     16-byte aligned, else masked scalar stores.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kCopyThreads = 256;
constexpr int kMaxK = 11;

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

// ---- full, row and column patterns -----------------------------------

enum Pattern { kFull = 0, kRow = 1, kColumn = 2 };

// One launch's weights, per output, in the pattern's canonical order.
struct TapWeights {
  float w[2][kMaxK * kMaxK];
};

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// The four outputs a[0..3] at columns x0.. of one output row: a float4
// __stcs when `vec` (W % 4 == 0 and the row 16-byte aligned), else
// masked scalar stores.
__device__ __forceinline__ void store4(float* __restrict__ row, int x0, int W,
                                       bool vec, const float (&a)[4]) {
  if (vec) {
    if (x0 < W) {
      __stcs(reinterpret_cast<float4*>(row + x0),
             make_float4(a[0], a[1], a[2], a[3]));
    }
  } else {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      if (x0 + w < W) __stcs(row + x0 + w, a[w]);
    }
  }
}

// full pattern: the launch shape of K3 (csrc/stencil.cu; PERF.md)
constexpr int kPatchW = 4;                     // outputs per thread, x
constexpr int kPatchH = 4;                     // outputs per thread, y
constexpr int kFullX = 16;                     // threads, x
constexpr int kFullY = 16;                     // threads, y
constexpr int kFullThreads = kFullX * kFullY;
constexpr int kFullTileW = kFullX * kPatchW;   // 64
constexpr int kFullTileH = kFullY * kPatchH;   // 64
// blocks per SM, which caps registers: 8 (32 registers; PERF.md), but
// k = 3 with one output spills at 32 and takes 6 (40)
template <int K, int NOUT>
constexpr int kFullMinBlocks = K == 3 && NOUT == 1 ? 6 : 8;
constexpr int kAccPerPass = 16;                // accumulators per pass

template <int K>
struct FullGeom {
  // the tile starts at the output tile's first column (VALID: no column
  // left of it is read), so tile rows and patches stay 16-byte aligned;
  // it holds the 64 + K - 1 columns its windows reach, in whole float4s
  static constexpr int SW = (kFullTileW + K - 1 + 3) / 4 * 4;
  static constexpr int SW4 = SW / 4;
  static constexpr int SH = kFullTileH + K - 1;
  static constexpr int NV = (kPatchW + K - 1 + 3) / 4;  // float4s per row
  static_assert(4 * (kFullX - 1) + 4 * NV <= SW, "window inside tile");
};

template <int K, int NOUT>
__global__ void __launch_bounds__(kFullThreads, kFullMinBlocks<K, NOUT>)
window_full_kernel(const float* __restrict__ P, float* __restrict__ o0,
                   float* __restrict__ o1, int Hp, int Wp, int H, int W,
                   bool vec_in, bool vec_out,
                   const __grid_constant__ TapWeights taps) {
  using G = FullGeom<K>;
  // patch rows per pass: 16 accumulators (one output: 4 rows, two: 2)
  constexpr int kPassRows = kAccPerPass / (NOUT * kPatchW);
  static_assert(kPatchH % kPassRows == 0, "whole passes");
  __shared__ __align__(16) float tile[G::SH * G::SW];
  const int tid = threadIdx.y * kFullX + threadIdx.x;
  const int gx0 = blockIdx.x * kFullTileW;
  const int gy0 = blockIdx.y * kFullTileH;

  // ---- halo tile: SH rows x SW4 float4 slots, walked tid, tid + 256, ...
  {
    constexpr int kRowStep = kFullThreads / G::SW4;
    constexpr int kColStep = kFullThreads % G::SW4;
    int r = tid / G::SW4;   // once per thread; a constant divisor
    int c4 = tid - r * G::SW4;
    while (r < G::SH) {
      const int gy = gy0 + r;
      const int gx = gx0 + 4 * c4;
      float4 v = zero4();
      if (gy < Hp) {
        const float* row = P + (size_t)gy * Wp;
        if (vec_in) {
          if (gx < Wp) v = __ldg(reinterpret_cast<const float4*>(row + gx));
        } else {
          if (gx < Wp) v.x = __ldg(row + gx);
          if (gx + 1 < Wp) v.y = __ldg(row + gx + 1);
          if (gx + 2 < Wp) v.z = __ldg(row + gx + 2);
          if (gx + 3 < Wp) v.w = __ldg(row + gx + 3);
        }
      }
      reinterpret_cast<float4*>(tile)[r * G::SW4 + c4] = v;
      r += kRowStep;
      c4 += kColStep;
      if (c4 >= G::SW4) {
        c4 -= G::SW4;
        ++r;
      }
    }
  }
  __syncthreads();

  // ---- the patch of every output, kPassRows rows per pass (rolled: an
  // unrolled pass loop keeps rows shared by two passes live and spills)
  const float4* base = reinterpret_cast<const float4*>(
      tile + threadIdx.y * kPatchH * G::SW + 4 * threadIdx.x);
  const int x0 = gx0 + kPatchW * threadIdx.x;
  const int y0 = gy0 + kPatchH * threadIdx.y;
#pragma unroll 1
  for (int pass = 0; pass < kPatchH / kPassRows; ++pass) {
    float acc[NOUT][kPassRows][kPatchW];
#pragma unroll
    for (int o = 0; o < NOUT; ++o) {
#pragma unroll
      for (int m = 0; m < kPassRows; ++m) {
#pragma unroll
        for (int w = 0; w < kPatchW; ++w) acc[o][m][w] = 0.f;
      }
    }
#pragma unroll
    for (int rr = 0; rr < kPassRows + K - 1; ++rr) {
      float v[4 * G::NV];
#pragma unroll
      for (int q = 0; q < G::NV; ++q) {
        const float4 t = base[(pass * kPassRows + rr) * G::SW4 + q];
        v[4 * q] = t.x;
        v[4 * q + 1] = t.y;
        v[4 * q + 2] = t.z;
        v[4 * q + 3] = t.w;
      }
      // output row m meets tap row i = rr - m: rr ascending walks each
      // output's taps in (i, j) row-major order
#pragma unroll
      for (int m = 0; m < kPassRows; ++m) {
        const int i = rr - m;
        if (i < 0 || i >= K) continue;  // resolved at compile time
#pragma unroll
        for (int j = 0; j < K; ++j) {
#pragma unroll
          for (int o = 0; o < NOUT; ++o) {
            const float t = taps.w[o][i * K + j];
#pragma unroll
            for (int w = 0; w < kPatchW; ++w) {
              acc[o][m][w] = fmaf(t, v[w + j], acc[o][m][w]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kPassRows; ++m) {
      const int y = y0 + pass * kPassRows + m;
      if (y >= H) break;
#pragma unroll
      for (int o = 0; o < NOUT; ++o) {
        store4((o == 0 ? o0 : o1) + (size_t)y * W, x0, W, vec_out, acc[o][m]);
      }
    }
  }
}

// row pattern: taps (0, j), j < K; one float4 of outputs per thread
constexpr int kRowThreads = 256;

template <int K, int NOUT>
__global__ void __launch_bounds__(kRowThreads)
window_row_kernel(const float* __restrict__ P, float* __restrict__ o0,
                  float* __restrict__ o1, int Wp, int W, bool vec_in,
                  bool vec_out, const __grid_constant__ TapWeights taps) {
  constexpr int NV = (4 + K - 1 + 3) / 4;  // float4s of P per thread
  const int r = blockIdx.x;
  const int c = 4 * (blockIdx.y * kRowThreads + threadIdx.x);
  if (c >= W) return;
  const float* src = P + (size_t)r * Wp + c;
  float v[4 * NV];
  if (vec_in) {
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const float4 t = c + 4 * q < Wp
                           ? __ldg(reinterpret_cast<const float4*>(src) + q)
                           : zero4();
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4 * NV; ++e) v[e] = c + e < Wp ? __ldg(src + e) : 0.f;
  }
#pragma unroll
  for (int o = 0; o < NOUT; ++o) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float t = taps.w[o][j];
#pragma unroll
      for (int w = 0; w < 4; ++w) a[w] = fmaf(t, v[w + j], a[w]);
    }
    store4((o == 0 ? o0 : o1) + (size_t)r * W, c, W, vec_out, a);
  }
}

// column pattern: taps (i, K / 2), i < K; one float4 of output columns
// per thread, a strip of 4K rows (2K measured 12% slower: PERF.md)
constexpr int kColThreads = 128;
template <int K>
constexpr int kColStrip = 4 * K;

template <int K, int NOUT>
__global__ void __launch_bounds__(kColThreads)
window_column_kernel(const float* __restrict__ P, float* __restrict__ o0,
                     float* __restrict__ o1, int Hp, int Wp, int H, int W,
                     bool vec_in, bool vec_out,
                     const __grid_constant__ TapWeights taps) {
  constexpr int R = K / 2;
  constexpr int S = R % 4;  // the source's shift inside its float4
  const int c = 4 * (blockIdx.x * kColThreads + threadIdx.x);
  const int y0 = blockIdx.y * kColStrip<K>;
  if (c >= W) return;
  // the float4 holding source column c + R (16-byte aligned when vec_in)
  const float* src = P + c + (R - S);
  // row y of the source columns c + R .. c + R + 3, zero past P
  auto load = [&](int y) {
    float4 v = zero4();
    if (y < Hp) {
      const float* p = src + (size_t)y * Wp;
      if (vec_in) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(p));
        if constexpr (S == 0) {
          v = a;
        } else {
          const float4 b =
              c + R - S + 4 < Wp
                  ? __ldg(reinterpret_cast<const float4*>(p) + 1)
                  : zero4();
          v = funnel<S>(a, b);
        }
      } else {
        if (c + R < Wp) v.x = __ldg(p + S);
        if (c + R + 1 < Wp) v.y = __ldg(p + S + 1);
        if (c + R + 2 < Wp) v.z = __ldg(p + S + 2);
        if (c + R + 3 < Wp) v.w = __ldg(p + S + 3);
      }
    }
    return v;
  };
  // ring[(y - y0) % K] holds source row y; rows y0 .. y0 + K - 2 first
  float4 ring[K];
#pragma unroll
  for (int i = 0; i < K - 1; ++i) ring[i] = load(y0 + i);
#pragma unroll 1
  for (int u0 = 0; u0 < kColStrip<K>; u0 += K) {
    if (y0 + u0 >= H) break;
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int y = y0 + u0 + u;  // output row: source rows y .. y + K - 1
      ring[(u + K - 1) % K] = load(y + K - 1);
      if (y < H) {
#pragma unroll
        for (int o = 0; o < NOUT; ++o) {
          float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int i = 0; i < K; ++i) {
            const float t = taps.w[o][i];
            const float4 x = ring[(u + i) % K];
            a[0] = fmaf(t, x.x, a[0]);
            a[1] = fmaf(t, x.y, a[1]);
            a[2] = fmaf(t, x.z, a[2]);
            a[3] = fmaf(t, x.w, a[3]);
          }
          store4((o == 0 ? o0 : o1) + (size_t)y * W, c, W, vec_out, a);
        }
      }
    }
  }
}

template <int K, int NOUT>
int launch_pattern(int pattern, const float* P, float* o0, float* o1,
                   int Hp, int Wp, int H, int W, const TapWeights& taps,
                   cudaStream_t s) {
  const bool vec_in = reinterpret_cast<uintptr_t>(P) % 16 == 0 && Wp % 4 == 0;
  const bool vec_out = W % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(o0) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(o1) % 16 == 0;
  if (pattern == kFull) {
    const dim3 grid((W + kFullTileW - 1) / kFullTileW,
                    (H + kFullTileH - 1) / kFullTileH);
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    window_full_kernel<K, NOUT><<<grid, dim3(kFullX, kFullY), 0, s>>>(
        P, o0, o1, Hp, Wp, H, W, vec_in, vec_out, taps);
  } else if (pattern == kRow) {
    const dim3 grid(H, (W + 4 * kRowThreads - 1) / (4 * kRowThreads));
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    window_row_kernel<K, NOUT><<<grid, kRowThreads, 0, s>>>(
        P, o0, o1, Wp, W, vec_in, vec_out, taps);
  } else {
    const dim3 grid((W + 4 * kColThreads - 1) / (4 * kColThreads),
                    (H + kColStrip<K> - 1) / kColStrip<K>);
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    window_column_kernel<K, NOUT><<<grid, kColThreads, 0, s>>>(
        P, o0, o1, Hp, Wp, H, W, vec_in, vec_out, taps);
  }
  return imsim_last_error();
}

template <int K>
int launch_taps(int pattern, int nout, const float* P, float* o0, float* o1,
                int Hp, int Wp, int H, int W, const TapWeights& taps,
                cudaStream_t s) {
  if (nout == 1) {
    return launch_pattern<K, 1>(pattern, P, o0, o1, Hp, Wp, H, W, taps, s);
  }
  return launch_pattern<K, 2>(pattern, P, o0, o1, Hp, Wp, H, W, taps, s);
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

// P2, P3, P6 a and b: out (H, W) = w * P[r + di, c + dj] over P (Hp, Wp).
IMSIM_API int imsim_window_copy(const float* P, float* out, int Hp, int Wp,
                                int H, int W, int di, int dj, float w,
                                void* stream) {
  if (H <= 0 || W <= 0) return 0;
  if (di < 0 || dj < 0 || H + di > Hp || W + dj > Wp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(P) | reinterpret_cast<uintptr_t>(out)) &
      3) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  return launch_window_copy(P, out, Wp, H, W, di, dj, w,
                            static_cast<cudaStream_t>(stream));
}

// P4-P7: out_o (H, W) = sum_n w_o[n] * P[r + di_n, c + dj_n] over P
// (Hp, Wp), for o < nout, over the pattern's taps n in canonical order:
// full (0) n = k * di + dj, row (1) (0, n), column (2) (n, k / 2); odd
// k in 3..11.  w1 is read only for nout = 2.
IMSIM_API int imsim_window_taps(const float* P, float* o0, float* o1,
                                int Hp, int Wp, int H, int W, int k,
                                int pattern, int nout, const float* w0,
                                const float* w1, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  if (k < 3 || k > kMaxK || k % 2 == 0 || nout < 1 || nout > 2 ||
      pattern < kFull || pattern > kColumn) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int reach_i = pattern == kRow ? 0 : k - 1;
  const int reach_j = pattern == kColumn ? k / 2 : k - 1;
  if (H + reach_i > Hp || W + reach_j > Wp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(P) | reinterpret_cast<uintptr_t>(o0) |
       reinterpret_cast<uintptr_t>(o1)) & 3) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  TapWeights taps = {};
  const int ntaps = pattern == kFull ? k * k : k;
  for (int n = 0; n < ntaps; ++n) {
    taps.w[0][n] = w0[n];
    taps.w[1][n] = nout == 2 ? w1[n] : 0.f;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 3:
      return launch_taps<3>(pattern, nout, P, o0, o1, Hp, Wp, H, W, taps, s);
    case 5:
      return launch_taps<5>(pattern, nout, P, o0, o1, Hp, Wp, H, W, taps, s);
    case 7:
      return launch_taps<7>(pattern, nout, P, o0, o1, Hp, Wp, H, W, taps, s);
    case 9:
      return launch_taps<9>(pattern, nout, P, o0, o1, Hp, Wp, H, W, taps, s);
    default:
      return launch_taps<11>(pattern, nout, P, o0, o1, Hp, Wp, H, W, taps,
                             s);
  }
}
