// K3: SAME-padded correlation of a charge image with two k x k tap sets
// that share every input tap (the brighter-fatter displacement field).
//
// Replaces imsim_tpu/ops/stencil.py::stencil_pair (Pallas
// _stencil2_kernel: row-tiled VMEM halo slab, lane rolls).
//
//   ox[y, x] = sum_{i,j} kx[i, j] * img[y + i - R, x + j - R]
//   oy[y, x] = sum_{i,j} ky[i, j] * img[y + i - R, x + j - R]
// with zeros outside the frame, R = k / 2.
//
// Bound on the H100: compute.  2 k^2 FMAs (162 for k = 9, 324 flops) per
// pixel against 12 B of device traffic per pixel, so float32 FMA issue
// is the limit, and every instruction that is not an FMA costs issue
// slots.  Design:
//   * one block of 16 x 16 threads per 64 x 64 output tile; the
//     (64 + k - 1)-row halo tile is loaded once into shared memory with
//     16-byte global loads and stores when W % 4 == 0 and the image is
//     16-byte aligned (a float4 then lies wholly inside or outside the
//     frame), else with masked scalar loads; frame edges are zero by
//     masking (no padded copy of the frame, any H and W); the slots are
//     walked with a running (row, column) pair, no division per slot;
//   * register blocking: each thread computes a 4 x 4 patch of both
//     outputs in two passes of 2 x 4 (16 accumulators).  For each of the
//     2 + k - 1 input rows of a pass it reads the 4 + k - 1 values the
//     pass needs with 128-bit shared loads (3 for k <= 9, 5 for k = 11)
//     and feeds each to every tap of the pass it meets: 60 shared loads
//     for 2,592 FMAs at k = 9, against one 4-byte load per 2 FMAs with
//     one output per thread.  The pass loop stays rolled: fully unrolled
//     straight-line code let the compiler hoist loads and taps until it
//     hit the 128-register cap and spilled (PERF.md);
//   * the 2 k^2 taps cross by value in the launch parameters, which the
//     card keeps in its constant bank, so each FMA reads its tap as a
//     constant-bank operand (no global symbol, so concurrent launches
//     with other taps cannot race);
//   * k is a template parameter, so every loop unrolls fully.
// Each output accumulates in (i, j) row-major order, one FMA per tap, as
// the reference's shifted-slice sum.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxK = 11;
// patch and launch shape (the alternatives measured are in PERF.md)
constexpr int kPatchW = 4;                       // outputs per thread, x
constexpr int kPatchH = 4;                       // outputs per thread, y
constexpr int kPassRows = 2;                     // patch rows per pass
constexpr int kMinBlocks = 2;                    // blocks per SM (caps
                                                 //   registers)
constexpr int kThreadsX = 16;
constexpr int kThreadsY = 16;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kTileW = kThreadsX * kPatchW;      // 64
constexpr int kTileH = kThreadsY * kPatchH;
static_assert(kPatchH % kPassRows == 0, "whole passes");

struct Taps {
  float kx[kMaxK * kMaxK];
  float ky[kMaxK * kMaxK];
};

template <int K>
struct Geom {
  static constexpr int R = K / 2;
  // the tile's first column sits PADL columns left of the output tile,
  // PADL a multiple of 4, so tile rows and patches stay 16-byte aligned
  static constexpr int PADL = (R + 3) / 4 * 4;
  static constexpr int SW = (PADL + kTileW + R + 3) / 4 * 4;
  static constexpr int SW4 = SW / 4;
  static constexpr int SH = kTileH + K - 1;
  // a patch's window starts S columns into its first float4
  static constexpr int S = PADL - R;
  static constexpr int NV = (S + kPatchW + K - 1 + 3) / 4;
  static_assert(S >= 0 && S < 4, "window offset");
  static_assert(4 * (kThreadsX - 1) + 4 * NV <= SW, "window inside tile");
};

template <int K, bool VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
stencil_pair_kernel(const float* __restrict__ img, float* __restrict__ ox,
                    float* __restrict__ oy, int H, int W,
                    const __grid_constant__ Taps taps) {
  using G = Geom<K>;
  __shared__ __align__(16) float tile[G::SH * G::SW];
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int gx0 = blockIdx.x * kTileW - G::PADL;
  const int gy0 = blockIdx.y * kTileH - G::R;

  // ---- halo tile: SH rows x SW4 float4 slots, walked tid, tid + 256, ...
  {
    constexpr int kRowStep = kThreads / G::SW4;
    constexpr int kColStep = kThreads % G::SW4;
    int r = tid / G::SW4;   // once per thread; a constant divisor
    int c4 = tid - r * G::SW4;
    for (; r < G::SH;) {
      const int gy = gy0 + r;
      const int gx = gx0 + 4 * c4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gy >= 0 && gy < H) {
        const float* row = img + (size_t)gy * W;
        if (VEC) {
          if (gx >= 0 && gx < W) {
            v = __ldg(reinterpret_cast<const float4*>(row + gx));
          }
        } else {
          if (gx >= 0 && gx < W) v.x = __ldg(row + gx);
          if (gx + 1 >= 0 && gx + 1 < W) v.y = __ldg(row + gx + 1);
          if (gx + 2 >= 0 && gx + 2 < W) v.z = __ldg(row + gx + 2);
          if (gx + 3 >= 0 && gx + 3 < W) v.w = __ldg(row + gx + 3);
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

  // ---- the patch of both outputs, kPassRows rows per pass (the pass
  // loop stays rolled: unrolled, the compiler keeps rows shared by two
  // passes live across both and spills)
  const float4* base = reinterpret_cast<const float4*>(
      tile + threadIdx.y * kPatchH * G::SW + 4 * threadIdx.x);
  const int x0 = blockIdx.x * kTileW + kPatchW * threadIdx.x;
  const int y0 = blockIdx.y * kTileH + kPatchH * threadIdx.y;
#pragma unroll 1
  for (int pass = 0; pass < kPatchH / kPassRows; ++pass) {
    float ax[kPassRows][kPatchW], ay[kPassRows][kPatchW];
#pragma unroll
    for (int m = 0; m < kPassRows; ++m) {
#pragma unroll
      for (int w = 0; w < kPatchW; ++w) {
        ax[m][w] = 0.f;
        ay[m][w] = 0.f;
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
#pragma unroll
      for (int m = 0; m < kPassRows; ++m) {
        const int i = rr - m;
        if (i < 0 || i >= K) continue;  // resolved at compile time
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float tx = taps.kx[i * K + j];
          const float ty = taps.ky[i * K + j];
#pragma unroll
          for (int w = 0; w < kPatchW; ++w) {
            ax[m][w] = fmaf(tx, v[G::S + w + j], ax[m][w]);
            ay[m][w] = fmaf(ty, v[G::S + w + j], ay[m][w]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kPassRows; ++m) {
      const int y = y0 + pass * kPassRows + m;
      if (y >= H) break;
      const size_t o = (size_t)y * W + x0;
      if (VEC) {
        // W % 4 == 0: the patch row lies wholly inside or outside
        if (x0 < W) {
          reinterpret_cast<float4*>(ox + o)[0] =
              make_float4(ax[m][0], ax[m][1], ax[m][2], ax[m][3]);
          reinterpret_cast<float4*>(oy + o)[0] =
              make_float4(ay[m][0], ay[m][1], ay[m][2], ay[m][3]);
        }
      } else {
#pragma unroll
        for (int w = 0; w < kPatchW; ++w) {
          if (x0 + w < W) {
            ox[o + w] = ax[m][w];
            oy[o + w] = ay[m][w];
          }
        }
      }
    }
  }
}

template <int K>
int launch(const float* img, float* ox, float* oy, int H, int W,
           const Taps& taps, cudaStream_t s) {
  dim3 block(kThreadsX, kThreadsY);
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  const bool vec = W % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ox) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(oy) % 16 == 0;
  if (vec) {
    stencil_pair_kernel<K, true><<<grid, block, 0, s>>>(img, ox, oy, H, W,
                                                         taps);
  } else {
    stencil_pair_kernel<K, false><<<grid, block, 0, s>>>(img, ox, oy, H, W,
                                                          taps);
  }
  return imsim_last_error();
}

}  // namespace

IMSIM_API int imsim_stencil_pair(const float* img, float* ox, float* oy,
                                 int H, int W, int k, const float* kx,
                                 const float* ky, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  Taps taps = {};
  if (k < 1 || k > kMaxK || k % 2 == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((H + kTileH - 1) / kTileH > 65535) {  // the grid's y limit
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < k * k; ++i) {
    taps.kx[i] = kx[i];
    taps.ky[i] = ky[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 3: return launch<3>(img, ox, oy, H, W, taps, s);
    case 5: return launch<5>(img, ox, oy, H, W, taps, s);
    case 7: return launch<7>(img, ox, oy, H, W, taps, s);
    case 9: return launch<9>(img, ox, oy, H, W, taps, s);
    case 11: return launch<11>(img, ox, oy, H, W, taps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
