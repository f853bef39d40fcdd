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
// pixel against 12 B of device traffic per pixel once the tile sits in
// shared memory, so float32 FMA issue is the limit.  Design:
//   * one block per 32 x 32 output tile, 32 x 8 threads, each thread 4
//     rows; the (32 + k - 1)^2 halo tile is loaded once into shared
//     memory, with frame edges zero-padded by masking the loads (no
//     padded copy of the frame; any H, W, e.g. 4004 x 4096);
//   * both outputs accumulate from each shared-memory tap read;
//   * the 2 k^2 taps cross by value in the launch parameters, which the
//     card keeps in its constant bank, so every tap read is a
//     warp-uniform constant-bank broadcast (no global symbol, so
//     concurrent launches with other taps cannot race);
//   * k is a template parameter, so the tap loops unroll fully.
// Accumulation order is (i, j) row-major, one FMA per tap, as the
// reference's shifted-slice sum.
#include "common.cuh"

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kRowsPerPass = 8;
constexpr int kMaxK = 11;

struct Taps {
  float kx[kMaxK * kMaxK];
  float ky[kMaxK * kMaxK];
};

template <int K>
__global__ void __launch_bounds__(kTileW * kRowsPerPass)
stencil_pair_kernel(const float* __restrict__ img, float* __restrict__ ox,
                    float* __restrict__ oy, int H, int W,
                    const __grid_constant__ Taps taps) {
  constexpr int R = K / 2;
  constexpr int SW = kTileW + K - 1;
  constexpr int SH = kTileH + K - 1;
  __shared__ float tile[SH * SW];
  const int gx0 = blockIdx.x * kTileW - R;
  const int gy0 = blockIdx.y * kTileH - R;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int i = tid; i < SH * SW; i += kTileW * kRowsPerPass) {
    const int ty = i / SW;
    const int tx = i - ty * SW;
    const int gy = gy0 + ty;
    const int gx = gx0 + tx;
    tile[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                  ? img[(size_t)gy * W + gx]
                  : 0.f;
  }
  __syncthreads();
  const int x = blockIdx.x * kTileW + threadIdx.x;
  for (int r = threadIdx.y; r < kTileH; r += kRowsPerPass) {
    const int y = blockIdx.y * kTileH + r;
    float ax = 0.f, ay = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float v = tile[(r + i) * SW + threadIdx.x + j];
        ax = fmaf(taps.kx[i * K + j], v, ax);
        ay = fmaf(taps.ky[i * K + j], v, ay);
      }
    }
    if (x < W && y < H) {
      ox[(size_t)y * W + x] = ax;
      oy[(size_t)y * W + x] = ay;
    }
  }
}

template <int K>
int launch(const float* img, float* ox, float* oy, int H, int W,
           const Taps& taps, cudaStream_t s) {
  dim3 block(kTileW, kRowsPerPass);
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  stencil_pair_kernel<K><<<grid, block, 0, s>>>(img, ox, oy, H, W, taps);
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
