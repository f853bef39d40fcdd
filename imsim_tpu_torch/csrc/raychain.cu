// K2: the fused per-photon ray chain.
//
// Replaces imsim_tpu/ops/raychain.py::field_to_sensor_pallas (Pallas
// _kernel).  One thread per photon, in float32 with IEEE sqrtf / atanf /
// sinf / tanf (built without --use_fast_math):
//   1. DCR kick (photons/optics_ops.dcr_kick);
//   2. spider-diffraction kick from the pre-drawn normal: nearest spider
//      edge on the exact field-rotation curve
//      (photons/diffraction.apply_diffraction), rotated by -rotTelPos;
//   3. entrance ray (optics/trace.rays_from_field);
//   4. 12-surface trace: closed-form conic root + Newton polish (+2 steps
//      on aspheres), reflection / refraction, vignetting
//      (optics/trace.trace_surfaces, optics/geometry.intersect);
//   5. FOCAL_FRAME + detector yaw -> pixel coordinates;
//   6. silicon-refraction slopes, the XLA formula (v/n)/t_z of
//      photons/optics_ops.silicon_refraction;
//   7. fused form: absorption_length_poly and depth_diffusion_displace
//      (sensor/silicon.py) with the passed-in draws (u, g1, g2).
//
// Bound on the H100: compute.  About 2,500 flops and 25 transcendentals
// per photon against 44 B read and 12 B written (fused form), so the
// FP32 pipes and the special-function unit set the pace, not memory.
// Design: the whole chain lives in registers; the surface matrix, the
// visit scalars and the silicon constants cross by value in the launch
// parameters (constant bank, warp-uniform reads); the surface loop is
// fully unrolled so every parameter index is a compile-time constant.
#include "common.cuh"

namespace {

constexpr int kMaxSurf = 16;
constexpr int kSurfW = 20;  // c, kappa, coefs(4), ap_lo, ap_hi, vtx(3), rot(9)
constexpr int kNCoef = 4;
constexpr int kNAbs = 29;
constexpr int kThreads = 256;

constexpr int MIRROR = 0, REFRACT_IN = 1, REFRACT_OUT = 2, DETECTOR = 3;

struct ChainParams {
  float surf[kMaxSurf * kSurfW];
  int kinds[kMaxSurf];
  int newton[kMaxSurf];
  int n_surf;
  int apply_dcr, apply_diffr, field_rotation, fused;
  float bore_alt, j01, j11, k1_ref, k2_ref;
  float air_p_mbar, air_f1, air_f2, air_f3, air_w_mbar;
  float crot, srot;
  float cl, sl, fx, fy, fz, h0x, h0y, h0z, n_h0;
  float det_cx_mm, det_cy_mm, det_crot, det_srot, det_ox, det_oy;
  float thick_um, pix_um, diff_um;
  float abs_cheb[kNAbs];
};

constexpr float kPi = 3.14159265358979323846f;
constexpr float kOmegaEarth = 7.292115826090781e-05f;

// n_air - 1 (optics/geometry.air_index_excess) with the weather
// factors folded on the host.
__device__ __forceinline__ float air_index_excess(float wl,
                                                  const ChainParams& p) {
  const float q = 1000.f / wl;
  const float sigma2 = q * q;
  float n = 64.328f + 29498.1f / (146.f - sigma2) + 255.4f / (41.f - sigma2);
  n = n * p.air_p_mbar * p.air_f1 / p.air_f2;
  n = n - ((0.0624f - 0.000680f * sigma2) / p.air_f3) * p.air_w_mbar;
  return 1e-6f * n;
}

__device__ __forceinline__ float silica_index(float wl) {
  const float w = wl * 1e-3f;
  const float w2 = w * w;
  const float n2 = 1.f + 0.6961663f * w2 / (w2 - 0.00467914825849f) +
                   0.4079426f * w2 / (w2 - 0.01351206307396f) +
                   0.8974794f * w2 / (w2 - 97.934002537921f);
  return sqrtf(n2);
}

struct Conic {
  float c, kappa, a[kNCoef];
  bool asph;
};

__device__ __forceinline__ float conic_sag(float r2, const Conic& s) {
  const float arg = 1.f - (1.f + s.kappa) * s.c * s.c * r2;
  return s.c * r2 / (1.f + sqrtf(fmaxf(arg, 1e-12f)));
}

__device__ __forceinline__ float conic_sag_slope(float r2, const Conic& s) {
  const float arg = fmaxf(1.f - (1.f + s.kappa) * s.c * s.c * r2, 1e-12f);
  const float q = sqrtf(arg);
  const float op = 1.f + q;
  return s.c / op +
         s.c * r2 * (s.c * s.c * (1.f + s.kappa) * 0.5f) / (q * (op * op));
}

// F(t) = z(t) - sag(r2(t)) and dF/dt along the ray
__device__ __forceinline__ void conic_F(float px, float py, float pz,
                                        float vx, float vy, float vz,
                                        const Conic& s, float t, float* F,
                                        float* dF) {
  const float x = px + t * vx;
  const float y = py + t * vy;
  const float z = pz + t * vz;
  const float r2 = x * x + y * y;
  float sg = conic_sag(r2, s);
  float ds = conic_sag_slope(r2, s);
  if (s.asph) {
    float acc = 0.f, dacc = 0.f;
#pragma unroll
    for (int i = kNCoef - 1; i >= 0; --i) {
      acc = acc * r2 + s.a[i];
      dacc = dacc * r2 + s.a[i] * (float)(i + 2);
    }
    sg = sg + r2 * r2 * acc;
    ds = ds + r2 * dacc;
  }
  const float dr2dt = 2.f * (x * vx + y * vy);
  *F = z - sg;
  *dF = vz - ds * dr2dt;
}

__global__ void __launch_bounds__(kThreads)
ray_chain_kernel(const float* __restrict__ thx_in,
                 const float* __restrict__ thy_in,
                 const float* __restrict__ pu_in,
                 const float* __restrict__ pv_in,
                 const float* __restrict__ wl_in,
                 const float* __restrict__ t_in,
                 const float* __restrict__ w_in,
                 const float* __restrict__ nrm_in,
                 const float* __restrict__ u_in,
                 const float* __restrict__ g1_in,
                 const float* __restrict__ g2_in, float* __restrict__ x_out,
                 float* __restrict__ y_out, float* __restrict__ dxdz_out,
                 float* __restrict__ dydz_out, float* __restrict__ flux_out,
                 long long n, const __grid_constant__ ChainParams p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float thx = thx_in[i], thy = thy_in[i];
  const float pu = pu_in[i], pv = pv_in[i];
  const float wl = wl_in[i], t = t_in[i];
  float flux = w_in[i];

  // 1. DCR: zenith-ward kick R(lambda) - R(lambda_ref)
  if (p.apply_dcr) {
    const float v = p.j01 * thx + p.j11 * thy;
    const float alt = p.bore_alt + v;
    const float xi = air_index_excess(wl, p);
    const float k1 = xi * (1.f - 0.001254f);
    const float k2 = -xi * (0.001254f + xi * 0.5f);
    const float tz = tanf(fminf(fmaxf(0.5f * kPi - alt, 0.f), 1.5f));
    const float dalt = (k1 - p.k1_ref) * tz + (k2 - p.k2_ref) * (tz * tz * tz);
    thx = thx + p.j01 * dalt;
    thy = thy + p.j11 * dalt;
  }

  // 2. spider diffraction in the rotating spider frame
  if (p.apply_diffr) {
    float c = 1.f, s = 0.f;
    if (p.field_rotation) {
      const float wt = kOmegaEarth * t;
      const float zx = cosf(wt) * p.cl;
      const float zy = sinf(wt) * p.cl;
      const float htx = p.fy * p.sl - p.fz * zy;
      const float hty = p.fz * zx - p.fx * p.sl;
      const float htz = p.fx * zy - p.fy * zx;
      const float nrm = sqrtf(htx * htx + hty * hty + htz * htz) * p.n_h0;
      const float cos_t = (htx * p.h0x + hty * p.h0y + htz * p.h0z) / nrm;
      const float sin_t = (zx * p.h0x + zy * p.h0y + p.sl * p.h0z) / nrm;
      const float r = 1.f / sqrtf(sin_t * sin_t + cos_t * cos_t);
      s = sin_t * r;
      c = cos_t * r;
    }
    const float ru = c * pu - s * pv;
    const float rv = s * pu + c * pv;
    // nearest edge: 4 vanes [nx, ny, d, half-thickness], then the two
    // aperture circles (first match wins on ties)
    const float S2 = 0.70710678118654752f;
    const float ln[4][4] = {{S2, S2, -0.4f, 0.025f},
                            {-S2, S2, -0.4f, 0.025f},
                            {S2, S2, 0.4f, 0.025f},
                            {-S2, S2, 0.4f, 0.025f}};
    float dist = 0.f, ex = 0.f, ey = 0.f;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const float dl =
          fabsf(fabsf(ln[l][0] * ru + ln[l][1] * rv - ln[l][2]) - ln[l][3]);
      if (l == 0 || dl < dist) {
        ex = ln[l][0];
        ey = ln[l][1];
      }
      dist = l == 0 ? dl : fminf(dl, dist);
    }
    const float circ_r[2] = {2.558f, 4.18f};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float dxc = 0.f - ru;
      const float dyc = 0.f - rv;
      const float rr = fmaxf(hypotf(dxc, dyc), 1e-12f);
      const float dc = fabsf(rr - circ_r[k]);
      if (dc < dist) {
        ex = dxc / rr;
        ey = dyc / rr;
      }
      dist = fminf(dc, dist);
    }
    const float kw = 2.f * kPi / (wl * 1e-9f);
    const float phi = atanf(1.f / (2.f * kw * fmaxf(dist, 1e-9f)));
    const float kick = phi * nrm_in[i];
    const float du = kick * ex, dv = kick * ey;
    const float dur = c * du + s * dv;
    const float dvr = -s * du + c * dv;
    thx = thx + (p.crot * dur + p.srot * dvr);
    thy = thy + (-p.srot * dur + p.crot * dvr);
  }

  // 3. entrance ray at z = 10 m
  float vz = -1.f / sqrtf(1.f + thx * thx + thy * thy);
  float vx = -thx * vz, vy = -thy * vz;
  float px = pu - thx * 10.f, py = pv - thy * 10.f, pz = 10.f;

  // 4. surface loop
  const float n_si = silica_index(wl);
  bool vig = false;
  float dx_det = 0.f, dy_det = 0.f, dvx = 0.f, dvy = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxSurf; ++k) {
    if (k >= p.n_surf) break;
    const float* S = p.surf + k * kSurfW;
    Conic cs;
    cs.c = S[0];
    cs.kappa = S[1];
    cs.asph = p.newton[k] > 1;
#pragma unroll
    for (int j = 0; j < kNCoef; ++j) cs.a[j] = S[2 + j];
    const float ap_lo = S[6], ap_hi = S[7];
    const float v0 = S[8], v1 = S[9], v2 = S[10];
    const float R0 = S[11], R1 = S[12], R2 = S[13], R3 = S[14], R4 = S[15],
                R5 = S[16], R6 = S[17], R7 = S[18], R8 = S[19];
    // to local: p_l = R^T (p - vtx), v_l = R^T v
    const float ddx = px - v0, ddy = py - v1, ddz = pz - v2;
    const float lx = R0 * ddx + R3 * ddy + R6 * ddz;
    const float ly = R1 * ddx + R4 * ddy + R7 * ddz;
    const float lz = R2 * ddx + R5 * ddy + R8 * ddz;
    float lvx = R0 * vx + R3 * vy + R6 * vz;
    float lvy = R1 * vx + R4 * vy + R7 * vz;
    float lvz = R2 * vx + R5 * vy + R8 * vz;

    // closed-form conic root anchored at the z = 0 plane hit
    const float kk = 1.f + cs.kappa;
    const float t0 = -lz / lvz;
    const float x0 = lx + t0 * lvx;
    const float y0 = ly + t0 * lvy;
    const float A = cs.c * (lvx * lvx + lvy * lvy + kk * lvz * lvz);
    const float B = 2.f * cs.c * (x0 * lvx + y0 * lvy) - 2.f * lvz;
    const float C = cs.c * (x0 * x0 + y0 * y0);
    const float disc = fmaxf(B * B - 4.f * A * C, 0.f);
    const float sq = sqrtf(disc);
    const float sgn = B >= 0.f ? 1.f : -1.f;
    const float q = -0.5f * (B + sgn * sq);
    const float eps = 1e-30f;
    const float s_a = q / (fabsf(A) < eps ? eps : A);
    const float s_b = C / (fabsf(q) < eps ? eps : q);
    float tt = t0 + (fabsf(s_a) < fabsf(s_b) ? s_a : s_b);
    float F = 0.f, dF = 1.f;
    for (int it = 0; it < p.newton[k]; ++it) {
      conic_F(lx, ly, lz, lvx, lvy, lvz, cs, tt, &F, &dF);
      tt = tt - F / dF;
    }
    const float x = lx + tt * lvx;
    const float y = ly + tt * lvy;
    const float z = lz + tt * lvz;
    vig = vig || (fabsf(F) > 1e-5f);
    const float r = sqrtf(x * x + y * y);
    vig = vig || (r < ap_lo) || (r > ap_hi);
    const int kind = p.kinds[k];
    if (kind == DETECTOR) {
      dx_det = x;
      dy_det = y;
      dvx = lvx;
      dvy = lvy;
      break;
    }
    // surface normal (+z facing)
    float dzdr2 = conic_sag_slope(x * x + y * y, cs);
    {
      const float r2 = x * x + y * y;
      float dacc = 0.f;
#pragma unroll
      for (int j = kNCoef - 1; j >= 0; --j) {
        dacc = dacc * r2 + cs.a[j] * (float)(j + 2);
      }
      dzdr2 = dzdr2 + r2 * dacc;
    }
    const float dzdx = 2.f * x * dzdr2;
    const float dzdy = 2.f * y * dzdr2;
    const float inv = 1.f / sqrtf(1.f + dzdx * dzdx + dzdy * dzdy);
    float nx = -dzdx * inv, ny = -dzdy * inv, nz = inv;
    if (kind == MIRROR) {
      const float d = lvx * nx + lvy * ny + lvz * nz;
      lvx = lvx - 2.f * d * nx;
      lvy = lvy - 2.f * d * ny;
      lvz = lvz - 2.f * d * nz;
    } else if (kind == REFRACT_IN || kind == REFRACT_OUT) {
      const float eta = kind == REFRACT_IN ? 1.f / n_si : n_si;
      float d = lvx * nx + lvy * ny + lvz * nz;
      const float sign = d > 0.f ? -1.f : 1.f;
      nx *= sign;
      ny *= sign;
      nz *= sign;
      d *= sign;
      const float c1 = -d;
      const float c2sq = 1.f - eta * eta * (1.f - c1 * c1);
      const float c2 = sqrtf(fmaxf(c2sq, 1e-12f));
      const float kr = eta * c1 - c2;
      lvx = eta * lvx + kr * nx;
      lvy = eta * lvy + kr * ny;
      lvz = eta * lvz + kr * nz;
    }
    // to global
    px = R0 * x + R1 * y + R2 * z + v0;
    py = R3 * x + R4 * y + R5 * z + v1;
    pz = R6 * x + R7 * y + R8 * z + v2;
    vx = R0 * lvx + R1 * lvy + R2 * lvz;
    vy = R3 * lvx + R4 * lvy + R5 * lvz;
    vz = R6 * lvx + R7 * lvy + R8 * lvz;
  }
  if (vig) flux = 0.f;

  // 5. trace frame -> focal DVCS (FOCAL_FRAME = [[0, 1], [-1, 0]]) ->
  //    detector pixels through the detector yaw
  const float fxm = dy_det;
  const float fym = -dx_det;
  const float ux = fxm * 1e3f - p.det_cx_mm;
  const float uy = fym * 1e3f - p.det_cy_mm;
  float xpix = (p.det_crot * ux + p.det_srot * uy) * 100.f + p.det_ox;
  float ypix = (-p.det_srot * ux + p.det_crot * uy) * 100.f + p.det_oy;

  // 6. slopes inside the silicon: Snell in slope form
  const float w = fminf(fmaxf(wl, 300.f), 1100.f) * 1e-3f;
  const float w2 = w * w;
  const float n_sil = 3.42f + 0.159f / w2 + 0.0324f / (w2 * w2);
  const float inv_n = 1.f / n_sil;
  const float tx = dvx * inv_n, ty = dvy * inv_n;
  const float tzs = sqrtf(fmaxf(1.f - tx * tx - ty * ty, 1e-6f));
  const float dxdz = tx / tzs, dydz = ty / tzs;

  if (!p.fused) {
    x_out[i] = xpix;
    y_out[i] = ypix;
    dxdz_out[i] = dxdz;
    dydz_out[i] = dydz;
    flux_out[i] = flux;
    return;
  }

  // 7. silicon: absorption length (Chebyshev in log10), conversion
  //    depth, lateral travel, diffusion
  const float xc = fminf(fmaxf(2.f * (wl - 430.f) / 670.f - 1.f, -1.f), 1.f);
  float b1 = 0.f, b2 = 0.f;
#pragma unroll
  for (int k = kNAbs - 1; k > 0; --k) {
    const float b0 = p.abs_cheb[k] + 2.f * xc * b1 - b2;
    b2 = b1;
    b1 = b0;
  }
  const float labs = powf(10.f, p.abs_cheb[0] + xc * b1 - b2);
  float zc = -labs * logf(u_in[i]);
  if (!(zc < p.thick_um)) flux = 0.f;
  zc = fminf(zc, p.thick_um);
  xpix = xpix + dxdz * zc / p.pix_um;
  ypix = ypix + dydz * zc / p.pix_um;
  const float drift = fmaxf(p.thick_um - zc, 0.f);
  const float sigma = p.diff_um * sqrtf(drift / p.thick_um) / p.pix_um;
  x_out[i] = xpix + sigma * g1_in[i];
  y_out[i] = ypix + sigma * g2_in[i];
  flux_out[i] = flux;
}

}  // namespace

IMSIM_API int imsim_chain_params_size() {
  return static_cast<int>(sizeof(ChainParams));
}

IMSIM_API int imsim_field_to_sensor(
    const float* thx, const float* thy, const float* pu, const float* pv,
    const float* wl, const float* t, const float* w, const float* nrm,
    const float* u, const float* g1, const float* g2, float* x, float* y,
    float* dxdz, float* dydz, float* flux, long long n,
    const ChainParams* params, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ray_chain_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      thx, thy, pu, pv, wl, t, w, nrm, u, g1, g2, x, y, dxdz, dydz, flux, n,
      *params);
  return imsim_last_error();
}
