// K2: the fused per-photon ray chain.
//
// Replaces imsim_tpu/ops/raychain.py::field_to_sensor_pallas (Pallas
// _kernel).  Per photon, in float32:
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
// Bound on the H100: compute.  Each stage carries its operation count
// per photon in an `ops[stage] = n` note (an add, subtract or multiply 1,
// an FMA 2, a sqrt, reciprocal, divide or transcendental 1; min, max,
// abs, negation, compares and selects 0); ops/raychain.chain_flops reads
// the notes and sums them over the surfaces: 2,871 operations per photon
// for the bench telescope in the fused form against 56 B read and
// written, so the FP32 pipes and the special-function unit set the pace,
// not memory.  Edit a stage, recount its note.  Design:
//   * one evaluation per Newton step: a single reciprocal square root of
//     the conic's argument gives both sqrt(arg) and 1/sqrt(arg), and one
//     reciprocal of 1 + sqrt(arg) serves the sag and its slope.  The
//     Newton steps only find the hit (each corrects the last), so they
//     run on fast intrinsics; the surface normal's slope, whose rounding
//     tilts the ray and reaches the focal plane magnified by the ~10 m
//     focal length, is evaluated once at the final point in IEEE float32
//     as the reference does (reusing the last step's approximate slope
//     put photons 0.397 px from the plain twin at 18.7 M photons on an
//     H100, past the 0.35 px bar);
//   * visit constants are folded on the host in float64 and rounded to
//     float32 (ops/raychain.chain_params): (1 + kappa), (1 + kappa) c^2,
//     (1 + kappa) c^2 / 2, (i + 2) a_i, the squared aperture radii;
//   * the Newton trip count is compile-time: kMaxNewton steps unrolled,
//     each behind a warp-uniform per-surface predicate;
//   * kPhotons photons per thread, interleaved stage by stage, so each
//     thread carries independent dependency chains; the surface loop is
//     not unrolled (one body in the instruction cache), and its per-
//     surface constants are warp-uniform constant-bank loads from the
//     launch parameters;
//   * fast intrinsics only where the chain's bar (ops/raychain.gaps_ok)
//     keeps room: rsqrtf for the conic's square root inside the Newton
//     step, __frcp_rn (correctly rounded) for 1 / (1 + sqrt(arg)),
//     __fdividef and rsqrtf for the plane hit t0, the closed-form root's
//     square root and ratios and the Newton update (each is corrected by
//     the next Newton step), __fdividef for the normal slope's small
//     second term, __frsqrt_rn (correctly rounded) for the normal's
//     length.  The normal slope's main term, the refraction's square
//     root, the indices, the DCR and diffraction kicks and the silicon
//     stage keep IEEE sqrtf and division: their rounding reaches the
//     focal plane unpolished.  The library is built without
//     --use_fast_math.
#include "common.cuh"

namespace {

constexpr int kMaxSurf = 16;
constexpr int kNCoef = 4;
constexpr int kSurfW = 26;      // the folded per-surface block, below
constexpr int kNAbs = 29;
constexpr int kMaxNewton = 3;   // NEWTON_POLISH + 2 on an asphere
// launch shape (the alternatives measured are in PERF.md)
constexpr int kPhotons = 2;     // photons per thread, interleaved
constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;   // blocks per SM (caps registers)

// columns of the per-surface block: c, 1 + kappa, (1 + kappa) c^2,
// (1 + kappa) c^2 / 2, a_i (4), (i + 2) a_i (4), ap_lo^2 (-1 when ap_lo
// <= 0), ap_hi^2, vertex (3), rotation (9, row-major)
constexpr int kC = 0, kK1 = 1, kKC2 = 2, kHKC2 = 3, kA = 4, kDA = 8,
              kApLo2 = 12, kApHi2 = 13, kVtx = 14, kRot = 17;
static_assert(kRot + 9 == kSurfW, "surface block layout");

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

// ops[silica] = 16: with the reciprocal 1 / n the kernel keeps beside it
__device__ __forceinline__ float silica_index(float wl) {
  const float w = wl * 1e-3f;
  const float w2 = w * w;
  const float n2 = 1.f + 0.6961663f * w2 / (w2 - 0.00467914825849f) +
                   0.4079426f * w2 / (w2 - 0.01351206307396f) +
                   0.8974794f * w2 / (w2 - 97.934002537921f);
  return sqrtf(n2);
}

// stages 1-2: the DCR and spider-diffraction kicks of the field angles
__device__ __forceinline__ void kicks(const ChainParams& p, float& thx,
                                      float& thy, float pu, float pv,
                                      float wl, float t, float nrm_draw) {
  // 1. DCR: zenith-ward kick R(lambda) - R(lambda_ref)
  //    ops[dcr] = 38: air_index_excess 17, the kick 21
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
  //    ops[diffraction] = 56: the spider frame, 4 vanes, 2 circles, the
  //    atan kick and its rotation back
  if (p.apply_diffr) {
    float c = 1.f, s = 0.f;
    if (p.field_rotation) {
      // ops[field_rotation] = 40: the rotating spider angle
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
    const float kick = phi * nrm_draw;
    const float du = kick * ex, dv = kick * ey;
    const float dur = c * du + s * dv;
    const float dvr = -s * du + c * dv;
    thx = thx + (p.crot * dur + p.srot * dvr);
    thy = thy + (-p.srot * dur + p.crot * dvr);
  }
}

// one surface's constants, read once per surface from the launch
// parameters (warp-uniform)
struct Surf {
  float c, k1, kc2, hkc2, a[kNCoef], da[kNCoef], ap_lo2, ap_hi2;
  float v0, v1, v2, R[9];
};

__device__ __forceinline__ Surf load_surf(const float* S) {
  Surf s;
  s.c = S[kC];
  s.k1 = S[kK1];
  s.kc2 = S[kKC2];
  s.hkc2 = S[kHKC2];
#pragma unroll
  for (int i = 0; i < kNCoef; ++i) {
    s.a[i] = S[kA + i];
    s.da[i] = S[kDA + i];
  }
  s.ap_lo2 = S[kApLo2];
  s.ap_hi2 = S[kApHi2];
  s.v0 = S[kVtx];
  s.v1 = S[kVtx + 1];
  s.v2 = S[kVtx + 2];
#pragma unroll
  for (int i = 0; i < 9; ++i) s.R[i] = S[kRot + i];
  return s;
}

// closed-form conic root anchored at the z = 0 plane hit
// ops[root] = 35
__device__ __forceinline__ float conic_root(float lx, float ly, float lz,
                                            float lvx, float lvy, float lvz,
                                            const Surf& s) {
  const float t0 = __fdividef(-lz, lvz);
  const float x0 = lx + t0 * lvx;
  const float y0 = ly + t0 * lvy;
  const float A = s.c * (lvx * lvx + lvy * lvy + s.k1 * lvz * lvz);
  const float B = 2.f * s.c * (x0 * lvx + y0 * lvy) - 2.f * lvz;
  const float C = s.c * (x0 * x0 + y0 * y0);
  // an approximate square root: the Newton steps polish the root
  const float disc = fmaxf(B * B - 4.f * A * C, 0.f);
  const float sq = disc > 0.f ? disc * rsqrtf(disc) : 0.f;
  const float sgn = B >= 0.f ? 1.f : -1.f;
  const float q = -0.5f * (B + sgn * sq);
  const float eps = 1e-30f;
  const float s_a = __fdividef(q, fabsf(A) < eps ? eps : A);
  const float s_b = __fdividef(C, fabsf(q) < eps ? eps : q);
  return t0 + (fabsf(s_a) < fabsf(s_b) ? s_a : s_b);
}

// one Newton step on F(t) = z(t) - sag(r2(t)): updates t and returns
// the pre-update residual F
// ops[newton] = 32, and ops[asphere] = 21 more on an asphere
__device__ __forceinline__ void newton_step(float lx, float ly, float lz,
                                            float lvx, float lvy, float lvz,
                                            const Surf& s, bool asph,
                                            float& t, float& F) {
  const float x = lx + t * lvx;
  const float y = ly + t * lvy;
  const float z = lz + t * lvz;
  const float r2 = x * x + y * y;
  const float arg = fmaxf(1.f - s.kc2 * r2, 1e-12f);
  const float rq = rsqrtf(arg);            // 1 / sqrt(arg)
  const float iop = __frcp_rn(1.f + arg * rq);  // 1 / (1 + sqrt(arg))
  const float cr2 = s.c * r2;
  // sag = c r2 / (1 + q); slope = c / (1 + q)
  //   + c r2 (c^2 (1 + kappa) / 2) / (q (1 + q)^2)
  float sg = cr2 * iop;
  float sl = s.c * iop + cr2 * s.hkc2 * (iop * iop * rq);
  if (asph) {
    float acc = 0.f, dacc = 0.f;
#pragma unroll
    for (int i = kNCoef - 1; i >= 0; --i) {
      acc = acc * r2 + s.a[i];
      dacc = dacc * r2 + s.da[i];
    }
    sg = sg + r2 * r2 * acc;
    sl = sl + r2 * dacc;
  }
  F = z - sg;
  const float dF = lvz - sl * (2.f * (x * lvx + y * lvy));
  t = t - __fdividef(F, dF);
}

// d(sag)/d(r^2) at the hit in the reference's order (optics/geometry.
// conic_sag_slope + the asphere's derivative): IEEE float32 but for the
// second term's division, a few percent of the slope at most on the
// bench telescope, so its 2-ulp quotient moves the slope by < 0.1 ulp.
// ops[normal] = 22: this slope 11, the unit normal built from it in the
// kernel 11; ops[normal_asphere] = 10 more on an asphere
__device__ __forceinline__ float normal_slope(float r2, const Surf& s,
                                              bool asph) {
  const float q = sqrtf(fmaxf(1.f - s.kc2 * r2, 1e-12f));
  const float op = 1.f + q;
  float sl = s.c / op + __fdividef(s.c * r2 * s.hkc2, q * (op * op));
  if (asph) {
    float dacc = 0.f;
#pragma unroll
    for (int i = kNCoef - 1; i >= 0; --i) dacc = dacc * r2 + s.da[i];
    sl = sl + r2 * dacc;
  }
  return sl;
}

template <int NP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
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
  // photon j of this thread: i0 + j * kThreads (coalesced per j); a
  // thread past the end recomputes photon 0 and stores nothing
  const long long i0 = (long long)blockIdx.x * (kThreads * NP) + threadIdx.x;
  long long idx[NP];
  float wl[NP], flux[NP], n_si[NP], inv_nsi[NP];
  float px[NP], py[NP], pz[NP], vx[NP], vy[NP], vz[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    idx[j] = i0 + (long long)j * kThreads;
    const long long i = idx[j] < n ? idx[j] : 0;
    float thx = thx_in[i], thy = thy_in[i];
    const float pu = pu_in[i], pv = pv_in[i];
    wl[j] = wl_in[i];
    flux[j] = w_in[i];
    kicks(p, thx, thy, pu, pv, wl[j], t_in[i],
          p.apply_diffr ? nrm_in[i] : 0.f);
    // 3. entrance ray at z = 10 m; ops[entrance] = 12
    vz[j] = -1.f / sqrtf(1.f + thx * thx + thy * thy);
    vx[j] = -thx * vz[j];
    vy[j] = -thy * vz[j];
    px[j] = pu - thx * 10.f;
    py[j] = pv - thy * 10.f;
    pz[j] = 10.f;
    n_si[j] = silica_index(wl[j]);
    inv_nsi[j] = 1.f / n_si[j];
  }

  // 4. surface loop
  bool vig[NP];
  float dx_det[NP], dy_det[NP], dvx[NP], dvy[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    vig[j] = false;
    dx_det[j] = dy_det[j] = dvx[j] = dvy[j] = 0.f;
  }
#pragma unroll 1
  for (int k = 0; k < p.n_surf; ++k) {
    const Surf s = load_surf(p.surf + k * kSurfW);
    const int kind = p.kinds[k];
    const int nsteps = p.newton[k];
    const bool asph = nsteps > 1;
    float lx[NP], ly[NP], lz[NP], lvx[NP], lvy[NP], lvz[NP];
    float tt[NP], F[NP], r2[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      // to local: p_l = R^T (p - vtx), v_l = R^T v; ops[to_local] = 33
      const float ddx = px[j] - s.v0, ddy = py[j] - s.v1, ddz = pz[j] - s.v2;
      lx[j] = s.R[0] * ddx + s.R[3] * ddy + s.R[6] * ddz;
      ly[j] = s.R[1] * ddx + s.R[4] * ddy + s.R[7] * ddz;
      lz[j] = s.R[2] * ddx + s.R[5] * ddy + s.R[8] * ddz;
      lvx[j] = s.R[0] * vx[j] + s.R[3] * vy[j] + s.R[6] * vz[j];
      lvy[j] = s.R[1] * vx[j] + s.R[4] * vy[j] + s.R[7] * vz[j];
      lvz[j] = s.R[2] * vx[j] + s.R[5] * vy[j] + s.R[8] * vz[j];
      tt[j] = conic_root(lx[j], ly[j], lz[j], lvx[j], lvy[j], lvz[j], s);
      F[j] = 0.f;
    }
#pragma unroll
    for (int it = 0; it < kMaxNewton; ++it) {
      if (it < nsteps) {
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          newton_step(lx[j], ly[j], lz[j], lvx[j], lvy[j], lvz[j], s, asph,
                      tt[j], F[j]);
        }
      }
    }
    // the hit and the vignetting test; ops[hit] = 9
    float x[NP], y[NP], z[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      x[j] = lx[j] + tt[j] * lvx[j];
      y[j] = ly[j] + tt[j] * lvy[j];
      z[j] = lz[j] + tt[j] * lvz[j];
      r2[j] = x[j] * x[j] + y[j] * y[j];
      vig[j] = vig[j] || (fabsf(F[j]) > 1e-5f) || (r2[j] < s.ap_lo2) ||
               (r2[j] > s.ap_hi2);
    }
    if (kind == DETECTOR) {
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        dx_det[j] = x[j];
        dy_det[j] = y[j];
        dvx[j] = lvx[j];
        dvy[j] = lvy[j];
      }
      break;
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      // surface normal (+z facing)
      const float dzdr2 = normal_slope(r2[j], s, asph);
      const float dzdx = 2.f * x[j] * dzdr2;
      const float dzdy = 2.f * y[j] * dzdr2;
      const float inv = __frsqrt_rn(1.f + dzdx * dzdx + dzdy * dzdy);
      float nx = -dzdx * inv, ny = -dzdy * inv, nz = inv;
      float ux = lvx[j], uy = lvy[j], uz = lvz[j];
      if (kind == MIRROR) {  // ops[mirror] = 12
        const float d = ux * nx + uy * ny + uz * nz;
        ux = ux - 2.f * d * nx;
        uy = uy - 2.f * d * ny;
        uz = uz - 2.f * d * nz;
      } else if (kind == REFRACT_IN || kind == REFRACT_OUT) {
        // ops[refract] = 26
        const float eta = kind == REFRACT_IN ? inv_nsi[j] : n_si[j];
        float d = ux * nx + uy * ny + uz * nz;
        const float sign = d > 0.f ? -1.f : 1.f;
        nx *= sign;
        ny *= sign;
        nz *= sign;
        d *= sign;
        const float c1 = -d;
        const float c2sq = 1.f - eta * eta * (1.f - c1 * c1);
        const float c2 = sqrtf(fmaxf(c2sq, 1e-12f));
        const float kr = eta * c1 - c2;
        ux = eta * ux + kr * nx;
        uy = eta * uy + kr * ny;
        uz = eta * uz + kr * nz;
      }
      // to global; ops[to_global] = 33
      px[j] = s.R[0] * x[j] + s.R[1] * y[j] + s.R[2] * z[j] + s.v0;
      py[j] = s.R[3] * x[j] + s.R[4] * y[j] + s.R[5] * z[j] + s.v1;
      pz[j] = s.R[6] * x[j] + s.R[7] * y[j] + s.R[8] * z[j] + s.v2;
      vx[j] = s.R[0] * ux + s.R[1] * uy + s.R[2] * uz;
      vy[j] = s.R[3] * ux + s.R[4] * uy + s.R[5] * uz;
      vz[j] = s.R[6] * ux + s.R[7] * uy + s.R[8] * uz;
    }
  }

#pragma unroll
  for (int j = 0; j < NP; ++j) {
    if (vig[j]) flux[j] = 0.f;
    // 5. trace frame -> focal DVCS (FOCAL_FRAME = [[0, 1], [-1, 0]]) ->
    //    detector pixels through the detector yaw; ops[pixels] = 14
    const float fxm = dy_det[j];
    const float fym = -dx_det[j];
    const float ux = fxm * 1e3f - p.det_cx_mm;
    const float uy = fym * 1e3f - p.det_cy_mm;
    float xpix = (p.det_crot * ux + p.det_srot * uy) * 100.f + p.det_ox;
    float ypix = (-p.det_srot * ux + p.det_crot * uy) * 100.f + p.det_oy;

    // 6. slopes inside the silicon: Snell in slope form;
    //    ops[slopes] = 17
    const float w = fminf(fmaxf(wl[j], 300.f), 1100.f) * 1e-3f;
    const float w2 = w * w;
    const float n_sil = 3.42f + 0.159f / w2 + 0.0324f / (w2 * w2);
    const float inv_n = 1.f / n_sil;
    const float tx = dvx[j] * inv_n, ty = dvy[j] * inv_n;
    const float tzs = sqrtf(fmaxf(1.f - tx * tx - ty * ty, 1e-6f));
    const float dxdz = tx / tzs, dydz = ty / tzs;
    const long long i = idx[j];
    if (i >= n) continue;

    if (!p.fused) {
      x_out[i] = xpix;
      y_out[i] = ypix;
      dxdz_out[i] = dxdz;
      dydz_out[i] = dydz;
      flux_out[i] = flux[j];
      continue;
    }

    // 7. silicon: absorption length (Chebyshev in log10), conversion
    //    depth, lateral travel, diffusion; ops[silicon] = 110
    const float xc =
        fminf(fmaxf(2.f * (wl[j] - 430.f) / 670.f - 1.f, -1.f), 1.f);
    float b1 = 0.f, b2 = 0.f;
#pragma unroll
    for (int k = kNAbs - 1; k > 0; --k) {
      const float b0 = p.abs_cheb[k] + 2.f * xc * b1 - b2;
      b2 = b1;
      b1 = b0;
    }
    const float labs = powf(10.f, p.abs_cheb[0] + xc * b1 - b2);
    float zc = -labs * logf(u_in[i]);
    float f = flux[j];
    if (!(zc < p.thick_um)) f = 0.f;
    zc = fminf(zc, p.thick_um);
    xpix = xpix + dxdz * zc / p.pix_um;
    ypix = ypix + dydz * zc / p.pix_um;
    const float drift = fmaxf(p.thick_um - zc, 0.f);
    const float sigma = p.diff_um * sqrtf(drift / p.thick_um) / p.pix_um;
    x_out[i] = xpix + sigma * g1_in[i];
    y_out[i] = ypix + sigma * g2_in[i];
    flux_out[i] = f;
  }
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
  if (params->n_surf < 0 || params->n_surf > kMaxSurf) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = 0; k < params->n_surf; ++k) {
    if (params->newton[k] < 1 || params->newton[k] > kMaxNewton) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const long long per_block = (long long)kThreads * kPhotons;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ray_chain_kernel<kPhotons><<<static_cast<unsigned>(blocks), kThreads, 0,
                               s>>>(thx, thy, pu, pv, wl, t, w, nrm, u, g1,
                                    g2, x, y, dxdz, dydz, flux, n, *params);
  return imsim_last_error();
}
