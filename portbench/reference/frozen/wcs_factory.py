"""Per-detector WCS construction: ICRF -> observed -> field -> focal ->
pixel, fit as TAN-SIP (imsim_tpu/optics/wcs_factory.py counterpart).

Everything here is host-side float64 and runs once per CCD.  The field
-> focal map traces chief rays through the port's own trace on float64
CPU tensors with the float64 surface matrix (`TelescopeDesign.host`),
the trace whose float32 form the photon chain runs, so sky truth, photon
landing and the written WCS agree by construction.
"""
from __future__ import annotations

import numpy as np
import torch

from .camera import CCD, PIXEL_SIZE_MM, focal_mm_to_pixel
from .coords import gnomonic_deproject, gnomonic_project
from .astrometry import Observation
from .loader import LoadedTelescope, load_telescope
from .telescope import TelescopeDesign
from .trace import rays_from_field, trace
from .wcs import TanSipWCS, fit_tan_sip

# the trace frame -> DVCS focal frame (photons/optics_ops.FOCAL_FRAME)
FOCAL_FRAME = ((0.0, 1.0), (-1.0, 0.0))

# effective wavelength [nm] of each band (the WCS's refraction and the
# trace's dispersion)
BAND_WL = dict(u=370.0, g=480.0, r=622.0, i=755.0, z=870.0, y=975.0)


def host_trace(tel: TelescopeDesign, thx, thy, wavelength_nm: float):
    """Chief rays (pupil centre) of float64 field angles [rad] to the
    detector: (x, y) [m] in the trace frame, float64 numpy."""
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa: E731
    thx, thy = f64(thx), f64(thy)
    zero = torch.zeros_like(thx)
    out = trace(tel.host, *rays_from_field(thx, thy, zero, zero),
                torch.full_like(thx, wavelength_nm))
    return out["x"].numpy(), out["y"].numpy()


class WCSFactory:
    def __init__(self, obs: Observation, telescope: LoadedTelescope,
                 wavelength_nm: float = 622.0, order: int = 3):
        self.obs = obs
        self.telescope = telescope
        self.wavelength = wavelength_nm
        self.order = order
        # Sky tangent -> camera field is one involutory reflection,
        #     (thx, thy) = Ref(rotTelPos - q) @ (e_east, n_north),
        # with (e, n) the gnomonic tangent basis at the observed
        # boresight in observed ra/dec and q the observed parallactic
        # angle (the JAX package's frame, solved there from the
        # reference's written WCS solutions).
        q = obs.parallactic_angle_observed()
        self._q = float(q)
        ax = telescope.rotTelPos - self._q
        self._cax = float(np.cos(ax))
        self._sax = float(np.sin(ax))
        self._bore_rob, self._bore_dob = obs.azalt_to_observed_radec(
            np.atleast_1d(obs.bore_az), np.atleast_1d(obs.bore_alt))
        self._bore_rob = float(self._bore_rob[0])
        self._bore_dob = float(self._bore_dob[0])
        # linear field->focal scale for inversion seeds
        self._efl = self._measure_efl()

    def altaz_to_field_jacobian(self):
        """2x2 orthogonal Jacobian of the boresight-tangent alt-az ->
        camera field map, measured numerically from this factory's own
        observed->field chain.  Columns: image of the horizontal
        (+azimuth) and zenith-ward (+altitude) unit tangents,
        field = J @ (d_horiz, d_alt)."""
        eps = 1e-7
        az0, alt0 = self.obs.bore_az, self.obs.bore_alt

        def field_of(az, alt):
            ra, dec = self.obs.observed_to_icrf(np.atleast_1d(az),
                                                np.atleast_1d(alt))
            thx, thy = self.icrf_to_field(ra, dec)
            return np.array([float(thx[0]), float(thy[0])])

        f0 = field_of(az0, alt0)
        je = (field_of(az0 + eps / np.cos(alt0), alt0) - f0) / eps
        jn = (field_of(az0, alt0 + eps) - f0) / eps
        J = np.stack([je, jn], axis=1)
        if not np.allclose(J @ J.T, np.eye(2), atol=1e-4):
            raise ValueError(f"alt-az -> field Jacobian not orthogonal: {J}")
        # exact orthogonalization of the finite-difference estimate
        u, _, vt = np.linalg.svd(J)
        return u @ vt

    # --- field <-> focal (raytrace) --------------------------------------
    def field_to_focal_m(self, thx, thy, tel=None):
        """Chief-ray focal-plane position [m] in DVCS for field angles
        [rad] in the camera frame (rotator already applied)."""
        thx = np.atleast_1d(np.asarray(thx, float))
        thy = np.atleast_1d(np.asarray(thy, float))
        x, y = host_trace(tel if tel is not None else self.telescope.fiducial,
                          thx, thy, self.wavelength)
        (f00, f01), (f10, f11) = FOCAL_FRAME
        return f00 * x + f01 * y, f10 * x + f11 * y

    def _measure_efl(self):
        x1, y1 = self.field_to_focal_m(0.002, 0.0)
        x2, y2 = self.field_to_focal_m(0.0021, 0.0)
        return float(np.hypot(x2[0] - x1[0], y2[0] - y1[0]) / 0.0001)

    def focal_m_to_field(self, fx, fy, tel=None, niter=4):
        """Invert field->focal by Newton with a numeric Jacobian."""
        fx = np.atleast_1d(np.asarray(fx, float))
        fy = np.atleast_1d(np.asarray(fy, float))
        thx = fx / self._efl
        thy = fy / self._efl
        h = 1e-6
        for _ in range(niter):
            X, Y = self.field_to_focal_m(thx, thy, tel)
            Xx, Yx = self.field_to_focal_m(thx + h, thy, tel)
            Xy, Yy = self.field_to_focal_m(thx, thy + h, tel)
            j11 = (Xx - X) / h
            j12 = (Xy - X) / h
            j21 = (Yx - Y) / h
            j22 = (Yy - Y) / h
            det = j11 * j22 - j12 * j21
            rx = fx - X
            ry = fy - Y
            thx = thx + (j22 * rx - j12 * ry) / det
            thy = thy + (-j21 * rx + j11 * ry) / det
        return thx, thy

    # --- ICRF <-> field ---------------------------------------------------
    def _sky_to_field(self, e_east, n_north):
        """The frame reflection Ref(rotTelPos - q): involutory, so this
        is also the field -> tangent map."""
        return (self._cax * e_east + self._sax * n_north,
                self._sax * e_east - self._cax * n_north)

    def icrf_to_field(self, ra, dec):
        """ICRF -> camera-frame field angles (the photon chain's input):
        gnomonic about the observed boresight in observed ra/dec, then
        the reflection Ref(rotTelPos - q)."""
        rob, dob = self.obs.icrf_to_observed_radec(
            np.asarray(ra, float), np.asarray(dec, float))
        e, n = gnomonic_project(rob, dob, self._bore_rob, self._bore_dob)
        return self._sky_to_field(e, n)

    def field_to_icrf(self, thx, thy):
        e, n = self._sky_to_field(thx, thy)   # involution: self-inverse
        rob, dob = gnomonic_deproject(e, n, self._bore_rob,
                                      self._bore_dob)
        return self.obs.observed_radec_to_icrf(rob, dob)

    # --- full WCS per detector ---------------------------------------------
    def det_field_center(self, ccd: CCD, tel=None):
        fx = ccd.center_mm[0] * 1e-3
        fy = ccd.center_mm[1] * 1e-3
        thx, thy = self.focal_m_to_field(fx, fy, tel)
        return float(thx[0]), float(thy[0])

    def field_samples(self, ccd: CCD, tel=None, rings=6):
        """Hexapolar field-angle grid covering the detector + margin."""
        cx, cy = self.det_field_center(ccd, tel)
        # detector half-diagonal in field angle + 10% margin
        half_mm = 0.5 * np.hypot(ccd.bounds.width, ccd.bounds.height) \
            * PIXEL_SIZE_MM
        r_max = 1.1 * half_mm * 1e-3 / self._efl
        thx = [cx]
        thy = [cy]
        for k in range(1, rings + 1):
            r = r_max * k / rings
            m = 6 * k
            a = np.arange(m) * 2 * np.pi / m
            thx.extend(cx + r * np.cos(a))
            thy.extend(cy + r * np.sin(a))
        return np.array(thx), np.array(thy)

    def make_culling_wcs(self, ccd: CCD) -> TanSipWCS:
        """The WCS the catalog cull uses: the CCD's own."""
        return self.get_wcs(ccd)

    def get_wcs(self, ccd: CCD, z_offset: float = None) -> TanSipWCS:
        """Fit the order-3 TAN-SIP pixel->ICRF WCS for one detector.
        z_offset defaults to the detector's focal height offset."""
        if z_offset is None:
            z_offset = getattr(ccd, "height_mm", 0.0) * 1e-3
        tel = self.telescope.for_detector(ccd.det_name, z_offset)
        thx, thy = self.field_samples(ccd, tel)
        fx, fy = self.field_to_focal_m(thx, thy, tel)
        x, y = focal_mm_to_pixel(ccd, fx * 1e3, fy * 1e3)
        ra, dec = self.field_to_icrf(thx, thy)
        return fit_tan_sip(x, y, ra, dec, order=self.order)


def make_wcs_factory(boresight_ra, boresight_dec, mjd, band="r",
                     rotTelPos=0.0, telescope: LoadedTelescope = None,
                     wavelength_nm=None, order: int = 3, **weather):
    """One-call constructor with the JAX package's defaults (T = 280 K,
    pressure from the site altitude, H2O 1 kPa, the band's effective
    wavelength, SIP order 3)."""
    wl = wavelength_nm or BAND_WL.get(band, 622.0)
    obs = Observation(boresight_ra, boresight_dec, mjd, wavelength_nm=wl,
                      **weather)
    tel = telescope or load_telescope(band=band, rotTelPos=rotTelPos)
    return WCSFactory(obs, tel, wavelength_nm=wl, order=order)
