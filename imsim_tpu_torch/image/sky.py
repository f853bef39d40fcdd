"""Sky background: brightness model, CCD gradient plane, E2V fringing
(copy of imsim_tpu/image/sky.py; host numpy).

SkyModel is the analytic decomposition the JAX package uses in place of
rubin_sim.skybrightness: per-band dark-sky zenith surface brightness, van
Rhijn airglow with extinction, Krisciunas & Schaefer (1991) moonlight,
zodiacal light and twilight, or the loaded sky SED's component rates
with the same condition factors.  SkyGradient is the plane through the
sky level at the CCD centre and its two lower corners; CCD_Fringing the
normalized fringe surface of E2V sensors.
"""
from __future__ import annotations

import hashlib

import numpy as np

from ..catalog.bandpass import Bandpass
from ..catalog.instcat import RUBIN_AREA
from ..utils.coords import angular_separation

# Zenith dark-sky surface brightness, AB mag/arcsec^2
DARK_SKY_SB = {"u": 22.96, "g": 22.26, "r": 21.20,
               "i": 20.48, "z": 19.60, "y": 18.61}
# Atmospheric extinction coefficient per band (mag/airmass)
EXTINCTION_K = {"u": 0.47, "g": 0.21, "r": 0.13,
                "i": 0.10, "z": 0.07, "y": 0.17}
# Zodiacal-light surface brightness at the ecliptic pole, AB
# mag/arcsec^2; it brightens toward the ecliptic plane by ~1.3 mag
ZODI_POLE_SB = {"u": 24.9, "g": 23.8, "r": 23.1,
                "i": 22.7, "z": 22.5, "y": 22.4}
ECL_OBLIQUITY = np.radians(23.4393)
# Solar AB magnitudes through the Rubin bands and Johnson V: moonlight
# and twilight are scattered sunlight
SUN_AB_MAG = {"u": 6.39, "g": 5.11, "r": 4.65,
              "i": 4.53, "z": 4.50, "y": 4.50}
V_SUN_AB = 4.81
# Dark-sky V surface brightness of K&S 1991's 79 nL
V_DARK_SB = 21.587


def _solar_vs_dark_color(band: str) -> float:
    """Converts a V-band scattered-sunlight flux ratio (against the V dark
    sky) into the same ratio in `band`."""
    col_sun = SUN_AB_MAG.get(band, V_SUN_AB) - V_SUN_AB
    col_dark = DARK_SKY_SB.get(band, 21.0) - V_DARK_SB
    return 10.0 ** (-0.4 * (col_sun - col_dark))


def ecliptic_latitude(ra, dec):
    """Ecliptic latitude [rad] from equatorial (ra, dec) [rad]."""
    return np.arcsin(np.cos(ECL_OBLIQUITY) * np.sin(dec)
                     - np.sin(ECL_OBLIQUITY) * np.cos(dec) * np.sin(ra))


def _krisciunas_schaefer_delta(moon_phase_deg, moon_alt_rad, sep_rad, k, X):
    """Moonlight brightening as a V-band flux ratio against the dark sky
    (Krisciunas & Schaefer 1991)."""
    if moon_alt_rad <= 0:
        return 0.0
    alpha = moon_phase_deg  # 0 = full moon
    # lunar illuminance
    istar = 10 ** (-0.4 * (3.84 + 0.026 * abs(alpha) + 4e-9 * alpha**4))
    rho = np.degrees(sep_rad)
    frho = 10 ** 5.36 * (1.06 + np.cos(sep_rad) ** 2) \
        + 10 ** (6.15 - rho / 40.0)
    # optical pathlength of moonlight (K&S eq. 3)
    Xm = (1 - 0.96 * np.sin(np.pi / 2 - moon_alt_rad) ** 2) ** -0.5
    Bmoon = frho * istar * 10 ** (-0.4 * k * Xm) \
        * (1 - 10 ** (-0.4 * k * X))
    # K&S calibrate in V: 79 nL is their dark-sky zenith brightness
    return Bmoon / 79.0


class SkyModel:
    """Sky level in photons/arcsec^2 (through the hardware bandpass when a
    sky SED is loaded: the atmosphere is part of the emission model)."""

    def __init__(self, exptime, mjd, bandpass: Bandpass,
                 pupil_area=RUBIN_AREA, airmass=1.0,
                 moon_phase_deg=180.0, moon_alt_rad=-0.5,
                 moon_ra=0.0, moon_dec=0.0, sun_alt_rad=-1.0,
                 sky_sed=None, logger=None):
        self.exptime = exptime
        self.mjd = mjd
        self.bandpass = bandpass
        self.band = bandpass.band
        self.pupil_area = pupil_area
        self.airmass = airmass
        self.moon_phase_deg = moon_phase_deg
        self.moon_alt_rad = moon_alt_rad
        self.moon_ra = moon_ra
        self.moon_dec = moon_dec
        self.sun_alt_rad = sun_alt_rad
        # a loaded spectrum (image/sky_sed.py): component templates
        # integrated through the hardware bandpass
        self.sky_sed = sky_sed
        self._sed_rates = None
        if sky_sed is not None:
            from ..catalog.bandpass import hardware_bandpass
            from .sky_sed import photon_rate

            bp_hw = hardware_bandpass(self.band)
            self._sed_rates = {
                name: photon_rate(sky_sed.wave_nm, spec, bp_hw)
                for name, spec in sky_sed.components.items()}

    # --- per-component condition/position factors (flux ratios against
    # the component's dark-zenith template) ------------------------------

    def _airglow_factor(self):
        """van Rhijn airmass scaling x extinction of the airglow."""
        X = self.airmass
        k = EXTINCTION_K.get(self.band, 0.15)
        vr = (1 - 0.96 * (1 - 1 / X**2)) ** -0.5 if X > 1 else 1.0
        return vr * 10 ** (-0.4 * k * (X - 1))

    def _moon_ratio_v(self, ra, dec):
        """The V-band moonlight-to-dark-sky flux ratio (the moonlight
        template is normalized to a unit V ratio)."""
        k = EXTINCTION_K.get("g", 0.21) * 0.62 + 0.08  # ~ k_V
        sep = angular_separation(ra, dec, self.moon_ra, self.moon_dec)
        return _krisciunas_schaefer_delta(
            self.moon_phase_deg, self.moon_alt_rad, sep, k,
            self.airmass)

    def _moon_factor(self, ra, dec):
        """K&S moonlight as a flux ratio against this band's dark sky,
        color-corrected by the solar-vs-dark-sky color."""
        k = EXTINCTION_K.get(self.band, 0.15)
        sep = angular_separation(ra, dec, self.moon_ra, self.moon_dec)
        ratio_v = _krisciunas_schaefer_delta(
            self.moon_phase_deg, self.moon_alt_rad, sep, k,
            self.airmass)
        return ratio_v * _solar_vs_dark_color(self.band)

    def _zodi_factor(self, ra, dec):
        """Ecliptic morphology against the pole value (Leinert 1998)."""
        beta = ecliptic_latitude(ra, dec)
        return 10 ** (0.4 * 1.3 * (1.0 - abs(np.sin(beta))))

    def _twilight_ratio_r(self):
        """The r-band twilight-to-dark-sky flux ratio: 1 at sun altitude
        -13 deg, 10x per 2.5 deg, none below -20 deg."""
        sun_alt_deg = np.degrees(self.sun_alt_rad)
        if sun_alt_deg <= -20.0:
            return 0.0
        return 10.0 ** ((sun_alt_deg + 13.0) / 2.5)

    def _twilight_excess(self):
        """Twilight brightening against the dark sky, per band by the
        solar-vs-dark-sky color."""
        ratio_r = self._twilight_ratio_r()
        if ratio_r == 0.0:
            return 0.0
        color = _solar_vs_dark_color(self.band) / _solar_vs_dark_color("r")
        return ratio_r * color

    def get_sky_level(self, ra, dec):
        """photons/arcsec^2 at (ra, dec) radians: airglow + moonlight +
        zodiacal light + twilight; with a loaded sky SED the absolute
        scale and spectrum come from the data and the condition factors
        stay analytic."""
        m_dark = DARK_SKY_SB.get(self.band, 21.0)
        if self._sed_rates is not None:
            rate = 0.0
            for name, r0 in self._sed_rates.items():
                if name == "airglow":
                    rate += r0 * self._airglow_factor()
                elif name == "moonlight":
                    rate += r0 * self._moon_ratio_v(ra, dec)
                elif name == "zodiacal":
                    rate += r0 * self._zodi_factor(ra, dec)
                elif name == "twilight":
                    rate += r0 * self._twilight_ratio_r()
                else:       # merged: total analytic ratio vs dark
                    ratio = (self._airglow_factor()
                             + self._moon_factor(ra, dec)
                             + self._twilight_excess())
                    rate += r0 * ratio
            # component files without moonlight/twilight templates get
            # those conditions against the summed dark base
            if "merged" not in self._sed_rates:
                dark_base = sum(self._sed_rates.values())
                if "moonlight" not in self._sed_rates:
                    rate += dark_base * self._moon_factor(ra, dec)
                if "twilight" not in self._sed_rates:
                    rate += dark_base * self._twilight_excess()
            return rate * self.pupil_area * self.exptime
        flux_ratio = self._airglow_factor()
        flux_ratio += self._moon_factor(ra, dec)
        # zodiacal light: pole value brightening ~1.3 mag toward the
        # ecliptic plane
        m_zodi = (ZODI_POLE_SB.get(self.band, 23.0)
                  - 1.3 * (1.0 - abs(np.sin(ecliptic_latitude(ra, dec)))))
        flux_ratio += 10 ** (-0.4 * (m_zodi - m_dark))
        flux_ratio += self._twilight_excess()
        m_sky = m_dark - 2.5 * np.log10(max(flux_ratio, 1e-6))
        # photons/s/cm^2/arcsec^2 via the bandpass AB zeropoint
        rate = 10 ** (-0.4 * (m_sky - self.bandpass.zeropoint))
        return rate * self.pupil_area * self.exptime


class SkyGradient:
    """Plane through the sky level at the CCD centre and its two lower
    corners; returns the level relative to the centre's."""

    def __init__(self, sky_model, wcs, world_center_ra, world_center_dec,
                 image_xsize):
        self.sky_level_center = sky_model.get_sky_level(world_center_ra,
                                                        world_center_dec)
        cx, cy = wcs.radec_to_xy(world_center_ra, world_center_dec)
        M = np.array([[float(cx), float(cy), 1],
                      [0.0, 0.0, 1],
                      [float(image_xsize), 0.0, 1]])
        ra_ll, dec_ll = wcs.xy_to_radec(0.0, 0.0)
        ra_lr, dec_lr = wcs.xy_to_radec(float(image_xsize), 0.0)
        z = np.array([self.sky_level_center,
                      sky_model.get_sky_level(ra_ll, dec_ll),
                      sky_model.get_sky_level(ra_lr, dec_lr)])
        self.a, self.b, self.c = np.linalg.solve(M, z)

    def __call__(self, x, y):
        return (self.a * x + self.b * y + self.c) / self.sky_level_center


def sensor_fringing_seed(serial: str, visit: int) -> int:
    """Deterministic per-sensor seed via sha256 (not hash())."""
    h = hashlib.sha256(f"{serial}:{visit}".encode()).digest()
    return int.from_bytes(h[:4], "little")


class CCD_Fringing:
    """Normalized fringing surface for E2V sensors: a spectral-synthesis
    heightfield -> cos(2 n1 X) pattern at 0.2% amplitude.  Host numpy in
    the JAX package's order (its draws from default_rng(seed)), so the
    map is bit-equal to the JAX package's."""

    def __init__(self, seed, spatial_vary=True, boresight_offset_deg=0.0):
        self.seed = seed
        self.spatial_vary = spatial_vary
        self.offset = boresight_offset_deg

    def generate_heightfield(self, fractal_dimension=2.5, n=4096):
        """The epitaxial-thickness surface: a Hermitian half-plane of
        complex Gaussian modes with amplitude k^-gamma exp(-(k/k_c)^2),
        gamma = (4 - D) / 1.2, k_c = 1/64, inverted with one real FFT.  A
        real (n, n) array."""
        gamma = (4.0 - fractal_dimension) / 1.2
        gen = np.random.default_rng(self.seed)
        ky = np.fft.fftfreq(n)[:, None]
        kx = np.fft.rfftfreq(n)[None, :]
        k = np.hypot(kx, ky)
        k_c = 1.0 / 64.0
        amp = np.zeros_like(k)
        nz = k > 0
        amp[nz] = k[nz] ** (-gamma) * np.exp(-(k[nz] / k_c) ** 2)
        modes = (gen.standard_normal(k.shape)
                 + 1j * gen.standard_normal(k.shape)) * amp
        return np.fft.irfft2(modes, s=(n, n))

    def fringe_variation_level(self):
        """OH skyline spatial variation against field position: a smooth
        radial modulation (a measured surface goes through
        `skyline_surface`)."""
        if not self.spatial_vary:
            return 1.0
        return 1.0 + 0.06 * np.cos(self.offset * 1.8) - 0.03 * self.offset**2 / 4.0

    def fringing_map(self, shape=(4096, 4096), amplitude=0.002,
                     skyline_surface=None):
        """Normalized (mean ~1) float32 fringing surface.

        skyline_surface: optional measured OH-skyline spatial-variation
        map (2-D array, bilinearly resampled to `shape`); the analytic
        fringe_variation_level is used when absent."""
        n = 4096
        X = self.generate_heightfield(2.5, n)
        X *= 10.0 / np.std(X)
        if skyline_surface is not None:
            sv = np.asarray(skyline_surface, float)
            yi = np.linspace(0, sv.shape[0] - 1, shape[0])
            xi = np.linspace(0, sv.shape[1] - 1, shape[1])
            # bilinear resample onto the image grid
            y0 = np.clip(yi.astype(int), 0, sv.shape[0] - 2)[:, None]
            x0 = np.clip(xi.astype(int), 0, sv.shape[1] - 2)[None, :]
            wy = (yi[:, None] - y0)
            wx = (xi[None, :] - x0)
            level = (sv[y0, x0] * (1 - wy) * (1 - wx)
                     + sv[y0, x0 + 1] * (1 - wy) * wx
                     + sv[y0 + 1, x0] * wy * (1 - wx)
                     + sv[y0 + 1, x0 + 1] * wy * wx)
        else:
            level = self.fringe_variation_level()
        Z = amplitude * level * np.cos(2 * 1.5 * X[:shape[0], :shape[1]]) \
            + 1.0
        return Z.astype(np.float32)
