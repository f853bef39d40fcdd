"""LSST camera geometry, generated programmatically (host numpy; copy of
imsim_tpu/electronics/camera.py).

The full camera model: 189 science CCDs in 21 rafts (and, for
`LsstCam`, the corner rafts' guiders and wavefront sensors), 16 amps
each, ITL/E2V variants, focal-plane positions, raw segment geometry,
gains, read noise, bias levels, full wells and crosstalk, from the
published Rubin camera constants.  The per-detector electronics come
from a sha256-seeded generator per detector (`_det_hash`), drawn in the
reference's order, so every value is bit-equal to the JAX package's.
Measured bias levels and electronics overrides are optional JSON files.
Object model: Camera[det_name] -> CCD[amp_name] -> Amp.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np

# Science rafts (5x5 grid minus the 4 corner rafts)
SCIENCE_RAFTS = [f"R{x}{y}" for x in range(5) for y in range(5)
                 if f"{x}{y}" not in ("00", "04", "40", "44")]
SENSORS = [f"S{i}{j}" for i in range(3) for j in range(3)]
# Corner rafts: 2 full-size ITL guiders (SG0/SG1) + an intra/extra
# wavefront pair of half-height ITL sensors (SW0 at -1.5 mm, SW1 at
# +1.5 mm focal height)
CORNER_RAFTS = ["R00", "R04", "R40", "R44"]
CORNER_SENSORS = ["SG0", "SG1", "SW0", "SW1"]
WF_HEIGHT_MM = 1.5

# Vendor per raft (8 ITL rafts, 13 e2v rafts — the as-built LSSTCam mix)
ITL_RAFTS = {"R01", "R02", "R03", "R10", "R20", "R41", "R42", "R43"}

PIXEL_SIZE_MM = 0.01   # 10 um
RAFT_PITCH_MM = 127.0
CCD_PITCH_MM = 42.25

# Raw segment geometry of the LSSTCam raft example files: both vendors
# read 576 x 2048 raw segments (E2V: 10 prescan, 54 serial overscan, 46
# parallel; ITL: 3 prescan, 64 serial overscan, 48 parallel).
VENDOR_SPECS = {
    "ITL": dict(nx=4072, ny=4000, amp_nx=509, amp_ny=2000,
                prescan=3, serial_oscan=64, parallel_oscan=48,
                full_well=97_000.0, midline_bleed_stop=False),
    "E2V": dict(nx=4096, ny=4004, amp_nx=512, amp_ny=2002,
                prescan=10, serial_oscan=54, parallel_oscan=46,
                full_well=175_000.0, midline_bleed_stop=True),
    # half-height ITL wavefront sensor: single row of 8 amps
    "ITL_WF": dict(nx=4072, ny=2000, amp_nx=509, amp_ny=2000,
                   prescan=3, serial_oscan=64, parallel_oscan=48,
                   full_well=97_000.0, midline_bleed_stop=False),
}

AMP_NAMES = [f"C0{i}" for i in range(8)] + [f"C1{i}" for i in range(8)]


@dataclasses.dataclass
class Bounds:
    """Integer pixel bounds, inclusive, 0-based [xmin, xmax] x [ymin, ymax]."""
    xmin: int
    xmax: int
    ymin: int
    ymax: int

    @property
    def width(self):
        return self.xmax - self.xmin + 1

    @property
    def height(self):
        return self.ymax - self.ymin + 1

    def section_keyword(self, flipx=False, flipy=False):
        """NOAO 1-based image section string."""
        x0, x1 = self.xmin + 1, self.xmax + 1
        y0, y1 = self.ymin + 1, self.ymax + 1
        if flipx:
            x0, x1 = x1, x0
        if flipy:
            y0, y1 = y1, y0
        return f"[{x0}:{x1},{y0}:{y1}]"


def _det_hash(det_name: str, tag: str) -> np.random.Generator:
    h = hashlib.sha256(f"{det_name}:{tag}".encode()).digest()
    return np.random.default_rng(int.from_bytes(h[:8], "little"))


@dataclasses.dataclass
class Amp:
    name: str
    bounds: Bounds            # imaging section in CCD pixel coords
    raw_bounds: Bounds        # full raw segment incl pre/overscan
    raw_data_bounds: Bounds   # imaging section within raw segment
    raw_flip_x: bool
    raw_flip_y: bool
    gain: float
    read_noise: float         # ADU rms
    bias_level: float         # ADU
    full_well: float          # e-


class CCD(dict):
    """dict of Amp keyed by name + CCD-level info."""

    def __init__(self, det_name, vendor, serial, bounds, center_mm,
                 full_well, xtalk, height_mm=0.0, rot_deg=0.0):
        super().__init__()
        self.det_name = det_name
        self.vendor = vendor
        self.serial = serial
        self.bounds = bounds
        self.center_mm = center_mm   # (x, y) focal plane
        self.full_well = full_well
        self.xtalk = xtalk           # (16, 16) crosstalk matrix
        # per-detector focal height offset, consumed as a telescope
        # z-offset (the wavefront sensors' +-1.5 mm)
        self.height_mm = height_mm
        # per-detector yaw about its centre; zero unless measured values
        # come in through the overrides JSON
        self.rot_deg = rot_deg

    def getSerial(self):
        return self.serial

    @property
    def amp_names(self):
        return list(self.keys())


def build_ccd(det_name: str, bias_levels: dict | None = None) -> CCD:
    raft, sensor = det_name.split("_")
    is_corner = raft in CORNER_RAFTS
    is_wf = is_corner and sensor.startswith("SW")
    if is_corner:
        vendor = "ITL_WF" if is_wf else "ITL"
    else:
        vendor = "ITL" if raft in ITL_RAFTS else "E2V"
    spec = VENDOR_SPECS[vendor]
    nx, ny = spec["nx"], spec["ny"]
    anx, any_ = spec["amp_nx"], spec["amp_ny"]
    pre, sos, pos = spec["prescan"], spec["serial_oscan"], spec["parallel_oscan"]

    # focal-plane center
    rx, ry = int(raft[1]), int(raft[2])
    if is_corner:
        # corner-raft layout: sensors cluster at the raft corner
        # nearest the field center; the wavefront pair stacks two
        # half-height sensors into one full-CCD footprint
        ux = 1.0 if rx == 0 else -1.0
        uy = 1.0 if ry == 0 else -1.0
        bx = (rx - 2) * RAFT_PITCH_MM
        by = (ry - 2) * RAFT_PITCH_MM
        if sensor == "SG0":
            cx, cy = bx + ux * CCD_PITCH_MM, by
        elif sensor == "SG1":
            cx, cy = bx, by + uy * CCD_PITCH_MM
        else:
            cx = bx + ux * CCD_PITCH_MM
            cy = by + uy * CCD_PITCH_MM \
                + (-1.0 if sensor == "SW0" else 1.0) * uy * 10.5
    else:
        sx, sy = int(sensor[1]), int(sensor[2])
        cx = (rx - 2) * RAFT_PITCH_MM + (sx - 1) * CCD_PITCH_MM
        cy = (ry - 2) * RAFT_PITCH_MM + (sy - 1) * CCD_PITCH_MM

    serial = f"{vendor}-CCD{raft[1:]}{sensor[1:]}"

    n_amps = 8 if is_wf else 16
    # the draw order is the reference's: gains, read noises, then the
    # crosstalk row by row
    rng = _det_hash(det_name, "electronics")
    gains = rng.normal(1.68, 0.04, n_amps)
    read_noises = rng.normal(6.5, 0.6, n_amps) / gains  # ADU
    # weak symmetric crosstalk between amps, strongest for neighbors
    xt = np.zeros((n_amps, n_amps))
    for i in range(n_amps):
        for j in range(n_amps):
            if i == j:
                continue
            row_i, col_i = divmod(i, 8)
            row_j, col_j = divmod(j, 8)
            d = abs(col_i - col_j) + 4 * abs(row_i - row_j)
            xt[i, j] = rng.normal(0, 2e-6) + (2e-6 / (1 + d * d))
    # the wavefront pair sits at -+1.5 mm; the simulated camera has no
    # other height error or yaw (measured values come in through the
    # overrides JSON)
    height_mm = (-WF_HEIGHT_MM if sensor == "SW0" else WF_HEIGHT_MM) \
        if is_wf else 0.0
    ccd = CCD(det_name, vendor, serial,
              Bounds(0, nx - 1, 0, ny - 1), (cx, cy),
              spec["full_well"], xt, height_mm=height_mm, rot_deg=0.0)

    raw_nx = pre + anx + sos
    raw_ny = any_ + pos
    for k, aname in enumerate(AMP_NAMES[:n_amps]):
        row, col = divmod(k, 8)
        # imaging section: amps tile the CCD 8 cols x 2 rows; bottom row
        # (C0x) reads down, top row (C1x) reads up.
        x0 = col * anx
        y0 = 0 if row == 0 else ny - any_
        b = Bounds(x0, x0 + anx - 1, y0, y0 + any_ - 1)
        raw_b = Bounds(0, raw_nx - 1, 0, raw_ny - 1)
        raw_db = Bounds(pre, pre + anx - 1, 0, any_ - 1)
        bias = 1000.0 if bias_levels is None else \
            bias_levels.get(det_name, {}).get(aname, 1000.0)
        ccd[aname] = Amp(
            name=aname, bounds=b, raw_bounds=raw_b, raw_data_bounds=raw_db,
            # E2V flips x on the top row only; ITL flips x everywhere;
            # the top row reads top-to-bottom
            raw_flip_x=(row == 1) or vendor.startswith("ITL"),
            raw_flip_y=(row == 1),
            gain=float(gains[k]), read_noise=float(read_noises[k]),
            bias_level=float(bias), full_well=spec["full_well"])
    return ccd


class Camera(dict):
    """Camera['R22_S11'] -> CCD.  det_num ordering is name-sorted."""

    def __init__(self, camera_class="LsstCamSim", bias_levels_file=None,
                 overrides_file=None):
        """bias_levels_file: per-amp bias JSON ({det: {amp: adu}}).

        overrides_file: measured electronics JSON replacing the
        synthesized values — {det: {"gains": {amp: e-/ADU},
        "read_noise": {amp: ADU}, "full_well": e-, "xtalk": 16x16 list,
        "rot_deg": deg, "height_mm": mm}}.  Both files are optional: a
        missing path keeps the synthesized values."""
        super().__init__()
        self.camera_name = camera_class
        bias = None
        if bias_levels_file and os.path.isfile(bias_levels_file):
            with open(bias_levels_file) as f:
                bias = json.load(f)
        overrides = {}
        if overrides_file and os.path.isfile(overrides_file):
            with open(overrides_file) as f:
                overrides = json.load(f)
        if camera_class == "LsstComCamSim":
            names = [f"R22_{s}" for s in SENSORS]
        else:
            names = [f"{r}_{s}" for r in SCIENCE_RAFTS for s in SENSORS]
            if camera_class == "LsstCam":
                # full focal plane: + corner-raft guiders and
                # intra/extra wavefront sensors
                names += [f"{r}_{s}" for r in CORNER_RAFTS
                          for s in CORNER_SENSORS]
        for n in sorted(names):
            ccd = build_ccd(n, bias)
            ov = overrides.get(n)
            if ov:
                if "xtalk" in ov:
                    ccd.xtalk = np.asarray(ov["xtalk"], float)
                if "full_well" in ov:
                    ccd.full_well = float(ov["full_well"])
                    for a in ccd.values():
                        a.full_well = float(ov["full_well"])
                if "rot_deg" in ov:
                    ccd.rot_deg = float(ov["rot_deg"])
                if "height_mm" in ov:
                    ccd.height_mm = float(ov["height_mm"])
                for aname, g in (ov.get("gains") or {}).items():
                    ccd[aname].gain = float(g)
                for aname, rn in (ov.get("read_noise") or {}).items():
                    ccd[aname].read_noise = float(rn)
            self[n] = ccd
        self.det_names = sorted(names)

    def det_name(self, det_num: int) -> str:
        return self.det_names[det_num]

    def det_num(self, det_name: str) -> int:
        return self.det_names.index(det_name)


_camera_cache: dict = {}


def get_camera(camera="LsstCamSim", bias_levels_file=None,
               overrides_file=None) -> Camera:
    key = (camera, bias_levels_file, overrides_file)
    if key not in _camera_cache:
        _camera_cache[key] = Camera(camera, bias_levels_file,
                                    overrides_file)
    return _camera_cache[key]


def pixel_to_focal_mm(ccd: CCD, x, y):
    """CCD pixel -> focal plane mm (x along columns), including the
    detector's yaw about its center."""
    nx = ccd.bounds.width
    ny = ccd.bounds.height
    dx = (np.asarray(x) - (nx - 1) / 2) * PIXEL_SIZE_MM
    dy = (np.asarray(y) - (ny - 1) / 2) * PIXEL_SIZE_MM
    r = np.radians(getattr(ccd, "rot_deg", 0.0))
    c, s = np.cos(r), np.sin(r)
    fx = ccd.center_mm[0] + c * dx - s * dy
    fy = ccd.center_mm[1] + s * dx + c * dy
    return fx, fy


def focal_mm_to_pixel(ccd: CCD, fx, fy):
    nx = ccd.bounds.width
    ny = ccd.bounds.height
    ux = np.asarray(fx) - ccd.center_mm[0]
    uy = np.asarray(fy) - ccd.center_mm[1]
    r = np.radians(getattr(ccd, "rot_deg", 0.0))
    c, s = np.cos(r), np.sin(r)
    x = (c * ux + s * uy) / PIXEL_SIZE_MM + (nx - 1) / 2
    y = (-s * ux + c * uy) / PIXEL_SIZE_MM + (ny - 1) / 2
    return x, y
