"""Camera constants the readout needs (copy of the JAX package's
imsim_tpu/electronics/camera.py VENDOR_SPECS).  The camera model itself
(CCD and amp geometry, gains, crosstalk) is built by the JAX package and
crosses as numpy data (convert.readout_from_numpy)."""

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
