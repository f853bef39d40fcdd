"""The physical models in one namespace (imsim_tpu/models counterpart):
each name lazily re-exports the port module's class, so that
`from imsim_tpu_torch.models import SiliconParams` works without knowing
the package's layout (sensor/, psf/, optics/, image/, electronics/,
catalog/).
"""

__all__ = [
    "SiliconParams",          # sensor: depth, diffusion, tree rings, BF
    "TreeRings",              # per-detector tree-ring displacement model
    "AtmConfig", "AtmScreens",  # frozen-flow phase-screen atmosphere
    "Telescope",              # ray-traceable optical prescription
    "SkyModel",               # sky brightness (dark sky, moon, airglow)
    "CCD_Fringing",           # thinned-CCD fringing surface
    "Camera",                 # 189-CCD focal-plane geometry, electronics
    "Bandpass",               # instrument and atmosphere throughput
]

_HOME = {
    "SiliconParams": ("imsim_tpu_torch.sensor.silicon", "SiliconParams"),
    "TreeRings": ("imsim_tpu_torch.sensor.treerings", "TreeRings"),
    "AtmConfig": ("imsim_tpu_torch.psf.atmosphere", "AtmConfig"),
    "AtmScreens": ("imsim_tpu_torch.psf.atmosphere", "AtmScreens"),
    "Telescope": ("imsim_tpu_torch.optics.telescope", "Telescope"),
    "SkyModel": ("imsim_tpu_torch.image.sky", "SkyModel"),
    "CCD_Fringing": ("imsim_tpu_torch.image.sky", "CCD_Fringing"),
    "Camera": ("imsim_tpu_torch.electronics.camera", "Camera"),
    "Bandpass": ("imsim_tpu_torch.catalog.bandpass", "Bandpass"),
}


def __getattr__(name):
    try:
        mod, sym = _HOME[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib

    return getattr(importlib.import_module(mod), sym)
