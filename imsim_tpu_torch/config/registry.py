"""Type registries: the imSim type names -> builders
(imsim_tpu/config/registry.py counterpart, the same names and values).

The registries are plain dicts, so users extend the port the same way:
register_input("my_loader", builder), and YAML `type:` names resolve
through them.  The input loaders build the port's own objects (OpsimData,
the perturbed telescope, the atmosphere's config and screen spec, the
sky model, tree rings, vignetting); `config.runner.build_visit_context`
routes each `input.<name>` section through INPUT_TYPES.
"""
from __future__ import annotations

import dataclasses

import numpy as np

INPUT_TYPES: dict = {}
VALUE_TYPES: dict = {}
IMAGE_TYPES: dict = {}
STAMP_TYPES: dict = {}
OUTPUT_TYPES: dict = {}
EXTRA_OUTPUT_TYPES: dict = {}
PSF_TYPES: dict = {}
WCS_TYPES: dict = {}
PHOTON_OP_TYPES: dict = {}
BANDPASS_TYPES: dict = {}
SED_TYPES: dict = {}


def _reg(registry):
    def deco_factory(name):
        def deco(fn):
            registry[name] = fn
            return fn
        return deco
    return deco_factory


register_input = _reg(INPUT_TYPES)
register_value = _reg(VALUE_TYPES)
register_image = _reg(IMAGE_TYPES)
register_stamp = _reg(STAMP_TYPES)
register_output = _reg(OUTPUT_TYPES)
register_extra_output = _reg(EXTRA_OUTPUT_TYPES)
register_psf = _reg(PSF_TYPES)
register_wcs = _reg(WCS_TYPES)
register_photon_op = _reg(PHOTON_OP_TYPES)
register_bandpass = _reg(BANDPASS_TYPES)
register_sed = _reg(SED_TYPES)


def build_value(type_name: str, node: dict, view):
    """Resolve a {type: X, ...} node through the value registries."""
    for reg in (VALUE_TYPES, PSF_TYPES, WCS_TYPES, BANDPASS_TYPES,
                SED_TYPES, PHOTON_OP_TYPES):
        if type_name in reg:
            return reg[type_name](node, view)
    raise KeyError(f"unknown config type '{type_name}'")


# ---- built-in registrations ------------------------------------------------


@register_bandpass("RubinBandpass")
def _rubin_bandpass(node, view):
    from ..catalog.bandpass import rubin_bandpass

    band = view.resolve(node.get("band", "@image.bandpass.band"))
    airmass = view.resolve(node.get("airmass", 1.0))
    return rubin_bandpass(band, airmass=float(airmass))


@register_psf("AtmosphericPSF")
def _atm_psf(node, view):
    from ..psf.atmosphere import AtmConfig

    return AtmConfig(
        fwhm=float(view.resolve(node.get("fwhm",
                                         view.get("psf.fwhm", 0.8)))),
        L0=float(view.resolve(node.get("L0", 25.0))),
        kcrit=float(view.resolve(node.get("kcrit", 0.2))),
        exptime=float(view.resolve(node.get("exptime", 30.0))),
    )


@register_psf("DoubleGaussianPSF")
def _double_gaussian_psf(node, view):
    return dict(kind="double_gaussian",
                fwhm1=float(view.resolve(node.get("fwhm1", 0.6))),
                fwhm2=float(view.resolve(node.get("fwhm2", 0.12))),
                wgt1=float(view.resolve(node.get("wgt1", 0.8))))


@register_psf("KolmogorovPSF")
def _kolmogorov_psf(node, view):
    return dict(kind="kolmogorov",
                fwhm=float(view.resolve(node.get("fwhm", 0.8))),
                gauss_fwhm=float(view.resolve(node.get("gauss_fwhm", 0.3))))


@register_psf("Convolve")
def _convolve_psf(node, view):
    return [view.resolve(item) for item in node.get("items", [])]


@register_wcs("Batoid")
def _batoid_wcs(node, view):
    # the name the configs use for the ray-traced WCS
    return dict(kind="raytraced", node=node)


@register_wcs("Dict")
def _dict_wcs(node, view):
    from ..optics.wcs import TanSipWCS

    d = view.resolve(node.get("dict", {}))
    crpix = [float(d.get("CRPIX1", 2048)) - 1,
             float(d.get("CRPIX2", 2048)) - 1]
    cd = np.array([[float(d.get("CD1_1", -5.5e-5)),
                    float(d.get("CD1_2", 0.0))],
                   [float(d.get("CD2_1", 0.0)),
                    float(d.get("CD2_2", 5.5e-5))]])
    crval = [float(d.get("CRVAL1", 0.0)) * np.pi / 180,
             float(d.get("CRVAL2", 0.0)) * np.pi / 180]
    return TanSipWCS(crpix, cd, crval)


@register_value("OpsimData")
def _opsim_value(node, view):
    field = view.resolve(node["field"])
    return view.state["opsim_data"][field]


@register_value("SkyLevel")
def _sky_level(node, view):
    sky = view.state["sky_model"]
    ra, dec = view.state["boresight"]
    return sky.get_sky_level(ra, dec)


@register_value("TreeRingCenter")
def _tree_ring_center(node, view):
    det = view.resolve(node.get("det_name", view.state.get("det_name")))
    return view.state["tree_rings"].get_center(det)


@register_value("TreeRingFunc")
def _tree_ring_func(node, view):
    det = view.resolve(node.get("det_name", view.state.get("det_name")))
    return view.state["tree_rings"].get_func(det)


@register_value("RowData")
def _row_data(node, view):
    from ..catalog.table_row import row_data
    return row_data(node, view)


@register_value("List")
def _list_value(node, view):
    items = [view.resolve(v) for v in node.get("items", [])]
    if node.get("index") is not None:
        return items[int(view.resolve(node["index"]))]
    return items


@register_value("FormattedStr")
def _formatted_str(node, view):
    fmt = str(view.resolve(node.get("format", "")))
    items = tuple(view.resolve(v) for v in node.get("items", []))
    return fmt % items


@register_value("Sequence")
def _sequence_value(node, view):
    """The whole list at once: first/nitems/step or first/last/step."""
    first = int(view.resolve(node.get("first", 0)))
    step = int(view.resolve(node.get("step", 1)))
    if node.get("nitems") is not None:
        n = int(view.resolve(node["nitems"]))
        return list(range(first, first + n * step, step))
    last = int(view.resolve(node.get("last", first)))
    return list(range(first, last + (1 if step > 0 else -1), step))


@register_value("Current")
def _current_value(node, view):
    return view.resolve("@" + str(node.get("key", "")))


@register_photon_op("RubinOptics")
def _rubin_optics(node, view):
    return dict(kind="optics", dcr=False, diffraction=False)


@register_photon_op("RubinDiffractionOptics")
def _rubin_diff_optics(node, view):
    return dict(kind="optics", dcr=False, diffraction=True)


@register_photon_op("RubinDiffraction")
def _rubin_diffraction(node, view):
    return dict(kind="diffraction")


@register_photon_op("PhotonDCR")
def _photon_dcr(node, view):
    return dict(kind="dcr")


@register_photon_op("BandpassRatio")
def _bandpass_ratio(node, view):
    """An identity: photon wavelengths are drawn from SED x the visit's
    bandpass directly, so there is no fiducial bandpass to reweight."""
    return dict(kind="identity")


@register_stamp("LSST_Silicon")
def _stamp_silicon(node, view):
    return dict(kind="pooled", sensor="silicon")


@register_stamp("LSST_Photons")
def _stamp_photons(node, view):
    return dict(kind="pooled", sensor="none", save_photons=True)


@register_image("LSST_Image")
def _image_scattered(node, view):
    return dict(kind="pooled")


@register_image("LSST_PhotonPoolingImage")
def _image_pooled(node, view):
    return dict(kind="pooled")


@register_image("LSST_Flat")
def _image_flat(node, view):
    return dict(kind="flat")


@register_output("LSST_CCD")
def _output_ccd(node, view):
    return dict(kind="ccd")


# ---- input loaders: visit-scoped singletons, read in order by
# build_visit_context; each may read the earlier ones from view.state --


@register_input("opsim_data")
def _input_opsim(node, view):
    """Visit metadata: an opsim sqlite row, a phoSim catalog header, or
    the config's opsim_meta dict (its typed values resolved)."""
    from ..catalog import opsim as opsim_mod
    from ..meta_data import resolve_data_path as _data

    node = node or {}
    fname = _data(node.get("file_name"))
    if fname and str(fname).endswith(".db"):
        ods = opsim_mod.read_opsim_db(fname, node.get("visit"),
                                      snap=int(node.get("snap", 0)))
    elif fname:
        ods = opsim_mod.read_instcat_header(fname)
    else:
        cat = view.cfg.get("input", {}).get("instance_catalog", {}) or {}
        if cat.get("file_name"):
            ods = opsim_mod.read_instcat_header(_data(cat["file_name"]))
        else:
            # a typed value there (a RowData row of a visit table) is read
            # before the visit's metadata exists; the JAX package passes
            # such a node through unread
            meta = {k: view.resolve(v) if isinstance(v, dict) and "type" in v
                    else v for k, v in
                    (view.cfg.get("opsim_meta", {}) or {}).items()}
            ods = opsim_mod.from_dict(meta)
    # config-level metadata: snap, IMGTYPE and REASON
    for k in ("snap", "image_type", "reason"):
        if node.get(k) is not None:
            ods.meta[k] = node[k]
    return ods


@register_input("telescope")
def _input_telescope(node, view):
    """The visit's perturbed telescope (perturbations and fea terms)."""
    from ..optics.loader import load_telescope

    node = node or {}
    ods = view.state["opsim_data"]
    return load_telescope(
        telescope=node.get("name", "LSST"),
        band=ods.get("band", "r"),
        perturbations=node.get("perturbations", ()) or (),
        fea=node.get("fea"),
        rotTelPos=float(ods.get("rotTelPos", 0.0)) * np.pi / 180,
        focusZ=float(node.get("focusZ", 0.0)))


@register_input("atm_psf")
def _input_atm_psf(node, view):
    """The atmosphere and the optional AOS optics screen: (AtmConfig,
    ScreenSpec), or (None, None) when psf.type is not AtmosphericPSF.
    doOpt folds the AOS wavefront into view.state['telescope'] first,
    so it runs before the WCS factory traces the telescope.  The screens
    themselves are made from the spec on the render's device
    (config.runner.VisitContext.screens)."""
    from ..meta_data import resolve_data_path as _data
    from ..utils.rng import ATM_SEED_OFFSET

    node = node or {}
    ods = view.state["opsim_data"]
    seed = int(ods.get("seed", 42))
    tel = view.state.get("telescope")
    if node.get("doOpt") and tel is not None:
        from ..optics.aos import OpticalZernikes

        OpticalZernikes(
            seed=seed,
            data_dir=_data(node.get("optics_data_dir"))).apply_to(tel)
    psf_cfg = view.cfg.get("psf", {}) or {}
    if psf_cfg.get("type", "AtmosphericPSF") != "AtmosphericPSF":
        return None, None
    from ..psf.atmosphere import AtmConfig, screen_spec

    atm_cfg = AtmConfig(
        fwhm=float(ods.get("rawSeeing", 0.7)),
        L0=float(node.get("L0", 25.0)),
        kcrit=float(node.get("kcrit", 0.2)),
        screen_size=float(node.get("screen_size", 819.2)),
        screen_scale=float(node.get("screen_scale", 0.8)),
        altitude_deg=float(ods.get("altitude", 90.0)),
        exptime=float(ods.get("exptime", 30.0)),
        t0=float(node.get("t0", 0.0)))
    # the atmosphere's own seed: the visit's + 271828; save_file: the
    # screens are reused from that file when it exists, else saved there
    # (config.runner.VisitContext.screens)
    spec = screen_spec(seed + ATM_SEED_OFFSET, atm_cfg)
    save_file = _data(node.get("save_file"))
    if save_file:
        spec = dataclasses.replace(spec, save_file=str(save_file))
    return atm_cfg, spec


@register_input("sky_model")
def _input_sky_model(node, view):
    """The sky-brightness model from the visit's conditions, through the
    bandpass and the optional loaded sky SED in view.state."""
    from ..image.sky import SkyModel

    node = node or {}
    ods = view.state["opsim_data"]
    deg = np.pi / 180
    # opsim's moonPhase is percent illuminated; the Krisciunas & Schaefer
    # model takes the phase angle in degrees (0 = full)
    f = np.clip(float(ods.get("moonPhase", 0.0)) / 100.0, 0.0, 1.0)
    alpha_deg = float(np.degrees(np.arccos(2.0 * f - 1.0)))
    kw = {}
    if node.get("eff_area") is not None:
        kw["pupil_area"] = float(node["eff_area"])
    return SkyModel(
        float(node.get("exp_time") or ods.get("exptime", 30.0)),
        ods.get("mjd_mid", 60674.0),
        view.state["bandpass"],
        airmass=float(ods.get("airmass", 1.0)),
        moon_phase_deg=alpha_deg,
        moon_alt_rad=float(ods.get("moonAlt", -28.65)) * deg,
        moon_ra=float(ods.get("moonRA", 0.0)) * deg,
        moon_dec=float(ods.get("moonDec", 0.0)) * deg,
        sun_alt_rad=float(ods.get("sunAlt", -57.3)) * deg,
        sky_sed=view.state.get("sky_sed"), **kw)


@register_input("tree_rings")
def _input_tree_rings(node, view):
    from ..meta_data import resolve_data_path as _data
    from ..sensor.treerings import TreeRings

    node = node or {}
    return TreeRings(file_name=_data(node.get("file_name")),
                     only_dets=node.get("only_dets"))


@register_input("vignetting")
def _input_vignetting(node, view):
    from ..image.vignetting import Vignetting
    from ..meta_data import resolve_data_path as _data

    node = node or {}
    if node.get("file_name"):
        return Vignetting.from_file(_data(node["file_name"]))
    return Vignetting()
