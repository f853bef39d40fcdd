"""The port's spans and counters (imsim_tpu_torch.utils.trace) on the
CPU: nothing recorded and no synchronisation while tracing is off; the
CCD's span tree, the binner's counters, the shared clock with
torch.profiler, a visit's three threads linked by CCD, the CLI's
Chrome-trace file, and the benchmark's readers of the store."""
import json
import threading

import numpy as np
import pytest
import torch

from imsim_tpu_torch import __main__ as CLI
from imsim_tpu_torch.config import runner as TR
from imsim_tpu_torch.config.interpreter import load_config
from imsim_tpu_torch.photons.batch import PhotonBatch
from imsim_tpu_torch.sensor.simple import accumulate
from imsim_tpu_torch.utils import trace
from portbench import harness

torch.set_num_threads(1)

DET = "R22_S11"
FAST = ["psf.type=DoubleGaussianPSF", "image.sensor.type=none",
        "image.batch_size=200000", "image.nbatch=2",
        "input.atm_psf.screen_size=102.4", "input.atm_psf.screen_scale=0.8"]
CCD_STEPS = {"ccd.upload", "ccd.sky_pieces", "ccd.render", "ccd.sky",
             "ccd.cosmic_rays", "ccd.readout"}


@pytest.fixture(autouse=True)
def clean_store():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    """A tiny instance catalog at the boresight (R22_S11's centre): one
    star bright enough for the FFT pass, seven faint objects, one SED."""
    d = tmp_path_factory.mktemp("cat")
    (d / "flatSED").mkdir()
    w = np.linspace(300, 1150, 200)
    np.savetxt(d / "flatSED" / "sed_flat.txt",
               np.column_stack([w, np.ones_like(w)]))
    lines = ["rightascension 30.0", "declination -20.0", "mjd 60674.2",
             "filter 2", "seeing 0.7", "vistime 30.0", "rottelpos 0.0",
             "obshistid 4242", "altitude 60.0"]
    rng = np.random.default_rng(5)
    for i in range(8):
        ra = 30.0 + rng.uniform(-0.004, 0.004)
        dec = -20.0 + rng.uniform(-0.004, 0.004)
        mag = 14.0 if i == 0 else rng.uniform(21.0, 23.0)
        lines.append(f"object {i} {ra:.6f} {dec:.6f} {mag:.2f} "
                     "flatSED/sed_flat.txt 0 0 0 0 0 0 point none none")
    (d / "cat.txt").write_text("\n".join(lines) + "\n")
    return str(d / "cat.txt"), str(d)


def _over(catalog, out, *extra):
    cat, sed_dir = catalog
    return [f"input.instance_catalog.file_name={cat}",
            f"input.instance_catalog.sed_dir={sed_dir}", *FAST,
            f"output.dir={out}", *extra]


@pytest.fixture(scope="module")
def ccd(catalog, tmp_path_factory):
    """The visit context and R22_S11's central 256 x 256 window, prepared
    on the host (render_one_ccd uploads it)."""
    out = tmp_path_factory.mktemp("out")
    ctx = TR.build_visit_context(load_config(
        {"template": "imsim-config-instcat"}, _over(catalog, out)))
    prep = TR.prepare_ccd(ctx, DET, window=(256, 256), device="cpu",
                          upload=False)
    return ctx, prep


def test_off_records_nothing():
    assert not trace.on()
    # the same no-op context every time; a CUDA device makes no event
    assert trace.span("a") is trace.span("b", ccd="x", device="cuda")
    with trace.span("a", device="cuda"):
        trace.count("c", torch.ones(()))
    steps = trace.Steps("ccd", device="cuda")
    steps.mark("render")
    assert trace.spans() == [] and trace.counters() == []


def test_render_off_records_no_span_and_never_syncs(ccd, monkeypatch):
    ctx, prep = ccd
    calls = []
    monkeypatch.setattr(TR, "_sync", lambda device: calls.append(device))
    res = TR.render_one_ccd(ctx, DET, "cpu", prep=prep)
    assert calls == [] and trace.spans() == [] and trace.counters() == []
    assert {"sky pieces", "render", "sky", "cosmic rays",
            "readout"} <= set(res["seconds"])


def _self_s(s, children):
    """A span's host seconds less its children's (one thread: they do
    not overlap)."""
    return s["host_s"] - sum(c["host_s"] for c in children)


def test_render_on_gives_the_ccd_span_tree(ccd, monkeypatch):
    ctx, prep = ccd
    calls = []
    monkeypatch.setattr(TR, "_sync", lambda device: calls.append(device))
    trace.enable()
    TR.render_one_ccd(ctx, DET, "cpu", prep=prep)
    trace.disable()
    sp = trace.spans()
    by_id = {s["id"]: s for s in sp}
    kids = {s["id"]: [c for c in sp if c["parent"] == s["id"]] for s in sp}
    (root,) = [s for s in sp if s["parent"] is None]
    assert root["name"] == "ccd"
    assert {c["name"] for c in kids[root["id"]]} == CCD_STEPS
    names = [s["name"] for s in sp]
    (render,) = [s for s in sp if s["name"] == "ccd.render"]
    assert {"render.fft", "render.plan", "render.batch"} == {
        c["name"] for c in kids[render["id"]]}
    batches = [s for s in sp if s["name"] == "render.batch"]
    assert batches and names.count("render.rows") == len(batches)
    for b in batches:
        assert [c["name"] for c in kids[b["id"]]] == [
            "render.rows", "render.shoot", "render.sensor"]
    for s in sp:
        assert s["ccd"] == DET and s["device_s"] is None
        assert s["thread"] == threading.current_thread().name
        assert s["start_ns"] <= s["end_ns"] and 0 <= s["cpu_s"]
        assert _self_s(s, kids[s["id"]]) >= 0
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= \
                p["end_ns"]
    # the steps synchronise while tracing is on: five steps, the readout
    assert len(calls) == 6
    tot = {}
    for c in trace.counters():
        assert c["ccd"] == DET
        tot[c["name"]] = tot.get(c["name"], 0.0) + c["value"]
    assert 0 <= tot["sensor.off_frame"] <= tot["sensor.binned"]
    assert tot["sensor.binned"] > 0


SENSOR = ["sensor.field", "sensor.displace", "sensor.bin",
          "sensor.redistribute"]


def test_sensor_spans_nest_under_render_sensor(catalog, tmp_path):
    """With the Silicon sensor each render.sensor holds, per chunk, the
    sensor's spans in order: the BF field (K3), the depth and diffusion
    (the analytic PSF's photons; the optics path moves them in its ray
    chain and has no sensor.displace), the binning scatter and the
    continuity update."""
    ctx = TR.build_visit_context(load_config(
        {"template": "imsim-config-instcat"},
        _over(catalog, tmp_path, "image.sensor.type=Silicon")))
    prep = TR.prepare_ccd(ctx, DET, window=(128, 128), device="cpu",
                          upload=False)
    trace.enable()
    TR.render_one_ccd(ctx, DET, "cpu", prep=prep)
    trace.disable()
    sp = trace.spans()
    kids = {s["id"]: [c["name"] for c in sp if c["parent"] == s["id"]]
            for s in sp}
    sensors = [s for s in sp if s["name"] == "render.sensor"]
    assert sensors
    for s in sensors:
        names = kids[s["id"]]
        assert names and names == SENSOR * (len(names) // len(SENSOR))
    assert all(s["ccd"] == DET for s in sp)


def test_the_catalog_ccd_bins_whole_fluxes(catalog, tmp_path):
    """`sensor.nonunit` reads 0 on what the catalog CCD's producers hand
    the binner (the pooled render's weights, the ray chain's zeroing, the
    silicon's depth loss, the template's optics and sensor): the
    contract that makes the card's atomic binning exact."""
    over = [o for o in _over(catalog, tmp_path)
            if not o.startswith(("psf.type=", "image.sensor.type="))]
    ctx = TR.build_visit_context(load_config(
        {"template": "imsim-config-instcat"}, over))
    prep = TR.prepare_ccd(ctx, DET, window=(128, 128), device="cpu",
                          upload=False)
    trace.enable()
    TR.render_one_ccd(ctx, DET, "cpu", prep=prep)
    trace.disable()
    assert "sensor.bin" in {s["name"] for s in trace.spans()}
    tot = {}
    for c in trace.counters():
        tot[c["name"]] = tot.get(c["name"], 0.0) + c["value"]
    assert tot["sensor.binned"] > 0
    assert tot["sensor.nonunit"] == 0


def test_binner_counters_match_a_hand_count():
    H, W = 6, 8
    x = torch.tensor([0.0, 7.4, 7.6, -0.6, -0.4, 3.0, 3.0, 100.0,
                      float("nan")])
    y = torch.tensor([0.0, 5.4, 1.0, 2.0, 2.0, 5.6, -0.6, 2.0, 2.0])
    inside = (np.round(x.numpy()) >= 0) & (np.round(x.numpy()) < W) & \
        (np.round(y.numpy()) >= 0) & (np.round(y.numpy()) < H)
    ph = PhotonBatch.zeros(x.numel(), device="cpu").replace(
        x=x, y=y, flux=torch.ones_like(x))
    trace.enable()
    with trace.span("ccd", ccd="R01_S00"):
        img = accumulate(ph, torch.zeros((H, W)))
        accumulate(ph, img)
    got = {}
    for c in trace.counters():
        assert c["ccd"] == "R01_S00"
        got[c["name"]] = got.get(c["name"], 0) + c["value"]
    assert got == {"sensor.binned": 2 * x.numel(),
                   "sensor.off_frame": 2 * int((~inside).sum()),
                   "sensor.nonunit": 0}
    assert float(img.sum()) == 2 * int(inside.sum())


def test_profiler_turns_tracing_on_and_shares_its_clock():
    from torch.profiler import ProfilerActivity, profile

    def other():
        with trace.span("other.span"):
            torch.ones(8).sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.on()
        with trace.span("warm.span"):     # the first annotation's set-up
            pass
        with trace.span("main.span", ccd="R22_S11"):
            torch.ones(8).sum()
        th = threading.Thread(target=other)
        th.start()
        th.join(30)
        assert not th.is_alive()
    assert not trace.on()
    sp = {s["name"]: s for s in trace.spans()}
    assert set(sp) == {"warm.span", "main.span", "other.span"}
    assert sp["other.span"]["thread"] != sp["main.span"]["thread"]
    ev = [e for e in harness.kineto_events(prof) if e[0] == "main.span"]
    assert len(ev) == 1
    assert abs(ev[0][1] * 1e3 - sp["main.span"]["start_ns"]) < 1e6
    # the profiler records no annotation of another thread
    assert not [e for e in harness.kineto_events(prof)
                if e[0] == "other.span"]


@pytest.fixture(scope="module")
def traced_visit(catalog, tmp_path_factory):
    """Two CCDs through the CLI with the prefetch thread and one IO
    worker, traced to a Chrome-trace file: (events, the store's spans)."""
    d = tmp_path_factory.mktemp("visit")
    path = str(d / "trace.json")
    trace.reset()
    user = d / "user.yaml"
    user.write_text("template: imsim-config-instcat\n")
    CLI.main(["-q", "--device", "cpu", "--trace", path, str(user)]
             + _over(catalog, d / "out", "output.det_num=[93, 94]",
                     "image.nobjects=3", "image.sky_level=0",
                     "output.io_workers=1"))
    sp = trace.spans()
    trace.reset()
    with open(path) as f:
        return json.load(f), sp


def test_visit_threads_are_linked_by_ccd(traced_visit):
    _, sp = traced_visit
    main = threading.current_thread().name
    by = {}
    for s in sp:
        by.setdefault(s["name"], []).append(s)
    dets = {"R22_S10", "R22_S11"}
    for name in ("visit.wait_prep", "prep", "ccd", "ccd.pull", "io.write"):
        assert {s["ccd"] for s in by[name]} == dets, name
    assert {s["thread"] for s in by["visit.wait_prep"]} == {main}
    assert {s["thread"] for s in by["ccd"]} == {main}
    (prep_thread,) = {s["thread"] for s in by["prep"]}
    (io_thread,) = {s["thread"] for s in by["io.write"]}
    assert len({main, prep_thread, io_thread}) == 3
    assert all(s["parent"] is None for s in by["prep"] + by["io.write"]
               + by["ccd.pull"] + by["visit.wait_prep"])
    # each CCD is prepared before the render thread stops waiting for it
    for det in dets:
        (p,) = [s for s in by["prep"] if s["ccd"] == det]
        (w,) = [s for s in by["visit.wait_prep"] if s["ccd"] == det]
        (c,) = [s for s in by["ccd"] if s["ccd"] == det]
        assert p["end_ns"] <= w["end_ns"] <= c["start_ns"]
        assert {k["name"] for k in sp if k["parent"] == p["id"]} >= {
            "prep.wcs", "prep.cull", "prep.scene", "prep.state"}


def test_cli_writes_a_chrome_trace(traced_visit):
    doc, sp = traced_visit
    ev = doc["traceEvents"]
    x = [e for e in ev if e["ph"] == "X"]
    assert {"ccd", "prep", "io.write"} <= {e["name"] for e in x}
    assert len(x) == len(sp)
    first = min(sp, key=lambda s: s["start_ns"])
    assert min(e["ts"] for e in x) == pytest.approx(first["start_ns"] * 1e-3)
    threads = {e["tid"]: e["args"]["name"] for e in ev if e["ph"] == "M"}
    assert {threads[e["tid"]] for e in x if e["name"] == "ccd"} == {
        threading.current_thread().name}
    counters = [e for e in ev if e["ph"] == "C"]
    assert {e["name"] for e in counters} == {
        "sensor.binned", "sensor.off_frame", "sensor.nonunit"}


def _store(monkeypatch, spans, counters=()):
    """A hand-made store in the trace module's place."""
    full = []
    for i, (name, host_s, cpu_s, device_s) in enumerate(spans):
        full.append(dict(id=i + 1, name=name, parent=None, ccd="R22_S11",
                         thread="MainThread", tid=1, start_ns=0,
                         end_ns=int(host_s * 1e9), host_s=host_s,
                         cpu_s=cpu_s, device_s=device_s))
    monkeypatch.setattr(trace, "spans", lambda: full)
    monkeypatch.setattr(trace, "counters", lambda: [
        dict(name=n, value=v, ccd="R22_S11", thread="MainThread", tid=1,
             t_ns=0) for n, v in counters])


STORE = [("render.fft", 0.5, 0.1, 0.08), ("render.fft", 0.5, 0.1, 0.04),
         ("render.plan", 0.3, 0.1, 0.6),
         ("render.rows", 0.1, 0.1, 0.2), ("render.rows", 0.1, 0.1, 0.4),
         ("render.shoot", 0.2, 0.1, 0.9), ("render.sensor", 0.1, 0.1, 2.2),
         ("ccd.sky", 0.1, 0.1, 0.05), ("ccd.cosmic_rays", 0.1, 0.1, 0.01),
         ("ccd.readout", 0.1, 0.1, 0.1), ("ccd.render", 3.0, 1.0, 4.0),
         ("visit.wait_prep", 18.0, 0.001, None),
         ("visit.wait_prep", 6.0, 0.001, None),
         ("prep", 25.0, 20.0, None), ("prep", 24.0, 21.0, None),
         ("prep.scene", 17.0, 16.0, None)]


# each reader's number from STORE, over two CCDs
READINGS = [("fft_s.ccd", 0.06), ("objmap_s.ccd", 0.3), ("rows_s.ccd", 0.3),
            ("shoot_s.ccd", 0.45), ("sensor_s.ccd", 1.1),
            ("finish_s.ccd", 0.08), ("offframe_share.ccd", 9.0),
            ("prep_wait_s.visit", 12.0), ("prep_offcpu_s.visit", 4.0)]


@pytest.mark.parametrize("name,want", READINGS)
def test_metric_reads_a_hand_made_store(monkeypatch, name, want):
    _store(monkeypatch, STORE, [("sensor.binned", 6e7),
                                ("sensor.off_frame", 5.4e6),
                                ("sensor.binned", 4e7),
                                ("sensor.off_frame", 3.6e6)])
    got = harness.metric_reader(name)(dict(ccds=2))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", [n for n, _ in READINGS])
def test_metric_reads_none_without_its_spans(monkeypatch, name):
    # a run on the CPU (no device seconds) or a store with nothing to read
    _store(monkeypatch, [(n, h, c, None) for n, h, c, _ in STORE
                         if not n.startswith(("visit.", "prep"))])
    assert harness.metric_reader(name)(dict(ccds=2)) is None
