"""Tiny cells for the CPU tests: the shapes of the real configurations
and traffic at a few hundred pixels, written as a cell's own files into
a copy of the benchmark's tree."""

import json
import pathlib
import shutil

BENCH = pathlib.Path(__file__).resolve().parent.parent

IMAGE = {"sigma_px": 2.0, "mean": 0.5, "std": 0.25}
CONFIGS = {
    "eq_tiny": dict(
        name="eq_tiny", degree=3, prefilter=3, synopsis="panorama",
        coeff="f32", image=IMAGE, facets=[dict(
            projection="spherical", width=128, height=64, hfov=360.0,
            channels=3)]),
    "ring_tiny": dict(
        name="ring_tiny", degree=3, prefilter=3, synopsis="panorama",
        coeff="f32", image=IMAGE, facets=[dict(
            projection="rectilinear", width=96, height=72, hfov=72.0,
            yaw=60.0 * i, a=0.01, b=-0.02, c=0.005, channels=3)
            for i in range(6)]),
}
TRAFFIC = {
    "cube_tiny": dict(projection="cubemap", width=32, height=192, hfov=90.0,
                      twine=0),
    "view_tiny": dict(projection="rectilinear", width=64, height=40,
                      hfov=100.0, yaw=30.0, pitch=10.0, twine=-1),
    "pano_tiny": dict(projection="spherical", width=512, height=256,
                      hfov=360.0, twine=0),
    "pano2_tiny": dict(projection="spherical", width=512, height=256,
                       hfov=360.0, twine=2),
}
for t in TRAFFIC.values():
    t.update(in_flight=2, warm_frames=2, traced_frames=4)
# each tiny cell reports the metrics of the real cell it shrinks
TWIN = {"eq_tiny.cube": "equirect8k.cubemap",
        "eq_tiny.view": "equirect8k.view_twined",
        "ring_tiny.pano": "ring6_lens.pano",
        "ring_tiny.pano2": "ring6_lens.pano_twined"}
# (config, traffic); the limits are the real cells' kind of numbers at
# this size: the CPU's plain versions read 1e-6..2e-6 (twined stitch:
# 6e-4 at the edges of this small a facet), the bf16 control 3e-3..1e-2
CELLS = {
    "eq_tiny.cube": ("eq_tiny", "cube_tiny", 1e-4, 2e-5),
    "eq_tiny.view": ("eq_tiny", "view_tiny", 1e-4, 2e-5),
    "ring_tiny.pano": ("ring_tiny", "pano_tiny", 1e-4, 2e-5),
    "ring_tiny.pano2": ("ring_tiny", "pano2_tiny", 2e-3, 1e-4),
}


def tree(tmp, spec_path=BENCH.parent / "BENCHMARK.json"):
    """A copy of the benchmark's tree under ``tmp`` with the tiny cells'
    files added; returns (base, spec) where spec is BENCHMARK.json with
    the tiny cells added beside the real ones."""
    base = pathlib.Path(tmp) / "benchmark"
    shutil.copytree(BENCH, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    spec = json.loads(pathlib.Path(spec_path).read_text())
    for name, cfg in CONFIGS.items():
        (base / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, t in TRAFFIC.items():
        (base / "traffic" / f"{name}.json").write_text(json.dumps(t))
    for name, (cfg, traffic, max_gap, rms_gap) in CELLS.items():
        spec["workloads"].append(dict(name=name, config=cfg,
                                      traffic=traffic, chips=1, why="tiny"))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if TWIN[name] in m.get("workloads", ()):
                m["workloads"].append(name)
        (base / "limits" / f"{name}.json").write_text(json.dumps(
            dict(max_gap=max_gap, rms_gap=rms_gap)))
    return base, spec
