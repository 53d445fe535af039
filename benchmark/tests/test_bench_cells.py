"""A cell's files are found by name; a cell is added by new files
alone; the result line has its fixed keys, in order."""

import json
import time

import pytest
import torch

from benchmark import harness as H
from benchmark.tests import tiny

KEYS = ("correct", "attempted", "failed", "metrics", "device", "checks")


def test_every_cell_finds_its_files():
    spec = H.load_spec()
    names = {c["name"] for c in spec["configs"]}
    for cell in spec["workloads"]:
        assert cell["config"] in names
        config = H.data("configs", cell["config"])
        assert config["name"] == cell["config"]
        traffic = H.data("traffic", cell["traffic"])
        assert traffic["in_flight"] >= 1
        limits = H.data("limits", cell["name"])
        assert set(limits) >= {"max_gap", "rms_gap"}
        for trace in (0, 1):
            for m in H.cell_metrics(spec, cell["name"], trace):
                assert H.module("metrics", m["name"]) is not None, m["name"]
    for c in spec["configs"]:
        cfg = json.loads((H.ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_metrics_per_cell():
    spec = H.load_spec()
    e2e = [m["name"] for m in H.cell_metrics(spec, "equirect8k.cubemap", 0)]
    assert e2e == ["mpix_s", "frame_ms_p95", "peak_mem_mib", "setup_s"]
    # the host-paced stitch reports no rate, and so none of the metrics
    # that move it
    e2e = [m["name"] for m in H.cell_metrics(spec, "ring6_lens.pano", 0)]
    assert e2e == ["peak_mem_mib", "setup_s"]
    layer = [m["name"] for m in H.cell_metrics(spec, "ring6_lens.pano", 1)]
    assert layer == ["source_build_ms", "first_frame_ms"]
    # one file a metric: a reader for each, a count where it has one
    assert H.module("counts", "frame_roofline") is not None
    assert H.module("counts", "enqueue_ms") is None
    with pytest.raises(H.Refused):
        H.find_cell(spec, "no.such_cell")


def test_a_cell_from_new_files_alone(tmp_path):
    """The tiny cells exist only as new files (configuration, traffic,
    limits) and new entries; the harness runs them untouched."""
    base, spec = tiny.tree(tmp_path)
    before = {p.relative_to(H.HERE): p.read_bytes()
              for p in H.HERE.rglob("*") if p.is_file()
              and "tests" not in p.parts and "__pycache__" not in p.parts}
    run, res = H.run_cell(spec, "eq_tiny.cube", 12345678912345, 0.2, False,
                          "cpu", time.perf_counter(), base=base,
                          log=lambda *a: None)
    for rel, blob in before.items():
        assert (base / rel).read_bytes() == blob, rel
    assert tuple(res) == KEYS
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] == run.window["frames"] >= 1
    assert set(res["metrics"]) <= {"mpix_s", "frame_ms_p95", "setup_s"}
    assert {"mpix_s", "setup_s"} <= set(res["metrics"])
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == {"max_gap", "rms_gap"}


@pytest.mark.parametrize("cell, rate", [("eq_tiny.view", True),
                                        ("ring_tiny.pano", False)])
def test_traced_line(tmp_path, cell, rate):
    base, spec = tiny.tree(tmp_path)
    _run, res = H.run_cell(spec, cell, 2 ** 40 + 7, 0.2, True,
                           "cpu", time.perf_counter(), base=base,
                           log=lambda *a: None)
    assert list(res)[-1] == "checks"
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert {"source_build_ms", "first_frame_ms"} <= set(res["metrics"])
    assert ({"enqueue_ms", "launches_per_frame"} <= set(res["metrics"])) \
        is rate
    assert "mpix_s" not in res["metrics"]


def test_frame_latency_runs_from_call_to_completion():
    def render():
        time.sleep(0.002)
        return torch.zeros(4, 6, 3)

    rec, held, last = H.frames_in_flight(render, torch.device("cpu"),
                                         frames=5, depth=2, hold_at=0.0)
    assert rec["frames"] == len(rec["latency_ms"]) == 5
    assert rec["pixels"] == 24 and held is not None and last is not None
    assert min(rec["latency_ms"]) >= 2.0
    assert all(lat >= enq for lat, enq in zip(rec["latency_ms"],
                                              rec["enqueue_ms"]))
