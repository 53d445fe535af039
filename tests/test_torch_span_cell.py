"""What ``tools/span_cell.py`` reads from a cell's spans and its traced
span, on hand-made spans and chrome-trace events: the set-up numbers
(``plan_pass_ms`` the union of the first frame's build spans,
``upload_ms``), the frame numbers (``route_host_us`` the mean of
``frame_tensor``'s self time, ``launch_host_us`` the wrapper spans over
the launches), and the traced span's (``idle_in_program_pct`` a part of
the idle share that ``benchmark/tracing.reduce`` computes from the CUDA
events alone, the idle gaps named by the innermost program span, and
the share of wrapper spans that enclose their own launch). No JAX.
"""

import importlib.util
import pathlib

import pytest

from benchmark import tracing as T

_SPEC = importlib.util.spec_from_file_location(
    "span_cell",
    pathlib.Path(__file__).resolve().parent.parent / "tools" / "span_cell.py")
sc = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(sc)


def _span(name, ts, dur, parent=-1, frame=-1):
    return dict(ph="X", cat="user_annotation", name=name, ts=ts, dur=dur,
                args=dict(parent=parent, frame=frame))


def _x(name, cat, ts, dur, corr=None):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur,
                args={} if corr is None else dict(correlation=corr))


def test_set_up_and_frame_numbers():
    setup = [
        _span("make_mount_source", 0.0, 50.0),
        _span("upload", 10.0, 20.0, parent=0),
        _span("frame_tensor", 60.0, 40.0, frame=1),
        _span("operands_build", 61.0, 9.0, parent=2, frame=1),
        _span("block_list_build", 70.0, 10.0, parent=2, frame=1),
        _span("chain_blocks", 72.0, 6.0, parent=4, frame=1),
        _span("champion_planes_build", 80.0, 15.0, parent=2, frame=1),
        _span("champion_planes", 81.0, 9.0, parent=6, frame=1),
        _span("resample_planar_chain", 95.0, 4.0, parent=2, frame=1),
        # a later frame's build is not the plan's first frame's
        _span("frame_tensor", 200.0, 30.0, frame=2),
        _span("operands_build", 201.0, 20.0, parent=9, frame=2),
    ]
    out = sc.set_up_numbers(setup)
    assert out["plan_pass_ms"] == pytest.approx(0.034)
    assert out["upload_ms"] == pytest.approx(0.020)
    assert out["make_mount_source_ms"] == pytest.approx(0.050)
    assert out["first_frame_tensor_ms"] == pytest.approx(0.040)
    assert out["first_frame_launches_ms"] == pytest.approx(0.004)
    frames = [
        _span("frame_tensor", 0.0, 46.0, frame=1),
        _span("resample_planar_chain", 8.0, 8.0, parent=0, frame=1),
        _span("resample_planar_chain", 35.0, 10.0, parent=0, frame=1),
        _span("frame_tensor", 100.0, 30.0, frame=2),
        _span("resample_inline", 110.0, 12.0, parent=3, frame=2),
    ]
    out = sc.frame_numbers(frames, launches=3)
    assert out["route_host_us"] == pytest.approx(0.5 * (28.0 + 18.0))
    assert out["launch_host_us"] == pytest.approx(10.0)
    assert out["frame_tensor_ms"] == pytest.approx(0.038)
    assert out["frames"] == 2


def test_trace_numbers_within_the_idle_share():
    """Device idle 100-106 inside a wrapper span, 140-141 between calls,
    160-200 in the wait: 6 of the 100 us window in the program, and the
    idle share is ``reduce``'s own over the same CUDA events."""
    events = [
        _x("cudaLaunchKernel", "cuda_runtime", 100.0, 5.0, corr=1),
        _x("void (anonymous namespace)::k1<3>", "kernel", 106.0, 34.0,
           corr=1),
        _x("cudaLaunchKernel", "cuda_runtime", 130.0, 4.0, corr=2),
        _x("void (anonymous namespace)::k1<3>", "kernel", 141.0, 19.0,
           corr=2),
        _x("cudaEventSynchronize", "cuda_runtime", 150.0, 50.0),
    ]
    spans = [
        _span("frame_tensor", 90.0, 46.0, frame=1),
        _span("resample_planar_chain", 98.0, 8.0, parent=0, frame=1),
        _span("resample_planar_chain", 125.0, 10.0, parent=0, frame=1),
    ]
    out = sc.trace_numbers(events, spans)
    assert out["idle_in_program_pct"] == pytest.approx(6.0)
    red = T.reduce(events, frames=1)
    idle_pct = 100.0 * (1.0 - red["busy_s"] / red["window_s"])
    assert idle_pct == pytest.approx(47.0)
    gaps = dict(out["idle_gaps"])
    assert gaps == pytest.approx({"span resample_planar_chain": 6e-6,
                                  "no recorded host call": 1e-6,
                                  "cudaEventSynchronize": 40e-6})
    assert sum(gaps.values()) == pytest.approx(red["window_s"]
                                               - red["busy_s"])
    assert out["enclosed"] == 1.0 and out["wrapper_spans"] == 2
    late = [dict(spans[2], ts=131.0)]
    assert sc.trace_numbers(events, spans[:2] + late)["enclosed"] == 0.5
