"""The span recorder (``runtime/spans``) and its sites: off it records
nothing; on, spans nest with their parent's index and their frame's
number, the buffer holds ``CAPACITY`` spans and counts the rest in
``dropped``, and ``drain`` exports chrome-trace "X" events. A tiny
voronoi stitch through ``fastpath.frame_tensor`` on the CPU makes one
``frame_tensor`` span a frame with one wrapper span a launch, the
per-plan builds only in the plan's first frame, and
``make_mount_source`` with its ``upload``; on a ``torch.profiler``
trace of the CPU, after ``clock_offset``'s alignment, the plain path's
``aten::`` operations fall inside their wrapper's span. On a card, each
wrapper span encloses its own ``cudaLaunchKernel``.

No JAX, so that the card test runs where JAX is not installed
(``python3 -m pytest --noconftest -p no:cacheprovider
tests/test_torch_spans.py -m cuda``).
"""

import json

import pytest
import torch

from envutil_tpu_torch.core.conventions import Projection as TP
from envutil_tpu_torch.ops import resample as R
from envutil_tpu_torch.runtime import fastpath as FP
from envutil_tpu_torch.runtime import spans as SP

from test_torch_compact import facet, plan_of, source

torch.set_num_threads(1)

WRAPPERS = {name for name, fn in vars(R).items()
            if callable(fn) and isinstance(getattr(fn, "launches", None),
                                           int)}
BUILDS = ("operands_build", "block_list_build", "champion_planes_build")


@pytest.fixture(autouse=True)
def _recorder():
    """Each test starts and ends with recording off and nothing kept."""
    SP.disable()
    SP._open.clear()
    SP.drain()
    SP.dropped = 0
    yield
    SP.disable()
    SP._open.clear()
    SP.drain()
    SP.dropped = 0


def _stitch(device="cpu"):
    """Three 64x48 rectilinear facets stitched (voronoi) into a 96x48
    equirect: its plan and the facets' sources."""
    fs = [facet(TP.RECTILINEAR, 64, 48, 70.0, no=i, yaw=y)
          for i, y in enumerate((-0.6, 0.0, 0.6))]
    return plan_of(fs, TP.SPHERICAL, 96, 48, 360.0), \
        [source(f, device) for f in fs]


def _by_name(events, name):
    return [e for e in events if e["name"] == name]


def test_off_records_nothing():
    plan, srcs = _stitch()
    FP.frame_tensor(plan, srcs)
    assert not SP.on and SP.drain() == [] and SP.dropped == 0


def test_nesting_parents_and_frames():
    outside = SP.begin("make_mount_source")
    SP.end(outside)
    f1 = SP.begin("frame_tensor", frame=True)
    a = SP.begin("resample_planar_chain")
    SP.end(a)
    b = SP.begin("champion_planes_build")
    c = SP.begin("chain_blocks")
    SP.end(c)
    SP.end(b)
    SP.end(f1)
    f2 = SP.begin("frame_tensor", frame=True)
    d = SP.begin("resample_twined_chain")
    # an end skipped by an exception inside a span: its parent's end
    # closes it on the stack
    SP.end(f2)
    ev = SP.drain()
    assert [e["name"] for e in ev] == [
        "make_mount_source", "frame_tensor", "resample_planar_chain",
        "champion_planes_build", "chain_blocks", "frame_tensor",
        "resample_twined_chain"]
    assert [e["args"]["parent"] for e in ev] == [-1, -1, f1, f1, b, -1, f2]
    assert [e["args"]["frame"] for e in ev] == [-1, 1, 1, 1, 1, 2, 2]
    assert d == 6 and SP._open == []
    e = SP.begin("frame_tensor", frame=True)
    with pytest.raises(RuntimeError):
        SP.drain()
    SP.end(e)
    assert SP.drain()[0]["args"]["frame"] == 1


def test_buffer_bound_counts_dropped(monkeypatch):
    monkeypatch.setattr(SP, "CAPACITY", 4)
    got = []
    for _ in range(6):
        i = SP.begin("resample_inline")
        got.append(i)
        if i >= 0:
            SP.end(i)
    assert got == [0, 1, 2, 3, -1, -1] and SP.dropped == 2
    assert len(SP.drain()) == 4
    assert SP.begin("resample_inline") == 0
    SP.end(0)


def test_chrome_export():
    i = SP.begin("frame_tensor", frame=True)
    SP.end(i)
    t0, t1 = SP._spans[0][1:3]
    ev, = SP.drain(offset_us=-1000.0)
    assert ev["ph"] == "X" and ev["cat"] == "user_annotation"
    assert ev["ts"] == pytest.approx(t0 * 1e-3 - 1000.0, abs=1e-3)
    assert ev["dur"] == pytest.approx((t1 - t0) * 1e-3, abs=1e-3)
    assert ev["args"] == dict(parent=-1, frame=1)
    assert json.loads(json.dumps([ev])) == [ev]


def test_frame_tensor_spans_per_frame_and_plan():
    """The plan's first frame holds its builds; the second frame is one
    ``frame_tensor`` span whose children are one wrapper span a facet's
    launch; the sources' spans hold their upload."""
    fs = [facet(TP.RECTILINEAR, 64, 48, 70.0, no=i, yaw=y)
          for i, y in enumerate((-0.6, 0.0, 0.6))]
    SP.enable()
    srcs = [source(f) for f in fs]
    plan = plan_of(fs, TP.SPHERICAL, 96, 48, 360.0)
    FP.frame_tensor(plan, srcs)
    log = []
    FP.frame_tensor(plan, srcs)
    FP.stitch_frame(plan, srcs, log=log)
    SP.disable()
    ev = SP.drain()
    made = _by_name(ev, "make_mount_source")
    assert len(made) == 3
    for e in _by_name(ev, "upload"):
        assert ev[e["args"]["parent"]]["name"] == "make_mount_source"
    assert len(_by_name(ev, "upload")) == 3
    frames = _by_name(ev, "frame_tensor")
    assert [e["args"]["frame"] for e in frames] == [1, 2]
    first = [e for e in ev if e["args"]["frame"] == 1]
    assert len(_by_name(first, "champion_planes_build")) == 1
    assert {e["name"] for e in first} >= set(BUILDS)
    second = [e for e in ev if e["args"]["frame"] == 2]
    top = ev.index(frames[1])
    kids = [e for e in second if e["args"]["parent"] == top]
    assert len(second) == 1 + len(kids)
    assert all(e["name"] in WRAPPERS for e in kids)
    assert len(kids) == sum(w is not None for w in log) == 3
    for e in kids:
        assert frames[1]["ts"] <= e["ts"] and e["ts"] + e["dur"] <= \
            frames[1]["ts"] + frames[1]["dur"]


def _events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    return data.get("traceEvents", data) if isinstance(data, dict) \
        else data


def test_aligned_spans_hold_their_aten_ops(tmp_path):
    """On a CPU trace, after alignment, every top-level ``aten::`` op
    that overlaps a wrapper span lies inside it, and each wrapper span
    holds one."""
    from torch.profiler import ProfilerActivity, profile
    plan, srcs = _stitch()
    FP.frame_tensor(plan, srcs)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        SP.enable()
        SP.mark_clock("cpu")
        FP.frame_tensor(plan, srcs)
        SP.mark_clock("cpu")
        SP.disable()
    events = _events(prof, tmp_path)
    offset, err = SP.clock_offset(events)
    assert err < 50.0
    # another event of the marked call, as a profiler's own, is passed by
    stray = dict(ph="X", name=SP.MARK_NAME, ts=min(
        e["ts"] for e in events if e.get("ph") == "X") - 500.0, dur=1.0)
    assert SP.clock_offset([stray] + events) == (offset, err)
    spans = [e for e in SP.drain(offset) if e["name"] in WRAPPERS]
    assert len(spans) == 3
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events if e.get("ph") == "X"
                 and str(e.get("name", "")).startswith("aten::"))
    top, end = [], float("-inf")
    for s, e in ops:
        if s >= end:
            top.append((s, e))
            end = e
    for sp in spans:
        a, b = sp["ts"], sp["ts"] + sp["dur"]
        inside = [(s, e) for s, e in top if s < b and e > a]
        assert inside
        for s, e in inside:
            assert a - err <= s and e <= b + err


@pytest.mark.cuda
def test_wrapper_spans_enclose_their_launches_on_card(tmp_path):
    """On a card: a frame's wrapper spans are as many as the launches
    its counters count, and after alignment each encloses its own
    ``cudaLaunchKernel`` (the launch of the port's kernel, in order)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    from torch.profiler import ProfilerActivity, profile
    R.build()
    plan, srcs = _stitch("cuda")
    FP.frame_tensor(plan, srcs)
    torch.cuda.synchronize()
    before = sum(getattr(R, n).launches for n in WRAPPERS)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        SP.enable()
        SP.mark_clock("cuda")
        for _ in range(4):
            FP.frame_tensor(plan, srcs)
        torch.cuda.synchronize()
        SP.mark_clock("cuda")
        SP.disable()
    launched = sum(getattr(R, n).launches for n in WRAPPERS) - before
    events = _events(prof, tmp_path)
    offset, err = SP.clock_offset(events)
    spans = sorted((e for e in SP.drain(offset) if e["name"] in WRAPPERS),
                   key=lambda e: e["ts"])
    assert len(spans) == launched == 12
    kernels = {e["args"].get("correlation") for e in events
               if e.get("cat") == "kernel"
               and "anonymous namespace" in e.get("name", "")}
    calls = sorted((e for e in events if e.get("name") == "cudaLaunchKernel"
                    and e["args"].get("correlation") in kernels),
                   key=lambda e: e["ts"])
    assert len(calls) == launched
    for sp, call in zip(spans, calls):
        assert sp["ts"] <= call["ts"]
        assert call["ts"] + call["dur"] <= sp["ts"] + sp["dur"]
    assert err < 50.0
