"""Run one cell of the benchmark with the program's spans recording, and
read what they say.

    python3 tools/span_cell.py --workload <cell> --seed <n> \\
        --seconds <s> [--cost_frames <n>]

from the repository's root, on a CUDA card (``--tiny`` runs the
benchmark's tiny CPU cells instead, to rehearse). It runs the cell as
``benchmark/run.py --trace 1`` does, through ``benchmark/harness
.run_cell`` unchanged, with three of the harness's module functions
wrapped for the run:

- ``job.build``: recording (``envutil_tpu_torch.runtime.spans``) starts
  before the sources are built, so set-up's spans hold the sources, the
  plan's first frame (frame 1) and the warm frames;
- ``frames_in_flight``: recording stops before the measured window,
  which runs with spans off as in every run of the benchmark, and is on
  for the traced span's frames, bracketed by ``spans.mark_clock``;
- ``tracing.reduce``: the trace's events with the clock's marks taken
  out go to the harness's ``reduce`` as they are, so every number of
  the result line comes from the CUDA events alone; the spans are
  aligned to the trace (``spans.clock_offset``) and read beside them.

Standard output carries the harness's result line, then ``spans:`` and
one JSON object: the per-layer numbers the spans give (``route_host_us``,
``launch_host_us``, ``idle_in_program_pct``, ``plan_pass_ms``,
``upload_ms``), their checks (the mean ``frame_tensor`` span of the
traced frames against ``enqueue_ms`` of the window, ``plan_pass_ms``
against ``first_frame_ms``, ``upload_ms`` against ``source_build_ms``,
``dropped``, the share of wrapper spans that enclose their own
``cudaLaunchKernel`` and ``span_clock_error_us``), the traced span's
idle gaps named by the innermost program span open at their middle,
and, with ``--cost_frames``, what recording costs a frame: blocks of
that many frames with spans off and on in turns after the check.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the checkout's own program and harness, whatever else is installed
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import harness as H  # noqa: E402
from benchmark import job as J  # noqa: E402
from benchmark import tracing as T  # noqa: E402
from envutil_tpu_torch.ops import resample as R  # noqa: E402
from envutil_tpu_torch.runtime import fastpath as FP  # noqa: E402
from envutil_tpu_torch.runtime import spans as SP  # noqa: E402

WRAPPERS = frozenset(name for name, fn in vars(R).items() if callable(fn)
                     and isinstance(getattr(fn, "launches", None), int))
BUILDS = ("operands_build", "block_list_build", "champion_planes_build")
MARKS = ("cudaDeviceSynchronize", SP.MARK_NAME)
# the port's kernels live in anonymous namespaces (csrc/*.cu)
OWN_KERNEL = "anonymous namespace"


def _length(intervals):
    return sum(e - s for s, e in intervals)


def _overlap(a, b):
    """The length of the intersection of two unions of intervals."""
    out, j = 0.0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            out += max(0.0, min(e, b[k][1]) - max(s, b[k][0]))
            k += 1
    return out


def _interval(ev):
    return float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0))


def _opened(intervals):
    """(start, end, name) sorted by start, with the starts apart."""
    intervals.sort(key=lambda x: x[0])
    return [x[0] for x in intervals], intervals


def _innermost(opened, t):
    """The name of the latest-opened interval that holds ``t``; a
    frame's spans and calls are a few dozen, so look back that far."""
    starts, intervals = opened
    at = bisect.bisect_right(starts, t)
    for s, e, name in reversed(intervals[max(0, at - T.HOST_LOOKBACK):at]):
        if e > t:
            return name
    return None


def set_up_numbers(spans):
    """plan_pass_ms (the union of the build spans in the plan's first
    frame: a build nested in another counts once), upload_ms (every
    source's upload), the sources' whole spans, and the first frame's
    span with the part of it in the wrapper spans outside the builds
    (its launches), from set-up's spans."""
    first = [_interval(e) for e in spans
             if e["args"]["frame"] == 1 and e["name"] in BUILDS]
    top = next((i for i, e in enumerate(spans)
                if e["name"] == "frame_tensor"), None)
    return dict(
        plan_pass_ms=_length(T._union(first)) * 1e-3,
        upload_ms=sum(e["dur"] for e in spans if e["name"] == "upload")
        * 1e-3,
        make_mount_source_ms=sum(e["dur"] for e in spans
                                 if e["name"] == "make_mount_source") * 1e-3,
        first_frame_tensor_ms=None if top is None
        else spans[top]["dur"] * 1e-3,
        first_frame_launches_ms=sum(
            e["dur"] for e in spans
            if e["name"] in WRAPPERS and e["args"]["parent"] == top) * 1e-3)


def frame_numbers(spans, launches):
    """route_host_us (the mean over frames of ``frame_tensor``'s self
    time: its span less its wrapper children), launch_host_us (the
    wrapper spans' time over ``launches``) and the mean frame_tensor
    span, from the traced frames' spans."""
    frames = [i for i, e in enumerate(spans) if e["name"] == "frame_tensor"]
    kids = {}
    for e in spans:
        if e["name"] in WRAPPERS and e["args"]["parent"] >= 0:
            kids[e["args"]["parent"]] = kids.get(e["args"]["parent"], 0.0) \
                + e["dur"]
    wrapped = sum(e["dur"] for e in spans if e["name"] in WRAPPERS)
    if not frames:
        return dict(route_host_us=None, launch_host_us=None,
                    frame_tensor_ms=None, frames=0)
    return dict(
        route_host_us=statistics.fmean(spans[i]["dur"] - kids.get(i, 0.0)
                                       for i in frames),
        launch_host_us=wrapped / launches if launches else None,
        frame_tensor_ms=statistics.fmean(spans[i]["dur"]
                                         for i in frames) * 1e-3,
        frames=len(frames))


def trace_numbers(events, spans):
    """From the traced span's CUDA events (the clock's marks taken out)
    and the aligned spans: idle_in_program_pct, the idle gaps named by
    the innermost program span open at their middle (else by the
    innermost CUDA call, as ``tracing.reduce`` names them), and the
    share of wrapper spans that enclose their own launch of the port's
    kernel (the k-th such launch in the k-th wrapper span)."""
    dev = [_interval(e) for e in events if T._is_device(e)]
    host = [e for e in events if e.get("ph") == "X"
            and str(e.get("cat", "")).lower() in T.HOST_CATS
            and not str(e.get("name", "")).startswith("ProfilerStep")]
    out = dict(idle_in_program_pct=None, idle_gaps=[], enclosed=None,
               wrapper_spans=0, own_launches=0)
    if not dev or not host:
        return out
    t0 = min(float(e["ts"]) for e in host)
    t1 = max([e for _s, e in dev] + [_interval(e)[1] for e in host])
    busy = T._union([(max(s, t0), min(e, t1)) for s, e in dev if e > t0])
    idle, prev = [], t0
    for s, e in busy + [[t1, t1]]:
        if s > prev:
            idle.append([prev, s])
        prev = max(prev, e)
    prog = T._union([(max(s, t0), min(e, t1)) for s, e in map(_interval, spans)
                   if e > t0 and s < t1])
    out["idle_in_program_pct"] = 100.0 * _overlap(idle, prog) / (t1 - t0)
    named = _opened([(*_interval(e), f"span {e['name']}") for e in spans])
    calls = _opened([(*_interval(e), e["name"]) for e in host])
    gaps = {}
    for s, e in idle:
        mid = 0.5 * (s + e)
        what = _innermost(named, mid) or _innermost(calls, mid) \
            or "no recorded host call"
        gaps[what] = gaps.get(what, 0.0) + (e - s) * 1e-6
    out["idle_gaps"] = [[n, v] for n, v in sorted(
        gaps.items(), key=lambda kv: -kv[1])[:10]]
    own = {e["args"].get("correlation") for e in events
           if T._is_device(e) and OWN_KERNEL in str(e.get("name", ""))}
    launches = sorted(_interval(e) for e in host
                      if e["name"] == "cudaLaunchKernel"
                      and e.get("args", {}).get("correlation") in own)
    wrappers = sorted(_interval(e) for e in spans if e["name"] in WRAPPERS)
    out.update(wrapper_spans=len(wrappers), own_launches=len(launches))
    if wrappers and len(wrappers) == len(launches):
        out["enclosed"] = sum(a <= s and e <= b for (a, b), (s, e)
                              in zip(wrappers, launches)) / len(wrappers)
    return out


class SpanRun:
    """The wrapped harness functions of one run and what they kept."""

    def __init__(self):
        self.calls = 0
        self.setup = []
        self.traced = []
        self.events = []
        self.launches = 0
        self.clock = None
        self.dropped = 0
        self.job = None
        self.traced_enqueue_ms = []
        self._build, self._frames, self._reduce = \
            J.build, H.frames_in_flight, T.reduce

    def __enter__(self):
        J.build, H.frames_in_flight, T.reduce = \
            self.build, self.frames, self.reduce
        return self

    def __exit__(self, *exc):
        J.build, H.frames_in_flight, T.reduce = \
            self._build, self._frames, self._reduce
        SP.disable()

    def build(self, *a, **kw):
        SP.enable()
        self.job = self._build(*a, **kw)
        return self.job

    def frames(self, render, device, **kw):
        # run_cell's calls: the warm frames, the measured window, then
        # the traced span's warm-up and its traced frames
        self.calls += 1
        if self.calls == 2:
            SP.disable()
            self.setup = SP.drain()
        if self.calls != 4:
            return self._frames(render, device, **kw)
        SP.mark_clock(device)
        n = H.launches()
        SP.enable()
        out = self._frames(render, device, **kw)
        SP.disable()
        self.launches = H.launches() - n
        SP.mark_clock(device)
        self.traced_enqueue_ms = out[0]["enqueue_ms"]
        return out

    def reduce(self, events, frames):
        self.clock = SP.clock_offset(events)
        self.dropped = SP.dropped
        self.traced = SP.drain(self.clock[0] if self.clock else 0.0)
        self.events = [e for e in events if e.get("name") not in MARKS]
        return self._reduce(self.events, frames)


def _site():
    """One span site, as the program's."""
    s = SP.begin("site") if SP.on else -1
    try:
        pass
    finally:
        if s >= 0:
            SP.end(s)


def _bare():
    pass


def site_ns(calls=20000, rounds=5):
    """ns of one span site over a call of an empty function, with
    recording off and on (a begin and an end): the least of ``rounds``
    loops of ``calls``."""
    def loop(fn):
        t = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        return (time.perf_counter_ns() - t) / calls
    out = {}
    for state in ("off", "on"):
        best = float("inf")
        for _ in range(rounds):
            if state == "on":
                SP.enable()
            best = min(best, loop(_site) - loop(_bare))
            SP.disable()
            SP.drain()
        out[state] = best
    return out


def cost(render, device, frames, depth, blocks=6):
    """What recording costs a frame, with no profiler running: the
    site's ns off and on (``site_ns``), and ``blocks`` blocks of
    ``frames`` frames with spans off and on in turns (off first): each
    block's mean enqueue ms, and each on block's ``frame_numbers``
    (``frame_tensor``'s mean span, its self time, a wrapper call); the
    ratios of the on blocks' medians (enqueue, span) to the off blocks'
    enqueue."""
    off, on, per_block, spans = [], [], [], 0
    for b in range(2 * blocks):
        n = H.launches()
        if b % 2:
            SP.enable()
        rec, _h, _l = H.frames_in_flight(render, device, frames=frames,
                                         depth=depth)
        SP.disable()
        kept = SP.drain()
        spans = max(spans, len(kept))
        (on if b % 2 else off).append(statistics.fmean(rec["enqueue_ms"]))
        if b % 2:
            per_block.append(frame_numbers(kept, H.launches() - n))
    base = statistics.median(off)
    out = dict(site_ns=site_ns(), spans_per_frame=spans / frames,
               enqueue_ms_off=off, enqueue_ms_on=on,
               on_over_off=statistics.median(on) / base)
    for key in ("frame_tensor_ms", "route_host_us", "launch_host_us"):
        out[f"{key}_on"] = [x[key] for x in per_block]
    out["span_over_off"] = statistics.median(out["frame_tensor_ms_on"]) \
        / base
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--cost_frames", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="the benchmark's tiny CPU cells (a rehearsal)")
    ns = ap.parse_args(argv)

    def say(*a):
        print(*a, file=sys.stderr, flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        if ns.tiny:
            from benchmark.tests import tiny
            base, spec = tiny.tree(tmp)
            device = "cpu"
        else:
            base, spec, device = H.HERE, H.load_spec(ROOT), "cuda"
            if not torch.cuda.is_available():
                say("refused: no CUDA device")
                return 3
        with SpanRun() as sr:
            run, res = H.run_cell(spec, ns.workload, ns.seed, ns.seconds,
                                  True, device, T_START, base=base, log=say)
        print(json.dumps(res), flush=True)
        out = dict(workload=ns.workload, seed=ns.seed,
                   device=res["device"]["kind"])
        out.update(set_up_numbers(sr.setup))
        out.update(frame_numbers(sr.traced, sr.launches))
        out.update(trace_numbers(sr.events, sr.traced))
        out.update(
            launches=sr.launches, dropped=sr.dropped,
            span_clock_error_us=sr.clock[1] if sr.clock else None,
            enqueue_ms=statistics.fmean(run.window["enqueue_ms"]),
            traced_enqueue_ms=statistics.fmean(sr.traced_enqueue_ms)
            if sr.traced_enqueue_ms else None,
            first_frame_ms=run.setup["first_frame_ms"],
            source_build_ms=run.setup["source_build_ms"],
            correct=res["correct"])
        if ns.cost_frames:
            traffic = H.data("traffic", run.cell["traffic"], base)
            _args, sources, plan, _ms = sr.job
            out["cost"] = cost(lambda: FP.frame_tensor(plan, sources),
                               torch.device(device), ns.cost_frames,
                               traffic["in_flight"])
        print("spans: " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
