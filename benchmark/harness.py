"""One run of one cell: set-up, the measured window, the traced span, the
check against the reference, and the result line.

Everything that belongs to one cell is found by name from its entry in
``BENCHMARK.json``: the configuration ``configs/<config>.json``, the
traffic ``traffic/<traffic>.json``, the limits of its check
``limits/<cell>.json``, each metric's reader ``metrics/<metric>.py`` and,
where one exists, its count ``counts/<metric>.py``. A reader is a module
with ``read(run) -> float | None`` over the run's record (``Run``); a
count is a module with ``count(work) -> dict`` over the reference's
``work``, stored in ``run.counts[<metric>]`` before the readers run.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import importlib.util
import json
import pathlib
import random
import subprocess
import sys
import time

import torch

from . import check
from . import job as J
from . import tracing

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level modules that no run may load: JAX and the JAX package that
# the measured port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "envutil_tpu")


class Refused(Exception):
    """The run cannot report: its exit code and message."""

    def __init__(self, code, message):
        super().__init__(message)
        self.code = code


# ---------------------------------------------------------------------------
# the cell and its files
# ---------------------------------------------------------------------------

def load_spec(root=ROOT):
    return json.loads((pathlib.Path(root) / "BENCHMARK.json").read_text())


def find_cell(spec, name):
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise Refused(2, f"no workload named {name!r} in BENCHMARK.json")


def _applies(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def cell_metrics(spec, cell_name, trace):
    """The metrics a run of the cell reports: its end-to-end metrics, or
    with ``trace`` its per-layer metrics."""
    e2e = [m for m in spec["end_to_end"] if _applies(m, cell_name)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if _applies(m, cell_name) and m["moves"] in moved]


def data(kind, name, base=HERE):
    path = pathlib.Path(base) / kind / f"{name}.json"
    if not path.exists():
        raise Refused(2, f"missing {kind}/{name}.json")
    return json.loads(path.read_text())


def module(kind, name, base=HERE):
    """``<base>/<kind>/<name>.py`` as a module, or None where there is
    none."""
    path = pathlib.Path(base) / kind / f"{name}.py"
    if not path.exists():
        return None
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# completion marks: CUDA events on the card, none on the CPU
# ---------------------------------------------------------------------------

class _HostMark:
    """A stand-in for a CUDA event where the render runs on the CPU (the
    tests): the CPU path is synchronous."""

    def record(self):
        pass

    def synchronize(self):
        pass


def _mark(device):
    if device.type == "cuda":
        return torch.cuda.Event()
    return _HostMark()


def launches():
    """The sum of every kernel wrapper's launch counter."""
    from envutil_tpu_torch.ops import resample as R
    return sum(getattr(fn, "launches") for fn in vars(R).values()
               if callable(fn) and isinstance(getattr(fn, "launches", None),
                                              int))


def build_kernels():
    """Build (first run of a checkout) and load every kernel library of
    the program; seconds taken."""
    from envutil_tpu_torch.ops import kernels as K
    from envutil_tpu_torch.ops import resample as R
    libs = [v for v in vars(R).values() if isinstance(v, K.Library)]
    return K.build_all(libs)


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------

def frames_in_flight(render, device, seconds=None, frames=None, depth=2,
                     hold_at=None):
    """Render frames back to back with ``depth`` frames in flight: after
    enqueuing frame i, wait for frame i - depth + 1. Runs for ``seconds``
    of host time (frames enqueued until it has passed) or ``frames``
    frames. Returns (record, held, last): frames, host seconds from the
    first call to the last completion, each frame's latency (host ms from
    its call to the moment its completion event is seen done), each
    call's host ms; the first frame enqueued at or after ``hold_at``
    seconds, kept for the check; the last frame."""
    ring = [_mark(device) for _ in range(depth + 2)]
    pending = collections.deque()
    latency_ms, enqueue_ms = [], []
    held = img = None
    n = 0
    t0 = time.perf_counter()

    def wait():
        tc, e, _ = pending.popleft()
        e.synchronize()
        latency_ms.append((time.perf_counter() - tc) * 1e3)

    while True:
        t = time.perf_counter()
        if (frames is not None and n >= frames) or \
                (seconds is not None and t - t0 >= seconds):
            break
        e = ring[n % len(ring)]
        tc = time.perf_counter()
        img = render()
        enqueue_ms.append((time.perf_counter() - tc) * 1e3)
        e.record()
        if held is None and hold_at is not None and t - t0 >= hold_at:
            held = img
        pending.append((tc, e, img))
        while len(pending) >= depth:
            wait()
        n += 1
    while pending:
        wait()
    rec = dict(frames=n, seconds=time.perf_counter() - t0,
               latency_ms=latency_ms, enqueue_ms=enqueue_ms,
               pixels=0 if img is None else img.shape[0] * img.shape[1])
    return rec, held, img


@dataclasses.dataclass
class Run:
    """What a run recorded, for the metric readers."""
    cell: dict
    config: dict
    traffic: dict
    setup: dict = dataclasses.field(default_factory=dict)
    window: dict = dataclasses.field(default_factory=dict)
    trace: dict | None = None
    counts: dict = dataclasses.field(default_factory=dict)
    device: dict = dataclasses.field(default_factory=dict)
    checks: dict = dataclasses.field(default_factory=dict)
    failed: int = 0
    work: dict = dataclasses.field(default_factory=dict)


def run_cell(spec, cell_name, seed, seconds, trace, device, t_start,
             base=HERE, coeff=None, log=print):
    """One run of the cell on ``device``; returns (Run, result dict).
    ``coeff`` overrides the configuration's table type (the control)."""
    from envutil_tpu_torch.runtime import fastpath as FP

    device = torch.device(device)
    cell = find_cell(spec, cell_name)
    config = data("configs", cell["config"], base)
    traffic = data("traffic", cell["traffic"], base)
    limits = data("limits", cell_name, base)
    run = Run(cell=cell, config=config, traffic=traffic)
    if device.type == "cuda":
        run.setup["kernel_build_s"] = build_kernels()

    t0 = time.perf_counter()
    images = J.make_images(config, seed, device)
    run.setup["images_ms"] = (time.perf_counter() - t0) * 1e3
    args, sources, plan, build_ms = J.build(config, traffic, images, device,
                                            coeff)
    run.setup["source_build_ms"] = build_ms

    def render():
        return FP.frame_tensor(plan, sources)

    counters = ("_operands", "block_list", "champion_planes")
    before = {c: getattr(FP, c).builds for c in counters}
    J.sync(device)
    t0 = time.perf_counter()
    render()
    J.sync(device)
    run.setup["first_frame_ms"] = (time.perf_counter() - t0) * 1e3
    run.setup["builds"] = {c: getattr(FP, c).builds - before[c]
                           for c in counters}
    # warm with the window's pattern of memory: frames in flight and one
    # kept, so that the window allocates from the allocator's cache
    frames_in_flight(render, device, frames=traffic["warm_frames"],
                     depth=traffic["in_flight"], hold_at=0.0)

    hold_at = random.Random(seed).uniform(0.1, 0.9) * seconds
    n_launch = launches()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run.setup["setup_s"] = time.perf_counter() - t_start
    rec, held, last = frames_in_flight(render, device, seconds=seconds,
                                       depth=traffic["in_flight"],
                                       hold_at=hold_at)
    rec["launches"] = launches() - n_launch
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    if trace:
        run.trace = tracing.traced_span(
            render, device, frames=traffic["traced_frames"],
            depth=traffic["in_flight"], frames_in_flight=frames_in_flight,
            warm_frames=traffic["warm_frames"])
    run.window = rec
    run.device = dict(platform="gpu" if device.type == "cuda" else "cpu",
                      kind=torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu",
                      count=int(cell["chips"]), memory_peak_bytes=int(peak))
    log(f"set-up: {run.setup['setup_s']:.3f} s (kernel libraries "
        f"{run.setup.get('kernel_build_s', 0.0):.3f} s, images "
        f"{run.setup['images_ms']:.1f} ms, sources {build_ms:.1f} ms, first "
        f"frame {run.setup['first_frame_ms']:.1f} ms, builds in it "
        f"{run.setup['builds']}); window: {rec['frames']} frames in "
        f"{rec['seconds']:.3f} s, {rec['launches']} launches")
    frames = [last] if held is None or held is last else [held, last]
    del render, sources, plan, args, held, last
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    run.checks, run.failed, work = check.compare(config, traffic, images,
                                                 frames, limits, device)
    run.setup["reference_s"] = work["reference_s"]
    run.work = {k: v for k, v in work.items() if k != "touched"}
    del frames
    for m in cell_metrics(spec, cell_name, trace):
        cnt = module("counts", m["name"], base)
        if cnt is not None:
            run.counts[m["name"]] = cnt.count(work)
    return run, result(spec, cell_name, run, trace, base)


def result(spec, cell_name, run, trace, base=HERE):
    """The result line's object; ``checks`` comes last."""
    metrics = {}
    for m in cell_metrics(spec, cell_name, trace):
        reader = module("metrics", m["name"], base)
        value = None if reader is None else reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = dict(run.device)
    out = dict(correct=all(c["value"] <= c["limit"]
                           for c in run.checks.values()),
               attempted=run.window["frames"],
               failed=run.failed,
               metrics=metrics, device=device)
    if trace and run.trace is not None:
        device.update(busy_s=run.trace["busy_s"],
                      window_s=run.trace["window_s"])
        out["breakdown"] = dict(device_ops=run.trace["device_ops"],
                                idle_gaps=run.trace["idle_gaps"])
    out["checks"] = {k: dict(value=c["value"], limit=c["limit"])
                     for k, c in run.checks.items()}
    return out


def card_line():
    """The card's name, power limit and clocks, as nvidia-smi reads
    them, or why it could not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def loaded_forbidden():
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))
