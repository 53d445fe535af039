"""Run one cell of the benchmark on the card and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the repository's root (or a checkout of it). The cell is an entry
of ``workloads`` in BENCHMARK.json; ``--seed`` makes the images, so one
seed always gives the same inputs; ``--seconds`` is the length of the
measured window; ``--trace 1`` adds a profiled span after the window and
reports the per-layer metrics in place of the end-to-end ones.

Standard error carries the set-up, the card (nvidia-smi), the counts and
the trace, and as its last lines each number of the check beside its
limit; the last line of standard output is the result, one JSON object.
The run exits with another code than 0, and prints no result, where no
CUDA card (or fewer than the cell asks for) is present, where the
program cannot be imported, and where a module of JAX or of the JAX
package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the checkout's own program and harness, whatever else is installed
sys.path[0] = str(ROOT)


def say(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ns = ap.parse_args(argv)

    import torch
    from benchmark import harness as H

    try:
        spec = H.load_spec(ROOT)
        cell = H.find_cell(spec, ns.workload)
        if not torch.cuda.is_available():
            raise H.Refused(3, "no CUDA device: torch.cuda.is_available() "
                               "is False")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise H.Refused(3, f"the cell asks for {cell['chips']} cards, "
                               f"{torch.cuda.device_count()} present")
        try:
            import envutil_tpu_torch
        except ImportError as e:
            raise H.Refused(2, f"the program cannot be imported: {e}")
        where = pathlib.Path(envutil_tpu_torch.__file__).resolve()
        if ROOT not in where.parents:
            raise H.Refused(2, f"envutil_tpu_torch comes from {where}, "
                               f"not from this checkout")
        run, res = H.run_cell(spec, ns.workload, ns.seed, ns.seconds,
                              bool(ns.trace), "cuda", T_START, log=say)
        bad = H.loaded_forbidden()
        if bad:
            raise H.Refused(4, "modules of JAX or of the JAX package are "
                               f"loaded: {', '.join(bad)}")
    except H.Refused as e:
        say(f"refused: {e}")
        return e.code

    say(f"card: {H.card_line()}")
    w = run.window
    say(f"window: {w['frames']} frames of {w['pixels']} px in "
        f"{w['seconds']:.6f} s; frame latency min/median/max "
        f"{min(w['latency_ms']):.6f} / "
        f"{sorted(w['latency_ms'])[len(w['latency_ms']) // 2]:.6f} / "
        f"{max(w['latency_ms']):.6f} ms; reference and check "
        f"{run.setup['reference_s']:.3f} s, {run.work['ambiguous_px']} px "
        f"within rounding of a window edge or a voronoi tie")
    for name, c in run.counts.items():
        say(f"count {name}: {json.dumps(c)}")
    if run.trace is not None:
        t = {k: v for k, v in run.trace.items()
             if k not in ("device_ops", "idle_gaps")}
        say(f"trace: {json.dumps(t)}")
    for name, c in res["checks"].items():
        say(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
