"""Readings that the limits of a cell's check are set from, in one
process on the card: the program on a dozen seeds or more, and the
control, the program with its tables stored in bfloat16 (``--coeff
bf16``, the program's own lower-precision path), on three seeds or more;
each a run of the cell as ``run.py`` makes it, with a short window.

    python3 benchmark/control.py --workload <cell> [--seeds 12]
        [--control-seeds 3] [--seconds 2] [--first-seed <n>]

prints one JSON line per run and, last, the summary: per compared
number the program's largest reading (the lower one), the control's
smallest (the upper one), and their ratio. The benchmark's own runs do
not run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 12345)
    ns = ap.parse_args(argv)

    import torch
    from benchmark import harness as H
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    spec = H.load_spec(ROOT)
    readings = {None: [], "bf16": []}
    plan = [(None, ns.first_seed + 7919 * k) for k in range(ns.seeds)] + \
        [("bf16", ns.first_seed + 104729 * (k + 1))
         for k in range(ns.control_seeds)]
    for coeff, seed in plan:
        run, res = H.run_cell(spec, ns.workload, seed, ns.seconds, False,
                              "cuda", time.perf_counter(), coeff=coeff,
                              log=lambda *a: None)
        line = dict(workload=ns.workload, seed=seed,
                    coeff=coeff or "f32", frames=run.window["frames"],
                    ambiguous_px=run.work.get("ambiguous_px"),
                    **{k: v["value"] for k, v in res["checks"].items()})
        readings[coeff].append(line)
        print(json.dumps(line), flush=True)
    summary = {"workload": ns.workload, "card": H.card_line()}
    for k in ("max_gap", "rms_gap"):
        lower = max(r[k] for r in readings[None])
        upper = min(r[k] for r in readings["bf16"]) if readings["bf16"] \
            else None
        summary[k] = dict(lower=lower, upper=upper,
                          ratio=None if upper is None else upper / lower)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
