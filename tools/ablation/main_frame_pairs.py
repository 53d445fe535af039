#!/usr/bin/env python3
"""Time chip_smoke.py's main path (an 8192x4096 RGB equirect to a
2048x12288 cubemap, degree 3, through ``fastpath.fused_frame``) in two
trees of the repo, in alternating processes on one CUDA card, to tell a
change of its frame time from the spread between processes.

    python3 tools/ablation/main_frame_pairs.py OTHER_ROOT [ROUNDS]

OTHER_ROOT is another checkout of the repo (an unpacked ``git
archive``). Each of ROUNDS rounds (default 2) runs four child
processes, other, this, this, other; each imports ``envutil_tpu_torch``
and ``chip_smoke`` from its own tree, builds the main path's source and
plan, and times, in three turns: the inline kernel alone and the frame
(``fused_frame`` into a reused buffer, as chip_smoke.py times it), both
with CUDA events (median of 20, a sync before each); each of them in a
burst of 20 calls between two events, which hides the host's time
behind the card's; and the host side of each alone (wall time per call
of 200 calls enqueued without a sync). A frame timed with events one
call at a time includes the host's time up to the kernel's launch,
since the card is idle when the first event is recorded. With OTHER_ROOT
a copy of this tree, the run shows the spread between processes
alone. Prints one line per child and, last, one JSON object with
every reading, the medians per tree and the card's name and power
limit.
"""

import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np

SCRIPT = pathlib.Path(__file__).resolve()
THIS = SCRIPT.parents[2]


def child(root):
    sys.path.insert(0, root)
    import torch
    import chip_smoke as CS
    from envutil_tpu_torch.core.conventions import Projection as P
    from envutil_tpu_torch.models import environment as E
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    w, h = 8192, 4096
    fct = CS.make_facet(P.SPHERICAL, w, h, 2 * math.pi)
    src = E.make_mount_source(fct, CS.ramp_fixture(w, h), 3, 3,
                              device="cuda")
    plan = CS.plan_for(fct, P.CUBEMAP, 2048, 6 * 2048, 90, 3)
    ops = FP.frame_operands(plan, src)
    kw = CS.inline_kw(ops, 3)
    args = (src.spl.coeff, ops["xfeat"], ops["yfeat"], ops["bmats"])
    buf = torch.empty((plan.height, plan.width, 3), device="cuda")

    def kernel():
        R.resample_inline(buf, *args, **kw)

    def frame():
        FP.fused_frame(plan, src, out=buf)

    def burst(fn, n=20):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    def host(fn, n=200):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / n
        torch.cuda.synchronize()
        return ms

    for _ in range(3):
        kernel()
        frame()
    torch.cuda.synchronize()
    reads = {"kernel_ms": [], "frame_ms": [], "burst_kernel_ms": [],
             "burst_frame_ms": [], "host_kernel_ms": [], "host_frame_ms": []}
    for _ in range(3):
        reads["kernel_ms"].append(CS.events_ms(kernel, 20))
        reads["frame_ms"].append(CS.events_ms(frame, 20))
        reads["burst_kernel_ms"].append(burst(kernel))
        reads["burst_frame_ms"].append(burst(frame))
        reads["host_kernel_ms"].append(host(kernel))
        reads["host_frame_ms"].append(host(frame))
    print(json.dumps(reads))


def main():
    if sys.argv[1] == "--child":
        child(sys.argv[2])
        return 0
    other = str(pathlib.Path(sys.argv[1]).resolve())
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    runs = []
    for r in range(rounds):
        for tree in ("other", "this", "this", "other"):
            root = other if tree == "other" else str(THIS)
            res = subprocess.run([sys.executable, str(SCRIPT), "--child",
                                  root], cwd=root, capture_output=True,
                                 text=True)
            if res.returncode != 0:
                print(res.stdout[-2000:], res.stderr[-4000:],
                      file=sys.stderr)
                return 1
            reads = json.loads(res.stdout.strip().splitlines()[-1])
            runs.append(dict(tree=tree, round=r, **reads))
            print(f"round {r} {tree}: " + "; ".join(
                f"{k} " + ", ".join(f"{v:.4f}" for v in vs)
                for k, vs in reads.items()), flush=True)
    medians = {tree: {k: float(np.median([v for run in runs
                                          if run["tree"] == tree
                                          for v in run[k]]))
                      for k in runs[0] if k.endswith("_ms")}
               for tree in ("other", "this")}
    print(json.dumps({"card": card, "medians": medians, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
