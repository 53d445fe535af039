#!/usr/bin/env python3
"""Time the planar kernels' launches on paths without a voronoi stitch
in two trees of the repo, in alternating processes on one CUDA card:
the K2 chain form at config 3 (a biatan6 noise source, 1024-px faces ->
1920x1152 stereographic) and at the lens facet (1536x1152 rectilinear,
lens a, b, c = 0.01, -0.02, 0.005 -> 4096x2048 equirect, on its block
list), the K3 chain form at config 3 and the lens facet under --twine 2
(4 taps), and the K3 planes form at the translated facet under --twine
2 (640x480 -> 1024x768, on the twined coordinate pass's operands).

    python3 tools/ablation/chain_pairs.py OTHER_ROOT [ROUNDS]

OTHER_ROOT is another checkout of the repo (an unpacked ``git archive``,
e.g. of the parent commit). Each of ROUNDS rounds (default 2) runs four
child processes, other, this, this, other; each imports
``envutil_tpu_torch`` and ``chip_smoke`` from its own tree (and builds
that tree's kernels at first use), builds the sources and operands
through the API both trees share, and times each launch with CUDA
events: single launches (median of 20) and bursts of 20 launches
between two events (median of 5, per launch). Prints one line per child
and, last, one JSON object with every reading, the medians per tree,
this tree's over the other's, and the card's name and power limit.
"""

import json
import math
import pathlib
import subprocess
import sys

import numpy as np

SCRIPT = pathlib.Path(__file__).resolve()
THIS = SCRIPT.parents[2]


def child(root):
    sys.path.insert(0, root)
    import torch
    import chip_smoke as CS
    from envutil_tpu_torch.core.conventions import Projection as P
    from envutil_tpu_torch.models import cubemap as CBM
    from envutil_tpu_torch.models import environment as E
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    R.build()
    rng = np.random.default_rng(3)
    bfct = CS.make_facet(P.BIATAN6, 1024, 6144, math.radians(100))
    faces = rng.uniform(0, 1, (6, 1024, 1024, 3)).astype(np.float32)
    bsrc = CBM.make_cubemap_source(bfct, faces, 3, 3, 128, 64,
                                   device="cuda")
    lf = CS.make_facet(P.RECTILINEAR, 1536, 1152, math.radians(72),
                       a=0.01, b=-0.02, c=0.005)
    limg = rng.uniform(0, 1, (1152, 1536, 3)).astype(np.float32)
    lsrc = E.make_mount_source(lf, limg, 3, 3, device="cuda")
    tf = CS.make_facet(P.RECTILINEAR, 640, 480, math.radians(80),
                       tr_x=0.2, tr_y=-0.1, tr_z=0.15, yaw=math.radians(10))
    tsrc = E.make_mount_source(tf, limg[:480, :640], 3, 3, device="cuda")

    def chain(plan, src):
        ops = FP.chain_operands(plan, src)
        args = [src.spl.coeff] + [ops.pop(k) for k in ("xfeat", "yfeat",
                                                        "bmats")]
        if plan.spread is None:
            kernel = R.resample_planar_chain
        else:
            kernel = R.resample_twined_chain
            args.append(ops.pop("spread"))
        blocks = FP.block_list(plan, src)
        buf = torch.zeros((plan.height, plan.width, 3), device="cuda")
        return lambda: kernel(buf, *args, blocks=blocks, **ops)

    def planes_twined(plan, src):
        ops = FP.twined_coords(plan, FP.frame_window(plan), src)
        spread = FP._spread_tensor(plan.spread, src.spl.coeff.device)
        buf = torch.zeros((plan.height, plan.width, 3), device="cuda")
        planes = [ops[k] for k in ("sx", "sy", "dux", "duy", "dvx", "dvy")]
        return lambda: R.resample_twined(
            buf, src.spl.coeff, *planes, spread, degree=3,
            n_taps=len(plan.spread), tap_weights=ops["tap_weights"],
            wrap_x=ops["wrap_x"])

    jobs = {
        "config 3, K2 chain": chain(CS.plan_for(
            bfct, P.STEREOGRAPHIC, 1920, 1152, 150, 3, (35, 20, 0)), bsrc),
        "config 3 twined, K3 chain": chain(CS.plan_for(
            bfct, P.STEREOGRAPHIC, 1920, 1152, 150, 3, (35, 20, 0),
            twine=2), bsrc),
        "lens, K2 chain on its list": chain(CS.plan_for(
            lf, P.SPHERICAL, 4096, 2048, 360, 3), lsrc),
        "lens twined, K3 chain on its list": chain(CS.plan_for(
            lf, P.SPHERICAL, 4096, 2048, 360, 3, twine=2), lsrc),
        "translated twined, K3 planes": planes_twined(CS.plan_for(
            tf, P.RECTILINEAR, 1024, 768, 100, 3, (5, 0, 0), twine=2), tsrc),
    }
    out = {}
    for name, fn in jobs.items():
        for _ in range(3):
            fn()

        def burst(fn=fn):
            for _ in range(20):
                fn()
        out[name] = dict(ms=CS.events_ms(fn, 20),
                         burst_ms=CS.events_ms(burst, 5) / 20)
    print("CHILD " + json.dumps(out), flush=True)


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        return child(sys.argv[2])
    other = str(pathlib.Path(sys.argv[1]).resolve())
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    runs = {"this": [], "other": []}
    for _ in range(rounds):
        for tree in ("other", "this", "this", "other"):
            root = str(THIS) if tree == "this" else other
            proc = subprocess.run([sys.executable, str(SCRIPT), "--child",
                                   root], capture_output=True, text=True,
                                  cwd=root)
            line = [ln for ln in proc.stdout.splitlines()
                    if ln.startswith("CHILD ")]
            if proc.returncode != 0 or not line:
                raise SystemExit(f"child in {root} failed:\n{proc.stdout}\n"
                                 f"{proc.stderr}")
            rec = json.loads(line[-1][6:])
            runs[tree].append(rec)
            print(f"{tree}: " + "; ".join(
                f"{k} {v['ms']:.4f} / {v['burst_ms']:.4f} ms"
                for k, v in rec.items()), flush=True)
    medians = {tree: {job: {m: float(np.median([r[job][m] for r in recs]))
                            for m in ("ms", "burst_ms")}
                      for job in recs[0]}
               for tree, recs in runs.items()}
    ratio = {job: {m: medians["this"][job][m] / medians["other"][job][m]
                   for m in ("ms", "burst_ms")}
             for job in medians["this"]}
    print(json.dumps(dict(card=card, runs=runs, medians=medians,
                          this_over_other=ratio)))


if __name__ == "__main__":
    main()
