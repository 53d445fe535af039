"""Time variants of the inline twined kernel (K4) against each other on
one CUDA card, in rotation on the same operands.

    python3 tools/ablation/k4_variants.py

Run from the repository root on a machine with a card. Writes each
variant of this checkout's csrc/resample_inline_twined.cu (with the
headers beside it) under envutil_tpu_torch/_build/k4_variants/, builds
them in parallel, prints each one's registers at degree 1, three
channels, float32, and the largest stack frame of its instantiations,
then times every variant at config
4, the pole-and-seam view, a one-tap launch of config 4's view and the
16K job (chip_smoke.py's shapes): bursts of 20 launches between two
events, median of 5, per launch, in the order of the list and back,
twice, averaged. Each output is compared with the first variant's.
Prints one JSON object last. (K4 before and after a commit is timed by
``python3 chip_smoke.py PARENT_ROOT``.)
"""

import json
import math
import pathlib
import re
import shutil
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402

SOURCE = "resample_inline_twined.cu"
# name: (text replaced, replacement) in the kernel source
VARIANTS = {
    "as committed": None,
    "registers capped at 40 (6 blocks an SM)": (
        "__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)\n",
        "__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y, 6)\n"),
    "spline_at in place of spline_block": (
        "    spline_block<DEGREE, NCH>(coeff, p.table, sx, sy, val);",
        "    spline_at<DEGREE, NCH>(coeff, p.table, sx, sy, val);"),
}


def variant_roots():
    csrc = ROOT / "envutil_tpu_torch" / "csrc"
    base = ROOT / "envutil_tpu_torch" / "_build" / "k4_variants"
    roots = {}
    for i, (name, edit) in enumerate(VARIANTS.items()):
        root = base / f"v{i}"
        dst = root / "envutil_tpu_torch" / "csrc"
        shutil.rmtree(root, ignore_errors=True)
        dst.mkdir(parents=True)
        for header in csrc.glob("*.cuh"):
            shutil.copy(header, dst)
        text = (csrc / SOURCE).read_text()
        if edit is not None:
            if edit[0] not in text:
                raise SystemExit(f"k4_variants: {name}: source text not found")
            text = text.replace(edit[0], edit[1])
        (dst / SOURCE).write_text(text)
        roots[name] = root
    return roots


def registers(lib):
    """(registers of the degree-1, 3-channel float32 instantiations,
    largest stack frame) from ``lib``'s build log; (None, None) for a
    library built before this run (chip_smoke.py prints those)."""
    if not lib.build_log:
        return None, None
    regs, stack, entry = {}, 0, None
    for line in lib.build_log.splitlines():
        m = re.search(r"kernelI((?:Li\d+E)+)(\w+?)E", line)
        if "Compiling entry function" in line and m:
            entry = m.group(1) + m.group(2)
        elif entry and "Used " in line:
            regs[entry] = int(line.split("Used ")[1].split(" registers")[0])
        elif "bytes stack frame" in line:
            stack = max(stack, int(line.split(" bytes stack frame")[0]
                                   .split()[-1]))
    return ({k: v for k, v in regs.items() if k.startswith("Li1ELi3E")
             and k.endswith("f")}, stack)


def main():
    import torch
    from envutil_tpu_torch.core.conventions import Projection as P
    from envutil_tpu_torch.models import environment as E
    from envutil_tpu_torch.ops import kernels as K
    from envutil_tpu_torch.ops import resample as R
    card = CS.card_line()
    print(f"card: {card}", flush=True)
    libs = {n: CS.parent_k4_library(r) for n, r in variant_roots().items()}
    K.build_all(list(libs.values()))
    rec = {"card": card, "registers": {}, "jobs": {}}
    for n, lib in libs.items():
        regs, stack = registers(lib)
        rec["registers"][n] = dict(degree1_3ch_f32=regs, max_stack=stack)
        print(f"{n}: registers at degree 1, 3 channels, float32 {regs}; "
              f"largest stack frame {stack} bytes", flush=True)

    def job(plan, src):
        tensors, kw = CS.twined_inline_operands(plan, src)
        buf = torch.empty((plan.height, plan.width, 3), device="cuda")
        return (lambda: R.resample_inline_twined(buf, src.spl.coeff,
                                                 *tensors, **kw), buf)
    fct = CS.make_facet(P.SPHERICAL, 8192, 4096, 2 * math.pi)
    src = E.make_mount_source(fct, CS.ramp_fixture(8192, 4096), 1, 1,
                              device="cuda")
    view = (fct, P.RECTILINEAR, 2048, 1280, 100, 1)
    jobs = {"config 4": job(CS.plan_for(*view, twine=-1), src),
            "pole and seam": job(CS.plan_for(*view, (180, 80, 0),
                                             twine=-1), src),
            "one tap": job(CS.plan_for(*view, twine=[(0.25, 0.25, 1.0)]),
                           src)}
    fct16 = CS.make_facet(P.SPHERICAL, 16384, 8192, 2 * math.pi)
    src16 = E.make_mount_source(fct16, CS.ramp_fixture(16384, 8192), 1, 1,
                                device="cuda")
    jobs["16K"] = job(CS.plan_for(fct16, P.RECTILINEAR, 2048, 1280, 100, 1,
                                  twine=-1), src16)
    names = list(libs)
    for name, (launch, buf) in jobs.items():
        outs = {}
        for n in names:
            CS.with_k4_library(libs[n], launch)
            torch.cuda.synchronize()
            outs[n] = buf.clone()
        diffs = {n: float((outs[n] - outs[names[0]]).abs().max())
                 for n in names}
        del outs

        def many():
            for _ in range(20):
                launch()
        times = {n: [] for n in names}
        for _ in range(2):
            for n in names + names[::-1]:
                CS.with_k4_library(libs[n], many)
                times[n].append(CS.with_k4_library(
                    libs[n], lambda: CS.events_ms(many, 5)) / 20)
        rec["jobs"][name] = {n: dict(ms=float(np.mean(times[n])),
                                     max_abs_vs_first=diffs[n])
                             for n in names}
        print(f"{name}: per launch " + "; ".join(
            f"{n} {np.mean(times[n]):.4f} ms" for n in names)
            + f"; clocks/power/temp after: {CS.smi_now()}", flush=True)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
