"""The inline twined kernel (K4) of a parent checkout and of this one in
turns at spline degrees 0 to 7, on one CUDA card.

    python3 tools/ablation/k4_degrees.py PARENT_ROOT

Run from the repository root on a machine with a card; PARENT_ROOT is a
checkout of the parent commit (e.g. an unpacked ``git archive``). Builds
both K4s in parallel (chip_smoke.parent_k4_library), prints the
registers and spills of each one's three-channel, affine-target,
float32 instantiation at every degree timed, then at config 4's view
(8K ramp source, 2048x1280, 4 taps) and the 16K job (16K ramp source,
16 taps) for degrees 0, 1, 3, 5 and 7: holds this checkout's K4 against
its plain version (chip_smoke.KERNEL_BOUND), prints the share of
pixel-taps through the increment (the plain version's count) and the
bound, and times the two K4s in turns (chip_smoke.k4_turns). Prints one
JSON object last.
"""

import json
import math
import pathlib
import re
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402

DEGREES = (0, 1, 3, 5, 7)


def registers(lib, degree):
    """(registers, spill store bytes) of ``lib``'s degree-``degree``,
    three-channel, affine-target float32 instantiation from its build
    log; None where the library was built before this run."""
    name = f"resample_inline_twined_kernelILi{degree}ELi3ELi0EfE"
    regs, spill, inside = None, 0, False
    for line in lib.build_log.splitlines():
        if "Compiling entry function" in line:
            inside = name in line
        elif inside and "Used " in line and " registers" in line:
            regs = int(line.split("Used ")[1].split(" registers")[0])
        elif inside:
            m = re.search(r"(\d+) bytes spill stores", line)
            spill = max(spill, int(m.group(1))) if m else spill
    return None if regs is None else (regs, spill)


def main():
    import torch
    from envutil_tpu_torch.core.conventions import Projection as P
    from envutil_tpu_torch.models import environment as E
    from envutil_tpu_torch.ops import kernels as K
    from envutil_tpu_torch.ops import resample as R
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    card = CS.card_line()
    print(f"card: {card}", flush=True)
    CS.PARENT["k4"] = CS.parent_k4_library(sys.argv[1])
    K.build_all([R._INLINE_TWINED, CS.PARENT["k4"]])
    rec = {"card": card, "registers": {}, "jobs": {}}
    for which, lib in (("after", R._INLINE_TWINED),
                       ("before", CS.PARENT["k4"])):
        rec["registers"][which] = {d: registers(lib, d) for d in DEGREES}
        print(f"K4 {which}: (registers, spill store bytes) of the "
              f"3-channel, affine, float32 instantiation by degree "
              f"{rec['registers'][which]}", flush=True)
    tables = (("config 4", 8192, 4), ("16K", 16384, 16))
    for table, width, taps in tables:
        fct = CS.make_facet(P.SPHERICAL, width, width // 2, 2 * math.pi)
        img = CS.ramp_fixture(width, width // 2)
        plan0 = CS.plan_for(fct, P.RECTILINEAR, 2048, 1280, 100, 1,
                            twine=-1)
        CS.check(len(plan0.spread) == taps, f"{table}: {plan0.spread}")
        for degree in DEGREES:
            name = f"{table}, degree {degree}"
            src = E.make_mount_source(fct, img, degree, degree,
                                      device="cuda")
            plan = CS.plan_for(fct, P.RECTILINEAR, 2048, 1280, 100, degree,
                               twine=plan0.spread)
            err, _edge, _p = CS.twined_kernel_vs_plain(plan, src)
            CS.check(err <= CS.KERNEL_BOUND,
                     f"{name}: K4 disagrees with its plain version: {err}")
            bound = CS.inline_twined_bound(plan, src)
            print(f"{name}: K4 vs plain {err:.3e} (bound "
                  f"{CS.KERNEL_BOUND:g}); bound {bound[0]:.4f} ms by "
                  f"{bound[1]}; {CS.share_text(bound[7])}", flush=True)
            tensors, kw = CS.twined_inline_operands(plan, src)
            buf = torch.empty((plan.height, plan.width, 3), device="cuda")
            turns = CS.k4_turns(name, lambda: R.resample_inline_twined(
                buf, src.spl.coeff, *tensors, **kw), buf)
            rec["jobs"][name] = dict(max_abs_err=err, bound_ms=bound[0],
                                     bound_by=bound[1],
                                     increment_share=bound[7], turns=turns)
            del src, tensors, kw, buf
            torch.cuda.empty_cache()
        del img
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
