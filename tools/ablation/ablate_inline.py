#!/usr/bin/env python3
"""Attribute the time of the two inline kernels on one CUDA card by
ablation (no profiler runs where the card is).

    python3 tools/ablation/ablate_inline.py        # from the repo root

Builds tools/ablation/inline_ablation.cu (variants of the kernels as
they stood before the staged-window redesign, each with one part of the
work removed; see the note at its head) and times every variant with
CUDA events (median of 20) at chip_smoke.py's shapes: the main path and
config 2r for the inline kernel, config 4, the pole-and-seam view and
the 16K job for the twined one. Prints one line per variant and, last,
one JSON object with all readings and the card's name and power limit.
"""

import ctypes
import json
import math
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402

INLINE = {0: "as it stood", 1: "cheap 1:1 coordinates, taps read",
          2: "chain kept, one tap read", 3: "one channel stored",
          4: "table padded to 4 channels, 16-byte tap loads",
          5: "chain alone, no tap read", 6: "cheap pickup, taps read"}
TWINED = {0: "as it stood", 1: "pickup hoisted to three a pixel",
          2: "pickup per tap, one table entry per tap",
          4: "cheap pickup per tap", 5: "pickup per tap alone, no tap read"}


def build():
    from envutil_tpu_torch.ops import kernels as K
    src = pathlib.Path(__file__).with_name("inline_ablation.cu")
    K.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = K.BUILD_DIR / "inline_ablation.so"
    subprocess.run([K.nvcc_path(), *K.NVCC_FLAGS[:-2], "-I",
                    str(ROOT / "envutil_tpu_torch" / "csrc"), "-o", str(so),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    lib.ablate_inline.argtypes = [i] + [p] * 7 + [ll] * 4 + [i] * 5 + \
        [f, f, i] + [f] * 8 + [p]
    lib.ablate_twined.argtypes = [i] + [p] * 7 + [ll] * 4 + [i] * 3 + \
        [f, f, i] + [f] * 7 + [p]
    return lib


def events_20(fn):
    return CS.events_ms(fn, 20)


def time_variants(name, names, launch, timer=events_20):
    import torch
    out = {}
    for v, what in names.items():
        for _ in range(3):
            launch(v)
        torch.cuda.synchronize()
        out[v] = timer(lambda: launch(v))
        print(f"{name}: variant {v} ({what}): {out[v]:.4f} ms", flush=True)
    return out


def inline_case(lib, name, plan, src, names=INLINE, timer=events_20):
    import torch
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    ops = FP.frame_operands(plan, src)
    coeff = src.spl.coeff
    hp, wp, nch = coeff.shape
    coeff4 = torch.zeros((hp, wp, 4), device="cuda")
    coeff4[..., :3] = coeff
    buf = torch.empty((plan.height, plan.width, 3), device="cuda")
    c = ops["consts"]
    section = c[11] if ops["smode"] != "sph" else 0.0
    stream = torch.cuda.current_stream().cuda_stream
    wmat = R._wmat(3)

    def launch(v):
        err = lib.ablate_inline(
            v, buf.data_ptr(), coeff.data_ptr(), coeff4.data_ptr(),
            ops["xfeat"].data_ptr(), ops["yfeat"].data_ptr(),
            ops["bmats"].data_ptr(), wmat, plan.height, plan.width, hp, wp,
            ops["row0"], ops["face_rows"], R._TMODES[ops["tmode"]],
            R._SMODES[ops["smode"]], R._GATES[c[4]], c[5], c[6],
            R._GATES[c[7]], c[8], c[9], c[0], c[1], c[2], c[3], c[10],
            section, stream)
        CS.check(err == 0, f"ablate_inline variant {v}: CUDA error {err}")
    return time_variants(name, names, launch, timer)


def twined_case(lib, name, plan, src, names=TWINED, timer=events_20):
    import torch
    from envutil_tpu_torch.ops import resample as R
    tensors, kw = CS.twined_inline_operands(plan, src)
    xfeat, yfeat, bmats, spread = tensors
    coeff = src.spl.coeff
    hp, wp, _ = coeff.shape
    buf = torch.empty((plan.height, plan.width, 3), device="cuda")
    c = kw["consts"]
    stream = torch.cuda.current_stream().cuda_stream
    wmat = R._wmat(1)
    CS.check(kw["tmode"] == "affine" and kw["smode"] == "sph",
             "the twined ablation takes rectilinear views of a mount")

    def launch(v):
        err = lib.ablate_twined(
            v, buf.data_ptr(), coeff.data_ptr(), xfeat.data_ptr(),
            yfeat.data_ptr(), bmats.data_ptr(), spread.data_ptr(), wmat,
            plan.height, plan.width, hp, wp, kw["n_taps"],
            R._SMODES[kw["smode"]], R._GATES[c[4]], c[5], c[6],
            R._GATES[c[7]], c[8], c[9], c[0], c[1], c[2], c[3], c[10],
            stream)
        CS.check(err == 0, f"ablate_twined variant {v}: CUDA error {err}")
    return time_variants(f"{name} ({kw['n_taps']} taps)", names, launch,
                         timer)


def main():
    import torch
    if not torch.cuda.is_available():
        print("ablate_inline: needs one CUDA card", file=sys.stderr)
        return 2
    from envutil_tpu_torch.core.conventions import Projection as P
    from envutil_tpu_torch.models import cubemap as CBM
    from envutil_tpu_torch.models import environment as E
    card = CS.card_line()
    print(f"card: {card}", flush=True)
    lib = build()
    res = {"card": card}
    w, h, fw = 8192, 4096, 2048
    img = CS.ramp_fixture(w, h)
    fct = CS.make_facet(P.SPHERICAL, w, h, 2 * math.pi)
    src = E.make_mount_source(fct, img, 3, 3, device="cuda")
    plan = CS.plan_for(fct, P.CUBEMAP, fw, 6 * fw, 90, 3)
    res["main"] = inline_case(lib, "main path", plan, src)
    del src
    torch.cuda.empty_cache()

    src1 = E.make_mount_source(fct, img, 1, 1, device="cuda")
    del img
    plan4 = CS.plan_for(fct, P.RECTILINEAR, 2048, 1280, 100, 1, twine=-1)
    res["config 4"] = twined_case(lib, "config 4", plan4, src1)
    plan4p = CS.plan_for(fct, P.RECTILINEAR, 2048, 1280, 100, 1,
                         (180, 80, 0), twine=-1)
    res["pole and seam"] = twined_case(lib, "pole and seam", plan4p, src1)
    del src1
    torch.cuda.empty_cache()

    rng = np.random.default_rng(5)
    cfct = CS.make_facet(P.CUBEMAP, fw, 6 * fw, math.pi / 2)
    faces = rng.uniform(0, 1, (6, fw, fw, 3)).astype(np.float32)
    csrc = CBM.make_cubemap_source(cfct, faces, 3, 3, 128, 64, device="cuda")
    del faces
    plan2r = CS.plan_for(cfct, P.SPHERICAL, w, h, 360, 3)
    res["2r"] = inline_case(lib, "config 2r", plan2r, csrc)
    del csrc
    torch.cuda.empty_cache()

    w16, h16 = 16384, 8192
    fct16 = CS.make_facet(P.SPHERICAL, w16, h16, 2 * math.pi)
    src16 = E.make_mount_source(fct16, CS.ramp_fixture(w16, h16), 1, 1,
                                device="cuda")
    plan16 = CS.plan_for(fct16, P.RECTILINEAR, 2048, 1280, 100, 1, twine=-1)
    res["16K"] = twined_case(lib, "16K job", plan16, src16)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
