#!/usr/bin/env python3
"""Attribute the time of the two planar kernels and of the PyTorch
coordinate passes in front of them on one CUDA card, by ablation (no
profiler runs where the card is).

    python3 tools/ablation/ablate_planar.py        # from the repo root

Builds tools/ablation/planar_ablation.cu (variants of the kernels as
they stood before the fused coordinate chain and of their chain forms,
each with one part of the work removed; see the note at its head) and
times every variant with
CUDA events (median of 20) at chip_smoke.py's shapes: configs 3 and the
lens facet for the planar kernel, config 3 twined and the lens facet
twined for the twined one. Times the coordinate pass of each path split
into its stages (median of 10 each). Prints the shipped kernels' build
lines that report spills, one line per reading and, last, one JSON
object with all readings and the card's name and power limit.
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

VARIANTS = {0: "as it stood", 1: "planes read, one entry a spline",
            2: "planes read, nothing gathered",
            3: "taps gathered, planes replaced by an affine stand-in"}
CHAIN_VARIANTS = {0: "chain form", 1: "chain form, one entry a spline",
                  2: "chain form, nothing gathered"}
STAGED_VARIANT = {3: "chain form, window staged (32x8 px, 32 KB)"}


def build():
    from envutil_tpu_torch.ops import kernels as K
    src = pathlib.Path(__file__).with_name("planar_ablation.cu")
    K.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = K.BUILD_DIR / "planar_ablation.so"
    subprocess.run([K.nvcc_path(), *K.NVCC_FLAGS[:-2], "-I",
                    str(ROOT / "envutil_tpu_torch" / "csrc"), "-o", str(so),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
    lib.ablate_planar.argtypes = [i] + [p] * 7 + [ll] * 4 + [p]
    lib.ablate_twined.argtypes = [i] + [p] * 12 + [ll] * 4 + [i, f, f, p]
    lib.ablate_chain.argtypes = [i] + [p] * 9 + [ll] * 4 + [i] * 6 + [p]
    return lib


def spill_lines():
    """The ptxas lines of the shipped kernels that report spills."""
    from envutil_tpu_torch.ops import resample as R
    R.build()
    out = []
    for lib in R.LIBRARIES:
        entry = ""
        for line in lib.build_log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "bytes spill stores" in line and \
                    "0 bytes spill stores, 0 bytes spill loads" not in line:
                out.append(f"{lib.source.name}: {entry}: {line.strip()}")
    return out


def stand_in(sx, sy, cover, hp, wp):
    """(12 floats, covered share): an affine of the pixel index onto the
    range of the real coordinates over the bounding box of the covered
    pixels, and that box."""
    import torch
    rows = torch.nonzero(cover.any(dim=1)).flatten()
    cols = torch.nonzero(cover.any(dim=0)).flatten()
    y0, y1 = int(rows.min()), int(rows.max()) + 1
    x0, x1 = int(cols.min()), int(cols.max()) + 1
    xs, ys = sx[cover], sy[cover]
    lo_x = max(float(xs.min()), 2.0)
    hi_x = min(float(xs.max()), wp - 3.0)
    lo_y = max(float(ys.min()), 2.0)
    hi_y = min(float(ys.max()), hp - 3.0)
    a = (hi_x - lo_x) / max(x1 - x0, 1)
    c = (hi_y - lo_y) / max(y1 - y0, 1)
    share = (y1 - y0) * (x1 - x0) / cover.numel()
    return [a, lo_x - a * x0, c, lo_y - c * y0, x0, x1, y0, y1], share


def as_floats(values):
    return (ctypes.c_float * len(values))(*values)


def time_variants(name, launch, variants=VARIANTS):
    import torch
    out = {}
    for v, what in variants.items():
        for _ in range(3):
            launch(v)
        torch.cuda.synchronize()
        out[what] = CS.events_ms(lambda: launch(v), 20)
        print(f"{name}: variant {v} ({what}): {out[what]:.4f} ms",
              flush=True)
    return out


def chain_case(lib, name, plan, src, buf):
    """The chain form's variants on the job's own operands."""
    import torch
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    ops = FP.chain_operands(plan, src)
    coeff = src.spl.coeff
    hp, wp, _ = coeff.shape
    ints, floats = R._pickup_arrays(ops["pick"])
    spread = ops.get("spread")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(v):
        err = lib.ablate_chain(
            v, buf.data_ptr(), coeff.data_ptr(), ops["xfeat"].data_ptr(),
            ops["yfeat"].data_ptr(), ops["bmats"].data_ptr(),
            None if spread is None else spread.data_ptr(), R._wmat(3), ints,
            floats, plan.height, plan.width, hp, wp, ops["row0"],
            ops["face_rows"], R._CHAIN_TMODES[ops["tmode"]],
            ops.get("n_taps", 0), int(ops.get("precise", False)),
            int(ops.get("tap_valid", False)), stream)
        CS.check(err == 0, f"ablate_chain variant {v}: CUDA error {err}")
    return time_variants(name, launch, CHAIN_VARIANTS if spread is not None
                         else {**CHAIN_VARIANTS, **STAGED_VARIANT})


def planar_case(lib, name, plan, src):
    import torch
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    sx, sy, mask = FP.coords(plan, FP.frame_window(plan), src)
    masked = src.static.kind != "cubemap"
    m = mask.to(torch.float32) if masked else None
    coeff = src.spl.coeff
    hp, wp, _ = coeff.shape
    cover = mask if masked else torch.ones_like(mask)
    stand, share = stand_in(sx, sy, cover, hp, wp)
    stand = as_floats(stand + [0.0] * 4)
    buf = torch.zeros((plan.height, plan.width, 3), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(v):
        err = lib.ablate_planar(
            v, buf.data_ptr(), coeff.data_ptr(), sx.data_ptr(),
            sy.data_ptr(), None if m is None else m.data_ptr(), R._wmat(3),
            stand, plan.height, plan.width, hp, wp, stream)
        CS.check(err == 0, f"ablate_planar variant {v}: CUDA error {err}")
    res = time_variants(name, launch)
    res.update(chain_case(lib, name, plan, src, buf))
    res["stand-in covers (share of the frame)"] = share
    res["covered (share of the frame)"] = float(cover.float().mean())
    res["stages"] = planar_stages(name, plan, src, buf)
    return res


def planar_stages(name, plan, src, buf):
    """The coordinate pass of fastpath.coords (+ the zero fill and mask
    cast of a masked planar_frame), stage by stage."""
    import torch
    from envutil_tpu_torch.models import environment as E
    from envutil_tpu_torch.models import stepper as ST
    from envutil_tpu_torch.ops import spline as S
    from envutil_tpu_torch.runtime import fastpath as FP
    spl = src.spl
    window = FP.frame_window(plan)

    def rays():
        return ST.target_rays(plan.projection, plan.width, plan.height,
                              plan.extent, basis=plan.bases[0],
                              normalize=True,
                              planar_to_ray=plan.planar_to_ray[0],
                              window=window, device="cuda")
    ray = rays()
    x, y, mask = E.source_spline_coords(src, ray)
    h, w = spl.core_shape

    def gates():
        return (S.gate(x, spl.bcs[1], w) + spl.pad,
                S.gate(y, spl.bcs[0], h) + spl.pad)
    stages = {"target rays": rays,
              "pickup": lambda: E.source_spline_coords(src, ray),
              "gates and pad": gates,
              "whole pass (fastpath.coords)": lambda: FP.coords(plan, window,
                                                                src)}
    if src.static.kind != "cubemap":
        stages["mask cast and zero fill"] = lambda: (mask.to(torch.float32),
                                                     buf.zero_())
    return time_stages(name, stages)


def time_stages(name, stages):
    out = {}
    for what, fn in stages.items():
        fn()
        out[what] = CS.events_ms(fn, 10)
        print(f"{name}: pass stage {what}: {out[what]:.4f} ms", flush=True)
    return out


def twined_case(lib, name, plan, src):
    import torch
    from envutil_tpu_torch.models import synopsis as SYN
    from envutil_tpu_torch.ops import resample as R
    from envutil_tpu_torch.runtime import fastpath as FP
    ops = FP.twined_coords(plan, FP.frame_window(plan), src)
    planes = [ops[k] for k in ("sx", "sy", "dux", "duy", "dvx", "dvy")]
    tapw = ops["tap_weights"]
    coeff = src.spl.coeff
    hp, wp, _ = coeff.shape
    sp = torch.tensor(SYN.scaled_spread(plan.spread), dtype=torch.float32,
                      device="cuda")
    cover = (tapw.sum(dim=0) > 0) if tapw is not None else \
        torch.ones(planes[0].shape, dtype=torch.bool, device="cuda")
    stand, share = stand_in(planes[0], planes[1], cover, hp, wp)
    stand = as_floats(stand + [float(t[cover].median()) for t in planes[2:]])
    lower, period = ops["wrap_x"] or (0.0, 0.0)
    buf = torch.zeros((plan.height, plan.width, 3), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(v):
        err = lib.ablate_twined(
            v, buf.data_ptr(), coeff.data_ptr(),
            *(t.data_ptr() for t in planes), sp.data_ptr(),
            None if tapw is None else tapw.data_ptr(), R._wmat(3), stand,
            plan.height, plan.width, hp, wp, len(plan.spread), lower, period,
            stream)
        CS.check(err == 0, f"ablate_twined variant {v}: CUDA error {err}")
    res = time_variants(f"{name} ({len(plan.spread)} taps)", launch)
    res.update(chain_case(lib, name, plan, src, buf))
    res["stand-in covers (share of the frame)"] = share
    res["covered (share of the frame)"] = float(cover.float().mean())
    res["stages"] = twined_stages(name, plan, src)
    return res


def twined_stages(name, plan, src):
    """The coordinate pass of fastpath.twined_coords, stage by stage."""
    import torch
    from envutil_tpu_torch.core import geometry as geo
    from envutil_tpu_torch.models import environment as E
    from envutil_tpu_torch.models import stepper as ST
    from envutil_tpu_torch.models import synopsis as SYN
    from envutil_tpu_torch.ops import spline as S
    from envutil_tpu_torch.runtime import fastpath as FP
    spl, st = src.spl, src.static
    window = FP.frame_window(plan)
    w = spl.core_shape[1]

    def ninepack():
        return ST.target_ninepack(
            plan.projection, plan.width, plan.height, plan.extent,
            basis=plan.bases[0], normalize=True,
            planar_to_ray=plan.planar_to_ray[0], window=window,
            device="cuda")
    p0, p10, p01 = ninepack()
    du, dv = SYN.derivative_rays(p0, p10, p01, plan.twine_precise)

    def pickups():
        face = geo.ray_to_cubeface(*p0)[0] if st.kind == "cubemap" else None
        return [E.source_spline_coords(src, r, face) for r in (p0, p10, p01)]
    (x0, y0, _), (x1, y1, _), (x2, y2, _) = pickups()
    periodic = st.kind != "cubemap" and spl.bcs[1] == S.PERIODIC

    def derivatives():
        out = []
        for x, y in ((x1, y1), (x2, y2)):
            dx, dy = x - x0, y - y0
            if periodic:
                dx = torch.remainder(dx + 0.5 * w, float(w)) - 0.5 * w
            out += [torch.nan_to_num(dx, 0.0, 0.0, 0.0).contiguous(),
                    torch.nan_to_num(dy, 0.0, 0.0, 0.0).contiguous()]
        return out
    stages = {"ninepack (three target ray grids)": ninepack,
              "derivative rays": lambda: SYN.derivative_rays(
                  p0, p10, p01, plan.twine_precise),
              "three pickups": pickups,
              "coordinate derivatives": derivatives,
              "whole pass (fastpath.twined_coords)": lambda: FP.twined_coords(
                  plan, window, src)}
    if not FP._covers_every_ray(src):
        stages["tap validity (K chains, uint8 planes)"] = lambda: torch.stack(
            [E.source_spline_coords(src, SYN.deflect(p0, du, dv, cx, cy))[2]
             for cx, cy, _w in SYN.scaled_spread(plan.spread)]
        ).to(torch.uint8)
    return time_stages(name, stages)


def main():
    import torch
    if not torch.cuda.is_available():
        print("ablate_planar: needs one CUDA card", file=sys.stderr)
        return 2
    from envutil_tpu_torch.core.conventions import Projection as P
    from envutil_tpu_torch.core.metrics import get_extent
    from envutil_tpu_torch.models import cubemap as CBM
    from envutil_tpu_torch.models import environment as E
    from envutil_tpu_torch.models import stepper as ST
    card = CS.card_line()
    print(f"card: {card}", flush=True)
    for line in spill_lines():
        print(f"spills: {line}", flush=True)
    lib = build()
    res = {"card": card}

    rng = np.random.default_rng(3)
    bfct = CS.make_facet(P.BIATAN6, 1024, 6144, math.radians(100))
    faces = rng.uniform(0, 1, (6, 1024, 1024, 3)).astype(np.float32)
    bsrc = CBM.make_cubemap_source(bfct, faces, 3, 3, 128, 64, device="cuda")
    del faces
    res["config 3"] = planar_case(
        lib, "config 3", CS.plan_for(bfct, P.STEREOGRAPHIC, 1920, 1152, 150,
                                     3, (35, 20, 0)), bsrc)
    del bsrc
    ext = get_extent(P.BIATAN6, 1024, 6144, math.radians(100))
    sfaces = CS.smooth_environment(ST.target_rays(
        P.BIATAN6, 1024, 6144, ext, device="cuda")).cpu().numpy()
    ssrc = CBM.make_cubemap_source(bfct, sfaces.reshape(6, 1024, 1024, 3),
                                   3, 3, 128, 64, device="cuda")
    del sfaces
    res["config 3 twined"] = twined_case(
        lib, "config 3 twined", CS.plan_for(
            bfct, P.STEREOGRAPHIC, 1920, 1152, 150, 3, (35, 20, 0),
            twine=2), ssrc)
    del ssrc
    torch.cuda.empty_cache()

    lf = CS.make_facet(P.RECTILINEAR, 1536, 1152, math.radians(72),
                       a=0.01, b=-0.02, c=0.005)
    limg = rng.uniform(0, 1, (1152, 1536, 3)).astype(np.float32)
    lsrc = E.make_mount_source(lf, limg, 3, 3, device="cuda")
    res["lens facet"] = planar_case(
        lib, "lens facet", CS.plan_for(lf, P.SPHERICAL, 4096, 2048, 360, 3),
        lsrc)
    res["lens facet twined"] = twined_case(
        lib, "lens facet twined", CS.plan_for(lf, P.SPHERICAL, 4096, 2048,
                                              360, 3, twine=2), lsrc)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
