"""Command-line entry point of the PyTorch port (``envutil-torch``).

Counterpart of envutil_tpu/runtime/cli.py (envutil_main.cc:1634-1983).
Job modes match the reference:
  * single job: `envutil-torch --input in.exr --output out.exr ...`
    (``--single`` re-creates one facet of a PTO, ``--mask_for`` renders
    a facet's mask)
  * --split: loop of --single jobs re-creating each facet
  * streaming mode: trailing '-' reads argument lines from stdin and
    re-runs the core with assets persisting across jobs
  * tethered serve mode: trailing '+' (socket transport,
    runtime/serve.py) or '++' (shared-memory frame buffers with the
    visor pipeline semantics, runtime/visor.py)
Every mode renders on CUDA unless the environment sets
``ENVUTIL_PLATFORM=cpu``, the override the JAX CLI honours too.
--mesh N splits a job's output rows over N devices of that type (every
CUDA card, or N CPU slots) and --shard_table, with it, the facets'
tables (runtime/render.render_frame, parallel/mesh.py).
"""

from __future__ import annotations

import os
import shlex
import sys
from typing import List

import numpy as np
import torch

from ..core.conventions import PROJECTION_NAMES
from ..io import imgio
from ..ops import spline as S
from . import assets, loader
from .args import D2R, parse_args
from .platform import resolve_device
from .render import build_plan, render_frame

# cumulated frame rendering time (rt_cumulated, envutil_main.cc:1620)
rt_cumulated = 0.0


def cp_statistics(args, sources) -> None:
    """Control-point intensity check: sample a 4x4 window around each
    control point in both facets, pool the intensity sums per facet
    pair, echo the matrix and the pairwise brightness ratios. This is
    a working version of the reference's experimental CP-statistics
    block (envutil_payload.cc:1950-2026, disabled there), generalized
    to any facet count; it's what -v exposes when a PTO has c-lines.
    The windows are evaluated on each source's device."""
    nf = len(sources)
    s = np.zeros((nf, nf), np.float64)
    offs = np.arange(4, dtype=np.float32) - 1.5
    dx, dy = np.meshgrid(offs, offs)
    for cp in args.cp_list:
        if cp.t != 0:      # only 'normal' points carry intensity info
            continue
        for fi, x, y, fj in ((cp.n, cp.x, cp.y, cp.N),
                             (cp.N, cp.X, cp.Y, cp.n)):
            if not (0 <= fi < nf) or sources[fi].spl is None:
                continue
            spl = sources[fi].spl
            px = S.eval_spline(
                spl, *(torch.from_numpy(np.asarray(v + d, np.float32))
                       .to(spl.coeff.device) for v, d in ((x, dx), (y, dy))))
            nch = px.shape[-1]
            colour = px[..., :nch - 1] if nch in (2, 4) else px
            s[fi][fj] += float(torch.sum(colour))
    print("CP intensity check:")
    for j in range(nf):
        print(" ".join(f"{s[i][j]:.6g}" for i in range(nf)))
    for i in range(nf):
        for j in range(i):
            if s[j][i] != 0.0:
                print(f"{i}:{j} {s[i][j] / s[j][i]:.6g}")


def _run_job(args, device) -> None:
    """One rendition: load facets, build plan, render, save. Every
    facet is loaded where -v asks for the control-point check of a PTO
    with c-lines, else only the plan's."""
    global rt_cumulated
    plan = build_plan(args, args.facets)
    if args.verbose and args.cp_list:
        every = [loader.load_source(f, args, device) for f in args.facets]
        cp_statistics(args, every)
        sources = [every[i] for i in plan.facet_indices]
    else:
        sources = [loader.load_source(args.facets[i], args, device)
                   for i in plan.facet_indices]

    # for 'single' jobs, undo the target facet's own brighten
    # (envutil_payload.cc:481-512)
    amplify = None
    if args.single >= 0:
        b = args.facets[args.single].brighten
        if b != 1.0:
            amplify = 1.0 / b

    img = render_frame(plan, sources, verbose=args.verbose, amplify=amplify,
                       device=device, mesh_n=args.mesh,
                       shard_table=args.shard_table)
    rt_cumulated += render_frame.last_ms

    if args.mask_for != -1 and img.shape[-1] == 2:
        # after the synopsis the mask is (value*alpha, alpha); keep the
        # first channel as a plain grey mask (environment.h:1311-1323)
        img = img[..., :1]

    imgio.save_image(
        args.output, img,
        projection_name=PROJECTION_NAMES[args.projection],
        hfov_deg=args.hfov / D2R,
        working_colour_space=args.working_colour_space,
        output_colour_space=args.colour_space,
        verbose=args.verbose)


def _split_argv(argv: List[str], i: int, out_name: str) -> List[str]:
    """The argument list of --split's i-th job: ``argv`` without its
    --split argument, with ``--single i --output out_name``."""
    clean, skip = [], False
    for a in list(argv) + ["--single", str(i), "--output", out_name]:
        if skip:
            skip = False
        elif a == "--split":
            skip = True
        elif not a.startswith("--split="):
            clean.append(a)
    return clean


def core(argv: List[str], device=None) -> int:
    args = parse_args(argv)
    args.twine_setup()
    device = resolve_device(device)
    if args.split:
        # re-create each facet from the synopsis (--split,
        # envutil_main.cc:1679-1722); the solo facet is skipped
        for i in range(args.nfacets):
            if i == args.solo:
                continue
            out_name = args.split % i if "%" in args.split else args.split
            sub_args = parse_args(_split_argv(argv, i, out_name))
            sub_args.store_cropped = False
            sub_args.twine_setup()
            _run_job(sub_args, device)
    else:
        if args.single != -1:
            args.store_cropped = False
        _run_job(args, device)
    assets.conclude_cycle()
    return 0


def main(argv: List[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = os.environ.get("ENVUTIL_PLATFORM") or None
    if argv and argv[-1] == "++":
        from .visor import render_loop as visor_loop
        visor_loop(verbose="-v" in argv or "--verbose" in argv,
                   device=device)
        return 0
    if argv and argv[-1] == "+":
        from .serve import render_loop
        render_loop(device=device)
        return 0
    if not argv or argv[-1] != "-":
        return core(argv, device)
    # streaming mode: read argument lines from stdin, prepend the CL
    # arguments before '-' (envutil_main.cc:1948-1982)
    base = argv[:-1]
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        tokens = shlex.split(line)
        print(" " + " ".join(f"<{t}>" for t in tokens))
        core(base + tokens, device)
    print("pipe has reached EOF")
    return 0


if __name__ == "__main__":
    sys.exit(main())
