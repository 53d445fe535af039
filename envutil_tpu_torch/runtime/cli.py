"""Command-line entry point of the PyTorch port (``envutil-torch``).

Counterpart of envutil_tpu/runtime/cli.py for single jobs
(envutil_main.cc:1634-1983): `envutil-torch --input in.tif --output
out.tif ...`. The job renders on CUDA unless the environment sets
``ENVUTIL_PLATFORM=cpu``, the override the JAX CLI honours too.
Streaming ('-'), tethered serve ('+', '++'), --split/--single and
--mesh wait for later slices of the port and raise.
"""

from __future__ import annotations

import os
import sys
from typing import List

from ..core.conventions import PROJECTION_NAMES
from ..io import imgio
from . import assets, loader
from .args import D2R, parse_args
from .platform import resolve_device
from .render import build_plan, render_frame

# cumulated frame rendering time (rt_cumulated, envutil_main.cc:1620)
rt_cumulated = 0.0


def _run_job(args, device) -> None:
    """One rendition: load facets, build plan, render, save."""
    global rt_cumulated
    plan = build_plan(args, args.facets)
    sources = [loader.load_source(args.facets[i], args, device)
               for i in plan.facet_indices]
    img = render_frame(plan, sources, verbose=args.verbose, device=device)
    rt_cumulated += render_frame.last_ms
    imgio.save_image(
        args.output, img,
        projection_name=PROJECTION_NAMES[args.projection],
        hfov_deg=args.hfov / D2R,
        working_colour_space=args.working_colour_space,
        output_colour_space=args.colour_space,
        verbose=args.verbose)


def core(argv: List[str], device=None) -> int:
    args = parse_args(argv)
    args.twine_setup()
    if args.split or args.single != -1:
        raise NotImplementedError(
            "--split/--single wait for the PTO slice of the PyTorch port")
    if args.mesh > 1 or args.shard_table:
        raise NotImplementedError(
            "--mesh/--shard_table wait for the multi-device slice of the "
            "PyTorch port")
    if args.mask_for != -1:
        raise NotImplementedError(
            "--mask_for waits for the masking slice of the PyTorch port")
    _run_job(args, resolve_device(device))
    assets.conclude_cycle()
    return 0


def main(argv: List[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[-1] in ("-", "+", "++"):
        raise NotImplementedError(
            "streaming ('-') and tethered serve ('+', '++') modes wait "
            "for the runtime-surfaces slice of the PyTorch port")
    return core(argv, os.environ.get("ENVUTIL_PLATFORM") or None)


if __name__ == "__main__":
    sys.exit(main())
