"""A cell's job, built through the program as its command line would.

The configuration (``configs/<name>.json``) names the facets, their
geometry and lens, the spline degree and the seeded images; the traffic
(``traffic/<name>.json``) names the render request. ``argv`` writes them
as the arguments of the program's command line; ``build`` parses those
through ``runtime/args.py`` (with ``twine_setup``), builds each facet's
source from its seeded image through ``models/environment
.make_mount_source`` with the table stored as ``--coeff`` asks, as the
loader does, and makes the plan with ``runtime/render.build_plan``.

The card's machine reads no image file (it has neither imageio nor
OpenEXR), so the header probe that the command line makes of each input
file (``io/imgio.read_image_metadata``) is answered from the
configuration while ``build`` parses (``_probe``); the pixels come from
``images``.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

# PTO i-line projection codes
_PTO_CODES = {"rectilinear": 0, "cylindrical": 1, "fisheye": 3,
              "spherical": 4, "stereographic": 10}


def _seed(seed):
    """A generator seed from any whole number (seeds may exceed 32 bits;
    a torch generator takes 64)."""
    return int(seed) % (1 << 63)


def _blur(x, sigma, axis):
    """Gaussian low-pass of ``x`` along ``axis`` (edges replicated), as a
    sum of shifted copies so that the same seed always gives the same
    image."""
    radius = int(math.ceil(3.0 * sigma))
    taps = np.exp(-0.5 * (np.arange(-radius, radius + 1) / sigma) ** 2)
    taps /= taps.sum()
    n = x.shape[axis]
    idx = torch.arange(-radius, n + radius, device=x.device).clamp_(0, n - 1)
    ext = torch.index_select(x, axis, idx)
    out = torch.zeros_like(x)
    for k, t in enumerate(taps):
        out += float(t) * ext.narrow(axis, k, n)
    return out, float(np.sqrt((taps ** 2).sum()))


def make_images(config, seed, device):
    """The facets' images, (H, W, C) float32 host arrays: seeded white
    noise made on ``device`` and low-passed to the spectrum of a
    photograph (``image.sigma_px``), around ``image.mean`` with standard
    deviation ``image.std``."""
    recipe = config["image"]
    g = torch.Generator(device=device)
    g.manual_seed(_seed(seed))
    out = []
    for spec in config["facets"]:
        x = torch.randn((spec["height"], spec["width"], spec["channels"]),
                        generator=g, device=device, dtype=torch.float32)
        gain = 1.0
        for axis in (0, 1):
            x, k = _blur(x, recipe["sigma_px"], axis)
            gain *= k
        x = recipe["mean"] + (recipe["std"] / gain) * x
        out.append(x.cpu().numpy())
        del x
    return out


def image_name(config, i):
    return f"{config['name']}_{i}.exr"


def argv(config, traffic):
    """The job as the program's command line takes it."""
    t = traffic
    out = ["--output", "frame.exr", "--projection", t["projection"],
           "--width", str(t["width"]), "--height", str(t["height"]),
           "--hfov", repr(float(t["hfov"]))]
    for k in ("yaw", "pitch", "roll"):
        out += [f"--{k}", repr(float(t.get(k, 0.0)))]
    out += ["--twine", str(t.get("twine", -1)),
            "--degree", str(config["degree"]),
            "--prefilter", str(config.get("prefilter", config["degree"])),
            "--synopsis", config.get("synopsis", "panorama"),
            "--coeff", config.get("coeff", "f32")]
    for i, f in enumerate(config["facets"]):
        name = image_name(config, i)
        angles = [repr(float(f.get(k, 0.0))) for k in ("yaw", "pitch",
                                                        "roll")]
        if any(f.get(k, 0.0) for k in "abc"):
            line = (f"i f{_PTO_CODES[f['projection']]} v{f['hfov']!r} "
                    f"y{angles[0]} p{angles[1]} r{angles[2]} "
                    + " ".join(f"{k}{float(f[k])!r}" for k in "abc"
                               if f.get(k, 0.0))
                    + f' n"{name}"')
            out += ["--pto_line", line]
        else:
            out += ["--facet", name, f["projection"], repr(float(f["hfov"])),
                    *angles]
    return out


@contextlib.contextmanager
def _probe(config):
    """Answer the command line's header probe of the configuration's
    image names from the configuration."""
    from envutil_tpu_torch.io import imgio
    sizes = {image_name(config, i): dict(width=f["width"],
                                          height=f["height"],
                                          nchannels=f["channels"])
             for i, f in enumerate(config["facets"])}
    original = imgio.read_image_metadata

    def probe(path):
        return dict(sizes[path]) if path in sizes else original(path)
    imgio.read_image_metadata = probe
    try:
        yield
    finally:
        imgio.read_image_metadata = original


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build(config, traffic, images, device, coeff=None):
    """(args, sources, plan, source_build_ms): the job parsed as the
    command line parses it, each facet's source built from its image
    and stored in the table type ``--coeff`` names (``coeff`` overrides
    the configuration's), and the plan."""
    from envutil_tpu_torch.models import environment as E
    from envutil_tpu_torch.ops import spline as S
    from envutil_tpu_torch.runtime.args import parse_args
    from envutil_tpu_torch.runtime.render import build_plan

    if coeff is not None:
        config = dict(config, coeff=coeff)
    with _probe(config):
        args = parse_args(argv(config, traffic))
    args.twine_setup()
    plan = build_plan(args, args.facets)
    sync(device)
    t0 = time.perf_counter()
    sources = []
    for i in plan.facet_indices:
        src = E.make_mount_source(args.facets[i], images[i],
                                  args.spline_degree, args.prefilter_degree,
                                  device=device)
        src.spl = S.storage_spline(src.spl, args.coeff_dtype)
        sources.append(src)
    sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    return args, sources, plan, ms
