"""Argument system: CLI options, PTO consumption, derived state.

Mirrors the reference's `arguments` (envutil_basic.h:633-703) and
arguments::init (envutil_main.cc:178-1251) option-for-option: the
target inherits facet geometry (class Args extends Facet the way
`arguments : facet_base` does), angles arrive in degrees and are
converted to radians, hfov determines the extent unless --hfov 0 hands
control to explicit --x0/--x1/--y0/--y1, PTO i/p/k/c lines are
consumed with the same projection-code tables and envutil extensions
(W input-crop windows, Pano, Csp), and Eev values become per-facet
'brighten' factors (envutil_main.cc:1006-1061).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from typing import List, Optional

from ..core.conventions import PROJECTION_NAMES, Projection, parse_projection
from ..core.facet import Facet, PtoMask
from ..core.metrics import get_extent, get_step
from ..io import imgio, pto
from ..models import twining

D2R = math.pi / 180.0

# PTO projection code tables (envutil_main.cc:590-610 p-line,
# 724-740 i-line)
_P_LINE_PRJ = {0: Projection.RECTILINEAR, 1: Projection.CYLINDRICAL,
               2: Projection.SPHERICAL, 3: Projection.FISHEYE,
               4: Projection.STEREOGRAPHIC}
_I_LINE_PRJ = {0: Projection.RECTILINEAR, 1: Projection.CYLINDRICAL,
               2: Projection.FISHEYE, 3: Projection.FISHEYE,
               4: Projection.SPHERICAL, 10: Projection.STEREOGRAPHIC}


@dataclasses.dataclass
class ControlPoint:
    t: int = 0
    n: int = 0
    N: int = 0
    x: float = 0.0
    y: float = 0.0
    X: float = 0.0
    Y: float = 0.0


@dataclasses.dataclass
class Args(Facet):
    """Target geometry (inherited Facet fields) + job options."""
    verbose: bool = False
    tethered: bool = False
    output: str = ""
    split: str = ""
    synopsis: str = "panorama"
    working_colour_space: str = "scene_linear"
    input_colour_space: str = ""
    output_colour_space: str = "scene_linear"
    pto_file: str = ""
    oiio_options: List[str] = dataclasses.field(default_factory=list)
    support_min: int = 8
    tile_size: int = 64
    prefilter_degree: int = -1
    spline_degree: int = 1
    twine: int = -1
    twf_file: str = ""
    twine_normalize: bool = False
    twine_precise: bool = False
    twine_pyramid: bool = False
    precise: bool = False
    coeff_cache: str = ""
    coeff_dtype: str = "f32"
    twine_width: float = 1.0
    twine_density: float = 1.0
    twine_sigma: float = 0.0
    twine_threshold: float = 0.0
    twine_max: int = 8
    twine_spread: list = dataclasses.field(default_factory=list)
    cp_list: List[ControlPoint] = dataclasses.field(default_factory=list)
    nchannels: int = 1
    facets: List[Facet] = dataclasses.field(default_factory=list)
    pto_masks: List[PtoMask] = dataclasses.field(default_factory=list)
    store_cropped: bool = False
    p_crop_x0: int = 0
    p_crop_x1: int = 0
    p_crop_y0: int = 0
    p_crop_y1: int = 0
    solo: int = -1
    single: int = -1
    mask_for: int = -1
    out_brighten: float = 1.0
    mesh: int = 0
    shard_table: bool = False

    @property
    def nfacets(self) -> int:
        return len(self.facets)

    def as_facet(self) -> Facet:
        return self

    def _apply_pyramid(self, f) -> None:
        """Annotate one facet with its --twine_pyramid decimation level
        and rewrite its geometry to the decimated size (the loader does
        the pixel-data decimation, runtime/loader.py). Conservatively
        restricted to plain full-window mount facets - PTO planar
        transforms, masks, crops and cubemap IR keep full resolution."""
        if (f.projection in (Projection.CUBEMAP, Projection.BIATAN6)
                or f.masked != -1
                or f.has_2d_tf or f.has_translation or f.has_lens_crop
                or f.has_pto_mask or f.window_x_offset
                or f.window_y_offset or f.window_width != f.width
                or f.window_height != f.height):
            return
        mag_f = f.step / self.step
        if mag_f >= 0.5:
            return
        level = int(math.floor(math.log2(1.0 / mag_f)))
        while level > 0 and (f.width % (1 << level)
                             or f.height % (1 << level)
                             or f.width >> level < 64
                             or f.height >> level < 64):
            level -= 1
        if level == 0:
            return
        f.pyramid_level = level
        w, h = f.width >> level, f.height >> level
        f.set_geometry(f.projection, w, h, f.hfov)
        f.window_width, f.window_height = w, h
        f.window_x_offset = f.window_y_offset = 0
        if self.verbose:
            print(f"twine_pyramid: facet {f.facet_no} decimated "
                  f"{level}x2 to {w}x{h} (magnification "
                  f"{mag_f:.3f} -> {f.step / self.step:.3f})")

    # -- twine parameterization (arguments::twine_setup,
    #    envutil_main.cc:1405-1616) ------------------------------------
    def twine_setup(self) -> None:
        if self.twf_file:
            self.twine = 1
        if self.twine != -1:
            if self.twine < 0:
                self.twine = 0
            if self.twine > 0:
                assert self.twine_width > 0.0
        else:
            if self.nfacets == 1 or self.solo > 0:
                smallest = self.facets[max(self.solo, 0)].step
            else:
                smallest = min(f.step for f in self.facets)
            mag = smallest / self.step
            if self.twine_pyramid and mag < 0.5 and self.single < 0:
                # pyramid minification: box-decimate heavily minified
                # facets at load time so the residual minification
                # lands in [0.5, 1) and the twining filter shrinks to
                # <= 2x2 taps over a window-local footprint. The
                # decimation is itself the box prefilter the large
                # twine kernel would otherwise approximate tap-wise;
                # the rendered filter differs slightly from the
                # reference's K-tap twine, so this is opt-in.
                if self.nfacets == 1 or self.solo > 0:
                    cands = [self.facets[max(self.solo, 0)]]
                else:
                    cands = self.facets
                for f in cands:
                    self._apply_pyramid(f)
                if self.nfacets == 1 or self.solo > 0:
                    smallest = self.facets[max(self.solo, 0)].step
                else:
                    smallest = min(f.step for f in self.facets)
                mag = smallest / self.step
            if mag > 1.0:
                if self.spline_degree > 1:
                    if self.nfacets > 1:
                        self.twine = 3
                    elif mag < 2.0:
                        self.twine = 2
                    else:
                        self.twine = 1
                else:
                    self.twine = min(5, int(1.0 + mag))
                    self.twine_width = mag
            else:
                self.twine = min(self.twine_max, int(1.0 + 1.0 / mag))
                self.twine_width = 1.0
            if self.verbose:
                print(f"automatic twining for magnification {mag}: "
                      f"twine {self.twine} twine_width {self.twine_width}")

        if self.twine_density != 1.0:
            self.twine = int(round(self.twine * self.twine_density))
            if self.verbose:
                print(f"applied twine_density {self.twine_density}: "
                      f"twine is now {self.twine}")

        if not self.twf_file:
            self.twine_spread = twining.make_spread(
                self.twine, self.twine, self.twine_width,
                self.twine_sigma, self.twine_threshold, self.verbose)
        else:
            self.twine_spread = twining.read_twf_file(
                self.twf_file, self.twine_width, self.twine_normalize,
                self.verbose)
        if self.twine:
            assert self.twine_spread
        if self.verbose:
            print("final twining filter kernel:")
            for i, c in enumerate(self.twine_spread):
                print(f"{i}\tx:\t{c[0]}\ty:\t{c[1]}\tw:\t{c[2]}")


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="envutil",
        description="envutil_tpu: convert and create extracts from "
                    "environment images (TPU-native)")
    ap.add_argument("-v", dest="verbose", action="store_true",
                    help="Verbose output")
    ap.add_argument("--output", default="", metavar="OUTPUT",
                    help="output file name (mandatory)")
    ap.add_argument("--projection", default="rectilinear", metavar="PRJ")
    ap.add_argument("--hfov", type=float, default=90.0, metavar="ANGLE")
    ap.add_argument("--width", type=int, default=0, metavar="EXTENT")
    ap.add_argument("--height", type=int, default=0, metavar="EXTENT")
    ap.add_argument("--support_min", type=int, default=8)
    ap.add_argument("--tile_size", type=int, default=64)
    ap.add_argument("--ctc", type=int, default=0,
                    help="cubemap facets measure fov center-to-center"
                         ": convert to edge-to-edge semantics "
                         "(README.md:845-869)")
    ap.add_argument("--synopsis", default="panorama", metavar="MODE")
    ap.add_argument("--working_colour_space", default="scene_linear")
    ap.add_argument("--input_colour_space", default="")
    ap.add_argument("--output_colour_space", default="scene_linear")
    ap.add_argument("--single", type=int, default=-1, metavar="FACET")
    ap.add_argument("--split", default="", metavar="FORMAT_STRING")
    ap.add_argument("--yaw", type=float, default=0.0, metavar="ANGLE")
    ap.add_argument("--pitch", type=float, default=0.0, metavar="ANGLE")
    ap.add_argument("--roll", type=float, default=0.0, metavar="ANGLE")
    ap.add_argument("--x0", type=float, default=0.0)
    ap.add_argument("--x1", type=float, default=0.0)
    ap.add_argument("--y0", type=float, default=0.0)
    ap.add_argument("--y1", type=float, default=0.0)
    ap.add_argument("--brighten", type=float, default=1.0)
    ap.add_argument("--prefilter", type=int, default=-1, metavar="DEG")
    ap.add_argument("--degree", type=int, default=1, metavar="DEG")
    ap.add_argument("--twine", type=int, default=-1)
    ap.add_argument("--twf_file", default="")
    ap.add_argument("--twine_normalize", action="store_true")
    ap.add_argument("--twine_precise", action="store_true")
    ap.add_argument("--twine_pyramid", action="store_true",
                    help="box-decimate heavily minified facets at load "
                    "so automatic twining needs <= 2x2 taps (fast "
                    "minification; slightly different filter than the "
                    "reference's large twine kernel)")
    ap.add_argument("--precise", action="store_true",
                    help="disable approximate accelerations (pole-patch source copies)")
    ap.add_argument("--coeff_cache", default="", metavar="DIR",
                    help="persist prefiltered coefficients on disk "
                    "(restart resume; also ENVUTIL_COEFF_CACHE)")
    ap.add_argument("--coeff", dest="coeff_dtype", default="f32",
                    choices=("f32", "bf16"),
                    help="coefficient storage dtype (bf16 halves HBM "
                    "for 16K+ sources; ~45 dB)")
    ap.add_argument("--twine_width", type=float, default=1.0)
    ap.add_argument("--twine_density", type=float, default=1.0)
    ap.add_argument("--twine_sigma", type=float, default=0.0)
    ap.add_argument("--twine_threshold", type=float, default=0.0)
    ap.add_argument("--twine_max", type=int, default=8)
    ap.add_argument("--photo", action="append", default=[],
                    metavar="IMAGE")
    ap.add_argument("--facet", action="append", nargs=6, default=[],
                    metavar=("IMAGE", "PROJECTION", "HFOV", "YAW",
                             "PITCH", "ROLL"))
    ap.add_argument("--oiio", action="append", default=[],
                    metavar="OPTION")
    ap.add_argument("--pto", default="", metavar="PTOFILE")
    ap.add_argument("--pto_line", action="append", default=[],
                    metavar="LINE")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="split the render over N devices (output rows "
                         "in N bands, one a device: the first N CUDA "
                         "cards, or N CPU slots with "
                         "ENVUTIL_PLATFORM=cpu; sources replicated); "
                         "0 = single device")
    ap.add_argument("--shard_table", action="store_true",
                    help="with --mesh: split the facet coefficient "
                         "tables into row bands over the devices and "
                         "evaluate them by passing the bands round a "
                         "ring (for sources too large for one card's "
                         "memory)")
    ap.add_argument("--solo", type=int, default=-1)
    ap.add_argument("--mask_for", type=int, default=-1)
    ap.add_argument("--nchannels", type=int, default=0)
    # single-image input sugar: --input X == --facet X metadata -1 0 0 0
    ap.add_argument("--input", default="", metavar="IMAGE",
                    help="environment image input (projection/hfov from "
                         "metadata)")
    return ap


def _glean_facet_metrics(fct: Facet, read_hfov: bool,
                         read_projection: bool, verbose: bool,
                         env_aspect: bool = False) -> None:
    """Open the image to get size/channels (and optionally Projection /
    Hfov metadata - facet_spec::get_image_metrics,
    envutil_basic.h:545-630).

    ``env_aspect`` is set for ``--input`` (this framework's
    'environment image' sugar; the reference has no such argument):
    when the image carries no Projection metadatum, a 2:1 image is
    taken as a full lat/lon environment and a 1:6 vertical stripe as
    a cubemap - the two environment formats envutil is documented to
    take (envutil_main.cc:39-41). ``--photo`` keeps the reference's
    metadata-else-rectilinear-65 behavior (envutil_basic.h:607-625)."""
    name = fct.filename
    if "%s" in name:
        from ..core.conventions import FACE_NAMES
        name = fct.filename % FACE_NAMES[0]
    meta = imgio.read_image_metadata(name)
    fct.width = fct.window_width = meta["width"]
    fct.height = fct.window_height = meta["height"]
    fct.window_x_offset = fct.window_y_offset = 0
    fct.nchannels = meta["nchannels"]
    if "%s" in fct.filename:
        # six separate faces: the facet is the full 1:6 stripe
        fct.height = fct.window_height = 6 * fct.width
    inferred_hfov = None
    if read_projection:
        if "%s" in fct.filename:
            # a cubeface series is a cubemap regardless of the faces'
            # own (rectilinear) metadata (and hfov)
            fct.projection = Projection.CUBEMAP
            fct.hfov = math.pi / 2
            read_hfov = False
        elif "Projection" in meta:
            fct.projection = parse_projection(meta["Projection"])
            if verbose:
                print(f"found projection in metadata: {meta['Projection']}")
        elif env_aspect and fct.width == 2 * fct.height:
            fct.projection = Projection.SPHERICAL
            inferred_hfov = 2.0 * math.pi
            if verbose:
                print("no 'Projection' metadatum; 2:1 aspect -> "
                      "full spherical (360 degrees)")
        elif env_aspect and fct.height == 6 * fct.width:
            fct.projection = Projection.CUBEMAP
            inferred_hfov = math.pi / 2
            if verbose:
                print("no 'Projection' metadatum; 1:6 aspect -> "
                      "cubemap (90-degree faces)")
        else:
            if verbose:
                print("no 'Projection' metadatum found; assuming "
                      "'rectilinear'")
            fct.projection = Projection.RECTILINEAR
    if read_hfov:
        if "Hfov" in meta:
            fct.hfov = meta["Hfov"] * D2R
            if verbose:
                print(f"found hfov in metadata: {meta['Hfov']}")
        elif inferred_hfov is not None:
            fct.hfov = inferred_hfov
        else:
            if verbose:
                print("no 'Hfov' metadatum found; assuming 65 degrees")
            fct.hfov = 65.0 * D2R


def _consume_pto(args: Args, ns, ignore_p_line: bool):
    """PTO file + --pto_line addenda -> facets / p-line / masks / cps
    (envutil_main.cc:522-905). Returns (p_line_present, p_line_eev,
    eev_sum, eev_count, p_line geometry tuple or None)."""
    parser = pto.PtoParser()
    parser.read(ns.pto, ns.pto_line)

    for c_line in parser.lines("c"):
        args.cp_list.append(ControlPoint(
            t=pto.glean_int(c_line.get("t")),
            n=pto.glean_int(c_line.get("n")),
            N=pto.glean_int(c_line.get("N")),
            x=pto.glean_float(c_line.get("x")),
            y=pto.glean_float(c_line.get("y")),
            X=pto.glean_float(c_line.get("X")),
            Y=pto.glean_float(c_line.get("Y"))))
    if args.verbose and args.cp_list:
        print(f"PTO file contains {len(args.cp_list)} control points")

    p_line_present = False
    p_line_eev = 0.0
    p_geo = None
    if not ignore_p_line:
        for p_line in parser.lines("p"):
            p_line_present = True
            prj = _P_LINE_PRJ.get(pto.glean_int(p_line.get("f")))
            if prj is None:
                print(f"can't handle PTO projection code "
                      f"{p_line.get('f')} in p-line")
                prj = Projection.NONE
            p_geo = (prj, pto.glean_int(p_line.get("w")),
                     pto.glean_int(p_line.get("h")),
                     D2R * pto.glean_float(p_line.get("v")))
            p_line_eev = pto.glean_float(p_line.get("Eev"))
            crop = pto.parse_crop(p_line.get("S"))
            if crop:
                args.store_cropped = True
                (args.p_crop_x0, args.p_crop_x1,
                 args.p_crop_y0, args.p_crop_y1) = crop
            break  # additional p-lines ignored

    eev_sum, eev_count = 0.0, 0
    for i_line in parser.lines("i"):
        f = Facet(facet_no=len(args.facets))
        csp = pto.unquote(i_line.get("Csp")) or args.input_colour_space
        f.colour_space = csp

        pano = i_line.get("Pano")
        if pano:
            # 'unstitching' extension: this facet is an already
            # stitched panorama with the p-line's geometry
            assert p_line_present
            f.filename = pto.unquote(pano)
            f.colour_space = args.output_colour_space
            f.asset_key = f.filename
            f.projection = p_geo[0]
            f.hfov = p_geo[3]
            _glean_facet_metrics(f, False, False, args.verbose)
            if args.store_cropped:
                assert f.width == args.p_crop_x1 - args.p_crop_x0
                assert f.height == args.p_crop_y1 - args.p_crop_y0
                f.window_width, f.window_height = f.width, f.height
                f.width, f.height = p_geo[1], p_geo[2]
                f.window_x_offset = args.p_crop_x0
                f.window_y_offset = args.p_crop_y0
            args.solo = f.facet_no
        else:
            f.filename = pto.unquote(i_line.get("n"))
            f.asset_key = f.filename
            code = pto.glean_int(i_line.get("f"))
            if code not in _I_LINE_PRJ:
                raise SystemExit(f"can't handle PTO projection code "
                                 f"{code} in i-line")
            f.projection = _I_LINE_PRJ[code]
            _glean_facet_metrics(f, False, False, args.verbose)
            f.hfov = D2R * pto.glean_float(i_line.get("v"))
            window = pto.parse_crop(i_line.get("W"))
            if window:
                x0, x1, y0, y1 = window
                f.window_x_offset, f.window_y_offset = x0, y0
                f.window_width, f.window_height = x1 - x0, y1 - y0
                assert f.window_width == f.width
                assert f.window_height == f.height
                f.width = pto.glean_int(i_line.get("w"))
                f.height = pto.glean_int(i_line.get("h"))
                assert f.width and f.height

        f.yaw = D2R * pto.glean_float(i_line.get("y"))
        f.pitch = D2R * pto.glean_float(i_line.get("p"))
        f.roll = D2R * pto.glean_float(i_line.get("r"))
        f.tr_x = pto.glean_float(i_line.get("TrX"))
        f.tr_y = pto.glean_float(i_line.get("TrY"))
        f.tr_z = -pto.glean_float(i_line.get("TrZ"))
        f.tp_y = D2R * pto.glean_float(i_line.get("Tpy"))
        f.tp_p = D2R * pto.glean_float(i_line.get("Tpp"))
        f.tp_r = 0.0
        f.shear_g = pto.glean_float(i_line.get("g")) / f.height
        f.shear_t = pto.glean_float(i_line.get("t")) / f.width
        f.step = get_step(f.projection, f.width, f.height, f.hfov)
        f.extent = get_extent(f.projection, f.width, f.height, f.hfov)
        f.a = pto.glean_float(i_line.get("a"))
        f.b = pto.glean_float(i_line.get("b"))
        f.c = pto.glean_float(i_line.get("c"))
        f.h = pto.glean_float(i_line.get("d"))
        f.v = pto.glean_float(i_line.get("e"))
        f.process_geometry()
        f.brighten = pto.glean_float(i_line.get("Eev"))
        if f.brighten != 0.0:
            eev_sum += f.brighten
            eev_count += 1
        crop = pto.parse_crop(i_line.get("S"))
        if crop:
            f.has_lens_crop = True
            f.crop_x0, f.crop_x1, f.crop_y0, f.crop_y1 = crop
        args.facets.append(f)

    mask_no = 0
    for k_line in parser.lines("k"):
        image = pto.glean_int(k_line.get("i"))
        variant = pto.glean_int(k_line.get("t"))
        vx, vy = pto.parse_mask_vertices(k_line.get("p"))
        mask = PtoMask(image=image, variant=variant, vx=vx, vy=vy)
        if variant != 0:
            print(f"warning: mask type not implemented: {variant} - "
                  "this mask will be ignored")
        args.pto_masks.append(mask)
        fct = args.facets[image]
        suffix = "."
        if fct.filename == fct.asset_key:
            suffix += args.pto_file + "."
        fct.has_pto_mask = True
        fct.pto_masks.append(mask)
        fct.asset_key += suffix + str(mask_no)
        mask_no += 1

    return p_line_present, p_line_eev, eev_sum, eev_count, p_geo


def parse_args(argv: List[str]) -> Args:
    """Full init (envutil_main.cc:178-1251)."""
    ns = make_parser().parse_args(argv)
    args = Args()
    args.verbose = ns.verbose
    args.output = ns.output
    args.split = ns.split
    args.synopsis = ns.synopsis
    args.working_colour_space = ns.working_colour_space
    args.input_colour_space = ns.input_colour_space
    args.output_colour_space = ns.output_colour_space
    args.colour_space = ns.output_colour_space
    args.pto_file = ns.pto
    args.twf_file = ns.twf_file
    args.oiio_options = list(ns.oiio)
    args.prefilter_degree = ns.prefilter
    args.spline_degree = ns.degree
    args.twine = ns.twine
    args.twine_normalize = ns.twine_normalize
    args.twine_precise = ns.twine_precise
    args.twine_pyramid = ns.twine_pyramid
    args.precise = ns.precise
    args.coeff_cache = ns.coeff_cache
    args.coeff_dtype = ns.coeff_dtype
    args.twine_width = ns.twine_width
    args.twine_density = ns.twine_density
    args.twine_sigma = ns.twine_sigma
    args.twine_threshold = ns.twine_threshold
    args.twine_max = ns.twine_max
    args.support_min = ns.support_min
    args.tile_size = ns.tile_size
    args.out_brighten = ns.brighten
    args.mesh = ns.mesh
    args.shard_table = ns.shard_table

    if args.prefilter_degree < 0:
        args.prefilter_degree = args.spline_degree

    args.projection = parse_projection(ns.projection)
    hfov = ns.hfov
    x0, x1, y0, y1 = ns.x0, ns.x1, ns.y0, ns.y1
    if hfov != 0.0:
        x0 = x1 = y0 = y1 = 0.0
    width, height = ns.width, ns.height

    facet_args = list(ns.facet)
    if ns.input:
        facet_args.insert(0, [ns.input, "env_metadata", "-1", "0",
                              "0", "0"])
    for name in ns.photo:
        facet_args.append([name, "metadata", "-1", "0", "0", "0"])

    if not ns.pto and not ns.pto_line:
        assert facet_args, "no input: need --input/--facet/--photo/--pto"
    assert ns.output or ns.split, "--output (or --split) is mandatory"

    ignore_p_line = False
    if width == 0:
        width = 1024
    else:
        ignore_p_line = True

    if args.projection in (Projection.CUBEMAP, Projection.BIATAN6):
        height = 6 * width
        assert hfov >= 90.0, "cubemap output needs hfov >= 90"
    if args.projection == Projection.SPHERICAL and height == 0:
        if width & 1:
            width += 1
        height = width // 2
    if height == 0:
        height = width

    p_line_present, p_line_eev, eev_sum, eev_count, p_geo = \
        _consume_pto(args, ns, ignore_p_line)

    # free --facet arguments come after PTO facets (numbering!)
    for spec in facet_args:
        f = Facet(facet_no=len(args.facets))
        f.filename = spec[0]
        f.asset_key = f.filename
        f.colour_space = args.input_colour_space
        read_projection = spec[1] in ("metadata", "env_metadata")
        f.hfov = float(spec[2])
        read_hfov = f.hfov == -1.0
        if not read_hfov and f.hfov <= 0:
            raise SystemExit(f"facet hfov invalid: {f.hfov}")
        if not read_projection:
            f.projection = parse_projection(spec[1])
        _glean_facet_metrics(f, read_hfov, read_projection,
                             args.verbose,
                             env_aspect=spec[1] == "env_metadata")
        if not read_hfov:
            f.hfov = float(spec[2]) * D2R
        f.yaw = float(spec[3]) * D2R
        f.pitch = float(spec[4]) * D2R
        f.roll = float(spec[5]) * D2R
        f.step = get_step(f.projection, f.width, f.height, f.hfov)
        f.extent = get_extent(f.projection, f.width, f.height, f.hfov)
        f.process_geometry()
        f.brighten = 0.0
        args.facets.append(f)

    assert args.nfacets, "no facets"

    if ns.ctc:
        # center-to-center cubemaps: the reference documents the
        # manual conversion fov' = 2*atan(tan(fov/2)*(w+1)/w)
        # (README.md:845-869); --ctc applies it per cubemap facet
        for f in args.facets:
            if f.projection == Projection.CUBEMAP:
                f.hfov = 2.0 * math.atan(
                    math.tan(f.hfov / 2.0)
                    * (f.width + 1.0) / f.width)
                f.step = get_step(f.projection, f.width, f.height,
                                  f.hfov)
                f.extent = get_extent(f.projection, f.width,
                                      f.height, f.hfov)
                f.process_geometry()
                if args.verbose:
                    print(f"facet {f.facet_no}: ctc fov -> "
                          f"{f.hfov / D2R:.6f} deg edge-to-edge")

    if args.solo == -1:
        args.solo = ns.solo
    args.single = ns.single
    if args.solo != -1:
        assert args.solo < args.nfacets
    if args.single != -1:
        assert args.single < args.nfacets
    if args.nfacets == 1:
        args.solo = 0
    args.mask_for = ns.mask_for
    if args.mask_for != -1:
        assert args.mask_for < args.nfacets

    # Eev -> brighten (envutil_main.cc:1006-1061)
    args.nchannels = 1
    alpha_seen = False
    if eev_count > 0:
        eev_sum /= eev_count
    if p_line_eev != 0.0:
        eev_sum = p_line_eev
        if args.verbose:
            print(f"p-line has Eev, hence Eev out = {eev_sum}")

    for m in args.facets:
        if eev_count:
            if m.brighten == 0.0:
                m.brighten = 1.0
            else:
                m.brighten = 2.0 ** (m.brighten - eev_sum)
        else:
            m.brighten = 1.0
        if args.out_brighten != 1.0:
            m.brighten *= args.out_brighten

        if m.has_pto_mask or m.has_lens_crop:
            if m.nchannels in (1, 3):
                m.nchannels += 1
        if m.nchannels in (2, 4):
            alpha_seen = True
        args.nchannels = max(args.nchannels, m.nchannels)

        m.masked = -1 if args.mask_for == -1 else \
            (1 if m.facet_no == args.mask_for else 0)

        if args.verbose:
            print(f"facet {m.facet_no} '{m.filename}' "
                  f"{PROJECTION_NAMES[m.projection]} "
                  f"{m.width}*{m.height}#{m.nchannels} "
                  f"hfov: {m.hfov / D2R} step: {m.step}")
            print(f"orientation y:{m.yaw / D2R} p:{m.pitch / D2R} "
                  f"r:{m.roll / D2R}")
            print(f"brighten: {m.brighten}")

    if alpha_seen and args.nchannels == 3:
        print("found at least one image with transparency")
        args.nchannels = 4
    if ns.nchannels > 0:
        print("global nchannels override in arguments")
        args.nchannels = ns.nchannels
    if args.verbose:
        print(f"global nchannels set to: {args.nchannels}")

    # target geometry (envutil_main.cc:1159-1250)
    if args.single >= 0:
        fspec = args.facets[args.single]
        for field in ("projection", "hfov", "yaw", "pitch", "roll",
                      "width", "height", "window_width", "window_height",
                      "window_x_offset", "window_y_offset", "extent",
                      "step", "tr_x", "tr_y", "tr_z", "tp_y", "tp_p",
                      "tp_r", "shear_g", "shear_t", "s", "a", "b", "c",
                      "h", "v", "r_max", "cap_radius", "has_shift",
                      "has_lcp", "has_shear", "has_2d_tf",
                      "has_translation"):
            setattr(args, field, getattr(fspec, field))
        if args.verbose:
            print("using '--single' argument to set output metrics")
    elif p_line_present:
        args.projection, args.width, args.height, args.hfov = \
            p_geo[0], p_geo[1], p_geo[2], p_geo[3]
    else:
        args.hfov = hfov * D2R
        args.yaw = ns.yaw * D2R
        args.pitch = ns.pitch * D2R
        args.roll = ns.roll * D2R
        args.width, args.height = width, height

    # extent from hfov (a non-zero hfov overrides x0..y1); the step is
    # always (x1-x0)/width (envutil_main.cc:1221-1232)
    if args.hfov != 0.0:
        args.extent = get_extent(args.projection, args.width,
                                 args.height, args.hfov)
    else:
        from ..core.metrics import Extent
        args.extent = Extent(x0, x1, y0, y1)
    assert args.extent.x0 <= args.extent.x1
    assert args.extent.y0 <= args.extent.y1
    args.step = (args.extent.x1 - args.extent.x0) / args.width

    if args.verbose:
        print(f"output: {args.output}")
        print(f"output projection: {PROJECTION_NAMES[args.projection]}")
        print(f"output width: {args.width} height: {args.height}")
        print(f"virtual camera yaw: {args.yaw / D2R} "
              f"pitch: {args.pitch / D2R} roll: {args.roll / D2R}")
        print(f"x0: {args.extent.x0} x1: {args.extent.x1}")
        print(f"y0: {args.extent.y0} y1: {args.extent.y1}")
        print(f"step: {args.step}")
    return args
