"""Image input/output and colour management.

Replaces the reference's OpenImageIO edge (read_image_data
envutil_basic.h:823-986, save_array envutil_basic.h:710-817): TIFF and
LDR formats (png/jpg/...) go through imageio. EXR needs the native
OpenEXR shim, which this package does not carry yet: EXR paths raise.
All rendering arithmetic is float32 scene-linear RGB, like the
reference; sRGB<->linear conversion is built in (environment.h:524-533,
envutil_payload.cc:225-235), other colour conversions raise.
"""

from __future__ import annotations

import pathlib

import numpy as np

from ..core.conventions import FACE_NAMES


def _no_exr(path: str):
    raise NotImplementedError(
        f"{path}: EXR input/output needs the native OpenEXR shim, which "
        "the PyTorch port does not carry yet; use TIFF or PNG")


# ---------------------------------------------------------------------------
# colour management
# ---------------------------------------------------------------------------

LINEAR_NAMES = {"", "linear", "Linear", "scene_linear", "lin_rec709"}
SRGB_NAMES = {"sRGB", "srgb"}


def srgb_to_linear(v: np.ndarray) -> np.ndarray:
    """sRGB EOTF (environment.h:524-533)."""
    v = np.asarray(v, np.float32)
    return np.where(v <= 0.04045, v / 12.92,
                    ((v + 0.055) / 1.055) ** 2.4).astype(np.float32)


def linear_to_srgb(v: np.ndarray) -> np.ndarray:
    """inverse EOTF (envutil_payload.cc:225-235)."""
    v = np.asarray(v, np.float32)
    return np.where(v <= 0.0031308, 12.92 * v,
                    1.055 * np.clip(v, 0, None) ** (1.0 / 2.4) - 0.055
                    ).astype(np.float32)


def convert_colour(arr: np.ndarray, src: str, dst: str,
                   alpha_channels: bool = True) -> np.ndarray:
    """Convert between colour spaces. Linear<->sRGB is built in; other
    pairs raise. Alpha channels (last channel of 2- or
    4-channel data) are passed through untouched."""
    if src == dst or (src in LINEAR_NAMES and dst in LINEAR_NAMES):
        return arr
    nch = arr.shape[-1]
    has_alpha = alpha_channels and nch in (2, 4)
    colour = arr[..., :nch - 1] if has_alpha else arr

    if src in SRGB_NAMES and dst in LINEAR_NAMES:
        out = srgb_to_linear(colour)
    elif src in LINEAR_NAMES and dst in SRGB_NAMES:
        out = linear_to_srgb(colour)
    else:
        raise NotImplementedError(
            f"colour conversion {src!r} -> {dst!r}: the PyTorch port "
            "converts only between sRGB and linear so far")
    if has_alpha:
        out = np.concatenate([out, arr[..., -1:]], axis=-1)
    return out


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _is_exr(path: str) -> bool:
    return str(path).lower().endswith(".exr")


def _default_file_csp(path: str, arr_dtype) -> str:
    if _is_exr(path):
        return "scene_linear"
    if np.issubdtype(arr_dtype, np.floating):
        return "scene_linear"
    return "sRGB"


# camera RAW formats (the reference reads these through OIIO's libraw
# plugin, configured via --oiio raw:* keys, envutil_basic.h:843-905;
# here they go through rawpy when it is installed)
_RAW_EXTS = {".cr2", ".cr3", ".nef", ".arw", ".dng", ".orf", ".raf",
             ".rw2", ".pef", ".srw", ".raw", ".erf", ".kdc", ".mrw",
             ".nrw", ".sr2", ".srf", ".x3f", ".3fr", ".iiq"}


def _is_raw(path: str) -> bool:
    return pathlib.Path(path).suffix.lower() in _RAW_EXTS


def parse_oiio_options(options) -> list:
    """Parse --oiio plugin options in the reference's dialect
    (envutil_basic.h:843-905): each item is ``key[@TYPE]=value`` or a
    bare ``key``. Returns (key, typestring, value) triples."""
    out = []
    for attr in options or []:
        if "=" in attr:
            lhs, val = attr.split("=", 1)
        else:
            lhs, val = attr, ""
        if "@" in lhs:
            key, typ = lhs.split("@", 1)
        else:
            key, typ = lhs, ""
        out.append((key, typ, val))
    return out


def _read_raw(path: str, oiio_options, verbose: bool):
    """Decode a camera RAW via rawpy, honoring the OIIO raw:* config
    keys the reference forwards to its libraw plugin. Returns float32
    (H, W, 3) in [0,1] plus the effective colour space name."""
    try:
        import rawpy
    except ImportError as e:
        raise IOError(
            f"{path}: camera RAW input needs the 'rawpy' package, which "
            "is not installed in this environment (the reference uses "
            "OpenImageIO's libraw plugin here)") from e

    kw = dict(output_bps=16, use_camera_wb=True, no_auto_bright=True,
              gamma=(1.0, 1.0))
    csp = "scene_linear"
    for key, _typ, val in parse_oiio_options(oiio_options):
        if not key.startswith("raw:"):
            continue  # non-raw keys are handled by the caller
        sub = key[4:].lower()
        if sub == "colorspace":
            name = val.lower()
            spaces = {"srgb": rawpy.ColorSpace.sRGB,
                      "srgb-linear": rawpy.ColorSpace.sRGB,
                      "linear": rawpy.ColorSpace.raw,
                      "raw": rawpy.ColorSpace.raw,
                      "adobe": rawpy.ColorSpace.Adobe,
                      "wide": rawpy.ColorSpace.Wide,
                      "prophoto": rawpy.ColorSpace.ProPhoto,
                      "prophoto-linear": rawpy.ColorSpace.ProPhoto,
                      "xyz": rawpy.ColorSpace.XYZ,
                      "aces": rawpy.ColorSpace.ACES}
            if name in spaces:
                kw["output_color"] = spaces[name]
            if name == "srgb":
                kw["gamma"] = (2.222, 4.5)  # libraw's sRGB-ish default
                csp = "sRGB"
            elif verbose and name not in spaces:
                print(f"--oiio {key}={val}: unknown colour space, "
                      "keeping linear")
        elif sub == "use_camera_wb":
            kw["use_camera_wb"] = bool(int(val))
        elif sub == "auto_bright":
            kw["no_auto_bright"] = not bool(int(val))
        elif sub == "exposure":
            kw["exp_shift"] = float(val)
        elif sub == "user_flip":
            kw["user_flip"] = int(val)
        elif sub == "demosaic":
            try:
                kw["demosaic_algorithm"] = \
                    getattr(rawpy.DemosaicAlgorithm, val)
            except AttributeError:
                if verbose:
                    print(f"--oiio {key}={val}: unknown demosaic "
                          "algorithm, using default")
        elif sub == "highlightmode":
            kw["highlight_mode"] = int(val)
        elif verbose:
            print(f"--oiio {key}={val}: key not supported by the "
                  "rawpy backend, ignored")
    with rawpy.imread(path) as r:
        rgb = r.postprocess(**kw)
    return rgb.astype(np.float32) / 65535.0, csp


def read_image(path: str, colour_space: str = "",
               working_colour_space: str = "scene_linear",
               verbose: bool = False, oiio_options=None) -> np.ndarray:
    """Read an image file to interleaved float32 (H, W, C) in the
    working colour space. ``colour_space`` overrides the file's assumed
    colour space (the PTO 'Csp' extension / --input_colour_space).
    ``oiio_options`` is the --oiio plugin key list (reference
    envutil_basic.h:843-905); raw:* keys drive RAW decoding, other keys
    are specific to OIIO plugins this build does not use and warn."""
    if oiio_options and verbose:
        for key, typ, val in parse_oiio_options(oiio_options):
            if not key.startswith("raw:"):
                print(f"--oiio {key}"
                      + (f"@{typ}" if typ else "")
                      + f"={val}: no OIIO in this build; key has no "
                      "effect on non-RAW inputs")
    if _is_raw(path):
        arr, file_csp = _read_raw(path, oiio_options, verbose)
        csp = colour_space or file_csp
        if verbose:
            print(f"file {path} loaded: {arr.shape[1]}x{arr.shape[0]}"
                  f"#{arr.shape[2]}, colour space {csp}")
        return convert_colour(arr, csp, working_colour_space)
    if _is_exr(path):
        _no_exr(path)
    import imageio.v3 as iio
    raw = iio.imread(path)
    native_dtype = raw.dtype
    if raw.ndim == 2:
        raw = raw[..., None]
    if np.issubdtype(raw.dtype, np.integer):
        arr = raw.astype(np.float32) / float(np.iinfo(raw.dtype).max)
    else:
        arr = raw.astype(np.float32)

    csp = colour_space or _default_file_csp(path, native_dtype)
    if verbose:
        print(f"file {path} loaded: {arr.shape[1]}x{arr.shape[0]}"
              f"#{arr.shape[2]}, colour space {csp}")
    return convert_colour(arr, csp, working_colour_space)


def read_image_metadata(path: str) -> dict:
    """Glean size/channels and (for EXR) Projection/Hfov metadata
    without loading pixel data where possible."""
    meta = {}
    if _is_raw(path):
        try:
            import rawpy
        except ImportError as e:
            raise IOError(
                f"{path}: camera RAW metadata needs 'rawpy', which is "
                "not installed in this environment") from e
        with rawpy.imread(path) as r:
            s = r.sizes
        meta["width"], meta["height"] = int(s.width), int(s.height)
        meta["nchannels"] = 3
        return meta
    if _is_exr(path):
        _no_exr(path)
    import imageio.v3 as iio
    props = iio.improps(path)
    shp = props.shape
    meta["height"], meta["width"] = int(shp[0]), int(shp[1])
    meta["nchannels"] = int(shp[2]) if len(shp) > 2 else 1
    return meta



# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def save_image(path: str, arr: np.ndarray, *,
               projection_name: str = "rectilinear",
               hfov_deg: float = 90.0,
               working_colour_space: str = "scene_linear",
               output_colour_space: str = "scene_linear",
               verbose: bool = False) -> None:
    """Save (H, W, C) float32 pixels. TIFF as float32 and LDR formats
    as 8 bit via imageio; EXR raises. JPEG output is forced to sRGB like the reference
    (envutil_basic.h:787-799). A '%s' in the path for cubemap data
    stores six separate cube faces (envutil_basic.h:726-757)."""
    path = str(path)
    arr = np.ascontiguousarray(arr, np.float32)
    h, w, c = arr.shape

    if "%s" in path and projection_name in ("cubemap", "biatan6"):
        assert h == 6 * w, "cubemap output must be a 1:6 stripe"
        for i, face in enumerate(FACE_NAMES):
            save_image(path % face, arr[i * w:(i + 1) * w],
                       projection_name="rectilinear", hfov_deg=90.0,
                       working_colour_space=working_colour_space,
                       output_colour_space=output_colour_space,
                       verbose=verbose)
        return

    target_csp = output_colour_space
    lower = path.lower()
    if lower.endswith((".jpg", ".jpeg")):
        if verbose:
            print("enforcing sRGB for JPEG output")
        target_csp = "sRGB"

    out = convert_colour(arr, working_colour_space, target_csp)

    if lower.endswith(".exr"):
        _no_exr(path)
    if lower.endswith((".tif", ".tiff")):
        import imageio.v3 as iio
        iio.imwrite(path, out)
    else:
        import imageio.v3 as iio
        u8 = np.clip(out * 255.0 + 0.5, 0, 255).astype(np.uint8)
        if u8.shape[-1] == 1:
            u8 = u8[..., 0]
        iio.imwrite(path, u8)
    if verbose:
        print(f"saved {path} ({w}x{h}#{c}, {target_csp})")
