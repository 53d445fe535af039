"""Image input/output and colour management.

Replaces the reference's OpenImageIO edge (read_image_data
envutil_basic.h:823-986, save_array envutil_basic.h:710-817): EXR goes
through the native C++ shim (io/native/envio.cc, OpenEXR scanline
files with Projection/Hfov metadata), built at first use with g++
against the system OpenEXR 3.1 and Imath 3.1 into ``_build/``
(git-ignored) and loaded with ctypes; TIFF and LDR formats
(png/jpg/...) go through imageio. All rendering arithmetic is float32
scene-linear RGB, like the reference; sRGB<->linear conversion is built
in (environment.h:524-533, envutil_payload.cc:225-235), an active
``$OCIO`` config is read by io/ocio.py, the standard RGB spaces come
from io/colour.py, and any other space needs PyOpenColorIO.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile

import numpy as np

from ..core.conventions import FACE_NAMES

_NATIVE_SRC = pathlib.Path(__file__).parent / "native" / "envio.cc"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
# the JAX package's io/native/Makefile
_CXX = ("g++", "-O2", "-fPIC", "-std=c++17", "-I/usr/include/OpenEXR",
        "-I/usr/include/Imath", "-shared")
_LIBS = ("-lOpenEXR-3_1", "-lIex-3_1", "-lIlmThread-3_1", "-lImath-3_1")
_LIB = None

_P = ctypes.c_char_p
_PP = ctypes.POINTER(ctypes.c_char_p)
_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int)
_INT = ctypes.c_int
_VOID = ctypes.c_void_p
# every C entry point of envio.cc: (argtypes, restype)
NATIVE_SYMBOLS = {
    "envio_read_exr": ([_P, ctypes.POINTER(_F), _I, _I, _I], _INT),
    "envio_read_exr_header": ([_P, _I, _I, _I], _INT),
    "envio_read_exr_string_attr": ([_P, _P, _PP], _INT),
    "envio_read_exr_float_attr": ([_P, _P, _F], _INT),
    "envio_write_exr": ([_P, _F, _INT, _INT, _INT, _PP, _PP, _INT, _PP, _F,
                         _INT], _INT),
    "envio_open_exr_in": ([_P, _I, _I, _I], _VOID),
    "envio_read_exr_scanlines": ([_VOID, _INT, _INT, _F], _INT),
    "envio_close_exr_in": ([_VOID], None),
    "envio_open_exr_out": ([_P, _INT, _INT, _INT, _PP, _PP, _INT, _PP, _F,
                            _INT], _VOID),
    "envio_write_exr_scanlines": ([_VOID, _INT, _F], _INT),
    "envio_close_exr_out": ([_VOID], _INT),
    "envio_free": ([_VOID], None),
}


def native_path() -> pathlib.Path:
    """The shim's library in ``_build/``, named by a hash of its source."""
    digest = hashlib.sha256(_NATIVE_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"envio_{digest}.so"


def _load_native():
    """The EXR shim, built with g++ at first use (into a temporary file
    renamed into place, so that concurrent processes never load a partial
    library); a failed build raises with the compiler's output."""
    global _LIB
    if _LIB is not None:
        return _LIB
    so = native_path()
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [*_CXX, "-o", tmp, str(_NATIVE_SRC), *_LIBS],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed ({proc.returncode}) building "
                    f"{_NATIVE_SRC.name}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in NATIVE_SYMBOLS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _LIB = lib
    return lib


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
    """Convert between colour spaces: an active ``$OCIO`` config first
    (io/ocio.py), then the built-in sRGB<->linear, then the built-in
    spaces of io/colour.py; other pairs require PyOpenColorIO. Alpha
    channels (last channel of 2- or 4-channel data) are passed through
    untouched."""
    if src == dst or (src in LINEAR_NAMES and dst in LINEAR_NAMES):
        return arr
    nch = arr.shape[-1]
    has_alpha = alpha_channels and nch in (2, 4)
    colour = arr[..., :nch - 1] if has_alpha else arr

    # an active $OCIO config takes precedence, like OIIO's
    # colorconvert (envutil_main.cc:396-437); io/ocio.py implements
    # the algebraic transform subset without PyOpenColorIO
    ocio_out = None
    if os.environ.get("OCIO") and colour.shape[-1] == 3:
        from . import ocio as _ocio
        ocio_out = _ocio.convert(colour, src, dst)
    if ocio_out is not None:
        out = ocio_out
    elif src in SRGB_NAMES and dst in LINEAR_NAMES:
        out = srgb_to_linear(colour)
    elif src in LINEAR_NAMES and dst in SRGB_NAMES:
        out = linear_to_srgb(colour)
    else:
        from . import colour as C
        if C.known(src) and C.known(dst) and colour.shape[-1] == 3:
            # built-in spaces (primaries + transfer, io/colour.py)
            out = C.convert(colour, src, dst)
        else:
            # anything else needs a full OCIO config
            try:
                import PyOpenColorIO as ocio
            except ImportError:
                raise ValueError(
                    f"colour conversion {src!r} -> {dst!r} is not "
                    "built in and needs an OCIO config "
                    "(PyOpenColorIO not available)") from None
            config = ocio.GetCurrentConfig()
            proc = config.getProcessor(src, dst).getDefaultCPUProcessor()
            out = np.ascontiguousarray(colour, np.float32)
            proc.applyRGB(out)
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
        lib = _load_native()
        data = ctypes.POINTER(ctypes.c_float)()
        w = ctypes.c_int()
        h = ctypes.c_int()
        c = ctypes.c_int()
        rc = lib.envio_read_exr(str(path).encode(), ctypes.byref(data),
                                ctypes.byref(w), ctypes.byref(h),
                                ctypes.byref(c))
        if rc != 0:
            raise IOError(f"failed to read EXR {path!r} (rc={rc})")
        n = h.value * w.value * c.value
        arr = np.ctypeslib.as_array(data, shape=(n,)).astype(np.float32,
                                                             copy=True)
        lib.envio_free(data)
        arr = arr.reshape(h.value, w.value, c.value)
        native_dtype = np.float32
    else:
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
        lib = _load_native()
        sval = ctypes.c_char_p()
        if lib.envio_read_exr_string_attr(str(path).encode(),
                                          b"Projection",
                                          ctypes.byref(sval)) == 0:
            meta["Projection"] = sval.value.decode()
        fval = ctypes.c_float()
        if lib.envio_read_exr_float_attr(str(path).encode(), b"Hfov",
                                         ctypes.byref(fval)) == 0:
            meta["Hfov"] = float(fval.value)
        # header-only probe: no pixel decode (the reference gleans
        # specs from the OIIO spec likewise, envutil_basic.h:545-630)
        w = ctypes.c_int()
        h = ctypes.c_int()
        c = ctypes.c_int()
        rc = lib.envio_read_exr_header(str(path).encode(),
                                       ctypes.byref(w), ctypes.byref(h),
                                       ctypes.byref(c))
        if rc != 0:
            raise IOError(f"cannot probe EXR header: {path} (rc={rc})")
        meta["width"], meta["height"] = int(w.value), int(h.value)
        meta["nchannels"] = int(c.value)
    else:
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
    """Save (H, W, C) float32 pixels. EXR via the native shim with
    Projection/Hfov metadata; TIFF as float32 and LDR formats as 8 bit
    via imageio. JPEG output is forced to sRGB like the reference
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
        lib = _load_native()
        snames = (ctypes.c_char_p * 2)(b"ImageDescription", b"Projection")
        svals = (ctypes.c_char_p * 2)(
            b"image processed by envutil_tpu_torch",
            projection_name.encode())
        fnames = (ctypes.c_char_p * 1)(b"Hfov")
        fvals = (ctypes.c_float * 1)(float(hfov_deg))
        rc = lib.envio_write_exr(
            path.encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            w, h, c, snames, svals, 2, fnames, fvals, 1)
        if rc != 0:
            raise IOError(f"failed to write EXR {path!r} (rc={rc})")
    elif lower.endswith((".tif", ".tiff")):
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
