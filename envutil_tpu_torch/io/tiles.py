"""Out-of-core tile and scanline stores.

Counterpart of the reference's out-of-core storage layer
(zimt/tiles.h, zimt/scanlines.h): a notional raster larger than RAM is
persisted as per-tile files, individual tiles are read/written on
demand, and resident tiles are ref-counted with a bounded cache so the
render engine can stream through rasters of any size.

Mapping to the reference:

* ``Tile``            = ``tile_t`` (tiles.h:171) - one resident chunk
  with a user count.
* ``TileStore``       = ``tile_store_t``/``basic_tile_store_t``
  (tiles.h:354, 723) - per-tile files under a directory, open-tile
  ref counting, write-through on eviction.
* ``TileStore.reader``/``writer`` windows = ``tile_loader`` /
  ``tile_storer`` (tiles.h:1093, 1337): they adapt the store to the
  render engine's windowed processing, which is this framework's
  analog of zimt::process's get_t/put_t slots.
* ``LineStore``       = ``line_store_t`` (zimt/scanlines.h:55) - a
  store whose tiles are single scanlines, loading/storing through
  user callbacks (e.g. native EXR scanline I/O, see exr_line_reader /
  exr_line_writer).
* ``render_to_store`` = running zimt::process with a tile_storer as
  put_t: the frame is rendered strip-wise and streamed to disk, so
  output size is not bounded by host RAM. Each strip is a plan whose
  window is the strip and goes through ``render.render_frame``, so on
  CUDA every strip runs the kernels of the frame's route.

Like the reference (SURVEY.md L3b), the subsystem is part of the
library surface rather than a CLI mode; render_to_store is its
engine-facing integration point.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import threading
from typing import Callable, Optional, Tuple

import numpy as np

from . import imgio


class Tile:
    """One resident tile: data + user refcount (tile_t, tiles.h:171)."""

    __slots__ = ("index", "data", "nusers", "dirty", "stamp")

    def __init__(self, index, data):
        self.index = index
        self.data = data
        self.nusers = 0
        self.dirty = False
        self.stamp = 0


class TileStore:
    """A 2D raster (H, W, C) persisted as per-tile ``.npy`` files under
    a directory (basic_tile_store_t, tiles.h:723). Tiles are read and
    written on demand; ``get``/``release`` ref-count resident tiles and
    a bounded cache evicts (write-through) unused tiles in LRU order -
    the analog of the reference's open-tile accounting, which keeps
    larger-than-RAM rasters streamable (tiles.h:70-160).

    Modes: 'w' creates/overwrites (shape required), 'r' opens read-only,
    'r+' opens for update. Metadata lives in ``store.json``.
    """

    def __init__(self, directory, mode: str = "r",
                 shape: Optional[Tuple[int, int, int]] = None,
                 tile_shape: Tuple[int, int] = (256, 256),
                 dtype=np.float32, max_resident: int = 64):
        self.dir = pathlib.Path(directory)
        self.mode = mode
        self.max_resident = int(max_resident)
        self._lock = threading.Lock()
        self._clock = 0
        meta_path = self.dir / "store.json"
        if mode == "w":
            if shape is None:
                raise ValueError("mode 'w' needs a shape")
            self.shape = tuple(int(s) for s in shape)
            self.tile_shape = tuple(int(t) for t in tile_shape)
            self.dtype = np.dtype(dtype)
            self.dir.mkdir(parents=True, exist_ok=True)
            meta_path.write_text(json.dumps({
                "shape": self.shape, "tile_shape": self.tile_shape,
                "dtype": self.dtype.name}))
        elif mode in ("r", "r+"):
            meta = json.loads(meta_path.read_text())
            self.shape = tuple(meta["shape"])
            self.tile_shape = tuple(meta["tile_shape"])
            self.dtype = np.dtype(meta["dtype"])
        else:
            raise ValueError(f"bad mode {mode!r}")
        th, tw = self.tile_shape
        self.ntiles = (-(-self.shape[0] // th), -(-self.shape[1] // tw))
        self._resident = {}

    # -- tile addressing ---------------------------------------------

    def tile_path(self, iy: int, ix: int) -> pathlib.Path:
        """Per-tile filename from the tile index, mirroring the
        reference's index-derived tile filenames (tiles.h:770-788)."""
        return self.dir / f"tile_{iy:05d}_{ix:05d}.npy"

    def _tile_extent(self, iy, ix):
        th, tw = self.tile_shape
        y0, x0 = iy * th, ix * tw
        y1 = min(y0 + th, self.shape[0])
        x1 = min(x0 + tw, self.shape[1])
        return y0, y1, x0, x1

    # -- residency (ref-counted, LRU write-through) --------------------

    def get(self, iy: int, ix: int, for_write: bool = False) -> Tile:
        """Acquire a tile (incrementing its user count). Absent tile
        files read as zeros, like the reference's on-demand tiles."""
        if not (0 <= iy < self.ntiles[0] and 0 <= ix < self.ntiles[1]):
            raise IndexError((iy, ix))
        if for_write and self.mode == "r":
            raise PermissionError("read-only store")
        with self._lock:
            t = self._resident.get((iy, ix))
            if t is None:
                y0, y1, x0, x1 = self._tile_extent(iy, ix)
                path = self.tile_path(iy, ix)
                if path.exists():
                    data = np.load(path)
                else:
                    data = np.zeros((y1 - y0, x1 - x0, self.shape[2]),
                                    self.dtype)
                t = Tile((iy, ix), data)
                self._resident[(iy, ix)] = t
            t.nusers += 1
            t.dirty = t.dirty or for_write
            self._clock += 1
            t.stamp = self._clock
            return t

    def release(self, tile: Tile) -> None:
        """Drop one user; unused tiles past the cache budget are
        flushed (if dirty) and evicted, LRU first."""
        with self._lock:
            tile.nusers -= 1
            assert tile.nusers >= 0
            self._evict_locked()

    def _evict_locked(self):
        while len(self._resident) > self.max_resident:
            idle = [t for t in self._resident.values() if t.nusers == 0]
            if not idle:
                return
            victim = min(idle, key=lambda t: t.stamp)
            if victim.dirty:
                self._store_tile(victim)
            del self._resident[victim.index]

    def _store_tile(self, tile: Tile):
        np.save(self.tile_path(*tile.index), tile.data)
        tile.dirty = False

    def flush(self) -> None:
        """Write every dirty resident tile through to disk."""
        with self._lock:
            for t in self._resident.values():
                if t.dirty:
                    self._store_tile(t)

    def close(self) -> None:
        self.flush()
        with self._lock:
            self._resident.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- windowed access (tile_loader / tile_storer, tiles.h:1093/1337)

    def read_window(self, y0: int, y1: int, x0: int, x1: int
                    ) -> np.ndarray:
        """Assemble a pixel window from the covering tiles."""
        out = np.zeros((y1 - y0, x1 - x0, self.shape[2]), self.dtype)
        self._for_tiles(y0, y1, x0, x1, False,
                        lambda tile, src, dst: out.__setitem__(
                            dst, tile.data[src]))
        return out

    def write_window(self, arr: np.ndarray, y0: int, x0: int) -> None:
        """Scatter a pixel window into the covering tiles (marking
        them dirty; they hit disk on eviction/flush)."""
        y1, x1 = y0 + arr.shape[0], x0 + arr.shape[1]

        def put(tile, src, dst):
            tile.data[src] = arr[dst]
        self._for_tiles(y0, y1, x0, x1, True, put)

    def _for_tiles(self, y0, y1, x0, x1, for_write, fn):
        if not (0 <= y0 <= y1 <= self.shape[0]
                and 0 <= x0 <= x1 <= self.shape[1]):
            raise IndexError((y0, y1, x0, x1))
        th, tw = self.tile_shape
        for iy in range(y0 // th, -(-y1 // th)):
            for ix in range(x0 // tw, -(-x1 // tw)):
                ty0, ty1, tx0, tx1 = self._tile_extent(iy, ix)
                cy0, cy1 = max(y0, ty0), min(y1, ty1)
                cx0, cx1 = max(x0, tx0), min(x1, tx1)
                if cy0 >= cy1 or cx0 >= cx1:
                    continue
                tile = self.get(iy, ix, for_write)
                try:
                    src = (slice(cy0 - ty0, cy1 - ty0),
                           slice(cx0 - tx0, cx1 - tx0))
                    dst = (slice(cy0 - y0, cy1 - y0),
                           slice(cx0 - x0, cx1 - x0))
                    fn(tile, src, dst)
                finally:
                    self.release(tile)


class LineStore:
    """A store whose 'tiles' are single scanlines, loaded/stored via
    callbacks (line_store_t, zimt/scanlines.h:55-230): ``load_fn(y) ->
    (W, C) array`` and/or ``store_fn(y, line)``. Adapts scanline media
    (EXR files, sockets) to the same windowed interface as TileStore.
    """

    def __init__(self, width: int, height: int, nchannels: int,
                 load_fn: Optional[Callable] = None,
                 store_fn: Optional[Callable] = None):
        self.shape = (int(height), int(width), int(nchannels))
        self.load_fn = load_fn
        self.store_fn = store_fn

    def read_window(self, y0, y1, x0, x1) -> np.ndarray:
        if self.load_fn is None:
            raise PermissionError("write-only line store")
        lines = [np.asarray(self.load_fn(y))[x0:x1]
                 for y in range(y0, y1)]
        return np.stack(lines, axis=0)

    def write_window(self, arr: np.ndarray, y0: int, x0: int) -> None:
        if self.store_fn is None:
            raise PermissionError("read-only line store")
        if x0 != 0 or arr.shape[1] != self.shape[1]:
            raise ValueError("line store writes must span full rows")
        for i in range(arr.shape[0]):
            self.store_fn(y0 + i, arr[i])


# ---------------------------------------------------------------------------
# native EXR scanline adapters (the reference's OIIO read_scanlines /
# write_scanlines callbacks, zimt/scanlines.h:268-317)
# ---------------------------------------------------------------------------

class exr_line_reader:
    """Incremental EXR scanline reader; usable as a LineStore load_fn.
    Holds the file open, reads rows on demand (no full-image buffer)."""

    def __init__(self, path: str):
        lib = imgio._load_native()
        w = ctypes.c_int()
        h = ctypes.c_int()
        c = ctypes.c_int()
        self._h = lib.envio_open_exr_in(str(path).encode(),
                                        ctypes.byref(w), ctypes.byref(h),
                                        ctypes.byref(c))
        if not self._h:
            raise IOError(f"cannot open EXR {path!r}")
        self.width, self.height, self.nchannels = \
            w.value, h.value, c.value
        self._lib = lib

    def read(self, y0: int, n: int = 1) -> np.ndarray:
        buf = np.empty((n, self.width, self.nchannels), np.float32)
        rc = self._lib.envio_read_exr_scanlines(
            self._h, int(y0), int(n),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise IOError(f"scanline read failed (rc={rc})")
        return buf

    def __call__(self, y: int) -> np.ndarray:
        return self.read(y, 1)[0]

    def close(self):
        if self._h:
            self._lib.envio_close_exr_in(self._h)
            self._h = None

    def line_store(self) -> LineStore:
        return LineStore(self.width, self.height, self.nchannels,
                         load_fn=self)


class exr_line_writer:
    """Sequential EXR scanline writer; usable as a LineStore store_fn
    (rows must arrive top-down, like OutputFile::writePixels)."""

    def __init__(self, path: str, width: int, height: int,
                 nchannels: int, projection_name: str = "rectilinear",
                 hfov_deg: float = 90.0):
        lib = imgio._load_native()
        snames = (ctypes.c_char_p * 1)(b"Projection")
        svals = (ctypes.c_char_p * 1)(projection_name.encode())
        fnames = (ctypes.c_char_p * 1)(b"Hfov")
        fvals = (ctypes.c_float * 1)(float(hfov_deg))
        self._h = lib.envio_open_exr_out(
            str(path).encode(), int(width), int(height), int(nchannels),
            snames, svals, 1, fnames, fvals, 1)
        if not self._h:
            raise IOError(f"cannot create EXR {path!r}")
        self.width, self.height, self.nchannels = width, height, nchannels
        self._lib = lib
        self._next_y = 0

    def write(self, arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(arr, np.float32)
        rc = self._lib.envio_write_exr_scanlines(
            self._h, arr.shape[0],
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise IOError(f"scanline write failed (rc={rc})")
        self._next_y += arr.shape[0]

    def __call__(self, y: int, line: np.ndarray) -> None:
        if y != self._next_y:
            raise ValueError("EXR scanline writes must be sequential")
        self.write(line[None])

    def close(self):
        if self._h:
            rc = self._lib.envio_close_exr_out(self._h)
            self._h = None
            if rc != 0:
                raise IOError("EXR closed before all rows were written")

    def line_store(self) -> LineStore:
        return LineStore(self.width, self.height, self.nchannels,
                         store_fn=self)


# ---------------------------------------------------------------------------
# engine integration: zimt::process with a tile_storer put_t
# ---------------------------------------------------------------------------

def render_to_store(plan, sources, store, strip_rows: int = 512,
                    verbose: bool = False, device=None) -> None:
    """Render a frame strip-wise straight into a tile/line store - the
    put_t-is-a-tile_storer configuration (tiles.h:1337): output size is
    bounded by the store, not host or device RAM. Each strip renders as
    the plan with the strip as its window (``plan.crop``, which every
    route reads through ``fastpath.frame_window``) on ``device`` (CUDA
    unless the caller asks for the CPU), so a strip takes the frame's
    route and its pixels are computed from absolute pixel coordinates.
    Like the JAX package, every strip is ``strip_rows`` high: the tail
    strip is moved up to end at the window's last row and only its new
    rows are stored."""
    import dataclasses

    from ..runtime.fastpath import frame_window
    from ..runtime.render import render_frame

    y0, y1, x0, x1 = frame_window(plan)
    if store.shape[:2] != (y1 - y0, x1 - x0):
        raise ValueError("store shape does not match the plan window")

    yy = y0
    while yy < y1:
        ye = min(yy + strip_rows, y1)
        yr = yy if ye - yy == strip_rows else max(y0, ye - strip_rows)
        strip = dataclasses.replace(plan, crop=(yr, ye, x0, x1))
        out = render_frame(strip, sources, device=device)
        store.write_window(out[yy - yr:], yy - y0, 0)
        if verbose:
            print(f"stored rows {yy}..{ye}")
        yy = ye
    if hasattr(store, "flush"):
        store.flush()
