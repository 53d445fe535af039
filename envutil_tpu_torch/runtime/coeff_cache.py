"""On-disk prefiltered-coefficient cache.

Counterpart of envutil_tpu/runtime/coeff_cache.py, with its entry layout
and identity: one ``.npz`` per asset, named by a hash of the asset key,
the storage dtype (``--coeff``) and each source file's size and mtime,
so a changed source or another dtype is a miss. A spline is stored under
a prefix as ``coeff`` (a bfloat16 table as its raw 16-bit bits, which
``np.savez`` can write and read back), ``dtype`` (the table's dtype
name), ``meta`` (pad, degree, core height, core width, spherical) and
``bcs``; ``variant_names`` lists the fast-path source variants the JAX
package stores beside the main spline. The port has none (its kernels
need no rolled or pitched copies), so it writes an empty list and reads
only the main spline: an entry either package wrote serves the other. A
restarted job then skips the image read and the prefilter. A corrupt
entry is a miss.

Enabled by ``--coeff_cache DIR`` or ``ENVUTIL_COEFF_CACHE=DIR``.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
from typing import Optional

import numpy as np
import torch

from ..ops import spline as S


def cache_dir(args) -> Optional[pathlib.Path]:
    d = getattr(args, "coeff_cache", None) \
        or os.environ.get("ENVUTIL_COEFF_CACHE")
    return pathlib.Path(d) if d else None


def _entry_path(cdir: pathlib.Path, fct, key, args=None) -> pathlib.Path:
    # the stored tables carry the storage dtype (--coeff), so the entry
    # identity includes it
    ident = [repr(key),
             getattr(args, "coeff_dtype", "f32") if args else "f32"]
    # file identity: a changed source invalidates the entry
    fn = fct.filename
    names = ([fn % face for face in
              ("left", "right", "top", "bottom", "front", "back")]
             if "%s" in fn else [fn])
    for n in names:
        try:
            st = os.stat(n)
            ident.append(f"{n}:{st.st_size}:{st.st_mtime_ns}")
        except OSError:
            ident.append(f"{n}:absent")
    h = hashlib.sha256("\n".join(ident).encode()).hexdigest()[:32]
    return cdir / f"coeff_{h}.npz"


def _pack_spline(d: dict, prefix: str, spl: S.Spline2D) -> None:
    coeff = spl.coeff.detach().cpu().contiguous()
    if coeff.dtype == torch.bfloat16:
        d[prefix + "coeff"] = coeff.view(torch.int16).numpy().view(np.uint16)
        d[prefix + "dtype"] = np.array(["bfloat16"])
    else:
        d[prefix + "coeff"] = coeff.numpy()
        d[prefix + "dtype"] = np.array([d[prefix + "coeff"].dtype.name])
    d[prefix + "meta"] = np.array(
        [spl.pad, spl.degree, spl.core_shape[0], spl.core_shape[1],
         int(spl.spherical)], np.int64)
    d[prefix + "bcs"] = np.array([str(spl.bcs[0]), str(spl.bcs[1])])


def _unpack_spline(z, prefix: str, device) -> S.Spline2D:
    pad, degree, ch, cw, sph = [int(v) for v in z[prefix + "meta"]]
    bcs = tuple(str(b) for b in z[prefix + "bcs"])
    coeff = z[prefix + "coeff"]
    tag = str(z[prefix + "dtype"][0]) if prefix + "dtype" in z \
        else coeff.dtype.name
    if tag == "bfloat16":
        table = torch.from_numpy(np.array(coeff).view(np.int16)).view(
            torch.bfloat16)
    elif tag == "float32":
        table = torch.from_numpy(np.array(coeff, np.float32))
    else:
        raise ValueError(f"a {tag} table is no storage dtype of the port")
    return S.Spline2D(coeff=table.to(device), pad=pad, degree=degree,
                      bcs=bcs, core_shape=(ch, cw), spherical=bool(sph))


def load(args, fct, key, device=None) -> Optional[S.Spline2D]:
    """The main spline of the entry for ``key`` on ``device``, or None."""
    cdir = cache_dir(args)
    if cdir is None:
        return None
    path = _entry_path(cdir, fct, key, args)
    if not path.exists():
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            spl = _unpack_spline(z, "main_", device)
    except Exception:
        return None  # treat a corrupt entry as a miss
    if getattr(args, "verbose", False):
        print(f"asset {fct.asset_key}: coefficients restored from {path}")
    return spl


def store(args, fct, key, spl: S.Spline2D) -> None:
    cdir = cache_dir(args)
    if cdir is None or spl is None:
        return
    cdir.mkdir(parents=True, exist_ok=True)
    path = _entry_path(cdir, fct, key, args)
    d = {"variant_names": np.array([], dtype=str)}
    _pack_spline(d, "main_", spl)
    tmp = path.with_suffix(".tmp.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **d)
    os.replace(tmp, path)  # atomic publish (restart-safe)
    if getattr(args, "verbose", False):
        print(f"asset {fct.asset_key}: coefficients cached to {path}")
