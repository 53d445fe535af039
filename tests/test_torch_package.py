"""Package boundary of the PyTorch port: it imports neither JAX nor the
JAX package, and its entry points never fall back to the CPU."""

import math
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from envutil_tpu_torch.core.conventions import Projection
from envutil_tpu_torch.core.facet import Facet
from envutil_tpu_torch.core.metrics import get_extent, get_step
from envutil_tpu_torch.models import environment as E
from envutil_tpu_torch.runtime.args import Args
from envutil_tpu_torch.runtime.render import build_plan, render_frame

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "envutil_tpu_torch"


def test_port_imports_no_jax():
    """Import every module of the port in a fresh interpreter (the test
    process has JAX loaded by conftest.py) and check sys.modules: no JAX,
    and the modules that load ``yaml``, ``scipy`` or PyOpenColorIO when
    they need them (io/ocio.py, imgio's colour routing) load none of them
    on import."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import envutil_tpu_torch as P\n"
        "for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'envutil_tpu', 'yaml', 'scipy', "
        "'PyOpenColorIO'))\n"
        "new = ['io.ocio', 'io.colour', 'io.aces', 'io.tiles', "
        "'runtime.serve', 'runtime.visor', 'parallel.mesh']\n"
        "assert all('envutil_tpu_torch.' + m in sys.modules for m in new)\n"
        "print(len([m for m in sys.modules if m.startswith('envutil_tpu_torch')]))\n"
        "sys.exit('imported: ' + ' '.join(bad) if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[-1]) >= 37  # every module was imported


def test_port_sources_name_no_jax():
    pattern = re.compile(r"\bjax\b|\bjnp\b|envutil_tpu\.")
    files = sorted(p for p in PKG.rglob("*")
                   if p.suffix in (".py", ".cu", ".cuh", ".h", ".cc"))
    assert len(files) >= 25
    hits = [f"{p.relative_to(ROOT)}:{i}"
            for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pattern.search(line)]
    assert not hits, hits
    assert (ROOT / "chip_smoke.py").exists()
    assert not pattern.search((ROOT / "chip_smoke.py").read_text())


def test_render_frame_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device works")
    f = Facet(facet_no=0, nchannels=3)
    f.set_geometry(Projection.SPHERICAL, 32, 16, 2 * math.pi)
    f.step = get_step(Projection.SPHERICAL, 32, 16, 2 * math.pi)
    f.process_geometry()
    img = np.zeros((16, 32, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        E.make_mount_source(f, img, 1, 1)
    src = E.make_mount_source(f, img, 1, 1, device="cpu")
    a = Args()
    a.projection = Projection.RECTILINEAR
    a.width = a.height = 8
    a.hfov = math.pi / 2
    a.extent = get_extent(a.projection, 8, 8, a.hfov)
    a.twine, a.nchannels, a.solo, a.facets = 0, 3, 0, [f]
    plan = build_plan(a, [f])
    with pytest.raises(RuntimeError, match="CUDA"):
        render_frame(plan, [src])
    assert render_frame(plan, [src], device="cpu").shape == (8, 8, 3)


def test_entry_point_argtypes_match_c_signatures():
    """Every C entry point of the kernel sources (``extern "C" int
    envutil_...(...)``) is declared to ctypes with one argtype per C
    parameter, of the matching kind: a pointer, ``long long``, ``int`` or
    ``float``. ctypes cannot see a C signature, so a parameter added on
    one side only shows as a launch failure on the card."""
    import ctypes
    from envutil_tpu_torch.ops import resample as R
    kinds = {"long long": ctypes.c_longlong, "int": ctypes.c_int,
             "float": ctypes.c_float}
    declared = {name: (lib, types) for lib in R.LIBRARIES
                for name, types in lib.symbols.items()}
    found = set()
    for lib in R.LIBRARIES:
        text = lib.source.read_text()
        for name, params in re.findall(
                r'extern "C" int (\w+)\((.*?)\)\s*\{', text, re.S):
            want = [ctypes.c_void_p if "*" in p else
                    kinds[" ".join(p.split()[:-1]).replace("const ", "")]
                    for p in (q.strip() for q in params.split(","))]
            assert declared[name][0] is lib, name
            assert declared[name][1] == want, name
            found.add(name)
    assert found == set(declared)


def test_exr_and_job_modes_no_longer_raise(monkeypatch):
    """The EXR stub is gone from ``imgio``, and ``cli.main`` runs the
    streaming ('-') and tethered ('+', '++') modes instead of raising
    (the loops stubbed out; stdin empty)."""
    import io

    from envutil_tpu_torch.io import imgio
    from envutil_tpu_torch.runtime import cli, serve, visor
    assert not hasattr(imgio, "_no_exr")
    assert "_no_exr" not in (PKG / "io" / "imgio.py").read_text()
    ran = []
    monkeypatch.setattr(serve, "render_loop", lambda **kw: ran.append("+"))
    monkeypatch.setattr(visor, "render_loop", lambda **kw: ran.append("++"))
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    monkeypatch.setenv("ENVUTIL_PLATFORM", "cpu")
    for mode in ("-", "+", "++"):
        assert cli.main([mode]) == 0
    assert ran == ["+", "++"]
