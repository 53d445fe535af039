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
    process has JAX loaded by conftest.py) and check sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import envutil_tpu_torch as P\n"
        "for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'envutil_tpu'))\n"
        "print(len([m for m in sys.modules if m.startswith('envutil_tpu_torch')]))\n"
        "sys.exit('imported: ' + ' '.join(bad) if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[-1]) >= 25  # every module was imported


def test_port_sources_name_no_jax():
    pattern = re.compile(r"\bjax\b|\bjnp\b|envutil_tpu\.")
    files = sorted(p for p in PKG.rglob("*")
                   if p.suffix in (".py", ".cu", ".cuh", ".h"))
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
