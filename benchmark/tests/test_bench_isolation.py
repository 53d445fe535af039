"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
the reference loads nothing of the port, and a run without a card
prints no result and exits with another code than 0."""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

PROBE = r"""
import json, sys, time
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(body):
    out = subprocess.run([sys.executable, "-c",
                          PROBE.format(root=str(ROOT), body=body)],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT, env={"PATH": "/usr/bin:/bin",
                                        "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    body = f"""
import benchmark.run
from benchmark import harness as H
from benchmark.tests import tiny
base, spec = tiny.tree({str(tmp_path)!r})
H.run_cell(spec, "ring_tiny.pano", 7, 0.1, True, "cpu", time.perf_counter(),
           base=base, log=lambda *a: None)
"""
    mods = _modules(body)
    assert "envutil_tpu_torch" in mods and "benchmark" in mods
    assert not mods & {"jax", "jaxlib", "flax", "envutil_tpu"}


def test_reference_loads_nothing_of_the_port():
    mods = _modules("import benchmark.reference.exact\n"
                    "import benchmark.check\n")
    assert not {m for m in mods if m.startswith("envutil")}
    assert not mods & {"jax", "jaxlib", "flax"}


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "equirect8k.cubemap", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], capture_output=True,
                         text=True, timeout=600, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin",
                              "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
