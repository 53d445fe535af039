"""``correct`` comes out true for the program and false for the control
(the program on bfloat16 tables, --coeff bf16) and for each fault the
cells can have, planted in the timed path: a frame returned unwritten,
half of it left out, one answer altered where it is produced."""

import time

import pytest
import torch

from benchmark import harness as H
from benchmark.tests import tiny
from envutil_tpu_torch.runtime import fastpath as FP


def _run(tmp_path, cell, seed=31415926535, coeff=None):
    base, spec = tiny.tree(tmp_path / (coeff or "f32"))
    return H.run_cell(spec, cell, seed, 0.2, False, "cpu",
                      time.perf_counter(), base=base, coeff=coeff,
                      log=lambda *a: None)[1]


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_program_correct_control_not(tmp_path, cell):
    res = _run(tmp_path, cell)
    assert res["correct"] is True, res["checks"]
    ctl = _run(tmp_path, cell, coeff="bf16")
    assert ctl["correct"] is False, ctl["checks"]
    assert ctl["checks"]["rms_gap"]["value"] > \
        3 * res["checks"]["rms_gap"]["value"]


def _unwritten(frame):
    return torch.zeros_like(frame)


def _half(frame):
    frame[frame.shape[0] // 2:] = 0.0
    return frame


def _altered(frame):
    frame[frame.shape[0] // 3, frame.shape[1] // 3, 0] += 0.05
    return frame


@pytest.mark.parametrize("cell", ["eq_tiny.cube", "ring_tiny.pano"])
@pytest.mark.parametrize("fault", [_unwritten, _half, _altered])
def test_fault_is_not_correct(tmp_path, monkeypatch, cell, fault):
    real = FP.frame_tensor
    monkeypatch.setattr(FP, "frame_tensor",
                        lambda plan, sources, *a, **k: fault(
                            real(plan, sources, *a, **k)))
    res = _run(tmp_path, cell)
    assert res["correct"] is False, (fault.__name__, res["checks"])
    assert res["failed"] >= 1
