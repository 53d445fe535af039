"""The staged window model's evaluation is bit-equal to the plain
version's on every inline case of test_torch_window.
"""

import pytest
import torch

from envutil_tpu_torch.ops import resample as R

from test_torch_window import (
    BUDGET, INLINE_CASES, TILE, inline_cases, staged_eval,
)


@pytest.mark.parametrize("name", list(INLINE_CASES))
def test_staged_evaluation_is_bit_equal_to_plain(inline_cases, name):
    coeff, degree, sx, sy, plain = inline_cases[name]
    kw = dict(degree=degree, table_shape=coeff.shape, tile=TILE)
    win = R.window_model(sx, sy, window_bytes=BUDGET, **kw)
    holds = R.window_holds(win, sx, sy, **kw)
    staged = staged_eval(coeff, win, sx, sy, degree, TILE)
    assert bool(torch.isfinite(staged[holds]).all())
    assert torch.equal(staged[holds], plain[holds])
    assert bool(staged[~holds].isnan().all())
