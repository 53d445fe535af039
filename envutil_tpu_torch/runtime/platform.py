"""Device selection for the port's entry points.

Counterpart of envutil_tpu/runtime/platform.py. Entry points run on
CUDA unless the caller asks for the CPU; a missing card raises instead
of falling back, so no run reports CPU work as device work.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means CUDA. Raises when
    CUDA is asked for and no card is available."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain path on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device
