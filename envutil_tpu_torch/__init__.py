"""envutil_tpu_torch: the PyTorch/CUDA port of the JAX package
envutil_tpu, which stays beside it as the reference.

It is imported on its own: it uses PyTorch and numpy and nothing of
JAX or of the JAX package. Its hot path is hand-written CUDA for Hopper
(csrc/), built with nvcc at first use; on the CPU every kernel wrapper
runs its plain PyTorch version instead.

Package layout (mirrors envutil_tpu):
  core/      conventions, projection geometry, rotations, metrics
  ops/       b-spline prefilter/eval, the resample kernel's wrapper
  models/    steppers, environments, twining parameters
  io/        image I/O (imageio), PTO parser
  runtime/   CLI, args, asset cache, render orchestration, fast path
  csrc/      CUDA sources
"""

__version__ = "0.1.0"

from .core.conventions import Face, Projection  # noqa: F401
