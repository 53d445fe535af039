"""The benchmark of envutil_tpu_torch, the PyTorch and CUDA port: one
command runs one cell (``run.py``); BENCHMARK.json at the repository's
root lists the cells and metrics, and the files under this folder hold
each cell's configuration, traffic and limits, each metric's reader and
count, and the plain reference that decides whether a run is correct."""
