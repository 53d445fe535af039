"""The port's geometry (envutil_tpu_torch.core.geometry) against the JAX
package's at float64, and against the third-transcription truth
literals (tests/data/reference_semantics_truth.json).

Both packages evaluate the same closed-form expressions in float64 with
the same operation order, so they agree to a few ulps: 1e-12 absolute
on values of order 1 (1e-9 relative where divisions by near-zero z make
values large).
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from envutil_tpu.core import geometry as JG
from envutil_tpu.core.conventions import Projection as JP
from envutil_tpu_torch.core import geometry as TG
from envutil_tpu_torch.core.conventions import Projection as TP

torch.set_num_threads(1)

TOL = 1e-12
TRUTH = json.load(open(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "data",
    "reference_semantics_truth.json")))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def _np(seq):
    return [np.asarray(v, np.float64) for v in seq]


def _close(got, want, tol=TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64),
                                   rtol=1e-9, atol=tol)


def _planar_samples(proj, rng, n=257):
    if proj in (TP.CUBEMAP, TP.BIATAN6):
        return rng.uniform(-0.999, 0.999, n), rng.uniform(-5.99, 5.99, n)
    if proj == TP.SPHERICAL:
        return rng.uniform(-math.pi, math.pi, n), \
            rng.uniform(-1.5, 1.5, n)
    if proj == TP.CYLINDRICAL:
        return rng.uniform(-math.pi, math.pi, n), rng.uniform(-3, 3, n)
    if proj == TP.FISHEYE:
        return rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n)
    return rng.uniform(-2, 2, n), rng.uniform(-2, 2, n)


ALL = [p for p in TP if p != TP.NONE]


@pytest.mark.parametrize("proj", ALL, ids=[p.name.lower() for p in ALL])
def test_to_ray_to_plane_pairs(proj):
    rng = np.random.default_rng(int(proj) + 11)
    px, py = _planar_samples(proj, rng)
    want = _np(JG.to_ray(JP(int(proj)))(px, py))
    got = TG.to_ray(proj)(_t(px), _t(py))
    _close(got, want)
    # the inverse on rays spread over the sphere
    ray = rng.normal(size=(3, 257))
    ray[2] = np.abs(ray[2]) + 0.1 if proj == TP.RECTILINEAR else ray[2]
    want = _np(JG.to_plane(JP(int(proj)))(*ray))
    got = TG.to_plane(proj)(*map(_t, ray))
    _close(got, want)


def test_cubeface_maps():
    rng = np.random.default_rng(5)
    ray = rng.normal(size=(3, 1000))
    ray[:, :6] = np.eye(3).repeat(2, axis=1) * [1, -1, 1, -1, 1, -1]
    jf, jx, jy = JG.ray_to_cubeface(*ray)
    tf, tx, ty = TG.ray_to_cubeface(*map(_t, ray))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert tf.dtype == torch.int32
    _close((tx, ty), _np((jx, jy)))
    face = rng.integers(0, 6, 1000).astype(np.int32)
    _close(TG.ray_to_cubeface_fixed(*map(_t, ray), torch.from_numpy(face)),
           _np(JG.ray_to_cubeface_fixed(*ray, face)))
    fx, fy = rng.uniform(-1, 1, (2, 1000))
    _close(TG.in_face_to_ray(torch.from_numpy(face), _t(fx), _t(fy)),
           _np(JG.in_face_to_ray(face, fx, fy)))


def test_vector_helpers():
    rng = np.random.default_rng(9)
    ray = rng.normal(size=(3, 64))
    m = rng.normal(size=(3, 3))
    _close(TG.normalize(*map(_t, ray)), _np(JG.normalize(*ray)))
    _close(TG.apply_matrix(m, *map(_t, ray)),
           _np(JG.apply_matrix(m, *ray)))
