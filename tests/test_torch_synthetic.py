"""The device ground truth of the procedural scene on the CPU:
``make_synthetic_scene(backend="torch")`` against the JAX
``make_synthetic_scene(backend="jax")`` (its jitted float32 row renderer)
and against the port's own float64 numpy path: c2ws and focal equal, images
and alphas within one level (the JAX package's own bar between its two
paths, tests/test_data.py), at two seeds, both splits, H = 48 (one row
chunk) and H = 50 (the chunk falls to a divisor of H)."""

import numpy as np
import pytest
import torch

from danerf_tpu.data.synthetic import make_synthetic_scene as jax_scene
from danerf_tpu_torch.data.synthetic import _render_gt_torch, make_synthetic_scene

torch.set_num_threads(2)


def levels_apart(a, b):
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), int((d > 0).sum())


@pytest.mark.parametrize("height", [48, 50])
@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("seed", [0, 3])
def test_device_ground_truth_matches_jax_and_numpy(seed, split, height):
    kw = dict(n_images=2, height=height, width=40, seed=seed)
    got = make_synthetic_scene(split, backend="torch", device="cpu", **kw)
    want = jax_scene(split, backend="jax", **kw)
    host = make_synthetic_scene(split, **kw)
    np.testing.assert_array_equal(got.c2ws, want.c2ws)
    assert got.focal == want.focal and (got.near, got.far, got.split) == (want.near, want.far,
                                                                         split)
    for ref in (want, host):
        for k in ("images", "alphas"):
            a, b = getattr(got, k), getattr(ref, k)
            assert a.shape == b.shape and a.dtype == np.uint8, k
            worst, n = levels_apart(a, b)
            assert worst <= 1, (k, worst, n)
    # most pixels agree exactly: a level apart only at a quantisation edge
    assert levels_apart(got.images, host.images)[1] <= 0.01 * got.images.size


def test_jax_is_an_alias_and_other_backends_are_numpy():
    kw = dict(n_images=1, height=12, width=10, n_samples=32)
    torch_scene = make_synthetic_scene(backend="torch", device="cpu", **kw)
    alias = make_synthetic_scene(backend="jax", device="cpu", **kw)
    np.testing.assert_array_equal(alias.images, torch_scene.images)
    np.testing.assert_array_equal(alias.alphas, torch_scene.alphas)
    # any other value takes the numpy path, as the JAX function does
    numpy_scene = make_synthetic_scene(**kw)
    other = make_synthetic_scene(backend="anything", **kw)
    np.testing.assert_array_equal(other.images, numpy_scene.images)
    np.testing.assert_array_equal(other.images, jax_scene(backend="anything", **kw).images)


def test_row_chunks_do_not_change_a_value():
    """Every value is a function of its own ray: chunks of 50 (the divisor of
    50 not above 100), 10 and 1 rows give the same bits."""
    c2w = make_synthetic_scene(n_images=1, height=4, width=4, n_samples=8).c2ws[0]
    runs = [_render_gt_torch(np.asarray(c2w, np.float64), 50, 12, 30.0, 2.0, 6.0, 24, 0,
                             device="cpu", row_chunk=rc) for rc in (100, 16, 1)]
    for rgb, acc in runs[1:]:
        np.testing.assert_array_equal(rgb, runs[0][0])
        np.testing.assert_array_equal(acc, runs[0][1])


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_synthetic_scene(n_images=1, height=4, width=4, backend="torch")
