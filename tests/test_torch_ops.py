"""danerf_tpu_torch.ops against danerf_tpu.ops on the same inputs.

Inputs come from a seeded numpy generator; where the JAX function draws
random numbers, the test draws them with jax.random and passes the same draws
to the port.  Both sides compute in f32 on the CPU, so the tolerances are a
few f32 ulps unless stated otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from danerf_tpu import ops as jops
from danerf_tpu_torch import ops as tops

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def test_positional_encoding_matches():
    x = np.random.default_rng(0).normal(size=(33, 3)).astype(np.float32)
    for levels in (10, 4, 0):
        want = np.asarray(jops.positional_encoding(jnp.asarray(x), levels))
        got = tops.positional_encoding(_t(x), levels).numpy()
        # the same f32 arguments 2^i x go through two sin implementations
        np.testing.assert_allclose(got, want, atol=2e-6, err_msg=f"L={levels}")


def test_generate_rays_matches():
    c2w = tops.look_at_c2w([1.0, 2.0, 3.5], [0.0, 0.2, 0.0], [0.0, 1.0, 0.0])
    np.testing.assert_allclose(
        c2w, jops.look_at_c2w(np.array([1.0, 2.0, 3.5]), np.zeros(3) + [0, 0.2, 0],
                              np.array([0.0, 1.0, 0.0])), atol=0)
    o_j, d_j = jops.generate_rays(10, 12, 13.5, jnp.asarray(c2w))
    o_t, d_t = tops.generate_rays(10, 12, 13.5, _t(c2w))
    assert o_t.shape == (10, 12, 3) and d_t.shape == (10, 12, 3)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=0)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(d_t.numpy(), axis=-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("perturb", [False, True])
def test_sample_stratified_with_jax_jitter(perturb):
    rng = np.random.default_rng(1)
    o = rng.normal(size=(7, 3)).astype(np.float32)
    d = rng.normal(size=(7, 3)).astype(np.float32)
    key = jax.random.key(3)
    z_j, pts_j = jops.sample_stratified(key, jnp.asarray(o), jnp.asarray(d), 2.0, 6.0, 16,
                                        perturb=perturb)
    # the JAX function's jitter is one uniform draw of z's shape from `key`
    jitter = _t(jax.random.uniform(key, (7, 16), jnp.float32))
    z_t, pts_t = tops.sample_stratified(_t(o), _t(d), 2.0, 6.0, 16, perturb=perturb,
                                        rand=jitter)
    # linspace may round its last bit differently in the two libraries
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=1e-6)
    np.testing.assert_allclose(pts_t.numpy(), np.asarray(pts_j), atol=1e-5)


def test_importance_uniforms_with_jax_draw():
    key = jax.random.key(4)
    u_j = jops.sampling.importance_uniforms(key, (5,), 12, perturb=True)
    draw = _t(jax.random.uniform(key, (5, 12), jnp.float32))
    u_t = tops.importance_uniforms((5,), 12, perturb=True, rand=draw)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=1e-7)


def _pdf_inputs():
    rng = np.random.default_rng(0)
    w = rng.random((7, 16)).astype(np.float32)
    w[0, :] = 0.0
    w[0, 8] = 1.0   # a delta distribution exercises the tie and clamp paths
    w[1, :] = 0.0   # all-zero weights: a uniform CDF from the 1e-5 floor
    z = np.sort(rng.random((7, 16)).astype(np.float32) * 4 + 2, axis=-1)
    return z, w


@pytest.mark.parametrize("kind", ["centers", "jittered", "past_end"])
def test_sample_pdf_shared_u(kind):
    z, w = _pdf_inputs()
    n_imp = 24
    if kind == "centers":
        u = np.asarray(jops.sampling.importance_uniforms(None, (7,), n_imp, perturb=False))
    elif kind == "jittered":
        u = np.asarray(jops.sampling.importance_uniforms(jax.random.key(5), (7,), n_imp))
    else:
        # u at and beyond the last CDF value: the suffix is empty, cdf_above
        # is +max-float and z_above clamps to the last depth
        u = np.linspace(0.9, 1.0 + 1e-6, n_imp, dtype=np.float32)[None].repeat(7, 0)
    want = np.asarray(jops.sample_pdf(None, jnp.asarray(z), jnp.asarray(w), n_imp,
                                      u=jnp.asarray(u)))
    got = tops.sample_pdf(_t(z), _t(w), n_imp, u=_t(u)).numpy()
    assert np.all(np.isfinite(got))
    # identical bracket selections; the interpolation differs by f32 cumsum
    # rounding only
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_sample_pdf_tie_matches_searchsorted_left():
    """u exactly on a CDF value brackets as searchsorted(right=False)."""
    z = np.linspace(2.0, 6.0, 8, dtype=np.float32)[None]
    w = np.full((1, 8), 0.125, np.float32) - 1e-5      # cdf = k/8 after the floor
    u = np.array([[0.0, 0.25, 0.5, 0.75]], np.float32)
    want = np.asarray(jops.sample_pdf(None, jnp.asarray(z), jnp.asarray(w), 4,
                                      u=jnp.asarray(u)))
    got = tops.sample_pdf(_t(z), _t(w), 4, u=_t(u)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("bg", [None, (1.0, 1.0, 1.0), (0.2, 0.5, 0.9)])
def test_composite_matches(bg):
    rng = np.random.default_rng(2)
    rgb = rng.random((9, 32, 3)).astype(np.float32)
    sigma = (rng.random((9, 32)) * 4).astype(np.float32)
    z = np.sort(rng.random((9, 32)) * 4 + 2, -1).astype(np.float32)
    want = jops.composite(jnp.asarray(rgb), jnp.asarray(sigma), jnp.asarray(z), bg)
    got = tops.composite(_t(rgb), _t(sigma), _t(z), bg)
    for k in ("rgb", "depth", "acc", "weights"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-6, err_msg=k)


def test_combine_z_matches():
    rng = np.random.default_rng(3)
    o = rng.normal(size=(5, 3)).astype(np.float32)
    d = rng.normal(size=(5, 3)).astype(np.float32)
    zc = np.sort(rng.random((5, 8)), -1).astype(np.float32)
    zf = rng.random((5, 6)).astype(np.float32)
    zc[:, 3] = zf[:, 2]   # a tie between the two sets
    z_j, p_j = jops.combine_z(jnp.asarray(o), jnp.asarray(d), jnp.asarray(zc), jnp.asarray(zf))
    z_t, p_t = tops.combine_z(_t(o), _t(d), _t(zc), _t(zf))
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-6)


def test_ray_aabb_bounds_matches():
    rng = np.random.default_rng(4)
    o = (rng.normal(size=(64, 3)) * 3).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d[0] = [0.0, 0.0, 1.0]   # axis-parallel: the 1e-10 guard
    box = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
    n_j, f_j = jops.sampling.ray_aabb_bounds(jnp.asarray(o), jnp.asarray(d), box[:3],
                                             box[3:], 2.0, 6.0)
    n_t, f_t = tops.ray_aabb_bounds(_t(o), _t(d), box[:3], box[3:], 2.0, 6.0)
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), atol=1e-6)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=1e-6)


@pytest.mark.parametrize("dim,levels,include", [(3, 10, True), (3, 4, True), (1, 6, True),
                                                (3, 0, True), (3, 5, False), (2, 0, False)])
def test_encoding_output_dim_matches_jax(dim, levels, include):
    """encoding_output_dim against the JAX package's, and the width
    positional_encoding gives."""
    from danerf_tpu.ops.encoding import encoding_output_dim as j_dim
    from danerf_tpu_torch.ops import encoding_output_dim, positional_encoding

    got = encoding_output_dim(dim, levels, include)
    assert got == j_dim(dim, levels, include)
    assert positional_encoding(torch.zeros(5, dim), levels, include).shape == (5, got)
