"""danerf_tpu_torch.models / utils.convert / config against danerf_tpu.

The JAX package's initialized params go through params_from_jax into the
port's NeRF module; inputs come from a seeded numpy generator and feed both
forwards.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from danerf_tpu.config import NeRFConfig as JaxConfig
from danerf_tpu.models import init_nerf_params, nerf_apply
from danerf_tpu_torch.config import NeRFConfig
from danerf_tpu_torch.models.nerf import NeRF
from danerf_tpu_torch.utils.convert import (load_reference_checkpoint,
                                            params_from_jax, params_to_jax)

torch.set_num_threads(2)

SMALL = dict(hidden_dim=64, num_layers=4, skip_connect_layers=(2,), appearance_dim=16,
             density_bias_init=0.5)

CASES = {
    "f32": dict(use_bf16=False),
    "bf16": dict(use_bf16=True),
    "softplus": dict(use_bf16=False, density_activation="softplus"),
    "time": dict(use_bf16=False, use_time=True),
    "no_appearance": dict(use_bf16=False, use_appearance=False),
}


def _np_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, init_nerf_params(jax.random.key(seed), jcfg))


def _inputs(n, e, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    emb = rng.normal(size=(n, e)).astype(np.float32)
    t = rng.random((n, 1)).astype(np.float32)
    return x, d, emb, t


def _module(params, over):
    model = NeRF(NeRFConfig(**SMALL, **over))
    model.load_state_dict(params_from_jax(params))
    return model


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
@pytest.mark.parametrize("with_emb", [True, False], ids=["emb", "emb_none"])
def test_forward_matches_nerf_apply(case, with_emb):
    over = CASES[case]
    jcfg = JaxConfig(**SMALL, **over)
    params = _np_params(jcfg)
    model = _module(params, over)
    x, d, emb, t = _inputs(256, jcfg.appearance_dim)
    e = emb if with_emb else None
    tt = t if jcfg.use_time else None
    rgb_j, sig_j = nerf_apply(params, jcfg, jnp.asarray(x), jnp.asarray(d),
                              None if e is None else jnp.asarray(e),
                              None if tt is None else jnp.asarray(tt))
    with torch.no_grad():
        rgb_t, sig_t = model(torch.from_numpy(x), torch.from_numpy(d),
                             None if e is None else torch.from_numpy(e),
                             None if tt is None else torch.from_numpy(tt))
    if jcfg.use_bf16:
        # bf16-rounded matmul inputs, f32 sums in another order: a sum that
        # lands next to a bf16 rounding boundary rounds the other way, one
        # bf16 ulp (2^-8 relative) in that activation and less downstream
        atol = 5e-3
    else:
        atol = 2e-5   # f32 throughout; summation order only
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=atol)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), atol=atol, rtol=atol)


def test_state_dict_uses_reference_keys_and_round_trips(tmp_path):
    jcfg = JaxConfig(**SMALL)
    params = _np_params(jcfg)
    sd = params_from_jax(params)
    model = NeRF(NeRFConfig(**SMALL))
    assert sorted(model.state_dict()) == sorted(sd)
    assert "pts_linears.2.weight" in sd and "appearance_projection.bias" in sd
    assert tuple(sd["pts_linears.2.weight"].shape) == (64, 64 + 63)   # (out, in), skip

    back = params_to_jax(sd)
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)

    # a reference-format checkpoint loads into the module as it is
    emb = torch.randn(3, jcfg.appearance_dim)
    path = tmp_path / "checkpoint_1.pt"
    torch.save({"model_state_dict": sd, "appearance_embeddings": emb, "iteration": 7}, path)
    sd2, emb2, meta = load_reference_checkpoint(str(path))
    model.load_state_dict(sd2)
    assert meta == {"iteration": 7}
    torch.testing.assert_close(emb2, emb)
    torch.testing.assert_close(model.state_dict()["rgb_linear.weight"], sd["rgb_linear.weight"])


def test_init_distribution():
    """U(+-1/sqrt(in)) weights and biases, plus density_bias_init."""
    model = NeRF(NeRFConfig(density_bias_init=0.5), torch.Generator().manual_seed(0))
    w = model.pts_linears[1].weight.detach()
    bound = 1 / np.sqrt(256)
    assert float(w.abs().max()) <= bound
    np.testing.assert_allclose(float(w.std()), bound / np.sqrt(3), rtol=0.02)
    b = model.density_head.bias.detach()
    assert 0.5 - bound <= float(b) <= 0.5 + bound


def test_config_shared_fields_equal():
    """Every field the two configs share has the same default (use_fused_train
    and use_hier_onepass among them); the TPU knobs are the only JAX fields
    the port replaces (by use_kernels)."""
    jfields = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    tfields = {f.name: f.default for f in dataclasses.fields(NeRFConfig)}
    assert {"use_fused_train", "use_hier_onepass"} <= set(jfields) & set(tfields)
    assert tfields["use_hier_onepass"] is jfields["use_hier_onepass"] is False
    tpu_knobs = {"use_pallas", "fused_composite2d"}
    assert set(jfields) - set(tfields) == tpu_knobs
    assert set(tfields) - set(jfields) == {"use_kernels"}
    for name in set(jfields) & set(tfields):
        assert jfields[name] == tfields[name], name
    j, t = JaxConfig(), NeRFConfig()
    for prop in ("pos_enc_dim", "dir_enc_dim", "time_enc_dim"):
        assert getattr(j, prop) == getattr(t, prop)
    from danerf_tpu.config import RENDER_PRESETS as JP
    from danerf_tpu_torch.config import RENDER_PRESETS as TP
    assert JP == TP
