"""The f32 tensor-core kernels' 3xTF32 operands and numerics, on the CPU.

The f32 serving kernels (``csrc/march_f32.cu``, ``csrc/merged_f32.cu`` on
``csrc/field_f32_sm90.cuh``) form every trunk and dir-layer product from
operands split into two TF32 halves, hi = rna_tf32(x) and lo =
rna_tf32(x - hi), as a_lo b_hi + a_hi b_lo + a_hi b_hi with f32 sums; so
do the f32 K3, K4, K6, K7, K8 and K9 (``csrc/march_bwd_f32.cu``,
``csrc/merged_train_f32.cu``, ``csrc/merged_bwd_f32.cu``,
``csrc/march_train_f32.cu``, ``csrc/mlp_bwd_f32.cu``,
``csrc/hier_onepass_f32.cu`` on ``csrc/field_bwd_f32_sm90.cuh``) for the
forward, the transposed chain's d_pre @ W[:, :hidden] and the dW of each
layer's hidden input.  The weights are split on the host
(``fused_mlp.split_tf32``, into ``PackedParams.mats_tf32`` and, for the
chain, ``mats_kn_tf32``); these tests hold that split to a numpy emulation
of ``cvt.rna.tf32.f32``, predict the kernels' accuracy by running their
plain versions with test-local 3xTF32 products, and hold the emulated
gradients to the JAX package's Pallas kernels (interpret mode).  The card
check (chip_smoke.py ``f32_kernels``, ``f32_bwd``,
tests/test_torch_cuda.py) also covers the tensor cores' own summation,
which no CPU run emulates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from danerf_tpu.config import NeRFConfig as JaxConfig
from danerf_tpu.kernels import fused_nerf_apply as j_fused_nerf_apply
from danerf_tpu.kernels.fused_render import (fused_hier_onepass_train,
                                             fused_hier_train_loss_grads,
                                             fused_render_rays_coarse_field,
                                             fused_render_rays_merged, fused_train_loss_grads)
from danerf_tpu.models import init_nerf_params
from danerf_tpu_torch.config import NeRFConfig
from danerf_tpu_torch.kernels import fused_mlp as fm
from danerf_tpu_torch.kernels import fused_render as fr
from danerf_tpu_torch.kernels.fused_mlp import (PackedGrads, pack_params,
                                                params_from_jax_module, split_tf32,
                                                unpack_grads)
from danerf_tpu_torch.models.nerf import NeRF
from danerf_tpu_torch.ops.sampling import importance_uniforms, sample_pdf, sample_stratified
from danerf_tpu_torch.utils.convert import params_to_jax

torch.set_num_threads(2)

F32_GAIN = 16.0   # as chip_smoke.py: the bf16 error over the f32 one, at least


def _rna_tf32_numpy(x):
    """cvt.rna.tf32.f32 emulated in float64: x rounded to 11 significant
    bits, to nearest, ties away from zero (normal inputs and zero)."""
    x = np.asarray(x, np.float32).astype(np.float64)
    m, e = np.frexp(x)                            # x = m 2^e, 0.5 <= |m| < 1
    s = np.abs(m) * 2.0 ** 11
    r = np.sign(m) * np.floor(s + 0.5)            # ties away from zero
    return np.ldexp(r, e - 11).astype(np.float32)


def _samples(seed=0, n=4096):
    """Seeded f32 values: normal spread over many binades with both signs,
    exact ties of the TF32 rounding (a 1 in the 13th bit and nothing below),
    zeros of both signs and tiny values down to 1e-30."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * np.exp2(rng.integers(-20, 20, n))).astype(np.float32)
    ties = (rng.integers(1 << 23, 1 << 24, 256, dtype=np.int64) & ~0x1FFF | 0x1000)
    ties = (ties.astype(np.float32) * np.exp2(rng.integers(-40, 10, 256) - 23.0)
            * rng.choice([-1.0, 1.0], 256)).astype(np.float32)
    tiny = (rng.uniform(1.0, 2.0, 64) * 10.0 ** rng.integers(-30, -10, 64)
            * rng.choice([-1.0, 1.0], 64)).astype(np.float32)
    return np.concatenate([x, ties, tiny, np.array([0.0, -0.0], np.float32)])


def test_split_tf32_matches_cvt_rna():
    """hi keeps no bit in its low 13 mantissa bits; hi and lo are the numpy
    emulation of cvt.rna.tf32.f32 of x and of x - hi; x - hi - lo is within
    2^-22 |x| (ties included, where rna rounds away from zero)."""
    x = _samples()
    hi, lo = split_tf32(torch.tensor(x))
    assert hi.dtype == lo.dtype == torch.float32
    bits = hi.view(torch.int32).numpy()
    assert not (bits & 0x1FFF).any()
    assert not (lo.view(torch.int32).numpy() & 0x1FFF).any()
    want_hi = _rna_tf32_numpy(x)
    np.testing.assert_array_equal(hi.numpy(), want_hi)
    np.testing.assert_array_equal(lo.numpy(), _rna_tf32_numpy(x - want_hi))
    resid = np.abs(x.astype(np.float64) - hi.numpy() - lo.numpy())
    assert (resid <= 2.0 ** -22 * np.abs(x.astype(np.float64))).all()
    # the ties went away from zero
    t = x[4096:4096 + 256]
    assert (np.abs(hi.numpy()[4096:4096 + 256]) > np.abs(t)).all()


@pytest.mark.parametrize("use_time", [False, True], ids=["no_time", "time"])
def test_pack_params_splits_the_f32_weights(use_time):
    """pack_params(use_bf16=False) lays W_hi and W_lo (mats_tf32 rows 0 and
    1) at mats' offsets and shapes, zeros elsewhere, with W_hi + W_lo
    within 2^-22 |W| of mats; bf16 packing has none."""
    over = dict(use_time=True, time_enc_levels=3) if use_time else {}
    cfg = NeRFConfig(hidden_dim=64, num_layers=4, skip_connect_layers=(2,), appearance_dim=16,
                     use_bf16=False, **over)
    model = NeRF(cfg, torch.Generator().manual_seed(0))
    packed = pack_params(model, cfg)
    split = packed.mats_tf32
    assert split.dtype == torch.float32 and tuple(split.shape) == (2, packed.mats.numel())
    covered = torch.zeros(packed.mats.numel(), dtype=torch.bool)
    for name, (off, (n, k)) in packed.mat_at.items():
        w = packed.mat(name).numpy()
        hi = split[0, off:off + n * k].view(n, k).numpy()
        lo = split[1, off:off + n * k].view(n, k).numpy()
        np.testing.assert_array_equal(hi, _rna_tf32_numpy(w), err_msg=name)
        np.testing.assert_array_equal(lo, _rna_tf32_numpy(w - hi), err_msg=name)
        err = np.abs(w.astype(np.float64) - hi - lo)
        assert (err <= 2.0 ** -22 * np.abs(w.astype(np.float64))).all(), name
        covered[off:off + n * k] = True
    assert not bool(split[:, ~covered].any())
    assert pack_params(model, cfg.replace(use_bf16=True)).mats_tf32 is None


@pytest.mark.parametrize("use_time", [False, True], ids=["no_time", "time"])
def test_pack_params_splits_the_chain_weights(use_time):
    """pack_params(use_bf16=False) lays the transposed chain's TF32 halves
    (mats_kn_tf32 rows 0 and 1, the f32 K3 and K4's B operand) in mats_kn's
    layout: W^T's hi and lo at W's offsets, each the numpy emulation of
    cvt.rna.tf32.f32 of W^T and of W^T - hi, zeros elsewhere; bf16 packing
    has none."""
    over = dict(use_time=True, time_enc_levels=3) if use_time else {}
    cfg = NeRFConfig(hidden_dim=64, num_layers=4, skip_connect_layers=(2,), appearance_dim=16,
                     use_bf16=False, **over)
    model = NeRF(cfg, torch.Generator().manual_seed(0))
    packed = pack_params(model, cfg)
    split = packed.mats_kn_tf32
    assert split.dtype == torch.float32 and tuple(split.shape) == (2, packed.mats.numel())
    covered = torch.zeros(packed.mats.numel(), dtype=torch.bool)
    for name, (off, (n, k)) in packed.mat_at.items():
        wt = packed.mat(name).t().contiguous().numpy()
        hi = split[0, off:off + n * k].view(k, n).numpy()
        lo = split[1, off:off + n * k].view(k, n).numpy()
        np.testing.assert_array_equal(hi, _rna_tf32_numpy(wt), err_msg=name)
        np.testing.assert_array_equal(lo, _rna_tf32_numpy(wt - hi), err_msg=name)
        np.testing.assert_array_equal(
            hi, packed.mats_tf32[0, off:off + n * k].view(n, k).t().numpy(), err_msg=name)
        covered[off:off + n * k] = True
    assert not bool(split[:, ~covered].any())
    assert pack_params(model, cfg.replace(use_bf16=True)).mats_kn_tf32 is None


def _field_3xtf32(packed_weights):
    """field_from_enc_plain with the trunk and dir-layer products formed as
    the f32 K2/K5 tile forms them: a_lo b_hi + a_hi b_lo + a_hi b_hi from the
    split operands, each product an f32 matmul; the appearance term and the
    heads in f32 as before."""
    tensor_core = {w.data_ptr() for w in packed_weights}
    plain_dot = fm._dot

    def dot(a, w, cdt):
        if w.data_ptr() not in tensor_core:
            return plain_dot(a, w, cdt)
        a_hi, a_lo = split_tf32(a.to(torch.float32))
        w_hi, w_lo = split_tf32(w)
        return (F.linear(a_lo, w_hi) + F.linear(a_hi, w_lo)) + F.linear(a_hi, w_hi)

    return dot


def _errs(got, want):
    """Max abs errors as chip_smoke.py's output_errs takes them (the
    field's sigma relative to max(1, |sigma|))."""
    out = {}
    for k in ("rgb", "depth", "acc", "weights", "z_vals"):
        if k in want:
            out[k] = float((got[k] - want[k]).abs().max())
    if "field" in want:
        a, b = got["field"], want["field"]
        out["field_rgb"] = float((a[:, :3] - b[:, :3]).abs().max())
        out["field_sigma"] = float(((a[:, 3] - b[:, 3]) / b[:, 3].abs().clamp_min(1.0))
                                   .abs().max())
    return out


@pytest.mark.parametrize("use_time", [False, True], ids=["no_time", "time"])
def test_3xtf32_field_predicts_f32_accuracy(monkeypatch, use_time):
    """A CPU prediction of the f32 K2 and K5's numerics: their plain versions
    run with a 3xTF32 field (``_field_3xtf32``) at the kernels' width (8 x
    256, 24 rays: K2 at 64 samples with its field, K5 at 64 + 32) land
    within PLAIN_TOL_F32 of the f32 plain outputs, and the bf16 plain
    versions' error against the same outputs is at least F32_GAIN times
    larger (the ratio chip_smoke.py takes: rgb, depth, weights and the
    field).  Measured here, without and with time: rgb within 6.0e-8 of the
    f32 plain outputs, depth 4.8e-7, weights 5.1e-8, the field's rgb and
    sigma 6.0e-8 (PLAIN_TOL_F32: 3e-6, 1e-5, 1e-6, 3e-6, 1e-6); the bf16
    error 750x (K5) to 7,800x larger.
    It leaves out the tensor cores' own summation order, which the card
    check covers."""
    cfg16 = NeRFConfig(density_bias_init=0.5, use_time=use_time)
    cfg = cfg16.replace(use_bf16=False)
    model = NeRF(cfg, torch.Generator().manual_seed(1)).requires_grad_(False)
    pk, pk16 = pack_params(model, cfg), pack_params(model, cfg16)
    n, sc, sf = 24, 64, 32
    g = torch.Generator().manual_seed(2)
    o = torch.randn(n, 3, generator=g)
    o = 4.0 * o / o.norm(dim=-1, keepdim=True)
    d = -o / 4.0 + 0.3 * torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    emb = torch.randn(n, cfg.appearance_dim, generator=g)
    t = torch.rand(n, 1, generator=g) if use_time else None
    z, _ = sample_stratified(o, d, cfg.near, cfg.far, sc, True, g)
    want = fr.march_plain(pk, cfg, o, d, emb, z, t, want_field=True)
    z_f = sample_pdf(z, want["weights"], sf, True, rand=g)
    args = (o, d, emb, z, want["field"], z_f, t)
    want5 = fr.merged_plain(pk, cfg, *args)
    bf16 = (fr.march_plain(pk16, cfg16, o, d, emb, z, t, want_field=True),
            fr.merged_plain(pk16, cfg16, *args))
    mats = [pk.mat(f"w{i}") for i in range(cfg.num_layers)] + [pk.mat("wdir")]
    calls = []
    dot = _field_3xtf32(mats)
    monkeypatch.setattr(fm, "_dot", lambda a, w, cdt: calls.append(w.shape) or dot(a, w, cdt))
    got = (fr.march_plain(pk, cfg, o, d, emb, z, t, want_field=True),
           fr.merged_plain(pk, cfg, *args))
    monkeypatch.undo()
    assert len(calls) == 2 * (cfg.num_layers + 3)   # the trunk, dir, appearance and rgb products
    for tag, g32, g16, w in (("K2", got[0], bf16[0], want), ("K5", got[1], bf16[1], want5)):
        e32, e16 = _errs(g32, w), _errs(g16, w)
        for k, v in e32.items():
            assert v <= fr.PLAIN_TOL_F32[k], (tag, k, v)
        keys = [k for k in e32 if k not in ("acc", "z_vals")]
        worst32, worst16 = max(e32[k] for k in keys), max(e16[k] for k in keys)
        assert worst16 >= F32_GAIN * worst32, (tag, worst16, worst32)
        assert e32.get("z_vals", 0.0) == 0.0


def _row_errs(got, want):
    """The per-sample field's errors as chip_smoke.py takes K1's: rgb
    absolute, sigma relative to max(1, |sigma|)."""
    (rgb, sigma), (rgb_w, sigma_w) = got, want
    return {"field_rgb": float((rgb - rgb_w).abs().max()),
            "field_sigma": float(((sigma - sigma_w) / sigma_w.abs().clamp_min(1.0))
                                 .abs().max())}


@pytest.mark.parametrize("use_time", [False, True], ids=["no_time", "time"])
def test_3xtf32_k1_predicts_f32_accuracy(monkeypatch, use_time):
    """A CPU prediction of the f32 K1's numerics (csrc/mlp_fwd_f32.cu on
    the 3xTF32 row tile): its plain version, fused_fwd_plain, with the
    trunk and dir-layer products formed by 3xTF32 (``_field_3xtf32``; the
    appearance term an unsplit f32 product, as row_app4 forms it) at the
    kernel's width (8 x 256) on the per-sample rows of 16 rays of 64
    samples (``_rows_of``: 1,024 rows), lands within PLAIN_TOL_F32's
    field_rgb and field_sigma of the f32 plain outputs, and the bf16 plain
    version's error against the same outputs is at least F32_GAIN times
    larger.  Measured here, without and with time: rgb and sigma within
    6.0e-8 of the f32 plain outputs (PLAIN_TOL_F32: 3e-6, 1e-6), the bf16
    error 8.2e-4 to 9.3e-4, ~14,000x larger.  It leaves out the tensor
    cores' own summation order, which the card check covers."""
    cfg16 = NeRFConfig(density_bias_init=0.5, use_time=use_time)
    cfg = cfg16.replace(use_bf16=False)
    model = NeRF(cfg, torch.Generator().manual_seed(6)).requires_grad_(False)
    pk, pk16 = pack_params(model, cfg), pack_params(model, cfg16)
    x, dr, er, tr = _rows_of(*_bwd_inputs(cfg, 16, 64, 7)[:5])
    want = fm.fused_fwd_plain(pk, cfg, x, dr, er, tr)
    e16 = _row_errs(fm.fused_fwd_plain(pk16, cfg16, x, dr, er, tr), want)
    calls = []
    dot = _field_3xtf32([pk.mat(f"w{i}") for i in range(cfg.num_layers)] + [pk.mat("wdir")])
    monkeypatch.setattr(fm, "_dot", lambda a, w, cdt: calls.append(w.shape) or dot(a, w, cdt))
    e32 = _row_errs(fm.fused_fwd_plain(pk, cfg, x, dr, er, tr), want)
    monkeypatch.undo()
    assert len(calls) == cfg.num_layers + 3   # the trunk, dir, appearance and rgb products
    for k, v in e32.items():
        assert v <= fr.PLAIN_TOL_F32[k], (k, v)
    assert max(e16.values()) >= F32_GAIN * max(e32.values()), (e16, e32)


# The 3xTF32-emulated K1 against the JAX f32 K1: the two packages sum in
# other orders and the emulation splits its products' operands into TF32
# halves; measured 1.2e-7 (rgb) and 6.0e-8 (sigma) at this size, the
# limit ~10x above.
K1_JAX_TOL = {"field_rgb": 1e-6, "field_sigma": 1e-6}


@pytest.mark.parametrize("use_time", [False, True], ids=["no_time", "time"])
def test_3xtf32_k1_matches_jax(monkeypatch, use_time):
    """The 3xTF32-emulated K1 (as above) against the JAX package's f32 K1,
    fused_nerf_apply with use_bf16=False (``_fused_fwd_call``'s Pallas
    kernel in interpret mode), at a small size (hidden 64, 4 layers, skip
    at 2; with time 3 levels) on the per-sample rows of 20 rays of 16
    seeded numpy samples, the weights from the JAX initialiser through
    params_from_jax: within K1_JAX_TOL (rgb absolute, sigma relative to
    max(1, |sigma|))."""
    n, s = 20, 16
    over = dict(use_time=True, time_enc_levels=3) if use_time else {}
    jcfg = JaxConfig(**SMALL, use_bf16=False, **over)
    cfg = NeRFConfig(**SMALL, use_bf16=False, **over)
    params = jax.tree.map(np.asarray, init_nerf_params(jax.random.key(8), jcfg))
    model = params_from_jax_module(params, cfg, device="cpu").requires_grad_(False)
    rng = np.random.default_rng(8)
    o = (rng.normal(size=(n, 3)) * 0.1 + [0.0, 0.0, 4.0]).astype(np.float32)
    d = (rng.normal(size=(n, 3)) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    emb = rng.normal(size=(n, cfg.appearance_dim)).astype(np.float32)
    edges = np.linspace(2.0, 6.0, s + 1, dtype=np.float32)
    z = (edges[:-1] + rng.random((n, s)) * (edges[1] - edges[0])).astype(np.float32)
    t = rng.random((n, 1)).astype(np.float32) if use_time else None
    x, dr, er, tr = _rows_of(*(torch.tensor(v) for v in (o, d, emb, z)),
                             None if t is None else torch.tensor(t))
    j_rgb, j_sigma = j_fused_nerf_apply(params, jcfg, x.numpy(), dr.numpy(), er.numpy(),
                                        t=None if tr is None else jnp.asarray(tr.numpy()))
    pk = pack_params(model, cfg)
    dot = _field_3xtf32([pk.mat(f"w{i}") for i in range(cfg.num_layers)] + [pk.mat("wdir")])
    monkeypatch.setattr(fm, "_dot", dot)
    rgb, sigma = fm.fused_fwd_plain(pk, cfg, x, dr, er, tr)
    monkeypatch.undo()
    errs = _row_errs((rgb, sigma[:, 0]), (torch.tensor(np.asarray(j_rgb)),
                                          torch.tensor(np.asarray(j_sigma))))
    for k, v in errs.items():
        assert v <= K1_JAX_TOL[k], (k, v)


# ---------------------------------------------------------------- backward

def _x3(a, b):
    """a @ b as the f32 K3/K4 tile forms it on the tensor cores: the split
    operands' three products, small terms first, f32 sums."""
    a_hi, a_lo = split_tf32(a.contiguous())
    b_hi, b_lo = split_tf32(b.contiguous())
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _field_bwd_3xtf32(cfg, packed, res, emb, g_rgb, g_sigma):
    """fused_mlp.field_bwd_plain in f32 with the products the f32 K3 and K4
    form on the tensor cores formed by _x3: the transposed chain's d_pre @
    W[:, :hidden] (trunk layers 1.. and the dir layer) and the dW of those
    layers' hidden inputs; d_pre_rgb, d_happ, demb, the heads and the narrow
    dW jobs (the encodings, the embedding, happ) in f32, as there."""
    hid = cfg.hidden_dim
    out = PackedGrads.zeros(packed)
    d_pre_rgb = g_rgb * res["rgb"] * (1.0 - res["rgb"])
    out.mat("wrgb").copy_(d_pre_rgb.t() @ res["happ"])
    out.vec("brgb").copy_(d_pre_rgb.sum(0))
    d_happ = d_pre_rgb @ packed.mat("wrgb")
    out.mat("wapp").copy_(d_happ.t() @ emb)
    out.vec("bapp").copy_(d_happ.sum(0))
    demb = d_happ @ packed.mat("wapp")
    d_hdir_pre = torch.where(res["dir_gate"], d_happ, 0.0)

    def dw(name, d_pre, a, first):
        w = out.mat(name)
        if first:   # layer 0: its input is the encoding
            w.copy_(d_pre.t() @ a)
            return
        w[:, :hid] = _x3(d_pre.t(), a[:, :hid])
        w[:, hid:] = d_pre.t() @ a[:, hid:]

    dw("wdir", d_hdir_pre, res["dcat"], False)
    out.vec("bdir").copy_(d_hdir_pre.sum(0))
    d_h = _x3(d_hdir_pre, packed.mat("wdir")[:, :hid])
    if cfg.density_activation == "softplus":
        d_sigma_pre = g_sigma * torch.sigmoid(res["sigma_pre"])
    else:
        d_sigma_pre = g_sigma * (res["sigma_pre"] > 0)
    out.vec("wd").copy_((res["h_last"] * d_sigma_pre).sum(0))
    out.vec("bd").copy_(d_sigma_pre.sum(0))
    d_h = d_h + d_sigma_pre * packed.vec("wd")
    for i in range(packed.num_layers - 1, -1, -1):
        d_pre = torch.where(res["gates"][i], d_h, 0.0)
        dw(f"w{i}", d_pre, res["ins"][i], i == 0)
        out.vec(f"b{i}").copy_(d_pre.sum(0))
        if i > 0:
            d_h = _x3(d_pre, packed.mat(f"w{i}")[:, :hid])
    return out, demb


def _emulate_3xtf32(monkeypatch, packed):
    """Route the plain versions' field and backward through the f32
    backward tile's numerics (K3, K4, K6-K9): the forward's trunk and dir-layer products by
    3xTF32 (_field_3xtf32), the backward (_field_bwd_3xtf32) on the relu
    gates of an f32 forward of the same rows (the tile's gate pass; the
    sigma gate under relu too), which the forward's outputs here do not take
    (they differ from the tile's only where a gate lies within the 3xTF32
    error of 0, by that much).  K9's plain version draws its importance
    depths from the emulated coarse weights, as the kernel draws them from
    its own.  Returns the list of 3xTF32 forward products."""
    mats = [packed.mat(f"w{i}") for i in range(packed.num_layers)] + [packed.mat("wdir")]
    calls = []
    dot, f32_dot = _field_3xtf32(mats), fm._dot
    state = {"f32": False}

    def dot_(a, w, cdt):
        if state["f32"]:
            return f32_dot(a, w, cdt)
        calls.append(w.shape)
        return dot(a, w, cdt)

    def bwd(cfg, pk, res, emb, *rest):
        hid = cfg.hidden_dim
        state["f32"] = True
        _, _, r32 = fm.field_from_enc_plain(cfg, res["ins"][0], res["dcat"][:, hid:], emb, pk,
                                            want_res=True)
        state["f32"] = False
        res = dict(res, gates=r32["gates"], dir_gate=r32["dir_gate"])
        if cfg.density_activation != "softplus":
            res["sigma_pre"] = torch.where(r32["sigma_pre"] > 0, 1.0, -1.0)
        return _field_bwd_3xtf32(cfg, pk, res, emb, *rest)
    monkeypatch.setattr(fm, "_dot", dot_)
    monkeypatch.setattr(fr, "field_bwd_plain", bwd)
    monkeypatch.setattr(fm, "field_bwd_plain", bwd)
    return calls


def _bwd_inputs(cfg, n, s, seed):
    g = torch.Generator().manual_seed(seed)
    o = torch.randn(n, 3, generator=g)
    o = 4.0 * o / o.norm(dim=-1, keepdim=True)
    d = -o / 4.0 + 0.3 * torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    emb = torch.randn(n, cfg.appearance_dim, generator=g)
    t = torch.rand(n, 1, generator=g) if cfg.use_time else None
    z, _ = sample_stratified(o, d, cfg.near, cfg.far, s, True, g)
    return o, d, emb, z, t, g


def _rows_of(o, d, emb, z, t):
    """The per-sample rows of rays: points o + z d, each ray's direction,
    embedding and time repeated over its samples."""
    s = z.shape[-1]

    def rep(v):
        return None if v is None else v[:, None].expand(-1, s, -1).reshape(-1, v.shape[-1])
    x = (o[:, None, :] + z[..., None] * d[:, None, :]).reshape(-1, 3)
    return x, rep(d), rep(emb), rep(t)


@pytest.mark.parametrize("use_time", [False, True], ids=["no_time", "time"])
@pytest.mark.parametrize("kernel", ["K3", "K4", "K6", "K7", "K8", "K9"])
def test_3xtf32_backward_predicts_f32_accuracy(monkeypatch, kernel, use_time):
    """A CPU prediction of the f32 K3, K4, K6, K7, K8 and K9's numerics:
    their plain versions with every forward, chain and dW product the tile
    forms on the tensor cores formed by 3xTF32 (``_emulate_3xtf32``), at
    the kernels' width (8 x 256, 16 rays of 64 samples; K4, K6 and K9 at 64
    + 64; K8 at their 1,024 rows), land within PLAIN_TOL_F32_BWD of the f32
    plain versions (each gradient's relative error, K9's within
    grad_rel_k9; K3's and K8's demb; K4's loss, demb and g_field; K6's demb
    and g_field under every cotangent, g_w included; K7's loss and demb;
    K9's two losses and demb),
    and the bf16 plain versions' error against the same outputs is at least
    F32_GAIN times larger (gradients and demb, as tests/test_torch_cuda.py
    _held32 takes it).  The relu gates are an f32 forward's, as the tile's
    gate pass gives them; here that forward sums in the plain version's own
    order, so no gate lies on the other side, where the card's gate pass
    (the FFMA tile's sums) may disagree with the card's plain version at an
    f32 rounding (the card check's CPU referee).  It leaves out the tensor
    cores' own summation order, which the card check covers."""
    tol = fr.PLAIN_TOL_F32_BWD
    cfg16 = NeRFConfig(density_bias_init=0.5, use_time=use_time)
    cfg = cfg16.replace(use_bf16=False)
    model = NeRF(cfg, torch.Generator().manual_seed(3)).requires_grad_(False)
    pk, pk16 = pack_params(model, cfg), pack_params(model, cfg16)
    n, sc, sf = 16, 64, 64
    o, d, emb, z, t, g = _bwd_inputs(cfg, n, sc, 4)
    grad_key, forwards = "grad_rel", 1
    if kernel == "K8":
        x, dr, er, tr = _rows_of(o, d, emb, z, t)
        g_rgb = torch.randn(x.shape[0], 3, generator=g)
        g_sig = torch.randn(x.shape[0], 1, generator=g)

        def run(p, c):
            grads, demb = fm.fused_bwd_plain(p, c, x, dr, er, g_rgb, g_sig, tr)
            return grads, {"demb": demb}
    elif kernel == "K9":
        u = importance_uniforms((n,), sf, True, rand=g)
        target = torch.rand(n, 3, generator=g)
        grad_key, forwards = "grad_rel_k9", 3   # the coarse march, the fine pass, K3's recompute

        def run(p, c):
            loss_f, loss_c, grads, demb = fr.hier_onepass_plain(p, c, o, d, emb, z, u, target, t)
            return grads, {"loss": torch.stack([loss_f, loss_c]), "demb_k4": demb}
    elif kernel == "K3":
        cot = (torch.randn(n, 3, generator=g), torch.randn(n, generator=g),
               torch.randn(n, generator=g), 0.1 * torch.randn(n, sc, generator=g),
               0.1 * torch.randn(n, 4, sc, generator=g))

        def run(p, c):
            grads, demb = fr.march_bwd_plain(p, c, o, d, emb, z, *cot, t=t)
            return grads, {"demb": demb}
    elif kernel == "K7":
        target = torch.rand(n, 3, generator=g)

        def run(p, c):
            loss, grads, demb = fr.march_train_plain(p, c, o, d, emb, z, target, t)
            return grads, {"loss": loss, "demb_k4": demb}
    elif kernel == "K6":
        coarse = fr.march_plain(pk, cfg, o, d, emb, z, t, want_field=True)
        z_f = sample_pdf(z, coarse["weights"], sf, True, rand=g)
        cot = (torch.randn(n, 3, generator=g), torch.randn(n, generator=g),
               torch.randn(n, generator=g), 0.1 * torch.randn(n, sc + sf, generator=g))
        args = (o, d, emb, z, coarse["field"], z_f, *cot)

        def run(p, c):
            grads, demb, g_field = fr.merged_bwd_plain(p, c, *args, t=t)
            return grads, {"demb": demb, "g_field_k6": g_field}
    else:
        coarse = fr.march_plain(pk, cfg, o, d, emb, z, t, want_field=True)
        z_f = sample_pdf(z, coarse["weights"], sf, True, rand=g)
        target = torch.rand(n, 3, generator=g)
        args = (o, d, emb, z, coarse["field"], z_f, target, t)

        def run(p, c):
            loss, grads, demb, g_field = fr.merged_train_plain(p, c, *args)
            return grads, {"loss": loss, "demb_k4": demb, "g_field": g_field}
    want, want16 = run(pk, cfg), run(pk16, cfg16)
    calls = _emulate_3xtf32(monkeypatch, pk)
    got = run(pk, cfg)
    monkeypatch.undo()
    # the trunk, dir, appearance and rgb products of each forward
    assert len(calls) == forwards * (cfg.num_layers + 3)

    def rel(a, b):
        return max(fr.grad_rel_errors(a, b, model).values())
    g32 = rel(got[0], want[0])
    g16 = rel(want16[0], want[0])
    assert g32 <= tol[grad_key], g32
    worst32, worst16 = [g32], [g16]
    for key, w in want[1].items():
        err = float((got[1][key] - w).abs().max())
        assert err <= tol[key], (key, err)
        if key.startswith("demb"):
            worst32.append(err)
            worst16.append(float((want16[1][key] - w).abs().max()))
    assert max(worst16) >= F32_GAIN * max(worst32), (worst16, worst32)


SMALL = dict(hidden_dim=64, num_layers=4, skip_connect_layers=(2,), appearance_dim=16,
             density_bias_init=0.5)
GRAD_RTOL, GRAD_ATOL = 1e-4, 2e-5   # tests/test_torch_train.py's f32 limits


def _assert_leaves(got, want, what):
    g = [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(got)]
    w = [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(want)]
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=f"{what} {i}")


@pytest.mark.parametrize("kernel", ["K3", "K4", "K6", "K6_time", "K7", "K8", "K8_time", "K9",
                                    "K9_time"])
def test_3xtf32_backward_matches_jax(monkeypatch, kernel):
    """The 3xTF32-emulated backward of K3, K4, K6, K7, K8 and K9 (as
    above) against the JAX package's f32 kernels in interpret mode: K3
    against jax.vjp of fused_render_rays_coarse_field (``_march_bwd_call``,
    want_field, every cotangent non-zero), K4 against
    fused_hier_train_loss_grads (``_merged_train_pallas``), K6 against
    jax.vjp of fused_render_rays_merged (``_hier_vjp_bwd``) under non-zero
    cotangents of rgb, depth, acc and the merged weights, with g_field as
    the coarse field's cotangent, K7 against fused_train_loss_grads
    (``_train_pallas``), K8 against
    jax.vjp of fused_nerf_apply (``_fused_vjp_bwd``) at the rays' 20 x 16
    sample rows under random cotangents of rgb and sigma, K9 against
    fused_hier_onepass_train (``_hier_onepass_pallas``, which draws its
    importance depths from its own coarse weights), K6, K8 and K9 also with
    time (3 time levels), use_bf16=False, at a small size (hidden 64, 4 layers,
    skip at 2, 20 rays of 16 + 8 samples, seeded numpy inputs).  Each
    gradient leaf within rtol 1e-4 + atol 2e-5 (the f32 limits of
    tests/test_torch_train.py: the two packages sum in other orders), demb
    and g_field within 2e-5, the losses within 1e-6 relative."""
    n, sc, sf = 20, 16, 8
    over = dict(use_time=True, time_enc_levels=3) if kernel.endswith("_time") else {}
    kernel = kernel.split("_")[0]
    jcfg = JaxConfig(**SMALL, use_bf16=False, **over)
    cfg = NeRFConfig(**SMALL, use_bf16=False, **over)
    params = jax.tree.map(np.asarray, init_nerf_params(jax.random.key(5), jcfg))
    model = params_from_jax_module(params, cfg, device="cpu").requires_grad_(False)
    rng = np.random.default_rng(5)
    o = (rng.normal(size=(n, 3)) * 0.1 + [0.0, 0.0, 4.0]).astype(np.float32)
    d = (rng.normal(size=(n, 3)) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    emb = rng.normal(size=(n, cfg.appearance_dim)).astype(np.float32)
    edges = np.linspace(2.0, 6.0, sc + 1, dtype=np.float32)
    z = (edges[:-1] + rng.random((n, sc)) * (edges[1] - edges[0])).astype(np.float32)
    t = rng.random((n, 1)).astype(np.float32) if cfg.use_time else None
    pk = pack_params(model, cfg)
    tt = [torch.tensor(x) for x in (o, d, emb, z)]
    _emulate_3xtf32(monkeypatch, pk)
    if kernel == "K8":
        x, dr, er, tr = (None if v is None else v.numpy() for v in
                         _rows_of(*tt, None if t is None else torch.tensor(t)))
        g_rgb = rng.normal(size=(x.shape[0], 3)).astype(np.float32)
        g_sig = rng.normal(size=x.shape[0]).astype(np.float32)
        _, vjp = jax.vjp(lambda p, e: j_fused_nerf_apply(p, jcfg, x, dr, e,
                                                         t=None if tr is None else jnp.asarray(tr)),
                         params, jnp.asarray(er))
        j_grads, j_demb = vjp((jnp.asarray(g_rgb), jnp.asarray(g_sig)))
        grads, demb = fm.fused_bwd_plain(pk, cfg, *(torch.tensor(v) for v in (x, dr, er, g_rgb,
                                                                             g_sig)),
                                         None if tr is None else torch.tensor(tr))
    elif kernel == "K9":
        u = np.sort(rng.random((n, sf)), axis=-1).astype(np.float32)
        target = rng.random((n, 3)).astype(np.float32)
        j_f, j_c, j_grads, j_demb = fused_hier_onepass_train(params, jcfg, o, d, z, u, target,
                                                             emb, t=t)
        loss_f, loss_c, grads, demb = fr.hier_onepass_plain(
            pk, cfg, *tt, torch.tensor(u), torch.tensor(target),
            None if t is None else torch.tensor(t))
        np.testing.assert_allclose(float(loss_f), float(j_f), rtol=1e-6)
        np.testing.assert_allclose(float(loss_c), float(j_c), rtol=1e-6)
    elif kernel == "K7":
        target = rng.random((n, 3)).astype(np.float32)
        j_loss, j_grads, j_demb = fused_train_loss_grads(params, jcfg, o, d, z, target, emb)
        loss, grads, demb = fr.march_train_plain(pk, cfg, *tt, torch.tensor(target))
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-6)
    elif kernel == "K6":
        jt = None if t is None else jnp.asarray(t)
        field = np.asarray(fused_render_rays_coarse_field(params, jcfg, o, d, z, emb,
                                                          t=jt)["field"])
        zf = np.sort(rng.uniform(2.0, 6.0, size=(n, sf)).astype(np.float32), axis=-1)
        cot = {"rgb": rng.normal(size=(n, 3)), "depth": rng.normal(size=n),
               "acc": rng.normal(size=n), "weights": rng.normal(size=(n, sc + sf)) * 0.3,
               "z_vals": np.zeros((n, sc + sf))}
        cot = {k: v.astype(np.float32) for k, v in cot.items()}
        _, vjp = jax.vjp(lambda p, e, f: fused_render_rays_merged(p, jcfg, o, d, z, f, zf, e,
                                                                  t=jt),
                         params, jnp.asarray(emb), jnp.asarray(field))
        j_grads, j_demb, j_gf = vjp({k: jnp.asarray(v) for k, v in cot.items()})
        grads, demb, gf = fr.merged_bwd_plain(
            pk, cfg, *tt, torch.tensor(field), torch.tensor(zf),
            *(torch.tensor(cot[k]) for k in ("rgb", "depth", "acc", "weights")),
            t=None if t is None else torch.tensor(t))
        np.testing.assert_allclose(gf.numpy(), np.asarray(j_gf), atol=GRAD_ATOL, rtol=0)
    elif kernel == "K3":
        cot = {"rgb": rng.normal(size=(n, 3)), "depth": rng.normal(size=n),
               "acc": rng.normal(size=n), "weights": rng.normal(size=(n, sc)) * 0.3,
               "field": rng.normal(size=(n, 4, sc)) * 0.3}
        cot = {k: v.astype(np.float32) for k, v in cot.items()}
        _, vjp = jax.vjp(lambda p, e: fused_render_rays_coarse_field(p, jcfg, o, d, z, e),
                         params, jnp.asarray(emb))
        j_grads, j_demb = vjp({k: jnp.asarray(v) for k, v in cot.items()})
        grads, demb = fr.march_bwd_plain(pk, cfg, *tt, *(torch.tensor(cot[k]) for k in
                                                         ("rgb", "depth", "acc", "weights",
                                                          "field")))
    else:
        field = np.asarray(fused_render_rays_coarse_field(params, jcfg, o, d, z, emb)["field"])
        zf = np.sort(rng.uniform(2.0, 6.0, size=(n, sf)).astype(np.float32), axis=-1)
        target = rng.random((n, 3)).astype(np.float32)
        j_loss, j_grads, j_demb, j_gf = fused_hier_train_loss_grads(
            params, jcfg, o, d, z, field, zf, target, emb)
        loss, grads, demb, gf = fr.merged_train_plain(pk, cfg, *tt, torch.tensor(field),
                                                      torch.tensor(zf), torch.tensor(target))
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-6)
        np.testing.assert_allclose(gf.numpy(), np.asarray(j_gf), atol=GRAD_ATOL, rtol=0)
    monkeypatch.undo()
    _assert_leaves(params_to_jax(unpack_grads(grads, model)), j_grads, f"{kernel} params")
    np.testing.assert_allclose(demb.numpy(), np.asarray(j_demb), atol=GRAD_ATOL, rtol=0)
