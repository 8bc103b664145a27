"""The f32 K2 and K5's 3xTF32 operands and numerics, on the CPU.

The f32 serving kernels (``csrc/march_f32.cu``, ``csrc/merged_f32.cu`` on
``csrc/field_f32_sm90.cuh``) form every trunk and dir-layer product from
operands split into two TF32 halves, hi = rna_tf32(x) and lo =
rna_tf32(x - hi), as a_lo b_hi + a_hi b_lo + a_hi b_hi with f32 sums.  The
weights are split on the host (``fused_mlp.split_tf32``, into
``PackedParams.mats_tf32``); these tests hold that split to a numpy
emulation of ``cvt.rna.tf32.f32``, and predict the kernels' accuracy by
running K2's and K5's plain versions with a test-local 3xTF32 field.  The
card check (chip_smoke.py ``f32_kernels``, tests/test_torch_cuda.py) also
covers the tensor cores' own summation, which no CPU run emulates.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from danerf_tpu_torch.config import NeRFConfig
from danerf_tpu_torch.kernels import fused_mlp as fm
from danerf_tpu_torch.kernels import fused_render as fr
from danerf_tpu_torch.kernels.fused_mlp import pack_params, split_tf32
from danerf_tpu_torch.models.nerf import NeRF
from danerf_tpu_torch.ops.sampling import sample_pdf, sample_stratified

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
