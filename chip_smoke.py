"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--out DIR]

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. env      torch / CUDA versions and the card (nvidia-smi name, power limit).
2. build    compile every kernel from danerf_tpu_torch/kernels/csrc (nvcc,
            sm_90a, all sources at once); ptxas reports go to DIR/build.log.
3. kernels  at full width (default NeRFConfig: 8x256, bf16) on seeded inputs,
            each kernel against its plain PyTorch version on the card,
            within fused_render.PLAIN_TOL, at 4093 rays (a ragged tile) and
            at one 65,536-ray chunk: K2 with want_field at 64 samples
            (medium's coarse pass) and without at 32 (preview), K5 at
            64 + 64 with z_f from sample_pdf of K2's weights; and
            render_rays' kernel route against its reference route on 512
            rays.
4. bwd      the backward and training kernels against their plain versions
            at 37 rays (19 blocks, so a lost or doubled block shows) and at
            the 1024-ray training batch: K3 with every cotangent seeded
            non-zero, want_field on and off; K4 and K7 with a seeded target
            (K4's field_c from K2, z_f from sample_pdf); K6 with every
            cotangent seeded and a coarse/fine tie in z.  Per-ray outputs and
            the loss by max abs error, each parameter gradient by relative
            Frobenius error; K3 and K7 twice, which must agree bit for bit.
5. step     one training step at B = 1024 on each training path (64 + 64;
            coarse only, num_importance=0; 64 + 64 on a white background),
            each built twice from the same module, table, batch and draws:
            through the kernels and through their plain versions; the
            launches, loss, every gradient and the parameters after one Adam
            step compared.
6. render   the serving path: a seeded full-width model saved as a
            reference-format .pt, rendered by `cli.main render` (two
            400x400 medium frames, then one preview frame); launch counts
            are zeroed just before each and read just after.
7. train    the training paths through `cli.main train` on the procedural
            scene (5 warm-up steps of 64 rays, then 1024), launch counts
            zeroed just before each run: 200 steps of 64 + 64 (exactly one
            K2, K4 and K3 launch a step; then `render` of the final
            checkpoint), 100 steps of `--num_importance 0` (one K7 a step
            and nothing else), 100 steps of `--white_background` (one K2,
            K5, K6 and K3 a step); finite losses and a rising PSNR.
8. timing   CUDA-event times of every kernel and its plain version, each
            beside its bound: K2 (want_field) and K5 on a 65,536-ray chunk,
            K3, K4, K6 and K7 on a chunk and at B = 1024 (plain versions at
            B = 1024); an 800x800 medium frame end to end (median of three
            after a warm-up frame); the training step of each path at
            B = 1024 (median of 50 synchronised steps) with its rays/s and
            its kernels' share, and the device time by kernel over 10 steps
            (torch.profiler) of the 64 + 64 and the coarse-only step.

Before the last line it prints the card's name and power limit and the
{"kernels": [...]} record; the last line is the ok record.  Exits non-zero,
printing no result, when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------- bounds

PEAK_BF16 = 989e12     # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
PEAK_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s


def field_macs(cfg):
    """(MACs per sample, MACs per ray) of the field: the per-ray part is the
    appearance projection, which depends only on the ray's embedding."""
    h, half = cfg.hidden_dim, cfg.hidden_dim // 2
    per_sample = 0
    k = cfg.pos_enc_dim
    for i in range(cfg.num_layers):
        if i in cfg.skip_connect_layers and i > 0:
            k = h + cfg.pos_enc_dim
        per_sample += k * h
        k = h
    per_sample += h + (h + cfg.dir_enc_dim) * half + half * 3
    return per_sample, cfg.appearance_dim * half


def bwd_macs(cfg):
    """MACs per sample of the transposed chain after the forward: every
    weight once for dW (the appearance projection per sample, as the JAX
    kernel's dotT_a over the sample rows), plus the hidden part of each
    d_in except the first layer's (trunk layers 1.., dir, rgb, density)."""
    h, half = cfg.hidden_dim, cfg.hidden_dim // 2
    per_sample, per_ray = field_macs(cfg)
    d_w = per_sample + per_ray
    d_in = (cfg.num_layers - 1) * h * h + half * h + 3 * half + h
    return d_w + d_in


def bound_ms(flop, bytes_moved):
    t_ops, t_bytes = flop / PEAK_BF16, bytes_moved / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bound(cfg, rays, samples, bytes_moved, backward=False):
    """The least time for a kernel over rays x samples: the forward field,
    plus the transposed chain when ``backward`` (K3 recomputes the forward,
    K4 runs it once; both then run the chain: ~3 forward units), and demb's
    per-ray E x half MACs."""
    per_sample, per_ray = field_macs(cfg)
    macs = per_sample * rays * samples + per_ray * rays
    if backward:
        macs += bwd_macs(cfg) * rays * samples + per_ray * rays
    return bound_ms(2.0 * macs, bytes_moved)


def cuda_ms(fn, iters, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- inputs

def make_model(cfg, seed, device):
    import torch

    from danerf_tpu_torch.models.nerf import NeRF

    model = NeRF(cfg, torch.Generator().manual_seed(seed))
    return model.to(device).eval().requires_grad_(False)


def make_rays(n, cfg, seed, device, samples=None, perturb=True):
    """Rays from a radius-4 sphere aimed near the origin, their stratified
    depths (``samples`` per ray, jittered when ``perturb``) and per-ray
    embeddings."""
    import torch

    from danerf_tpu_torch.ops.sampling import sample_stratified

    g = torch.Generator(device=device).manual_seed(seed)
    o = torch.randn(n, 3, generator=g, device=device)
    o = 4.0 * o / o.norm(dim=-1, keepdim=True)
    d = -o / 4.0 + 0.3 * torch.randn(n, 3, generator=g, device=device)
    d = d / d.norm(dim=-1, keepdim=True)
    emb = torch.randn(n, cfg.appearance_dim, generator=g, device=device)
    z, _ = sample_stratified(o, d, cfg.near, cfg.far, samples or cfg.num_samples, perturb, g)
    return o, d, emb, z


# ---------------------------------------------------------------- phases

def phase_env():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi})
    return smi


def phase_build(out_dir):
    from danerf_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build(force=True)
    secs = time.perf_counter() - t0
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        for name, log in logs.items():
            f.write(f"==== {name}.cu\n{log}\n")
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln] for n, log in logs.items()}
    emit({"phase": "build", "seconds": secs, "built": sorted(logs), "ptxas": ptxas})


def compare(errs, failures, tag, got, want, keys):
    """Record the max abs error of each output against PLAIN_TOL."""
    from danerf_tpu_torch.kernels.fused_render import PLAIN_TOL

    for k in keys:
        if k == "field":
            pairs = {"field_rgb": (got[k][:, :3], want[k][:, :3]),
                     # sigma is unbounded: its error is taken relative to max(1, |sigma|)
                     "field_sigma": ((got[k][:, 3] - want[k][:, 3])
                                     / want[k][:, 3].abs().clamp_min(1.0), 0 * want[k][:, 3])}
        else:
            pairs = {k: (got[k], want[k])}
        for name, (a, b) in pairs.items():
            e = max_err(a, b)
            errs[f"{tag}.{name}"] = e
            if not math.isfinite(e) or e > PLAIN_TOL[name]:
                failures.append(f"{tag}.{name}: {e} > {PLAIN_TOL[name]}")


def phase_kernels(cfg, model, device):
    """Each kernel against its plain version at the shapes the main path
    gives it: 4093 rays (a ragged tile) and one full 65,536-ray chunk; K2 with
    want_field at 64 samples (medium) and without at 32 (preview); K5 at
    64 + 64 with z_f from sample_pdf of K2's weights.  Returns the max abs
    errors per kernel and the chunk's inputs for the timing phase."""
    import torch

    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import pack_params
    from danerf_tpu_torch.ops.sampling import sample_pdf
    from danerf_tpu_torch.render.renderer import render_rays

    packed = pack_params(model, cfg)
    errs, failures = {}, []
    preview_s = max(int(cfg.num_samples * 0.5), 1)
    chunk = None
    for n, seed in ((4093, 1), (cfg.render_chunk, 4)):
        o, d, emb, z = make_rays(n, cfg, seed=seed, device=device)
        want_f = fr.march_plain(packed, cfg, o, d, emb, z, want_field=True)
        got_f = fr.march_cuda(packed, cfg, o, d, emb, z, want_field=True)
        torch.cuda.synchronize()
        compare(errs, failures, f"K2_field@{n}", got_f, want_f,
                ["rgb", "depth", "acc", "weights", "field"])
        _, _, _, z32 = make_rays(n, cfg, seed=seed, device=device, samples=preview_s,
                                 perturb=False)
        want = fr.march_plain(packed, cfg, o, d, emb, z32)
        got = fr.march_cuda(packed, cfg, o, d, emb, z32)
        torch.cuda.synchronize()
        compare(errs, failures, f"K2@{n}x{preview_s}", got, want,
                ["rgb", "depth", "acc", "weights"])
        if n == 4093:
            want = fr.march_plain(packed, cfg, o, d, emb, z)
            got = fr.march_cuda(packed, cfg, o, d, emb, z)
            torch.cuda.synchronize()
            compare(errs, failures, f"K2@{n}", got, want, ["rgb", "depth", "acc", "weights"])

        g = torch.Generator(device=device).manual_seed(seed + 1)
        z_f = sample_pdf(z, want_f["weights"], cfg.num_importance, True, rand=g)
        want_m = fr.merged_plain(packed, cfg, o, d, emb, z, want_f["field"], z_f)
        got_m = fr.merged_cuda(packed, cfg, o, d, emb, z, want_f["field"], z_f)
        torch.cuda.synchronize()
        compare(errs, failures, f"K5@{n}", got_m, want_m,
                ["rgb", "depth", "acc", "weights", "z_vals"])
        mean_acc = float(want_f["acc"].mean())
        del want_f, got_f, want, got, want_m, got_m
        chunk = (o, d, emb, z, z_f)

    # the slice against the reference route: module forward at every sample
    # (nerf_apply's encoding form, sin(2^i (o + z d)) whose f32 rounding 2^9
    # amplifies, and bf16 density matmul), sorted union
    n = 512
    o, d, emb = (x[:n] for x in chunk[:3])
    with torch.no_grad():
        ref = render_rays(model, cfg, o, d, emb, perturb=False, fused_composite=False)
        ker = render_rays(model, cfg, o, d, emb, perturb=False, fused_composite=True)
    torch.cuda.synchronize()
    slice_tol = {"rgb": 5e-3, "acc": 5e-3, "depth": 2e-2}
    for k, t in slice_tol.items():
        e = max_err(ker[k], ref[k])
        errs[f"render_rays.{k}"] = e
        if not math.isfinite(e) or e > t:
            failures.append(f"render_rays.{k}: {e} > {t}")

    emit({"phase": "kernels", "rays": [4093, cfg.render_chunk], "max_abs_err": errs,
          "tolerance": {**fr.PLAIN_TOL, **{f"render_rays.{k}": v for k, v in slice_tol.items()}},
          "mean_acc": mean_acc, "failures": failures})
    if failures:
        raise AssertionError("kernel disagrees with its plain version: " + "; ".join(failures))
    # the kernels record takes absolute errors (field_sigma's is relative)
    worst = {kern: max(v for k, v in errs.items()
                       if k.startswith(kern) and not k.endswith("field_sigma"))
             for kern in ("K2", "K5")}
    return worst, chunk


def _cotangents(n, s, g, device):
    """Seeded non-zero cotangents of K2's outputs: rgb, depth, acc, weights,
    field."""
    import torch

    return (torch.randn(n, 3, generator=g, device=device),
            torch.randn(n, generator=g, device=device),
            torch.randn(n, generator=g, device=device),
            0.1 * torch.randn(n, s, generator=g, device=device),
            0.1 * torch.randn(n, 4, s, generator=g, device=device))


def _tie(z, z_f):
    """z_f with its sixth depth set to each ray's eighth coarse depth, sorted:
    a coarse/fine tie (the merge puts the coarse sample first)."""
    import torch

    z_f = z_f.clone()
    z_f[:, 5] = z[:, 7]
    return torch.sort(z_f, dim=-1).values


def phase_bwd(cfg, model, device):
    """The backward and training kernels against their plain versions at 37
    rays and at the 1024-ray batch: K3 (every cotangent seeded, want_field on
    and off), K4 and K7 (seeded targets), K6 (every cotangent seeded,
    weights in merged order, a coarse/fine tie in z).  K3 and K7 run twice
    and must agree bit for bit.  Returns the max abs error of each kernel's
    per-ray outputs (and loss) for the kernels record."""
    import torch

    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import PackedGrads, pack_params
    from danerf_tpu_torch.ops.sampling import sample_pdf

    tol = fr.PLAIN_TOL
    packed = pack_params(model, cfg)
    sa = cfg.num_samples + cfg.num_importance
    errs, grad_rel, failures, deterministic, drop = {}, {}, [], {"K3": True, "K7": True}, {}

    def check(name, err, limit):
        errs[name] = err
        if not math.isfinite(err) or err > limit:
            failures.append(f"{name}: {err} > {limit}")

    def check_grads(tag, got, want):
        rel = fr.grad_rel_errors(got, want, model)
        worst = max(rel, key=rel.get)
        grad_rel[tag] = {"worst": rel[worst], "param": worst}
        if not math.isfinite(rel[worst]) or rel[worst] > tol["grad_rel"]:
            failures.append(f"{tag}.grad_rel {worst}: {rel[worst]} > {tol['grad_rel']}")

    def same(a, b):
        return bool(torch.equal(a.mats, b.mats) and torch.equal(a.vecs, b.vecs))

    def dropped(kern, got, want, **first_block):
        """What losing the first block of rays (2 rays at 64 samples) does:
        the summed gradients' relative change, and the block's per-ray
        outputs, which would be missing."""
        eff = fr.grad_rel_errors(got, want, model)
        drop[kern] = {"grad_rel_min": min(eff.values()), "grad_rel_max": max(eff.values()),
                      **{k: float(v[:2].abs().max()) for k, v in first_block.items()}}

    for n, seed in ((37, 11), (cfg.batch_size, 12)):
        o, d, emb, z = make_rays(n, cfg, seed=seed, device=device)
        g = torch.Generator(device=device).manual_seed(seed + 100)
        *cot, g_field = _cotangents(n, cfg.num_samples, g, device)
        for want_field in (True, False):
            gf = g_field if want_field else None
            tag = f"K3{'_field' if want_field else ''}@{n}"
            gk, dk = fr.march_bwd_cuda(packed, cfg, o, d, emb, z, *cot, gf)
            gk2, _ = fr.march_bwd_cuda(packed, cfg, o, d, emb, z, *cot, gf)
            gp, dp = fr.march_bwd_plain(packed, cfg, o, d, emb, z, *cot, gf)
            torch.cuda.synchronize()
            deterministic["K3"] &= same(gk, gk2)
            check_grads(tag, gk, gp)
            check(f"{tag}.demb", max_err(dk, dp), tol["demb"])
            if n == 37 and want_field:
                gd, _ = fr.march_bwd_plain(packed, cfg, o[2:], d[2:], emb[2:], z[2:],
                                           *(c[2:] for c in cot), gf[2:])
                dropped("K3", gd, gp, demb=dp)
        coarse = fr.march_cuda(packed, cfg, o, d, emb, z, want_field=True)
        z_f = sample_pdf(z, coarse["weights"], cfg.num_importance, True, rand=g)
        target = torch.rand(n, 3, generator=g, device=device)
        lk, gk, dk, fk = fr.merged_train_cuda(packed, cfg, o, d, emb, z, coarse["field"], z_f,
                                              target)
        lp, gp, dp, fp = fr.merged_train_plain(packed, cfg, o, d, emb, z, coarse["field"], z_f,
                                               target)
        torch.cuda.synchronize()
        check_grads(f"K4@{n}", gk, gp)
        check(f"K4@{n}.loss", abs(float(lk) - float(lp)), tol["loss"])
        check(f"K4@{n}.demb", max_err(dk, dp), tol["demb_k4"])
        check(f"K4@{n}.g_field", max_err(fk, fp), tol["g_field"])
        errs[f"K4@{n}.g_field_scale"] = float(fp.abs().max())

        # K7: the coarse-only loss and its gradients
        lk, gk, dk = fr.march_train_cuda(packed, cfg, o, d, emb, z, target)
        lk2, gk2, dk2 = fr.march_train_cuda(packed, cfg, o, d, emb, z, target)
        lp, gp, dp = fr.march_train_plain(packed, cfg, o, d, emb, z, target)
        torch.cuda.synchronize()
        deterministic["K7"] &= (same(gk, gk2) and bool(torch.equal(lk, lk2))
                                and bool(torch.equal(dk, dk2)))
        check_grads(f"K7@{n}", gk, gp)
        check(f"K7@{n}.loss", abs(float(lk) - float(lp)), tol["loss"])
        check(f"K7@{n}.demb", max_err(dk, dp), tol["demb_k4"])
        errs[f"K7@{n}.demb_scale"] = float(dp.abs().max())
        if n == 37:
            # the other rays' terms, still over 3R
            _, gd, _ = fr.march_train_plain(packed, cfg, o[2:], d[2:], emb[2:], z[2:], target[2:])
            f = (n - 2) / n
            dropped("K7", PackedGrads(gd.mats * f, gd.vecs * f, gd.packed), gp, demb=dp)

        # K6: the merged composite's VJP, every cotangent non-zero
        z_t = _tie(z, z_f)
        c6 = (torch.randn(n, 3, generator=g, device=device),
              torch.randn(n, generator=g, device=device),
              torch.randn(n, generator=g, device=device),
              0.1 * torch.randn(n, sa, generator=g, device=device))
        gk, dk, fk = fr.merged_bwd_cuda(packed, cfg, o, d, emb, z, coarse["field"], z_t, *c6)
        gp, dp, fp = fr.merged_bwd_plain(packed, cfg, o, d, emb, z, coarse["field"], z_t, *c6)
        torch.cuda.synchronize()
        check_grads(f"K6@{n}", gk, gp)
        check(f"K6@{n}.demb", max_err(dk, dp), tol["demb"])
        check(f"K6@{n}.g_field", max_err(fk, fp), tol["g_field_k6"])
        errs[f"K6@{n}.g_field_scale"] = float(fp.abs().max())
        if n == 37:
            gd, _, _ = fr.merged_bwd_plain(packed, cfg, o[2:], d[2:], emb[2:], z[2:],
                                           coarse["field"][2:], z_t[2:], *(c[2:] for c in c6))
            dropped("K6", gd, gp, demb=dp, g_field=fp)
        del coarse
    for kern, ok in deterministic.items():
        if not ok:
            failures.append(f"{kern} gave different results on the same inputs")
    emit({"phase": "bwd", "rays": [37, cfg.batch_size], "max_abs_err": errs,
          "grad_rel": grad_rel, "dropped_block_effect_at_37": drop,
          "deterministic": deterministic,
          "tolerance": {k: tol[k] for k in ("grad_rel", "demb", "demb_k4", "g_field",
                                            "g_field_k6", "loss")},
          "failures": failures})
    if failures:
        raise AssertionError("backward kernel disagrees with its plain version: "
                             + "; ".join(failures))
    return {kern: max(v for k, v in errs.items() if k.startswith(kern) and "scale" not in k)
            for kern in ("K3", "K4", "K6", "K7")}


@contextlib.contextmanager
def plain_route():
    """Route the autograd Functions through the plain versions on the card
    (for the step-parity phase only; the port itself never does this)."""
    from danerf_tpu_torch.kernels import fused_render as fr

    names = ("_march_fwd", "_march_bwd", "_march_train", "_merged_fwd", "_merged_bwd",
             "_merged_train")
    saved = {n: getattr(fr, n) for n in names}
    fr._march_fwd = lambda pk, c, o, d, e, z, t, wf: fr.march_plain(pk, c, o, d, e, z, t, wf)
    fr._march_bwd = lambda pk, c, o, d, e, z, t, cot: fr.march_bwd_plain(pk, c, o, d, e, z,
                                                                         *cot, t=t)
    fr._march_train = lambda pk, c, *a: fr.march_train_plain(pk, c, *a)
    fr._merged_fwd = lambda pk, c, *a: fr.merged_plain(pk, c, *a)
    fr._merged_bwd = lambda pk, c, o, d, e, zc, fc, zf, t, cot: fr.merged_bwd_plain(
        pk, c, o, d, e, zc, fc, zf, *cot, t=t)
    fr._merged_train = lambda pk, c, *a: fr.merged_train_plain(pk, c, *a)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(fr, n, f)


# The training paths: config changes, and the launches of one step.
PATHS = {
    "hier": ({}, {"march": 1, "march_bwd": 1, "merged_train": 1}),
    "coarse": ({"num_importance": 0}, {"march_train": 1}),
    "white": ({"white_background": True},
              {"march": 1, "merged": 1, "merged_bwd": 1, "march_bwd": 1}),
}


def launches_of(per_step, steps=1):
    from danerf_tpu_torch.kernels import fused_render as fr

    return {k: per_step.get(k, 0) * steps for k in fr.LAUNCHES}


def phase_step(cfg, model, device):
    """One training step at B = 1024 on each training path (64 + 64; coarse
    only; 64 + 64 on a white background), each built twice from the same
    module, table, batch and draws: through the kernels and through their
    plain versions; loss, every gradient and the parameters after one Adam
    step compared."""
    import copy

    import torch

    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.train.trainer import compute_loss_and_grads, make_optimizer

    n, n_img = cfg.batch_size, 4
    o, d, _, _ = make_rays(n, cfg, seed=21, device=device)
    g = torch.Generator(device=device).manual_seed(22)
    batch = {"rays_o": o, "rays_d": d, "rgb": torch.rand(n, 3, generator=g, device=device),
             "img_idx": torch.randint(0, n_img, (n,), generator=g, device=device)}
    draws = (torch.rand(n, cfg.num_samples, generator=g, device=device),
             torch.rand(n, cfg.num_importance, generator=g, device=device))
    table0 = torch.randn(n_img, cfg.appearance_dim, generator=g, device=device)
    names = [nm for nm, _ in model.named_parameters()] + ["appearance"]
    tol = fr.PLAIN_TOL
    report, failures = {}, []
    for path, (over, per_step) in PATHS.items():
        pcfg = cfg.replace(**over)
        pdraws = draws if pcfg.num_importance > 0 else draws[:1]
        runs = {}
        for route in ("kernel", "plain"):
            m = copy.deepcopy(model).requires_grad_(True)
            table = torch.nn.Parameter(table0.clone())
            params = list(m.parameters()) + [table]
            opt, sched = make_optimizer(pcfg, params)
            before = [p.detach().clone() for p in params]
            fr.reset_launch_counts()
            with plain_route() if route == "plain" else contextlib.nullcontext():
                opt.zero_grad(set_to_none=True)
                loss, aux = compute_loss_and_grads(m, table, pcfg, batch, draws=pdraws)
                grads = [p.grad.detach().clone() for p in params]
                opt.step()
                sched.step()
            torch.cuda.synchronize()
            runs[route] = {"loss": float(loss), **{k: float(v) for k, v in aux.items()},
                           "grads": grads, "delta": [p.detach() - b for p, b in zip(params, before)],
                           "launches": dict(fr.LAUNCHES)}
        k, p = runs["kernel"], runs["plain"]
        grad_rel = {nm: float((a - b).norm() / b.norm()) for nm, a, b in
                    zip(names, k["grads"], p["grads"]) if float(b.norm()) > 0}
        upd_rel = {nm: float((a - b).norm() / b.norm()) for nm, a, b in
                   zip(names, k["delta"], p["delta"]) if float(b.norm()) > 0}
        param_abs = max(max_err(a, b) for a, b in zip(k["delta"], p["delta"]))
        if k["launches"] != launches_of(per_step):
            failures.append(f"{path}: kernel step launches {k['launches']}")
        if any(p["launches"].values()):
            failures.append(f"{path}: plain step launched kernels {p['launches']}")
        loss_err = abs(k["loss"] - p["loss"])
        if not math.isfinite(loss_err) or loss_err > tol["loss"]:
            failures.append(f"{path}: loss: {loss_err} > {tol['loss']}")
        worst = max(grad_rel, key=grad_rel.get)
        if not math.isfinite(grad_rel[worst]) or grad_rel[worst] > tol["grad_rel"]:
            failures.append(f"{path}: grad {worst}: {grad_rel[worst]} > {tol['grad_rel']}")
        # Adam's first step moves each element by at most lr, so the two runs'
        # parameters differ by at most 2 lr, reached where a gradient element
        # near 0 changes sign between them
        if not math.isfinite(param_abs) or param_abs > 2 * pcfg.learning_rate * (1 + 1e-3):
            failures.append(f"{path}: parameters after one Adam step: {param_abs}")
        report[path] = {"loss": [k["loss"], p["loss"]], "loss_err": loss_err,
                        **{a: [k[a], p[a]] for a in ("mse", "coarse_mse") if a in k},
                        "grad_rel_worst": {"param": worst, "err": grad_rel[worst]},
                        "update_rel_worst": max(upd_rel.values()),
                        "param_max_abs_diff": param_abs, "launches": k["launches"]}
    emit({"phase": "step", "rays": n, **report, "failures": failures})
    if failures:
        raise AssertionError("kernel step disagrees with the plain step: " + "; ".join(failures))


def phase_render(cfg, model, out_dir):
    import numpy as np
    import torch

    from danerf_tpu_torch.cli.main import main as cli_main
    from danerf_tpu_torch.kernels import fused_render as fr

    ckpt = os.path.join(out_dir, "smoke_model.pt")
    table = torch.randn(4, cfg.appearance_dim, generator=torch.Generator().manual_seed(3))
    torch.save({"model_state_dict": {k: v.cpu() for k, v in model.state_dict().items()},
                "appearance_embeddings": table, "iteration": 0}, ckpt)

    size, frames = 400, 2
    chunks = -(-size * size // cfg.render_chunk)
    runs = {}
    for quality, n_frames in (("medium", frames), ("preview", 1)):
        run_dir = os.path.join(out_dir, f"render_{quality}")
        argv = ["render", "--checkpoint", ckpt, "--output_dir", run_dir,
                "--frames", str(n_frames), "--width", str(size), "--height", str(size),
                "--quality", quality, "--save_depth", "--device", "cuda", "--seed", "0"]
        fr.reset_launch_counts()
        t0 = time.perf_counter()
        written = cli_main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(fr.LAUNCHES)
        for i in range(n_frames):
            for name in (f"rgb_{i:03d}.png", f"depth_{i:03d}.png", f"raw/depth_{i:03d}.npy"):
                if not os.path.exists(os.path.join(run_dir, name)):
                    raise AssertionError(f"{quality}: {name} was not written")
            depth = np.load(os.path.join(run_dir, f"raw/depth_{i:03d}.npy"))
            if depth.shape != (size, size) or not np.isfinite(depth).all():
                raise AssertionError(f"{quality}: depth {i} bad: {depth.shape}")
        want = {"march": chunks * n_frames,
                "merged": chunks * n_frames if quality != "preview" else 0}
        if counts["march"] < want["march"] or (
                quality != "preview" and counts["merged"] < want["merged"]):
            raise AssertionError(f"{quality}: launches {counts}, expected at least {want}")
        runs[quality] = {"frames": len(written), "seconds": secs, "launches": counts,
                         "chunks_per_frame": chunks}
    emit({"phase": "render", "size": size, **runs})
    return runs["medium"]["launches"]


TRAIN_FLAGS = {"hier": [], "coarse": ["--num_importance", "0"], "white": ["--white_background"]}


def phase_train(out_dir, path, iters, render):
    """A training path through its entry point: `cli.main train` for
    ``iters`` steps on the procedural scene, with exactly the path's kernel
    launches per step, finite losses and a rising PSNR; then, when
    ``render``, `render` of the final checkpoint."""
    import shutil

    import numpy as np
    import torch

    from danerf_tpu_torch.cli.main import main as cli_main
    from danerf_tpu_torch.kernels import fused_render as fr

    warmup = 5
    save = os.path.join(out_dir, f"train_{path}")
    shutil.rmtree(save, ignore_errors=True)          # metrics.jsonl appends
    no_scene = os.path.join(out_dir, "no_scene")     # -> the procedural scene
    argv = ["train", "--iters", str(iters), "--density_bias_init", "0.5", "--save_dir", save,
            "--device", "cuda", "--seed", "0", "--dataset_path", no_scene, *TRAIN_FLAGS[path]]
    fr.reset_launch_counts()
    t0 = time.perf_counter()
    cli_main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(fr.LAUNCHES)
    want = launches_of(PATHS[path][1], iters)
    if counts != want:
        raise AssertionError(f"train {path}: launches {counts}, expected {want}")
    with open(os.path.join(save, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if [r["step"] for r in rows] != list(range(1, iters + 1)):
        raise AssertionError(f"train {path}: metrics.jsonl does not hold one row per step")
    if not all(math.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"train {path}: a logged loss is not finite")
    first = float(np.mean([r["psnr"] for r in rows[warmup:warmup + 20]]))
    last = float(np.mean([r["psnr"] for r in rows[-20:]]))
    if not last > first:
        raise AssertionError(f"train {path}: PSNR did not rise ({first} -> {last})")
    ckpt = os.path.join(save, "checkpoint_final.pt")
    if not os.path.exists(ckpt):
        raise AssertionError(f"train {path}: checkpoint_final.pt was not written")
    if render:
        render_dir = os.path.join(out_dir, f"render_trained_{path}")
        written = cli_main(["render", "--checkpoint", ckpt, "--output_dir", render_dir,
                            "--quality", "preview", "--frames", "1", "--width", "100",
                            "--height", "100", "--device", "cuda", "--dataset_path", no_scene])
        if len(written) != 1 or not os.path.exists(written[0]):
            raise AssertionError("render of the trained checkpoint wrote no frame")
    emit({"phase": "train", "path": path, "flags": TRAIN_FLAGS[path], "iters": iters,
          "seconds_incl_scene": secs, "launches": counts,
          "loss_first": rows[0]["loss"], "loss_last": rows[-1]["loss"],
          "psnr_mean_first20_after_warmup": first, "psnr_mean_last20": last})
    return counts


def phase_timing(cfg, model, device, chunk):
    import torch

    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import pack_params
    from danerf_tpu_torch.render.renderer import render_frame
    from danerf_tpu_torch.viz.paths import camera_path

    R, S = cfg.render_chunk, cfg.num_samples
    packed = pack_params(model, cfg)
    o, d, emb, z, z_f = chunk
    field = fr.march_cuda(packed, cfg, o, d, emb, z, want_field=True)["field"]

    k2 = cuda_ms(lambda: fr.march_cuda(packed, cfg, o, d, emb, z, want_field=True), 5, 2)
    k5 = cuda_ms(lambda: fr.merged_cuda(packed, cfg, o, d, emb, z, field, z_f), 5, 2)
    k2_plain = cuda_ms(lambda: fr.march_plain(packed, cfg, o, d, emb, z, want_field=True), 3)
    k5_plain = cuda_ms(lambda: fr.merged_plain(packed, cfg, o, d, emb, z, field, z_f), 3)

    w_bytes = packed.mats.numel() * 2 + packed.vecs.numel() * 4
    e = cfg.appearance_dim
    k2_bytes = 4 * R * (3 + 3 + e + S) + 4 * R * (3 + 1 + 1 + S + 4 * S) + w_bytes
    sa = S + cfg.num_importance
    k5_bytes = (4 * R * (3 + 3 + e + S + 4 * S + cfg.num_importance)
                + 4 * R * (3 + 1 + 1 + sa + sa) + w_bytes)
    k2_bound, k2_by = bound(cfg, R, S, k2_bytes)
    k5_bound, k5_by = bound(cfg, R, cfg.num_importance, k5_bytes)

    side = 800
    c2w = camera_path("circle", 2, cfg.scene)[0]
    focal = 0.5 * side / math.tan(0.5 * 0.6911)
    emb0 = emb[0]

    def frame():
        gen = torch.Generator(device=device).manual_seed(6)
        return render_frame(model, cfg, c2w, side, side, focal, appearance_embedding=emb0,
                            perturb=True, generator=gen, device=device)

    frame()
    torch.cuda.synchronize()
    # host-clock times spread more than device times: report the median of 3
    frame_ms = []
    for _ in range(3):
        fr.reset_launch_counts()
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    frame_launches = dict(fr.LAUNCHES)
    chunks = side * side / R
    timing = {"chunk_rays": R, "k2_ms": k2, "k5_ms": k5, "k2_plain_ms": k2_plain,
              "k5_plain_ms": k5_plain, "k2_bound_ms": k2_bound, "k5_bound_ms": k5_bound,
              "frame_800_medium_derived_ms": chunks * (k2 + k5),
              "frame_800_medium_measured_ms": sorted(frame_ms)[1],
              "frame_800_medium_each_ms": frame_ms,
              "frame_800_medium_launches": frame_launches,
              "frame_800_medium_bound_ms": chunks * (k2_bound + k5_bound)}
    emit({"phase": "timing", **timing})
    return timing, (k2_by, k5_by)


def profile_steps(step, n_prof=10):
    """Device time by kernel over ``n_prof`` steps (torch.profiler, CUPTI):
    the top kernels, the device's busy ms a step and the profiled wall ms a
    step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_prof
    kernels = sorted(((ev.key, ev.self_device_time_total / 1e3 / n_prof, ev.count / n_prof)
                      for ev in prof.key_averages()
                      # kernels and copies; a user range (Optimizer.step#...) on the
                      # device timeline spans others and would count them twice
                      if ev.device_type == DeviceType.CUDA
                      and not getattr(ev, "is_user_annotation", False)
                      and not ev.key.startswith("Optimizer.")),
                     key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    return {"profile_ms_per_step": [[k[0][:70], k[1], k[2]] for k in kernels[:14]],
            "profile_device_busy_ms_per_step": busy_ms, "profile_wall_ms_per_step": wall_ms,
            "profile_idle_share": 1.0 - busy_ms / wall_ms}


def phase_train_timing(cfg, model, device, chunk):
    """The training kernels (K3, K4, K6, K7) on the 65,536-ray chunk and at
    the 1024-ray batch, their plain versions at the batch, and the training
    step of each path at B = 1024 (median of 50 synchronised steps) with a
    torch.profiler breakdown of the 64 + 64 and the coarse-only step."""
    import numpy as np
    import torch

    from danerf_tpu_torch.data.dataset import RayDataset
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import pack_params
    from danerf_tpu_torch.ops.sampling import sample_pdf
    from danerf_tpu_torch.train.trainer import init_model, make_optimizer, train_step
    from danerf_tpu_torch.viz.paths import camera_path

    packed = pack_params(model, cfg)
    sc, sf, e = cfg.num_samples, cfg.num_importance, cfg.appearance_dim
    sa = sc + sf
    w_bytes = packed.mats.numel() * 2 + packed.vecs.numel() * 4
    g_bytes = (packed.mats.numel() + packed.vecs.numel()) * 4
    # bytes each kernel must move: inputs read once, outputs written once
    ray_bytes = {
        "k3": lambda n: 4 * n * (3 + 3 + e + sc + 3 + 1 + 1 + sc + 4 * sc) + 4 * n * e,
        "k4": lambda n: 4 * n * (3 + 3 + e + sc + 4 * sc + sf + 3) + 4 * n * (e + 4 * sc) + 4,
        "k6": lambda n: (4 * n * (3 + 3 + e + sc + 4 * sc + sf + 3 + 1 + 1 + sa)
                         + 4 * n * (e + 4 * sc)),
        "k7": lambda n: 4 * n * (3 + 3 + e + sc + 3) + 4 * n * e + 4,
    }
    fine = {"k3": False, "k4": True, "k6": True, "k7": False}   # field at Sf, else Sc

    out, bound_by = {}, {}
    g = torch.Generator(device=device).manual_seed(31)
    shapes = (("chunk", chunk),
              ("batch", make_rays(cfg.batch_size, cfg, seed=32, device=device) + (None,)))
    for tag, (o, d, emb, z, z_f) in shapes:
        n = o.shape[0]
        *cot, g_field = _cotangents(n, sc, g, device)
        coarse = fr.march_cuda(packed, cfg, o, d, emb, z, want_field=True)
        if z_f is None:
            z_f = sample_pdf(z, coarse["weights"], sf, True, rand=g)
        field = coarse["field"]
        target = torch.rand(n, 3, generator=g, device=device)
        c6 = (cot[0], cot[1], cot[2], 0.1 * torch.randn(n, sa, generator=g, device=device))
        del coarse
        calls = {
            "k3": (lambda: fr.march_bwd_cuda(packed, cfg, o, d, emb, z, *cot, g_field),
                   lambda: fr.march_bwd_plain(packed, cfg, o, d, emb, z, *cot, g_field)),
            "k4": (lambda: fr.merged_train_cuda(packed, cfg, o, d, emb, z, field, z_f, target),
                   lambda: fr.merged_train_plain(packed, cfg, o, d, emb, z, field, z_f, target)),
            "k6": (lambda: fr.merged_bwd_cuda(packed, cfg, o, d, emb, z, field, z_f, *c6),
                   lambda: fr.merged_bwd_plain(packed, cfg, o, d, emb, z, field, z_f, *c6)),
            "k7": (lambda: fr.march_train_cuda(packed, cfg, o, d, emb, z, target),
                   lambda: fr.march_train_plain(packed, cfg, o, d, emb, z, target)),
        }
        iters = 3 if tag == "chunk" else 20
        for k, (kern, plain) in calls.items():
            out[f"{k}_{tag}_ms"] = cuda_ms(kern, iters)
            out[f"{k}_{tag}_bound_ms"], bound_by[k] = bound(
                cfg, n, sf if fine[k] else sc, ray_bytes[k](n) + w_bytes + g_bytes,
                backward=True)
            if tag == "batch":
                out[f"{k}_batch_plain_ms"] = cuda_ms(plain, 5)
        if tag == "batch":
            out["k2_batch_ms"] = cuda_ms(
                lambda: fr.march_cuda(packed, cfg, o, d, emb, z, want_field=True), iters)
            out["k5_batch_ms"] = cuda_ms(
                lambda: fr.merged_cuda(packed, cfg, o, d, emb, z, field, z_f), iters)
            k2_bytes = 4 * n * (3 + 3 + e + sc) + 4 * n * (3 + 1 + 1 + sc + 4 * sc) + w_bytes
            out["k2_batch_bound_ms"], _ = bound(cfg, n, sc, k2_bytes)
            k5_bytes = (4 * n * (3 + 3 + e + sc + 4 * sc + sf) + 4 * n * (3 + 1 + 1 + sa + sa)
                        + w_bytes)
            out["k5_batch_bound_ms"], _ = bound(cfg, n, sf, k5_bytes)
        del cot, g_field, field, target, c6, calls

    # the training step at B = 1024 on a pool of 20 random 100x100 images
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, size=(20, 100, 100, 3), dtype=np.uint8)
    c2ws = np.stack([np.asarray(c, np.float32) for c in camera_path("circle", 20, cfg.scene)])
    ds = RayDataset(imgs, imgs[..., 0], c2ws, 138.9, cfg.near, cfg.far)
    # the kernels of a step, and their bound, at B = 1024
    step_kernels = {"hier": ("k2", "k3", "k4"), "coarse": ("k7",),
                    "white": ("k2", "k5", "k6", "k3")}
    steps = {}
    for path, (over, _) in PATHS.items():
        pcfg = cfg.replace(**over)
        model_t, table = init_model(pcfg, 20, 0, device)
        opt, sched = make_optimizer(pcfg, list(model_t.parameters()) + [table])
        pool = ds.device_arrays(pcfg.white_background, device=device)
        gen = torch.Generator(device=device).manual_seed(0)

        def step():
            return train_step(model_t, table, opt, sched, pool, pcfg, 100, 100, ds.focal, None,
                              gen)

        for _ in range(5):
            step()
        torch.cuda.synchronize()
        times = []
        for _ in range(50):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        step_ms = float(np.median(times))
        kern_ms = sum(out[f"{k}_batch_ms"] for k in step_kernels[path])
        steps[path] = {"step_ms_median": step_ms, "step_ms_min": min(times),
                       "step_ms_max": max(times), "rays_per_s": cfg.batch_size / (step_ms / 1e3),
                       "kernels": step_kernels[path], "kernel_share": kern_ms / step_ms,
                       "step_bound_ms": sum(out[f"{k}_batch_bound_ms"]
                                            for k in step_kernels[path])}
        if path in ("hier", "coarse"):
            steps[path].update(profile_steps(step))
    emit({"phase": "train_timing", "batch": cfg.batch_size, "chunk_rays": chunk[0].shape[0],
          **out, "steps": steps})
    return out, bound_by


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  "build", "chip_smoke"),
                    help="directory for the build log, checkpoint and frames")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU", file=sys.stderr)
        return 2
    import danerf_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    from danerf_tpu_torch.config import NeRFConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    device = torch.device("cuda")

    smi = phase_env()
    phase_build(args.out)
    # Full width, seeded random weights; the density bias is shifted alive so
    # the composite is not vacuous (relu heads can be born dead).
    cfg = NeRFConfig(density_bias_init=0.5)
    model = make_model(cfg, seed=0, device=device)
    errs, chunk = phase_kernels(cfg, model, device)
    errs.update(phase_bwd(cfg, model, device))
    phase_step(cfg, model, device)
    launches = phase_render(cfg, model, args.out)
    train_launches = {"hier": phase_train(args.out, "hier", 200, render=True),
                      "coarse": phase_train(args.out, "coarse", 100, render=False),
                      "white": phase_train(args.out, "white", 100, render=False)}
    timing, bound_by = phase_timing(cfg, model, device, chunk)
    tt, tt_bound_by = phase_train_timing(cfg, model, device, chunk)

    def train_kernel(name, key, source, replaces, path, counter):
        # a training kernel at the batch (B = 1024 rays, 64 + 64), its
        # launches from its path's training run
        return {"name": name, "route": "cuda",
                "source": f"danerf_tpu_torch/kernels/csrc/{source}",
                "replaces": f"danerf_tpu/kernels/fused_render.py:{replaces}",
                "launches": train_launches[path][counter], "max_abs_err": errs[key.upper()],
                "ms": tt[f"{key}_batch_ms"], "plain_ms": tt[f"{key}_batch_plain_ms"],
                "bound_ms": tt[f"{key}_batch_bound_ms"], "bound_by": tt_bound_by[key],
                "library_ms": None}

    kernels = [
        {"name": "K2 ray march (want_field)", "route": "cuda",
         "source": "danerf_tpu_torch/kernels/csrc/march.cu",
         "replaces": "danerf_tpu/kernels/fused_render.py:155",
         "launches": launches["march"], "max_abs_err": errs["K2"],
         "ms": timing["k2_ms"], "plain_ms": timing["k2_plain_ms"],
         "bound_ms": timing["k2_bound_ms"], "bound_by": bound_by[0], "library_ms": None},
        {"name": "K5 merged composite", "route": "cuda",
         "source": "danerf_tpu_torch/kernels/csrc/merged.cu",
         "replaces": "danerf_tpu/kernels/fused_render.py:757",
         "launches": launches["merged"], "max_abs_err": errs["K5"],
         "ms": timing["k5_ms"], "plain_ms": timing["k5_plain_ms"],
         "bound_ms": timing["k5_bound_ms"], "bound_by": bound_by[1], "library_ms": None},
        train_kernel("K3 ray-march backward (want_field)", "k3", "march_bwd.cu", 212, "hier",
                     "march_bwd"),
        train_kernel("K4 merged fine pass + MSE + backward", "k4", "merged_train.cu", 831,
                     "hier", "merged_train"),
        train_kernel("K6 merged-composite backward", "k6", "merged_bwd.cu", 779, "white",
                     "merged_bwd"),
        train_kernel("K7 coarse march + MSE + backward", "k7", "march_train.cu", 449, "coarse",
                     "march_train"),
    ]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
