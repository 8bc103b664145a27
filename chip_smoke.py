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
4. bwd      the backward kernels against their plain versions at 37 rays
            (19 blocks, so a lost or doubled block shows) and at the
            1024-ray training batch: K3 with every cotangent seeded non-zero,
            want_field on and off; K4 with field_c from K2, z_f from
            sample_pdf and a seeded target.  Per-ray outputs and the loss by
            max abs error, each parameter gradient by relative Frobenius
            error; each K3 call twice, which must agree bit for bit.
5. step     one training step at B = 1024 built twice from the same module,
            table, batch and draws: through the kernels and through their
            plain versions; loss, every gradient and the parameters after
            one Adam step compared.
6. render   the serving path: a seeded full-width model saved as a
            reference-format .pt, rendered by `cli.main render` (two
            400x400 medium frames, then one preview frame); launch counts
            are zeroed just before each and read just after.
7. train    the training path: `cli.main train` for 200 steps on the
            procedural scene (5 warm-up steps of 64 rays, then 1024);
            exactly one K2, K4 and K3 launch per step, finite losses, a
            rising PSNR, and `render` of the final checkpoint.
8. timing   CUDA-event times of every kernel and its plain version, each
            beside its bound: K2 (want_field) and K5 on a 65,536-ray chunk,
            K3 and K4 on a chunk and at B = 1024 (plain versions at B =
            1024); an 800x800 medium frame end to end (median of three after
            a warm-up frame); the training step at B = 1024 (median of 50
            synchronised steps) with its rays/s and the share of K2+K3+K4,
            and the device time by kernel over 10 steps (torch.profiler).

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


def phase_bwd(cfg, model, device):
    """K3 and K4 against their plain versions at 37 rays and at the 1024-ray
    batch.  Returns the max abs error of each kernel's per-ray outputs (and
    loss) for the kernels record."""
    import torch

    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import pack_params
    from danerf_tpu_torch.ops.sampling import sample_pdf

    tol = fr.PLAIN_TOL
    packed = pack_params(model, cfg)
    errs, grad_rel, failures, deterministic = {}, {}, [], True

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

    drop = None
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
            deterministic &= bool(torch.equal(gk.mats, gk2.mats) and torch.equal(gk.vecs, gk2.vecs))
            check_grads(tag, gk, gp)
            check(f"{tag}.demb", max_err(dk, dp), tol["demb"])
            if n == 37 and want_field:
                # what a lost block of rays (the first 2) does to the sums
                gd, _ = fr.march_bwd_plain(packed, cfg, o[2:], d[2:], emb[2:], z[2:],
                                           *(c[2:] for c in cot), gf[2:])
                eff = fr.grad_rel_errors(gd, gp, model)
                drop = {"min": min(eff.values()), "max": max(eff.values())}
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
    if not deterministic:
        failures.append("K3 gave different gradients on the same inputs")
    emit({"phase": "bwd", "rays": [37, cfg.batch_size], "max_abs_err": errs,
          "grad_rel": grad_rel, "dropped_block_effect_at_37": drop,
          "deterministic": deterministic,
          "tolerance": {k: tol[k] for k in ("grad_rel", "demb", "demb_k4", "g_field", "loss")},
          "failures": failures})
    if failures:
        raise AssertionError("backward kernel disagrees with its plain version: "
                             + "; ".join(failures))
    return {kern: max(v for k, v in errs.items() if k.startswith(kern) and "scale" not in k)
            for kern in ("K3", "K4")}


@contextlib.contextmanager
def plain_route():
    """Route the autograd Functions through the plain versions on the card
    (for the step-parity phase only; the port itself never does this)."""
    from danerf_tpu_torch.kernels import fused_render as fr

    saved = fr._march_fwd, fr._march_bwd, fr._merged_train
    fr._march_fwd = lambda pk, c, o, d, e, z, t, wf: fr.march_plain(pk, c, o, d, e, z, t, wf)
    fr._march_bwd = lambda pk, c, o, d, e, z, t, cot: fr.march_bwd_plain(pk, c, o, d, e, z,
                                                                         *cot, t=t)
    fr._merged_train = lambda pk, c, *a: fr.merged_train_plain(pk, c, *a)
    try:
        yield
    finally:
        fr._march_fwd, fr._march_bwd, fr._merged_train = saved


def phase_step(cfg, model, device):
    """One training step at B = 1024 through the kernels and through the
    plain versions, from the same module, table, batch and draws."""
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
    runs = {}
    for route in ("kernel", "plain"):
        m = copy.deepcopy(model).requires_grad_(True)
        table = torch.nn.Parameter(table0.clone())
        params = list(m.parameters()) + [table]
        opt, sched = make_optimizer(cfg, params)
        before = [p.detach().clone() for p in params]
        fr.reset_launch_counts()
        with plain_route() if route == "plain" else contextlib.nullcontext():
            opt.zero_grad(set_to_none=True)
            loss, aux = compute_loss_and_grads(m, table, cfg, batch, draws=draws)
            grads = [p.grad.detach().clone() for p in params]
            opt.step()
            sched.step()
        torch.cuda.synchronize()
        runs[route] = {"loss": float(loss), "mse": float(aux["mse"]),
                       "coarse_mse": float(aux["coarse_mse"]), "grads": grads,
                       "delta": [p.detach() - b for p, b in zip(params, before)],
                       "launches": dict(fr.LAUNCHES)}
    k, p = runs["kernel"], runs["plain"]
    names = [nm for nm, _ in model.named_parameters()] + ["appearance"]
    grad_rel = {nm: float((a - b).norm() / b.norm()) for nm, a, b in
                zip(names, k["grads"], p["grads"]) if float(b.norm()) > 0}
    upd_rel = {nm: float((a - b).norm() / b.norm()) for nm, a, b in
               zip(names, k["delta"], p["delta"]) if float(b.norm()) > 0}
    param_abs = max(max_err(a, b) for a, b in zip(k["delta"], p["delta"]))
    tol = fr.PLAIN_TOL
    failures = []
    if k["launches"] != {"march": 1, "merged": 0, "march_bwd": 1, "merged_train": 1}:
        failures.append(f"kernel step launches {k['launches']}")
    if any(p["launches"].values()):
        failures.append(f"plain step launched kernels {p['launches']}")
    loss_err = abs(k["loss"] - p["loss"])
    if not math.isfinite(loss_err) or loss_err > tol["loss"]:
        failures.append(f"loss: {loss_err} > {tol['loss']}")
    worst = max(grad_rel, key=grad_rel.get)
    if not math.isfinite(grad_rel[worst]) or grad_rel[worst] > tol["grad_rel"]:
        failures.append(f"grad {worst}: {grad_rel[worst]} > {tol['grad_rel']}")
    # Adam's first step moves each element by at most lr, so the two runs'
    # parameters differ by at most 2 lr, reached where a gradient element
    # near 0 changes sign between them
    if not math.isfinite(param_abs) or param_abs > 2 * cfg.learning_rate * (1 + 1e-3):
        failures.append(f"parameters after one Adam step: {param_abs}")
    emit({"phase": "step", "rays": n, "loss": [k["loss"], p["loss"]], "loss_err": loss_err,
          "mse": [k["mse"], p["mse"]], "coarse_mse": [k["coarse_mse"], p["coarse_mse"]],
          "grad_rel_worst": {"param": worst, "err": grad_rel[worst]},
          "update_rel_worst": max(upd_rel.values()), "param_max_abs_diff": param_abs,
          "launches": k["launches"], "failures": failures})
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


def phase_train(out_dir):
    """The training path through its entry point: 200 steps of `cli.main
    train` on the procedural scene, then `render` of the final checkpoint."""
    import shutil

    import numpy as np
    import torch

    from danerf_tpu_torch.cli.main import main as cli_main
    from danerf_tpu_torch.kernels import fused_render as fr

    iters, warmup = 200, 5
    save = os.path.join(out_dir, "train")
    shutil.rmtree(save, ignore_errors=True)          # metrics.jsonl appends
    no_scene = os.path.join(out_dir, "no_scene")     # -> the procedural scene
    argv = ["train", "--iters", str(iters), "--density_bias_init", "0.5", "--save_dir", save,
            "--device", "cuda", "--seed", "0", "--dataset_path", no_scene]
    fr.reset_launch_counts()
    t0 = time.perf_counter()
    cli_main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(fr.LAUNCHES)
    want = {"march": iters, "merged": 0, "march_bwd": iters, "merged_train": iters}
    if counts != want:
        raise AssertionError(f"train: launches {counts}, expected {want}")
    with open(os.path.join(save, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if [r["step"] for r in rows] != list(range(1, iters + 1)):
        raise AssertionError("train: metrics.jsonl does not hold one row per step")
    if not all(math.isfinite(r["loss"]) for r in rows):
        raise AssertionError("train: a logged loss is not finite")
    first = float(np.mean([r["psnr"] for r in rows[warmup:warmup + 20]]))
    last = float(np.mean([r["psnr"] for r in rows[-20:]]))
    if not last > first:
        raise AssertionError(f"train: PSNR did not rise ({first} -> {last})")
    ckpt = os.path.join(save, "checkpoint_final.pt")
    if not os.path.exists(ckpt):
        raise AssertionError("train: checkpoint_final.pt was not written")
    render_dir = os.path.join(out_dir, "render_trained")
    written = cli_main(["render", "--checkpoint", ckpt, "--output_dir", render_dir,
                        "--quality", "preview", "--frames", "1", "--width", "100", "--height",
                        "100", "--device", "cuda", "--dataset_path", no_scene])
    if len(written) != 1 or not os.path.exists(written[0]):
        raise AssertionError("render of the trained checkpoint wrote no frame")
    emit({"phase": "train", "iters": iters, "seconds_incl_scene": secs, "launches": counts,
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


def phase_train_timing(cfg, model, device, chunk):
    """K3 and K4 on the 65,536-ray chunk and at the 1024-ray batch, their
    plain versions at the batch, and the training step at B = 1024."""
    import numpy as np
    import torch

    from danerf_tpu_torch.data.dataset import RayDataset
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import pack_params
    from danerf_tpu_torch.ops.sampling import sample_pdf
    from danerf_tpu_torch.train.trainer import init_model, make_optimizer, train_step

    packed = pack_params(model, cfg)
    sc, sf, e = cfg.num_samples, cfg.num_importance, cfg.appearance_dim
    w_bytes = packed.mats.numel() * 2 + packed.vecs.numel() * 4
    g_bytes = (packed.mats.numel() + packed.vecs.numel()) * 4

    def k3_bytes(n):
        return 4 * n * (3 + 3 + e + sc + 3 + 1 + 1 + sc + 4 * sc) + 4 * n * e + w_bytes + g_bytes

    def k4_bytes(n):
        return (4 * n * (3 + 3 + e + sc + 4 * sc + sf + 3) + 4 * n * (e + 4 * sc) + 4
                + w_bytes + g_bytes)

    out = {}
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
        del coarse
        iters = 3 if tag == "chunk" else 20
        out[f"k3_{tag}_ms"] = cuda_ms(
            lambda: fr.march_bwd_cuda(packed, cfg, o, d, emb, z, *cot, g_field), iters)
        out[f"k4_{tag}_ms"] = cuda_ms(
            lambda: fr.merged_train_cuda(packed, cfg, o, d, emb, z, field, z_f, target), iters)
        out[f"k3_{tag}_bound_ms"], by3 = bound(cfg, n, sc, k3_bytes(n), backward=True)
        out[f"k4_{tag}_bound_ms"], by4 = bound(cfg, n, sf, k4_bytes(n), backward=True)
        if tag == "batch":
            out["k2_batch_ms"] = cuda_ms(
                lambda: fr.march_cuda(packed, cfg, o, d, emb, z, want_field=True), iters)
            out["k3_batch_plain_ms"] = cuda_ms(
                lambda: fr.march_bwd_plain(packed, cfg, o, d, emb, z, *cot, g_field), 5)
            out["k4_batch_plain_ms"] = cuda_ms(
                lambda: fr.merged_train_plain(packed, cfg, o, d, emb, z, field, z_f, target), 5)
            k2_bytes = 4 * n * (3 + 3 + e + sc) + 4 * n * (3 + 1 + 1 + sc + 4 * sc) + w_bytes
            out["k2_batch_bound_ms"], _ = bound(cfg, n, sc, k2_bytes)
            out["bound_by"] = (by3, by4)
        del cot, g_field, field, target

    # the training step at B = 1024 on a pool of 20 random 100x100 images
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, size=(20, 100, 100, 3), dtype=np.uint8)
    from danerf_tpu_torch.viz.paths import camera_path

    c2ws = np.stack([np.asarray(c, np.float32) for c in camera_path("circle", 20, cfg.scene)])
    ds = RayDataset(imgs, imgs[..., 0], c2ws, 138.9, cfg.near, cfg.far)
    model_t, table = init_model(cfg, 20, 0, device)
    opt, sched = make_optimizer(cfg, list(model_t.parameters()) + [table])
    pool = ds.device_arrays(device=device)
    gen = torch.Generator(device=device).manual_seed(0)

    def step():
        return train_step(model_t, table, opt, sched, pool, cfg, 100, 100, ds.focal, None, gen)

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
    kern_ms = out["k2_batch_ms"] + out["k3_batch_ms"] + out["k4_batch_ms"]

    # device time by kernel over 10 steps (torch.profiler, CUPTI)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n_prof = 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            step()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / n_prof
    kernels = sorted(((ev.key, ev.self_device_time_total / 1e3 / n_prof, ev.count / n_prof)
                      for ev in prof.key_averages()
                      # kernels and copies; a user range (Optimizer.step#...) on the
                      # device timeline spans others and would count them twice
                      if ev.device_type == DeviceType.CUDA
                      and not getattr(ev, "is_user_annotation", False)
                      and not ev.key.startswith("Optimizer.")),
                     key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    out.update({"profile_ms_per_step": [[k[0][:70], k[1], k[2]] for k in kernels[:14]],
                "profile_device_busy_ms_per_step": busy_ms,
                "profile_wall_ms_per_step": prof_wall_ms,
                "profile_idle_share": 1.0 - busy_ms / prof_wall_ms})
    out.update({"step_ms_median": step_ms, "step_ms_min": min(times),
                "step_ms_max": max(times), "rays_per_s": cfg.batch_size / (step_ms / 1e3),
                "k2_k3_k4_share": kern_ms / step_ms,
                "step_bound_ms": out["k2_batch_bound_ms"] + out["k3_batch_bound_ms"]
                + out["k4_batch_bound_ms"]})
    emit({"phase": "train_timing", "batch": cfg.batch_size, "chunk_rays": chunk[0].shape[0],
          **{k: v for k, v in out.items() if k != "bound_by"}})
    return out


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
    train_launches = phase_train(args.out)
    timing, bound_by = phase_timing(cfg, model, device, chunk)
    tt = phase_train_timing(cfg, model, device, chunk)

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
        # the backward kernels at the training batch (B = 1024 rays, 64 + 64)
        {"name": "K3 ray-march backward (want_field)", "route": "cuda",
         "source": "danerf_tpu_torch/kernels/csrc/march_bwd.cu",
         "replaces": "danerf_tpu/kernels/fused_render.py:212",
         "launches": train_launches["march_bwd"], "max_abs_err": errs["K3"],
         "ms": tt["k3_batch_ms"], "plain_ms": tt["k3_batch_plain_ms"],
         "bound_ms": tt["k3_batch_bound_ms"], "bound_by": tt["bound_by"][0], "library_ms": None},
        {"name": "K4 merged fine pass + MSE + backward", "route": "cuda",
         "source": "danerf_tpu_torch/kernels/csrc/merged_train.cu",
         "replaces": "danerf_tpu/kernels/fused_render.py:831",
         "launches": train_launches["merged_train"], "max_abs_err": errs["K4"],
         "ms": tt["k4_batch_ms"], "plain_ms": tt["k4_batch_plain_ms"],
         "bound_ms": tt["k4_batch_bound_ms"], "bound_by": tt["bound_by"][1], "library_ms": None},
    ]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
