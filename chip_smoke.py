"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--out DIR]

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. env      torch / CUDA versions and the card (nvidia-smi name, power limit).
2. build    compile every kernel from danerf_tpu_torch/kernels/csrc (nvcc,
            sm_90a, all sources at once); one line of each kernel's
            registers, shared memory and spills (-Xptxas -v; the tile and
            dW pass of K3, K4, K6 and K7 apart); the full reports go to
            DIR/build.log.
3. kernels  at full width (default NeRFConfig: 8x256, bf16) on seeded inputs,
            each kernel against its plain PyTorch version on the card,
            within fused_render.PLAIN_TOL, at 4093 rays (a ragged tile) and
            at one 65,536-ray chunk: K2 with want_field at 64 samples
            (medium's coarse pass) and without at 32 (preview), K5 at
            64 + 64 with z_f from sample_pdf of K2's weights; at 4093 rays
            the shapes of csrc/field_sm90.cuh's tile (tile_shapes: K2 at S =
            32, 48, 64, 100, 128 with and without its field, K5 at 64 + 64,
            64 + 16, 128 + 128 with and without the appearance projection,
            two calls bit for bit); K1 on the
            points of 4093 x 32 = 130,976 rows (ragged), and of 65,536 and
            131,072 rows (the coarse and fine evaluations of a 1024-ray
            batch), with and without the appearance projection; and
            render_rays' fused route against its reference route and its
            per-sample kernel route (K1) on 512 rays.
4. bwd      the backward and training kernels against their plain versions
            at 37 rays (19 blocks, so a lost or doubled block shows) and at
            the 1024-ray training batch: K3 with every cotangent seeded
            non-zero, want_field on and off; K4 and K7 with a seeded target
            (K4's field_c from K2, z_f from sample_pdf); K6 with every
            cotangent seeded and a coarse/fine tie in z; K8 with seeded
            per-row cotangents at 2,400 rows (19 tiles) and 131,072.
            Per-ray (per-row) outputs and the loss by max abs error, each
            parameter gradient by relative Frobenius error; K3, K7 and K8
            twice, which must agree bit for bit.
4a. bwd_shapes  K3, K7, K4 and K6 (csrc/field_bwd_sm90.cuh) at every shape
            their tile takes, at 37 rays, the 1024-ray batch and 4093 rays:
            K3 at S = 32, 48, 64, 100, 128 with every cotangent and g_field,
            without g_field, with only g_rgb, and at S = 64 with every
            cotangent null (exact zeros); K7 at the same S, seeded targets;
            K4 at Sc + Sf = 64 + 64, 64 + 16, 64 + 48, 128 + 128; K6 at the
            same with a coarse/fine tie under every cotangent, the
            white-background pattern (g_rgb, g_acc), only g_rgb and none
            (exact zeros); all with the appearance projection packed as
            zeros at 64 (+ 64); two calls bit for bit; the shapes K3, K4,
            K6, K7, K8 and K9 refuse; run again on the time model after
            4b.
4b. time_kernels  the has_time variants (use_time, 6 time levels: the
            encoded time at the first and the skip layers, kx = 80) on a
            model of their own, each ray's (row's) time uniform in [0, 1]:
            K2 (want_field) and K5 at 4093 rays and on a 65,536-ray chunk,
            and at tile_shapes' shapes; K3 and K6 (every cotangent; K6 with a coarse/fine tie) at 37
            rays and at B = 1024, K4 and K7 at 37 rays, K1 at 130,976 rows
            and K8 at 37, 129 and 2,400 rows, against their plain versions.
4c. hier_onepass  K9, the one-kernel hierarchical training step, and its
            has_time variant on the time model, against their plain
            versions at 37 rays and at B = 1024, at Sc + Sf = 64 + 64,
            64 + 16, 128 + 128, 48 + 32 and 32 + 64 (seeded targets,
            uniforms from importance_uniforms); both MSEs, every gradient
            and demb; two calls agree bit for bit.
5. step     one training step at B = 1024 on each training path (64 + 64;
            coarse only, num_importance=0; 64 + 64 on a white background;
            64 + 64 per sample, use_fused_train=False; 64 + 64 with
            use_time; 64 + 64 in one kernel, use_hier_onepass), each built
            twice from the same module, table, batch and draws: through the
            kernels and through their plain versions; the launches, loss,
            every gradient and the parameters after one Adam step compared;
            the one-kernel step also against the 64 + 64 step through K2,
            K4 and K3.
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
            K5, K6 and K3 a step); then 100 steps of the per-sample route,
            which has no CLI flag (nor has the JAX CLI): train() with
            use_fused_train=False (two K1 and two K8 a step and nothing
            else); 100 steps of `--use_time` on the time-varying scene (one
            K2, K5, K6 and K3 a step, the has_time variants; then `render
            --use_time --animate_time` of its checkpoint, two 400x400 medium
            frames); 100 steps of use_hier_onepass, which has no CLI flag
            either, through train() (one K9 a step and nothing else); finite
            losses and a rising PSNR.
8. timing   CUDA-event times of every kernel and its plain version, each
            beside its bound: K2 (want_field) and K5 on a 65,536-ray chunk,
            K3, K4, K6, K7 and K9 on a chunk and at B = 1024 (plain versions
            at B = 1024; K9 beside K2 + K4 + K3), K1 at 65,536 and 131,072
            rows and on a chunk's 4,194,304 sample rows, K8 at 65,536 and
            131,072 rows; an 800x800 medium frame end to end (median of
            three after a warm-up frame; exactly 10 K2 and 10 K5 launches a
            frame and no other kernel); the training step of each path at
            B = 1024 (median of 50 synchronised steps) with its rays/s and
            its kernels' share, and the device time by kernel over 10 steps
            (torch.profiler) of the 64 + 64, the coarse-only, the
            white-background, the per-sample and the K9 step; then the same
            for use_time: the has_time K2/K5 on the chunk, K3-K7 and K9 at
            B = 1024 and K1/K8 at 131,072 rows with their plain versions, an
            800x800 medium frame at t = 0.5, and the use_time step,
            profiled.  K3, K4, K6 and K7 at the batch are also broken down
            by kernel (tile, dW pass) beside torch.matmul over the same dW
            products (dw_cublas_ms, a yardstick only), and each profiled
            step by part (their tile, their dW pass, the rest).

Before the last line it prints the card's name and power limit and the
{"kernels": [...]} record (each kernel with its has_time variant's numbers
under "has_time"); the last line is the ok record.  Exits non-zero,
printing no result, when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
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
    appearance projection, which depends only on the ray's embedding.  With
    use_time the encoded time enters the first and the skip layers."""
    h, half = cfg.hidden_dim, cfg.hidden_dim // 2
    per_sample = 0
    pos_in = cfg.pos_enc_dim + (cfg.time_enc_dim if cfg.use_time else 0)
    k = pos_in
    for i in range(cfg.num_layers):
        if i in cfg.skip_connect_layers and i > 0:
            k = h + pos_in
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


def sample_rows(rays, cfg, seed, device, samples):
    """The per-sample route's rows for ``rays`` seeded rays of ``samples``
    stratified depths: flat points o + z d, and each row's direction and
    embedding (its ray's)."""
    o, d, emb, z = make_rays(rays, cfg, seed, device, samples=samples)

    def per_row(t):
        return t[:, None, :].expand(-1, samples, -1).reshape(-1, t.shape[-1]).contiguous()

    return (o[:, None, :] + z[..., None] * d[:, None, :]).reshape(-1, 3), per_row(d), per_row(emb)


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


def ptxas_resources(log):
    """Registers, static shared memory and spills from a source's ``nvcc
    -Xptxas -v`` output (the most registers and static shared memory of its
    functions, the spills summed over them)."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = [(int(a), int(b)) for a, b in
              re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    smem = [int(m) for m in re.findall(r"(\d+) bytes smem", log)]
    return {"registers": max(regs, default=None), "static_smem": max(smem, default=0),
            "spill_stores": sum(a for a, _ in spills), "spill_loads": sum(b for _, b in spills)}


def function_resources(log, name):
    """ptxas_resources of the functions of ``log`` whose mangled name holds
    ``name``."""
    blocks = re.split(r"(?=ptxas info\s*: Compiling entry function)", log)
    return ptxas_resources("".join(b for b in blocks if name in b.split("\n", 1)[0]))


def phase_build(out_dir):
    """Build every kernel; one line with each one's registers, shared
    memory and spills (K2 and K5, ``csrc/field_sm90.cuh``, take dynamic
    shared memory, which ptxas does not report: it is read from the
    library)."""
    from danerf_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build(force=True)
    secs = time.perf_counter() - t0
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        for name, log in logs.items():
            f.write(f"==== {name}.cu\n{log}\n")
    res = {n: ptxas_resources(log) for n, log in logs.items()}
    for n in ("march", "merged"):
        res[n]["dynamic_smem"] = int(_build.load(n).danerf_tile_smem_bytes())
    # K3, K4, K6, K7, K8 and K9 (csrc/field_bwd_sm90.cuh): the tile kernel and
    # the dW pass apart, each with its dynamic shared memory
    for n in ("march_bwd", "merged_train", "merged_bwd", "march_train", "mlp_bwd",
              "hier_onepass"):
        lib = _build.load(n)
        tile = "hier_tile90" if n == "hier_onepass" else "bwd_tile90"
        for fn, key, smem in ((tile, "tile", lib.danerf_bwd_tile_smem_bytes),
                              ("dw90_kernel", "dw_pass", lib.danerf_dw90_smem_bytes)):
            res[n][key] = {**function_resources(logs[n], fn), "dynamic_smem": int(smem())}
    emit({"phase": "build", "seconds": secs, "built": sorted(logs), "resources": res})


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


def tile_shapes(cfg, model, device, errs, failures, tag, with_time):
    """K2 and K5 at the shapes field_sm90.cuh's tile takes, against their
    plain versions at 4093 rays (a ragged last tile): K2 at S = 32, 48, 64,
    100, 128 (1 to 4 rays a 128-row tile, rays that straddle its two
    warpgroups or fill both), with and without its field; K5 at Sc + Sf =
    64 + 64, 64 + 16, 128 + 128 (2, 8 and 1 rays a tile), with the
    appearance projection and packed as zeros.  ``tag`` is "" or "t" (the
    time model, each ray's time uniform in [0, 1]).  Two calls must agree
    bit for bit."""
    import torch

    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import pack_params
    from danerf_tpu_torch.ops.sampling import sample_pdf

    n, same = 4093, True
    packs = (("", pack_params(model, cfg)), ("_noapp", pack_params(model, cfg, appearance=False)))
    for s in (32, 48, 64, 100, 128):
        o, d, emb, z = make_rays(n, cfg, seed=10 + s, device=device, samples=s)
        t = (torch.rand(n, 1, generator=torch.Generator(device=device).manual_seed(s),
                        device=device) if with_time else None)
        for wf in (True, False):
            args = (packs[0][1], cfg, o, d, emb, z, t)
            want = fr.march_plain(*args, want_field=wf)
            got, again = fr.march_cuda(*args, want_field=wf), fr.march_cuda(*args, want_field=wf)
            torch.cuda.synchronize()
            compare(errs, failures, f"K2{tag}@{n}x{s}{'_field' if wf else ''}", got, want,
                    ["rgb", "depth", "acc", "weights"] + (["field"] if wf else []))
            same &= all(bool(torch.equal(got[k], again[k])) for k in got)
    for sc, sf in ((64, 64), (64, 16), (128, 128)):
        o, d, emb, z = make_rays(n, cfg, seed=20 + sf, device=device, samples=sc)
        g = torch.Generator(device=device).manual_seed(sc + sf)
        t = torch.rand(n, 1, generator=g, device=device) if with_time else None
        for app, pk in packs:
            e = emb if app == "" else torch.zeros_like(emb)
            coarse = fr.march_plain(pk, cfg, o, d, e, z, t, want_field=True)
            z_f = sample_pdf(z, coarse["weights"], sf, True, rand=g)
            args = (pk, cfg, o, d, e, z, coarse["field"], z_f, t)
            want = fr.merged_plain(*args)
            got, again = fr.merged_cuda(*args), fr.merged_cuda(*args)
            torch.cuda.synchronize()
            compare(errs, failures, f"K5{tag}@{n}x{sc}+{sf}{app}", got, want,
                    ["rgb", "depth", "acc", "weights", "z_vals"])
            same &= all(bool(torch.equal(got[k], again[k])) for k in got)
    if not same:
        failures.append(f"K2{tag}/K5{tag} gave different results on the same inputs")


def refusals(cfg, packed, device):
    """The shapes the backward tile's kernels refuse: K3 and K7 at S = 129;
    K4 and K6 at Sc + Sf = 64 + 129, 200 + 64 and where the merge arrays
    pass their limit (126 + 16), as on the old tile, while 125 + 16 is
    taken; and S or Sf = 0, which the old tile divided by; K8 with an
    embedding of 24 (its appearance product steps K by 16); K9 at Sc + Sf =
    129 + 64, 64 + 129, 0 + 64 and 64 + 0, as on its first tile.  Returns
    what went otherwise."""
    import torch

    from danerf_tpu_torch.kernels import fused_mlp as fm
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import pack_params
    from danerf_tpu_torch.ops.sampling import importance_uniforms

    n, out = 37, []
    o, d, emb, z = make_rays(n, cfg, seed=95, device=device, samples=129)
    g = torch.Generator(device=device).manual_seed(95)
    target = torch.rand(n, 3, generator=g, device=device)
    field = fr.march_plain(packed, cfg, o, d, emb, z[:, :64], want_field=True)["field"]
    calls = {}
    for s in (0, 129):
        zs = z[:, :s].contiguous()
        calls[f"K3@{s}"] = lambda zs=zs: fr.march_bwd_cuda(packed, cfg, o, d, emb, zs, None,
                                                           None, None, None)
        calls[f"K7@{s}"] = lambda zs=zs: fr.march_train_cuda(packed, cfg, o, d, emb, zs, target)
    for sc, sf in ((64, 129), (200, 64), (64, 0), (126, 16), (125, 16)):
        zc = torch.sort(torch.rand(n, sc, generator=g, device=device) * 4 + 2, dim=-1)[0]
        fc = field[:, :, :1].expand(-1, -1, sc).contiguous()
        zf = torch.sort(torch.rand(n, sf, generator=g, device=device) * 4 + 2, dim=-1)[0]
        args = (packed, cfg, o, d, emb, zc, fc, zf)
        calls[f"K4@{sc}+{sf}"] = lambda a=args: fr.merged_train_cuda(*a, target)
        calls[f"K6@{sc}+{sf}"] = lambda a=args: fr.merged_bwd_cuda(*a, target, None, None, None)
    cfg24 = cfg.replace(appearance_dim=24)
    x, dr, _ = sample_rows(1, cfg, 96, device, n)
    calls["K8@E24"] = lambda: fm.fused_bwd_cuda(
        pack_params(make_model(cfg24, 0, device), cfg24), cfg24, x, dr,
        torch.randn(n, 24, generator=g, device=device), target, target[:, :1])
    for sc, sf in ((129, 64), (64, 129), (0, 64), (64, 0)):
        u = importance_uniforms((n,), sf, True, rand=g, device=device)
        calls[f"K9@{sc}+{sf}"] = lambda zc=z[:, :sc].contiguous(), u=u: fr.hier_onepass_cuda(
            packed, cfg, o, d, emb, zc, u, target)
    for name, call in calls.items():
        taken = name.endswith("125+16")
        try:
            call()
            torch.cuda.synchronize()
            if not taken:
                out.append(f"{name} was taken; it must be refused")
        except RuntimeError as exc:
            if taken or "a width this kernel does not take" not in str(exc):
                out.append(f"{name}: {exc}")
    return out


def phase_bwd_shapes(cfg, model, device, tag):
    """K3, K7, K4 and K6 at every shape csrc/field_bwd_sm90.cuh's tile takes,
    against their plain versions at 37 rays (a lost or doubled CTA shows),
    at the 1024-ray batch and at 4093 rays (a ragged last tile): K3 at S =
    32, 48, 64, 100, 128 with every cotangent and g_field, without g_field,
    and with only g_rgb (the null ones read as zeros), and at S = 64 with
    every cotangent null (all outputs exactly zero); K7 at the same S with
    seeded targets; K4 at Sc + Sf = 64 + 64, 64 + 16, 64 + 48, 128 + 128;
    K6 at the same Sc + Sf with a coarse/fine tie, under every cotangent,
    the white-background pattern (g_rgb and g_acc), only g_rgb and none
    (all outputs exactly zero); all four at 64 (+ 64) samples with the
    appearance projection packed as zeros.  ``tag`` is "" or "t" (the time
    model, each ray's time uniform in [0, 1]).  Two calls must agree bit
    for bit.  Without time, the shapes they refuse (``refusals``).  Returns
    the worst per-ray abs error of each kernel."""
    import torch

    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import pack_params
    from danerf_tpu_torch.ops.sampling import sample_pdf

    tol = fr.PLAIN_TOL
    packs = {"": pack_params(model, cfg), "_noapp": pack_params(model, cfg, appearance=False)}
    errs, grad_rel, failures, same = {}, {}, [], True
    check, check_grads = checks(errs, grad_rel, failures, model)

    def equal(a, b):
        return all(bool(torch.equal(x, y)) for x, y in zip(a, b))

    def zero(name, *outs):
        check(f"{name}.zero", max(float(x.abs().max()) for x in outs), 0.0)

    for n in (37, cfg.batch_size, 4093):
        for s in (32, 48, 64, 100, 128):
            o, d, emb, z = make_rays(n, cfg, seed=70 + s, device=device, samples=s)
            g = torch.Generator(device=device).manual_seed(n + s)
            t = torch.rand(n, 1, generator=g, device=device) if cfg.use_time else None
            g_rgb, g_depth, g_acc, g_w, g_field = _cotangents(n, s, g, device)
            cases = {"_field": (g_rgb, g_depth, g_acc, g_w, g_field),
                     "": (g_rgb, g_depth, g_acc, g_w, None),
                     "_rgb_only": (g_rgb, None, None, None, None)}
            if s == 64:
                cases["_null"] = (None,) * 5
                cases["_field_noapp"] = cases["_field"]
            for case, cot in cases.items():
                pk = packs["_noapp" if case.endswith("noapp") else ""]
                e = torch.zeros_like(emb) if case.endswith("noapp") else emb
                name = f"K3{tag}@{n}x{s}{case}"
                gk, dk = fr.march_bwd_cuda(pk, cfg, o, d, e, z, *cot, t=t)
                gk2, dk2 = fr.march_bwd_cuda(pk, cfg, o, d, e, z, *cot, t=t)
                same &= equal((gk.mats, gk.vecs, dk), (gk2.mats, gk2.vecs, dk2))
                if case == "_null":
                    torch.cuda.synchronize()
                    zero(name, gk.mats, gk.vecs, dk)
                    continue
                gp, dp = fr.march_bwd_plain(pk, cfg, o, d, e, z, *cot, t=t)
                torch.cuda.synchronize()
                check_grads(name, gk, gp)
                check(f"{name}.demb", max_err(dk, dp), tol["demb"])
            target = torch.rand(n, 3, generator=g, device=device)
            for app in (("", "_noapp") if s == 64 else ("",)):
                pk = packs[app]
                e = torch.zeros_like(emb) if app else emb
                args = (pk, cfg, o, d, e, z, target, t)
                name = f"K7{tag}@{n}x{s}{app}"
                got, again = fr.march_train_cuda(*args), fr.march_train_cuda(*args)
                lp, gp, dp = fr.march_train_plain(*args)
                torch.cuda.synchronize()
                lk, gk, dk = got
                same &= equal((lk, gk.mats, gk.vecs, dk),
                              (again[0], again[1].mats, again[1].vecs, again[2]))
                check_grads(name, gk, gp)
                check(f"{name}.loss", abs(float(lk) - float(lp)), tol["loss"])
                check(f"{name}.demb", max_err(dk, dp), tol["demb_k4"])
        for sc, sf in ((64, 64), (64, 16), (64, 48), (128, 128)):
            o, d, emb, z = make_rays(n, cfg, seed=80 + sf, device=device, samples=sc)
            g = torch.Generator(device=device).manual_seed(n + sc + sf)
            t = torch.rand(n, 1, generator=g, device=device) if cfg.use_time else None
            target = torch.rand(n, 3, generator=g, device=device)
            for app in (("", "_noapp") if (sc, sf) == (64, 64) else ("",)):
                pk = packs[app]
                e = torch.zeros_like(emb) if app else emb
                coarse = fr.march_plain(pk, cfg, o, d, e, z, t, want_field=True)
                z_f = sample_pdf(z, coarse["weights"], sf, True, rand=g)
                args = (pk, cfg, o, d, e, z, coarse["field"], z_f, target, t)
                name = f"K4{tag}@{n}x{sc}+{sf}{app}"
                got, again = fr.merged_train_cuda(*args), fr.merged_train_cuda(*args)
                lp, gp, dp, fp = fr.merged_train_plain(*args)
                torch.cuda.synchronize()
                lk, gk, dk, fk = got
                same &= equal((lk, gk.mats, gk.vecs, dk, fk),
                              (again[0], again[1].mats, again[1].vecs, again[2], again[3]))
                check_grads(name, gk, gp)
                check(f"{name}.loss", abs(float(lk) - float(lp)), tol["loss"])
                check(f"{name}.demb", max_err(dk, dp), tol["demb_k4"])
                check(f"{name}.g_field", max_err(fk, fp), tol["g_field"])
                # K6 on the same coarse field, with a coarse/fine tie
                z_t = _tie(z, z_f)
                c6 = _cotangents(n, sc + sf, g, device)[:4]
                cases = {"": c6, "_white": (c6[0], None, c6[2], None),
                         "_rgb_only": (c6[0], None, None, None), "_null": (None,) * 4}
                for case, cot in (cases.items() if not app else [("", c6)]):
                    name = f"K6{tag}@{n}x{sc}+{sf}{app}{case}"
                    args = (pk, cfg, o, d, e, z, coarse["field"], z_t, *cot)
                    gk, dk, fk = fr.merged_bwd_cuda(*args, t=t)
                    gk2, dk2, fk2 = fr.merged_bwd_cuda(*args, t=t)
                    same &= equal((gk.mats, gk.vecs, dk, fk), (gk2.mats, gk2.vecs, dk2, fk2))
                    if case == "_null":
                        torch.cuda.synchronize()
                        zero(name, gk.mats, gk.vecs, dk, fk)
                        continue
                    gp, dp, fp = fr.merged_bwd_plain(*args, t=t)
                    torch.cuda.synchronize()
                    check_grads(name, gk, gp)
                    check(f"{name}.demb", max_err(dk, dp), tol["demb"])
                    check(f"{name}.g_field", max_err(fk, fp), tol["g_field_k6"])
    if not same:
        failures.append(f"K3{tag}/K7{tag}/K4{tag}/K6{tag} gave different results on the same "
                        "inputs")
    if not cfg.use_time:
        failures += refusals(cfg, packs[""], device)
    emit({"phase": "bwd_shapes", "use_time": cfg.use_time, "rays": [37, cfg.batch_size, 4093],
          "max_abs_err": errs, "grad_rel": grad_rel, "deterministic": same,
          "failures": failures})
    if failures:
        raise AssertionError("K3/K7/K4/K6 disagree with their plain versions: "
                             + "; ".join(failures))
    return {kern: max(v for k, v in errs.items() if k.startswith(kern))
            for kern in ("K3", "K4", "K6", "K7")}


def phase_kernels(cfg, model, device):
    """Each kernel against its plain version at the shapes the main path
    gives it: 4093 rays (a ragged tile) and one full 65,536-ray chunk; K2 with
    want_field at 64 samples (medium) and without at 32 (preview); K5 at
    64 + 64 with z_f from sample_pdf of K2's weights; K1 at the rows of the
    per-sample route.  Returns the max abs errors per kernel and the chunk's
    inputs for the timing phase."""
    import torch

    from danerf_tpu_torch.kernels import fused_mlp as fm
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
        chunk = (o, d, emb, z, z_f, None)
    tile_shapes(cfg, model, device, errs, failures, "", with_time=False)

    # K1 on flat points: the samples of 4093 rays x 32 (130,976 rows, a
    # ragged tile), and the coarse (65,536) and fine (131,072) evaluations
    # of a 1024-ray batch; with and without the appearance projection
    no_app = pack_params(model, cfg, appearance=False)
    for rays, s_per, seed in ((4093, 32, 1), (1024, 64, 2), (1024, 128, 3)):
        x, dr, er = sample_rows(rays, cfg, seed, device, s_per)
        n = x.shape[0]
        for tag, pk, e in (("", packed, er), ("_noapp", no_app, torch.zeros_like(er))):
            rk, sk = fm.fused_fwd_cuda(pk, cfg, x, dr, e)
            rp, sp = fm.fused_fwd_plain(pk, cfg, x, dr, e)
            torch.cuda.synchronize()
            checks = {"field_rgb": max_err(rk, rp),
                      "field_sigma": max_err((sk - sp) / sp.abs().clamp_min(1.0), 0 * sp)}
            for name, e_ in checks.items():
                errs[f"K1@{n}{tag}.{name}"] = e_
                if not math.isfinite(e_) or e_ > fr.PLAIN_TOL[name]:
                    failures.append(f"K1@{n}{tag}.{name}: {e_} > {fr.PLAIN_TOL[name]}")
            errs[f"K1@{n}{tag}.sigma"] = max_err(sk, sp)
        del x, dr, er, rk, sk, rp, sp

    # the fused route against the reference route (module forward at every
    # sample: nerf_apply's encoding form, sin(2^i (o + z d)) whose f32
    # rounding 2^9 amplifies, and bf16 density matmul; sorted union) and
    # against the per-sample kernel route (K1 at every sample; sorted union)
    n = 512
    o, d, emb = (x[:n] for x in chunk[:3])
    with torch.no_grad():
        ker = render_rays(model, cfg, o, d, emb, perturb=False, fused_composite=True)
        routes = {"render_rays": render_rays(model, cfg.replace(use_kernels=False), o, d, emb,
                                             perturb=False, fused_composite=False),
                  "render_rays_per_sample": render_rays(model, cfg, o, d, emb, perturb=False,
                                                        fused_composite=False)}
    torch.cuda.synchronize()
    slice_tol = {"rgb": 5e-3, "acc": 5e-3, "depth": 2e-2}
    for route, ref in routes.items():
        for k, t in slice_tol.items():
            e = max_err(ker[k], ref[k])
            errs[f"{route}.{k}"] = e
            if not math.isfinite(e) or e > t:
                failures.append(f"{route}.{k}: {e} > {t}")

    emit({"phase": "kernels", "rays": [4093, cfg.render_chunk],
          "k1_rows": [4093 * 32, 65536, 131072], "max_abs_err": errs,
          "tolerance": {**fr.PLAIN_TOL, **{f"render_rays.{k}": v for k, v in slice_tol.items()}},
          "mean_acc": mean_acc, "failures": failures})
    if failures:
        raise AssertionError("kernel disagrees with its plain version: " + "; ".join(failures))
    # the kernels record takes absolute errors (field_sigma's is relative)
    worst = {kern: max(v for k, v in errs.items()
                       if k.startswith(kern) and not k.endswith("field_sigma"))
             for kern in ("K1", "K2", "K5")}
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


def checks(errs, grad_rel, failures, model):
    """(check, check_grads): record a max abs error (in ``errs``) or each
    parameter gradient's relative Frobenius error against the kernel's plain
    version (the worst in ``grad_rel``) and append to ``failures`` what is
    over its limit or not finite."""
    from danerf_tpu_torch.kernels import fused_render as fr

    limit_g = fr.PLAIN_TOL["grad_rel"]

    def check(name, err, limit):
        errs[name] = err
        if not math.isfinite(err) or err > limit:
            failures.append(f"{name}: {err} > {limit}")

    def check_grads(tag, got, want):
        rel = fr.grad_rel_errors(got, want, model)
        worst = max(rel, key=rel.get)
        grad_rel[tag] = {"worst": rel[worst], "param": worst}
        if not math.isfinite(rel[worst]) or rel[worst] > limit_g:
            failures.append(f"{tag}.grad_rel {worst}: {rel[worst]} > {limit_g}")

    return check, check_grads


def phase_bwd(cfg, model, device):
    """The backward and training kernels against their plain versions at 37
    rays and at the 1024-ray batch: K3 (every cotangent seeded, want_field on
    and off), K4 and K7 (seeded targets), K6 (every cotangent seeded,
    weights in merged order, a coarse/fine tie in z); K8 at 37, 129 (one
    tile and one row), 2,400 (19 tiles, the last ragged), 65,536 and
    131,072 rows (a 1024-ray batch's coarse and fine rows), with the
    appearance projection and packed as zeros (a zero embedding).  K3, K7
    and K8 run twice and must agree bit for bit.
    Returns the max abs error of each kernel's per-ray (per-row) outputs
    (and loss) for the kernels record."""
    import torch

    from danerf_tpu_torch.kernels import fused_mlp as fm
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import PackedGrads, pack_params
    from danerf_tpu_torch.ops.sampling import sample_pdf

    tol = fr.PLAIN_TOL
    packed = pack_params(model, cfg)
    sa = cfg.num_samples + cfg.num_importance
    errs, grad_rel, failures, deterministic, drop = {}, {}, [], {"K3": True, "K7": True}, {}
    check, check_grads = checks(errs, grad_rel, failures, model)

    def same(a, b):
        return bool(torch.equal(a.mats, b.mats) and torch.equal(a.vecs, b.vecs))

    def dropped(kern, got, want, first=2, **first_block):
        """What losing the first block (2 rays at 64 samples; K8: 128 rows)
        does: the summed gradients' relative change, and the block's per-ray
        (per-row) outputs, which would be missing."""
        eff = fr.grad_rel_errors(got, want, model)
        drop[kern] = {"grad_rel_min": min(eff.values()), "grad_rel_max": max(eff.values()),
                      **{k: float(v[:first].abs().max()) for k, v in first_block.items()}}

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

    # K8: the per-sample field's backward under seeded per-row cotangents,
    # at 37 and 129 rows (below one tile, one tile and a row), 2,400 (19
    # tiles, the last ragged), and the 65,536 and 131,072 rows of a 1024-ray
    # batch's coarse and fine evaluations; with the appearance projection
    # and packed as zeros (a zero embedding)
    deterministic["K8"] = True
    packed_noapp = pack_params(model, cfg, appearance=False)
    for n, seed in ((37, 15), (129, 16), (2400, 13), (cfg.batch_size * cfg.num_samples, 17),
                    (2 * cfg.batch_size * cfg.num_samples, 14)):
        x, dr, er = (t[:n] for t in sample_rows(-(-n // cfg.num_samples), cfg, seed, device,
                                                cfg.num_samples))
        g = torch.Generator(device=device).manual_seed(seed + 100)
        g_rgb = torch.randn(n, 3, generator=g, device=device)
        g_sig = torch.randn(n, 1, generator=g, device=device)
        for app, pk, e in (("", packed, er), ("_noapp", packed_noapp, torch.zeros_like(er))):
            gk, dk = fm.fused_bwd_cuda(pk, cfg, x, dr, e, g_rgb, g_sig)
            gk2, dk2 = fm.fused_bwd_cuda(pk, cfg, x, dr, e, g_rgb, g_sig)
            gp, dp = fm.fused_bwd_plain(pk, cfg, x, dr, e, g_rgb, g_sig)
            torch.cuda.synchronize()
            deterministic["K8"] &= same(gk, gk2) and bool(torch.equal(dk, dk2))
            check_grads(f"K8@{n}{app}", gk, gp)
            check(f"K8@{n}{app}.demb", max_err(dk, dp), tol["demb_k8"])
            errs[f"K8@{n}{app}.demb_scale"] = float(dp.abs().max())
            if n == 2400 and not app:
                gd, _ = fm.fused_bwd_plain(pk, cfg, x[128:], dr[128:], e[128:], g_rgb[128:],
                                           g_sig[128:])
                dropped("K8", gd, gp, first=128, demb=dp)
            del gk, gk2, gp, dk, dk2, dp
    for kern, ok in deterministic.items():
        if not ok:
            failures.append(f"{kern} gave different results on the same inputs")
    emit({"phase": "bwd", "rays": [37, cfg.batch_size], "max_abs_err": errs,
          "grad_rel": grad_rel, "dropped_block_effect_at_37": drop,
          "deterministic": deterministic,
          "tolerance": {k: tol[k] for k in ("grad_rel", "demb", "demb_k4", "g_field",
                                            "g_field_k6", "loss", "demb_k8")},
          "failures": failures})
    if failures:
        raise AssertionError("backward kernel disagrees with its plain version: "
                             + "; ".join(failures))
    return {kern: max(v for k, v in errs.items() if k.startswith(kern) and "scale" not in k)
            for kern in ("K3", "K4", "K6", "K7", "K8")}


def phase_time_kernels(cfg, model, device):
    """The has_time variants (use_time: the encoded time at the first and
    the skip layers, kx = 80) against their plain versions, each ray's (each
    row's) time uniform in [0, 1]: K2 with want_field and K5 (z_f from
    sample_pdf) at 4093 rays and on one 65,536-ray chunk; K3 (every
    cotangent, g_field) and K6 (every cotangent, a coarse/fine tie) at 37
    rays and at the 1024-ray batch; K4 and K7 (seeded targets) at 37 rays;
    K1 at 4093 x 32 = 130,976 rows (ragged) and K8 at 37, 129 and 2,400
    rows (19 tiles).  Returns the worst abs error per kernel and the chunk's inputs
    (with t) for the timing phase."""
    import torch

    from danerf_tpu_torch.kernels import fused_mlp as fm
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import pack_params
    from danerf_tpu_torch.ops.sampling import sample_pdf

    tol = fr.PLAIN_TOL
    packed = pack_params(model, cfg)
    errs, grad_rel, failures = {}, {}, []
    check, check_grads = checks(errs, grad_rel, failures, model)

    def times(n, seed):
        return torch.rand(n, 1, generator=torch.Generator(device=device).manual_seed(seed),
                          device=device)

    chunk = None
    for n, seed in ((4093, 41), (cfg.render_chunk, 44)):
        o, d, emb, z = make_rays(n, cfg, seed=seed, device=device)
        t = times(n, seed + 1)
        want_f = fr.march_plain(packed, cfg, o, d, emb, z, t, want_field=True)
        got_f = fr.march_cuda(packed, cfg, o, d, emb, z, t, want_field=True)
        torch.cuda.synchronize()
        compare(errs, failures, f"K2t_field@{n}", got_f, want_f,
                ["rgb", "depth", "acc", "weights", "field"])
        g = torch.Generator(device=device).manual_seed(seed + 2)
        z_f = sample_pdf(z, want_f["weights"], cfg.num_importance, True, rand=g)
        want_m = fr.merged_plain(packed, cfg, o, d, emb, z, want_f["field"], z_f, t)
        got_m = fr.merged_cuda(packed, cfg, o, d, emb, z, want_f["field"], z_f, t)
        torch.cuda.synchronize()
        compare(errs, failures, f"K5t@{n}", got_m, want_m,
                ["rgb", "depth", "acc", "weights", "z_vals"])
        del want_f, got_f, want_m, got_m
        chunk = (o, d, emb, z, z_f, t)
    tile_shapes(cfg, model, device, errs, failures, "t", with_time=True)

    for n, seed in ((37, 51), (cfg.batch_size, 52)):
        o, d, emb, z = make_rays(n, cfg, seed=seed, device=device)
        t = times(n, seed + 1)
        g = torch.Generator(device=device).manual_seed(seed + 100)
        *cot, g_field = _cotangents(n, cfg.num_samples, g, device)
        gk, dk = fr.march_bwd_cuda(packed, cfg, o, d, emb, z, *cot, g_field, t=t)
        gp, dp = fr.march_bwd_plain(packed, cfg, o, d, emb, z, *cot, g_field, t=t)
        torch.cuda.synchronize()
        check_grads(f"K3t_field@{n}", gk, gp)
        check(f"K3t_field@{n}.demb", max_err(dk, dp), tol["demb"])
        coarse = fr.march_cuda(packed, cfg, o, d, emb, z, t, want_field=True)
        z_f = sample_pdf(z, coarse["weights"], cfg.num_importance, True, rand=g)
        z_t = _tie(z, z_f)
        c6 = (torch.randn(n, 3, generator=g, device=device),
              torch.randn(n, generator=g, device=device),
              torch.randn(n, generator=g, device=device),
              0.1 * torch.randn(n, cfg.num_samples + cfg.num_importance, generator=g,
                                device=device))
        gk, dk, fk = fr.merged_bwd_cuda(packed, cfg, o, d, emb, z, coarse["field"], z_t, *c6,
                                        t=t)
        gp, dp, fp = fr.merged_bwd_plain(packed, cfg, o, d, emb, z, coarse["field"], z_t, *c6,
                                         t=t)
        torch.cuda.synchronize()
        check_grads(f"K6t@{n}", gk, gp)
        check(f"K6t@{n}.demb", max_err(dk, dp), tol["demb"])
        check(f"K6t@{n}.g_field", max_err(fk, fp), tol["g_field_k6"])
        if n == 37:
            # K4 and K7 take t too, though no route of either package reaches them with it
            target = torch.rand(n, 3, generator=g, device=device)
            lk, gk, dk, fk = fr.merged_train_cuda(packed, cfg, o, d, emb, z, coarse["field"],
                                                  z_f, target, t)
            lp, gp, dp, fp = fr.merged_train_plain(packed, cfg, o, d, emb, z, coarse["field"],
                                                   z_f, target, t)
            torch.cuda.synchronize()
            check_grads(f"K4t@{n}", gk, gp)
            check(f"K4t@{n}.loss", abs(float(lk) - float(lp)), tol["loss"])
            check(f"K4t@{n}.demb", max_err(dk, dp), tol["demb_k4"])
            check(f"K4t@{n}.g_field", max_err(fk, fp), tol["g_field"])
            lk, gk, dk = fr.march_train_cuda(packed, cfg, o, d, emb, z, target, t)
            lp, gp, dp = fr.march_train_plain(packed, cfg, o, d, emb, z, target, t)
            torch.cuda.synchronize()
            check_grads(f"K7t@{n}", gk, gp)
            check(f"K7t@{n}.loss", abs(float(lk) - float(lp)), tol["loss"])
            check(f"K7t@{n}.demb", max_err(dk, dp), tol["demb_k4"])
        del coarse

    # K1 on the samples of 4093 rays x 32 (130,976 rows, a ragged tile), K8
    # at 37, 129 and 2,400 rows (19 tiles), each row with its own time
    x, dr, er = sample_rows(4093, cfg, 61, device, 32)
    t = times(x.shape[0], 62)
    rk, sk = fm.fused_fwd_cuda(packed, cfg, x, dr, er, t)
    rp, sp = fm.fused_fwd_plain(packed, cfg, x, dr, er, t)
    torch.cuda.synchronize()
    check(f"K1t@{x.shape[0]}.field_rgb", max_err(rk, rp), tol["field_rgb"])
    check(f"K1t@{x.shape[0]}.field_sigma", max_err((sk - sp) / sp.abs().clamp_min(1.0), 0 * sp),
          tol["field_sigma"])
    for n, seed in ((37, 64), (129, 65), (2400, 63)):
        g = torch.Generator(device=device).manual_seed(seed)
        g_rgb = torch.randn(n, 3, generator=g, device=device)
        g_sig = torch.randn(n, 1, generator=g, device=device)
        rows = (x[:n], dr[:n], er[:n], g_rgb, g_sig, t[:n])
        gk, dk = fm.fused_bwd_cuda(packed, cfg, *rows)
        gp, dp = fm.fused_bwd_plain(packed, cfg, *rows)
        torch.cuda.synchronize()
        check_grads(f"K8t@{n}", gk, gp)
        check(f"K8t@{n}.demb", max_err(dk, dp), tol["demb_k8"])
    emit({"phase": "time_kernels", "time_enc_levels": cfg.time_enc_levels,
          "rays": [4093, cfg.render_chunk, 37, cfg.batch_size], "k1_rows": 4093 * 32,
          "k8_rows": [37, 129, 2400], "max_abs_err": errs, "grad_rel": grad_rel,
          "failures": failures})
    if failures:
        raise AssertionError("has_time kernel disagrees with its plain version: "
                             + "; ".join(failures))
    # the kernels record takes absolute errors (field_sigma's is relative)
    worst = {kern: max(v for k, v in errs.items()
                       if k.startswith(kern + "t") and not k.endswith("field_sigma"))
             for kern in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8")}
    return worst, chunk


def phase_hier_onepass(cfg, model, cfg_t, model_t, device):
    """K9, the one-kernel hierarchical training step, and its has_time
    variant on the time model (which no route reaches) against their plain
    versions: at 37 rays (19 CTAs at 64 + 64, so a lost or doubled CTA
    shows) and at the 1024-ray batch, at Sc + Sf = 64 + 64, 64 + 16,
    128 + 128, 48 + 32 and 32 + 64 (2, 2, 1, 2 and 2 rays a tile: the fine
    rows fewer than, as many as and more than the coarse ones); seeded
    targets, uniforms from importance_uniforms (each ray's time uniform in
    [0, 1]).  Both MSEs, every gradient and demb; two calls on the same
    inputs must agree bit for bit.  Returns the worst abs error of each
    variant's per-ray outputs and losses for the kernels record."""
    import torch

    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import pack_params
    from danerf_tpu_torch.ops.sampling import importance_uniforms

    tol = fr.PLAIN_TOL
    errs, grad_rel, failures, deterministic = {}, {}, [], True
    cases = []
    for tag, c, m, seed in (("K9", cfg, model, 71), ("K9t", cfg_t, model_t, 73)):
        for k, (sc, sf) in enumerate(((64, 64), (64, 16), (128, 128), (48, 32), (32, 64))):
            for n in (37, cfg.batch_size):
                # 64 + 64 keeps its seeds: 71 and 72 at 37 and 1024 rays, 73 with time
                s = seed + (n != 37) if k == 0 else 200 + 10 * k + (n != 37) + 5 * (tag == "K9t")
                cases.append((tag, c.replace(num_samples=sc, num_importance=sf), m, n, s))
    for tag, c, m, n, seed in cases:
        check, check_grads = checks(errs, grad_rel, failures, m)
        packed = pack_params(m, c)
        o, d, emb, z = make_rays(n, c, seed=seed, device=device)
        g = torch.Generator(device=device).manual_seed(seed + 100)
        u = importance_uniforms((n,), c.num_importance, True, rand=g, device=device)
        target = torch.rand(n, 3, generator=g, device=device)
        t = torch.rand(n, 1, generator=g, device=device) if c.use_time else None
        args = (packed, c, o, d, emb, z, u, target, t)
        k, k2 = fr.hier_onepass_cuda(*args), fr.hier_onepass_cuda(*args)
        p = fr.hier_onepass_plain(*args)
        torch.cuda.synchronize()
        flat = lambda r: (r[0], r[1], r[2].mats, r[2].vecs, r[3])  # noqa: E731
        deterministic &= all(bool(torch.equal(a, b)) for a, b in zip(flat(k), flat(k2)))
        name = f"{tag}@{n}x{c.num_samples}+{c.num_importance}"
        check_grads(name, k[2], p[2])
        check(f"{name}.loss_fine", abs(float(k[0]) - float(p[0])), tol["loss_k9"])
        check(f"{name}.loss_coarse", abs(float(k[1]) - float(p[1])), tol["loss_k9"])
        check(f"{name}.demb", max_err(k[3], p[3]), tol["demb_k9"])
        errs[f"{name}.demb_scale"] = float(p[3].abs().max())
        errs[f"{name}.loss"] = [float(k[0]), float(k[1])]
    if not deterministic:
        failures.append("K9 gave different results on the same inputs")
    emit({"phase": "hier_onepass", "rays": [37, cfg.batch_size],
          "samples": sorted({f"{c.num_samples}+{c.num_importance}" for _, c, *_ in cases}),
          "max_abs_err": errs, "grad_rel": grad_rel, "deterministic": deterministic,
          "tolerance": {k: tol[k] for k in ("grad_rel", "loss_k9", "demb_k9")},
          "failures": failures})
    if failures:
        raise AssertionError("K9 disagrees with its plain version: " + "; ".join(failures))
    return {kern: max(v for key, v in errs.items()
                      if key.startswith(kern + "@") and not key.endswith(("scale", ".loss")))
            for kern in ("K9", "K9t")}


@contextlib.contextmanager
def plain_route():
    """Route the autograd Functions through the plain versions on the card
    (for the step-parity phase only; the port itself never does this)."""
    from danerf_tpu_torch.kernels import fused_mlp as fm
    from danerf_tpu_torch.kernels import fused_render as fr

    names = ("_march_fwd", "_march_bwd", "_march_train", "_merged_fwd", "_merged_bwd",
             "_merged_train", "_hier_onepass")
    saved = {n: getattr(fr, n) for n in names}
    saved_fm = {n: getattr(fm, n) for n in ("_field_fwd", "_field_bwd")}
    fm._field_fwd = lambda pk, c, x, d, e, t: fm.fused_fwd_plain(pk, c, x, d, e, t)
    fm._field_bwd = lambda pk, c, x, d, e, t, gr, gs: fm.fused_bwd_plain(pk, c, x, d, e, gr, gs,
                                                                         t)
    fr._march_fwd = lambda pk, c, o, d, e, z, t, wf: fr.march_plain(pk, c, o, d, e, z, t, wf)
    fr._march_bwd = lambda pk, c, o, d, e, z, t, cot: fr.march_bwd_plain(pk, c, o, d, e, z,
                                                                         *cot, t=t)
    fr._march_train = lambda pk, c, *a: fr.march_train_plain(pk, c, *a)
    fr._merged_fwd = lambda pk, c, *a: fr.merged_plain(pk, c, *a)
    fr._merged_bwd = lambda pk, c, o, d, e, zc, fc, zf, t, cot: fr.merged_bwd_plain(
        pk, c, o, d, e, zc, fc, zf, *cot, t=t)
    fr._merged_train = lambda pk, c, *a: fr.merged_train_plain(pk, c, *a)
    fr._hier_onepass = lambda pk, c, *a: fr.hier_onepass_plain(pk, c, *a)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(fr, n, f)
        for n, f in saved_fm.items():
            setattr(fm, n, f)


# The training paths: config changes, and the launches of one step.
PATHS = {
    "hier": ({}, {"march": 1, "march_bwd": 1, "merged_train": 1}),
    "coarse": ({"num_importance": 0}, {"march_train": 1}),
    "white": ({"white_background": True},
              {"march": 1, "merged": 1, "merged_bwd": 1, "march_bwd": 1}),
    "per_sample": ({"use_fused_train": False}, {"mlp_fwd": 2, "mlp_bwd": 2}),
    "time": ({"use_time": True}, {"march": 1, "merged": 1, "merged_bwd": 1, "march_bwd": 1}),
    "hier_onepass": ({"use_hier_onepass": True}, {"hier_onepass": 1}),
}


def launches_of(per_step, steps=1):
    from danerf_tpu_torch.kernels import fused_render as fr

    return {k: per_step.get(k, 0) * steps for k in fr.LAUNCHES}


def phase_step(cfg, model, device):
    """One training step at B = 1024 on each training path (64 + 64; coarse
    only; 64 + 64 on a white background; 64 + 64 per sample, K1/K8; 64 + 64
    with use_time, the has_time K2/K5/K6/K3 on a model of its own and the
    batch's per-ray times; 64 + 64 in one kernel, use_hier_onepass, K9),
    each built twice from the same module, table, batch and draws: through
    the kernels and through their plain versions; loss, every gradient and
    the parameters after one Adam step compared.  The K9 step is also held
    against the 64 + 64 step through K2, K4 and K3 on the same draws."""
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
    times = torch.rand(n, 1, generator=g, device=device)
    names = [nm for nm, _ in model.named_parameters()] + ["appearance"]
    tol = fr.PLAIN_TOL
    report, failures, kernel_runs = {}, [], {}
    for path, (over, per_step) in PATHS.items():
        pcfg = cfg.replace(**over)
        pdraws = draws if pcfg.num_importance > 0 else draws[:1]
        base, pbatch = model, batch
        if pcfg.use_time:
            base, pbatch = make_model(pcfg, seed=0, device=device), {**batch, "t": times}
        runs = {}
        for route in ("kernel", "plain"):
            m = copy.deepcopy(base).requires_grad_(True)
            table = torch.nn.Parameter(table0.clone())
            params = list(m.parameters()) + [table]
            opt, sched = make_optimizer(pcfg, params)
            before = [p.detach().clone() for p in params]
            fr.reset_launch_counts()
            with plain_route() if route == "plain" else contextlib.nullcontext():
                opt.zero_grad(set_to_none=True)
                loss, aux = compute_loss_and_grads(m, table, pcfg, pbatch, draws=pdraws)
                grads = [p.grad.detach().clone() for p in params]
                opt.step()
                sched.step()
            torch.cuda.synchronize()
            runs[route] = {"loss": float(loss), **{k: float(v) for k, v in aux.items()},
                           "grads": grads, "delta": [p.detach() - b for p, b in zip(params, before)],
                           "launches": dict(fr.LAUNCHES)}
        k, p = runs["kernel"], runs["plain"]
        kernel_runs[path] = k
        if k["launches"] != launches_of(per_step):
            failures.append(f"{path}: kernel step launches {k['launches']}")
        if any(p["launches"].values()):
            failures.append(f"{path}: plain step launched kernels {p['launches']}")
        loss_tol = tol["loss_k9" if pcfg.use_hier_onepass else "loss"]
        report[path] = {**step_diff(path, k, p, names, pcfg, loss_tol, failures),
                        "launches": k["launches"]}
    # one kernel (K9) against three (K2, K4, K3), the same step and draws
    report["hier_onepass"]["vs_two_kernel_step"] = step_diff(
        "hier_onepass vs hier", kernel_runs["hier_onepass"], kernel_runs["hier"], names, cfg,
        tol["loss_k9"], failures)
    emit({"phase": "step", "rays": n, **report, "failures": failures})
    if failures:
        raise AssertionError("kernel step disagrees with the plain step: " + "; ".join(failures))


def step_diff(what, k, p, names, cfg, loss_tol, failures):
    """Two runs of one step (loss, aux, gradients, parameter updates), the
    loss held to ``loss_tol``, the gradients to PLAIN_TOL's grad_rel; what
    is over goes to ``failures``."""
    from danerf_tpu_torch.kernels import fused_render as fr

    tol = fr.PLAIN_TOL
    grad_rel = {nm: float((a - b).norm() / b.norm()) for nm, a, b in
                zip(names, k["grads"], p["grads"]) if float(b.norm()) > 0}
    upd_rel = {nm: float((a - b).norm() / b.norm()) for nm, a, b in
               zip(names, k["delta"], p["delta"]) if float(b.norm()) > 0}
    param_abs = max(max_err(a, b) for a, b in zip(k["delta"], p["delta"]))
    loss_err = abs(k["loss"] - p["loss"])
    if not math.isfinite(loss_err) or loss_err > loss_tol:
        failures.append(f"{what}: loss: {loss_err} > {loss_tol}")
    worst = max(grad_rel, key=grad_rel.get)
    if not math.isfinite(grad_rel[worst]) or grad_rel[worst] > tol["grad_rel"]:
        failures.append(f"{what}: grad {worst}: {grad_rel[worst]} > {tol['grad_rel']}")
    # Adam's first step moves each element by at most lr, so the two runs'
    # parameters differ by at most 2 lr, reached where a gradient element
    # near 0 changes sign between them
    if not math.isfinite(param_abs) or param_abs > 2 * cfg.learning_rate * (1 + 1e-3):
        failures.append(f"{what}: parameters after one Adam step: {param_abs}")
    return {"loss": [k["loss"], p["loss"]], "loss_err": loss_err,
            **{a: [k[a], p[a]] for a in ("mse", "coarse_mse") if a in k},
            "grad_rel_worst": {"param": worst, "err": grad_rel[worst]},
            "update_rel_worst": max(upd_rel.values()), "param_max_abs_diff": param_abs}


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


TRAIN_FLAGS = {"hier": [], "coarse": ["--num_importance", "0"], "white": ["--white_background"],
               "per_sample": [], "time": ["--use_time"], "hier_onepass": []}
# The routes with no CLI flag (nor has the JAX CLI one), trained through train()
API_PATHS = ("per_sample", "hier_onepass")


def train_api(argv, over):
    """A route's entry point where it has no CLI flag (the per-sample route,
    use_fused_train=False; the one-kernel step, use_hier_onepass=True):
    ``train(cfg.replace(**over), dataset)``, the config and dataset built as
    `cli.main train` builds them from ``argv``'s flags."""
    from danerf_tpu_torch.cli.main import _train_config, build_parser
    from danerf_tpu_torch.data.dataset import load_dataset
    from danerf_tpu_torch.train.trainer import train

    args = build_parser().parse_args(argv)
    cfg = _train_config(args).replace(**over)
    return train(cfg, load_dataset(cfg, "train"), save_dir=args.save_dir,
                 num_iterations=args.iters, seed=args.seed, device=args.device,
                 log_path=os.path.join(args.save_dir, "metrics.jsonl"))


def phase_train(out_dir, path, iters, render):
    """A training path through its entry point: `cli.main train` (for the
    routes without a flag ``train_api``) for ``iters`` steps on the
    procedural scene (its time-varying form under --use_time), with exactly
    the path's kernel launches per step, finite losses and a rising PSNR;
    then, when ``render``, `render` of the final checkpoint: a 100x100
    preview frame, or for the time path two 400x400 medium frames with
    --use_time --animate_time (t = 0, then 1)."""
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
    if path in API_PATHS:
        train_api(argv, PATHS[path][0])
    else:
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
    rendered = None
    if render:
        render_dir = os.path.join(out_dir, f"render_trained_{path}")
        if path == "time":
            size, frames, flags = 400, 2, ["--quality", "medium", "--use_time", "--animate_time"]
        else:
            size, frames, flags = 100, 1, ["--quality", "preview"]
        fr.reset_launch_counts()
        written = cli_main(["render", "--checkpoint", ckpt, "--output_dir", render_dir,
                            "--frames", str(frames), "--width", str(size), "--height",
                            str(size), "--device", "cuda", "--dataset_path", no_scene, *flags])
        torch.cuda.synchronize()
        if len(written) != frames or not all(os.path.exists(w) for w in written):
            raise AssertionError(f"render of the trained {path} checkpoint wrote {written}")
        if path == "time" and min(fr.LAUNCHES["march"], fr.LAUNCHES["merged"]) < 3 * frames:
            raise AssertionError(f"time render: launches {fr.LAUNCHES}, expected 3 K2 and 3 "
                                 "K5 a frame")
        rendered = {"frames": written, "size": size, "flags": flags,
                    "launches": dict(fr.LAUNCHES)}
    emit({"phase": "train", "path": path, "flags": TRAIN_FLAGS[path], "iters": iters,
          "seconds_incl_scene": secs, "launches": counts,
          "loss_first": rows[0]["loss"], "loss_last": rows[-1]["loss"],
          "psnr_mean_first20_after_warmup": first, "psnr_mean_last20": last,
          "render": rendered})
    return counts


def phase_timing(cfg, model, device, chunk, frame_t=None):
    """K2 (want_field) and K5 on the 65,536-ray chunk and their plain
    versions, each beside its bound, and one 800x800 medium frame (median of
    three after a warm-up frame); with use_time the chunk carries each ray's
    time and the frame renders at ``frame_t``."""
    import torch

    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import pack_params
    from danerf_tpu_torch.render.renderer import render_frame
    from danerf_tpu_torch.viz.paths import camera_path

    R, S = cfg.render_chunk, cfg.num_samples
    packed = pack_params(model, cfg)
    o, d, emb, z, z_f, t = chunk
    field = fr.march_cuda(packed, cfg, o, d, emb, z, t, want_field=True)["field"]

    k2 = cuda_ms(lambda: fr.march_cuda(packed, cfg, o, d, emb, z, t, want_field=True), 5, 2)
    k5 = cuda_ms(lambda: fr.merged_cuda(packed, cfg, o, d, emb, z, field, z_f, t), 5, 2)
    k2_plain = cuda_ms(lambda: fr.march_plain(packed, cfg, o, d, emb, z, t, want_field=True), 3)
    k5_plain = cuda_ms(lambda: fr.merged_plain(packed, cfg, o, d, emb, z, field, z_f, t), 3)

    w_bytes = packed.mats.numel() * 2 + packed.vecs.numel() * 4
    e, nt = cfg.appearance_dim, int(t is not None)
    k2_bytes = 4 * R * (3 + 3 + e + S + nt) + 4 * R * (3 + 1 + 1 + S + 4 * S) + w_bytes
    sa = S + cfg.num_importance
    k5_bytes = (4 * R * (3 + 3 + e + S + 4 * S + cfg.num_importance + nt)
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
                            perturb=True, t=frame_t, generator=gen, device=device)

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
    # the frame's 640,000 rays in 10 chunks: one K2 and one K5 each, nothing else
    want_launches = {k: (math.ceil(chunks) if k in ("march", "merged") else 0)
                     for k in frame_launches}
    if frame_launches != want_launches:
        raise AssertionError(f"800x800 medium frame launched {frame_launches}, "
                             f"expected {want_launches}")
    timing = {"chunk_rays": R, "k2_ms": k2, "k5_ms": k5, "k2_plain_ms": k2_plain,
              "k5_plain_ms": k5_plain, "k2_bound_ms": k2_bound, "k5_bound_ms": k5_bound,
              "frame_800_medium_derived_ms": chunks * (k2 + k5),
              "frame_800_medium_measured_ms": sorted(frame_ms)[1],
              "frame_800_medium_each_ms": frame_ms,
              "frame_800_medium_launches": frame_launches,
              "frame_800_medium_bound_ms": chunks * (k2_bound + k5_bound)}
    emit({"phase": "timing", "use_time": cfg.use_time, "frame_t": frame_t, **timing})
    return timing, (k2_by, k5_by)


def kernel_part(name):
    """The part of a step a device kernel belongs to: the tile kernel of K3,
    K4, K6, K7, K8 or K9 (csrc/field_bwd_sm90.cuh), their dW pass (the
    wgmma blocks, the narrow jobs, the reductions), or the rest."""
    if "bwd_tile90" in name or "hier_tile90" in name:
        return "bwd90_tile"
    if any(k in name for k in ("dw90_", "dw_kernel<64>", "dw_reduce<64>", "reduce_slots")):
        return "bwd90_dw_pass"
    return "rest"


def dw_pass_timing(cfg, packed, device, calls):
    """K3, K4, K6 and K7 at the batch broken down by torch.profiler (device
    ms per call of each kernel they launch, and by kernel_part), and torch.matmul
    over the same d_pre^T @ input products at the batch's 65,536 rows as a
    yardstick (``dw_cublas_ms``; nothing on any path calls it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from danerf_tpu_torch.kernels.fused_mlp import enc_widths

    out = {}
    for k in ("k3", "k4", "k6", "k7"):
        calls[k][0]()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                calls[k][0]()
            torch.cuda.synchronize()
        kern, parts = {}, {}
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            ms = ev.self_device_time_total / 1e3 / 5
            kern[ev.key[:60]] = ms
            parts[kernel_part(ev.key)] = parts.get(kernel_part(ev.key), 0.0) + ms
        out[k] = {"kernels_ms": kern, "parts_ms": parts}
    rows = cfg.batch_size * cfg.num_samples
    kx, kd = enc_widths(cfg)
    L, hid, half = packed.num_layers, cfg.hidden_dim, cfg.hidden_dim // 2
    g = torch.Generator(device=device).manual_seed(90)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=device).to(torch.bfloat16)

    dpre, h = rnd(L, rows, hid), rnd(L, rows, hid)
    ddir, dapp, happ = rnd(rows, half), rnd(rows, half), rnd(rows, half)
    encx, encd = rnd(rows, kx), rnd(rows, kd)
    embr, drgb = rnd(rows, cfg.appearance_dim), rnd(rows, 16)
    skips = [i for i in cfg.skip_connect_layers if 0 < i < L]
    products = ([(dpre[i], h[i - 1]) for i in range(1, L)] + [(ddir, h[L - 1])]
                + [(dpre[i], encx) for i in [0] + skips]
                + [(ddir, encd), (dapp, embr), (drgb, happ)])
    out["dw_cublas_ms"] = cuda_ms(lambda: [torch.matmul(a.t(), b) for a, b in products], 10)
    out["dw_cublas_products"] = len(products)
    del dpre, h, products
    return out


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
    breakdown = {}
    for name, ms, _ in kernels:
        breakdown[kernel_part(name)] = breakdown.get(kernel_part(name), 0.0) + ms
    return {"profile_ms_per_step": [[k[0][:70], k[1], k[2]] for k in kernels[:14]],
            "profile_breakdown_ms_per_step": breakdown,
            "profile_device_busy_ms_per_step": busy_ms, "profile_wall_ms_per_step": wall_ms,
            "profile_idle_share": 1.0 - busy_ms / wall_ms}


def phase_train_timing(cfg, model, device, chunk):
    """The training kernels (K3, K4, K6, K7, K9) on the 65,536-ray chunk and
    at the 1024-ray batch, their plain versions at the batch; K1 and K8 at
    the per-sample route's rows of a batch (K1 also on the chunk's), with
    their plain versions; and the training step of each path at B = 1024
    (median of 50 synchronised steps) with a torch.profiler breakdown of the
    64 + 64, the coarse-only, the white-background, the per-sample and the
    one-kernel (K9) step.
    With use_time (the has_time variants, each ray's or row's time uniform
    in [0, 1]): every kernel at the batch (K1/K8 at 131,072 rows) and the
    use_time step, profiled."""
    import torch

    from danerf_tpu_torch.kernels import fused_mlp as fm
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import pack_params
    from danerf_tpu_torch.ops.sampling import importance_uniforms, sample_pdf

    packed = pack_params(model, cfg)
    sc, sf, e = cfg.num_samples, cfg.num_importance, cfg.appearance_dim
    sa, nt = sc + sf, int(cfg.use_time)
    w_bytes = packed.mats.numel() * 2 + packed.vecs.numel() * 4
    g_bytes = (packed.mats.numel() + packed.vecs.numel()) * 4
    # bytes each kernel must move: inputs read once, outputs written once
    ray_bytes = {
        "k3": lambda n: 4 * n * (3 + 3 + e + sc + nt + 3 + 1 + 1 + sc + 4 * sc) + 4 * n * e,
        "k4": lambda n: (4 * n * (3 + 3 + e + sc + 4 * sc + sf + 3 + nt) + 4 * n * (e + 4 * sc)
                         + 4),
        "k6": lambda n: (4 * n * (3 + 3 + e + sc + 4 * sc + sf + nt + 3 + 1 + 1 + sa)
                         + 4 * n * (e + 4 * sc)),
        "k7": lambda n: 4 * n * (3 + 3 + e + sc + 3 + nt) + 4 * n * e + 4,
        "k9": lambda n: 4 * n * (3 + 3 + e + sc + sf + 3 + nt) + 4 * n * e + 8,
    }
    # the samples a ray at which each runs the field and its transposed chain
    samples = {"k3": sc, "k4": sf, "k6": sf, "k7": sc, "k9": sc + sf}

    out, bound_by = {}, {}
    g = torch.Generator(device=device).manual_seed(31)

    def times(n):
        return torch.rand(n, 1, generator=g, device=device) if cfg.use_time else None

    shapes = [("batch", make_rays(cfg.batch_size, cfg, seed=32, device=device)
               + (None, times(cfg.batch_size)))]
    if not cfg.use_time:
        shapes.insert(0, ("chunk", chunk))
    for tag, (o, d, emb, z, z_f, t) in shapes:
        n = o.shape[0]
        *cot, g_field = _cotangents(n, sc, g, device)
        coarse = fr.march_cuda(packed, cfg, o, d, emb, z, t, want_field=True)
        if z_f is None:
            z_f = sample_pdf(z, coarse["weights"], sf, True, rand=g)
        field = coarse["field"]
        target = torch.rand(n, 3, generator=g, device=device)
        c6 = (cot[0], cot[1], cot[2], 0.1 * torch.randn(n, sa, generator=g, device=device))
        u = importance_uniforms((n,), sf, True, rand=g, device=device)
        del coarse
        calls = {
            "k3": (lambda: fr.march_bwd_cuda(packed, cfg, o, d, emb, z, *cot, g_field, t=t),
                   lambda: fr.march_bwd_plain(packed, cfg, o, d, emb, z, *cot, g_field, t=t)),
            "k4": (lambda: fr.merged_train_cuda(packed, cfg, o, d, emb, z, field, z_f, target,
                                                t),
                   lambda: fr.merged_train_plain(packed, cfg, o, d, emb, z, field, z_f, target,
                                                 t)),
            "k6": (lambda: fr.merged_bwd_cuda(packed, cfg, o, d, emb, z, field, z_f, *c6, t=t),
                   lambda: fr.merged_bwd_plain(packed, cfg, o, d, emb, z, field, z_f, *c6,
                                               t=t)),
            "k7": (lambda: fr.march_train_cuda(packed, cfg, o, d, emb, z, target, t),
                   lambda: fr.march_train_plain(packed, cfg, o, d, emb, z, target, t)),
            "k9": (lambda: fr.hier_onepass_cuda(packed, cfg, o, d, emb, z, u, target, t),
                   lambda: fr.hier_onepass_plain(packed, cfg, o, d, emb, z, u, target, t)),
        }
        iters = 3 if tag == "chunk" else 20
        for k, (kern, plain) in calls.items():
            out[f"{k}_{tag}_ms"] = cuda_ms(kern, iters)
            out[f"{k}_{tag}_bound_ms"], bound_by[k] = bound(
                cfg, n, samples[k], ray_bytes[k](n) + w_bytes + g_bytes, backward=True)
            if tag == "batch":
                out[f"{k}_batch_plain_ms"] = cuda_ms(plain, 5)
        if tag == "batch":
            out["k2_batch_ms"] = cuda_ms(
                lambda: fr.march_cuda(packed, cfg, o, d, emb, z, t, want_field=True), iters)
            out["k5_batch_ms"] = cuda_ms(
                lambda: fr.merged_cuda(packed, cfg, o, d, emb, z, field, z_f, t), iters)
            k2_bytes = (4 * n * (3 + 3 + e + sc + nt) + 4 * n * (3 + 1 + 1 + sc + 4 * sc)
                        + w_bytes)
            out["k2_batch_bound_ms"], _ = bound(cfg, n, sc, k2_bytes)
            k5_bytes = (4 * n * (3 + 3 + e + sc + 4 * sc + sf + nt)
                        + 4 * n * (3 + 1 + 1 + sa + sa) + w_bytes)
            out["k5_batch_bound_ms"], _ = bound(cfg, n, sf, k5_bytes)
            if not cfg.use_time:
                out["bwd90_parts"] = dw_pass_timing(cfg, packed, device, calls)
        del cot, g_field, field, target, c6, u, calls

    # K1 and K8 at the rows of a 1024-ray batch's coarse (65,536) and fine
    # (131,072) evaluations, and K1 on a render chunk's sample rows
    # (65,536 rays x 64 = 4,194,304); bytes: inputs once, outputs once
    k1_bytes = lambda n: 4 * n * (3 + 3 + e + nt) + 4 * n * (3 + 1) + w_bytes
    k8_bytes = lambda n: 4 * n * (3 + 3 + e + nt + 3 + 1) + 4 * n * e + w_bytes + g_bytes
    row_sets = {"131072": sample_rows(cfg.batch_size, cfg, 34, device, sc + sf)}
    if not cfg.use_time:
        row_sets = {"65536": sample_rows(cfg.batch_size, cfg, 33, device, sc), **row_sets,
                    "chunk": sample_rows(cfg.render_chunk, cfg, 35, device, sc)}
    for tag, (x, dr, er) in row_sets.items():
        n = x.shape[0]
        t = times(n)
        out[f"k1_{tag}_ms"] = cuda_ms(lambda: fm.fused_fwd_cuda(packed, cfg, x, dr, er, t),
                                      3 if tag == "chunk" else 20)
        out[f"k1_{tag}_plain_ms"] = cuda_ms(lambda: fm.fused_fwd_plain(packed, cfg, x, dr, er,
                                                                       t),
                                            2 if tag == "chunk" else 5)
        out[f"k1_{tag}_bound_ms"], bound_by["k1"] = bound(cfg, n, 1, k1_bytes(n))
        if tag != "chunk":
            g_rgb = torch.randn(n, 3, generator=g, device=device)
            g_sig = torch.randn(n, 1, generator=g, device=device)
            out[f"k8_{tag}_ms"] = cuda_ms(
                lambda: fm.fused_bwd_cuda(packed, cfg, x, dr, er, g_rgb, g_sig, t), 10)
            out[f"k8_{tag}_plain_ms"] = cuda_ms(
                lambda: fm.fused_bwd_plain(packed, cfg, x, dr, er, g_rgb, g_sig, t), 3)
            out[f"k8_{tag}_bound_ms"], bound_by["k8"] = bound(cfg, n, 1, k8_bytes(n),
                                                              backward=True)
        del x, dr, er
    del row_sets

    # the kernels of a step, and their bound, at B = 1024
    white = ("k2_batch", "k5_batch", "k6_batch", "k3_batch")
    step_kernels = ({"time": white} if cfg.use_time else
                    {"hier": ("k2_batch", "k3_batch", "k4_batch"), "coarse": ("k7_batch",),
                     "white": white,
                     "per_sample": ("k1_65536", "k1_131072", "k8_65536", "k8_131072"),
                     "hier_onepass": ("k9_batch",)})
    steps = {path: step_timing(cfg.replace(**PATHS[path][0]), device, out, kerns,
                               profile=path in ("hier", "coarse", "white", "per_sample",
                                                "time", "hier_onepass"))
             for path, kerns in step_kernels.items()}
    emit({"phase": "train_timing", "use_time": cfg.use_time, "batch": cfg.batch_size,
          "chunk_rays": chunk[0].shape[0], **out, "steps": steps})
    return out, bound_by


def step_timing(cfg, device, kernel_ms, kernels, profile):
    """The training step of ``cfg`` at B = 1024 on a pool of 20 random
    100x100 images (with capture times 0..1 under use_time): the median of
    50 synchronised steps after 5 warm-up steps, its rays/s, the share of
    ``kernels`` (keys of ``kernel_ms``, the step's kernels timed alone) and
    their summed bound; with ``profile`` a torch.profiler window of 10
    steps."""
    import numpy as np
    import torch

    from danerf_tpu_torch.data.dataset import RayDataset
    from danerf_tpu_torch.train.trainer import init_model, make_optimizer, train_step
    from danerf_tpu_torch.viz.paths import camera_path

    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, size=(20, 100, 100, 3), dtype=np.uint8)
    c2ws = np.stack([np.asarray(c, np.float32) for c in camera_path("circle", 20, cfg.scene)])
    ds = RayDataset(imgs, imgs[..., 0], c2ws, 138.9, cfg.near, cfg.far,
                    times=np.linspace(0.0, 1.0, 20, dtype=np.float32) if cfg.use_time else None)
    model, table = init_model(cfg, 20, 0, device)
    opt, sched = make_optimizer(cfg, list(model.parameters()) + [table])
    pool = ds.device_arrays(cfg.white_background, device=device)
    gen = torch.Generator(device=device).manual_seed(0)

    def step():
        return train_step(model, table, opt, sched, pool, cfg, 100, 100, ds.focal, None, gen)

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
    kern_ms = sum(kernel_ms[f"{k}_ms"] for k in kernels)
    out = {"step_ms_median": step_ms, "step_ms_min": min(times), "step_ms_max": max(times),
           "rays_per_s": cfg.batch_size / (step_ms / 1e3), "kernels": kernels,
           "kernel_share": kern_ms / step_ms,
           "step_bound_ms": sum(kernel_ms[f"{k}_bound_ms"] for k in kernels)}
    if profile:
        out.update(profile_steps(step))
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
    for k, v in phase_bwd_shapes(cfg, model, device, "").items():
        errs[k] = max(errs[k], v)
    # the time-conditioned model (use_time, 6 time levels): the has_time variants
    cfg_t = cfg.replace(use_time=True)
    model_t = make_model(cfg_t, seed=0, device=device)
    errs_t, chunk_t = phase_time_kernels(cfg_t, model_t, device)
    for k, v in phase_bwd_shapes(cfg_t, model_t, device, "t").items():
        errs_t[k] = max(errs_t[k], v)
    errs_k9 = phase_hier_onepass(cfg, model, cfg_t, model_t, device)
    phase_step(cfg, model, device)
    launches = phase_render(cfg, model, args.out)
    train_launches = {"hier": phase_train(args.out, "hier", 200, render=True),
                      "coarse": phase_train(args.out, "coarse", 100, render=False),
                      "white": phase_train(args.out, "white", 100, render=False),
                      "per_sample": phase_train(args.out, "per_sample", 100, render=False),
                      "time": phase_train(args.out, "time", 100, render=True),
                      "hier_onepass": phase_train(args.out, "hier_onepass", 100, render=False)}
    timing, bound_by = phase_timing(cfg, model, device, chunk)
    tt, tt_bound_by = phase_train_timing(cfg, model, device, chunk)
    timing_t, bound_by_t = phase_timing(cfg_t, model_t, device, chunk_t, frame_t=0.5)
    tt_t, tt_bound_by_t = phase_train_timing(cfg_t, model_t, device, chunk_t)

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
    # K1 and K8 at the 131,072 rows of the per-sample step's fine evaluation,
    # their launches from the per-sample training run
    for name, key, source, line, counter in (
            ("K1 per-sample field", "k1", "mlp_fwd.cu", 231, "mlp_fwd"),
            ("K8 per-sample field backward", "k8", "mlp_bwd.cu", 249, "mlp_bwd")):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"danerf_tpu_torch/kernels/csrc/{source}",
                        "replaces": f"danerf_tpu/kernels/fused_mlp.py:{line}",
                        "launches": train_launches["per_sample"][counter],
                        "max_abs_err": errs[key.upper()], "ms": tt[f"{key}_131072_ms"],
                        "plain_ms": tt[f"{key}_131072_plain_ms"],
                        "bound_ms": tt[f"{key}_131072_bound_ms"], "bound_by": tt_bound_by[key],
                        "library_ms": None})
    # the has_time variant of each kernel: K2/K5 on the chunk, the others at
    # the batch (K1/K8 at 131,072 rows); launches from the use_time training
    # run, which no K1, K4, K7 or K8 serves (K4 and K7: no route of either
    # package; K1 and K8: the per-sample route with time, not driven here)
    for rec, key in zip(kernels, ("k2", "k5", "k3", "k4", "k6", "k7", "k1", "k8")):
        counter = {"k2": "march", "k5": "merged", "k3": "march_bwd", "k4": "merged_train",
                   "k6": "merged_bwd", "k7": "march_train", "k1": "mlp_fwd",
                   "k8": "mlp_bwd"}[key]
        if key in ("k2", "k5"):
            at = {"ms": timing_t[f"{key}_ms"], "plain_ms": timing_t[f"{key}_plain_ms"],
                  "bound_ms": timing_t[f"{key}_bound_ms"],
                  "bound_by": bound_by_t[0 if key == "k2" else 1], "at": "65,536-ray chunk"}
        else:
            shape = "131072" if key in ("k1", "k8") else "batch"
            at = {"ms": tt_t[f"{key}_{shape}_ms"], "plain_ms": tt_t[f"{key}_{shape}_plain_ms"],
                  "bound_ms": tt_t[f"{key}_{shape}_bound_ms"], "bound_by": tt_bound_by_t[key],
                  "at": "131,072 rows" if shape == "131072" else "1024-ray batch"}
        rec["variants_held"] = ["without time", "has_time"]
        rec["has_time"] = {"launches": train_launches["time"][counter],
                           "max_abs_err": errs_t[key.upper()], **at}
    # K9 at the batch, its launches from the use_hier_onepass training run,
    # beside the three kernels it replaces (K2 + K4 + K3) at the batch and on
    # the chunk, timed in this call; its has_time variant (reached by no
    # route, as in the JAX package) at the batch of the time model
    k9 = {"name": "K9 one-kernel hierarchical training step", "route": "cuda",
          "source": "danerf_tpu_torch/kernels/csrc/hier_onepass.cu",
          "replaces": "danerf_tpu/kernels/fused_render.py:1303",
          "launches": train_launches["hier_onepass"]["hier_onepass"],
          "max_abs_err": errs_k9["K9"], "ms": tt["k9_batch_ms"],
          "plain_ms": tt["k9_batch_plain_ms"], "bound_ms": tt["k9_batch_bound_ms"],
          "bound_by": tt_bound_by["k9"], "library_ms": None,
          "ms_and_two_kernel_ms": {
              "batch": [tt["k9_batch_ms"], tt["k2_batch_ms"] + tt["k4_batch_ms"]
                        + tt["k3_batch_ms"]],
              "chunk": [tt["k9_chunk_ms"], timing["k2_ms"] + tt["k4_chunk_ms"]
                        + tt["k3_chunk_ms"]]},
          "variants_held": ["without time", "has_time"],
          "has_time": {"launches": train_launches["time"]["hier_onepass"],
                       "max_abs_err": errs_k9["K9t"], "ms": tt_t["k9_batch_ms"],
                       "plain_ms": tt_t["k9_batch_plain_ms"],
                       "bound_ms": tt_t["k9_batch_bound_ms"], "bound_by": tt_bound_by_t["k9"],
                       "at": "1024-ray batch"}}
    kernels.append(k9)
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
