"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--out DIR]
    python3 chip_smoke.py --cards N     (N cards: only the data-parallel phase)

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. env      torch / CUDA versions and the card (nvidia-smi name, power limit).
2. build    compile every kernel from danerf_tpu_torch/kernels/csrc (nvcc,
            sm_90a, all sources at once); one line of each kernel's
            registers, shared memory and spills (-Xptxas -v; K1, K2 and K5
            with their dynamic shared memory; the tile and dW pass of K3,
            K4, K6-K9 apart); the full reports go to DIR/build.log.
3. kernels  at full width (default NeRFConfig: 8x256, bf16) on seeded inputs,
            each kernel against its plain PyTorch version on the card,
            within fused_render.PLAIN_TOL, at 4093 rays (a ragged tile) and
            at one 65,536-ray chunk: K2 with want_field at 64 samples
            (medium's coarse pass) and without at 32 (preview), K5 at
            64 + 64 with z_f from sample_pdf of K2's weights; at 4093 rays
            the shapes of csrc/field_sm90.cuh's tile (tile_shapes: K2 at S =
            32, 48, 64, 100, 128 with and without its field, K5 at 64 + 64,
            64 + 16, 128 + 128 with and without the appearance projection,
            two calls bit for bit); K1 (csrc/field_sm90.cuh's row tile) on
            the points of 4093 x 32 = 130,976 rows (ragged), and of 65,536
            and 131,072 rows (the coarse and fine evaluations of a 1024-ray
            batch), with and without the appearance projection, two calls
            bit for bit, and at 130,976 rows with the softplus density
            activation (a model of its own); and
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
            rays and at B = 1024, K4 and K7 at 37 rays, K1 at 4,093 and
            130,976 rows and K8 at 37, 129 and 2,400 rows, against their
            plain versions.
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
6a. chained  several steps a call (make_train_step, steps_per_call=10: the
            steps captured once as a CUDA graph, one replay a call): for
            each training path at B = 1024 on a pool of 20 random 100x100
            images, from one seeded state (5 warm-up steps of 64 rays), 10
            replayed steps against 10 eager steps, bit for bit: parameters,
            table, Adam's moments and step counts, the rate, StepLR, each
            step's metrics and the generator's next draw, with exactly the
            path's launches per step on both; on 64 + 64 also 3 replays
            against 30 eager steps with scheduler_step_size=7 (rate changes
            inside a replay), and train() for 40 steps (a checkpoint every
            20) against 20 steps, a resume and 20 more (the final
            checkpoints and the rows of steps 21-40).
7. train    the training paths through `cli.main train` on the procedural
            scene (5 warm-up steps of 64 rays, then 1024, 10 steps a call:
            one graph replay a full chunk), launch counts zeroed just before
            each run: 200 steps of 64 + 64 with --checkpoint_every 100
            (exactly one K2, K4 and K3 launch a step, plus one K2 and one
            K5 for each checkpoint's validation render; render_000100.png
            and training_curves.png must decode; then --resume to 250
            steps, exactly the launches of 50 steps, rows 201-250 appended;
            then `render` of the final checkpoint), 100 steps of
            `--num_importance 0` (one K7 a step and nothing else), 100 steps
            of `--white_background` (one K2, K5, K6 and K3 a step); then 100
            steps of the per-sample route, which has no CLI flag (nor has
            the JAX CLI): train() with use_fused_train=False (two K1 and two
            K8 a step and nothing else); 100 steps of `--use_time` on the
            time-varying scene (one K2, K5, K6 and K3 a step, the has_time
            variants; then `render --use_time --animate_time` of its
            checkpoint, two 400x400 medium frames); 100 steps of
            use_hier_onepass, which has no CLI flag either, through train()
            (one K9 a step and nothing else); one metrics.jsonl row a step,
            finite losses and a rising PSNR.
7e. eval    `cli.main eval` on the checkpoints of 7 (64 + 64, white
            background, use_time; 100x100 procedural views): --max_views 2
            of --split val with and without --optimize_embeddings (the
            test-time fit: 50 Adam steps on one appearance embedding, the
            model frozen, each step K2, K5 forward and K6, K3 backward, one
            CUDA-graph replay a view), of --split train, and a fit under
            --num_importance 0 (K2, K3); exactly those launches plus one K2
            and one K5 a frame chunk (zeroed just before each run, read
            just after); per view within 0.1 dB PSNR and 0.005 SSIM of the
            same command with --no_pallas on the card; one view's graph fit
            equal to its eager fit bit for bit.
7f. loaders the port's JPEG decoder on the committed fixture
            (tests/data_torch/frame.jpg) and its Lanczos downscale by 8 of
            the fixture RGBA PNG, each equal to the sha256 of PIL's output
            stored beside them, with their host ms; a custom-format scene
            of those frames through load_dataset.  7e and 7f run before any
            torch.profiler window.
7a. fx      the depth-aware effects (danerf_tpu_torch/fx/, plain PyTorch
            ops, no kernel of their own): each of the 14 with and without
            depth on a seeded 800x800 frame and depth, on the card against
            the port on the CPU with the same draws, within
            fx.effects.levels_apart's tolerance (1 level; 0.1% of the pixels
            where a threshold decides), under PyTorch's default TF32 flags
            (restored after); then each effect's CUDA-event ms at 800x800
            (median of 10 after a warm-up call).  7a-7d run before any
            torch.profiler window.
7b. serve_fx  `cli.main render --effect Fog --create_video`, then --effect
            Hologram: two 400x400 medium frames each from the smoke
            checkpoint; every file, the AVI read back (frame count, size,
            pixels against the PNGs), exactly one K2 and one K5 a chunk
            (launch counts zeroed just before each, read just after).
7c. spiral_fx  the reference's pipeline through the CLI: `spiral` (12 frames
            at 200x200, grayscale depth on frames 0 and 10, its AVI; one K2
            and one K5 a frame), `effects` on its output (all 14: Fog on the
            2 depth frames, the rest on 12, an AVI each), `preview` (Fog at
            3 values of fog_start, manifest.json), `video`.
7d. serve_timing  an 800x800 medium frame: render_frame alone (median of
            3), the serial frame loop (render, fetch, two PNG encodes, one
            frame after another), render_path, which overlaps the fetch and
            the encodes with the next frame, without an effect, with Fog and
            with Toon Shader (ms a frame over 4 frames after a warm-up
            call; without an effect also over 12), the aligned spiral's ms
            a frame, and apply_effect_to_frames' timings (load, device,
            write) over it.
7g. eval_timing  evaluate() on 2 seeded random 800x800 views (the
            procedural poses) with the seeded model: ms a view without and
            with the fit (each call captures the fit once), the fit alone
            eager and as a graph replay (median of 3), render_frame beside
            render plus score; then one torch.profiler window of a replayed
            and of an eager fit (device-busy ms, idle share).
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
            white-background, the per-sample and the K9 step; beside each,
            the chained step (10 steps a replay: median, min and max of 20
            synchronised replays over 10, rays/s, a replay's CUDA-event
            time, the graph's pool, and a torch.profiler window of 3
            replays with its idle share); then the same
            for use_time: the has_time K2/K5 on the chunk, K3-K7 and K9 at
            B = 1024 and K1/K8 at 131,072 rows with their plain versions, an
            800x800 medium frame at t = 0.5, and the use_time step,
            profiled.  K3, K4, K6 and K7 at the batch are also broken down
            by kernel (tile, dW pass) beside torch.matmul over the same dW
            products (dw_cublas_ms, a yardstick only), and each profiled
            step by part (their tile, their dW pass, the rest).
9. data parallelism (danerf_tpu_torch/parallel/mesh.py), after every
   profiler window of 8: hier_dp, `cli.main train --coordinator_address
   auto --mesh_data 0` as torchrun starts one rank (an NCCL group of one,
   a 1 x 1 mesh; 100 steps of 64 + 64 with --checkpoint_every 100: exactly
   one K2, K4 and K3 a step plus the validation render's K2 and K5, rising
   PSNR); dist_step, on a world-size-1 NCCL group of this process: for
   64 + 64, coarse-only and per sample, 10 chained sharded steps (one
   replay, the flat all-reduce captured with them) against 10 chained
   make_train_step steps bit for bit with the path's launches, then the two
   64 + 64 steps timed in turns (20 replays each) with a profiler window of
   3 replays each; dist_frame: render_frame(mesh=) of an 800x800 medium
   frame against render_frame bit for bit (10 K2, 10 K5), and
   make_sharded_render on a 65,536-ray chunk against render_rays'
   per-sample route bit for bit (2 K1), with their ms; dist_two_ranks: two
   processes of this script on the one card on gloo (3 eager sharded
   64 + 64 steps at a global B = 1024, a 200x200 sharded frame, the
   --mesh_model 2 module-route forward), each against the same work in one
   process within TWO_RANK_TOL; a failure in either child fails the run.
   With --cards N (N > 1) the script runs env, build and only this last
   phase, as dist_cards: N ranks on NCCL, one card each, the same checks,
   plus the chained step at B = 1024 and N x 1024 and the 800x800 frame
   timed against one card, and the tensor-parallel kernel-route step
   (N/2 x 2 mesh) chained against eager, bit for bit.
Before the last line it prints the card's name and power limit and the
{"kernels": [...]} record (each kernel with its has_time variant's numbers
under "has_time"; K2, K5, K3 and K6 with the launches of 7e's kernel-route
runs under "eval_launches"; K2, K4 and K3 with those of hier_dp under
"dp_train_launches", K2 and K5 with a sharded frame's, K1 with a sharded
chunk's); the last line is the ok record.  Exits non-zero,
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
    memory and spills (K1, K2 and K5, ``csrc/field_sm90.cuh``, take dynamic
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
    for n in ("march", "merged", "mlp_fwd"):
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
    # of a 1024-ray batch; with and without the appearance projection; two
    # calls bit for bit; and at 130,976 rows on a model with the softplus
    # density activation
    no_app = pack_params(model, cfg, appearance=False)
    cfg_sp = cfg.replace(density_activation="softplus")
    packed_sp = pack_params(make_model(cfg_sp, seed=7, device=device), cfg_sp)
    for rays, s_per, seed in ((4093, 32, 1), (1024, 64, 2), (1024, 128, 3)):
        x, dr, er = sample_rows(rays, cfg, seed, device, s_per)
        n = x.shape[0]
        runs = [("", cfg, packed, er), ("_noapp", cfg, no_app, torch.zeros_like(er))]
        if rays == 4093:
            runs.append(("_softplus", cfg_sp, packed_sp, er))
        for tag, c, pk, e in runs:
            rk, sk = fm.fused_fwd_cuda(pk, c, x, dr, e)
            rk2, sk2 = fm.fused_fwd_cuda(pk, c, x, dr, e)
            rp, sp = fm.fused_fwd_plain(pk, c, x, dr, e)
            torch.cuda.synchronize()
            checks = {"field_rgb": max_err(rk, rp),
                      "field_sigma": max_err((sk - sp) / sp.abs().clamp_min(1.0), 0 * sp)}
            for name, e_ in checks.items():
                errs[f"K1@{n}{tag}.{name}"] = e_
                if not math.isfinite(e_) or e_ > fr.PLAIN_TOL[name]:
                    failures.append(f"K1@{n}{tag}.{name}: {e_} > {fr.PLAIN_TOL[name]}")
            errs[f"K1@{n}{tag}.sigma"] = max_err(sk, sp)
            if not (torch.equal(rk, rk2) and torch.equal(sk, sk2)):
                failures.append(f"K1@{n}{tag}: two calls differ")
        del x, dr, er, rk, sk, rk2, sk2, rp, sp
    del packed_sp

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

    # K1 on the samples of 4093 rays x 32 (130,976 rows, a ragged tile) and
    # on its first 4,093 rows (32 tiles, the last ragged), K8 at 37, 129 and
    # 2,400 rows (19 tiles), each row with its own time
    x, dr, er = sample_rows(4093, cfg, 61, device, 32)
    t = times(x.shape[0], 62)
    for n in (4093, x.shape[0]):
        rk, sk = fm.fused_fwd_cuda(packed, cfg, x[:n], dr[:n], er[:n], t[:n])
        rp, sp = fm.fused_fwd_plain(packed, cfg, x[:n], dr[:n], er[:n], t[:n])
        torch.cuda.synchronize()
        check(f"K1t@{n}.field_rgb", max_err(rk, rp), tol["field_rgb"])
        check(f"K1t@{n}.field_sigma", max_err((sk - sp) / sp.abs().clamp_min(1.0), 0 * sp),
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
          "rays": [4093, cfg.render_chunk, 37, cfg.batch_size], "k1_rows": [4093, 4093 * 32],
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


def timing_scene(cfg):
    """The training phases' pool: 20 random 100x100 images on a circle of
    cameras (capture times 0..1 under use_time)."""
    import numpy as np

    from danerf_tpu_torch.data.dataset import RayDataset
    from danerf_tpu_torch.viz.paths import camera_path

    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, size=(20, 100, 100, 3), dtype=np.uint8)
    c2ws = np.stack([np.asarray(c, np.float32) for c in camera_path("circle", 20, cfg.scene)])
    return RayDataset(imgs, imgs[..., 0], c2ws, 138.9, cfg.near, cfg.far,
                      times=np.linspace(0.0, 1.0, 20, dtype=np.float32) if cfg.use_time else None)


def train_state(cfg, ds, device, seed=0):
    """A fresh training state from ``seed``: module, table, Adam, StepLR,
    generator and the pool."""
    import torch

    from danerf_tpu_torch.train.trainer import init_model, make_optimizer

    model, table = init_model(cfg, ds.n_images, seed, device)
    opt, sched = make_optimizer(cfg, list(model.parameters()) + [table])
    gen = torch.Generator(device=device).manual_seed(seed)
    return model, table, opt, sched, gen, ds.device_arrays(cfg.white_background, device=device)


def state_diff(a, b):
    """What differs, bit for bit, between two training states (module,
    table, Adam's moments and step counts, the rate, StepLR, and the
    generators' next draw, which this consumes)."""
    import torch

    (ma, ta, oa, sa, ga), (mb, tb, ob, sb, gb) = a, b
    diff = [n for (n, p), q in zip(ma.named_parameters(), mb.parameters())
            if not torch.equal(p, q)]
    if not torch.equal(ta, tb):
        diff.append("appearance")
    pa, pb = list(ma.parameters()) + [ta], list(mb.parameters()) + [tb]
    for i, (p, q) in enumerate(zip(pa, pb)):
        for k in ("step", "exp_avg", "exp_avg_sq"):
            if not torch.equal(oa.state[p][k], ob.state[q][k]):
                diff.append(f"adam[{i}].{k}")
    if not torch.equal(oa.param_groups[0]["lr"], ob.param_groups[0]["lr"]):
        diff.append("lr")
    if sa.last_epoch != sb.last_epoch:
        diff.append("steplr")
    if not torch.equal(torch.rand(16, generator=ga, device=ga.device),
                       torch.rand(16, generator=gb, device=gb.device)):
        diff.append("generator next draw")
    return diff


def chained_vs_eager(cfg, ds, device, k, calls, per_step):
    """From one seeded state, 5 warm-up steps of 64 rays (train's), then
    ``calls`` calls of ``k`` steps as one graph replay (make_train_step,
    steps_per_call=k) against calls * k eager steps (steps_per_call=1):
    returns the differences (state_diff, then each step's metrics), the
    launches of both runs against the path's, and the graph's pool."""
    import torch

    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.train.trainer import make_train_step

    runs = {}
    for mode, per_call in (("chained", k), ("eager", 1)):
        model, table, opt, sched, gen, pool = train_state(cfg, ds, device)
        warm = make_train_step(model, table, opt, sched, pool, cfg, ds.height, ds.width,
                               ds.focal, 64, gen, 1)
        for _ in range(5):
            warm()
        step = make_train_step(model, table, opt, sched, pool, cfg, ds.height, ds.width,
                               ds.focal, None, gen, per_call)
        fr.reset_launch_counts()
        out = [step() for _ in range(calls * k // per_call)]
        torch.cuda.synchronize()
        runs[mode] = {"state": (model, table, opt, sched, gen), "launches": dict(fr.LAUNCHES),
                      "metrics": {n: torch.cat([m[n] for m in out]) for n in out[0]},
                      "pool_bytes": getattr(step, "pool_bytes", None)}
    c, e = runs["chained"], runs["eager"]
    diff = state_diff(c["state"], e["state"])
    diff += [f"metric {n}" for n in e["metrics"]
             if not torch.equal(c["metrics"][n], e["metrics"][n])]
    want = launches_of(per_step, calls * k)
    bad_launches = {m: r["launches"] for m, r in runs.items() if r["launches"] != want}
    finite = all(bool(torch.isfinite(v).all()) for v in c["metrics"].values())
    return {"steps": calls * k, "differences": diff, "launches_wrong": bad_launches,
            "finite": finite, "graph_pool_bytes": c["pool_bytes"],
            "loss_first_last": [float(c["metrics"]["loss"][0]),
                                float(c["metrics"]["loss"][-1])]}


def resume_vs_straight(cfg, ds, device, out_dir):
    """train() for 40 steps with a checkpoint every 20 (10 steps a call)
    against 20 steps, a resume, and 20 more: the final checkpoints bit for
    bit (module, table, Adam, StepLR, the generator's state) and the rows of
    steps 21-40."""
    import shutil

    import torch

    from danerf_tpu_torch.train.trainer import train

    dirs = {m: os.path.join(out_dir, f"chained_resume_{m}") for m in ("straight", "split")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)

    def run(d, n, resume=False):
        train(cfg, ds, save_dir=d, num_iterations=n, checkpoint_every=20, device=device,
              progress=False, resume=resume, log_path=os.path.join(d, "metrics.jsonl"))

    run(dirs["straight"], 40)
    run(dirs["split"], 20)
    run(dirs["split"], 40, resume=True)
    a, b = (torch.load(os.path.join(d, "checkpoint_final.pt"), map_location="cpu",
                       weights_only=False) for d in dirs.values())
    diff = [k for k, v in a["model_state_dict"].items()
            if not torch.equal(v, b["model_state_dict"][k])]
    for key in ("appearance_embeddings", "generator_state"):
        if not torch.equal(a[key], b[key]):
            diff.append(key)
    sa, sb = a["optimizer_state_dict"], b["optimizer_state_dict"]
    diff += [f"adam[{i}].{k}" for i, st in sa["state"].items() for k, v in st.items()
             if not torch.equal(v, sb["state"][i][k])]
    for key in ("param_groups",):
        if sa[key] != sb[key]:
            diff.append(f"adam {key}")
    if a["scheduler_state_dict"] != b["scheduler_state_dict"]:
        diff.append("steplr")

    def rows(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return [{k: v for k, v in json.loads(line).items() if k != "t"} for line in f]

    ra, rb = rows(dirs["straight"]), rows(dirs["split"])
    if [r["step"] for r in rb] != list(range(1, 41)) or ra[20:] != rb[20:]:
        diff.append("rows 21-40")
    return {"iteration": [a["iteration"], b["iteration"]], "differences": diff}


def phase_chained(cfg, device, out_dir, k=10):
    """Several steps a call on the card: for each training path at B = 1024,
    from one seeded state, ``k`` steps as one replay of a captured CUDA
    graph against ``k`` eager steps, bit for bit (parameters and table,
    Adam's moments and step counts, the rate, StepLR, each step's metrics,
    the generator's next draw), with exactly the path's launches per step
    on both; on the 64 + 64 path also 3 replays against 30 eager steps with
    scheduler_step_size=7 (the rate changes inside a replay), and train()
    for 40 steps (a checkpoint every 20) against 20, a resume and 20 more."""
    report, failures = {}, []
    for path, (over, per_step) in PATHS.items():
        pcfg = cfg.replace(**over)
        report[path] = chained_vs_eager(pcfg, timing_scene(pcfg), device, k, 1, per_step)
    report["rate_boundary"] = chained_vs_eager(cfg.replace(scheduler_step_size=7),
                                               timing_scene(cfg), device, k, 3,
                                               PATHS["hier"][1])
    for name, r in report.items():
        if r["differences"] or r["launches_wrong"] or not r["finite"]:
            failures.append(f"{name}: {r['differences']} {r['launches_wrong']} "
                            f"finite={r['finite']}")
    report["resume"] = resume_vs_straight(cfg, timing_scene(cfg), device, out_dir)
    if report["resume"]["differences"] or report["resume"]["iteration"] != [40, 40]:
        failures.append(f"resume: {report['resume']}")
    emit({"phase": "chained", "steps_per_call": k, "rays": cfg.batch_size, **report,
          "failures": failures})
    if failures:
        raise AssertionError("chained steps differ from eager steps: " + "; ".join(failures))


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
               "per_sample": [], "time": ["--use_time"], "hier_onepass": [],
               # data-parallel 64 + 64 over every rank of a torchrun group
               "hier_dp": ["--coordinator_address", "auto", "--mesh_data", "0"]}
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
    return train(cfg, load_dataset(cfg, "train"), save_dir=args.save_dir, resume=args.resume,
                 num_iterations=args.iters, seed=args.seed, device=args.device,
                 checkpoint_every=args.checkpoint_every,
                 log_path=os.path.join(args.save_dir, "metrics.jsonl"))


def phase_train(out_dir, path, iters, render, every=None, resume_to=None):
    """A training path through its entry point: `cli.main train` (for the
    routes without a flag ``train_api``) for ``iters`` steps on the
    procedural scene (its time-varying form under --use_time), 10 steps a
    call (the default steps_per_call: one graph replay a full chunk), with
    exactly the path's kernel launches per step, one metrics.jsonl row a
    step, finite losses and a rising PSNR.  With ``every``
    (--checkpoint_every) each checkpoint's validation render (one K2 and
    one K5 launch: the 100x100 view is one chunk) is counted too, and
    render_000100.png and training_curves.png must decode; with
    ``resume_to`` the run is then resumed (--resume) to that step, with
    exactly the path's launches for the steps added and their rows
    appended.  Then, when ``render``, `render` of the final checkpoint: a
    100x100 preview frame, or for the time path two 400x400 medium frames
    with --use_time --animate_time (t = 0, then 1)."""
    import shutil

    import numpy as np
    import torch

    from danerf_tpu_torch.cli.main import main as cli_main
    from danerf_tpu_torch.data.png import read_png
    from danerf_tpu_torch.kernels import fused_render as fr

    warmup = 5
    kind = path.removesuffix("_dp")   # the launches of a data-parallel step: its path's
    save = os.path.join(out_dir, f"train_{path}")
    shutil.rmtree(save, ignore_errors=True)          # metrics.jsonl appends
    no_scene = os.path.join(out_dir, "no_scene")     # -> the procedural scene
    argv = ["train", "--density_bias_init", "0.5", "--save_dir", save, "--device", "cuda",
            "--seed", "0", "--dataset_path", no_scene, *TRAIN_FLAGS[path]]
    if every:
        argv += ["--checkpoint_every", str(every)]

    def run(n, *flags):
        fr.reset_launch_counts()
        t0 = time.perf_counter()
        if path in API_PATHS:
            train_api([*argv, "--iters", str(n), *flags], PATHS[kind][0])
        else:
            cli_main([*argv, "--iters", str(n), *flags])
        torch.cuda.synchronize()
        return time.perf_counter() - t0, dict(fr.LAUNCHES)

    def val_renders(first, last):
        n = sum(1 for s in range(first + 1, last + 1) if every and s % every == 0)
        return {"march": n, "merged": n if PATHS[kind][0].get("num_importance", 1) else 0}

    secs, counts = run(iters)
    want = launches_of(PATHS[kind][1], iters)
    for k, v in val_renders(0, iters).items():
        want[k] += v
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
    pngs = {}
    if every:
        for name, shape in (("render_000100.png", (100, 200, 3)),
                            ("training_curves.png", (400, 1000, 3))):
            img = read_png(os.path.join(save, name))
            if img.shape != shape or img.std() == 0:
                raise AssertionError(f"train {path}: {name} decodes to {img.shape}, "
                                     f"std {img.std()}")
            pngs[name] = list(img.shape)
    resumed = None
    if resume_to:
        r_secs, r_counts = run(resume_to, "--resume")
        r_want = launches_of(PATHS[kind][1], resume_to - iters)
        for k, v in val_renders(iters, resume_to).items():
            r_want[k] += v
        if r_counts != r_want:
            raise AssertionError(f"train {path} --resume: launches {r_counts}, "
                                 f"expected {r_want}")
        with open(os.path.join(save, "metrics.jsonl")) as f:
            r_rows = [json.loads(line) for line in f]
        if [r["step"] for r in r_rows] != list(range(1, resume_to + 1)):
            raise AssertionError(f"train {path} --resume: the rows are not 1..{resume_to}")
        it = torch.load(ckpt, map_location="cpu", weights_only=False)["iteration"]
        if it != resume_to or not all(math.isfinite(r["loss"]) for r in r_rows):
            raise AssertionError(f"train {path} --resume: final checkpoint at {it}")
        resumed = {"to": resume_to, "seconds": r_secs, "launches": r_counts,
                   "loss_last": r_rows[-1]["loss"],
                   "psnr_mean_last20": float(np.mean([r["psnr"] for r in r_rows[-20:]]))}
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
          "checkpoint_every": every, "seconds_incl_scene": secs, "launches": counts,
          "loss_first": rows[0]["loss"], "loss_last": rows[-1]["loss"],
          "psnr_mean_first20_after_warmup": first, "psnr_mean_last20": last,
          "pngs": pngs, "resumed": resumed, "render": rendered})
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
    """The training step of ``cfg`` at B = 1024 on timing_scene's pool:
    the median of 50 synchronised eager steps after 5 warm-up steps, its
    rays/s, the share of ``kernels`` (keys of ``kernel_ms``, the step's
    kernels timed alone) and their summed bound; then the chained step (10
    steps a call, one graph replay): the median, min and max of 20
    synchronised replays, each over 10, its rays/s, one replay's device time
    by CUDA events, and the graph's pool; with ``profile`` torch.profiler
    windows of 10 eager steps and of 3 replays."""
    import numpy as np
    import torch

    from danerf_tpu_torch.train.trainer import make_train_step, train_step

    ds = timing_scene(cfg)
    model, table, opt, sched, gen, pool = train_state(cfg, ds, device)

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

    k = 10
    chained = make_train_step(model, table, opt, sched, pool, cfg, 100, 100, ds.focal, None,
                              gen, k)
    chained()
    torch.cuda.synchronize()
    reps = []
    for _ in range(20):
        t0 = time.perf_counter()
        chained()
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) * 1e3 / k)
    chained_ms = float(np.median(reps))
    out.update({"chained_steps_per_call": k, "chained_ms_per_step_median": chained_ms,
                "chained_ms_per_step_min": min(reps), "chained_ms_per_step_max": max(reps),
                "chained_rays_per_s": cfg.batch_size / (chained_ms / 1e3),
                "chained_replay_event_ms": cuda_ms(chained, 5),
                "graph_pool_bytes": chained.pool_bytes})
    if profile:
        prof = profile_steps(chained, n_prof=3)
        out.update({"chained_profile_ms_per_replay": prof["profile_ms_per_step"],
                    "chained_profile_breakdown_ms_per_step": {
                        n: v / k for n, v in prof["profile_breakdown_ms_per_step"].items()},
                    "chained_profile_device_busy_ms_per_step":
                        prof["profile_device_busy_ms_per_step"] / k,
                    "chained_profile_wall_ms_per_step": prof["profile_wall_ms_per_step"] / k,
                    "chained_profile_idle_share": prof["profile_idle_share"]})
    return out


# ---------------------------------------------------------------- effects

def fx_inputs(side, seed):
    """A seeded uint8 frame and a depth map in [0, 1] with smooth structure,
    a step at a third of the width and a little noise (on the host)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    img = torch.randint(0, 256, (side, side, 3), generator=g, dtype=torch.uint8)
    yy, xx = torch.meshgrid(torch.arange(side), torch.arange(side), indexing="ij")
    depth = 0.45 + 0.25 * torch.sin(xx / 7.0) * torch.cos(yy / 5.0)
    depth = depth + 0.05 * torch.rand(side, side, generator=g) + 0.2 * (xx >= side // 3)
    return img, depth.clamp(0, 1)


def event_ms(fn, iters=10):
    """Median and each of ``iters`` CUDA-event times of ``fn`` after a
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2], times


def phase_fx(device, side=800):
    """Each of the 14 effects, with and without depth, on a seeded 800x800
    frame and depth: on the card and, with the same draws, through the port
    on the CPU, within effects.levels_apart's tolerance, under PyTorch's
    default TF32 flags (cuDNN on, matmul off; restored after); then each
    effect's time on the card (with depth, its noise drawn on the card):
    median of 10 CUDA-event times after a warm-up call."""
    import torch

    from danerf_tpu_torch.fx.effects import EFFECTS, apply_effect, draw_noise, levels_apart

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        img, depth = fx_inputs(side, 11)
        img_d, depth_d = img.to(device), depth.to(device)
        held, failures = {}, []
        for name in EFFECTS:
            for tag, dep, dep_d in (("depth", depth, depth_d), ("no_depth", None, None)):
                draws = draw_noise(name, img.shape, torch.Generator().manual_seed(12), "cpu")
                want = apply_effect(name, img, dep, draws=draws, device="cpu")
                got = apply_effect(name, img_d, dep_d, draws=draws)
                if got.device.type != "cuda" or got.dtype != torch.uint8:
                    failures.append(f"{name} {tag}: {got.device} {got.dtype}")
                apart = levels_apart(name, got, want)
                held[f"{name} / {tag}"] = apart
                if not apart["ok"]:
                    failures.append(f"{name} {tag}: {apart}")
        ms = {}
        for name in EFFECTS:
            gen = torch.Generator(device=device).manual_seed(13)
            ms[name], _ = event_ms(lambda: apply_effect(name, img_d, depth_d, generator=gen))
        flags = {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                 "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    emit({"phase": "fx", "size": side, "tf32_flags": flags, "held": held, "ms": ms,
          "failures": failures})
    if failures:
        raise AssertionError("effects on the card differ from the CPU: " + "; ".join(failures))
    return ms


def serve_launches(counts, want_k2k5):
    """The render's launches: exactly ``want_k2k5`` K2 and K5, nothing else."""
    want = {k: (want_k2k5 if k in ("march", "merged") else 0) for k in counts}
    if counts != want:
        raise AssertionError(f"launches {counts}, expected {want}")


def check_video(path, pngs, fps):
    """The AVI, read with the port's reader: one frame a PNG, each equal
    to its PNG, at ``fps``."""
    import numpy as np

    from danerf_tpu_torch.data.png import read_png
    from danerf_tpu_torch.viz.video import read_avi

    frames, got_fps = read_avi(path)
    want = np.stack([read_png(p) for p in pngs])
    if frames.shape != want.shape or got_fps != fps or not np.array_equal(frames, want):
        raise AssertionError(f"{path}: {frames.shape} at {got_fps} fps, expected "
                             f"{want.shape} at {fps}, equal={np.array_equal(frames, want)}")
    return list(frames.shape)


def phase_serve_fx(cfg, out_dir, device, size=400):
    """render --effect Fog --create_video, then --effect Hologram, each two
    400x400 medium frames from the smoke checkpoint: every file, the video
    read back against the PNGs, and exactly one K2 and one K5 a chunk."""
    import numpy as np
    import torch

    from danerf_tpu_torch.cli.main import main as cli_main
    from danerf_tpu_torch.data.png import read_png
    from danerf_tpu_torch.kernels import fused_render as fr

    ckpt = os.path.join(out_dir, "smoke_model.pt")
    frames = 2
    chunks = -(-size * size // cfg.render_chunk)
    plain = [read_png(os.path.join(out_dir, "render_medium", f"rgb_{i:03d}.png"))
             for i in range(frames)]
    runs = {}
    for effect in ("Fog", "Hologram"):
        run_dir = os.path.join(out_dir, f"serve_fx_{effect.lower()}")
        argv = ["render", "--checkpoint", ckpt, "--output_dir", run_dir, "--frames",
                str(frames), "--width", str(size), "--height", str(size), "--quality",
                "medium", "--save_depth", "--effect", effect, "--create_video", "--fps", "24",
                "--device", str(device), "--seed", "0"]
        fr.reset_launch_counts()
        t0 = time.perf_counter()
        written = cli_main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(fr.LAUNCHES)
        serve_launches(counts, chunks * frames)
        for i in range(frames):
            for name in (f"rgb_{i:03d}.png", f"depth_{i:03d}.png", f"raw/depth_{i:03d}.npy"):
                if not os.path.exists(os.path.join(run_dir, name)):
                    raise AssertionError(f"{effect}: {name} was not written")
        # render's default --scene, hotdog, names the video
        shape = check_video(os.path.join(run_dir, "hotdog_render.avi"), written, 24)
        got = [read_png(p) for p in written]
        if effect == "Fog" and min(int(g.min()) for g in got) < 178:
            raise AssertionError("Fog: a pixel below 0.7 x 255 (fog lets at most 30% through)")
        if any(np.array_equal(g, p) for g, p in zip(got, plain)):
            raise AssertionError(f"{effect}: a frame equals the unaffected render")
        runs[effect] = {"frames": len(written), "seconds": secs, "launches": counts,
                        "video": shape}
    emit({"phase": "serve_fx", "size": size, **runs})
    return runs


def phase_spiral_fx(cfg, out_dir, device, n=12, size=200):
    """The reference's pipeline through the CLI on the card: spiral (12
    frames at 200x200, depth on frames 0 and 10, its video), effects on its
    output (all 14: Fog on the 2 depth frames, the rest on 12, a video
    each), preview (fog_start at three values), video."""
    import json as _json

    import torch

    from danerf_tpu_torch.cli.main import main as cli_main
    from danerf_tpu_torch.data.png import read_png
    from danerf_tpu_torch.fx.effects import EFFECTS
    from danerf_tpu_torch.kernels import fused_render as fr

    ckpt = os.path.abspath(os.path.join(out_dir, "smoke_model.pt"))
    work = os.path.join(out_dir, "spiral_fx")
    os.makedirs(work, exist_ok=True)
    chunks = -(-size * size // cfg.render_chunk)
    report = {}
    with contextlib.chdir(work):
        fr.reset_launch_counts()
        t0 = time.perf_counter()
        written = cli_main(["spiral", "--checkpoint", ckpt, "--output_dir", "sp", "--frames",
                            str(n), "--width", str(size), "--height", str(size), "--fps", "30",
                            "--device", str(device), "--seed", "0"])
        torch.cuda.synchronize()
        report["spiral_seconds"] = time.perf_counter() - t0
        counts = dict(fr.LAUNCHES)
        serve_launches(counts, chunks * n)
        report["spiral_launches"] = counts
        depth = sorted(f for f in os.listdir("output/sp") if f.startswith("depth_"))
        if depth != ["depth_0000.png", "depth_0010.png"] or len(written) != n:
            raise AssertionError(f"spiral wrote {len(written)} frames, depth {depth}")
        if read_png("output/sp/depth_0000.png").shape != (size, size):
            raise AssertionError("spiral depth is not a grayscale frame")
        # spiral's default --scene, chair, names the video
        report["spiral_video"] = check_video("output/sp/chair_spiral.avi", written, 30)

        t0 = time.perf_counter()
        names = cli_main(["effects", "--input_dir", "output/sp", "--device", str(device)])
        report["effects_seconds"] = time.perf_counter() - t0
        if names != list(EFFECTS):
            raise AssertionError(f"effects ran {names}")
        report["effects_frames"] = {}
        for name in names:
            slug = name.lower().replace(" ", "_")
            outs = sorted(os.path.join("output/sp_effects", slug, f)
                          for f in os.listdir(os.path.join("output/sp_effects", slug)))
            if len(outs) != (2 if name == "Fog" else n):
                raise AssertionError(f"effects {name}: {len(outs)} frames")
            check_video(f"output/sp_effects/{slug}.avi", outs, 60)
            report["effects_frames"][name] = len(outs)

        with open("spec.json", "w") as f:
            _json.dump({"effects": [{"name": "Fog", "sweep": {"fog_start": [0.0, 0.2, 0.4]}}]},
                       f)
        previews = cli_main(["preview", "--image", "output/sp/frame_0000.png", "--depth",
                             "output/sp/depth_0000.png", "--spec", "spec.json", "--output_dir",
                             "pv", "--device", str(device)])
        with open("pv/manifest.json") as f:
            manifest = _json.load(f)
        if len(previews) != 3 or [m["params"]["fog_start"] for m in manifest] != [0.0, 0.2, 0.4]:
            raise AssertionError(f"preview wrote {previews}, manifest {manifest}")
        report["previews"] = [os.path.basename(p) for p in previews]

        cli_main(["video", "--input_dir", "output/sp", "--output", "sp.mp4", "--pattern",
                  "frame_*.png", "--fps", "30"])
        report["video"] = check_video("sp.avi", written, 30)
    emit({"phase": "spiral_fx", "frames": n, "size": size, **report})
    return report


def phase_serve_timing(cfg, model, out_dir, device, side=800, frames=4):
    """One 800x800 medium frame four ways, in one call: render_frame alone
    (median of 3 after a warm-up frame); the frame loop as it was before
    the I/O overlap (render, fetch, two PNG encodes, one frame after
    another: ms a frame over ``frames``); render_path, which overlaps the
    fetch and the encodes with the next frame (ms a frame over ``frames``
    after a warm-up call of one frame), without an effect, with Fog and with
    Toon Shader, and without an effect over 3 x ``frames``; then
    apply_effect_to_frames' timings (Toon Shader) over an aligned spiral of
    ``frames`` 800x800 frames."""
    import numpy as np
    import torch

    from danerf_tpu_torch.fx.batch import apply_effect_to_frames
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.render.frames import render_aligned_spiral, render_path
    from danerf_tpu_torch.render.renderer import render_frame
    from danerf_tpu_torch.viz.depth import colorize_depth
    from danerf_tpu_torch.viz.paths import camera_path
    from danerf_tpu_torch.viz.png import write_png

    emb = torch.randn(cfg.appearance_dim, generator=torch.Generator().manual_seed(3))
    focal = 0.5 * side / np.tan(0.5 * 0.6911)
    c2ws = camera_path("circle", frames, cfg.scene)
    chunks = -(-side * side // cfg.render_chunk)
    work = os.path.join(out_dir, "serve_timing")

    def frame(i):
        gen = torch.Generator(device=device).manual_seed(i)
        return render_frame(model, cfg, c2ws[i % frames], side, side, focal,
                            appearance_embedding=emb, perturb=True, generator=gen,
                            device=device)

    frame(0)
    torch.cuda.synchronize()
    alone = []
    for i in range(3):
        t0 = time.perf_counter()
        frame(i)
        torch.cuda.synchronize()
        alone.append((time.perf_counter() - t0) * 1e3)

    serial_dir = os.path.join(work, "serial")
    os.makedirs(serial_dir, exist_ok=True)
    t0 = time.perf_counter()
    for i in range(frames):
        gen = torch.Generator(device=device).manual_seed(i)
        rgb, depth, _ = render_frame(model, cfg, c2ws[i], side, side, focal,
                                     appearance_embedding=emb, perturb=True,
                                     generator=gen, device=device)
        rgb_u8 = (rgb * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()
        depth_np = depth.cpu().numpy()
        write_png(os.path.join(serial_dir, f"rgb_{i:03d}.png"), rgb_u8)
        write_png(os.path.join(serial_dir, f"depth_{i:03d}.png"), colorize_depth(depth_np))
    serial = (time.perf_counter() - t0) * 1e3 / frames

    paths = {}
    # the last frame's PNGs are written after its render: over ``frames``
    # frames that tail is part of each frame's ms; 3 x ``frames`` without an
    # effect shows the steady state
    for effect, n in ((None, frames), ("Fog", frames), ("Toon Shader", frames),
                      (None, 3 * frames)):
        tag = f"{effect or 'none'} x {n}"
        run_dir = os.path.join(work, tag.lower().replace(" ", "_"))
        kw = dict(appearance_embedding=emb, quality="medium", width=side, height=side,
                  effect=effect, device=device)
        render_path(model, cfg, run_dir + "_warm", num_frames=1, **kw)
        fr.reset_launch_counts()
        t0 = time.perf_counter()
        written = render_path(model, cfg, run_dir, num_frames=n, **kw)
        ms = (time.perf_counter() - t0) * 1e3 / n
        counts = dict(fr.LAUNCHES)
        serve_launches(counts, chunks * n)
        if len(written) != n:
            raise AssertionError(f"render_path {tag}: {len(written)} frames")
        paths[tag] = {"ms_per_frame": ms, "launches": counts}

    spiral_dir = os.path.join(work, "spiral")
    fr.reset_launch_counts()
    t0 = time.perf_counter()
    render_aligned_spiral(model, cfg, spiral_dir, appearance_embedding=emb, num_frames=frames,
                          height=side, width=side, make_video=False, device=device)
    spiral_ms = (time.perf_counter() - t0) * 1e3 / frames
    spiral_launches = dict(fr.LAUNCHES)
    serve_launches(spiral_launches, chunks * frames)
    batch = {}
    apply_effect_to_frames(spiral_dir, os.path.join(work, "batch", "toon_shader"),
                           "Toon Shader", make_video=False, timings=batch, device=device)
    if batch["frames"] != frames:
        raise AssertionError(f"apply_effect_to_frames timed {batch}")
    report = {"size": side, "frames": frames, "render_frame_ms": sorted(alone)[1],
              "render_frame_each_ms": alone,
              "serial_loop_ms_per_frame": serial, "render_path": paths,
              "spiral_ms_per_frame": spiral_ms, "spiral_launches": spiral_launches,
              "batch_toon_shader": batch}
    emit({"phase": "serve_timing", **report})
    return report


# Each eval run of phase_eval: (checkpoint's training path, flags beyond
# --checkpoint/--max_views/--device).
EVAL_RUNS = (("hier", ["--split", "val"]),
             ("hier", ["--split", "val", "--optimize_embeddings"]),
             ("hier", ["--split", "train"]),
             ("hier", ["--split", "val", "--optimize_embeddings", "--num_importance", "0"]),
             ("white", ["--split", "val", "--white_background"]),
             ("white", ["--split", "val", "--white_background", "--optimize_embeddings"]),
             ("white", ["--split", "train", "--white_background"]),
             ("time", ["--split", "val", "--use_time"]),
             ("time", ["--split", "val", "--use_time", "--optimize_embeddings"]),
             ("time", ["--split", "train", "--use_time"]))
EVAL_VIEWS = 2
EVAL_OPT_STEPS = 50
# per view, the kernel route against the plain route (--no_pallas) on the card
EVAL_TOL = {"psnr_db": 0.1, "ssim": 0.005}


def eval_launches(flags, views, size=100):
    """The launches of `eval` over ``views`` views of size x size: one K2 and
    one K5 a chunk of the frame (K2 alone under --num_importance 0); with
    --optimize_embeddings also, a view, EVAL_OPT_STEPS x (K2 + K5 + K6 +
    K3) of the fit (K2 + K3 under --num_importance 0)."""
    from danerf_tpu_torch.kernels import fused_render as fr

    chunks = -(-size * size // 65536)
    coarse = "--num_importance" in flags and flags[flags.index("--num_importance") + 1] == "0"
    frame = {"march": chunks} if coarse else {"march": chunks, "merged": chunks}
    step = ({"march": 1, "march_bwd": 1} if coarse
            else {"march": 1, "merged": 1, "merged_bwd": 1, "march_bwd": 1})
    fit = EVAL_OPT_STEPS if "--optimize_embeddings" in flags else 0
    return {k: views * (frame.get(k, 0) + fit * step.get(k, 0)) for k in fr.LAUNCHES}


def phase_eval(out_dir):
    """`cli.main eval` on the checkpoints phase_train wrote (64 + 64, white
    background, use_time; the procedural scene, 100x100 views): --max_views
    2 of --split val with and without --optimize_embeddings (the fit: 50
    Adam steps a view, one CUDA-graph replay), of --split train (each view
    its own embedding), and a fit under --num_importance 0.  Each run with
    exactly its launches (eval_launches; zeroed just before, read just
    after) and, per view, within EVAL_TOL of the same command with
    --no_pallas on the card, which launches nothing.  Then one view's
    graph fit against its eager fit, bit for bit, and the fit's launches
    per replay."""
    import numpy as np
    import torch

    from danerf_tpu_torch.cli.main import main as cli_main
    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.data.dataset import load_dataset
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.train.evaluate import EmbeddingFit, _target, left_half_rays, fit_seed
    from danerf_tpu_torch.utils.checkpoint import load_model

    no_scene = os.path.join(out_dir, "no_scene")
    runs, totals = [], {k: 0 for k in fr.LAUNCHES}
    for path, flags in EVAL_RUNS:
        ckpt = os.path.join(out_dir, f"train_{path}", "checkpoint_final.pt")
        argv = ["eval", "--checkpoint", ckpt, "--dataset_path", no_scene, "--max_views",
                str(EVAL_VIEWS), "--device", "cuda", *flags]
        fr.reset_launch_counts()
        t0 = time.perf_counter()
        got = cli_main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(fr.LAUNCHES)
        want = eval_launches(flags, EVAL_VIEWS)
        if counts != want:
            raise AssertionError(f"eval {path} {flags}: launches {counts}, expected {want}")
        for k, v in counts.items():
            totals[k] += v
        fr.reset_launch_counts()
        plain = cli_main([*argv, "--no_pallas"])
        torch.cuda.synchronize()
        if any(fr.LAUNCHES.values()):
            raise AssertionError(f"eval --no_pallas launched {fr.LAUNCHES}")
        deltas = []
        for g, p in zip(got["per_view"], plain["per_view"]):
            d = {"psnr_db": abs(g["psnr"] - p["psnr"]), "ssim": abs(g["ssim"] - p["ssim"])}
            if not (np.isfinite(g["psnr"]) and all(d[k] <= EVAL_TOL[k] for k in d)):
                raise AssertionError(f"eval {path} {flags}: view {g['view']} kernel {g}, "
                                     f"plain {p}")
            deltas.append(d)
        want_protocol = ("left-half-optimized, right-half-scored"
                         if "--optimize_embeddings" in flags else "full-image")
        if got["protocol"] != want_protocol or got["n_views"] != EVAL_VIEWS:
            raise AssertionError(f"eval {path} {flags}: {got['protocol']}, {got['n_views']}")
        runs.append({"path": path, "flags": flags, "seconds": secs, "launches": counts,
                     "psnr": [v["psnr"] for v in got["per_view"]],
                     "ssim": [v["ssim"] for v in got["per_view"]],
                     "plain_psnr": [v["psnr"] for v in plain["per_view"]],
                     "plain_ssim": [v["ssim"] for v in plain["per_view"]],
                     "max_delta": {k: max(d[k] for d in deltas) for k in EVAL_TOL}})

    # one view's fit as a graph replay against the same fit run eagerly
    cfg = NeRFConfig(dataset_path=no_scene)
    ds = load_dataset(cfg, "val")
    model, _, _, cfg = load_model(os.path.join(out_dir, "train_hier", "checkpoint_final.pt"),
                                  cfg, "cuda")
    model.requires_grad_(False)
    dev = torch.device("cuda")
    rays_o, rays_d = left_half_rays(ds.c2ws[0], ds.height, ds.width, ds.focal, dev)
    gt = torch.from_numpy(ds.images[0]).to(dev)
    target = _target(gt, None)[:, :ds.width // 2].reshape(-1, 3)
    fits = {}
    for graph in (True, False):
        fit = EmbeddingFit(model, cfg, rays_o.shape[0], EVAL_OPT_STEPS, device=dev, graph=graph)
        idx = torch.randint(0, rays_o.shape[0], (EVAL_OPT_STEPS, fit.batch), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(fit_seed(0, 0)))
        fr.reset_launch_counts()
        fits[graph] = (fit(rays_o, rays_d, target, idx), fit(rays_o, rays_d, target, idx))
        torch.cuda.synchronize()
        fits[f"launches_{graph}"] = dict(fr.LAUNCHES)
    (g1, g2), (e1, e2) = fits[True], fits[False]
    if not (torch.equal(g1, e1) and torch.equal(g2, e2) and torch.equal(g1, g2)):
        raise AssertionError(f"graph fit {g1.tolist()} != eager fit {e1.tolist()}")
    per_fit = eval_launches(["--optimize_embeddings"], 1, size=0)
    for graph in (True, False):
        want = {k: 2 * v for k, v in per_fit.items()}
        if fits[f"launches_{graph}"] != want:
            raise AssertionError(f"fit (graph={graph}) launches {fits[f'launches_{graph}']}, "
                                 f"expected {want}")
    emit({"phase": "eval", "views": EVAL_VIEWS, "opt_steps": EVAL_OPT_STEPS, "tol": EVAL_TOL,
          "runs": runs, "launches_total": totals, "graph_fit_equals_eager_fit": True,
          "fit_embedding_norm": float(g1.norm()), "launches_per_fit": per_fit})
    return totals


def eval_timing_scene(side, views, seed=0):
    """A RayDataset of ``views`` seeded random side x side images on the
    procedural scene's first poses (the content does not matter for time)."""
    import numpy as np

    from danerf_tpu_torch.data.dataset import RayDataset
    from danerf_tpu_torch.data.synthetic import SYNTHETIC_FOV, make_synthetic_scene

    poses = make_synthetic_scene(split="val", n_images=views, height=8, width=8,
                                 n_samples=4).c2ws
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (views, side, side, 3), dtype=np.uint8)
    return RayDataset(imgs, np.full((views, side, side), 255, np.uint8), poses,
                      float(0.5 * side / np.tan(0.5 * SYNTHETIC_FOV)), 2.0, 6.0, "val")


def phase_eval_timing(cfg, model, device, side=800, views=2):
    """evaluate() at side x side on the seeded model, in one call: ms a view
    over ``views`` views (after a warm-up call of one view) without and
    with the embedding fit (each call captures the fit once and replays it
    a view); the fit alone, eagerly and as a graph replay (median of 3
    after a warm-up), and a replay's device-busy ms over one torch.profiler
    window (after the other timings: a window slows later eager launches,
    PERF.md section 7); render_frame alone and with the score
    (_score_view) beside it."""
    import torch

    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.render.renderer import render_frame
    from danerf_tpu_torch.train.evaluate import EmbeddingFit, _score_view, left_half_rays
    from danerf_tpu_torch.train.evaluate import evaluate

    ds = eval_timing_scene(side, views)
    table = torch.randn(views, cfg.appearance_dim, generator=torch.Generator().manual_seed(5))
    chunks = -(-side * side // cfg.render_chunk)
    per_view = {}
    for fit in (False, True):
        evaluate(model, cfg, ds, appearance=table, max_views=1, optimize_embeddings=fit,
                 device=device)
        fr.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = evaluate(model, cfg, ds, appearance=table, optimize_embeddings=fit,
                       device=device)
        ms = (time.perf_counter() - t0) * 1e3 / views
        want = {k: views * (chunks + (EVAL_OPT_STEPS if fit else 0))
                if k in ("march", "merged") else
                views * EVAL_OPT_STEPS if fit and k in ("merged_bwd", "march_bwd") else 0
                for k in fr.LAUNCHES}
        if dict(fr.LAUNCHES) != want:
            raise AssertionError(f"eval_timing fit={fit}: launches {fr.LAUNCHES}, "
                                 f"expected {want}")
        per_view["fit" if fit else "no_fit"] = {"ms_per_view": ms, "psnr": res["psnr"],
                                               "launches": dict(fr.LAUNCHES)}

    dev = torch.device(device)
    rays_o, rays_d = left_half_rays(ds.c2ws[0], side, side, ds.focal, dev)
    target = torch.rand(rays_o.shape[0], 3, generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev)
    idx = torch.randint(0, rays_o.shape[0], (EVAL_OPT_STEPS, 1024), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(2))
    fit_ms = {}
    fits = {}
    for graph in (False, True):
        fit = EmbeddingFit(model, cfg, rays_o.shape[0], EVAL_OPT_STEPS, device=dev, graph=graph)
        fits[graph] = fit
        fit(rays_o, rays_d, target, idx)
        each = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit(rays_o, rays_d, target, idx)
            torch.cuda.synchronize()
            each.append((time.perf_counter() - t0) * 1e3)
        fit_ms["graph" if graph else "eager"] = {"ms": sorted(each)[1], "each_ms": each}

    c2w = ds.c2ws[0]
    gt = torch.from_numpy(ds.images[0]).to(dev)
    emb = table[0].to(dev)

    def frame():
        return render_frame(model, cfg, c2w, side, side, ds.focal, appearance_embedding=emb,
                            perturb=False, device=dev)

    def frame_scored():
        rgb, _, _ = frame()
        return _score_view(rgb, gt, side // 2, False)

    frame_ms = {}
    for name, fn in (("render_frame", frame), ("render_and_score", frame_scored)):
        fn()
        each = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            each.append((time.perf_counter() - t0) * 1e3)
        frame_ms[name] = {"ms": sorted(each)[1], "each_ms": each}
    busy = {name: profile_steps(lambda f=fits[g]: f(rays_o, rays_d, target, idx), n_prof=1)
            for name, g in (("graph", True), ("eager", False))}
    report = {"size": side, "views": views, "opt_steps": EVAL_OPT_STEPS, "batch": 1024,
              "evaluate": per_view, "fit": fit_ms, "frame": frame_ms,
              "fit_device_busy_ms": {k: v["profile_device_busy_ms_per_step"]
                                     for k, v in busy.items()},
              "fit_idle_share": {k: v["profile_idle_share"] for k, v in busy.items()},
              "fit_profile": {k: v["profile_ms_per_step"][:8] for k, v in busy.items()}}
    emit({"phase": "eval_timing", **report})
    return report


def phase_loaders(out_dir):
    """The port's own loaders on the card's host (no imaging library there):
    the committed fixture JPEG (4:2:0, a restart interval) through
    data/jpeg.py and the fixture RGBA PNG downscaled by 8 through
    data/resize.py, each against the sha256 of PIL's output stored beside
    them (tests/data_torch/pil_digests.json, computed where PIL is); their
    ms (median of 3); then a custom-format scene of those frames (two JPEGs
    and a PNG) through load_dataset."""
    import hashlib
    import shutil

    import numpy as np

    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.data.dataset import load_dataset
    from danerf_tpu_torch.data.jpeg import read_jpeg
    from danerf_tpu_torch.data.png import read_png
    from danerf_tpu_torch.data.resize import lanczos_resize
    from danerf_tpu_torch.viz.png import write_png

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data_torch")
    with open(os.path.join(data, "pil_digests.json")) as f:
        stored = json.load(f)
    jpg, png = os.path.join(data, "frame.jpg"), os.path.join(data, "frame_rgba.png")

    rgba = read_png(png)
    report = {}
    for name, key, fn in (
            ("jpeg_decode", "frame.jpg", lambda: read_jpeg(jpg)),
            ("png_decode", None, lambda: read_png(png)),
            ("lanczos_8", "frame_rgba.png lanczos 8",
             lambda: lanczos_resize(rgba, rgba.shape[1] // 8, rgba.shape[0] // 8))):
        each = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = np.ascontiguousarray(fn())
            each.append((time.perf_counter() - t0) * 1e3)
        got = {"shape": list(out.shape), "sha256": hashlib.sha256(out.tobytes()).hexdigest()}
        if key is not None and got != stored[key]:
            raise AssertionError(f"loaders: {key} gives {got}, PIL {stored[key]}")
        report[name] = {"ms": sorted(each)[1], "each_ms": each, "shape": got["shape"],
                        "held_against_pil": key is not None}
    scene = os.path.join(out_dir, "custom_scene")
    shutil.rmtree(scene, ignore_errors=True)
    images = os.path.join(scene, "images")
    os.makedirs(images)
    shutil.copy(jpg, os.path.join(images, "a.jpg"))
    shutil.copy(jpg, os.path.join(images, "c.jpg"))
    rgb = read_jpeg(jpg)[::-1].copy()
    write_png(os.path.join(images, "b.png"), rgb)
    frames = [{"file_path": n, "transform_matrix": np.eye(4).tolist()}
              for n in ("a.jpg", "b.png", "c.jpg")]
    with open(os.path.join(scene, "transforms.json"), "w") as f:
        json.dump({"camera_angle_x": 0.6911, "frames": frames}, f)
    cfg = NeRFConfig(dataset_type="custom", dataset_path=images)
    t0 = time.perf_counter()
    train = load_dataset(cfg, "train")
    val = load_dataset(cfg, "val")
    load_ms = (time.perf_counter() - t0) * 1e3
    if (train.images.shape != (2,) + tuple(stored["frame.jpg"]["shape"])
            or not np.array_equal(train.images[1], rgb) or val.n_images != 1
            or not np.array_equal(val.images[0], train.images[0])
            or not (train.alphas == 255).all()):
        raise AssertionError(f"loaders: the custom scene loads as {train.images.shape}")
    report["custom_scene"] = {"train": list(train.images.shape), "val": list(val.images.shape),
                              "focal": train.focal, "load_ms": load_ms}
    emit({"phase": "loaders", **report})
    return report


# ---------------------------------------------------------------- parallel

def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def torchrun_env():
    """The environment torchrun gives the one process of a one-card run
    (world size 1), which `--coordinator_address auto` reads."""
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "RANK": "0",
           "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dp_vs_single(cfg, ds, device, mesh, k, per_step):
    """From one seeded state, 5 warm-up steps of 64 rays, then one call of
    ``k`` steps as one graph replay: make_sharded_train_step over ``mesh``
    (world size 1) against make_train_step; the differences bit for bit
    (state_diff, each step's metrics), the launches of both against the
    path's, and both steps (to time them)."""
    import torch

    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.parallel import make_sharded_train_step
    from danerf_tpu_torch.train.trainer import make_train_step

    runs = {}
    for mode in ("sharded", "single"):
        model, table, opt, sched, gen, pool = train_state(cfg, ds, device)

        def make(n, bs):
            if mode == "sharded":
                return make_sharded_train_step(model, table, opt, sched, pool, cfg, mesh,
                                               ds.height, ds.width, ds.focal, bs, gen, n)
            return make_train_step(model, table, opt, sched, pool, cfg, ds.height, ds.width,
                                   ds.focal, bs, gen, n)

        warm = make(1, 64)
        for _ in range(5):
            warm()
        step = make(k, None)
        fr.reset_launch_counts()
        out = step()
        torch.cuda.synchronize()
        runs[mode] = {"state": (model, table, opt, sched, gen), "launches": dict(fr.LAUNCHES),
                      "metrics": out, "step": step}
    a, b = runs["sharded"], runs["single"]
    diff = state_diff(a["state"], b["state"])
    diff += [f"metric {n}" for n in b["metrics"]
             if not torch.equal(a["metrics"][n], b["metrics"][n])]
    want = launches_of(per_step, k)
    bad = {m: r["launches"] for m, r in runs.items() if r["launches"] != want}
    n_flat = sum(p.numel() for p in a["state"][0].parameters()) + a["state"][1].numel()
    return {"steps": k, "differences": diff, "launches_wrong": bad,
            "launches": a["launches"], "flat_allreduce_floats": n_flat + len(a["metrics"]),
            "loss_first_last": [float(a["metrics"]["loss"][0]),
                                float(a["metrics"]["loss"][-1])]}, a["step"], b["step"]


def phase_dist_step(cfg, device, mesh, k=10):
    """Data-parallel training on a world-size-1 NCCL group: for the 64 + 64,
    the coarse-only and the per-sample path, 10 chained sharded steps (one
    graph replay, the flat all-reduce captured with them) against 10
    chained make_train_step steps, bit for bit, with exactly the path's
    launches; then on 64 + 64 both steps timed in turns (20 synchronised
    replays each, ms a step) and a torch.profiler window of 3 replays each
    (device busy, idle share): the difference is the all-reduce's cost."""
    import numpy as np
    import torch

    report, failures, steps = {}, [], {}
    for path in ("hier", "coarse", "per_sample"):
        over, per_step = PATHS[path]
        pcfg = cfg.replace(**over)
        report[path], *steps[path] = dp_vs_single(pcfg, timing_scene(pcfg), device, mesh, k,
                                                  per_step)
        if report[path]["differences"] or report[path]["launches_wrong"]:
            failures.append(f"{path}: {report[path]}")
    sharded, single = steps["hier"]
    times = {"sharded": [], "single": []}
    for _ in range(20):
        for mode, step in (("single", single), ("sharded", sharded)):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times[mode].append((time.perf_counter() - t0) * 1e3 / k)
    timing = {}
    for mode, step in (("single", single), ("sharded", sharded)):
        prof = profile_steps(step, n_prof=3)
        timing[mode] = {"ms_per_step_median": float(np.median(times[mode])),
                        "ms_per_step_min": min(times[mode]),
                        "ms_per_step_max": max(times[mode]),
                        "rays_per_s": cfg.batch_size / (float(np.median(times[mode])) / 1e3),
                        "replay_event_ms": cuda_ms(step, 5),
                        "device_busy_ms_per_step": prof["profile_device_busy_ms_per_step"] / k,
                        "idle_share": prof["profile_idle_share"],
                        "top_kernels_ms_per_replay": prof["profile_ms_per_step"][:8]}
    timing["sharded_over_single"] = (timing["sharded"]["ms_per_step_median"]
                                     / timing["single"]["ms_per_step_median"])
    emit({"phase": "dist_step", "world_size": 1, "backend": "nccl", "steps_per_call": k,
          "rays": cfg.batch_size, **report, "timing_64_64": timing, "failures": failures})
    if failures:
        raise AssertionError("sharded steps differ from make_train_step: " + "; ".join(failures))
    return report


def phase_dist_frame(cfg, model, device, mesh, side=800):
    """The sharded frame on a world-size-1 NCCL group: render_frame(mesh=)
    of an 800x800 medium frame (64 + 64, jittered from a seeded generator)
    against render_frame, bit for bit, with exactly 10 K2 and 10 K5
    launches; make_sharded_render on one 65,536-ray chunk against
    render_rays' per-sample route, bit for bit, with exactly 2 K1 launches;
    the ms of each (median of 3 after a warm-up call, in turns)."""
    import numpy as np
    import torch

    from danerf_tpu_torch.config import RENDER_PRESETS
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.parallel.mesh import make_sharded_render
    from danerf_tpu_torch.render.renderer import render_frame, render_rays
    from danerf_tpu_torch.viz.paths import camera_path

    emb = torch.randn(cfg.appearance_dim, generator=torch.Generator().manual_seed(3))
    focal = 0.5 * side / np.tan(0.5 * 0.6911)
    c2w = camera_path("circle", 4, cfg.scene)[1]

    def frame(m):
        gen = torch.Generator(device=device).manual_seed(7)
        return render_frame(model, cfg, c2w, side, side, focal, appearance_embedding=emb,
                            perturb=True, chunk=RENDER_PRESETS["medium"]["chunk"],
                            generator=gen, device=device, mesh=m)

    failures = []
    fr.reset_launch_counts()
    got = frame(mesh)
    torch.cuda.synchronize()
    frame_launches = dict(fr.LAUNCHES)
    want = frame(None)
    frame_equal = all(torch.equal(a, b) for a, b in zip(got, want))
    n_chunks = -(-side * side // RENDER_PRESETS["medium"]["chunk"])
    if frame_launches != launches_of({"march": n_chunks, "merged": n_chunks}):
        failures.append(f"sharded frame launches {frame_launches}")
    if not frame_equal:
        failures.append("sharded frame != render_frame: max "
                        f"{max(max_err(a, b) for a, b in zip(got, want))}")
    frame_ms = {"sharded": [], "single": []}
    for _ in range(3):
        for mode, m in (("single", None), ("sharded", mesh)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame(m)
            torch.cuda.synchronize()
            frame_ms[mode].append((time.perf_counter() - t0) * 1e3)

    n = cfg.render_chunk
    o, d, e, _ = make_rays(n, cfg, seed=31, device=device)
    render = make_sharded_render(cfg, mesh, 256, 256, cfg.num_samples, cfg.num_importance)
    with torch.no_grad():
        fr.reset_launch_counts()
        got_r = render(model, o, d, e)
        torch.cuda.synchronize()
        render_launches = dict(fr.LAUNCHES)

        def plain_route():
            out = render_rays(model, cfg, o, d, e, perturb=False, fused_composite=False)
            return out["rgb"], out["depth"], out["acc"]

        want_r = plain_route()
        render_equal = all(torch.equal(a, b) for a, b in zip(got_r, want_r))
        render_ms = {"sharded": cuda_ms(lambda: render(model, o, d, e), 3),
                     "render_rays": cuda_ms(plain_route, 3)}
    if render_launches != launches_of({"mlp_fwd": 2}):
        failures.append(f"make_sharded_render launches {render_launches}")
    if not render_equal:
        failures.append("make_sharded_render != render_rays: max "
                        f"{max(max_err(a, b) for a, b in zip(got_r, want_r))}")
    report = {"frame": {"side": side, "equal": frame_equal, "launches": frame_launches,
                        "ms_median": {m: float(np.median(v)) for m, v in frame_ms.items()},
                        "ms": frame_ms},
              "sharded_render": {"rays": n, "samples": [cfg.num_samples, cfg.num_importance],
                                 "equal": render_equal, "launches": render_launches,
                                 "ms": render_ms}}
    emit({"phase": "dist_frame", "world_size": 1, "backend": "nccl", **report,
          "failures": failures})
    if failures:
        raise AssertionError("the sharded frame disagrees: " + "; ".join(failures))
    return report


# The two-rank phase's bars (gloo on one card, the same f32 work in other
# sums): the first step's gradients summed over two half batches, per
# parameter by relative Frobenius error (a sum in place of the mean would be
# 0.5); each step's loss relatively; the parameters after 3 Adam steps at
# most 2 lr apart a step (Adam moves an element by at most ~lr, and an
# element whose gradient is near 0 may change sign between the two); the
# frame at the JAX sharded frame's bars (tests/test_parallel.py: rgb and
# acc 1e-5, depth 1e-4): its kernels compute each ray alone on the same
# jitter, but PyTorch's per-ray reductions (the direction's norm, the CDF's
# sums) may take another order for half the rays (measured on the H100:
# 6.2e-6); the tensor-parallel forward (bf16 inputs rounded at the same
# places, the row-parallel partial sums in another order) at PLAIN_TOL's
# field limits.
TWO_RANK_TOL = {"grad_rel": 1e-3, "loss_rel": 1e-4, "frame_rgb_acc": 1e-5, "frame_depth": 1e-4}


def two_rank_inputs(cfg, device):
    """What both ranks and the single-process reference start from: the
    training state, the frame's model, camera and embedding, the points of
    the tensor-parallel forward."""
    import numpy as np
    import torch

    from danerf_tpu_torch.viz.paths import camera_path

    ds = timing_scene(cfg)
    g = torch.Generator(device=device).manual_seed(41)
    x = torch.randn(4096, 3, generator=g, device=device)
    d = torch.randn(4096, 3, generator=g, device=device)
    d = d / d.norm(dim=-1, keepdim=True)
    emb = torch.randn(4096, cfg.appearance_dim, generator=g, device=device)
    return {"ds": ds, "state": train_state(cfg, ds, device), "c2w": camera_path("circle", 4,
                                                                                cfg.scene)[1],
            "focal": 0.5 * 200 / np.tan(0.5 * 0.6911), "points": (x, d, emb),
            "frame_emb": torch.randn(cfg.appearance_dim,
                                     generator=torch.Generator().manual_seed(3))}


def two_rank_work(cfg, device, mesh=None, tp_mesh=None):
    """3 eager 64 + 64 steps at B = 1024 (sharded over ``mesh`` when given),
    a 200x200 medium frame, and the module-route forward (tensor-parallel
    over ``tp_mesh`` when given): losses, the first step's gradients, the
    parameters after, the frame, rgb/sigma and the wall ms of the steps."""
    import torch

    from danerf_tpu_torch.parallel import make_sharded_train_step
    from danerf_tpu_torch.parallel.mesh import TPNeRF
    from danerf_tpu_torch.render.renderer import render_frame
    from danerf_tpu_torch.train.trainer import make_train_step

    inp = two_rank_inputs(cfg, device)
    ds = inp["ds"]
    model, table, opt, sched, gen, pool = inp["state"]
    if mesh is None:
        step = make_train_step(model, table, opt, sched, pool, cfg, ds.height, ds.width,
                               ds.focal, None, gen, 1)
    else:
        step = make_sharded_train_step(model, table, opt, sched, pool, cfg, mesh, ds.height,
                                       ds.width, ds.focal, None, gen, 1)
    params = list(model.parameters()) + [table]
    losses, grads = [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3):
        losses.append(float(step()["loss"][0]))
        if i == 0:
            grads = [p.grad.detach().clone() for p in params]
    steps_ms = (time.perf_counter() - t0) * 1e3 / 3
    fmodel = make_model(cfg, seed=0, device=device)
    gen_f = torch.Generator(device=device).manual_seed(7)
    frame = render_frame(fmodel, cfg, inp["c2w"], 200, 200, inp["focal"],
                         appearance_embedding=inp["frame_emb"], perturb=True, chunk=65536,
                         generator=gen_f, device=device, mesh=mesh)
    mcfg = cfg.replace(use_kernels=False)
    net = make_model(mcfg, seed=0, device=device)
    if tp_mesh is not None:
        net = TPNeRF(net, tp_mesh)
    with torch.no_grad():
        rgb, sigma = net(*inp["points"])
    return {"losses": losses, "grads": [g.cpu() for g in grads],
            "params": [p.detach().cpu() for p in params],
            "frame": [f.cpu() for f in frame], "rgb": rgb.cpu(), "sigma": sigma.cpu(),
            "steps_ms": steps_ms}


def card_timing(cfg, device, mesh, world, side=800):
    """The chained 64 + 64 step (10 steps a replay; over ``mesh`` when
    given, else one process) at a global batch of B = 1024 and of world x
    1024 (each rank's block 1024 rays): the median, min and max ms a step
    of 20 synchronised replays after the capture, and rays/s; and the
    800x800 medium frame (median of 3 after a warm-up call)."""
    import numpy as np
    import torch

    from danerf_tpu_torch.parallel import make_sharded_train_step
    from danerf_tpu_torch.render.renderer import render_frame
    from danerf_tpu_torch.train.trainer import make_train_step

    out = {}
    ds = timing_scene(cfg)
    for b in (cfg.batch_size, world * cfg.batch_size):
        model, table, opt, sched, gen, pool = train_state(cfg, ds, device)
        if mesh is None:
            step = make_train_step(model, table, opt, sched, pool, cfg, ds.height, ds.width,
                                   ds.focal, b, gen, 10)
        else:
            step = make_sharded_train_step(model, table, opt, sched, pool, cfg, mesh, ds.height,
                                           ds.width, ds.focal, b, gen, 10)
        step()
        torch.cuda.synchronize()
        reps = []
        for _ in range(20):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t0) * 1e3 / 10)
        ms = float(np.median(reps))
        out[f"step_B{b}"] = {"ms_per_step_median": ms, "ms_per_step_min": min(reps),
                             "ms_per_step_max": max(reps), "rays_per_s": b / (ms / 1e3)}
    inp = two_rank_inputs(cfg, device)
    fmodel = make_model(cfg, seed=0, device=device)
    focal = 0.5 * side / np.tan(0.5 * 0.6911)
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_frame(fmodel, cfg, inp["c2w"], side, side, focal,
                     appearance_embedding=inp["frame_emb"], perturb=True, chunk=65536,
                     generator=torch.Generator(device=device).manual_seed(7), device=device,
                     mesh=mesh)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out[f"frame_{side}_medium_ms"] = float(np.median(times[1:]))
    return out


def tp_chained_vs_eager(cfg, device, tp_mesh, k=10):
    """The tensor-parallel step on the kernel route (the trunk gathered
    each step, NCCL in the captured graph): one call of ``k`` steps as a
    graph replay against ``k`` eager steps from one seeded state, bit for
    bit on this rank's shards (state_diff) and metrics, with the 64 + 64
    launches; returns this rank's differences."""
    import torch

    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.parallel import make_sharded_train_step, shard_train_state

    ds = timing_scene(cfg)
    runs = {}
    for per_call, calls in ((k, 1), (1, k)):
        model, table, opt, sched, gen, pool = train_state(cfg, ds, device)
        model, table, opt, sched = shard_train_state(model, table, opt, sched, gen, tp_mesh,
                                                     tensor_parallel=True)
        step = make_sharded_train_step(model, table, opt, sched, pool, cfg, tp_mesh, ds.height,
                                       ds.width, ds.focal, None, gen, per_call)
        fr.reset_launch_counts()
        out = [step() for _ in range(calls)]
        torch.cuda.synchronize()
        runs[per_call] = ((model, table, opt, sched, gen), dict(fr.LAUNCHES),
                          {n: torch.cat([m[n] for m in out]) for n in out[0]})
    (sa, la, ma), (sb, lb, mb) = runs[k], runs[1]
    diff = state_diff(sa, sb) + [f"metric {n}" for n in mb if not torch.equal(ma[n], mb[n])]
    want = launches_of(PATHS["hier"][1], k)
    if la != want or lb != want:
        diff.append(f"launches {la} {lb}")
    return diff


def dist_child(rank: int, world: int, port: int, out_dir: str, backend: str) -> int:
    """One rank of phase_dist_ranks: on gloo every rank shares the one
    card, on NCCL each takes its own (rank % cards)."""
    import torch
    import torch.distributed as dist

    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.parallel import initialize_distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert initialize_distributed(f"127.0.0.1:{port}", world, rank, backend=backend)
    device = torch.device("cuda")
    cfg = NeRFConfig(density_bias_init=0.5)
    mesh = make_mesh(data=world, model=1)
    tp_mesh = make_mesh(data=world // 2, model=2)
    got = two_rank_work(cfg, device, mesh=mesh, tp_mesh=tp_mesh)
    if backend == "nccl":
        got["timing"] = card_timing(cfg, device, mesh, world)
        n_diff = torch.tensor([len(tp_chained_vs_eager(cfg, device, tp_mesh))], device=device)
        dist.all_reduce(n_diff)
        got["tp_chained_differences_all_ranks"] = int(n_diff)
    if rank == 0:
        torch.save(got, os.path.join(out_dir, f"ranks_{world}.pt"))
    dist.destroy_process_group()
    return 0


def phase_dist_ranks(cfg, device, out_dir, world=2, backend="gloo"):
    """``world`` processes of this script, one rank each: on gloo all on
    the one card (NCCL refuses two ranks on one card; phase dist_two_ranks),
    on NCCL one card each (phase dist_cards, ``--cards``).  Each rank runs 3
    eager sharded 64 + 64 steps at a global B = 1024, a 200x200 sharded
    frame and the --mesh_model 2 module-route forward, held against the
    same work in this process without a mesh within TWO_RANK_TOL; on NCCL
    also the chained step's and the 800x800 frame's times (against this
    process's on one card, timed after the ranks exit) and the
    tensor-parallel kernel-route step chained against eager, bit for bit.
    A failure in any rank fails the phase.  Gloo times are no speed figure
    (the ranks share one card and gloo copies through the host)."""
    import torch

    from danerf_tpu_torch.kernels import fused_render as fr

    child_dir = os.path.join(out_dir, f"ranks_{backend}_{world}")
    os.makedirs(child_dir, exist_ok=True)
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist-child",
                               str(r), str(world), str(port), child_dir, backend],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    children_s = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"dist ranks: rank {r} exited {p.returncode}:\n{log[-4000:]}")
    got = torch.load(os.path.join(child_dir, f"ranks_{world}.pt"), weights_only=False)
    want = two_rank_work(cfg, device)
    names = [n for n, _ in make_model(cfg, 0, "cpu").named_parameters()] + ["appearance"]
    grad_rel = {n: float((a - b).norm() / b.norm()) for n, a, b in
                zip(names, got["grads"], want["grads"]) if float(b.norm()) > 0}
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    param_abs = max(max_err(a, b) for a, b in zip(got["params"], want["params"]))
    frame_err = [max_err(a, b) for a, b in zip(got["frame"], want["frame"])]
    rgb_err = max_err(got["rgb"], want["rgb"])
    sigma_err = float(((got["sigma"] - want["sigma"]).abs()
                       / want["sigma"].abs().clamp_min(1.0)).max())
    tol = fr.PLAIN_TOL
    checks = {"grad_rel_worst": (max(grad_rel.values()), TWO_RANK_TOL["grad_rel"]),
              "loss_rel": (loss_rel, TWO_RANK_TOL["loss_rel"]),
              "param_max_abs": (param_abs, 3 * 2 * cfg.learning_rate * (1 + 1e-3)),
              "frame_rgb_max_abs": (frame_err[0], TWO_RANK_TOL["frame_rgb_acc"]),
              "frame_depth_max_abs": (frame_err[1], TWO_RANK_TOL["frame_depth"]),
              "frame_acc_max_abs": (frame_err[2], TWO_RANK_TOL["frame_rgb_acc"]),
              "tp_rgb_max_abs": (rgb_err, tol["field_rgb"]),
              "tp_sigma_rel": (sigma_err, tol["field_sigma"])}
    failures = [f"{k}: {v} > {lim}" for k, (v, lim) in checks.items()
                if not (math.isfinite(v) and v <= lim)]
    report = {"phase": "dist_two_ranks" if backend == "gloo" else "dist_cards",
              "world_size": world, "backend": backend,
              "cards": 1 if backend == "gloo" else world,
              "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()},
              "grad_rel_worst_param": max(grad_rel, key=grad_rel.get),
              "losses": {"ranks": got["losses"], "one_process": want["losses"]},
              "steps_ms_each_ranks": got["steps_ms"],
              "steps_ms_each_one_process": want["steps_ms"],
              "children_s_incl_start": children_s}
    if backend == "nccl":
        report["tp_chained_differences_all_ranks"] = got["tp_chained_differences_all_ranks"]
        if got["tp_chained_differences_all_ranks"]:
            failures.append("tensor-parallel chained steps differ from eager steps")
        report["timing_ranks"] = got["timing"]
        report["timing_one_card"] = card_timing(cfg, device, None, world)
    report["failures"] = failures
    emit(report)
    if failures:
        raise AssertionError("the ranks disagree with one process: " + "; ".join(failures))
    return checks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  "build", "chip_smoke"),
                    help="directory for the build log, checkpoint and frames")
    ap.add_argument("--cards", type=int, default=1,
                    help="with N > 1: only the data-parallel phase over N cards on NCCL")
    # one rank of phase_dist_ranks (the script starts the ranks)
    ap.add_argument("--dist-child", nargs=5, metavar=("RANK", "WORLD", "PORT", "DIR", "BACKEND"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU", file=sys.stderr)
        return 2
    import danerf_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    if args.dist_child:
        rank, world, port, out, backend = args.dist_child
        return dist_child(int(rank), int(world), int(port), out, backend)

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
    if args.cards > 1:
        if torch.cuda.device_count() < args.cards:
            raise AssertionError(f"--cards {args.cards}: {torch.cuda.device_count()} cards")
        phase_dist_ranks(cfg, device, args.out, args.cards, "nccl")
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
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
    phase_chained(cfg, device, args.out)
    train_launches = {"hier": phase_train(args.out, "hier", 200, render=True, every=100,
                                          resume_to=250),
                      "coarse": phase_train(args.out, "coarse", 100, render=False),
                      "white": phase_train(args.out, "white", 100, render=False),
                      "per_sample": phase_train(args.out, "per_sample", 100, render=False),
                      "time": phase_train(args.out, "time", 100, render=True),
                      "hier_onepass": phase_train(args.out, "hier_onepass", 100, render=False)}
    # evaluation on those checkpoints (K2, K5 a frame chunk; the fit's K2, K5,
    # K6, K3 a step), before any torch.profiler window
    eval_counts = phase_eval(args.out)
    phase_loaders(args.out)
    # the depth-aware effects and the renders that feed them, timed before
    # any torch.profiler window (phase_train_timing's): timed after one, the
    # effects' eager launches have run up to 2.3x slower on the H100
    phase_fx(device)
    phase_serve_fx(cfg, args.out, device)
    phase_spiral_fx(cfg, args.out, device)
    phase_serve_timing(cfg, model, args.out, device)
    phase_eval_timing(cfg, model, device)
    timing, bound_by = phase_timing(cfg, model, device, chunk)
    tt, tt_bound_by = phase_train_timing(cfg, model, device, chunk)
    timing_t, bound_by_t = phase_timing(cfg_t, model_t, device, chunk_t, frame_t=0.5)
    tt_t, tt_bound_by_t = phase_train_timing(cfg_t, model_t, device, chunk_t)
    # data parallelism (parallel/mesh.py): 64 + 64 through `cli.main train
    # --coordinator_address auto --mesh_data 0` as torchrun runs one rank
    # (its NCCL group of one; one K2, K4, K3 a step and one K2, K5 for the
    # validation render), then on a world-size-1 NCCL group of this process
    # the sharded steps and frames against the unsharded ones, then two
    # ranks on gloo
    with torchrun_env():
        train_launches["hier_dp"] = phase_train(args.out, "hier_dp", 100, render=False,
                                                every=100)
    import torch.distributed as dist

    from danerf_tpu_torch.parallel import make_mesh

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    mesh = make_mesh()
    phase_dist_step(cfg, device, mesh)
    dist_frame = phase_dist_frame(cfg, model, device, mesh)
    dist.destroy_process_group()
    phase_dist_ranks(cfg, device, args.out)

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
    # the eval phase's launches (all its kernel-route runs) of the four
    # kernels the test-time fit and the frame run
    for rec in kernels:
        counter = {"K2": "march", "K5": "merged", "K3": "march_bwd",
                   "K6": "merged_bwd"}.get(rec["name"][:2])
        if counter:
            rec["eval_launches"] = eval_counts[counter]
    # data parallelism: the launches of the data-parallel training run (K2,
    # K4, K3), of a sharded 800x800 frame on the one rank (K2, K5) and of
    # make_sharded_render's 65,536-ray chunk (K1)
    for rec in kernels:
        key = rec["name"][:2]
        counter = {"K2": "march", "K4": "merged_train", "K3": "march_bwd"}.get(key)
        if counter:
            rec["dp_train_launches"] = train_launches["hier_dp"][counter]
        if key in ("K2", "K5"):
            rec["sharded_frame_launches_per_rank"] = dist_frame["frame"]["launches"][
                "march" if key == "K2" else "merged"]
        if key == "K1":
            rec["sharded_render_launches_per_chunk"] = dist_frame["sharded_render"][
                "launches"]["mlp_fwd"]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
