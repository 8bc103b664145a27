"""The multi-seed PSNR-parity study (counterpart of examples/parity_study.py;
the bar: "PSNR within 0.1 dB of the reference implementation trained under
the same config").

On the card the reference arm is the reference trainer itself
(``danerf_tpu_torch/benchmarks/torch_reference.py``: plain PyTorch, f32,
TF32 off), not a mirror of it: the JAX study ran a JAX mirror because torch
on its host's CPU took ~8 h a seed.  Each reference seed starts from the
init the repository's ``benchmarks/torch_reference.py`` draws for it and
consumes the same numpy stream.

  Arm "reference"       the reference trainer, coarse (64), f32; evaluated
                        by converting its weights into the port's model
                        (``benchmarks/reference_init.py``) and rendering
                        through ``evaluate`` with use_kernels=False in f32.
  Arm "framework"       the port's trainer, bf16 on the kernels, coarse-only
                        (K7 a step; K2 a frame chunk in eval).
  Arm "framework_f32"   the same in f32 (the f32 K7, K2).
  Arm "reference_hier"  the reference trainer with the declared fine pass
                        (64 + 64, mse(fine) + mse(coarse)).
  Arm "framework_hier"  the port's trainer at the default 64 + 64 config
                        (K2, K4, K3 a step; K2 + K5 a chunk in eval).
  Arm "framework_paired[_hier]"
                        the port's trainer from the SAME torch init as the
                        reference arm's seed: per-seed differencing removes
                        init variance.  ``init_model`` draws that init bit
                        for bit (tests/test_torch_parity_study.py), so these
                        arms ARE the "framework[_hier]" runs (``SAME_AS``:
                        one cache, trained once) and the JAX report's
                        attribution_init_family is 0 by construction.
  Arm "framework_paired_hier_f32p" / "_xla32"
                        attribution cells: the paired-hier arm in f32 on the
                        kernels, and in f32 with use_kernels=False (the
                        module's forward and autograd, TF32 off: the
                        counterpart of the JAX use_pallas=False path, taken
                        as a configuration, no kernel launched).

The framework arms train as the JAX script's trainer loop does: the
warm-up steps at ``warmup_batch_size``, then 10 steps a call
(``make_train_step``: one CUDA-graph replay a call on the card).

Born-dead seeds are handled symmetrically: every run's init is probed with
the same fixed probe set (``density_alive_probe``); dead seeds are recorded,
excluded and replaced by the next seed on every arm.

Each run is cached as ``<runs_dir>/<arm>_seed<k>.json`` (under the
gitignored ``build/``), so the study resumes across calls; ``--arms`` runs
some arms.  The report holds every key of the JAX report
(``examples/parity_report.json``), ``"backend": "cuda"``, the card's name
and power limit (``device``), each arm's config, seconds a seed and kernel
launches.  The committed CPU anchor (``examples/parity_runs/
torch_anchor_seed0.json``, the repository script on the CPU from seed 0's
init and stream) is paired with this study's reference seed 0 under
``mirror_pairing``; ``dead_rates.json`` and ``equivalence*.json`` in
``runs_dir`` (``benchmarks/dead_rate_probe.py``,
``benchmarks/parity_equivalence.py``) are merged in.

    python -m danerf_tpu_torch.examples.parity_study --iters 5000 --seeds 4 [--arms ...]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from danerf_tpu_torch import resolve_device
from danerf_tpu_torch.examples import device_block, launches, launches_since, sync

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SCENE = os.path.join(ROOT, "examples", "procedural_scene")
RUNS_DIR = os.path.join("build", "parity_runs_torch")   # gitignored
REPORT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "parity_report_h100.json")
# the JAX study's committed runs: read (its CPU anchor), never written
COMMITTED_RUNS = os.path.join(ROOT, "examples", "parity_runs")
ARMS = ("reference", "framework", "framework_f32", "reference_hier", "framework_hier",
        "framework_paired", "framework_paired_hier", "framework_paired_hier_f32p",
        "framework_paired_hier_xla32")
# arms whose runs are another arm's: init_model draws the torch init
SAME_AS = {"framework_paired": "framework", "framework_paired_hier": "framework_hier"}
STEPS_PER_CALL = 10
EXTRAS = ("dead_rates", "equivalence", "equivalence_600", "equivalence_hier",
          "equivalence_hier_600")


def _rel(path: str) -> str:
    """``path`` relative to the repository when it lies inside it."""
    path = os.path.abspath(path)
    return os.path.relpath(path, ROOT) if path.startswith(ROOT + os.sep) else path


def _eval(model, table, cfg, val_ds, dev) -> dict:
    """``evaluate`` with the mean trained embedding, and its launches."""
    from danerf_tpu_torch.train.evaluate import evaluate

    emb = table.detach().mean(0, keepdim=True) if table is not None else None
    before = launches()
    ev = evaluate(model, cfg, val_ds, appearance=emb, n_importance=cfg.num_importance,
                  device=dev)
    ev["launches"] = launches_since(before)
    return ev


def _dead(seed: int, probe: float) -> dict:
    return {"seed": seed, "dead_at_init": True, "probe_max_sigma": probe}


def framework_run(cfg, train_ds, val_ds, iters, seed, device="cuda"):
    """One run of the port's trainer + eval; returns the result dict.

    The run starts from ``init_model``'s init, which is the torch init the
    reference arm uses for this seed, with a fresh Adam: the seeds pair
    across arms, and the alive/dead probe agrees with the reference arm's."""
    from danerf_tpu_torch.benchmarks.reference_init import density_alive_probe
    from danerf_tpu_torch.train.trainer import init_model, make_optimizer, make_train_step

    dev = resolve_device(device)
    model, table = init_model(cfg, train_ds.n_images, seed, dev)
    probe = density_alive_probe(model, cfg, train_ds.images.shape, train_ds.c2ws,
                                train_ds.focal)
    if probe <= 0.0:
        return _dead(seed, probe)

    params = list(model.parameters()) + ([table] if table is not None else [])
    opt, sched = make_optimizer(cfg, params)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pool = train_ds.device_arrays(cfg.white_background, dev)
    h, w, focal = train_ds.height, train_ds.width, train_ds.focal
    step = make_train_step(model, table, opt, sched, pool, cfg, h, w, focal, None, gen,
                           STEPS_PER_CALL)
    warm = make_train_step(model, table, opt, sched, pool, cfg, h, w, focal,
                           cfg.warmup_batch_size, gen, 1)
    before = launches()
    t0 = time.time()
    metrics = None
    for _ in range(cfg.warmup_iters):
        metrics = warm()
    i = cfg.warmup_iters
    while i < iters:
        metrics = step()
        i += STEPS_PER_CALL
    sync(dev)
    train_s = time.time() - t0
    train_launches = launches_since(before)
    ev = _eval(model, table, cfg, val_ds, dev)
    return {"seed": seed, "dead_at_init": False, "probe_max_sigma": probe,
            "val_psnr": ev["psnr"], "val_ssim": ev["ssim"], "per_view": ev["per_view"],
            "train_seconds": train_s, "steps": i,
            "final_train_psnr": float(metrics["psnr"][-1]),
            "launches": {"train": train_launches, "eval": ev["launches"]}}


def reference_run(cfg, train_ds, val_ds, iters, seed, device="cuda"):
    """One reference-trainer run (torch init + reference semantics) + eval
    through the port's ``evaluate`` (use_kernels=False, f32)."""
    from danerf_tpu_torch.benchmarks.reference_init import (density_alive_probe,
                                                            model_from_reference,
                                                            sample_torch_init)
    from danerf_tpu_torch.benchmarks.torch_reference import export_init, train_reference

    dev = resolve_device(device)
    model0, _ = model_from_reference(sample_torch_init(cfg, train_ds.n_images, seed), cfg, dev)
    probe = density_alive_probe(model0, cfg, train_ds.images.shape, train_ds.c2ws,
                                train_ds.focal)
    if probe <= 0.0:
        return _dead(seed, probe)

    imgs = train_ds.images.astype(np.float32) / 255.0
    before = launches()
    t0 = time.time()
    model, emb, mses = train_reference(cfg, imgs, train_ds.c2ws, train_ds.focal, iters,
                                       seed=seed, log_every=10 ** 9, device=dev)
    sync(dev)
    train_s = time.time() - t0
    train_launches = launches_since(before)
    trained, table = model_from_reference(export_init(model, emb), cfg, dev)
    ev = _eval(trained, table, cfg, val_ds, dev)
    return {"seed": seed, "dead_at_init": False, "probe_max_sigma": probe,
            "val_psnr": ev["psnr"], "val_ssim": ev["ssim"], "per_view": ev["per_view"],
            "train_seconds": train_s, "steps": iters,
            "final_train_psnr": float(-10 * np.log10(np.mean(mses[-100:]))),
            # per-100-step mean-MSE trace: comparable with an anchor's
            # mse_trace_every100 (same init + same numpy stream)
            "mse_trace_every100": [float(np.mean(mses[j:j + 100]))
                                   for j in range(0, len(mses), 100)],
            "launches": {"train": train_launches, "eval": ev["launches"]}}


def collect_arm(name, run_fn, cfg, train_ds, val_ds, iters, n_seeds, runs_dir,
                start_seed=0, max_probe=None):
    """Run (or load cached) seeds until n_seeds alive ones exist; dead seeds
    are recorded and replaced by the next integer (symmetric rule)."""
    os.makedirs(runs_dir, exist_ok=True)
    if max_probe is None:
        # the dead rate on the parity scene is ~45% (dead_rates.json), so
        # probing 3x the target leaves headroom at any study scale
        max_probe = max(24, 3 * n_seeds)
    alive, dead = [], []
    seed = start_seed
    while len(alive) < n_seeds and seed < start_seed + max_probe:
        path = os.path.join(runs_dir, f"{name}_seed{seed}.json")
        res = None
        if os.path.isfile(path):
            with open(path) as f:
                res = json.load(f)
            if res.get("iters") != iters:
                res = None  # stale cache from a different study scale
        if res is None:
            print(f"[{name}] seed {seed} ...", flush=True)
            res = run_fn(cfg, train_ds, val_ds, iters, seed)
            res["iters"] = iters
            with open(path, "w") as f:
                json.dump(res, f, indent=2)
        if res.get("dead_at_init"):
            print(f"[{name}] seed {seed}: DEAD at init (excluded)", flush=True)
            dead.append(seed)
        else:
            print(f"[{name}] seed {seed}: psnr {res['val_psnr']:.3f} "
                  f"({res.get('train_seconds', 0):.1f}s)", flush=True)
            alive.append(res)
        seed += 1
    return alive, dead


def _t975(df: float) -> float:
    from scipy import stats

    return float(stats.t.ppf(0.975, df))


def welch(a, b):
    """Welch's t CI95 + t statistic for mean(a) - mean(b)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    na, nb = len(a), len(b)
    delta = float(a.mean() - b.mean())
    if na < 2 or nb < 2:
        return {"delta": delta, "ci95": None, "t": None, "df": None,
                "note": "needs >=2 seeds per arm"}
    va, vb = a.var(ddof=1) / na, b.var(ddof=1) / nb
    se = math.sqrt(va + vb)
    if se == 0:
        return {"delta": delta, "ci95": [delta, delta], "t": 0.0, "df": 0.0}
    df = (va + vb) ** 2 / (va ** 2 / max(na - 1, 1) + vb ** 2 / max(nb - 1, 1))
    tq = _t975(df)
    return {"delta": delta, "ci95": [delta - tq * se, delta + tq * se],
            "t": delta / se, "df": float(df)}


def arm_stats(runs):
    p = [r["val_psnr"] for r in runs]
    return {"n": len(p), "psnr_mean": float(np.mean(p)),
            "psnr_std": float(np.std(p, ddof=1)) if len(p) > 1 else 0.0,
            "psnr_values": p,
            "ssim_mean": float(np.mean([r["val_ssim"] for r in runs]))}


def paired_delta(runs_a, runs_b):
    """Per-seed differencing over the seeds common to both arms (which share
    each seed's init, so init variance cancels): a one-sample t CI on the
    per-seed PSNR deltas, with robust companions; None under two common
    seeds."""
    from scipy import stats

    by_seed_a = {r["seed"]: r["val_psnr"] for r in runs_a}
    by_seed_b = {r["seed"]: r["val_psnr"] for r in runs_b}
    common = sorted(set(by_seed_a) & set(by_seed_b))
    if len(common) < 2:
        return None
    d = np.asarray([by_seed_a[s] - by_seed_b[s] for s in common])
    se = float(d.std(ddof=1) / math.sqrt(len(d)))
    tq = _t975(len(d) - 1)
    out = {
        "design": "paired (same torch init per seed in both arms)",
        "seeds": common,
        "per_seed_delta": d.tolist(),
        "delta": float(d.mean()),
        "ci95": [float(d.mean() - tq * se), float(d.mean() + tq * se)],
        "ci95_half_width": float(tq * se),
        "t": float(d.mean() / se) if se > 0 else None,
        # heavy-tailed per-seed deltas (trajectories from one init can reach
        # different optima): robust companions beside the t CI
        "median": float(np.median(d)),
        "per_seed_delta_std": float(d.std(ddof=1)),
    }
    try:
        out["wilcoxon_p"] = float(stats.wilcoxon(d).pvalue)
    except ValueError:   # every delta zero
        pass
    return out


ABL_KEYS = ("attribution_init_family", "attribution_bf16", "attribution_kernel_path",
            "attribution_sampling_trainer_residual")


def statistics(results: dict) -> dict:
    """The deltas and the attribution of ``delta_hier`` from the alive runs
    of each arm ({arm: [run, ...]}), under the JAX report's keys."""
    out = {}

    def psnrs(arm):
        return [r["val_psnr"] for r in results[arm]]

    def delta(a, b, key):
        if results.get(a) and results.get(b):
            out[key] = welch(psnrs(a), psnrs(b))
            ci = out[key]["ci95"]
            out[key]["within_ci"] = (ci[0] <= 0.0 <= ci[1]) if ci else None

    def paired(a, b, key):
        if results.get(a) and results.get(b):
            d = paired_delta(results[a], results[b])
            if d is not None:
                out[key] = d

    delta("framework", "reference", "delta_framework_minus_reference")
    delta("framework_f32", "reference", "delta_f32_minus_reference")
    delta("framework_hier", "reference_hier", "delta_hier")
    paired("framework_paired", "reference", "delta_paired_coarse")
    paired("framework_paired_hier", "reference_hier", "delta_paired_hier")
    # delta_hier decomposes into arm-mean differences along the ablation
    # chain: init family + bf16 + kernel path + sampling/trainer residual
    paired("framework_paired_hier", "framework_paired_hier_f32p", "attribution_bf16")
    paired("framework_paired_hier_f32p", "framework_paired_hier_xla32",
           "attribution_kernel_path")
    paired("framework_paired_hier_xla32", "reference_hier",
           "attribution_sampling_trainer_residual")
    if results.get("framework_hier") and results.get("framework_paired_hier"):
        out["attribution_init_family"] = welch(psnrs("framework_hier"),
                                               psnrs("framework_paired_hier"))
        out["attribution_init_family"]["design"] = (
            "unpaired in the JAX study, whose framework init family was its own; "
            "init_model draws the torch init, so both arms are one set of runs and "
            "this term is 0 by construction")
    if all(k in out for k in ABL_KEYS):
        out["attribution"] = {
            "question": "what produces delta_hier (framework defaults minus reference "
                        "semantics, unpaired)?",
            "factors_identical_by_construction": {
                "batch_sampling": "single-image-per-step on BOTH sides "
                                  "(sample_ray_batch single_image=True; reference "
                                  "src/dataset.py:250)",
                "hier_loss": "mse(fine) + 1.0*mse(coarse) on BOTH sides (trainer "
                             "loss_fn; torch_reference.train_reference)",
            },
            "per_factor_delta_db": {k.replace("attribution_", ""): out[k]["delta"]
                                    for k in ABL_KEYS},
            "per_factor_ci95": {k.replace("attribution_", ""): out[k].get("ci95")
                                for k in ABL_KEYS},
            "factor_sum_db": float(sum(out[k]["delta"] for k in ABL_KEYS)),
            "delta_hier_db": out.get("delta_hier", {}).get("delta"),
            "note": "factor_sum equals delta_hier exactly only when every arm is "
                    "evaluated on its own full alive-seed set; with shared seed subsets "
                    "the paired terms are unbiased estimates of the same chain",
        }
    return out


def _anchors(runs_dir: str, anchors_dir: str) -> list:
    """The torch anchors (``torch_anchor_*.json``) of the JAX study's runs
    and of this study's, each paired with this study's reference run of the
    same seed (same init and numpy stream) under ``mirror_pairing``."""
    anchors = []
    for d in dict.fromkeys((anchors_dir, runs_dir)):
        if not (d and os.path.isdir(d)):
            continue
        for fn in sorted(os.listdir(d)):
            if fn.startswith("torch_anchor_") and fn.endswith(".json"):
                with open(os.path.join(d, fn)) as f:
                    anchors.append({"file": _rel(os.path.join(d, fn)), **json.load(f)})
    for a in anchors:
        path = os.path.join(runs_dir, ("reference_hier" if a.get("hier") else "reference")
                            + f"_seed{a.get('seed', 0)}.json")
        tr_a = a.get("mse_trace_every100")
        if not (tr_a and os.path.isfile(path)):
            continue
        with open(path) as f:
            m = json.load(f)
        tr_m = m.get("mse_trace_every100")
        if not tr_m:
            continue
        k = min(len(tr_a), len(tr_m))
        la = np.log(np.maximum(np.asarray(tr_a[:k]), 1e-12))
        lm = np.log(np.maximum(np.asarray(tr_m[:k]), 1e-12))
        a["mirror_pairing"] = {
            "mirror_file": os.path.basename(path),
            "n_trace_points": k,
            "log_mse_correlation": float(np.corrcoef(la, lm)[0, 1]),
            "train_psnr_tail_delta_mirror_minus_torch": (
                float(m.get("final_train_psnr", np.nan) - a.get("train_psnr_tail", np.nan))),
            "note": "'mirror' is this study's reference arm: the reference trainer on "
                    "this device from the anchor's init and numpy stream",
        }
    return anchors


def configs(base) -> dict:
    """Each arm's config, from ``base`` (the scene's near/far set)."""
    ref = base.replace(num_importance=0, use_bf16=False, use_kernels=False)
    fw = base.replace(num_importance=0, use_bf16=True, use_kernels=True)
    return {
        "reference": ref,
        "framework": fw,
        "framework_f32": fw.replace(use_bf16=False),
        "reference_hier": base.replace(use_bf16=False, use_kernels=False),   # 64+64
        "framework_hier": base.replace(use_bf16=True, use_kernels=True),     # 64+64
        "framework_paired": fw,
        "framework_paired_hier": base.replace(use_bf16=True, use_kernels=True),
        "framework_paired_hier_f32p": base.replace(use_bf16=False, use_kernels=True),
        "framework_paired_hier_xla32": base.replace(use_bf16=False, use_kernels=False),
    }


def run(arms=ARMS, iters: int = 5000, seeds: int = 4, hier_seeds: int = 3, f32_seeds: int = 2,
        abl_seeds: int = 12, scene: str = SCENE, out: str = REPORT, runs_dir: str = RUNS_DIR,
        device="cuda", base=None, anchors_dir: str = COMMITTED_RUNS) -> dict:
    """The study over ``arms`` at ``iters`` steps a run, from ``base`` (the
    default ``NeRFConfig``; a test passes a narrow one) on the Blender scene
    ``scene``; caches runs in ``runs_dir``, writes the report to ``out``
    and returns it."""
    import functools

    from danerf_tpu_torch.benchmarks.torch_reference import check_f32_highest
    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.data.blender import load_blender_scene

    dev = resolve_device(device)
    check_f32_highest(dev)
    card = device_block(dev)
    train_ds = load_blender_scene(scene, "train")
    val_ds = load_blender_scene(scene, "val")
    base = (base or NeRFConfig()).replace(near=train_ds.near, far=train_ds.far)
    cfgs = configs(base)
    fw = functools.partial(framework_run, device=dev)
    ref = functools.partial(reference_run, device=dev)
    plan = {"reference": (ref, seeds), "framework": (fw, seeds),
            "framework_f32": (fw, f32_seeds), "reference_hier": (ref, hier_seeds),
            "framework_hier": (fw, hier_seeds), "framework_paired": (fw, seeds),
            "framework_paired_hier": (fw, hier_seeds),
            "framework_paired_hier_f32p": (fw, abl_seeds),
            "framework_paired_hier_xla32": (fw, abl_seeds)}

    results, dead_log = {}, {}
    for arm in arms:
        fn, n = plan[arm]
        src = SAME_AS.get(arm, arm)   # a SAME_AS arm reads (or fills) its source's cache
        results[arm], dead_log[arm] = collect_arm(src, fn, cfgs[src], train_ds, val_ds, iters,
                                                  n, runs_dir)

    report = {
        "experiment": "multi-seed PSNR parity, reference semantics vs the port's trainer "
                      "(BASELINE.json bar)",
        "data": {"source": _rel(scene), "kind": "procedural-roundtrip",
                 "resolution": [train_ds.height, train_ds.width],
                 "train_views": train_ds.n_images, "val_views": val_ds.n_images},
        "iters": iters,
        "backend": dev.type,
        "device": card,
        "reference_arm_note": (
            "the reference arm is the reference trainer itself "
            "(danerf_tpu_torch/benchmarks/torch_reference.py) on this device in f32 with "
            "TF32 off, from the torch init of each seed and the shared numpy stream; its "
            "drift against the same trainer on the CPU is benchmarks/parity_equivalence.py"),
        "dead_seed_rule": "same fixed probe every arm; dead -> excluded + replaced by next "
                          "seed (density_alive_probe)",
        "dead_seeds": dead_log,
        "arms": {arm: arm_stats(runs) for arm, runs in results.items() if runs},
        "runs": results,
        "configs": {arm: {"samples": [cfgs[arm].num_samples, cfgs[arm].num_importance],
                          "bf16": cfgs[arm].use_bf16, "kernels": cfgs[arm].use_kernels,
                          "trainer": "reference" if arm.startswith("reference") else "port",
                          "init": "torch",
                          "runs_of": SAME_AS.get(arm, arm)}
                    for arm in results},
        "seconds_per_seed": {arm: float(np.mean([r["train_seconds"] for r in runs]))
                             for arm, runs in results.items() if runs},
        "launches_per_seed": {arm: runs[0]["launches"] for arm, runs in results.items()
                              if runs},
    }
    report.update(statistics(results))
    anchors = _anchors(runs_dir, anchors_dir)
    if anchors:
        report["torch_anchors"] = anchors
    for extra in EXTRAS:
        path = os.path.join(runs_dir, f"{extra}.json")
        if os.path.isfile(path):
            with open(path) as f:
                report[extra] = json.load(f)

    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({k: v for k, v in report.items()
                      if k.startswith("delta") or k in ("arms", "seconds_per_seed")}, indent=2))
    print(f"wrote {out}", flush=True)
    return report


def main(argv=None) -> dict:
    from danerf_tpu_torch.benchmarks.torch_reference import use_f32_highest

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=5000)
    ap.add_argument("--seeds", type=int, default=4, help="alive seeds per principal arm")
    ap.add_argument("--hier-seeds", type=int, default=3)
    ap.add_argument("--f32-seeds", type=int, default=2)
    ap.add_argument("--abl-seeds", type=int, default=12,
                    help="alive seeds per attribution-ablation cell")
    ap.add_argument("--scene", default=SCENE)
    ap.add_argument("--out", default=REPORT)
    ap.add_argument("--runs-dir", default=RUNS_DIR)
    ap.add_argument("--arms", default="all",
                    help="comma list of " + ",".join(ARMS) + " (or 'all')")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    arms = ARMS if args.arms == "all" else tuple(args.arms.split(","))
    unknown = set(arms) - set(ARMS)
    if unknown:
        ap.error(f"unknown arms {sorted(unknown)}")
    # the f32 arms' plain matmuls in full f32 (the JAX study's f32-highest)
    use_f32_highest()
    return run(arms, args.iters, args.seeds, args.hier_seeds, args.f32_seeds, args.abl_seeds,
               args.scene, args.out, args.runs_dir, args.device)


if __name__ == "__main__":
    main()
