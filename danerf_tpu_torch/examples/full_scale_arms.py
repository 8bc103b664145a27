"""The full-scale study's arms on one scene, and the small example drivers
over seeds, each beside the JAX run's committed report: the evidence on
whether the port trains the model the JAX package trains (the port's
full-scale run scored 54.887 dB, the JAX run's on a TPU v5e 49.487).

Arms (``--arms``, run in the order given):

  seed:S          ``full_scale`` at its defaults from seed S (init and batches)
  live:N[:F]      the first N seeds from F (default 1) up whose density
                  head is live on the study's scene (``density_alive_probe``
                  > 0), each as seed:S; the dead ones are listed
  jax_init        seed 0's batches from the JAX run's own initial parameters
                  (``jax_init_seed0.npz``, ``create_train_state(key(0))``)
  no_pallas       seed 0 on the plain route (``use_kernels=False``: no kernel)
  hier_demo, demo_synthetic, multi_scene
                  the small driver at its JAX settings (``main``'s config,
                  the kernels on) from each of the first ``--small-seeds``
                  seeds from 0 up that are live on its scenes

The full-scale arms share one scene (made once on the device; no numpy
check view) and cut the spiral to ``--frames`` (the val PSNR is scored
before it); each small driver's scenes are made once for all its seeds.
Each arm's record goes into ``--summary`` as soon as it ends, merged with
what the file holds, beside the card's name and power limit; its full
report into ``--out``.  The summary also holds the port's seeds' spread,
the small drivers' mean, std and range beside each v5e figure, and each
clause of the decision rule (``decide``).  A later call given the same
``--summary`` adds its arms to the earlier ones (on the same card only).

    python -m danerf_tpu_torch.examples.full_scale_arms --arms seed:0 live:4 jax_init \\
        hier_demo demo_synthetic multi_scene no_pallas [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

import numpy as np
import torch

from danerf_tpu_torch import resolve_device
from danerf_tpu_torch.examples import device_block, full_scale

HERE = os.path.dirname(os.path.abspath(__file__))
SUMMARY = os.path.join(HERE, "full_scale_arms_h100.json")
OUT = os.path.join("build", "full_scale_arms")
REPO = os.path.dirname(os.path.dirname(HERE))
# the JAX runs' committed reports (examples/*_report_v5e.json)
V5E = {"full_scale": {"val_psnr": 49.487, "val_ssim": 0.9962, "final_train_psnr": 49.863,
                      "per_view_psnr": [45.13, 51.81]},
       "hier_demo": {"psnr": 29.8, "ssim": 0.988},
       "demo_synthetic": {"psnr": 31.007, "ssim": 0.9804},
       "multi_scene": {"0": {"psnr": 32.81, "ssim": 0.9946}, "1": {"psnr": 26.05, "ssim": 0.97}}}
V5E_REPORTS = [f"examples/{n}_report_v5e.json"
               for n in ("full_scale", "hier", "demo", "multi_scene")]
# below it an arm did not train (an all-black render of the val views
# scores about 6 dB, every arm that trained on the card 49.9 dB or more)
TRAINED_PSNR = 30.0
# the JAX scripts' settings (their defaults, or the flags of the v5e reports)
SMALL = {"hier_demo": {"iters": 1500, "size": 100},
         "demo_synthetic": {"iters": 3000, "size": 100, "frames": 24},
         "multi_scene": {"iters": 3000, "size": 80, "frames": 16, "scenes": ("0", "1")}}


def small_config(name: str, size: int, base=None):
    """The ``NeRFConfig`` each small driver's ``main`` builds on the card
    at ``size`` (``base``: ``NeRFConfig(use_bf16=True)``, or a test's)."""
    from danerf_tpu_torch.config import NeRFConfig

    base = base or NeRFConfig(use_bf16=True)
    if name == "hier_demo":
        return base
    return base.replace(num_importance=0, use_kernels=True, render_chunk=size * size)


def small_scenes(name: str, settings: dict) -> dict:
    """{scene name: (train, val)} as each small driver makes them."""
    from danerf_tpu_torch.data.synthetic import make_synthetic_scene

    size = settings["size"]
    if name == "hier_demo":
        return {"0": (make_synthetic_scene("train", height=size, width=size),
                      make_synthetic_scene("val", height=size, width=size))}
    if name == "demo_synthetic":
        return {"0": (make_synthetic_scene("train", n_images=20, height=size, width=size),
                      make_synthetic_scene("val", n_images=4, height=size, width=size))}
    return {s: (make_synthetic_scene("train", n_images=16, height=size, width=size,
                                     seed=int(s)),
                make_synthetic_scene("val", n_images=2, height=size, width=size, seed=int(s)))
            for s in settings["scenes"]}


def alive(cfg, scene, seed: int) -> float:
    """``density_alive_probe`` of ``init_model``'s draw for ``seed`` on
    ``scene`` (0.0: born dead; ``full_scale.init_block``)."""
    return full_scale.init_block(cfg, scene, seed, None, None)["density_alive"]


def stats(values) -> dict:
    v = np.asarray(values, np.float64)
    return {"n": int(v.size), "mean": float(v.mean()),
            "std": float(v.std(ddof=1)) if v.size > 1 else None,
            "min": float(v.min()), "max": float(v.max()), "range": float(v.max() - v.min())}


def decide(fs: dict) -> dict:
    """The decision rule's card-side clauses over the full-scale arms, in
    its order (the training loop's CPU test is the first clause's other
    half): the plain route off seed 0's kernel route by more than the
    seeds' std; the JAX init within 1.5 dB of the JAX run while the port's
    seeds stay >= 3 dB above it; the JAX run inside the seeds' range, or a
    range of >= 5.4 dB; every arm >= 3 dB above the JAX run.  An arm whose
    init the probe reads as dead (0.0, ``probe_dead_arms``) counts in the
    JAX-init clause and, as a seed, in the seed clause (``all_seeds``),
    and in no other; an arm below ``TRAINED_PSNR`` (a head that never
    revived, ``untrained_arms``) counts in the JAX-init clause alone."""
    jax = V5E["full_scale"]["val_psnr"]
    every = fs.get("arms", {})
    trained = {k: a for k, a in every.items() if a["val_psnr"] >= TRAINED_PSNR}
    arms = {k: a for k, a in trained.items() if a["init"]["density_alive"] > 0.0}

    def seeds_of(group):
        return [a["val_psnr"] for a in group.values()
                if a["route"] == "kernels" and a["init"]["from"] == "init_model"]

    seeds = seeds_of(arms)
    if len(seeds) < 2 or "seed:0" not in arms:
        return {}
    spread, all_seeds = stats(seeds), stats(seeds_of(trained))
    out = {"port_seeds": spread, "all_seeds": all_seeds, "jax_run": jax,
           "probe_dead_arms": sorted(k for k, a in every.items()
                                     if a["init"]["density_alive"] <= 0.0),
           "untrained_arms": sorted(set(every) - set(trained))}
    if "no_pallas" in arms:
        gap = arms["no_pallas"]["val_psnr"] - arms["seed:0"]["val_psnr"]
        out["plain_minus_kernels_seed0"] = gap
        out["port_fault"] = abs(gap) > spread["std"]
    if "jax_init" in fs["arms"]:
        out["jax_init_minus_jax_run"] = fs["arms"]["jax_init"]["val_psnr"] - jax
        out["init_effect"] = (abs(out["jax_init_minus_jax_run"]) <= 1.5
                              and spread["min"] - jax >= 3.0)
    out["seed_effect"] = (all_seeds["min"] <= jax <= all_seeds["max"]
                          or all_seeds["range"] >= 5.4)
    out["every_arm_3db_above"] = all(a["val_psnr"] - jax >= 3.0 for a in arms.values())
    # a secondary reading, which decides nothing alone: the JAX run against
    # the port's seeds' 95% prediction interval for one more seed
    from scipy import stats as sps

    half = sps.t.ppf(0.975, spread["n"] - 1) * spread["std"] * np.sqrt(1 + 1 / spread["n"])
    out["prediction_interval_95"] = [float(spread["mean"] - half), float(spread["mean"] + half)]
    out["jax_run_inside_prediction_interval"] = bool(abs(jax - spread["mean"]) <= half)
    return out


class Summary:
    """The summary file: loaded, updated one record at a time, written
    after each."""

    def __init__(self, path: str, card: dict):
        self.path = path
        self.data = {}
        device = card.get("nvidia_smi") or card["name"]
        if os.path.exists(path):
            with open(path) as f:
                self.data = json.load(f)
            if self.data.get("device", device) != device:
                raise ValueError(f"{path} holds arms of {self.data['device']!r}, not {device!r}")
        self.data.update(device=device, v5e=V5E, v5e_reports=V5E_REPORTS)

    def put(self, path, value) -> None:
        node = self.data
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
        if "full_scale" in self.data:
            self.data["full_scale"]["decision_rule"] = decide(self.data["full_scale"])
        with open(self.path, "w") as f:
            json.dump(self.data, f, indent=1)


def full_scale_arm(name, summary, scenes, out, study, dev, base, seed=0, init_npz=None,
                   kernels=True) -> None:
    """One full-scale arm of ``base`` through ``full_scale.run`` on the
    shared scene; ``study``: ``run``'s keyword settings (frames, and a
    test's cuts)."""
    cfg = base.replace(use_kernels=kernels)
    arm_dir = os.path.join(out, name.replace(":", "_"))
    rep = full_scale.run(cfg, arm_dir, arm_dir + ".json", device=dev, seed=seed,
                         init_npz=init_npz, scenes=scenes, **study)
    per_view = rep["eval"]["per_view_psnr"]
    summary.put(("full_scale", "arms", name), {
        "device": summary.data["device"], "seed": seed, "init": rep["init"],
        "route": "kernels" if kernels else "plain",
        "val_psnr": rep["eval"]["val_psnr"], "val_ssim": rep["eval"]["val_ssim"],
        "per_view_psnr_range": [min(per_view), max(per_view)],
        "final_train_psnr": rep["train"]["final_train_psnr"],
        "final_loss": rep["train"]["final_loss"],
        "train_seconds": rep["train"]["seconds"],
        "rays_per_sec_incl_ckpt": rep["train"]["rays_per_sec_incl_ckpt"],
        "launches": rep["train"]["launches"], "eval_launches": rep["eval"]["launches"],
        "eval_seconds_per_view": rep["eval"]["seconds_per_view"],
        "rates_match_steplr": rep["train"]["lr_at_checkpoints"]["all_match"],
        "report": os.path.relpath(arm_dir + ".json", REPO)})
    print(f"arm {name}: val PSNR {rep['eval']['val_psnr']:.3f} dB, train "
          f"{rep['train']['seconds']:.1f} s", flush=True)
    for sub in ("spiral", "fog", "toon_shader", "checkpoints"):
        shutil.rmtree(os.path.join(arm_dir, sub), ignore_errors=True)


def small_arm(name, summary, n_seeds, out, dev, settings, base=None) -> None:
    """A small driver at ``settings`` (``SMALL[name]``) from each of its
    first ``n_seeds`` live seeds."""
    import importlib

    mod = importlib.import_module(f"danerf_tpu_torch.examples.{name}")
    cfg, scenes = small_config(name, settings["size"], base), small_scenes(name, settings)
    runs, dead, seed = [], {}, 0
    while len(runs) < n_seeds:
        probe = {s: alive(cfg, scene, seed) for s, (scene, _) in scenes.items()}
        if min(probe.values()) <= 0.0:
            dead[str(seed)] = probe
            seed += 1
            continue
        run_dir = os.path.join(out, f"{name}_{seed}")
        t0 = time.time()
        if name == "multi_scene":
            rep = mod.run(cfg, settings["scenes"], settings["iters"], settings["size"],
                          settings["frames"], run_dir, dev, seed, datasets=scenes)
            row = {s: {"psnr": rep[s]["psnr"], "ssim": rep[s]["ssim"]}
                   for s in settings["scenes"]}
        elif name == "demo_synthetic":
            rep = mod.run(cfg, settings["iters"], run_dir, settings["size"], settings["frames"],
                          dev, seed, scenes=scenes["0"])
            row = {"psnr": rep["val_psnr"], "ssim": rep["val_ssim"],
                   "train_s": rep["train_seconds"]}
        else:
            rep = mod.run(cfg, settings["iters"], settings["size"], run_dir, dev, seed,
                          scenes=scenes["0"])
            row = {"psnr": rep["psnr"], "ssim": rep["ssim"], "train_s": rep["train_s"]}
        row.update(seed=seed, density_alive=probe, seconds=time.time() - t0)
        runs.append(row)
        shutil.rmtree(run_dir, ignore_errors=True)
        print(f"{name} seed {seed}: {row}", flush=True)
        seed += 1
    block = {"device": summary.data["device"],
             "settings": {k: list(v) if isinstance(v, tuple) else v for k, v in settings.items()},
             "pallas": cfg.use_kernels, "runs": runs, "dead_seeds": dead}
    if name == "multi_scene":
        for s in settings["scenes"]:
            block[s] = {"port": stats([r[s]["psnr"] for r in runs]),
                        "port_ssim": stats([r[s]["ssim"] for r in runs]),
                        "v5e": V5E[name][s]}
            block[s]["v5e_inside_range"] = (block[s]["port"]["min"] <= V5E[name][s]["psnr"]
                                            <= block[s]["port"]["max"])
    else:
        block["port"] = stats([r["psnr"] for r in runs])
        block["port_ssim"] = stats([r["ssim"] for r in runs])
        block["v5e"] = V5E[name]
        block["v5e_inside_range"] = block["port"]["min"] <= V5E[name]["psnr"] <= block["port"]["max"]
    summary.put(("small", name), block)


def run(arms, summary_path: str = SUMMARY, out: str = OUT, frames: int = 1,
        small_seeds: int = 8, probe_max: int = 40, device="cuda", base=None, small=None,
        **cuts) -> dict:
    """Run ``arms`` (see the module's docstring) in order; returns the
    summary.  For a test: ``base`` replaces ``NeRFConfig(use_bf16=True)``,
    ``small`` the small drivers' ``SMALL`` settings, and ``cuts``
    (``full_scale.run``'s ``iters``, ``size``, ``train_views``,
    ``val_views``, ``checkpoint_every``) the study's, ``full_scale.DEFAULTS``."""
    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.data.synthetic import make_synthetic_scene

    dev = resolve_device(device)
    os.makedirs(out, exist_ok=True)
    summary = Summary(summary_path, device_block(dev))
    base = base or NeRFConfig(use_bf16=True)
    small = small or SMALL
    study = {"frames": frames, **cuts}
    size, train_views, val_views = ({**full_scale.DEFAULTS, **cuts}[k]
                                    for k in ("size", "train_views", "val_views"))
    scenes = None
    for arm in arms:
        if arm in SMALL:
            small_arm(arm, summary, small_seeds, out, dev, small[arm], base)
            continue
        if scenes is None:
            t0 = time.time()
            scenes = (make_synthetic_scene("train", n_images=train_views, height=size,
                                           width=size, backend="torch", device=dev),
                      make_synthetic_scene("val", n_images=val_views, height=size, width=size,
                                           backend="torch", device=dev))
            print(f"scene: {time.time() - t0:.1f} s", flush=True)
        kind, _, arg = arm.partition(":")
        if kind == "seed":
            full_scale_arm(arm, summary, scenes, out, study, dev, base, seed=int(arg))
        elif kind == "live":
            count, _, first = arg.partition(":")
            found, dead = [], []
            for seed in range(int(first or 1), probe_max):
                if len(found) == int(count):
                    break
                if alive(base, scenes[0], seed) > 0.0:
                    found.append(seed)
                else:
                    dead.append(seed)
            summary.put(("full_scale", "live_seeds", arm), {"live": found, "dead": dead})
            for seed in found:
                full_scale_arm(f"seed:{seed}", summary, scenes, out, study, dev, base, seed=seed)
        elif kind == "jax_init":
            full_scale_arm(arm, summary, scenes, out, study, dev, base,
                           init_npz=full_scale.JAX_INIT)
        elif kind == "no_pallas":
            full_scale_arm(arm, summary, scenes, out, study, dev, base, kernels=False)
        else:
            raise ValueError(f"unknown arm {arm!r}")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return summary.data


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arms", nargs="+", required=True)
    ap.add_argument("--summary", default=SUMMARY,
                    help="the summary file; arms already in it are kept")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--frames", type=int, default=1,
                    help="spiral frames of each full-scale arm (scored before the spiral)")
    ap.add_argument("--small-seeds", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.arms, args.summary, args.out, args.frames, args.small_seeds,
               device=args.device)


if __name__ == "__main__":
    main()
