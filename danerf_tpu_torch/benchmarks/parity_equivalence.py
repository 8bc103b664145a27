"""The trajectory drift of the reference trainer between the card and the
CPU at the parity-study scale (counterpart of
benchmarks/parity_equivalence.py, which measured torch against its JAX
mirror).

Both sides start from the SAME torch init and consume the SAME numpy
stream (``torch_reference`` module doc), so their per-step losses differ
only by the two devices' arithmetic (cuBLAS and the card's elementwise
kernels against the CPU's).  The CPU side is the repository script's
trajectory bit for bit; the card side is the parity study's reference arm.

The report has the JAX script's keys, "torch" the CPU side and "mirror"
the card side (their seconds, final PSNRs and traces; ``sides`` says so),
and the device:
  - per-step relative loss drift over the window,
  - max/median drift over the first 50 steps and over all, the correlation
    of the log losses.
``--window N:PATH`` also writes the report of the run's first N steps to
PATH as soon as the CPU side has taken them (a run of 600 steps gives the
300-step report of the same trajectory, kept if the run is cut short).

    python -m danerf_tpu_torch.benchmarks.parity_equivalence --iters 300 [--hier]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np

from danerf_tpu_torch import resolve_device


def report_of(mt, mj, n: int, seed: int, hier: bool, scale: dict, seconds: dict,
              device: dict) -> dict:
    """The report of the first ``n`` steps of the CPU losses ``mt`` and the
    card's ``mj``."""
    mt, mj = np.asarray(mt[:n]), np.asarray(mj[:n])
    rel = np.abs(mt - mj) / np.maximum(np.abs(mt), 1e-12)
    k = min(50, n)
    return {
        "iters": n,
        "seed": seed,
        "hier": hier,
        "scale": scale,
        "pairing": "same torch init + same numpy RNG stream (see "
                   "danerf_tpu_torch/benchmarks/torch_reference.py module doc)",
        "sides": {"torch": "the reference trainer on the CPU", "mirror": "the same on the card"},
        "device": device,
        "torch_seconds": seconds["cpu"],
        "mirror_seconds": seconds["card"],
        f"rel_drift_first_{k}": {"max": float(rel[:k].max()),
                                 "median": float(np.median(rel[:k]))},
        "rel_drift_full": {"max": float(rel.max()), "median": float(np.median(rel))},
        "log_mse_correlation_full": float(np.corrcoef(
            np.log(np.maximum(mt, 1e-12)), np.log(np.maximum(mj, 1e-12)))[0, 1]),
        "final_psnr_torch": float(-10 * np.log10(mt[-k:].mean())),
        "final_psnr_mirror": float(-10 * np.log10(mj[-k:].mean())),
        "loss_trace_torch_every10": mt[::10].tolist(),
        "loss_trace_mirror_every10": mj[::10].tolist(),
    }


def run(iters: int = 300, seed: int = 0, hier: bool = False, scene: str | None = None,
        device="cuda", base=None, windows=(), on_window=None) -> list:
    """Train the reference ``iters`` steps on ``device``, then on the CPU;
    returns the reports of the whole run and of each window (its first N
    steps), in that order.  ``on_window(n, report)`` is called as soon as
    the CPU side has taken a window's N steps (a run cut short keeps
    them)."""
    from danerf_tpu_torch.benchmarks.torch_reference import train_reference
    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.data.blender import load_blender_scene
    from danerf_tpu_torch.examples import device_block
    from danerf_tpu_torch.examples.parity_study import SCENE

    dev = resolve_device(device)
    ds = load_blender_scene(scene or SCENE, "train")
    base = base or NeRFConfig()
    cfg = base.replace(num_importance=base.num_importance if hier else 0, use_kernels=False,
                       use_bf16=False, near=ds.near, far=ds.far)
    imgs = ds.images.astype(np.float32) / 255.0
    scale = {"resolution": [ds.height, ds.width], "batch": cfg.batch_size,
             "model": f"{cfg.num_layers}x{cfg.hidden_dim}",
             "samples": [cfg.num_samples, cfg.num_importance]}
    card = device_block(dev)
    seconds, losses, reports = {}, {}, {}

    def window(it, model, emb, mses):
        if it in windows:
            reports[it] = report_of(mses, losses["card"], it, seed, hier, scale,
                                    {**seconds, "cpu": time.time() - t0}, card)
            if on_window is not None:
                on_window(it, reports[it])

    for side, d in (("card", dev), ("cpu", "cpu")):
        t0 = time.time()
        _, _, losses[side] = train_reference(
            cfg, imgs, ds.c2ws, ds.focal, iters, seed=seed, log_every=10 ** 9, device=d,
            on_checkpoint=window if side == "cpu" and windows else None,
            checkpoint_every=math.gcd(*windows) if windows else 0)
        seconds[side] = time.time() - t0
    whole = report_of(losses["cpu"], losses["card"], iters, seed, hier, scale, seconds, card)
    return [whole] + [reports[n] for n in windows]


def _write(path: str, report: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=2)


def main(argv=None) -> list:
    from danerf_tpu_torch.benchmarks.torch_reference import use_f32_highest
    from danerf_tpu_torch.examples.parity_study import RUNS_DIR, SCENE

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hier", action="store_true")
    ap.add_argument("--scene", default=SCENE)
    ap.add_argument("--out", default=os.path.join(RUNS_DIR, "equivalence.json"))
    ap.add_argument("--window", action="append", default=[], metavar="N:PATH",
                    help="also write the report of the first N steps to PATH")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    windows = [(int(w.split(":", 1)[0]), w.split(":", 1)[1]) for w in args.window]
    if any(not 0 < n <= args.iters for n, _ in windows):
        ap.error("a window's N must lie in 1..--iters")
    use_f32_highest()
    paths = dict(windows)

    def write(path, report):
        _write(path, report)
        print(json.dumps({k: v for k, v in report.items() if not k.startswith("loss_trace")},
                         indent=2), flush=True)

    reports = run(args.iters, args.seed, args.hier, args.scene, args.device,
                  windows=tuple(paths), on_window=lambda n, r: write(paths[n], r))
    write(args.out, reports[0])
    return reports


if __name__ == "__main__":
    main()
