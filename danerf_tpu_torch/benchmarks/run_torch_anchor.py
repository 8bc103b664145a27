"""ONE reference-semantics training run with its progress and init (the
parity anchor; counterpart of benchmarks/run_torch_anchor.py).

The JAX study ran this script on its host's CPU (one 5000-step seed took
19,077 s, ``examples/parity_runs/torch_anchor_seed0.json``) and paired it
with its mirror.  Here it runs on ``--device`` (the card by default): the
reference trainer from the seed's torch init and numpy stream, a partial
report every 500 steps (with one val view every 1000), and the init as an
``.npz`` for pairing.

Writes (``--outdir``, by default the parity study's runs directory):
  torch_anchor_seed{S}[_hier].json       (progress + final)
  torch_anchor_seed{S}[_hier]_init.npz   (init for pairing)

    python -m danerf_tpu_torch.benchmarks.run_torch_anchor --iters 5000 --seed 0
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def run(iters: int = 5000, seed: int = 0, hier: bool = False, compile_fwd: bool = True,
        scene: str | None = None, outdir: str | None = None, device="cuda", base=None) -> dict:
    """The anchor run; writes its JSON and init under ``outdir`` and returns
    the final state."""
    from danerf_tpu_torch import resolve_device
    from danerf_tpu_torch.benchmarks.torch_reference import (render_image_reference,
                                                             train_reference)
    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.data.blender import load_blender_scene
    from danerf_tpu_torch.examples.parity_study import RUNS_DIR, SCENE

    dev = resolve_device(device)
    scene = scene or SCENE
    outdir = outdir or RUNS_DIR
    train_ds = load_blender_scene(scene, "train")
    val_ds = load_blender_scene(scene, "val")
    base = base or NeRFConfig()
    cfg = base.replace(num_importance=base.num_importance if hier else 0, use_kernels=False,
                       use_bf16=False, near=train_ds.near, far=train_ds.far)

    tag = f"torch_anchor_seed{seed}" + ("_hier" if hier else "")
    os.makedirs(outdir, exist_ok=True)
    out_json = os.path.join(outdir, f"{tag}.json")
    imgs = train_ds.images.astype(np.float32) / 255.0
    gt = val_ds.images.astype(np.float32) / 255.0

    t0 = time.time()
    state = {
        "arm": "torch_reference",
        "hier": hier,
        "seed": seed,
        "iters_target": iters,
        "compiled": compile_fwd,
        "device": str(dev),
        "config": {"batch": cfg.batch_size, "samples": cfg.num_samples,
                   "importance": cfg.num_importance, "hidden": cfg.hidden_dim,
                   "layers": cfg.num_layers,
                   "resolution": [train_ds.height, train_ds.width]},
        "status": "running",
    }

    def eval_now(model, emb, n_views=None):
        emb_row = emb.detach().mean(0) if emb is not None else None
        per_view = []
        nv = val_ds.n_images if n_views is None else min(n_views, val_ds.n_images)
        for i in range(nv):
            pred = render_image_reference(
                model, cfg, val_ds.c2ws[i], val_ds.height, val_ds.width,
                val_ds.focal, emb_row=emb_row, n_importance=cfg.num_importance)
            mse = float(np.mean((pred - gt[i]) ** 2))
            per_view.append({"view": i, "mse": mse,
                             "psnr": float(-10 * np.log10(max(mse, 1e-12)))})
        return per_view

    def trace(mses):
        return [float(np.mean(mses[j:j + 100])) for j in range(0, len(mses), 100)]

    def on_checkpoint(it, model, emb, mses):
        state["iters_done"] = it
        state["train_seconds"] = time.time() - t0
        state["train_psnr_tail"] = float(-10 * np.log10(np.mean(mses[-100:])))
        state["mse_trace_every100"] = trace(mses)
        # partial eval on ONE view keeps a checkpoint short
        if it % 1000 == 0:
            with torch.no_grad():
                state["partial_val"] = eval_now(model, emb, n_views=1)
        with open(out_json, "w") as f:
            json.dump(state, f, indent=2)
        print(f"[anchor] iter {it} psnr {state['train_psnr_tail']:.2f} "
              f"({state['train_seconds']:.0f}s)", flush=True)

    init_out = {}
    model, emb, mses = train_reference(
        cfg, imgs, train_ds.c2ws, train_ds.focal, iters, seed=seed, log_every=10 ** 9,
        use_compile=compile_fwd, init_out=init_out, on_checkpoint=on_checkpoint,
        checkpoint_every=500, device=dev)
    np.savez(os.path.join(outdir, f"{tag}_init.npz"), **init_out)

    per_view = eval_now(model, emb)
    state.update({
        "status": "done",
        "iters_done": iters,
        "train_seconds": time.time() - t0,
        "per_view": per_view,
        "val_psnr": float(np.mean([v["psnr"] for v in per_view])),
        "train_psnr_tail": float(-10 * np.log10(np.mean(mses[-100:]))),
        "final_train_psnr": float(-10 * np.log10(np.mean(mses[-100:]))),
        "mse_trace_every100": trace(mses),
    })
    with open(out_json, "w") as f:
        json.dump(state, f, indent=2)
    print(f"[anchor] done: val psnr {state['val_psnr']:.3f} "
          f"in {state['train_seconds']:.0f}s -> {out_json}", flush=True)
    return state


def main(argv=None) -> dict:
    from danerf_tpu_torch.benchmarks.torch_reference import use_f32_highest
    from danerf_tpu_torch.examples.parity_study import RUNS_DIR, SCENE

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=5000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hier", action="store_true",
                    help="hierarchical arm: num_importance=64, loss = mse(fine) + mse(coarse)")
    ap.add_argument("--no-compile", action="store_true")
    ap.add_argument("--scene", default=SCENE)
    ap.add_argument("--outdir", default=RUNS_DIR)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    use_f32_highest()
    return run(args.iters, args.seed, args.hier, not args.no_compile, args.scene, args.outdir,
               args.device)


if __name__ == "__main__":
    main()
