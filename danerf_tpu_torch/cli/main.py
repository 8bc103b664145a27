"""Command line of the port (counterpart of danerf_tpu/cli/main.py):
``python -m danerf_tpu_torch.cli.main {train,render} ...``.

``train`` takes the JAX CLI's flags plus ``--device`` (default cuda) and
``--checkpoint_every``, and writes reference-format ``.pt`` checkpoints and
``metrics.jsonl`` into ``--save_dir``.  ``render`` takes the JAX CLI's
flags plus ``--device`` and ``--seed``; ``--checkpoint`` is a
reference-format ``.pt`` (such as ``<save_dir>/checkpoint_final.pt``).
Flags whose machinery is not yet ported raise instead of being ignored.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="danerf-torch",
                                description="NeRF-W training and rendering on PyTorch/CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a NeRF-W model")
    t.add_argument("--scene", type=str, default="lego")
    t.add_argument("--dataset_path", type=str, default="data/nerf_synthetic")
    t.add_argument("--iters", type=int, default=None)
    t.add_argument("--batch_size", type=int, default=None)
    t.add_argument("--save_dir", type=str, default=None)
    t.add_argument("--resume", action="store_true", help="(not yet ported)")
    t.add_argument("--no_appearance", action="store_true")
    t.add_argument("--num_importance", type=int, default=None)
    t.add_argument("--mesh_data", type=int, default=1, help="(not yet ported; must be 1)")
    t.add_argument("--mesh_model", type=int, default=1, help="(not yet ported; must be 1)")
    t.add_argument("--seed", type=int, default=0,
                   help="seeds the initial weights and every draw of the run")
    t.add_argument("--profile", type=str, default=None, help="(not yet ported)")
    t.add_argument("--density_activation", type=str, default=None,
                   choices=["relu", "softplus"])
    t.add_argument("--density_bias_init", type=float, default=None,
                   help="added to the density bias at init (e.g. 0.5)")
    t.add_argument("--no_pallas", action="store_true",
                   help="take the reference route (autograd) instead of the kernels")
    t.add_argument("--white_background", action="store_true",
                   help="composite RGBA targets over white")
    t.add_argument("--use_time", action="store_true", help="(not yet ported)")
    t.add_argument("--coordinator_address", type=str, default=None, help="(not yet ported)")
    t.add_argument("--num_processes", type=int, default=None, help="(not yet ported)")
    t.add_argument("--process_id", type=int, default=None, help="(not yet ported)")
    t.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    t.add_argument("--checkpoint_every", type=int, default=1000,
                   help="steps between checkpoints (0: only the final one)")

    r = sub.add_parser("render", help="render novel views along a camera path")
    r.add_argument("--scene", type=str, default="hotdog")
    r.add_argument("--dataset_path", type=str, default="data/nerf_synthetic")
    r.add_argument("--checkpoint", type=str, default=None,
                   help="reference-format .pt checkpoint")
    r.add_argument("--output_dir", type=str, default="output")
    r.add_argument("--frames", type=int, default=120)
    r.add_argument("--quality", type=str, default="high",
                   choices=["preview", "medium", "high"])
    r.add_argument("--width", type=int, default=800)
    r.add_argument("--height", type=int, default=800)
    r.add_argument("--start_frame", type=int, default=0)
    r.add_argument("--end_frame", type=int, default=None)
    r.add_argument("--camera_path", type=str, default="circle",
                   choices=["circle", "spiral", "hemisphere", "horizontal_only"])
    r.add_argument("--spiral_loops", type=float, default=2.0)
    r.add_argument("--height_range", type=float, nargs=2, default=[-0.5, 0.5])
    r.add_argument("--effect", type=str, default=None,
                   help="depth-aware effect (not yet ported)")
    r.add_argument("--save_depth", action="store_true")
    r.add_argument("--raw_output", action="store_true")
    r.add_argument("--create_video", action="store_true", help="(not yet ported)")
    r.add_argument("--fps", type=int, default=30)
    r.add_argument("--no_pallas", action="store_true",
                   help="take the reference route instead of the kernels")
    r.add_argument("--chunk", type=int, default=None,
                   help="rays per kernel call (default: quality preset)")
    r.add_argument("--mesh_data", type=int, default=1,
                   help="multi-device frame sharding (not yet ported; must be 1)")
    r.add_argument("--white_background", action="store_true",
                   help="fill acc<1 rays with white")
    r.add_argument("--use_time", action="store_true", help="(not yet ported)")
    r.add_argument("--time", type=float, default=None, help="(not yet ported)")
    r.add_argument("--animate_time", action="store_true", help="(not yet ported)")
    r.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    r.add_argument("--seed", type=int, default=0,
                   help="seeds the per-frame sampling generators")
    return p


def _train_not_ported(args) -> list:
    bad = []
    if args.resume:
        bad.append("--resume")
    if args.profile is not None:
        bad.append("--profile")
    if args.mesh_data != 1 or args.mesh_model != 1:
        bad.append("--mesh_data/--mesh_model != 1")
    if (args.coordinator_address is not None or args.num_processes is not None
            or args.process_id is not None):
        bad.append("--coordinator_address/--num_processes/--process_id")
    if args.use_time:
        bad.append("--use_time")
    return bad


def _train_config(args):
    from danerf_tpu_torch.config import NeRFConfig

    over = {"use_kernels": not args.no_pallas, "white_background": args.white_background}
    if args.batch_size:
        over["batch_size"] = args.batch_size
    if args.no_appearance:
        over["use_appearance"] = False
    if args.num_importance is not None:
        over["num_importance"] = args.num_importance
    if args.density_activation:
        over["density_activation"] = args.density_activation
    if args.density_bias_init is not None:
        over["density_bias_init"] = args.density_bias_init
    return NeRFConfig(scene=args.scene, dataset_path=args.dataset_path).replace(**over)


def cmd_train(args):
    import os

    import torch

    from danerf_tpu_torch import resolve_device
    from danerf_tpu_torch.data.dataset import load_dataset
    from danerf_tpu_torch.models.nerf import NeRF
    from danerf_tpu_torch.train.trainer import train

    bad = _train_not_ported(args)
    if bad:
        raise NotImplementedError("not yet ported to danerf_tpu_torch: " + ", ".join(bad))
    device = resolve_device(args.device)
    cfg = _train_config(args)

    # Start-up smoke test before committing to training (reference
    # run.py:327-344): 10 random points through the model, with and without
    # an appearance embedding.
    g = torch.Generator().manual_seed(0)
    model = NeRF(cfg, g).to(device)
    x = torch.randn(10, 3, generator=g).to(device)
    d = torch.randn(10, 3, generator=g).to(device)
    d = d / d.norm(dim=-1, keepdim=True)
    with torch.no_grad():
        rgb, sigma = model(x, d)
        assert rgb.shape == (10, 3) and sigma.shape == (10,)
        if cfg.use_appearance:
            emb = torch.randn(10, cfg.appearance_dim, generator=g).to(device)
            rgb, sigma = model(x, d, emb)
            assert rgb.shape == (10, 3)
    print(f"model smoke test passed: rgb={tuple(rgb.shape)}, sigma={tuple(sigma.shape)}")
    del model

    ds = load_dataset(cfg, "train")
    save_dir = args.save_dir or f"checkpoints_{args.scene}"
    return train(cfg, ds, save_dir=save_dir, num_iterations=args.iters, seed=args.seed,
                 device=device, checkpoint_every=args.checkpoint_every,
                 log_path=os.path.join(save_dir, "metrics.jsonl"))


def _not_ported(args) -> list:
    bad = []
    if args.effect is not None:
        bad.append("--effect")
    if args.use_time or args.animate_time or args.time is not None:
        bad.append("--use_time/--animate_time/--time")
    if args.mesh_data != 1:
        bad.append("--mesh_data != 1")
    if args.create_video:
        bad.append("--create_video")
    if args.checkpoint is not None and not args.checkpoint.endswith(".pt"):
        bad.append("a danerf_tpu (Orbax) checkpoint directory; pass a .pt")
    return bad


def _load_model(args, cfg, device):
    """NeRF module + appearance embedding 0 from a reference .pt."""
    from danerf_tpu_torch.models.nerf import NeRF
    from danerf_tpu_torch.utils.convert import load_reference_checkpoint

    sd, emb_table, meta = load_reference_checkpoint(args.checkpoint)
    cfg = cfg.replace(use_appearance="appearance_projection.weight" in sd)
    model = NeRF(cfg)
    model.load_state_dict(sd)
    emb = None
    if cfg.use_appearance and emb_table is not None:
        emb = emb_table[0]  # the reference renders with embedding 0
    print(f"Imported reference checkpoint (iteration {meta.get('iteration')})")
    return model.to(device).eval().requires_grad_(False), emb, cfg


def cmd_render(args):
    from danerf_tpu_torch import resolve_device
    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.data.dataset import scene_intrinsics
    from danerf_tpu_torch.render.frames import render_path

    bad = _not_ported(args)
    if bad:
        raise NotImplementedError("not yet ported to danerf_tpu_torch: " + ", ".join(bad))
    if args.checkpoint is None:
        raise SystemExit("pass --checkpoint <reference-format .pt>")
    device = resolve_device(args.device)
    cfg = NeRFConfig(scene=args.scene, dataset_path=args.dataset_path,
                     white_background=args.white_background,
                     use_kernels=not args.no_pallas)
    ds = scene_intrinsics(cfg, "train")
    model, emb, cfg = _load_model(args, cfg, device)
    return render_path(model, cfg, args.output_dir, appearance_embedding=emb,
                       num_frames=args.frames, quality=args.quality,
                       width=args.width, height=args.height,
                       start_frame=args.start_frame, end_frame=args.end_frame,
                       camera_path_kind=args.camera_path,
                       spiral_loops=args.spiral_loops,
                       height_range=tuple(args.height_range),
                       save_depth=args.save_depth, raw_output=args.raw_output,
                       dataset_width=ds.width, focal=ds.focal, seed=args.seed,
                       chunk=args.chunk, device=device)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd == "train":
        return cmd_train(args)
    if args.cmd == "render":
        return cmd_render(args)
    raise SystemExit(f"unknown command {args.cmd!r}")


if __name__ == "__main__":
    main(sys.argv[1:])
