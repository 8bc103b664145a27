"""Command line of the port (counterpart of danerf_tpu/cli/main.py):
``python -m danerf_tpu_torch.cli.main render ...``.

``render`` takes the JAX CLI's flags plus ``--device`` (default cuda) and
``--seed``.  ``--checkpoint`` is a reference-format ``.pt`` (the port's own
saved state_dict uses the same keys).  Flags whose machinery is not yet
ported raise instead of being ignored.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="danerf-torch",
                                description="NeRF-W rendering on PyTorch/CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)

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
    from danerf_tpu_torch.data.dataset import load_dataset
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
    ds = load_dataset(cfg, "train")
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
    if args.cmd == "render":
        return cmd_render(args)
    raise SystemExit(f"unknown command {args.cmd!r}")


if __name__ == "__main__":
    main(sys.argv[1:])
