"""Command line of the port (counterpart of danerf_tpu/cli/main.py):
``python -m danerf_tpu_torch.cli.main {train,render,spiral,effects,eval,preview,video} ...``.

``train`` takes the JAX CLI's flags plus ``--device`` (default cuda) and
``--checkpoint_every``, and writes reference-format ``.pt`` checkpoints,
``metrics.jsonl``, a validation render at each checkpoint and
``training_curves.png`` into ``--save_dir``; ``--resume`` continues from
the latest checkpoint there, and ``--profile DIR`` first writes a
``torch.profiler`` trace of 20 steps into DIR.  ``render`` takes the JAX CLI's
flags plus ``--device`` and ``--seed``; ``--checkpoint`` is a
reference-format ``.pt`` (such as ``<save_dir>/checkpoint_final.pt``), and
without it ``render`` takes the latest checkpoint of ``checkpoints_<scene>``
(``train``'s default ``--save_dir``), as the JAX CLI does.  ``render
--effect NAME`` applies a depth-aware effect to each frame on the device,
and ``--create_video`` encodes the frames as an uncompressed AVI.
``spiral`` renders the aligned spiral (``frame_NNNN.png``, a grayscale
``depth_NNNN.png`` every 10th frame, a video) into ``output/<--output_dir>``
(the JAX CLI's prefix), with ``--device`` and ``--seed``; ``effects``
applies one effect or all of them to such a directory, ``preview`` writes
parameter-sweep previews from a JSON spec (both with ``--device``), and
``video`` encodes an image sequence.  ``eval`` renders a split of the scene
from a ``.pt`` and prints its PSNR/SSIM as one JSON line (``--out``: the
per-view report), with the JAX CLI's flags plus ``--device``;
``--optimize_embeddings`` fits each view's appearance embedding on its
left half and scores the right half.  A ``danerf_tpu`` (Orbax) checkpoint
directory is converted to a ``.pt`` by ``orbax_to_pt.py`` at the root of
the repository, where JAX is installed.
``train``, ``render`` and ``spiral`` take the JAX CLI's ``--mesh_data``
and ``--mesh_model`` and its multi-process flags (``--coordinator_address
host:port|auto --num_processes N --process_id i``; ``auto`` under
``torchrun``): data-parallel training over the ranks, each frame's rays
sharded over them (``parallel/mesh.py``); rank 0 writes the files.
``--use_time`` trains and renders the time-conditioned variant; ``render``
warns when ``--time`` or ``--animate_time`` come without it (the JAX CLI
ignores them silently).
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import warnings


def _add_process_flags(p) -> None:
    """The multi-process flags (``parallel.initialize_distributed``)."""
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of rank 0 (multi-process runs), or auto under torchrun")
    p.add_argument("--num_processes", type=int, default=None,
                   help="total number of processes (ranks)")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank in [0, num_processes)")


def _add_mesh_flags(p) -> None:
    """A frame renderer's mesh and multi-process flags."""
    p.add_argument("--mesh_data", type=int, default=1,
                   help="shard each frame's rays over this many ranks (0 = all ranks)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="model axis of the mesh: ranks of one data row render the same "
                        "rays (the weights stay whole)")
    _add_process_flags(p)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="danerf-torch",
                                description="NeRF-W training and rendering on PyTorch/CUDA")
    try:
        from importlib.metadata import version

        ver = version("danerf-tpu")
    except Exception:  # not installed as a package (repo checkout)
        ver = "dev"
    p.add_argument("--version", action="version", version=f"danerf-torch {ver}")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a NeRF-W model")
    t.add_argument("--scene", type=str, default="lego")
    t.add_argument("--dataset_path", type=str, default="data/nerf_synthetic")
    t.add_argument("--iters", type=int, default=None)
    t.add_argument("--batch_size", type=int, default=None)
    t.add_argument("--save_dir", type=str, default=None)
    t.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint in --save_dir")
    t.add_argument("--no_appearance", action="store_true")
    t.add_argument("--num_importance", type=int, default=None)
    t.add_argument("--mesh_data", type=int, default=1,
                   help="data-parallel axis size over the ranks (0 = ranks // mesh_model)")
    t.add_argument("--mesh_model", type=int, default=1,
                   help="tensor-parallel axis size (the trunk's weights sharded; capability, "
                        "not speed)")
    t.add_argument("--seed", type=int, default=0,
                   help="seeds the initial weights and every draw of the run")
    t.add_argument("--profile", type=str, default=None,
                   help="first write a torch.profiler trace of 20 steps to this dir")
    t.add_argument("--density_activation", type=str, default=None,
                   choices=["relu", "softplus"])
    t.add_argument("--density_bias_init", type=float, default=None,
                   help="added to the density bias at init (e.g. 0.5)")
    t.add_argument("--no_pallas", action="store_true",
                   help="take the reference route (autograd) instead of the kernels")
    t.add_argument("--white_background", action="store_true",
                   help="composite RGBA targets over white")
    t.add_argument("--use_time", action="store_true",
                   help="train the time-conditioned variant; needs per-image times, which "
                        "the procedural time-varying scene supplies when no Blender data "
                        "is present")
    _add_process_flags(t)
    t.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    t.add_argument("--checkpoint_every", type=int, default=1000,
                   help="steps between checkpoints (0: only the final one)")

    r = sub.add_parser("render", help="render novel views along a camera path")
    r.add_argument("--scene", type=str, default="hotdog")
    r.add_argument("--dataset_path", type=str, default="data/nerf_synthetic")
    r.add_argument("--checkpoint", type=str, default=None,
                   help="reference-format .pt checkpoint (default: the latest in "
                        "checkpoints_<scene>)")
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
                   help="depth-aware effect applied to each frame on the device")
    r.add_argument("--save_depth", action="store_true")
    r.add_argument("--raw_output", action="store_true")
    r.add_argument("--create_video", action="store_true",
                   help="encode the frames as <scene>_render.avi (uncompressed)")
    r.add_argument("--fps", type=int, default=30)
    r.add_argument("--no_pallas", action="store_true",
                   help="take the reference route instead of the kernels")
    r.add_argument("--chunk", type=int, default=None,
                   help="rays per kernel call (default: quality preset)")
    _add_mesh_flags(r)
    r.add_argument("--white_background", action="store_true",
                   help="fill acc<1 rays with white")
    r.add_argument("--use_time", action="store_true",
                   help="render a time-conditioned checkpoint")
    r.add_argument("--time", type=float, default=None,
                   help="fixed frame time in [0, 1] for --use_time renders (default 0)")
    r.add_argument("--animate_time", action="store_true",
                   help="sweep t from 0 to 1 across the rendered frames (--use_time)")
    r.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    r.add_argument("--seed", type=int, default=0,
                   help="seeds the per-frame sampling and effect generators")

    s = sub.add_parser("spiral", help="aligned spiral render + video")
    s.add_argument("--scene", type=str, default="chair")
    s.add_argument("--dataset_path", type=str, default="data/nerf_synthetic")
    s.add_argument("--checkpoint", type=str, default=None,
                   help="reference-format .pt checkpoint (default: the latest in "
                        "checkpoints_<scene>)")
    s.add_argument("--output_dir", type=str, default="spiral_render",
                   help="written under output/ unless it starts with output/")
    s.add_argument("--frames", type=int, default=120)
    s.add_argument("--fps", type=int, default=60)
    s.add_argument("--loops", type=float, default=2)
    s.add_argument("--rotation", type=str, default="x", choices=["x", "y", "z", "none"])
    s.add_argument("--width", type=int, default=800)
    s.add_argument("--height", type=int, default=800)
    s.add_argument("--no_pallas", action="store_true",
                   help="take the reference route instead of the kernels")
    _add_mesh_flags(s)
    s.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    s.add_argument("--seed", type=int, default=0,
                   help="seeds the per-frame generators")

    e = sub.add_parser("effects", help="apply effects to rendered frames")
    e.add_argument("--input_dir", type=str, required=True)
    e.add_argument("--output_dir", type=str, default=None)
    e.add_argument("--effect", type=str, default=None, help="one effect; default: all")
    e.add_argument("--skip_effects", type=str, nargs="+", default=[])
    e.add_argument("--fog_only", action="store_true")
    e.add_argument("--fps", type=int, default=60)
    e.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")

    ev = sub.add_parser("eval", help="render a split and report PSNR/SSIM")
    ev.add_argument("--scene", type=str, default="lego")
    ev.add_argument("--dataset_path", type=str, default="data/nerf_synthetic")
    ev.add_argument("--checkpoint", type=str, default=None,
                    help="reference-format .pt checkpoint (default: the latest in "
                         "checkpoints_<scene>)")
    ev.add_argument("--split", type=str, default="val")
    ev.add_argument("--max_views", type=int, default=None)
    ev.add_argument("--num_importance", type=int, default=None)
    ev.add_argument("--out", type=str, default=None, help="write JSON report")
    ev.add_argument("--no_pallas", action="store_true",
                    help="take the reference route instead of the kernels")
    ev.add_argument("--optimize_embeddings", action="store_true",
                    help="NeRF-W held-out protocol: per view, fit a fresh appearance "
                         "embedding on the left half and score the right half")
    ev.add_argument("--opt_steps", type=int, default=50,
                    help="embedding-optimization steps per view")
    ev.add_argument("--use_time", action="store_true",
                    help="evaluate a time-conditioned checkpoint (per-view times come "
                         "from the dataset)")
    ev.add_argument("--white_background", action="store_true",
                    help="score against white-composited GT and render with a white "
                         "background")
    ev.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")

    pv = sub.add_parser("preview", help="parameter-sweep effect previews")
    pv.add_argument("--image", type=str, required=True)
    pv.add_argument("--depth", type=str, default=None)
    pv.add_argument("--spec", type=str, required=True,
                    help="JSON spec: {effects: [{name, params?, sweep?}]}")
    pv.add_argument("--output_dir", type=str, default="previews")
    pv.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")

    v = sub.add_parser("video", help="encode an image sequence to video (uncompressed AVI)")
    v.add_argument("--input_dir", type=str, required=True)
    v.add_argument("--output", type=str, required=True,
                   help="a name not ending in .avi becomes <root>.avi")
    v.add_argument("--pattern", type=str, default="rgb_*.png")
    v.add_argument("--fps", type=int, default=30)
    v.add_argument("--resolution", type=int, nargs=2, default=None)
    return p


@contextlib.contextmanager
def _process_group(args, device):
    """Join the process group the multi-process flags describe
    (``initialize_distributed``: NCCL on the card, gloo on the CPU) for the
    command, and leave it after."""
    from danerf_tpu_torch.parallel import initialize_distributed

    joined = initialize_distributed(args.coordinator_address, args.num_processes,
                                    args.process_id, device=device)
    if joined:
        import torch.distributed as dist

        print(f"distributed: process {dist.get_rank()}/{dist.get_world_size()}, "
              f"{dist.get_backend()}")
    try:
        yield
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def _make_mesh(args, device, render: bool):
    """The (data, model) mesh of ``--mesh_data``/``--mesh_model`` over the
    ranks of the process group, or None: for axes of 1, or without a process
    group (one rank is the unsharded path), or when the axes exceed the
    ranks, where ``train`` stays on one rank and ``render``/``spiral`` say
    so, as the JAX CLI does."""
    if args.mesh_data == 1 and args.mesh_model == 1:
        return None
    import torch.distributed as dist

    from danerf_tpu_torch.parallel import make_mesh
    from danerf_tpu_torch.parallel.mesh import _rank_world

    world = _rank_world()[1]
    data = args.mesh_data or world // args.mesh_model
    if data * args.mesh_model > world:
        if render:
            print(f"--mesh_data {data} > {world} devices; rendering single-device")
        return None
    if not dist.is_initialized():
        return None
    return make_mesh(data=data, model=args.mesh_model, device=device)


def _train_config(args):
    from danerf_tpu_torch.config import NeRFConfig

    over = {"use_kernels": not args.no_pallas, "white_background": args.white_background,
            "use_time": args.use_time}
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
    from danerf_tpu_torch import resolve_device

    device = resolve_device(args.device)
    with _process_group(args, device):
        return _train(args, device)


def _train(args, device):
    import os

    import torch

    from danerf_tpu_torch.data.dataset import load_dataset
    from danerf_tpu_torch.models.nerf import NeRF
    from danerf_tpu_torch.train.trainer import train

    cfg = _train_config(args)

    # Start-up smoke test before committing to training (reference
    # run.py:327-344): 10 random points through the model, with and without
    # an appearance embedding (at t = 0.5 under --use_time).
    g = torch.Generator().manual_seed(0)
    model = NeRF(cfg, g).to(device)
    x = torch.randn(10, 3, generator=g).to(device)
    d = torch.randn(10, 3, generator=g).to(device)
    d = d / d.norm(dim=-1, keepdim=True)
    tt = torch.full((10, 1), 0.5, device=device) if cfg.use_time else None
    with torch.no_grad():
        rgb, sigma = model(x, d, t=tt)
        assert rgb.shape == (10, 3) and sigma.shape == (10,)
        if cfg.use_appearance:
            emb = torch.randn(10, cfg.appearance_dim, generator=g).to(device)
            rgb, sigma = model(x, d, emb, tt)
            assert rgb.shape == (10, 3)
    print(f"model smoke test passed: rgb={tuple(rgb.shape)}, sigma={tuple(sigma.shape)}")
    del model

    ds = load_dataset(cfg, "train")
    mesh = _make_mesh(args, device, render=False)
    if mesh is not None:
        cfg = cfg.replace(mesh_data=mesh.data, mesh_model=mesh.model)
    save_dir = args.save_dir or f"checkpoints_{args.scene}"
    if args.profile:
        # a short profiled run before the real one (the JAX CLI's); its
        # checkpoint goes into the trace directory, so that --resume never
        # continues from it
        from danerf_tpu_torch.utils.profiling import trace

        with trace(args.profile):
            train(cfg, ds, save_dir=os.path.join(args.profile, "run"), num_iterations=20,
                  checkpoint_every=0, seed=args.seed, device=device, progress=False, mesh=mesh)
        print(f"profiler trace written to {args.profile}")
    return train(cfg, ds, save_dir=save_dir, resume=args.resume, num_iterations=args.iters,
                 seed=args.seed, device=device, checkpoint_every=args.checkpoint_every,
                 log_path=os.path.join(save_dir, "metrics.jsonl"), mesh=mesh)


def _not_ported(args) -> list:
    bad = []
    if args.checkpoint is not None and not args.checkpoint.endswith(".pt"):
        bad.append("a danerf_tpu (Orbax) checkpoint directory; convert it to a .pt with "
                   "orbax_to_pt.py (at the repository root, where JAX is installed)")
    return bad


def _load_model(args, cfg, device, want_table: bool = False):
    """NeRF module + appearance embedding 0 from a reference .pt: the one
    ``--checkpoint`` names, else the latest of ``checkpoints_<scene>``.
    With ``want_table`` the whole appearance table (or None) comes after
    the embedding."""
    from danerf_tpu_torch.utils.checkpoint import latest_checkpoint, load_model

    ckpt = args.checkpoint
    if not ckpt:
        default_dir = f"checkpoints_{args.scene}"
        ckpt = latest_checkpoint(default_dir)
        if ckpt is None:
            sys.exit(f"No checkpoint found in {default_dir}; pass --checkpoint")
        print(f"Using checkpoint: {ckpt}")
    model, emb_table, meta, cfg = load_model(ckpt, cfg, device)
    emb = None
    if cfg.use_appearance and emb_table is not None:
        emb = emb_table[0]  # the reference renders with embedding 0
    print(f"Imported reference checkpoint (iteration {meta.get('iteration')})")
    model = model.eval().requires_grad_(False)
    if want_table:
        return model, emb, emb_table if cfg.use_appearance else None, cfg
    return model, emb, cfg


def cmd_render(args):
    from danerf_tpu_torch import resolve_device

    bad = _not_ported(args)
    if bad:
        raise NotImplementedError("not yet ported to danerf_tpu_torch: " + ", ".join(bad))
    device = resolve_device(args.device)
    with _process_group(args, device):
        return _render(args, device)


def _render(args, device):
    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.data.dataset import scene_intrinsics
    from danerf_tpu_torch.render.frames import render_path

    if not args.use_time and (args.time is not None or args.animate_time):
        warnings.warn("--time/--animate_time have no effect without --use_time (a model "
                      "without the time input); rendering without a time", stacklevel=2)
    cfg = NeRFConfig(scene=args.scene, dataset_path=args.dataset_path,
                     white_background=args.white_background,
                     use_kernels=not args.no_pallas, use_time=args.use_time)
    ds = scene_intrinsics(cfg, "train")
    model, emb, cfg = _load_model(args, cfg, device)
    return render_path(model, cfg, args.output_dir, appearance_embedding=emb,
                       num_frames=args.frames, quality=args.quality,
                       width=args.width, height=args.height,
                       start_frame=args.start_frame, end_frame=args.end_frame,
                       camera_path_kind=args.camera_path,
                       spiral_loops=args.spiral_loops,
                       height_range=tuple(args.height_range), effect=args.effect,
                       save_depth=args.save_depth, raw_output=args.raw_output,
                       make_video=args.create_video, fps=args.fps,
                       dataset_width=ds.width, focal=ds.focal, seed=args.seed,
                       chunk=args.chunk, time=args.time if args.use_time else None,
                       animate_time=args.use_time and args.animate_time, device=device,
                       mesh=_make_mesh(args, device, render=True))


def cmd_spiral(args):
    from danerf_tpu_torch import resolve_device

    bad = _not_ported(args)
    if bad:
        raise NotImplementedError("not yet ported to danerf_tpu_torch: " + ", ".join(bad))
    device = resolve_device(args.device)
    with _process_group(args, device):
        return _spiral(args, device)


def _spiral(args, device):
    import os

    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.data.dataset import scene_intrinsics
    from danerf_tpu_torch.render.frames import render_aligned_spiral

    cfg = NeRFConfig(scene=args.scene, dataset_path=args.dataset_path,
                     use_kernels=not args.no_pallas)
    ds = scene_intrinsics(cfg, "train")
    model, emb, cfg = _load_model(args, cfg, device)
    out = args.output_dir
    if not out.startswith("output/"):  # the reference's prefix, as the JAX CLI keeps it
        out = os.path.join("output", out)
    return render_aligned_spiral(model, cfg, out, appearance_embedding=emb,
                                 num_frames=args.frames, fps=args.fps, loops=args.loops,
                                 rotation_axis=args.rotation, height=args.height,
                                 width=args.width, focal=ds.focal, seed=args.seed,
                                 device=device, mesh=_make_mesh(args, device, render=True))


def cmd_effects(args):
    import os

    from danerf_tpu_torch.fx.batch import apply_all_effects, apply_effect_to_frames

    out = args.output_dir or args.input_dir + "_effects"
    if args.effect:
        return apply_effect_to_frames(args.input_dir,
                                      os.path.join(out, args.effect.lower().replace(" ", "_")),
                                      args.effect, fps=args.fps, device=args.device)
    return apply_all_effects(args.input_dir, out, fog_only=args.fog_only,
                             skip=args.skip_effects, fps=args.fps, device=args.device)


def cmd_eval(args):
    import json

    from danerf_tpu_torch import resolve_device
    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.data.dataset import load_dataset
    from danerf_tpu_torch.train.evaluate import evaluate

    bad = _not_ported(args)
    if bad:
        raise NotImplementedError("not yet ported to danerf_tpu_torch: " + ", ".join(bad))
    device = resolve_device(args.device)
    cfg = NeRFConfig(scene=args.scene, dataset_path=args.dataset_path,
                     white_background=args.white_background,
                     use_kernels=not args.no_pallas, use_time=args.use_time)
    if args.num_importance is not None:
        cfg = cfg.replace(num_importance=args.num_importance)
    ds = load_dataset(cfg, args.split)
    model, emb, table, cfg = _load_model(args, cfg, device, want_table=True)
    appearance = None
    if cfg.use_appearance:
        if args.split == "train" and table is not None and table.shape[0] == ds.n_images:
            appearance = table          # each train view its own embedding
        elif emb is not None:
            # held-out views: embedding 0 (the reference's), unless
            # --optimize_embeddings fits one per view
            appearance = emb[None].repeat(ds.n_images, 1)
    res = evaluate(model, cfg, ds, appearance=appearance, max_views=args.max_views,
                   n_importance=args.num_importance,
                   optimize_embeddings=args.optimize_embeddings, opt_steps=args.opt_steps,
                   device=device)
    print(json.dumps({k: res[k] for k in ("psnr", "ssim", "mse", "n_views", "protocol")}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


def cmd_preview(args):
    from danerf_tpu_torch.fx.preview import preview_from_files

    written = preview_from_files(args.image, args.depth, args.spec, args.output_dir,
                                 device=args.device)
    print(f"wrote {len(written)} previews to {args.output_dir}")
    return written


def cmd_video(args):
    from danerf_tpu_torch.viz.video import create_video_from_images

    ok = create_video_from_images(args.input_dir, args.output, args.pattern, args.fps,
                                  tuple(args.resolution) if args.resolution else None)
    if not ok:
        sys.exit(f"no images matching {args.pattern} in {args.input_dir}")
    return ok


COMMANDS = {"train": cmd_train, "render": cmd_render, "spiral": cmd_spiral,
            "effects": cmd_effects, "eval": cmd_eval, "preview": cmd_preview,
            "video": cmd_video}


def main(argv=None):
    args = build_parser().parse_args(argv)
    return COMMANDS[args.cmd](args)


if __name__ == "__main__":
    main(sys.argv[1:])
