"""A/B timing of the port's CUDA kernels (K1-K9; K1, K2, K5, K6 and K7 also with time)
between another checkout and this one, on one GPU.

    python3 kernel_ab.py BASE_DIR [--rounds 2] [--out FILE]

BASE_DIR is a checkout of another commit (for example the parent, unpacked
with ``git archive``).  Each round runs one process per tree in the order
base, this, this, base; each process builds its kernels from its own
sources (``BASE_DIR/build``, ``./build``) and times every kernel with CUDA
events at chip_smoke.py's shapes and seeds: K2 (want_field) and K5 on a
65,536-ray chunk, K2 also at 32 samples (``preview``) and both with time
(``use_time``, their has_time variants: ``k2_t``, ``k5_t``), K3 (with
g_field), K4, K6, K7 and K9 at the 1024-ray batch, K6 and K7 also with time
(``k6_t``, ``k7_t``), K1 and K8 at the 131,072 rows of a batch's fine
evaluation, K1 also with time (``k1_t``), K1 and K8 also at the 65,536 rows
of its coarse one (``k1_65536``, ``k8_65536``); the f32 configuration
(use_bf16=False) of K2 (want_field) and K5 on the chunk (``k2_f32``,
``k5_f32``) and of K2 at the 1024-ray batch (``k2_f32_1024``), each also
with time (``..._t``); of K3 (with g_field), K4, K6 (every cotangent) and
K7 at the batch (``k3_f32``, ``k4_f32``, ``k6_f32``, ``k7_f32``; with time
``..._t``) and at 8,192 rays (``k3_f32_8192``, ``k4_f32_8192``,
``k6_f32_8192``, ``k7_f32_8192``); of K8 at the 131,072 and 65,536 rows
(``k8_f32``, ``k8_f32_65536``) and K9 at the batch (``k9_f32``), each also
with time (``..._t``); of K1 at the same rows (``k1_f32``,
``k1_f32_65536``; with time at 131,072, ``k1_f32_t``); and the f32
training steps at the batch, chained as ``train`` runs them (ms a step,
the median of 20 replays of 10 steps, chip_smoke.py's step_timing): 64 +
64 (``step_f32_hier``), coarse-only
(``step_f32_coarse``: one K7), white background (``step_f32_white``: K2,
K5, K6, K3), per sample (``step_f32_per_sample``: two K1 and two K8) and
in one kernel (``step_f32_onepass``: one K9).

    python3 kernel_ab.py --ablate NAME [--rounds 1]

times this tree against a copy of it (``build/ablate_NAME``) with one part
of an f32 tensor-core tile taken out: ``weight_stream``, the TMA loads of
the forward's weight ring (``csrc/field_f32_sm90.cuh``; each stage is
released to the consumers unloaded), ``products``, its tensor-core products
(each slice's fence, commit and wait stay; also the f32 K3 and K4 tile's
forward and transposed chain, which take the same slices), and, of the f32
K3 and K4 (``csrc/field_bwd_f32_sm90.cuh``), ``chain_stream``, the TMA
loads of the transposed chain's weights, or ``dw_products``, the tensor-core
products of their wgmma dW pass.  The copy's f32 outputs are wrong; only
its times mean something: how far that part holds the tile (the f32 K6
and K7 run on the same tiles as K3 and K4).

    python3 kernel_ab.py BASE_DIR --decode [--rounds 3]

times the port's image decoders instead, on the host (no GPU, nothing
built): each process decodes every JPEG and PNG of this tree's
tests/data_torch/ with its own tree's ``data/jpeg.py`` and ``data/png.py``
(ms, median of --iters decodes after one warm-up); a file that tree
refuses (the base's refusals) is left out of its record.

Prints one
JSON line per process and, last, the medians per tree and their ratio
(this / base) per kernel.  Needs a GPU, except with --decode; exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# --ablate: (the header of csrc/, the text taken out, what replaces it)
ABLATIONS = {
    "weight_stream": (
        "field_f32_sm90.cuh",
        """      mbar_expect_tx(full + 8 * pp.stage, 2 * n * ROW_BYTES);
      tma_load3(ring + pp.stage * STAGE_BYTES, &maps.m[i], k0, full + 8 * pp.stage);
""",
        """      mbar_arrive(&smem32().full[pp.stage]);
"""),
    "products": (
        "field_f32_sm90.cuh",
        """  wgmma_tf32<N>(acc, f.lo, dh, !first);
  wgmma_tf32<N>(acc, f.hi, dl, 1);
  wgmma_tf32<N>(acc, f.hi, dh, 1);
""",
        ""),
    "chain_stream": (
        "field_bwd_f32_sm90.cuh",
        """    mbar_expect_tx(full + 8 * pp.stage, STAGE_BYTES);
    tma_load3_at(ring + pp.stage * STAGE_BYTES, m, k0, row, 0, full + 8 * pp.stage);
""",
        """    mbar_arrive(&sm.f.full[pp.stage]);
"""),
    "dw_products": (
        "field_bwd_f32_sm90.cuh",
        """  wgmma_tf32<HID>(acc, f.lo, dh, 1);
  wgmma_tf32<HID>(acc, f.hi, dl, 1);
  wgmma_tf32<HID>(acc, f.hi, dh, 1);
""",
        ""),
}


def ablated_tree(name):
    """A copy of this tree's package (and chip_smoke.py, which the step's
    timing takes) under build/ablate_NAME with the part ``name`` of an f32
    tile taken out (ABLATIONS); returns its root."""
    root = os.path.join(HERE, "build", f"ablate_{name}")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "danerf_tpu_torch"),
                    os.path.join(root, "danerf_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(HERE, "chip_smoke.py"), root)
    file, old, new = ABLATIONS[name]
    header = os.path.join(root, "danerf_tpu_torch", "kernels", "csrc", file)
    with open(header) as f:
        text = f.read()
    if text.count(old) != 1:
        raise RuntimeError(f"--ablate {name}: its text is not in {file} once")
    with open(header, "w") as f:
        f.write(text.replace(old, new))
    return root


def _time_kernels(iters):
    """Every kernel's ms per call in this process (imports the tree on
    sys.path)."""
    import torch

    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.kernels import fused_mlp as fm
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.models.nerf import NeRF
    from danerf_tpu_torch.ops.sampling import importance_uniforms, sample_pdf, sample_stratified

    dev = torch.device("cuda")
    cfg = NeRFConfig(density_bias_init=0.5)
    model = NeRF(cfg, torch.Generator().manual_seed(0)).to(dev).requires_grad_(False)
    packed = fm.pack_params(model, cfg)
    cfg_t = cfg.replace(use_time=True)
    model_t = NeRF(cfg_t, torch.Generator().manual_seed(0)).to(dev).requires_grad_(False)
    packed_t = fm.pack_params(model_t, cfg_t)
    c32, c32_t = cfg.replace(use_bf16=False), cfg_t.replace(use_bf16=False)
    p32, p32_t = fm.pack_params(model, c32), fm.pack_params(model_t, c32_t)

    def rays(n, seed, samples):
        g = torch.Generator(device=dev).manual_seed(seed)
        o = torch.randn(n, 3, generator=g, device=dev)
        o = 4.0 * o / o.norm(dim=-1, keepdim=True)
        d = -o / 4.0 + 0.3 * torch.randn(n, 3, generator=g, device=dev)
        d = d / d.norm(dim=-1, keepdim=True)
        emb = torch.randn(n, cfg.appearance_dim, generator=g, device=dev)
        z, _ = sample_stratified(o, d, cfg.near, cfg.far, samples, True, g)
        return o, d, emb, z, g

    def ms(fn, n):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    out = {}
    sc, sf = cfg.num_samples, cfg.num_importance
    for tag, n in (("chunk", cfg.render_chunk), ("batch", cfg.batch_size)):
        o, d, emb, z, g = rays(n, 4 if tag == "chunk" else 32, sc)
        coarse = fr.march_cuda(packed, cfg, o, d, emb, z, want_field=True)
        z_f = sample_pdf(z, coarse["weights"], sf, True, rand=g)
        field = coarse["field"]
        if tag == "chunk":
            out["k2"] = ms(lambda: fr.march_cuda(packed, cfg, o, d, emb, z, want_field=True),
                           max(2, iters // 4))
            out["k5"] = ms(lambda: fr.merged_cuda(packed, cfg, o, d, emb, z, field, z_f),
                           max(2, iters // 4))
            z32 = z[:, ::2].contiguous()
            out["k2_s32"] = ms(lambda: fr.march_cuda(packed, cfg, o, d, emb, z32),
                               max(2, iters // 4))
            t = torch.rand(n, 1, generator=g, device=dev)
            coarse_t = fr.march_cuda(packed_t, cfg_t, o, d, emb, z, t, want_field=True)
            field_t = coarse_t["field"]
            out["k2_t"] = ms(lambda: fr.march_cuda(packed_t, cfg_t, o, d, emb, z, t,
                                                   want_field=True), max(2, iters // 4))
            out["k5_t"] = ms(lambda: fr.merged_cuda(packed_t, cfg_t, o, d, emb, z, field_t, z_f, t),
                             max(2, iters // 4))
            # the f32 K2 and K5, without and with time
            for key, cc, pp, tt in (("", c32, p32, None), ("_t", c32_t, p32_t, t)):
                f32_field = fr.march_cuda(pp, cc, o, d, emb, z, tt, want_field=True)["field"]
                out["k2_f32" + key] = ms(lambda: fr.march_cuda(pp, cc, o, d, emb, z, tt,
                                                               want_field=True), max(2, iters // 8))
                out["k5_f32" + key] = ms(lambda: fr.merged_cuda(pp, cc, o, d, emb, z, f32_field,
                                                                z_f, tt), max(2, iters // 8))
            continue
        cot = (torch.randn(n, 3, generator=g, device=dev), torch.randn(n, generator=g, device=dev),
               torch.randn(n, generator=g, device=dev),
               0.1 * torch.randn(n, sc, generator=g, device=dev))
        g_field = 0.1 * torch.randn(n, 4, sc, generator=g, device=dev)
        c6 = cot[:3] + (0.1 * torch.randn(n, sc + sf, generator=g, device=dev),)
        target = torch.rand(n, 3, generator=g, device=dev)
        out["k3"] = ms(lambda: fr.march_bwd_cuda(packed, cfg, o, d, emb, z, *cot, g_field), iters)
        out["k4"] = ms(lambda: fr.merged_train_cuda(packed, cfg, o, d, emb, z, field, z_f,
                                                    target), iters)
        out["k6"] = ms(lambda: fr.merged_bwd_cuda(packed, cfg, o, d, emb, z, field, z_f, *c6),
                       iters)
        out["k7"] = ms(lambda: fr.march_train_cuda(packed, cfg, o, d, emb, z, target), iters)
        u = importance_uniforms((n,), sf, True, rand=g, device=dev)
        out["k9"] = ms(lambda: fr.hier_onepass_cuda(packed, cfg, o, d, emb, z, u, target), iters)
        t = torch.rand(n, 1, generator=g, device=dev)
        field_t = fr.march_cuda(packed_t, cfg_t, o, d, emb, z, t, want_field=True)["field"]
        out["k6_t"] = ms(lambda: fr.merged_bwd_cuda(packed_t, cfg_t, o, d, emb, z, field_t, z_f,
                                                    *c6, t=t), iters)
        out["k7_t"] = ms(lambda: fr.march_train_cuda(packed_t, cfg_t, o, d, emb, z, target, t),
                         iters)
        out["k2_f32_1024"] = ms(lambda: fr.march_cuda(p32, c32, o, d, emb, z, want_field=True),
                                iters)
        out["k2_f32_1024_t"] = ms(lambda: fr.march_cuda(p32_t, c32_t, o, d, emb, z, t,
                                                        want_field=True), iters)
        # the f32 K3, K4, K6 and K7, without and with time, at their f32
        # K2's field and fine depths; the f32 K9
        for key, cc, pp, tt in (("", c32, p32, None), ("_t", c32_t, p32_t, t)):
            f32_coarse = fr.march_cuda(pp, cc, o, d, emb, z, tt, want_field=True)
            zf32 = sample_pdf(z, f32_coarse["weights"], sf, True, rand=g)
            out["k3_f32" + key] = ms(lambda: fr.march_bwd_cuda(pp, cc, o, d, emb, z, *cot, g_field,
                                                               t=tt), iters)
            out["k4_f32" + key] = ms(lambda: fr.merged_train_cuda(
                pp, cc, o, d, emb, z, f32_coarse["field"], zf32, target, tt), iters)
            out["k6_f32" + key] = ms(lambda: fr.merged_bwd_cuda(
                pp, cc, o, d, emb, z, f32_coarse["field"], zf32, *c6, t=tt), iters)
            out["k7_f32" + key] = ms(lambda: fr.march_train_cuda(pp, cc, o, d, emb, z, target, tt),
                                     iters)
            out["k9_f32" + key] = ms(lambda: fr.hier_onepass_cuda(pp, cc, o, d, emb, z, u, target,
                                                                  tt), iters)
    # the f32 K3, K4, K6 and K7 at 8,192 rays
    n = 8192
    o, d, emb, z, g = rays(n, 35, sc)
    f32_coarse = fr.march_cuda(p32, c32, o, d, emb, z, want_field=True)
    zf32 = sample_pdf(z, f32_coarse["weights"], sf, True, rand=g)
    cot = (torch.randn(n, 3, generator=g, device=dev), torch.randn(n, generator=g, device=dev),
           torch.randn(n, generator=g, device=dev),
           0.1 * torch.randn(n, sc, generator=g, device=dev),
           0.1 * torch.randn(n, 4, sc, generator=g, device=dev))
    target = torch.rand(n, 3, generator=g, device=dev)
    out["k3_f32_8192"] = ms(lambda: fr.march_bwd_cuda(p32, c32, o, d, emb, z, *cot),
                            max(2, iters // 4))
    out["k4_f32_8192"] = ms(lambda: fr.merged_train_cuda(p32, c32, o, d, emb, z,
                                                         f32_coarse["field"], zf32, target),
                            max(2, iters // 4))
    c6 = cot[:3] + (0.1 * torch.randn(n, sc + sf, generator=g, device=dev),)
    out["k6_f32_8192"] = ms(lambda: fr.merged_bwd_cuda(p32, c32, o, d, emb, z,
                                                       f32_coarse["field"], zf32, *c6),
                            max(2, iters // 4))
    out["k7_f32_8192"] = ms(lambda: fr.march_train_cuda(p32, c32, o, d, emb, z, target),
                            max(2, iters // 4))
    del o, d, emb, z, cot, c6, target, f32_coarse, zf32
    for key, seed, s in (("", 34, sc + sf), ("_65536", 33, sc)):
        o, d, emb, z, g = rays(cfg.batch_size, seed, s)
        rep = lambda t: t[:, None, :].expand(-1, s, -1).reshape(-1, t.shape[-1]).contiguous()
        x = (o[:, None, :] + z[..., None] * d[:, None, :]).reshape(-1, 3).contiguous()
        dr, er = rep(d), rep(emb)
        g_rgb = torch.randn(x.shape[0], 3, generator=g, device=dev)
        g_sig = torch.randn(x.shape[0], 1, generator=g, device=dev)
        out["k1" + key] = ms(lambda: fm.fused_fwd_cuda(packed, cfg, x, dr, er), iters)
        out["k1_f32" + key] = ms(lambda: fm.fused_fwd_cuda(p32, c32, x, dr, er), iters)
        if not key:
            t = torch.rand(x.shape[0], 1, generator=g, device=dev)
            out["k1_t"] = ms(lambda: fm.fused_fwd_cuda(packed_t, cfg_t, x, dr, er, t), iters)
            out["k1_f32_t"] = ms(lambda: fm.fused_fwd_cuda(p32_t, c32_t, x, dr, er, t), iters)
        out["k8" + key] = ms(lambda: fm.fused_bwd_cuda(packed, cfg, x, dr, er, g_rgb, g_sig),
                             max(2, iters // 2))
        # the f32 K8, without and with time
        t = torch.rand(x.shape[0], 1, generator=g, device=dev)
        for tag, cc, pp, tt in (("", c32, p32, None), ("_t", c32_t, p32_t, t)):
            out["k8_f32" + key + tag] = ms(lambda: fm.fused_bwd_cuda(pp, cc, x, dr, er, g_rgb,
                                                                     g_sig, tt),
                                           max(2, iters // 2))
        del x, dr, er, g_rgb, g_sig, t
    # the f32 steps at the batch, chained (the tree's chip_smoke.py)
    import chip_smoke

    for key, over in (("step_f32_hier", {}), ("step_f32_coarse", {"num_importance": 0}),
                      ("step_f32_white", {"white_background": True}),
                      ("step_f32_per_sample", {"use_fused_train": False}),
                      ("step_f32_onepass", {"use_hier_onepass": True})):
        out[key] = chip_smoke.step_timing(c32.replace(**over), dev, {}, (), profile=False)[
            "chained_ms_per_step_median"]
    return out


def _time_decodes(iters):
    """ms (median of ``iters`` after a warm-up) of each fixture decode of
    this tree's tests/data_torch/ with the imported tree's decoders."""
    import time

    from danerf_tpu_torch.data.jpeg import read_jpeg
    from danerf_tpu_torch.data.png import read_png

    data = os.path.join(HERE, "tests", "data_torch")
    ms = {}
    for name in sorted(os.listdir(data)):
        read = {".jpg": read_jpeg, ".png": read_png}.get(os.path.splitext(name)[1])
        if read is None:
            continue
        try:
            read(os.path.join(data, name))
        except ValueError:
            continue                                  # a format this tree refuses
        each = []
        for _ in range(iters):
            t0 = time.perf_counter()
            read(os.path.join(data, name))
            each.append((time.perf_counter() - t0) * 1e3)
        ms[name] = statistics.median(each)
    return ms


def _worker(tree, iters, decode=False):
    here = os.path.realpath(HERE)
    sys.path[:] = [p for p in sys.path if os.path.realpath(p or ".") != here]
    sys.path.insert(0, tree)
    if decode:
        from danerf_tpu_torch.data import jpeg

        if os.path.realpath(os.path.dirname(jpeg.__file__)) != os.path.realpath(
                os.path.join(tree, "danerf_tpu_torch", "data")):
            raise RuntimeError(f"imported {jpeg.__file__}, not the tree {tree}")
        print(json.dumps({"tree": tree, "ms": _time_decodes(iters)}), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from danerf_tpu_torch.kernels import _build

    if os.path.realpath(os.path.dirname(_build.CSRC)) != os.path.realpath(
            os.path.join(tree, "danerf_tpu_torch", "kernels")):
        raise RuntimeError(f"imported {_build.CSRC}, not the tree {tree}")
    _build.build(force=True)
    print(json.dumps({"tree": tree, "ms": _time_kernels(iters)}), flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("base", nargs="?", help="the other checkout")
    ap.add_argument("--ablate", choices=sorted(ABLATIONS), default=None,
                    help="time against this tree with a part of the f32 K2/K5 tile taken out")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    ap.add_argument("--decode", action="store_true",
                    help="time the image decoders on the host instead of the kernels")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        return _worker(args.worker, args.iters, args.decode)
    if (args.base is None) == (args.ablate is None):
        ap.error("give BASE_DIR or --ablate, not both")
    base = ablated_tree(args.ablate) if args.ablate else os.path.abspath(args.base)
    trees = {"base": base, "this": HERE}
    runs = {"base": [], "this": []}
    lines = []
    for _ in range(args.rounds):
        for side in ("base", "this", "this", "base"):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                                   trees[side], "--iters", str(args.iters),
                                   *(["--decode"] if args.decode else [])],
                                  capture_output=True, text=True, timeout=900, cwd=trees[side])
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr[-4000:])
                raise SystemExit(f"kernel_ab: the {side} process failed ({proc.returncode})")
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[side].append(rec["ms"])
            lines.append(json.dumps({"side": side, **rec}))
            print(lines[-1], flush=True)
    med = {side: {k: statistics.median(r[k] for r in rs) for k in rs[0]}
           for side, rs in runs.items()}
    summary = {"median_ms": med,
               "ratio_this_over_base": {k: med["this"][k] / med["base"][k]
                                        for k in med["base"] if k in med["this"]},
               **{f"spread_{side}": {k: (min(r[k] for r in rs), max(r[k] for r in rs))
                                     for k in med[side]} for side, rs in runs.items()}}
    lines.append(json.dumps(summary))
    print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
