"""The port's depth-aware effects against danerf_tpu on the CPU: every
image primitive of ``fx/imageops.py`` (f32, rtol 1e-5 plus 1e-5 of the
output's largest magnitude; Canny's {0, 255} mask: ties may flip 0.1% of
its pixels), the 14 entries of
``EFFECTS`` with and without depth, the parameter set and names, the batch
driver over a directory of frames and the parameter-sweep previews.

Inputs are seeded numpy arrays at 96x128 and at 16x16 (where a 21-tap blur
pads 10 of 16 pixels, and the cases with a 41-tap blur pad wider than the
image).  The noise effects get the JAX draws through ``draws=``, drawn with
the JAX effects' own key splits from ``jax.random.key(0)``, the key
``danerf_tpu.fx.apply_effect`` defaults to.

Tolerance: every effect within 1 uint8 level at every pixel.  Where a
threshold or a tie decides a mask (Toon's ``grad > 0.05``, Posterize's
``e > 20``, Canny's comparisons in Neon Glow), a pixel may flip: there at
most 0.1% of the pixels may differ by more than 1 (the count is printed).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from danerf_tpu.fx import EFFECTS as J_EFFECTS
from danerf_tpu.fx import apply_effect as j_apply
from danerf_tpu.fx import default_params as j_default_params
from danerf_tpu.fx import imageops as jio
from danerf_tpu_torch.fx import EFFECTS, apply_effect, default_params
from danerf_tpu_torch.fx import imageops as io
from danerf_tpu_torch.fx.effects import levels_apart

torch.set_num_threads(2)

SIZES = {"96x128": (96, 128), "16x16": (16, 16)}


def _inputs(h, w, seed=0):
    """A seeded uint8 image and a depth map with smooth structure and edges
    (a step at a third of the width) plus a little noise, in [0, 1]."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    depth = 0.45 + 0.25 * np.sin(xx / 7.0) * np.cos(yy / 5.0) + 0.05 * rng.random((h, w))
    depth[:, w // 3:] += 0.2
    return img, np.clip(depth, 0, 1).astype(np.float32)


def jax_draws(name, h, w, key=None):
    """The draws danerf_tpu.fx's noise effects take from ``key``, with
    their own splits (Night Vision and Film Grain: normal(key); Hologram:
    split into a noise and a streak key, fold_in(streak key, 1) for the
    widths)."""
    key = jax.random.key(0) if key is None else key
    if name == "Night Vision":
        return {"normal": np.asarray(jax.random.normal(key, (h, w)))}
    if name == "Film Grain":
        return {"normal": np.asarray(jax.random.normal(key, (h, w, 3)))}
    if name == "Hologram":
        k_noise, k_lines = jax.random.split(key)
        return {"normal": np.asarray(jax.random.normal(k_noise, (h, w, 3))),
                "xs": np.asarray(jax.random.randint(k_lines, (3,), 0, w)),
                "widths": np.asarray(jax.random.randint(jax.random.fold_in(k_lines, 1), (3,),
                                                        2, 6))}
    return {}


def assert_levels(name, got, want, tag=""):
    """Within 1 level everywhere; a thresholded effect may flip <= 0.1% of
    its pixels by more (``effects.levels_apart``, which chip_smoke.py also
    holds the card to)."""
    apart = levels_apart(name, np.asarray(got), np.asarray(want))
    print(f"{name} {tag}: {apart}")
    assert apart["ok"], f"{name} {tag}: {apart}"


# ------------------------------------------------------------- primitives

@pytest.mark.parametrize("n", [1, 2, 3, 5, 16])
@pytest.mark.parametrize("pad", [0, 1, 4, 10, 20])
def test_reflect_index_matches_numpy(n, pad):
    want = np.pad(np.arange(n), pad, mode="reflect")
    np.testing.assert_array_equal(io.reflect_index(n, pad).numpy(), want)


def _prim_cases():
    k = np.random.default_rng(5).normal(size=(5, 3)).astype(np.float32)
    return {
        "conv2d": (lambda m, x: m.conv2d(x, k if m is io else jax.numpy.asarray(k)), "rgb"),
        "gaussian_blur5": (lambda m, x: m.gaussian_blur(x, 5, 0.0), "rgb"),
        "gaussian_blur21": (lambda m, x: m.gaussian_blur(x, 21, 0.0), "rgb"),
        "gaussian_blur41": (lambda m, x: m.gaussian_blur(x, 41, 0.0), "rgb"),
        "gaussian_blur7_sigma2": (lambda m, x: m.gaussian_blur(x, 7, 2.0), "gray"),
        "sobel_magnitude": (lambda m, x: m.sobel_magnitude(x), "depth"),
        "laplacian": (lambda m, x: m.laplacian(x), "gray"),
        "dilate3": (lambda m, x: m.dilate3(x, 2), "depth"),
        "bilateral_filter": (lambda m, x: m.bilateral_filter(x, 9, 75.0, 75.0), "depth"),
        "rgb_to_hsv_u8": (lambda m, x: m.rgb_to_hsv_u8(x), "rgb"),
        "hsv_round_trip": (lambda m, x: m.hsv_to_rgb_u8(*m.rgb_to_hsv_u8(x)), "rgb"),
        "rgb_to_gray": (lambda m, x: m.rgb_to_gray(x), "rgb"),
        "equalize_hist_u8": (lambda m, x: m.equalize_hist_u8(x), "gray"),
        "canny_simple": (lambda m, x: m.canny_simple(x, 50.0, 150.0), "gray"),
    }


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("prim", list(_prim_cases()))
def test_imageops_match_jax(prim, size):
    fn, kind = _prim_cases()[prim]
    img, depth = _inputs(*SIZES[size])
    x = {"rgb": img.astype(np.float32), "depth": depth * 255.0,
         "gray": np.asarray(jio.rgb_to_gray(img.astype(np.float32)))}[kind]
    if prim == "dilate3":
        x = depth
    want = fn(jio, jax.numpy.asarray(x))
    got = fn(io, torch.from_numpy(np.array(x)))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        w = np.asarray(w)
        # signed taps (conv2d, Sobel, Laplacian) cancel to near zero, where
        # only an error relative to the output's scale means anything
        scale = max(float(np.abs(w).max()), 1.0)
        if prim == "canny_simple":  # a {0, 255} mask: ties may flip <= 0.1%
            assert np.count_nonzero(g.numpy() != w) <= 0.001 * w.size
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5 * scale, err_msg=prim)


# ------------------------------------------------------------- effects

@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("with_depth", [True, False], ids=["depth", "no_depth"])
@pytest.mark.parametrize("name", list(J_EFFECTS))
def test_effect_matches_jax(name, with_depth, size):
    h, w = SIZES[size]
    img, depth = _inputs(h, w)
    dep = depth if with_depth else None
    want = np.asarray(j_apply(name, img, dep))
    got = apply_effect(name, img, dep, draws=jax_draws(name, h, w), device="cpu")
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert_levels(name, got.numpy(), want, f"{size} {'depth' if with_depth else ''}")


# a 41-tap blur at 16x16 pads 20 pixels on a 16-pixel axis
OVERRIDES = [("Toon Shader", {"toon_levels": 8, "toon_edge_strength": 0.5}),
             ("Fog", {"fog_start": 0.3, "fog_color_r": 10, "fog_exponent": 2.0}),
             ("Bloom", {"bloom_size": 40, "bloom_strength": 0.6}),
             ("Neon Glow", {"neon_glow_radius": 20, "neon_glow_intensity": 1.0}),
             ("Hologram", {"hologram_lines": 7}),
             ("Film Grain", {"film_grain_amount": 0.5}),
             ("Pencil Sketch", {"sketch_strength": 0.4}),
             ("Posterize", {"posterize_levels": 7}),
             ("Color Boost", {"color_saturation": 2.5}),
             ("Vignette", {"vignette_strength": 1.5})]


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("name,params", OVERRIDES, ids=[n for n, _ in OVERRIDES])
def test_params_override_matches_jax(name, params, size):
    h, w = SIZES[size]
    img, depth = _inputs(h, w, seed=3)
    want = np.asarray(j_apply(name, img, depth, params))
    got = apply_effect(name, img, depth, params, draws=jax_draws(name, h, w), device="cpu")
    assert_levels(name, got.numpy(), want, size)
    base = apply_effect(name, img, depth, draws=jax_draws(name, h, w), device="cpu")
    assert not torch.equal(got, base)


def test_default_params_and_names_match_jax():
    assert default_params() == j_default_params() and len(default_params()) == 21
    assert list(EFFECTS) == list(J_EFFECTS) and len(EFFECTS) == 14
    img, depth = _inputs(16, 16)
    for slug, name in (("fog", "Fog"), ("toon_shader", "Toon Shader"),
                       ("neon-glow", "Neon Glow"), ("PENCIL_SKETCH", "Pencil Sketch")):
        assert torch.equal(apply_effect(slug, img, depth, device="cpu"),
                           apply_effect(name, img, depth, device="cpu"))
        np.testing.assert_array_equal(np.asarray(j_apply(slug, img, depth)),
                                      np.asarray(j_apply(name, img, depth)))
    with pytest.raises(KeyError) as want:
        j_apply("nope", img)
    with pytest.raises(KeyError) as got:
        apply_effect("nope", img, device="cpu")
    assert str(got.value) == str(want.value)


def test_noise_effects_draw_from_the_generator():
    """Without draws the noise effects draw from the generator (seed 0 by
    default): the same seed gives the same frame, another seed another; a
    (H, W, 1) depth reads as (H, W); a tensor stays on its device."""
    img, depth = _inputs(16, 16)
    for name in ("Night Vision", "Film Grain", "Hologram"):
        a = apply_effect(name, img, depth, device="cpu")
        b = apply_effect(name, img, depth, generator=torch.Generator().manual_seed(0),
                         device="cpu")
        c = apply_effect(name, img, depth, generator=torch.Generator().manual_seed(1),
                         device="cpu")
        assert torch.equal(a, b) and not torch.equal(a, c), name
    t = apply_effect("Toon Shader", torch.from_numpy(img), torch.from_numpy(depth[..., None]))
    assert t.device.type == "cpu"
    assert torch.equal(t, apply_effect("Toon Shader", img, depth, device="cpu"))


# ------------------------------------------------------------- batch driver

def _write_frames(d, n=3, with_depth=(0, 2), size=(16, 16)):
    from danerf_tpu_torch.viz.png import write_png

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        write_png(os.path.join(d, f"frame_{i:04d}.png"),
                  rng.integers(0, 255, size + (3,), dtype=np.uint8))
        if i in with_depth:
            write_png(os.path.join(d, f"depth_{i:04d}.png"),
                      rng.integers(0, 255, size, dtype=np.uint8))


def _decode(path):
    from danerf_tpu_torch.data.png import read_png

    return read_png(path)


@pytest.mark.parametrize("name", ["Sepia", "Fog", "Toon Shader", "Neon Glow"])
def test_apply_effect_to_frames_matches_jax(tmp_path, name):
    """Frame for frame against the JAX batch driver; Fog only on the frames
    with a depth map; the port's video beside the output directory."""
    from danerf_tpu.fx.batch import apply_effect_to_frames as j_frames
    from danerf_tpu_torch.fx.batch import apply_effect_to_frames, find_frames_with_depth
    from danerf_tpu_torch.viz.video import read_avi

    src = str(tmp_path / "in")
    _write_frames(src, 3, with_depth=(0, 2), size=(20, 24))
    assert find_frames_with_depth(src) == ["0000", "0002"]
    want = j_frames(src, str(tmp_path / "jax" / "out"), name, make_video=False)
    got = apply_effect_to_frames(src, str(tmp_path / "port" / "out"), name, device="cpu")
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == (2 if name == "Fog" else 3)
    for g, w in zip(got, want):
        assert_levels(name, _decode(g), _decode(w), os.path.basename(g))
    video = tmp_path / "port" / f"{name.lower().replace(' ', '_')}.avi"
    frames, fps = read_avi(str(video))
    assert frames.shape == (len(got), 20, 24, 3) and fps == 60
    for frame, path in zip(frames, got):
        np.testing.assert_array_equal(frame, _decode(path))


def test_batch_skip_existing_and_timings(tmp_path):
    """Output paths stay in frame order around a frame that exists already;
    timings count the frames computed; a second run writes nothing, the
    video included."""
    from danerf_tpu_torch.fx.batch import apply_effect_to_frames
    from danerf_tpu_torch.viz.png import write_png

    src = str(tmp_path / "in")
    _write_frames(src, 4, with_depth=())
    out = tmp_path / "fx" / "out"
    os.makedirs(out)
    write_png(str(out / "frame_0001.png"), np.zeros((16, 16, 3), np.uint8))
    tm = {}
    w = apply_effect_to_frames(src, str(out), "Sepia", timings=tm, device="cpu")
    assert [os.path.basename(p) for p in w] == [f"frame_{i:04d}.png" for i in range(4)]
    assert tm["frames"] == 3 and set(tm) == {"load_s", "device_s", "write_s", "frames"}
    assert tm["load_s"] >= 0 and tm["device_s"] > 0 and tm["write_s"] > 0
    assert not _decode(str(out / "frame_0001.png")).any()   # skipped, not overwritten
    video = tmp_path / "fx" / "sepia.avi"
    stamps = {p: os.path.getmtime(p) for p in [video, *out.iterdir()]}
    tm = {}
    apply_effect_to_frames(src, str(out), "Sepia", timings=tm, device="cpu")
    assert tm["frames"] == 0 and {p: os.path.getmtime(p) for p in stamps} == stamps
    with pytest.raises(KeyError, match="unknown effect"):
        apply_effect_to_frames(src, str(out), "fog", device="cpu")


def test_apply_all_effects_matches_jax(tmp_path):
    """Every effect, one directory and one video each, against the JAX
    driver: the noise effects by their files (their draws differ: the JAX
    driver draws from key(0), the port from a seed-0 generator), the rest
    pixel for pixel; then skip and fog_only."""
    pytest.importorskip("cv2")   # the JAX driver writes its videos through OpenCV
    from danerf_tpu.fx.batch import apply_all_effects as j_all
    from danerf_tpu_torch.fx.batch import apply_all_effects

    src = str(tmp_path / "in")
    _write_frames(src, 3, with_depth=(0, 2))
    names = apply_all_effects(src, str(tmp_path / "port"), device="cpu")
    assert names == j_all(src, str(tmp_path / "jax")) == list(EFFECTS)
    for name in names:
        slug = name.lower().replace(" ", "_")
        got = sorted(os.listdir(tmp_path / "port" / slug))
        assert got == sorted(os.listdir(tmp_path / "jax" / slug))
        assert (tmp_path / "port" / f"{slug}.avi").exists()
        for f in got:
            g = _decode(str(tmp_path / "port" / slug / f))
            w = _decode(str(tmp_path / "jax" / slug / f))
            if name in ("Night Vision", "Film Grain", "Hologram"):
                assert g.shape == w.shape
            else:
                assert_levels(name, g, w, f)
    assert apply_all_effects(src, str(tmp_path / "skip"), skip=["Fog", "Sepia"],
                             device="cpu") == [n for n in EFFECTS if n not in ("Fog", "Sepia")]
    assert apply_all_effects(src, str(tmp_path / "fog"), fog_only=True, device="cpu") == ["Fog"]
    assert sorted(os.listdir(tmp_path / "fog" / "fog")) == ["frame_0000.png", "frame_0002.png"]


# ------------------------------------------------------------- previews

SPEC = {"effects": [{"name": "Fog", "sweep": {"fog_start": [0.0, 0.2, 0.4]}},
                    {"name": "Toon Shader", "params": {"toon_levels": 8}},
                    {"name": "Bloom", "params": {"bloom_strength": 0.5},
                     "sweep": {"bloom_size": [5, 9], "vignette_strength": [0.1, 0.2]}}]}


def test_expand_spec_matches_jax():
    from danerf_tpu.fx.preview import expand_spec as j_expand
    from danerf_tpu_torch.fx.preview import expand_spec

    assert list(expand_spec(SPEC)) == list(j_expand(SPEC))
    assert len(list(expand_spec(SPEC))) == 3 + 1 + 4
    with pytest.raises(KeyError, match="unknown effect"):
        list(expand_spec({"effects": [{"name": "fog"}]}))


def test_previews_and_manifest_match_jax(tmp_path):
    """preview_from_files on a written frame and depth: the same file names
    and manifest.json as the JAX previews, the pixels within the effects'
    tolerance."""
    from danerf_tpu.fx.preview import preview_from_files as j_preview
    from danerf_tpu_torch.fx.preview import preview_from_files

    src = str(tmp_path / "in")
    _write_frames(src, 1, with_depth=(0,), size=(24, 20))
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(SPEC))
    args = (os.path.join(src, "frame_0000.png"), os.path.join(src, "depth_0000.png"), str(spec))
    want = j_preview(*args, str(tmp_path / "jax"))
    got = preview_from_files(*args, str(tmp_path / "port"), device="cpu")
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert "fog__fog_start=0.2.png" in {os.path.basename(p) for p in got}
    assert (json.loads((tmp_path / "port" / "manifest.json").read_text())
            == json.loads((tmp_path / "jax" / "manifest.json").read_text()))
    for g, w in zip(got, want):
        assert_levels(os.path.basename(g).split("__")[0], _decode(g), _decode(w))
