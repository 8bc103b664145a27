"""The port's native bridge (danerf_tpu_torch/native/bridge.py) against the
JAX package's danerf_tpu.native.bridge on the CPU.

Both bridges run the same binary: the port builds it (``ensure_built``, into
the gitignored ``build/shader_processor/``, under a file lock) and the JAX
bridge is handed it (``binary_path=``, ``auto_build=False``).  The JAX
``ensure_built`` is never called here: it builds into
``native/shader_processor/build/``, which tests/test_native.py builds at
import, and two builds there would race.  The native outputs and the
depth PNG the tool reads must be equal pixel for pixel (the same tool on
the same pixels); the fx fallback runs on ``device="cpu"`` on deterministic
effects and is held to ``fx.effects.levels_apart``, the port's effect
tolerance against danerf_tpu.fx.
"""

import os
import subprocess

import numpy as np
import pytest
import torch

from danerf_tpu.native import bridge as jb
from danerf_tpu_torch.fx.effects import levels_apart
from danerf_tpu_torch.native import bridge as tb

torch.set_num_threads(2)

SHADERS = {"default.frag": "Original", "toon.frag": "Toon Shader", "fog.frag": "Fog"}


@pytest.fixture(scope="module")
def binary():
    path = tb.ensure_built(os.path.join(tb.BUILD_DIR, "shader_processor"))
    if path is None:
        pytest.skip("the native tool does not build here (cmake, Ninja, a C++ compiler, "
                    "libpng or libjpeg missing)")
    return path


def _inputs(seed=0, h=24, w=20):
    """A seeded RGB image and a depth with a smooth ramp and a step."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    depth = np.linspace(2.0, 5.0, h * w, dtype=np.float32).reshape(h, w)
    depth[:, w // 2:] += 1.5
    return img, depth


def _bridges(tmp_path, binary_path):
    port = tb.ShaderBridge(binary_path=str(binary_path), shader_dir=str(tmp_path / "port"),
                           auto_build=False, device="cpu")
    ref = jb.ShaderBridge(binary_path=str(binary_path), shader_dir=str(tmp_path / "jax"),
                          auto_build=False)
    return port, ref


def test_builds_into_its_own_tree(binary):
    """The binary lies in the port's build tree under build/, never in
    native/shader_processor/build/; a second call finds it."""
    assert binary == os.path.join(tb.BUILD_DIR, "shader_processor")
    assert os.path.commonpath([binary, tb._REPO_ROOT + "/build"]) == tb._REPO_ROOT + "/build"
    assert os.access(binary, os.X_OK)
    assert tb.ensure_built(binary) == binary


def test_default_binary_lookup(monkeypatch):
    """$DANERF_SHADER_PROCESSOR first, then the checkout's build tree."""
    monkeypatch.setenv("DANERF_SHADER_PROCESSOR", "/opt/tools/shader_processor")
    assert tb._default_binary() == "/opt/tools/shader_processor"
    monkeypatch.delenv("DANERF_SHADER_PROCESSOR")
    assert tb._default_binary() == os.path.join(tb.BUILD_DIR, "shader_processor")


@pytest.mark.parametrize("shader,params", [("default.frag", None), ("toon.frag", None),
                                           ("toon.frag", {"levels": 3}), ("fog.frag", None)],
                         ids=["default", "toon", "toon_levels3", "fog"])
@pytest.mark.parametrize("with_depth", [True, False], ids=["depth", "no_depth"])
def test_native_outputs_match_jax(binary, tmp_path, monkeypatch, shader, params, with_depth):
    """The same binary through both bridges: equal outputs, and the depth
    PNG the tool reads decodes to the same pixels."""
    Image = pytest.importorskip("PIL.Image")
    depth_pngs = []
    run = subprocess.run

    def spy(cmd, *a, **kw):
        if "--depth" in cmd:
            with Image.open(cmd[cmd.index("--depth") + 1]) as im:
                depth_pngs.append(np.asarray(im))
        return run(cmd, *a, **kw)

    monkeypatch.setattr(subprocess, "run", spy)
    port, ref = _bridges(tmp_path, binary)
    assert port.use_native and ref.use_native
    img, depth = _inputs()
    d = depth if with_depth else None
    want = ref.apply_shader(img, d, shader, params)
    got = port.apply_shader(img, d, shader, params)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert len(depth_pngs) == (2 if with_depth else 0)
    if with_depth:
        np.testing.assert_array_equal(depth_pngs[1], depth_pngs[0])
        assert depth_pngs[1].min() == 0 and depth_pngs[1].max() == 255


def test_default_shaders_and_directives_match_jax(tmp_path):
    """The three .frag files are written as the JAX bridge writes them, and
    parse_directives reads every file (and a missing one) the same way."""
    port, ref = _bridges(tmp_path, tmp_path / "no_binary")
    assert port.available_shaders() == ref.available_shaders() == sorted(SHADERS)
    for name in SHADERS:
        with open(os.path.join(port.shader_dir, name)) as f, \
                open(os.path.join(ref.shader_dir, name)) as g:
            assert f.read() == g.read()
    odd = tmp_path / "odd.frag"
    odd.write_text("// effect:  Neon-Glow \n// param: glow_strength = 2.5\n// param: bad=x\n"
                   "// param: noequals\n//param: tight=1\n void main() {}\n")
    for path in [os.path.join(port.shader_dir, n) for n in SHADERS] + [str(odd),
                                                                       str(tmp_path / "gone")]:
        assert tb.ShaderBridge.parse_directives(path) == jb.ShaderBridge.parse_directives(path)
    assert tb.ShaderBridge.parse_directives(str(odd)) == ("Neon-Glow", {"glow_strength": 2.5})


@pytest.mark.parametrize("shader,params", [("default.frag", None), ("toon.frag", None),
                                           ("fog.frag", None), ("fog.frag", {"fog_start": 0.3}),
                                           ("sepia.frag", None)],
                         ids=["default", "toon", "fog", "fog_start", "sepia_by_name"])
def test_fallback_matches_jax(tmp_path, shader, params):
    """Without a binary both bridges take their fx pipelines (the port's on
    the CPU): the effect of the file's directive, or of the file name when
    there is no file (sepia), with the file's parameters under the
    caller's; held to levels_apart."""
    port, ref = _bridges(tmp_path, tmp_path / "no_binary")
    assert not port.use_native and not ref.use_native
    img, depth = _inputs(1)
    d01 = (depth - depth.min()) / (depth.max() - depth.min())
    want = ref.apply_shader(img, d01, shader, params)
    got = port.apply_shader(img, d01, shader, params)
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    name = SHADERS.get(shader, "Sepia")
    assert levels_apart(name, got, np.asarray(want))["ok"], levels_apart(name, got, want)


def test_unknown_effect_warns_and_returns_the_image(tmp_path):
    """An effect fx does not implement: both warn with the same words and
    return the image unprocessed."""
    port, ref = _bridges(tmp_path, tmp_path / "no_binary")
    for b in (port, ref):
        with open(os.path.join(b.shader_dir, "wobble.frag"), "w") as f:
            f.write("// effect: wobble\nvoid main() {}\n")
    img, _ = _inputs(2)
    msg = r"shader 'wobble.frag' \(effect 'wobble'\) has no Python fx fallback; returning " \
          r"the image UNPROCESSED\. Build the native tool \(danerf_tpu(_torch)?\.native"
    for b in (ref, port):
        with pytest.warns(UserWarning, match=msg):
            np.testing.assert_array_equal(b.apply_shader(img, None, "wobble.frag"), img)


def test_missing_shader_file_warns_and_passes_through(binary, tmp_path):
    """With the binary, a shader file that does not exist: both warn and run
    default.frag (passthrough)."""
    port, ref = _bridges(tmp_path, binary)
    img, depth = _inputs(3)
    outs = []
    for b in (ref, port):
        with pytest.warns(UserWarning, match=r"not found; using default\.frag \(passthrough\)"):
            outs.append(b.apply_shader(img, depth, "absent.frag"))
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1], img)


def test_failing_binary_falls_back(tmp_path):
    """A binary that fails: both warn with its error output and take the fx
    fallback."""
    tool = tmp_path / "broken_tool"
    tool.write_text("#!/bin/sh\necho 'cannot open display' >&2\nexit 3\n")
    tool.chmod(0o755)
    port, ref = _bridges(tmp_path, tool)
    assert port.use_native and ref.use_native
    img, depth = _inputs(4)
    d01 = (depth - depth.min()) / (depth.max() - depth.min())
    outs = []
    for b in (ref, port):
        with pytest.warns(UserWarning, match=r"native shader_processor failed on 'toon\.frag': "
                                             r"cannot open display; falling back"):
            outs.append(np.asarray(b.apply_shader(img, d01, "toon.frag")))
    assert levels_apart("Toon Shader", outs[1], outs[0])["ok"]
