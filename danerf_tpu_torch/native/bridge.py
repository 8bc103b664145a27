"""Python <-> native shader_processor bridge (counterpart of
danerf_tpu/native/bridge.py).

The native tool (``native/shader_processor``, C++ on libpng and libjpeg,
headless) runs one image through a shader file's ``// effect:`` and ``//
param:`` directives: ``shader_processor --input IN.png --output OUT.png
--shader S.frag [--depth D.png] [--param k=v ...]``.  ``ShaderBridge``
writes the default, toon and fog ``.frag`` files on first use and sends
each image through the binary as PNG temp files (the port's own PNG writer
and decoder: no imaging library), the depth normalised to uint8 as the JAX
bridge does.  Where the binary is missing or fails, the effect runs through
``danerf_tpu_torch.fx.apply_effect`` on the bridge's device (the card
unless the caller asks for the CPU), with the JAX bridge's name mapping
and warnings.

``ensure_built`` configures the sources, which it only reads, with CMake
(and Ninja) into ``build/shader_processor/`` at the repository root (listed
in ``.gitignore``), under a file lock so that concurrent processes build
once; the binary is found at ``$DANERF_SHADER_PROCESSOR``, then in that
build tree, then on ``PATH``.
"""

from __future__ import annotations

import fcntl
import os
import shutil
import subprocess
import tempfile
import warnings
from typing import Optional

import numpy as np
import torch

_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native", "shader_processor")
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "shader_processor")


def _default_binary() -> str:
    """The native binary: $DANERF_SHADER_PROCESSOR, then this checkout's
    build tree (built, or buildable by ``ensure_built``), then a
    ``shader_processor`` on PATH."""
    env = os.environ.get("DANERF_SHADER_PROCESSOR")
    if env:
        return env
    built = os.path.join(BUILD_DIR, "shader_processor")
    if os.path.exists(built) or os.path.isdir(_NATIVE_DIR):
        return built
    return shutil.which("shader_processor") or built


DEFAULT_BINARY = _default_binary()

# Shader files written on first run (the JAX bridge's): GLSL-shaped, with
# the directives the headless tool executes.
DEFAULT_FRAG = """\
// effect: passthrough
#version 330 core
out vec4 FragColor;
in vec2 TexCoord;
uniform sampler2D u_texture;
void main() { FragColor = texture(u_texture, TexCoord); }
"""

TOON_FRAG = """\
// effect: toon
// param: levels=4
// param: edge_threshold=0.1
#version 330 core
out vec4 FragColor;
in vec2 TexCoord;
uniform sampler2D u_texture;
uniform sampler2D u_depth;
uniform float u_levels = 4.0;
uniform float u_edge_threshold = 0.1;
void main() {
    vec4 color = texture(u_texture, TexCoord);
    color.rgb = floor(color.rgb * u_levels) / u_levels;
    float d  = texture(u_depth, TexCoord).r;
    float dr = texture(u_depth, TexCoord + vec2(0.001, 0.0)).r;
    float db = texture(u_depth, TexCoord + vec2(0.0, 0.001)).r;
    float edge = step(u_edge_threshold, abs(d - dr) + abs(d - db));
    color.rgb *= (1.0 - edge);
    FragColor = color;
}
"""

FOG_FRAG = """\
// effect: fog
// param: fog_start=0.1
// param: fog_exponent=3.0
// param: fog_visibility=0.3
#version 330 core
out vec4 FragColor;
in vec2 TexCoord;
uniform sampler2D u_texture;
uniform sampler2D u_depth;
void main() {
    vec3 c = texture(u_texture, TexCoord).rgb;
    float d = texture(u_depth, TexCoord).r;
    float adj = clamp((d - 0.1) / 0.9, 0.0, 1.0);
    adj = pow(adj, 3.0) * 0.3;
    FragColor = vec4(mix(vec3(1.0), c, adj), 1.0);
}
"""


def ensure_built(binary: str = DEFAULT_BINARY, quiet: bool = True) -> Optional[str]:
    """Build the native tool if ``binary`` is missing: CMake configures
    ``native/shader_processor`` (read only) into the binary's directory
    with Ninja (CMake's default generator where there is no Ninja) and
    builds it, under an exclusive lock on ``<dir>.lock``.  Returns the
    binary's path, or None when the build fails (cmake, a build tool, a
    compiler, libpng or libjpeg missing); callers then take the fx
    fallback.  A failed configure leaves no CMake cache behind, so a later
    call configures afresh."""
    if os.path.exists(binary):
        return binary
    build_dir = os.path.dirname(os.path.abspath(binary))
    os.makedirs(os.path.dirname(build_dir), exist_ok=True)
    with open(build_dir + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(binary):   # another process built it meanwhile
            return binary
        try:
            kw = dict(capture_output=quiet, check=True)
            gen = ["-G", "Ninja"] if shutil.which("ninja") else []
            subprocess.run(["cmake", "-S", _NATIVE_DIR, "-B", build_dir, *gen], **kw)
            subprocess.run(["cmake", "--build", build_dir], **kw)
        except (subprocess.CalledProcessError, FileNotFoundError):
            cache = os.path.join(build_dir, "CMakeCache.txt")
            if os.path.exists(cache):
                os.remove(cache)
            return None
    return binary if os.path.exists(binary) else None


def _png_in(path: str, img) -> None:
    from danerf_tpu_torch.viz.png import write_png

    if torch.is_tensor(img):
        img = img.cpu().numpy()
    write_png(path, np.asarray(img, np.uint8))


def _depth_u8(depth) -> np.ndarray:
    """The depth as the tool reads it: min-max normalised, times 255,
    truncated to uint8 (the JAX bridge's arithmetic, in f32)."""
    if torch.is_tensor(depth):
        depth = depth.cpu().numpy()
    d = np.asarray(depth, np.float32)
    d = (d - d.min()) / (d.max() - d.min() + 1e-10)
    return (d * 255).astype(np.uint8)


class ShaderBridge:
    """Subprocess interface to the native shader_processor.

    ``device``: where the fx fallback runs (``resolve_device`` when it
    runs: the card unless the caller asks for the CPU)."""

    def __init__(self, binary_path: Optional[str] = None, shader_dir: str = "shaders",
                 auto_build: bool = True, device="cuda"):
        self.binary = binary_path or DEFAULT_BINARY
        self.shader_dir = shader_dir
        self.device = device
        if not os.path.exists(self.shader_dir):
            os.makedirs(self.shader_dir, exist_ok=True)
            self._write_default_shaders()
        if not os.path.exists(self.binary) and auto_build:
            ensure_built(self.binary)
        self.use_native = os.path.exists(self.binary)
        # the effect chosen, kept across frames (as the JAX bridge keeps it)
        self.current_effect: Optional[str] = None
        self.params: dict = {}

    def _write_default_shaders(self):
        for name, text in [("default.frag", DEFAULT_FRAG), ("toon.frag", TOON_FRAG),
                           ("fog.frag", FOG_FRAG)]:
            with open(os.path.join(self.shader_dir, name), "w") as f:
                f.write(text)

    def available_shaders(self):
        if not os.path.isdir(self.shader_dir):
            return []
        return sorted(f for f in os.listdir(self.shader_dir) if f.endswith((".frag", ".glsl")))

    def apply_shader(self, image, depth=None, shader_name: str = "default.frag",
                     params: Optional[dict] = None) -> np.ndarray:
        """Run one uint8 image (H, W[, C]) through the native tool, with the
        depth (H, W) when given; the fx fallback where the tool is missing
        or fails.  Returns the result as a numpy uint8 array."""
        shader_path = os.path.join(self.shader_dir, shader_name)
        if not os.path.exists(shader_path):
            if not self.use_native:
                # the fallback resolves effects by name, so a missing file
                # is fine there (it warns when the name is unknown too)
                return self._apply_fallback(image, depth, shader_name, params)
            warnings.warn(f"shader file {shader_path!r} not found; using "
                          f"default.frag (passthrough)", stacklevel=2)
            shader_path = os.path.join(self.shader_dir, "default.frag")

        if not self.use_native:
            return self._apply_fallback(image, depth, shader_name, params)

        from danerf_tpu_torch.data.png import read_png
        from danerf_tpu_torch.viz.png import write_png

        with tempfile.TemporaryDirectory() as td:
            in_path = os.path.join(td, "in.png")
            out_path = os.path.join(td, "out.png")
            _png_in(in_path, image)
            cmd = [self.binary, "--input", in_path, "--output", out_path,
                   "--shader", shader_path]
            if depth is not None:
                depth_path = os.path.join(td, "depth.png")
                write_png(depth_path, _depth_u8(depth))
                cmd += ["--depth", depth_path]
            for k, v in (params or {}).items():
                cmd += ["--param", f"{k}={v}"]
            try:
                subprocess.run(cmd, check=True, capture_output=True)
                return read_png(out_path)
            except (subprocess.CalledProcessError, FileNotFoundError, OSError, ValueError) as e:
                detail = ""
                if isinstance(e, subprocess.CalledProcessError) and e.stderr:
                    detail = ": " + e.stderr.decode(errors="replace").strip()
                warnings.warn(f"native shader_processor failed on "
                              f"{shader_name!r}{detail}; falling back to the "
                              f"Python fx pipeline", stacklevel=2)
                return self._apply_fallback(image, depth, shader_name, params)

    @staticmethod
    def parse_directives(shader_path: str):
        """The ``// effect:`` name and ``// param: k=v`` values (floats) of a
        shader file, which the native tool executes, so the fallback honours
        the same contract: (effect or None, {name: value})."""
        effect, dparams = None, {}
        try:
            with open(shader_path) as f:
                for line in f:
                    line = line.strip()
                    if line.startswith("// effect:"):
                        effect = line.split(":", 1)[1].strip()
                    elif line.startswith("// param:"):
                        kv = line.split(":", 1)[1].strip()
                        if "=" in kv:
                            k, v = kv.split("=", 1)
                            try:
                                dparams[k.strip()] = float(v)
                            except ValueError:
                                pass
        except OSError:
            pass
        return effect, dparams

    def _apply_fallback(self, image, depth, shader_name, params):
        """The fx fallback: the effect of the shader file's ``// effect:``
        directive, else the file name's stem, with the file's parameters
        under the caller's, through ``apply_effect`` on the bridge's device.
        An effect fx does not implement returns the image unprocessed, with
        a warning that names the shader."""
        from danerf_tpu_torch import resolve_device
        from danerf_tpu_torch.fx import apply_effect

        effect, dparams = self.parse_directives(os.path.join(self.shader_dir, shader_name))
        name = effect or shader_name.rsplit(".", 1)[0].lower()
        merged = dict(dparams)
        if params:
            merged.update(params)
        fx_name = {"toon": "Toon Shader", "sketch": "Pencil Sketch",
                   "passthrough": "Original", "default": "Original"}.get(name, name)
        try:
            return apply_effect(fx_name, image, depth, merged,
                                device=resolve_device(self.device)).cpu().numpy()
        except KeyError:
            warnings.warn(
                f"shader {shader_name!r} (effect {name!r}) has no Python fx "
                f"fallback; returning the image UNPROCESSED. Build the native "
                f"tool (danerf_tpu_torch.native.ensure_built) to run it.",
                stacklevel=2)
            return image.cpu().numpy() if torch.is_tensor(image) else np.asarray(image)
