"""Headless effect preview (counterpart of danerf_tpu/fx/preview.py): a
JSON spec of effects and parameter sweeps in, one preview PNG per
(effect, parameters) and a ``manifest.json`` out.

Spec format::

    {
      "effects": [
        {"name": "Fog", "sweep": {"fog_start": [0.0, 0.2, 0.4]}},
        {"name": "Toon Shader", "params": {"toon_levels": 8}}
      ]
    }
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Optional

import numpy as np

from danerf_tpu_torch import resolve_device
from danerf_tpu_torch.fx.batch import load_depth
from danerf_tpu_torch.fx.effects import EFFECTS, apply_effect, default_params
from danerf_tpu_torch.viz.png import write_png
from danerf_tpu_torch.viz.video import load_rgb


def _slug(name: str, params: dict) -> str:
    parts = [name.lower().replace(" ", "_")]
    parts += [f"{k}={v:g}" for k, v in sorted(params.items())]
    return "__".join(parts)


def expand_spec(spec: dict):
    """Yield (effect_name, params) combos from a preview spec."""
    for entry in spec.get("effects", []):
        name = entry["name"]
        if name not in EFFECTS:
            raise KeyError(f"unknown effect {name!r}")
        base = dict(entry.get("params", {}))
        sweep = entry.get("sweep", {})
        if not sweep:
            yield name, base
            continue
        keys = sorted(sweep)
        for combo in itertools.product(*(sweep[k] for k in keys)):
            p = dict(base)
            p.update(dict(zip(keys, combo)))
            yield name, p


def render_previews(image: np.ndarray, depth: Optional[np.ndarray], spec: dict,
                    output_dir: str, device="cuda") -> list[str]:
    """Write one preview PNG per (effect, parameter combo); returns paths."""
    dev = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    written, manifest = [], []
    for name, params in expand_spec(spec):
        out = apply_effect(name, image, depth, params, device=dev).cpu().numpy()
        path = os.path.join(output_dir, _slug(name, params) + ".png")
        write_png(path, out)
        written.append(path)
        # the manifest records the full parameter set of each preview
        full = default_params()
        full.update(params)
        manifest.append({"effect": name, "path": os.path.basename(path), "params": full})
    with open(os.path.join(output_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return written


def preview_from_files(image_path: str, depth_path: Optional[str], spec_path: str,
                       output_dir: str, device="cuda") -> list[str]:
    image = load_rgb(image_path)
    depth = load_depth(depth_path) if depth_path else None
    with open(spec_path) as f:
        spec = json.load(f)
    return render_previews(image, depth, spec, output_dir, device=device)
