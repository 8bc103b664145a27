"""The port's counterparts of the repository's example scripts
(``examples/*.py``, which run the JAX package): the reference-native
full-scale study (``full_scale``, then ``measure_io_overlap`` on its
output), the 64 + 64 and coarse-only demos (``hier_demo``,
``demo_synthetic``), one model per scene (``multi_scene``), and the parity
studies against the reference's training semantics: the multi-seed study
(``parity_study``, whose H100 report is ``parity_report_h100.json``) and the
single-seed same-data run (``parity_chair``), both on the reference trainer
of ``danerf_tpu_torch/benchmarks/``.

Each module has ``main(argv=None)`` with the JAX script's flags plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions)
and a ``run`` function that takes a ``NeRFConfig``, so that a test can call
it at a narrow width.  ``python -m danerf_tpu_torch.examples.<name>`` runs
one.  Each writes the report its JAX script writes, under the same keys.
"""

from __future__ import annotations

import subprocess

import torch


def device_block(dev: torch.device) -> dict:
    """What a report says of the device it ran on: on the card its name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them (a card may be set below its maximum
    and then runs slower), on the CPU ``{"name": "cpu"}``."""
    if dev.type != "cuda":
        return {"name": "cpu", "nvidia_smi": None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    line = smi[index]
    name, _, limit = line.rpartition(", ")
    return {"name": name, "power_limit": limit, "nvidia_smi": line,
            "torch_name": torch.cuda.get_device_name(dev), "count": torch.cuda.device_count()}


def sync(dev: torch.device) -> None:
    """Wait for the device's queued work, so that a host clock read next
    closes what was timed."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def launches() -> dict:
    """A copy of the kernel wrappers' launch counts
    (``kernels/fused_mlp.LAUNCHES``)."""
    from danerf_tpu_torch.kernels.fused_mlp import LAUNCHES

    return dict(LAUNCHES)


def launches_since(before: dict) -> dict:
    """The launches since ``before`` (``launches()``), the kernels launched
    at least once."""
    return {k: v - before[k] for k, v in launches().items() if v != before[k]}
