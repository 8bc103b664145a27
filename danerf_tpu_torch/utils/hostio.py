"""Device-to-host copies that overlap the next frame's work.

``fetch_async(t)`` enqueues the copy of ``t`` into pinned host memory on the
current stream, right after the work that produced ``t`` and before
whatever the caller enqueues next, and returns a function that waits for
that copy alone (a CUDA event) and gives the numpy array.  A worker thread
can call it while the caller's thread dispatches the next frame: a plain
``t.cpu()`` from the worker would queue behind that next frame's kernels.
On the CPU the function returns the array at once.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def fetch_async(t: torch.Tensor) -> Callable[[], np.ndarray]:
    t = t.detach()
    if t.device.type != "cuda":
        return t.numpy
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait() -> np.ndarray:
        done.synchronize()
        return host.numpy()

    return wait
