"""Write the JAX checkpoint fixture that two processes save together.

    python tests/data_torch/write_jax_checkpoint_2proc.py

Runs where JAX, orbax and the danerf_tpu package are (from the repository
root).  Starts two processes the way ``tests/test_multiprocess.py`` starts
``tests/mp_worker.py``: each initializes ``jax.distributed`` against a local
coordinator (CPU backend, gloo collectives, 2 local devices each: one mesh
of 4 devices over 2 processes) and runs that worker's ``run_steps`` (its
small widths: hidden 32, 2 layers, appearance 4, 8 samples, f32; the
sharded train step, 3 calls of 2 steps).  Then both call the JAX
``save_checkpoint`` on the sharded state, with ``{"step": 6,
"process_count": 2}`` as its metadata, into
``tests/data_torch/jax_run_2proc/checkpoint_000006/``.  Orbax writes the
numpy leaves from the primary process alone (``state/ocdbt.process_0/``
beside the root ``manifest.ocdbt``); the port reads the directory as it
reads a single-process one.
"""

from __future__ import annotations

import os
import shutil
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
RUN = os.path.join(HERE, "jax_run_2proc")
PROCESSES = 2


def worker(pid: int, port: int):
    sys.path.insert(0, REPO)
    from tests.mp_worker import LOCAL_DEVICES, run_steps

    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count={LOCAL_DEVICES}")
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    from danerf_tpu.parallel import initialize_distributed
    from danerf_tpu.utils.checkpoint import save_checkpoint

    assert initialize_distributed(f"localhost:{port}", PROCESSES, pid) is True
    assert jax.process_count() == PROCESSES
    _, state = run_steps(jax.device_count())
    step = int(np.asarray(state.step))
    save_checkpoint(RUN, f"checkpoint_{step:06d}", state,
                    {"step": step, "process_count": jax.process_count()})


def main():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    shutil.rmtree(RUN, ignore_errors=True)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen([sys.executable, __file__, "--worker", str(i), str(port)],
                              env=env) for i in range(PROCESSES)]
    codes = [p.wait(timeout=600) for p in procs]
    if any(codes):
        raise SystemExit(f"a worker failed: exit codes {codes}")
    for d, _, files in sorted(os.walk(RUN)):
        for f in sorted(files):
            path = os.path.join(d, f)
            print(os.path.relpath(path, HERE), os.path.getsize(path))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(int(sys.argv[2]), int(sys.argv[3]))
    else:
        main()
