"""The port's counterparts of the repository's ``benchmarks/`` scripts that
the parity studies (``danerf_tpu_torch/examples/parity_study.py``,
``parity_chair.py``) run on:

- ``torch_reference``: the reference's training semantics in plain PyTorch
  on a chosen device (the referee; it launches none of the port's kernels),
  its init drawn on the CPU as the repository script draws it;
- ``reference_init``: a reference init as the port's model and appearance
  table, and the born-dead density probe (no mirror: on the card the
  reference arm is the reference trainer itself);
- ``dead_rate_probe``: the born-dead rate of both init families;
- ``parity_equivalence``: the reference trainer's drift between the card and
  the CPU from one init and one numpy stream;
- ``run_torch_anchor``: one reference run with its progress and init.

Each has ``main(argv=None)`` with the JAX script's flags plus ``--device``
(default ``cuda``) and a ``run`` function; ``python -m
danerf_tpu_torch.benchmarks.<name>`` runs one.  They write under the
gitignored ``build/parity_runs_torch/`` unless told otherwise.
"""
