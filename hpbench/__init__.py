"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of GraphHP.

One command runs one cell once::

    python3 hpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations and metrics are named in ``BENCHMARK.json`` at the
repository root.  Everything that belongs to one name sits in a file of its
own, found by that name: ``configs/<config>.json``, ``traffic/<mix>.json``,
``metrics/<metric>.py``, ``limits/<cell>.json``, ``apps/<app>.py`` (how a
cell drives the port's program) and ``reference/<app>.py`` (its plain
reference).  Nothing here imports ``jax`` or the JAX package ``repro``, and
the references import nothing of ``repro_torch``.
"""
