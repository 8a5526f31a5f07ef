"""The benchmark of the PyTorch/CUDA port (``repro_torch``): serverless
model endpoints behind the warm pool, one cell at a time.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name from ``BENCHMARK.json``:
``configs/<config>.json`` (the model as it is run, and the name of its
plain reference under ``reference/``), ``traffic/<traffic>.json`` (the
parameters that :mod:`portbench.traffic` turns into requests) and
``metrics/<metric>.py`` (one reader a per-layer metric). A cell, a mix or a
metric is added by adding files and entries; no module here names one.

The yardstick lives here and not in the program: the traffic generator,
the operation and byte counts (:mod:`portbench.counts`), the reduction of a
profiler trace (:mod:`portbench.trace`), the weights' draw
(:mod:`portbench.weights`), the plain references and the comparison that
decides ``correct`` (:mod:`portbench.check`). Nothing here imports ``jax``
or the JAX package ``repro``.
"""
