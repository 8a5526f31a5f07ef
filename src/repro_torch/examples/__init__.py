"""The port's twins of ``examples/*.py``: the ways users start the system.

Each runs as ``python -m repro_torch.examples.<name> [--device cpu]``
(the card by default), keeps the reference script's defaults, arguments
and printed lines, and computes its printed numbers in a function the
tests call at a small size:

  * :mod:`~repro_torch.examples.quickstart` — the policy grid over a
    generated trace, its Pareto set, and the grid across workload regimes;
  * :mod:`~repro_torch.examples.policy_explorer` — the hybrid policy's
    knob space and its Pareto frontier, per scenario;
  * :mod:`~repro_torch.examples.serve_serverless` — reduced models of the
    six architectures behind the warm pool, hybrid against fixed 10 min;
  * :mod:`~repro_torch.examples.train_smollm` — SmolLM training with
    checkpoints and a restart after an injected crash;
  * :mod:`~repro_torch.examples.export_dataset` — a generated trace in the
    AzurePublicDataset format.
"""
