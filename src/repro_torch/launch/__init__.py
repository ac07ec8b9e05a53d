"""Command-line entry points: ``python -m repro_torch.launch.train`` (the
model zoo's trainer), ``python -m repro_torch.launch.serve`` (the
paper's monitoring pipeline) and ``python -m repro_torch.launch.dryrun``
(the zoo's launch analyses on one card, with ``specs`` and
``op_cost``)."""
