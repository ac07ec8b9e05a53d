"""Command-line entry points: ``python -m repro_torch.launch.train`` (the
model zoo's trainer) and ``python -m repro_torch.launch.serve`` (the
paper's monitoring pipeline)."""
