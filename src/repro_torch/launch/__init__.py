"""Command-line entry points of the port: ``python -m
repro_torch.launch.make_dataset`` writes a synthetic dataset and
``python -m repro_torch.launch.advise`` recommends a compressor and an
error bound for every variable of one."""
