"""Command-line entry points of the port: ``python -m
repro_torch.launch.make_dataset`` writes a synthetic dataset, ``python
-m repro_torch.launch.advise`` recommends a compressor and an error
bound for every variable of one (``--service`` through the sweep
service), and ``python -m repro_torch.launch.sweep_serve`` drives the
sweep service with concurrent UC1/UC2 clients, ``python -m
repro_torch.launch.serve`` generates with an LLM and ``python -m
repro_torch.launch.train`` trains one.  ``mesh`` joins a
process group (``dist_init``) and builds sweep meshes
(``make_sweep_mesh``)."""
