"""Single-process training-time compressor runs (``sweep.training_crs``)."""
