"""Hand-written CUDA kernels for the featurization path, one package per
TPU kernel of ``src/repro/kernels``: ``ref.py`` holds the plain PyTorch
version, ``ops.py`` the public wrapper that routes by device, and the
kernel source lives in ``repro_torch/csrc/<name>.cu``."""
