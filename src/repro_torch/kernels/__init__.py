"""Hand-written CUDA kernels for the featurization path, one package per
TPU kernel of ``src/repro/kernels``: ``ref.py`` holds the plain PyTorch
version, ``ops.py`` the public wrapper that routes by device, and the
kernel source lives in ``repro_torch/csrc/<name>.cu``."""


def wrappers() -> dict:
    """Kernel name -> its wrapper, whose ``launches`` counter (and
    ``by_shape`` counter) counts that kernel's launches on the card."""
    from repro_torch.kernels.gram import ops as gram
    from repro_torch.kernels.lorenzo import ops as lorenzo
    from repro_torch.kernels.qent import ops as qent
    from repro_torch.kernels.quality import ops as quality
    from repro_torch.kernels.zfp_block import ops as zfp_block
    return {"gram_batched": gram.gram_batched,
            "qent_histogram_sweep": qent.qent_histogram_sweep,
            "qdq_sse_sweep": quality.qdq_sse_sweep,
            "lorenzo2d": lorenzo.lorenzo2d,
            "zfp_forward2d": zfp_block.zfp_forward2d}
