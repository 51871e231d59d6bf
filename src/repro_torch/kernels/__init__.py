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


def launch_counts() -> dict:
    """Kernel name -> (its launches so far, {launch shape: launches})."""
    return {k: (fn.launches, dict(fn.by_shape))
            for k, fn in wrappers().items()}


def launches_since(before: dict, after: dict = None) -> tuple:
    """The launches between two :func:`launch_counts` (``after``: now):
    ({kernel: launches}, {kernel: {launch shape as text: launches}})."""
    after = launch_counts() if after is None else after
    total, by_shape = {}, {}
    for k, (n, shapes) in after.items():
        total[k] = n - before[k][0]
        by_shape[k] = {str(sh): c - before[k][1].get(sh, 0)
                       for sh, c in shapes.items()
                       if c > before[k][1].get(sh, 0)}
    return total, by_shape
