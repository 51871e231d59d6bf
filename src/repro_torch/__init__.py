"""PyTorch/CUDA port of the ``repro`` CR-prediction package.

Mirrors ``src/repro/``'s layout and names module for module.  Plain
tensor code is PyTorch; the three kernels on the featurization path
(batched Gram, fused q-ent histogram, fused quality SSE) are CUDA C++
sources under ``csrc/``, compiled for ``sm_90a`` by ``nvcc`` at first
use (``kernels/_build.py``).

Routing follows the tensor's device: a CUDA tensor launches the
hand-written kernel (or the call raises), a CPU tensor takes the plain
PyTorch version of the same function.  Entry points that create data
default to ``device="cuda"``; pass ``device="cpu"`` to run on the host.

The LLM serving and training paths (``configs``, ``models``,
``serve.engine``, ``train``, ``ckpt``, ``launch.serve``,
``launch.train``) have no kernel of their own: their products are
``torch.matmul`` and their attention the reference's plain form; a
lossy checkpoint runs the compressors' kernels.

This package imports neither ``jax`` nor anything of ``repro``.
"""
