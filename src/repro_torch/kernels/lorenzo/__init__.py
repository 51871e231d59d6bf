"""Dual-quantization Lorenzo codes of a 2-D slice: the plain version in
``ref``, the CUDA kernel in ``csrc/lorenzo.cu``, the public dispatch in
``ops``."""
