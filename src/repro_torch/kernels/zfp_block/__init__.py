"""ZFP forward transform of a 2-D slice (block exponents + integer
lifting per 4x4 block): the plain version in ``ref``, the CUDA kernel in
``csrc/zfp_block.cu``, the public dispatch in ``ops``."""
