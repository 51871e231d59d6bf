"""Error-bounded lossy compressors (PyTorch decorrelation + real byte counts).

Importing this package registers the compressors ported so far:
sz3-lorenzo, bitgrooming, digitrounding.
"""
from repro_torch.compressors import base
from repro_torch.compressors import rounding  # noqa: F401  (registers)
from repro_torch.compressors import sz        # noqa: F401

get = base.get
names = base.names
all_compressors = base.all_compressors
