"""Error-bounded lossy compressors (PyTorch decorrelation + real byte counts).

Importing this package registers the reference's compressors: the
paper's 2-D study set sz2, sz3-lorenzo, sz3-regression, sz3-interp,
zfp, mgard, bitgrooming and digitrounding, and the 3-D ``tthresh``.
"""
from repro_torch.compressors import base
from repro_torch.compressors import sz        # noqa: F401  (registers)
from repro_torch.compressors import zfp       # noqa: F401
from repro_torch.compressors import mgard     # noqa: F401
from repro_torch.compressors import rounding  # noqa: F401
from repro_torch.compressors import tthresh   # noqa: F401

get = base.get
names = base.names
all_compressors = base.all_compressors

# The 2-D study set (the paper's main compressor list), in the
# reference's order.
STUDY_2D = ["sz2", "sz3-lorenzo", "sz3-regression", "sz3-interp",
            "zfp", "mgard", "bitgrooming", "digitrounding"]
# The 3-D study set (paper section 4.5).
STUDY_3D = ["sz2", "zfp", "mgard", "bitgrooming", "tthresh"]
