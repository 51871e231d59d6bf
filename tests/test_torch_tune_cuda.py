"""Every candidate build of the q-ent kernel against the plain build's
bits on the card (``cuda``-marked: they skip without one).

No JAX here, so the file also runs on the card's machine:

    python -m pytest -q -m cuda tests/test_torch_tune_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import tune as KT  # noqa: E402
from repro_torch.kernels.qent import ops as qent_ops  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("k, n, e, bins", [(2, 100000, 3, 65536),
                                           (3, 9100, 8, 4096),
                                           (1, 70001, 1, 65536)])
def test_cuda_qent_candidates_bit_equal(k, n, e, bins):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ only")
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((k, n), generator=g, device="cuda")
    eps = torch.logspace(-3, -1, e, device="cuda")
    want = qent_ops.qent_histogram_sweep(x, eps, bins)
    for tile in KT.QENT_TILE_CANDIDATES:
        assert torch.equal(qent_ops.launch(x, eps, bins,
                                           KT.tile_defines(tile)), want)
    assert torch.equal(want.cpu(), qent_ops.qent_histogram_sweep(
        x.cpu(), eps.cpu(), bins))
