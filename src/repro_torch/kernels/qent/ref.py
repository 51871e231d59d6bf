"""Plain PyTorch version of the q-ent kernel and the entropy reduction."""
import torch

from repro_torch.quant import INT32_CODE_MAX, INT32_CODE_MIN
from repro_torch.quant import flush_subnormals as _ftz
from repro_torch.refmath import sum_rows_f32


def hash_codes(x: torch.Tensor, epss: torch.Tensor, bins: int) -> torch.Tensor:
    """(n,) values x (e,) error bounds -> (e, n) int64 bins in [0, bins):
    ``floor(x / eps)`` saturated to the int32 range, then positive mod.
    The division is tensor by tensor, so it is IEEE on every device.
    ``x`` holds no subnormal (the entry points flush the data); a
    subnormal quotient reads as a signed zero (code 0), as in the
    reference and the kernel."""
    codes = torch.clamp(torch.floor(_ftz(x[None, :] / epss[:, None])),
                        INT32_CODE_MIN, INT32_CODE_MAX).to(torch.int32)
    return torch.remainder(codes, bins).to(torch.int64)


def qent_histogram_sweep(x: torch.Tensor, epss: torch.Tensor,
                         bins: int) -> torch.Tensor:
    """(k, n) float32 x (e,) float32 -> (k, e, bins) int32 histograms,
    one ``bincount`` per slice over all its error bounds."""
    k, _ = x.shape
    e = epss.shape[0]
    offs = (torch.arange(e, device=x.device) * bins)[:, None]
    out = torch.empty((k, e, bins), dtype=torch.int32, device=x.device)
    for s in range(k):
        idx = hash_codes(x[s], epss, bins) + offs
        out[s] = torch.bincount(idx.reshape(-1), minlength=e * bins
                                ).reshape(e, bins).to(torch.int32)
    return out


def entropy_bits_rows(hist: torch.Tensor) -> torch.Tensor:
    """Entropy (bits/symbol) along the last (bins) axis of a (k, ...,
    bins) histogram stack, float32 like the reference's
    ``entropy_bits_rows``.  The terms are elementwise (and the counts'
    total an integer sum); each (slice, eps) row's terms add in XLA's
    order (``refmath.sum_rows_f32``), so a row's entropy is the same
    bits in any batch and in any eb grid: a library sum splits by the
    number of rows it reduces at once."""
    return -sum_rows_f32(_entropy_terms(hist))


def _entropy_terms(hist: torch.Tensor) -> torch.Tensor:
    n = torch.clamp(hist.sum(dim=-1, keepdim=True), min=1)
    p = hist.to(torch.float32) / n.to(torch.float32)
    return torch.where(p > 0, p * torch.log2(torch.clamp(p, min=1e-30)),
                       torch.zeros_like(p))
