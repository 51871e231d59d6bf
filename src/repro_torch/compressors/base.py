"""Compressor API + registry.

Every compressor exposes:
  * ``encode(data, eps)   -> (codes, aux)``   decorrelate + quantize (torch)
  * ``decode(codes, aux, eps) -> recon``      reconstruction (torch)
  * ``size_bytes(codes, aux, eps) -> int``    host-side real byte count
  * ``cr(data, eps) -> float``                original_bytes / compressed

Decorrelation and quantization run on the data's device; the entropy
stage runs on the host (``lossless``), as real compressor pipelines do.
``encode`` reads a subnormal value as a zero of its sign, as the
reference's float32 operations do (``quant.flush_subnormals``), unless
the compressor codes the data's bit patterns themselves
(``reads_bits``), which the reference's integer operations leave as
they are.  Subclasses implement ``_encode``.
"""
from __future__ import annotations

import abc
from typing import Any, Dict, Tuple

import torch

from repro_torch.quant import flush_subnormals
from repro_torch.quant import scalar  # noqa: F401  (its callers' name)


class Compressor(abc.ABC):
    name: str = "base"
    supports_3d: bool = True
    reads_bits: bool = False

    def encode(self, data: torch.Tensor, eps: float) -> Tuple[Any, Dict[str, Any]]:
        """Decorrelate and quantize: (codes, aux)."""
        data = data.to(torch.float32)
        return self._encode(data if self.reads_bits
                            else flush_subnormals(data), eps)

    @abc.abstractmethod
    def _encode(self, data: torch.Tensor, eps: float) -> Tuple[Any, Dict[str, Any]]:
        ...

    @abc.abstractmethod
    def decode(self, codes: Any, aux: Dict[str, Any], eps: float) -> torch.Tensor:
        ...

    @abc.abstractmethod
    def size_bytes(self, codes: Any, aux: Dict[str, Any], eps: float) -> int:
        ...

    def cr(self, data: torch.Tensor, eps: float) -> float:
        """Measured compression ratio (original fp32 bytes / compressed)."""
        codes, aux = self.encode(data, eps)
        size = self.size_bytes(codes, aux, eps)
        return float(data.numel() * 4) / max(size, 1)

    def roundtrip_error(self, data: torch.Tensor, eps: float) -> float:
        """Max abs error of the reconstruction, subnormals read as zeros."""
        codes, aux = self.encode(data, eps)
        recon = flush_subnormals(self.decode(codes, aux, eps))
        data = flush_subnormals(data.to(torch.float32))
        return float(torch.max(torch.abs(flush_subnormals(recon - data))))


def error_bound_slack(data: torch.Tensor) -> float:
    """fp32 representability floor for quantizer-grid reconstructions.

    Reconstruction values fl(q * 2eps) are spaced 2eps +- 1 ulp(|d|)
    apart, so the best achievable max error is eps + ulp/2: for
    |d| >> eps no integer code can do better.  The bound a compressor
    holds is err <= eps + error_bound_slack(data).
    """
    return float(torch.max(torch.abs(data))) * 2.0 ** -23


_REGISTRY: Dict[str, Compressor] = {}


def register(comp: Compressor) -> Compressor:
    _REGISTRY[comp.name] = comp
    return comp


def get(name: str) -> Compressor:
    return _REGISTRY[name]


def names() -> list[str]:
    return sorted(_REGISTRY)


def all_compressors() -> Dict[str, Compressor]:
    return dict(_REGISTRY)
