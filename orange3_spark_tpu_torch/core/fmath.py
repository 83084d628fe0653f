"""Float32 elementary functions whose rounding the reference fixes.

XLA rounds a float32 square root correctly on the CPU and on the card.
Torch's CPU ``sqrt`` need not: on an AVX512 AMD EPYC under torch 2.13
(MKL) about one float32 root in six is 1 ulp off, for any ATen CPU
capability and for a single element. A float64 root rounded once to
float32 is correctly rounded (float64 carries more than 2·24 + 2 bits,
so no double rounding can land on the wrong side), so the CPU path takes
that. On CUDA ``torch.sqrt`` compiles with nvcc's default
``-prec-sqrt=true`` and is correctly rounded (``chip_smoke.py`` checks
it on the card).
"""

from __future__ import annotations

import torch

__all__ = ["norm32", "sqrt32"]


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """√x, correctly rounded in x's float dtype, on either device."""
    if x.is_cuda or not x.is_floating_point() or x.dtype == torch.float64:
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def norm32(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """The Euclidean norm as ``jnp.linalg.norm`` forms it: the square
    root of the sum of squares (no rescaling), over ``dim`` (all of x when
    None)."""
    sq = x * x
    s = sq.sum() if dim is None else sq.sum(dim=dim, keepdim=keepdim)
    return sqrt32(s)
