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

A float32 sum's bits depend on its order. XLA:CPU rewrites a reduction
over 32 or more entries as a tree (its ``TreeReductionRewriter``): a
``reduce-window`` of 32 entries, stride 32, over the padded axis, the
padding split evenly (low ``p // 2``), repeated while 32 or more
partials remain, each window summed in order from 0, then the rest in
order. ``xla_sum`` writes that order out; torch's CPU sum (vectorised
accumulators) and the card's (a tree of its own) round apart from it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["norm32", "sqrt32", "xla_sum"]

#: XLA:CPU's tree reduction: windows of this many entries
XLA_REDUCE_WINDOW = 32


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


def _sum_in_order(x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    for j in range(x.shape[0]):
        acc = acc + x[j]
    return acc


def xla_sum(x: torch.Tensor, dim: int = 0, keepdim: bool = False) -> torch.Tensor:
    """The sum of ``x`` over ``dim`` in XLA:CPU's order (module docstring):
    ``jnp.sum(x, axis=dim)`` of the reference, bitwise, on the CPU and on
    the card (a few dozen small ops: one add a window entry a level)."""
    x = x.movedim(dim, 0)
    while x.shape[0] >= XLA_REDUCE_WINDOW:
        n = x.shape[0]
        groups = -(-n // XLA_REDUCE_WINDOW)
        pad = groups * XLA_REDUCE_WINDOW - n
        if pad:
            x = F.pad(x, [0, 0] * (x.ndim - 1) + [pad // 2, pad - pad // 2])
        x = _sum_in_order(x.reshape(groups, XLA_REDUCE_WINDOW, *x.shape[1:]).movedim(1, 0))
    out = _sum_in_order(x)
    return out.unsqueeze(dim) if keepdim else out
