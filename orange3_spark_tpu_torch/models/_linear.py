"""Per-row losses of the linear models, and their gradients.

``per_row_loss`` is the one loss implementation the hashed-sparse path
(and later the dense linear models) share; its logits come from an
embedding gather or a matmul. ``per_row_loss_grad`` is its derivative with
respect to the logits, written out, with the JAX package's autodiff rules
at the kinks: d max(a, b) splits 1/2 to each side at a tie, and d|z|/dz is
+1 at z = 0. Those rules matter here: a fit starts from a zero table, so
every logit of the first step is exactly 0, where the binary logistic
gradient is ½ - y - ½ (0 or -1), not sigmoid(0) - y.
"""

from __future__ import annotations

import torch

from orange3_spark_tpu_torch.ops.stats import EPS_TOTAL_WEIGHT

__all__ = ["EPS_TOTAL_WEIGHT", "LOSS_KINDS", "per_row_loss", "per_row_loss_grad"]

LOSS_KINDS = ("logistic", "binary_logistic", "hinge", "squared_hinge", "squared")


def per_row_loss(loss_kind: str, logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[N] loss of each row from [N, k] logits and [N] labels.

    'logistic' is softmax cross-entropy over k classes; 'binary_logistic'
    the single-logit sigmoid form (k = 1), softplus(z) - z·y written
    stably; 'hinge'/'squared_hinge' the SVM margins on the first logit;
    'squared' least squares."""
    if loss_kind == "logistic":
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, 1, y.to(torch.int64)[:, None])[:, 0]
    if loss_kind == "binary_logistic":
        z = logits[:, 0]
        return torch.clamp_min(z, 0.0) - z * y + torch.log1p(torch.exp(-torch.abs(z)))
    if loss_kind in ("hinge", "squared_hinge"):
        margin = torch.clamp_min(1.0 - (2.0 * y - 1.0) * logits[:, 0], 0.0)
        return margin if loss_kind == "hinge" else margin**2
    if loss_kind == "squared":
        return 0.5 * (logits[:, 0] - y) ** 2
    raise ValueError(loss_kind)


def _tie_step(a: torch.Tensor) -> torch.Tensor:
    """d max(a, 0)/da: 1 above, ½ at the tie, 0 below."""
    return torch.where(a > 0, 1.0, torch.where(a == 0, 0.5, 0.0))


def per_row_loss_grad(loss_kind: str, logits: torch.Tensor,
                      y: torch.Tensor) -> torch.Tensor:
    """[N, k] d per_row_loss / d logits, row by row."""
    if loss_kind == "logistic":
        p = torch.softmax(logits, dim=-1)
        return p - torch.nn.functional.one_hot(
            y.to(torch.int64), logits.shape[1]).to(logits.dtype)
    z = logits[:, 0]
    if loss_kind == "binary_logistic":
        x = torch.exp(-torch.abs(z))
        q = x / (1.0 + x)
        g = _tie_step(z) - y - torch.where(z >= 0, q, -q)
    elif loss_kind in ("hinge", "squared_hinge"):
        s = 2.0 * y - 1.0
        a = 1.0 - s * z
        g = -s * _tie_step(a)
        if loss_kind == "squared_hinge":
            g = 2.0 * torch.clamp_min(a, 0.0) * g
    elif loss_kind == "squared":
        g = z - y
    else:
        raise ValueError(loss_kind)
    return g[:, None]
