"""Loss functions (fixed-shape, mask-weighted), the PyTorch counterpart of
``monorun_tpu/losses.py``.

* ``robust_kl_loss``: Huber-ised attenuated NLL divided by an EMA of the
  mean inverse std; the EMA is explicit state threaded through the train
  step, and its batch term carries no gradient.
* ``kl_loss_mv``: multivariate KL with the degeneracy guard decided on
  values without gradient, applied to the log-determinant's input.
* ``smooth_l1_loss``: accepts the integer pseudo-targets 0 and -1.
* ``sigmoid_bce_loss`` and ``softmax_ce_loss`` for the RPN and R-CNN.

Every loss takes an optional element weight (which doubles as the
validity mask of the fixed-shape padding) and an ``avg_factor``.

Under data parallelism (``parallel/``) a rank holds its rows of the global
batch, and the batch-wide terms are global: a mean loss is the rank's own
sum over the global denominator (so the ranks' losses sum to the loss of
the global batch), and the robust KL loss's EMA takes the global batch's
mean.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from .ops.clip import clip
from .parallel import global_mean, global_sum

Tensor = torch.Tensor


def weighted_reduce(
    loss: Tensor,
    weight: Optional[Tensor] = None,
    reduction: str = "mean",
    avg_factor: Optional[Tensor] = None,
    eps: float = 1e-12,
) -> Tensor:
    """mmdet-style weighted reduction over a fixed-shape loss tensor. The
    denominator of a mean (``avg_factor``, the weights' sum or the element
    count) is summed over the data-parallel ranks; the numerator is this
    rank's own."""
    if weight is not None:
        loss = loss * weight
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if avg_factor is None:
        if weight is None:
            return loss.sum() / global_sum(loss.new_tensor(float(loss.numel())))
        w = torch.broadcast_to(weight, loss.shape)
        return loss.sum() / clip(global_sum(w.sum().to(loss.dtype)), eps)
    return loss.sum() / clip(global_sum(torch.as_tensor(avg_factor, device=loss.device)
                                        .to(loss.dtype)), eps)


def _diff(pred: Tensor, target: Union[Tensor, int], absolute: bool) -> Tensor:
    """Difference, with the reference's integer pseudo-targets."""
    if isinstance(target, int):
        if target == 0:
            return pred.abs() if absolute else pred
        if target == -1:
            return pred
        raise ValueError(f"unsupported int target {target}")
    d = pred - target
    return d.abs() if absolute else d


def smooth_l1_loss(
    pred: Tensor,
    target: Union[Tensor, int],
    beta: float = 1.0,
    weight: Optional[Tensor] = None,
    reduction: str = "mean",
    avg_factor: Optional[Tensor] = None,
) -> Tensor:
    diff = _diff(pred, target, absolute=True).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    return weighted_reduce(loss, weight, reduction, avg_factor)


def robust_kl_loss(
    pred: Tensor,
    target: Union[Tensor, int],
    logstd: Tensor,
    mean_inv_std: Tensor,
    weight: Optional[Tensor] = None,
    delta: float = 1.414,
    momentum: float = 0.1,
    eps: float = 1e-4,
    training: bool = True,
    reduction: str = "mean",
    avg_factor: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Huber-ised attenuated NLL with EMA normalisation. Returns ``(loss,
    new_mean_inv_std)``."""
    diff = _diff(pred, target, absolute=True)
    inverse_std = clip(torch.exp(-logstd), None, 1.0 / eps)
    dw = diff * inverse_std
    loss = torch.where(dw < delta, 0.5 * dw.square(), delta * (dw - 0.5 * delta)) + logstd
    if training:
        batch_mean = global_mean(inverse_std.detach())
        new_mean_inv_std = (1.0 - momentum) * mean_inv_std + momentum * batch_mean
    else:
        new_mean_inv_std = mean_inv_std
    loss = loss / clip(new_mean_inv_std, 1e-6)
    return weighted_reduce(loss, weight, reduction, avg_factor), new_mean_inv_std


def kl_loss_mv(
    pred: Tensor,                  # (n, d)
    target: Union[Tensor, int],    # (n, d) or 0
    inv_cov: Tensor,               # (n, d, d)
    weight: Optional[Tensor] = None,
    reduction: str = "mean",
    avg_factor: Optional[Tensor] = None,
) -> Tensor:
    """Multivariate KL, 0.5 (diff^T S^-1 diff - logdet S^-1), guarded: the
    rows whose inverse covariance is not finite, not positive-definite or
    nearly singular (logdet <= -60), judged without gradient, take the
    identity before the log-determinant and give 0."""
    diff = _diff(pred, target, absolute=False)
    d = inv_cov.shape[-1]
    ic0 = inv_cov.detach()
    finite = torch.isfinite(ic0.reshape(ic0.shape[0], -1)).all(-1)
    sign0, logdet0 = torch.linalg.slogdet(torch.where(finite[:, None, None], ic0,
                                                      torch.eye(d, dtype=ic0.dtype,
                                                                device=ic0.device)))
    ok = finite & (sign0 > 0) & torch.isfinite(logdet0) & (logdet0 > -60.0)
    eye = torch.eye(d, dtype=inv_cov.dtype, device=inv_cov.device)
    safe = torch.where(ok[:, None, None], inv_cov, eye)
    _, logabsdet = torch.linalg.slogdet(safe)
    dw = torch.einsum("ni,nij,nj->n", diff, safe, diff)
    loss = torch.where(ok, (dw - logabsdet) / 2.0, torch.zeros_like(dw))
    return weighted_reduce(loss[:, None], weight, reduction, avg_factor)


def sigmoid_bce_loss(
    logits: Tensor,
    targets: Tensor,
    weight: Optional[Tensor] = None,
    reduction: str = "mean",
    avg_factor: Optional[Tensor] = None,
) -> Tensor:
    """Binary cross-entropy with logits (RPN objectness, score head)."""
    loss = clip(logits, 0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return weighted_reduce(loss, weight, reduction, avg_factor)


def softmax_ce_loss(
    logits: Tensor,        # (n, num_classes)
    labels: Tensor,        # (n,) int
    weight: Optional[Tensor] = None,
    reduction: str = "mean",
    avg_factor: Optional[Tensor] = None,
) -> Tensor:
    """Softmax cross-entropy (R-CNN classification)."""
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return weighted_reduce(logz - ll, weight, reduction, avg_factor)
