"""Training losses (PyTorch port of the JAX package's `train/losses.py`).

  * `cross_entropy_loss` — mean cross entropy over pixels whose label is not
    `ignore_index`, 0 when none is valid; nll = logsumexp - <logits, one-hot>.
  * `silog_loss` — masked scale-invariant log depth loss,
    mean(d^2) - lambda * mean(d)^2 over valid pixels, eps-clamped logs,
    0 when the mask is empty.

Both reduce in fp32 whatever the activations' dtype, and mask with `where`
instead of boolean indexing, so they never synchronise with the host.

Over a process group both are the global batch's loss, as JAX's under a
data-sharded batch: the sums are all-reduced over the data group with
autograd and the valid counts without (`parallel/mesh.py`; the ranks of a
model group hold the same rows), so every rank holds the same value and the
sum of the data group's gradients is its size times the gradient of the
global loss, which the step's gradient average divides back out.  In a
one-process world the arithmetic is the one-process port's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from denseclip_vit_multimodal_tpu_torch.parallel import mesh as mesh_lib


def cross_entropy_loss(
    logits: torch.Tensor,  # [B, H, W, K] (channel-last)
    labels: torch.Tensor,  # [B, H, W] int
    ignore_index: int = 255,
) -> torch.Tensor:
    """Mean CE over pixels whose label != ignore_index; 0 if none is valid."""
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    lse = torch.logsumexp(logits, dim=-1)
    picked = (logits * F.one_hot(safe, logits.shape[-1]).to(logits.dtype)).sum(dim=-1)
    nll = torch.where(valid, lse - picked, torch.zeros_like(lse))
    count = valid.sum()
    if mesh_lib.data_size() > 1:
        total, count = mesh_lib.all_reduce_sum(nll.sum()), mesh_lib.sum_across(count)
        return torch.where(count > 0, total / count.clamp(min=1), total.new_zeros(()))
    return torch.where(count > 0, nll.sum() / count.clamp(min=1), nll.new_zeros(()))


def silog_loss(
    prediction: torch.Tensor,  # [B, H, W] or [B, H, W, 1]
    target: torch.Tensor,  # [B, H, W]
    mask: Optional[torch.Tensor] = None,  # bool, same spatial shape
    lambd: float = 0.5,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Masked scale-invariant log depth loss."""
    pred = prediction.float().clamp(min=eps)
    tgt = target.float().clamp(min=eps)
    if pred.dim() == tgt.dim() + 1:
        pred = pred.squeeze(-1)
    log_diff = torch.log(pred) - torch.log(tgt)
    if mask is not None:
        if mask.dim() == log_diff.dim() + 1:
            mask = mask.squeeze(-1)
        mask = mask.bool()
        log_diff = torch.where(mask, log_diff, torch.zeros_like(log_diff))
        count = mask.sum().float()
    else:
        count = torch.tensor(float(log_diff.numel()), device=log_diff.device)
    sq_sum, sum_ = log_diff.square().sum(), log_diff.sum()
    if mesh_lib.data_size() > 1:
        sq_sum, sum_ = mesh_lib.all_reduce_sum(torch.stack([sq_sum, sum_])).unbind()
        count = mesh_lib.sum_across(count)
    safe = count.clamp(min=1.0)
    loss = sq_sum / safe - lambd * sum_.square() / safe.square()
    return torch.where(count > 0, loss, torch.zeros_like(loss))
