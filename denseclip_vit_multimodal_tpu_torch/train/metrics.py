"""Evaluation metrics on the device (PyTorch port of the JAX package's
`train/metrics.py`): segmentation mIoU / accuracy and the depth error suite.

  * `confusion_matrix` — int32 [K, K] counts, rows the target, pixels whose
    label is `ignore_index` left out; accumulated across batches with `+`.
    One `bincount` over target * K + prediction: exact, where the JAX
    package's one-hot product on the MXU needs its 2^24-pixel chunks.  As
    there, a label or prediction outside [0, K) counts nowhere.
  * `miou_from_confusion` / `accuracy_from_confusion` — intersection /
    (union + eps), averaged over the classes present in target or prediction.
  * `depth_errors` — AbsRel / SqRel / RMSE / RMSElog / delta < 1.25^k with
    the ground-truth range mask and the prediction clamped to it, returned as
    (sums, count) so that batches aggregate exactly; `finalize_depth_errors`
    divides (and takes the roots) after aggregation.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def confusion_matrix(
    preds: torch.Tensor,  # [..., H, W] int predictions
    labels: torch.Tensor,  # [..., H, W] int labels
    num_classes: int,
    ignore_index: int = 255,
) -> torch.Tensor:
    """Returns [num_classes, num_classes] int32 counts (rows = target)."""
    t = labels.reshape(-1).long()
    p = preds.reshape(-1).long().to(t.device)
    keep = (t != ignore_index) & (t >= 0) & (t < num_classes) & (p >= 0) & (p < num_classes)
    counts = torch.bincount(t[keep] * num_classes + p[keep], minlength=num_classes * num_classes)
    return counts.reshape(num_classes, num_classes).to(torch.int32)


def miou_from_confusion(cm: torch.Tensor, eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean IoU over classes present in GT or pred, per-class IoU), fp32."""
    cm = cm.float()
    intersection = torch.diagonal(cm)
    union = cm.sum(0) + cm.sum(1) - intersection
    iou = intersection / (union + eps)
    present = union > 0
    miou = torch.where(present, iou, torch.zeros_like(iou)).sum() / present.sum().clamp(min=1)
    return miou, iou


def accuracy_from_confusion(cm: torch.Tensor) -> torch.Tensor:
    cm = cm.float()  # an int32 sum over the cells could overflow
    return torch.trace(cm) / cm.sum().clamp(min=1.0)


def depth_errors(
    pred: torch.Tensor,  # [..., H, W] predicted depth
    gt: torch.Tensor,  # [..., H, W] ground-truth depth
    mask: torch.Tensor,  # [..., H, W] bool validity
    min_depth: float = 1e-3,
    max_depth: float = 80.0,
    clamp_pred: bool = True,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Per-batch depth error SUMS and the valid-pixel COUNT (fp32 scalars).

    Evaluation mask = validity mask AND gt in [min_depth, max_depth];
    predictions clamped to that range.  After aggregation: abs_rel =
    sums['abs_rel'] / n, rmse = sqrt(sums['sq_diff'] / n), and so on.
    """
    pred = pred.float()
    gt = gt.float().to(pred.device)
    eval_mask = mask.bool().to(pred.device) & (gt >= min_depth) & (gt <= max_depth)
    if clamp_pred:
        pred = pred.clamp(min_depth, max_depth)
    one = torch.ones((), dtype=torch.float32, device=pred.device)
    safe_gt = torch.where(eval_mask, gt, one)
    safe_pred = torch.where(eval_mask, pred, one)

    diff = safe_gt - safe_pred
    log_diff = torch.log(safe_gt) - torch.log(safe_pred)
    thresh = torch.maximum(safe_gt / safe_pred, safe_pred / safe_gt)

    m = eval_mask.float()
    sums = {
        "abs_rel": (m * diff.abs() / safe_gt).sum(),
        "sq_rel": (m * diff.square() / safe_gt).sum(),
        "sq_diff": (m * diff.square()).sum(),
        "sq_log_diff": (m * log_diff.square()).sum(),
        "a1": (m * (thresh < 1.25)).sum(),
        "a2": (m * (thresh < 1.25**2)).sum(),
        "a3": (m * (thresh < 1.25**3)).sum(),
    }
    return sums, m.sum()


def finalize_depth_errors(sums: Dict[str, torch.Tensor], count: torch.Tensor
                          ) -> Dict[str, torch.Tensor]:
    n = torch.as_tensor(count, dtype=torch.float32).clamp(min=1.0)
    return {
        "abs_rel": sums["abs_rel"] / n,
        "sq_rel": sums["sq_rel"] / n,
        "rmse": torch.sqrt(sums["sq_diff"] / n),
        "rmse_log": torch.sqrt(sums["sq_log_diff"] / n),
        "a1": sums["a1"] / n,
        "a2": sums["a2"] / n,
        "a3": sums["a3"] / n,
    }
