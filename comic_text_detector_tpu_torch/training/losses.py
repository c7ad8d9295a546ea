"""Training losses, NCHW.

Counterpart of the JAX package's ``training/losses.py`` (reference
utils/loss.py): BinaryDiceLoss (:10-47) for U-Net mask training; the DBNet
loss family — OHEM-balanced BCE (:50-100), heatmap Dice (:103-137), masked
L1 (:140-147) and their 3·shrink + 1·thresh + binary combination
``DBLoss`` (:149-187).

The OHEM top-k (a count that depends on the data) is a descending sort and
a rank mask, as in the JAX package: no count is read back to the host.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def binary_dice_loss(predict: torch.Tensor, target: torch.Tensor, smooth: float = 1.0,
                     p: float = 2.0) -> torch.Tensor:
    """Dice over flattened per-sample maps, mean over batch."""
    b = predict.shape[0]
    pred = predict.reshape(b, -1).float()
    tgt = target.reshape(b, -1).float()
    num = torch.sum(pred * tgt, dim=1) + smooth
    den = torch.sum(pred**p + tgt**p, dim=1) + smooth
    return torch.mean(1.0 - num / den)


def balance_bce_loss(logits: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor, negative_ratio: float = 3.0,
                     eps: float = 1e-6) -> torch.Tensor:
    """OHEM-balanced BCE-with-logits: all positives + the (3x) hardest
    negatives.  ``logits``, ``gt``, ``mask`` (B, H, W); ``mask`` the valid
    region."""
    logits, gt, mask = logits.float(), gt.float(), mask.float()
    positive = gt * mask
    negative = (1.0 - gt) * mask
    pos_count = torch.sum(positive)
    neg_count = torch.minimum(torch.sum(negative), pos_count * negative_ratio)

    loss = F.relu(logits) - logits * gt + torch.log1p(torch.exp(-torch.abs(logits)))
    pos_sum = torch.sum(loss * positive)
    # ascending stable sort, reversed: ties fall in the JAX package's order
    # (jnp.sort(...)[::-1]), so the same tied negatives take the gradient
    neg_sorted = torch.sort((loss * negative).reshape(-1), stable=True).values.flip(0)
    rank = torch.arange(neg_sorted.shape[0], dtype=torch.float32, device=neg_sorted.device)
    neg_sum = torch.sum(torch.where(rank < neg_count, neg_sorted, torch.zeros_like(neg_sorted)))
    return (pos_sum + neg_sum) / (pos_count + neg_count + eps)


def dice_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor, weights: Optional[torch.Tensor] = None,
              eps: float = 1e-6) -> torch.Tensor:
    """Heatmap dice (B, H, W) with valid mask."""
    pred, gt, mask = pred.float(), gt.float(), mask.float()
    if weights is not None:
        mask = weights * mask
    intersection = torch.sum(pred * gt * mask)
    union = torch.sum(pred * mask) + torch.sum(gt * mask) + eps
    return 1.0 - 2.0 * intersection / union


def mask_l1_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mask = mask.float()
    return torch.sum(torch.abs(pred.float() - gt.float()) * mask) / (torch.sum(mask) + eps)


def db_loss(pred: torch.Tensor, batch: Dict[str, torch.Tensor], use_bce: bool = True, alpha: float = 3.0,
            beta: float = 1.0, ohem_ratio: float = 3.0) -> Dict[str, torch.Tensor]:
    """DBNet composite loss on the (B, C, H, W) head output.

    ``pred`` channels: 0 shrink (sigmoid), 1 thresh, 2 binary [, 3 raw
    logits].  ``batch`` keys: shrink_map, shrink_mask, threshold_map,
    threshold_mask (each (B, H, W)).
    """
    shrink_maps = pred[:, 0]
    threshold_maps = pred[:, 1]
    binary_maps = pred[:, 2]

    if use_bce:
        # The JAX package reads pred[..., 3] whatever the head emits.  With
        # the default shrink_with_sigmoid=True the head has 3 channels: JAX
        # clamps the read to channel 2 (the binary map) and drops its
        # gradient (an out-of-bounds gather's transpose drops the update),
        # so the term adds its value to the loss and nothing to the
        # gradient.  Compute the same.
        logits = pred[:, 3] if pred.shape[1] > 3 else pred[:, 2].detach()
        loss_shrink = balance_bce_loss(logits, batch["shrink_map"], batch["shrink_mask"], ohem_ratio) + dice_loss(
            shrink_maps, batch["shrink_map"], batch["shrink_mask"])
    else:
        loss_shrink = dice_loss(shrink_maps, batch["shrink_map"], batch["shrink_mask"])

    loss_thresh = mask_l1_loss(threshold_maps, batch["threshold_map"], batch["threshold_mask"])
    metrics = dict(loss_shrink_maps=loss_shrink, loss_threshold_maps=loss_thresh)
    # Binary channel: the reference feeds the binary *probability* map to
    # BCE-with-logits (utils/loss.py:181); kept to match training dynamics.
    loss_binary = dice_loss(binary_maps, batch["shrink_map"], batch["shrink_mask"]) + balance_bce_loss(
        binary_maps, batch["shrink_map"], batch["shrink_mask"], ohem_ratio)
    metrics["loss_binary_maps"] = loss_binary
    metrics["loss"] = alpha * loss_shrink + beta * loss_thresh + loss_binary
    return metrics
