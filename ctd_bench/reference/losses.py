"""The DBNet loss of one process (reference utils/loss.py:50-187):
OHEM-balanced BCE, heatmap dice, masked L1 and their 3·shrink + thresh +
binary sum.  Frozen copy of the port's ``training/losses.py`` without its
process-group arithmetic, including the port's reading of the BCE logits
(with a 3-channel head, the binary map, detached, as the JAX package reads
it).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def balance_bce_loss(logits, gt, mask, negative_ratio: float = 3.0, eps: float = 1e-6):
    logits, gt, mask = logits.float(), gt.float(), mask.float()
    positive = gt * mask
    negative = (1.0 - gt) * mask
    pos_count = torch.sum(positive)
    neg_count = torch.minimum(torch.sum(negative), pos_count * negative_ratio)
    loss = F.relu(logits) - logits * gt + torch.log1p(torch.exp(-torch.abs(logits)))
    pos_sum = torch.sum(loss * positive)
    neg_sorted = torch.sort((loss * negative).reshape(-1), stable=True).values.flip(0)
    rank = torch.arange(neg_sorted.shape[0], dtype=torch.float32, device=neg_sorted.device)
    neg_sum = torch.sum(torch.where(rank < neg_count, neg_sorted, torch.zeros_like(neg_sorted)))
    return (pos_sum + neg_sum) / (pos_count + neg_count + eps)


def dice_loss(pred, gt, mask, eps: float = 1e-6):
    pred, gt, mask = pred.float(), gt.float(), mask.float()
    inter = torch.sum(pred * gt * mask)
    return 1.0 - 2.0 * inter / (torch.sum(pred * mask) + torch.sum(gt * mask) + eps)


def mask_l1_loss(pred, gt, mask, eps: float = 1e-6):
    mask = mask.float()
    return torch.sum(torch.abs(pred.float() - gt.float()) * mask) / (torch.sum(mask) + eps)


def db_loss(pred: torch.Tensor, batch: Dict[str, torch.Tensor], alpha: float = 3.0, beta: float = 1.0,
            ohem_ratio: float = 3.0) -> Dict[str, torch.Tensor]:
    shrink, thresh, binary = pred[:, 0], pred[:, 1], pred[:, 2]
    logits = pred[:, 3] if pred.shape[1] > 3 else pred[:, 2].detach()
    loss_shrink = (balance_bce_loss(logits, batch["shrink_map"], batch["shrink_mask"], ohem_ratio)
                   + dice_loss(shrink, batch["shrink_map"], batch["shrink_mask"]))
    loss_thresh = mask_l1_loss(thresh, batch["threshold_map"], batch["threshold_mask"])
    loss_binary = (dice_loss(binary, batch["shrink_map"], batch["shrink_mask"])
                   + balance_bce_loss(binary, batch["shrink_map"], batch["shrink_mask"], ohem_ratio))
    return {"loss": alpha * loss_shrink + beta * loss_thresh + loss_binary, "loss_shrink_maps": loss_shrink,
            "loss_threshold_maps": loss_thresh, "loss_binary_maps": loss_binary}
