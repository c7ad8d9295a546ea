"""Training losses, NCHW.

Counterpart of the JAX package's ``training/losses.py`` (reference
utils/loss.py): BinaryDiceLoss (:10-47) for U-Net mask training; the DBNet
loss family — OHEM-balanced BCE (:50-100), heatmap Dice (:103-137), masked
L1 (:140-147) and their 3·shrink + 1·thresh + binary combination
``DBLoss`` (:149-187).

The OHEM top-k (a count that depends on the data) is a descending sort and
a rank mask, as in the JAX package: no count is read back to the host.

Under a mesh (``mesh=`` with a process group, each rank holding its
contiguous block of the global batch) every loss is the JAX function of
the global batch.  Each rank backpropagates a share, the shares summing to
the global loss, and the ranks then sum their parameter gradients
(``training/steps.py``); every normaliser and count is the global one,
taken through the autograd all-reduce.  Per-sample and elementwise terms
share as their local sum over the global count; ``dice_loss``, computed
whole from global sums, shares as ``L / W``.  Each function returns a
scalar whose value is the global loss and whose gradient is the rank's
share (``parallel/collectives.py::sum_shares``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from comic_text_detector_tpu_torch.parallel.collectives import all_reduce, group_size, sum_shares
from comic_text_detector_tpu_torch.parallel.mesh import Mesh


def _group(mesh: Optional[Mesh]):
    return None if mesh is None else mesh.group


def binary_dice_loss(predict: torch.Tensor, target: torch.Tensor, smooth: float = 1.0, p: float = 2.0,
                     mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Dice over flattened per-sample maps, mean over batch."""
    b = predict.shape[0]
    pred = predict.reshape(b, -1).float()
    tgt = target.reshape(b, -1).float()
    num = torch.sum(pred * tgt, dim=1) + smooth
    den = torch.sum(pred**p + tgt**p, dim=1) + smooth
    group = _group(mesh)
    if group is None:
        return torch.mean(1.0 - num / den)
    return sum_shares([torch.sum(1.0 - num / den) / (b * group_size(group))], group)[0]


def balance_bce_loss(logits: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor, negative_ratio: float = 3.0,
                     eps: float = 1e-6, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """OHEM-balanced BCE-with-logits: all positives + the (3x) hardest
    negatives.  ``logits``, ``gt``, ``mask`` (B, H, W); ``mask`` the valid
    region.

    Under a mesh the hardest negatives are those of the global batch: each
    rank writes its negative losses into its block of a zeroed buffer of
    the global batch's, one all-reduce fills it in the global flat order,
    and every rank runs the same sort over it and sums the selected
    elements of its own block."""
    group = _group(mesh)
    logits, gt, mask = logits.float(), gt.float(), mask.float()
    positive = gt * mask
    negative = (1.0 - gt) * mask
    pos_count, neg_total = all_reduce(torch.stack([torch.sum(positive), torch.sum(negative)]), group)
    neg_count = torch.minimum(neg_total, pos_count * negative_ratio)

    loss = F.relu(logits) - logits * gt + torch.log1p(torch.exp(-torch.abs(logits)))
    pos_sum = torch.sum(loss * positive)
    neg_losses = (loss * negative).reshape(-1)
    if group is None:
        # ascending stable sort, reversed: ties fall in the JAX package's
        # order (jnp.sort(...)[::-1]), so the same tied negatives take the
        # gradient
        neg_sorted = torch.sort(neg_losses, stable=True).values.flip(0)
        rank = torch.arange(neg_sorted.shape[0], dtype=torch.float32, device=neg_sorted.device)
        neg_sum = torch.sum(torch.where(rank < neg_count, neg_sorted, torch.zeros_like(neg_sorted)))
        return (pos_sum + neg_sum) / (pos_count + neg_count + eps)
    n, r, world = neg_losses.shape[0], dist.get_rank(group), group_size(group)
    everyone = torch.zeros(world * n, dtype=torch.float32, device=neg_losses.device)
    everyone[r * n:(r + 1) * n] = neg_losses.detach()
    order = torch.sort(all_reduce(everyone, group), stable=True).indices.flip(0)
    rank = torch.arange(world * n, dtype=torch.float32, device=order.device)
    chosen = torch.empty(world * n, dtype=torch.bool, device=order.device)
    chosen[order] = rank < neg_count
    neg_sum = torch.sum(torch.where(chosen[r * n:(r + 1) * n], neg_losses, torch.zeros_like(neg_losses)))
    return sum_shares([(pos_sum + neg_sum) / (pos_count + neg_count + eps)], group)[0]


def dice_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor, weights: Optional[torch.Tensor] = None,
              eps: float = 1e-6, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Heatmap dice (B, H, W) with valid mask."""
    pred, gt, mask = pred.float(), gt.float(), mask.float()
    if weights is not None:
        mask = weights * mask
    group = _group(mesh)
    intersection, p_sum, g_sum = all_reduce(
        torch.stack([torch.sum(pred * gt * mask), torch.sum(pred * mask), torch.sum(gt * mask)]), group)
    whole = 1.0 - 2.0 * intersection / (p_sum + g_sum + eps)
    share = whole / group_size(group)  # computed whole from global sums: each rank takes 1/W of its gradient
    return whole.detach() + (share - share.detach())


def mask_l1_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor, eps: float = 1e-6,
                 mesh: Optional[Mesh] = None) -> torch.Tensor:
    mask = mask.float()
    group = _group(mesh)
    num = torch.sum(torch.abs(pred.float() - gt.float()) * mask)
    return sum_shares([num / (all_reduce(torch.sum(mask), group) + eps)], group)[0]


def db_loss(pred: torch.Tensor, batch: Dict[str, torch.Tensor], use_bce: bool = True, alpha: float = 3.0,
            beta: float = 1.0, ohem_ratio: float = 3.0, mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
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
        loss_shrink = balance_bce_loss(logits, batch["shrink_map"], batch["shrink_mask"], ohem_ratio,
                                       mesh=mesh) + dice_loss(shrink_maps, batch["shrink_map"],
                                                              batch["shrink_mask"], mesh=mesh)
    else:
        loss_shrink = dice_loss(shrink_maps, batch["shrink_map"], batch["shrink_mask"], mesh=mesh)

    loss_thresh = mask_l1_loss(threshold_maps, batch["threshold_map"], batch["threshold_mask"], mesh=mesh)
    metrics = dict(loss_shrink_maps=loss_shrink, loss_threshold_maps=loss_thresh)
    # Binary channel: the reference feeds the binary *probability* map to
    # BCE-with-logits (utils/loss.py:181); kept to match training dynamics.
    loss_binary = dice_loss(binary_maps, batch["shrink_map"], batch["shrink_mask"], mesh=mesh) + balance_bce_loss(
        binary_maps, batch["shrink_map"], batch["shrink_mask"], ohem_ratio, mesh=mesh)
    metrics["loss_binary_maps"] = loss_binary
    metrics["loss"] = alpha * loss_shrink + beta * loss_thresh + loss_binary
    return metrics
