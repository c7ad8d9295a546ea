"""SegDetectorRepresenter: the public API of the reference's DB post-process
(utils/db_utils.py:32-211), with its pixel stage on the device.

Counterpart of the JAX package's ``postproc/db_rep.py``::

    rep = SegDetectorRepresenter(thresh=0.3)            # device="cuda"
    boxes_batch, scores_batch = rep(input_size, lines_map)

``lines_map`` is a (B, 2, H, W) NCHW tensor or array (the port's layout and
the reference's) or (B, H, W, 2) NHWC (the JAX package's); channel 0 is the
shrink map either way.  Each map is labelled and reduced on ``device``
(``ops/db_decode.py::db_device_decode``: K6, then K2 on the card at every
size), and its quads or polygons are built on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from comic_text_detector_tpu_torch.constants import MAX_DB_COMPONENTS
from comic_text_detector_tpu_torch.ops.db_decode import boxes_from_stats, db_device_decode, polygons_from_stats
from comic_text_detector_tpu_torch.utils.device import resolve_device


class SegDetectorRepresenter:
    def __init__(
        self,
        thresh: float = 0.3,
        box_thresh: float = 0.7,
        max_candidates: int = 1000,
        unclip_ratio: float = 1.5,
        capacity: int = MAX_DB_COMPONENTS,
        device: str = "cuda",
    ):
        self.min_size = 3
        self.thresh = thresh
        self.box_thresh = box_thresh
        self.max_candidates = max_candidates
        self.unclip_ratio = unclip_ratio
        self.capacity = capacity
        self.device = resolve_device(device)

    def _shrink_maps(self, pred) -> torch.Tensor:
        """-> (B, H, W) float32 shrink probability maps on the device,
        accepting NCHW or NHWC."""
        if not hasattr(pred, "shape") or len(pred.shape) != 4:
            raise ValueError(f"expected 4-D prediction, got shape {getattr(pred, 'shape', None)}")
        t = torch.as_tensor(np.asarray(pred) if not isinstance(pred, torch.Tensor) else pred)
        # NCHW if the channel dim is small and comes before the spatial dims
        shrink = t[:, 0] if t.shape[1] in (1, 2, 3, 4) and t.shape[1] < t.shape[-1] else t[..., 0]
        return shrink.to(self.device, torch.float32)

    def __call__(self, batch, pred, is_output_polygon: bool = False):
        """Returns (boxes_batch, scores_batch), lists over the batch: (N, 4, 2)
        int32 quad arrays in quad mode, ragged polygon lists in polygon
        mode."""
        shrink = self._shrink_maps(pred)
        b, h, w = shrink.shape
        boxes_batch, scores_batch = [], []
        for bi in range(b):
            stats = db_device_decode(shrink[bi], self.thresh, self.capacity)
            if is_output_polygon:
                boxes, scores = polygons_from_stats(
                    stats, w, h, w, h,
                    unclip_ratio=self.unclip_ratio,
                    box_thresh=self.box_thresh,
                    min_size=self.min_size,
                    max_candidates=self.max_candidates,
                )
            else:
                boxes, scores = boxes_from_stats(
                    stats, w, h, w, h,
                    unclip_ratio=self.unclip_ratio,
                    max_candidates=self.max_candidates,
                )
            boxes_batch.append(boxes)
            scores_batch.append(np.asarray(scores))
        return boxes_batch, scores_batch
