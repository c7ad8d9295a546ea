"""Block-detection training dataset (image + same-name ``.txt`` YOLO labels).

Own copy of the JAX package's ``data/blk_dataset.py``: ``<name>.png`` with
``<name>.txt`` rows of ``cls x y w h`` normalized (the synthetic renderer's
output contract, reference text_rendering.py:405-463), ``mask-*`` and
``line-*`` files skipped, letterboxed with the labels scaled by the content
fraction (bottom/right padding), into fixed-capacity padded label arrays
for the dense YOLO loss (``training/yolo_loss.py``).  The same batches from
the same seed and files: the draws from ``random.Random(seed)`` in the same
order, the HSV jitter from ``np.random.RandomState(seed)`` where the JAX
package draws from NumPy's global generator.  Images are read through
``utils/io.py``, PNG without Pillow.
"""

from __future__ import annotations

import glob
import os.path as osp
import random
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from comic_text_detector_tpu_torch.data.augment import augment_hsv, flip_lr, negate
from comic_text_detector_tpu_torch.data.seg_dataset import PrefetchLoader
from comic_text_detector_tpu_torch.ops.resize import letterbox_fast_np, letterbox_shape
from comic_text_detector_tpu_torch.utils.io import IMG_EXT, imread

MAX_LABELS = 32  # fixed label capacity per page (renderer places <= 8 blocks)


class BlkDataset:
    """Yields (img RGB/255 float32 (S, S, 3) or RGB uint8 with
    ``as_uint8``, labels (MAX_LABELS, 5) float32, label_mask (MAX_LABELS,)
    bool)."""

    def __init__(
        self,
        img_dir,
        img_size: int = 640,
        augment: bool = False,
        aug_param: Optional[dict] = None,
        seed: int = 0,
        as_uint8: bool = False,
    ):
        self.as_uint8 = as_uint8  # uint8 RGB upload, /255 on the device
        dirs = [img_dir] if isinstance(img_dir, str) else list(img_dir)
        self._augment = augment
        ap = aug_param or {}
        self._hsv = ap.get("hsv", 0.5) if augment else 0.0
        self._flip = ap.get("flip_lr", 0.5) if augment else 0.0
        self._neg = ap.get("neg", 0.1) if augment else 0.0
        self._rng = random.Random(seed)
        self._np_rng = np.random.RandomState(seed)
        self.img_size = img_size

        self.pairs: List[Tuple[str, str]] = []
        for d in dirs:
            for filep in sorted(glob.glob(osp.join(d, "*"))):
                suffix = Path(filep).suffix
                name = osp.basename(filep)
                if suffix.lower() not in IMG_EXT:
                    continue
                if name.startswith("mask-") or name.startswith("line-"):
                    continue
                labelp = filep[: -len(suffix)] + ".txt"
                if osp.exists(labelp):
                    self.pairs.append((filep, labelp))

    def __len__(self) -> int:
        return len(self.pairs)

    def initialize(self) -> None:  # epoch hook (API parity with SegDataset)
        pass

    def _load(self, i: int):
        imp, labelp = self.pairs[i]
        img = imread(imp)
        rows = []
        with open(labelp, "r", encoding="utf8") as f:
            for line in f:
                parts = line.split()
                if len(parts) == 5:
                    rows.append([float(v) for v in parts])
        labels = np.asarray(rows, np.float32).reshape(-1, 5)
        return img, labels

    def __getitem__(self, idx: int):
        img, labels = self._load(idx)
        h, w = img.shape[:2]
        s = self.img_size
        nh, nw, _, _, _ = letterbox_shape(h, w, s)
        img, _, _ = letterbox_fast_np(img, s)
        # normalized coordinates shrink by the content fraction
        labels = labels.copy()
        labels[:, 1] *= nw / s  # x
        labels[:, 3] *= nw / s  # w
        labels[:, 2] *= nh / s  # y
        labels[:, 4] *= nh / s  # h

        if self._augment:
            if self._rng.random() < self._hsv:
                img = augment_hsv(np.ascontiguousarray(img), rng=self._np_rng)
            if self._rng.random() < self._flip:
                img = flip_lr(img)
                labels[:, 1] = 1.0 - labels[:, 1]
            if self._rng.random() < self._neg:
                img = negate(img)

        out_labels = np.zeros((MAX_LABELS, 5), np.float32)
        out_mask = np.zeros((MAX_LABELS,), bool)
        n = min(len(labels), MAX_LABELS)
        out_labels[:n] = labels[:n]
        out_mask[:n] = True
        # training colour contract matches the seg loader: RGB/255
        if self.as_uint8:
            img = np.ascontiguousarray(img[:, :, ::-1])
        else:
            img = img[:, :, ::-1].astype(np.float32) / 255.0
        return img, out_labels, out_mask


def create_dataloader(
    img_dir,
    img_size: int,
    batch_size: int,
    augment: bool = False,
    aug_param: Optional[dict] = None,
    shuffle: bool = True,
    seed: int = 0,
    as_uint8: bool = False,
):
    ds = BlkDataset(
        img_dir, img_size=img_size, augment=augment, aug_param=aug_param, seed=seed, as_uint8=as_uint8,
    )
    loader = PrefetchLoader(ds, batch_size, shuffle=shuffle, seed=seed)
    return ds, loader
