"""Segmentation training dataset (img + ``mask-*.png`` pairs).

Own copy of the JAX package's ``data/seg_dataset.py``: the same batches
from the same seed and files (the draws from ``random.Random(seed)`` in the
same order; the HSV jitter from ``np.random.RandomState(seed)`` where the
JAX package draws from NumPy's global generator).  It reads images through
``utils/io.py``, PNG without Pillow.

The JAX package's: a torch-free re-design of the reference's LoadImageAndMask (seg_dataset.py:90-211):
same pairing convention, multi-size jitter, mini-mosaic / HSV / flip /
negation augments, in-RAM cache with a size cap, and a threaded prefetching
batch iterator in place of torch DataLoader workers.

Color quirk preserved: training consumes RGB/255 (reference transform,
seg_dataset.py:161-168) while deployment consumes BGR (inference.py:74-77) —
mostly-grayscale manga makes this asymmetry benign, and matching it keeps
converted checkpoints equivalent.
"""

from __future__ import annotations

import glob
import os.path as osp
import queue
import random
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from comic_text_detector_tpu_torch.data.augment import augment_hsv, flip_lr, negate
from comic_text_detector_tpu_torch.ops.resize import letterbox_fast_np, resize_keepasp_np
from comic_text_detector_tpu_torch.utils.io import IMG_EXT, imread

CACHE_CAP_GB = 7.0


class SegDataset:
    def __init__(
        self,
        img_dir,
        mask_dir=None,
        img_size: int = 640,
        augment: bool = False,
        aug_param: Optional[dict] = None,
        cache: bool = False,
        stride: int = 128,
        seed: int = 0,
        as_uint8: bool = False,
    ):
        # as_uint8: emit RGB uint8 images + 0/1 uint8 masks; the train steps
        # convert on the device, from 4x fewer host->device bytes.
        self.as_uint8 = as_uint8
        self.img_dir = [img_dir] if isinstance(img_dir, str) else list(img_dir)
        if not mask_dir:
            self.mask_dir = self.img_dir
        else:
            self.mask_dir = [mask_dir] if isinstance(mask_dir, str) else list(mask_dir)
        self.base_size = img_size
        self.img_size: Tuple[int, int] = (img_size, img_size)
        self.stride = stride
        self._augment = augment
        self._rng = random.Random(seed)
        self._np_rng = np.random.RandomState(seed)
        if augment:
            ap = aug_param or {}
            self._mini_mosaic = ap.get("mini_mosaic", 0.0)
            self._augment_hsv = ap.get("hsv", 0.0)
            self._flip_lr = ap.get("flip_lr", 0.0)
            self._neg = ap.get("neg", 0.0)
            size_range = ap.get("size_range", [-1])
            if size_range[0] != -1:
                mn = round(img_size * size_range[0] / stride) * stride
                mx = round(img_size * size_range[1] / stride) * stride
                self.valid_size = np.arange(mn, mx + 1, stride)
                self.multi_size = True
            else:
                self.valid_size = None
                self.multi_size = False

        self.img_mask_list: List[Tuple[str, str]] = []
        for d in self.img_dir:
            for filep in sorted(glob.glob(osp.join(d, "*"))):
                suffix = Path(filep).suffix
                if suffix.lower() not in IMG_EXT:
                    continue
                maskname = "mask-" + osp.basename(filep).replace(suffix, ".png")
                for md in self.mask_dir:
                    maskp = osp.join(md, maskname)
                    if osp.exists(maskp):
                        self.img_mask_list.append((filep, maskp))
        n = len(self.img_mask_list)
        self.imgs: List[Optional[np.ndarray]] = [None] * n
        self.masks: List[Optional[np.ndarray]] = [None] * n
        if cache:
            gb = 0.0
            for i in range(n):
                img, mask = self.load_pair(i, self.base_size)
                self.masks[i] = mask
                gb += mask.nbytes / 1e9
                if gb > CACHE_CAP_GB:
                    break

    def __len__(self) -> int:
        return len(self.img_mask_list)

    def initialize(self) -> None:
        """Resample the epoch's global image size (multi-size training)."""
        if self._augment and getattr(self, "multi_size", False):
            s = int(self._rng.choice(list(self.valid_size)))
            self.img_size = (s, s)

    def load_pair(self, i: int, max_size=None):
        imp, maskp = self.img_mask_list[i]
        img = self.imgs[i]
        mask = self.masks[i]
        if img is None:
            img = imread(imp)
        if mask is None:
            mask = imread(maskp, grayscale=True)
        if max_size is not None:
            if isinstance(max_size, tuple):
                max_size = max_size[0]
            img = resize_keepasp_np(img, max_size, fast=True)
            mask = resize_keepasp_np(mask, max_size, fast=True)
        return img, mask

    def _apply_augment(self, img, mask):
        im_h, im_w = img.shape[:2]
        if im_h > im_w and self._rng.random() < self._mini_mosaic:
            img, mask = self.mini_mosaic(img, mask)
        img, _, _ = letterbox_fast_np(img, self.img_size)
        mask, _, _ = letterbox_fast_np(mask, self.img_size)
        if self._rng.random() < self._augment_hsv:
            img = augment_hsv(np.ascontiguousarray(img), rng=self._np_rng)
        if self._rng.random() < self._flip_lr:
            img, mask = flip_lr(img), flip_lr(mask)
        if self._rng.random() < self._neg:
            img = negate(img)
        return img, mask

    def mini_mosaic(self, img, mask):
        """Paste a second tall page side-by-side (reference seg_dataset.py:70-88)."""
        im_h, im_w = img.shape[:2]
        idx = self._rng.randint(0, len(self) - 1)
        img2, mask2 = self.load_pair(idx, self.img_size)
        img2_h, img2_w = img2.shape[:2]
        ratio = img2_h / im_h
        if img2_h > img2_w and 0.4 < ratio < 1.6:
            H = max(im_h, img2_h)
            W = im_w + img2_w
            im_tmp = np.zeros((H, W, 3), np.uint8)
            im_tmp[:im_h, :im_w] = img
            im_tmp[:img2_h, im_w:] = img2
            mask_tmp = np.zeros((H, W), np.uint8)
            mask_tmp[:im_h, :im_w] = mask
            mask_tmp[:img2_h, im_w:] = mask2
            return im_tmp, mask_tmp
        return img, mask

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        img, mask = self.load_pair(idx, self.img_size)
        if self._augment:
            img, mask = self._apply_augment(img, mask)
        else:
            img, _, _ = letterbox_fast_np(img, self.img_size)
            mask, _, _ = letterbox_fast_np(mask, self.img_size)
        # training color contract: RGB/255 float (see module docstring)
        if self.as_uint8:
            return np.ascontiguousarray(img[:, :, ::-1]), (mask > 30).astype(np.uint8)
        img = img[:, :, ::-1].astype(np.float32) / 255.0
        mask = (mask > 30).astype(np.float32)
        return img, mask


class PrefetchLoader:
    """Threaded batch loader: decodes/augments the next batch on host while
    the device computes (the double-buffering half of the volume pipeline)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, prefetch: int = 2, seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = max(1, min(batch_size, len(dataset)))
        self.shuffle = shuffle
        self.prefetch = prefetch
        self._rng = random.Random(seed)
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return max(n, 1) if len(self.dataset) else 0

    def __iter__(self) -> Iterator:
        order = list(range(len(self.dataset)))
        if self.shuffle:
            self._rng.shuffle(order)
        batches = [
            order[i : i + self.batch_size] for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        error: list = []

        def worker():
            try:
                for idxs in batches:
                    items = [self.dataset[i] for i in idxs]
                    q.put(tuple(np.stack(col) for col in zip(*items)) if not isinstance(items[0], dict) else _stack_dicts(items))
            except BaseException as e:  # surface loader errors in the consumer
                error.append(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item
        if error:
            raise error[0]


def _stack_dicts(items):
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        try:
            out[k] = np.stack(vals)
        except ValueError:
            out[k] = vals  # ragged (e.g. text_polys): keep as list
    return out


def create_dataloader(
    img_dir,
    mask_dir,
    imgsz: int,
    batch_size: int,
    augment: bool = False,
    aug_param=None,
    cache: bool = False,
    workers: int = 2,
    shuffle: bool = False,
    as_uint8: bool = False,
):
    dataset = SegDataset(img_dir, mask_dir, imgsz, augment, aug_param, cache, as_uint8=as_uint8)
    loader = PrefetchLoader(dataset, batch_size, shuffle=shuffle, prefetch=max(2, workers))
    return dataset, loader
