"""DB-head training dataset (img + ``line-*.txt`` 8-coord polygons).

Own copy of the JAX package's ``data/db_dataset.py``, with the same draws
in the same order as ``data/seg_dataset.py`` says.  The rotation augment
needs Pillow (``data/augment.py``).

The JAX package's: a torch-free re-design of the reference LoadImageAndAnnotations
(db_dataset.py:43-248): same pairing/normalization conventions, rotation
augment with polygon rotation, per-sample shrink/border map generation, and
ragged-aware batching (text_polys kept as lists for the val metric).
"""

from __future__ import annotations

import glob
import os
import os.path as osp
import random
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from comic_text_detector_tpu_torch.data.augment import augment_hsv, flip_lr, negate, rotate_image_and_polys
from comic_text_detector_tpu_torch.data.maps import MakeBorderMap, MakeShrinkMap
from comic_text_detector_tpu_torch.data.seg_dataset import PrefetchLoader
from comic_text_detector_tpu_torch.ops.resize import letterbox_fast_np, resize_keepasp_np
from comic_text_detector_tpu_torch.utils.io import IMG_EXT, imread


class DBDataset:
    def __init__(
        self,
        img_dir,
        ann_dir=None,
        img_size: int = 640,
        augment: bool = False,
        aug_param: Optional[dict] = None,
        cache: bool = False,
        stride: int = 128,
        with_ann: bool = False,
        seed: int = 0,
        as_uint8: bool = False,
    ):
        self.as_uint8 = as_uint8  # uint8 RGB upload, device-side /255
        self.img_dir = [img_dir] if isinstance(img_dir, str) else list(img_dir)
        if not ann_dir:
            self.ann_dir = self.img_dir
        else:
            self.ann_dir = [ann_dir] if isinstance(ann_dir, str) else list(ann_dir)
        self.with_ann = with_ann
        self.make_border_map = MakeBorderMap(shrink_ratio=0.4)
        self.make_shrink_map = MakeShrinkMap(shrink_ratio=0.4)
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
            self._rotate = ap.get("rotate", 0.0)
            self.rotate_range = ap.get("rotate_range", [-70, 70])
            size_range = ap.get("size_range", [-1])
            if isinstance(size_range, list) and size_range[0] > 0:
                mn = round(img_size * size_range[0] / stride) * stride
                mx = round(img_size * size_range[1] / stride) * stride
                self.valid_size = np.arange(mn, mx + 1, stride)
                self.multi_size = True
            else:
                self.valid_size = None
                self.multi_size = False

        self.img_ann_list: List[Tuple[str, str]] = []
        for d in self.img_dir:
            for filep in sorted(glob.glob(osp.join(d, "*"))):
                suffix = Path(filep).suffix
                if suffix.lower() not in IMG_EXT:
                    continue
                annname = "line-" + osp.basename(filep).replace(suffix, ".txt")
                for ad in self.ann_dir:
                    annp = osp.join(ad, annname)
                    if osp.exists(annp):
                        self.img_ann_list.append((filep, annp))

    def __len__(self) -> int:
        return len(self.img_ann_list)

    def initialize(self) -> None:
        if self._augment and getattr(self, "multi_size", False):
            s = int(self._rng.choice(list(self.valid_size)))
            self.img_size = (s, s)

    def load_item(self, i: int, max_size=None):
        imp, annp = self.img_ann_list[i]
        img = imread(imp)
        im_h, im_w = img.shape[:2]
        ann = np.loadtxt(annp)
        if ann.size == 0:
            # textless page (pure-negative example: batch-level OHEM then
            # supervises its hardest false-positive pixels); an empty file
            # otherwise reshapes to one 0-point "polygon" and crashes the
            # map validators
            ann = np.zeros((0, 4, 2), np.float64)
        else:
            if ann.ndim == 1:
                ann = ann[None]
            ann = ann.astype(np.float64)
            ann[:, ::2] /= im_w
            ann[:, 1::2] /= im_h
            ann = ann.reshape(len(ann), -1, 2)
        if max_size is not None:
            if isinstance(max_size, tuple):
                max_size = max_size[0]
            img = resize_keepasp_np(img, max_size, fast=True)
        return img, ann

    def mini_mosaic(self, img, ann):
        im_h, im_w = img.shape[:2]
        idx = self._rng.randint(0, len(self) - 1)
        img2, ann2 = self.load_item(idx, self.img_size)
        img2_h, img2_w = img2.shape[:2]
        if img2_h > img2_w:
            H = max(im_h, img2_h)
            W = im_w + img2_w
            im_tmp = np.zeros((H, W, 3), np.uint8)
            im_tmp[:im_h, :im_w] = img
            im_tmp[:img2_h, im_w:] = img2
            ann = ann.copy()
            ann[:, :, 0] = ann[:, :, 0] * im_w / W
            ann[:, :, 1] = ann[:, :, 1] * im_h / H
            if ann2.shape[0] > 0:
                ann2 = ann2.copy()
                ann2[:, :, 0] = ann2[:, :, 0] * img2_w / W + im_w / W
                ann2[:, :, 1] = ann2[:, :, 1] * img2_h / H
                ann = np.concatenate((ann, ann2))
            return im_tmp, ann
        return img, ann

    def _apply_augment(self, img, ann):
        im_h, im_w = img.shape[:2]
        if im_h > im_w and self._rng.random() < self._mini_mosaic:
            img, ann = self.mini_mosaic(img, ann)
        if self._rng.random() < self._augment_hsv:
            img = augment_hsv(np.ascontiguousarray(img), rng=self._np_rng)
        if self._rng.random() < self._flip_lr:
            img = flip_lr(img)
            ann = ann.copy()
            ann[:, :, 0] = 1 - ann[:, :, 0]
        if self._rng.random() < self._neg:
            img = negate(img)
        if self._rng.random() < self._rotate:
            degrees = self._rng.uniform(self.rotate_range[0], self.rotate_range[1])
            if abs(degrees) > 15:
                img, ann = rotate_image_and_polys(img, ann, degrees)
        return img, ann

    def __getitem__(self, idx: int) -> dict:
        if getattr(self, "cache_prepared", False):
            return self._cached_item(idx)
        return self._finalize(self._build_item(idx))

    def _build_item(self, idx: int) -> dict:
        img, ann = self.load_item(idx, self.img_size)
        if self._augment and not getattr(self, "cache_prepared", False):
            img, ann = self._apply_augment(img, ann)
        ignore_tags = [False] * ann.shape[0]
        img, _, (dw, dh) = letterbox_fast_np(img, self.img_size)
        im_h, im_w = img.shape[:2]
        ann = ann.copy()
        ann[:, :, 0] *= im_w - dw
        ann[:, :, 1] *= im_h - dh
        ann = ann.astype(np.int64)
        data = {"imgs": img, "text_polys": ann, "ignore_tags": ignore_tags}
        data = self.make_shrink_map(data)
        data = self.make_border_map(data)
        data["content_wh"] = (im_w - dw, im_h - dh)
        return data

    def _finalize(self, data: dict) -> dict:
        data = dict(data)
        data.pop("content_wh", None)
        tp = data.pop("text_polys")
        it = data.pop("ignore_tags")
        if self.with_ann:
            data["text_polys"] = np.array(tp)
            data["ignore_tags"] = np.array(it)
        if self.as_uint8:
            data["imgs"] = np.ascontiguousarray(data["imgs"][:, :, ::-1])  # RGB uint8
        else:
            data["imgs"] = data["imgs"][:, :, ::-1].astype(np.float32) / 255.0  # RGB/255
        return data

    # --- prepared-sample cache --------------------------------------------
    #
    # Per-sample shrink/border map generation + PNG decode is the DB train
    # step's host bottleneck (a host with few cores cannot hide it behind
    # device compute).  With rotation/multi-size off, the letterboxed image + GT
    # maps are deterministic: cache them once (maps as float16, ~2.3 MB per
    # 512px sample — thousands of pages fit in RAM), then apply only the
    # cheap augments (content-region flip of image+maps together, HSV /
    # negate of the image alone) per epoch.

    def enable_prepared_cache(self, disk_dir: str | None = None) -> None:
        if self._augment and (getattr(self, "multi_size", False) or self._rotate or self._mini_mosaic):
            raise ValueError(
                "cache_prepared requires rotate/mini_mosaic/multi-size off "
                "(those augments change the GT maps per epoch)"
            )
        if self._augment and self.with_ann:
            raise ValueError(
                "cache_prepared+augment leaves text_polys unflipped — "
                "use it only for training loaders (with_ann=False)"
            )
        self.cache_prepared = True
        self._prep_cache: dict = {}
        # optional disk tier: prepared samples are deterministic, so chunked
        # training runs (process restarts) reload them instead of re-paying
        # per-sample map generation
        self._prep_disk = disk_dir
        if disk_dir:
            os.makedirs(disk_dir, exist_ok=True)

    def _cached_item(self, idx: int) -> dict:
        got = self._prep_cache.get(idx)
        if got is None and self._prep_disk:
            p = os.path.join(self._prep_disk, f"prep_{self.base_size}_{idx}.npz")
            if os.path.exists(p):
                with np.load(p, allow_pickle=True) as z:
                    got = {k: z[k] for k in z.files}
                got["text_polys"] = got["text_polys"].tolist()
                got["ignore_tags"] = got["ignore_tags"].tolist()
                got["content_wh"] = tuple(got["content_wh"])
                self._prep_cache[idx] = got
        if got is None:
            data = self._build_item(idx)
            got = {
                "imgs": data["imgs"],
                "shrink_map": data["shrink_map"].astype(np.float16),
                "shrink_mask": data["shrink_mask"].astype(np.float16),
                "threshold_map": data["threshold_map"].astype(np.float16),
                "threshold_mask": data["threshold_mask"].astype(np.float16),
                "text_polys": data["text_polys"],
                "ignore_tags": data["ignore_tags"],
                "content_wh": data["content_wh"],
            }
            self._prep_cache[idx] = got
            if self._prep_disk:
                p = os.path.join(self._prep_disk, f"prep_{self.base_size}_{idx}.npz")
                if not os.path.exists(p):
                    np.savez(
                        p,
                        **{
                            k: (np.asarray(v, dtype=object) if k in ("text_polys", "ignore_tags")
                                else np.asarray(v))
                            for k, v in got.items()
                        },
                    )
        data = {
            k: (v.astype(np.float32) if isinstance(v, np.ndarray) and v.dtype == np.float16 else v)
            for k, v in got.items()
        }
        if self._augment:
            cw, ch = data["content_wh"]
            if self._rng.random() < self._flip_lr:
                for k in ("imgs", "shrink_map", "shrink_mask", "threshold_map", "threshold_mask"):
                    a = data[k].copy()
                    a[:ch, :cw] = a[:ch, cw - 1::-1]  # flip content, pad stays right
                    data[k] = a
            if self._rng.random() < self._augment_hsv:
                data["imgs"] = augment_hsv(np.ascontiguousarray(data["imgs"]), rng=self._np_rng)
            if self._rng.random() < self._neg:
                data["imgs"] = negate(data["imgs"])
        return self._finalize(data)


def create_dataloader(
    img_dir,
    ann_dir,
    imgsz: int,
    batch_size: int,
    augment: bool = False,
    aug_param=None,
    cache: bool = False,
    workers: int = 2,
    shuffle: bool = False,
    with_ann: bool = False,
    as_uint8: bool = False,
):
    dataset = DBDataset(
        img_dir, ann_dir, imgsz, augment, aug_param, cache, with_ann=with_ann, as_uint8=as_uint8
    )
    loader = PrefetchLoader(dataset, batch_size, shuffle=shuffle, prefetch=max(2, workers))
    return dataset, loader
