"""Batch annotation, the weak-supervision label factory.

Counterpart of the JAX package's ``pipeline/annotations.py`` (reference
``model2annotations``, inference.py:19-70): walk image directories, run the
detector with the annotation-mode refine, and write YOLO labels, line
polygons, refined masks and, on request, the blocks as JSON.  The file names
(``mask-*``, ``line-*``) are the contract the training datasets read
(``data/seg_dataset.py``, ``data/db_dataset.py``).
"""

from __future__ import annotations

import json
import os
import os.path as osp
from pathlib import Path
from typing import List, Union

import numpy as np

from comic_text_detector_tpu_torch.constants import REFINEMASK_ANNOTATION
from comic_text_detector_tpu_torch.pipeline.detector import TextDetector
from comic_text_detector_tpu_torch.utils.imgproc import get_yololabel_strings, xyxy2yolo
from comic_text_detector_tpu_torch.utils.io import NumpyEncoder, find_all_imgs, imread, imwrite


def _images(img_dir_list: Union[str, List[str]]) -> List[str]:
    if isinstance(img_dir_list, str):
        img_dir_list = [img_dir_list]
    return [p for d in img_dir_list for p in find_all_imgs(d, abs_path=True)]


def model2annotations(
    model_path: Union[str, TextDetector],
    img_dir_list: Union[str, List[str]],
    save_dir: str,
    save_json: bool = False,
    input_size: int = 1024,
    progress: bool = True,
    device: str = "cuda",
) -> None:
    """Annotate every image of ``img_dir_list`` into ``save_dir``: the page
    (as PNG), ``<name>.txt`` (YOLO labels, class 1 a block),
    ``line-<name>.txt`` (line quads, where there are lines),
    ``mask-<name>.png`` (the refined mask) and with ``save_json``
    ``<name>.json`` (the blocks).  ``model_path`` is a model file for
    ``TextDetector`` (run on ``device``) or a ``TextDetector``."""
    if isinstance(model_path, TextDetector):
        model = model_path
    else:
        model = TextDetector(model_path=model_path, input_size=input_size, act="leaky", device=device)
    imglist = _images(img_dir_list)
    it = imglist
    if progress:
        try:
            from tqdm import tqdm

            it = tqdm(imglist)
        except ImportError:
            pass
    for img_path in it:
        imgname = osp.basename(img_path)
        img = imread(img_path)
        im_h, im_w = img.shape[:2]
        imname = imgname.replace(Path(imgname).suffix, "")
        _mask, mask_refined, blk_list = model(img, refine_mode=REFINEMASK_ANNOTATION, keep_undetected_mask=True)
        polys = [line for blk in blk_list for line in blk.lines]
        blk_yolo = xyxy2yolo([blk.xyxy for blk in blk_list], im_w, im_h)
        yolo_label = "" if blk_yolo is None else get_yololabel_strings([1] * len(blk_yolo), blk_yolo)
        with open(osp.join(save_dir, imname + ".txt"), "w", encoding="utf8") as f:
            f.write(yolo_label)
        if polys:
            np.savetxt(osp.join(save_dir, "line-" + imname + ".txt"), np.array(polys).reshape(-1, 8), fmt="%d")
        if save_json:
            with open(osp.join(save_dir, imname + ".json"), "w", encoding="utf8") as f:
                f.write(json.dumps([blk.to_dict() for blk in blk_list], ensure_ascii=False, cls=NumpyEncoder))
        imwrite(osp.join(save_dir, imgname), img)
        imwrite(osp.join(save_dir, "mask-" + imname + ".png"), mask_refined)


def traverse_by_dict(img_dir_list: Union[str, List[str]], dict_dir: str, save_dir: Union[str, None] = None) -> None:
    """Reload saved block JSON and masks, refine again and save
    visualisations (``viz-*.png``) and refined masks (``refined-*.png``):
    the reference's traverse_by_dict debug loop (inference.py:180-200),
    writing files instead of showing windows.  Host only; the drawing needs
    Pillow (``postproc/textblock.py::visualize_textblocks``), which is not
    among the packages the card's machine is stated to have."""
    from comic_text_detector_tpu_torch.postproc.textblock import TextBlock, visualize_textblocks
    from comic_text_detector_tpu_torch.postproc.textmask import refine_mask

    save_dir = save_dir or dict_dir
    os.makedirs(save_dir, exist_ok=True)
    for img_path in _images(img_dir_list):
        imgname = osp.basename(img_path)
        imname = imgname.replace(Path(imgname).suffix, "")
        mask_path = osp.join(dict_dir, "mask-" + imname + ".png")
        json_path = osp.join(dict_dir, imname + ".json")
        if not (osp.exists(mask_path) and osp.exists(json_path)):
            continue
        with open(json_path, "r", encoding="utf8") as f:
            blk_list = [TextBlock(**d) for d in json.loads(f.read())]
        img = imread(img_path)
        mask = refine_mask(img, imread(mask_path, grayscale=True), blk_list)
        canvas = img.copy()
        visualize_textblocks(canvas, blk_list)
        imwrite(osp.join(save_dir, "viz-" + imname + ".png"), canvas)
        imwrite(osp.join(save_dir, "refined-" + imname + ".png"), mask)
