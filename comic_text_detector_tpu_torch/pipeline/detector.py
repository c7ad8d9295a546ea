"""TextDetector — the end-to-end page -> (mask, mask_refined, blk_list) API.

Counterpart of the JAX package's ``pipeline/detector.py::TextDetector``, in
float32 or (``half=True``) bf16.  One device step runs upload, cv2-exact
letterbox, the three-head net, NMS, the grey mask's finalize (K6), the DB
decode and, where the device refine or the packed transfer needs it, the
un-letterbox of the grey mask to page resolution (cv2-exact, the JAX
package's ``_upsample_mask``).  With ``mask_transfer="grey"`` the mask comes
back at letterbox resolution and the host resizes it to the page as the JAX
package does (``ops/resize.py::resize_bilinear_fast``).  The host then
groups blocks and lines (each stage a span of ``utils/profiling.py``: ``page``
with ``step``, ``download``, ``group``, ``refine``, ``fetch``, one unit a
request).  The mask is refined on the host
(``refine_backend="host"``, the default) or on the device (``"device"``:
``ops/refine.py``, reading the page and the page-resolution grey mask the
device step already holds).  With ``mask_transfer="packed"`` (device refine
only) the raw mask comes back binarised at > 30 and packed 1 bit a pixel, as
the refined mask always does with the device refine.

Colour contract: the input is a BGR uint8 page and the net reads BGR/255.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from comic_text_detector_tpu_torch import constants as C
from comic_text_detector_tpu_torch.config import YOLOV5S_CFG
from comic_text_detector_tpu_torch.export.program import load_exported, read_sidecar
from comic_text_detector_tpu_torch.models.detector import TextDetBase, build_inference_model
from comic_text_detector_tpu_torch.models.init import random_variables
from comic_text_detector_tpu_torch.ops.bits import packbits_rows
from comic_text_detector_tpu_torch.ops.db_decode import boxes_from_device_rects, db_decode_full_device
from comic_text_detector_tpu_torch.ops.finalize import mask_to_u8
from comic_text_detector_tpu_torch.ops.nms import nms_single
from comic_text_detector_tpu_torch.ops.refine import check_bounds, refine_page
from comic_text_detector_tpu_torch.ops.resize import (
    letterbox_device_u8,
    letterbox_np,
    letterbox_shape,
    resize_bilinear_fast,
    resize_cv2exact_u8,
)
from comic_text_detector_tpu_torch.postproc.textblock import TextBlock, group_output
from comic_text_detector_tpu_torch.postproc.textmask import refine_mask, refine_undetected_mask
from comic_text_detector_tpu_torch.utils.device import resolve_device
from comic_text_detector_tpu_torch.utils.profiling import count, new_unit, span, to_host
from comic_text_detector_tpu_torch.utils.serialization import msgpack_restore, to_bytes
from comic_text_detector_tpu_torch.utils.imgproc import (
    connected_components_with_stats,
    expand_textwindow,
    intersect_area,
    threshold_binary,
)
from comic_text_detector_tpu_torch.weights import load_model_file, state_dict_from_jax, variables_from_state_dict


def preprocess_img(img: np.ndarray, input_size=(1024, 1024), to_tensor: bool = True):
    """Host preprocessing of the reference's free function
    (inference.py:72-83): cv2-exact letterbox and, with ``to_tensor``,
    (1, S, S, 3) float32 / 255; returns (img_in, ratio, dw, dh).  The net
    reads BGR, as the page comes."""
    if isinstance(input_size, int):
        input_size = (input_size, input_size)
    img_in, ratio, (dw, dh) = letterbox_np(img, input_size)
    if to_tensor:
        img_in = img_in[None].astype(np.float32) / 255.0
    return img_in, ratio, int(dw), int(dh)


def postprocess_mask(mask, thresh=None) -> np.ndarray:
    """Squeeze, threshold where ``thresh`` is given, x255 as uint8
    (reference inference.py:85-99)."""
    if isinstance(mask, torch.Tensor):
        mask = mask.detach().cpu().numpy()
    m = np.asarray(mask).squeeze()
    if thresh is not None:
        m = m > thresh
    return (m * 255).astype(np.uint8)


def postprocess_yolo(rows: np.ndarray, count: int, resize_ratio):
    """Fixed NMS rows -> (boxes int32, classes, confs) ragged triple
    (reference inference.py:101-114)."""
    det = np.asarray(rows)[:count].copy()
    det[:, [0, 2]] *= resize_ratio[0]
    det[:, [1, 3]] *= resize_ratio[1]
    return det[:, 0:4].astype(np.int32), det[:, 5].astype(np.int32), np.round(det[:, 4], 3)


def scale_lines(dboxes, dscores, dvalid, size: int, box_thresh: float, resize_ratio):
    """Device DB rects of one page -> int32 line quads in page coordinates
    (an empty list when none passes ``box_thresh``)."""
    lines, scores = boxes_from_device_rects(dboxes, dscores, dvalid, size, size, size, size)
    if len(scores):
        lines = lines[scores > box_thresh]
    if lines.size == 0:
        return []
    lines = lines.astype(np.float64)
    lines[..., 0] *= resize_ratio[0]
    lines[..., 1] *= resize_ratio[1]
    return lines.astype(np.int32)


def build_model(variables, model_path: Optional[str], cfg: Optional[dict], act: str, dtype: torch.dtype,
                device: torch.device, input_size: int):
    """The three-head net with its weights, on ``device``, computing in
    ``dtype`` (float32 parameters whatever it is).  The weights come from
    ``variables`` (JAX layout) or ``model_path``: a ``.pt2`` (a program
    from ``export/program.py::export_program``, which stands in for the
    module; its act, dtype and ``input_size`` must be these) or a file of
    weights that ``weights.py::load_model_file`` reads (``.npz``, ``.onnx``,
    a reference ``.pt``)."""
    path = None if model_path is None else str(model_path)
    if variables is not None:
        model_cfg = cfg or YOLOV5S_CFG
        state = state_dict_from_jax(variables, model_cfg)
    elif path is None:
        raise ValueError("provide model_path or variables")
    elif path.endswith(".pt2"):
        meta = read_sidecar(path)
        dtype_name = str(dtype).removeprefix("torch.")
        if (meta["act"], meta["dtype"]) != (act, dtype_name):
            raise ValueError(f"{path} computes with act {meta['act']!r} in {meta['dtype']}, "
                             f"not act {act!r} in {dtype_name}")
        if meta["input"][2] != input_size:
            raise ValueError(f"{path} was exported at input size {meta['input'][2]} (its sidecar "
                             f"{path}.json), not {input_size}")
        return load_exported(path, device)
    else:
        state, model_cfg = load_model_file(path, cfg)
    model = build_inference_model(model_cfg, act=act, dtype=dtype)
    model.load_state_dict(state, strict=True)
    return model.to(device)


def run_net(model, lb_u8: torch.Tensor):
    """(B, S, S, 3) uint8 letterboxed pages -> the net's float32 outputs.
    The input is /255 in float32, then cast to the compute dtype by the
    model; float32 convolutions run without TF32, as the JAX package's do,
    and only through cuDNN's deterministic algorithms, so that a page gives
    the same bits on every call (on the H100 the default algorithm of the
    float32 transposed convolutions sums in another order from call to
    call)."""
    x = lb_u8.permute(0, 3, 1, 2).to(torch.float32) / 255.0
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        return model(x)


class TextDetector:
    """Comic/manga page text detector.

    Usage::

        det = TextDetector("data/flagship_r2.npz")      # .npz, .pt, .onnx or .pt2
        mask, mask_refined, blk_list = det(img_bgr)     # uint8 BGR page

    Runs on ``device="cuda"``; ``device="cpu"`` must be asked for.
    ``half=True`` runs the net in bf16, as does ``compute_dtype=
    torch.bfloat16`` (which, where given, decides).  ``cfg`` is the YOLO
    graph's (a checkpoint's embedded cfg; ``YOLOV5S_CFG`` by default).
    ``save_variables`` / ``from_native`` write and read the native (flax
    msgpack) format; ``random_init`` gives a detector of seeded random
    weights.
    """

    lang_list = C.LANG_LIST
    langcls2idx = C.LANGCLS2IDX

    def __init__(
        self,
        model_path: Optional[str] = None,
        input_size: int = C.DEFAULT_INPUT_SIZE,
        device: str = "cuda",
        half: bool = False,
        nms_thresh: float = C.DEFAULT_NMS_THRESH,
        conf_thresh: float = C.DEFAULT_CONF_THRESH,
        mask_thresh: float = C.DEFAULT_MASK_THRESH,
        act: str = "leaky",
        variables=None,
        cfg: Optional[dict] = None,
        compute_dtype: Optional[torch.dtype] = None,
        refine_backend: str = "host",
        mask_transfer: str = "grey",
    ):
        # packed mode needs the device refine: the host refine reads grey values
        if mask_transfer == "packed" and refine_backend != "device":
            raise ValueError("mask_transfer='packed' requires refine_backend='device'")
        self.refine_backend = refine_backend
        self.mask_transfer = mask_transfer
        self.device = resolve_device(device)
        if isinstance(input_size, tuple):
            input_size = input_size[0]
        self.input_size = (input_size, input_size)
        self.conf_thresh = conf_thresh
        self.nms_thresh = nms_thresh
        self.mask_thresh = mask_thresh
        self.db_thresh = C.DEFAULT_DB_THRESH
        self.box_thresh = C.DEFAULT_BOX_THRESH
        self.unclip_ratio = C.DEFAULT_UNCLIP_RATIO

        if compute_dtype is None:
            compute_dtype = torch.bfloat16 if half else torch.float32
        self.compute_dtype = compute_dtype
        self.model = build_model(variables, model_path, cfg, act, compute_dtype, self.device, input_size)

    @classmethod
    def random_init(cls, input_size: int = C.DEFAULT_INPUT_SIZE, act: str = "leaky", seed: int = 0,
                    device: str = "cuda", **kw) -> "TextDetector":
        """A detector of random weights on the shipped graph (tests,
        architecture work): ``models/init.py::apply_reference_init`` from
        a ``torch.Generator`` seeded with ``seed`` (He-normal kernels, unit
        BatchNorm scale, zero shifts and biases; running mean 0, variance
        1).  The values are not the JAX package's (another RNG and
        recipe); the shapes and dtypes are."""
        return cls(variables=random_variables(seed), input_size=input_size, act=act, device=device, **kw)

    def save_variables(self, path: str) -> None:
        """Write the weights in the native format, the bytes the JAX
        package's ``save_variables`` writes for the same weights."""
        if not isinstance(self.model, TextDetBase):
            raise ValueError("this detector runs a .pt2 program, which holds no variables to save")
        with open(path, "wb") as f:
            f.write(to_bytes(variables_from_state_dict(self.model.state_dict())))

    @classmethod
    def from_native(cls, path: str, input_size: int = C.DEFAULT_INPUT_SIZE, act: str = "leaky",
                    device: str = "cuda", **kw) -> "TextDetector":
        """A detector from a native-format file (the port's or the JAX
        package's ``save_variables``)."""
        with open(path, "rb") as f:
            variables = msgpack_restore(f.read())
        return cls(variables=variables, input_size=input_size, act=act, device=device, **kw)

    @torch.no_grad()
    def _device_step(self, img: np.ndarray):
        """Upload -> letterbox -> net -> NMS, mask finalize and DB decode;
        every output stays on the device.  The mask to download is the
        letterbox-resolution grey mask (``"grey"``) or the page-resolution
        one binarised at > 30 and packed (``"packed"``).  Also returns the
        uploaded page and the page-resolution grey mask (None unless the
        device refine or the packed transfer needs it)."""
        size = self.input_size[0]
        im_h, im_w = img.shape[:2]
        _, _, dw, dh, _ = letterbox_shape(im_h, im_w, size)
        with span("upload"):
            count("host_syncs")  # a blocking copy from pageable memory: waits for the stream
            img_dev = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        with span("letterbox"):
            lb = letterbox_device_u8(img_dev, size)[None]
        with span("net"):
            blks, mask, lines = run_net(self.model, lb)
        with span("nms"):
            rows, n_rows = nms_single(blks[0].to(torch.float32), self.conf_thresh, self.nms_thresh)
        with span("finalize"):
            mask_full = mask_to_u8(mask[0, 0])
        with span("decode"):
            boxes, scores, valid = db_decode_full_device(lines[0, 0].to(torch.float32), self.db_thresh)
        with span("resize"):
            mask_page = None
            if self.refine_backend == "device" or self.mask_transfer == "packed":
                mask_page = resize_cv2exact_u8(mask_full[: size - dh, : size - dw], (im_h, im_w))
            if self.mask_transfer == "packed":
                mask_out = packbits_rows(mask_page > 30)
            else:
                mask_out = mask_full[: size - dh, : size - dw]
        return rows, n_rows, mask_out, boxes, scores, valid, img_dev, mask_page

    def __call__(
        self,
        img: np.ndarray,
        refine_mode: int = C.REFINEMASK_INPAINT,
        keep_undetected_mask: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray, List[TextBlock]]:
        with span("page", new_unit()):
            return self._page(img, refine_mode, keep_undetected_mask)

    def _page(self, img: np.ndarray, refine_mode: int, keep_undetected_mask: bool):
        im_h, im_w = img.shape[:2]
        size = self.input_size[0]
        _, _, dw, dh, _ = letterbox_shape(im_h, im_w, size)
        with span("step"):
            *host_out, img_dev, mask_dev = self._device_step(img)
        with span("download"):
            rows, n_rows, mask_out, dboxes, dscores, dvalid = (to_host(t) for t in host_out)

        with span("group"):
            if self.mask_transfer == "packed":
                mask = unpack_rows(mask_out, im_w)
            else:
                mask = resize_bilinear_fast(mask_out, (im_h, im_w))
            resize_ratio = (im_w / (size - dw), im_h / (size - dh))
            blks = postprocess_yolo(rows, int(n_rows), resize_ratio)
            lines = scale_lines(dboxes, dscores, dvalid, size, self.box_thresh, resize_ratio)
            blk_list = group_output(blks, lines, im_w, im_h, mask)
        if self.refine_backend == "device":
            mask_refined = _refine_on_device(
                img_dev, mask_dev, blk_list, img.shape, refine_mode, mask if keep_undetected_mask else None
            )
        else:
            with span("refine"):
                mask_refined = refine_mask(img, mask, blk_list, refine_mode=refine_mode)
                if keep_undetected_mask:
                    mask_refined = refine_undetected_mask(img, mask, mask_refined, blk_list, refine_mode=refine_mode)
        return mask, mask_refined, blk_list


def unpack_rows(packed: np.ndarray, width: int) -> np.ndarray:
    """1-bpp rows -> 0/255 uint8, cropped to ``width`` (packbits pads)."""
    return (np.unpackbits(packed, axis=-1) * np.uint8(255))[..., :width]


def _download_canvas(canvas: torch.Tensor, im_w: int) -> np.ndarray:
    """Binary canvas -> host 0/255 uint8, shipped 1 bit a pixel."""
    return unpack_rows(to_host(packbits_rows(canvas > 0)), im_w)


def _refine_on_device(img_dev, mask_dev, blk_list, img_shape, refine_mode, undetected_mask=None) -> np.ndarray:
    """Device refine at the original page resolution: the uploaded page and
    the page-resolution grey mask are already on the device, and every
    block window refines in batched dispatches (``ops/refine.py``)."""
    im_w = img_shape[1]
    with span("refine"):
        windows = [expand_textwindow(img_shape, blk.xyxy, expand_r=16) for blk in blk_list]
        canvas = refine_page(img_dev, mask_dev, np.asarray(windows).reshape(-1, 4), refine_mode)
        made = [canvas]
        if undetected_mask is not None:
            refined_orig = _download_canvas(canvas, im_w)
            check_bounds(canvas)
            extra = _rescue_undetected_device(
                img_dev, mask_dev, canvas, refined_orig, undetected_mask, blk_list, img_shape, refine_mode
            )
            if extra is None:
                return refined_orig
            made.append(extra)
            canvas = canvas | extra
    with span("fetch"):
        refined = _download_canvas(canvas, im_w)
    check_bounds(*made)  # the download waited for the refine
    return refined


def _rescue_undetected_device(
    img_dev, mask_dev, canvas, refined_host, undetected_mask, blk_list, img_shape, refine_mode
):
    """Rescue raw-mask components no block covers (reference
    textmask.py:135-156): CC over the host raw mask minus the refined area
    picks the windows, the refine runs on the device.  Returns the extra
    device canvas, or None when nothing needs rescuing."""
    rescue_mask = undetected_mask.copy()
    rescue_mask[refined_host > 30] = 0
    # already-refined areas are left out of the rescue's prediction too
    mask_excl = torch.where(canvas > 30, 0, mask_dev)
    pred_t = threshold_binary(rescue_mask, 30)
    n, _labels, stats, _c = connected_components_with_stats(pred_t, 4)
    boxes = []
    for li in range(1, n):
        x, y, w, h, area = stats[li]
        if area <= 50:
            continue
        bbox = [x, y, x + w, y + h]
        best = max((intersect_area(blk.xyxy, bbox) for blk in blk_list), default=-1)
        if best / w / h < 0.5:
            boxes.append(expand_textwindow(img_shape, bbox, expand_r=16))
    if not boxes:
        return None
    return refine_page(img_dev, mask_excl, np.asarray(boxes), refine_mode)
