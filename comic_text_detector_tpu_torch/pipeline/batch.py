"""BatchTextDetector: the batch stream, the throughput configuration.

Counterpart of the JAX package's ``pipeline/batch.py``.  Pages are
letterboxed on the device, stacked and run through the net as one batch;
NMS runs page by page, the grey masks are finalized in one K6 launch
(``ops/finalize.py::mask_to_u8``) and the DB maps decoded as one stack
(``ops/db_decode.py::db_decode_batch``).  The host then groups each page's
blocks and lines, and the masks are refined on the host or, with
``refine_backend="device"``, in one ``refine_pages`` call per page shape.
:meth:`BatchTextDetector.stream` reads pages from an iterable in a producer
thread and keeps batches in flight, so that the next batch is uploaded and
enqueued while the host finishes the previous one.  Its stages are spans
of ``utils/profiling.py`` (``wait``; ``submit`` and ``collect`` with their
children), one unit a batch.

With ``mesh=`` (``parallel.mesh.make_mesh(devices=...)``, one process)
the detector keeps one replica of the net on each mesh device and splits
every batch into contiguous blocks of ``ceil(n / d)`` pages, as the JAX
class shards one batch over the ``data`` axis: each block runs net, NMS,
K6 and the DB decode on its device and its pages refine there, and
``collect`` returns the pages in order.  Serving is one process: a mesh
with a process group raises.

One part of the JAX class is not ported, because it only schedules work
on the TPU: padding each batch and each page-shape group to
``batch_size`` (against XLA retraces).
"""

from __future__ import annotations

import contextlib
import queue
import threading
from collections import deque
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from comic_text_detector_tpu_torch import constants as C
from comic_text_detector_tpu_torch.models.init import random_variables
from comic_text_detector_tpu_torch.ops.bits import packbits_rows
from comic_text_detector_tpu_torch.ops.db_decode import db_decode_batch
from comic_text_detector_tpu_torch.ops.finalize import mask_to_u8
from comic_text_detector_tpu_torch.ops.nms import nms_single
from comic_text_detector_tpu_torch.ops.refine import check_bounds, refine_pages
from comic_text_detector_tpu_torch.ops.resize import (
    letterbox_device_u8,
    letterbox_shape,
    resize_bilinear_fast,
    resize_cv2exact_u8,
)
from comic_text_detector_tpu_torch.parallel.mesh import replicate
from comic_text_detector_tpu_torch.pipeline.detector import (
    _rescue_undetected_device,
    build_model,
    postprocess_yolo,
    run_net,
    scale_lines,
    unpack_rows,
)
from comic_text_detector_tpu_torch.postproc.textblock import group_output
from comic_text_detector_tpu_torch.postproc.textmask import refine_mask, refine_undetected_mask
from comic_text_detector_tpu_torch.utils.device import resolve_device
from comic_text_detector_tpu_torch.utils.imgproc import expand_textwindow
from comic_text_detector_tpu_torch.utils.profiling import new_unit, span, to_host


def _on(device: torch.device):
    """Make ``device`` the current CUDA device for the kernels' launches
    (nothing to do on the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class _Ticket(list):
    """What :meth:`BatchTextDetector.submit` returns: a (device, block)
    entry per mesh device that took pages, and the unit id of the batch's
    spans (``utils/profiling.py``), which ``collect`` takes on."""

    def __init__(self, unit):
        super().__init__()
        self.unit = unit


class BatchTextDetector:
    """Fixed-batch detector: up to ``batch_size`` BGR pages per net call.

    Usage::

        det = BatchTextDetector(load_npz("data/flagship_r2.npz"))
        for mask, mask_refined, blk_list in det.stream(pages):
            ...

    ``variables`` are the JAX package's weights (``weights.load_npz``).  Runs
    on ``device="cuda"``; ``device="cpu"`` must be asked for.  ``half=True``
    (the default, as in the JAX package) runs the net in bf16.  ``mesh``
    runs each batch split over the mesh's devices (module docstring), in
    place of ``device``.
    """

    def __init__(
        self,
        variables,
        batch_size: int = 4,
        input_size: int = C.DEFAULT_INPUT_SIZE,
        act: str = "leaky",
        cfg: Optional[dict] = None,
        half: bool = True,
        conf_thresh: float = C.DEFAULT_CONF_THRESH,
        nms_thresh: float = C.DEFAULT_NMS_THRESH,
        mesh=None,
        refine_backend: str = "host",
        mask_transfer: str = "grey",
        device: str = "cuda",
    ):
        if mesh is not None and mesh.group is not None:
            raise NotImplementedError("BatchTextDetector serves from one process: pass a mesh of this process's "
                                      "devices (make_mesh(devices=...)) without a process group")
        if mask_transfer == "packed" and refine_backend != "device":
            raise ValueError("mask_transfer='packed' requires refine_backend='device'")
        self.refine_backend = refine_backend
        self.mask_transfer = mask_transfer
        self.device = resolve_device(device) if mesh is None else mesh.devices[0]
        self.batch_size = batch_size
        self.size = input_size
        self.conf_thresh = conf_thresh
        self.nms_thresh = nms_thresh
        self.db_thresh = C.DEFAULT_DB_THRESH
        self.box_thresh = C.DEFAULT_BOX_THRESH
        dtype = torch.bfloat16 if half else torch.float32
        self.model = build_model(variables, None, cfg, act, dtype, self.device, input_size)
        self.devices = [self.device] if mesh is None else list(mesh.devices)
        if mesh is not None:
            self.replicas = replicate(mesh, self.model)
            self.model = self.replicas[0]
        else:
            self.replicas = [self.model]

    @classmethod
    def random_init(cls, batch_size: int = 4, input_size: int = C.DEFAULT_INPUT_SIZE, seed: int = 0,
                    device: str = "cuda", **kw) -> "BatchTextDetector":
        """A batch detector of seeded random weights
        (``models/init.py::random_variables``)."""
        return cls(random_variables(seed), batch_size=batch_size, input_size=input_size, device=device, **kw)

    def _upload(self, img: np.ndarray, device: Optional[torch.device] = None) -> torch.Tensor:
        """Host page -> device (``self.device`` by default), through a
        pinned buffer on the card (the copy is asynchronous; the caching
        host allocator keeps the buffer until it completes)."""
        device = self.device if device is None else device
        t = torch.from_numpy(np.ascontiguousarray(img))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t

    @torch.no_grad()
    def submit(self, pages: Sequence[np.ndarray]):
        """Upload, letterbox and run one batch of pages (``stream`` sends
        ``batch_size`` at a time); returns an opaque ticket for :meth:`collect`,
        which carries the batch's unit id for the spans.  The outputs
        stay on the device until ``collect`` downloads them.  Under a mesh
        each device takes a contiguous block of ``ceil(n / d)`` pages."""
        ticket = _Ticket(new_unit())
        with span("submit", ticket.unit):
            per = -(-len(pages) // len(self.replicas))
            for i, (model, device) in enumerate(zip(self.replicas, self.devices)):
                block = list(pages[i * per:(i + 1) * per])
                if block:
                    with _on(device):
                        ticket.append((device, self._submit_block(block, model, device)))
        return ticket

    def _submit_block(self, pages: List[np.ndarray], model, device: torch.device):
        size = self.size
        metas, origs, lbs = [], [], []
        for img in pages:
            im_h, im_w = img.shape[:2]
            _, _, dw, dh, _ = letterbox_shape(im_h, im_w, size)
            with span("upload"):
                orig = self._upload(img, device)  # one upload serves letterbox AND refine
            origs.append(orig)
            with span("letterbox"):
                lbs.append(letterbox_device_u8(orig, size))
            metas.append((im_h, im_w, dw, dh))
        with span("net"):
            blks, mask, lines = run_net(model, torch.stack(lbs))
        with span("nms"):
            nms = [nms_single(b.to(torch.float32), self.conf_thresh, self.nms_thresh) for b in blks]
            rows = torch.stack([r for r, _ in nms])
            counts = torch.stack([c for _, c in nms])
        with span("finalize"):
            masks_full = mask_to_u8(mask[:, 0])
        with span("decode"):
            # the shrink maps are a page-strided view of the DB head's (B, 2, S, S)
            # output: K6 binarizes them in place, with no copy
            boxes, scores, valid = db_decode_batch(lines[:, 0], self.db_thresh)

        with span("resize"):
            mask_devs = None
            if self.refine_backend == "device" or self.mask_transfer == "packed":
                # the page-resolution grey masks, cv2-exact: the device refine
                # reads them, and packed mode ships them binarised at > 30
                mask_devs = [
                    resize_cv2exact_u8(masks_full[i, : size - dh, : size - dw], (im_h, im_w))
                    for i, (im_h, im_w, dw, dh) in enumerate(metas)
                ]
            if self.mask_transfer == "packed":
                masks_out = [packbits_rows(m > 30) for m in mask_devs]
            else:
                # crop to the batch's shared content region before the download
                min_dh = min(m[3] for m in metas)
                min_dw = min(m[2] for m in metas)
                masks_out = masks_full[:, : size - min_dh, : size - min_dw]
        outputs = (rows, counts, masks_out, boxes, scores, valid)
        extras = (origs, mask_devs) if self.refine_backend == "device" else None
        return outputs, metas, pages, extras

    @torch.no_grad()
    def collect(
        self,
        ticket,
        refine_mode: int = C.REFINEMASK_INPAINT,
        keep_undetected_mask: bool = False,
    ) -> List[Tuple[np.ndarray, np.ndarray, list]]:
        """Download one submitted batch, group each page's blocks and lines,
        refine its mask; returns [(mask, mask_refined, blk_list)] in page
        order."""
        out = []
        with span("collect", ticket.unit):
            for device, block in ticket:
                with _on(device):
                    out += self._collect_block(block, refine_mode, keep_undetected_mask)
        return out

    def _collect_block(self, ticket, refine_mode: int, keep_undetected_mask: bool):
        outputs, metas, pages, extras = ticket
        size = self.size
        rows, counts, masks_out, dboxes, dscores, dvalid = outputs
        with span("download"):
            if isinstance(masks_out, list):
                masks_out = [to_host(m) for m in masks_out]
            else:
                masks_out = to_host(masks_out)
            rows, counts, dboxes, dscores, dvalid = (to_host(t) for t in (rows, counts, dboxes, dscores, dvalid))
        staged = []
        with span("group"):
            for i in range(len(pages)):
                im_h, im_w, dw, dh = metas[i]
                resize_ratio = (im_w / (size - dw), im_h / (size - dh))
                blks = postprocess_yolo(rows[i], int(counts[i]), resize_ratio)
                lines = scale_lines(dboxes[i], dscores[i], dvalid[i], size, self.box_thresh, resize_ratio)
                if self.mask_transfer == "packed":
                    mask = unpack_rows(masks_out[i], im_w)
                else:
                    mask = resize_bilinear_fast(masks_out[i][: size - dh, : size - dw], (im_h, im_w))
                staged.append((mask, group_output(blks, lines, im_w, im_h, mask)))

        if self.refine_backend == "device":
            with span("refine"):
                tickets = self._submit_refines(extras, pages, [bl for _, bl in staged], refine_mode)

        out = []
        for i, page in enumerate(pages):
            mask, blk_list = staged[i]
            if self.refine_backend == "device":
                mask_refined = self._finish_refine(tickets[i])
                if keep_undetected_mask:
                    mask_refined = self._rescue_undetected(
                        tickets[i], mask_refined, mask, blk_list, page.shape, refine_mode
                    )
            else:
                with span("refine"):
                    mask_refined = refine_mask(page, mask, blk_list, refine_mode=refine_mode)
                    if keep_undetected_mask:
                        mask_refined = refine_undetected_mask(page, mask, mask_refined, blk_list, refine_mode)
            out.append((mask, mask_refined, blk_list))
        return out

    def _submit_refines(self, extras, pages, blk_lists, refine_mode):
        """Refine the whole batch's block windows at page resolution, one
        ``refine_pages`` call for each group of same-shaped pages, whose
        windows share dispatches.  Returns one ticket per page."""
        origs, mask_devs = extras
        groups: dict = {}
        for i, page in enumerate(pages):
            groups.setdefault(page.shape[:2], []).append(i)
        tickets = [None] * len(pages)
        for shape, idxs in groups.items():
            imgs = torch.stack([origs[i] for i in idxs])
            masks = torch.stack([mask_devs[i] for i in idxs])
            windows, pids = [], []
            for gi, i in enumerate(idxs):
                for blk in blk_lists[i]:
                    windows.append(expand_textwindow(pages[i].shape, blk.xyxy, expand_r=16))
                    pids.append(gi)
            canvases = refine_pages(
                imgs, masks, np.asarray(windows, np.int32).reshape(-1, 4), np.asarray(pids, np.int32),
                refine_mode,
            )
            packed = packbits_rows(canvases > 0)
            fetch_cache: dict = {}  # one download for the whole shape group
            for gi, i in enumerate(idxs):
                tickets[i] = (packed, canvases, imgs, masks, gi, shape, fetch_cache)
        return tickets

    def _finish_refine(self, ticket) -> np.ndarray:
        packed, canvases, _imgs, _masks, gi, shape, fetch_cache = ticket
        with span("fetch"):
            if "host" not in fetch_cache:
                fetch_cache["host"] = to_host(packed)
                check_bounds(canvases)  # the download waited for the refine
            return unpack_rows(fetch_cache["host"][gi], shape[1])

    def _rescue_undetected(self, ticket, refined, raw_mask, blk_list, img_shape, refine_mode):
        """keep_undetected_mask for the batch path: the single page's rescue
        at page resolution, merged into the refined mask on the host."""
        _packed, canvases, imgs, masks, gi, shape, _fetch_cache = ticket
        extra = _rescue_undetected_device(
            imgs[gi], masks[gi], canvases[gi], refined, raw_mask, blk_list, img_shape, refine_mode
        )
        if extra is None:
            return refined
        extra_host = unpack_rows(to_host(packbits_rows(extra > 0)), shape[1])
        check_bounds(extra)
        return np.where(extra_host > 0, np.uint8(255), refined)

    def process_batch(
        self,
        pages: Sequence[np.ndarray],
        refine_mode: int = C.REFINEMASK_INPAINT,
        keep_undetected_mask: bool = False,
    ) -> List[Tuple[np.ndarray, np.ndarray, list]]:
        """Run <= batch_size BGR pages; returns [(mask, mask_refined, blk_list)]."""
        return self.collect(self.submit(pages), refine_mode, keep_undetected_mask)

    def stream(
        self,
        images: Iterable[np.ndarray],
        refine_mode: int = C.REFINEMASK_INPAINT,
        keep_undetected_mask: bool = False,
        prefetch: int = 2,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, list]]:
        """Yield (mask, mask_refined, blk_list) for every page of ``images``,
        in order.  A producer thread reads the source into batches, up to
        ``prefetch`` ahead; up to ``prefetch`` batches are submitted before
        the oldest is collected.  An error raised by the source reaches the
        consumer after the pages read before it."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = object()
        error: List[BaseException] = []

        def producer():
            chunk: List[np.ndarray] = []
            try:
                for img in images:
                    chunk.append(img)
                    if len(chunk) == self.batch_size:
                        q.put(chunk)
                        chunk = []
                if chunk:
                    q.put(chunk)
            except BaseException as e:  # surface source errors in the consumer
                error.append(e)
            finally:
                q.put(stop)

        threading.Thread(target=producer, daemon=True).start()
        in_flight: deque = deque()
        depth = max(1, prefetch)
        while True:
            with span("wait"):
                chunk = q.get()
            if chunk is stop:
                break
            in_flight.append(self.submit(chunk))
            if len(in_flight) > depth:
                yield from self.collect(in_flight.popleft(), refine_mode, keep_undetected_mask)
        while in_flight:
            yield from self.collect(in_flight.popleft(), refine_mode, keep_undetected_mask)
        if error:
            raise error[0]
