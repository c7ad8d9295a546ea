"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each announced on a flushed line
before it starts so a stall shows where it stopped:

1. the card's name and power limit, the torch and CUDA versions;
2. build the CUDA kernels from ``comic_text_detector_tpu_torch/csrc`` (one
   nvcc per source, all started together), with the build time, and the
   host library (``native.py``, ``csrc/ctdnative.cpp``, with ``c++``), so
   that the representer's timings leave its build out;
3. hold each kernel (K1, K2, K3, both functions of K6) and the ids route
   bit for bit against its plain PyTorch version, small inputs first; K1
   at every refine bucket shape with 4 x slots windows; K1, K3 and the ids
   route on masks aimed at the tile borders of K1's and K3's local phase
   (``border_masks``: combs, a serpentine on its side, chains linked only
   through NW or NE, zigzags, noise) at every bucket shape, 257x255,
   1x4097, 4097x1, 64x4096, 4x1024x1024, 1037x1024, 700x1531 and 700x1400,
   K3 with seeds over the whole int32 range; K1 on each bucket's 45% noise
   stack and K3 on 4x1024x1024 noise 20 times, every repeat bit-identical;
   K2 on ``border_masks`` and on chains that cross its tile seam at x = 1024
   through NE or NW only (``seam_chains``) at widths 1023, 1024, 1025, 1536,
   2047, 2048 and 2049 and heights 1, 13 and 37, on 4-page stacks whose
   pages differ at the seams, and 20 times on (4, 1536, 1536) noise;
   K6 at the seams of its decomposition (``check_k6_seams``): edge values
   (every k/255 and its float32 neighbours, the threshold's neighbours) on
   planes of 1, 15, 16, 17, 4095 and 4097 elements, B = 1 and 5, read in
   place as x[:, 0] and x[:, 1] of (B, 2, H, W) stacks (page strides that
   break 16-byte alignment), from unaligned bases and contiguous;
4. the single-page paths, each on the same seeded synthetic pages with
   every kernel's launch count set to 0 just before and read just after:
   ``TextDetector("data/flagship_r2.npz", input_size=1024)`` (host refine)
   and the same with ``refine_backend="device", mask_transfer="packed"``;
   then K2 and K3 against their plain versions on the path's own
   1024x1024 DB bitmap, K1 on page 0's own candidate stack and at every
   refine bucket shape (4 x slots glyph windows), their times, the device
   refine alone, and ms/page of both configurations;
5. the output check: the same page through the card and through the
   port's CPU route (plain versions) at input size 512 must agree, for
   both refine backends, and the card's ``refine_page`` must be bit-equal
   to the CPU's on the same page and grey mask;
6. the main path, the batch stream: ``BatchTextDetector`` with the
   flagship weights, batch 4, input 1024, bf16, device refine, packed
   masks, warmed on 4 pages, then 12 distinct seeded pages in three shapes
   with every launch count set to 0 just before and read just after;
   pages/s, ms/page and launches per page; K6 against its plain version
   on the batch's own mask stack and on its DB maps as the stream reads
   them (the view ``lines[:, 0]``, in place), each function's time a
   launch on the card's clock (CUPTI) and on events, from device memory,
   in the L2, on the view, and on a contiguous copy of the view then K6
   (the stream's form before the view was read in place); K2 and K3
   timed on the batch's (4, 1024, 1024) DB bitmaps, K3 with the ids as
   seeds and with the split route's own seeds (root ranks, 2**30 elsewhere),
   K2 also from device memory (copies cycled) with its time by kernel;
7. determinism: the same 12 pages streamed again, and one single-page call
   repeated, must give bit-identical outputs;
8. bf16 against float32 (the f32 batch stream on the same pages, mask IoU
   >= 0.98 at > 30); the batch stream against the single-page
   ``TextDetector`` in the same configuration: a batch of 1 bit-identical,
   a batch of 4 with the same block counts and refined IoU >= 0.99 in
   float32 and >= 0.98 in bf16 (bf16 convolutions round differently at
   another batch size); and a source that raises mid-stream reaching the
   consumer;
9. K4 (the connected-components row and column sweeps) bit for bit against
   its plain version: the new path's first 1536x1536 DB bitmap, a 1536x1536
   serpentine, 45% noise, all-zero, all-one, 1037x1531 and a
   (4, 1536, 1536) stack, with random labels under the background; then
   ``connected_components`` on the K4, K2 and plain routes, with the K4
   fixpoint's rounds; ``connected_components(connectivity=4)`` through
   ``"auto"`` against the plain route, through K4 at 2x64x4096 and past
   K4's rows at 2x64x5000; then the column kernel alone on masks aimed at its
   row chunks (``col_chunk_masks``: runs that fill chunks, cross, start,
   end or break at their borders, one-pixel runs there, full-height
   columns) at heights 1536, 1535, 1537, 2047, 2048, 2049, 3001, 31, 33
   and 64, on one-row and one-column maps, on 4-page stacks whose seams
   are set on both sides, with labels over the whole int32 range, and 20
   times on (4, 1536, 1536) 45% noise, every repeat bit-identical;
10. K5 (3x3 erode, dilate and cross erode) bit for bit against its plain
   version, uint8 and float32, at 1536x1536, 1x4097, 4097x1 and 1037x1531;
11. the path at input 1536: ``BatchTextDetector(..., input_size=1536,
   half=True, refine_backend="device", mask_transfer="packed").stream`` over
   8 high-resolution scans (2150x1500, 2048x1448, 1500x2150), whose DB
   decode labels through K2 (``connected_components`` on the card), with
   every launch count set to 0 just before and read just after, and K4's
   held at 0; pages/s, launches per page and the device's idle
   share; ``TextDetector(..., input_size=1536)`` with the host refine and
   with the device refine + packed; repeat runs bit-identical; the batch's
   DB decode bit-equal through K4, K2 and the plain route;
12. ``SegDetectorRepresenter`` in quad and polygon mode on that net's DB
   maps, the card against the port's CPU route; then K4, K5 and K6 (on the
   1536 batch's mask stack and its view ``lines[:, 0]``) timed at the
   path's shapes on the card's clock and on events, beside their bounds,
   their plain versions and, where one exists, a single PyTorch call
   computing the same function; K4's column
   kernel also at (4, 2048, 2048), the batch's bitmaps scaled up; K2 from
   device memory on the batch's bitmaps and at (4, 2048, 2048), with its
   time by kernel, and ``connected_components`` through ``"auto"`` on both;
13. the seg trainer on the card at imgsz 512, batch 8 (the repo's training
   configuration), full width, the flagship weights carried into the train
   tree (``weights.train_from_deploy``), on 16 train and 8 val seeded
   synthetic pages written as PNG with their text masks and line quads
   (``synthetic_page(..., truth=True)``): one step on the card against the
   same step on the CPU (loss within 1e-4 relative, gradients within 1e-3
   in relative L2 over the trainable tree), 20 steps on one batch (a
   finite loss that falls; ms a step, steps/s, peak memory),
   ``seg_trainer.train`` for 2 epochs (its ``unet_last.ctd`` written), two
   runs of 3 steps from that checkpoint with bit-identical losses, and a
   pixel P/R/F1 eval;
14. the DB trainer the same way, grafted from the seg state, ``loss:
   bce``; its eval (``db_trainer.eval_model``) with every launch count set
   to 0 just before and read just after, and in a profiler trace, must
   launch K6 binarize and K2, each bit-equal to its plain version on the
   eval's own maps, and its quads must equal the CPU representer's on the
   same maps; the trained heads go back into a deploy
   tree, through ``save_compact`` and ``load_npz``, and the port's
   ``TextDetector`` serves a page from it;
15. the YOLO block trainer on the card the same way, at imgsz 512, batch 8
   (``scripts/train_flagship.py``'s stage 1: adam, lr0 2e-3, lrf 0.05,
   momentum 0.9, hsv 0.5, flip 0.5, neg 0.1), full width and depth,
   flagship_r2's ``blk_det`` carried into ``BlkDetTrain``, on the same
   pages with one YOLO block a bubble (``p*.txt``): the dense targets of
   colliding labels (``colliding_labels``) equal on the card and the CPU
   and bit-identical over 20 repeats; one step against the CPU's (the
   loss and its three terms within 1e-4 relative, gradients within 1e-3
   in relative L2, as phases 13-14); 20 falling steps (ms a step, kernel
   launches a step); ``yolo_trainer.train`` for 4 steps with 2 evals
   (loss and AP50) and both checkpoints; two runs of 3 steps from
   ``yolo_last.ctd`` with bit-identical losses; the NMS rows
   (counts equal, boxes within 0.01 px, confidences within 1e-4, classes
   equal), per-class AP50 (within 1e-3) and eval loss terms (within 1e-3
   relative) of the card against the CPU's on the same state and val
   batch; ``augmented_detect`` on the card against the CPU (within 1e-3
   of 1 + |value|); no launch of K1-K6 across all of it; then the
   YOLO-trained ``blk_det`` in the deploy tree, served by ``TextDetector``,
   and its layers 0-9 as the seg trainer's backbone for one step;
16. the model files (``model_files_phase``), each written into a temporary
   directory and served by ``TextDetector`` at 1024, float32, device refine,
   packed masks, on phase 4's pages with every launch count set to 0 just
   before and read just after (K1, K2, K3 and both K6 functions must
   launch), against ``TextDetector("data/flagship_r2.npz")``: the
   reference ``.pt`` (``export_torch_checkpoint``), the reference's three
   training files through ``load_from_parts`` and the native msgpack file
   (``save_variables`` / ``from_native``), each bit-identical; the
   ``.onnx`` (``export_onnx`` at 128, Conv+BN folded) with its net's
   outputs at 1024 within 1e-4 on the maps and 1e-3 + 5e-3 on the boxes
   and refined IoU >= 0.99, with the ingestion's host seconds; the ``.pt2``
   (``export_program`` on the card at 1024) with its net within 1e-4 of
   the module's, and ms/page of both detectors;
17. the YOLO graph's block variants (``variant_phase``): ``V5S_TR``
   (yolov5 v5.0 ``models/hub/yolov5s-transformer.yaml``: Focus, SPP, C3TR
   over 32x32 tokens at 1024) and ``V5S_GHOST`` (v6.0
   ``models/hub/yolov5s-ghost.yaml``: GhostConv, C3Ghost,
   GhostBottleneck), at full width (``nc: 2``, depth 0.33, width 0.50),
   random weights from seeded generators, BatchNorm statistics of two
   seeded pages and the Detect biases spread so that a few blocks remain
   (``variant_variables``), through ``TextDetector`` at
   1024, device refine, packed masks, float32 and bf16, on phase 4's pages
   with every launch count set to 0 just before and read just after (K1
   and K2 must launch), each call repeated bit-identical; in float32 the
   card against the CPU route on phase 5's page (the same blocks within 1
   px and refined IoU >= 0.99); in bf16 every step of the first Focus,
   SPP, C3TR, GhostConv and C3Ghost held alone on the CPU's bf16 input of
   phase 5's page at 1024, its card-vs-CPU gap at most a quarter of the
   CPU's own bf16-vs-float32 gap, each block around them at most twice
   (``hold_bf16_pieces``: the whole path's bf16 is chaotic on random
   weights);
   ``V5S_TR``'s ``.pt``, native file and the ``.pt2`` that the CLI's
   ``export`` writes, each serving the pages bit-identical to the
   variables-built detector; the CLI's ``detect`` on a PNG page and
   ``annotate`` on a directory of 4 PNG pages (flagship weights) against
   direct calls; ms a page of both variant detectors and the flagship's
   on one page in two turns, the net alone, and the load seconds of the
   ``.pt`` and the ``.pt2``;
18. data parallelism (``mesh_phase``): ``BatchTextDetector(mesh=
   make_mesh(devices=[cuda:0, cuda:0]))`` (two cards where there are two)
   with the flagship weights, batch 4, input 1024, device refine, packed
   masks on phase 6's 12 pages, float32 bit-identical to phase 8's stream
   without a mesh and bf16 with phase 6's block counts and refined IoU
   >= 0.98, its launches a page and pages/s; two ranks on cuda:0 over gloo
   (``parallel/mesh.py::spawn``) for the seg, DB (``loss: bce``) and YOLO
   steps at imgsz 512, global batch 8, full width from the flagship
   weights: one step against the one-process step on the card (loss terms
   within 1e-5 relative, trainable gradients within 1e-4 in relative L2,
   BatchNorm running statistics within 1e-5), the ranks' parameters
   bit-identical after 3 steps; then ``seg_trainer.train``,
   ``db_trainer.train`` and ``yolo_trainer.train`` with ``mesh=`` for 2
   steps each, rank 0 alone writing the checkpoints and its DB eval
   launching K2 and K6 binarize (rank 1 none); and the YOLO step through
   the mesh route on NCCL at world 1, held to the one-process step with
   the same tolerances and bit-identical over two runs.  A rank that
   raises, or a join past its time limit, fails the script;
19. the host library behind ``boxes_from_stats`` (``host_library_phase``):
   built again from its source into a temporary directory with the
   machine's ``c++`` (the seconds printed) and equal to the one in use;
   ``label_components`` (8- and 4-connected) and
   ``component_min_area_rects`` bit-equal to their plain versions
   (``native.label_components_plain``, ``component_min_area_rects_plain``)
   at 1536x1536 45% noise and on phase 12's four 1536 DB maps, each timed;
   ``SegDetectorRepresenter``'s quad mode on those maps and on two synthetic
   1536 text-line maps (``text_line_maps``, about 230 quads a page: phase
   12's maps give 1-2) through the library and through the NumPy route:
   the same counts, equal scores, corners
   within 1 px but where the two routes' min-area rects tie in area (each
   route keeps the first tied orientation it meets), ms a page of each
   route's host half and of the whole call, two runs of each route
   bit-identical; then a child interpreter with Pillow blocked runs one DB
   dataset epoch at imgsz 512 with ``rotate: 1.0`` and 2 steps of
   ``db_trainer.train`` with the default DB hyp (its eval included), the
   losses finite.

Prints ``{"train": {...}}`` (phases 13-15), ``{"model_files": {...}}``
(phase 16), ``{"variants": {...}}`` (phase 17), ``{"mesh": {...}}`` (phase
18), ``{"host_library": {...}}`` (phase 19) and ``{"kernels": [...]}`` on
lines of their own (every kernel with its
event ``ms`` and its ``device_ms`` a launch on the card's clock, K1-K3 and
K6 also with their launches on phase 18's mesh stream, K2 and K6 binarize
with the mesh DB eval's), the whole script's seconds, and as its last line
``{"ok": true, "device": {...}}``.  Any failure raises, and the exit code is
not 0; without a CUDA device, or outside a checkout, it exits 1 before
printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(ROOT, "data", "flagship_r2.npz")
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet


def phase(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def synthetic_page(rng, h: int, w: int, colour: bool, truth: bool = False):
    """Light page with speech bubbles of glyph-like dark strokes.  With
    ``truth``, also the text mask (uint8 0/255, the strokes left on the
    page), each text line's quad (x0, y0, x1, y0, x1, y1, x0, y1 around
    its remaining strokes) and each bubble's block (cls, x0, y0, x1, y1:
    the union of its lines' quads, class 1 (ja) for vertical text and 0
    (eng) for horizontal, bubbles with no stroke left skipped): (page,
    mask, quads, blocks).  The draws from ``rng`` are the same either
    way."""
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w]
    base = 205 + 30 * (yy / h)
    page = np.repeat(base[..., None], 3, axis=2)
    if colour:
        page = page * np.array([0.85, 0.95, 1.0]) + np.array([10.0, 0.0, -15.0])
    lines = []  # the stroke rectangles (y0, y1, x0, x1) of each text line
    owner = []  # (bubble, vertical) of each line
    for bubble in range(int(rng.integers(4, 8))):
        cy, cx = rng.integers(h // 8, h - h // 8), rng.integers(w // 8, w - w // 8)
        ry, rx = rng.integers(h // 14, h // 6), rng.integers(w // 14, w // 6)
        inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        page[inside] = 250
        cell = int(rng.integers(14, 26))
        vertical = rng.random() < 0.5
        for r in range(-ry // 2, ry // 2 - cell, cell + cell // 3):
            rects = []
            for c in range(-rx // 2, rx // 2 - cell, cell + 2):
                y0, x0 = (cy + c, cx + r) if vertical else (cy + r, cx + c)
                if not (0 <= y0 < h - cell and 0 <= x0 < w - cell):
                    continue
                for _ in range(int(rng.integers(2, 5))):
                    t = int(rng.integers(2, 4))
                    if rng.random() < 0.5:  # horizontal stroke
                        y = y0 + int(rng.integers(0, cell - t))
                        a, b = sorted(rng.integers(0, cell, 2))
                        page[y:y + t, x0 + a:x0 + b + 1] = 25
                        rects.append((y, y + t, x0 + a, x0 + b + 1))
                    else:  # vertical stroke
                        x = x0 + int(rng.integers(0, cell - t))
                        a, b = sorted(rng.integers(0, cell, 2))
                        page[y0 + a:y0 + b + 1, x:x + t] = 25
                        rects.append((y0 + a, y0 + b + 1, x, x + t))
            lines.append(rects)
            owner.append((bubble, vertical))
    page = np.clip(page, 0, 255).astype(np.uint8)
    if not colour:
        page[..., 1] = page[..., 0]
        page[..., 2] = page[..., 0]
    if not truth:
        return page
    text = (page == 25).all(axis=2)
    quads = []
    blocks = {}  # bubble -> [cls, x0, y0, x1, y1]
    for rects, (bubble, vertical) in zip(lines, owner):
        if not rects:
            continue
        own = np.zeros_like(text)
        for y0, y1, x0, x1 in rects:
            own[y0:y1, x0:x1] = True
        ys, xs = np.nonzero(own & text)  # later bubbles paint over earlier strokes
        if len(ys):
            x0, y0, x1, y1 = int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1
            quads.append([x0, y0, x1, y0, x1, y1, x0, y1])
            b = blocks.setdefault(bubble, [int(vertical), x0, y0, x1, y1])
            b[1:] = [min(b[1], x0), min(b[2], y0), max(b[3], x1), max(b[4], y1)]
    return (page, text.astype(np.uint8) * 255, np.array(quads, np.int64).reshape(-1, 8),
            np.array(list(blocks.values()), np.int64).reshape(-1, 5))


def serpentine(s: int):
    import numpy as np

    m = np.zeros((s, s), np.uint8)
    m[::2, :] = 1
    for r in range(0, s - 2, 2):
        m[r + 1, 0 if (r // 2) % 2 == 0 else s - 1] = 1
    return m


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_cycle(fn, args, iters: int) -> float:
    """Like :func:`cuda_ms`, cycling through ``args`` (one tuple per call) so
    that inputs larger together than the 50 MB L2 come from device memory."""
    import torch

    fn(*args[0])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args[i % len(args)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phase_ms(fn, reps: int = 20, args=((),), only=None) -> dict:
    """Device ms a call of ``fn`` spends in each CUDA kernel it launches, by
    kernel name (CUPTI times through torch.profiler, over ``reps`` calls),
    cycling through ``args`` (one tuple per call) as :func:`cuda_ms_cycle`
    does; the time of a launch is the mean over the launches the trace
    holds.  With ``only``, the kernels whose names hold it, however few of
    their launches the trace kept (CUPTI drops records, and then another
    kernel's may be all a trace holds).  Empty if three traces in a row
    hold none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*args[0])
    torch.cuda.synchronize()
    for _ in range(3):  # a trace that holds none of the launches is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                fn(*args[i % len(args)])
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        # a kernel of the call appears about ``reps`` times (a multiple for
        # one launched more than once a call); records of other work that
        # reach the trace appear a few times, and are left out
        ours = [e for e in events if (only in e.key if only else e.count >= reps // 2)]
        if len(ours) < len(events):
            phase("  profiler: left out " + ", ".join(f"{e.key[:50]} x{e.count}" for e in events if e not in ours))
        if ours:
            return {e.key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]:
                    e.self_device_time_total / e.count * max(1, round(e.count / reps)) / 1e3 for e in ours}
        phase("  profiler: the trace held no launch of the call; taken again")
        time.sleep(0.1)
    return {}


def time_k2(bitmaps, copies: int, plain_ms: float, smi: str) -> dict:
    """K2 on an (N, H, W) uint8 stack by raw launches, cycling ``copies``
    copies of the stack and its output so that they come from device
    memory; its time by kernel, its bound (5 bytes a pixel) and the plain
    version's time ``plain_ms``.  Prints one line."""
    import torch

    from comic_text_detector_tpu_torch.ops import cc_kernels as K

    err = torch.zeros(1, dtype=torch.int32, device=bitmaps.device)
    args = [(bitmaps.clone(), torch.empty(bitmaps.shape, dtype=torch.int32, device=bitmaps.device), err)
            for _ in range(copies)]
    ms = cuda_ms_cycle(K.launch_cc_window, args, 100)
    by_kernel = kernel_phase_ms(lambda: K.launch_cc_window(*args[0]))
    if int(err.item()):
        raise AssertionError("a union-find loop bound was hit while timing K2")
    bound = bitmaps.numel() * 5 / H100_BYTES_PER_S * 1e3
    phase(f"  K2 on {tuple(bitmaps.shape)} from device memory ({copies} copies cycled): {ms:.4f} ms, bound "
          f"{bound:.5f} ms (5 B a pixel at 3.35 TB/s), plain {plain_ms:.2f} ms; by kernel (ms a launch): "
          + ", ".join(f"{k} {v:.4f}" for k, v in by_kernel.items()) + f"; {smi}")
    return {"ms": ms, "bound_ms": bound, "plain_ms": plain_ms, "phase_ms": by_kernel}


def device_ms(fn, args=((),), reps: int = 40, only=None):
    """Device ms a call of ``fn``: the CUPTI times of every kernel it
    launches (whose name holds ``only``, if given), summed
    (:func:`kernel_phase_ms`); None where the profiler recorded none."""
    return sum(kernel_phase_ms(fn, reps, args, only).values()) or None


def fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def time_k6(mask_stack, lines, thresh: float, smi: str) -> dict:
    """Both K6 functions at one batch's shapes: bit for bit against their
    plain versions on the (B, S, S) mask stack, on the stream's own view
    ``lines[:, 0]`` of the (B, 2, S, S) DB maps (read in place) and on a
    contiguous copy of it; then each function's time a launch on the card's
    clock (CUPTI) and on CUDA events over the Python launch loop, cycling
    contiguous copies that pass 150 MB (the 50 MB L2 three times); its
    device time with the input in the L2, on the stream's view (in the L2
    and cycling as many copies of the DB maps), and on the stream's form
    before the view was read in place (a contiguous copy of the view, then
    K6); the plain version's time and one
    library call's, on events and on the card's clock (from device memory
    and in the L2); the bound (5 bytes a pixel).  Prints one line a
    function."""
    import torch

    from comic_text_detector_tpu_torch.ops import finalize as K6

    view = lines[:, 0]
    shrink = view.contiguous()
    kernel = {"mask_to_u8": K6.mask_to_u8, "binarize": lambda x: K6.binarize(x, thresh)}
    plain = {"mask_to_u8": K6.mask_to_u8_plain, "binarize": lambda x: K6.binarize_plain(x, thresh)}
    library = {"mask_to_u8": lambda x: x.mul(255).to(torch.uint8),
               "binarize": lambda x: torch.gt(x, thresh).view(torch.uint8)}
    launch = {"mask_to_u8": K6.launch_mask_to_u8,
              "binarize": lambda x, o, *layout: K6.launch_binarize(x, thresh, o, *layout)}
    for name in kernel:
        for label, x in (("the mask stack", mask_stack), ("the stream's view lines[:, 0]", view),
                         ("a contiguous copy of the view", shrink)):
            got, ref = kernel[name](x), plain[name](x)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"K6 {name} differs from its plain version on {label} {tuple(x.shape)}: "
                                     f"{int((got != ref).sum())} values")
    out = torch.empty(shrink.shape, dtype=torch.uint8, device=shrink.device)
    n, plane = shrink.shape[0], shrink[0].numel()
    # copies whose inputs and outputs together pass 150 MB, three times the
    # L2: 8 at (4, 1024, 1024), 4 at (4, 1536, 1536)
    copies = max(2, -(-150_000_000 // (shrink.numel() * 5)))
    cycled = [(shrink.clone(), out, n, plane, plane) for _ in range(copies)]
    views = [(lines.clone()[:, 0], out, n, plane, lines.stride(0)) for _ in range(copies)]
    res = {}
    for name in kernel:
        go = launch[name]
        r = {
            "ms": cuda_ms_cycle(go, cycled, 200),
            "device_ms": device_ms(go, cycled),
            "device_ms_l2": device_ms(go, cycled[:1]),
            "device_ms_view_l2": device_ms(go, views[:1]),
            "device_ms_view": device_ms(go, views),
            "device_ms_copy_then_k6_l2": device_ms(lambda v, o, *_: go(v.contiguous(), o, n, plane, plane), views[:1]),
            "device_ms_copy_then_k6": device_ms(lambda v, o, *_: go(v.contiguous(), o, n, plane, plane), views),
            "plain_ms": cuda_ms_cycle(lambda x, *_: plain[name](x), cycled, 50),
            "library_ms": cuda_ms_cycle(lambda x, *_: library[name](x), cycled, 50),
            "library_device_ms": device_ms(lambda x, *_: library[name](x), cycled),
            "library_device_ms_l2": device_ms(lambda x, *_: library[name](x), cycled[:1]),
            "bound_ms": shrink.numel() * 5 / H100_BYTES_PER_S * 1e3,
        }
        res[name] = r
        phase(f"  K6 {name} on {tuple(shrink.shape)}: {fmt(r['device_ms'])} ms a launch on the card's clock from "
              f"device memory ({copies} copies cycled; {r['ms']:.4f} on events over the Python loop), "
              f"{fmt(r['device_ms_l2'])} in the L2; on the stream's view lines[:, 0] {fmt(r['device_ms_view_l2'])} in "
              f"the L2 / {fmt(r['device_ms_view'])} from device memory, a copy then K6 "
              f"{fmt(r['device_ms_copy_then_k6_l2'])} / {fmt(r['device_ms_copy_then_k6'])}; plain {r['plain_ms']:.4f}, "
              f"library {r['library_ms']:.4f} ({fmt(r['library_device_ms'])} on the card's clock, "
              f"{fmt(r['library_device_ms_l2'])} in the L2); bound {r['bound_ms']:.5f} ms (5 B a pixel at 3.35 TB/s); "
              f"{smi}")
    del cycled, views
    return res


def page_time_of(detector, pages) -> float:
    """ms per page of a single-page detector over ``pages``, after one
    warm-up pass, two passes timed."""
    import torch

    for p in pages:
        detector(p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 2
    for _ in range(reps):
        for p in pages:
            detector(p)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (reps * len(pages))


def mask_iou(a, b) -> float:
    import numpy as np

    a, b = a > 30, b > 30
    return float(np.logical_and(a, b).sum() / max(np.logical_or(a, b).sum(), 1))


def same_outputs(x, y) -> bool:
    """Two (mask, mask_refined, blk_list) results bit for bit: both masks,
    and each block's xyxy, line quads and language."""
    import numpy as np

    (m1, r1, b1), (m2, r2, b2) = x, y
    if not (np.array_equal(m1, m2) and np.array_equal(r1, r2) and len(b1) == len(b2)):
        return False
    return all(
        list(a.xyxy) == list(b.xyxy) and a.language == b.language
        and np.array_equal(np.asarray(a.lines), np.asarray(b.lines))
        for a, b in zip(b1, b2)
    )


def check_k6_seams(dev) -> dict:
    """Both K6 functions bit for bit against their plain versions at the
    seams of the kernel's decomposition (16 elements a thread from each
    plane's first 16-byte aligned output byte; head and tail by the plane's
    first block): every value is an edge value (0, 1, every k/255 and its
    float32 neighbours, the threshold 0.3 and its neighbours), on planes of
    1, 15, 16, 17, 4095 and 4097 elements in 1- and 5-page stacks, read in
    place as ``x[:, 0]`` and ``x[:, 1]`` of (B, 2, H, W) stacks (page
    strides and bases that break 16-byte alignment where H * W is odd or
    not a multiple of 4), from a base 1, 2 and 3 elements past an aligned
    one, and contiguous; then seeded maps at (1, 37, 1001) and (4, 1024,
    1024), whole and from an unaligned base.  Returns the max abs errors and
    the number of cases."""
    import numpy as np
    import torch

    from comic_text_detector_tpu_torch.ops import finalize as K6

    k = np.arange(256, dtype=np.float32) / np.float32(255)
    t = np.float32(0.3)
    edge = np.concatenate([k, np.nextafter(k, np.float32(2)), np.nextafter(k, np.float32(-1)), np.float32([0.0, 1.0]),
                           np.float32([t, np.nextafter(t, np.float32(1)), np.nextafter(t, np.float32(0))])])
    edge = edge.clip(0, 1).astype(np.float32)
    errs = {"mask_to_u8": 0, "binarize": 0, "cases": 0}

    def hold(name, x):
        for key, got, ref in (("mask_to_u8", K6.mask_to_u8(x), K6.mask_to_u8_plain(x)),
                              ("binarize", K6.binarize(x, 0.3), K6.binarize_plain(x, 0.3))):
            torch.cuda.synchronize()
            if got.shape != x.shape or not got.is_contiguous() or not torch.equal(got, ref):
                raise AssertionError(f"K6 {key} differs from its plain version on {name} {tuple(x.shape)} "
                                     f"strides {x.stride()}: {int((got != ref).sum())} values")
        errs["cases"] += 1

    rng = np.random.default_rng(3)
    for h, w in ((1, 1), (3, 5), (4, 4), (1, 17), (63, 65), (17, 241)):
        for b in (1, 5):
            n = b * 2 * h * w
            flat = torch.from_numpy(rng.permutation(np.resize(edge, n + 3)).astype(np.float32)).to(dev)
            stack = flat[:n].view(b, 2, h, w)
            hold(f"x[:, 0] of a ({b}, 2, {h}, {w}) stack", stack[:, 0])
            hold(f"x[:, 1] of a ({b}, 2, {h}, {w}) stack", stack[:, 1])
            hold(f"a contiguous ({b}, {h}, {w}) stack", flat[: b * h * w].view(b, h, w))
            for off in (1, 2, 3):
                hold(f"x[:, 0] from a base {off} elements on", flat[off:off + n].view(b, 2, h, w)[:, 0])
    for shape in ((1, 37, 1001), (4, 1024, 1024)):
        x = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)
        hold("seeded map", x)
        hold("seeded map from an unaligned base", x.reshape(-1)[1:])
    return errs


def border_masks(h: int, w: int):
    """Masks aimed at the tile borders of K1's and K3's local phase (tiles
    are runs of whole rows up to W = 1024, 1024 columns wide beyond): a
    vertical comb with its spine at the bottom and one with it at the top,
    a serpentine turned on its side, chains linked only through NW or only
    through NE, zigzags linked only diagonally, and 45% noise."""
    import numpy as np

    y, x = np.mgrid[0:h, 0:w]
    comb = (x % 2 == 0).astype(np.uint8)
    comb_top = comb.copy()
    comb[-1] = 1
    comb_top[0] = 1
    serp = np.zeros((h, w), np.uint8)
    side = min(h, w)
    serp[:side, :side] = serpentine(side).T
    return {
        "comb": comb, "comb spine on top": comb_top, "serpentine on its side": serp,
        "NW chains": ((x - y) % 3 == 0).astype(np.uint8), "NE chains": ((x + y) % 3 == 0).astype(np.uint8),
        "zigzags": (x % 4 == y % 2).astype(np.uint8),
        "noise 45%": (np.random.default_rng(h * 7919 + w).random((h, w)) < 0.45).astype(np.uint8),
    }


def edge_seeds(rng, m_np):
    """int32 seeds over the whole int32 range, with -1, 0, 2**30 and
    2**31 - 2 mixed in; background gets random values (K3 must not read
    them)."""
    import numpy as np

    vals = rng.integers(-(2**31), 2**31 - 1, m_np.shape, dtype=np.int64)
    special = np.array([-1, 0, 2**30, 2**31 - 2], np.int64)
    pick = rng.random(m_np.shape)
    vals = np.where(pick < 0.2, special[rng.integers(0, 4, m_np.shape)], vals)
    return vals.astype(np.int32)


def check_tile_borders(dev, bucket_shapes) -> dict:
    """K1, K3 and the split ids route (K2 -> cumsum -> K3) bit for bit
    against their plain versions on ``border_masks``: K1 on stacks of them
    at every refine bucket shape and at 257x255, 1x4097, 4097x1 and
    64x4096; K3 on 4x1024x1024 stacks, 1037x1024, 1x4097 and 700x1531 (tiles
    side by side, with chains crossing the vertical tile edge through NE
    and NW) with seeds over the whole int32 range; the ids route where the
    window is above 512x512 and at most 1024x1024.  Then K1 on the 45%
    noise stack of each bucket, and K3 on 4x1024x1024 noise, 20 times each:
    every repeat must give the same bits.  Returns the max abs errors."""
    import numpy as np
    import torch

    from comic_text_detector_tpu_torch.ops import cc_kernels as K

    rng = np.random.default_rng(22)
    errs = {"K1": 0, "K3": 0, "ids": 0}

    def same(kname, name, got, ref):
        torch.cuda.synchronize()
        err = int((got.long() - ref.long()).abs().max()) if got.numel() else 0
        if err != 0:
            raise AssertionError(f"{kname} differs from its plain version on {name}: {int((got != ref).sum())} pixels")
        errs[kname] = max(errs[kname], err)

    def stack(h, w, n):
        kinds = list(border_masks(h, w).values())
        return torch.from_numpy(np.stack([kinds[i % len(kinds)] for i in range(n)])).to(dev)

    k1_shapes = [(n, h, w) for h, w, n in bucket_shapes] + [(8, 257, 255), (2, 1, 4097), (2, 4097, 1),
                                                             (2, 64, 4096)]
    for n, h, w in k1_shapes:
        for name, win in border_masks(h, w).items():
            m = torch.from_numpy(np.repeat(win[None], n, 0)).to(dev)
            same("K1", f"{name} {n}x{h}x{w}", K.cc_ids_fused(m), K.cc_ids_windows_local_plain(m))
        m = stack(h, w, n)
        same("K1", f"mixed {n}x{h}x{w}", K.cc_ids_fused(m), K.cc_ids_windows_local_plain(m))
    phase("  K1 bit-equal on the tile-border masks at " + ", ".join(f"{n}x{h}x{w}" for n, h, w in k1_shapes))

    k3_cases = {"mixed 4x1024x1024": stack(1024, 1024, 4)}
    for h, w in ((1037, 1024), (1, 4097), (700, 1531), (700, 1400)):
        for name, win in border_masks(h, w).items():
            k3_cases[f"{name} 1x{h}x{w}"] = torch.from_numpy(win[None]).to(dev)
    for name, m in k3_cases.items():
        seeds = torch.from_numpy(edge_seeds(rng, m.cpu().numpy())).to(dev)
        same("K3", name, K.min_prop_windows_local(m, seeds), K.min_prop_windows_local_plain(m, seeds))
        if K.FUSED_IDS_MAX_ELEMS < m.shape[1] * m.shape[2] <= K.IDS_MAX_ELEMS:
            same("ids", name, K.cc_ids_windows_local(m), K.cc_ids_windows_local_plain(m))
    phase(f"  K3 bit-equal on the tile-border masks with edge seeds ({len(k3_cases)} cases, 1037x1024, "
          "1x4097, 700x1531 among them); the split ids route on those above 512x512")

    for n, h, w in [(n, h, w) for h, w, n in bucket_shapes]:
        m = torch.from_numpy((rng.random((n, h, w)) < 0.45).astype(np.uint8)).to(dev)
        ref = K.cc_ids_windows_local_plain(m)
        for rep in range(20):
            same("K1", f"noise 45% {n}x{h}x{w}, repeat {rep}", K.cc_ids_fused(m), ref)
    m = torch.from_numpy((rng.random((4, 1024, 1024)) < 0.45).astype(np.uint8)).to(dev)
    seeds = torch.from_numpy(edge_seeds(rng, m.cpu().numpy())).to(dev)
    ref = K.min_prop_windows_local_plain(m, seeds)
    for rep in range(20):
        same("K3", f"noise 45% 4x1024x1024, repeat {rep}", K.min_prop_windows_local(m, seeds), ref)
    phase("  20 repeats bit-identical: K1 on the 45% noise stack of every bucket, K3 on 4x1024x1024 noise")
    return errs


def seam_chains(h: int, w: int, through: str):
    """Components that cross the tile seam at x = 1024 by one diagonal link
    only: every third row y, a run ending at (y, 1023) and a run starting at
    (y - 1, 1024) (linked through NE), or a run starting at (y, 1024) and one
    ending at (y - 1, 1023) (through NW).  The rows take every offset from
    the 8-row tile edges, so some links also cross a tile row's edge."""
    import numpy as np

    m = np.zeros((h, w), np.uint8)
    for y in range(1, h, 3):
        if through == "NE":
            m[y, 1000:1024] = 1
            m[y - 1, 1024:1050] = 1
        else:
            m[y, 1024:1050] = 1
            m[y - 1, 1000:1024] = 1
    return m


def check_k2_seams(dev) -> int:
    """K2 bit for bit against its plain version on masks aimed at its tiles
    and the seams between them: ``border_masks`` and ``seam_chains`` at
    widths 1023, 1024, 1025, 1536, 2047, 2048 and 2049 (tiles of up to 1024
    columns side by side beyond 1024) and heights 1, 13 and 37 (not whole
    tiles of 8 rows); 4-page stacks whose pages differ at the seams; then 20
    repeats on (4, 1536, 1536) 45% noise, each bit-identical.  Returns the
    max abs error (0, or it raises)."""
    import numpy as np
    import torch

    from comic_text_detector_tpu_torch.ops import cc_kernels as K

    def hold(name, m_np):
        m = torch.from_numpy(np.ascontiguousarray(m_np)).to(dev)
        got, ref = K.cc_windows_local(m), K.cc_windows_local_plain(m)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"K2 differs from its plain version on {name} {tuple(m.shape)}: "
                                 f"{int((got != ref).sum())} pixels")

    cases = 0
    for w in (1023, 1024, 1025, 1536, 2047, 2048, 2049):
        for h in (1, 13, 37):
            kinds = dict(border_masks(h, w))
            if w > 1024:
                kinds["NE across x = 1024"] = seam_chains(h, w, "NE")
                kinds["NW across x = 1024"] = seam_chains(h, w, "NW")
            for name, win in kinds.items():
                hold(name, win[None])
                cases += 1
    phase(f"  K2 bit-equal on the tile-border masks and chains across x = 1024 ({cases} cases): widths 1023, "
          "1024, 1025, 1536, 2047, 2048, 2049; heights 1, 13, 37")
    for h, w in ((37, 1536), (203, 2049), (61, 2048)):
        kinds = border_masks(h, w)
        pages = [seam_chains(h, w, "NE"), seam_chains(h, w, "NW"), kinds["noise 45%"], kinds["NE chains"]]
        pages[2][:, 1022:1026] = 1  # the noise page's seam set on both sides
        hold("a 4-page stack whose pages differ at the seams", np.stack(pages))
    phase("  K2 bit-equal on 4-page stacks whose pages differ at the seams: 4x37x1536, 4x203x2049, 4x61x2048")
    m = (np.random.default_rng(24).random((4, 1536, 1536)) < 0.45).astype(np.uint8)
    mt = torch.from_numpy(m).to(dev)
    ref = K.cc_windows_local_plain(mt)
    for i in range(20):
        got = K.cc_windows_local(mt)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"K2 repeat {i} on (4, 1536, 1536) 45% noise differs: {int((got != ref).sum())} pixels")
    phase("  K2: 20 repeats on (4, 1536, 1536) 45% noise, each bit-identical")
    return 0


def check_k4(dev, cases: dict) -> int:
    """Both K4 sweeps against their plain versions on each (N, H, W) or
    (H, W) mask of ``cases``, with random int32 labels everywhere (under
    the background too); then ``connected_components`` on the K4, K2 and
    plain routes.  Returns the max abs error (0, or it raises)."""
    import numpy as np
    import torch

    from comic_text_detector_tpu_torch.ops import cc as CC
    from comic_text_detector_tpu_torch.ops import scan_kernels as K4

    rng = np.random.default_rng(5)
    for name, m in cases.items():
        m = m.to(dev)
        lab = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, tuple(m.shape), dtype=np.int64).astype(np.int32))
        lab = lab.to(dev)
        for kernel, plain in ((K4.cc_row_sweep, K4.cc_row_sweep_plain), (K4.cc_col_sweep, K4.cc_col_sweep_plain)):
            got, ref = kernel(lab, m), plain(lab, m)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"K4 {kernel.__name__} differs from its plain version on {name}: "
                                     f"{int((got != ref).sum())} pixels")
        t0 = time.perf_counter()
        k4 = CC.connected_components(m, 8, "pallas")
        torch.cuda.synchronize()
        k4_s, rounds = time.perf_counter() - t0, CC.connected_components.rounds
        k2, plain_cc = CC.connected_components(m, 8, "vmem"), CC.connected_components(m, 8, "xla")
        torch.cuda.synchronize()
        if not (torch.equal(k4, plain_cc) and torch.equal(k2, plain_cc)):
            raise AssertionError(f"connected_components differs between routes on {name}: K4 {int((k4 != plain_cc).sum())}, "
                                 f"K2 {int((k2 != plain_cc).sum())} pixels")
        phase(f"  {name} {tuple(m.shape)}: sweeps bit-equal, connected_components equal on K4, K2 and plain "
              f"({rounds} K4 rounds, {k4_s * 1e3:.1f} ms)")
    return 0


def col_chunk_masks(n: int, h: int, w: int):
    """(N, H, W) masks aimed at the row chunks of K4's column kernel (32
    chunks of ceil(H / 32) rows a column, ``kColChunks`` in
    ``csrc/scan.cu``), column by column: runs filling
    every other chunk, runs crossing each chunk border by one pixel on each
    side, runs that end just above a border and start just below it (a
    break exactly at the border), one-pixel runs just below and just above
    each border, full-height columns, and 45% noise with every chunk
    border's two pixels set."""
    import numpy as np

    c = -(-h // 32)
    borders = np.arange(c, h, c)
    m = np.zeros((n, h, w), np.uint8)
    rng = np.random.default_rng(h * 7 + w)
    for j in range(w):
        kind = j % 7
        if kind == 0:
            for k in range(0, -(-h // c), 2):
                m[:, k * c:(k + 1) * c, j] = 1
        elif kind == 1:
            for b in borders:
                m[:, b - 1:b + 1, j] = 1
        elif kind == 2:
            for b in borders:
                m[:, max(b - 5, 0):b, j] = 1
                m[:, b + 1:b + 6, j] = 1
        elif kind == 3:
            m[:, borders, j] = 1
        elif kind == 4:
            m[:, borders - 1, j] = 1
        elif kind == 5:
            m[:, :, j] = 1
        else:
            m[:, :, j] = rng.random((n, h)) < 0.45
            m[:, borders - 1, j] = 1
            m[:, borders, j] = 1
    return m


def check_k4_columns(dev) -> int:
    """K4's column kernel against its plain version on masks aimed at its
    row chunks and page seams, with labels over the whole int32 range
    (INT32_MIN and INT32_MAX among them, under set and unset pixels); then
    20 repeats on 45% noise, each bit-identical.  Returns the max abs error
    (0, or it raises)."""
    import numpy as np
    import torch

    from comic_text_detector_tpu_torch.ops import scan_kernels as K4

    rng = np.random.default_rng(19)

    def labels_for(shape):
        lab = rng.integers(-(2**31), 2**31 - 1, shape, dtype=np.int64).astype(np.int32)
        lab[rng.random(shape) < 0.01] = 2**31 - 1
        lab[rng.random(shape) < 0.01] = -(2**31)
        return torch.from_numpy(lab).to(dev)

    def hold(name, m_np):
        m = torch.from_numpy(np.ascontiguousarray(m_np)).to(dev)
        lab = labels_for(m.shape)
        got, ref = K4.cc_col_sweep(lab, m), K4.cc_col_sweep_plain(lab, m)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"K4 cc_col_sweep differs from its plain version on {name} {tuple(m.shape)}: "
                                 f"{int((got != ref).sum())} pixels")

    names = []
    # chunk borders at the path's height, at 32 x 64 and its neighbours (the
    # last heights whose chunks keep their mask in a register, and the first
    # that read it again), at a tall height, and with empty chunks
    for n, h, w in ((1, 1536, 1536), (1, 1535, 97), (1, 1537, 97), (1, 2048, 64), (1, 2047, 70), (1, 2049, 70),
                    (1, 3001, 97), (1, 31, 53), (1, 33, 53), (2, 64, 1531)):
        hold("chunk borders", col_chunk_masks(n, h, w))
        names.append(f"{n}x{h}x{w}")
    # one row, and one column
    for shape in ((1, 1, 1531), (3, 1, 40), (1, 1537, 1)):
        hold("one row or column", (rng.random(shape) < 0.6).astype(np.uint8))
        names.append("x".join(map(str, shape)))
    # a 4-page stack whose seams are set on both sides, under different labels
    seam = (rng.random((4, 1536, 1531)) < 0.45).astype(np.uint8)
    seam[:, :2] = 1
    seam[:, -2:] = 1
    hold("page seams set on both sides", seam)
    seam_full = np.zeros((4, 1536, 97), np.uint8)
    seam_full[:, :, ::2] = 1  # full-height columns on every page
    hold("full-height columns on 4 pages", seam_full)
    names += ["4x1536x1531 seams", "4x1536x97 full-height"]
    phase(f"  K4 column kernel bit-equal on its row-chunk borders, one-row and one-column maps and page seams: "
          + ", ".join(names))
    # 20 repeats on 45% noise, each bit-identical to the plain version
    m = torch.from_numpy((rng.random((4, 1536, 1536)) < 0.45).astype(np.uint8)).to(dev)
    lab = labels_for(m.shape)
    ref = K4.cc_col_sweep_plain(lab, m)
    for i in range(20):
        got = K4.cc_col_sweep(lab, m)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"K4 cc_col_sweep repeat {i} on 45% noise differs: {int((got != ref).sum())} pixels")
    phase("  K4 column kernel: 20 repeats on (4, 1536, 1536) 45% noise, each bit-identical")
    return 0


ROW_CHUNKS = (16, 32, 48, 64, 96, 128)  # K4 row kernel's chunk widths, ``launch_rows<C>`` in csrc/scan.cu


def row_lane_masks(n: int, w: int, rng):
    """(N, 10, W) masks aimed at the lane borders of K4's row kernel (one
    warp a row, lane i holding pixels [i*C, i*C + C), C the least of
    ``ROW_CHUNKS`` with 32 * C >= W), one kind a row, each page starting at
    another kind: runs ending at each border, runs starting at it, runs
    crossing it by one pixel a side, single-pixel runs just before and
    just after it, an all-one row, every other chunk set throughout, 45%
    noise with both pixels at each border set, and with only the one
    before it set, and a row set but for its two end pixels."""
    import numpy as np

    c = next(c for c in ROW_CHUNKS if 32 * c >= w)
    borders = np.arange(c, w, c)
    rows = []
    for kind in range(10):
        r = np.zeros(w, np.uint8)
        if kind == 0:
            for b in borders:
                r[max(b - 5, 0):b] = 1
        elif kind == 1:
            for b in borders:
                r[b:b + 5] = 1
        elif kind == 2:
            for b in borders:
                r[b - 1:b + 1] = 1
        elif kind == 3:
            r[borders - 1] = 1
        elif kind == 4:
            r[borders] = 1
        elif kind == 5:
            r[:] = 1
        elif kind == 6:
            for k in range(0, -(-w // c), 2):
                r[k * c:(k + 1) * c] = 1
        elif kind in (7, 8):
            r[:] = rng.random(w) < 0.45
            r[borders - 1] = 1
            r[borders] = kind == 7
        else:
            r[1:w - 1] = 1
        rows.append(r)
    m = np.stack(rows)
    return np.stack([m[np.roll(np.arange(10), -p)] for p in range(n)])


def check_k4_rows(dev) -> int:
    """K4's row kernel against its plain version on masks aimed at its lane
    borders (``row_lane_masks``) at widths 1, 31, 32, 33, 47, 49, 127, 129,
    1535, 1536, 1537, 2047, 2049, 4095 and 4096, on stacks whose adjacent
    pages' last and first rows are both set throughout, and on views at odd
    element offsets (every row then unaligned, or aligned row by row at
    odd widths), with labels over the whole int32 range (INT32_MIN and
    INT32_MAX among them, under set and unset pixels); then 20 repeats on
    45% noise at (4, 1536, 1536), each bit-identical.  Returns the max abs
    error (0, or it raises)."""
    import numpy as np
    import torch

    from comic_text_detector_tpu_torch.ops import scan_kernels as K4

    rng = np.random.default_rng(23)

    def labels_for(shape):
        lab = rng.integers(-(2**31), 2**31 - 1, shape, dtype=np.int64).astype(np.int32)
        lab[rng.random(shape) < 0.01] = 2**31 - 1
        lab[rng.random(shape) < 0.01] = -(2**31)
        return torch.from_numpy(lab).to(dev)

    def hold(name, m, lab):
        got, ref = K4.cc_row_sweep(lab, m), K4.cc_row_sweep_plain(lab, m)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"K4 cc_row_sweep differs from its plain version on {name} {tuple(m.shape)}: "
                                 f"{int((got != ref).sum())} pixels")

    widths = (1, 31, 32, 33, 47, 49, 127, 129, 1535, 1536, 1537, 2047, 2049, 4095, 4096)
    cases = 0
    for w in widths:
        m = torch.from_numpy(row_lane_masks(3, w, rng)).to(dev)
        hold(f"lane borders at W = {w}", m, labels_for(m.shape))
        # pages whose last and first rows are set throughout
        seam = (rng.random((4, 6, w)) < 0.5).astype(np.uint8)
        seam[:, 0] = 1
        seam[:, -1] = 1
        seam_t = torch.from_numpy(seam).to(dev)
        hold(f"page seams at W = {w}", seam_t, labels_for(seam.shape))
        # views at odd element offsets of larger buffers: the labels 1 element
        # (4 bytes) off 16-byte alignment, the mask 1 or 3 bytes off
        for lo, mo in ((1, 1), (2, 3)):
            lab_buf = labels_for((m.numel() + lo,))
            m_buf = torch.zeros(m.numel() + mo, dtype=torch.uint8, device=dev)
            m_buf[mo:] = m.reshape(-1)
            hold(f"views at offsets {lo} / {mo} at W = {w}", m_buf[mo:].view(m.shape), lab_buf[lo:].view(m.shape))
        cases += 4
    phase(f"  K4 row kernel bit-equal on its lane borders, page seams and odd-offset views ({cases} cases) at widths "
          + ", ".join(map(str, widths)))
    m = torch.from_numpy((rng.random((4, 1536, 1536)) < 0.45).astype(np.uint8)).to(dev)
    lab = labels_for(m.shape)
    ref = K4.cc_row_sweep_plain(lab, m)
    for i in range(20):
        got = K4.cc_row_sweep(lab, m)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"K4 cc_row_sweep repeat {i} on 45% noise differs: {int((got != ref).sum())} pixels")
    phase("  K4 row kernel: 20 repeats on (4, 1536, 1536) 45% noise, each bit-identical")
    return 0


def same_values(got, ref) -> bool:
    """Bit-equal in integer types; in float32 equal values and NaN at the
    same places (the plain versions' ``torch.minimum`` may write NaN bits
    of its own, the kernels return the input's)."""
    import torch

    if not got.dtype.is_floating_point:
        return torch.equal(got, ref)
    return torch.equal(got.isnan(), ref.isnan()) and torch.equal(got.nan_to_num(0.0), ref.nan_to_num(0.0))


def check_k5(dev) -> int:
    """The three K5 functions against their plain versions, uint8 and
    float32: at 1536x1536, 1x4097, 4097x1 and 1037x1531; at the seams of
    the kernel's layout (strips of 4 pixels, warps of 128 columns, bands of
    rows): every H and W of 1, 2 and 3, W of 127, 129 and 4097, float32
    with NaN, +inf and -inf planted at strip, segment and band borders;
    and on a view at an odd byte offset of an odd-width image (``x[1:]`` of
    a flattened buffer: every uint8 row then starts off alignment, or row
    by row at odd widths).  Returns the max abs error (0, or it raises)."""
    import numpy as np
    import torch

    from comic_text_detector_tpu_torch.ops import morph as K5

    rng = np.random.default_rng(6)
    names = ("erode3x3", "dilate3x3", "erode3x3_ellipse")

    def image(shape, dtype):
        if dtype == "uint8":
            return rng.integers(0, 256, shape, dtype=np.uint8)
        x = (rng.standard_normal(shape) * 100).astype(np.float32)
        h, w = shape
        for special in (np.nan, np.inf, -np.inf):  # at strip, segment and band borders
            for rows, cols in ((np.arange(7, h, 8), slice(None)), (np.arange(8, h, 8), slice(None)),
                               (slice(None), np.arange(3, w, 4)), (slice(None), np.arange(4, w, 4)),
                               (slice(None), np.arange(127, w, 128)), (slice(None), np.arange(128, w, 128))):
                x[rows, cols] = np.where(rng.random(x[rows, cols].shape) < 0.05, special, x[rows, cols])
        return x

    def hold(label, x):
        for name in names:
            kernel = getattr(K5, name)
            before = kernel.launches
            got, ref = kernel(x), getattr(K5, name + "_plain")(x)
            torch.cuda.synchronize()
            if kernel.launches != before + 1 or not same_values(got, ref):
                raise AssertionError(f"K5 {name} differs from its plain version on {label} {tuple(x.shape)} {x.dtype}: "
                                     f"{int((got != ref).sum())} pixels, launches +{kernel.launches - before}")

    for shape in ((1536, 1536), (1, 4097), (4097, 1), (1037, 1531)):
        for dtype in ("uint8", "float32"):
            x_np = (rng.integers(0, 256, shape, dtype=np.uint8) if dtype == "uint8"
                    else (rng.standard_normal(shape) * 100).astype(np.float32))
            hold("random", torch.from_numpy(x_np).to(dev))
        phase(f"  K5 erode, dilate, cross erode bit-equal at {shape}, uint8 and float32")
    seams = [(h, w) for h in (1, 2, 3) for w in (1, 2, 3)] + [(37, 127), (37, 129), (5, 4097), (300, 129), (47, 1531)]
    for shape in seams:
        for dtype in ("uint8", "float32"):
            hold("seams", torch.from_numpy(image(shape, dtype)).to(dev))
    # views at odd offsets of odd-width images, read in place (``.contiguous()``
    # keeps them): uint8 one byte off, float32 one element off
    for shape in ((37, 129), (300, 1531), (3, 3)):
        for dtype in ("uint8", "float32"):
            x = torch.from_numpy(image(shape, dtype)).to(dev)
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
            buf[1:] = x.reshape(-1)
            hold("an odd-offset view", buf[1:].view(shape))
    phase("  K5 erode, dilate, cross erode equal in uint8 and float32 (NaN compared as NaN) at the seams: H, W in "
          "{1, 2, 3}, W 127, 129, 4097, 1531, NaN and infinities at strip, segment and band borders, views at odd "
          "offsets of 37x129, 300x1531 and 3x3")
    return 0


def write_pages(root: str, rng, n: int) -> str:
    """``n`` seeded synthetic pages written by the port's PNG writer, each
    with its text mask (``mask-*.png``), line quads (``line-*.txt``) and
    YOLO block labels (``p*.txt``: ``cls x y w h`` normalized), the layout
    the three trainers' datasets read."""
    import numpy as np

    from comic_text_detector_tpu_torch.utils.io import imwrite

    os.makedirs(root, exist_ok=True)
    sizes = [(768, 544), (704, 512), (832, 576), (640, 448)]
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        page, mask, quads, blocks = synthetic_page(rng, h, w, colour=i % 3 == 1, truth=True)
        imwrite(os.path.join(root, f"p{i:02d}.png"), page)
        imwrite(os.path.join(root, f"mask-p{i:02d}.png"), mask)
        np.savetxt(os.path.join(root, f"line-p{i:02d}.txt"), quads, fmt="%d")
        cls, x0, y0, x1, y1 = blocks.T.astype(np.float64)
        yolo = np.stack([cls, (x0 + x1) / 2 / w, (y0 + y1) / 2 / h, (x1 - x0) / w, (y1 - y0) / h], axis=1)
        np.savetxt(os.path.join(root, f"p{i:02d}.txt"), yolo, fmt=["%d"] + ["%.6f"] * 4)
    return root


def grad_gap(a, b) -> tuple:
    """(relative L2 over all trainable gradients, worst leaf's max-abs gap
    over its max-abs) of model ``a`` against model ``b``."""
    import torch

    num = den = 0.0
    worst = 0.0
    gb = dict(b.named_parameters())
    for k, p in a.named_parameters():
        if p.grad is None:
            continue
        d = p.grad.double().cpu() - gb[k].grad.double().cpu()
        ref = gb[k].grad.double().cpu()
        num += float(torch.sum(d * d))
        den += float(torch.sum(ref * ref))
        worst = max(worst, float(d.abs().max()) / max(float(ref.abs().max()), 1e-30))
    return (num / max(den, 1e-300)) ** 0.5, worst


def step_kernels(fn, reps: int) -> dict:
    """Device ms and launches a call of ``fn`` by kernel name (CUPTI through
    torch.profiler, averaged over ``reps`` calls)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / reps / 1e3, e.count / reps) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def train_phase(name: str, card: str, smi: str, trainer, make_state, loader, to_step, step, run_trainer,
                ckpt: str):
    """The checks the trainers share, on the card at imgsz 512, batch 8:
    one step against the same step on the CPU (each loss term within 1e-4
    relative, gradients within 1e-3 in relative L2),
    20 steps on a fixed batch (a finite loss that falls; ms a step, peak
    memory), the trainer's own ``train`` (its checkpoint written), and two
    runs of the next 3 steps from that checkpoint (bit-identical losses).
    ``step`` returns the loss or a dict of loss terms with ``loss``."""
    import numpy as np
    import torch

    from comic_text_detector_tpu_torch.training import checkpoint as ckpt_lib

    def terms(out) -> dict:
        return {k: v.detach() for k, v in out.items()} if isinstance(out, dict) else {"loss": out.detach()}

    batches = list(loader)
    fixed = batches[0]
    on = {d: to_step(fixed, d) for d in ("cpu", card)}
    states = {d: make_state(d) for d in ("cpu", card)}
    t0 = time.perf_counter()
    outs = {d: {k: float(v) for k, v in terms(step(states[d], on[d])).items()} for d in ("cpu", card)}
    cpu_s = time.perf_counter() - t0
    rels = {k: abs(outs[card][k] - v) / max(abs(v), 1e-30) for k, v in outs["cpu"].items()}
    rel = max(rels.values())
    losses = {d: outs[d]["loss"] for d in outs}
    l2, worst = grad_gap(states[card].model, states["cpu"].model)
    phase(f"  {name}: one step, card {losses[card]:.7f} / CPU {losses['cpu']:.7f} (rel "
          + ", ".join(f"{k} {v:.2e}" for k, v in rels.items())
          + f"), gradients rel L2 {l2:.2e}, worst leaf {worst:.2e} of its max-abs ({cpu_s:.1f} s with the CPU's)")
    if not rel <= 1e-4:
        raise AssertionError(f"{name}: card and CPU loss terms differ by {rels} relative (limit 1e-4)")
    if not l2 <= 1e-3:
        raise AssertionError(f"{name}: card and CPU gradients differ by {l2:.2e} in relative L2 (limit 1e-3)")
    del states

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = make_state(card)
    seq = []
    for i in range(20):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        seq.append(terms(step(state, on[card]))["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 18
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30  # the model, optimizer and steps
    seq = [float(x) for x in seq]
    phase(f"  {name}: 20 steps on one batch, loss {seq[0]:.5f} -> {seq[-1]:.5f}; {ms:.2f} ms a step "
          f"({1e3 / ms:.2f} steps/s), peak memory {peak:.2f} GiB; {smi}")
    if not (np.isfinite(seq).all() and seq[-1] < seq[0]):
        raise AssertionError(f"{name}: the loss on a fixed batch did not fall: {seq}")
    by_kernel = step_kernels(lambda: step(state, on[card]), 3)
    busy = sum(v[0] for v in by_kernel.values())
    launches = sum(v[1] for v in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:6]
    phase(f"  {name}: device busy {busy:.2f} ms a step (CUPTI) in {launches:g} kernel launches, idle share "
          f"{1 - busy / ms:.3f}; top kernels (ms, launches a step): "
          + ", ".join(f"{k[:60]} {v[0]:.2f} x{v[1]:g}" for k, v in top) + f"; {smi}")
    # the cost of bit-for-bit steps: the same steps with cuDNN free to pick
    # non-deterministic algorithms (TF32 still off); a measurement only
    from comic_text_detector_tpu_torch.training import steps as steps_mod

    deterministic = steps_mod._cudnn
    steps_mod._cudnn = lambda: torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                                          allow_tf32=False)
    try:
        for i in range(12):
            if i == 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            step(state, on[card])
        torch.cuda.synchronize()
    finally:
        steps_mod._cudnn = deterministic
    ms_free = (time.perf_counter() - t0) * 1e3 / 10
    phase(f"  {name}: {ms_free:.2f} ms a step with cuDNN's non-deterministic algorithms allowed; {smi}")

    t0 = time.perf_counter()
    out = run_trainer()
    torch.cuda.synchronize()
    trainer_s = time.perf_counter() - t0
    phase(f"  {name}: {trainer.__name__.rsplit('.', 1)[-1]}.train, {out['steps']} steps with 2 evals and checkpoints, "
          f"{trainer_s:.2f} s ({out['steps'] / trainer_s:.3f} steps/s with data loading); {smi}")
    if not os.path.exists(ckpt) or not os.path.exists(ckpt + ".meta.json"):
        raise AssertionError(f"{name}: {ckpt} was not written")

    runs = []
    for _ in range(2):
        st = ckpt_lib.restore(ckpt, make_state(card))["state"]
        runs.append(torch.stack([terms(step(st, to_step(b, card)))["loss"] for b in batches[:3]]).cpu())
    if not torch.equal(runs[0], runs[1]):
        raise AssertionError(f"{name}: two runs from {os.path.basename(ckpt)} differ: {runs}")
    phase(f"  {name}: 3 steps from {os.path.basename(ckpt)}, twice: bit-identical losses {runs[0].tolist()}")
    return out, {"ms_a_step": ms, "steps_per_s": 1e3 / ms, "peak_gib": peak, "loss_20_steps": [seq[0], seq[-1]],
                 "busy_ms_a_step": busy, "idle_share": 1 - busy / ms, "kernel_launches_a_step": launches,
                 "ms_a_step_nondeterministic": ms_free,
                 "top_kernels": {k[:80]: v for k, v in top},
                 "card_vs_cpu_loss_rel": rel, "card_vs_cpu_rel": rels, "card_vs_cpu_grad_rel_l2": l2,
                 "card_vs_cpu_grad_worst_leaf": worst,
                 "trainer_s": trainer_s, "trainer_steps": out["steps"], "restore_losses": runs[0].tolist()}


def colliding_labels():
    """YOLO labels aimed at the dense target assignment's edges: a pair of
    equal boxes of other classes (their candidates collide on every cell
    and anchor), an overlapping box, centres at the corners, within one
    cell of a border and on cell borders, a zero-size box and masked
    boxes; two pages, the second in reverse order."""
    import numpy as np

    rows = [[0, 0.40, 0.40, 0.20, 0.20], [1, 0.40, 0.40, 0.20, 0.20], [1, 0.43, 0.41, 0.19, 0.22],
            [0, 0.01, 0.02, 0.10, 0.08], [1, 0.99, 0.985, 0.12, 0.30], [0, 1.0 / 64, 0.5, 0.2, 0.2],
            [1, 0.5, 63.0 / 64, 0.2, 0.2], [0, 0.5, 0.5, 0.0, 0.3], [1, 0.3, 0.7, 0.3, 0.2], [0, 0.3, 0.7, 0.3, 0.2],
            [1, 0.96875, 0.03125, 0.6, 0.9], [0, 0.5, 0.5, 0.95, 0.95], [1, 0.125, 0.25, 0.02, 0.03]]
    labels = np.asarray([rows, rows[::-1]], np.float32)
    mask = np.ones(labels.shape[:2], bool)
    mask[0, 8:10] = False
    mask[1, 3:5] = False
    return labels, mask


def yolo_phase(dev, smi: str, counters: dict, work: str, train_dir: str, val_dir: str, deploy: dict,
               imgsz: int, bs: int) -> dict:
    """Phase 15: the YOLO block trainer on the card (see the module
    docstring)."""
    import numpy as np
    import torch

    from comic_text_detector_tpu_torch.data import blk_dataset, seg_dataset
    from comic_text_detector_tpu_torch.models.yolo import augmented_detect
    from comic_text_detector_tpu_torch.pipeline import TextDetector
    from comic_text_detector_tpu_torch.training import checkpoint as ckpt_lib
    from comic_text_detector_tpu_torch.training import seg_trainer, yolo_trainer
    from comic_text_detector_tpu_torch.training.steps import (
        Optimizer, create_seg_train_state, create_yolo_train_state, seg_train_step, yolo_eval_step, yolo_train_step,
    )
    from comic_text_detector_tpu_torch.training.yolo_loss import _level_targets
    from comic_text_detector_tpu_torch.weights import (
        blk_train_from_deploy, deploy_from_train, train_from_deploy, variables_from_state_dict,
    )

    card = str(dev)
    for fn in counters.values():
        fn.launches = 0
    yolo_vars = blk_train_from_deploy(deploy)
    hyp = {"data": {"train_img_dir": train_dir, "val_img_dir": val_dir, "imgsz": imgsz, "augment": True,
                    "aug_param": {"hsv": 0.5, "flip_lr": 0.5, "neg": 0.1}, "save_dir": work},
           "train": {"epochs": 2, "batch_size": bs, "lr0": 2e-3, "lrf": 0.05, "optimizer": "adam", "momentum": 0.9,
                     "weight_decay": 0.0, "eval_interval": 1, "warmup_steps": 2}}

    # the dense targets of colliding labels: the card's equal to the CPU's,
    # and bit-identical over 20 repeats
    labels, mask = colliding_labels()
    spec = yolo_trainer.build_model(yolo_vars).spec
    n_pos = []
    for a, s in zip(spec.anchors, spec.strides):
        ag = torch.tensor(a, dtype=torch.float32).view(-1, 2) / s
        g = imgsz // s
        ref = _level_targets(torch.from_numpy(labels), torch.from_numpy(mask), ag, g, g)
        args = (torch.from_numpy(labels).to(dev), torch.from_numpy(mask).to(dev), ag.to(dev), g, g)
        first = _level_targets(*args)
        if not torch.equal(first.cpu(), ref):
            raise AssertionError(f"dense targets at {g}x{g} differ between the card and the CPU")
        for _ in range(20):
            if not torch.equal(_level_targets(*args), first):
                raise AssertionError(f"dense targets at {g}x{g} differ between repeats on the card")
        n_pos.append(int(ref[..., 5].sum()))
    phase(f"  YOLO dense targets of colliding labels at {imgsz // 8}, {imgsz // 16}, {imgsz // 32}: the card's equal "
          f"to the CPU's and bit-identical over 20 repeats ({n_pos} positives)")

    def yolo_state(d):
        model = yolo_trainer.build_model(yolo_vars).to(d)
        return create_yolo_train_state(model, lambda p: Optimizer(p, "adam", 1e-4, momentum=0.9))

    def yolo_batch(b, d):
        return tuple(torch.from_numpy(x).to(d) for x in b)

    _, loader = blk_dataset.create_dataloader(train_dir, imgsz, bs, as_uint8=True, shuffle=False)
    out, res = train_phase(
        "YOLO", card, smi, yolo_trainer, yolo_state, loader, yolo_batch, lambda st, b: yolo_train_step(st, *b),
        lambda: yolo_trainer.train(hyp, variables=yolo_vars, device=card), os.path.join(work, "yolo_last.ctd"))

    best = os.path.join(work, "yolo_best.ctd")
    if not os.path.exists(best) or out["ap"] is None or not np.isfinite(out["best_loss"]):
        raise AssertionError(f"yolo_trainer.train wrote no {best} or no AP50: {out['best_loss']}, {out['ap']}")
    meta = json.load(open(os.path.join(work, "yolo_last.ctd.meta.json")))
    phase(f"  YOLO trainer: best_loss {out['best_loss']:.5f} (yolo_last meta {meta['best_loss']:.5f}), AP50 "
          f"{out['ap']['ap50'].round(4).tolist()} mAP50 {out['ap']['map50']:.4f} over {out['ap']['n_gt'].tolist()} "
          "blocks (eng, ja)")

    # the evals on the card against the CPU on the same state and val pages
    _, val_loader = blk_dataset.create_dataloader(val_dir, imgsz, min(4, bs), augment=False, shuffle=False,
                                                  as_uint8=True)
    vb = next(iter(val_loader))
    states = {d: yolo_state(d) for d in ("cpu", card)}
    rows = {d: yolo_trainer.detect_batch(states[d], torch.from_numpy(vb[0]).to(d)) for d in ("cpu", card)}
    (rc, cc), (rg, cg) = rows["cpu"], [t.cpu() for t in rows[card]]
    if not torch.equal(cc, cg) or int(cc.sum()) == 0:
        raise AssertionError(f"NMS counts differ between the card and the CPU (or are all 0): {cg} / {cc}")
    box_gap = max(float((rg[b, :n, :4] - rc[b, :n, :4]).abs().max()) for b, n in enumerate(cc.tolist()) if n)
    conf_gap = max(float((rg[b, :n, 4] - rc[b, :n, 4]).abs().max()) for b, n in enumerate(cc.tolist()) if n)
    if box_gap > 1e-2 or conf_gap > 1e-4 or not torch.equal(rg[..., 5], rc[..., 5]):
        raise AssertionError(f"NMS rows differ between the card and the CPU: boxes {box_gap}, conf {conf_gap}")
    aps = {d: yolo_trainer.eval_detection_ap(states[d], val_loader) for d in ("cpu", card)}
    ap_gap = float(np.abs(aps[card]["ap50"] - aps["cpu"]["ap50"]).max())
    if ap_gap > 1e-3 or not np.array_equal(aps[card]["n_gt"], aps["cpu"]["n_gt"]):
        raise AssertionError(f"AP50 differs between the card and the CPU: {aps}")
    evs = {d: yolo_eval_step(states[d], *(torch.from_numpy(x).to(d) for x in vb)) for d in ("cpu", card)}
    ev_rel = max(abs(float(evs[card][k]) - float(v)) / max(abs(float(v)), 1e-30) for k, v in evs["cpu"].items())
    if ev_rel > 1e-3:
        raise AssertionError(f"the eval loss terms differ between the card and the CPU: {evs}")
    phase(f"  YOLO eval, card vs CPU on {len(vb[0])} val pages: NMS counts {cg.tolist()} equal, boxes within "
          f"{box_gap:.2e} px, confidences {conf_gap:.2e}; AP50 {aps[card]['ap50'].round(4).tolist()} (CPU "
          f"{aps['cpu']['ap50'].round(4).tolist()}, gap {ap_gap:.1e}); eval loss terms within {ev_rel:.1e} relative")
    # the evals' own time, the val batches loaded first
    val = list(val_loader)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ap_card = yolo_trainer.eval_detection_ap(states[card], val)
    eval_ap_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for b in val:
        float(yolo_eval_step(states[card], *(torch.from_numpy(x).to(dev) for x in b))["loss"])
    eval_loss_ms = (time.perf_counter() - t0) * 1e3
    phase(f"  YOLO evals on {len(val) * min(4, bs)} val pages (loaded first): loss {eval_loss_ms:.1f} ms, AP50 "
          f"(decode, NMS, matching) {eval_ap_ms:.1f} ms, mAP50 {ap_card['map50']:.4f}; {smi}")

    # test-time augmentation: the card against the CPU on one batch
    x = torch.from_numpy(vb[0]).permute(0, 3, 1, 2).float() / 255.0
    tta = {}
    for d in ("cpu", card):
        states[d].model.eval()
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
            tta[d] = augmented_detect(states[d].model.blk_det, x.to(d)).cpu()
    tta_gap = float(((tta[card] - tta["cpu"]).abs() / (1.0 + tta["cpu"].abs())).max())
    if tta["cpu"].shape != tta[card].shape or not tta_gap <= 1e-3:
        raise AssertionError(f"augmented_detect differs between the card and the CPU: {tta_gap}")
    phase(f"  augmented_detect on {tuple(x.shape)}: {tuple(tta[card].shape)} rows, card vs CPU within {tta_gap:.2e} "
          "(absolute over 1 + |CPU value|)")
    del states

    launched = {k: fn.launches for k, fn in counters.items() if fn.launches}
    if launched:
        raise AssertionError(f"a hand-written kernel launched during the YOLO steps: {launched}")
    phase("  launches of K1-K6 across the YOLO steps, evals and test-time augmentation: none (no TPU kernel lies "
          "on this path)")

    # the flagship chain: the YOLO-trained blk_det into the deploy tree,
    # served by TextDetector, and its layers 0-9 as the seg trainer's backbone
    trained = variables_from_state_dict(out["state"].model.state_dict())
    tree = deploy_from_train(trained, deploy)
    path = os.path.join(work, "yolo_trained.npz")
    ckpt_lib.save_compact(path, tree)
    page = synthetic_page(np.random.default_rng(15), 1400, 1000, colour=False)
    mask_, mask_ref, blks = TextDetector(path, input_size=1024, device=card)(page)
    if mask_.shape != (1400, 1000) or mask_ref.shape != (1400, 1000):
        raise AssertionError(f"TextDetector on the YOLO-trained checkpoint gave masks of {mask_.shape}")
    seg_vars = train_from_deploy(tree)

    def same_tree(a, b) -> bool:
        if isinstance(a, dict):
            return isinstance(b, dict) and a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
        return np.array_equal(a, b)

    for col in ("params", "batch_stats"):
        layers = seg_vars[col]["backbone"]
        if sorted(layers, key=lambda k: int(k.split("_")[1]))[-1] != "model_9" or not all(
                same_tree(v, trained[col]["blk_det"][k]) for k, v in layers.items()):
            raise AssertionError(f"the seg backbone's {col} are not the YOLO-trained layers 0-9")
    model = seg_trainer.build_model(seg_vars, "leaky", with_db=False).to(dev)
    st = create_seg_train_state(model, lambda p: Optimizer(p, "adam", 1e-4, momentum=0.9))
    imgs, masks = next(iter(seg_dataset.create_dataloader(train_dir, "", imgsz, bs, as_uint8=True)[1]))
    seg_loss = float(seg_train_step(st, torch.from_numpy(imgs).to(dev), torch.from_numpy(masks).to(dev))["loss"])
    if not np.isfinite(seg_loss):
        raise AssertionError(f"the seg step on the YOLO-trained backbone gave {seg_loss}")
    phase(f"  the YOLO-trained blk_det in the deploy tree served a page through TextDetector ({len(blks)} blocks, "
          f"mask>30 {(mask_ > 30).mean():.4f}); its layers 0-9 as the seg trainer's backbone: one step, loss "
          f"{seg_loss:.5f}")
    res.update(eval_loss_ms=eval_loss_ms, eval_ap_ms=eval_ap_ms, ap50=aps[card]["ap50"].tolist(),
               map50=aps[card]["map50"], ap50_cpu=aps["cpu"]["ap50"].tolist(), n_gt=aps[card]["n_gt"].tolist(),
               nms_box_gap_px=box_gap, nms_conf_gap=conf_gap, eval_rel=ev_rel, tta_gap=tta_gap,
               target_positives=n_pos, trainer_best_loss=out["best_loss"],
               trainer_ap50=out["ap"]["ap50"].tolist(), handoff_blocks=len(blks), handoff_seg_loss=seg_loss)
    return res


def train_phases(dev, smi: str, counters: dict, imgsz: int = 512, bs: int = 8) -> dict:
    """Phases 13-15: the seg, DB and YOLO trainers on the card, imgsz 512,
    batch 8 (scripts/train_flagship.py's configuration), from the flagship
    weights carried into the train trees, on 2 x ``bs`` train and ``bs``
    val seeded synthetic pages."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from comic_text_detector_tpu_torch.data import db_dataset, seg_dataset
    from comic_text_detector_tpu_torch.ops import cc_kernels as K
    from comic_text_detector_tpu_torch.ops import finalize as K6
    from comic_text_detector_tpu_torch.ops.geometry import iou_convex
    from comic_text_detector_tpu_torch.pipeline import TextDetector
    from comic_text_detector_tpu_torch.postproc.db_rep import SegDetectorRepresenter
    from comic_text_detector_tpu_torch.training import checkpoint as ckpt_lib
    from comic_text_detector_tpu_torch.training import db_trainer, seg_trainer
    from comic_text_detector_tpu_torch.training.metrics import QuadMetric, pixel_prf1
    from comic_text_detector_tpu_torch.training.steps import (
        Optimizer, create_db_train_state, create_seg_train_state, db_eval_step, db_train_step, seg_eval_step,
        seg_train_step,
    )
    from comic_text_detector_tpu_torch.weights import (
        deploy_from_train, load_npz, train_from_deploy, variables_from_state_dict,
    )

    card = str(dev)
    work = tempfile.mkdtemp(prefix="ctd_train_")
    try:
        rng = np.random.default_rng(14)
        t0 = time.perf_counter()
        train_dir = write_pages(os.path.join(work, "train"), rng, 2 * bs)
        val_dir = write_pages(os.path.join(work, "val"), rng, bs)
        phase(f"  {3 * bs} synthetic pages written as PNG in {time.perf_counter() - t0:.1f} s")
        deploy = load_npz(WEIGHTS)
        seg_vars = train_from_deploy(deploy)
        data = {"train_img_dir": train_dir, "val_img_dir": val_dir, "imgsz": imgsz, "augment": True,
                "aug_param": {"hsv": 0.5, "flip_lr": 0.5, "neg": 0.1, "mini_mosaic": 0.2}, "save_dir": work}
        results = {}

        phase(f"13/19 seg trainer on the card: imgsz {imgsz}, batch {bs}, full width, flagship_r2 weights")
        hyp_seg = {"data": data, "model": {"act": "leaky"},
                   "train": {"epochs": 2, "batch_size": bs, "lr0": 2e-3, "lrf": 0.05, "optimizer": "adam",
                             "momentum": 0.9, "weight_decay": 0.0, "eval_interval": 1, "accumulation_steps": 1,
                             "warmup_steps": 2}}

        def seg_state(d):
            model = seg_trainer.build_model(seg_vars, "leaky", with_db=False).to(d)
            return create_seg_train_state(model, lambda p: Optimizer(p, "adam", 1e-4, momentum=0.9))

        def seg_batch(b, d):
            return tuple(torch.from_numpy(x).to(d) for x in b)

        _, seg_loader = seg_dataset.create_dataloader(train_dir, "", imgsz, bs, as_uint8=True)
        seg_out, results["seg"] = train_phase(
            "seg", card, smi, seg_trainer, seg_state, seg_loader, seg_batch,
            lambda st, b: seg_train_step(st, *b)["loss"],
            lambda: seg_trainer.train(hyp_seg, variables=seg_vars, device=card),
            os.path.join(work, "unet_last.ctd"))
        st = seg_out["state"]
        _, val_loader = seg_dataset.create_dataloader(val_dir, "", imgsz, min(4, bs), as_uint8=True)
        val = list(val_loader)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sums = torch.zeros(3, dtype=torch.float64, device=dev)
        for imgs, masks in val:
            m = seg_eval_step(st, torch.from_numpy(imgs).to(dev), torch.from_numpy(masks).to(dev))
            sums += torch.stack([m["tp"], m["gt"], m["pr"]]).double()
        r, p, f1 = pixel_prf1(*sums.tolist())
        eval_ms = (time.perf_counter() - t0) * 1e3
        phase(f"  seg eval on {bs} pages: pixel P {p:.4f} R {r:.4f} F1 {f1:.4f}, {eval_ms:.1f} ms; {smi}")
        if not np.isfinite([p, r, f1]).all():
            raise AssertionError("seg eval gave a non-finite metric")
        results["seg"].update(eval_ms=eval_ms, pixel_p=p, pixel_r=r, pixel_f1=f1, best_f1=seg_out["best_f1"])
        unet_vars = variables_from_state_dict(st.model.state_dict())
        del st, seg_out

        phase(f"14/19 DB trainer on the card: grafted from the seg state, loss bce, imgsz {imgsz}, batch {bs}")
        db_vars = db_trainer.graft_db_variables(train_from_deploy(deploy, with_db=True), unet_vars)
        hyp_db = {"data": dict(data, augment=False), "model": {"act": "leaky"},
                  "train": {"epochs": 2, "batch_size": bs, "lr0": 1e-3, "lrf": 0.1, "optimizer": "adam",
                            "momentum": 0.9, "weight_decay": 0.0, "eval_interval": 1, "accumulation_steps": 1,
                            "loss": "bce", "warmup_steps": 2}}
        keys = ("imgs", "shrink_map", "shrink_mask", "threshold_map", "threshold_mask")

        def db_state(d):
            model = seg_trainer.build_model(db_vars, "leaky", with_db=True).to(d)
            return create_db_train_state(model, lambda p: Optimizer(p, "adam", 1e-4, momentum=0.937))

        def db_batch(b, d):
            return {k: torch.from_numpy(b[k]).to(d) for k in keys}

        _, db_loader = db_dataset.create_dataloader(train_dir, "", imgsz, bs, as_uint8=True)
        db_out, results["db"] = train_phase(
            "DB", card, smi, db_trainer, db_state, db_loader, db_batch,
            lambda st, b: db_train_step(st, b, use_bce=True)["loss"],
            lambda: db_trainer.train(hyp_db, variables=train_from_deploy(deploy, with_db=True),
                                     unet_variables=unet_vars, device=card),
            os.path.join(work, "db_last.ctd"))
        st = db_out["state"]

        # the eval: K6 binarize and K2 must launch, seen by their counts and
        # by kernel name in a profiler trace
        _, dval_loader = db_dataset.create_dataloader(val_dir, "", imgsz, bs, as_uint8=True, with_ann=True)
        rep = SegDetectorRepresenter(thresh=0.5, device=card)
        db_trainer.eval_model(st, dval_loader, rep, QuadMetric())  # warm
        for fn in counters.values():
            fn.launches = 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rpf = db_trainer.eval_model(st, dval_loader, rep, QuadMetric())
            torch.cuda.synchronize()
        eval_counts = {k: fn.launches for k, fn in counters.items() if fn.launches}
        names = {e.key for e in prof.key_averages()}
        by_name = {"K6 binarize": any("finalize_kernel" in n and "Above" in n for n in names),
                   "K2": any("gather_kernel<true>" in n for n in names)}
        phase(f"  DB eval: launches {eval_counts}; in the trace by kernel name: {by_name}")
        if eval_counts.get("K6 binarize", 0) <= 0 or eval_counts.get("K2", 0) <= 0 or not all(by_name.values()):
            raise AssertionError(f"the DB eval did not launch K6 binarize and K2: {eval_counts}, {by_name}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rpf = db_trainer.eval_model(st, dval_loader, rep, QuadMetric())
        eval_ms = (time.perf_counter() - t0) * 1e3
        phase(f"  DB eval on {bs} pages: R {rpf[0]:.4f} P {rpf[1]:.4f} F {rpf[2]:.4f}, {eval_ms:.1f} ms; {smi}")
        vb = next(iter(dval_loader))
        preds = db_eval_step(st, torch.from_numpy(vb["imgs"]).to(dev))
        # the path's two kernels against their plain versions on the path's
        # own inputs: each page's shrink plane read in place, its bitmap
        for page in preds[:, 0]:
            bits = K6.binarize(page, 0.5)
            if not torch.equal(bits, K6.binarize_plain(page, 0.5)):
                raise AssertionError("K6 binarize differs from its plain version on a DB eval map")
            if not torch.equal(K.cc_windows_local(bits[None]), K.cc_windows_local_plain(bits[None])):
                raise AssertionError("K2 differs from its plain version on a DB eval bitmap")
        phase(f"  K6 binarize and K2 bit-equal to their plain versions on the eval's {preds.shape[0]} maps")
        gb, gs = rep(vb, preds)
        cb, cs = SegDetectorRepresenter(thresh=0.5, device="cpu")(vb, preds.cpu())
        if not (all(np.array_equal(a, b) for a, b in zip(gb, cb))
                and all(np.allclose(a, b, rtol=0, atol=1e-5) for a, b in zip(gs, cs))):
            raise AssertionError("the DB eval's quads on the card differ from the CPU representer's")
        low = QuadMetric()
        low = low.gather_measure([low.validate_measure(vb, (gb, gs), 0.3)])
        # the metric on these batches: the ground truth as the prediction
        # scores 1; and how near the net's quads come to the ground truth
        self_q = QuadMetric()
        self_q = self_q.gather_measure([self_q.validate_measure(
            vb, ([np.asarray(p) for p in vb["text_polys"]], [np.ones(len(p)) for p in vb["text_polys"]]))])
        if self_q["fmeasure"].avg < 0.99:
            raise AssertionError(f"QuadMetric of the ground truth against itself: {self_q['fmeasure'].avg}")
        best = [max((iou_convex(q, g) for q in boxes), default=0.0)
                for boxes, gts in zip(gb, vb["text_polys"]) for g in gts]
        phase(f"  DB eval metric: the ground truth against itself F {self_q['fmeasure'].avg:.4f}; each ground-truth "
              f"line's best IoU with the net's quads: mean {np.mean(best):.3f}, median {np.median(best):.3f}, "
              f"over 0.5 {np.mean(np.asarray(best) > 0.5):.3f} ({len(best)} lines)")
        phase(f"  DB eval quads equal to the CPU representer's on the same maps: {[len(b) for b in gb]} a page; "
              f"scores {np.concatenate(gs).mean() if sum(map(len, gs)) else 0:.3f} on average; at box_thresh 0.3 "
              f"R {low['recall'].avg:.4f} P {low['precision'].avg:.4f} F {low['fmeasure'].avg:.4f}")
        results["db"].update(eval_ms=eval_ms, recall=rpf[0], precision=rpf[1], fmeasure=rpf[2],
                             eval_launches=eval_counts, quads=[len(b) for b in gb],
                             rpf_box_thresh_0_3=[low["recall"].avg, low["precision"].avg, low["fmeasure"].avg],
                             gt_best_iou_mean=float(np.mean(best)))

        # the trained heads back into a deploy tree, through the compact npz,
        # served by the port's TextDetector
        trained = deploy_from_train(variables_from_state_dict(st.model.state_dict()),
                                    deploy_from_train(unet_vars, deploy))
        path = os.path.join(work, "trained.npz")
        ckpt_lib.save_compact(path, trained)
        mask, mask_ref, blks = TextDetector(path, input_size=1024, device=card)(
            synthetic_page(rng, 1400, 1000, colour=False))
        if mask.shape != (1400, 1000) or mask_ref.shape != (1400, 1000):
            raise AssertionError(f"TextDetector on the trained checkpoint gave masks of {mask.shape}")
        phase(f"  the trained deploy tree, saved compact and loaded by TextDetector, served a page: "
              f"{len(blks)} blocks, mask>30 {(mask > 30).mean():.4f}")
        del st, db_out

        phase(f"15/19 YOLO trainer on the card: imgsz {imgsz}, batch {bs}, full width and depth, the whole graph "
              "in train mode, flagship_r2's blk_det")
        results["yolo"] = yolo_phase(dev, smi, counters, work, train_dir, val_dir, deploy, imgsz, bs)
        return results
    finally:
        shutil.rmtree(work, ignore_errors=True)


def net_outputs(model, pages, size: int, device: str):
    """The net's (blk, seg, det) on each page's letterbox, as ``run_net``
    gives them."""
    import torch

    from comic_text_detector_tpu_torch.ops.resize import letterbox_device_u8
    from comic_text_detector_tpu_torch.pipeline.detector import run_net

    with torch.no_grad():
        return [run_net(model, letterbox_device_u8(torch.from_numpy(p).to(device), size)[None]) for p in pages]


def model_files_phase(det_base, pages, drive, names, smi: str, size: int = 1024, device: str = "cuda") -> dict:
    """Phase 16: every model file ``TextDetector`` loads or writes, each
    written into a temporary directory, loaded, and run on ``pages`` through
    ``drive`` (every launch count set to 0 just before, read just after; a
    kernel of ``names`` not launched fails), against ``det_base``
    (``TextDetector(WEIGHTS, ...)`` in the same configuration): the
    reference ``.pt``, the three training files, the native msgpack file
    bit-identical; the ``.onnx`` (Conv+BN folded by the export) within the
    JAX ingestion test's tolerances and refined IoU >= 0.99; the ``.pt2``
    program within 1e-4 of the module.  Returns the numbers printed."""
    import tempfile

    import numpy as np
    import torch

    from comic_text_detector_tpu_torch.config import YOLOV5S_CFG
    from comic_text_detector_tpu_torch.export import export_onnx, export_program
    from comic_text_detector_tpu_torch.models.convert import export_torch_checkpoint, load_from_parts
    from comic_text_detector_tpu_torch.models.onnx_ingest import convert_onnx_checkpoint
    from comic_text_detector_tpu_torch.pipeline import TextDetector
    from comic_text_detector_tpu_torch.weights import load_npz

    kw = dict(input_size=size, device=device, refine_backend="device", mask_transfer="packed")
    base, base_counts = drive(lambda: [det_base(p) for p in pages], names)
    phase(f"  baseline TextDetector(flagship_r2.npz): launches {base_counts}")
    variables = load_npz(WEIGHTS)
    out = {}

    def serve(fmt: str, make, bit_identical: bool = False):
        """Load a detector with ``make``, run the pages through ``drive``;
        with ``bit_identical``, fail unless they equal the baseline's."""
        t0 = time.perf_counter()
        det = make()
        load_s = time.perf_counter() - t0
        res, counts = drive(lambda: [det(p) for p in pages], names)
        same = all(same_outputs(r, b) for r, b in zip(res, base))
        ious = [1.0 if np.array_equal(r[1], b[1]) else mask_iou(r[1], b[1]) for r, b in zip(res, base)]
        out[fmt] = {"load_s": load_s, "launches": counts, "bit_identical": same, "refined_iou": ious,
                    "blocks": [len(r[2]) for r in res], "blocks_base": [len(b[2]) for b in base]}
        phase(f"  {fmt}: loaded in {load_s:.2f} s, {out[fmt]['blocks']} blocks (base {out[fmt]['blocks_base']}), "
              f"bit-identical {same}, refined IoU {min(ious):.5f}; launches {counts}; {smi}")
        if bit_identical and not same:
            raise AssertionError(f"{fmt}: pages differ from the .npz detector's")
        return det

    with tempfile.TemporaryDirectory() as d:
        ckpt = export_torch_checkpoint(variables)
        pt = os.path.join(d, "comictextdetector.pt")
        torch.save(ckpt, pt)
        serve(".pt", lambda: TextDetector(pt, **kw), bit_identical=True)

        files = []
        for name, part in (("blk.pt", {"cfg": YOLOV5S_CFG, "weights": ckpt["blk_det"]["weights"]}),
                           ("unet_best.ckpt", {"weights": ckpt["text_seg"], "epoch": 1}),
                           ("db_best.ckpt", {"weights": ckpt["text_det"], "epoch": 1})):
            files.append(os.path.join(d, name))
            torch.save(part, files[-1])

        def from_parts():
            parts_vars, cfg = load_from_parts(*files)
            return TextDetector(variables=parts_vars, cfg=cfg, **kw)

        serve("three parts", from_parts, bit_identical=True)

        native = os.path.join(d, "ctd.msgpack")
        det_base.save_variables(native)
        serve("native", lambda: TextDetector.from_native(native, **kw), bit_identical=True)

        onnx_path = os.path.join(d, "comictextdetector.pt.onnx")
        t0 = time.perf_counter()
        export_onnx(det_base.model, onnx_path, input_size=128)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        convert_onnx_checkpoint(onnx_path)
        ingest_s = time.perf_counter() - t0
        det_onnx = serve(".onnx", lambda: TextDetector(onnx_path, **kw))
        gaps = {"blk": 0.0, "seg": 0.0, "det": 0.0}
        base_nets = net_outputs(det_base.model, pages, size, device)
        for got, want in zip(net_outputs(det_onnx.model, pages, size, device), base_nets):
            for name, g, w in zip(gaps, got, want):
                gaps[name] = max(gaps[name], float((g - w).abs().max()))
            within = [torch.allclose(got[0], want[0], rtol=1e-3, atol=5e-3),
                      torch.allclose(got[1], want[1], rtol=0, atol=1e-4),
                      torch.allclose(got[2], want[2], rtol=0, atol=1e-4)]
            if not all(within):
                raise AssertionError(f".onnx net outside blocks 1e-3 + 5e-3, mask and lines 1e-4: gaps {gaps}")
        if min(out[".onnx"]["refined_iou"]) < 0.99:
            raise AssertionError(f".onnx refined IoU {out['.onnx']['refined_iou']} under 0.99")
        out[".onnx"].update(export_s=export_s, ingest_host_s=ingest_s, net_gap=gaps)
        phase(f"  .onnx: export at 128 {export_s:.2f} s (Conv+BN folded), ingestion {ingest_s:.3f} s on the host; "
              f"net at {size} against the .npz net, largest gaps {gaps}; {smi}")

        pt2 = os.path.join(d, "ctd.pt2")
        t0 = time.perf_counter()
        export_program(variables, pt2, input_size=size, device=device)
        export_s = time.perf_counter() - t0
        det_pt2 = serve(".pt2", lambda: TextDetector(pt2, **kw))
        gap, bit = 0.0, True
        for got, want in zip(net_outputs(det_pt2.model, pages, size, device), base_nets):
            gap = max(gap, max(float((g - w).abs().max()) for g, w in zip(got, want)))
            bit = bit and all(torch.equal(g, w) for g, w in zip(got, want))
        if gap > 1e-4:
            raise AssertionError(f".pt2 net {gap} from the module's, over 1e-4")
        ms = {"program": [], "module": []}  # in turns: program, module, module, program
        for name, det in (("program", det_pt2), ("module", det_base), ("module", det_base), ("program", det_pt2)):
            ms[name].append(page_time_of(det, pages))
        out[".pt2"].update(export_s=export_s, net_gap=gap, net_bit_identical=bit, ms_per_page=ms["program"],
                           ms_per_page_module=ms["module"])
        phase(f"  .pt2: torch.export at {size} on {device} {export_s:.2f} s; net outputs within {gap:.3e} of the "
              f"module's (bit-identical {bit}); ms/page in turns: program {ms['program']}, module "
              f"{ms['module']}; {smi}")
    return out


def v5s_tr_cfg() -> dict:
    """yolov5 v5.0 ``models/hub/yolov5s-transformer.yaml`` with this repo's
    ``nc: 2`` and anchors (depth 0.33, width 0.50): the v5.0 backbone (Focus
    stem, SPP, three C3TR last) and the v5.0 yolov5s head, which is
    ``YOLOV5S_CFG``'s."""
    import copy

    from comic_text_detector_tpu_torch.config import YOLOV5S_CFG

    cfg = copy.deepcopy(YOLOV5S_CFG)
    cfg["backbone"] = [
        [-1, 1, "Focus", [64, 3]],
        [-1, 1, "Conv", [128, 3, 2]],
        [-1, 3, "C3", [128]],
        [-1, 1, "Conv", [256, 3, 2]],
        [-1, 9, "C3", [256]],
        [-1, 1, "Conv", [512, 3, 2]],
        [-1, 9, "C3", [512]],
        [-1, 1, "Conv", [1024, 3, 2]],
        [-1, 1, "SPP", [1024, [5, 9, 13]]],
        [-1, 3, "C3TR", [1024, False]],
    ]
    return cfg


def v5s_ghost_cfg() -> dict:
    """yolov5 v6.0 ``models/hub/yolov5s-ghost.yaml`` with this repo's
    ``nc: 2`` and anchors: ``YOLOV5S_CFG`` with every Conv after layer 0 a
    GhostConv and every C3 a C3Ghost."""
    import copy

    from comic_text_detector_tpu_torch.config import YOLOV5S_CFG

    cfg = copy.deepcopy(YOLOV5S_CFG)
    for i, row in enumerate(cfg["backbone"] + cfg["head"]):
        if row[2] == "C3":
            row[2] = "C3Ghost"
        elif row[2] == "Conv" and i > 0:
            row[2] = "GhostConv"
    return cfg


# Phase 17's random weights (``variant_variables``): ``random_variables``
# (the reference init from a seeded torch.Generator); then every BatchNorm's
# running statistics set to the batch statistics of two seeded synthetic
# pages at 512 (the init's identity BatchNorms let the features of a
# 60-layer random graph fade to a constant, and a constant score puts a
# block on every cell of a grid or on none); then every Detect conv bias
# drawn from N(0, DETECT_BIAS_STD**2) of the same generator, the objectness
# biases shifted by DETECT_OBJ_SHIFT, so that the scores' upper tail alone
# passes the default conf_thresh of 0.4: measured on the CPU at 1024, 19-67
# blocks a page (V5S_TR) and 65-267 (V5S_GHOST) on phase 4's pages, 30 and
# 135 on phase 5's.
DETECT_BIAS_STD, DETECT_OBJ_SHIFT = 2.0, -11.0
VARIANT_CONF_THRESH = 0.4


def variant_variables(cfg: dict, seed: int) -> dict:
    """Deploy variables (JAX layout) of the three-head net on ``cfg``:
    the seeded reference init, the BatchNorm statistics of two seeded
    pages, and the Detect biases spread (above)."""
    import numpy as np
    import torch
    from torch import nn

    from comic_text_detector_tpu_torch.models.detector import build_inference_model
    from comic_text_detector_tpu_torch.ops.resize import letterbox_device_u8
    from comic_text_detector_tpu_torch.models.init import random_variables
    from comic_text_detector_tpu_torch.weights import state_dict_from_jax, variables_from_state_dict

    model = build_inference_model(cfg)
    model.load_state_dict(state_dict_from_jax(random_variables(seed, cfg), cfg))
    for mod in model.modules():
        if isinstance(mod, nn.BatchNorm2d):
            mod.reset_running_stats()
            mod.momentum = None  # a cumulative average: the batch's statistics
    pages = [synthetic_page(np.random.default_rng(100 + i), 700, 500, colour=bool(i)) for i in range(2)]
    x = torch.stack([letterbox_device_u8(torch.from_numpy(p), 512) for p in pages]).permute(0, 3, 1, 2) / 255.0
    with torch.no_grad():
        model.train()(x)
        model.eval()
        gen = torch.Generator().manual_seed(seed + 1000)
        for conv in model.blk_det.model[-1].m:
            b = torch.randn(conv.bias.shape, generator=gen) * DETECT_BIAS_STD
            b.view(3, -1)[:, 4] += DETECT_OBJ_SHIFT
            conv.bias.copy_(b)
    return variables_from_state_dict(model.state_dict())


# Phase 17's bf16 check (``hold_bf16_pieces``).  The card and the CPU sum
# in float32 in other orders, so on one bf16 input a step with one sum
# rounds a few elements the other way; after three or four sums in a row
# the two roundings are independent and the gap is that of two bf16 runs.
# So every leaf step of a new block (a Conv with its BatchNorm and
# activation, a Linear, attention's in-projection, attention's scores,
# softmax and weighted sum) is held alone, on the CPU's bf16 input: its
# card-vs-CPU gap (relative L2) at most LEAF_RATIO times the CPU's own
# bf16-vs-float32 gap on that input.  Measured on the CPU on phase 5's page
# at 1024, a step summed exactly (float64) and rounded at the same places
# lies 0.000-0.021 of that gap from the CPU's; attention's softmax left in
# float32 0.544, a step computed in float32 and cast at its end 1.01-1.12.
# The blocks around the steps (Focus, SPP, C3TR and its transformer, GhostConv,
# GhostBottleneck, C3Ghost) are held at BLOCK_RATIO: two independent
# roundings lie about sqrt(2) of one rounding's gap apart, a wrong layout
# lies the signal's size apart.
LEAF_RATIO, BLOCK_RATIO = 0.25, 2.0


def hold_bf16_pieces(name: str, det_card, det_cpu, page, size: int) -> dict:
    """Phase 17: hold the card's bf16 against the CPU's, piece by piece, in
    the first instance of each new block type of ``det_card``'s graph (both
    detectors bf16, the same weights), each piece on the input it gets in
    the CPU's run of ``page`` at ``size`` (above).  Returns each piece's
    ratio of gaps, with the largest leaf and block printed."""
    import torch

    from comic_text_detector_tpu_torch.models import blocks as B
    from comic_text_detector_tpu_torch.ops.resize import letterbox_device_u8

    new_blocks = (B.Focus, B.SPP, B.C3TR, B.GhostConv, B.C3Ghost)
    blocks = (B.TransformerBlock, B.TransformerLayer, B.GhostBottleneck) + new_blocks
    cpu_mods, card_mods = dict(det_cpu.model.named_modules()), dict(det_card.model.named_modules())
    firsts = {}
    for n, mod in det_cpu.model.blk_det.model.named_children():
        firsts.setdefault(type(mod), f"blk_det.model.{n}")
    roots = [n for t, n in firsts.items() if t in new_blocks]
    inputs = {}
    hooks = [cpu_mods[n].register_forward_pre_hook(lambda mod, inp, n=n: inputs.setdefault(n, inp) and None)
             for n in cpu_mods
             if any(n == r or n.startswith(r + ".") for r in roots)
             and isinstance(cpu_mods[n], (B.Conv, B.Linear, B.MultiheadAttention) + blocks)]
    x = letterbox_device_u8(torch.from_numpy(page), size)[None].permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        det_cpu.model.blk_det(x.to(torch.bfloat16))
    for h in hooks:
        h.remove()

    def pieces():  # (label, leaf, CPU callable, card callable, bf16 inputs)
        for n, inp in inputs.items():
            cpu, card = cpu_mods[n], card_mods[n]
            yield n, not isinstance(cpu, blocks + (B.MultiheadAttention,)), cpu, card, inp
            if isinstance(cpu, B.MultiheadAttention):
                heads = [cpu.project(t, i) for i, t in enumerate(inp)]
                heads[0] = heads[0] * (cpu.embed // cpu.num_heads) ** -0.5
                for i, t in enumerate(inp):
                    yield f"{n}.project[{i}]", True, lambda t, i=i: cpu.project(t, i), lambda t, i=i: card.project(t, i), (t,)
                yield f"{n}.attend", True, cpu.attend, card.attend, tuple(heads)

    out, worst = {}, {True: (0.0, ""), False: (0.0, "")}
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                                     allow_tf32=False):
        for label, leaf, cpu, card, inp in pieces():
            want, want32 = cpu(*inp), cpu(*(t.float() for t in inp))
            got = card(*(t.cuda() for t in inp))
            if got.dtype != want.dtype or got.shape != want.shape:
                raise AssertionError(f"{name} bf16, {label}: {got.dtype} {tuple(got.shape)} on the card, "
                                     f"{want.dtype} {tuple(want.shape)} on the CPU")
            want, want32, got = want.float(), want32.float(), got.float().cpu()
            gap = float((got - want).norm() / want.norm())
            base = float((want - want32).norm() / want32.norm())
            ratio = gap / base if base else (0.0 if gap == 0 else float("inf"))
            out[label] = {"ratio": ratio, "gap": gap, "bf16_vs_f32": base, "leaf": leaf}
            worst[leaf] = max(worst[leaf], (ratio, label))
            if ratio > (LEAF_RATIO if leaf else BLOCK_RATIO):
                raise AssertionError(f"{name} bf16, {label}: card-vs-CPU gap {gap:.3e} is {ratio:.3f} of the CPU's "
                                     f"bf16-vs-float32 gap {base:.3e}, over {LEAF_RATIO if leaf else BLOCK_RATIO}")
    n_leaf = sum(v["leaf"] for v in out.values())
    phase(f"  {name} bf16 piece by piece on phase 5's page at {size}, card vs CPU on the CPU's bf16 input "
          f"(gap over the CPU's bf16-vs-float32 gap): {n_leaf} leaf steps, largest {worst[True][0]:.4f} "
          f"({worst[True][1]}; at most {LEAF_RATIO}); {len(out) - n_leaf} blocks, largest {worst[False][0]:.4f} "
          f"({worst[False][1]}; at most {BLOCK_RATIO})")
    return out


def variant_phase(pages, small, drive, smi: str, det_flagship, size: int = 1024) -> dict:
    """Phase 17: the YOLO graph's block variants and the side paths on the
    card.  ``V5S_TR`` and ``V5S_GHOST`` (random weights, ``variant_variables``)
    through ``TextDetector`` at ``size``, device refine, packed masks, in
    float32 and bf16, on ``pages`` through ``drive`` (K1 and K2 must
    launch), each call repeated bit-identical; in float32 the card against
    the CPU route on ``small`` (the same blocks within 1 px and refined IoU
    >= 0.99 on a refined mask that is not empty, as phase 5); in bf16 the
    new blocks held piece by piece on ``small`` (``hold_bf16_pieces``).  Then
    ``V5S_TR``'s ``.pt`` (``export_torch_checkpoint``), native file and
    ``.pt2`` (written by the CLI's ``export``) serving ``pages``
    bit-identical to the variables-built detector; the CLI's ``detect`` and
    ``annotate`` with the flagship weights against direct calls; ms a page
    of the variant detectors and ``det_flagship`` on one page in two
    turns.  Returns the numbers printed."""
    import filecmp
    import tempfile

    import numpy as np
    import torch

    from comic_text_detector_tpu_torch import cli
    from comic_text_detector_tpu_torch.constants import REFINEMASK_ANNOTATION
    from comic_text_detector_tpu_torch.models.convert import export_torch_checkpoint
    from comic_text_detector_tpu_torch.pipeline import TextDetector, model2annotations
    from comic_text_detector_tpu_torch.utils.io import NumpyEncoder, imread, imwrite

    kw = dict(input_size=size, refine_backend="device", mask_transfer="packed", conf_thresh=VARIANT_CONF_THRESH)
    phase(f"  random weights: the reference init from torch.Generator seeds 0 (V5S_TR) and 1 (V5S_GHOST), BatchNorm "
          f"statistics of two seeded pages, Detect biases from N(0, {DETECT_BIAS_STD}^2) with the objectness ones "
          f"shifted by {DETECT_OBJ_SHIFT}; conf_thresh {VARIANT_CONF_THRESH}")
    out, f32 = {}, {}
    for seed, (name, make) in enumerate((("V5S_TR", v5s_tr_cfg), ("V5S_GHOST", v5s_ghost_cfg))):
        cfg = make()
        variables = variant_variables(cfg, seed)
        for half in (False, True):
            tag = f"{name} {'bf16' if half else 'f32'}"
            det = TextDetector(variables=variables, cfg=cfg, half=half, **kw)
            res, counts = drive(lambda: [det(p) for p in pages], ["K1", "K2"])
            if not all(same_outputs(a, det(p)) for a, p in zip(res, pages)):
                raise AssertionError(f"{tag}: a repeat call differs")
            for p, (mask, refined, blks) in zip(pages, res):
                if mask.shape != p.shape[:2] or refined.shape != p.shape[:2] or not blks:
                    raise AssertionError(f"{tag}: page {p.shape} gave masks {mask.shape} and {len(blks)} blocks")
            if half:  # the whole path's bf16 is chaotic on random weights (PERF.md): held piece by piece
                cpu = TextDetector(variables=variables, cfg=cfg, half=True, device="cpu", **kw)
                out[tag] = {"launches": counts, "blocks": [len(r[2]) for r in res],
                            "pieces": hold_bf16_pieces(name, det, cpu, small, size)}
                phase(f"  {tag}: {out[tag]['blocks']} blocks a page, repeat calls bit-identical; launches {counts}")
                continue
            # the CPU route at 1024 on phase 5's page, float32: at 512 these
            # random weights leave that page no refined pixel (V5S_GHOST), and
            # on a larger page one grey pixel at the seg head's edge moved the
            # refine's components (IoU 0.897 with the same 62 blocks)
            cpu = TextDetector(variables=variables, cfg=cfg, device="cpu", **kw)
            got, want = det(small.copy()), cpu(small.copy())
            iou = mask_iou(got[1], want[1])
            out[tag] = {"launches": counts, "blocks": [len(r[2]) for r in res], "cpu_route_iou": iou,
                        "cpu_route_blocks": [len(got[2]), len(want[2])]}
            phase(f"  {tag}: {out[tag]['blocks']} blocks a page, repeat calls bit-identical; launches {counts}; "
                  f"card vs CPU route on phase 5's page: {len(got[2])} / {len(want[2])} blocks, refined IoU {iou:.5f} "
                  f"({int((want[1] > 30).sum())} px set on the CPU)")
            # phase 5's rule; the blocks matched as sets (their reading order sorts near-ties)
            a = np.asarray([b.xyxy for b in got[2]], np.int64).reshape(-1, 1, 4)
            b = np.asarray([b.xyxy for b in want[2]], np.int64).reshape(1, -1, 4)
            apart = np.abs(a - b).max(axis=2) if a.size and b.size else np.zeros((0, 0))
            if not got[2] or len(got[2]) != len(want[2]) or apart.min(axis=1).max() > 1 \
                    or apart.min(axis=0).max() > 1:
                raise AssertionError(f"{tag}, phase 5's page: blocks {[b.xyxy for b in got[2]]} on the card, "
                                     f"{[b.xyxy for b in want[2]]} on the CPU")
            if not (want[1] > 30).any():
                raise AssertionError(f"{tag}: the CPU route's refined mask is empty, so its IoU says nothing")
            if iou < 0.99:
                raise AssertionError(f"{tag}: refined IoU {iou:.5f} between card and CPU, under 0.99")
            f32[name] = (det, cfg, variables, res)

    det_tr, cfg_tr, vars_tr, base = f32["V5S_TR"]
    with tempfile.TemporaryDirectory() as d:
        def serve(fmt: str, make) -> float:
            t0 = time.perf_counter()
            det = make()
            load_s = time.perf_counter() - t0
            if not all(same_outputs(det(p), b) for p, b in zip(pages, base)):
                raise AssertionError(f"V5S_TR from its {fmt}: pages differ from the variables-built detector's")
            out.setdefault("V5S_TR files", {})[fmt] = {"load_s": load_s}
            phase(f"  V5S_TR from its {fmt}: loaded in {load_s:.2f} s, pages bit-identical; {smi}")
            return load_s

        pt = os.path.join(d, "v5s_tr.pt")
        torch.save(export_torch_checkpoint(vars_tr, cfg_tr), pt)
        load_pt = serve(".pt", lambda: TextDetector(pt, **kw))
        native = os.path.join(d, "v5s_tr.msgpack")
        det_tr.save_variables(native)
        serve("native file", lambda: TextDetector.from_native(native, cfg=cfg_tr, **kw))
        pt2 = os.path.join(d, "v5s_tr.pt2")
        t0 = time.perf_counter()
        cli.main(["export", "--model", pt, "--out", pt2, "--input-size", str(size)])
        out["V5S_TR files"] = dict(out["V5S_TR files"], cli_export_s=time.perf_counter() - t0)
        load_pt2 = serve(".pt2 from the CLI's export", lambda: TextDetector(pt2, **kw))

        page_png = os.path.join(d, "page0.png")
        imwrite(page_png, pages[0])
        prefix = os.path.join(d, "p0")
        cli.main(["detect", "--model", WEIGHTS, "--image", page_png, "--out-prefix", prefix,
                  "--input-size", str(size)])
        mask, refined, blks = TextDetector(WEIGHTS, input_size=size)(imread(page_png), keep_undetected_mask=True)
        with open(prefix + "-blocks.json") as f:
            same_json = json.load(f) == json.loads(json.dumps([b.to_dict() for b in blks], cls=NumpyEncoder))
        if not (np.array_equal(imread(prefix + "-mask.png", grayscale=True), mask)
                and np.array_equal(imread(prefix + "-mask-refined.png", grayscale=True), refined) and same_json):
            raise AssertionError("CLI detect: its files differ from a direct TextDetector call")
        phase(f"  CLI detect on a PNG page: -mask.png, -mask-refined.png and -blocks.json ({len(blks)} blocks) "
              "equal to a direct TextDetector call")

        ann_in, ann_cli, ann_direct = (os.path.join(d, n) for n in ("ann_in", "ann_cli", "ann_direct"))
        for n in (ann_in, ann_cli, ann_direct):
            os.makedirs(n)
        for i, p in enumerate(list(pages) + [small]):
            imwrite(os.path.join(ann_in, f"page{i}.png"), p)
        cli.main(["annotate", "--model", WEIGHTS, "--img-dir", ann_in, "--save-dir", ann_cli, "--save-json",
                  "--input-size", str(size)])
        det_ann = TextDetector(WEIGHTS, input_size=size)
        model2annotations(det_ann, ann_in, ann_direct, save_json=True, progress=False)
        names = sorted(os.listdir(ann_direct))
        if sorted(os.listdir(ann_cli)) != names or len(names) < 4 * (len(pages) + 1):
            raise AssertionError(f"CLI annotate wrote {sorted(os.listdir(ann_cli))}, the direct call {names}")
        for n in names:
            a, b = os.path.join(ann_cli, n), os.path.join(ann_direct, n)
            same = np.array_equal(imread(a), imread(b)) if n.endswith(".png") else filecmp.cmp(a, b, shallow=False)
            if not same:
                raise AssertionError(f"CLI annotate: {n} differs from model2annotations' direct call")
        for i in range(len(pages) + 1):
            img = imread(os.path.join(ann_in, f"page{i}.png"))
            _, refined, _ = det_ann(img, refine_mode=REFINEMASK_ANNOTATION, keep_undetected_mask=True)
            if not np.array_equal(imread(os.path.join(ann_cli, f"mask-page{i}.png"), grayscale=True), refined):
                raise AssertionError(f"CLI annotate: mask-page{i}.png differs from a direct TextDetector call")
        phase(f"  CLI annotate on {len(pages) + 1} PNG pages: {len(names)} files equal to model2annotations' direct call, the "
              "masks to direct TextDetector calls")

    ms = {"flagship": [], "V5S_TR": [], "V5S_GHOST": []}
    for name in ("flagship", "V5S_TR", "V5S_GHOST", "V5S_GHOST", "V5S_TR", "flagship"):
        ms[name].append(page_time_of(det_flagship if name == "flagship" else f32[name][0], pages[:1]))
    # the net alone (run_net on page 0's letterbox), apart from the refine,
    # whose work grows with the random weights' block count
    from comic_text_detector_tpu_torch.ops.resize import letterbox_device_u8
    from comic_text_detector_tpu_torch.pipeline.detector import run_net

    lb = letterbox_device_u8(torch.from_numpy(pages[0]).cuda(), size)[None]
    with torch.no_grad():
        net_ms = {name: cuda_ms(lambda m=(det_flagship if name == "flagship" else f32[name][0]).model: run_net(m, lb), 10)
                  for name in ms}
    out.update(ms_per_page_f32=ms, net_ms_f32=net_ms,
               blocks_per_page={"flagship": [len(det_flagship(p)[2]) for p in pages],
                                **{n: out[f"{n} f32"]["blocks"] for n in ("V5S_TR", "V5S_GHOST")}})
    print(f"single page, f32, {size}, device refine, packed: ms on phase 4's page 0 in turns " + ", ".join(
        f"{k} {v}" for k, v in ms.items()) + "; net alone ms " + ", ".join(
        f"{k} {v:.2f}" for k, v in net_ms.items()) + f"; blocks a page {out['blocks_per_page']}; V5S_TR load s: "
        f".pt {load_pt:.2f}, .pt2 {load_pt2:.2f}; {smi}", flush=True)
    return out


MESH_KINDS = ("seg", "db", "yolo")
DB_KEYS = ("imgs", "shrink_map", "shrink_mask", "threshold_map", "threshold_mask")


def mesh_state(kind: str, dev):
    """Phase 18: a train state of ``kind`` from the flagship weights on
    ``dev``, with the optimizer of phases 13-15."""
    from comic_text_detector_tpu_torch.training import seg_trainer, yolo_trainer
    from comic_text_detector_tpu_torch.training.steps import (
        Optimizer, create_db_train_state, create_seg_train_state, create_yolo_train_state,
    )
    from comic_text_detector_tpu_torch.weights import blk_train_from_deploy, load_npz, train_from_deploy

    deploy = load_npz(WEIGHTS)
    if kind == "seg":
        model = seg_trainer.build_model(train_from_deploy(deploy), "leaky", with_db=False).to(dev)
        return create_seg_train_state(model, lambda p: Optimizer(p, "adam", 1e-4, momentum=0.9))
    if kind == "db":
        model = seg_trainer.build_model(train_from_deploy(deploy, with_db=True), "leaky", with_db=True).to(dev)
        return create_db_train_state(model, lambda p: Optimizer(p, "adam", 1e-4, momentum=0.937))
    model = yolo_trainer.build_model(blk_train_from_deploy(deploy)).to(dev)
    return create_yolo_train_state(model, lambda p: Optimizer(p, "adam", 1e-4, momentum=0.9))


def mesh_step(kind: str, state, batch: dict, mesh=None) -> dict:
    """One train step of ``kind`` on the global ``batch`` (NumPy): under
    ``mesh`` each rank takes its block, without it the whole batch goes to
    the state's device.  Returns the loss terms and the trainable
    gradients and BatchNorm running statistics, each flattened."""
    import torch

    from comic_text_detector_tpu_torch.training.steps import db_train_step, seg_train_step, yolo_train_step

    dev = next(state.model.parameters()).device
    t = {k: torch.from_numpy(v) if mesh is not None else torch.from_numpy(v).to(dev) for k, v in batch.items()}
    if kind == "seg":
        m = seg_train_step(state, t["imgs"], t["masks"], mesh=mesh)
    elif kind == "db":
        m = db_train_step(state, {k: t[k] for k in DB_KEYS}, use_bce=True, mesh=mesh)
    else:
        m = yolo_train_step(state, t["imgs"], t["labels"], t["label_mask"], mesh=mesh)
    grads = torch.cat([p.grad.reshape(-1) for p in state.optimizer.params if p.grad is not None])
    stats = torch.cat([b.reshape(-1).float() for name in state.trainable
                       for k, b in getattr(state.model, name).named_buffers() if "running" in k])
    return {"terms": {k: float(v) for k, v in m.items()}, "grads": grads.cpu().numpy(),
            "stats": stats.cpu().numpy()}


def params_digest(state) -> str:
    import hashlib

    h = hashlib.sha256()
    for p in state.model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def mesh_train_rank(mesh, batches: dict, hyps: dict) -> dict:
    """Phase 18's gloo part on one rank: each step kind on its global batch
    under the mesh (the first step's terms, gradients and statistics; the
    parameters' digest after 3 steps), then each trainer's ``train(mesh=)``
    for 2 steps, with the checkpoint writes and the DB eval's K2 and K6
    binarize launches counted on this rank."""
    import torch

    from comic_text_detector_tpu_torch.ops import cc_kernels as K
    from comic_text_detector_tpu_torch.ops import finalize as K6
    from comic_text_detector_tpu_torch.training import checkpoint as ckpt_lib
    from comic_text_detector_tpu_torch.training import db_trainer, seg_trainer, yolo_trainer
    from comic_text_detector_tpu_torch.weights import blk_train_from_deploy, load_npz, train_from_deploy

    dev = mesh.devices[0]
    out = {}
    for kind in MESH_KINDS:
        state = mesh_state(kind, dev)
        out[kind] = mesh_step(kind, state, batches[kind], mesh)
        for _ in range(2):
            mesh_step(kind, state, batches[kind], mesh)
        out[kind]["digest"] = params_digest(state)
        del state
    deploy = load_npz(WEIGHTS)
    variables = {"seg": lambda: train_from_deploy(deploy), "db": lambda: train_from_deploy(deploy, with_db=True),
                 "yolo": lambda: blk_train_from_deploy(deploy)}
    trainers = {"seg": seg_trainer, "db": db_trainer, "yolo": yolo_trainer}
    saves = []
    real_save = ckpt_lib.save

    def counted_save(path, *args, **kwargs):
        saves.append(os.path.basename(path))
        return real_save(path, *args, **kwargs)

    ckpt_lib.save = counted_save
    try:
        for kind, hyp in hyps.items():
            saves.clear()
            K.cc_windows_local.launches = 0
            K6.binarize.launches = 0
            t0 = time.perf_counter()
            res = trainers[kind].train(hyp, variables=variables[kind](), max_steps=2, mesh=mesh)
            torch.cuda.synchronize()
            out["train_" + kind] = {"steps": res["steps"], "saves": list(saves), "s": time.perf_counter() - t0,
                                    "K2": K.cc_windows_local.launches, "K6 binarize": K6.binarize.launches,
                                    "digest": params_digest(res["state"])}
    finally:
        ckpt_lib.save = real_save
    return out


def nccl_yolo_rank(mesh, batch: dict) -> list:
    """Phase 18's NCCL part: the YOLO step through the mesh route at world
    1, twice from the same weights."""
    return [mesh_step("yolo", mesh_state("yolo", mesh.devices[0]), batch, mesh) for _ in range(2)]


def hold_step(name: str, got: dict, ref: dict) -> dict:
    """A mesh step against the one-process step: loss terms within 1e-5
    relative, gradients within 1e-4 in relative L2, running statistics
    within 1e-5 (absolute and relative)."""
    import numpy as np

    rel = {k: abs(got["terms"][k] - v) / max(abs(v), 1e-30) for k, v in ref["terms"].items()}
    g, gr = got["grads"].astype(np.float64), ref["grads"].astype(np.float64)
    l2 = float(np.linalg.norm(g - gr) / max(np.linalg.norm(gr), 1e-30))
    s, sr = got["stats"].astype(np.float64), ref["stats"].astype(np.float64)
    stats_gap = float(np.max(np.abs(s - sr) / (1e-5 + 1e-5 * np.abs(sr)))) if sr.size else 0.0
    if max(rel.values()) > 1e-5 or l2 > 1e-4 or stats_gap > 1.0:
        raise AssertionError(f"{name}: loss terms rel {rel}, gradients rel L2 {l2:.3e}, running statistics at "
                             f"{stats_gap:.3f} of their 1e-5 bound")
    return {"terms_rel": rel, "grads_rel_l2": l2, "stats_gap_of_bound": stats_gap}


def mesh_phase(dev, smi: str, drive, path_1024, variables, warm, spages, out16, out32, stream_pps: float,
               imgsz: int = 512, bs: int = 8, card: str = "cuda:0", world1_backend: str = "nccl") -> dict:
    """Phase 18: data parallelism on the card (see the module docstring).
    ``card`` and ``world1_backend`` let a rehearsal on the CPU run it on
    ``"cpu"`` and gloo."""
    import concurrent.futures
    import shutil
    import tempfile

    import numpy as np
    import torch

    from comic_text_detector_tpu_torch.data import blk_dataset, db_dataset, seg_dataset
    from comic_text_detector_tpu_torch.parallel.mesh import make_mesh, spawn
    from comic_text_detector_tpu_torch.pipeline import BatchTextDetector

    t_phase = time.perf_counter()
    result = {}
    # 1. the batch stream over two replicas (two cards where there are two)
    devices = ["cuda:0", "cuda:1"] if torch.cuda.device_count() > 1 else [card, card]
    bkw = dict(batch_size=4, input_size=1024, refine_backend="device", mask_transfer="packed",
               mesh=make_mesh(devices=devices))
    m32 = BatchTextDetector(variables, half=False, **bkw)
    got32 = list(m32.stream(iter(spages)))
    same32 = [same_outputs(a, b) for a, b in zip(got32, out32)]
    if len(got32) != len(spages) or not all(same32):
        raise AssertionError(f"the float32 mesh stream differs from the stream without a mesh: {same32}")
    del m32
    m16 = BatchTextDetector(variables, half=True, **bkw)
    list(m16.stream(iter(warm)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got16, counts = drive(lambda: list(m16.stream(iter(spages))), path_1024)
    mesh_s = time.perf_counter() - t0
    blocks = [(len(a[2]), len(b[2])) for a, b in zip(got16, out16)]
    ious = [mask_iou(a[1], b[1]) for a, b in zip(got16, out16)]
    if any(a != b for a, b in blocks) or min(ious) < 0.98:
        raise AssertionError(f"bf16 mesh stream against the stream without a mesh: blocks {blocks}, refined IoU "
                             f"{min(ious):.4f}")
    per_page = {k: v / len(spages) for k, v in counts.items() if v}
    phase(f"  BatchTextDetector(mesh=make_mesh(devices={devices})): float32 bit-identical to the stream without a "
          f"mesh on {len(spages)} pages; bf16 the same block counts, refined IoU >= {min(ious):.4f}; "
          f"{len(spages) / mesh_s:.3f} pages/s (phase 6 without a mesh {stream_pps:.3f}); launches a page {per_page}; "
          f"{smi}")
    result["stream"] = {"devices": devices, "pages_per_s_bf16": len(spages) / mesh_s,
                        "pages_per_s_bf16_no_mesh": stream_pps, "launches_per_page": per_page,
                        "launches": counts, "refined_iou_min_bf16": min(ious)}
    del m16
    torch.cuda.empty_cache()

    # 2. two gloo ranks on the card against one process; 3. NCCL at world 1
    work = tempfile.mkdtemp(prefix="ctd_mesh_")
    try:
        rng = np.random.default_rng(18)
        train_dir = write_pages(os.path.join(work, "train"), rng, 16)
        val_dir = write_pages(os.path.join(work, "val"), rng, 8)
        imgs, masks = next(iter(seg_dataset.create_dataloader(train_dir, "", imgsz, bs, as_uint8=True,
                                                              shuffle=False)[1]))
        dbb = next(iter(db_dataset.create_dataloader(train_dir, "", imgsz, bs, as_uint8=True, shuffle=False)[1]))
        bimgs, labels, lmask = next(iter(blk_dataset.create_dataloader(train_dir, imgsz, bs, as_uint8=True,
                                                                         shuffle=False)[1]))
        batches = {"seg": {"imgs": imgs, "masks": masks}, "db": {k: dbb[k] for k in DB_KEYS},
                   "yolo": {"imgs": bimgs, "labels": labels, "label_mask": lmask}}
        train = {"epochs": 1, "batch_size": bs, "lr0": 1e-3, "lrf": 0.1, "optimizer": "adam", "momentum": 0.9,
                 "weight_decay": 0.0, "eval_interval": 1, "accumulation_steps": 1, "loss": "bce", "warmup_steps": 2}
        hyps = {}
        for kind, augment in (("seg", True), ("db", False), ("yolo", True)):
            save_dir = os.path.join(work, kind)
            hyps[kind] = {"data": {"train_img_dir": train_dir, "val_img_dir": val_dir, "imgsz": imgsz,
                                   "augment": augment, "aug_param": {"hsv": 0.5, "flip_lr": 0.5, "neg": 0.1},
                                   "save_dir": save_dir}, "model": {"act": "leaky"}, "train": dict(train)}
        # the two gloo ranks and the NCCL rank start together, and this
        # process takes the one-process steps while they start up
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            gloo = pool.submit(spawn, mesh_train_rank, 2, backend="gloo", devices=[card, card], timeout=600,
                               args=(batches, hyps))
            nccl = pool.submit(spawn, nccl_yolo_rank, 1, backend=world1_backend, devices=[card], timeout=300,
                               args=(batches["yolo"],))
            refs = {kind: mesh_step(kind, mesh_state(kind, dev), batches[kind]) for kind in MESH_KINDS}
            ranks = gloo.result()
            gloo_s = time.perf_counter() - t0
            runs = nccl.result()[0]
            nccl_s = time.perf_counter() - t0
        result["gloo"] = {"s": gloo_s}
        for kind in MESH_KINDS:
            r0, r1 = ranks[0][kind], ranks[1][kind]
            if r0["terms"] != r1["terms"] or r0["digest"] != r1["digest"]:
                raise AssertionError(f"{kind}: the ranks differ: {r0['terms']} / {r1['terms']}, parameters after 3 "
                                     f"steps {r0['digest'][:12]} / {r1['digest'][:12]}")
            held = hold_step(f"{kind} step, 2 gloo ranks", r0, refs[kind])
            result["gloo"][kind] = held
            phase(f"  {kind} step, 2 gloo ranks on {card}, global batch {bs} at {imgsz}: loss terms rel "
                  + ", ".join(f"{k} {v:.2e}" for k, v in held["terms_rel"].items())
                  + f"; gradients rel L2 {held['grads_rel_l2']:.2e}; running statistics at "
                  f"{held['stats_gap_of_bound']:.3f} of the bound; the ranks' parameters bit-identical after 3 steps")
        want_saves = {"seg": ["unet_last.ctd", "unet_best.ctd"], "db": ["db_last.ctd", "db_best.ctd"],
                      "yolo": ["yolo_last.ctd", "yolo_best.ctd"]}
        for kind in MESH_KINDS:
            t0, t1 = ranks[0]["train_" + kind], ranks[1]["train_" + kind]
            if (t0["steps"], t1["steps"]) != (2, 2) or t1["saves"] or want_saves[kind][0] not in t0["saves"] \
                    or not set(t0["saves"]) <= set(want_saves[kind]) or t0["digest"] != t1["digest"]:
                raise AssertionError(f"{kind}_trainer.train(mesh=): rank 0 {t0}, rank 1 {t1}")
            if not all(os.path.exists(os.path.join(work, kind, f)) for f in t0["saves"]):
                raise AssertionError(f"{kind}_trainer.train(mesh=) left no checkpoint in {os.path.join(work, kind)}")
        db0, db1 = ranks[0]["train_db"], ranks[1]["train_db"]
        if db0["K2"] <= 0 or db0["K6 binarize"] <= 0 or db1["K2"] or db1["K6 binarize"]:
            raise AssertionError(f"the mesh DB eval's launches: rank 0 {db0}, rank 1 {db1}")
        result["gloo"]["trainers"] = {k: {"rank0": ranks[0]["train_" + k], "rank1": ranks[1]["train_" + k]}
                                      for k in MESH_KINDS}
        phase(f"  seg, DB and YOLO train(mesh=), 2 gloo ranks, 2 steps each: "
              + ", ".join(f"{k} {ranks[0]['train_' + k]['s']:.1f} s" for k in MESH_KINDS)
              + f"; rank 0 alone wrote {[ranks[0]['train_' + k]['saves'] for k in MESH_KINDS]}; the DB eval on rank 0 "
              f"launched K2 x{db0['K2']} and K6 binarize x{db0['K6 binarize']}, rank 1 none; the ranks' parameters "
              f"bit-identical; {gloo_s:.1f} s for the ranks; {smi}")

        a, b = runs
        if a["terms"] != b["terms"] or not np.array_equal(a["grads"], b["grads"]) \
                or not np.array_equal(a["stats"], b["stats"]):
            raise AssertionError("the NCCL world-1 YOLO step differs between two runs")
        held = hold_step("YOLO step, NCCL at world 1", a, refs["yolo"])
        result["nccl_world1"] = dict(held, s=nccl_s)
        phase(f"  YOLO step through the mesh route, {world1_backend} at world 1: loss terms rel "
              + ", ".join(f"{k} {v:.2e}" for k, v in held["terms_rel"].items())
              + f"; gradients rel L2 {held['grads_rel_l2']:.2e}; two runs bit-identical; {nccl_s:.1f} s from the "
              f"launch of both groups; {smi}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    result["s"] = time.perf_counter() - t_phase
    phase(f"  phase 18 took {result['s']:.1f} s")
    return result


HOST_PHASE_CHILD = r"""
import json, os, sys
sys.modules["PIL"] = None  # Pillow blocked: the rotate and the PNG reader run without it
import numpy as np
from comic_text_detector_tpu_torch.data.db_dataset import create_dataloader
from comic_text_detector_tpu_torch.training import db_trainer
from comic_text_detector_tpu_torch.utils.config import DB_DEFAULTS, deep_merge
train_dir, val_dir, work, device = sys.argv[1:5]
aug = dict(DB_DEFAULTS["data"]["aug_param"], rotate=1.0)
ds, loader = create_dataloader(train_dir, "", 512, 4, augment=True, aug_param=aug, shuffle=True, as_uint8=True)
ds.initialize()
batches = list(loader)
finite = all(np.isfinite(b[k].astype(np.float64)).all() for b in batches for k in b if isinstance(b[k], np.ndarray))
hyp = deep_merge(DB_DEFAULTS, {"data": {"train_img_dir": train_dir, "val_img_dir": val_dir, "save_dir": work}})
out = db_trainer.train(hyp, max_steps=2, device=device)
print(json.dumps({"epoch_batches": len(batches), "epoch_finite": bool(finite), "pil": "PIL.Image" in sys.modules,
                  "imgsz": hyp["data"]["imgsz"], "batch_size": hyp["train"]["batch_size"],
                  "rotate": hyp["data"]["aug_param"]["rotate"], "steps": out["steps"],
                  "losses": out["last_metrics"]}))
"""


def text_line_maps(rng, n: int, size: int):
    """``n`` synthetic (size, size) DB shrink maps of text-line bars (one
    bar per 1500 pixels, rotated, 8-36 px long, 3-8 wide, 0.5-0.95), a 3x3
    box blur and 2% speckle at 0.25, under the representer's threshold:
    about 230 quads a page at 1536."""
    import numpy as np

    maps = np.zeros((n, 2, size, size), np.float32)
    yy, xx = np.mgrid[-20:20, -20:20].astype(np.float32)
    for m in maps[:, 0]:
        for _ in range(size * size // 1500):
            cy, cx = rng.integers(20, size - 20, 2)
            ang = rng.uniform(0, np.pi)
            length, width = rng.uniform(4, 18), rng.uniform(1.5, 4)
            u = xx * np.cos(ang) + yy * np.sin(ang)
            v = -xx * np.sin(ang) + yy * np.cos(ang)
            bar = ((np.abs(u) < length) & (np.abs(v) < width)) * np.float32(rng.uniform(0.5, 0.95))
            win = m[cy - 20:cy + 20, cx - 20:cx + 20]
            np.maximum(win, bar, out=win)
        pad = np.pad(m, 1)
        m[:] = sum(pad[i:i + size, j:j + size] for i in range(3) for j in range(3)) / 9
        m += 0.25 * (rng.random((size, size)) < 0.02)
        np.clip(m, 0, 1, out=m)
    maps[:, 1] = maps[:, 0]
    return maps


def route_rect_areas(stats, k: int, max_candidates: int) -> tuple:
    """The areas (w * h, before the unclip) of the min-area rects that the
    library route and the NumPy route of ``boxes_from_stats`` take for its
    ``k``-th quad on host ``stats``."""
    import numpy as np

    from comic_text_detector_tpu_torch import native
    from comic_text_detector_tpu_torch.ops import geometry as geo

    labels, area = stats.compact_labels.numpy(), stats.area.numpy()
    _, ssides, _ = native.get_native().component_min_area_rects(labels, len(area) - 1, None, 1.5)
    kept = [i for i in range(1, len(area)) if area[i] > 0][:max_candidates]
    comp = [i for i in kept if ssides[i - 1] >= 2.0][k]
    ys, xs = np.nonzero(labels == comp)
    _, lib_w, lib_h = native._min_area_rect(native._hull(xs.astype(np.float64), ys.astype(np.float64)))
    _, (np_w, np_h) = geo.min_area_rect(np.stack([xs, ys], axis=1).astype(np.float64))
    return lib_w * lib_h, np_w * np_h


def host_library_phase(dev, smi: str, lines, thresh: float) -> dict:
    """Phase 19: the host library (``native.py``, ``csrc/ctdnative.cpp``)
    built from the checkout's source into a temporary directory with the
    machine's ``c++``; ``label_components`` and ``component_min_area_rects``
    against their plain versions at 1536x1536 45% noise and on phase 12's
    four DB maps, bit for bit; ``SegDetectorRepresenter``'s quad mode on
    those maps and on two synthetic text-line maps (``text_line_maps``)
    through the library and through the NumPy route (the same counts, equal
    scores, corners within 1 px but where the routes' min-area rects tie in
    area), ms a page of each route's host half and of the whole call,
    repeats bit-identical; and, in a child
    interpreter with Pillow blocked, one DB dataset epoch at imgsz 512 with
    ``rotate: 1.0`` and 2 steps of ``db_trainer.train`` with the default DB
    hyp, its losses finite.  The child (about 25 s, most of it start-up and
    the trainer's first steps) runs beside the build and the library-vs-plain
    holds; the representer's routes are timed after it has ended."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from comic_text_detector_tpu_torch import native
    from comic_text_detector_tpu_torch.ops import cuda_build
    from comic_text_detector_tpu_torch.ops.cc import ComponentStats
    from comic_text_detector_tpu_torch.ops.db_decode import boxes_from_stats, db_device_decode
    from comic_text_detector_tpu_torch.postproc.db_rep import SegDetectorRepresenter

    out = {"card": smi}
    work = tempfile.mkdtemp(prefix="ctd_host_")
    child = None
    try:
        # Pillow blocked: the DB dataset's rotate and the DB trainer with the
        # default hyp, in a child started first
        page_rng = np.random.default_rng(190)
        train_dir = write_pages(os.path.join(work, "train"), page_rng, 8)
        val_dir = write_pages(os.path.join(work, "val"), page_rng, 4)
        child_log = open(os.path.join(work, "child.log"), "w+")
        t_child = time.perf_counter()
        child = subprocess.Popen([sys.executable, "-c", HOST_PHASE_CHILD, train_dir, val_dir, work, str(dev)],
                                 cwd=ROOT, stdout=child_log, stderr=subprocess.STDOUT, text=True)

        cold = os.path.join(work, "libctd_ctdnative_cold.so")
        t0 = time.perf_counter()
        log = cuda_build.finish_build(cuda_build.start_build(native._cxx(), native.CXX_FLAGS, native.SOURCE, cold),
                                      cold)
        if log:
            raise AssertionError(f"the host library did not build:\n{log}")
        out["cold_build_s"] = time.perf_counter() - t0
        fresh, lib = native.NativeLib(cold), native.get_native()
        cxx = subprocess.run([native._cxx(), "--version"], capture_output=True, text=True).stdout.splitlines()[0]
        phase(f"  host library built from csrc/ctdnative.cpp in {out['cold_build_s']:.2f} s ({cxx}; the one in use "
              f"was built in phase 2 in {native.build_seconds:.2f} s)")

        rng = np.random.default_rng(19)
        noise = (rng.random((1536, 1536)) < 0.45).astype(np.uint8)
        shrink = lines[:, 0].float().cpu().numpy()
        cases = [("noise 45% 1536x1536", noise, rng.random(noise.shape).astype(np.float32))]
        cases += [(f"DB map {i} (> {thresh})", (shrink[i] > thresh).astype(np.uint8), shrink[i]) for i in range(len(shrink))]
        held = []
        for name, mask, prob in cases:
            t0 = time.perf_counter()
            labels, n = lib.label_components(mask, 8)
            t1 = time.perf_counter()
            rects = lib.component_min_area_rects(labels, n, prob, 1.5)
            t2 = time.perf_counter()
            plain_labels, plain_n = native.label_components_plain(mask, 8)
            t3 = time.perf_counter()
            plain_rects = native.component_min_area_rects_plain(labels, n, prob, 1.5)
            t4 = time.perf_counter()
            if plain_n != n or not np.array_equal(plain_labels, labels):
                raise AssertionError(f"label_components differs from its plain version on {name}")
            if not all(np.array_equal(a, b) for a, b in zip(rects, plain_rects)):
                raise AssertionError(f"component_min_area_rects differs from its plain version on {name}")
            again = fresh.label_components(mask, 8)
            if again[1] != n or not np.array_equal(again[0], labels) or not all(
                    np.array_equal(a, b) for a, b in zip(fresh.component_min_area_rects(labels, n, prob, 1.5), rects)):
                raise AssertionError(f"the cold build differs from the library in use on {name}")
            l4, n4 = lib.label_components(mask, 4)
            p4, pn4 = native.label_components_plain(mask, 4)
            if n4 != pn4 or not np.array_equal(l4, p4):
                raise AssertionError(f"label_components (4-connected) differs from its plain version on {name}")
            held.append({"case": name, "components": n, "label_ms": (t1 - t0) * 1e3, "rects_ms": (t2 - t1) * 1e3,
                         "label_plain_ms": (t3 - t2) * 1e3, "rects_plain_ms": (t4 - t3) * 1e3})
            phase(f"  {name}: {n} components; label_components {held[-1]['label_ms']:.2f} ms (plain "
                  f"{held[-1]['label_plain_ms']:.1f}), component_min_area_rects {held[-1]['rects_ms']:.2f} ms (plain "
                  f"{held[-1]['rects_plain_ms']:.1f}); bit-equal to the plain versions (8- and 4-connected) and "
                  f"to the cold build (the Pillow-blocked child runs beside)")
        out["held"] = held
        try:
            child.wait(timeout=300)
        except subprocess.TimeoutExpired:
            raise AssertionError("the Pillow-blocked child did not end within 300 s") from None
        child_s = time.perf_counter() - t_child
        child_log.seek(0)
        child_out = child_log.read()
        child_log.close()
        if child.returncode != 0:
            raise AssertionError(f"the Pillow-blocked child failed:\n{child_out[-4000:]}")

        # the representer's quad mode through both routes, on phase 12's maps
        # and on synthetic text-line maps; the host half alone on
        # statistics already on the host
        rep = SegDetectorRepresenter(box_thresh=0.3, device=str(dev))
        out["representer"] = {}
        map_sets = (("phase 12's maps", lines.float()),
                    ("text-line maps", torch.from_numpy(text_line_maps(np.random.default_rng(191), 2, 1536)).to(dev)))
        for set_name, pred in map_sets:
            h, w = pred.shape[-2:]
            stats = [ComponentStats(*(t.cpu() for t in db_device_decode(pred[i, 0], rep.thresh, rep.capacity)))
                     for i in range(pred.shape[0])]
            routes = {}
            for route in ("library", "numpy"):
                saved = native.get_native
                if route == "numpy":
                    native.get_native = lambda: None
                try:
                    t0 = time.perf_counter()
                    host = [boxes_from_stats(st, w, h, w, h) for st in stats]
                    host_ms = (time.perf_counter() - t0) * 1e3 / len(stats)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    boxes, scores = rep(None, pred)
                    call_ms = (time.perf_counter() - t0) * 1e3 / len(stats)
                finally:
                    native.get_native = saved
                # the host half and the whole call are two runs of the route
                if not all(np.array_equal(x[0], b) and np.array_equal(x[1], c)
                           for x, b, c in zip(host, boxes, scores)):
                    raise AssertionError(f"the representer's {route} route on {set_name}: two runs differ")
                routes[route] = {"boxes": boxes, "scores": scores, "host_ms_per_page": host_ms,
                                 "call_ms_per_page": call_ms, "per_page": [len(b) for b in boxes]}
                phase(f"  representer quad mode on {set_name}, {route} route: {routes[route]['per_page']} a page; "
                      f"host half {host_ms:.2f} ms a page, whole call {call_ms:.2f} ms a page; two runs "
                      f"bit-identical; {smi}")
            again = rep(None, pred)
            if not all(np.array_equal(a, b) and np.array_equal(c, d) for a, b, c, d in
                       zip(again[0], routes["library"]["boxes"], again[1], routes["library"]["scores"])):
                raise AssertionError(f"the representer's library route on {set_name}: a third run differs")
            lib_r, np_r = routes["library"], routes["numpy"]
            gap, ties, tie_gap = 0, 0, 0
            for i in range(len(stats)):
                if len(lib_r["boxes"][i]) != len(np_r["boxes"][i]):
                    raise AssertionError(f"{set_name}, page {i}: {len(lib_r['boxes'][i])} quads on the library "
                                         f"route, {len(np_r['boxes'][i])} on the NumPy route")
                if not np.array_equal(lib_r["scores"][i], np_r["scores"][i]):
                    raise AssertionError(f"{set_name}, page {i}: the routes' scores differ")
                if not len(lib_r["boxes"][i]):
                    continue
                far = np.abs(lib_r["boxes"][i].astype(np.int64) - np_r["boxes"][i].astype(np.int64)).reshape(
                    len(lib_r["boxes"][i]), -1).max(axis=1)
                near = far <= 1
                gap = max(gap, int(far[near].max(initial=0)))
                for k in np.nonzero(~near)[0]:
                    lib_area, np_area = route_rect_areas(stats[i], int(k), rep.max_candidates)
                    if abs(lib_area - np_area) > 1e-9 * lib_area:
                        raise AssertionError(f"{set_name}, page {i}, quad {k}: the routes' corners differ by "
                                             f"{far[k]} px and their min-area rects by area ({lib_area!r} against "
                                             f"{np_area!r})")
                    ties += 1
                    tie_gap = max(tie_gap, int(far[k]))
            if sum(lib_r["per_page"]) == 0:
                raise AssertionError(f"the representer found no quad on {set_name}")
            out["representer"][set_name] = {k: {x: v for x, v in r.items() if x not in ("boxes", "scores")}
                                            for k, r in routes.items()}
            out["representer"][set_name].update(corner_gap_px=gap, tied_rects=ties, tied_gap_px=tie_gap)
            phase(f"  routes agree on {set_name}: the same counts, equal scores, corners within {gap} px but on "
                  f"{ties} quads whose min-area rects tie in area (each route keeps the first of two tied "
                  f"orientations it meets: up to {tie_gap} px apart); the library's host half "
                  f"{np_r['host_ms_per_page'] / max(lib_r['host_ms_per_page'], 1e-9):.0f}x faster")

        got = json.loads(child_out.strip().splitlines()[-1])
        losses = list(got["losses"].values())
        if got["pil"] or not got["epoch_finite"] or got["steps"] != 2 or not np.isfinite(losses).all():
            raise AssertionError(f"the Pillow-blocked child: {got}")
        got["seconds"] = child_s
        out["pillow_blocked"] = got
        phase(f"  Pillow blocked: a DB dataset epoch at 512 with rotate 1.0 ({got['epoch_batches']} batches, finite), "
              f"then db_trainer.train with the default DB hyp (imgsz {got['imgsz']}, batch {got['batch_size']}, "
              f"rotate {got['rotate']}): {got['steps']} steps, loss {got['losses']['loss']:.5f}; "
              f"{child_s:.1f} s in a child interpreter")
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(work, ignore_errors=True)
    return out


def main() -> None:
    t_script = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script runs only on a CUDA device")
    if not os.path.isdir(os.path.join(ROOT, "comic_text_detector_tpu_torch")) or not os.path.exists(WEIGHTS):
        fail("run from a checkout of the repository: the port package or data/flagship_r2.npz is missing")
    import numpy as np

    from comic_text_detector_tpu_torch.ops import cc_kernels as K
    from comic_text_detector_tpu_torch.ops import cuda_build
    from comic_text_detector_tpu_torch.ops import finalize as K6
    from comic_text_detector_tpu_torch.ops import morph as K5
    from comic_text_detector_tpu_torch.ops import scan_kernels as K4

    phase("1/19 device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    phase("2/19 build kernels (nvcc, one per source, in parallel)")
    t0 = time.perf_counter()
    build_s = cuda_build.build_all()
    phase(f"build time {time.perf_counter() - t0:.1f} s (" + ", ".join(f"{k} {v:.1f} s" for k, v in build_s.items())
          + ")")
    from comic_text_detector_tpu_torch import native

    native.get_native()  # built here, so that the representer's timings below leave its build out
    phase(f"  host library (csrc/ctdnative.cpp, c++): {native.build_seconds:.1f} s")

    phase("3/19 kernels vs plain versions, bit for bit")
    from comic_text_detector_tpu_torch.ops import refine as R
    rng = np.random.default_rng(0)
    blob = np.zeros((1024, 1024), np.uint8)
    blob[80:960, 120:900] = 1
    blob[rng.random(blob.shape) < 0.08] = 0
    cases = [
        ("noise 64x128", (rng.random((2, 64, 128)) < 0.45).astype(np.uint8)),
        ("serpentine 256x256", serpentine(256)[None]),
        ("noise 45% 1024x1024", (rng.random((1, 1024, 1024)) < 0.45).astype(np.uint8)),
        ("blob 8% holes 1024x1024", blob[None]),
    ]

    def hold(name: str, m_np) -> dict:
        """Kernel vs plain version on one input; returns the max abs errors."""
        m = torch.from_numpy(m_np).to(dev)
        seeds = torch.from_numpy(
            np.where(m_np > 0, rng.integers(0, 1 << 20, m_np.shape), K.CC_BIG).astype(np.int32)
        ).to(dev)
        pairs = [
            ("K2", K.cc_windows_local(m), K.cc_windows_local_plain(m)),
            ("K3", K.min_prop_windows_local(m, seeds), K.min_prop_windows_local_plain(m, seeds)),
            ("ids", K.cc_ids_windows_local(m), K.cc_ids_windows_local_plain(m)),
        ]
        torch.cuda.synchronize()
        errs = {}
        for kname, got, ref in pairs:
            errs[kname] = int((got.long() - ref.long()).abs().max())
            if errs[kname] != 0:
                bad = int((got != ref).sum())
                raise AssertionError(f"{kname} differs from its plain version on {name}: {bad} pixels")
        phase(f"  {name}: K2, K3, ids bit-equal")
        return errs

    for name, m_np in cases:
        hold(name, m_np)

    def hold_k1(name: str, m: torch.Tensor) -> int:
        """K1 vs its plain version on one (N, h, w) stack; returns the max
        abs error (0, or it raises)."""
        got, ref = K.cc_ids_fused(m), K.cc_ids_windows_local_plain(m)
        torch.cuda.synchronize()
        err = int((got.long() - ref.long()).abs().max())
        if err != 0:
            raise AssertionError(f"K1 differs from its plain version on {name}: {int((got != ref).sum())} pixels")
        return err

    k1_glyph_stacks = {}  # timed in phase 4
    for bh, bw, slots, _cap in R.BUCKETS:
        glyph = (synthetic_page(rng, bh, bw, colour=False)[..., 0] < 128).astype(np.uint8)
        k1_glyph_stacks[(bh, bw)] = torch.from_numpy(np.repeat(glyph[None], 4 * slots, 0)).to(dev)
        serp = np.zeros((bh, bw), np.uint8)
        side = min(bh, bw)
        serp[:side, :side] = serpentine(side)
        kinds = {
            "glyph": glyph, "serpentine": serp, "noise 45%": (rng.random((bh, bw)) < 0.45).astype(np.uint8),
            "all-zero": np.zeros((bh, bw), np.uint8), "all-one": np.ones((bh, bw), np.uint8),
        }
        for kind, win in kinds.items():
            hold_k1(f"{kind} {4 * slots}x{bh}x{bw}", torch.from_numpy(np.repeat(win[None], 4 * slots, 0)).to(dev))
        mixed = np.stack([list(kinds.values())[i % 5] for i in range(4 * slots)])
        hold_k1(f"mixed {4 * slots}x{bh}x{bw}", torch.from_numpy(mixed).to(dev))
        phase(f"  K1 bit-equal at {4 * slots}x{bh}x{bw}: glyph, serpentine, noise 45%, all-zero, all-one, mixed")

    border_errs = check_tile_borders(dev, [(bh, bw, 4 * slots) for bh, bw, slots, _cap in R.BUCKETS])
    k2_seam_err = check_k2_seams(dev)

    k6_seam_errs = check_k6_seams(dev)
    phase(f"  K6 mask_to_u8 and binarize bit-equal on {k6_seam_errs['cases']} seam cases: edge values, planes of 1, "
          "15, 16, 17, 4095 and 4097 elements, B = 1 and 5, page strides and bases that break 16-byte alignment")

    phase("4/19 single-page paths: TextDetector at 1024, flagship_r2 weights, host and device refine")
    from comic_text_detector_tpu_torch.ops.db_decode import db_decode_full_device
    from comic_text_detector_tpu_torch.ops.nms import nms_single
    from comic_text_detector_tpu_torch.ops.resize import letterbox_device_u8, letterbox_shape, resize_cv2exact_u8
    from comic_text_detector_tpu_torch.pipeline import TextDetector
    from comic_text_detector_tpu_torch.pipeline.detector import run_net

    det = TextDetector(WEIGHTS, input_size=1024)
    pages = [
        synthetic_page(rng, 1400, 1000, colour=False),
        synthetic_page(rng, 1100, 1600, colour=True),
        synthetic_page(rng, 1400, 1000, colour=True),
    ]
    counters = {"K1": K.cc_ids_fused, "K2": K.cc_windows_local, "K3": K.min_prop_windows_local,
                "K6 mask_to_u8": K6.mask_to_u8, "K6 binarize": K6.binarize,
                "K4 row": K4.cc_row_sweep, "K4 col": K4.cc_col_sweep, "K5 erode": K5.erode3x3,
                "K5 dilate": K5.dilate3x3, "K5 cross": K5.erode3x3_ellipse}
    path_1024 = ["K1", "K2", "K3", "K6 mask_to_u8", "K6 binarize"]

    def drive(run, names):
        """Run a path with every launch count set to 0 just before and read
        just after; fail if a kernel in ``names`` was not launched."""
        for fn in counters.values():
            fn.launches = 0
        out = run()
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in counters.items()}
        for kname in names:
            if counts[kname] <= 0:
                raise AssertionError(f"{kname} was not launched on the path")
        return out, counts

    results, launches = drive(lambda: [det(p) for p in pages], ["K2", "K3", "K6 mask_to_u8", "K6 binarize"])
    phase(f"  launches on the host-refine path: {launches}")
    for p, (mask, refined, blks) in zip(pages, results):
        if mask.shape != p.shape[:2] or refined.shape != p.shape[:2] or mask.dtype != np.uint8:
            raise AssertionError(f"mask shapes {mask.shape} {refined.shape} for page {p.shape}")
        n_lines = sum(len(b.lines) for b in blks)
        phase(f"  page {p.shape}: {len(blks)} blocks, {n_lines} lines, mask>30 {(mask > 30).mean():.4f}")

    phase("  device refine, packed masks")
    det_dev = TextDetector(WEIGHTS, input_size=1024, refine_backend="device", mask_transfer="packed")
    results_dev, launches_dev = drive(lambda: [det_dev(p) for p in pages], path_1024)
    phase(f"  launches on the device-refine path: {launches_dev}")
    for p, (mask, refined, blks) in zip(pages, results_dev):
        if mask.shape != p.shape[:2] or refined.shape != p.shape[:2] or mask.dtype != np.uint8:
            raise AssertionError(f"mask shapes {mask.shape} {refined.shape} for page {p.shape}")
        if not set(np.unique(mask)) <= {0, 255} or not set(np.unique(refined)) <= {0, 255}:
            raise AssertionError("packed-mode masks are not 0/255")
        phase(f"  page {p.shape}: {len(blks)} blocks, mask>30 {(mask > 30).mean():.4f}, "
              f"refined {(refined > 0).mean():.4f}")

    # the path's own DB bitmap
    with torch.no_grad():
        lb = letterbox_device_u8(torch.from_numpy(pages[0]).to(dev), 1024)
        x = lb.permute(2, 0, 1)[None].float() / 255.0
        blks_t, mask_t, lines_t = det.model(x)
    for t in (blks_t, mask_t, lines_t):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("non-finite net output")
    if tuple(mask_t.shape) != (1, 1, 1024, 1024) or tuple(lines_t.shape) != (1, 2, 1024, 1024):
        raise AssertionError(f"net output shapes {tuple(mask_t.shape)} {tuple(lines_t.shape)}")
    bitmap = (lines_t[0, 0] > det.db_thresh).to(torch.uint8)[None].contiguous()
    ids = K.cc_ids_windows_local(bitmap)
    n_comp = int(ids.max())
    phase(f"  DB bitmap: {int(bitmap.sum())} fg pixels, {n_comp} components")
    db_errs = hold("DB bitmap of page 0", bitmap.cpu().numpy())

    seeds = torch.where(ids > 0, ids, K.CC_BIG).to(torch.int32)
    out = torch.empty_like(seeds)
    parent = torch.empty_like(seeds)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    k2_ms = cuda_ms(lambda: K.launch_cc_window(bitmap, out, err), 50)
    k3_ms = cuda_ms(lambda: K.launch_min_prop_window(bitmap, seeds, parent, out, err), 50)
    if int(err.item()):
        raise AssertionError("a union-find loop bound was hit while timing")
    k2_plain = cuda_ms(lambda: K.cc_windows_local_plain(bitmap), 5)
    k3_plain = cuda_ms(lambda: K.min_prop_windows_local_plain(bitmap, seeds), 5)

    # page 0's own candidate stack: the first dispatch of its device refine
    from comic_text_detector_tpu_torch.utils.imgproc import expand_textwindow

    *_, img0, mask0 = det_dev._device_step(pages[0])
    blks0 = results_dev[0][2]
    windows = np.asarray([expand_textwindow(pages[0].shape, b.xyxy, expand_r=16) for b in blks0]).reshape(-1, 4)
    if not len(windows):
        raise AssertionError("page 0 has no text block to refine")
    buckets = [R._bucket_index(int(x2 - x1), int(y2 - y1)) for x1, y1, x2, y2 in windows]
    bi = buckets[0]
    bh, bw, slots, cap = R.BUCKETS[bi]
    sel = [j for j, b in enumerate(buckets) if b == bi][:slots]
    padded = np.zeros((slots, 4), np.int32)
    padded[:, 2:] = 1
    padded[: len(sel)] = windows[sel]
    with torch.no_grad():
        win_img, win_msk, in_win = R.extract_windows(img0, mask0, padded, None, (bh, bw))
        cands, _ = R._candidates(win_img, win_msk, in_win)
        stack = R._drop_tiny_components((cands > 0).reshape(4 * slots, bh, bw)).to(torch.uint8).contiguous()
    k1_err = hold_k1(f"page 0 candidate stack {tuple(stack.shape)}", stack)

    def k1_launcher(m):
        n, h, w = m.shape
        out = torch.empty(m.shape, dtype=torch.int32, device=dev)
        parent = torch.empty(m.shape, dtype=torch.int32, device=dev)
        counts = torch.empty((n, K.ids_chunk_count(h, w)), dtype=torch.int32, device=dev)
        return out, lambda: K.launch_cc_ids_window(m, parent, counts, out, err)

    def time_k1(m, iters=50):
        """K1's time on one (N, h, w) stack, by raw launches."""
        out, launch = k1_launcher(m)
        ms = cuda_ms(launch, iters)
        if int(err.item()):
            raise AssertionError("a union-find loop bound was hit while timing K1")
        return ms, int(out.max())

    k1_ms, k1_max_id = time_k1(stack)
    k1_phases = kernel_phase_ms(k1_launcher(stack)[1])
    phase("  K1 on page 0's candidates by kernel (ms a launch): "
          + ", ".join(f"{k} {v:.4f}" for k, v in k1_phases.items()))
    k1_plain = cuda_ms(lambda: K.cc_ids_windows_local_plain(stack), 5)
    k1_bytes = stack.numel() * (1 + 4)  # mask in, ids out
    phase(f"  K1 on page 0's candidates {tuple(stack.shape)} ({len(sel)} windows of bucket {bh}x{bw}): "
          f"{k1_ms:.4f} ms, plain {k1_plain:.2f} ms, bound {k1_bytes / H100_BYTES_PER_S * 1e3:.5f} ms, "
          f"{k1_max_id} max id")
    # every refine bucket at its dispatch size (4 x slots windows), on a glyph window
    k1_buckets = {}
    for (gh, gw), m in k1_glyph_stacks.items():
        k1_buckets[f"{m.shape[0]}x{gh}x{gw}"] = {
            "ms": time_k1(m)[0], "plain_ms": cuda_ms(lambda: K.cc_ids_windows_local_plain(m), 3),
            "bound_ms": m.numel() * 5 / H100_BYTES_PER_S * 1e3,
        }
    phase("  K1 by bucket, glyph windows (ms): " + ", ".join(
        f"{k} {v['ms']:.4f} (plain {v['plain_ms']:.2f}, bound {v['bound_ms']:.5f})" for k, v in k1_buckets.items()))

    page_ms = page_time_of(det, pages)
    page_ms_dev = page_time_of(det_dev, pages)
    step_ms = cuda_ms(lambda: det._device_step(pages[0]), 5)
    refine_ms = cuda_ms(lambda: R.refine_page(img0, mask0, windows, 0), 5)
    # each stage of that dispatch alone (the steps of ops/refine.py::_refine_windows)
    with torch.no_grad():
        pred = (R._erode_ellipse3(torch.where(in_win, win_msk, 255)) > 60) & in_win
        fgs = stack.bool()
        ids_all = R._component_ids(fgs)
        merged = R._merge_labeled(torch.zeros_like(pred), fgs[:slots], ids_all[:slots], pred, cap=cap)
        canvas0 = torch.zeros((1, img0.shape[0] + bh, img0.shape[1] + bw), dtype=torch.uint8, device=dev)
        valid0 = np.arange(slots) < len(sel)
        refine_stages = {
            "extract": cuda_ms(lambda: R.extract_windows(img0, mask0, padded, None, (bh, bw)), 5),
            "candidates": cuda_ms(lambda: R._candidates(win_img, win_msk, in_win), 5),
            "drop_tiny": cuda_ms(lambda: R._drop_tiny_components((cands > 0).reshape(4 * slots, bh, bw)), 5),
            "cc_ids_candidates": cuda_ms(lambda: R._component_ids(fgs), 5),
            "merge_x4": cuda_ms(lambda: [R._merge_labeled(merged, fgs[:slots], ids_all[:slots], pred, cap=cap)
                                         for _ in range(4)], 5),
            "fill_holes": cuda_ms(lambda: R._fill_holes(merged, pred, in_win, cap=cap), 5),
            "paste": cuda_ms(lambda: R.paste_windows_exact(canvas0, merged.to(torch.uint8) * 255, padded, valid0,
                                                           np.zeros(slots, np.int64)), 5),
        }
    phase("  device refine dispatch by stage (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in refine_stages.items()))
    phase(f"  host refine {page_ms:.1f} ms/page, device refine + packed {page_ms_dev:.1f} ms/page end to end; "
          f"{step_ms:.1f} ms device step, {refine_ms:.1f} ms device refine of page 0 "
          f"({len(windows)} windows, page {pages[0].shape})")

    # each stage of the device step alone, on page 0's tensors
    img_dev = torch.from_numpy(pages[0]).to(dev)
    h0, w0 = pages[0].shape[:2]
    _, _, dw0, dh0, _ = letterbox_shape(h0, w0, 1024)
    mask_u8 = (mask_t[0, 0] * 255.0).to(torch.uint8)
    with torch.no_grad():
        stages = {
            "upload": cuda_ms(lambda: torch.from_numpy(pages[0]).to(dev), 5),
            "letterbox": cuda_ms(lambda: letterbox_device_u8(img_dev, 1024), 5),
            "net": cuda_ms(lambda: det.model(x), 5),  # cuDNN's default algorithms
            "net_deterministic": cuda_ms(lambda: run_net(det.model, lb[None]), 5),  # as the pipelines run it
            "nms": cuda_ms(lambda: nms_single(blks_t[0], det.conf_thresh, det.nms_thresh), 5),
            "mask_unletterbox": cuda_ms(
                lambda: resize_cv2exact_u8(mask_u8[: 1024 - dh0, : 1024 - dw0], (h0, w0)), 5),
            "db_decode": cuda_ms(lambda: db_decode_full_device(lines_t[0, 0], det.db_thresh), 5),
        }
    phase("  device step by stage (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))

    phase("5/19 output check: card vs the port's CPU route")
    canvas_gpu = R.refine_page(img0, mask0, windows, 0).cpu()
    canvas_cpu = R.refine_page(img0.cpu(), mask0.cpu(), windows, 0)
    if not torch.equal(canvas_gpu, canvas_cpu):
        raise AssertionError(f"refine_page differs between card and CPU on {int((canvas_gpu != canvas_cpu).sum())} px")
    phase(f"  refine_page of page 0 bit-equal on card and CPU ({int(canvas_cpu.count_nonzero())} px set)")

    small = synthetic_page(np.random.default_rng(7), 560, 720, colour=False)
    det_gpu = TextDetector(WEIGHTS, input_size=512)
    det_cpu = TextDetector(WEIGHTS, input_size=512, device="cpu")
    mg, rg, bg = det_gpu(small.copy())
    mc, rc, bc = det_cpu(small.copy())
    mdiff = int(np.abs(mg.astype(np.int16) - mc).max())
    if mdiff > 1:
        raise AssertionError(f"grey mask differs by {mdiff} levels between card and CPU")
    if len(bg) != len(bc) or not bc:
        raise AssertionError(f"{len(bg)} blocks on the card, {len(bc)} on the CPU")
    for a, b in zip(bg, bc):
        la, lb_ = np.asarray(a.lines), np.asarray(b.lines)
        if np.abs(np.asarray(a.xyxy) - np.asarray(b.xyxy)).max() > 1 or la.shape != lb_.shape:
            raise AssertionError(f"block {a.xyxy} ({len(a.lines)} lines) vs {b.xyxy} ({len(b.lines)} lines)")
        if la.size and np.abs(la - lb_).max() > 1:
            raise AssertionError(f"line quads of block {a.xyxy} differ by more than 1 px")
    iou = np.logical_and(rg > 0, rc > 0).sum() / max(np.logical_or(rg > 0, rc > 0).sum(), 1)
    if iou < 0.99:
        raise AssertionError(f"refined mask IoU {iou:.4f} between card and CPU")
    phase(f"  card and CPU agree: {len(bg)} blocks, mask within {mdiff} level, refined IoU {iou:.4f}")

    kw = dict(input_size=512, refine_backend="device")
    mg, rg, bg = TextDetector(WEIGHTS, **kw)(small.copy())
    mc, rc, bc = TextDetector(WEIGHTS, device="cpu", **kw)(small.copy())
    if len(bg) != len(bc) or np.abs(mg.astype(np.int16) - mc).max() > 1:
        raise AssertionError(f"device refine at 512: {len(bg)} vs {len(bc)} blocks or grey masks apart")
    iou_dev = np.logical_and(rg > 0, rc > 0).sum() / max(np.logical_or(rg > 0, rc > 0).sum(), 1)
    if iou_dev < 0.99:
        raise AssertionError(f"device-refined mask IoU {iou_dev:.4f} between card and CPU")
    phase(f"  device refine at 512, card and CPU agree: {len(bg)} blocks, refined IoU {iou_dev:.4f}")

    phase("6/19 main path: BatchTextDetector.stream, bf16, batch 4, input 1024, device refine, packed masks")
    from comic_text_detector_tpu_torch.ops.db_decode import db_decode_batch
    from comic_text_detector_tpu_torch.pipeline import BatchTextDetector
    from comic_text_detector_tpu_torch.weights import load_npz

    variables = load_npz(WEIGHTS)
    bkw = dict(batch_size=4, input_size=1024, refine_backend="device", mask_transfer="packed")
    bdet = BatchTextDetector(variables, half=True, **bkw)
    shapes = [(1400, 1000), (1500, 1060), (1056, 1500)]
    srng = np.random.default_rng(11)
    warm = [synthetic_page(srng, *shapes[i % 3], colour=i % 2 == 1) for i in range(4)]
    spages = [synthetic_page(srng, *shapes[i % 3], colour=i % 2 == 0) for i in range(12)]
    list(bdet.stream(iter(warm)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out16, launches_b = drive(lambda: list(bdet.stream(iter(spages))), path_1024)
    stream_s = time.perf_counter() - t0
    per_page_b = {k: v / len(spages) for k, v in launches_b.items()}
    if len(out16) != len(spages):
        raise AssertionError(f"the stream returned {len(out16)} results for {len(spages)} pages")
    for p, (mask, refined, blks) in zip(spages, out16):
        if mask.shape != p.shape[:2] or refined.shape != p.shape[:2] or mask.dtype != np.uint8:
            raise AssertionError(f"batch mask shapes {mask.shape} {refined.shape} for page {p.shape}")
        if not set(np.unique(mask)) <= {0, 255} or not set(np.unique(refined)) <= {0, 255}:
            raise AssertionError("batch packed-mode masks are not 0/255")
    n_blocks = [len(b) for _, _, b in out16]
    if sum(n_blocks) == 0:
        raise AssertionError("the batch stream found no text block on 12 pages")
    phase(f"  bf16 stream: {len(spages) / stream_s:.3f} pages/s, {stream_s * 1e3 / len(spages):.2f} ms/page; "
          f"blocks per page {n_blocks}")
    phase(f"  launches per page: {per_page_b}")

    # device busy time of the same stream (CUPTI kernel times, one stream),
    # against the unprofiled wall time above
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        list(bdet.stream(iter(spages)))
        torch.cuda.synchronize()
    kernel_us = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(us for us, _, _ in kernel_us) / 1e3
    idle = 1.0 - busy_ms / (stream_s * 1e3) if busy_ms > 0 else None
    top_kernels = [(k[:60], n, round(us / 1e3, 3)) for us, n, k in kernel_us[:8]]
    phase(f"  device busy {busy_ms / len(spages):.2f} ms/page of {stream_s * 1e3 / len(spages):.2f}: idle share "
          f"{'not measured (no device time in the trace)' if idle is None else f'{idle:.3f}'}; "
          f"top kernels (name, launches, ms): {top_kernels}")

    phase("7/19 determinism: the same 12 pages streamed again, one single-page call repeated")
    out16b = list(bdet.stream(iter(spages)))
    diff = [i for i, (x, y) in enumerate(zip(out16, out16b)) if not same_outputs(x, y)]
    if diff:
        raise AssertionError(f"repeat stream differs on pages {diff}")
    det16 = TextDetector(WEIGHTS, input_size=1024, half=True, refine_backend="device", mask_transfer="packed")
    single = [det16(spages[0]) for _ in range(2)]
    if not same_outputs(*single):
        raise AssertionError("repeated single-page call differs")
    with torch.no_grad():
        lbs = torch.stack([letterbox_device_u8(torch.from_numpy(p).to(dev), 1024) for p in spages[:4]])
        blks_b, mask_b, lines_b = run_net(bdet.model, lbs)
        shrink0 = lines_b[:, 0]  # the stream's own view of the DB maps, read in place
        dec = [db_decode_batch(shrink0, 0.3) for _ in range(3)]
    torch.cuda.synchronize()
    for d in dec[1:]:
        if not all(torch.equal(a, b) for a, b in zip(d, dec[0])):
            raise AssertionError("db_decode_batch differs between repeated calls on one stack")
    phase(f"  bit-identical: 12 streamed pages x 2, single page x 2, DB decode of a 4-page stack x 3 "
          f"({int(dec[0][2].sum())} boxes)")

    phase("8/19 bf16 vs f32, batch vs single page, error propagation")
    bdet32 = BatchTextDetector(variables, half=False, **bkw)
    list(bdet32.stream(iter(warm)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out32 = list(bdet32.stream(iter(spages)))
    stream32_s = time.perf_counter() - t0
    ious16 = [mask_iou(a[0], b[0]) for a, b in zip(out16, out32)]
    phase(f"  f32 stream: {len(spages) / stream32_s:.3f} pages/s, {stream32_s * 1e3 / len(spages):.2f} ms/page; "
          f"bf16 vs f32 mask IoU per page {[round(v, 4) for v in ious16]}")
    if min(ious16[:4]) < 0.98:
        raise AssertionError(f"bf16 vs f32 mask IoU {min(ious16[:4]):.4f} < 0.98 on the first 4 pages")
    single16 = [det16(p) for p in spages[:4]]
    single32 = [det_dev(p) for p in spages[:4]]
    bdet1 = BatchTextDetector(variables, half=True, **dict(bkw, batch_size=1))
    out1 = list(bdet1.stream(iter(spages[:4])))
    same1 = [same_outputs(a, b) for a, b in zip(out1, single16)]
    with torch.no_grad():
        one = torch.cat([run_net(bdet.model, lbs[i:i + 1])[1] for i in range(4)])
        net_gap = float((one - mask_b).abs().max())
    diag = {}
    for name, outs, singles in (("bf16", out16, single16), ("f32", out32, single32)):
        diag[name] = {
            "blocks": [(len(b[2]), len(s_[2])) for b, s_ in zip(outs, singles)],
            "mask_iou": [round(mask_iou(b[0], s_[0]), 4) for b, s_ in zip(outs, singles)],
            "refined_iou": [round(mask_iou(b[1], s_[1]), 4) for b, s_ in zip(outs, singles)],
        }
    phase(f"  batch vs single page: {diag}; batch_size=1 stream == TextDetector: {same1}; "
          f"bf16 mask gap batch 4 vs batch 1 net: {net_gap:.4g}")
    # The batch of 1 runs the single page's computation and must match it
    # bit for bit.  A batch of 4 runs the net at another shape: in float32
    # that leaves the outputs unchanged (refined IoU >= 0.99, the card-vs-CPU
    # rule of phase 5), but bf16 convolutions round differently at another
    # batch size (the mask moves by up to a few hundredths), so in bf16 the
    # batch of 4 is held to the JAX package's bf16 budget, IoU >= 0.98.
    if not all(same1):
        raise AssertionError(f"the batch_size=1 stream differs from TextDetector: {same1}")
    for name, floor in (("f32", 0.99), ("bf16", 0.98)):
        if any(b != s_ for b, s_ in diag[name]["blocks"]):
            raise AssertionError(f"{name}: batch and single-page block counts differ: {diag[name]['blocks']}")
        if min(diag[name]["refined_iou"]) < floor:
            raise AssertionError(f"{name}: batch vs single-page refined IoU {min(diag[name]['refined_iou'])} < {floor}")

    def bad_source():
        yield spages[0]
        yield spages[1]
        raise RuntimeError("page source failed")

    try:
        list(bdet.stream(bad_source()))
    except RuntimeError as e:
        if "page source failed" not in str(e):
            raise
    else:
        raise AssertionError("a source error did not reach the consumer")
    phase("  a source error raised mid-stream reached the consumer")

    # the kernels at the batch path's own shapes: K6 on the batch's mask
    # stack and DB maps (the stream's view lines_b[:, 0] among them), K2 and
    # K3 on its DB bitmap stack
    mask_stack = mask_b[:, 0].contiguous()
    k6 = {"1024": time_k6(mask_stack, lines_b, 0.3, smi)}
    bitmaps = K6.binarize(lines_b[:, 0], 0.3)
    db_errs_b = hold("DB bitmap stack of the batch", bitmaps.cpu().numpy())
    ids_b = K.cc_ids_windows_local(bitmaps)
    seeds_b = torch.where(ids_b > 0, ids_b, K.CC_BIG).to(torch.int32)
    out_b, parent_b = torch.empty_like(seeds_b), torch.empty_like(seeds_b)
    # the split route's own seeds: each root's raster rank, 2**30 elsewhere
    lin_b = torch.arange(bitmaps.shape[1] * bitmaps.shape[2], dtype=torch.int32, device=dev).view(1, *bitmaps.shape[1:])
    roots_b = (K.cc_windows_local(bitmaps) == lin_b) & (bitmaps != 0)
    rank_b = torch.cumsum(roots_b.view(roots_b.shape[0], -1), dim=1, dtype=torch.int32).view(roots_b.shape)
    split_seeds_b = torch.where(roots_b, rank_b, K.CC_BIG).to(torch.int32)
    if not torch.equal(K.min_prop_windows_local(bitmaps, split_seeds_b),
                       K.min_prop_windows_local_plain(bitmaps, split_seeds_b)):
        raise AssertionError("K3 differs from its plain version on the split route's seeds")
    k2b_ms = cuda_ms(lambda: K.launch_cc_window(bitmaps, out_b, err), 50)
    k3b_ms = cuda_ms(lambda: K.launch_min_prop_window(bitmaps, seeds_b, parent_b, out_b, err), 50)
    k3s_ms = cuda_ms(lambda: K.launch_min_prop_window(bitmaps, split_seeds_b, parent_b, out_b, err), 50)
    if int(err.item()):
        raise AssertionError("a union-find loop bound was hit while timing the batch's bitmap")
    k3_phases = kernel_phase_ms(lambda: K.launch_min_prop_window(bitmaps, seeds_b, parent_b, out_b, err))
    phase("  K3 on the batch's DB bitmaps by kernel (ms a launch): "
          + ", ".join(f"{k} {v:.4f}" for k, v in k3_phases.items()))
    k2b_plain = cuda_ms(lambda: K.cc_windows_local_plain(bitmaps), 3)
    k3b_plain = cuda_ms(lambda: K.min_prop_windows_local_plain(bitmaps, seeds_b), 3)
    pxb = bitmaps.numel()
    phase(f"  K2 / K3 on the batch's DB bitmaps {tuple(bitmaps.shape)}: {k2b_ms:.4f} / {k3b_ms:.4f} ms "
          f"(plain {k2b_plain:.2f} / {k3b_plain:.2f} ms); K3 on the split route's seeds {k3s_ms:.4f} ms; "
          f"bounds {pxb * 5 / H100_BYTES_PER_S * 1e3:.5f} / {pxb * 9 / H100_BYTES_PER_S * 1e3:.5f} ms")
    # K2 from device memory: 4 copies of the bitmaps and outputs (80 MB, over the L2)
    k2_timed = {"1024": time_k2(bitmaps, 4, k2b_plain, smi)}

    def net_any_algo(model, lb_u8):
        x = lb_u8.permute(0, 3, 1, 2).to(torch.float32) / 255.0
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False, allow_tf32=False):
            return model(x)

    # the batch's stages alone, on the first 4 pages' tensors (CUDA events)
    with torch.no_grad():
        batch_stages = {
            "upload_pinned_x4": cuda_ms(lambda: [bdet._upload(p) for p in spages[:4]], 5),
            "letterbox_x4": cuda_ms(lambda: [letterbox_device_u8(torch.from_numpy(p).to(dev), 1024)
                                             for p in spages[:4]], 5),
            "net_bf16_b4": cuda_ms(lambda: run_net(bdet.model, lbs), 5),
            "net_f32_b4": cuda_ms(lambda: run_net(bdet32.model, lbs), 5),
            # the same net without run_net's restriction to deterministic cuDNN algorithms
            "net_f32_b4_any_algo": cuda_ms(lambda: net_any_algo(bdet32.model, lbs), 5),
            "net_bf16_b4_any_algo": cuda_ms(lambda: net_any_algo(bdet.model, lbs), 5),
            "nms_x4": cuda_ms(lambda: [nms_single(b, bdet.conf_thresh, bdet.nms_thresh) for b in blks_b], 5),
            "mask_finalize_k6": cuda_ms(lambda: K6.mask_to_u8(mask_stack), 5),
            "db_decode_b4": cuda_ms(lambda: db_decode_batch(shrink0, 0.3), 5),
            "submit_b4": cuda_ms(lambda: bdet.submit(spages[:4]), 3),
        }
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            bdet.process_batch(spages[:4])
        torch.cuda.synchronize()
        batch_stages["process_batch_b4_host_ms"] = (time.perf_counter() - t0) * 1e3 / reps
    phase("  batch stages (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in batch_stages.items()))

    # ------------------------------------------------------------------
    # input 1536: the DB decode's label route through K4
    # ------------------------------------------------------------------
    from comic_text_detector_tpu_torch.ops import cc as CC
    from comic_text_detector_tpu_torch.ops import db_decode as DB
    from comic_text_detector_tpu_torch.postproc.db_rep import SegDetectorRepresenter

    big = 1536
    hshapes = [(2150, 1500), (2048, 1448), (1500, 2150)]
    hrng = np.random.default_rng(15)
    hwarm = [synthetic_page(hrng, *hshapes[i % 3], colour=i % 2 == 0) for i in range(4)]
    hpages = [synthetic_page(hrng, *hshapes[i % 3], colour=i % 2 == 1) for i in range(8)]
    bdet_big = BatchTextDetector(variables, half=True, **dict(bkw, input_size=big))
    with torch.no_grad():
        lbs_big = torch.stack([letterbox_device_u8(torch.from_numpy(p).to(dev), big) for p in hpages[:4]])
        _, mask_big, lines_big = run_net(bdet_big.model, lbs_big)
        shrink_big = lines_big[:, 0]  # the stream's own view of the DB maps, read in place
    bitmaps_big = K6.binarize(shrink_big, bdet_big.db_thresh)
    if tuple(lines_big.shape) != (4, 2, big, big) or not bool(torch.isfinite(lines_big).all()):
        raise AssertionError(f"net DB maps at {big}: {tuple(lines_big.shape)}, finite {bool(torch.isfinite(lines_big).all())}")

    phase("9/19 K4 vs its plain version, bit for bit; connected_components on the K4, K2 and plain routes")
    noise = torch.from_numpy((np.random.default_rng(16).random((big, big)) < 0.45).astype(np.uint8))
    odd = np.zeros((1037, 1531), np.uint8)
    odd[::3] = 1
    odd[np.random.default_rng(17).random(odd.shape) < 0.3] = 1
    k4_cases = {
        "DB bitmap of the 1536 path, page 0": bitmaps_big[0].cpu(),
        "serpentine": torch.from_numpy(serpentine(big)),
        "noise 45%": noise,
        "all-zero": torch.zeros((big, big), dtype=torch.uint8),
        "all-one": torch.ones((big, big), dtype=torch.uint8),
        "odd shape": torch.from_numpy(odd),
        "the batch's DB bitmap stack": bitmaps_big.cpu(),
    }
    k4_err = check_k4(dev, k4_cases)
    k4c_err = check_k4_columns(dev)
    k4r_err = check_k4_rows(dev)
    # 4-connected maps through "auto": K4 where its rows take the width, the
    # plain route where they are wider
    for shape, k4_expected in (((2, 64, 4096), True), ((2, 64, 5000), False)):
        m4 = torch.from_numpy((np.random.default_rng(25).random(shape) < 0.55).astype(np.uint8)).to(dev)
        before = K4.cc_row_sweep.launches
        got4 = CC.connected_components(m4, 4)
        launched = K4.cc_row_sweep.launches > before
        same = torch.equal(got4, CC.connected_components(m4, 4, "xla"))
        if not same or launched != k4_expected:
            raise AssertionError(f"connected_components(connectivity=4) through auto on {shape}: K4 launched "
                                 f"{launched}, labels equal to the plain route {same}")
    phase("  connected_components(connectivity=4) through auto equal to the plain route: 2x64x4096 through K4, "
          "2x64x5000 (rows wider than K4's) through the plain route")

    phase("10/19 K5 vs its plain version, bit for bit")
    k5_err = check_k5(dev)

    phase(f"11/19 the path at input {big}: BatchTextDetector.stream, bf16, batch 4, device refine, packed masks")
    list(bdet_big.stream(iter(hwarm)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_big, launches_big = drive(lambda: list(bdet_big.stream(iter(hpages))),
                                  ["K1", "K2", "K6 mask_to_u8", "K6 binarize"])
    big_s = time.perf_counter() - t0
    per_page_big = {k: v / len(hpages) for k, v in launches_big.items()}
    if launches_big["K4 row"] or launches_big["K4 col"]:
        raise AssertionError(f"K4 was launched on the {big} stream: {launches_big}")
    for p, (mask, refined, blks) in zip(hpages, out_big):
        if mask.shape != p.shape[:2] or refined.shape != p.shape[:2] or mask.dtype != np.uint8:
            raise AssertionError(f"mask shapes {mask.shape} {refined.shape} for page {p.shape}")
        if not set(np.unique(mask)) <= {0, 255} or not set(np.unique(refined)) <= {0, 255}:
            raise AssertionError("packed-mode masks are not 0/255")
    blocks_big = [len(b) for _, _, b in out_big]
    lines_per_page = [sum(len(x.lines) for x in b) for _, _, b in out_big]
    if sum(blocks_big) == 0 or sum(lines_per_page) == 0:
        raise AssertionError(f"the {big} stream found no text: blocks {blocks_big}, lines {lines_per_page}")
    phase(f"  bf16 stream at {big}: {len(hpages) / big_s:.3f} pages/s, {big_s * 1e3 / len(hpages):.2f} ms/page; "
          f"blocks per page {blocks_big}, lines per page {lines_per_page}")
    phase(f"  launches per page: {per_page_big}")
    phase(f"  K4 launches on the {big} stream: 0 (the card's connected_components labels 8-connected maps "
          "with K2 at every size; K4 runs for backend='pallas' and 4-connected maps); the kernels line gives "
          "K4's launches from this stream")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        list(bdet_big.stream(iter(hpages)))
        torch.cuda.synchronize()
    kernel_us_big = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                            if e.device_type == DeviceType.CUDA), reverse=True)
    busy_big = sum(us for us, _, _ in kernel_us_big) / 1e3
    idle_big = 1.0 - busy_big / (big_s * 1e3) if busy_big > 0 else None
    top_big = [(k[:60], n, round(us / 1e3, 3)) for us, n, k in kernel_us_big[:8]]
    phase(f"  device busy {busy_big / len(hpages):.2f} ms/page of {big_s * 1e3 / len(hpages):.2f}: idle share "
          f"{'not measured (no device time in the trace)' if idle_big is None else f'{idle_big:.3f}'}; "
          f"top kernels (name, launches, ms): {top_big}")

    out_big2 = list(bdet_big.stream(iter(hpages)))
    diff = [i for i, (x, y) in enumerate(zip(out_big, out_big2)) if not same_outputs(x, y)]
    if diff:
        raise AssertionError(f"repeat stream at {big} differs on pages {diff}")
    single_big = {}
    for name, kw in (("host refine", {}), ("device refine + packed", dict(refine_backend="device",
                                                                           mask_transfer="packed"))):
        det_big = TextDetector(WEIGHTS, input_size=big, **kw)
        res, launches_single = drive(lambda: [det_big(hpages[0]) for _ in range(2)],
                                     ["K2", "K6 mask_to_u8", "K6 binarize"])
        if launches_single["K4 row"] or launches_single["K4 col"]:
            raise AssertionError(f"K4 was launched by TextDetector at {big} ({name}): {launches_single}")
        if not same_outputs(*res):
            (m1, r1, b1), (m2, r2, b2) = res
            raise AssertionError(f"TextDetector at {big} ({name}) differs between two calls: mask "
                                 f"{int((m1 != m2).sum())} px, refined {int((r1 != r2).sum())} px, "
                                 f"{len(b1)} vs {len(b2)} blocks")
        mask, refined, blks = res[0]
        if mask.shape != hpages[0].shape[:2] or not blks:
            raise AssertionError(f"TextDetector at {big} ({name}): mask {mask.shape}, {len(blks)} blocks")
        single_big[name] = {"blocks": len(blks), "lines": sum(len(b.lines) for b in blks),
                            "launches_per_call": {k: v / 2 for k, v in launches_single.items()},
                            "ms_per_page": page_time_of(det_big, hpages[:3])}
        phase(f"  TextDetector at {big}, {name}: {single_big[name]}")

    decoded = {}
    with torch.no_grad():
        for backend in ("pallas", "vmem", "xla"):
            labels = CC.connected_components(bitmaps_big, 8, backend)
            decoded[backend] = [DB._decode_labeled(shrink_big[i], labels[i], 256, 90, 8192, False) for i in range(4)]
        auto = DB.db_decode_batch(shrink_big, bdet_big.db_thresh)
    torch.cuda.synchronize()
    for backend in ("vmem", "xla"):
        for a, b in zip(decoded["pallas"], decoded[backend]):
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"the DB decode at {big} differs between K4 and the {backend} route")
    if not all(torch.equal(torch.stack([d[j] for d in decoded["pallas"]]), auto[j]) for j in range(3)):
        raise AssertionError(f"db_decode_batch at {big} (through K2) differs from its K4 route")
    phase(f"  bit-identical: the {big} stream x 2, each TextDetector call x 2; the batch's DB decode equal "
          f"through K4, K2 and the plain route ({int(auto[2].sum())} boxes)")

    phase("12/19 SegDetectorRepresenter (quad, polygon) on the card vs the port's CPU route; K4 and K5 timings")
    # box_thresh 0.3: the net's line scores on these synthetic scans are about
    # 0.4, under the default 0.7, and polygon mode filters by it
    rep_gpu = SegDetectorRepresenter(box_thresh=0.3, device="cuda")
    rep_cpu = SegDetectorRepresenter(box_thresh=0.3, device="cpu")
    lines_f32 = lines_big.to(torch.float32)
    rep_summary = {}
    for polygon in (False, True):
        t0 = time.perf_counter()
        bg_, sg_ = rep_gpu(None, lines_f32, is_output_polygon=polygon)
        rep_ms = (time.perf_counter() - t0) * 1e3 / 4
        bc_, sc_ = rep_cpu(None, lines_f32.cpu().numpy(), is_output_polygon=polygon)
        for i in range(4):
            if len(bg_[i]) != len(bc_[i]) or any(not np.array_equal(a, b) for a, b in zip(bg_[i], bc_[i])):
                raise AssertionError(f"SegDetectorRepresenter (polygon={polygon}) page {i}: card and CPU differ")
            if len(sg_[i]) and np.abs(np.asarray(sg_[i]) - np.asarray(sc_[i])).max() > 1e-5:
                raise AssertionError(f"SegDetectorRepresenter (polygon={polygon}) page {i}: scores differ by more than 1e-5")
        mode = "polygon" if polygon else "quad"
        if sum(len(b) for b in bg_) == 0:
            raise AssertionError(f"SegDetectorRepresenter ({mode} mode) found nothing on 4 pages")
        rep_summary[mode] = {"per_page": [len(b) for b in bg_], "ms_per_page": rep_ms}
        phase(f"  {mode} mode: {[len(b) for b in bg_]} per page, equal on card and CPU (scores within 1e-5), "
              f"{rep_ms:.1f} ms/page on the card")

    import torch.nn.functional as F

    # K4 per launch at the path's (4, 1536, 1536), on the labels of its second round
    lin = torch.arange(big * big, dtype=torch.int32, device=dev).view(1, big, big)
    lab0 = torch.where(bitmaps_big != 0, lin, K.CC_BIG).contiguous()
    k4_out = torch.empty_like(lab0)
    k4_args = [(lab0.clone(), bitmaps_big.clone(), k4_out) for _ in range(2)]  # 2 x 47 MB: more than the L2
    k4r_ms = cuda_ms_cycle(K4.launch_row_sweep, k4_args, 100)
    k4c_ms = cuda_ms_cycle(K4.launch_col_sweep, k4_args, 100)
    k4r_dev = device_ms(K4.launch_row_sweep, k4_args, only="row_sweep")
    k4c_dev = device_ms(K4.launch_col_sweep, k4_args, only="col_sweep")
    k4r_plain = cuda_ms(lambda: K4.cc_row_sweep_plain(lab0, bitmaps_big), 5)
    k4c_plain = cuda_ms(lambda: K4.cc_col_sweep_plain(lab0, bitmaps_big), 5)
    k4_bytes = bitmaps_big.numel() * (4 + 1 + 4)  # labels and mask in, labels out
    cc_k4_ms = cuda_ms(lambda: CC.connected_components(bitmaps_big, 8, "pallas"), 3)
    k4_rounds = CC.connected_components.rounds
    cc_k2_ms = cuda_ms(lambda: CC.connected_components(bitmaps_big, 8, "vmem"), 3)
    cc_plain_ms = cuda_ms(lambda: CC.connected_components(bitmaps_big, 8, "xla"), 3)
    phase(f"  K4 on {tuple(bitmaps_big.shape)} (2 copies cycled), ms a launch on the card's clock (events over the "
          f"Python loop): row {fmt(k4r_dev)} ({k4r_ms:.4f}), plain {k4r_plain:.3f}; column {fmt(k4c_dev)} "
          f"({k4c_ms:.4f}), plain {k4c_plain:.3f}; bound {k4_bytes / H100_BYTES_PER_S * 1e3:.4f} ms a sweep; library: none; "
          f"events time the host's issue rate; {smi}")
    # the column kernel at input_size 2048: the batch's bitmaps scaled up by
    # nearest neighbour, 2 copies of 4 x 2048 x 2048 cycled (2 x 84 MB)
    s2 = 2048
    bitmaps_2048 = F.interpolate(bitmaps_big[:, None].float(), size=(s2, s2), mode="nearest")[:, 0].to(torch.uint8)
    lin2 = torch.arange(s2 * s2, dtype=torch.int32, device=dev).view(1, s2, s2)
    lab2 = torch.where(bitmaps_2048 != 0, lin2, K.CC_BIG).contiguous()
    k4c_2048_args = [(lab2.clone(), bitmaps_2048.clone(), torch.empty_like(lab2)) for _ in range(2)]
    if not torch.equal(K4.cc_col_sweep(lab2, bitmaps_2048), K4.cc_col_sweep_plain(lab2, bitmaps_2048)):
        raise AssertionError("K4 cc_col_sweep differs from its plain version on the 2048 bitmaps")
    k4c_2048 = {"ms": cuda_ms_cycle(K4.launch_col_sweep, k4c_2048_args, 100),
                "plain_ms": cuda_ms(lambda: K4.cc_col_sweep_plain(lab2, bitmaps_2048), 5),
                "bound_ms": bitmaps_2048.numel() * (4 + 1 + 4) / H100_BYTES_PER_S * 1e3}
    phase(f"  K4 column on {tuple(bitmaps_2048.shape)} (the 1536 bitmaps scaled up): {k4c_2048['ms']:.4f} ms "
          f"(plain {k4c_2048['plain_ms']:.3f}), bound {k4c_2048['bound_ms']:.4f} ms; {smi}")
    if not torch.equal(K4.cc_row_sweep(lab2, bitmaps_2048), K4.cc_row_sweep_plain(lab2, bitmaps_2048)):
        raise AssertionError("K4 cc_row_sweep differs from its plain version on the 2048 bitmaps")
    k4r_2048 = {"device_ms": device_ms(K4.launch_row_sweep, k4c_2048_args, only="row_sweep"),
                "ms": cuda_ms_cycle(K4.launch_row_sweep, k4c_2048_args, 100),
                "plain_ms": cuda_ms(lambda: K4.cc_row_sweep_plain(lab2, bitmaps_2048), 5),
                "bound_ms": k4c_2048["bound_ms"]}
    phase(f"  K4 row on {tuple(bitmaps_2048.shape)} (2 copies cycled): {fmt(k4r_2048['device_ms'])} ms a launch on "
          f"the card's clock ({k4r_2048['ms']:.4f} on events over the Python loop, the host's issue rate), plain "
          f"{k4r_2048['plain_ms']:.3f}, bound {k4r_2048['bound_ms']:.4f} ms; library: none (no PyTorch call takes a "
          f"segmented min-scan); {smi}")
    phase(f"  connected_components on the batch's bitmaps: K4 route {cc_k4_ms:.2f} ms ({k4_rounds} rounds), "
          f"K2 route {cc_k2_ms:.2f} ms, plain {cc_plain_ms:.2f} ms")
    # K2 on the 1536 batch's bitmaps and on the 2048 ones (2 copies each cycled,
    # 2 x 47 MB and 2 x 84 MB); connected_components through "auto", which
    # takes K2 on the card
    cc_auto_ms = {}
    for name, m in (("1536", bitmaps_big), ("2048", bitmaps_2048)):
        if not torch.equal(K.cc_windows_local(m), K.cc_windows_local_plain(m)):
            raise AssertionError(f"K2 differs from its plain version on the {name} bitmaps")
        k2_timed[name] = time_k2(m, 2, cuda_ms(lambda: K.cc_windows_local_plain(m), 3), smi)
        if not torch.equal(CC.connected_components(m, 8), CC.connected_components(m, 8, "xla")):
            raise AssertionError(f"connected_components through auto differs from the plain route on the {name} bitmaps")
        cc_auto_ms[name] = cuda_ms(lambda: CC.connected_components(m, 8), 20)
    phase(f"  connected_components through auto (K2): {cc_auto_ms['1536']:.3f} ms on {tuple(bitmaps_big.shape)}, "
          f"{cc_auto_ms['2048']:.3f} ms on {tuple(bitmaps_2048.shape)}; equal to the plain route; {smi}")

    # K6 at the 1536 batch's shapes, on its mask stack and its own DB maps
    k6["1536"] = time_k6(mask_big[:, 0].contiguous(), lines_big, bdet_big.db_thresh, smi)

    # K5 at 1536 x 1536 (8 copies cycled in both types: the uint8 ones fit in
    # the L2, the float32 ones pass it) and at 4096 x 4096 (uint8 4 copies,
    # 67 MB; float32 2 copies, 268 MB); beside each, out.copy_(x) of the same
    # bytes on the card's clock, the practical floor at that size.  The
    # library forms, timed whole on the card's clock: dilate is F.pad
    # (replicate) then F.max_pool2d, erode the same between two negations;
    # the cross has none
    k5 = {}
    k5_library = {}
    for s5, copies8, copies32 in ((big, 8, 8), (4096, 4, 2)):
        x8 = torch.from_numpy(np.random.default_rng(18).integers(0, 256, (s5, s5), dtype=np.uint8)).to(dev)
        for dtype, x, copies in (("uint8", x8, copies8), ("float32", x8.float(), copies32)):
            xs = [(x.clone(), torch.empty_like(x)) for _ in range(copies)]
            floor = device_ms(lambda a, o: o.copy_(a), xs)
            for op, name in ((0, "erode3x3"), (1, "dilate3x3"), (2, "erode3x3_ellipse")):
                if not torch.equal(getattr(K5, name)(x), getattr(K5, name + "_plain")(x)):
                    raise AssertionError(f"K5 {name} differs from its plain version at {s5}x{s5} {dtype}")
                k5[(name, dtype, s5)] = {
                    "ms": cuda_ms_cycle(lambda a, o, op=op: K5.launch_morph(a, o, op), xs, 200),
                    "device_ms": device_ms(lambda a, o, op=op: K5.launch_morph(a, o, op), xs, only="morph3x3"),
                    "plain_ms": cuda_ms(lambda: getattr(K5, name + "_plain")(x), 20),
                    "bound_ms": x.numel() * x.element_size() * 2 / H100_BYTES_PER_S * 1e3,
                    "copy_floor_device_ms": floor, "copies": copies,
                }
            flip = (lambda t: 255 - t) if dtype == "uint8" else (lambda t: -t)  # min as a max, order reversed
            lib_forms = {
                "dilate3x3": lambda a, *_: F.max_pool2d(F.pad(a[None, None], (1, 1, 1, 1), mode="replicate"), 3, 1),
                "erode3x3": lambda a, *_, flip=flip: flip(
                    F.max_pool2d(F.pad(flip(a[None, None]), (1, 1, 1, 1), mode="replicate"), 3, 1)),
            }
            for name, form in lib_forms.items():
                try:
                    same = same_values(form(x)[0, 0], getattr(K5, name)(x))
                except RuntimeError as e:  # an input type the library call refuses
                    k5_library[(name, dtype, s5)] = f"none: {str(e).splitlines()[0][:120]}"
                    continue
                if not same:
                    raise AssertionError(f"the library form of {name} differs from K5 at {s5}x{s5} {dtype}")
                by_kernel = kernel_phase_ms(form, 40, xs)
                k5[(name, dtype, s5)]["library_ms"] = cuda_ms_cycle(form, xs, 200)
                k5[(name, dtype, s5)]["library_device_ms"] = sum(by_kernel.values()) or None
                k5[(name, dtype, s5)]["library_kernels"] = len(by_kernel)
                k5_library[(name, dtype, s5)] = (f"{fmt(sum(by_kernel.values()) or None)} ms on the card's clock in "
                                                 f"{len(by_kernel)} kernels")
        phase(f"  K5 at {s5}x{s5}, ms a launch on the card's clock (events over the Python loop, the host's issue rate): "
              + ", ".join(f"{n} {d} {fmt(v['device_ms'])} ({v['ms']:.4f}; plain {v['plain_ms']:.3f}, bound "
                          f"{v['bound_ms']:.5f}, out.copy_(x) {fmt(v['copy_floor_device_ms'])}, {v['copies']} copies)"
                          for (n, d, sz), v in k5.items() if sz == s5) + f"; {smi}")
        phase(f"  K5's library forms at {s5}x{s5}: " + ", ".join(
            f"{n} {d}: {v}" for (n, d, sz), v in k5_library.items() if sz == s5) + "; erode3x3_ellipse: none")

    kernels = [
        {
            "name": "cc_ids_window (K1)", "route": "cuda",
            "source": "comic_text_detector_tpu_torch/csrc/cc.cu",
            "replaces": "comic_text_detector_tpu/ops/pallas_kernels.py:335",
            "launches": launches_b["K1"], "max_abs_err": max(k1_err, border_errs["K1"]), "ms": k1_ms,
            "device_ms": sum(k1_phases.values()) or None,
            "plain_ms": k1_plain,
            "bound_ms": k1_bytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
        },
        {
            "name": "cc_window (K2)", "route": "cuda",
            "source": "comic_text_detector_tpu_torch/csrc/cc.cu",
            "replaces": "comic_text_detector_tpu/ops/pallas_kernels.py:300",
            "launches": launches_b["K2"], "max_abs_err": max(db_errs["K2"], db_errs_b["K2"], k2_seam_err),
            "ms": k2_timed["1024"]["ms"], "device_ms": sum(k2_timed["1024"]["phase_ms"].values()) or None,
            "plain_ms": k2b_plain, "bound_ms": pxb * 5 / H100_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": None,
        },
        {
            "name": "min_prop_window (K3)", "route": "cuda",
            "source": "comic_text_detector_tpu_torch/csrc/cc.cu",
            "replaces": "comic_text_detector_tpu/ops/pallas_kernels.py:320",
            "launches": launches_b["K3"],
            "max_abs_err": max(db_errs["K3"], db_errs_b["K3"], border_errs["K3"], border_errs["ids"]), "ms": k3b_ms,
            "device_ms": sum(k3_phases.values()) or None,
            "plain_ms": k3b_plain, "bound_ms": pxb * 9 / H100_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None,
        },
        {
            "name": "mask_to_u8 (K6 finalize)", "route": "cuda",
            "source": "comic_text_detector_tpu_torch/csrc/finalize.cu",
            "replaces": "comic_text_detector_tpu/ops/pallas_kernels.py:92",
            "launches": launches_b["K6 mask_to_u8"], "max_abs_err": k6_seam_errs["mask_to_u8"],
            "ms": k6["1024"]["mask_to_u8"]["ms"], "device_ms": k6["1024"]["mask_to_u8"]["device_ms"],
            "plain_ms": k6["1024"]["mask_to_u8"]["plain_ms"], "bound_ms": k6["1024"]["mask_to_u8"]["bound_ms"],
            "bound_by": "bytes", "library_ms": k6["1024"]["mask_to_u8"]["library_ms"],
        },
        {
            "name": "binarize (K6 binarize)", "route": "cuda",
            "source": "comic_text_detector_tpu_torch/csrc/finalize.cu",
            "replaces": "comic_text_detector_tpu/ops/pallas_kernels.py:107",
            "launches": launches_b["K6 binarize"], "max_abs_err": k6_seam_errs["binarize"],
            "ms": k6["1024"]["binarize"]["ms"], "device_ms": k6["1024"]["binarize"]["device_ms"],
            "plain_ms": k6["1024"]["binarize"]["plain_ms"], "bound_ms": k6["1024"]["binarize"]["bound_ms"],
            "bound_by": "bytes", "library_ms": k6["1024"]["binarize"]["library_ms"],
        },
        {
            "name": "cc_row_sweep (K4 rows)", "route": "cuda",
            "source": "comic_text_detector_tpu_torch/csrc/scan.cu",
            "replaces": "comic_text_detector_tpu/ops/pallas_kernels.py:177",
            "launches": launches_big["K4 row"], "max_abs_err": max(k4_err, k4r_err), "ms": k4r_ms, "device_ms": k4r_dev,
            "plain_ms": k4r_plain,
            "bound_ms": k4_bytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
        },
        {
            "name": "cc_col_sweep (K4 columns)", "route": "cuda",
            "source": "comic_text_detector_tpu_torch/csrc/scan.cu",
            "replaces": "comic_text_detector_tpu/ops/pallas_kernels.py:177",
            "launches": launches_big["K4 col"], "max_abs_err": max(k4_err, k4c_err), "ms": k4c_ms, "device_ms": k4c_dev,
            "plain_ms": k4c_plain,
            "bound_ms": k4_bytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
        },
    ]
    # K5 has no caller on any path: its launches on the path are 0
    for name, line, key in (("erode3x3", 37, "K5 erode"), ("dilate3x3", 37, "K5 dilate"),
                            ("erode3x3_ellipse", 71, "K5 cross")):
        v = k5[(name, "float32", big)]
        kernels.append({
            "name": f"{name} (K5, float32 1536x1536)", "route": "cuda",
            "source": "comic_text_detector_tpu_torch/csrc/morph.cu",
            "replaces": f"comic_text_detector_tpu/ops/pallas_kernels.py:{line}",
            "launches": launches_big[key], "max_abs_err": k5_err, "ms": v["ms"], "device_ms": v["device_ms"],
            "plain_ms": v["plain_ms"],
            "bound_ms": v["bound_ms"], "bound_by": "bytes", "library_ms": v.get("library_ms"),
            "library_device_ms": v.get("library_device_ms"),
        })
    print(json.dumps({"stream_pages_per_s_bf16": len(spages) / stream_s,
                      "stream_ms_per_page_bf16": stream_s * 1e3 / len(spages),
                      "stream_pages_per_s_f32": len(spages) / stream32_s,
                      "stream_ms_per_page_f32": stream32_s * 1e3 / len(spages),
                      "stream_launches_per_page": per_page_b, "stream_blocks": n_blocks,
                      "stream_device_busy_ms_per_page": busy_ms / len(spages), "stream_idle_share": idle,
                      "stream_top_kernels": top_kernels,
                      "bf16_vs_f32_mask_iou": ious16, "batch_vs_single": diag, "bf16_net_gap_b4_vs_b1": net_gap,
                      "batch_stage_ms": batch_stages, "k2_k3_batch_ms": [k2b_ms, k3b_ms],
                      "k3_split_seeds_ms": k3s_ms, "k1_bucket_ms": k1_buckets,
                      "k1_phase_ms": k1_phases, "k3_phase_ms": k3_phases,
                      "k2_k3_single_ms": [k2_ms, k3_ms], "k2_k3_single_plain_ms": [k2_plain, k3_plain],
                      "build_s": build_s,
                      "page_ms": page_ms, "page_ms_device_refine": page_ms_dev, "device_step_ms": step_ms,
                      "device_refine_ms": refine_ms, "refine_windows": len(windows), "stage_ms": stages,
                      "refine_dispatch_stage_ms": refine_stages,
                      "db_components": n_comp, "k1_stack": list(stack.shape),
                      "k1_launches_per_page": launches_dev["K1"] / len(pages),
                      "launches_device_refine": launches_dev, "pages": [list(p.shape) for p in pages],
                      "card": smi}), flush=True)
    print(json.dumps({"input": big, "stream_pages_per_s_bf16": len(hpages) / big_s,
                      "stream_ms_per_page_bf16": big_s * 1e3 / len(hpages),
                      "stream_launches_per_page": per_page_big, "stream_blocks": blocks_big,
                      "stream_lines": lines_per_page,
                      "stream_device_busy_ms_per_page": busy_big / len(hpages), "stream_idle_share": idle_big,
                      "stream_top_kernels": top_big, "single_page": single_big, "representer": rep_summary,
                      "k4_ms": [k4r_ms, k4c_ms], "k4_plain_ms": [k4r_plain, k4c_plain],
                      "k4_col_2048": k4c_2048, "k4_row_2048": k4r_2048, "k4_device_ms": [k4r_dev, k4c_dev],
                      "cc_ms": {"k4": cc_k4_ms, "k2": cc_k2_ms, "plain": cc_plain_ms, "k4_rounds": k4_rounds,
                                "auto": cc_auto_ms},
                      "k2": k2_timed, "k6": k6,
                      "k5_ms": {f"{n} {d} {sz}": v for (n, d, sz), v in k5.items()},
                      "k5_library": {f"{n} {d} {sz}": v for (n, d, sz), v in k5_library.items()},
                      "pages": [list(p.shape) for p in hpages], "card": smi}), flush=True)
    train = train_phases(dev, smi, counters)
    print(json.dumps({"train": train, "card": smi}), flush=True)
    phase("16/19 model files: .pt, three parts, native msgpack, .onnx and .pt2 through TextDetector at 1024, "
          "device refine, packed masks")
    files = model_files_phase(det_dev, pages, drive, path_1024, smi)
    print(json.dumps({"model_files": files, "card": smi}), flush=True)
    phase("17/19 the YOLO graph's block variants (V5S_TR, V5S_GHOST) through TextDetector at 1024, device refine, "
          "packed masks; their model files; the CLI")
    variants = variant_phase(pages, small, drive, smi, det_dev)
    print(json.dumps({"variants": variants, "card": smi}), flush=True)
    phase("18/19 data parallelism: BatchTextDetector(mesh=) over two replicas; the seg, DB and YOLO steps and "
          "trainers on 2 gloo ranks on cuda:0; the YOLO step on NCCL at world 1")
    mesh = mesh_phase(dev, smi, drive, path_1024, variables, warm, spages, out16, out32, len(spages) / stream_s)
    print(json.dumps({"mesh": mesh, "card": smi}), flush=True)
    phase("19/19 the host library behind boxes_from_stats: build, its functions against their plain versions, the "
          "representer through both routes; the DB rotate and trainer with Pillow blocked")
    t0 = time.perf_counter()
    host = host_library_phase(dev, smi, lines_f32, 0.3)
    host["phase_s"] = time.perf_counter() - t0
    phase(f"  phase 19: {host['phase_s']:.1f} s")
    print(json.dumps({"host_library": host}), flush=True)
    db_eval = mesh["gloo"]["trainers"]["db"]["rank0"]
    for entry in kernels:  # the launches on the mesh paths: the stream's, and the mesh DB trainer's eval
        key = {"cc_ids_window (K1)": "K1", "cc_window (K2)": "K2", "min_prop_window (K3)": "K3",
               "mask_to_u8 (K6 finalize)": "K6 mask_to_u8", "binarize (K6 binarize)": "K6 binarize"}.get(entry["name"])
        if key is not None:
            entry["mesh_stream_launches"] = mesh["stream"]["launches"][key]
            if key in ("K2", "K6 binarize"):
                entry["mesh_db_eval_launches"] = db_eval[key]
    phase(f"whole script {time.perf_counter() - t_script:.1f} s; {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
