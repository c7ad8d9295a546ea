"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each announced on a flushed line
before it starts so a stall shows where it stopped:

1. the card's name and power limit, the torch and CUDA versions;
2. build the CUDA kernels from ``comic_text_detector_tpu_torch/csrc`` (one
   nvcc per source, all started together), with the build time;
3. hold each kernel (K1, K2, K3) and the ids route bit for bit against
   its plain PyTorch version, small inputs first; K1 at every refine
   bucket shape with 4 x slots windows;
4. the two paths, each on the same seeded synthetic pages with every
   kernel's launch count set to 0 just before and read just after:
   ``TextDetector("data/flagship_r2.npz", input_size=1024)`` (host refine,
   K2 and K3 in the DB decode) and the same with
   ``refine_backend="device", mask_transfer="packed"`` (K1 in the refine
   too); then K2 and K3 against their plain versions on the path's own
   1024x1024 DB bitmap, K1 on page 0's own candidate stack, their times,
   the device refine alone, and ms/page of both configurations;
5. the output check: the same page through the card and through the
   port's CPU route (plain versions) at input size 512 must agree, for
   both refine backends, and the card's ``refine_page`` must be bit-equal
   to the CPU's on the same page and grey mask.

Prints ``{"kernels": [...]}`` on a line of its own, and as its last line
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


def synthetic_page(rng, h: int, w: int, colour: bool):
    """Light page with speech bubbles of glyph-like dark strokes."""
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w]
    base = 205 + 30 * (yy / h)
    page = np.repeat(base[..., None], 3, axis=2)
    if colour:
        page = page * np.array([0.85, 0.95, 1.0]) + np.array([10.0, 0.0, -15.0])
    for _ in range(int(rng.integers(4, 8))):
        cy, cx = rng.integers(h // 8, h - h // 8), rng.integers(w // 8, w - w // 8)
        ry, rx = rng.integers(h // 14, h // 6), rng.integers(w // 14, w // 6)
        inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        page[inside] = 250
        cell = int(rng.integers(14, 26))
        vertical = rng.random() < 0.5
        for r in range(-ry // 2, ry // 2 - cell, cell + cell // 3):
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
                    else:  # vertical stroke
                        x = x0 + int(rng.integers(0, cell - t))
                        a, b = sorted(rng.integers(0, cell, 2))
                        page[y0 + a:y0 + b + 1, x:x + t] = 25
    page = np.clip(page, 0, 255).astype(np.uint8)
    if not colour:
        page[..., 1] = page[..., 0]
        page[..., 2] = page[..., 0]
    return page


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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script runs only on a CUDA device")
    if not os.path.isdir(os.path.join(ROOT, "comic_text_detector_tpu_torch")) or not os.path.exists(WEIGHTS):
        fail("run from a checkout of the repository: the port package or data/flagship_r2.npz is missing")
    import numpy as np

    from comic_text_detector_tpu_torch.ops import cc_kernels as K

    phase("1/5 device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    phase("2/5 build kernels (nvcc)")
    t0 = time.perf_counter()
    K.build()
    phase(f"build time {time.perf_counter() - t0:.1f} s")

    phase("3/5 kernels vs plain versions, bit for bit")
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

    for bh, bw, slots, _cap in R.BUCKETS:
        glyph = (synthetic_page(rng, bh, bw, colour=False)[..., 0] < 128).astype(np.uint8)
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

    phase("4/5 main paths: TextDetector at 1024, flagship_r2 weights, host and device refine")
    from comic_text_detector_tpu_torch.ops.db_decode import db_decode_full_device
    from comic_text_detector_tpu_torch.ops.nms import nms_single
    from comic_text_detector_tpu_torch.ops.resize import letterbox_device_u8, letterbox_shape, resize_cv2exact_u8
    from comic_text_detector_tpu_torch.pipeline import TextDetector

    det = TextDetector(WEIGHTS, input_size=1024)
    pages = [
        synthetic_page(rng, 1400, 1000, colour=False),
        synthetic_page(rng, 1100, 1600, colour=True),
        synthetic_page(rng, 1400, 1000, colour=True),
    ]
    K.cc_windows_local.launches = 0
    K.min_prop_windows_local.launches = 0
    results = [det(p) for p in pages]
    torch.cuda.synchronize()
    launches = {"K2": K.cc_windows_local.launches, "K3": K.min_prop_windows_local.launches}
    phase(f"  launches on the main path: {launches}")
    for kname, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{kname} was not launched on the main path")
    for p, (mask, refined, blks) in zip(pages, results):
        if mask.shape != p.shape[:2] or refined.shape != p.shape[:2] or mask.dtype != np.uint8:
            raise AssertionError(f"mask shapes {mask.shape} {refined.shape} for page {p.shape}")
        n_lines = sum(len(b.lines) for b in blks)
        phase(f"  page {p.shape}: {len(blks)} blocks, {n_lines} lines, mask>30 {(mask > 30).mean():.4f}")

    phase("  device refine, packed masks")
    det_dev = TextDetector(WEIGHTS, input_size=1024, refine_backend="device", mask_transfer="packed")
    for kernel in (K.cc_windows_local, K.min_prop_windows_local, K.cc_ids_fused):
        kernel.launches = 0
    results_dev = [det_dev(p) for p in pages]
    torch.cuda.synchronize()
    launches_dev = {"K1": K.cc_ids_fused.launches, "K2": K.cc_windows_local.launches,
                    "K3": K.min_prop_windows_local.launches}
    phase(f"  launches on the device-refine path: {launches_dev}")
    for kname, n in launches_dev.items():
        if n <= 0:
            raise AssertionError(f"{kname} was not launched on the device-refine path")
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
    px = bitmap.numel()
    k2_bytes = px * 1 + px * 4  # mask in, labels out
    k3_bytes = px * 1 + px * 4 + px * 4  # mask + seeds in, ids out

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
    k1_out, k1_parent = torch.empty(stack.shape, dtype=torch.int32, device=dev), torch.empty(
        stack.shape, dtype=torch.int32, device=dev)
    k1_ms = cuda_ms(lambda: K.launch_cc_ids_window(stack, k1_parent, k1_out, err), 50)
    if int(err.item()):
        raise AssertionError("a union-find loop bound was hit while timing K1")
    k1_plain = cuda_ms(lambda: K.cc_ids_windows_local_plain(stack), 5)
    k1_bytes = stack.numel() * (1 + 4)  # mask in, ids out
    phase(f"  K1 on page 0's candidates {tuple(stack.shape)} ({len(sel)} windows of bucket {bh}x{bw}): "
          f"{k1_ms:.4f} ms, plain {k1_plain:.2f} ms, {int(k1_out.max())} max id")

    def page_time(detector) -> float:
        for p in pages:  # warm-up
            detector(p)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reps = 2
        for _ in range(reps):
            for p in pages:
                detector(p)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / (reps * len(pages))

    page_ms = page_time(det)
    page_ms_dev = page_time(det_dev)
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
            "net": cuda_ms(lambda: det.model(x), 5),
            "nms": cuda_ms(lambda: nms_single(blks_t[0], det.conf_thresh, det.nms_thresh), 5),
            "mask_unletterbox": cuda_ms(
                lambda: resize_cv2exact_u8(mask_u8[: 1024 - dh0, : 1024 - dw0], (h0, w0)), 5),
            "db_decode": cuda_ms(lambda: db_decode_full_device(lines_t[0, 0], det.db_thresh), 5),
        }
    phase("  device step by stage (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))

    phase("5/5 output check: card vs the port's CPU route")
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

    kernels = [
        {
            "name": "cc_ids_window (K1)", "route": "cuda",
            "source": "comic_text_detector_tpu_torch/csrc/cc.cu",
            "replaces": "comic_text_detector_tpu/ops/pallas_kernels.py:335",
            "launches": launches_dev["K1"], "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain,
            "bound_ms": k1_bytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
        },
        {
            "name": "cc_window (K2)", "route": "cuda",
            "source": "comic_text_detector_tpu_torch/csrc/cc.cu",
            "replaces": "comic_text_detector_tpu/ops/pallas_kernels.py:300",
            "launches": launches["K2"], "max_abs_err": db_errs["K2"], "ms": k2_ms, "plain_ms": k2_plain,
            "bound_ms": k2_bytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
        },
        {
            "name": "min_prop_window (K3)", "route": "cuda",
            "source": "comic_text_detector_tpu_torch/csrc/cc.cu",
            "replaces": "comic_text_detector_tpu/ops/pallas_kernels.py:320",
            "launches": launches["K3"], "max_abs_err": db_errs["K3"], "ms": k3_ms, "plain_ms": k3_plain,
            "bound_ms": k3_bytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
        },
    ]
    print(json.dumps({"page_ms": page_ms, "page_ms_device_refine": page_ms_dev, "device_step_ms": step_ms,
                      "device_refine_ms": refine_ms, "refine_windows": len(windows), "stage_ms": stages,
                      "refine_dispatch_stage_ms": refine_stages,
                      "db_components": n_comp, "k1_stack": list(stack.shape),
                      "k1_launches_per_page": launches_dev["K1"] / len(pages),
                      "launches_device_refine": launches_dev, "pages": [list(p.shape) for p in pages],
                      "card": smi}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
